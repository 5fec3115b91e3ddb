"""The FL drivers — the port's counterparts of the scripts of
`examples/`, one module each, under the same names:

    python -m repro_torch.examples.quickstart          # one Scenario, Eq.-11
    python -m repro_torch.examples.handover            # HandoverMultiRSU
    python -m repro_torch.examples.campaign            # run vs run_campaign
    python -m repro_torch.examples.resume              # save, restore, go on
    python -m repro_torch.examples.mobility_ablation   # velocity sweep
    python -m repro_torch.examples.train_federated_ssl --preset paper --noniid
    python -m repro_torch.examples.serve_campaign      # train and serve
    python -m repro_torch.examples.serve_batched       # zoo prefill + decode

Each keeps its script's flags, defaults and printed lines and adds
``--device``: the card by default (raising where there is none), the
plain PyTorch path with ``--device cpu``. Each has ``main(argv=None)``,
which returns what it printed as a dict, and raises (``resume`` exits
1) where its own checks fail. Run from the repository root with
``PYTHONPATH=src``.
"""
