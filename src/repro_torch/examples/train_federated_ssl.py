"""End-to-end driver: federated SSL pre-training + probe evaluation.

The paper's full experiment at configurable scale, declared as a
`Scenario` and driven through pure rounds. Defaults run a short
configuration (``--preset ci``); ``--preset paper`` sets Table 1's
values (95 vehicles, 5 a round, batch 512, 5,000 images a class with
15% held out for the probe, lr 0.9, 150 rounds), and flags given
explicitly override the preset's (``--rounds 2`` cuts the campaign).

    PYTHONPATH=src python -m repro_torch.examples.train_federated_ssl \\
        --preset paper --noniid                      # on the card
    PYTHONPATH=src python -m repro_torch.examples.train_federated_ssl \\
        --rounds 10 --vehicles 10 --aggregator flsimco --noniid --device cpu

Checkpoints are FULL `FLState` snapshots (model + RNG streams + round),
so ``--resume`` continues from the newest one (`latest`) as a run that
never paused. Prints the seconds a round (host clock; every round ends
in a fetch of its loss), which the reference's script does not.
Counterpart of `examples/train_federated_ssl.py`.
"""
from __future__ import annotations

import os
import time

from repro_torch.checkpoint.store import latest, restore_state, save_state
from repro_torch.core.aggregation import AGGREGATORS
from repro_torch.core.federation import gradient_std
from repro_torch.core.scenario import Scenario, run_round
from repro_torch.data.synthetic import (make_dataset, partition_dirichlet,
                                        partition_iid)
from repro_torch.eval.probe import encode, knn_top1, linear_probe_top1
from repro_torch.examples.common import device_of, parser

PAPER = dict(rounds=150, vehicles=95, per_round=5, batch=512,
             n_per_class=5000, lr=0.9)     # Table 1


def _parser():
    ap = parser(__doc__)
    ap.add_argument("--preset", choices=["ci", "paper"], default="ci")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--vehicles", type=int, default=10)
    ap.add_argument("--per-round", type=int, default=5)
    ap.add_argument("--local-iters", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-per-class", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--aggregator", default="flsimco",
                    choices=sorted(AGGREGATORS) + ["fedco"])
    ap.add_argument("--client", default=None, choices=["dtssl", "fedco"])
    ap.add_argument("--topology", default="single",
                    choices=["single", "multi", "handover"])
    ap.add_argument("--noniid", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--ckpt-dir", default="checkpoints/fl_ssl")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--probe", default="knn", choices=["knn", "linear"])
    return ap


def parse(argv=None):
    """The flags, the preset's values under those given explicitly."""
    ap = _parser()
    if ap.parse_args(argv).preset == "paper":
        ap.set_defaults(**PAPER)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse(argv)
    device = device_of(a)

    x, y = make_dataset(n_per_class=a.n_per_class, seed=0)
    split = int(0.85 * len(x))
    xtr, ytr, xte, yte = x[:split], y[:split], x[split:], y[split:]
    if a.noniid:
        parts = partition_dirichlet(
            ytr, a.vehicles, a.alpha,
            min_per_client=min(520, len(xtr) // a.vehicles), seed=0)
    else:
        parts = partition_iid(ytr, a.vehicles)

    sc = Scenario(topology=a.topology, aggregator=a.aggregator,
                  client=a.client, data=[xtr[p] for p in parts],
                  n_vehicles=a.vehicles, vehicles_per_round=a.per_round,
                  batch_size=a.batch, rounds=a.rounds,
                  local_iters=a.local_iters, lr=a.lr, device=device)

    state = None
    if a.resume:
        found = latest(a.ckpt_dir)
        if found:
            state = restore_state(found[0], scenario=sc)
            print(f"resumed full FLState from {found[0]} "
                  f"(round {state.round})")
    if state is None:
        state = sc.init_state()

    history = []
    start = state.round
    t0 = time.perf_counter()
    while state.round < a.rounds:
        state, rec = run_round(state, sc)
        history.append(rec)
        r = rec["round"]
        if r % 5 == 0 or r == a.rounds - 1:
            print(f"[{sc.cfg.aggregator}/{sc.cfg.client}] round {r:4d} "
                  f"loss={rec['loss']:.4f}")
        if state.round % a.ckpt_every == 0:
            save_state(os.path.join(a.ckpt_dir,
                                    f"ckpt_{state.round}.npz"), state,
                       scenario=sc)
    seconds = time.perf_counter() - t0
    per_round = seconds / len(history) if history else 0.0
    print(f"rounds {start}-{state.round - 1} in {seconds:.2f} s "
          f"({per_round:.4f} s a round, checkpoints included) on "
          f"{sc.device}")

    losses = [h["loss"] for h in history]
    out = {"losses": losses, "seconds_per_round": per_round,
           "round": state.round}
    if len(losses) > 1:
        out["grad_std"] = gradient_std(losses)
        print(f"gradient std of loss curve: {out['grad_std']:.4f}")

    f_tr = encode(state.global_tree, xtr[:2000], device=device)
    f_te = encode(state.global_tree, xte[:1000], device=device)
    if a.probe == "knn":
        acc = knn_top1(f_tr, ytr[:2000], f_te, yte[:1000], device=device)
    else:
        acc = linear_probe_top1(f_tr, ytr[:2000], f_te, yte[:1000],
                                device=device)
    print(f"{a.probe} probe top-1: {acc:.4f}")
    out["top1"] = acc
    out["checkpoint"] = save_state(
        os.path.join(a.ckpt_dir, f"ckpt_{state.round}.npz"), state,
        scenario=sc)
    return out


if __name__ == "__main__":
    main()
