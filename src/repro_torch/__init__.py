"""PyTorch/CUDA port of the FLSimCo reproduction (`repro`, JAX/Pallas).

The JAX package `repro` stays the reference; every module here names the
reference module it is held against, and tests/test_torch_*.py compare
the two on the same inputs. This package imports torch and numpy only —
never jax, never a module of `repro`.

Slice 1 covers the paper's main path: `Scenario(topology="single",
client="dtssl", aggregator=<any scheme>)` driven by `run_round` / `run`
(core/scenario.py), with the Eq.-11 aggregation (`kernels/csrc/wagg.cu`)
and the dual-temperature loss forward (`kernels/csrc/dt_loss.cu`) as
hand-written CUDA kernels. Slice 2 adds the comms and serving path: the
codecs (comms/codecs.py) with the blockwise-int8 `q8_encode` /
`q8_decode` kernels (`kernels/csrc/qdelta.cu`), the serving tier
(serve/) and the train-and-serve launcher (launch/serve.py).
"""
