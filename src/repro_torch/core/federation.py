"""Federated orchestration shim and training-curve statistics —
counterpart of `repro.core.federation` (`FederatedTrainer`,
`gradient_std`).

The simulation API is the pure one in `core/scenario.py` (`Scenario`,
`run_round`, `run`, `run_campaign`). `FederatedTrainer` is the
reference's back-compat shim over it: an `FLState` threaded through
`run_round`, the history accumulated, no round logic of its own.

The module re-exports `FLConfig`, `FLState` and `CLIENT_UPDATES`, as
the reference's does. The reference's jit factories
(`make_local_train_step`, `make_moco_local_train_step`) are JAX-only and
not re-exported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.clients import CLIENT_UPDATES
from repro_torch.core.mobility import MobilityModel
from repro_torch.core.scenario import Scenario, run_round
from repro_torch.core.state import FLConfig, FLState
from repro_torch.core.topology import SingleRSU, Topology

__all__ = ["FLConfig", "FLState", "FederatedTrainer", "gradient_std",
           "CLIENT_UPDATES"]


class FederatedTrainer:
    """Back-compat shim: an `FLState` threaded through `run_round`.

    The reference's constructor, plus ``device`` (the `Scenario`'s: CUDA
    unless ``device="cpu"``). Every attribute is a read-only view into
    the scenario and state pair. ``key`` is the state's ``gen_state``:
    the CPU `torch.Generator` state that takes the place of the
    reference's jax key."""

    def __init__(self, cfg: FLConfig, global_tree, client_data: list,
                 mobility: Optional[MobilityModel] = None,
                 blur_images: bool = True,
                 topology: Optional[Topology] = None, device=None):
        self.scenario = Scenario(
            cfg,
            topology=topology if topology is not None else SingleRSU(),
            mobility=mobility, data=client_data, global_tree=global_tree,
            blur_images=blur_images, device=device)
        self.state: FLState = self.scenario.init_state()
        self.history: list[dict] = []

    # -- the reference's attribute surface ----------------------------------

    @property
    def cfg(self) -> FLConfig:
        return self.scenario.cfg

    @property
    def topology(self) -> Topology:
        return self.scenario.topology

    @property
    def mobility(self) -> MobilityModel:
        return self.scenario.mobility

    @property
    def global_tree(self):
        return self.state.global_tree

    @property
    def key(self):
        """The state's `gen_state` (the reference's jax key)."""
        return self.state.gen_state

    @property
    def key_tree(self):
        return self.state.client_state["key_tree"]

    @property
    def global_queue(self):
        return self.state.client_state["queue"]

    @property
    def lr_fn(self):
        return self.scenario.lr_fn

    # -- rounds --------------------------------------------------------------

    def round(self, r: Optional[int] = None, parallel: bool = True) -> dict:
        """Advance one round. `r` is accepted for signature compatibility
        but the round counter lives in the state (it must survive
        checkpoint/resume); a mismatching `r` is rejected."""
        if r is not None and r != self.state.round:
            raise ValueError(f"round index {r} does not match state round "
                             f"{self.state.round}; the counter lives in "
                             f"FLState now — call round() without it")
        self.state, rec = run_round(self.state, self.scenario,
                                    parallel=parallel)
        self.history.append(rec)
        return rec

    def run(self, rounds: Optional[int] = None, log_every: int = 10,
            parallel: bool = True):
        for r in range(rounds if rounds is not None else self.cfg.rounds):
            rec = self.round(parallel=parallel)
            if log_every and r % log_every == 0:
                print(f"[round {rec['round']:4d}] loss={rec['loss']:.4f} "
                      f"lr={rec['lr']:.4f}")
        return self.history


def gradient_std(losses) -> float:
    """Paper Fig. 6 stability metric: std of the loss-curve gradient."""
    diffs = np.diff(np.asarray(losses, np.float64))
    return float(np.std(diffs))
