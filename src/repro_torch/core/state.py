"""Explicit federated-learning state — counterpart of `repro.core.state`
(`FLConfig`, `FLState`, `pack_host_rng`, `unpack_host_rng`).

`FLState` holds everything that changes from round to round: the RSU
model, the packed host `numpy.random.RandomState` (cohort ids and batch
indices, MT19937 — bitwise the reference's stream), the state of the
CPU `torch.Generator` that takes the place of the reference's jax key
(velocities, positions, augmentation draws), the topology's state
(handover positions and per-RSU models) and the client algorithm's
(FedCo's key encoder and queue). So

    state, rec = run_round(state, scenario)      # core/scenario.py

is pure: the same state in gives the same state out.

`FLState.to_tree()` / `FLState.from_tree()` convert to and from the
plain dict pytree that `checkpoint.store` writes, in the reference's
layout, with `gen_state` where the reference has its jax `key`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.core.mobility import BLUR_KMH_100

def resolve_fedco_alias(aggregator, client):
    """The legacy ``aggregator="fedco"`` spelling means client="fedco"
    aggregated with "fedavg"; returns (aggregator, client), unchanged
    unless aggregator == "fedco". A conflicting explicit client raises."""
    if aggregator != "fedco":
        return aggregator, client
    if client not in (None, "fedco"):
        raise ValueError(
            "aggregator='fedco' is a legacy alias for "
            "client='fedco', aggregator='fedavg' and conflicts "
            f"with explicit client={client!r}; pick one spelling")
    return "fedavg", "fedco"


@dataclass(frozen=True)
class FLConfig:
    n_vehicles: int = 95          # fleet size (Table 1)
    vehicles_per_round: int = 5   # N_r (Fig. 5: 5 or 10)
    local_iters: int = 1          # local SGD iterations per round
    batch_size: int = 512         # Table 1 / Sec. 5.2
    rounds: int = 150             # R^max
    lr: float = 0.9               # Table 1 (cosine annealed)
    momentum: float = 0.9
    weight_decay: float = 5e-4
    tau_alpha: float = 0.1
    tau_beta: float = 1.0
    aggregator: str = "flsimco"   # any AGGREGATORS name
    client: Optional[str] = None  # any CLIENT_UPDATES name; None: "dtssl"
    blur_threshold: float = BLUR_KMH_100   # in blur units (Eq. 2)
    moco_momentum: float = 0.99   # FedCo key-encoder EMA (Table 1)
    queue_len: int = 4096         # FedCo global queue (Sec. 5.2)
    feature_dim: int = 128
    normalize_weights: bool = True
    codec: str = "identity"       # any CODECS name (comms/codecs.py)
    seed: int = 0

    def __post_init__(self):
        # the registries import FLConfig, so they are resolved here
        from repro_torch.comms.codecs import CODECS
        from repro_torch.core.aggregation import AGGREGATORS
        from repro_torch.core.clients import CLIENT_UPDATES
        aggregator, client = resolve_fedco_alias(self.aggregator, self.client)
        object.__setattr__(self, "aggregator", aggregator)
        object.__setattr__(self, "client", client or "dtssl")
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}; "
                             f"valid: {sorted(AGGREGATORS)}")
        if self.client not in CLIENT_UPDATES:
            raise ValueError(f"unknown client update {self.client!r}; "
                             f"valid: {sorted(CLIENT_UPDATES)}")
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; valid: "
                             f"{sorted(CODECS)}")


def pack_host_rng(rng: np.random.RandomState) -> dict:
    """Serialize a `RandomState` into a dict of arrays."""
    name, keys, pos, has_gauss, cached = rng.get_state(legacy=True)
    if name != "MT19937":
        raise ValueError(f"expected an MT19937 RandomState, got {name}")
    return {"mt_keys": np.asarray(keys, np.uint32),
            "mt_pos": np.int64(pos),
            "has_gauss": np.int64(has_gauss),
            "cached_gaussian": np.float64(cached)}


def unpack_host_rng(packed: dict) -> np.random.RandomState:
    """Rebuild the `RandomState` a `pack_host_rng` snapshot described."""
    rng = np.random.RandomState()
    rng.set_state(("MT19937",
                   np.asarray(packed["mt_keys"], np.uint32),
                   int(packed["mt_pos"]),
                   int(packed["has_gauss"]),
                   float(packed["cached_gaussian"])))
    return rng


def _tensor(a, device) -> torch.Tensor:
    """A checkpoint leaf (numpy, or a tensor) as a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.tensor(np.asarray(a), device=device)


def generator_from(gen_state: torch.Tensor) -> torch.Generator:
    gen = torch.Generator()
    gen.set_state(gen_state)
    return gen


@dataclass(frozen=True)
class FLState:
    """One immutable snapshot of the federated state machine.

    global_tree   RSU model ({"params", "state"} dict of tensors)
    gen_state     CPU torch.Generator state (velocities, augmentations)
    host_rng      packed numpy RandomState (cohort + batch-index draws)
    round         next round index (drives the cosine LR schedule)
    topo          per-topology state ({} for SingleRSU and MultiRSU; for
                  HandoverMultiRSU: positions (n_vehicles,) float32 and
                  blur_sum, upload_count (n_rsus,) float64, numpy on the
                  host, and rsu_models, a tuple of n_rsus model trees)
    client_state  per-client-algorithm state (None for DT-SSL; FedCo:
                  {"key_tree": model tree, "queue": (K, D) float32})
    comms         per-codec comms state: None, or for delta_int8
                  {"ef": (vehicles_per_round, Ppad) float32} on the
                  scenario's device (comms/codecs.py)
    """

    global_tree: Any
    gen_state: torch.Tensor
    host_rng: dict
    round: int = 0
    topo: dict = field(default_factory=dict)
    client_state: Optional[dict] = None
    comms: Optional[dict] = None

    def replace(self, **kw) -> "FLState":
        return dataclasses.replace(self, **kw)

    # -- checkpoint payload -------------------------------------------------

    def to_tree(self) -> dict:
        """Plain dict pytree — what checkpoint.store writes; the
        reference's layout with `gen_state` in the place of `key`."""
        return {"global_tree": self.global_tree,
                "gen_state": self.gen_state,
                "host_rng": dict(self.host_rng),
                "round": np.int64(self.round),
                "topo": self.topo,
                "client_state": self.client_state,
                "comms": self.comms}

    @classmethod
    def from_tree(cls, tree: dict, device="cpu",
                  gen_state: Optional[torch.Tensor] = None) -> "FLState":
        """The state a `to_tree` payload (numpy or tensor leaves)
        describes: model trees, FedCo's key tree and queue and the error
        feedback as tensors on `device`; host_rng, the handover's
        positions and sync statistics as numpy; rsu_models a tuple;
        gen_state a CPU uint8 tensor.

        A payload of the reference holds a jax `key` and no generator
        state; it needs `gen_state` (which also takes the place of a
        stored one), since a threefry key has no torch counterpart and a
        silent reseed would change the run."""
        if gen_state is None:
            if "gen_state" not in tree:
                raise ValueError(
                    "this state holds no torch generator state (a "
                    "checkpoint of the JAX reference holds a jax key "
                    "instead); pass gen_state= explicitly to resume it")
            gen_state = tree["gen_state"]

        def on_device(t):
            return tree_map(lambda a: _tensor(a, device), t)

        topo = dict(tree.get("topo") or {})
        for k in ("positions", "blur_sum", "upload_count"):
            if k in topo:
                topo[k] = np.asarray(topo[k])
        if "rsu_models" in topo:
            topo["rsu_models"] = tuple(on_device(t)
                                       for t in topo["rsu_models"])
        cs, comms = tree.get("client_state"), tree.get("comms")
        return cls(global_tree=on_device(tree["global_tree"]),
                   gen_state=_tensor(gen_state, "cpu"),
                   host_rng={k: np.asarray(v)
                             for k, v in tree["host_rng"].items()},
                   round=int(tree["round"]), topo=topo,
                   client_state=on_device(cs) if cs else None,
                   comms=on_device(comms) if comms else None)
