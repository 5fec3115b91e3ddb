"""Declarative experiment builder + the pure round API — counterpart of
`repro.core.scenario` (`Scenario`, `run_round`, `run`, `run_campaign`).

    sc = Scenario(topology="single", client="dtssl", aggregator="flsimco",
                  partitioner="dirichlet", alpha=0.1, n_vehicles=8,
                  vehicles_per_round=4, batch_size=32, rounds=6)
    state = sc.init_state()
    state, rec = run_round(state, sc)            # one pure round
    state, history = run(sc, state, rounds=5)    # or many
    state, history = run_campaign(sc, state, rounds=5)   # planned ahead,
                                                 # a CUDA graph a round

Same signatures as the reference; `Scenario` also takes ``device``: the
scenario runs on CUDA unless ``device="cpu"`` is passed, and raises if
CUDA is asked for and missing. Building a scenario turns on the float32
parity mode (runtime.py). Every topology (``single``, ``multi``,
``handover``), client (``dtssl``, ``fedco``, and the legacy
``aggregator="fedco"`` spelling), aggregator and codec of the reference
is accepted, the topologies' mesh options too (launch/mesh.py: with
``torch.distributed`` ranks, each rank builds the same scenario).
``parallel=True`` (the default, as in the reference) trains each cohort
or RSU group with the batched client step, ``parallel=False`` client by
client (core/clients.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.comms.codecs import comms_init_state
from repro_torch.convert import tree_map
from repro_torch.core.clients import CLIENT_UPDATES
from repro_torch.core.mobility import MobilityModel
from repro_torch.core.state import (FLConfig, FLState, pack_host_rng,
                                    resolve_fedco_alias)
from repro_torch.core.topology import TOPOLOGIES
from repro_torch.optim.optimizers import cosine_schedule
from repro_torch.runtime import resolve_device, set_parity_mode

PARTITIONERS = ("iid", "dirichlet")


class Scenario:
    """Static description of one federated experiment (see the reference
    `repro.core.scenario.Scenario` for every field), on `device`."""

    def __init__(self, cfg: Optional[FLConfig] = None, *,
                 topology="single",
                 aggregator: Optional[str] = None,
                 client: Optional[str] = None,
                 mobility: Optional[MobilityModel] = None,
                 partitioner: str = "iid",
                 alpha: float = 0.1,
                 n_per_class: int = 100,
                 min_per_client: int = 0,
                 data_seed: int = 0,
                 arch: str = "resnet18-cifar",
                 data: Optional[Sequence] = None,
                 global_tree: Any = None,
                 blur_images: bool = True,
                 topology_kwargs: Optional[dict] = None,
                 device=None,
                 **cfg_kwargs):
        self.device = resolve_device(device)
        set_parity_mode()
        if cfg is None:
            cfg = FLConfig(**cfg_kwargs)
        elif cfg_kwargs:
            cfg = dataclasses.replace(cfg, **cfg_kwargs)
        # the alias is resolved before the override: cfg.client is already
        # a concrete name, which FLConfig could not tell from a request
        aggregator, client = resolve_fedco_alias(aggregator, client)
        overrides = {k: v for k, v in (("aggregator", aggregator),
                                       ("client", client)) if v is not None}
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        if isinstance(topology, str):
            if topology not in TOPOLOGIES:
                raise ValueError(f"unknown topology {topology!r}; valid: "
                                 f"{sorted(TOPOLOGIES)}")
            topology = TOPOLOGIES[topology](**(topology_kwargs or {}))
        elif topology_kwargs:
            raise ValueError("topology_kwargs only applies when `topology` "
                             "is a registry name")
        self.topology = topology
        self.mobility = mobility if mobility is not None else MobilityModel()
        self.blur_images = blur_images
        if partitioner not in PARTITIONERS:
            raise ValueError(f"unknown partitioner {partitioner!r}; valid: "
                             f"{sorted(PARTITIONERS)}")
        self.partitioner = partitioner
        self.alpha = alpha
        self.n_per_class = n_per_class
        self.min_per_client = min_per_client
        self.data_seed = data_seed
        self.arch = arch
        self._data = list(data) if data is not None else None
        self._dataset = None
        self._global_tree = global_tree
        self._lr_fn = None
        self.topology.validate(self.cfg, self.device)

    # -- lazy builders -------------------------------------------------------

    @property
    def data(self) -> list:
        """Per-vehicle image arrays (numpy, built on first access)."""
        if self._data is None:
            from repro_torch.data.synthetic import (partition_dirichlet,
                                                    partition_iid)
            x, y = self.dataset
            if self.partitioner == "iid":
                parts = partition_iid(y, self.cfg.n_vehicles,
                                      seed=self.data_seed)
            else:
                parts = partition_dirichlet(
                    y, self.cfg.n_vehicles, alpha=self.alpha,
                    min_per_client=self.min_per_client, seed=self.data_seed)
            self._data = [x[p] for p in parts]
        return self._data

    @property
    def dataset(self):
        """The full (images, labels) pool."""
        if self._dataset is None:
            from repro_torch.data.synthetic import make_dataset
            self._dataset = make_dataset(n_per_class=self.n_per_class,
                                         seed=self.data_seed)
        return self._dataset

    def init_tree(self) -> dict:
        """Round-0 model on the scenario's device (built from `arch` and a
        generator seeded with cfg.seed unless provided)."""
        if self._global_tree is None:
            from repro_torch.configs import get_config
            from repro_torch.models.resnet import init_resnet
            gen = torch.Generator().manual_seed(self.cfg.seed)
            self._global_tree = init_resnet(get_config(self.arch), gen,
                                            self.device)
        return tree_map(lambda t: t.to(self.device), self._global_tree)

    @property
    def lr_fn(self):
        if self._lr_fn is None:
            self._lr_fn = cosine_schedule(self.cfg.lr, self.cfg.rounds)
        return self._lr_fn

    def init_state(self) -> FLState:
        """The round-0 `FLState` (model, both RNG streams, the client's,
        the topology's and the codec's state), deterministic in
        cfg.seed."""
        cfg = self.cfg
        tree = self.init_tree()
        gen = torch.Generator().manual_seed(cfg.seed)
        client_state = CLIENT_UPDATES[cfg.client].init_state(cfg, tree)
        topo = self.topology.init_state(cfg, self.mobility, tree, gen)
        return FLState(global_tree=tree, gen_state=gen.get_state(),
                       host_rng=pack_host_rng(np.random.RandomState(cfg.seed)),
                       round=0, topo=topo, client_state=client_state,
                       comms=comms_init_state(cfg, tree))


def run_round(state: FLState, scenario: Scenario, parallel: bool = True):
    """One federated round: (state, scenario) -> (state, record). Pure.
    Runs on the scenario's device; `parallel` picks the batched cohort
    step (True) or the client-by-client one."""
    return scenario.topology.run_round(state, scenario, parallel=parallel)


def run(scenario: Scenario, state: Optional[FLState] = None,
        rounds: Optional[int] = None, parallel: bool = True,
        log_every: int = 0, publish=None):
    """Run `rounds` rounds (default cfg.rounds) from `state` (default the
    scenario's round-0 state). Returns (final state, list of records).
    ``publish(round, tree)`` is called after every round."""
    if state is None:
        state = scenario.init_state()
    history = []
    for _ in range(rounds if rounds is not None else scenario.cfg.rounds):
        state, rec = run_round(state, scenario, parallel=parallel)
        history.append(rec)
        if publish is not None:
            publish(state.round, state.global_tree)
        if log_every and rec["round"] % log_every == 0:
            print(f"[round {rec['round']:4d}] loss={rec['loss']:.4f} "
                  f"lr={rec['lr']:.4f}")
    return state, history


def run_campaign(scenario: Scenario, state: Optional[FLState] = None,
                 rounds: Optional[int] = None, **kwargs):
    """`run` through the campaign engine: the whole schedule drawn ahead
    from the same random streams, then one round body a round, eager or
    replayed from a CUDA graph (``mode``) — see core/engine.py for the
    modes, checkpoints, publishing and what is bitwise. Signature sugar
    over `engine.run_campaign`."""
    from repro_torch.core.engine import run_campaign as _run_campaign
    return _run_campaign(scenario, state, rounds, **kwargs)
