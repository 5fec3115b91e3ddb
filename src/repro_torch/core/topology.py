"""RSU topologies — pure round orchestration over an explicit `FLState`.

Counterpart of `repro.core.topology` (`Topology`, `SingleRSU`,
`MultiRSU`, `HandoverMultiRSU`, `_cohort_plan`, `_batch_indices`,
`_client_images`, `_region_sync_weights`, `_require_flsimco`). A
topology holds static configuration only; what changes from round to
round lives in `FLState` (`topo` for the handover's positions and
per-RSU models), so ``state, rec = topology.run_round(state, scenario)``
is pure.

  SingleRSU         paper-exact Steps 2-4: one RSU, one cohort, one
                    aggregation through the ``AGGREGATORS`` registry.
  MultiRSU          N RSUs under one regional server: the cohort is dealt
                    round-robin, each RSU trains and aggregates its group
                    (Eq. 11), the region merges the RSU models
                    (`aggregate_hierarchical`). MultiRSU(n_rsus=1) is
                    bitwise SingleRSU.
  HandoverMultiRSU  MultiRSU plus motion on a ring road: per-RSU models
                    persist in `FLState.topo`, a vehicle downloads from
                    the RSU covering it at round start and uploads to the
                    one covering it at round end; a stale upload (another
                    RSU) has its Eq.-11 weight scaled by `stale_discount`.
                    Every `sync_every` rounds the region merges the RSU
                    models.

A round is split as the reference splits it: a plan that makes every
random draw up front, then an execution. Host MT19937 draws
(`numpy.random.RandomState`: cohort ids, batch indices) come in the
reference's order, so they are bitwise the reference's; the CPU
`torch.Generator` takes the place of the jax key chain (velocities,
each client's per-iteration pi1/pi2 draws). The handover plan is itself
two steps, `draw_round` (the draws) and `plan_round` (a pure function of
them: grouping, motion, upload weights, the sync), so a test can hand
`plan_round` and `execute` draws replayed from the reference.

Each cohort or RSU group trains through the client's `run_cohort`:
``parallel=True`` (the default, the reference's vmapped path) runs the
batched client step over chunks of clients, ``parallel=False`` trains
client by client (core/clients.py); the handover pads each download
group to its power-of-two bucket when ``parallel and bucketed``, as the
reference does. The mesh paths (`MultiRSU(mesh_aggregate=...)`,
`HandoverMultiRSU(mesh_shard=True)`) shard a cohort over a cohort mesh
of `torch.distributed` ranks (launch/mesh.py): every rank runs the same
round and ends it with the same state, bitwise.

The phases are marked with `torch.profiler.record_function` ranges
(``round.plan``, ``round.batches``, ``round.clients``, ``round.comms``,
``round.aggregate``; MultiRSU and the handover mark the last four once
per RSU group), which `trace_round` reads from a profiled round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.comms.codecs import roundtrip_cohort
from repro_torch.convert import flat_spec, ravel, tree_map, unravel
from repro_torch.core import aggregation as agg
from repro_torch.core import ssl
from repro_torch.core.clients import (CLIENT_UPDATES, _stack_draws,
                                      train_sharded)
from repro_torch.core.cohort import CohortBatch, bucket_size
from repro_torch.core.collectives import is_sharded
from repro_torch.core.hierarchical import (aggregate_hierarchical,
                                           sharded_hierarchical,
                                           sharded_hierarchical_row)
from repro_torch.core.mobility import apply_motion_blur
from repro_torch.core.state import (FLConfig, FLState, generator_from,
                                    pack_host_rng, unpack_host_rng)


# --------------------------------------------------------------------------
# shared round machinery
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CohortPlan:
    """Every random choice of one SingleRSU/MultiRSU round, made before
    any training.

    ids         (n,) vehicle ids (host RNG)
    batch_idx   n arrays of cfg.batch_size indices into each vehicle's data
    velocities  (n,) float32 CPU tensor (Eq. 1)
    lr          this round's learning rate (a float32 value)
    draws       per client, per local iteration, a (pi1, pi2) draw pair
    """

    ids: np.ndarray
    batch_idx: list
    velocities: torch.Tensor
    lr: float
    draws: list


def _batch_indices(rng, data_len: int, cfg) -> np.ndarray:
    """One client's batch indices from the host RNG; small clients sample
    with replacement."""
    return rng.choice(data_len, size=cfg.batch_size,
                      replace=data_len < cfg.batch_size)


def _pi_draws(gen: torch.Generator, cfg, n: int) -> list:
    """n clients' (pi1, pi2) draw pairs, one per local iteration."""
    b = cfg.batch_size
    return [[(ssl.draw_pi1(gen, b), ssl.draw_pi2(gen, b))
             for _ in range(cfg.local_iters)] for _ in range(n)]


def _cohort_plan(rng: np.random.RandomState, gen: torch.Generator, rnd: int,
                 scenario) -> CohortPlan:
    """Draw one round's plan; advances `rng` and `gen`."""
    cfg = scenario.cfg
    ids = rng.choice(cfg.n_vehicles, size=cfg.vehicles_per_round,
                     replace=False)
    batch_idx = [_batch_indices(rng, len(scenario.data[c]), cfg) for c in ids]
    velocities = scenario.mobility.sample(gen, len(ids))
    return CohortPlan(ids=ids, batch_idx=batch_idx, velocities=velocities,
                      lr=scenario.lr_fn(rnd),
                      draws=_pi_draws(gen, cfg, len(ids)))


def _client_images(scenario, cid: int, idx, velocity, device) -> torch.Tensor:
    """One client's batch, motion-blurred by its velocity (no RNG)."""
    # analysis: allow=retrace-fresh-array -- the client's batch, uploaded
    # once a round by design
    images = torch.from_numpy(scenario.data[cid][idx]).to(device)
    if scenario.blur_images:
        images = apply_motion_blur(images, velocity,
                                   scenario.mobility.camera_const)
    return images


def _client_draws(draws: list, device) -> list:
    """One client's (pi1, pi2) draw pairs on `device`."""
    return [(ssl.draws_to(d1, device), ssl.draws_to(d2, device))
            for d1, d2 in draws]


def _host_losses(losses: torch.Tensor) -> np.ndarray:
    return losses.cpu().numpy().astype(np.float64)


def _region_sync_weights(mob, blur_sum, upload_count,
                         count_scaled: bool) -> np.ndarray:
    """Level-2 sync weights: Eq. 11 over each RSU's mean blur since the
    last sync (the prior mean blur where it had no uploads), optionally
    scaled by its upload count; float32 weights, scaled and normalized in
    float64, as the reference does."""
    counts = np.asarray(upload_count, np.float64)
    mean_blur = np.where(
        counts > 0, np.asarray(blur_sum, np.float64) / np.maximum(counts, 1.0),
        float(mob.blur_level(mob.mu)))
    W = agg.flsimco_weights(
        torch.from_numpy(mean_blur.astype(np.float32))).numpy()
    if count_scaled:
        W = W * counts
    s = W.sum()
    return W / s if s > 1e-12 else np.full_like(W, 1.0 / len(W))


def _require_flsimco(cfg: FLConfig, name: str) -> None:
    if cfg.aggregator != "flsimco":
        raise ValueError(
            f"{name} implements the hierarchical Eq.-11 (blur-weighted) "
            f"extension and requires aggregator='flsimco'; got "
            f"{cfg.aggregator!r}. Run other schemes under SingleRSU.")
    if not cfg.normalize_weights:
        raise ValueError(
            f"{name} always normalizes Eq.-11 weights; "
            f"normalize_weights=False would break the MultiRSU(1) == "
            f"SingleRSU equivalence. Use SingleRSU for the unnormalized "
            f"literal form.")


class Topology:
    """Strategy object: the structure of one federated round.

    validate(cfg, device)               fail fast on unsupported configs
    signature()                         static parameters, JSON-able
    init_state(cfg, mobility,
               global_tree, gen)        -> the round-0 `FLState.topo`
    run_round(state, scenario)          -> (new FLState, round record)
    """

    name = "base"

    def validate(self, cfg: FLConfig, device=None) -> None:
        pass

    def signature(self) -> dict:
        return {"name": self.name}

    def init_state(self, cfg: FLConfig, mobility, global_tree,
                   gen: torch.Generator) -> dict:
        return {}

    def run_round(self, state: FLState, scenario, parallel: bool = True):
        raise NotImplementedError


class SingleRSU(Topology):
    """Paper-exact FLSimCo: one RSU aggregating one sampled cohort."""

    name = "single"

    def run_round(self, state: FLState, scenario, parallel: bool = True):
        """One round: (state, scenario) -> (new state, record).
        `parallel` picks the batched (True) or the client-by-client
        cohort step."""
        with record_function("round.plan"):
            rng = unpack_host_rng(state.host_rng)
            gen = generator_from(state.gen_state)
            plan = _cohort_plan(rng, gen, state.round, scenario)
        state, rec = self.execute(state, scenario, plan, parallel)
        return state.replace(gen_state=gen.get_state(),
                             host_rng=pack_host_rng(rng)), rec

    def _batches(self, scenario, plan: CohortPlan):
        """The plan's batches, draws and velocities on the device."""
        device = scenario.device
        with record_function("round.batches"):
            batches = [_client_images(scenario, c, idx, v, device)
                       for c, idx, v in zip(plan.ids, plan.batch_idx,
                                            plan.velocities)]
            draws = [_client_draws(d, device) for d in plan.draws]
            return batches, draws, plan.velocities.to(device)

    def execute(self, state: FLState, scenario, plan: CohortPlan,
                parallel: bool = True):
        """Run `plan` from `state` (its tree, client state and comms) on
        the scenario's device. Returns (state after the round, record);
        the RNG fields are left as they were."""
        cfg, mob = scenario.cfg, scenario.mobility
        client = CLIENT_UPDATES[cfg.client]
        tree = tree_map(lambda t: t.to(scenario.device), state.global_tree)
        batches, draws, v = self._batches(scenario, plan)
        with record_function("round.clients"):
            cohort, uploads = client.run_cohort(
                cfg, tree, state.client_state, batches, draws, plan.lr,
                parallel=parallel)
            cohort = cohort.with_stats(velocities=v, blur=mob.blur_level(v))
        # comms tier: the RSU aggregates what survived the V2I link
        # (encode -> decode against the broadcast base model); identity
        # passes the cohort through, the lossless delta codec is bitwise
        with record_function("round.comms"):
            cohort, comms = roundtrip_cohort(cfg, cohort, tree, state.comms)
        with record_function("round.aggregate"):
            new_tree = agg.AGGREGATORS[cfg.aggregator](cohort, cfg)
        new_cs = client.finalize(cfg, state.client_state, new_tree, uploads)
        losses = _host_losses(cohort.valid_losses)
        rec = {"round": state.round, "loss": float(np.mean(losses)),
               "velocities": plan.velocities.tolist(), "lr": plan.lr,
               "topology": self.name}
        return state.replace(global_tree=new_tree, round=state.round + 1,
                             client_state=new_cs, comms=comms), rec


class MultiRSU(SingleRSU):
    """N RSUs + regional server, no motion: hierarchical Eq. 11.

    The cohort (drawn as SingleRSU draws it, batches in round order) is
    dealt round-robin across RSUs; each RSU trains its group (one batched
    step a group under ``parallel=True``), the codec
    stage runs per group with the cohort indices as error-feedback slots,
    and `aggregate_hierarchical` merges the groups. FedCo uploads are
    kept in group order.

    The mesh (`resolve_mesh`): ``mesh_aggregate=None`` (the default)
    promotes the round to a (pod=n_rsus, data=d) cohort mesh whenever
    the process group has 2 ranks or more and the cohort splits evenly;
    True forces the mesh (actionable errors when it cannot be built);
    False pins the host path. With a mesh of more than one rank, a
    DT-SSL round under ``parallel=True`` shards whole: each rank trains
    its block of the RSU-major cohort, runs the codec on it (slots
    ``rows=perm``) and the two levels reduce through
    `sharded_hierarchical` with `mesh_reduction` ("exact": bitwise the
    host merge of the same rows; "psum": float-close). Otherwise every
    rank trains the groups on the host path and, on a mesh (one rank
    included), merges them through `sharded_hierarchical`.
    """

    name = "multi"

    def __init__(self, n_rsus: int = 2, count_scaled: bool = True,
                 mesh_aggregate: Optional[bool] = None,
                 mesh_reduction: str = "exact"):
        if n_rsus < 1:
            raise ValueError("n_rsus must be >= 1")
        if mesh_reduction not in ("exact", "psum"):
            raise ValueError(f"mesh_reduction {mesh_reduction!r} not in "
                             f"('exact', 'psum')")
        self.n_rsus = n_rsus
        self.count_scaled = count_scaled
        self.mesh_aggregate = mesh_aggregate
        self.mesh_reduction = mesh_reduction

    def signature(self) -> dict:
        return {"name": self.name, "n_rsus": self.n_rsus,
                "count_scaled": self.count_scaled,
                "mesh_aggregate": self.mesh_aggregate,
                "mesh_reduction": self.mesh_reduction}

    def resolve_mesh(self, cfg: FLConfig, device=None):
        """The cohort mesh this topology's rounds run on (on `device`'s
        type, None meaning CUDA), or None for the host path. Explicit
        True raises the actionable errors (ranks needed against ranks
        there, an uneven cohort) instead of falling back."""
        from repro_torch.launch.mesh import (cohort_axis_divisor,
                                             cohort_mesh, maybe_cohort_mesh)
        if self.mesh_aggregate is False:
            return None
        n = cfg.vehicles_per_round
        if n % self.n_rsus:
            if self.mesh_aggregate:
                raise ValueError(
                    f"mesh_aggregate needs equal per-RSU cohorts: "
                    f"vehicles_per_round={n} not divisible by "
                    f"n_rsus={self.n_rsus} — pick n_rsus dividing the "
                    f"cohort, or mesh_aggregate=None to auto-fall-back")
            return None
        s = n // self.n_rsus
        if self.mesh_aggregate:
            return cohort_mesh(self.n_rsus,
                               cohort_axis_divisor(s, self.n_rsus), device)
        return maybe_cohort_mesh(self.n_rsus, s, device)

    def validate(self, cfg: FLConfig, device=None) -> None:
        _require_flsimco(cfg, "MultiRSU")
        # fail before any training, not after the cohort has run
        self.resolve_mesh(cfg, device)

    def rsu_groups(self, n: int) -> list:
        """The non-empty round-robin groups of a cohort of n: one array of
        cohort indices per RSU."""
        assign = np.arange(n) % self.n_rsus
        sels = [np.where(assign == rsu)[0] for rsu in range(self.n_rsus)]
        return [s for s in sels if s.size]

    def execute(self, state: FLState, scenario, plan: CohortPlan,
                parallel: bool = True):
        cfg, mob = scenario.cfg, scenario.mobility
        client = CLIENT_UPDATES[cfg.client]
        tree = tree_map(lambda t: t.to(scenario.device), state.global_tree)
        batches, draws, v = self._batches(scenario, plan)
        blur = mob.blur_level(v)
        sels = self.rsu_groups(len(plan.ids))
        mesh = self.resolve_mesh(cfg, scenario.device)
        if is_sharded(mesh) and parallel and cfg.client == "dtssl":
            return self._sharded_round(state, scenario, plan, tree, batches,
                                       draws, v, blur, sels, mesh)
        comms, cohorts, uploads = state.comms, [], []
        for sel in sels:
            rows = torch.from_numpy(sel).to(v.device)
            with record_function("round.clients"):
                cohort, ups = client.run_cohort(
                    cfg, tree, state.client_state, [batches[i] for i in sel],
                    [draws[i] for i in sel], plan.lr, parallel=parallel)
                cohort = cohort.with_stats(velocities=v[rows],
                                           blur=blur[rows])
            # the codec is row-wise: per-group roundtrips with rows=sel
            # keep each client's error-feedback slot at its cohort index
            with record_function("round.comms"):
                cohort, comms = roundtrip_cohort(cfg, cohort, tree, comms,
                                                 rows=sel)
            cohorts.append(cohort)
            uploads.extend(ups or [])
        with record_function("round.aggregate"):
            if mesh is None:
                new_tree = aggregate_hierarchical(
                    cohorts, count_scaled=self.count_scaled)
            else:
                new_tree = self._mesh_aggregate(cohorts, mesh)
        new_cs = client.finalize(cfg, state.client_state, new_tree,
                                 uploads or None)
        losses = torch.cat([c.valid_losses for c in cohorts])
        return self._finish(state, plan, sels, new_tree, new_cs, comms,
                            losses)

    def _finish(self, state, plan, sels, new_tree, new_cs, comms, losses):
        rec = {"round": state.round,
               "loss": float(np.mean(_host_losses(losses))),
               "velocities": plan.velocities.tolist(), "lr": plan.lr,
               "topology": self.name,
               "rsu_sizes": [int(s.size) for s in sels]}
        return state.replace(global_tree=new_tree, round=state.round + 1,
                             client_state=new_cs, comms=comms), rec

    def _sharded_round(self, state, scenario, plan, tree, batches, draws, v,
                       blur, sels, mesh):
        """The round sharded whole over `mesh` (`sharded_step`), from the
        plan's per-client batches and draws; the losses come back
        RSU-major, as the host path's."""
        perm = torch.from_numpy(np.concatenate(sels)).to(v.device)
        blk = perm[CohortBatch.sharding_spec(mesh, perm.numel())].tolist()
        row, comms, losses = self.sharded_step(
            scenario.cfg, tree, torch.stack([batches[i] for i in blk]),
            _stack_draws([draws[i] for i in blk]), plan.lr, v, blur,
            state.comms, perm, mesh)
        return self._finish(state, plan, sels, unravel(row, flat_spec(tree)),
                            None, comms, losses)

    def sharded_step(self, cfg, tree, images, draws, lr, velocities, blur,
                     comms, perm, mesh):
        """A DT-SSL round's work over a mesh of more than one rank, for
        `execute` and the campaign engine's round body alike: this rank
        trains its block of the RSU-major cohort ``perm`` (a (n,) device
        index tensor) from `tree` (images (b, B, H, W, C) and the draws
        stacked over the block's b clients, as `clients.train_sharded`
        takes them); the cohort takes ``velocities`` and ``blur`` (cohort
        order) at ``perm``; the codec runs on the block (error-feedback
        slot = cohort index) and `sharded_hierarchical_row` merges.
        Returns (the (P,) global row, comms, the (n,) losses RSU-major),
        the same on every rank."""
        with record_function("round.clients"):
            cohort = train_sharded(cfg, tree, images, draws, lr, mesh,
                                   perm.numel())
            cohort = cohort.with_stats(velocities=velocities[perm],
                                       blur=blur[perm])
        with record_function("round.comms"):
            cohort, comms = roundtrip_cohort(cfg, cohort, tree, comms,
                                             rows=perm)
        with record_function("round.aggregate"):
            row = sharded_hierarchical_row(
                cohort, mesh, self.n_rsus, count_scaled=self.count_scaled,
                reduction=self.mesh_reduction)
        return row, comms, cohort.valid_losses

    def _mesh_aggregate(self, cohorts, mesh) -> dict:
        """The host-trained groups merged over the cohort mesh, as one
        RSU-major cohort of their valid rows."""
        sizes = sorted(c.n for c in cohorts)
        if len(set(sizes)) != 1:
            raise ValueError(f"mesh_aggregate needs equal per-RSU cohorts; "
                             f"got sizes {sizes}")
        return sharded_hierarchical(CohortBatch.concat(cohorts), mesh,
                                    len(cohorts),
                                    count_scaled=self.count_scaled,
                                    reduction=self.mesh_reduction)


@dataclass(frozen=True)
class HandoverDraws:
    """Every random draw of one handover round.

    ids       (n,) vehicle ids (host RNG)
    idx       (n, batch_size) batch indices, drawn in download-group order
    fleet_v   (n_vehicles,) float32 velocities of the whole fleet
    draws     per participant (cohort order), per local iteration, a
              (pi1, pi2) draw pair
    """

    ids: np.ndarray
    idx: np.ndarray
    fleet_v: torch.Tensor
    draws: list


@dataclass(frozen=True)
class HandoverPlan:
    """One handover round, derived from its `HandoverDraws` and the topo
    state. Arrays are host numpy unless marked.

    velocities    (n,) float32 CPU tensor, the participants' fleet_v
    down, up      (n,) int64 download and upload RSU of each participant
    down_groups   [(rsu, cohort indices)] of the non-empty download groups
    positions     (n_vehicles,) float32 fleet positions after the round
    stale         (n,) bool, up != down
    blur          (n,) float32 Eq.-2 blur of each participant
    uploads       [(rsu, cohort indices, float64 weights)] of each upload
                  group with usable weight
    upload_sizes  participants uploading to each RSU (empty ones too)
    synced        whether the region merges the RSU models this round
    sync_W        (n_rsus,) level-2 weights when synced, else None
    blur_sum, upload_count  the (n_rsus,) float64 accumulators after the
                  round (reset by a sync)
    """

    ids: np.ndarray
    idx: np.ndarray
    velocities: torch.Tensor
    lr: float
    draws: list
    down: np.ndarray
    down_groups: list
    positions: np.ndarray
    up: np.ndarray
    stale: np.ndarray
    blur: np.ndarray
    uploads: list
    upload_sizes: list
    synced: bool
    sync_W: Optional[np.ndarray]
    blur_sum: np.ndarray
    upload_count: np.ndarray


class HandoverMultiRSU(Topology):
    """MultiRSU with persistent per-RSU models and vehicle motion.

    Ring road of length n_rsus * rsu_range; RSU r covers [r*rsu_range,
    (r+1)*rsu_range). Each round every vehicle advances by
    v * round_duration (wrapping), so a participant can download from RSU
    A and upload to RSU B; such stale uploads have their Eq.-11 weight
    scaled by `stale_discount` before renormalization. An RSU with no
    usable upload keeps its model. Every `sync_every` rounds the region
    merges the RSU models with blur-weighted, upload-count-scaled
    weights accumulated since the last sync.

    `FLState.topo`: positions (n_vehicles,) float32, rsu_models (a tuple
    of n_rsus trees), blur_sum and upload_count (n_rsus,) float64.

    Under ``parallel=True`` each download group trains as one batched
    step; with `bucketed` (the default) it is first padded to its
    power-of-two `bucket_size` by repeating the last client's batch and
    draws (no random numbers drawn), and the padded rows are masked out,
    as in the reference. `bucketed=False` runs each group at its exact
    size; ``parallel=False`` trains client by client and never pads. As
    in the reference, `bucketed` is not part of `signature` (it changes
    no result beyond rounding). `mesh_shard=True` (opt-in) shards each
    download group's client work over ``maybe_cohort_mesh(1,
    bucket_size(vehicles_per_round))`` under ``parallel=True`` where the
    process group has 2 ranks or more: each rank trains its block of the
    group (float-close against the unsharded step), and the group is
    gathered back before its codec stage, so the regrouping, uploads and
    sync run as on the host path, the same on every rank.
    """

    name = "handover"

    def __init__(self, n_rsus: int = 2, rsu_range: float = 1000.0,
                 round_duration: float = 20.0, stale_discount: float = 0.5,
                 sync_every: int = 5, count_scaled: bool = True,
                 bucketed: bool = True, mesh_shard: bool = False):
        if n_rsus < 1:
            raise ValueError("n_rsus must be >= 1")
        if not 0.0 <= stale_discount <= 1.0:
            raise ValueError("stale_discount must be in [0, 1]")
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        self.n_rsus = n_rsus
        self.rsu_range = rsu_range
        self.road_length = n_rsus * rsu_range
        self.round_duration = round_duration
        self.stale_discount = stale_discount
        self.sync_every = sync_every
        self.count_scaled = count_scaled
        self.bucketed = bucketed
        self.mesh_shard = mesh_shard

    def signature(self) -> dict:
        return {"name": self.name, "n_rsus": self.n_rsus,
                "rsu_range": self.rsu_range,
                "round_duration": self.round_duration,
                "stale_discount": self.stale_discount,
                "sync_every": self.sync_every,
                "count_scaled": self.count_scaled,
                "mesh_shard": self.mesh_shard}

    def validate(self, cfg: FLConfig, device=None) -> None:
        _require_flsimco(cfg, "HandoverMultiRSU")
        if cfg.client != "dtssl":
            raise ValueError(
                "HandoverMultiRSU keeps divergent per-RSU models between "
                "syncs, so client algorithms with global server state "
                f"(client={cfg.client!r}) are undefined here; use "
                "client='dtssl' or the SingleRSU/MultiRSU topologies.")

    def init_state(self, cfg: FLConfig, mobility, global_tree,
                   gen: torch.Generator) -> dict:
        """Uniform positions from `gen`; every RSU starts from the global
        tree; zero sync statistics."""
        positions = mobility.init_positions(gen, cfg.n_vehicles,
                                            self.road_length).numpy()
        return {"positions": positions,
                "rsu_models": tuple([global_tree] * self.n_rsus),
                "blur_sum": np.zeros(self.n_rsus),
                "upload_count": np.zeros(self.n_rsus)}

    def pad_to(self, group_size: int):
        """The padded size of a download group under the batched step:
        its `bucket_size` when `bucketed`, else None (exact size)."""
        return bucket_size(int(group_size)) if self.bucketed else None

    def rsu_index(self, positions) -> np.ndarray:
        return (np.floor_divide(np.asarray(positions), self.rsu_range)
                .astype(np.int64) % self.n_rsus)

    def draw_round(self, rng: np.random.RandomState, gen: torch.Generator,
                   positions: np.ndarray, scenario) -> HandoverDraws:
        """The round's draws; advances `rng` and `gen`. Host: the cohort
        ids, then each participant's batch indices in download-group
        order. Generator: the whole fleet's velocities, then each
        participant's pi1/pi2 draws in cohort order."""
        cfg = scenario.cfg
        ids = rng.choice(cfg.n_vehicles, size=cfg.vehicles_per_round,
                         replace=False)
        idx = np.empty((len(ids), cfg.batch_size), np.int64)
        down = self.rsu_index(positions[ids])
        for i in np.argsort(down, kind="stable"):
            idx[i] = _batch_indices(rng, len(scenario.data[ids[i]]), cfg)
        fleet_v = scenario.mobility.sample(gen, cfg.n_vehicles)
        return HandoverDraws(ids=ids, idx=idx, fleet_v=fleet_v,
                             draws=_pi_draws(gen, cfg, len(ids)))

    def plan_round(self, draws: HandoverDraws, rnd: int, positions,
                   blur_sum, upload_count, scenario) -> HandoverPlan:
        """Everything about the round that does not depend on training,
        from its draws and the topo state (taken by value): grouping,
        motion, upload weights with staleness discounts, the sync and its
        weights, the accumulators' successors. Pure."""
        mob = scenario.mobility
        ids = draws.ids
        # analysis: allow=retrace-fresh-array -- CPU plan tensor
        velocities = draws.fleet_v[torch.from_numpy(ids)]
        down = self.rsu_index(positions[ids])
        down_groups = [(rsu, np.where(down == rsu)[0])
                       for rsu in range(self.n_rsus) if (down == rsu).any()]
        # analysis: allow=host-sync-fetch,retrace-fresh-array -- CPU plan
        # tensor
        positions = mob.advance_positions(
            torch.tensor(positions, dtype=torch.float32), draws.fleet_v,
            self.round_duration, self.road_length).numpy()
        up = self.rsu_index(positions[ids])
        stale = up != down
        # analysis: allow=host-sync-fetch -- CPU plan tensor
        blur = mob.blur_level(velocities).numpy()
        # this round's uploads to each RSU, added to the accumulators
        # below (new arrays: the inputs are left as they were)
        new_blur, new_count = np.zeros(self.n_rsus), np.zeros(self.n_rsus)
        upload_sizes, uploads = [], []
        for rsu in range(self.n_rsus):
            sel = np.where(up == rsu)[0]
            upload_sizes.append(int(sel.size))
            if sel.size == 0:
                continue
            # float32 Eq.-11 weights times a float64 discount, normalized
            # in float64, as the reference does; rounded to float32 only
            # at the weighted sum
            # analysis: allow=host-sync-fetch,retrace-fresh-array -- CPU
            # plan tensor
            w = agg.flsimco_weights(torch.from_numpy(blur[sel])).numpy()
            w = w * np.where(stale[sel], self.stale_discount, 1.0)
            s = w.sum()
            if s <= 1e-12:
                # every upload stale with stale_discount=0: the RSU keeps
                # its model, as if it had received none
                continue
            uploads.append((rsu, sel, w / s))
            new_blur[rsu] = blur[sel].sum()
            new_count[rsu] = sel.size
        blur_sum = np.add(blur_sum, new_blur, dtype=np.float64)
        upload_count = np.add(upload_count, new_count, dtype=np.float64)
        synced = (rnd + 1) % self.sync_every == 0
        sync_W = None
        if synced:
            sync_W = _region_sync_weights(mob, blur_sum, upload_count,
                                          self.count_scaled)
            blur_sum = np.zeros(self.n_rsus)
            upload_count = np.zeros(self.n_rsus)
        return HandoverPlan(
            ids=ids, idx=draws.idx, velocities=velocities,
            lr=scenario.lr_fn(rnd), draws=draws.draws, down=down,
            down_groups=down_groups, positions=positions, up=up,
            stale=stale, blur=blur, uploads=uploads,
            upload_sizes=upload_sizes, synced=synced, sync_W=sync_W,
            blur_sum=blur_sum, upload_count=upload_count)

    def run_round(self, state: FLState, scenario, parallel: bool = True):
        """One round: (state, scenario) -> (new state, record).
        `parallel` picks the batched (True) or the client-by-client
        cohort step."""
        with record_function("round.plan"):
            rng = unpack_host_rng(state.host_rng)
            gen = generator_from(state.gen_state)
            positions = state.topo["positions"]
            draws = self.draw_round(rng, gen, positions, scenario)
            plan = self.plan_round(draws, state.round, positions,
                                   state.topo["blur_sum"],
                                   state.topo["upload_count"], scenario)
        state, rec = self.execute(state, scenario, plan, parallel)
        return state.replace(gen_state=gen.get_state(),
                             host_rng=pack_host_rng(rng)), rec

    def execute(self, state: FLState, scenario, plan: HandoverPlan,
                parallel: bool = True):
        """Run `plan` from `state` on the scenario's device. Returns
        (state after the round, record); the RNG fields are left as they
        were."""
        cfg, device = scenario.cfg, scenario.device
        client = CLIENT_UPDATES[cfg.client]
        rsu_models = [tree_map(lambda t: t.to(device), model)
                      for model in state.topo["rsu_models"]]
        mesh = None
        if self.mesh_shard and parallel:
            from repro_torch.launch.mesh import maybe_cohort_mesh
            mesh = maybe_cohort_mesh(1, bucket_size(cfg.vehicles_per_round),
                                     device)
        comms, group_sel, group_cohorts = state.comms, [], []
        # Step 2: each download group trains from its RSU's model; the
        # delta base of a client is its download RSU's model and its
        # error-feedback slot its cohort index
        for rsu, sel in plan.down_groups:
            with record_function("round.batches"):
                batches = [_client_images(scenario, plan.ids[i],
                                          plan.idx[i], plan.velocities[i],
                                          device) for i in sel]
                draws = [_client_draws(plan.draws[i], device) for i in sel]
            with record_function("round.clients"):
                cohort, _ = client.run_cohort(
                    cfg, rsu_models[rsu], state.client_state, batches,
                    draws, plan.lr, parallel=parallel,
                    pad_to=self.pad_to(sel.size) if parallel else None,
                    mesh=mesh)
                cohort = cohort.gather()
            with record_function("round.comms"):
                cohort, comms = roundtrip_cohort(cfg, cohort,
                                                 rsu_models[rsu], comms,
                                                 rows=sel)
            group_sel.append(sel)
            group_cohorts.append(cohort)
        # Step 3-4: one cohort of all n clients, rows in download-group
        # order; each upload group is gathered from it through row_of in
        # its cohort-index order (the order of its weighted sum)
        with record_function("round.aggregate"):
            n = len(plan.ids)
            full = CohortBatch.concat(group_cohorts)
            row_of = np.empty(n, np.int64)
            row_of[np.concatenate(group_sel)] = np.arange(n)
            merged = [None] * self.n_rsus       # flat rows merged this round
            for rsu, sel, w in plan.uploads:
                merged[rsu] = agg.cohort_weighted_row(full.take(row_of[sel]),
                                                      w)
                rsu_models[rsu] = unravel(merged[rsu], full.spec)
            # between syncs the global tree keeps the last merged model
            new_tree = state.global_tree
            if plan.synced:
                flat = torch.stack([ravel(m) if r is None else r
                                    for r, m in zip(merged, rsu_models)])
                new_tree = agg._weighted_stacked_sum(flat, full.spec,
                                                     plan.sync_W)
                rsu_models = [new_tree] * self.n_rsus
        losses = _host_losses(full.losses)[row_of]      # cohort order
        rec = {"round": state.round, "loss": float(np.mean(losses)),
               "velocities": plan.velocities.tolist(), "lr": plan.lr,
               "topology": self.name, "rsu_sizes": plan.upload_sizes,
               "n_handovers": int(plan.stale.sum()), "synced": plan.synced}
        topo = {"positions": plan.positions, "rsu_models": tuple(rsu_models),
                "blur_sum": plan.blur_sum, "upload_count": plan.upload_count}
        return state.replace(global_tree=new_tree, round=state.round + 1,
                             topo=topo, comms=comms), rec

    def region_view(self, state: FLState) -> dict:
        """Uniform merge of the current per-RSU models, an evaluation
        snapshot between syncs; the state is not touched."""
        return agg.aggregate_fedavg(list(state.topo["rsu_models"]))


TOPOLOGIES = {
    "single": SingleRSU,
    "multi": MultiRSU,
    "handover": HandoverMultiRSU,
}
