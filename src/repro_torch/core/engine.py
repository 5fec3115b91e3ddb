"""Whole-campaign execution: rounds planned ahead, each round replayed
from one CUDA graph on the card.

Counterpart of `repro.core.engine` (`check_campaign_supported`,
`resolve_mode`, `_data_stack`, `_plan_cohort_chunk`,
`_plan_handover_chunk`, `_build_cohort_body`, `_build_handover_body`,
`campaign_callables`, `compile_counts`, `reset_engine_caches`,
`_carry_of`, `_state_of`, `_plan_chunk`, `run_campaign`).

Everything about a round that does not depend on training is a function
of the two random streams and the topology's host state: cohort ids and
batch indices (host MT19937), velocities and the pi1/pi2 draws (the CPU
`torch.Generator`), the learning rate (the round index), and for the
handover the motion, the grouping, the upload weights and the sync. So a
campaign of K rounds splits into

  plan     K rounds drawn ahead on the host through the eager round's
           own helpers (`topology._cohort_plan`, `_batch_indices`,
           `HandoverMultiRSU.draw_round` / `plan_round`), so the host
           MT19937 and the generator advance exactly as K eager rounds
           advance them; each round packed into a few device tensors, its
           ``xs`` (ids, batch indices, the draws stacked over clients,
           velocities, blur, ``lr`` as a 0-d float32 tensor; for the
           handover also ``down``, the zero-padded (R, n) upload-weight
           matrix ``wmat``, ``has_up``, the ``sync`` flag and ``sync_w``);
           the records are built here, their loss filled in later;
  execute  one round body a round, from the carry (the global model as a
           flat row; the handover's RSU models as (R, P) rows; a stateful
           codec's error feedback) and the round's xs to the next carry
           and the round's per-client losses, fetched once a chunk.

Modes:
  "eager"  the body as plain torch ops, round by round: the CPU path and
           the oracle.
  "graph"  CUDA only. The body captured once in a `torch.cuda.CUDAGraph`
           and replayed every round: a round copies its xs into the
           graph's static buffers and replays, and the captured body
           writes its next carry back into the carry's buffers.
  "auto"   eager on the CPU, graph on CUDA.
The reference's names map: "jit" is "eager", "scan" is "graph". The port
has no `lax.scan`: the reference scans so that XLA runs many rounds with
no host in between, and one graph of one round already replays a whole
round with none; a chunk is a loop of replays.

Sharded cohorts. A MultiRSU scenario whose `resolve_mesh` gives a cohort
mesh of more than one rank (launch/mesh.py) runs its round body sharded,
through the eager sharded round's own `MultiRSU.sharded_step`: each rank
trains its block of the RSU-major cohort, the codec runs on the block,
and `sharded_hierarchical_row` merges; every rank ends each round with
the same carry. That body runs eagerly: a CUDA graph over NCCL collectives
across ranks cannot be checked on a one-card machine, so "auto" resolves
to eager there and "graph" raises (ROADMAP.md, Later work: graph mode
over a multi-rank mesh). At one rank the body and the graph are the host
ones.

Graph mode. A campaign's first round that finds no graph for its key and
shapes runs the body on a side stream, through the static buffers: the
warm-up, which loads every kernel library, sets dt_loss's attributes and
lets cuDNN choose its plans, and which is a round of the campaign. Then
the body is captured into a private memory pool. `compile_counts` counts
captures: one per campaign key, whatever the chunking, the bound
`analysis.guards.ENGINE_COMPILE_BOUNDS` holds; each capture is also counted
by `analysis.guards.track_compiles`. At most one graph
lives at a time, since its pool holds a round's peak (about 52 GiB at
Table 1): capturing another frees the first, and `reset_engine_caches`
frees it. A capture that fails raises; nothing falls back to the eager
body. The kernels' counters count wrapper calls, which a capture makes
without running the kernels and a replay runs without making: the engine
takes the capture's counts back and adds them at every replay
(`ops.add_launches`), so a counter still reads launches that ran.

What holds (tests/test_torch_engine.py, chip_smoke.py ``[engine]``):
the schedule (every record field but the loss, host_rng, gen_state, the
handover's positions and accumulators) is bitwise the eager `run`'s in
either mode. On the CPU, any chunking and any checkpoint split is
bitwise the uninterrupted campaign, and the trees are bitwise
`run(parallel=True)`'s where the body trains the same chunks
(SingleRSU). MultiRSU's body trains the cohort in order (the eager round
trains group by group) and the handover's the whole cohort with each
client's init tree gathered from its download RSU (the eager round
trains each download group padded to its bucket): "regrouping is data,
not shape", so one body covers every round. There the trees agree
within the port's tolerances. On the card, runs are not bitwise
repeatable: chip_smoke.py holds graph against eager within its
CROSS_MAX_ABS, chunk by chunk from one state.
"""
from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.profiler import record_function

from repro_torch.analysis.guards import no_implicit_transfers, record_compile
from repro_torch.comms.codecs import CODECS, roundtrip_cohort
from repro_torch.convert import flat_spec, ravel, unravel
from repro_torch.core import aggregation as agg
from repro_torch.core.clients import _stack_draws, train_chunks
from repro_torch.core.cohort import CohortBatch
from repro_torch.core.collectives import is_sharded
from repro_torch.core.hierarchical import hierarchical_row
from repro_torch.core.mobility import apply_motion_blur
from repro_torch.core.state import (FLState, generator_from, pack_host_rng,
                                    unpack_host_rng)
from repro_torch.core.topology import (HandoverMultiRSU, MultiRSU, SingleRSU,
                                       _cohort_plan)
from repro_torch.kernels import ops

MODES = ("auto", "eager", "graph", "jit", "scan")
_REFERENCE_NAMES = {"jit": "eager", "scan": "graph"}


# --------------------------------------------------------------------------
# support checks and modes
# --------------------------------------------------------------------------

def check_campaign_supported(scenario) -> None:
    """Fail fast, before any capture, on what the engine cannot express,
    MultiRSU's mesh errors included."""
    cfg, topo = scenario.cfg, scenario.topology
    if cfg.client != "dtssl":
        raise ValueError(
            "run_campaign runs the cohort as one batched client step, "
            "which needs a stateless client update; "
            f"client={cfg.client!r} is sequential (FedCo threads a MoCo "
            "key encoder and queue through the cohort). Use the eager "
            "run()/run_round() loop for it.")
    if type(topo) is MultiRSU:
        topo.resolve_mesh(cfg, scenario.device)
    if type(topo) not in (SingleRSU, MultiRSU, HandoverMultiRSU):
        raise ValueError(
            f"run_campaign supports the built-in topologies "
            f"(single/multi/handover); got {type(topo).__name__}. "
            "Custom topologies run through the eager run() loop.")


def _campaign_mesh(scenario):
    """The cohort mesh of more than one rank a MultiRSU campaign shards
    over, else None."""
    topo = scenario.topology
    if type(topo) is not MultiRSU:
        return None
    mesh = topo.resolve_mesh(scenario.cfg, scenario.device)
    return mesh if is_sharded(mesh) else None


def resolve_mode(mode: str, device, sharded: bool = False) -> str:
    """"eager" or "graph" for a scenario on `device`: "auto" is eager on
    the CPU and graph on CUDA; the reference's "jit" is eager and "scan"
    graph. A graph needs CUDA and one rank: a `sharded` campaign (a mesh
    of more than one rank) runs eagerly."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    mode = _REFERENCE_NAMES.get(mode, mode)
    on_cuda = torch.device(device).type == "cuda"
    if mode == "graph" and sharded:
        raise NotImplementedError(
            "mode='graph' over a cohort mesh of more than one rank is not "
            "ported; see ROADMAP.md, Later work (graph mode over a "
            "multi-rank mesh). Use mode='eager'")
    if mode == "auto":
        return "graph" if on_cuda and not sharded else "eager"
    if mode == "graph" and not on_cuda:
        raise ValueError("mode='graph' captures a CUDA graph, and this "
                         "scenario runs on the CPU; use mode='eager'")
    return mode


# --------------------------------------------------------------------------
# schedule planning (the eager round's draws, in its order)
# --------------------------------------------------------------------------

def _data_stack(scenario) -> torch.Tensor:
    """The vehicles' images as one CPU tensor (n_vehicles, maxlen, ...),
    each vehicle's rows zero-padded to the longest; the padding is never
    indexed (batch indices are drawn against each vehicle's own length,
    as in the eager round)."""
    data = scenario.data
    maxlen = max(len(d) for d in data)
    stack = np.zeros((len(data), maxlen) + data[0].shape[1:], data[0].dtype)
    for c, d in enumerate(data):
        stack[c, :len(d)] = d
    return torch.from_numpy(stack)


def _xs_on(xs: dict, scenario) -> dict:
    return pytree.tree_map(lambda t: t.to(scenario.device), xs)


def _cohort_round(plan, scenario, rnd: int):
    """(xs, record) of one planned SingleRSU/MultiRSU round."""
    topo = scenario.topology
    # analysis: allow=retrace-fresh-array -- the round's planned xs, packed
    # once at planning
    xs = _xs_on({
        "ids": torch.from_numpy(plan.ids.astype(np.int64)),
        "idx": torch.from_numpy(np.stack(plan.batch_idx).astype(np.int64)),
        "draws": _stack_draws(plan.draws),
        "velocities": plan.velocities,
        "blur": scenario.mobility.blur_level(plan.velocities),
        "lr": torch.tensor(plan.lr, dtype=torch.float32)}, scenario)
    # analysis: allow=host-sync-fetch -- CPU plan tensor
    rec = {"round": rnd, "loss": None,
           "velocities": plan.velocities.tolist(), "lr": plan.lr,
           "topology": topo.name}
    if type(topo) is MultiRSU:
        rec["rsu_sizes"] = [int(s.size)
                            for s in topo.rsu_groups(len(plan.ids))]
    return xs, rec


def _handover_round(plan, scenario, rnd: int):
    """(xs, record) of one `HandoverPlan`: each upload group's weights at
    its clients' cohort indices of a zero (R, n) matrix, rounded to
    float32 as the eager round's weighted sum rounds them."""
    topo = scenario.topology
    R, n = topo.n_rsus, len(plan.ids)
    wmat = np.zeros((R, n), np.float32)
    has_up = np.zeros((R,), bool)
    for rsu, sel, w in plan.uploads:
        wmat[rsu, sel] = w
        has_up[rsu] = True
    sync_w = plan.sync_W if plan.synced else np.zeros(R)
    # analysis: allow=retrace-fresh-array -- the round's planned xs, packed
    # once at planning
    xs = _xs_on({
        "ids": torch.from_numpy(plan.ids.astype(np.int64)),
        "idx": torch.from_numpy(plan.idx.astype(np.int64)),
        "draws": _stack_draws(plan.draws),
        "velocities": plan.velocities,
        "lr": torch.tensor(plan.lr, dtype=torch.float32),
        "down": torch.from_numpy(plan.down.astype(np.int64)),
        "wmat": torch.from_numpy(wmat),
        "has_up": torch.from_numpy(has_up),
        "sync": torch.tensor(bool(plan.synced)),
        "sync_w": torch.from_numpy(sync_w.astype(np.float32))}, scenario)
    # analysis: allow=host-sync-fetch,host-sync-cast -- CPU plan tensor and
    # host numpy plan values
    rec = {"round": rnd, "loss": None,
           "velocities": plan.velocities.tolist(), "lr": plan.lr,
           "topology": topo.name, "rsu_sizes": plan.upload_sizes,
           "n_handovers": int(plan.stale.sum()), "synced": plan.synced}
    return xs, rec


def _plan_cohort_chunk(state, scenario, k: int):
    """k SingleRSU/MultiRSU rounds: (xs list, records, rng, generator),
    both streams advanced as k eager rounds advance them."""
    rng = unpack_host_rng(state.host_rng)
    gen = generator_from(state.gen_state)
    rounds = [_cohort_round(_cohort_plan(rng, gen, state.round + i,
                                         scenario),
                            scenario, state.round + i) for i in range(k)]
    return [x for x, _ in rounds], [r for _, r in rounds], rng, gen


def _plan_handover_chunk(state, scenario, k: int):
    """k handover rounds through `draw_round` / `plan_round` (the code the
    eager round runs): (xs list, records, rng, generator, the advanced
    positions and accumulators)."""
    topo = scenario.topology
    rng = unpack_host_rng(state.host_rng)
    gen = generator_from(state.gen_state)
    host = {k_: state.topo[k_]
            for k_ in ("positions", "blur_sum", "upload_count")}
    xs_list, recs = [], []
    for i in range(k):
        draws = topo.draw_round(rng, gen, host["positions"], scenario)
        plan = topo.plan_round(draws, state.round + i, host["positions"],
                               host["blur_sum"], host["upload_count"],
                               scenario)
        host = {"positions": plan.positions, "blur_sum": plan.blur_sum,
                "upload_count": plan.upload_count}
        xs, rec = _handover_round(plan, scenario, state.round + i)
        xs_list.append(xs)
        recs.append(rec)
    return xs_list, recs, rng, gen, host


def _plan_chunk(state, scenario, k: int):
    """(xs list, records, rng, generator, topo host state) of the next k
    rounds; the last is {} but for the handover."""
    if isinstance(scenario.topology, HandoverMultiRSU):
        return _plan_handover_chunk(state, scenario, k)
    return (*_plan_cohort_chunk(state, scenario, k), {})


# --------------------------------------------------------------------------
# round bodies
# --------------------------------------------------------------------------

def _client_images(dstack, xs, scenario) -> torch.Tensor:
    """(n, B, H, W, C): the cohort's batches gathered from the device data
    stack, each blurred by its client's velocity."""
    batches = dstack[xs["ids"][:, None], xs["idx"]]
    if not scenario.blur_images:
        return batches
    cc = scenario.mobility.camera_const
    return torch.stack([apply_motion_blur(b, v, cc)
                        for b, v in zip(batches, xs["velocities"])])


def _train(scenario, spec, tree, images, xs, tree_batched=False):
    cohort = CohortBatch.empty(spec, images.shape[0], device=images.device)
    train_chunks(scenario.cfg, tree, images, xs["draws"], xs["lr"], cohort,
                 tree_batched)
    return cohort


def _build_sharded_body(scenario, mesh):
    """Round body for MultiRSU over a mesh of more than one rank: carry as
    `_build_cohort_body`'s. `MultiRSU.sharded_step` on this rank's block
    of the RSU-major cohort ``perm``, from the planned xs; the losses
    come back in cohort order."""
    cfg, topo = scenario.cfg, scenario.topology
    stateful = CODECS[cfg.codec].stateful
    n = cfg.vehicles_per_round
    # analysis: allow=retrace-fresh-array -- built once a campaign key; the
    # round is the nested body
    perm = torch.from_numpy(np.concatenate(topo.rsu_groups(n))).to(
        scenario.device)
    blk = perm[CohortBatch.sharding_spec(mesh, n)]
    inv = torch.argsort(perm)

    def body(spec, dstack, carry, xs):
        sub = {k: xs[k][blk] for k in ("ids", "idx", "velocities")}
        draws = [tuple({k: v[blk] for k, v in d.items()} for d in pair)
                 for pair in xs["draws"]]
        row, comms, losses = topo.sharded_step(
            cfg, unravel(carry[0], spec),
            _client_images(dstack, sub, scenario), draws, xs["lr"],
            xs["velocities"], xs["blur"],
            {"ef": carry[1]} if stateful else None, perm, mesh)
        return ((row, comms["ef"]) if stateful else (row,)), losses[inv]

    return body


def _build_cohort_body(scenario):
    """Round body for SingleRSU and MultiRSU: carry = (global row,) and
    the error feedback after it under a stateful codec. The cohort trains
    in order, in chunks of CLIENTS_PER_CHUNK from the shared tree; the
    codec runs over the whole cohort (error-feedback slot i = cohort
    position i, as the eager round's rows); SingleRSU aggregates with its
    scheme's weights, MultiRSU through the round-robin groups (over a
    mesh of more than one rank: `_build_sharded_body`)."""
    cfg, topo = scenario.cfg, scenario.topology
    mesh = _campaign_mesh(scenario)
    if mesh is not None:
        return _build_sharded_body(scenario, mesh)
    stateful = CODECS[cfg.codec].stateful
    weights = agg.SCHEME_WEIGHTS[cfg.aggregator]
    groups = None
    if type(topo) is MultiRSU:
        # analysis: allow=retrace-fresh-array -- built once a campaign key;
        # the round is the nested body
        groups = [torch.from_numpy(s).to(scenario.device)
                  for s in topo.rsu_groups(cfg.vehicles_per_round)]

    def body(spec, dstack, carry, xs):
        tree = unravel(carry[0], spec)
        cohort = _train(scenario, spec, tree,
                        _client_images(dstack, xs, scenario), xs)
        cohort = cohort.with_stats(velocities=xs["velocities"],
                                   blur=xs["blur"])
        comms = {"ef": carry[1]} if stateful else None
        cohort, comms = roundtrip_cohort(cfg, cohort, tree, comms)
        if groups is None:
            row = agg.cohort_weighted_row(cohort, weights(cohort, cfg))
        else:
            row = hierarchical_row([cohort.take(g) for g in groups],
                                   count_scaled=topo.count_scaled)
        return ((row, comms["ef"]) if stateful else (row,)), cohort.losses

    return body


def _build_handover_body(scenario):
    """Round body for HandoverMultiRSU: carry = (global row, RSU rows (R,
    P)) and the error feedback after them under a stateful codec. Each
    client trains from its download RSU's row (``down``), the tree
    batched over the cohort; the codec's base is that row; each RSU's
    upload is a `wagg` over the whole cohort with the zero-padded weights
    of ``wmat`` (an RSU without uploads keeps its row), then one more
    `wagg` merges the RSUs with ``sync_w``, taken only when ``sync`` is
    set."""
    cfg = scenario.cfg
    stateful = CODECS[cfg.codec].stateful

    def body(spec, dstack, carry, xs):
        grow, rstack = carry[0], carry[1]
        images = _client_images(dstack, xs, scenario)
        init = unravel(rstack[xs["down"]], spec)
        cohort = _train(scenario, spec, init, images, xs, tree_batched=True)
        comms = {"ef": carry[2]} if stateful else None
        cohort, comms = roundtrip_cohort(cfg, cohort, init, comms,
                                         stacked_base=True)
        ups = torch.stack([ops.wagg_flat(cohort.flat, w)
                           for w in xs["wmat"]])
        rstack = torch.where(xs["has_up"][:, None], ups, rstack)
        merged = ops.wagg_flat(rstack, xs["sync_w"])
        rstack = torch.where(xs["sync"], merged, rstack)
        grow = torch.where(xs["sync"], merged, grow)
        carry = (grow, rstack) + ((comms["ef"],) if stateful else ())
        return carry, cohort.losses

    return body


# --------------------------------------------------------------------------
# the captured round
# --------------------------------------------------------------------------

class _GraphRound:
    """The round body captured in one CUDA graph, with the static buffers
    it reads: the data stack, the carry (which the captured body
    overwrites with the next carry) and the xs; and the round's losses,
    which it writes.

    Built from a campaign's first round: that round runs eagerly on a
    side stream through the same buffers (the warm-up), then the body is
    captured into a private pool. `losses0` holds the warm-up round's
    losses."""

    def __init__(self, body, spec, dstack, carry, xs, shapes):
        self.shapes = shapes
        self.dstack = dstack
        self.carry = [c.clone() for c in carry]
        self.xs = [x.clone() for x in pytree.tree_leaves(xs)]
        static_xs = pytree.tree_unflatten(self.xs, pytree.tree_structure(xs))

        def step():
            new_carry, losses = body(spec, self.dstack, self.carry,
                                     static_xs)
            for c, n in zip(self.carry, new_carry):
                c.copy_(n)
            return losses

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.losses0 = step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        before = ops.launch_counts()
        reserved = torch.cuda.memory_reserved()
        t = time.perf_counter()
        # analysis: allow=retrace-ctor -- one capture a campaign key
        # (compile_counts, analysis.guards.ENGINE_COMPILE_BOUNDS)
        self.graph = torch.cuda.CUDAGraph()
        # analysis: allow=retrace-ctor -- the same capture
        with torch.cuda.graph(self.graph):
            self.losses = step()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        ops.add_launches({k: -v for k, v in self.launches.items()})
        record_compile("graph_captures")

    def load(self, carry) -> None:
        for c, x in zip(self.carry, carry):
            c.copy_(x)

    def replay(self, xs) -> torch.Tensor:
        """One round: `xs` into the static buffers, the graph replayed.
        Returns a copy of the round's losses."""
        for s, x in zip(self.xs, pytree.tree_leaves(xs)):
            s.copy_(x)
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.losses.clone()


# --------------------------------------------------------------------------
# callable cache
# --------------------------------------------------------------------------

_CALLABLE_CACHE: dict = {}


def _campaign_key(scenario):
    return (scenario.cfg,
            tuple(sorted(scenario.topology.signature().items())),
            scenario.mobility, scenario.blur_images, str(scenario.device))


def campaign_callables(scenario) -> dict:
    """The engine's entry for this scenario, cached on (cfg, topology
    signature, mobility, blur flag, device): the round body (``body``),
    its captured graph or None (``graph``; a graph is also tied to the
    tree's flat layout and the data stack's shape) and the count of
    captures (``captures``). The data stack is an input, so a sweep over
    seeds or data reuses one entry."""
    key = _campaign_key(scenario)
    got = _CALLABLE_CACHE.get(key)
    if got is None:
        build = (_build_handover_body
                 if isinstance(scenario.topology, HandoverMultiRSU)
                 else _build_cohort_body)
        got = {"body": build(scenario), "graph": None, "captures": 0}
        _CALLABLE_CACHE[key] = got
    return got


def compile_counts(scenario) -> dict:
    """{"graph": captures} for this scenario's entry: one per campaign
    key (and layout), whatever the chunking and the topology."""
    got = _CALLABLE_CACHE.get(_campaign_key(scenario))
    return {"graph": 0 if got is None else got["captures"]}


def graph_stats(scenario) -> Optional[dict]:
    """The live graph of this scenario's entry: seconds its capture took
    (``capture_s``, the warm-up round not included) and the bytes its
    private pool reserved (``pool_bytes``); None without one."""
    got = _CALLABLE_CACHE.get(_campaign_key(scenario))
    g = None if got is None else got["graph"]
    return None if g is None else {"capture_s": g.capture_s,
                                   "pool_bytes": g.pool_bytes}


def _free_graphs() -> None:
    for entry in _CALLABLE_CACHE.values():
        entry["graph"] = None
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def reset_engine_caches() -> None:
    """Drop every cached entry and its graph, and return the graph's pool
    to the device."""
    _free_graphs()
    _CALLABLE_CACHE.clear()


# --------------------------------------------------------------------------
# the campaign
# --------------------------------------------------------------------------

def _carry_of(state, scenario) -> tuple:
    dev = scenario.device
    carry = (ravel(state.global_tree).to(dev),)
    if isinstance(scenario.topology, HandoverMultiRSU):
        carry += (torch.stack([ravel(m).to(dev)
                               for m in state.topo["rsu_models"]]),)
    if CODECS[scenario.cfg.codec].stateful:
        carry += (state.comms["ef"].to(dev),)
    return carry


def _state_of(carry, state, scenario, spec, rng, gen, k, topo_host):
    carry = list(carry)
    comms, topo = state.comms, state.topo
    if CODECS[scenario.cfg.codec].stateful:
        comms = {"ef": carry.pop()}
    if isinstance(scenario.topology, HandoverMultiRSU):
        rstack = carry.pop()
        topo = {"positions": topo_host["positions"],
                "rsu_models": tuple(unravel(r, spec) for r in rstack),
                "blur_sum": topo_host["blur_sum"],
                "upload_count": topo_host["upload_count"]}
    return state.replace(global_tree=unravel(carry[0], spec),
                         gen_state=gen.get_state(),
                         host_rng=pack_host_rng(rng), round=state.round + k,
                         topo=topo, comms=comms)


def _transfer_guard(on: bool):
    return no_implicit_transfers() if on else contextlib.nullcontext()


def _graph_rounds(entry, spec, dstack, shapes, carry, xs_list, guard):
    """A chunk in graph mode: (carry after it, each round's losses). The
    warm-up and the capture, when the entry has no graph for these
    shapes, run outside the guard; the replays inside it."""
    ys = []
    g = entry["graph"]
    if g is None or g.shapes != shapes:
        _free_graphs()
        with record_function("engine.capture"):
            g = _GraphRound(entry["body"], spec, dstack, carry, xs_list[0],
                            shapes)
        entry["graph"] = g
        entry["captures"] += 1
        ys.append(g.losses0)
        del g.losses0
        xs_list = xs_list[1:]
    else:
        g.load(carry)
    with _transfer_guard(guard):
        for xs in xs_list:
            with record_function("engine.round"):
                ys.append(g.replay(xs))
    return tuple(c.clone() for c in g.carry), ys


def _run_rounds(entry, mode, spec, dstack, shapes, carry, xs_list,
                guard=False):
    """Rounds `xs_list` from `carry` in `mode`: (carry after them, each
    round's losses on the device)."""
    if mode == "graph":
        return _graph_rounds(entry, spec, dstack, shapes, carry, xs_list,
                             guard)
    ys = []
    with _transfer_guard(guard):
        for xs in xs_list:
            with record_function("engine.round"):
                carry, losses = entry["body"](spec, dstack, carry, xs)
            ys.append(losses)
    return carry, ys


def run_campaign(scenario, state: Optional[FLState] = None,
                 rounds: Optional[int] = None, *, mode: str = "auto",
                 checkpoint_every: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 log_every: int = 0, transfer_guard: bool = False,
                 publish=None, publish_every: int = 0):
    """Run `rounds` rounds (default cfg.rounds) from `state` (default the
    scenario's round-0 state) through the engine. Returns (final state,
    history) like `run`, the schedule bitwise `run`'s (see the module
    docstring for the trees).

    mode              "eager", "graph" (CUDA), "auto" (by the scenario's
                      device), or the reference's "jit" / "scan"
    checkpoint_every  chunk size and checkpoint cadence: after each chunk
                      `save_state` writes ``round_NNNNNN.npz`` (and the
                      fingerprint sidecar) into `checkpoint_dir`, which it
                      needs; resuming from one is bitwise the
                      uninterrupted campaign on the CPU. A sharded
                      campaign's rank 0 writes each checkpoint once and
                      every rank waits for it (`_checkpoint`)
    log_every         print `run`'s "[round N] loss=... lr=..." lines,
                      from the history fetched once a chunk
    transfer_guard    raise on any host-device synchronisation torch makes
                      while the rounds replay (not while they are planned
                      or captured): `analysis.guards.no_implicit_transfers`.
                      CUDA only; for the steady state, run a campaign that
                      captures first
    publish           ``publish(round, tree)`` once a chunk, with the
                      state's round and global tree (a copy the engine
                      does not touch again), e.g. ``ModelStore.publish``
    publish_every     chunk size when only the publish cadence matters;
                      0 publishes once per natural chunk
    """
    check_campaign_supported(scenario)
    mode = resolve_mode(mode, scenario.device,
                        sharded=_campaign_mesh(scenario) is not None)
    if checkpoint_every is not None:
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every needs checkpoint_dir")
    if publish_every < 0:
        raise ValueError("publish_every must be >= 0")
    if transfer_guard and scenario.device.type != "cuda":
        raise ValueError("transfer_guard watches host-device syncs on CUDA; "
                         "this scenario runs on the CPU")
    if state is None:
        state = scenario.init_state()
    total = rounds if rounds is not None else scenario.cfg.rounds
    chunk = (checkpoint_every or publish_every
             or (log_every if log_every > 0 else total))
    chunk = max(1, min(chunk, total)) if total else 1
    entry = campaign_callables(scenario)
    spec = flat_spec(state.global_tree)
    stack = _data_stack(scenario)
    shapes = (spec, tuple(stack.shape))
    g = entry["graph"]
    if mode == "graph" and g is not None and g.shapes == shapes:
        dstack = g.dstack.copy_(stack)
    else:
        dstack = stack.to(scenario.device)
    history, done = [], 0
    while done < total:
        k = min(chunk, total - done)
        with record_function("engine.plan"):
            xs_list, recs, rng, gen, topo_host = _plan_chunk(state, scenario,
                                                             k)
        carry, ys = _run_rounds(entry, mode, spec, dstack, shapes,
                                _carry_of(state, scenario), xs_list,
                                transfer_guard)
        # analysis: sanctioned-sync -- the chunk's one fetch: its losses
        losses_h = torch.stack(ys).cpu().numpy().astype(np.float64)
        for i, rec in enumerate(recs):
            rec["loss"] = float(np.mean(losses_h[i]))
            history.append(rec)
            if log_every and rec["round"] % log_every == 0:
                print(f"[round {rec['round']:4d}] loss={rec['loss']:.4f} "
                      f"lr={rec['lr']:.4f}")
        state = _state_of(carry, state, scenario, spec, rng, gen, k,
                          topo_host)
        if publish is not None:
            publish(state.round, state.global_tree)
        done += k
        if checkpoint_every:
            _checkpoint(os.path.join(checkpoint_dir,
                                     f"round_{state.round:06d}"),
                        state, scenario)
    return state, history


def _checkpoint(path: str, state, scenario) -> None:
    """`save_state` of a chunk's end. The ranks of a sharded campaign
    hold the same state and share `path`: global rank 0 alone writes it,
    then every rank waits at a barrier over the cohort mesh's ranks (the
    default group, which the mesh spans), so no rank goes on, returns or
    restores before the files are whole."""
    from repro_torch.checkpoint.store import save_state
    sharded = _campaign_mesh(scenario) is not None
    if not sharded or dist.get_rank() == 0:
        save_state(path, state, scenario)
    if sharded:
        dist.barrier()
