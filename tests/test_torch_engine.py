"""The port's campaign engine (repro_torch.core.engine, `run_campaign`)
on the CPU, in its eager mode (the graph mode needs CUDA: chip_smoke.py
``[engine]`` runs it on the card).

Two sizes.
* ENGINE_TINY, the reference's engine test size (tests/test_engine.py:
  8 vehicles, 3 a round, 4x4x3 images, batch 2), for everything that is
  bitwise: the schedule against the port's eager `run`, the plan under
  any chunking, checkpoint and chunk splits, logging, publishing, and the
  trees against `run(parallel=True)` where the engine trains the same
  chunks (SingleRSU).
* PARITY, tests/test_torch_topology.py's size (6 vehicles, 3 a round,
  16x16 images, batch 8), for trees and losses held within tolerances:
  against the reference's `run_campaign(mode="jit")`, and against the
  port's `run` where the engine trains other chunks (MultiRSU: the cohort
  in order; the handover: the whole cohort, each client's init tree
  gathered from its download RSU). At ENGINE_TINY the deepest
  BatchNorms normalise 2 values a channel, which turns float32 rounding
  into O(1) differences within one round, so no implementation agrees
  with another there: from one tree and the same draws, the reference's
  eager and jitted round-0 losses already differ in the second decimal,
  and so do the port's and the reference's. At PARITY round-0 losses
  agree within 4e-7.
  Trees are compared round by round, each round from one state, as
  tests/test_torch_round.py does: two chained rounds grow the first
  round's rounding to 8% of the update (measured).

Tolerances are tests/test_torch_round.py's (LOSS_TOL, TREE_MAX_ABS,
TREE_REL_UPDATE), with one code step more under delta_int8 for the trees
and the error feedback, as tests/test_torch_comms.py holds them.
Measured: the engine against the reference's jitted campaign, losses
within 1.3e-6, trees within 1.9e-3 max abs and 0.21% of the update, the
error feedback within 4.2e-3; against the port's `run`, MultiRSU trees
within 1.2e-7 and 0.00003% (the chunks differ, the results barely), the
handover's within 1.9e-4 and 0.027% (1.2e-3 and 0.28% under delta_int8,
its error feedback within 2.0e-3).

About 2.5 minutes in one process, most of it the reference's four
compiles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import os

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.core import hierarchical as jhier
from repro.core.scenario import Scenario as JScenario
from repro.core.scenario import run_campaign as j_run_campaign
from repro_torch.analysis.guards import ENGINE_COMPILE_BOUNDS
from repro_torch.checkpoint.store import restore_state
from repro_torch.comms import codecs as tcodecs
from repro_torch.convert import flat_spec, ravel
from repro_torch.core import engine
from repro_torch.core.scenario import Scenario, run, run_campaign
from repro_torch.core.state import pack_host_rng
from repro_torch.core.topology import MultiRSU
from repro_torch.optim.optimizers import sgd
from test_torch_round import (LOSS_TOL, TREE_MAX_ABS, TREE_REL_UPDATE,
                              _ravel_ref, port_state, replayed_plan,
                              torch_threads)  # noqa: F401 (autouse)
from test_torch_topology import _assert_plans_equal, _replayed_handover

# an eager campaign captures nothing: every bounded counter reads 0
NO_CAPTURES = dict.fromkeys(ENGINE_COMPILE_BOUNDS, 0)
_RS = np.random.RandomState(0)
DATA = [_RS.rand(6, 4, 4, 3).astype(np.float32) for _ in range(8)]
ENGINE_TINY = dict(data=DATA, n_vehicles=8, vehicles_per_round=3,
                   batch_size=2, rounds=6, local_iters=1, lr=0.4, seed=11)
_RS = np.random.RandomState(1)
PARITY = dict(data=[_RS.rand(20, 16, 16, 3).astype(np.float32)
                    for _ in range(6)],
              n_vehicles=6, vehicles_per_round=3, batch_size=8, rounds=6,
              local_iters=1, lr=0.4, seed=11)
HANDOVER = {"n_rsus": 2, "rsu_range": 200.0, "round_duration": 50.0,
            "sync_every": 2}
CASES = {
    "single": dict(topology="single"),
    "multi": dict(topology="multi", topology_kwargs={"n_rsus": 2}),
    "handover": dict(topology="handover", topology_kwargs=HANDOVER),
    "single_delta_int8": dict(topology="single", codec="delta_int8"),
    "handover_delta_int8": dict(topology="handover", topology_kwargs=HANDOVER,
                                codec="delta_int8"),
}


def _scenario(case: str, size=None, **over) -> Scenario:
    return Scenario(**{**(size or ENGINE_TINY), **CASES[case], **over},
                    device="cpu")


@pytest.fixture
def q8_steps(monkeypatch):
    """The largest block scale of each delta_int8 encode: under
    delta_int8 the rows of two implementations differ by rounding, so a
    code may flip by one step, and the trees and the error feedback are
    held within one step of that scale beyond TREE_MAX_ABS, as in
    tests/test_torch_comms.py."""
    steps = []
    codec = tcodecs.CODECS["delta_int8"]

    def encode(rows, base, ef=None):
        payload, new_ef = codec.encode(rows, base, ef)
        steps.append(float(payload["scales"].max()))
        return payload, new_ef

    monkeypatch.setitem(tcodecs.CODECS, "delta_int8",
                        dataclasses.replace(codec, encode=encode))
    return steps


def _sans_loss(rec):
    return {k: v for k, v in rec.items() if k != "loss"}


def _assert_states_bitwise(a, b):
    assert a.round == b.round
    for x, y in zip(_rows(a), _rows(b), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(a.gen_state, b.gen_state)
    for k in a.host_rng:
        np.testing.assert_array_equal(a.host_rng[k], b.host_rng[k])
    for k in ("positions", "blur_sum", "upload_count"):
        if k in a.topo:
            np.testing.assert_array_equal(a.topo[k], b.topo[k])
    assert (a.comms is None) == (b.comms is None)
    if a.comms is not None:
        assert torch.equal(a.comms["ef"], b.comms["ef"])


@functools.lru_cache(maxsize=None)
def _run6(case):
    """6 rounds of `run` with log_every=1: (state, history, the lines it
    printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, hist = run(_scenario(case), rounds=6, log_every=1)
    return state, hist, out.getvalue().splitlines()


@functools.lru_cache(maxsize=None)
def _eager6(case):
    return run_campaign(_scenario(case), rounds=6, mode="eager")


# --------------------------------------------------------------------------
# the schedule, bitwise the eager loop's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["single", "multi", "handover"])
def test_schedule_and_records_match_run(case):
    """Every record field but the loss, the host RNG, the generator and
    the handover's positions and accumulators after 6 rounds are bitwise
    the eager loop's."""
    st_e, hist_e, _ = _run6(case)
    st_c, hist_c = _eager6(case)
    assert len(hist_c) == len(hist_e) == 6
    for a, b in zip(hist_e, hist_c):
        assert _sans_loss(a) == _sans_loss(b)
        assert isinstance(b["loss"], float) and np.isfinite(b["loss"])
    assert torch.equal(st_e.gen_state, st_c.gen_state)
    for k in st_e.host_rng:
        np.testing.assert_array_equal(st_e.host_rng[k], st_c.host_rng[k])
    assert st_c.round == st_e.round == 6
    if case == "handover":
        for k in ("positions", "blur_sum", "upload_count"):
            np.testing.assert_array_equal(st_e.topo[k], st_c.topo[k])
        assert any(r["n_handovers"] for r in hist_c)
        assert any(r["synced"] for r in hist_c)


@pytest.mark.parametrize("case", ["single", "multi", "handover"])
@pytest.mark.parametrize("seed", [0, 3])
def test_plan_is_chunking_invariant(case, seed):
    """Planning 6 rounds at once or 2 + 2 + 2 gives the same xs, records
    and random streams: what makes a checkpoint split bitwise."""
    sc = _scenario(case, seed=seed)

    def plan(chunks):
        state, xs_all, recs_all = sc.init_state(), [], []
        for k in chunks:
            xs, recs, rng, gen, topo_host = engine._plan_chunk(state, sc, k)
            xs_all += xs
            recs_all += recs
            state = state.replace(gen_state=gen.get_state(),
                                  host_rng=pack_host_rng(rng),
                                  round=state.round + k,
                                  topo={**state.topo, **topo_host})
        return xs_all, recs_all, state

    xs1, recs1, end1 = plan([6])
    xs2, recs2, end2 = plan([2, 2, 2])
    assert recs1 == recs2
    for a, b in zip(xs1, xs2, strict=True):
        for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b),
                        strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(end1.gen_state, end2.gen_state)
    for k in end1.host_rng:
        np.testing.assert_array_equal(end1.host_rng[k], end2.host_rng[k])
    if case == "handover":
        np.testing.assert_array_equal(end1.topo["positions"],
                                      end2.topo["positions"])


# --------------------------------------------------------------------------
# the trees: against the port's run, and against the reference's engine
# --------------------------------------------------------------------------

def test_single_trees_bitwise_run():
    """SingleRSU: the engine trains the chunks `run(parallel=True)`
    trains, with a 0-d tensor lr, so 6 rounds are bitwise."""
    st_e, hist_e, _ = _run6("single")
    st_c, hist_c = _eager6("single")
    _assert_states_bitwise(st_e, st_c)
    assert [r["loss"] for r in hist_e] == [r["loss"] for r in hist_c]


def _rows(state):
    return [ravel(state.global_tree)] + [ravel(m) for m in
                                         state.topo.get("rsu_models", ())]


def _assert_rows_close(a, b, start, step=0.0):
    """Each row (global tree, every RSU model) within TREE_MAX_ABS (plus
    a code step under delta_int8), and its difference within
    TREE_REL_UPDATE of b's update from `start` (an unchanged row must be
    equal)."""
    for x, y, z in zip(_rows(a), _rows(b), _rows(start), strict=True):
        assert torch.isfinite(x).all()
        assert float((x - y).abs().max()) <= TREE_MAX_ABS + step
        assert float((x - y).norm()) <= TREE_REL_UPDATE * float(
            (y - z).norm())


@pytest.mark.parametrize("case", ["multi", "handover_delta_int8"])
def test_eager_body_within_tolerance_of_run(case, q8_steps):
    """MultiRSU and the handover: the engine trains other chunks than
    the eager round, so each of 2 rounds (a handover and the sync among
    them) from the eager loop's state is held within tolerance."""
    sc = _scenario(case, PARITY)
    state = sc.init_state()
    for _ in range(2):
        del q8_steps[:]
        st_e, (rec_e,) = run(sc, state, rounds=1)
        st_c, (rec_c,) = run_campaign(sc, state, rounds=1, mode="eager")
        step = max(q8_steps, default=0.0)
        assert _sans_loss(rec_e) == _sans_loss(rec_c)
        assert abs(rec_e["loss"] - rec_c["loss"]) <= LOSS_TOL
        _assert_rows_close(st_c, st_e, state, step)
        if st_e.comms is not None:
            assert float((st_c.comms["ef"] - st_e.comms["ef"]).abs()
                         .max()) <= TREE_MAX_ABS + step
        state = st_e


@functools.lru_cache(maxsize=None)
def _reference_rounds(case):
    """The reference's jitted campaign one round at a time from its
    round-0 state: [(state before, state after, record)] for 2 rounds."""
    jsc = JScenario(**{**PARITY, **CASES[case]})
    out, jstate = [], jsc.init_state()
    try:
        for _ in range(2):
            jnext, (jrec,) = j_run_campaign(jsc, jstate, rounds=1,
                                            mode="jit")
            out.append((jstate, jnext, jrec))
            jstate = jnext
    finally:
        # the reference's `hierarchical._count_scale` memoizes the array
        # it builds; built while the jitted MultiRSU body traces, that is
        # a tracer, which a later eager reference round in this process
        # would read (UnexpectedTracerError in
        # test_torch_fedco.py::test_fedco_multi_rsu_round_matches_reference)
        jhier._count_scale.cache_clear()
    return jsc, out


def _replayed_round(jsc, tsc, jstate):
    """(xs, record) of the port's plan of the reference's next round,
    with its draws replayed; the plan's host half checked bitwise."""
    if tsc.topology.name == "handover":
        like = (jstate.host_rng, jstate.key, jstate.round, jstate.topo)
        jplan, plan, _ = _replayed_handover(jsc.topology, tsc.topology, like,
                                            jsc, tsc)
        _assert_plans_equal(plan, jplan)
        return engine._handover_round(plan, tsc, jstate.round)
    return engine._cohort_round(replayed_plan(jstate, jsc, tsc), tsc,
                                jstate.round)


@pytest.mark.parametrize("case", ["single", "multi", "handover",
                                  "single_delta_int8"])
def test_engine_matches_reference_campaign(case, q8_steps):
    """The eager body against the reference's `run_campaign(mode="jit")`,
    each of 2 rounds from the reference's state with its draws replayed:
    records, losses, the global tree, every RSU model and the error
    feedback."""
    jsc, rounds = _reference_rounds(case)
    tsc = _scenario(case, PARITY)
    entry = engine.campaign_callables(tsc)
    stack = engine._data_stack(tsc)
    for jstate, jnext, jrec in rounds:
        del q8_steps[:]
        xs, rec = _replayed_round(jsc, tsc, jstate)
        state = port_state(jstate)
        spec = flat_spec(state.global_tree)
        carry, (losses,) = engine._run_rounds(
            entry, "eager", spec, stack, None,
            engine._carry_of(state, tsc), [xs])
        step = max(q8_steps, default=0.0)
        assert _sans_loss(rec) == _sans_loss(jrec)
        assert abs(float(np.mean(losses.numpy().astype(np.float64)))
                   - jrec["loss"]) <= LOSS_TOL
        want = [jnext.global_tree] + list(jnext.topo.get("rsu_models", ()))
        start = [jstate.global_tree] + list(
            jstate.topo.get("rsu_models", ()))
        got = [carry[0]] + (list(carry[1]) if len(want) > 1 else [])
        for g, w, s in zip(got, want, start, strict=True):
            w, s = _ravel_ref(w), _ravel_ref(s)
            assert np.abs(g.numpy() - w).max() <= TREE_MAX_ABS + step
            assert np.linalg.norm(g.numpy() - w) <= \
                TREE_REL_UPDATE * np.linalg.norm(w - s)
        if jnext.comms is not None:
            ef = np.asarray(jnext.comms["ef"])
            assert np.abs(carry[-1].numpy() - ef).max() <= \
                TREE_MAX_ABS + step


# --------------------------------------------------------------------------
# splits, logging, publishing: bitwise within the mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["handover"])
def test_checkpoint_and_chunk_splits_bitwise(case, tmp_path):
    """checkpoint_every=3 (two chunks of 3, a checkpoint after each), and
    the round-3 checkpoint restored from disk plus 3 rounds, are each
    bitwise the uninterrupted 6 rounds."""
    sc = _scenario(case)
    st6, hist6 = _eager6(case)
    st_ck, hist_ck = run_campaign(sc, rounds=6, mode="eager",
                                  checkpoint_every=3,
                                  checkpoint_dir=str(tmp_path))
    _assert_states_bitwise(st6, st_ck)
    assert hist_ck == hist6
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz")) \
        == ["round_000003.npz", "round_000006.npz"]
    restored = restore_state(os.path.join(tmp_path, "round_000003"), sc)
    assert restored.round == 3
    st_b, hist_b = run_campaign(sc, restored, rounds=3, mode="eager")
    _assert_states_bitwise(st6, st_b)
    assert hist_ck[:3] + hist_b == hist6
    assert engine.compile_counts(sc) == NO_CAPTURES


@functools.lru_cache(maxsize=None)
def _logged():
    """2 single rounds through the engine with log_every=1 and a publish
    hook: (the lines printed, the published (round, tree) pairs, the
    result)."""
    published = []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = run_campaign(_scenario("single"), rounds=2, mode="eager",
                              log_every=1,
                              publish=lambda r, t: published.append((r, t)))
    return out.getvalue().splitlines(), published, result


def test_log_every_prints_run_lines():
    """The engine prints, from its once-a-chunk history, the lines `run`
    prints for the same rounds."""
    lines, _, (_, hist) = _logged()
    assert lines == _run6("single")[2][:2]
    assert lines == [f"[round {r['round']:4d}] loss={r['loss']:.4f} "
                     f"lr={r['lr']:.4f}" for r in hist]


def test_publish_once_per_chunk():
    """log_every=1 makes chunks of one round: one publish a chunk, with
    the state's round and a tree bitwise the state's."""
    _, published, (state, _) = _logged()
    assert [r for r, _ in published] == [1, 2]
    assert torch.equal(ravel(published[-1][1]), ravel(state.global_tree))
    assert not torch.equal(ravel(published[0][1]), ravel(published[1][1]))


# --------------------------------------------------------------------------
# modes, errors, the tensor lr, the cache
# --------------------------------------------------------------------------

def test_modes():
    for dev, auto in (("cpu", "eager"), ("cuda", "graph")):
        assert engine.resolve_mode("auto", dev) == auto
        assert engine.resolve_mode("jit", dev) == "eager"
        assert engine.resolve_mode("eager", dev) == "eager"
    assert engine.resolve_mode("scan", "cuda") == "graph"
    assert engine.resolve_mode("graph", "cuda") == "graph"
    for mode in ("graph", "scan"):
        with pytest.raises(ValueError, match="CPU"):
            engine.resolve_mode(mode, "cpu")
    with pytest.raises(ValueError, match="mode"):
        engine.resolve_mode("compiled", "cpu")


def test_graph_and_transfer_guard_need_cuda():
    sc = _scenario("single")
    with pytest.raises(ValueError, match="CPU"):
        run_campaign(sc, rounds=1, mode="graph")
    with pytest.raises(ValueError, match="CPU"):
        run_campaign(sc, rounds=1, mode="eager", transfer_guard=True)


def test_unsupported_configs_fail_fast(tmp_path):
    with pytest.raises(ValueError, match="sequential"):
        engine.check_campaign_supported(Scenario(
            **ENGINE_TINY, topology="single", client="fedco",
            aggregator="fedavg", queue_len=16, device="cpu"))

    class CustomTopo(MultiRSU):
        pass

    sc = _scenario("single")
    sc.topology = CustomTopo(n_rsus=2)
    with pytest.raises(ValueError, match="built-in"):
        run_campaign(sc, rounds=1)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_campaign(_scenario("single"), rounds=1, checkpoint_every=1)
    with pytest.raises(ValueError, match=">= 1"):
        run_campaign(_scenario("single"), rounds=1, checkpoint_every=0,
                     checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="publish_every"):
        run_campaign(_scenario("single"), rounds=1, publish_every=-1)


def test_tensor_lr_is_bitwise_float_lr():
    """The SGD update with a 0-d float32 tensor lr (what the captured
    round reads) is bitwise the update with the float."""
    rs = np.random.RandomState(5)
    params = {"a": torch.from_numpy(rs.randn(257).astype(np.float32)),
              "b": {"c": torch.from_numpy(rs.randn(3, 7).astype(np.float32))}}
    grads = {"a": torch.from_numpy(rs.randn(257).astype(np.float32)),
             "b": {"c": torch.from_numpy(rs.randn(3, 7).astype(np.float32))}}
    init, update = sgd(0.9, 5e-4)
    lr = float(np.float32(0.37))
    state = update(params, grads, init(params), 0.1)[1]
    p_f, s_f = update(params, grads, state, lr)
    p_t, s_t = update(params, grads, state,
                      torch.tensor(lr, dtype=torch.float32))
    for x, y in zip(pytree.tree_leaves((p_f, s_f.momentum)),
                    pytree.tree_leaves((p_t, s_t.momentum)), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_compile_counts_and_reset():
    """An eager campaign captures nothing; its cache entry (the round
    body) is dropped by reset_engine_caches."""
    sc = _scenario("single")
    run_campaign(sc, rounds=1, mode="eager")
    assert engine.compile_counts(sc) == NO_CAPTURES
    assert engine.graph_stats(sc) is None
    assert engine._campaign_key(sc) in engine._CALLABLE_CACHE
    engine.reset_engine_caches()
    assert not engine._CALLABLE_CACHE
    assert engine.compile_counts(sc) == NO_CAPTURES


def test_data_stack_pads_to_the_longest_vehicle():
    data = [np.full((n, 2, 2, 3), i + 1, np.float32)
            for i, n in enumerate((3, 5, 1))]
    sc = Scenario(data=data, n_vehicles=3, vehicles_per_round=2,
                  batch_size=2, device="cpu")
    stack = engine._data_stack(sc)
    assert tuple(stack.shape) == (3, 5, 2, 2, 3)
    for i, d in enumerate(data):
        assert torch.equal(stack[i, :len(d)], torch.from_numpy(d))
        assert not stack[i, len(d):].any()


def test_replayed_plans_pack_every_field():
    """A replayed reference plan packs into the xs the engine's own
    planner gives (the same keys, dtypes and shapes)."""
    tsc = _scenario("handover", PARITY)
    xs_own, _, _, _, _ = engine._plan_chunk(tsc.init_state(), tsc, 1)
    jsc, rounds = _reference_rounds("handover")
    xs, _ = _replayed_round(jsc, tsc, rounds[0][0])
    def leaves(t):
        return [(tuple(x.shape), x.dtype) for x in pytree.tree_leaves(t)]

    assert pytree.tree_structure(xs) == pytree.tree_structure(xs_own[0])
    assert leaves(xs) == leaves(xs_own[0])
