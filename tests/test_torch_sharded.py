"""Sharded cohorts (launch/mesh.py, core/hierarchical.py's sharded forms,
MultiRSU and HandoverMultiRSU on a cohort mesh) on the CPU.

Three kinds of run.
* In process: the mesh policy and its actionable errors, the one-rank
  group's backends, and the 1 x 1 mesh forms over a one-rank gloo group
  against the port's host forms (bitwise) and the reference's host
  `AGGREGATORS` and `aggregate_hierarchical` (REF_TOL).
* Spawned gloo ranks, one spawn a world size (2 and 4), every multi-rank
  case inside it (`_rank_main`): each rank writes its results to an npz
  under tmp_path and the parent compares them, with each other (every
  rank's results and final states bitwise equal) and with the port's host
  forms (bitwise for "gather", "split" and "exact", and for a mesh round
  with parallel=False; ROUND tolerances for the rounds whose clients
  train in blocks; two delta_int8 rounds against mesh_aggregate=False,
  error feedback slot by slot) and the reference's (REF_TOL).
* One subprocess running the reference at 4 forced XLA devices:
  `sharded_hierarchical(reduction="psum")`, in float32 and with float64
  accumulation, on the blocks the port's 4 ranks hold (PSUM_TOL), and
  its sharded MultiRSU(n_rsus=2, mesh_aggregate=True) round 0, which the
  ranks replay from the reference's state and draws (ROUND tolerances).

Rounds run on an eighth-width ResNet-18 (`torch_sharded_ranks`), 4
vehicles a round on 2 RSUs: at tests/test_torch_engine.py's parity size
(16 x 16 images, batch 8) where held within tolerances or compared
with the reference, at its ENGINE_TINY images where bitwise. Measured
(world sizes 2 and 4): the sharded parallel round against the host
round 3.1e-7 and 6.6e-7 max abs, the handover 6.0e-7 and 1.1e-6, losses
within 2.4e-7; against the reference's sharded round 4.5e-4 max abs
(0.055% of the update), loss 1.0e-6; delta_int8 bitwise the host rounds
at 2 ranks, at 4 the rows 3.2e-4 and the error feedback 1.2e-3 max abs
(a flipped code) with 0.07% of a slot's elements beyond 1e-6; psum
against the host hierarchy 0 and 3.0e-8; every form against the
reference's host forms 6.0e-8; the float64 psum 0 from the exact sum,
float32's 3.8e-4. About 60 s in one process.
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import aggregation as jagg
from repro.core import hierarchical as jhier
from repro.core.cohort import CohortBatch as JCohortBatch
from repro.core.scenario import Scenario as JScenario
from repro.core.state import FLConfig as JFLConfig
from repro.launch import mesh as jmesh
from repro_torch.core import aggregation as tagg
from repro_torch.core import engine
from repro_torch.core import hierarchical as thier
from repro_torch.core.cohort import CohortBatch
from repro_torch.core.scenario import run, run_campaign
from repro_torch.core.state import FLConfig
from repro_torch.core.topology import MultiRSU
from repro_torch.launch import mesh as tmesh
from test_torch_round import (LOSS_TOL, TREE_MAX_ABS, TREE_REL_UPDATE,
                              port_state, replayed_plan,
                              torch_threads)  # noqa: F401 (autouse)
from torch_sharded_ranks import (DISCARD_BLUR, PARITY, REF_START, TINY,
                                 WORLDS, _cancel_cohort, _cancel_expect,
                                 _cohort, _handover_sched, _hier_cohort,
                                 _losses, _narrow_tree, _row, _scenario,
                                 _state_rows, spawn_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's host forms and the reference's sum the rows in another order
# (the plain wagg's ascending rows against XLA's tensordot), as in
# tests/test_torch_topology.py: within 1e-6 on values near 1.
REF_TOL = 1e-6
# psum reassociates each row sum of at most 8 float32 terms near 1 (the
# local block sum, then the all-reduce's own order): a few float32 ULPs
# of 1, so 1e-6 against the host forms and the reference's psum alike.
PSUM_TOL = 1e-6
# float64 accumulation: within the float32 rounding of the exact sum (the
# reference's tests/multidevice/test_sharded_comms.py bound).
F64_TOL = 2e-6
# delta_int8 rounds whose clients train in other blocks than the host's:
# an error-feedback element is the same up to the trained rows' float
# noise (EF_ATOL; measured 1.7e-6 after round 1) unless its int8 code
# flipped by one step, which happens only where a row element lies within
# that noise of a rounding boundary: at most EF_FLIP_SHARE of a slot's
# elements (measured 0.07% at 4 ranks; another client's slot differs in
# 98.6%), each within one code step.
EF_ATOL = 1e-5
EF_FLIP_SHARE = 1e-2
_SPAWNED: dict = {}


def _jnarrow() -> dict:
    """The ranks' eighth-width model as the reference's tree."""
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), _narrow_tree())


def _save_reference_start(out_dir: str) -> None:
    """The reference's round-0 state and its next round's plan, its jax
    draws replayed (test_torch_round.replayed_plan), for the ranks to run
    through their mesh."""
    jsc = JScenario(topology="multi", topology_kwargs={
        "n_rsus": 2, "mesh_aggregate": False}, global_tree=_jnarrow(),
        **PARITY)
    tsc = _scenario(tkw={"mesh_aggregate": False})
    jstate = jsc.init_state()
    torch.save({"state": port_state(jstate),
                "plan": replayed_plan(jstate, jsc, tsc)},
               os.path.join(out_dir, REF_START))


def _spawned(world: int, tmp_path_factory) -> list:
    """One spawn of `world` ranks per test run, whichever test asks first."""
    if world not in _SPAWNED:
        out_dir = tmp_path_factory.mktemp(f"ranks{world}")
        _save_reference_start(str(out_dir))
        _SPAWNED[world] = spawn_ranks(world, str(out_dir))
    return _SPAWNED[world]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    return _spawned(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawned(4, tmp_path_factory)


def _jtree(rows: np.ndarray) -> dict:
    """The reference's stacked tree of (m, P) rows in ravel order."""
    return {"a": jnp.asarray(rows[:, :12].reshape(-1, 4, 3)),
            "b": {"c": jnp.asarray(rows[:, 12:])}}


def _jcohort(c: CohortBatch) -> JCohortBatch:
    rows = c.flat.numpy()
    return JCohortBatch.from_stacked(
        _jtree(rows), jnp.zeros((c.size,)), n=c.n,
        blur=jnp.asarray(c.blur.numpy()))


def _jrow(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree["a"]).reshape(-1),
                           np.asarray(tree["b"]["c"]).reshape(-1)])


# --------------------------------------------------------------------------
# host forms (the oracles), computed here
# --------------------------------------------------------------------------

def _host_aggregate(c: CohortBatch, cfg) -> np.ndarray:
    return _row(tagg.AGGREGATORS[cfg.aggregator](c, cfg))


def _ref_aggregate(c: CohortBatch, name: str) -> np.ndarray:
    return _jrow(jagg.AGGREGATORS[name](_jcohort(c), JFLConfig(
        aggregator=name)))


def _host_hier(c: CohortBatch, R: int, count_scaled=True) -> np.ndarray:
    s = c.n // R
    return thier.hierarchical_row(
        [c.take(list(range(r * s, (r + 1) * s))) for r in range(R)],
        count_scaled).numpy()


def _ref_hier(c: CohortBatch, R: int, count_scaled=True) -> np.ndarray:
    s = c.n // R
    rows, blur = c.flat.numpy(), c.blur.numpy()
    groups = [JCohortBatch.from_stacked(
        _jtree(rows[r * s:(r + 1) * s]), jnp.zeros((s,)),
        blur=jnp.asarray(blur[r * s:(r + 1) * s])) for r in range(R)]
    return _jrow(jhier.aggregate_hierarchical(groups,
                                              count_scaled=count_scaled))


@functools.lru_cache(maxsize=None)
def _host_runs() -> dict:
    """The port's host rounds (mesh_aggregate=False) from the ranks'
    round-0 states."""
    out = {}
    sc = _scenario(tkw={"mesh_aggregate": False})
    st, hist = run(sc, rounds=1)
    out["par"] = (_row(st.global_tree), _losses(hist))
    out["start"] = _row(sc.init_state().global_tree)
    hsc = _scenario("handover")
    st, hist = run(hsc, rounds=2)
    out["handover"] = (_state_rows(st), _losses(hist), _handover_sched(hist))
    return out


def _assert_round_close(got: np.ndarray, want: np.ndarray,
                        start: np.ndarray) -> None:
    """A round whose clients train in other blocks than the host's: the
    tolerances of tests/test_torch_round.py."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= TREE_MAX_ABS
    assert (np.linalg.norm(got - want)
            <= TREE_REL_UPDATE * np.linalg.norm(want - start))


# --------------------------------------------------------------------------
# in process: the policy, the errors, the 1 x 1 mesh
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank():
    """A one-rank gloo group for the test (created by `cohort_mesh`),
    destroyed after it."""
    yield
    thier.reset_sharded_caches()
    if dist.is_initialized():
        dist.destroy_process_group()


def test_cohort_axis_divisor_policy():
    for rows, pods, have in ((4, 2, 8), (6, 2, 8), (5, 2, 8), (8, 2, 8),
                             (7, 1, 8), (4, 16, 8), (2, 2, 4), (4, 1, 2)):
        assert tmesh.cohort_axis_divisor(rows, pods, device_count=have) \
            == jmesh.cohort_axis_divisor(rows, pods, device_count=have)
    assert tmesh.cohort_axis_divisor(6, 2, device_count=8) == 3
    assert tmesh.cohort_axis_divisor(5, 2, device_count=8) == 1


def test_cohort_mesh_actionable_errors():
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.cohort_mesh(0, 4, "cpu")
    with pytest.raises(ValueError) as ei:
        tmesh.cohort_mesh(2, 1, "cpu")
    msg = str(ei.value)
    assert "needs 2 ranks" in msg and "have 1" in msg
    assert "torchrun --nproc-per-node" in msg and "mesh_aggregate=False" in msg
    # MultiRSU(mesh_aggregate=True) raises it before any training
    with pytest.raises(ValueError, match="needs 2 ranks"):
        _scenario(tkw={"mesh_aggregate": True})
    assert not dist.is_initialized()


def test_multi_rsu_uneven_cohort_error_is_actionable():
    cfg = FLConfig(vehicles_per_round=5)
    with pytest.raises(ValueError) as ei:
        MultiRSU(n_rsus=2, mesh_aggregate=True).resolve_mesh(cfg, "cpu")
    msg = str(ei.value)
    assert "mesh_aggregate" in msg and "not divisible" in msg
    assert "auto-fall-back" in msg
    assert MultiRSU(n_rsus=2).resolve_mesh(cfg, "cpu") is None


def test_maybe_cohort_mesh_none_under_two_ranks(one_rank):
    assert tmesh.maybe_cohort_mesh(1, 4, "cpu") is None
    assert tmesh.maybe_cohort_mesh(2, 4, "cpu") is None
    assert MultiRSU(n_rsus=2).resolve_mesh(FLConfig(vehicles_per_round=4),
                                           "cpu") is None
    tmesh.cohort_mesh(1, 1, "cpu")                   # a group of one rank
    assert tmesh.world_size() == 1
    assert tmesh.maybe_cohort_mesh(1, 4, "cpu") is None


def test_one_rank_group_serves_both_device_types(one_rank):
    """The group `cohort_mesh` makes where none exists has gloo for CPU
    tensors and, where the build has NCCL, NCCL for CUDA tensors: a CPU
    scenario built first does not lock a later CUDA one out."""
    tmesh.cohort_mesh(1, 1, "cpu")
    backend = str(dist.get_backend())
    assert "gloo" in backend
    if dist.is_nccl_available():
        assert "nccl" in backend
        tmesh._ensure_group(torch.device("cuda"))
    else:
        with pytest.raises(ValueError, match="init_process_group\\('nccl'\\)"):
            tmesh._ensure_group(torch.device("cuda"))


def test_graph_mode_refuses_a_multi_rank_mesh():
    with pytest.raises(NotImplementedError, match="multi-rank mesh"):
        engine.resolve_mode("graph", "cuda", sharded=True)
    assert engine.resolve_mode("auto", "cuda", sharded=True) == "eager"
    assert engine.resolve_mode("auto", "cuda") == "graph"


def test_one_rank_mesh_forms_match_host_and_reference(one_rank):
    mesh = tmesh.cohort_mesh(1, 1, "cpu")
    assert mesh is tmesh.cohort_mesh(1, 1, "cpu")
    assert tmesh.batch_axes(mesh) == ("pod", "data")
    c = _cohort(0, 5, 8, blur=DISCARD_BLUR)
    for name in sorted(tagg.AGGREGATORS):
        cfg = FLConfig(aggregator=name)
        want = _host_aggregate(c, cfg)
        ref = _ref_aggregate(c, name)
        for red in ("gather", "split"):
            got = _row(thier.sharded_aggregate(c, cfg, mesh, reduction=red))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, ref, rtol=0, atol=REF_TOL)
    with pytest.raises(ValueError, match="reduction"):
        thier.sharded_cohort_sum(c, torch.ones(5) / 5, mesh,
                                 reduction="magic")
    h = _cohort(10, 4, 4)
    for cs in (True, False):
        got = _row(thier.sharded_hierarchical(h, mesh, 1, count_scaled=cs))
        np.testing.assert_array_equal(got, _host_hier(h, 1, cs))
        np.testing.assert_allclose(got, _ref_hier(h, 1, cs), rtol=0,
                                   atol=REF_TOL)
    got = _row(thier.sharded_hierarchical(h, mesh, 1, reduction="psum"))
    np.testing.assert_allclose(got, _host_hier(h, 1), rtol=0, atol=PSUM_TOL)
    with pytest.raises(ValueError, match="divisible"):
        thier.sharded_hierarchical(h, mesh, 3)
    with pytest.raises(ValueError, match="one RSU a pod"):
        thier.sharded_hierarchical(h, mesh, 2)
    with pytest.raises(ValueError, match="reduction"):
        thier.sharded_hierarchical(h, mesh, 1, reduction="magic")


def test_one_rank_mesh_round_is_bitwise_the_host_round(one_rank):
    """MultiRSU(mesh_aggregate=True) on one rank: the groups train on the
    host path and merge over the 1 x 1 mesh, bitwise the host merge; the
    campaign engine keeps its host body there."""
    on = _scenario(size=TINY, tkw={"n_rsus": 1, "mesh_aggregate": True})
    off = _scenario(size=TINY, tkw={"n_rsus": 1, "mesh_aggregate": False})
    assert tmesh.axis_size(on.topology.resolve_mesh(on.cfg, "cpu")) == 1
    st_on, h_on = run(on, rounds=1)
    st_off, h_off = run(off, rounds=1)
    np.testing.assert_array_equal(_row(st_on.global_tree),
                                  _row(st_off.global_tree))
    assert h_on == h_off
    assert engine._campaign_mesh(on) is None
    st_c, h_c = run_campaign(on, rounds=1, mode="eager")
    st_h, h_h = run_campaign(off, rounds=1, mode="eager")
    np.testing.assert_array_equal(_row(st_c.global_tree),
                                  _row(st_h.global_tree))
    assert h_c == h_h


# --------------------------------------------------------------------------
# spawned gloo ranks
# --------------------------------------------------------------------------

def test_every_rank_ends_with_the_same_results(ranks):
    assert [int(r["world"]) for r in ranks] == [len(ranks)] * len(ranks)
    keys = {k for k in ranks[0] if k != "seconds"
            and not k.startswith("rank/")}
    for other in ranks[1:]:
        assert {k for k in other if k != "seconds"
                and not k.startswith("rank/")} == keys
        for k in keys:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


def test_sharded_gather_and_split_all_schemes(ranks):
    c = _cohort(0, 5, 8, blur=DISCARD_BLUR)
    for name in sorted(tagg.AGGREGATORS):
        want = _host_aggregate(c, FLConfig(aggregator=name))
        ref = _ref_aggregate(c, name)
        for red in ("gather", "split"):
            got = ranks[0][f"agg/{name}/{red}"]
            np.testing.assert_array_equal(got, want, err_msg=(name, red))
            np.testing.assert_allclose(got, ref, rtol=0, atol=REF_TOL)


def test_cohort_smaller_than_mesh_and_all_invalid_shard(ranks):
    small = _cohort(2, 2, 3)
    for red in ("gather", "split"):
        np.testing.assert_array_equal(ranks[0][f"small/{red}"],
                                      _host_aggregate(small, FLConfig()))
    invalid = _cohort(3, 2, 8)
    np.testing.assert_array_equal(
        ranks[0]["invalid_shard"],
        _host_aggregate(invalid, FLConfig(aggregator="fedavg")))
    np.testing.assert_allclose(ranks[0]["invalid_shard"],
                               _ref_aggregate(invalid, "fedavg"), rtol=0,
                               atol=REF_TOL)


def test_shard_gather_and_explicit_weights(ranks):
    c4 = _cohort(4, 4, 8)
    want = tagg.cohort_weighted_row(c4, torch.tensor([0.4, 0.3, 0.2, 0.1]))
    world = len(ranks)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["explicit"], want.numpy())
        np.testing.assert_array_equal(r["sharded_input"], want.numpy())
        np.testing.assert_array_equal(r["shard_gather"], c4.flat.numpy())
        b = 8 // world
        assert r["rank/shard_rows"].tolist() == [rank * b, b, 8]


@pytest.mark.parametrize("count_scaled", [True, False])
def test_sharded_hierarchical_exact(ranks, count_scaled):
    h = _hier_cohort()
    got = ranks[0][f"exact/{count_scaled}"]
    np.testing.assert_array_equal(got, _host_hier(h, 2, count_scaled))
    np.testing.assert_allclose(got, _ref_hier(h, 2, count_scaled), rtol=0,
                               atol=REF_TOL)


def test_sharded_hierarchical_psum_and_float64_accumulation(ranks):
    r = ranks[0]
    np.testing.assert_allclose(r["psum"], _host_hier(_hier_cohort(), 2),
                               rtol=0, atol=PSUM_TOL)
    expect = _cancel_expect()
    assert r["cancel/f64"].dtype == np.float32
    np.testing.assert_allclose(r["cancel/f64"], expect, rtol=1e-6,
                               atol=F64_TOL)
    err32 = np.abs(r["cancel/f32"].astype(np.float64) - expect).max()
    err64 = np.abs(r["cancel/f64"].astype(np.float64) - expect).max()
    assert err64 <= err32
    # the scalar form (one row a rank) is the blocked form of b = 1
    np.testing.assert_array_equal(r["scalar"], r["scalar_ref"])
    c = _cancel_cohort()
    b = 8 // len(ranks)
    L = c.blur.numpy()[::b]
    w = (L.sum() - L) / L.sum()
    np.testing.assert_allclose(r["normalized_w"], w / w.sum(), rtol=1e-6)


# The reference at 4 forced XLA devices: its psum on the rows the port's
# 4 ranks hold, (pod=2, data=2) for 2 RSUs of 4 and (1, 4) for the
# float64 case, and its fully sharded MultiRSU(n_rsus=2,
# mesh_aggregate=True) round 0 at (2, 2) from the ranks' model.
_REFERENCE4 = """
import sys, numpy as np, jax, jax.numpy as jnp
from repro.core.hierarchical import sharded_hierarchical
from repro.core.scenario import Scenario, run_round
from repro.launch.mesh import cohort_mesh
from repro_torch import convert
from torch_sharded_ranks import PARITY, _narrow_tree
d = np.load(sys.argv[1])
assert jax.device_count() == 4, jax.device_count()
t = {'a': jnp.asarray(d['h_rows'][:, :12].reshape(-1, 4, 3)),
     'b': {'c': jnp.asarray(d['h_rows'][:, 12:])}}
g = sharded_hierarchical(t, jnp.asarray(d['h_blur']), cohort_mesh(2, 2), 2,
                         reduction='psum')
psum = np.concatenate([np.asarray(g['a']).reshape(-1),
                       np.asarray(g['b']['c'])])
sc = Scenario(topology='multi', topology_kwargs={
    'n_rsus': 2, 'mesh_aggregate': True}, global_tree=jax.tree.map(
    lambda x: jnp.asarray(x.numpy()), _narrow_tree()), **PARITY)
assert sc.topology.resolve_mesh(sc.cfg).devices.shape == (2, 2)
st, rec = run_round(sc.init_state(), sc)
row = convert.ravel(convert.tree_from_numpy(
    jax.tree.map(np.asarray, st.global_tree))).numpy()
w = {'w': jnp.asarray(d['c_rows'])}
c32 = sharded_hierarchical(w, jnp.asarray(d['c_blur']), cohort_mesh(1, 4), 1,
                           reduction='psum')
jax.config.update('jax_enable_x64', True)
c64 = sharded_hierarchical(w, jnp.asarray(d['c_blur']), cohort_mesh(1, 4), 1,
                           reduction='psum', accum_dtype=jnp.float64)
np.savez(sys.argv[2], psum=psum, c32=np.asarray(c32['w']),
         c64=np.asarray(c64['w']), round_global=row,
         round_loss=np.array(rec['loss']),
         round_velocities=np.array(rec['velocities']))
"""


@pytest.fixture(scope="module")
def reference4(tmp_path_factory) -> dict:
    """`_REFERENCE4`'s results, run once a module in a subprocess."""
    tmp = tmp_path_factory.mktemp("reference4")
    h, cancel = _hier_cohort(), _cancel_cohort()
    np.savez(tmp / "in.npz", h_rows=h.flat.numpy(), h_blur=h.blur.numpy(),
             c_rows=cancel.flat.numpy(), c_blur=cancel.blur.numpy())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    subprocess.run([sys.executable, "-c", _REFERENCE4, str(tmp / "in.npz"),
                    str(tmp / "out.npz")], check=True, env=env, cwd=ROOT,
                   timeout=300)
    return dict(np.load(tmp / "out.npz"))


def test_psum_against_the_reference_at_four_devices(ranks4, reference4):
    ref = reference4
    r = ranks4[0]
    np.testing.assert_allclose(r["psum"], ref["psum"], rtol=0, atol=PSUM_TOL)
    assert ref["c64"].dtype == np.float32
    np.testing.assert_allclose(r["cancel/f64"], ref["c64"], rtol=1e-6,
                               atol=F64_TOL)
    expect = _cancel_expect()
    for got in (r["cancel/f32"], ref["c32"]):
        assert np.abs(r["cancel/f64"].astype(np.float64) - expect).max() \
            <= np.abs(got.astype(np.float64) - expect).max()


def test_sharded_round_matches_the_reference_mesh_round(ranks, reference4):
    """The port's sharded MultiRSU round over its (2, world / 2) mesh,
    from the reference's round-0 state with the reference's draws,
    against the reference's own sharded round over 4 forced devices
    (mesh_aggregate=True): both train their clients in blocks, so held
    at the round tolerances of tests/test_torch_round.py."""
    r = ranks[0]
    np.testing.assert_array_equal(r["ref/velocities"],
                                  reference4["round_velocities"])
    _assert_round_close(r["ref/global"], reference4["round_global"],
                        _host_runs()["start"])
    assert abs(float(r["ref/loss"]) - float(reference4["round_loss"])) \
        <= LOSS_TOL


def test_sequential_mesh_round_is_bitwise_the_host_round(ranks):
    """parallel=False: every rank trains the groups on the host path, and
    the "exact" merge over the mesh is bitwise the host merge (both run
    in the rank: torch's CPU kernels may round otherwise at another
    thread count)."""
    r = ranks[0]
    for k in ("global", "loss"):
        np.testing.assert_array_equal(r[f"tiny/None/False/{k}"],
                                      r[f"tiny/False/False/{k}"])


def test_parallel_sharded_round_is_close_to_the_host_round(ranks):
    want, loss = _host_runs()["par"]
    start = _host_runs()["start"]
    r = ranks[0]
    _assert_round_close(r["par/global"], want, start)
    assert np.abs(r["par/loss"] - loss).max() <= LOSS_TOL
    # the psum reduction of the same blocks
    np.testing.assert_allclose(r["tiny_psum/global"],
                               r["tiny/None/True/global"], rtol=0,
                               atol=PSUM_TOL)


def test_sharded_codec_rounds_thread_the_error_feedback(ranks):
    r = ranks[0]
    # lossless delta: bitwise the identity round
    np.testing.assert_array_equal(r["delta/global"],
                                  r["tiny/None/True/global"])
    np.testing.assert_array_equal(r["delta/loss"], r["tiny/None/True/loss"])
    # delta_int8: the block roundtrip is the host roundtrip, bitwise
    np.testing.assert_array_equal(r["codec/sharded_rows"],
                                  r["codec/host_rows"])
    np.testing.assert_array_equal(r["codec/sharded_ef"], r["codec/host_ef"])
    ef1, ef2 = r["int8/ef1"], r["run/ef"]
    assert np.isfinite(ef2).all() and (np.abs(ef1).max(axis=1) > 0).all()
    assert not np.array_equal(ef1, ef2)
    assert np.isfinite(r["run/global"]).all()


def test_sharded_int8_rounds_match_the_host_rounds(ranks):
    """delta_int8 over the mesh against mesh_aggregate=False, both run in
    the rank for 2 rounds from one state. At 2 ranks the mesh is (2, 1):
    each rank trains its RSU's group in one batched step of the host's
    width, so the rows, the error feedback and the losses are bitwise the
    host's. At 4 ranks each client trains in a block of its own: the
    global rows at the round tolerances plus one code step (the largest
    block scale either side encoded with), the error feedback slot by slot
    at EF_ATOL, EF_FLIP_SHARE and one code step."""
    r = ranks[0]
    got = {k: r[f"int8/{k}"] for k in ("global1", "global2", "ef1", "ef2")}
    want = {k: r[f"int8host/{k}"] for k in got}
    if len(ranks) == 2:
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(r["int8/loss"], r["int8host/loss"])
        return
    step = max(r["int8/steps"].max(), r["int8host/steps"].max())
    for k, start in (("global1", _row(_narrow_tree())),
                     ("global2", want["global1"])):
        a, b = got[k], want[k]
        assert np.isfinite(a).all() and np.abs(a - b).max() \
            <= TREE_MAX_ABS + step, k
        assert np.linalg.norm(a - b) \
            <= TREE_REL_UPDATE * np.linalg.norm(b - start), k
    for k in ("ef1", "ef2"):
        assert got[k].shape == want[k].shape
        for slot, (a, b) in enumerate(zip(got[k], want[k])):
            d = np.abs(a - b)
            assert d.max() <= step + EF_ATOL, (k, slot, d.max(), step)
            assert (d > EF_ATOL).mean() <= EF_FLIP_SHARE, \
                (k, slot, (d > EF_ATOL).mean())
    assert np.abs(r["int8/loss"] - r["int8host/loss"]).max() <= LOSS_TOL


def test_handover_mesh_shard_round(ranks):
    """Each download group's clients train in blocks over (1, ranks);
    the plan, the regrouping and the sync are the host round's."""
    want, loss, sched = _host_runs()["handover"]
    start = _host_runs()["start"]
    r = ranks[0]
    np.testing.assert_array_equal(r["handover/sched"], sched)
    assert sched[:, 1].tolist() == [0, 1] and sched[:, 0].sum() > 0
    for k in ("positions", "blur_sum", "upload_count", "host_rng",
              "gen_state"):
        np.testing.assert_array_equal(r[f"handover/{k}"], want[k])
    for k in ("global", "rsu0", "rsu1"):
        _assert_round_close(r[f"handover/{k}"], want[k], start)
    assert np.abs(r["handover/loss"] - loss).max() <= LOSS_TOL


def test_sharded_campaign_matches_the_sharded_run(ranks):
    """`run_campaign(mode="eager")` over the mesh trains the same blocks
    as the eager sharded `run`: the schedule bitwise, the states
    bitwise on the CPU."""
    r = ranks[0]
    assert bool(r["campaign/same_schedule"])
    for k in ("global", "ef", "gen_state", "host_rng"):
        np.testing.assert_array_equal(r[f"campaign/{k}"], r[f"run/{k}"])
    np.testing.assert_array_equal(r["campaign/loss"], r["run/loss"])


def test_sharded_checkpoint_written_once_and_resumed_bitwise(ranks):
    """A sharded campaign with checkpoint_every=2 into one shared
    directory: rank 0 alone calls save_state (and save, which writes the
    npz and LATEST) once a checkpoint, and both checkpoints are whole on
    every rank when run_campaign returns (read back at once). The chunked
    campaign, the round-2 checkpoint restored on every rank and run 2
    more rounds, and two chunks of 2 rounds are each bitwise the straight
    4-round campaign: every leaf of the FLState, the losses and the
    schedule; the restored checkpoints are bitwise the states they
    saved (the reference's tests/multidevice/test_sharded_engine.py
    holds its sharded resume the same way)."""
    calls = [r["rank/ckpt_calls"] for r in ranks]
    np.testing.assert_array_equal(calls[0], [2, 2])
    np.testing.assert_array_equal(np.sum(calls, axis=0), [2, 2])
    for r in ranks:
        assert int(r["ckpt/latest_step"]) == 4
        assert r["ckpt/same_schedule"].all()
        leaves = [k.split("/")[-1] for k in r if k.startswith(
            "ckpt/straight/") and not k.endswith("/loss")]
        assert len(leaves) > 10
        for run_, want in (("chunked", "straight"), ("resumed", "straight"),
                           ("chunks", "straight"),
                           ("restored_end", "chunked"),
                           ("restored_mid", "first_chunk")):
            for k in leaves:
                np.testing.assert_array_equal(
                    r[f"ckpt/{run_}/{k}"], r[f"ckpt/{want}/{k}"],
                    err_msg=f"{run_} vs {want}: {k}")
        loss = r["ckpt/straight/loss"]
        np.testing.assert_array_equal(r["ckpt/chunked/loss"], loss)
        np.testing.assert_array_equal(r["ckpt/chunks/loss"], loss)
        np.testing.assert_array_equal(r["ckpt/resumed/loss"], loss[2:])
