"""The port's MultiRSU, HandoverMultiRSU and host hierarchy against the
reference's, on the CPU.

The reference (`repro`, JAX) runs `run_round(..., parallel=False)` with
its Pallas `wagg` kernel in interpret mode; the port starts every round
from the reference's state (`test_torch_round.port_state`) with the
reference's jax draws replayed into its plan. What must be bitwise:
positions, RSU indices, cohort ids and batch indices (host MT19937,
drawn in download-group order), the download/upload groups and their
sizes, and MultiRSU(n_rsus=1) against SingleRSU inside the port. Losses
and trees are held as in tests/test_torch_round.py.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import hierarchical as jhier
from repro.core import mobility as jmob
from repro.core.scenario import Scenario as JScenario
from repro.core.scenario import run_round as j_run_round
from repro.core.state import unpack_host_rng
from repro_torch import convert
from repro_torch.comms import codecs as tcodecs
from repro_torch.core import aggregation as tagg
from repro_torch.core import hierarchical as thier
from repro_torch.core import mobility as tmob
from repro_torch.core.cohort import CohortBatch
from repro_torch.core.scenario import Scenario, run_round
from repro_torch.core.state import pack_host_rng
from test_torch_round import (LOSS_TOL, TREE_MAX_ABS, TREE_REL_UPDATE,
                              _assert_trees_close, _ravel_ref, port_state,
                              replay_pi_draws, replayed_plan,
                              torch_threads)  # noqa: F401 (autouse)

KW = dict(n_vehicles=6, vehicles_per_round=3, batch_size=8, rounds=4,
          local_iters=1)
HANDOVER = dict(n_rsus=2, rsu_range=100.0, sync_every=2)
# Eq.-11 upload weights and level-2 sync weights: the port's float32
# flsimco_weights (torch) against the reference's (XLA) on the same
# blur levels, then the same float64 steps; a float32 sum of a few blur
# levels may round differently in the two. Measured: bitwise equal in
# every plan of these tests.
WEIGHT_TOL = 1e-6
# Rounds (LOSS_TOL, TREE_MAX_ABS, TREE_REL_UPDATE of test_torch_round).
# Measured: MultiRSU loss 1.1e-6, tree max abs 2.1e-3, 0.36% of the
# update's norm; handover loss 3.2e-7, RSU models max abs 6.4e-3 and
# 0.44%, global tree 1.9e-4 and 0.004%.


def _data(n=6, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.rand(20, 16, 16, 3).astype(np.float32) for _ in range(n)]


def _scenarios(topology, topology_kwargs, **kw):
    data = _data()
    kw = dict(KW, **kw)
    return (JScenario(topology=topology, topology_kwargs=topology_kwargs,
                      data=data, **kw),
            Scenario(topology=topology, topology_kwargs=topology_kwargs,
                     data=data, device="cpu", **kw))


# --------------------------------------------------------------------------
# MultiRSU and the host hierarchy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_rsus,count_scaled", [(2, True), (2, False),
                                                 (3, True), (3, False)])
def test_multi_rsu_matches_reference_two_rounds(n_rsus, count_scaled):
    """n_rsus + 1 vehicles a round: RSU 0 gets two, so the RSUs' counts
    differ and count_scaled changes the level-2 weights."""
    jsc, tsc = _scenarios("multi", {"n_rsus": n_rsus,
                                    "count_scaled": count_scaled,
                                    "mesh_aggregate": False},
                          vehicles_per_round=n_rsus + 1)
    jstate = jsc.init_state()
    for _ in range(2):
        plan = replayed_plan(jstate, jsc, tsc)
        st, rec = tsc.topology.execute(port_state(jstate), tsc, plan)
        start = jstate.global_tree
        with jagg.wagg_backend("interpret"):
            jstate, jrec = j_run_round(jstate, jsc, parallel=False)
        assert rec["velocities"] == jrec["velocities"]
        assert rec["rsu_sizes"] == jrec["rsu_sizes"]
        assert abs(rec["loss"] - jrec["loss"]) <= LOSS_TOL
        _assert_trees_close(st.global_tree, jstate.global_tree, start)


def test_multi_rsu_of_one_is_bitwise_single_rsu():
    out = []
    for topology, tkw in (("single", None), ("multi", {"n_rsus": 1})):
        sc = Scenario(topology=topology, topology_kwargs=tkw, data=_data(),
                      device="cpu", **KW)
        st, rec = run_round(sc.init_state(), sc)
        out.append((convert.ravel(st.global_tree), rec["loss"]))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


@pytest.mark.parametrize("count_scaled", [True, False])
def test_aggregate_hierarchical_matches_reference(count_scaled):
    rs = np.random.RandomState(3)
    sizes = (3, 1, 2)
    groups = [[{"a": rs.randn(4, 5).astype(np.float32),
                "b": {"c": rs.randn(7).astype(np.float32)}}
               for _ in range(n)] for n in sizes]
    blur = [rs.uniform(9, 25, n).astype(np.float32) for n in sizes]
    want = jhier.aggregate_hierarchical(groups, blur, count_scaled)
    t_groups = [[convert.tree_from_numpy(t) for t in g] for g in groups]
    got = thier.aggregate_hierarchical(t_groups, blur, count_scaled)
    # the two sum the rows in another order (tensordot vs the plain
    # version's ascending order): measured max abs 6.0e-8 on values near 1
    np.testing.assert_allclose(convert.ravel(got).numpy(), _ravel_ref(want),
                               rtol=0, atol=1e-6)
    # a CohortBatch with blur attached is the same group as the list
    cohorts = [thier._as_cohort(g, b) for g, b in zip(t_groups, blur)]
    again = thier.aggregate_hierarchical(cohorts, count_scaled=count_scaled)
    assert torch.equal(convert.ravel(again), convert.ravel(got))


def test_cohort_take_and_concat():
    spec = convert.flat_spec({"w": torch.zeros(3)})
    a = CohortBatch.empty(spec, 4, n=3)
    b = CohortBatch.empty(spec, 2)
    for c, rows in ((a, 3), (b, 2)):
        for i in range(rows):
            c.write(i, {"w": torch.full((3,), float(10 * c.size + i))},
                    float(i))
    a = a.with_stats(velocities=[1.0, 2.0, 3.0], blur=[4.0, 5.0, 6.0])
    b = b.with_stats(velocities=[7.0, 8.0], blur=[9.0, 10.0])
    full = CohortBatch.concat([a, b])
    assert full.n == full.size == 5
    assert full.flat[:, 0].tolist() == [40, 41, 42, 20, 21]
    assert full.blur.tolist() == [4, 5, 6, 9, 10]
    sub = full.take([4, 0, 3])
    assert sub.flat[:, 0].tolist() == [21, 40, 20]
    assert sub.losses.tolist() == [1, 0, 0]
    assert sub.velocities.tolist() == [8, 1, 7]
    assert sub.mask.tolist() == [1, 1, 1] and sub.n == 3


# --------------------------------------------------------------------------
# ring-road positions
# --------------------------------------------------------------------------

def test_positions_bitwise_and_advance_is_not_fused():
    """init_positions from the reference's uniforms and advance_positions
    are bitwise the reference's. The reference's plan advances positions
    with eager jnp ops, so v*dt and the sum round separately: a fused
    multiply-add (one rounding of p + v*dt, what XLA emits under jit)
    would differ in about 15% of the elements here."""
    mj, mt = jmob.MobilityModel(), tmob.MobilityModel()
    n = 20_000
    for seed, road in ((0, 2000.0), (1, 200.0), (2, 3000.0)):
        kp, kv = jax.random.split(jax.random.PRNGKey(seed))
        pj = np.asarray(mj.init_positions(kp, n, road))
        u = torch.from_numpy(np.array(jax.random.uniform(kp, (n,))))
        pt = mt.init_positions(None, n, road, u=u)
        np.testing.assert_array_equal(pt.numpy(), pj)
        assert pt.dtype == torch.float32 and 0 <= pj.min() < pj.max() < road
        v = np.asarray(mj.sample(kv, n))
        for sign in (1.0, -1.0):
            aj = np.asarray(mj.advance_positions(pj, sign * v, 20.0, road))
            at = mt.advance_positions(pt, torch.from_numpy(sign * v), 20.0,
                                      road)
            assert at.dtype == torch.float32
            np.testing.assert_array_equal(at.numpy(), aj)
        fused = np.fmod((pj.astype(np.float64) + v.astype(np.float64)
                         * 20.0).astype(np.float32), np.float32(road))
        assert (fused != aj).mean() > 0.01


# --------------------------------------------------------------------------
# the handover plan
# --------------------------------------------------------------------------

def _replayed_handover(jtopo, ttopo, jstate_like, jsc, tsc):
    """(reference plan, port plan) for the next round from the
    reference's host RNG, jax key and topo statistics; the port's draws
    are its own host draws (checked bitwise) with the reference's
    velocity uniforms and pi1/pi2 keys replayed."""
    host_rng, key, rnd, topo = jstate_like
    positions = np.asarray(topo["positions"])
    jplan = jtopo.plan_round(unpack_host_rng(host_rng), key, rnd, positions,
                             topo["blur_sum"], topo["upload_count"], jsc)
    rng_t = unpack_host_rng(host_rng)
    draws = ttopo.draw_round(rng_t, torch.Generator().manual_seed(0),
                             positions, tsc)
    np.testing.assert_array_equal(draws.ids, jplan["ids"])
    np.testing.assert_array_equal(draws.idx, jplan["idx"])
    _, kv = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(
        kv, (jsc.cfg.n_vehicles,))))
    fleet_v = tsc.mobility.sample(None, jsc.cfg.n_vehicles, u=u)
    np.testing.assert_array_equal(fleet_v.numpy(),
                                  np.asarray(jplan["fleet_v"]))
    pi = [[replay_pi_draws(k, jsc.cfg.batch_size)
           for k in jax.random.split(ck, jsc.cfg.local_iters)]
          for ck in jplan["cks"]]
    draws = dataclasses.replace(draws, fleet_v=fleet_v, draws=pi)
    plan = ttopo.plan_round(draws, rnd, positions, topo["blur_sum"],
                            topo["upload_count"], tsc)
    return jplan, plan, rng_t


def _assert_plans_equal(plan, jplan):
    for f in ("ids", "idx", "down", "up", "stale", "positions", "blur",
              "blur_sum", "upload_count"):
        np.testing.assert_array_equal(getattr(plan, f), np.asarray(jplan[f]),
                                      err_msg=f)
    assert plan.positions.dtype == np.asarray(jplan["positions"]).dtype
    np.testing.assert_array_equal(plan.velocities.numpy(),
                                  np.asarray(jplan["velocities"]))
    assert plan.upload_sizes == jplan["upload_sizes"]
    assert plan.synced == jplan["synced"]
    assert [(r, s.tolist()) for r, s in plan.down_groups] == \
        [(r, s.tolist()) for r, s in jplan["down_groups"]]
    assert len(plan.uploads) == len(jplan["uploads"])
    for (r, s, w), (jr, js, jw) in zip(plan.uploads, jplan["uploads"]):
        assert r == jr and s.tolist() == js.tolist()
        assert w.dtype == np.float64
        np.testing.assert_allclose(w, jw, rtol=0, atol=WEIGHT_TOL)
    if plan.synced:
        np.testing.assert_allclose(plan.sync_W, jplan["sync_W"], rtol=0,
                                   atol=WEIGHT_TOL)
    else:
        assert plan.sync_W is None and jplan["sync_W"] is None


@pytest.mark.parametrize("stale_discount", [0.5, 0.0])
def test_handover_plan_matches_reference_over_rounds(stale_discount):
    """Eight chained plans (no training): the draws' host half, the
    grouping, motion and the accumulators bitwise, the weights within
    WEIGHT_TOL; handovers, syncs and (with stale_discount=0) a skipped
    all-stale upload group all occur."""
    tkw = dict(HANDOVER, stale_discount=stale_discount)
    jsc, tsc = _scenarios("handover", tkw)
    jstate = jsc.init_state()
    like = (jstate.host_rng, jstate.key, 0, jstate.topo)
    seen = {"stale": 0, "synced": 0, "skipped": 0}
    for rnd in range(8):
        jplan, plan, rng_t = _replayed_handover(jsc.topology, tsc.topology,
                                                like, jsc, tsc)
        _assert_plans_equal(plan, jplan)
        seen["stale"] += int(plan.stale.sum())
        seen["synced"] += plan.synced
        seen["skipped"] += sum(plan.upload_sizes[r] > 0 for r in range(2)) \
            - len(plan.uploads)
        topo = {"positions": plan.positions, "blur_sum": plan.blur_sum,
                "upload_count": plan.upload_count}
        like = (pack_host_rng(rng_t), jplan["key"], rnd + 1, topo)
    assert seen["stale"] and seen["synced"] == 4
    assert (seen["skipped"] > 0) == (stale_discount == 0.0)


# --------------------------------------------------------------------------
# handover rounds
# --------------------------------------------------------------------------

def _assert_rsu_models_close(st, jstate, jprev):
    """Every RSU model and the global tree against the reference's; an
    RSU model is held relative to its own update this round (an RSU
    that received nothing and did not sync must be bitwise unchanged)."""
    for t, j, j0 in zip(st.topo["rsu_models"], jstate.topo["rsu_models"],
                        jprev.topo["rsu_models"]):
        _assert_trees_close(t, j, j0)
    _assert_trees_close(st.global_tree, jstate.global_tree,
                        jprev.global_tree)


def _handover_round(jsc, tsc, jstate):
    """One round on both sides from the reference's state; returns (port
    state, port record, reference state, reference record, port plan)."""
    like = (jstate.host_rng, jstate.key, jstate.round, jstate.topo)
    jplan, plan, _ = _replayed_handover(jsc.topology, tsc.topology, like,
                                        jsc, tsc)
    _assert_plans_equal(plan, jplan)
    st, rec = tsc.topology.execute(port_state(jstate), tsc, plan)
    with jagg.wagg_backend("interpret"):
        jnext, jrec = j_run_round(jstate, jsc, parallel=False)
    for k in ("round", "velocities", "rsu_sizes", "n_handovers", "synced"):
        assert rec[k] == jrec[k], k
    assert abs(rec["loss"] - jrec["loss"]) <= LOSS_TOL
    np.testing.assert_array_equal(st.topo["positions"],
                                  jnext.topo["positions"])
    return st, rec, jnext, jrec, plan


def test_handover_matches_reference_three_rounds():
    """n_rsus=2 on a 200 m ring, 3 of 6 vehicles a round, sync every 2
    rounds: the reference's records show handovers in every round and
    the sync in round 1."""
    jsc, tsc = _scenarios("handover", HANDOVER)
    jstate = jsc.init_state()
    handovers, syncs = 0, 0
    for _ in range(3):
        st, rec, jnext, jrec, _ = _handover_round(jsc, tsc, jstate)
        _assert_rsu_models_close(st, jnext, jstate)
        handovers += jrec["n_handovers"]
        syncs += jrec["synced"]
        jstate = jnext
    assert handovers > 0 and syncs == 1


def test_handover_delta_int8_round_matches_reference(monkeypatch):
    """One delta_int8 handover round: each download group's delta base
    is its download RSU's model, the error-feedback slots the cohort
    indices. Held as the delta_int8 SingleRSU round is
    (tests/test_torch_comms.py): one code may flip by one step of its
    block's scale, so max abs differences get the largest scale the
    port's encoder used on top of TREE_MAX_ABS."""
    scales = []
    codec = tcodecs.CODECS["delta_int8"]

    def encode(rows, base, ef=None):
        payload, new_ef = codec.encode(rows, base, ef)
        scales.append(float(payload["scales"].max()))
        return payload, new_ef

    monkeypatch.setitem(tcodecs.CODECS, "delta_int8",
                        dataclasses.replace(codec, encode=encode))
    jsc, tsc = _scenarios("handover", HANDOVER, codec="delta_int8")
    jstate = jsc.init_state()
    st, rec, jnext, jrec, plan = _handover_round(jsc, tsc, jstate)
    assert len(scales) == len(plan.down_groups)
    step = max(scales)
    ef, jef = st.comms["ef"].numpy(), np.asarray(jnext.comms["ef"])
    assert ef.shape == jef.shape and np.isfinite(ef).all()
    assert np.abs(ef - jef).max() <= TREE_MAX_ABS + step
    for t, j, j0 in zip(st.topo["rsu_models"], jnext.topo["rsu_models"],
                        jstate.topo["rsu_models"]):
        a, b = convert.ravel(t).numpy(), _ravel_ref(j)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= TREE_MAX_ABS + step
        assert np.linalg.norm(a - b) <= TREE_REL_UPDATE * \
            np.linalg.norm(b - _ravel_ref(j0))


def _all_stale_state(tsc, rounds=30):
    """A port handover state (from round-0 onward, plans only) whose next
    round has an upload group made only of stale uploads."""
    state = tsc.init_state()
    for _ in range(rounds):
        rng = unpack_host_rng(state.host_rng)
        gen = torch.Generator()
        gen.set_state(state.gen_state)
        positions = state.topo["positions"]
        plan = tsc.topology.plan_round(
            tsc.topology.draw_round(rng, gen, positions, tsc), state.round,
            positions, state.topo["blur_sum"], state.topo["upload_count"],
            tsc)
        for rsu in range(tsc.topology.n_rsus):
            sel = plan.up == rsu
            if sel.any() and plan.stale[sel].all():
                return state, plan, rsu
        state = state.replace(
            gen_state=gen.get_state(), host_rng=pack_host_rng(rng),
            round=state.round + 1,
            topo=dict(state.topo, positions=plan.positions,
                      blur_sum=plan.blur_sum,
                      upload_count=plan.upload_count))
    raise AssertionError("no all-stale upload group in the plans")


def _distinct_models(tree, n: int) -> tuple:
    """n RSU models that differ in value: `tree` shifted by 0.01 * (r + 1)
    in every float leaf."""
    return tuple(convert.tree_map(
        lambda t, r=r: t + 0.01 * (r + 1) if t.is_floating_point() else t,
        tree) for r in range(n))


def test_handover_round_is_pure_and_all_stale_group_keeps_its_model():
    """stale_discount=0: an upload group of stale uploads only has no
    usable weight, so its RSU keeps its model bitwise. The round is pure:
    the same state in gives the same state out, the input untouched."""
    tsc = Scenario(topology="handover",
                   topology_kwargs=dict(HANDOVER, stale_discount=0.0,
                                        sync_every=100),
                   data=_data(), device="cpu", **KW)
    state, plan, rsu = _all_stale_state(tsc)
    assert rsu not in [r for r, _, _ in plan.uploads]
    # every RSU model distinct, so "kept" cannot pass by coincidence
    models = _distinct_models(state.global_tree, tsc.topology.n_rsus)
    state = state.replace(topo=dict(state.topo, rsu_models=models))
    before = [convert.ravel(t).clone() for t in models]
    pos = state.topo["positions"].copy()
    out = [run_round(state, tsc) for _ in range(2)]
    (s1, r1), (s2, r2) = out
    assert r1 == r2
    np.testing.assert_array_equal(s1.topo["positions"], s2.topo["positions"])
    for a, b in zip(s1.topo["rsu_models"], s2.topo["rsu_models"]):
        assert torch.equal(convert.ravel(a), convert.ravel(b))
    np.testing.assert_array_equal(state.topo["positions"], pos)
    for t, b in zip(state.topo["rsu_models"], before):
        assert torch.equal(convert.ravel(t), b)
    assert torch.equal(convert.ravel(s1.topo["rsu_models"][rsu]),
                       before[rsu])
    assert r1["n_handovers"] > 0 and not r1["synced"]


def test_handover_sync_with_a_kept_rsu_model_is_the_weighted_sum():
    """A sync round in which one RSU gets no usable upload (all stale,
    stale_discount=0): its kept model enters the sync raveled from its
    tree, the others as the rows merged this round. The synced global
    tree is bitwise the weighted sum of the RSU models that the same
    round leaves without the sync."""
    def scenario(sync_every):
        return Scenario(topology="handover", topology_kwargs=dict(
            HANDOVER, stale_discount=0.0, sync_every=sync_every),
            data=_data(), device="cpu", **KW)

    sync, nosync = scenario(1), scenario(100)
    state, _, rsu = _all_stale_state(nosync)
    models = _distinct_models(state.global_tree, nosync.topology.n_rsus)
    state = state.replace(topo=dict(state.topo, rsu_models=models))
    gen = torch.Generator()
    gen.set_state(state.gen_state)
    positions = state.topo["positions"]
    plan = sync.topology.plan_round(
        sync.topology.draw_round(unpack_host_rng(state.host_rng), gen,
                                 positions, sync),
        state.round, positions, state.topo["blur_sum"],
        state.topo["upload_count"], sync)
    assert plan.synced and rsu not in [r for r, _, _ in plan.uploads]
    s_sync, rec = run_round(state, sync)
    s_no, _ = run_round(state, nosync)
    assert rec["synced"]
    assert torch.equal(convert.ravel(s_no.topo["rsu_models"][rsu]),
                       convert.ravel(models[rsu]))
    want = tagg._weighted_tree_sum(list(s_no.topo["rsu_models"]),
                                   plan.sync_W)
    assert torch.equal(convert.ravel(s_sync.global_tree),
                       convert.ravel(want))


def test_region_view_matches_reference():
    """The uniform merge of distinct RSU models; the state untouched."""
    jsc, tsc = _scenarios("handover", HANDOVER)
    jstate = jsc.init_state()
    rs = np.random.RandomState(5)
    models = tuple(jax.tree.map(
        lambda a: (np.asarray(a) + rs.randn(*np.shape(a)) * 0.1)
        .astype(np.float32), jstate.global_tree) for _ in range(2))
    jstate = jstate.replace(topo=dict(jstate.topo, rsu_models=models))
    with jagg.wagg_backend("interpret"):
        want = jsc.topology.region_view(jstate)
    st = port_state(jstate)
    got = tsc.topology.region_view(st)
    # uniform weights 0.5 each: both sums are exact, so the merge is
    # bitwise whatever the summation order
    np.testing.assert_array_equal(convert.ravel(got).numpy(),
                                  _ravel_ref(want))
    assert torch.equal(convert.ravel(st.topo["rsu_models"][0]),
                       torch.from_numpy(_ravel_ref(models[0])))
