"""The port's batched cohort step (`DTSSLClient.run_cohort(parallel=True)`:
the client step under `torch.func.vmap` over chunks of clients, one DT
loss call a chunk) against its client-by-client path and against the
reference's vmapped `run_round(parallel=True)`, on the CPU.

The reference runs with its Pallas `wagg` in interpret mode; the port
starts from the reference's state with the reference's jax draws
replayed into its plan (tests/test_torch_round.py). The reference's own
oracle for this, `test_parallel_and_sequential_rounds_agree`
(tests/test_federation.py), passes here; its bucketed handover oracle
(`test_handover_bucketed_vmapped_matches_sequential`) fails on this tree,
so the port's padded handover is held against the port's own sequential
path, and against the reference's vmapped round within tolerance.

Tolerances are test_torch_round.py's LOSS_TOL, TREE_MAX_ABS and
TREE_REL_UPDATE (1e-4, 1e-2, 2e-2). Measured here, over the single,
multi and padded handover rounds: the batched round against the port's
sequential one, loss within 9.5e-7, trees within 9.6e-5 max abs and
0.0072% of the update's norm; against the reference's vmapped round,
loss within 6.2e-7, trees within 2.7e-3 max abs and 0.42% of the
update's norm. Padded (bucketed) and exact handover groups gave bitwise
equal RSU models.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.scenario import Scenario as JScenario
from repro.core.scenario import run_round as j_run_round
from repro_torch import convert
from repro_torch.core import aggregation as tagg
from repro_torch.core import clients as tclients
from repro_torch.core import ssl as tssl
from repro_torch.core.cohort import CohortBatch, bucket_size
from repro_torch.core.scenario import Scenario, run_round
from repro_torch.core.state import (generator_from, pack_host_rng,
                                    unpack_host_rng)
from repro_torch.kernels import ops, ref
from test_torch_round import (LOSS_TOL, TREE_MAX_ABS, TREE_REL_UPDATE,
                              _assert_trees_close, port_state, replayed_plan,
                              torch_threads)  # noqa: F401 (autouse)
from test_torch_topology import (HANDOVER, _assert_plans_equal,
                                 _assert_rsu_models_close, _replayed_handover)

KW = dict(n_vehicles=6, vehicles_per_round=3, batch_size=8, rounds=4)


def _data(n=6, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.rand(20, 16, 16, 3).astype(np.float32) for _ in range(n)]


def _unit(rs, *shape):
    x = rs.randn(*shape).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True))


def _assert_rows_close(a: torch.Tensor, b: torch.Tensor, start: torch.Tensor):
    """Cohort rows `a` against `b`, each trained from the flat `start`."""
    assert a.shape == b.shape and bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) <= TREE_MAX_ABS
    for x, y in zip(a, b):
        assert float((x - y).norm()) <= TREE_REL_UPDATE * float(
            (y - start).norm())


# --------------------------------------------------------------------------
# the DT loss of a cohort
# --------------------------------------------------------------------------

@pytest.mark.parametrize("taus", [(0.1, 1.0), (0.07, 1.0)])
def test_cohort_dt_loss_and_vmapped_grads_bitwise(taus):
    """The cohort plain version is C unbatched calls, bitwise; through
    `torch.func.vmap(torch.func.grad)` the loss and its gradients are
    bitwise those of a loop of the unbatched autograd path."""
    rs = np.random.RandomState(0)
    c, m, d = 4, 24, 32
    q, k = _unit(rs, c, m, d), _unit(rs, c, m, d)
    got = ops.dt_loss_fwd(q, k, *taus)
    assert all(t.shape == (c, m) for t in got)
    for i in range(c):
        for a, b in zip(ref.dt_loss_fwd_ref(q[i], k[i], *taus),
                        (t[i] for t in got)):
            assert torch.equal(a, b)

    def loss(a, b):
        return ops.dt_loss(a, b, *taus)

    losses = torch.func.vmap(loss)(q, k)
    gq, gk = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(q, k)
    for i in range(c):
        qi, ki = q[i].clone().requires_grad_(), k[i].clone().requires_grad_()
        li = loss(qi, ki)
        a, b = torch.autograd.grad(li, (qi, ki))
        assert torch.equal(li.detach(), losses[i])
        assert torch.equal(a, gq[i]) and torch.equal(b, gk[i])
    # an unbatched k (in_dims None) goes through the same cohort call
    l0 = torch.func.vmap(loss, in_dims=(0, None))(q, k[0])
    assert torch.equal(l0[0], losses[0])


def test_resnet_apply_under_vmap_keeps_bn_per_client():
    """Under `torch.func.vmap` with the tree unbatched, the forward, the
    features and the new BN state of each client are those of its own
    unbatched call (BN statistics per client, never over the chunk)."""
    from repro_torch.models.resnet import resnet_apply

    tree = Scenario(device="cpu", data=_data()).init_tree()
    x = torch.from_numpy(np.stack([d[:8] for d in _data(3, seed=2)]))
    x[1] *= 0.5                       # clients whose statistics differ
    z, h, t = torch.func.vmap(lambda xi: resnet_apply(tree, xi))(x)
    # one convolution over 24 images against three over 8: float32 sums
    # in other orders (measured: z 5.8e-7, BN state 8.3e-7 max abs)
    for i in range(3):
        zi, hi, ti = resnet_apply(tree, x[i])
        torch.testing.assert_close(z[i], zi, atol=1e-6, rtol=0)
        torch.testing.assert_close(h[i], hi, atol=1e-5, rtol=1e-5)
        for (_, a), (_, b) in zip(convert.leaves_with_paths(t["state"]),
                                  convert.leaves_with_paths(ti["state"])):
            torch.testing.assert_close(a[i], b, atol=1e-6, rtol=1e-6)


def test_cohort_batch_rows_and_padding():
    spec = convert.flat_spec({"a": torch.zeros(2, 3), "b": torch.zeros(4)})
    c = CohortBatch.empty(spec, 4, n=3)
    trees = {"a": torch.arange(18.0).reshape(3, 2, 3),
             "b": -torch.arange(12.0).reshape(3, 4)}
    c.write_rows(0, trees, torch.tensor([1.0, 2.0, 3.0]))
    for i in range(3):
        one = CohortBatch.empty(spec, 1)
        one.write(0, {"a": trees["a"][i], "b": trees["b"][i]}, 0.0)
        assert torch.equal(c.flat[i], one.flat[0])
    c = c.with_stats(velocities=[1.0, 2.0, 3.0], blur=[4.0, 5.0, 6.0])
    p = c.pad_to(8)
    assert p.size == 8 and p.n == 3 and c.pad_to(4) is c
    assert p.mask.tolist() == [1, 1, 1, 0, 0, 0, 0, 0]
    assert torch.equal(p.flat[4:], c.flat[3:].expand(4, -1))
    assert p.blur.tolist() == [4, 5, 6, 6, 6, 6, 6, 6]
    w = torch.tensor([0.2, 0.3, 0.5])
    assert torch.equal(tagg.cohort_weighted_row(p, w),
                       tagg.cohort_weighted_row(c, w))
    with pytest.raises(ValueError):
        c.pad_to(3)
    assert [bucket_size(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]
    with pytest.raises(ValueError):
        bucket_size(0)


# --------------------------------------------------------------------------
# rounds: batched against sequential and against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("topology,local_iters,m", [("single", 1, 2),
                                                    ("multi", 1, 4),
                                                    ("single", 2, 3)])
def test_parallel_round_matches_sequential_and_reference(topology,
                                                         local_iters, m):
    """One round of m clients from the reference's state: the port's
    batched round against its sequential round and, at one local
    iteration, against the reference's `run_round(parallel=True)`
    (MultiRSU's two groups of 2 reuse SingleRSU's compiled cohort step
    of 2). Two local iterations run at lr 0.05: at lr 0.9 a 1e-7 change
    of the images moves the sequential path's own second iteration by 5%
    of the update (measured), so no two paths agree there."""
    tkw = {"n_rsus": 2} if topology == "multi" else None
    kw = dict(KW, local_iters=local_iters, vehicles_per_round=m,
              lr=0.9 if local_iters == 1 else 0.05)
    data = _data()
    jsc = JScenario(topology=topology, topology_kwargs=tkw, data=data, **kw)
    tsc = Scenario(topology=topology, topology_kwargs=tkw, data=data,
                   device="cpu", **kw)
    jstate = jsc.init_state()
    plan = replayed_plan(jstate, jsc, tsc)
    out = {par: tsc.topology.execute(port_state(jstate), tsc, plan,
                                     parallel=par) for par in (True, False)}
    (st, rec), (st_s, rec_s) = out[True], out[False]
    assert rec["velocities"] == rec_s["velocities"]
    assert abs(rec["loss"] - rec_s["loss"]) <= LOSS_TOL
    if local_iters == 1:
        with jagg.wagg_backend("interpret"):
            jnext, jrec = j_run_round(jstate, jsc, parallel=True)
        assert rec["velocities"] == jrec["velocities"]
        assert abs(rec["loss"] - jrec["loss"]) <= LOSS_TOL
        _assert_trees_close(st.global_tree, jnext.global_tree,
                            jstate.global_tree)
    start = convert.ravel(port_state(jstate).global_tree)
    _assert_rows_close(convert.ravel(st.global_tree)[None],
                       convert.ravel(st_s.global_tree)[None], start)


@pytest.fixture(scope="module")
def five_clients():
    """Five clients' batches and draws, the tree they start from, and
    their rows trained client by client."""
    sc = Scenario(device="cpu", batch_size=8, data=_data())
    cfg, tree = sc.cfg, sc.init_tree()
    gen = torch.Generator().manual_seed(3)
    batches = [torch.from_numpy(x[:8]) for x in _data(5, seed=1)]
    draws = [[(tssl.draw_pi1(gen, 8), tssl.draw_pi2(gen, 8))]
             for _ in range(5)]
    seq, _ = tclients.DTSSLClient().run_cohort(cfg, tree, None, batches,
                                               draws, 0.9, parallel=False)
    return cfg, tree, batches, draws, seq


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_chunk_sizes_give_the_same_trees(chunk, five_clients, monkeypatch):
    """Chunks of 1, 2 and 5 clients against the client-by-client rows:
    each row within TREE_REL_UPDATE of its update, and the Eq.-11
    aggregate of the five within TREE_MAX_ABS too. (One client's row
    differs from its sequential row by up to 1.9e-2 in one element at
    this batch of 8, from a ReLU input within rounding of 0, measured
    alike for every chunk size; an aggregate averages it down, so the
    max-abs bound holds aggregates, as in the round tests.)"""
    cfg, tree, batches, draws, seq = five_clients
    monkeypatch.setattr(tclients, "CLIENTS_PER_CHUNK", chunk)
    got, _ = tclients.DTSSLClient().run_cohort(cfg, tree, None, batches,
                                               draws, 0.9)
    assert got.n == got.size == 5 and bool(torch.isfinite(got.flat).all())
    start = convert.ravel(tree)
    for x, y in zip(got.flat, seq.flat):
        assert float((x - y).norm()) <= TREE_REL_UPDATE * float(
            (y - start).norm())
    assert float((got.losses - seq.losses).abs().max()) <= LOSS_TOL
    w = tagg.flsimco_weights(torch.tensor([12.0, 15.0, 20.0, 25.0, 30.0]))
    _assert_rows_close(tagg.cohort_weighted_row(got, w)[None],
                       tagg.cohort_weighted_row(seq, w)[None], start)


def test_padded_group_aggregates_as_the_unpadded_one(five_clients,
                                                     monkeypatch):
    """Three clients padded to bucket_size(3) = 4: the padded row trains
    on the last client's batch and draws again, and is masked out, so
    the Eq.-11 aggregate is the unpadded group's (bitwise, given the same
    valid rows)."""
    cfg, tree, batches, draws, seq = five_clients
    monkeypatch.setattr(tclients, "CLIENTS_PER_CHUNK", 4)
    client = tclients.DTSSLClient()
    plain, _ = client.run_cohort(cfg, tree, None, batches[:3], draws[:3],
                                 0.9)
    padded, _ = client.run_cohort(cfg, tree, None, batches[:3], draws[:3],
                                  0.9, pad_to=bucket_size(3))
    assert (padded.size, padded.n, plain.size) == (4, 3, 3)
    assert padded.mask.tolist() == [1, 1, 1, 0]
    start = convert.ravel(tree)
    _assert_rows_close(padded.flat[:3], plain.flat, start)
    _assert_rows_close(padded.flat[3:], padded.flat[2:3], start)
    w = tagg.flsimco_weights(torch.tensor([12.0, 20.0, 30.0]))
    same_rows = dataclasses.replace(padded, flat=torch.cat(
        [plain.flat, padded.flat[3:]]))
    assert torch.equal(tagg.cohort_weighted_row(same_rows, w),
                       tagg.cohort_weighted_row(plain, w))
    # FedCo is sequential whatever `parallel` says
    fedco = tclients.FedCoClient()
    fcfg = dataclasses.replace(cfg, client="fedco", queue_len=32)
    cs = fedco.init_state(fcfg, tree)
    rows = [fedco.run_cohort(fcfg, tree, cs, batches[:2], draws[:2], 0.9,
                             parallel=par)[0].flat for par in (True, False)]
    assert torch.equal(rows[0], rows[1])


def _padded_handover(tsc, jsc):
    """A reference state whose next round pads a download group: the
    round-0 state carried through the rounds' plans (positions, sync
    statistics and both random streams; the models stay the round-0
    ones) until a plan has a group whose size is not a power of two."""
    jstate = jsc.init_state()
    for _ in range(8):
        like = (jstate.host_rng, jstate.key, jstate.round, jstate.topo)
        jplan, plan, rng = _replayed_handover(jsc.topology, tsc.topology,
                                              like, jsc, tsc)
        if any(bucket_size(s.size) != s.size for _, s in plan.down_groups):
            return jstate
        jstate = jstate.replace(
            host_rng=pack_host_rng(rng), key=jplan["key"],
            round=jstate.round + 1,
            topo=dict(jstate.topo, positions=plan.positions,
                      blur_sum=plan.blur_sum,
                      upload_count=plan.upload_count))
    raise AssertionError("no padded download group in eight plans")


def test_handover_padded_round_matches_sequential_and_reference():
    """A handover round with a padded download group: the port's batched
    round against its sequential round (the generator and host RNG state
    after the round equal, so the padding drew nothing) and against the
    reference's vmapped, bucketed round."""
    data = _data()
    kw = dict(KW, vehicles_per_round=5)
    jsc = JScenario(topology="handover", topology_kwargs=HANDOVER,
                    data=data, **kw)
    tsc = Scenario(topology="handover", topology_kwargs=HANDOVER, data=data,
                   device="cpu", **kw)
    jstate = _padded_handover(tsc, jsc)
    like = (jstate.host_rng, jstate.key, jstate.round, jstate.topo)
    jplan, plan, _ = _replayed_handover(jsc.topology, tsc.topology, like,
                                        jsc, tsc)
    _assert_plans_equal(plan, jplan)
    out = {par: tsc.topology.execute(port_state(jstate), tsc, plan,
                                     parallel=par) for par in (True, False)}
    with jagg.wagg_backend("interpret"):
        jnext, jrec = j_run_round(jstate, jsc, parallel=True)
    (st, rec), (st_s, rec_s) = out[True], out[False]
    for other in (rec_s, jrec):
        for k in ("round", "velocities", "rsu_sizes", "n_handovers",
                  "synced"):
            assert rec[k] == other[k], k
        assert abs(rec["loss"] - other["loss"]) <= LOSS_TOL
    _assert_rsu_models_close(st, jnext, jstate)
    start = port_state(jstate)
    for a, b, s0 in zip(st.topo["rsu_models"], st_s.topo["rsu_models"],
                        start.topo["rsu_models"]):
        _assert_rows_close(convert.ravel(a)[None], convert.ravel(b)[None],
                           convert.ravel(s0))


def test_padding_draws_no_random_numbers():
    """bucketed=True and bucketed=False from one port state leave the
    same generator and host RNG state and the same records, whatever the
    group sizes; the rows they train agree within tolerance."""
    data = _data()
    kw = dict(KW, vehicles_per_round=5)
    out = []
    for bucketed in (True, False):
        sc = Scenario(topology="handover", data=data, device="cpu",
                      topology_kwargs=dict(HANDOVER, bucketed=bucketed),
                      **kw)
        state = sc.init_state()
        positions = state.topo["positions"]
        plan = sc.topology.plan_round(
            sc.topology.draw_round(unpack_host_rng(state.host_rng),
                                   generator_from(state.gen_state),
                                   positions, sc),
            state.round, positions, state.topo["blur_sum"],
            state.topo["upload_count"], sc)
        out.append((state, plan) + run_round(state, sc))
    (s0, plan, st_b, rec_b), (_, _, st_u, rec_u) = out
    assert any(bucket_size(s.size) != s.size for _, s in plan.down_groups)
    assert torch.equal(st_b.gen_state, st_u.gen_state)
    for k in st_b.host_rng:
        np.testing.assert_array_equal(st_b.host_rng[k], st_u.host_rng[k])
    assert {k: v for k, v in rec_b.items() if k != "loss"} == \
        {k: v for k, v in rec_u.items() if k != "loss"}
    assert abs(rec_b["loss"] - rec_u["loss"]) <= LOSS_TOL
    for a, b, s in zip(st_b.topo["rsu_models"], st_u.topo["rsu_models"],
                       s0.topo["rsu_models"]):
        _assert_rows_close(convert.ravel(a)[None], convert.ravel(b)[None],
                           convert.ravel(s))
