"""Whole-round parity: the port's SingleRSU round against the reference's.

The reference (`repro`, JAX) runs `run_round(..., parallel=False)` with
its Pallas `wagg` kernel in interpret mode. The port (`repro_torch`, CPU)
runs the same round from the converted global tree, fed a plan whose
random draws are replayed from the reference's keys
(`topology._cohort_plan`, `clients.make_local_train_step`'s per-iteration
split, `clients._client_loss`, `ssl.pi1` / `ssl.pi2`). Cohort ids, batch
indices, velocities and the host RNG state are bitwise equal; loss and
tree agree within the tolerances below, each round starting both sides
from the reference's tree.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import topology as jtopo
from repro.core.scenario import Scenario as JScenario
from repro.core.scenario import run_round as j_run_round
from repro_torch import convert
from repro_torch.core import topology as ttopo
from repro_torch.core.scenario import Scenario, run_round
from repro_torch.core.state import FLState, generator_from, unpack_host_rng

# The reference trains inside one XLA program (fused, FMA-contracted
# convolutions and BN); the port runs PyTorch's CPU kernels op by op, so
# activations agree to float32 rounding (z within ~1e-6). A ReLU whose
# input lies within that rounding of 0 can still switch sides; at this
# size (batch 8, BN over as few as 32 values per channel) one such switch
# in the first round moves the weight update by up to 2.4e-3 in one
# element and 0.45% in norm (measured), and a second round from diverged
# trees amplifies it. So each round starts both sides from the
# reference's tree, and the tree is held to a max abs difference and to
# the norm of the difference relative to the norm of the round's update.
LOSS_TOL = 1e-4          # measured below 3e-6
TREE_MAX_ABS = 1e-2      # measured below 2.7e-3
TREE_REL_UPDATE = 2e-2   # measured below 4.5e-3
KW = dict(n_vehicles=4, vehicles_per_round=2, batch_size=8, rounds=4,
          local_iters=1)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Under pytest-xdist, each worker's torch intra-op pool gets its
    share of the cores instead of all of them: N workers each running a
    pool as wide as the machine oversubscribe it, and the CPU rounds of
    these tests then take 25x longer (measured: two small MultiRSU
    rounds, six processes on 8 cores, 256 s against 10 s with one
    thread each). A single process keeps torch's default. The port's
    test modules import this fixture, which makes it theirs too."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                                  // workers))
    yield
    torch.set_num_threads(prev)


def _data():
    rs = np.random.RandomState(0)
    return [rs.rand(20, 16, 16, 3).astype(np.float32) for _ in range(4)]


def _np(x):
    return torch.from_numpy(np.array(x))


def replay_pi_draws(key, b: int):
    """The port's (pi1, pi2) draws for one local iteration, replayed from
    the reference's key (clients._client_loss, ssl.pi1, ssl.pi2)."""
    k1, k2 = jax.random.split(key)
    a, c = jax.random.split(k1)
    d1 = {"flip": _np(jax.random.bernoulli(a, 0.5, (b,))),
          "gray": _np(jax.random.bernoulli(c, 0.2, (b,)))}
    j1, j2, j3 = jax.random.split(k2, 3)
    ks = jax.random.split(j2, 4)
    f = [_np(jax.random.uniform(k, (b, 1, 1, 1), minval=0.6, maxval=1.4))
         for k in ks[:3]]
    d2 = {"apply": _np(jax.random.bernoulli(j1, 0.8, (b,))),
          "brightness": f[0], "contrast": f[1], "saturation": f[2],
          "hue": _np(jax.random.uniform(ks[3], (b, 1, 1), minval=-0.4,
                                        maxval=0.4)),
          "gray": _np(jax.random.bernoulli(j3, 0.4, (b,)))}
    return d1, d2


def replayed_plan(jstate, jsc, tsc):
    """The port's plan for the reference's next round, with the
    reference's draws; also checks the host-RNG half bitwise."""
    cfg = jsc.cfg
    rng_j = unpack_host_rng(jstate.host_rng)
    ids, vel_j, lr_j, _, cks = jtopo._cohort_plan(rng_j, jstate.key,
                                                  jstate.round, jsc)
    idx_j = [jtopo._batch_indices(rng_j, len(jsc.data[c]), cfg) for c in ids]

    rng_t = unpack_host_rng(jstate.host_rng)
    plan = ttopo._cohort_plan(rng_t, torch.Generator().manual_seed(0),
                              jstate.round, tsc)
    np.testing.assert_array_equal(plan.ids, ids)
    for a, b in zip(plan.batch_idx, idx_j):
        np.testing.assert_array_equal(a, b)
    assert rng_t.get_state()[2] == rng_j.get_state()[2]
    np.testing.assert_array_equal(rng_t.get_state()[1], rng_j.get_state()[1])
    assert abs(plan.lr - float(lr_j)) <= np.spacing(np.float32(lr_j))

    _, kv = jax.random.split(jstate.key)
    u = np.array(jax.random.uniform(kv, (len(ids),)))
    vel = tsc.mobility.sample(None, len(ids), u=torch.from_numpy(u))
    np.testing.assert_array_equal(vel.numpy(), np.asarray(vel_j))
    draws = [[replay_pi_draws(k, cfg.batch_size)
              for k in jax.random.split(ck, cfg.local_iters)] for ck in cks]
    return dataclasses.replace(plan, velocities=vel, draws=draws)


def port_state(jstate, device="cpu") -> FLState:
    """The port's FLState holding the reference state's tree, host RNG,
    round, topology, client and comms state (its generator is a fresh
    one: a test replays the reference's jax draws into the plan)."""
    return FLState(
        global_tree=convert.tree_from_numpy(
            jax.tree.map(np.asarray, jstate.global_tree), device),
        gen_state=torch.Generator().get_state(), host_rng=jstate.host_rng,
        round=jstate.round, topo=convert.topo_from_numpy(jstate.topo, device),
        client_state=convert.client_state_from_numpy(jstate.client_state,
                                                     device),
        comms=convert.comms_from_numpy(jstate.comms, device))


def _ravel_ref(t):
    return np.concatenate([np.asarray(l).reshape(-1)
                           for l in jax.tree.leaves(t)])


def _assert_trees_close(t_port, t_ref, t_start):
    a, b = convert.ravel(t_port).numpy(), _ravel_ref(t_ref)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= TREE_MAX_ABS
    upd = np.linalg.norm(b - _ravel_ref(t_start))
    assert np.linalg.norm(a - b) <= TREE_REL_UPDATE * upd


@pytest.mark.parametrize("aggregator", ["flsimco", "softmax"])
def test_round_matches_reference_two_rounds(aggregator):
    data = _data()
    jsc = JScenario(topology="single", client="dtssl", aggregator=aggregator,
                    data=data, **KW)
    tsc = Scenario(topology="single", client="dtssl", aggregator=aggregator,
                   data=data, device="cpu", **KW)
    jstate = jsc.init_state()
    for _ in range(2):
        plan = replayed_plan(jstate, jsc, tsc)
        st, rec = tsc.topology.execute(port_state(jstate), tsc, plan)
        tree = st.global_tree
        start = jstate.global_tree
        with jagg.wagg_backend("interpret"):
            jstate, jrec = j_run_round(jstate, jsc, parallel=False)
        assert rec["velocities"] == jrec["velocities"]
        assert rec["round"] == jrec["round"]
        assert abs(rec["loss"] - jrec["loss"]) <= LOSS_TOL
        _assert_trees_close(tree, jstate.global_tree, start)


def test_round_is_pure_and_advances_state():
    tsc = Scenario(data=_data(), device="cpu", **KW)
    s0 = tsc.init_state()
    s1, r1 = run_round(s0, tsc)
    s1b, r1b = run_round(s0, tsc)
    assert r1 == r1b and s1.round == 1
    assert torch.equal(convert.ravel(s1.global_tree),
                       convert.ravel(s1b.global_tree))
    assert not torch.equal(s1.gen_state, s0.gen_state)
    assert unpack_host_rng(s1.host_rng).get_state()[2] != \
        unpack_host_rng(s0.host_rng).get_state()[2]
    # the generator state carried in FLState reproduces the plan's draws
    gen = generator_from(s0.gen_state)
    v = tsc.mobility.sample(gen, KW["vehicles_per_round"])
    assert v.tolist() == r1["velocities"]
