"""The port's FedCo baseline (repro_torch.core.clients.FedCoClient, the
MoCo helpers of core/ssl.py, InfoNCE) against the reference's, on the
CPU.

Rounds start both sides from the reference's state (its tree, key
encoder and queue: `test_torch_round.port_state`) with the reference's
jax draws replayed into the port's plan, as tests/test_torch_round.py
does for DT-SSL.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import dt_loss as jdt
from repro.core import ssl as jssl
from repro.core.scenario import Scenario as JScenario
from repro.core.scenario import run_round as j_run_round
from repro.core.state import resolve_fedco_alias as j_resolve
from repro_torch import convert
from repro_torch.core import dt_loss as tdt
from repro_torch.core import ssl as tssl
from repro_torch.core.scenario import Scenario
from repro_torch.core.state import resolve_fedco_alias
from test_torch_round import (KW, LOSS_TOL, _assert_trees_close, _data,
                              _ravel_ref, port_state, replayed_plan,
                              torch_threads)  # noqa: F401 (autouse)

QUEUE = 64
# The uploaded k-vectors: the key encoder's projector output (unit norm)
# on the pi2 view; float32 rounding of two frameworks' convolutions.
# Measured: max abs 2.8e-7.
KVEC_TOL = 1e-5
# The EMA key encoder, m*k + (1-m)*q: XLA may fuse it into one FMA
# under jit (one rounding fewer). Measured: bitwise equal (eager).
EMA_TOL = 1e-6
# Rounds (LOSS_TOL, TREE_MAX_ABS, TREE_REL_UPDATE of test_torch_round).
# Measured: loss 7.6e-8, tree max abs 3.4e-6, 0.0014% of the update's
# norm, under SingleRSU and MultiRSU.


def _t(x):
    return torch.from_numpy(np.array(x))


def test_info_nce_loss_matches_reference():
    rs = np.random.RandomState(0)

    def unit(*shape):
        x = rs.randn(*shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q, k, queue = unit(32, 128), unit(32, 128), unit(256, 128)
    for tau in (0.07, 0.2):
        want = float(jdt.info_nce_loss(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(queue), tau))
        got = float(tdt.info_nce_loss(_t(q), _t(k), _t(queue), tau))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_moco_helpers_match_reference():
    rs = np.random.RandomState(1)
    kp = {"a": rs.randn(5, 3).astype(np.float32),
          "b": {"c": rs.randn(4).astype(np.float32)}}
    qp = jax.tree.map(lambda a: (a + rs.randn(*a.shape)).astype(np.float32),
                      kp)
    want = jssl.momentum_update(kp, qp, 0.99)
    got = tssl.momentum_update(convert.tree_from_numpy(kp),
                               convert.tree_from_numpy(qp), 0.99)
    np.testing.assert_allclose(convert.ravel(got).numpy(), _ravel_ref(want),
                               rtol=0, atol=EMA_TOL)

    st = tssl.init_moco_state(convert.tree_from_numpy(kp), 10, 4,
                              torch.Generator().manual_seed(0))
    assert st.ptr == 0 and tuple(st.queue.shape) == (10, 4)
    np.testing.assert_allclose(st.queue.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert torch.equal(convert.ravel(st.key_params),
                       torch.from_numpy(_ravel_ref(kp)))
    jst = jssl.MoCoState(key_params=kp, queue=jnp.asarray(st.queue.numpy()),
                         ptr=jnp.zeros((), jnp.int32))
    for b in (3, 4, 6):     # the third push wraps around the ring
        keys = rs.randn(b, 4).astype(np.float32)
        jst = jssl.queue_push(jst, jnp.asarray(keys))
        st = tssl.queue_push(st, _t(keys))
        np.testing.assert_array_equal(st.queue.numpy(), np.asarray(jst.queue))
        assert st.ptr == int(jst.ptr)

    queue = rs.randn(10, 4).astype(np.float32)
    ups = [rs.randn(3, 4).astype(np.float32) for _ in range(2)]
    for u in (ups, ups * 3):    # the uploads fill part of, or all, the queue
        want = jssl.fedco_merge_queues(jnp.asarray(queue),
                                       [jnp.asarray(x) for x in u])
        got = tssl.fedco_merge_queues(_t(queue), [_t(x) for x in u])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("aggregator,client", [
    ("fedco", None), ("fedco", "fedco"), ("flsimco", "fedco"),
    ("fedavg", None), (None, "dtssl"), ("fedco", "dtssl")])
def test_fedco_alias_resolves_as_reference(aggregator, client):
    try:
        want = j_resolve(aggregator, client)
    except ValueError:
        with pytest.raises(ValueError, match="legacy alias"):
            resolve_fedco_alias(aggregator, client)
        with pytest.raises(ValueError, match="legacy alias"):
            Scenario(device="cpu", aggregator=aggregator, client=client)
        return
    assert resolve_fedco_alias(aggregator, client) == want


def _fedco_round(jsc, tsc, jstate):
    """One FedCo round on both sides from the reference's state."""
    plan = replayed_plan(jstate, jsc, tsc)
    st, rec = tsc.topology.execute(port_state(jstate), tsc, plan)
    with jagg.wagg_backend("interpret"):
        jnext, jrec = j_run_round(jstate, jsc, parallel=False)
    assert rec["velocities"] == jrec["velocities"]
    assert abs(rec["loss"] - jrec["loss"]) <= LOSS_TOL
    _assert_trees_close(st.global_tree, jnext.global_tree, jstate.global_tree)
    # the key encoder is a copy of the aggregated tree
    cs, jcs = st.client_state, jnext.client_state
    assert torch.equal(convert.ravel(cs["key_tree"]),
                       convert.ravel(st.global_tree))
    assert cs["key_tree"]["params"]["stem"].data_ptr() != \
        st.global_tree["params"]["stem"].data_ptr()
    # the merged queue: the uploads (one batch of k-vectors per client,
    # newest first in cohort order) in front of the old queue, truncated
    n_up = tsc.cfg.vehicles_per_round * tsc.cfg.batch_size
    q, jq = cs["queue"].numpy(), np.asarray(jcs["queue"])
    assert q.shape == jq.shape == (QUEUE, 128)
    np.testing.assert_allclose(q[:n_up], jq[:n_up], rtol=0, atol=KVEC_TOL)
    np.testing.assert_array_equal(
        q[n_up:], np.asarray(jstate.client_state["queue"])[:QUEUE - n_up])
    assert rec["round"] == jrec["round"]
    return st, rec


def test_fedco_single_rsu_round_matches_reference():
    """client="fedco" through the legacy aggregator="fedco" spelling:
    FedAvg of the client trees under SingleRSU."""
    kw = dict(aggregator="fedco", data=_data(), queue_len=QUEUE, **KW)
    jsc, tsc = JScenario(**kw), Scenario(device="cpu", **kw)
    assert (tsc.cfg.aggregator, tsc.cfg.client) == ("fedavg", "fedco")
    _fedco_round(jsc, tsc, jsc.init_state())


def test_fedco_multi_rsu_round_matches_reference():
    """FedCo under MultiRSU(n_rsus=2) with the hierarchical Eq.-11
    aggregation: the uploads are merged in RSU-group order (round-robin:
    cohort indices 0 and 2, then 1)."""
    kw = dict(topology="multi", client="fedco", data=_data(),
              queue_len=QUEUE, **dict(KW, vehicles_per_round=3))
    jsc = JScenario(topology_kwargs={"n_rsus": 2, "mesh_aggregate": False},
                    **kw)
    tsc = Scenario(topology_kwargs={"n_rsus": 2}, device="cpu", **kw)
    st, rec = _fedco_round(jsc, tsc, jsc.init_state())
    assert rec["rsu_sizes"] == [2, 1]


def test_fedco_init_state_and_handover_refusal():
    sc = Scenario(client="fedco", data=_data(), device="cpu",
                  queue_len=QUEUE, **KW)
    st = sc.init_state()
    queue = st.client_state["queue"]
    assert tuple(queue.shape) == (QUEUE, 128) and queue.dtype == torch.float32
    np.testing.assert_allclose(queue.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert torch.equal(queue, sc.init_state().client_state["queue"])
    assert torch.equal(convert.ravel(st.client_state["key_tree"]),
                       convert.ravel(st.global_tree))
    with pytest.raises(ValueError, match="client='dtssl'"):
        Scenario(topology="handover", client="fedco", device="cpu")
