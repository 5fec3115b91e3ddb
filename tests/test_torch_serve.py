"""The port's serving tier (repro_torch.serve) on CPU tensors.

The cases of the reference's tests/test_serve.py that need no compiled
engine, ported: publish chains, encode-once accounting, eviction into the
full-tree fallback, bitwise decode of every reply path, admission
control, coalescing, exactly-once resolution, stop semantics, a threaded
fleet and the eager ``run(publish=)`` hook; and the random interleavings
of tests/test_serve_properties.py, drawn from numpy seeds. Trees are
compared as flat rows with ``torch.equal``. One cross-package case holds
the port's `ModelStore` against the reference's on the same trees.
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import ModelStore as JModelStore
from repro_torch import convert
from repro_torch.comms.codecs import decode_snapshot
from repro_torch.core.scenario import Scenario, run
from repro_torch.serve import (ModelStore, PendingFetch, Reply, RSUServer,
                               ServePolicy, apply_reply, build_reply)
from test_torch_round import torch_threads  # noqa: F401 (autouse)

CODEC_NAMES = ["identity", "delta", "delta_int8"]


def _np_tree_at(i, seed=0):
    rs = np.random.RandomState(seed * 1000 + i)
    return {"w": rs.randn(3, 2).astype(np.float32),
            "b": rs.randn(4).astype(np.float32),
            "s": np.float32(rs.randn())}


def _tree_at(i, seed=0):
    return convert.tree_from_numpy(_np_tree_at(i, seed))


def _eq(a, b):
    return torch.equal(convert.ravel(a), convert.ravel(b))


def _scenario(rounds=3):
    rs = np.random.RandomState(0)
    data = [rs.rand(6, 4, 4, 3).astype(np.float32) for _ in range(8)]
    return Scenario(topology="single", data=data, n_vehicles=8,
                    vehicles_per_round=3, batch_size=2, rounds=rounds,
                    local_iters=1, lr=0.4, seed=11, device="cpu")


# --------------------------------------------------------------------------
# store
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_publish_chain_decodes_bitwise(codec):
    store = ModelStore(codec=codec, window=8)
    for r in range(5):
        store.publish(r, _tree_at(r))
    tree = store.get(0).served_tree
    chain = store.chain_from(0)
    assert [s.round for s in chain] == [1, 2, 3, 4]
    for snap in chain:
        tree = decode_snapshot(codec, snap.delta_payload, tree)
        assert _eq(tree, snap.served_tree)
    if codec != "delta_int8":          # lossless: served IS the published
        assert _eq(tree, store.get(4).tree)


def test_publish_encodes_once_and_rounds_increase():
    store = ModelStore(codec="delta", window=8)
    for r in range(4):
        store.publish(r, _tree_at(r))
    assert store.stats() == {"publishes": 4, "delta_encodes": 3,
                             "full_encodes": 0}
    with pytest.raises(ValueError, match="increase"):
        store.publish(2, _tree_at(2))
    store.full_payload(3)
    store.full_payload(3)
    assert store.stats()["full_encodes"] == 1
    with pytest.raises(KeyError):
        store.full_payload(99)
    with pytest.raises(ValueError):
        ModelStore(codec="gzip")
    with pytest.raises(ValueError):
        ModelStore(window=0)


def test_eviction_breaks_chain_into_full_fallback():
    store = ModelStore(codec="delta", window=3)
    for r in range(6):
        store.publish(r, _tree_at(r))
    assert store.rounds() == [3, 4, 5]
    assert store.chain_from(1) is None
    rep = build_reply(store, ServePolicy(max_lag=10), 1)
    assert rep.kind == "full" and rep.round == 5
    assert _eq(apply_reply(rep, None), store.get(5).tree)
    assert [s.round for s in store.chain_from(3)] == [4, 5]


@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_reply_paths_bitwise_vs_served_tree(codec):
    store = ModelStore(codec=codec, window=8)
    for r in range(5):
        store.publish(r, _tree_at(r))
    pol = ServePolicy(max_lag=2)
    rep = build_reply(store, pol, 3)
    assert rep.kind == "delta" and rep.round == 4 and rep.base_round == 3
    assert _eq(apply_reply(rep, store.get(3).served_tree, codec=codec),
               store.get(4).served_tree)
    rep = build_reply(store, pol, 0)
    assert rep.kind == "full"
    assert _eq(apply_reply(rep, None, codec=codec), store.get(4).served_tree)
    rep = build_reply(store, pol, 4)
    assert rep.kind == "current" and rep.payloads == ()
    marker = {"sentinel": torch.zeros(1)}
    assert apply_reply(rep, marker, codec=codec) is marker


def test_empty_store_sheds_with_retry_after():
    rep = build_reply(ModelStore(), ServePolicy(retry_after_s=0.25), 0)
    assert rep.status == "shed" and rep.retry_after_s == 0.25
    with pytest.raises(ValueError, match="shed"):
        apply_reply(rep, None)


def test_store_matches_reference_store_bitwise():
    """Fed the same trees, the two stores' delta_int8 payloads and served
    trees are bitwise equal (the port's plain q8 is the reference's)."""
    jstore, tstore = JModelStore("delta_int8", 8), ModelStore("delta_int8", 8)
    for r in range(4):
        t = _np_tree_at(r)
        jstore.publish(r, jax.tree.map(jnp.asarray, t))
        tstore.publish(r, convert.tree_from_numpy(t))
    for r in range(4):
        js, ts = jstore.get(r), tstore.get(r)
        want = np.concatenate([np.asarray(l).reshape(-1)
                               for l in jax.tree.leaves(js.served_tree)])
        np.testing.assert_array_equal(
            convert.ravel(ts.served_tree).numpy(), want)
        if r == 0:
            assert ts.delta_payload is None and js.delta_payload is None
            continue
        assert ts.delta_nbytes == js.delta_nbytes
        for k in ("codes", "scales"):
            np.testing.assert_array_equal(ts.delta_payload[k].numpy(),
                                          np.asarray(js.delta_payload[k]))


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------

def _served_store(codec="delta", rounds=4):
    store = ModelStore(codec=codec, window=rounds + 2)
    for r in range(rounds):
        store.publish(r, _tree_at(r))
    return store


def test_admission_control_bounds_queue_and_sheds():
    server = RSUServer(_served_store(),
                       ServePolicy(queue_limit=8, retry_after_s=0.125),
                       start=False)
    pends = [server.submit(2) for _ in range(20)]
    shed = [p for p in pends if p.done()]
    assert len(shed) == 12
    assert all(p.result().status == "shed" and
               p.result().retry_after_s == 0.125 for p in shed)
    assert server.stats()["max_depth"] == 8 and server.pending == 8
    while server.drain_once(block=False):
        pass
    st = server.stats()
    assert st["submitted"] == 20 and st["served"] == 8 and st["shed"] == 12
    assert all(p.done() for p in pends)


def test_batcher_coalesces_one_reply_per_have_round():
    server = RSUServer(_served_store(), ServePolicy(max_batch=64),
                       start=False)
    pends = [server.submit(r) for r in [2, 2, 2, 1, 1, 3]]
    assert server.drain_once(block=False) == 6
    st = server.stats()
    assert st["batches"] == 1 and st["groups"] == 3
    assert pends[0].result() is pends[1].result() is pends[2].result()
    assert pends[3].result() is pends[4].result()
    store = _served_store()
    server2 = RSUServer(store, ServePolicy(max_lag=0), start=False)
    for _ in range(5):
        server2.submit(0)
    server2.drain_once(block=False)
    assert store.stats()["full_encodes"] == 1


def test_max_batch_splits_drains():
    server = RSUServer(_served_store(), ServePolicy(max_batch=4),
                       start=False)
    for _ in range(10):
        server.submit(2)
    drained = []
    while n := server.drain_once(block=False):
        drained.append(n)
    assert drained == [4, 4, 2]


def test_fetch_answered_exactly_once():
    p = PendingFetch(0)
    p._resolve(Reply(status="ok", kind="current", round=0))
    with pytest.raises(RuntimeError, match="twice"):
        p._resolve(Reply(status="ok", kind="current", round=0))
    with pytest.raises(TimeoutError):
        PendingFetch(0).result(timeout=0.01)


def test_stop_drains_pending_then_sheds_new_submits():
    server = RSUServer(_served_store(), start=False)
    pends = [server.submit(2) for _ in range(5)]
    server.stop(drain=True)
    assert all(p.result().status == "ok" for p in pends)
    assert server.submit(2).result().status == "shed"
    server2 = RSUServer(_served_store(), start=False)
    pends2 = [server2.submit(2) for _ in range(5)]
    server2.stop(drain=False)
    assert all(p.result().status == "shed" for p in pends2)
    st = server2.stats()
    assert st["submitted"] == 5 and st["shed"] == 5 and st["served"] == 0


@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_threaded_server_serves_concurrent_fleet(codec):
    store = _served_store(codec)
    server = RSUServer(store, ServePolicy(max_wait_s=0.002))
    results, errors = [], []

    def fleet(seed):
        try:
            rs = np.random.RandomState(seed)
            got = []
            for _ in range(25):
                have = int(rs.randint(0, 4))
                rep = server.submit(have).result(timeout=10.0)
                assert rep.status == "ok"
                base = store.get(have).served_tree
                got.append(_eq(apply_reply(rep, base, codec=codec),
                               store.get(3).served_tree))
            results.append(got)
        except Exception as e:    # reported below, with the thread's seed
            errors.append((seed, e))

    threads = [threading.Thread(target=fleet, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    server.stop()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) == 6 and all(all(r) for r in results)
    st = server.stats()
    assert st["submitted"] == st["served"] == 150 and st["shed"] == 0


# --------------------------------------------------------------------------
# random interleavings (the reference's tests/test_serve_properties.py,
# with seeded numpy draws in place of hypothesis)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODEC_NAMES)
@pytest.mark.parametrize("seed", range(4))
def test_interleavings_preserve_queue_and_parity_invariants(seed, codec):
    """Random publish / submit / drain sequences against a queue model:
    nothing lost or answered twice, the queue bound and the shed count
    exact, replies at the requested round or newer, and every payload
    decoding bitwise to the reconstruction of its round."""
    rs = np.random.RandomState(seed)
    queue_limit, max_batch = rs.randint(1, 7), rs.randint(1, 9)
    max_lag, window = rs.randint(0, 5), rs.randint(1, 7)
    store = ModelStore(codec=codec, window=window)
    policy = ServePolicy(max_batch=max_batch, queue_limit=queue_limit,
                         max_lag=max_lag, retry_after_s=0.01)
    server = RSUServer(store, policy, start=False)
    served_trees, next_round, model_queue, model_shed = {}, 0, 0, 0
    pending = []
    for _ in range(rs.randint(20, 41)):
        op = rs.randint(3)
        if op == 0:
            snap = store.publish(next_round, _tree_at(next_round, seed=5))
            served_trees[next_round] = snap.served_tree
            next_round += 1
        elif op == 1:
            have = min(rs.randint(-1, 13), next_round - 1)
            p = server.submit(have)
            pending.append((p, have))
            if model_queue >= queue_limit:
                model_shed += 1
                assert p.done() and p.result().status == "shed"
            else:
                model_queue += 1
        else:
            n = server.drain_once(block=False)
            assert n == min(model_queue, max_batch)
            model_queue -= n
        assert server.pending <= queue_limit
    while server.drain_once(block=False):
        pass
    st = server.stats()
    assert st["submitted"] == len(pending) and st["shed"] == model_shed
    assert st["served"] + st["shed"] == len(pending)
    assert st["max_depth"] <= queue_limit
    for p, have in pending:
        rep = p.result(timeout=0)
        if rep.status == "shed":
            assert rep.retry_after_s > 0
            continue
        assert rep.round >= have
        if rep.round == have:
            assert rep.kind == "current"
        if rep.kind == "delta":
            assert rep.base_round == have and len(rep.payloads) <= max_lag
        base = served_trees.get(have)
        if rep.kind != "full" and base is None:
            continue
        tree = apply_reply(rep, base, codec=codec)
        if rep.kind != "current":
            assert _eq(tree, served_trees[rep.round])
    for p, _ in pending[:3]:
        with pytest.raises(RuntimeError, match="twice"):
            p._resolve(Reply(status="ok", kind="current", round=0))


@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_delta_chain_consistency_any_depth(codec):
    """Hop by hop, a vehicle lands bitwise on the server's reconstruction
    however long the chain (lossy codecs chain off the reconstruction)."""
    for hops in (1, 3, 6):
        store = ModelStore(codec=codec, window=hops + 2)
        for r in range(hops + 1):
            store.publish(r, _tree_at(r, seed=7))
        server = RSUServer(store, ServePolicy(max_lag=hops), start=False)
        p = server.submit(0)
        server.drain_once(block=False)
        rep = p.result(timeout=0)
        assert rep.kind == "delta" and len(rep.payloads) == hops
        assert _eq(apply_reply(rep, store.get(0).served_tree, codec=codec),
                   store.get(hops).served_tree)


# --------------------------------------------------------------------------
# the learner hook
# --------------------------------------------------------------------------

def test_eager_run_publish_hook_feeds_the_store():
    sc = _scenario(rounds=3)
    seen = []
    store = ModelStore(codec="delta_int8")
    state0 = sc.init_state()
    store.publish(state0.round, state0.global_tree)

    def publish(rnd, tree):
        seen.append(int(rnd))
        store.publish(rnd, tree)

    state, _ = run(sc, state0, publish=publish)
    assert seen == [1, 2, 3] and state.round == 3
    assert _eq(store.get(3).tree, state.global_tree)
    rep = build_reply(store, ServePolicy(max_lag=4), 0)
    assert rep.kind == "delta" and len(rep.payloads) == 3
    assert _eq(apply_reply(rep, store.get(0).served_tree, "delta_int8"),
               store.get(3).served_tree)
