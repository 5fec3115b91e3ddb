"""The port's checkpoints (repro_torch.checkpoint.store, FLState.to_tree /
from_tree) against the reference's, on the CPU.

The cases of tests/test_checkpoint.py run against the port; then the two
packages read each other's files: a file the reference's `save_state`
wrote restores in the port bitwise in every leaf (with the generator
state given explicitly: the file holds a jax key), and a file the port
wrote restores through the reference's structural `restore` bitwise, and
runs a reference round once a jax key is added. The fingerprints of one
Scenario are equal in both packages, and a port run paused at round 2,
saved, restored and continued is bitwise equal to a straight one.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core import aggregation as jagg
from repro.core.scenario import Scenario as JScenario
from repro.core.scenario import run_round as j_run_round
from repro.core.state import FLState as JFLState
from repro.core.state import pack_host_rng as j_pack
from repro.core.state import unpack_host_rng as j_unpack
from repro_torch import convert
from repro_torch.checkpoint.store import (_leaves, latest, restore,
                                          restore_state, save, save_state,
                                          _scenario_fingerprint)
from repro_torch.core.scenario import Scenario, run
from test_torch_round import torch_threads  # noqa: F401 (autouse)

KW = dict(n_vehicles=6, vehicles_per_round=3, batch_size=8, rounds=4,
          data=[np.random.RandomState(i).rand(12, 16, 16, 3)
                .astype(np.float32) for i in range(6)])
HANDOVER = dict(topology="handover",
                topology_kwargs=dict(n_rsus=2, rsu_range=100.0,
                                     sync_every=2))
CASES = {"single": {}, "handover": HANDOVER,
         "fedco": dict(aggregator="fedco", queue_len=64),
         "delta_int8": dict(codec="delta_int8")}


def _np(x):
    """A leaf as numpy; a bfloat16 tensor as its raw 16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    return np.asarray(x)


def _assert_bitwise(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _assert_leaves_bitwise(t1, t2):
    l1, l2 = _leaves(t1), _leaves(t2)
    assert len(l1) == len(l2)
    for a, b in zip(l1, l2):
        _assert_bitwise(a, b)


# --------------------------------------------------------------------------
# the reference's cases (tests/test_checkpoint.py) against the port
# --------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn((4, 5), generator=g),
                       "b": torch.zeros(5, dtype=torch.bfloat16)},
            "opt": [torch.ones(3), {"count": np.int32(7)}]}
    path = os.path.join(tmp_path, "ckpt_10.npz")
    save(path, 10, tree)
    step, restored = restore(path, tree)
    assert step == 10
    _assert_leaves_bitwise(tree, restored)
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert isinstance(restored["params"]["w"], torch.Tensor)


def test_latest_pointer(tmp_path):
    tree = {"x": torch.arange(3)}
    save(os.path.join(tmp_path, "c1.npz"), 1, tree)
    save(os.path.join(tmp_path, "c2.npz"), 2, tree)
    path, step = latest(str(tmp_path))
    assert step == 2 and path.endswith("c2.npz")
    assert latest(os.path.join(tmp_path, "none")) is None


def test_shape_mismatch_raises(tmp_path):
    p = os.path.join(tmp_path, "c.npz")
    save(p, 0, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(p, {"x": torch.zeros(4)})


def test_structural_restore_needs_no_example_tree(tmp_path):
    """The stored spec rebuilds dict/list/tuple/None nesting exactly,
    bfloat16 leaves and exact int64/float64 scalars included."""
    tree = {"params": {"w": torch.randn((4, 5),
                                        generator=torch.Generator()),
                       "b": (torch.full((3,), 2.5, dtype=torch.bfloat16),
                             np.int32(7))},
            "none_field": None,
            "counters": [np.int64(2**40 + 3), np.float64(1e-300)]}
    p = os.path.join(tmp_path, "structural.npz")
    save(p, 4, tree)
    step, restored = restore(p)
    assert step == 4
    assert isinstance(restored, dict)
    assert isinstance(restored["params"]["b"], tuple)
    assert restored["none_field"] is None
    assert isinstance(restored["counters"], list)
    assert restored["params"]["b"][0].dtype == torch.bfloat16
    assert int(restored["counters"][0]) == 2**40 + 3
    assert float(restored["counters"][1]) == 1e-300
    _assert_leaves_bitwise(tree, restored)


def test_flstate_roundtrip_with_bf16_and_fedco_queue(tmp_path):
    """A whole FLState: bfloat16 model leaves, FedCo's key tree and
    queue, the host RNG and the round round-trip structurally."""
    sc = Scenario(client="fedco", aggregator="fedavg", device="cpu",
                  queue_len=32, seed=9, **KW)
    state = sc.init_state()
    tree = dict(state.global_tree)
    tree["extra_bf16"] = torch.arange(6).to(torch.bfloat16)
    state = state.replace(global_tree=tree)
    p = save_state(os.path.join(tmp_path, "flstate.npz"), state)
    restored = restore_state(p, device="cpu")
    assert restored.round == state.round == 0
    assert restored.global_tree["extra_bf16"].dtype == torch.bfloat16
    assert set(restored.client_state) == {"key_tree", "queue"}
    _assert_leaves_bitwise(state.to_tree(), restored.to_tree())


def test_restore_state_rejects_mismatched_scenario(tmp_path):
    sc_a = Scenario(device="cpu", **KW)
    state = sc_a.init_state()
    p = save_state(os.path.join(tmp_path, "fp.npz"), state, scenario=sc_a)
    restore_state(p, scenario=sc_a)
    sc_b = Scenario(aggregator="fedavg", device="cpu", **KW)
    with pytest.raises(ValueError, match="aggregator"):
        restore_state(p, scenario=sc_b)
    restore_state(p, device="cpu")          # no scenario: no check
    p2 = save_state(os.path.join(tmp_path, "nofp.npz"), state)
    restore_state(p2, scenario=sc_b)        # no sidecar: no check


def test_restore_without_spec_requires_like(tmp_path):
    tree = {"x": torch.arange(4)}
    p = os.path.join(tmp_path, "old.npz")
    save(p, 1, tree)
    z = dict(np.load(p))
    z.pop("__spec__")
    np.savez(p, **z)
    with pytest.raises(ValueError, match="structural"):
        restore(p)
    step, restored = restore(p, tree)
    assert step == 1
    np.testing.assert_array_equal(restored["x"].numpy(), np.arange(4))


# --------------------------------------------------------------------------
# across the two packages
# --------------------------------------------------------------------------

def _busy_reference_state(case):
    """A reference FLState whose every field holds distinct values: a host
    RNG with a cached gaussian, round 3, and the topology's, FedCo's and
    the codec's state filled with random numbers of their dtypes."""
    jsc = JScenario(**CASES[case], **KW)
    st = jsc.init_state()
    rs = np.random.RandomState(1)

    def noisy(tree):
        return jax.tree.map(lambda a: np.asarray(
            a + rs.randn(*np.shape(a)).astype(np.float32)), tree)

    host = j_unpack(st.host_rng)
    host.rand(7)
    host.randn()                        # leaves a cached gaussian
    st = st.replace(global_tree=noisy(st.global_tree),
                    host_rng=j_pack(host), round=3)
    topo = dict(st.topo)
    if topo:
        topo.update(rsu_models=tuple(noisy(t) for t in topo["rsu_models"]),
                    blur_sum=rs.rand(2) * 20.0,
                    upload_count=np.array([3.0, 4.0]))
        st = st.replace(topo=topo)
    if st.client_state is not None:
        st = st.replace(client_state={
            "key_tree": noisy(st.client_state["key_tree"]),
            "queue": noisy(st.client_state["queue"])})
    if st.comms is not None:        # distinct values, cheaply
        ef = np.asarray(st.comms["ef"])
        st = st.replace(comms={"ef": (np.arange(ef.size, dtype=np.float32)
                                      .reshape(ef.shape) * 1e-7)})
    return jsc, st


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_file_restores_in_port_bitwise(case, tmp_path):
    _, jstate = _busy_reference_state(case)
    p = jstore.save_state(os.path.join(tmp_path, "ref.npz"), jstate)
    with pytest.raises(ValueError, match="gen_state"):
        restore_state(p, device="cpu")
    gen_state = torch.Generator().manual_seed(5).get_state()
    st = restore_state(p, device="cpu", gen_state=gen_state)
    assert torch.equal(st.gen_state, gen_state)
    assert st.round == jstate.round
    want = jstate.to_tree()
    got = st.to_tree()
    for k in ("global_tree", "host_rng", "round", "topo", "client_state",
              "comms"):
        _assert_leaves_bitwise(got[k], want[k])
    assert st.host_rng["has_gauss"] == 1
    if case == "handover":
        assert isinstance(st.topo["positions"], np.ndarray)
        assert isinstance(st.topo["rsu_models"], tuple)
        assert st.topo["positions"].dtype == np.float32
        assert st.topo["blur_sum"].dtype == np.float64
    if case == "fedco":
        assert isinstance(st.client_state["queue"], torch.Tensor)
    if case == "delta_int8":
        assert isinstance(st.comms["ef"], torch.Tensor)


def test_port_file_restores_in_reference_and_runs_a_round(tmp_path):
    """The port's handover state with delta_int8 (every kind of field)
    through the reference's structural restore, bitwise; with a jax key
    added, the reference runs a round from it. The state is the round-0
    one with distinct values in the error feedback and the sync
    statistics, and round 1."""
    sc = Scenario(device="cpu", codec="delta_int8", **HANDOVER, **KW)
    state = sc.init_state()
    ef = state.comms["ef"]
    state = state.replace(
        round=1, comms={"ef": torch.arange(ef.numel(), dtype=torch.float32)
                        .reshape(ef.shape) * 1e-7},
        topo=dict(state.topo, blur_sum=np.array([12.5, 30.25]),
                  upload_count=np.array([1.0, 2.0])))
    p = save_state(os.path.join(tmp_path, "port.npz"), state)
    step, tree = jstore.restore(p)
    assert step == 1
    _assert_leaves_bitwise(tree, state.to_tree())
    assert isinstance(tree["topo"]["rsu_models"], tuple)
    # the round runs without the codec stage, whose Pallas kernels take
    # minutes in interpret mode at this width
    tree["comms"] = None
    tree["key"] = jax.random.PRNGKey(0)
    jstate = JFLState.from_tree(tree)
    jsc = JScenario(**HANDOVER, **KW)
    with jagg.wagg_backend("interpret"):
        jnext, rec = j_run_round(jstate, jsc, parallel=False)
    assert rec["round"] == 1 and jnext.round == 2
    assert np.isfinite(rec["loss"])
    assert all(bool(jnp.isfinite(x).all())
               for x in jax.tree.leaves(jnext.global_tree))


@pytest.mark.parametrize("kw", [
    {}, dict(topology="multi", topology_kwargs={"n_rsus": 3}),
    dict(topology="multi", topology_kwargs={"n_rsus": 2,
                                            "count_scaled": False}),
    HANDOVER, dict(HANDOVER, topology_kwargs={"bucketed": False}),
    dict(aggregator="fedco"), dict(codec="delta_int8", lr=0.5)])
def test_fingerprints_equal_across_packages(kw, tmp_path):
    """The same Scenario stamps the same fingerprint in both packages,
    so a checkpoint of either refuses another experiment in the other."""
    sc, jsc = Scenario(device="cpu", **kw, **KW), JScenario(**kw, **KW)
    assert _scenario_fingerprint(sc) == jstore._scenario_fingerprint(jsc)
    p = jstore.save_state(os.path.join(tmp_path, "fp.npz"),
                          jsc.init_state(), scenario=jsc)
    gen_state = torch.Generator().get_state()
    restore_state(p, scenario=sc, gen_state=gen_state)
    other = Scenario(device="cpu", **kw, **dict(KW, batch_size=16))
    with pytest.raises(ValueError, match="batch_size"):
        restore_state(p, scenario=other, gen_state=gen_state)


@pytest.mark.parametrize("case", ["single", "handover_delta_int8", "fedco"])
def test_resume_at_round_two_is_bitwise(case, tmp_path):
    """The port's form of examples/resume.py: 4 rounds straight, with
    the state saved at round 2, against save_state + restore_state + the
    last 2 rounds again: equal bitwise in every leaf of the final state
    and in every record. (`run` is a loop of pure rounds, so 2 + 2
    rounds from the state in memory are the straight run.)"""
    kw = {"single": {}, "fedco": CASES["fedco"],
          "handover_delta_int8": dict(HANDOVER, codec="delta_int8")}[case]
    sc = Scenario(device="cpu", **kw, **KW)
    mid, hist_a = run(sc, rounds=2)
    p = save_state(os.path.join(tmp_path, f"ckpt_{mid.round}.npz"), mid,
                   scenario=sc)
    straight, hist_b = run(sc, mid, rounds=2)
    assert latest(str(tmp_path)) == (p, 2)
    resumed, hist_c = run(sc, restore_state(p, scenario=sc), rounds=2)
    assert hist_c == hist_b and [h["round"] for h in hist_a + hist_c] == \
        [0, 1, 2, 3]
    _assert_leaves_bitwise(straight.to_tree(), resumed.to_tree())
    assert convert.ravel(straight.global_tree).shape[0] > 0
