"""The FL drivers (`repro_torch.examples`), each called in-process through
its ``main([... "--device", "cpu"])`` at a small size, its own checks
passing; and what they share with the reference's scripts of
`examples/`.

* quickstart: the dataset, the partition, and the host MT19937 cohort
  ids and batch indices of each round bitwise the reference's planning
  functions' for the same Scenario; the printed Eq.-11 weights within
  WEIGHT_TOL of the reference's `flsimco_weights` of the same velocities.
* campaign and resume (every topology): bitwise on the CPU.
* train_federated_ssl: a run stopped after its round-2 checkpoint
  (``--ckpt-every 1``) and resumed (``--resume``) to round 4 ends bitwise
  the straight 4-round run; its checkpoint reads in the reference's
  `restore_state`, the fingerprint checked against the reference's
  Scenario; ``--preset paper`` sets Table 1 under explicit flags.
* serve_campaign: every fetch resolves, every decoded tree bitwise a
  published snapshot. serve_batched: its tokens equal
  `launch/decode.py`'s greedy tokens for the same params and prompts.
* Every driver raises without ``--device`` where there is no card.

The rounds run on an eighth-width ResNet-18 (the widths patched, as
tests/torch_sharded_ranks.py's model): the drivers build their model
from the config, and a full-width client step costs about a second on
one CPU thread. About 30-60 s in one process.

    PYTHONPATH=src python -m pytest tests/test_torch_examples.py
"""
from __future__ import annotations

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core import aggregation as jagg
from repro.core import topology as jtopo
from repro.core.mobility import MobilityModel as JMobilityModel
from repro.core.scenario import Scenario as JScenario
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core import topology as ttopo
from repro_torch.core.state import generator_from, unpack_host_rng
from repro_torch.data.synthetic import (make_dataset, partition_dirichlet,
                                        partition_iid)
from repro_torch.examples import (campaign, handover, mobility_ablation,
                                  quickstart, resume, serve_batched,
                                  serve_campaign, train_federated_ssl)
from repro_torch.launch import decode
from repro_torch.models import resnet
from test_torch_round import torch_threads  # noqa: F401 (autouse)

# the weights are float32 Eq.-11 arithmetic in both packages on the same
# float32 velocities: a few float32 ULPs of values near 0.25
WEIGHT_TOL = 1e-6
CPU = ["--device", "cpu"]
DRIVERS = {"quickstart": quickstart, "handover": handover,
           "campaign": campaign, "resume": resume,
           "mobility_ablation": mobility_ablation,
           "train_federated_ssl": train_federated_ssl,
           "serve_campaign": serve_campaign, "serve_batched": serve_batched}
# train_federated_ssl at a small size (IID unless a test adds --noniid)
SSL_SMALL = ["--vehicles", "4", "--per-round", "2", "--batch", "8",
             "--n-per-class", "10", *CPU]


@pytest.fixture(autouse=True)
def narrow():
    with mock.patch.object(resnet, "WIDTHS", (8, 16, 32, 64)):
        yield


def test_quickstart_plan_and_weights_match_reference():
    out = quickstart.main(CPU)
    sc = quickstart.scenario("cpu")
    jsc = JScenario(topology="single", aggregator="flsimco", client="dtssl",
                    partitioner="dirichlet", alpha=0.1, n_per_class=60,
                    min_per_client=40, n_vehicles=8, vehicles_per_round=4,
                    batch_size=32, rounds=2, local_iters=1, lr=0.5)
    for a, b in zip(sc.dataset, jsc.dataset):
        np.testing.assert_array_equal(a, b)
    assert len(sc.data) == len(jsc.data) == out["vehicles"] == 8
    for a, b in zip(sc.data, jsc.data):
        np.testing.assert_array_equal(a, b)
    assert out["images"] == len(jsc.dataset[0])
    # each round's plan from the round-0 streams, both packages
    state, jstate = sc.init_state(), jsc.init_state()
    rng_t, gen = unpack_host_rng(state.host_rng), generator_from(
        state.gen_state)
    rng_j, key = unpack_host_rng(jstate.host_rng), jstate.key
    for rnd, printed in enumerate(out["rounds"]):
        plan = ttopo._cohort_plan(rng_t, gen, rnd, sc)
        ids, _, _, key, _ = jtopo._cohort_plan(rng_j, key, rnd, jsc)
        np.testing.assert_array_equal(plan.ids, ids)
        for got, c in zip(plan.batch_idx, ids):
            np.testing.assert_array_equal(
                got, jtopo._batch_indices(rng_j, len(jsc.data[c]), jsc.cfg))
        # the driver's round drew exactly this plan
        np.testing.assert_array_equal(plan.velocities.numpy(),
                                      np.float32(printed["velocities"]))
        v = np.float32(printed["velocities"])
        want = np.asarray(jagg.flsimco_weights(JMobilityModel().blur_level(v)))
        np.testing.assert_allclose(printed["weights"], want, rtol=0,
                                   atol=WEIGHT_TOL)
        assert np.isfinite(printed["loss"])
    np.testing.assert_array_equal(rng_t.get_state()[1], rng_j.get_state()[1])
    assert rng_t.get_state()[2] == rng_j.get_state()[2]


def test_handover_driver():
    out = handover.main(CPU)
    assert [r["round"] for r in out["rounds"]] == list(range(6))
    assert [r["synced"] for r in out["rounds"]] == [False, False, True] * 2
    assert all(sum(r["rsu_sizes"]) == 4 for r in out["rounds"])
    assert out["handovers"] == sum(r["n_handovers"] for r in out["rounds"])
    assert out["view_params"] == sum(
        x.numel() for _, x in convert.leaves_with_paths(
            resnet.init_resnet(get_config("resnet18-cifar"),
                               torch.Generator().manual_seed(0), "cpu")))
    assert all(np.isfinite(r["loss"]) for r in out["rounds"])


def test_campaign_driver_is_bitwise_on_cpu():
    out = campaign.main(["--rounds", "4", *CPU])
    assert out["bitwise"] and out["chunk_gaps"] == [0.0, 0.0]
    assert out["compile_counts"] == {"graph": 0}
    assert out["rounds"] == 4


@pytest.mark.parametrize("topology", ["single", "multi", "handover"])
def test_resume_driver_is_bitwise_on_cpu(topology):
    out = resume.main(["--topology", topology, *CPU])
    assert out["bitwise"] and out["restored_bitwise"]
    assert out["max_abs"] == 0.0 and len(out["losses"]) == 4


def test_resume_driver_rejects_save_outside_rounds():
    with pytest.raises(SystemExit):
        resume.main(["--rounds", "2", "--save-at", "2", *CPU])


def test_mobility_ablation_driver():
    out = mobility_ablation.main(["--rounds", "2", "--vehicles", "4",
                                  "--n-per-class", "10", *CPU])
    assert sorted(out) == list(mobility_ablation.MUS)
    fracs = [out[mu]["frac_blurred"] for mu in mobility_ablation.MUS]
    assert fracs == sorted(fracs) and fracs[0] < 0.5 < fracs[-1]
    for row in out.values():
        assert 0 < row["weight_min"] <= 0.2 <= row["weight_max"] < 1
        for agg in ("flsimco", "fedavg"):
            assert len(row[agg]["losses"]) == 2
            assert np.isfinite(row[agg]["grad_std"])


def _final(path) -> list:
    return store._leaves(store.restore(path)[1])


class _Stopped(Exception):
    pass


def test_train_federated_ssl_resume_is_bitwise(tmp_path):
    """A run killed right after its round-2 checkpoint, then started
    again with --resume, ends bitwise the straight 4-round run (the
    final checkpoint leaf for leaf, and the probe)."""
    straight = train_federated_ssl.main(
        ["--rounds", "4", "--noniid", "--ckpt-dir", str(tmp_path / "a"),
         *SSL_SMALL])

    def stop_at_2(path, state, scenario=None):
        p = store.save_state(path, state, scenario=scenario)
        if state.round == 2:
            raise _Stopped
        return p

    args = ["--rounds", "4", "--noniid", "--ckpt-dir", str(tmp_path / "b"),
            "--ckpt-every", "1", *SSL_SMALL]
    with mock.patch.object(train_federated_ssl, "save_state", stop_at_2), \
            pytest.raises(_Stopped):
        train_federated_ssl.main(args)
    assert store.latest(str(tmp_path / "b"))[1] == 2
    resumed = train_federated_ssl.main(args + ["--resume"])
    assert resumed["round"] == straight["round"] == 4
    assert resumed["losses"] == straight["losses"][2:]
    assert resumed["top1"] == straight["top1"]
    a, b = _final(straight["checkpoint"]), _final(resumed["checkpoint"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_train_federated_ssl_checkpoint_reads_in_reference(tmp_path):
    """The driver's checkpoint through the reference's restore_state,
    its fingerprint checked against the reference's Scenario (the port's
    file holds gen_state where the reference's holds a jax key: one is
    added to the restored tree, as tests/test_torch_checkpoint.py does);
    runs no reference round."""
    out = train_federated_ssl.main(
        ["--rounds", "2", "--ckpt-dir", str(tmp_path), *SSL_SMALL])
    x, y = make_dataset(n_per_class=10, seed=0)
    split = int(0.85 * len(x))
    data = [x[:split][p] for p in partition_iid(y[:split], 4)]
    jsc = JScenario(topology="single", aggregator="flsimco", data=data,
                    n_vehicles=4, vehicles_per_round=2, batch_size=8,
                    rounds=2, local_iters=1, lr=0.5)
    restore = jstore.restore

    def keyed(path, like=None):
        step, tree = restore(path)
        tree["key"] = jax.random.PRNGKey(0)
        return step, tree

    with mock.patch.object(jstore, "restore", keyed):
        jstate = jstore.restore_state(out["checkpoint"], scenario=jsc)
        with pytest.raises(ValueError, match="different experiment"):
            jstore.restore_state(out["checkpoint"], scenario=JScenario(
                data=data, n_vehicles=4, vehicles_per_round=2,
                batch_size=8, rounds=3, local_iters=1, lr=0.5))
    st = store.restore_state(out["checkpoint"], device="cpu")
    assert jstate.round == st.round == 2
    got = convert.leaves_with_paths(jax.tree.map(np.asarray,
                                                 jstate.global_tree))
    want = convert.leaves_with_paths(convert.tree_to_numpy(st.global_tree))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    for k in st.host_rng:
        np.testing.assert_array_equal(jstate.host_rng[k], st.host_rng[k])


def test_train_federated_ssl_paper_preset_under_explicit_flags():
    a = train_federated_ssl.parse(["--preset", "paper", "--noniid",
                                   "--rounds", "2"])
    assert (a.rounds, a.vehicles, a.per_round, a.batch, a.n_per_class,
            a.lr, a.noniid) == (2, 95, 5, 512, 5000, 0.9, True)
    a = train_federated_ssl.parse(["--preset", "paper"])
    assert a.rounds == 150
    a = train_federated_ssl.parse([])
    assert (a.rounds, a.vehicles, a.batch) == (8, 10, 64)


def test_train_federated_ssl_noniid_partition_is_the_scripts():
    """The Dirichlet split the driver makes (85% of the pool, at least
    min(520, N / vehicles) images a vehicle) is the reference script's."""
    from repro.data import synthetic as jdata
    x, y = make_dataset(n_per_class=10, seed=0)
    jx, jy = jdata.make_dataset(n_per_class=10, seed=0)
    np.testing.assert_array_equal(x, jx)
    split = int(0.85 * len(x))
    kw = dict(min_per_client=min(520, split // 4), seed=0)
    for a, b in zip(partition_dirichlet(y[:split], 4, 0.1, **kw),
                    jdata.partition_dirichlet(jy[:split], 4, 0.1, **kw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("codec", ["delta", "delta_int8"])
def test_serve_campaign_driver(codec):
    out = serve_campaign.main(["--codec", codec, "--fetchers", "3", *CPU])
    assert out["mismatches"] == 0 and out["lost"] == 0
    assert out["fetched"] >= 3 and out["final_round"] == 4
    assert out["server"]["submitted"] == (out["server"]["served"]
                                          + out["server"]["shed"])
    assert out["store"]["publishes"] == 5


@pytest.mark.parametrize("argv", [[], ["--arch", "rwkv6-1.6b",
                                       "--long-context"]])
def test_serve_batched_tokens_are_the_decode_drivers(argv):
    out = serve_batched.main(argv + ["--tokens", "6", *CPU])
    cfg = get_config(argv[1] if argv else "tinyllama-1.1b").reduced()
    params = decode.init_model(cfg, 0, torch.float32, "cpu")
    prompts = decode.random_prompts(cfg, 4, 32, 0, "cpu")
    last, cache, _ = decode.run_prefill(cfg, params, prompts, 38,
                                        torch.float32,
                                        long_context=bool(argv))
    toks, _, _ = decode.run_decode(cfg, params, last, cache, 32, 5,
                                   long_context=bool(argv))
    assert out["tokens"] == toks.tolist()
    assert np.array(out["tokens"]).shape == (4, 6)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_without_device_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        DRIVERS[name].main([])

