"""Module-by-module parity of the port (repro_torch) with the reference.

Same inputs (numpy seeds, or the reference's own draws replayed) go
through each reference function and its port on the CPU. Plus the
port's import hygiene (no jax, no `repro`) and its device rules.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import dt_loss as jdt
from repro.core import mobility as jmob
from repro.core import ssl as jssl
from repro.data import synthetic as jdata
from repro.models import resnet as jres
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import aggregation as tagg
from repro_torch.core import dt_loss as tdt
from repro_torch.core import mobility as tmob
from repro_torch.core import ssl as tssl
from repro_torch.core.scenario import Scenario
from repro_torch.core.state import FLConfig
from repro_torch.data import synthetic as tdata
from repro_torch.models import resnet as tres
from repro_torch.optim import optimizers as topt
from test_torch_round import replay_pi_draws
from test_torch_round import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
P_RESNET18 = 11_497_024 + 9_600


def _t(x):
    return torch.from_numpy(np.array(x))


class _Cfg:
    d_ff = 128


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_synthetic_data_and_partitions_bitwise():
    xj, yj = jdata.make_dataset(n_per_class=30, seed=3)
    xt, yt = tdata.make_dataset(n_per_class=30, seed=3)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    for a, b in zip(tdata.partition_iid(yt, 7, seed=1),
                    jdata.partition_iid(yj, 7, seed=1)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
            tdata.partition_dirichlet(yt, 6, 0.1, min_per_client=20, seed=2),
            jdata.partition_dirichlet(yj, 6, 0.1, min_per_client=20, seed=2)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# mobility
# --------------------------------------------------------------------------

def test_velocity_grid_bitwise_and_cdf_within_ulps():
    mj, mt = jmob.MobilityModel(), tmob.MobilityModel()
    grid, cdf = mt.grid_cdf()
    gj = np.asarray(jnp.linspace(mj.v_min, mj.v_max, 4097))
    np.testing.assert_array_equal(grid.numpy(), gj)
    cj = jnp.cumsum(mj.pdf(gj))
    cj = np.asarray(cj / cj[-1])
    # exp is not correctly rounded in either library: <= 1 ULP of the cdf
    np.testing.assert_array_max_ulp(cdf.numpy(), cj, maxulp=2)


def test_velocities_from_the_same_uniforms_bitwise():
    mj, mt = jmob.MobilityModel(), tmob.MobilityModel()
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, (100_000,)))
    np.testing.assert_array_equal(mt.sample(None, len(u), u=_t(u)).numpy(),
                                  np.asarray(mj.sample(key, len(u))))
    v = np.linspace(10, 50, 17).astype(np.float32)
    np.testing.assert_array_equal(mt.blur_level(_t(v)).numpy(),
                                  np.asarray(mj.blur_level(v)))
    assert tmob.BLUR_KMH_100 == jmob.BLUR_KMH_100


@pytest.mark.parametrize("v", [0.0, 16.67, 27.78, 33.3, 41.67, 80.0])
def test_motion_blur_matches_reference(v):
    np.testing.assert_array_equal(tmob.motion_blur_kernel(v).numpy(),
                                  np.asarray(jmob.motion_blur_kernel(v)))
    x = np.random.RandomState(int(v)).rand(3, 8, 12, 3).astype(np.float32)
    np.testing.assert_allclose(
        tmob.apply_motion_blur(_t(x), torch.tensor(v)).numpy(),
        np.asarray(jmob.apply_motion_blur(jnp.asarray(x), v)), atol=1e-6)


# --------------------------------------------------------------------------
# augmentations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pi1_pi2_match_reference_on_replayed_draws(seed):
    x = np.random.RandomState(seed).rand(16, 8, 8, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    d1, d2 = replay_pi_draws(key, 16)
    np.testing.assert_allclose(tssl.pi1(_t(x), d1).numpy(),
                               np.asarray(jssl.pi1(k1, jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(tssl.pi2(_t(x), d2).numpy(),
                               np.asarray(jssl.pi2(k2, jnp.asarray(x))),
                               atol=2e-6)


def test_draws_have_the_reference_shapes_and_rates():
    gen = torch.Generator().manual_seed(0)
    d1, d2 = tssl.draw_pi1(gen, 4000), tssl.draw_pi2(gen, 4000)
    assert d1["flip"].dtype == torch.bool and d1["flip"].shape == (4000,)
    assert d2["brightness"].shape == (4000, 1, 1, 1)
    assert d2["hue"].shape == (4000, 1, 1)
    for d, key, p in ((d1, "flip", 0.5), (d1, "gray", 0.2),
                      (d2, "apply", 0.8), (d2, "gray", 0.4)):
        assert abs(d[key].float().mean().item() - p) < 0.03
    assert 0.6 <= d2["contrast"].min() and d2["contrast"].max() <= 1.4
    assert -0.4 <= d2["hue"].min() and d2["hue"].max() <= 0.4


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

def _converted_resnet(seed=0):
    tj = jres.init_resnet(_Cfg(), jax.random.PRNGKey(seed))
    return tj, convert.tree_from_numpy(jax.tree.map(np.asarray, tj))


def test_tree_conversion_roundtrip_and_flat_layout():
    tj, tt = _converted_resnet()
    back = convert.tree_to_numpy(tt)
    for (pj, a), (pt, b) in zip(
            jax.tree_util.tree_leaves_with_path(tj),
            jax.tree_util.tree_leaves_with_path(back)):
        assert pj == pt
        np.testing.assert_array_equal(np.asarray(a), b)
    flat_j = np.concatenate([np.asarray(l).reshape(-1)
                             for l in jax.tree.leaves(tj)])
    flat_t = convert.ravel(tt)
    assert flat_t.shape == (P_RESNET18,)
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    spec = convert.flat_spec(tt)
    again = convert.unravel(flat_t, spec)
    assert torch.equal(convert.ravel(again), flat_t)


def test_init_resnet_matches_reference_structure_and_scale():
    tj, _ = _converted_resnet()
    tt = tres.init_resnet(get_config("resnet18-cifar"),
                          torch.Generator().manual_seed(0), device="cpu")
    lj = jax.tree_util.tree_leaves_with_path(tj)
    lt = convert.leaves_with_paths(tt)
    assert len(lj) == len(lt)
    for (_, a), (_, b) in zip(lj, lt):
        assert tuple(a.shape) == tuple(b.shape)
    w = tt["params"]["s2b0"]["conv1"]                 # fan_in 3*3*128
    assert abs(w.std().item() - np.sqrt(2 / 1152)) < 0.02 * np.sqrt(2 / 1152)


def test_resnet_forward_state_and_grads_match_reference():
    tj, tt = _converted_resnet(1)
    rs = np.random.RandomState(3)
    x = rs.rand(4, 16, 16, 3).astype(np.float32)
    r = rs.randn(4, 128).astype(np.float32)
    zj, hj, nj = jres.resnet_apply(tj, jnp.asarray(x), train=True)
    zt, ht, nt = tres.resnet_apply(tt, _t(x), train=True)
    np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj), atol=5e-6)
    np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj),
                               atol=1e-4, rtol=1e-5)
    for a, b in zip(convert.leaves_with_paths(nt["state"]),
                    jax.tree.leaves(nj["state"])):
        np.testing.assert_allclose(a[1].numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    z_eval, _, ne = tres.resnet_apply(tt, _t(x), train=False)
    np.testing.assert_allclose(
        z_eval.numpy(),
        np.asarray(jres.resnet_apply(tj, jnp.asarray(x), train=False)[0]),
        atol=5e-6)
    for (_, a), (_, b) in zip(convert.leaves_with_paths(ne["state"]),
                              convert.leaves_with_paths(tt["state"])):
        assert a is b                      # eval mode keeps the BN state

    def loss_j(p):
        t = {"params": p, "state": tj["state"]}
        return jnp.sum(jres.resnet_apply(t, jnp.asarray(x))[0] * r)

    gj = jax.tree.leaves(jax.grad(loss_j)(tj["params"]))
    params = convert.tree_map(lambda t: t.clone().requires_grad_(),
                              tt["params"])
    zt, _, _ = tres.resnet_apply({"params": params, "state": tt["state"]},
                                 _t(x))
    leaves = [l for _, l in convert.leaves_with_paths(params)]
    gt = torch.autograd.grad((zt * _t(r)).sum(), leaves)
    # float32 reassociation, relative to each leaf's largest gradient (a
    # ReLU input within rounding of 0 could switch sides, see
    # test_torch_round.py; none does at this seed)
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-4 * max(1.0, np.abs(b).max()))


# --------------------------------------------------------------------------
# DT loss (plain)
# --------------------------------------------------------------------------

def test_plain_dt_losses_and_grads_match_reference():
    rs = np.random.RandomState(4)
    q, kp, kn = (rs.randn(*s).astype(np.float32)
                 for s in ((32, 16), (32, 16), (50, 16)))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    kp /= np.linalg.norm(kp, axis=-1, keepdims=True)
    kn /= np.linalg.norm(kn, axis=-1, keepdims=True)
    cases = [(jdt.dt_loss_matrix, tdt.dt_loss_matrix, (q, kp)),
             (jdt.dt_loss, tdt.dt_loss, (q, kp, kn)),
             (jdt.info_nce_loss, tdt.info_nce_loss, (q, kp, kn))]
    for fj, ft, args in cases:
        vj, gj = jax.value_and_grad(fj)(*map(jnp.asarray, args))
        a0 = _t(args[0]).requires_grad_()
        vt = ft(a0, *map(_t, args[1:]))
        (gt,) = torch.autograd.grad(vt, a0)
        np.testing.assert_allclose(float(vt), float(vj), rtol=1e-6)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)


# --------------------------------------------------------------------------
# optimizer + schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_bitwise(nesterov):
    rs = np.random.RandomState(int(nesterov))
    tree = {"a": rs.randn(5, 3).astype(np.float32),
            "b": {"c": rs.randn(7).astype(np.float32)}}
    grads = jax.tree.map(lambda x: rs.randn(*x.shape).astype(np.float32),
                         tree)
    ij, uj = jopt.sgd(0.9, 5e-4, nesterov)
    it, ut = topt.sgd(0.9, 5e-4, nesterov)
    pj, sj = tree, ij(tree)
    pt, st = convert.tree_from_numpy(tree), it(convert.tree_from_numpy(tree))
    lr = float(np.float32(0.37))
    for _ in range(3):   # momentum carries across steps
        pj, sj = uj(pj, grads, sj, jnp.float32(lr))
        pt, st = ut(pt, convert.tree_from_numpy(grads), st, lr)
    for a, b in zip(convert.leaves_with_paths(pt), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b))
    for a, b in zip(convert.leaves_with_paths(st.momentum),
                    jax.tree.leaves(sj.momentum)):
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b))


def _assert_lr_close(ft, fj, steps, amp):
    """Every other operation is the reference's, in float32; only cos may
    differ, by 1 ULP (neither library rounds it correctly). 1 + cos(pi t)
    cancels near the end of the schedule, so that ULP becomes up to
    amp * 2**-23 absolute (measured: 7 ULP of a small lr, 6e-8)."""
    got = np.array([ft(s) for s in steps], np.float32)
    want = np.array([fj(s) for s in steps], np.float32)
    bound = amp * 2.0 ** -23 + np.spacing(np.abs(want))
    assert (np.abs(got - want) <= bound).all()
    assert (got == want).mean() > 0.9


def test_cosine_lr_within_one_ulp_of_cos():
    _assert_lr_close(topt.cosine_schedule(0.9, 150),
                     jopt.cosine_schedule(0.9, 150), range(160), 0.45)
    _assert_lr_close(topt.cosine_schedule(0.5, 20, 0.01, 4),
                     jopt.cosine_schedule(0.5, 20, 0.01, 4), range(24), 0.245)
    assert topt.constant_schedule(0.1)(7) == float(np.float32(0.1))


# --------------------------------------------------------------------------
# aggregation weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5])
def test_all_five_scheme_weights_match_reference(n):
    rs = np.random.RandomState(n)
    blur = (rs.uniform(16.67, 41.67, n) * 0.58).astype(np.float32)
    cfg = FLConfig()
    for name in jagg.SCHEME_WEIGHTS:
        assert name in tagg.SCHEME_WEIGHTS

    class C:   # the only cohort fields the weight functions read
        valid_blur = blur
        flat = torch.empty(0)
    C.n = n
    for name, fj in jagg.SCHEME_WEIGHTS.items():
        wj = np.asarray(fj(C, cfg))
        wt = tagg.SCHEME_WEIGHTS[name](C, cfg)
        np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tagg.flsimco_weights(_t(blur), normalize=False).numpy(),
        np.asarray(jagg.flsimco_weights(blur, normalize=False)), rtol=1e-6)
    edge = np.array([0.0] * n, np.float32)
    np.testing.assert_array_equal(tagg.flsimco_weights(_t(edge)).numpy(),
                                  np.asarray(jagg.flsimco_weights(edge)))
    over = np.full(n, 100.0, np.float32)
    np.testing.assert_array_equal(
        tagg.discard_weights(_t(over), cfg.blur_threshold).numpy(),
        np.asarray(jagg.discard_weights(over, cfg.blur_threshold)))


@pytest.mark.parametrize("name", sorted(tagg.AGGREGATORS))
def test_padded_cohort_aggregates_bitwise_like_unpadded(name):
    from repro_torch.core.cohort import CohortBatch

    rs = np.random.RandomState(7)
    trees = [{"params": {"w": _t(rs.randn(3, 5).astype(np.float32))},
              "state": {"m": _t(rs.randn(4).astype(np.float32))}}
             for _ in range(3)]
    blur = _t((rs.uniform(16.67, 41.67, 3) * 0.58).astype(np.float32))
    spec = convert.flat_spec(trees[0])
    out = []
    for m in (3, 4):
        c = CohortBatch.empty(spec, m, n=3)
        for i in range(3):               # padding rows stay as allocated
            c.write(i, trees[i], 0.0)
        c = c.with_stats(velocities=blur / 0.58, blur=blur)
        out.append(convert.ravel(tagg.AGGREGATORS[name](c, FLConfig())))
    assert torch.equal(out[0], out[1])


# --------------------------------------------------------------------------
# package rules
# --------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.runtime, repro_torch.convert\n"
        "import repro_torch.core.scenario, repro_torch.core.topology\n"
        "import repro_torch.core.dt_loss, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.build, repro_torch.configs\n"
        "import repro_torch.data.synthetic, repro_torch.optim.optimizers\n"
        "import repro_torch.comms.codecs, repro_torch.serve\n"
        "import repro_torch.launch.serve, repro_torch.kernels.qdelta\n"
        "import repro_torch.models.transformer, repro_torch.models.layers\n"
        "import repro_torch.kernels.rwkv6, repro_torch.launch.decode\n"
        "import repro_torch.launch.steps, repro_torch.configs.rwkv6_1_6b\n"
        "import repro_torch.core.hierarchical, repro_torch.core.federation\n"
        "import repro_torch.eval.probe, repro_torch.trace_round\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.store\n"
        "import repro_torch.core.engine, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.core.collectives\n"
        "import repro_torch.launch.sharding, repro_torch.launch.dryrun\n"
        "import repro_torch.models.sharding_hooks\n"
        "import repro_torch.analysis.lint, repro_torch.analysis.guards\n"
        "import repro_torch.analysis.contracts\n"
        "import repro_torch.configs.tinyllama_1_1b\n"
        "import repro_torch.configs.qwen2_0_5b\n"
        "import repro_torch.configs.gemma2_27b\n"
        "import repro_torch.configs.deepseek_67b\n"
        "import repro_torch.configs.olmoe_1b_7b\n"
        "import repro_torch.configs.kimi_k2_1t_a32b\n"
        "import repro_torch.configs.hymba_1_5b\n"
        "import repro_torch.configs.seamless_m4t_large_v2\n"
        "import repro_torch.configs.llama_3_2_vision_90b\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.handover\n"
        "import repro_torch.examples.campaign\n"
        "import repro_torch.examples.resume\n"
        "import repro_torch.examples.mobility_ablation\n"
        "import repro_torch.examples.train_federated_ssl\n"
        "import repro_torch.examples.serve_campaign\n"
        "import repro_torch.examples.serve_batched\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert Scenario(data=[np.zeros((1, 4, 4, 3), np.float32)]) \
            .device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Scenario()


@pytest.mark.parametrize("kw", [
    dict(topology="multi", topology_kwargs={"mesh_aggregate": True}),
    dict(topology="handover", topology_kwargs={"mesh_shard": True}),
    dict(client="fedco"),
    dict(aggregator="fedco")])
def test_unported_choices_raise_not_implemented(kw):
    """The mesh options are ported (tests/test_torch_sharded.py) and raise
    no NotImplementedError: MultiRSU(mesh_aggregate=True) raises its
    actionable error on one rank (2 RSUs of the default 5 vehicles do
    not split evenly), the handover's opt-in mesh_shard runs the host
    path there; both FedCo spellings resolve as the reference's FLConfig
    does."""
    from repro.core.state import FLConfig as JFLConfig

    if kw.get("topology") == "multi":
        with pytest.raises(ValueError, match="mesh_aggregate needs equal"):
            Scenario(device="cpu", **kw)
        return
    if "topology_kwargs" in kw:
        assert Scenario(device="cpu", **kw).topology.mesh_shard
        return
    cfg = Scenario(device="cpu", **kw).cfg
    want = JFLConfig(**kw)
    assert (cfg.aggregator, cfg.client) == (want.aggregator, want.client)


@pytest.mark.parametrize("what", ["no-such-arch", "family:no-such"])
def test_unknown_archs_and_families_raise(what):
    """Every arch and family of the reference is ported: an unknown name
    raises KeyError from `get_config` and an unknown family ValueError
    from `init_params`, in both packages."""
    import dataclasses

    from repro.configs.base import get_config as j_get_config
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT

    if what.startswith("family:"):
        fam = what.split(":")[1]
        j_cfg = dataclasses.replace(j_get_config("rwkv6-1.6b-smoke"),
                                    family=fam)
        t_cfg = dataclasses.replace(get_config("rwkv6-1.6b-smoke"),
                                    family=fam)
        with pytest.raises(ValueError, match="unknown family"):
            JT.init_params(j_cfg, jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="unknown family"):
            TT.init_params(t_cfg, torch.Generator())
    else:
        with pytest.raises(KeyError):
            j_get_config(what)
        with pytest.raises(KeyError, match=what):
            get_config(what)


@pytest.mark.parametrize("codec", ["identity", "delta", "delta_int8"])
def test_every_codec_is_accepted(codec):
    from repro.comms.codecs import comms_init_state as j_comms_init_state
    from repro.core.state import FLConfig as JFLConfig

    sc = Scenario(device="cpu", codec=codec, vehicles_per_round=3,
                  data=[np.zeros((2, 4, 4, 3), np.float32)] * 4,
                  n_vehicles=4)
    comms = sc.init_state().comms
    tree = convert.tree_to_numpy(sc.init_tree())
    want = j_comms_init_state(JFLConfig(codec=codec, vehicles_per_round=3),
                              tree)
    if want is None:
        assert comms is None
    else:
        assert set(comms) == set(want) == {"ef"}
        assert tuple(comms["ef"].shape) == want["ef"].shape == \
            (3, -(-P_RESNET18 // 256) * 256)
        assert comms["ef"].dtype == torch.float32 and not comms["ef"].any()


def test_unknown_choices_raise_value_error():
    with pytest.raises(ValueError):
        Scenario(device="cpu", codec="gzip")
    with pytest.raises(ValueError):
        Scenario(device="cpu", aggregator="median")
    with pytest.raises(ValueError):
        Scenario(device="cpu", topology="ring")
    with pytest.raises(ValueError):
        Scenario(device="cpu", partitioner="shards")
