"""The port's MoE zoo family (sort-based capacity routing, shared experts,
leading dense layers, the Switch aux loss and its gradients) against the
JAX reference, on the CPU: the configs, the MoE layers, the model in its
three modes, the train step and the launchers.

The configs are the two MoE ``-smoke`` configs (2 layers, d_model 256, 4
query heads and 2 KV heads of 64, expert d_ff 512, 4 experts of which 2
are active, vocab 1024 padded to 2048; kimi-k2's keeps its shared expert
and its leading dense layer) in float32. Inputs are numpy draws; the
reference's weights are carried into the port with
`convert.zoo_params_from_numpy`, after the zero-initialised norm scales
get small numpy noise (tests/test_torch_dense.py's `_noised`).

Routing is discrete, so it is held bitwise: on the same float32 logits
the top-k indices, the stable sort's order, each assignment's slot and
the drop masks equal the reference's, at capacity factors 1.0 (some
assignments drop), 1.25 (the default) and 16 (none drop). Values, both
sides float32: TOL = 2e-5 absolute on MoE outputs, aux losses and
logits (sums of 256-512 products in other orders, values of order
1-10); gradients within GRAD_REL of each gradient's largest magnitude;
train steps at tests/test_torch_train.py's LOSS_REL and LEAF_REL, the
``dt`` step widened as tests/test_torch_dense_train.py widens it.

The card's check of `moe_block` against the CPU lives in
tests/test_torch_kernels.py, which imports no jax.

    PYTHONPATH=src python -m pytest tests/test_torch_moe.py
"""
from __future__ import annotations

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs.base import InputShape as JShape
from repro.configs.base import get_config as j_get_config
from repro.launch import steps as jst
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import decode as tdecode
from repro_torch.launch import steps as tst
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_dense import _noised
from test_torch_dense_train import _dt_widening
from test_torch_round import torch_threads  # noqa: F401 (autouse)
from test_torch_train import (LEAF_REL, LOSS_REL, _blur, _leaf_err,
                              _ref_drops, _tree_errs, mesh)  # noqa: F401

TOL = 2e-5
GRAD_REL = 1e-5
ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b")
FACTORS = (1.0, 1.25, 16.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tok(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _tokens(seed, b, s, vocab=1024):
    return np.random.RandomState(seed).randint(1, vocab, (b, s)).astype(
        np.int32)


def _cfgs(arch, factor=None):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch + "-smoke")
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=factor)
    return jcfg, tcfg


@functools.cache
def _jforward(jcfg, mode="train"):
    """The reference's forward, jitted once per (config, mode) in this
    module: (params, tokens, cache, positions) -> (logits, cache, aux)."""
    return jax.jit(lambda p, tokens, cache, positions: JT.forward(
        jcfg, p, tokens, mode=mode, cache=cache, positions=positions))


@functools.cache
def _jfeatures(jcfg):
    return jax.jit(lambda p, tokens: JT.forward_features(jcfg, p, tokens))


@functools.cache
def _jmoe(jcfg):
    """The reference's moe_block and dense oracle, jitted once a config."""
    return (jax.jit(lambda p, x: JL.moe_block(jcfg, p, x)),
            jax.jit(lambda p, x: JL.moe_block_dense_ref(jcfg, p, x)))


@pytest.fixture(scope="module")
def models():
    """arch -> numpy params of the reference's smoke config (its init
    jitted: eager, it takes seconds more)."""
    init = jax.jit(JT.init_params, static_argnums=0)
    return {arch: _noised(jax.tree.map(np.asarray, init(
        j_get_config(arch).reduced(), jax.random.PRNGKey(i))), i)
        for i, arch in enumerate(ARCHS)}


def _moe_params(models, arch):
    """The first MoE layer's numpy params."""
    return jax.tree.map(lambda a: a[0], models[arch]["blocks"]["moe"])


def _x(seed, d, b=2, s=24):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


# --------------------------------------------------------------------------
# configs and the init tree
# --------------------------------------------------------------------------

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "head_dim_", "d_ff", "vocab_size", "padded_vocab",
          "citation", "rope_theta", "qkv_bias", "sliding_window",
          "local_global_period", "attn_logit_softcap", "final_logit_softcap",
          "attn_scale_override", "act", "gated_mlp", "n_experts",
          "n_experts_active", "moe_capacity_factor", "router_aux_loss_coef",
          "moe_impl", "n_shared_experts", "moe_first_dense_layers", "is_moe",
          "norm", "post_norm", "norm_eps", "tie_embeddings", "embed_scale",
          "long_context_mode", "long_context_window")


@pytest.mark.parametrize("name", [a + s for a in ARCHS for s in ("", "-smoke")])
def test_config_fields_match_reference(name):
    j, t = j_get_config(name), get_config(name)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.is_moe


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Keys (``dense_blocks`` for kimi's leading dense layer, the shared
    expert), stacked shapes and dtypes equal the reference's in float32
    and bfloat16: the router stays float32 in a bfloat16 tree."""
    jcfg, tcfg = _cfgs(arch)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jp = jax.eval_shape(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(0), jdt))
        tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), tdt)
        jl = convert.leaves_with_paths(jax.tree.map(
            lambda a: (a.shape, str(a.dtype)), jp,
            is_leaf=lambda a: hasattr(a, "shape")))
        tl = convert.leaves_with_paths(convert.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            tp))
        assert tl == jl
        assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    assert ("dense_blocks" in tp) == (arch == "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_a_bfloat16_tree_with_a_float32_router(models, arch):
    """A bfloat16 reference tree with its float32 routers (and kimi's
    ``dense_blocks``) crosses to the port with every leaf's dtype and
    value kept, and back."""
    np_p = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key == "router"
        else a.astype(jnp.bfloat16), models[arch])
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"]["moe"]["w_up"].dtype == torch.bfloat16
    back = convert.zoo_params_to_numpy(tp)
    for (pa, a), (pb, b) in zip(convert.leaves_with_paths(back),
                                convert.leaves_with_paths(np_p)):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("factor,t,want", [(1.25, 48, 30), (1.0, 48, 24),
                                           (16.0, 48, 48), (1.25, 2, 2),
                                           (1.25, 5, 4), (2.0 / 3.0, 33, 11)])
def test_capacity_is_the_references_python_int(factor, t, want):
    """C = min(max(int(T k / E cf), 4), T), the reference's Python
    expression evaluated in the same order."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", factor)
    assert TL.moe_capacity(tcfg, t) == want
    ref_c = min(max(int(t * jcfg.n_experts_active / jcfg.n_experts
                        * jcfg.moe_capacity_factor), 4), t)
    assert ref_c == want


# --------------------------------------------------------------------------
# the MoE block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", FACTORS)
def test_dispatch_is_bitwise_the_references(models, arch, factor):
    """On the same float32 logits: top-k indices, the sort order, every
    assignment's slot and the drop mask bitwise; the capacity buffer,
    the gates and me/ce at TOL. Capacity factor 1.0 drops assignments,
    16 none."""
    jcfg, tcfg = _cfgs(arch, factor)
    jp = _moe_params(models, arch)
    xf = _x(1, jcfg.d_model).reshape(-1, jcfg.d_model)
    logits = np.asarray(jnp.asarray(xf) @ jp["router"])
    t = xf.shape[0]
    c = TL.moe_capacity(tcfg, t)
    jbuf, jse, jsc, jorder, jgate, (jme, jce) = JL._moe_dispatch_local(
        jcfg, jnp.asarray(xf), jnp.asarray(logits), c)
    tbuf, tse, tsc, torder, tgate, (tme, tce) = TL._moe_dispatch_local(
        tcfg, _t(xf), _t(logits), c)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                            jcfg.n_experts_active)
    _, _, tidx = TL.moe_route(tcfg, _t(logits))
    for got, want in ((tidx, jidx), (torder, jorder), (tse, jse),
                      (tsc, jsc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dropped = (tsc == c).numpy()
    np.testing.assert_array_equal(dropped, np.asarray(jsc) == c)
    assert dropped.any() == (factor == 1.0), int(dropped.sum())
    # only the overflow slot (0, c) takes more than one write
    kept = np.stack([tse.numpy(), tsc.numpy()], 1)[~dropped]
    assert len({tuple(r) for r in kept}) == len(kept)
    assert (tse.numpy()[dropped] == 0).all()
    _close(tbuf[:, :c], np.asarray(jbuf)[:, :c])
    _close(tgate, jgate)
    _close(tme, jme)
    np.testing.assert_array_equal(tce.numpy(), np.asarray(jce))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", FACTORS)
def test_moe_block_matches_reference(models, arch, factor):
    """Outputs and the aux loss at TOL, each side routing from its own
    router product; with no drops (factor 16) also equal to the dense
    every-expert oracle, the port's and the reference's."""
    jcfg, tcfg = _cfgs(arch, factor)
    jp = _moe_params(models, arch)
    tp = convert.zoo_params_from_numpy(jp, "cpu")
    x = _x(2, jcfg.d_model)
    jblock, jdense = _jmoe(jcfg)
    jy, jaux = jblock(jp, jnp.asarray(x))
    ty, taux = TL.moe_block(tcfg, tp, _t(x))
    assert ty.shape == x.shape and taux.dtype == torch.float32
    _close(ty, jy)
    _close(taux, jaux)
    if factor == 16.0:
        dense = TL.moe_block_dense_ref(tcfg, tp, _t(x))
        _close(dense, ty)
        _close(dense, jdense(jp, jnp.asarray(x)))


def test_moe_apply_runs_moe_block_for_every_impl(models):
    """On one device "auto", "scatter" and "ep" all run `moe_block`, as the
    reference's do without a ``model`` axis larger than 1; an unknown
    name is refused."""
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b")
    tp = convert.zoo_params_from_numpy(_moe_params(models,
                                                   "kimi-k2-1t-a32b"), "cpu")
    x = _t(_x(3, tcfg.d_model))
    want, want_aux = TL.moe_block(tcfg, tp, x)
    for impl in TL.MOE_IMPLS:
        cfg = dataclasses.replace(tcfg, moe_impl=impl)
        got, aux = TL.moe_apply(cfg, tp, x)
        assert torch.equal(got, want) and torch.equal(aux, want_aux), impl
    jy, _ = JL.moe_apply(dataclasses.replace(jcfg, moe_impl="ep"),
                         _moe_params(models, "kimi-k2-1t-a32b"),
                         jnp.asarray(x.numpy()))
    _close(want, jy)
    with pytest.raises(ValueError, match="moe_impl"):
        TL.moe_apply(dataclasses.replace(tcfg, moe_impl="shard"), tp, x)


@pytest.mark.parametrize("arch,factor", [("olmoe-1b-7b", 1.0),
                                         ("kimi-k2-1t-a32b", 1.25)])
def test_moe_block_gradients_match_jax_grad(models, arch, factor):
    """Gradients of <out, g> + aux with respect to x and every leaf
    (router through the gates and me; experts; the shared expert)
    against `jax.grad`; a dropped assignment passes no gradient to its
    token through its expert."""
    jcfg, tcfg = _cfgs(arch, factor)
    jp = _moe_params(models, arch)
    x = _x(4, jcfg.d_model)
    g = np.random.RandomState(5).randn(*x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JL.moe_block(jcfg, p, x)
        return jnp.sum(y * g) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = convert.zoo_params_from_numpy(jp, "cpu")
    paths = convert.leaves_with_paths(tp)
    leaves = [t.requires_grad_() for _, t in paths]
    tx = _t(x).requires_grad_()
    y, aux = TL.moe_block(tcfg, convert.unflatten(leaves, tp), tx)
    grads = torch.autograd.grad((y * _t(g)).sum() + aux, leaves + [tx])
    want = dict(convert.leaves_with_paths(jax.tree.map(np.asarray, jgp)))
    for (path, _), got in zip(paths, grads[:-1]):
        assert _leaf_err(got, want[path]) <= GRAD_REL, path
    assert _leaf_err(grads[-1], jgx) <= GRAD_REL


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _logits_close(got, want, cfg, atol=TOL):
    _close(got[..., :cfg.vocab_size], np.asarray(want)[..., :cfg.vocab_size],
           atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_features_match_reference(models, arch):
    """Logits and the summed aux loss of the MoE layers; the features and
    their aux."""
    jcfg, tcfg = _cfgs(arch)
    np_p = models[arch]
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    toks = _tokens(9, 2, 45)
    want, _, aux = _jforward(jcfg)(np_p, jnp.asarray(toks), None, None)
    got, cache, t_aux = TT.forward(tcfg, tp, _tok(toks))
    assert got.shape == (2, 45, jcfg.padded_vocab) and cache is None
    _logits_close(got, want, jcfg)
    assert float(t_aux) > 0.0
    _close(t_aux, aux)
    f_want, f_aux = _jfeatures(jcfg)(np_p, jnp.asarray(toks))
    f_got, tf_aux = TT.forward_features(tcfg, tp, _tok(toks))
    _close(f_got, f_want)
    _close(tf_aux, f_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(models, arch):
    """Prefill 40 positions into a 44-wide cache (``kv`` and, for kimi,
    ``kv_dense``), then 2 decode steps, each from the reference's cache:
    logits, aux and every cache leaf."""
    jcfg, tcfg = _cfgs(arch)
    np_p = models[arch]
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    b, s = 2, 40
    toks = _tokens(10, b, s + 2)
    jcache = JT.init_cache(jcfg, b, s + 4, dtype=jnp.float32)
    tcache = TT.init_cache(tcfg, b, s + 4, dtype=torch.float32, device="cpu")
    assert set(tcache) == set(jcache) == (
        {"kv", "kv_dense"} if arch == "kimi-k2-1t-a32b" else {"kv"})
    want, jcache, jaux = _jforward(jcfg, "prefill")(
        np_p, jnp.asarray(toks[:, :s]), jcache, None)
    got, tcache, taux = TT.forward(tcfg, tp, _tok(toks[:, :s]),
                                   mode="prefill", cache=tcache)
    _logits_close(got, want, jcfg)
    _close(taux, jaux)

    def caches_close(tc, jc):
        for key in jc:
            for name, w in jc[key].items():
                if name == "pos":
                    np.testing.assert_array_equal(tc[key][name].numpy(),
                                                  np.asarray(w))
                else:
                    _close(tc[key][name], w)

    caches_close(tcache, jcache)
    for i in range(2):
        p = np.full((b,), s + i, np.int32)
        want, jnew, jaux = _jforward(jcfg, "decode")(
            np_p, jnp.asarray(toks[:, s + i:][:, :1]), jcache, jnp.asarray(p))
        got, tnew, taux = TT.forward(
            tcfg, tp, _tok(toks[:, s + i:][:, :1]), mode="decode",
            cache=convert.tree_map(_t, jax.tree.map(np.asarray, jcache)),
            positions=_tok(p))
        _logits_close(got, want, jcfg)
        _close(taux, jaux)
        caches_close(tnew, jnew)
        jcache = jnew


def test_decode_after_prefill_equals_a_full_forward(models):
    """kimi-smoke (its dense and MoE stacks) through launch/decode.py's
    functions at capacity factor E / k, where nothing drops (C = T): the
    prefill's pick and each step's equal the full forward's greedy pick
    at the same position, and its logits within TOL."""
    _, tcfg = _cfgs("kimi-k2-1t-a32b")
    tcfg = dataclasses.replace(
        tcfg, moe_capacity_factor=tcfg.n_experts / tcfg.n_experts_active)
    tp = convert.zoo_params_from_numpy(models["kimi-k2-1t-a32b"], "cpu")
    prompts = _tok(_tokens(13, 2, 20))
    last, cache, _ = tdecode.run_prefill(tcfg, tp, prompts, 24,
                                         torch.float32)
    toks, _, _ = tdecode.run_decode(tcfg, tp, last, cache, 20, 3)
    full, _, _ = TT.forward(tcfg, tp, torch.cat([prompts, toks[:, :3]], 1))
    _logits_close(last, full[:, 19].numpy(), tcfg)
    for i in range(4):
        assert torch.equal(toks[:, i],
                           tdecode.greedy(tcfg, full[:, 19 + i])[:, 0])


# --------------------------------------------------------------------------
# the train step and the launchers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,objective,b,s,n_micro", [
    ("olmoe-1b-7b", "lm", 4, 24, 2),
    ("kimi-k2-1t-a32b", "dt", 8, 16, 1),
])
def test_train_step_matches_reference(mesh, models, arch, objective, b, s,
                                      n_micro):
    """One `make_train_step` step (flsimco, sgdm) against the reference's,
    from the reference's params: the loss with its aux terms, then every
    parameter and momentum leaf (the router's through the gates and the
    load-balance loss)."""
    jcfg, tcfg = _cfgs(arch)
    np_p = models[arch]
    kw = dict(objective=objective, n_micro=n_micro)
    jfn, _ = jst.make_train_step(jcfg, JShape("t", s, b, "train"), mesh,
                                 **kw)
    tfn, _ = tst.make_train_step(tcfg, InputShape("t", s, b, "train"), **kw)
    toks = np.random.RandomState(s + b).randint(1, jcfg.vocab_size,
                                                (b, s)).astype(np.int32)
    blur = _blur(s, b)
    with compat.set_mesh(mesh):
        jp, jm, jmet = jax.jit(jfn)(np_p, jst.init_momentum(np_p),
                                    {"tokens": jnp.asarray(toks),
                                     "blur": jnp.asarray(blur)})
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    batch = {"tokens": _tok(toks), "blur": torch.from_numpy(blur)}
    widen = 0.0
    if objective == "dt":
        batch["drops"] = _ref_drops(b // n_micro, s, n_micro)
        widen = _dt_widening(tcfg, tp, batch, n_micro)
    tp, tm, tmet = tfn(tp, tst.init_momentum(tp), batch)
    want = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - want) <= (LOSS_REL + widen) * abs(want)
    for name, tree, ref_tree in (("params", tp, jp), ("momentum", tm, jm)):
        errs = _tree_errs(tree, ref_tree)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= LEAF_REL + widen, (name, worst, errs[worst],
                                                 widen)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_launcher_reduced_on_cpu(capsys, arch):
    tdecode.main(["--arch", arch, "--reduced", "--device", "cpu",
                  "--tokens", "3", "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert re.search(rf"{arch}-smoke on cpu: prefill 2x12 in [\d.]+ ms", out), \
        out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_reduced_on_cpu(capsys, arch):
    ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                 "1", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert re.search(rf"train {arch}-smoke on cpu: 4 x 16 tokens a step",
                     out), out
    losses = re.findall(r"step (\d): loss=([-\d.]+) \(", out)
    assert [s for s, _ in losses] == ["0"], out
    assert all(np.isfinite(float(v)) for _, v in losses)
