"""The port's audio zoo family (SeamlessM4T: a non-causal encoder over
frame embeddings, tanh-gated cross-attention over its context, the ctx
cache and the frames input) against the JAX reference, on the CPU: the
config, the attention forms, the blocks, the model in its three modes,
the train step and the launchers.

The config is ``seamless-m4t-large-v2-smoke`` (2 encoder and 2 decoder
layers, d_model 256, 4 query heads and 2 KV heads of 64, d_ff 512 with
the tanh gelu, layernorm, frames 64 wide, vocab 1024 padded to 2048) in
float32. Inputs are numpy draws; the reference's weights are carried
into the port with `convert.zoo_params_from_numpy`.

The reference starts both gates of every cross block at 0, so tanh(0) =
0 keeps the context out of the logits: at the init parameters two
different frames inputs give bitwise equal logits, and the encoder and
the cross-attention get no gradient. A check at the init gates would
pass with a wrong or missing encoder. So every case but
`test_zero_gates_make_the_logits_independent_of_the_frames` (which pins
the init) gives the gates non-zero values drawn from a seed, the same in
both packages, and the layernorms' zero biases N(0, 0.1) noise
(`_gated`).

Tolerances, both sides float32, as tests/test_torch_dense.py and
tests/test_torch_moe.py state them for the same functions: TOL = 2e-5
absolute on outputs, logits, features and caches; gradients within
GRAD_REL of each gradient's largest magnitude; train steps at
tests/test_torch_train.py's LOSS_REL and LEAF_REL, the ``dt`` step
widened as tests/test_torch_dense_train.py widens it.

    PYTHONPATH=src python -m pytest tests/test_torch_audio.py
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
from repro_torch.configs.base import PORTED_FAMILIES, InputShape
from repro_torch.kernels import ref
from repro_torch.launch import decode as tdecode
from repro_torch.launch import steps as tst
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_round import torch_threads  # noqa: F401 (autouse)
from test_torch_train import (LEAF_REL, LOSS_REL, _blur, _leaf_err,
                              _ref_drops, _tree_errs, mesh)  # noqa: F401

ARCH = "seamless-m4t-large-v2"
TOL = 2e-5
GRAD_REL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _tok(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _max_abs(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _tokens(seed, b, s, vocab=1024):
    return np.random.RandomState(seed).randint(1, vocab, (b, s)).astype(
        np.int32)


def _frames(seed, b, s):
    """(B, max(S // 4, 8), d_audio) float32 frame embeddings."""
    jcfg, _ = _cfgs()
    shape = (b, jst.enc_ctx_len(jcfg, s), jcfg.d_audio)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _gated(np_tree, seed):
    """A copy of a numpy tree whose cross-block gates are drawn with
    |gate| in [0.3, 1.2] and random signs, and whose all-zero norm
    biases get N(0, 0.1) noise."""
    rs = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("gate_attn", "gate_mlp"):
                mag = rs.uniform(0.3, 1.2, v.shape)
                out[k] = (mag * rs.choice([-1.0, 1.0], v.shape)).astype(
                    v.dtype)
            elif k == "bias" and not np.any(v):
                out[k] = (rs.randn(*v.shape) * 0.1).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(np_tree)


@functools.cache
def _cfgs():
    return j_get_config(ARCH).reduced(), get_config(ARCH + "-smoke")


@functools.cache
def _narrow_cfgs():
    """The smoke configs with 2 query heads and 1 KV head of 16 (d 32),
    for the flash path at 2048 queries."""
    kw = dict(d_model=32, n_heads=2, n_kv_heads=1, head_dim=16)
    jcfg, tcfg = _cfgs()
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


@functools.cache
def _jforward(mode="train"):
    """The reference's forward, jitted once per mode in this module:
    (params, tokens, cache, positions, aux_inputs) -> (logits, cache)."""
    jcfg, _ = _cfgs()

    def fn(p, tokens, cache, positions, aux):
        logits, new_cache, _ = JT.forward(jcfg, p, tokens, mode=mode,
                                          cache=cache, positions=positions,
                                          aux_inputs=aux)
        return logits, new_cache
    return jax.jit(fn)


def _aux(frames):
    return {"frames": jnp.asarray(frames)}


@pytest.fixture(scope="module")
def init_model():
    """The reference's smoke params in numpy (its init jitted), as
    initialised: both gates 0."""
    jcfg, _ = _cfgs()
    init = jax.jit(JT.init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(init_model):
    """The smoke params with gates and norm biases drawn (`_gated`)."""
    return _gated(init_model, 0)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


# --------------------------------------------------------------------------
# the config and the init tree
# --------------------------------------------------------------------------

FIELDS = ("name", "family", "n_layers", "n_encoder_layers", "d_model",
          "n_heads", "n_kv_heads", "head_dim", "head_dim_", "d_ff",
          "vocab_size", "padded_vocab", "citation", "rope_theta",
          "qkv_bias", "sliding_window", "attn_logit_softcap",
          "final_logit_softcap", "attn_scale_override", "act", "gated_mlp",
          "d_audio", "norm", "post_norm", "norm_eps",
          "tie_embeddings", "embed_scale", "long_context_mode",
          "long_context_window")


@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_config_fields_match_reference(name):
    j, t = j_get_config(name), get_config(name)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert "audio" in PORTED_FAMILIES


@pytest.mark.parametrize("s", [4, 32, 33, 3008, 4096])
def test_ctx_len_and_frames_shape_match_reference(s):
    """max(S // 4, 8) context rows, d_audio wide, as the reference's
    `enc_ctx_len` and `_aux_shapes`."""
    for name in (ARCH, ARCH + "-smoke"):
        j, t = j_get_config(name), get_config(name)
        assert tst.enc_ctx_len(t, s) == jst.enc_ctx_len(j, s)
        assert tst.frames_shape(t, 3, s) == jst._aux_shapes(j, 3, s)[
            "frames"][0]
    assert tst.enc_ctx_len(get_config("tinyllama-1.1b"), s) == 0


def test_init_params_tree_matches_reference():
    """Keys, stacked shapes and dtypes equal the reference's in float32
    and bfloat16; each layer's gates are float32 0-d (stacked: (L,)
    float32) in a bfloat16 tree too, and start at 0."""
    jcfg, tcfg = _cfgs()
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
        for name in ("gate_attn", "gate_mlp"):
            gate = tp["cross_blocks"][name]
            assert gate.shape == (tcfg.n_layers,)
            assert gate.dtype == torch.float32 and not gate.any()
        assert tp["enc_blocks"]["mlp"]["w_up"].shape[0] == \
            tcfg.n_encoder_layers
        assert tp["audio_adapter"].shape == (tcfg.d_audio, tcfg.d_model)


def test_convert_round_trips_a_bfloat16_tree_with_float32_gates(model):
    """A bfloat16 reference tree with its float32 gates crosses to the
    port with every leaf's dtype and value kept, and back."""
    keep = ("gate_attn", "gate_mlp")
    np_p = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in keep
        else a.astype(jnp.bfloat16), model)
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    for name in keep:
        assert tp["cross_blocks"][name].dtype == torch.float32
    assert tp["cross_blocks"]["xattn"]["wq"].dtype == torch.bfloat16
    back = convert.zoo_params_to_numpy(tp)
    for (pa, a), (pb, b) in zip(convert.leaves_with_paths(back),
                                convert.leaves_with_paths(np_p)):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    # a single layer's 0-d gate too
    one = convert.zoo_params_from_numpy(_layer(model["cross_blocks"]),
                                        "cpu")
    assert one["gate_attn"].shape == () and float(one["gate_attn"]) == \
        float(model["cross_blocks"]["gate_attn"][0])


# --------------------------------------------------------------------------
# the attention forms
# --------------------------------------------------------------------------

def test_cross_attention_init_makes_no_biases():
    """With qkv_bias set, a self-attention block gets q, k, v biases and
    a cross block none, in both packages."""
    jcfg, tcfg = (dataclasses.replace(c, qkv_bias=True) for c in _cfgs())
    for cross in (False, True):
        jp = JL.init_attention(jcfg, jax.random.PRNGKey(0), cross=cross)
        tp = TL.init_attention(tcfg, torch.Generator().manual_seed(0),
                               cross=cross)
        assert sorted(tp) == sorted(jp)
        assert ("bq" in tp) == (not cross)


ATTN_CASES = {
    # (narrow config, B, Sq, Sk): Sk is the context's length (cross)
    "cross-direct": (False, 2, 24, 10),
    "noncausal-direct": (False, 2, 24, None),
    "cross-flash": (True, 1, 2048, 1024),       # queries 1, keys 0
    "noncausal-flash": (True, 1, 2048, None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_forms_match_reference(case):
    """`attention_block` with ``kv_src`` (cross-attention: k and v from the
    context, no RoPE, every query sees every row) and with
    ``causal=False`` (the encoder's self-attention, RoPE at 0..S-1),
    each on the direct path and on the flash path (2048 queries, keys a
    multiple of 1024; cross-attention there at query positions 1 and key
    positions 0): the output, and the gradients of <out, g> with respect
    to x, the context and every projection, against the reference's
    block and `jax.grad` of it."""
    narrow, b, sq, sk = ATTN_CASES[case]
    jcfg, tcfg = _narrow_cfgs() if narrow else _cfgs()
    cross = sk is not None
    jp = JL.init_attention(jcfg, jax.random.PRNGKey(3), cross=cross)
    rs = np.random.RandomState(len(case) + sq)
    x = rs.randn(b, sq, jcfg.d_model).astype(np.float32)
    src = (rs.randn(b, sk, jcfg.d_model).astype(np.float32) if cross
           else None)
    pos = np.broadcast_to(np.arange(sq), (b, sq)).astype(np.int32)
    g = rs.randn(b, sq, jcfg.d_model).astype(np.float32)
    kw = dict(kv_src=None, use_rope=False) if cross else dict(causal=False)

    def jloss(p, x, src):
        o, _ = JL.attention_block(jcfg, p, x, jnp.asarray(pos),
                                  **(dict(kw, kv_src=src) if cross else kw))
        return jnp.sum(o * g), o

    argnums = (0, 1, 2) if cross else (0, 1)
    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=argnums,
                                             has_aux=True))(jp, x, src)
    tp = convert.zoo_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    paths = convert.leaves_with_paths(tp)
    leaves = [t.requires_grad_() for _, t in paths]
    ins = [_t(x).requires_grad_()] + ([_t(src).requires_grad_()] if cross
                                      else [])
    to, cache = TL.attention_block(
        tcfg, convert.unflatten(leaves, tp), ins[0], _tok(pos),
        **(dict(kw, kv_src=ins[1]) if cross else kw))
    assert cache is None
    err = _max_abs(to.detach(), jo)
    grads = torch.autograd.grad((to * _t(g)).sum(), leaves + ins)
    want = dict(convert.leaves_with_paths(jax.tree.map(np.asarray, jg[0])))
    g_errs = [_leaf_err(got, want[path]) for (path, _), got in
              zip(paths, grads)]
    g_errs += [_leaf_err(got, w) for got, w in zip(grads[len(leaves):],
                                                    jg[1:])]
    print(f"attention {case}: max abs out {err:.2e}, gradients "
          f"{max(g_errs):.2e} of their max")
    assert err <= TOL and max(g_errs) <= GRAD_REL


def test_cross_attention_ignores_the_cache_and_positions():
    """Cross-attention reads no cache and returns none, and its output
    does not depend on the query positions (RoPE is off; every query
    sees every context row)."""
    _, tcfg = _cfgs()
    tp = TL.init_attention(tcfg, torch.Generator().manual_seed(1),
                           cross=True)
    rs = np.random.RandomState(2)
    x, src = _t(rs.randn(2, 5, 256).astype(np.float32)), \
        _t(rs.randn(2, 7, 256).astype(np.float32))
    cache = TL.make_cache(tcfg, 2, 16, torch.float32, n_layers=0)
    o1, c1 = TL.attention_block(tcfg, tp, x, torch.arange(5).expand(2, 5),
                                kv_src=src, use_rope=False, cache=cache)
    o2, c2 = TL.attention_block(tcfg, tp, x,
                                torch.arange(40, 45).expand(2, 5),
                                kv_src=src, use_rope=False)
    assert c1 is None and c2 is None and torch.equal(o1, o2)
    assert bool((cache["pos"] == -1).all())


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block", ["cross", "encoder"])
def test_blocks_match_reference(model, block):
    """`_cross_block` (gated cross-attention and MLP over a context of 9
    rows) and `_encoder_block` (non-causal self-attention and MLP) of
    the first layer, against the reference's."""
    jcfg, tcfg = _cfgs()
    rs = np.random.RandomState(11)
    x = rs.randn(2, 13, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(13), (2, 13)).astype(np.int32)
    if block == "cross":
        jp = _layer(model["cross_blocks"])
        assert float(jp["gate_attn"]) != 0 and float(jp["gate_mlp"]) != 0
        ctx = rs.randn(2, 9, jcfg.d_model).astype(np.float32)
        want = jax.jit(lambda p, x, c: JT._cross_block(
            jcfg, p, x, jnp.asarray(pos), c))(jp, x, ctx)
        got = TT._cross_block(tcfg, convert.zoo_params_from_numpy(jp, "cpu"),
                              _t(x), _tok(pos), _t(ctx))
    else:
        jp = _layer(model["enc_blocks"])
        want = jax.jit(lambda p, x: JT._encoder_block(
            jcfg, p, x, jnp.asarray(pos)))(jp, x)
        got = TT._encoder_block(tcfg, convert.zoo_params_from_numpy(
            jp, "cpu"), _t(x), _tok(pos))
    print(f"{block} block: max abs {_max_abs(got, want):.2e}")
    _close(got, want)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _logits_close(got, want, atol=TOL):
    v = _cfgs()[0].vocab_size
    _close(np.asarray(got)[..., :v], np.asarray(want)[..., :v], atol)


def _caches_close(tc, jc):
    for name, w in jc["kv"].items():
        if name == "pos":
            np.testing.assert_array_equal(tc["kv"][name].numpy(),
                                          np.asarray(w))
        else:
            _close(tc["kv"][name], w)
    assert tuple(tc["ctx"].shape) == np.asarray(jc["ctx"]).shape
    _close(tc["ctx"], jc["ctx"])


def test_zero_gates_make_the_logits_independent_of_the_frames(init_model):
    """At the init parameters (both gates 0) two different frames inputs
    give bitwise equal logits in each package, as the reference's: this
    pins the init, and is why every other case draws the gates. With
    the gates drawn the logits move."""
    jcfg, tcfg = _cfgs()
    toks = _tokens(20, 2, 24)
    f1, f2 = _frames(21, 2, 24), _frames(22, 2, 24)
    j1, _ = _jforward()(init_model, jnp.asarray(toks), None, None, _aux(f1))
    j2, _ = _jforward()(init_model, jnp.asarray(toks), None, None, _aux(f2))
    np.testing.assert_array_equal(np.asarray(j1), np.asarray(j2))
    tp = convert.zoo_params_from_numpy(init_model, "cpu")
    t1, _, _ = TT.forward(tcfg, tp, _tok(toks), aux_inputs={"frames": _t(f1)})
    t2, _, _ = TT.forward(tcfg, tp, _tok(toks), aux_inputs={"frames": _t(f2)})
    assert torch.equal(t1, t2)
    gp = convert.zoo_params_from_numpy(_gated(init_model, 0), "cpu")
    t1, _, _ = TT.forward(tcfg, gp, _tok(toks), aux_inputs={"frames": _t(f1)})
    t2, _, _ = TT.forward(tcfg, gp, _tok(toks), aux_inputs={"frames": _t(f2)})
    v = tcfg.vocab_size
    assert float((t1 - t2)[..., :v].abs().max()) > 0.1


def test_forward_train_and_features_match_reference(model):
    """Logits of a 37-token train-mode forward with 9 frames, and the
    features, against the reference's."""
    jcfg, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    toks, fr = _tokens(9, 2, 37), _frames(10, 2, 37)
    want, _ = _jforward()(model, jnp.asarray(toks), None, None, _aux(fr))
    got, cache, aux = TT.forward(tcfg, tp, _tok(toks),
                                 aux_inputs={"frames": _t(fr)})
    assert got.shape == (2, 37, jcfg.padded_vocab) and cache is None
    assert float(aux) == 0.0
    print(f"forward: max abs logits "
          f"{_max_abs(got[..., :1024], np.asarray(want)[..., :1024]):.2e}")
    _logits_close(got, want)
    f_want, _ = jax.jit(lambda p, t, a: JT.forward_features(
        jcfg, p, t, aux_inputs=a))(model, jnp.asarray(toks), _aux(fr))
    f_got, _ = TT.forward_features(tcfg, tp, _tok(toks),
                                   aux_inputs={"frames": _t(fr)})
    _close(f_got, f_want)


def test_forward_without_frames_or_a_cache_raises(model):
    """The encoder needs frames and decode needs the cache's ctx: a
    train-mode call with neither raises a ValueError naming the input
    (the reference fails there too, on the missing cache)."""
    jcfg, tcfg = _cfgs()
    toks = _tokens(15, 1, 8)
    with pytest.raises(TypeError):
        JT.forward(jcfg, model, jnp.asarray(toks))
    with pytest.raises(ValueError, match=r"aux_inputs\['frames'\]"):
        TT.forward(tcfg, convert.zoo_params_from_numpy(model, "cpu"),
                   _tok(toks))


def test_prefill_and_decode_match_reference(model):
    """Prefill 20 positions with 8 frames into a cache of 24 slots whose
    ctx starts at enc_ctx_len(24) = 8 zero rows, then 3 decode steps
    that read the ctx from the cache, each from the reference's cache:
    logits and every cache leaf (the rings, positions bitwise, and the
    ctx)."""
    jcfg, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    b, s = 2, 20
    toks, fr = _tokens(16, b, s + 3), _frames(17, b, s)
    ctx_len = jst.enc_ctx_len(jcfg, s + 4)
    jcache = JT.init_cache(jcfg, b, s + 4, dtype=jnp.float32,
                           ctx_len=ctx_len)
    tcache = TT.init_cache(tcfg, b, s + 4, dtype=torch.float32, device="cpu",
                           ctx_len=tst.enc_ctx_len(tcfg, s + 4))
    assert set(tcache) == set(jcache) == {"kv", "ctx"}
    assert tuple(tcache["ctx"].shape) == jcache["ctx"].shape
    want, jcache = _jforward("prefill")(model, jnp.asarray(toks[:, :s]),
                                        jcache, None, _aux(fr))
    got, tcache, _ = TT.forward(tcfg, tp, _tok(toks[:, :s]), mode="prefill",
                                cache=tcache, aux_inputs={"frames": _t(fr)})
    _logits_close(got, want)
    _caches_close(tcache, jcache)
    for i in range(3):
        p = np.full((b,), s + i, np.int32)
        want, jnew = _jforward("decode")(
            model, jnp.asarray(toks[:, s + i:][:, :1]), jcache,
            jnp.asarray(p), None)
        got, tnew, _ = TT.forward(
            tcfg, tp, _tok(toks[:, s + i:][:, :1]), mode="decode",
            cache=convert.tree_map(_t, jax.tree.map(np.asarray, jcache)),
            positions=_tok(p))
        _logits_close(got, want)
        _caches_close(tnew, jnew)
        jcache = jnew


def test_prefill_without_frames_matches_reference(mesh, model):
    """`make_prefill_step` without frames: the cross blocks attend over
    the zero ctx of enc_ctx_len(total) rows, against the reference's
    prefill step on the one-device mesh: the last logits and the
    cache."""
    jcfg, tcfg = _cfgs()
    b, s, total = 2, 16, 40
    toks = _tokens(18, b, s)
    jfn = jst.make_prefill_step(jcfg, JShape("p", total, b, "prefill"),
                                mesh, param_dtype=jnp.float32)
    with compat.set_mesh(mesh):
        want, jcache = jax.jit(jfn)(model, {"tokens": jnp.asarray(toks)})
    tfn = tst.make_prefill_step(tcfg, InputShape("p", total, b, "prefill"),
                                param_dtype=torch.float32)
    got, tcache = tfn(convert.zoo_params_from_numpy(model, "cpu"),
                      {"tokens": _tok(toks)})
    assert tcache["ctx"].shape == (b, 10, tcfg.d_model)
    assert not tcache["ctx"].any()
    _logits_close(got, want)
    _caches_close(tcache, jcache)


def test_decode_after_prefill_equals_a_full_forward(model):
    """Greedy decode through launch/decode.py's functions with frames:
    the prefill's pick and each step's equal the full forward's with the
    same frames at the same position, the logits within TOL."""
    _, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    prompts, fr = _tok(_tokens(13, 2, 20)), _t(_frames(14, 2, 20))
    last, cache, _ = tdecode.run_prefill(tcfg, tp, prompts, 24,
                                         torch.float32, frames=fr)
    toks, cache, _ = tdecode.run_decode(tcfg, tp, last, cache, 20, 3)
    full, _, _ = TT.forward(tcfg, tp, torch.cat([prompts, toks[:, :3]], 1),
                            aux_inputs={"frames": fr})
    _logits_close(last, full[:, 19].numpy())
    for i in range(4):
        assert torch.equal(toks[:, i],
                           tdecode.greedy(tcfg, full[:, 19 + i])[:, 0])


# --------------------------------------------------------------------------
# the train step and the launchers
# --------------------------------------------------------------------------

MOVED = (("enc_blocks", "attn", "wq"), ("enc_blocks", "mlp", "w_up"),
         ("cross_blocks", "xattn", "wq"), ("cross_blocks", "xattn", "wk"),
         ("audio_adapter",))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float64)


@pytest.mark.parametrize("objective,b,s,n_micro", [("lm", 4, 24, 2),
                                                   ("dt", 8, 16, 2)])
def test_train_step_matches_reference(mesh, model, objective, b, s,
                                      n_micro):
    """One `make_train_step` step (flsimco, sgdm) with frames split into
    the micro-batches with the tokens, against the reference's from the
    reference's params: the loss, then every parameter and momentum
    leaf. The encoder's, the adapter's and the cross-attention's
    gradients (the momentum less weight decay's share) are non-zero in
    both packages."""
    jcfg, tcfg = _cfgs()
    kw = dict(objective=objective, n_micro=n_micro)
    jfn, _ = jst.make_train_step(jcfg, JShape("t", s, b, "train"), mesh,
                                 **kw)
    tfn, _ = tst.make_train_step(tcfg, InputShape("t", s, b, "train"), **kw)
    toks, fr = _tokens(s + b, b, s), _frames(s + b + 1, b, s)
    blur = _blur(s, b)
    with compat.set_mesh(mesh):
        jp, jm, jmet = jax.jit(jfn)(model, jst.init_momentum(model),
                                    {"tokens": jnp.asarray(toks),
                                     "blur": jnp.asarray(blur),
                                     "frames": jnp.asarray(fr)})
    tp0 = convert.zoo_params_from_numpy(model, "cpu")
    batch = {"tokens": _tok(toks), "blur": torch.from_numpy(blur),
             "frames": _t(fr)}
    widen = 0.0
    if objective == "dt":
        batch["drops"] = _ref_drops(b // n_micro, s, n_micro)
        widen = _dt_widening(tcfg, tp0, batch, n_micro)
    tp, tm, tmet = tfn(tp0, tst.init_momentum(tp0), batch)
    want = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - want) <= (LOSS_REL + widen) * abs(want)
    for name, tree, ref_tree in (("params", tp, jp), ("momentum", tm, jm)):
        errs = _tree_errs(tree, ref_tree)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= LEAF_REL + widen, (name, worst, errs[worst],
                                                 widen)
    tm_np = convert.tree_to_numpy(tm)
    for path in MOVED:
        wd = 5e-4 * _leaf(model, path)
        for m in (tm_np, jm):
            g = np.abs(_leaf(m, path) - wd).max()
            assert g > 1e-6, (path, g)


def _dt_widening(tcfg, tp, batch, n_micro) -> float:
    """tests/test_torch_dense_train.py's `_dt_widening`, each view's
    features reading its micro-batch's frames: 2^-24 / tau_a / min(w_a)
    (tau_a = 0.1), w_a = 1 - p_a(pos) from the port's own features."""
    w_min = 1.0
    with torch.no_grad():
        for toks, d, fr in zip(batch["tokens"].chunk(n_micro),
                               batch["drops"].chunk(n_micro, dim=1),
                               batch["frames"].chunk(n_micro)):
            q, k = (TT.forward_features(
                tcfg, tp, torch.where(m, tst.MASK_TOKEN, toks),
                aux_inputs={"frames": fr})[0] for m in d)
            _, lse_a, _, pos = ref.dt_loss_fwd_ref(q, k, 0.1, 1.0)
            w_min = min(w_min, float((1 - torch.exp(pos / 0.1 - lse_a))
                                     .min()))
    return 2.0 ** -24 / 0.1 / w_min


def test_decode_launcher_reduced_on_cpu(capsys):
    tdecode.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                  "--tokens", "3", "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert re.search(rf"{ARCH}-smoke on cpu: prefill 2x12 in [\d.]+ ms", out), \
        out


@pytest.mark.parametrize("objective", ["lm", "dt"])
def test_train_launcher_reduced_on_cpu(capsys, objective):
    ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                 "1", "--seq-len", "16", "--objective", objective,
                 "--batch", "8"])
    out = capsys.readouterr().out
    assert re.search(rf"train {ARCH}-smoke on cpu: 8 x 16 tokens a step",
                     out), out
    losses = re.findall(r"step (\d): loss=([-\d.]+) \(", out)
    assert [s for s, _ in losses] == ["0"], out
    assert all(np.isfinite(float(v)) for _, v in losses)
