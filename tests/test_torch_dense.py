"""The port's dense zoo family (GQA attention with RoPE, softcaps,
local/global windows, ring-buffer and int8 KV caches) against the JAX
reference, on the CPU: the layers, the model in its three modes, and the
serve steps.

The configs are the four dense ``-smoke`` configs (2 layers, d_model
<= 256, 4 query heads and 2 KV heads of 64, d_ff <= 512, vocab <= 1024;
gemma2's sliding window 32 and every long-context window 64) in float32.
Inputs are numpy draws; the reference's weights are carried into the
port with `convert.zoo_params_from_numpy`, after the zero-initialised
leaves (qwen2's q/k/v biases, the norms' scales) get small numpy noise,
so the biases and norms are exercised too.

Tolerances, both sides float32: TOL = 2e-5 absolute on attention outputs,
RoPE and MLPs (sums of 64-256 products in other orders, values of order
1), and on logits (values of order 1-10 after two layers; 6e-6 is the
largest seen). Masks and cache positions are bitwise. The int8 cache:
the two frameworks' k and v differ by float32 rounding, so a code whose
value sits at a rounding boundary may land one step apart; codes are
held within one step (and at most INT8_FLIP_SHARE of them apart), the
scales at TOL relative, and logits computed from such caches within
INT8_LOGIT_TOL (a flipped code moves one k or v element by its row's
absmax / 127).

    PYTHONPATH=src python -m pytest tests/test_torch_dense.py
"""
from __future__ import annotations

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import decode as tdecode
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_round import torch_threads  # noqa: F401 (autouse)

TOL = 2e-5
INT8_LOGIT_TOL = 1e-2
INT8_FLIP_SHARE = 0.01
ARCHS = ("tinyllama-1.1b", "qwen2-0.5b", "gemma2-27b", "deepseek-67b")


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


def _noised(np_tree, seed):
    """The zero-initialised leaves (biases, norm scales) given N(0, 0.1)
    numpy noise, so both sides read nonzero values."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in np_tree.items():
        if isinstance(v, dict):
            out[k] = _noised(v, seed + 1 + len(out))
        elif k in ("bq", "bk", "bv", "scale") and not np.any(v):
            out[k] = (rs.randn(*v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


@functools.cache
def _jforward(jcfg, mode="train", long_context=False):
    """The reference's forward, jitted once per (config, mode) in this
    module: (params, tokens, cache, positions) -> (logits, cache)."""
    def fn(p, tokens, cache, positions):
        logits, new_cache, _ = JT.forward(jcfg, p, tokens, mode=mode,
                                          cache=cache, positions=positions,
                                          long_context=long_context)
        return logits, new_cache
    return jax.jit(fn)


@functools.cache
def _jblock(jcfg, window):
    """The reference's attention_block, jitted once per (config, window)."""
    return jax.jit(lambda p, x, pos, cache: JL.attention_block(
        jcfg, p, x, pos, window=window, cache=cache))


@pytest.fixture(scope="module")
def models():
    """arch -> (reference smoke cfg, port smoke cfg, numpy params)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = j_get_config(arch).reduced()
        np_p = _noised(jax.tree.map(np.asarray, JT.init_params(
            jcfg, jax.random.PRNGKey(i))), i)
        out[arch] = (jcfg, get_config(arch + "-smoke"), np_p)
    return out


# --------------------------------------------------------------------------
# configs, windows, cache geometry
# --------------------------------------------------------------------------

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "head_dim_", "d_ff", "vocab_size", "padded_vocab",
          "citation", "rope_theta", "qkv_bias", "sliding_window",
          "local_global_period", "attn_logit_softcap", "final_logit_softcap",
          "attn_scale_override", "act", "gated_mlp", "norm", "post_norm",
          "norm_eps", "tie_embeddings", "embed_scale", "long_context_mode",
          "long_context_window")


@pytest.mark.parametrize("name", [a + s for a in ARCHS for s in ("", "-smoke")])
def test_config_fields_match_reference(name):
    j, t = j_get_config(name), get_config(name)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("long_context", [False, True])
def test_layer_windows_and_cache_width_match_reference(arch, long_context):
    for name in (arch, arch + "-smoke"):
        j, t = j_get_config(name), get_config(name)
        assert TT.layer_windows(t, 5, long_context) == \
            np.asarray(JT.layer_windows(j, 5, long_context)).tolist()
        for s in (1, 32, 100, 5000, 524_288):
            assert TT.cache_width(t, s, long_context) == \
                JT.cache_width(j, s, long_context), s


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Keys, stacked shapes and dtypes of the port's init equal the
    reference's, in float32 and bfloat16."""
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch + "-smoke")
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


# --------------------------------------------------------------------------
# leaf functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    rs = np.random.RandomState(int(theta) % 97)
    x = rs.randn(2, 33, 3, 64).astype(np.float32)
    pos = rs.randint(0, 4096, (2, 33)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(TL.apply_rope(_t(x), _tok(pos), theta), want)
    # bfloat16 in, bfloat16 out: rotated in float32, then one rounding
    xb = _t(x).to(torch.bfloat16)
    got = TL.apply_rope(xb, _tok(pos), theta)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        TL.apply_rope(xb.float(), _tok(pos), theta).numpy(), rtol=2.0 ** -8,
        atol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [JL.BIG_WINDOW, 5])
def test_build_mask_and_softcap_match_reference(causal, window):
    rs = np.random.RandomState(3)
    q_pos = rs.randint(0, 20, (2, 7)).astype(np.int32)
    kv_pos = rs.randint(-1, 20, (2, 11)).astype(np.int32)   # -1: empty slot
    want = JL._build_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                          causal=causal, window=window)
    got = TL._build_mask(_tok(q_pos), _t(kv_pos), causal=causal,
                         window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = rs.randn(4, 9).astype(np.float32) * 80
    for cap in (0.0, 50.0):
        _close(TL._softcap(_t(s), cap), JL._softcap(jnp.asarray(s), cap),
               1e-4)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_attn_direct_matches_reference(softcap):
    """GQA grouping (h = kh * G + g), masked slots and a fully masked row
    (which the reference turns into the mean of v: softmax of NEG_INF
    everywhere)."""
    rs = np.random.RandomState(4)
    q = rs.randn(2, 5, 2, 3, 16).astype(np.float32)
    k = rs.randn(2, 9, 2, 16).astype(np.float32)
    v = rs.randn(2, 9, 2, 16).astype(np.float32)
    mask = rs.rand(2, 5, 9) > 0.3
    mask[1, 2] = False
    want = JL._attn_direct(*(jnp.asarray(a) for a in (q, k, v, mask)),
                           scale=0.25, softcap=softcap)
    got = TL._attn_direct(_t(q), _t(k), _t(v), _t(mask), scale=0.25,
                          softcap=softcap)
    _close(got, want)


@pytest.mark.parametrize("sq,sk,window,softcap", [
    (37, 37, JL.BIG_WINDOW, 0.0),           # direct
    (2048, 2048, JL.BIG_WINDOW, 0.0),       # flash, two chunks
    (2048, 3072, 700, 50.0),                # flash over a longer cache
])
def test_attention_core_matches_reference_on_both_paths(sq, sk, window,
                                                        softcap):
    rs = np.random.RandomState(sq + sk)
    q = rs.randn(1, sq, 4, 64).astype(np.float32)
    k = rs.randn(1, sk, 2, 64).astype(np.float32)
    v = rs.randn(1, sk, 2, 64).astype(np.float32)
    q_pos = (np.arange(sq) + (sk - sq))[None].astype(np.int32)
    kv_pos = np.arange(sk)[None].astype(np.int32)
    kv_pos[0, -5:] = -1                     # empty slots
    args = (q, k, v, q_pos, kv_pos)
    want = JL.attention_core(*(jnp.asarray(a) for a in args), window=window,
                             softcap=softcap)
    got = TL.attention_core(*(_t(a) for a in args), window=window,
                            softcap=softcap)
    assert got.shape == (1, sq, 4, 64)
    _close(got, want)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
def test_mlp_block_matches_reference(models, act, gated):
    import dataclasses
    jcfg, tcfg, _ = models["tinyllama-1.1b"]
    jcfg = dataclasses.replace(jcfg, act=act, gated_mlp=gated)
    tcfg = dataclasses.replace(tcfg, act=act, gated_mlp=gated)
    jp = jax.tree.map(np.asarray, JL.init_mlp(jcfg, jax.random.PRNGKey(1)))
    assert ("w_gate" in jp) == gated
    x = np.random.RandomState(5).randn(2, 7, jcfg.d_model).astype(np.float32)
    want = JL.mlp_block(jcfg, jp, jnp.asarray(x))
    got = TL.mlp_block(tcfg, convert.zoo_params_from_numpy(jp, "cpu"), _t(x))
    _close(got, want)


def test_quantize_kv_matches_reference():
    """Bitwise on the same input: absmax / 127 scales, round half to even
    (exact ties included), clipped to +-127; an all-zero row keeps the
    1e-8 floor."""
    rs = np.random.RandomState(6)
    x = rs.randn(3, 5, 16).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, :4] = np.array([127.0, 0.5, 1.5, -2.5], np.float32)  # ties
    jq, js = JL._quantize_kv(jnp.asarray(x))
    tq, ts = TL._quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TL._dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(JL._dequantize_kv(jq, js, jnp.float32)))


# --------------------------------------------------------------------------
# the attention block and its caches
# --------------------------------------------------------------------------

def _block_params(models, arch):
    jcfg, tcfg, np_p = models[arch]
    attn = jax.tree.map(lambda a: a[0], np_p["blocks"]["attn"])
    return jcfg, tcfg, attn, convert.zoo_params_from_numpy(attn, "cpu")


def _cache_np(tcache):
    return {k: v.numpy() for k, v in tcache.items()}


def _assert_cache(tcache, jcache, exact_codes=True):
    assert set(tcache) == set(jcache)
    for name, want in jcache.items():
        got, want = tcache[name].numpy(), np.asarray(want)
        assert got.dtype == want.dtype, name
        if name == "pos":
            np.testing.assert_array_equal(got, want)
        elif got.dtype == np.int8 and not exact_codes:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and diff.mean() <= INT8_FLIP_SHARE, name
        elif name.endswith("_scale"):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
        else:
            _close(got, want)


@pytest.mark.parametrize("arch,cache_dtype,window", [
    ("qwen2-0.5b", "float32", None),        # qkv bias, GQA
    ("gemma2-27b", "float32", 32),          # softcap, scale, local window
    ("tinyllama-1.1b", "int8", None),
    ("gemma2-27b", "int8", 6),
])
def test_attention_block_ring_buffer_matches_reference(models, arch,
                                                       cache_dtype, window):
    """A prefill of 12 positions into a ring of W = 16, then 9 decode
    steps that wrap it (positions 12..20 into slots 12..15, 0..4), each
    from the reference's own cache, so each step's output and new cache
    are held on their own."""
    jcfg, tcfg, jp, tp = _block_params(models, arch)
    rs = np.random.RandomState(7)
    b, w, s0 = 2, 16, 12
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jcache = JL.make_cache(jcfg, b, w, jdt, n_layers=0)
    tcache = TL.make_cache(tcfg, b, w, tdt, n_layers=0)
    _assert_cache(tcache, jcache)
    pos = np.broadcast_to(np.arange(s0, dtype=np.int32), (b, s0))
    for step in range(10):
        n = s0 if step == 0 else 1
        x = rs.randn(b, n, jcfg.d_model).astype(np.float32)
        jo, jnew = _jblock(jcfg, window)(jp, jnp.asarray(x),
                                         jnp.asarray(pos), jcache)
        to, tnew = TL.attention_block(
            tcfg, tp, _t(x), _tok(pos), window=window,
            cache={k: _t(v) for k, v in jcache.items()})
        _close(to, jo)
        _assert_cache(tnew, jnew, exact_codes=cache_dtype != "int8")
        jcache = jnew
        pos = pos[:, -1:] + 1
    assert int(np.asarray(jcache["pos"]).max()) == s0 + 8   # wrapped


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_prefill_longer_than_the_ring_keeps_the_latest(models, cache_dtype,
                                                       monkeypatch):
    """Sq = 20 positions into W = 8 slots: each slot holds the latest
    position that maps to it (12..19 in slots 4..7, 0..3), as the
    reference's scatter leaves it on the CPU; and every write names each
    slot of a row once (a scatter with repeated indices keeps no order
    on the card)."""
    writes = []
    put = torch.Tensor.index_put

    def recording(self, indices, values, accumulate=False):
        writes.append(indices[1])
        return put(self, indices, values, accumulate)

    monkeypatch.setattr(torch.Tensor, "index_put", recording)
    jcfg, tcfg, jp, tp = _block_params(models, "tinyllama-1.1b")
    b, w, s = 2, 8, 20
    x = np.random.RandomState(8).randn(b, s, jcfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jo, jnew = _jblock(jcfg, None)(
        jp, jnp.asarray(x), jnp.asarray(pos),
        JL.make_cache(jcfg, b, w, jdt, n_layers=0))
    to, tnew = TL.attention_block(tcfg, tp, _t(x), _tok(pos),
                                  cache=TL.make_cache(tcfg, b, w, tdt,
                                                      n_layers=0))
    np.testing.assert_array_equal(tnew["pos"][0].numpy(),
                                  [16, 17, 18, 19, 12, 13, 14, 15])
    assert writes and all(len(set(row.tolist())) == row.numel()
                          for slots in writes for row in slots)
    _assert_cache(tnew, jnew, exact_codes=cache_dtype != "int8")
    _close(to, jo, TOL if cache_dtype == "float32" else INT8_LOGIT_TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _logits_close(got, want, cfg, atol=TOL):
    _close(got[..., :cfg.vocab_size], np.asarray(want)[..., :cfg.vocab_size],
           atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_features_match_reference(models, arch):
    jcfg, tcfg, np_p = models[arch]
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    toks = _tokens(9, 2, 45)                  # past gemma2's window of 32
    want, _, aux = JT.forward(jcfg, np_p, jnp.asarray(toks))
    got, cache, t_aux = TT.forward(tcfg, tp, _tok(toks))
    assert got.shape == (2, 45, jcfg.padded_vocab) and cache is None
    _logits_close(got, want, jcfg)
    assert float(t_aux) == float(aux) == 0.0
    f_want, _ = JT.forward_features(jcfg, np_p, jnp.asarray(toks))
    f_got, _ = TT.forward_features(tcfg, tp, _tok(toks))
    _close(f_got, f_want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_prefill_and_decode_match_reference(models, arch, cache_dtype):
    """Prefill 40 positions into a 44-wide cache, then 2 decode steps,
    each from the reference's cache; with positions as (B,) starts."""
    jcfg, tcfg, np_p = models[arch]
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    b, s = 2, 40
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    exact = cache_dtype == "float32"
    toks = _tokens(10, b, s + 3)
    jcache = JT.init_cache(jcfg, b, s + 4, dtype=jdt)
    tcache = TT.init_cache(tcfg, b, s + 4, dtype=tdt, device="cpu")
    want, jcache = _jforward(jcfg, "prefill")(
        np_p, jnp.asarray(toks[:, :s]), jcache, None)
    got, tcache, _ = TT.forward(tcfg, tp, _tok(toks[:, :s]), mode="prefill",
                                cache=tcache)
    _logits_close(got, want, jcfg, TOL if exact else INT8_LOGIT_TOL)
    _assert_cache(tcache["kv"], jcache["kv"], exact_codes=exact)
    for i in range(2):
        p = np.full((b,), s + i, np.int32)
        want, jnew = _jforward(jcfg, "decode")(
            np_p, jnp.asarray(toks[:, s + i:][:, :1]), jcache,
            jnp.asarray(p))
        got, tnew, _ = TT.forward(
            tcfg, tp, _tok(toks[:, s + i:][:, :1]), mode="decode",
            cache={"kv": {k: _t(v) for k, v in jcache["kv"].items()}},
            positions=_tok(p))
        _logits_close(got, want, jcfg)
        _assert_cache(tnew["kv"], jnew["kv"], exact_codes=exact)
        jcache = jnew


def test_long_context_prefill_past_the_window_matches_reference(models):
    """gemma2 under long_context: every layer's window is 64, the cache
    width min(S, 64), so a prefill of 80 positions wraps its ring; then
    one decode step."""
    jcfg, tcfg, np_p = models["gemma2-27b"]
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    b, s = 2, 80
    toks = _tokens(11, b, s + 1)
    assert TT.cache_width(tcfg, s + 1, True) == 64
    jcache = JT.init_cache(jcfg, b, s + 1, jnp.float32, long_context=True)
    tcache = TT.init_cache(tcfg, b, s + 1, torch.float32, "cpu",
                           long_context=True)
    want, jcache = _jforward(jcfg, "prefill", True)(
        np_p, jnp.asarray(toks[:, :s]), jcache, None)
    got, tcache, _ = TT.forward(tcfg, tp, _tok(toks[:, :s]), mode="prefill",
                                cache=tcache, long_context=True)
    _logits_close(got, want, jcfg)
    _assert_cache(tcache["kv"], jcache["kv"])
    p = np.full((b,), s, np.int32)
    want, _ = _jforward(jcfg, "decode", True)(
        np_p, jnp.asarray(toks[:, s:]), jcache, jnp.asarray(p))
    got, _, _ = TT.forward(tcfg, tp, _tok(toks[:, s:]), mode="decode",
                           cache=tcache, positions=_tok(p),
                           long_context=True)
    _logits_close(got, want, jcfg)


# --------------------------------------------------------------------------
# serve steps and the driver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape_name", [("qwen2-0.5b", "prefill"),
                                             ("gemma2-27b", "long_500k")])
def test_serve_steps_match_the_reference_forward(models, arch, shape_name):
    """`make_prefill_step` (head on the last position only) and
    `make_decode_step` against the reference's forward; ``long_500k``
    sets long_context, as the reference's steps do."""
    jcfg, tcfg, np_p = models[arch]
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    b, s, total = 2, 70, 72
    long_ctx = shape_name == "long_500k"
    shape = InputShape(shape_name, total, b, "prefill")
    toks = _tokens(12, b, s + 1)
    last, tcache = tsteps.make_prefill_step(tcfg, shape, torch.float32)(
        tp, {"tokens": _tok(toks[:, :s])})
    jcache = JT.init_cache(jcfg, b, total, jnp.float32,
                           long_context=long_ctx)
    want, jcache = _jforward(jcfg, "prefill", long_ctx)(
        np_p, jnp.asarray(toks[:, :s]), jcache, None)
    assert last.shape == (b, jcfg.padded_vocab)
    _logits_close(last, np.asarray(want)[:, -1], jcfg)
    assert tcache["kv"]["k"].shape[2] == (64 if long_ctx else total)
    logits, _ = tsteps.make_decode_step(tcfg, shape)(
        tp, {"tokens": _tok(toks[:, s:]), "cache": tcache,
             "positions": torch.full((b,), s)})
    want, _ = _jforward(jcfg, "decode", long_ctx)(
        np_p, jnp.asarray(toks[:, s:]), jcache,
        jnp.full((b,), s, jnp.int32))
    _logits_close(logits, np.asarray(want)[:, 0], jcfg)


def test_decode_after_prefill_equals_a_full_forward(models):
    """Greedy decode through launch/decode.py's functions: each step's
    logits equal the full forward's at that position (tinyllama-smoke,
    float32, within TOL)."""
    _, tcfg, np_p = models["tinyllama-1.1b"]
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    prompts = _tok(_tokens(13, 2, 20))
    last, cache, _ = tdecode.run_prefill(tcfg, tp, prompts, 24,
                                         torch.float32)
    toks, _, _ = tdecode.run_decode(tcfg, tp, last, cache, 20, 3)
    full, _, _ = TT.forward(tcfg, tp, torch.cat([prompts, toks[:, :3]], 1))
    assert torch.equal(toks[:, 0], tdecode.greedy(tcfg, full[:, 19])[:, 0])
    for i in range(1, 4):
        assert torch.equal(toks[:, i],
                           tdecode.greedy(tcfg, full[:, 19 + i])[:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_launcher_reduced_on_cpu(capsys, arch):
    tdecode.main(["--arch", arch, "--reduced", "--device", "cpu",
                  "--tokens", "3"])
    out = capsys.readouterr().out
    assert re.search(rf"{arch}-smoke on cpu: prefill 2x32 in [\d.]+ ms", out), \
        out
