"""The port's vlm zoo family (Llama-3.2-Vision: decoder blocks stacked
nested under super-layers, each closed by a tanh-gated cross block over
the projected patch embeddings, the patches input and the vision ctx
cache) against the JAX reference, on the CPU: the config, the init tree,
the model in its three modes, the train step and the launchers.

Two configs, both float32:

* ``llama-3.2-vision-90b-smoke``, the reference's `reduced()`: 2
  layers with a cross block every 2nd, so one super-layer of one
  decoder block and one cross block; d_model 256, 4 query heads and 2
  KV heads of 64, d_ff 512 with the gated silu, RMSNorm, 16 vision
  tokens 64 wide, vocab 1024 padded to 2048;
* NESTED, the same with n_layers 6 and a cross block every 3rd layer:
  2 super-layers of 2 decoder blocks, so ``blocks`` leaves are (2, 2,
  ...), ``cross_blocks`` (2, ...) and the cache's rings 4 layers
  (block j of super-layer s at s * 2 + j). `reduced()` has one of each
  and cannot show the order of the walk or of the flat cache index, so
  every case that walks the stack or the cache runs at NESTED.

Inputs are numpy draws; the reference's weights are carried into the
port with `convert.zoo_params_from_numpy`. The reference starts both
gates of every cross block at 0, which keeps the patches out of the
logits and of the gradients, so every case but
`test_zero_gates_make_the_logits_independent_of_the_patches` draws the
gates from a seed, the same in both packages (tests/test_torch_audio.py's
`_gated`).

Tolerances, as tests/test_torch_audio.py states them for the same
functions: TOL = 2e-5 absolute on logits, features and caches (cache
positions bitwise); train steps at tests/test_torch_train.py's LOSS_REL
and LEAF_REL, the ``dt`` step widened as tests/test_torch_dense_train.py
widens it.

    PYTHONPATH=src python -m pytest tests/test_torch_vlm.py
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
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import PORTED_FAMILIES, InputShape
from repro_torch.kernels import ref
from repro_torch.launch import decode as tdecode
from repro_torch.launch import steps as tst
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from test_torch_audio import _gated
from test_torch_round import torch_threads  # noqa: F401 (autouse)
from test_torch_train import (LEAF_REL, LOSS_REL, _blur, _ref_drops,
                              _tree_errs, mesh)  # noqa: F401

ARCH = "llama-3.2-vision-90b"
TOL = 2e-5
NESTED = dict(n_layers=6, cross_attn_period=3)


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


@functools.cache
def _cfgs(nested=True):
    """(reference, port) configs: NESTED, or the reduced ones."""
    jcfg, tcfg = j_get_config(ARCH).reduced(), get_config(ARCH + "-smoke")
    if nested:
        jcfg, tcfg = (dataclasses.replace(c, **NESTED) for c in (jcfg, tcfg))
    return jcfg, tcfg


def _patches(seed, b):
    """(B, n_vision_tokens, d_vision) float32 patch embeddings."""
    jcfg, _ = _cfgs()
    shape = jst._aux_shapes(jcfg, b, 1)["patches"][0]
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _aux(patches):
    return {"patches": jnp.asarray(patches)}


@functools.cache
def _jforward(mode="train", long_context=False):
    """The reference's NESTED forward, jitted once per (mode,
    long_context) in this module: (params, tokens, cache, positions,
    aux_inputs) -> (logits, cache)."""
    jcfg, _ = _cfgs()

    def fn(p, tokens, cache, positions, aux):
        logits, new_cache, _ = JT.forward(jcfg, p, tokens, mode=mode,
                                          cache=cache, positions=positions,
                                          aux_inputs=aux,
                                          long_context=long_context)
        return logits, new_cache
    return jax.jit(fn)


@pytest.fixture(scope="module")
def init_model():
    """The reference's NESTED params in numpy (its init jitted), as
    initialised: every gate 0."""
    jcfg, _ = _cfgs()
    init = jax.jit(JT.init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(init_model):
    """The NESTED params with the gates drawn (`_gated`)."""
    return _gated(init_model, 0)


# --------------------------------------------------------------------------
# the config and the init tree
# --------------------------------------------------------------------------

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "head_dim_", "d_ff", "vocab_size", "padded_vocab",
          "citation", "rope_theta", "qkv_bias", "sliding_window",
          "attn_logit_softcap", "final_logit_softcap", "attn_scale_override",
          "act", "gated_mlp", "cross_attn_period", "n_vision_tokens",
          "d_vision", "norm", "post_norm", "norm_eps", "tie_embeddings",
          "embed_scale", "long_context_mode", "long_context_window")


@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_config_fields_match_reference(name):
    j, t = j_get_config(name), get_config(name)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert "vlm" in PORTED_FAMILIES


@pytest.mark.parametrize("s", [4, 80, 3008])
def test_ctx_len_and_patches_shape_match_reference(s):
    """n_vision_tokens context rows whatever the length, d_vision wide,
    as the reference's `enc_ctx_len` and `_aux_shapes`."""
    for name in (ARCH, ARCH + "-smoke"):
        j, t = j_get_config(name), get_config(name)
        assert tst.enc_ctx_len(t, s) == jst.enc_ctx_len(j, s) == \
            t.n_vision_tokens
        assert tst.patches_shape(t, 3) == jst._aux_shapes(j, 3, s)[
            "patches"][0]


@pytest.mark.parametrize("nested", [False, True], ids=["reduced", "nested"])
def test_init_params_tree_matches_reference(nested):
    """Keys, nested stacked shapes and dtypes equal the reference's in
    float32 and bfloat16: ``blocks`` (n_super, n_self, ...),
    ``cross_blocks`` (n_super, ...) with float32 gates at 0 in a bfloat16
    tree too, ``vision_proj`` (d_vision, d)."""
    jcfg, tcfg = _cfgs(nested)
    n_super, n_self = (2, 2) if nested else (1, 1)
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
        assert tp["blocks"]["mlp"]["w_up"].shape[:2] == (n_super, n_self)
        for name in ("gate_attn", "gate_mlp"):
            gate = tp["cross_blocks"][name]
            assert gate.shape == (n_super,)
            assert gate.dtype == torch.float32 and not gate.any()
        assert tp["vision_proj"].shape == (tcfg.d_vision, tcfg.d_model)
        assert tp["vision_proj"].dtype == tdt


def test_convert_round_trips_the_nested_tree(model):
    """The NESTED reference tree in bfloat16 with its float32 gates
    crosses to the port with every leaf's layout, dtype and value kept,
    and back."""
    keep = ("gate_attn", "gate_mlp")
    np_p = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in keep
        else a.astype(jnp.bfloat16), model)
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    for name in keep:
        assert tp["cross_blocks"][name].dtype == torch.float32
    assert tp["blocks"]["attn"]["wq"].shape[:2] == (2, 2)
    assert tp["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    back = convert.zoo_params_to_numpy(tp)
    for (pa, a), (pb, b) in zip(convert.leaves_with_paths(back),
                                convert.leaves_with_paths(np_p)):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_init_cache_matches_reference():
    """One flat stack of n_super * n_self rings and a zero ctx of
    n_vision_tokens rows, whatever `ctx_len` says, as the reference's:
    keys, shapes, dtypes and values."""
    jcfg, tcfg = _cfgs()
    for long_context in (False, True):
        jc = JT.init_cache(jcfg, 2, 100, dtype=jnp.float32, ctx_len=7,
                           long_context=long_context)
        tc = TT.init_cache(tcfg, 2, 100, dtype=torch.float32, device="cpu",
                           ctx_len=7, long_context=long_context)
        got = convert.leaves_with_paths(tc)
        want = convert.leaves_with_paths(jax.tree.map(np.asarray, jc))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)
            np.testing.assert_array_equal(a.numpy(), b)
        assert tc["kv"]["k"].shape[:3] == (4, 2, 64 if long_context
                                           else 100)
        assert tc["ctx"].shape == (2, tcfg.n_vision_tokens, tcfg.d_model)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _logits_close(got, want, atol=TOL):
    v = _cfgs()[0].vocab_size
    _close(np.asarray(got)[..., :v], np.asarray(want)[..., :v], atol)


def _caches_close(tc, jc):
    """Every cache leaf: positions bitwise, rings and ctx within TOL."""
    for name, w in jc["kv"].items():
        if name == "pos":
            np.testing.assert_array_equal(tc["kv"][name].numpy(),
                                          np.asarray(w))
        else:
            _close(tc["kv"][name], w)
    assert tuple(tc["ctx"].shape) == np.asarray(jc["ctx"]).shape
    _close(tc["ctx"], jc["ctx"])


def test_zero_gates_make_the_logits_independent_of_the_patches(init_model):
    """At the init parameters (every gate 0) two different patches inputs
    give bitwise equal logits in each package, as the reference's: this
    pins the init, and is why every other case draws the gates. With
    the gates drawn the logits move."""
    _, tcfg = _cfgs()
    toks = _tokens(20, 2, 24)
    p1, p2 = _patches(21, 2), _patches(22, 2)
    j1, _ = _jforward()(init_model, jnp.asarray(toks), None, None, _aux(p1))
    j2, _ = _jforward()(init_model, jnp.asarray(toks), None, None, _aux(p2))
    np.testing.assert_array_equal(np.asarray(j1), np.asarray(j2))
    tp = convert.zoo_params_from_numpy(init_model, "cpu")
    t1, _, _ = TT.forward(tcfg, tp, _tok(toks),
                          aux_inputs={"patches": _t(p1)})
    t2, _, _ = TT.forward(tcfg, tp, _tok(toks),
                          aux_inputs={"patches": _t(p2)})
    assert torch.equal(t1, t2)
    gp = convert.zoo_params_from_numpy(_gated(init_model, 0), "cpu")
    t1, _, _ = TT.forward(tcfg, gp, _tok(toks),
                          aux_inputs={"patches": _t(p1)})
    t2, _, _ = TT.forward(tcfg, gp, _tok(toks),
                          aux_inputs={"patches": _t(p2)})
    v = tcfg.vocab_size
    assert float((t1 - t2)[..., :v].abs().max()) > 0.1


def test_forward_train_and_features_match_reference(model):
    """Logits of a 37-token train-mode forward with patches, and the
    features, against the reference's, at NESTED."""
    jcfg, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    toks, pt = _tokens(9, 2, 37), _patches(10, 2)
    want, _ = _jforward()(model, jnp.asarray(toks), None, None, _aux(pt))
    got, cache, aux = TT.forward(tcfg, tp, _tok(toks),
                                 aux_inputs={"patches": _t(pt)})
    assert got.shape == (2, 37, jcfg.padded_vocab) and cache is None
    assert float(aux) == 0.0
    print(f"forward: max abs logits "
          f"{_max_abs(got[..., :1024], np.asarray(want)[..., :1024]):.2e}")
    _logits_close(got, want)
    f_want, _ = jax.jit(lambda p, t, a: JT.forward_features(
        jcfg, p, t, aux_inputs=a))(model, jnp.asarray(toks), _aux(pt))
    f_got, _ = TT.forward_features(tcfg, tp, _tok(toks),
                                   aux_inputs={"patches": _t(pt)})
    print(f"features: max abs {_max_abs(f_got, f_want):.2e}")
    _close(f_got, f_want)


def test_forward_at_the_reduced_config_matches_reference():
    """The reference's own `reduced()` layout (one super-layer of one
    decoder block and one cross block), gates drawn: the train-mode
    logits with patches."""
    jcfg, tcfg = _cfgs(nested=False)
    init = jax.jit(JT.init_params, static_argnums=0)
    jp = _gated(jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(1))),
                1)
    toks, pt = _tokens(11, 2, 29), _patches(12, 2)
    want, _, _ = jax.jit(lambda p, t, a: JT.forward(
        jcfg, p, t, aux_inputs=a))(jp, jnp.asarray(toks), _aux(pt))
    got, _, _ = TT.forward(tcfg, convert.zoo_params_from_numpy(jp, "cpu"),
                           _tok(toks), aux_inputs={"patches": _t(pt)})
    print(f"reduced forward: max abs logits "
          f"{_max_abs(got[..., :1024], np.asarray(want)[..., :1024]):.2e}")
    _logits_close(got, want)


def test_forward_without_patches_or_a_cache_raises(model):
    """The context needs patches, or a cache holding it: a train-mode
    call with neither raises a ValueError naming the input (the
    reference fails there too, reading the ctx of a None cache)."""
    jcfg, tcfg = _cfgs()
    toks = _tokens(15, 1, 8)
    with pytest.raises(TypeError):
        JT.forward(jcfg, model, jnp.asarray(toks))
    with pytest.raises(ValueError, match=r"aux_inputs\['patches'\]"):
        TT.forward(tcfg, convert.zoo_params_from_numpy(model, "cpu"),
                   _tok(toks))


def test_profiler_ranges_name_the_family(model):
    """A forward with patches runs ``vlm.vision_proj`` once and
    ``vlm.cross`` and ``attention.ctx_kv`` once a super-layer (the
    audio family's cross blocks keep ``audio.cross``)."""
    _, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        TT.forward(tcfg, tp, _tok(_tokens(3, 1, 5)),
                   aux_inputs={"patches": _t(_patches(4, 1))})
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("vlm.vision_proj") == 1
    assert counts.get("vlm.cross") == 2
    assert counts.get("attention.ctx_kv") == 2
    assert "audio.cross" not in counts


def _prefill_then_decode(model, toks, pt, s, n, long_context):
    """Prefill s positions of `toks` with patches `pt` into a cache of s
    + n + 1 slots (a ring of the long-context window under
    `long_context`), then n decode steps that read the ctx from the
    cache, each from the reference's cache; logits and every cache leaf
    against the reference's."""
    jcfg, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    b = toks.shape[0]
    jcache = JT.init_cache(jcfg, b, s + n + 1, dtype=jnp.float32,
                           long_context=long_context)
    tcache = TT.init_cache(tcfg, b, s + n + 1, dtype=torch.float32,
                           device="cpu", long_context=long_context)
    assert set(tcache) == set(jcache) == {"kv", "ctx"}
    want, jcache = _jforward("prefill", long_context)(
        model, jnp.asarray(toks[:, :s]), jcache, None, _aux(pt))
    got, tcache, _ = TT.forward(tcfg, tp, _tok(toks[:, :s]), mode="prefill",
                                cache=tcache, aux_inputs={"patches": _t(pt)},
                                long_context=long_context)
    errs = [_max_abs(got[..., :1024], np.asarray(want)[..., :1024])]
    _logits_close(got, want)
    _caches_close(tcache, jcache)
    for i in range(n):
        p = np.full((b,), s + i, np.int32)
        want, jnew = _jforward("decode", long_context)(
            model, jnp.asarray(toks[:, s + i:][:, :1]), jcache,
            jnp.asarray(p), None)
        got, tnew, _ = TT.forward(
            tcfg, tp, _tok(toks[:, s + i:][:, :1]), mode="decode",
            cache=convert.tree_map(_t, jax.tree.map(np.asarray, jcache)),
            positions=_tok(p), long_context=long_context)
        errs.append(_max_abs(got[..., :1024],
                             np.asarray(want)[..., :1024]))
        _logits_close(got, want)
        _caches_close(tnew, jnew)
        jcache = jnew
    return errs, tcache


def test_prefill_and_decode_match_reference(model):
    """Prefill 20 positions with patches, then 3 decode steps from the
    cache's ctx, at NESTED: logits and every cache leaf (the 4 flat
    rings, positions bitwise, and the projected ctx); the ctx after the
    prefill is patches @ vision_proj."""
    toks, pt = _tokens(16, 2, 23), _patches(17, 2)
    errs, tcache = _prefill_then_decode(model, toks, pt, 20, 3, False)
    print(f"prefill and decode: max abs logits {max(errs):.2e}")
    assert tcache["kv"]["k"].shape[0] == 4
    _close(tcache["ctx"], pt @ model["vision_proj"])


def test_long_context_prefill_and_decode_match_reference(model):
    """``long_context``: the window of 64 in every decoder block and a
    ring of 64 slots; an 80-token prefill (its last 64 positions kept)
    and 2 decode steps, against the reference's at NESTED."""
    toks, pt = _tokens(23, 2, 82), _patches(24, 2)
    errs, tcache = _prefill_then_decode(model, toks, pt, 80, 2, True)
    print(f"long-context prefill and decode: max abs logits "
          f"{max(errs):.2e}")
    assert tcache["kv"]["k"].shape[2] == 64


def test_prefill_without_patches_matches_reference(mesh, model):
    """`make_prefill_step` without patches: the cross blocks attend over
    the zero ctx of n_vision_tokens rows, against the reference's
    prefill step on the one-device mesh: the last logits and the cache."""
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
    assert tcache["ctx"].shape == (b, tcfg.n_vision_tokens, tcfg.d_model)
    assert not tcache["ctx"].any()
    _logits_close(got, want)
    _caches_close(tcache, jcache)


def test_decode_after_prefill_equals_a_full_forward(model):
    """Greedy decode through launch/decode.py's functions with patches:
    the prefill's pick and each step's equal the full forward's with the
    same patches at the same position, the logits within TOL."""
    _, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    prompts, pt = _tok(_tokens(13, 2, 20)), _t(_patches(14, 2))
    last, cache, _ = tdecode.run_prefill(tcfg, tp, prompts, 24,
                                         torch.float32, patches=pt)
    toks, cache, _ = tdecode.run_decode(tcfg, tp, last, cache, 20, 3)
    full, _, _ = TT.forward(tcfg, tp, torch.cat([prompts, toks[:, :3]], 1),
                            aux_inputs={"patches": pt})
    _logits_close(last, full[:, 19].numpy())
    for i in range(4):
        assert torch.equal(toks[:, i],
                           tdecode.greedy(tcfg, full[:, 19 + i])[:, 0])


# --------------------------------------------------------------------------
# the train step and the launchers
# --------------------------------------------------------------------------

MOVED = (("vision_proj",), ("cross_blocks", "xattn", "wq"),
         ("cross_blocks", "xattn", "wk"), ("cross_blocks", "xattn", "wv"))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float64)


@pytest.mark.parametrize("objective,b,s", [("lm", 4, 24), ("dt", 8, 16)])
def test_train_step_matches_reference(mesh, model, objective, b, s):
    """One `make_train_step` step (flsimco, sgdm) at NESTED in 2
    micro-batches, the patches split with the tokens, against the
    reference's from the reference's params: the loss, then every
    parameter and momentum leaf. The vision projector's and the
    cross-attention's gradients (the momentum less weight decay's share)
    are non-zero in both packages."""
    jcfg, tcfg = _cfgs()
    kw = dict(objective=objective, n_micro=2)
    jfn, _ = jst.make_train_step(jcfg, JShape("t", s, b, "train"), mesh,
                                 **kw)
    tfn, _ = tst.make_train_step(tcfg, InputShape("t", s, b, "train"), **kw)
    toks, pt = _tokens(s + b, b, s), _patches(s + b + 1, b)
    blur = _blur(s, b)
    with compat.set_mesh(mesh):
        jp, jm, jmet = jax.jit(jfn)(model, jst.init_momentum(model),
                                    {"tokens": jnp.asarray(toks),
                                     "blur": jnp.asarray(blur),
                                     "patches": jnp.asarray(pt)})
    tp0 = convert.zoo_params_from_numpy(model, "cpu")
    batch = {"tokens": _tok(toks), "blur": torch.from_numpy(blur),
             "patches": _t(pt)}
    widen = 0.0
    if objective == "dt":
        batch["drops"] = _ref_drops(b // 2, s, 2)
        widen = _dt_widening(tcfg, tp0, batch, 2)
    tp, tm, tmet = tfn(tp0, tst.init_momentum(tp0), batch)
    want = float(jmet["loss"])
    loss_rel = abs(float(tmet["loss"]) - want) / abs(want)
    worst = {}
    for name, tree, ref_tree in (("params", tp, jp), ("momentum", tm, jm)):
        errs = _tree_errs(tree, ref_tree)
        worst[name] = max(errs, key=errs.get)
        assert errs[worst[name]] <= LEAF_REL + widen, (
            name, worst[name], errs[worst[name]], widen)
        worst[name] = errs[worst[name]]
    print(f"{objective} step: loss relative {loss_rel:.2e}, leaves "
          f"{worst} (tol {LEAF_REL} + {widen:.2e})")
    assert loss_rel <= LOSS_REL + widen
    tm_np = convert.tree_to_numpy(tm)
    for path in MOVED:
        wd = 5e-4 * _leaf(model, path)
        for m in (tm_np, jm):
            g = np.abs(_leaf(m, path) - wd).max()
            assert g > 1e-6, (path, g)


def _dt_widening(tcfg, tp, batch, n_micro) -> float:
    """tests/test_torch_dense_train.py's `_dt_widening`, each view's
    features reading its micro-batch's patches: 2^-24 / tau_a / min(w_a)
    (tau_a = 0.1), w_a = 1 - p_a(pos) from the port's own features."""
    w_min = 1.0
    with torch.no_grad():
        for toks, d, pt in zip(batch["tokens"].chunk(n_micro),
                               batch["drops"].chunk(n_micro, dim=1),
                               batch["patches"].chunk(n_micro)):
            q, k = (TT.forward_features(
                tcfg, tp, torch.where(m, tst.MASK_TOKEN, toks),
                aux_inputs={"patches": pt})[0] for m in d)
            _, lse_a, _, pos = ref.dt_loss_fwd_ref(q, k, 0.1, 1.0)
            w_min = min(w_min, float((1 - torch.exp(pos / 0.1 - lse_a))
                                     .min()))
    return 2.0 ** -24 / 0.1 / w_min


def test_make_batch_draws_patches():
    """`make_batch` draws the patches (B, n_vision_tokens, d_vision)
    standard normal float32 from the step's generator, after the tokens
    and the blur: the same for the same (seed, step), new for another
    step."""
    cfg = get_config(ARCH + "-smoke")
    shape = InputShape("cpu", 16, 4, "train")
    a = ttrain.make_batch(cfg, shape, 0, 0, "cpu", "lm")
    b = ttrain.make_batch(cfg, shape, 0, 0, "cpu", "lm")
    c = ttrain.make_batch(cfg, shape, 1, 0, "cpu", "dt")
    assert a["patches"].shape == (4, 16, 64) == tuple(c["patches"].shape)
    assert a["patches"].dtype == torch.float32
    assert torch.equal(a["patches"], b["patches"])
    assert not torch.equal(a["patches"], c["patches"])
    assert "frames" not in a and "drops" in c


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
