"""The port's hybrid zoo family (Hymba: the selective-SSM branch beside
sliding-window attention, its conv and SSM decode states, the SSM
backward that recomputes each group of chunks) against the JAX
reference, on the CPU: the config, the SSM layer and its gradients, the
model in its three modes, the train step and the launchers.

The config is ``hymba-1.5b-smoke`` (2 layers, d_model 256, 4 query heads
and 2 KV heads of 64, window 32, d_ff 512, SSM state 16 and 512 inner
channels, vocab 1024 padded to 2048) in float32. Inputs are numpy draws;
the reference's weights are carried into the port with
`convert.zoo_params_from_numpy`, after the zero-initialised norm scales
get small numpy noise (tests/test_torch_dense.py's `_noised`).

Tolerances, both sides float32: SSM_TOL = 3e-5 absolute on the SSM
layer's output and states, the bound the reference's own
tests/test_models_units.py gives two orderings of the same float32
recurrence; TOL = 2e-5 absolute on logits, features and caches (sums of
256-512 products in other orders, values of order 1-10); gradients
within GRAD_REL of each gradient's largest magnitude, as
tests/test_torch_moe.py states it; train steps at
tests/test_torch_train.py's LOSS_REL and LEAF_REL, the ``dt`` step
widened as tests/test_torch_dense_train.py widens it.

    PYTHONPATH=src python -m pytest tests/test_torch_hybrid.py
"""
from __future__ import annotations

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

ARCH = "hymba-1.5b"
TOL = 2e-5
SSM_TOL = 3e-5
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


@functools.cache
def _cfgs():
    return j_get_config(ARCH).reduced(), get_config(ARCH + "-smoke")


@functools.cache
def _jforward(mode="train", long_context=False):
    """The reference's forward, jitted once per (mode, long_context) in
    this module: (params, tokens, cache, positions) -> (logits, cache)."""
    jcfg, _ = _cfgs()

    def fn(p, tokens, cache, positions):
        logits, new_cache, _ = JT.forward(jcfg, p, tokens, mode=mode,
                                          cache=cache, positions=positions,
                                          long_context=long_context)
        return logits, new_cache
    return jax.jit(fn)


@functools.cache
def _jssm():
    """The reference's ssm_block, jitted once (retraced per shape)."""
    jcfg, _ = _cfgs()
    return jax.jit(lambda p, x, h, c: JL.ssm_block(jcfg, p, x, h, c))


@pytest.fixture(scope="module")
def model():
    """The reference's smoke params in numpy (its init jitted)."""
    jcfg, _ = _cfgs()
    init = jax.jit(JT.init_params, static_argnums=0)
    return _noised(jax.tree.map(np.asarray, init(
        jcfg, jax.random.PRNGKey(0))), 0)


def _ssm_params(model):
    """The first layer's numpy SSM params."""
    return jax.tree.map(lambda a: a[0], model["blocks"]["ssm"])


def _ssm_inputs(seed, s, with_state, b=2):
    jcfg, _ = _cfgs()
    di = jcfg.ssm_expand * jcfg.d_model
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, s, jcfg.d_model) * 0.5).astype(np.float32)
    if not with_state:
        return x, None, None
    h = (rs.randn(b, di, jcfg.ssm_state) * 0.1).astype(np.float32)
    c = (rs.randn(b, 3, di) * 0.5).astype(np.float32)
    return x, h, c


def _maybe(t):
    return None if t is None else _t(t)


# --------------------------------------------------------------------------
# the config and the init tree
# --------------------------------------------------------------------------

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "head_dim_", "d_ff", "vocab_size", "padded_vocab",
          "citation", "rope_theta", "qkv_bias", "sliding_window",
          "local_global_period", "attn_logit_softcap", "final_logit_softcap",
          "attn_scale_override", "act", "gated_mlp", "ssm_state",
          "ssm_expand", "hybrid_parallel", "norm", "post_norm", "norm_eps",
          "tie_embeddings", "embed_scale", "long_context_mode",
          "long_context_window")


@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_config_fields_match_reference(name):
    j, t = j_get_config(name), get_config(name)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("long_context", [False, True])
def test_layer_windows_and_cache_width_match_reference(long_context):
    jcfg, tcfg = _cfgs()
    for cfg_j, cfg_t in ((j_get_config(ARCH), get_config(ARCH)),
                         (jcfg, tcfg)):
        assert TT.layer_windows(cfg_t, cfg_t.n_layers, long_context) == [
            int(w) for w in JT.layer_windows(cfg_j, cfg_j.n_layers,
                                             long_context)]
        for s in (16, 32, 64, 1024, 4096):
            assert TT.cache_width(cfg_t, s, long_context) == \
                JT.cache_width(cfg_j, s, long_context)


def test_init_params_tree_matches_reference():
    """Keys, stacked shapes and dtypes equal the reference's in float32
    and bfloat16: b_dt, A_log and D stay float32 in a bfloat16 tree."""
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
        for name in ("b_dt", "A_log", "D"):
            assert tp["blocks"]["ssm"][name].dtype == torch.float32
    # the float32 leaves' values are the reference's
    jp = JL.init_ssm(jcfg, jax.random.PRNGKey(0))
    tp = TL.init_ssm(tcfg, torch.Generator().manual_seed(0))
    for name in ("b_dt", "A_log", "D"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=1e-7, atol=0)


def test_convert_carries_a_bfloat16_tree_with_float32_ssm_leaves(model):
    """A bfloat16 reference tree with its float32 b_dt, A_log and D
    crosses to the port with every leaf's dtype and value kept, and
    back."""
    keep = ("b_dt", "A_log", "D")
    np_p = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in keep
        else a.astype(jnp.bfloat16), model)
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    for name in keep:
        assert tp["blocks"]["ssm"][name].dtype == torch.float32
    assert tp["blocks"]["ssm"]["w_in"].dtype == torch.bfloat16
    back = convert.zoo_params_to_numpy(tp)
    for (pa, a), (pb, b) in zip(convert.leaves_with_paths(back),
                                convert.leaves_with_paths(np_p)):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# --------------------------------------------------------------------------
# the SSM layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_conv_matches_reference(model, with_state):
    """The width-4 causal conv and its new state, from zeros and from a
    conv state."""
    jcfg, _ = _cfgs()
    jp = _ssm_params(model)
    di = jcfg.ssm_expand * jcfg.d_model
    rs = np.random.RandomState(3)
    x = rs.randn(2, 11, di).astype(np.float32)
    c = rs.randn(2, 3, di).astype(np.float32) if with_state else None
    jy, jc = JL._ssm_conv(jp, jnp.asarray(x),
                          None if c is None else jnp.asarray(c))
    ty, tc = TL._ssm_conv(convert.zoo_params_from_numpy(jp, "cpu"), _t(x),
                          _maybe(c))
    _close(ty, jy, 1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("s", [20, 128, 200])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_block_matches_reference(model, s, with_state):
    """`ssm_block`'s output, state and conv state at SSM_TOL: one chunk
    of 20, one of 128, and 200 = 128 + 72 (the ragged split, the states
    threaded between the parts); from zeros and from given states."""
    jcfg, tcfg = _cfgs()
    jp = _ssm_params(model)
    x, h, c = _ssm_inputs(s, s, with_state)
    jo, (jh, jc) = _jssm()(jp, jnp.asarray(x), h, c)
    to, (th, tc) = TL.ssm_block(tcfg, convert.zoo_params_from_numpy(
        jp, "cpu"), _t(x), _maybe(h), _maybe(c))
    errs = (_max_abs(to, jo), _max_abs(th, jh), _max_abs(tc, jc))
    print(f"ssm_block S={s} state={with_state}: max abs out, h, conv "
          f"{errs}")
    assert to.shape == x.shape and th.dtype == torch.float32
    assert max(errs) <= SSM_TOL, errs


def test_ssm_block_equals_its_steps(model):
    """The port's chunked `ssm_block` against its own `ssm_step` token by
    token (the reference's test_ssm_chunked_equals_stepwise, ported)."""
    _, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(_ssm_params(model), "cpu")
    x = _t(np.random.RandomState(6).randn(1, 20, tcfg.d_model)
           .astype(np.float32) * 0.2)
    o_all, (h_all, c_all) = TL.ssm_block(tcfg, tp, x)
    h = c = None
    outs = []
    for t in range(x.shape[1]):
        o, (h, c) = TL.ssm_step(tcfg, tp, x[:, t:t + 1], h, c)
        outs.append(o)
    _close(torch.cat(outs, 1), o_all, SSM_TOL)
    _close(h, h_all, SSM_TOL)
    _close(c, c_all, SSM_TOL)


@pytest.mark.parametrize("s,with_state,group_elems", [
    (200, True, None),       # 128 + 72, one group a part
    (384, False, 1),         # three chunks, one group each
    (384, True, 2 * 128 * 512 * 16 * 2),   # groups of 2 chunks, then 1
])
def test_ssm_gradients_match_jax_grad(model, monkeypatch, s, with_state,
                                      group_elems):
    """Gradients of <out, g> + <h, g_h> + <conv, g_c> with respect to x,
    the starting states and every SSM leaf, through the recomputing
    backward (`layers._SSMScan`), against `jax.grad` of the reference's
    `ssm_block`; with `group_elems` set, the backward walks several
    groups of chunks and carries the state's gradient between them."""
    jcfg, tcfg = _cfgs()
    if group_elems is not None:
        monkeypatch.setattr(TL, "SSM_GROUP_ELEMS", group_elems)
    jp = _ssm_params(model)
    x, h0, c0 = _ssm_inputs(s + 1, s, with_state)
    di = jcfg.ssm_expand * jcfg.d_model
    rs = np.random.RandomState(7)
    g = rs.randn(*x.shape).astype(np.float32)
    gh = rs.randn(2, di, jcfg.ssm_state).astype(np.float32)
    gc = rs.randn(2, 3, di).astype(np.float32)

    def jloss(p, x, h, c):
        o, (hn, cn) = JL.ssm_block(jcfg, p, x, h, c)
        return jnp.sum(o * g) + jnp.sum(hn * gh) + jnp.sum(cn * gc)

    argnums = (0, 1, 2, 3) if with_state else (0, 1)
    jg = jax.jit(jax.grad(jloss, argnums=argnums))(
        jp, jnp.asarray(x), h0, c0)
    tp = convert.zoo_params_from_numpy(jp, "cpu")
    paths = convert.leaves_with_paths(tp)
    leaves = [t.requires_grad_() for _, t in paths]
    ins = [_t(a).requires_grad_() for a in (x, h0, c0) if a is not None]
    o, (hn, cn) = TL.ssm_block(tcfg, convert.unflatten(leaves, tp), ins[0],
                               *(ins[1:] or (None, None)))
    loss = (o * _t(g)).sum() + (hn * _t(gh)).sum() + (cn * _t(gc)).sum()
    grads = torch.autograd.grad(loss, leaves + ins)
    want = dict(convert.leaves_with_paths(jax.tree.map(np.asarray, jg[0])))
    for (path, _), got in zip(paths, grads):
        assert _leaf_err(got, want[path]) <= GRAD_REL, path
    for got, w in zip(grads[len(leaves):], jg[1:]):
        assert _leaf_err(got, w) <= GRAD_REL


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
    _close(tc["ssm"], jc["ssm"])
    _close(tc["conv"], jc["conv"])


def test_forward_train_and_features_match_reference(model):
    """Logits of a 45-token train-mode forward (a 128-chunk would be
    whole; 45 is one ragged chunk) and the features."""
    jcfg, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    toks = _tokens(9, 2, 45)
    want, _ = _jforward()(model, jnp.asarray(toks), None, None)
    got, cache, aux = TT.forward(tcfg, tp, _tok(toks))
    assert got.shape == (2, 45, jcfg.padded_vocab) and cache is None
    assert float(aux) == 0.0
    _logits_close(got, want)
    f_want, _ = jax.jit(lambda p, t: JT.forward_features(jcfg, p, t))(
        model, jnp.asarray(toks))
    f_got, _ = TT.forward_features(tcfg, tp, _tok(toks))
    _close(f_got, f_want)


@pytest.mark.parametrize("s", [32, 64])
def test_prefill_and_decode_match_reference(model, s):
    """Prefill S positions into the ring of W = 32 slots (cache_width of
    S + 4), then 2 decode steps, each from the reference's cache: logits
    and every cache leaf (kv ring, SSM states, conv states). At S = 32 =
    W the prefill's last logits equal a full forward's. At S = 64 > W
    the ring keeps only the last 32 positions' keys, so queries before S
    - W lose keys of their window and the next layer's SSM carries that
    on: the port's prefill equals the reference's there, and both differ
    from the full forward by the same amount."""
    jcfg, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    b = 2
    toks = _tokens(10, b, s + 2)
    jcache = JT.init_cache(jcfg, b, s + 4, dtype=jnp.float32)
    tcache = TT.init_cache(tcfg, b, s + 4, dtype=torch.float32, device="cpu")
    assert set(tcache) == set(jcache) == {"kv", "ssm", "conv"}
    assert tcache["kv"]["k"].shape[2] == 32
    want, jcache = _jforward("prefill")(model, jnp.asarray(toks[:, :s]),
                                        jcache, None)
    got, tcache, _ = TT.forward(tcfg, tp, _tok(toks[:, :s]), mode="prefill",
                                cache=tcache)
    _logits_close(got, want)
    _caches_close(tcache, jcache)
    full, _, _ = TT.forward(tcfg, tp, _tok(toks[:, :s]))
    v = jcfg.vocab_size
    off_port = _max_abs(got[:, -1, :v], full[:, -1, :v])
    off_ref = _max_abs(np.asarray(want)[:, -1, :v], full[:, -1, :v])
    print(f"prefill S={s}: last logits off the full forward by {off_port} "
          f"(port), {off_ref} (reference)")
    if s == 32:
        assert off_port <= TOL
    else:
        assert off_port > 0.1 and abs(off_port - off_ref) <= TOL
    for i in range(2):
        p = np.full((b,), s + i, np.int32)
        want, jnew = _jforward("decode")(
            model, jnp.asarray(toks[:, s + i:][:, :1]), jcache,
            jnp.asarray(p))
        got, tnew, _ = TT.forward(
            tcfg, tp, _tok(toks[:, s + i:][:, :1]), mode="decode",
            cache=convert.tree_map(_t, jax.tree.map(np.asarray, jcache)),
            positions=_tok(p))
        _logits_close(got, want)
        _caches_close(tnew, jnew)
        jcache = jnew


def test_long_context_decode_matches_reference(model):
    """Decode under long_context at positions 0, 1, W/2, W, W + 3 and 2W
    + 1 into a ring of W = 32 slots (the reference's
    test_sliding_window_decode_long_context[hymba]), each side carrying
    its own cache: every step's logits and the final cache value for
    value, the ring's width fixed."""
    jcfg, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    b = 2
    w = TT.cache_width(tcfg, 256, True)
    assert w == JT.cache_width(jcfg, 256, True) == 32
    jcache = JT.init_cache(jcfg, b, 256, dtype=jnp.float32,
                           long_context=True)
    tcache = TT.init_cache(tcfg, b, 256, dtype=torch.float32, device="cpu",
                           long_context=True)
    tok = _tokens(14, b, 1)
    for pos in (0, 1, w // 2, w, w + 3, 2 * w + 1):
        p = np.full((b,), pos, np.int32)
        want, jcache = _jforward("decode", True)(
            model, jnp.asarray(tok), jcache, jnp.asarray(p))
        got, tcache, _ = TT.forward(tcfg, tp, _tok(tok), mode="decode",
                                    cache=tcache, positions=_tok(p),
                                    long_context=True)
        assert bool(torch.isfinite(got[..., :tcfg.vocab_size]).all())
        _logits_close(got, want)
    _caches_close(tcache, jcache)
    assert tcache["kv"]["k"].shape[2] == w


def test_prefill_without_a_cache_raises(model):
    """As the reference's: the kv ring must exist to be filled."""
    jcfg, tcfg = _cfgs()
    toks = _tokens(15, 1, 8)
    with pytest.raises(ValueError, match="hybrid prefill requires a cache"):
        JT.forward(jcfg, model, jnp.asarray(toks), mode="prefill")
    with pytest.raises(ValueError, match="hybrid prefill requires a cache"):
        TT.forward(tcfg, convert.zoo_params_from_numpy(model, "cpu"),
                   _tok(toks), mode="prefill")


def test_decode_after_prefill_equals_a_full_forward(model):
    """Greedy decode through launch/decode.py's functions, the prompt
    within the window (20 + 3 < 32): the prefill's pick and each step's
    equal the full forward's at the same position, the logits within
    TOL."""
    _, tcfg = _cfgs()
    tp = convert.zoo_params_from_numpy(model, "cpu")
    prompts = _tok(_tokens(13, 2, 20))
    last, cache, _ = tdecode.run_prefill(tcfg, tp, prompts, 24,
                                         torch.float32)
    toks, cache, _ = tdecode.run_decode(tcfg, tp, last, cache, 20, 3)
    full, _, _ = TT.forward(tcfg, tp, torch.cat([prompts, toks[:, :3]], 1))
    _logits_close(last, full[:, 19].numpy())
    for i in range(4):
        assert torch.equal(toks[:, i],
                           tdecode.greedy(tcfg, full[:, 19 + i])[:, 0])


# --------------------------------------------------------------------------
# the train step and the launchers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("objective,b,s,n_micro", [("lm", 4, 24, 2),
                                                   ("dt", 8, 16, 1)])
def test_train_step_matches_reference(mesh, model, objective, b, s,
                                      n_micro):
    """One `make_train_step` step (flsimco, sgdm) against the reference's,
    from the reference's params: the loss, then every parameter and
    momentum leaf (the SSM's through the recomputing backward)."""
    jcfg, tcfg = _cfgs()
    kw = dict(objective=objective, n_micro=n_micro)
    jfn, _ = jst.make_train_step(jcfg, JShape("t", s, b, "train"), mesh,
                                 **kw)
    tfn, _ = tst.make_train_step(tcfg, InputShape("t", s, b, "train"), **kw)
    toks = np.random.RandomState(s + b).randint(1, jcfg.vocab_size,
                                                (b, s)).astype(np.int32)
    blur = _blur(s, b)
    with compat.set_mesh(mesh):
        jp, jm, jmet = jax.jit(jfn)(model, jst.init_momentum(model),
                                    {"tokens": jnp.asarray(toks),
                                     "blur": jnp.asarray(blur)})
    tp = convert.zoo_params_from_numpy(model, "cpu")
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

