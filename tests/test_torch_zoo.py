"""The port's zoo serving path (RWKV6, ``ssm`` family) against the JAX
reference, on the CPU.

Inputs are made from numpy seeds (or drawn once by the reference and
handed over as numpy), and the reference's weights are carried into the
port with `convert.zoo_params_from_numpy`, so both sides compute on the
same numbers. The config is ``rwkv6-1.6b-smoke`` (2 layers, d_model 256,
4 heads of 64, d_ff 512, vocab 1024 padded to 2048) in float32.

Tolerances: 2e-4 absolute, the reference's own for this recurrence
(tests/test_kernels.py, tests/test_archs_smoke.py). Both sides compute in
float32; the chunked form, the matmuls and the norms sum in other orders
in the two frameworks, a few ULP of values of order 1-20.

    PYTHONPATH=src python -m pytest tests/test_torch_zoo.py
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6 import rwkv6_pallas
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import decode as tdecode
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_round import torch_threads  # noqa: F401 (autouse)

TOL = 2e-4
ARCH = "rwkv6-1.6b"


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rwkv6_inputs(seed, bh, s, d, with_state):
    """The reference's kernel-test distribution (tests/test_kernels.py)."""
    rs = np.random.RandomState(seed)
    r, k, v = ((rs.randn(bh, s, d) * 0.5).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rs.randn(bh, s, d) * 0.3 - 1.0), -4.0, -1e-4)
    u = (rs.randn(bh, d) * 0.3).astype(np.float32)
    s0 = ((rs.randn(bh, d, d) * 0.3).astype(np.float32) if with_state
          else None)
    return r, k, v, logw.astype(np.float32), u, s0


@pytest.fixture(scope="module")
def cfgs():
    return j_get_config(ARCH).reduced(), get_config(ARCH + "-smoke")


@pytest.fixture(scope="module")
def model(cfgs):
    """Reference float32 params of the smoke config, and the port's copy."""
    jcfg, _ = cfgs
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.zoo_params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jp, tp


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(1, vocab, (b, s)).astype(
        np.int32)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_config_fields_match_reference(name):
    j = j_get_config(name)
    t = get_config(name)
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "d_ff",
              "vocab_size", "rwkv_head_dim", "norm", "norm_eps",
              "tie_embeddings", "embed_scale", "final_logit_softcap", "act",
              "gated_mlp", "long_context_mode", "padded_vocab"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(cfgs, dtype):
    """Keys, stacked shapes and per-leaf dtypes of the port's init equal
    the reference's (``w0``, ``w_lora_b`` and ``u`` stay float32)."""
    jcfg, tcfg = cfgs
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0),
                                               getattr(jnp, dtype)))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                        getattr(torch, dtype))
    jl = convert.leaves_with_paths(jax.tree.map(
        lambda a: (a.shape, str(a.dtype)), jp,
        is_leaf=lambda a: hasattr(a, "shape")))
    tl = convert.leaves_with_paths(convert.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp))
    assert tl == jl


def test_zoo_params_roundtrip_keeps_bfloat16_bits(cfgs):
    jcfg, _ = cfgs
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(3),
                                                 jnp.bfloat16))
    tp = convert.zoo_params_from_numpy(jp, device="cpu")
    assert tp["blocks"]["tmix"]["wr"].dtype == torch.bfloat16
    assert tp["blocks"]["tmix"]["u"].dtype == torch.float32
    back = convert.zoo_params_to_numpy(tp)
    for (path, a), (_, b) in zip(convert.leaves_with_paths(jp),
                                 convert.leaves_with_paths(back)):
        np.testing.assert_array_equal(a.astype(np.float32), b, str(path))


# --------------------------------------------------------------------------
# the rwkv6 wrapper (plain path) against the reference kernel and oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 37, 128])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_matches_pallas_and_oracle(S, D, with_state):
    r, k, v, lw, u, s0 = _rwkv6_inputs(S * 100 + D, 3, S, D, with_state)
    o, st = ops.rwkv6(_t(r), _t(k), _t(v), _t(lw), _t(u),
                      None if s0 is None else _t(s0))
    jo, jst = jref.rwkv6_ref(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                             None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), _np(jo), atol=TOL)
    np.testing.assert_allclose(st.numpy(), _np(jst), atol=TOL)
    # the port's sequential oracle is the reference's
    so, sst = ref.rwkv6_ref(_t(r), _t(k), _t(v), _t(lw), _t(u),
                            None if s0 is None else _t(s0))
    np.testing.assert_allclose(so.numpy(), _np(jo), atol=TOL)
    np.testing.assert_allclose(sst.numpy(), _np(jst), atol=TOL)
    if with_state:
        return          # the Pallas kernel starts from a zero state
    if S % 16 == 0:
        po, pst = rwkv6_pallas(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                               interpret=True)
        np.testing.assert_allclose(st.numpy(), _np(pst), atol=TOL)
    else:
        po, _ = jops.rwkv6(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                           interpret=True)
    np.testing.assert_allclose(o.numpy(), _np(po), atol=TOL)


def _wrapper_pads_inputs():
    """The inputs of tests/test_kernels.py::test_rwkv6_wrapper_pads_sequence
    (BH = 2, S = 37, D = 32), drawn by the reference."""
    ks = jax.random.split(jax.random.PRNGKey(77), 5)
    bh, s, d = 2, 37, 32
    r, k, v = (jax.random.normal(ks[i], (bh, s, d)) * 0.5 for i in range(3))
    logw = jnp.clip(-jnp.exp(jax.random.normal(ks[3], (bh, s, d))), -4, -1e-4)
    u = jax.random.normal(ks[4], (d,)) * 0.3
    return r, k, v, logw, u


def test_rwkv6_ragged_state_is_the_oracles():
    """At S = 37 the port returns the state after exactly 37 steps."""
    args = _wrapper_pads_inputs()
    o, st = ops.rwkv6(*(_t(a) for a in args))
    jo, jst = jref.rwkv6_ref(*args)
    np.testing.assert_allclose(o.numpy(), _np(jo), atol=TOL)
    np.testing.assert_allclose(st.numpy(), _np(jst), atol=TOL)


def test_reference_wrapper_decays_the_padded_state():
    """Pins the known difference: the reference wrapper pads S = 37 to 48
    with logw = -1e-4, so its state is the true state decayed by
    exp(-1e-4) for each of the 11 padded steps — off by more than its own
    tolerance. The port does not copy this (previous test)."""
    args = _wrapper_pads_inputs()
    _, jst = jref.rwkv6_ref(*args)
    _, wst = jops.rwkv6(*args, interpret=True)
    err = float(np.abs(_np(wst) - _np(jst)).max())
    assert err > 5 * TOL
    np.testing.assert_allclose(_np(wst), _np(jst) * np.exp(-11e-4),
                               atol=TOL)
    _, st = ops.rwkv6(*(_t(a) for a in args))
    assert float(np.abs(st.numpy() - _np(wst)).max()) > 5 * TOL


def test_rwkv6_bshd_layout_matches_rows():
    """The (B, S, H, D) layout the time-mix hands the wrapper equals the
    (BH, S, D) call on transposed rows."""
    b, s, h, d = 2, 21, 3, 32
    r, k, v, lw, _, _ = _rwkv6_inputs(9, b, s, h * d, False)
    rs = np.random.RandomState(10)
    u = (rs.randn(h, d) * 0.3).astype(np.float32)
    s0 = (rs.randn(b, h, d, d) * 0.3).astype(np.float32)
    four = [_t(a).view(b, s, h, d) for a in (r, k, v, lw)]
    o4, st4 = ops.rwkv6(*four, _t(u), _t(s0))
    rows = [t.transpose(1, 2).reshape(b * h, s, d) for t in four]
    o3, st3 = ref.rwkv6_ref(*rows, _t(u).repeat(b, 1),
                            _t(s0).reshape(b * h, d, d))
    np.testing.assert_allclose(o4.transpose(1, 2).reshape(b * h, s, d),
                               o3, atol=TOL)
    np.testing.assert_allclose(st4.reshape(b * h, d, d), st3, atol=TOL)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _x(seed, b, s, d, scale=0.5):
    return (np.random.RandomState(seed).randn(b, s, d) * scale).astype(
        np.float32)


@pytest.mark.parametrize("S,carry", [(32, False), (37, True), (5, True)])
def test_rwkv_tmix_chunked_matches_reference(cfgs, S, carry):
    """The port calls the kernel once on the whole sequence; the reference
    splits a ragged S into a chunk-aligned head and a tail."""
    jcfg, tcfg = cfgs
    jp = JL.init_rwkv_tmix(jcfg, jax.random.PRNGKey(5))
    tp = convert.zoo_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    b, d = 2, jcfg.d_model
    h, hd = d // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    x = _x(S, b, S, d)
    rs = np.random.RandomState(S + 1)
    state = (rs.randn(b, h, hd, hd) * 0.1).astype(np.float32) if carry \
        else None
    x_last = (rs.randn(b, d) * 0.5).astype(np.float32) if carry else None
    jo, jst, jxl = JL.rwkv_tmix_chunked(
        jcfg, jp, jnp.asarray(x),
        None if state is None else jnp.asarray(state),
        None if x_last is None else jnp.asarray(x_last))
    to, tst, txl = TL.rwkv_tmix_chunked(
        tcfg, tp, _t(x), None if state is None else _t(state),
        None if x_last is None else _t(x_last))
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=TOL)
    np.testing.assert_allclose(tst.numpy(), _np(jst), atol=TOL)
    np.testing.assert_array_equal(txl.numpy(), _np(jxl))


def test_rwkv_tmix_step_and_cmix_match_reference(cfgs):
    jcfg, tcfg = cfgs
    key = jax.random.PRNGKey(6)
    jt, jc = JL.init_rwkv_tmix(jcfg, key), \
        JL.init_rwkv_cmix(jcfg, jax.random.fold_in(key, 1))
    tt, tc = (convert.zoo_params_from_numpy(jax.tree.map(np.asarray, p),
                                            "cpu") for p in (jt, jc))
    b, d = 3, jcfg.d_model
    h, hd = d // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    rs = np.random.RandomState(8)
    x1 = (rs.randn(b, 1, d) * 0.5).astype(np.float32)
    state = (rs.randn(b, h, hd, hd) * 0.1).astype(np.float32)
    xl = (rs.randn(b, d) * 0.5).astype(np.float32)
    jo, jst, _ = JL.rwkv_tmix_step(jcfg, jt, jnp.asarray(x1),
                                   jnp.asarray(state), jnp.asarray(xl))
    to, tst, _ = TL.rwkv_tmix_step(tcfg, tt, _t(x1), _t(state), _t(xl))
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=TOL)
    np.testing.assert_allclose(tst.numpy(), _np(jst), atol=TOL)
    x = _x(9, b, 19, d)
    for last in (None, xl):
        jy, jxl = JL.rwkv_cmix(jcfg, jc, jnp.asarray(x),
                               None if last is None else jnp.asarray(last))
        ty, txl = TL.rwkv_cmix(tcfg, tc, _t(x),
                               None if last is None else _t(last))
        np.testing.assert_allclose(ty.numpy(), _np(jy), atol=TOL)
        np.testing.assert_array_equal(txl.numpy(), _np(jxl))


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms_match_reference(cfgs, norm):
    """`apply_norm` picks the reference's norm from the params' keys."""
    import dataclasses

    jcfg, tcfg = (dataclasses.replace(c, norm=norm) for c in cfgs)
    rs = np.random.RandomState(2)
    x = (rs.randn(4, 7, 256) * 3 + 1).astype(np.float32)
    init = TL.init_norm(tcfg)
    assert set(init) == set(JL.init_norm(jcfg))
    p = {k: (rs.rand(256) + 0.5).astype(np.float32) for k in init}
    want = JL.apply_norm(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.apply_norm(tcfg, convert.tree_map(_t, p), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_train_forward_logits_match_reference(cfgs, model):
    jcfg, tcfg = cfgs
    jp, tp = model
    toks = _tokens(1, 2, 37, jcfg.vocab_size)
    jl, jc, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    tl, tc, aux = TT.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert jc is None and tc is None and float(aux) == 0.0
    assert tl.shape == (2, 37, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL)
    assert float(tl[..., tcfg.vocab_size:].max()) < -1e29


@pytest.mark.parametrize("S", [32, 37])
def test_prefill_and_decode_match_reference(cfgs, model, S):
    """The port's steps (make_prefill_step, make_decode_step) against the
    reference's forward in prefill and decode mode: last-position logits,
    every cache leaf after the prefill, and four decode steps."""
    jcfg, tcfg = cfgs
    jp, tp = model
    b, n = 2, 4
    toks = _tokens(S, b, S + n, jcfg.vocab_size)
    jcache = JT.init_cache(jcfg, b, S + n, dtype=jnp.float32)
    jl, jcache, _ = JT.forward(jcfg, jp, jnp.asarray(toks[:, :S]),
                               mode="prefill", cache=jcache)
    shape = tsteps.InputShape("p", S + n, b, "prefill")
    tlast, tcache = tsteps.make_prefill_step(tcfg, shape, torch.float32)(
        tp, {"tokens": torch.from_numpy(toks[:, :S]).long()})
    np.testing.assert_allclose(tlast.numpy(), _np(jl[:, -1]), atol=TOL)
    for name in ("state", "x_last_t", "x_last_c"):
        assert tcache[name].dtype == torch.float32
        np.testing.assert_allclose(tcache[name].numpy(), _np(jcache[name]),
                                   atol=TOL, err_msg=name)
    decode = tsteps.make_decode_step(tcfg)
    for i in range(n):
        tok = toks[:, S + i:S + i + 1]
        pos = np.full((b,), S + i, np.int32)
        jl, jcache, _ = JT.forward(jcfg, jp, jnp.asarray(tok), mode="decode",
                                   cache=jcache, positions=jnp.asarray(pos))
        tl, tcache = decode(tp, {"tokens": torch.from_numpy(tok).long(),
                                 "positions": torch.from_numpy(pos).long(),
                                 "cache": tcache})
        np.testing.assert_allclose(tl.numpy(), _np(jl[:, 0]), atol=TOL)
        np.testing.assert_allclose(tcache["state"].numpy(),
                                   _np(jcache["state"]), atol=TOL)


def test_decode_matches_full_forward(cfgs, model):
    """tests/test_archs_smoke.py::test_decode_matches_full_forward, on the
    port alone: decode after a prefill of S tokens equals the last
    position of a full forward of S + 1 tokens."""
    _, tcfg = cfgs
    _, tp = model
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(4, b, s + 1, tcfg.vocab_size)).long()
    full, _, _ = TT.forward(tcfg, tp, toks)
    cache = TT.init_cache(tcfg, b, s + 1, dtype=torch.float32)
    _, cache, _ = TT.forward(tcfg, tp, toks[:, :s], mode="prefill",
                             cache=cache)
    dec, _, _ = TT.forward(tcfg, tp, toks[:, s:], mode="decode", cache=cache,
                           positions=torch.full((b,), s))
    np.testing.assert_allclose(dec[:, 0, :tcfg.vocab_size].numpy(),
                               full[:, -1, :tcfg.vocab_size].numpy(),
                               atol=TOL)


def test_prefill_without_cache_returns_the_states(cfgs, model):
    """Prefill mode with no cache stacks each layer's state, as the
    reference does; train mode returns none."""
    jcfg, tcfg = cfgs
    jp, tp = model
    toks = _tokens(6, 2, 20, jcfg.vocab_size)
    _, jc, _ = JT.forward(jcfg, jp, jnp.asarray(toks), mode="prefill")
    _, tc, _ = TT.forward(tcfg, tp, torch.from_numpy(toks).long(),
                          mode="prefill")
    assert set(tc) == set(jc)
    for name in tc:
        np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]), atol=TOL)


def test_decode_launcher_reduced_on_cpu(capsys):
    tdecode.main(["--reduced", "--device", "cpu", "--tokens", "3"])
    out = capsys.readouterr().out
    m = re.search(r"rwkv6-1.6b-smoke on cpu: prefill 2x32 .* 3 decode steps "
                  r"x 2 seqs .* tok/s\); first tokens \[(.*)\]", out)
    assert m, out
    assert len(m.group(1).split(",")) == 4
