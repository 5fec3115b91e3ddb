"""The port's dense zoo family in training against the JAX reference, on
the CPU: the flash attention Function's gradients against `jax.grad`
through the reference's `custom_vjp`, and `make_train_step` (``lm`` and
``dt``) against the reference's own step.

The reference's step runs jitted under the one-device mesh with
``AxisType.Auto`` axes of tests/test_torch_train.py (the `mesh`
fixture, whose docstring says why), and the DT objective's drop masks
are the reference's `PRNGKey(0)` draws replayed into the port's step
(`_ref_drops`). Weights are the reference's, carried across with
`convert.zoo_params_from_numpy`.

Tolerances, both sides float32: gradients of the flash path within
GRAD_REL of each gradient's largest magnitude (the score tiles are
products over 64 and sums over up to 2048 keys, taken in other orders;
2e-6 is the largest seen); losses within LOSS_REL relative and every
parameter and momentum leaf within LEAF_REL of its largest magnitude,
as in tests/test_torch_train.py. The ``dt`` step widens both by
2^-24 / tau_a / min(w_a) (`_dt_widening`): with random weights the two
views' features nearly coincide, so each row's positive takes nearly all
of the softmax at tau_a and the loss's w_a = 1 - p_a(pos) cancels to a
few 1e-4. Its logits pos / tau_a and lse_a are of order 1 / tau_a = 10,
where one float32 rounding is 2^-24 / tau_a absolute; p_a = exp(pos /
tau_a - lse_a) carries that as a relative error, and w_a as that over
w_a, which the loss and its gradient inherit.

    PYTHONPATH=src python -m pytest tests/test_torch_dense_train.py
"""
from __future__ import annotations

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
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tst
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_round import torch_threads  # noqa: F401 (autouse)
from test_torch_train import (LEAF_REL, LOSS_REL, _blur, _leaf_err,
                              _ref_drops, _tree_errs, mesh)  # noqa: F401

GRAD_REL = 1e-5


def _dt_widening(tcfg, tp, batch, n_micro) -> float:
    """2^-24 / tau_a / min(w_a) over the micro-batches of a ``dt`` batch
    (tau_a = 0.1), w_a = 1 - p_a(pos) from the port's own features of the
    two views."""
    w_min = 1.0
    with torch.no_grad():
        for toks, d in zip(batch["tokens"].chunk(n_micro),
                           batch["drops"].chunk(n_micro, dim=1)):
            q, k = (TT.forward_features(tcfg, tp, torch.where(
                m, tst.MASK_TOKEN, toks))[0] for m in d)
            _, lse_a, _, pos = ref.dt_loss_fwd_ref(q, k, 0.1, 1.0)
            w_min = min(w_min, float((1 - torch.exp(pos / 0.1 - lse_a))
                                     .min()))
    return 2.0 ** -24 / 0.1 / w_min


def _flash_inputs(seed, b, sq, sk, kh, g, d):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, kh, g, d).astype(np.float32)
    k = rs.randn(b, sk, kh, d).astype(np.float32)
    v = rs.randn(b, sk, kh, d).astype(np.float32)
    go = rs.randn(b, sq, kh, g, d).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(sk - sq, sk), (b, sq)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(sk), (b, sk)).astype(np.int32).copy()
    kv_pos[:, -3:] = -1                                  # empty slots
    return q, k, v, go, q_pos, kv_pos


@pytest.mark.parametrize("sq,sk,chunk,window,softcap", [
    (2048, 2048, 1024, JL.BIG_WINDOW, 0.0),     # attention_core's path
    (2048, 2048, 1024, 300, 50.0),
    (96, 256, 64, JL.BIG_WINDOW, 50.0),         # more chunks, a longer cache
    (96, 256, 64, 40, 0.0),
])
def test_flash_gradients_match_jax_grad(sq, sk, chunk, window, softcap):
    """q, k and v gradients of <out, go> through the port's Function
    against `jax.grad` through the reference's `flash_attention` (its
    custom VJP), with and without the softcap and a window; the forward
    too."""
    q, k, v, go, q_pos, kv_pos = _flash_inputs(sq + sk + int(softcap), 1,
                                               sq, sk, 2, 2, 64)
    scale = 1.0 / 8

    def jloss(q, k, v):
        o = JL.flash_attention(q, k, v, jnp.asarray(q_pos, jnp.float32),
                               jnp.asarray(kv_pos, jnp.float32),
                               jnp.float32(window), True, scale, softcap,
                               chunk)
        return jnp.sum(o * go), o

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out = TL.flash_attention(*leaves, torch.from_numpy(q_pos.astype(np.int64)),
                             torch.from_numpy(kv_pos.astype(np.int64)),
                             window, True, scale, softcap, chunk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=2e-5, rtol=0)
    got = torch.autograd.grad((out * torch.from_numpy(go)).sum(), leaves)
    for name, a, b in zip("qkv", got, j_grads):
        assert _leaf_err(a, b) <= GRAD_REL, name


def test_flash_function_keeps_dtypes_and_records_no_graph_without_grad():
    """bfloat16 in, bfloat16 out and bfloat16 gradients (float32 inside);
    under no_grad the output has no grad_fn."""
    q, k, v, go, q_pos, kv_pos = _flash_inputs(1, 1, 64, 128, 2, 2, 16)
    bf = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in (q, k, v)]
    pos = (torch.from_numpy(q_pos.astype(np.int64)),
           torch.from_numpy(kv_pos.astype(np.int64)))
    out = TL.flash_attention(*bf, *pos, JL.BIG_WINDOW, True, 0.25, 0.0, 64)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), bf)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    with torch.no_grad():
        out = TL.flash_attention(*bf, *pos, JL.BIG_WINDOW, True, 0.25, 0.0,
                                 64)
    assert out.grad_fn is None


@pytest.mark.parametrize("arch,objective,b,s,n_micro", [
    ("tinyllama-1.1b", "lm", 2, 2048, 2),   # the flash path and its backward
    ("gemma2-27b", "lm", 4, 40, 2),         # softcaps, post-norms, a window
    ("qwen2-0.5b", "dt", 8, 24, 1),         # qkv bias, tied embeddings
    ("deepseek-67b", "dt", 8, 24, 2),
])
def test_train_step_matches_reference(mesh, arch, objective, b, s, n_micro):
    """One `make_train_step` step (flsimco, sgdm) against the reference's,
    from the reference's params: the loss, then every parameter and
    momentum leaf."""
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch + "-smoke")
    np_p = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(5)))
    kw = dict(objective=objective, n_micro=n_micro)
    jfn, _ = jst.make_train_step(jcfg, JShape("t", s, b, "train"), mesh,
                                 **kw)
    tfn, _ = tst.make_train_step(tcfg, InputShape("t", s, b, "train"), **kw)
    toks = np.random.RandomState(s).randint(1, jcfg.vocab_size,
                                            (b, s)).astype(np.int32)
    blur = _blur(s, b)
    with compat.set_mesh(mesh):
        jp, jm, jmet = jax.jit(jfn)(np_p, jst.init_momentum(np_p),
                                    {"tokens": jnp.asarray(toks),
                                     "blur": jnp.asarray(blur)})
    tp = convert.zoo_params_from_numpy(np_p, "cpu")
    batch = {"tokens": torch.from_numpy(toks.astype(np.int64)),
             "blur": torch.from_numpy(blur)}
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


@pytest.mark.parametrize("d", [896, 4608, 8192])
def test_dt_loss_at_the_dense_widths_matches_reference(d):
    """The DT loss the ``dt`` objective takes at d_model = 896 (qwen2),
    4608 (gemma2) and 8192 (deepseek): the port's `ops.dt_loss` on the
    CPU (the plain version of the kernel's wide form) and its gradients
    against the reference's `dt_loss_matrix` and `jax.grad` of it, on
    unit rows of a micro-batch of 8."""
    from repro.core.dt_loss import dt_loss_matrix
    rs = np.random.RandomState(d)
    q, k = (rs.randn(8, d).astype(np.float32) for _ in range(2))
    q, k = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (q, k))
    want, (gq, gk) = jax.value_and_grad(
        lambda a, b: dt_loss_matrix(a, b, 0.1, 1.0), argnums=(0, 1))(q, k)
    tq, tk = (torch.from_numpy(x).requires_grad_() for x in (q, k))
    got = ops.dt_loss(tq, tk, 0.1, 1.0)
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    for a, b in zip(torch.autograd.grad(got, (tq, tk)), (gq, gk)):
        assert _leaf_err(a, b) <= LEAF_REL
