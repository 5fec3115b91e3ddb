"""Public wrappers around the port's kernels — counterpart of
`repro.kernels.ops` (`wagg_flat`, `wagg_tree`, `wagg_stacked`, `dt_loss`,
`q8_encode_flat`, `q8_decode_flat`, `rwkv6`).

Each wrapper runs the hand-written CUDA kernel when its tensors lie on a
CUDA device and the plain version (kernels/ref.py) when they lie on the
CPU. There is no other path: a CUDA input the kernel refuses raises, and
a failed build or launch raises too.

* ``wagg_flat(stacked (m, P), w (m,), mask=None)`` — Eq.-11 weighted sum;
  ``wagg_tree(trees, w)`` the same over a list of model trees,
  ``wagg_stacked(stacked_tree, w, mask=None)`` over a stacked tree.
* ``dt_loss(q, k, tau_alpha, tau_beta)`` — mean DT loss, differentiable:
  a `torch.autograd.Function` whose forward is the DT kernel (its wide
  form for 256 < D <= 8192, the zoo's features) and whose
  backward is the plain-torch port of the reference's `_dt_bwd` (the
  reference has no backward kernel either), with the Eq.-6 weight
  treated as a constant. It composes with `torch.func`: under
  `torch.func.vmap` its `vmap` rule sends the batched (C, M, D) q and k
  to ONE launch of the kernel's cohort form (the cohort plain version
  on the CPU), and the backward runs batched.
* ``q8_encode_flat(flat (N, P), ef (N, P))`` and
  ``q8_decode_flat(codes, scales)`` — the blockwise-int8 delta codec
  (one float32 scale per BQ = 256 columns), P zero-padded to a multiple
  of BQ as the reference's wrappers pad it.
* ``rwkv6(r, k, v, logw, u, state0=None)`` — the RWKV6 recurrence for
  any S >= 1 (the CUDA kernel steps it with the state in registers; the
  plain version is chunked, CHUNK = 16), returning the true state after
  S steps (`ref.rwkv6_ref`'s, not the reference wrapper's decayed one);
  ``rwkv6_plain`` is its plain version on any device. Differentiable:
  a `torch.autograd.Function` whose forward is the kernel and whose
  backward differentiates the plain chunked form with every chunk at
  once (`ref.rwkv6_chunked_parallel`); the reference has no backward
  kernel.

`launch_counts()` reads every kernel's launch counter (each wrapper adds
one where it launches its kernel); `add_launches` is for whoever replays
a CUDA graph, which runs the launches its capture recorded without
calling the wrappers (core/engine.py).
"""
from __future__ import annotations

import torch

from repro_torch.convert import (flat_spec, leaves_with_paths, ravel_into,
                                 tree_map, unflatten, unravel)
from repro_torch.kernels import ref
from repro_torch.kernels import dt_loss as _dt_kernel
from repro_torch.kernels import qdelta as _q8_kernel
from repro_torch.kernels import rwkv6 as _rwkv6_kernel
from repro_torch.kernels import wagg as _wagg_kernel
from repro_torch.kernels.qdelta import BQ
from repro_torch.models.sharding_hooks import is_dtensor


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel name."""
    return {"wagg": _wagg_kernel.LAUNCHES, "dt_loss": _dt_kernel.LAUNCHES,
            "dt_loss_wide": _dt_kernel.WIDE_LAUNCHES,
            "q8_encode": _q8_kernel.ENCODE_LAUNCHES,
            "q8_decode": _q8_kernel.DECODE_LAUNCHES,
            "rwkv6": _rwkv6_kernel.LAUNCHES}


def add_launches(counts: dict) -> None:
    """Add `counts` (kernel name -> launches, as `launch_counts` names
    them) to the counters. A graph replay adds what its capture recorded;
    a capture takes its own calls back (they recorded the launches, they
    did not run them)."""
    # analysis: allow=purity-global-mutation -- the launch counters
    _wagg_kernel.LAUNCHES += counts.get("wagg", 0)
    _dt_kernel.LAUNCHES += counts.get("dt_loss", 0)
    _dt_kernel.WIDE_LAUNCHES += counts.get("dt_loss_wide", 0)
    _rwkv6_kernel.LAUNCHES += counts.get("rwkv6", 0)
    with _q8_kernel._COUNT_LOCK:
        _q8_kernel.ENCODE_LAUNCHES += counts.get("q8_encode", 0)
        _q8_kernel.DECODE_LAUNCHES += counts.get("q8_decode", 0)


def _on_cuda(*ts) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        return False
    raise ValueError(f"inputs must all lie on one CUDA device or all on the "
                     f"CPU, got {sorted(devs)}")


def wagg_flat(stacked: torch.Tensor, w: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """stacked (m, P) x w (m,) -> (P,) float32; `mask` (m,) zeroes rows
    (padding rows of a bucketed cohort) inside the kernel."""
    if _on_cuda(stacked, w, mask):
        return _wagg_kernel.wagg_cuda(stacked, w, mask)
    return ref.wagg_ref(stacked, w, mask)


def _unravel_like(out: torch.Tensor, like) -> dict:
    """(P,) float32 -> `like`'s structure, shapes and leaf dtypes."""
    leaves = leaves_with_paths(like)
    got = leaves_with_paths(unravel(out, flat_spec(like)))
    return unflatten([x.to(l.dtype) for (_, x), (_, l) in zip(got, leaves)],
                     like)


def wagg_tree(trees, w) -> dict:
    """Weighted sum of a list of model trees (the list-API boundary):
    each tree raveled into a row of one (n, P) float32 buffer, then
    `wagg_flat`, and the (P,) result in the first tree's structure,
    each leaf cast back to its dtype."""
    spec = flat_spec(trees[0])
    first = leaves_with_paths(trees[0])[0][1]
    stacked = torch.empty((len(trees), spec.size), dtype=torch.float32,
                          device=first.device)
    for row, tree in zip(stacked, trees):
        ravel_into(tree, row, spec)
    # analysis: allow=retrace-fresh-array -- the list boundary's n weights
    w = torch.as_tensor(w, dtype=torch.float32, device=stacked.device)
    return _unravel_like(wagg_flat(stacked, w), trees[0])


def wagg_stacked(stacked_tree, w, mask=None) -> dict:
    """Weighted sum over the leading cohort axis of a stacked tree (every
    leaf (N, ...)): the leaves raveled into one (N, P) float32 matrix,
    one `wagg_flat` (`mask` zeroes rows), and the (P,) result in one
    row's structure and leaf dtypes."""
    leaves = [t for _, t in leaves_with_paths(stacked_tree)]
    n = leaves[0].shape[0]
    flat = torch.cat([t.reshape(n, -1).float() for t in leaves], dim=1)
    # analysis: allow=retrace-fresh-array -- float32 at the kernel boundary
    w = torch.as_tensor(w, dtype=torch.float32, device=flat.device)
    return _unravel_like(wagg_flat(flat, w, mask),
                         tree_map(lambda t: t[0], stacked_tree))


def dt_loss_fwd(q: torch.Tensor, k: torch.Tensor, tau_alpha: float,
                tau_beta: float):
    """(loss_vec, lse_a, lse_b, pos), each (M,) float32 for (M, D) q and
    k; each (C, M) for a cohort (C, M, D), in one launch on the card."""
    if _on_cuda(q, k):
        return _dt_kernel.dt_loss_fwd_cuda(q, k, tau_alpha, tau_beta)
    if q.dim() == 3:
        return ref.dt_loss_fwd_cohort_ref(q, k, tau_alpha, tau_beta)
    return ref.dt_loss_fwd_ref(q, k, tau_alpha, tau_beta)


class _DTLoss(torch.autograd.Function):
    """(mean loss, lse_a, lse_b, pos); only the loss is differentiable.
    The three statistics are outputs so that the backward may save them
    (the `setup_context` form, which `torch.func` needs)."""

    @staticmethod
    def forward(q, k, tau_alpha, tau_beta):
        loss_vec, lse_a, lse_b, pos = dt_loss_fwd(q, k, tau_alpha, tau_beta)
        return loss_vec.mean(), lse_a, lse_b, pos

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, tau_alpha, tau_beta = inputs
        _, lse_a, lse_b, pos = output
        ctx.mark_non_differentiable(lse_a, lse_b, pos)
        ctx.save_for_backward(q, k, lse_a, lse_b, pos)
        ctx.taus = (tau_alpha, tau_beta)

    @staticmethod
    def vmap(info, in_dims, q, k, tau_alpha, tau_beta):
        """The cohort: q and k batched over clients (any vmap levels
        folded into one leading C) -> one `dt_loss_fwd` of (C, M, D)."""
        def cohort(t, dim):
            t = (t.expand(info.batch_size, *t.shape) if dim is None
                 else t.movedim(dim, 0))
            return t.reshape(-1, *t.shape[-2:]).contiguous(), t.shape[:-2]

        (q3, lead), (k3, _) = cohort(q, in_dims[0]), cohort(k, in_dims[1])
        loss_vec, lse_a, lse_b, pos = dt_loss_fwd(q3, k3, tau_alpha,
                                                  tau_beta)
        outs = (loss_vec.mean(-1).reshape(lead),
                *(t.reshape(*lead, -1) for t in (lse_a, lse_b, pos)))
        return outs, (0, 0, 0, 0)

    @staticmethod
    def backward(ctx, g, _lse_a, _lse_b, _pos):
        """d/dq, d/dk of mean_i [-w_i (pos_i/ta - lse_a_i)] with w_i held
        constant (stop-gradient, Eq. 6): dL/dsim_ij = w_i/(ta M) (p_a_ij -
        delta_ij). Materialises the (M, M) matrix, as the reference does."""
        q, k, lse_a, lse_b, pos = ctx.saved_tensors
        ta, tb = ctx.taus
        m = q.shape[0]
        qf, kf = q.float(), k.float()
        sim = qf @ kf.T
        log_pa = pos / ta - lse_a
        w_a = 1.0 - torch.exp(log_pa)
        w_b = 1.0 - torch.exp(pos / tb - lse_b)
        weight = w_b / torch.clamp(w_a, min=1e-8)
        p_a = torch.exp(sim / ta - lse_a[:, None])
        coef = (g * weight / (ta * m))[:, None]
        dsim = coef * (p_a - torch.eye(m, dtype=torch.float32,
                                       device=q.device))
        dq = (dsim @ kf).to(q.dtype)
        dk = (dsim.T @ qf).to(k.dtype)
        return dq, dk, None, None


def dt_loss(q: torch.Tensor, k: torch.Tensor, tau_alpha: float = 0.1,
            tau_beta: float = 1.0) -> torch.Tensor:
    """Mean dual-temperature loss over in-batch similarities (fused)."""
    return _DTLoss.apply(q, k, tau_alpha, tau_beta)[0]


def _pad_cols(x: torch.Tensor, multiple: int):
    p = x.shape[1]
    pad = (-p) % multiple
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, p


def q8_encode_flat(flat: torch.Tensor, ef: torch.Tensor):
    """Blockwise-int8 encode of an (N, P) float32 delta matrix with its
    (N, P) error-feedback residual. Returns (codes (N, P) int8, scales
    (N, ceil(P / BQ)) float32, new_ef (N, P) float32); semantics of
    `ref.q8_encode_ref` on the zero-padded matrix. (The reference's
    interpret path keeps P // BQ scales; the codecs always pass
    P % BQ == 0, where the two agree.)"""
    x, p = _pad_cols(flat, BQ)
    e, _ = _pad_cols(ef, BQ)
    if _on_cuda(x, e):
        codes, scales, new_ef = _q8_kernel.q8_encode_cuda(x.contiguous(),
                                                          e.contiguous())
    else:
        codes, scales, new_ef = ref.q8_encode_ref(x, e, block=BQ)
    return codes[:, :p], scales, new_ef[:, :p]


def q8_decode_flat(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N, P) int8 codes with (N, ceil(P / BQ)) float32 scales -> (N, P)
    float32 (semantics of `ref.q8_decode_ref`)."""
    c, p = _pad_cols(codes, BQ)
    if tuple(scales.shape) != (c.shape[0], c.shape[1] // BQ):
        raise ValueError(f"q8: scales {tuple(scales.shape)} do not match "
                         f"codes {tuple(codes.shape)} (one per {BQ} columns)")
    if _on_cuda(c, scales):
        out = _q8_kernel.q8_decode_cuda(c.contiguous(), scales.contiguous())
    else:
        out = ref.q8_decode_ref(c, scales, block=BQ)
    return out[:, :p]


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          logw: torch.Tensor, u: torch.Tensor,
          state0: torch.Tensor | None = None):
    """RWKV6 recurrence S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T), for any S >= 1.

    r, k, v, logw: (BH, S, D) float32 with u (BH, D) or (D,) and state0
    (BH, D, D) or None (zeros); or (B, S, H, D) with u (H, D) or (D,) and
    state0 (B, H, D, D). Returns (o in the input's layout, state (BH, D, D)
    or (B, H, D, D)), float32. Semantics of `ref.rwkv6_ref`.

    Differentiable: where an input requires a gradient, the call goes
    through `_RWKV6`, whose forward is this same call and whose backward
    differentiates the plain chunked form (`ref.rwkv6_chunked_parallel`).
    Without gradients (prefill) nothing is saved.

    Plain tensors only: a DTensor argument (a mesh step) raises
    TypeError, since neither the launch nor the plain version reads a
    DTensor's shards; `models.layers.rwkv6_on_shards` runs it on each
    rank's (batch, head) shards."""
    if any(is_dtensor(t) for t in (r, k, v, logw, u, state0)):
        raise TypeError("ops.rwkv6 takes plain tensors, got a DTensor: on a "
                        "mesh call models.layers.rwkv6_on_shards, which "
                        "launches it on each rank's (batch, head) shards")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, logw, u, state0)):
        return _RWKV6.apply(r, k, v, logw, u, state0)
    return _rwkv6_forward(r, k, v, logw, u, state0)


def _rwkv6_forward(r, k, v, logw, u, state0):
    """The kernel on the card, the plain chunked version on the CPU."""
    if _on_cuda(r, k, v, logw, u, state0):
        return _rwkv6_kernel.rwkv6_cuda(r, k, v, logw, u, state0)
    return rwkv6_plain(r, k, v, logw, u, state0)


class _RWKV6(torch.autograd.Function):
    """`rwkv6` with a gradient. The forward runs without a graph (the
    kernel on the card) and saves its six inputs; the backward recomputes
    the chunked form (`ref.rwkv6_chunked_parallel`, CHUNK = 16, all
    chunks at once) with a graph and differentiates it. The reference has
    no backward kernel either: its gradient is the autodiff of its jnp
    chunked scan. The same code runs on both devices."""

    @staticmethod
    def forward(r, k, v, logw, u, state0):
        return _rwkv6_forward(r, k, v, logw, u, state0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g_o, g_state):
        inputs = ctx.saved_tensors
        want = [i for i, t in enumerate(inputs)
                if t is not None and ctx.needs_input_grad[i]]
        grads = [None] * len(inputs)
        outs = [(i, g) for i, g in enumerate((g_o, g_state))
                if g is not None]
        if not want or not outs:
            return tuple(grads)
        with torch.enable_grad(), \
                torch.profiler.record_function("rwkv6.recompute"):
            leaves = [t.detach().requires_grad_(i in want) if t is not None
                      else None for i, t in enumerate(inputs)]
            out = rwkv6_plain(*leaves, fn=ref.rwkv6_chunked_parallel)
            got = torch.autograd.grad([out[i] for i, _ in outs],
                                      [leaves[i] for i in want],
                                      [g for _, g in outs],
                                      allow_unused=True)
        for i, g in zip(want, got):
            grads[i] = g
        return tuple(grads)


def rwkv6_plain(r, k, v, logw, u, state0=None, fn=ref.rwkv6_chunked_ref):
    """`rwkv6` through the plain chunked version (`ref.rwkv6_chunked_ref`,
    or `fn` of the same signature on (BH, S, D) rows) on whatever device
    the tensors lie on: the CPU path of `rwkv6`, and what chip_smoke.py
    holds the kernel against on the card. Differentiable by autograd."""
    b, h, s, d = _rwkv6_kernel.geometry(r)
    if r.dim() == 3:
        return fn(r, k, v, logw, u, state0)

    def rows(t):
        return t.transpose(1, 2).reshape(b * h, s, d)

    u_rows = u.float().expand(h, d).repeat(b, 1)
    st0 = None if state0 is None else state0.reshape(b * h, d, d)
    o, st = fn(rows(r), rows(k), rows(v), rows(logw), u_rows, st0)
    return (o.reshape(b, h, s, d).transpose(1, 2).contiguous(),
            st.reshape(b, h, d, d))
