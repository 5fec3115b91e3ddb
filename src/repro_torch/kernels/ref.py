"""Plain PyTorch versions of the port's kernels — counterpart of
`repro.kernels.ref` (`dt_loss_fwd_ref`, its mean `dt_loss_ref` and
its cohort form `dt_loss_fwd_cohort_ref`, `wagg_ref`, `q8_encode_ref`,
`q8_decode_ref`, `rwkv6_ref`).

They define what the CUDA kernels compute. The CPU path of every wrapper
runs them (only because its tensors lie on the CPU), and chip_smoke.py
holds each kernel against them on the card. For RWKV6 there are two:
`rwkv6_ref`, the reference's token-by-token oracle, and
`rwkv6_chunked_ref`, the chunked form the kernel computes (the
reference layer's `chunk_body`), which is the plain version. A third,
`rwkv6_chunked_parallel`, computes the chunked form with every chunk at
once: the backward of `ops.rwkv6` differentiates it.
"""
from __future__ import annotations

import numpy as np
import torch

_INV127 = float(np.float32(1.0 / 127.0))   # the float32 the kernels use


def dt_loss_fwd_ref(q: torch.Tensor, k: torch.Tensor, tau_alpha: float,
                    tau_beta: float):
    """Returns (loss_vec (M,), lse_a (M,), lse_b (M,), pos (M,)).

    loss_i = -sg[(1-softmax_b(pos))/(1-softmax_a(pos))] * log softmax_a(pos)
    over the in-batch similarity row sim_i = q_i @ k^T (positive = diag).
    """
    return dt_loss_from_sim(q.float() @ k.float().T, tau_alpha, tau_beta)


def dt_loss_ref(q: torch.Tensor, k: torch.Tensor, tau_alpha: float = 0.1,
                tau_beta: float = 1.0) -> torch.Tensor:
    """The mean of `dt_loss_fwd_ref`'s per-row losses."""
    return dt_loss_fwd_ref(q, k, tau_alpha, tau_beta)[0].mean()


def dt_loss_fwd_cohort_ref(q: torch.Tensor, k: torch.Tensor,
                           tau_alpha: float, tau_beta: float):
    """The cohort form: q, k (C, M, D) -> four (C, M), row c from q[c] and
    k[c] alone through `dt_loss_fwd_ref` (so each is bitwise the
    unbatched call)."""
    outs = [dt_loss_fwd_ref(qc, kc, tau_alpha, tau_beta)
            for qc, kc in zip(q, k)]
    return tuple(torch.stack(x) for x in zip(*outs))


def dt_loss_from_sim(sim: torch.Tensor, tau_alpha: float, tau_beta: float):
    """`dt_loss_fwd_ref` from its (M, M) similarity, in sim's dtype."""
    pos = torch.diagonal(sim)
    lse_a = torch.logsumexp(sim / tau_alpha, dim=-1)
    lse_b = torch.logsumexp(sim / tau_beta, dim=-1)
    log_pa = pos / tau_alpha - lse_a
    w_a = 1.0 - torch.exp(log_pa)
    w_b = 1.0 - torch.exp(pos / tau_beta - lse_b)
    weight = w_b / torch.clamp(w_a, min=1e-8)
    return -weight * log_pa, lse_a, lse_b, pos


def wagg_ref(stacked: torch.Tensor, w: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """stacked (m, P) x w (m,) [x mask (m,)] -> (P,) float32.

    Accumulates in ascending row order from +0.0, as the kernel does, so a
    masked call with zero-weight padding rows is bitwise equal to the
    unpadded call (each padding row adds an exact +0.0)."""
    w = w.float() if mask is None else w.float() * mask.float()
    # analysis: allow=retrace-fresh-array -- the output's accumulator,
    # made on the input's device
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for n in range(stacked.shape[0]):
        acc = acc + w[n] * stacked[n].float()
    return acc


def q8_encode_ref(flat: torch.Tensor, ef: torch.Tensor, block: int = 256):
    """Blockwise symmetric int8 quantization with error feedback.

    flat, ef: (N, P) float32 with P % block == 0. y = flat + ef; each
    length-`block` slice of a row gets the scale max|y| * f32(1/127) (a
    multiply, as the reference's); codes are round-half-even in
    [-127, 127]; an all-zero block takes scale 0 and decodes to exact
    zeros. Returns (codes int8 (N, P), scales float32 (N, P / block),
    new_ef = y - codes * scales float32 (N, P)), each step rounded once,
    as the CUDA kernel does.
    """
    n, p = flat.shape
    y = (flat + ef).reshape(n, p // block, block)
    scales = torch.amax(y.abs(), dim=-1) * _INV127
    inv = torch.where(scales > 0, 1.0 / scales, 0.0)
    codes = torch.clamp(torch.round(y * inv[..., None]), -127.0, 127.0)
    codes = codes.to(torch.int8)
    new_ef = y - codes.float() * scales[..., None]
    return codes.reshape(n, p), scales, new_ef.reshape(n, p)


def q8_decode_ref(codes: torch.Tensor, scales: torch.Tensor,
                  block: int = 256) -> torch.Tensor:
    """(N, P) int8 codes x (N, P / block) float32 scales -> (N, P)
    float32, the inverse of `q8_encode_ref` up to its quantization error."""
    n, p = codes.shape
    out = codes.reshape(n, p // block, block).float() * scales[..., None]
    return out.reshape(n, p)


RWKV_CHUNK = 16     # the reference's CHUNK (kernels/rwkv6.py, models/layers.py)


def _rwkv_inputs(r, k, v, logw, u, state0):
    bh, _, d = r.shape
    u = u.float().expand(bh, d) if u.dim() == 1 else u.float()
    st = (torch.zeros((bh, d, d), dtype=torch.float32, device=r.device)
          if state0 is None else state0.float())
    return (r.float(), k.float(), v.float(), logw.float(), u, st)


def rwkv6_ref(r, k, v, logw, u, state0=None):
    """Sequential oracle. r, k, v, logw: (BH, S, D); u: (D,) or (BH, D);
    state0: (BH, D, D) or None (zeros).

    S_t = diag(w_t) S_{t-1} + k_t v_t^T ; o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
    with w_t = exp(logw_t). Returns (o (BH, S, D), state (BH, D, D)), float32.
    """
    r, k, v, logw, u, st = _rwkv_inputs(r, k, v, logw, u, state0)
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bd,bde->be", r[:, t], st + u[..., None] * kv))
        st = st * torch.exp(logw[:, t])[..., None] + kv
    return torch.stack(outs, 1), st


def rwkv6_chunked_ref(r, k, v, logw, u, state0=None, chunk: int = RWKV_CHUNK):
    """The recurrence of `rwkv6_ref` in chunks of `chunk` steps — the
    reference's `rwkv_tmix_chunked.chunk_body` for one (batch*head) row
    layout, with the state carried from chunk to chunk.

    Within a chunk, with cum = cumsum(logw) and cum_prev = cum - logw:
      o_i = (r_i exp(cum_prev_i)) S0 + sum_{j<i} scores_ij v_j + (r_i u k_i) v_i,
      scores_ij = sum_d r_id k_jd exp(cum_prev_id - cum_jd),
      S_end = diag(exp(cum_C)) S0 + sum_j diag(exp(cum_C - cum_j)) k_j v_j^T,
    every exponent taken after the subtraction (so <= 0 where used).

    Any S >= 1: a ragged last chunk is padded with r = k = v = 0 and
    logw = 0 (no decay), which leaves o's first S rows and the state
    exactly those of S steps — unlike the reference wrapper
    `repro.kernels.ops.rwkv6`, which pads logw with -1e-4 and so decays
    the returned state once per padded step.
    """
    r, k, v, logw, u, st = _rwkv_inputs(r, k, v, logw, u, state0)
    bh, s, d = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                         for t in (r, k, v, logw))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)[..., None]
    outs = []
    for c0 in range(0, s + pad, chunk):
        rc, kc, vc, lwc = (t[:, c0:c0 + chunk] for t in (r, k, v, logw))
        cum = torch.cumsum(lwc, dim=1)
        cum_prev = cum - lwc
        o = torch.bmm(rc * torch.exp(cum_prev), st)
        dec = torch.exp(cum_prev[:, :, None] - cum[:, None])   # (BH, C, C, D)
        scores = (rc[:, :, None] * kc[:, None]
                  * torch.where(tri, dec, 0.0)).sum(-1)
        o = o + torch.bmm(scores, vc)
        o = o + (rc * u[:, None] * kc).sum(-1, keepdim=True) * vc
        total = cum[:, -1]
        kdec = kc * torch.exp(total[:, None] - cum)
        st = st * torch.exp(total)[..., None] + torch.bmm(kdec.transpose(1, 2),
                                                          vc)
        outs.append(o)
    return torch.cat(outs, 1)[:, :s], st


def chunk_carry(log_decay, inc, state0):
    """The states after each step of S_c = diag(exp(log_decay_c)) S_{c-1}
    + inc_c from S_0 = state0, all steps at once.

    log_decay (BH, n, D) <= 0, inc (BH, n, D, E), state0 (BH, D, E) ->
    (BH, n, D, E). The steps go in groups of RWKV_CHUNK: within a group,
    step c takes sum_{j <= c} exp(lam_c - lam_j) inc_j (lam the group's
    prefix sum of log_decay; each exponent taken after the subtraction,
    so <= 0) plus exp(lam_c) times the state the group starts from, and
    the groups' own states come from the same rule one level up (a
    recursion of depth log_16(n)). Sums in another order than a
    step-by-step loop, to float32 rounding."""
    bh, n, d = log_decay.shape
    e = inc.shape[-1]
    g = min(RWKV_CHUNK, n)
    pad = (-n) % g
    if pad:   # no decay and no increment past the end
        log_decay = torch.nn.functional.pad(log_decay, (0, 0, 0, pad))
        inc = torch.nn.functional.pad(inc, (0, 0, 0, 0, 0, pad))
    nb = (n + pad) // g
    lam = torch.cumsum(log_decay.reshape(bh, nb, g, d), dim=2)
    tri = torch.tril(torch.ones((g, g), dtype=torch.bool,
                                device=lam.device))[..., None]
    diff = torch.where(tri, lam[:, :, :, None] - lam[:, :, None], 0.0)
    w = torch.where(tri, torch.exp(diff), 0.0)          # (BH, nb, g, g, D)
    # local_c = sum_j w_cj * inc_j, one (g, g) @ (g, E) product per D row
    local = torch.matmul(w.permute(0, 1, 4, 2, 3),
                         inc.reshape(bh, nb, g, d, e).transpose(2, 3))
    local = local.transpose(2, 3)                       # (BH, nb, g, D, E)
    if nb == 1:
        start = state0[:, None]
    else:
        ends = chunk_carry(lam[:, :, -1], local[:, :, -1], state0)
        start = torch.cat([state0[:, None], ends[:, :-1]], 1)
    states = torch.exp(lam)[..., None] * start[:, :, None] + local
    return states.reshape(bh, nb * g, d, e)[:, :n]


def rwkv6_chunked_parallel(r, k, v, logw, u, state0=None):
    """`rwkv6_chunked_ref` with every chunk at once: the same terms in a
    (BH, n_chunks, C, ...) layout, and the state entering each chunk from
    `chunk_carry` in place of a loop over the chunks. A few hundred
    operations for any S, where the loop takes about ten a chunk; equal
    to `rwkv6_chunked_ref` to float32 rounding. The backward of
    `ops.rwkv6` differentiates it."""
    r, k, v, logw, u, st = _rwkv_inputs(r, k, v, logw, u, state0)
    bh, s, d = r.shape
    chunk = RWKV_CHUNK
    pad = (-s) % chunk
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                         for t in (r, k, v, logw))
    n = (s + pad) // chunk
    rc, kc, vc, lw = (t.reshape(bh, n, chunk, d) for t in (r, k, v, logw))
    cum = torch.cumsum(lw, dim=2)
    cum_prev = cum - lw
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)[..., None]
    diff = torch.where(tri, cum_prev[:, :, :, None] - cum[:, :, None], 0.0)
    dec = torch.where(tri, torch.exp(diff), 0.0)       # (BH, n, C, C, D)
    scores = (rc[:, :, :, None] * kc[:, :, None] * dec).sum(-1)
    o = torch.matmul(scores, vc)
    o = o + (rc * u[:, None, None] * kc).sum(-1, keepdim=True) * vc
    total = cum[:, :, -1]                               # (BH, n, D)
    kdec = kc * torch.exp(total[:, :, None] - cum)
    after = chunk_carry(total, torch.matmul(kdec.transpose(2, 3), vc), st)
    before = torch.cat([st[:, None], after[:, :-1]], 1)
    o = o + torch.matmul(rc * torch.exp(cum_prev), before)
    return o.reshape(bh, n * chunk, d)[:, :s], after[:, -1]
