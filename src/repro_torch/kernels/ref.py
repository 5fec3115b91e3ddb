"""Plain PyTorch versions of the port's kernels — counterpart of
`repro.kernels.ref` (`dt_loss_fwd_ref`, `wagg_ref`, `q8_encode_ref`,
`q8_decode_ref`).

They define what the CUDA kernels compute. The CPU path of every wrapper
runs them (only because its tensors lie on the CPU), and chip_smoke.py
holds each kernel against them on the card.
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
    sim = q.float() @ k.float().T
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
