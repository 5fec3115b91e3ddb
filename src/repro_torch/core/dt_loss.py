"""Dual-Temperature (DT) contrastive loss, plain torch — FLSimCo Eq. (6)-(8).

Counterpart of `repro.core.dt_loss` (`dt_loss_matrix`, `dt_loss`,
`info_nce_loss`). Per anchor i:

    L_i = -sg[ W_beta_i / W_alpha_i ] * log p_alpha_i(pos),
    W_tau_i = 1 - softmax_tau(logits_i)[pos].

The port's client trains through the fused `kernels.ops.dt_loss`; these
plain versions are its oracle (tests, chip_smoke.py) and what autograd
differentiates on the reference side of a comparison.
"""
from __future__ import annotations

import torch

DEFAULT_TAU_ALPHA = 0.1
DEFAULT_TAU_BETA = 1.0


def _dt_from_logits(logits, pos_index, tau_alpha, tau_beta):
    """logits: (B, 1+K) raw similarities, positive at column `pos_index`.
    Returns the per-anchor loss vector (B,)."""
    log_pa = torch.log_softmax(logits / tau_alpha, dim=-1)
    pb = torch.softmax(logits / tau_beta, dim=-1)
    idx = pos_index[:, None]
    log_pos_a = torch.gather(log_pa, -1, idx)[:, 0]
    w_alpha = 1.0 - torch.exp(log_pos_a)                     # Eq. (8)
    w_beta = 1.0 - torch.gather(pb, -1, idx)[:, 0]           # Eq. (7)
    weight = (w_beta / torch.clamp(w_alpha, min=1e-8)).detach()
    return -weight * log_pos_a                               # Eq. (6)


def dt_loss(q, k_pos, k_neg, tau_alpha=DEFAULT_TAU_ALPHA,
            tau_beta=DEFAULT_TAU_BETA):
    """Explicit-negative form. q, k_pos: (B,D); k_neg: (K,D) shared."""
    pos = (q * k_pos).sum(dim=-1, keepdim=True)
    logits = torch.cat([pos, q @ k_neg.T], dim=-1).float()
    pos_index = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    return _dt_from_logits(logits, pos_index, tau_alpha, tau_beta).mean()


def dt_loss_matrix(q, k, tau_alpha=DEFAULT_TAU_ALPHA,
                   tau_beta=DEFAULT_TAU_BETA):
    """In-batch form (FLSimCo Eq. 3-5): positives on the diagonal of
    q@k^T, negatives the other columns. q, k: (B, D), L2-normalized."""
    sim = (q @ k.T).float()
    pos_index = torch.arange(q.shape[0], device=q.device)
    return _dt_from_logits(sim, pos_index, tau_alpha, tau_beta).mean()


def info_nce_loss(q, k_pos, queue, tau=0.07):
    """MoCo-style InfoNCE against a negative queue — FedCo baseline."""
    pos = (q * k_pos).sum(dim=-1, keepdim=True)
    logits = torch.cat([pos, q @ queue.T], dim=-1).float() / tau
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()
