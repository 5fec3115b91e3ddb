"""SGD, AdamW and LR schedules over dict trees of tensors — counterpart
of `repro.optim.optimizers` (`sgd`, `AdamWState`, `adamw`,
`cosine_schedule`, `constant_schedule`).

    init, update = sgd(momentum, weight_decay, nesterov)
    state = init(params)
    params, state = update(params, grads, state, lr)

The paper trains with SGD(momentum=0.9, weight_decay=5e-4) under a
cosine-annealed lr from 0.9 (Table 1). The update is float32 elementwise
in the reference's order, one operation at a time (no fused
multiply-add), so on the CPU it is bitwise equal to the reference run
op by op. The update is out of place, so it runs under
`torch.func.vmap` (the batched cohort step's per-client SGD). The
schedules return a Python float holding a float32 value; `update` takes
`lr` as that float or as a 0-d float32 tensor, with bitwise the same
result (the campaign engine's captured round reads it from a device
tensor, which a replay refills each round: a float would be captured as
a constant).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.convert import tree_map


class SGDState(NamedTuple):
    momentum: dict


def _zip_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def sgd(momentum: float = 0.9, weight_decay: float = 5e-4,
        nesterov: bool = False):
    def init(params):
        return SGDState(momentum=tree_map(torch.zeros_like, params))

    def update(params, grads, state, lr):
        def upd(p, g, m):
            g = g.float() + weight_decay * p.float()
            m_new = momentum * m.float() + g
            step = (g + momentum * m_new) if nesterov else m_new
            return (p.float() - lr * step).to(p.dtype), m_new.to(m.dtype)

        out = _zip_map(upd, params, grads, state.momentum)
        is_pair = lambda t: isinstance(t, tuple)
        return (_pick(out, 0, is_pair),
                SGDState(momentum=_pick(out, 1, is_pair)))

    return init, update


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    """AdamW with bias correction and decoupled weight decay, the
    moments in float32 whatever the leaves' dtype, as the reference's."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32))

    def update(params, grads, state, lr):
        c = state.count + 1
        bc1 = 1 - b1 ** c.float()
        bc2 = 1 - b2 ** c.float()

        def upd(p, g, mu, nu):
            g = g.float()
            mu_n = b1 * mu + (1 - b1) * g
            nu_n = b2 * nu + (1 - b2) * g * g
            step = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + eps)
            p_new = p.float() - lr * (step + weight_decay * p.float())
            return p_new.to(p.dtype), mu_n, nu_n

        out = _zip_map(upd, params, grads, state.mu, state.nu)
        is_triple = lambda t: isinstance(t, tuple)
        return (_pick(out, 0, is_triple),
                AdamWState(mu=_pick(out, 1, is_triple),
                           nu=_pick(out, 2, is_triple), count=c))

    return init, update


def _pick(tree, i, is_pair):
    if is_pair(tree):
        return tree[i]
    return {k: _pick(v, i, is_pair) for k, v in tree.items()}


def cosine_schedule(base_lr: float, total_steps: int, min_lr: float = 0.0,
                    warmup: int = 0) -> Callable:
    """Cosine annealing, computed in float32 like the reference."""
    def lr(step):
        step = torch.tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        cos = min_lr + 0.5 * (base_lr - min_lr) * (1 + torch.cos(math.pi * t))
        return float(torch.where(step < warmup, warm, cos) if warmup else cos)
    return lr


def constant_schedule(base_lr: float) -> Callable:
    return lambda step: float(torch.tensor(base_lr, dtype=torch.float32))
