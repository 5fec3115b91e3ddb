"""FLSimCo Sec. 4 Step 2 image augmentations and the MoCo/FedCo
machinery — counterpart of `repro.core.ssl` (`pi1`, `pi2`, `_grayscale`,
`_color_jitter`, `token_view`, `MoCoState`, `init_moco_state`,
`momentum_update`, `queue_push`, `fedco_merge_queues`).

    pi1: horizontal flip (p=.5) -> grayscale (p=.2)
    pi2: color jitter (brightness/contrast/saturation/hue, range .4,
         p=.8) -> grayscale (p=.4) -> clip to [0, 1]

The reference draws inside each view from a jax key. Here each view is a
draw (`draw_pi1` / `draw_pi2`, from a CPU `torch.Generator`, returning
the masks and factors) and an apply (`pi1` / `pi2`, pure functions of the
images and the draws), so a round's plan can hold its draws and a test
can hand the port the reference's draws; a token view likewise
(`draw_token_view`, `token_view`). Images stay NHWC, as in the
reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.convert import leaves_with_paths, tree_map

GRAY_W = (0.299, 0.587, 0.114)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    g = (x[..., 0:1] * GRAY_W[0] + x[..., 1:2] * GRAY_W[1]
         + x[..., 2:3] * GRAY_W[2])
    return g.expand(x.shape)


def _bernoulli(gen, p: float, b: int) -> torch.Tensor:
    return torch.rand(b, generator=gen) < p


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def draw_pi1(gen: torch.Generator, b: int) -> dict:
    """pi1's random choices for a batch of b: flip and grayscale masks."""
    return {"flip": _bernoulli(gen, 0.5, b), "gray": _bernoulli(gen, 0.2, b)}


def draw_pi2(gen: torch.Generator, b: int, rng: float = 0.4) -> dict:
    """pi2's random choices: apply/grayscale masks, jitter factors
    (b,1,1,1) in [1-rng, 1+rng] and hue (b,1,1) in [-rng, rng]."""
    return {"apply": _bernoulli(gen, 0.8, b),
            "brightness": _uniform(gen, (b, 1, 1, 1), 1 - rng, 1 + rng),
            "contrast": _uniform(gen, (b, 1, 1, 1), 1 - rng, 1 + rng),
            "saturation": _uniform(gen, (b, 1, 1, 1), 1 - rng, 1 + rng),
            "hue": _uniform(gen, (b, 1, 1), -rng, rng),
            "gray": _bernoulli(gen, 0.4, b)}


def draws_to(draws: dict, device) -> dict:
    return {k: v.to(device) for k, v in draws.items()}


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask[:, None, None, None], a, b)


def _color_jitter(x: torch.Tensor, d: dict) -> torch.Tensor:
    x = x * d["brightness"]
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * d["contrast"] + mean
    g = _grayscale(x)
    x = g + (x - g) * d["saturation"]
    # hue: rotate chroma around the gray axis (small-angle YIQ rotation)
    theta = d["hue"][..., None] * math.pi
    cos, sin = torch.cos(theta), torch.sin(theta)
    y = _grayscale(x)
    r, g_, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    i = 0.596 * r - 0.274 * g_ - 0.322 * b
    q = 0.211 * r - 0.523 * g_ + 0.312 * b
    i2 = cos * i - sin * q
    q2 = sin * i + cos * q
    yv = y[..., 0:1]
    return torch.cat([
        yv + 0.956 * i2 + 0.621 * q2,
        yv - 0.272 * i2 - 0.647 * q2,
        yv - 1.106 * i2 + 1.703 * q2,
    ], dim=-1)


def pi1(x: torch.Tensor, d: dict) -> torch.Tensor:
    """Horizontal flip -> grayscale. x: (B,H,W,3) in [0,1]."""
    x = _where(d["flip"], x.flip(2), x)
    return _where(d["gray"], _grayscale(x), x)


def pi2(x: torch.Tensor, d: dict) -> torch.Tensor:
    """Color jitter -> grayscale -> clip to [0, 1]."""
    x = _where(d["apply"], _color_jitter(x, d), x)
    x = _where(d["gray"], _grayscale(x), x)
    return torch.clamp(x, 0.0, 1.0)


# --------------------------------------------------------------------------
# MoCo / FedCo machinery
# --------------------------------------------------------------------------

def draw_token_view(gen: torch.Generator, shape, drop_p: float = 0.15):
    """A token view's drop mask: (B, S) bool, each position dropped with
    probability `drop_p`, from the CPU generator `gen`."""
    return torch.rand(tuple(shape), generator=gen) < drop_p


def token_view(tokens: torch.Tensor, mask_id: int, drop: torch.Tensor):
    """The masking view of a token batch (B, S): `mask_id` where `drop`
    (`draw_token_view`, moved to the tokens' device) is set."""
    return torch.where(drop, mask_id, tokens)


class MoCoState(NamedTuple):
    key_params: dict        # momentum (EMA) encoder params
    queue: torch.Tensor     # (K, D) L2-normalized negatives
    ptr: int                # ring pointer


def normal_queue(gen: torch.Generator, queue_len: int, dim: int,
                 device="cpu") -> torch.Tensor:
    """(queue_len, dim) standard normals from `gen`, each row
    L2-normalized."""
    q = torch.randn((queue_len, dim), generator=gen, dtype=torch.float32)
    return (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).to(device)


def init_moco_state(params: dict, queue_len: int, dim: int,
                    gen: torch.Generator) -> MoCoState:
    """A copy of `params` as the key encoder, a random normalized queue
    on the params' device, the pointer at 0."""
    device = leaves_with_paths(params)[0][1].device
    return MoCoState(key_params=tree_map(torch.clone, params),
                     queue=normal_queue(gen, queue_len, dim, device), ptr=0)


def momentum_update(key_params, query_params, m: float = 0.99):
    """EMA key-encoder update (MoCo): m * key + (1 - m) * query."""
    if isinstance(key_params, dict):
        return {k: momentum_update(key_params[k], query_params[k], m)
                for k in key_params}
    return m * key_params + (1 - m) * query_params.to(key_params.dtype)


def queue_push(state: MoCoState, keys: torch.Tensor) -> MoCoState:
    """Ring-buffer enqueue of a batch of k-vectors (B, D)."""
    K, B = state.queue.shape[0], keys.shape[0]
    idx = (state.ptr + torch.arange(B, device=state.queue.device)) % K
    queue = state.queue.clone()
    queue[idx] = keys.to(queue.dtype)
    return state._replace(queue=queue, ptr=(state.ptr + B) % K)


def fedco_merge_queues(global_queue: torch.Tensor, client_keys_list):
    """FedCo: the RSU puts the uploaded k-value batches in front of the
    global queue (newest first) and truncates to its length."""
    K = global_queue.shape[0]
    return torch.cat(list(client_keys_list) + [global_queue])[:K]
