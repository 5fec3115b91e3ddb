"""Neural-net primitives of the zoo's ``ssm`` family (RWKV6 "Finch") —
counterpart of `repro.models.layers` (`normal_init`, `fan_in_init`, the
norms, `init_rwkv_tmix`, `_rwkv_project`, `rwkv_tmix_chunked`,
`rwkv_tmix_step`, `init_rwkv_cmix`, `rwkv_cmix`).

Functional, like the reference: ``init_*`` builds a dict of tensors from
an explicit `torch.Generator` (the tensors land on the generator's
device), the matching apply function consumes it. Weight layouts are the
reference's: ``x @ W`` with W as (d_in, d_out). Numerics follow it too:
parameters in the caller's dtype except the float32 decay and bonus
leaves (``w0``, ``w_lora_b``, ``u``), norm statistics, token-shift mixes
and the recurrence in float32, each projection's output in the input's
dtype.

The chunked time-mix runs the hand-written kernel through
`kernels.ops.rwkv6` (the plain chunked version on the CPU): once per
layer on the whole sequence, from the cache's state, reading the
projections' (B, S, H, D) layout in place. The kernel takes any S, so a
ragged S needs no head/tail split. The one-token decode step is plain
torch, as the reference's is jnp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30
RWKV_DECAY_FLOOR = -4.0  # clamp of the per-step log-decay, as the reference


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, std, dtype=torch.float32):
    """float32 N(0, std^2) draws on the generator's device, cast to dtype."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def fan_in_init(gen: torch.Generator, shape, dtype=torch.float32):
    """N(0, 1 / fan_in) with fan_in = shape[0]."""
    return normal_init(gen, shape, 1.0 / math.sqrt(shape[0]), dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_rmsnorm(d, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def init_layernorm(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def init_norm(cfg, d=None, dtype=torch.float32, device=None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return init_rmsnorm(d, dtype, device)
    return init_layernorm(d, dtype, device)


def apply_norm(cfg, p, x):
    fn = rmsnorm if "bias" not in p else layernorm
    return fn(p, x, cfg.norm_eps)


# --------------------------------------------------------------------------
# RWKV6 (Finch) time-mix
# --------------------------------------------------------------------------

def init_rwkv_tmix(cfg, gen: torch.Generator, dtype=torch.float32):
    d = cfg.d_model
    return {
        "mu": normal_init(gen, (5, d), 0.1, dtype),    # shift-mix r,k,v,g,w
        "wr": fan_in_init(gen, (d, d), dtype),
        "wk": fan_in_init(gen, (d, d), dtype),
        "wv": fan_in_init(gen, (d, d), dtype),
        "wg": fan_in_init(gen, (d, d), dtype),
        "w0": normal_init(gen, (d,), 0.5) - 2.0,        # base decay, f32
        "w_lora_a": fan_in_init(gen, (d, 64), dtype),
        "w_lora_b": normal_init(gen, (64, d), 0.01),    # f32
        "u": normal_init(gen, (d,), 0.1),               # bonus, f32
        "wo": fan_in_init(gen, (d, d), dtype),
    }


def _shift(x, x_last):
    """The previous token of each position: x_last (B, d) or zeros first."""
    first = x_last[:, None] if x_last is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_project(cfg, p, x, x_prev):
    """Token-shift mixing + projections. x, x_prev: (B, S, d). Returns
    r, k, v, g in x's dtype and the float32 log-decay, clamped to
    [RWKV_DECAY_FLOOR, -1e-4]. Each of the five mixes is formed on its own
    (the reference stacks them; the same elementwise arithmetic)."""
    mu = p["mu"].float()
    xs, xp = x.float(), x_prev.float()
    diff = xp - xs

    def mixed(i):
        return (xs + diff * mu[i]).to(x.dtype)

    r = mixed(0) @ p["wr"]
    k = mixed(1) @ p["wk"]
    v = mixed(2) @ p["wv"]
    g = F.silu(mixed(3) @ p["wg"])
    lw = p["w0"] + torch.tanh(mixed(4) @ p["w_lora_a"]).float() @ p["w_lora_b"]
    logw = torch.clamp(-torch.exp(lw), RWKV_DECAY_FLOOR, -1e-4)
    return r, k, v, g, logw


def rwkv_tmix_chunked(cfg, p, x, state=None, x_last=None):
    """RWKV6 time-mix over a full sequence, on the rwkv6 kernel.

    x: (B, S, d); state: (B, H, D, D) float32 carry (k-dim, v-dim) or None;
    x_last: (B, d) token before x[:, 0] or None. Returns (out (B, S, d),
    new_state (B, H, D, D) float32, last_x (B, d))."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    r, k, v, g, logw = _rwkv_project(cfg, p, x, _shift(x, x_last))

    def heads(t):
        return t.float().contiguous().view(b, s, h, hd)

    u = p["u"].float().view(h, hd)
    if state is not None:
        state = state.float().contiguous()
    o, state = ops.rwkv6(heads(r), heads(k), heads(v), heads(logw), u, state)
    o = (o.view(b, s, d).to(x.dtype) * g) @ p["wo"]
    return o, state, x[:, -1]


def rwkv_tmix_step(cfg, p, x, state, x_last):
    """Single-token decode step. x: (B, 1, d); state: (B, H, D, D)."""
    b, _, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    r, k, v, g, logw = _rwkv_project(cfg, p, x, x_last[:, None])
    rh, kh, vh = (t.float().reshape(b, h, hd) for t in (r, k, v))
    w = torch.exp(logw.reshape(b, h, hd))
    u = p["u"].float().view(h, hd)
    kv = kh[..., :, None] * vh[..., None, :]                 # (B, H, D, D)
    o = torch.einsum("bhd,bhde->bhe", rh, state + u[None, :, :, None] * kv)
    state = state * w[..., None] + kv
    o = o.reshape(b, 1, h * hd).to(x.dtype) * g
    return o @ p["wo"], state, x[:, -1]


# --------------------------------------------------------------------------
# RWKV6 channel-mix
# --------------------------------------------------------------------------

def init_rwkv_cmix(cfg, gen: torch.Generator, dtype=torch.float32):
    d = cfg.d_model
    return {
        "mu": normal_init(gen, (2, d), 0.1, dtype),
        "w_up": fan_in_init(gen, (d, cfg.d_ff), dtype),
        "w_down": fan_in_init(gen, (cfg.d_ff, d), dtype),
    }


def rwkv_cmix(cfg, p, x, x_last=None):
    """Channel-mix (square-ReLU FFN with token shift). Returns (out
    (B, S, d), last_x (B, d))."""
    xs, xp = x.float(), _shift(x, x_last).float()
    xk = xs + (xp - xs) * p["mu"].float()[0]
    h = torch.square(torch.relu(xk.to(x.dtype) @ p["w_up"]))
    return h @ p["w_down"], x[:, -1]
