"""Vehicle mobility + motion-blur model — FLSimCo Eq. (1)-(2).

Counterpart of `repro.core.mobility` (`MobilityModel.pdf/sample/
blur_level/init_positions/advance_positions`, `motion_blur_kernel`,
`apply_motion_blur`, `BLUR_KMH_100`).

Velocities are IID truncated Gaussians on [v_min, v_max] (Eq. 1), drawn
by inverse CDF on a 4097-point grid; the blur level is linear in
velocity, L = (H*s/Q) * v (Eq. 2).

The grid and the CDF are built to match the reference bit for bit where
float32 allows: the grid repeats `jnp.linspace`'s
``start*(1-t) + stop*t`` with the fused multiply-add XLA's CPU backend
emits, and the cumulative sum repeats XLA's blocked scan (sequential
within blocks of 16, block totals scanned recursively). Only `exp` in
the pdf may differ by 1 ULP (neither library rounds it correctly), so a
velocity differs from the reference's only when u lands within that ULP
of a CDF step (tests/test_torch_modules.py pins 100k draws bitwise).

Ring-road positions (the handover topology) are float32 and bitwise the
reference's for the same uniforms: `advance_positions` rounds v*dt, then
the sum, as the reference's eager jnp ops do (no fused multiply-add;
tests/test_torch_topology.py pins it), and wraps with the truncated
remainder plus the sign fix-up of `jnp.mod`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

KMH_100 = 100.0 / 3.6  # 27.78 m/s — paper's velocity cutoff for baseline2
CAMERA_CONST = 0.58    # H*s/Q, Table 1 — the Eq.-2 blur-per-velocity slope
# The 100 km/h cutoff in blur units (Eq. 2 under the Table-1 camera
# constant); FLConfig.blur_threshold defaults to it.
BLUR_KMH_100 = CAMERA_CONST * KMH_100  # ~16.11

GRID = 4097


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace` in float32 as XLA-CPU computes it:
    fma(stop, t, start*(1-t)) with t = iota/(num-1)."""
    f32 = np.float32
    t = np.arange(num - 1, dtype=f32) / f32(num - 1)
    a = f32(start) * (f32(1) - t)
    # the f32 x f32 product is exact in float64, so one rounding of the
    # float64 sum reproduces the fused multiply-add
    fused = (a.astype(np.float64)
             + np.float64(f32(stop)) * t.astype(np.float64)).astype(f32)
    return np.concatenate([fused, np.array([stop], f32)])


def _blocked_cumsum_f32(x: np.ndarray, block: int = 16) -> np.ndarray:
    """Inclusive float32 prefix sum in the order of XLA-CPU's cumsum:
    sequential inside rows of `block`, row totals scanned recursively and
    added back as an exclusive prefix."""
    n = x.shape[0]
    if n <= block:
        return np.cumsum(x, dtype=np.float32)
    rows = -(-n // block)
    xp = np.zeros(rows * block, np.float32)
    xp[:n] = x
    local = np.cumsum(xp.reshape(rows, block), axis=1, dtype=np.float32)
    totals = _blocked_cumsum_f32(local[:, -1], block)
    excl = np.concatenate([np.zeros(1, np.float32), totals[:-1]])
    return (local + excl[:, None]).reshape(-1)[:n]


@dataclass(frozen=True)
class MobilityModel:
    v_min: float = 16.67
    v_max: float = 41.67
    mu: float = (16.67 + 41.67) / 2
    sigma: float = 5.0
    camera_const: float = CAMERA_CONST   # H*s/Q  (Table 1: 0.58)

    def pdf(self, v) -> torch.Tensor:
        """Truncated Gaussian pdf, Eq. (1), in float32."""
        v = torch.as_tensor(v, dtype=torch.float32)
        z = (v - self.mu) / self.sigma
        base = torch.exp(-0.5 * z * z) / (self.sigma * math.sqrt(2 * math.pi))
        lo = math.erf((self.v_min - self.mu) / (self.sigma * math.sqrt(2)))
        hi = math.erf((self.v_max - self.mu) / (self.sigma * math.sqrt(2)))
        norm = 0.5 * (hi - lo)
        inside = (v >= self.v_min) & (v <= self.v_max)
        return torch.where(inside, base / norm, torch.zeros_like(base))

    def grid_cdf(self):
        """(grid, cdf), both (4097,) float32 CPU tensors."""
        grid = torch.from_numpy(_linspace_f32(self.v_min, self.v_max, GRID))
        csum = torch.from_numpy(_blocked_cumsum_f32(self.pdf(grid).numpy()))
        return grid, csum / csum[-1:]

    def sample(self, generator: torch.Generator | None, n: int,
               u: torch.Tensor | None = None) -> torch.Tensor:
        """n velocities (float32, CPU) by inverse CDF on the grid.

        The uniforms come from `generator` (a CPU `torch.Generator`), or
        are passed as `u` (n,) — the tests feed the reference's draws."""
        if u is None:
            u = torch.rand(n, generator=generator, dtype=torch.float32)
        u = torch.as_tensor(u, dtype=torch.float32)
        grid, cdf = self.grid_cdf()
        idx = torch.searchsorted(cdf, u)
        return grid[idx.clamp(0, GRID - 1)]

    def blur_level(self, v) -> torch.Tensor:
        """Eq. (2): L = (H*s/Q) * v."""
        return self.camera_const * torch.as_tensor(v, dtype=torch.float32)

    # -- positions on a ring road of length road_length (handover) ----------

    def init_positions(self, generator: torch.Generator | None, n: int,
                       road_length: float,
                       u: torch.Tensor | None = None) -> torch.Tensor:
        """n uniform positions on [0, road_length), float32 on the CPU;
        the uniforms come from `generator` or are passed as `u`."""
        if u is None:
            u = torch.rand(n, generator=generator, dtype=torch.float32)
        return torch.as_tensor(u, dtype=torch.float32) * road_length

    def advance_positions(self, positions, velocities, dt: float,
                          road_length: float) -> torch.Tensor:
        """(positions + v*dt) mod road_length in float32, each product and
        the sum rounded on its own."""
        p = torch.as_tensor(positions, dtype=torch.float32)
        v = torch.as_tensor(velocities, dtype=torch.float32)
        x = p + v * dt
        r = torch.fmod(x, road_length)
        wrap = (r != 0) & ((r < 0) != (road_length < 0))
        return torch.where(wrap, r + road_length, r)


def motion_blur_kernel(v, camera_const: float = CAMERA_CONST,
                       max_len: int = 9) -> torch.Tensor:
    """Horizontal linear motion-blur PSF whose length grows with velocity:
    extent = clip(L/2, 1, max_len) pixels, zero-padded and normalized
    to (max_len,)."""
    L = camera_const * torch.as_tensor(v, dtype=torch.float32)
    extent = torch.clamp(L / 2.0, 1.0, float(max_len))
    idx = torch.arange(max_len, dtype=torch.float32, device=L.device)
    center = (max_len - 1) / 2.0
    one, zero = torch.ones_like(idx), torch.zeros_like(idx)
    w = torch.where((idx - center).abs() <= (extent - 1.0) / 2.0 + 1e-6,
                    one, zero)
    w = torch.maximum(w, torch.where(idx == center, one, zero))
    return w / w.sum()


def apply_motion_blur(images: torch.Tensor, v, camera_const: float = CAMERA_CONST,
                      max_len: int = 9) -> torch.Tensor:
    """Blur (B,H,W,C) images with the velocity-dependent horizontal PSF
    (edge padding; taps summed in ascending order like the reference)."""
    k = motion_blur_kernel(torch.as_tensor(v, device=images.device),
                           camera_const, max_len)
    pad = max_len // 2
    W = images.shape[2]
    x = torch.cat([images[:, :, :1].expand(-1, -1, pad, -1), images,
                   images[:, :, -1:].expand(-1, -1, pad, -1)], dim=2)
    out = 0
    for i in range(max_len):
        out = out + x[:, :, i:i + W, :] * k[i]
    return out
