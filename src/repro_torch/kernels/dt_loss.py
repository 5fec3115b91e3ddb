"""Dual-temperature loss forward kernel — launcher for ``csrc/dt_loss.cu``.

Counterpart of `repro.kernels.dt_loss.dt_loss_fwd_pallas` (the Pallas TPU
kernel `_dt_fwd_kernel`). `dt_loss_fwd_cuda` launches the hand-written
CUDA kernel on CUDA tensors and nothing else: one (M, D) pair, or a
cohort of C pairs (C, M, D) in one launch. Two hand-written kernels of
the same file: the Hopper design for D <= MAX_D (the FL path's
ResNet features, D = 128) and the wide form for MAX_D < D <= WIDE_MAX_D
(the zoo's features, D = d_model: 896 to 8192; a cluster's CTAs split D
where the keys fit one key tile, and split the keys otherwise); the
wrapper picks by D and raises above WIDE_MAX_D. The device dispatch, the
plain version and the gradient live in `kernels.ops`. `kernel_attributes`
and `wide_kernel_attributes` report each kernel's registers, spills and
CTAs per SM.

`LAUNCHES` and `WIDE_LAUNCHES` count launches of the two kernels (and
nothing else).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = 0
WIDE_LAUNCHES = 0
MAX_D = 256      # the widest D of the Hopper kernel (csrc kMaxD)
WIDE_MAX_D = 8192  # the widest D of the wide form (csrc kWideMaxD)
ATTRIBUTES = ("regs", "local_bytes", "shared_bytes", "blocks_per_sm",
              "threads", "cluster")

_c = ctypes


@functools.cache
def _lib(entry: str = "dt_loss_fwd_launch"):
    """The configured C entry point `entry` (built and loaded at first
    launch): ``dt_loss_fwd_launch`` or ``dt_loss_fwd_wide_launch``, of one
    signature."""
    fn = getattr(build.load("dt_loss"), entry)
    fn.argtypes = [_c.c_void_p] * 6 + [_c.c_int] * 4 + [
        _c.c_float, _c.c_float, _c.c_void_p]
    fn.restype = _c.c_int
    return fn


def _is_wide(d: int) -> bool:
    return MAX_D < d <= WIDE_MAX_D and d % 4 == 0


def _check_d(d: int) -> None:
    if not 1 <= d <= MAX_D or d % 4:
        raise ValueError(f"dt_loss kernel takes D % 4 == 0 with D <= {MAX_D} "
                         f"(the wide form: up to {WIDE_MAX_D}), got D = {d}")


def kernel_attributes(d: int = 128) -> dict:
    """What the compiler and the occupancy calculator say of the kernel at
    width `d` on the current CUDA device: registers and local (spill)
    bytes a thread, shared bytes a CTA, CTAs an SM holds at once (0 where
    the calculator declines), threads a CTA, CTAs a cluster."""
    _check_d(d)
    return build.attributes("dt_loss", ATTRIBUTES, d)


def wide_kernel_attributes(d: int = 2048) -> dict:
    """`kernel_attributes` of the wide form at width `d` (MAX_D < d <=
    WIDE_MAX_D, d % 4 == 0); its shared memory does not depend on d."""
    if not _is_wide(d):
        raise ValueError(f"dt_loss wide form takes D % 4 == 0 with {MAX_D} "
                         f"< D <= {WIDE_MAX_D}, got D = {d}")
    return build.attributes("dt_loss", ATTRIBUTES, d,
                            entry="dt_loss_wide_attributes")


def dt_loss_fwd_cuda(q: torch.Tensor, k: torch.Tensor, tau_alpha: float,
                     tau_beta: float):
    """q, k (M, D) float32 CUDA -> (loss_vec, lse_a, lse_b, pos), each
    (M,); or a cohort q, k (C, M, D) -> four (C, M), client c's rows from
    q[c] and k[c] alone, in one launch. D <= MAX_D goes to the Hopper
    kernel, MAX_D < D <= WIDE_MAX_D to the wide form. Raises on anything
    the kernels do not take."""
    # analysis: allow=purity-global-mutation -- the launch counters that
    # show a run went through the kernels (chip_smoke.py reads them)
    global LAUNCHES, WIDE_LAUNCHES
    for name, t in (("q", q), ("k", k)):
        if t.device.type != "cuda":
            raise ValueError(f"dt_loss_fwd_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.dtype != torch.float32 or t.dim() not in (2, 3) \
                or not t.is_contiguous():
            raise ValueError(f"dt_loss: {name} must be contiguous 2-D or "
                             f"3-D float32, got {t.dtype} {tuple(t.shape)}")
    if q.shape != k.shape or q.device != k.device:
        raise ValueError(f"dt_loss: q {tuple(q.shape)} on {q.device} and "
                         f"k {tuple(k.shape)} on {k.device} must match")
    c, m, d = q.shape if q.dim() == 3 else (1, *q.shape)
    if m < 1 or not 1 <= c <= 65535:
        raise ValueError(f"dt_loss kernel takes M >= 1 and 1 <= C <= 65535, "
                         f"got {tuple(q.shape)}")
    wide = _is_wide(d)
    if not wide:
        _check_d(d)
    if q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("dt_loss kernel needs 16-byte aligned q and k")
    # one allocation, handed out as four outputs of q's leading shape
    out = torch.empty((4, *q.shape[:-1]), dtype=torch.float32,
                      device=q.device)
    ptr, row = out.data_ptr(), 4 * c * m
    fn = _lib("dt_loss_fwd_wide_launch" if wide else "dt_loss_fwd_launch")
    args = (q.data_ptr(), k.data_ptr(), ptr, ptr + row, ptr + 2 * row,
            ptr + 3 * row, c, m, d, m, float(tau_alpha), float(tau_beta))
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    build.check(err, "dt_loss_fwd_wide" if wide else "dt_loss_fwd")
    if wide:
        WIDE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out.unbind(0)
