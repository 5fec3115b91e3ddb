"""Eq.-11 weighted aggregation kernel — launcher for ``csrc/wagg.cu``.

Counterpart of `repro.kernels.wagg.wagg_pallas` (the Pallas TPU kernels
`_wagg_kernel` / `_wagg_masked_kernel`). `wagg_cuda` launches the
hand-written CUDA kernel on CUDA tensors and nothing else; the device
dispatch and the plain version live in `kernels.ops.wagg_flat`.

`LAUNCHES` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = 0

_c = ctypes


@functools.cache
def _lib():
    """The configured C entry point (built and loaded at first launch)."""
    fn = build.load("wagg").wagg_launch
    fn.argtypes = [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_int, _c.c_longlong, _c.c_void_p]
    fn.restype = _c.c_int
    return fn


def _check_vec(name, t, m, device):
    if t.device != device or t.dtype != torch.float32 or t.shape != (m,):
        raise ValueError(f"wagg: {name} must be float32 ({m},) on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def wagg_cuda(stacked: torch.Tensor, w: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """(m, P) float32 stack x (m,) weights [x (m,) mask] -> (P,) float32,
    on the CUDA kernel. Raises on anything the kernel does not take."""
    # analysis: allow=purity-global-mutation -- the launch counter that
    # shows a run went through the kernel (chip_smoke.py reads it)
    global LAUNCHES
    if stacked.device.type != "cuda":
        raise ValueError(f"wagg_cuda needs CUDA tensors, got {stacked.device}")
    if stacked.dtype != torch.float32 or stacked.dim() != 2:
        raise ValueError(f"wagg: stacked must be 2-D float32, got "
                         f"{stacked.dtype} {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("wagg: stacked must be contiguous")
    m, p = stacked.shape
    if m < 1 or p < 1:
        raise ValueError(f"wagg: empty stack {tuple(stacked.shape)}")
    dev = stacked.device
    _check_vec("w", w, m, dev)
    if mask is not None:
        _check_vec("mask", mask, m, dev)
    w = w.contiguous()
    mask = None if mask is None else mask.contiguous()
    out = torch.empty(p, dtype=torch.float32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(stacked.data_ptr(), w.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 m, p, stream)
    build.check(err, "wagg")
    LAUNCHES += 1
    return out
