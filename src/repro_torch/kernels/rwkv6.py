"""RWKV6 recurrence kernel — launcher for ``csrc/rwkv6.cu``.

Counterpart of `repro.kernels.rwkv6.rwkv6_pallas` (the Pallas TPU kernel
`_rwkv6_kernel`). `rwkv6_cuda` launches the hand-written CUDA kernel on
CUDA tensors and nothing else; the device dispatch and the plain version
live in `kernels.ops.rwkv6` and `kernels.ref.rwkv6_chunked_ref`.

Two input layouts, read in place by strides (unit stride along D):

* (BH, S, D) rows, with u (BH, D) or (D,) and state0 (BH, D, D);
* (B, S, H, D), the layout the time-mix projections produce, with u
  (H, D) or (D,) and state0 (B, H, D, D).

o comes back contiguous in the input's layout, the state contiguous as
(BH, D, D) or (B, H, D, D). Any S >= 1: the kernel runs exactly S steps,
so the state is that of S steps. `kernel_attributes` reports the
kernel's registers, spills and blocks per SM.

`LAUNCHES` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = 0
HEAD_DIMS = (32, 64)     # the template instances of csrc/rwkv6.cu

_c = ctypes


@functools.cache
def _lib():
    """The configured C entry point (built and loaded at first launch)."""
    fn = build.load("rwkv6").rwkv6_launch
    fn.argtypes = ([_c.c_void_p] * 8 + [_c.c_int] * 4 + [_c.c_longlong] * 8
                   + [_c.c_void_p])
    fn.restype = _c.c_int
    return fn


ATTRIBUTES = ("regs", "local_bytes", "shared_bytes", "blocks_per_sm",
              "threads", "steps_per_slab")


def kernel_attributes(d: int = 64) -> dict:
    """What the compiler and the occupancy calculator say of the kernel
    for head size `d` on the current CUDA device: registers and local
    (spill) bytes a thread, static shared bytes a block, blocks an SM holds
    at once, threads a block (one (batch*head) row), steps a slab."""
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6 kernel takes D in {HEAD_DIMS}, got {d}")
    return build.attributes("rwkv6", ATTRIBUTES, d)


def geometry(r: torch.Tensor):
    """(B, H, S, D) of a (BH, S, D) tensor (B = BH, H = 1) or a
    (B, S, H, D) tensor."""
    if r.dim() == 3:
        bh, s, d = r.shape
        return bh, 1, s, d
    if r.dim() == 4:
        b, s, h, d = r.shape
        return b, h, s, d
    raise ValueError(f"rwkv6: r must be (BH, S, D) or (B, S, H, D), got "
                     f"{tuple(r.shape)}")


def _strides(t: torch.Tensor):
    """(b, h, t) element strides of a 3- or 4-D tensor laid out as r."""
    if t.dim() == 3:
        return t.stride(0), 0, t.stride(1)
    return t.stride(0), t.stride(2), t.stride(1)


def rwkv6_cuda(r, k, v, logw, u, state0=None):
    """The RWKV6 recurrence on the CUDA kernel: (o, state), float32. See
    the module doc for the layouts. Raises on anything the kernel does not
    take."""
    # analysis: allow=purity-global-mutation -- the launch counter that
    # shows a run went through the kernel (chip_smoke.py reads it)
    global LAUNCHES
    b, h, s, d = geometry(r)
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_cuda needs CUDA tensors, got {dev}")
    if d not in HEAD_DIMS or s < 1:
        raise ValueError(f"rwkv6 kernel takes D in {HEAD_DIMS} and S >= 1, "
                         f"got {tuple(r.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.device != dev or t.dtype != torch.float32 \
                or t.shape != r.shape or t.stride() != r.stride():
            raise ValueError(f"rwkv6: {name} must be float32 {tuple(r.shape)} "
                             f"on {dev} with r's strides, got {t.dtype} "
                             f"{tuple(t.shape)} {t.stride()} on {t.device}")
    if r.stride(-1) != 1:
        raise ValueError("rwkv6: inputs need unit stride along D")
    rows_u = b if r.dim() == 3 else h
    if u.device != dev or u.dtype != torch.float32 or u.stride(-1) != 1 \
            or tuple(u.shape) not in ((d,), (rows_u, d)):
        raise ValueError(f"rwkv6: u must be float32 (D,) or ({rows_u}, D) on "
                         f"{dev}, got {u.dtype} {tuple(u.shape)}")
    state_shape = (b * h, d, d) if r.dim() == 3 else (b, h, d, d)
    if state0 is not None and (
            state0.device != dev or state0.dtype != torch.float32
            or tuple(state0.shape) != state_shape
            or not state0.is_contiguous()):
        raise ValueError(f"rwkv6: state0 must be contiguous float32 "
                         f"{state_shape} on {dev}, got {state0.dtype} "
                         f"{tuple(state0.shape)}")
    u_row = u.stride(0) if u.dim() == 2 else 0
    ub, uh = (u_row, 0) if r.dim() == 3 else (0, u_row)
    o = torch.empty(r.shape, dtype=torch.float32, device=dev)
    state = torch.empty(state_shape, dtype=torch.float32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(),
                 None if state0 is None else state0.data_ptr(),
                 o.data_ptr(), state.data_ptr(), b * h, h, s, d,
                 *_strides(r), *_strides(o), ub, uh, stream)
    build.check(err, "rwkv6")
    LAUNCHES += 1
    return o, state
