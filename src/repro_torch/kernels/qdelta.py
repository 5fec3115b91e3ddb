"""Blockwise-int8 delta codec kernels — launchers for ``csrc/qdelta.cu``.

Counterpart of `repro.kernels.qdelta` (`q8_encode_pallas` and
`q8_decode_pallas`, the Pallas TPU kernels `_q8_encode_kernel` and
`_q8_decode_kernel`). `q8_encode_cuda` and `q8_decode_cuda` launch the
hand-written CUDA kernels on CUDA tensors and nothing else; the device
dispatch, the padding of P and the plain versions live in `kernels.ops`
and `kernels.ref`.

`ENCODE_LAUNCHES` and `DECODE_LAUNCHES` count kernel launches (and
nothing else). The serving tier decodes from several fetcher threads at
once, so each count is taken under a lock.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build

BQ = 256    # quantization block: parameters sharing one float32 scale

ENCODE_LAUNCHES = 0
DECODE_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_c = ctypes


@functools.cache
def _lib():
    """The configured C entry points (built and loaded at first launch)."""
    lib = build.load("qdelta")
    enc, dec = lib.q8_encode_launch, lib.q8_decode_launch
    enc.argtypes = [_c.c_void_p] * 5 + [_c.c_longlong, _c.c_void_p]
    dec.argtypes = [_c.c_void_p] * 3 + [_c.c_longlong, _c.c_void_p]
    enc.restype = dec.restype = _c.c_int
    return enc, dec


def _check(name, t, dtype, shape, device, align):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"q8: {name} must be {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"q8: {name} must be contiguous and {align}-byte "
                         f"aligned")


def _matrix_shape(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {t.device}")
    if t.dim() != 2 or t.shape[1] % BQ:
        raise ValueError(f"{what}: expected (N, P) with P % {BQ} == 0, got "
                         f"{tuple(t.shape)}")
    return tuple(t.shape)


def q8_encode_cuda(delta: torch.Tensor, ef: torch.Tensor):
    """delta, ef (N, P) float32 CUDA, P % 256 == 0 -> (codes (N, P) int8,
    scales (N, P / 256) float32, new_ef (N, P) float32), on the CUDA
    kernel. Raises on anything the kernel does not take."""
    # analysis: allow=purity-global-mutation -- the launch counter that
    # shows a run went through the kernel (chip_smoke.py reads it)
    global ENCODE_LAUNCHES
    n, p = shape = _matrix_shape(delta, "q8_encode_cuda")
    dev = delta.device
    _check("delta", delta, torch.float32, shape, dev, 16)
    _check("ef", ef, torch.float32, shape, dev, 16)
    codes = torch.empty(shape, dtype=torch.int8, device=dev)
    scales = torch.empty((n, p // BQ), dtype=torch.float32, device=dev)
    new_ef = torch.empty(shape, dtype=torch.float32, device=dev)
    enc, _ = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = enc(delta.data_ptr(), ef.data_ptr(), codes.data_ptr(),
                  scales.data_ptr(), new_ef.data_ptr(), n * p, stream)
    build.check(err, "q8_encode")
    with _COUNT_LOCK:
        ENCODE_LAUNCHES += 1
    return codes, scales, new_ef


def q8_decode_cuda(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """codes (N, P) int8, scales (N, P / 256) float32, CUDA, P % 256 == 0
    -> (N, P) float32, on the CUDA kernel. Raises on anything the kernel
    does not take."""
    # analysis: allow=purity-global-mutation -- the launch counter
    global DECODE_LAUNCHES
    n, p = shape = _matrix_shape(codes, "q8_decode_cuda")
    dev = codes.device
    _check("codes", codes, torch.int8, shape, dev, 8)
    _check("scales", scales, torch.float32, (n, p // BQ), dev, 4)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    _, dec = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = dec(codes.data_ptr(), scales.data_ptr(), out.data_ptr(), n * p,
                  stream)
    build.check(err, "q8_decode")
    with _COUNT_LOCK:
        DECODE_LAUNCHES += 1
    return out
