"""Activation-sharding hooks — counterpart of `repro.models.sharding_hooks`
(`constrain`, `activation_sharding`).

The models stay functional; a mesh step installs a constraint function
(`launch.sharding.make_activation_rules`: redistribute a DTensor to the
named layout, the counterpart of `with_sharding_constraint`) so the hot
activations keep their layout. The default is the identity, so the
one-device paths never touch a mesh.

Names the zoo uses, as the reference's:
  tokens_bsd   — (batch, seq, d_model)
  tokens_bsf   — (batch, seq, d_ff), the MLP's hidden
  attn_bshd    — (batch, seq, heads, head_dim)
  moe_ecd      — (experts, capacity, d)
  logits_bsv   — (batch, seq, vocab)
  cache_kv     — a (batch, W, kv heads, head_dim) ring buffer
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

_local = threading.local()


def _default(x, name: str):
    return x


def constrain(x, name: str):
    """The installed constraint for the logical activation `name`
    applied to `x` (the identity when none is installed)."""
    fn = getattr(_local, "fn", None) or _default
    return fn(x, name)


@contextlib.contextmanager
def activation_sharding(fn: Callable):
    """Install `fn(x, name)` as the constraint within the block."""
    prev = getattr(_local, "fn", None)
    _local.fn = fn
    try:
        yield
    finally:
        _local.fn = prev


def replicated_like(t, ref):
    """`t`, the same full tensor on every rank (a constant: positions,
    rotary frequencies, masks), as a DTensor replicated over `ref`'s
    mesh where `ref` is a DTensor, as GSPMD replicates a constant;
    otherwise `t` itself."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def sharded_like(t, ref):
    """`t`, the same full tensor on every rank and of `ref`'s shape in
    the dims `ref` shards, as a DTensor with `ref`'s placements (each
    rank keeps its own slice) where `ref` is a DTensor; otherwise `t`."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(ref, DTensor):
        return t
    return distribute_tensor(t, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def batch_like(t, ref):
    """`t`, the same full tensor on every rank, as a DTensor on `ref`'s
    mesh split on dim 0 as `ref` splits its dim 0 (the batch) and
    replicated otherwise, each rank keeping its rows, where `ref` is a
    DTensor; otherwise `t`. For positions made inside the model, whose
    rank differs from the activations'."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    if not isinstance(ref, DTensor):
        return t
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in ref.placements]
    return distribute_tensor(t, ref.device_mesh, pl, src_data_rank=None)


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (a tensor on a mesh)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_to_mesh(t, mesh, placements, shape):
    """This rank's shard `t` of a tensor of global `shape` as a DTensor
    with `placements`, laid out contiguously (the shard is made
    contiguous, and the DTensor's strides are the contiguous ones of
    `shape`, so later views of it are views of the shard too)."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False, shape=tuple(shape),
                              stride=tuple(reversed(stride)))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(t):
    """`t` itself, whose gradient comes back contiguous."""
    return _ContiguousGrad.apply(t)


def mesh_to_local(t, placements, grad_placements=None):
    """This rank's shard of the DTensor `t` at `placements`,
    differentiable (`grad_placements` as `DTensor.to_local`'s). The
    gradient that comes back is made contiguous before it re-enters
    DTensor, whose views assume the layout its strides claim (a local
    product's gradient is often a transposed view)."""
    local = t.redistribute(t.device_mesh, placements).to_local(
        grad_placements=grad_placements)
    return contiguous_grad(local)
