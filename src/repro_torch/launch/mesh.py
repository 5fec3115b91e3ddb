"""Cohort meshes over `torch.distributed` — counterpart of
`repro.launch.mesh` (`COHORT_AXES`, `cohort_mesh`, `cohort_axis_divisor`,
`maybe_cohort_mesh`, `batch_axes`, `axis_size`).

The reference runs one controller and `shard_map`s a stacked cohort over
a jax mesh. The port runs SPMD, one process a device (launched by
``torchrun --nproc-per-node N`` or `torch.multiprocessing`): every rank
runs the same round plan, trains its contiguous block of cohort rows,
and the collectives leave the same result on every rank. A cohort mesh
is a `DeviceMesh` of shape (pods, data) with dims named ("pod", "data")
over the default process group: NCCL on CUDA, gloo on the CPU.

A mesh spans every rank of the group (every rank holds a block; a rank
outside the mesh would hold neither a block nor the result), so rank r
is mesh coordinate (r // data, r % data) and holds rows [r * b, (r + 1)
* b) of a cohort of m = b * pods * data rows. Where no process group
exists, a 1 x 1 mesh creates a one-rank group itself, so the mesh paths
run on one card with no launcher. NCCL takes one rank a device, and
gloo cannot gather CUDA tensors, so a one-card machine runs the mesh at
world size 1.

Zoo meshes: the zoo's mesh mode (launch/steps.py with a mesh) runs over
a `DeviceMesh` named ("data", "model"), or ("pod", "data", "model")
across pods, that spans every rank (`zoo_mesh`, cached like the cohort
meshes). `make_production_mesh` is the reference's (16, 16) or (2, 16,
16) over 256 or 512 launched ranks, and `make_host_mesh` its (1, 1)
mesh at world size 1. `ShapeMesh` carries the axis names and sizes only,
as jax's `AbstractMesh` does: the sharding rules take it, so the specs
of a production mesh are computed on one CPU. `axis_names` and
`axis_sizes` read either kind.

The collectives a sharded form runs on a mesh (`psum`, `all_gather_rows`,
`cohort_rank`) are in core/collectives.py, beside the modules that call
them; this module builds meshes and groups.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.collectives import COHORT_AXES, axis_size, world_size
from repro_torch.runtime import resolve_device

__all__ = ["COHORT_AXES", "ShapeMesh", "ZOO_AXES", "ZOO_AXES_MULTI_POD",
           "axis_names", "axis_size", "axis_sizes", "batch_axes",
           "cohort_axis_divisor", "cohort_mesh", "init_from_launcher",
           "make_host_mesh", "make_production_mesh", "maybe_cohort_mesh",
           "reset_meshes", "world_size", "zoo_mesh"]

ZOO_AXES = ("data", "model")
ZOO_AXES_MULTI_POD = ("pod", "data", "model")

_LAUNCH_HINT = ("launch one process a device, e.g. `torchrun "
                "--nproc-per-node N` (NCCL on CUDA, gloo on the CPU), or "
                "drop to the host path (mesh_aggregate=False)")

_MESHES: dict = {}


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _ensure_group(device: torch.device) -> None:
    """The default group, created with one rank (an in-memory store, no
    launcher) where none exists: gloo for CPU tensors and, where the
    build has NCCL, NCCL for CUDA tensors, so that one group serves
    scenarios on either device. The group must have a backend for the
    device's tensors."""
    want = _backend_for(device)
    if not dist.is_initialized():
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        both = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"
        dist.init_process_group(both, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = str(dist.get_backend())
    if want not in have:
        raise ValueError(
            f"the process group's backend {have!r} has no collectives for "
            f"{device.type} tensors; init_process_group({want!r}) for a "
            f"{device.type} scenario")


def init_from_launcher(device=None) -> torch.device:
    """Under a launcher that sets WORLD_SIZE > 1 (``torchrun``), the
    default group from its environment (NCCL for CUDA, gloo for the CPU),
    with CUDA rank r on card LOCAL_RANK; returns this rank's device
    (`device` resolved as `runtime.resolve_device`, None meaning CUDA).
    Without one, nothing is initialised."""
    import os
    device = resolve_device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group(_backend_for(device))
    return device


def _spanning_mesh(shape: tuple, names: tuple, device, what: str):
    """A `DeviceMesh` of `shape` with dims `names` over every rank of the
    default group (a one-rank group made where there is none), on
    `device`'s type (None means CUDA), cached on (shape, names, device
    type). Raises an actionable ValueError when the group has too few
    ranks, or more ranks than the mesh spans."""
    if any(n < 1 for n in shape):
        raise ValueError(f"{what} axes must be >= 1, got {shape}")
    need, have = math.prod(shape), world_size()
    if have < need:
        raise ValueError(f"{what} needs {need} ranks; have {have} — "
                         f"{_LAUNCH_HINT}")
    if have > need:
        raise ValueError(
            f"{what} spans {need} ranks; the process group has {have} — "
            f"a mesh spans every rank, so launch {need} processes "
            f"(`torchrun --nproc-per-node {need}`)")
    device = resolve_device(device)
    key = (shape, names, device.type)
    mesh = _MESHES.get(key)
    if mesh is None:
        from torch.distributed.device_mesh import init_device_mesh
        _ensure_group(device)
        # analysis: allow=retrace-ctor -- cached in _MESHES on (shape,
        # names, device type)
        mesh = init_device_mesh(device.type, shape, mesh_dim_names=names)
        _MESHES[key] = mesh
    return mesh


def cohort_mesh(pods: int, data: int, device=None):
    """The (pod=pods, data=data) `DeviceMesh` a cohort shards over, on
    `device`'s type (None means CUDA), cached on its shape."""
    return _spanning_mesh((pods, data), COHORT_AXES, device,
                          f"cohort mesh (pod={pods}, data={data})")


def zoo_mesh(data: int, model: int, pods: int = 0, device=None):
    """The zoo's `DeviceMesh` over every rank: (data, model) named
    ZOO_AXES, or (pods, data, model) named ZOO_AXES_MULTI_POD when `pods`
    is given; on `device`'s type (None means CUDA), cached on its
    shape."""
    if pods:
        return _spanning_mesh((pods, data, model), ZOO_AXES_MULTI_POD,
                              device, f"zoo mesh (pod={pods}, data={data}, "
                                      f"model={model})")
    return _spanning_mesh((data, model), ZOO_AXES, device,
                          f"zoo mesh (data={data}, model={model})")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh over the launched ranks: (data=16,
    model=16), or (pod=2, data=16, model=16) with `multi_pod`."""
    return zoo_mesh(16, 16, 2 if multi_pod else 0, device)


def make_host_mesh(device=None):
    """The (data=1, model=1) zoo mesh at world size 1: the production
    axis names on one device, as the reference's."""
    return zoo_mesh(1, 1, 0, device)


class ShapeMesh:
    """Axis names and sizes without devices, as jax's `AbstractMesh`:
    ``ShapeMesh((2, 16, 16), ("pod", "data", "model"))``. The sharding
    rules read nothing else of a mesh."""

    def __init__(self, shape: tuple, names: tuple):
        if len(shape) != len(names):
            raise ValueError(f"shape {shape} and names {names} differ in "
                             f"length")
        self.shape = dict(zip(names, shape))
        self.mesh_dim_names = tuple(names)

    def __repr__(self):
        return f"ShapeMesh({self.shape})"


def axis_names(mesh) -> tuple:
    """The dim names of a `DeviceMesh` or a `ShapeMesh`."""
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """{name: size} of a `DeviceMesh` or a `ShapeMesh`."""
    if isinstance(mesh, ShapeMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def reset_meshes() -> None:
    """Forget the cached meshes (after the process group is destroyed)."""
    _MESHES.clear()


def cohort_axis_divisor(rows_per_pod: int, pods: int,
                        device_count: int = None) -> int:
    """Largest d with d | rows_per_pod and pods * d <= device_count (the
    group's ranks by default): the widest data axis that keeps every
    per-RSU block rank-aligned without padding."""
    if device_count is None:
        device_count = world_size()
    cap = max(1, device_count // max(pods, 1))
    for d in range(min(rows_per_pod, cap), 0, -1):
        if rows_per_pod % d == 0:
            return d
    return 1


def maybe_cohort_mesh(pods: int, rows_per_pod: int, device=None):
    """The auto-resolved cohort mesh: (pod=pods, data=d) with the widest
    d of `cohort_axis_divisor`, or None under 2 ranks, or where that mesh
    would not span every rank (the host path then runs on each rank)."""
    if pods < 1 or rows_per_pod < 1:
        return None
    have = world_size()
    if have < 2 or have < pods:
        return None
    d = cohort_axis_divisor(rows_per_pod, pods, have)
    if pods * d != have:
        return None
    return cohort_mesh(pods, d, device)


def batch_axes(mesh) -> tuple:
    """Mesh dims the cohort, or a zoo batch, shards over."""
    return tuple(a for a in axis_names(mesh) if a in COHORT_AXES)
