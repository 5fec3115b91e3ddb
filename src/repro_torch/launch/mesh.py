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

The reference's `make_production_mesh` and `make_host_mesh` are TPU pod
shapes (ROADMAP.md Queue A, item 12, mesh lowering) and are not here.
The collectives a sharded form runs on a mesh (`psum`, `all_gather_rows`,
`cohort_rank`) are in core/collectives.py, beside the modules that call
them; this module builds meshes and groups.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.collectives import COHORT_AXES, axis_size, world_size
from repro_torch.runtime import resolve_device

__all__ = ["COHORT_AXES", "axis_size", "batch_axes", "cohort_axis_divisor",
           "cohort_mesh", "init_from_launcher", "maybe_cohort_mesh",
           "reset_meshes", "world_size"]

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


def cohort_mesh(pods: int, data: int, device=None):
    """The (pod=pods, data=data) `DeviceMesh` a cohort shards over, on
    `device`'s type (None means CUDA), cached on its shape. Raises an
    actionable ValueError when the group has too few ranks, or more ranks
    than the mesh spans."""
    if pods < 1 or data < 1:
        raise ValueError(f"cohort mesh axes must be >= 1, got "
                         f"(pod={pods}, data={data})")
    need, have = pods * data, world_size()
    if have < need:
        raise ValueError(
            f"cohort mesh (pod={pods}, data={data}) needs {need} ranks; "
            f"have {have} — {_LAUNCH_HINT}")
    if have > need:
        raise ValueError(
            f"cohort mesh (pod={pods}, data={data}) spans {need} ranks; "
            f"the process group has {have} — every rank holds a block of "
            f"the cohort, so launch {need} processes "
            f"(`torchrun --nproc-per-node {need}`)")
    device = resolve_device(device)
    key = (pods, data, device.type)
    mesh = _MESHES.get(key)
    if mesh is None:
        from torch.distributed.device_mesh import init_device_mesh
        _ensure_group(device)
        # analysis: allow=retrace-ctor -- cached in _MESHES on (pods, data,
        # device type)
        mesh = init_device_mesh(device.type, (pods, data),
                                mesh_dim_names=COHORT_AXES)
        _MESHES[key] = mesh
    return mesh


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
    """Mesh dims the cohort shards over."""
    return tuple(a for a in mesh.mesh_dim_names if a in COHORT_AXES)
