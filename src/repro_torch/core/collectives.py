"""Collectives over a cohort mesh's process groups — the port's
counterpart of the `jax.lax` collectives (`psum`, `all_gather`,
`axis_index`, `axis_size`) that the reference's sharded forms call inside
`shard_map`.

A cohort mesh is a `DeviceMesh` of shape (pods, data) with dims named
`COHORT_AXES` over the default process group; launch/mesh.py builds it.
Rank r is mesh coordinate (r // data, r % data) and holds the r-th
contiguous block of a sharded cohort's rows. Every function here takes
the mesh, or one of its dims' process groups, as it is given; none
creates a group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

COHORT_AXES = ("pod", "data")


def world_size() -> int:
    """Ranks in the default process group; 1 where there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def axis_size(mesh, names=COHORT_AXES) -> int:
    """Ranks along the named dims (all the cohort dims by default)."""
    s = 1
    for n in ([names] if isinstance(names, str) else names):
        if n in mesh.mesh_dim_names:
            s *= mesh.size(mesh.mesh_dim_names.index(n))
    return s


def is_sharded(mesh) -> bool:
    """Whether a cohort on `mesh` is split over more than one rank (a
    1 x 1 mesh, or none, keeps every row on this rank)."""
    return mesh is not None and axis_size(mesh) > 1


def cohort_rank(mesh) -> int:
    """This rank's position along the flattened (pod, data) cohort axis."""
    pod, data = mesh.get_coordinate()
    return pod * axis_size(mesh, "data") + data


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` summed over the ranks of `group` (the default group when None),
    in place; returns it."""
    dist.all_reduce(x, group=group)
    return x


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's (b, ...) block of `group` (the default group when
    None), stacked in rank order along dim 0: (b * ranks, ...)."""
    k = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((k * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, x, group=group)
    return out
