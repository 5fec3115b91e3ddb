"""Hierarchical (two-level) blur-weighted aggregation — counterpart of
`repro.core.hierarchical` (`aggregate_hierarchical`,
`two_stage_weighted_psum`, `sharded_cohort_sum`, `sharded_aggregate`,
`sharded_hierarchical`, `reset_sharded_caches`).

  level 1 (RSU r):   theta_r = sum_{n in r} w_n theta_n,
                     w_n ∝ (Σ_r L − L_n)   over vehicles at RSU r
  level 2 (region):  theta   = sum_r W_r theta_r,
                     W_r ∝ (Σ L̄ − L̄_r)    over RSU mean blur levels,
                     optionally scaled by each RSU's vehicle count.

Level 1 is one `cohort_weighted_row` per RSU, each a row of one
(n_rsus, P) buffer; level 2 is one weighted sum over that buffer,
unraveled once: n_rsus + 1 `ops.wagg_flat` calls. The weights and the
counts stay on the cohorts' device (each count is its validity mask's
sum), so the campaign engine's captured round runs it with no host copy
(core/engine.py).

Sharded cohorts: the cohort's rows split over a cohort mesh
(launch/mesh.py; `CohortBatch.shard`), one block a rank, and the same
result on every rank. Every reduction is `ops.wagg_flat` (the `wagg`
kernel on the card), which sums each column in ascending row order from
+0.0, so the forms that only move rows are bitwise the host forms:

* `sharded_cohort_sum` / `sharded_aggregate` — the ``AGGREGATORS`` sum.
  "gather" all_gathers the blocks and makes the host call; "split"
  all_to_alls the (m/D, P) blocks into (m, P/D) column slices, reduces
  each slice on its rank and all_gathers the columns (a rank holds
  O(m P / D)).
* `sharded_hierarchical` — the two-level Eq. 11 with RSU r's rows on
  pod r. "exact" gathers each RSU's rows over "data" and the RSU models
  over "pod", with the host's weights; "psum" is the blocked
  `two_stage_weighted_psum`, which moves one model a rank and
  reassociates the row sum (float-close, not bitwise).

The reference caches its `shard_map`ped callables and a device copy of
the RSU counts (`_count_scale`); the port compiles nothing, and computes
the counts on the device, as `hierarchical_row` does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.convert import flat_spec, leaves_with_paths, unravel
from repro_torch.core.aggregation import (SCHEME_WEIGHTS, cohort_weighted_row,
                                          flsimco_weights, weighted_psum_tree)
from repro_torch.core.cohort import CohortBatch
from repro_torch.core.collectives import (COHORT_AXES, all_gather_rows,
                                          axis_size, psum)
from repro_torch.kernels import ops


def _as_cohort(group, blur) -> CohortBatch:
    """One RSU group as a `CohortBatch`: it already is one (blur
    attached), or a list of client trees with its (N_r,) blur levels."""
    if isinstance(group, CohortBatch):
        return group
    device = leaves_with_paths(group[0])[0][1].device
    cohort = CohortBatch.empty(flat_spec(group[0]), len(group), device=device)
    for i, tree in enumerate(group):
        cohort.write(i, tree, 0.0)
    return cohort.with_stats(blur=blur)


def hierarchical_row(cohorts: Sequence[CohortBatch],
                     count_scaled: bool = True) -> torch.Tensor:
    """The region's model as a (P,) flat row, from one `CohortBatch` an
    RSU with its blur levels attached."""
    rsu_flat = torch.stack([
        cohort_weighted_row(c, flsimco_weights(c.valid_blur))
        for c in cohorts])
    W = flsimco_weights(torch.stack([c.valid_blur.mean() for c in cohorts]))
    if count_scaled:
        W = W * torch.stack([c.mask.sum() for c in cohorts])
        W = W / W.sum()
    return ops.wagg_flat(rsu_flat, W)


def aggregate_hierarchical(groups: Sequence, blur_groups: Sequence = None,
                           count_scaled: bool = True) -> dict:
    """groups[r] = the cohort at RSU r (a `CohortBatch` with blur
    attached, or a list of client trees with blur_groups[r] its (N_r,)
    blur levels). Returns the region's model tree."""
    blur_groups = blur_groups or [None] * len(groups)
    cohorts = [_as_cohort(g, b) for g, b in zip(groups, blur_groups)]
    return unravel(hierarchical_row(cohorts, count_scaled), cohorts[0].spec)


# --------------------------------------------------------------------------
# the mesh-level two-stage collective
# --------------------------------------------------------------------------

def two_stage_weighted_psum(rows: torch.Tensor, blur_level, *,
                            rsu_group=None, region_group=None,
                            count_scaled: bool = True, accum_dtype=None):
    """Hierarchical Eq. 11 as two collectives: a weighted all-reduce over
    `rsu_group` (the ranks of one RSU, mesh dim "data"), then over
    `region_group` (one rank of each RSU, mesh dim "pod"). Returns the
    region's (P,) row, the same on every rank.

    blur_level: a scalar when this rank holds one vehicle's (P,) row, or
    a (b,) block for its (b, P) rows; the block form reduces its rows
    locally (`ops.wagg_flat`) and all-reduces the partial sums, one model
    a rank on the wire (float-close against the host forms: the row sum
    is reassociated). With `accum_dtype` (torch.float64) both levels
    accumulate in that dtype, cast back to float32 after level 2."""
    # analysis: allow=retrace-fresh-array -- the call's blur levels, no
    # copy when already float32 on the rows' device
    L = torch.as_tensor(blur_level, dtype=torch.float32, device=rows.device)
    blocked = L.dim() > 0
    ad = accum_dtype
    # level 1: vehicles within the RSU
    tot1 = psum(L.sum() if blocked else L.clone(), rsu_group)
    # analysis: allow=retrace-fresh-array -- the 0-d count the all-reduce
    # sums, filled on the rows' device (no upload)
    n1 = psum(torch.full((), L.numel(), dtype=torch.float32,
                               device=rows.device), rsu_group)
    w1 = (tot1 - L) / torch.clamp(tot1, min=1e-12)
    s1 = psum(w1.sum() if blocked else w1.clone(), rsu_group)
    w1 = torch.where(s1 > 1e-12, w1 / torch.clamp(s1, min=1e-12), 1.0 / n1)
    if blocked:
        part = (ops.wagg_flat(rows, w1) if ad is None
                else w1.to(ad) @ rows.to(ad))
        rsu_row = psum(part, rsu_group)
    elif ad is not None:
        rsu_row = psum(rows.to(ad) * w1.to(ad), rsu_group)
    else:
        rsu_row = weighted_psum_tree(rows, w1, rsu_group)
    # level 2: RSUs within the region; each RSU's quantities are the same
    # on all its ranks after level 1, and the region group holds one rank
    # of each RSU, so nothing is counted twice
    Lbar = tot1 / n1
    tot2 = psum(Lbar.clone(), region_group)
    n2 = psum(torch.ones_like(Lbar), region_group)
    w2 = (tot2 - Lbar) / torch.clamp(tot2, min=1e-12)
    if count_scaled:
        w2 = w2 * n1
    s2 = psum(w2.clone(), region_group)
    w2 = torch.where(s2 > 1e-12, w2 / torch.clamp(s2, min=1e-12), 1.0 / n2)
    if ad is not None:
        return psum(rsu_row * w2.to(ad), region_group).float()
    return weighted_psum_tree(rsu_row, w2, region_group)


# --------------------------------------------------------------------------
# sharded cohorts
# --------------------------------------------------------------------------

def _sharded(cohort: CohortBatch, mesh) -> CohortBatch:
    return cohort if cohort.mesh is mesh else cohort.shard(mesh)


def sharded_cohort_row(cohort: CohortBatch, w_valid, mesh, *,
                       reduction: str = "gather") -> torch.Tensor:
    """`cohort_weighted_row` with the rows sharded over `mesh`: the (P,)
    row on every rank, bitwise the host call's in either reduction.
    `cohort` is the whole cohort or its `shard(mesh)`; a size that does
    not divide the mesh is re-padded (zero-weight, masked rows)."""
    if reduction not in ("gather", "split"):
        raise ValueError(f"reduction {reduction!r} not in "
                         f"('gather', 'split')")
    sh = _sharded(cohort, mesh)
    w = sh.padded_weights(w_valid)
    if reduction == "gather":
        return ops.wagg_flat(all_gather_rows(sh.flat), w, sh.mask)
    # split: rank j gets every rank's rows of column slice j; P padded to
    # a multiple of 4 D so each slice keeps the kernel's 16-byte rows
    d = axis_size(mesh)
    b, p = sh.flat.shape
    pd = -(-p // (4 * d)) * 4
    blk = sh.flat.new_zeros((b, d * pd))
    blk[:, :p] = sh.flat
    send = blk.view(b, d, pd).transpose(0, 1).contiguous()
    cols = torch.empty_like(send)
    dist.all_to_all_single(cols, send)
    part = ops.wagg_flat(cols.view(d * b, pd), w, sh.mask)
    return all_gather_rows(part).view(-1)[:p]


def sharded_cohort_sum(cohort: CohortBatch, w_valid, mesh, *,
                       reduction: str = "gather") -> dict:
    """`sharded_cohort_row` unraveled into the model tree."""
    return unravel(sharded_cohort_row(cohort, w_valid, mesh,
                                      reduction=reduction), cohort.spec)


def sharded_aggregate(cohort: CohortBatch, cfg, mesh, *, scheme: str = None,
                      reduction: str = "gather") -> dict:
    """``AGGREGATORS[scheme]`` (cfg.aggregator by default) with the rows
    sharded over `mesh`: the weights from the same ``SCHEME_WEIGHTS``
    entry on the cohort's (replicated) stats, so bitwise the host
    aggregator for all five schemes."""
    scheme = cfg.aggregator if scheme is None else scheme
    return sharded_cohort_sum(cohort, SCHEME_WEIGHTS[scheme](cohort, cfg),
                              mesh, reduction=reduction)


def sharded_hierarchical_row(cohort: CohortBatch, mesh, n_rsus: int, *,
                             count_scaled: bool = True,
                             reduction: str = "exact",
                             accum_dtype=None) -> torch.Tensor:
    """Two-level Eq. 11 over an RSU-major cohort on `mesh` (pod=n_rsus,
    data=d with d | the per-RSU size): the cohort (whole, or its
    `shard(mesh)`) has every row valid, RSU r's s rows at [r s, (r + 1)
    s), and its blur attached. "exact" computes both levels' weights as
    `hierarchical_row` does and reduces through gathers, bitwise its
    result; "psum" is the blocked `two_stage_weighted_psum` (float-close;
    `accum_dtype` widens its accumulator). Returns the (P,) row."""
    if reduction not in ("exact", "psum"):
        raise ValueError(f"reduction {reduction!r} not in ('exact', 'psum')")
    R, m = n_rsus, cohort.n
    if m % R or cohort.size != m:
        raise ValueError(f"rsu-major cohort of {m} valid rows (of "
                         f"{cohort.size}) not divisible by n_rsus={R}")
    s = m // R
    pods, data = (axis_size(mesh, a) for a in COHORT_AXES)
    if pods != R or s % data:
        raise ValueError(f"mesh (pod={pods}, data={data}) does not hold "
                         f"{R} RSUs of {s} rows, one RSU a pod")
    sh = _sharded(cohort, mesh)
    blur = sh.valid_blur.float()
    data_g, pod_g = mesh.get_group("data"), mesh.get_group("pod")
    if reduction == "psum":
        blk = blur[sh.row0:sh.row0 + sh.flat.shape[0]]
        return two_stage_weighted_psum(sh.flat, blk, rsu_group=data_g,
                                       region_group=pod_g,
                                       count_scaled=count_scaled,
                                       accum_dtype=accum_dtype)
    blocks = [blur[r * s:(r + 1) * s] for r in range(R)]
    pod = mesh.get_coordinate()[0]
    rsu_row = ops.wagg_flat(all_gather_rows(sh.flat, data_g),
                            flsimco_weights(blocks[pod]))
    W = flsimco_weights(torch.stack([b.mean() for b in blocks]))
    if count_scaled:
        W = W * s
        W = W / W.sum()
    return ops.wagg_flat(all_gather_rows(rsu_row[None], pod_g), W)


def sharded_hierarchical(cohort: CohortBatch, mesh, n_rsus: int, *,
                         count_scaled: bool = True, reduction: str = "exact",
                         accum_dtype=None) -> dict:
    """`sharded_hierarchical_row` unraveled into the model tree. The
    reference takes the stacked trees and the blur apart; the port takes
    them as one `CohortBatch`, as `aggregate_hierarchical` does."""
    return unravel(sharded_hierarchical_row(
        cohort, mesh, n_rsus, count_scaled=count_scaled, reduction=reduction,
        accum_dtype=accum_dtype), cohort.spec)


def reset_sharded_caches() -> None:
    """Drop the cached cohort meshes (test isolation, or after the process
    group is destroyed); the port caches no sharded callables."""
    from repro_torch.launch.mesh import reset_meshes
    reset_meshes()
