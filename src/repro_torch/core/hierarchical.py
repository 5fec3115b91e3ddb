"""Hierarchical (two-level) blur-weighted aggregation — counterpart of
`repro.core.hierarchical.aggregate_hierarchical`, the host form.

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
(core/engine.py). The mesh forms
(`two_stage_weighted_psum`, `sharded_*`) are ROADMAP.md Queue A, item 9.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.convert import flat_spec, leaves_with_paths, unravel
from repro_torch.core.aggregation import cohort_weighted_row, flsimco_weights
from repro_torch.core.cohort import CohortBatch
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
