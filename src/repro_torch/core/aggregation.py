"""Model aggregation schemes — the paper's core contribution (Eq. 11).

Counterpart of `repro.core.aggregation` (`SCHEME_WEIGHTS`,
`AGGREGATORS`, `cohort_weighted_sum`, `_weighted_stacked_sum`,
`_weighted_tree_sum`, the weight functions and the list API
`aggregate_fedavg`, `aggregate_flsimco`, `aggregate_discard`,
`aggregate_softmax`, `aggregate_inverse`). Every
entry has the dispatch signature

    aggregate(cohort: CohortBatch, cfg) -> tree

  flsimco  — blur-weighted (Eq. 11), weight_n ∝ (ΣL − L_n)/ΣL — the paper
  fedavg   — baseline1: uniform average
  discard  — baseline2: drop clients above cfg.blur_threshold, then fedavg
  softmax  — w ∝ softmax(−L/T), T = 5
  inverse  — w ∝ 1/(L+eps), eps = 1

Every weighted sum goes through `kernels.ops.wagg_flat` — the CUDA
kernel on the card, its plain version on the CPU. There is no tree-map
backend switch.

The collective forms (`weighted_psum_tree`, `normalized_weight_on_axis`)
take a process group (a cohort mesh dim, core/collectives.py) where the
reference takes mesh axis names, and reduce with a float32 `all_reduce`
SUM; every rank of the group gets the same result.
"""
from __future__ import annotations

import torch

from repro_torch.convert import (flat_spec, leaves_with_paths, ravel_into,
                                 tree_map, unravel)
from repro_torch.core.collectives import psum
from repro_torch.kernels import ops


def _weighted_stacked_sum(flat: torch.Tensor, spec, weights,
                          mask=None) -> dict:
    """sum_m w_m * row[m] over an (m, P) cohort buffer, unraveled into
    the model tree (leaves are views of the one (P,) result). `weights`
    already float32 on the buffer's device are used as they are, with no
    copy (the campaign engine's captured round)."""
    # analysis: allow=retrace-fresh-array -- the call's weights, no copy
    # when already float32 on the buffer's device
    w = torch.as_tensor(weights, dtype=torch.float32, device=flat.device)
    return unravel(ops.wagg_flat(flat, w, mask), spec)


def _weighted_tree_sum(trees, weights) -> dict:
    """sum_n w_n * tree_n over a list of model trees: the trees raveled
    into the rows of one (n, P) buffer, then one weighted sum. `weights`
    may be float64 (host weights); they are rounded to float32 here, as
    the reference rounds them at its aggregation boundary."""
    spec = flat_spec(trees[0])
    device = leaves_with_paths(trees[0])[0][1].device
    flat = torch.empty((len(trees), spec.size), dtype=torch.float32,
                       device=device)
    for row, tree in zip(flat, trees):
        ravel_into(tree, row, spec)
    return _weighted_stacked_sum(flat, spec, weights)


def aggregate_fedavg(trees, data_sizes=None) -> dict:
    """Baseline1 over a list of trees: uniform, or weighted by local
    dataset size."""
    if data_sizes is None:
        # analysis: allow=retrace-fresh-array -- the call's n host weights
        w = torch.full((len(trees),), 1.0 / len(trees), dtype=torch.float32)
    else:
        # analysis: allow=retrace-fresh-array -- the call's n host weights
        s = torch.as_tensor(data_sizes, dtype=torch.float32)
        w = s / s.sum()
    return _weighted_tree_sum(trees, w)


def aggregate_flsimco(trees, blur_levels, normalize: bool = True) -> dict:
    """Blur-level-weighted aggregation (Eq. 11) over a list of trees."""
    return _weighted_tree_sum(trees, flsimco_weights(blur_levels, normalize))


def aggregate_discard(trees, blur_levels, threshold: float) -> dict:
    """Baseline2 over a list of trees: clients whose blur level exceeds
    `threshold` dropped, FedAvg over the rest (all of them if none
    remains)."""
    return _weighted_tree_sum(trees, discard_weights(blur_levels, threshold))


def aggregate_softmax(trees, blur_levels, temperature: float = 5.0) -> dict:
    """w = softmax(-L / T) over a list of trees."""
    return _weighted_tree_sum(trees, softmax_weights(blur_levels,
                                                     temperature))


def aggregate_inverse(trees, blur_levels, eps: float = 1.0) -> dict:
    """w proportional to 1 / (L + eps) over a list of trees."""
    return _weighted_tree_sum(trees, inverse_weights(blur_levels, eps))


def cohort_weighted_row(cohort, w_valid) -> torch.Tensor:
    """(n,) weights over the valid rows, zero-padded, applied with the
    cohort's validity mask: the (P,) flat row of the weighted sum."""
    w = cohort.padded_weights(w_valid)
    return ops.wagg_flat(cohort.flat, w, cohort.mask)


def cohort_weighted_sum(cohort, w_valid) -> dict:
    """`cohort_weighted_row` unraveled into the model tree."""
    return unravel(cohort_weighted_row(cohort, w_valid), cohort.spec)


def flsimco_weights(blur_levels, normalize: bool = True) -> torch.Tensor:
    """Eq. (11): w_n = (ΣL − L_n) / ΣL   [/ (N−1) when normalized]."""
    L = torch.as_tensor(blur_levels, dtype=torch.float32)
    n = L.shape[0]
    total = L.sum()
    w = (total - L) / torch.clamp(total, min=1e-12)
    if normalize:
        s = w.sum()
        # degenerate cases (single client, or all-zero blur) -> uniform
        w = torch.where(s > 1e-12, w / torch.clamp(s, min=1e-12),
                        torch.full_like(w, 1.0 / n))
    return w


def discard_weights(blur_levels, threshold: float) -> torch.Tensor:
    """Baseline2: uniform over clients with blur L <= threshold (FedAvg
    over all if every client exceeds it)."""
    L = torch.as_tensor(blur_levels, dtype=torch.float32)
    keep = (L <= threshold).float()
    n_keep = keep.sum()
    return torch.where(n_keep > 0, keep / torch.clamp(n_keep, min=1.0),
                       torch.full_like(keep, 1.0 / keep.shape[0]))


def softmax_weights(blur_levels, temperature: float = 5.0) -> torch.Tensor:
    L = torch.as_tensor(blur_levels, dtype=torch.float32)
    return torch.softmax(-L / temperature, dim=0)


def inverse_weights(blur_levels, eps: float = 1.0) -> torch.Tensor:
    L = torch.as_tensor(blur_levels, dtype=torch.float32)
    w = 1.0 / (L + eps)
    return w / w.sum()


def _weights_flsimco(cohort, cfg):
    return flsimco_weights(cohort.valid_blur, cfg.normalize_weights)


def _weights_fedavg(cohort, cfg):
    return torch.full((cohort.n,), 1.0 / cohort.n, dtype=torch.float32,
                      device=cohort.flat.device)


def _weights_discard(cohort, cfg):
    return discard_weights(cohort.valid_blur, cfg.blur_threshold)


def _weights_softmax(cohort, cfg):
    return softmax_weights(cohort.valid_blur)


def _weights_inverse(cohort, cfg):
    return inverse_weights(cohort.valid_blur)


SCHEME_WEIGHTS = {
    "flsimco": _weights_flsimco,
    "fedavg": _weights_fedavg,
    "discard": _weights_discard,
    "softmax": _weights_softmax,
    "inverse": _weights_inverse,
}


def _make_dispatch(weight_fn):
    def dispatch(cohort, cfg):
        return cohort_weighted_sum(cohort, weight_fn(cohort, cfg))
    return dispatch


AGGREGATORS = {name: _make_dispatch(fn) for name, fn in SCHEME_WEIGHTS.items()}


# --------------------------------------------------------------------------
# collective form
# --------------------------------------------------------------------------

def weighted_psum_tree(tree, weight, group=None):
    """Eq. 11 as one collective: every leaf <- sum over the group's ranks
    of weight * leaf, `weight` this rank's normalized weight (the weights
    sum to 1 over the group). A bare tensor is a one-leaf tree."""
    return tree_map(lambda x: psum(x.float() * weight, group).to(x.dtype),
                    tree)


def normalized_weight_on_axis(blur_level, group=None,
                              normalize: bool = True) -> torch.Tensor:
    """This rank's Eq.-11 weight (sum L - L) / sum L over the group, from
    its scalar blur level L, by scalar all-reduces (no model moves);
    normalized over the group (uniform where the weights vanish)."""
    L = torch.as_tensor(blur_level, dtype=torch.float32)
    total = psum(L.clone(), group)
    w = (total - L) / torch.clamp(total, min=1e-12)
    if normalize:
        wsum = psum(w.clone(), group)
        n = psum(torch.ones_like(w), group)
        w = torch.where(wsum > 1e-12, w / torch.clamp(wsum, min=1e-12),
                        1.0 / n)
    return w
