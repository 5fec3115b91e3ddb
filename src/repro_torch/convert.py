"""Model trees across the two packages, and the port's flat row layout.

No single JAX counterpart: the reference ravels trees inline
(`repro.kernels.ops.wagg_stacked`, `repro.comms.codecs`). The port's
model tree is a nested dict of tensors with the reference's keys and
layouts (conv weights HWIO), so conversion is a leaf-by-leaf copy:

* `tree_from_numpy(np_tree, device)` — a reference ``{"params",
  "state"}`` tree (numpy leaves, e.g. ``jax.tree.map(np.asarray, t)``)
  into the port's; `tree_to_numpy` goes back.
* `comms_from_numpy(np_comms, device)` — the reference's
  ``FLState.comms`` (None, or ``{"ef": (m, Ppad)}``) into the port's.
* `topo_from_numpy(np_topo, device)` and
  `client_state_from_numpy(np_cs, device)` — the reference's
  ``FLState.topo`` (the handover's positions, RSU models and sync
  statistics) and ``FLState.client_state`` (FedCo's key tree and queue)
  into the port's.
* `zoo_params_from_numpy(np_tree, device=None)` — a reference zoo
  ``T.init_params`` tree (stacked blocks, bfloat16 leaves included) into
  the port's, leaf dtypes kept; `zoo_params_to_numpy` goes back.

The FLAT ROW LAYOUT is the reference's ravel order: `jax.tree.leaves`
order (dict keys sorted at every level, so ``params`` before ``state``),
each leaf raveled C-order in its reference layout. A converted tree thus
ravels to the same (P,) vector `ops.wagg_stacked` builds — which the q8
codec (comms/codecs.py) needs, since one int8 scale covers 256
consecutive raveled parameters. For ResNet-18-CIFAR, P = 11,497,024
params + 9,600 BN stats = 11,506,624.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.runtime import resolve_device


def leaves_with_paths(tree, prefix=()):
    """[(path, leaf)] in the reference's ravel order (sorted keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(leaves, like: dict) -> dict:
    """Leaves in ravel order -> a tree shaped like `like`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def tree_from_numpy(np_tree, device="cpu") -> dict:
    """Reference tree with numpy (or array-like) leaves -> port tree."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    np_tree)


def tree_to_numpy(tree) -> dict:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _leaf_from_numpy(a, device) -> torch.Tensor:
    """numpy leaf -> tensor of the same dtype; numpy's bfloat16 (the
    ml_dtypes type jax hands out) travels as its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.tensor(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def zoo_params_from_numpy(np_tree, device=None) -> dict:
    """Reference zoo params (numpy or array-like leaves, e.g.
    ``jax.tree.map(np.asarray, T.init_params(cfg, key))``) -> the port's
    tree on `device` (None means CUDA), keys, layouts and dtypes kept."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, device), np_tree)


def zoo_params_to_numpy(tree) -> dict:
    """Port zoo params -> numpy leaves; bfloat16 leaves come back as
    float32 (exact), since numpy has no bfloat16 of its own."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, tree)


def comms_from_numpy(np_comms, device="cpu"):
    """Reference ``FLState.comms`` (numpy or array-like leaves) -> the
    port's: None stays None, ``{"ef": (m, Ppad)}`` becomes float32
    tensors on `device`."""
    if np_comms is None:
        return None
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in np_comms.items()}


def topo_from_numpy(np_topo, device="cpu") -> dict:
    """Reference ``FLState.topo`` -> the port's: positions stay host
    float32 and the sync statistics host float64 (numpy), each RSU model
    becomes a tree on `device`; {} stays {}."""
    topo = dict(np_topo or {})
    if "positions" in topo:
        topo["positions"] = np.array(topo["positions"], np.float32)
    for k in ("blur_sum", "upload_count"):
        if k in topo:
            topo[k] = np.array(topo[k], np.float64)
    if "rsu_models" in topo:
        topo["rsu_models"] = tuple(tree_from_numpy(t, device)
                                   for t in topo["rsu_models"])
    return topo


def client_state_from_numpy(np_cs, device="cpu"):
    """Reference ``FLState.client_state`` -> the port's: None stays None,
    FedCo's {"key_tree", "queue"} become a tree and a float32 (K, D)
    tensor on `device`."""
    if np_cs is None:
        return None
    return {"key_tree": tree_from_numpy(np_cs["key_tree"], device),
            "queue": torch.tensor(np.asarray(np_cs["queue"], np.float32),
                                  device=device)}


class FlatSpec(NamedTuple):
    """Where each leaf lives in a flat row: (path, shape, offset, size)."""

    entries: tuple
    size: int


def flat_spec(tree) -> FlatSpec:
    entries, off = [], 0
    for path, leaf in leaves_with_paths(tree):
        n = leaf.numel()
        entries.append((path, tuple(leaf.shape), off, n))
        off += n
    return FlatSpec(tuple(entries), off)


def ravel_into(tree, row: torch.Tensor, spec: FlatSpec) -> None:
    """Write `tree`'s leaves into the (P,) float32 `row` in place."""
    for (path, _, off, n), (_, leaf) in zip(spec.entries,
                                            leaves_with_paths(tree)):
        row[off:off + n].copy_(leaf.reshape(-1))


def ravel(tree) -> torch.Tensor:
    """(P,) float32 row of `tree` in the flat row layout."""
    spec = flat_spec(tree)
    first = leaves_with_paths(tree)[0][1]
    row = torch.empty(spec.size, dtype=torch.float32, device=first.device)
    ravel_into(tree, row, spec)
    return row


def unravel(row: torch.Tensor, spec: FlatSpec) -> dict:
    """(P,) row -> tree whose leaves are views into `row`; (m, P) rows ->
    the stacked tree, each leaf (m, *shape), row i being tree i."""
    tree: dict = {}
    lead = tuple(row.shape[:-1])
    for path, shape, off, n in spec.entries:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = row[..., off:off + n].view(lead + tuple(shape))
    return tree
