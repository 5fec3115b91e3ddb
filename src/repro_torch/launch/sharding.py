"""Parameter, activation and cache sharding rules — counterpart of
`repro.launch.sharding` (`sanitize`, `param_spec`, `params_shardings`,
`batch_spec`, `tokens_sharding`, `kv_cache_spec`, `cache_shardings`,
`make_activation_rules`).

Strategy, as the reference's: Megatron-style tensor parallelism on the
``model`` axis and FSDP-style weight sharding on the ("pod", "data")
axes, with per-tensor divisibility checks that fall back to replication
(`sanitize` drops any axis that does not divide its dim).

A spec is a tuple with one entry a tensor dim: None (replicated), an
axis name, or a tuple of axis names (the dim split over several mesh
dims, the first the major one). The rules give the same tuples as the
reference's `PartitionSpec`s, normalised as `PartitionSpec` normalises
them (a one-name tuple is the name). They read only the mesh's axis
names and sizes, so they take a `DeviceMesh` over the launched ranks or
a `launch.mesh.ShapeMesh` (the counterpart of jax's `AbstractMesh`),
which computes the specs of a production mesh on one CPU.

On a `DeviceMesh` a spec becomes DTensor placements (`placements_of`):
mesh dim i gets ``Shard(d)`` where tensor dim d's entry names it, else
``Replicate()``. `shard_tree` makes a tree of DTensors from full
tensors, each rank slicing its own shard (no communication);
`gather_tree` gathers one back (`full`, a tensor). `make_activation_rules` gives the
`models.sharding_hooks.constrain` function of a mesh: a DTensor
activation is redistributed to its named layout (GSPMD's
`with_sharding_constraint`), a plain tensor passes through.
"""
from __future__ import annotations

import math

import torch

from repro_torch.convert import leaves_with_paths, unflatten
from repro_torch.launch.mesh import axis_names, axis_sizes, batch_axes
from repro_torch.models.sharding_hooks import is_dtensor

__all__ = ["batch_spec", "cache_shardings", "full", "gather_tree",
           "kv_cache_spec", "make_activation_rules", "param_spec",
           "params_shardings", "placements_of", "sanitize", "shard_like",
           "shard_tree", "tokens_sharding"]

STACKED = ("blocks", "dense_blocks", "cross_blocks", "enc_blocks")


def _entry(axes):
    """A spec entry as `PartitionSpec` keeps it: a one-name tuple is the
    name, an empty one None."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    return axes


def _spec(*entries) -> tuple:
    return tuple(_entry(a) for a in entries)


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def sanitize(mesh, spec: tuple, shape) -> tuple:
    """Drop spec axes that don't divide the tensor dim (a tuple keeps its
    longest dividing prefix); one entry a dim of `shape`."""
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if axes is None:
            out.append(None)
        elif dim % _size(mesh, axes) == 0:
            out.append(axes)
        elif not isinstance(axes, str):
            kept = []
            for a in axes:
                if dim % _size(mesh, tuple(kept) + (a,)) == 0:
                    kept.append(a)
            out.append(tuple(kept) if kept else None)
        else:
            out.append(None)
    return _spec(*out)


def param_spec(mesh, path: str, shape, *, fsdp: bool = True,
               stacked_prefix: int = 0) -> tuple:
    """The spec of one parameter leaf at `path` ("blocks/attn/wq").

    `stacked_prefix` leading stacked-layer axes stay unsharded; `fsdp`
    adds the ("pod", "data") axes on the non-model dim of large 2-D
    weights."""
    fs = batch_axes(mesh) if fsdp else None
    core = shape[stacked_prefix:]
    nd = len(core)

    def rule(*spec):
        return sanitize(mesh, (None,) * stacked_prefix + spec, shape)

    last = path.rsplit("/", 1)[-1]
    # embeddings / unembed
    if last == "embed":                          # (V, d)
        return rule("model", fs)
    if last == "unembed":                        # (d, V)
        return rule(fs, "model")
    if last in ("vision_proj", "audio_adapter"):
        return rule(None, "model")
    # MoE
    if last == "router":                         # (d, E)
        return rule(None, "model")
    if "moe" in path and last in ("w_up", "w_gate", "w_down") and nd == 3:
        return rule("model", fs, None)           # experts on model
    # attention
    if last in ("wq", "wk", "wv"):               # (d, H * hd)
        return rule(fs, "model")
    if last == "wo":                             # (H * hd, d)
        return rule("model", fs)
    if last in ("bq", "bk", "bv"):
        return rule("model")
    # MLP
    if last in ("w_up", "w_gate"):               # (d, f)
        return rule(fs, "model")
    if last == "w_down":                         # (f, d)
        return rule("model", fs)
    # rwkv (wk, wv are caught above, as in the reference)
    if last in ("wr", "wk", "wv", "wg"):
        return rule(fs, "model")
    if last == "w_lora_a":
        return rule(fs, None)
    if last == "w_lora_b":
        return rule(None, "model")
    # ssm
    if last == "w_in":                           # (d, 2 di)
        return rule(fs, "model")
    if last == "w_out":                          # (di, d)
        return rule("model", fs)
    if last == "w_dt":                           # (di, di)
        return rule(fs, "model")
    if last in ("w_B", "w_C"):                   # (di, st)
        return rule("model", None)
    if last in ("A_log", "D", "b_dt"):
        return rule("model")
    if last == "conv":                           # (4, di)
        return rule(None, "model")
    # projector / probe / small
    if nd == 2 and min(core) >= 128:
        return rule(fs, "model")
    return ()                                    # replicated


def _stacked(path: str, vlm: bool) -> int:
    if not path.startswith(STACKED):
        return 0
    return 2 if vlm and path.startswith("blocks/") else 1


def params_shardings(mesh, params, *, fsdp: bool = True, vlm: bool = False):
    """A tree like `params` (tensors, or anything with ``.shape``) of
    specs, one entry a dim of each leaf (a spec tuple is a leaf of the
    port's trees, which nest dicts only)."""
    specs = []
    for path, leaf in leaves_with_paths(params):
        ps = "/".join(path)
        spec = param_spec(mesh, ps, tuple(leaf.shape), fsdp=fsdp,
                          stacked_prefix=_stacked(ps, vlm))
        specs.append(sanitize(mesh, spec, tuple(leaf.shape)))
    return unflatten(specs, params)


# --------------------------------------------------------------------------
# data and cache shardings
# --------------------------------------------------------------------------

def batch_spec(mesh, global_batch: int) -> tuple:
    """Batch over (pod, data) when divisible, else over data, else
    replicated: a one-entry spec."""
    ba = batch_axes(mesh)
    if global_batch % _size(mesh, ba) == 0:
        return _spec(ba)
    if "data" in ba and global_batch % axis_sizes(mesh)["data"] == 0:
        return _spec("data")
    return (None,)


def tokens_sharding(mesh, global_batch: int) -> tuple:
    """The (B, S) tokens' spec."""
    return batch_spec(mesh, global_batch) + (None,)


def kv_cache_spec(mesh, shape, bax, prefix: int = 1) -> tuple:
    """Preference chain for (L?, B, W, KH, hd) KV buffers: heads on
    model if divisible, else the W axis, else head_dim, else only the
    batch."""
    pre = (None,) * prefix
    for cand in (_spec(*pre, bax, None, "model", None),
                 _spec(*pre, bax, "model", None, None),
                 _spec(*pre, bax, None, None, "model")):
        if sanitize(mesh, cand, shape) == cand:
            return cand
    return sanitize(mesh, (*pre, bax, None, None, None), shape)


def cache_shardings(mesh, cache, global_batch: int):
    """A tree like `cache` of specs: batch on (pod, data); KV heads on
    model if divisible, else W, else head_dim; SSM and rwkv states on
    their channel axis."""
    b = batch_spec(mesh, global_batch)
    bax = b[0] if len(b) else None
    specs = []
    for path, leaf in leaves_with_paths(cache):
        shp = tuple(leaf.shape)
        last = path[-1]
        if last in ("k", "v"):                    # (L, B, W, KH, hd)
            spec = kv_cache_spec(mesh, shp, bax)
        elif last in ("k_scale", "v_scale"):      # (L, B, W, KH)
            full = kv_cache_spec(mesh, shp + (1,), bax)
            spec = sanitize(mesh, full[:4], shp)
        elif last == "pos":                       # (L, B, W)
            spec = sanitize(mesh, (None, bax, None), shp)
        elif last == "state" and len(shp) == 5:   # rwkv (L, B, H, D, D)
            spec = sanitize(mesh, (None, bax, "model", None, None), shp)
        elif last == "ssm":                       # (L, B, di, st)
            spec = sanitize(mesh, (None, bax, "model", None), shp)
        elif last == "conv":                      # (L, B, 3, di)
            spec = sanitize(mesh, (None, bax, None, "model"), shp)
        elif last in ("x_last_t", "x_last_c"):    # (L, B, d)
            spec = sanitize(mesh, (None, bax, None), shp)
        elif last == "ctx":                       # (B, T, d)
            spec = sanitize(mesh, (bax, None, None), shp)
        else:
            spec = ()
        specs.append(spec)
    return unflatten(specs, cache)


# --------------------------------------------------------------------------
# specs as DTensor placements
# --------------------------------------------------------------------------

def placements_of(mesh, spec: tuple, shape=None) -> tuple:
    """DTensor placements of `spec` on the `DeviceMesh` `mesh`: mesh dim
    i is ``Shard(d)`` where entry d names it, else ``Replicate()``. A
    dim over several mesh dims takes them in the mesh's order, the first
    the major split, which is the reference's tuple order; a tuple in
    another order raises ValueError. Given the tensor's `shape`, a dim
    of size 1 stays replicated: `sanitize` keeps it only over mesh dims
    of size 1, where a shard is the whole, and DTensor's view rules
    drop a size-1 dim, so a product that folds a sharded one (a
    micro-batch of one sequence at world size 1) finds no strategy."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None or (shape is not None and shape[d] == 1):
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_like(t: torch.Tensor, mesh, spec: tuple):
    """The full tensor `t` (the same on every rank) as a DTensor with
    `spec`'s placements: each rank keeps its own slice, nothing is
    sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements_of(mesh, spec, t.shape),
                             src_data_rank=None)


def shard_tree(tree, mesh, specs):
    """`tree`'s tensors as DTensors by the spec tree `specs` (from
    `params_shardings` or `cache_shardings`)."""
    leaves = [shard_like(t, mesh, s) for (_, t), (_, s) in
              zip(leaves_with_paths(tree), leaves_with_paths(specs))]
    return unflatten(leaves, tree)


def full(t):
    """The full tensor of a DTensor (gathered, on every rank); any other
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def gather_tree(tree):
    """`full` of every leaf of `tree`."""
    return unflatten([full(t) for _, t in leaves_with_paths(tree)], tree)


# --------------------------------------------------------------------------
# activation rules for models.sharding_hooks
# --------------------------------------------------------------------------

def make_activation_rules(mesh, global_batch: int):
    """constrain(x, name) for `models.sharding_hooks`: a DTensor `x` is
    redistributed to the layout its logical `name` has on `mesh` (the
    reference's table, each spec sanitised for x's shape); a plain
    tensor, or an unknown name, passes through."""
    b = batch_spec(mesh, global_batch)
    bax = b[0] if len(b) else None
    table = {
        "tokens_bsd": (bax, None, None),
        "tokens_bsf": (bax, None, "model"),
        "attn_bshd": (bax, None, "model", None),
        "moe_ecd": ("model", None, None),
        "logits_bsv": (bax, None, "model"),
    }

    def constrain(x, name):
        if not is_dtensor(x):
            return x
        if name == "cache_kv":                    # (B, W, KH, hd)
            spec = kv_cache_spec(mesh, tuple(x.shape), bax, prefix=0)
        elif name in table:
            spec = sanitize(mesh, table[name], tuple(x.shape))
        else:
            return x
        want = placements_of(mesh, spec, x.shape)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(mesh, want)

    return constrain
