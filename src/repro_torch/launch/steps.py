"""Train and serve steps of the zoo — counterpart of
`repro.launch.steps` (`input_specs`, `params_specs`, `pick_n_micro`,
`make_train_step`, `init_momentum`, `make_prefill_step`,
`make_decode_step` and the losses).

Without a mesh a step runs on one device, the one the params and tokens
lie on. With a zoo mesh (`launch.mesh.zoo_mesh`, a `DeviceMesh` over the
launched ranks) it is the reference's pjit step: the params and the
momentum are DTensors placed by `launch.sharding.params_shardings`
(`shard_params`), the batch is placed by `input_specs` (a step takes
DTensors or full tensors, the same on every rank, and places the
latter), the cache by `cache_shardings`, and the model runs on the
DTensors under `sharding.make_activation_rules` (the hooks of
`models.sharding_hooks`). The update runs leaf by leaf on the DTensors,
each gradient placed like its leaf. The mesh steps take every zoo
family (MESH_FAMILIES): the ``ssm`` family's rwkv6 kernel and the
``hybrid`` family's selective scan run on each rank's shards
(`models.layers.rwkv6_on_shards`, `_ssm_scan_on_shards`), and the
``audio`` and ``vlm`` contexts are placed on the batch.

Federated mapping, as the reference's: for one local iteration,
FLSimCo's Eq.-11 aggregation is exactly a blur-weighted gradient sum,

    theta' = sum_n w_n (theta - eta g_n) = theta - eta sum_n w_n g_n,

so the train step weights each example's loss by its normalised Eq.-11
weight (`_flsimco_example_weights`). On a mesh that sum is the weighted
all-reduce the DTensor gradients carry; on one card it is the sum over
the batch. Micro-batches accumulate their gradients in float32, as the
reference's scan does; on a mesh each micro-batch is the same rows as
on one card (the batch is split whole, then each part placed). The DT
loss on a mesh takes every feature row: the features are gathered over
the batch axes and every rank runs `ops.dt_loss` (the DT kernel on the
card) on the same (M, D), as GSPMD does for the reference's jnp loss.
The ``audio`` family's batches carry ``frames`` (B, `enc_ctx_len`,
d_audio) and the ``vlm`` family's ``patches`` (B, n_vision_tokens,
d_vision) beside the tokens, split into the micro-batches with them,
and their prefills write the context into the cache.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.configs.base import InputShape
from repro_torch.convert import leaves_with_paths, tree_map, unflatten
from repro_torch.core.mobility import BLUR_KMH_100
from repro_torch.kernels import ops
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models import transformer as T
from repro_torch.models.sharding_hooks import (activation_sharding,
                                               is_dtensor, replicated_like)

MASK_TOKEN = 0  # token id used for DT-objective masking views
DROP_P = 0.15   # the DT objective's token drop rate, a view each
AGGREGATIONS = ("flsimco", "fedavg", "discard")
AUX_KEYS = ("frames", "patches")   # the context inputs: audio's, vlm's
MESH_FAMILIES = T.ZOO_FAMILIES     # the families the mesh steps take


def enc_ctx_len(cfg, seq_len: int) -> int:
    """Context rows for `seq_len` tokens: the ``audio`` family's
    (the reference's frames length, max(S // 4, 8)), the ``vlm``
    family's n_vision_tokens whatever `seq_len` is; 0 for the other
    families."""
    if cfg.family == "vlm":
        return cfg.n_vision_tokens
    return max(seq_len // 4, 8) if cfg.family == "audio" else 0


def frames_shape(cfg, batch: int, seq_len: int) -> tuple:
    """(B, enc_ctx_len, d_audio): the ``audio`` family's frame
    embeddings for `batch` sequences of `seq_len` tokens."""
    return (batch, enc_ctx_len(cfg, seq_len), cfg.d_audio)


def patches_shape(cfg, batch: int) -> tuple:
    """(B, n_vision_tokens, d_vision): the ``vlm`` family's patch
    embeddings for `batch` sequences (of any length)."""
    return (batch, cfg.n_vision_tokens, cfg.d_vision)


# --------------------------------------------------------------------------
# input and parameter specs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placed:
    """A tensor's shape and dtype (a meta tensor) and its spec on a mesh:
    the counterpart of a `jax.ShapeDtypeStruct` with a sharding."""

    meta: torch.Tensor
    spec: tuple

    @property
    def shape(self) -> tuple:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype


def _placed(mesh, shape, dtype, spec) -> Placed:
    return Placed(torch.empty(shape, dtype=dtype, device="meta"),
                  sh.sanitize(mesh, spec, shape))


def _aux_shapes(cfg, b: int, s: int) -> dict:
    if cfg.family == "vlm":
        return {"patches": patches_shape(cfg, b)}
    if cfg.family == "audio":
        return {"frames": frames_shape(cfg, b, s)}
    return {}


def input_specs(cfg, shape: InputShape, mesh, param_dtype=torch.bfloat16,
                cache_dtype=None, objective: str = "lm") -> dict:
    """`Placed` stand-ins for one workload's inputs, as the reference's:

    train:   {"tokens", "blur", aux...}
    prefill: {"tokens", aux...}
    decode:  {"tokens", "positions", "cache"}

    The batch is on (pod, data) where it divides (`batch_spec`); the
    cache follows `cache_shardings`. `mesh` is a `DeviceMesh` or a
    `ShapeMesh`. A ``dt`` train step (`objective`) also takes its
    views' drop masks, ``drops`` (2, B, S) bool with the batch on dim 1
    (the reference draws them inside its step from a key)."""
    b, s = shape.global_batch, shape.seq_len
    bax = sh.batch_spec(mesh, b)[0]
    aux = {k: _placed(mesh, shp, torch.bfloat16, (bax, None, None))
           for k, shp in _aux_shapes(cfg, b, s).items()}
    if shape.kind == "train":
        if objective == "dt":
            aux["drops"] = _placed(mesh, (2, b, s), torch.bool,
                                   (None, bax, None))
        return {"tokens": _placed(mesh, (b, s), torch.int64, (bax, None)),
                "blur": _placed(mesh, (b,), torch.float32, (bax,)), **aux}
    if shape.kind == "prefill":
        return {"tokens": _placed(mesh, (b, s), torch.int64, (bax, None)),
                **aux}
    cache = T.init_cache(cfg, b, s, dtype=cache_dtype or param_dtype,
                         device="meta", long_context=_long_context(shape),
                         ctx_len=enc_ctx_len(cfg, s))
    specs = sh.cache_shardings(mesh, cache, b)
    return {"tokens": _placed(mesh, (b, 1), torch.int64, (bax, None)),
            "positions": _placed(mesh, (b,), torch.int64, (bax,)),
            "cache": unflatten([Placed(t, sp) for (_, t), (_, sp) in zip(
                leaves_with_paths(cache), leaves_with_paths(specs))],
                cache)}


def params_specs(cfg, mesh, param_dtype=torch.bfloat16):
    """(a tree of `Placed` for the parameters, their spec tree), from
    `transformer.param_shapes` (nothing allocated) and
    `params_shardings`."""
    meta = T.param_shapes(cfg, param_dtype)
    specs = sh.params_shardings(mesh, meta, vlm=cfg.family == "vlm")
    return unflatten([Placed(t, sp) for (_, t), (_, sp) in zip(
        leaves_with_paths(meta), leaves_with_paths(specs))], meta), specs


def shard_params(cfg, params, mesh):
    """`params` (full tensors, the same on every rank) as DTensors placed
    by `params_shardings`; each rank keeps its own slices."""
    specs = sh.params_shardings(mesh, params, vlm=cfg.family == "vlm")
    return sh.shard_tree(params, mesh, specs)


def launch_zoo_mesh(device=None, model_parallel=None,
                    multi_pod: bool = False):
    """(this rank's device, the zoo mesh or None) for the drivers' mesh
    mode: under a launcher with more than one rank, or with
    `model_parallel` given, the zoo mesh over every rank (launch/mesh.py
    `init_from_launcher`, `zoo_mesh`), its ``model`` axis
    `model_parallel` ranks (1 by default), two pods with `multi_pod`;
    else None (one card)."""
    import os

    from repro_torch.core.collectives import world_size
    from repro_torch.launch.mesh import init_from_launcher, zoo_mesh

    wants = multi_pod or model_parallel is not None or int(
        os.environ.get("WORLD_SIZE", "1")) > 1
    device = init_from_launcher(device)
    if not wants:
        return device, None
    model = model_parallel or 1
    pods = 2 if multi_pod else 0
    per = model * (pods or 1)
    if world_size() % per:
        raise ValueError(f"{world_size()} ranks do not split into "
                         f"{pods or 1} pod(s) of model-parallel groups of "
                         f"{model}")
    return device, zoo_mesh(world_size() // per, model, pods, device)


def _place_batch(batch: dict, mesh) -> dict:
    """Each tensor of `batch` as a DTensor on `mesh` with its batch dim
    (dim 1 of ``drops``, else dim 0) on (pod, data) where it divides
    (`batch_spec`); a DTensor is placed again, a full tensor sliced."""
    out = {}
    for k, t in batch.items():
        dim = 1 if k == "drops" else 0
        spec = [None] * t.dim()
        spec[dim] = sh.batch_spec(mesh, t.shape[dim])[0]
        want = sh.placements_of(mesh, tuple(spec), t.shape)
        if is_dtensor(t):
            out[k] = t if tuple(t.placements) == want else \
                t.redistribute(mesh, want)
        else:
            out[k] = sh.shard_like(t, mesh, tuple(spec))
    return out


def _aux_inputs(batch: dict):
    """The forward's aux_inputs of a batch: its ``frames`` and
    ``patches`` (AUX_KEYS), or None where it has neither, as the
    reference's."""
    return {k: batch[k] for k in AUX_KEYS if k in batch} or None


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _flsimco_example_weights(blur: torch.Tensor) -> torch.Tensor:
    """Eq. 11 weights across the global batch, normalised to sum to 1."""
    total = blur.sum()
    w = (total - blur) / torch.clamp(total, min=1e-12)
    return w / torch.clamp(w.sum(), min=1e-12)


def example_weights(blur: torch.Tensor, aggregation: str) -> torch.Tensor:
    """(B,) float32 loss weights: Eq. 11 (``flsimco``), uniform
    (``fedavg``), or uniform over the examples at most BLUR_KMH_100
    blurred (``discard``)."""
    if aggregation == "flsimco":
        return _flsimco_example_weights(blur)
    if aggregation == "discard":
        keep = (blur <= BLUR_KMH_100).float()
        return keep / torch.clamp(keep.sum(), min=1.0)
    if aggregation == "fedavg":
        return torch.full_like(blur, 1.0 / blur.shape[0])
    raise ValueError(f"unknown aggregation {aggregation!r}; valid: "
                     f"{AGGREGATIONS}")


def lm_loss_per_example(cfg, logits: torch.Tensor,
                        tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy per example (B,), float32, padded vocab
    already masked: logsumexp minus the gathered target logit, averaged
    over positions. The reference's default one-hot form exists to keep
    the vocab axis sharded under GSPMD; one card has no such axis and
    gathers, a mesh (DTensor logits) takes the one-hot form. The two
    forms give the same values: the one-hot products are exact and the
    target logit is their only nonzero term."""
    tgt = tokens[:, 1:]
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    if is_dtensor(lg):
        # the reference's one-hot form: the vocab stays sharded (DTensor
        # cannot reduce the masked partial of a gather over a sharded dim)
        ids = replicated_like(torch.arange(lg.shape[-1], device=lg.device),
                              lg)
        tgt_logit = (lg * (ids == tgt[..., None]).to(lg.dtype)).sum(dim=-1)
    else:
        tgt_logit = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return (lse - tgt_logit).mean(dim=-1)


def draw_drop_masks(shape, gen: torch.Generator) -> torch.Tensor:
    """The DT objective's two views' drop masks, (2, *shape) bool on the
    CPU: each token dropped with probability DROP_P, drawn from the CPU
    generator `gen` (the plan; the caller moves them to the device)."""
    return torch.rand((2, *shape), generator=gen) < DROP_P


def dt_objective(cfg, params, tokens, drops, tau_alpha: float = 0.1,
                 tau_beta: float = 1.0, aux_inputs=None) -> torch.Tensor:
    """Token-view DT-SSL objective: two views of `tokens`, each with the
    tokens of its drop mask (`drops` (2, B, S) bool) set to MASK_TOKEN,
    through `forward_features` (both reading the same `aux_inputs`), and
    the in-batch DT loss between them (`ops.dt_loss`, the DT kernel on
    the card; on a mesh on the features gathered over the batch axes)
    plus the aux terms."""
    v1 = torch.where(drops[0], MASK_TOKEN, tokens)
    v2 = torch.where(drops[1], MASK_TOKEN, tokens)
    q, aux1 = T.forward_features(cfg, params, v1, aux_inputs=aux_inputs)
    k, aux2 = T.forward_features(cfg, params, v2, aux_inputs=aux_inputs)
    # on a mesh: every feature row on every rank, gathered over the batch
    # axes, so each rank launches the DT kernel on the same (M, D)
    loss = ops.dt_loss(sh.full(q), sh.full(k), tau_alpha, tau_beta)
    return replicated_like(loss, aux1) + aux1 + aux2


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def pick_n_micro(cfg, shape: InputShape, mesh=None,
                 act_budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor, the reference's rule: per-layer bf16
    activation checkpoints of a batch shard (the batch over the mesh's
    (pod, data) axes; the whole batch without a mesh) under budget."""
    shards = 1
    if mesh is not None:
        shards = math.prod(axis_sizes(mesh)[a] for a in batch_axes(mesh))
    b = max(shape.global_batch // shards, 1)
    need = cfg.n_layers * shape.seq_len * cfg.d_model * 2 * b \
        / act_budget_bytes
    n = 1
    while n < b and need / n > 1.0:
        n *= 2
    return min(n, b)


def make_grad_fn(cfg, *, objective: str = "lm",
                 aggregation: str = "flsimco", n_micro: int = 1,
                 mesh=None):
    """grads(params, batch) -> (loss, grads): the loss summed over
    `n_micro` micro-batches and its gradients accumulated in float32, one
    tensor per leaf in `leaves_with_paths` order. ``batch`` holds
    ``tokens`` (B, S) and ``blur`` (B,) float32; for ``dt`` also
    ``drops`` (2, B, S) bool (`draw_drop_masks`); for ``audio`` also
    ``frames`` (`frames_shape`), for ``vlm`` ``patches``
    (`patches_shape`), split with the tokens. The LM loss is weighted by
    `example_weights` over the global batch; the DT loss is not, as the
    reference's. On a `mesh` the params are DTensors; the batch is split
    whole (micro-batch i is rows [i B / n, (i + 1) B / n), as on one
    card) and each part placed by `batch_spec`; each gradient comes
    back placed like its leaf, and the loss is a plain tensor, the same
    on every rank."""
    if objective not in ("lm", "dt"):
        raise ValueError(f"unknown objective {objective!r}; valid: lm, dt")
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {aggregation!r}; valid: "
                         f"{AGGREGATIONS}")

    def loss_fn(params, mb):
        aux_in = _aux_inputs(mb)
        if objective == "dt":
            return dt_objective(cfg, params, mb["tokens"], mb["drops"],
                                aux_inputs=aux_in)
        logits, _, aux = T.forward(cfg, params, mb["tokens"], mode="train",
                                   aux_inputs=aux_in)
        per_ex = lm_loss_per_example(cfg, logits, mb["tokens"])
        return (per_ex * mb["weights"]).sum() + aux

    def grads(params, batch):
        batch = {k: sh.full(v) for k, v in batch.items()}
        tokens = batch["tokens"]
        if tokens.shape[0] % n_micro:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{n_micro} micro-batches")
        parts = {"tokens": tokens.chunk(n_micro)}
        for k in AUX_KEYS:
            if k in batch:
                parts[k] = batch[k].chunk(n_micro)
        if objective == "dt":
            if "drops" not in batch:
                raise ValueError("the dt objective takes its views' drop "
                                 "masks from batch['drops'] "
                                 "(draw_drop_masks)")
            parts["drops"] = batch["drops"].chunk(n_micro, dim=1)
        else:
            parts["weights"] = example_weights(batch["blur"],
                                               aggregation).chunk(n_micro)
        leaves = [t.detach().requires_grad_()
                  for _, t in leaves_with_paths(params)]
        tree = unflatten(leaves, params)
        total, acc = None, None
        for i in range(n_micro):
            mb = {k: v[i] for k, v in parts.items()}
            if mesh is not None:
                mb = _place_batch(mb, mesh)
            with torch.enable_grad():
                loss = loss_fn(tree, mb)
                if is_dtensor(loss):
                    loss = loss.redistribute(
                        mesh, sh.placements_of(mesh, ()))
                g = torch.autograd.grad(loss, leaves, materialize_grads=True)
            if mesh is not None:
                g = [x.redistribute(mesh, p.placements)
                     for x, p in zip(g, leaves)]
            if acc is None:
                acc = [x.float() for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x)
            del g
            loss = sh.full(loss.detach())
            total = loss if total is None else total + loss
        return total, acc

    return grads


def make_train_step(cfg, shape: InputShape, mesh=None, *,
                    objective: str = "lm", optimizer: str = "sgdm",
                    lr: float = 1e-2, momentum: float = 0.9,
                    weight_decay: float = 5e-4,
                    aggregation: str = "flsimco", n_micro=None):
    """Returns (train_step, n_micro); train_step(params, mom, batch) ->
    (params, mom, {"loss"}). The update, per leaf, in float32 and cast
    back to the leaf's dtype: g + weight_decay * p, then SGD with
    momentum (``sgdm``: m = momentum * m + g, p -= lr * m) or plain SGD
    (``sgd``: p -= lr * g, mom unchanged). New tensors are returned; the
    inputs are left as they were. With a zoo `mesh` the params and the
    momentum are DTensors (`shard_params`), the batch is placed by
    `input_specs`, the activations by `make_activation_rules`, and
    each leaf's update runs on its shards; the loss is a plain tensor,
    the same on every rank."""
    if optimizer not in ("sgdm", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}; valid: sgdm, "
                         f"sgd")
    nm = n_micro or pick_n_micro(cfg, shape, mesh)
    grads_of = make_grad_fn(cfg, objective=objective,
                            aggregation=aggregation, n_micro=nm, mesh=mesh)
    rules = None if mesh is None else sh.make_activation_rules(
        mesh, shape.global_batch)

    def train_step(params, mom, batch):
        with activation_sharding(rules):
            loss, grads = grads_of(params, batch)
        new_p, new_m = [], []
        for (_, p), (_, m) in zip(leaves_with_paths(params),
                                  leaves_with_paths(mom)):
            g = grads.pop(0).add_(p.float(), alpha=weight_decay)
            if optimizer == "sgdm":
                g = g.add_(m.float(), alpha=momentum)
                new_m.append(g.to(m.dtype))
            else:
                new_m.append(m)
            new_p.append((p.float() - lr * g).to(p.dtype))
        return (unflatten(new_p, params), unflatten(new_m, mom),
                {"loss": loss})

    return train_step, nm


def init_momentum(params, optimizer: str = "sgdm"):
    """Zeros like each leaf (``sgdm``), or a float32 scalar zero per leaf
    (``sgd``, which keeps no momentum), on the leaf's device."""
    if optimizer == "sgdm":
        return tree_map(torch.zeros_like, params)
    return tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                          device=p.device), params)


# --------------------------------------------------------------------------
# serve steps
# --------------------------------------------------------------------------


def _long_context(shape: InputShape) -> bool:
    """The reference's steps serve ``long_500k`` with long_context (a
    ring-buffer cache of the long-context window)."""
    return shape.name == "long_500k"


def _mesh_cache(cfg, batch: int, seq_len: int, *, dtype, device,
                long_context: bool, ctx_len: int, mesh) -> dict:
    """`T.init_cache`'s empty cache as DTensors placed by
    `cache_shardings`, each rank allocating only its shards: ``pos``
    filled with -1 (an empty slot), the rest with 0, as `init_cache`
    fills them."""
    from torch.distributed.tensor import full as dfull
    meta = T.init_cache(cfg, batch, seq_len, dtype=dtype, device="meta",
                        long_context=long_context, ctx_len=ctx_len)
    specs = sh.cache_shardings(mesh, meta, batch)
    leaves = [dfull(t.shape, -1 if path[-1] == "pos" else 0, dtype=t.dtype,
                    device_mesh=mesh,
                    placements=sh.placements_of(mesh, sp, t.shape))
              for (path, t), (_, sp) in zip(leaves_with_paths(meta),
                                            leaves_with_paths(specs))]
    return unflatten(leaves, meta)


def make_prefill_step(cfg, shape: InputShape, param_dtype=torch.bfloat16, *,
                      mesh=None):
    """prefill(params, {"tokens": (B, S)[, "frames" | "patches"]}) ->
    (logits of the last position (B, V) float32, cache). The cache
    starts empty, for positions below ``shape.seq_len``, in
    `param_dtype`, as the reference's; an ``audio`` or ``vlm`` cache
    starts with a zero context of `enc_ctx_len` (``shape.seq_len``)
    rows, which the encoder's output (``frames``) or the projected
    ``patches`` replace when the batch has them. The head
    runs on the last position only: the reference computes (B, S, V)
    logits and returns ``logits[:, -1]``, the same values, and at full
    width (B = 16, S = 2048, V = 65536) the full logits would take 8.6 GB
    of float32. With a zoo `mesh`: the params are DTensors
    (`shard_params`), the batch is placed, the cache starts as DTensors
    placed by `cache_shardings`, and the logits and the cache come back
    as DTensors."""
    long_ctx = _long_context(shape)
    rules = None if mesh is None else sh.make_activation_rules(
        mesh, shape.global_batch)
    make_cache = T.init_cache if mesh is None else functools.partial(
        _mesh_cache, mesh=mesh)

    @torch.no_grad()
    def prefill(params, batch):
        if mesh is not None:
            batch = _place_batch(batch, mesh)
        tokens = batch["tokens"]
        cache = make_cache(cfg, tokens.shape[0], shape.seq_len,
                           dtype=param_dtype, device=tokens.device,
                           long_context=long_ctx,
                           ctx_len=enc_ctx_len(cfg, shape.seq_len))
        with activation_sharding(rules):
            x, cache, _ = T._forward_hidden(cfg, params, tokens,
                                            mode="prefill", cache=cache,
                                            aux_inputs=_aux_inputs(batch),
                                            long_context=long_ctx)
            return T._head(cfg, params, x[:, -1]), cache

    return prefill


def make_decode_step(cfg, shape: InputShape | None = None, *, mesh=None):
    """decode(params, {"tokens": (B, 1), "positions": (B,), "cache"}) ->
    (logits (B, V) float32, new cache); `shape` sets long_context, as
    for the prefill. With a zoo `mesh` the tokens and positions are
    placed, the params and the cache are DTensors (the prefill's), and
    the logits and the new cache come back as DTensors; `shape` must
    then be given (its global batch sets the activation rules)."""
    if mesh is not None and shape is None:
        raise ValueError("a mesh decode step needs its InputShape (the "
                         "global batch sets the activation rules)")
    long_ctx = shape is not None and _long_context(shape)
    rules = None if mesh is None else sh.make_activation_rules(
        mesh, shape.global_batch)

    @torch.no_grad()
    def decode(params, batch):
        inputs = {k: batch[k] for k in ("tokens", "positions") if k in batch}
        if mesh is not None:
            inputs = _place_batch(inputs, mesh)
        with activation_sharding(rules):
            logits, cache, _ = T.forward(cfg, params, inputs["tokens"],
                                         mode="decode", cache=batch["cache"],
                                         positions=inputs.get("positions"),
                                         long_context=long_ctx)
            return logits[:, 0], cache

    return decode
