"""Train and serve steps of the zoo on one card — counterpart of
`repro.launch.steps` (`make_train_step`, `init_momentum`,
`make_prefill_step`, `make_decode_step` and the losses), without the
mesh and the sharding rules: the port runs on one device, the one the
params and tokens lie on.

Federated mapping, as the reference's: for one local iteration,
FLSimCo's Eq.-11 aggregation is exactly a blur-weighted gradient sum,

    theta' = sum_n w_n (theta - eta g_n) = theta - eta sum_n w_n g_n,

so the train step weights each example's loss by its normalised Eq.-11
weight (`_flsimco_example_weights`). On a mesh that sum is the weighted
all-reduce GSPMD emits; on one card it is the sum over the batch.
Micro-batches accumulate their gradients in float32, as the reference's
scan does. The ``audio`` family's batches carry ``frames`` (B,
`enc_ctx_len`, d_audio) and the ``vlm`` family's ``patches`` (B,
n_vision_tokens, d_vision) beside the tokens, split into the
micro-batches with them, and their prefills write the context into the
cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape
from repro_torch.convert import leaves_with_paths, tree_map, unflatten
from repro_torch.core.mobility import BLUR_KMH_100
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

MASK_TOKEN = 0  # token id used for DT-objective masking views
DROP_P = 0.15   # the DT objective's token drop rate, a view each
AGGREGATIONS = ("flsimco", "fedavg", "discard")
AUX_KEYS = ("frames", "patches")   # the context inputs: audio's, vlm's


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
    the vocab axis sharded under GSPMD; one card has no such axis, and
    the two forms compute the same function."""
    tgt = tokens[:, 1:]
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
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
    the card) plus the aux terms."""
    v1 = torch.where(drops[0], MASK_TOKEN, tokens)
    v2 = torch.where(drops[1], MASK_TOKEN, tokens)
    q, aux1 = T.forward_features(cfg, params, v1, aux_inputs=aux_inputs)
    k, aux2 = T.forward_features(cfg, params, v2, aux_inputs=aux_inputs)
    return ops.dt_loss(q, k, tau_alpha, tau_beta) + aux1 + aux2


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

def pick_n_micro(cfg, shape: InputShape,
                 act_budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor: the reference's rule on one shard,
    per-layer bf16 activation checkpoints of the batch under budget."""
    b = max(shape.global_batch, 1)
    need = cfg.n_layers * shape.seq_len * cfg.d_model * 2 * b \
        / act_budget_bytes
    n = 1
    while n < b and need / n > 1.0:
        n *= 2
    return min(n, b)


def make_grad_fn(cfg, *, objective: str = "lm",
                 aggregation: str = "flsimco", n_micro: int = 1):
    """grads(params, batch) -> (loss, grads): the loss summed over
    `n_micro` micro-batches and its gradients accumulated in float32, one
    tensor per leaf in `leaves_with_paths` order. ``batch`` holds
    ``tokens`` (B, S) and ``blur`` (B,) float32; for ``dt`` also
    ``drops`` (2, B, S) bool (`draw_drop_masks`); for ``audio`` also
    ``frames`` (`frames_shape`), for ``vlm`` ``patches``
    (`patches_shape`), split with the tokens. The LM loss is weighted by
    `example_weights` over the global batch; the DT loss is not, as the
    reference's."""
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
            with torch.enable_grad():
                loss = loss_fn(tree, {k: v[i] for k, v in parts.items()})
                g = torch.autograd.grad(loss, leaves, materialize_grads=True)
            if acc is None:
                acc = [x.float() for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x)
            del g
            loss = loss.detach()
            total = loss if total is None else total + loss
        return total, acc

    return grads


def make_train_step(cfg, shape: InputShape, *, objective: str = "lm",
                    optimizer: str = "sgdm", lr: float = 1e-2,
                    momentum: float = 0.9, weight_decay: float = 5e-4,
                    aggregation: str = "flsimco", n_micro=None):
    """Returns (train_step, n_micro); train_step(params, mom, batch) ->
    (params, mom, {"loss"}). The update, per leaf, in float32 and cast
    back to the leaf's dtype: g + weight_decay * p, then SGD with
    momentum (``sgdm``: m = momentum * m + g, p -= lr * m) or plain SGD
    (``sgd``: p -= lr * g, mom unchanged). New tensors are returned; the
    inputs are left as they were."""
    if optimizer not in ("sgdm", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}; valid: sgdm, "
                         f"sgd")
    nm = n_micro or pick_n_micro(cfg, shape)
    grads_of = make_grad_fn(cfg, objective=objective,
                            aggregation=aggregation, n_micro=nm)

    def train_step(params, mom, batch):
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


def make_prefill_step(cfg, shape: InputShape, param_dtype=torch.bfloat16):
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
    of float32."""
    long_ctx = _long_context(shape)

    @torch.no_grad()
    def prefill(params, batch):
        tokens = batch["tokens"]
        cache = T.init_cache(cfg, tokens.shape[0], shape.seq_len,
                             dtype=param_dtype,
                             device=tokens.device, long_context=long_ctx,
                             ctx_len=enc_ctx_len(cfg, shape.seq_len))
        x, cache, _ = T._forward_hidden(cfg, params, tokens,
                                        mode="prefill", cache=cache,
                                        aux_inputs=_aux_inputs(batch),
                                        long_context=long_ctx)
        return T._head(cfg, params, x[:, -1]), cache

    return prefill


def make_decode_step(cfg, shape: InputShape | None = None):
    """decode(params, {"tokens": (B, 1), "positions": (B,), "cache"}) ->
    (logits (B, V) float32, new cache); `shape` sets long_context, as
    for the prefill."""
    long_ctx = shape is not None and _long_context(shape)

    @torch.no_grad()
    def decode(params, batch):
        logits, cache, _ = T.forward(cfg, params, batch["tokens"],
                                     mode="decode", cache=batch["cache"],
                                     positions=batch.get("positions"),
                                     long_context=long_ctx)
        return logits[:, 0], cache

    return decode
