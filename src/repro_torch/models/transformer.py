"""Model assembly of the zoo, ``dense``, ``moe``, ``ssm`` (RWKV6),
``hybrid`` (Hymba), ``audio`` (SeamlessM4T) and ``vlm``
(Llama-3.2-Vision) families — counterpart of
`repro.models.transformer` (`_init_decoder_block`, `_decoder_block`,
`_init_cross_block`, `_cross_block`, `_encoder_block` (its init is
`_init_decoder_block`), `_init_rwkv_block`, `_init_hymba_block`,
`_hymba_block`, `init_params`, `layer_windows`, `cache_width`,
`init_cache`, `_embed`, `_head`, `_forward_hidden`, `forward`,
`forward_features`), and `param_shapes`.

Blocks keep the reference's stacked layout: every leaf of
``params["blocks"]`` and of the cache has a leading layer axis. The
reference runs the layers with `lax.scan`; the port loops over them in
Python. Modes, as the reference's:

  train   — full-sequence teacher forcing -> logits
  prefill — like train, into the cache, and returns the new cache
  decode  — one new token against the cache

The ``moe`` family is the dense decoder block with `layers.moe_apply`
in place of the MLP: ``params["blocks"]`` holds the MoE layers and, with
``moe_first_dense_layers``, ``params["dense_blocks"]`` the leading dense
ones, which run first. Its blocks' aux losses are summed into the
forward's aux_losses. The ``hybrid`` block runs sliding-window
attention and the selective SSM (`layers.ssm_block`) side by side on the
same normed input and averages their normed outputs. The ``audio``
family is an encoder-decoder: the frame embeddings (``aux_inputs
["frames"]`` (B, Te, d_audio)) go through ``audio_adapter``, the
non-causal encoder blocks (``enc_blocks``, RoPE at 0..Te-1) and
``enc_norm`` to the context; each decoder layer is the decoder block
(``blocks``) followed by a cross block (``cross_blocks``) that attends
over the context, its attention and MLP outputs scaled by
tanh(``gate_attn``) and tanh(``gate_mlp``), float32 scalars that start
at 0, so at init the context does not reach the logits (the
reference's init). The ranges ``audio.encoder`` and ``audio.cross``
mark the encoder stack and each cross block for the profiler. The
``vlm`` family interleaves the same gated cross blocks with the decoder
blocks: every ``cross_attn_period``-th layer is a cross block, so the
model is n_super = n_layers // period super-layers of n_self = period -
1 decoder blocks and one cross block. ``params["blocks"]`` is stacked
nested, (n_super, n_self, ...), ``cross_blocks`` (n_super, ...), and
the context is the patch embeddings (``aux_inputs["patches"]`` (B,
n_vision_tokens, d_vision)) through ``vision_proj`` (d_vision, d), with
no norm (the vision encoder is a stub, as in the reference). The ranges
``vlm.vision_proj`` and ``vlm.cross`` mark the projection and each
cross block.

Caches: ``dense``: ``{"kv": {"k", "v": (L, B, W, KH, hd), "pos": (L, B,
W) int32}}`` ring buffers of width `cache_width` (int8 k and v add
``k_scale``, ``v_scale`` (L, B, W, KH)); ``moe``: the same for its MoE
layers, and ``"kv_dense"`` for its leading dense layers; ``ssm``:
``{"state": (L, B, H, D, D) float32, "x_last_t": (L, B, d), "x_last_c":
(L, B, d)}`` (the last token seen by each layer's time-mix and
channel-mix); ``hybrid``: ``{"kv": the dense ring buffers, "ssm": (L,
B, di, st) float32, "conv": (L, B, 3, di)}`` (each layer's SSM state and
the last 3 inputs of its conv); ``audio``: ``{"kv": the dense ring
buffers of its decoder layers, "ctx": (B, Te, d)}``, the encoder's
output, which a prefill with frames writes (Te = the frames' length)
and decode reads (the cross blocks project its k and v again every
step, as the reference's); ``vlm``: ``{"kv": the rings of its n_super *
n_self decoder blocks in one flat stack (block j of super-layer s at s *
n_self + j), "ctx": (B, n_vision_tokens, d)}``, the projected patches,
written and read as ``audio``'s. A ``hybrid`` prefill needs a cache, as
the reference's; one longer than the ring (W = 1024 slots for
hymba-1.5b) keeps only its last W positions' keys, so its earlier
queries lose keys of their window, and the next layer's SSM carries
that on: even the last logits then differ from a full forward's, as
the reference's do.

On a mesh (launch/steps.py's mesh steps) the params, tokens, caches
and context inputs are DTensors, for every family; the blocks end in
`constrain(x, "tokens_bsd")` and the head in `constrain(logits,
"logits_bsv")`, as the reference's (the encoder and cross blocks add
none, as the reference's do not). `param_shapes` gives `init_params`'
tree as meta tensors (the counterpart of `jax.eval_shape`). Placed by
hand, at the op: `_embed` looks up each rank's ids in the gathered
table (DTensor's vocab-sharded lookup leaves masked partial sums its
backward cannot redistribute); the positions take the tokens'
placements, the encoder's positions the frames' batch placement
(`sharding_hooks.batch_like`), and the constants (the padded-vocab
mask, the embedding scale, every family's aux accumulator) are
replicated (`sharding_hooks.replicated_like`); the context a prefill
writes into the cache is placed as the cache's ``ctx``, on the batch
(`_cache_ctx`). The rwkv6 kernel, the selective scan and the cross
attention's key positions are placed in models/layers.py.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.convert import leaves_with_paths, tree_map
from repro_torch.models import layers as L
from repro_torch.models.sharding_hooks import (batch_like, constrain,
                                               is_dtensor, local_to_mesh,
                                               mesh_to_local, replicated_like,
                                               sharded_like)


ATTENTION_FAMILIES = ("dense", "moe")
ZOO_FAMILIES = ATTENTION_FAMILIES + ("ssm", "hybrid", "audio", "vlm")


def _check_family(cfg) -> None:
    """ValueError for a family this module does not build, as the
    reference's `init_params` raises for an unknown one."""
    if cfg.family not in ZOO_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the zoo's "
                         f"families are {ZOO_FAMILIES}")


def _init_decoder_block(cfg, gen, dtype, moe: bool = False):
    p = {"ln1": L.init_norm(cfg, dtype=dtype, device=gen.device),
         "attn": L.init_attention(cfg, gen, dtype),
         "ln2": L.init_norm(cfg, dtype=dtype, device=gen.device)}
    if moe:
        p["moe"] = L.init_moe(cfg, gen, dtype)
    else:
        p["mlp"] = L.init_mlp(cfg, gen, dtype)
    if cfg.post_norm:
        p["ln1_post"] = L.init_norm(cfg, dtype=dtype, device=gen.device)
        p["ln2_post"] = L.init_norm(cfg, dtype=dtype, device=gen.device)
    return p


def _decoder_block(cfg, p, x, q_pos, *, window, cache=None):
    """Pre-norm attention and MLP (or MoE) with residuals (gemma2: a norm
    after each too). Returns (x, the layer's new cache or None, the
    layer's aux loss: the MoE's, or 0.0)."""
    h, new_cache = L.attention_block(cfg, p["attn"],
                                     L.apply_norm(cfg, p["ln1"], x), q_pos,
                                     window=window, cache=cache)
    if cfg.post_norm:
        h = L.apply_norm(cfg, p["ln1_post"], h)
    x = x + h
    hin = L.apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        h, aux = L.moe_apply(cfg, p["moe"], hin)
    else:
        h, aux = L.mlp_block(cfg, p["mlp"], hin), 0.0
    if cfg.post_norm:
        h = L.apply_norm(cfg, p["ln2_post"], h)
    return constrain(x + h, "tokens_bsd"), new_cache, aux


def _init_cross_block(cfg, gen, dtype):
    """Norm, cross-attention (no qkv biases), norm, MLP, and the two
    float32 0-d gates at 0 whatever `dtype` is."""
    dev = gen.device
    return {"ln1": L.init_norm(cfg, dtype=dtype, device=dev),
            "xattn": L.init_attention(cfg, gen, dtype, cross=True),
            "ln2": L.init_norm(cfg, dtype=dtype, device=dev),
            "mlp": L.init_mlp(cfg, gen, dtype),
            "gate_attn": torch.zeros((), dtype=torch.float32, device=dev),
            "gate_mlp": torch.zeros((), dtype=torch.float32, device=dev)}


def _cross_block(cfg, p, x, q_pos, ctx):
    """Gated cross-attention over the context `ctx` (B, Te, d), then a
    gated MLP, with residuals: x + tanh(gate) * h, the gate rounded to
    x's dtype before the product, as the reference's ``.astype``. Runs
    in the profiler range ``<family>.cross`` (``audio.cross``,
    ``vlm.cross``)."""
    with torch.profiler.record_function(f"{cfg.family}.cross"):
        h, _ = L.attention_block(cfg, p["xattn"],
                                 L.apply_norm(cfg, p["ln1"], x), q_pos,
                                 kv_src=ctx, use_rope=False)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h
        h = L.mlp_block(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
        return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * h


def _encoder_block(cfg, p, x, pos):
    """Pre-norm non-causal self-attention (RoPE at `pos`) and the MLP,
    with residuals."""
    h, _ = L.attention_block(cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
                             pos, causal=False)
    x = x + h
    return x + L.mlp_block(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))


def _init_rwkv_block(cfg, gen, dtype):
    return {
        "ln1": L.init_layernorm(cfg.d_model, dtype, gen.device),
        "tmix": L.init_rwkv_tmix(cfg, gen, dtype),
        "ln2": L.init_layernorm(cfg.d_model, dtype, gen.device),
        "cmix": L.init_rwkv_cmix(cfg, gen, dtype),
    }


def _init_hymba_block(cfg, gen, dtype):
    dev = gen.device
    return {"ln1": L.init_norm(cfg, dtype=dtype, device=dev),
            "attn": L.init_attention(cfg, gen, dtype),
            "ssm": L.init_ssm(cfg, gen, dtype),
            "norm_attn": L.init_rmsnorm(cfg.d_model, dtype, dev),
            "norm_ssm": L.init_rmsnorm(cfg.d_model, dtype, dev),
            "ln2": L.init_norm(cfg, dtype=dtype, device=dev),
            "mlp": L.init_mlp(cfg, gen, dtype)}


def _hymba_block(cfg, p, x, q_pos, *, window, cache=None, ssm_state=None,
                 conv_state=None):
    """Attention and the SSM in parallel on the same normed input,
    mean-fused after a norm each, then the MLP; residuals around both.
    Returns (x, the layer's new kv cache or None, SSM state, conv
    state)."""
    xn = L.apply_norm(cfg, p["ln1"], x)
    ha, new_cache = L.attention_block(cfg, p["attn"], xn, q_pos,
                                      window=window, cache=cache)
    hs, (new_ssm, new_conv) = L.ssm_block(cfg, p["ssm"], xn,
                                          state=ssm_state,
                                          conv_state=conv_state)
    h = 0.5 * (L.rmsnorm(p["norm_attn"], ha) + L.rmsnorm(p["norm_ssm"], hs))
    x = x + h
    x = x + L.mlp_block(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))
    return constrain(x, "tokens_bsd"), new_cache, new_ssm, new_conv


def _stack(blocks: list) -> dict:
    """Per-layer trees -> one tree whose leaves have a leading layer axis."""
    def build(nodes):
        if isinstance(nodes[0], dict):
            return {k: build([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)
    return build(blocks)


def _init_stack(n: int, make) -> dict:
    """`n` layers of `make()` stacked along a leading layer axis, each
    layer copied into the stack as it is drawn, so at most one layer's
    tensors lie beside the stack (a single layer is a view of itself):
    at full width one kimi-k2 MoE layer holds 33.8 GB of experts."""
    first = make()
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    if next(iter(leaves_with_paths(first)))[1].is_meta:
        return out                 # shapes only (`param_shapes`)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


def _vlm_shape(cfg) -> tuple:
    """``vlm``: (n_super, n_self), the super-layers and the decoder
    blocks in each (a cross block follows them)."""
    per = cfg.cross_attn_period
    return cfg.n_layers // per, per - 1


def _n_dense(cfg) -> int:
    """Leading dense layers: the ``moe`` family's, 0 otherwise."""
    return cfg.moe_first_dense_layers if cfg.family == "moe" else 0


def init_params(cfg, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Random parameters on the generator's device: embed, final_norm,
    unembed (unless tied) and the stacked blocks, in the reference's
    layouts and per-leaf dtypes (`dtype`, except the ``ssm`` family's
    float32 ``w0``, ``w_lora_b`` and ``u``, the ``moe`` family's float32
    router, the ``hybrid`` family's float32 ``b_dt``, ``A_log`` and
    ``D``, and the ``audio`` family's float32 gates). ``moe`` adds
    ``dense_blocks`` for its leading dense layers, and its ``blocks``
    hold the MoE layers; ``audio`` adds ``enc_blocks``,
    ``cross_blocks`` (one a decoder layer), ``audio_adapter`` (d_audio,
    d) and ``enc_norm``; ``vlm`` stacks its ``blocks`` nested (n_super,
    n_self, ...) and adds ``cross_blocks`` (one a super-layer, their
    gates float32 too) and ``vision_proj`` (d_vision, d). The draws are the
    port's own: tests carry the reference's weights across with
    `convert.zoo_params_from_numpy`."""
    _check_family(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    p: dict = {
        "embed": L.normal_init(gen, (v, d), 0.02, dtype),
        "final_norm": L.init_norm(cfg, dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.normal_init(gen, (d, v), 1 / math.sqrt(d), dtype)
    if cfg.family in ("ssm", "hybrid"):
        init = _init_rwkv_block if cfg.family == "ssm" else _init_hymba_block
        p["blocks"] = _init_stack(cfg.n_layers,
                                  lambda: init(cfg, gen, dtype))
        return p
    if cfg.family == "audio":     # an encoder layer: a decoder block's init
        p["enc_blocks"] = _init_stack(
            cfg.n_encoder_layers, lambda: _init_decoder_block(cfg, gen, dtype))
        p["blocks"] = _init_stack(
            cfg.n_layers, lambda: _init_decoder_block(cfg, gen, dtype))
        p["cross_blocks"] = _init_stack(
            cfg.n_layers, lambda: _init_cross_block(cfg, gen, dtype))
        p["audio_adapter"] = L.fan_in_init(gen, (cfg.d_audio, d), dtype)
        p["enc_norm"] = L.init_norm(cfg, dtype=dtype, device=gen.device)
        return p
    if cfg.family == "vlm":
        n_super, n_self = _vlm_shape(cfg)
        p["blocks"] = _init_stack(n_super, lambda: _init_stack(
            n_self, lambda: _init_decoder_block(cfg, gen, dtype)))
        p["cross_blocks"] = _init_stack(
            n_super, lambda: _init_cross_block(cfg, gen, dtype))
        p["vision_proj"] = L.fan_in_init(gen, (cfg.d_vision, d), dtype)
        return p
    moe = cfg.family == "moe"
    n_dense = _n_dense(cfg)
    if n_dense:
        p["dense_blocks"] = _init_stack(
            n_dense, lambda: _init_decoder_block(cfg, gen, dtype))
    p["blocks"] = _init_stack(
        cfg.n_layers - n_dense,
        lambda: _init_decoder_block(cfg, gen, dtype, moe))
    return p


class _MetaGenerator(torch.Generator):
    """A CPU generator whose device is ``meta``: the init functions draw
    on ``gen.device``, so they build shape-only tensors."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg, dtype=torch.bfloat16) -> dict:
    """`init_params`'s tree as meta tensors (shapes and dtypes, no
    storage, nothing drawn): the counterpart of `jax.eval_shape` of the
    reference's init, which the sharding rules read at full width."""
    return init_params(cfg, _MetaGenerator(), dtype)


def layer_windows(cfg, n_layers: int, long_context: bool) -> list:
    """Each layer's attention window (BIG_WINDOW = none): gemma2's even
    layers the sliding window and odd ones global, else the config's
    window for every layer; global means the long-context window under
    `long_context`."""
    glob = cfg.long_context_window if long_context else L.BIG_WINDOW
    if cfg.local_global_period:
        return [cfg.sliding_window if i % cfg.local_global_period == 0
                else glob for i in range(n_layers)]
    return [cfg.sliding_window or glob] * n_layers


def cache_width(cfg, seq_len: int, long_context: bool) -> int:
    """Ring-buffer width of the decode caches for positions < seq_len."""
    if long_context:
        if cfg.long_context_mode == "native" and cfg.sliding_window:
            return min(seq_len, cfg.sliding_window)
        return min(seq_len, cfg.long_context_window)
    if cfg.sliding_window and not cfg.local_global_period:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int = 0, dtype=torch.bfloat16,
               device=None, *, long_context: bool = False,
               ctx_len: int = 0) -> dict:
    """Empty decode cache for positions < `seq_len`: ``dense`` and
    ``moe``, ring buffers of `cache_width` slots in `dtype`
    (``torch.int8``: the quantized cache), ``kv_dense`` for the leading
    dense layers; ``ssm``, the recurrent state (its size does not depend
    on `seq_len`); ``hybrid``, the ring buffers, the SSM states in
    float32 and the conv states in `dtype`; ``audio``, the ring buffers
    and a zero context of `ctx_len` rows in `dtype`; ``vlm``, the ring
    buffers of its decoder blocks in one flat stack and a zero context
    of n_vision_tokens rows in `dtype` (`ctx_len` is ignored, as the
    reference's)."""
    _check_family(cfg)
    if cfg.family == "vlm":
        n_super, n_self = _vlm_shape(cfg)
        return {"kv": L.make_cache(cfg, batch,
                                   cache_width(cfg, seq_len, long_context),
                                   dtype, n_layers=n_super * n_self,
                                   device=device),
                "ctx": torch.zeros((batch, cfg.n_vision_tokens,
                                    cfg.d_model), dtype=dtype,
                                   device=device)}
    if cfg.family == "audio":
        return {"kv": L.make_cache(cfg, batch,
                                   cache_width(cfg, seq_len, long_context),
                                   dtype, n_layers=cfg.n_layers,
                                   device=device),
                "ctx": torch.zeros((batch, ctx_len, cfg.d_model),
                                   dtype=dtype, device=device)}
    if cfg.family == "hybrid":
        n, di = cfg.n_layers, cfg.ssm_expand * cfg.d_model
        return {"kv": L.make_cache(cfg, batch,
                                   cache_width(cfg, seq_len, long_context),
                                   dtype, n_layers=n, device=device),
                "ssm": torch.zeros((n, batch, di, cfg.ssm_state),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros((n, batch, 3, di), dtype=dtype,
                                    device=device)}
    if cfg.family in ATTENTION_FAMILIES:
        width = cache_width(cfg, seq_len, long_context)
        n_dense = _n_dense(cfg)
        c = {"kv": L.make_cache(cfg, batch, width, dtype,
                                n_layers=cfg.n_layers - n_dense,
                                device=device)}
        if n_dense:
            c["kv_dense"] = L.make_cache(cfg, batch, width, dtype,
                                         n_layers=n_dense, device=device)
        return c
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    h = d // hd
    n = cfg.n_layers
    return {
        "state": torch.zeros((n, batch, h, hd, hd), dtype=torch.float32,
                             device=device),
        "x_last_t": torch.zeros((n, batch, d), dtype=dtype, device=device),
        "x_last_c": torch.zeros((n, batch, d), dtype=dtype, device=device),
    }


def _embed(cfg, p, tokens):
    """The tokens' embedding rows (times sqrt(d) where the config scales
    them), through `F.embedding`: the same rows as indexing, and on a
    mesh the same backward op as on one device (indexing's backward
    under DTensor sums repeated tokens in another order).

    On a mesh the lookup runs on each rank's ids against the whole
    table, gathered (DTensor's vocab-sharded lookup leaves masked
    partial sums that its backward cannot redistribute): the rows keep
    the ids' placements, and the table's gradient is partial over the
    mesh dims that split the ids."""
    w = p["embed"]
    if not is_dtensor(w):
        x = F.embedding(tokens, w)
    else:
        from torch.distributed.tensor import Partial, Replicate
        mesh, pl = w.device_mesh, tuple(tokens.placements)
        table = mesh_to_local(w, [Replicate()] * mesh.ndim,
                              [Replicate() if q == Replicate() else Partial()
                               for q in pl])
        rows = F.embedding(tokens.to_local(), table)
        x = local_to_mesh(rows, mesh, pl, (*tokens.shape, w.shape[1]))
    if cfg.embed_scale:
        x = x * replicated_like(torch.tensor(math.sqrt(cfg.d_model),
                                             dtype=x.dtype, device=x.device),
                                x)
    return x


def _head(cfg, p, x):
    """Final norm and unembedding -> float32 logits over the padded vocab,
    the padding ids masked with NEG_INF."""
    x = L.apply_norm(cfg, p["final_norm"], x)
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = (x @ w).float()
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab, device=logits.device) \
            < cfg.vocab_size
        logits = torch.where(replicated_like(mask, logits), logits,
                             L.NEG_INF)
    return constrain(logits, "logits_bsv")


def _rwkv_block(cfg, blk, x, mode, st):
    xn = L.layernorm(blk["ln1"], x)
    if mode == "decode":
        o, s_new, xl_t = L.rwkv_tmix_step(cfg, blk["tmix"], xn, st["state"],
                                          st["x_last_t"])
    else:
        o, s_new, xl_t = L.rwkv_tmix_chunked(
            cfg, blk["tmix"], xn,
            state=st["state"] if st is not None else None,
            x_last=st["x_last_t"] if st is not None else None)
    x = x + o
    xn2 = L.layernorm(blk["ln2"], x)
    o2, xl_c = L.rwkv_cmix(cfg, blk["cmix"], xn2,
                           x_last=st["x_last_c"] if st is not None else None)
    return constrain(x + o2, "tokens_bsd"), {"state": s_new, "x_last_t": xl_t,
                                            "x_last_c": xl_c}


def _decoder_stack(cfg, blocks, n, x, positions, kv, long_context, aux):
    """The `n` stacked decoder `blocks` over `x` at `positions` (B, S),
    each with its window (`layer_windows` of the stack's depth) and its
    slice of the stacked cache `kv` (None: no cache). Returns (x, the new
    stacked cache or None, aux plus the blocks' aux losses)."""
    outs = []
    for i, win in enumerate(layer_windows(cfg, n, long_context)):
        blk = tree_map(lambda t: t[i], blocks)
        c = None if kv is None else {k: v[i] for k, v in kv.items()}
        x, new, a = _decoder_block(cfg, blk, x, positions, window=win,
                                   cache=c)
        aux = aux + a
        outs.append(new)
    return x, (None if kv is None else _stack(outs)), aux


def _attention_layers(cfg, p, x, positions, cache, long_context):
    """``dense`` and ``moe``: the leading dense stack (``dense_blocks``,
    cache ``kv_dense``), then ``blocks`` (cache ``kv``). Returns (x, new
    cache or None, the summed aux loss, float32)."""
    aux = replicated_like(torch.zeros((), device=x.device), x)
    new_cache = None if cache is None else {}
    n_dense = _n_dense(cfg)
    for blocks, key, n in (("dense_blocks", "kv_dense", n_dense),
                           ("blocks", "kv", cfg.n_layers - n_dense)):
        if not n:
            continue
        x, kv, aux = _decoder_stack(cfg, p[blocks], n, x, positions,
                                    None if cache is None else cache[key],
                                    long_context, aux)
        if cache is not None:
            new_cache[key] = kv
    return x, new_cache, aux


def _hymba_layers(cfg, p, x, positions, cache, long_context):
    """``hybrid``: the stacked Hymba blocks, each with its window and its
    slice of the cache (None: none). Returns (x, the new cache or None,
    a float32 zero aux loss)."""
    outs = []
    for i, win in enumerate(layer_windows(cfg, cfg.n_layers, long_context)):
        blk = tree_map(lambda t: t[i], p["blocks"])
        st = None if cache is None else {
            "kv": {k: v[i] for k, v in cache["kv"].items()},
            "ssm": cache["ssm"][i], "conv": cache["conv"][i]}
        x, kv, h, conv = _hymba_block(
            cfg, blk, x, positions, window=win,
            cache=None if st is None else st["kv"],
            ssm_state=None if st is None else st["ssm"],
            conv_state=None if st is None else st["conv"])
        outs.append({"kv": kv, "ssm": h, "conv": conv})
    aux = replicated_like(torch.zeros((), device=x.device), x)
    return x, (None if cache is None else _stack(outs)), aux


def _encode(cfg, p, frames, dtype):
    """The ``audio`` context: `frames` (B, Te, d_audio) in `dtype` through
    ``audio_adapter``, the encoder blocks at positions 0..Te-1 and
    ``enc_norm`` -> (B, Te, d)."""
    with torch.profiler.record_function("audio.encoder"):
        x = frames.to(dtype) @ p["audio_adapter"]
        b, te = x.shape[:2]
        pos = batch_like(torch.arange(te, device=x.device).expand(b, te), x)
        for i in range(cfg.n_encoder_layers):
            x = _encoder_block(cfg, tree_map(lambda t: t[i], p["enc_blocks"]),
                               x, pos)
        return L.apply_norm(cfg, p["enc_norm"], x)


def _cache_ctx(ctx, cache):
    """The new cache's context: `ctx`, on a mesh placed as the cache's
    ``ctx`` ((bax, None, None), `cache_shardings`), whatever layout the
    encoder or the projection left it in."""
    if not is_dtensor(ctx):
        return ctx
    want = cache["ctx"].placements
    return ctx if ctx.placements == want else ctx.redistribute(
        ctx.device_mesh, want)


def _audio_layers(cfg, p, x, positions, cache, long_context, aux_inputs):
    """``audio``: the context from ``aux_inputs["frames"]`` when given
    (`_encode`), else the cache's ``ctx``; then each decoder block (the
    long-context window under `long_context`, else none) with its slice
    of the cache, followed by its cross block over the context. Returns
    (x, the new cache ``{"kv", "ctx"}`` (this call's context) or None, a
    float32 zero aux loss)."""
    if aux_inputs is not None:
        ctx = _encode(cfg, p, aux_inputs["frames"], x.dtype)
    elif cache is not None:
        ctx = cache["ctx"]
    else:
        raise ValueError("the audio family needs aux_inputs['frames'] (B, "
                         "T_frames, d_audio) for its encoder, or a cache "
                         "holding the encoder's ctx")
    win = cfg.long_context_window if long_context else L.BIG_WINDOW
    outs = []
    for i in range(cfg.n_layers):
        c = None if cache is None else {k: v[i] for k, v in
                                        cache["kv"].items()}
        x, new, _ = _decoder_block(cfg, tree_map(lambda t: t[i], p["blocks"]),
                                   x, positions, window=win, cache=c)
        x = _cross_block(cfg, tree_map(lambda t: t[i], p["cross_blocks"]),
                         x, positions, ctx)
        outs.append(new)
    aux = replicated_like(torch.zeros((), device=x.device), x)
    if cache is None:
        return x, None, aux
    return x, {"kv": _stack(outs), "ctx": _cache_ctx(ctx, cache)}, aux


def _vlm_layers(cfg, p, x, positions, cache, long_context, aux_inputs):
    """``vlm``: the context from ``aux_inputs["patches"]`` when given
    (``patches @ vision_proj``, range ``vlm.vision_proj``), else the
    cache's ``ctx``; then each super-layer s: its n_self decoder blocks
    (the long-context window under `long_context`, else none), block j
    with the flat cache layer s * n_self + j, followed by cross block s
    over the context. Returns (x, the new cache ``{"kv", "ctx"}`` (this
    call's context) or None, a float32 zero aux loss)."""
    if aux_inputs is not None:
        with torch.profiler.record_function("vlm.vision_proj"):
            ctx = aux_inputs["patches"].to(x.dtype) @ p["vision_proj"]
    elif cache is not None:
        ctx = cache["ctx"]
    else:
        raise ValueError("the vlm family needs aux_inputs['patches'] (B, "
                         "n_vision_tokens, d_vision) for its context, or a "
                         "cache holding the projected ctx")
    n_super, n_self = _vlm_shape(cfg)
    win = cfg.long_context_window if long_context else L.BIG_WINDOW
    outs = []
    for s in range(n_super):
        for j in range(n_self):
            c = None if cache is None else {
                k: v[s * n_self + j] for k, v in cache["kv"].items()}
            x, new, _ = _decoder_block(
                cfg, tree_map(lambda t: t[s, j], p["blocks"]), x,
                positions, window=win, cache=c)
            outs.append(new)
        x = _cross_block(cfg, tree_map(lambda t: t[s], p["cross_blocks"]),
                         x, positions, ctx)
    aux = replicated_like(torch.zeros((), device=x.device), x)
    if cache is None:
        return x, None, aux
    return x, {"kv": _stack(outs), "ctx": _cache_ctx(ctx, cache)}, aux


def _forward_hidden(cfg, p, tokens, *, mode, cache, positions=None,
                    aux_inputs=None, long_context=False):
    """Backbone: embeddings -> blocks. Returns (hidden, new_cache,
    aux_losses float32); the new cache is None in train mode without a
    cache, as the reference's. ``dense``, ``moe``, ``hybrid``,
    ``audio`` and ``vlm``: `positions` None (0..S-1), (B,) (each row's
    first position) or (B, S); a ``dense``, ``moe``, ``audio`` or
    ``vlm`` prefill without a cache returns None, a ``hybrid`` one
    raises ValueError, as the reference's. `aux_inputs`: ``{"frames":
    (B, Te, d_audio)}`` for ``audio``, ``{"patches": (B,
    n_vision_tokens, d_vision)}`` for ``vlm`` (without it, and without a
    cache, either raises ValueError), ignored by the other families."""
    _check_family(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.family == "hybrid" and mode == "prefill" and cache is None:
        raise ValueError("hybrid prefill requires a cache (init_cache) so "
                         "the kv ring fills")
    x = _embed(cfg, p, tokens)
    if cfg.family != "ssm":
        b, s = tokens.shape
        steps = torch.arange(s, device=tokens.device)
        if positions is None:
            positions = sharded_like(steps.expand(b, s), tokens)
        elif positions.dim() == 1:
            positions = positions[:, None] + replicated_like(steps[None],
                                                             positions)
        if cfg.family in ("audio", "vlm"):
            layers = _audio_layers if cfg.family == "audio" else _vlm_layers
            return layers(cfg, p, x, positions, cache, long_context,
                          aux_inputs)
        layers = (_hymba_layers if cfg.family == "hybrid"
                  else _attention_layers)
        return layers(cfg, p, x, positions, cache, long_context)
    outs = []
    for i in range(cfg.n_layers):
        blk = tree_map(lambda t: t[i], p["blocks"])
        st = None if cache is None else {k: c[i] for k, c in cache.items()}
        x, new = _rwkv_block(cfg, blk, x, mode, st)
        outs.append(new)
    aux = replicated_like(torch.zeros((), device=x.device), x)
    if cache is None and mode != "prefill":
        return x, None, aux
    return x, _stack(outs), aux


def forward(cfg, p, tokens, *, mode: str = "train", cache=None,
            positions=None, aux_inputs=None, long_context: bool = False):
    """Unified forward. Returns (logits float32, new_cache, aux_losses).

    tokens: (B, S) int64. decode: S == 1 against `cache` and `positions`
    (B,) absolute. The ``ssm`` recurrence reads neither `positions` nor
    `long_context` (the ``hybrid`` family's attention reads both).
    `aux_inputs`: the ``audio`` family's ``{"frames"}`` or the ``vlm``
    family's ``{"patches"}`` (`_forward_hidden`). aux_losses (float32)
    is the sum of the MoE blocks' load-balance losses, 0 for the other
    families."""
    x, new_cache, aux = _forward_hidden(cfg, p, tokens, mode=mode,
                                        cache=cache, positions=positions,
                                        aux_inputs=aux_inputs,
                                        long_context=long_context)
    return _head(cfg, p, x), new_cache, aux


def forward_features(cfg, p, tokens, *, aux_inputs=None):
    """Mean-pooled, L2-normalised final hidden state (B, d_model) float32
    — the representation the dual-temperature loss takes for token
    architectures — and aux_losses, as `forward`'s. `aux_inputs`: the
    ``audio`` family's ``{"frames"}`` or the ``vlm`` family's
    ``{"patches"}``, which both DT views read."""
    x, _, aux = _forward_hidden(cfg, p, tokens, mode="train", cache=None,
                                aux_inputs=aux_inputs)
    x = L.apply_norm(cfg, p["final_norm"], x)
    f = x.mean(dim=1).float()
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                        min=1e-8)
    return f, aux
