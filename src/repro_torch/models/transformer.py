"""Model assembly of the zoo, ``ssm`` family (RWKV6) — counterpart of
`repro.models.transformer` (`_init_rwkv_block`, `init_params`,
`init_cache`, `_embed`, `_head`, `_forward_hidden`, `forward`,
`forward_features`).

Blocks keep the reference's stacked layout: every leaf of
``params["blocks"]`` and of the cache has a leading layer axis. The
reference runs the layers with `lax.scan`; the port loops over them in
Python. Modes, as the reference's:

  train   — full-sequence teacher forcing -> logits
  prefill — like train, from the cache's state, and returns the new cache
  decode  — one new token against the recurrent cache (no KV cache)

Cache: ``{"state": (L, B, H, D, D) float32, "x_last_t": (L, B, d),
"x_last_c": (L, B, d)}`` (the last token seen by each layer's time-mix
and channel-mix). The other families raise NotImplementedError naming
ROADMAP.md.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import family_not_ported
from repro_torch.convert import tree_map
from repro_torch.models import layers as L


def _check_family(cfg) -> None:
    if cfg.family != "ssm":
        raise family_not_ported(cfg.family)


def _init_rwkv_block(cfg, gen, dtype):
    return {
        "ln1": L.init_layernorm(cfg.d_model, dtype, gen.device),
        "tmix": L.init_rwkv_tmix(cfg, gen, dtype),
        "ln2": L.init_layernorm(cfg.d_model, dtype, gen.device),
        "cmix": L.init_rwkv_cmix(cfg, gen, dtype),
    }


def _stack(blocks: list) -> dict:
    """Per-layer trees -> one tree whose leaves have a leading layer axis."""
    def build(nodes):
        if isinstance(nodes[0], dict):
            return {k: build([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)
    return build(blocks)


def init_params(cfg, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Random parameters on the generator's device: embed, final_norm,
    unembed (unless tied) and the stacked blocks, in the reference's
    layouts and per-leaf dtypes (`dtype` except the float32 ``w0``,
    ``w_lora_b`` and ``u``). The draws are the port's own: tests carry
    the reference's weights across with `convert.zoo_params_from_numpy`."""
    _check_family(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    p: dict = {
        "embed": L.normal_init(gen, (v, d), 0.02, dtype),
        "final_norm": L.init_norm(cfg, dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.normal_init(gen, (d, v), 1 / math.sqrt(d), dtype)
    p["blocks"] = _stack([_init_rwkv_block(cfg, gen, dtype)
                          for _ in range(cfg.n_layers)])
    return p


def init_cache(cfg, batch: int, seq_len: int = 0, dtype=torch.bfloat16,
               device=None) -> dict:
    """Empty recurrent cache (its size does not depend on `seq_len`)."""
    _check_family(cfg)
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
    x = p["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
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
        logits = torch.where(mask, logits, L.NEG_INF)
    return logits


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
    return x + o2, {"state": s_new, "x_last_t": xl_t, "x_last_c": xl_c}


def _forward_hidden(cfg, p, tokens, *, mode, cache):
    """Backbone: embeddings -> blocks. Returns (hidden, new_cache); the
    new cache is None in train mode without a cache, as the reference's."""
    _check_family(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = _embed(cfg, p, tokens)
    outs = []
    for i in range(cfg.n_layers):
        blk = tree_map(lambda t: t[i], p["blocks"])
        st = None if cache is None else {k: c[i] for k, c in cache.items()}
        x, new = _rwkv_block(cfg, blk, x, mode, st)
        outs.append(new)
    if cache is None and mode != "prefill":
        return x, None
    return x, _stack(outs)


def forward(cfg, p, tokens, *, mode: str = "train", cache=None,
            positions=None):
    """Unified forward. Returns (logits float32, new_cache, aux_losses).

    tokens: (B, S) int64. decode: S == 1 against `cache`. `positions` is
    accepted for the reference's signature; the recurrence does not read
    it. aux_losses is 0 (the family has no auxiliary loss)."""
    x, new_cache = _forward_hidden(cfg, p, tokens, mode=mode, cache=cache)
    return _head(cfg, p, x), new_cache, torch.zeros((), device=x.device)


def forward_features(cfg, p, tokens):
    """Mean-pooled, L2-normalised final hidden state (B, d_model) float32
    — the representation the dual-temperature loss takes for token
    architectures — and aux_losses (0 for this family)."""
    x, _ = _forward_hidden(cfg, p, tokens, mode="train", cache=None)
    x = L.apply_norm(cfg, p["final_norm"], x)
    f = x.mean(dim=1).float()
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                        min=1e-8)
    return f, torch.zeros((), device=x.device)
