"""Serve steps of the zoo on one card — counterpart of
`repro.launch.steps` (`make_prefill_step`, `make_decode_step`), without
the mesh and the sharding rules: the port runs on one device, the one
the params and tokens lie on.

The training steps (`make_train_step` with the DT objective and the
blur-weighted LM loss) are not ported yet (ROADMAP.md Queue A).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape
from repro_torch.models import transformer as T


def make_prefill_step(cfg, shape: InputShape, param_dtype=torch.bfloat16):
    """prefill(params, {"tokens": (B, S)}) -> (logits of the last position
    (B, V) float32, cache). The cache starts empty in `param_dtype`, as the
    reference's. The head runs on the last position only: the reference
    computes (B, S, V) logits and returns ``logits[:, -1]``, the same
    values, and at full width (B = 16, S = 2048, V = 65536) the full
    logits would take 8.6 GB of float32."""

    @torch.no_grad()
    def prefill(params, batch):
        tokens = batch["tokens"]
        cache = T.init_cache(cfg, tokens.shape[0], shape.seq_len,
                             dtype=param_dtype, device=tokens.device)
        x, cache = T._forward_hidden(cfg, params, tokens, mode="prefill",
                                     cache=cache)
        return T._head(cfg, params, x[:, -1]), cache

    return prefill


def make_decode_step(cfg):
    """decode(params, {"tokens": (B, 1), "positions": (B,), "cache"}) ->
    (logits (B, V) float32, new cache)."""

    @torch.no_grad()
    def decode(params, batch):
        logits, cache, _ = T.forward(cfg, params, batch["tokens"],
                                     mode="decode", cache=batch["cache"],
                                     positions=batch.get("positions"))
        return logits[:, 0], cache

    return decode
