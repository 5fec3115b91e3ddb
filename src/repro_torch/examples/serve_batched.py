"""Transformer decode demo (prefill + KV-cache greedy decode) — NOT the
FL serving tier.

Scope: loads an architecture from the model zoo (its reduced variant, as
the reference's script always does), prefills a batch of random prompts,
then decodes greedily to N tokens per sequence through
`launch/decode.py` (`run_prefill`, `run_decode`) — the serve path the
decode_32k / long_500k shapes take at full width. Nothing here touches
federated rounds or RSU model distribution: that is `repro_torch.serve`
(see `repro_torch.examples.serve_campaign`). Weights and prompts are
random from seed 0. Counterpart of `examples/serve_batched.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch tinyllama-1.1b --tokens 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch rwkv6-1.6b --long-context   # O(1)-state long-context decode
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.examples.common import device_of, parser
from repro_torch.launch import decode as D
from repro_torch.launch import steps
from repro_torch.runtime import set_parity_mode

SEED = 0


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--long-context", action="store_true")
    a = ap.parse_args(argv)
    device = device_of(a)
    set_parity_mode()

    cfg = get_config(a.arch)
    if a.reduced:
        cfg = cfg.reduced()
    print(f"== serving {cfg.name} ({cfg.family}) ==")
    params = D.init_model(cfg, SEED, torch.float32, device)

    B, S = a.batch, a.prompt_len
    max_pos = S + a.tokens
    prompts = D.random_prompts(cfg, B, S, SEED, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    frames = patches = None
    if cfg.family == "audio":
        frames = torch.randn(steps.frames_shape(cfg, B, max_pos),
                             generator=gen, device=device)
    if cfg.family == "vlm":
        patches = torch.randn(steps.patches_shape(cfg, B), generator=gen,
                              device=device)

    last, cache, t_prefill = D.run_prefill(
        cfg, params, prompts, max_pos, torch.float32, frames=frames,
        patches=patches, long_context=a.long_context)
    print(f"prefill: {B}x{S} tokens in {t_prefill*1e3:.1f} ms "
          f"({B*S/t_prefill:.0f} tok/s)")
    out, _, t_dec = D.run_decode(cfg, params, last, cache, S, a.tokens - 1,
                                 long_context=a.long_context)
    print(f"decode: {a.tokens} steps x {B} seqs in {t_dec*1e3:.1f} ms "
          f"({(a.tokens-1)*B/max(t_dec,1e-9):.0f} tok/s)")
    ids = out.cpu()
    print("generated ids (seq 0):", ids[0].tolist())
    return {"arch": cfg.name, "tokens": ids.tolist(),
            "prefill_s": t_prefill, "decode_s": t_dec}


if __name__ == "__main__":
    main()
