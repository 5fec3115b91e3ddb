"""Prefill + greedy decode of a zoo model — counterpart of
`repro.launch.decode` (`main`), for the port's ``ssm`` family (RWKV6,
a recurrent cache), ``dense`` family (tinyllama-1.1b, qwen2-0.5b,
gemma2-27b, deepseek-67b; a ring-buffer KV cache), ``moe`` family
(olmoe-1b-7b, kimi-k2-1t-a32b; the dense family's caches), ``hybrid``
family (hymba-1.5b; the ring of its 1024 window beside the SSM and conv
states), ``audio`` family (seamless-m4t-large-v2; the decoder's
rings beside the encoder's context) and ``vlm`` family
(llama-3.2-vision-90b; the decoder blocks' rings beside the projected
patches).

The reference runs ``--reduced`` end to end on the CPU and, without it,
only lowers and compiles the decode step for a TPU mesh. The port runs
both on one card, or on the zoo mesh under ``torchrun --nproc-per-node
N`` (or with ``--model-parallel M``, as `launch.train`'s mesh mode:
every family; params, prompts and caches sharded, rank 0 prints):
``--reduced`` is the reference's run (the ``-smoke`` config, B = 2,
S = 32, float32 parameters and cache); without it the full-width config
runs on the card with bfloat16 parameters and cache (the reference's
serve-step default), at ``--batch`` prompts of ``--prompt-len`` random
tokens. Weights are random, from ``--seed``. The cache holds prompt plus
decode tokens, as the reference's; a dense prefill takes the flash path
where the prompt has 2048 tokens or more and that sum is a multiple of
1024 (`layers.attention_core`), as 3008 + 64 below.

    PYTHONPATH=src python -m repro_torch.launch.decode --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.decode --arch rwkv6-1.6b \\
        --batch 16 --prompt-len 2048 --tokens 64       # on the card
    PYTHONPATH=src python -m repro_torch.launch.decode --arch tinyllama-1.1b \\
        --batch 16 --prompt-len 3008 --tokens 64       # on the card
    PYTHONPATH=src python -m repro_torch.launch.decode --arch olmoe-1b-7b \\
        --batch 16 --prompt-len 3008 --tokens 64       # on the card
    PYTHONPATH=src python -m repro_torch.launch.decode --arch kimi-k2-1t-a32b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.decode --arch hymba-1.5b \\
        --batch 16 --prompt-len 1024 --tokens 64       # on the card

A hymba prompt longer than its window of 1024 loses keys of its earlier
queries' windows, as the reference's prefill does (models/transformer.py).
The command line prefills seamless without frames, as the reference's
does: its cross blocks then attend over a zero context of max(S // 4,
8) rows (S the cache's length). `run_prefill` takes frames.

    PYTHONPATH=src python -m repro_torch.launch.decode \\
        --arch seamless-m4t-large-v2 --reduced --device cpu

The command line prefills llama-3.2-vision-90b without patches too: its
cross blocks attend over a zero context of n_vision_tokens rows.
`run_prefill` takes patches. At full width its 100 layers (181 GB in
bf16) do not fit one card; chip_smoke.py serves it with n_layers cut to
5, one period.

    PYTHONPATH=src python -m repro_torch.launch.decode \\
        --arch llama-3.2-vision-90b --reduced --device cpu

On 8 gloo ranks of the CPU, model-parallel over 4:

    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.decode \
        --arch tinyllama-1.1b --reduced --device cpu --batch 8 \
        --model-parallel 4
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.decode \
        --reduced --device cpu --batch 8 --model-parallel 4   # rwkv6

Prints the prefill time, the decode time per step and decode tok/s.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T
from repro_torch.runtime import set_parity_mode


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_model(cfg, seed: int, dtype, device) -> dict:
    """Random parameters drawn on `device` from a generator seeded with
    `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_params(cfg, gen, dtype)


def random_prompts(cfg, batch: int, length: int, seed: int, device):
    """(batch, length) token ids in [1, vocab_size), drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(1, cfg.vocab_size, (batch, length), generator=gen,
                         device=device)


def greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) next token ids over the real vocabulary."""
    return torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]


def _shape(kind: str, total_len: int, b: int, long_context: bool):
    """The step's InputShape: the reference's ``long_500k`` name selects
    the long-context cache (`steps._long_context`)."""
    return InputShape("long_500k" if long_context else kind, total_len, b,
                      kind)


def run_prefill(cfg, params, prompts, total_len: int, param_dtype,
                frames=None, patches=None, mesh=None,
                long_context: bool = False):
    """Prefill `prompts` (with the ``audio`` family's `frames` (B, Te,
    d_audio) or the ``vlm`` family's `patches` (B, n_vision_tokens,
    d_vision) when given); returns (last-position logits (B, V), cache,
    seconds on the host clock, synchronised). On a zoo `mesh` the params
    are DTensors and the logits and cache come back as DTensors.
    `long_context` serves the long-context cache (the reference's
    ``long_context=True``)."""
    b = prompts.shape[0]
    prefill = st.make_prefill_step(
        cfg, _shape("prefill", total_len, b, long_context), param_dtype,
        mesh=mesh)
    batch = {"tokens": prompts}
    for k, v in (("frames", frames), ("patches", patches)):
        if v is not None:
            batch[k] = v
    _sync(prompts.device)
    t0 = time.perf_counter()
    last, cache = prefill(params, batch)
    _sync(prompts.device)
    return last, cache, time.perf_counter() - t0


def run_decode(cfg, params, last, cache, start: int, n_tokens: int,
               mesh=None, long_context: bool = False):
    """`n_tokens` greedy decode steps from the prefill's `last` logits at
    absolute position `start`. Returns (tokens (B, n_tokens + 1): the
    prefill's pick then each step's, cache, seconds, synchronised). On a
    zoo `mesh` each step's logits are gathered for the pick."""
    b = last.shape[0]
    decode = st.make_decode_step(
        cfg, _shape("decode", start + n_tokens, b, long_context), mesh=mesh)
    last = sh.full(last)
    tok = greedy(cfg, last)
    out = [tok]
    _sync(tok.device)
    t0 = time.perf_counter()
    for i in range(n_tokens):
        # analysis: allow=retrace-fresh-array -- the step's positions,
        # filled on the device (no upload)
        pos = torch.full((b,), start + i, dtype=torch.int64, device=tok.device)
        logits, cache = decode(params, {"tokens": tok, "positions": pos,
                                        "cache": cache})
        tok = greedy(cfg, sh.full(logits))
        out.append(tok)
    _sync(tok.device)
    return torch.cat(out, dim=1), cache, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None,
                    help="prompts (default: 2 reduced, 16 full width)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="prompt tokens (default: 32 reduced, 2048 full)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--multi-pod", action="store_true",
                    help="mesh: two pods, (pod, data, model)")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="mesh: ranks a model-parallel group; given, the "
                         "zoo mesh runs even at world size 1")
    a = ap.parse_args(argv)

    cfg = get_config(a.arch)
    device, mesh = st.launch_zoo_mesh(a.device, a.model_parallel,
                                      a.multi_pod)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    set_parity_mode()
    if a.reduced:
        cfg = cfg.reduced()
        dtype, b, s = torch.float32, a.batch or 2, a.prompt_len or 32
    else:
        dtype, b, s = torch.bfloat16, a.batch or 16, a.prompt_len or 2048
    params = init_model(cfg, a.seed, dtype, device)
    if mesh is not None:
        params = st.shard_params(cfg, params, mesh)
    prompts = random_prompts(cfg, b, s, a.seed, device)
    # warm-up: builds the kernel and the library handles before timing
    last, cache, _ = run_prefill(cfg, params, prompts, s + a.tokens, dtype,
                                 mesh=mesh)
    run_decode(cfg, params, last, cache, s, min(a.tokens, 2), mesh)
    last, cache, t_pre = run_prefill(cfg, params, prompts, s + a.tokens, dtype,
                                     mesh=mesh)
    toks, _, t_dec = run_decode(cfg, params, last, cache, s, a.tokens, mesh)
    if not bool(torch.isfinite(sh.full(last)[:, :cfg.vocab_size]).all()):
        raise SystemExit("prefill logits are not finite")
    if not lead:
        return
    if mesh is not None:
        device = (f"the {dict(zip(mesh.mesh_dim_names, mesh.shape))} mesh "
                  f"of {device.type} ranks")
    print(f"{cfg.name} on {device}: prefill {b}x{s} in {t_pre * 1e3:.1f} ms "
          f"({b * s / t_pre:.0f} tok/s); {a.tokens} decode steps x {b} seqs "
          f"in {t_dec * 1e3:.1f} ms ({t_dec * 1e3 / max(a.tokens, 1):.2f} "
          f"ms/step, {a.tokens * b / t_dec:.1f} tok/s); first tokens "
          f"{toks[0, :8].tolist()}")


if __name__ == "__main__":
    main()
