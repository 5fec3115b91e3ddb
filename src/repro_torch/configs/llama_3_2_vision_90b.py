"""Llama-3.2-Vision-90B — a decoder with gated cross-attention image layers.

Counterpart of `repro.configs.llama_3_2_vision_90b`
[hf:meta-llama/Llama-3.2-11B-Vision]: the language backbone only, 100
layers (80 self-attention and 20 gated cross-attention, one every 5th
layer), d_model 8192, 64 heads with 8 KV heads (GQA), d_ff 28672 with
the gated silu, RMSNorm, vocab 128256 (padded to 129024). The ViT
vision encoder is a stub, as in the reference: the model takes
precomputed patch embeddings (B, n_vision_tokens, d_vision), which one
linear projector maps to d_model for the cross-attention's keys and
values.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
    cross_attn_period=5,
    n_vision_tokens=1601,      # 1 global + 1600 patches at 560 px
    d_vision=1280,
    act="silu",
    gated_mlp=True,
))
