"""Qwen2-0.5B — GQA with QKV bias.

Counterpart of `repro.configs.qwen2_0_5b` [arXiv:2407.10671]: 24 layers,
d_model 896, 14 query heads and 2 KV heads of 64, q/k/v biases, SwiGLU
d_ff 4864, vocab 151936, tied embeddings, RoPE theta 1e6.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    citation="arXiv:2407.10671",
    qkv_bias=True,
    tie_embeddings=True,
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
))
