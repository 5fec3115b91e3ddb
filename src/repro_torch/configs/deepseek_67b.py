"""DeepSeek-67B — llama-arch dense.

Counterpart of `repro.configs.deepseek_67b` [arXiv:2401.02954]: 95
layers, d_model 8192, 64 query heads and 8 KV heads of 128, SwiGLU d_ff
22016, vocab 102400.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    citation="arXiv:2401.02954",
    act="silu",
    gated_mlp=True,
))
