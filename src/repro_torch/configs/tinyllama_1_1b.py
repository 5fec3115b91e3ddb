"""TinyLlama-1.1B — llama2-arch small.

Counterpart of `repro.configs.tinyllama_1_1b` [arXiv:2401.02385]: 22
layers, d_model 2048, 32 query heads and 4 KV heads of 64, SwiGLU d_ff
5632, vocab 32000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    citation="arXiv:2401.02385",
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
))
