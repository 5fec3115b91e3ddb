"""Kimi-K2 1T-A32B — trillion-parameter MoE, 384 experts top-8.

Counterpart of `repro.configs.kimi_k2_1t_a32b` [arXiv:2501.kimi2]: 61
layers, d_model 7168, 64 query heads and 8 KV heads of 128, expert d_ff
2048, 384 routed experts (8 active) and 1 shared expert, the first
layer dense, vocab 163840.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    citation="arXiv:2501.kimi2",
    n_experts=384,
    n_experts_active=8,
    n_shared_experts=1,
    moe_first_dense_layers=1,
    act="silu",
    gated_mlp=True,
))
