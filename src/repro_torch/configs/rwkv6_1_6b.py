"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay.

Counterpart of `repro.configs.rwkv6_1_6b` [arXiv:2404.05892]: 24 layers,
d_model 2048, 32 heads of 64, d_ff 7168, vocab 65536.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                # wkv heads = d_model / rwkv_head_dim
    d_ff=7168,
    vocab_size=65536,
    citation="arXiv:2404.05892",
    rwkv_head_dim=64,
    gated_mlp=False,           # rwkv channel-mix: square-relu two-matrix FFN
    act="sqrelu",
    norm="layernorm",
    long_context_mode="native",  # O(1) recurrent state
))
