"""Hymba-1.5B — parallel attention and mamba heads in every layer.

Counterpart of `repro.configs.hymba_1_5b` [arXiv:2411.13676]: 32 layers,
d_model 1600, 25 attention heads and 5 KV heads of 64 beside a
selective-SSM branch (state 16, expand 2: 3200 inner channels) in every
layer, the two branches' outputs mean-fused after a norm each; SwiGLU
d_ff 5504, vocab 32001. Attention uses a sliding window of 1024 in
every layer; the SSM branch carries the context beyond it, so long
contexts run natively.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    citation="arXiv:2411.13676",
    ssm_state=16,
    ssm_expand=2,
    hybrid_parallel=True,
    sliding_window=1024,
    long_context_mode="native",  # SSM branch is O(1)-state
))
