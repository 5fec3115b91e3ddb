"""OLMoE-1B-7B — 64 experts, top-8 MoE.

Counterpart of `repro.configs.olmoe_1b_7b` [arXiv:2409.02060]: 16
layers, d_model 2048, 16 heads (MHA), expert d_ff 1024, 64 routed
experts of which 8 are active, SwiGLU, vocab 50304.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    citation="arXiv:2409.02060",
    n_experts=64,
    n_experts_active=8,
    act="silu",
    gated_mlp=True,
))
