"""Gemma2-27B — local/global alternating attention, logit softcaps.

Counterpart of `repro.configs.gemma2_27b` [arXiv:2408.00118]: 46 layers,
d_model 4608, 32 query heads and 16 KV heads of 128, GeGLU d_ff 36864,
vocab 256000, even layers a 4096 sliding window and odd layers global,
attention softcap 50 and final softcap 30, post-block norms, sqrt(d)
embedding scale, tied embeddings, query scale 1/sqrt(224).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    citation="arXiv:2408.00118",
    local_global_period=2,      # even layers: sliding window; odd: global
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    gated_mlp=True,             # GeGLU
    norm="rmsnorm",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    attn_scale_override=1.0 / (224 ** 0.5),  # query_pre_attn_scalar=224 for 27B
))
