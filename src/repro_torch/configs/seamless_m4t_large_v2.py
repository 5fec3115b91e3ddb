"""SeamlessM4T-large-v2 — an encoder-decoder over audio frames.

Counterpart of `repro.configs.seamless_m4t_large_v2` [arXiv:2308.11596]:
the backbone only, 24 encoder and 24 decoder layers, d_model 1024, 16
heads with 16 KV heads (MHA), d_ff 8192 with the tanh gelu and no gate,
layernorm, vocab 256206 (padded to 258048). Each decoder layer is the
decoder block followed by a tanh-gated cross-attention block over the
encoder's output. The speech frontend (mel-spectrogram and conformer
feature extractor) is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T_frames, d_audio) through a linear
adapter.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,               # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    citation="arXiv:2308.11596",
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    d_audio=1024,
))
