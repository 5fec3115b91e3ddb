"""Model configs: own copy of the `repro.configs` registry (ResNet-18-CIFAR,
RWKV6-1.6B, the dense TinyLlama-1.1B, Qwen2-0.5B, Gemma2-27B and
DeepSeek-67B, the MoE OLMoE-1B-7B and Kimi-K2-1T-A32B, the hybrid
Hymba-1.5B, the audio encoder-decoder SeamlessM4T-large-v2 and the
vision-language Llama-3.2-Vision-90B)."""
from repro_torch.configs.base import (  # noqa: F401
    InputShape, ModelConfig, get_config, list_configs)
