"""Model configs: own copy of the `repro.configs` registry (ResNet-18-CIFAR,
RWKV6-1.6B and the dense TinyLlama-1.1B, Qwen2-0.5B, Gemma2-27B and
DeepSeek-67B)."""
from repro_torch.configs.base import (  # noqa: F401
    InputShape, ModelConfig, get_config)
