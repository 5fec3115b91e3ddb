"""Model configs: own copy of the `repro.configs` registry (ResNet-18-CIFAR
and RWKV6-1.6B)."""
from repro_torch.configs.base import (  # noqa: F401
    InputShape, ModelConfig, get_config)
