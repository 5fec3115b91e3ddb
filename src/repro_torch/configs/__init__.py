"""Model configs: own copy of the `repro.configs` registry (ResNet only)."""
from repro_torch.configs.base import ModelConfig, get_config  # noqa: F401
