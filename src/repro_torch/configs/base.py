"""Config registry — counterpart of `repro.configs.base`.

The port keeps its own copy of the `ModelConfig` fields its models read
and of `get_config`. Slice 1 registers only the paper's backbone,
``resnet18-cifar`` (configs/resnet18_cifar.py); the transformer zoo comes
with its own slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the subset the ResNet family reads)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    citation: str = ""


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        from repro_torch.configs import resnet18_cifar  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; the port registers "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]
