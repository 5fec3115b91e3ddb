"""Config registry — counterpart of `repro.configs.base` (`ModelConfig`,
`pad_vocab`, `InputShape`, `get_config`).

The port keeps its own copy of the `ModelConfig` fields its models read
and of `get_config`, with the reference's ``-smoke`` suffix for the
`reduced()` variant. It registers the paper's backbone,
``resnet18-cifar`` (configs/resnet18_cifar.py), and the zoo's one
architecture that runs a TPU kernel, ``rwkv6-1.6b``
(configs/rwkv6_1_6b.py). The reference's other architectures raise
NotImplementedError naming the ROADMAP.md entry that ports them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

VOCAB_PAD_MULTIPLE = 2048

# The reference's registry (repro/configs/) beyond what the port runs.
UNPORTED_ARCHS = ("deepseek-67b", "gemma2-27b", "hymba-1.5b",
                  "kimi-k2-1t-a32b", "llama-3.2-vision-90b", "olmoe-1b-7b",
                  "qwen2-0.5b", "seamless-m4t-large-v2", "tinyllama-1.1b")
PORTED_FAMILIES = ("resnet", "ssm")
ROADMAP_ZOO = "ROADMAP.md Queue A, item 12 (the other zoo families)"


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return int(math.ceil(v / multiple) * multiple)


def family_not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"family={family!r} is not ported to repro_torch yet; see "
        f"{ROADMAP_ZOO}")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters: the fields of the reference's
    `ModelConfig` that the ResNet and ``ssm`` (RWKV6) families read, with
    the reference's defaults."""

    name: str
    family: str      # resnet | ssm (the reference's others: not ported)
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0
    citation: str = ""
    rwkv_head_dim: int = 64
    act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False
    final_logit_softcap: float = 0.0
    long_context_mode: str = "sliding_window"

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family and code path, tiny dims (the
        reference's rule: 2 layers, d_model <= 256, <= 4 heads of 64,
        d_ff <= 512, vocab <= 1024)."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=2,
            d_model=min(self.d_model, 256), n_heads=min(self.n_heads, 4),
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 1024))


@dataclass(frozen=True)
class InputShape:
    """One (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """The registered config `name`; ``<name>-smoke`` is its `reduced()`."""
    if not _REGISTRY:
        from repro_torch.configs import resnet18_cifar, rwkv6_1_6b  # noqa: F401
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch={name!r} is not ported to repro_torch yet; see "
            f"{ROADMAP_ZOO}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; the port registers "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]
