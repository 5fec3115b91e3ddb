"""Config registry — counterpart of `repro.configs.base` (`ModelConfig`,
`pad_vocab`, `InputShape`, `INPUT_SHAPES`, `get_config`,
`list_configs`).

The port keeps its own copy of the `ModelConfig` fields its models read,
of `INPUT_SHAPES` and of `get_config`, with the reference's ``-smoke``
suffix for the `reduced()` variant. It registers the paper's backbone,
``resnet18-cifar`` (configs/resnet18_cifar.py), the zoo's ``ssm``
architecture ``rwkv6-1.6b`` (configs/rwkv6_1_6b.py) and its four
``dense`` ones (``tinyllama-1.1b``, ``qwen2-0.5b``, ``gemma2-27b``,
``deepseek-67b``) and its two ``moe`` ones (``olmoe-1b-7b``,
``kimi-k2-1t-a32b``), its ``hybrid`` one, ``hymba-1.5b``
(configs/hymba_1_5b.py), its ``audio`` one, ``seamless-m4t-large-v2``
(configs/seamless_m4t_large_v2.py), and its ``vlm`` one,
``llama-3.2-vision-90b`` (configs/llama_3_2_vision_90b.py): every
architecture of the reference's registry. An unknown name raises
KeyError, as the reference's `get_config` does.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

VOCAB_PAD_MULTIPLE = 2048

PORTED_FAMILIES = ("resnet", "ssm", "dense", "moe", "hybrid", "audio",
                   "vlm")


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return int(math.ceil(v / multiple) * multiple)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters: the fields of the reference's
    `ModelConfig` that the ResNet, ``ssm`` (RWKV6), ``dense``, ``moe``,
    ``hybrid`` (Hymba), ``audio`` (SeamlessM4T) and ``vlm``
    (Llama-3.2-Vision) families read, with the reference's defaults."""

    name: str
    family: str      # resnet | ssm | dense | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                   # 0 -> d_model // n_heads
    citation: str = ""
    rope_theta: float = 10_000.0
    qkv_bias: bool = False              # qwen2
    sliding_window: int = 0             # 0 = full attention
    local_global_period: int = 0        # gemma2: 2 -> alternate local/global
    attn_logit_softcap: float = 0.0     # gemma2: 50.
    final_logit_softcap: float = 0.0    # gemma2: 30.
    attn_scale_override: float = 0.0    # 0 -> 1/sqrt(head_dim)
    ssm_state: int = 0                  # mamba state size (hymba 16)
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    hybrid_parallel: bool = False       # hymba: parallel attn + ssm heads
    act: str = "silu"
    gated_mlp: bool = True
    n_experts: int = 0
    n_experts_active: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    moe_impl: str = "auto"              # auto | scatter | ep (layers.moe_apply)
    n_shared_experts: int = 0           # kimi-k2: 1 shared expert
    moe_first_dense_layers: int = 0     # kimi-k2: first layer dense
    cross_attn_period: int = 0          # llama3.2-vision: every 5th layer
    n_vision_tokens: int = 0
    d_vision: int = 0
    n_encoder_layers: int = 0           # seamless: 24
    d_audio: int = 0                    # frontend frame-embedding dim
    norm: str = "rmsnorm"
    post_norm: bool = False             # gemma2: post-block norms too
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False
    long_context_mode: str = "sliding_window"
    long_context_window: int = 8192

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def _attn_params(self) -> int:
        d, h = self.d_model, self.head_dim_
        return (d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h)
                + (self.n_heads * h) * d)

    def n_params(self) -> int:
        """Approximate total parameter count (embeddings + blocks), the
        reference's formula: attention, (gated) MLP or experts plus
        router a layer; rwkv6's 6 d^2 mixing in place of attention;
        hybrid's SSM projections; the cross blocks and encoder layers;
        the padded vocab's embedding and unembedding."""
        d, h = self.d_model, self.head_dim_
        attn = self._attn_params()
        mlp_mult = 3 if self.gated_mlp else 2
        if self.is_moe:
            ff = mlp_mult * d * self.d_ff * (self.n_experts
                                             + self.n_shared_experts)
            ff += d * self.n_experts                        # router
        else:
            ff = mlp_mult * d * self.d_ff
        per_layer = attn + ff
        if self.family == "ssm":
            per_layer = 6 * d * d + mlp_mult * d * self.d_ff
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            per_layer = (attn + mlp_mult * d * self.d_ff + 2 * d * d_in
                         + d_in * d)
        n = self.n_layers * per_layer
        if self.cross_attn_period:
            n_cross = self.n_layers // self.cross_attn_period
            n += n_cross * (2 * d * d + 2 * d * (self.n_kv_heads * h))
        if self.is_encdec:
            n += self.n_encoder_layers * per_layer
        n += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return int(n)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: the active and shared experts
        only), the reference's formula; `n_params` for the others."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        mlp_mult = 3 if self.gated_mlp else 2
        dense_ff = mlp_mult * d * self.d_ff * (self.n_experts_active
                                               + self.n_shared_experts)
        per_layer = self._attn_params() + dense_ff + d * self.n_experts
        return int(self.n_layers * per_layer + self.padded_vocab * d * 2)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family and code path, tiny dims (the
        reference's rule: 2 layers, d_model <= 256, <= 4 heads of 64,
        <= 2 kv heads, d_ff <= 512, vocab <= 1024; 4 experts, 2 active,
        <= 1 shared and <= 1 leading dense layer; 2 encoder layers; a
        cross block every 2nd layer over 16 vision tokens 64 wide; a
        sliding window becomes 32, the long-context window 64 and the
        frame embedding 64 wide)."""
        kw = dict(name=self.name + "-smoke", n_layers=2,
                  d_model=min(self.d_model, 256),
                  n_heads=min(self.n_heads, 4),
                  n_kv_heads=min(self.n_kv_heads, 2), head_dim=64,
                  d_ff=min(self.d_ff, 512),
                  vocab_size=min(self.vocab_size, 1024))
        if self.n_experts:
            kw.update(n_experts=4, n_experts_active=2,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      moe_first_dense_layers=min(self.moe_first_dense_layers,
                                                 1))
        if self.n_encoder_layers:
            kw.update(n_encoder_layers=2)
        if self.cross_attn_period:
            kw.update(cross_attn_period=2, n_vision_tokens=16, d_vision=64)
        if self.sliding_window:
            kw.update(sliding_window=32)
        if self.long_context_window:
            kw.update(long_context_window=64)
        if self.d_audio:
            kw.update(d_audio=64)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    """One (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        deepseek_67b, gemma2_27b, hymba_1_5b, kimi_k2_1t_a32b,
        llama_3_2_vision_90b, olmoe_1b_7b, qwen2_0_5b, resnet18_cifar,
        rwkv6_1_6b, seamless_m4t_large_v2, tinyllama_1_1b)


def get_config(name: str) -> ModelConfig:
    """The registered config `name`; ``<name>-smoke`` is its `reduced()`."""
    if not _REGISTRY:
        _load_all()
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; the port registers "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    """Every registered name, sorted, as the reference's."""
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)
