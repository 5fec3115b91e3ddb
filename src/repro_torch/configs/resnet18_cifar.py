"""Paper's own backbone: improved ResNet-18 with a fixed 128-D projector.

Counterpart of `repro.configs.resnet18_cifar` (FLSimCo Sec. 5.1: "We
adopt an improved ResNet-18 with a fixed dimension of 128-D as the
backbone model").
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="resnet18-cifar",
    family="resnet",
    n_layers=18,
    d_model=512,          # final stage width
    n_heads=1,
    n_kv_heads=1,
    d_ff=128,             # projector output dim (128-D)
    vocab_size=10,        # CIFAR-10 classes (for the probe head)
    citation="FLSimCo Sec. 5.1 / arXiv:2203.17248 (SimCo)",
))
