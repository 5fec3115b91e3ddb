"""ResNet-18-CIFAR backbone (counterpart of `repro.models.resnet`)."""
