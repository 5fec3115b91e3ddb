"""Models of the port: the ResNet-18-CIFAR backbone (counterpart of
`repro.models.resnet`) and the zoo's RWKV6 family (`models.layers`,
`models.transformer`)."""
