"""The paper's own model: ResNet-18 on CIFAR (PFedDST §III uses ResNet-18).

GroupNorm replaces BatchNorm (FL-safe under aggregation).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet18-cifar",
    family="cnn",
    num_layers=18,
    d_model=512,             # final feature width
    cnn_stages=(2, 2, 2, 2),
    cnn_width=64,
    image_size=32,
    image_channels=3,
    num_classes=10,
    source="paper §III (He et al. 2016 ResNet-18)",
)
