"""Config registry of the port: the paper's ResNet-18/CIFAR model."""
from __future__ import annotations

from repro_torch.configs import resnet18_cifar
from repro_torch.configs.base import FLConfig, ModelConfig

ARCH_REGISTRY: dict[str, ModelConfig] = {
    "resnet18-cifar": resnet18_cifar.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}"
        )
    return ARCH_REGISTRY[name]


__all__ = ["ARCH_REGISTRY", "FLConfig", "ModelConfig", "get_config"]
