"""Config registry of the port: the paper's ResNet-18/CIFAR model and the
two LLMs whose serving path is ported (qwen2-1.5b, rwkv6-7b)."""
from __future__ import annotations

from repro_torch.configs import qwen2_1_5b, resnet18_cifar, rwkv6_7b
from repro_torch.configs.base import (ChurnConfig, CommsConfig,
                                      DeviceProfile, FLConfig, ModelConfig,
                                      ThreatConfig)

ARCH_REGISTRY: dict[str, ModelConfig] = {
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "resnet18-cifar": resnet18_cifar.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}"
        )
    return ARCH_REGISTRY[name]


__all__ = ["ARCH_REGISTRY", "ChurnConfig", "CommsConfig", "DeviceProfile",
           "FLConfig", "ModelConfig", "ThreatConfig", "get_config"]
