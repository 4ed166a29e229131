"""Config registry of the port: the paper's ResNet-18/CIFAR model and the
LLMs whose serving path is ported (dense: qwen2-1.5b, qwen2.5-3b,
qwen2.5-14b, starcoder2-7b; ssm: rwkv6-7b; hybrid: recurrentgemma-2b;
audio: whisper-base)."""
from __future__ import annotations

from repro_torch.configs import (qwen2_1_5b, qwen2_5_14b, qwen2_5_3b,
                                 recurrentgemma_2b, resnet18_cifar, rwkv6_7b,
                                 starcoder2_7b, whisper_base)
from repro_torch.configs.base import (ChurnConfig, CommsConfig,
                                      DeviceProfile, FLConfig, ModelConfig,
                                      ThreatConfig)

ARCH_REGISTRY: dict[str, ModelConfig] = {
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "qwen2.5-14b": qwen2_5_14b.CONFIG,
    "starcoder2-7b": starcoder2_7b.CONFIG,
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
