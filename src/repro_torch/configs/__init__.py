"""Config registry of the port: the paper's ResNet-18/CIFAR model and the
reference's ten LLMs, all served (dense: qwen2-1.5b, qwen2.5-3b,
qwen2.5-14b, starcoder2-7b; moe: phi3.5-moe-42b-a6.6b, deepseek-v3-671b;
vlm: internvl2-76b; ssm: rwkv6-7b; hybrid: recurrentgemma-2b; audio:
whisper-base)."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v3, internvl2_76b, phi35_moe,
                                 qwen2_1_5b, qwen2_5_14b, qwen2_5_3b,
                                 recurrentgemma_2b, resnet18_cifar, rwkv6_7b,
                                 starcoder2_7b, whisper_base)
from repro_torch.configs.base import (INPUT_SHAPES, ChurnConfig,
                                      CommsConfig, DeviceProfile, FLConfig,
                                      InputShape, ModelConfig, ThreatConfig)

ARCH_REGISTRY: dict[str, ModelConfig] = {
    "phi3.5-moe-42b-a6.6b": phi35_moe.CONFIG,
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "qwen2.5-14b": qwen2_5_14b.CONFIG,
    "deepseek-v3-671b": deepseek_v3.CONFIG,
    "starcoder2-7b": starcoder2_7b.CONFIG,
    "resnet18-cifar": resnet18_cifar.CONFIG,
}

ASSIGNED_ARCHS = [k for k in ARCH_REGISTRY if k != "resnet18-cifar"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}"
        )
    return ARCH_REGISTRY[name]


__all__ = ["ARCH_REGISTRY", "ASSIGNED_ARCHS", "ChurnConfig", "CommsConfig",
           "DeviceProfile", "FLConfig", "INPUT_SHAPES", "InputShape",
           "ModelConfig", "ThreatConfig", "get_config"]
