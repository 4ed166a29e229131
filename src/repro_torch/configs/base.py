"""Model/run configuration dataclasses — the port's own copy of
`repro.configs.base`, trimmed to the fields the PFedDST round and the
paper's baselines read.

`ModelConfig` keeps the CNN family only (the paper's ResNet-18/CIFAR);
`FLConfig` keeps the Section III protocol. The reference's network
fabric, device-heterogeneity and open-world fields are not ported yet
(ROADMAP queue 1 items 8–11), so a config cannot ask for them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "cnn" is the only family ported
    dtype: str = "bfloat16"
    cnn_stages: Tuple[int, ...] = ()      # blocks per stage
    cnn_width: int = 64
    image_size: int = 32
    image_channels: int = 3
    num_classes: int = 0

    def reduced(self) -> "ModelConfig":
        """Same-family CPU smoke variant (reference `ModelConfig.reduced`:
        two stages of one block, width 16)."""
        changes = dict(name=self.name + "-smoke")
        if self.family == "cnn":
            changes.update(cnn_stages=(1, 1), cnn_width=16)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class FLConfig:
    num_clients: int = 100
    peers_per_round: int = 10          # |M_i|
    client_sample_ratio: float = 0.1
    batch_size: int = 128
    epochs_extractor: int = 5          # K_e
    epochs_header: int = 1             # K_h
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.005
    # Eq. 8/9 score hyper-parameters
    alpha: float = 1.0                 # loss-score scale
    comm_cost: float = 1.0             # c (equal cost between clients, §III-A)
    recency_lambda: float = 0.5        # λ
    selection: str = "topk"            # "topk" | "threshold" | "random"
    score_threshold: float = 0.0       # s* (selection == "threshold")
    # route Eq. 7–9 scoring + top-k through the fused select_topk kernel
    # (topk selection) or the Eq. 7 Gram through raw_gram (threshold /
    # random selection)
    use_score_kernel: bool = False
    probe_size: int = 32               # per-client probe batch for s_l (Eq. 6)
    # Dis-PFL baseline (fl/strategies dispfl spec)
    dispfl_sparsity: float = 0.5       # personal-mask sparsity
    dispfl_regrow: float = 0.02        # RigL-style random regrow rate/round
    classes_per_client: int = 2        # pathological partition
