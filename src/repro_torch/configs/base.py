"""Model/run configuration dataclasses — the port's own copy of
`repro.configs.base`, trimmed to the fields the ported paths read.

`ModelConfig` keeps the CNN family (the paper's ResNet-18/CIFAR) and the
dense and ssm (RWKV6) LLM families that the serving path runs. The
reference's MoE, MLA, hybrid, audio and vlm fields are not ported (ROADMAP
queue 1 item 12). `FLConfig` keeps the Section III protocol; the
reference's network fabric, device-heterogeneity and open-world fields are
not ported yet (ROADMAP queue 1 items 8–11), so a config cannot ask for
them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # cnn | dense | ssm are ported
    dtype: str = "bfloat16"
    source: str = ""               # citation of the published config

    # --- LLM (dense, ssm) ----------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    num_kv_heads: int = 0          # 0 → MHA (= num_heads)
    head_dim: int = 0              # 0 → d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    act: str = "silu"
    ssm_head_dim: int = 64         # rwkv6 wkv head width

    # --- CNN (the paper's resnet) ----------------------------------------------
    cnn_stages: Tuple[int, ...] = ()      # blocks per stage
    cnn_width: int = 64
    image_size: int = 32
    image_channels: int = 3
    num_classes: int = 0

    def __post_init__(self):
        if self.num_kv_heads == 0 and self.num_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Embed/lm_head vocab dim, padded to a multiple of 256 (the
        reference's layout); the padded classes are never sampled."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def n_rep(self) -> int:
        """GQA repetition factor."""
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def reduced(self) -> "ModelConfig":
        """Same-family CPU smoke variant (reference `ModelConfig.reduced`):
        an LLM keeps ≤2 layers, d_model ≤ 256, ≤4 heads, d_ff ≤ 512 and a
        vocabulary ≤ 512; the CNN two stages of one block at width 16."""
        changes = dict(name=self.name + "-smoke")
        if self.family == "cnn":
            changes.update(cnn_stages=(1, 1), cnn_width=16)
        else:
            d_model = min(self.d_model, 256)
            heads = min(self.num_heads, 4)
            changes.update(
                num_layers=min(self.num_layers, 2),
                d_model=d_model,
                num_heads=heads,
                num_kv_heads=min(self.num_kv_heads, heads),
                head_dim=max(8, d_model // heads) if heads else 0,
                d_ff=min(self.d_ff, 512),
                vocab_size=min(self.vocab_size, 512),
            )
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
