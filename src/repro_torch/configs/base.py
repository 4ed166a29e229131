"""Model/run configuration dataclasses — the port's own copy of
`repro.configs.base`.

`ModelConfig` has every field of the reference's, with its defaults,
`__post_init__`, properties, `param_count` and `reduced()`: the paper's
ResNet-18/CIFAR (cnn) and the LLM families. The serving path runs every
LLM family: dense, moe (with MLA), vlm (text tokens only), ssm (RWKV6),
hybrid (RecurrentGemma) and audio (Whisper). `FLConfig` keeps the Section III protocol
and the network fabric (`CommsConfig`, `repro_torch.comms`), and the
semi-async rounds' device model (`DeviceProfile`, `deadline_s`,
`staleness_alpha`, `version_depth`; `repro_torch.fl.hetero`), and the open
world (`ThreatConfig`, `ChurnConfig`; `repro_torch.openworld`).
`InputShape` / `INPUT_SHAPES` are the reference's four assigned step
shapes, which the dry run (`repro_torch.launch.dryrun`) counts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio |
                                   # vlm | cnn
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
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""               # citation of the published config

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert FFN width (0 → d_ff)
    moe_dispatch: str = "gather"   # "gather" (prod) | "einsum" (GShard ref)

    # --- MLA (deepseek) ------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (rwkv6) ---------------------------------------------------------
    ssm_head_dim: int = 64         # wkv head width

    # --- hybrid (recurrentgemma) ----------------------------------------------
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    window_size: int = 0                  # local attention window
    lru_width: int = 0                    # 0 → d_model

    # --- encoder-decoder (whisper) ---------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500        # stub frame-embedding sequence length

    # --- modality frontend stub (audio/vlm) -------------------------------------
    frontend: str = "none"         # none | audio_stub | vision_stub
    num_prefix_tokens: int = 0     # vision patch tokens prepended to text

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
        if self.moe_d_ff == 0 and self.num_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def padded_vocab(self) -> int:
        """Embed/lm_head vocab dim, padded to a multiple of 256 (the
        reference's layout); the padded classes are never sampled."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Whether the decode state does not grow with the context."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_rep(self) -> int:
        """GQA repetition factor."""
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def param_count(self) -> int:
        """Analytic parameter count (`models.model.count_params`)."""
        from repro_torch.models.model import count_params  # lazy: a cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Same-family CPU smoke variant (reference `ModelConfig.reduced`):
        ≤2 layers, d_model ≤ 256, ≤4 heads, d_ff ≤ 512, a vocabulary
        ≤ 512, ≤4 experts, a window ≤ 16 and the first three blocks of a
        hybrid pattern; the CNN two stages of one block at width 16."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        head_dim = max(8, d_model // heads) if heads else 0
        changes = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            window_size=min(self.window_size, 16) if self.window_size else 0,
            lru_width=0,
        )
        if self.num_experts:
            changes.update(
                num_experts=min(self.num_experts, 4),
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_d_ff=min(self.moe_d_ff, 256),
            )
        if self.use_mla:
            changes.update(
                q_lora_rank=min(self.q_lora_rank, 64) or 0,
                kv_lora_rank=min(self.kv_lora_rank, 64),
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
        if self.block_pattern:
            pattern = self.block_pattern[:3]
            changes.update(block_pattern=pattern, num_layers=len(pattern))
        if self.family == "cnn":
            changes.update(cnn_stages=(1, 1), cnn_width=16)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class CommsConfig:
    """Network model of the decentralized fabric (`repro_torch.comms`).

    The default — fully-connected topology, uniform links, no events —
    is the paper's §III-A world of equal communication cost between all
    clients: the Eq. 9 `c` matrix is the scalar `FLConfig.comm_cost` off
    the diagonal and every peer is a candidate.
    """
    # --- topology -----------------------------------------------------------
    topology: str = "full"      # full | ring | torus | erdos_renyi |
                                # small_world | hier_ring | geo_cell |
                                # dynamic
    ring_hops: int = 1          # ring: connect to ±1..hops neighbours
    er_p: float = 0.3           # erdos_renyi: iid edge probability
    ws_k: int = 4               # small_world: base lattice degree (even)
    ws_beta: float = 0.2        # small_world: rewiring probability
    hier_cluster: int = 16      # hier_ring: clients per cluster ring
    geo_cells: int = 4          # geo_cell: grid cells per unit-square side
    dyn_degree: int = 4         # dynamic: score-driven out-degree
    dyn_explore: int = 1        # dynamic: extra random exploration edges
    graph_seed: int = 0         # static graph sampling seed
    sparse: bool = False        # the packed CSR SparseFabric (static
                                # topologies, p2p accounting only)

    # --- link model ---------------------------------------------------------
    link_model: str = "uniform"     # uniform | hetero | geometric
    bandwidth_mbps: float = 100.0   # mean link bandwidth
    latency_ms: float = 10.0        # mean one-way link latency
    hetero_spread: float = 4.0      # hetero: max/min client-tier ratio
    energy_nj_per_byte: float = 5.0 # radio energy per byte on the mean link

    # --- network events -----------------------------------------------------
    p_link_drop: float = 0.0    # per-round iid symmetric edge dropout
    availability: float = 1.0   # per-round per-client online probability
    p_stale: float = 0.0        # prob. a client's update misses the deadline
    max_staleness: int = 3      # staleness horizon (rounds)
    stale_mode: str = "drop"    # "drop": a stale peer loses its candidate
                                # column; "serve": it stays selectable
                                # (a versioned strategy serves its
                                # published snapshot, pfeddst_async)

    # --- payload ------------------------------------------------------------
    payload_bits: int = 0       # quantized bits/param (0 → native dtype)
    msg_overhead_bytes: int = 0 # fixed per-message framing overhead

    def __post_init__(self):
        if self.stale_mode not in ("drop", "serve"):
            raise ValueError(
                f"stale_mode must be 'drop' or 'serve', "
                f"got {self.stale_mode!r}")
        if self.sparse and self.topology == "dynamic":
            raise ValueError(
                "sparse=True requires a static topology (the dynamic "
                "graph is resampled every round and has no CSR)")


@dataclass(frozen=True)
class DeviceProfile:
    """Per-client device capability model (`repro_torch.fl.hetero`).

    Sampled once per experiment into three (M,) vectors — relative
    compute speed, channel rate and energy scale — that feed the
    per-client round wall-time of the semi-async deadline gate and the
    link-cost `c` matrix of the Eq. 9 peer score (a slow channel makes a
    peer less attractive to pull).

    Families:
      uniform   every device identical (speed 1.0), the paper's implicit
                assumption; the semi-async rounds then reduce exactly to
                the synchronous protocol.
      bimodal   `straggler_fraction` of the clients run
                `straggler_slowdown` times slower.
      zipf      speed ∝ rank^(−zipf_exponent) over a random permutation
                of the clients: a long-tailed capability distribution.
    """
    family: str = "uniform"            # uniform | bimodal | zipf
    straggler_fraction: float = 0.25   # bimodal: fraction of slow devices
    straggler_slowdown: float = 4.0    # bimodal: slow-device speed = 1/this
    zipf_exponent: float = 1.1         # zipf: speed_i = rank_i^(−exponent)
    step_time_s: float = 0.1           # reference-device seconds / local step
    comm_s: float = 0.5                # reference payload transfer seconds
    rate_follows_speed: bool = True    # slow compute ⇒ equally slow channel
    seed: int = 0                      # device-vector sampling seed


@dataclass(frozen=True)
class ThreatConfig:
    """Adversary model of open-world runs (`repro_torch.openworld`).

    A fixed `adversary_fraction` of the population is adversarial
    (deterministic in `seed`, so every driver — simulator, benches,
    SelectionGraph annotation — sees the same set). Adversaries can
    corrupt their local update (byzantine `attack`), game the Eq. 9 peer
    score (`score_game`), or both; `defense` swaps the library
    aggregation for a robust reducer. With every knob at its default
    (`adversary_fraction=0`, attacks and defense "none") the strategy's
    stages are returned unchanged, bit for bit the closed honest
    population.
    """
    adversary_fraction: float = 0.0
    # --- byzantine update corruption (applied after local training) --------
    attack: str = "none"        # none | sign_flip | gaussian | scale
    attack_scale: float = 1.0   # sign_flip / scale: delta multiplier
    noise_std: float = 1.0      # gaussian: per-param noise stddev
    # --- Eq. 9 score gaming -------------------------------------------------
    # "header": publish an anti-aligned header so the Eq. 7 similarity
    #   term (subtracted in Eq. 9) makes the adversary maximally
    #   attractive; "cost": under-report the Eq. 9 link cost (claim the
    #   best link in the fleet × cost_gain); "both": both.
    score_game: str = "none"    # none | header | cost | both
    cost_gain: float = 1.0      # cost gaming: claimed c = best link × gain
    # --- robust aggregation (repro_torch.openworld.defense) ----------------
    defense: str = "none"       # none | trimmed_mean | median | norm_clip
    trim_fraction: float = 0.2  # trimmed_mean: fraction cut from each tail
    clip_factor: float = 2.0    # norm_clip: allowed multiple of the median
    seed: int = 0               # adversary-set sampling seed

    def __post_init__(self):
        if self.attack not in ("none", "sign_flip", "gaussian", "scale"):
            raise ValueError(f"unknown attack {self.attack!r}")
        if self.score_game not in ("none", "header", "cost", "both"):
            raise ValueError(f"unknown score_game {self.score_game!r}")
        if self.defense not in ("none", "trimmed_mean", "median",
                                "norm_clip"):
            raise ValueError(f"unknown defense {self.defense!r}")

    @property
    def inert(self) -> bool:
        """True when no knob changes the round: the composition layer then
        leaves the stages untouched (the bitwise guarantee)."""
        return (self.adversary_fraction <= 0.0
                or (self.attack == "none" and self.score_game == "none")) \
            and self.defense == "none"


@dataclass(frozen=True)
class ChurnConfig:
    """Client join/leave churn on the fixed-capacity (M,) population
    (`repro_torch.openworld.lifecycle`).

    Each round every alive client leaves w.p. `leave_rate` and every dead
    slot joins w.p. `join_rate`; a round that would leave nobody alive
    keeps the previous alive mask instead (the zero-alive guard).
    Newcomers bootstrap from the alive peers' snapshots — the versioned
    peer store's served versions on versioned strategies, live
    parameters otherwise — and their optimizer state and PFedDST context
    rows (loss l, recency t) reset. With both rates 0 and `init_alive=1.0`
    the wrapped run is the closed population's, bit for bit.
    """
    join_rate: float = 0.0      # per-round P(dead slot joins)
    leave_rate: float = 0.0     # per-round P(alive client leaves)
    init_alive: float = 1.0     # fraction of slots alive at round 0 (≥1 slot)
    seed: int = 0               # initial-alive sampling seed

    @property
    def inert(self) -> bool:
        return (self.join_rate <= 0.0 and self.leave_rate <= 0.0
                and self.init_alive >= 1.0)


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
    seed: int = 0
    # network model; None → the scalar-cost path (no candidate masking,
    # no byte accounting)
    comms: Optional[CommsConfig] = field(default_factory=CommsConfig)
    # --- device heterogeneity + semi-async rounds (fl.hetero) --------------
    # None → every device identical (no device wall-time in History)
    device_profile: Optional[DeviceProfile] = None
    # per-round deadline in seconds of simulated device time. inf or <= 0
    # → synchronous rounds (a round stalls on its slowest sampled client);
    # finite → pfeddst_async gates out the clients whose round wall-time
    # exceeds it and serves their published snapshots meanwhile
    deadline_s: float = float("inf")
    # staleness discount of semi-async aggregation: a version `lag` rounds
    # old mixes with weight (1 + lag)^(−staleness_alpha)
    staleness_alpha: float = 0.5
    # ring depth V of pfeddst_async's versioned peer store
    version_depth: int = 4
    # --- open-world population (repro_torch.openworld) ---------------------
    # None → closed honest population (the paper's world). Setting either
    # wraps the strategy's stages (openworld.make_open_spec); inert configs
    # (fraction 0, rates 0) leave them bitwise untouched.
    threat: Optional[ThreatConfig] = None
    churn: Optional[ChurnConfig] = None
