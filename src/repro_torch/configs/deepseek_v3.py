"""deepseek-v3-671b [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8.

Deviations (the reference's, kept): a uniform stack of MoE layers (the
real first-3 dense layers are folded into the uniform stack); MTP head
omitted.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,        # MLA: per-head KV reconstructed from rank-512 latent
    d_ff=2048,
    vocab_size=129280,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    source="arXiv:2412.19437",
)
