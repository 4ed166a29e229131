"""rwkv6-7b (Finch) [arXiv:2404.05892] — attention-free, data-dependent decay."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # wkv heads = d_model / ssm_head_dim
    num_kv_heads=64,
    head_dim=64,
    ssm_head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    source="arXiv:2404.05892",
)
