"""recurrentgemma-2b [arXiv:2402.19427] — RG-LRU + local attention, 1:2.

Griffin pattern: repeating (recurrent, recurrent, local-attn); 26 layers =
8 full blocks + 2 trailing recurrent layers.
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = ("rec", "rec", "attn") * 8 + ("rec", "rec")

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=_PATTERN,
    window_size=2048,
    act="gelu",
    source="arXiv:2402.19427",
)
assert len(_PATTERN) == 26
