"""internvl2-76b [arXiv:2404.16821] — InternLM2 LM backbone; InternViT vision
encoder + projector are a stub (input_specs provides patch embeddings).
Serving reads text tokens only; `vision_proj` is initialised and carried."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision_stub",
    num_prefix_tokens=256,   # one InternViT tile after pixel-shuffle
    rope_theta=1e6,
    source="arXiv:2404.16821",
)
