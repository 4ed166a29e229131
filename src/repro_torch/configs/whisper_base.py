"""whisper-base [arXiv:2212.04356] — enc-dec backbone; conv/mel frontend is a
stub per the carve-out (input_specs provides precomputed frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_seq=1500,        # 30 s of audio at 50 Hz after the stub conv
    frontend="audio_stub",
    act="gelu",
    source="arXiv:2212.04356",
)
