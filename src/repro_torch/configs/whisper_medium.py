"""whisper-medium — enc-dec, conv frontend STUB [arXiv:2212.04356].

[audio] 24L(dec)+24L(enc) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
The conv stem is a stub: batches carry precomputed mel-frame embeddings
(``frames [B, n_audio_frames, d_model]``); learned positional embeddings
over 1500 frames.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356; hf:openai/whisper-medium",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    activation="gelu",
    use_rope=False,
    norm="layernorm",
    is_encoder_decoder=True,
    n_encoder_layers=24,
    n_audio_frames=1500,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, vocab_round_to=64, n_audio_frames=16,
    param_dtype="float32", dtype="float32",
)
