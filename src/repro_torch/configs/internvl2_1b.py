"""internvl2-1b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

[vlm] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The ViT frontend is a stub: batches carry precomputed patch embeddings
(``vision_embeds``) prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    activation="swiglu",
    rope_theta=1_000_000.0,
    n_vision_tokens=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, vocab_round_to=64, n_vision_tokens=8,
    param_dtype="float32", dtype="float32",
)
