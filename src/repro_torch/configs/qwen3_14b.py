"""qwen3-14b — qk_norm, GQA [hf:Qwen/Qwen3-14B family].

[dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-14B",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    activation="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
    vocab_size=512, vocab_round_to=64,
    param_dtype="float32", dtype="float32",
)
