"""glm4-9b — RoPE, GQA [hf:THUDM/glm-4-9b].

[dense] 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    source="hf:THUDM/glm-4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
    vocab_size=512, vocab_round_to=64,
    param_dtype="float32", dtype="float32",
)
