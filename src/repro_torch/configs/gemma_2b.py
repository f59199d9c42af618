"""gemma-2b — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf:google/gemma-2b].

[dense] 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    source="arXiv:2403.08295; hf:google/gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=128,
    vocab_size=512, vocab_round_to=64,
    param_dtype="float32", dtype="float32",
)
