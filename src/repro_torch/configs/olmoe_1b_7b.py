"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B].

[moe] 16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert) vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    activation="swiglu",
    n_experts=64,
    moe_top_k=8,
    qk_norm=True,
    rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=64,
    n_experts=8, moe_top_k=2, vocab_size=512, vocab_round_to=64,
    param_dtype="float32", dtype="float32",
)
