"""dbrx-132b — 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

[moe] 40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert) vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    activation="swiglu",
    n_experts=16,
    moe_top_k=4,
    rope_theta=500_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    n_experts=4, moe_top_k=2, vocab_size=512, vocab_round_to=64,
    param_dtype="float32", dtype="float32",
)
