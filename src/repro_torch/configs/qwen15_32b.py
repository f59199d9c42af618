"""qwen1.5-32b — QKV bias [hf:Qwen/Qwen1.5-0.5B family scaling].

[dense] 64L d_model=5120 40H (GQA kv=40 → full MHA KV) d_ff=27392 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-32B",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=160,
    vocab_size=512, vocab_round_to=64,
    param_dtype="float32", dtype="float32",
)
