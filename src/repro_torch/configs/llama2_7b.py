"""llama2-7b — the paper's own primary subject [arXiv:2307.09288].

32L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    source="arXiv:2307.09288 (paper's subject model)",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=176,
    vocab_size=512, vocab_round_to=64,
    param_dtype="float32", dtype="float32",
)
