"""recurrentgemma-9b — Griffin: RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427; unverified].

[hybrid] 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.
Pattern: (rglru, rglru, local_attn) repeating; local window 2048.
Sub-quadratic → runs the long_500k shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427 (Griffin); hf:google/recurrentgemma-9b",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    activation="geglu",
    attn_window=2048,
    block_pattern=("rglru", "rglru", "local_attn"),
    rnn_width=4096,
    use_rope=True,
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
    vocab_size=512, vocab_round_to=64, attn_window=16, rnn_width=64,
    param_dtype="float32", dtype="float32",
)
