"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060].

[ssm] 48L d_model=1024 attn-free vocab=50280, ssm_state=128, d_ff=0
(mamba2 has no separate FFN; the SSD mixer is the whole layer).
Sub-quadratic → runs the long_500k shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060; hf:state-spaces/mamba2-370m",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    use_rope=False,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    vocab_size=512, vocab_round_to=64,
    param_dtype="float32", dtype="float32",
)
