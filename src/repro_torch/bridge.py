"""Carry weights from the JAX package into the port.

``params_from_numpy`` takes the parameter pytree that ``repro``'s
``decoder.init_params`` or ``encdec.init_params`` returns, converted leaf
by leaf with ``np.asarray``, and returns the same nested dict of torch
tensors — the port keeps the JAX layout, so no leaf is transposed or
renamed. Decoder-only: ``embed``, ``final_norm.scale``, ``lm_head``, and
per kind, stacked over that kind's layers: ``stacks.attn.{norm.scale, wq,
wk, wv, wo}`` (``bq, bk, bv``, ``q_norm, k_norm`` where the config has
them), ``stacks.dense.{norm.scale, wi, wo}``, ``stacks.moe.{norm.scale,
wi [E, D, 2F], wo [E, F, D], router [D, E]}``, ``stacks.ssd.{norm.scale,
in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_scale, out_proj}``,
``stacks.rglru.{norm.scale, wx, w_gate, conv_w, conv_b, wa, ba, wi, bi,
lam, wo}``. Encoder-decoder (whisper, layernorm: ``norm.{scale, bias}``):
``embed, enc_pos, final_norm.{scale, bias}, enc_final_norm.{scale,
bias}``, ``stacks.{enc_attn, attn, cross}.{norm, wq, wk, wv, wo}`` and
``stacks.{enc_ffn, ffn}.{norm, wi, wo}``. The MoE router stays f32 under
``dtype=``, as JAX keeps it under bf16 params.
``qnet_from_numpy`` does the same for the DQN's ``w1/b1/w2/b2``.
Only arrays cross: this module needs no import of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


# leaves kept in their own dtype whatever ``dtype=`` asks for
_KEEP_DTYPE = ("router",)


def _tree_to_torch(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device,
                                  None if k in _KEEP_DTYPE else dtype)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":       # ml_dtypes bf16 has no torch twin
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device="cuda", dtype=None) -> dict:
    """JAX model pytree (numpy leaves) → the port's parameter dict, on the
    card unless ``device="cpu"`` is passed."""
    return _tree_to_torch(tree, device, dtype)


def qnet_from_numpy(q_params) -> dict:
    """JAX DQN params {w1, b1, w2, b2} → f32 CPU tensors."""
    return _tree_to_torch(q_params, "cpu", torch.float32)
