"""Carry weights from the JAX package into the port.

``params_from_numpy`` takes the parameter pytree that ``repro``'s
``decoder.init_params`` returns, converted leaf by leaf with
``np.asarray`` (``embed``, ``final_norm.scale``, ``lm_head``,
``stacks.attn.{norm.scale,wq,wk,wv,wo}``, ``stacks.dense.{norm.scale,wi,wo}``,
stacked over layers), and returns the same nested dict of torch tensors —
the port keeps the JAX layout, so no leaf is transposed or renamed.
``qnet_from_numpy`` does the same for the DQN's ``w1/b1/w2/b2``.
Only arrays cross: this module needs no import of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def _tree_to_torch(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
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
