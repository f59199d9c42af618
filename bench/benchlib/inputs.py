"""Every input of a run, made from ``--seed``: the weights (on the device,
in the port's parameter layout, one draw per leaf), the controller's
calibration batch, its seeded Q-network and the prompts. The same tensors
go to the program and to the reference.

The weights are random at the published widths. Norm scales are zero under
the port's ``(1 + scale)`` convention; the LM head's columns past the
vocabulary (the padding to a multiple of ``vocab_round_to``) are zero, as
in a checkpoint, so no greedy step can pick an id outside the vocabulary.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def vocab_padded(cfg: dict) -> int:
    m = int(cfg.get("vocab_round_to", 512))
    return -(-int(cfg["vocab_size"]) // m) * m


def _normal(gen, shape, std, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def weights(cfg: dict, seed: int, device) -> Dict:
    """Random weights of ``cfg`` (a configuration's ``model`` section) in
    the port's layout: ``embed``, ``final_norm``, ``lm_head`` and one
    stack per kind (``attn``, with q/k/v biases of std 0.1 under
    ``qkv_bias``; ``dense``) with its pre-norm."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    pd = _DTYPES[cfg.get("param_dtype", "bfloat16")]
    L, D = int(cfg["n_layers"]), int(cfg["d_model"])
    H, K = int(cfg["n_heads"]), int(cfg["n_kv_heads"])
    Dh = int(cfg.get("head_dim") or D // H)
    F, V, Vp = int(cfg["d_ff"]), int(cfg["vocab_size"]), vocab_padded(cfg)
    out_scale = 1.0 / math.sqrt(2 * L)
    zeros = lambda *s: torch.zeros(*s, dtype=pd, device=device)
    head = _normal(gen, (D, Vp), 1.0 / math.sqrt(D), pd, device)
    head[:, V:] = 0
    attn = {"norm": {"scale": zeros(L, D)},
            "wq": _normal(gen, (L, D, H * Dh), 1.0 / math.sqrt(D), pd, device),
            "wk": _normal(gen, (L, D, K * Dh), 1.0 / math.sqrt(D), pd, device),
            "wv": _normal(gen, (L, D, K * Dh), 1.0 / math.sqrt(D), pd, device),
            "wo": _normal(gen, (L, H * Dh, D),
                          out_scale / math.sqrt(H * Dh), pd, device)}
    if cfg.get("qkv_bias"):
        attn.update(bq=_normal(gen, (L, H * Dh), 0.1, pd, device),
                    bk=_normal(gen, (L, K * Dh), 0.1, pd, device),
                    bv=_normal(gen, (L, K * Dh), 0.1, pd, device))
    stacks = {"attn": attn, "dense": {
        "norm": {"scale": zeros(L, D)},
        "wi": _normal(gen, (L, D, 2 * F), 1.0 / math.sqrt(D), pd, device),
        "wo": _normal(gen, (L, F, D), out_scale / math.sqrt(F), pd, device)}}
    return {"embed": _normal(gen, (Vp, D), 0.02, pd, device),
            "final_norm": {"scale": zeros(D)}, "lm_head": head,
            "stacks": stacks}


def calib_batch(cfg: dict, rows: int, seq: int, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """The controller's calibration batch: random ids, labels = tokens
    (the NLL reads the next token)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 1) % (2 ** 63))
    toks = torch.randint(0, int(cfg["vocab_size"]), (rows, seq),
                         generator=gen, device=device)
    return {"tokens": toks, "labels": toks.clone()}


def qnet(n_layers: int, seed: int, hidden: int = 32) -> Dict:
    """The controller's Q-network, seeded and untrained (no trained one is
    kept in the repository), in the port's layout: state 2L + 4, actions
    2L + 1 (STOP first), one tanh hidden layer."""
    gen = torch.Generator().manual_seed((int(seed) + 2) % (2 ** 63))
    s, a = 2 * n_layers + 4, 2 * n_layers + 1
    return {"w1": torch.randn(s, hidden, generator=gen) / math.sqrt(s),
            "b1": torch.zeros(hidden),
            "w2": torch.randn(hidden, a, generator=gen) / math.sqrt(hidden),
            "b2": torch.zeros(a)}


class Prompts:
    """Prompt ids per arrival index, drawn from the seed and the index, so
    a prompt does not depend on which others were drawn."""

    def __init__(self, vocab_size: int, seed: int):
        self.vocab = int(vocab_size)
        self.seed = int(seed)

    def __call__(self, index: int, batch: int, length: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 3, int(index)))
        return rng.integers(0, self.vocab, size=(batch, length),
                            dtype=np.int32)
