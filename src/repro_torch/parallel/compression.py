"""int8 error-feedback gradient compression for the DP all-reduce.

The port of ``repro/parallel/compression.py`` over a ``torch.distributed``
group. Each step quantizes (grad + residual) to int8 with one scale per
leaf, all-reduces the dequantized payload, divides by the group's size,
and keeps the quantization error as the next step's residual, which makes
the compression unbiased over time (SGD with error feedback converges at
the uncompressed rate). As in JAX, what is summed is ``q * scale`` in f32
(JAX's ``psum`` of the same product): the int8 codes fix the values, the
wire carries f32.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import flatten, unflatten

__all__ = ["init_residuals", "compress_allreduce", "plain_allreduce"]


def init_residuals(grads):
    """f32 zeros shaped like every gradient leaf."""
    return unflatten(grads, {k: torch.zeros_like(g, dtype=torch.float32)
                             for k, g in flatten(grads).items()})


def _quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, f32 scale): ``scale = max|x| / 127 + 1e-12``, codes
    ``clip(round(x / scale), -127, 127)`` (half to even, as ``jnp.round``).
    Both divisions are IEEE divisions by a tensor: a Python-number divisor
    makes a CUDA kernel multiply by its reciprocal, a last-bit difference
    that can move a code across a rounding boundary."""
    x = x.float()
    scale = (torch.max(torch.abs(x))
             / torch.tensor(127.0, device=x.device)) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_allreduce(grads, residuals, group=None) -> Tuple[Any, Any]:
    """EF-int8 all-reduce-mean over ``group`` (default: the world).
    Returns (mean grads f32, new residuals)."""
    n = dist.get_world_size(group)
    means, res = {}, {}
    flat_r = flatten(residuals)
    for k, g in flatten(grads).items():
        v = g.float() + flat_r[k]
        q, scale = _quantize(v)
        deq = q.float() * scale
        res[k] = v - deq                                   # error feedback
        total = deq.clone()
        dist.all_reduce(total, group=group)
        means[k] = total / n
    return unflatten(grads, means), unflatten(grads, res)


def plain_allreduce(grads, group=None):
    """f32 all-reduce-mean over ``group``."""
    n = dist.get_world_size(group)
    out = {}
    for k, g in flatten(grads).items():
        total = g.float().clone()
        dist.all_reduce(total, group=group)
        out[k] = total / n
    return unflatten(grads, out)
