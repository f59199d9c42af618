"""Diagonal linear recurrence of the RG-LRU (Griffin) mixer.

``rglru_ref`` is the plain PyTorch version (any device): the sequential
loop ``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0`` — what the model
runs on the CPU, the counterpart of ``repro/models/rglru.py::blocked_scan``
and ``repro/kernels/ref.py::rglru_ref``. ``rglru_cuda`` launches the CUDA
kernel ``csrc/rglru.cu``, the port of the Pallas kernel
``repro/kernels/rglru.py::rglru``. a, b: ``[B, T, W]`` f32 → h f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import Cost


def rglru_ref(a, b):
    """The steps' states are stacked once at the end: writing each into a
    preallocated output would make autograd copy the whole output's
    gradient once per step in the backward (quadratic in T)."""
    h = torch.zeros_like(a[:, 0], dtype=torch.float32)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        hs.append(h)
    return torch.stack(hs, dim=1)


def cost(a, b) -> Cost:
    """a and b read, h written (f32); a multiply and an add per element."""
    return Cost(flops=2.0 * a.numel(), bytes=float(3 * 4 * a.numel()),
                outputs=((tuple(a.shape), torch.float32),),
                op_dtype=torch.float32)


def rglru_cuda(a, b):
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("rglru_cuda takes CUDA tensors")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_cuda takes float32 tensors, got {a.dtype}/"
                        f"{b.dtype}")
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"bad shapes a {tuple(a.shape)} b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_cuda takes contiguous tensors")
    B, T, W = a.shape
    h = torch.empty_like(a)
    fn = build.function("rap_rglru", [build.P] * 3 + [build.I] * 3
                        + [build.P])
    build.check(fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, T, W,
                   build.stream(a)), "rglru")
    return h
