"""The flash wrapper's static plan and its layout work, on the CPU.

``kernels/flash_attention.py::plan`` picks, from the query length, head
width, dtype and the inputs' layout alone, the body the CUDA kernel runs,
the tiles it is instantiated with, its shared memory, the head width it is
given and whether the inputs are copied first; ``csrc/flash_attention.cu``
refuses any other tiles, so the table here is the kernel's. The pad-and-
slice path (``run_planned``) is held against the plain version with the
plain version in the kernel's place: zero columns and the unpadded D's
scale must give the plain result (f32 to 1e-6, bf16 to one rounding of
the output), and a misaligned or strided view must reach the kernel as
fresh contiguous memory.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

HALF = [torch.bfloat16, torch.float16]

# D -> (d_pad, width); then per width, q tile by Sq class: (kv_tile,
# smem bytes) for q tiles of 64 and 128 rows
WIDTHS = {16: (16, 64), 32: (32, 64), 36: (40, 64), 40: (40, 64),
          64: (64, 64), 128: (128, 128), 256: (256, 256)}
TILES = {(64, 64): (128, 74824), (64, 128): (128, 83016),
         (128, 64): (64, 83016), (128, 128): (64, 99400),
         (256, 64): (64, 164936)}


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("Sq", [1, 7, 64, 65, 129, 264, 1500])
@pytest.mark.parametrize("D", sorted(WIDTHS))
def test_plan_half(D, Sq, dtype):
    p = fa.plan(Sq, D, dtype)
    d_pad, width = WIDTHS[D]
    q_tile = 64 if Sq <= 64 or width == 256 else 128
    kv_tile, smem = TILES[(width, q_tile)]
    assert p == fa.FlashPlan("wgmma", q_tile, kv_tile, width, d_pad, smem,
                             False)
    assert p.d_pad % 8 == 0 and p.d_pad <= p.width
    assert p.smem_bytes <= fa.SMEM_LIMIT
    if q_tile == 64 and width <= 128:  # two CTAs share an SM (228 KB)
        assert 2 * (p.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("D", [16, 36, 64, 128, 256])
def test_plan_f32(D):
    p = fa.plan(100, D, torch.float32)
    assert (p.body, p.q_tile, p.kv_tile, p.d_pad, p.copy) == \
        ("fma", 32, 32, D, False)
    assert p.smem_bytes == (3 * 32 * (D + 1) + 32 * 33) * 4 <= fa.SMEM_LIMIT
    # the FMA body reads elements: only a strided view is copied
    assert not fa.plan(100, D, torch.float32, True, False).copy
    assert fa.plan(100, D, torch.float32, False, True).copy


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("contiguous,aligned", [(True, False), (False, True),
                                                (False, False)])
def test_plan_copies_what_tma_refuses(dtype, contiguous, aligned):
    p = fa.plan(129, 64, dtype, contiguous, aligned)
    assert p.copy and p.body == "wgmma"
    assert dataclasses.replace(p, copy=False) == fa.plan(129, 64, dtype)


def test_plan_refuses():
    with pytest.raises(ValueError):
        fa.plan(64, 264, torch.bfloat16)
    with pytest.raises(TypeError):
        fa.plan(64, 64, torch.int8)


def _inputs(seed, B, Sq, Skv, H, K, D, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((B, Sq, H, D), (B, Skv, K, D),
                                 (B, Skv, K, D))]


def _core(seen, **kw):
    """The plain version in the kernel's place: what the wrapper hands the
    kernel is recorded, and must be what the Hopper body takes."""
    def core(q, k, v, scale):
        for t in (q, k, v):
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
        seen.append((q.shape[-1], scale))
        return fa.attention_ref(q, k, v, scale=scale, **kw)
    return core


TOL = {torch.float32: 1e-6, torch.bfloat16: 8e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [36, 40])
@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0),
                                               (True, 16, 30.0),
                                               (False, 0, 0.0)])
def test_pad_and_slice_matches_plain(D, dtype, causal, window, cap):
    """The wrapper pads D to a multiple of 8 (36 -> 40), and the kernel's
    tiles hold 64 columns (TMA fills 40..63 with zeros): both paddings,
    with 1/sqrt(D) of the unpadded D, give the plain result."""
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v = _inputs(D, 2, 70, 70, 4, 2, D, dtype)
    want = fa.attention_ref(q, k, v, **kw)
    p = fa.plan(70, D, torch.bfloat16)
    for d_pad in (p.d_pad, p.width):
        seen = []
        got = fa.run_planned(q, k, v, dataclasses.replace(p, d_pad=d_pad),
                             _core(seen, **kw))
        assert seen == [(d_pad, 1.0 / math.sqrt(D))]
        assert got.shape == q.shape and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", HALF)
def test_misaligned_and_strided_views_are_copied(dtype):
    B, S, H, K, D = 2, 65, 4, 2, 64
    q, k, v = _inputs(3, B, S, S, H, K, D, dtype)
    q_mis = torch.empty(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    q_mis.copy_(q)
    k_str = torch.empty(B, K, S, D, dtype=dtype).transpose(1, 2)
    k_str.copy_(k)
    p = fa.plan(S, D, dtype, False, q_mis.data_ptr() % 16 == 0)
    assert p.copy and q_mis.data_ptr() % 16
    seen = []
    got = fa.run_planned(q_mis, k_str, v, p, _core(seen))
    assert seen == [(D, 1.0 / math.sqrt(D))]
    torch.testing.assert_close(got, fa.attention_ref(q, k, v), atol=0,
                               rtol=0)


def test_attention_ref_scale():
    q, k, v = _inputs(5, 1, 33, 33, 2, 1, 32, torch.float32)
    torch.testing.assert_close(fa.attention_ref(q, k, v),
                               fa.attention_ref(q, k, v,
                                                scale=1 / math.sqrt(32)))
    assert not torch.allclose(fa.attention_ref(q, k, v),
                              fa.attention_ref(q, k, v, scale=0.5))
