"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels are built at
first use) and skips without one; the file imports neither JAX nor the JAX
package, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in f32 (TF32 off), 2e-2 in bf16 for attention — the plain
versions round the softmax probabilities to bf16 before the P·V product,
as the JAX reference does, while the kernels keep them in f32 — and
1e-5 / 8e-3 (one bf16 rounding) for the fused GLU. The case lists are
shared with ``tests/test_torch_kernels.py``, which holds the plain
versions against the JAX kernels on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode_attention as pdec
from repro_torch.kernels import swiglu
from repro_torch.models import decoder, registry

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


FLASH_CASES = [
    # B, Sq, H, K, D, window, softcap
    (2, 64, 4, 2, 32, 0, 0.0),      # GQA
    (1, 50, 4, 1, 16, 0, 0.0),      # ragged (padding path)
    (1, 64, 4, 4, 32, 16, 0.0),     # banded / MHA
    (1, 32, 4, 2, 32, 0, 30.0),     # softcap
]


def _qkv(seed, B, Sq, H, K, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sq, K, D)).astype(np.float32),
            rng.standard_normal((B, Sq, K, D)).astype(np.float32))


PAGED_CASES = [
    # B, H, K, D, page_tokens, max_len, softcap
    (3, 4, 4, 32, 8, 40, 0.0),      # G = 1 (llama2-7b's MHA)
    (2, 8, 2, 32, 16, 48, 0.0),     # G = 4
    (2, 8, 2, 16, 8, 32, 30.0),     # G = 4 + softcap
    (1, 4, 1, 32, 16, 17, 0.0),     # G = 4, one token past a page edge
]


def _paged_inputs(seed, B, H, K, D, pt, S):
    """Random pools, a shuffled page table and ragged lengths."""
    rng = np.random.default_rng(seed)
    P = -(-S // pt)
    n_pages = B * P + 3
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    lengths[0] = S
    table = rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, pt, K, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, pt, K, D)).astype(np.float32)
    return q, kp, vp, table, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Sq,H,K,D,window,cap", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, H, K, D, window,
                                              cap, dtype, tol):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(7, B, Sq, H, K, D))
    got = fa.flash_attention_cuda(q, k, v, window=window, softcap=cap)
    want = fa.attention_ref(q, k, v, window=window, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,K,D,pt,S,cap", PAGED_CASES)
def test_paged_decode_kernel_matches_plain(cuda, B, H, K, D, pt, S, cap,
                                           dtype, tol):
    q, kp, vp, table, lengths = (torch.from_numpy(a).to(cuda) for a in
                                 _paged_inputs(9, B, H, K, D, pt, S))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = pdec.paged_decode_attention_cuda(q, kp, vp, table, lengths,
                                           softcap=cap)
    want = pdec.paged_decode_attention_ref(q, kp, vp, table, lengths,
                                           softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_fused_glu_kernel_matches_plain(cuda, activation, dtype, tol):
    h = torch.randn(37, 2 * 11008, device=cuda).to(dtype)
    torch.testing.assert_close(swiglu.fused_glu_cuda(h, activation).float(),
                               swiglu.glu_ref(h, activation).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_warm_horizon_makes_no_host_sync(cuda):
    """The counterpart of the JAX transfer-guard tests: once warm, a paged
    decode horizon on the card runs with host syncs turned into errors."""
    cfg = get_smoke_config("llama2-7b")
    params = registry.build(cfg).init(0, cuda)
    B, pt, npg = 2, 8, 4
    shape = (cfg.n_layers, B * npg + 1, pt, cfg.n_kv_heads, cfg.dh)
    pools = {k: torch.randn(shape, device=cuda) for k in ("k", "v")}
    table = torch.arange(B * npg, dtype=torch.int32,
                         device=cuda).reshape(B, npg)
    pos = torch.full((B,), 9, dtype=torch.int32, device=cuda)
    tok = torch.ones(B, 1, dtype=torch.int32, device=cuda)
    decoder.paged_decode_horizon(params, cfg, pools, table, pos, tok, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, _, _ = decoder.paged_decode_horizon(params, cfg, pools, table,
                                                  pos, tok, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert toks.shape == (B, 4)


@pytest.mark.cuda
def test_paged_decode_kernel_stops_at_table_width(cuda):
    """Lengths past the table width attend the table's tokens only, as
    the plain version's gather (and the TPU grid) does."""
    q, kp, vp, table, lengths = (torch.from_numpy(a).to(cuda) for a in
                                 _paged_inputs(5, 2, 4, 2, 32, 8, 24))
    lengths = lengths + 5
    torch.testing.assert_close(
        pdec.paged_decode_attention_cuda(q, kp, vp, table, lengths),
        pdec.paged_decode_attention_ref(q, kp, vp, table, lengths),
        atol=1e-4, rtol=1e-4)
