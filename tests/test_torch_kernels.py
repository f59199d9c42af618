"""The port's kernel functions against the JAX package's kernels.

On the CPU every ``repro_torch.kernels.ops`` wrapper runs its kernel's
plain PyTorch version; it is held here against the JAX package's Pallas
kernel run as ``tests/test_kernels.py`` runs it (``repro.kernels.ops`` in
interpret mode), on the same numpy inputs. The CUDA kernels themselves are
held against the plain versions in ``tests/test_torch_cuda.py``.

Tolerances (f32): flash attention 2e-5, paged decode 1e-5, fused GLU 1e-6
— the plain versions differ from the Pallas kernels only in summation
order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import swiglu
from test_torch_cuda import FLASH_CASES, PAGED_CASES, _paged_inputs, _qkv

torch.set_num_threads(1)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("B,Sq,H,K,D,window,cap", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(B, Sq, H, K, D, window, cap):
    q, k, v = _qkv(B * 100 + Sq, B, Sq, H, K, D)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                softcap=cap, block_q=32, block_k=32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window, softcap=cap)
    _close(got, want, 2e-5)


# -------------------------------------------------------- paged decode
@pytest.mark.parametrize("B,H,K,D,pt,S,cap", PAGED_CASES)
def test_paged_decode_plain_matches_pallas(B, H, K, D, pt, S, cap):
    args = _paged_inputs(B * 1000 + S, B, H, K, D, pt, S)
    want = jops.paged_decode_attention(*(jnp.asarray(a) for a in args),
                                       softcap=cap)
    got = ops.paged_decode_attention(*(torch.from_numpy(a) for a in args),
                                     softcap=cap)
    _close(got, want, 1e-5)


# ------------------------------------------------------------ fused GLU
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
@pytest.mark.parametrize("T,F", [(5, 40), (3, 176)])
def test_fused_glu_plain_matches_pallas(T, F, activation):
    h = np.random.default_rng(T * F).standard_normal(
        (T, 2 * F)).astype(np.float32)
    want = jops.fused_glu(jnp.asarray(h), activation)
    got = ops.fused_glu(torch.from_numpy(h), activation)
    assert got.shape == (T, F)
    _close(got, want, 1e-6)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never launches a kernel: the counters stay put."""
    before = ops.launch_counts()
    ops.fused_glu(torch.ones(2, 8))
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _paged_inputs(0, 1, 4, 4, 16, 8, 8))
    ops.paged_decode_attention(q, kp, vp, table, lengths)
    ops.flash_attention(*(torch.from_numpy(a) for a in _qkv(0, 1, 8, 4, 4, 16)))
    assert ops.launch_counts() == before


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        swiglu.fused_glu_cuda(torch.ones(2, 8))
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(*(torch.from_numpy(a)
                                  for a in _qkv(0, 1, 8, 4, 4, 16)))
