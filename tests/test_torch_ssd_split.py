"""The CUDA ``ssd`` kernels' decomposition of the chunked scan, mirrored in
plain PyTorch, on the CPU.

The CUDA kernels split Mamba-2's chunked scan the GPU way: C·Bᵀ once per
(batch, chunk) for every head, each chunk's own state in parallel, the
state passed across chunks in order, then y per 64-row query tile over the
key tiles up to the diagonal, with the carried state's term skipped on the
first chunk. ``ref.ssd_split_ref`` mirrors that arithmetic; here it is held
against the plain version ``ssd_ref`` and against the JAX package's Pallas
kernel in interpret mode (``repro.kernels.ops.ssd``) on the same numpy
inputs from a seeded generator, at the kernels' tile and chunk edges
(``test_torch_cuda.SSD_EDGES``: T around one and two query tiles, one past
a chunk of 256, three chunks with a ragged last one, a chunk smaller than a
tile, one token) and at mamba2's widths P = 64, N = 128. The kernels
themselves are held against ``ssd_ref`` on the same edges in
``tests/test_torch_cuda.py``.

Tolerance 3e-4 (f32): the JAX suite's for two chunked sums taken in
another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref, ssd
from test_torch_cuda import SSD_EDGES, _ssd_inputs

torch.set_num_threads(1)

TOL = 3e-4
CASES = SSD_EDGES + [
    (2, 64, 2, 64, 128, 256),     # the GSI scoring shape's chunk, 2 heads
    (1, 130, 2, 64, 128, 64),     # mamba2's widths, chunks of one tile
]
IDS = [f"B{b}-T{t}-H{h}-P{p}-N{n}-chunk{q}" for b, t, h, p, n, q in CASES]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,T,H,P,N,Q", CASES, ids=IDS)
def test_split_mirror_matches_plain_and_pallas(B, T, H, P, N, Q):
    args = _ssd_inputs(B * 7 + T, B, T, H, P, N)
    y, fin = ref.ssd_split_ref(*map(torch.from_numpy, args), Q)
    assert y.shape == (B, T, H, P) and fin.shape == (B, H, P, N)
    y_ref, fin_ref = ssd.ssd_ref(*map(torch.from_numpy, args), Q)
    jy, jfin = jops.ssd(*map(jnp.asarray, args), chunk=Q)
    for got, want in ((y, y_ref), (fin, fin_ref), (y, jy), (fin, jfin)):
        _close(got, want)
