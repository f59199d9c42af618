"""The decode kernels' split-KV arithmetic, mirrored in plain PyTorch, on
the CPU.

The CUDA decode kernels cut each row's tokens into splits of whole 64-token
tiles (``ref.decode_splits``, from static shapes only) and combine the
splits' partial softmaxes in a fixed order. ``ref.split_decode_ref`` and
``ref.split_paged_decode_ref`` mirror that arithmetic; here they are held
against the unsplit plain versions and against the JAX package's Pallas
kernels in interpret mode (``repro.kernels.ops``), on the same numpy inputs
from a seeded generator, for the dense and the paged kernels. The edges: a
split boundary on a page edge and inside a page, a row of one token, splits
wholly past a row's end, a ring mask whose valid tokens wrap, a row with no
valid token, and recurrentgemma's G=16 at D=256. The kernels themselves are
held against the same plain versions, and bitwise against each other, in
``tests/test_torch_cuda.py``.

Tolerance 2e-5 (f32): the mirror, the plain versions and the Pallas
kernels take the softmax's maxima and sums in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import paged_decode_attention as pdec
from repro_torch.kernels import ref
from repro_torch.models import attention as tatt
from test_torch_cuda import SPLIT_CASES, SPLIT_IDS, _split_inputs

torch.set_num_threads(1)

TOL = 2e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


# ------------------------------------------------------------- the split rule
@pytest.mark.parametrize("B,K,S,sms,want", [
    (8, 32, 512, 132, (192, 3)),     # llama2-7b's slot cache, B = 8
    (1, 32, 512, 132, (64, 8)),      # ... B = 1: one tile a split
    (8, 1, 264, 132, (64, 5)),       # recurrentgemma-9b's ring of 264
    (2, 8, 2560, 132, (128, 20)),    # several tiles a split
    (1, 1, 1, 132, (64, 1)),         # one token
    (64, 32, 4096, 132, (4096, 1)),  # enough rows: one split
])
def test_decode_splits_are_whole_tiles_from_shapes(B, K, S, sms, want):
    split, n = ref.decode_splits(B, K, S, sms)
    assert (split, n) == want
    assert split % ref.DECODE_TILE == 0
    assert (n - 1) * split < S <= n * split


# ------------------------------------------------------------ dense mirror
def _dense_case(seed, B, H, K, D, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32))


def _ring(S, pos, window):
    return np.mod(pos - np.arange(S), S) < min(pos + 1, window)


DENSE_EDGES = {
    # B, H, K, D, S, per-row masks, softcap
    "prefix-edges": (3, 4, 2, 32, 192, lambda S: np.stack(
        [np.arange(S) < n for n in (192, 1, 64)]), 0.0),
    "ring-wraps": (2, 8, 2, 32, 160, lambda S: np.stack(
        [_ring(S, 230, 100), _ring(S, 190, 90)]), 30.0),
    "empty-row": (2, 4, 4, 16, 130, lambda S: np.stack(
        [np.arange(S) < 130, np.zeros(S, bool)]), 0.0),
    "griffin-G16-D256": (1, 16, 1, 256, 264, lambda S: _ring(S, 300, 200)[None],
                         0.0),
}


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("case", list(DENSE_EDGES))
def test_dense_split_mirror_matches_plain_and_pallas(case, split):
    B, H, K, D, S, mask, cap = DENSE_EDGES[case]
    q, k, v = _dense_case(len(case), B, H, K, D, S)
    valid = mask(S)
    if case == "ring-wraps":
        # both ends valid, a gap between: the valid tokens wrap
        assert valid[:, 0].all() and valid[:, -1].all()
        assert not valid.all(axis=1).any()
    got = ref.split_decode_ref(*(torch.from_numpy(a) for a in
                                 (q, k, v, valid)), split, softcap=cap)
    for b in range(B):
        want = jops.decode_attention(jnp.asarray(q[b:b + 1]),
                                     jnp.asarray(k[b:b + 1]),
                                     jnp.asarray(v[b:b + 1]),
                                     jnp.asarray(valid[b]), softcap=cap,
                                     block_k=64)
        _close(got[b:b + 1], want)
    plain = dec.decode_attention_ref(*(torch.from_numpy(a) for a in
                                       (q, k, v, valid)), softcap=cap)
    rows = valid.any(axis=1)          # a row with no valid token gives 0
    _close(got[rows], plain[rows])
    assert not got[~rows].any()


# ------------------------------------------------------------ paged mirror
# the small edges of the kernels' split cases (the serves' widths and the
# 2560-token cache are the card's: Pallas interpret mode walks every page)
PAGED_EDGES = [0, 1, 3, 6]


@pytest.mark.parametrize("split", [64, 128, 192])
@pytest.mark.parametrize("i", PAGED_EDGES,
                         ids=[SPLIT_IDS[i] for i in PAGED_EDGES])
def test_paged_split_mirror_matches_plain_and_pallas(i, split):
    B, H, K, D, pt, lengths, cap = SPLIT_CASES[i]
    args = _split_inputs(41 + i, B, H, K, D, pt, lengths)
    want = jops.paged_decode_attention(*(jnp.asarray(a) for a in args),
                                       softcap=cap)
    t = [torch.from_numpy(a) for a in args]
    got = ref.split_paged_decode_ref(*t, split, softcap=cap)
    _close(got, want)
    _close(got, pdec.paged_decode_attention_ref(*t, softcap=cap))


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("i", [0, 1], ids=[SPLIT_IDS[i] for i in (0, 1)])
def test_quant_split_mirror_matches_pallas(i, name):
    """int8 / fp8 pages: the mirror widens each code as code · scale, as
    the fused-dequant kernel and the Pallas ``_kernel_quant`` do."""
    jdt, tdt = {"int8": (jnp.int8, torch.int8),
                "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}[name]
    B, H, K, D, pt, lengths, cap = SPLIT_CASES[i]
    q, kp, vp, table, lens = _split_inputs(43 + i, B, H, K, D, pt, lengths)
    kq, ks = tatt.page_quant(torch.from_numpy(kp), tdt)
    vq, vs = tatt.page_quant(torch.from_numpy(vp), tdt)
    raw = lambda c: jnp.asarray(c.view(torch.uint8).numpy()).view(jdt)
    want = jops.paged_decode_attention(
        jnp.asarray(q), raw(kq), raw(vq), jnp.asarray(table),
        jnp.asarray(lens), k_scales=jnp.asarray(ks.numpy()),
        v_scales=jnp.asarray(vs.numpy()), softcap=cap)
    got = ref.split_paged_decode_ref(
        torch.from_numpy(q), kq, vq, torch.from_numpy(table),
        torch.from_numpy(lens), 64, k_scales=ks, v_scales=vs, softcap=cap)
    _close(got, want)
    # the JAX pages are the port's codes, bit for bit
    np.testing.assert_array_equal(
        np.asarray(jatt.page_dequant(raw(kq), jnp.asarray(ks.numpy()))),
        tatt.page_dequant(kq, ks).numpy())
