"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels are built at
first use) and skips without one; the file imports neither JAX nor the JAX
package, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in f32 (TF32 off), 2e-2 in bf16 and fp16 for attention —
the plain versions round the softmax probabilities to bf16 before the P·V
product, as the JAX reference does, while the decode kernels keep them in
f32 and the flash kernel's tensor-core body sums in another order — and
1e-5 / 8e-3 / 2e-3 (one bf16 or fp16 rounding) for the fused GLU, whose
16-byte vector path is also held bitwise against its element path. The
fused-dequant paged decode kernel (int8 and fp8 pages) is also held
bitwise against the model-dtype kernel run on ``page_dequant``-ed pages,
with f32 q, and the dense decode kernel bitwise against the paged kernel on
pages holding the same tokens in order (f32 q, prefix mask). The case lists
are shared with ``tests/test_torch_kernels.py`` and
``tests/test_torch_quant.py``, which hold the plain versions against the
JAX kernels on the CPU. The scan kernels (``ssd`` at 3e-4, ``rglru`` at
2e-5, both f32: the tolerances of ``tests/test_torch_recurrent.py``) take
that file's shapes plus mamba2's and recurrentgemma's widths; ``ssd`` also
its tile and chunk edges and ``chip_smoke.py``'s timed shapes, and two of
its launches give the same bits. Small recurrent models are held card
against CPU by ``chip_smoke.py``'s reference phase. The MoE decoders and
whisper-medium add flash without the causal mask (Skv = 1500 frames), the
GLU on a 3-D expert buffer, decode at dbrx's G = 6 and at whisper's self
and cross shapes, and their SMOKE models card against CPU. bf16 / fp16 q
runs the decode kernels' tensor-core body wherever the wrappers' plan
names it (the f32 twins above stay on the FMA body); the cases at its end
hold it at G = 8 and 16, D = 128 and 256, on every page kind, both bodies
at the narrow groups (G = 1, 5, 6, 7), its dense ≡ paged and two-launch
bits, and strided cache views read without a copy.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode_attention as pdec
from repro_torch.kernels import ref, rglru, ssd, swiglu
from repro_torch.models import attention, decoder, registry

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
    # the edges of the bf16/fp16 body's 64 x 64 tiles
    (1, 100, 4, 2, 32, 0, 0.0),     # Sq, Skv not multiples of 64
    (2, 130, 4, 4, 64, 0, 0.0),     # three kv tiles, the last ragged
    (1, 65, 4, 1, 64, 0, 0.0),      # a second q tile of one row
    (1, 130, 4, 4, 32, 16, 0.0),    # a band narrower than a tile
    (1, 100, 4, 2, 32, 300, 0.0),   # a band wider than S
    (1, 64, 8, 2, 128, 0, 0.0),     # GQA G=4 at D=128
    (1, 70, 4, 2, 40, 0, 0.0),      # D=40, zero-padded to 64
    (1, 70, 4, 2, 36, 0, 0.0),      # D % 8 != 0: padded to 40 by the wrapper
    # the Hopper body's tiles: 128 query rows (two warpgroups) past Sq = 64,
    # KV tiles of 128 keys (64 at D = 256)
    (1, 129, 4, 2, 64, 0, 0.0),     # a q tile of one row past 128
    (2, 200, 4, 4, 32, 0, 0.0),     # Sq not a multiple of 128
    (1, 129, 4, 1, 256, 0, 0.0),    # D = 256, G = 4
    (1, 100, 16, 1, 64, 0, 0.0),    # G = 16
    (1, 129, 4, 2, 16, 0, 0.0),     # D = 16 in a 64-column box
    (1, 200, 4, 2, 64, 40, 0.0),    # a band narrower than a KV tile
    (1, 129, 4, 2, 64, 0, 30.0),    # softcap on the 128-row tile
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
    # split-KV: splits are whole 64-token tiles
    (2, 4, 2, 32, 16, 130, 0.0),    # split edges on page edges
    (2, 8, 2, 32, 24, 150, 30.0),   # split edges inside pages, softcap
]

# split-KV edges with explicit lengths, and the serves' widths:
# B, H, K, D, page_tokens, lengths, softcap
SPLIT_CASES = [
    (3, 4, 2, 32, 16, (192, 1, 64), 0.0),   # a row of 1 token, a row ending
                                            # on a split edge; splits wholly
                                            # past two rows' ends
    (2, 8, 2, 32, 24, (150, 65), 30.0),     # split edges inside pages
    (2, 8, 8, 64, 16, (2560, 700), 0.0),    # B·K = 16: several tiles a
                                            # split (the two-stage ring)
    (2, 4, 2, 36, 8, (100, 37), 0.0),       # D % 8 != 0: element loader
    (1, 32, 32, 128, 16, (512,), 0.0),      # llama2-7b, B = 1
    (8, 32, 32, 128, 16, (512, 137, 300, 45, 511, 257, 64, 1), 0.0),
    (1, 16, 1, 256, 16, (264,), 0.0),       # recurrentgemma: G = 16, D = 256
    (8, 16, 1, 256, 16, (264, 200, 130, 64, 65, 1, 263, 100), 0.0),
]
SPLIT_IDS = [f"B{c[0]}-H{c[1]}-K{c[2]}-D{c[3]}-pt{c[4]}-len{max(c[5])}"
             for c in SPLIT_CASES]


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


def _split_inputs(seed, B, H, K, D, pt, lengths):
    """As :func:`_paged_inputs` with the given lengths (the table as wide
    as the longest)."""
    rng = np.random.default_rng(seed)
    P = -(-max(lengths) // pt)
    n_pages = B * P + 3
    table = rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, pt, K, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, pt, K, D)).astype(np.float32)
    return q, kp, vp, table, np.asarray(lengths, dtype=np.int32)


def _dense_of(q, kp, vp, table, lengths):
    """The same tokens as a contiguous cache with prefix masks."""
    B, P = table.shape
    pt, K, D = kp.shape[1:]
    kd = kp[table].reshape(B, P * pt, K, D)
    vd = vp[table].reshape(B, P * pt, K, D)
    valid = np.arange(P * pt)[None, :] < lengths[:, None]
    return q, kd, vd, valid


# bf16 and fp16 run the kernel's Hopper (TMA + wgmma) body, f32 its FMA body
FLASH_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2),
                (torch.float16, 2e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES)
@pytest.mark.parametrize("B,Sq,H,K,D,window,cap", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, H, K, D, window,
                                              cap, dtype, tol):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(7, B, Sq, H, K, D))
    got = fa.flash_attention_cuda(q, k, v, window=window, softcap=cap)
    want = fa.attention_ref(q, k, v, window=window, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# recurrentgemma's local attention: 16 query heads on one kv head of 256
GRIFFIN_FLASH_CASES = [
    # B, Sq, H, K, D, window, softcap
    (1, 70, 16, 1, 256, 0, 0.0),    # causal, shorter than the window
    (1, 100, 16, 1, 256, 32, 0.0),  # banded: S > window
    (1, 65, 16, 1, 256, 0, 0.0),    # a q tile straddling the diagonal
    (2, 130, 16, 1, 256, 16, 0.0),  # a band narrower than a tile
    (1, 129, 16, 1, 256, 0, 0.0),   # one row past two 64-row warpgroups
    (1, 264, 16, 1, 256, 0, 30.0),  # the serve's length, softcapped
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES)
@pytest.mark.parametrize("B,Sq,H,K,D,window,cap", GRIFFIN_FLASH_CASES)
def test_flash_attention_kernel_matches_plain_griffin(cuda, B, Sq, H, K, D,
                                                      window, cap, dtype,
                                                      tol):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(8, B, Sq, H, K, D))
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


def _quant_inputs(seed, B, H, K, D, pt, S, page_dtype, device):
    q, kp, vp, table, lengths = (torch.from_numpy(a).to(device) for a in
                                 _paged_inputs(seed, B, H, K, D, pt, S))
    kq, ks = attention.page_quant(kp, page_dtype)
    vq, vs = attention.page_quant(vp, page_dtype)
    return q, kq, vq, ks, vs, table, lengths


PAGE_DTYPES = pytest.mark.parametrize(
    "page_dtype", [torch.int8, torch.float8_e4m3fn], ids=["int8", "fp8"])


@pytest.mark.cuda
@PAGE_DTYPES
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,K,D,pt,S,cap", PAGED_CASES)
def test_paged_decode_quant_kernel_matches_plain(cuda, B, H, K, D, pt, S, cap,
                                                 dtype, tol, page_dtype):
    q, kq, vq, ks, vs, table, lengths = _quant_inputs(
        11, B, H, K, D, pt, S, page_dtype, cuda)
    q = q.to(dtype)
    got = pdec.paged_decode_attention_quant_cuda(q, kq, vq, ks, vs, table,
                                                 lengths, softcap=cap)
    want = pdec.paged_decode_attention_quant_ref(q, kq, vq, ks, vs, table,
                                                 lengths, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@PAGE_DTYPES
@pytest.mark.parametrize("B,H,K,D,pt,S,cap", PAGED_CASES)
def test_paged_decode_quant_kernel_equals_kernel_on_dequantized_pages(
        cuda, B, H, K, D, pt, S, cap, page_dtype):
    """Fused dequant runs the model-dtype kernel's f32 op sequence: with f32
    q the two kernels agree bitwise."""
    q, kq, vq, ks, vs, table, lengths = _quant_inputs(
        13, B, H, K, D, pt, S, page_dtype, cuda)
    got = pdec.paged_decode_attention_quant_cuda(q, kq, vq, ks, vs, table,
                                                 lengths, softcap=cap)
    want = pdec.paged_decode_attention_cuda(
        q, attention.page_dequant(kq, ks), attention.page_dequant(vq, vs),
        table, lengths, softcap=cap)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_int8_horizon_card_matches_cpu(cuda):
    """A 4-layer f32 model on an int8 page pool: the card (kernels) and the
    CPU (plain versions) emit the same greedy tokens, and a warmed
    quantized horizon makes no host sync."""
    cfg = get_smoke_config("llama2-7b").replace(n_layers=4)
    params = registry.build(cfg).init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32))
    B, pt, npg = 2, 8, 5
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        logits, cache = decoder.prefill(p, cfg, toks.to(dev), npg * pt)
        table = torch.arange(B * npg, dtype=torch.int32,
                             device=dev).reshape(B, npg)
        pools = {}
        for pk, sk in (("k", "ks"), ("v", "vs")):
            codes, sc = attention.page_quant(
                cache["attn"][pk].reshape(cfg.n_layers, B, npg, pt,
                                          cfg.n_kv_heads, cfg.dh).float(),
                torch.int8)
            pools[pk] = torch.zeros(cfg.n_layers, B * npg + 1, pt,
                                    cfg.n_kv_heads, cfg.dh,
                                    dtype=torch.int8, device=dev)
            pools[sk] = torch.zeros(cfg.n_layers, B * npg + 1,
                                    cfg.n_kv_heads, device=dev)
            pools[pk][:, table.long()] = codes
            pools[sk][:, table.long()] = sc
        pos = torch.full((B,), 21, dtype=torch.int32, device=dev)
        first = torch.argmax(logits, -1).to(torch.int32)[:, None]
        h, _, _ = decoder.paged_decode_horizon(p, cfg, pools, table, pos,
                                               first, 8)
        out[str(dev)] = h.cpu()
    assert torch.equal(out["cpu"], out[str(cuda)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decoder.paged_decode_horizon(p, cfg, pools, table, pos, first, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_fused_glu_kernel_matches_plain(cuda, activation, dtype, tol):
    h = torch.randn(37, 2 * 11008, device=cuda).to(dtype)
    torch.testing.assert_close(swiglu.fused_glu_cuda(h, activation).float(),
                               swiglu.glu_ref(h, activation).float(),
                               atol=tol, rtol=tol)


GLU_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 8e-3),
              (torch.float16, 2e-3)]      # one rounding to the output type


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GLU_DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("F,activation", [(11008, "swiglu"),
                                          (12288, "geglu"),
                                          (11007, "swiglu")],
                         ids=["llama", "recurrentgemma", "odd-F"])
@pytest.mark.parametrize("T", [1, 2048])
def test_fused_glu_kernel_at_the_serving_widths(cuda, T, F, activation,
                                                dtype, tol):
    """llama2-7b's and recurrentgemma-9b's widths take the 16-byte vector
    path, an odd F the element path; one row and a prefill of 8 x 256."""
    g = torch.Generator(device=cuda).manual_seed(T + F)
    h = torch.randn(T, 2 * F, generator=g, device=cuda).to(dtype)
    torch.testing.assert_close(swiglu.fused_glu_cuda(h, activation).float(),
                               swiglu.glu_ref(h, activation).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_fused_glu_vector_path_equals_element_path(cuda, activation, dtype):
    """The same arithmetic on both paths: a buffer one element off a
    16-byte boundary takes the element path and gives the vector path's
    bits."""
    T, F = 37, 11008
    g = torch.Generator(device=cuda).manual_seed(7)
    buf = torch.randn(T * 2 * F + 1, generator=g, device=cuda).to(dtype)
    shifted = buf[1:].view(T, 2 * F)                 # element path
    assert shifted.data_ptr() % 16 != 0
    aligned = shifted.clone()                        # vector path
    assert torch.equal(swiglu.fused_glu_cuda(aligned, activation),
                       swiglu.fused_glu_cuda(shifted, activation))


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


DECODE_CASES = [
    # B, H, K, D, S, softcap, mask: "rows" prefix per row [B,S], "one"
    # prefix [S], "ring" wrapped ring buffer per row
    (3, 4, 4, 32, 128, 0.0, "rows"),   # G = 1, S a multiple of the tile
    (3, 4, 4, 32, 128, 0.0, "one"),
    (2, 8, 2, 32, 100, 0.0, "rows"),   # G = 4, S not a multiple of 64
    (2, 8, 2, 16, 70, 30.0, "rows"),   # softcap
    (2, 4, 2, 32, 96, 0.0, "ring"),    # non-prefix mask
    (2, 16, 1, 256, 80, 0.0, "ring"),  # recurrentgemma: G = 16, D = 256
    # split-KV at the serves' widths: llama2-7b at B = 1 and 8,
    # recurrentgemma's ring of 264 at B = 8, and a long cache (several
    # tiles a split)
    (1, 32, 32, 128, 512, 0.0, "rows"),
    (8, 32, 32, 128, 512, 0.0, "rows"),
    (8, 16, 1, 256, 264, 0.0, "ring"),
    (2, 8, 8, 64, 2560, 0.0, "rows"),
    (2, 4, 2, 36, 100, 0.0, "rows"),   # D % 8 != 0: element loader
]


def _decode_inputs(seed, B, H, K, D, S, mask):
    """q, k, v and a mask; prefix masks come from ragged lengths (row 0
    full)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=B)
    lengths[0] = S
    kpos = np.arange(S)
    if mask == "one":
        valid = kpos < lengths[1]
    elif mask == "rows":
        valid = kpos[None, :] < lengths[:, None]
    else:
        pos = S + 7 + 11 * np.arange(B)[:, None]
        valid = np.mod(pos - kpos[None, :], S) < 40
    return q, k, v, valid, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,K,D,S,cap,mask", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, B, H, K, D, S, cap, mask, dtype,
                                     tol):
    q, k, v, valid, _ = _decode_inputs(17, B, H, K, D, S, mask)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
    valid = torch.from_numpy(valid).to(cuda)
    got = dec.decode_attention_cuda(q, k, v, valid, softcap=cap)
    want = dec.decode_attention_ref(q, k, v, valid, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,D,pt,S,cap", PAGED_CASES)
def test_decode_kernel_equals_paged_kernel(cuda, B, H, K, D, pt, S, cap):
    """The two kernels share one tile loop: with f32 q, a prefix mask and
    pages holding the same tokens in order they agree bitwise."""
    q, kp, vp, table, lengths = _paged_inputs(19, B, H, K, D, pt, S)
    P = table.shape[1]
    kd = kp[table].reshape(B, P * pt, K, D)
    vd = vp[table].reshape(B, P * pt, K, D)
    valid = np.arange(P * pt)[None, :] < lengths[:, None]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    got = dec.decode_attention_cuda(t(q), t(kd), t(vd), t(valid),
                                    softcap=cap)
    want = pdec.paged_decode_attention_cuda(t(q), t(kp), t(vp), t(table),
                                            t(lengths), softcap=cap)
    assert torch.equal(got, want)


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,K,D,pt,lengths,cap", SPLIT_CASES,
                         ids=SPLIT_IDS)
def test_split_decode_kernels_match_plain(cuda, B, H, K, D, pt, lengths, cap,
                                          dtype, tol):
    """Both kernels at the split edges and the serves' widths against
    their plain versions, and the f32 kernels against the plain mirror of
    their split-and-combine at the kernels' own split length."""
    q, kp, vp, table, lens = _on(cuda, *_split_inputs(23, B, H, K, D, pt,
                                                      lengths))
    _, kd, vd, valid = _on(cuda, *_dense_of(*_split_inputs(
        23, B, H, K, D, pt, lengths)))
    q, kp, vp, kd, vd = (t.to(dtype) for t in (q, kp, vp, kd, vd))
    got = pdec.paged_decode_attention_cuda(q, kp, vp, table, lens,
                                           softcap=cap)
    want = pdec.paged_decode_attention_ref(q, kp, vp, table, lens,
                                           softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    got_d = dec.decode_attention_cuda(q, kd, vd, valid, softcap=cap)
    want_d = dec.decode_attention_ref(q, kd, vd, valid, softcap=cap)
    torch.testing.assert_close(got_d.float(), want_d.float(), atol=tol,
                               rtol=tol)
    if dtype == torch.float32:
        split, _ = ref.decode_splits(B, K, kd.shape[1],
                                     torch.cuda.get_device_properties(
                                         cuda).multi_processor_count)
        mirror = ref.split_decode_ref(q, kd, vd, valid, split, softcap=cap)
        torch.testing.assert_close(got_d, mirror, atol=tol, rtol=tol)


@pytest.mark.cuda
@PAGE_DTYPES
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,K,D,pt,lengths,cap", SPLIT_CASES,
                         ids=SPLIT_IDS)
def test_split_quant_kernel_matches_plain(cuda, B, H, K, D, pt, lengths, cap,
                                          dtype, tol, page_dtype):
    q, kp, vp, table, lens = _on(cuda, *_split_inputs(29, B, H, K, D, pt,
                                                      lengths))
    kq, ks = attention.page_quant(kp, page_dtype)
    vq, vs = attention.page_quant(vp, page_dtype)
    q = q.to(dtype)
    got = pdec.paged_decode_attention_quant_cuda(q, kq, vq, ks, vs, table,
                                                 lens, softcap=cap)
    want = pdec.paged_decode_attention_quant_ref(q, kq, vq, ks, vs, table,
                                                 lens, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,D,pt,lengths,cap", SPLIT_CASES,
                         ids=SPLIT_IDS)
def test_split_kernels_keep_their_bitwise_twins(cuda, B, H, K, D, pt,
                                                lengths, cap):
    """Across several splits: dense ≡ paged on the same tokens (f32 q,
    prefix masks), and int8 / fp8 pages ≡ the model-dtype kernel on their
    dequantized pages."""
    arrays = _split_inputs(31, B, H, K, D, pt, lengths)
    q, kp, vp, table, lens = _on(cuda, *arrays)
    _, kd, vd, valid = _on(cuda, *_dense_of(*arrays))
    assert torch.equal(
        dec.decode_attention_cuda(q, kd, vd, valid, softcap=cap),
        pdec.paged_decode_attention_cuda(q, kp, vp, table, lens,
                                         softcap=cap))
    for page_dtype in (torch.int8, torch.float8_e4m3fn):
        kq, ks = attention.page_quant(kp, page_dtype)
        vq, vs = attention.page_quant(vp, page_dtype)
        assert torch.equal(
            pdec.paged_decode_attention_quant_cuda(q, kq, vq, ks, vs, table,
                                                   lens, softcap=cap),
            pdec.paged_decode_attention_cuda(
                q, attention.page_dequant(kq, ks),
                attention.page_dequant(vq, vs), table, lens, softcap=cap))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [5, 7], ids=["llama2-7b", "recurrentgemma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_are_deterministic(cuda, case, dtype):
    """Two launches on the same inputs give the same bits, for each body:
    the splits combine in a fixed order, with no float atomics."""
    B, H, K, D, pt, lengths, cap = SPLIT_CASES[case]
    arrays = _split_inputs(37, B, H, K, D, pt, lengths)
    q, kp, vp, table, lens = _on(cuda, *arrays)
    _, kd, vd, valid = _on(cuda, *_dense_of(*arrays))
    q, kp, vp, kd, vd = (t.to(dtype) for t in (q, kp, vp, kd, vd))
    kq, ks = attention.page_quant(kp.float(), torch.int8)
    vq, vs = attention.page_quant(vp.float(), torch.int8)
    for run in (lambda: dec.decode_attention_cuda(q, kd, vd, valid),
                lambda: pdec.paged_decode_attention_cuda(q, kp, vp, table,
                                                         lens),
                lambda: pdec.paged_decode_attention_quant_cuda(
                    q, kq, vq, ks, vs, table, lens)):
        first = run()
        assert torch.equal(first, run())


@pytest.mark.cuda
def test_decode_kernels_refuse_what_does_not_fit(cuda):
    """A group and width whose tiles overflow a block's shared memory are
    refused by the kernels (an error code, cleared); a launch after the
    refusal still runs."""
    q, k, v, valid, _ = _decode_inputs(0, 1, 64, 1, 1024, 64, "rows")
    q, k, v, valid = _on(cuda, q, k, v, valid)
    with pytest.raises(RuntimeError, match="decode_attention"):
        dec.decode_attention_cuda(q, k, v, valid)
    qp, kp, vp, table, lens = _on(cuda, *_paged_inputs(0, 1, 64, 1, 1024, 16,
                                                       64))
    with pytest.raises(RuntimeError, match="paged_decode_attention"):
        pdec.paged_decode_attention_cuda(qp, kp, vp, table, lens)
    q, k, v, valid, _ = _decode_inputs(1, 2, 8, 2, 32, 100, "rows")
    q, k, v, valid = _on(cuda, q, k, v, valid)
    torch.testing.assert_close(dec.decode_attention_cuda(q, k, v, valid),
                               dec.decode_attention_ref(q, k, v, valid),
                               atol=1e-4, rtol=1e-4)


def _slot_cache_run(p, cfg, dev, kv_dtype, toks, H):
    """Prefill 3 rows into a 32-token slot cache, move them to ragged
    positions and decode H tokens with [L, B] gates."""
    logits, cache = decoder.prefill(p, cfg, toks.to(dev), 32,
                                    kv_dtype=kv_dtype)
    cache["pos"] = torch.tensor([21, 15, 9], dtype=torch.int32, device=dev)
    gates = torch.ones(2, cfg.n_layers, 3, device=dev)
    gates[0, 1, 0] = gates[1, 2, 2] = 0.0
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks_h, cache = decoder.decode_horizon(
        p, cfg, cache, first, H, gates={"mixer": gates[0], "ffn": gates[1]})
    return logits, toks_h, cache, first, gates


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, torch.int8, torch.float8_e4m3fn],
                         ids=["model", "int8", "fp8"])
def test_slot_horizon_card_matches_cpu(cuda, kv_dtype):
    """A 4-layer f32 model on a slot cache: the card (decode kernel) and
    the CPU (plain version) emit the same greedy tokens, and a warmed
    horizon makes no host sync."""
    cfg = get_smoke_config("llama2-7b").replace(n_layers=4)
    params = registry.build(cfg).init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 21)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        logits, h, cache, first, gates = _slot_cache_run(p, cfg, dev,
                                                         kv_dtype, toks, 8)
        out[str(dev)] = (logits.cpu(), h.cpu())
    torch.testing.assert_close(out[str(cuda)][0], out["cpu"][0], atol=1e-3,
                               rtol=0)
    assert torch.equal(out["cpu"][1], out[str(cuda)][1])
    g = {"mixer": gates[0], "ffn": gates[1]}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decoder.decode_horizon(p, cfg, cache, first, 4, gates=g)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_slot_group_bucketed_horizon_makes_no_host_sync(cuda):
    """A slot group stepping 2 of 4 slots gathers, decodes and scatters
    back on the device: once warm, with host syncs turned into errors."""
    from repro_torch.runtime import LocalExecutor
    cfg = get_smoke_config("llama2-7b")
    model = registry.build(cfg)
    params = model.init(0, cuda)
    ex = LocalExecutor(model, params, max_active=4)
    group = ex.group_for(None, 32)
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    ex.prefill_into(group, [0, 2], "r0", prompt, np.ones(2 * cfg.n_layers))
    ex.decode_finish(ex.decode_launch(group, 4))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, idx = group.launch_horizon(4, ex.decode_buckets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert idx == [0, 2] and toks.shape == (2, 4)


# ----------------------------------------------------------- the scans
# the kernel's tile and chunk edges (64-row query and key tiles, chunks of
# 256): T around one and two tiles, one past a chunk, three chunks with a
# ragged last one, a chunk smaller than a tile, one token; P, N at mamba2's
# widths and below. tests/test_torch_ssd_split.py holds the plain mirror of
# the kernel's decomposition against ssd_ref and Pallas on the same edges.
SSD_EDGES = [
    # B, T, H, P, N, chunk
    (1, 63, 2, 64, 128, 256), (1, 64, 2, 64, 128, 256),
    (1, 65, 2, 64, 128, 256), (1, 129, 2, 64, 128, 256),
    (2, 257, 2, 16, 32, 256), (1, 600, 2, 16, 32, 256),
    (2, 100, 3, 32, 64, 32), (2, 1, 2, 64, 128, 256),
]
# the shapes chip_smoke.py times: GSI scoring, prefill, batch 1, three chunks
SSD_TIMED = [(16, 64, 32, 64, 128, 256), (8, 256, 32, 64, 128, 256),
             (1, 256, 32, 64, 128, 256), (2, 600, 32, 64, 128, 256)]
SSD_CASES = [
    # B, T, H, P, N, chunk
    (1, 64, 2, 16, 16, 16), (2, 100, 4, 32, 64, 32),   # ragged T
    (1, 48, 3, 16, 32, 16), (2, 300, 4, 64, 128, 256),  # mamba2's head
    (3, 64, 2, 64, 128, 256),                           # T < chunk
    (1, 50, 2, 6, 10, 16),                              # P, N % 4 != 0
] + SSD_EDGES + SSD_TIMED


def _ssd_inputs(seed, B, T, H, P, N):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    return (r(B, T, H, P, scale=0.5), -np.abs(r(B, T, H, scale=0.1)),
            r(B, T, N, scale=0.3), r(B, T, N, scale=0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,N,Q", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, B, T, H, P, N, Q):
    args = [torch.from_numpy(a).to(cuda) for a in
            _ssd_inputs(B * 10 + T, B, T, H, P, N)]
    y, fin = ssd.ssd_cuda(*args, Q)
    y_ref, fin_ref = ssd.ssd_ref(*args, Q)
    torch.testing.assert_close(y, y_ref, atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(fin, fin_ref, atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,P,N,Q", SSD_TIMED + [SSD_EDGES[-3]])
def test_ssd_kernel_is_deterministic(cuda, B, T, H, P, N, Q):
    """Two launches on the same inputs give the same bits: no atomics,
    every sum in a fixed order (the state pass included)."""
    args = [torch.from_numpy(a).to(cuda) for a in
            _ssd_inputs(B + T, B, T, H, P, N)]
    y, fin = ssd.ssd_cuda(*args, Q)
    y2, fin2 = ssd.ssd_cuda(*args, Q)
    assert torch.equal(y, y2) and torch.equal(fin, fin2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W", [(2, 64, 128), (1, 100, 64), (3, 33, 96),
                                   (2, 257, 4096)])
def test_rglru_kernel_matches_plain(cuda, B, T, W):
    rng = np.random.default_rng(B * 10 + T)
    a = np.exp(-np.abs(rng.standard_normal((B, T, W)) * 0.5))
    b = rng.standard_normal((B, T, W)) * 0.5
    a, b = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (a, b))
    torch.testing.assert_close(rglru.rglru_cuda(a, b), rglru.rglru_ref(a, b),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_scan_wrappers_refuse_bf16_and_strided(cuda):
    a = torch.ones(1, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        rglru.rglru_cuda(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rglru.rglru_cuda(a.transpose(1, 2), a.transpose(1, 2))
    # the kernel refuses a chunk over 256 and a state whose tiles overflow a
    # block's shared memory; a launch after either still runs
    args = [torch.from_numpy(x).to(cuda) for x in _ssd_inputs(0, 1, 300, 2,
                                                              16, 16)]
    with pytest.raises(RuntimeError, match="ssd"):
        ssd.ssd_cuda(*args, 300)
    big = [torch.from_numpy(x).to(cuda) for x in _ssd_inputs(0, 1, 8, 1, 64,
                                                             512)]
    with pytest.raises(RuntimeError, match="ssd"):
        ssd.ssd_cuda(*big, 8)
    y, fin = ssd.ssd_cuda(*args, 256)
    y_ref, fin_ref = ssd.ssd_ref(*args, 256)
    torch.testing.assert_close(y, y_ref, atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kv_dtype", [("paged", None), ("paged", "int8"),
                                           ("paged", "fp8"), ("local", None)])
def test_shocked_trace_equals_unshocked_on_the_card(cuda, kind, kv_dtype):
    """A 4-layer f32 model served on the card with and without a budget
    shock that preempts (pages or slot-cache rows spilled to the host and
    restored): every request's tokens are equal, and the pool drains."""
    from repro_torch.core import masks, memory
    from repro_torch.core.policy import DensePolicy
    from repro_torch.runtime import (EngineConfig, EngineRequest,
                                     LocalExecutor, PagedExecutor, RAPEngine,
                                     TickStaircase)
    cfg = get_smoke_config("llama2-7b").replace(n_layers=4)
    model = registry.build(cfg)
    params = model.init(0, cuda)
    mm = memory.build_memory_model(cfg)
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32)
    full = masks.full_mask(cfg.n_layers)
    budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 26)
    make = PagedExecutor if kind == "paged" else LocalExecutor
    reps = []
    for shock in (False, True):
        eng = RAPEngine(model, params, DensePolicy(mm), EngineConfig(
            mode="masked", max_new_tokens=6, max_active=4, max_len=32,
            budget_bytes=budget, tokens_per_page=8, kv_dtype=kv_dtype,
            decode_horizon=2),
            executor=make(model, params, max_active=4, kv_dtype=kv_dtype))
        kv = budget - eng.resident_param_bytes
        frac = (eng.resident_param_bytes + 0.2 * kv) / budget
        reps.append(eng.run(
            [EngineRequest(rid=f"r{i}", prompt=toks[:, : (16 if i % 2
                                                           else 24)])
             for i in range(8)],
            budget_trace=(TickStaircase(budget, [(3, 1.0), (10, frac),
                                                 (0, 1.0)])
                          if shock else None)))
    ref, rep = reps
    assert rep.preempted_count > 0
    want = {r.rid: r.tokens for r in ref.results}
    assert len(want) == 8 and {r.status for r in rep.results} == {"done"}
    for r in rep.results:
        assert np.array_equal(r.tokens, want[r.rid]), r.rid
    assert rep.pool["reserved_bytes"] == 0
    assert rep.pool["spilled_requests"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_rows_keep_their_bits_under_split_rows(cuda, dtype):
    """With ``split_rows`` at the slot width, a row of either decode kernel
    gives the same bits whether it is launched with 8 rows, 4 or alone
    (llama2-7b's 32 heads over 272 token slots: 3 splits for 8 rows, 5 for
    4 or 1 when the launch picks), and the dense ≡ paged twin holds."""
    g = torch.Generator().manual_seed(1)
    B, H, K, D, pt, S = 8, 32, 32, 128, 16, 272
    maxp = S // pt
    q = torch.randn(B, 1, H, D, generator=g).to(dtype).to(cuda)
    kp = torch.randn(B * maxp, pt, K, D, generator=g).to(dtype).to(cuda)
    vp = torch.randn(B * maxp, pt, K, D, generator=g).to(dtype).to(cuda)
    table = torch.arange(B * maxp, dtype=torch.int32,
                         device=cuda).reshape(B, maxp)
    lengths = torch.tensor([S - 7, 60, 130, 200, 17, 250, 99, 180],
                           dtype=torch.int32, device=cuda)
    kd = kp[table.long()].reshape(B, S, K, D)
    vd = vp[table.long()].reshape(B, S, K, D)
    valid = torch.arange(S, device=cuda)[None, :] < lengths[:, None]
    paged = lambda r: pdec.paged_decode_attention_cuda(
        q[r], kp, vp, table[r], lengths[r], split_rows=B)
    dense = lambda r: dec.decode_attention_cuda(q[r], kd[r], vd[r],
                                                valid[r], split_rows=B)
    for run in (paged, dense):
        ref = run(slice(0, B))
        for width in (4, 1):
            got = torch.cat([run(slice(i, i + width))
                             for i in range(0, B, width)])
            assert torch.equal(got, ref)
    if dtype == torch.float32:
        assert torch.equal(paged(slice(0, 4)), dense(slice(0, 4)))


def _fixed_mask_engine(model, params, kind, masks_seq, *, budget, kv_dtype,
                       bucket_quant="none"):
    """A structural engine whose policy hands out ``masks_seq`` in order
    (the last one repeating), one slot per group."""
    from repro_torch.core import memory
    from repro_torch.core.policy import Decision, PruningPolicy
    from repro_torch.runtime import (EngineConfig, LocalExecutor,
                                     PagedExecutor, RAPEngine)

    class Fixed(PruningPolicy):
        name = "fixed"

        def __init__(self, mm):
            self.mm, self.i = mm, 0

        def observe(self, state):
            m = masks_seq[min(self.i, len(masks_seq) - 1)].copy()
            self.i += 1
            peak = self.mm.peak_bytes(m, state.batch, state.total_len)
            return Decision(mask=m, steps=0, peak_bytes=peak,
                            fits=peak <= state.budget_bytes, latency_s=0.0)

    make = PagedExecutor if kind == "paged" else LocalExecutor
    return RAPEngine(model, params, Fixed(memory.build_memory_model(
        model.cfg)), EngineConfig(
        mode="structural", max_new_tokens=6, max_active=2, max_len=32,
        budget_bytes=budget, tokens_per_page=8, kv_dtype=kv_dtype,
        decode_horizon=2, bucket_quant=bucket_quant),
        executor=make(model, params, mode="structural", max_active=2,
                      kv_dtype=kv_dtype, bucket_quant=bucket_quant))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kv_dtype,quant",
                         [("paged", None, "pow2"), ("paged", "int8", "layer"),
                          ("local", None, "none"), ("local", None, "pow2")])
def test_structural_trace_card_matches_cpu(cuda, kind, kv_dtype, quant):
    """A 4-layer f32 model served in structural mode on the card and on the
    CPU: a two-row bucket, masks dropping different layers (one bucket
    signature, two gather keys) and a half-pruned layer, the tokens
    equal."""
    from repro_torch.core import masks, memory
    from repro_torch.runtime import EngineRequest
    cfg = get_smoke_config("llama2-7b").replace(n_layers=4)
    model = registry.build(cfg)
    cpu_params = model.init(0, "cpu")
    L = cfg.n_layers
    # two rows first, so a pow2 bucket stays below the pool's L layers
    two = masks.full_mask(L)
    two[[0, 2, L, L + 2]] = False
    seq = [two]
    for drop in (0, 1, 2):
        m = masks.full_mask(L)
        m[drop] = m[L + drop] = False
        seq.append(m)
    half = masks.full_mask(L)
    half[1] = False
    seq.append(half)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 26)).astype(np.int32)
    mm = memory.build_memory_model(cfg)
    full = masks.full_mask(L)
    budget = mm.param_bytes(full) + 4 * mm.state_bytes(full, 1, 32)
    out = {}
    for dev in ("cpu", cuda):
        params = _tree_to(cpu_params, dev)
        eng = _fixed_mask_engine(model, params, kind, seq, budget=budget,
                                 kv_dtype=kv_dtype, bucket_quant=quant)
        rep = eng.run([EngineRequest(rid=f"r{i}",
                                     prompt=toks[:, : 16 + 2 * i])
                       for i in range(6)])
        assert {r.status for r in rep.results} == {"done"}
        out[str(dev)] = {r.rid: (r.tokens, r.bucket) for r in rep.results}
    for rid, (t, b) in out["cpu"].items():
        assert np.array_equal(out["cuda"][rid][0], t), rid
        assert out["cuda"][rid][1] == b != ()
    assert min(len(b) for _, b in out["cpu"].values()) == 2


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama2-7b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_structural_launches_follow_the_layout(cuda, arch):
    """A retained layout launches each kernel once per row that has its
    block: flash / ssd / rglru per mixer row and the GLU per FFN row in a
    prefill; the decode kernel per attention row and the GLU per FFN row
    in a decode step (slot caches, and pages for llama)."""
    from repro_torch.core import masks
    from repro_torch.kernels import ops
    n = {"llama2-7b": 4, "mamba2-370m": 4, "recurrentgemma-9b": 6}[arch]
    cfg = get_smoke_config(arch).replace(n_layers=n)
    params = registry.build(cfg).init(0, cuda)
    m = masks.full_mask(n)
    m[1] = False
    m[n + 2] = False
    m[3] = m[n + 3] = False
    lay = masks.retained_layout(cfg, m)
    count = lambda *kinds: sum(s.mixer in kinds for s in lay)
    n_ffn = sum(s.ffn is not None for s in lay)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda)
    ops.reset_launches()
    logits, cache = decoder.prefill(params, cfg, toks, 32, layout=lay)
    got = ops.launch_counts()
    assert got["flash_attention"] == count("attn", "local_attn")
    assert got["ssd"] == count("ssd") and got["rglru"] == count("rglru")
    assert got["fused_glu"] == n_ffn
    ops.reset_launches()
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    decoder.decode_horizon(params, cfg, cache, first, 3, layout=lay)
    got = ops.launch_counts()
    assert got["decode_attention"] == 3 * count("attn", "local_attn")
    assert got["fused_glu"] == 3 * n_ffn
    assert got["paged_decode_attention"] == 0
    if arch == "llama2-7b":
        # a whole-layer (paged) bucket: pool layers [0, L') of the pages
        qm = masks.quantize_mask(cfg, m, "layer")
        play = masks.retained_layout(cfg, qm)
        L2, pt = len(play), 8
        pools = {k: torch.zeros(cfg.n_layers, 9, pt, cfg.n_kv_heads, cfg.dh,
                                device=cuda) for k in ("k", "v")}
        table = torch.arange(8, dtype=torch.int32,
                             device=cuda).reshape(2, 4)
        pos = torch.full((2,), 20, dtype=torch.int32, device=cuda)
        ops.reset_launches()
        decoder.paged_decode_horizon(params, cfg, pools, table, pos, first,
                                     3, layout=play)
        got = ops.launch_counts()
        assert got["paged_decode_attention"] == 3 * L2
        assert got["fused_glu"] == 3 * L2 and got["decode_attention"] == 0
        assert bool((pools["k"][L2:] == 0).all())


# --------------------------------------------------------------- gradients
# (kernel, label, dtype, inputs(gen), kernel call, plain call); tolerance:
# the largest |Δ| of an input's gradient relative to its largest magnitude,
# 1e-4 in f32 and 3e-2 in bf16 (the loss feeds the kernel's own output,
# which differs from the plain version's by up to a rounding, into the
# upstream gradient; the backward itself is the plain version's autograd)
GRAD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _grad_cases():
    def rnd(g, *s, dt=torch.float32, scale=1.0):
        return (torch.randn(*s, generator=g, device="cuda") * scale).to(dt)

    def flash(B, S, H, K, D, w, cap, dt):
        kw = dict(window=w, softcap=cap)
        return ("flash_attention", f"flash-B{B}-S{S}-H{H}-K{K}-D{D}-w{w}-"
                f"cap{cap}-{str(dt)[6:]}", dt,
                lambda g: (rnd(g, B, S, H, D, dt=dt), rnd(g, B, S, K, D, dt=dt),
                           rnd(g, B, S, K, D, dt=dt)),
                lambda ops, *x: ops.flash_attention(*x, **kw),
                lambda *x: fa.attention_ref(*x, **kw))

    def glu(T, F, act, dt):
        return ("fused_glu", f"glu-T{T}-F{F}-{act}-{str(dt)[6:]}", dt,
                lambda g: (rnd(g, T, 2 * F, dt=dt),),
                lambda ops, h: ops.fused_glu(h, act),
                lambda h: swiglu.glu_ref(h, act))

    def scan_in(g, B, T, H, P, N):
        return (rnd(g, B, T, H, P, scale=0.5),
                -rnd(g, B, T, H, scale=0.1).abs(), rnd(g, B, T, N, scale=0.3),
                rnd(g, B, T, N, scale=0.3))

    return [
        flash(2, 64, 4, 2, 32, 0, 0.0, torch.float32),      # GQA
        flash(1, 100, 4, 4, 64, 16, 0.0, torch.float32),    # band, ragged
        flash(1, 64, 4, 2, 32, 0, 30.0, torch.float32),     # softcap
        flash(2, 130, 8, 2, 128, 0, 0.0, torch.bfloat16),   # tensor cores
        glu(37, 11008, "swiglu", torch.bfloat16),
        glu(16, 688, "swiglu", torch.float32),
        glu(9, 12288, "geglu", torch.bfloat16),
        glu(5, 11007, "geglu", torch.float32),               # element path
        ("ssd", "ssd-B2-T40-H3-P16-N32-chunk16", torch.float32,
         lambda g: scan_in(g, 2, 40, 3, 16, 32),
         lambda ops, *x: ops.ssd(*x, 16), lambda *x: ssd.ssd_ref(*x, 16)),
        ("rglru", "rglru-B2-T33-W96", torch.float32,
         lambda g: (torch.rand(2, 33, 96, generator=g, device="cuda"),
                    rnd(g, 2, 33, 96)),
         lambda ops, a, b: ops.rglru(a, b), rglru.rglru_ref),
    ]


GRAD_CASES = _grad_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[1] for c in GRAD_CASES])
def test_kernel_gradients_match_plain_autograd(cuda, case):
    """A loss through the kernel on the card reaches every input (the
    forward launches the kernel once; the backward is the plain version's
    autograd) with the gradients of the plain version's own autograd."""
    from repro_torch.kernels import ops
    kernel, _, dt, make, call, plain = case
    g = torch.Generator(device="cuda").manual_seed(3)
    inputs = make(g)
    w = {}

    def grads(f):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = f(*xs)
        o = (out[0] if isinstance(out, tuple) else out).float()
        w.setdefault("w", torch.randn(o.shape, generator=g, device="cuda"))
        return torch.autograd.grad((w["w"] * o).sum() + 0.5 * (o * o).sum(),
                                   xs)

    before = getattr(ops, kernel).launches
    got = grads(lambda *x: call(ops, *x))
    assert getattr(ops, kernel).launches == before + 1
    want = grads(plain)
    for a, b in zip(got, want):
        assert a is not None and a.dtype == b.dtype
        assert bool(torch.isfinite(a).all())
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        assert rel <= GRAD_REL_TOL[dt], rel


@pytest.mark.cuda
def test_ssd_gradient_takes_the_final_state(cuda):
    """With the final state in the loss too, both outputs' gradients flow.
    Held relative to each gradient's largest magnitude, as above: the
    gradient of the first token's ``log_a`` is a sum of terms that cancel
    to 0 analytically, whose residue follows the upstream gradient's
    roundings."""
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(4)
    x = [torch.randn(1, 20, 2, 8, generator=g, device="cuda"),
         -torch.rand(1, 20, 2, generator=g, device="cuda") * 0.1,
         torch.randn(1, 20, 16, generator=g, device="cuda"),
         torch.randn(1, 20, 16, generator=g, device="cuda")]

    def grads(f):
        xs = [t.clone().requires_grad_(True) for t in x]
        y, st = f(*xs)
        return torch.autograd.grad(y.square().sum() + st.sum(), xs)

    for a, b in zip(grads(lambda *t: ops.ssd(*t, 8)),
                    grads(lambda *t: ssd.ssd_ref(*t, 8))):
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= GRAD_REL_TOL[torch.float32], rel


@pytest.mark.cuda
def test_decode_kernels_refuse_grad_inputs(cuda):
    from repro_torch.kernels import ops
    q = torch.randn(2, 1, 4, 32, device=cuda, requires_grad=True)
    k = torch.randn(2, 16, 4, 32, device=cuda)
    pages = torch.randn(5, 8, 4, 32, device=cuda)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([16, 9], dtype=torch.int32, device=cuda)
    scales = torch.ones(5, 4, device=cuda)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no gradient path"):
        ops.decode_attention(q, k, k, torch.ones(16, dtype=torch.bool,
                                                 device=cuda))
    with pytest.raises(RuntimeError, match="no gradient path"):
        ops.paged_decode_attention(q, pages, pages, table, lengths)
    with pytest.raises(RuntimeError, match="no gradient path"):
        ops.paged_decode_attention(q, pages.to(torch.int8),
                                   pages.to(torch.int8), table, lengths,
                                   k_scales=scales, v_scales=scales)
    assert ops.launch_counts() == before
    with torch.no_grad():                       # no graph: the kernel runs
        ops.decode_attention(q, k, k, torch.ones(16, dtype=torch.bool,
                                                 device=cuda))
    assert ops.decode_attention.launches == before["decode_attention"] + 1


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda):
    """Three remat train steps of SMOKE llama2 (f32): the card through the
    kernels, the CPU through the plain versions, from the same weights."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = get_smoke_config("llama2-7b")
    model = registry.build(cfg)
    step = steps.make_train_step(model, adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10), remat=True)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
               for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(model.init(0, "cpu"), dev)
        s = adamw.init(p)
        ops.reset_launches()
        losses = []
        for t in batches:
            b = {"tokens": torch.from_numpy(t).to(dev),
                 "labels": torch.from_numpy(t).to(dev)}
            p, s, m = step(p, s, b)
            losses.append(float(m["loss"]))
        out[dev] = (p, losses, ops.launch_counts())
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5)
    assert out["cuda"][2]["flash_attention"] == 3 * 2 * cfg.n_layers
    assert out["cuda"][2]["fused_glu"] == 3 * 2 * cfg.n_layers
    torch.testing.assert_close(out["cuda"][0]["embed"].cpu(),
                               out["cpu"][0]["embed"], rtol=1e-4, atol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ------------------------------------------- the dense decoder's new shapes
# (H, K, D) at full width: decode groups G = H / K of 8 (gemma-2b, MQA at
# D = 256), 16 (glm4-9b), 5 (qwen3-14b) and 7 (internvl2-1b, flash at
# D = 64) — G % 4 != 0 takes the decode bodies' one-head-a-block path — and
# qwen1.5-32b's full MHA over 40 kv heads (G = 1)
ARCH_CASES = {"gemma-2b": (8, 1, 256), "glm4-9b": (32, 2, 128),
              "qwen3-14b": (40, 8, 128), "qwen1.5-32b": (40, 40, 128),
              "internvl2-1b": (14, 2, 64)}
ARCH_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ARCH_DTYPES)
@pytest.mark.parametrize("arch", list(ARCH_CASES))
def test_flash_attention_kernel_at_the_new_archs(cuda, arch, dtype, tol):
    H, K, D = ARCH_CASES[arch]
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(29, 2, 130, H, K, D))
    got = fa.flash_attention_cuda(q, k, v)
    want = fa.attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ARCH_DTYPES)
@pytest.mark.parametrize("arch", list(ARCH_CASES))
def test_decode_kernels_at_the_new_archs(cuda, arch, dtype, tol):
    """The dense and the paged decode kernel against their plain versions
    (4 rows, ragged lengths up to 300 tokens in 16-token pages), and, in
    f32, bitwise against each other."""
    _decode_kernels_at(cuda, arch, dtype, tol, ARCH_CASES)


def _decode_kernels_at(cuda, arch, dtype, tol, cases):
    H, K, D = cases[arch]
    lengths = (300, 1, 137, 64)
    q, kp, vp, table, lens = _on(cuda, *_split_inputs(31, 4, H, K, D, 16,
                                                      lengths))
    _, kd, vd, valid = _on(cuda, *_dense_of(*_split_inputs(
        31, 4, H, K, D, 16, lengths)))
    qd, kp, vp, kd, vd = (t.to(dtype) for t in (q, kp, vp, kd, vd))
    got = pdec.paged_decode_attention_cuda(qd, kp, vp, table, lens)
    want = pdec.paged_decode_attention_ref(qd, kp, vp, table, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    got_d = dec.decode_attention_cuda(qd, kd, vd, valid)
    want_d = dec.decode_attention_ref(qd, kd, vd, valid)
    torch.testing.assert_close(got_d.float(), want_d.float(), atol=tol,
                               rtol=tol)
    if dtype == torch.float32:
        assert torch.equal(got_d, got)


# --------------------------------- the MoE decoders and whisper-medium
# dbrx-132b's attention: 48 query heads on 8 kv heads of 128 (G = 6, the
# one-head-a-block decode path)
ARCH_CASES_MOE = {"dbrx-132b": (48, 8, 128), "olmoe-1b-7b": (16, 16, 128)}
# whisper's unmasked attention (causal=False): the encoder over its 1500
# frames, the cross-attention of a prompt against them, and small ragged
# tiles; Skv = 1500 is not a multiple of the 64-key tile
NONCAUSAL_CASES = [
    # B, Sq, Skv, H, K, D
    (1, 1500, 1500, 16, 16, 64),
    (2, 7, 1500, 16, 16, 64),
    (2, 100, 130, 4, 2, 32),
    (1, 65, 1500, 4, 4, 64),
    (4, 32, 1500, 16, 16, 64),      # a prompt's cross-attention: one
                                    # 64-row warpgroup
    (1, 129, 1500, 16, 4, 128),     # G = 4, 128-row tiles at D = 128
    (2, 64, 1500, 8, 8, 40),        # D = 40 (TMA zero-fills 40..63)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,K,D", NONCAUSAL_CASES)
def test_flash_attention_kernel_non_causal(cuda, B, Sq, Skv, H, K, D, dtype,
                                           tol):
    rng = np.random.default_rng(B * Sq + Skv)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, D)).astype(
        np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, K, D)).astype(
        np.float32)).to(cuda, dtype) for _ in range(2))
    got = fa.flash_attention_cuda(q, k, v, causal=False)
    want = fa.attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


HALF_DTYPES = [torch.bfloat16, torch.float16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("Sq,Skv,D,window", [(200, 64, 64, 16),
                                             (100, 40, 128, 8)])
def test_flash_attention_kernel_empty_band(cuda, Sq, Skv, D, window, dtype):
    """Causal with Skv < Sq and a band: rows from Skv - 1 + window on keep
    no key and give exactly 0 (the kernel's acc / max(l, 1e-30); the plain
    version's softmax over a fully masked row is uniform, so it is held to
    the rows that keep a key)."""
    rng = np.random.default_rng(Sq + D)
    q = torch.from_numpy(rng.standard_normal((2, Sq, 4, D)).astype(
        np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((2, Skv, 2, D)).astype(
        np.float32)).to(cuda, dtype) for _ in range(2))
    got = fa.flash_attention_cuda(q, k, v, window=window)
    want = fa.attention_ref(q, k, v, window=window)
    empty = Skv - 1 + window
    torch.testing.assert_close(got[:, :empty].float(),
                               want[:, :empty].float(), atol=2e-2, rtol=2e-2)
    assert torch.count_nonzero(got[:, empty:]) == 0
    assert torch.count_nonzero(got[:, :empty].float().abs().sum(-1)) \
        == 2 * empty * 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF_DTYPES)
def test_flash_attention_kernel_views(cuda, dtype):
    """A view one element off a 16-byte boundary and a strided view are
    copied by the wrapper (``plan(...).copy``) and run the Hopper body."""
    B, S, H, K, D = 2, 129, 4, 2, 64
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(11, B, S, H, K, D))
    off = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)[1:]
    q_mis = off.view(q.shape)
    q_mis.copy_(q)
    assert q_mis.data_ptr() % 16 and fa.plan(S, D, dtype, True, False).copy
    k_str = torch.empty(B, K, S, D, dtype=dtype,
                        device=cuda).transpose(1, 2)
    k_str.copy_(k)
    assert not k_str.is_contiguous()
    before = fa.BODY_LAUNCHES["wgmma"]
    got = fa.flash_attention_cuda(q_mis, k_str, v)
    assert fa.BODY_LAUNCHES["wgmma"] == before + 1
    torch.testing.assert_close(got.float(),
                               fa.attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF_DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,window", [
    (8, 256, 256, 32, 32, 128, True, 0),     # llama2-7b's prefill
    (4, 1500, 1500, 16, 16, 64, False, 0),   # whisper's encoder
    (2, 264, 264, 16, 1, 256, True, 2048),   # recurrentgemma-9b
    (4, 64, 64, 32, 32, 128, True, 0),       # GSI scoring
])
def test_flash_attention_kernel_same_bits(cuda, B, Sq, Skv, H, K, D,
                                          causal, window, dtype):
    """Two launches on the same inputs give the same bits (no atomics, no
    split over keys), and every bf16/fp16 call runs the Hopper body."""
    rng = np.random.default_rng(Sq * H + D)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, D)).astype(
        np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, K, D)).astype(
        np.float32)).to(cuda, dtype) for _ in range(2))
    before = dict(fa.BODY_LAUNCHES)
    a = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    b = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert fa.BODY_LAUNCHES == {"wgmma": before["wgmma"] + 2,
                                "fma": before["fma"]}
    assert torch.equal(a, b)
    want = fa.attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(a.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GLU_DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("E,rows,F", [(64, 321, 1024), (16, 321, 10752),
                                      (8, 9, 64)],
                         ids=["olmoe", "dbrx", "smoke"])
def test_fused_glu_kernel_on_the_expert_buffer(cuda, E, rows, F, dtype, tol):
    """The MoE's expert buffer [E, C+1, 2F] (C = 320: 1024 scoring tokens
    at olmoe's and dbrx's k / E), a 3-D input."""
    g = torch.Generator(device=cuda).manual_seed(E + F)
    h = torch.randn(E, rows, 2 * F, generator=g, device=cuda).to(dtype)
    got = swiglu.fused_glu_cuda(h, "swiglu")
    assert got.shape == (E, rows, F)
    torch.testing.assert_close(got.float(), swiglu.glu_ref(h).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ARCH_DTYPES)
@pytest.mark.parametrize("arch", list(ARCH_CASES_MOE))
def test_decode_kernels_at_the_moe_archs(cuda, arch, dtype, tol):
    """dbrx's G = 6 and olmoe's MHA through both decode kernels, as
    :func:`test_decode_kernels_at_the_new_archs` holds the dense decoders'."""
    _decode_kernels_at(cuda, arch, dtype, tol, ARCH_CASES_MOE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", ARCH_DTYPES)
@pytest.mark.parametrize("S,mask", [(448, "rows"), (1500, "all")],
                         ids=["self", "cross"])
def test_decode_kernel_at_whisper_shapes(cuda, S, mask, dtype, tol):
    """whisper's self-attention decode (16 heads of 64, ragged rows) and
    its cross-attention decode: one query against all 1500 frames, a
    shared all-true ``valid [S]``."""
    q, k, v, valid, _ = _decode_inputs(23, 4, 16, 16, 64, S, "rows")
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
    valid = (torch.ones(S, dtype=torch.bool, device=cuda) if mask == "all"
             else torch.from_numpy(valid).to(cuda))
    got = dec.decode_attention_cuda(q, k, v, valid)
    want = dec.decode_attention_ref(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "dbrx-132b",
                                  "whisper-medium"])
def test_moe_and_whisper_smoke_card_match_cpu(cuda, arch):
    """SMOKE f32 models through the kernels on the card against the plain
    versions on the CPU: logits within 1e-3 and greedy tokens equal (MoE:
    the capacity dispatch drops the same assignments; whisper: prefill on
    frames and 4 decode steps)."""
    from repro_torch.kernels import ops
    cfg = get_smoke_config(arch)
    model = registry.build(cfg)
    params = model.init(0, "cpu")
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    b = {"tokens": toks}
    if cfg.is_encoder_decoder:
        b["frames"] = torch.randn(2, cfg.n_audio_frames, cfg.d_model,
                                  generator=g)
    out = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda))):
        bd = {k: v.to(dev) for k, v in b.items()}
        ops.reset_launches()
        logits = model.logits(p, bd)
        last, cache = model.prefill(p, bd, 32)
        tok = torch.argmax(last, -1).to(torch.int32)[:, None]
        toks_out = []
        for _ in range(4):
            step, cache = model.decode(p, cache, tok)
            tok = torch.argmax(step[:, -1], -1).to(torch.int32)[:, None]
            toks_out.append(tok)
        out[dev] = (logits.cpu(), torch.cat(toks_out, 1).cpu(),
                    ops.launch_counts())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-3,
                               rtol=1e-3)
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    launches = out["cuda"][2]
    assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0
    assert (launches["fused_glu"] > 0) == (not cfg.is_encoder_decoder)


# ------------------------------------------- the tensor-core decode body
# bf16 / fp16 q run the decode kernels' tensor-core body (TMA ring from a
# producer warp, wgmma with the 64-token tile as M) wherever the plan
# (``decode_attention.plan``) names it: here at G = 8 and 16 and D = 128
# and 256, through the dense cache, model-dtype pages and int8 / fp8 pages,
# each launch counted on its body (``decode_attention.BODY_LAUNCHES``)
TC_CASES = [
    # B, H, K, D, page_tokens, lengths
    (4, 16, 2, 128, 16, (300, 1, 137, 64)),    # G = 8 at D = 128
    (4, 8, 1, 256, 16, (300, 1, 137, 64)),     # gemma-2b: G = 8 at D = 256
    (4, 32, 2, 128, 16, (300, 1, 137, 64)),    # glm4-9b: G = 16
    (3, 16, 1, 256, 16, (264, 65, 1)),         # recurrentgemma: G = 16, 256
    (2, 16, 2, 128, 8, (129, 40)),             # pages of 8: 8 boxes a tile
    (2, 32, 2, 256, 24, (150, 64)),            # pages of 24: boxes of 8
]
TC_IDS = [f"B{c[0]}-H{c[1]}-K{c[2]}-D{c[3]}-pt{c[4]}" for c in TC_CASES]


def _tc_inputs(cuda, seed, B, H, K, D, pt, lengths, dtype):
    arrays = _split_inputs(seed, B, H, K, D, pt, lengths)
    q, kp, vp, table, lens = _on(cuda, *arrays)
    _, kd, vd, valid = _on(cuda, *_dense_of(*arrays))
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), table, lens,
            kd.to(dtype), vd.to(dtype), valid, kp, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,K,D,pt,lengths", TC_CASES, ids=TC_IDS)
def test_tensor_core_decode_body_matches_plain(cuda, B, H, K, D, pt, lengths,
                                               dtype):
    q, kp, vp, table, lens, kd, vd, valid, kp32, vp32 = _tc_inputs(
        cuda, 41, B, H, K, D, pt, lengths, dtype)
    before = dict(dec.BODY_LAUNCHES)
    for got, want in (
            (dec.decode_attention_cuda(q, kd, vd, valid),
             dec.decode_attention_ref(q, kd, vd, valid)),
            (pdec.paged_decode_attention_cuda(q, kp, vp, table, lens),
             pdec.paged_decode_attention_ref(q, kp, vp, table, lens))):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    for page_dtype in (torch.int8, torch.float8_e4m3fn):
        kq, ks = attention.page_quant(kp32, page_dtype)
        vq, vs = attention.page_quant(vp32, page_dtype)
        torch.testing.assert_close(
            pdec.paged_decode_attention_quant_cuda(q, kq, vq, ks, vs, table,
                                                   lens).float(),
            pdec.paged_decode_attention_quant_ref(q, kq, vq, ks, vs, table,
                                                  lens).float(),
            atol=2e-2, rtol=2e-2)
    assert dec.BODY_LAUNCHES["wgmma"] - before["wgmma"] == 4
    assert dec.BODY_LAUNCHES["fma"] == before["fma"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,D,pt,lengths",
                         TC_CASES + [(2, 4, 1, 128, 64, (200, 64)),
                                     (8, 32, 32, 128, 16,
                                      (512, 137, 300, 45, 511, 257, 64, 1))],
                         ids=TC_IDS + ["B2-H4-K1-D128-pt64",
                                       "B8-H32-K32-D128-pt16"])
def test_tensor_core_decode_body_keeps_its_twins(cuda, B, H, K, D, pt,
                                                 lengths):
    """On the tensor-core body (bf16 q; asked for by name through the
    private launch entries, as the plan gives G = 1 the FMA body): the
    dense kernel equals the paged kernel bitwise on pages holding the same
    tokens in order
    (one body, the same split points), pages of 64 tokens
    (``page_tokens == block_k``) among them; two launches of each kernel
    give the same bits."""
    q, kp, vp, table, lens, kd, vd, valid, kp32, vp32 = _tc_inputs(
        cuda, 43, B, H, K, D, pt, lengths, torch.bfloat16)
    before = dec.BODY_LAUNCHES["wgmma"]
    tc = {"body": "wgmma"}
    dense = dec._decode_cuda(q, kd, vd, valid, **tc)
    assert torch.equal(dense, pdec._paged_cuda(q, kp, vp, table, lens,
                                               **tc))
    kq, ks = attention.page_quant(kp32, torch.int8)
    vq, vs = attention.page_quant(vp32, torch.int8)
    fq, fs = attention.page_quant(vp32, torch.float8_e4m3fn)
    for run in (lambda: dec._decode_cuda(q, kd, vd, valid, **tc),
                lambda: pdec._paged_cuda(q, kp, vp, table, lens, **tc),
                lambda: pdec._paged_quant_cuda(
                    q, kq, vq, ks, vs, table, lens, **tc),
                lambda: pdec._paged_quant_cuda(
                    q, fq, fq, fs, fs, table, lens, **tc)):
        assert torch.equal(run(), run())
    assert dec.BODY_LAUNCHES["wgmma"] - before == 10


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["wgmma", "fma"])
@pytest.mark.parametrize("H,K,D", [(32, 32, 128), (40, 8, 128),
                                   (48, 8, 128), (14, 2, 64)],
                         ids=["G1", "G5", "G6", "G7"])
def test_both_bodies_at_narrow_groups(cuda, H, K, D, body):
    """At the groups where the plan's choice rests on the card's timings
    (G = 1, and 5 to 7), both bodies run every kernel (bf16 q, N padded to
    8 on the tensor cores) within the bf16 tolerance of the plain
    versions, each launch on the body asked for (the private launch
    entries), and dense ≡ paged holds on either."""
    q, kp, vp, table, lens, kd, vd, valid, kp32, vp32 = _tc_inputs(
        cuda, 47, 4, H, K, D, 16, (300, 1, 137, 64), torch.bfloat16)
    before = dict(dec.BODY_LAUNCHES)
    got = dec._decode_cuda(q, kd, vd, valid, body=body)
    torch.testing.assert_close(
        got.float(), dec.decode_attention_ref(q, kd, vd, valid).float(),
        atol=2e-2, rtol=2e-2)
    assert torch.equal(got, pdec._paged_cuda(q, kp, vp, table, lens,
                                             body=body))
    kq, ks = attention.page_quant(kp32, torch.int8)
    vq, vs = attention.page_quant(vp32, torch.int8)
    torch.testing.assert_close(
        pdec._paged_quant_cuda(q, kq, vq, ks, vs, table, lens,
                               body=body).float(),
        pdec.paged_decode_attention_quant_ref(q, kq, vq, ks, vs, table,
                                              lens).float(),
        atol=2e-2, rtol=2e-2)
    assert dec.BODY_LAUNCHES[body] - before[body] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_cache_views_run_without_a_copy(cuda, dtype):
    """A sequence block ``k[:, a:b]`` (the sequence-parallel step's), a
    batch slice and one kv head's view of a cache reach the kernel in
    place: no K/V copy (``decode_attention.COPIES``), one launch each on
    the plan's body, and the same bits as the call on a contiguous copy of
    the view (the same plan). A view whose rows of D are not contiguous is
    copied once."""
    g = torch.Generator().manual_seed(3)
    B, S, H, K, D = 4, 512, 16, 2, 128
    q = torch.randn(B, 1, H, D, generator=g).to(dtype).to(cuda)
    k = torch.randn(B, S, K, D, generator=g).to(dtype).to(cuda)
    v = torch.randn(B, S, K, D, generator=g).to(dtype).to(cuda)
    lens = torch.tensor([512, 300, 129, 7], device=cuda)
    valid = torch.arange(S, device=cuda)[None, :] < lens[:, None]
    body = "fma" if dtype == torch.float32 else "wgmma"
    views = {"block": (q, k[:, 128:256], v[:, 128:256], valid[:, 128:256]),
             "batch": (q[1:3], k[1:3], v[1:3], valid[1:3]),
             "head": (q[:, :, 8:], k[:, :, 1:], v[:, :, 1:], valid)}
    for name, (qq, kk, vv, m) in views.items():
        copies, before = dec.COPIES["kv"], dict(dec.BODY_LAUNCHES)
        got, lse = dec.decode_attention_cuda(qq, kk, vv, m, return_lse=True)
        assert dec.COPIES["kv"] == copies, name
        assert dec.BODY_LAUNCHES[body] - before[body] == 1, name
        want, want_lse = dec.decode_attention_cuda(
            qq.contiguous(), kk.contiguous(), vv.contiguous(),
            m.contiguous(), return_lse=True)
        assert torch.equal(got, want) and torch.equal(lse, want_lse), name
    kt = k.transpose(1, 3).contiguous().transpose(1, 3)   # D not innermost
    copies = dec.COPIES["kv"]
    got = dec.decode_attention_cuda(q, kt, v, valid)
    assert dec.COPIES["kv"] == copies + 1
    assert torch.equal(got, dec.decode_attention_cuda(q, k, v, valid))
