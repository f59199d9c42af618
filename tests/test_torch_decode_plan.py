"""The decode wrappers' static plan (``kernels/decode_attention.py::plan``),
which routes every decode call on the card: the body by dtype, group and
head width, its ring stages and shared memory against an H100 block's
limit, the copy rule for strided dense caches, the refusals, and the
split-KV cut it hands both wrappers (``ref.decode_splits`` at
``split_rows``). Pure functions of shapes: no card, no kernel."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ref

torch.set_num_threads(1)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
INT8, FP8 = torch.int8, torch.float8_e4m3fn

# (G, D) of the serves' decode groups: llama2-7b / qwen1.5-32b / whisper
# (G = 1), qwen3-14b (5), dbrx (6), internvl2 (7 at D = 64), gemma-2b (8 at
# D = 256), glm4-9b (16), recurrentgemma-9b (16 at D = 256)
SERVE_GROUPS = [(1, 128), (1, 64), (5, 128), (6, 128), (7, 64), (8, 256),
                (16, 128), (16, 256)]


def _plan(dtype=BF16, page_dtype=None, G=1, D=128, pt=0, lse=False, rows=8,
          K=32, S=512, body=None, **kw):
    """The plan's plan, or (``body``) the plan of a body forced, as the
    private launch entries ask for it."""
    args = (dtype, page_dtype, G, D, pt, lse, rows, K, S, ref.H100_SMS)
    if body is None:
        return dec.plan(*args, **kw)
    return dec._body_plan(body, *args, **kw)


@pytest.mark.parametrize("G,D", SERVE_GROUPS)
@pytest.mark.parametrize("page_dtype,pt", [(None, 0), ("model", 16),
                                           (INT8, 16), (FP8, 16)],
                         ids=["dense", "paged", "int8", "fp8"])
def test_bf16_takes_the_tensor_core_body_at_the_serves_groups(G, D,
                                                             page_dtype, pt):
    pdt = BF16 if page_dtype == "model" else page_dtype
    p = _plan(BF16, pdt, G, D, pt)
    assert p.body == ("wgmma" if G >= dec.TC_MIN_GROUP else "fma")
    # the card's timings: tensor cores from G = 5, the FMA body at G = 1
    assert p.body == ("wgmma" if G >= 5 else "fma")
    if p.body == "wgmma":
        assert p.stages == min(dec.TC_STAGES, p.split_tokens // 64) >= 1
        assert p.heads == (8 if G <= 8 else 16)
        assert p.width == (64 if D <= 64 else 128 if D <= 128 else 256)
    assert p.smem_bytes <= dec.SMEM_LIMIT


@pytest.mark.parametrize("page_dtype,pt", [(None, 0), (F32, 16),
                                           (INT8, 16), (FP8, 16)])
@pytest.mark.parametrize("G,D", SERVE_GROUPS + [(4, 32), (4, 36)])
def test_f32_q_runs_the_fma_body_in_one_stage(G, D, page_dtype, pt):
    """f32 q keeps the FMA body: the quantized kernel with f32 q stays
    bitwise the kernel on dequantized pages."""
    p = _plan(F32, page_dtype, G, D, pt)
    assert (p.body, p.stages, p.heads, p.width) == ("fma", 1, G, D)
    assert not p.copy


@pytest.mark.parametrize("page_dtype,pt,G,D,why", [
    (None, 0, 4, 36, "D = 36"),         # D % 8: TMA's 16-byte rows
    (INT8, 16, 4, 40, "D = 40"),        # codes: D % 16
    (FP8, 16, 4, 40, "D = 40"),
    (None, 0, 48, 64, "G = 48"),        # more heads than n16
    (None, 0, 24, 64, "G = 24"),
    (BF16, 12, 4, 64, "page_tokens = 12"),   # boxes of >= 8 tokens
    (None, 0, 4, 320, "D = 320"),
])
def test_what_the_tensor_core_body_refuses_runs_the_fma_body(page_dtype, pt,
                                                             G, D, why):
    assert _plan(BF16, page_dtype, G, D, pt).body == "fma"
    with pytest.raises(ValueError, match=why):
        _plan(BF16, page_dtype, G, D, pt, body="wgmma")


def test_refusals():
    """A group and width whose FMA tiles overflow a block, a forced body
    the dtype has not, an unknown body, an unknown dtype and an lse asked
    of a paged kernel are refused before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        _plan(F32, None, 64, 1024, rows=1, K=1, S=64)
    with pytest.raises(ValueError, match="bf16/fp16"):
        _plan(F32, None, 8, 128, body="wgmma")
    with pytest.raises(ValueError, match="unknown decode body"):
        _plan(BF16, None, 8, 128, body="mma")
    with pytest.raises(TypeError, match="float32/bfloat16/float16"):
        _plan(torch.int32, None, 8, 128)
    with pytest.raises(ValueError, match="page pool"):
        _plan(BF16, BF16, 8, 128, pt=16, aligned=False, body="wgmma")
    for body in (None, "wgmma", "fma"):
        with pytest.raises(ValueError, match="dense decode kernel"):
            _plan(BF16, INT8, 8, 128, pt=16, lse=True, body=body)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("lse", [False, True])
def test_the_plan_names_the_output_form(dtype, lse):
    """Under ``return_lse`` the plan names an f32 output with its lse,
    which the dense wrapper allocates; the body and split do not move."""
    p, q = _plan(dtype, None, 8, 128, lse=lse), _plan(dtype, None, 8, 128)
    assert p.lse is lse and not q.lse
    assert (p.body, p.stages, p.smem_bytes, p.split_tokens, p.nsplit) == (
        q.body, q.stages, q.smem_bytes, q.split_tokens, q.nsplit)


@pytest.mark.parametrize("G,D,codes,stages,want", [
    # K and V stages, widened tiles (codes), Q, P and its remainder, the
    # warps' words, flags, scales, barriers, 1024 bytes of alignment
    (8, 128, False, 3, 3 * 2 * 64 * 128 * 2 + 8 * 128 * 2 + 2 * 8 * 128
     + 4 * 8 * 4 + 3 * 64 * 2 + 3 * 16 + 1024),
    (16, 256, True, 3, 3 * 2 * 64 * 256 + 2 * 64 * 256 * 2 + 16 * 256 * 2
     + 2 * 16 * 128 + 4 * 16 * 4 + 3 * 64 * 2 + 3 * 16 + 1024),
])
def test_tensor_core_shared_memory_mirrors_the_kernel_layout(G, D, codes,
                                                             stages, want):
    pdt = INT8 if codes else None
    p = _plan(BF16, pdt, G, D, 16 if codes else 0)
    assert p.stages == stages and p.smem_bytes == want


def test_tensor_core_shared_memory_fits_at_every_width():
    for D in (8, 64, 128, 192, 256):
        for G in (1, 8, 16):
            for pdt, pt in ((None, 0), (BF16, 16), (INT8, 16), (FP8, 64)):
                if pdt in (INT8, FP8) and D % 16:
                    continue
                p = _plan(BF16, pdt, G, D, pt, body="wgmma")
                assert p.smem_bytes <= dec.SMEM_LIMIT


@pytest.mark.parametrize("B,K,S", [(8, 32, 512), (1, 32, 512), (4, 32, 272),
                                   (8, 1, 264), (3, 2, 4096), (2, 8, 130)])
@pytest.mark.parametrize("dtype,page_dtype,pt", [
    (BF16, None, 0), (BF16, BF16, 16), (BF16, INT8, 16), (F32, None, 0),
    (F32, FP8, 16)])
def test_split_counts_follow_split_rows(B, K, S, dtype, page_dtype, pt):
    """The cut the plan hands either wrapper is ``ref.decode_splits`` of
    the slot width (``split_rows`` = 8) or the launch's rows, never of the
    lengths, whichever the body."""
    for rows in (B, 8):
        p = _plan(dtype, page_dtype, 4, 128, pt, rows=rows, K=K, S=S)
        assert (p.split_tokens, p.nsplit) == ref.decode_splits(
            rows, K, S, ref.H100_SMS)
        assert p.split_tokens % ref.DECODE_TILE == 0
        assert p.nsplit * p.split_tokens >= S
    assert dec.split_rows_of(B, 0) == B and dec.split_rows_of(B, 8) == 8


def test_split_counts_do_not_depend_on_the_body_or_lse():
    for body in ("wgmma", "fma"):
        for lse in (False, True):
            p = _plan(BF16, None, 1, 128, lse=lse, rows=1, S=4096, body=body)
            assert (p.split_tokens, p.nsplit) == ref.decode_splits(
                1, 32, 4096, ref.H100_SMS)


def _cache(seed, B=4, S=96, K=2, D=128, dtype=BF16):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, S, K, D)).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("view", ["block", "batch", "head", "whole"])
def test_cache_views_need_no_copy(view):
    """A sequence block ``k[:, a:b]`` (the sequence-parallel step's), a
    batch slice and one kv head's view are read in place by either body:
    their rows of D are contiguous and their strides 16-byte multiples."""
    k, v = _cache(1), _cache(2)
    cut = {"block": lambda t: t[:, 32:64], "batch": lambda t: t[1:3],
           "head": lambda t: t[:, :, 1:], "whole": lambda t: t}[view]
    kv, vv = cut(k), cut(v)
    contiguous, aligned = dec._kv_layout(kv, vv)
    assert contiguous and aligned
    for body in ("wgmma", "fma"):
        p = _plan(BF16, None, 8, 128, K=kv.shape[2], S=kv.shape[1],
                  contiguous=contiguous, aligned=aligned, body=body)
        assert not p.copy
    # the strides the kernel gets index the view's own elements
    sb, ss, sh = dec._strides(kv)
    flat = kv.untyped_storage()
    assert kv.storage_offset() + 1 * sb + 2 * ss + 0 * sh + 5 == (
        kv[1, 2, 0, 5:6].storage_offset())
    assert flat.data_ptr() == k.untyped_storage().data_ptr()


def test_transposed_or_mismatched_views_are_copied():
    """A view whose rows of D are not contiguous is copied by either body;
    K and V at different strides too; a misaligned one only by the
    tensor-core body, which reads 16-byte rows by TMA."""
    k = _cache(3)
    kt = k.transpose(1, 3).contiguous().transpose(1, 3)   # D not innermost
    contiguous, _ = dec._kv_layout(kt, kt)
    assert not contiguous
    for body in ("wgmma", "fma"):
        assert _plan(BF16, None, 8, 128, contiguous=False,
                     body=body).copy
    contiguous, _ = dec._kv_layout(k, _cache(4)[:, :, :, :])
    assert contiguous
    contiguous, _ = dec._kv_layout(k[:, 1:], _cache(4, S=97)[:, 1:])
    assert not contiguous                                  # strides differ
    odd = _cache(5, D=132)[..., :128]      # rows of 264 bytes: misaligned
    contiguous, aligned = dec._kv_layout(odd, odd)
    assert contiguous and not aligned
    assert _plan(BF16, None, 8, 128, contiguous=True, aligned=False).copy
    assert not _plan(BF16, None, 8, 128, contiguous=True, aligned=False,
                     body="fma").copy


def test_size_one_dims_get_strides_tma_takes():
    """A dimension of one element may carry any stride in PyTorch; the
    kernel gets the stride it would have contiguous (its one coordinate
    indexes alike), so a row or head of a cache is no copy either."""
    k = _cache(6, B=3, K=4)
    one = k[1:2, :, 2:3]
    sb, ss, sh = dec._strides(one)
    assert (sb, ss, sh) == (one.shape[1] * ss, k.stride(1), 128)
    assert all(s * 2 % 16 == 0 for s in (sb, ss, sh))
    assert dec._kv_layout(one, one) == (True, True)


def test_plan_is_cached_and_pure():
    a = _plan(BF16, None, 16, 256, rows=8, K=1, S=264)
    b = _plan(BF16, None, 16, 256, rows=8, K=1, S=264)
    split, n = ref.decode_splits(8, 1, 264, ref.H100_SMS)
    assert a is b and a == dec.DecodePlan(
        "wgmma", min(dec.TC_STAGES, split // 64), 16, 256, a.smem_bytes,
        False, False, split, n)


def test_the_forced_body_is_the_plans_where_they_agree():
    """A forced body's plan (the private entries') is the plan's own plan
    wherever the plan names that body: one layout, one split."""
    for dtype, pdt, G, D, pt in ((BF16, None, 16, 256, 0),
                                 (BF16, INT8, 8, 128, 16),
                                 (BF16, BF16, 1, 128, 16),
                                 (F32, None, 4, 64, 0)):
        p = _plan(dtype, pdt, G, D, pt)
        assert _plan(dtype, pdt, G, D, pt, body=p.body) == p


def test_plan_takes_no_body():
    """The plan alone routes: it has no input that names a body."""
    import inspect
    assert "body" not in inspect.signature(dec.plan).parameters
    from repro_torch.kernels import paged_decode_attention as pdec
    for fn in (dec.decode_attention_cuda, pdec.paged_decode_attention_cuda,
               pdec.paged_decode_attention_quant_cuda):
        assert "body" not in inspect.signature(fn).parameters
