"""Dispatch from the model code to the kernels.

A CUDA tensor goes to the hand-written CUDA kernel (or the call raises); a
CPU tensor goes to the kernel's plain PyTorch version. There is no fallback
from a CUDA tensor to the plain version. Each wrapper carries a plain
integer ``launches`` attribute, raised by one exactly where it launches its
kernel, so a run can show which kernels the main path went through
(:func:`launch_counts`, :func:`reset_launches`).

Gradients. The four forward kernels (flash attention, the fused GLU,
``ssd``, ``rglru``) sit in losses: training, LLMPruner's Taylor saliency.
Their CUDA wrappers write through raw pointers into fresh tensors, which
autograd cannot see. So when grad mode is on and an input requires grad,
a CUDA call goes through :class:`KernelGrad`: its forward launches the
hand-written kernel (the launch counted as always), and its backward
recomputes the kernel's plain version from the saved inputs and returns
that version's autograd gradients. The backward is the plain derivative
because the JAX package has none of its own to port: no Pallas kernel
there carries a ``custom_vjp``, and its train step and Taylor saliency
differentiate XLA code. A hand-written backward kernel is optional speed
work (ROADMAP queue 2). The three decode kernels are never in a loss; on a
CUDA input that requires grad while grad mode is on they raise rather than
cut the graph.

Analysis. Inside :func:`analysis` (the dry run asks for it: a mode, never
a fallback) every wrapper takes fake tensors only, and in place of a
launch adds its kernel's ``cost()`` to the record, one call as the card
would launch it, and returns fresh outputs of the kernel's shapes; no
plain version runs in the forward, so none of its operations or S x S
intermediates are counted, and the ``launches`` counters stay as they
are. A loss differentiated through a forward kernel goes through
:class:`KernelGrad` as on the card, so its backward is the plain
version's autograd, counted.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import swiglu as _glu


class KernelGrad(torch.autograd.Function):
    """A kernel call that autograd can differentiate: ``forward`` runs
    ``kernel(*inputs, **kw)``; ``backward`` runs ``plain(*inputs, **kw)``
    on the saved inputs under grad mode and returns its gradients.
    ``kernel`` and ``plain`` compute the same function (a tensor or a
    tuple of tensors); an output whose gradient is not needed (``ssd``'s
    final state in a forward that drops it) arrives as ``None`` and is
    left out. Generic over the pair, so a CPU test can hand it the plain
    version in the kernel's place."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, kw: dict, *inputs):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return kernel(*inputs, **kw)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*xs, **ctx.kw)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True))
        return (None, None, None) + tuple(next(got) if n else None
                                          for n in need)


_ANALYSIS: Optional[object] = None    # the record of a running analysis


@contextlib.contextmanager
def analysis(record):
    """Route every wrapper to the analysis form for the block's duration:
    ``record.kernel(name, cost)`` receives each call's
    ``kernels.ref.Cost``."""
    global _ANALYSIS
    prev, _ANALYSIS = _ANALYSIS, record
    try:
        yield record
    finally:
        _ANALYSIS = prev


def _analyze(name: str, cost: Callable, plain: Optional[Callable], inputs,
             **kw):
    """One kernel call inside :func:`analysis`: ``cost(*inputs, **kw)``
    recorded under ``name``, fresh outputs of its shapes returned (through
    :class:`KernelGrad` where a loss is differentiated through it, for the
    forward kernels, which give their ``plain`` version)."""
    from torch._subclasses.fake_tensor import FakeTensor
    for t in inputs:
        if torch.is_tensor(t) and not isinstance(t, FakeTensor):
            raise RuntimeError(
                f"kernels.ops.analysis counts fake tensors only; {name} got "
                f"a real {t.device.type} tensor {tuple(t.shape)}")
    record = _ANALYSIS

    def kernel(*xs, **kw):
        c = cost(*xs, **kw)
        record.kernel(name, c)
        outs = tuple(torch.empty(shape, dtype=dt, device=xs[0].device)
                     for shape, dt in c.outputs)
        return outs if len(outs) > 1 else outs[0]

    if plain is None:
        return kernel(*inputs, **kw)
    return _launch(kernel, plain, *inputs, **kw)


def _wants_grad(inputs) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def _launch(kernel: Callable, plain: Callable, *inputs, **kw):
    """A CUDA call of ``kernel``: through :class:`KernelGrad` where a loss
    may be differentiated through it, else as it is."""
    if _wants_grad(inputs):
        return KernelGrad.apply(kernel, plain, kw, *inputs)
    return kernel(*inputs, **kw)


def _no_grad_input(name: str, inputs) -> None:
    """Decode kernels are never differentiated: refuse, not cut the graph."""
    if _wants_grad(inputs):
        raise RuntimeError(
            f"{name} has no gradient path: it serves decode steps, which no "
            f"loss runs; call it under torch.no_grad() or on detached inputs")


def fused_glu(h, activation: str = "swiglu"):
    """h: [..., 2F] fused (gate, up) → act(gate) * up, [..., F]."""
    if _ANALYSIS is not None:
        return _analyze("fused_glu", _glu.cost, _glu.glu_ref, (h,),
                        activation=activation)
    if h.is_cuda:
        fused_glu.launches += 1
        return _launch(_glu.fused_glu_cuda, _glu.glu_ref, h,
                       activation=activation)
    return _glu.glu_ref(h, activation)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           k_scales=None, v_scales=None,
                           softcap: float = 0.0, split_rows: int = 0):
    """q: [B,1,H,D]; k/v_pages: [n_pages, pt, K, D]; page_table: int32
    [B, max_pages]; lengths: int32 [B] → [B,1,H,D]. ``k/v_scales`` (f32
    ``[n_pages, K]``, both or neither) mark int8/fp8 pages and go to
    :func:`paged_decode_attention_quant`. ``split_rows`` (0: B) is the row
    count the kernel's split-KV cut is chosen for (``ref.decode_splits``);
    the plain version has no splits."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if k_scales is not None:
        return paged_decode_attention_quant(
            q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
            softcap=softcap, split_rows=split_rows)
    if _ANALYSIS is not None:
        return _analyze("paged_decode_attention", _pdec.cost, None,
                        (q, k_pages, v_pages, page_table, lengths),
                        softcap=softcap, split_rows=split_rows)
    if q.is_cuda:
        _no_grad_input("paged_decode_attention", (q, k_pages, v_pages))
        paged_decode_attention.launches += 1
        return _pdec.paged_decode_attention_cuda(
            q, k_pages, v_pages, page_table, lengths, softcap=softcap,
            split_rows=split_rows)
    return _pdec.paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                            lengths, softcap=softcap)


def paged_decode_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 page_table, lengths, *,
                                 softcap: float = 0.0, split_rows: int = 0):
    """Fused-dequant paged decode: int8/fp8 pages with per-(page, kv head)
    f32 scales ``[n_pages, K]``; otherwise as :func:`paged_decode_attention`."""
    if _ANALYSIS is not None:
        return _analyze("paged_decode_attention_quant", _pdec.cost_quant,
                        None, (q, k_pages, v_pages, k_scales, v_scales,
                               page_table, lengths),
                        softcap=softcap, split_rows=split_rows)
    if q.is_cuda:
        _no_grad_input("paged_decode_attention_quant",
                       (q, k_pages, v_pages, k_scales, v_scales))
        paged_decode_attention_quant.launches += 1
        return _pdec.paged_decode_attention_quant_cuda(
            q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
            softcap=softcap, split_rows=split_rows)
    return _pdec.paged_decode_attention_quant_ref(
        q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
        softcap=softcap)


def decode_attention(q, k, v, valid, *, softcap: float = 0.0,
                     split_rows: int = 0, return_lse: bool = False):
    """q: [B,1,H,D]; k/v: [B,S,K,D] contiguous cache; valid: bool [S] (one
    mask for all rows) or [B,S] (one per row) → [B,1,H,D]; under
    ``return_lse`` that in f32 and the f32 log-sum-exp [B, H] beside it
    (one launch either way). ``split_rows`` as in
    :func:`paged_decode_attention`."""
    if _ANALYSIS is not None:
        return _analyze("decode_attention", _dec.cost, None, (q, k, v, valid),
                        softcap=softcap, split_rows=split_rows,
                        return_lse=return_lse)
    if q.is_cuda:
        _no_grad_input("decode_attention", (q, k, v))
        decode_attention.launches += 1
        return _dec.decode_attention_cuda(q, k, v, valid, softcap=softcap,
                                          split_rows=split_rows,
                                          return_lse=return_lse)
    return _dec.decode_attention_ref(q, k, v, valid, softcap=softcap,
                                     return_lse=return_lse)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: [B,Sq,H,D]; k/v: [B,Skv,K,D] → [B,Sq,H,D] (q.dtype)."""
    if _ANALYSIS is not None:
        return _analyze("flash_attention", _fa.cost, _fa.attention_ref,
                        (q, k, v), causal=causal, window=window,
                        softcap=softcap)
    if q.is_cuda:
        flash_attention.launches += 1
        return _launch(_fa.flash_attention_cuda, _fa.attention_ref, q, k, v,
                       causal=causal, window=window, softcap=softcap)
    return _fa.attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)


def ssd(xh, log_a, Bm, Cm, chunk: int = 256):
    """Chunked SSD scan: xh [B,T,H,P], log_a [B,T,H], Bm/Cm [B,T,N], all
    f32 and contiguous → (y [B,T,H,P], final state [B,H,P,N]), f32."""
    if _ANALYSIS is not None:
        return _analyze("ssd", _ssd.cost, _ssd.ssd_ref, (xh, log_a, Bm, Cm),
                        chunk=chunk)
    if xh.is_cuda:
        ssd.launches += 1
        return _launch(_ssd.ssd_cuda, _ssd.ssd_ref, xh, log_a, Bm, Cm,
                       chunk=chunk)
    return _ssd.ssd_ref(xh, log_a, Bm, Cm, chunk)


def rglru(a, b):
    """h_t = a_t * h_{t-1} + b_t from zero: a, b [B,T,W] f32 → h f32."""
    if _ANALYSIS is not None:
        return _analyze("rglru", _rg.cost, _rg.rglru_ref, (a, b))
    if a.is_cuda:
        rglru.launches += 1
        return _launch(_rg.rglru_cuda, _rg.rglru_ref, a, b)
    return _rg.rglru_ref(a, b)


KERNELS = (fused_glu, paged_decode_attention,
           paged_decode_attention_quant, flash_attention, decode_attention,
           ssd, rglru)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
