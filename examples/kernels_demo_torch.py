"""Kernel walkthrough on the PyTorch port: run each of the port's seven
Hopper kernels against its plain PyTorch version and print the max
deviation and how the kernel is laid out.

  PYTHONPATH=src python examples/kernels_demo_torch.py               # GPU
  PYTHONPATH=src python examples/kernels_demo_torch.py --device cpu

The twin of ``examples/kernels_demo.py`` (the Pallas kernels in interpret
mode). On the GPU each call goes through ``repro_torch.kernels.ops``,
which builds the CUDA kernels with ``nvcc`` at first use and launches
them; the plain version runs on the same CUDA tensors. On the CPU ``ops``
dispatches to the plain versions themselves, so every deviation is 0.
"""
import argparse
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pdec
from repro_torch.kernels import rglru, ssd, swiglu
from repro_torch.launch import resolve_device
from repro_torch.models import attention


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Print each kernel's max |Δ| against its plain version; returns
    them by name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=0.5):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    where = ("the CUDA kernel" if device.type == "cuda"
             else "the plain version (CPU)")
    print(f"each kernel through ops ({where}) against its plain version "
          f"on {device}:")
    out: Dict[str, float] = {}

    def show(name, got, want, layout):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        d = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want))
        out[name] = d
        print(f"  {name:30s} max|Δ| = {d:.2e}   {layout}")

    q, k, v = r(2, 256, 8, 64), r(2, 256, 2, 64), r(2, 256, 2, 64)
    show("flash_attention", ops.flash_attention(q, k, v),
         fa.attention_ref(q, k, v),
         "64-row q tiles per CTA, KV streamed in 64-key tiles, online "
         "softmax")

    q1 = r(2, 1, 8, 64)
    kc, vc = r(2, 1024, 2, 64), r(2, 1024, 2, 64)
    valid = torch.arange(1024, device=device) < 700
    show("decode_attention", ops.decode_attention(q1, kc, vc, valid),
         dec.decode_attention_ref(q1, kc, vc, valid),
         "split-KV over 64-token tiles, GQA group per CTA, ordered combine")

    # the same tokens in 16-token pages, rows' pages shuffled in the pool
    pt, n_pages = 16, 2 * 1024 // 16
    perm = torch.randperm(n_pages, generator=g).to(device)
    kp = torch.empty(n_pages, pt, 2, 64, device=device)
    vp = torch.empty_like(kp)
    kp[perm] = kc.reshape(n_pages, pt, 2, 64)
    vp[perm] = vc.reshape(n_pages, pt, 2, 64)
    table = perm.reshape(2, -1).to(torch.int32)
    lengths = torch.tensor([700, 1024], dtype=torch.int32, device=device)
    show("paged_decode_attention",
         ops.paged_decode_attention(q1, kp, vp, table, lengths),
         pdec.paged_decode_attention_ref(q1, kp, vp, table, lengths),
         "the dense body with a page-table indirection in the loader")
    kq, ks = attention.page_quant(kp, torch.int8)
    vq, vs = attention.page_quant(vp, torch.int8)
    show("paged_decode_attention_quant",
         ops.paged_decode_attention(q1, kq, vq, table, lengths,
                                    k_scales=ks, v_scales=vs),
         pdec.paged_decode_attention_quant_ref(q1, kq, vq, ks, vs, table,
                                               lengths),
         "int8 pages, code x (page, head) scale in the loader")

    h = r(512, 2 * 1024)
    show("fused_glu", ops.fused_glu(h, "swiglu"), swiglu.glu_ref(h, "swiglu"),
         "16-byte vectors of gate and up, silu(gate) * up")

    xh, la = r(1, 512, 4, 32), -r(1, 512, 4).abs() * 0.2
    Bm, Cm = r(1, 512, 64, scale=0.3), r(1, 512, 64, scale=0.3)
    show("ssd", ops.ssd(xh, la, Bm, Cm, 128), ssd.ssd_ref(xh, la, Bm, Cm, 128),
         "chunk, pass and out kernels; 3xTF32 mma.sync products")

    a = torch.exp(-r(2, 512, 256).abs())
    b = r(2, 512, 256)
    show("rglru", ops.rglru(a, b), rglru.rglru_ref(a, b),
         "one thread per channel, the scan over T in registers")
    print(f"launches: {ops.launch_counts()}")
    return out


if __name__ == "__main__":
    main()
