#!/usr/bin/env python3
"""Compare the dense and paged decode kernels of two source trees bit for
bit, on one NVIDIA GPU.

    python3 tools/decode_bits.py SRC OUT.pt     # one tree's outputs
    python3 tools/decode_bits.py --compare A.pt B.pt

``SRC`` is a ``src`` directory holding ``repro_torch``; its kernels are
built from that tree's ``csrc``. Each tree runs in a process of its own
(one kernel library a process) on the same seeded inputs: llama2-7b's
decode shapes (B = 8 against a full 4096-token cache and a 512 one with
ragged lengths), recurrentgemma-9b's (16 query heads on one kv head of
256), a GQA and a softcap-free small case, in f32 and bf16, through
``decode_attention_cuda`` and ``paged_decode_attention_cuda`` (pages of
16). ``--compare`` prints how many outputs are equal and exits 1 on any
difference.
"""
from __future__ import annotations

import subprocess
import sys

CASES = [(8, 32, 32, 128, 4096, 4096), (8, 32, 32, 128, 512, 300),
         (8, 16, 1, 256, 256, 200), (1, 32, 8, 128, 64, 40),
         (3, 8, 2, 64, 96, 70)]       # B, H, K, D, S, longest length


def outputs(src: str) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as pdec
    g = torch.Generator(device="cpu").manual_seed(7)
    out = {}
    for B, H, K, D, S, n in CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, 1, H, D, generator=g).cuda().to(dt)
            k = torch.randn(B, S, K, D, generator=g).cuda().to(dt)
            v = torch.randn(B, S, K, D, generator=g).cuda().to(dt)
            valid = torch.arange(S, device="cuda")[None] < torch.randint(
                1, n + 1, (B, 1), generator=g).cuda()
            tag = f"{B} {H} {K} {D} {S} {dt}"
            out[f"dense {tag}"] = dec.decode_attention_cuda(q, k, v, valid)
            pages = S // 16
            table = torch.arange(B * pages, device="cuda",
                                 dtype=torch.int32).reshape(B, pages)
            out[f"paged {tag}"] = pdec.paged_decode_attention_cuda(
                q, k.reshape(B * pages, 16, K, D),
                v.reshape(B * pages, 16, K, D), table,
                valid.sum(-1).to(torch.int32))
    return {k: t.cpu() for k, t in out.items()}


def main() -> None:
    import torch
    if sys.argv[1] == "--compare":
        a, b = torch.load(sys.argv[2]), torch.load(sys.argv[3])
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        print(f"compared {len(a)} outputs: {len(a) - len(bad)} bitwise "
              f"equal; differing: {bad}")
        sys.exit(1 if bad else 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    torch.save(outputs(sys.argv[1]), sys.argv[2])
    print(f"saved {2 * 2 * len(CASES)} outputs of {sys.argv[1]} [{card}]")


if __name__ == "__main__":
    main()
