#!/usr/bin/env python3
"""Where serve 3 and its sharded 1 x 1 twin part, on one NVIDIA GPU.

    python3 tools/serve_twin_divergence.py [SRC]

Runs ``chip_smoke.py``'s serve 3 (``--executor local``) and its twin on
``--executor sharded --mesh 1x1`` (an NCCL world of one), both on
``chip_smoke.TickClock``, with a spy on ``kernels.ops.decode_attention``.
At every decode call it launches the kernel again on the same rows with
K and V zeroed outside the valid tokens (``clean``: nothing else may leak
into the output) and row by row (``rows``: no row may depend on another),
and keeps per-row hashes of q, of the valid K and V and of the output.
Calls are matched by index (both serves make the same calls: 6 horizons
of 8 steps x 32 layers) and rows across the executors by their q bits.
It prints one JSON line: the card, the tree, the counts of calls whose
output changed under ``clean`` or ``rows``, the rows whose inputs differ
between the executors (and the first call where one does), the rows with
equal inputs and other output bits (a fault of the kernel), and the
requests whose tokens or masks differ. ``SRC`` is a ``src`` directory
holding ``repro_torch`` (default: this checkout's), so the parent's tree
can run beside this one.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def row_hash(t) -> list:
    """A hash of each row's bits (t [B, ...], 2- or 4-byte elements)."""
    import torch
    x = t.reshape(t.shape[0], -1)
    x = x.view(torch.int16) if x.element_size() == 2 else x.view(
        torch.int32)
    w = torch.arange(x.shape[1], device=x.device, dtype=torch.int64) \
        % 9973 + 1
    return (x.long() * w).sum(1).tolist()


def spied_serve(torch, ops, dec, argv) -> tuple:
    """One serve on the tick clock with the spy: (streams, call log)."""
    from chip_smoke import TickClock
    from repro_torch.launch import serve
    kernel = ops.decode_attention
    log = []

    def spy(q, k, v, valid, **kw):
        out = kernel(q, k, v, valid, **kw)
        bodies = dict(getattr(dec, "BODY_LAUNCHES", {}))
        B = q.shape[0]
        rows = valid if valid.ndim == 2 else valid[None].expand(B, -1)
        m = rows[:, :, None, None]
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        kc = torch.where(m, k, zero).contiguous()
        vc = torch.where(m, v, zero).contiguous()
        clean = dec.decode_attention_cuda(q, kc, vc, valid, **kw)
        alone = torch.cat([dec.decode_attention_cuda(
            q[r:r + 1], k[r:r + 1], v[r:r + 1], rows[r:r + 1], **kw)
            for r in range(B)])
        if bodies:   # these launches are the spy's, not the serve's
            dec.BODY_LAUNCHES.update(bodies)
        log.append({"q": row_hash(q), "k": row_hash(kc), "v": row_hash(vc),
                    "out": row_hash(out),
                    "clean": bool(torch.equal(out, clean)),
                    "rows": bool(torch.equal(out, alone))})
        return out

    spy.launches = 0   # the kernel counts its launches under its name
    ops.decode_attention = spy
    try:
        with TickClock():
            _, rep = serve.main(argv)
    finally:
        ops.decode_attention = kernel
    streams = {r.rid: (r.tokens.tolist(), r.mask.tolist())
               for r in rep.results if r.status == "done"}
    return streams, log


def compare(a: list, b: list) -> dict:
    """Rows of each call of ``a`` matched to ``b``'s by their q bits."""
    other = same_in_other_out = 0
    first = None
    for i, (x, y) in enumerate(zip(a, b)):
        by_q = {q: j for j, q in enumerate(y["q"])}
        for r, q in enumerate(x["q"]):
            j = by_q.get(q)
            if j is None or (x["k"][r], x["v"][r]) != (y["k"][j],
                                                       y["v"][j]):
                other += 1
                first = i if first is None else first
            elif x["out"][r] != y["out"][j]:
                same_in_other_out += 1
    return {"rows_with_other_inputs": other, "first_call_with_other_inputs":
            first, "rows_with_equal_inputs_and_other_output":
            same_in_other_out}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("serve_twin_divergence: no CUDA device")
    src = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT / "src").resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    from chip_smoke import SERVE3_ARGV, SERVE3_SHARDED_ARGV, card_line
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    local, la = spied_serve(torch, ops, dec, SERVE3_ARGV)
    sharded, sa = spied_serve(torch, ops, dec, SERVE3_SHARDED_ARGV)
    print(json.dumps({
        "card": card_line(), "src": str(src), "calls": [len(la), len(sa)],
        "calls_changed_when_clean": sum(not c["clean"] for c in la + sa),
        "calls_changed_row_by_row": sum(not c["rows"] for c in la + sa),
        **compare(la, sa),
        "requests_differing": sorted(r for r in local
                                     if local[r] != sharded.get(r))}))


if __name__ == "__main__":
    main()
