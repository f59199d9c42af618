"""The control of ``correct``: the reference put in the program's place,
computed one precision below the configuration's (float8 e4m3 for bf16).

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 20

For each seed, in one process: serve the cell as ``bench/run.py`` does (a
window of ``--seconds``), draw the check's sample of served requests, and
read on the same prompts and served tokens (a) the program's widest gap
(``token_gap``, what ``correct`` compares) and (b) the widest gap of the
token the fp8 computation puts first (``control_gap``). A limit lies
between the program's readings and the control's. One JSON line a seed. The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402,F401  (paths and environment as a benchmark run)
import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from benchlib import check, serve, spec
    if not torch.cuda.is_available():
        print("bench/control.py: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    plan = cell.limits.get("check", {})
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = serve.serve(cell.config, cell.traffic, seed, args.seconds,
                        trace=False, device=device, t_start=t0)
        torch.cuda.empty_cache()
        sample = check.sample_requests(r, seed, int(plan.get("tokens", 256)),
                                       int(plan.get("requests", 8)))
        cfg = cell.config["model"]
        sound = check.position_gaps(r, cfg, sample, device)
        low = check.position_gaps(r, cfg, sample, device, control=True)
        a, b = np.concatenate(sound), np.concatenate(low)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "token_gap": float(a.max()),
                          "control_gap": float(b.max()),
                          "mean_gap": float(a.mean()),
                          "control_mean_gap": float(b.mean()),
                          "flipped": float((a > 0).mean()),
                          "control_flipped": float((b > 0).mean()),
                          "per_request": [[float(x.max()), float(y.max())]
                                          for x, y in zip(sound, low)],
                          "tokens": int(sum(x.tokens.shape[1]
                                            for x, _ in sample)),
                          "seconds": time.perf_counter() - t0}), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
