"""What decides ``correct``: the program's outputs on the timed path,
compared with the plain reference once the window has closed.

* ``token_gap``: a sample of the served requests, drawn from the seed and
  holding the one served the most tokens. The reference runs each prompt
  with its served tokens (one row of the request, under the request's
  keep-mask) and reads, at every served position, how far the served
  token's logit lies below its best. The widest gap is compared. It is
  ``inf`` for a token outside the vocabulary.
* ``decision_faults``: every policy decision in the window against paper
  Eq. (3)–(4) and Algorithm 3's stopping rule, worked out again: the
  peak of its mask, whether it fits the budget the decision was made
  under, that the controller removed blocks only while the peak exceeded
  it, and one block per step.
* ``choice_faults``: every fresh decision in the window replayed step by
  step from the importance the program computed at each step: the block
  it removed has to be the Q-network's best valid action there.
* ``pool_overcommits`` / ``pool_over_capacity_bytes``: the pool's ledger.

Each number has its limit in ``bench/cells/<cell>.json``; a number whose
limit is absent is reported and not judged.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchlib import inputs
from reference import controller as ref_ctl
from reference import model as ref_model


def sample_requests(run, seed: int, token_budget: int,
                    max_requests: int) -> List[Tuple]:
    """(result, row) pairs: the request served the most tokens, then
    others drawn from the seed, until ``token_budget`` served tokens."""
    done = [r for r in run.results
            if r.tokens is not None and r.tokens.shape[1] >= 2]
    if not done:
        return []
    rng = np.random.default_rng((int(seed), 7))
    longest = max(done, key=lambda r: r.tokens.shape[1])
    rest = [r for r in done if r is not longest]
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    out, total = [], 0
    for r in order:
        if len(out) >= max_requests or total >= token_budget:
            break
        out.append((r, int(rng.integers(0, r.tokens.shape[0]))))
        total += r.tokens.shape[1]
    return out


def _sequence(run, cfg: Dict, result, row: int, device):
    s = run.window.served[result.rid]
    prompt = inputs.Prompts(cfg["vocab_size"], run.seed)(
        s.index, s.batch, s.prompt)[row]
    served = result.tokens[row].astype(np.int64)
    seq = np.concatenate([prompt.astype(np.int64), served[:-1]])
    pos = list(range(len(prompt) - 1, len(seq)))
    return torch.from_numpy(seq)[None].to(device), pos, served


def position_gaps(run, cfg: Dict, sample, device,
                  control: bool = False) -> List[np.ndarray]:
    """Per sampled request, at each served position, how far below the
    reference's best logit lies the served token's (or, with ``control``,
    the token an fp8 computation puts first); ``inf`` for a token outside
    the vocabulary."""
    gaps = []
    V = int(cfg["vocab_size"])
    for result, row in sample:
        seq, pos, served = _sequence(run, cfg, result, row, device)
        mask = np.asarray(result.mask, bool)[None]
        ref = ref_model.logits(run.params, cfg, seq, mask, pos)[0]
        best = ref.max(dim=-1).values
        if control:
            low = ref_model.logits(run.params, cfg, seq, mask, pos,
                                   prec=ref_model.Precision("fp8"))[0]
            pick = low.argmax(dim=-1)
        else:
            pick = torch.from_numpy(np.minimum(served, V - 1)).to(device)
        g = (best - ref.gather(-1, pick[:, None])[:, 0]).cpu().numpy()
        if not control:
            g[served >= V] = math.inf
        gaps.append(g.astype(np.float64))
        del ref
    return gaps


def token_gaps(run, cfg: Dict, sample, device, control: bool = False):
    """The widest gap of each sampled request (``position_gaps``)."""
    return [float(g.max()) for g in position_gaps(run, cfg, sample, device,
                                                  control)]


def _decide_spans(run, window_only: bool = True):
    w = run.window
    return [sp for sp in w.spans if sp.kind == "decide" and (
        not window_only or w.t_open <= sp.t0 < w.t_close)]


def _decisions(run):
    out = []
    for sp in _decide_spans(run):
        st, d, _ = sp.info
        out.append((st.batch, st.total_len, st.budget_bytes,
                    np.asarray(d.mask, bool), d.steps, d.peak_bytes, d.fits,
                    d.cached))
    return out


def _replays(run):
    out = []
    for sp in _decide_spans(run):
        st, d, passes = sp.info
        out.append((st.batch, st.total_len, st.budget_bytes,
                    np.asarray(d.mask, bool), d.steps, d.cached, passes))
    return out


def check(run, cfg_file: Dict, limits: Dict,
          device) -> Tuple[bool, Dict[str, Dict], List[str]]:
    """(correct, {name: {"value", "limit"}}, findings) of a finished
    run."""
    cfg = cfg_file["model"]
    seed = run.seed
    lim = limits.get("limits", {})
    plan = limits.get("check", {})
    numbers: Dict[str, float] = {}
    peak = ref_ctl.Peak(cfg)
    decisions = _decisions(run)
    faults = ref_ctl.decision_faults(peak, decisions)
    numbers["decision_faults"] = float(len(faults))
    choices = ref_ctl.choice_faults(peak, run.q_params, _replays(run))
    numbers["choice_faults"] = float(len(choices))
    faults = faults + choices
    numbers["pool_overcommits"] = float(run.pool["overcommit_events"])
    numbers["pool_over_capacity_bytes"] = max(
        0.0, run.pool["peak_reserved_bytes"] - run.pool["capacity_bytes"])
    sample = sample_requests(run, seed, int(plan.get("tokens", 256)),
                             int(plan.get("requests", 8)))
    gaps = token_gaps(run, cfg, sample, device)
    numbers["token_gap"] = max(gaps) if gaps else math.inf
    out = {k: {"value": v, "limit": lim.get(k)} for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in out.values()
                  if v["limit"] is not None) and math.isfinite(
        numbers["token_gap"])
    return correct, out, faults
