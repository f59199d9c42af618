"""Fig. 9 analogue: DQN expected-reward curves across 3 random seeds —
training is robust to initialization."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common


def run() -> list:
    model, params, corpus = common.subject()
    rows = []
    finals = []
    for seed in (0, 1, 2):
        _, tr = common.trained_controller(model, params, corpus,
                                          episodes=5, seed=seed,
                                          tag="fig9")
        r = np.asarray(tr.episode_rewards)
        # smoothed curve
        smooth = np.convolve(r, np.ones(5) / 5, mode="valid")
        for ep, v in enumerate(smooth):
            rows.append({"seed": seed, "episode": ep,
                         "reward_smoothed": round(float(v), 4)})
        finals.append(float(smooth[-1]))
    common.emit("fig9_seeds", rows,
                header=["seed", "episode", "reward_smoothed"])
    print(f"# final smoothed rewards per seed: "
          f"{[round(f, 3) for f in finals]} "
          f"(band width {max(finals)-min(finals):.3f})")
    return rows
