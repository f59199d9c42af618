"""Fault-tolerant training runtime: the port of ``repro/runtime/trainer.py``.

  * checkpoint/restart — atomic step checkpoints (params + optimizer) in
    the JAX package's format (``repro_torch.checkpoint``); ``run`` resumes
    from the latest one, and the step-indexed data pipeline replays the
    exact batch sequence;
  * crash safety — any exception triggers a best-effort emergency save
    before re-raising, so at most one step of work is lost;
  * straggler mitigation — per-step wall-time EWMA; a step slower than
    ``straggler_factor ×`` the EWMA is recorded and fires ``on_straggler``;
  * async checkpointing — file I/O on a background thread, overlapping the
    next steps. A run's last step is saved once: where the periodic save
    already wrote it, the final save only waits for that write.

The step is ``steps.make_train_step`` run eagerly on ``device`` (the card
unless the caller asks for the CPU). Elastic re-meshing and sharded
training (``mesh=``, ``remesh``) are multi-GPU work, ROADMAP queue 1,
item 16.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import adamw
from repro_torch.runtime import steps as steps_lib

_MULTI_GPU = ("multi-GPU training (a mesh, elastic re-meshing) is ROADMAP "
              "queue 1, item 16")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = True
    log_every: int = 10
    remat: bool = True
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    seed: int = 0


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data.batch_iterator``) or tensors, on
    ``device``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, model, opt_cfg: adamw.AdamWConfig,
                 cfg: TrainerConfig, mesh=None,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 on_log: Optional[Callable[[int, Dict], None]] = None,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(f"mesh=: {_MULTI_GPU}")
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.device = torch.device(device)
        self.on_straggler = on_straggler
        self.on_log = on_log
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
                     if cfg.ckpt_dir else None)
        self.step = 0
        self.params = None
        self.opt_state = None
        self._ewma = None
        self._saved_step = None
        self.straggler_events = []
        self._step_fn = steps_lib.make_train_step(model, opt_cfg,
                                                  remat=cfg.remat)

    # ------------------------------------------------------------- plumbing
    def init_state(self):
        self.params = self.model.init(self.cfg.seed, self.device)
        self.opt_state = adamw.init(self.params)
        self.step = 0

    def maybe_restore(self) -> bool:
        """True if a checkpoint was restored."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        shapes = self.model.init(self.cfg.seed, "meta")   # no weights drawn
        template = {"params": shapes, "opt": adamw.init(shapes)}
        state, manifest = self.ckpt.restore(template, device=self.device)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = self._saved_step = manifest["step"]
        return True

    def save(self, blocking: Optional[bool] = None):
        if self.ckpt is None:
            return
        self.ckpt.save({"params": self.params, "opt": self.opt_state},
                       self.step,
                       blocking=(not self.cfg.ckpt_async
                                 if blocking is None else blocking))
        self._saved_step = self.step

    def remesh(self, new_mesh):
        raise NotImplementedError(f"remesh: {_MULTI_GPU}")

    # ----------------------------------------------------------------- run
    def run(self, batches: Iterator[Dict], *,
            steps: Optional[int] = None) -> Dict[str, Any]:
        """Train until ``total_steps`` (or ``steps`` more), checkpointing and
        watching for stragglers. Returns summary metrics."""
        if self.params is None and not self.maybe_restore():
            self.init_state()
        target = (self.cfg.total_steps if steps is None
                  else self.step + steps)
        history = []
        try:
            while self.step < target:
                t0 = time.perf_counter()   # includes data fetch: input
                batch = to_device(next(batches), self.device)  # stalls too
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])     # waits for the step
                dt = time.perf_counter() - t0
                self.step += 1
                self._watch_straggler(dt)
                if self.step % self.cfg.log_every == 0 or self.step == target:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["loss"] = loss
                    history.append({"step": self.step, "time_s": dt, **m})
                    if self.on_log:
                        self.on_log(self.step, m)
                if (self.ckpt is not None
                        and self.step % self.cfg.ckpt_every == 0):
                    self.save()
        except BaseException:
            if self.ckpt is not None and self.params is not None:
                try:
                    self.save(blocking=True)   # emergency checkpoint
                except Exception:
                    pass
            raise
        if self.ckpt is not None:
            if self._saved_step == self.step:
                self.ckpt.wait()               # this step is being written
            else:
                self.save(blocking=True)
        return {"history": history, "final_step": self.step,
                "straggler_events": list(self.straggler_events)}

    def _watch_straggler(self, dt: float):
        if self._ewma is None:
            # the first step pays one-time costs (the kernels' build, the
            # allocator's growth) — a sentinel, seeded on the next
            self._ewma = -1.0
            return
        if self._ewma < 0:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.straggler_events.append((self.step, dt, self._ewma))
            if self.on_straggler:
                self.on_straggler(self.step, dt)
        a = self.cfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt
