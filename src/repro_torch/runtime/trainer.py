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

  * elastic re-mesh — ``remesh(new_mesh)`` gathers the live state whole,
    rebuilds the step for the new mesh and cuts the state again: with a
    checkpoint restore, the shrink/grow-the-job path.

The step is ``steps.make_train_step`` run eagerly on ``device`` (the card
unless the caller asks for the CPU), or, with ``mesh=`` (a
``launch.mesh.Mesh``), ``steps.make_sharded_train_step``: every rank runs
this trainer on the same batches, holds its blocks of the parameters and
moments under ``parallel.sharding.param_pspecs`` and takes its data shard.
A checkpoint holds the whole state in JAX's format, gathered and written
by rank 0; a restore cuts it for the current mesh (or none).
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
        self.mesh = mesh
        self._build()

    # ------------------------------------------------------------- plumbing
    def _build(self):
        """The step (and, on a mesh, the partition specs) for
        ``self.mesh``."""
        if self.mesh is None:
            self._specs = None
            self._step_fn = steps_lib.make_train_step(
                self.model, self.opt_cfg, remat=self.cfg.remat)
            return
        from repro_torch.parallel.sharding import P, param_pspecs
        specs = param_pspecs(self.model.init(self.cfg.seed, "meta"),
                             self.mesh)
        self._specs = {"params": specs,
                       "opt": adamw.AdamWState(step=P(), mu=specs, nu=specs)}
        self._step_fn = steps_lib.make_sharded_train_step(
            self.model, self.opt_cfg, self.mesh, specs=specs,
            remat=self.cfg.remat)

    def _cut(self, state: dict) -> dict:
        """This rank's blocks of a whole {"params", "opt"} state."""
        if self.mesh is None:
            return state
        from repro_torch.parallel.sharding import shard_params
        return shard_params(state, self._specs, self.mesh, self.mesh.coords,
                            self.model.cfg)

    def gathered_state(self, *, dst=None) -> Optional[dict]:
        """The whole {"params", "opt"} state: on every rank, or with
        ``dst`` on that rank's host alone (None elsewhere). A collective
        on a mesh: every rank calls it. Leaves that nothing cuts are the
        live tensors themselves."""
        state = {"params": self.params, "opt": self.opt_state}
        if self.mesh is None:
            return state
        from repro_torch.parallel.tp import gather_tree
        return gather_tree(state, self._specs, self.mesh, self.model.cfg,
                           dst=dst)

    def _set(self, state: dict) -> None:
        state = self._cut(state)
        self.params, self.opt_state = state["params"], state["opt"]

    def init_state(self):
        params = self.model.init(self.cfg.seed, self.device)
        self._set({"params": params, "opt": adamw.init(params)})
        self.step = 0

    def maybe_restore(self) -> bool:
        """True if a checkpoint was restored (cut for the current mesh)."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        shapes = self.model.init(self.cfg.seed, "meta")   # no weights drawn
        template = {"params": shapes, "opt": adamw.init(shapes)}
        state, manifest = self.ckpt.restore(template, device=self.device)
        self._set(state)
        self.step = self._saved_step = manifest["step"]
        return True

    def save(self, blocking: Optional[bool] = None):
        """Checkpoint the whole state (on a mesh: gathered to rank 0, which
        writes it)."""
        if self.ckpt is None:
            return
        state = self.gathered_state(dst=0)
        if state is not None:
            self.ckpt.save(state, self.step,
                           blocking=(not self.cfg.ckpt_async
                                     if blocking is None else blocking))
        self._saved_step = self.step

    # ------------------------------------------------------------- elastic
    def remesh(self, new_mesh):
        """Elastic scaling: gather the live state whole, rebuild the step
        and the specs for ``new_mesh`` (None: meshless) and cut the state
        again, as JAX's (which goes through the host)."""
        state = self.gathered_state() if self.params is not None else None
        self.mesh = new_mesh
        self._build()
        if state is not None:
            self._set(state)

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
            # on a mesh of several ranks the save is a collective that a
            # rank failing alone would hang: no emergency save there
            if (self.ckpt is not None and self.params is not None
                    and (self.mesh is None or self.mesh.size == 1)):
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
