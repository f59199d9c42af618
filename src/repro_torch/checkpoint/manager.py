"""Fault-tolerant checkpointing in the JAX package's on-disk format:
atomic, async, keep-N.

Layout (that of ``repro/checkpoint/manager.py``, so checkpoints move both
ways between the packages):

    <dir>/step_<%010d>/
        manifest.json   # {"step", "extra", "leaves": {key: {file, shape,
                        #   dtype}}}
        <file>.npy      # one file per leaf

A leaf's key joins its path with ``/`` (``repro_torch.tree.flatten``:
``params/stacks/attn/wq``, ``opt/step``, ``opt/mu/embed``); its file is
``key.replace("/", "__") + ".npy"``; its dtype is numpy's name for it
(``float32``, ``int32``, ``bfloat16``). A
bf16 leaf is written as JAX writes one: two-byte void records (numpy has
no bf16 of its own), dtype ``"bfloat16"`` in the manifest; it is read back
through a ``uint16`` view into ``torch.bfloat16``, so no ``ml_dtypes`` is
needed. (The JAX package cannot restore such a leaf: ROADMAP queue 3.)

Atomicity: leaves go into ``step_<n>.tmp``, which is renamed into place
(the commit point); ``latest_step`` trusts only directories with a
manifest. Async: ``save(..., blocking=False)`` snapshots every leaf to host
memory at once and writes the files on a background thread; its error is
raised by the next ``wait()``. Restore places each leaf on the device and
in the dtype of the template's leaf (a ``"meta"`` template, from
``Model.init(seed, "meta")``, restores to ``device``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

_VOID2 = np.dtype("V2")       # how numpy stores a bf16 array it cannot name


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A snapshot of one leaf on the host, as it is written: (array,
    manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(_VOID2), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write(flat: Dict[str, Tuple[np.ndarray, str]], directory: str,
           step: int, extra: Optional[Dict[str, Any]]) -> str:
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, (arr, dtype) in flat.items():
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # commit point
    return final


def save_pytree(tree, directory: str, step: int, *,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomic synchronous save. Returns the committed path."""
    return _write({k: _host(v) for k, v in flatten(tree).items()},
                  directory, step, extra)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def _load(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_pytree(template, directory: str, step: Optional[int] = None, *,
                   device=None):
    """Restore into ``template``'s structure: each leaf in its template
    leaf's dtype, on ``device`` (default: the template leaf's device; the
    CPU for a ``"meta"`` template). Returns (tree, manifest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for key, leaf in flatten(template).items():
        t = _load(path, manifest["leaves"][key])
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
        dev = device or (leaf.device if leaf.device.type != "meta" else "cpu")
        leaves[key] = t.to(device=dev, dtype=leaf.dtype)
    return unflatten(template, leaves), manifest


class CheckpointManager:
    """keep-N rotation + async background writes."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree, step: int, *, extra=None, blocking: bool = True):
        self.wait()
        flat = {k: _host(v) for k, v in flatten(tree).items()}  # snapshot
        if blocking:
            self._write(flat, step, extra)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(flat, step, extra),
                daemon=True)
            self._thread.start()

    def _write_guarded(self, flat, step, extra):
        try:
            self._write(flat, step, extra)
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def _write(self, flat, step, extra):
        _write(flat, self.directory, step, extra)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n)
             for n in os.listdir(self.directory)) if m)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def restore(self, template, *, step=None, device=None):
        self.wait()
        return restore_pytree(template, self.directory, step, device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)
