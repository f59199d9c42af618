"""Process groups and device meshes.

The port of ``repro/launch/mesh.py`` for ``torch.distributed``. The port
runs explicit SPMD: one process per card, every process running the same
program on rank-local tensors, with the collectives named in the code. A
:class:`Mesh` is a ``DeviceMesh`` over the world with JAX's axis names —
``("data", "model")``, ``("pod", "data", "model")`` multi-pod — plus the
rules' view of it (``shape``: axis name → size) and this rank's
coordinates.

The process group (:func:`init_distributed`): under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` set) from its environment,
otherwise a world of one on a ``FileStore`` in a fresh temporary
directory. The backend follows the device — ``cuda`` NCCL, ``cpu`` gloo —
and nothing switches it. Every group gets an explicit timeout.

Importing this module touches no process group: meshes are built inside
functions only.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding

__all__ = ["Mesh", "init_distributed", "destroy_distributed",
           "make_production_mesh", "make_host_mesh", "make_serve_mesh",
           "PG_TIMEOUT"]

PG_TIMEOUT = timedelta(seconds=600)

_STORE_DIR: Optional[str] = None    # the FileStore of a world of one


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda", *, timeout: timedelta = PG_TIMEOUT
                     ) -> None:
    """Start this process's group unless one is running: from torchrun's
    environment when it is set, else a world of one on a ``FileStore``.
    ``device`` picks the backend (``cuda``: NCCL on this rank's card,
    ``cpu``: gloo)."""
    if dist.is_initialized():
        return
    backend = _backend(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)
        return
    global _STORE_DIR
    if backend == "nccl":
        torch.cuda.set_device(torch.cuda.current_device())
    _STORE_DIR = tempfile.mkdtemp(prefix="rap_pg_")
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(_STORE_DIR, "store"), 1), rank=0, world_size=1,
        timeout=timeout)


def destroy_distributed() -> None:
    """Tear the process group down (every subgroup with it), and remove
    the ``FileStore`` directory of a world of one that
    :func:`init_distributed` started."""
    global _STORE_DIR
    if dist.is_initialized():
        dist.destroy_process_group()
    if _STORE_DIR is not None:
        shutil.rmtree(_STORE_DIR, ignore_errors=True)
        _STORE_DIR = None


class Mesh:
    """A device mesh over the running world, row-major over ``axes``.

    ``shape`` ({axis: size}, in axis order) is what the sharding rules
    read; ``coords`` ({axis: index}) is this rank's place; ``group(axis)``
    is the process group along one axis (this rank's row of it), and
    ``group(("pod", "data"))`` the group over several. ``device`` is the
    card this rank computes on (or the CPU, under gloo)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_type: str = "cuda"):
        from torch.distributed.device_mesh import init_device_mesh
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} vs axes {axes}")
        world = dist.get_world_size()
        n = 1
        for s in shape:
            n *= s
        if n != world:
            raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                             f"{n} ranks; the world has {world}")
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.axis_names = axes
        self.size = n
        self.device_type = device_type
        self.device_mesh = init_device_mesh(device_type, shape,
                                            mesh_dim_names=axes)
        self.coords: Dict[str, int] = {
            a: self.device_mesh.get_local_rank(a) for a in axes}
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_type == "cuda" else torch.device("cpu"))
        self._groups = {a: self.device_mesh.get_group(a) for a in axes}
        if len(axes) > 2:
            self._groups[axes[:-1]] = self._flat_group(axes[:-1])

    def _flat_group(self, lead: Tuple[str, ...]):
        """One group over the leading axes (pod x data): the ranks that
        share this rank's last coordinate. Every rank builds every such
        group, in the same order."""
        ranks_at = self.device_mesh.mesh            # rank at each coordinate
        mine = None
        for c in range(ranks_at.shape[-1]):
            ranks = ranks_at[..., c].flatten().tolist()
            g = dist.new_group(ranks, timeout=PG_TIMEOUT)
            if dist.get_rank() in ranks:
                mine = g
        return mine

    def group(self, axis):
        if isinstance(axis, (tuple, list)):
            axis = tuple(axis)
            return self._groups[axis if len(axis) > 1 else axis[0]]
        return self._groups[axis]

    def axis_size(self, axis) -> int:
        return sharding.axis_size(self, axis)

    def coord(self, axis) -> int:
        """This rank's coordinate along an axis or a tuple of axes."""
        return sharding.coord(self, axis, self.coords)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return sharding.dp_axes(self)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production mesh: 16 x 16 ("data", "model"), or 2 x 16 x 16
    ("pod", "data", "model") multi-pod, over a world of exactly that many
    ranks (raises with the count it needs otherwise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} production mesh needs {need} "
            f"ranks (torchrun --nproc-per-node / --nnodes); this world has "
            f"{world}")
    return Mesh(shape, axes, device_type)


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None, axes=None, *,
                   device="cuda"):
    """A small mesh over the running world (started first if it is not):
    ``(world, 1)`` ("data", "model") by default."""
    init_distributed(device)
    n = dist.get_world_size()
    if shape is None:
        shape, axes = (n, 1), ("data", "model")
    return Mesh(shape, axes or ("data", "model"), torch.device(device).type)


def make_serve_mesh(n_slots: Optional[int] = None, *, device="cuda"):
    """DP-majority serve mesh over the running world (DESIGN.md §7).

    The engine's slot axis is the data-parallel dimension, so the "data"
    axis is the largest power of two that fits the world and divides
    ``n_slots``, with a "model" axis of one. One rank yields the
    degenerate (1, 1) mesh. Ranks past the data axis are not used, so the
    world must be exactly that size."""
    init_distributed(device)
    n = dist.get_world_size()
    d = 1
    while d * 2 <= n and (n_slots is None or int(n_slots) % (d * 2) == 0):
        d *= 2
    return make_host_mesh((d, 1), ("data", "model"), device=device)
