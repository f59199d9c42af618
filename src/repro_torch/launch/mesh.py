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

:func:`fake_world` starts the ``"fake"`` backend as rank 0 of ``n``: no
peer exists and no collective moves data, so the dry run
(``launch/dryrun.py``) builds the production mesh and runs one rank's
program on fake tensors, recording every collective it would issue.

The card's data-sheet figures (``PEAK_FLOPS_BF16`` ... ``CARDS_PER_NODE``)
are the roofline's denominators (``repro_torch.roofline``) and the
kernels' bounds (``chip_smoke.py``).

Importing this module touches no process group: meshes are built inside
functions only.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding

__all__ = ["Mesh", "init_distributed", "destroy_distributed", "fake_world",
           "is_fake_world", "make_production_mesh", "make_host_mesh",
           "make_serve_mesh", "PG_TIMEOUT", "PEAK_FLOPS_BF16",
           "PEAK_FLOPS_TF32", "PEAK_FLOPS_F32", "HBM_BW", "HBM_PER_CARD",
           "NVLINK_BW", "NET_BW", "CARDS_PER_NODE"]

PG_TIMEOUT = timedelta(seconds=600)

# Hardware constants of one NVIDIA H100 SXM5 80GB (700 W), dense rates.
# NVIDIA H100 Tensor Core GPU data sheet,
# https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet
# (its tensor-core rates are quoted with 2:4 sparsity; dense is half):
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, BF16/FP16 tensor cores (1979 sparse)
PEAK_FLOPS_TF32 = 495e12     # FLOP/s, TF32 tensor cores (989 sparse)
PEAK_FLOPS_F32 = 67e12       # FLOP/s, FP32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
HBM_PER_CARD = 80e9          # bytes of HBM3
NVLINK_BW = 450e9            # bytes/s per direction per GPU: half of the
                             # data sheet's 900 GB/s NVLink total
# NVIDIA DGX H100 user guide, "Introduction to the NVIDIA DGX H100 System",
# https://docs.nvidia.com/dgx/dgxh100-user-guide/introduction-to-dgxh100.html:
# eight GPUs a node on NVSwitch, and one 400 Gb/s ConnectX-7 (InfiniBand
# NDR) port per GPU for the compute fabric between nodes
NET_BW = 50e9                # bytes/s per GPU between nodes
CARDS_PER_NODE = 8


def peak_flops(dtype) -> float:
    """The card's peak rate for operations on ``dtype`` (a torch dtype or
    its name): the tensor cores' for 16-bit types, the FP32 units' for
    f32."""
    return PEAK_FLOPS_F32 if "float32" in str(dtype) else PEAK_FLOPS_BF16

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


def is_fake_world() -> bool:
    """True inside :func:`fake_world`."""
    return dist.is_initialized() and dist.get_backend() == "fake"


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a world of ``n`` on the ``"fake"`` backend, for counting
    one rank's program (``launch/dryrun.py``): collectives return at once
    and move nothing. Refuses to start beside a running process group, and
    destroys its own on exit, so nothing after it sees a group."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already running; "
                           "a fake world replaces none")
    # importing it registers the "fake" backend where torch does not
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))
    try:
        yield
    finally:
        dist.destroy_process_group()


class Mesh:
    """A device mesh over the running world, row-major over ``axes``.

    ``shape`` ({axis: size}, in axis order) is what the sharding rules
    read; ``coords`` ({axis: index}) is this rank's place; ``group(axis)``
    is the process group along one axis (this rank's row of it), and
    ``group(("pod", "data"))`` the group over several. ``device`` is the
    card this rank computes on (or the CPU, under gloo and on a
    :func:`fake_world`, whose ranks compute on fake CPU tensors)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_type: str = "cuda"):
        from torch.distributed.device_mesh import init_device_mesh
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if is_fake_world():
            device_type = "cpu"
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
