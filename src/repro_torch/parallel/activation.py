"""The parallelism policy of the code that runs under a mesh.

The port of ``repro/parallel/activation.py``'s ``Policy`` / ``use`` /
``policy``: a context installs the mesh the model code runs under, and
the tensor-parallel blocks (``models/attention.py``, ``ffn.py``,
``rglru.py``, ``decoder.py``'s embedding and head) and ``moe_ffn``'s
expert-parallel route read it. Without a policy, or on a model axis of
one, the model code is the single-device code, unchanged.

JAX's six layout hints (``hidden``, ``logits``, ``width``, ``gather_seq``,
``expert_buffer``, ``heads``) have no counterpart here. They are
``with_sharding_constraint`` calls that steer GSPMD's propagation; the port
runs explicit SPMD, where every activation is rank-local by construction
and each collective is written where the math needs it
(``parallel/tp.py``). Their one effect beyond layout — ``hidden``'s
sequence-over-model split at S >= 2048 and ``shard_seq`` — is sequence
parallelism, ROADMAP item 16b.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

from repro_torch.parallel import sharding

__all__ = ["Policy", "use", "policy"]

_POLICY: Optional["Policy"] = None


class Policy:
    """The mesh the code runs under: ``dp`` (its data axes), ``ndp``,
    ``nmdl`` (the model axis), ``fsdp``, ``shard_seq``; and, for explicit
    SPMD, this rank's model coordinate ``mrank`` and group
    ``model_group``."""

    def __init__(self, mesh, *, shard_seq: bool = False,
                 fsdp: bool = False):
        self.mesh = mesh
        self.dp: Tuple[str, ...] = sharding.dp_axes(mesh)
        self.ndp = sharding.axis_size(mesh, self.dp)
        self.nmdl = sharding.axis_size(mesh, "model")
        self.shard_seq = shard_seq
        self.fsdp = fsdp

    @property
    def mrank(self) -> int:
        return self.mesh.coord("model")

    @property
    def model_group(self):
        return self.mesh.group("model")


@contextlib.contextmanager
def use(mesh, *, shard_seq: bool = False, fsdp: bool = False):
    global _POLICY
    prev = _POLICY
    _POLICY = (Policy(mesh, shard_seq=shard_seq, fsdp=fsdp)
               if mesh is not None else None)
    try:
        yield
    finally:
        _POLICY = prev


def policy() -> Optional[Policy]:
    return _POLICY
