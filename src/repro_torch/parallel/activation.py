"""The parallelism policy of the code that runs under a mesh.

The port of ``repro/parallel/activation.py``'s ``Policy`` / ``use`` /
``policy``: a context installs the mesh the model code runs under, and
the tensor-parallel blocks (``models/attention.py``, ``ffn.py``,
``rglru.py``, ``decoder.py``'s embedding and head) and ``moe_ffn``'s
expert-parallel route read it. Without a policy, or on a model axis of
one, the model code is the single-device code, unchanged.

JAX's six layout hints (``hidden``, ``logits``, ``width``, ``gather_seq``,
``expert_buffer``, ``heads``) are ``with_sharding_constraint`` calls that
steer GSPMD's propagation; the port runs explicit SPMD, where every
activation is rank-local by construction and each collective is written
where the math needs it (``parallel/tp.py``). ``hidden``'s one effect
beyond layout, the residual stream cut along S over "model" at S >= 2048
(Megatron sequence parallelism), is :func:`seq_sharded`'s rule, which the
model code applies through ``tp.seq_split``.

``cache_specs`` (the specs ``parallel.sharding.cache_pspecs`` gives a
decode cache; ``ShardedExecutor.lower_decode`` and the dry run set them)
tells the decode step that its cache holds every KV head and the whole
recurrent width, with the sequence of a KV leaf (or a state's width or
heads, under ``shard_seq``) cut where the specs say
(``tp.cache_cut``). Without them the cache is the serve layout.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

from repro_torch.parallel import sharding

__all__ = ["Policy", "use", "policy", "seq_sharded", "SEQ_SHARD_MIN"]

_POLICY: Optional["Policy"] = None
SEQ_SHARD_MIN = 2048        # JAX's _SEQ_SHARD_MIN


class Policy:
    """The mesh the code runs under: ``dp`` (its data axes), ``ndp``,
    ``nmdl`` (the model axis), ``fsdp``, ``shard_seq``, ``cache_specs``
    (module docstring); and, for explicit SPMD, this rank's model
    coordinate ``mrank`` and group ``model_group``."""

    def __init__(self, mesh, *, shard_seq: bool = False,
                 fsdp: bool = False, cache_specs=None):
        self.mesh = mesh
        self.dp: Tuple[str, ...] = sharding.dp_axes(mesh)
        self.ndp = sharding.axis_size(mesh, self.dp)
        self.nmdl = sharding.axis_size(mesh, "model")
        self.shard_seq = shard_seq
        self.fsdp = fsdp
        self.cache_specs = cache_specs

    @property
    def mrank(self) -> int:
        return self.mesh.coord("model")

    @property
    def model_group(self):
        return self.mesh.group("model")


@contextlib.contextmanager
def use(mesh, *, shard_seq: bool = False, fsdp: bool = False,
        cache_specs=None):
    global _POLICY
    prev = _POLICY
    _POLICY = (Policy(mesh, shard_seq=shard_seq, fsdp=fsdp,
                      cache_specs=cache_specs)
               if mesh is not None else None)
    try:
        yield
    finally:
        _POLICY = prev


def policy() -> Optional[Policy]:
    return _POLICY


def seq_sharded(S: int) -> bool:
    """Whether a residual stream of S positions is cut along S over
    "model" (JAX's ``hidden``: a model axis m > 1, S >= 2048 and m
    dividing S)."""
    p = _POLICY
    return (p is not None and p.nmdl > 1 and S >= SEQ_SHARD_MIN
            and S % p.nmdl == 0)
