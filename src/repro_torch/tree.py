"""Parameter trees as flat dicts: the JAX package's leaf order and names.

A tree is nested dicts, NamedTuples (``AdamWState``) and sequences of
tensors. :func:`flatten` names each leaf by its path joined with ``/``
(``stacks/attn/wq``, ``opt/mu/embed``), in the order
``jax.tree_util.tree_flatten_with_path`` visits it (dict keys sorted,
NamedTuple fields in order), which is how the JAX package's checkpoints
name their files; :func:`unflatten` puts such leaves back into a
template's structure.
"""
from __future__ import annotations

from typing import Any, Dict


def _children(tree):
    """(key, child) pairs in the JAX flatten order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in kids:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with ``leaves[key]`` at each leaf."""
    kids = _children(template)
    if kids is None:
        return leaves[prefix]
    sub = lambda k, v: unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
    if isinstance(template, dict):
        return {k: sub(str(k), v) for k, v in template.items()}
    vals = [sub(k, v) for k, v in kids]
    if hasattr(template, "_fields"):
        return type(template)(*vals)
    return type(template)(vals)
