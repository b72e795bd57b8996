"""Flattening nested containers of tensors: the port's small pytree.

The world state is a tree of dataclasses, dicts and NamedTuples (the
Verlet cache) with tensors at the leaves; the tick's observed outputs are
dicts, lists and tuples of tensors.  The cost book keys captures on a
flattened state, the CUDA graphs bind and copy back leaf by leaf, and a
K-tick train stacks every leaf of its per-tick outputs.  Dict keys are
taken in sorted order, so equal trees flatten equally.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Tuple

_LEAF = None  # the spec of a leaf


def flatten(tree: Any) -> Tuple[List[Any], Any, List[str]]:
    """``(leaves, spec, paths)``: the leaves in a fixed order, a hashable
    spec of the containers around them, and each leaf's path
    (``.classes.NPC.i32``, ``.events[0][1].killer``)."""
    leaves: List[Any] = []
    paths: List[str] = []

    def rec(x, path):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return ("dc", type(x), names,
                    tuple(rec(getattr(x, k), f"{path}.{k}") for k in names))
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("nt", type(x), tuple(rec(v, f"{path}.{k}") for k, v in zip(x._fields, x)))
        if isinstance(x, (tuple, list)):
            return ("seq", type(x), tuple(rec(v, f"{path}[{i}]") for i, v in enumerate(x)))
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return ("dict", keys, tuple(rec(x[k], f"{path}.{k}") for k in keys))
        leaves.append(x)
        paths.append(path)
        return _LEAF

    spec = rec(tree, "")
    return leaves, spec, paths


def unflatten(spec: Any, leaves) -> Any:
    """The tree of ``spec`` with ``leaves`` (in :func:`flatten` order)."""
    it: Iterator[Any] = iter(leaves)

    def rec(s):
        if s is _LEAF:
            return next(it)
        kind = s[0]
        if kind == "dc":
            _, cls, names, kids = s
            return cls(**{k: rec(c) for k, c in zip(names, kids)})
        if kind == "nt":
            return s[1](*(rec(c) for c in s[2]))
        if kind == "seq":
            return s[1](rec(c) for c in s[2])
        return {k: rec(c) for k, c in zip(s[1], s[2])}

    return rec(spec)
