"""The check that nothing the benchmark loaded is JAX or the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: ``noahgameframe_tpu_torch`` is the program under test,
``noahgameframe_tpu`` the JAX package it was ported from.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "noahgameframe_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
