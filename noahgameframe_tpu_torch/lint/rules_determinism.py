"""Determinism rules: no wall clocks, no unseeded RNGs.

The JAX package's ``lint/rules_determinism.py`` over the whole port:
record/replay's contract is that device state is a pure function of
(checkpoint, journaled inputs), and one stray ``time.time()`` or
process-global ``random.random()`` on a tick-adjacent path silently
breaks every replay.  Intentional wall-clock reads (live telemetry
stamps, the GuidAllocator's wall mode) carry inline suppressions with
reasons instead of being invisible to the scan.

``unseeded-rng`` also covers torch's process-global generator: a draw
(``torch.rand``, ``randn``, ``randint``, ``randperm``, ``normal``,
``bernoulli``, ``multinomial``) without ``generator=``, and a reseed of
the global state (``torch.manual_seed`` and its CUDA forms).  The port's
contract is an explicit generator, or the counter-based threefry stream
of ``core/prng.py``.
"""

from __future__ import annotations

import ast

from .engine import Rule, dotted_name

#: torch draws that read the process-global generator unless handed one
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
               "bernoulli", "multinomial"}
#: reseeds of torch's process-global generator state
TORCH_RESEEDS = {"manual_seed", "seed", "cuda.manual_seed",
                 "cuda.manual_seed_all", "cuda.seed", "cuda.seed_all"}


class _AliasTracker(ast.NodeVisitor):
    """Per-file import-alias bookkeeping shared by both rules."""

    def __init__(self) -> None:
        super().__init__()
        self.time_aliases = set()  # modules: import time [as _t]
        self.time_fn_aliases = set()  # names: from time import time [as t]
        self.random_aliases = set()  # modules: import random [as _r]
        self.numpy_aliases = set()  # modules: import numpy [as np]
        self.torch_aliases = set()  # modules: import torch [as th]
        self.torch_fn_aliases = {}  # names: from torch import randn [as r]

    def _reset(self) -> None:
        self.time_aliases = set()
        self.time_fn_aliases = set()
        self.random_aliases = set()
        self.numpy_aliases = set()
        self.torch_aliases = set()
        self.torch_fn_aliases = {}

    def visit_Import(self, node):
        for a in node.names:
            name = a.asname or a.name
            if a.name == "time":
                self.time_aliases.add(name)
            elif a.name == "random":
                self.random_aliases.add(name)
            elif a.name == "numpy":
                self.numpy_aliases.add(name)
            elif a.name == "torch":
                self.torch_aliases.add(name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        if node.module == "time":
            for a in node.names:
                if a.name == "time":
                    self.time_fn_aliases.add(a.asname or a.name)
        elif node.module == "torch":
            for a in node.names:
                if a.name in TORCH_DRAWS or a.name in TORCH_RESEEDS:
                    self.torch_fn_aliases[a.asname or a.name] = a.name
        self.generic_visit(node)


class WallClockRule(_AliasTracker, Rule):
    """``time.time()`` under any import alias."""

    name = "wall-clock"
    description = ("No time.time() reads: monotonic()/perf_counter() are "
                   "the injectable-now patterns; wall time in a journaled "
                   "input or compiled path breaks bit-identical replay.")

    def check_module(self, module, ctx):
        self._reset()
        self.visit(module.tree)

    def visit_Call(self, node):
        dotted = dotted_name(node.func)
        if dotted is not None:
            parts = dotted.split(".")
            if dotted in self.time_fn_aliases:
                self.flag(node, f"wall clock read: {dotted}()")
            elif parts[0] in self.time_aliases and parts[1:] == ["time"]:
                self.flag(node, f"wall clock read: {dotted}()")
        self.generic_visit(node)


class UnseededRngRule(_AliasTracker, Rule):
    """Module-global ``random.*``, unseeded numpy generators, and torch's
    process-global generator."""

    name = "unseeded-rng"
    description = ("No process-global random.* calls, no unseeded "
                   "np.random generators, and no torch draw without "
                   "generator= (nor torch.manual_seed): all randomness "
                   "flows from an explicit seed so replays reproduce it.")

    def check_module(self, module, ctx):
        self._reset()
        self.visit(module.tree)

    def visit_Call(self, node):
        dotted = dotted_name(node.func)
        if dotted is not None:
            parts = dotted.split(".")
            head, rest = parts[0], parts[1:]
            if head in self.random_aliases and len(rest) == 1:
                if not (rest[0] == "Random" and node.args):
                    self.flag(node, f"process-global RNG: {dotted}()")
            elif (head in self.numpy_aliases and len(rest) == 2
                  and rest[0] == "random"):
                if not (rest[1] == "default_rng" and node.args):
                    self.flag(node, f"unseeded numpy RNG: {dotted}()")
            elif head in self.torch_aliases and rest:
                self._check_torch(node, dotted, ".".join(rest))
            elif not rest and head in self.torch_fn_aliases:
                self._check_torch(node, dotted, self.torch_fn_aliases[head])
        self.generic_visit(node)

    def _check_torch(self, node, dotted: str, fn: str) -> None:
        if fn in TORCH_RESEEDS:
            self.flag(node, f"reseeds torch's process-global RNG: {dotted}()")
        elif fn in TORCH_DRAWS and not any(
                k.arg == "generator" for k in node.keywords):
            self.flag(node, f"torch draw from the process-global RNG: "
                      f"{dotted}() without generator=")
