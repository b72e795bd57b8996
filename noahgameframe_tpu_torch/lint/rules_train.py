"""Tick-train lane coverage contract.

The JAX package's ``lint/rules_train.py`` on the port's step.  A K-tick
train (``Kernel.train``) captures K steps as one CUDA graph and stacks
every per-tick output lane of ``Kernel._step`` that host code consumes
(journal digests, death masks, diff counts, event params) into
``[K, ...]`` buffers, so the train loses no per-tick history.  The
stacking is generic — it stacks whatever the step returns — so the
reviewed INTENT lives in one literal: ``TRAIN_LANE_SPEC`` in
``kernel/kernel.py`` enumerates the lanes a train must carry, and
``TRAIN_EXCLUDED`` waivers lanes deliberately dropped (each with a
reason).  This rule is the static complement of the run-time
``_assert_train_lanes`` check: every key of the lanes dict literal that
``Kernel._step`` returns (``return state, raw``, with ``raw = {...}``)
must be enumerated or waivered, and every spec pattern must still match
a real lane — a lane the spec skips would silently lose its per-tick
history the first time a train replaces the single ticks, and a stale
pattern hides the next real gap.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import List, Optional

from .engine import Finding, PackageContext, Rule
from .rules_store import _find_module, _literal_str_tuple

KERNEL_SUFFIX = "kernel/kernel.py"
STEP_CLASS = "Kernel"
STEP_METHOD = "_step"


def _step_node(tree: ast.AST) -> Optional[ast.FunctionDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == STEP_CLASS:
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and m.name == STEP_METHOD:
                    return m
    return None


def _step_lane_keys(tree: ast.AST):
    """The literal string keys of the lanes dict ``Kernel._step`` returns
    as the last element of its result tuple, plus the dict node (or
    ``(None, None)`` when the shape is not statically reviewable)."""
    step = _step_node(tree)
    if step is None:
        return None, None
    returned = set()
    for node in ast.walk(step):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Tuple) \
                and node.value.elts \
                and isinstance(node.value.elts[-1], ast.Name):
            returned.add(node.value.elts[-1].id)
    for stmt in ast.walk(step):
        if not (isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id in returned
                and isinstance(stmt.value, ast.Dict)):
            continue
        keys: List[str] = []
        for k in stmt.value.keys:
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return None, stmt.value  # computed key: unreviewable
            keys.append(k.value)
        return keys, stmt.value
    return None, None


class TrainLanesCoveredRule(Rule):
    """Every per-tick lane of ``Kernel._step`` is enumerated by
    TRAIN_LANE_SPEC (or waivered in TRAIN_EXCLUDED), and the spec names
    no lane that no longer exists — a lane the train's stacked fetch
    skips silently loses its per-tick history inside a K-tick train."""

    name = "train-lanes-covered"
    description = ("kernel/kernel.py TRAIN_LANE_SPEC (+ TRAIN_EXCLUDED) "
                   "must enumerate every key of the lanes dict "
                   "Kernel._step returns, and match only keys that exist.")
    per_module = False

    def run_package(self, ctx: PackageContext) -> List[Finding]:
        self.findings = []
        kern = _find_module(ctx, KERNEL_SUFFIX)
        if kern is None:
            return self.findings  # contract module absent: out of scope
        if kern.tree is None:
            return self.findings  # parse-error finding already emitted

        keys, out_node = _step_lane_keys(kern.tree)
        if out_node is None:
            self.flag(1, "Kernel._step's returned `raw = {...}` lanes "
                      "literal vanished from kernel/kernel.py — the "
                      "train-lane coverage contract has nothing to hold "
                      "onto", path=kern.rel)
            return self.findings
        if keys is None:
            self.flag(out_node, "Kernel._step's lanes dict has a computed "
                      "key — train lanes must be literal strings to be "
                      "reviewed statically", path=kern.rel)
            return self.findings

        spec, spec_node = _literal_str_tuple(kern.tree, "TRAIN_LANE_SPEC")
        excl, excl_node = _literal_str_tuple(kern.tree, "TRAIN_EXCLUDED")
        if spec_node is None:
            self.flag(1, "TRAIN_LANE_SPEC vanished from kernel/kernel.py",
                      path=kern.rel)
            return self.findings
        if spec is None:
            self.flag(spec_node, "TRAIN_LANE_SPEC must be a literal "
                      "tuple of strings — a computed spec cannot be "
                      "reviewed statically", path=kern.rel)
            return self.findings
        if excl_node is not None and excl is None:
            self.flag(excl_node, "TRAIN_EXCLUDED must be a literal "
                      "tuple of strings", path=kern.rel)
            excl = []
        excl = excl or []

        patterns = list(spec) + list(excl)
        for key in keys:
            if not any(fnmatch.fnmatch(key, pat) for pat in patterns):
                self.flag(out_node, f"step lane `{key}` is not covered "
                          "by TRAIN_LANE_SPEC or TRAIN_EXCLUDED — a "
                          "K-tick train would silently lose its "
                          "per-tick history", path=kern.rel)
        for pat in patterns:
            if not any(fnmatch.fnmatch(key, pat) for key in keys):
                where = spec_node if pat in spec else (excl_node
                                                      or spec_node)
                self.flag(where, f"spec entry `{pat}` matches no "
                          "Kernel._step lane — stale after a kernel "
                          "refactor", path=kern.rel)
        return self.findings
