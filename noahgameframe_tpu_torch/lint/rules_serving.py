"""Serving-edge rule: the batched serve path stays loop-free.

The JAX package's ``lint/rules_serving.py`` on the port.  The batched
engine moved per-session interest/encode work onto the device — one
vmap-over-sessions dispatch (``ops/serving.py``) against the
SessionTable's seen-state — leaving the host exactly one per-session
job: slicing precomputed byte buffers into packets, attributed to the
StageClock ``assemble`` stage.  A Python ``for`` over the session set
inside an ``interest`` or ``encode`` stage reintroduces the O(sessions)
host wall the batched engine removed, and it does so silently: the
frame still ships, only the waterfall regresses.

The rule walks every ``with ...stage("interest"|"encode")`` block in the
serve roles, follows ``self._method(...)`` calls transitively (without
descending into nested ``stage("assemble")`` blocks — that stage is the
sanctioned per-session emission), and flags loops or comprehensions that
iterate the session set: any ``self.sessions`` chain, or names bound
from ``self._observer_arrays()`` (the legacy path's per-session
collector).  The legacy engine keeps its loops by design — it is the
parity oracle for NF_SERVE_BATCH — so its sites carry reviewed
``# nf-lint: disable=serve-loop -- ...`` waivers.

The port splits the reference's ``GameRole`` over ``net/roles/game.py``
and the mixins in ``net/roles/game_{handlers,interest,session,switch,
sync}.py``.  Those files are one method table here: a stage opened in
one of them follows ``self._method(...)`` into the others, and a loop is
reported at the file and line that hold it.  Over a tree with a single
``game.py`` (the JAX package, its fixtures) the walk is the reference's.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Dict, List, Set, Tuple

from .engine import ModuleInfo, PackageContext, Rule, dotted_name

#: stages where per-session Python iteration is the bug
_HOT_STAGES = {"interest", "encode"}
#: the stage whose whole point is per-session packet slicing
_EXEMPT_STAGE = "assemble"
#: self-methods whose results ARE the session set (legacy collector)
_SESSION_SOURCES = {"_observer_arrays"}

_COMPS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)

#: the files that together hold GameRole's methods (one method table)
_ROLE_FAMILY = ("net/roles/game.py", "net/roles/game_*.py")


def _in_family(rel: str) -> bool:
    return any(fnmatch.fnmatch(rel, pat) for pat in _ROLE_FAMILY)


def _stage_names(node: ast.With) -> Set[str]:
    """Stage labels opened by a ``with`` statement (any item that is a
    ``*.stage("<literal>")`` call)."""
    out: Set[str] = set()
    for item in node.items:
        call = item.context_expr
        if not isinstance(call, ast.Call):
            continue
        d = dotted_name(call.func)
        leaf = d.split(".")[-1] if d else (
            call.func.attr if isinstance(call.func, ast.Attribute) else "")
        if leaf == "stage" and call.args \
                and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            out.add(call.args[0].value)
    return out


def _session_aliases(fn) -> Set[str]:
    """Local names bound from a ``self._observer_arrays()``-style call —
    iterating them is iterating the session set."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        d = dotted_name(node.value.func)
        if d is None or d.split(".")[-1] not in _SESSION_SOURCES:
            continue
        for tgt in node.targets:
            for x in ast.walk(tgt):
                if isinstance(x, ast.Name):
                    out.add(x.id)
    return out


def _iters_sessions(expr, aliases: Set[str]) -> bool:
    for x in ast.walk(expr):
        if isinstance(x, ast.Attribute) and x.attr == "sessions":
            return True
        if isinstance(x, ast.Name) and x.id in aliases:
            return True
    return False


class ServeLoopRule(Rule):
    """Per-session Python loops inside hot serve stages."""

    name = "serve-loop"
    description = (
        "No `for ... in self.sessions` (or _observer_arrays aliases) "
        "inside StageClock 'interest'/'encode' stages or methods they "
        "call — per-session host work belongs to the 'assemble' stage.")
    scope = ("net/roles/*.py",)

    def check_module(self, module: ModuleInfo, ctx: PackageContext) -> None:
        tree = module.tree
        # name -> (file, def): this module's defs first, then (for the
        # GameRole family) its sibling mixins' in path order
        methods: Dict[str, Tuple[str, ast.AST]] = {}
        trees = [(module.rel, tree)]
        if _in_family(module.rel):
            trees += [(rel, m.tree) for rel, m in sorted(ctx.modules.items())
                      if rel != module.rel and m.tree is not None
                      and _in_family(rel)]
        for rel, t in trees:
            for node in ast.walk(t):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods.setdefault(node.name, (rel, node))

        # seeds: hot-stage with-blocks, attributed to their (outermost)
        # enclosing function.  ast.walk is breadth-first, so the parent
        # function sees each with-block before any nested def does.
        seen_withs: Set[int] = set()
        queue: List[Tuple[str, str]] = []  # (method name, stage)
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            aliases = _session_aliases(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.With) or id(node) in seen_withs:
                    continue
                seen_withs.add(id(node))
                for stage in _stage_names(node) & _HOT_STAGES:
                    self._scan(node.body, stage, fn.name, aliases, queue,
                               module.rel)

        # transitive closure over self-method calls made in hot stages
        reached: Dict[str, Set[str]] = {}
        while queue:
            name, stage = queue.pop()
            if stage in reached.setdefault(name, set()):
                continue
            reached[name].add(stage)
            if name not in methods:
                continue
            rel, fn = methods[name]
            self._scan(fn.body, stage, name, _session_aliases(fn), queue, rel)

    def _scan(self, nodes, stage: str, where: str, aliases: Set[str],
              queue: List[Tuple[str, str]], rel: str) -> None:
        """Flag session loops and collect self-calls under one stage.

        Labelled nested ``with`` blocks are NOT descended into:
        'assemble' is the sanctioned per-session emission stage, and any
        other stage label is its own seed (harvested by check_module).
        Nested defs ARE descended into — they execute when called inside
        this stage.  Statements and expressions recurse uniformly via
        ``iter_child_nodes``.
        """
        for node in nodes:
            if isinstance(node, ast.With) and _stage_names(node):
                continue
            if isinstance(node, (ast.For, ast.AsyncFor)) \
                    and _iters_sessions(node.iter, aliases):
                self._flag_loop(node, stage, where, rel)
            if isinstance(node, _COMPS):
                for gen in node.generators:
                    if _iters_sessions(gen.iter, aliases):
                        self._flag_loop(node, stage, where, rel)
                        break
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self":
                queue.append((node.func.attr, stage))
            self._scan(list(ast.iter_child_nodes(node)), stage, where,
                       aliases, queue, rel)

    def _flag_loop(self, node, stage: str, where: str, rel: str) -> None:
        self.flag(node,
                  f"per-session Python loop in the '{stage}'-stage serve "
                  f"path (`{where}`) — the batched edge does per-session "
                  "work only in the 'assemble' stage; waivers are for the "
                  "legacy engine only", path=rel)
