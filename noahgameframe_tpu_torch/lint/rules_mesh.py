"""Elastic-mesh rule: captured code must not capture a mesh via object state.

The JAX package's ``lint/rules_mesh.py`` over the port's roots.  A
``parallel/mesh.py`` ``Mesh`` names devices.  Code that runs inside a
captured step bakes whatever mesh it read at capture time into the CUDA
graph (and into its collectives) — so a mesh reached through mutable
object state (``self.mesh``) silently pins the OLD device set after an
elastic reshard (``ShardedKernel.reshard`` / ``ElasticMesh``) unless
the holder is re-aimed and the kernel invalidated in the same breath.
Passing the mesh as a function parameter keeps the dependency visible at
every call site and re-binds naturally on the post-reshard capture.

The rule walks the call graph from the roots whose steps are captured
(as capture-safety does: graph dispatchers, ``add_phase`` registrations
and vmap targets; an eager dispatcher re-reads ``self.mesh`` on every
call, so nothing goes stale there) and flags ``self.<attr>`` reads where the attribute is
mesh-named (``mesh`` or ``*_mesh``).  A read that genuinely participates
in the reshard contract — retarget() + invalidate() before every
re-capture — carries a same-line
``nf-lint: disable=mesh-not-captured -- <why>`` waiver.
"""

from __future__ import annotations

import ast
from typing import List

from .callgraph import captured_reachable
from .engine import Finding, PackageContext, Rule
from .rules_trace import CAPTURED_KINDS, _TracedScan

_MESH_ATTRS = ("mesh",)


def _mesh_named(attr: str) -> bool:
    return attr in _MESH_ATTRS or attr.endswith("_mesh")


class _MeshScan(_TracedScan):
    def visit_Attribute(self, node):
        if isinstance(node.ctx, ast.Load) and _mesh_named(node.attr) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            self.flag(
                node,
                f"`self.{node.attr}` read {self.where()} — a mesh "
                "captured through object state pins the capture to a "
                "stale device set after an elastic reshard; pass the mesh "
                "as a parameter (or retarget()+invalidate() and waive "
                "with a reason)")
        self.generic_visit(node)


class MeshNotCapturedRule(Rule):
    """Stale-device-set hazard: mesh reads through `self` in captured code."""

    name = "mesh-not-captured"
    description = (
        "capture-reachable code must not read a mesh via object state "
        "(`self.mesh`); pass it as a parameter so an elastic reshard "
        "re-binds it on the re-capture.")
    per_module = False

    def run_package(self, ctx: PackageContext) -> List[Finding]:
        self.findings = []
        for tf in captured_reachable(ctx, CAPTURED_KINDS).values():
            if tf.info.rel not in ctx.modules:
                continue
            self.module = ctx.modules[tf.info.rel]
            _MeshScan(self, tf).scan()
        return self.findings
