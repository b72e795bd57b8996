"""Custom-op parity discipline: every ``torch.library.custom_op`` in the
tree must be pinned by a parity test that runs it on the card.

The counterpart of the JAX package's ``lint/rules_pallas.py``, as
``ops/stencil_cuda.py`` is of ``ops/stencil_pallas.py``.  The port's hand
kernels run only on a CUDA device; the CPU CI image never launches them
(a wrapper given CPU tensors runs the plain PyTorch version instead).
The ONLY thing standing between a kernel and a silent bitwise divergence
from its plain version is the card-only test that compares the two — so
that pin is a contract, not a courtesy.  Each module that defines custom
ops declares a literal registry::

    CUSTOM_OP_PARITY_TESTS = {
        "nf::combat_fold": "tests/test_torch_cuda.py",
        "nf::slot_rows": "tests/test_torch_cuda.py",
        "nf::fused_neighborhood": "tests/test_torch_cuda.py",
    }

mapping each op to the test file that pins it.  For every op the rule
checks that the registry names it, that the file exists, and that its
text mentions the op's wrapper (a function of the module that calls
``torch.ops.<ns>.<op>``), the op's plain version (``<op>_plain`` or,
where there is none, the module's function ``<op>``) and the ``cuda``
marker (``mark.cuda``), which takes the place of the reference's
``interpret``: a pin that never runs on the card proves nothing.  Stale
registry keys — an op renamed or deleted without updating its pin — are
findings too, so the registry tracks reality in both directions.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .engine import Finding, ModuleInfo, PackageContext, Rule, dotted_name

REGISTRY_NAME = "CUSTOM_OP_PARITY_TESTS"

#: the pin's text must carry this marker: a parity test that never runs
#: on a CUDA device proves nothing about the kernel
CUDA_MARKER = re.compile(r"mark\.cuda\b")


def _literal_registry(tree) -> Optional[Tuple[int, Dict[str, str]]]:
    """The module's top-level ``CUSTOM_OP_PARITY_TESTS`` literal, if any:
    (line, entries).  Only str->str constant entries count: a computed
    registry can't be audited statically, which defeats the point of the
    pin."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name) and tgt.id == REGISTRY_NAME:
                if not isinstance(value, ast.Dict):
                    return node.lineno, {}
                out: Dict[str, str] = {}
                for k, v in zip(value.keys, value.values):
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str) \
                            and isinstance(v, ast.Constant) \
                            and isinstance(v.value, str):
                        out[k.value] = v.value
                return node.lineno, out
    return None


def _custom_ops(tree) -> Dict[str, int]:
    """op name ("ns::op") -> line of every ``torch.library.custom_op``
    (decorator or call form) in a module."""
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func)
        if d is None or d.split(".")[-1] != "custom_op" or not node.args:
            continue
        a = node.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            out.setdefault(a.value, node.lineno)
    return out


def _module_funcs(tree) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _wrappers(tree, op: str) -> List[str]:
    """Module functions that call ``torch.ops.<ns>.<name>`` for ``op``."""
    ns, _, short = op.partition("::")
    want = f"ops.{ns}.{short}"
    out = []
    for name, fn in _module_funcs(tree).items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                d = dotted_name(node.func)
                if d is not None and (d == want or d.endswith("." + want)):
                    out.append(name)
                    break
    return sorted(out)


def _plain(tree, op: str) -> Optional[str]:
    """The op's plain version: ``<name>_plain``, else ``<name>``."""
    short = op.partition("::")[2]
    funcs = _module_funcs(tree)
    for cand in (f"{short}_plain", short):
        if cand in funcs:
            return cand
    return None


def _mentions(text: str, name: str) -> bool:
    return re.search(rf"\b{re.escape(name)}\b", text) is not None


class CustomOpParityPinnedRule(Rule):
    """Every custom op is named by a card-only parity test via its
    module's ``CUSTOM_OP_PARITY_TESTS`` registry."""

    name = "custom-op-parity-pinned"
    description = (
        "Each torch.library.custom_op must be a key of its module's "
        "literal CUSTOM_OP_PARITY_TESTS registry, pointing at an existing "
        "test file whose text names the op's wrapper and plain version "
        "and carries the cuda marker; stale registry keys are findings "
        "too.")
    per_module = False

    def run_package(self, ctx: PackageContext) -> List[Finding]:
        self.findings = []
        for rel, mod in sorted(ctx.modules.items()):
            if mod.tree is None or rel.startswith("lint/"):
                continue
            ops = _custom_ops(mod.tree)
            reg = _literal_registry(mod.tree)
            if not ops and reg is None:
                continue
            self.module = mod
            self._check_module(ctx, mod, ops, reg)
        return self.findings

    def _check_module(self, ctx: PackageContext, mod: ModuleInfo,
                      ops: Dict[str, int],
                      reg: Optional[Tuple[int, Dict[str, str]]]) -> None:
        rel = mod.rel
        for op, line in sorted(ops.items()):
            if reg is None:
                self.flag(line, f"custom op `{op}` but the module declares "
                          f"no literal {REGISTRY_NAME} registry — the "
                          "kernel has no parity pin on the card", path=rel)
                continue
            entries = reg[1]
            if op not in entries:
                self.flag(line, f"custom op `{op}` is not named in "
                          f"{REGISTRY_NAME} — no card-only parity test "
                          "pins this kernel", path=rel)
                continue
            self._check_pin(ctx, mod, line, op, entries[op])
        if reg is None:
            return
        reg_line, entries = reg
        live: Set[str] = set(ops)
        for op in sorted(set(entries) - live):
            self.flag(reg_line, f"{REGISTRY_NAME} entry `{op}` matches no "
                      "torch.library.custom_op in this module — stale pin "
                      "(op renamed or deleted)", path=rel)

    def _check_pin(self, ctx: PackageContext, mod: ModuleInfo, line: int,
                   op: str, pin: str) -> None:
        rel = mod.rel
        # pins resolve against the scan root first (fixture layouts),
        # then its parent (the real tree: root is the package dir and
        # tests/ is its sibling)
        for base in (ctx.root, ctx.root.parent):
            path = base / pin
            if path.is_file():
                break
        else:
            self.flag(line, f"{REGISTRY_NAME} pins `{op}` to `{pin}`, "
                      "which does not exist — the parity test has "
                      "vanished", path=rel)
            return
        try:
            text = path.read_text(encoding="utf-8")
        except OSError:
            self.flag(line, f"{REGISTRY_NAME} pin `{pin}` for `{op}` is "
                      "unreadable", path=rel)
            return
        wrappers = _wrappers(mod.tree, op)
        plain = _plain(mod.tree, op)
        if not wrappers:
            self.flag(line, f"custom op `{op}` has no wrapper in this "
                      f"module (no call of torch.ops."
                      f"{op.replace('::', '.')})", path=rel)
        elif not any(_mentions(text, w) for w in wrappers):
            self.flag(line, f"parity pin `{pin}` never mentions `{op}`'s "
                      f"wrapper ({', '.join(wrappers)}) — the registry "
                      "points at a file that does not run this kernel",
                      path=rel)
        if plain is None:
            self.flag(line, f"custom op `{op}` has no plain version in "
                      "this module (`<op>_plain` or `<op>`) to hold it "
                      "against", path=rel)
        elif not _mentions(text, plain):
            self.flag(line, f"parity pin `{pin}` never mentions `{plain}`"
                      f", `{op}`'s plain version — it holds the kernel "
                      "against nothing", path=rel)
        if not CUDA_MARKER.search(text):
            self.flag(line, f"parity pin `{pin}` for `{op}` never uses "
                      "the `cuda` marker — on the CPU CI image the "
                      "wrapper runs the plain version, so only a "
                      "card-only test pins the kernel", path=rel)
