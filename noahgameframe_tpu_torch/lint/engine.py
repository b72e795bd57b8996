"""nf-lint engine: parsed-module cache, suppressions, baseline, report.

The port's own copy of ``noahgameframe_tpu/lint/engine.py``, kept
verbatim apart from these lines and the baseline's regeneration hint.
The engine is deliberately dependency-free (``ast`` + ``struct`` + the
standard library only): it must run in CI images, pre-commit hooks and
editors without importing torch or touching a device.  One parse per
file feeds every rule; rules are :class:`Rule` subclasses — an
``ast.NodeVisitor`` with file-set scoping — registered in
``noahgameframe_tpu_torch.lint.ALL_RULES``.

Suppression syntax (same line as the finding, or a standalone comment
above it — a wrapped reason may continue over further comment lines)::

    x = time.time()  # nf-lint: disable=wall-clock -- live-mode stamp

The reason after ``--`` is mandatory: a suppression is a reviewed
decision, not an escape hatch.  A suppression that matches no finding
is itself a finding (``unused-suppression``), so stale waivers cannot
linger after the offense is fixed.

The baseline file records real-but-deferred findings keyed by
``(rule, path, message)`` — line numbers drift, messages don't — so an
old debt doesn't fail CI while any NEW finding still does.  Stale
baseline entries are reported (non-fatally) so ``--update-baseline``
gets run when debt is paid down.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import json
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SUPPRESS_TAG = "nf-lint:"

# findings the engine itself emits (never rule names)
UNUSED_SUPPRESSION = "unused-suppression"
BAD_SUPPRESSION = "bad-suppression"
PARSE_ERROR = "parse-error"


@dataclasses.dataclass
class Finding:
    """One diagnostic: a rule, a location, and what went wrong."""

    rule: str
    path: str  # posix path relative to the scan root
    line: int
    message: str
    status: str = "open"  # open | suppressed | baselined
    reason: Optional[str] = None  # suppression reason when suppressed

    def key(self) -> str:
        """Line-free identity used for baseline matching."""
        return f"{self.rule}::{self.path}::{self.message}"

    def to_json(self) -> dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "status": self.status,
        }
        if self.reason is not None:
            d["reason"] = self.reason
        return d


@dataclasses.dataclass
class Suppression:
    line: int  # line the suppression APPLIES to
    rules: Tuple[str, ...]
    reason: str
    comment_line: int
    used: bool = False


class ModuleInfo:
    """One parsed source file: AST + raw lines + suppressions."""

    def __init__(self, rel: str, source: str):
        self.rel = rel  # posix, relative to the scan root
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        self.suppressions: List[Suppression] = []
        self.bad_suppressions: List[Tuple[int, str]] = []
        try:
            self.tree = ast.parse(source, filename=rel)
        except SyntaxError as e:  # surfaced as a PARSE_ERROR finding
            self.parse_error = f"syntax error: {e.msg} (line {e.lineno})"
            return
        self._collect_suppressions()

    # -- suppressions -----------------------------------------------------

    def _collect_suppressions(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except tokenize.TokenError:
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT or SUPPRESS_TAG not in tok.string:
                continue
            lineno, col = tok.start
            text = tok.string
            body = text.split(SUPPRESS_TAG, 1)[1].strip()
            parsed = self._parse_suppression(body)
            if parsed is None:
                self.bad_suppressions.append(
                    (lineno,
                     "malformed suppression: expected "
                     "'# nf-lint: disable=<rule>[,<rule>] -- <reason>'"))
                continue
            rules, reason = parsed
            # a comment alone on its line applies to the next CODE line
            # (continuation comment lines — a wrapped reason — and
            # blanks are skipped); trailing a statement it applies to
            # that statement's line
            prefix = self.lines[lineno - 1][:col] if lineno <= len(self.lines) else ""
            if not prefix.strip():
                target = lineno + 1
                while target <= len(self.lines):
                    stripped = self.lines[target - 1].strip()
                    if stripped and not stripped.startswith("#"):
                        break
                    target += 1
            else:
                target = lineno
            self.suppressions.append(
                Suppression(line=target, rules=rules, reason=reason,
                            comment_line=lineno))

    @staticmethod
    def _parse_suppression(body: str) -> Optional[Tuple[Tuple[str, ...], str]]:
        if not body.startswith("disable="):
            return None
        body = body[len("disable="):]
        if "--" not in body:
            return None  # reason is mandatory
        rules_part, reason = body.split("--", 1)
        reason = reason.strip()
        rules = tuple(r.strip() for r in rules_part.split(",") if r.strip())
        if not rules or not reason:
            return None
        return rules, reason

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        for s in self.suppressions:
            if s.line == line and rule in s.rules:
                return s
        return None


class PackageContext:
    """Every parsed module under the scan root, plus lazy cross-file
    indexes (built by callgraph.py on first use)."""

    def __init__(self, root: Path,
                 overrides: Optional[Dict[str, str]] = None):
        self.root = Path(root)
        self.modules: Dict[str, ModuleInfo] = {}
        self._index = None  # callgraph.PackageIndex, built lazily
        overrides = dict(overrides or {})
        for path in sorted(self.root.rglob("*.py")):
            rel = path.relative_to(self.root).as_posix()
            src = overrides.pop(rel, None)
            if src is None:
                src = path.read_text(encoding="utf-8")
            self.modules[rel] = ModuleInfo(rel, src)
        for rel, src in sorted(overrides.items()):  # purely-virtual files
            self.modules[rel] = ModuleInfo(rel, src)

    @property
    def index(self):
        if self._index is None:
            from .callgraph import PackageIndex

            self._index = PackageIndex(self)
        return self._index


class Rule(ast.NodeVisitor):
    """Base class for lint rules.

    Subclasses set ``name``/``description`` and either implement
    ``visit_*`` methods (per-module mode: the engine calls :meth:`run`
    once per in-scope file) or set ``per_module = False`` and override
    :meth:`run_package` for whole-package analyses (call graphs,
    dispatch tables).

    ``scope`` is a tuple of fnmatch globs over root-relative posix
    paths; empty means every ``*.py`` under the root.
    """

    name: str = ""
    description: str = ""
    scope: Tuple[str, ...] = ()
    per_module: bool = True

    def __init__(self) -> None:
        self.findings: List[Finding] = []
        self.module: Optional[ModuleInfo] = None
        self.ctx: Optional[PackageContext] = None

    # -- scoping ----------------------------------------------------------

    def applies(self, rel: str) -> bool:
        if not self.scope:
            return True
        return any(fnmatch.fnmatch(rel, pat) for pat in self.scope)

    # -- drivers ----------------------------------------------------------

    def run(self, module: ModuleInfo, ctx: PackageContext) -> List[Finding]:
        self.findings = []
        self.module = module
        self.ctx = ctx
        if module.tree is not None:
            self.check_module(module, ctx)
        return self.findings

    def check_module(self, module: ModuleInfo, ctx: PackageContext) -> None:
        """Default per-module driver: visit the AST."""
        self.visit(module.tree)

    def run_package(self, ctx: PackageContext) -> List[Finding]:
        """Whole-package driver for ``per_module = False`` rules."""
        raise NotImplementedError

    # -- reporting --------------------------------------------------------

    def flag(self, node, message: str, path: Optional[str] = None) -> None:
        line = getattr(node, "lineno", node if isinstance(node, int) else 0)
        self.findings.append(
            Finding(rule=self.name, path=path or self.module.rel,
                    line=line, message=message))


# -- helpers shared by several rules --------------------------------------

def dotted_name(node) -> Optional[str]:
    """Attribute/Name chain as 'a.b.c', or None for dynamic expressions."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- baseline -------------------------------------------------------------

def load_baseline(path: Optional[Path]) -> Dict[str, dict]:
    if path is None or not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    return {e["rule"] + "::" + e["path"] + "::" + e["message"]: e
            for e in data.get("findings", ())}


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    entries = [
        {"rule": f.rule, "path": f.path, "line": f.line,
         "message": f.message}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    ]
    payload = {
        "version": 1,
        "comment": "real-but-deferred nf-lint findings; regenerate with "
                   "`python -m noahgameframe_tpu_torch.lint --update-baseline`",
        "findings": entries,
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n",
                          encoding="utf-8")


# -- report ---------------------------------------------------------------

@dataclasses.dataclass
class Report:
    root: str
    rules: List[str]
    findings: List[Finding]
    stale_baseline: List[str]

    @property
    def open_findings(self) -> List[Finding]:
        return [f for f in self.findings if f.status == "open"]

    def to_json(self) -> dict:
        counts = {"total": len(self.findings)}
        for st in ("open", "suppressed", "baselined"):
            counts[st] = sum(1 for f in self.findings if f.status == st)
        return {
            "version": 1,
            "root": self.root,
            "rules": list(self.rules),
            "counts": counts,
            "findings": [f.to_json() for f in sorted(
                self.findings, key=lambda f: (f.path, f.line, f.rule))],
            "stale_baseline": list(self.stale_baseline),
        }


def run_lint(root: Path,
             rules: Sequence[type] = None,
             rule_filter: Optional[Sequence[str]] = None,
             baseline_path: Optional[Path] = None,
             overrides: Optional[Dict[str, str]] = None) -> Report:
    """Run ``rules`` (classes) over every ``*.py`` under ``root``.

    ``rule_filter`` keeps only the named rules (engine-level findings —
    suppression hygiene, parse errors — always run).  ``overrides`` maps
    root-relative paths to replacement source text, letting tests inject
    a violation into a real module without touching disk.
    """
    if rules is None:
        from . import ALL_RULES

        rules = ALL_RULES
    selected = [cls for cls in rules
                if not rule_filter or cls.name in rule_filter]
    if rule_filter:
        known = {cls.name for cls in rules}
        unknown = [r for r in rule_filter if r not in known]
        if unknown:
            raise ValueError(f"unknown rule(s): {', '.join(unknown)}")
    ctx = PackageContext(root, overrides=overrides)
    findings: List[Finding] = []

    for rel, mod in ctx.modules.items():
        if mod.parse_error is not None:
            findings.append(Finding(PARSE_ERROR, rel, 0, mod.parse_error))
        for lineno, msg in mod.bad_suppressions:
            findings.append(Finding(BAD_SUPPRESSION, rel, lineno, msg))

    for cls in selected:
        rule = cls()
        if rule.per_module:
            for rel, mod in ctx.modules.items():
                if rule.applies(rel):
                    findings.extend(rule.run(mod, ctx))
        else:
            rule.ctx = ctx
            findings.extend(rule.run_package(ctx))

    # dedupe: one line can trip a rule twice (float(r) * float(r)) and
    # call-graph rules can reach a function through several roots
    seen: set = set()
    unique: List[Finding] = []
    for f in findings:
        ident = (f.rule, f.path, f.line, f.message)
        if ident not in seen:
            seen.add(ident)
            unique.append(f)
    findings = unique

    # suppression matching (engine findings are never suppressible:
    # a suppression of "unused-suppression" would be self-defeating)
    engine_rules = {UNUSED_SUPPRESSION, BAD_SUPPRESSION, PARSE_ERROR}
    for f in findings:
        if f.rule in engine_rules:
            continue
        mod = ctx.modules.get(f.path)
        if mod is None:
            continue
        sup = mod.suppression_for(f.rule, f.line)
        if sup is not None:
            sup.used = True
            f.status = "suppressed"
            f.reason = sup.reason

    # unused suppressions — only for rules that actually ran, so a
    # --rule-filtered run doesn't misreport every other waiver as stale
    ran = {cls.name for cls in selected}
    for rel, mod in ctx.modules.items():
        for sup in mod.suppressions:
            if sup.used or not (set(sup.rules) & ran):
                continue
            findings.append(Finding(
                UNUSED_SUPPRESSION, rel, sup.comment_line,
                f"suppression of {','.join(sup.rules)} matches no finding"))

    # baseline
    baseline = load_baseline(baseline_path)
    matched = set()
    for f in findings:
        if f.status == "open" and f.key() in baseline:
            f.status = "baselined"
            matched.add(f.key())
    stale = sorted(set(baseline) - matched)

    return Report(root=str(root), rules=[cls.name for cls in selected],
                  findings=findings, stale_baseline=stale)
