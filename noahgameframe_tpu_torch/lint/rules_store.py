"""Store/migration coverage contract (the JAX package's rule, unchanged;
the port's spec is ``persist/rowblob.py:ROW_LEAF_SPEC``).

The unified mesh engine moves an entity between shards as a FULL
``ClassState`` row: every leaf ``persist/rowblob.py``'s walk yields is
packed, ppermuted and scatter-inserted.  The walk is generic — it
recurses ``dataclasses.fields`` — so a bank added to ``ClassState`` (or
``TimerState``/``RecordState``) is picked up automatically at trace
time.  What the runtime cannot see is INTENT: ``ROW_LEAF_SPEC`` is the
reviewed enumeration of what a row IS, and ``MIGRATION_EXCLUDED`` the
waivered exclusions (must stay empty while caches live in
``WorldState.aux``).  This rule cross-checks the two statically: every
store field must be enumerated (or explicitly waivered), and every spec
entry must still name a real field — the static complement of the
check in ``class_row_leaf_items``, and the migration twin of the
off-device session-blob re-home, which shares the same walk.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Dict, List, Optional, Tuple

from .engine import Finding, ModuleInfo, PackageContext, Rule

STORE_SUFFIX = "core/store.py"
SPEC_SUFFIX = "persist/rowblob.py"

#: ClassState fields holding nested row-axis dataclasses, and how their
#: leaves appear as dotted spec paths
_NESTED = {"TimerState": "{field}.{leaf}", "RecordState": "{field}.*.{leaf}"}


def _find_module(ctx: PackageContext, suffix: str) -> Optional[ModuleInfo]:
    for rel, mod in ctx.modules.items():
        if rel == suffix or rel.endswith("/" + suffix):
            return mod
    return None


def _dataclass_fields(tree) -> Dict[str, List[Tuple[str, ast.AnnAssign]]]:
    """name -> [(field, AnnAssign node)] for every class in the module."""
    out: Dict[str, List[Tuple[str, ast.AnnAssign]]] = {}
    for n in tree.body:
        if isinstance(n, ast.ClassDef):
            out[n.name] = [
                (s.target.id, s) for s in n.body
                if isinstance(s, ast.AnnAssign)
                and isinstance(s.target, ast.Name)
            ]
    return out


def _literal_str_tuple(tree, name: str):
    """(values, node) for a module-level ``NAME = ("a", "b", ...)``
    literal; (None, node) when the assignment exists but is not a plain
    literal tuple/list of strings; (None, None) when absent."""
    for n in tree.body:
        targets = []
        if isinstance(n, ast.Assign):
            targets, value = n.targets, n.value
        elif isinstance(n, ast.AnnAssign) and n.value is not None:
            targets, value = [n.target], n.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                if isinstance(value, (ast.Tuple, ast.List)) and all(
                    isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in value.elts
                ):
                    return [e.value for e in value.elts], n
                return None, n
    return None, None


class MigrateCoversStoreRule(Rule):
    """Every ClassState leaf is enumerated by the migration pack spec
    (or carries a waivered exclusion), and the spec names no field that
    no longer exists — a bank silently left behind by cross-shard
    migration corrupts the entity on arrival."""

    name = "migrate-covers-store"
    description = ("persist/rowblob.py ROW_LEAF_SPEC (+ MIGRATION_"
                   "EXCLUDED) must enumerate every ClassState leaf in "
                   "core/store.py, and name only leaves that exist.")
    per_module = False

    def run_package(self, ctx: PackageContext) -> List[Finding]:
        self.findings = []
        store = _find_module(ctx, STORE_SUFFIX)
        spec_mod = _find_module(ctx, SPEC_SUFFIX)
        if store is None or spec_mod is None:
            return self.findings  # contract pair absent: out of scope
        if store.tree is None or spec_mod.tree is None:
            return self.findings  # parse-error finding already emitted

        classes = _dataclass_fields(store.tree)
        if "ClassState" not in classes:
            self.flag(1, "ClassState vanished from core/store.py — the "
                      "migration coverage contract has nothing to hold "
                      "onto", path=store.rel)
            return self.findings
        expected: Dict[str, ast.AnnAssign] = {}
        for field, node in classes["ClassState"]:
            ann = ast.unparse(node.annotation)
            nested = next((c for c in _NESTED if c in ann), None)
            if nested is None:
                expected[field] = node
                continue
            for leaf, _sub in classes.get(nested, []):
                expected[_NESTED[nested].format(field=field,
                                                leaf=leaf)] = node
            if not classes.get(nested):
                self.flag(node, f"nested row dataclass `{nested}` for "
                          f"field `{field}` has no resolvable fields",
                          path=store.rel)

        spec, spec_node = _literal_str_tuple(spec_mod.tree,
                                             "ROW_LEAF_SPEC")
        excl, excl_node = _literal_str_tuple(spec_mod.tree,
                                             "MIGRATION_EXCLUDED")
        if spec_node is None:
            self.flag(1, "ROW_LEAF_SPEC vanished from persist/rowblob.py",
                      path=spec_mod.rel)
            return self.findings
        if spec is None:
            self.flag(spec_node, "ROW_LEAF_SPEC must be a literal tuple "
                      "of strings — a computed spec cannot be reviewed "
                      "statically", path=spec_mod.rel)
            return self.findings
        if excl_node is not None and excl is None:
            self.flag(excl_node, "MIGRATION_EXCLUDED must be a literal "
                      "tuple of strings", path=spec_mod.rel)
            excl = []
        excl = excl or []

        patterns = list(spec) + list(excl)
        for path, node in sorted(expected.items()):
            if not any(fnmatch.fnmatch(path, pat) for pat in patterns):
                self.flag(node, f"store leaf `{path}` is not covered by "
                          "ROW_LEAF_SPEC or MIGRATION_EXCLUDED — "
                          "cross-shard migration would silently leave "
                          "this bank behind", path=store.rel)
        for pat in patterns:
            if not any(fnmatch.fnmatch(path, pat) for path in expected):
                where = spec_node if pat in spec else (excl_node
                                                       or spec_node)
                self.flag(where, f"spec entry `{pat}` matches no "
                          "ClassState leaf — stale after a store "
                          "refactor", path=spec_mod.rel)
        return self.findings
