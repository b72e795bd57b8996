"""Room-batch coverage contract (the JAX package's rule, unchanged).

The many-worlds engine stacks FULL ``WorldState`` pytrees along a
leading room axis: every leaf ``parallel/rooms.py``'s walk yields is
broadcast into the batch, scattered on admit and gathered on extract.
Like the migration walk, the runtime recursion is generic — a bank
added to the store is picked up automatically at trace time — so the
reviewed INTENT lives in two literals: ``ROOM_PACK_SPEC`` enumerates
what a room IS, and ``ROOM_EXCLUDED`` waivers the leaves deliberately
left out of re-home blobs (the ``aux.*`` caches, rebuilt from blanks on
admit).  This rule is the static complement of the trace-time assertion
in ``world_room_leaf_items``: every ``WorldState`` leaf must be
enumerated or waivered, and every spec entry must still name a real
leaf — a store bank the room walk silently skips would be wiped on
re-home, and a stale entry hides the next real gap.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Dict, List

from .engine import Finding, PackageContext, Rule
from .rules_store import (
    _NESTED,
    _dataclass_fields,
    _find_module,
    _literal_str_tuple,
)

STORE_SUFFIX = "core/store.py"
ROOMS_SUFFIX = "parallel/rooms.py"


class RoomAxisCoveredRule(Rule):
    """Every WorldState leaf is enumerated by the room pack spec (or
    carries a waivered exclusion), and the spec names no leaf that no
    longer exists — a bank the room walk skips is silently zeroed the
    first time its room is re-homed across engines."""

    name = "room-axis-covered"
    description = ("parallel/rooms.py ROOM_PACK_SPEC (+ ROOM_EXCLUDED) "
                   "must enumerate every WorldState leaf in "
                   "core/store.py, and name only leaves that exist.")
    per_module = False

    def run_package(self, ctx: PackageContext) -> List[Finding]:
        self.findings = []
        store = _find_module(ctx, STORE_SUFFIX)
        rooms_mod = _find_module(ctx, ROOMS_SUFFIX)
        if store is None or rooms_mod is None:
            return self.findings  # contract pair absent: out of scope
        if store.tree is None or rooms_mod.tree is None:
            return self.findings  # parse-error finding already emitted

        classes = _dataclass_fields(store.tree)
        if "WorldState" not in classes:
            self.flag(1, "WorldState vanished from core/store.py — the "
                      "room-axis coverage contract has nothing to hold "
                      "onto", path=store.rel)
            return self.findings

        # expand WorldState fields into the dotted paths the room walk
        # yields: classes.* recurses ClassState (sharing the migration
        # rule's nested-dataclass table), other Dict fields are keyed
        # collections (aux.*), the rest are plain scalar/array leaves
        expected: Dict[str, ast.AnnAssign] = {}
        for field, node in classes["WorldState"]:
            # strip quotes so stringified annotations compare the same
            ann = ast.unparse(node.annotation).strip("'\"")
            if "ClassState" in ann:
                for leaf, sub in classes.get("ClassState", []):
                    leaf_ann = ast.unparse(sub.annotation)
                    nested = next((c for c in _NESTED if c in leaf_ann),
                                  None)
                    if nested is None:
                        expected[f"{field}.*.{leaf}"] = node
                        continue
                    for inner, _n in classes.get(nested, []):
                        path = _NESTED[nested].format(field=leaf,
                                                      leaf=inner)
                        expected[f"{field}.*.{path}"] = node
                if not classes.get("ClassState"):
                    self.flag(node, "ClassState has no resolvable fields "
                              f"to expand `{field}` with", path=store.rel)
            elif ann.startswith(("Dict", "dict")):
                expected[f"{field}.*"] = node
            else:
                expected[field] = node

        spec, spec_node = _literal_str_tuple(rooms_mod.tree,
                                             "ROOM_PACK_SPEC")
        excl, excl_node = _literal_str_tuple(rooms_mod.tree,
                                             "ROOM_EXCLUDED")
        if spec_node is None:
            self.flag(1, "ROOM_PACK_SPEC vanished from parallel/rooms.py",
                      path=rooms_mod.rel)
            return self.findings
        if spec is None:
            self.flag(spec_node, "ROOM_PACK_SPEC must be a literal tuple "
                      "of strings — a computed spec cannot be reviewed "
                      "statically", path=rooms_mod.rel)
            return self.findings
        if excl_node is not None and excl is None:
            self.flag(excl_node, "ROOM_EXCLUDED must be a literal tuple "
                      "of strings", path=rooms_mod.rel)
            excl = []
        excl = excl or []

        patterns = list(spec) + list(excl)
        for path, node in sorted(expected.items()):
            if not any(fnmatch.fnmatch(path, pat) for pat in patterns):
                self.flag(node, f"store leaf `{path}` is not covered by "
                          "ROOM_PACK_SPEC or ROOM_EXCLUDED — re-homing a "
                          "room would silently wipe this bank",
                          path=store.rel)
        for pat in patterns:
            if not any(fnmatch.fnmatch(path, pat) for path in expected):
                where = spec_node if pat in spec else (excl_node
                                                      or spec_node)
                self.flag(where, f"spec entry `{pat}` matches no "
                          "WorldState leaf — stale after a store "
                          "refactor", path=rooms_mod.rel)
        return self.findings
