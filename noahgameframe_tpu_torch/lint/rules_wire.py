"""Wire/codec consistency rules: the JAX package's ``lint/rules_wire.py``
on the port.  Both rules scan every module, so the files into which the
port splits the reference's ``net/roles/game.py``
(``game_{handlers,interest,session,switch,sync}.py``) are covered like
the rest; a handler named on a mixin resolves through ``GameRole``'s
package-resolvable bases.

Two hazard classes:

- **struct-codec**: every ``struct`` format string must parse, its
  ``calcsize`` must match any paired length constant (``_HEAD`` ↔
  ``HEAD_LENGTH``, ``X = _STRUCT.size  # 52 bytes``), and tuple
  destructures of ``unpack`` (and argument lists of ``pack``) must
  match the format's field count.  This is how the ``>HII`` journal/WAL
  framing and the 52-byte ``<BBHIIQQQQQ`` trace codec stay honest when
  someone adds a field to one side of the wire.
- **dispatch-handler**: every opcode registered on a dispatch table
  (``server.on(MsgID.X, self._handler)``) must reference a handler
  that actually exists — a renamed method otherwise fails at role
  startup (or worse, only when the first frame of that opcode lands).
"""

from __future__ import annotations

import ast
import re
import struct as _struct
from typing import Dict, List, Optional

from .engine import Rule, dotted_name

_BYTES_COMMENT = re.compile(r"#[^#]*?\b(\d+)\s*bytes?\b")
_CONST_SUFFIXES = ("_LENGTH", "_SIZE", "_LEN", "_BYTES")


def _field_count(fmt: str) -> int:
    """Number of Python values a format packs/unpacks."""
    n = 0
    count: Optional[int] = None
    for ch in fmt:
        if ch in "<>=!@ ":
            continue
        if ch.isdigit():
            count = (count or 0) * 10 + int(ch)
            continue
        if ch == "x":
            pass  # pad bytes produce no value
        elif ch in "sp":
            n += 1  # a counted string is ONE value
        else:
            n += count if count is not None else 1
        count = None
    return n


def _struct_base(var: str) -> str:
    base = var.lstrip("_")
    for suf in ("_STRUCT", "_FMT", "_HEAD"):
        if base.endswith(suf) and base != suf:
            base = base[: -len(suf)]
    return base


class StructCodecRule(Rule):
    """Format-string / length-constant / arity consistency."""

    name = "struct-codec"
    description = ("struct formats must parse; calcsize must equal paired "
                   "*_LENGTH/_SIZE constants and '# N bytes' comments; "
                   "unpack destructures and pack argument lists must "
                   "match the field count.")

    def check_module(self, module, ctx):
        tree = module.tree
        struct_vars: Dict[str, str] = {}  # var -> fmt (module level)
        int_consts: Dict[str, int] = {}
        # pass 1: module-level bindings
        for node in tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                    or not isinstance(node.targets[0], ast.Name):
                continue
            name = node.targets[0].id
            fmt = self._struct_ctor_fmt(node.value)
            if fmt is not None:
                struct_vars[name] = fmt
            elif isinstance(node.value, ast.Constant) \
                    and type(node.value.value) is int:
                int_consts[name] = node.value.value
        # pass 2: every struct call in the file
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self._check_call(node, struct_vars)
            elif isinstance(node, ast.Assign):
                self._check_unpack_assign(node, struct_vars)
        # pass 3: paired length constants
        for var, fmt in struct_vars.items():
            size = self._calcsize(None, fmt)
            if size is None:
                continue
            base = _struct_base(var)
            for cname in [base + s for s in _CONST_SUFFIXES] \
                    + [_struct_base(base) + s for s in _CONST_SUFFIXES]:
                if cname in int_consts and int_consts[cname] != size:
                    self.flag(self._line_of(tree, var),
                              f"`{var}` packs {size} bytes ({fmt!r}) but "
                              f"paired constant {cname} = "
                              f"{int_consts[cname]}")
        # pass 4: '# N bytes' trailing comments on struct/size lines
        self._check_size_comments(module, struct_vars)

    # -- helpers ----------------------------------------------------------

    def _struct_ctor_fmt(self, value) -> Optional[str]:
        if not isinstance(value, ast.Call):
            return None
        d = dotted_name(value.func)
        if d is None or d.split(".")[-1] != "Struct":
            return None
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            return value.args[0].value
        return None

    def _calcsize(self, node, fmt: str) -> Optional[int]:
        try:
            return _struct.calcsize(fmt)
        except _struct.error as e:
            if node is not None:
                self.flag(node, f"invalid struct format {fmt!r}: {e}")
            return None

    def _line_of(self, tree, var: str) -> int:
        for node in tree.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == var:
                return node.lineno
        return 1

    def _call_fmt(self, node: ast.Call,
                  struct_vars: Dict[str, str]):
        """(fmt, n_fixed_args) for struct.pack/unpack/Struct-method calls."""
        d = dotted_name(node.func)
        if d is None:
            return None
        parts = d.split(".")
        leaf = parts[-1]
        if leaf not in ("pack", "unpack", "unpack_from", "pack_into",
                        "calcsize", "iter_unpack", "Struct"):
            return None
        if len(parts) == 2 and parts[0] in struct_vars:
            return struct_vars[parts[0]], 0  # V.pack(...) — fmt bound
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            return node.args[0].value, 1  # struct.pack(fmt, ...)
        return None

    def _check_call(self, node: ast.Call, struct_vars) -> None:
        got = self._call_fmt(node, struct_vars)
        if got is None:
            return
        fmt, n_fmt_args = got
        size = self._calcsize(node, fmt)
        if size is None:
            return
        d = dotted_name(node.func)
        leaf = d.split(".")[-1]
        if leaf == "pack" and not any(
                isinstance(a, ast.Starred) for a in node.args):
            supplied = len(node.args) - n_fmt_args
            want = _field_count(fmt)
            if supplied != want:
                self.flag(node, f"pack({fmt!r}) takes {want} values, "
                          f"{supplied} supplied")

    def _check_unpack_assign(self, node: ast.Assign, struct_vars) -> None:
        if not isinstance(node.value, ast.Call):
            return
        got = self._call_fmt(node.value, struct_vars)
        if got is None:
            return
        d = dotted_name(node.value.func)
        if d.split(".")[-1] not in ("unpack", "unpack_from"):
            return
        fmt, _ = got
        if self._calcsize(None, fmt) is None:
            return
        want = _field_count(fmt)
        for tgt in node.targets:
            if isinstance(tgt, ast.Tuple) and not any(
                    isinstance(e, ast.Starred) for e in tgt.elts):
                if len(tgt.elts) != want:
                    self.flag(node, f"unpack({fmt!r}) yields {want} "
                              f"values, {len(tgt.elts)} targets")

    def _check_size_comments(self, module, struct_vars) -> None:
        for node in module.tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                    or not isinstance(node.targets[0], ast.Name):
                continue
            line = module.lines[node.lineno - 1] \
                if node.lineno <= len(module.lines) else ""
            m = _BYTES_COMMENT.search(line)
            if not m:
                continue
            claimed = int(m.group(1))
            fmt = self._struct_ctor_fmt(node.value)
            if fmt is None:
                # X = V.size  # N bytes
                d = dotted_name(node.value)
                if d is None:
                    continue
                parts = d.split(".")
                if len(parts) == 2 and parts[1] == "size" \
                        and parts[0] in struct_vars:
                    fmt = struct_vars[parts[0]]
            if fmt is None:
                continue
            size = self._calcsize(None, fmt)
            if size is not None and size != claimed:
                self.flag(node, f"comment claims {claimed} bytes but "
                          f"{fmt!r} packs {size}")


_REG_LEAVES = {"on", "on_any", "on_socket_event"}


class DispatchHandlerRule(Rule):
    """Registered opcodes must reference handlers that exist."""

    name = "dispatch-handler"
    description = ("Every `X.on(msg_id, handler)` registration must point "
                   "at a resolvable handler (method/function/lambda/"
                   "partial) — a renamed handler otherwise dies at role "
                   "startup or on first frame.")

    def check_module(self, module, ctx):
        self._cls_stack: List[str] = []
        self._local_defs: List[set] = []
        self.visit(module.tree)

    def visit_ClassDef(self, node):
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _visit_fn(self, node):
        nested = {n.name for n in ast.walk(node)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # parameters count: wrapper methods forward `fn` straight through
        # (net/module.py `def on(self, msg_id, fn): self.dispatch.on(...)`)
        a = node.args
        nested |= {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
        if a.vararg:
            nested.add(a.vararg.arg)
        if a.kwarg:
            nested.add(a.kwarg.arg)
        self._local_defs.append(nested)
        self.generic_visit(node)
        self._local_defs.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Call(self, node):
        d = dotted_name(node.func)
        if d is not None and d.split(".")[-1] in _REG_LEAVES:
            leaf = d.split(".")[-1]
            handler = None
            if leaf == "on" and len(node.args) == 2:
                handler = node.args[1]
            elif leaf in ("on_any", "on_socket_event") \
                    and len(node.args) == 1:
                handler = node.args[0]
            if handler is not None:
                self._check_handler(node, handler)
        self.generic_visit(node)

    def _check_handler(self, node, handler) -> None:
        if isinstance(handler, ast.Lambda):
            return
        if isinstance(handler, ast.Call):
            # handler factory: self._on_register(ServerType.WORLD) — the
            # factory itself must resolve
            self._check_handler(node, handler.func)
            return
        if isinstance(handler, ast.Attribute):
            d = dotted_name(handler)
            if d is None:
                return
            parts = d.split(".")
            if parts[0] == "self" and len(parts) == 2 and self._cls_stack:
                if not self._self_method_exists(parts[1]):
                    self.flag(node, f"opcode registered with handler "
                              f"`{d}` but no such method exists on "
                              f"{self._cls_stack[-1]} (or its "
                              "package-resolvable bases)")
            return
        if isinstance(handler, ast.Name):
            if any(handler.id in s for s in self._local_defs):
                return
            syms = self.ctx.index.by_rel.get(self.module.rel)
            if syms is not None and (handler.id in syms.funcs
                                     or handler.id in syms.classes
                                     or handler.id in syms.imports):
                return
            self.flag(node, f"opcode registered with handler "
                      f"`{handler.id}` which is not defined in this "
                      "module")

    def _self_method_exists(self, name: str) -> bool:
        index = self.ctx.index
        syms = index.by_rel.get(self.module.rel)
        if syms is None:
            return True  # unindexed (parse issue) — don't guess
        ci = syms.classes.get(self._cls_stack[-1])
        if ci is None:
            return True
        if index.method_on(ci, name) is not None:
            return True
        # assigned callables (self.handler = ... in __init__) count
        for m in ci.methods.values():
            for n in ast.walk(m.node):
                if isinstance(n, ast.Attribute) and n.attr == name \
                        and isinstance(n.ctx, ast.Store):
                    return True
        return False
