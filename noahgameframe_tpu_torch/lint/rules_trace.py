"""Captured-step rules: capture-safety and recapture hazards.

The port's counterparts of the JAX package's ``trace-safety`` and
``recompile-hazard``.  Both walk the call graph of :mod:`.callgraph`
from the roots whose steps are captured or batched
(:data:`CAPTURED_KINDS`: a cost-book dispatcher that may record a CUDA
graph — the tick, the train, the rooms step —, every kernel phase, and
every ``torch.func.vmap`` target), because that is where a host sync or
a data-dependent shape either breaks the capture outright (a sync is
refused while a stream captures) or stalls the pipeline the graph exists
to keep full.  An eager dispatcher (``graph=False``, such as the sharded
tick's or the interest queries') is no such root: it runs its step as it
is on every call.

What counts as tensor-rooted (a parameter of a reached function, and
every name a plain assignment derives from one) follows the reference's
tracer proxy, with the port's refinements, each pinned by a fixture:

- a parameter annotated with a host type (``int``, ``Optional[int]``,
  ``Sequence[Tuple[int, int]]``, ...) or defaulting to a Python scalar
  is a declared host value;
- only names that an assignment binds are derived: an enum member
  inside a subscript target (``x[:, int(Group.BUFF)] = v``) is not;
- inside the negative branch of ``isinstance(x, torch.Tensor)`` (an
  ``else``, an ``if not isinstance``, a conditional expression's other
  arm), ``x`` is no tensor.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import (
    ClassInfo,
    FuncInfo,
    TracedFunc,
    VMAP_KINDS,
    captured_reachable,
)
from .engine import Finding, PackageContext, Rule, dotted_name

#: names whose appearance in an enclosing ``if`` test sanctions a host
#: sync: the stage clock's honest-device-timing span (NF_STAGE_TIMING)
_SANCTION_MARKERS = ("stage_timing", "NF_STAGE_TIMING")

#: no-argument tensor methods that copy to the host (a sync)
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
#: calls whose output size depends on the data (no static size)
_DYNAMIC_SIZE = {"nonzero", "masked_select", "argwhere"}
#: constructors whose arguments are a shape
_SHAPE_FNS = {"arange", "zeros", "ones", "full", "empty", "linspace",
              "new_zeros", "new_ones", "new_full", "new_empty"}
#: calls that yield a bool mask
_MASK_FNS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or",
             "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt",
             "ge", "isin"}
#: annotation names that declare a host value
_HOST_TYPES = {"int", "float", "bool", "str", "bytes", "Optional",
               "Sequence", "Tuple", "List", "Dict", "Mapping", "Iterable",
               "Union", "tuple", "list", "dict", "set", "frozenset",
               "FrozenSet", "Set"}
_DTYPE_NAMES = {"float16", "bfloat16", "float32", "float64", "float",
                "double", "half", "int8", "int16", "int32", "int64",
                "uint8", "uint16", "uint32", "uint64", "int", "long",
                "short", "bool", "complex64", "complex128"}

#: the kinds whose steps a CUDA graph captures (an eager dispatcher
#: re-reads its closure on every call)
CAPTURED_KINDS = ("graph", "phase", "vmap")


def _host_declared(arg: ast.arg) -> bool:
    """A parameter annotated with a type built only from Python scalars
    and containers is a DECLARED host value: converting it is sizing
    math, not a device sync."""
    ann = arg.annotation
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    names = [x.id for x in ast.walk(ann) if isinstance(x, ast.Name)]
    names += [x.attr for x in ast.walk(ann) if isinstance(x, ast.Attribute)]
    consts = [x for x in ast.walk(ann) if isinstance(x, ast.Constant)]
    return bool(names) and all(n in _HOST_TYPES for n in names) \
        and all(c.value is None or c.value is Ellipsis for c in consts)


def _store_names(target) -> List[str]:
    """Names an assignment target binds (tuple/list/starred unpacking),
    not the names read inside a subscript or attribute target."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _store_names(e)]
    if isinstance(target, ast.Starred):
        return _store_names(target.value)
    return []


def _tainted_names(fn_node) -> Set[str]:
    """Tensor-rooted names: parameters (minus ``self`` and declared host
    values) and, to a fixpoint, every name a plain assignment binds from
    one."""
    args = fn_node.args
    pos = args.posonlyargs + args.args
    host = {a.arg for a in pos + args.kwonlyargs if _host_declared(a)}
    for a, dflt in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        if isinstance(dflt, ast.Constant) \
                and isinstance(dflt.value, (int, float, bool, str)):
            host.add(a.arg)
    for a, dflt in zip(args.kwonlyargs, args.kw_defaults):
        if isinstance(dflt, ast.Constant) \
                and isinstance(dflt.value, (int, float, bool, str)):
            host.add(a.arg)
    names = {a.arg for a in (pos + args.kwonlyargs)} - host
    names |= {a.arg for a in (args.vararg, args.kwarg) if a is not None}
    names.discard("self")
    if isinstance(fn_node, ast.Lambda):
        return names
    for _ in range(8):
        grew = False
        for node in ast.walk(fn_node):
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(x, ast.Name) and x.id in names
                       for x in ast.walk(node.value)):
                continue
            for tgt in node.targets:
                for n in _store_names(tgt):
                    if n not in names:
                        names.add(n)
                        grew = True
        if not grew:
            break
    return names


def _tensor_check(test) -> Optional[Tuple[str, bool]]:
    """(name, positive) for ``isinstance(name, torch.Tensor)`` (positive)
    or ``not isinstance(...)`` (negative), else None."""
    positive = True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        positive, test = False, test.operand
    if not (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
            and test.func.id == "isinstance" and len(test.args) == 2
            and isinstance(test.args[0], ast.Name)):
        return None
    kinds = test.args[1].elts if isinstance(test.args[1], ast.Tuple) \
        else [test.args[1]]
    if any((dotted_name(k) or "").split(".")[-1] == "Tensor" for k in kinds):
        return test.args[0].id, positive
    return None


class _TracedScan(ast.NodeVisitor):
    """Shared captured-function walker: NF_STAGE_TIMING sanctioning and
    the isinstance-negative branches."""

    def __init__(self, rule: Rule, tf: TracedFunc):
        self.rule = rule
        self.tf = tf
        self.tainted = _tainted_names(tf.info.node)
        self._sanction_depth = 0
        self._not_tensor: List[str] = []

    def scan(self) -> None:
        node = self.tf.info.node
        body = node.body if isinstance(node.body, list) else [node.body]
        for stmt in body:
            self.visit(stmt)

    def rooted(self, expr) -> bool:
        """Is ``expr`` derived from a tensor-rooted name here?"""
        for x in ast.walk(expr):
            if isinstance(x, ast.Name) and x.id in self.tainted \
                    and x.id not in self._not_tensor:
                return True
        return False

    def _sanctioned_test(self, test) -> bool:
        for x in ast.walk(test):
            if isinstance(x, ast.Name) and any(
                    m in x.id for m in _SANCTION_MARKERS):
                return True
            if isinstance(x, ast.Attribute) and any(
                    m in x.attr for m in _SANCTION_MARKERS):
                return True
            if isinstance(x, ast.Constant) and isinstance(x.value, str) \
                    and "NF_STAGE_TIMING" in x.value:
                return True
        return False

    def _visit_block(self, stmts, not_tensor: Optional[str]) -> None:
        if not_tensor is not None:
            self._not_tensor.append(not_tensor)
        for stmt in stmts:
            self.visit(stmt)
        if not_tensor is not None:
            self._not_tensor.pop()

    def visit_If(self, node):
        check = _tensor_check(node.test)
        name, positive = check if check else (None, True)
        self.visit(node.test)
        if self._sanctioned_test(node.test):
            self._sanction_depth += 1
            self._visit_block(node.body, None)
            self._sanction_depth -= 1
        else:
            self._visit_block(node.body, None if positive else name)
        self._visit_block(node.orelse, name if positive else None)

    def visit_IfExp(self, node):
        check = _tensor_check(node.test)
        name, positive = check if check else (None, True)
        self.visit(node.test)
        self._visit_block([node.body], None if positive else name)
        self._visit_block([node.orelse], name if positive else None)

    def visit_With(self, node):
        if any(self._sanctioned_test(item.context_expr)
               for item in node.items):
            self._sanction_depth += 1
            self.generic_visit(node)
            self._sanction_depth -= 1
        else:
            self.generic_visit(node)

    # nested defs are separate reachability nodes; do not double-scan
    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    @property
    def sanctioned(self) -> bool:
        return self._sanction_depth > 0

    def where(self) -> str:
        return (f"in capture-reachable `{self.tf.info.qual}` "
                f"(root: {self.tf.via})")

    def flag(self, node, message: str) -> None:
        self.rule.flag(node, message, path=self.tf.info.rel)


def _mask_expr(expr, masks: Set[str]) -> bool:
    """Is ``expr`` (an index) a bool mask: a comparison, a mask call, a
    bitwise combination or inversion of masks, or a name bound from
    one?"""
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in masks
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return _mask_expr(expr.operand, masks)
    if isinstance(expr, ast.BinOp) \
            and isinstance(expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _mask_expr(expr.left, masks) or _mask_expr(expr.right, masks)
    if isinstance(expr, ast.Call):
        d = dotted_name(expr.func)
        return d is not None and d.split(".")[-1] in _MASK_FNS
    return False


def _mask_names(fn_node) -> Set[str]:
    """Local names bound (by a plain assignment) to a bool mask."""
    masks: Set[str] = set()
    if isinstance(fn_node, ast.Lambda):
        return masks
    for _ in range(4):
        grew = False
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id not in masks \
                    and _mask_expr(node.value, masks):
                masks.add(node.targets[0].id)
                grew = True
        if not grew:
            break
    return masks


def _is_dtype(expr) -> bool:
    d = dotted_name(expr)
    return d is not None and d.startswith("torch.") \
        and d.split(".")[-1] in _DTYPE_NAMES


class _CaptureSafetyScan(_TracedScan):
    def __init__(self, rule: Rule, tf: TracedFunc, vmapped: bool):
        super().__init__(rule, tf)
        self.vmapped = vmapped
        self.masks = _mask_names(tf.info.node)

    def visit_Call(self, node):
        d = dotted_name(node.func)
        leaf = d.split(".")[-1] if d else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        attr_call = isinstance(node.func, ast.Attribute)
        if self.sanctioned:
            pass
        elif leaf == "synchronize":
            self.flag(node, f"host sync `{leaf}` {self.where()} — outside "
                      "the sanctioned NF_STAGE_TIMING span")
        elif attr_call and leaf in _HOST_READS and not node.args:
            self.flag(node, f"`.{leaf}()` copies to the host {self.where()}"
                      " — a sync, refused while a CUDA graph captures")
        elif d == "print":
            self.flag(node, f"`print` {self.where()} — host I/O inside "
                      "the captured step path")
        elif d in ("int", "float", "bool") and node.args \
                and isinstance(node.args[0], (ast.Name, ast.Attribute,
                                              ast.Subscript)) \
                and self.rooted(node.args[0]):
            # direct conversion of a tensor-rooted value only: wrapped
            # host math (int(math.ceil(...))) yields a Python scalar
            self.flag(node, f"`{d}()` on a tensor-rooted value "
                      f"{self.where()} — concretizes (host sync)")
        elif leaf in _DYNAMIC_SIZE or (
                leaf == "where" and len(node.args) == 1 and not node.keywords):
            self.flag(node, f"`{leaf}` {self.where()} — its output size "
                      "depends on the data (a sync; no static size)")
        if leaf == "getenv" or (d is not None and ".environ" in f".{d}."):
            self.flag(node, f"os.environ read {self.where()} — config is "
                      "a setup-time input, not a capture-time one")
        if self.vmapped and attr_call and leaf == "view" \
                and len(node.args) == 1 and not node.keywords \
                and _is_dtype(node.args[0]):
            self.flag(node, f"`Tensor.view(dtype)` {self.where()} — "
                      "reached under torch.func.vmap, where the card's "
                      "torch has no batching rule for it")
        self.generic_visit(node)

    def visit_Subscript(self, node):
        d = dotted_name(node.value)
        if d is not None and d.split(".")[-1] == "environ":
            # bare os.environ[...] access (no .get call)
            self.flag(node, f"os.environ read {self.where()} — config is "
                      "a setup-time input, not a capture-time one")
        elif not self.sanctioned and _mask_expr(node.slice, self.masks):
            self.flag(node, f"boolean-mask indexing {self.where()} — a "
                      "data-dependent shape (a sync); use torch.where or "
                      "masked_fill")
        self.generic_visit(node)


class CaptureSafetyRule(Rule):
    """Host syncs and data-dependent shapes inside a captured or
    vmapped step."""

    name = "capture-safety"
    description = (
        "No .item()/.tolist()/.cpu()/.numpy(), synchronize(), int()/"
        "float()/bool() of a tensor, print, os.environ reads, nonzero/"
        "masked_select or bool-mask indexing in code a captured or "
        "vmapped step reaches, outside the sanctioned NF_STAGE_TIMING "
        "span; no Tensor.view(dtype) under vmap.")
    per_module = False

    def run_package(self, ctx: PackageContext) -> List[Finding]:
        self.findings = []
        vmapped = captured_reachable(ctx, VMAP_KINDS)
        for key, tf in captured_reachable(ctx, CAPTURED_KINDS).items():
            if tf.info.rel not in ctx.modules:
                continue
            self.module = ctx.modules[tf.info.rel]
            _CaptureSafetyScan(self, tf, key in vmapped).scan()
        return self.findings


class _ShapeScan(_TracedScan):
    def visit_Call(self, node):
        d = dotted_name(node.func)
        leaf = d.split(".")[-1] if d else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        if leaf in _SHAPE_FNS:
            for a in list(node.args) + [k.value for k in node.keywords]:
                for x in ast.walk(a):
                    if not isinstance(x, ast.Call):
                        continue
                    if isinstance(x.func, ast.Name) and x.func.id == "len" \
                            and x.args and self.rooted(x.args[0]):
                        self.flag(node, f"data-dependent shape: "
                                  f"`{leaf}(len(...))` {self.where()} — "
                                  "every distinct length is a fresh "
                                  "capture")
                    elif isinstance(x.func, ast.Attribute) \
                            and x.func.attr == "tolist" and not x.args:
                        self.flag(node, f"data-dependent shape: "
                                  f"`{leaf}(....tolist())` {self.where()}"
                                  " — a host read sizes the capture")
        self.generic_visit(node)


def _enclosing_classes(index) -> Dict[int, ClassInfo]:
    """id(function or lambda node) -> the class whose method holds it."""
    out: Dict[int, ClassInfo] = {}
    for syms in index.modules.values():
        for ci in syms.classes.values():
            for m in ci.methods.values():
                for x in ast.walk(m.node):
                    if isinstance(x, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                        out[id(x)] = ci
    return out


def _self_attrs(fn_node, store: bool) -> Dict[str, int]:
    """``self.<attr>`` loads (or stores) in a function: attr -> line."""
    out: Dict[str, int] = {}
    want = ast.Store if store else ast.Load
    for x in ast.walk(fn_node):
        if isinstance(x, ast.Attribute) and isinstance(x.ctx, want) \
                and isinstance(x.value, ast.Name) and x.value.id == "self":
            out.setdefault(x.attr, x.lineno)
    return out


class RecaptureHazardRule(Rule):
    """What a captured step closes over must be in its capture key, and
    no shape inside it may come from a host read."""

    name = "recapture-hazard"
    description = (
        "A self.<attr> that captured code reads and a public host method "
        "rebinds must be named by Kernel._statics() (or another "
        "*_statics()) or the module's capture_key(); no .tolist()/"
        "len(tensor)-derived shapes in captured code.")
    per_module = False

    #: set-up: Module's start-up hooks (awake .. ready_execute) and
    #: Kernel.build run before the kernel's first capture (a plugin reload
    #: replaces the phase chain, which drops every capture)
    SETUP_METHODS = ("awake", "init", "after_init", "check_config",
                     "ready_execute", "build")

    def run_package(self, ctx: PackageContext) -> List[Finding]:
        self.findings = []
        reached = captured_reachable(ctx, CAPTURED_KINDS)
        index = ctx.index
        owners = _enclosing_classes(index)
        # (a) closures: class -> attr -> (reader qual, root)
        reads: Dict[Tuple[str, str], Tuple[ClassInfo, Dict[str, Tuple]]] = {}
        for tf in reached.values():
            ci = owners.get(id(tf.info.node))
            if ci is None:
                continue
            slot = reads.setdefault((ci.rel, ci.name), (ci, {}))[1]
            for attr in _self_attrs(tf.info.node, store=False):
                slot.setdefault(attr, (tf.info.qual, tf.via))
        for (_rel, _name), (ci, attrs) in sorted(reads.items(),
                                                 key=lambda kv: kv[0]):
            self._check_class(ctx, ci, attrs, set(reached))
        # (b) the captured interior: shapes from host reads
        for tf in reached.values():
            if tf.info.rel not in ctx.modules:
                continue
            self.module = ctx.modules[tf.info.rel]
            _ShapeScan(self, tf).scan()
        return self.findings

    def _keyed(self, ctx, ci: ClassInfo) -> Optional[Set[str]]:
        """Attributes the class's capture key reads (through the
        self-methods it calls), or None when it has no key method."""
        index = ctx.index
        roots = [m for n, m in ci.methods.items()
                 if n == "capture_key" or n.endswith("_statics")]
        if not roots:
            inherited = index.method_on(ci, "capture_key")
            roots = [inherited] if inherited is not None else []
        if not roots:
            return None
        named: Set[str] = set()
        seen: Set[Tuple] = set()
        todo: List[FuncInfo] = list(roots)
        while todo:
            fi = todo.pop()
            if fi.key in seen:
                continue
            seen.add(fi.key)
            for attr in _self_attrs(fi.node, store=False):
                named.add(attr)
                m = index.method_on(ci, attr)
                if m is not None:
                    todo.append(m)
        return named

    def _check_class(self, ctx, ci: ClassInfo, attrs: Dict[str, Tuple],
                     reached: Set[Tuple]):
        index = ctx.index
        keyed = self._keyed(ctx, ci)
        for name, fi in sorted(ci.methods.items()):
            # host methods only: a public method the capture itself
            # reaches (TickCtx.rng) is part of the step
            if name.startswith("_") or name in self.SETUP_METHODS \
                    or fi.key in reached:
                continue
            for attr, line in sorted(_self_attrs(fi.node, store=True).items()):
                if attr not in attrs or (keyed is not None and attr in keyed):
                    continue
                if index.method_on(ci, attr) is not None:
                    continue  # a property's setter rebinds nothing captured
                reader, via = attrs[attr]
                key = ("neither _statics() nor capture_key() names it"
                       if keyed is not None else "the class has no "
                       "_statics() or capture_key() to name it")
                self.module = ctx.modules[fi.rel]
                self.flag(line, f"`{ci.name}.{name}` rebinds `self.{attr}`,"
                          f" which captured `{reader}` reads (root: {via}),"
                          f" but {key} — a replay would run the stale "
                          "value", path=fi.rel)
