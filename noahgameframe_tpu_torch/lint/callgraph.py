"""Package-wide symbol index + capture-rooted call-graph reachability.

The capture-safety, recapture-hazard and mesh rules need to know which
functions can run *inside* a captured or batched step: a CUDA graph
records every launch of the step once and replays it, ``torch.func.vmap``
runs it once for every room, and in both a host sync or a data-dependent
shape either breaks the capture or silently stalls the pipeline.  Python
gives no static guarantee, so this module computes a name-based
over-approximation.  The symbol index and the resolution are the JAX
package's ``lint/callgraph.py``; the roots are the port's:

- **Roots** (:func:`capture_sites`), each with a kind:

  - every cost-book dispatcher, ``<...>.costbook.wrap("<entry>", fn,
    ...)`` (or any ``.wrap`` whose entry name is a string literal):
    kind ``graph`` when it may capture a CUDA graph (``graph=True``, or a
    ``graph=`` flag only known at run time), ``eager`` when it never
    does.  A dispatcher built by a helper that forwards its ``fn``
    parameter (``self._wrap(name, fn, statics)``) roots what each call
    of the helper passes, through up to four helpers;
  - every phase registered with ``Module.add_phase(name, fn)`` (kind
    ``phase``): the kernel composes those straight into the step that
    graphs capture and the rooms engine vmaps;
  - every ``torch.func.vmap(f)`` target (kind ``vmap``).

  ``jax.jit`` is no root here.
- **Edges**: from a reached function, any call whose target resolves
  through local defs, module functions, package-internal imports,
  ``self.<method>`` on the enclosing class, or — for ``obj.method()``
  attribute calls — a method name defined exactly once in the whole
  package (ambiguous names are skipped, an under-approximation the
  contract tests pin).  Function references passed as call arguments
  are treated as called.  Instantiating a package class pulls in its
  methods (``TickCtx`` helpers run inside the step).

The result is deliberately name-based and conservative: a missed edge
means a missed check (the paired injection tests keep the important
edges alive); a spurious edge only means an extra file gets scanned.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple, Union

from .engine import ModuleInfo, PackageContext, dotted_name

# attribute-call names too generic to resolve by bare-name lookup even
# when unique — they collide with dict/list/ndarray methods constantly
_GENERIC_ATTRS = {
    "get", "set", "add", "items", "keys", "values", "append", "extend",
    "pop", "update", "copy", "clear", "sort", "join", "split", "strip",
    "read", "write", "close", "open", "send", "put", "sum", "min", "max",
    "mean", "any", "all", "astype", "reshape", "replace", "encode",
    "decode", "format", "count",
    # torch.Tensor methods: a tensor call must not resolve to the one
    # package method that happens to share its name (``x.view(...)``)
    "view", "where", "gather", "flatten", "unflatten", "size", "index",
    "put", "name", "t", "dot", "cross", "lerp", "log", "histogram",
    "select", "to", "clone", "float", "int", "long", "bool", "expand",
    "repeat", "permute", "transpose", "unsqueeze", "squeeze", "scatter",
    "cumsum", "argsort", "topk", "abs", "clamp", "chunk", "narrow",
    "fill_", "copy_", "zero_", "numel", "dim", "type", "apply",
    "contiguous",
}

# call heads that take functions as arguments and call them inside the
# step (so their args are harvested for function references)
_COMBINATORS = {"vmap", "partial", "map"}


@dataclasses.dataclass(frozen=True)
class FuncInfo:
    rel: str  # module path relative to scan root
    modname: str  # dotted ("kernel.kernel")
    qual: str  # "Kernel._step"
    cls: Optional[str]
    node: Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

    @property
    def key(self) -> Tuple[str, str, int]:
        return (self.rel, self.qual, self.node.lineno)


@dataclasses.dataclass
class ClassInfo:
    rel: str
    modname: str
    name: str
    bases: Tuple[str, ...]  # dotted base expressions
    methods: Dict[str, FuncInfo]


@dataclasses.dataclass
class ModuleSyms:
    modname: str
    rel: str
    funcs: Dict[str, FuncInfo]
    classes: Dict[str, ClassInfo]
    # local name -> ("mod", dotted-modname) | ("sym", modname, orig_name)
    imports: Dict[str, Tuple]


def _modname(rel: str) -> str:
    parts = rel[:-3].split("/")  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class PackageIndex:
    """Symbol tables for every module under the scan root."""

    def __init__(self, ctx: PackageContext):
        self.ctx = ctx
        self.pkg_name = ctx.root.name
        self.modules: Dict[str, ModuleSyms] = {}
        self.by_rel: Dict[str, ModuleSyms] = {}
        self.by_func_name: Dict[str, List[FuncInfo]] = {}
        for rel, mod in ctx.modules.items():
            if mod.tree is None:
                continue
            syms = self._index_module(rel, mod)
            self.modules[syms.modname] = syms
            self.by_rel[rel] = syms
        for syms in self.modules.values():
            for fi in syms.funcs.values():
                self.by_func_name.setdefault(fi.qual.rsplit(".", 1)[-1],
                                             []).append(fi)
            for ci in syms.classes.values():
                for name, fi in ci.methods.items():
                    self.by_func_name.setdefault(name, []).append(fi)

    # -- construction -----------------------------------------------------

    def _index_module(self, rel: str, mod: ModuleInfo) -> ModuleSyms:
        modname = _modname(rel)
        syms = ModuleSyms(modname=modname, rel=rel, funcs={}, classes={},
                          imports={})
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                syms.funcs[node.name] = FuncInfo(rel, modname, node.name,
                                                 None, node)
            elif isinstance(node, ast.ClassDef):
                methods = {}
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        methods[b.name] = FuncInfo(
                            rel, modname, f"{node.name}.{b.name}",
                            node.name, b)
                bases = tuple(d for d in (dotted_name(b) for b in node.bases)
                              if d is not None)
                syms.classes[node.name] = ClassInfo(rel, modname, node.name,
                                                    bases, methods)
        for node in ast.walk(mod.tree):
            self._index_imports(node, modname, syms.imports)
        return syms

    def _index_imports(self, node, modname: str, out: Dict) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                target = self._abs_module(a.name)
                if target is not None:
                    out[local] = ("mod", target if a.asname else
                                  target.split(".")[0])
                    if a.asname:
                        out[local] = ("mod", target)
        elif isinstance(node, ast.ImportFrom):
            base = self._from_base(modname, node)
            if base is None:
                return
            for a in node.names:
                local = a.asname or a.name
                child = f"{base}.{a.name}" if base else a.name
                if child in self._known_modnames():
                    out[local] = ("mod", child)
                else:
                    out[local] = ("sym", base, a.name)

    def _known_modnames(self) -> Set[str]:
        if not hasattr(self, "_known"):
            self._known = {_modname(rel) for rel in self.ctx.modules}
        return self._known

    def _abs_module(self, dotted: str) -> Optional[str]:
        """Map an absolute import to a root-relative module name."""
        parts = dotted.split(".")
        if parts[0] == self.pkg_name:
            inner = ".".join(parts[1:])
            return inner if inner in self._known_modnames() or not inner \
                else None
        return None  # external

    def _from_base(self, modname: str, node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return self._abs_module(node.module or "")
        container = modname.split(".") if modname else []
        rel = self.ctx.root / (modname.replace(".", "/") + ".py")
        # a package __init__'s level-1 refers to itself; a module's to
        # its parent.  Our modname for pkg/__init__.py already drops the
        # __init__ segment, so both cases are "drop (level-1) from the
        # container", where a plain module's container excludes itself.
        if rel.exists() or f"{modname}".replace(".", "/") + ".py" in self.ctx.modules:
            container = container[:-1]
        drop = node.level - 1
        if drop > len(container):
            return None
        base = container[: len(container) - drop] if drop else container
        if node.module:
            base = base + node.module.split(".")
        name = ".".join(base)
        return name if name in self._known_modnames() or name == "" else None

    # -- resolution -------------------------------------------------------

    def module_syms(self, modname: str) -> Optional[ModuleSyms]:
        return self.modules.get(modname)

    def resolve_in_module(self, modname: str, name: str):
        syms = self.modules.get(modname)
        if syms is None:
            return None
        if name in syms.funcs:
            return syms.funcs[name]
        if name in syms.classes:
            return syms.classes[name]
        imp = syms.imports.get(name)
        if imp is not None:
            return self._resolve_import(imp)
        return None

    def _resolve_import(self, imp: Tuple):
        if imp[0] == "mod":
            return ("mod", imp[1])
        _, base, orig = imp
        return self.resolve_in_module(base, orig)

    def class_info(self, modname: str, cls_name: str) -> Optional[ClassInfo]:
        syms = self.modules.get(modname)
        if syms and cls_name in syms.classes:
            return syms.classes[cls_name]
        return None

    def method_on(self, ci: ClassInfo, name: str,
                  _depth: int = 0) -> Optional[FuncInfo]:
        """Method lookup through package-resolvable base classes."""
        if name in ci.methods:
            return ci.methods[name]
        if _depth > 4:
            return None
        for base in ci.bases:
            head = base.split(".")[-1]
            target = self.resolve_in_module(ci.modname, base.split(".")[0])
            if isinstance(target, ClassInfo):
                found = self.method_on(target, name, _depth + 1)
                if found:
                    return found
            elif isinstance(target, tuple) and target[0] == "mod":
                bsyms = self.modules.get(target[1])
                if bsyms and head in bsyms.classes:
                    found = self.method_on(bsyms.classes[head], name,
                                           _depth + 1)
                    if found:
                        return found
        return None

    def unique_by_name(self, name: str) -> Optional[FuncInfo]:
        if name in _GENERIC_ATTRS or name.startswith("__"):
            return None
        cands = self.by_func_name.get(name, ())
        return cands[0] if len(cands) == 1 else None


# -------------------------------------------------------------------------
# scopes + reference harvesting
# -------------------------------------------------------------------------

@dataclasses.dataclass
class Scope:
    index: PackageIndex
    modname: str
    cls: Optional[ClassInfo]
    locals: Dict[str, FuncInfo]
    assigns: Dict[str, ast.expr]
    imports: Dict[str, Tuple]

    def child_for(self, fn_node) -> "Scope":
        locals_: Dict[str, FuncInfo] = {}
        assigns: Dict[str, ast.expr] = {}
        imports: Dict[str, Tuple] = dict(self.imports)
        for node in ast.walk(fn_node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn_node:
                locals_[node.name] = FuncInfo(
                    self.index.modules[self.modname].rel
                    if self.modname in self.index.modules else "?",
                    self.modname, node.name, None, node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigns[node.targets[0].id] = node.value
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                self.index._index_imports(node, self.modname, imports)
        return dataclasses.replace(self, locals={**self.locals, **locals_},
                                   assigns={**self.assigns, **assigns},
                                   imports=imports)


Target = Union[FuncInfo, ClassInfo]


def resolve_name(scope: Scope, name: str, _depth: int = 0) -> List[Target]:
    if name in scope.locals:
        return [scope.locals[name]]
    if name in scope.assigns and _depth < 6:
        return harvest(scope.assigns[name], scope, _depth + 1)
    imp = scope.imports.get(name)
    if imp is not None:
        t = scope.index._resolve_import(imp)
        if isinstance(t, (FuncInfo, ClassInfo)):
            return [t]
        return []
    t = scope.index.resolve_in_module(scope.modname, name)
    if isinstance(t, (FuncInfo, ClassInfo)):
        return [t]
    return []


def resolve_attr(scope: Scope, node: ast.Attribute,
                 as_call: bool) -> List[Target]:
    dotted = dotted_name(node)
    if dotted is None:
        # dynamic root (call result, subscript …): bare-name fallback
        if as_call:
            fi = scope.index.unique_by_name(node.attr)
            return [fi] if fi else []
        return []
    parts = dotted.split(".")
    if parts[0] == "self" and scope.cls is not None and len(parts) == 2:
        m = scope.index.method_on(scope.cls, parts[1])
        if m:
            return [m]
        return []
    # module-alias chains: nf_mod.sub.fn
    imp = scope.imports.get(parts[0])
    if imp is not None and imp[0] == "mod" or (
            imp is not None and scope.index._resolve_import(imp) is not None):
        t = scope.index._resolve_import(imp) if imp else None
        i = 1
        while isinstance(t, tuple) and t[0] == "mod" and i < len(parts):
            syms = scope.index.modules.get(t[1])
            if syms is None:
                t = None
                break
            nxt = scope.index.resolve_in_module(t[1], parts[i])
            if nxt is None and f"{t[1]}.{parts[i]}" in scope.index.modules:
                nxt = ("mod", f"{t[1]}.{parts[i]}")
            t = nxt
            i += 1
        if isinstance(t, (FuncInfo, ClassInfo)) and i == len(parts):
            return [t]
        if isinstance(t, (FuncInfo, ClassInfo)):
            return []
    if as_call and len(parts) >= 2:
        fi = scope.index.unique_by_name(parts[-1])
        return [fi] if fi else []
    return []


def harvest(expr, scope: Scope, _depth: int = 0) -> List[Target]:
    """Every package function/class an expression could hand to a root."""
    if _depth > 8 or expr is None:
        return []
    out: List[Target] = []
    if isinstance(expr, ast.Name):
        out.extend(resolve_name(scope, expr.id, _depth))
    elif isinstance(expr, ast.Attribute):
        out.extend(resolve_attr(scope, expr, as_call=False))
        if not out:
            fi = scope.index.unique_by_name(expr.attr)
            if fi:
                out.append(fi)
    elif isinstance(expr, ast.Lambda):
        # the lambda's own module and class: its body is scanned, and its
        # ``self.<method>`` calls resolve on the enclosing class
        syms = scope.index.modules.get(scope.modname)
        out.append(FuncInfo(syms.rel if syms else "<lambda>", scope.modname,
                            "<lambda>", scope.cls.name if scope.cls else None,
                            expr))
    elif isinstance(expr, ast.Call):
        out.extend(harvest(expr.func, scope, _depth + 1))
        for a in list(expr.args) + [k.value for k in expr.keywords]:
            out.extend(harvest(a, scope, _depth + 1))
    elif isinstance(expr, (ast.Tuple, ast.List)):
        for e in expr.elts:
            out.extend(harvest(e, scope, _depth + 1))
    return out


# -------------------------------------------------------------------------
# roots + reachability
# -------------------------------------------------------------------------

#: root kinds: a CUDA-graph capture, an eager cost-book dispatch, a
#: kernel phase, a vmap target
ROOT_KINDS = ("graph", "eager", "phase", "vmap")
#: the kinds whose code runs under ``torch.func.vmap`` (every phase runs
#: inside the step the rooms engine vmaps)
VMAP_KINDS = ("vmap", "phase")
_FORWARD_DEPTH = 4


@dataclasses.dataclass
class CaptureSite:
    rel: str
    lineno: int
    call: ast.Call
    targets: List[Target]
    kind: str  # one of ROOT_KINDS


def _str_entry(expr) -> bool:
    return isinstance(expr, ast.JoinedStr) or (
        isinstance(expr, ast.Constant) and isinstance(expr.value, str))


def _wrap_kind(call: ast.Call) -> Optional[str]:
    """'graph' or 'eager' for a cost-book dispatcher call, else None."""
    d = dotted_name(call.func)
    if d is None or "." not in d or d.split(".")[-1] != "wrap" \
            or len(call.args) < 2:
        return None
    receiver = d.rsplit(".", 1)[0]
    if not (receiver.split(".")[-1] == "costbook" or _str_entry(call.args[0])):
        return None
    for kw in call.keywords:
        if kw.arg == "graph":
            if isinstance(kw.value, ast.Constant) and not kw.value.value:
                return "eager"
            return "graph"  # True, or a flag known only at run time
    return "eager"


def _is_vmap(call: ast.Call) -> bool:
    d = dotted_name(call.func)
    return d is not None and d.split(".")[-1] == "vmap" and bool(call.args)


def _param_index(fn_node, name: str) -> Optional[int]:
    """Position of parameter ``name`` among ``fn_node``'s positional
    parameters (``self`` excluded), or None."""
    if isinstance(fn_node, ast.Lambda):
        return None
    params = [a.arg for a in fn_node.args.posonlyargs + fn_node.args.args]
    if params and params[0] == "self":
        params = params[1:]
    return params.index(name) if name in params else None


class _RootCollector(ast.NodeVisitor):
    """One module's roots.  ``forwards`` maps a helper (FuncInfo key) to
    (its FuncInfo, parameter position, parameter name, kind): a helper
    whose parameter is what it wraps or vmaps; the calls of it are
    roots too (:func:`capture_sites`)."""

    def __init__(self, index: PackageIndex, syms: ModuleSyms,
                 forwards: Dict[Tuple, Tuple]):
        self.index = index
        self.syms = syms
        self.scope = Scope(index, syms.modname, None, {}, {}, syms.imports)
        self.sites: List[CaptureSite] = []
        self.forwards_in = forwards
        self.forwards_out: Dict[Tuple, Tuple] = {}
        self._cls_stack: List[Optional[ClassInfo]] = []
        self._fn_stack: List[Tuple[Scope, FuncInfo]] = []

    def visit_ClassDef(self, node):
        self._cls_stack.append(self.syms.classes.get(node.name))
        self.generic_visit(node)
        self._cls_stack.pop()

    def _cur_scope(self) -> Scope:
        base = self._fn_stack[-1][0] if self._fn_stack else self.scope
        cls = self._cls_stack[-1] if self._cls_stack else None
        return dataclasses.replace(base, cls=cls)

    def _owned_info(self, node) -> FuncInfo:
        cls = self._cls_stack[-1] if self._cls_stack else None
        if cls is not None and node.name in cls.methods \
                and cls.methods[node.name].node is node:
            return cls.methods[node.name]
        if node.name in self.syms.funcs and self.syms.funcs[node.name].node is node:
            return self.syms.funcs[node.name]
        return FuncInfo(self.syms.rel, self.syms.modname, node.name,
                        cls.name if cls else None, node)

    def _visit_fn(self, node):
        scope = self._cur_scope()
        self._fn_stack.append((scope.child_for(node), self._owned_info(node)))
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _root(self, node: ast.Call, fn_expr, kind: str) -> None:
        scope = self._cur_scope()
        self.sites.append(CaptureSite(self.syms.rel, node.lineno, node,
                                      harvest(fn_expr, scope), kind))
        # a helper that wraps its own parameter: its callers root too
        if isinstance(fn_expr, ast.Name) and self._fn_stack:
            owner = self._fn_stack[-1][1]
            pos = _param_index(owner.node, fn_expr.id)
            if pos is not None:
                self.forwards_out[owner.key] = (owner, pos, fn_expr.id, kind)

    def visit_Call(self, node):
        kind = _wrap_kind(node)
        if kind is not None:
            self._root(node, node.args[1], kind)
        elif _is_vmap(node):
            self._root(node, node.args[0], "vmap")
        else:
            d = dotted_name(node.func)
            if d is not None and d.split(".")[-1] == "add_phase":
                fn_expr = node.args[1] if len(node.args) >= 2 else next(
                    (kw.value for kw in node.keywords if kw.arg == "fn"), None)
                if fn_expr is not None:
                    self._root(node, fn_expr, "phase")
        if self.forwards_in:
            self._forwarded(node)
        self.generic_visit(node)

    def _forwarded(self, node: ast.Call) -> None:
        """A call of a forwarding helper roots the argument it forwards."""
        scope = self._cur_scope()
        if isinstance(node.func, ast.Name):
            callees = resolve_name(scope, node.func.id)
        elif isinstance(node.func, ast.Attribute):
            callees = resolve_attr(scope, node.func, as_call=True)
        else:
            return
        for t in callees:
            fwd = self.forwards_in.get(t.key) if isinstance(t, FuncInfo) \
                else None
            if fwd is None:
                continue
            _fi, pos, pname, kind = fwd
            arg = node.args[pos] if pos < len(node.args) else next(
                (kw.value for kw in node.keywords if kw.arg == pname), None)
            if arg is not None and not isinstance(arg, ast.Starred):
                self._root(node, arg, kind)


def capture_sites(ctx: PackageContext) -> List[CaptureSite]:
    """Every root of the package (cached on ``ctx``)."""
    cache = ctx.__dict__.setdefault("_capture_cache", {})
    if "sites" in cache:
        return cache["sites"]
    index = ctx.index
    sites: List[CaptureSite] = []
    forwards: Dict[Tuple, Tuple] = {}
    seen_sites: Set[Tuple] = set()
    for _ in range(_FORWARD_DEPTH + 1):
        new_forwards: Dict[Tuple, Tuple] = {}
        for rel, syms in index.by_rel.items():
            if rel.startswith("lint/"):
                continue  # the analyzer does not analyze itself
            col = _RootCollector(index, syms, forwards)
            col.visit(ctx.modules[rel].tree)
            for site in col.sites:
                ident = (site.rel, site.lineno, site.kind,
                         tuple(t.key if isinstance(t, FuncInfo) else t.name
                               for t in site.targets))
                if ident not in seen_sites:
                    seen_sites.add(ident)
                    sites.append(site)
            new_forwards.update(col.forwards_out)
        if set(new_forwards) <= set(forwards):
            break
        forwards.update(new_forwards)
    cache["sites"] = sites
    return sites


@dataclasses.dataclass
class TracedFunc:
    info: FuncInfo
    scope: Scope
    via: str  # human-readable root provenance


def captured_reachable(ctx: PackageContext,
                       kinds: Sequence[str] = ROOT_KINDS
                       ) -> Dict[Tuple, TracedFunc]:
    """BFS the call graph from every root of the given kinds (cached on
    ``ctx`` per kind set)."""
    cache = ctx.__dict__.setdefault("_capture_cache", {})
    key = ("reach", tuple(sorted(kinds)))
    if key in cache:
        return cache[key]
    index = ctx.index
    reached: Dict[Tuple, TracedFunc] = {}
    # breadth-first, roots in file order: each function's provenance is
    # the first root (in that order) that reaches it by a shortest path
    queue: Deque[TracedFunc] = collections.deque()

    def scope_for(fi: FuncInfo) -> Scope:
        syms = index.modules.get(fi.modname)
        imports = syms.imports if syms else {}
        cls = index.class_info(fi.modname, fi.cls) if fi.cls else None
        base = Scope(index, fi.modname, cls, {}, {}, imports)
        if isinstance(fi.node, ast.Lambda):
            return base
        return base.child_for(fi.node)

    def push(t: Target, via: str):
        if isinstance(t, ClassInfo):
            for m in t.methods.values():
                push(m, via + f" -> {t.name}()")
            return
        if not isinstance(t, FuncInfo):
            return
        if t.rel.startswith("lint/"):
            return
        if t.key in reached:
            return
        tf = TracedFunc(t, scope_for(t), via)
        reached[t.key] = tf
        queue.append(tf)

    for site in capture_sites(ctx):
        if site.kind not in kinds:
            continue
        via = f"{site.rel}:{site.lineno} ({site.kind})"
        for t in site.targets:
            push(t, via)

    while queue:
        tf = queue.popleft()
        scope = dataclasses.replace(tf.scope)
        for node in ast.walk(tf.info.node):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                for t in resolve_name(scope, node.func.id):
                    push(t, tf.via)
            elif isinstance(node.func, ast.Attribute):
                for t in resolve_attr(scope, node.func, as_call=True):
                    push(t, tf.via)
            # combinator args: functions passed by reference are called
            d = dotted_name(node.func)
            leaf = d.split(".")[-1] if d else ""
            if leaf in _COMBINATORS:
                for a in list(node.args) + [k.value for k in node.keywords]:
                    for t in harvest(a, scope):
                        push(t, tf.via)
            else:
                for a in node.args:
                    if isinstance(a, (ast.Name, ast.Attribute)):
                        for t in (resolve_name(scope, a.id)
                                  if isinstance(a, ast.Name)
                                  else resolve_attr(scope, a, as_call=False)):
                            if isinstance(t, FuncInfo):
                                push(t, tf.via)
    cache[key] = reached
    return reached
