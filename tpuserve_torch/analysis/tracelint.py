"""Trace-discipline lint (TPS5xx) over the port's captured regions.

The port's counterpart of ``tpuserve/analysis/tracelint.py``. The
reference walks ``jax.jit`` bodies; the port serves every bucket and every
generation program by replaying a CUDA graph captured at startup, so its
central invariant is "steady-state capture delta 0, no host sync inside a
replay". These rules prove it ahead of runtime by walking the
capture-reachability set — every function whose body a CUDA graph records —
and flagging the hazards that silently mint new captures, bake host values
into a graph or sync the host inside a capture. Each rule keeps the
reference's number where its hazard exists for a graph:

- **TPS501 — a fresh program per call.** ``register_program`` handed a
  lambda or a function defined in the enclosing call (outside
  ``__init__``): each call registers a new function object, and each one
  captures a new graph.

- **TPS502 — host syncs in a captured body.** ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` and
  ``np.*`` calls on tensor-typed names, and any ``torch.cuda.synchronize()``
  or ``<stream>.synchronize()``: illegal while a graph records, and a graph
  replays none of it. A bare ``print`` fires at capture time only.

- **TPS503 — Python control flow on tensor values.** ``if``/``while`` on a
  tensor-derived expression syncs the host at capture and bakes the branch
  it took into the graph. ``x is None`` checks and kwonly-arg branches are
  exempt (static by construction: kwonly args of captured functions are the
  port's convention for capture-time parameters, e.g. ``prefill_chunk``'s
  ``chunk``).

- **TPS504 / TPS505 — capture by closure.** In a *host-side* function, a
  nested function handed to ``register_program`` that captures (TPS504) a
  tensor freshly built per call from the enclosing function's arguments
  (``torch.arange(n)`` and friends) or (TPS505) an enclosing-function
  argument directly: the graph bakes the tensor's address or the value,
  so every distinct value needs another capture. Pass it as a program
  argument instead.

Capture-reachability = the conventional ``ServingModel`` /
``GenerativeModel`` entry points (``forward``, ``step``, ``extract``,
``init_state``, ``prefill_chunk``), the function handed to
``register_program(tag, fn, ...)`` (or the nested def a same-module factory
call returns for it), the bodies of ``with torch.cuda.graph(...)`` blocks,
plus a bounded same-module call-graph walk through their helpers (nested
defs included).

Deliberate host reads carry an inline sanction, as in the reference::

    if "kp" in state:  # tps-ok[TPS503]: dict structure check at capture time

The annotation names the rule and MUST give a reason; it suppresses that
rule on that statement only.

Honest limits: resolution is name-based within a module/class (no type
inference), so cross-object helpers (``self.unet(...)``) are not descended
into — that residue is what the runtime retrace witness
(``TPUSERVE_RETRACE_WITNESS=1``: the capture count and the sync guard)
covers.

Pure AST + text — no torch import — so the lint runs on a bare Python.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from tpuserve_torch.analysis.astlint import (
    MAX_CALL_DEPTH,
    FuncInfo,
    ModuleInfo,
    _parse_module,
    _self_attr,
    dotted,
)
from tpuserve_torch.analysis.findings import Finding

# Conventional captured entry points on serving/generative model classes.
TRACED_METHOD_NAMES = {"forward", "step", "extract", "init_state",
                       "prefill_chunk"}
TRACED_BASE_NAMES = {"GenerativeModel", "ServingModel"}

# Attribute reads that yield host metadata even on a tensor: branching on
# a shape is free, branching on data is not.
UNTAINT_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda", "layout"}
# Tensor methods that return host metadata.
UNTAINT_METHODS = {"size", "dim", "numel", "element_size", "stride",
                   "is_contiguous", "get_device", "data_ptr"}

# Builtins that force a concrete host value out of a tensor.
HOST_FORCERS = {"float", "int", "bool", "complex"}
HOST_FORCER_ATTRS = {"item", "tolist", "cpu", "numpy"}

# Untainting builtins: host values (len of a tensor is its leading dim;
# isinstance/type are structural).
STATIC_BUILTINS = {"len", "isinstance", "type", "range", "enumerate"}

# Namespaces whose calls return tensors.
TENSOR_NAMESPACES = {"torch", "F"}

# Tensor constructors whose per-call result, captured into a registered
# program, is baked into its graph by address (TPS504).
ARRAY_BUILDERS = {"arange", "zeros", "ones", "full", "empty", "tensor",
                  "as_tensor", "from_numpy", "asarray", "array", "linspace",
                  "eye", "tri", "rand", "randn", "randint"}
ARRAY_NAMESPACES = {"torch", "np", "numpy"}

_SANCTION_RE = re.compile(
    r"#\s*tps-ok\[(?P<rules>TPS\d{3}(?:\s*,\s*TPS\d{3})*)\]:\s*\S")


def sanctioned_rules(line_text: str) -> set[str]:
    """Rule ids sanctioned by an inline ``# tps-ok[TPSnnn]: reason``
    annotation on this source line (empty set when absent or when the
    required reason text is missing)."""
    m = _SANCTION_RE.search(line_text)
    if m is None:
        return set()
    return {r.strip() for r in m.group("rules").split(",")}


def filter_sanctioned(findings: list[Finding],
                      sources: dict[str, list[str]]) -> list[Finding]:
    """Drop findings whose source line carries a matching sanction."""
    out = []
    for f in findings:
        lines = sources.get(f.file)
        if lines and 1 <= f.line <= len(lines) \
                and f.rule in sanctioned_rules(lines[f.line - 1]):
            continue
        out.append(f)
    return out


def _is_graph_block(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(...)`` (or an alias ending in ``cuda.graph``)."""
    if not isinstance(item.context_expr, ast.Call):
        return False
    name = dotted(item.context_expr.func) or ""
    return name == "cuda.graph" or name.endswith(".cuda.graph")


def _registered_fn(call: ast.Call) -> ast.AST | None:
    """The function argument of ``<runtime>.register_program(tag, fn, ...)``."""
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr == "register_program" and len(call.args) >= 2:
        return call.args[1]
    return None


def _is_sync(call: ast.Call) -> str | None:
    """The name of a host-synchronizing call (``torch.cuda.synchronize()``,
    ``<stream or event>.synchronize()``), else None."""
    name = dotted(call.func)
    if isinstance(call.func, ast.Attribute) and call.func.attr == "synchronize":
        return name or ".synchronize"
    return None


def _positional_params(fn: ast.AST) -> list[str]:
    """Positional parameter names, minus self/cls. Kwonly args are NOT
    included: a kwonly arg of a captured function is the port's convention
    for a capture-time-static parameter (closed over at register time)."""
    a = fn.args
    names = [p.arg for p in [*a.posonlyargs, *a.args]]
    return [n for n in names if n not in ("self", "cls")]


def _static_param_names(fn: ast.AST) -> set[str]:
    """Params that are host-static by declaration: annotated with a host
    scalar type (``b: int``)."""
    static: set[str] = set()
    for p in [*fn.args.posonlyargs, *fn.args.args]:
        ann = p.annotation
        if isinstance(ann, ast.Name) and ann.id in ("int", "bool", "str"):
            static.add(p.arg)
    return static


def _bound_names(fn: ast.AST) -> set[str]:
    """Every name bound inside ``fn`` (params, assignments, defs, loop and
    comprehension targets, imports) — for free-variable computation."""
    a = fn.args
    bound = {p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]}
    if a.vararg:
        bound.add(a.vararg.arg)
    if a.kwarg:
        bound.add(a.kwarg.arg)
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
            bound.add(n.id)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(n.name)
        elif isinstance(n, ast.alias):
            bound.add((n.asname or n.name).split(".")[0])
        elif isinstance(n, ast.ExceptHandler) and n.name:
            bound.add(n.name)
    return bound


def _free_names(fn: ast.AST) -> set[str]:
    """Names ``fn`` reads but does not bind (its closure candidates)."""
    bound = _bound_names(fn)
    free = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id not in bound:
            free.add(n.id)
    return free


class _Taint:
    """Flow-through taint for tensor-typed names inside one body.

    Positional params seed the set; values computed from tainted names or
    from ``torch.*``/``F.*`` calls propagate; ``.shape``/``.dtype``-style
    reads, ``.size()``-style methods, ``len()`` and ``x is None`` checks
    untaint (host metadata)."""

    def __init__(self, seed: set[str]) -> None:
        self.names = set(seed)

    def expr(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            if e.attr in UNTAINT_ATTRS:
                return False
            return self.expr(e.value)
        if isinstance(e, ast.Subscript):
            return self.expr(e.value)
        if isinstance(e, ast.Call):
            name = dotted(e.func) or ""
            if isinstance(e.func, ast.Name) and e.func.id in STATIC_BUILTINS:
                return False
            if isinstance(e.func, ast.Name) and e.func.id in HOST_FORCERS:
                return False  # result is a host scalar (and flagged)
            if name.split(".")[0] in TENSOR_NAMESPACES:
                return True
            if isinstance(e.func, ast.Attribute):
                if e.func.attr in HOST_FORCER_ATTRS or e.func.attr in UNTAINT_METHODS:
                    return False  # result is a host value (forcers are flagged)
                if self.expr(e.func.value):
                    return True  # method on a tensor (x.mean(), x.sum())
            return any(self.expr(a) for a in e.args) or any(
                self.expr(kw.value) for kw in e.keywords)
        if isinstance(e, ast.BinOp):
            return self.expr(e.left) or self.expr(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.expr(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.expr(v) for v in e.values)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops) \
                    and any(isinstance(c, ast.Constant) and c.value is None
                            for c in e.comparators):
                return False  # `x is None`: structural
            return self.expr(e.left) or any(self.expr(c)
                                            for c in e.comparators)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr(v) for v in e.elts)
        if isinstance(e, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            return self.expr(e.elt)
        if isinstance(e, ast.IfExp):
            return self.expr(e.body) or self.expr(e.test) or self.expr(e.orelse)
        if isinstance(e, ast.Starred):
            return self.expr(e.value)
        if isinstance(e, ast.Await):
            return self.expr(e.value)
        return False

    def assign(self, target: ast.AST, value_tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if value_tainted:
                self.names.add(target.id)
            else:
                self.names.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self.assign(t, value_tainted)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, value_tainted)


class TraceAnalyzer:
    """TPS5xx driver over a parsed module set."""

    def __init__(self, modules: list[ModuleInfo]) -> None:
        self.modules = modules
        self.findings: list[Finding] = []
        self.traced: set[tuple[str, str]] = set()  # (modname, qualname)
        # Method names handed to register_program through an object we
        # cannot type (``rt.register_program("extract", model.extract)``) —
        # any conventional model class defining them is treated as captured.
        self._traced_attr_names: set[str] = set(TRACED_METHOD_NAMES)

    # -- reachability ---------------------------------------------------------

    def _conventional_classes(self, mi: ModuleInfo) -> set[str]:
        out = set()
        for stmt in mi.tree.body:
            if not isinstance(stmt, ast.ClassDef):
                continue
            for base in stmt.bases:
                name = dotted(base) or ""
                if name.split(".")[-1] in TRACED_BASE_NAMES:
                    out.add(stmt.name)
        return out

    def _mark(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        self.traced.add((mi.modname, fi.qualname))

    def _seed_roots(self) -> None:
        for mi in self.modules:
            conv = self._conventional_classes(mi)
            for fi in mi.functions.values():
                if fi.cls in conv and fi.name in TRACED_METHOD_NAMES \
                        and "<locals>" not in fi.name:
                    self._mark(mi, fi)
            # Functions handed (by reference) to register_program.
            for fi in list(mi.functions.values()):
                for n in ast.walk(fi.node):
                    if isinstance(n, ast.Call):
                        fn_arg = _registered_fn(n)
                        if fn_arg is not None:
                            self._mark_reference(mi, fi, fn_arg)

    def _local_def(self, mi: ModuleInfo, scope: str, name: str) -> FuncInfo | None:
        """The def ``name`` nested in the function ``scope`` (registered by
        astlint under a ``<locals>`` qualname), else None."""
        suffix = f".<locals>.{name}"
        return next((f for q, f in mi.functions.items()
                     if q.endswith(suffix) and q.startswith(scope)), None)

    def _mark_reference(self, mi: ModuleInfo, scope: FuncInfo,
                        ref: ast.AST) -> None:
        if isinstance(ref, ast.Name):
            target = self._local_def(mi, scope.qualname.split(".<locals>.")[0], ref.id) \
                or mi.functions.get(ref.id)
            if target is not None:
                self._mark(mi, target)
            return
        if isinstance(ref, ast.Call) and isinstance(ref.func, ast.Name):
            # A same-module factory (``_packed_step(model, layout)``): the
            # nested defs it returns are what the graph records.
            factory = mi.functions.get(ref.func.id)
            if factory is None:
                return
            for n in ast.walk(factory.node):
                if isinstance(n, ast.Return) and isinstance(n.value, ast.Name):
                    target = self._local_def(mi, factory.qualname, n.value.id)
                    if target is not None:
                        self._mark(mi, target)
            return
        attr = _self_attr(ref)
        if attr is not None and scope.cls is not None:
            target = mi.functions.get(f"{scope.cls}.{attr}")
            if target is not None:
                self._mark(mi, target)
            return
        if isinstance(ref, ast.Attribute):
            # ``model.extract``-style: type unknown; remember the method
            # name and mark it on every conventional model class.
            self._traced_attr_names.add(ref.attr)

    def _walk_reachability(self) -> None:
        # Conventional-class methods named like recorded attr references.
        for mi in self.modules:
            conv = self._conventional_classes(mi)
            for fi in mi.functions.values():
                if fi.cls in conv and fi.name in self._traced_attr_names \
                        and "<locals>" not in fi.name:
                    self._mark(mi, fi)
        # Bounded same-module call-graph closure, from the captured
        # functions and from the bodies of graph blocks.
        work = [(mi, fi, fi.node, 1) for mi in self.modules
                for fi in list(mi.functions.values())
                if (mi.modname, fi.qualname) in self.traced]
        for mi in self.modules:
            for fi in list(mi.functions.values()):
                for n in ast.walk(fi.node):
                    if isinstance(n, ast.With) and any(map(_is_graph_block, n.items)):
                        work.append((mi, fi, ast.Module(body=n.body, type_ignores=[]), 1))
        while work:
            mi, fi, node, depth = work.pop()
            if depth > MAX_CALL_DEPTH:
                continue
            for n in ast.walk(node):
                if not isinstance(n, ast.Call):
                    continue
                callee = None
                attr = _self_attr(n.func)
                if attr is not None and fi.cls is not None:
                    callee = mi.functions.get(f"{fi.cls}.{attr}")
                elif isinstance(n.func, ast.Name):
                    callee = mi.functions.get(n.func.id)
                if callee is None:
                    continue
                key = (mi.modname, callee.qualname)
                if key in self.traced:
                    continue
                self.traced.add(key)
                work.append((mi, callee, callee.node, depth + 1))

    # -- rules ----------------------------------------------------------------

    def run(self) -> list[Finding]:
        self._seed_roots()
        self._walk_reachability()
        for mi in self.modules:
            for fi in mi.functions.values():
                traced = (mi.modname, fi.qualname) in self.traced
                if "<locals>" in fi.name:
                    # A captured nested def of a host-side owner (a
                    # registered local program); a captured owner's body
                    # covers its nested defs.
                    owner = fi.qualname.split(".<locals>.")[0]
                    if traced and (mi.modname, owner) not in self.traced:
                        self._check_body(mi, fi, captured=True)
                    continue
                if traced:
                    self._check_body(mi, fi, captured=True)
                else:
                    # Host-side: only its graph blocks are captured.
                    self._check_body(mi, fi, captured=False)
                    self._check_closure_capture(mi, fi)
                self._check_register_sites(mi, fi)
        self.findings.sort(key=lambda f: (f.file, f.line, f.rule, f.symbol))
        return self.findings

    # TPS502 / TPS503 over one body (nested defs included): all of it when
    # ``captured``, else only the bodies of its graph blocks.
    def _check_body(self, mi: ModuleInfo, fi: FuncInfo, captured: bool) -> None:
        if not captured and not any(
                isinstance(n, ast.With) and any(map(_is_graph_block, n.items))
                for n in ast.walk(fi.node)):
            return
        taint = _Taint(set(_positional_params(fi.node))
                       - _static_param_names(fi.node))

        def visit_stmt(stmt: ast.AST, flag: bool) -> None:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for p in set(_positional_params(stmt)) \
                        - _static_param_names(stmt):
                    taint.names.add(p)
                for s in stmt.body:
                    visit_stmt(s, flag)
                return
            if isinstance(stmt, ast.Assign):
                t = taint.expr(stmt.value)
                if flag:
                    self._check_exprs(mi, fi, taint, stmt)
                for target in stmt.targets:
                    taint.assign(target, t)
                return
            if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                value = stmt.value
                t = taint.expr(value) if value is not None else False
                if isinstance(stmt, ast.AugAssign):
                    t = t or taint.expr(stmt.target)
                if flag:
                    self._check_exprs(mi, fi, taint, stmt)
                taint.assign(stmt.target, t)
                return
            if isinstance(stmt, (ast.If, ast.While)):
                if flag and taint.expr(stmt.test):
                    kind = "if" if isinstance(stmt, ast.If) else "while"
                    self._add(
                        "TPS503", mi, fi,
                        f"Python `{kind}` on captured value "
                        f"{ast.unparse(stmt.test)} (a host sync at capture, and "
                        "the graph keeps the branch it took; use torch.where)",
                        stmt.lineno)
                if flag:
                    self._check_exprs(mi, fi, taint, stmt.test)
                for s in [*stmt.body, *stmt.orelse]:
                    visit_stmt(s, flag)
                return
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                if flag:
                    self._check_exprs(mi, fi, taint, stmt.iter)
                taint.assign(stmt.target, taint.expr(stmt.iter))
                for s in [*stmt.body, *stmt.orelse]:
                    visit_stmt(s, flag)
                return
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = flag or any(map(_is_graph_block, stmt.items))
                for item in stmt.items:
                    if item.optional_vars is not None:
                        taint.assign(item.optional_vars, False)
                for s in stmt.body:
                    visit_stmt(s, inner)
                return
            if isinstance(stmt, ast.Try):
                for s in [*stmt.body, *stmt.orelse, *stmt.finalbody]:
                    visit_stmt(s, flag)
                for h in stmt.handlers:
                    for s in h.body:
                        visit_stmt(s, flag)
                return
            if flag:
                self._check_exprs(mi, fi, taint, stmt)

        for s in fi.node.body:
            visit_stmt(s, captured)

    def _check_exprs(self, mi: ModuleInfo, fi: FuncInfo, taint: _Taint,
                     node: ast.AST) -> None:
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            name = dotted(n.func) or ""
            if isinstance(n.func, ast.Name):
                if n.func.id in HOST_FORCERS and len(n.args) == 1 \
                        and taint.expr(n.args[0]):
                    self._add(
                        "TPS502", mi, fi,
                        f"host-forcing {n.func.id}() on captured value "
                        f"{ast.unparse(n.args[0])}", n.lineno)
                elif n.func.id == "print":
                    self._add(
                        "TPS502", mi, fi,
                        "print() in a captured body fires at capture time "
                        "only, never on replay", n.lineno)
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in HOST_FORCER_ATTRS \
                    and not n.args and taint.expr(n.func.value):
                self._add(
                    "TPS502", mi, fi,
                    f"host-forcing .{n.func.attr}() on captured value "
                    f"{ast.unparse(n.func.value)}", n.lineno)
            sync = _is_sync(n)
            if sync is not None:
                self._add(
                    "TPS502", mi, fi,
                    f"{sync}() in a captured body syncs the host (illegal "
                    "while a graph records; a replay runs none of it)", n.lineno)
            if name.split(".")[0] in ("np", "numpy") and (
                    any(taint.expr(a) for a in n.args)
                    or any(taint.expr(kw.value) for kw in n.keywords)):
                self._add(
                    "TPS502", mi, fi,
                    f"{name}() on captured value forces a host transfer "
                    "(use torch)", n.lineno)

    # TPS501 over one function's register_program sites.
    def _check_register_sites(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        if fi.name.split(".")[-1] == "__init__":
            return
        local_defs = {n.name for n in ast.walk(fi.node)
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and n is not fi.node}
        for n in ast.walk(fi.node):
            if not isinstance(n, ast.Call):
                continue
            fn_arg = _registered_fn(n)
            if fn_arg is None:
                continue
            if isinstance(fn_arg, ast.Lambda) or (
                    isinstance(fn_arg, ast.Name) and fn_arg.id in local_defs):
                what = ("a lambda" if isinstance(fn_arg, ast.Lambda)
                        else f"locally-defined {ast.unparse(fn_arg)}")
                self._add(
                    "TPS501", mi, fi,
                    f"register_program({what}) registers a fresh function per "
                    "call, and each one captures a new graph (hoist the "
                    "function, or register it once)", n.lineno)

    # TPS504/TPS505 over one HOST-side function.
    def _check_closure_capture(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        node = fi.node
        params = set(_positional_params(node))
        if not params:
            return
        # Locals built per call from params via tensor constructors.
        fresh_arrays: dict[str, int] = {}
        for n in ast.walk(node):
            if not isinstance(n, ast.Assign) or len(n.targets) != 1 \
                    or not isinstance(n.targets[0], ast.Name):
                continue
            v = n.value
            if not isinstance(v, ast.Call):
                continue
            name = dotted(v.func) or ""
            ns, _, last = name.rpartition(".")
            if last in ARRAY_BUILDERS and ns in ARRAY_NAMESPACES:
                uses_param = any(
                    isinstance(sub, ast.Name) and sub.id in params
                    for a in [*v.args, *[kw.value for kw in v.keywords]]
                    for sub in ast.walk(a))
                if uses_param:
                    fresh_arrays[n.targets[0].id] = n.lineno
        local_fns = {n.name: n for n in ast.walk(node)
                     if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                     and n is not node}
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            fn_arg = _registered_fn(n)
            if fn_arg is None:
                continue
            target = None
            if isinstance(fn_arg, ast.Lambda):
                target = fn_arg
            elif isinstance(fn_arg, ast.Name) and fn_arg.id in local_fns:
                target = local_fns[fn_arg.id]
            if target is None:
                continue
            free = _free_names(target)
            label = (getattr(target, "name", None) or "lambda")
            for name in sorted(free & params):
                self._add(
                    "TPS505", mi, fi,
                    f"captured {label} captures enclosing argument {name!r} "
                    "by closure — baked into the graph at capture (pass it "
                    "as a program argument)", n.lineno)
            for name in sorted(free & set(fresh_arrays)):
                self._add(
                    "TPS504", mi, fi,
                    f"captured {label} captures {name!r}, a tensor built "
                    "per call from enclosing arguments (line "
                    f"{fresh_arrays[name]}) — the graph bakes its address "
                    "(pass it as a program argument)", n.lineno)

    # -- plumbing --------------------------------------------------------------

    def _add(self, rule: str, mi: ModuleInfo, fi: FuncInfo, message: str,
             line: int) -> None:
        f = Finding(rule=rule, file=mi.relpath, symbol=fi.qualname,
                    message=message, line=line)
        if f not in self.findings:
            self.findings.append(f)


def run_paths(files: list[Path], root: Path) -> list[Finding]:
    """Parse ``files``, run the TPS5xx rules, and honor inline sanctions."""
    modules = []
    sources: dict[str, list[str]] = {}
    for path in sorted(files):
        mi = _parse_module(path, root)
        if mi is not None:
            modules.append(mi)
            try:
                sources[mi.relpath] = path.read_text().splitlines()
            except OSError:
                pass
    findings = TraceAnalyzer(modules).run()
    return filter_sanctioned(findings, sources)
