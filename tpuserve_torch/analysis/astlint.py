"""AST concurrency lint over the port's serving path, copied from
``tpuserve/analysis/astlint.py`` (its rules and messages unchanged).

Three rule families, tuned to this repo's architecture — one asyncio event
loop fronting per-stage thread pools, worker processes, and 15+ named locks:

- **TPS101 / TPS102 — blocking on the event loop.** TPS101 flags blocking
  primitives (``time.sleep``, sync file/socket/subprocess IO) called in an
  ``async def`` body or in a sync function the async body calls *directly*
  (a bounded call-graph walk: work handed to ``run_in_executor`` /
  ``StageExecutors.run`` passes a reference, not a call, so it never creates
  an edge). It also flags loop-side ``.result()`` / ``.join()`` and blocking
  ``acquire()``/``wait()`` on a known threading lock inside async bodies.
  TPS102 flags a threading lock held across an ``await`` (a ``with`` over a
  thread-family lock whose body awaits) — the static twin of the runtime
  witness's LockHeldAcrossAwait.

- **TPS201 — lock-order cycles.** Lock attributes are typed from their
  creation sites (``threading.Lock()`` / ``utils.locks.new_lock`` vs
  ``asyncio.Lock()`` / ``new_async_lock``); nested ``with lock:`` scopes
  (plus locks acquired by functions called while a lock is held, one level
  deep) build a global acquisition graph, and any cycle — the classic AB/BA
  inversion — is reported with both acquisition sites.

- **TPS301 — unguarded cross-context writes.** Per class, every method is
  placed in an execution context: event loop (``async def``, or referenced
  by ``call_soon*``/``call_later``/``add_done_callback``) or executor thread
  (referenced by ``run_in_executor``/``submit``/``map``/``Thread(target=)``),
  with contexts and held locks propagated through intra-class calls to a
  fixpoint. An instance attribute mutated from both contexts with no common
  threading lock on every path is flagged.

Honest limits: resolution is name-based within a module/class (no type
inference across objects), so cross-object mutation (``w.rows_used += 1``)
and dynamically-dispatched calls are invisible — that residue is exactly
what the runtime witness covers. Findings must be read with the baseline
workflow in mind: ``tpuserve_torch/analysis/baseline.json`` holds accepted
debt.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from tpuserve_torch.analysis.findings import Finding

THREAD_LOCK_FACTORIES = {
    "threading.Lock",
    "threading.RLock",
    "new_lock",
    "locks.new_lock",
}
THREAD_COND_FACTORIES = {
    "threading.Condition",
    "threading.Event",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
}
ASYNC_LOCK_FACTORIES = {
    "asyncio.Lock",
    "asyncio.Condition",
    "asyncio.Semaphore",
    "asyncio.Event",
    "new_async_lock",
    "locks.new_async_lock",
}

# Blocking in ANY loop-executed code: flagged in async bodies and propagated
# through directly-called sync helpers.
BLOCKING_CALLS = {
    "time.sleep",
    "os.system",
    "os.waitpid",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "socket.create_connection",
    "socket.getaddrinfo",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
    "requests.request",
}
BLOCKING_BUILTINS = {"open", "input"}

# Blocking only worth flagging when written directly in an async body (sync
# helpers use these legitimately on executor threads).
ASYNC_ONLY_ATTRS = {"result", "join"}

MUTATOR_ATTRS = {
    "append",
    "appendleft",
    "extend",
    "insert",
    "remove",
    "pop",
    "popleft",
    "popitem",
    "clear",
    "update",
    "setdefault",
    "add",
    "discard",
}

THREAD_SCHEDULERS = {"run_in_executor", "submit", "map"}
LOOP_SCHEDULERS = {
    "call_soon",
    "call_soon_threadsafe",
    "call_later",
    "call_at",
    "add_done_callback",
}

MAX_CALL_DEPTH = 4


def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _self_attr(node: ast.AST) -> str | None:
    """'X' when node is ``self.X``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _lock_family(call: ast.AST) -> str | None:
    """'thread' / 'async' when ``call`` constructs a known lock, else None."""
    if not isinstance(call, ast.Call):
        return None
    name = dotted(call.func)
    if name is None:
        return None
    if name in THREAD_LOCK_FACTORIES or name in THREAD_COND_FACTORIES:
        return "thread"
    if name in ASYNC_LOCK_FACTORIES:
        return "async"
    # The named constructors also match when imported qualified
    # (tpuserve_torch.utils.locks.new_lock) or called through an alias ending in
    # the bare helper name.
    short = name.split(".")[-1]
    if short == "new_lock":
        return "thread"
    if short == "new_async_lock":
        return "async"
    return None


@dataclass
class FuncInfo:
    module: str
    cls: str | None
    name: str
    node: ast.AST
    is_async: bool

    @property
    def qualname(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


@dataclass
class ModuleInfo:
    relpath: str
    modname: str
    tree: ast.Module
    class_locks: dict[str, dict[str, str]] = field(default_factory=dict)
    module_locks: dict[str, str] = field(default_factory=dict)
    functions: dict[str, FuncInfo] = field(default_factory=dict)  # qualname ->


def _walk_skipping_defs(node: ast.AST):
    """Yield nodes of ``node``'s body without descending into nested defs."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _collect_nested(mi: ModuleInfo, owner: FuncInfo) -> None:
    """Register defs nested inside ``owner`` under ``<locals>`` qualnames.

    Async generators defined inside handler functions (PR 17's streaming
    bodies) run ON the event loop when iterated, but used to be invisible:
    only top-level and class-level defs were collected, so the blocking-call
    rules never saw them. The ``<locals>`` qualname keeps them out of the
    bare-name resolution map (``_resolve_call`` looks up ``f`` or
    ``Cls.f``), so they are checked directly without becoming accidental
    call-graph targets."""
    for sub in ast.walk(owner.node):
        if sub is owner.node:
            continue
        if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fi = FuncInfo(
            mi.modname,
            owner.cls,
            f"{owner.name}.<locals>.{sub.name}",
            sub,
            isinstance(sub, ast.AsyncFunctionDef),
        )
        mi.functions.setdefault(fi.qualname, fi)


def _parse_module(path: Path, root: Path) -> ModuleInfo | None:
    try:
        src = path.read_text()
        tree = ast.parse(src, filename=str(path))
    except (OSError, SyntaxError):
        return None
    rel = path.relative_to(root).as_posix() if path.is_relative_to(root) else path.name
    modname = rel[:-3].replace("/", ".") if rel.endswith(".py") else rel
    mi = ModuleInfo(relpath=rel, modname=modname, tree=tree)

    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            fam = _lock_family(stmt.value)
            if fam and isinstance(stmt.targets[0], ast.Name):
                mi.module_locks[stmt.targets[0].id] = fam
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi = FuncInfo(modname, None, stmt.name, stmt, isinstance(stmt, ast.AsyncFunctionDef))
            mi.functions[fi.qualname] = fi
        elif isinstance(stmt, ast.ClassDef):
            locks: dict[str, str] = {}
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    attr = _self_attr(sub.targets[0])
                    fam = _lock_family(sub.value)
                    if attr and fam:
                        locks[attr] = fam
            mi.class_locks[stmt.name] = locks
            for item in stmt.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fi = FuncInfo(
                        modname,
                        stmt.name,
                        item.name,
                        item,
                        isinstance(item, ast.AsyncFunctionDef),
                    )
                    mi.functions[fi.qualname] = fi
    for fi in list(mi.functions.values()):
        _collect_nested(mi, fi)
    return mi


class Analyzer:
    """Cross-module rule driver over a set of parsed modules."""

    def __init__(self, modules: list[ModuleInfo]) -> None:
        self.modules = modules
        self.findings: list[Finding] = []

    def run(self) -> list[Finding]:
        edges: list[tuple[str, str, str, str, int]] = []  # (a, b, file, symbol, line)
        for mi in self.modules:
            for fi in mi.functions.values():
                if fi.is_async:
                    self._check_async_body(mi, fi)
                    self._check_lock_across_await(mi, fi)
            edges.extend(self._lock_edges(mi))
        self._check_lock_cycles(edges)
        for mi in self.modules:
            for stmt in mi.tree.body:
                if isinstance(stmt, ast.ClassDef):
                    self._check_shared_state(mi, stmt)
        self.findings.sort(key=lambda f: (f.file, f.line, f.rule, f.symbol))
        return self.findings

    # -- shared resolution helpers -------------------------------------------

    def _lock_id(self, mi: ModuleInfo, cls: str | None, node: ast.AST) -> tuple[str, str] | None:
        """(lock id, family) for a lock-valued expression, else None."""
        attr = _self_attr(node)
        if attr is not None and cls is not None:
            fam = mi.class_locks.get(cls, {}).get(attr)
            if fam:
                return f"{mi.modname}.{cls}.{attr}", fam
        if isinstance(node, ast.Name) and node.id in mi.module_locks:
            return f"{mi.modname}.{node.id}", mi.module_locks[node.id]
        return None

    def _resolve_call(self, mi: ModuleInfo, cls: str | None, call: ast.Call) -> FuncInfo | None:
        """Resolve a direct call to a same-module function / same-class
        method. Cross-object calls resolve to None on purpose (no type
        inference — see module docstring)."""
        func = call.func
        attr = _self_attr(func)
        if attr is not None and cls is not None:
            return mi.functions.get(f"{cls}.{attr}")
        if isinstance(func, ast.Name):
            return mi.functions.get(func.id)
        return None

    # -- TPS101: blocking reachable from async -------------------------------

    def _direct_blocking(self, node: ast.AST, awaited: set[int]) -> list[tuple[str, int]]:
        out = []
        for n in _walk_skipping_defs(node):
            if isinstance(n, ast.Await):
                awaited.add(id(n.value))
            if not isinstance(n, ast.Call) or id(n) in awaited:
                continue
            name = dotted(n.func)
            if name in BLOCKING_CALLS:
                out.append((name, n.lineno))
            elif isinstance(n.func, ast.Name) and n.func.id in BLOCKING_BUILTINS:
                out.append((f"{n.func.id}()", n.lineno))
        return out

    def _check_async_body(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        awaited: set[int] = set()
        for n in _walk_skipping_defs(fi.node):
            if isinstance(n, ast.Await):
                awaited.add(id(n.value))
        parents: dict[int, ast.AST] = {}
        for p in ast.walk(fi.node):
            for c in ast.iter_child_nodes(p):
                parents[id(c)] = p
        # Direct blocking primitives + loop-only smells in the async body.
        for desc, line in self._direct_blocking(fi.node, awaited):
            self._add("TPS101", mi, fi.qualname, f"blocking call {desc} in async def", line)
        for n in _walk_skipping_defs(fi.node):
            if not isinstance(n, ast.Call) or id(n) in awaited:
                continue
            if isinstance(n.func, ast.Attribute):
                if n.func.attr in ASYNC_ONLY_ATTRS and not n.args and not n.keywords:
                    if self._done_guarded(parents, n):
                        continue  # t.result() under `if t.done():` — no wait
                    self._add(
                        "TPS101",
                        mi,
                        fi.qualname,
                        f"blocking .{n.func.attr}() in async def",
                        n.lineno,
                    )
                elif n.func.attr in ("acquire", "wait"):
                    lock = self._lock_id(mi, fi.cls, n.func.value)
                    if lock and lock[1] == "thread":
                        self._add(
                            "TPS101",
                            mi,
                            fi.qualname,
                            f"blocking {lock[0]}.{n.func.attr}() in async def",
                            n.lineno,
                        )
        # Propagate through directly-called sync helpers (bounded DFS).
        self._reach_blocking(mi, fi, fi.node, awaited, [fi.qualname], set())

    @staticmethod
    def _done_guarded(parents: dict[int, ast.AST], call: ast.Call) -> bool:
        """True for ``t.result()`` inside the body of ``if t.done():`` — the
        task already completed, so the read cannot block the loop."""
        if call.func.attr != "result":
            return False
        recv = dotted(call.func.value)
        if recv is None:
            return False
        child: ast.AST = call
        n: ast.AST = call
        while id(n) in parents:
            child, n = n, parents[id(n)]
            if not isinstance(n, ast.If) or child not in n.body:
                continue
            for sub in ast.walk(n.test):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "done" \
                        and dotted(sub.func.value) == recv:
                    return True
        return False

    def _reach_blocking(self, mi, fi, node, awaited, path, seen) -> None:
        if len(path) > MAX_CALL_DEPTH:
            return
        for n in _walk_skipping_defs(node):
            if not isinstance(n, ast.Call):
                continue
            callee = self._resolve_call(mi, fi.cls, n)
            if callee is None or callee.is_async or callee.qualname in seen:
                continue
            seen.add(callee.qualname)
            sub_awaited: set[int] = set()
            for hit, _line in self._direct_blocking(callee.node, sub_awaited):
                self._add(
                    "TPS101",
                    mi,
                    path[0],
                    f"blocking call {hit} reachable from async def via "
                    + " -> ".join([*path[1:], callee.qualname]),
                    n.lineno,
                )
            self._reach_blocking(mi, callee, callee.node, sub_awaited, [*path, callee.qualname], seen)

    # -- TPS102: threading lock held across await ----------------------------

    def _check_lock_across_await(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        for n in _walk_skipping_defs(fi.node):
            if not isinstance(n, ast.With):
                continue
            for item in n.items:
                lock = self._lock_id(mi, fi.cls, item.context_expr)
                if lock is None or lock[1] != "thread":
                    continue
                body_awaits = any(
                    isinstance(sub, ast.Await)
                    for stmt in n.body
                    for sub in [stmt, *_walk_skipping_defs(stmt)]
                )
                if body_awaits:
                    self._add(
                        "TPS102",
                        mi,
                        fi.qualname,
                        f"threading lock {lock[0]} held across await",
                        n.lineno,
                    )

    # -- TPS201: lock-order graph --------------------------------------------

    def _locks_acquired_in(self, mi: ModuleInfo, fi: FuncInfo) -> list[tuple[str, int]]:
        out = []
        for n in _walk_skipping_defs(fi.node):
            if isinstance(n, ast.With):
                for item in n.items:
                    lock = self._lock_id(mi, fi.cls, item.context_expr)
                    if lock:
                        out.append((lock[0], n.lineno))
        return out

    def _lock_edges(self, mi: ModuleInfo) -> list[tuple[str, str, str, str, int]]:
        edges = []

        def visit(fi: FuncInfo, node: ast.AST, held: list[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, ast.With):
                    acquired = []
                    for item in child.items:
                        lock = self._lock_id(mi, fi.cls, item.context_expr)
                        if lock:
                            for h in held:
                                if h != lock[0]:
                                    edges.append((h, lock[0], mi.relpath, fi.qualname, child.lineno))
                            acquired.append(lock[0])
                    visit(fi, child, held + acquired)
                    continue
                if isinstance(child, ast.Call) and held:
                    callee = self._resolve_call(mi, fi.cls, child)
                    if callee is not None:
                        for lock_id, line in self._locks_acquired_in(mi, callee):
                            for h in held:
                                if h != lock_id:
                                    edges.append((h, lock_id, mi.relpath, fi.qualname, child.lineno))
                visit(fi, child, held)

        for fi in mi.functions.values():
            visit(fi, fi.node, [])
        return edges

    def _check_lock_cycles(self, edges: list[tuple[str, str, str, str, int]]) -> None:
        succ: dict[str, set[str]] = {}
        first_site: dict[tuple[str, str], tuple[str, str, int]] = {}
        for a, b, f, sym, line in edges:
            succ.setdefault(a, set()).add(b)
            first_site.setdefault((a, b), (f, sym, line))

        def path(start: str, goal: str) -> list[str] | None:
            stack, seen = [(start, [start])], {start}
            while stack:
                node, p = stack.pop()
                if node == goal:
                    return p
                for nxt in sorted(succ.get(node, ())):
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append((nxt, [*p, nxt]))
            return None

        reported: set[frozenset] = set()
        for (a, b), (f, sym, line) in sorted(first_site.items()):
            back = path(b, a)
            if back is None:
                continue
            cycle = [a, *back]
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            sites = []
            for x, y in zip(cycle, cycle[1:]):
                sf, ssym, _sl = first_site[(x, y)]
                sites.append(f"{x}->{y} in {ssym} ({sf})")
            self._add_raw(
                Finding(
                    rule="TPS201",
                    file=f,
                    symbol=" -> ".join(cycle),
                    message="lock-order cycle: " + "; ".join(sites),
                    line=line,
                )
            )

    # -- TPS301: unguarded cross-context writes ------------------------------

    def _check_shared_state(self, mi: ModuleInfo, cls: ast.ClassDef) -> None:
        lock_attrs = {a for a, fam in mi.class_locks.get(cls.name, {}).items() if fam == "thread"}
        methods = {
            fi.name: fi
            for fi in mi.functions.values()
            if fi.cls == cls.name and fi.name not in ("__init__", "__post_init__")
        }
        # Per method: writes/calls with the lexical thread-lock guards active.
        writes: dict[str, list[tuple[str, frozenset, int]]] = {m: [] for m in methods}
        calls: dict[str, list[tuple[str, frozenset]]] = {m: [] for m in methods}
        seeds: set[tuple[str, str]] = set()  # (method, ctx)

        def written_attr(n: ast.AST) -> str | None:
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        return attr
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                        if attr is not None:
                            return attr
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
                if n.func.attr in MUTATOR_ATTRS:
                    attr = _self_attr(n.func.value)
                    if attr is not None:
                        return attr
            return None

        def scan(mname: str, fi: FuncInfo, node: ast.AST, guards: frozenset) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, ast.With):
                    acquired = set()
                    for item in child.items:
                        attr = _self_attr(item.context_expr)
                        if attr in lock_attrs:
                            acquired.add(attr)
                    scan(mname, fi, child, guards | acquired)
                    continue
                attr = written_attr(child)
                if attr is not None and attr not in lock_attrs:
                    writes[mname].append((attr, guards, child.lineno))
                if isinstance(child, ast.Call):
                    callee = self._resolve_call(mi, cls.name, child)
                    if callee is not None and callee.name in methods:
                        calls[mname].append((callee.name, guards))
                    self._scan_scheduling(child, methods, seeds)
                scan(mname, fi, child, guards)

        for mname, fi in methods.items():
            if fi.is_async:
                seeds.add((mname, "loop"))
            scan(mname, fi, fi.node, frozenset())

        # Propagate (ctx, held-at-entry) through intra-class calls. Entry
        # state per (method, ctx) is the INTERSECTION over paths: a write is
        # guarded only if the lock is held however the method was reached.
        entry: dict[tuple[str, str], frozenset] = {}
        work = [(m, ctx, frozenset()) for m, ctx in seeds]
        while work:
            mname, ctx, held = work.pop()
            key = (mname, ctx)
            merged = held if key not in entry else entry[key] & held
            if key in entry and merged == entry[key]:
                continue
            entry[key] = merged
            for callee, site_guards in calls.get(mname, ()):
                work.append((callee, ctx, merged | site_guards))

        # An attribute written unguarded from both contexts (no common lock
        # between the thread-side and loop-side writes) is a race.
        per_attr: dict[str, dict[str, list[tuple[frozenset, str]]]] = {}
        for (mname, ctx), held in entry.items():
            for attr, guards, _line in writes.get(mname, ()):
                per_attr.setdefault(attr, {}).setdefault(ctx, []).append(
                    (guards | held, mname)
                )
        for attr, by_ctx in sorted(per_attr.items()):
            for tguards, tmeth in by_ctx.get("thread", ()):
                for lguards, lmeth in by_ctx.get("loop", ()):
                    if tguards & lguards:
                        continue
                    self._add_raw(
                        Finding(
                            rule="TPS301",
                            file=mi.relpath,
                            symbol=f"{cls.name}.{attr}",
                            message=(
                                f"written from executor-thread context ({tmeth}) and "
                                f"event-loop context ({lmeth}) with no common lock"
                            ),
                            line=cls.lineno,
                        )
                    )
                    break
                else:
                    continue
                break

    def _scan_scheduling(self, call: ast.Call, methods: dict, seeds: set) -> None:
        """Record methods handed to executors/threads vs loop callbacks."""
        ctx = None
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr in THREAD_SCHEDULERS:
                ctx = "thread"
            elif func.attr in LOOP_SCHEDULERS:
                ctx = "loop"
        name = dotted(func) or ""
        values = list(call.args) + [kw.value for kw in call.keywords]
        if name.split(".")[-1] == "Thread":
            ctx = "thread"
        if ctx is None:
            return
        for v in values:
            attr = _self_attr(v)
            if attr in methods:
                seeds.add((attr, ctx))

    # -- plumbing ------------------------------------------------------------

    def _add(self, rule: str, mi: ModuleInfo, symbol: str, message: str, line: int) -> None:
        self._add_raw(Finding(rule=rule, file=mi.relpath, symbol=symbol, message=message, line=line))

    def _add_raw(self, finding: Finding) -> None:
        if finding not in self.findings:
            self.findings.append(finding)


def run_paths(files: list[Path], root: Path) -> list[Finding]:
    """Parse ``files`` and run every AST rule family; returns findings."""
    modules = []
    for path in sorted(files):
        mi = _parse_module(path, root)
        if mi is not None:
            modules.append(mi)
    return Analyzer(modules).run()


def collect_files(paths: list[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files
