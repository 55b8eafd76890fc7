"""Ledger escape analysis (TPS6xx) — acquire/release balance along the AST,
copied from ``tpuserve/analysis/ledgerlint.py`` (rules and messages
unchanged; the port's ledgers carry the same class names:
``genserve/arena.py`` ``SlotArena``, ``genserve/pages.py`` ``PageLedger``,
``hostpipe.py`` ``SlotPool`` and ``AssemblyArena``).

The serving path owns four acquire/release ledgers — ``SlotArena`` /
``PageLedger`` (genserve slot blocks + paged KV), ``AssemblyArena``
(recycled host batch buffers), ``SlotPool`` (staging / shm-slot
admission) — and each already carries a runtime tripwire
(``SlotCorrupted`` / ``PageCorrupted``) for double-release. This rule
catches the *other* direction ahead of runtime: an acquisition that
dominates an exception-capable region without a release on every path
leaks the entry forever (slots vanish from the pool, pages never return
to the free list).

- **TPS601** — after ``x = ledger.acquire(...)``, an await / call / raise
  executes while the entry is held, with no ``try`` whose ``finally`` or
  handler releases it.

Receivers are typed from their creation sites (``self.arena =
SlotArena(...)``, ``SlotPool(depth)``, lists of pools), exactly like
astlint types locks — no inference across objects beyond the attribute
name. The protection patterns honored:

- the acquire sits inside a ``try`` whose ``finally`` or any handler
  releases the receiver — directly, or through a same-class method whose
  body releases it (``self._release_slot``-style funnels, one level);
- a subsequent ``try`` with such a handler/finally starts before any
  risky statement (the acquire-then-guard idiom);
- a guard ``if`` whose body releases the receiver (release-and-bail);
- ``return`` transfers ownership to the caller (long-lived entries — a
  genserve slot lives across iterations by design — are not findings:
  the rule is about exception windows, not held-at-exit);
- tracking stops at the enclosing loop boundary (an entry that survives
  a loop iteration is long-lived by design).

``try_acquire`` (returns ``None`` instead of blocking) is not tracked:
its callers branch on the result, which a linear scan cannot follow.
Inline sanctions use the same annotation tracelint honors::

    slot = pool.acquire()  # tps-ok[TPS601]: released by the reaper task

Pure AST — no torch import — so ``python -m tpuserve_torch lint``
runs on a bare Python.
"""

from __future__ import annotations

import ast
from pathlib import Path

from tpuserve_torch.analysis.astlint import (
    FuncInfo,
    ModuleInfo,
    _parse_module,
    _self_attr,
    dotted,
)
from tpuserve_torch.analysis.findings import Finding
from tpuserve_torch.analysis.tracelint import filter_sanctioned

LEDGER_CLASSES = {"SlotArena", "PageLedger", "AssemblyArena", "SlotPool"}


def _ledger_ctor(value: ast.AST) -> str | None:
    """Ledger class name when ``value`` constructs one (directly or as a
    list/comprehension of them), else None."""
    if isinstance(value, ast.Call):
        name = (dotted(value.func) or "").split(".")[-1]
        if name in LEDGER_CLASSES:
            return name
    if isinstance(value, ast.ListComp):
        return _ledger_ctor(value.elt)
    if isinstance(value, (ast.List, ast.Tuple)) and value.elts:
        return _ledger_ctor(value.elts[0])
    return None


def _receiver_name(node: ast.AST) -> str | None:
    """The identifying attribute/variable name of an acquire/release
    receiver: ``self.arena`` -> 'arena', ``w.slots`` -> 'slots',
    ``self._staging[i]`` -> '_staging', ``pool`` -> 'pool'."""
    if isinstance(node, ast.Subscript):
        return _receiver_name(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _collect_ledger_names(modules: list[ModuleInfo]) -> dict[str, str]:
    """attr/var name -> ledger class, from every creation site in the
    module set (cross-module on purpose: the engine's ``self.pages`` is a
    ``PageLedger`` no matter which file reads it)."""
    out: dict[str, str] = {}
    for mi in modules:
        for n in ast.walk(mi.tree):
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                cls = _ledger_ctor(n.value)
                name = _receiver_name(n.targets[0])
                if cls and name:
                    out[name] = cls
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                cls = _ledger_ctor(n.value)
                name = _receiver_name(n.target)
                if cls and name:
                    out[name] = cls
    return out


def _is_release(node: ast.AST, recv: str) -> bool:
    """True when ``node`` releases receiver ``recv`` (release/release_all/
    close on the same-named receiver)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("release", "release_all", "close") \
                and _receiver_name(n.func.value) == recv:
            return True
    return False


def _shallow_nodes(stmt: ast.stmt):
    """The statement's own expression nodes — no descent into nested
    statement blocks (those are scanned as their own blocks) or defs."""
    stack = [stmt]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.stmt, ast.FunctionDef,
                              ast.AsyncFunctionDef, ast.Lambda,
                              ast.ExceptHandler)):
                continue
            stack.append(c)


def _walk_no_defs(node: ast.AST):
    """ast.walk without descending into nested function bodies."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            stack.append(c)


class LedgerAnalyzer:
    def __init__(self, modules: list[ModuleInfo]) -> None:
        self.modules = modules
        self.ledgers = _collect_ledger_names(modules)
        self.findings: list[Finding] = []

    def run(self) -> list[Finding]:
        for mi in self.modules:
            for fi in mi.functions.values():
                if "<locals>" in fi.name:
                    continue  # subtree of its owner; scanned there
                self._check_function(mi, fi)
        self.findings.sort(key=lambda f: (f.file, f.line, f.rule, f.symbol))
        return self.findings

    # -- release resolution ---------------------------------------------------

    def _releases(self, mi: ModuleInfo, cls: str | None, node: ast.AST,
                  recv: str) -> bool:
        """``node`` releases ``recv`` directly, or calls a same-class /
        same-module funnel whose body does (one level deep)."""
        if _is_release(node, recv):
            return True
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            callee = None
            attr = _self_attr(n.func)
            if attr is not None and cls is not None:
                callee = mi.functions.get(f"{cls}.{attr}")
            elif isinstance(n.func, ast.Name):
                callee = mi.functions.get(n.func.id)
            if callee is not None and _is_release(callee.node, recv):
                return True
        return False

    # -- the scan -------------------------------------------------------------

    def _check_function(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        # Parent chain for enclosing-try protection checks.
        parents: dict[int, ast.AST] = {}
        for p in ast.walk(fi.node):
            for c in ast.iter_child_nodes(p):
                parents[id(c)] = p

        def enclosing_protected(stmt: ast.AST, recv: str) -> bool:
            n = stmt
            while id(n) in parents:
                n = parents[id(n)]
                if isinstance(n, ast.Try):
                    handlers = [*(h for h in n.handlers), ]
                    if any(self._releases(mi, fi.cls, h, recv)
                           for h in handlers) \
                            or self._releases(
                                mi, fi.cls,
                                ast.Module(body=n.finalbody,
                                           type_ignores=[]), recv):
                        return True
                if n is fi.node:
                    break
            return False

        # Find acquire statements: any statement whose OWN expressions
        # contain ``<typed receiver>.acquire(...)`` (awaited/assigned ok).
        for block, idx, recv, cls_name, line in self._acquires(fi):
            if enclosing_protected(block[idx], recv):
                continue
            hazard = self._scan_after(mi, fi, parents, block, idx, recv)
            if hazard is not None:
                kind, hline = hazard
                # Anchored at the ACQUIRE site — that is where the inline
                # ``# tps-ok[TPS601]: reason`` sanction goes.
                self._add(
                    "TPS601", mi, fi,
                    f"{cls_name} '{recv}' acquired here is held across an "
                    f"exception-capable {kind} (line {hline}) with no "
                    "try/finally or except-path release", line)

    def _acquires(self, fi: FuncInfo):
        """(directly enclosing block, index, receiver, class, line) for
        each typed-ledger ``.acquire(...)`` statement in ``fi``."""
        out = []

        def visit_block(body: list[ast.stmt]) -> None:
            for i, stmt in enumerate(body):
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit_block(stmt.body)
                    continue
                for n in _shallow_nodes(stmt):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and n.func.attr == "acquire":
                        recv = _receiver_name(n.func.value)
                        cls = self.ledgers.get(recv or "")
                        if cls:
                            out.append((body, i, recv, cls, n.lineno))
                for name in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, name, None)
                    if isinstance(sub, list) and sub:
                        visit_block(sub)
                for h in getattr(stmt, "handlers", ()):
                    visit_block(h.body)

        visit_block(fi.node.body)
        return out

    def _scan_after(self, mi: ModuleInfo, fi: FuncInfo,
                    parents: dict[int, ast.AST], block: list[ast.stmt],
                    idx: int, recv: str):
        """Walk statements after the acquire; return (kind, line) for the
        first unprotected exception-capable statement, None when the
        window closes safely (release / protecting try / return / guard /
        loop boundary / end of function)."""
        # Owner map: block list -> the compound statement (or function)
        # holding it, so block exhaustion can unwind outward.
        owner: dict[int, ast.AST] = {id(fi.node.body): fi.node}
        for n in ast.walk(fi.node):
            for name in ("body", "orelse", "finalbody"):
                blk = getattr(n, name, None)
                if isinstance(blk, list):
                    owner.setdefault(id(blk), n)
            for h in getattr(n, "handlers", ()):
                owner.setdefault(id(h.body), n)

        body, i = block, idx + 1
        while True:
            while i < len(body):
                stmt = body[i]
                i += 1
                verdict = self._classify(mi, fi, stmt, recv)
                if verdict in ("released", "protected-closed"):
                    return None
                if verdict == "safe":
                    continue
                return verdict  # (kind, line) hazard tuple
            comp = owner.get(id(body))
            if comp is None or comp is fi.node \
                    or isinstance(comp, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                return None  # end of function: held-at-exit is by design
            if isinstance(comp, (ast.For, ast.AsyncFor, ast.While)):
                return None  # loop boundary: long-lived by design
            parent_body = None
            grand = parents.get(id(comp))
            if grand is not None:
                for name in ("body", "orelse", "finalbody"):
                    blk = getattr(grand, name, None)
                    if isinstance(blk, list) and comp in blk:
                        parent_body = blk
                for h in getattr(grand, "handlers", ()):
                    if comp in h.body:
                        parent_body = h.body
            if parent_body is None:
                return None
            body, i = parent_body, parent_body.index(comp) + 1

    def _classify(self, mi: ModuleInfo, fi: FuncInfo, stmt: ast.stmt,
                  recv: str):
        """'released' | 'protected-closed' | 'safe' | (kind, line)."""
        if isinstance(stmt, ast.Try):
            protects = any(self._releases(mi, fi.cls, h, recv)
                           for h in stmt.handlers) \
                or self._releases(mi, fi.cls,
                                  ast.Module(body=stmt.finalbody,
                                             type_ignores=[]), recv)
            if protects:
                # finally-release closes the window entirely; handler-only
                # release leaves the success path holding (by design —
                # ownership passed to runtime machinery). Either way the
                # escape window is closed.
                return "protected-closed"
            # An unprotecting try is only as safe as its contents.
            hazard = self._first_hazard(stmt, recv)
            return hazard if hazard is not None else "safe"
        if isinstance(stmt, ast.If):
            # Guard-release idiom: a branch that releases and bails is part
            # of the release protocol; the statement as a whole is safe iff
            # neither branch contains an unguarded hazard. The held path
            # continues to be scanned after the if.
            for branch in (stmt.body, stmt.orelse):
                branch_mod = ast.Module(body=branch, type_ignores=[])
                if self._releases(mi, fi.cls, branch_mod, recv):
                    continue
                hazard = self._first_hazard(branch_mod, recv)
                if hazard is not None:
                    return hazard
            return "safe"
        if self._releases(mi, fi.cls, stmt, recv):
            # Direct release (or a call into a same-class release funnel).
            return "released"
        if isinstance(stmt, (ast.Return, ast.Break, ast.Continue)):
            return "released"  # ownership transfer / loop boundary
        hazard = self._first_hazard(stmt, recv)
        return hazard if hazard is not None else "safe"

    def _first_hazard(self, node: ast.AST, recv: str):
        """(kind, line) for the first await/call/raise in ``node`` that is
        not an operation on the receiver itself, else None."""
        for n in _walk_no_defs(node):
            if isinstance(n, ast.Raise):
                return ("raise", n.lineno)
            if isinstance(n, ast.Await):
                return ("await", n.lineno)
            if isinstance(n, ast.Call):
                if isinstance(n.func, ast.Attribute) \
                        and _receiver_name(n.func.value) == recv:
                    continue  # ops on the ledger itself
                return ("call", n.lineno)
        return None

    def _add(self, rule: str, mi: ModuleInfo, fi: FuncInfo, message: str,
             line: int) -> None:
        f = Finding(rule=rule, file=mi.relpath, symbol=fi.qualname,
                    message=message, line=line)
        if f not in self.findings:
            self.findings.append(f)


def run_paths(files: list[Path], root: Path) -> list[Finding]:
    """Parse ``files``, run the TPS6xx rules, and honor inline sanctions."""
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
    findings = LedgerAnalyzer(modules).run()
    return filter_sanctioned(findings, sources)
