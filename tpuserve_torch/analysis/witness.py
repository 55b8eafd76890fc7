"""Runtime witnesses, copied from ``tpuserve/analysis/witness.py``: a
Python-level mini-TSan for the port's serving path, and the retrace witness.

The static pass (tpuserve_torch.analysis.astlint) sees lock *sites*; this
module watches lock *instances* live. When ``TPUSERVE_LOCK_WITNESS=1``,
every lock built through ``tpuserve_torch.utils.locks.new_lock`` /
``new_async_lock`` becomes a witness wrapper that:

- records, per thread (and per asyncio task for async locks), the stack of
  currently-held witnessed locks;
- maintains one global lock-order graph keyed by lock *name* (the creation
  site, e.g. ``deferred.spawn``), adding an edge H -> L whenever L is
  acquired while H is held, and **raising LockOrderViolation** the moment a
  new edge closes a cycle — an AB/BA inversion is reported at acquisition
  time, deterministically, instead of as a once-a-month production deadlock;
- via an asyncio task factory (``install``), checks at **every coroutine
  suspension** that the event-loop thread holds no witnessed ``threading``
  lock, raising LockHeldAcrossAwait with the acquisition stack when one is
  held across an ``await`` (asyncio locks are exempt: holding those across
  awaits is their job).

Violations raise because silent logging defeats the point: a drill asserts
availability, and a raised violation fails the run visibly. ``snapshot()``
exposes the observed graph (``/stats`` ``robustness.lock_witness`` when the
witness is on).

Scope and honesty: only locks created through the named constructors are
witnessed — third-party and stdlib-internal locks are invisible, and a lock
acquired and released inside one bytecode run of a C extension cannot be
seen at all.

A second, independent witness lives here too: the **retrace witness**
(``TPUSERVE_RETRACE_WITNESS=1``). The static pass (tracelint, TPS5xx)
proves capture discipline over what it can see; the residue only shows up
as ``runtime_compiles_total`` or a variant's ``captures`` ticking under
load. The server declares a *warmup barrier* once startup is done
(``declare_warmup_complete``); after it, every compile the runtime reports
through ``note_compile(tag, variant)`` and every CUDA-graph capture it
reports through ``note_capture(tag, variant)`` raises **RetraceViolation
naming the (tag, variant)** unless it happens inside a
``sanctioned_compiles()`` window (the lifecycle's stage-time
``ensure_compiled`` is the one such window: warming a cold or demoted model
compiles and captures by design). The torch half — the sync guard armed at
the barrier (``torch.cuda.set_sync_debug_mode("error")``), the blessed
``host_fetch`` readback and the ``allow_transfers`` windows — lives in
``tpuserve_torch.utils.retrace`` so this module imports no torch; it counts
the windows here (``note_transfer_window``).
"""

from __future__ import annotations

import asyncio
import os
import sys
import threading

_ENV = "TPUSERVE_LOCK_WITNESS"
_TRUE = ("1", "true", "yes", "on")

# Bound kept state: violations and per-edge stacks are capped so a pathological
# run cannot grow memory without bound.
_MAX_VIOLATIONS = 64
_STACK_FRAMES = 8


class WitnessViolation(RuntimeError):
    """Base class for witness findings (raised, not logged: see module doc)."""


class LockOrderViolation(WitnessViolation):
    """A lock acquisition closed a cycle in the global lock-order graph."""


class LockHeldAcrossAwait(WitnessViolation):
    """A threading lock was held by the event-loop thread at a coroutine
    suspension point — the await parks the loop while the lock stays taken."""


_forced: bool | None = None


def enabled() -> bool:
    """Witness on? Env-driven (TPUSERVE_LOCK_WITNESS=1) unless force()d."""
    if _forced is not None:
        return _forced
    return os.environ.get(_ENV, "").strip().lower() in _TRUE


def force(value: bool | None) -> None:
    """Test hook: override the env check (None restores env behavior)."""
    global _forced
    _forced = value


def _site_frames() -> list[tuple[str, int, str]]:
    """The calling site's (file, line, function) frames, outermost first,
    the witness's own left out: read from the live frames, without
    ``traceback.extract_stack``'s source-line lookups. Every witnessed
    acquisition records one, so its cost is the witness's; it is formatted
    (``_format_site``) only when a report needs it."""
    frames = []
    f = sys._getframe()
    while f is not None:
        code = f.f_code
        if not code.co_filename.endswith("witness.py"):
            frames.append((code.co_filename, f.f_lineno, code.co_name))
        f = f.f_back
    frames.reverse()
    keep = [fr for fr in frames if "tpuserve" in fr[0]] or frames
    return keep[-_STACK_FRAMES:]


def _format_site(frames: list[tuple[str, int, str]]) -> str:
    """The reference's site string: ``file:line(function)`` joined by " <- "."""
    return " <- ".join(f"{os.path.basename(name)}:{line}({func})" for name, line, func in frames)


def _site_stack() -> str:
    return _format_site(_site_frames())


class _Registry:
    """Global witness state: held-lock stacks and the lock-order graph.

    Internal synchronization uses a RAW threading.Lock (never a WitnessLock:
    the registry must not witness itself). The graph is name-keyed, so two
    instances from one creation site share a node — an AB/BA inversion
    between *roles* is caught even across distinct instances.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        self.edges: dict[tuple[str, str], dict] = {}
        self.succ: dict[str, set[str]] = {}
        self.locks_seen: set[str] = set()
        self.acquisitions = 0
        self.violations: list[dict] = []
        # Held asyncio-lock names, with their acquisition sites' frames, per
        # task id (tasks are not weakly held long: entries are removed on
        # release, and a task dying mid-hold leaks one small list at most
        # until the same id is reused).
        self._task_held: dict[int, list[tuple[str, list]]] = {}

    # -- held-state ----------------------------------------------------------
    def _thread_held(self) -> list[tuple[str, str]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _current_task_id(self) -> int | None:
        try:
            task = asyncio.current_task()
        except RuntimeError:
            return None
        return None if task is None else id(task)

    def register(self, name: str) -> None:
        with self._mu:
            self.locks_seen.add(name)

    # -- threading-lock protocol --------------------------------------------
    def intent(self, name: str) -> None:
        """About to acquire ``name`` on this thread: record order edges from
        every lock already held here; raise if one closes a cycle."""
        self._note_edges(name, self._thread_held())

    def push(self, name: str) -> None:
        self._thread_held().append((name, _site_frames()))

    def pop(self, name: str) -> None:
        held = self._thread_held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                del held[i]
                return
        # Released on a different thread than it was acquired on (legal for
        # bare Lock, and happens when a violation unwound the holder): no-op.

    # -- asyncio-lock protocol ----------------------------------------------
    def async_intent(self, name: str) -> None:
        """Order edges for an async acquire: predecessors are the current
        task's held async locks plus this thread's held threading locks."""
        held = list(self._thread_held())
        tid = self._current_task_id()
        if tid is not None:
            held += self._task_held.get(tid, [])
        self._note_edges(name, held)

    def push_async(self, name: str) -> None:
        tid = self._current_task_id()
        if tid is not None:
            self._task_held.setdefault(tid, []).append((name, _site_frames()))

    def pop_async(self, name: str) -> None:
        tid = self._current_task_id()
        held = self._task_held.get(tid)
        if not held:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                del held[i]
                break
        if not held:
            self._task_held.pop(tid, None)

    # -- graph ---------------------------------------------------------------
    def _note_edges(self, name: str, held: list[tuple[str, list]]) -> None:
        if not held:
            with self._mu:
                self.acquisitions += 1
            return
        frames = _site_frames()  # formatted only for a new edge
        stack = None
        cycle_msg = None
        with self._mu:
            self.acquisitions += 1
            for prev, _ in held:
                if prev == name:
                    continue  # same-site reentry across instances: not an order
                key = (prev, name)
                if key in self.edges:
                    self.edges[key]["count"] += 1
                    continue
                stack = stack or _format_site(frames)
                path = self._find_path(name, prev)
                self.edges[key] = {"stack": stack, "count": 1}
                self.succ.setdefault(prev, set()).add(name)
                if path is not None:
                    cycle = [prev, name, *path[1:]]
                    cycle_msg = self._record_violation(
                        "lock_order",
                        "lock-order cycle: " + " -> ".join(cycle),
                        stack,
                    )
        if cycle_msg is not None:
            raise LockOrderViolation(cycle_msg)

    def _find_path(self, start: str, goal: str) -> list[str] | None:
        """Path start ->* goal over recorded edges (callers hold self._mu)."""
        stack = [(start, [start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            for nxt in self.succ.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, [*path, nxt]))
        return None

    def _record_violation(self, kind: str, message: str, stack: str) -> str:
        if len(self.violations) < _MAX_VIOLATIONS:
            self.violations.append({"kind": kind, "message": message, "stack": stack})
        return f"{message} [at {stack}]"

    # -- suspension check (task driver) --------------------------------------
    def check_suspension(self) -> None:
        held = self._thread_held()
        if not held:
            return
        detail = "; ".join(f"{name} (acquired at {_format_site(frames)})"
                           for name, frames in held)
        with self._mu:
            msg = self._record_violation(
                "held_across_await",
                f"threading lock(s) held across an await: {detail}",
                _site_stack(),
            )
        raise LockHeldAcrossAwait(msg)

    # -- admin ---------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            return {
                "locks": sorted(self.locks_seen),
                "acquisitions": self.acquisitions,
                "edges": sorted(
                    [a, b, info["count"]] for (a, b), info in self.edges.items()
                ),
                "violations": list(self.violations),
            }

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.succ.clear()
            self.locks_seen.clear()
            self.acquisitions = 0
            self.violations.clear()
            self._task_held.clear()
        self._tls.held = []


_REG = _Registry()


def snapshot() -> dict:
    """Observed lock graph + violations (the /stats lock_witness block)."""
    return _REG.snapshot()


def reset() -> None:
    """Test hook: drop all recorded graph/held state."""
    _REG.reset()


class WitnessLock:
    """Drop-in threading.Lock wrapper feeding the witness registry."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        _REG.register(name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _REG.intent(self.name)  # may raise LockOrderViolation, before blocking
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _REG.push(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        _REG.pop(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name} locked={self._lock.locked()}>"


class WitnessAsyncLock:
    """Drop-in asyncio.Lock wrapper feeding the witness registry.

    Holding one across an await is legal (that is what asyncio locks are
    for); it still participates in the order graph so an AB/BA inversion
    between two async locks — or an async lock nested against a threading
    lock on the loop thread — is caught."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = asyncio.Lock()
        _REG.register(name)

    async def acquire(self) -> bool:
        _REG.async_intent(self.name)  # may raise LockOrderViolation
        await self._lock.acquire()
        _REG.push_async(self.name)
        return True

    def release(self) -> None:
        self._lock.release()
        _REG.pop_async(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    async def __aenter__(self) -> None:
        await self.acquire()

    async def __aexit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessAsyncLock {self.name} locked={self._lock.locked()}>"


# ---------------------------------------------------------------------------
# Suspension instrumentation: a task factory whose tasks run coroutines
# through a driver that re-yields every suspension, checking held locks at
# each one. This is the piece that turns "lock held across await" from a
# code-review judgement into a deterministic runtime error.
# ---------------------------------------------------------------------------


class _YieldThrough:
    """Awaitable forwarding one raw yield (a Future or None) to the Task."""

    __slots__ = ("value",)

    def __init__(self, value) -> None:
        self.value = value

    def __await__(self):
        result = yield self.value
        return result


async def _driver(coro):
    """Step ``coro`` manually, checking witness state at every suspension."""
    send_value = None
    exc: BaseException | None = None
    while True:
        try:
            if exc is None:
                yielded = coro.send(send_value)
            else:
                pending, exc = exc, None
                yielded = coro.throw(pending)
        except StopIteration as stop:
            return stop.value
        try:
            _REG.check_suspension()
        except WitnessViolation:
            # Unwind the inner coroutine NOW so its with/finally blocks run
            # and release the offending lock; otherwise release would happen
            # nondeterministically at GC and poison this thread's held list.
            coro.close()
            raise
        try:
            send_value = await _YieldThrough(yielded)
        except BaseException as e:  # noqa: BLE001 — forwarded into coro
            send_value = None
            exc = e


def _task_factory(loop, coro, **kwargs):
    if asyncio.iscoroutine(coro):
        coro = _driver(coro)
    return asyncio.Task(coro, loop=loop, **kwargs)


def install(loop: asyncio.AbstractEventLoop | None = None) -> None:
    """Instrument task creation on ``loop`` (default: the running loop)."""
    if loop is None:
        loop = asyncio.get_running_loop()
    loop.set_task_factory(_task_factory)


def maybe_install(loop: asyncio.AbstractEventLoop | None = None) -> bool:
    """install() when the witness is enabled; returns whether it is."""
    if enabled():
        install(loop)
        return True
    return False


# ---------------------------------------------------------------------------
# Retrace witness: compile- and capture-stability assertions after the
# warmup barrier. Pure Python (no torch import) — tpuserve_torch.utils.retrace
# holds the torch half.
# ---------------------------------------------------------------------------

_RETRACE_ENV = "TPUSERVE_RETRACE_WITNESS"
_retrace_forced: bool | None = None


class RetraceViolation(WitnessViolation):
    """The runtime compiled a new variant or captured a CUDA graph after
    the warmup barrier — the steady-state compile- and capture-delta-0
    invariant broke, and the message names the (tag, variant)."""


def retrace_enabled() -> bool:
    """Retrace witness on? Env-driven unless force_retrace()d."""
    if _retrace_forced is not None:
        return _retrace_forced
    return os.environ.get(_RETRACE_ENV, "").strip().lower() in _TRUE


def force_retrace(value: bool | None) -> None:
    """Test hook: override the env check (None restores env behavior)."""
    global _retrace_forced
    _retrace_forced = value


class _RetraceRegistry:
    """Per-process compile and capture ledger around one declared warmup
    barrier.

    Compiles and captures before the barrier are warmup (counted, silent).
    A ``sanctioned()`` window marks deliberate post-barrier compilation and
    capture — the lifecycle's stage-time ``ensure_compiled`` — process-wide
    on purpose: the work may run on an executor thread, not the thread that
    opened the window. Everything else after the barrier raises. The torch
    half's ``allow_transfers`` windows opened while the sync guard is armed
    are counted in ``transfer_windows``."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.barrier: str | None = None  # declaring site, None = not yet
        self.warmup_compiles = 0
        self.sanction_depth = 0
        self.sanctioned_compiles = 0
        self.warmup_captures = 0
        self.sanctioned_captures = 0
        self.transfer_windows = 0
        self.violations: list[dict] = []

    def note_compile(self, tag: str, variant: str) -> None:
        self._note("compile", tag, variant)

    def note_capture(self, tag: str, variant: str) -> None:
        self._note("capture", tag, variant)

    def _note(self, what: str, tag: str, variant: str) -> None:
        if not retrace_enabled():
            return
        compile_ = what == "compile"
        stack = _site_stack()
        with self._mu:
            if self.barrier is None:
                if compile_:
                    self.warmup_compiles += 1
                else:
                    self.warmup_captures += 1
                return
            if self.sanction_depth > 0:
                if compile_:
                    self.sanctioned_compiles += 1
                else:
                    self.sanctioned_captures += 1
                return
            msg = (f"{'compile' if compile_ else 'graph capture'} after warmup "
                   f"barrier: tag={tag} variant={variant} (barrier declared at "
                   f"{self.barrier})")
            if len(self.violations) < _MAX_VIOLATIONS:
                self.violations.append(
                    {"kind": "retrace" if compile_ else "recapture", "tag": tag,
                     "variant": variant, "message": msg, "stack": stack})
        raise RetraceViolation(f"{msg} [at {stack}]")

    def note_transfer_window(self) -> None:
        with self._mu:
            self.transfer_windows += 1

    def declare_barrier(self) -> None:
        with self._mu:
            self.barrier = _site_stack()

    def sanction_enter(self) -> None:
        with self._mu:
            self.sanction_depth += 1

    def sanction_exit(self) -> None:
        with self._mu:
            self.sanction_depth = max(0, self.sanction_depth - 1)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "enabled": retrace_enabled(),
                "barrier_declared": self.barrier is not None,
                "warmup_compiles": self.warmup_compiles,
                "sanctioned_compiles": self.sanctioned_compiles,
                "warmup_captures": self.warmup_captures,
                "sanctioned_captures": self.sanctioned_captures,
                "transfer_windows": self.transfer_windows,
                "violations": list(self.violations),
            }

    def reset(self) -> None:
        with self._mu:
            self.barrier = None
            self.warmup_compiles = 0
            self.sanction_depth = 0
            self.sanctioned_compiles = 0
            self.warmup_captures = 0
            self.sanctioned_captures = 0
            self.transfer_windows = 0
            self.violations.clear()


_RETRACE = _RetraceRegistry()


def note_compile(tag: str, variant: str) -> None:
    """Runtime compile-site hook (``_compile_bucket``/``register_program``
    call this at every ``runtime_compiles_total`` tick). Raises
    RetraceViolation after the barrier outside a sanctioned window."""
    _RETRACE.note_compile(tag, variant)


def note_capture(tag: str, variant: str) -> None:
    """Runtime capture-site hook (``_capture``/``_capture_program`` call
    this before each CUDA-graph capture, a re-warm's included, which ticks
    no compile). Raises RetraceViolation after the barrier outside a
    sanctioned window, before the capture starts."""
    _RETRACE.note_capture(tag, variant)


def note_transfer_window() -> None:
    """Count one ``allow_transfers`` window opened while the sync guard is
    armed (``tpuserve_torch.utils.retrace``)."""
    _RETRACE.note_transfer_window()


def declare_warmup_complete() -> None:
    """The server finished startup compilation: from here on, any
    unsanctioned compile is a retrace violation. Recorded with the
    declaring site so the violation message can name it."""
    _RETRACE.declare_barrier()


class sanctioned_compiles:
    """Context manager blessing deliberate post-barrier compilation and
    capture (stage-time ``ensure_compiled``). Process-wide while open."""

    def __enter__(self) -> "sanctioned_compiles":
        _RETRACE.sanction_enter()
        return self

    def __exit__(self, *exc) -> None:
        _RETRACE.sanction_exit()


def retrace_snapshot() -> dict:
    """Barrier, compile and capture ledger state (the /stats
    retrace_witness block)."""
    return _RETRACE.snapshot()


def reset_retrace() -> None:
    """Drop barrier + ledger (each ServerState.build starts fresh)."""
    _RETRACE.reset()
