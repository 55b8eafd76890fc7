"""Structured event plane, audit trail and postmortem ledger, copied from
``tpuserve/telemetry/events.py``.

Metrics say that something happened, traces say where a request spent its
time; this module records what the process was saying. One schema, three
pieces:

- **EventLog**: a bounded ring of structured event records (``ts_us`` /
  ``level`` / ``subsystem`` / ``event`` / ``model`` / ``trace_id`` +
  ``span_id`` when the emitter is in request context / free-form
  ``fields``), fed by explicit ``emit()`` calls (publishes, rollbacks,
  request errors) and by an ``EventLogBridge`` ``logging.Handler`` over
  the ``tpuserve_torch.*`` loggers, with an optional JSONL file sink;
  queried at ``GET /debug/events``.
- **AuditLog**: every admin verb (``:reload``, ``:rollback``,
  ``/debug/profile``, drain) with its outcome, duration and fields, FIFO
  bounded, mirrored into the event ring; ``GET /debug/audit``.
- **PostmortemLog** and **BlackBoxWriter**: the crash-forensics ledger
  (``GET /debug/postmortems``) and the snapshot checkpointer. In the
  reference a supervisor folds a dead worker's stderr tail and last
  snapshot into a postmortem; the port serves one process, so its ledger
  stays empty unless a caller adds to it.

Events carry the request trace id when the emitter knows one, so
``/debug/trace?trace_id=`` interleaves them into the record (and into the
Chrome output as instant events). Every structure is locked: events come
from handlers on any accept loop, from the logging bridge on any thread
and from the sampler thread. The file reads of ``capture_blocking`` are
blocking and belong on executor threads.
"""

from __future__ import annotations

import json
import logging
import os
import signal as _signal
import threading
import time
from collections import deque

from tpuserve_torch.utils.locks import new_lock

# Event severity vocabulary — the `level` label on
# events_logged_total{level=,subsystem=} and the /debug/events?level=
# filter (junk values 400).
EVENT_LEVELS = ("debug", "info", "warning", "error")

# The logger the bridge listens on: the port's package.
LOGGER = "tpuserve_torch"

_LOGGING_TO_LEVEL = {
    logging.DEBUG: "debug",
    logging.INFO: "info",
    logging.WARNING: "warning",
    logging.ERROR: "error",
    logging.CRITICAL: "error",
}


def signal_name(exitcode: int | None) -> str | None:
    """The signal that killed a process, from its multiprocessing/waitpid
    exit code (negative = killed by that signal). None for clean exits and
    unknown codes — the postmortem then carries the raw exit code only."""
    if exitcode is None or exitcode >= 0:
        return None
    try:
        return _signal.Signals(-exitcode).name
    except ValueError:
        return None


def read_tail(path: str | None, nbytes: int) -> str | None:
    """Last ``nbytes`` of a capture file, decoded leniently. None when the
    path is unset/unreadable (a process that never wrote stderr is data,
    not an error). os-level IO: callers run this on executor threads or in
    plain processes, never on an event loop."""
    if not path or nbytes <= 0:
        return None
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        size = os.fstat(fd).st_size
        os.lseek(fd, max(0, size - nbytes), os.SEEK_SET)
        data = os.read(fd, nbytes)
    except OSError:
        return None
    finally:
        os.close(fd)
    return data.decode("utf-8", errors="replace")


def read_snapshot(path: str | None) -> dict | None:
    """Parse a black-box snapshot file; None when absent/corrupt (a
    process killed mid-write must still get a postmortem — the atomic
    tmp+rename in BlackBoxWriter makes corruption rare, not impossible)."""
    if not path:
        return None
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        chunks = []
        while True:
            b = os.read(fd, 65536)
            if not b:
                break
            chunks.append(b)
    except OSError:
        return None
    finally:
        os.close(fd)
    try:
        out = json.loads(b"".join(chunks))
    except ValueError:
        return None
    return out if isinstance(out, dict) else None


class EventLog:
    """Bounded per-process ring of structured event records.

    Records keep the NEWEST ``capacity`` events (deque maxlen). ``pid`` is
    the process lane, same vocabulary as span pids (0 for the
    single-process server). Emissions
    tick ``events_logged_total{level=,subsystem=}`` (counters prebound
    lazily per pair — the label space is small and stable)."""

    def __init__(self, metrics, capacity: int = 4096, pid: int = 0,
                 jsonl_path: str = "") -> None:
        self.metrics = metrics
        self.capacity = max(1, int(capacity))
        self.pid = pid
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._counters: dict[tuple[str, str], object] = {}
        self._lock = new_lock("events.EventLog")
        self._sink_fd: int | None = None
        self._sink_failed = False
        if jsonl_path:
            try:
                os.makedirs(os.path.dirname(jsonl_path) or ".",
                            exist_ok=True)
                self._sink_fd = os.open(
                    jsonl_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                    0o644)
            except OSError:
                self._sink_failed = True

    def emit(self, level: str, subsystem: str, event: str, *,
             model: str | None = None, trace_id: str | None = None,
             span_id: str | None = None, msg: str | None = None,
             **fields) -> dict:
        """Record one structured event; returns the record. Safe from any
        thread or event loop; never raises (the event plane must not take
        the serving path down)."""
        if level not in EVENT_LEVELS:
            level = "info"
        rec: dict = {
            "ts_us": time.time() * 1e6,
            "level": level,
            "subsystem": subsystem,
            "event": event,
            "pid": self.pid,
        }
        if model is not None:
            rec["model"] = model
        if trace_id is not None:
            rec["trace_id"] = trace_id
        if span_id is not None:
            rec["span_id"] = span_id
        if msg is not None:
            rec["msg"] = msg
        if fields:
            rec["fields"] = fields
        with self._lock:
            self._ring.append(rec)
            c = self._counters.get((level, subsystem))
            if c is None:
                c = self._counters[(level, subsystem)] = self.metrics.counter(
                    f"events_logged_total{{level={level},"
                    f"subsystem={subsystem}}}")
            if self._sink_fd is not None and not self._sink_failed:
                try:
                    os.write(self._sink_fd,
                             (json.dumps(rec, ensure_ascii=False,
                                         default=str) + "\n").encode())
                except OSError:
                    # One-shot disable, no logging: a dead sink must not
                    # recurse through the bridge back into emit().
                    self._sink_failed = True
        c.inc()
        return rec

    def query(self, since_us: float | None = None, level: str | None = None,
              subsystem: str | None = None, trace_id: str | None = None,
              limit: int = 1000) -> list[dict]:
        """Filtered view of the ring, oldest-first, capped to the NEWEST
        ``limit`` matching records (a post-incident pull sees the most
        recent window — same contract as the span ring)."""
        with self._lock:
            events = list(self._ring)
        out = [e for e in events
               if (since_us is None or e["ts_us"] >= since_us)
               and (level is None or e["level"] == level)
               and (subsystem is None or e["subsystem"] == subsystem)
               and (trace_id is None or e.get("trace_id") == trace_id)]
        if limit >= 0:
            # NOT out[-limit:]: -0 slices the WHOLE list (the /debug/trace
            # lesson, pinned again in tests/test_events.py).
            out = out[len(out) - limit:] if limit else []
        return out

    def tail(self, n: int) -> list[dict]:
        """The newest ``n`` records, oldest-first (black-box snapshots)."""
        with self._lock:
            events = list(self._ring)
        return events[max(0, len(events) - n):]

    def stats(self) -> dict:
        with self._lock:
            size = len(self._ring)
            logged = {f"{lv}/{sub}": c.value
                      for (lv, sub), c in self._counters.items()}
        return {"capacity": self.capacity, "size": size,
                "logged_total": logged,
                "jsonl_sink": ("failed" if self._sink_failed
                               else "on" if self._sink_fd is not None
                               else "off")}

    def close(self) -> None:
        with self._lock:
            if self._sink_fd is not None:
                try:
                    os.close(self._sink_fd)
                except OSError:
                    pass
                self._sink_fd = None


class EventLogBridge(logging.Handler):
    """stdlib-logging -> event-ring bridge: a handler on the
    ``tpuserve_torch`` logger, so every ``logging.getLogger(
    "tpuserve_torch.*")`` call site flows into the ring. Subsystem = the
    logger-name suffix after ``tpuserve_torch.`` (the bare package logger
    maps to ``server``). Never raises — a logging handler that throws turns every
    log line into an incident."""

    def __init__(self, event_log: EventLog) -> None:
        super().__init__()
        self.event_log = event_log

    def emit(self, record: logging.LogRecord) -> None:  # noqa: A003
        try:
            name = record.name
            subsystem = (name.split(".", 1)[1] if "." in name
                         else "server")
            level = _LOGGING_TO_LEVEL.get(record.levelno)
            if level is None:
                level = "error" if record.levelno >= logging.ERROR else \
                    "warning" if record.levelno >= logging.WARNING else \
                    "info" if record.levelno >= logging.INFO else "debug"
            self.event_log.emit(level, subsystem, "log",
                                msg=record.getMessage())
        except Exception:  # noqa: BLE001 — see docstring
            pass


_BRIDGE: EventLogBridge | None = None
_ACTIVE: EventLog | None = None


def install_bridge(event_log: EventLog, level: str = "INFO") -> EventLogBridge:
    """Install (or replace) the process's logging bridge on the
    ``tpuserve_torch`` logger. One bridge per process: a test constructing
    a second ServerState swaps the bridge rather than double-recording."""
    global _BRIDGE
    root = logging.getLogger(LOGGER)
    if _BRIDGE is not None:
        root.removeHandler(_BRIDGE)
    _BRIDGE = EventLogBridge(event_log)
    lvl = getattr(logging, level.upper(), logging.INFO)
    _BRIDGE.setLevel(lvl)
    # A record is gated by its LOGGER's effective level before any handler
    # sees it; with an unconfigured root (WARNING) the bridge would
    # silently miss every INFO line. The server always configures INFO
    # logging, so lowering the tpuserve_torch subtree to the bridge level
    # changes nothing when served and makes the bridge honest elsewhere.
    if root.getEffectiveLevel() > lvl:
        root.setLevel(lvl)
    root.addHandler(_BRIDGE)
    return _BRIDGE


def set_active(event_log: EventLog | None) -> None:
    """Register the process's event log for module-level ``emit()`` — the
    light-weight entry used by layers (the lifecycle) that predate
    the event plane and should not grow a constructor parameter for it."""
    global _ACTIVE
    _ACTIVE = event_log


def emit(level: str, subsystem: str, event: str, **kw) -> None:
    """Emit onto the process's active event log; silent no-op before
    ``set_active`` (unit tests driving a bare lifecycle emit nowhere)."""
    log = _ACTIVE
    if log is not None:
        log.emit(level, subsystem, event, **kw)


def reject_unknown_query(query, known) -> None:
    """The shared half of introspection-endpoint query hardening (the
    /debug/trace discipline: junk is a 400, never a 500 or a silent
    default): a read-only debug view runs its params through this one
    check, so a typo'd filter fails identically everywhere. Raises ValueError
    with a client-facing message."""
    unknown = set(query) - set(known)
    if unknown:
        raise ValueError(f"unknown query param(s): {sorted(unknown)} "
                         f"(known: {sorted(known)})")


def query_limit(query, default: int = 1000) -> int:
    """Parse the conventional ``limit`` param (int, >= 0)."""
    try:
        limit = int(query.get("limit", str(default)))
    except (TypeError, ValueError):
        raise ValueError("limit must be an integer") from None
    if limit < 0:
        raise ValueError(f"limit must be >= 0, got {limit}")
    return limit


def parse_events_query(query) -> dict:
    """Validate /debug/events query params. Raises ValueError with a
    client-facing message."""
    out: dict = {}
    reject_unknown_query(
        query, {"since_us", "level", "subsystem", "trace_id", "limit"})
    if "since_us" in query:
        try:
            out["since_us"] = float(query["since_us"])
        except (TypeError, ValueError):
            raise ValueError("since_us must be a number (epoch "
                             "microseconds)") from None
    level = query.get("level")
    if level is not None:
        if level not in EVENT_LEVELS:
            raise ValueError(f"level must be one of {list(EVENT_LEVELS)}, "
                             f"got {level!r}")
        out["level"] = level
    if query.get("subsystem"):
        out["subsystem"] = query["subsystem"]
    if query.get("trace_id"):
        out["trace_id"] = query["trace_id"]
    out["limit"] = query_limit(query)
    return out


class AuditLog:
    """Bounded FIFO of admin-action records: who-did-what for every verb
    that mutates serving state (`:reload`, `:rollback`, `:warm`,
    `/debug/profile`, drain). Each record lands in the event ring too
    (subsystem ``audit``) so the flight data interleaves, and ticks
    ``audit_events_total{verb=,outcome=}``."""

    def __init__(self, metrics, capacity: int = 256,
                 events: EventLog | None = None) -> None:
        self.metrics = metrics
        self.capacity = max(1, int(capacity))
        self.events = events
        self._records: deque[dict] = deque(maxlen=self.capacity)
        self._counters: dict[tuple[str, str], object] = {}
        self._lock = new_lock("events.AuditLog")

    def record(self, verb: str, target: str, outcome: str,
               duration_ms: float | None = None, **fields) -> dict:
        rec: dict = {
            "ts": round(time.time(), 3),
            "verb": verb,
            "target": target,
            "outcome": outcome,
        }
        if duration_ms is not None:
            rec["duration_ms"] = round(duration_ms, 3)
        rec.update(fields)
        with self._lock:
            self._records.append(rec)
            c = self._counters.get((verb, outcome))
            if c is None:
                c = self._counters[(verb, outcome)] = self.metrics.counter(
                    f"audit_events_total{{verb={verb},outcome={outcome}}}")
        c.inc()
        if self.events is not None:
            self.events.emit(
                "info" if outcome == "ok" else "warning", "audit", verb,
                model=None if target == "server" else target,
                outcome=outcome, **({"duration_ms": rec["duration_ms"]}
                                    if duration_ms is not None else {}))
        return rec

    def dump(self) -> list[dict]:
        """Newest-first records (the /debug/audit body)."""
        with self._lock:
            return list(reversed(self._records))

    def stats(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "size": len(self._records)}


class PostmortemLog:
    """Bounded FIFO of process-death forensics records.

    ``add()`` is pure bookkeeping (safe on the event loop); ``capture_blocking()``
    additionally reads the dead slot's stderr capture + snapshot files and
    belongs on an executor thread. Every record ticks
    ``postmortems_total{component=,signal=}`` (signal = the killing signal
    name, or ``none`` for clean/unknown exits)."""

    def __init__(self, metrics, capacity: int = 64,
                 tail_bytes: int = 4096,
                 events: EventLog | None = None) -> None:
        self.metrics = metrics
        self.capacity = max(1, int(capacity))
        self.tail_bytes = max(0, int(tail_bytes))
        self.events = events
        self._records: deque[dict] = deque(maxlen=self.capacity)
        self._counters: dict[tuple[str, str], object] = {}
        self._lock = new_lock("events.PostmortemLog")

    def add(self, component: str, ident: str, pid: int | None,
            exitcode: int | None, stderr_tail: str | None = None,
            snapshot: dict | None = None, **fields) -> dict:
        sig = signal_name(exitcode)
        rec: dict = {
            "ts": round(time.time(), 3),
            "component": component,
            "id": ident,
            "pid": pid,
            "exitcode": exitcode,
            "signal": sig,
            "stderr_tail": stderr_tail,
            "snapshot": snapshot,
        }
        rec.update(fields)
        with self._lock:
            self._records.append(rec)
            key = (component, sig or "none")
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = self.metrics.counter(
                    f"postmortems_total{{component={component},"
                    f"signal={sig or 'none'}}}")
        c.inc()
        if self.events is not None:
            self.events.emit("error", "supervision", "postmortem",
                             component=component, id=ident, pid=pid,
                             exitcode=exitcode, signal=sig)
        return rec

    def capture_blocking(self, component: str, ident: str, pid: int | None,
                         exitcode: int | None, stderr_path: str | None = None,
                         snapshot_path: str | None = None, **fields) -> dict:
        """Read the dead slot's black-box files and fold a record.
        Blocking file IO — executor threads only (callers schedule it
        off the loop at reap time)."""
        return self.add(
            component, ident, pid, exitcode,
            stderr_tail=read_tail(stderr_path, self.tail_bytes),
            snapshot=read_snapshot(snapshot_path), **fields)

    def dump(self) -> list[dict]:
        """Newest-first records (the /debug/postmortems body)."""
        with self._lock:
            return list(reversed(self._records))

    def stats(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "size": len(self._records)}


class BlackBoxWriter(threading.Thread):
    """The per-process postmortem checkpointer: every ``interval_s`` (and
    once immediately at start, so even a freshly booted process leaves
    evidence) writes ``collect()`` to the slot's snapshot file atomically
    (tmp + rename — a SIGKILL mid-write leaves the previous snapshot, not
    a torn one). Daemon + event-signalled stop, the MetricSampler
    discipline: drains join it cleanly, a wedged write can't hang exit."""

    def __init__(self, path: str, interval_s: float, collect) -> None:
        super().__init__(name="tpuserve-torch-blackbox", daemon=True)
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self.collect = collect
        self._stop_ev = threading.Event()
        self.writes = 0

    def run(self) -> None:
        self.write_once()
        while not self._stop_ev.wait(self.interval_s):
            self.write_once()

    def write_once(self) -> None:
        """One snapshot (callable directly from tests). Never raises."""
        try:
            data = json.dumps(self.collect(), ensure_ascii=False,
                              default=str).encode()
        except Exception:  # noqa: BLE001 — a bad collect skips one tick
            return
        tmp = f"{self.path}.tmp"
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
            os.replace(tmp, self.path)
            self.writes += 1
        except OSError:
            pass

    def stop(self, timeout: float = 5.0) -> None:
        """Signal and join (idempotent; called from drain AND stop)."""
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout)


def events_to_chrome(events: list[dict]) -> list[dict]:
    """Render event records as Chrome instant events (``ph: "i"``) for
    interleaving with span trees — ``obs.spans_to_chrome`` merges them so
    the trace shows what the process was saying while the spans ran."""
    out = []
    for e in events:
        args = dict(e.get("fields") or {})
        for k in ("level", "model", "trace_id", "msg"):
            if e.get(k) is not None:
                args[k] = e[k]
        out.append({
            "name": f"{e.get('subsystem', '?')}:{e.get('event', '?')}",
            "ph": "i",
            "ts": float(e.get("ts_us", 0.0)),
            "pid": int(e.get("pid", 0)),
            "tid": e.get("subsystem", "events"),
            "s": "p",  # process-scoped instant marker
            "args": args,
        })
    return out
