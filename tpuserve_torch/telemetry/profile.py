"""On-demand device profiling, ported from ``tpuserve/telemetry/profile.py``.

``POST /debug/profile?duration_ms=`` arms a ``torch.profiler`` trace (CPU
and, on a CUDA device, CUDA activity through CUPTI) for the window, then
merges its Chrome-trace events with the span ring's events of the same
window into one Chrome-trace artifact: the kernels the card ran (K1 by
name inside a served batch's ``compute`` span) beside the serving-path
spans. ``/debug/slow`` names a slow request, its span tree names the phase,
and a capture during a repro names the kernels.

Clock: the profiler's events carry microseconds relative to the trace's
``baseTimeNanoseconds`` metadata; base + ts is wall-clock time
(``time.time()``), the clock of the span ring, so every device event is put
on it. Device lanes are re-based to pids >= 1000 so they never collide with
the serving lanes.

Degradation contract (the reference's): a profiler that refuses to start or
emits nothing parseable still yields the span-ring half, with
``device_trace: "unavailable: ..."`` in the ``tpuserve_profile`` metadata,
never a 5xx. One capture at a time (``CaptureBusy`` -> 409): the profiler
is process-global state. The blocking start, stop and export run on one
executor thread of their own (the profiler is enabled and disabled from the
same thread); the window's wait is an ``asyncio.sleep``, so nothing here
stalls the serving loop. The ``profiler_port`` listener's ``POST
/profile`` runs the same capture.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
import json
import logging
import os
import shutil
import tempfile
import time

from tpuserve_torch.obs import Metrics

log = logging.getLogger("tpuserve_torch.telemetry")


class CaptureBusy(Exception):
    """A capture is already armed (-> 409): the profiler is one-at-a-time
    process-global state."""


def _read_trace(path: str) -> "list | None":
    """The exported Chrome trace's events on the wall clock: each event's
    ``ts`` plus the trace's ``baseTimeNanoseconds`` (in µs). None when
    nothing parseable came out."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    events = data.get("traceEvents")
    if not isinstance(events, list) or not events:
        return None
    base_us = float(data.get("baseTimeNanoseconds", 0)) / 1e3
    out = []
    for ev in events:
        if isinstance(ev.get("ts"), (int, float)):
            ev = dict(ev, ts=ev["ts"] + base_us)
        out.append(ev)
    return out


class ProfileCapture:
    """One process's profiling endpoint state. ``cuda`` adds CUDA activity
    (kernels, memcpys) to the CPU activity the profiler always records."""

    # Device lanes are re-based onto pids >= this so they never collide
    # with the serving lanes.
    DEVICE_PID_BASE = 1000

    def __init__(self, metrics: Metrics, cuda: bool = False) -> None:
        self.metrics = metrics
        self.cuda = cuda
        self._armed = False
        self.captures = metrics.counter("profile_captures_total")
        self.last_capture: dict | None = None
        self._prof = None
        self._executor: cf.ThreadPoolExecutor | None = None

    @property
    def armed(self) -> bool:
        return self._armed

    async def capture(self, duration_ms: float) -> dict:
        """Run one capture; returns the merged Chrome-trace dict. Raises
        CaptureBusy when one is already in flight."""
        if self._armed:
            raise CaptureBusy()
        self._armed = True
        loop = asyncio.get_running_loop()
        if self._executor is None:
            self._executor = cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tpuserve-torch-profile")
        tmpdir = tempfile.mkdtemp(prefix="tpuserve_torch_profile_")
        t0_us = time.time() * 1e6
        device_note = "ok"
        device_events: "list | None" = None
        try:
            started = await loop.run_in_executor(self._executor, self._start_trace)
            await asyncio.sleep(duration_ms / 1e3)
            if started:
                path = os.path.join(tmpdir, "trace.json")
                await loop.run_in_executor(self._executor, self._stop_trace, path)
                device_events = await loop.run_in_executor(
                    self._executor, _read_trace, path)
                if device_events is None:
                    device_note = ("unavailable: profiler emitted no "
                                   "parseable trace JSON")
            else:
                device_note = "unavailable: torch.profiler failed to start"
        finally:
            self._armed = False
            shutil.rmtree(tmpdir, ignore_errors=True)
        t1_us = time.time() * 1e6

        # The span ring's slice of the same window: the serving path's batch
        # spans beside the device lanes.
        ring = json.loads(self.metrics.tracer.chrome_trace(
            limit=None, since_us=t0_us))["traceEvents"]
        merged = list(ring)
        for ev in device_events or ():
            ev = dict(ev)
            pid = ev.get("pid")
            ev["pid"] = self.DEVICE_PID_BASE + (pid if isinstance(pid, int) else 0)
            merged.append(ev)
        self.captures.inc()
        meta = {
            "duration_ms": duration_ms,
            "device_trace": device_note,
            "ring_events": len(ring),
            "device_events": len(device_events or []),
            "captured_at": round(t0_us / 1e6, 3),
            # The capture's window on the ring's clock (epoch µs), start and
            # stop calls included.
            "window_us": [t0_us, t1_us],
        }
        self.last_capture = {k: v for k, v in meta.items() if k != "window_us"}
        return {"traceEvents": merged, "tpuserve_profile": meta}

    def _start_trace(self) -> bool:
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            return True
        except Exception:  # noqa: BLE001 — best-effort by contract
            log.exception("torch.profiler failed to start")
            self._prof = None
            return False

    def _stop_trace(self, path: str) -> None:
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            prof.export_chrome_trace(path)
        except Exception:  # noqa: BLE001
            log.exception("torch.profiler stop/export failed")

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    def stats(self) -> dict:
        return {"armed": self._armed,
                "captures_total": int(self.captures.value),
                "last_capture": self.last_capture}
