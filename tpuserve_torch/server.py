"""HTTP serving layer of the port, ported from ``tpuserve/server.py``.

The JAX server is built on aiohttp; the port's front door is written on
``asyncio.start_server`` from the standard library (HTTP/1.1,
``Content-Length`` bodies, keep-alive), so it serves on a machine that has
torch and nothing else. One event loop (the main loop) owns the batchers,
caches and breakers; handlers read the body, decode it on the thread pool
(``model.host_decode_items``; on the accept loop with ``decode_inline``),
submit to the batcher (through the result cache when ``[cache]`` is on),
await the per-item futures and JSON-encode the result. All device work
happens behind the batcher.

Endpoints (response shapes and status codes as in the JAX server):

- ``POST /v1/models/{name}:predict`` (aliases ``:classify``, ``:detect``,
  ``:generate``): ``{"text": ...}`` answers ``{"top_k": [...]}``,
  ``{"texts": [...]}`` answers ``{"results": [...]}`` in request order; for
  an image model an ``application/x-tpuserve-frame`` body or an npy
  (N, H, W, 3) batch answers ``{"results": [...]}``, an npy (H, W, 3) image
  or an encoded image ``{"top_k": [...]}``; for textgen ``{"prompt",
  "seed"?, "max_new_tokens"?, "temperature"?}`` answers ``{"text",
  "tokens", "n_tokens"}``; for sd15 ``{"prompt", "negative_prompt"?,
  "seed"?}`` answers the PNG (``image/png``). With ``[genserve] enabled =
  true`` a generative
  model is served by the iteration-level engine
  (``tpuserve_torch.genserve.GenEngine``) in place of the batcher, with the
  same front-door surface (deadlines, breaker, cache, canaries, watchdog,
  drain); its paged-KV admission shed answers 503 with ``"reason":
  "kv_pressure"`` and a Retry-After, a mid-generation deadline 504.
  ``?stream=true`` on an engine-served model answers one request as a
  chunked ``text/event-stream`` (``X-Tpuserve-Stream: 1``): a ``token``
  event per generated token, heartbeats (``: hb``) across idle gaps, and
  exactly one terminal event, ``done`` (finish reason, usage) or ``error``
  (its reason); sd15 streams binary frames instead
  (``frame.CONTENT_TYPE``: progress events, previews, the image). Before the first unit failures are plain statuses (504,
  503, 429, 500) with no byte of stream written; after it they are
  in-stream ``error`` events. A stream bypasses the result cache and
  single-flight; a client that goes away frees its slot.
- ``GET /healthz`` (``ok``, ``degraded`` or, once a drain began,
  ``draining`` with 503), ``GET /metrics`` (Prometheus text), ``GET
  /stats`` (latency summary, backend — card, torch and CUDA versions,
  device —, the ``robustness`` block — draining, each model's breaker, the
  armed faults —, the ``cache`` block when ``[cache]`` is on, the ingest
  block — requests and bytes per accept loop, frame errors and
  native-decode fallbacks per model —, the host pipeline, the
  ``genserve`` block of each engine-served model — slots, fold-ins, early
  exits, evictions, step EWMA, the KV page pool —, the kernels'
  launch counts and the ``roofline`` block — per model the resident
  variants, ``compiles_total``, the startup probes' raw forward ms per
  bucket (``roofline_probe_iters``), ``utilization`` and the compute phase
  split into device time and host wait —), ``GET /v1/models`` (buckets,
  variants, dtype, quantize, device), ``GET /`` (the reference's HTML
  index page, byte for byte).
- ``POST /debug/kernels:reset`` sets the kernels' launch counts to 0, so a
  caller can count exactly the launches of the requests it sends next.
- Observability (the reference's defaults, on unless their table switches
  them off): ``GET /debug/trace`` (the span ring as Chrome JSON, ``?limit=``
  default 5000, ``?since_us=``; ``?trace_id=`` one recorded request's span
  tree with its events interleaved, ``&format=record`` the raw record),
  ``GET /debug/slow`` (the flight recorder: slowest-N trees per model and
  the errored ones, ``?model=``), ``GET /debug/events`` (the event ring,
  ``?since_us=&level=&subsystem=&trace_id=&limit=``), ``GET /debug/audit``,
  ``GET /debug/postmortems``, ``GET /stats/history?metric=&window_s=``,
  ``GET /alerts`` and ``POST /debug/profile?duration_ms=`` (a
  ``torch.profiler`` device trace merged with the span ring; 409 while one
  is armed). ``/metrics`` answers the OpenMetrics content type when the
  ``Accept`` header asks for it.
- ``POST /admin/models/{name}:reload`` (staged, canary-gated weight swap
  from the model's ``weights``: 200 with the new version; 409 with the
  failing gate's ``stage`` and the version still serving; 500 with
  ``rolled_back: true`` when the post-publish canary failed and the
  lifecycle reverted), ``POST /admin/models/{name}:rollback`` (200, or 409
  when no previous version is retained) and ``GET
  /admin/models/{name}/versions`` (live and previous version, soak state,
  history), backed by ``tpuserve_torch.lifecycle``. With
  ``canary_interval_s`` > 0 every model's canary re-runs on that interval,
  feeding ``/healthz``, the soak monitor and the breaker's recovery.

Robustness: a per-model circuit breaker trips after ``breaker_threshold``
consecutive failed dispatches; while it is open, predict answers 503 +
``Retry-After`` (the time to the next periodic canary, the probe that
half-opens and closes it) before the body is decoded. A watchdog revives
dead group loops every ``watchdog_interval_s``. On SIGTERM the server
drains: the watchdog and the canary stop, new requests get 503 +
``Retry-After`` and ``/healthz`` turns ``draining``, every accepted request
gets up to ``drain_timeout_s`` to finish, then the server stops and the
process exits 0. With ``ingest_loops`` = N > 1, N-1 more accept loops, each
on its own thread with an SO_REUSEPORT listener on the serving port, read,
parse and decode requests and hop onto the main loop once per request.

Errors: decode failure 400 (a malformed frame answers its ``frame: ...``
message and ticks ``frame_errors_total{model=}`` beside
``bad_requests_total{model=}``), unknown model or path 404, wrong method 405,
body too large 413, queue full 429 (+ ``Retry-After`` from the queue's
clear time), draining or breaker open 503 (+ ``Retry-After``), deadline
exceeded 504, batch failure 500. Error bodies are ``{"error": ...,
"trace_id": ...}``; every predict response carries ``X-Trace-Id``: the
request's well-formed ``X-Trace-Id`` when it sent one, else a fresh id. The
request's span tree (``request`` at the root; ``body_read``, ``parse``,
``dispatch``, then the batcher's ``queue``, ``preproc``, ``h2d``,
``compute`` and ``postproc``) goes to the flight recorder, and an errored
or retained-slow request leaves a ``request_error`` / ``slow_request``
event with its trace id. Admin verbs (``:reload``, ``:rollback``, profile,
drain) leave audit records.

Behind the router (``tpuserve_torch.workerproc``) this server is a worker:
it adopts the router's ``X-Trace-Id`` / ``X-Parent-Span`` (its spans and
events on lane worker id + 1), re-stamps the forwarded ``X-Timeout-Ms`` on
its own clock, checkpoints a black-box snapshot to ``[events]
snapshot_path`` and hosts the ``worker_slow`` / ``worker_hang`` /
``worker_crash`` fault call sites, which fire before a predict reads its
body. ``log_json`` logs one JSON object per line (``configure_logging``);
``debug_nans``, ``prewarm_executables`` and ``compilation_cache_dir`` are
the runtime's (``tpuserve_torch.runtime``). ``serve`` with ``[router]
enabled`` runs the router in this process instead.

Not ported yet (ROADMAP.md queue 1): host failure domains, peer routers,
the fleet scheduler (``:warm``/``:demote``), tenants (``/tenants``), the
autopilot and deferred mode (item 11b), ``/metrics/fleet`` and
``profiler_port`` (item 12).
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
import contextlib
import functools
import gc
import json
import logging
import math
import os
import signal
import socket
import threading
import time
from dataclasses import dataclass, field
from http import HTTPStatus
from urllib.parse import parse_qsl, unquote

import torch

from tpuserve_torch import models as modelzoo
from tpuserve_torch import preproc
from tpuserve_torch.batcher import (DeadlineExceeded, ModelBatcher, QueueFull,
                                    clamp_retry_after_s)
from tpuserve_torch.bench.roofline import compute_split, phase_p50
from tpuserve_torch.cache import ModelCache
from tpuserve_torch.config import ServerConfig, SloConfig, unported_settings
from tpuserve_torch.faults import CircuitBreaker, FaultInjector, Watchdog
from tpuserve_torch.frame import FrameError
from tpuserve_torch.genserve import GenEngine, KVPressure
from tpuserve_torch.hostpipe import StageExecutors
from tpuserve_torch.lifecycle import ModelLifecycle, ReloadRejected
from tpuserve_torch.obs import (FlightRecorder, Metrics, TraceContext,
                                exposition_content_type, spans_to_chrome)
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.runtime import (ModelRuntime, backend_info, build_runtime,
                                    configure_runtime, resolve_device)
from tpuserve_torch.telemetry import events as events_mod
from tpuserve_torch.telemetry.events import (AuditLog, BlackBoxWriter, EventLog,
                                             PostmortemLog)
from tpuserve_torch.telemetry.profile import CaptureBusy, ProfileCapture
from tpuserve_torch.telemetry.slo import SloEngine, UtilizationDeriver
from tpuserve_torch.telemetry.store import MetricSampler, TimeSeriesStore

log = logging.getLogger("tpuserve_torch.server")

_VERBS = ("predict", "classify", "detect", "generate")
_MAX_BODY = 64 * 1024 * 1024  # the JAX server's client_max_size
_MAX_HEAD = 64 * 1024
# How long an injected stream_stall wedges a started stream's writer, and an
# injected worker_hang a request: long enough that the request never answers
# within any sane deadline (the router's hedging and 504 own it), short
# enough that a forgotten armed rule cannot pin a connection forever.
_STREAM_STALL_S = _WORKER_HANG_S = 3600.0

# The JAX server's index page, byte for byte.
_INDEX_HTML = """<!doctype html><title>tpuserve</title>
<h1>tpuserve</h1>
<p>POST an image to <code>/v1/models/&lt;name&gt;:classify</code>.
See <a href="/v1/models">models</a>, <a href="/metrics">metrics</a>,
<a href="/stats">stats</a>, <a href="/healthz">health</a>.</p>
<form method=post enctype=multipart/form-data onsubmit="
  event.preventDefault();
  const f=document.getElementById('f').files[0];
  const m=document.getElementById('m').value;
  fetch('/v1/models/'+m+':predict',{method:'POST',body:f,
    headers:{'Content-Type':f.type}})
   .then(r=>r.json()).then(j=>document.getElementById('out').textContent=
     JSON.stringify(j,null,2));
">
<input type=text id=m value=resnet50> <input type=file id=f>
<button>predict</button></form><pre id=out></pre>
"""


@dataclass
class Request:
    """One request off the wire: the head is parsed at once, the body is
    read on demand (``read``), so a shed can answer before it."""

    method: str
    path: str
    query: dict
    headers: dict  # lower-cased names
    length: int = 0
    reader: asyncio.StreamReader | None = field(default=None, repr=False)
    # The connection's writer: a streamed response writes through it.
    writer: asyncio.StreamWriter | None = field(default=None, repr=False)
    body: bytes | None = None
    read_s: float = 0.0  # time spent reading the body off the socket

    @property
    def content_type(self) -> str:
        """The media type without parameters (aiohttp's default when the
        header is absent, so decode sees what the JAX server sees)."""
        raw = self.headers.get("content-type", "")
        return raw.split(";", 1)[0].strip().lower() or "application/octet-stream"

    async def read(self) -> bytes:
        """The body (read off the socket at the first call)."""
        if self.body is None:
            t0 = time.perf_counter()
            self.body = (await self.reader.readexactly(self.length)
                         if self.length else b"")
            self.read_s = time.perf_counter() - t0
        return self.body


@dataclass
class Response:
    status: int
    body: bytes
    content_type: str = "application/json"
    headers: dict = field(default_factory=dict)

    def encode(self, keep_alive: bool) -> bytes:
        reason = HTTPStatus(self.status).phrase
        lines = [f"HTTP/1.1 {self.status} {reason}",
                 f"Content-Type: {self.content_type}",
                 f"Content-Length: {len(self.body)}",
                 f"Connection: {'keep-alive' if keep_alive else 'close'}"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + self.body


class StreamResponse:
    """A response the handler writes itself as it goes (HTTP/1.1 chunked
    transfer coding), on the connection's own loop: ``prepare`` writes the
    head, ``write`` one chunk, ``write_eof`` the terminating chunk. A client
    that went away is seen at a write — its end of the connection closed,
    or the transport reset — as ConnectionResetError. After ``write_eof``
    (``complete``) the connection serves its next request; a torn stream
    closes it. ``stream_score_ms`` is what the flight recorder ranks the
    request by (set by the stream handler)."""

    def __init__(self, req: Request, content_type: str, headers: dict) -> None:
        self.status = 200
        self.content_type = content_type
        self.headers = headers
        self.keep_alive = _keep_alive(req)
        self.complete = False
        self.stream_score_ms: float | None = None
        self._reader = req.reader
        self._writer = req.writer

    async def prepare(self) -> None:
        lines = ["HTTP/1.1 200 OK", f"Content-Type: {self.content_type}",
                 "Transfer-Encoding: chunked",
                 f"Connection: {'keep-alive' if self.keep_alive else 'close'}"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        await self._send(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    async def write(self, data: bytes) -> None:
        if data:
            await self._send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        await self._send(b"0\r\n\r\n")
        self.complete = True

    def abort(self) -> None:
        """Tear the connection down mid-stream: no terminating chunk."""
        self._writer.transport.close()

    async def _send(self, data: bytes) -> None:
        if self._reader.at_eof() or self._writer.is_closing():
            raise ConnectionResetError("the client closed the connection")
        self._writer.write(data)
        await self._writer.drain()


def json_response(obj, status: int = 200, headers: dict | None = None) -> Response:
    return Response(status, json.dumps(obj).encode("utf-8"), headers=headers or {})


def _text(status: int) -> Response:
    """aiohttp's plain-text answer for an unrouted path or method."""
    return Response(status, f"{status}: {HTTPStatus(status).phrase}".encode(),
                    content_type="text/plain; charset=utf-8")


def _err(status: int, message: str, retry_after: int | None = None,
         trace_id: str | None = None, reason: str | None = None) -> Response:
    headers: dict[str, str] = {}
    if retry_after:
        headers["Retry-After"] = str(retry_after)
    body = {"error": message}
    if reason is not None:
        # Machine-readable shed reason ("kv_pressure").
        body["reason"] = reason
    if trace_id is not None:
        body["trace_id"] = trace_id
        headers["X-Trace-Id"] = trace_id
    return json_response(body, status=status, headers=headers)


class ModelHandles:
    """Per-model prebound metrics and config for the predict handler."""

    __slots__ = ("mcfg", "requests", "bad_requests", "timeouts", "total_hist",
                 "body_read_hist", "parse_hist", "frame_errors", "native_fallback")

    def __init__(self, name: str, mcfg, metrics: Metrics) -> None:
        self.mcfg = mcfg
        self.requests = metrics.counter(f"requests_total{{model={name}}}")
        self.bad_requests = metrics.counter(f"bad_requests_total{{model={name}}}")
        self.timeouts = metrics.counter(f"timeouts_total{{model={name}}}")
        self.total_hist = metrics.histogram(f"latency_ms{{model={name},phase=total}}")
        self.body_read_hist = metrics.histogram(
            f"latency_ms{{model={name},phase=body_read}}")
        self.parse_hist = metrics.histogram(f"latency_ms{{model={name},phase=parse}}")
        # Malformed frame bodies (each also counts in bad_requests_total).
        self.frame_errors = metrics.counter(f"frame_errors_total{{model={name}}}")
        # yuv420 decodes that the PIL path served although the native shim
        # was tried (shim missing or failed, or not an exact-size 4:2:0 JPEG).
        self.native_fallback = metrics.counter(
            f"native_decode_fallback_total{{model={name}}}")


class IngestHandles:
    """One accept loop's prebound ingest counters
    (``ingest_requests_total{loop=}``, ``ingest_bytes_total{loop=}``)."""

    __slots__ = ("index", "requests", "bytes")

    def __init__(self, index: int, metrics: Metrics) -> None:
        self.index = index
        self.requests = metrics.ingest_requests_counter(index)
        self.bytes = metrics.ingest_bytes_counter(index)


class Connections:
    """The open client connections of one accept loop and its requests in
    progress (a read request not yet answered), so a stop can wait for the
    answers of accepted work before closing the sockets. Loop-local."""

    def __init__(self) -> None:
        self.writers: set[asyncio.StreamWriter] = set()
        self.busy = 0
        self._idle = asyncio.Event()
        self._idle.set()

    def begin(self) -> None:
        self.busy += 1
        self._idle.clear()

    def end(self) -> None:
        self.busy -= 1
        if self.busy == 0:
            self._idle.set()

    async def close(self, timeout_s: float) -> None:
        """Wait (bounded) for the requests in progress to be answered, then
        close every connection."""
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(self._idle.wait(), max(0.0, timeout_s))
        for writer in list(self.writers):
            writer.close()


def _reject_unported(cfg: ServerConfig) -> None:
    """Refuse settings the port does not serve yet, instead of silently
    ignoring them."""
    unported = unported_settings(cfg)
    if unported:
        raise NotImplementedError(
            "not yet ported to tpuserve_torch (see ROADMAP.md queue 1): "
            + ", ".join(unported))


class NotServing(RuntimeError):
    """The batcher refused the submit (stopped, racing shutdown) -> 503."""


class ServerState:
    """Everything a running server owns. ``device`` defaults to the current
    CUDA device; pass ``"cpu"`` to serve on the CPU."""

    def __init__(self, cfg: ServerConfig,
                 device: "str | torch.device | None" = None) -> None:
        _reject_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        configure_runtime(cfg)
        # The worker id behind the router (tpuserve_torch.workerproc), None
        # when serving alone: spans and events of this process then carry
        # the lane worker id + 1, the router's being 0.
        self.worker_id: int | None = None
        self.metrics = Metrics(cfg.trace_capacity, exemplars=cfg.trace.exemplars)
        # Tail-latency flight recorder: complete span trees of the slowest-N
        # requests per model and of every errored or shed one
        # (/debug/slow, /debug/trace?trace_id=). Thread-safe: every accept
        # loop finishes its own requests into it.
        self.recorder = FlightRecorder(
            slow_n=cfg.trace.slow_n, error_capacity=cfg.trace.error_capacity,
            always_record_errors=cfg.trace.always_record_errors,
            metrics=self.metrics)
        self.pool = cf.ThreadPoolExecutor(max_workers=cfg.decode_threads,
                                          thread_name_prefix="tpuserve-torch")
        self.stages = StageExecutors(cfg.pipeline, self.metrics)
        self.models: dict[str, object] = {}
        self.runtimes: dict[str, ModelRuntime] = {}
        # Per-model dispatch: ModelBatcher (locked batches) or GenEngine
        # (iteration-level generation); both expose the same surface.
        self.batchers: "dict[str, ModelBatcher | GenEngine]" = {}
        # The GenEngine subset of batchers (the /stats genserve block; the
        # lifecycle's staged canary).
        self.engines: dict[str, GenEngine] = {}
        self.breakers: dict[str, CircuitBreaker] = {}
        # Per-model result cache + single-flight; empty unless [cache] is on.
        self.caches: dict[str, ModelCache] = {}
        self.handles: dict[str, ModelHandles] = {}
        # Per-accept-loop ingest counters by loop index (0 = the main loop).
        self.ingest: dict[int, IngestHandles] = {}
        self.lifecycles: dict[str, ModelLifecycle] = {}
        self.injector = (FaultInjector(cfg.faults, self.metrics)
                         if cfg.faults.enabled else None)
        self.watchdog = Watchdog(cfg.watchdog_interval_s, self.metrics)
        self.canary_ok: dict[str, bool] = {}
        self._canary_task: asyncio.Task | None = None
        # Next periodic-canary fire time (time.monotonic clock): the basis of
        # the breaker 503s' Retry-After (the canary is the recovery probe).
        self._next_canary_at: float | None = None
        # The loop that owns the batchers, caches and breakers (set in
        # start); handlers on an ingest loop hop onto it.
        self.main_loop: asyncio.AbstractEventLoop | None = None
        # Graceful drain: True once shutdown began — new requests shed with
        # 503 + Retry-After while accepted ones finish.
        self.draining = False
        self.serving_addresses: list = []
        # The main loop's client connections (keep-alive ones idle between
        # requests), closed at shutdown so the listener's wait_closed() can
        # return.
        self.connections: Connections | None = None
        # Telemetry plane: metric history, SLO burn rates, device
        # utilization and profiling; all None with [telemetry] enabled =
        # false.
        self.store: TimeSeriesStore | None = None
        self.sampler: MetricSampler | None = None
        self.slo: SloEngine | None = None
        self.util: UtilizationDeriver | None = None
        self.profiler: ProfileCapture | None = None
        if cfg.telemetry.enabled:
            tcfg = cfg.telemetry
            self.store = TimeSeriesStore(
                self.metrics, capacity=int(tcfg.history_s / tcfg.sample_interval_s))
            self.slo = SloEngine(self.metrics, self.store, tcfg.burn_windows_s)
            self.util = UtilizationDeriver(self.metrics, self.store,
                                           tcfg.utilization_window_s)
            self.sampler = MetricSampler(self.store, tcfg.sample_interval_s,
                                         hooks=[self.slo.tick, self.util.tick])
            self.profiler = ProfileCapture(self.metrics, cuda=self.device.type == "cuda")
        # Event plane: the event ring with its logging bridge, the admin
        # audit trail and the postmortem ledger; all None with [events]
        # enabled = false.
        self.events: EventLog | None = None
        self.audit: AuditLog | None = None
        self.postmortems: PostmortemLog | None = None
        if cfg.events.enabled:
            ecfg = cfg.events
            self.events = EventLog(self.metrics, ecfg.capacity, jsonl_path=ecfg.jsonl_path)
            self.audit = AuditLog(self.metrics, ecfg.audit_capacity, events=self.events)
            self.postmortems = PostmortemLog(
                self.metrics, ecfg.postmortem_capacity,
                tail_bytes=ecfg.stderr_tail_bytes, events=self.events)
            events_mod.install_bridge(self.events, ecfg.bridge_level)
            events_mod.set_active(self.events)
        # The worker tier's black box: a postmortem snapshot checkpointed to
        # [events] snapshot_path (set per worker slot by the supervisor).
        self.blackbox: BlackBoxWriter | None = None

    def build(self) -> None:
        """Build every model's runtime: params on the device, buckets warm —
        or, for a generative model with ``[genserve]`` on, the generation
        engine's programs in place of the buckets."""
        for mcfg in self.cfg.models:
            t0 = time.perf_counter()
            model = modelzoo.build(mcfg)
            if self.cfg.genserve.enabled and getattr(model, "generative", False):
                # The engine's insert/step/extract programs replace the
                # forward buckets: capturing both would double startup for
                # nothing.
                rt = build_runtime(model, device=self.device, metrics=self.metrics,
                                   compile_forward=False, debug_nans=self.cfg.debug_nans)
                eng = GenEngine(model, rt, self.metrics, self.cfg.genserve,
                                stages=self.stages, pipeline_cfg=self.cfg.pipeline)
                eng.compile()  # registers, captures and prewarms the programs
                self.engines[mcfg.name] = eng
            else:
                rt = build_runtime(model, device=self.device, metrics=self.metrics,
                                   prewarm=self.cfg.prewarm_executables,
                                   debug_nans=self.cfg.debug_nans)
                if self.cfg.roofline_probe_iters > 0:
                    rt.probe_all_raw(int(self.cfg.roofline_probe_iters))
            # Armed after warm-up and probes: chaos targets the serving path.
            rt.injector = self.injector
            self.models[mcfg.name] = model
            self.runtimes[mcfg.name] = rt
            log.info("model %s ready in %.1fs: %s", mcfg.name,
                     time.perf_counter() - t0, rt.describe())

    def ingest_handles(self, index: int) -> IngestHandles:
        """Prebound ingest counters for accept loop ``index`` (idempotent)."""
        h = self.ingest.get(index)
        if h is None:
            h = self.ingest[index] = IngestHandles(index, self.metrics)
        return h

    async def start(self) -> None:
        self.main_loop = asyncio.get_running_loop()
        self.connections = Connections()
        self.ingest_handles(0)
        preproc.set_native_fallback_hook(self._note_native_fallback)
        for name, model in self.models.items():
            rt = self.runtimes[name]
            br = CircuitBreaker(name, model.cfg.breaker_threshold, self.metrics,
                                retry_after_s=model.cfg.breaker_retry_after_s)
            self.breakers[name] = br
            eng = self.engines.get(name)
            if eng is not None:
                # The same front-door surface as the batcher: canary, cache,
                # watchdog, lifecycle and drain compose unchanged.
                eng.breaker, eng.injector = br, self.injector
                await eng.start()
                b: "ModelBatcher | GenEngine" = eng
            else:
                b = ModelBatcher(model, rt, self.metrics, stages=self.stages,
                                 pipeline_cfg=self.cfg.pipeline,
                                 adaptive_cfg=self.cfg.adaptive, breaker=br,
                                 injector=self.injector)
                await b.start()
            self.batchers[name] = b
            self.handles[name] = ModelHandles(name, model.cfg, self.metrics)
            if self.cfg.cache.enabled and model.cfg.cacheable:
                # Keys carry the LIVE version, so a publish or rollback
                # invalidates every older entry.
                self.caches[name] = ModelCache(
                    name, self.cfg.cache, self.metrics,
                    version_fn=functools.partial(getattr, rt, "version"))
            self.watchdog.register(name, "group_loop", b.revive_group_loops)
            # Engine-served models canary a staged candidate with a SHORT
            # generation through the real programs, on the scratch block.
            self.lifecycles[name] = ModelLifecycle(
                name, rt, model, self.cfg.lifecycle, self.metrics, breaker=br,
                canary=functools.partial(self.run_canary, name),
                canary_status=functools.partial(self.canary_ok.get, name),
                injector=self.injector,
                staged_canary_fn=eng.staged_canary_sync if eng is not None else None)
        if self.slo is not None:
            # Models whose [model.slo] names a latency objective get burn
            # gauges and an /alerts row; a first-unit objective is its own
            # subject over gen_first_unit_ms.
            for mcfg in self.cfg.models:
                self.slo.register(mcfg.name, mcfg.slo)
                if mcfg.slo.first_unit_ms > 0:
                    self.slo.register(
                        f"{mcfg.name}:first_unit",
                        SloConfig(latency_ms=mcfg.slo.first_unit_ms,
                                  availability=mcfg.slo.availability,
                                  burn_alert=mcfg.slo.burn_alert),
                        metric=f"gen_first_unit_ms{{model={mcfg.name}}}")
        if self.sampler is not None:
            self.sampler.start()
        if self.cfg.startup_canary:
            await self.run_canaries()
        if self.cfg.canary_interval_s > 0:
            self._canary_task = asyncio.get_running_loop().create_task(self._canary_loop())
        if self.events is not None and self.cfg.events.snapshot_path \
                and self.cfg.events.snapshot_interval_s > 0:
            # Checkpoint a postmortem snapshot once now and then on the
            # interval, so a SIGKILL at any point after boot leaves the last
            # events, flight summaries and key counters for the supervisor.
            self.blackbox = BlackBoxWriter(self.cfg.events.snapshot_path,
                                           self.cfg.events.snapshot_interval_s,
                                           self._blackbox_snapshot)
            self.blackbox.start()
        self.watchdog.start()

    # Counter families the black-box snapshot carries: the serving volume and
    # failure tallies a postmortem reader checks first.
    _BLACKBOX_COUNTERS = frozenset((
        "requests_total", "bad_requests_total", "timeouts_total",
        "deadline_exceeded_total", "batches_total",
        "watchdog_restarts_total", "events_logged_total"))

    def _blackbox_snapshot(self) -> dict:
        """One postmortem checkpoint (BlackBoxWriter's ``collect``): the
        last 50 event records, compact flight-recorder summaries (trace
        ids, not span trees) and the key counters. Runs on the black-box
        thread; everything it reads is locked."""
        counters = {name: v for name, v in self.metrics.counter_values().items()
                    if name.split("{", 1)[0] in self._BLACKBOX_COUNTERS}
        dumped = self.recorder.dump()
        slow = [{"model": model, "trace_id": r["trace_id"], "status": r["status"],
                 "duration_ms": r["duration_ms"]}
                for model, recs in sorted(dumped.get("slow", {}).items())
                for r in recs[:4]]
        errors = [{"model": r["model"], "trace_id": r["trace_id"], "status": r["status"],
                   "duration_ms": r["duration_ms"]} for r in dumped.get("errors", [])[:8]]
        return {"ts": round(time.time(), 3), "pid": os.getpid(),
                "worker_id": self.worker_id,
                "events": self.events.tail(50) if self.events is not None else [],
                "flight": {"slow": slow, "errors": errors}, "counters": counters}

    async def _stop_blackbox(self) -> None:
        if self.blackbox is not None:
            await asyncio.get_running_loop().run_in_executor(None, self.blackbox.stop)

    def _note_native_fallback(self, model: str) -> None:
        self.handles[model].native_fallback.inc()

    async def _stop_canary_loop(self) -> None:
        if self._canary_task is not None:
            self._canary_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._canary_task
            self._canary_task = None

    async def stop(self) -> None:
        await self.watchdog.stop()
        await self._stop_sampler()
        await self._stop_blackbox()
        for lc in self.lifecycles.values():
            lc.close()  # stop soak monitors
        await self._stop_canary_loop()
        for b in self.batchers.values():
            await b.stop()
        self.stages.shutdown()
        self.pool.shutdown(wait=False, cancel_futures=True)
        if self.profiler is not None:
            self.profiler.close()
        if self.events is not None:
            self.events.close()  # close the JSONL sink

    async def _stop_sampler(self) -> None:
        """Join the telemetry sampler off the loop (idempotent)."""
        if self.sampler is not None:
            await asyncio.get_running_loop().run_in_executor(None, self.sampler.stop)

    # -- graceful drain ------------------------------------------------------
    def begin_drain(self) -> None:
        """Stop admitting requests: predict answers 503 + Retry-After and
        /healthz turns "draining" so load balancers pull this replica."""
        self.draining = True

    async def drain(self) -> bool:
        """SIGTERM path: stop the revival machinery (the watchdog must not
        revive a loop the drain quiesces, the canary must not add work after
        admission closed), refuse new work, then wait up to
        ``drain_timeout_s`` for every accepted request. False when the
        budget expired first."""
        t_drain = time.perf_counter()
        await self.watchdog.stop()
        await self._stop_canary_loop()
        self.begin_drain()
        # The sampler and the black box only read: they join after admission
        # closed.
        await self._stop_sampler()
        await self._stop_blackbox()
        deadline = asyncio.get_running_loop().time() + self.cfg.drain_timeout_s
        ok = True
        for b in self.batchers.values():
            ok &= await b.drain(deadline)
        if self.audit is not None:
            self.audit.record("drain", "server", "ok" if ok else "budget_expired",
                              duration_ms=(time.perf_counter() - t_drain) * 1e3,
                              drain_timeout_s=self.cfg.drain_timeout_s)
        return ok

    # -- canaries ------------------------------------------------------------
    async def _canary_loop(self) -> None:
        """Re-run every model's canary each ``canary_interval_s`` so /healthz,
        the soak monitor and the breaker's recovery reflect live serving
        health. Each cycle's timeout is bounded by the interval but never
        below a model's own request_timeout_ms."""
        base = min(60.0, max(2.0, 2.0 * self.cfg.canary_interval_s))
        timeouts = {name: max(base, m.cfg.request_timeout_ms / 1e3)
                    for name, m in self.models.items()}
        while True:
            self._next_canary_at = time.monotonic() + self.cfg.canary_interval_s
            await asyncio.sleep(self.cfg.canary_interval_s)
            try:
                await self.run_canaries(timeouts=timeouts)
            except Exception:  # one bad cycle must not end re-canarying
                log.exception("periodic canary cycle failed")

    async def run_canaries(self, timeout_s: float = 60.0,
                           timeouts: dict[str, float] | None = None) -> None:
        # Concurrent: one hung model must not stall the others.
        await asyncio.gather(*(self.run_canary(n, timeout_s=(timeouts or {}).get(n, timeout_s))
                               for n in self.models))

    async def run_canary(self, name: str, timeout_s: float = 60.0) -> bool:
        """Tiny end-to-end inference through the batcher; feeds /healthz and
        half-opens/closes the breaker (canaries ride the batcher whatever
        the breaker's state: they are the recovery probe)."""
        model = self.models[name]
        br = self.breakers.get(name)
        try:
            if self.injector is not None:
                self.injector.check("canary_fail", name)
            if br is not None:
                br.probe()
            item = model.canary_item()
            fut = self.batchers[name].submit(item, group=model.group_key(item))
            await asyncio.wait_for(fut, timeout=timeout_s)
            self.canary_ok[name] = True
        except QueueFull:
            log.info("canary for %s skipped: queue full (shedding)", name)
        except Exception:
            log.exception("canary failed for %s", name)
            self.canary_ok[name] = False
        return self.canary_ok.get(name, True)

    # -- Retry-After hints ---------------------------------------------------
    def shed_retry_after(self) -> int:
        """Retry-After seconds on drain 503s: this replica is going away."""
        return max(1, math.ceil(self.cfg.shed_retry_after_s))

    def queue_retry_after(self, name: str) -> int:
        """Retry-After seconds on queue-full 429s: the batcher's estimated
        queue-clear time, clamped to [1, 30] s; the configured constant
        before any batch has completed."""
        b = self.batchers.get(name)
        hint = clamp_retry_after_s(b.estimate_clear_s() if b is not None else None)
        return hint if hint is not None else self.shed_retry_after()

    def kv_retry_after(self, name: str, exc: KVPressure) -> int:
        """Retry-After seconds on paged-KV pressure 503s: the engine's
        page-clear estimate carried on the shed, clamped like every hint;
        the queue-clear hint before the engine has duration evidence."""
        hint = clamp_retry_after_s(exc.retry_after_s)
        return hint if hint is not None else self.queue_retry_after(name)

    def breaker_retry_after(self, name: str) -> int:
        """Retry-After seconds on breaker 503s: the time to the next
        periodic canary when canaries drive recovery (the interval before
        the loop armed a fire time), else the model's configured hint."""
        if self.cfg.canary_interval_s > 0:
            if self._next_canary_at is not None:
                eta = self._next_canary_at - time.monotonic()
                return max(1, math.ceil(eta)) if eta > 0 else 1
            return max(1, math.ceil(self.cfg.canary_interval_s))
        br = self.breakers.get(name)
        return max(1, math.ceil(br.retry_after_s if br else 1.0))

    # -- routing -------------------------------------------------------------
    async def handle(self, req: Request, ingest: IngestHandles) -> Response:
        """Route one request. Predict runs on the accept loop that read it
        (hopping once onto the main loop for the batcher); every other
        route touches main-loop state and runs there."""
        path = req.path
        if path.startswith("/v1/models/") and ":" in path:
            name, _, verb = path[len("/v1/models/"):].rpartition(":")
            if verb in _VERBS and name and "/" not in name:
                if req.method != "POST":
                    resp = _text(405)
                    resp.headers["Allow"] = "POST"
                    return resp
                return await self.predict(req, name, ingest)
        await req.read()
        return await _on_main(self, lambda: self._route(req))

    async def _route(self, req: Request) -> Response:
        path = req.path
        if path.startswith("/admin/models/"):
            return await self.admin(req, path[len("/admin/models/"):])
        routes = {
            "/": ("GET", self.index),
            "/healthz": ("GET", self.healthz),
            "/metrics": ("GET", self.metrics_text),
            "/stats": ("GET", self.stats),
            "/v1/models": ("GET", self.models_json),
            "/debug/kernels:reset": ("POST", self.reset_kernel_counts),
            "/debug/trace": ("GET", self.debug_trace),
            "/debug/slow": ("GET", self.debug_slow),
            "/debug/events": ("GET", self.debug_events),
            "/debug/audit": ("GET", self.debug_audit),
            "/debug/postmortems": ("GET", self.debug_postmortems),
            "/debug/profile": ("POST", self.debug_profile),
            "/stats/history": ("GET", self.stats_history),
            "/alerts": ("GET", self.alerts),
        }
        route = routes.get(path)
        if route is None:
            return _text(404)
        method, fn = route
        if req.method != method and not (method == "GET" and req.method == "HEAD"):
            resp = _text(405)
            resp.headers["Allow"] = method
            return resp
        resp = fn(req)
        return await resp if asyncio.iscoroutine(resp) else resp

    async def admin(self, req: Request, rest: str) -> Response:
        """``{name}:reload``, ``{name}:rollback`` (POST) and
        ``{name}/versions`` (GET), with the JAX server's answers; reloads and
        rollbacks leave audit records."""
        if rest.endswith("/versions"):
            name, verb, method = rest[:-len("/versions")], "versions", "GET"
        else:
            name, _, verb = rest.rpartition(":")
            method = "POST"
        if not name or "/" in name or verb not in ("reload", "rollback", "versions"):
            return _text(404)
        if req.method != method and not (method == "GET" and req.method == "HEAD"):
            resp = _text(405)
            resp.headers["Allow"] = method
            return resp
        lc = self.lifecycles.get(name)
        if lc is None:
            return _err(404, f"unknown model {name!r}")
        if verb == "versions":
            return json_response(lc.describe())
        t0 = time.perf_counter()

        def audit(outcome: str, **fields) -> None:
            if self.audit is not None:
                self.audit.record(verb, name, outcome,
                                  duration_ms=(time.perf_counter() - t0) * 1e3, **fields)

        if verb == "rollback":
            try:
                info = await lc.rollback(reason="manual")
            except ValueError as e:
                audit("rejected", error=str(e))
                return _err(409, str(e))
            audit("ok", version=info.get("version"),
                  rolled_back_from=info.get("rolled_back_from"))
            return json_response(info)
        try:
            info = await lc.reload()
        except ReloadRejected as e:
            version = self.runtimes[name].version
            audit("rolled_back" if e.rolled_back else "rejected", stage=e.stage,
                  version=version, error=str(e))
            body = {"error": str(e), "stage": e.stage, "rolled_back": e.rolled_back,
                    "version": version}
            # Pre-publish rejection: an artifact conflict (409). A
            # post-publish rollback: bad weights were briefly live (500).
            return json_response(body, status=500 if e.rolled_back else 409)
        except Exception as e:  # noqa: BLE001
            log.exception("reload of %s failed", name)
            audit("error", error=str(e))
            return _err(500, f"reload failed: {e}")
        audit("ok", version=info.get("version"))
        return json_response(info)

    def index(self, req: Request) -> Response:
        return Response(200, _INDEX_HTML.encode("utf-8"),
                        content_type="text/html; charset=utf-8")

    def healthz(self, req: Request) -> Response:
        if self.draining:
            return json_response({"status": "draining", "models": self.canary_ok},
                                 status=503)
        ok = all(self.canary_ok.values()) if self.canary_ok else True
        return json_response({"status": "ok" if ok else "degraded",
                              "models": self.canary_ok}, status=200 if ok else 503)

    def metrics_text(self, req: Request) -> Response:
        return Response(200, self.metrics.render_prometheus().encode("utf-8"),
                        content_type=exposition_content_type(req.headers.get("accept")))

    def models_json(self, req: Request) -> Response:
        return json_response({n: rt.describe() for n, rt in self.runtimes.items()})

    def kernel_counts(self) -> dict:
        by_shape = {"x".join(map(str, s)): n for s, n in sorted(fa.shape_launches.items())}
        return {"flash_attention": {"launches": fa.launches, "by_shape": by_shape},
                "flash_attention_stats": {"launches": fa.stats_launches}}

    def reset_kernel_counts(self, req: Request) -> Response:
        fa.reset_launches()
        return json_response({"kernels": self.kernel_counts()})

    def stats(self, req: Request) -> Response:
        out = self.metrics.summary()
        out["backend"] = backend_info(self.device)
        out["kernels"] = self.kernel_counts()
        out["robustness"] = {
            "draining": self.draining,
            "breakers": {n: br.describe() for n, br in self.breakers.items()},
        }
        if self.injector is not None:
            out["robustness"]["faults"] = self.injector.snapshot()
        # Flight-recorder occupancy (the trees are at /debug/slow and
        # /debug/trace?trace_id=).
        out["trace"] = self.recorder.stats()
        if self.events is not None:
            out["events"] = {**self.events.stats(), "audit": self.audit.stats(),
                             "postmortems": self.postmortems.stats()}
        if self.store is not None:
            out["telemetry"] = {**self.store.stats(),
                                "sample_interval_s": self.cfg.telemetry.sample_interval_s,
                                "profile": self.profiler.stats()}
        if self.util is not None:
            util = self.util.stats()
            if util:
                out["utilization"] = util
        if self.slo is not None:
            alerts = self.slo.alerts()
            if alerts["models"]:
                out["slo"] = alerts
        out["lifecycle"] = {n: lc.describe() for n, lc in self.lifecycles.items()}
        out["ingest"] = {
            "loops": {str(i): {"requests": ih.requests.value, "bytes": ih.bytes.value}
                      for i, ih in sorted(self.ingest.items())},
            "frame_errors_total": {n: h.frame_errors.value for n, h in self.handles.items()},
            "native_decode_fallback_total": {
                n: h.native_fallback.value for n, h in self.handles.items()},
        }
        out["pipeline"] = {
            "stages": self.stages.stats(),
            "models": {n: b.pipeline_stats() for n, b in self.batchers.items()},
        }
        if self.caches:
            out["cache"] = {n: c.stats() for n, c in self.caches.items()}
        if self.engines:
            # Slot occupancy, fold-in/early-exit/eviction counts, step
            # timing and the KV page pool, per engine-served model.
            out["genserve"] = {n: e.pipeline_stats() for n, e in self.engines.items()}
        roofline = self.roofline(out["latency"])
        if roofline:
            out["roofline"] = roofline
        return json_response(out)

    def roofline(self, latency_summary: dict) -> dict:
        """The /stats ``roofline`` block, as the reference builds it: per
        model the resident variants, the lifetime compile count, the raw
        forward ms per bucket (when ``roofline_probe_iters`` armed the
        startup probes), the live utilization, and the serving compute
        phase split into device time and host wait."""
        out: dict = {}
        for name, rt in self.runtimes.items():
            row: dict = {
                "variants": rt.variants_summary(),
                "compiles_total": rt.compiles_total,
                "raw_ms_per_batch": {str(list(b)): v
                                     for b, v in sorted(rt.raw_ms_per_batch.items())},
            }
            if self.util is not None:
                u = self.util.stats().get(name)
                if u:
                    row["utilization"] = u
            raw_vals = [v for v in rt.raw_ms_per_batch.values() if v]
            if raw_vals:
                # The largest probed bucket prices the split: it is what a
                # saturated loop overwhelmingly serves, and the biggest raw
                # time makes host_wait a lower bound.
                split = compute_split(phase_p50(latency_summary, name, "compute"),
                                      max(raw_vals))
                if split is not None:
                    row["compute_split"] = split
            out[name] = row
        return out

    # -- observability routes -------------------------------------------------
    def debug_trace(self, req: Request) -> Response:
        """The span ring as Chrome JSON (``?limit=``, default 5000;
        ``?since_us=``), or with ``?trace_id=`` one recorded request's span
        tree, its events interleaved (``&format=record``: the raw record
        with an ``events`` key)."""
        trace_id = req.query.get("trace_id")
        if trace_id:
            rec = self.recorder.get(trace_id)
            if rec is None:
                return _err(404, f"trace {trace_id!r} is not in the flight "
                                 "recorder (evicted or never retained)")
            events = (self.events.query(trace_id=trace_id, limit=200)
                      if self.events is not None else [])
            if req.query.get("format") == "record":
                return json_response(dict(rec, events=events))
            return Response(200, spans_to_chrome(rec["spans"], events=events).encode())
        try:
            limit = int(req.query.get("limit", "5000"))
            since_us = float(req.query["since_us"]) if "since_us" in req.query else None
        except ValueError as e:
            return _err(400, f"limit/since_us must be numbers: {e}")
        if limit < 0:
            return _err(400, f"limit must be >= 0, got {limit}")
        return Response(200, self.metrics.tracer.chrome_trace(
            limit=limit, since_us=since_us).encode())

    def debug_slow(self, req: Request) -> Response:
        return json_response(self.recorder.dump(model=req.query.get("model")))

    def debug_events(self, req: Request) -> Response:
        if self.events is None:
            return _err(409, "[events] is disabled; no events are recorded")
        try:
            q = events_mod.parse_events_query(req.query)
        except ValueError as e:
            return _err(400, str(e))
        return json_response({"events": self.events.query(**q), **self.events.stats()})

    def debug_audit(self, req: Request) -> Response:
        if self.audit is None:
            return _err(409, "[events] is disabled; no audit trail is kept")
        return json_response({"audit": self.audit.dump(), **self.audit.stats()})

    def debug_postmortems(self, req: Request) -> Response:
        if self.postmortems is None:
            return _err(409, "[events] is disabled; no postmortems are kept")
        return json_response({"postmortems": self.postmortems.dump(),
                              **self.postmortems.stats()})

    def stats_history(self, req: Request) -> Response:
        """Metric history from the telemetry rings: without ``?metric=`` the
        recorded series' names; with it (a full labelled name or a base
        name) each matching series, over ``?window_s=``."""
        if self.store is None:
            return _err(409, "[telemetry] is disabled; no history is recorded")
        metric = req.query.get("metric")
        if not metric:
            return json_response({"metrics": self.store.metric_names(),
                                  **self.store.stats()})
        try:
            window_s = float(req.query["window_s"]) if "window_s" in req.query else None
            if window_s is not None and window_s <= 0:
                raise ValueError(window_s)
        except (TypeError, ValueError):
            return _err(400, "window_s must be a positive number")
        names = self.store.match(metric)
        if not names:
            return _err(404, f"no recorded series matches {metric!r} "
                             "(GET /stats/history lists the inventory)")
        series = [self.store.history(n, window_s) for n in names]
        return json_response({"series": [x for x in series if x is not None]})

    def alerts(self, req: Request) -> Response:
        if self.slo is None:
            return _err(409, "[telemetry] is disabled; no SLO evaluation runs")
        return json_response(self.slo.alerts())

    async def debug_profile(self, req: Request) -> Response:
        """Arm a device trace for ``?duration_ms=`` (default 500) and answer
        one merged Chrome trace: device lanes (pids >= 1000) beside the span
        ring's events of the same window. 409 while a capture is armed."""
        if self.profiler is None:
            return _err(409, "[telemetry] is disabled; profiling is not armed")
        try:
            duration_ms = float(req.query.get("duration_ms", "500"))
        except (TypeError, ValueError):
            return _err(400, "duration_ms must be a number")
        cap = self.cfg.telemetry.profile_max_ms
        if not 1.0 <= duration_ms <= cap:
            return _err(400, f"duration_ms must be in [1, {cap:g}], got {duration_ms:g}")
        t0 = time.perf_counter()
        try:
            merged = await self.profiler.capture(duration_ms)
        except CaptureBusy:
            if self.audit is not None:
                self.audit.record("profile", "server", "busy", requested_ms=duration_ms)
            return _err(409, "a profile capture is already armed "
                             "(the profiler is one-at-a-time)")
        if self.audit is not None:
            self.audit.record("profile", "server", "ok",
                              duration_ms=(time.perf_counter() - t0) * 1e3,
                              requested_ms=duration_ms)
        return json_response(merged)

    # -- predict -------------------------------------------------------------
    async def predict(self, req: Request, name: str, ingest: IngestHandles) -> Response:
        """Adopt (or mint) the request's trace context, serve it, then stamp
        ``X-Trace-Id`` on the response, record the root span and offer the
        finished trace to the flight recorder; errored and retained-slow
        requests leave an event carrying the trace id."""
        ctx = TraceContext.from_headers(
            req.headers, pid=self.worker_id + 1 if self.worker_id is not None else 0)
        wall0 = time.time()
        t0 = time.perf_counter()
        resp = await self._predict_traced(req, name, ingest, ctx)
        dur_s = time.perf_counter() - t0
        ctx.root_span("request", wall0, wall0 + dur_s, tid=name, status=resp.status)
        resp.headers.setdefault("X-Trace-Id", ctx.trace_id)
        # A stream scores by max(first unit, largest gap), so a slow stream
        # is catchable while a long healthy generation is not filed as slow.
        score_ms = getattr(resp, "stream_score_ms", None)
        kinds = self.recorder.finish(
            ctx, name, resp.status, score_ms if score_ms is not None else dur_s * 1e3)
        if self.events is not None:
            if resp.status >= 400:
                self.events.emit(
                    "error" if resp.status >= 500 else "warning", "http",
                    "request_error", model=name, trace_id=ctx.trace_id,
                    status=resp.status, duration_ms=round(dur_s * 1e3, 3))
            elif "slow" in kinds:
                self.events.emit(
                    "info", "http", "slow_request", model=name,
                    trace_id=ctx.trace_id, status=resp.status,
                    duration_ms=round(dur_s * 1e3, 3))
        return resp

    async def _predict_traced(self, req: Request, name: str, ingest: IngestHandles,
                              ctx: TraceContext) -> "Response | StreamResponse":
        trace_id = ctx.trace_id
        model = self.models.get(name)
        if model is None:
            return _err(404, f"unknown model {name!r}", trace_id=trace_id)
        # Shed checks run BEFORE the body is read and decoded: a draining
        # replica or a tripped model answers at once, with a Retry-After.
        if self.draining:
            return _err(503, "server draining; retry against another replica",
                        retry_after=self.shed_retry_after(), trace_id=trace_id)
        breaker = self.breakers.get(name)
        if breaker is not None and not breaker.allow():
            breaker.on_shed()
            return _err(503, f"circuit open for model {name!r}; recovery probe "
                             "in progress",
                        retry_after=self.breaker_retry_after(name), trace_id=trace_id)
        try:
            want_stream = _requested_stream(req)
        except ValueError as e:
            return _err(400, str(e), trace_id=trace_id)
        h = self.handles[name]
        h.requests.inc()
        t_start = time.perf_counter()
        if self.injector is not None:
            # Process-boundary chaos: a degraded (worker_slow), wedged
            # (worker_hang: the request never answers) or crashed
            # (worker_crash: the process exits, taking every request in it)
            # serving process. Behind the router they prove hedging, retry
            # and supervision; alone they show the blast radius the split
            # removes.
            delay = self.injector.delay_s("worker_slow", name)
            if delay > 0:
                await asyncio.sleep(delay)
            if self.injector.fire("worker_hang", name) is not None:
                await asyncio.sleep(_WORKER_HANG_S)
                return _err(503, "wedged worker unwedged; retry", trace_id=trace_id)
            if self.injector.fire("worker_crash", name) is not None:
                log.error("chaos: worker_crash fired for %s: exiting the process", name)
                os._exit(17)
        w_read = time.time()
        body = await req.read()
        h.body_read_hist.observe(req.read_s * 1e3, trace_id=trace_id)
        ctx.span("body_read", w_read, w_read + req.read_s, tid=name,
                 loop=ingest.index, bytes=len(body))
        ingest.requests.inc()
        ingest.bytes.inc(len(body))
        ctype = req.content_type
        try:
            timeout_ms = _requested_timeout_ms(req, ctype)
        except ValueError as e:
            return _err(400, str(e), trace_id=trace_id)
        timeout_s = (timeout_ms if timeout_ms is not None
                     else h.mcfg.request_timeout_ms) / 1e3
        deadline_at = t_start + timeout_s
        try:
            if self.injector is not None:
                self.injector.check("decode_corrupt", name)
            t_parse = time.perf_counter()
            w_parse = time.time()
            if self.cfg.decode_inline:
                items, batched = model.host_decode_items(body, ctype)
            else:
                items, batched = await asyncio.get_running_loop().run_in_executor(
                    self.pool, model.host_decode_items, body, ctype)
            if not items:
                raise ValueError("empty batch")
            parse_s = time.perf_counter() - t_parse
            h.parse_hist.observe(parse_s * 1e3, trace_id=trace_id)
            ctx.span("parse", w_parse, w_parse + parse_s, tid=name, items=len(items))
        except FrameError as e:
            h.frame_errors.inc()
            h.bad_requests.inc()
            return _err(400, str(e), trace_id=trace_id)
        except Exception as e:
            h.bad_requests.inc()
            return _err(400, f"could not decode request: {e}", trace_id=trace_id)

        if want_stream:
            # Straight to the engine's emission channel: no result cache, no
            # single-flight (a stream never coalesces onto a buffered leader
            # nor answers from a cached body), and never the unary path.
            eng = self.engines.get(name)
            if eng is None:
                h.bad_requests.inc()
                return _err(400, f"model {name!r} does not support streaming "
                                 "(stream=true needs a [genserve]-served "
                                 "generative model)", trace_id=trace_id)
            if len(items) != 1:
                h.bad_requests.inc()
                return _err(400, "stream=true requires a single-item request",
                            trace_id=trace_id)
            return await self._predict_stream(req, name, model, h, eng, items[0],
                                              deadline_at, timeout_s, ctx, t_start)

        w_dispatch = time.time()
        t_dispatch = time.perf_counter()
        try:
            results, hit_entry = await _on_main(self, lambda: self._submit_and_gather(
                name, model, items, deadline_at, timeout_ms, ctx))
        except KVPressure as e:
            # Paged-KV admission shed: the fast-shed contract of queue-full,
            # but 503 with reason "kv_pressure", so clients can tell memory
            # pressure from queue pressure.
            return _err(503, str(e), retry_after=self.kv_retry_after(name, e),
                        trace_id=trace_id, reason="kv_pressure")
        except QueueFull:
            return _err(429, "queue full, retry later",
                        retry_after=self.queue_retry_after(name), trace_id=trace_id)
        except NotServing as e:
            return _err(503, f"server not accepting requests: {e}", trace_id=trace_id)
        except DeadlineExceeded as e:
            return _err(504, f"deadline_exceeded: {e}", trace_id=trace_id)
        except asyncio.TimeoutError:
            h.timeouts.inc()
            return _err(504, f"request deadline ({timeout_s * 1e3:.0f} ms) exceeded",
                        trace_id=trace_id)
        except Exception as e:
            return _err(500, f"inference failed: {e}", trace_id=trace_id)
        finally:
            # The hop onto the main loop plus everything it ran (cache,
            # single-flight, batcher): the batcher's spans are its children
            # in time.
            ctx.span("dispatch", w_dispatch,
                     w_dispatch + (time.perf_counter() - t_dispatch), tid=name)
        h.total_hist.observe((time.perf_counter() - t_start) * 1e3, trace_id=trace_id)
        headers = {"X-Trace-Id": trace_id}
        if batched:
            return json_response({"results": results}, headers=headers)
        if isinstance(results[0], bytes):  # sd15's PNG
            return Response(200, results[0], content_type="image/png", headers=headers)
        if hit_entry is not None and hit_entry.body is not None:
            # Cache hit: the response bytes were serialized once, when the
            # entry was made.
            return Response(200, hit_entry.body, headers=headers)
        return json_response(results[0], headers=headers)

    async def _predict_stream(self, req: Request, name: str, model, h: ModelHandles,
                              eng: GenEngine, item, deadline_at: float,
                              timeout_s: float, ctx: TraceContext,
                              t_start: float) -> "Response | StreamResponse":
        """One streamed generation end to end. The engine's GenStream queue
        is the single channel: units flush per engine iteration, heartbeats
        cover idle gaps, and exactly one terminal ("done" with finish reason
        and usage, or "error" naming the cause) closes every started
        stream. The deadline contract splits here: until the first unit no
        byte is written and failures stay plain statuses (a fast 504); after
        it they become in-stream error events. The stream's queue lives on
        the main loop: every read hops there (``_on_main``), every write
        happens on this connection's loop. A client gone mid-stream cancels
        the engine future, which frees its slot."""
        trace_id = ctx.trace_id

        async def _submit():
            try:
                return eng.submit_stream(item, deadline_at=deadline_at, ctx=ctx)
            except QueueFull:
                raise
            except RuntimeError as e:
                raise NotServing(str(e)) from e

        try:
            fut, stream = await _on_main(self, _submit)
        except KVPressure as e:
            return _err(503, str(e), retry_after=self.kv_retry_after(name, e),
                        trace_id=trace_id, reason="kv_pressure")
        except QueueFull:
            return _err(429, "queue full, retry later",
                        retry_after=self.queue_retry_after(name), trace_id=trace_id)
        except NotServing as e:
            return _err(503, f"server not accepting requests: {e}", trace_id=trace_id)

        hb_s = eng.gcfg.stream_heartbeat_s
        hb = model.stream_heartbeat()
        encode = model.encode_stream_unit
        resp: StreamResponse | None = None
        terminal: dict | None = None
        n_units = 0
        last_write: float | None = None
        first_unit_ms: float | None = None
        max_gap_ms = 0.0
        max_gap_end = 0.0
        try:
            while terminal is None:
                if resp is None:
                    # Admission -> first unit: bounded by the request
                    # deadline plus the unary path's 0.25 s backstop grace
                    # (the engine's fast-504 eviction normally answers first).
                    budget = max(0.0, deadline_at - time.perf_counter()) + 0.25
                    try:
                        unit = await _on_main(self, lambda: asyncio.wait_for(
                            stream.get(), budget))
                    except asyncio.TimeoutError:
                        h.timeouts.inc()
                        return _err(504, f"request deadline ({timeout_s * 1e3:.0f} "
                                         "ms) exceeded", trace_id=trace_id)
                    if unit["type"] == "error":
                        status = _stream_error_status(unit.get("error", ""))
                        if status == 504:
                            h.timeouts.inc()
                        return _err(status, f"{unit.get('error', 'error')}: "
                                            f"{unit.get('message', '')}",
                                    trace_id=trace_id)
                    resp = StreamResponse(req, model.stream_content_type(),
                                          {"X-Tpuserve-Stream": "1",
                                           "X-Trace-Id": trace_id})
                    try:
                        await resp.prepare()
                    except ConnectionError:
                        return resp
                else:
                    try:
                        unit = await _on_main(self, lambda: asyncio.wait_for(
                            stream.get(), hb_s if hb_s > 0 else None))
                    except asyncio.TimeoutError:
                        try:
                            await resp.write(hb)
                        except ConnectionError:
                            return resp
                        continue
                now = time.perf_counter()
                if first_unit_ms is None:
                    first_unit_ms = (now - t_start) * 1e3
                elif last_write is not None:
                    gap = (now - last_write) * 1e3
                    if gap > max_gap_ms:
                        max_gap_ms, max_gap_end = gap, time.time()
                last_write = now
                if unit["type"] in ("done", "error"):
                    terminal = unit
                try:
                    await resp.write(encode(unit))
                except ConnectionError:
                    return resp  # the finally below frees the slot
                n_units += 1
                if self.injector is not None and terminal is None:
                    # Chaos on a STARTED stream: stream_stall wedges the
                    # writer (units and heartbeats stop); stream_disconnect
                    # tears the transport with NO terminal event, the torn
                    # shape clients must count as an error.
                    if self.injector.fire("stream_stall", name) is not None:
                        await asyncio.sleep(_STREAM_STALL_S)
                        return resp
                    if self.injector.fire("stream_disconnect", name) is not None:
                        resp.abort()
                        return resp
        finally:
            if terminal is None:
                # Abandoned mid-stream (client gone, handler cancelled,
                # injected tear): cancel the engine future so the slot frees,
                # and close the stream so a blocked producer wakes. Scheduled
                # on the main loop, not awaited: this may run a cancellation.
                def _abandon():
                    fut.cancel()
                    stream.close()

                (self.main_loop or asyncio.get_running_loop()).call_soon_threadsafe(
                    _abandon)

        # Stream health spans: first-unit latency and the largest gap between
        # units, not the total wall time, say whether a stream was slow.
        wall_end = time.time()
        if max_gap_ms > 0:
            ctx.span("stream_gap", max_gap_end - max_gap_ms / 1e3, max_gap_end,
                     tid=name, gap_ms=round(max_gap_ms, 3))
        ctx.span("stream_terminal", wall_end, wall_end, tid=name,
                 type=terminal["type"],
                 finish_reason=(terminal.get("finish_reason")
                                if terminal["type"] == "done" else terminal.get("error")),
                 units=n_units)
        resp.stream_score_ms = max(first_unit_ms or 0.0, max_gap_ms)
        with contextlib.suppress(ConnectionError):
            await resp.write_eof()
        return resp

    async def _submit_and_gather(self, name: str, model, items: list,
                                 deadline_at: float, timeout_ms: float | None,
                                 ctx: TraceContext | None = None) -> tuple[list, object]:
        """Cache lookup and single-flight, batcher submission and the
        deadline-bounded gather of one decoded request: everything that must
        run on the main loop. Returns (results, the last hit entry or None).
        Raises QueueFull (-> 429), NotServing (-> 503), DeadlineExceeded
        (-> fast 504), asyncio.TimeoutError (-> backstop 504) or the batch
        failure (-> 500)."""
        cache = self.caches.get(name)
        batcher = self.batchers[name]
        results: list = [None] * len(items)
        futs: list[asyncio.Future] = []
        slots: list[int] = []
        hit_entry = None
        try:
            for i, item in enumerate(items):
                if cache is not None:
                    key = cache.key_for(item)
                    entry = cache.get(key)
                    if entry is not None:
                        results[i] = entry.value
                        hit_entry = entry
                        if ctx is not None:
                            now = time.time()
                            ctx.span("cache_hit", now, now, tid=name)
                        continue
                    fut = cache.submit_through(key, lambda it=item: batcher.submit(
                        it, group=model.group_key(it), deadline_at=deadline_at,
                        ctx=ctx), ctx=ctx)
                else:
                    fut = batcher.submit(item, group=model.group_key(item),
                                         deadline_at=deadline_at, ctx=ctx)
                futs.append(fut)
                slots.append(i)
        except QueueFull:
            for f in futs:
                f.cancel()
            raise
        except RuntimeError as e:  # batcher stopped: racing shutdown
            for f in futs:
                f.cancel()
            raise NotServing(str(e)) from e
        if futs:
            try:
                # The batcher enforces an explicit client deadline at flush
                # time; this timer runs slightly late as the backstop.
                grace = 0.25 if timeout_ms is not None else 0.0
                remaining = max(0.0, deadline_at - time.perf_counter())
                done = await asyncio.wait_for(asyncio.gather(*futs),
                                              timeout=remaining + grace)
            except BaseException:
                for f in futs:
                    f.cancel()
                raise
            for i, res in zip(slots, done):
                results[i] = res
        return results, hit_entry


async def _on_main(state: ServerState, factory):
    """Run ``factory()`` (a coroutine factory) on the main loop: a plain
    await there; from an ingest loop the coroutine is scheduled onto the
    main loop (which owns the batchers, caches and breakers) and its result
    or exception crosses back through a concurrent future. Cancelling the
    ingest side's await cancels the main-loop task."""
    loop = asyncio.get_running_loop()
    if state.main_loop is None or loop is state.main_loop:
        return await factory()
    return await asyncio.wrap_future(
        asyncio.run_coroutine_threadsafe(factory(), state.main_loop))


def _requested_stream(req: Request) -> bool:
    """The ``?stream=`` query flag; ValueError (-> 400) on junk values — a
    typo'd flag must fail loudly, not silently serve unary."""
    raw = req.query.get("stream")
    if raw is None:
        return False
    val = raw.strip().lower()
    if val in ("true", "1"):
        return True
    if val in ("false", "0"):
        return False
    raise ValueError(f'stream must be "true", "1", "false" or "0", got {raw!r}')


def _stream_error_status(reason: str) -> int:
    """A terminal before the first unit -> a plain HTTP status (no byte of
    the stream was written, so no stream semantics are owed)."""
    return {"deadline_exceeded": 504, "shutdown": 503, "drain": 503}.get(reason, 500)


def _requested_timeout_ms(req: Request, ctype: str) -> float | None:
    """Client deadline: ``timeout_ms`` as a JSON body key, a ``?timeout_ms=``
    query parameter or an ``X-Timeout-Ms`` header; ValueError (-> 400) when
    present but not a positive number."""
    raw = req.query.get("timeout_ms") or req.headers.get("x-timeout-ms")
    if raw is None and ctype == "application/json" and b"timeout_ms" in req.body:
        try:
            parsed = json.loads(req.body)
        except ValueError:
            return None  # model decode owns malformed-body errors
        if isinstance(parsed, dict):
            raw = parsed.get("timeout_ms")
    if raw is None:
        return None
    try:
        val = float(raw)
    except (TypeError, ValueError):
        raise ValueError(f"timeout_ms must be a number, got {raw!r}") from None
    if not math.isfinite(val) or val <= 0:
        raise ValueError(f"timeout_ms must be a positive number, got {val}")
    return val


# -- HTTP/1.1 on asyncio streams ----------------------------------------------

async def _read_request(reader: asyncio.StreamReader) -> "Request | Response | None":
    """One request's head off the connection: a Request (its body left on
    the socket for ``Request.read``), an error Response to send before
    closing, or None when the peer closed between requests."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError:
        return None
    except asyncio.LimitOverrunError:
        return _text(431)
    try:
        lines = head.decode("latin-1").split("\r\n")
        method, target, version = lines[0].split(" ")
        if not version.startswith("HTTP/1."):
            raise ValueError(version)
        headers = {}
        for line in lines[1:]:
            if line:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0"))
        if length < 0:
            raise ValueError(length)
    except ValueError:
        return _text(400)
    if "chunked" in headers.get("transfer-encoding", "").lower():
        return _err(411, "chunked request bodies are not supported; send Content-Length")
    if length > _MAX_BODY:
        return _text(413)
    path, _, qs = target.partition("?")
    req = Request(method=method.upper(), path=unquote(path),
                  query=dict(parse_qsl(qs)), headers=headers, length=length,
                  reader=reader)
    req.headers[":version"] = version
    return req


def _keep_alive(req: Request) -> bool:
    conn = req.headers.get("connection", "").lower()
    if req.headers.get(":version") == "HTTP/1.0":
        return conn == "keep-alive"
    return conn != "close"


async def _serve_connection(state: ServerState, conns: Connections,
                            ingest: IngestHandles, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
    conns.writers.add(writer)
    try:
        while True:
            try:
                req = await _read_request(reader)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            if req is None:
                return
            if isinstance(req, Response):  # malformed: answer and close
                writer.write(req.encode(keep_alive=False))
                await writer.drain()
                return
            req.writer = writer
            conns.begin()
            try:
                try:
                    resp = await state.handle(req, ingest)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return  # the client went away mid-body
                except Exception as e:
                    log.exception("handler failed for %s %s", req.method, req.path)
                    resp = _err(500, f"internal error: {e}")
                if isinstance(resp, StreamResponse):
                    # Written by the handler as it went: a complete stream
                    # keeps the connection, a torn one closes it.
                    if not resp.complete:
                        return
                    keep = resp.keep_alive
                else:
                    if req.body is None:
                        await req.read()  # a shed left the body: discard it
                    keep = _keep_alive(req)
                    writer.write(resp.encode(keep_alive=keep))
                    await writer.drain()
            finally:
                conns.end()
            if not keep:
                return
    except (asyncio.IncompleteReadError, ConnectionError):
        return  # the client went away mid-request or mid-response
    finally:
        conns.writers.discard(writer)
        writer.close()
        with contextlib.suppress(ConnectionError):
            await writer.wait_closed()


async def _listen(state: ServerState, conns: Connections, ingest: IngestHandles,
                  host: str, port: int, reuse_port: bool) -> asyncio.AbstractServer:
    return await asyncio.start_server(
        lambda r, w: _serve_connection(state, conns, ingest, r, w),
        host, port, limit=_MAX_HEAD, reuse_port=reuse_port or None)


class IngestLoop(threading.Thread):
    """One more accept loop: its own thread, event loop and SO_REUSEPORT
    listener on the serving port. The kernel spreads connections across the
    listeners, so reading, parsing and decoding of this loop's requests do
    not serialize on the main loop; predict hops onto the main loop once per
    request (``_on_main``), and no runtime or batcher is touched from here.
    A daemon thread: a wedged teardown never keeps the process alive."""

    def __init__(self, state: ServerState, index: int, host: str, port: int) -> None:
        super().__init__(name=f"tpuserve-torch-ingest-{index}", daemon=True)
        self.state = state
        self.index = index
        self.host = host
        self.port = port
        self.error: BaseException | None = None
        self._ready = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop_ev: asyncio.Event | None = None

    def run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._serve())
        except BaseException as e:  # noqa: BLE001 — surfaced by wait_ready
            self.error = e
            log.exception("ingest loop %d failed", self.index)
        finally:
            self._ready.set()
            loop.close()

    async def _serve(self) -> None:
        conns = Connections()
        server = await _listen(self.state, conns, self.state.ingest_handles(self.index),
                               self.host, self.port, reuse_port=True)
        self._stop_ev = asyncio.Event()
        self._ready.set()
        try:
            await self._stop_ev.wait()
        finally:
            server.close()
            await conns.close(5.0)
            await server.wait_closed()

    def wait_ready(self, timeout: float = 30.0) -> None:
        """Block (call from an executor) until the listener is up; re-raise
        a bind or startup failure."""
        self._ready.wait(timeout)
        if self.error is not None:
            raise self.error

    def request_stop(self) -> None:
        """Thread-safe: ask the loop to close its listener and exit."""
        loop, ev = self._loop, self._stop_ev
        if loop is not None and ev is not None:
            loop.call_soon_threadsafe(ev.set)


def start_ingest_loops(state: ServerState, host: str, port: int) -> list[IngestLoop]:
    """Spawn the N-1 extra accept loops of ``ingest_loops = N``; the caller
    awaits ``stop_ingest_loops`` at shutdown. Serves on one loop, with a
    warning, where SO_REUSEPORT is missing."""
    n = max(1, state.cfg.ingest_loops)
    if n <= 1:
        return []
    if not hasattr(socket, "SO_REUSEPORT"):
        log.warning("ingest_loops = %d requested but SO_REUSEPORT is not "
                    "available on this platform; serving on one loop", n)
        return []
    threads = [IngestLoop(state, i, host, port) for i in range(1, n)]
    for t in threads:
        t.start()
    return threads


async def stop_ingest_loops(threads: list[IngestLoop]) -> None:
    """Stop and join the ingest loops without blocking the calling loop."""
    loop = asyncio.get_running_loop()
    for t in threads:
        t.request_stop()
    for t in threads:
        await loop.run_in_executor(None, functools.partial(t.join, 10.0))


async def start_server(state: ServerState, host: str | None = None,
                       port: int | None = None) -> asyncio.AbstractServer:
    """Start the batchers (and canaries, watchdog), then listen on the main
    loop and start the ingest loops; ``port=0`` binds an ephemeral port,
    recorded in ``state.serving_addresses``."""
    await state.start()
    host = host if host is not None else state.cfg.host
    reuse = state.cfg.ingest_loops > 1 and hasattr(socket, "SO_REUSEPORT")
    server = await _listen(state, state.connections, state.ingest_handles(0), host,
                           state.cfg.port if port is None else port, reuse)
    state.serving_addresses = [s.getsockname()[:2] for s in server.sockets]
    # Ingest listeners bind the ACTUAL port (an ephemeral one included).
    threads = start_ingest_loops(state, host, state.serving_addresses[0][1])
    server.ingest_threads = threads
    for t in threads:
        await asyncio.get_running_loop().run_in_executor(None, t.wait_ready)
    return server


async def stop_server(state: ServerState, server: asyncio.AbstractServer) -> None:
    """Stop listening (ingest loops first), stop the batchers (queued
    requests fail, in-flight batches finish), let the handlers answer, then
    close the client connections still open."""
    state.draining = True
    await stop_ingest_loops(getattr(server, "ingest_threads", []))
    server.close()
    await state.stop()
    await state.connections.close(5.0)
    await server.wait_closed()


async def serve_async(state: ServerState, ready: asyncio.Event | None = None,
                      stop: asyncio.Event | None = None) -> None:
    """Serve until SIGTERM or SIGINT (or ``stop``), then drain: new requests
    get 503 + Retry-After while every accepted request gets up to
    ``drain_timeout_s`` to finish; only then stop. ``ready`` is set once
    every listener is up."""
    server = await start_server(state)
    loop = asyncio.get_running_loop()
    if stop is None:
        stop = asyncio.Event()
    installed: list[signal.Signals] = []
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
            installed.append(sig)
        except (NotImplementedError, RuntimeError):
            pass  # not the main thread
    for host, port in state.serving_addresses:
        log.info("Running on http://%s:%d (device %s, %d accept loop(s))", host, port,
                 state.device, 1 + len(server.ingest_threads))
    if ready is not None:
        ready.set()
    try:
        await stop.wait()
        log.info("shutdown signal: draining (budget %.0fs)", state.cfg.drain_timeout_s)
        if not await state.drain():
            log.warning("drain budget expired with requests still in flight")
    finally:
        for sig in installed:
            loop.remove_signal_handler(sig)
        await stop_server(state, server)


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line: ts/level/logger/msg (+ exc when present)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        if record.stack_info:
            out["stack"] = self.formatStack(record.stack_info)
        return json.dumps(out, ensure_ascii=False)


def configure_logging(cfg: ServerConfig) -> None:
    """INFO logging to stderr: one JSON object per line with ``log_json``,
    else the human-readable format."""
    if cfg.log_json:
        handler = logging.StreamHandler()
        handler.setFormatter(JsonLogFormatter())
        logging.basicConfig(level=logging.INFO, handlers=[handler])
    else:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def serve(cfg: ServerConfig, device: "str | None" = None) -> None:
    """Serve ``cfg`` until SIGTERM/SIGINT: in this process, or with ``[router]
    enabled`` as a router over worker processes on ``device``."""
    configure_logging(cfg)
    if cfg.router.enabled:
        # This process is the device-free front tier; the supervisor spawns
        # the worker processes that build the models.
        from tpuserve_torch.workerproc import serve_router

        serve_router(cfg, device=device)
        return
    state = ServerState(cfg, device=device)
    state.build()
    # Startup leaves ~200k objects that live as long as the process and a
    # full collection nearly due; scanning them stalls whichever request
    # trips it (over 100 ms on the H100 machine's host once the two models
    # of examples/resnet50.toml are built: scripts/torch_first_request.py).
    # Frozen, they are never scanned again.
    gc.collect()
    gc.freeze()
    asyncio.run(serve_async(state))
