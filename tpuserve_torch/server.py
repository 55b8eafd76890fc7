"""HTTP serving layer of the port, ported from ``tpuserve/server.py``.

The JAX server is built on aiohttp; the port's front door is written on
``asyncio.start_server`` from the standard library (HTTP/1.1,
``Content-Length`` bodies, keep-alive), so it serves on a machine that has
torch and nothing else. One event loop owns the batchers; handlers only read
the body, decode it on the thread pool (``model.host_decode_items``), submit
to the batcher, await the per-item futures and JSON-encode the result. All
device work happens behind the batcher.

Endpoints (response shapes and status codes as in the JAX server):

- ``POST /v1/models/{name}:predict`` (aliases ``:classify``, ``:detect``,
  ``:generate``): ``{"text": ...}`` answers ``{"top_k": [...]}``,
  ``{"texts": [...]}`` answers ``{"results": [...]}`` in request order; for
  an image model an ``application/x-tpuserve-frame`` body or an npy
  (N, H, W, 3) batch answers ``{"results": [...]}``, an npy (H, W, 3) image
  or an encoded image ``{"top_k": [...]}``.
- ``GET /healthz``, ``GET /metrics`` (Prometheus text), ``GET /stats``
  (latency summary, backend — card, torch and CUDA versions, device — the
  ingest block — requests and bytes of the one accept loop, frame errors
  and native-decode fallbacks per model —, the host pipeline and the
  kernels' launch counts), ``GET /v1/models`` (buckets, variants, dtype,
  quantize, device).
- ``POST /debug/kernels:reset`` sets the kernels' launch counts to 0, so a
  caller can count exactly the launches of the requests it sends next.
- ``POST /admin/models/{name}:reload`` (staged, canary-gated weight swap
  from the model's ``weights``: 200 with the new version; 409 with the
  failing gate's ``stage`` and the version still serving; 500 with
  ``rolled_back: true`` when the post-publish canary failed and the
  lifecycle reverted), ``POST /admin/models/{name}:rollback`` (200, or 409
  when no previous version is retained) and ``GET
  /admin/models/{name}/versions`` (live and previous version, soak state,
  history), backed by ``tpuserve_torch.lifecycle``. ``/stats`` carries a
  ``lifecycle`` block, and with ``canary_interval_s`` > 0 every model's
  canary re-runs on that interval, feeding ``/healthz``.

Errors: decode failure 400 (a malformed frame answers its ``frame: ...``
message and ticks ``frame_errors_total{model=}`` beside
``bad_requests_total{model=}``), unknown model or path 404, wrong method 405,
body too large 413, queue full 429 (+ ``Retry-After``), draining 503,
deadline exceeded 504, batch failure 500. Error bodies are
``{"error": ..., "trace_id": ...}``; every predict response carries
``X-Trace-Id``.

Not ported yet (ROADMAP.md queue 1): the router/worker tiers, the circuit
breaker, result cache, fleet scheduler (``:warm``/``:demote``), tenants,
the telemetry and event planes, streaming, parallel ingest loops, the
``/stats`` roofline block and request tracing beyond the trace id.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
import contextlib
import functools
import json
import logging
import math
import os
import signal
import time
from dataclasses import dataclass, field
from http import HTTPStatus
from urllib.parse import parse_qsl, unquote

import torch

from tpuserve_torch import models as modelzoo
from tpuserve_torch import preproc
from tpuserve_torch.batcher import DeadlineExceeded, ModelBatcher, QueueFull
from tpuserve_torch.config import ServerConfig, unported_settings
from tpuserve_torch.faults import FaultInjector
from tpuserve_torch.frame import FrameError
from tpuserve_torch.hostpipe import StageExecutors
from tpuserve_torch.lifecycle import ModelLifecycle, ReloadRejected
from tpuserve_torch.obs import PROMETHEUS_CONTENT_TYPE, Metrics
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.runtime import (ModelRuntime, backend_info, build_runtime,
                                    resolve_device)

log = logging.getLogger("tpuserve_torch.server")

_VERBS = ("predict", "classify", "detect", "generate")
_MAX_BODY = 64 * 1024 * 1024  # the JAX server's client_max_size
_MAX_HEAD = 64 * 1024


@dataclass
class Request:
    method: str
    path: str
    query: dict
    headers: dict  # lower-cased names
    body: bytes = b""
    read_s: float = 0.0  # time spent reading the body off the socket

    @property
    def content_type(self) -> str:
        """The media type without parameters (aiohttp's default when the
        header is absent, so decode sees what the JAX server sees)."""
        raw = self.headers.get("content-type", "")
        return raw.split(";", 1)[0].strip().lower() or "application/octet-stream"


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


def json_response(obj, status: int = 200, headers: dict | None = None) -> Response:
    return Response(status, json.dumps(obj).encode("utf-8"), headers=headers or {})


def _text(status: int) -> Response:
    """aiohttp's plain-text answer for an unrouted path or method."""
    return Response(status, f"{status}: {HTTPStatus(status).phrase}".encode(),
                    content_type="text/plain; charset=utf-8")


def _err(status: int, message: str, retry_after: int | None = None,
         trace_id: str | None = None) -> Response:
    headers: dict[str, str] = {}
    if retry_after:
        headers["Retry-After"] = str(retry_after)
    body = {"error": message}
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


def _reject_unported(cfg: ServerConfig) -> None:
    """Refuse settings the port does not serve yet, instead of silently
    ignoring them."""
    unported = unported_settings(cfg)
    if unported:
        raise NotImplementedError(
            "not yet ported to tpuserve_torch (see ROADMAP.md queue 1): "
            + ", ".join(unported))


class ServerState:
    """Everything a running server owns. ``device`` defaults to the current
    CUDA device; pass ``"cpu"`` to serve on the CPU."""

    def __init__(self, cfg: ServerConfig,
                 device: "str | torch.device | None" = None) -> None:
        _reject_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics = Metrics()
        self.pool = cf.ThreadPoolExecutor(max_workers=cfg.decode_threads,
                                          thread_name_prefix="tpuserve-torch")
        self.stages = StageExecutors(cfg.pipeline, self.metrics)
        self.models: dict[str, object] = {}
        self.runtimes: dict[str, ModelRuntime] = {}
        self.batchers: dict[str, ModelBatcher] = {}
        self.handles: dict[str, ModelHandles] = {}
        # The one accept loop's ingest counters (the JAX server's loop 0).
        self.ingest_requests = self.metrics.counter("ingest_requests_total{loop=0}")
        self.ingest_bytes = self.metrics.counter("ingest_bytes_total{loop=0}")
        self.lifecycles: dict[str, ModelLifecycle] = {}
        self.injector = (FaultInjector(cfg.faults, self.metrics)
                         if cfg.faults.enabled else None)
        self.canary_ok: dict[str, bool] = {}
        self._canary_task: asyncio.Task | None = None
        self.draining = False
        self.serving_addresses: list = []
        # Open client connections (keep-alive ones idle between requests),
        # closed at shutdown so the listener's wait_closed() can return.
        self.connections: set[asyncio.StreamWriter] = set()

    def build(self) -> None:
        """Build every model's runtime: params on the device, buckets warm."""
        for mcfg in self.cfg.models:
            t0 = time.perf_counter()
            model = modelzoo.build(mcfg)
            rt = build_runtime(model, device=self.device, metrics=self.metrics)
            if self.cfg.roofline_probe_iters > 0:
                rt.probe_all_raw(int(self.cfg.roofline_probe_iters))
            # Armed after warm-up and probes: chaos targets the serving path.
            rt.injector = self.injector
            self.models[mcfg.name] = model
            self.runtimes[mcfg.name] = rt
            log.info("model %s ready in %.1fs: %s", mcfg.name,
                     time.perf_counter() - t0, rt.describe())

    async def start(self) -> None:
        preproc.set_native_fallback_hook(self._note_native_fallback)
        for name, model in self.models.items():
            b = ModelBatcher(model, self.runtimes[name], self.metrics,
                             stages=self.stages, pipeline_cfg=self.cfg.pipeline)
            await b.start()
            self.batchers[name] = b
            self.handles[name] = ModelHandles(name, model.cfg, self.metrics)
            self.lifecycles[name] = ModelLifecycle(
                name, self.runtimes[name], model, self.cfg.lifecycle, self.metrics,
                canary=functools.partial(self.run_canary, name),
                canary_status=functools.partial(self.canary_ok.get, name),
                injector=self.injector)
        if self.cfg.startup_canary:
            for name in self.models:
                await self.run_canary(name)
        if self.cfg.canary_interval_s > 0:
            self._canary_task = asyncio.get_running_loop().create_task(self._canary_loop())

    def _note_native_fallback(self, model: str) -> None:
        self.handles[model].native_fallback.inc()

    async def stop(self) -> None:
        for lc in self.lifecycles.values():
            lc.close()  # stop soak monitors
        if self._canary_task is not None:
            self._canary_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._canary_task
            self._canary_task = None
        for b in self.batchers.values():
            await b.stop()
        self.stages.shutdown()
        self.pool.shutdown(wait=False, cancel_futures=True)

    async def _canary_loop(self) -> None:
        """Re-run every model's canary each ``canary_interval_s`` so
        /healthz (and the lifecycle's soak monitor) reflect live serving
        health. Each cycle's timeout is bounded by the interval but never
        below a model's own request_timeout_ms."""
        base = min(60.0, max(2.0, 2.0 * self.cfg.canary_interval_s))
        timeouts = {name: max(base, m.cfg.request_timeout_ms / 1e3)
                    for name, m in self.models.items()}
        while True:
            await asyncio.sleep(self.cfg.canary_interval_s)
            try:
                await asyncio.gather(*(self.run_canary(n, timeout_s=t)
                                       for n, t in timeouts.items()))
            except Exception:  # one bad cycle must not end re-canarying
                log.exception("periodic canary cycle failed")

    async def run_canary(self, name: str, timeout_s: float = 60.0) -> bool:
        """Tiny end-to-end inference through the batcher; feeds /healthz."""
        model = self.models[name]
        try:
            if self.injector is not None:
                self.injector.check("canary_fail", name)
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

    # -- routing -------------------------------------------------------------
    async def handle(self, req: Request) -> Response:
        path = req.path
        if path.startswith("/admin/models/"):
            return await self.admin(req, path[len("/admin/models/"):])
        if path.startswith("/v1/models/") and ":" in path:
            name, _, verb = path[len("/v1/models/"):].rpartition(":")
            if verb in _VERBS and name and "/" not in name:
                if req.method != "POST":
                    resp = _text(405)
                    resp.headers["Allow"] = "POST"
                    return resp
                return await self.predict(req, name)
        routes = {
            "/healthz": ("GET", self.healthz),
            "/metrics": ("GET", self.metrics_text),
            "/stats": ("GET", self.stats),
            "/v1/models": ("GET", self.models_json),
            "/debug/kernels:reset": ("POST", self.reset_kernel_counts),
        }
        route = routes.get(path)
        if route is None:
            return _text(404)
        method, fn = route
        if req.method != method and not (method == "GET" and req.method == "HEAD"):
            resp = _text(405)
            resp.headers["Allow"] = method
            return resp
        return fn()

    async def admin(self, req: Request, rest: str) -> Response:
        """``{name}:reload``, ``{name}:rollback`` (POST) and
        ``{name}/versions`` (GET), with the JAX server's answers."""
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
        if verb == "rollback":
            try:
                return json_response(await lc.rollback(reason="manual"))
            except ValueError as e:
                return _err(409, str(e))
        try:
            info = await lc.reload()
        except ReloadRejected as e:
            body = {"error": str(e), "stage": e.stage, "rolled_back": e.rolled_back,
                    "version": self.runtimes[name].version}
            # Pre-publish rejection: an artifact conflict (409). A
            # post-publish rollback: bad weights were briefly live (500).
            return json_response(body, status=500 if e.rolled_back else 409)
        except Exception as e:  # noqa: BLE001
            log.exception("reload of %s failed", name)
            return _err(500, f"reload failed: {e}")
        return json_response(info)

    def healthz(self) -> Response:
        if self.draining:
            return json_response({"status": "draining", "models": self.canary_ok},
                                 status=503)
        ok = all(self.canary_ok.values()) if self.canary_ok else True
        return json_response({"status": "ok" if ok else "degraded",
                              "models": self.canary_ok}, status=200 if ok else 503)

    def metrics_text(self) -> Response:
        return Response(200, self.metrics.render_prometheus().encode("utf-8"),
                        content_type=PROMETHEUS_CONTENT_TYPE)

    def models_json(self) -> Response:
        return json_response({n: rt.describe() for n, rt in self.runtimes.items()})

    def kernel_counts(self) -> dict:
        return {"flash_attention": {"launches": fa.launches},
                "flash_attention_stats": {"launches": fa.stats_launches}}

    def reset_kernel_counts(self) -> Response:
        fa.reset_launches()
        return json_response({"kernels": self.kernel_counts()})

    def stats(self) -> Response:
        out = self.metrics.summary()
        out["backend"] = backend_info(self.device)
        out["kernels"] = self.kernel_counts()
        out["robustness"] = {"draining": self.draining}
        if self.injector is not None:
            out["robustness"]["faults"] = self.injector.snapshot()
        out["lifecycle"] = {n: lc.describe() for n, lc in self.lifecycles.items()}
        out["ingest"] = {
            "loops": {"0": {"requests": self.ingest_requests.value,
                            "bytes": self.ingest_bytes.value}},
            "frame_errors_total": {n: h.frame_errors.value for n, h in self.handles.items()},
            "native_decode_fallback_total": {
                n: h.native_fallback.value for n, h in self.handles.items()},
        }
        out["pipeline"] = {
            "stages": self.stages.stats(),
            "models": {n: b.pipeline_stats() for n, b in self.batchers.items()},
        }
        return json_response(out)

    async def predict(self, req: Request, name: str) -> Response:
        trace_id = os.urandom(16).hex()
        model = self.models.get(name)
        if model is None:
            return _err(404, f"unknown model {name!r}", trace_id=trace_id)
        if self.draining:
            return _err(503, "server draining; retry against another replica",
                        retry_after=self._retry_after(), trace_id=trace_id)
        h = self.handles[name]
        h.requests.inc()
        t_start = time.perf_counter()
        h.body_read_hist.observe(req.read_s * 1e3)
        self.ingest_requests.inc()
        self.ingest_bytes.inc(len(req.body))
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
            items, batched = await asyncio.get_running_loop().run_in_executor(
                self.pool, model.host_decode_items, req.body, ctype)
            if not items:
                raise ValueError("empty batch")
            h.parse_hist.observe((time.perf_counter() - t_parse) * 1e3)
        except FrameError as e:
            h.frame_errors.inc()
            h.bad_requests.inc()
            return _err(400, str(e), trace_id=trace_id)
        except Exception as e:
            h.bad_requests.inc()
            return _err(400, f"could not decode request: {e}", trace_id=trace_id)

        batcher = self.batchers[name]
        futs: list[asyncio.Future] = []
        try:
            for item in items:
                futs.append(batcher.submit(item, group=model.group_key(item),
                                           deadline_at=deadline_at))
        except QueueFull:
            for f in futs:
                f.cancel()
            return _err(429, "queue full, retry later",
                        retry_after=self._retry_after(), trace_id=trace_id)
        except RuntimeError as e:  # batcher stopped: racing shutdown
            for f in futs:
                f.cancel()
            return _err(503, f"server not accepting requests: {e}", trace_id=trace_id)
        try:
            # The batcher enforces an explicit client deadline at flush time;
            # this timer runs slightly late as the backstop.
            grace = 0.25 if timeout_ms is not None else 0.0
            remaining = max(0.0, deadline_at - time.perf_counter())
            results = await asyncio.wait_for(asyncio.gather(*futs),
                                             timeout=remaining + grace)
        except DeadlineExceeded as e:
            return _err(504, f"deadline_exceeded: {e}", trace_id=trace_id)
        except asyncio.TimeoutError:
            h.timeouts.inc()
            return _err(504, f"request deadline ({timeout_s * 1e3:.0f} ms) exceeded",
                        trace_id=trace_id)
        except Exception as e:
            return _err(500, f"inference failed: {e}", trace_id=trace_id)
        finally:
            for f in futs:
                if not f.done():
                    f.cancel()
        h.total_hist.observe((time.perf_counter() - t_start) * 1e3)
        payload = {"results": list(results)} if batched else results[0]
        return json_response(payload, headers={"X-Trace-Id": trace_id})

    def _retry_after(self) -> int:
        return max(1, math.ceil(self.cfg.shed_retry_after_s))


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
    """One request off the connection: a Request, an error Response to send
    before closing, or None when the peer closed between requests."""
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
    t0 = time.perf_counter()
    body = await reader.readexactly(length) if length else b""
    path, _, qs = target.partition("?")
    req = Request(method=method.upper(), path=unquote(path),
                  query=dict(parse_qsl(qs)), headers=headers, body=body,
                  read_s=time.perf_counter() - t0)
    req.headers[":version"] = version
    return req


def _keep_alive(req: Request) -> bool:
    conn = req.headers.get("connection", "").lower()
    if req.headers.get(":version") == "HTTP/1.0":
        return conn == "keep-alive"
    return conn != "close"


async def _serve_connection(state: ServerState, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
    state.connections.add(writer)
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
            try:
                resp = await state.handle(req)
            except Exception as e:
                log.exception("handler failed for %s %s", req.method, req.path)
                resp = _err(500, f"internal error: {e}")
            keep = _keep_alive(req)
            writer.write(resp.encode(keep_alive=keep))
            await writer.drain()
            if not keep:
                return
    except ConnectionError:
        return  # the client went away mid-response
    finally:
        state.connections.discard(writer)
        writer.close()
        with contextlib.suppress(ConnectionError):
            await writer.wait_closed()


async def start_server(state: ServerState, host: str | None = None,
                       port: int | None = None) -> asyncio.AbstractServer:
    """Start the batchers (and canaries), then listen; ``port=0`` binds an
    ephemeral port, recorded in ``state.serving_addresses``."""
    await state.start()
    server = await asyncio.start_server(
        lambda r, w: _serve_connection(state, r, w),
        host if host is not None else state.cfg.host,
        state.cfg.port if port is None else port, limit=_MAX_HEAD)
    state.serving_addresses = [s.getsockname()[:2] for s in server.sockets]
    return server


async def stop_server(state: ServerState, server: asyncio.AbstractServer) -> None:
    """Stop listening, stop the batchers (queued requests fail, in-flight
    batches finish), then close the client connections still open."""
    state.draining = True
    server.close()
    await state.stop()
    for writer in list(state.connections):
        writer.close()
    await server.wait_closed()


async def serve_async(state: ServerState) -> None:
    """Serve until SIGINT or SIGTERM."""
    server = await start_server(state)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    for host, port in state.serving_addresses:
        log.info("Running on http://%s:%d (device %s)", host, port, state.device)
    try:
        await stop.wait()
    finally:
        await stop_server(state, server)


def serve(cfg: ServerConfig, device: "str | None" = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    state = ServerState(cfg, device=device)
    state.build()
    asyncio.run(serve_async(state))
