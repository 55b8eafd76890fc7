"""Asyncio HTTP load generator, ported from ``tpuserve/bench/loadgen.py``
onto the standard-library client in ``tpuserve_torch.bench.client`` (the
reference drives aiohttp); names, summaries and window accounting are the
reference's.

Two modes:

- **Closed loop** (``run_load``): ``concurrency`` workers each keep exactly
  one request in flight. Measures peak sustainable throughput; its p50 is
  queueing delay by Little's law, NOT server latency.
- **Open loop** (``run_load_open``): requests are issued on a fixed-rate
  clock regardless of completions, like independent clients. Latency
  percentiles at a stated offered rate are the honest latency metric.

Window accounting, both modes: a request is recorded only if it *completes*
inside the measurement window ``[warmup, warmup + duration)``; throughput
divides by the actual window length. In-flight stragglers at window end are
counted separately (``n_late``) and never inflate throughput.

Workload shaping for the result cache: ``payload`` may be a LIST of bodies,
cycled round-robin across issues. A pool of N distinct payloads larger than
the server's cache capacity is a **miss-only** workload (LRU round-robin
thrash: every lookup misses), while the single-payload default is
**hit-heavy** once the cache is warm — ``synthetic_pool`` builds the
distinct bodies, and the CLI exposes it as ``--distinct N``.

Streaming (``--stream``): ``run_stream_load`` parses ``text/event-stream``
answers (``SseParser``) for first-token latency, inter-token gaps and
tokens/s, against the port's engine-served generation and the JAX
package's alike. ``--synthetic prompt`` pools (``synthetic_prompt_pool``) drive the
port's text generation with mixed ``max_new_tokens``.
"""

from __future__ import annotations

import asyncio
import io
import json
import time
from dataclasses import dataclass, field

import numpy as np

from tpuserve_torch.bench.client import ClientSession
from tpuserve_torch.obs import percentile

# Inter-token gap histogram edges (ms). Log-ish spacing: the interesting
# signal is the tail (a prefill stall parks every decoder for one chunk),
# and a fixed ladder keeps pass-over-pass summaries comparable.
GAP_HIST_EDGES_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0)


def gap_histogram(gaps_ms: list[float]) -> dict:
    """Fixed-ladder histogram of inter-token gaps: ``{"<=10": n, ...,
    ">250": n}`` — cheap to eyeball across loadgen passes."""
    counts = [0] * (len(GAP_HIST_EDGES_MS) + 1)
    for g in gaps_ms:
        for i, edge in enumerate(GAP_HIST_EDGES_MS):
            if g <= edge:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    out = {f"<={edge:g}": counts[i]
           for i, edge in enumerate(GAP_HIST_EDGES_MS)}
    out[f">{GAP_HIST_EDGES_MS[-1]:g}"] = counts[-1]
    return out


@dataclass
class LoadResult:
    mode: str = "closed"
    n_ok: int = 0
    n_err: int = 0
    n_late: int = 0  # completed after the window closed (excluded above)
    n_late_err: int = 0  # of those, the ones that failed (not in the summary)
    duration_s: float = 0.0  # actual measurement window
    offered_rate: float = 0.0  # open loop only: requests/s issued
    # Client-side batching: each POST carries this many items (the server's
    # {"results": [...]} shape). Throughput counts ITEMS; latencies are still
    # whole-request (the time to answer all items in the POST).
    items_per_request: int = 1
    # Size of the distinct-payload pool cycled by the run (0 = one payload).
    distinct_payloads: int = 0
    latencies_ms: list[float] = field(default_factory=list)

    @property
    def throughput(self) -> float:
        if self.duration_s <= 0:
            return 0.0
        return self.n_ok * self.items_per_request / self.duration_s

    def summary(self) -> dict:
        out = {
            "mode": self.mode,
            "n_ok": self.n_ok,
            "n_err": self.n_err,
            "n_late": self.n_late,
            "duration_s": round(self.duration_s, 3),
            "throughput_per_s": round(self.throughput, 1),
            "p50_ms": round(percentile(self.latencies_ms, 0.5), 3),
            "p90_ms": round(percentile(self.latencies_ms, 0.9), 3),
            "p99_ms": round(percentile(self.latencies_ms, 0.99), 3),
        }
        if self.items_per_request != 1:
            out["items_per_request"] = self.items_per_request
        if self.distinct_payloads:
            out["distinct_payloads"] = self.distinct_payloads
        if self.mode == "open":
            out["offered_rate_per_s"] = round(self.offered_rate, 1)
        return out


@dataclass
class StreamLoadResult:
    """Closed-loop STREAMING load : per-stream first-token
    latency, inter-token gaps, and exact tokens/s measured from token
    EVENT arrival timestamps — not from request completions, which for a
    stream only say when the last byte landed."""

    mode: str = "stream-closed"
    n_ok: int = 0       # terminal "done" inside the window
    n_err: int = 0      # plain status, "error" terminal, or torn stream
    n_late: int = 0
    duration_s: float = 0.0
    distinct_payloads: int = 0
    tokens: int = 0     # token events that ARRIVED inside the window
    torn: int = 0       # streams ending with no terminal (must be 0)
    terminals: dict = field(default_factory=dict)
    first_token_ms: list[float] = field(default_factory=list)
    gap_ms: list[float] = field(default_factory=list)

    def summary(self) -> dict:
        out = {
            "mode": self.mode,
            "n_ok": self.n_ok,
            "n_err": self.n_err,
            "n_late": self.n_late,
            "duration_s": round(self.duration_s, 3),
            "streams_per_s": round(self.n_ok / self.duration_s, 2)
            if self.duration_s > 0 else 0.0,
            "tokens_per_s": round(self.tokens / self.duration_s, 1)
            if self.duration_s > 0 else 0.0,
            "first_token_p50_ms": round(
                percentile(self.first_token_ms, 0.5), 3),
            "first_token_p99_ms": round(
                percentile(self.first_token_ms, 0.99), 3),
            "inter_token_gap_p50_ms": round(percentile(self.gap_ms, 0.5), 3),
            "inter_token_gap_p99_ms": round(percentile(self.gap_ms, 0.99), 3),
            "inter_token_gap_max_ms": round(max(self.gap_ms), 3)
            if self.gap_ms else 0.0,
            "inter_token_gap_hist_ms": gap_histogram(self.gap_ms),
            "terminals": dict(self.terminals),
            "torn_streams": self.torn,
        }
        if self.distinct_payloads:
            out["distinct_payloads"] = self.distinct_payloads
        return out


class SseParser:
    """Incremental ``text/event-stream`` parser.

    feed() returns complete ``(event, data_text)`` pairs; comment lines
    (the server's ``: hb`` heartbeats) are dropped. Deliberately tolerant
    of a TORN event glued to a later complete one (a worker SIGKILLed
    mid-write, then the router's appended error terminal): each ``event:``
    line starts a fresh pair, so the partial pair surfaces as undecodable
    data for the caller to count — never as a swallowed terminal."""

    def __init__(self) -> None:
        self._buf = b""

    @property
    def pending(self) -> int:
        """Bytes of an incomplete event still buffered (torn-tail audit)."""
        return len(self._buf)

    def feed(self, chunk: bytes) -> list[tuple[str, str]]:
        self._buf += chunk
        out: list[tuple[str, str]] = []
        while b"\n\n" in self._buf:
            block, self._buf = self._buf.split(b"\n\n", 1)
            event: str | None = None
            data: list[bytes] = []
            for line in block.split(b"\n"):
                if line.startswith(b":"):
                    continue  # heartbeat / comment
                if line.startswith(b"event:"):
                    if event is not None:
                        out.append((event, b"\n".join(data).decode(
                            "utf-8", "replace")))
                        data = []
                    event = line[6:].strip().decode("utf-8", "replace")
                elif line.startswith(b"data:"):
                    data.append(line[5:].strip())
            if event is not None:
                out.append((event,
                            b"\n".join(data).decode("utf-8", "replace")))
        return out


async def stream_generate(session, url: str, data: bytes, headers: dict,
                          total_timeout_s: float = 120.0) -> dict:
    """POST one ``?stream=true`` generation and consume the SSE stream to
    EOF. Returns the full per-stream record the drill's byte-audit needs:
    concatenated token text, token indices and arrival times
    (perf_counter), the terminal ("done"/"error"/None), and ``torn`` —
    True when the stream ended with NO terminal event, which is exactly
    the silent truncation the streaming contract forbids."""
    rec: dict = {"status": None, "terminal": None, "finish_reason": None,
                 "error": None, "usage": None, "text": "", "indices": [],
                 "token_times": [], "junk": 0, "torn": False,
                 "first_token_ms": None}
    sep = "&" if "?" in url else "?"
    t0 = time.perf_counter()
    try:
        async with session.stream(
                "POST", f"{url}{sep}stream=true", data=data, headers=headers,
                timeout_s=total_timeout_s) as r:
            rec["status"] = r.status
            if r.status != 200 \
                    or r.headers.get("x-tpuserve-stream") != "1":
                await r.read()  # plain (pre-first-unit) answer: no stream
                return rec
            parser = SseParser()
            async for chunk in r.iter_any():
                for event, text in parser.feed(chunk):
                    try:
                        obj = json.loads(text) if text else {}
                    except ValueError:
                        rec["junk"] += 1  # torn event (worker died mid-write)
                        continue
                    if event == "token":
                        now = time.perf_counter()
                        if rec["first_token_ms"] is None:
                            rec["first_token_ms"] = (now - t0) * 1e3
                        rec["token_times"].append(now)
                        rec["text"] += obj.get("text", "")
                        rec["indices"].append(obj.get("index"))
                    elif event == "done":
                        rec["terminal"] = "done"
                        rec["finish_reason"] = obj.get("finish_reason")
                        rec["usage"] = obj.get("usage")
                    elif event == "error":
                        rec["terminal"] = "error"
                        rec["error"] = obj.get("error")
            if rec["terminal"] is None:
                rec["torn"] = True  # EOF, no terminal: silent truncation
            rec["junk"] += 1 if parser.pending else 0
    except asyncio.CancelledError:
        raise
    except Exception:  # noqa: BLE001 — transport failure mid-stream
        if rec["status"] == 200:
            rec["torn"] = rec["terminal"] is None
        elif rec["status"] is None:
            rec["status"] = -1  # connect-level failure, never admitted
    return rec


async def run_stream_load(
    url: str,
    payload: "bytes | list[bytes]",
    content_type: str,
    duration_s: float = 10.0,
    concurrency: int = 8,
    warmup_s: float = 2.0,
) -> StreamLoadResult:
    """Closed-loop streaming mode (``bench --stream``): ``concurrency``
    workers each keep one STREAM in flight, parsing token events as they
    arrive. First-token latency and inter-token gaps come from event
    timestamps; tokens/s counts token arrivals inside the window — the
    exact generation rate, not an average smeared over request lifetimes."""
    pool = payload if isinstance(payload, (list, tuple)) else None
    result = StreamLoadResult(distinct_payloads=len(pool) if pool else 0)
    headers = {"Content-Type": content_type}
    now = time.perf_counter()
    record_from = now + warmup_s
    stop_at = now + warmup_s + duration_s
    cursor = 0

    async def worker(session) -> None:
        nonlocal cursor
        while time.perf_counter() < stop_at:
            if pool is not None:
                data = pool[cursor % len(pool)]
                cursor += 1
            else:
                data = payload
            rec = await stream_generate(session, url, data, headers)
            # Token arrivals count toward tokens/s regardless of how the
            # stream ended — delivered tokens are delivered work.
            result.tokens += sum(1 for t in rec["token_times"]
                                 if record_from <= t < stop_at)
            t1 = time.perf_counter()
            if t1 < record_from:
                continue
            if t1 >= stop_at:
                result.n_late += 1
                continue
            term = rec["terminal"] or ("torn" if rec["torn"] else "none")
            result.terminals[term] = result.terminals.get(term, 0) + 1
            if rec["torn"]:
                result.torn += 1
            if rec["terminal"] == "done":
                result.n_ok += 1
                if rec["first_token_ms"] is not None:
                    result.first_token_ms.append(rec["first_token_ms"])
                times = rec["token_times"]
                result.gap_ms.extend(
                    (b - a) * 1e3 for a, b in zip(times, times[1:]))
            else:
                result.n_err += 1

    async with ClientSession(limit=concurrency * 2) as session:
        await asyncio.gather(*(asyncio.ensure_future(worker(session))
                               for _ in range(concurrency)))
    result.duration_s = stop_at - record_from
    return result


def closed_loop_concurrency(buckets: list[int], n_chips: int = 1,
                            per_chip_cap: int = 384) -> int:
    """Loadgen connection count for a closed-loop bench run.

    Per chip, keep ~3 top-bucket batches of demand in flight (one
    computing, one in transfer, one assembling — the pipeline's natural
    occupancy), floored at 32 connections and capped at ``per_chip_cap``.
    Scaling by ``n_chips`` is the point: a closed loop
    sized for one chip offers exactly one chip's worth of demand, so an
    8-chip mesh idles 7 chips and the bench under-reports by design."""
    n = max(1, n_chips)
    top = max(buckets) if buckets else 0
    return min(per_chip_cap * n, max(32, 3 * top * n))


def synthetic_image_npy(edge: int = 256, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (edge, edge, 3), dtype=np.uint8)
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def synthetic_image_npy_batch(edge: int = 256, n: int = 8, seed: int = 0) -> bytes:
    """(n, edge, edge, 3) uint8 npy body: one POST carrying a client batch."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (n, edge, edge, 3), dtype=np.uint8)
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def synthetic_pool(kind: str, n: int, edge: int = 256,
                   batch: int = 0, seed_base: int = 0) -> list[bytes]:
    """``n`` distinct synthetic payloads (seeds seed_base..seed_base+n-1)
    for miss-only workloads: every body decodes to different pixels, so
    every request is a new cache key. ``kind`` is "jpeg" or "npy";
    ``batch > 1`` builds (batch, edge, edge, 3) npy client batches
    instead. ``seed_base`` gives multi-process load workers disjoint pools
    — two workers cycling the SAME pool would coalesce in the server's
    single-flight layer and share batch slots, inflating a miss-only
    measurement."""
    if batch > 1:
        return [synthetic_image_npy_batch(edge, batch, seed=seed_base + i)
                for i in range(n)]
    gen = synthetic_image_jpeg if kind == "jpeg" else synthetic_image_npy
    return [gen(edge, seed=seed_base + i) for i in range(n)]


def synthetic_frame(edge: int = 256, n_items: int = 8, kind: str = "yuv420",
                    seed: int = 0) -> bytes:
    """One ``application/x-tpuserve-frame`` body of ``n_items`` distinct
    random images (``tpuserve_torch.frame``): the framed-wire client batch. yuv420
    frames carry exactly the planes ``rgb_to_yuv420`` would produce from
    the equivalent npy body, so framed and npy loads are answer-identical
    (tests/test_frame.py pins it byte-for-byte)."""
    from tpuserve_torch import frame, preproc

    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n_items):
        rgb = rng.integers(0, 255, (edge, edge, 3), dtype=np.uint8)
        items.append(preproc.rgb_to_yuv420(rgb) if kind == "yuv420" else rgb)
    return frame.encode_frame(items, frame.KIND_BY_WIRE_FORMAT[kind], edge)


def synthetic_frame_pool(n: int, edge: int = 256, n_items: int = 8,
                         kind: str = "yuv420",
                         seed_base: int = 0) -> list[bytes]:
    """``n`` distinct framed bodies (each of ``n_items`` images) — the
    framed-wire miss-only pool (``--wire frame --distinct N``)."""
    return [synthetic_frame(edge, n_items, kind, seed=seed_base + i)
            for i in range(n)]


def synthetic_prompt_pool(n: int, max_new: tuple[int, int] = (2, 32),
                          sd: bool = False, seed: int = 0,
                          long_every: int = 0,
                          long_words: int = 16) -> list[bytes]:
    """``n`` distinct JSON prompt bodies for the generative families.

    Every body carries a distinct (prompt, seed) pair — the generative
    cache-key contract means no two of them can alias — and, for textgen
    (``sd=False``), a ``max_new_tokens`` drawn across ``[lo, hi]`` so the
    offered load has MIXED output lengths. Mixed lengths are the point:
    a locked batch runs every lane for its longest member, so
    the iteration-level engine's early-exit gain is only visible when
    short and long completions share a batch. SD bodies (``sd=True``) omit
    the length knob (fixed denoise steps) and vary prompt + seed only.

    ``long_every`` > 0 SKEWS the pool: every long_every-th body
    carries a ``long_words``-word prompt (a max-length prefill for the
    default textgen bench geometry) at the top of the max_new range — the
    workload that exposes prefill stalls and KV-footprint ceilings that a
    uniformly short pool never touches."""
    rng = np.random.default_rng(seed)
    words = ("fast serve model token image chip batch fox sky ocean "
             "mountain river night day glass stone").split()
    lo, hi = max_new
    if not sd and (lo < 1 or hi < lo):
        raise ValueError(f"max_new range must satisfy 1 <= lo <= hi, "
                         f"got {max_new}")
    out = []
    for i in range(n):
        is_long = long_every > 0 and i % long_every == long_every - 1
        size = long_words if is_long else int(rng.integers(2, 8))
        prompt = " ".join(rng.choice(words, size=size))
        body: dict = {"prompt": prompt, "seed": i}
        if not sd:
            # Deterministic spread over [lo, hi]: short and long lengths
            # interleave however the pool is cycled.
            body["max_new_tokens"] = hi if is_long else int(
                lo + (i * 7919) % (hi - lo + 1))
        out.append(json.dumps(body).encode())
    return out


def synthetic_image_jpeg(edge: int = 256, seed: int = 0, quality: int = 85) -> bytes:
    """A realistic photo-like JPEG (smooth gradients compress like photos).
    Needs PIL, imported here only; without it this raises RuntimeError."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("synthetic JPEG payloads need PIL (Pillow), which is not "
                           "installed; use --synthetic npy or --wire frame") from e

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:edge, 0:edge].astype(np.float32) / edge
    base = np.stack([
        0.5 + 0.5 * np.sin(6.28 * (x + rng.random())),
        0.5 + 0.5 * np.cos(6.28 * (y + rng.random())),
        0.5 + 0.5 * np.sin(6.28 * (x * y + rng.random())),
    ], axis=-1)
    noise = rng.normal(0, 0.05, base.shape)
    arr = np.clip((base + noise) * 255, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _record(result: LoadResult, ok: bool, t0: float, t1: float,
            record_from: float, stop_at: float) -> None:
    """Window-clamp one completion: only [record_from, stop_at) counts."""
    if t1 < record_from:
        return  # warmup
    if t1 >= stop_at:
        result.n_late += 1
        result.n_late_err += not ok
        return
    if ok:
        result.n_ok += 1
        result.latencies_ms.append((t1 - t0) * 1e3)
    else:
        result.n_err += 1


async def run_load(
    url: str,
    payload: "bytes | list[bytes]",
    content_type: str,
    duration_s: float = 10.0,
    concurrency: int = 64,
    warmup_s: float = 2.0,
    items_per_request: int = 1,
) -> LoadResult:
    """Closed loop: `concurrency` workers, one request in flight each.
    A list ``payload`` is a distinct-body pool cycled round-robin across
    the workers (miss-only cache workloads)."""
    pool = payload if isinstance(payload, (list, tuple)) else None
    result = LoadResult(mode="closed", items_per_request=items_per_request,
                        distinct_payloads=len(pool) if pool else 0)
    headers = {"Content-Type": content_type}
    now = time.perf_counter()
    record_from = now + warmup_s
    stop_at = now + warmup_s + duration_s
    cursor = 0  # shared round-robin index over the distinct-payload pool

    async def worker(session: ClientSession) -> None:
        nonlocal cursor
        while time.perf_counter() < stop_at:
            if pool is not None:
                data = pool[cursor % len(pool)]
                cursor += 1
            else:
                data = payload
            t0 = time.perf_counter()
            try:
                ok = (await session.post(url, data, headers)).status == 200
            except Exception:
                ok = False
            _record(result, ok, t0, time.perf_counter(), record_from, stop_at)

    async with ClientSession(limit=concurrency * 2) as session:
        workers = [asyncio.ensure_future(worker(session)) for _ in range(concurrency)]
        await asyncio.gather(*workers)
    result.duration_s = stop_at - record_from
    return result


async def run_load_open(
    url: str,
    payload: "bytes | list[bytes]",
    content_type: str,
    rate_per_s: float,
    duration_s: float = 10.0,
    warmup_s: float = 2.0,
    max_inflight: int = 4096,
    items_per_request: int = 1,
) -> LoadResult:
    """Open loop: issue at `rate_per_s` on a fixed clock, independent of
    completions. If the server can't keep up, in-flight grows toward
    ``max_inflight``; beyond it issues are dropped and counted as errors
    (the alternative — silently pausing the clock — would turn the mode
    closed-loop and overstate the server). A list ``payload`` cycles a
    distinct-body pool as in run_load."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be positive, got {rate_per_s}")
    pool = payload if isinstance(payload, (list, tuple)) else None
    result = LoadResult(mode="open", offered_rate=rate_per_s,
                        items_per_request=items_per_request,
                        distinct_payloads=len(pool) if pool else 0)
    headers = {"Content-Type": content_type}
    interval = 1.0 / rate_per_s
    now = time.perf_counter()
    record_from = now + warmup_s
    stop_at = now + warmup_s + duration_s
    inflight = 0
    issued = 0
    tasks: set[asyncio.Task] = set()

    async def one(session: ClientSession, seq: int) -> None:
        nonlocal inflight
        data = pool[seq % len(pool)] if pool is not None else payload
        t0 = time.perf_counter()
        try:
            ok = (await session.post(url, data, headers)).status == 200
        except Exception:
            ok = False
        finally:
            inflight -= 1
        _record(result, ok, t0, time.perf_counter(), record_from, stop_at)

    # Open loop: no client-side cap on connections.
    async with ClientSession(limit=0) as session:
        next_issue = now
        while next_issue < stop_at:
            delay = next_issue - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            if inflight >= max_inflight:
                if time.perf_counter() >= record_from:
                    result.n_err += 1  # shed at the client: server saturated
            else:
                inflight += 1
                t = asyncio.ensure_future(one(session, issued))
                issued += 1
                tasks.add(t)
                t.add_done_callback(tasks.discard)
            next_issue += interval
        if tasks:  # stragglers: counted as n_late by _record
            await asyncio.gather(*tasks, return_exceptions=True)
    result.duration_s = stop_at - record_from
    return result


def merge_load_summaries(parts: list[dict]) -> dict:
    """Combine per-worker load results into one summary (multi-process
    load generation).

    Each part is a worker's ``{"summary": ..., "latencies_ms": [...]}``
    dump. Counts sum; throughput sums (every worker measured its own
    aligned window); percentiles are EXACT over the concatenated latency
    samples — merging percentile-of-percentiles would lie about the tail."""
    if not parts:
        raise ValueError("no load-worker results to merge")
    lats: list[float] = []
    for p in parts:
        lats.extend(p.get("latencies_ms", []))
    summaries = [p["summary"] for p in parts]
    base = summaries[0]
    out = {
        "mode": base["mode"],
        "n_ok": sum(s["n_ok"] for s in summaries),
        "n_err": sum(s["n_err"] for s in summaries),
        "n_late": sum(s["n_late"] for s in summaries),
        "duration_s": max(s["duration_s"] for s in summaries),
        "throughput_per_s": round(
            sum(s["throughput_per_s"] for s in summaries), 1),
        "p50_ms": round(percentile(lats, 0.5), 3),
        "p90_ms": round(percentile(lats, 0.9), 3),
        "p99_ms": round(percentile(lats, 0.99), 3),
        "load_workers": len(parts),
    }
    for key in ("items_per_request", "distinct_payloads",
                "offered_rate_per_s"):
        if key in base:
            out[key] = base[key]
    return out


def _run_loadgen_multiproc(args, procs: int) -> int:
    """Fan the load out over ``procs`` worker processes and merge.

    One asyncio client process tops out around one core of HTTP work —
    against an 8-chip server THAT becomes the bottleneck and the bench
    under-reports the server. Workers split the
    connection count (and open-loop rate) evenly, take DISJOINT synthetic
    seed ranges (coalescing two workers' identical bodies would share
    batch slots), and dump raw latencies for an exact merged summary."""
    import os
    import subprocess
    import sys
    import tempfile

    batch = int(getattr(args, "batch", 0) or 0)
    distinct = int(getattr(args, "distinct", 0) or 0)
    seed_base = int(getattr(args, "seed_base", 0) or 0)
    rate = getattr(args, "rate", None)
    conc = max(1, args.concurrency)
    tmpdir = tempfile.mkdtemp(prefix="tpuserve-torch-loadgen-")
    workers = []
    dumps = []
    for i in range(procs):
        c_i = conc // procs + (1 if i < conc % procs else 0)
        if c_i <= 0:
            continue
        dump = os.path.join(tmpdir, f"worker{i}.json")
        dumps.append(dump)
        argv = [
            sys.executable, "-m", "tpuserve_torch", "bench",
            "--url", args.url, "--model", args.model, "--verb", args.verb,
            "--duration", str(args.duration),
            "--warmup", str(getattr(args, "warmup", 2.0)),
            "--concurrency", str(c_i),
            "--content-type", args.content_type,
            "--synthetic", getattr(args, "synthetic", "npy"),
            "--edge", str(getattr(args, "edge", 256)),
            "--wire", getattr(args, "wire", "npy"),
            "--frame-kind", getattr(args, "frame_kind", "yuv420"),
            "--max-new", str(getattr(args, "max_new", "2,32")),
            "--procs", "1",
            "--seed-base", str(seed_base + i * max(1, distinct)),
            "--dump-latencies", dump,
        ]
        if batch:
            argv += ["--batch", str(batch)]
        if distinct:
            argv += ["--distinct", str(distinct)]
        if getattr(args, "payload", None):
            argv += ["--payload", args.payload]
        if rate:
            argv += ["--rate", str(rate / procs)]
        workers.append(subprocess.Popen(argv, stdout=subprocess.DEVNULL))
    rcs = [w.wait() for w in workers]
    parts = []
    for dump in dumps:
        try:
            with open(dump, encoding="utf-8") as f:
                parts.append(json.load(f))
        except OSError:
            pass  # a crashed worker: its rc already marks the failure
    if not parts:
        print(json.dumps({"error": "every load worker failed",
                          "worker_rcs": rcs}))
        return 1
    merged = merge_load_summaries(parts)
    print(json.dumps(merged))
    return 0 if merged["n_ok"] > 0 and all(rc == 0 for rc in rcs) else 1


def run_loadgen_cli(args) -> int:
    procs = int(getattr(args, "procs", 1) or 1)
    if procs > 1:
        return _run_loadgen_multiproc(args, procs)
    batch = int(getattr(args, "batch", 0) or 0)
    distinct = int(getattr(args, "distinct", 0) or 0)
    seed_base = int(getattr(args, "seed_base", 0) or 0)
    synth = getattr(args, "synthetic", "npy")
    wire = getattr(args, "wire", "npy")
    content_type = args.content_type
    if wire == "frame":
        # Framed-wire client batches: each POST is one
        # multi-item application/x-tpuserve-frame body of --batch items
        # (throughput counts items); --distinct cycles a disjoint-seed
        # pool of framed bodies for miss-only workloads.
        from tpuserve_torch import frame

        kind = getattr(args, "frame_kind", "yuv420")
        edge = int(getattr(args, "edge", 256))
        n_items = max(1, batch)
        content_type = frame.CONTENT_TYPE
        if distinct > 1:
            payload = synthetic_frame_pool(distinct, edge, n_items, kind,
                                           seed_base=seed_base)
        else:
            payload = synthetic_frame(edge, n_items, kind, seed=seed_base)
        batch = n_items
    elif distinct > 1 and synth in ("prompt", "sd-prompt"):
        # Generative workload: distinct (prompt, seed) bodies, mixed
        # max_new_tokens for textgen (the engine's early-exit/fold-in
        # counters only move when output lengths mix).
        lo, hi = (int(x) for x in
                  str(getattr(args, "max_new", "2,32")).split(","))
        payload = synthetic_prompt_pool(
            distinct, (lo, hi), sd=synth == "sd-prompt",
            long_every=int(getattr(args, "long_every", 0) or 0),
            long_words=int(getattr(args, "long_words", 16) or 16))
    elif distinct > 1:
        # Miss-only workload: a pool of distinct synthetic bodies, cycled
        # round-robin (a pool larger than the server's cache capacity makes
        # every lookup an LRU miss).
        payload = synthetic_pool(synth, distinct,
                                 int(getattr(args, "edge", 256)), batch,
                                 seed_base=seed_base)
    elif args.payload:
        with open(args.payload, "rb") as f:
            payload = f.read()
    elif batch > 1:
        payload = synthetic_image_npy_batch(n=batch)
    else:
        payload = synthetic_image_npy()
    items = max(1, batch)
    url = f"{args.url}/v1/models/{args.model}:{args.verb}"
    warmup = getattr(args, "warmup", 2.0)
    rate = getattr(args, "rate", None)
    if getattr(args, "stream", False):
        # Streaming closed loop: one stream in flight per
        # worker; --rate/--procs don't apply (event timestamps, not
        # request completions, are the measurement).
        result = asyncio.run(run_stream_load(
            url, payload, content_type, args.duration, args.concurrency,
            warmup))
        print(json.dumps(result.summary()))
        return 0 if result.n_ok > 0 else 1
    if rate:
        result = asyncio.run(run_load_open(
            url, payload, content_type, rate, args.duration, warmup,
            items_per_request=items))
    else:
        result = asyncio.run(run_load(
            url, payload, content_type, args.duration, args.concurrency,
            warmup, items_per_request=items))
    dump = getattr(args, "dump_latencies", None)
    if dump:
        # Raw samples for the multi-process merge (exact percentiles).
        with open(dump, "w", encoding="utf-8") as f:
            json.dump({"summary": result.summary(),
                       "latencies_ms": result.latencies_ms}, f)
    print(json.dumps(result.summary()))
    return 0 if result.n_ok > 0 else 1
