"""Content-addressed result cache + single-flight coalescing, ported from
``tpuserve/cache.py``. It sits between the predict handler and the batcher:

- **Content addressing** — key = (live model version, digest of the decoded
  item). Two byte-identical uploads hash to the same key whichever
  connection carried them; the value is the postprocessed JSON-able result,
  so a hit skips everything from batching to the result.
- **Version binding** — the live version (``ModelRuntime.version``) is part
  of every key, so a lifecycle publish or rollback invalidates every older
  entry with no sweep: lookups under the new version never build an old
  key. A flight that completes after a mid-flight version change is
  dropped instead of cached (``cache_stale_drops_total``); its waiters
  still get the result.
- **Single-flight coalescing** — N concurrent identical misses occupy ONE
  batch slot: the first leads and submits to the batcher, the rest wait on
  the leader's completion (``cache_coalesced_total``). A failed leader
  (poison bisection included) fans its error out and populates nothing.
  With trace contexts, each joining waiter records a ``coalesced`` span
  whose ``linked_trace`` names the leader's trace.
- **Honest accounting** — hits, misses and coalesced waiters are disjoint
  counters, so cache traffic never reads as model throughput.

Threading: every method runs on the server's main event loop (the predict
handler and future done-callbacks); there is no lock. The reference's
per-tenant capacity shares wait for ``[tenants]`` (ROADMAP.md queue 1,
item 11), which the port refuses.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np

from tpuserve_torch.config import CacheConfig
from tpuserve_torch.obs import CACHE_EVENTS, Metrics


def item_digest(item: Any) -> str:
    """Stable content digest of one decoded request item (np arrays, tuples
    of planes, text dicts, scalars). Dtype and shape are part of the digest,
    so a (64,) uint8 never collides with an (8, 8) uint8 of the same bytes."""
    h = hashlib.blake2b(digest_size=16)
    _feed(h, item)
    return h.hexdigest()


def _feed(h: "hashlib._Hash", obj: Any) -> None:
    if isinstance(obj, np.ndarray):
        h.update(b"a")
        h.update(obj.dtype.str.encode())
        h.update(repr(obj.shape).encode())
        h.update(obj.tobytes())  # C-order copy when non-contiguous
    elif isinstance(obj, (tuple, list)):
        h.update(b"t" if isinstance(obj, tuple) else b"l")
        h.update(str(len(obj)).encode())
        for el in obj:
            _feed(h, el)
    elif isinstance(obj, dict):
        h.update(b"d")
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _feed(h, obj[k])
    elif isinstance(obj, bytes):
        h.update(b"b")
        h.update(obj)
    else:  # str / int / float / bool / None / np scalars
        h.update(b"s")
        h.update(repr(obj).encode())


@dataclass
class CacheEntry:
    """One cached result. ``body`` is the serialized JSON response for the
    single-item hit path (None for non-JSON or oversized values)."""

    value: Any
    body: bytes | None
    at: float  # time.monotonic() at population


@dataclass
class _Flight:
    """One in-flight miss: the leader's submission plus everyone waiting."""

    key: str
    version: int
    waiters: list[asyncio.Future]
    # The leader's trace id, named by every coalesced waiter's link span.
    leader_trace: str | None = None


class ModelCache:
    """Per-model result cache + single-flight front of the batcher."""

    def __init__(self, name: str, cfg: CacheConfig, metrics: Metrics,
                 version_fn: Callable[[], int]) -> None:
        self.name = name
        self.cfg = cfg
        self._version_fn = version_fn
        self._entries: dict[str, CacheEntry] = {}  # dicts iterate in LRU order
        self._flights: dict[str, _Flight] = {}
        c = {ev: metrics.cache_counter(name, ev) for ev in CACHE_EVENTS}
        self._c_hits = c["hits"]
        self._c_misses = c["misses"]
        self._c_coalesced = c["coalesced"]
        self._c_evictions = c["evictions"]
        self._c_stale = c["stale_drops"]
        self._g_entries = metrics.gauge(f"cache_entries{{model={name}}}")

    # -- lookup ---------------------------------------------------------------
    def key_for(self, item: Any) -> str:
        return f"{self._version_fn()}:{item_digest(item)}"

    def get(self, key: str) -> CacheEntry | None:
        """Return the live entry for ``key`` (counting a hit) or None."""
        e = self._entries.get(key)
        if e is None:
            return None
        if self.cfg.ttl_s > 0 and time.monotonic() - e.at > self.cfg.ttl_s:
            del self._entries[key]
            self._g_entries.set(len(self._entries))
            return None
        # LRU touch: move to the end of the dict's insertion order.
        del self._entries[key]
        self._entries[key] = e
        self._c_hits.inc()
        return e

    def put(self, key: str, value: Any) -> None:
        body = None
        if isinstance(value, (dict, list)):
            try:
                raw = json.dumps(value).encode()
                if len(raw) <= self.cfg.max_body_bytes:
                    body = raw
            except (TypeError, ValueError):
                body = None  # non-JSON-able results cache by value only
        self._entries.pop(key, None)
        self._entries[key] = CacheEntry(value, body, time.monotonic())
        while len(self._entries) > self.cfg.capacity:
            del self._entries[next(iter(self._entries))]
            self._c_evictions.inc()
        self._g_entries.set(len(self._entries))

    # -- single-flight --------------------------------------------------------
    def submit_through(self, key: str, submit: Callable[[], asyncio.Future],
                       ctx: Any = None) -> asyncio.Future:
        """Miss path: join the in-flight computation for ``key`` or lead a
        new one by calling ``submit()`` (which may raise, e.g. QueueFull —
        propagated to the caller with nothing registered).

        Returns a per-caller waiter future. Cancelling a waiter (client
        disconnect, HTTP timeout) never cancels the batch slot or the other
        waiters; the flight still completes and populates. ``ctx``
        (obs.TraceContext) makes coalescing traceable: the leader's trace id
        is kept on the flight and each joining waiter records a
        ``coalesced`` span naming it."""
        loop = asyncio.get_running_loop()
        if self.cfg.coalesce:
            fl = self._flights.get(key)
            if fl is not None:
                w = loop.create_future()
                fl.waiters.append(w)
                self._c_coalesced.inc()
                if ctx is not None:
                    now = time.time()
                    ctx.span("coalesced", now, now, tid=self.name,
                             linked_trace=fl.leader_trace)
                return w
        base = submit()
        self._c_misses.inc()
        fl = _Flight(key=key, version=self._version_fn(), waiters=[],
                     leader_trace=ctx.trace_id if ctx is not None else None)
        if self.cfg.coalesce:
            self._flights[key] = fl
        w = loop.create_future()
        fl.waiters.append(w)
        base.add_done_callback(lambda f: self._settle(fl, f))
        return w

    def _settle(self, fl: _Flight, base: asyncio.Future) -> None:
        if self._flights.get(fl.key) is fl:
            del self._flights[fl.key]
        if base.cancelled():
            for w in fl.waiters:
                if not w.done():
                    w.cancel()
            return
        exc = base.exception()
        if exc is not None:
            # Failed batches (poison-split leftovers included) populate NOTHING.
            for w in fl.waiters:
                if not w.done():
                    w.set_exception(exc)
            return
        val = base.result()
        if self._version_fn() == fl.version:
            self.put(fl.key, val)
        else:
            # Publish or rollback mid-flight: the result was admitted under
            # a version no longer live. Waiters still get it (as an uncached
            # request spanning the publish would), but no later lookup may.
            self._c_stale.inc()
        for w in fl.waiters:
            if not w.done():
                w.set_result(val)

    def clear(self) -> None:
        """Drop every entry (the router's fleet-wide reload invalidation)."""
        self._entries.clear()
        self._g_entries.set(0)

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        """The /stats "cache" block entry for this model."""
        return {
            "entries": len(self._entries),
            "capacity": self.cfg.capacity,
            "inflight": len(self._flights),
            "hits": self._c_hits.value,
            "misses": self._c_misses.value,
            "coalesced": self._c_coalesced.value,
            "evictions": self._c_evictions.value,
            "stale_drops": self._c_stale.value,
        }


def hit_rate(counters: dict[str, float]) -> float | None:
    """hits / (hits + misses + coalesced) from a counter snapshot or delta;
    None when no cacheable traffic was seen."""
    total = sum(counters.get(k, 0.0) for k in ("hits", "misses", "coalesced"))
    if total <= 0:
        return None
    return counters.get("hits", 0.0) / total


def counter_snapshot(metrics: Metrics, model: str,
                     events: Iterable[str] = ("hits", "misses",
                                              "coalesced")) -> dict[str, float]:
    """Current cache counter values for ``model``."""
    return {ev: metrics.cache_counter(model, ev).value for ev in events}
