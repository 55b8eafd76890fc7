"""Versioned model lifecycle: staged, reversible weight transitions, ported
from ``tpuserve/lifecycle.py``.

``ModelLifecycle`` turns ``POST /admin/models/{name}:reload`` into a gated
pipeline, every step of which keeps the old version serving on failure:

1. **stage** — load the candidate off the serving path; verify the sidecar
   checksum manifest (``savedmodel.write_manifest``), scan for NaN/Inf, and
   match structure, shapes and dtypes against the slots; then copy it into
   a free parameter slot (``ModelRuntime.stage_params``).
2. **staged canary** — run the model's canary item through the staged
   slot's captured graphs (``params_override``); for a model served by the
   generation engine, a short generation through the engine's programs on
   its scratch state block (``GenEngine.staged_canary_sync``). A regressed
   candidate never serves one request.
3. **publish** — switch the live slot under the runtime's reload lock; the
   candidate becomes numbered version N and version N-1 stays resident in
   its slot as last-known-good.
4. **post-publish canary + soak** — the canary re-runs on the live serving
   path; its failure, or within ``lifecycle.soak_s`` a breaker that left
   ``closed`` (``soak_breaker``) or a failed periodic canary
   (``soak_canary``), rolls back to the retained slot. The re-canary after
   a rollback is also the breaker's recovery probe.

``POST .../{name}:rollback`` exposes the same rollback manually and
``GET .../{name}/versions`` the transition history. Metrics:
``model_version`` gauge, ``reloads_total`` / ``reload_rejected_total{stage=}``
/ ``rollbacks_total{reason=}`` counters. Stage names, reasons, history
statuses and counter labels are the JAX package's, and so are the
structured events emitted beside the log lines (``published``,
``reload_rejected``, ``rolled_back`` in subsystem ``lifecycle``, through
``telemetry.events.emit``: a no-op unless the server's event plane is on).
"""

from __future__ import annotations

import asyncio
import logging
import time
from functools import partial
from typing import Any, Awaitable, Callable

import numpy as np

from tpuserve_torch.config import LifecycleConfig
from tpuserve_torch.obs import Metrics
from tpuserve_torch.runtime import NaNDetected, StagedParams
from tpuserve_torch.savedmodel import IntegrityError
from tpuserve_torch.telemetry import events as events_mod
from tpuserve_torch.utils.locks import new_async_lock

log = logging.getLogger("tpuserve_torch.lifecycle")


class ReloadRejected(Exception):
    """A reload did not end with the candidate serving.

    ``stage`` names the gate that failed (``integrity``, ``nan_scan``,
    ``structure``, ``load``, ``staged_canary``, ``post_canary``);
    ``rolled_back`` is True when the candidate HAD published and the
    lifecycle reverted it (post-publish canary failure)."""

    def __init__(self, message: str, stage: str,
                 rolled_back: bool = False) -> None:
        super().__init__(message)
        self.stage = stage
        self.rolled_back = rolled_back


class ModelLifecycle:
    """Per-model version lifecycle manager: owns the reload/rollback state
    machine for one served model. The server builds one per model at start()
    and routes the admin endpoints through it."""

    def __init__(self, name: str, runtime: Any, model: Any,
                 cfg: LifecycleConfig, metrics: Metrics,
                 breaker: Any | None = None,
                 canary: Callable[[], Awaitable[bool]] | None = None,
                 canary_status: Callable[[], bool | None] | None = None,
                 injector: Any | None = None,
                 staged_canary_fn: Callable[[StagedParams], None] | None = None) -> None:
        self.name = name
        self.runtime = runtime
        self.model = model
        self.cfg = cfg
        self.metrics = metrics
        self.breaker = breaker
        # Coroutine function re-running the model's live canary (rides the
        # batcher; feeds /healthz). None in tests that drive the lifecycle
        # without a server.
        self._canary = canary
        # Cheap read of the latest periodic-canary verdict; the soak monitor
        # watches it without submitting extra probes.
        self._canary_status = canary_status
        # Replacement staged-canary body (blocking; runs in the executor):
        # an engine-served generative model passes
        # GenEngine.staged_canary_sync, so the candidate proves itself on a
        # SHORT end-to-end generation through the real programs (on the
        # engine's scratch state block) instead of the one-shot forward
        # buckets it does not capture.
        self._staged_canary_fn = staged_canary_fn
        self.injector = injector
        self._lock = new_async_lock("lifecycle.ModelLifecycle")
        self._soak_task: asyncio.Task | None = None
        # Version-transition records, newest last: {version, at, status,
        # ...detail}. status: live | superseded | rolled_back | rejected.
        self.history: list[dict] = []
        self._record(version=runtime.version, status="live", source="startup")
        self.metrics.set_model_version(name, runtime.version)

    # -- public API ----------------------------------------------------------

    async def reload(self) -> dict:
        """Staged, reversible reload from cfg.weights. Returns the publish
        info dict on success; raises ReloadRejected with the failing gate
        (and whether a rollback happened) otherwise."""
        async with self._lock:
            self._cancel_soak()
            t0 = time.perf_counter()
            loop = asyncio.get_running_loop()
            # The default executor, not the server's decode pool: a slow
            # checkpoint load must not occupy a thread the batcher needs.
            try:
                staged = await loop.run_in_executor(None, partial(
                    self.runtime.stage_params,
                    verify_integrity=self.cfg.verify_checksum,
                    nan_scan=self.cfg.nan_scan,
                    require_manifest=self.cfg.require_manifest))
            except IntegrityError as e:
                self._reject("integrity", e)
            except NaNDetected as e:
                self._reject("nan_scan", e)
            except ValueError as e:
                self._reject("structure", e)
            except Exception as e:  # noqa: BLE001 — e.g. an unreadable file
                self._reject("load", e)

            # Every configured bucket's graphs exist before the staged canary
            # runs; steady state this adds nothing (runtime_compiles_total
            # and the captures stay put across reload churn).
            try:
                n_new = await loop.run_in_executor(None, self.runtime.ensure_compiled)
                if n_new:
                    log.info("%s: captured %d missing variant(s) at stage time",
                             self.name, n_new)
            except Exception as e:  # noqa: BLE001 — a failed capture
                self._reject("load", e)

            if self.cfg.staged_canary:
                try:
                    if self.injector is not None:
                        self.injector.check("reload_regressed", self.name)
                    await loop.run_in_executor(
                        None, self._staged_canary_sync, staged)
                except Exception as e:  # noqa: BLE001
                    self._reject("staged_canary", e)

            info = self.runtime.publish(staged)
            self.metrics.counter(f"reloads_total{{model={self.name}}}").inc()
            self.metrics.set_model_version(self.name, self.runtime.version)
            if self.history and self.history[-1]["status"] == "live":
                self.history[-1]["status"] = "superseded"
            self._record(version=self.runtime.version, status="live",
                         source=self.model.cfg.weights or "init")
            log.info("%s: published version %d", self.name, self.runtime.version)
            # Structured twin of the log line: fields a reader can match.
            events_mod.emit("info", "lifecycle", "published",
                            model=self.name, version=self.runtime.version)

            canary_ok = True
            if self._canary is not None:
                canary_ok = await self._canary()
            if not canary_ok:
                rb = await self._rollback_locked("post_publish_canary")
                raise ReloadRejected(
                    f"post-publish canary failed for {self.name}; rolled "
                    f"back to version {rb['version']}",
                    stage="post_canary", rolled_back=True)

            if self.cfg.soak_s > 0:
                self._soak_task = loop.create_task(self._soak(self.runtime.version))
            info["reload_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
            info["canary_ok"] = canary_ok
            info["soak_s"] = self.cfg.soak_s
            return info

    async def rollback(self, reason: str = "manual") -> dict:
        """Restore the retained last-known-good version (N-1). Raises
        ValueError when nothing is retained."""
        async with self._lock:
            return await self._rollback_locked(reason)

    def describe(self) -> dict:
        return {
            "model": self.name,
            "live_version": self.runtime.version,
            "previous_version": self.runtime.previous_version,
            "soaking": self._soak_task is not None and not self._soak_task.done(),
            "history": list(self.history),
        }

    def close(self) -> None:
        """Server shutdown: stop the soak monitor."""
        self._cancel_soak()

    # -- internals -----------------------------------------------------------

    def _record(self, **fields) -> None:
        fields.setdefault("at", round(time.time(), 3))
        self.history.append(fields)
        del self.history[: -self.cfg.history_limit]

    def _reject(self, stage: str, err: Exception) -> None:
        self.metrics.counter(
            f"reload_rejected_total{{model={self.name},stage={stage}}}").inc()
        self._record(version=self.runtime.version, status="rejected",
                     stage=stage, error=str(err))
        log.warning("%s: reload rejected at %s gate: %s; version %d keeps "
                    "serving", self.name, stage, err, self.runtime.version)
        events_mod.emit("warning", "lifecycle", "reload_rejected",
                        model=self.name, stage=stage, error=str(err),
                        version=self.runtime.version)
        raise ReloadRejected(
            f"reload rejected at {stage} gate: {err}", stage=stage) from err

    def _staged_canary_sync(self, staged: StagedParams) -> None:
        """Run the model's canary item through the staged slot's graphs
        (``params_override``): the candidate proves itself on the device
        before one request can reach it. Blocking D2H — runs in the default
        executor."""
        if self._staged_canary_fn is not None:
            self._staged_canary_fn(staged)
            return
        item = self.model.canary_item()
        bucket = self.model.bucket_for(1, group=self.model.group_key(item))
        host_batch = self.model.assemble([item], bucket)
        out = self.runtime.fetch(self.runtime.run(bucket, host_batch,
                                                  params_override=staged))
        bad = [k for k, a in sorted(out.items())
               if np.asarray(a).dtype.kind == "f" and not np.isfinite(a).all()]
        if bad:
            raise ValueError(f"staged canary produced non-finite outputs in {bad}")
        if not self.model.host_postprocess(out, 1):
            raise ValueError("staged canary produced no result")

    async def _rollback_locked(self, reason: str) -> dict:
        self._cancel_soak()
        info = self.runtime.rollback()  # ValueError if nothing retained
        self.metrics.counter(
            f"rollbacks_total{{model={self.name},reason={reason}}}").inc()
        self.metrics.set_model_version(self.name, self.runtime.version)
        for rec in reversed(self.history):
            if rec["version"] == info["rolled_back_from"] \
                    and rec["status"] in ("live", "superseded"):
                rec["status"] = "rolled_back"
                rec["reason"] = reason
                break
        self._record(version=info["version"], status="live",
                     source=f"rollback({reason})")
        log.warning("%s: rolled back version %d -> %d (%s)", self.name,
                    info["rolled_back_from"], info["version"], reason)
        events_mod.emit("warning", "lifecycle", "rolled_back",
                        model=self.name, reason=reason,
                        version=info["version"],
                        rolled_back_from=info["rolled_back_from"])
        # Re-canary so /healthz reflects the restored weights and the
        # breaker's recovery path sees a live probe.
        if self._canary is not None:
            await self._canary()
        return info

    async def _soak(self, version: int) -> None:
        """Post-publish soak monitor: a breaker trip or canary failure
        within the window rolls the just-published version back."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.cfg.soak_s
        while loop.time() < deadline:
            await asyncio.sleep(self.cfg.soak_poll_s)
            if self.runtime.version != version:
                return  # superseded or manually rolled back
            reason = None
            if self.breaker is not None and self.breaker.state != "closed":
                reason = "soak_breaker"
            elif self._canary_status is not None and self._canary_status() is False:
                reason = "soak_canary"
            if reason is not None:
                # Clear our own handle first: _rollback_locked cancels the
                # registered soak task, which would be this one.
                self._soak_task = None
                try:
                    await self.rollback(reason=reason)
                except ValueError:
                    log.warning("%s: soak wanted rollback but no previous "
                                "version retained", self.name)
                return
        log.info("%s: version %d passed its %.1fs soak window",
                 self.name, version, self.cfg.soak_s)

    def _cancel_soak(self) -> None:
        try:
            current = asyncio.current_task()
        except RuntimeError:  # close() outside a running loop
            current = None
        t = self._soak_task
        if t is None or t is current:
            return  # the soak task rolling back clears its own handle
        if not t.done():
            t.cancel()
        self._soak_task = None
