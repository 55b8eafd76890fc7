"""Typed configuration for tpuserve_torch: the part of ``tpuserve/config.py``
the port serves, in its own copy (the port imports nothing from
``tpuserve``).

The port reads the same TOML files as the JAX package. What it serves is
typed: :class:`ModelConfig`, :class:`PipelineConfig`,
:class:`LifecycleConfig`, :class:`FaultsConfig` (with its
:class:`FaultRuleConfig` rules), :class:`CacheConfig`,
:class:`AdaptiveConfig`, the observability tables :class:`TraceConfig`,
:class:`EventsConfig` and :class:`TelemetryConfig`, the generation
engine's :class:`GenserveConfig`, the process tier's :class:`RouterConfig`
and :class:`WorkerConfig`, the fleet scheduler's :class:`SchedulerConfig`,
the tenants' :class:`TenantsConfig` (with its :class:`TenantConfig`
entries), the fleet controller's :class:`AutopilotConfig`, the mesh plan
:class:`ParallelConfig`, the multi-process seam :class:`DistributedConfig`,
the per-model :class:`SloConfig` and the top-level :class:`ServerConfig`
fields, with the JAX package's defaults and checks. Every table and key of
the JAX package is typed since the mesh modes were ported, so
``UNPORTED_TABLES``, ``_SERVER_UNPORTED`` and ``_MODEL_UNPORTED`` are
empty; a setting the port ever lacks again parses into the ``unported``
dict of its ``ServerConfig`` or ``ModelConfig`` as a plain value, and
:func:`unported_settings` names it so the server refuses to start: a JAX
config tuned with it never loads into a server that quietly behaves
otherwise. Every ``[[faults.rule]]`` kind fires at a call site the port
has; while ``[faults]`` is enabled, a rule of a kind whose call site the
port lacked would be refused by name (``_FAULT_KINDS_UNPORTED``, empty
since deferred mode's ``worker_death`` was ported).

Example TOML::

    port = 8000

    [[model]]
    name = "bert"
    family = "bert"
    batch_buckets = [1, 8, 32]
    seq_buckets = [64, 128]
    dtype = "bfloat16"
    parallelism = "single"
"""

from __future__ import annotations

import dataclasses

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomli is the same parser
    import tomli as tomllib
from dataclasses import dataclass, field
from typing import Any

# The JAX package's tables the port does not serve yet (any key set in one
# is refused, except ``enabled = false``): none since [parallel] and
# [distributed] were ported with the mesh modes.
UNPORTED_TABLES: tuple[str, ...] = ()
_TABLE_OFF: dict[str, tuple] = {"enabled": (False,)}
# The JAX package's top-level and per-model keys the port does not serve
# yet, each with the values that ask for nothing the port lacks (empty: no
# such value, any setting is refused). None is left since profiler_port
# and pp were ported.
_SERVER_UNPORTED: dict[str, tuple] = {}
_MODEL_UNPORTED: dict[str, tuple] = {}


WIRE_FORMATS = ("rgb8", "yuv420")

# Fault kinds the reference's injector knows (tpuserve/config.py FAULT_KINDS).
FAULT_KINDS = ("batch_error", "slow_dispatch", "decode_corrupt", "worker_death",
               "canary_fail", "device_error", "slow_compute", "kill_group_loop",
               "reload_corrupt", "reload_nan", "reload_regressed", "worker_crash",
               "worker_hang", "worker_slow", "stream_stall", "stream_disconnect")
# The kinds whose call sites the port lacks, with the ROADMAP.md queue-1
# item that ports them; a rule of one of these is refused while [faults]
# is enabled. None is left since deferred mode's worker_death.
_FAULT_KINDS_UNPORTED: dict[str, str] = {}


@dataclass
class PipelineConfig:
    """Pipelined host execution (``[pipeline]`` TOML; tpuserve_torch.hostpipe).

    The hot path runs as a staged pipeline — assemble, H2D copy + dispatch,
    D2H fetch, postprocess — with a dedicated thread pool per stage so
    consecutive batches occupy different stages at once, preallocated
    per-bucket assembly buffers, and a depth-k pool of staging slots
    bounding the batches in the device section ([h2d..fetch])."""

    # Thread-pool size per stage (shared across every model).
    assemble_workers: int = 2
    h2d_workers: int = 2
    fetch_workers: int = 2
    postproc_workers: int = 2
    # Batches in flight inside [h2d..fetch] ("staging slots"); 0 derives it
    # from each model's max_inflight.
    depth: int = 0
    # Extra batches admitted past the device depth so assembly runs ahead of
    # the device: admission = depth + this.
    assemble_ahead: int = 2
    # Preallocated assembly buffers per (model, bucket); 0 sizes it to
    # depth + assemble_ahead. Acquires beyond this take one-shot
    # allocations counted in arena_overflow_total{model=}.
    arena_slots: int = 0
    # The h2d stage waits for its own copy to land (not for the work
    # queued before it), so the "h2d" phase owns the transfer.
    h2d_sync: bool = True

    def __post_init__(self) -> None:
        for f in ("assemble_workers", "h2d_workers", "fetch_workers",
                  "postproc_workers"):
            if getattr(self, f) < 1:
                raise ValueError(f"pipeline.{f} must be >= 1")
        if self.depth < 0 or self.assemble_ahead < 0 or self.arena_slots < 0:
            raise ValueError(
                "pipeline.depth/assemble_ahead/arena_slots must be >= 0")


@dataclass
class CacheConfig:
    """Content-addressed result cache + single-flight coalescing (``[cache]``
    TOML; tpuserve_torch.cache).

    Key = digest(model, live version, decoded item); value = the
    postprocessed result. The live model version is part of every key, so a
    lifecycle publish or rollback invalidates all previous entries without a
    sweep. Hits and coalesced waiters are counted apart from misses, so
    cache traffic never reads as model throughput."""

    enabled: bool = False
    # Max cached results per model (LRU beyond it).
    capacity: int = 4096
    # Entry time-to-live in seconds; 0 disables expiry (version churn is the
    # primary invalidation; TTL exists for non-deterministic models).
    ttl_s: float = 0.0
    # Single-flight: N concurrent identical misses occupy ONE batch slot,
    # the result fanning out to every waiter.
    coalesce: bool = True
    # JSON results at most this big are serialized once at population time,
    # so a hit's response body is a copy, not a json.dumps per request.
    max_body_bytes: int = 1048576

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError(f"cache.capacity must be >= 1, got {self.capacity}")
        if self.ttl_s < 0 or self.max_body_bytes < 0:
            raise ValueError("cache.ttl_s/max_body_bytes must be >= 0")


@dataclass
class AdaptiveConfig:
    """SLO-aware adaptive batching (``[adaptive]`` TOML; tpuserve_torch.batcher).

    Replaces the fixed max-wait flush with an AIMD-adjusted per-group target
    batch size plus a deadline-headroom bound from the per-bucket
    batch-duration EWMA: under light load the target decays to
    ``min_target`` and batches flush at once; under sustained load it climbs
    to the largest bucket and batches fill. ``deadline_ms`` stays as the
    max-wait backstop."""

    enabled: bool = True
    # Floor of the AIMD target batch size.
    min_target: int = 1
    # Starting target per group; 0 = the model's largest batch bucket (the
    # fixed-timer behaviour, so cold groups favour throughput).
    initial_target: int = 0
    # Additive increase when a batch fills to target with more work still
    # queued.
    increase: float = 1.0
    # Multiplicative decrease on a timer-driven partial flush.
    decrease: float = 0.5
    # Smoothing factor of the per-bucket batch-duration EWMA.
    ewma_alpha: float = 0.2
    # Safety margin (ms) subtracted with the EWMA from the earliest request
    # deadline when computing the flush headroom bound.
    slack_ms: float = 2.0

    def __post_init__(self) -> None:
        if self.min_target < 1 or self.initial_target < 0:
            raise ValueError(
                "adaptive.min_target must be >= 1 and initial_target >= 0")
        if self.increase <= 0 or not 0.0 < self.decrease <= 1.0:
            raise ValueError(
                "adaptive.increase must be > 0 and decrease in (0, 1]")
        if not 0.0 < self.ewma_alpha <= 1.0 or self.slack_ms < 0:
            raise ValueError(
                "adaptive.ewma_alpha must be in (0, 1] and slack_ms >= 0")


@dataclass
class GenserveConfig:
    """Iteration-level generation engine (``[genserve]`` TOML;
    tpuserve_torch.genserve).

    The static-bucket batcher locks a batch for its whole run — correct for
    one-shot classifiers, wrong for multi-step generative work. With this
    block enabled, models whose family implements the generative contract
    (``tpuserve_torch.genserve.GenerativeModel``: textgen) serve through an
    iteration-level engine instead (Orca): the active batch re-forms every
    model iteration, finished sequences retire immediately, queued requests
    fold into free slots mid-flight, and past-deadline sequences evict with
    the fast-504 contract. Non-generative models keep the batcher."""

    enabled: bool = False
    # Generative slot capacity per model (the step's batch width); 0 = the
    # model's largest batch bucket.
    slots: int = 0
    # Max queued requests folded into free slots per iteration; 0 = fill
    # every free slot.
    admit_per_step: int = 0
    # Streaming: per-request emission queue depth between the step loop and
    # the HTTP writer (a full queue applies the model's stream_policy).
    stream_queue: int = 64
    # SSE heartbeat comments (": hb") across idle emission gaps, so a client
    # can tell "still generating" from a dead stream; 0 disables them.
    stream_heartbeat_s: float = 5.0
    # Graceful-drain stream budget: on SIGTERM, in-flight streams get this
    # long to finish before the engine terminates stragglers with the
    # well-formed error event (reason "drain").
    stream_drain_s: float = 5.0
    # Paged KV cache (PagedAttention / vLLM): families with the paged
    # contract (textgen) keep KV in fixed-size pages behind a block table
    # instead of one dense worst-case-context slab per slot. Pages are
    # reserved at fold-in (prompt + decode budget) and returned on
    # retire/evict/disconnect; exhaustion sheds 503 (reason kv_pressure).
    kv_paging: bool = False
    # Tokens per KV page.
    kv_page_tokens: int = 16
    # Pages in the pool, INCLUDING the write-sink sentinel (page 0). 0 =
    # auto: slots * pages-per-max-context + 1, the dense slab's bytes.
    kv_pages: int = 0
    # Chunked prefill: a paged prompt folds in this many tokens per engine
    # iteration, interleaved with decode steps. 0 = whole prompt in one
    # chunk (exactly the dense prefill math). Only with kv_paging.
    prefill_chunk: int = 0

    def __post_init__(self) -> None:
        if self.slots < 0 or self.admit_per_step < 0:
            raise ValueError(
                "genserve.slots/admit_per_step must be >= 0")
        if self.stream_queue < 1:
            raise ValueError(
                f"genserve.stream_queue must be >= 1, got {self.stream_queue}")
        if self.stream_heartbeat_s < 0 or self.stream_drain_s < 0:
            raise ValueError(
                "genserve.stream_heartbeat_s/stream_drain_s must be >= 0")
        if self.kv_page_tokens < 1:
            raise ValueError(
                f"genserve.kv_page_tokens must be >= 1, got "
                f"{self.kv_page_tokens}")
        if self.kv_pages < 0 or self.prefill_chunk < 0:
            raise ValueError(
                "genserve.kv_pages/prefill_chunk must be >= 0")
        if self.kv_pages == 1:
            raise ValueError(
                "genserve.kv_pages must be 0 (auto) or >= 2 (the pool "
                "includes the sentinel page)")


@dataclass
class FaultRuleConfig:
    """One armed chaos rule (TOML ``[[faults.rule]]``; tpuserve_torch.faults)."""

    # Which call site fires (see FAULT_KINDS).
    kind: str = "batch_error"
    # Model name the rule applies to; "*" matches every model.
    model: str = "*"
    # Per-call-site chance of firing, drawn from a rule-local seeded RNG so
    # runs are reproducible.
    probability: float = 1.0
    # Max times the rule fires; -1 = unlimited.
    count: int = -1
    # Sleep for the slow_* kinds (ignored by the others).
    delay_ms: float = 0.0
    # Rule-local RNG seed; 0 derives one from FaultsConfig.seed + rule index.
    seed: int = 0
    # Arm the rule only after the injector has been alive this long (s).
    after_s: float = 0.0
    # Restrict the rule to one worker process id behind the router: -1 =
    # any process (a single-process server has no worker id).
    worker: int = -1

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {list(FAULT_KINDS)}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got {self.probability}")
        if self.after_s < 0:
            raise ValueError(f"faults.rule.after_s must be >= 0, got {self.after_s}")
        if self.worker < -1:
            raise ValueError(f"faults.rule.worker must be >= -1, got {self.worker}")


@dataclass
class FaultsConfig:
    """Deterministic fault injection for chaos testing (``[faults]`` TOML).

    Off by default; staging configs arm rules to prove that the lifecycle's
    gates and the server's canaries hold while degraded."""

    enabled: bool = False
    # Base seed rule-local RNGs derive from (reproducible chaos runs).
    seed: int = 0
    rules: list[FaultRuleConfig] = field(default_factory=list)


@dataclass
class LifecycleConfig:
    """Versioned model lifecycle (``[lifecycle]`` TOML; tpuserve_torch.lifecycle).

    Every weight reload is a staged, reversible transition: load off the
    serving path -> verify integrity -> canary the *staged* params -> publish
    as a numbered version with the previous tree retained -> auto-rollback on
    a post-publish canary failure or a failed canary within the soak
    window."""

    # Verify the sidecar checksum manifest (written by save_npz) against the
    # loaded tree when one is present.
    verify_checksum: bool = True
    # Reject reloads of checkpoints that carry NO manifest (strict
    # provenance mode).
    require_manifest: bool = False
    # Scan the candidate tree for NaN/Inf float leaves before staging.
    nan_scan: bool = True
    # Run the canary inference against the STAGED params (through the
    # staged parameter slot's graphs) before publishing; a failure never
    # publishes.
    staged_canary: bool = True
    # Post-publish soak window (s): if the periodic canary fails within this
    # window, the reload auto-rolls back to the retained last-known-good
    # version. 0 disables soaking.
    soak_s: float = 0.0
    # Soak poll cadence (s).
    soak_poll_s: float = 0.25
    # Version-transition records kept per model (/admin .../versions).
    history_limit: int = 16


@dataclass
class TraceConfig:
    """Request-scoped tracing (``[trace]`` TOML; tpuserve_torch.obs).

    Every HTTP request gets a 128-bit trace context at ingest (adopted from
    a well-formed ``X-Trace-Id``) and the id comes back as ``X-Trace-Id`` on
    every response, errors included. This block sizes what is retained: the
    flight recorder's slowest-N-per-model reservoir, the errored-request
    FIFO, and whether /metrics histograms render trace-id exemplars."""

    # Slowest-N complete span trees retained per model for /debug/slow;
    # 0 disables the slow reservoir (errors still record).
    slow_n: int = 16
    # Record every errored/shed request (HTTP status >= 400) even when fast.
    always_record_errors: bool = True
    # Errored-request span trees retained (FIFO beyond it).
    error_capacity: int = 256
    # Per-bucket trace-id exemplars on /metrics histogram bucket lines
    # (OpenMetrics exemplar syntax).
    exemplars: bool = True

    def __post_init__(self) -> None:
        if self.slow_n < 0 or self.error_capacity < 0:
            raise ValueError(
                "trace.slow_n/error_capacity must be >= 0")


@dataclass
class EventsConfig:
    """Structured event plane (``[events]`` TOML; tpuserve_torch.telemetry.events).

    On by default: a bounded ring of structured event records fed by
    explicit emissions and a stdlib ``logging.Handler`` bridge over the
    ``tpuserve_torch.*`` loggers (``GET /debug/events``), the admin audit
    trail (``GET /debug/audit``) and the postmortem ledger
    (``GET /debug/postmortems``). ``dir``, ``stderr_path`` and
    ``snapshot_path`` are the worker tier's black box
    (``tpuserve_torch.workerproc``): the supervisor sets the last two per
    worker slot, the worker redirects its stderr to the first and
    checkpoints a snapshot to the second, and the supervisor folds both
    into the postmortem of a worker it reaps."""

    enabled: bool = True
    # Event records retained in the ring (newest kept).
    capacity: int = 4096
    # Optional JSONL file sink ("" disables).
    jsonl_path: str = ""
    # Minimum stdlib-logging level bridged into the ring.
    bridge_level: str = "INFO"
    # Black-box directory of the worker tier ("" = a per-deployment
    # directory under the system's temporary directory).
    dir: str = ""
    # Postmortem-snapshot cadence (s) of a worker's black box.
    snapshot_interval_s: float = 2.0
    # Bytes of a dead process's stderr capture folded into its postmortem.
    stderr_tail_bytes: int = 4096
    # Admin audit records retained (FIFO beyond it).
    audit_capacity: int = 256
    # Postmortem records retained (FIFO beyond it).
    postmortem_capacity: int = 64
    # Set per worker slot by the supervisor: the worker's stderr capture
    # and its snapshot file ("" = none).
    stderr_path: str = ""
    snapshot_path: str = ""

    def __post_init__(self) -> None:
        if self.capacity < 1 or self.audit_capacity < 1 \
                or self.postmortem_capacity < 1:
            raise ValueError(
                "events.capacity/audit_capacity/postmortem_capacity "
                "must be >= 1")
        if self.snapshot_interval_s < 0 or self.stderr_tail_bytes < 0:
            raise ValueError(
                "events.snapshot_interval_s/stderr_tail_bytes must be >= 0")
        if self.bridge_level.upper() not in ("DEBUG", "INFO", "WARNING",
                                             "ERROR"):
            raise ValueError(
                f"events.bridge_level must be DEBUG/INFO/WARNING/ERROR, "
                f"got {self.bridge_level!r}")


@dataclass
class TelemetryConfig:
    """Telemetry plane (``[telemetry]`` TOML; tpuserve_torch.telemetry).

    On by default: a sampler thread snapshots every metric into bounded
    rings at ``sample_interval_s`` (``GET /stats/history``), the SLO engine
    evaluates multi-window burn rates over ``[model.slo]`` (``GET
    /alerts``), the sampler derives ``device_utilization{model=,replica=}``
    from ``device_seconds_total``, and ``POST /debug/profile`` captures a
    device trace. ``fleet_timeout_ms`` bounds each source of the router's
    fleet scrape (``/metrics/fleet``, ``/stats/fleet``)."""

    enabled: bool = True
    # Sampler cadence (s).
    sample_interval_s: float = 1.0
    # History retained per metric (s); ring capacity = history_s /
    # sample_interval_s, capped at 4096 samples.
    history_s: float = 600.0
    # Burn-rate windows (s), ascending: FIRING when the burn exceeds
    # `burn_alert` over the first two, PENDING over the first alone.
    burn_windows_s: list[float] = field(
        default_factory=lambda: [60.0, 300.0, 1800.0])
    # Window (s) of the device_utilization derivation.
    utilization_window_s: float = 10.0
    # The router's per-source fleet-scrape budget.
    fleet_timeout_ms: float = 2000.0
    # Upper bound on POST /debug/profile?duration_ms=.
    profile_max_ms: float = 10000.0

    def __post_init__(self) -> None:
        if self.sample_interval_s <= 0 or self.history_s <= 0:
            raise ValueError(
                "telemetry.sample_interval_s/history_s must be > 0")
        if len(self.burn_windows_s) < 2 \
                or any(w <= 0 for w in self.burn_windows_s) \
                or sorted(self.burn_windows_s) != list(self.burn_windows_s):
            raise ValueError(
                "telemetry.burn_windows_s must be >= 2 ascending positive "
                f"windows, got {self.burn_windows_s}")
        if self.utilization_window_s <= 0 or self.fleet_timeout_ms <= 0 \
                or self.profile_max_ms <= 0:
            raise ValueError(
                "telemetry.utilization_window_s/fleet_timeout_ms/"
                "profile_max_ms must be > 0")


@dataclass
class RouterConfig:
    """Router/worker process split (``[router]`` TOML;
    tpuserve_torch.workerproc).

    Off by default — the single-process server is unchanged. When enabled,
    ``serve`` starts a **router** process owning HTTP/JSON, the result
    cache + single-flight coalescing, admission/deadline stamping, and
    per-model circuit breakers, plus ``workers`` isolated worker processes
    each owning batching + the device runtime. A supervisor health-checks
    workers, reaps dead ones, and respawns them with exponential backoff;
    the router re-dispatches idempotent work to a surviving worker on
    transport failure (never past the request's absolute deadline) and
    hedges slow attempts — one misbehaving or crashed worker costs
    capacity, never availability. ``hosts`` groups the workers into host
    failure domains (``tpuserve_torch.workerproc.hosts``) and ``routers``
    puts peer routers on the serving port (``tpuserve_torch.workerproc.
    peers``)."""

    enabled: bool = False
    # Worker processes to supervise (each builds every configured model).
    # With hosts > 0 this is the worker count PER HOST.
    workers: int = 2
    # Host failure domains. 0 = no host layer: workers are direct children
    # of the router. N >= 1 groups the workers into N named hosts, each a
    # host-agent process in its own process group owning ``workers``
    # worker processes, so one SIGKILL of the group takes out the whole
    # domain, as a machine dying would. The router routes around a dead
    # host (host breaker + health probes), respawns it with the workers'
    # backoff, and never places a hedge on its primary's host.
    hosts: int = 0
    # Router processes sharing the serving port via SO_REUSEPORT. Router 0
    # (the primary) owns the host/worker supervisor and supervises the
    # N - 1 peer routers; every router shards the result cache by
    # consistent hash, forwarding a miss to the key's owning router over
    # loopback HTTP and degrading to local-only (counted, never erroring)
    # when the owner is unreachable.
    routers: int = 1
    # Consecutive relay transport failures (connection refused/reset)
    # against one host's workers before the whole host is routed around
    # without waiting for health probes; 0 disables the host breaker.
    host_breaker_threshold: int = 3
    # How long a tripped host breaker sheds picks before half-opening (the
    # next pick is the recovery probe; a success closes it).
    host_breaker_cooldown_s: float = 1.0
    # Peer routers poll the primary for topology (worker addresses, ring
    # membership, cache generations) this often.
    peer_sync_interval_s: float = 0.5
    # The primary's peer-listener port (the loopback control plane the peer
    # routers sync from and forward cache hops to); 0 = ephemeral.
    peer_port: int = 0
    # Transport-failure re-dispatches per request (connection refused/reset,
    # a worker dying mid-request). Definitive worker answers (any HTTP
    # status from a live worker except 503-not-admitted) are NEVER retried:
    # a 500 means the work already executed and failed — re-running it
    # would double-execute. Retries always honor the admission deadline.
    retry_max: int = 2
    # > 0: an attempt silent for this long gets a duplicate dispatched to a
    # different worker; first definitive answer wins, the loser is
    # cancelled (tail-latency hedging; covers a wedged-but-alive worker).
    hedge_ms: float = 0.0
    # TCP connect budget per attempt.
    connect_timeout_ms: float = 500.0
    # Supervisor HTTP health-probe cadence and per-probe budget.
    health_interval_s: float = 0.5
    health_timeout_ms: float = 1000.0
    # Consecutive failed probes before a live process is routed around.
    unhealthy_after: int = 3
    # Exponential respawn backoff for dead workers:
    # min(max_s, initial_s * multiplier^consecutive_failures).
    respawn_initial_s: float = 0.5
    respawn_max_s: float = 30.0
    respawn_multiplier: float = 2.0
    # Worker boot budget (spawn -> ready handshake), seconds. Generous: a
    # cold worker builds the kernels and captures every bucket's graphs.
    spawn_timeout_s: float = 900.0
    # Initial ACTIVE worker slots per host domain: slots beyond this boot
    # scaled down and cost nothing until ``/admin/hosts/{hid}:scale``
    # activates them. 0 = all ``workers`` slots active.
    active_workers: int = 0
    # Per-stream idle timeout: a STARTED stream whose worker goes silent (no
    # chunk) this long is terminated with the well-formed error event
    # (reason "idle_timeout"), distinct from the absolute request deadline.
    # 0 disables it (only the deadline bounds the stream).
    stream_idle_timeout_ms: float = 30000.0
    # Router-side graceful-drain stream budget: on SIGTERM, in-flight
    # streams get this long to finish before the router terminates them
    # with the error event (reason "drain"); 0 = only drain_timeout_s.
    stream_drain_s: float = 5.0

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError(f"router.workers must be >= 1, got {self.workers}")
        if self.active_workers < 0 or self.active_workers > self.workers:
            raise ValueError(
                f"router.active_workers must be in [0, workers], got "
                f"{self.active_workers}")
        if self.retry_max < 0 or self.hedge_ms < 0:
            raise ValueError("router.retry_max/hedge_ms must be >= 0")
        if self.respawn_initial_s < 0 or self.respawn_max_s <= 0 \
                or self.respawn_multiplier < 1.0:
            raise ValueError(
                "router.respawn_initial_s must be >= 0, respawn_max_s > 0, "
                "respawn_multiplier >= 1")
        if self.health_interval_s <= 0 or self.unhealthy_after < 1:
            raise ValueError(
                "router.health_interval_s must be > 0 and unhealthy_after >= 1")
        if self.hosts < 0:
            raise ValueError(f"router.hosts must be >= 0, got {self.hosts}")
        if self.routers < 1:
            raise ValueError(
                f"router.routers must be >= 1, got {self.routers}")
        if self.host_breaker_threshold < 0 \
                or self.host_breaker_cooldown_s <= 0:
            raise ValueError(
                "router.host_breaker_threshold must be >= 0 and "
                "host_breaker_cooldown_s > 0")
        if self.peer_sync_interval_s <= 0 or self.peer_port < 0:
            raise ValueError(
                "router.peer_sync_interval_s must be > 0 and "
                "peer_port >= 0")
        if self.stream_idle_timeout_ms < 0 or self.stream_drain_s < 0:
            raise ValueError(
                "router.stream_idle_timeout_ms/stream_drain_s must be >= 0")


@dataclass
class WorkerConfig:
    """Worker-process side of the router split (``[worker]`` TOML;
    tpuserve_torch.workerproc.worker). Workers are full single-process
    servers bound to loopback; the router relays to them."""

    # Bind address for worker HTTP listeners (loopback: workers are an
    # internal tier, never exposed).
    host: str = "127.0.0.1"
    # Worker i listens on port_base + i; 0 = ephemeral ports (the
    # supervisor learns them from the ready handshake).
    port_base: int = 0
    # Per-worker SIGTERM drain budget; 0 = inherit the server's
    # drain_timeout_s.
    drain_timeout_s: float = 0.0

    def __post_init__(self) -> None:
        if self.port_base < 0 or self.drain_timeout_s < 0:
            raise ValueError(
                "worker.port_base/drain_timeout_s must be >= 0")


@dataclass
class SchedulerConfig:
    """Fleet-level SLO scheduler (``[scheduler]`` TOML;
    tpuserve_torch.scheduler).

    Off by default: every model keeps its independent batcher. When enabled,
    a central scheduler sits between admission and the per-model batchers
    and engines: requests whose stamped deadline provably cannot be met shed
    at admission with a fast 504 (``deadline_unmeetable``);
    ``X-Priority: interactive|batch`` requests arbitrate device time through
    a per-model device-seconds ledger (batch-class work sheds first under
    overload, and no model's interactive traffic is starved below
    ``min_share``); and models declared ``cold_start`` boot with no
    parameter slot on the device, warm through the lifecycle's
    stage-then-publish path on their first request (or ``:warm``) and demote
    back to cold after ``idle_demote_s``, freeing their slots."""

    enabled: bool = False
    # Sliding window (s) of the per-model device-seconds ledger behind the
    # priority-share arbitration.
    window_s: float = 10.0
    # The fleet counts as saturated (batch-class sheds, share floors
    # enforce) when the summed predicted queue-clear time of the warm models
    # exceeds this many seconds.
    overload_clear_s: float = 1.0
    # Interactive floor: under saturation a model with queued work whose
    # windowed device-time share is below this is "starved", and a model
    # over its allowance (1 - min_share * others) sheds until it catches
    # up. 0 disables the floor.
    min_share: float = 0.05
    # Grace (ms) beyond the predicted completion before deadline_unmeetable
    # fires.
    headroom_ms: float = 0.0
    # > 0: a warm cold_start model idle this long demotes back to cold,
    # freeing its parameter slots, until the next request warms it again.
    idle_demote_s: float = 0.0
    # Retry-After hint (s) of warming-window 503s before the first warm-up
    # was measured (the measured warm duration after that).
    warm_retry_after_s: float = 5.0
    # Idle-demotion sweep cadence (s).
    sweep_interval_s: float = 0.5
    # Chip budget of the warm models (each warm model occupies its
    # parallelism degree, its runtime's n_chips); warming past it first demotes
    # idle cold_start models and otherwise sheds 503 chip_budget. 0 =
    # unlimited.
    chip_budget: int = 0

    def __post_init__(self) -> None:
        if self.window_s <= 0 or self.sweep_interval_s <= 0:
            raise ValueError(
                "scheduler.window_s/sweep_interval_s must be > 0")
        if self.chip_budget < 0:
            raise ValueError(
                f"scheduler.chip_budget must be >= 0, got {self.chip_budget}")
        if not 0.0 <= self.min_share < 0.5:
            raise ValueError(
                f"scheduler.min_share must be in [0, 0.5), got {self.min_share}")
        if self.overload_clear_s < 0 or self.headroom_ms < 0 \
                or self.idle_demote_s < 0 or self.warm_retry_after_s < 0:
            raise ValueError(
                "scheduler.overload_clear_s/headroom_ms/idle_demote_s/"
                "warm_retry_after_s must be >= 0")


@dataclass
class TenantConfig:
    """One tenant (``[[tenants.tenant]]`` TOML;
    tpuserve_torch.scheduler.tenants): an API key and its containment
    envelope — a fairness weight, a windowed device-seconds quota and a
    request-rate limit. Overage is refused at admission with 429 +
    Retry-After."""

    name: str = ""
    # The key clients present as ``X-Api-Key``; unique and non-empty.
    api_key: str = ""
    # Fairness weight: the tenant's relative share of device time under
    # saturation, and of the result cache's capacity.
    weight: float = 1.0
    # Device-seconds the tenant may use per [tenants] window_s; 0 =
    # unlimited (tenant_quota_exceeded 429s past it).
    quota_device_s: float = 0.0
    # Request-rate limit (token bucket, requests/s); 0 = unlimited.
    rate_per_s: float = 0.0
    # Token-bucket burst; 0 derives max(1, 2 * rate_per_s).
    burst: float = 0.0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenants.tenant.name must be non-empty")
        if not self.api_key:
            raise ValueError(
                f"tenants.tenant {self.name!r}: api_key must be non-empty")
        if self.weight <= 0:
            raise ValueError(
                f"tenants.tenant {self.name!r}: weight must be > 0, "
                f"got {self.weight}")
        if self.quota_device_s < 0 or self.rate_per_s < 0 or self.burst < 0:
            raise ValueError(
                f"tenants.tenant {self.name!r}: quota_device_s/rate_per_s/"
                "burst must be >= 0")


@dataclass
class TenantsConfig:
    """Multi-tenant front door (``[tenants]`` TOML;
    tpuserve_torch.scheduler.tenants).

    Off by default. When enabled, every predict request presents a
    configured ``X-Api-Key`` (401 otherwise, unless ``allow_anonymous``),
    and admission enforces per-tenant rate, windowed device-seconds quota
    and, under fleet saturation, weighted fair share, from one
    sliding-window device-seconds ledger per tenant. The result cache
    partitions its capacity by tenant weight, and each tenant gets SLO burn
    gauges over ``tenant_latency_ms{tenant=}``."""

    enabled: bool = False
    # Sliding window (s) of the per-tenant device-seconds ledger.
    window_s: float = 60.0
    # Admit requests with no or an unknown API key as the tenant named here
    # ("" = refuse them with 401); weight 1 and no quota or rate unless a
    # [[tenants.tenant]] entry names it.
    allow_anonymous: str = ""
    # Slack over a tenant's weighted fair share before share shedding fires
    # under saturation (tenant_share_exceeded); 0 disables it.
    share_slack: float = 1.25
    # Per-tenant SLO over tenant_latency_ms{tenant=}: latency objective (ms;
    # 0 disables the burn evaluation), availability target and burn alert.
    slo_latency_ms: float = 0.0
    slo_availability: float = 0.999
    slo_burn_alert: float = 10.0
    tenants: list[TenantConfig] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.window_s <= 0:
            raise ValueError(
                f"tenants.window_s must be > 0, got {self.window_s}")
        if self.share_slack < 0:
            raise ValueError(
                f"tenants.share_slack must be >= 0, got {self.share_slack}")
        if self.slo_latency_ms < 0:
            raise ValueError(
                f"tenants.slo_latency_ms must be >= 0, got {self.slo_latency_ms}")
        if not 0.0 < self.slo_availability < 1.0:
            raise ValueError(
                f"tenants.slo_availability must be in (0, 1), "
                f"got {self.slo_availability}")
        if self.slo_burn_alert <= 0:
            raise ValueError(
                f"tenants.slo_burn_alert must be > 0, got {self.slo_burn_alert}")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenants.tenant names must be unique: {names}")
        keys = [t.api_key for t in self.tenants]
        if len(set(keys)) != len(keys):
            raise ValueError("tenants.tenant api_keys must be unique")


@dataclass
class AutopilotConfig:
    """Self-healing fleet controller (``[autopilot]`` TOML;
    tpuserve_torch.scheduler.autopilot).

    Off by default. When enabled on the primary router, a reconcile loop
    reads SLO burn state, the host domains' queue pressure and the predicted
    clear time every ``interval_s`` and acts through the audited verbs an
    operator uses: scale a host domain's worker slots, engage or clear
    shed-on-burn per model, and (with ``paging``) warm or demote models under
    a budget. Every decision is damped by hysteresis, a per-(action, target)
    cooldown and an action budget per window, and rolled back when the
    objective got worse."""

    enabled: bool = False
    # Reconcile tick cadence (s).
    interval_s: float = 0.5
    # Consecutive ticks a trigger must hold before it acts.
    hysteresis_ticks: int = 3
    # Per-(action kind, target) cooldown (s); rollbacks are exempt.
    cooldown_s: float = 10.0
    # At most this many non-rollback actions per window_s.
    max_actions_per_window: int = 8
    window_s: float = 60.0
    # Follow-up watch: this long after an action the objective is measured
    # again, and an action that made it worse by more than
    # rollback_tolerance is inverted. 0 disables.
    follow_up_s: float = 15.0
    rollback_tolerance: float = 0.5
    # Queue pressure (mean in-flight relays per active healthy worker slot):
    # above high a domain scales up, below low with nothing burning it
    # scales down.
    pressure_high: float = 2.0
    pressure_low: float = 0.25
    # Predicted queue-clear time (s) that also triggers scale-up; 0 off.
    clear_high_s: float = 0.0
    # Never scale a domain below this many active slots.
    min_slots: int = 1
    # Allow shed-on-burn actions.
    burn_shed: bool = True
    # Allow scale actions against host domains.
    scale: bool = True
    # Allow warm/demote paging actions (fanned out to the workers' :warm and
    # :demote); needs [scheduler] cold_start models.
    paging: bool = False
    # Most models warm at once under paging; 0 = unlimited.
    max_warm: int = 0
    # Decision records kept for GET /debug/autopilot.
    history: int = 256

    def __post_init__(self) -> None:
        if self.interval_s <= 0 or self.window_s <= 0:
            raise ValueError(
                "autopilot.interval_s/window_s must be > 0")
        if self.hysteresis_ticks < 1 or self.max_actions_per_window < 1 \
                or self.min_slots < 1 or self.history < 1:
            raise ValueError(
                "autopilot.hysteresis_ticks/max_actions_per_window/"
                "min_slots/history must be >= 1")
        if self.cooldown_s < 0 or self.follow_up_s < 0 \
                or self.rollback_tolerance < 0 or self.clear_high_s < 0 \
                or self.max_warm < 0:
            raise ValueError(
                "autopilot.cooldown_s/follow_up_s/rollback_tolerance/"
                "clear_high_s/max_warm must be >= 0")
        if not 0.0 <= self.pressure_low < self.pressure_high:
            raise ValueError(
                f"autopilot.pressure_low must be in [0, pressure_high), got "
                f"low={self.pressure_low} high={self.pressure_high}")


@dataclass
class SloConfig:
    """Per-model service-level objective (``[model.slo]`` TOML;
    tpuserve_torch.telemetry.slo). A request is good when it answers within
    ``latency_ms``; the error budget is ``1 - availability`` and the burn
    rate over a window is (bad fraction) / budget. ``latency_ms = 0`` (the
    default) disables the SLO for the model."""

    latency_ms: float = 0.0
    availability: float = 0.999
    # FIRING when exceeded over the short and mid windows, PENDING on the
    # short alone.
    burn_alert: float = 10.0
    # First-unit objective of streamed generation (evaluated over
    # gen_first_unit_ms{model=}, which only a generation engine feeds).
    first_unit_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.latency_ms < 0:
            raise ValueError(
                f"slo.latency_ms must be >= 0, got {self.latency_ms}")
        if self.first_unit_ms < 0:
            raise ValueError(
                f"slo.first_unit_ms must be >= 0, got {self.first_unit_ms}")
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                f"slo.availability must be in (0, 1), got {self.availability}")
        if self.burn_alert <= 0:
            raise ValueError(
                f"slo.burn_alert must be > 0, got {self.burn_alert}")


@dataclass
class ModelConfig:
    """Per-model serving configuration."""

    name: str
    # Which implementation in tpuserve_torch.models to build.
    family: str = "resnet50"
    # Optional path to weights: a .npz of the reference's parameter tree
    # (tpuserve_torch.savedmodel); None => seeded random init.
    weights: str | None = None
    # Optional class-label file (one name per line, in class-index order);
    # responses then carry a "label" next to each class index.
    labels: str | None = None
    # Static batch-size buckets, ascending; each (batch, seq) bucket is
    # warmed up once at startup.
    batch_buckets: list[int] = field(default_factory=lambda: [1, 4, 8, 16, 32])
    # Sequence-length buckets for text models.
    seq_buckets: list[int] = field(default_factory=lambda: [64, 128, 256, 512])
    # Batcher flush deadline: a request waits at most this long for the batch
    # to fill before a partial (padded) batch is dispatched.
    deadline_ms: float = 5.0
    # Max requests queued before the server sheds load with 429s.
    max_queue: int = 4096
    # Per-request end-to-end deadline -> 504 when exceeded.
    request_timeout_ms: float = 2000.0
    # Compute dtype for params/activations on the device.
    dtype: str = "bfloat16"
    # Quantization: "int8" stores every large weight as int8 plus a
    # per-channel float32 scale and dequantizes it inside the forward;
    # "int8c" also keeps the family's int8-native weights (BERT's
    # projections and FFN, ResNet's 1x1 convs) int8 and multiplies them
    # int8 x int8 -> int32 (tpuserve_torch.quantize); None = full
    # compute-dtype weights.
    quantize: str | None = None
    # Float leaves smaller than this stay unquantized (biases, norms).
    quantize_min_size: int = 4096
    # Image input edge (H == W) for vision models.
    image_size: int = 224
    # Host->device wire shape edge for images: the host decodes to the wire
    # edge, the device resizes to image_size.
    wire_size: int = 256
    # Wire encoding of images: "rgb8" ((wire, wire, 3) uint8, 3 B/px) or
    # "yuv420" (full-res Y plane + 2x2-subsampled Cb/Cr planes, 1.5 B/px;
    # colour conversion on the device).
    wire_format: str = "rgb8"
    # Parallelism mode (tpuserve_torch.runtime): "sharded" (one mesh, the
    # batch split on its data axis, params replicated or split by the
    # family's partition rules), "replica" (one runtime replica per device),
    # "pipeline" (GPipe stages over a ("stage",) mesh) or "single" (the
    # first device only). The reference's default, "sharded", serves on a
    # one-device mesh on one card.
    parallelism: str = "sharded"
    # Pipeline stage count for parallelism = "pipeline" (0 = all devices).
    pp: int = 0
    # Tensor- and sequence-parallel axis sizes (1 = off).
    tp: int = 1
    sp: int = 1
    # Model-specific knobs (BERT: layers, d_model, heads, attention, ...).
    options: dict[str, Any] = field(default_factory=dict)
    # Number of classes where the family needs it.
    num_classes: int = 1000
    # Device-section depth (>= 1): how many of this model's batches occupy
    # [h2d..fetch] staging slots at once; [pipeline] depth overrides it
    # when nonzero. In recycle mode it bounds the batches between assembly
    # and their enqueue on a worker.
    max_inflight: int = 2
    # Execution mode (tpuserve_torch.deferred):
    # - "direct":  per-batch dispatch and readback in this process.
    # - "recycle": a deferred-readback pool of single-use worker processes
    #   that read their results back in bulk once per epoch; result latency
    #   is bounded by relay_epoch_ms.
    session_mode: str = "direct"
    # recycle mode: worker processes warmed before serving.
    relay_workers: int = 2
    # recycle mode: the epoch budget: a worker retires after this many rows
    # or relay_epoch_ms after its first batch, whichever comes first.
    relay_epoch_images: int = 4096
    relay_epoch_ms: float = 2000.0
    # recycle mode: shared-memory batch slots per worker (batches in flight).
    relay_slots: int = 4
    # Default priority class of requests without an X-Priority header
    # ("interactive" or "batch"); the fleet scheduler ([scheduler] enabled)
    # sheds batch-class work first under overload.
    priority: str = "interactive"
    # Weight paging: True boots this model cold (no parameter slot on the
    # device, nothing captured) until its first request or POST
    # .../{name}:warm stages it through the lifecycle; [scheduler]
    # idle_demote_s demotes it back. Needs [scheduler] enabled.
    cold_start: bool = False
    # Result-cache eligibility: False keeps this model out of the result
    # cache (for models whose results are not a pure function of the item).
    cacheable: bool = True
    # Streaming slow-consumer policy: what the engine does when a stream's
    # bounded emission queue is full because the client reads slowly.
    # "drop" discards DROPPABLE units (progress/preview events, counted in
    # gen_stream_dropped_total; tokens and terminals are never dropped) and
    # blocks only on non-droppable ones; "block" always blocks the step loop.
    stream_policy: str = "drop"
    # One-shot batch retry: a failed dispatch re-assembles and re-runs the
    # batch once before failing its futures.
    batch_retry: bool = True
    # When the whole-batch retry also fails, bisect recursively so a single
    # poison item fails only its own future.
    retry_split: bool = True
    # Circuit breaker: consecutive failed dispatches before the model trips
    # to fast 503 + Retry-After (0 disables); the canary half-opens it.
    breaker_threshold: int = 5
    # Retry-After hint (s) on breaker 503s when no periodic canary runs.
    breaker_retry_after_s: float = 5.0
    # Service-level objective ([model.slo] sub-table).
    slo: SloConfig = field(default_factory=SloConfig)
    # The JAX package's per-model keys the port does not serve yet, as
    # parsed (see unported_settings).
    unported: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """The checks of the typed fields (run again after overrides)."""
        if self.tp < 1 or self.sp < 1:
            raise ValueError(
                f"tp and sp must be >= 1, got tp={self.tp} sp={self.sp}")
        if self.pp < 0:
            raise ValueError(f"pp must be >= 0, got {self.pp}")
        if self.wire_format not in WIRE_FORMATS:
            raise ValueError(f"wire_format must be one of {WIRE_FORMATS}, "
                             f"got {self.wire_format!r}")
        if self.stream_policy not in ("drop", "block"):
            raise ValueError(
                f"stream_policy must be 'drop' or 'block', "
                f"got {self.stream_policy!r}")
        if self.priority not in ("interactive", "batch"):
            raise ValueError(
                f"priority must be 'interactive' or 'batch', "
                f"got {self.priority!r}")
        if self.cold_start and self.session_mode != "direct":
            raise ValueError(
                "cold_start requires session_mode = 'direct' (recycle-mode "
                "workers own their params out of process)")


@dataclass
class ParallelConfig:
    """Multi-device serving plan (``[parallel]`` TOML): a server-wide
    selection of how the serving path uses the devices; a model's
    ``parallelism`` remains the fine-grained knob.

    - ``mode = "replica"`` — N independent one-device runtime replicas,
      params copied per device, the batcher keeping every replica's depth-k
      staging slots full by least-loaded dispatch.
    - ``mode = "sharded"`` — one mesh over the devices, the batch split on
      its data axis.
    - ``mode = "single"`` — the first device only.
    - ``mode = ""`` (default) — every model keeps its own ``parallelism``.

    A non-empty mode overrides every configured model (``pipeline`` ones
    included) but the recycle-mode ones."""

    # "" = respect per-model `parallelism`; "replica" / "sharded" /
    # "single" override every model's mode at build time.
    mode: str = ""
    # Devices the serving path uses; 0 = every visible device.
    n_chips: int = 0
    # Sharded mode: data-axis size; 0 derives it from the device count and
    # the model's tp/sp axes. Setting `data` with n_chips = 0 sizes the
    # mesh to exactly data * tp * sp devices.
    data: int = 0

    def __post_init__(self) -> None:
        if self.mode not in ("", "replica", "sharded", "single"):
            raise ValueError(
                f"parallel.mode must be one of '', 'replica', 'sharded', "
                f"'single'; got {self.mode!r} (pipeline is per-model only)")
        if self.n_chips < 0 or self.data < 0:
            raise ValueError("parallel.n_chips/data must be >= 0")


@dataclass
class DistributedConfig:
    """Multi-process initialization (``[distributed]`` TOML;
    tpuserve_torch.parallel.distributed): with ``coordinator_address`` set,
    startup joins ``torch.distributed``'s process group before any device
    use. Leave it empty for one host."""

    # "host:port" of the process-0 coordinator; "" disables distributed init.
    coordinator_address: str = ""
    # Total process count; -1 = take it from the launcher's environment.
    num_processes: int = -1
    # This process's rank; -1 = take it from the launcher's environment.
    process_id: int = -1


@dataclass
class ServerConfig:
    """Top-level server configuration."""

    host: str = "0.0.0.0"
    port: int = 8000
    # Multi-process init; defaults to one process (disabled).
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    # Multi-device serving plan: replica per device vs sharded batch.
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    models: list[ModelConfig] = field(default_factory=list)
    # HTTP accept loops on the serving port: 1 = the main event loop only;
    # N > 1 adds N-1 ingest event-loop threads, each with its own
    # SO_REUSEPORT listener, whose handlers hop onto the main loop once per
    # request to reach the batchers.
    ingest_loops: int = 1
    # Host-side decode threadpool size.
    decode_threads: int = 8
    # Decode request bodies on the accept loop instead of the threadpool
    # (a single-core host saves the executor hop).
    decode_inline: bool = False
    # The remote-profile listener (the reference's jax.profiler.start_server
    # port): > 0 opens a second HTTP listener on this port whose
    # POST /profile?duration_ms= answers the merged trace POST
    # /debug/profile gives, through the same one-at-a-time capture (409
    # while one is armed). 0 disables. Behind the router each worker's
    # listener takes this port + its worker id.
    profiler_port: int = 0
    # Directory the hand-written CUDA kernels build into and load from (the
    # port's counterpart of the reference's persistent XLA compilation
    # cache); "" = build/kernels at the root of the checkout.
    compilation_cache_dir: str = ""
    # Validate-on-startup canary (tiny inference per model) on/off.
    startup_canary: bool = True
    # Periodic canary interval (s): each model's canary re-runs so /healthz
    # (and the lifecycle's soak monitor) reflect live serving health. 0 off.
    canary_interval_s: float = 0.0
    # Debug mode: check every fetched batch's outputs for NaN/Inf and fail
    # the batch with FloatingPointError. Re-reads every output; dev only.
    debug_nans: bool = False
    # Replay every bucket's graph once at startup (the first launch uploads
    # it to the card) so first requests do not pay it; the graphs are
    # captured either way.
    prewarm_executables: bool = True
    # Per-bucket raw-forward probes at startup (ModelRuntime.probe_all_raw):
    # this many dispatches per bucket, inputs resident. 0 off.
    roofline_probe_iters: int = 0
    # Watchdog sweep interval (s): restart dead group-accumulation tasks
    # (0 disables).
    watchdog_interval_s: float = 1.0
    # Graceful-drain budget on SIGTERM: new requests 503 at once while every
    # accepted request gets this long to finish before the hard stop.
    drain_timeout_s: float = 30.0
    # Retry-After hint (seconds) on 429 shed and drain 503 responses.
    shed_retry_after_s: float = 1.0
    # Pipelined host execution knobs (stage pools, depth, arenas).
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    # Content-addressed result cache + single-flight coalescing (off by
    # default: only correct for models deterministic in their input).
    cache: CacheConfig = field(default_factory=CacheConfig)
    # SLO-aware adaptive batching (AIMD target batch size per group).
    adaptive: AdaptiveConfig = field(default_factory=AdaptiveConfig)
    # Deterministic chaos injection (off by default).
    faults: FaultsConfig = field(default_factory=FaultsConfig)
    # Versioned reload lifecycle (integrity checks, staged canary, rollback).
    lifecycle: LifecycleConfig = field(default_factory=LifecycleConfig)
    # Span ring capacity of the tracer (/debug/trace, /debug/profile).
    trace_capacity: int = 65536
    # Request tracing retention (flight recorder, exemplars).
    trace: TraceConfig = field(default_factory=TraceConfig)
    # Telemetry plane (sampler, history, SLO burn rates, utilization,
    # profiling).
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    # Structured event plane (event ring, logging bridge, audit trail).
    events: EventsConfig = field(default_factory=EventsConfig)
    # Iteration-level generation engine for generative families.
    genserve: GenserveConfig = field(default_factory=GenserveConfig)
    # Router/worker process split (off by default).
    router: RouterConfig = field(default_factory=RouterConfig)
    # Worker-process knobs of the router split (loopback bind, drain).
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    # Fleet scheduler: predictive admission, priority classes, weight
    # paging (off by default).
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    # Per-tenant containment at the front door (off by default).
    tenants: TenantsConfig = field(default_factory=TenantsConfig)
    # Self-healing fleet controller on the primary router (off by default).
    autopilot: AutopilotConfig = field(default_factory=AutopilotConfig)
    # Emit one JSON object per log line instead of the human-readable
    # default.
    log_json: bool = False
    # The JAX package's settings the port does not serve yet, as parsed:
    # "[table] key" for its tables, the bare key for top-level keys.
    unported: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.ingest_loops < 1:
            raise ValueError(
                f"ingest_loops must be >= 1, got {self.ingest_loops}")

    def model(self, name: str) -> ModelConfig:
        for m in self.models:
            if m.name == name:
                return m
        raise KeyError(f"no model named {name!r} configured")


# The observability tables, [genserve], [router], [worker], [scheduler],
# [autopilot], [parallel] and [distributed], typed by TOML table name
# ([tenants] nests its entries and is built on its own).
TYPED_TABLES = {"trace": TraceConfig, "telemetry": TelemetryConfig,
                "events": EventsConfig, "genserve": GenserveConfig,
                "router": RouterConfig, "worker": WorkerConfig,
                "scheduler": SchedulerConfig, "autopilot": AutopilotConfig,
                "parallel": ParallelConfig, "distributed": DistributedConfig}


def unported_settings(cfg: ServerConfig) -> list[str]:
    """The settings of ``cfg`` that ask for behaviour the port lacks, as
    ``name = value`` strings (empty when the port serves all of ``cfg``)."""
    out = []
    for name, value in cfg.unported.items():
        if name.startswith("["):
            table, _, key = name[1:].partition("] ")
            accepted = _TABLE_OFF.get(key, ())
        else:
            accepted = _SERVER_UNPORTED[name]
        if value not in accepted:
            out.append(f"{name} = {value!r}")
    for m in cfg.models:
        out += [f"model {m.name}: {k} = {v!r}" for k, v in m.unported.items()
                if v not in _MODEL_UNPORTED[k]]
    if cfg.faults.enabled:
        out += [f"[[faults.rule]] kind = {r.kind!r} (not yet ported "
                f"({_FAULT_KINDS_UNPORTED[r.kind]}))"
                for r in cfg.faults.rules if r.kind in _FAULT_KINDS_UNPORTED]
    return out


def _build(cls: type, data: dict[str, Any], unported: dict[str, tuple] | None = None) -> Any:
    """Construct dataclass ``cls`` from a dict, erroring on unknown keys;
    keys named in ``unported`` go to the instance's ``unported`` dict."""
    names = {f.name for f in dataclasses.fields(cls)} - {"unported"}
    rest = {k: v for k, v in data.items() if k not in names}
    unknown = set(rest) - set(unported or ())
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    obj = cls(**{k: v for k, v in data.items() if k in names})
    if rest:
        obj.unported = rest
    return obj


def load_config(path: str | None = None, overrides: list[str] | None = None) -> ServerConfig:
    """Load a ServerConfig from a TOML file plus ``key.path=value`` overrides.

    Overrides use dot paths, e.g. ``port=9000``,
    ``model.bert.deadline_ms=2.5`` (the second path element selects the
    model by name) or ``adaptive.enabled=false``. Values are parsed as TOML
    scalars/arrays.
    """
    raw: dict[str, Any] = {}
    if path:
        with open(path, "rb") as f:
            raw = tomllib.load(f)

    model_dicts = raw.pop("model", [])
    pipeline_dict = raw.pop("pipeline", None)
    faults_dict = raw.pop("faults", None)
    lifecycle_dict = raw.pop("lifecycle", None)
    cache_dict = raw.pop("cache", None)
    adaptive_dict = raw.pop("adaptive", None)
    tenants_dict = raw.pop("tenants", None)
    typed_dicts = {t: raw.pop(t) for t in TYPED_TABLES if t in raw}
    tables = {t: raw.pop(t) for t in UNPORTED_TABLES if t in raw}
    cfg: ServerConfig = _build(ServerConfig, raw, _SERVER_UNPORTED)
    models = []
    for m in model_dicts:
        # [model.slo] is a nested sub-table of its [[model]] entry.
        slo_dict = m.pop("slo", None)
        mc = _build(ModelConfig, m, _MODEL_UNPORTED)
        if slo_dict is not None:
            mc.slo = _build(SloConfig, slo_dict)
        models.append(mc)
    cfg.models = models
    for table, data in typed_dicts.items():
        setattr(cfg, table, _build(TYPED_TABLES[table], data))
    if pipeline_dict is not None:
        cfg.pipeline = _build(PipelineConfig, pipeline_dict)
    if lifecycle_dict is not None:
        cfg.lifecycle = _build(LifecycleConfig, lifecycle_dict)
    if cache_dict is not None:
        cfg.cache = _build(CacheConfig, cache_dict)
    if adaptive_dict is not None:
        cfg.adaptive = _build(AdaptiveConfig, adaptive_dict)
    if tenants_dict is not None:
        # [[tenants.tenant]] entries are nested sub-tables of [tenants].
        tenant_dicts = tenants_dict.pop("tenant", [])
        cfg.tenants = _build(TenantsConfig, tenants_dict)
        cfg.tenants.tenants = [_build(TenantConfig, t) for t in tenant_dicts]
        cfg.tenants.__post_init__()  # uniqueness, with the entries set
    if faults_dict is not None:
        rule_dicts = faults_dict.pop("rule", [])
        cfg.faults = _build(FaultsConfig, faults_dict)
        cfg.faults.rules = [_build(FaultRuleConfig, r) for r in rule_dicts]
    for table, keys in tables.items():
        cfg.unported.update({f"[{table}] {k}": v for k, v in keys.items()})

    for ov in overrides or []:
        _apply_override(cfg, ov)
    for m in cfg.models:
        m.validate()
    return cfg


def _parse_toml_value(text: str) -> Any:
    try:
        return tomllib.loads(f"v = {text}")["v"]
    except tomllib.TOMLDecodeError:
        return text  # bare string


def _apply_override(cfg: ServerConfig, override: str) -> None:
    if "=" not in override:
        raise ValueError(f"override must look like key.path=value, got {override!r}")
    key, _, text = override.partition("=")
    value = _parse_toml_value(text.strip())
    parts = key.strip().split(".")

    target: Any = cfg
    unported = _SERVER_UNPORTED
    if parts[0] == "model":
        if len(parts) < 3:
            raise ValueError(f"model override needs model.<name>.<field>: {override!r}")
        target = cfg.model(parts[1])
        parts = parts[2:]
        unported = _MODEL_UNPORTED
    elif parts[0] in UNPORTED_TABLES and len(parts) == 2:
        cfg.unported[f"[{parts[0]}] {parts[1]}"] = value
        return
    if len(parts) == 1 and parts[0] in unported:
        target.unported[parts[0]] = value
        return
    for p in parts[:-1]:
        target = target[p] if isinstance(target, dict) else getattr(target, p)
    leaf = parts[-1]
    if isinstance(target, dict):  # e.g. model.<name>.options.<key>
        target[leaf] = value
        return
    if dataclasses.is_dataclass(target) and leaf not in {f.name for f in dataclasses.fields(target)}:
        raise ValueError(f"unknown config field {leaf!r} in {type(target).__name__}")
    setattr(target, leaf, value)
