"""Defaults of the port's config against the reference's (``tpuserve/config.py``).

The port refuses every setting it does not serve, by name. That protects a
key written in the TOML; a key left out takes the reference's default, so a
default that switches a feature ON that the port lacks would make the two
servers behave differently on the same file with no refusal at all. These
tests hold, for every example the port serves and for every key the port
still refuses:

- each typed field of the port equals the reference's value for the same
  file (defaults included);
- for each key the port refuses (``_SERVER_UNPORTED``, ``_MODEL_UNPORTED``,
  the switch of each table in ``UNPORTED_TABLES``; and the router's host,
  peer and scaling keys, served now), the reference's default is a value the port accepts —
  or the key is in ``OBSERVABILITY``, the explicit list of reference
  defaults the port does not serve yet, each of which the port indeed
  refuses when written. The list is empty: since the port serves request
  tracing and the events and telemetry planes, every reference default is
  served;
- the keys of the observability tables (``[trace]``, ``[events]``,
  ``[telemetry]``, ``[model.slo]`` and ``trace_capacity``) are typed with
  the reference's defaults, the router's ``[telemetry] fleet_timeout_ms``
  included, and served when written;
- the process tier's keys (every field of ``[router]`` and ``[worker]``),
  the worker black box's ``[events]`` keys and the server's small keys
  (``log_json``, ``debug_nans``, ``prewarm_executables``,
  ``compilation_cache_dir``), typed since the router/worker tier was
  ported, hold the reference's defaults and are served when written; the
  router's host, peer and scaling keys since host failure domains and peer
  routers were ported;
- every field of the reference's server, model and table configs is known
  to the port (typed or refused), so no key slips through unnamed;
- ``[genserve]``, typed since the generation engine was ported, holds the
  reference's defaults and refuses nothing since streaming was ported; the
  streaming keys (``stream_queue``, ``stream_heartbeat_s``,
  ``stream_drain_s``, the model's ``stream_policy``) are typed with the
  reference's defaults and served when written;
- every field of ``[scheduler]``, ``[tenants]`` (and its
  ``[[tenants.tenant]]`` entries) and ``[autopilot]``, and the model's
  ``priority`` and ``cold_start``, typed since the fleet scheduler, tenants
  and the autopilot were ported, holds the reference's default and is
  served when written;
- deferred mode's model keys (``session_mode`` and the four ``relay_*``),
  typed since deferred mode was ported, hold the reference's defaults and
  are served when written;
- ``profiler_port``, typed since the remote-profile listener was ported,
  holds the reference's default and is served when written.

Exact: the values are compared with ``==``.
"""

import dataclasses
import json

import pytest

from tpuserve import config as jconfig
from tpuserve_torch import config as tconfig

EXAMPLES = ("examples/bert_flash.toml", "examples/bert_long_ring.toml",
            "examples/resnet50.toml", "examples/mobilenetv3.toml",
            "examples/efficientdet.toml", "examples/textgen_flash.toml",
            "examples/textgen_moe_flash.toml", "examples/bert_moe_flash.toml",
            "examples/sd15_flash.toml", "examples/bert_flash_router.toml",
            "examples/textgen_flash_router.toml", "examples/bert_flash_hosts.toml",
            "examples/bert_fleet.toml", "examples/bert_flash_tenants.toml",
            "examples/bert_flash_recycle.toml")

# The reference's defaults that turn on a feature the port does not serve
# yet, each refused by the port when written out: none.
OBSERVABILITY: set[str] = set()

# The switch of each unported table: the key whose reference default says
# whether the feature is on.
TABLE_SWITCH = {"parallel": "[parallel] mode",
                "distributed": "[distributed] coordinator_address"}
TABLE_CLASS = {"autopilot": "AutopilotConfig", "distributed": "DistributedConfig",
               "genserve": "GenserveConfig", "parallel": "ParallelConfig",
               "router": "RouterConfig", "scheduler": "SchedulerConfig",
               "tenants": "TenantsConfig", "worker": "WorkerConfig"}

# The typed observability tables: the port's class and the reference's.
OBS_TABLES = {"trace": "TraceConfig", "events": "EventsConfig",
              "telemetry": "TelemetryConfig", "slo": "SloConfig"}


def _jax_default(name: str):
    """The reference's default for a refused key ("[table] key", a server
    key, or "model <key>")."""
    if name.startswith("["):
        table, key = name[1:].split("] ")
        return getattr(getattr(jconfig.ServerConfig(), table), key)
    if name.startswith("model "):
        value = getattr(jconfig.ModelConfig(name="m"), name[len("model "):])
        return dataclasses.asdict(value) if dataclasses.is_dataclass(value) else value
    return getattr(jconfig.ServerConfig(), name)


def _port_refuses(name: str, value) -> bool:
    """Does the port refuse ``name`` written out with ``value``? (A key of a
    typed table is written through ``load_config``'s override.)"""
    cfg = tconfig.ServerConfig(models=[tconfig.ModelConfig(name="m")])
    if name in SERVED_TIER_KEYS or (name in SERVED_FLEET_KEYS and name.startswith("[")):
        table, key = name[1:].split("] ")
        cfg = tconfig.load_config(None, [f"{table}.{key}={json.dumps(value)}"])
        assert getattr(getattr(cfg, table), key) == value
    elif name in SERVED_FLEET_KEYS or name in SERVED_DEFERRED_KEYS:
        key = name[len("model "):]
        setattr(cfg.models[0], key, value)
        cfg.models[0].validate()
        assert key not in tconfig._MODEL_UNPORTED
    elif name.startswith("model "):
        cfg.models[0].unported = {name[len("model "):]: value}
    elif name in SERVED_SERVER_KEYS:
        setattr(cfg, name, value)
        assert name not in tconfig._SERVER_UNPORTED
    else:
        cfg.unported = {name: value}
    return bool(tconfig.unported_settings(cfg))


def _switch(table: str) -> str:
    return TABLE_SWITCH.get(table, f"[{table}] enabled")


# The router's host, peer and scaling keys: refused off the reference's
# default until host failure domains and peer routers were ported, served
# since (their reference default among them).
SERVED_TIER_KEYS = [f"[router] {k}" for k in (
    "active_workers", "host_breaker_cooldown_s", "host_breaker_threshold", "hosts",
    "peer_port", "peer_sync_interval_s", "routers")]
# The fleet scheduler's, the tenants' and the autopilot's switches and the
# model's paging keys: refused off the reference's default until they were
# ported, served since.
SERVED_FLEET_KEYS = ["[autopilot] enabled", "[scheduler] enabled", "[tenants] enabled",
                     "model cold_start", "model priority"]

# Deferred mode's model keys: refused off the reference's default until
# deferred mode was ported, served since.
SERVED_DEFERRED_KEYS = [f"model {k}" for k in (
    "relay_epoch_images", "relay_epoch_ms", "relay_slots", "relay_workers", "session_mode")]

# The remote-profile listener's key: refused until it was ported, served
# since.
SERVED_SERVER_KEYS = ["profiler_port"]

REFUSED = sorted(tconfig._SERVER_UNPORTED) + SERVED_SERVER_KEYS \
    + [f"model {k}" for k in sorted(tconfig._MODEL_UNPORTED)] \
    + sorted({_switch(t) for t in tconfig.UNPORTED_TABLES}) + SERVED_TIER_KEYS \
    + SERVED_FLEET_KEYS + SERVED_DEFERRED_KEYS


@pytest.mark.parametrize("name", REFUSED)
def test_refused_key_default_is_accepted_or_listed(name):
    """The reference's default of a key the port refuses asks for nothing the
    port lacks, or the key is named in OBSERVABILITY (and then refused)."""
    default = _jax_default(name)
    if name in OBSERVABILITY:
        assert _port_refuses(name, default), name
    else:
        assert not _port_refuses(name, default), (name, default)


def test_observability_list_is_exactly_the_unserved_defaults():
    refused_defaults = {n for n in REFUSED if _port_refuses(n, _jax_default(n))}
    assert refused_defaults == OBSERVABILITY


@pytest.mark.parametrize("name", [
    "[adaptive] enabled", "[cache] enabled", "model batch_retry", "model retry_split",
    "model breaker_threshold", "model breaker_retry_after_s", "model cacheable",
    "watchdog_interval_s", "drain_timeout_s", "ingest_loops", "decode_inline"])
def test_robustness_keys_are_typed_with_the_reference_default(name):
    """The keys whose reference default switched a feature on are typed in
    the port now, with that default, and never refused."""
    if name.startswith("["):
        table, key = name[1:].split("] ")
        port = getattr(getattr(tconfig.ServerConfig(), table), key)
    elif name.startswith("model "):
        port = getattr(tconfig.ModelConfig(name="m"), name[len("model "):])
    else:
        port = getattr(tconfig.ServerConfig(), name)
    assert port == _jax_default(name)
    key = name.split("] ")[-1].replace("model ", "")
    assert key not in tconfig._SERVER_UNPORTED and key not in tconfig._MODEL_UNPORTED
    assert "adaptive" not in tconfig.UNPORTED_TABLES and "cache" not in tconfig.UNPORTED_TABLES


@pytest.mark.parametrize("name", [
    "[genserve] stream_queue", "[genserve] stream_heartbeat_s",
    "[genserve] stream_drain_s", "model stream_policy"])
def test_streaming_keys_are_typed_with_the_reference_default(name):
    """Streaming's keys, refused off their defaults until streamed
    generation was ported, are typed in the port now with the reference's
    default, and never refused."""
    if name.startswith("["):
        table, key = name[1:].split("] ")
        port = getattr(getattr(tconfig.ServerConfig(), table), key)
    else:
        key = name[len("model "):]
        port = getattr(tconfig.ModelConfig(name="m"), key)
    assert port == _jax_default(name)
    assert key not in tconfig._MODEL_UNPORTED
    cfg = tconfig.load_config(None, [f"genserve.{key}={json.dumps(port)}"]
                              if name.startswith("[") else None)
    assert tconfig.unported_settings(cfg) == []


@pytest.mark.parametrize("path", EXAMPLES)
def test_served_examples_type_what_the_reference_reads(path):
    """Every typed field of the port equals the reference's value for the
    same file, and the port serves the file as it is."""
    cfg, jcfg = tconfig.load_config(path), jconfig.load_config(path)
    assert tconfig.unported_settings(cfg) == []
    for f in dataclasses.fields(tconfig.ServerConfig):
        if f.name not in ("models", "unported"):
            port, ref = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(port):
                port, ref = dataclasses.asdict(port), dataclasses.asdict(ref)
            assert port == ref, (path, f.name)
    for m, jm in zip(cfg.models, jcfg.models, strict=True):
        for f in dataclasses.fields(tconfig.ModelConfig):
            if f.name != "unported":
                port, ref = getattr(m, f.name), getattr(jm, f.name)
                if dataclasses.is_dataclass(port):  # [model.slo]
                    port, ref = dataclasses.asdict(port), dataclasses.asdict(ref)
                assert port == ref, (path, m.name, f.name)


@pytest.mark.parametrize("cls, refused", [
    ("ServerConfig", set(tconfig._SERVER_UNPORTED) | set(tconfig.UNPORTED_TABLES)),
    ("ModelConfig", set(tconfig._MODEL_UNPORTED))])
def test_every_reference_key_is_typed_or_refused(cls, refused):
    typed = {f.name for f in dataclasses.fields(getattr(tconfig, cls))} - {"unported"}
    ref = {f.name for f in dataclasses.fields(getattr(jconfig, cls))}
    assert ref - typed == refused


@pytest.mark.parametrize("table", sorted(TABLE_CLASS))
def test_unported_table_keys_parse_as_refused(table, tmp_path):
    """Each key of an unported table parses into the port's unported dict
    under its name, and is refused when it asks for anything. [genserve] is
    typed since the generation engine was ported and refuses nothing since
    streaming was: each of its keys written parses typed and is served.
    [router] and [worker] are typed since the router/worker tier was
    ported: each key written parses typed and, since host failure domains
    and peer routers were ported, is served; [scheduler], [tenants] and
    [autopilot] likewise since the fleet scheduler, tenants and the
    autopilot were ported, and [parallel] and [distributed] since the mesh
    modes were."""
    if table in ("router", "worker", "scheduler", "tenants", "autopilot",
                 "parallel", "distributed"):
        assert table not in tconfig.UNPORTED_TABLES
        for f in dataclasses.fields(getattr(tconfig, TABLE_CLASS[table])):
            if f.default is dataclasses.MISSING:
                continue  # [tenants]' entry list: [[tenants.tenant]] tables
            # A value other than the default (active_workers stays <= workers;
            # the autopilot's pressure_low stays below pressure_high, the
            # scheduler's min_share below 0.5).
            value = (not f.default if isinstance(f.default, bool)
                     else "127.0.0.2" if isinstance(f.default, str)
                     else {"pressure_low": 0.5, "min_share": 0.1,
                           "slo_availability": 0.99}.get(f.name, f.default * 2 + 1))
            cfg = tconfig.load_config(None, [f"{table}.{f.name}={json.dumps(value)}"])
            assert getattr(getattr(cfg, table), f.name) == value, f.name
            assert cfg.unported == {} and tconfig.unported_settings(cfg) == [], f.name
        return
    if table == "genserve":
        assert table not in tconfig.UNPORTED_TABLES
        for f in dataclasses.fields(tconfig.GenserveConfig):
            if isinstance(f.default, bool) or not isinstance(f.default, (int, float)):
                continue
            cfg = tconfig.load_config(None, [f"{table}.{f.name}=12345"])
            assert getattr(cfg.genserve, f.name) == 12345
            assert cfg.unported == {}
            assert tconfig.unported_settings(cfg) == []
        return
    assert table in tconfig.UNPORTED_TABLES
    fields = dataclasses.fields(getattr(jconfig, TABLE_CLASS[table]))
    scalar = [f.name for f in fields if isinstance(getattr(
        getattr(jconfig.ServerConfig(), table), f.name), (bool, int, float, str))]
    assert scalar, table
    key = scalar[-1]
    cfg = tconfig.load_config(None, [f"{table}.{key}=12345"])
    assert cfg.unported == {f"[{table}] {key}": 12345}
    assert tconfig.unported_settings(cfg) == [f"[{table}] {key} = 12345"]


OBS_KEYS = ["trace_capacity"] + [
    f"{'model slo' if t == 'slo' else f'[{t}]'} {f.name}"
    for t, cls in OBS_TABLES.items() for f in dataclasses.fields(getattr(jconfig, cls))]


def _port_obs_default(name: str):
    if name.startswith("model slo "):
        return getattr(tconfig.ModelConfig(name="m").slo, name.split()[-1])
    if name.startswith("["):
        table, key = name[1:].split("] ")
        return getattr(getattr(tconfig.ServerConfig(), table), key)
    return getattr(tconfig.ServerConfig(), name)


def _ref_obs_default(name: str):
    if name.startswith("model slo "):
        return getattr(jconfig.ModelConfig(name="m").slo, name.split()[-1])
    return _jax_default(name)


@pytest.mark.parametrize("name", OBS_KEYS)
def test_observability_keys_are_typed_with_the_reference_default(name):
    """Every key of the reference's observability tables (and
    trace_capacity) is a typed field of the port with the reference's
    default, which the port serves: no refusal."""
    assert _port_obs_default(name) == _ref_obs_default(name)
    assert name not in tconfig._SERVER_UNPORTED
    cfg = tconfig.ServerConfig(models=[tconfig.ModelConfig(name="m")])
    assert tconfig.unported_settings(cfg) == []
    assert not {"trace", "events", "telemetry"} & set(tconfig.UNPORTED_TABLES)
    assert "slo" not in tconfig._MODEL_UNPORTED


@pytest.mark.parametrize("name, value", [("telemetry.fleet_timeout_ms", 2000.0)])
def test_worker_tier_keys_of_typed_tables_are_refused_when_written(name, value):
    """The router's fleet scrape reads this: refused when written until the
    fleet scrape was ported, served since (the typed field takes the value,
    nothing is refused)."""
    table, key = name.split(".")
    cfg = tconfig.load_config(None, [f"{name}={value!r}" if isinstance(value, str)
                                     else f"{name}={value}"])
    assert getattr(getattr(cfg, table), key) == value
    assert cfg.unported == {} and tconfig.unported_settings(cfg) == []


@pytest.mark.parametrize("key, value, axis", [
    ("sp", "2", "seq"),
    ("tp", "2", "model")])
def test_sd15_example_refuses_unserved_options_by_name(key, value, axis, tmp_path,
                                                       monkeypatch):
    """``examples/sd15_flash.toml`` builds (its module on the meta device),
    and so does the example with either mesh axis the port once refused
    by name written in: a seq axis (sp = 2), its work replicated, and a
    model axis (tp = 2), a module per model rank. The server builds each
    over two ranks (the example at tiny widths: the full one takes minutes
    on the CPU)."""
    from tpuserve_torch.models import build
    from tpuserve_torch.parallel import mesh as meshlib
    from tpuserve_torch.server import ServerState

    cfg = tconfig.load_config("examples/sd15_flash.toml")
    import torch

    with torch.device("meta"):
        build(cfg.models[0]).build_module()
    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * 2)
    sets = [f"model.sd15.{key}={value}", "model.sd15.parallelism='sharded'",
            "model.sd15.image_size=32", "model.sd15.batch_buckets=[1]",
            *(f"model.sd15.options.{k}={v}" for k, v in (
                ("steps", 2), ("text_layers", 1), ("unet_ch", 16), ("vae_ch", 16),
                ("vocab_size", 512), ("text_d_model", 32), ("text_heads", 2),
                ("unet_mults", [1, 2]), ("unet_res", 1), ("unet_attn_levels", [0]),
                ("unet_heads", 2), ("vae_mults", [1, 2])))]
    state = ServerState(tconfig.load_config("examples/sd15_flash.toml", sets), device="cpu")
    state.build()
    assert dict(state.runtimes["sd15"].mesh.shape)[axis] == 2


# Keys typed since the router/worker tier was ported: every field of
# [router] and [worker], the worker black box's [events] keys and the
# server's small keys.
PROCESS_TIER_KEYS = (
    [f"[router] {f.name}" for f in dataclasses.fields(tconfig.RouterConfig)]
    + [f"[worker] {f.name}" for f in dataclasses.fields(tconfig.WorkerConfig)]
    + ["[events] dir", "[events] stderr_path", "[events] snapshot_path",
       "log_json", "debug_nans", "prewarm_executables", "compilation_cache_dir"])


@pytest.mark.parametrize("name", PROCESS_TIER_KEYS)
def test_process_tier_keys_are_typed_with_the_reference_default(name):
    """Each key is a typed field of the port holding the reference's
    default, and that default is served (no refusal); the server's small
    keys are no longer in the refusal table."""
    if name.startswith("["):
        table, key = name[1:].split("] ")
        port = getattr(getattr(tconfig.ServerConfig(), table), key)
        assert table not in tconfig.UNPORTED_TABLES
    else:
        key = name
        port = getattr(tconfig.ServerConfig(), name)
        assert name not in tconfig._SERVER_UNPORTED
    assert port == _jax_default(name)
    cfg = tconfig.ServerConfig(models=[tconfig.ModelConfig(name="m")])
    assert tconfig.unported_settings(cfg) == []
    if name.startswith("["):
        written = tconfig.load_config(None, [f"{table}.{key}={json.dumps(port)}"])
        assert written.unported == {} and tconfig.unported_settings(written) == []


ROUTER_SERVED = [k.split("] ")[1] for k in SERVED_TIER_KEYS]


@pytest.mark.parametrize("key", ROUTER_SERVED)
def test_unserved_router_values_are_refused_by_name(key, tmp_path):
    """The router's host failure domains, peer routers and host scaling
    slots: refused off the reference's default until they were ported;
    served since. Off the default, a router deployment's file loads typed
    with nothing refused, and the server builds on it."""
    from tpuserve_torch.server import ServerState

    default = getattr(tconfig.RouterConfig(), key)
    value = {"active_workers": 1, "routers": 2, "hosts": 2}.get(key, default * 2 or 1)
    path = tmp_path / "c.toml"
    path.write_text(f"[router]\nenabled = true\n{key} = {json.dumps(value)}\n")
    cfg = tconfig.load_config(str(path))
    assert getattr(cfg.router, key) == value
    assert cfg.unported == {} and tconfig.unported_settings(cfg) == []
    ServerState(cfg, device="cpu")


FLEET_CLASSES = {"scheduler": "SchedulerConfig", "tenants": "TenantsConfig",
                 "autopilot": "AutopilotConfig", "tenant": "TenantConfig"}
FLEET_FIELDS = [(t, f.name) for t, cls in FLEET_CLASSES.items()
                for f in dataclasses.fields(getattr(jconfig, cls))]


@pytest.mark.parametrize("table, key", FLEET_FIELDS)
def test_fleet_keys_are_typed_with_the_reference_default(table, key):
    """Every field of [scheduler], [tenants] (its [[tenants.tenant]]
    entries too) and [autopilot] is a typed field of the port holding the
    reference's default, and that default is served: the tables are out of
    UNPORTED_TABLES and a config of defaults refuses nothing."""
    if table == "tenant":
        port = getattr(tconfig.TenantConfig(name="t", api_key="k"), key)
        ref = getattr(jconfig.TenantConfig(name="t", api_key="k"), key)
    else:
        assert table not in tconfig.UNPORTED_TABLES
        port = getattr(getattr(tconfig.ServerConfig(), table), key)
        ref = getattr(getattr(jconfig.ServerConfig(), table), key)
    assert port == ref, (table, key)
    assert tconfig.unported_settings(tconfig.ServerConfig(
        models=[tconfig.ModelConfig(name="m")])) == []
