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
  the switch of each table in ``UNPORTED_TABLES`` and the worker-tier keys
  of typed tables), the reference's default is a value the port accepts —
  or the key is in ``OBSERVABILITY``, the explicit list of reference
  defaults the port does not serve yet, each of which the port indeed
  refuses when written. The list is empty: since the port serves request
  tracing and the events and telemetry planes, every reference default is
  served;
- the keys of the observability tables (``[trace]``, ``[events]``,
  ``[telemetry]``, ``[model.slo]`` and ``trace_capacity``) are typed with
  the reference's defaults, and the worker-tier keys among them are
  refused when written;
- every field of the reference's server, model and table configs is known
  to the port (typed or refused), so no key slips through unnamed.

Exact: the values are compared with ``==``.
"""

import dataclasses

import pytest

from tpuserve import config as jconfig
from tpuserve_torch import config as tconfig

EXAMPLES = ("examples/bert_flash.toml", "examples/bert_long_ring.toml",
            "examples/resnet50.toml", "examples/mobilenetv3.toml")

# The reference's defaults that turn on a feature the port does not serve
# yet, each refused by the port when written out: none.
OBSERVABILITY: set[str] = set()

# The switch of each unported table: the key whose reference default says
# whether the feature is on. [worker] has no switch of its own: it
# configures processes that exist only behind [router].
TABLE_SWITCH = {"parallel": "[parallel] mode",
                "distributed": "[distributed] coordinator_address",
                "worker": "[router] enabled"}
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
    """Does the port refuse ``name`` written out with ``value``?"""
    cfg = tconfig.ServerConfig(models=[tconfig.ModelConfig(name="m")])
    if name.startswith("model "):
        cfg.models[0].unported = {name[len("model "):]: value}
    else:
        cfg.unported = {name: value}
    return bool(tconfig.unported_settings(cfg))


def _switch(table: str) -> str:
    return TABLE_SWITCH.get(table, f"[{table}] enabled")


# The worker-tier keys of typed tables refused while non-empty. (The
# router's [telemetry] fleet_timeout_ms is refused whenever written, so its
# default, never written, is not a refused value.)
TIER_KEYS = sorted(f"[{t}] {k}" for t, keys in tconfig._TABLE_KEYS_UNPORTED.items()
                   for k, accepted in keys.items() if accepted)

REFUSED = sorted(tconfig._SERVER_UNPORTED) \
    + [f"model {k}" for k in sorted(tconfig._MODEL_UNPORTED)] \
    + sorted({_switch(t) for t in tconfig.UNPORTED_TABLES}) + TIER_KEYS


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
    under its name, and is refused when it asks for anything."""
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


@pytest.mark.parametrize("name, value", [
    ("events.dir", "/tmp/bb"), ("events.stderr_path", "w0.stderr"),
    ("events.snapshot_path", "w0.json"), ("telemetry.fleet_timeout_ms", 2000.0)])
def test_worker_tier_keys_of_typed_tables_are_refused_when_written(name, value):
    """The reference's worker and router tiers read these; written, the port
    refuses them by name (the typed field still takes the value)."""
    table, key = name.split(".")
    cfg = tconfig.load_config(None, [f"{name}={value!r}" if isinstance(value, str)
                                     else f"{name}={value}"])
    assert getattr(getattr(cfg, table), key) == value
    assert tconfig.unported_settings(cfg) == [f"[{table}] {key} = {value!r}"]
