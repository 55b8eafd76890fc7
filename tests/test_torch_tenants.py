"""Tenant containment (``tpuserve_torch.scheduler.tenants`` and the cache's
tenant partition) against the reference's: each scenario of
``tests/test_tenants.py`` runs on both packages with the same tenants,
charges and admission sequence, and every admission decision (status,
reason, Retry-After, message), the usage view and the cache partition are
held EXACTLY equal to the reference's, beside the reference's own
expectations. Then the front door: the port's server and the reference's
on the same ``[tenants]`` config, over HTTP — 401 ``tenant_unknown``, 429
``tenant_rate_exceeded`` with its Retry-After and body, the per-tenant
charge, and ``GET /tenants`` (``?tenant=``, 404, 400) — equal.
"""

import asyncio
import io
from types import SimpleNamespace

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import cache as jcache
from tpuserve import config as jconfig
from tpuserve import obs as jobs
from tpuserve.scheduler import tenants as jtenants
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve_torch import cache as tcache
from tpuserve_torch import config as tconfig
from tpuserve_torch import obs as tobs
from tpuserve_torch.scheduler import tenants as ttenants
from tpuserve_torch.server import ServerState, start_server, stop_server

PKGS = {"jax": SimpleNamespace(cfg=jconfig, obs=jobs, tenants=jtenants, cache=jcache),
        "port": SimpleNamespace(cfg=tconfig, obs=tobs, tenants=ttenants, cache=tcache)}


def tenants_cfg(ns, **over):
    base = dict(enabled=True, window_s=60.0, tenants=[
        ns.cfg.TenantConfig(name="alpha", api_key="key-alpha", weight=3.0),
        ns.cfg.TenantConfig(name="beta", api_key="key-beta", weight=1.0,
                            quota_device_s=2.0, rate_per_s=2.0, burst=2.0)])
    base.update(over)
    return ns.cfg.TenantsConfig(**base)


def ledger(ns, **over):
    return ns.tenants.TenantLedger(tenants_cfg(ns, **over), ns.obs.Metrics())


def shed(s) -> tuple | None:
    """Everything a refusal carries, for the exact comparison."""
    return None if s is None else (s.status, s.reason, s.message, s.retry_after)


def both(scenario):
    out = {pkg: scenario(ns) for pkg, ns in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# -- identity ------------------------------------------------------------------------

@pytest.mark.parametrize("key,expect", [
    ("key-alpha", "alpha"), ("key-beta", "beta"), ("key-nope", None), ("", None), (None, None)])
def test_resolve(key, expect):
    assert both(lambda ns: ledger(ns).resolve(key)) == expect


def test_resolve_anonymous_fallback():
    def scenario(ns):
        led = ledger(ns, allow_anonymous="anon")
        return (led.resolve(None), led.resolve("key-nope"), led.resolve("key-alpha"),
                led.names(), led.weight_of("anon"), shed(led.admit("anon")))

    assert both(scenario) == ("anon", "anon", "alpha", ["alpha", "anon", "beta"], 1.0, None)


def test_shed_unknown_is_401():
    got = both(lambda ns: shed(ledger(ns).shed_unknown()))
    assert got[:2] == (401, "tenant_unknown") and got[3] is None


def test_names_weights():
    def scenario(ns):
        led = ledger(ns)
        return led.names(), led.weights(), led.weight_of("alpha"), led.weight_of("ghost")

    assert both(scenario) == (["alpha", "beta"], {"alpha": 3.0, "beta": 1.0}, 3.0, 1.0)


# -- rate --------------------------------------------------------------------------

def test_rate_token_bucket_exhausts():
    def scenario(ns):
        led = ledger(ns)
        return [shed(led.admit("beta")) for _ in range(3)]

    first, second, third = both(scenario)
    assert first is None and second is None
    assert third[:2] == (429, "tenant_rate_exceeded") and third[3] >= 1


def test_no_rate_limit_when_unset():
    def scenario(ns):
        led = ledger(ns)
        return [shed(led.admit("alpha")) for _ in range(100)]

    assert both(scenario) == [None] * 100


# -- quota -------------------------------------------------------------------------

def test_quota_window_device_seconds():
    def scenario(ns):
        led = ledger(ns)
        led.record("beta", 2.5)  # past the 2.0 device-second allowance
        return shed(led.admit("beta")), shed(led.admit("alpha"))

    beta, alpha = both(scenario)
    assert beta[:2] == (429, "tenant_quota_exceeded") and 1 <= beta[3] <= 30
    assert alpha is None  # the neighbour is untouched


def test_quota_under_allowance_admits():
    def scenario(ns):
        led = ledger(ns)
        led.record("beta", 1.0)
        return shed(led.admit("beta"))

    assert both(scenario) is None


def test_record_clamps_negative_charge():
    def scenario(ns):
        led = ledger(ns)
        led.record("beta", -5.0)
        return led.usage()["tenants"]["beta"]["window_device_s"]

    assert both(scenario) == 0.0


# -- fair share ----------------------------------------------------------------------

def test_share_shed_only_under_saturation():
    def scenario(ns):
        led = ledger(ns)
        led.record("beta", 1.5)
        led.record("alpha", 0.01)
        calm = shed(led.admit("beta"))
        led.saturated_fn = lambda: True
        return calm, shed(led.admit("beta")), shed(led.admit("alpha"))

    calm, saturated, alpha = both(scenario)
    assert calm is None and saturated[1] == "tenant_share_exceeded" and alpha is None


def test_share_shed_disabled_by_zero_slack():
    def scenario(ns):
        led = ledger(ns, share_slack=0.0)
        led.saturated_fn = lambda: True
        led.record("beta", 1.5)
        return shed(led.admit("beta"))

    assert both(scenario) is None


# -- usage view ----------------------------------------------------------------------

def test_usage_shape_and_counts():
    def scenario(ns):
        led = ledger(ns)
        first = shed(led.admit("alpha"))
        led.record("alpha", 0.25)
        u = led.usage()
        led.record("beta", 99.0)
        refused = shed(led.admit("beta"))
        return first, u, refused, led.usage()["tenants"]["beta"]["admitted_total"]

    first, u, refused, beta_admitted = both(scenario)
    assert first is None and u["enabled"] is True and u["window_s"] == 60.0
    row = u["tenants"]["alpha"]
    assert row["weight"] == 3.0 and row["admitted_total"] == 1
    assert row["window_device_s"] == pytest.approx(0.25)
    assert row["device_seconds_total"] == pytest.approx(0.25)
    assert refused is not None and beta_admitted == 0  # refusals never admit


def test_ledger_counters_match():
    """The per-tenant request, shed and device-seconds counters and the
    latency histogram the ledger binds: the same names and values."""
    def scenario(ns):
        metrics = ns.obs.Metrics()
        led = ns.tenants.TenantLedger(tenants_cfg(ns), metrics)
        for _ in range(3):
            led.admit("beta")
        led.record("beta", 0.5, latency_ms=12.0)
        led.admit("nobody")
        return {k: v for k, v in metrics.counter_values().items()
                if k.startswith("tenant_") and v}

    assert both(scenario) == {"tenant_requests_total{tenant=beta}": 2.0,
                              "tenant_sheds_total{tenant=beta,reason=tenant_rate_exceeded}": 1.0,
                              "tenant_device_seconds_total{tenant=beta}": 0.5,
                              "tenant_sheds_total{tenant=unknown,reason=tenant_unknown}": 1.0}


# -- config validation -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(name=""), dict(api_key=""), dict(weight=0.0), dict(weight=-1.0),
    dict(quota_device_s=-1.0), dict(rate_per_s=-1.0)])
def test_tenant_config_rejects(kw):
    def scenario(ns):
        with pytest.raises(ValueError) as e:
            ns.cfg.TenantConfig(**dict(dict(name="t", api_key="k"), **kw))
        return str(e.value)

    both(scenario)


def test_tenants_config_rejects_duplicates():
    def scenario(ns):
        msgs = []
        for pair in ((("a", "k1"), ("a", "k2")), (("a", "k"), ("b", "k"))):
            with pytest.raises(ValueError) as e:
                ns.cfg.TenantsConfig(tenants=[ns.cfg.TenantConfig(name=n, api_key=k)
                                              for n, k in pair])
            msgs.append(str(e.value))
        return msgs

    both(scenario)


# -- cache partition ----------------------------------------------------------------

def cache(ns, capacity=8):
    return ns.cache.ModelCache("toy", ns.cfg.CacheConfig(enabled=True, capacity=capacity),
                               ns.obs.Metrics(), lambda: 1)


def test_cache_shares_follow_weights():
    def scenario(ns):
        c = cache(ns, capacity=8)
        c.set_tenant_weights({"alpha": 3.0, "beta": 1.0})
        return c.stats()["tenants"]

    got = both(scenario)
    assert got["alpha"]["share"] == 6 and got["beta"]["share"] == 2


def test_cache_tenant_churn_evicts_own_entries_only():
    def scenario(ns):
        c = cache(ns, capacity=8)
        c.set_tenant_weights({"alpha": 3.0, "beta": 1.0})
        for i in range(3):
            c.put(f"a{i}", {"v": i}, tenant="alpha")
        for i in range(10):
            c.put(f"b{i}", {"v": i}, tenant="beta")
        return (c.stats(), [c.get(f"a{i}") is not None for i in range(3)],
                c.get("b9") is not None, c.get("b0") is None)

    stats, alpha_kept, newest, oldest_gone = both(scenario)
    assert stats["tenants"]["beta"]["entries"] == 2 and stats["tenants"]["alpha"]["entries"] == 3
    assert all(alpha_kept) and newest and oldest_gone


def test_cache_min_share_is_one():
    def scenario(ns):
        c = cache(ns, capacity=4)
        c.set_tenant_weights({"whale": 1000.0, "minnow": 1.0})
        return c.stats()["tenants"]["minnow"]["share"]

    assert both(scenario) == 1


def test_cache_unpartitioned_without_weights():
    def scenario(ns):
        c = cache(ns, capacity=2)
        for k, v in (("x", 1), ("y", 2), ("z", 3)):
            c.put(k, {"v": v})
        return "tenants" in c.stats(), c.get("x") is None

    assert both(scenario) == (False, True)


def test_cache_flight_populates_the_leaders_partition():
    """A single-flight miss led by one tenant populates that tenant's
    partition (the flight carries the leader's tenant)."""
    def scenario(ns):
        async def run():
            c = cache(ns, capacity=8)
            c.set_tenant_weights({"alpha": 3.0, "beta": 1.0})
            loop = asyncio.get_running_loop()
            base = loop.create_future()
            w = c.submit_through("k", lambda: base, tenant="beta")
            base.set_result({"v": 1})
            await w
            return c.stats()["tenants"]

        return asyncio.run(run())

    got = both(scenario)
    assert got["beta"]["entries"] == 1 and got["alpha"]["entries"] == 0


# -- the front door, over HTTP -------------------------------------------------------

NPY = {"Content-Type": "application/x-npy"}
TOY = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=5.0,
           dtype="float32", num_classes=10, parallelism="single",
           request_timeout_ms=10_000.0, wire_size=8)


def npy_image(seed: int = 0) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 200, (8, 8, 3), dtype=np.uint8))
    return buf.getvalue()


class Side:
    """One server (the reference's or the port's) on the same config."""

    def __init__(self, pkg: str, server_over) -> None:
        ns = PKGS[pkg]
        self.pkg = pkg
        cfg = ns.cfg.ServerConfig(models=[ns.cfg.ModelConfig(**TOY)], decode_threads=2,
                                  startup_canary=False, **server_over(ns))
        self.state = JaxServerState(cfg) if pkg == "jax" else ServerState(cfg, device="cpu")
        self.state.build()

    async def __aenter__(self):
        if self.pkg == "jax":
            self.client = TestClient(TestServer(make_app(self.state)))
            await self.client.start_server()
        else:
            self.server = await start_server(self.state, "127.0.0.1", 0)
            port = self.state.serving_addresses[0][1]
            self.client = aiohttp.ClientSession(f"http://127.0.0.1:{port}")
        return self

    async def __aexit__(self, *exc):
        await self.client.close()
        if self.pkg == "port":
            await stop_server(self.state, self.server)

    async def call(self, method: str, path: str, data=None, headers=None) -> tuple:
        """(status, body without its trace id, Retry-After)."""
        async with self.client.request(method, path, data=data, headers=headers) as r:
            body = await r.json() if r.content_type == "application/json" else await r.text()
            if isinstance(body, dict):
                body.pop("trace_id", None)
            return r.status, body, r.headers.get("Retry-After")


def tenant_server(ns):
    return dict(tenants=ns.cfg.TenantsConfig(enabled=True, tenants=[
        ns.cfg.TenantConfig(name="alpha", api_key="key-alpha", weight=3.0),
        ns.cfg.TenantConfig(name="beta", api_key="key-beta", rate_per_s=0.5, burst=2.0)]))


def test_front_door_tenant_admission_http():
    """The same request sequence on both servers: a missing and an unknown
    key 401 ``tenant_unknown``; beta's burst of 2 admits two answers and
    429s the third with ``tenant_rate_exceeded`` and its Retry-After;
    alpha is untouched; ``/tenants`` answers the usage (charges are wall
    times, so they are held positive, not equal), ``?tenant=`` narrows it,
    an unknown tenant 404s and a junk parameter 400s; ``/stats`` carries
    the ``tenants`` block."""
    async def run(pkg):
        async with Side(pkg, tenant_server) as side:
            out = []
            for key in (None, "key-nope", "key-beta", "key-beta", "key-beta", "key-alpha"):
                headers = dict(NPY, **({"X-Api-Key": key} if key else {}))
                st, body, ra = await side.call("POST", "/v1/models/toy:predict",
                                               npy_image(), headers)
                out.append((st, body if st != 200 else sorted(body), ra))
            st, usage, _ = await side.call("GET", "/tenants")
            rows = usage["tenants"]
            charged = {n: r.pop("window_device_s") > 0 and r.pop("device_seconds_total") > 0
                       for n, r in rows.items()}
            out.append((st, usage, charged))
            out.append((await side.call("GET", "/tenants?tenant=beta"))[:1])
            out.append((await side.call("GET", "/tenants?tenant=ghost"))[:2])
            out.append((await side.call("GET", "/tenants?junk=1"))[0])
            st, stats, _ = await side.call("GET", "/stats")
            out.append(sorted(stats["tenants"]["tenants"]))
            return out

    got = {pkg: asyncio.run(run(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    seq = got["port"]
    assert [s[0] for s in seq[:6]] == [401, 401, 200, 200, 429, 200]
    assert seq[0][1]["reason"] == "tenant_unknown" and seq[0][2] is None
    assert seq[4][1]["reason"] == "tenant_rate_exceeded" and int(seq[4][2]) >= 1
    assert seq[6][0] == 200 and seq[6][2] == {"alpha": True, "beta": True}
    assert seq[6][1]["tenants"]["beta"]["admitted_total"] == 2
    assert seq[7] == (200,) and seq[8] == (404, {"error": "unknown tenant 'ghost'"})
    assert seq[9] == 400 and seq[10] == ["alpha", "beta"]


def test_tenants_route_refused_without_the_table():
    async def run(pkg):
        async with Side(pkg, lambda ns: {}) as side:
            return await side.call("GET", "/tenants")

    got = {pkg: asyncio.run(run(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"] == (
        409, {"error": "[tenants] is disabled; no tenant ledger is kept"}, None)
