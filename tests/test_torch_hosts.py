"""Host failure domains (``tpuserve_torch.workerproc.hosts``) and the fleet
scrape (``tpuserve_torch.telemetry.fleet``) against the reference's
(``tpuserve/workerproc/hosts.py``, ``tpuserve/telemetry/fleet.py``), on the
CPU.

Without spawning: both packages' ``HostSupervisor`` are built on one config
with the same fake roster (2 hosts x 2 workers, agents that never ran) and
driven through one sequence on one fake clock: least-loaded picks across
hosts, ``exclude_hosts`` (the hedge rule), a host-breaker trip, its
half-open after the cooldown and its close on a success, ``down_domains``,
``respawn_eta_s``, ``scale_domain``'s refusals and a scale, ``scale_state``
and the ``stats`` rows: every decision equal. A recycle-mode model is
refused at construction by both with the same message. ``merge_expositions``
and ``sum_counter`` give byte-identical text and equal sums on the same
expositions, a stale source included.

On real processes, the reference's scenarios (``tests/test_hosts.py``): a
module-scoped fleet of 2 host agents x 2 CPU workers serving a narrow
seeded BERT-flash (2 layers, d_model 32; the port's K1 takes its plain
version on the CPU) boots and serves; one worker's death stays local to
its host (its agent respawns it); ``killpg`` of a whole host degrades,
refuses ``:reload`` 409 with per-host outcomes meanwhile, re-absorbs, and
the reload then succeeds fleet-wide; the fleet scrape sums counters exactly
while whole and goes stale (never 5xx) through a host kill; ``Retry-After``
is the least respawn ETA. Every kill takes its pgid or pid from the
router's roster. Every wait is bounded in code.
"""

import asyncio
import json
import os
import signal
import time
import types

import pytest
import torch
from test_torch_router import Fleet, _bert

from tpuserve import config as jconfig
from tpuserve import obs as jobs
from tpuserve.telemetry import fleet as jfleet
from tpuserve.workerproc import hosts as jhosts
from tpuserve_torch import config as tconfig
from tpuserve_torch import obs as tobs
from tpuserve_torch.config import RouterConfig, ServerConfig
from tpuserve_torch.telemetry import fleet as tfleet
from tpuserve_torch.workerproc import hosts as thosts

DEPLOYMENT = """
[router]
enabled = true
hosts = 2
workers = 2
host_breaker_threshold = 2
host_breaker_cooldown_s = 0.2
health_interval_s = 0.4
[events]
dir = "{bb}"
[[model]]
name = "bert"
family = "bert"
parallelism = "single"
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the spawned processes read it at import
    yield
    torch.set_num_threads(prev)
    if prev_env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = prev_env


# ---------------------------------------------------------------------------
# Decisions without processes, against the reference
# ---------------------------------------------------------------------------

class _Proc:
    def __init__(self):
        self.alive = True
        self.exitcode = None

    def is_alive(self):
        return self.alive


class _Conn:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)

    def close(self):
        pass


def _bare(mod, cfg, metrics, **kw):
    """``mod``'s HostSupervisor over a fake roster: hand-built host handles
    and worker refs whose agents never ran."""
    sup = mod.HostSupervisor(cfg, metrics, **kw)
    for hid in range(sup.n_hosts):
        h = object.__new__(mod.HostHandle)
        h.hid, h.pgid, h.pid = hid, 1000 + hid, 1000 + hid
        h.proc, h.conn, h.workers, h.started_at = _Proc(), _Conn(), {}, 0.0
        if hasattr(mod.HostHandle, "boot_s"):
            h.boot_s = 1.0
        for wid in sup._host_wids(hid):
            ref = mod.WorkerRef(wid, hid, 9000 + wid, 2000 + wid, "127.0.0.1")
            h.workers[wid] = ref
            sup._refs[wid] = ref
        sup.hosts[hid] = h
    return sup


def _without(d, keys):
    if isinstance(d, dict):
        return {k: _without(v, keys) for k, v in d.items() if k not in keys}
    if isinstance(d, list):
        return [_without(v, keys) for v in d]
    return d


def test_host_supervisor_decisions_match_reference(tmp_path, monkeypatch):
    path = tmp_path / "deploy.toml"
    path.write_text(DEPLOYMENT.format(bb=tmp_path / "bb"))
    now = [100.0]
    clock = types.SimpleNamespace(monotonic=lambda: now[0], time=time.time,
                                  sleep=time.sleep)
    for mod in (thosts, jhosts):
        monkeypatch.setattr(mod, "time", clock)
    port = _bare(thosts, tconfig.load_config(str(path)), tobs.Metrics(), device="cpu")
    ref = _bare(jhosts, jconfig.load_config(str(path)), jobs.Metrics(16))
    sups = (port, ref)

    def both(fn):
        p, r = (fn(s) for s in sups)
        assert p == r
        return p

    def wid_of(w):
        return None if w is None else w.wid

    # Least loaded across hosts, least recently picked on ties.
    for step in range(12):
        both(lambda s: wid_of(s.pick()))
        if step % 3 == 0:
            for s in sups:
                s.track_inflight(s._refs[step % 4], +1)
    # The hedge rule: never the excluded domains; None when all are.
    assert both(lambda s: s.pick(exclude_hosts={0}).host) == 1
    assert both(lambda s: wid_of(s.pick(exclude_hosts={0, 1}))) is None
    w = both(lambda s: s.pick(exclude={2}, exclude_hosts={0}).wid)
    assert w == 3
    # The host breaker: threshold 2 trips host 0 for the 0.2 s cooldown.
    for s in sups:
        s.note_transport_failure(s.hosts[0].workers[0])
    assert both(lambda s: s.host_tripped(0)) is False
    for s in sups:
        s.note_transport_failure(s.hosts[0].workers[0])
    assert both(lambda s: s.host_tripped(0)) is True
    assert {both(lambda s: s.pick().host) for _ in range(4)} == {1}
    now[0] += 0.25  # half-open: picks allowed again
    assert both(lambda s: s.host_tripped(0)) is False
    for s in sups:
        s.note_transport_failure(s.hosts[0].workers[1])  # re-trips at once
    assert both(lambda s: s.host_tripped(0)) is True
    for s in sups:
        s.note_success(s.hosts[0].workers[1])
    assert both(lambda s: (s.host_tripped(0), s._hb_fails[0])) == (False, 0)
    # Down domains: a dead agent, and a worker its agent is re-booting.
    assert both(lambda s: s.down_domains()) == []
    for s in sups:
        s.hosts[1].proc.alive = False
        s.hosts[0].workers[1].up = False
    assert both(lambda s: s.down_domains()) == ["host1", "host0:worker1"]
    assert both(lambda s: [r.wid for r in s.live_workers()]) == [0]
    assert both(lambda s: wid_of(s.worker_by_id(1))) is None
    # Retry-After's basis: the health interval, then the least host ETA.
    assert both(lambda s: s.respawn_eta_s()) == 0.4
    for s in sups:
        s._respawning |= {0, 1}
        s._next_up_at[0], s._next_up_at[1] = now[0] + 7.0, now[0] + 3.0
    assert both(lambda s: s.respawn_eta_s()) == 3.0
    rows = both(lambda s: _without(s.stats(), {"boot_s", "device"}))
    assert rows["hosts_up"] == 1 and rows["healthy"] == 1
    for s in sups:
        s._respawning.clear()
    # Scaling: the refusals, then a scale that reaches the agent's pipe.
    for hid, active in ((5, 1), (0, 3), (0, 0), (1, 1)):
        errs = []
        for s in sups:
            with pytest.raises((ValueError, RuntimeError)) as e:
                s.scale_domain(hid, active)
            errs.append((e.type.__name__, str(e.value)))
        assert errs[0] == errs[1], (hid, active)
    assert both(lambda s: s.scale_domain(0, 1)) == {"host": 0, "active_before": 2,
                                                    "active": 1, "max_slots": 2}
    assert both(lambda s: s.hosts[0].conn.sent) == [{"op": "scale", "active": 1}]
    assert both(lambda s: s.scale_state())[0]["active"] == 1
    # A worker the agent scaled down is cold on purpose, not a down domain.
    for s in sups:
        s._on_worker_scaled_down(s.hosts[0], 1)
    assert both(lambda s: s.down_domains()) == ["host1"]
    both(lambda s: _without(s.stats(), {"boot_s", "device"}))


def test_recycle_refused_at_construction_like_the_reference():
    cfg = ServerConfig(models=[tconfig.ModelConfig(name="rc", session_mode="recycle")],
                       router=RouterConfig(enabled=True, hosts=2))
    jcfg = jconfig.ServerConfig(models=[jconfig.ModelConfig(name="rc", session_mode="recycle")],
                                router=jconfig.RouterConfig(enabled=True, hosts=2))
    with pytest.raises(ValueError, match="recycle") as port:
        thosts.HostSupervisor(cfg, tobs.Metrics(), device="cpu")
    with pytest.raises(ValueError, match="recycle") as ref:
        jhosts.HostSupervisor(jcfg, jobs.Metrics(16))
    assert str(port.value) == str(ref.value)


def _exposition(mod, seed: int) -> str:
    """A /metrics body rendered by ``mod``'s registry: counters, gauges and
    histograms of one model, as a worker's would be."""
    m = mod.Metrics(16) if mod is jobs else mod.Metrics()
    m.counter('requests_total{model=bert}').inc(3 + seed)
    m.counter('items_total{model=bert}').inc(7 * (seed + 1))
    m.gauge('queue_depth{model=bert}').set(seed + 0.5)
    h = m.histogram('latency_ms{model=bert,phase=total}')
    for v in (0.3, 2.0, 9.0 * (seed + 1), 250.0):
        h.observe(v)
    return m.render_prometheus()


def test_fleet_merge_matches_reference_byte_for_byte():
    sources = [("router0", _exposition(tobs, 0)), ("worker0", _exposition(tobs, 1)),
               ("worker1", _exposition(jobs, 2)), ("worker2", None),
               ("router1", _exposition(tobs, 3))]
    merged = tfleet.merge_expositions(sources)
    assert merged == jfleet.merge_expositions(sources)
    assert "# STALE worker2" in merged and 'fleet_source_up{proc="worker2"} 0' in merged
    assert 'queue_depth{model="bert",proc="worker0"}' in merged
    assert tfleet.parse_exposition(sources[1][1]) == jfleet.parse_exposition(sources[1][1])
    for base, labels in (("requests_total", 'model="bert"'), ("items_total", None),
                         ("latency_ms_count", 'model="bert",phase="total"')):
        got = tfleet.sum_counter(merged, base, labels)
        assert got == jfleet.sum_counter(merged, base, labels) > 0
    assert tfleet.sum_counter(merged, "requests_total", 'model="bert"') \
        == sum(tfleet.sum_counter(t, "requests_total", 'model="bert"')
               for _, t in sources if t is not None)


# ---------------------------------------------------------------------------
# The host fleet: 2 real host agents x 2 real workers each
# ---------------------------------------------------------------------------

def _hosts_cfg() -> ServerConfig:
    return ServerConfig(
        host="127.0.0.1", port=0, decode_threads=2, startup_canary=False,
        drain_timeout_s=3.0, watchdog_interval_s=0.2,
        router=RouterConfig(enabled=True, workers=2, hosts=2, retry_max=3, hedge_ms=150.0,
                            health_interval_s=0.2, unhealthy_after=2,
                            respawn_initial_s=0.3, respawn_max_s=2.0),
        models=[_bert("bert")])


@pytest.fixture(scope="module")
def hostfleet():
    f = Fleet(_hosts_cfg())
    yield f
    f.close()


def _metrics(fleet, path="/metrics") -> dict:
    out = {}
    for line in fleet.request("GET", path)[1].decode().splitlines():
        if not line.startswith("#") and " " in line:
            k, v = line.rsplit(" ", 1)
            out[k] = float(v)
    return out


def _wait_health(fleet, want: str, budget: float) -> dict:
    deadline = time.monotonic() + budget
    health = {}
    while time.monotonic() < deadline:
        health = fleet.get_json("/healthz")[1]
        if health.get("status") == want:
            return health
        time.sleep(0.05)
    return health


def test_host_topology_boots_and_serves(hostfleet):
    status, body, _ = hostfleet.post("bert", {"text": "hello world"})
    assert status == 200, body
    status, health = hostfleet.get_json("/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["hosts"] == {"configured": 2, "up": 2}
    stats = hostfleet.get_json("/stats")[1]
    w = stats["workers"]
    assert w["configured"] == 4 and w["healthy"] == 4
    assert w["hosts_up"] == 2 and w["hosts_configured"] == 2
    assert [h["name"] for h in w["hosts"]] == ["host0", "host1"]
    assert all(h["state"] == "up" and len(h["workers"]) == 2 and h["boot_s"] > 0
               for h in w["hosts"])
    assert stats["topology"]["hosts_configured"] == 2
    assert stats["topology"]["workers_per_domain"] == 2
    assert stats["router"]["cuda_initialized"] is False
    m = _metrics(hostfleet)
    assert m.get('host_up{host="0"}') == m.get('host_up{host="1"}') == 1.0
    assert all(m.get(f'worker_up{{worker="{wid}"}}') == 1.0 for wid in range(4))
    # Each agent is its own process group, apart from the router's, and
    # every worker is a real process in its agent's group.
    sup = hostfleet.state.supervisor
    pgids = {h.pgid for h in sup.hosts}
    assert len(pgids) == 2 and os.getpgrp() not in pgids
    for h in sup.hosts:
        assert all(os.getpgid(r.pid) == h.pgid for r in h.workers.values())
    status, wstats = hostfleet.get_json("/workers/3/stats")
    assert status == 200 and "pipeline" in wstats and wstats["backend"]["device"] == "cpu"


def test_single_worker_death_is_host_local(hostfleet):
    """SIGKILL one WORKER (not its host): its agent respawns it and reports
    the new port up the pipe; the host never goes down and the router
    serves throughout."""
    sup = hostfleet.state.supervisor
    h0 = sup.hosts[0]
    old_pid = h0.workers[1].pid
    os.kill(old_pid, signal.SIGKILL)
    for i in range(6):
        status, body, _ = hostfleet.post("bert", {"text": f"through a worker death {i}"})
        assert status == 200, body
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        ref = sup.hosts[0].workers.get(1)
        if ref is not None and ref.up and ref.pid != old_pid and ref.healthy:
            break
        time.sleep(0.1)
    ref = sup.hosts[0].workers[1]
    assert ref.pid != old_pid and ref.up, (ref.pid, old_pid)
    assert sup.hosts[0] is h0  # the same agent: the host never died
    m = _metrics(hostfleet)
    assert m.get('host_respawns_total{host="0"}', 0.0) == 0.0
    assert m.get('worker_respawns_total{worker="1"}') == 1.0
    assert hostfleet.post("bert", {"text": "the respawned worker serves"})[0] == 200


def test_host_kill_degrades_then_reabsorbs(hostfleet):
    """killpg one ENTIRE host (agent and both workers, one syscall): every
    request keeps answering 200 on the survivor; a fleet :reload is refused
    409 with per-host outcomes while the domain is down, touching nobody;
    /healthz says degraded but stays 200; the domain re-absorbs and the
    reload then succeeds fleet-wide."""
    sup = hostfleet.state.supervisor
    pgid = sup.hosts[0].pgid
    deaths, host_deaths = sup.deaths_total, sup.host_deaths_total
    respawns = _metrics(hostfleet).get('host_respawns_total{host="0"}', 0.0)
    os.killpg(pgid, signal.SIGKILL)
    for i in range(12):
        status, body, _ = hostfleet.post("bert", {"text": f"through a host death {i}"})
        assert status == 200, (i, status, body)
    t0 = time.monotonic()
    status, info, _ = hostfleet.request("POST", "/admin/models/bert:reload")
    info = json.loads(info)
    assert status == 409, info
    assert time.monotonic() - t0 < 5.0, "a degraded reload must not hang"
    assert "host0" in info["down"] and "per_host" in info, info
    vers = hostfleet.get_json("/admin/models/bert/versions")[1]
    assert len({w["live_version"] for w in vers["workers"].values()}) == 1, vers
    health = _wait_health(hostfleet, "ok", 90.0)
    assert health["status"] == "ok" and health["hosts"] == {"configured": 2, "up": 2}, health
    m = _metrics(hostfleet)
    assert m.get('host_respawns_total{host="0"}') == respawns + 1
    assert m.get('host_up{host="0"}') == 1.0 and sup.hosts[0].pgid != pgid
    assert sup.host_deaths_total == host_deaths + 1
    assert sup.deaths_total == deaths + 2  # both workers went with their host
    status, info, _ = hostfleet.request("POST", "/admin/models/bert:reload")
    info = json.loads(info)
    assert status == 200, info
    assert info["fleet_consistent"] is True and len(info["workers"]) == 4
    assert sorted(info["per_host"]) == ["host0", "host1"]
    assert hostfleet.post("bert", {"text": "after the re-absorb"})[0] == 200
    # The dead domain left one host postmortem naming the signal, with the
    # lost workers' snapshots.
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        pms = [p for p in hostfleet.get_json("/debug/postmortems")[1]["postmortems"]
               if p["component"] == "host"]
        if pms:
            break
        time.sleep(0.1)
    assert pms and pms[0]["signal"] == "SIGKILL" and pms[0]["workers_lost"] == 2


def test_fleet_scrape_degrades_stale_never_500(hostfleet):
    """A whole fleet's scrape sums the workers' counters exactly; with a
    whole host killed the scrape stale-marks that domain's sources (never a
    5xx); after the respawn it is whole again."""
    def scrape():
        status, text, _ = hostfleet.request("GET", "/metrics/fleet")
        assert status == 200, text
        status, rollup = hostfleet.get_json("/stats/fleet")
        assert status == 200, rollup
        return text.decode(), rollup

    for i in range(6):
        assert hostfleet.post("bert", {"text": f"scraped {i}"})[0] == 200
    merged, rollup = scrape()
    per_worker = sum(tfleet.sum_counter(hostfleet.request("GET", f"/workers/{w}/metrics")[1]
                                        .decode(), "requests_total", 'model="bert"')
                     for w in range(4))
    fleet_sum = tfleet.sum_counter(merged, "requests_total", 'model="bert"')
    assert fleet_sum == per_worker > 0
    assert rollup["models"]["bert"]["requests_total"] == fleet_sum
    assert rollup["stale"] == [] and rollup["down_domains"] == []
    assert set(rollup["sources"]) == {"router0", "worker0", "worker1", "worker2", "worker3"}
    assert 'proc="worker0"' in merged
    assert rollup["models"]["bert"]["fleet_latency_p99_ms"] is not None

    os.killpg(hostfleet.state.supervisor.hosts[1].pgid, signal.SIGKILL)
    merged, rollup = scrape()  # at once: no 5xx
    assert {"worker2", "worker3"} <= set(rollup["stale"]), rollup
    assert 'fleet_source_up{proc="worker2"} 0' in merged and "# STALE worker2" in merged
    assert tfleet.sum_counter(merged, "requests_total", 'model="bert"') > 0
    assert hostfleet.post("bert", {"text": "during the scrape"})[0] == 200
    deadline = time.monotonic() + 90.0
    while time.monotonic() < deadline:
        merged, rollup = scrape()
        if not rollup["stale"] and not rollup["down_domains"]:
            break
        time.sleep(0.3)
    assert rollup["stale"] == [] and all(v == "up" for v in rollup["sources"].values())
    _wait_health(hostfleet, "ok", 30.0)
    assert hostfleet.post("bert", {"text": "scraped again"})[0] == 200


def test_retry_after_reflects_min_respawn_eta(hostfleet):
    """With hosts respawning, the no-worker Retry-After is the ceiling of
    the LEAST ETA across them; with none, of the health interval."""
    state = hostfleet.state
    sup = state.supervisor
    assert sup.respawn_eta_s() == pytest.approx(state.rcfg.health_interval_s)
    assert state.no_worker_retry_after() == 1

    async def arm():
        now = time.monotonic()
        sup._respawning |= {0, 1}
        sup._next_up_at[0], sup._next_up_at[1] = now + 7.0, now + 3.0
        return sup.respawn_eta_s(), state.no_worker_retry_after()

    async def disarm():
        sup._respawning.clear()

    # On the router's loop, which owns the roster.
    eta, retry_after = asyncio.run_coroutine_threadsafe(arm(), hostfleet._loop).result(10)
    asyncio.run_coroutine_threadsafe(disarm(), hostfleet._loop).result(10)
    assert 2.0 < eta <= 3.0 and retry_after == 3
