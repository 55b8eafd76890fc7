"""The versioned lifecycle over HTTP (``tpuserve_torch.lifecycle`` behind
``/admin/models/{name}:reload|:rollback`` and ``/versions``), each scenario
of ``tests/test_lifecycle.py`` replayed against the port's server AND the
JAX package's, on the CPU, with the toy model served from the same weights
(the JAX package's seed-1 tree: an orbax checkpoint for the JAX server, the
port's ``.npz`` for the port).

For every scenario the two servers must answer alike, exactly: status
codes, ``stage``, ``rolled_back``, ``version``, history statuses, the
lifecycle counters and the ``model_version`` gauge; and each server's own
answers must stay identical (bit for bit) where a rejected reload keeps the
old version serving or a rollback restores it. The two servers' top-k
probabilities agree within 1e-6 (the toy in float32, two frameworks).
Scenarios: integrity, nan_scan, structure, staged_canary, post_canary
rollback, manual rollback, soak on a failed canary, a soak that passes, and
a reload under load that drops nothing.
"""

import asyncio
import dataclasses
import io
import shutil

import aiohttp
import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import config as jconfig
from tpuserve.models import build as jax_build
from tpuserve.savedmodel import manifest_path as jax_manifest_path
from tpuserve.savedmodel import save_orbax
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve_torch import config as tconfig
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.server import ServerState, start_server, stop_server

NPY = {"Content-Type": "application/x-npy"}
MODEL = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=5.0,
             dtype="float32", num_classes=10, parallelism="single",
             request_timeout_ms=10_000.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def toy_tree(key: int = 1, num_classes: int = 10):
    jm = jax_build(jconfig.ModelConfig(**dict(MODEL, num_classes=num_classes)))
    return jax.device_get(jm.init_params(jax.random.key(key)))


def npy_image(seed: int = 0) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.random.default_rng(seed).integers(0, 200, (8, 8, 3), dtype=np.uint8))
    return buf.getvalue()


class Side:
    """One server (the JAX package's or the port's), its checkpoint and an
    HTTP client; ``pkg`` is "jax" or "port"."""

    def __init__(self, pkg: str, tmp_path, weights: bool, faults=(), lifecycle=None,
                 **server_over) -> None:
        self.pkg = pkg
        cfgm = jconfig if pkg == "jax" else tconfig
        self.ckpt = str(tmp_path / ("ckpt" if pkg == "jax" else "ckpt.npz"))
        if weights:
            self.write(toy_tree(1))
        model = cfgm.ModelConfig(**dict(MODEL, weights=self.ckpt if weights else None))
        cfg = cfgm.ServerConfig(
            models=[model], decode_threads=2,
            faults=cfgm.FaultsConfig(enabled=bool(faults),
                                     rules=[cfgm.FaultRuleConfig(**r) for r in faults]),
            lifecycle=cfgm.LifecycleConfig(**(lifecycle or {})), **server_over)
        self.state = (JaxServerState(cfg) if pkg == "jax"
                      else ServerState(cfg, device="cpu"))
        self.state.build()

    def write(self, tree, keep_manifest: bool = False) -> None:
        """(Over)write the checkpoint with ``tree``; ``keep_manifest`` puts
        the previous manifest back (a torn copy / bit rot stand-in)."""
        mpath = jax_manifest_path(self.ckpt) if self.pkg == "jax" else sm.manifest_path(self.ckpt)
        stale = open(mpath).read() if keep_manifest else None
        if self.pkg == "jax":
            shutil.rmtree(self.ckpt, ignore_errors=True)
            save_orbax(self.ckpt, tree)
        else:
            sm.save_npz(self.ckpt, tree)
        if stale is not None:
            with open(mpath, "w") as f:
                f.write(stale)

    async def __aenter__(self):
        if self.pkg == "jax":
            self.client = TestClient(TestServer(make_app(self.state)))
            await self.client.start_server()
        else:
            self.server = await start_server(self.state, "127.0.0.1", 0)
            port = self.state.serving_addresses[0][1]
            self.session = aiohttp.ClientSession(f"http://127.0.0.1:{port}")
        return self

    async def __aexit__(self, *exc):
        if self.pkg == "jax":
            await self.client.close()
        else:
            await self.session.close()
            await stop_server(self.state, self.server)

    async def call(self, method: str, path: str, data=None, headers=None):
        http = self.client if self.pkg == "jax" else self.session
        async with http.request(method, path, data=data, headers=headers) as r:
            if r.content_type == "application/json":
                return r.status, await r.json()
            return r.status, await r.text()

    async def probs(self) -> list:
        """Top-k probabilities for a fixed input: the weights' fingerprint."""
        status, body = await self.call("POST", "/v1/models/toy:predict", npy_image(7), NPY)
        assert status == 200, body
        return [e["prob"] for e in body["top_k"]]

    async def lifecycle_stats(self) -> dict:
        _, stats = await self.call("GET", "/stats")
        counters = {k: v for k, v in stats["counters"].items()
                    if k.startswith(("reloads_total", "reload_rejected_total", "rollbacks_total"))}
        lc = stats["lifecycle"]["toy"]
        return {"counters": counters, "gauge": stats["gauges"]["model_version{model=toy}"],
                "live": lc["live_version"], "previous": lc["previous_version"],
                "soaking": lc["soaking"], "history": [h["status"] for h in lc["history"]]}


def both(tmp_path, scenario, weights: bool = True, **kw) -> list[dict]:
    """Run ``scenario(side)`` on the JAX server and on the port's; each
    returns what it observed. Returns [jax's, port's]."""
    async def go():
        out = []
        for pkg in ("jax", "port"):
            d = tmp_path / pkg
            d.mkdir()
            async with Side(pkg, d, weights, **kw) as side:
                out.append(await scenario(side))
        return out

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


def assert_same(jax_seen: dict, port_seen: dict) -> None:
    """Equal observations, the probabilities within 1e-6."""
    jp, pp = jax_seen.pop("probs", None), port_seen.pop("probs", None)
    assert port_seen == jax_seen
    if jp is not None:
        np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-6)


def reject_view(status: int, body: dict) -> dict:
    return {"status": status, "stage": body.get("stage"),
            "rolled_back": body.get("rolled_back"), "version": body.get("version")}


def test_checksum_mismatch_rejected_old_version_serves(tmp_path):
    async def scenario(side):
        before = await side.probs()
        side.write(toy_tree(2), keep_manifest=True)
        seen = reject_view(*await side.call("POST", "/admin/models/toy:reload"))
        seen["unchanged"] = await side.probs() == before
        return dict(seen, probs=before, **await side.lifecycle_stats())

    jax_seen, port_seen = both(tmp_path, scenario)
    assert port_seen["status"] == 409 and port_seen["stage"] == "integrity"
    assert port_seen["version"] == 1 and port_seen["unchanged"] is True
    assert port_seen["counters"] == {"reload_rejected_total{model=toy,stage=integrity}": 1.0}
    assert_same(jax_seen, port_seen)


def test_nan_checkpoint_rejected_old_version_serves(tmp_path):
    async def scenario(side):
        before = await side.probs()
        tree = jax.tree_util.tree_map(np.array, toy_tree(2))
        tree["w1"][0, 0] = np.inf
        side.write(tree)                          # a matching manifest: integrity passes
        seen = reject_view(*await side.call("POST", "/admin/models/toy:reload"))
        seen["unchanged"] = await side.probs() == before
        return dict(seen, **await side.lifecycle_stats())

    jax_seen, port_seen = both(tmp_path, scenario)
    assert port_seen["status"] == 409 and port_seen["stage"] == "nan_scan"
    assert port_seen["version"] == 1 and port_seen["unchanged"] is True
    assert_same(jax_seen, port_seen)


def test_wrong_shapes_rejected_at_structure(tmp_path):
    async def scenario(side):
        side.write(toy_tree(2, num_classes=12))
        seen = reject_view(*await side.call("POST", "/admin/models/toy:reload"))
        return dict(seen, **await side.lifecycle_stats())

    jax_seen, port_seen = both(tmp_path, scenario)
    assert port_seen["status"] == 409 and port_seen["stage"] == "structure"
    assert_same(jax_seen, port_seen)


def test_staged_canary_failure_never_publishes(tmp_path):
    async def scenario(side):
        before = await side.probs()
        seen = []
        for _ in range(3):
            seen.append(reject_view(*await side.call("POST", "/admin/models/toy:reload")))
            seen[-1]["unchanged"] = await side.probs() == before
        return dict(rejections=seen, **await side.lifecycle_stats())

    jax_seen, port_seen = both(tmp_path, scenario, weights=False,
                               faults=[dict(kind="reload_regressed", model="toy")])
    assert port_seen["rejections"] == [{"status": 409, "stage": "staged_canary",
                                        "rolled_back": False, "version": 1,
                                        "unchanged": True}] * 3
    assert port_seen["history"] == ["live", "rejected", "rejected", "rejected"]
    assert port_seen["counters"] == {
        "reload_rejected_total{model=toy,stage=staged_canary}": 3.0}
    assert_same(jax_seen, port_seen)


def test_post_publish_canary_failure_rolls_back(tmp_path):
    async def scenario(side):
        seen = reject_view(*await side.call("POST", "/admin/models/toy:reload"))
        seen["serving"], _ = await side.call("POST", "/v1/models/toy:predict",
                                             npy_image(), NPY)
        return dict(seen, **await side.lifecycle_stats())

    # The startup canary is off: the one-rule injector fires on every canary.
    jax_seen, port_seen = both(tmp_path, scenario, weights=False, startup_canary=False,
                               faults=[dict(kind="canary_fail", model="toy")])
    assert port_seen["status"] == 500 and port_seen["stage"] == "post_canary"
    assert port_seen["rolled_back"] is True and port_seen["version"] == 1
    assert port_seen["serving"] == 200 and port_seen["gauge"] == 1.0
    assert port_seen["counters"]["rollbacks_total{model=toy,reason=post_publish_canary}"] == 1
    assert port_seen["history"] == ["superseded", "rolled_back", "live"]
    assert_same(jax_seen, port_seen)


def test_rollback_endpoint_restores_previous_version(tmp_path):
    async def scenario(side):
        probs_a = await side.probs()
        side.write(jax.tree_util.tree_map(lambda x: x + 0.25, toy_tree(1)))
        status, body = await side.call("POST", "/admin/models/toy:reload")
        seen = {"reload": (status, body["version"], body["previous_version"])}
        probs_b = await side.probs()
        seen["new_weights"] = probs_b != probs_a
        status, body = await side.call("POST", "/admin/models/toy:rollback")
        seen["rollback"] = (status, body)
        seen["restored"] = await side.probs() == probs_a
        _, v = await side.call("GET", "/admin/models/toy/versions")
        seen["versions"] = (v["live_version"], v["previous_version"],
                            [h["status"] for h in v["history"]])
        seen["second_rollback"] = (await side.call("POST", "/admin/models/toy:rollback"))[0]
        seen["unknown"] = (await side.call("POST", "/admin/models/nope:reload"))[0]
        return dict(seen, probs=probs_b, **await side.lifecycle_stats())

    jax_seen, port_seen = both(tmp_path, scenario)
    assert port_seen["reload"] == (200, 2, 1)
    assert port_seen["new_weights"] is True and port_seen["restored"] is True
    assert port_seen["rollback"] == (200, {"model": "toy", "version": 1,
                                           "rolled_back_from": 2})
    assert port_seen["versions"] == (1, None, ["superseded", "rolled_back", "live"])
    assert port_seen["second_rollback"] == 409 and port_seen["unknown"] == 404
    assert_same(jax_seen, port_seen)


async def wait_for_version(side, version: int, timeout_s: float = 3.0) -> int:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline and side.state.runtimes["toy"].version != version:
        await asyncio.sleep(0.02)
    return side.state.runtimes["toy"].version


def test_failed_canary_in_soak_window_auto_rolls_back(tmp_path):
    async def scenario(side):
        status, body = await side.call("POST", "/admin/models/toy:reload")
        seen = {"reload": (status, body["version"], body["soak_s"])}
        _, v = await side.call("GET", "/admin/models/toy/versions")
        seen["soaking_after_reload"] = v["soaking"]
        side.state.canary_ok["toy"] = False     # the periodic canary's verdict
        seen["after"] = await wait_for_version(side, 1)
        return dict(seen, **await side.lifecycle_stats())

    jax_seen, port_seen = both(tmp_path, scenario, weights=False,
                               lifecycle=dict(soak_s=5.0, soak_poll_s=0.05))
    assert port_seen["reload"] == (200, 2, 5.0) and port_seen["soaking_after_reload"] is True
    assert port_seen["after"] == 1 and port_seen["soaking"] is False
    assert port_seen["counters"]["rollbacks_total{model=toy,reason=soak_canary}"] == 1
    assert_same(jax_seen, port_seen)


def test_soak_window_passes_quietly(tmp_path):
    async def scenario(side):
        status, _ = await side.call("POST", "/admin/models/toy:reload")
        await asyncio.sleep(0.4)                  # outlive the soak window
        _, v = await side.call("GET", "/admin/models/toy/versions")
        return {"status": status, "live": v["live_version"], "soaking": v["soaking"]}

    jax_seen, port_seen = both(tmp_path, scenario, weights=False,
                               lifecycle=dict(soak_s=0.2, soak_poll_s=0.05))
    assert port_seen == {"status": 200, "live": 2, "soaking": False}
    assert_same(jax_seen, port_seen)


def test_reload_under_load_drops_nothing(tmp_path):
    async def scenario(side):
        async def one(i: int) -> int:
            return (await side.call("POST", "/v1/models/toy:predict", npy_image(i), NPY))[0]

        first = [asyncio.ensure_future(one(i)) for i in range(24)]
        side.write(jax.tree_util.tree_map(lambda x: x + 0.25, toy_tree(1)))
        reload_task = asyncio.ensure_future(side.call("POST", "/admin/models/toy:reload"))
        second = [asyncio.ensure_future(one(100 + i)) for i in range(24)]
        statuses = await asyncio.gather(*first, *second)
        return {"statuses": statuses, "reload": (await reload_task)[0],
                "version": side.state.runtimes["toy"].version}

    jax_seen, port_seen = both(tmp_path, scenario)
    assert port_seen == {"statuses": [200] * 48, "reload": 200, "version": 2}
    assert_same(jax_seen, port_seen)


def test_admin_routes_answer_like_the_reference(tmp_path):
    async def scenario(side):
        return {"get_reload": (await side.call("GET", "/admin/models/toy:reload"))[0],
                "post_versions": (await side.call("POST", "/admin/models/toy/versions"))[0],
                "unknown_versions": (await side.call("GET", "/admin/models/nope/versions"))[0],
                "no_rollback": await side.call("POST", "/admin/models/toy:rollback")}

    jax_seen, port_seen = both(tmp_path, scenario, weights=False)
    assert port_seen["get_reload"] == 405 and port_seen["unknown_versions"] == 404
    assert port_seen["no_rollback"][0] == 409
    assert_same(jax_seen, port_seen)


def test_periodic_canary_feeds_healthz(tmp_path):
    """canary_interval_s re-runs the canary: one injected failure turns
    /healthz degraded (503), the next canary brings it back."""
    async def scenario(side):
        seen = []
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 5.0
        while loop.time() < deadline and (len(seen) < 2 or seen[-1] != 200):
            status, _ = await side.call("GET", "/healthz")
            if not seen or seen[-1] != status:
                seen.append(status)
            await asyncio.sleep(0.01)
        return {"healthz": seen}

    jax_seen, port_seen = both(tmp_path, scenario, weights=False, startup_canary=False,
                               canary_interval_s=0.1,
                               faults=[dict(kind="canary_fail", model="toy", count=1)])
    assert port_seen == {"healthz": [200, 503, 200]}
    assert_same(jax_seen, port_seen)


def test_same_lifecycle_and_faults_tables_parse(tmp_path):
    path = tmp_path / "c.toml"
    path.write_text('canary_interval_s = 2.5\nroofline_probe_iters = 4\n'
                    '[lifecycle]\nsoak_s = 3.0\nrequire_manifest = true\n'
                    '[faults]\nenabled = true\nseed = 9\n'
                    '[[faults.rule]]\nkind = "reload_nan"\nprobability = 0.5\n'
                    '[[faults.rule]]\nkind = "device_error"\nmodel = "m"\ncount = 2\n')
    port, ref = tconfig.load_config(str(path)), jconfig.load_config(str(path))
    assert dataclasses.asdict(port.lifecycle) == dataclasses.asdict(ref.lifecycle)
    assert dataclasses.asdict(port.faults) == dataclasses.asdict(ref.faults)
    assert (port.canary_interval_s, port.roofline_probe_iters) == (2.5, 4)
    assert tconfig.unported_settings(port) == []
    with pytest.raises(ValueError, match="unknown fault kind"):
        tconfig.FaultRuleConfig(kind="nope")
