"""The port's HTTP server (``tpuserve_torch.server``) in-process on the CPU,
on an ephemeral port, driven with ``http.client``: status codes and JSON
shapes as the JAX server answers them, ``{"texts"}`` order, the
``/v1/models`` inventory, metric deltas, and an answer equal to the JAX
package's ``build_runtime(...).run`` on the same assembled batch and the
same (converted) weights: probabilities atol 1e-5, indices identical.
"""

import asyncio
import http.client
import json
import re
import threading

import jax
import numpy as np
import pytest
import torch

from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.models import build as jax_build
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve_torch.config import ModelConfig, ServerConfig
from tpuserve_torch.models.bert import from_jax_params
from tpuserve_torch.server import ServerState, start_server, stop_server

TINY = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512,
            attention="flash")
MODEL_KW = dict(name="bert", family="bert", batch_buckets=[1, 2],
                seq_buckets=[8, 16], deadline_ms=5.0, dtype="float32",
                num_classes=4, parallelism="single",
                request_timeout_ms=30_000.0, options=TINY)
JSON = {"Content-Type": "application/json"}


@pytest.fixture(scope="module")
def jax_side():
    model = jax_build(JaxModelConfig(**MODEL_KW))
    rt = jax_build_runtime(model)
    return model, rt, jax.device_get(rt.params_per_mesh[0])


@pytest.fixture(scope="module")
def server(jax_side):
    """The port serving the reference's weights on the CPU; yields its port."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = ServerConfig(models=[ModelConfig(**MODEL_KW)], decode_threads=2)
    state = ServerState(cfg, device="cpu")
    state.build()
    state.runtimes["bert"].module.load_state_dict(from_jax_params(jax_side[2]))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    srv = asyncio.run_coroutine_threadsafe(
        start_server(state, "127.0.0.1", 0), loop).result(60)
    try:
        yield state.serving_addresses[0][1]
    finally:
        asyncio.run_coroutine_threadsafe(stop_server(state, srv), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        torch.set_num_threads(prev)


def call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def classify(port, obj):
    return call(port, "POST", "/v1/models/bert:classify",
                json.dumps(obj).encode(), JSON)


def metric(text, name):
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def test_single_text_answers_top_k(server):
    status, headers, body = classify(server, {"text": "serve this text please"})
    assert status == 200, body
    top = json.loads(body)["top_k"]
    assert len(top) == 4 and {"class", "prob"} <= set(top[0])
    assert abs(sum(e["prob"] for e in top) - 1.0) < 1e-3
    assert re.fullmatch(r"[0-9a-f]{32}", headers["X-Trace-Id"])


def test_texts_batch_answers_results_in_order(server):
    texts = ["first text", "second one", "a third, longer text than the rest"]
    status, _, body = classify(server, {"texts": texts})
    assert status == 200, body
    results = json.loads(body)["results"]
    assert len(results) == 3
    for t, r in zip(texts, results):
        solo = json.loads(classify(server, {"text": t})[2])["top_k"]
        # Another bucket size sums in another order: equal to f32 rounding.
        assert [e["class"] for e in solo] == [e["class"] for e in r["top_k"]]
        np.testing.assert_allclose([e["prob"] for e in solo],
                                   [e["prob"] for e in r["top_k"]], atol=1e-6)


def test_answer_equals_jax_runtime(server, jax_side):
    model, rt, _ = jax_side
    texts = ["hello world", "compare both servers"]
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in texts]
    ref = rt.fetch(rt.run((2, 16), model.assemble(items, (2, 16))))
    results = json.loads(classify(server, {"texts": texts})[2])["results"]
    for row, res in enumerate(results):
        assert [e["class"] for e in res["top_k"]] == list(ref["indices"][row])
        np.testing.assert_allclose([e["prob"] for e in res["top_k"]],
                                   ref["probs"][row], atol=1e-5)


@pytest.mark.parametrize("method, path, body, status", [
    ("POST", "/v1/models/bert:classify", b"{oops", 400),             # bad JSON
    ("POST", "/v1/models/bert:classify", b'{"texts": ["ok", 7]}', 400),
    ("POST", "/v1/models/bert:classify", b'{"texts": []}', 400),     # empty batch
    ("POST", "/v1/models/bert:classify?timeout_ms=-1", b'{"text": "x"}', 400),
    ("POST", "/v1/models/nope:classify", b'{"text": "x"}', 404),     # unknown model
    ("GET", "/v1/models/bert:classify", None, 405),                  # wrong method
    ("GET", "/no/such/path", None, 404),
])
def test_error_statuses(server, method, path, body, status):
    got, _, raw = call(server, method, path, body, JSON)
    assert got == status, raw
    if path.startswith("/v1/models/") and got in (400, 404):
        err = json.loads(raw)
        assert set(err) == {"error", "trace_id"}


def test_keep_alive_serves_several_requests_on_one_connection(server):
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=30)
    try:
        for path in ("/healthz", "/v1/models/bert:classify", "/healthz"):
            body = b'{"text": "again"}' if "classify" in path else None
            conn.request("POST" if body else "GET", path, body=body, headers=JSON)
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 200
            assert resp.getheader("Connection") == "keep-alive"
    finally:
        conn.close()


def test_inventory_lists_buckets_and_device(server):
    status, _, body = call(server, "GET", "/v1/models")
    assert status == 200
    inv = json.loads(body)["bert"]
    assert inv["buckets"] == [[1, 8], [1, 16], [2, 8], [2, 16]]
    assert inv["device"] == "cpu" and inv["compiles_total"] == 4.0


def test_healthz_and_stats(server):
    status, _, body = call(server, "GET", "/healthz")
    assert status == 200 and json.loads(body) == {"status": "ok",
                                                  "models": {"bert": True}}
    stats = json.loads(call(server, "GET", "/stats")[2])
    assert stats["backend"]["device"] == "cpu"
    assert stats["backend"]["torch"] == torch.__version__
    # CPU tensors take the plain versions: the kernels never launch here.
    assert stats["kernels"] == {"flash_attention": {"launches": 0, "by_shape": {}},
                                "flash_attention_stats": {"launches": 0}}
    assert set(stats["pipeline"]["stages"]["workers"]) == {
        "assemble", "h2d", "fetch", "postproc"}


def test_kernel_count_reset_covers_k1_and_k2(server):
    status, _, body = call(server, "POST", "/debug/kernels:reset")
    assert status == 200
    assert json.loads(body) == {"kernels": {"flash_attention": {"launches": 0, "by_shape": {}},
                                            "flash_attention_stats": {"launches": 0}}}
    assert call(server, "GET", "/debug/kernels:reset")[0] == 405


def test_metric_deltas(server):
    before = call(server, "GET", "/metrics")[2].decode()
    status, _, _ = classify(server, {"texts": ["one", "two", "three"]})
    assert status == 200
    after = call(server, "GET", "/metrics")[2].decode()
    assert after.endswith("# EOF\n")
    for name in ('batches_total{model="bert"}', 'items_total{model="bert"}'):
        assert metric(after, name) > metric(before, name)
    assert metric(after, 'items_total{model="bert"}') - \
        metric(before, 'items_total{model="bert"}') == 3
    # Warm-up counted every bucket once; serving compiles nothing more.
    compiles = 'runtime_compiles_total{model="bert"}'
    assert metric(before, compiles) == metric(after, compiles) == 4
    assert 'latency_ms_count{model="bert",phase="compute"}' in after
