"""The port's HTTP server on the image path, in-process on the CPU on an
ephemeral port: ``examples/resnet50.toml`` cut to a CPU size (image 32,
wires 24 (yuv420, int8) and 40 (rgb8), and ``build_module`` patched to stage
sizes (1, 1, 1, 1)) plus the toy model, driven with ``http.client``.

Checked: framed yuv420 and rgb8 bodies, npy (N, H, W, 3) batches and single
npy images answer in the reference's shapes; a framed body and an npy body of
the same pixels answer byte-identically; each answer equals the server's own
runtime run on the same assembled batch (probabilities atol 1e-6, identical
indices); malformed frames answer 400 with the reference's ``frame: ...``
messages and tick ``frame_errors_total`` and ``bad_requests_total``; a PNG on
the yuv420 wire is served through the counted PIL fallback; ``/stats`` carries
the ``ingest`` block; every bucket of every model was warmed up before
serving (no thread needs a warm-up of its own), and
``runtime_compiles_total`` does not move after warm-up.
"""

import asyncio
import dataclasses
import http.client
import io
import json
import re
import struct
import threading

import numpy as np
import pytest
import torch

from tpuserve_torch import frame, preproc
from tpuserve_torch.config import ModelConfig, ServerConfig, load_config
from tpuserve_torch.models.resnet import ResNet, ResNet50Serving
from tpuserve_torch.server import ServerState, start_server, stop_server

CPU_CUT = {"resnet50": dict(image_size=32, wire_size=24, batch_buckets=[1, 4]),
           "resnet50_rgb": dict(image_size=32, wire_size=40, batch_buckets=[1, 4])}
NPY = {"Content-Type": "application/x-npy"}
FRAME = {"Content-Type": frame.CONTENT_TYPE}


def rgb(n, edge, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, edge, edge, 3), dtype=np.uint8)


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def shallow_module(self):
    return ResNet((1, 1, 1, 1), self.cfg.num_classes, self.v1_downsample, self.bn_eps)


@pytest.fixture(scope="module")
def server():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = load_config("examples/resnet50.toml")
    models = [dataclasses.replace(m, **CPU_CUT[m.name]) for m in cfg.models]
    models.append(ModelConfig(name="toy", family="toy", batch_buckets=[1, 4], dtype="float32",
                              num_classes=10, parallelism="single"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ResNet50Serving, "build_module", shallow_module)
        state = ServerState(ServerConfig(models=models, decode_threads=2), device="cpu")
        state.build()
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()
        srv = asyncio.run_coroutine_threadsafe(start_server(state, "127.0.0.1", 0),
                                               loop).result(60)
    try:
        yield state.serving_addresses[0][1], state
    finally:
        asyncio.run_coroutine_threadsafe(stop_server(state, srv), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
        preproc.set_native_fallback_hook(None)
        torch.set_num_threads(prev)


def call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def metric(text, name):
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def in_process(state, name, items):
    """The server's own runtime on the same assembled batch."""
    model, rt = state.models[name], state.runtimes[name]
    bucket = model.bucket_for(len(items))
    return rt.fetch(rt.run(bucket, model.assemble(items, bucket)))


def assert_answers(results, ref):
    for row, res in enumerate(results):
        assert [e["class"] for e in res["top_k"]] == list(ref["indices"][row])
        np.testing.assert_allclose([e["prob"] for e in res["top_k"]], ref["probs"][row],
                                   rtol=0, atol=1e-6)


def test_framed_yuv420_batch(server):
    port, state = server
    planes = [preproc.rgb_to_yuv420(a) for a in rgb(3, 24, seed=1)]
    status, body = call(port, "POST", "/v1/models/resnet50:classify",
                        frame.encode_frame(planes, frame.KIND_YUV420, 24), FRAME)
    assert status == 200, body
    results = json.loads(body)["results"]
    assert len(results) == 3 and all(len(r["top_k"]) == 5 for r in results)
    assert_answers(results, in_process(state, "resnet50", planes))


def test_npy_batch_and_single_image(server):
    port, state = server
    imgs = rgb(4, 40, seed=2)
    status, body = call(port, "POST", "/v1/models/resnet50_rgb:classify", npy(imgs), NPY)
    assert status == 200, body
    results = json.loads(body)["results"]
    assert_answers(results, in_process(state, "resnet50_rgb", list(imgs)))
    status, body = call(port, "POST", "/v1/models/resnet50_rgb:classify", npy(imgs[0]), NPY)
    assert status == 200, body
    single = json.loads(body)
    assert set(single) == {"top_k"}
    assert_answers([single], in_process(state, "resnet50_rgb", [imgs[0]]))
    # On the yuv420 wire an npy image is converted on the host.
    status, body = call(port, "POST", "/v1/models/resnet50:classify", npy(rgb(1, 24)[0]), NPY)
    assert status == 200 and set(json.loads(body)) == {"top_k"}


@pytest.mark.parametrize("name, edge", [("resnet50_rgb", 40), ("toy", 8)])
def test_frame_and_npy_answers_byte_identical(server, name, edge):
    port, _ = server
    imgs = rgb(3, edge, seed=17)
    framed = call(port, "POST", f"/v1/models/{name}:classify",
                  frame.encode_frame(list(imgs), frame.KIND_RGB8, edge), FRAME)
    plain = call(port, "POST", f"/v1/models/{name}:classify", npy(imgs), NPY)
    assert framed[0] == plain[0] == 200
    assert framed[1] == plain[1]


def test_malformed_frames_answer_400_and_count(server):
    port, state = server
    good = frame.encode_frame([preproc.rgb_to_yuv420(a) for a in rgb(2, 24)],
                              frame.KIND_YUV420, 24)
    bad_bodies = [b"", b"TPUF\x01\x00", b"NOPE" + good[4:], good[:-10], good + b"junk",
                  struct.pack("<4sHHII", b"TPUF", 1, frame.KIND_YUV420, 5000, 24) + good[16:],
                  frame.encode_frame(list(rgb(1, 24)), frame.KIND_RGB8, 24)]
    before = call(port, "GET", "/metrics")[1].decode()
    for body in bad_bodies:
        status, raw = call(port, "POST", "/v1/models/resnet50:classify", body, FRAME)
        err = json.loads(raw)
        assert status == 400 and err["error"].startswith("frame:"), (status, err)
        assert set(err) == {"error", "trace_id"}
        try:
            frame.parse_frame(body, kind=frame.KIND_YUV420, edge=24, max_items=1024)
        except frame.FrameError as e:
            assert err["error"] == str(e)
    after = call(port, "GET", "/metrics")[1].decode()
    for name in ('frame_errors_total{model="resnet50"}', 'bad_requests_total{model="resnet50"}'):
        assert metric(after, name) - metric(before, name) == len(bad_bodies), name
    assert call(port, "POST", "/v1/models/resnet50:classify", good, FRAME)[0] == 200


def test_png_on_the_yuv420_wire_is_a_counted_fallback(server):
    from PIL import Image

    port, _ = server
    buf = io.BytesIO()
    Image.new("RGB", (30, 20), (200, 30, 60)).save(buf, format="PNG")
    before = json.loads(call(port, "GET", "/stats")[1])["ingest"]
    status, body = call(port, "POST", "/v1/models/resnet50:classify", buf.getvalue(),
                        {"Content-Type": "image/png"})
    assert status == 200 and set(json.loads(body)) == {"top_k"}
    after = json.loads(call(port, "GET", "/stats")[1])["ingest"]
    fb = "native_decode_fallback_total"
    assert after[fb]["resnet50"] - before[fb]["resnet50"] == 1
    assert after[fb]["resnet50_rgb"] == before[fb]["resnet50_rgb"]


def test_stats_ingest_block_and_inventory(server):
    port, _ = server
    call(port, "POST", "/v1/models/toy:classify", npy(rgb(1, 8)[0]), NPY)
    stats = json.loads(call(port, "GET", "/stats")[1])
    ingest = stats["ingest"]
    assert set(ingest) == {"loops", "frame_errors_total", "native_decode_fallback_total"}
    assert list(ingest["loops"]) == ["0"]
    assert ingest["loops"]["0"]["requests"] >= 1 and ingest["loops"]["0"]["bytes"] > 0
    assert set(ingest["frame_errors_total"]) == {"resnet50", "resnet50_rgb", "toy"}
    assert stats["kernels"] == {"flash_attention": {"launches": 0, "by_shape": {}},
                                "flash_attention_stats": {"launches": 0}}
    inv = json.loads(call(port, "GET", "/v1/models")[1])
    assert inv["resnet50"]["quantize"] == "int8" and inv["resnet50_rgb"]["quantize"] is None
    assert inv["resnet50"]["buckets"] == [[1], [4]]
    # int8 weights: about a byte per weight where bf16 takes two.
    p8, p16 = inv["resnet50"]["params"], inv["resnet50_rgb"]["params"]
    assert p8["bytes"] < 0.6 * p16["bytes"]


def test_every_h2d_thread_warmed_before_serving(server):
    """The h2d stage's threads need no warm-up of their own: on the card they
    replay graphs captured at startup (cuDNN's per-thread plans are baked
    into them), and here each slot's module runs eagerly. What must hold is
    that every bucket of every model was warmed up at startup, before the
    batchers served, and that each model holds its three parameter slots."""
    _, state = server
    for name, rt in state.runtimes.items():
        model = state.models[name]
        assert sorted(v.bucket for v in rt.variants) == sorted(model.buckets())
        assert all(v.compile_ms > 0 for v in rt.variants.values())
        assert len(rt.slots) == 3 and rt.describe()["slots"]["live"] == 0
        assert rt.captures_total == 0  # CUDA graphs are captured on the card only


def test_compiles_do_not_move_after_warm_up(server):
    port, _ = server
    before = call(port, "GET", "/metrics")[1].decode()
    planes = [preproc.rgb_to_yuv420(a) for a in rgb(4, 24, seed=3)]
    for n in (1, 4, 2):
        status, _ = call(port, "POST", "/v1/models/resnet50:classify",
                         frame.encode_frame(planes[:n], frame.KIND_YUV420, 24), FRAME)
        assert status == 200
    after = call(port, "GET", "/metrics")[1].decode()
    for name in ("resnet50", "resnet50_rgb", "toy"):
        key = f'runtime_compiles_total{{model="{name}"}}'
        assert metric(after, key) == metric(before, key) == 2
    items = 'items_total{model="resnet50"}'
    assert metric(after, items) - metric(before, items) == 7
