"""EfficientDet-D0 of the port (``tpuserve_torch.models.efficientdet``)
against the reference's (``tpuserve/models/efficientdet.py``), on the CPU, on
the same seeded float32 trees converted by ``from_jax_params``.

The reference's own tests of this family are ``slow``; the JAX side here is
kept small and module-scoped: its tiny ``det_cfg`` (``tests/
test_efficientdet.py:21-32``) at 64 px and at 100 px, and full D0 width at
128 px, batch 2.

- Published figures: 3.7-4.1M parameters (the reference's count exactly),
  49,104 anchors at 512 px; ``make_anchors`` bit-equal.
- Heads: class logits and box regression against the JAX module, float32:
  atol 1e-5 x each output's largest magnitude (two frameworks sum the
  convolutions in other orders; measured 1e-7 x). At 100 px the feature maps
  are odd-sized, which exercises flax's "SAME" padding, the -inf max-pool
  pads and the half-pixel nearest resize; the anchor table's rows equal the
  heads' rows. bf16 (both sides cast every float leaf, as the runtimes do):
  atol 2e-2 x scale.
- Detections: the whole forward (device preprocessing, heads, sigmoid, top
  ``pre_nms``, decode, NMS) on a tree whose heads are scaled so that scores
  spread over the threshold (the seeded heads give every anchor ~0.01, below
  it): ``n``, classes, boxes (atol 1e-5) and scores (atol 1e-5) equal over
  every slot up to the first pair of kept scores closer than 1e-5, and all
  of them where no such pair exists.
- ``fixed_nms`` on random boxes, batched over 3 images: equal to the
  reference's per image and to the naive greedy NMS of
  ``tests/test_efficientdet.py:54-73``; ``pairwise_iou`` and
  ``decode_boxes`` within 1e-6.
- Seeded init: the class head's prior bias, fusion weights of ones,
  BatchNorm at identity; the conversion round-trips bit for bit.
- Padded lanes do not move real lanes (a served runtime, bucket 2).
- ``host_postprocess``: the same JSON as the reference's from the same
  outputs, labels included.
- Over HTTP: both servers on a tiny model at 64 px from the same ``.npz``:
  framed yuv420 and npy bodies to ``:detect`` answer the same detections.
- ``examples/efficientdet.toml`` is ``serve_all.toml``'s block on one device.
"""

import asyncio
import dataclasses
import io
import json

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import config as jconfig
from tpuserve.models import build as jax_build
from tpuserve.models import efficientdet as jdet
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve_torch import config as tconfig
from tpuserve_torch import frame, preproc
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.models import build
from tpuserve_torch.models import efficientdet as tdet
from tpuserve_torch.models.layers import from_jax_params, to_jax_params
from tpuserve_torch.runtime import build_runtime
from tpuserve_torch.server import ServerState, start_server, stop_server

HEAD_REL = 1e-5
BF16_REL = 2e-2
DET_TOL = 1e-5
DET = dict(det_classes=5, fpn_channels=16, fpn_repeats=1, head_repeats=1, max_level=5,
           pre_nms=32, max_dets=8, backbone_width=0.25, backbone_depth=0.35,
           score_thresh=0.005)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def det_kwargs(**over) -> dict:
    base = dict(name="det", family="efficientdet", batch_buckets=[1, 2], deadline_ms=2.0,
                dtype="float32", parallelism="single", request_timeout_ms=60_000.0,
                image_size=64, wire_size=64, options=dict(DET))
    base.update(over)
    return base


def pair(**over):
    kw = det_kwargs(**over)
    return jax_build(jconfig.ModelConfig(**kw)), build(tconfig.ModelConfig(**kw))


def spread(tree: dict, cls_gain: float, box_gain: float) -> dict:
    """The tree with its heads' final projections scaled, so that class
    scores spread across the threshold and boxes move off their anchors."""
    p = jax.tree_util.tree_map(np.array, tree)
    p["params"]["class_net"]["final"]["pw"]["kernel"] *= cls_gain
    p["params"]["box_net"]["final"]["pw"]["kernel"] *= box_gain
    return p


def port_module(model, tree, dtype=torch.float32):
    module = model.build_module().eval()
    module.load_state_dict(from_jax_params(tree), strict=True)
    return module.to(dtype).to(memory_format=torch.channels_last)


def nhwc_to_port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny model at 64 and 100 px: (jax model, port model,
    seed-0 tree) per size."""
    out = {}
    for size in (64, 100):
        jm, tm = pair(image_size=size, wire_size=size)
        out[size] = (jm, tm, jax.device_get(jax.jit(jm.init_params)(jax.random.key(0))))
    return out


@pytest.fixture(scope="module")
def full():
    """Full D0 width at 128 px: the reference's seed-0 tree."""
    jm, tm = pair(image_size=128, wire_size=128, options={}, batch_buckets=[2])
    return jm, tm, jax.device_get(jax.jit(jm.init_params)(jax.random.key(0)))


# -- published figures, anchors ---------------------------------------------------

def test_full_size_matches_published_figures():
    jm, tm = pair(image_size=512, wire_size=512, options={})
    shapes = jax.eval_shape(jm.init_params, jax.random.key(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        n_port = sum(p.numel() for p in tm.build_module().parameters())
    assert 3.7e6 < n_port < 4.1e6 and n_port == n_ref
    assert tm.anchors.shape == (49104, 4)


@pytest.mark.parametrize("size, lo, hi", [(512, 3, 7), (100, 3, 5), (64, 3, 7), (33, 2, 6)])
def test_make_anchors_bit_equal(size, lo, hi):
    ref = jdet.make_anchors(size, lo, hi, 4.0)
    got = tdet.make_anchors(size, lo, hi, 4.0)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


# -- the network ------------------------------------------------------------------

def _heads(module, x: np.ndarray):
    with torch.no_grad():
        return tuple(a.float().numpy() for a in module(nhwc_to_port(x)))


def _assert_heads(got, ref, rel: float) -> None:
    for g, r in zip(got, ref, strict=True):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * np.abs(r).max())


@pytest.mark.parametrize("size", [64, 100])
def test_tiny_heads_match_jax(tiny, size):
    jm, tm, tree = tiny[size]
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    ref = tuple(np.asarray(a) for a in jax.jit(jm.module.apply)(tree, x))
    got = _heads(port_module(tm, tree), x)
    _assert_heads(got, ref, HEAD_REL)
    assert got[0].shape[1] == tm.anchors.shape[0] == jm.anchors.shape[0]


def test_tiny_heads_match_jax_bf16(tiny):
    jm, tm, tree = tiny[100]
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    bf = jax_build(jconfig.ModelConfig(**det_kwargs(dtype="bfloat16", image_size=100,
                                                    wire_size=100)))
    x = np.random.default_rng(5).standard_normal((2, 100, 100, 3)).astype(np.float32)
    ref = tuple(np.asarray(a) for a in jax.jit(bf.module.apply)(params, x.astype(jnp.bfloat16)))
    module = port_module(tm, tree, torch.bfloat16)
    assert module.bifpn0.w_td3.dtype == torch.bfloat16   # as the reference's cast tree
    with torch.no_grad():
        got = tuple(a.numpy() for a in module(nhwc_to_port(x).to(torch.bfloat16)))
    assert all(g.dtype == np.float32 for g in got)
    _assert_heads(got, ref, BF16_REL)


def test_full_width_heads_match_jax(full):
    jm, tm, tree = full
    x = np.random.default_rng(0).standard_normal((2, 128, 128, 3)).astype(np.float32)
    ref = tuple(np.asarray(a) for a in jax.jit(jm.module.apply)(tree, x))
    got = _heads(port_module(tm, tree), x)
    _assert_heads(got, ref, HEAD_REL)
    assert got[0].shape == (2, tm.anchors.shape[0], 90)


def _assert_detections(out: dict, ref: dict) -> int:
    """Equal over every slot up to the first near-tie of kept scores; all of
    them when the kept scores separate. Returns the slots compared."""
    checked = 0
    for r in range(ref["n"].shape[0]):
        n = int(ref["n"][r])
        s = ref["scores"][r][:n]
        ties = np.nonzero(np.abs(np.diff(s)) <= DET_TOL)[0]
        m = int(ties[0]) + 1 if len(ties) else n
        np.testing.assert_array_equal(out["classes"][r][:m], ref["classes"][r][:m])
        np.testing.assert_allclose(out["boxes"][r][:m], ref["boxes"][r][:m], atol=DET_TOL)
        np.testing.assert_allclose(out["scores"][r][:m], ref["scores"][r][:m], atol=DET_TOL)
        if m == n:
            assert int(out["n"][r]) == n
            np.testing.assert_array_equal(out["classes"][r], ref["classes"][r])
            assert (out["scores"][r][n:] == 0).all()
        checked += m
    return checked


@pytest.mark.parametrize("which", ["tiny64", "tiny100", "full128"])
def test_detections_match_jax(tiny, full, which):
    if which == "full128":
        jm, tm, tree = full
        tree, size = spread(tree, 1e5, 3e4), 128
    else:
        size = int(which[4:])
        jm, tm, tree = tiny[size]
        tree = spread(tree, 30.0, 30.0)
    batch = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(jm.forward)(tree, batch))
    with torch.no_grad():
        out = {k: v.numpy() for k, v in tm.forward(port_module(tm, tree),
                                                   (torch.from_numpy(batch),)).items()}
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == \
        {k: (v.shape, v.dtype) for k, v in ref.items()}
    assert out["classes"].dtype == np.int32 and out["n"].dtype == np.int32
    assert ref["n"].min() >= 2, ref["n"]            # NMS did real work
    assert _assert_detections(out, ref) >= 4


# -- the fixed-shape tail ------------------------------------------------------------

def naive_nms(boxes, scores, classes, max_dets, iou_t, score_t):
    """Greedy per-class NMS in plain numpy (``tests/test_efficientdet.py``)."""
    def iou(a, b):
        ymin, xmin = max(a[0], b[0]), max(a[1], b[1])
        ymax, xmax = min(a[2], b[2]), min(a[3], b[3])
        inter = max(ymax - ymin, 0) * max(xmax - xmin, 0)
        area = lambda t: max(t[2] - t[0], 0) * max(t[3] - t[1], 0)  # noqa: E731
        u = area(a) + area(b) - inter
        return inter / u if u > 0 else 0.0

    order = np.argsort(-scores, kind="stable")
    kept = []
    for i in order:
        if scores[i] <= score_t or len(kept) == max_dets:
            break
        if any(classes[i] == classes[j] and iou(boxes[i], boxes[j]) > iou_t for j in kept):
            continue
        kept.append(int(i))
    return kept


def test_fixed_nms_matches_reference_and_naive():
    b, k, max_dets, iou_t, score_t = 3, 64, 16, 0.5, 0.05
    rng = np.random.default_rng(11)
    yx = rng.uniform(0, 0.8, (b, k, 2))
    hw = rng.uniform(0.05, 0.3, (b, k, 2))
    boxes = np.concatenate([yx, yx + hw], axis=-1).clip(0, 1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    scores[0, :8] = scores[0, 8]                          # ties: the first index wins
    classes = rng.integers(0, 3, (b, k)).astype(np.int32)
    out = tdet.fixed_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), max_dets, iou_t, score_t)
    out = {k_: v.numpy() for k_, v in out.items()}
    for i in range(b):
        ref = jax.tree_util.tree_map(np.asarray, jdet.fixed_nms(
            boxes[i], scores[i], classes[i], max_dets, iou_t, score_t))
        for key in ("boxes", "scores", "classes", "n"):
            np.testing.assert_array_equal(out[key][i], ref[key], err_msg=key)
        kept = naive_nms(boxes[i], scores[i], classes[i], max_dets, iou_t, score_t)
        n = int(out["n"][i])
        assert n == len(kept)
        np.testing.assert_array_equal(out["boxes"][i][:n], boxes[i][kept])
        np.testing.assert_array_equal(out["classes"][i][:n], classes[i][kept])
        assert (out["classes"][i][n:] == -1).all() and (out["scores"][i][n:] == 0).all()


def test_pairwise_iou_and_decode_match_reference():
    rng = np.random.default_rng(12)
    yx = rng.uniform(0, 0.8, (2, 20, 2))
    boxes = np.concatenate([yx, yx + rng.uniform(0, 0.3, (2, 20, 2))], -1).astype(np.float32)
    got = tdet.pairwise_iou(torch.from_numpy(boxes)).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i], np.asarray(jdet.pairwise_iou(boxes[i])), atol=1e-6)
    anchors = tdet.make_anchors(64, 3, 5)
    reg = rng.normal(0, 2, anchors.shape).astype(np.float32)   # clipped at +-8 somewhere
    reg[0, 2:] = 20.0
    ref = np.asarray(jdet.decode_boxes(reg, anchors, 64))
    got = tdet.decode_boxes(torch.from_numpy(reg), torch.from_numpy(anchors), 64).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


# -- init, conversion ---------------------------------------------------------------

def test_seeded_init_uses_reference_initializers():
    _, tm = pair()
    sd = tm.init_params(0)
    assert set(sd) == set(tm.build_module().state_dict())
    assert torch.all(sd["class_net.final.pw.bias"] == np.float32(-np.log((1 - 0.01) / 0.01)))
    fusion = [k for k in sd if k.rsplit(".", 1)[-1].startswith(("w_td", "w_out"))]
    assert len(fusion) == 4 and all(torch.all(sd[k] == 1.0) for k in fusion)
    assert sd["bifpn0.w_out4"].shape == (3,) and sd["bifpn0.w_out5"].shape == (2,)
    assert torch.all(sd["box_net.final.pw.bias"] == 0) and torch.all(sd["bn_lat3.running_var"] == 1)
    back = from_jax_params(to_jax_params(sd))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    # The reference's seeded tree has the same initializers where they are constants.
    jm, _ = pair()
    ref = jax.device_get(jm.init_params(jax.random.key(0)))["params"]
    np.testing.assert_array_equal(ref["bifpn0"]["w_td3"], np.ones(2, np.float32))
    np.testing.assert_allclose(ref["class_net"]["final"]["pw"]["bias"],
                               sd["class_net.final.pw.bias"].numpy(), rtol=1e-7)


def test_conversion_round_trips(tiny):
    _, tm, tree = tiny[64]
    sd = tm.from_jax_params(tree)
    back = tm.to_jax_params(sd)
    same = jax.tree_util.tree_map(lambda a, b: a.shape == b.shape and np.array_equal(a, b),
                                  back, jax.tree_util.tree_map(np.asarray, tree))
    assert jax.tree_util.tree_all(same)


# -- serving ------------------------------------------------------------------------

def test_padded_lanes_do_not_move_real_lanes(tiny):
    jm, tm, tree = tiny[64]
    tm.load_params = lambda: from_jax_params(spread(tree, 30.0, 30.0))
    rt = build_runtime(tm, device="cpu")
    rng = np.random.default_rng(3)
    img, other = rng.integers(0, 255, (2, 64, 64, 3), np.uint8)
    o1 = rt.fetch(rt.run((2,), tm.assemble([img], (2,))))
    o2 = rt.fetch(rt.run((2,), tm.assemble([img, other], (2,))))
    for key in ("boxes", "scores", "classes", "n"):
        np.testing.assert_array_equal(o1[key][0], o2[key][0], err_msg=key)
    assert o1["n"][0] >= 2


def test_host_postprocess_json_equal(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("person\nbicycle\ncar\n")
    jm, tm = pair(labels=str(labels), options=dict(DET, max_dets=6))
    rng = np.random.default_rng(4)
    out = {"boxes": rng.uniform(0, 1, (3, 6, 4)).astype(np.float32),
           "scores": rng.uniform(0, 1, (3, 6)).astype(np.float32),
           "classes": np.array([[0, 4, -1, 2, -1, -1], [-1] * 6, [1, 1, 1, 3, 2, 0]], np.int32),
           "n": np.array([3, 0, 6], np.int32)}
    got, ref = tm.host_postprocess(out, 3), jm.host_postprocess(out, 3)
    assert json.dumps(got) == json.dumps(ref)
    assert got[0]["detections"][0]["label"] == "person" and "label" not in got[0]["detections"][1]


def test_example_config_is_the_reference_block():
    ours = jconfig.load_config("examples/efficientdet.toml").models[0]
    ref = jconfig.load_config("examples/serve_all.toml").model("efficientdet")
    assert dataclasses.replace(ref, parallelism="single") == ours
    port = tconfig.load_config("examples/efficientdet.toml")
    m = port.models[0]
    assert (m.family, m.batch_buckets, m.deadline_ms, m.dtype, m.image_size, m.wire_format,
            m.wire_size, m.options, m.weights) == \
        ("efficientdet", [4, 8], 20.0, "bfloat16", 512, "yuv420", 512, {}, None)
    assert tconfig.unported_settings(port) == []
    assert build(m).det_classes == 90


SERVED = dict(det_kwargs(batch_buckets=[2]), wire_format="yuv420")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jm = jax_build(jconfig.ModelConfig(**SERVED))
    tree = spread(jax.device_get(jm.init_params(jax.random.key(0))), 30.0, 30.0)
    path = str(tmp_path_factory.mktemp("det") / "det.npz")
    sm.save_npz(path, tree)
    # The reference reads no .npz: its model loads the same tree directly.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet.EfficientDetServing, "load_params", lambda self: tree)
        jstate = JaxServerState(jconfig.ServerConfig(
            models=[jconfig.ModelConfig(**SERVED)], decode_threads=2))
        jstate.build()
    tstate = ServerState(tconfig.ServerConfig(
        models=[tconfig.ModelConfig(**SERVED, weights=path)], decode_threads=2), device="cpu")
    tstate.build()
    loop = asyncio.new_event_loop()

    async def up():
        jc = TestClient(TestServer(make_app(jstate)))
        await jc.start_server()
        server = await start_server(tstate, "127.0.0.1", 0)
        tc = aiohttp.ClientSession(f"http://127.0.0.1:{tstate.serving_addresses[0][1]}")
        return jc, server, tc

    jc, server, tc = loop.run_until_complete(up())
    yield (lambda coro: loop.run_until_complete(coro)), {"jax": jc, "port": tc}
    loop.run_until_complete(jc.close())
    loop.run_until_complete(tc.close())
    loop.run_until_complete(stop_server(tstate, server))
    loop.close()


def _bodies():
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    framed = frame.encode_frame([preproc.rgb_to_yuv420(a) for a in imgs], frame.KIND_YUV420, 64)
    buf = io.BytesIO()
    np.save(buf, imgs[0])
    return [(framed, frame.CONTENT_TYPE), (buf.getvalue(), "application/x-npy")]


def test_detect_over_http_on_both_servers(servers):
    run, clients = servers

    async def go():
        for body, ctype in _bodies():
            answers = {}
            for pkg, c in clients.items():
                async with c.post("/v1/models/det:detect", data=body,
                                  headers={"Content-Type": ctype}) as r:
                    assert r.status == 200, await r.text()
                    res = await r.json()
                answers[pkg] = res["results"] if "results" in res else [res]
            assert len(answers["port"]) == len(answers["jax"]) >= 1
            for a, b in zip(answers["port"], answers["jax"]):
                assert set(a) == set(b) == {"detections", "num_detections"}
                assert a["num_detections"] == b["num_detections"] >= 2
                assert [d["class"] for d in a["detections"]] == \
                    [d["class"] for d in b["detections"]]
                np.testing.assert_allclose([d["box"] for d in a["detections"]],
                                           [d["box"] for d in b["detections"]], atol=2e-5)
                np.testing.assert_allclose([d["score"] for d in a["detections"]],
                                           [d["score"] for d in b["detections"]], atol=2e-5)

    run(go())
