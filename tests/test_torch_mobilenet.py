"""MobileNetV3-Large of the port (``tpuserve_torch.models.mobilenet``)
against the reference's (``tpuserve/models/mobilenet.py``), on the CPU.

- The module: the same parameter count as the reference's tree (~5.5M, the
  published figure), the same leaves (names and shapes once converted),
  and flax's "SAME" padding of every stride-2 layer of the real V3_LARGE
  table at 224 px (``layers._same_padding`` against
  ``jax.lax.padtype_to_pads``; (0, 1) for the 3x3 layers, (1, 2) for the
  5x5 ones).
- Logits at full width — the real V3_LARGE table, 1000 classes, 224 px,
  batch 2 — against the JAX module on the same float32 tree (the
  reference's seed-0 init with its BatchNorm statistics randomized, so
  the epsilon and the order of BatchNorm's ops matter), converted by
  ``from_jax_params``: max abs diff <= 1e-5 x the logits' largest magnitude
  + 1e-6 (float32, two frameworks; measured 1.3e-7 at a 0.2 scale).
- ``from_jax_params`` and ``to_jax_params`` invert each other bit for bit.
- Served: both servers on the CPU with a shallow net (the first three
  blocks of the table, patched into both packages' module builders, as
  ``tests/test_torch_serve_vision.py`` cuts ResNet-50) at 32 px, buckets
  [1, 2], float32, the port reading the reference's seeded tree from a
  ``.npz``: framed yuv420 and npy bodies answer the same top-5 classes on
  both, probabilities within 1e-5.
- ``preproc_mean``/``preproc_std`` overrides reach the device
  preprocessing (``tests/test_mobilenet.py:106``).
"""

import asyncio
import dataclasses
import io

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve import config as jconfig
from tpuserve.models import build as jax_build
from tpuserve.models import mobilenet as jmobilenet
from tpuserve.server import ServerState as JaxServerState
from tpuserve.server import make_app
from tpuserve_torch import config as tconfig
from tpuserve_torch import frame, preproc
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.models import build
from tpuserve_torch.models import mobilenet as tmobilenet
from tpuserve_torch.models.layers import _same_padding, from_jax_params, to_jax_params
from tpuserve_torch.server import ServerState, start_server, stop_server

LOGIT_REL, LOGIT_ABS = 1e-5, 1e-6
SHALLOW = jmobilenet.V3_LARGE[:3]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def full_tree():
    """The reference's seed-0 float32 tree at full width, its BatchNorm
    statistics randomized (seed 1)."""
    jm = jmobilenet.MobileNetV3Large(num_classes=1000, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 224, 224, 3)))))
    rng = np.random.default_rng(1)

    def randomize(node):
        for k, v in node.items():
            if isinstance(v, dict):
                randomize(v)
            elif k == "mean":
                node[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    tree = {"params": dict(tree["params"]), "batch_stats": dict(tree["batch_stats"])}
    randomize(tree["batch_stats"])
    return jm, tree


def test_module_shapes_and_param_count(full_tree):
    """~5.5M parameters (the published figure), the reference's count; the
    same leaves, each of the converted shape."""
    _, tree = full_tree
    ref_leaves = dict(jax.tree_util.tree_flatten_with_path(tree["params"])[0])
    n_ref = sum(int(np.prod(v.shape)) for v in ref_leaves.values())
    module = tmobilenet.MobileNetV3Large(1000)
    n_port = sum(p.numel() for p in module.parameters())
    assert 5.3e6 < n_port < 5.7e6 and n_port == n_ref
    sd = from_jax_params(tree)
    own = module.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in own)
    # A depthwise kernel: (kh, kw, 1, C) -> (C, 1, kh, kw).
    assert tuple(tree["params"]["block3"]["depthwise"]["kernel"].shape) == (5, 5, 1, 72)
    assert tuple(sd["block3.depthwise.weight"].shape) == (72, 1, 5, 5)


def _stride2_layers():
    """(name, input edge, kernel) of every stride-2 convolution of V3_LARGE
    at 224 px."""
    out, edge = [("stem", 224, 3)], 112
    for i, (k, _, _, _, _, s) in enumerate(jmobilenet.V3_LARGE):
        if s == 2:
            out.append((f"block{i}.depthwise", edge, k))
            edge = -(-edge // 2)
    return out


@pytest.mark.parametrize("name, edge, k", _stride2_layers())
def test_same_padding_of_every_stride2_layer(name, edge, k):
    (ref,) = jax.lax.padtype_to_pads((edge,), (k,), (2,), "SAME")
    assert _same_padding(edge, k, 2) == tuple(ref)
    assert tuple(ref) == ((0, 1) if k == 3 else (1, 2))


def test_full_width_logits_match_jax(full_tree):
    jm, tree = full_tree
    x = np.random.default_rng(0).normal(size=(2, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(tree, x))
    module = tmobilenet.MobileNetV3Large(1000).eval()
    module.load_state_dict(from_jax_params(tree), strict=True)
    module.to(memory_format=torch.channels_last)
    with torch.no_grad():
        out = module(torch.from_numpy(x).permute(0, 3, 1, 2)
                     .contiguous(memory_format=torch.channels_last)).numpy()
    err = np.abs(out - ref).max()
    assert err <= LOGIT_REL * np.abs(ref).max() + LOGIT_ABS, err
    assert (np.argsort(-out, 1)[:, :5] == np.argsort(-ref, 1)[:, :5]).all()


def test_from_and_to_jax_params_round_trip(full_tree):
    _, tree = full_tree
    sd = from_jax_params(tree)
    back = to_jax_params(sd)
    same = jax.tree_util.tree_map(lambda a, b: a.shape == b.shape and np.array_equal(a, b),
                                  back, tree)
    assert jax.tree_util.tree_all(same)
    again = from_jax_params(back)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    seeded = build(tconfig.ModelConfig(name="m", family="mobilenetv3", parallelism="single"))
    init = seeded.init_params(3)
    assert all(torch.equal(from_jax_params(to_jax_params(init))[k], init[k]) for k in init)


def test_hard_activations_are_the_reference_formula():
    x = torch.linspace(-5, 5, 1001)
    ref_s = np.asarray(jmobilenet.hard_sigmoid(jnp.asarray(x.numpy())))
    ref_w = np.asarray(jmobilenet.hard_swish(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(tmobilenet.hard_sigmoid(x).numpy(), ref_s, atol=1e-7)
    np.testing.assert_allclose(tmobilenet.hard_swish(x).numpy(), ref_w, atol=1e-6)
    assert all(tmobilenet._divisible(v) == jmobilenet._divisible(v)
               for v in (16 / 4, 72 / 4, 120 / 4, 480 / 4, 672 / 4, 960 / 4, 3.0, 1000.3))


def test_preproc_norm_overridable_per_model():
    def cfg(**over):
        return tconfig.ModelConfig(name="mnv3", family="mobilenetv3", batch_buckets=[1, 2],
                                   dtype="float32", num_classes=10, parallelism="single",
                                   image_size=64, wire_size=64, **over)

    m_default = build(cfg())
    m_keras = build(cfg(options={"preproc_mean": [0.5, 0.5, 0.5],
                                 "preproc_std": [0.5, 0.5, 0.5]}))
    assert m_default.norm_mean == (0.485, 0.456, 0.406)
    assert m_keras.norm_mean == (0.5, 0.5, 0.5)
    batch = (torch.full((1, 64, 64, 3), 255, dtype=torch.uint8),)
    x_def = m_default.device_preprocess(batch)
    x_ker = m_keras.device_preprocess(batch)
    torch.testing.assert_close(x_ker, torch.ones_like(x_ker), atol=1e-6, rtol=0)
    assert not torch.allclose(x_def, x_ker)


# -- served: both servers, a shallow net ------------------------------------------

MODEL = dict(name="mnv3", family="mobilenetv3", batch_buckets=[1, 2], deadline_ms=2.0,
             dtype="float32", num_classes=1000, parallelism="single",
             request_timeout_ms=30_000.0, image_size=32, wire_size=32, wire_format="yuv420")


def _shallow_port(self):
    return tmobilenet.MobileNetV3Large(self.cfg.num_classes, blocks=SHALLOW)


def _shallow_jax(self, cfg):
    return jmobilenet.MobileNetV3Large(num_classes=cfg.num_classes, blocks=SHALLOW,
                                       dtype=jnp.dtype(cfg.dtype))


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmobilenet.MobileNetV3Serving, "build_module", _shallow_port)
        mp.setattr(jmobilenet.MobileNetV3Serving, "make_module", _shallow_jax)
        jm = jax_build(jconfig.ModelConfig(**MODEL))
        tree = jax.device_get(jm.init_params(jax.random.key(0)))
        path = str(tmp_path_factory.mktemp("mnv3") / "mnv3.npz")
        sm.save_npz(path, tree)
        jstate = JaxServerState(jconfig.ServerConfig(
            models=[jconfig.ModelConfig(**MODEL)], decode_threads=2))
        jstate.build()
        tstate = ServerState(tconfig.ServerConfig(
            models=[tconfig.ModelConfig(**MODEL, weights=path)], decode_threads=2), device="cpu")
        tstate.build()
        loop = asyncio.new_event_loop()

        async def up():
            jc = TestClient(TestServer(make_app(jstate)))
            await jc.start_server()
            server = await start_server(tstate, "127.0.0.1", 0)
            tc = aiohttp.ClientSession(f"http://127.0.0.1:{tstate.serving_addresses[0][1]}")
            return jc, server, tc

        jc, server, tc = loop.run_until_complete(up())
        yield (lambda coro: loop.run_until_complete(coro)), {"jax": jc, "port": tc}, tstate
        loop.run_until_complete(jc.close())
        loop.run_until_complete(tc.close())
        loop.run_until_complete(stop_server(tstate, server))
        loop.close()


def _bodies():
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    framed = frame.encode_frame([preproc.rgb_to_yuv420(a) for a in imgs], frame.KIND_YUV420, 32)
    buf = io.BytesIO()
    np.save(buf, imgs[0])
    return [(framed, frame.CONTENT_TYPE), (buf.getvalue(), "application/x-npy")]


def test_served_top_k_equal_across_packages(servers):
    run, clients, tstate = servers

    async def go():
        for body, ctype in _bodies():
            answers = {}
            for pkg, c in clients.items():
                async with c.post("/v1/models/mnv3:classify", data=body,
                                  headers={"Content-Type": ctype}) as r:
                    assert r.status == 200, await r.text()
                    res = await r.json()
                answers[pkg] = res["results"] if "results" in res else [res]
            assert len(answers["port"]) == len(answers["jax"])
            for a, b in zip(answers["port"], answers["jax"]):
                assert [e["class"] for e in a["top_k"]] == [e["class"] for e in b["top_k"]]
                np.testing.assert_allclose([e["prob"] for e in a["top_k"]],
                                           [e["prob"] for e in b["top_k"]], atol=1e-5)

    run(go())
    assert tstate.runtimes["mnv3"].describe()["family"] == "mobilenetv3"


def test_example_config_is_the_reference_block():
    """examples/mobilenetv3.toml is serve_all.toml's MobileNetV3 block on one
    device: the same fields but parallelism, as the reference reads them."""
    ours = jconfig.load_config("examples/mobilenetv3.toml").models[0]
    ref = jconfig.load_config("examples/serve_all.toml").model("mobilenetv3")
    assert dataclasses.replace(ref, parallelism="single") == ours
    port = tconfig.load_config("examples/mobilenetv3.toml").models[0]
    assert (port.batch_buckets, port.deadline_ms, port.dtype, port.wire_format,
            port.wire_size, port.image_size) == ([1, 2, 4, 8], 2.0, "bfloat16", "yuv420", 224, 224)
    assert tconfig.unported_settings(tconfig.load_config("examples/mobilenetv3.toml")) == []
