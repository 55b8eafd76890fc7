"""``tpuserve_torch.models.sd15`` against ``tpuserve/models/sd15.py`` on the
CPU, at the reference tests' tiny options (``tests/test_sd15.py`` ``TINY``:
1-layer CLIP of width 32, a 2-level UNet of 16 channels attending at level 0,
a 2-level VAE), float32, on the same weights: the port's seeded tree, held
to the reference's tree structure, handed to the reference as it is and to
the port through ``from_jax_params``. Inputs come from numpy seeds.
Tolerances:

- CLIP hidden states, one UNet call (dense and flash, at image_size 64:
  1,024 latent tokens, the flash branch; the reference runs its Pallas
  kernel in interpret mode, the port K1's plain version) and the VAE
  output: within 2e-4 (abs and rel), the reference's own flash-vs-dense
  tolerance;
- the DDIM schedule: bit-exact; the timestep embedding within 2e-4 abs
  (the float32 argument t * freq at t = 999 is spaced 6.1e-5 apart, and an
  ulp of ``exp``'s frequency moves it by up to that);
- latents from seeds: within 3 ulps of ``jax.random.normal`` (the uniform
  draws are exact; ``erf_inv``'s ``log1p`` is the framework's);
- the end-to-end ``forward`` image, and the port's engine path (insert,
  step, extract) against the port's locked ``forward``: every uint8 pixel
  within 1, at least 99 % equal;
- ``conv2d`` (the GEMM over shifted windows every convolution runs) against
  ``F.conv2d`` within 1e-5;
- exact: padded lanes leave real lanes alone, determinism in (prompt,
  seed), an engine image independent of its slot, the negative prompt's lane, the 77 token ids, the PNG round trip,
  the HTTP answers' pixels against the in-process forward, the stream's
  frames, the refusals.

At SD 1.5's full widths (on the meta device, no memory): the parameter
counts of ``tests/test_sd15.py`` and the ten K1 calls of one flash UNet
call, five at (2, 4096, 8, 64 <- 40) and five at (2, 1024, 8, 128 <- 80),
whose padded tensors pass K1's TMA layout rule.
"""

import asyncio
import dataclasses
import http.client
import io
import json
import struct
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserve.runtime  # noqa: F401 — sets jax_threefry_partitionable, as serving does
from tpuserve import config as jconfig
from tpuserve.models import build as jax_build
from tpuserve.models import sd15 as jsd
from tpuserve_torch import config as tconfig
from tpuserve_torch import frame as tframe
from tpuserve_torch.models import build as port_build
from tpuserve_torch.models import sd15 as tsd
from tpuserve_torch.ops import flash_attention as fa

TINY = dict(steps=3, guidance=5.0, vocab_size=512,
            text_layers=1, text_d_model=32, text_heads=2,
            unet_ch=16, unet_mults=[1, 2], unet_res=1, unet_attn_levels=[0],
            unet_heads=2, vae_ch=16, vae_mults=[1, 2])
TOL = 2e-4
ULPS = 3


def sd_cfg(pkg, **over):
    base = dict(name="sd", family="sd15", batch_buckets=[1, 2], deadline_ms=2.0,
                dtype="float32", parallelism="single", request_timeout_ms=120_000.0,
                image_size=32, options=dict(TINY))
    base.update(over)
    return pkg.ModelConfig(**base)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flat(tree) -> dict:
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def tree():
    """The port's seeded float32 tree in the reference's layout."""
    tm = port_build(sd_cfg(tconfig))
    return tm.to_jax_params(tm.init_params(0))


def port_pair(tree, **over):
    """(port model, its module on ``tree``)."""
    tm = port_build(sd_cfg(tconfig, **over))
    module = tm.build_module()
    module.load_state_dict(tm.from_jax_params(tree))
    return tm, module.eval()


@pytest.fixture(scope="module")
def pair(tree):
    """(reference model, port model, port module) at image_size 32."""
    return (jax_build(sd_cfg(jconfig)), *port_pair(tree))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_tree_structure_matches_reference_and_round_trips(tree):
    """The port's tree has the reference's paths and leaf shapes (its
    ``init_params`` traced abstractly), and ``from_jax_params`` then
    ``to_jax_params`` gives it back bit for bit."""
    jm = jax_build(sd_cfg(jconfig))
    want = flat(jax.eval_shape(jm.init_params, jax.random.key(0)))
    got = flat(tree)
    assert sorted(got) == sorted(want)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    tm = port_build(sd_cfg(tconfig))
    back = flat(tm.to_jax_params(tm.from_jax_params(tree)))
    assert all(np.array_equal(back[k], got[k]) for k in got)


def test_init_follows_flax_initializers(tree):
    """Each seeded leaf of 256 or more values has the spread of flax's
    initializer for it, drawn by flax at the same shape (within 15 %):
    LeCun-normal kernels (truncated at two of their standard deviations),
    the embedding's fan-in normal, ``pos_embed``'s normal(0.01); biases 0
    and norm scales 1 exactly."""
    import flax.linen as nn

    key = jax.random.key(5)
    draws: dict = {}

    def lecun(fan_in: int):
        # The std depends on fan_in alone: one (fan_in, 256) draw each.
        if fan_in not in draws:
            draws[fan_in] = nn.initializers.lecun_normal()(key, (fan_in, 256))
        return draws[fan_in]

    for path, leaf in flat(tree).items():
        if path.endswith("['bias']"):
            assert not leaf.any(), path
            continue
        if path.endswith("['scale']"):
            assert (leaf == 1).all(), path
            continue
        if leaf.size < 256:
            continue
        if path.endswith("['pos_embed']"):
            ref = nn.initializers.normal(0.01)(key, leaf.shape)
        elif path.endswith("['embedding']"):
            ref = nn.initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0)(
                key, leaf.shape)
        else:
            # DenseGeneral draws a (d, heads, hd) or (heads, hd, d) kernel
            # flattened to (inputs, outputs).
            split = 1 if path.endswith(("['query']['kernel']", "['key']['kernel']",
                                        "['value']['kernel']")) else leaf.ndim - 1
            if "['out']" in path:
                split = 2
            fan_in = int(np.prod(leaf.shape[:split]))
            ref = lecun(fan_in)
            bound = 2.0 * fan_in ** -0.5 / 0.87962566103423978
            assert np.abs(leaf).max() <= bound * (1 + 1e-6), path
        assert 0.85 < leaf.std() / float(np.std(ref)) < 1.15, (path, leaf.std(), np.std(ref))


def test_full_size_parameter_counts():
    """SD 1.5's published sizes on the meta device: UNet 859.5 M, CLIP
    123.1 M, VAE decoder ~49.5 M parameters; latent edge 64 at 512 px."""
    m = port_build(tconfig.ModelConfig(name="sd", family="sd15", dtype="bfloat16",
                                       parallelism="single", image_size=512,
                                       options=dict(vocab_size=49408)))
    with torch.device("meta"):
        module = m.build_module()
    count = {net: sum(p.numel() for p in getattr(module, net).parameters())
             for net in ("unet", "text", "vae")}
    assert 855e6 < count["unet"] < 865e6, count
    assert 120e6 < count["text"] < 126e6, count
    assert 45e6 < count["vae"] < 55e6, count
    assert m.latent == 64


def test_full_width_flash_unet_calls_k1_ten_times(monkeypatch):
    """One flash UNet call at SD 1.5's widths (2 lanes, 512 px, on the meta
    device) reaches K1 ten times: five at (2, 4096, 8, 64) from head dim 40
    and five at (2, 1024, 8, 128) from 80; bf16 tensors of those padded
    shapes pass K1's TMA stride rule."""
    calls = []

    def k1(q, k, v):
        calls.append(tuple(q.shape))
        assert q.shape == k.shape == v.shape and q.is_contiguous()
        return torch.empty_like(q)

    monkeypatch.setattr(tsd, "flash_attention", k1)
    m = port_build(tconfig.ModelConfig(name="sd", family="sd15", dtype="bfloat16",
                                       parallelism="single", image_size=512,
                                       options=dict(unet_attention="flash")))
    with torch.device("meta"):
        unet = m.build_module().unet.to(torch.bfloat16)
        eps = unet(torch.empty(2, 64, 64, 4), torch.zeros(2, dtype=torch.int32),
                   torch.empty(2, 77, 768, dtype=torch.bfloat16))
    assert tuple(eps.shape) == (2, 64, 64, 4)
    assert sorted(calls) == [(2, 1024, 8, 128)] * 5 + [(2, 4096, 8, 64)] * 5
    for shape, d in (((2, 4096, 8, 40), 64), ((2, 1024, 8, 80), 128)):
        q, k, v = (tsd.pad_head_dim(torch.zeros(shape, dtype=torch.bfloat16)) for _ in range(3))
        assert q.shape[-1] == d
        assert fa.tma_layout_problem(q, k, v) is None


def test_clip_hidden_states(pair, tree):
    jm, tm, module = pair
    ids = np.random.default_rng(1).integers(0, tm.vocab_size, (3, 77)).astype(np.int32)
    want = jax.jit(jm.text_encoder.apply)(tree["text"], jnp.asarray(ids))
    with torch.inference_mode():
        got = module.text(torch.from_numpy(ids))
    close(got, want)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_unet_one_call(tree, attention, monkeypatch):
    """At image_size 64 the latent is 32 x 32: 1,024 tokens at level 0, so
    "flash" takes the kernel (three calls: down0_attn0, up0_attn0/1)."""
    jm = jax_build(sd_cfg(jconfig, image_size=64,
                          options={**TINY, "unet_attention": attention}))
    tm, module = port_pair(tree, image_size=64, options={**TINY, "unet_attention": attention})
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    t = np.array([999, 500], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    want = jax.jit(jm.unet.apply)(tree["unet"], jnp.asarray(lat), jnp.asarray(t),
                                  jnp.asarray(ctx))
    shapes = []
    orig = tsd.flash_attention
    monkeypatch.setattr(tsd, "flash_attention",
                        lambda q, k, v: shapes.append(tuple(q.shape)) or orig(q, k, v))
    with torch.inference_mode():
        got = module.unet(*(torch.from_numpy(a) for a in (lat, t, ctx)))
    close(got, want)
    assert shapes == ([(2, 1024, 2, 64)] * 3 if attention == "flash" else [])


def test_vae_output(pair, tree):
    jm, _, module = pair
    z = np.random.default_rng(3).standard_normal((2, 16, 16, 4)).astype(np.float32)
    want = jax.jit(jm.vae.apply)(tree["vae"], jnp.asarray(z))
    with torch.inference_mode():
        got = module.vae(torch.from_numpy(z))
    close(got, want)


def test_ddim_schedule_and_timestep_embedding():
    for steps in (1, 3, 20, 50):
        for a, b in zip(tsd.ddim_schedule(steps), jsd.ddim_schedule(steps)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    t = np.array([0, 1, 250, 999], np.int32)
    want = jsd.timestep_embedding(jnp.asarray(t), 320)
    got = tsd.timestep_embedding(torch.from_numpy(t), 320)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


def test_latents_from_seeds_within_ulps(pair):
    _, tm, _ = pair
    seeds = np.array([0, 1, 2**31 - 1, -1, -(2**31), 4242], np.int32)
    got = tm.latents(torch.from_numpy(seeds)).numpy()
    for s, g in zip(seeds, got):
        key = jax.random.fold_in(jax.random.key(0), jnp.int32(s))
        want = np.asarray(jax.random.normal(key, (tm.latent, tm.latent, 4), jnp.float32))
        ulps = np.abs(g.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= ULPS, (s, ulps.max())


BODIES = [b'{"prompt": "a red square", "seed": 7}',
          b'{"prompt": "a tpu rendering images", "negative_prompt": "blur", "seed": -3}']


def items(model, bodies=BODIES) -> list:
    return [model.host_decode(b, "application/json") for b in bodies]


def port_forward(tm, module, its, bucket: int) -> np.ndarray:
    batch = tm.assemble(its, (bucket,))
    with torch.inference_mode():
        return tm.forward(module, tuple(torch.from_numpy(np.array(a)) for a in batch))[
            "image"].numpy()


def pixel_rule(got: np.ndarray, want: np.ndarray) -> None:
    """Every uint8 pixel within 1, at least 99 % equal."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()


def test_forward_image_matches_reference(pair, tree):
    jm, tm, module = pair
    its = items(tm)
    for a, b in zip(its, items(jm)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    want = np.asarray(jax.jit(jm.forward)(tree, jm.assemble(items(jm), (2,)))["image"])
    got = port_forward(tm, module, its, 2)
    assert got.dtype == np.uint8 and got.shape == (2, 32, 32, 3)
    pixel_rule(got, want)


def test_padded_lanes_do_not_affect_real_lanes(pair):
    _, tm, module = pair
    a, b = items(tm)
    np.testing.assert_array_equal(port_forward(tm, module, [a], 2)[0],
                                  port_forward(tm, module, [a, b], 2)[0])


def test_determinism_seed_and_negative_prompt(pair):
    """Same (prompt, seed) -> identical image, another seed -> another; a
    negative prompt steers, and leaving it unset equals ""."""
    _, tm, module = pair
    dec = lambda body: tm.host_decode(json.dumps(body).encode(), "application/json")  # noqa: E731
    base = dec({"prompt": "a cat", "seed": 4})
    runs = [port_forward(tm, module, [it], 1) for it in (
        base, base, dec({"prompt": "a cat", "seed": 5}),
        dec({"prompt": "a cat", "negative_prompt": "", "seed": 4}),
        dec({"prompt": "a cat", "negative_prompt": "a dog", "seed": 4}))]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert (runs[0] != runs[2]).any()
    np.testing.assert_array_equal(runs[0], runs[3])
    assert (runs[0] != runs[4]).any()


def test_tokenize_fixed_77_and_decode_errors(pair):
    jm, tm, _ = pair
    ids, neg, seed = tm.host_decode(b'{"prompt": "a b c", "seed": 5}', "application/json")
    assert ids.shape == neg.shape == (77,) and ids.dtype == np.int32 and int(seed) == 5
    long = b'{"prompt": "' + b"word " * 200 + b'"}'
    for body in (long, b"plain text prompt"):
        ctype = "application/json" if body.startswith(b"{") else "text/plain"
        got, want = tm.host_decode(body, ctype), jm.host_decode(body, ctype)
        assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(got, want))
    for body, match in ((b'{"seed": 1}', "prompt"),
                        (b'{"prompt": "x", "negative_prompt": 5}', "negative_prompt")):
        with pytest.raises(ValueError, match=match):
            tm.host_decode(body, "application/json")
    assert all(np.array_equal(x, y) for x, y in zip(tm.canary_item(), jm.canary_item()))


def decode_png(data: bytes) -> np.ndarray:
    """A filter-0 8-bit RGB PNG (what ``encode_png`` writes) -> (H, W, 3)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype, *_ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, ctype) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_round_trip():
    from PIL import Image

    arr = np.random.default_rng(4).integers(0, 256, (17, 23, 3), dtype=np.uint8)
    png = tsd.encode_png(arr)
    np.testing.assert_array_equal(decode_png(png), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png)).convert("RGB")), arr)
    with pytest.raises(ValueError, match="H, W, 3"):
        tsd.encode_png(arr[..., :2])


def engine_images(tm, bodies: list, slots: int = 2, waves: int = 2) -> list:
    """PNG pixels of ``bodies`` through a CPU runtime's generation engine
    (insert, step, extract), later waves folded into a stepping block."""
    from tpuserve_torch.genserve import GenEngine
    from tpuserve_torch.obs import Metrics
    from tpuserve_torch.runtime import build_runtime

    rt = build_runtime(tm, device="cpu", compile_forward=False)
    eng = GenEngine(tm, rt, Metrics(), tconfig.GenserveConfig(slots=slots))
    eng.compile()
    its = [tm.host_decode(b, "application/json") for b in bodies]

    async def go():
        await eng.start()
        futs, per = [], -(-len(its) // waves)
        for w in range(waves):
            futs += [eng.submit(it) for it in its[w * per:(w + 1) * per]]
            await asyncio.sleep(0.05)
        out = await asyncio.gather(*futs)
        await eng.stop()
        return out

    return [decode_png(png) for png in asyncio.run(go())]


def test_engine_matches_locked_forward(pair):
    """Three requests through a 2-slot engine (the third folds in while the
    block steps) against the locked forward of each alone."""
    _, tm, module = pair
    bodies = BODIES + [b'{"prompt": "third", "seed": 11}']
    got = engine_images(tm, bodies)
    for body, img in zip(bodies, got):
        pixel_rule(img, port_forward(tm, module, items(tm, [body]), 1)[0])


def test_engine_image_does_not_depend_on_its_slot(pair):
    """The same request twice at once lands in two slots (their UNet rows
    at different positions of the step's batch): the same pixels."""
    _, tm, _ = pair
    a, b, c = engine_images(tm, [BODIES[1], BODIES[1], BODIES[0]], slots=3, waves=1)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


@pytest.mark.parametrize("b, k, stride, dtype", [
    (3, 1, 1, torch.float32), (3, 3, 1, torch.float32), (3, 3, 2, torch.float32),
    (1, 3, 2, torch.float32), (1, 3, 1, torch.bfloat16)])
def test_conv2d_is_the_convolution(b, k, stride, dtype):
    """``conv2d`` (one GEMM over the shifted windows) against ``F.conv2d``
    with symmetric k // 2 padding: float32 within 1e-5 (one float32 image
    takes the GEMM too); one bf16 image is ``F.conv2d`` itself, exactly."""
    g = torch.Generator().manual_seed(k + stride)
    x = torch.randn(b, 8, 10, 10, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(5, 8, k, k, generator=g).to(dtype)
    bias = torch.randn(5, generator=g).to(dtype)
    got = tsd.conv2d(x, w, bias, stride)
    want = torch.nn.functional.conv2d(x, w, bias, stride=stride, padding=k // 2)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


class Served:
    """The port's server on the CPU, on an ephemeral port in a background
    loop, serving sd15 at TINY on its seeded weights."""

    def __init__(self, genserve: bool, **opts) -> None:
        from tpuserve_torch.server import ServerState, start_server

        cfg = tconfig.ServerConfig(
            decode_threads=2,
            genserve=tconfig.GenserveConfig(enabled=genserve, slots=2),
            models=[sd_cfg(tconfig, options={**TINY, **opts})])
        self.state = ServerState(cfg, device="cpu")
        self.state.build()
        self.loop = asyncio.new_event_loop()
        threading.Thread(target=self.loop.run_forever, daemon=True).start()
        self.srv = self.on_loop(start_server(self.state, "127.0.0.1", 0))
        self.port = self.state.serving_addresses[0][1]

    def on_loop(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def post(self, path: str, body: bytes) -> tuple[int, bytes, dict]:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, r.read(), {k.lower(): v for k, v in r.getheaders()}
        finally:
            conn.close()

    def close(self) -> None:
        from tpuserve_torch.server import stop_server

        self.on_loop(stop_server(self.state, self.srv))
        self.loop.call_soon_threadsafe(self.loop.stop)


@pytest.fixture
def served():
    holder = []
    yield lambda **kw: holder.append(Served(**kw)) or holder[-1]
    for s in holder:
        s.close()


@pytest.mark.parametrize("genserve", [False, True], ids=["locked", "engine"])
def test_http_generate_png(served, genserve):
    """``:generate`` answers ``image/png`` whose pixels are the in-process
    locked forward's on the same seeded weights (exactly for the locked
    batch, by the pixel rule through the engine), the same bytes again on
    a repeat, 400 without a prompt, and the same bytes again after a
    ``:reload`` of the seeded weights."""
    s = served(genserve=genserve)
    st, png, hdrs = s.post("/v1/models/sd:generate", BODIES[1])
    assert st == 200 and hdrs["content-type"] == "image/png", (st, png[:200])
    model = s.state.models["sd"]
    want = port_forward(model, s.state.runtimes["sd"].module, items(model, BODIES[1:]), 1)[0]
    got = decode_png(png)
    if genserve:
        pixel_rule(got, want)
    else:
        np.testing.assert_array_equal(got, want)
    assert s.post("/v1/models/sd:generate", BODIES[1])[1] == png
    st, body, _ = s.post("/v1/models/sd:generate", b'{"seed": 1}')
    assert st == 400 and b"prompt" in body
    st, body, _ = s.post("/admin/models/sd:reload", b"")
    assert st == 200, body[:300]
    assert s.post("/v1/models/sd:generate", BODIES[1])[1] == png


def test_http_stream_frames(served):
    """``?stream=true`` through the engine answers ``frame.CONTENT_TYPE``:
    progress events 1..steps, a preview frame per ``preview_every`` step
    before the last, exactly one final image frame (the unary PNG's
    pixels) and exactly one terminal ``done``, last."""
    s = served(genserve=True, preview_every=1)
    st, raw, hdrs = s.post("/v1/models/sd:generate?stream=true", BODIES[0])
    assert st == 200 and hdrs["content-type"] == tframe.CONTENT_TYPE, (st, raw[:200])
    frames = tframe.StreamFrameReader().feed(raw)
    events = [json.loads(p) for k, p in frames if k == tframe.KIND_EVENT]
    images = [i for i, (k, _) in enumerate(frames) if k == tframe.KIND_RGB8]
    progress = [e["step"] for e in events if e["type"] == "progress"]
    assert progress == [1, 2, 3]
    terminals = [e for e in events if e["type"] in ("done", "error")]
    assert terminals == [{"type": "done", "finish_reason": "stop", "usage": {"images": 1}}]
    assert json.loads(frames[-1][1]) == terminals[0]
    # Previews after steps 1 and 2, then the final image just before done.
    assert len(images) == 3 and images[-1] == len(frames) - 2
    final = tframe.parse_frame(frames[images[-1]][1], kind=tframe.KIND_RGB8, edge=32,
                               max_items=1)[0]
    _, png, _ = s.post("/v1/models/sd:generate", BODIES[0])
    np.testing.assert_array_equal(final, decode_png(png))


@pytest.mark.parametrize("over, exc, match", [
    (dict(options={**TINY, "bpe_vocab": "v.json"}), ValueError, "set together"),
    (dict(sp=2), NotImplementedError, "item 9b"),
    (dict(tp=2), NotImplementedError, "item 9b"),
    (dict(weights="/nonexistent/frozen.pb"), NotImplementedError, "import-model"),
    (dict(options={**TINY, "unet_attention": "magic"}), ValueError, "unet_attention"),
    (dict(options={**TINY, "preview_every": -1}), ValueError, "preview_every"),
    (dict(dtype="float64"), ValueError, "dtype"),
], ids=["bpe-half", "sharded", "tp2", "tf-weights", "attention", "preview", "dtype"])
def test_refusals(over, exc, match):
    """What the slice does not serve is refused at build by name, with its
    ROADMAP.md item; the reference's own validation messages otherwise."""
    with pytest.raises(exc, match=match):
        port_build(sd_cfg(tconfig, **over))


def test_reference_layout_maps_each_leaf(tree):
    """``reference_layout`` (the quantizer's view of a leaf) turns every
    port parameter into the reference's leaf, values included."""
    tm, module = port_pair(tree)
    ref = flat(tree)
    for name, p in module.state_dict().items():
        view, perm = tm.reference_layout(name, tuple(p.shape))
        net, *mods, leaf = name.split(".")
        leaf = "kernel" if leaf == "weight" else leaf
        key = f"['{net}']['params']" + "".join(f"['{m}']" for m in mods) + f"['{leaf}']"
        np.testing.assert_array_equal(p.reshape(view).permute(perm).numpy(), ref[key])


def test_sd15_example_config_parses_and_builds():
    cfg = tconfig.load_config("examples/sd15_flash.toml")
    (m,) = cfg.models
    assert (m.family, m.dtype, m.image_size, m.batch_buckets) == ("sd15", "bfloat16", 512, [1])
    assert (m.options["steps"], m.options["guidance"], m.options["unet_attention"]) == (
        20, 7.5, "flash")
    assert not cfg.genserve.enabled and tconfig.unported_settings(cfg) == []
    model = port_build(dataclasses.replace(m, options={**m.options, **TINY, "steps": 20}))
    assert model.steps == 20 and model.unet_attention == "flash"
