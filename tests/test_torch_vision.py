"""Port parity for the image path's host and device halves against the JAX
package: ``tpuserve_torch.frame`` against ``tpuserve.frame``,
``tpuserve_torch.preproc`` and ``tpuserve_torch.native`` against
``tpuserve.preproc`` and ``tpuserve.native``, the vision serving contract
(``models/vision.py``, ``models/toy.py``) against the reference's, and the
typed vision and quantize config fields.

Exact where the reference is exact: frame bytes, parsed arrays and every
``FrameError`` message; host-decoded planes and RGB arrays (native shim, PIL
fallback, npy); the batches assembled from read-only frame views.

Device preprocessing, ``device_prepare_images`` (256 -> 224 and 40 -> 32
downscales, antialiased; 32 -> 32) and ``device_prepare_images_yuv420``
(160 -> 224 upscale with chroma 80 -> 160; 32 -> 32), on the same seeded
uint8 batch: float32 atol 1e-5 after normalisation (the resize filters
summed in another order; measured up to 1.2e-6 at 256 -> 224); bfloat16
within one bf16 spacing of the reference's value, or within that float32
atol near 0 where the spacing is smaller (both round float32 values that
differ by that little, so a value at a rounding midpoint may go either way).

The toy model: probabilities atol 1e-6 and identical indices in float32,
unquantized and int8 (the reference's runtime order: cast, quantize,
dequantize in the forward).
"""

import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import frame as jframe
from tpuserve import native as jnative
from tpuserve import preproc as jpreproc
from tpuserve import quantize as jqz
from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.models import build as jax_build
from tpuserve_torch import frame, native, preproc
from tpuserve_torch.config import ModelConfig, load_config, unported_settings
from tpuserve_torch.models import build
from tpuserve_torch.models.toy import from_jax_params as toy_from_jax_params
from tpuserve_torch.runtime import build_runtime

EDGE = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rgb_items(n, edge=EDGE, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (edge, edge, 3), dtype=np.uint8) for _ in range(n)]


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def photo_jpeg(edge=256, quality=90) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:edge, 0:edge].astype(np.float32) / edge
    arr = np.stack([0.5 + 0.4 * np.sin(6.0 * x), 0.5 + 0.4 * np.cos(5.0 * y),
                    0.5 + 0.4 * np.sin(4.0 * (x + y))], axis=-1)
    arr = np.clip((arr + rng.normal(0, 0.03, arr.shape)) * 255, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def assert_same_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for p, q in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            np.testing.assert_array_equal(p, q)


# -- frame ----------------------------------------------------------------------

def test_frame_constants_match():
    for name in ("CONTENT_TYPE", "MAGIC", "VERSION", "KIND_RGB8", "KIND_YUV420", "KIND_NAMES",
                 "KIND_BY_WIRE_FORMAT", "HEADER_SIZE"):
        assert getattr(frame, name) == getattr(jframe, name), name
    for kind in (frame.KIND_RGB8, frame.KIND_YUV420):
        for edge in (8, 16, 160):
            assert frame.item_nbytes(kind, edge) == jframe.item_nbytes(kind, edge)
            assert frame.frame_nbytes(kind, edge, 3) == jframe.frame_nbytes(kind, edge, 3)


def test_roundtrip_rgb8_zero_copy_matches_reference():
    items = rgb_items(3)
    body = frame.encode_frame(items, frame.KIND_RGB8, EDGE)
    assert body == jframe.encode_frame(items, jframe.KIND_RGB8, EDGE)
    out = frame.parse_frame(body, kind=frame.KIND_RGB8, edge=EDGE, max_items=64)
    assert_same_items(out, jframe.parse_frame(body, kind=jframe.KIND_RGB8, edge=EDGE,
                                              max_items=64))
    for a, b in zip(items, out):
        np.testing.assert_array_equal(a, b)
        assert not b.flags.writeable and not b.flags.owndata   # views over the body


def test_roundtrip_yuv420_matches_reference():
    edge = 16
    planes = [preproc.rgb_to_yuv420(r) for r in rgb_items(2, edge=edge, seed=3)]
    body = frame.encode_frame(planes, frame.KIND_YUV420, edge)
    assert body == jframe.encode_frame(planes, jframe.KIND_YUV420, edge)
    out = frame.parse_frame(body, kind=frame.KIND_YUV420, edge=edge, max_items=64)
    assert_same_items(out, planes)
    y, u, _ = out[0]
    assert y.shape == (edge, edge) and u.shape == (edge // 2, edge // 2)
    assert not y.flags.writeable


def _good(n=2):
    return frame.encode_frame(rgb_items(n), frame.KIND_RGB8, EDGE)


def _hdr(count, kind=frame.KIND_RGB8, edge=EDGE):
    return struct.pack("<4sHHII", b"TPUF", 1, kind, count, edge)


_SIZE = 3 * EDGE * EDGE
_YUV16 = frame.encode_frame([preproc.rgb_to_yuv420(rgb_items(1, edge=16)[0])],
                            frame.KIND_YUV420, 16)
MALFORMED = {
    "empty": (b"", {}),
    "short": (b"TPUF\x01\x00", {}),
    "bad_magic": (b"NOPE" + _good()[4:], {}),
    "version": (_good()[:4] + b"\x63\x00" + _good()[6:], {}),
    "unknown_kind": (_hdr(1, kind=9) + _good(1)[16:], {}),
    "truncated_table": (_good(2)[:frame.HEADER_SIZE + 4], {}),
    "past_end": (_good(2)[:-10], {}),
    "trailing_garbage": (_good(2) + b"xx", {}),
    "over_max_items": (_good(4), dict(max_items=3)),
    "zero_count": (_hdr(0) + np.asarray([0], "<u8").tobytes(), {}),
    "zero_length_item": (_hdr(2) + np.asarray([0, 0, _SIZE], "<u8").tobytes() + bytes(_SIZE), {}),
    "non_ascending": (_hdr(2) + np.asarray([0, 2 * _SIZE, 2 * _SIZE], "<u8").tobytes()
                      + bytes(2 * _SIZE), {}),
    "garbage_planes": (_hdr(2) + np.asarray([0, _SIZE - 7, 2 * _SIZE], "<u8").tobytes()
                       + bytes(2 * _SIZE), {}),
    "first_offset": (_hdr(1) + np.asarray([4, _SIZE + 4], "<u8").tobytes()
                     + bytes(_SIZE + 4), {}),
    "kind_mismatch": (_YUV16, dict(edge=16)),
    "edge_mismatch": (_good(1), dict(edge=16)),
    "absurd_count": (_hdr(5000) + _good(2)[16:], dict(max_items=1024)),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_frame_same_error_as_reference(case):
    body, over = MALFORMED[case]
    args = {**dict(kind=frame.KIND_RGB8, edge=EDGE, max_items=16), **over}
    with pytest.raises(jframe.FrameError) as want:
        jframe.parse_frame(body, **args)
    with pytest.raises(frame.FrameError) as got:
        frame.parse_frame(body, **args)
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value) and str(got.value).startswith("frame:")


def test_encode_rejects_what_the_reference_rejects():
    for items, kind in (([], frame.KIND_RGB8), (rgb_items(1, edge=4), frame.KIND_RGB8)):
        with pytest.raises(jframe.FrameError) as want:
            jframe.encode_frame(items, kind, EDGE)
        with pytest.raises(frame.FrameError, match="^frame:") as got:
            frame.encode_frame(items, kind, EDGE)
        assert str(got.value) == str(want.value)


# -- host preprocessing ---------------------------------------------------------

def test_native_shim_decodes_the_reference_planes():
    if not native.available():
        pytest.skip("native jpegyuv shim unavailable (no compiler or libjpeg)")
    assert native.library_path().parent.name == "native"        # build/native
    payload = photo_jpeg()
    y, u, v = native.decode_yuv420(payload, 256)
    assert y.shape == (256, 256) and u.shape == (128, 128) and v.shape == (128, 128)
    if jnative.available():
        assert_same_items([(y, u, v)], [jnative.decode_yuv420(payload, 256)])
    fy, fu, fv = preproc.rgb_to_yuv420(preproc.decode_image(payload, "image/jpeg", edge=256))
    for a, b in ((y, fy), (u, fu), (v, fv)):
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 3.0
    assert native.decode_yuv420(photo_jpeg(edge=100), 256) is None   # wrong size declines


@pytest.mark.parametrize("kind", ["png", "jpeg_wrong_size", "npy"])
def test_yuv_fallbacks_match_reference_and_count(kind):
    from PIL import Image

    if kind == "png":
        buf = io.BytesIO()
        Image.new("RGB", (64, 64), (200, 30, 60)).save(buf, format="PNG")
        payload, ctype = buf.getvalue(), "image/png"
    elif kind == "jpeg_wrong_size":
        payload, ctype = photo_jpeg(edge=100), "image/jpeg"
    else:
        payload, ctype = npy(rgb_items(1, edge=64)[0]), "application/x-npy"
    seen = []
    preproc.set_native_fallback_hook(seen.append)
    try:
        got = preproc.decode_image_yuv420(payload, ctype, 256, model="m")
    finally:
        preproc.set_native_fallback_hook(None)
    assert_same_items([got], [jpreproc.decode_image_yuv420(payload, ctype, 256)])
    assert got[0].shape == (256, 256) and got[1].shape == (128, 128)
    # npy never tries the shim; the other two fell back from it.
    assert seen == ([] if kind == "npy" else ["m"])


def test_rgb_to_yuv420_matches_reference():
    gray = np.full((32, 32, 3), 128, np.uint8)
    assert all((p == 128).all() for p in preproc.rgb_to_yuv420(gray))
    rgb = rgb_items(1, edge=32, seed=5)[0]
    assert_same_items([preproc.rgb_to_yuv420(rgb)], [jpreproc.rgb_to_yuv420(rgb)])


def test_decode_image_matches_reference():
    payload = photo_jpeg(edge=100)
    for edge in (64, 100, 256):
        np.testing.assert_array_equal(preproc.decode_image(payload, "image/jpeg", edge),
                                      jpreproc.decode_image(payload, "image/jpeg", edge))
    arr = rgb_items(1, edge=20)[0]
    for edge in (20, 16):
        np.testing.assert_array_equal(preproc.decode_image(npy(arr), "application/x-npy", edge),
                                      jpreproc.decode_image(npy(arr), "application/x-npy", edge))
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 3), np.float32)):
        with pytest.raises(ValueError) as want:
            jpreproc.decode_image_array(bad, 4)
        with pytest.raises(ValueError) as got:
            preproc.decode_image_array(bad, 4)
        assert str(got.value) == str(want.value)


def test_decode_npy_items_single_vs_batch():
    one = rgb_items(1, edge=16)[0]
    for body, edge in ((npy(one), 16), (npy(np.stack([one, one + 1])), 16),
                       (npy(np.stack([one, one + 1])), 8)):
        got, batched = preproc.decode_npy_items(body, edge, max_items=8)
        want, jbatched = jpreproc.decode_npy_items(body, edge, max_items=8)
        assert batched == jbatched
        assert_same_items(got, want)
    with pytest.raises(ValueError, match="limit"):
        preproc.decode_npy_items(npy(np.zeros((9, 4, 4, 3), np.uint8)), 4, max_items=8)


# -- device preprocessing -------------------------------------------------------

def within_one_bf16_spacing(got: np.ndarray, want: np.ndarray, atol: float = 1e-5) -> None:
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= np.maximum(spacing, atol)).all(), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire, edge, size", [
    ("rgb8", 256, 224), ("rgb8", 40, 32), ("rgb8", 32, 32),
    ("yuv420", 160, 224), ("yuv420", 32, 32)])
def test_device_preprocess_matches_reference(wire, edge, size, dtype):
    rng = np.random.default_rng(edge + size)
    if wire == "rgb8":
        planes = (rng.integers(0, 256, (2, edge, edge, 3), dtype=np.uint8),)
        ref = jpreproc.device_prepare_images(planes[0], size, dtype=jnp.dtype(dtype))
        got = preproc.device_prepare_images(torch.from_numpy(planes[0]), size,
                                            dtype=getattr(torch, dtype))
    else:
        planes = (rng.integers(0, 256, (2, edge, edge), dtype=np.uint8),
                  rng.integers(0, 256, (2, edge // 2, edge // 2), dtype=np.uint8),
                  rng.integers(0, 256, (2, edge // 2, edge // 2), dtype=np.uint8))
        ref = jpreproc.device_prepare_images_yuv420(*planes, size, dtype=jnp.dtype(dtype))
        got = preproc.device_prepare_images_yuv420(*map(torch.from_numpy, planes), size,
                                                   dtype=getattr(torch, dtype))
    assert got.shape == (2, 3, size, size) and got.dtype == getattr(torch, dtype)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        within_one_bf16_spacing(got, want)


# -- the serving contract ---------------------------------------------------------

def vision_pair(**over):
    kw = dict(name="m", family="resnet50", dtype="float32", wire_size=16,
              wire_format="yuv420", parallelism="single", batch_buckets=[4])
    kw.update(over)
    return jax_build(JaxModelConfig(**kw)), build(ModelConfig(**kw))


@pytest.mark.parametrize("wire", ["rgb8", "yuv420"])
def test_vision_host_contract_matches_reference(wire):
    jm, tm = vision_pair(wire_format=wire)
    jsig, tsig = jm.input_signature((4,)), tm.input_signature((4,))
    jsig = jsig if isinstance(jsig, tuple) else (jsig,)
    assert [(tuple(s.shape), np.dtype(s.dtype)) for s in jsig] == \
        [(s.shape, s.dtype) for s in tsig]
    assert_same_items([tm.canary_item()], [jm.canary_item()])
    rgbs = rgb_items(3, edge=16, seed=9)
    items = rgbs if wire == "rgb8" else [preproc.rgb_to_yuv420(r) for r in rgbs]
    kind = frame.KIND_BY_WIRE_FORMAT[wire]
    bodies = [(frame.encode_frame(items, kind, 16), frame.CONTENT_TYPE),
              (npy(np.stack(rgbs)), "application/x-npy"), (npy(rgbs[0]), "application/x-npy")]
    for body, ctype in bodies:
        (got, batched), (want, jbatched) = (m.host_decode_items(body, ctype) for m in (tm, jm))
        assert batched == jbatched
        assert_same_items(got, want)
    # The framed and the npy wire hand the batcher the same items.
    assert_same_items(tm.host_decode_items(*bodies[0])[0], tm.host_decode_items(*bodies[1])[0])
    small = rgb_items(1) if wire == "rgb8" else [preproc.rgb_to_yuv420(rgb_items(1)[0])]
    with pytest.raises(frame.FrameError, match="wire_size"):
        tm.host_decode_items(frame.encode_frame(small, kind, EDGE), frame.CONTENT_TYPE)


def test_assemble_into_accepts_readonly_frame_views():
    """Read-only frame views copy into a preallocated (dirty) arena-shaped
    buffer in place, giving what the allocating assemble gives."""
    for model in (build(ModelConfig(name="toy", family="toy", dtype="float32", num_classes=10,
                                    parallelism="single", batch_buckets=[4])),
                  vision_pair()[1]):
        edge = 8 if model.cfg.family == "toy" else 16
        rgbs = rgb_items(3, edge=edge)
        items = rgbs if model.cfg.family == "toy" else [preproc.rgb_to_yuv420(r) for r in rgbs]
        kind = frame.KIND_RGB8 if model.cfg.family == "toy" else frame.KIND_YUV420
        parsed = model.host_decode_items(frame.encode_frame(items, kind, edge),
                                         frame.CONTENT_TYPE)[0]
        sig = model.input_signature((4,))
        out = tuple(np.ones(s.shape, s.dtype) for s in sig)     # dirty: padding must zero
        got = model.assemble_into(parsed, (4,), out)
        assert got is out
        assert_same_items([got], [model.assemble(parsed, (4,))])
        assert all((c[3] == 0).all() for c in got)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_toy_forward_matches_reference(quantize):
    kw = dict(name="toy", family="toy", dtype="float32", num_classes=10, parallelism="single",
              batch_buckets=[1, 4], quantize=quantize)
    jm, tm = jax_build(JaxModelConfig(**kw)), build(ModelConfig(**kw))
    tree = jax.device_get(jm.init_params(jax.random.key(0)))
    params = jqz.quantize_tree(tree, 4096) if quantize else tree
    tm.load_params = lambda: toy_from_jax_params(tree)
    rt = build_runtime(tm, device="cpu")
    batch = tm.assemble(rgb_items(3), (4,))
    want = jax.device_get(jax.jit(lambda p, b: jm.forward(
        jqz.dequantize_tree(p, jnp.float32) if quantize else p, b))(params, batch[0]))
    got = rt.fetch(rt.run((4,), batch))
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0, atol=1e-6)
    # Row 3 is padding: zeros give tied probabilities, ordered differently.
    np.testing.assert_array_equal(got["indices"][:3], want["indices"][:3])
    assert [r["top_k"][0]["class"] for r in tm.host_postprocess(got, 3)] == \
        [int(i) for i in want["indices"][:3, 0]]
    if quantize:
        assert rt.describe()["quantize"] == "int8"
        assert any(k.endswith("fc1.parametrizations.weight.original")
                   for k in rt.module.state_dict())


# -- config -----------------------------------------------------------------------

def test_resnet50_toml_parses_into_typed_fields():
    cfg = load_config("examples/resnet50.toml")
    assert unported_settings(cfg) == []
    m, rgb = cfg.model("resnet50"), cfg.model("resnet50_rgb")
    assert (m.family, m.wire_format, m.wire_size, m.image_size, m.quantize, m.deadline_ms,
            m.batch_buckets, m.parallelism, m.dtype) == \
        ("resnet50", "yuv420", 160, 224, "int8", 5.0, [1, 8, 32], "single", "bfloat16")
    assert (rgb.wire_format, rgb.wire_size, rgb.image_size, rgb.quantize) == \
        ("rgb8", 256, 224, None)
    assert m.quantize_min_size == 4096 and not m.unported
    block = load_config("examples/serve_all.toml").model("resnet50")
    assert (block.wire_format, block.wire_size, block.image_size, block.quantize) == \
        ("yuv420", 224, 224, None)
    cfg = load_config("examples/resnet50.toml", ["model.resnet50.image_size=64"])
    assert cfg.model("resnet50").image_size == 64
    with pytest.raises(ValueError, match="wire_format"):
        load_config("examples/resnet50.toml", ["model.resnet50.wire_format=jpeg"])


def test_int8c_and_unknown_quantize_refused():
    """int8c serves ResNet-50 (its 1x1 convolutions compute in int8) and is
    refused, with the reference's guidance, for a family that names no
    int8-native site (toy)."""
    cfg = load_config("examples/resnet50.toml", ["model.resnet50.quantize=int8c"])
    assert unported_settings(cfg) == []
    assert build(cfg.model("resnet50")).int8c_native_kernel_paths()
    kw = dict(name="t", family="toy", dtype="float32", num_classes=10, parallelism="single")
    with pytest.raises(ValueError, match=r"names no int8-native kernel sites; use quantize='int8'"):
        build_runtime(build(ModelConfig(quantize="int8c", **kw)), device="cpu")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        build_runtime(build(ModelConfig(quantize="int4", **kw)), device="cpu")
