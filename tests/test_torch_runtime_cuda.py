"""The runtime's host-to-device copy on the card, with two batches in
flight: batch 2's ``h2d`` (``h2d_sync`` on) waits for its own copy only,
not for the forward of batch 1 still queued on the compute stream, and
each forward still reads its own inputs.

The vision path on the card against the same model on the CPU: device
preprocessing (both wires, antialiased downscale and upscale) float32 atol
1e-5; a cut ResNet (``build_module`` patched to stage sizes (1, 1, 1, 1),
64 pixels) in float32 with
TF32 off, logits atol 1e-4 x their scale; under ``quantize = "int8"`` the
weights stay int8 with float32 scales on the card, equal to the CPU's.

Serving from CUDA graphs (one per bucket and parameter slot): for every
bucket of a tiny BERT (flash and ring attention; flash under int8c), the
toy, a cut ResNet (int8 and int8c) and the reference's tiny EfficientDet
(whose NMS tail runs inside the graph), the graph replay answers
bit-identically to the eager forward of the live slot on the same resident
input, every output; publish and rollback across
staged weights capture nothing new and rollback answers bit-identically to
before; two threads dispatching batches of one bucket concurrently
(the batcher's depth-2 h2d stage) each get their own answers; and the
kernels' launch counts grow by the launches each replayed graph recorded
(2 per batch for a 2-layer BERT's K1, or K2 as the ring's local step).

Marked ``cuda``: it skips where there is no CUDA device (streams and
pinned copies exist only on the card). This file imports neither JAX nor
the JAX package:

    TPUSERVE_TEST_TPU=1 python -m pytest tests/test_torch_runtime_cuda.py -m cuda
"""

import importlib
import json
import threading

import numpy as np
import pytest
import torch

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models import build
from tpuserve_torch.models.resnet import ResNet, ResNet50Serving
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.runtime import build_runtime

pytestmark = pytest.mark.cuda

BUCKET = (2, 16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copy stream exists only on the card")
    return torch.device("cuda")


def pinned_batch(model, texts):
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in texts]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory().numpy()
                 for a in model.assemble(items, BUCKET))


def test_h2d_does_not_wait_for_the_forward_in_flight(cuda):
    model = build(ModelConfig(
        name="b", family="bert", parallelism="single", dtype="float32",
        batch_buckets=[2], seq_buckets=[16], num_classes=4,
        options=dict(layers=1, d_model=32, heads=2, d_ff=64, vocab_size=512)))
    rt = build_runtime(model, device=cuda)
    rt.h2d_sync = True
    first = pinned_batch(model, ["first batch", "of two"])
    second = pinned_batch(model, ["the second", "batch in flight"])
    alone = [rt.fetch(rt.run(BUCKET, b)) for b in (first, second)]

    torch.cuda._sleep(2_000_000_000)          # about a second of card time
    busy = torch.cuda.Event()
    busy.record()
    out1 = rt.run(BUCKET, first)              # queued behind the busy work
    dev2 = rt.h2d(BUCKET, second)
    assert not busy.query(), "h2d waited for the work queued before its copy"
    out2 = rt.dispatch(BUCKET, dev2)
    for got, want in zip((rt.fetch(out1), rt.fetch(out2)), alone):
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6)


@pytest.mark.parametrize("wire, edge", [("rgb8", 80), ("yuv420", 48)])
def test_vision_path_on_the_card_matches_the_cpu(cuda, wire, edge, monkeypatch):
    monkeypatch.setattr(ResNet50Serving, "build_module", lambda self: ResNet(
        (1, 1, 1, 1), self.cfg.num_classes, self.v1_downsample, self.bn_eps))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(name="r", family="resnet50", parallelism="single", dtype="float32",
                      batch_buckets=[4], image_size=64, wire_size=edge, wire_format=wire,
                      quantize="int8")
    rng = np.random.default_rng(5)
    batch = tuple(rng.integers(0, 256, s.shape, dtype=np.uint8)
                  for s in build(cfg).input_signature((4,)))
    runs = []
    for device in ("cpu", cuda):
        model = build(cfg)
        rt = build_runtime(model, device=device)
        with torch.inference_mode():
            x = model.device_preprocess(rt.h2d((4,), batch))
            runs.append((x.float().cpu(), rt.module(x).float().cpu(),
                         {k: v.cpu() for k, v in rt.module.state_dict().items()}))
    (x_cpu, l_cpu, held_cpu), (x_gpu, l_gpu, held_gpu) = runs
    np.testing.assert_allclose(x_gpu.numpy(), x_cpu.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(l_gpu.numpy(), l_cpu.numpy(), rtol=0,
                               atol=1e-4 * float(l_cpu.abs().max()))
    assert any(k.endswith(".original") for k in held_gpu)
    for k, v in held_gpu.items():
        if k.endswith(".original"):
            assert v.dtype == torch.int8, k
        if k.endswith(".scale"):
            assert v.dtype == torch.float32, k
        assert torch.equal(v, held_cpu[k]), k


TINY = dict(layers=2, d_model=128, heads=2, d_ff=256, vocab_size=512)  # head dim 64


def served_model(kind: str, monkeypatch):
    """A small model of each served family, its cfg on one of the card's
    dtypes."""
    monkeypatch.setattr(ResNet50Serving, "build_module", lambda self: ResNet(
        (1, 1, 1, 1), self.cfg.num_classes, self.v1_downsample, self.bn_eps))
    if kind in ("flash", "ring", "flash_int8c"):
        return build(ModelConfig(
            name="b", family="bert", parallelism="single", dtype="bfloat16",
            batch_buckets=[1, 4], seq_buckets=[64, 128], num_classes=8,
            options=dict(TINY, attention=kind.split("_")[0]),
            quantize="int8c" if kind.endswith("int8c") else None, quantize_min_size=1024))
    if kind == "toy":
        return build(ModelConfig(name="t", family="toy", parallelism="single",
                                 dtype="float32", batch_buckets=[1, 4], num_classes=10))
    if kind == "efficientdet":
        return build(ModelConfig(
            name="d", family="efficientdet", parallelism="single", dtype="bfloat16",
            batch_buckets=[1, 4], image_size=64, wire_size=64, wire_format="yuv420",
            options=dict(det_classes=5, fpn_channels=16, fpn_repeats=1, head_repeats=1,
                         max_level=5, pre_nms=32, max_dets=8, backbone_width=0.25,
                         backbone_depth=0.35, score_thresh=0.005)))
    return build(ModelConfig(name="r", family="resnet50", parallelism="single",
                             dtype="bfloat16", batch_buckets=[1, 4], image_size=64,
                             wire_size=48, wire_format="yuv420", quantize=kind.split("_")[1]))


def random_batch(model, bucket, seed=0):
    rng = np.random.default_rng(seed)
    if model.cfg.family == "bert":
        texts = [" ".join(rng.choice(["serve", "the", "model", "text", "fast"], 9 + 7 * i))
                 for i in range(bucket[0])]
        items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
                 for t in texts]
        return model.assemble(items, bucket)
    return tuple(rng.integers(0, 256, s.shape, dtype=np.uint8)
                 for s in model.input_signature(bucket))


@pytest.mark.parametrize("kind", ["flash", "ring", "toy", "resnet_int8", "flash_int8c",
                                  "resnet_int8c", "efficientdet"])
def test_graph_replay_equals_eager_forward_per_bucket(cuda, kind, monkeypatch):
    model = served_model(kind, monkeypatch)
    rt = build_runtime(model, device=cuda)
    assert rt.captures_total == 3 * len(model.buckets())
    for bucket in model.buckets():
        dev = rt.h2d(bucket, random_batch(model, bucket))
        replay = rt.fetch(rt.dispatch(bucket, dev))
        with torch.inference_mode():
            eager = rt.fetch(model.forward(rt.module, dev))
        assert replay.keys() == eager.keys()
        for key in replay:
            assert replay[key].dtype == eager[key].dtype
            np.testing.assert_array_equal(replay[key], eager[key], err_msg=key)


def test_publish_and_rollback_capture_nothing(cuda, monkeypatch):
    model = served_model("resnet_int8", monkeypatch)
    rt = build_runtime(model, device=cuda)
    captures, compiles = rt.captures_total, rt.compiles_total
    batch = random_batch(model, (4,))
    v1 = rt.fetch(rt.run((4,), batch))
    tree = model.to_jax_params(model.init_params(1))
    model.load_tree = lambda **kw: tree
    staged = rt.stage_params()
    canary = rt.fetch(rt.run((4,), batch, params_override=staged))
    np.testing.assert_array_equal(rt.fetch(rt.run((4,), batch))["probs"], v1["probs"])
    rt.publish(staged)
    v2 = rt.fetch(rt.run((4,), batch))
    np.testing.assert_array_equal(v2["probs"], canary["probs"])
    assert not np.array_equal(v2["probs"], v1["probs"])
    rt.rollback()
    back = rt.fetch(rt.run((4,), batch))
    np.testing.assert_array_equal(back["probs"], v1["probs"])
    np.testing.assert_array_equal(back["indices"], v1["indices"])
    rt.publish(rt.stage_params())                      # into the slot rolled back from
    assert rt.ensure_compiled() == 0
    assert (rt.captures_total, rt.compiles_total) == (captures, compiles)


def test_depth2_concurrent_batches_of_one_bucket_get_their_own_answers(cuda, monkeypatch):
    model = served_model("flash", monkeypatch)
    rt = build_runtime(model, device=cuda)
    bucket = (4, 64)
    batches = [random_batch(model, bucket, seed=s) for s in range(4)]
    want = [rt.fetch(rt.run(bucket, b)) for b in batches]
    errors = []

    def worker(i: int) -> None:
        for n in range(40):
            k = (i + n) % len(batches)
            got = rt.fetch(rt.run(bucket, batches[k]))
            if not (np.array_equal(got["probs"], want[k]["probs"])
                    and np.array_equal(got["indices"], want[k]["indices"])):
                errors.append((i, n, k))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


@pytest.mark.parametrize("kind, per_batch", [("flash", (2, 0)), ("ring", (0, 2))])
def test_replays_count_their_kernel_launches(cuda, kind, per_batch, monkeypatch):
    # The ring's local step takes K2 at any size with the threshold at 0.
    monkeypatch.setattr(importlib.import_module("tpuserve_torch.ops.ring_attention"),
                        "DENSE_SCORE_BYTES_MAX", 0)
    model = served_model(kind, monkeypatch)
    rt = build_runtime(model, device=cuda)
    for bucket in model.buckets():
        assert rt.slots[0].graphs[bucket].launches == per_batch
    fa.reset_launches()
    for bucket in model.buckets():
        rt.fetch(rt.run(bucket, random_batch(model, bucket)))
    n = len(model.buckets())
    assert (fa.launches, fa.stats_launches) == (n * per_batch[0], n * per_batch[1])
