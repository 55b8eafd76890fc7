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

Marked ``cuda``: it skips where there is no CUDA device (streams and
pinned copies exist only on the card). This file imports neither JAX nor
the JAX package:

    TPUSERVE_TEST_TPU=1 python -m pytest tests/test_torch_runtime_cuda.py -m cuda
"""

import json

import numpy as np
import pytest
import torch

from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models import build
from tpuserve_torch.models.resnet import ResNet, ResNet50Serving
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
