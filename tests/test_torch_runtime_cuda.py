"""The runtime's host-to-device copy on the card, with two batches in
flight: batch 2's ``h2d`` (``h2d_sync`` on) waits for its own copy only,
not for the forward of batch 1 still queued on the compute stream, and
each forward still reads its own inputs.

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
