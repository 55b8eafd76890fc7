"""The runtime's parameter slots and version machine on the CPU, against the
JAX package's runtime (``tpuserve.runtime.ModelRuntime``) on the toy model:

- the version machine answers exactly as the reference's
  (``tests/test_lifecycle.py``'s sequence: 1 -> 2 -> 3, rollback to 2, no
  second rollback, then 4);
- the stage gates fire in the reference's order with the reference's
  messages, injected or real: integrity, NaN/Inf scan (the same keystr paths
  named), structure;
- a candidate lands in a free slot (neither live nor last-known-good) while
  the live slot keeps answering bit-identically; the staged canary
  (``params_override``) runs the candidate's slot; a stage after a rollback
  reuses the slot rolled back from; a staged handle that a later stage
  overwrote is refused at publish;
- ``dispatch`` fires the device_error and slow_compute injections;
  ``ensure_compiled`` returns 0 at steady state and rebuilds a missing
  variant; ``probe_raw_ms`` records a positive time per bucket; a graph
  replay's launches are added to the kernels' counts.

The toy's answers from the same tree agree with the reference's within
probabilities atol 1e-6 (float32) with identical indices.
"""

import time

import jax
import numpy as np
import pytest
import torch

from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.faults import FaultInjector as JaxInjector
from tpuserve.models import build as jax_build
from tpuserve.runtime import NaNDetected as JaxNaN
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve.savedmodel import save_orbax
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.faults import FaultInjected, FaultInjector
from tpuserve_torch.models import build
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.runtime import N_SLOTS, NaNDetected, build_runtime

MODEL = dict(name="toy", family="toy", batch_buckets=[1, 2, 4], deadline_ms=5.0,
             dtype="float32", num_classes=10, parallelism="single")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def toy_tree(key: int = 1, num_classes: int = 10):
    jm = jax_build(JaxModelConfig(**dict(MODEL, num_classes=num_classes)))
    return jax.tree_util.tree_map(np.array, jax.device_get(jm.init_params(jax.random.key(key))))


def runtimes(tmp_path, tree=None):
    """(the JAX package's runtime, the port's) on the toy; with ``tree``,
    both serve it from a checkpoint (orbax / .npz) and return its paths."""
    jckpt, ckpt = str(tmp_path / "ckpt"), str(tmp_path / "ckpt.npz")
    if tree is not None:
        save_orbax(jckpt, tree)
        sm.save_npz(ckpt, tree)
    weights = tree is not None
    jrt = jax_build_runtime(jax_build(JaxModelConfig(**dict(MODEL, weights=jckpt if weights else None))))
    rt = build_runtime(build(ModelConfig(**dict(MODEL, weights=ckpt if weights else None))),
                       device="cpu")
    return jrt, rt, jckpt, ckpt


def image_batch(model, bucket=(4,), seed=0):
    rng = np.random.default_rng(seed)
    return model.assemble(list(rng.integers(0, 256, (bucket[0], 8, 8, 3), dtype=np.uint8)),
                          bucket)


def answers(rt, bucket=(4,), override=None):
    batch = image_batch(rt.model, bucket)
    if override is None:
        return rt.fetch(rt.run(bucket, batch))
    return rt.fetch(rt.run(bucket, batch, params_override=override))


def test_version_machine_matches_reference(tmp_path):
    jrt, rt, _, _ = runtimes(tmp_path)
    seen = []
    for r in (jrt, rt):
        steps = [r.version]
        steps.append(r.publish(r.stage_params()))
        steps.append(r.publish(r.stage_params()))
        steps.append(r.rollback())
        with pytest.raises(ValueError, match="no retained previous") as err:
            r.rollback()
        steps.append(str(err.value))
        steps.append(r.publish(r.stage_params()))
        seen.append(steps)
    assert seen[1] == seen[0]
    assert [s["version"] for s in seen[1][1:4]] == [2, 3, 2] and seen[1][-1]["version"] == 4


def test_stage_gates_match_reference(tmp_path):
    tree = toy_tree(1)
    jrt, rt, jckpt, ckpt = runtimes(tmp_path, tree)
    np.testing.assert_allclose(answers(rt)["probs"], answers(jrt)["probs"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(answers(rt)["indices"], answers(jrt)["indices"])
    before = answers(rt)

    def errors(exc_types):
        out = []
        for r, e in zip((jrt, rt), exc_types):
            with pytest.raises(e) as err:
                r.stage_params()
            out.append(str(err.value))
        return out

    # NaN/Inf: same gate, same message (the keystr paths of the bad leaves).
    poisoned = toy_tree(2)
    poisoned["w2"][3, 3] = np.nan
    poisoned["b1"][0] = -np.inf
    save_orbax(jckpt + "2", poisoned)
    sm.save_npz(ckpt, poisoned)
    jrt.cfg.weights = jckpt + "2"
    ref_msg, msg = errors((JaxNaN, NaNDetected))
    assert msg == ref_msg and "['b1']" in msg and "['w2']" in msg
    # Structure: a tree for another head.
    wrong = toy_tree(2, num_classes=12)
    save_orbax(jckpt + "3", wrong)
    sm.save_npz(ckpt, wrong)
    jrt.cfg.weights = jckpt + "3"
    errors((ValueError, ValueError))
    # Integrity: a stale manifest over changed bytes.
    sm.save_npz(ckpt, toy_tree(3))
    sm.write_manifest(ckpt, toy_tree(4))
    with pytest.raises(sm.IntegrityError, match="corrupt"):
        rt.stage_params()
    # Injected: the reference's gate order and messages.
    for kind, exc in (("reload_corrupt", sm.IntegrityError), ("reload_nan", NaNDetected)):
        jrt.injector = JaxInjector.single(kind)
        rt.injector = FaultInjector.single(kind)
        sm.save_npz(ckpt, toy_tree(3))
        jrt.cfg.weights = jckpt
        ref_msg, msg = errors((Exception, exc))
        assert msg == ref_msg and "(injected)" in msg
    assert rt.version == 1
    np.testing.assert_array_equal(answers(rt)["probs"], before["probs"])


def test_candidate_goes_to_a_free_slot(tmp_path):
    _, rt, _, ckpt = runtimes(tmp_path, toy_tree(1))
    v1 = answers(rt)
    sm.save_npz(ckpt, toy_tree(2))
    staged = rt.stage_params()
    assert staged.slot not in (0,) and len(rt.slots) == N_SLOTS
    np.testing.assert_array_equal(answers(rt)["probs"], v1["probs"])   # live untouched
    canary = answers(rt, override=staged)
    assert not np.array_equal(canary["probs"], v1["probs"])
    rt.publish(staged)
    np.testing.assert_array_equal(answers(rt)["probs"], canary["probs"])
    assert rt.describe()["slots"] == {"count": 3, "live": staged.slot, "previous": 0}
    # With live and last-known-good held, the third slot is the only free one.
    sm.save_npz(ckpt, toy_tree(3))
    third = rt.stage_params()
    assert third.slot not in (0, staged.slot)
    # After a rollback the slot rolled back from is free again; a second
    # stage overwrites the handle staged before it.
    rt.rollback()
    np.testing.assert_array_equal(answers(rt)["probs"], v1["probs"])
    first = rt.stage_params()
    second = rt.stage_params()
    assert first.slot == second.slot == staged.slot
    with pytest.raises(ValueError, match="overwritten"):
        rt.publish(first)
    rt.publish(second)
    assert rt.version == 3 and rt.previous_version == 1


def test_dispatch_fires_device_error_and_slow_compute(tmp_path):
    _, rt, _, _ = runtimes(tmp_path)
    batch = image_batch(rt.model)
    rt.injector = FaultInjector.single("device_error", count=1)
    with pytest.raises(FaultInjected, match="device_error"):
        rt.run((4,), batch)
    rt.fetch(rt.run((4,), batch))                    # count exhausted
    rt.injector = FaultInjector.single("slow_compute", delay_ms=150.0, count=1)
    t0 = time.perf_counter()
    rt.fetch(rt.run((4,), batch))
    assert time.perf_counter() - t0 >= 0.15


def test_ensure_compiled_probe_and_replay_counts(tmp_path):
    _, rt, _, _ = runtimes(tmp_path)
    compiles = rt.compiles_total
    rt.publish(rt.stage_params())
    rt.rollback()
    assert rt.ensure_compiled() == 0 and rt.compiles_total == compiles == 3
    key = rt.variant_key((2,))
    del rt.variants[key]
    assert rt.ensure_compiled() == 1 and key in rt.variants
    probes = rt.probe_all_raw(iters=2)
    assert sorted(probes) == [(1,), (2,), (4,)] and all(v > 0 for v in probes.values())
    k1, k2 = fa.launches, fa.stats_launches
    fa.count_replay(12, 0)
    fa.count_replay(0, 12)
    assert (fa.launches - k1, fa.stats_launches - k2) == (12, 12)
    # The counts are process-wide: put them back for the tests that follow
    # in this process (the served CPU paths must read 0 launches).
    fa.launches, fa.stats_launches = k1, k2
    assert rt.describe()["captures_total"] == 0      # graphs exist on the card only
