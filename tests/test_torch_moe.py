"""The Switch-MoE FFN in the port (``tpuserve_torch.ops.moe``, textgen's
``_moe_ffn``, BERT's ``SwitchFFN`` branch) against the reference's
(``tpuserve/ops/moe.py``, ``tpuserve/models/{textgen,bert}.py``) on the CPU,
on the same weights (the reference's seeded trees through
``from_jax_params``) and the same inputs (``np.random.default_rng``).
Tolerances:

- ``switch_route``: ``dispatch`` (who goes to which expert and queue slot,
  the over-capacity drops, padding) identical; ``combine`` within 2.4e-7
  relative and ``aux`` within 1e-6 (the float32 softmax: torch's ``exp``
  and XLA's may round the last bit apart, 2 ulps at most here);
- ``SwitchFFN`` against flax's on the same params, float32: within 1e-5
  abs (and against the per-token loop, the reference test's bar);
- MoE textgen (E 4 at narrow widths), float32: teacher-forced prefill and
  per-step logits within 1e-4 abs, tokens identical — through the locked
  forward and through the dense, paged and chunked engines of both
  packages;
- MoE BERT, flash and dense attention: float32 logits within 1e-4 abs,
  a padded lane included; bf16 within 3e-2 with identical top-1 wherever
  the reference's top-two gap exceeds it (tests/test_torch_bert.py's rule);
- ``from_jax_params`` -> ``to_jax_params`` bit for bit; weight-only int8 of
  the MoE BERT equal to ``quantize_tree`` leaf by leaf;
- the reference's refusals, with its messages.

The reference's MoE tests that need a multi-device mesh or training
(``tests/test_moe.py::test_train_step_with_expert_parallelism``,
``::test_moe_bert_expert_parallel_sharded``) wait for the mesh modes and
the training utilities (ROADMAP items 9, 10 and 13).
"""

import asyncio
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_quantize import assert_quantized_like_reference
from test_torch_textgen import record_sampling, seeded_items, torch_batch
from tpuserve import config as jconfig
from tpuserve import genserve as jgenserve
from tpuserve import obs as jobs
from tpuserve.models import build as jax_build
from tpuserve.ops import moe as jmoe
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve_torch import config as tconfig
from tpuserve_torch import genserve as tgenserve
from tpuserve_torch import obs as tobs
from tpuserve_torch import savedmodel as sm
from tpuserve_torch.models import build as port_build
from tpuserve_torch.ops import moe as tmoe
from tpuserve_torch.runtime import build_runtime as port_build_runtime

LOGIT_TOL = 1e-4
TG_OPTS = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512,
               prompt_len=16, max_new_tokens=24, moe_experts=4)
BERT_OPTS = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512, moe_experts=4)
TEXTS = ["hello world", "Serve this text, please!", "mixture of experts " * 3, ""]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# switch_route and SwitchFFN
# ---------------------------------------------------------------------------

def ref_route(logits, capacity, mask=None):
    """The reference's switch_route vmapped over groups, as numpy."""
    if mask is None:
        out = jax.vmap(lambda lg: jmoe.switch_route(lg, capacity))(logits)
    else:
        out = jax.vmap(lambda lg, m: jmoe.switch_route(lg, capacity, m))(logits, mask)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("g, t, e, cap, masked", [
    (3, 16, 4, 5, True), (2, 128, 8, 20, True), (4, 64, 4, 2, False),
    (5, 7, 2, 1, True), (8, 1, 8, 1, False)])
def test_switch_route_matches_reference(g, t, e, cap, masked):
    rng = np.random.default_rng(t * e + cap)
    logits = (rng.normal(size=(g, t, e)) * 2).astype(np.float32)
    mask = (rng.random((g, t)) > 0.3).astype(np.float32) if masked else None
    ref = ref_route(logits, cap, mask)
    got = tmoe.switch_route(torch.from_numpy(logits), cap,
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=0, atol=1e-6)
    assert got[0].shape == (g, t, e, cap)
    # Every real token routed at most once; no expert over its capacity.
    assert got[0].sum(dim=(-2, -1)).max() <= 1
    assert got[0].sum(dim=1).max() <= 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_over_capacity_tokens_drop_to_zero(side):
    """Capacity 1: later tokens routed to a full expert contribute exactly
    zero (first come first served along the sequence)."""
    logits = np.zeros((16, 2), np.float32)
    logits[:, 0] = 5.0
    if side == "jax":
        dispatch, combine, _ = (np.asarray(a) for a in jmoe.switch_route(logits, capacity=1))
    else:
        dispatch, combine, _ = (a.numpy() for a in tmoe.switch_route(
            torch.from_numpy(logits), capacity=1))
    assert dispatch.sum() == 1.0 and dispatch[0, 0, 0] == 1.0
    assert combine[1:].sum() == 0.0


def test_aux_is_one_for_perfect_balance():
    """Uniform routing: aux = E * sum(1/E * 1/E * E) = 1 (Switch eq. 4), on
    both packages alike."""
    t, e = 8, 4
    logits = np.eye(e, dtype=np.float32)[np.arange(t) % e] * 9.0
    ref = float(jmoe.switch_route(jnp.asarray(logits), capacity=t)[2])
    got = float(tmoe.switch_route(torch.from_numpy(logits), capacity=t)[2])
    np.testing.assert_allclose(got, 1.0, atol=0.05)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_padding_never_claims_capacity():
    """Masked tokens get zero output and consume no slot: at a fixed
    capacity the masked full-length route assigns the real prefix exactly
    like the prefix alone."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(8, 2)).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    d_full, c_full, _ = tmoe.switch_route(torch.from_numpy(logits), 2, torch.from_numpy(mask))
    d_pref, c_pref, _ = tmoe.switch_route(torch.from_numpy(logits[:4]), 2)
    np.testing.assert_array_equal(d_full[:4].numpy(), d_pref.numpy())
    np.testing.assert_array_equal(c_full[:4].numpy(), c_pref.numpy())
    assert d_full[4:].sum() == 0.0
    # Leading padding too: it must not push real tokens past capacity.
    lead = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float32)
    d_lead, _, _ = tmoe.switch_route(torch.from_numpy(logits), 2, torch.from_numpy(lead))
    np.testing.assert_array_equal(d_lead.numpy(), ref_route(logits[None], 2, lead[None])[0][0])
    assert d_lead[:4].sum() == 0.0


def flax_switch(e, f, cf, x, seed=0):
    mod = jmoe.SwitchFFN(experts=e, d_ff=f, capacity_factor=cf)
    params = jax.device_get(mod.init(jax.random.key(seed), jnp.asarray(x)))
    return mod, params


def port_switch(params, d, e, f, cf):
    mod = tmoe.SwitchFFN(d, e, f, cf)
    p = params["params"]
    mod.load_state_dict({k: torch.from_numpy(np.array(p[k])) for k in
                         ("router", "w_up", "w_down")})
    return mod


@pytest.mark.parametrize("cf, masked", [(8.0, False), (1.0, True), (1.25, True)])
def test_switch_ffn_matches_flax(cf, masked):
    """The port's SwitchFFN against flax's on the same params, float32:
    outputs within 1e-5, aux within 1e-6, dropped tokens exactly zero in
    both."""
    rng = np.random.default_rng(7)
    b, s, d, f, e = 3, 16, 8, 16, 4
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    mask = (rng.random((b, s)) > 0.25).astype(np.float32) if masked else None
    mod, params = flax_switch(e, f, cf, x)
    ref_y, ref_aux = mod.apply(params, jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask))
    pm = port_switch(params, d, e, f, cf)
    with torch.no_grad():
        y, aux = pm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=0, atol=1e-6)
    ref_zero = np.all(np.asarray(ref_y) == 0.0, axis=-1)
    np.testing.assert_array_equal(np.all(y.numpy() == 0.0, axis=-1), ref_zero)
    if masked:
        assert ref_zero[mask == 0].all()


def test_switch_ffn_matches_per_token_reference():
    """With ample capacity the static formulation equals the obvious
    per-token loop: y[t] = gate[t] * FFN_{argmax}(x[t]) (tanh GELU)."""
    rng = np.random.default_rng(0)
    b, s, d, f, e = 2, 8, 8, 16, 4
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    _, params = flax_switch(e, f, 8.0, x)
    pm = port_switch(params, d, e, f, 8.0)
    with torch.no_grad():
        y, aux = pm(torch.from_numpy(x))
    xt = torch.from_numpy(x.reshape(-1, d))
    gates = torch.softmax(xt @ pm.router, dim=-1)
    want = torch.zeros_like(xt)
    for i in range(xt.shape[0]):
        k = int(gates[i].argmax())
        h = torch.nn.functional.gelu(xt[i] @ pm.w_up[k], approximate="tanh")
        want[i] = gates[i, k] * (h @ pm.w_down[k])
    np.testing.assert_allclose(y.reshape(-1, d).detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert math.isfinite(float(aux)) and float(aux) > 0


# ---------------------------------------------------------------------------
# MoE textgen
# ---------------------------------------------------------------------------

def tg_cfg(pkg, weights=None, **opts):
    return pkg.ModelConfig(name="tg", family="textgen", batch_buckets=[1, 2, 4],
                           dtype="float32", parallelism="single", max_queue=64,
                           request_timeout_ms=60_000.0, weights=weights,
                           options={**TG_OPTS, **opts})


@pytest.fixture(scope="module", params=["dense", "flash"])
def tg_pair(request):
    jm = jax_build(tg_cfg(jconfig, attention=request.param))
    params = jax.device_get(jm.init_params(jax.random.key(3)))
    tm = port_build(tg_cfg(tconfig, attention=request.param))
    module = tm.build_module()
    module.load_state_dict(tm.from_jax_params(params))
    return jm, params, tm, module.eval()


def test_textgen_moe_round_trip_bit_exact(tg_pair):
    jm, params, tm, module = tg_pair
    assert "w_up" not in params["layer0"] and params["layer0"]["moe_up"].shape == (4, 32, 64)
    back = tm.to_jax_params(tm.from_jax_params(params))
    flat = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), got[path])
    assert set(module.state_dict()) == set(tm.from_jax_params(params))


def test_textgen_moe_teacher_forced_logits_and_tokens(tg_pair):
    """Prefill + 8 decode steps over 4 seeded requests at 0.7: each step's
    logits within 1e-4 of the reference's, tokens identical; then the full
    locked forward's tokens identical, greedy too."""
    jm, params, tm, module = tg_pair
    items = seeded_items(jm, 4, seed=11, temp=0.7)
    batch = jm.assemble(items, (4,))
    jcalls, tcalls = [], []
    jo = record_sampling(jm, jcalls, np.asarray)
    to = record_sampling(tm, tcalls, lambda a: a.detach().numpy().copy())
    try:
        js = jm._prefill(params, *batch)
        with torch.no_grad():
            ts = tm._prefill(module, *torch_batch(batch))
            for _ in range(8):
                js, _ = jm._decode_step(params, js)
                tm._decode_step(module, ts)
    finally:
        jm._sample, tm._sample = jo, to
    assert len(jcalls) == len(tcalls) == 9
    for jc, tc in zip(jcalls, tcalls):
        np.testing.assert_allclose(tc[0], jc[0], rtol=0, atol=LOGIT_TOL)
    for key in ("tokens", "n_new", "done", "pos"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    for temp, seed in ((0.0, 6), (0.7, 5)):
        batch = jm.assemble(seeded_items(jm, 4, seed=seed, temp=temp), (4,))
        ref = jax.device_get(jax.jit(jm.forward)(params, batch))
        with torch.no_grad():
            got = tm.forward(module, torch_batch(batch))
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
        np.testing.assert_array_equal(got["n_new"].numpy(), np.asarray(ref["n_new"]))


def test_textgen_moe_lane_independent(tg_pair):
    """Group size one: a lane's tokens do not depend on its neighbours (the
    same request alone and beside three others)."""
    jm, params, tm, module = tg_pair
    items = seeded_items(jm, 4, seed=13, temp=0.7)
    with torch.no_grad():
        alone = tm.forward(module, torch_batch(jm.assemble(items[:1], (1,))))
        packed = tm.forward(module, torch_batch(jm.assemble(items, (4,))))
    np.testing.assert_array_equal(alone["tokens"][0].numpy(), packed["tokens"][0].numpy())


@pytest.fixture(scope="module")
def moe_weights(tmp_path_factory):
    """The reference runtime's seeded MoE tree (flash prefill), and the
    same tree as the port's .npz."""
    jm = jax_build(tg_cfg(jconfig, attention="flash", max_new_tokens=48))
    tree = jax.device_get(jax_build_runtime(jm, compile_forward=False).params_per_mesh[0])
    path = str(tmp_path_factory.mktemp("moe") / "tg_moe.npz")
    sm.save_npz(path, tree)
    return tree, path


def engine_tokens(pkg: str, weights, requests, **gc) -> list:
    """Serve ``requests`` through one package's engine (4 slots), all at
    once; the tokens of each."""
    if pkg == "jax":
        model = jax_build(tg_cfg(jconfig, attention="flash", max_new_tokens=48))
        rt = jax_build_runtime(model, compile_forward=False)
        g, obs, cfgm = jgenserve, jobs, jconfig
    else:
        model = port_build(tg_cfg(tconfig, weights[1], attention="flash",
                                  max_new_tokens=48))
        rt = port_build_runtime(model, device="cpu", compile_forward=False)
        g, obs, cfgm = tgenserve, tobs, tconfig
    eng = g.GenEngine(model, rt, obs.Metrics(), cfgm.GenserveConfig(slots=4, **gc))
    eng.compile()

    async def go():
        await eng.start()
        try:
            futs = [eng.submit(model.host_decode(json.dumps(
                {"prompt": p, "seed": s, "max_new_tokens": n, "temperature": t}).encode(),
                "application/json")) for p, s, n, t in requests]
            return [(await f)["tokens"] for f in futs]
        finally:
            await eng.stop()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


@pytest.mark.parametrize("gc", [{}, dict(kv_paging=True, kv_page_tokens=8),
                                dict(kv_paging=True, kv_page_tokens=8, prefill_chunk=4)],
                         ids=["dense", "paged", "chunked"])
def test_textgen_moe_engine_tokens_match_reference(moe_weights, gc):
    """Eight seeded requests (4 slots: fold-ins and early exits) through the
    MoE engines of both packages: identical tokens, dense and paged KV."""
    rng = np.random.default_rng(17)
    words = "the model serves text fast and slow with new old high low tokens".split()
    requests = [(" ".join(rng.choice(words, int(rng.integers(1, 21)))),
                 int(rng.integers(-1000, 1000)), int(rng.integers(1, 49)),
                 float(rng.choice([0.0, 0.7]))) for _ in range(8)]
    ref = engine_tokens("jax", moe_weights, requests, **gc)
    got = engine_tokens("port", moe_weights, requests, **gc)
    assert got == ref


# ---------------------------------------------------------------------------
# MoE BERT
# ---------------------------------------------------------------------------

def bert_kw(**over) -> dict:
    base = dict(name="bert", family="bert", batch_buckets=[1, 2, 4],
                seq_buckets=[8, 16], deadline_ms=5.0, dtype="float32",
                num_classes=4, parallelism="single", request_timeout_ms=30_000.0,
                options=dict(BERT_OPTS))
    base.update(over)
    return base


def bert_pair(attention="flash", **over):
    kw = bert_kw(**over)
    kw["options"] = dict(kw["options"], attention=attention)
    return jax_build(jconfig.ModelConfig(**kw)), port_build(tconfig.ModelConfig(**kw))


@pytest.fixture(scope="module")
def bert_params():
    jm, _ = bert_pair("dense")
    return jax.device_get(jm.init_params(jax.random.key(0)))


def bert_batch(model, texts, bucket):
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in texts]
    return model.assemble(items, bucket)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bert_moe_logits_match_reference_f32(attention, bert_params):
    """Four texts in a (4, 16) bucket (a short one padded 13 tokens deep,
    an empty one) and three in (4, 16) (a padded lane): logits within 1e-4,
    top-k indices identical."""
    jm, tm = bert_pair(attention)
    mod = tm.build_module()
    mod.load_state_dict(tm.from_jax_params(bert_params))
    for texts in (TEXTS, TEXTS[:3]):
        batch = bert_batch(tm, texts, (4, 16))
        ref = np.asarray(jm.module.apply(bert_params, *batch))
        ref_out = jm.forward(bert_params, batch)
        with torch.inference_mode():
            tb = tuple(torch.from_numpy(x) for x in batch)
            logits = mod(*tb).numpy()
            out = tm.forward(mod, tb)
        np.testing.assert_allclose(logits, ref, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(ref_out["indices"]))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bert_moe_logits_match_reference_bf16(attention, bert_params):
    jm, tm = bert_pair(attention, dtype="bfloat16")
    pb = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), bert_params)
    mod = tm.build_module()
    mod.load_state_dict(tm.from_jax_params(bert_params))
    mod.to(torch.bfloat16)
    batch = bert_batch(tm, TEXTS, (4, 16))
    ref = np.asarray(jm.module.apply(pb, *batch), np.float32)
    with torch.inference_mode():
        logits = mod(*(torch.from_numpy(x) for x in batch)).numpy()
    np.testing.assert_allclose(logits, ref, rtol=0, atol=3e-2)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 3e-2
    np.testing.assert_array_equal(logits.argmax(-1)[clear], ref.argmax(-1)[clear])


def test_bert_moe_round_trip_bit_exact(bert_params):
    _, tm = bert_pair("flash")
    assert set(bert_params["params"]["layer0"]["moe"]) == {"router", "w_up", "w_down"}
    sd = tm.from_jax_params(bert_params)
    assert set(sd) == set(tm.build_module().state_dict())
    back = tm.to_jax_params(sd)
    flat = jax.tree_util.tree_leaves_with_path(bert_params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), got[path])


def test_bert_moe_serves_single_device_padding_invariant():
    """Served through the port's runtime (seeded weights: the reference
    refuses weights= for MoE): row 0's answer does not depend on how many
    lanes ride along (per-row routing, padding masked)."""
    model = port_build(tconfig.ModelConfig(**bert_kw(batch_buckets=[4], seq_buckets=[16])))
    rt = port_build_runtime(model, device="cpu")
    item = model.host_decode(b'{"text": "mixture of experts"}', "application/json")
    out1 = rt.fetch(rt.run((4, 16), model.assemble([item], (4, 16))))
    out2 = rt.fetch(rt.run((4, 16), model.assemble([item] * 3, (4, 16))))
    assert np.isfinite(out1["probs"]).all()
    np.testing.assert_allclose(out1["probs"][0], out2["probs"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out1["indices"][0], out2["indices"][0])


def test_bert_moe_int8_quantizes_like_reference(bert_params):
    """Weight-only int8 of the MoE BERT: the router (d, E) and the expert
    stacks (E, d, f) / (E, f, d) quantize on the reference's channel (the
    last axis), bit for bit with quantize_tree."""
    jm, tm = bert_pair("flash", quantize="int8")
    n = assert_quantized_like_reference(jm, tm, bert_params, "bfloat16", 16)
    assert n >= 2 * 3


# ---------------------------------------------------------------------------
# The reference's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over, match", [
    (dict(parallelism="pipeline"), "does not compose with options.moe_experts"),
    (dict(parallelism="sharded", tp=2, options=dict(BERT_OPTS, moe_experts=3)), "divide"),
    (dict(weights="/nonexistent/savedmodel"), "moe_experts cannot be combined"),
])
def test_bert_moe_refusals_match_reference(over, match):
    """The same ValueError, with the same message, from both packages."""
    msgs = []
    for pkg, build_fn in ((jconfig, jax_build), (tconfig, port_build)):
        kw = bert_kw(**over)
        with pytest.raises(ValueError, match=match) as err:
            build_fn(pkg.ModelConfig(**kw))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_bert_moe_int8c_refused_like_reference():
    """int8 COMPUTE names no int8-native kernel on the MoE variant: both
    runtimes refuse it rather than quietly serve weight-only."""
    jm, tm = bert_pair("flash", quantize="int8c")
    assert jm.int8c_native_kernel_paths() == tm.int8c_native_kernel_paths() == []
    msgs = []
    for build_fn, model, kw in ((jax_build_runtime, jm, {}),
                               (port_build_runtime, tm, {"device": "cpu"})):
        with pytest.raises(ValueError, match="int8 COMPUTE") as err:
            build_fn(model, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("experts", [1, -2])
def test_textgen_moe_expert_count_checked_like_reference(experts):
    for pkg, build_fn in ((jconfig, jax_build), (tconfig, port_build)):
        with pytest.raises(ValueError, match="moe_experts must be 0"):
            build_fn(tg_cfg(pkg, moe_experts=experts))
