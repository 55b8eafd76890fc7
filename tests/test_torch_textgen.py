"""``tpuserve_torch.models.textgen`` against ``tpuserve/models/textgen.py`` on
the CPU, on the same weights (the reference's seeded tree through
``from_jax_params``) and the same inputs (prompts and sampling parameters
from ``np.random.default_rng``), at the reference tests' tiny size (2
layers, d 32, vocab 512, float32). Tolerances:

- prefill and per-step logits: within 1e-4 (abs) of the reference's, dense
  and flash attention (the port's flash prefill takes K1's plain version on
  CPU tensors; the reference runs its Pallas kernel in interpret mode, as
  its own CPU tests do);
- tokens, greedy and at temperature 0.7 (Gumbel noise from the port's
  threefry): identical. A differing token fails unless the reference's
  top-two margin of the sampling scores at that step is below 1e-4; such
  steps are reported (none occur on these inputs);
- the paged programs (whole-prompt and chunked prefill into pages, the
  paged decode step): the page pool within 1e-4, tokens identical;
- host side — ``host_decode`` items and its errors, ``detokenize``,
  ``host_postprocess`` — exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import config as jconfig
from tpuserve.models import build as jax_build
from tpuserve_torch import config as tconfig
from tpuserve_torch.models import build as port_build

TG_OPTS = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512,
               prompt_len=16, max_new_tokens=24)
LOGIT_TOL = 1e-4
MARGIN = 1e-4


def cfg(pkg, **opts):
    return pkg.ModelConfig(name="tg", family="textgen", batch_buckets=[1, 2, 4],
                           dtype="float32", parallelism="single",
                           options={**TG_OPTS, **opts})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["dense", "flash"])
def pair(request):
    """(reference model, its params, port model, port module) on one tree."""
    jm = jax_build(cfg(jconfig, attention=request.param))
    params = jax.device_get(jm.init_params(jax.random.key(3)))
    tm = port_build(cfg(tconfig, attention=request.param))
    module = tm.build_module()
    module.load_state_dict(tm.from_jax_params(params))
    return jm, params, tm, module.eval()


def seeded_items(model, n: int, seed: int, temp: float) -> list:
    """``n`` decoded requests: prompts of 1-20 seeded words (some longer
    than the 16-token bucket), seeds, and max_new_tokens over 1..24."""
    rng = np.random.default_rng(seed)
    words = "the model serves text fast and slow with new old high low tokens".split()
    out = []
    for i in range(n):
        prompt = " ".join(rng.choice(words, int(rng.integers(1, 21))))
        body = {"prompt": prompt, "seed": int(rng.integers(-2**31, 2**31 - 1)),
                "max_new_tokens": int(rng.integers(1, 25)), "temperature": temp}
        out.append(model.host_decode(json.dumps(body).encode(), "application/json"))
    return out


def torch_batch(batch) -> tuple:
    """Copies: the reference's state may hold the numpy inputs themselves."""
    return tuple(torch.from_numpy(np.array(a)) for a in batch)


def record_sampling(model, calls: list, to_np):
    """Wrap ``model._sample`` to record each call's (logits, seed, position,
    temp); returns the original method."""
    orig = model._sample

    def wrapped(logits, seed, position, temp):
        calls.append(tuple(to_np(a) for a in (logits, seed, position, temp)))
        return orig(logits, seed, position, temp)

    model._sample = wrapped
    return orig


def decision_margins(call) -> np.ndarray:
    """The reference's top-two margin of the sampling scores per lane of one
    recorded ``_sample`` call: logits (greedy) or logits / t + Gumbel."""
    logits, seed, position, temp = call
    scores = []
    for lg, sd, pos, t in zip(logits, seed, position, temp):
        if t > 0:
            key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), jnp.int32(sd)),
                                     jnp.int32(pos))
            g = np.asarray(jax.random.gumbel(key, lg.shape, jnp.float32))
            lg = lg / t + g
        top = np.sort(lg)[-2:]
        scores.append(top[1] - top[0])
    return np.asarray(scores)


def run_both(pair, items, steps: int):
    """Prefill + ``steps`` decode steps, eagerly, on both packages, each
    ``_sample`` call recorded: ([reference calls], [port calls], reference
    state, port state)."""
    jm, params, tm, module = pair
    batch = jm.assemble(items, (len(items),))
    jcalls, tcalls = [], []
    jorig = record_sampling(jm, jcalls, np.asarray)
    torig = record_sampling(tm, tcalls, lambda a: a.detach().numpy().copy())
    try:
        jstate = jm._prefill(params, *batch)
        with torch.no_grad():
            tstate = tm._prefill(module, *torch_batch(batch))
            for _ in range(steps):
                jstate, _ = jm._decode_step(params, jstate)
                tm._decode_step(module, tstate)
    finally:
        jm._sample, tm._sample = jorig, torig
    return jcalls, tcalls, jstate, tstate


def assert_tokens_match(ref: np.ndarray, got: np.ndarray, jcalls: list) -> list:
    """Tokens identical, except at a step whose reference margin is below
    MARGIN (returned, for the report)."""
    near_ties = []
    for lane, step in zip(*np.nonzero(ref != got)):
        margin = decision_margins(jcalls[step])[lane]
        assert margin < MARGIN, (
            f"lane {lane} step {step}: token {got[lane, step]} != reference "
            f"{ref[lane, step]} at a reference margin of {margin:.3g}")
        near_ties.append((int(lane), int(step), float(margin)))
    return near_ties


def test_from_jax_params_round_trip_bit_exact(pair):
    jm, params, tm, module = pair
    back = tm.to_jax_params(tm.from_jax_params(params))
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(leaf), flat_back[path])


def test_prefill_and_step_logits_within_tolerance(pair):
    jm, _, tm, _ = pair
    items = seeded_items(jm, 4, seed=11, temp=0.7)
    jcalls, tcalls, jstate, tstate = run_both(pair, items, steps=6)
    assert len(jcalls) == len(tcalls) == 7
    for i, (jc, tc) in enumerate(zip(jcalls, tcalls)):
        np.testing.assert_allclose(tc[0], jc[0], rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"logits of sampling call {i}")
        for a, b in zip(tc[1:], jc[1:]):
            np.testing.assert_array_equal(a, b)
    for key in ("k", "v"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                                   rtol=0, atol=LOGIT_TOL)
    for key in ("pos", "tokens", "n_new", "last", "done"):
        np.testing.assert_array_equal(tstate[key].numpy(), np.asarray(jstate[key]))


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_locked_forward_tokens_match_reference(pair, temp):
    """The full locked-batch forward (prefill + max_new - 1 steps) over 4
    seeded requests: identical tokens and counts under the near-tie rule."""
    jm, params, tm, module = pair
    items = seeded_items(jm, 4, seed=5 if temp else 6, temp=temp)
    batch = jm.assemble(items, (4,))
    ref = jax.device_get(jax.jit(jm.forward)(params, batch))
    with torch.no_grad():
        got = tm.forward(module, torch_batch(batch))
    np.testing.assert_array_equal(got["n_new"].numpy(), np.asarray(ref["n_new"]))
    ref_tok, got_tok = np.asarray(ref["tokens"]), got["tokens"].numpy()
    if not np.array_equal(ref_tok, got_tok):
        jcalls, _, _, _ = run_both(pair, items, steps=TG_OPTS["max_new_tokens"] - 1)
        ties = assert_tokens_match(ref_tok, got_tok, jcalls)
        print(f"near-tie steps (lane, step, margin): {ties}")
    assert (tm.host_postprocess({k: v.numpy() for k, v in got.items()}, 4)
            == jm.host_postprocess(jax.device_get(ref), 4))


def test_init_state_and_extract_match_reference(pair):
    """The engine's insert program body (one request's lanes) and extract."""
    jm, params, tm, module = pair
    item = seeded_items(jm, 1, seed=9, temp=0.7)[0]
    ref = jax.device_get(jm.init_state(params, item))
    with torch.no_grad():
        got = tm.init_state(module, torch_batch(item))
    assert set(got) == set(ref)
    for k in ref:
        if k in ("k", "v"):
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=LOGIT_TOL)
        else:
            np.testing.assert_array_equal(got[k].numpy(), ref[k])
    state = {k: torch.from_numpy(np.stack([np.asarray(v)] * 2)) for k, v in ref.items()}
    out = tm.extract(module, state, torch.tensor([1]))
    jout = jax.device_get(jm.extract(params, {k: np.stack([v] * 2) for k, v in ref.items()}, 1))
    np.testing.assert_array_equal(out["tokens"].numpy(), jout["tokens"])
    assert int(out["n_new"]) == int(jout["n_new"])


def paged_state(model, slots: int, pages: int, page_tokens: int, pkg: str):
    sig = model.kv_page_signature(slots, pages, page_tokens)
    if pkg == "jax":
        return {k: jnp.zeros(s.shape, s.dtype) for k, s in sig.items()}
    from tpuserve_torch.runtime import torch_dtype

    return {k: torch.zeros(s.shape, dtype=torch_dtype(s.dtype)) for k, s in sig.items()}


@pytest.mark.parametrize("chunk", [16, 4])
def test_paged_prefill_and_decode_match_reference(pair, chunk):
    """Two requests folded into pages (whole prompt, or 4-token chunks:
    bidirectional within a chunk, causal across), then 5 paged decode steps
    with the second slot's pages interleaved with the first's."""
    jm, params, tm, module = pair
    items = seeded_items(jm, 2, seed=21, temp=0.7)
    slots, pages, pt = 3, 2 * tm.kv_pages_per_slot(8) + 1, 8
    jst = paged_state(jm, slots, pages, pt, "jax")
    tst = paged_state(tm, slots, pages, pt, "port")
    pps = tm.kv_pages_per_slot(pt)
    rows = [np.arange(1, 2 * pps + 1, 2, dtype=np.int32),
            np.arange(2, 2 * pps + 1, 2, dtype=np.int32)]
    with torch.no_grad():
        for slot, (item, row) in enumerate(zip(items, rows)):
            for start in range(0, int(item[1]), chunk):
                jst = jm.prefill_chunk(params, jst, jnp.int32(slot), item, jnp.int32(start),
                                       jnp.asarray(row), chunk=chunk)
                tm.prefill_chunk(module, tst, torch.tensor([slot]), torch_batch(item),
                                 torch.tensor(start, dtype=torch.int32),
                                 torch.from_numpy(row), chunk=chunk)
        for _ in range(5):
            jst, jout = jm.step(params, jst)
            tout = tm.step(module, tst)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tst[k].numpy()[1:], np.asarray(jst[k])[1:],
                                   rtol=0, atol=LOGIT_TOL)
    for k in ("bt", "pos", "tokens", "n_new", "last", "done"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    for k in ("done", "n_new", "tokens"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))


def test_host_decode_items_and_errors_exact():
    jm, tm = jax_build(cfg(jconfig)), port_build(cfg(tconfig))
    rng = np.random.default_rng(0)
    bodies = [json.dumps({"prompt": "hello world", "seed": 3, "max_new_tokens": 5}),
              json.dumps({"prompt": "", "temperature": 0.25}),
              json.dumps({"prompt": " ".join(["token"] * 40), "seed": -7})]
    for _ in range(5):
        bodies.append(json.dumps({"prompt": " ".join(rng.choice(["a", "model", "Serves", "x1"], 6)),
                                  "seed": int(rng.integers(0, 1000)),
                                  "max_new_tokens": int(rng.integers(1, 25)),
                                  "temperature": float(rng.random())}))
    for b in bodies:
        ji, ti = (m.host_decode(b.encode(), "application/json") for m in (jm, tm))
        assert len(ji) == len(ti) == 5
        for a, c in zip(ji, ti):
            assert np.asarray(a).dtype == np.asarray(c).dtype
            np.testing.assert_array_equal(a, c)
    plain = (jm.host_decode(b"plain text body", "text/plain"),
             tm.host_decode(b"plain text body", "text/plain"))
    for a, c in zip(*plain):
        np.testing.assert_array_equal(a, c)
    for bad in ({"prompt": "x", "max_new_tokens": 25}, {"prompt": "x", "max_new_tokens": 0},
                {"prompt": "x", "temperature": -1}, {"text": "x"}, {"prompt": 3}):
        msgs = []
        for m in (jm, tm):
            with pytest.raises(ValueError) as e:
                m.host_decode(json.dumps(bad).encode(), "application/json")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], bad
    assert [np.asarray(a).tolist() for a in jm.canary_item()] == \
        [np.asarray(a).tolist() for a in tm.canary_item()]


def test_detokenize_and_postprocess_exact():
    jm, tm = jax_build(cfg(jconfig)), port_build(cfg(tconfig))
    rng = np.random.default_rng(1)
    for _ in range(20):
        toks = rng.integers(0, tm.vocab_size, int(rng.integers(0, 30))).tolist()
        assert tm.detokenize(toks) == jm.detokenize(toks)
    outs = {"tokens": rng.integers(0, 512, (3, 24)).astype(np.int32),
            "n_new": np.array([1, 24, 7], np.int32)}
    assert tm.host_postprocess(outs, 3) == jm.host_postprocess(outs, 3)
    res = tm.finalize({"tokens": outs["tokens"][1], "n_new": outs["n_new"][1]}, None)
    assert res == jm.finalize({"tokens": outs["tokens"][1], "n_new": outs["n_new"][1]}, None)
    assert tm.result_units(res) == jm.result_units(res) == 24.0


def test_paged_host_contract_matches_reference():
    jm, tm = jax_build(cfg(jconfig)), port_build(cfg(tconfig))
    for pt in (1, 7, 8, 16):
        assert tm.kv_pages_per_slot(pt) == jm.kv_pages_per_slot(pt)
    for item in seeded_items(jm, 6, seed=2, temp=0.0):
        assert tm.pages_needed(item, 8) == jm.pages_needed(item, 8)
        assert tm.prompt_tokens(item) == jm.prompt_tokens(item)
    for req in (0, 3, 16, 99):
        assert tm.kv_prefill_chunk(req) == jm.kv_prefill_chunk(req)
    assert tm.gen_max_steps() == jm.gen_max_steps() == 24


@pytest.mark.parametrize("opts, match", [
    (dict(attention="magic"), "attention"),
    (dict(attention="flash", prompt_len=12), "divisible by 8"),
    (dict(d_model=33), "heads"),
    (dict(moe_experts=1), "moe_experts")])
def test_textgen_option_validation(opts, match):
    """The reference's option checks, the same ValueError on both."""
    for pkg, builder in ((jconfig, jax_build), (tconfig, port_build)):
        with pytest.raises(ValueError, match=match):
            builder(cfg(pkg, **opts))


def test_moe_and_sharded_layout_not_ported():
    """The Switch-MoE variant is served (tests/test_torch_moe.py holds it to
    the reference); the reference's default (sharded) layout still waits
    for the mesh modes."""
    model = port_build(cfg(tconfig, moe_experts=4))
    assert model.moe_experts == 4
    assert {"router", "moe_up", "moe_down"} <= dict(
        model.build_module().layers[0].named_parameters()).keys()
    with pytest.raises(NotImplementedError, match="mesh modes"):
        port_build(tconfig.ModelConfig(name="tg", family="textgen", options=dict(TG_OPTS)))
