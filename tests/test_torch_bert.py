"""Port parity for BERT (``tpuserve_torch.models.bert``) against the JAX
package's ``tpuserve.models.bert`` on the same weights: the reference's
seeded flax tree, converted by ``from_jax_params``.

Ring and Ulysses attention run in single mode on a 1-device mesh on both
sides, once at ``local_impl="auto"`` (dense local math at these sizes) and
once with ``DENSE_SCORE_BYTES_MAX`` set to 0 in both packages, so both take
their flash local step: the reference's Pallas kernels in interpret mode,
the port's K2 (ring) and K1 (Ulysses) plain versions.

Tolerances: float32 logits atol 1e-4 (chained matmuls and LayerNorms
summed in different orders) with identical top-k indices; bfloat16 logits
atol 3e-2, four bf16 spacings at 1 (two frameworks round every layer's
activations to bf16 at different points; measured 1.0e-2 on this tiny
model), with identical top-1 wherever the reference's top-2 gap exceeds
that tolerance.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import text as jtext
from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.config import load_config as jax_load_config
from tpuserve.models import build as jax_build
from tpuserve.parallel import make_mesh as jax_make_mesh
from tpuserve.parallel.mesh import MeshPlan as JaxMeshPlan
from tpuserve_torch import text as ttext
from tpuserve_torch.config import ModelConfig, load_config
from tpuserve_torch.models import build
from tpuserve_torch.models.bert import from_jax_params
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.parallel import MeshPlan, make_mesh
from tpuserve_torch.runtime import build_runtime

TINY = dict(layers=2, d_model=32, heads=2, d_ff=64, vocab_size=512)
TEXTS = ["hello world", "Serve this text, please!", "Café au lait — naïve?",
         "a中b 12345 tokens", "x " * 40, ""]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cfg_kwargs(**over) -> dict:
    base = dict(name="bert", family="bert", batch_buckets=[1, 2, 4],
                seq_buckets=[8, 16], deadline_ms=5.0, dtype="float32",
                num_classes=4, parallelism="single",
                request_timeout_ms=30_000.0, options=dict(TINY))
    base.update(over)
    return base


def pair(attention="flash", **over):
    kw = cfg_kwargs(options=dict(TINY, attention=attention), **over)
    return jax_build(JaxModelConfig(**kw)), build(ModelConfig(**kw))


@pytest.fixture(scope="module")
def jax_params():
    jm, _ = pair("dense")
    return jax.device_get(jm.init_params(jax.random.key(0)))


def batch_of(model, texts, bucket):
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in texts]
    return model.assemble(items, bucket)


# -- tokenizer ----------------------------------------------------------------

@pytest.mark.parametrize("size", [512, 8192])
def test_tokenizer_ids_identical(size):
    assert ttext.synthetic_vocab(size) == jtext.synthetic_vocab(size)
    jt = jtext.WordPieceTokenizer(jtext.synthetic_vocab(size))
    tt = ttext.WordPieceTokenizer(ttext.synthetic_vocab(size))
    for t in TEXTS:
        assert tt.tokenize(t) == jt.tokenize(t)
        for n in (4, 16):  # truncation at max_len
            for a, b in zip(tt.encode(t, n), jt.encode(t, n)):
                np.testing.assert_array_equal(a, b)


def test_host_decode_matches_reference():
    jm, tm = pair()
    body = json.dumps({"texts": TEXTS}).encode()
    (jitems, jb), (titems, tb) = (m.host_decode_items(body, "application/json")
                                  for m in (jm, tm))
    assert jb is tb is True
    for a, b in zip(jitems, titems):
        np.testing.assert_array_equal(a, b)
        assert jm.group_key(a) == tm.group_key(b)
    np.testing.assert_array_equal(jm.assemble(jitems[:4], (4, 16))[0],
                                  tm.assemble(titems[:4], (4, 16))[0])


# -- network ------------------------------------------------------------------

@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_matches_jax_f32(attention, jax_params):
    jm, tm = pair(attention)
    mod = tm.build_module()
    mod.load_state_dict(from_jax_params(jax_params))
    batch = batch_of(tm, TEXTS[:4], (4, 16))
    ref_logits = np.asarray(jm.module.apply(jax_params, *batch))
    ref_out = jm.forward(jax_params, batch)
    with torch.inference_mode():
        tb = tuple(torch.from_numpy(x) for x in batch)
        logits = mod(*tb).numpy()
        out = tm.forward(mod, tb)
    np.testing.assert_allclose(logits, ref_logits, atol=1e-4)
    np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(ref_out["indices"]))
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(ref_out["probs"]), atol=1e-5)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_matches_jax_bf16(attention, jax_params):
    jm, tm = pair(attention, dtype="bfloat16")
    params_bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                         jax_params)
    mod = tm.build_module()
    mod.load_state_dict(from_jax_params(jax_params))
    mod.to(torch.bfloat16)
    batch = batch_of(tm, TEXTS[:4], (4, 16))
    ref = np.asarray(jm.module.apply(params_bf16, *batch), np.float32)
    with torch.inference_mode():
        logits = mod(*(torch.from_numpy(x) for x in batch)).numpy()
    assert logits.dtype == np.float32  # the classifier runs in f32
    np.testing.assert_allclose(logits, ref, atol=3e-2)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 3e-2
    np.testing.assert_array_equal(logits.argmax(-1)[clear], ref.argmax(-1)[clear])


def test_full_size_param_count_matches_reference():
    """BERT-base at full width (vocab 30522) is ~110M params, the same
    count as the reference's tree."""
    kw = dict(name="b", family="bert", dtype="float32", num_classes=2,
              parallelism="single", options={"vocab_size": 30522})
    jm = jax_build(JaxModelConfig(**kw))
    jp = jax.eval_shape(jm.init_params, jax.random.key(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    with torch.device("meta"):
        n = sum(p.numel() for p in build(ModelConfig(**kw)).build_module().parameters())
    assert n == n_ref and 105e6 < n < 115e6, (n, n_ref)


# -- ring and Ulysses attention (single mode, 1-device mesh) ------------------------

# head_dim 64, so the flash local step is open to local_impl="auto".
SP_TINY = dict(layers=2, d_model=128, heads=2, d_ff=64, vocab_size=512)


def sp_pair(attention):
    kw = cfg_kwargs(options=dict(SP_TINY, attention=attention))
    return jax_build(JaxModelConfig(**kw)), build(ModelConfig(**kw))


@pytest.fixture(scope="module")
def sp_params():
    jm, _ = sp_pair("dense")
    return jax.device_get(jm.init_params(jax.random.key(1)))


@pytest.mark.parametrize("local", ["auto", "flash"])
@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_sequence_parallel_forward_matches_jax(attention, local, sp_params, monkeypatch):
    if local == "flash":
        for mod in ("tpuserve.ops.ring_attention", "tpuserve_torch.ops.ring_attention"):
            monkeypatch.setattr(importlib.import_module(mod), "DENSE_SCORE_BYTES_MAX", 0)
    plain = "flash_attention_stats_reference" if attention == "ring" else \
        "flash_attention_reference"
    calls = []
    fn = getattr(fa, plain)
    monkeypatch.setattr(fa, plain, lambda *a: calls.append(1) or fn(*a))
    jm, tm = sp_pair(attention)
    jm.bind_mesh(jax_make_mesh(JaxMeshPlan(), devices=jax.devices()[:1]))
    tm.bind_mesh(make_mesh(MeshPlan(), devices=["cpu"]))
    mod = tm.build_module()
    mod.load_state_dict(from_jax_params(sp_params))
    batch = batch_of(tm, TEXTS[:4], (4, 16))
    ref_logits = np.asarray(jm.module.apply(sp_params, *batch))
    ref_out = jm.forward(sp_params, batch)
    with torch.inference_mode():
        tb = tuple(torch.from_numpy(x) for x in batch)
        logits = mod(*tb).numpy()
        out = tm.forward(mod, tb)
    # 2 layers: one local step per layer and forward on the flash path.
    assert len(calls) == (4 if local == "flash" else 0)
    np.testing.assert_allclose(logits, ref_logits, atol=1e-4)
    np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(ref_out["indices"]))
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(ref_out["probs"]), atol=1e-5)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_sequence_parallel_runtime_binds_its_mesh(attention):
    """The runtime binds a 1-device mesh on its own device before it builds
    the module, and serves the same answers as dense attention."""
    _, tm = sp_pair(attention)
    rt = build_runtime(tm, device="cpu")
    assert rt.mesh.shape == {"data": 1, "model": 1, "seq": 1}
    assert rt.mesh.axis_devices("seq") == [torch.device("cpu")]
    assert rt.compiles_total == len(tm.buckets())
    _, dm = sp_pair("dense")
    drt = build_runtime(dm, device="cpu")
    drt.module.load_state_dict(rt.module.state_dict())
    batch = batch_of(tm, TEXTS[:2], (2, 16))
    got, want = (r.fetch(r.run((2, 16), batch)) for r in (rt, drt))
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
    np.testing.assert_array_equal(got["indices"], want["indices"])


def test_sequence_parallel_forward_without_mesh_raises():
    _, tm = sp_pair("ring")
    mod = tm.build_module()
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="bind_mesh"):
        mod(ids, torch.ones_like(ids))


@pytest.mark.parametrize("attention, over, match", [
    ("ring", dict(parallelism="replica"), "replica mode"),
    ("ulysses", dict(parallelism="replica"), "replica mode"),
    ("ring", dict(sp=3), r"seq buckets \[8, 16\] are not divisible"),
    ("ulysses", dict(sp=4), r"local heads 2 \(heads=2, tp=1\)"),
])
def test_sequence_parallel_build_checks_match_reference(attention, over, match):
    kw = cfg_kwargs(options=dict(SP_TINY, attention=attention), **over)
    for make in (lambda: jax_build(JaxModelConfig(**kw)), lambda: build(ModelConfig(**kw))):
        with pytest.raises(ValueError, match=match):
            make()


# -- bucketing invariance in the port -------------------------------------------

@pytest.fixture(scope="module")
def served():
    _, tm = pair("flash")
    return tm, build_runtime(tm, device="cpu")


def test_runtime_warms_every_bucket(served):
    model, rt = served
    assert rt.compiles_total == len(model.buckets()) == 6
    assert rt.describe()["buckets"] == [list(b) for b in sorted(model.buckets())]


def test_seq_bucket_invariance(served):
    model, rt = served
    item = model.host_decode(b'{"text": "hello world"}', "application/json")
    out8 = rt.fetch(rt.run((1, 8), model.assemble([item], (1, 8))))
    out16 = rt.fetch(rt.run((1, 16), model.assemble([item], (1, 16))))
    np.testing.assert_allclose(out8["probs"], out16["probs"], atol=1e-5)
    np.testing.assert_array_equal(out8["indices"], out16["indices"])


def test_batch_padding_invariance(served):
    model, rt = served
    a = model.host_decode(b'{"text": "alpha beta"}', "application/json")
    b_ = model.host_decode(b'{"text": "gamma"}', "application/json")
    solo = rt.fetch(rt.run((1, 8), model.assemble([a], (1, 8))))
    padded = rt.fetch(rt.run((4, 8), model.assemble([a, b_], (4, 8))))
    np.testing.assert_allclose(solo["probs"][0], padded["probs"][0], atol=1e-5)
    np.testing.assert_array_equal(solo["indices"][0], padded["indices"][0])


# -- what this slice does not port ---------------------------------------------

@pytest.mark.parametrize("over, match", [
    # The MoE variant serves on a mesh without a model axis; experts on
    # "model" (expert parallelism) are ROADMAP item 10, quantized or not.
    pytest.param(dict(options=dict(TINY, moe_experts=4), parallelism="sharded", tp=2),
                 "item 10", id="over1-parallel attention"),
    pytest.param(dict(options=dict(TINY, moe_experts=4), quantize="int8",
                      parallelism="sharded", tp=2), "item 10", id="over2-quantized"),
    # The port reads the .npz form of the reference's tree, not a GraphDef.
    pytest.param(dict(weights="/nonexistent/frozen.pb"), "npz", id="over5-weights"),
])
def test_unported_options_raise(over, match):
    with pytest.raises(NotImplementedError, match=match):
        build(ModelConfig(**cfg_kwargs(**over)))


@pytest.mark.parametrize("over, n_chips", [
    # Refused until the seq axis was served beside a model and a data axis
    # (tests/test_torch_mesh_axes.py holds each to the reference's forward).
    pytest.param(dict(options=dict(TINY, attention="ring"), parallelism="sharded", tp=2),
                 2, id="ring-tp2"),
    pytest.param(dict(parallelism="sharded", tp=2, sp=2), 4, id="dense-tp2-sp2"),
    pytest.param(dict(options=dict(TINY, attention="ulysses"), parallelism="sharded", tp=2),
                 2, id="ulysses-tp2"),
])
def test_sequence_parallel_layouts_serve(over, n_chips, monkeypatch):
    from tpuserve_torch.config import ParallelConfig
    from tpuserve_torch.parallel import mesh as meshlib

    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * n_chips)
    _, single = pair("dense")
    tree = single.to_jax_params(single.init_params(0))
    model = build(ModelConfig(**cfg_kwargs(**over)))
    model.load_params = lambda: model.from_jax_params(tree)
    rt = build_runtime(model, device="cpu", parallel=ParallelConfig(n_chips=n_chips))
    single.load_params = lambda: single.from_jax_params(tree)
    base = build_runtime(single, device="cpu")
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in ("a served layout", "two")]
    batch = model.assemble(items, (2, 16))
    out, want = (r.fetch(r.run((2, 16), batch)) for r in (rt, base))
    np.testing.assert_allclose(out["probs"], want["probs"], atol=1e-5)
    np.testing.assert_array_equal(out["indices"], want["indices"])


SD_TINY = dict(steps=2, guidance=5.0, vocab_size=512, text_layers=1, text_d_model=32,
               text_heads=2, unet_ch=16, unet_mults=[1, 2], unet_res=1,
               unet_attn_levels=[0], unet_heads=2, vae_ch=16, vae_mults=[1, 2])
TG_TINY = dict(layers=1, d_model=32, heads=2, d_ff=64, vocab_size=512, prompt_len=16,
               max_new_tokens=8)


@pytest.mark.parametrize("family, via", [
    # Every family is ported and serves its default layout (parallelism =
    # "sharded", on a one-device mesh). A seq axis was refused for SD 1.5
    # and textgen until it was served (ROADMAP item 9b.3), and the test
    # keeps its name: SD 1.5's work replicates over the axis, textgen's KV
    # context splits over it. Each case serves sp = 2 over two ranks, by
    # the server and at build, and gives single mode's answer.
    pytest.param("sd15", "server", id="sd15-server"),
    pytest.param("sd15", "build", id="sd15"), pytest.param("textgen", "build", id="textgen")])
def test_unported_families_raise(family, via, monkeypatch):
    from tpuserve_torch.config import ParallelConfig, ServerConfig
    from tpuserve_torch.parallel import mesh as meshlib
    from tpuserve_torch.server import ServerState

    monkeypatch.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * 2)
    kw = (dict(image_size=32, options=dict(SD_TINY)) if family == "sd15"
          else dict(options=dict(TG_TINY)))
    kw.update(name="m", family=family, batch_buckets=[1], dtype="float32")
    body = json.dumps({"prompt": "a red cat", "seed": 3}).encode()
    outs = []
    for over in (dict(parallelism="single"), dict(parallelism="sharded", sp=2)):
        cfg = ModelConfig(**kw, **over)
        if via == "server":
            state = ServerState(ServerConfig(models=[cfg]), device="cpu")
            state.build()
            model, rt = state.models["m"], state.runtimes["m"]
        else:
            model = build(cfg)
            rt = build_runtime(model, device="cpu", parallel=ParallelConfig(n_chips=2))
        assert dict(rt.mesh.shape)["seq"] == over.get("sp", 1)
        batch = model.assemble([model.host_decode(body, "application/json")], (1,))
        outs.append(rt.fetch(rt.run((1,), batch)))
    assert all(outs[1][k].tobytes() == outs[0][k].tobytes() for k in outs[0])


def _same(port_value, jax_value) -> bool:
    """A parsed value equals the JAX config's typed one; a table parsed as
    a dict holds only the keys its file set."""
    import dataclasses

    port_value, jax_value = (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
                             for v in (port_value, jax_value))
    if isinstance(port_value, dict):
        return all(_same(v, jax_value[k]) for k, v in port_value.items())
    if isinstance(port_value, list):
        return len(port_value) == len(jax_value) and all(map(_same, port_value, jax_value))
    return port_value == jax_value


# TOML array-of-tables keys the JAX config stores under another name.
_RENAMED = {("faults", "rule"): "rules", ("tenants", "tenant"): "tenants"}


def test_same_toml_files_parse():
    """Every example parses: the typed fields equal the JAX config's, and
    each setting held as unported equals the JAX config's value for it."""
    import dataclasses

    from tpuserve_torch.config import ServerConfig

    for path in ("examples/bert_modes.toml", "examples/serve_all.toml",
                 "examples/genserve.toml", "examples/latency_12k.toml",
                 "examples/bert_long_ring.toml"):
        cfg, jcfg = load_config(path), jax_load_config(path)
        for f in dataclasses.fields(ServerConfig):
            if f.name not in ("models", "unported"):
                assert _same(getattr(cfg, f.name), getattr(jcfg, f.name)), (path, f.name)
        for name, value in cfg.unported.items():
            if name.startswith("["):
                table, key = name[1:].split("] ")
                jax_value = getattr(getattr(jcfg, table), _RENAMED.get((table, key), key))
            else:
                jax_value = getattr(jcfg, name)
            assert _same(value, jax_value), (path, name)
        assert [m.name for m in cfg.models] == [m.name for m in jcfg.models]
        for m, jm in zip(cfg.models, jcfg.models):
            for f in dataclasses.fields(ModelConfig):
                if f.name != "unported":
                    assert _same(getattr(m, f.name), getattr(jm, f.name)), (path, f.name)
            for key, value in m.unported.items():
                assert _same(value, getattr(jm, key)), (path, m.name, key)
    serve_all = load_config("examples/serve_all.toml")
    # The observability tables are typed (served) now, as the reference reads them.
    assert serve_all.events.enabled and serve_all.telemetry.enabled and not serve_all.unported
    assert _same(serve_all.adaptive, jax_load_config("examples/serve_all.toml").adaptive)
    cfg = load_config("examples/bert_modes.toml",
                      ["model.bert-pp.deadline_ms=2.5", "port=9001"])
    assert cfg.model("bert-pp").deadline_ms == 2.5 and cfg.port == 9001
    # pp is typed since the mesh modes were ported.
    assert cfg.model("bert-pp").pp == 4 and cfg.model("bert-pp").unported == {}
