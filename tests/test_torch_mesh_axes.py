"""The seq axis beside the data and model axes, and the vision families'
model axis, against the JAX package on the CPU.

The JAX side runs on its conftest's 8 fake host devices; the port's with
``mesh.visible_devices`` patched to ``["cpu"] * 8`` (eight ranks sharing
the CPU, single-controller). Both serve the JAX package's seeded tree (the
port reads it from a ``.npz``), at tiny widths in float32 unless a case
says otherwise.

Tolerances:

- BERT's ring and Ulysses attention on data 2 x seq 2, model 2 x seq 2 and
  data 2 x model 2 x seq 2: probabilities within atol 1e-5 of the
  reference's forward on the same mesh shape (the reference's own bound,
  ``tests/test_bert.py``), a padded lane included; top-k indices equal.
- ResNet-50 at tp = 2: float32 logits within 1e-4 of the reference's scale
  (max |logit|), int8 within 2e-3 of it (the int8 weights are the same
  bits; the convolutions add in another order), and the top-5 equal
  wherever the reference's logits separate the ranks by more than that.
- MobileNetV3, EfficientDet and toy at tp = 2 (their parameters replicate
  over "model"): the families' existing bars against the reference
  (``tests/test_torch_mobilenet.py``: probabilities atol 1e-5;
  ``tests/test_torch_efficientdet.py``: scores atol 1e-4, boxes atol 1e-3;
  toy: probabilities atol 1e-6), and the port's single mode's bytes.
- textgen's KV context on "seq" (dense KV at sp = 2; paged KV at tp = 2 x
  sp = 2 over an even and an odd page count): tokens identical to the
  reference's sharded engine and to the port's single engine.
- SD 1.5 serves on a seq axis alone (its work replicates over it), and
  beside a data or model axis (``tests/test_torch_sd15_mesh.py`` holds it
  to the reference there): every uint8 pixel within 1 of single mode's, at
  least 99 % equal (the bar of ``tests/test_torch_sd15.py``).
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_genserve import MODS, PKGS, prompt_item, run, tg_cfg  # noqa: F401
from test_torch_genserve import weights as tg_weights  # noqa: F401
from tpuserve import config as jconfig
from tpuserve.models import build as jax_build
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve_torch import config as tconfig
from tpuserve_torch import savedmodel
from tpuserve_torch.models import build
from tpuserve_torch.models.base import MeshModule
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.runtime import build_runtime

N_DEV = 8


@pytest.fixture(scope="module", autouse=True)
def eight():
    mp = pytest.MonkeyPatch()
    mp.setattr(meshlib, "visible_devices", lambda *a: ["cpu"] * N_DEV)
    yield
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def reference_and_port(kw: dict, tree, npz: str, n_chips: int, **over):
    """The reference's runtime and the port's on the same tree and mesh."""
    kw = {**kw, **over}
    jm = jax_build(jconfig.ModelConfig(**kw))
    jm.load_params = lambda: tree
    jrt = jax_build_runtime(jm, parallel=jconfig.ParallelConfig(n_chips=n_chips))
    model = build(tconfig.ModelConfig(**kw, weights=npz))
    rt = build_runtime(model, device="cpu", parallel=tconfig.ParallelConfig(n_chips=n_chips))
    return model, rt, jrt


# -- BERT: ring and Ulysses beside a data and a model axis ---------------------------

BERT = dict(layers=2, d_model=32, heads=4, d_ff=64, vocab_size=512, attention="dense")
TEXTS = ["sequence parallel serving one", "a longer text that fills more of the bucket",
         "three"]  # 3 of 4 lanes real: lane 3 is padding


def bert_kw(**over) -> dict:
    base = dict(name="bert", family="bert", batch_buckets=[4], seq_buckets=[16],
                dtype="float32", num_classes=4, parallelism="single",
                request_timeout_ms=30_000.0, options=dict(BERT))
    base.update(over)
    return base


@pytest.fixture(scope="module")
def bert_tree():
    return jax.device_get(jax_build(jconfig.ModelConfig(**bert_kw())).load_params())


@pytest.fixture(scope="module")
def bert_npz(bert_tree, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bert") / "bert.npz")
    savedmodel.save_npz(path, bert_tree)
    return path


# (tp, sp, n_chips) -> the mesh (data, model, seq) and the port's rank modules.
BERT_MESHES = {
    "data2-seq2": (1, 2, 4, {"data": 2, "model": 1, "seq": 2}, 2),
    "model2-seq2": (2, 2, 4, {"data": 1, "model": 2, "seq": 2}, 2),
    "data2-model2-seq2": (2, 2, 8, {"data": 2, "model": 2, "seq": 2}, 4),
}


@pytest.mark.parametrize("mesh", sorted(BERT_MESHES))
@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_bert_sequence_parallel_beside_data_and_model(attention, mesh, bert_tree, bert_npz):
    tp, sp, n_chips, shape, n_ranks = BERT_MESHES[mesh]
    kw = bert_kw(options=dict(BERT, attention=attention))
    model, rt, jrt = reference_and_port(kw, bert_tree, bert_npz, n_chips,
                                        parallelism="sharded", tp=tp, sp=sp)
    assert dict(rt.mesh.shape) == shape == dict(jrt.meshes[0].shape)
    assert rt.parallel_signature == jrt.parallel_signature == f"sharded@d{shape['data']}"
    assert (rt.n_chips, rt.n_replicas) == (jrt.n_chips, jrt.n_replicas)
    # One module per (data, model) rank; each one's attention runs over
    # its own seq ranks.
    assert isinstance(rt.module, MeshModule) and len(rt.module.ranks) == n_ranks
    for r in rt.module.ranks:
        assert dict(r.layers[0].attn.mesh.shape) == {"data": 1, "model": 1, "seq": sp}
    items = [model.host_decode(json.dumps({"text": t}).encode(), "application/json")
             for t in TEXTS]
    batch = model.assemble(items, (4, 16))
    ref = jrt.fetch(jrt.run((4, 16), batch))
    out = rt.fetch(rt.run((4, 16), batch))
    np.testing.assert_allclose(out["probs"], np.asarray(ref["probs"]), atol=1e-5)
    np.testing.assert_array_equal(out["indices"], np.asarray(ref["indices"]))
    # And the single dense forward's answers, on the port alone.
    one = build(tconfig.ModelConfig(**bert_kw(weights=bert_npz)))
    base = build_runtime(one, device="cpu")
    want = base.fetch(base.run((4, 16), batch))
    np.testing.assert_allclose(out["probs"], want["probs"], atol=1e-5)


def test_bert_sequence_parallel_keeps_the_reference_build_checks():
    """Seq buckets divisible by sp, and Ulysses' local heads (after the tp
    split) divisible by sp, as the reference checks them at build."""
    for builder, pkg in ((build, tconfig), (jax_build, jconfig)):
        with pytest.raises(ValueError, match="not divisible"):
            builder(pkg.ModelConfig(**bert_kw(options=dict(BERT, attention="ring"),
                                              parallelism="sharded", sp=3)))
        with pytest.raises(ValueError, match=r"local heads 2 \(heads=4, tp=2\)"):
            builder(pkg.ModelConfig(**bert_kw(options=dict(BERT, attention="ulysses"),
                                              parallelism="sharded", tp=2, sp=4,
                                              seq_buckets=[16])))


# -- textgen: the KV context on "seq" -------------------------------------------------

TG_PROMPTS = [
    ("a", 1, 3, 0.0),
    ("the quick brown fox jumps over the lazy dog again and again", 2, 12, 0.7),
    ("short prompt", 3, 1, 0.0),
    ("one two three four five six seven eight nine ten eleven twelve", 4, 8, 0.3),
    ("hello", 5, 20, 1.0),
    ("mid size prompt with a few words", 6, 40, 0.0),
]

# (ModelConfig fields, n_chips, [genserve] fields, the KV's seq blocks).
TG_LAYOUTS = {
    "dense-sp2": (dict(parallelism="sharded", sp=2), 2, dict(slots=4), 2),
    "paged-tp2-sp2-even": (dict(parallelism="sharded", tp=2, sp=2), 4,
                           dict(slots=4, kv_paging=True, kv_page_tokens=8, kv_pages=42), 2),
    # 41 pages do not split over 2 seq ranks: the reference's can_shard
    # replicates them, and so does the port.
    "paged-tp2-sp2-odd": (dict(parallelism="sharded", tp=2, sp=2), 4,
                          dict(slots=4, kv_paging=True, kv_page_tokens=8, kv_pages=41), 1),
}


async def tg_drive(eng, model, prompts):
    await eng.start()
    futs = [eng.submit(prompt_item(model, p, seed=s, max_new=n, temp=t))
            for (p, s, n, t) in prompts]
    res = await asyncio.gather(*futs)
    await eng.stop()
    return [list(r["tokens"]) for r in res]


def tg_engine(pkg, tg_weights, over: dict, n_chips: int, gen: dict):
    mods = MODS[pkg]
    parallel = mods.config.ParallelConfig(n_chips=n_chips)
    if pkg == "jax":
        model = jax_build(tg_cfg("jax", **over))
        rt = jax_build_runtime(model, compile_forward=False, parallel=parallel)
    else:
        model = build(tg_cfg("port", weights=tg_weights[1], **over))
        rt = build_runtime(model, device="cpu", compile_forward=False, parallel=parallel)
    eng = mods.genserve.GenEngine(model, rt, mods.obs.Metrics(),
                                  mods.config.GenserveConfig(**gen))
    eng.compile()
    return model, rt, eng


@pytest.mark.parametrize("layout", sorted(TG_LAYOUTS))
def test_textgen_kv_context_on_seq_matches_reference(layout, tg_weights):
    over, n_chips, gen, blocks = TG_LAYOUTS[layout]
    out, rts = {}, {}
    for pkg in PKGS:
        model, rt, eng = tg_engine(pkg, tg_weights, over, n_chips, gen)
        out[pkg] = run(tg_drive(eng, model, TG_PROMPTS))
        rts[pkg] = (model, rt, eng)
    model, rt, eng = rts["port"]
    jmodel, jrt, jeng = rts["jax"]
    assert dict(rt.mesh.shape) == dict(jrt.meshes[0].shape)
    assert rt.parallel_signature == jrt.parallel_signature
    # The state block's specs are the reference's, and so is its fallback.
    specs = model.state_partition_specs(eng._state_struct, rt.mesh)
    jspecs = jmodel.state_partition_specs(jeng._state_struct, jrt.meshes[0])
    assert {k: tuple(v) for k, v in specs.items()} == {k: tuple(v) for k, v in jspecs.items()}
    assert model._seq_blocks({k: torch.empty(v.shape) for k, v in
                              eng._state_struct.items() if k in ("k", "kp")}) == blocks
    _, _, single = tg_engine("port", tg_weights, {}, 0, gen)
    base = run(tg_drive(single, single.model, TG_PROMPTS))
    assert out["port"] == out["jax"] == base, out
    if eng.pages is not None:
        assert eng.pages.n_free == eng.pages.usable and eng.pages.n_reserved == 0


def test_textgen_seq_split_decode_attention_merges_like_the_whole_softmax():
    """The decode attention over seq-rank blocks (row max and sum merged in
    float32) against the one-block softmax on the same context, a lane
    whose live keys all lie in one block included: within float32
    rounding."""
    from tpuserve_torch.models.textgen import TextGenServing

    g = torch.Generator().manual_seed(3)
    b, c, h, hd = 3, 16, 2, 8
    q = torch.randn(b, h, hd, generator=g)
    kc, vc = torch.randn(b, c, h, hd, generator=g), torch.randn(b, c, h, hd, generator=g)
    pos = torch.tensor([2, 9, 15])
    mask = (torch.arange(c)[None, :] > pos[:, None]).float() * -1e9
    whole = TextGenServing._decode_attention(q, [(kc, vc, mask)])
    for n in (2, 4):
        split = TextGenServing._decode_attention(
            q, list(zip(kc.chunk(n, 1), vc.chunk(n, 1), mask.chunk(n, 1))))
        torch.testing.assert_close(split, whole, rtol=0, atol=1e-6)


# -- the vision families' model axis ---------------------------------------------------

RESNET_STAGES = (1, 1, 1, 1)
# The rule: float32 logits within 1e-4 of the reference's scale; bf16 (int8
# or not) within 1e-2 of it (tests/test_torch_resnet.py's bars at these
# shallow stages), and the top-5 equal wherever the reference's logits
# separate the ranks by more than that.
RESNET_REL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture
def shallow_resnet(monkeypatch):
    """Both packages' ResNet-50 serving class at shallow stages (the
    reference's rules and the port's split are the same at any depth)."""
    import jax.numpy as jnp

    from tpuserve.models import resnet as jresnet
    from tpuserve_torch.models import resnet as tresnet

    monkeypatch.setattr(jresnet.ResNet50Serving, "make_module", lambda self, cfg: jresnet.ResNet(
        stage_sizes=RESNET_STAGES, num_classes=cfg.num_classes, dtype=jnp.dtype(cfg.dtype)))
    monkeypatch.setattr(tresnet.ResNet50Serving, "build_module", lambda self: tresnet.ResNet(
        RESNET_STAGES, self.cfg.num_classes, tp=self.tp_split))


def vision_kw(family: str, **over) -> dict:
    base = dict(name="v", family=family, batch_buckets=[4], deadline_ms=2.0,
                dtype="float32", num_classes=10, parallelism="single",
                request_timeout_ms=30_000.0, image_size=32, wire_size=32, wire_format="rgb8")
    base.update(over)
    return base


def images_batch(model, n: int = 4, seed: int = 11):
    rng = np.random.default_rng(seed)
    edge = model.cfg.wire_size
    return model.assemble([rng.integers(0, 256, (edge, edge, 3), np.uint8)
                           for _ in range(n)], (n,))


def reference_logits(jm, jrt, batch) -> np.ndarray:
    """The reference's sharded forward up to its logits, as its runtime
    runs it (weights dequantized inside the program under int8)."""
    import jax.numpy as jnp

    from tpuserve import quantize as jqz

    def f(p, b):
        if jm.cfg.quantize == "int8":
            p = jqz.dequantize_tree(p, jnp.dtype(jm.cfg.dtype))
        return jm.module.apply(p, jm.device_preprocess(b)).astype(jnp.float32)

    return np.asarray(jax.jit(f)(jrt.params_per_mesh[0], batch[0]))


def port_logits(model, rt, batch) -> np.ndarray:
    with torch.inference_mode():
        dev = tuple(torch.from_numpy(a) for a in batch)
        if isinstance(rt.module, MeshModule):
            return model.mesh_logits(rt.module, dev).float().numpy()
        return model.logits(rt.module, dev).float().numpy()


@pytest.mark.parametrize("dtype, quantize, n_chips", [
    ("float32", None, 2), ("float32", None, 4), ("bfloat16", None, 2), ("bfloat16", "int8", 2)],
    ids=["f32-model2", "f32-data2-model2", "bf16-model2", "bf16-int8-model2"])
def test_resnet50_split_over_model_matches_reference(dtype, quantize, n_chips, shallow_resnet,
                                                     tmp_path):
    kw = vision_kw("resnet50", dtype=dtype, quantize=quantize, quantize_min_size=64)
    tree = jax.device_get(jax_build(jconfig.ModelConfig(**kw)).load_params())
    npz = str(tmp_path / "r.npz")
    savedmodel.save_npz(npz, tree)
    model, rt, jrt = reference_and_port(kw, tree, npz, n_chips, parallelism="sharded", tp=2)
    assert rt.parallel_signature == jrt.parallel_signature
    # Every convolution's output channels and the head's classes split.
    ranks = rt.module.ranks
    assert len(ranks) == n_chips and rt.module.grid == (n_chips // 2, 2)
    r0 = ranks[0]
    assert (r0.stem_conv.weight.shape[0], r0.stage1_block1.proj_conv.weight.shape[0],
            r0.stage4_block1.conv3.weight.shape[0], r0.head.weight.shape[0]) == (32, 128, 1024, 5)
    assert r0.stage1_block1.bn2.running_mean.shape == (32,)
    if quantize:
        assert sum(t.dtype == torch.int8 for t in rt.slots[0].tensors.values()) > 0
    batch = images_batch(model)
    got, want = port_logits(model, rt, batch), reference_logits(jrt.model, jrt, batch)
    tol = RESNET_REL[dtype] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    out = rt.fetch(rt.run((4,), batch))
    order = np.argsort(-want, axis=-1)[:, :5]
    gaps = -np.diff(np.take_along_axis(want, np.argsort(-want, axis=-1), -1), axis=-1)[:, :5]
    separated = gaps > tol
    assert (out["indices"] == order)[separated].all()
    # And the port's single mode's logits (the same module, unsplit).
    one = build(tconfig.ModelConfig(**kw, weights=npz))
    base = build_runtime(one, device="cpu")
    np.testing.assert_allclose(got, port_logits(one, base, batch), rtol=0, atol=tol)


def test_resnet50_model_axis_checks_the_split():
    with pytest.raises(ValueError, match="num_classes=9"):
        kw = vision_kw("resnet50", num_classes=9, parallelism="sharded", tp=2)
        model = build(tconfig.ModelConfig(**kw))
        build_runtime(model, device="cpu", parallel=tconfig.ParallelConfig(n_chips=2))


MNV3_SHALLOW = 3  # the first three blocks (tests/test_torch_mobilenet.py's SHALLOW)
DET = dict(det_classes=5, fpn_channels=16, fpn_repeats=1, head_repeats=1, max_level=5,
           pre_nms=32, max_dets=8, backbone_width=0.25, backbone_depth=0.35,
           score_thresh=0.005)
# family -> (ModelConfig fields, {output: atol against the reference}).
REPLICATED = {
    "toy": (dict(wire_size=8), {"probs": 1e-6}),
    "mobilenetv3": (dict(num_classes=1000, wire_format="yuv420"), {"probs": 1e-5}),
    "efficientdet": (dict(image_size=64, wire_size=64, options=dict(DET)),
                     {"scores": 1e-4, "boxes": 1e-3}),
}


@pytest.mark.parametrize("family", sorted(REPLICATED))
def test_replicated_families_on_a_model_axis(family, monkeypatch, tmp_path):
    """MobileNetV3, EfficientDet and toy at tp = 2: their parameters
    replicate over "model" as the reference's default rule does, so one
    copy serves each data rank's rows: the reference's sharded answers at
    the family's bar, and the port's single mode's bytes."""
    import jax.numpy as jnp

    from tpuserve.models import mobilenet as jmobilenet
    from tpuserve_torch.models import mobilenet as tmobilenet

    blocks = jmobilenet.V3_LARGE[:MNV3_SHALLOW]
    monkeypatch.setattr(tmobilenet.MobileNetV3Serving, "build_module",
                        lambda self: tmobilenet.MobileNetV3Large(self.cfg.num_classes,
                                                                 blocks=blocks))
    monkeypatch.setattr(jmobilenet.MobileNetV3Serving, "make_module",
                        lambda self, cfg: jmobilenet.MobileNetV3Large(
                            num_classes=cfg.num_classes, blocks=blocks,
                            dtype=jnp.dtype(cfg.dtype)))
    fields, tols = REPLICATED[family]
    kw = vision_kw(family, **fields)
    jm = jax_build(jconfig.ModelConfig(**kw))
    tree = jax.device_get(jm.load_params() if family != "mobilenetv3"
                          else jm.init_params(jax.random.key(0)))
    npz = str(tmp_path / "w.npz")
    savedmodel.save_npz(npz, tree)
    model, rt, jrt = reference_and_port(kw, tree, npz, 2, parallelism="sharded", tp=2)
    assert dict(rt.mesh.shape) == {"data": 1, "model": 2, "seq": 1}
    assert rt.parallel_signature == jrt.parallel_signature == "sharded@d1"
    assert isinstance(rt.module, MeshModule) and len(rt.module.ranks) == 1
    batch = images_batch(model)
    if model.cfg.wire_format == "yuv420":
        from tpuserve_torch import preproc

        rng = np.random.default_rng(11)
        batch = model.assemble([preproc.rgb_to_yuv420(rng.integers(0, 256, (32, 32, 3),
                                                                   np.uint8))
                                for _ in range(4)], (4,))
    out = rt.fetch(rt.run((4,), batch))
    ref = jrt.fetch(jrt.run((4,), batch if len(batch) > 1 else batch[0]))
    for k, tol in tols.items():
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), atol=tol)
    one = build(tconfig.ModelConfig(**kw, weights=npz))
    base = build_runtime(one, device="cpu")
    want = base.fetch(base.run((4,), batch))
    assert sorted(out) == sorted(want)
    assert all(out[k].tobytes() == want[k].tobytes() for k in want)


# -- SD 1.5: a seq axis alone, and beside a data or model axis ------------------------

SD_TINY = dict(steps=2, guidance=5.0, vocab_size=512, text_layers=1, text_d_model=32,
               text_heads=2, unet_ch=16, unet_mults=[1, 2], unet_res=1,
               unet_attn_levels=[0], unet_heads=2, vae_ch=16, vae_mults=[1, 2])


def sd_kw(**over) -> dict:
    base = dict(name="sd", family="sd15", batch_buckets=[2], dtype="float32",
                parallelism="sharded", image_size=32, options=dict(SD_TINY))
    base.update(over)
    return base


def test_sd15_serves_a_seq_axis_alone():
    bodies = [b'{"prompt": "a red cat", "seed": 1}', b'{"prompt": "a blue dog", "seed": 2}']
    out = []
    for over, n_chips in ((dict(parallelism="single"), 0), (dict(sp=2), 2)):
        model = build(tconfig.ModelConfig(**sd_kw(**over)))
        rt = build_runtime(model, device="cpu", parallel=tconfig.ParallelConfig(n_chips=n_chips))
        assert not isinstance(rt.module, MeshModule)
        batch = model.assemble([model.host_decode(b, "application/json") for b in bodies], (2,))
        out.append(rt.fetch(rt.run((2,), batch)))
    assert dict(rt.mesh.shape) == {"data": 1, "model": 1, "seq": 2}
    assert all(out[1][k].tobytes() == out[0][k].tobytes() for k in out[0])


@pytest.mark.parametrize("over, n_chips, shape", [
    (dict(sp=2), 4, {"data": 2, "model": 1, "seq": 2}),
    (dict(tp=2), 2, {"data": 1, "model": 2, "seq": 1})], ids=["data2-seq2", "model2"])
def test_sd15_serves_beside_a_data_or_model_axis(over, n_chips, shape):
    """A split slot (a module per data rank, or per model rank holding its
    heads and GEGLU block): single mode's images by the pixel rule."""
    bodies = [b'{"prompt": "a red cat", "seed": 1}', b'{"prompt": "a blue dog", "seed": 2}']
    out = []
    for kw, n in ((dict(parallelism="single"), 0), (over, n_chips)):
        model = build(tconfig.ModelConfig(**sd_kw(**kw)))
        rt = build_runtime(model, device="cpu", parallel=tconfig.ParallelConfig(n_chips=n))
        batch = model.assemble([model.host_decode(b, "application/json") for b in bodies], (2,))
        out.append(rt.fetch(rt.run((2,), batch))["image"])
    assert dict(rt.mesh.shape) == shape
    assert isinstance(rt.module, MeshModule) and len(rt.module.ranks) == 2
    d = np.abs(out[1].astype(np.int16) - out[0].astype(np.int16))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())


# -- the server's view of the new layouts --------------------------------------------

@pytest.mark.parametrize("kw, n_chips", [
    (bert_kw(options=dict(BERT, attention="ring"), parallelism="sharded", sp=2), 4),
    (bert_kw(options=dict(BERT, attention="ulysses"), parallelism="sharded", tp=2, sp=2), 8),
    (vision_kw("toy", wire_size=8, parallelism="sharded", tp=2, sp=2), 8)],
    ids=["ring-data2-seq2", "ulysses-data2-model2-seq2", "toy-data2-model2-seq2"])
def test_stats_parallel_block_reads_as_the_reference(kw, n_chips):
    """``/stats`` ``parallel`` (its keys; mode, signature, chips, replicas
    and one batch count for the mesh), the mesh's shape and the variants'
    parallelism key, as the reference's for the same mesh."""
    from tpuserve.server import ServerState as JaxServerState
    from tpuserve_torch.server import ServerState

    blocks = []
    for state in (JaxServerState(jconfig.ServerConfig(
                      models=[jconfig.ModelConfig(**kw)],
                      parallel=jconfig.ParallelConfig(n_chips=n_chips), startup_canary=False)),
                  ServerState(tconfig.ServerConfig(
                      models=[tconfig.ModelConfig(**kw)],
                      parallel=tconfig.ParallelConfig(n_chips=n_chips), startup_canary=False),
                      device="cpu")):
        state.build()
        rt = state.runtimes[kw["name"]]
        par = state.parallel_stats()[kw["name"]]
        blocks.append((sorted(par), [par[k] for k in ("mode", "signature", "n_chips", "replicas")],
                       len(par["replica_batches_total"]),
                       dict(rt.meshes[0].shape if hasattr(rt, "meshes") else rt.mesh.shape),
                       sorted(str(k.parallelism) for k in rt.variants)))
    assert blocks[1] == blocks[0]
