"""SD 1.5 on a split mesh (a data axis, a model axis, both, and a seq axis
beside them) against the JAX package on the CPU.

The JAX side runs on its conftest's 8 fake host devices; the port's with
``mesh.visible_devices`` patched to ``["cpu"] * 8`` (eight ranks sharing
the CPU, single-controller). Both serve one tree at the reference tests'
tiny options (``SD_TINY``: 1-layer CLIP of width 32 over 2 heads, a 2-level
UNet of 16 channels attending at level 0 over 2 heads, a 2-level VAE),
float32: the reference's seeded init with every bias drawn from a numpy
seed (zero biases would hide a bias added by every model rank), which the
port reads from a ``.npz``. The reference builds once per mesh (the first
build compiles for about a minute).

Tolerances:

- the locked ``forward``'s uint8 images on model 2, data 2, data 2 x
  model 2 and data 2 x model 2 x seq 2, against the reference's forward
  on the same mesh: every pixel within 1, at least 99 % equal (the bar of
  ``tests/test_torch_sd15.py``);
- one UNet call at ``image_size = 64`` (1,024 latent tokens: the flash
  branch, K1's plain version here, the reference's Pallas kernel in
  interpret mode) and CLIP's hidden states on the model-2 view, against
  the reference and against the port's single mode: within 2e-4 abs and
  rel;
- exact: each model rank's ``ff_up`` weight and bias are the whole leaf's
  gate block r beside its value block r and its ``ff_down`` rows value
  block r (a contiguous split of ``ff_up`` fails the same check and moves
  the block's output); q/k/v biases by heads, ``mlp_up``'s by columns;
  the ``out``/``ff_down``/``mlp_down`` biases on rank 0 alone; a rank's
  tree round-trips through ``from_jax_params``/``to_jax_params``; a
  reload copies each rank's blocks into the slot's tensors in place;
- int8 (``quantize = "int8"``) on data 2 x model 2 against single int8
  mode: the pixel rule above;
- the engine on data 2 x model 2 against the reference's ``GenEngine`` on
  the same mesh and against the port's locked forward on it: pixels
  within 1, at least 99 % equal; an engine image independent of its slot,
  and the same body twice giving the same bytes: exact;
- ``tp = 3`` (dividing neither 2 heads) is refused with a ValueError
  naming both head counts; the pipeline layout stays refused, as the
  reference refuses it.
"""

import asyncio
import io

import jax
import numpy as np
import pytest
import torch

from tpuserve import config as jconfig
from tpuserve import genserve as jgenserve
from tpuserve import obs as jobs
from tpuserve.models import build as jax_build
from tpuserve.runtime import build_runtime as jax_build_runtime
from tpuserve_torch import config as tconfig
from tpuserve_torch import genserve as tgenserve
from tpuserve_torch import obs as tobs
from tpuserve_torch import savedmodel
from tpuserve_torch.models import build
from tpuserve_torch.models import sd15 as tsd
from tpuserve_torch.models.base import MeshModule
from tpuserve_torch.parallel import mesh as meshlib
from tpuserve_torch.runtime import build_runtime

N_DEV = 8
TOL = 2e-4
SD_TINY = dict(steps=2, guidance=5.0, vocab_size=512, text_layers=1, text_d_model=32,
               text_heads=2, unet_ch=16, unet_mults=[1, 2], unet_res=1,
               unet_attn_levels=[0], unet_heads=2, vae_ch=16, vae_mults=[1, 2])
BODIES = [b'{"prompt": "a red cat on a mat", "seed": 1}',
          b'{"prompt": "a blue dog", "negative_prompt": "blur", "seed": -3}']
# name -> (ModelConfig fields, [parallel] n_chips, mesh shape, rank modules).
MESHES = {
    "model2": (dict(tp=2), 2, {"data": 1, "model": 2, "seq": 1}, 2),
    "data2": ({}, 2, {"data": 2, "model": 1, "seq": 1}, 2),
    "data2-model2": (dict(tp=2), 4, {"data": 2, "model": 2, "seq": 1}, 4),
    "data2-model2-seq2": (dict(tp=2, sp=2), 8, {"data": 2, "model": 2, "seq": 2}, 4),
}


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


def sd_kw(**over) -> dict:
    base = dict(name="sd", family="sd15", batch_buckets=[2], dtype="float32",
                parallelism="sharded", image_size=32, request_timeout_ms=120_000.0,
                options=dict(SD_TINY))
    base.update(over)
    return base


def with_biases(tree, seed: int):
    """``tree`` with every bias leaf drawn from N(0, 0.05) (numpy seed)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    rng.normal(0.0, 0.05, np.shape(v)).astype(np.float32) if k == "bias"
                    else np.asarray(v)) for k, v in node.items()}

    return walk(tree)


@pytest.fixture(scope="module")
def tree():
    return with_biases(jax.device_get(jax_build(jconfig.ModelConfig(**sd_kw())).load_params()),
                       seed=22)


@pytest.fixture(scope="module")
def npz(tree, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sd") / "sd.npz")
    savedmodel.save_npz(path, tree)
    return path


def reference(tree, n_chips: int, compile_forward: bool = True, **over):
    jm = jax_build(jconfig.ModelConfig(**sd_kw(**over)))
    jm.load_params = lambda: tree
    return jm, jax_build_runtime(jm, compile_forward=compile_forward,
                                 parallel=jconfig.ParallelConfig(n_chips=n_chips))


def port(npz: str, n_chips: int, compile_forward: bool = True, **over):
    model = build(tconfig.ModelConfig(**sd_kw(weights=npz, **over)))
    return model, build_runtime(model, device="cpu", compile_forward=compile_forward,
                                parallel=tconfig.ParallelConfig(n_chips=n_chips))


def items(model, bodies=BODIES) -> list:
    return [model.host_decode(b, "application/json") for b in bodies]


def pixel_rule(got: np.ndarray, want: np.ndarray) -> None:
    """Every uint8 pixel within 1, at least 99 % equal."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def reference_images(tree):
    """The reference's locked images per mesh, each mesh built once."""
    cache: dict = {}

    def get(name: str) -> np.ndarray:
        if name not in cache:
            over, n_chips, shape, _ = MESHES[name]
            jm, jrt = reference(tree, n_chips, **over)
            assert dict(jrt.meshes[0].shape) == shape
            cache[name] = np.asarray(jrt.fetch(jrt.run((2,), jm.assemble(items(jm), (2,))))[
                "image"])
        return cache[name]

    return get


@pytest.fixture(scope="module")
def single_images(npz):
    model, rt = port(npz, 0, parallelism="single")
    return rt.fetch(rt.run((2,), model.assemble(items(model), (2,))))["image"]


# -- the locked batch on each mesh ------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_locked_forward_on_a_split_mesh_matches_reference(mesh, npz, reference_images,
                                                          single_images):
    over, n_chips, shape, n_ranks = MESHES[mesh]
    model, rt = port(npz, n_chips, **over)
    assert dict(rt.mesh.shape) == shape
    assert rt.parallel_signature == f"sharded@d{shape['data']}"
    assert isinstance(rt.module, MeshModule) and len(rt.module.ranks) == n_ranks
    got = rt.fetch(rt.run((2,), model.assemble(items(model), (2,))))["image"]
    assert got.dtype == np.uint8 and got.shape == (2, 32, 32, 3)
    pixel_rule(got, reference_images(mesh))
    pixel_rule(got, single_images)


# -- one UNet call and CLIP on the model-2 view ---------------------------------------

def test_unet_and_clip_on_the_model_view(tree, npz, monkeypatch):
    """At image_size 64 the latent is 32 x 32: each model rank's K1 (plain
    version) runs on its one head at 1,024 tokens, three calls a rank."""
    kw = dict(image_size=64, options={**SD_TINY, "unet_attention": "flash"})
    jm = jax_build(jconfig.ModelConfig(**sd_kw(**kw)))
    model, rt = port(npz, 2, compile_forward=False, tp=2, **kw)
    single, srt = port(npz, 0, compile_forward=False, parallelism="single", **kw)
    view = model.data_ranks(rt.module)[0]
    assert len(view.ranks) == 2
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    t = np.array([999, 500], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    ids = rng.integers(0, model.vocab_size, (3, 77)).astype(np.int32)
    shapes = []
    orig = tsd.flash_attention
    monkeypatch.setattr(tsd, "flash_attention",
                        lambda q, k, v: shapes.append(tuple(q.shape)) or orig(q, k, v))
    with torch.inference_mode():
        eps = view.unet(*(torch.from_numpy(a) for a in (lat, t, ctx)))
        assert shapes == [(2, 1024, 1, 64)] * 6
        eps_single = srt.module.unet(*(torch.from_numpy(a) for a in (lat, t, ctx)))
        hidden = view.text(torch.from_numpy(ids))
        hidden_single = srt.module.text(torch.from_numpy(ids))
    close(eps, jax.jit(jm.unet.apply)(tree["unet"], lat, t, ctx))
    close(eps, eps_single)
    close(hidden, jax.jit(jm.text_encoder.apply)(tree["text"], ids))
    close(hidden, hidden_single)


# -- the split of the weights ------------------------------------------------------------

def geglu_blocks_hold(ranks: list, whole: dict, name: str) -> bool:
    """Rank r's ``ff_up`` (weight (out, in), bias) is the whole leaf's gate
    block r beside its value block r, and its ``ff_down`` rows value block
    r, for the spatial transformer ``name``."""
    up, down = whole[name]["block"]["ff_up"], whole[name]["block"]["ff_down"]
    n = up["kernel"].shape[1] // 2
    blk = n // len(ranks)
    for r, rank in enumerate(ranks):
        cols = np.r_[r * blk:(r + 1) * blk, n + r * blk:n + (r + 1) * blk]
        blocks = getattr(rank.unet, name).block
        if not (np.array_equal(blocks.ff_up.weight.numpy(), up["kernel"][:, cols].T)
                and np.array_equal(blocks.ff_up.bias.numpy(), up["bias"][cols])
                and np.array_equal(blocks.ff_down.weight.numpy(),
                                   down["kernel"][r * blk:(r + 1) * blk].T)):
            return False
    return True


def contiguous_ranks(model, tree, mesh) -> list:
    """The rank modules a contiguous column split of ``ff_up`` would give
    (``split_tree``'s blocks as the rules cut them, without the gate/value
    regrouping)."""
    view = model._with(tp_split=2)
    out = []
    for coord, rank_tree, _ in model.model_rank_trees(tree, mesh):
        module = view.build_module()
        module.load_state_dict(view.from_jax_params(model._tp_leaves(rank_tree, coord["model"],
                                                                     2)))
        out.append(module.eval().requires_grad_(False))
    return out


def test_geglu_split_takes_gate_and_value_blocks(tree, npz):
    model, rt = port(npz, 2, compile_forward=False, tp=2)
    ranks = list(rt.module.ranks)
    whole = tree["unet"]["params"]
    names = [n for n in whole if "attn" in n]
    assert names and all(geglu_blocks_hold(ranks, whole, n) for n in names)
    # A contiguous split hands rank 0 every gate column and rank 1 every
    # value column: the same check fails, and the block's output moves.
    naive = contiguous_ranks(model, tree, rt.mesh)
    assert not any(geglu_blocks_hold(naive, whole, n) for n in names)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 64, 16)).astype(np.float32))
    ctx = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 77, 32)).astype(
        np.float32))
    with torch.inference_mode():
        want = rt.module.ranks[0].unet.down0_attn0.block(x, ctx, [ranks[1].unet.down0_attn0.block])
        _, srt = port(npz, 0, compile_forward=False, parallelism="single")
        single = srt.module.unet.down0_attn0.block(x, ctx)
        bad = naive[0].unet.down0_attn0.block(x, ctx, [naive[1].unet.down0_attn0.block])
    close(want, single)
    assert (bad - single).abs().max() > 1e-2


def test_replicated_leaves_split_by_heads_and_columns_biases_once(tree, npz):
    """q/k/v biases by heads, ``mlp_up``'s by columns; the row-split
    products' biases (``out``, ``ff_down``, ``mlp_down``) on rank 0 alone;
    every replicated leaf (norms, convolutions, the VAE) whole on each."""
    _, rt = port(npz, 2, compile_forward=False, tp=2)
    ranks = list(rt.module.ranks)
    clip = tree["text"]["params"]["layer0"]
    unet = tree["unet"]["params"]["down0_attn0"]["block"]
    for r, rank in enumerate(ranks):
        for proj in ("query", "key", "value"):
            np.testing.assert_array_equal(getattr(rank.text.layer0.attn, proj).bias.numpy(),
                                          clip["attn"][proj]["bias"][r])
            np.testing.assert_array_equal(
                getattr(rank.unet.down0_attn0.block.cross_attn, proj).bias.numpy(),
                unet["cross_attn"][proj]["bias"][r])
        np.testing.assert_array_equal(rank.text.layer0.mlp_up.bias.numpy(),
                                      clip["mlp_up"]["bias"][r * 64:(r + 1) * 64])
        for got, want in ((rank.text.layer0.attn.out.bias, clip["attn"]["out"]["bias"]),
                          (rank.text.layer0.mlp_down.bias, clip["mlp_down"]["bias"]),
                          (rank.unet.down0_attn0.block.self_attn.out.bias,
                           unet["self_attn"]["out"]["bias"]),
                          (rank.unet.down0_attn0.block.ff_down.bias, unet["ff_down"]["bias"])):
            np.testing.assert_array_equal(got.numpy(), want if r == 0 else np.zeros_like(want))
        np.testing.assert_array_equal(rank.unet.down0_attn0.proj_in.bias.numpy(),
                                      tree["unet"]["params"]["down0_attn0"]["proj_in"]["bias"])
        np.testing.assert_array_equal(rank.vae.mid_attn.q.bias.numpy(),
                                      tree["vae"]["params"]["mid_attn"]["q"]["bias"])


def test_rank_tree_round_trips(tree, npz):
    """A model rank's tree (its blocks) through ``from_jax_params`` and
    ``to_jax_params`` of the rank's view, bit for bit, leaf shapes the
    rank's (heads / 2 per attention)."""
    model, rt = port(npz, 2, compile_forward=False, tp=2)
    view = model._with(tp_split=2)
    (_, rank_tree, _), _ = model.model_rank_trees(model._geglu_blocks(tree, 2), rt.mesh)
    rank_tree = model._tp_leaves(rank_tree, 0, 2)
    back = view.to_jax_params(view.from_jax_params(rank_tree))
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(rank_tree)[0])
    assert sorted(map(str, flat)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(flat[path], leaf)
    assert back["unet"]["params"]["down0_attn0"]["block"]["self_attn"]["query"][
        "kernel"].shape == (16, 1, 8)


def test_reload_copies_rank_blocks_in_place(tree, npz, tmp_path):
    """A staged tree lands in a free slot of a data 2 x model 2 runtime by
    copies into its rank tensors (their storage unchanged); published, it
    serves a fresh runtime's images on that tree; rolled back, the first."""
    path = str(tmp_path / "sd.npz")
    savedmodel.save_npz(path, tree)
    model, rt = port(path, 4, tp=2)
    batch = model.assemble(items(model), (2,))
    before = rt.fetch(rt.run((2,), batch))["image"]
    ptrs = [{k: t.data_ptr() for k, t in s.tensors.items()} for s in rt.slots]
    other = with_biases(tree, seed=23)
    savedmodel.save_npz(path, other)
    rt.publish(rt.stage_params())
    assert [{k: t.data_ptr() for k, t in s.tensors.items()} for s in rt.slots] == ptrs
    after = rt.fetch(rt.run((2,), batch))["image"]
    fresh_model, fresh = port(path, 4, tp=2)
    np.testing.assert_array_equal(after, fresh.fetch(fresh.run((2,), batch))["image"])
    assert (after != before).any()
    rt.rollback()
    np.testing.assert_array_equal(rt.fetch(rt.run((2,), batch))["image"], before)


def test_int8_on_data2_model2_matches_single_int8(npz):
    """Under ``quantize = "int8"`` (every kernel of 64 elements or more)
    the whole tree is quantized before the split, so a rank's ``ff_up``
    takes its gate and value columns' int8 values and scales: single int8
    mode's images by the pixel rule."""
    out = []
    for over, n_chips in ((dict(parallelism="single"), 0), (dict(tp=2), 4)):
        model, rt = port(npz, n_chips, quantize="int8", quantize_min_size=64, **over)
        out.append(rt.fetch(rt.run((2,), model.assemble(items(model), (2,))))["image"])
    assert isinstance(rt.module, MeshModule) and len(rt.module.ranks) == 4
    pixel_rule(out[1], out[0])


# -- the engine on data 2 x model 2 ------------------------------------------------------

def png_pixels(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def engine_pngs(pkg, model, rt, bodies: list, slots: int) -> list[bytes]:
    gcfg = pkg.config.GenserveConfig(slots=slots)
    eng = pkg.genserve.GenEngine(model, rt, pkg.obs.Metrics(), gcfg)
    eng.compile()

    async def go():
        await eng.start()
        out = await asyncio.gather(*[eng.submit(it) for it in items(model, bodies)])
        await eng.stop()
        return out

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


class _Pkg:
    def __init__(self, config, genserve, obs):
        self.config, self.genserve, self.obs = config, genserve, obs


JAX = _Pkg(jconfig, jgenserve, jobs)
PORT = _Pkg(tconfig, tgenserve, tobs)


@pytest.fixture(scope="module")
def engine_runtime(npz):
    return port(npz, 4, compile_forward=False, tp=2)


def test_engine_on_data2_model2_matches_reference_and_locked(tree, npz, engine_runtime):
    model, rt = engine_runtime
    assert dict(rt.mesh.shape) == MESHES["data2-model2"][2]
    got = engine_pngs(PORT, model, rt, BODIES, slots=3)
    jm, jrt = reference(tree, 4, compile_forward=False, tp=2)
    want = engine_pngs(JAX, jm, jrt, BODIES, slots=3)
    lm, lrt = port(npz, 4, tp=2)
    locked = lrt.fetch(lrt.run((2,), lm.assemble(items(lm), (2,))))["image"]
    for i, (g, w) in enumerate(zip(got, want)):
        pixel_rule(png_pixels(g), png_pixels(w))
        pixel_rule(png_pixels(g), locked[i])


def test_engine_image_does_not_depend_on_its_slot(engine_runtime):
    """The same body twice at once lands in two slots (its UNet rows at
    other positions of the step's batch, on every model rank): the same
    bytes, and the same again in a later run."""
    model, rt = engine_runtime
    a, b, c = engine_pngs(PORT, model, rt, [BODIES[1], BODIES[1], BODIES[0]], slots=3)
    assert a == b and a != c
    (again,) = engine_pngs(PORT, model, rt, [BODIES[1]], slots=3)
    assert again == a


# -- refusals ------------------------------------------------------------------------------

def test_tp_must_divide_the_heads():
    with pytest.raises(ValueError, match="unet_heads=2 and text_heads=2"):
        build(tconfig.ModelConfig(**sd_kw(tp=3)))


def test_pipeline_layout_stays_refused():
    """As the reference's: a generative family's programs do not compose
    with the pipeline's stage layout (SD has no homogeneous block stack)."""
    model = build(tconfig.ModelConfig(**sd_kw(parallelism="pipeline", pp=2)))
    with pytest.raises(ValueError, match="pipeline"):
        build_runtime(model, device="cpu", compile_forward=False,
                      parallel=tconfig.ParallelConfig(n_chips=2))
