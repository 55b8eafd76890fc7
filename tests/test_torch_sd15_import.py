"""SD 1.5's checkpoint import in the port against the reference's
(``tpuserve_torch/models/sd15_import.py``, ``savedmodel.read_safetensors``
and ``extract_torch_state_dict``).

One random tiny checkpoint in the published LDM layout — transformers'
``CLIPTextModel`` and the LDM-layout UNet and VAE towers of
``tests/test_torch_parity.py``, randomized from seed 0 — is written as a
``.safetensors`` and as an LDM-style ``.ckpt`` pickle (weights under
``state_dict``, a step counter beside them). On each:

- the port's imported tree equals the reference's ``import_torch_variables``
  output leaf for leaf (same paths, ``np.array_equal``);
- the port's towers, loaded from that tree, match the torch towers at the
  reference's ``TOL`` (rtol 2e-3, atol 2e-4);
- the runtime boots from the file and ``:reload`` re-imports it.

The hand-written ``.safetensors`` reader equals ``safetensors.torch.load_file``
(widened with ``.float()``) for F32, F16 and BF16 and refuses truncated and
overlapping files; the wrong-width and non-LDM checkpoints are refused with
the reference's messages; the chip smoke's LDM writer (``chip_smoke.
ldm_state_dict``, the importer's inverse) gives the seeded tree back
exactly through the import.
"""

import importlib.util
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from tpuserve.config import ModelConfig as JaxModelConfig
from tpuserve.models import build as jax_build
from tpuserve_torch import savedmodel as tsm
from tpuserve_torch.config import ModelConfig
from tpuserve_torch.models import build
from tpuserve_torch.utils.trees import flatten_with_paths

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_parity as ldm  # noqa: E402  (the LDM towers; its `slow` mark stays there)

ROOT = Path(__file__).resolve().parents[1]
TOL = ldm.TOL


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cfgs(weights=None, **over):
    kw = dict(name="sd", family="sd15", dtype="float32", batch_buckets=[1], image_size=32,
              weights=weights, options=ldm.tiny_sd_options())
    kw.update(over)
    return ModelConfig(parallelism="single", **kw), JaxModelConfig(**kw)


def jax_leaves(tree) -> list:
    return [(jax.tree_util.keystr(p), np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def port_leaves(tree) -> list:
    return [(p, np.asarray(leaf)) for p, leaf in flatten_with_paths(tree)]


def text_config(vocab: int):
    from transformers import CLIPTextConfig

    return CLIPTextConfig(
        vocab_size=vocab, hidden_size=ldm.TXT_D, intermediate_size=4 * ldm.TXT_D,
        num_hidden_layers=ldm.TXT_LAYERS, num_attention_heads=ldm.TXT_HEADS,
        max_position_embeddings=77, hidden_act="quick_gelu")


def towers(unet_ch: int = ldm.CH):
    """The three randomized torch towers (seed 0) in LDM layout."""
    from transformers import CLIPTextModel

    ldm.seed_all()
    clip = ldm.randomize(CLIPTextModel(text_config(ldm.model_vocab_size())))
    return clip, ldm.randomize(ldm.TUNet(ch=unet_ch)), ldm.randomize(ldm.TVAE())


def ldm_dict(clip, unet, vae) -> dict:
    out = {}
    out.update({f"cond_stage_model.transformer.{k}": v for k, v in clip.state_dict().items()})
    out.update({f"model.diffusion_model.{k}": v for k, v in unet.state_dict().items()})
    out.update({f"first_stage_model.{k}": v for k, v in vae.state_dict().items()})
    return {k: v.contiguous() for k, v in out.items()}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("sd_import")
    clip, unet, vae = towers()
    sd = ldm_dict(clip, unet, vae)
    paths = {"safetensors": str(d / "tiny_sd.safetensors"), "ckpt": str(d / "tiny_sd.ckpt")}
    save_file(sd, paths["safetensors"])
    torch.save({"state_dict": sd, "global_step": 470000, "epoch": 3}, paths["ckpt"])
    return {"paths": paths, "towers": (clip, unet, vae), "dir": d}


@pytest.fixture(scope="module")
def imported(ckpt):
    """{form: (port tree, reference tree)} from the same file."""
    out = {}
    for form, path in ckpt["paths"].items():
        pcfg, jcfg = cfgs(path)
        out[form] = (build(pcfg).load_tree(), jax_build(jcfg).load_params())
    return out


@pytest.mark.parametrize("form", ["safetensors", "ckpt"])
def test_imported_tree_equals_reference_leaf_for_leaf(imported, form):
    port, ref = imported[form]
    got, want = port_leaves(port), jax_leaves(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.array_equal(g, w), path


def test_both_forms_import_the_same_tree(imported):
    a, b = port_leaves(imported["safetensors"][0]), port_leaves(imported["ckpt"][0])
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))


@pytest.fixture(scope="module")
def port_module(ckpt, imported):
    pcfg, _ = cfgs(ckpt["paths"]["safetensors"])
    model = build(pcfg)
    module = model.build_module()
    module.load_state_dict(model.from_jax_params(imported["safetensors"][0]))
    return module.eval()


def test_text_tower_matches_clip_text_model(ckpt, port_module):
    clip = ckpt["towers"][0]
    ids = np.random.default_rng(0).integers(0, ldm.model_vocab_size(), (2, 77))
    with torch.no_grad():
        want = clip(input_ids=torch.from_numpy(ids)).last_hidden_state.numpy()
        got = port_module.text(torch.from_numpy(ids.astype(np.int32))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_unet_matches_ldm_unet(ckpt, port_module):
    unet = ckpt["towers"][1]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 750], dtype=np.int32)
    ctx = rng.standard_normal((2, 77, ldm.TXT_D)).astype(np.float32)
    with torch.no_grad():
        want = ldm.to_nhwc(unet(ldm.nchw(x), torch.from_numpy(t), torch.from_numpy(ctx)))
        got = port_module.unet(torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_vae_decoder_matches_ldm_vae(ckpt, port_module):
    vae = ckpt["towers"][2]
    z = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)
    with torch.no_grad():
        want = ldm.to_nhwc(vae(ldm.nchw(z)))
        got = port_module.vae(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_runtime_boots_from_the_checkpoint_and_reloads_it(ckpt):
    """The serving path: the runtime loads its slots from the .safetensors,
    serves an image equal to the runtime booted from the same tree as a
    .npz, and a reload re-imports the file (version 2, the same image)."""
    from tpuserve_torch.runtime import build_runtime

    path = ckpt["paths"]["safetensors"]
    npz = str(ckpt["dir"] / "tiny_sd.npz")
    tsm.save_npz(npz, build(cfgs(path)[0]).load_tree())
    images = []
    for weights in (path, npz):
        model = build(cfgs(weights)[0])
        rt = build_runtime(model, device="cpu")
        item = model.host_decode(b'{"prompt": "a cat", "seed": 3}', "application/json")
        bucket = (1,)
        images.append(rt.fetch(rt.dispatch(bucket, rt.h2d(bucket, model.assemble([item], bucket))))
                      ["image"])
        if weights == path:
            assert rt.reload_params()["version"] == 2
            again = rt.fetch(rt.dispatch(bucket, rt.h2d(bucket, model.assemble([item], bucket))))
            np.testing.assert_array_equal(again["image"], images[0])
    assert images[0].shape == (1, 32, 32, 3) and images[0].dtype == np.uint8
    np.testing.assert_array_equal(images[0], images[1])


# -- the .safetensors reader ---------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_reader_equals_safetensors_load_file(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(7, 5, generator=g) * 3,
               "b.bias": torch.randn(11, generator=g),
               "c.kernel": torch.randn(2, 3, 4, 5, generator=g),
               "d.scalar": torch.tensor(2.5), "e.empty": torch.zeros(0, 4)}
    path = str(tmp_path / "t.safetensors")
    save_file({k: v.to(dtype) for k, v in tensors.items()}, path, metadata={"format": "pt"})
    want = {k: v.float().numpy() for k, v in load_file(path).items()}
    got = tsm.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert tsm.extract_torch_state_dict(path).keys() == want.keys()


def _raw_safetensors(path: Path, header: dict, data: bytes) -> None:
    head = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(head)) + head + data)


@pytest.mark.parametrize("case, match", [
    ("no-length", "truncated"), ("short-header", "truncated"), ("short-data", "truncated"),
    ("overlap", "overlaps"), ("gap", "gap"), ("shape", "bytes for"), ("dtype", "unknown dtype"),
])
def test_reader_refuses_malformed_files(tmp_path, case, match):
    path = tmp_path / "bad.safetensors"
    f32 = np.arange(8, dtype=np.float32).tobytes()
    ok = {"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]},
          "y": {"dtype": "F32", "shape": [4], "data_offsets": [16, 32]}}
    if case == "no-length":
        path.write_bytes(b"\x01\x02")
    elif case == "short-header":
        path.write_bytes(struct.pack("<Q", 1000) + b"{}")
    elif case == "short-data":
        _raw_safetensors(path, ok, f32[:20])
    elif case == "overlap":
        _raw_safetensors(path, {**ok, "y": {"dtype": "F32", "shape": [4],
                                            "data_offsets": [8, 24]}}, f32[:24])
    elif case == "gap":
        _raw_safetensors(path, {**ok, "y": {"dtype": "F32", "shape": [2],
                                            "data_offsets": [24, 32]}}, f32)
    elif case == "shape":
        _raw_safetensors(path, {**ok, "y": {"dtype": "F32", "shape": [3],
                                            "data_offsets": [16, 32]}}, f32)
    else:
        _raw_safetensors(path, {**ok, "y": {"dtype": "Q4", "shape": [4],
                                            "data_offsets": [16, 32]}}, f32)
    with pytest.raises(ValueError, match=match):
        tsm.read_safetensors(str(path))


def test_bin_that_is_not_torch_gets_the_guidance(tmp_path):
    path = tmp_path / "ggml-model.bin"
    path.write_bytes(b"GGML" + bytes(64))
    with pytest.raises(ValueError, match="cannot identify weight format.*'.bin'"):
        build(cfgs(str(path))[0]).load_tree()


# -- refusals: the reference's messages -----------------------------------------

def _write(tmp_path, name: str, sd: dict) -> str:
    from safetensors.torch import save_file

    path = str(tmp_path / name)
    save_file(sd, path)
    return path


def test_wrong_architecture_fails_with_guidance(tmp_path):
    """A checkpoint whose UNet width disagrees with the config fails at
    import, in both packages, with the same message."""
    path = _write(tmp_path, "wrong.safetensors", ldm_dict(*towers(unet_ch=16)))
    pcfg, jcfg = cfgs(path)
    with pytest.raises(ValueError, match="shape|architecture") as port_err:
        build(pcfg).load_tree()
    with pytest.raises(ValueError, match="shape|architecture") as ref_err:
        jax_build(jcfg).load_params()
    assert str(port_err.value) == str(ref_err.value)


def test_non_ldm_checkpoint_rejected(tmp_path):
    path = _write(tmp_path, "other.safetensors", {"some.random.weight": torch.zeros(3, 3)})
    pcfg, jcfg = cfgs(path)
    with pytest.raises(ValueError, match="LDM") as port_err:
        build(pcfg).load_tree()
    with pytest.raises(ValueError, match="LDM") as ref_err:
        jax_build(jcfg).load_params()
    assert str(port_err.value) == str(ref_err.value)


def test_missing_tensor_and_vocabulary_mismatch_messages(ckpt, tmp_path):
    """A missing LDM tensor names itself; a token table of another size
    carries the reference's vocabulary-mismatch hint."""
    from safetensors.torch import load_file

    sd = load_file(ckpt["paths"]["safetensors"])
    gone = dict(sd)
    del gone["model.diffusion_model.out.2.weight"]
    pcfg, jcfg = cfgs(_write(tmp_path, "gone.safetensors", gone))
    with pytest.raises(ValueError, match="missing expected tensor") as port_err:
        build(pcfg).load_tree()
    with pytest.raises(ValueError) as ref_err:
        jax_build(jcfg).load_params()
    assert str(port_err.value) == str(ref_err.value)

    key = "cond_stage_model.transformer.text_model.embeddings.token_embedding.weight"
    wide = dict(sd, **{key: torch.zeros(sd[key].shape[0] + 5, sd[key].shape[1])})
    pcfg, jcfg = cfgs(_write(tmp_path, "vocab.safetensors", wide))
    with pytest.raises(ValueError, match="vocabulary mismatch") as port_err:
        build(pcfg).load_tree()
    with pytest.raises(ValueError) as ref_err:
        jax_build(jcfg).load_params()
    assert str(port_err.value) == str(ref_err.value)


# -- the chip smoke's writer: the importer's inverse ------------------------------

def test_smoke_ldm_writer_round_trips_the_seeded_tree(tmp_path):
    """``chip_smoke.ldm_state_dict`` + ``write_safetensors`` (what phase 20
    serves its locked server from) write the port's seeded tree in LDM
    layout; the port's import gives it back bit for bit, and the
    reference's import of the same file equals it."""
    cs = chip_smoke()
    model = build(cfgs()[0])
    tree = model.to_jax_params(model.init_params(0))
    path = tmp_path / "seeded.safetensors"
    size = cs.write_safetensors(path, cs.ldm_state_dict(tree, model))
    assert size == path.stat().st_size
    got = port_leaves(build(cfgs(str(path))[0]).load_tree())
    want = port_leaves(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))
    ref = jax_leaves(jax_build(cfgs(str(path))[1]).load_params())
    assert [p for p, _ in ref] == [p for p, _ in want]
    assert all(np.array_equal(r, w) for (_, r), (_, w) in zip(ref, want))


# -- what the port imports ------------------------------------------------------

def test_port_imports_no_checkpoint_library_and_tensorflow_only_in_functions():
    """The import path needs none of ``safetensors``, ``transformers`` or
    ``regex`` (the card's machine has none of them), nor the JAX package;
    TensorFlow is imported only inside functions of ``savedmodel.py``
    (``import-model``'s extraction), never when a module is imported."""
    import ast

    sources = sorted((ROOT / "tpuserve_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    banned = ("tpuserve", "jax", "flax", "safetensors", "transformers", "regex")
    tf_sites = []
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        in_function = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                in_function.update(id(n) for n in ast.walk(node) if n is not node)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path}: imports {name}"
                if top == "tensorflow":
                    assert id(node) in in_function, f"{path}: module-level {name}"
                    tf_sites.append(path.name)
    assert tf_sites and set(tf_sites) == {"savedmodel.py"}
