"""Model weights on disk and their integrity layer, ported from
``tpuserve/savedmodel.py``.

The JAX package's native checkpoint is an orbax directory; the port reads
the same parameter tree — the reference's float32 flax tree — from a
``.npz`` instead: one member per leaf, named by its ``keystr`` path
(``['params']['embed']['embedding']``). Orbax and safetensors are not
dependencies of the port, and a ``.npz`` needs nothing beyond numpy.
``save_npz`` writes one (and its manifest), ``load_npz`` reads it back into
the nested tree; each family's ``from_jax_params`` turns the tree into the
module's state_dict and ``to_jax_params`` back.

The other weight forms the reference reads, but orbax:

- **torch checkpoints** (``.safetensors`` / ``.ckpt`` / ``.pt`` / ``.pth``
  / ``.bin``), how SD 1.5-class artifacts ship, are served as they are:
  ``read_safetensors`` parses the format by hand (an 8-byte little-endian
  header length, a JSON header, raw bytes) through ``np.memmap``, so a
  4 GB file is not copied on its way in; pickles go through
  ``torch.load(weights_only=True)``, which runs no code from the file.
  Either gives a flat ``{name: np.ndarray}`` dict (16-bit floats widened
  to float32, as the reference's ``.float()``) that the family's
  ``import_torch_variables`` maps onto its tree.
- **TF SavedModel directories and frozen GraphDef ``.pb`` files** are read
  only by ``python -m tpuserve_torch import-model`` (``convert_cli``),
  which imports TensorFlow inside its functions, hands the flat dict to
  the family's ``import_tf_variables`` and writes the ``.npz``; serving
  refuses them by name.
- **orbax directories** need orbax and jax, which the port does not
  import: refused.

The sidecar checksum manifest is the JAX package's, byte for byte:
``<checkpoint>.manifest.json`` beside the file, holding per leaf the
sha256 over ``str(dtype)``, ``repr(shape)`` and the raw bytes. A manifest
written by either package over the same tree verifies in the other. A
reload recomputes the digests over the tree as read and rejects the
candidate on any mismatch (bit rot, a truncated copy, a writer racing the
reload) before it can serve. As in the reference, only the native form
(the ``.npz``) is held to it; a torch checkpoint is not.
"""

from __future__ import annotations

import ast
import hashlib
import json
import logging
import math
import os
import re
import struct
from typing import Any

import numpy as np

from tpuserve_torch.utils.trees import flatten_with_paths

log = logging.getLogger("tpuserve_torch.savedmodel")

MANIFEST_ALGO = "sha256"


class IntegrityError(ValueError):
    """A checkpoint failed its sidecar checksum manifest: the reload path
    rejects the candidate and the old version keeps serving."""


TORCH_SUFFIXES = (".safetensors", ".ckpt", ".pt", ".pth", ".bin")


def detect_format(path: str) -> str:
    """``"npz"`` for the port's checkpoint, ``"torch"`` for a torch one.
    A TF SavedModel directory or GraphDef ``.pb`` raises
    NotImplementedError naming ``import-model``, an orbax directory
    NotImplementedError; anything else ValueError."""
    fmt = import_format(path)
    if fmt in ("npz", "torch"):
        return fmt
    if fmt in ("saved_model", "graphdef"):
        kind = "a TF SavedModel" if fmt == "saved_model" else "a GraphDef"
        raise NotImplementedError(
            f"{path!r} is {kind}: tpuserve_torch serves the .npz form of the "
            "reference's parameter tree; convert it with `python -m "
            "tpuserve_torch import-model --saved-model <path> --family <family> "
            "--out <file>.npz` where TensorFlow is installed")
    raise NotImplementedError(
        f"{path!r} is an orbax checkpoint: tpuserve_torch reads the .npz form "
        "of the reference's parameter tree (tpuserve_torch.savedmodel.save_npz); "
        "orbax needs jax, which the port does not import")


def import_format(path: str) -> str:
    """The reference's detection (``tpuserve/savedmodel.py``'s
    ``detect_format``) plus the ``.npz``: ``"npz"`` | ``"torch"`` |
    ``"saved_model"`` | ``"graphdef"`` | ``"orbax"``; ValueError for
    anything else."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "saved_model.pb")):
            return "saved_model"
        return "orbax"
    if path.endswith(".npz"):
        return "npz"
    if path.endswith(".pb"):
        return "graphdef"
    if path.endswith(TORCH_SUFFIXES):
        return "torch"
    raise ValueError(f"cannot identify weight format of {path!r}")


# -- sidecar checksum manifest -------------------------------------------------

def manifest_path(ckpt_path: str) -> str:
    return os.path.abspath(ckpt_path).rstrip("/") + ".manifest.json"


def _leaf_digest(a: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(tuple(a.shape)).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def tree_digests(params: Any) -> dict[str, str]:
    """{tree path: sha256 hex} over dtype + shape + raw bytes per leaf."""
    return {path: _leaf_digest(np.asarray(leaf))
            for path, leaf in flatten_with_paths(params)}


def write_manifest(ckpt_path: str, params: Any) -> str:
    mpath = manifest_path(ckpt_path)
    doc = {"algo": MANIFEST_ALGO, "leaves": tree_digests(params)}
    tmp = mpath + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, mpath)  # atomic: a racing reader never sees a torn file
    return mpath


def verify_manifest_if_present(ckpt_path: str, params: Any,
                               require: bool = False) -> bool:
    """Check ``params`` against the sidecar manifest; raises IntegrityError on
    any mismatch. Returns False when no manifest exists (skipped) — unless
    ``require`` is set, which makes a missing manifest itself a rejection."""
    mpath = manifest_path(ckpt_path)
    if not os.path.exists(mpath):
        if require:
            raise IntegrityError(
                f"no checksum manifest at {mpath!r} and lifecycle."
                "require_manifest is set; re-export the checkpoint with "
                "save_npz")
        log.debug("no manifest for %s; integrity check skipped", ckpt_path)
        return False
    with open(mpath, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("algo") != MANIFEST_ALGO:
        raise IntegrityError(
            f"manifest {mpath!r} uses unknown algo {doc.get('algo')!r}")
    want: dict[str, str] = doc.get("leaves", {})
    got = tree_digests(params)
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        changed = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        detail = "; ".join(
            f"{label} {paths[:3]}" for label, paths in
            (("missing", missing), ("unexpected", extra), ("corrupt", changed))
            if paths)
        raise IntegrityError(
            f"checkpoint at {ckpt_path!r} fails its checksum manifest "
            f"({detail}); candidate rejected")
    return True


# -- the port's checkpoint: the reference's tree in a .npz ---------------------

_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")\]")


def _path_keys(path: str) -> list[str]:
    """``"['a']['b']"`` -> ``["a", "b"]``; ValueError for any other
    spelling (the tree's keys are strings)."""
    keys = [ast.literal_eval(m) for m in _KEY.findall(path)]
    if "".join(f"[{k!r}]" for k in keys) != path or not keys:
        raise ValueError(f"checkpoint member {path!r} is not a tree path of string keys")
    return keys


def save_npz(path: str, tree: Any) -> str:
    """Write ``tree`` (nested dicts of arrays; numpy or CPU tensors are read
    as numpy) to ``path`` (which must end in ``.npz``), then its manifest.
    Both writes are atomic renames. Returns the manifest's path."""
    if not path.endswith(".npz"):
        raise ValueError(f"the port's checkpoint is a .npz file, got {path!r}")
    leaves = {p: np.asarray(leaf) for p, leaf in flatten_with_paths(tree)}
    for p in leaves:
        _path_keys(p)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **leaves)
    os.replace(tmp, path)
    return write_manifest(path, leaves_to_tree(leaves))


def leaves_to_tree(leaves: dict[str, np.ndarray]) -> dict:
    """``{keystr path: array}`` -> the nested dict tree."""
    tree: dict = {}
    for path, a in leaves.items():
        *parents, last = _path_keys(path)
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(f"checkpoint member {path!r} lies under a leaf")
        if last in node:
            raise ValueError(f"checkpoint member {path!r} clashes with a subtree")
        node[last] = a
    return tree


def load_npz(path: str) -> dict:
    """Read a checkpoint written by ``save_npz`` (or by hand with the same
    member names) back into the nested tree of numpy arrays."""
    detect_format(path)
    with np.load(path, allow_pickle=False) as z:
        return leaves_to_tree({name: z[name] for name in z.files})


# -- torch checkpoints ---------------------------------------------------------

# safetensors dtype names -> numpy dtypes; BF16 has none and is widened.
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Flat {name: np.ndarray} from a ``.safetensors`` file, parsed by hand:
    an 8-byte little-endian header length, a JSON header (``dtype``,
    ``shape``, ``data_offsets`` per tensor; ``__metadata__`` skipped), then
    the tensors' raw bytes. The bytes are read through ``np.memmap``: a
    float32 tensor comes back as a read-only view of the mapped file, so a
    4 GB checkpoint is not copied on its way in; BF16 (uint16 shifted left by
    16, viewed as float32) and F16 are widened to float32, as the
    reference's ``.float()``. A truncated file, offsets that overlap, leave
    a gap or disagree with the shape raise ValueError."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"safetensors file {path!r} is truncated: no header length")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"safetensors file {path!r} is truncated: its header "
                             f"needs {n} bytes, the file holds {size - 8}")
        header = json.loads(f.read(n))
    start = 8 + n
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=start, shape=(size - start,))
            if size > start else np.zeros((0,), np.uint8))
    entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                     key=lambda kv: tuple(kv[1]["data_offsets"]))
    out: dict[str, np.ndarray] = {}
    end_prev = 0
    for name, info in entries:
        begin, end = (int(x) for x in info["data_offsets"])
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"safetensors tensor {name!r}: unknown dtype {info['dtype']!r}")
        if begin < end_prev:
            raise ValueError(f"safetensors file {path!r}: tensor {name!r} overlaps the "
                             f"one before it (offsets {begin} < {end_prev})")
        if begin > end_prev:
            raise ValueError(f"safetensors file {path!r}: a gap of {begin - end_prev} "
                             f"bytes before tensor {name!r}")
        if end > data.shape[0]:
            raise ValueError(f"safetensors file {path!r} is truncated: tensor {name!r} "
                             f"ends at byte {end} of a {data.shape[0]}-byte buffer")
        dtype = np.dtype(_ST_DTYPES[info["dtype"]])
        shape = tuple(int(d) for d in info["shape"])
        if end - begin != math.prod(shape) * dtype.itemsize:
            raise ValueError(f"safetensors tensor {name!r}: {end - begin} bytes for "
                             f"{info['dtype']} {list(shape)}")
        a = data[begin:end].view(dtype).reshape(shape)
        if info["dtype"] == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] == "F16":
            a = a.astype(np.float32)
        out[name] = a
        end_prev = end
    if end_prev != data.shape[0]:
        raise ValueError(f"safetensors file {path!r}: {data.shape[0] - end_prev} bytes "
                         "after the last tensor")
    return out


def extract_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Flat {name: np.ndarray} from a torch-ecosystem checkpoint file.

    - ``.safetensors``: ``read_safetensors`` (no pickle, no copy).
    - pickle checkpoints (``.ckpt``/``.pt``/``.pth``/``.bin``): read with
      ``torch.load(weights_only=True)`` — tensor data only, no arbitrary
      code execution from untrusted files. LDM-style wrappers that nest the
      weights under a ``state_dict`` key are unwrapped; entries that are not
      tensors (step counters) are skipped.

    bf16/f16 tensors are widened to float32 (numpy has no bf16); the runtime
    casts to the serving compute dtype on its way to the device anyway."""
    if path.endswith(".safetensors"):
        out = read_safetensors(path)
    else:
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        out = {}
        for k, v in sd.items():
            if not isinstance(v, torch.Tensor):
                continue
            if v.dtype in (torch.bfloat16, torch.float16):
                v = v.float()
            out[k] = v.numpy()
    if not out:
        raise ValueError(f"torch checkpoint at {path!r} holds no tensors")
    return out


def read_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """``extract_torch_state_dict``, with the reference's guidance for a
    ``.bin`` that is not a torch checkpoint (``.bin`` is only assumed to be
    one: pytorch_model.bin is the common case, a GGML or raw blob is not)."""
    try:
        return extract_torch_state_dict(path)
    except Exception as e:
        if path.endswith(".bin"):
            raise ValueError(
                f"cannot identify weight format of {path!r}: tried the "
                "torch loader for the '.bin' suffix but it failed "
                f"({type(e).__name__}: {e}); supported formats are the port's "
                ".npz, TF SavedModel dirs and GraphDef .pb (through import-model), "
                "and torch .safetensors/.ckpt/.pt/.pth/.bin") from e
        raise


# -- TF weight extraction (import-model only; TensorFlow imported lazily) ------

_CKPT_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def extract_saved_model_variables(path: str) -> dict[str, np.ndarray]:
    """Flat {name: np.ndarray} from a TF2 SavedModel.

    Prefers the loaded object's ``variables`` collection, whose names are the
    semantic layer paths (``conv1_conv/kernel``) that family
    ``import_tf_variables`` mappings are written against; the ``:0`` tensor
    suffix is stripped. Falls back to reading the ``variables/`` checkpoint
    shards directly (object-graph paths like ``layer_with_weights-0/kernel``)
    for SavedModels whose root object exposes no variables."""
    import tensorflow as tf

    out: dict[str, np.ndarray] = {}
    try:
        loaded = tf.saved_model.load(path)
        variables = list(getattr(loaded, "variables", None) or ())
        semantic: dict[str, np.ndarray] = {}
        for v in variables:
            semantic[v.name.split(":")[0]] = np.asarray(v.numpy())
        # Commit only a complete AND collision-free read: a mid-loop failure
        # or duplicate names (legal in TF for subclassed models) must not
        # hand a truncated dict to import_tf_variables when the checkpoint
        # reader below could produce the full set.
        if len(semantic) == len(variables):
            out = semantic
        elif variables:
            log.warning(
                "SavedModel %s has %d variables but only %d unique names; "
                "using checkpoint reader", path, len(variables), len(semantic))
    except Exception:  # noqa: BLE001 — fall through to the checkpoint reader
        log.warning("tf.saved_model.load failed for %s; using checkpoint reader", path)
    if out:
        return out

    reader = tf.train.load_checkpoint(os.path.join(path, "variables", "variables"))
    for key in reader.get_variable_to_shape_map():
        name = key[: -len(_CKPT_SUFFIX)] if key.endswith(_CKPT_SUFFIX) else key
        if name.startswith("_CHECKPOINTABLE_OBJECT_GRAPH") or "OBJECT_CONFIG" in name:
            continue
        out[name] = reader.get_tensor(key)
    if not out:
        raise ValueError(f"SavedModel at {path!r} exposes no variables")
    return out


def extract_graphdef_constants(path: str) -> dict[str, np.ndarray]:
    """Flat {node_name: np.ndarray} of Const nodes from a frozen GraphDef."""
    import tensorflow as tf

    gd = tf.compat.v1.GraphDef()
    with open(path, "rb") as f:
        gd.ParseFromString(f.read())
    out: dict[str, np.ndarray] = {}
    for node in gd.node:
        if node.op == "Const":
            t = node.attr["value"].tensor
            out[node.name] = np.array(tf.make_ndarray(t))
    if not out:
        raise ValueError(f"GraphDef at {path!r} has no Const nodes")
    return out


def import_tree(model, path: str) -> Any:
    """The reference's parameter tree of ``model`` from the checkpoint at
    ``path``, in any form ``import_format`` names but orbax: the ``.npz``
    as it is, a torch checkpoint through the family's
    ``import_torch_variables``, a SavedModel or GraphDef (TensorFlow needed)
    through its ``import_tf_variables``."""
    fmt = import_format(path)
    if fmt == "npz":
        return load_npz(path)
    if fmt == "torch":
        return model.import_torch_variables(read_torch_checkpoint(path))
    if fmt == "orbax":
        detect_format(path)  # refused by name
    flat = (extract_saved_model_variables(path) if fmt == "saved_model"
            else extract_graphdef_constants(path))
    return model.import_tf_variables(flat)


# -- import-model ----------------------------------------------------------------

def convert_cli(saved_model_path: str, family: str, out_path: str,
                options: dict | None = None, quantize: str | None = None) -> str:
    """SavedModel / GraphDef / torch checkpoint -> the port's ``.npz`` and
    its manifest (``save_npz``), so serving never needs TensorFlow.

    ``options`` configures the family for the import — keys naming
    ModelConfig fields (e.g. num_classes, dtype, seq_buckets) set those
    fields; everything else lands in ModelConfig.options (e.g. BERT's
    vocab_file / layer sizes). The import must match the artifact.

    ``quantize="int8"`` writes the weight-only int8 tree (the reference's
    ``quantize_tree`` at the model's ``quantize_min_size``: a ``{"q8",
    "q8_scale"}`` sub-tree per quantized leaf, half the bytes); serve it
    with ``quantize = "int8"`` or ``"int8c"``. Returns the manifest's
    path."""
    import dataclasses

    from tpuserve_torch import quantize as qz
    from tpuserve_torch.config import ModelConfig
    from tpuserve_torch.models import build

    opts = dict(options or {})
    reserved = {"name", "family", "weights", "options"}
    bad = reserved & set(opts)
    if bad:
        raise ValueError(f"--opt cannot set {sorted(bad)}; use the dedicated "
                         "CLI flags instead")
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown --quantize mode {quantize!r}")
    settable = {f.name for f in dataclasses.fields(ModelConfig)} - reserved
    fields = {k: opts.pop(k) for k in list(opts) if k in settable}
    cfg = ModelConfig(name=family, family=family, options=opts, **fields)
    tree = import_tree(build(cfg), saved_model_path)
    if quantize == "int8":
        tree = qz.quantize_tree(tree, cfg.quantize_min_size)
    mpath = save_npz(out_path, tree)
    log.info("wrote the .npz checkpoint to %s", out_path)
    print(f"converted {saved_model_path} -> {out_path}"
          + (f" ({quantize}-quantized)" if quantize else ""))
    return mpath
