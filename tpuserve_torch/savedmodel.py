"""Model weights on disk and their integrity layer, ported from
``tpuserve/savedmodel.py``.

The JAX package's native checkpoint is an orbax directory; the port reads
the same parameter tree — the reference's float32 flax tree — from a
``.npz`` instead: one member per leaf, named by its ``keystr`` path
(``['params']['embed']['embedding']``). Orbax, TensorFlow and safetensors
are not dependencies of the port, and a ``.npz`` needs nothing beyond
numpy. ``save_npz`` writes one (and its manifest), ``load_npz`` reads it
back into the nested tree; each family's ``from_jax_params`` turns the tree
into the module's state_dict and ``to_jax_params`` back.

The sidecar checksum manifest is the JAX package's, byte for byte:
``<checkpoint>.manifest.json`` beside the file, holding per leaf the
sha256 over ``str(dtype)``, ``repr(shape)`` and the raw bytes. A manifest
written by either package over the same tree verifies in the other. A
reload recomputes the digests over the tree as read and rejects the
candidate on any mismatch (bit rot, a truncated copy, a writer racing the
reload) before it can serve.
"""

from __future__ import annotations

import ast
import hashlib
import json
import logging
import os
import re
from typing import Any

import numpy as np

from tpuserve_torch.utils.trees import flatten_with_paths

log = logging.getLogger("tpuserve_torch.savedmodel")

MANIFEST_ALGO = "sha256"


class IntegrityError(ValueError):
    """A checkpoint failed its sidecar checksum manifest: the reload path
    rejects the candidate and the old version keeps serving."""


def detect_format(path: str) -> str:
    """``"npz"`` for the port's checkpoint. The JAX package's other forms
    (an orbax or TF SavedModel directory, a GraphDef ``.pb``, a torch
    checkpoint) raise NotImplementedError; anything else ValueError."""
    if path.endswith(".npz") and not os.path.isdir(path):
        return "npz"
    if os.path.isdir(path):
        kind = ("a TF SavedModel" if os.path.exists(os.path.join(path, "saved_model.pb"))
                else "an orbax checkpoint")
    elif path.endswith(".pb"):
        kind = "a GraphDef"
    elif path.endswith((".safetensors", ".ckpt", ".pt", ".pth", ".bin")):
        kind = "a torch checkpoint"
    else:
        raise ValueError(f"cannot identify weight format of {path!r}")
    raise NotImplementedError(
        f"{path!r} is {kind}: tpuserve_torch reads the .npz form of the "
        "reference's parameter tree (tpuserve_torch.savedmodel.save_npz)")


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
