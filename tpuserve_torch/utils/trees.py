"""Parameter-tree helpers, ported from ``tpuserve/utils/trees.py``.

A tree is a nested dict (the reference's flax tree of numpy arrays) or a
flat one (a PyTorch state_dict); leaves are numpy arrays or tensors.
Leaves are visited in the JAX package's order — dict keys sorted — and
named with its ``jax.tree_util.keystr`` spelling (``['w2']``,
``['params']['layer0']['attn']['query']['kernel']``), so both packages
name the same leaf alike.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch


def flatten_with_paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in the JAX package's order: dict keys
    sorted, list and tuple entries by index; None is an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten_with_paths(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from flatten_with_paths(sub, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _numel_and_bytes(leaf: Any) -> tuple[int, int]:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel(), leaf.numel() * leaf.element_size()
    a = np.asarray(leaf)
    return a.size, a.nbytes


def tree_summary(tree: Any) -> dict:
    """``{"leaves", "bytes", "params"}`` of a tree, as the JAX package's."""
    sizes = [_numel_and_bytes(leaf) for _, leaf in flatten_with_paths(tree)]
    return {"leaves": len(sizes), "bytes": sum(b for _, b in sizes),
            "params": sum(n for n, _ in sizes)}


def _finite(leaf: Any) -> bool | None:
    """Whether a float leaf holds only finite values; None for a leaf that
    is not floating point. bfloat16 arrays (numpy kind 'V') are widened to
    float32 for the scan, as the reference does."""
    if isinstance(leaf, torch.Tensor):
        return bool(torch.isfinite(leaf).all()) if leaf.is_floating_point() else None
    a = np.asarray(leaf)
    if a.dtype.kind not in "fV":
        return None
    if a.dtype.kind == "V":
        try:
            a = a.astype(np.float32)
        except (TypeError, ValueError):
            return None  # a genuinely structured dtype: nothing to scan
    return bool(np.isfinite(a).all())


def nonfinite_paths(tree: Any, limit: int = 8) -> list[str]:
    """Paths of float leaves holding any NaN/Inf (the first ``limit``).

    The lifecycle's reload gate scans candidate weight trees with this: a
    poisoned checkpoint (NaN from a diverged fine-tune, Inf from a bf16
    overflow) is rejected before it can serve."""
    bad: list[str] = []
    for path, leaf in flatten_with_paths(tree):
        if _finite(leaf) is False:
            bad.append(path)
            if len(bad) >= limit:
                break
    return bad
