"""Regex partition rules -> per-rank parameter trees, ported from
``tpuserve/parallel/partition.py``.

A model family publishes an ordered list of ``(regex, PartitionSpec)``
rules; each leaf's '/'-joined path in the reference's parameter tree is
matched against them in order and the first hit wins. Scalars and size-1
leaves are never partitioned; without a catch-all rule (``(".*", P())``) an
unmatched leaf raises.

Where the reference hands the specs to XLA as shardings, the port is
single-controller: ``shard_pytree`` splits each leaf along its spec's axes
into one block per mesh rank and puts it on that rank's device.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np
import torch


class PartitionSpec(tuple):
    """One mesh axis name (or None) per leading dim of a leaf, as
    ``jax.sharding.PartitionSpec``: ``P(None, "model")`` splits dim 1 over
    the model axis; dims past the spec's length are not split."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# A catch-all: replicate everything (the default for data-parallel serving).
REPLICATED_RULES: list[tuple[str, PartitionSpec]] = [(".*", P())]


def _is_leaf(x: Any) -> bool:
    return not isinstance(x, dict)


def named_leaves(tree: Any, sep: str = "/",
                 is_leaf: Callable[[Any], bool] | None = None) -> list[tuple[str, Any]]:
    """Flatten a nested-dict tree into (path, leaf) pairs with readable '/'
    paths, in the reference's (sorted-key) order. ``is_leaf`` marks dicts to
    keep whole (a quantized ``{"q8", "q8_scale"}`` sub-tree)."""
    out: list[tuple[str, Any]] = []

    def walk(prefix: str, node: Any) -> None:
        if _is_leaf(node) or (is_leaf is not None and is_leaf(node)):
            out.append((prefix, node))
            return
        for k in sorted(node):
            walk(f"{prefix}{sep}{k}" if prefix else str(k), node[k])

    walk("", tree)
    return out


def tree_map_with_name(fn: Callable[[str, Any], Any], tree: Any, sep: str = "/",
                       is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn(path, leaf)`` over every leaf, the tree's structure kept."""
    def walk(prefix: str, node: Any) -> Any:
        if _is_leaf(node) or (is_leaf is not None and is_leaf(node)):
            return fn(prefix, node)
        return {k: walk(f"{prefix}{sep}{k}" if prefix else str(k), v)
                for k, v in node.items()}

    return walk("", tree)


def spec_for_name(rules: list[tuple[str, PartitionSpec]], name: str,
                  shape: tuple) -> PartitionSpec:
    """First rule whose regex matches ``name`` wins; scalars/size-1 replicate."""
    if len(shape) == 0 or int(np.prod(shape)) == 1:
        return P()
    for rule, spec in rules:
        if re.search(rule, name) is not None:
            return spec
    raise ValueError(f"no partition rule matched param {name!r}")


def match_partition_rules(rules: list[tuple[str, PartitionSpec]], params: Any) -> Any:
    """A tree of PartitionSpec following ordered regex rules."""
    return tree_map_with_name(
        lambda name, leaf: spec_for_name(rules, name, tuple(np.shape(leaf))), params)


def rank_coords(mesh) -> list[dict[str, int]]:
    """Each rank's coordinate on every axis, in the mesh's flat rank order."""
    return [dict(zip(mesh.axis_names, idx)) for idx in np.ndindex(*mesh.devices.shape)]


def split_leaf(leaf: Any, spec: PartitionSpec, mesh_shape: dict[str, int],
               coord: dict[str, int]) -> Any:
    """The block of ``leaf`` that the rank at ``coord`` holds under ``spec``:
    each dim named in the spec split over its axis into contiguous blocks,
    the first ``size % n`` one longer (``np.array_split``'s blocks; even
    where the axis divides the dim)."""
    index = []
    for dim, axis in enumerate(spec):
        n = mesh_shape.get(axis, 1) if axis is not None else 1
        if n == 1:
            index.append(slice(None))
            continue
        size, r = np.shape(leaf)[dim], coord[axis]
        base, extra = divmod(size, n)
        start = r * base + min(r, extra)
        index.append(slice(start, start + base + (r < extra)))
    return leaf[tuple(index)]


def split_tree(params: Any, specs: Any, mesh) -> list[Any]:
    """``params`` split by a matching tree of specs: one tree per mesh rank
    (flat rank order), each leaf that rank's block, on the host."""
    flat = named_leaves(params)
    spec_of = dict(named_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec)))
    out = []
    for coord in rank_coords(mesh):
        blocks = {name: split_leaf(leaf, spec_of[name], mesh.shape, coord)
                  for name, leaf in flat}
        out.append(tree_map_with_name(lambda name, _leaf: blocks[name], params))
    return out


def shard_pytree(params: Any, rules: list[tuple[str, PartitionSpec]], mesh) -> list[Any]:
    """Split every leaf by its rule-derived spec: one tree per mesh rank
    (flat rank order), each leaf a tensor on that rank's device."""
    specs = match_partition_rules(rules, params)
    return [tree_map_with_name(lambda _n, leaf, dev=dev: torch.as_tensor(
                np.ascontiguousarray(leaf)).to(dev), tree)
            for tree, dev in zip(split_tree(params, specs, mesh), mesh.devices.flat)]
