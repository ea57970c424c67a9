"""Sharded native key checkpoint format (pod-scale bootstrapping keys).

Port of ``eoc_tfhe_tpu/io/native_keys.py``, the same files on disk, so that a
directory written by either package loads in the other:

    <dir>/MANIFEST.json          — schema, per-tensor dtype/shape/spec
    <dir>/t<i>.shard<k>.bin      — raw little-endian bytes of shard k

A tree is dicts (keys sorted), lists and tuples (in order) of tensors and
:class:`~..parallel.mesh.Sharded` blocks; leaf i is ``t<i>``, in JAX's
flatten order.  Shards are cut along each tensor's sharded axes
(``_shard_grid``, row-major over the dimensions); replicated tensors write
one shard.  Each rank writes only the shards it holds (one rank of those
holding the same block), rank 0 writes the manifest, and a load reads only
the shard of this rank's block.  The manifest's ``"treedef"`` string is
informational: this package writes its own and never parses it.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..parallel.mesh import Mesh, Sharded, block_index

_SCHEMA = "eoc-tfhe-tpu/native-keys/v1"


def _leaves(tree) -> list:
    """Leaves in JAX's flatten order (dict keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, Sharded)):
        return [tree]
    raise TypeError(f"native_keys stores tensors in dicts, lists and tuples, not "
                    f"{type(tree).__name__}")


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "None" if tree is None else "*"


def _shard_grid(shape, spec, mesh: Mesh):
    """Yield (shard_index, tuple_of_slices) covering the array."""
    dims = []
    for d, size in enumerate(shape):
        parts = block_index(spec, d, mesh)[0]
        if size % parts:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split into "
                             f"{parts} parts (spec {spec})")
        dims.append((parts, size // parts))
    for k in range(math.prod(p for p, _ in dims)):
        idx, rem = [], k
        for parts, _ in reversed(dims):
            idx.append(rem % parts)
            rem //= parts
        yield k, tuple(slice(i * blk, (i + 1) * blk)
                       for i, (_, blk) in zip(reversed(idx), dims))


def _my_shard(shape, spec, mesh: Mesh) -> int:
    """Index of the shard that holds this rank's block."""
    k = 0
    for d in range(len(shape)):
        parts, idx = block_index(spec, d, mesh)
        k = k * parts + idx
    return k


def _writes(spec, mesh: Mesh | None) -> bool:
    """Whether this rank writes its block: the first of the ranks that hold
    it (index 0 on every mesh axis the spec does not name)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    if mesh is None:
        return rank == 0
    named = {a for e in spec if e for a in e}
    return all(mesh.index(a) == 0 for a in mesh.axis_names if a not in named)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().contiguous().numpy()


def save_pytree(path: str, tree, mesh: Mesh | None = None) -> dict:
    """Write a tree of tensors and sharded blocks; returns the manifest.
    Every rank of the mesh calls it; it returns when all files are written."""
    os.makedirs(path, exist_ok=True)
    manifest = {"schema": _SCHEMA, "treedef": _treedef(tree), "tensors": {}}
    for i, leaf in enumerate(_leaves(tree)):
        spec = leaf.spec if isinstance(leaf, Sharded) and mesh is not None else ()
        local = leaf.local if isinstance(leaf, Sharded) else leaf
        shape = tuple(leaf.shape) if isinstance(leaf, Sharded) else tuple(local.shape)
        if isinstance(leaf, Sharded) and mesh is None and tuple(local.shape) != shape:
            raise ValueError(f"tensor t{i} is a block of {shape}; pass its mesh")
        host = _np(local)
        entry = {"dtype": str(host.dtype), "shape": list(shape),
                 "spec": [list(e) if e else None for e in spec] or None, "shards": 1}
        if spec:
            entry["shards"] = sum(1 for _ in _shard_grid(shape, spec, mesh))
            k = _my_shard(shape, spec, mesh)
        else:
            k = 0
        if _writes(spec, mesh):
            with open(os.path.join(path, f"t{i}.shard{k}.bin"), "wb") as f:
                f.write(host.astype(host.dtype.newbyteorder("<"), copy=False).tobytes())
        manifest["tensors"][f"t{i}"] = entry
    if _writes((), None):
        with open(os.path.join(path, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    if dist.is_initialized():
        dist.barrier()
    return manifest


def load_pytree(path: str, tree_like, mesh: Mesh | None = None, device=None):
    """Load tensors saved by :func:`save_pytree` into the structure of
    ``tree_like`` (leaf values ignored).  A tensor saved with a spec comes
    back, with a mesh, as this rank's :class:`Sharded` block, read from its
    one shard file; others come back whole.  Tensors go to the mesh's device,
    else ``device`` (the card unless named)."""
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if manifest["schema"] != _SCHEMA:
        raise ValueError(f"not a native key directory: schema {manifest.get('schema')!r}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    out = []
    for i, _ in enumerate(_leaves(tree_like)):
        e = manifest["tensors"][f"t{i}"]
        shape = tuple(e["shape"])
        dtype = np.dtype(e["dtype"]).newbyteorder("<")
        spec = tuple(tuple(x) if x else None for x in (e["spec"] or []))
        if e["shards"] > 1 and (mesh is None or not spec):
            # a multi-shard tensor cannot be read as shard0 alone: that gives
            # 1/shards of the elements and a reshape error far from the cause
            raise ValueError(f"tensor t{i} was saved as {e['shards']} shards; pass the "
                             f"mesh it was sharded over to load_pytree")

        def read(k, blk, _i=i, _dtype=dtype):
            data = np.fromfile(os.path.join(path, f"t{_i}.shard{k}.bin"), dtype=_dtype)
            return torch.from_numpy(data.astype(_dtype.newbyteorder("="))).reshape(blk).to(dev)

        if mesh is None or not any(spec):
            out.append(read(0, shape))
            continue
        grid = dict(_shard_grid(shape, spec, mesh))
        if len(grid) != e["shards"]:
            raise ValueError(f"mesh mismatch for tensor t{i}: manifest has {e['shards']} "
                             f"shards, current mesh would read {len(grid)}")
        k = _my_shard(shape, spec, mesh)
        blk = tuple(s.stop - s.start for s in grid[k])
        out.append(Sharded(local=read(k, blk), spec=spec, shape=shape))
    return _unflatten(tree_like, iter(out))
