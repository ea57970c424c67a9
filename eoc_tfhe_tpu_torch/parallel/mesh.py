"""(dp, tp) meshes of ranks, sharded tensors and the collectives over them.

Port of ``eoc_tfhe_tpu/parallel/mesh.py`` onto ``torch.distributed``.  The
port runs one process (rank) per device, so a mesh is a layout of ranks,
not a list of devices: rank r sits at (r // tp, r % tp), which is the
reference's ``np.asarray(devices).reshape(dp, tp)``.  Each axis has its own
process groups, and ``shard_map``'s collectives over an axis name become the
calls of :class:`Mesh` on this rank's slice.

Axis semantics, as in the reference:
  dp — data parallel over the ciphertext batch;
  tp — tensor parallel over the key-switch table's contraction rows and the
       external product (TGSW rows or NTT frequencies).

A tensor placed with a ``NamedSharding`` in the reference is, on each rank,
a :class:`Sharded`: this rank's block, its spec and the whole shape.
Collectives on CUDA tensors go through the group's backend; gloo is given
a host copy of a CUDA tensor (explicitly, for that backend only), which is
how several ranks share one card, where NCCL refuses two ranks on one GPU.

Each collective that reaches the backend opens the span
``tfhe.mesh.<op> axis=<axis> bytes=<bytes>`` (``utils/profiling.span``) and
adds its bytes to :data:`collective_bytes`: the bytes of the operand this
rank hands to it (its whole tensor for psum, all_gather and all_to_all; the
source's tensor for broadcast).  A collective over one rank is the identity
and opens nothing.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..core.numeric import wrap32
from ..device import resolve_device
from ..utils.profiling import span

AXES = ("dp", "tp")

#: Bytes this process's collectives have been handed (see the module doc),
#: a process-wide count like ``ops.blind_rotate.launches``.
collective_bytes = 0


def local_rank(rank: int) -> int:
    """This process's index on its host: ``LOCAL_RANK``, else ``rank`` modulo
    ``LOCAL_WORLD_SIZE``, else ``rank``."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if "LOCAL_WORLD_SIZE" in os.environ:
        return rank % int(os.environ["LOCAL_WORLD_SIZE"])
    return rank


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """A rank's device: ``device`` where it names an index or the CPU, else
    ``cuda:{local_rank % device_count}``.  Never the CPU unless asked for; raises
    without a card (``device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, tp) layout of ranks, and its groups.

    A group is None where its axis has size 1 (or no process group is
    active): collectives over that axis are then the identity.
    """

    dp: int
    tp: int
    rank: int
    device: torch.device
    dp_group: object | None = None
    tp_group: object | None = None

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def coords(self) -> tuple[int, int]:
        return self.rank // self.tp, self.rank % self.tp

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return {"dp": self.dp_group, "tp": self.tp_group}[axis]

    # -- collectives over one axis, in the group's rank order ----------------

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return psum(x, self.group(axis), axis=axis)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        return all_gather(x, self.group(axis), dim, axis=axis)

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        return all_to_all(x, self.group(axis), split_dim, concat_dim, axis=axis)


def make_mesh(dp: int | None = None, tp: int = 1, device=None) -> Mesh:
    """Create a (dp, tp) mesh over the ranks of the process group (one rank
    without one).  Defaults: all ranks on dp, tp=1.  ``device`` is this
    rank's (see :func:`rank_device`).

    Every rank must call it, in the same order as its other group calls:
    ``new_group`` is collective.  Multi-host: ranks are host-major, so dp runs
    across hosts and tp inside one (:func:`~.distributed.make_hybrid_mesh`).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"mesh dp={dp} x tp={tp} != {world} ranks")
    groups = {}
    for axis, lines in (("dp", [[i * tp + j for i in range(dp)] for j in range(tp)]),
                        ("tp", [[i * tp + j for j in range(tp)] for i in range(dp)])):
        if len(lines[0]) == 1:
            continue
        for ranks in lines:        # every rank creates every group, in one order
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(dp=dp, tp=tp, rank=rank, device=rank_device(device, rank),
                dp_group=groups.get("dp"), tp_group=groups.get("tp"))


# ---------------------------------------------------------------------------
# Collectives on a process group (None: this rank alone).
# ---------------------------------------------------------------------------

def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _on_backend(group, x: torch.Tensor) -> torch.Tensor:
    """x as the group's backend takes it: a host copy of a CUDA tensor for gloo."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu().contiguous()
    return x.contiguous()


def _collective(op: str, axis: str, x: torch.Tensor):
    """The span of one collective on ``x``, its bytes counted."""
    global collective_bytes
    nbytes = x.numel() * x.element_size()
    collective_bytes += nbytes
    return span(f"tfhe.mesh.{op}", axis=axis, bytes=nbytes)


def psum(x: torch.Tensor, group, axis: str = "world") -> torch.Tensor:
    """Sum over the group.  int32 is summed exactly mod 2^32 (in int64, then
    wrapped), whatever the backend does with signed overflow; a float sum is
    the backend's, exact for integer values below 2^24 in float32.  ``axis``
    names the group in the span."""
    if _size(group) == 1:
        return x
    with _collective("psum", axis, x):
        y = _on_backend(group, x.to(torch.int64) if x.dtype == torch.int32 else x.clone())
        dist.all_reduce(y, group=group)          # in place: never on the caller's tensor
        y = y.to(x.device)
        return wrap32(y) if x.dtype == torch.int32 else y


def all_gather(x: torch.Tensor, group, dim: int = 0, axis: str = "world") -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (``all_gather(..., tiled=True)``)."""
    n = _size(group)
    if n == 1:
        return x
    with _collective("all_gather", axis, x):
        y = _on_backend(group, x)
        out = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(out, y, group=group)
        return torch.cat(out, dim=dim).to(x.device)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int,
               axis: str = "world") -> torch.Tensor:
    """``all_to_all(x, split_axis, concat_axis, tiled=True)``: chunk j of
    ``split_dim`` goes to group rank j, and the chunks received are
    concatenated along ``concat_dim`` in group-rank order."""
    n = _size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"axis {split_dim} of {tuple(x.shape)} does not split over {n} ranks")
    with _collective("all_to_all", axis, x):
        y = _on_backend(group, x.movedim(split_dim, 0))     # chunk j = rows of rank j
        out = torch.empty_like(y)
        dist.all_to_all_single(out, y, group=group)
        out = out.to(x.device).reshape((n, y.shape[0] // n) + tuple(y.shape[1:]))
        return torch.cat([blk.movedim(0, split_dim) for blk in out.unbind(0)], dim=concat_dim)


def broadcast(x: torch.Tensor, group=None, src: int = 0, axis: str = "world") -> torch.Tensor:
    """A copy of group rank ``src``'s ``x`` (same shape and dtype on every rank)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    with _collective("broadcast", axis, x):
        y = _on_backend(group, x.clone())
        dist.broadcast(y, src=dist.get_global_rank(group, src) if group is not None else src,
                       group=group)
        return y.to(x.device)


# ---------------------------------------------------------------------------
# Sharded tensors.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharded:
    """This rank's block of a tensor cut over mesh axes: the port's form of a
    ``jax.Array`` placed with a ``NamedSharding``.

    ``spec[d]`` is None or a tuple of mesh axis names that cut dimension d
    (the reference's ``PartitionSpec``, each entry as a tuple); ``shape`` is
    the whole tensor's.
    """

    local: torch.Tensor
    spec: tuple
    shape: tuple


def _spec_entry(spec: tuple, d: int) -> tuple:
    e = spec[d] if d < len(spec) else None
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def block_index(spec: tuple, d: int, mesh: Mesh) -> tuple[int, int]:
    """(parts, this rank's block) of dimension d: the named axes' sizes
    multiplied, the index row-major over them (as JAX lays a tuple entry)."""
    parts, idx = 1, 0
    for axis in _spec_entry(spec, d):
        parts, idx = parts * mesh.size(axis), idx * mesh.size(axis) + mesh.index(axis)
    return parts, idx


def shard(x: torch.Tensor, spec: tuple, mesh: Mesh) -> Sharded:
    """This rank's block of the whole tensor ``x`` under ``spec`` (entries past
    its end replicate their dimension), on the mesh's device."""
    spec = tuple(_spec_entry(spec, d) or None for d in range(len(spec)))
    local = x
    for d in range(x.dim()):
        parts, idx = block_index(spec, d, mesh)
        if x.shape[d] % parts:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not split into "
                             f"{parts} parts (spec {spec})")
        blk = x.shape[d] // parts
        local = local.narrow(d, idx * blk, blk)
    return Sharded(local=local.to(mesh.device).contiguous(), spec=spec, shape=tuple(x.shape))


def batch_slice(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's dp slice of ``x`` along ``dim``, on the mesh's device."""
    spec = (None,) * dim + (("dp",),)
    return shard(x, spec, mesh).local


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists, tuples and dataclasses
    (other values are kept as they are)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_lwe_batch(ct, mesh: Mesh):
    """This rank's dp slice of a batched ciphertext (or any tree of tensors
    with the batch first), on the mesh's device."""
    return _tree_map(lambda x: batch_slice(x, mesh), ct)


def replicate(tree, mesh: Mesh):
    """Key material made equal on every rank: each tensor broadcast from rank
    0 to the mesh's device (every rank passes tensors of the same shapes)."""
    return _tree_map(lambda x: broadcast(x.to(mesh.device)), tree)
