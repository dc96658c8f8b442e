"""Placement rules: name-based parameter specs and their DTensor placements.

The JAX package's rules (``repro.dist.sharding``), carried over for the
reshard pass. Meshes carry a ``model`` axis (tensor parallelism) plus one
or more batch-parallel axes (``data``, optionally a leading ``pod``). Every
weight matrix follows the Megatron pattern: input-side projections are
column-parallel (``(..., D, F)`` placed ``("data", "model")``: FSDP over
the reduction dim, tensor-parallel over the output dim), output-side
projections are row-parallel (``(..., F, D)`` placed ``("model",
"data")``), embeddings are vocab-parallel, and norms, biases and SSM
scalars stay replicated.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh dim name, or a tuple of names (the dim split over several mesh dims,
the first the major one), with trailing ``None``s trimmed, as
``PartitionSpec`` prints. The rules read only a mesh's shape and dim names
(``mesh.shape`` and ``mesh.mesh_dim_names``), so they work on a
``DeviceMesh`` or on anything that carries the two. :func:`placements`
turns a spec into DTensor placements, one per mesh dim.

The module also holds the one definition of the survivors' mesh
(:func:`survivor_grid`) and of placing a leaf on it (:func:`place`), which
the torch data plane's reshard and ``core.mesh_manager.MeshManager`` both
call, and the two reads of a placed leaf that the trainer's step over
ranks makes: :func:`assemble` (the whole tensor, over a given group) and
:func:`local_block` (where this rank's block sits in it).

:func:`batch_specs` and :func:`cache_specs` place a step's batch and
decode cache. The activation helpers (:func:`shard_activations`,
:func:`shard_heads`, :func:`gather_fsdp`) are what the models call where
the reference calls ``with_sharding_constraint``: inside a mesh made
current by ``dist.compat.use_mesh`` they redistribute a DTensor to the
spec's placements (DTensor emits the collective, as GSPMD does for a
constraint). They return their argument itself when no mesh is current,
when ``mode == "none"`` or when it is not a DTensor, so the one-card serve
and train paths run exactly as before; that check comes first and costs a
context-variable read.
"""
from __future__ import annotations

import math
import sys
import warnings
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.dist.compat import _CURRENT

PyTree = Any
Spec = tuple

# Megatron-style classification by leaf name (see module docstring).
_IN_MATS = frozenset({"wq", "wk", "wv", "w_in", "w_gate", "in_proj",
                      "we_in", "we_gate"})
_OUT_MATS = frozenset({"wo", "w_out", "out_proj", "we_out"})
_EMBEDS = frozenset({"embed", "unembed"})

# (param, dim, mesh axes) triples already warned about, as in the JAX
# package: replication is silent after the first occurrence so sweeps over
# many layers of the same shape do not flood the log
_replication_warned: set[tuple] = set()


def mesh_sizes(mesh) -> dict[str, int]:
    """Mesh dim name -> size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_product(sizes: dict[str, int], entry) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes[a] for a in axes)


def sanitize_spec(spec: Spec, shape: tuple[int, ...], mesh,
                  *, param: str | None = None) -> Spec:
    """Drop spec axes whose dim is not divisible by the mesh axes' product
    (a shard must be whole); trim trailing Nones.

    Each dropped axis is reported once per (param, dim, axes) via
    ``warnings.warn``: a silently replicated weight is a real capacity
    surprise and should be visible the first time it happens.
    """
    sizes = mesh_sizes(mesh)
    out: list = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        prod = _axis_product(sizes, entry)
        if shape[i] % prod == 0:
            out.append(entry)
        else:
            key = (param, i, entry)
            if key not in _replication_warned:
                _replication_warned.add(key)
                warnings.warn(
                    f"sanitize_spec: dim {i} of {param or 'array'} "
                    f"(size {shape[i]}) does not divide mesh axes "
                    f"{entry!r} (product {prod}); replicating that "
                    f"dimension instead of sharding it",
                    UserWarning, stacklevel=2)
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _param_rule(name: str, ndim: int) -> Spec:
    if name in _IN_MATS and ndim >= 2:
        return (None,) * (ndim - 2) + ("data", "model")
    if name in _OUT_MATS and ndim >= 2:
        return (None,) * (ndim - 2) + ("model", "data")
    if name in _EMBEDS:
        return ("model",)
    if name == "conv_w" and ndim >= 1:
        return (None,) * (ndim - 1) + ("model",)
    return ()


def tree_map_with_path(fn, tree: PyTree, path: tuple = ()) -> PyTree:
    """``fn(path, leaf)`` over nested dicts, lists and tuples; ``path`` holds
    the dict keys and sequence indices from the root, as strings."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_spec(path: tuple, shape: tuple[int, ...], mesh) -> Spec:
    """The spec of the leaf at ``path`` (keys from the root): its name's
    rule, sanitized against the mesh under its dotted path."""
    spec = _param_rule(path[-1] if path else "", len(shape))
    return sanitize_spec(spec, tuple(shape), mesh, param=".".join(path))


def param_specs(cfg, params: PyTree, mesh) -> PyTree:
    """Spec tree for a parameter (or optimizer-moment) tree."""
    del cfg  # rules are name-based; cfg kept for signature stability
    return tree_map_with_path(lambda path, leaf: leaf_spec(path, leaf.shape, mesh), params)


def current_mesh():
    """The mesh ``dist.compat.use_mesh`` made current, or None."""
    return _CURRENT.get()


def _batch_dim_axes(mesh, global_batch: int):
    """Mesh axes the batch dimension shards over: all non-model axes if the
    batch divides their product, dropping the leading (pod) axis first;
    None (replicated) when nothing divides."""
    names = [n for n in mesh.mesh_dim_names if n != "model"]
    sizes = mesh_sizes(mesh)
    while names:
        prod = math.prod(sizes[n] for n in names)
        if global_batch % prod == 0:
            return tuple(names) if len(names) > 1 else names[0]
        names.pop(0)
    return None


def batch_specs(cfg, mesh, batch: PyTree, global_batch: int) -> PyTree:
    """Batch arrays shard dim 0 over the non-model axes, rest replicated
    (the reference's spec, trailing Nones kept)."""
    del cfg
    b = _batch_dim_axes(mesh, global_batch)

    def spec_of(path, leaf):
        nd = len(leaf.shape)
        return () if nd == 0 else (b,) + (None,) * (nd - 1)

    return tree_map_with_path(spec_of, batch)


def cache_specs(cfg, mesh, cache: PyTree, global_batch: int) -> PyTree:
    """Decode-cache specs: (L, B, ...) leaves shard batch on dim 1; the KV
    head dim (3) is tensor-parallel. A leaf of fewer than two dims (the
    position, a host int in the port) is replicated."""
    del cfg
    b = _batch_dim_axes(mesh, global_batch)

    def spec_of(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        if nd < 2:
            return ()
        if path[-1] in ("k", "v") and nd == 5:
            spec = (None, b, None, "model", None)
        else:
            spec = (None, b) + (None,) * (nd - 2)
        return sanitize_spec(spec, shape, mesh, param=".".join(path))

    return tree_map_with_path(spec_of, cache)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``. ``placements``
    are its DTensor placements."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` for the tensor dim whose entry names it, else
    ``Replicate()``. A tensor dim split over several mesh dims is sharded by
    each of them, the first named the major one (DTensor's default order)."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for axis in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            if axis in by_axis:
                raise ValueError(f"spec {spec!r} names mesh dim {axis!r} twice")
            by_axis[axis] = d
    names = tuple(mesh.mesh_dim_names)
    unknown = set(by_axis) - set(names)
    if unknown:
        raise ValueError(f"spec {spec!r} names {sorted(unknown)}, not dims of mesh {names}")
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate() for a in names)


def survivor_grid(survivors, node_ranks: Callable[[int], list[int]]) -> list[list[int]]:
    """The rank grid ``(data, model)`` of the survivors' mesh: the row of
    ranks ``node_ranks(n)`` of each surviving node, deduplicated (nodes share
    a row under the wrap-around mapping) and sorted (docs/dataplane.md,
    "Fault-driven resharding", step 1). Rows that overlap without being
    equal form no mesh and raise."""
    rows = sorted({tuple(node_ranks(n)) for n in survivors})
    flat = [r for row in rows for r in row]
    if len(set(flat)) != len(flat):
        raise ValueError(f"the survivors' rank rows {rows} overlap: no mesh over them")
    return [list(row) for row in rows]


def sum_bytes(buf: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce ``buf`` in place over ``group`` (the world group by
    default), summed as bytes. Where each element was written by one rank
    into a buffer the others left zero, every rank receives it bit for bit:
    a byte plus zeros never carries. Works on every backend and device
    (gloo has no all_gather for CUDA tensors, but an all_reduce)."""
    dist.all_reduce(buf.view(-1).view(torch.uint8), group=group)
    return buf


def local_block(leaf) -> tuple | None:
    """The index, in the whole tensor, of the block of DTensor ``leaf`` that
    this rank holds (``leaf.to_local()``), or None outside the leaf's mesh.
    A replicated mesh dim leaves the index unchanged: every rank along it
    holds the same block. Shards are even: the placements come from
    sanitized specs."""
    from torch.distributed.tensor import Shard

    coord = leaf.device_mesh.get_coordinate()
    if coord is None:
        return None
    sizes = tuple(leaf.device_mesh.shape)
    index = [0] * leaf.ndim
    count = [1] * leaf.ndim
    for m, p in enumerate(leaf.placements):
        if isinstance(p, Shard):
            index[p.dim] = index[p.dim] * sizes[m] + coord[m]
            count[p.dim] *= sizes[m]
    block = []
    for d in range(leaf.ndim):
        chunk = leaf.shape[d] // count[d]
        block.append(slice(index[d] * chunk, (index[d] + 1) * chunk))
    return tuple(block)


def _writes(leaf) -> bool:
    """Whether this rank writes its block of DTensor ``leaf`` when it is
    assembled: it is in the mesh, at coordinate 0 on every replicated mesh
    dim, so each element has exactly one writer."""
    from torch.distributed.tensor import Shard

    coord = leaf.device_mesh.get_coordinate()
    return coord is not None and all(
        isinstance(p, Shard) or c == 0 for p, c in zip(leaf.placements, coord))


def assemble(leaf: torch.Tensor, group=None) -> torch.Tensor:
    """``leaf`` as one whole tensor on this rank. A plain tensor is already
    whole. For a DTensor every rank of ``group`` (the world group by
    default; it must hold every rank of the leaf's mesh) calls it together:
    the one rank that writes each element (:func:`local_block`, coordinate 0
    on every replicated mesh dim) puts it into a zeroed buffer, and
    :func:`sum_bytes` carries it to all."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return leaf.detach()
    local = leaf.to_local()
    buf = torch.zeros(leaf.shape, dtype=leaf.dtype, device=local.device)
    if _writes(leaf):
        block = local_block(leaf)
        if buf[block].shape != local.shape:
            raise ValueError(f"uneven shard {tuple(local.shape)} of {tuple(leaf.shape)}")
        buf[block] = local
    return sum_bytes(buf, group)


def place(leaf: torch.Tensor, mesh, spec: Spec):
    """``leaf`` placed on ``mesh`` by ``spec``, as a DTensor. Every rank
    holds the leaf whole (a DTensor of an earlier placement is assembled
    first), so ``distribute_tensor(..., src_data_rank=None)`` only slices:
    no scatter. A shard that is a view of the whole is copied, so the
    whole is not kept alive by it."""
    from torch.distributed.tensor import distribute_tensor

    whole = assemble(leaf)
    where = placements(spec, mesh)
    placed = distribute_tensor(whole, mesh, where, src_data_rank=None)
    local = placed.to_local()
    if local.numel() < whole.numel() and \
            local.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr():
        placed = type(placed).from_local(local.clone(), mesh, where, run_check=False,
                                         shape=whole.shape, stride=whole.stride())
    return placed


# ---------------------------------------------------------------------------
# in-model constraints (identity off a mesh, on plain tensors, or mode none)
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor's module: the
    models call this on every layer of a host-bound decode, and where the
    module was never imported no DTensor exists."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _block_offset(size: int, mesh, m: int) -> int:
    """Where this rank's block of a dim of ``size`` split over mesh dim
    ``m`` starts: DTensor cuts a dim into ceil-sized chunks (the last ones
    shorter or empty when the mesh dim does not divide it)."""
    return min(mesh.get_coordinate()[m] * -(-size // mesh.size(m)), size)


def _constrain(x, spec: Spec, mesh):
    return x.redistribute(mesh, placements(sanitize_spec(spec, tuple(x.shape), mesh), mesh))


def shard_activations(x, mode: str = "batch"):
    """Constrain an activation: dim 0 batch-parallel; under ``batch_seq``
    (sequence parallelism) dim 1 additionally shards over ``model``."""
    mesh = _CURRENT.get()
    if mesh is None or mode == "none" or not _is_dtensor(x):
        return x
    b = _batch_dim_axes(mesh, x.shape[0])
    seq = "model" if (mode == "batch_seq" and x.ndim >= 3) else None
    return _constrain(x, (b, seq) + (None,) * (x.ndim - 2), mesh)


def shard_heads(x, mode: str = "batch", head_axis: int = 2):
    """Constrain a heads-major (or FFN-intermediate) tensor: dim 0
    batch-parallel, ``head_axis`` tensor-parallel over ``model``."""
    mesh = _CURRENT.get()
    if mesh is None or mode == "none" or not _is_dtensor(x):
        return x
    spec: list = [None] * x.ndim
    spec[0] = _batch_dim_axes(mesh, x.shape[0])
    spec[head_axis] = "model"
    return _constrain(x, tuple(spec), mesh)


def replicated_like(x, like):
    """Plain tensor ``x`` as a DTensor replicated on ``like``'s mesh when
    ``like`` is a DTensor; ``x`` itself otherwise."""
    if not _is_dtensor(like) or _is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def split_last(x, *sizes: int):
    """``x`` with its last dim split into ``sizes`` (a reshape). A DTensor
    whose last dim is split over mesh dims that do not divide ``sizes[0]``
    is first gathered along it: DTensor cannot place that view, where GSPMD
    reshards it implicitly."""
    if _is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = [m for m, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1]
        if last and sizes[0] % math.prod(x.device_mesh.size(m) for m in last):
            x = x.redistribute(x.device_mesh, [Replicate() if m in last else p
                                               for m, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:-1], *sizes)


class _MergeLast(torch.autograd.Function):
    """A DTensor's last two dims merged; the gradient is split back with
    :func:`split_last`, which gathers it when its shard cannot be split."""

    @staticmethod
    def forward(ctx, x):
        ctx.sizes = tuple(x.shape[-2:])
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, grad):
        return split_last(grad, *ctx.sizes)


def merge_last(x):
    """``x`` (..., a, b) as (..., a * b), a reshape; on a DTensor its
    backward goes through :func:`split_last`."""
    if not _is_dtensor(x):
        return x.reshape(*x.shape[:-2], -1)
    return _MergeLast.apply(x)


def shard_gqa(q, k, v, mode: str = "batch"):
    """Constrain grouped attention's operands alike: dim 0 batch-parallel,
    the head dim (2) over ``model`` when both the query heads and the KV
    heads divide it (so each device's query heads read its own KV heads),
    else replicated."""
    mesh = _CURRENT.get()
    if mesh is None or mode == "none" or not _is_dtensor(q):
        return q, k, v
    model = mesh_sizes(mesh).get("model", 1)
    heads = "model" if q.shape[2] % model == 0 and k.shape[2] % model == 0 else None
    b = _batch_dim_axes(mesh, q.shape[0])
    return tuple(_constrain(t, (b, None, heads, None), mesh) for t in (q, k, v))


def gather_fsdp(tree: PyTree, mode: str = "batch") -> PyTree:
    """Re-place each DTensor leaf of a weight tree by its rule with the
    FSDP (``data``) axis removed: DTensor all-gathers it; tensor-parallel
    (``model``) axes stay. Plain leaves are left as they are."""
    mesh = _CURRENT.get()
    if mesh is None or mode == "none":
        return tree

    def gather(path, leaf):
        if not _is_dtensor(leaf):
            return leaf
        rule = _param_rule(path[-1] if path else "", leaf.ndim)
        return _constrain(leaf, tuple(None if e == "data" else e for e in rule), mesh)

    return tree_map_with_path(gather, tree)


def per_shard(fn, tensors: tuple, outs: tuple = (None,), **kwargs):
    """``fn(*tensors, **kwargs)`` run block by block, for a computation that
    is independent along every sharded dim (the batch and head dims of
    attention and of the SSD scan, pinned there by :func:`shard_heads`).

    On plain tensors it is that call. On DTensors each device runs ``fn`` on
    its own blocks (``local_map``): the einsums inside never see a batch dim
    and a head dim sharded over different mesh dims merged into one, which
    DTensor can only express as a strided shard. ``outs`` has one entry per
    output of ``fn``: None to place it as the first input, or a mapping
    ``{input dim: output dim}`` for a shard that sits at another dim."""
    first = tensors[0]
    if not _is_dtensor(first):
        return fn(*tensors, **kwargs)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    base = list(first.placements)

    def moved(dims):
        if dims is None:
            return base
        return [Shard(dims[p.dim]) if isinstance(p, Shard) else p for p in base]

    out_pl = tuple(moved(d) for d in outs)
    run = local_map(lambda *xs: fn(*xs, **kwargs),
                    out_placements=out_pl[0] if len(out_pl) == 1 else out_pl,
                    in_placements=tuple(list(t.placements) if _is_dtensor(t) else None
                                        for t in tensors),
                    device_mesh=first.device_mesh)
    return run(*tensors)


def _last_dim_split(x):
    """(mesh dim, offset of this rank's block) of a DTensor whose last dim
    is split over one mesh dim, or None when that dim is whole."""
    from torch.distributed.tensor import Shard

    dims = [m for m, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1]
    if not dims:
        return None
    if len(dims) > 1:
        raise NotImplementedError(f"last dim split over mesh dims {dims}")
    m = dims[0]
    return m, _block_offset(x.shape[-1], x.device_mesh, m)


def _without(x, m: int, replace) -> list:
    return [replace if k == m else p for k, p in enumerate(x.placements)]


def take_last(x, idx):
    """``x[..., idx]`` row by row: ``torch.gather(x, -1, idx[..., None])``.
    On a DTensor split on its last dim (vocab-parallel logits) each device
    reads the indices that fall in its block, zero elsewhere, and the result
    is a partial sum over that mesh dim; DTensor's own rule for it needs the
    data and does not run on stand-ins."""
    split = _last_dim_split(x) if _is_dtensor(x) else None
    if split is None:
        return torch.gather(x, -1, idx[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    m, off = split

    def local(xl, il):
        w = xl.shape[-1]
        j = il.long() - off
        t = torch.gather(xl, -1, j.clamp(0, w - 1)[..., None])[..., 0]
        return torch.where((j >= 0) & (j < w), t, torch.zeros((), dtype=t.dtype, device=t.device))

    run = local_map(local, out_placements=_without(x, m, Partial()),
                    in_placements=(list(x.placements), _without(x, m, Replicate())),
                    device_mesh=x.device_mesh, redistribute_inputs=True)
    return run(x, idx)


def take_rows(table, idx):
    """``table[idx]``: rows of a (V, D) table (an embedding lookup). On a
    DTensor table each device looks up the ids that fall in its block of
    rows, zero elsewhere, and the result is a partial sum over the mesh
    dims that split the rows (a vocab-parallel lookup); the table's gradient
    is a partial sum over the mesh dims that split the ids. DTensor's own
    rule needs the data on the way in and fails on the way back."""
    if not _is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rows = [m for m, p in enumerate(table.placements) if isinstance(p, Shard) and p.dim == 0]
    if len(rows) > 1:
        raise NotImplementedError(f"table rows split over mesh dims {rows}")
    off = _block_offset(table.shape[0], mesh, rows[0]) if rows else 0
    idx = replicated_like(idx, table)
    idx_pl = [Replicate() if m in rows else p for m, p in enumerate(idx.placements)]
    out_pl = [Partial() if m in rows else p for m, p in enumerate(idx_pl)]

    def local(tl, il):
        j = il.long() - off
        t = tl[j.clamp(0, tl.shape[0] - 1)]
        return torch.where(((j >= 0) & (j < tl.shape[0]))[..., None], t,
                           torch.zeros((), dtype=t.dtype, device=t.device))

    tab_pl = [p if m in rows else Replicate() for m, p in enumerate(table.placements)]
    # each device's table gradient holds only its ids' rows: a partial sum
    # over the mesh dims that split the ids
    grad_pl = [p if m in rows else Partial() if isinstance(idx_pl[m], Shard) else Replicate()
               for m, p in enumerate(tab_pl)]
    return local_map(local, out_placements=out_pl, in_placements=(tab_pl, idx_pl),
                     in_grad_placements=(grad_pl, idx_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, idx)


def argmax_last(x):
    """``torch.argmax(x, dim=-1)``. On a DTensor split on its last dim each
    device takes its block's first maximum, and the first of the blocks'
    maxima wins: the index of the first maximum, as on one tensor."""
    split = _last_dim_split(x) if _is_dtensor(x) else None
    if split is None:
        return torch.argmax(x, dim=-1)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    m, off = split

    def local(xl):
        i = torch.argmax(xl, dim=-1, keepdim=True)
        return torch.gather(xl, -1, i), i + off

    pl = list(x.placements)
    vals, idxs = local_map(local, out_placements=(pl, pl), in_placements=(pl,),
                           device_mesh=x.device_mesh)(x)
    whole = _without(x, m, Replicate())
    vals = vals.redistribute(x.device_mesh, whole)
    idxs = idxs.redistribute(x.device_mesh, whole)
    return torch.gather(idxs, -1, torch.argmax(vals, dim=-1, keepdim=True))[..., 0]
