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

``batch_specs``, ``cache_specs`` and the activation helpers
(``shard_activations``, ``shard_heads``, ``gather_fsdp``) are not ported
yet.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Callable

import torch
import torch.distributed as dist

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
