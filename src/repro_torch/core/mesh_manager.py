"""Mesh management: survivors -> DeviceMesh, live-state resharding, compile cache.

ULFM's shrink hands back a working communicator; on a cluster of cards the
analogue has three parts:

  (a) rebuild the collective topology  -> a new ``DeviceMesh`` over the
      survivors' ranks (a failed node removes its whole host);
  (b) reshard live state               -> ``distribute_tensor`` of params
      and optimizer state onto the new mesh;
  (c) recompile                        -> a ``torch.compile`` of the step for
      the new mesh, memoized in :class:`CompileCache` so a *re-grown*
      cluster (elastic regrow back to a previously-seen size) reuses it.

A node owns ``chips_per_node`` consecutive ranks. The data-parallel dim
spans nodes; the model dim spans chips within a node, so a node failure only
ever shrinks the data dim and never fractures a tensor. Ranks stand where the
JAX package has devices: ``world_size`` is ``len(jax.devices())``'s
counterpart, the default process group's size (1 without one).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.dist.sharding import place, survivor_grid

PyTree = Any


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclass
class DevicePool:
    """Logical node -> ranks mapping over the process group's ranks.

    With fewer ranks than nodes (one card, or the CPU), several logical
    nodes map onto the same rank: the collective *structure* is still
    exercised, placement is virtual. With enough ranks the mapping is 1:1
    and meshes are physical.
    """

    n_nodes: int
    chips_per_node: int = 1
    n_spares: int = 0          # warm spares hold ranks too (they idle warm)
    world_size: int = field(default_factory=_world_size)

    def node_devices(self, node: int) -> list[int]:
        want = self.chips_per_node
        if self.total_nodes * want <= self.world_size:
            return list(range(node * want, (node + 1) * want))
        return [(node * want + j) % self.world_size for j in range(want)]

    @property
    def total_nodes(self) -> int:
        """Initial workers plus the provisioned spare slots: a substituted
        spare must map onto real ranks just like the node it replaces."""
        return self.n_nodes + self.n_spares

    @property
    def physical(self) -> bool:
        return self.total_nodes * self.chips_per_node <= self.world_size


class MeshManager:
    """Builds survivor meshes and reshards live state after repair."""

    def __init__(self, pool: DevicePool, *, device_type: str = "cuda"):
        self.pool = pool      # the model dim is the pool's chips_per_node
        self.device_type = device_type

    def survivor_ranks(self, survivors: list[int]) -> list[list[int]]:
        """The rank grid of the survivors' mesh, (data, model): the surviving
        nodes' rows of ranks, deduplicated and sorted
        (``dist.sharding.survivor_grid``, the one definition the torch data
        plane's ``mesh_for`` uses too, with one rank a node). Where the pool
        is physical this is the JAX package's grid. Where it is not, the JAX
        package takes a ``(dp, 1)`` grid over its first devices instead;
        the port keeps the ranks that hold the survivors, so state is placed
        where their nodes live."""
        return survivor_grid(survivors, self.pool.node_devices)

    def survivor_mesh(self, survivors: list[int]):
        """``DeviceMesh`` ``("data", "model")`` over :meth:`survivor_ranks`.
        Every rank of the process group builds it (creating its groups is
        collective)."""
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(self.device_type, torch.tensor(self.survivor_ranks(survivors)),
                          mesh_dim_names=("data", "model"))

    @staticmethod
    def reshard(tree: PyTree, mesh, specs: PyTree) -> PyTree:
        """Place live state on a (new) mesh: each leaf by its spec (see
        ``repro_torch.dist.sharding.place``: sliced from the whole leaf
        every rank holds, a leaf placed before assembled first)."""
        def walk(t, s):      # walks the state's structure: a spec is a tuple
            if isinstance(t, dict):
                return {k: walk(v, s[k]) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(walk(v, w) for v, w in zip(t, s))
            return place(t, mesh, s)

        return walk(tree, specs)


@dataclass
class CompileRecord:
    compiled: Any
    lower_seconds: float
    compile_seconds: float
    hits: int = 0


def _leaves(tree: PyTree) -> list:
    """The leaves in the JAX package's order: dict keys sorted, sequences
    in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _dtype_name(dtype) -> str:
    """The JAX package's dtype spelling ("float32", not "torch.float32")."""
    return str(dtype).removeprefix("torch.")


class CompileCache:
    """Memoizes compiled steps by (tag, mesh shape, mesh dims, input avals).

    Elastic regrow returns the cluster to a previously-seen size; the repair
    then skips (c) entirely.
    """

    def __init__(self):
        self._store: dict[tuple, CompileRecord] = {}

    @staticmethod
    def _aval_key(tree: PyTree) -> tuple:
        return tuple((tuple(leaf.shape), _dtype_name(leaf.dtype)) for leaf in _leaves(tree))

    def key(self, tag: str, mesh, *trees: PyTree) -> tuple:
        return (tag, tuple(mesh.shape), tuple(mesh.mesh_dim_names),
                tuple(self._aval_key(t) for t in trees))

    def get(self, key: tuple) -> CompileRecord | None:
        rec = self._store.get(key)
        if rec is not None:
            rec.hits += 1
        return rec

    def put(self, key: tuple, compiled: Any, lower_s: float, compile_s: float
            ) -> CompileRecord:
        rec = CompileRecord(compiled, lower_s, compile_s)
        self._store[key] = rec
        return rec

    def lower_and_compile(self, tag: str, mesh, fn, *args) -> tuple[Any, bool]:
        """Returns (compiled callable, cache_hit). On a miss it stores
        ``torch.compile(fn)`` and runs its first call on ``args``, which is
        when torch compiles: that call's time is the compile time (there is
        no separate lowering step, lower_seconds is 0)."""
        key = self.key(tag, mesh, args)
        rec = self.get(key)
        if rec is not None:
            return rec.compiled, True
        compiled = torch.compile(fn)
        with tracing.span("compile", tag=tag) as sp:
            compiled(*args)
        self.put(key, compiled, 0.0, sp.seconds)
        return compiled, False

    def stats(self) -> dict:
        return {
            "entries": len(self._store),
            "hits": sum(r.hits for r in self._store.values()),
            "compile_seconds": sum(r.compile_seconds for r in self._store.values()),
        }
