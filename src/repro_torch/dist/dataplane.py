"""The data-plane seam: what moves the payload bytes under the simulated control plane.

``HierarchicalCollectives`` (the §V schedule executor) decides who reduces
to whom, the stage list and the alpha-beta charge; it routes exactly four
payload operations through a data plane:

| hop class                | call                          | sim                  | torch                                    |
|--------------------------|-------------------------------|----------------------|------------------------------------------|
| reduce fold (any level)  | ``reduce(parts, op, nodes)``  | sequential numpy fold | the same fold in torch ops on the device |
| bcast root payload       | ``bcast_payload(p, root)``    | identity             | the payload as a device tensor           |
| result gather            | ``gather_arrays(vs, nodes)``  | identity             | the payloads as device tensors           |
| cross-legion compression | ``compress(g, scheme, f)``    | numpy twins          | absmax + quantize kernels / stable top-k |

plus ``asarray`` (a payload the plane can carry: a numpy array on sim, a
tensor on the plane's device on torch), ``register_state`` /
``reshard_registered`` (post-repair state redistribution) and ``name``.

Both planes fold *sequentially*, ``acc = op(acc, p)`` in the order the
schedule passes the parts. Elementwise IEEE f32 operations in the same order
give the same bits, so on one rank the torch plane's results equal the sim
plane's byte for byte on any f32 payload; the compression hop is bit-equal
too (see ``optim.compression``). The torch plane takes the predefined MPI
reductions the sim fold computes: ``np.add``, ``np.multiply``,
``np.maximum``, ``np.minimum``, ``np.logical_and/or/xor`` and
``np.bitwise_and/or/xor``, each as the torch op of the same name; it raises
on any other callable, naming it: it never drops to the host for a call.

**Ranks.** When a ``torch.distributed`` process group is initialised (see
:func:`init_from_env`), every rank runs the same control plane from the
same arguments, and logical node ``n`` lives on rank ``n % world`` (the
JAX package's ``devices[node % ndev]``). Every rank passes the payload
entries of every node a call names: the plane reads the values of the nodes
its rank owns, and only the shape and dtype of the others. A reduce folds
this rank's parts in the schedule's order and ``all_reduce``s the partial
fold in the payload's own dtype (a rank with no part adds the op's identity),
so integer-exact payloads stay byte-equal to the sim fold while other f32
sums may differ in the last bits (the order across ranks is the backend's).
The logical ops reduce 0/1 over ``uint8`` and return ``bool``, as the sim
fold does. NCCL has no bitwise reduction, so on every backend the bitwise
and logical-xor partials travel to every rank as bytes
(``sharding.sum_bytes``) and fold in rank order. A reduce of one part
returns that part, sent from its owner.
A bcast comes from the rank that owns the root. A gather writes each node's
payload, on its owner's rank, into a zeroed buffer that is summed as bytes
(``sharding.sum_bytes``): every bit arrives as sent, on every backend. The
compression hop runs on every rank over the replicated partial, so its
output is byte-equal on every rank. At world size 1 the group's path gives
the same bytes as the one-device plane.

Every reduce is a world-wide ``all_reduce`` of the whole payload, whatever
nodes it names: a rank with no part sends the identity. So a hierarchical
allreduce over ``L`` legions moves ``L + 1`` world-wide all_reduces (one a
legion at level 0, one across the masters) and a broadcast, and every rank
runs the compression hop on every master's partial, not only on those it
owns. A group of each legion's ranks would cut both; it is not built yet.

**Resharding.** With more than one rank, ``reshard_registered`` rebuilds a
``("data", "model")`` ``DeviceMesh`` over the survivors' ranks
(``sharding.survivor_grid``) and re-places every registered leaf by
``param_specs`` (``sharding.place``; docs/dataplane.md, "Fault-driven
resharding"), reporting a :class:`ReshardReport`. On one rank and on the sim
plane it returns ``None``: every node's state lives on the one device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (
    leaf_spec,
    place,
    sum_bytes,
    survivor_grid,
    tree_map_with_path,
)
from repro_torch.optim import compression as C

# the predefined MPI reductions: numpy's op (the sim fold's), torch's
_TORCH_OPS = {np.add: torch.add, np.multiply: torch.mul, np.maximum: torch.maximum,
              np.minimum: torch.minimum, np.logical_and: torch.logical_and,
              np.logical_or: torch.logical_or, np.logical_xor: torch.logical_xor,
              np.bitwise_and: torch.bitwise_and, np.bitwise_or: torch.bitwise_or,
              np.bitwise_xor: torch.bitwise_xor}
_R = dist.ReduceOp
# the ops an all_reduce computes on every backend (the logical ones over uint8
# 0/1); the others fold every rank's partial, sent as bytes
_DIST_OPS = {np.add: _R.SUM, np.multiply: _R.PRODUCT, np.maximum: _R.MAX, np.minimum: _R.MIN,
             np.logical_and: _R.MIN, np.logical_or: _R.MAX}
_LOGICAL = (np.logical_and, np.logical_or, np.logical_xor)


def _fold(parts: list, op: Callable) -> Any:
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


def _identity(like: torch.Tensor, op: Callable) -> torch.Tensor:
    """The element that leaves ``op`` unchanged, shaped like ``like``."""
    if op in (np.add, np.bitwise_or, np.bitwise_xor):
        return torch.zeros_like(like)
    if op is np.multiply:
        return torch.ones_like(like)
    if op is np.bitwise_and:       # every bit set
        return ~torch.zeros_like(like)
    biggest = op is np.minimum
    if like.dtype == torch.bool:
        value = biggest
    elif like.dtype.is_floating_point:
        value = float("inf") if biggest else float("-inf")
    else:
        info = torch.iinfo(like.dtype)
        value = info.max if biggest else info.min
    return torch.full_like(like, value)


@dataclass(frozen=True)
class ReshardReport:
    """One post-repair redistribution pass of the registered state."""
    leaves: int                   # tensors re-placed
    n_devices: int                # ranks in the survivors' mesh
    moved_bytes: int              # the re-placed leaves' global bytes
    wall_seconds: float           # the pass's wall time, slowest rank's
    mesh_shape: tuple[int, ...]


class SimDataPlane:
    """The numpy simulator: payloads are host arrays, folds are numpy ops,
    compression runs the numpy twins."""

    name = "sim"

    def asarray(self, x) -> np.ndarray:
        return np.asarray(x)

    def reduce(self, parts: list, op: Callable, nodes: list | None = None) -> Any:
        return _fold(parts, op)

    def bcast_payload(self, payload, root: int | None = None):
        return payload

    def gather_arrays(self, values: list, nodes: list | None = None) -> list:
        return list(values)

    def compress(self, g: np.ndarray, scheme: str, fraction: float) -> np.ndarray:
        """Compress-then-decompress round trip: what the receiver sees."""
        if scheme == "int8":
            return C.decompress_int8_np(C.compress_int8_np(g))
        if scheme == "topk":
            return C.decompress_topk_np(C.compress_topk_np(g, fraction), g.shape)
        raise ValueError(f"unknown compression scheme {scheme!r}")

    def register_state(self, name: str, getter: Callable[[], Any],
                       setter: Callable[[Any], None] | None = None) -> None:
        """Placement is virtual in the simulator: nothing to redistribute."""

    def reshard_registered(self, view) -> None:
        return None


class TorchDataPlane:
    """Payloads are torch tensors on ``device`` (``"cuda"`` by default);
    every fold, bcast, gather and compression stays on it. Over the default
    process group when one is initialised (module docstring)."""

    name = "torch"

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.registered: dict[str, tuple[Callable, Callable | None]] = {}
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.world = dist.get_world_size() if self.distributed else 1
        self._meshes: dict[tuple[int, ...], Any] = {}

    def owner(self, node: int) -> int:
        """The rank that holds logical node ``node``'s payload and state."""
        return node % self.world

    def asarray(self, x) -> torch.Tensor:
        """``x`` as a tensor on the plane's device. A host array (or scalar,
        or list) is copied there once; a tensor on another device raises."""
        if isinstance(x, torch.Tensor):
            if x.device.type != self.device.type:
                raise ValueError(f"payload on {x.device}, data plane on {self.device}")
            return x
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _owned(self, nodes: list | None, n: int) -> list[bool]:
        if nodes is None or len(nodes) != n:
            raise ValueError("a data plane over a process group needs the node of "
                             f"each of the {n} payloads")
        return [self.owner(node) == self.rank for node in nodes]

    def reduce(self, parts: list, op: Callable, nodes: list | None = None) -> torch.Tensor:
        fn = _TORCH_OPS.get(op)
        if fn is None:
            names = ", ".join(o.__name__ for o in _TORCH_OPS)
            raise ValueError(f"torch data plane: unsupported reduce op "
                             f"{getattr(op, '__name__', op)!r} ({names})")
        parts = [self.asarray(p) for p in parts]
        if not self.distributed:
            return _fold(parts, fn)
        owned = self._owned(nodes, len(parts))
        if len(parts) == 1:     # the fold of one part is the part
            return self.bcast_payload(parts[0], nodes[0])
        mine = [p for p, own in zip(parts, owned) if own]
        if len(mine) > 1:
            acc = _fold(mine, fn)
        else:   # all_reduce works in place: never on the caller's tensor
            acc = mine[0].clone() if mine else None
        if op in _LOGICAL:
            acc = torch.full(parts[0].shape, op is np.logical_and, dtype=torch.uint8,
                             device=self.device) if acc is None else (acc != 0).to(torch.uint8)
        elif acc is None:
            acc = _identity(parts[0], op)
        if op in _DIST_OPS:
            dist.all_reduce(acc, op=_DIST_OPS[op])
        else:
            rows = torch.zeros((self.world, *acc.shape), dtype=acc.dtype, device=self.device)
            rows[self.rank] = acc
            acc = _fold(list(sum_bytes(rows).unbind(0)), fn)
        return acc.bool() if op in _LOGICAL else acc

    def bcast_payload(self, payload, root: int | None = None) -> torch.Tensor:
        t = self.asarray(payload)
        if not self.distributed:
            return t
        if root is None:
            raise ValueError("a data plane over a process group needs the bcast root")
        src = self.owner(root)
        if self.rank == src:
            buf = t.contiguous()
        else:
            buf = torch.empty_like(t, memory_format=torch.contiguous_format)
        dist.broadcast(buf, src=src)
        return buf

    def gather_arrays(self, values: list, nodes: list | None = None) -> list:
        vals = [self.asarray(v) for v in values]
        if not self.distributed:
            return vals
        rows = torch.zeros((len(vals), *vals[0].shape), dtype=vals[0].dtype,
                           device=self.device)
        for i, (v, own) in enumerate(zip(vals, self._owned(nodes, len(vals)))):
            if own:
                rows[i] = v
        return list(sum_bytes(rows).unbind(0))

    def compress(self, g: torch.Tensor, scheme: str, fraction: float) -> torch.Tensor:
        """Compress-then-decompress round trip on the device: int8 through the
        absmax and quantize kernels (their plain versions on a CPU plane)."""
        g = self.asarray(g)
        if scheme == "int8":
            return C.decompress_int8(C.compress_int8(g))
        if scheme == "topk":
            return C.decompress_topk(C.compress_topk(g, fraction), g.shape)
        raise ValueError(f"unknown compression scheme {scheme!r}")

    def register_state(self, name: str, getter: Callable[[], Any],
                       setter: Callable[[Any], None] | None = None) -> None:
        """Register a state tree; a getter that returns ``None`` (its owner
        is gone) is skipped by the reshard pass."""
        self.registered[name] = (getter, setter)

    # -- resharding over the survivors' mesh --------------------------------------

    def mesh_for(self, view):
        """The ``("data", "model")`` ``DeviceMesh`` of shape ``(n, 1)`` over the
        ranks of the view's nodes, deduplicated (a rank holding a surviving
        node stays): ``survivor_grid``, as ``MeshManager`` builds it with a
        pool of one rank a node. Every rank builds it (creating a process
        group is collective), a rank outside it too; one mesh per rank set."""
        from torch.distributed.device_mesh import DeviceMesh

        if not self.distributed:
            raise RuntimeError("mesh_for needs an initialised process group")
        grid = survivor_grid(view.nodes, lambda n: [self.owner(n)])
        key = tuple(r for row in grid for r in row)
        mesh = self._meshes.get(key)
        if mesh is None:
            mesh = DeviceMesh(self.device.type, torch.tensor(grid),
                              mesh_dim_names=("data", "model"))
            self._meshes[key] = mesh
        return mesh

    def reshard_registered(self, view) -> ReshardReport | None:
        """Re-place every registered leaf on the survivors' mesh by
        ``param_specs`` (``sharding.place``: no scatter) and hand each placed
        tree to its setter; ``None`` on one rank or with nothing registered.
        A collective of the world group: every rank calls it, one that holds
        no surviving node too. The trainer's params, mu and nu come back
        placed, and its next step reads them where they are (see
        ``core.trainer``). The wall time, the span ``pipeline.reshard``,
        covers the mesh, the placement and a device sync; every rank reports
        the slowest rank's, so every rank's clock takes the same charge."""
        if self.world == 1 or not self.registered:
            return None
        with tracing.span("pipeline.reshard") as reshard:
            mesh = self.mesh_for(view)
            leaves = moved = 0

            def place_leaf(path, leaf):
                nonlocal leaves, moved
                if not isinstance(leaf, torch.Tensor):
                    return leaf
                leaves += 1
                moved += leaf.numel() * leaf.element_size()
                return place(leaf, mesh, leaf_spec(path, tuple(leaf.shape), mesh))

            for getter, setter in self.registered.values():
                tree = getter()
                if tree is None:
                    continue
                placed_tree = tree_map_with_path(place_leaf, tree)
                if setter is not None:
                    setter(placed_tree)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        wall = torch.tensor([reshard.seconds], dtype=torch.float64, device=self.device)
        dist.all_reduce(wall, op=dist.ReduceOp.MAX)
        return ReshardReport(leaves=leaves, n_devices=mesh.size(), moved_bytes=moved,
                             wall_seconds=float(wall.item()), mesh_shape=tuple(mesh.shape))


_DEFAULT = SimDataPlane()


def default_dataplane() -> SimDataPlane:
    """The plane of a ``HierarchicalCollectives`` built without a cluster:
    the shared sim plane, so a bare schedule stays numpy-only."""
    return _DEFAULT


def make_dataplane(policy, device: str | torch.device = "cuda"):
    """The plane ``policy.data_plane`` names: ``torch`` on ``device``,
    ``sim``, or ``auto`` (torch when a process group of more than one rank
    is initialised or more than one CUDA device is visible, else sim)."""
    kind = policy.data_plane
    if kind == "auto":
        ranks = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        kind = "torch" if ranks > 1 or torch.cuda.device_count() > 1 else "sim"
    if kind == "torch":
        return TorchDataPlane(device)
    if kind == "sim":
        return SimDataPlane()
    raise ValueError(f"unknown data_plane {policy.data_plane!r}")


def init_from_env(device: str | torch.device = "cuda", backend: str | None = None
                  ) -> torch.device:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, optionally
    ``LOCAL_RANK``) and return this rank's device.

    NCCL for ``cuda`` and gloo for ``cpu`` unless ``backend`` names one.
    Raises when the device or the backend is missing; it never switches from
    one backend to another by itself. On ``cuda`` the rank's card is
    ``LOCAL_RANK`` modulo the cards visible, so several ranks may share one
    card (gloo allows it; NCCL refuses two ranks on one card).
    """
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    available = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}
    if backend not in available:
        raise ValueError(f"unknown backend {backend!r}: use 'nccl' or 'gloo'")
    if not available[backend]():
        raise RuntimeError(f"this torch build has no {backend} backend")
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_from_env: {', '.join(missing)} not set "
                           "(start the ranks with torchrun)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev
