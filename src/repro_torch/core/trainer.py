"""ResilientTrainer — data-parallel training under the Legio runtime.

The integration of the paper's technique: a training step wrapped so node
failures are survived by *discard-and-continue* rather than a global
restart:

  * the virtual cluster's nodes each own one data-parallel batch shard;
  * a failure (injected here) triggers the Legio repair path (agreement,
    hierarchical shrink, master re-election) at the step boundary, and the
    step runs on the survivors' shards;
  * the global batch shrinks (DROP) or redistributes (REBALANCE); the loss
    is the mean over the shards actually computed, so the gradient
    estimator stays unbiased (the paper's Monte-Carlo argument, applied to
    stochastic gradients);
  * per-legion checkpoints (``cr.py``) bound the loss of a non-recoverable
    event, and restart-only-failed brings a replacement back without
    touching survivors.

On one rank, one device holds the whole step: the global batch is the
survivors' shards concatenated, as the JAX package's single-program step
sees it. The trainer runs on its cluster's ``device`` ("cuda" unless the
cluster was built with ``device="cpu"``; without a card "cuda" raises). It
builds a device pool, a mesh manager and a compile cache as the JAX
package's does; its loop never reads them. ``TrainerReport.recompiled``
keeps its meaning: the step saw a mesh change (a repair or an expansion).

**Over ranks.** When the cluster's torch data plane spans a process group
(``TorchDataPlane.distributed``), every rank runs the same control plane
and calls ``run_step`` together. After each repair the plane has placed
``params``, ``mu`` and ``nu`` by ``param_specs`` on the survivors'
``("data", "model")`` mesh (through the setters registered here); before
the first repair they are plain tensors, whole on every rank. A step:

  1. builds the shards of the live nodes this rank owns (node ``n`` on
     rank ``n % world``), in sorted shard order;
  2. assembles the whole parameters from their placed blocks by a byte sum
     over the mesh's ``data`` group (``sharding.assemble``; DTensor's own
     redistribution would need an ``all_gather``, which gloo lacks for
     CUDA tensors), and runs forward and backward on them as plain leaves;
     the rank's loss is its token mean scaled by its share of the global
     tokens;
  3. sums the gradients over that group in fp32 buckets and rounds them
     once to the parameters' dtype;
  4. clips by the global norm of the summed gradient (the same on every
     rank) and runs AdamW on this rank's blocks of params, mu and nu, in
     place, so the placement stays;
  5. sums the scalar metrics over the world, so every rank reports the
     same ``TrainerReport``.

A rank that holds no live node (a fault took all of them) stays outside
the mesh: it computes nothing but still takes every world-wide collective
(the reshard and the metrics) in lock-step. At world size 1 the step's
operations are the one-rank step's, so its numbers are bit-identical.
MoE configs route the flattened global batch, the live shards sorted and
concatenated whole, in groups of ``moe_group_size`` tokens (the last
padded with zero rows), and take their load-balancing loss, router z-loss
and dropped fraction as means over the groups. A group may span shards on
several ranks, so over more than one rank the step runs the forward and
the backward inside a ``moe.routing_span`` built anew each step (after a
fault ``T``, the rows and the pad change): the group's ranks sum each
layer's router logits into a buffer of the whole batch, every rank routes
all of it and computes its own tokens (``models/moe.py``). Each rank's
``share`` of the global routing losses backpropagates into the whole
buffer, the backward sum adds the shares to 1, and each rank keeps its own
rows: the router gradients the ranks sum in step 3 are the reference's.
Every member of the mesh must run each layer's sums, so a member that
holds no shard runs a stand-in shard that routes nothing, with its loss
scaled by 0 and its gradients set to zeros.

The registered state getters hold the trainer weakly, so a dropped trainer
frees its tensors at once, without waiting for the cycle collector.
"""
from __future__ import annotations

import math
import time
import weakref
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.cr import LegionCheckpointer
from repro_torch.core.executor import VirtualCluster
from repro_torch.core.mesh_manager import CompileCache, DevicePool, MeshManager
from repro_torch.core.types import RepairReport
from repro_torch.data.pipeline import host_batch_numpy
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (
    assemble,
    leaf_spec,
    local_block,
    place,
    tree_map_with_path,
)
from repro_torch.models import api, moe
from repro_torch.optim.adamw import (
    OptState,
    adamw_init,
    adamw_update_,
    clip_by_global_norm_,
    cosine_schedule,
    tree_leaves,
    tree_map,
)

PyTree = Any

# the scalar metrics of ``api.train_loss``, summed over the ranks in this
# order; a MoE config adds its routing means
_METRICS = ("accuracy", "loss", "nll", "z_loss")
_MOE_METRICS = ("dropped", "moe_aux", "router_z")
# the gradient sum over ranks runs in fp32 buckets of at most this many
# elements (1 GiB): few calls (gloo's cost is per call), bounded memory
BUCKET_ELEMS = 1 << 28


@dataclass
class TrainerReport:
    step: int
    loss: float
    grad_norm: float
    active_shards: int
    grad_scale: float
    repair: RepairReport | None = None
    recompiled: bool = False
    step_seconds: float = 0.0
    metrics: dict = field(default_factory=dict)


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """(params, opt, batch, grad_scale) -> (params, opt, metrics).

    The JAX package's jitted step: value-and-grad of the scaled loss,
    global-norm clipping, AdamW. Parameters and moments are updated in
    place, leaf by leaf (the JAX step donates them); the same tensors come
    back. The dry-run's train step (``launch.steps.train_step_fn``) is this
    step at ``grad_scale`` 1 on DTensor leaves.
    """
    lr_fn = cosine_schedule(tc)

    def train_step(params: PyTree, opt: OptState, batch: dict, grad_scale: float):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = api.train_loss(cfg, params, batch)
            # a leaf the loss does not read (the token embedding of a stub
            # frontend's batch) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss * grad_scale, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _retree_leaves(params, iter([_placed_like(g, p) for g, p in zip(grads, leaves)]))
        with torch.no_grad():
            gnorm = clip_by_global_norm_(grads, tc.grad_clip)
            opt = adamw_update_(grads, opt, params, tc, lr_fn(opt.step))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return params, opt, metrics

    return train_step


def _placed_like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient re-placed as its parameter (a partial sum is
    reduce-scattered to the parameter's shards, as in the dry-run); a plain
    one as is."""
    placements = getattr(param, "placements", None)
    if placements is None or tuple(grad.placements) == tuple(placements):
        return grad
    return grad.redistribute(param.device_mesh, placements)


def _retree_leaves(template: PyTree, leaves) -> PyTree:
    """``template``'s dict structure over the iterator ``leaves``, which
    yields them in ``tree_leaves`` order (sorted keys)."""
    if isinstance(template, dict):
        return {k: _retree_leaves(template[k], leaves) for k in sorted(template)}
    return next(leaves)


class ResilientTrainer:
    """Data-parallel training loop with Legio fault resiliency."""

    def __init__(
        self,
        cfg: ModelConfig,
        tc: TrainConfig,
        cluster: VirtualCluster,
        *,
        per_shard_batch: int = 4,
        seq_len: int = 128,
        checkpointer: LegionCheckpointer | None = None,
    ):
        plane = cluster.dataplane
        # the step over ranks (module docstring) whenever the plane spans a
        # process group, at world size 1 too
        self.distributed = bool(getattr(plane, "distributed", False))
        self.cfg, self.tc = cfg, tc
        self.cluster = cluster
        self.device = resolve_device(cluster.device)
        self.per_shard_batch = per_shard_batch
        self.seq_len = seq_len
        self.checkpointer = checkpointer
        if checkpointer is not None and cluster.checkpointer is None:
            # substituted ranks restore from the same per-legion store
            cluster.checkpointer = checkpointer
        # all fault plumbing rides the MPI facade: the session owns the
        # step boundary (spare delivery, splice re-expansion, ground-truth
        # injection) and the INJECTED-channel drain
        from repro_torch.mpi import Session

        self.session = Session.adopt(cluster)
        self.pool = DevicePool(n_nodes=cluster.n_initial,
                               n_spares=cluster.spare_pool.capacity)
        self.mesh_manager = MeshManager(self.pool, device_type=self.device.type)
        self.compile_cache = CompileCache()
        self.train_step = make_train_step(cfg, tc)
        self.lr_fn = cosine_schedule(tc)
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.params = api.init_params(cfg, gen, self.device)
        self.opt = adamw_init(self.params)
        self.step = 0
        self.history: list[TrainerReport] = []
        # live state rides the data plane: after every shrink or regrow the
        # plane re-places it (a no-op while one device holds every node).
        # The getters and setters reach the trainer through a weak
        # reference, so the cluster keeps none of its tensors alive; once
        # the trainer is gone its getters read None
        me = weakref.ref(self)
        self.session.register_sharded_state(
            "trainer.params", lambda: _get(me, lambda t: t.params),
            lambda p: _set(me, lambda t: setattr(t, "params", p)))
        self.session.register_sharded_state(
            "trainer.opt.mu", lambda: _get(me, lambda t: t.opt.mu),
            lambda mu: _set(me, lambda t: setattr(t, "opt", t.opt._replace(mu=mu))))
        self.session.register_sharded_state(
            "trainer.opt.nu", lambda: _get(me, lambda t: t.opt.nu),
            lambda nu: _set(me, lambda t: setattr(t, "opt", t.opt._replace(nu=nu))))

    # -- batch assembly under the current plan --------------------------------------

    def _batch_of(self, step: int, shards: list[int]) -> dict:
        """The shards' batches at ``step``, concatenated in the given order."""
        parts = [host_batch_numpy(self.tc.seed, step, s, batch=self.per_shard_batch,
                                  seq_len=self.seq_len, vocab_size=self.cfg.vocab_size)
                 for s in shards]
        return {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).to(self.device)
                for k in parts[0]}

    def _global_batch(self, step: int) -> tuple[dict, float]:
        shards = sorted(s for a in self.cluster.plan.assignments for s in a.shards)
        if not shards:
            raise RuntimeError("no surviving shards — cluster exhausted")
        # mean-over-present-shards is already the renormalised estimator:
        # grad_scale stays 1.0 for DROP (the mean's denominator shrank with
        # the batch); it differs from 1 only for weighted schemes
        return self._batch_of(step, shards), 1.0

    def _rank_shards(self) -> list[int]:
        """The shards of the live nodes this rank owns, sorted."""
        plane = self.cluster.dataplane
        return sorted(s for a in self.cluster.plan.assignments
                      if plane.owner(a.node) == plane.rank for s in a.shards)

    # -- one resilient step -----------------------------------------------------------

    def run_step(self) -> TrainerReport:
        cl = self.cluster
        t0 = time.perf_counter()
        step = self.step

        # step boundary through the facade: re-spawned spares and warmed-up
        # substitutes rejoin before shards are handed out, and ground-truth
        # faults land and drain through the pipeline's INJECTED channel
        # (detect → notice → agree → plan → apply). charge=False: the
        # trainer's clock is wall time. Over ranks a repair also reshards
        # params and moments onto the survivors' mesh here.
        boundary = self.session.boundary(step, observe_injected=True, charge=False)
        repair = None
        recompiled = bool(boundary.expansions)
        if boundary.actions:
            repair = boundary.actions[0].report
            recompiled = True  # a mesh change

        if self.distributed:
            grad_scale = 1.0        # DROP's scale, as _global_batch's
            metrics = self._group_step(step)
        else:
            batch, grad_scale = self._global_batch(step)
            self.params, self.opt, metrics = self.train_step(
                self.params, self.opt, batch, grad_scale)

        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {step}: {loss}")

        if self.checkpointer is not None and self.tc.checkpoint_every > 0 \
                and step > 0 and step % self.tc.checkpoint_every == 0:
            # over ranks every rank assembles the state once (a collective),
            # pushes the same map to its replicator, and rank 0 writes
            whole = self._whole_state()
            self.checkpointer.save(step, cl.topo, lambda n: self._state_of(n, whole),
                                   sync=False,
                                   write=not self.distributed or cl.dataplane.rank == 0)

        report = TrainerReport(
            step=step,
            loss=loss,
            grad_norm=float(metrics.get("grad_norm", 0.0)),
            active_shards=cl.plan.active_shards,
            grad_scale=grad_scale,
            repair=repair,
            recompiled=recompiled,
            step_seconds=time.perf_counter() - t0,
            metrics={k: float(v) for k, v in metrics.items() if v.dim() == 0},
        )
        self.history.append(report)
        self.step += 1
        return report

    def _group_step(self, step: int) -> dict:
        """One step over the process group (module docstring, steps 1-5);
        returns the metrics summed over the world, with the grad norm."""
        plane = self.cluster.dataplane
        active = self.cluster.plan.active_shards
        if active == 0:
            raise RuntimeError("no surviving shards — cluster exhausted")
        shards = self._rank_shards()
        # every shard has the same token count: the rank's share of the
        # global tokens, exactly 1.0 when one rank computes every shard
        share = len(shards) / active
        mesh = _mesh_of(self.params)
        member = mesh is None or mesh.get_coordinate() is not None
        if shards and not member:
            raise RuntimeError(f"rank {plane.rank} owns shards {shards} but is outside "
                               "the survivors' mesh")
        names = _METRICS + (_MOE_METRICS if self.cfg.is_moe else ())
        sums = torch.zeros(len(names) + 1, dtype=torch.float32, device=self.device)
        if member:
            group = None if mesh is None else mesh.get_group("data")
            lowest = 0 if mesh is None else int(mesh.mesh.min())
            whole = assemble_params(self.params, group)
            leaves = tree_leaves(whole)
            span = self._routing_span(shards, group)
            if shards or span is not None:
                # a member with no shard runs a stand-in one under the span
                batch = self._batch_of(step, shards or [0])
                for p in leaves:
                    p.requires_grad_(True)
                try:
                    with moe.routing_span(span):   # the backward's recompute reads it too
                        loss, metrics = api.train_loss(self.cfg, whole, batch)
                        grads = [g.contiguous()
                                 for g in torch.autograd.grad(loss * share, leaves)]
                finally:
                    for p in leaves:
                        p.requires_grad_(False)
                if not shards:
                    grads = [torch.zeros_like(p) for p in leaves]
                if set(metrics) != set(names):
                    raise ValueError(f"{self.cfg.name}: metrics {sorted(metrics)}, the step "
                                     f"over ranks sums {list(names)}")
                weight = dict.fromkeys(names, share)
                if span is not None:
                    # the routing means are the global batch's on every rank:
                    # one rank adds them, so the sum is their value exactly
                    weight.update(dict.fromkeys(_MOE_METRICS, float(plane.rank == lowest)))
                sums[:-1] = torch.stack([metrics[k].detach().float() * weight[k]
                                         for k in names])
                del batch, loss, metrics
            else:
                grads = [torch.zeros_like(p) for p in leaves]
            del whole, leaves
            allreduce_grads(grads, group)
            grads = _retree_leaves(self.params, iter(grads))
            with torch.no_grad():
                gnorm = clip_by_global_norm_(grads, self.tc.grad_clip)
                local = tree_map(_block_of, grads, self.params)
                del grads
                opt = adamw_update_(local, OptState(step=self.opt.step,
                                                    mu=tree_map(_local, self.opt.mu),
                                                    nu=tree_map(_local, self.opt.nu)),
                                    tree_map(_local, self.params), self.tc,
                                    self.lr_fn(self.opt.step))
            # the updates went into the placed tensors' blocks in place
            self.opt = self.opt._replace(step=opt.step)
            if plane.rank == lowest:     # one rank adds the (common) norm
                sums[-1] = gnorm
        else:
            self.opt = self.opt._replace(step=self.opt.step + 1)
        dist.all_reduce(sums)
        out = {k: sums[i] for i, k in enumerate(names)}
        out["grad_norm"] = sums[-1]
        return out

    def _routing_span(self, shards: list[int], group) -> moe.RoutingSpan | None:
        """The MoE routing span of this step's global batch over ``group``
        (module docstring), or None: not a MoE config, or the group is one
        rank (it holds every live shard, as on one rank)."""
        if not self.cfg.is_moe or dist.get_world_size(group) == 1:
            return None
        every = sorted(s for a in self.cluster.plan.assignments for s in a.shards)
        at = {s: i for i, s in enumerate(every)}
        per = self.per_shard_batch * self.seq_len
        rows = None
        if shards:
            rows = torch.cat([torch.arange(at[s] * per, (at[s] + 1) * per) for s in shards])
            rows = rows.to(self.device)
        return moe.RoutingSpan(group, rows, len(every) * per)

    def _whole_state(self) -> dict:
        """params, mu and nu as whole tensors; over ranks a collective of the
        world group (every rank gets every leaf)."""
        return {name: tree_map(assemble, tree)
                for name, tree in (("params", self.params), ("mu", self.opt.mu),
                                   ("nu", self.opt.nu))}

    def _state_of(self, node: int, whole: dict | None = None) -> PyTree:
        """Member state shard for checkpointing, as whole tensors.

        Data-parallel state is replicated, so every member's shard is the
        (params, opt, step) triple plus its shard assignment: a replacement
        node needs nothing from survivors beyond its own file (§VII).
        ``whole`` is :meth:`_whole_state`'s, taken once per save; without it
        the state is assembled here (over ranks, a collective).
        """
        whole = self._whole_state() if whole is None else whole
        shards = list(self.cluster.plan.shards_of(node)) or [-1]
        return {
            "params": whole["params"],
            "opt": {"step": self.opt.step, "mu": whole["mu"], "nu": whole["nu"]},
            "meta": {
                "step": torch.tensor(self.step, dtype=torch.int32),
                "shards": torch.tensor(shards, dtype=torch.int32),
            },
        }

    def run(self, n_steps: int) -> list[TrainerReport]:
        return [self.run_step() for _ in range(n_steps)]

    # -- restart-only-failed -----------------------------------------------------------

    def restore_from(self, checkpointer: LegionCheckpointer,
                     legion: int, node: int) -> None:
        """Load one member's file into this trainer. Over ranks every rank
        calls it together: rank 0's pending writes finish before any rank
        reads, and each leaf that is placed now is placed again, by
        ``param_specs`` on its mesh, from the whole tensor read."""
        if self.distributed:
            checkpointer.wait()
            dist.barrier()
        state = checkpointer.restore_failed_member(legion, node, template=None)
        self.params = _retree(self.params, state["params"])
        self.opt = OptState(
            step=state["opt"]["step"].to(self.device, torch.int32),
            mu=_retree(self.opt.mu, state["opt"]["mu"]),
            nu=_retree(self.opt.nu, state["opt"]["nu"]),
        )
        self.step = int(state["meta"]["step"])


def assemble_params(params: PyTree, group) -> PyTree:
    """The whole parameters, each placed leaf assembled over ``group`` (the
    mesh's ``data`` group, or the world); plain leaves are already whole."""
    return tree_map(lambda p: assemble(p, group), params)


def allreduce_grads(grads: list, group) -> None:
    """Sum the (contiguous) gradient leaves over ``group`` in place. The
    leaves, read as one flat stream, go in fp32 buckets of at most
    BUCKET_ELEMS elements (each leaf upcast exactly), and each sum is
    rounded once to its leaf's dtype. At world size 1 the values come back
    unchanged."""
    total = sum(g.numel() for g in grads)
    start = 0
    while start < total:
        size = min(BUCKET_ELEMS, total - start)
        bucket = torch.empty(size, dtype=torch.float32, device=grads[0].device)
        pieces, offset, at = [], 0, 0
        for g in grads:
            lo, hi = max(start, offset), min(start + size, offset + g.numel())
            if lo < hi:
                pieces.append((g.view(-1)[lo - offset:hi - offset], at))
                at += hi - lo
            offset += g.numel()
        for piece, at in pieces:
            bucket[at:at + piece.numel()].copy_(piece)
        dist.all_reduce(bucket, group=group)
        for piece, at in pieces:
            piece.copy_(bucket[at:at + piece.numel()])
        del bucket
        start += size


def _mesh_of(tree: PyTree):
    """The mesh the state is placed on, or None while it is whole (no
    repair has resharded it yet)."""
    from torch.distributed.tensor import DTensor

    leaf = tree_leaves(tree)[0]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def _local(leaf: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``leaf``: the placed tensor's own storage (an
    update in place lands in the DTensor), or a plain leaf itself."""
    from torch.distributed.tensor import DTensor

    return leaf.to_local() if isinstance(leaf, DTensor) else leaf


def _block_of(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """The part of the whole gradient ``grad`` that this rank's block of
    ``param`` covers."""
    from torch.distributed.tensor import DTensor

    return grad[local_block(param)] if isinstance(param, DTensor) else grad


def _get(ref: weakref.ref, read):
    """``read(trainer)``, or None once the trainer is gone."""
    trainer = ref()
    return None if trainer is None else read(trainer)


def _set(ref: weakref.ref, write) -> None:
    trainer = ref()
    if trainer is not None:
        write(trainer)


def _retree(template: PyTree, loaded: PyTree) -> PyTree:
    """``loaded``'s leaves in ``template``'s structure, dtype, shape and
    device; where the template's leaf is placed, placed the same way on its
    mesh (by ``param_specs``, sliced from the whole: no collective)."""
    from torch.distributed.tensor import DTensor

    def leaf(path, t):
        x = loaded
        for k in path:
            x = x[k]
        x = x.to(t.device, t.dtype).reshape(t.shape).contiguous()
        if isinstance(t, DTensor):
            return place(x, t.device_mesh, leaf_spec(path, tuple(t.shape), t.device_mesh))
        return x

    return tree_map_with_path(leaf, template)
