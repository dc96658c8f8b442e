"""Batch-shard reassignment — the rank-translation policy analogue (§IV).

When an MPI rank dies mid-operation Legio either IGNOREs the op or STOPs the
application. In data-parallel ML the per-rank artifact is the *batch shard*;
the corresponding policies are:

  DROP       — survivors keep their own shards; the failed node's shards are
               simply not computed this step. The gradient mean renormalizes
               over survivors (smaller batch, unbiased estimator — exactly
               the paper's Monte-Carlo "approximate result" trade-off).
  REBALANCE  — the failed node's shards are redistributed round-robin over
               survivors (exact batch, more work per survivor). Possible
               here because the data pipeline is counter-based: any node can
               regenerate any shard bit-exactly (see data/pipeline.py).

Assignments are pure data (no device state), so reassignment is O(shards).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.data.pipeline import ShardAssignment


@dataclass(frozen=True)
class BatchPlan:
    assignments: tuple[ShardAssignment, ...]
    dropped_shards: tuple[int, ...]
    policy: str

    @property
    def active_shards(self) -> int:
        return sum(len(a.shards) for a in self.assignments)

    def shards_of(self, node: int) -> tuple[int, ...]:
        for a in self.assignments:
            if a.node == node:
                return a.shards
        return ()


def initial_assignment(nodes: list[int], shards_per_node: int = 1) -> BatchPlan:
    """Node i owns shards [i*spn, (i+1)*spn) — the no-fault layout."""
    asg = tuple(
        ShardAssignment(node=n, shards=tuple(
            i * shards_per_node + j for j in range(shards_per_node)))
        for i, n in enumerate(sorted(nodes))
    )
    return BatchPlan(assignments=asg, dropped_shards=(), policy="initial")


def reassign(
    plan: BatchPlan,
    failed: set[int],
    policy: str,
) -> BatchPlan:
    """Apply DROP or REBALANCE after ``failed`` nodes left the cluster."""
    survivors = [a for a in plan.assignments if a.node not in failed]
    orphans: list[int] = sorted(
        s for a in plan.assignments if a.node in failed for s in a.shards
    )
    if policy == "drop" or not survivors:
        return BatchPlan(
            assignments=tuple(survivors),
            dropped_shards=tuple(sorted(set(plan.dropped_shards) | set(orphans))),
            policy="drop",
        )
    if policy == "rebalance":
        buckets: dict[int, list[int]] = {a.node: list(a.shards) for a in survivors}
        order = sorted(buckets, key=lambda n: (len(buckets[n]), n))
        for i, shard in enumerate(orphans):
            buckets[order[i % len(order)]].append(shard)
        return BatchPlan(
            assignments=tuple(
                ShardAssignment(node=n, shards=tuple(sorted(buckets[n])))
                for n in sorted(buckets)
            ),
            dropped_shards=plan.dropped_shards,
            policy="rebalance",
        )
    raise ValueError(f"unknown batch policy {policy!r}")


def substitute_assign(plan: BatchPlan, mapping: dict[int, int]) -> BatchPlan:
    """Blocking substitution: each failed node's shards move wholesale to
    its substitute (exact capacity restoration — the counter-based pipeline
    regenerates them bit-exactly on the new owner)."""
    if not mapping:
        return plan
    assignments = tuple(sorted(
        (ShardAssignment(node=mapping.get(a.node, a.node), shards=a.shards)
         for a in plan.assignments),
        key=lambda a: a.node,
    ))
    return BatchPlan(assignments=assignments,
                     dropped_shards=plan.dropped_shards,
                     policy="substitute")


def restore_rank(plan: BatchPlan, node: int,
                 shards: tuple[int, ...] | None = None) -> BatchPlan:
    """Non-blocking substitution, deferred half: return capacity to a
    restored rank. Under DROP the orphaned shards are sitting in
    ``dropped_shards`` — the restored node takes back *its* shards
    (``shards``, the failed slot's assignment at fault time; shards dropped
    for other, never-substituted failures stay dropped). Under REBALANCE
    nothing was dropped, so the restored node pulls shards back from the
    most-loaded survivors until the spread is <= 1 (the inverse of the
    round-robin handout)."""
    if any(a.node == node for a in plan.assignments):
        raise ValueError(f"node {node} already holds an assignment")
    pool = set(plan.dropped_shards)
    take = sorted(pool if shards is None else pool & set(shards))
    if take:
        assignments = plan.assignments + (
            ShardAssignment(node=node, shards=tuple(take)),)
        return BatchPlan(
            assignments=tuple(sorted(assignments, key=lambda a: a.node)),
            dropped_shards=tuple(sorted(pool - set(take))),
            policy="substitute",
        )
    buckets: dict[int, list[int]] = {a.node: list(a.shards)
                                     for a in plan.assignments}
    buckets[node] = []
    while True:
        donor = max(buckets, key=lambda n: (len(buckets[n]), -n))
        if len(buckets[donor]) - len(buckets[node]) <= 1 or donor == node:
            break
        buckets[node].append(buckets[donor].pop())
    return BatchPlan(
        assignments=tuple(
            ShardAssignment(node=n, shards=tuple(sorted(buckets[n])))
            for n in sorted(buckets)
        ),
        dropped_shards=plan.dropped_shards,   # unclaimed drops stay recorded
        policy="substitute",
    )


def validate_plan(plan: BatchPlan, view) -> None:
    """Cross-check a batch plan against a :class:`TopologyView` snapshot —
    the structural half of the epoch discipline: at the moment a collective
    reads the topology, every assigned node must exist in the snapshot and
    no shard may be double-assigned or simultaneously assigned and dropped.
    Raises ``ValueError`` on the first violation."""
    nodes = set(view.nodes)
    seen: set[int] = set()
    for a in plan.assignments:
        if a.node not in nodes:
            raise ValueError(
                f"plan assigns shards to node {a.node} which is not in the "
                f"topology snapshot (epoch {getattr(view, 'epoch', '?')})")
        dup = seen.intersection(a.shards)
        if dup:
            raise ValueError(f"shards {sorted(dup)} assigned twice")
        seen.update(a.shards)
    overlap = seen.intersection(plan.dropped_shards)
    if overlap:
        raise ValueError(
            f"shards {sorted(overlap)} both assigned and dropped")


def gradient_scale(plan: BatchPlan, total_shards: int) -> float:
    """Weight for the gradient mean so the estimator renormalizes over the
    shards actually computed (DROP shrinks the denominator)."""
    active = plan.active_shards
    if active == 0:
        return 0.0
    return float(total_shards) / float(active)
