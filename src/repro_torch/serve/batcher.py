"""Micro-batcher — turns a legion queue into per-node dispatch batches.

Batch size comes from ``LegioPolicy.serve_microbatch``: each free window
slot admits up to that many requests. Smaller batches bound the blast
radius of a fault (at most ``serve_microbatch`` requests ride on any one
slot) at the cost of more dispatch rounds; the serve_latency benchmark
sweeps the trade.

Batch *composition* is deadline-aware: once any queued request carries an
SLO deadline, :meth:`form_one` hands the queue a slack key (deadline minus
now minus remaining service) and the queue yields the tightest requests
first — earliest-deadline-first over remaining work, instead of pure FIFO.
Deadline-less queues stay strictly FIFO, so the legacy dispatch order is
byte-identical to the pre-SLO engine.
"""
from __future__ import annotations

from repro_torch.serve.queue import LegionQueue, Request


class MicroBatcher:
    """Stateless batch former: policy-sized, slack-ordered queue slices."""

    def __init__(self, microbatch: int):
        if microbatch <= 0:
            raise ValueError(f"microbatch must be positive, got {microbatch}")
        self.microbatch = microbatch

    def form_one(self, queue: LegionQueue, *, now: float = 0.0,
                 tick_seconds: float = 1.0) -> list[Request]:
        """One micro-batch for one free window slot. SLO slack orders the
        pick when the queue holds any deadlined request; otherwise FIFO."""
        key = None
        if queue.has_deadlines:
            key = lambda r: r.slack(now, tick_seconds)    # noqa: E731
        return queue.pop_batch(self.microbatch, key=key)

    def form(self, queue: LegionQueue,
             members: list[int]) -> dict[int, list[Request]]:
        """One batch per live member, in member order — the lock-step
        baseline's dispatch (and the legacy surface): the queue keeps
        anything beyond this round's capacity."""
        batches: dict[int, list[Request]] = {}
        for node in members:
            batch = queue.pop_batch(self.microbatch)
            if not batch:
                break
            batches[node] = batch
        return batches
