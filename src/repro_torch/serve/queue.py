"""Per-legion work queues — the unit of request ownership.

A request belongs to exactly one legion queue at a time (or to a node's
in-flight window, or to the completed map — never two of these at once; the
engine's accounting test walks every round asserting it). Queues are FIFO
with two exceptions:

  * a re-enqueued request (its node died mid-batch) goes to the *front*,
    so redelivery latency does not compound the fault latency;
  * when any queued request carries a deadline, :meth:`pop_batch` selects
    by SLO slack (earliest-deadline-first over remaining service) instead
    of pure arrival order — ties keep queue order, so the schedule is
    deterministic and deadline-less requests stay FIFO among themselves.

Requests also carry their continuous-batching service spec: a prefill
phase (``prefill_ticks``) followed by a decode phase (``decode_ticks``),
each advanced one simulated tick at a time by the engine. Progress
(``prefill_done``/``decode_done``) travels *with* the request, which is
what makes decode-state migration possible — a request whose node died
mid-decode re-enters a queue with its decode progress intact and only the
remaining ticks left to serve.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Request:
    """One client request flowing through the serve subsystem.

    ``rid`` is the client-visible identity the dedup guard keys on;
    ``attempts`` counts deliveries (1 = never touched a failed node).
    The default service spec (1 prefill tick, 0 decode ticks) completes in
    the round it is dispatched — the pre-continuous-batching behavior.
    """

    rid: int
    payload: Any = None
    enqueue_step: int = 0
    attempts: int = 0
    legion: int | None = None      # current owning legion (router-assigned)
    # service spec (ticks of LegioPolicy.step_sim_seconds each)
    prefill_ticks: int = 1
    decode_ticks: int = 0
    # SLO surface (admission control + slack scheduling read these)
    slo_class: str = "standard"
    deadline_sim: float = math.inf
    user: int = -1
    arrival_sim: float = 0.0
    # phase progress — migrates across redeliveries when the node dies
    # mid-decode (serve_migrate_decode)
    prefill_done: int = 0
    decode_done: int = 0
    migrations: int = 0

    @property
    def service_ticks_remaining(self) -> int:
        return (self.prefill_ticks - self.prefill_done) \
            + (self.decode_ticks - self.decode_done)

    def slack(self, now: float, tick_seconds: float) -> float:
        """Seconds to spare if served immediately; infinite without an SLO."""
        return self.deadline_sim - now \
            - self.service_ticks_remaining * tick_seconds


@dataclass
class LegionQueue:
    """Request queue owned by one legion: FIFO, front-push redelivery, and
    slack-ordered batch forming once deadlines are present."""

    legion: int
    _q: deque = field(default_factory=deque)
    _deadlined: int = 0         # queued requests carrying a finite deadline
    _ticks: int = 0             # queued service ticks (admission feasibility)

    def push(self, req: Request) -> None:
        req.legion = self.legion
        self._q.append(req)
        self._account(req, +1)

    def push_front(self, req: Request) -> None:
        """Redelivery path: re-enqueued requests skip the line."""
        req.legion = self.legion
        self._q.appendleft(req)
        self._account(req, +1)

    def _account(self, req: Request, sign: int) -> None:
        if math.isfinite(req.deadline_sim):
            self._deadlined += sign
        self._ticks += sign * req.service_ticks_remaining

    @property
    def has_deadlines(self) -> bool:
        return self._deadlined > 0

    @property
    def pending_ticks(self) -> int:
        """Total service ticks queued — the admission-control backlog."""
        return self._ticks

    def pop_batch(self, n: int,
                  key: "Callable[[Request], float] | None" = None
                  ) -> list[Request]:
        """Take up to ``n`` requests. FIFO without ``key``; with ``key``
        (SLO slack), the ``n`` smallest-key requests leave first — ties
        keep queue order, so front-pushed redeliveries retain priority
        among equals and the schedule is byte-identical across runs."""
        if key is not None and len(self._q) > 1:
            order = sorted(range(len(self._q)),
                           key=lambda i: (key(self._q[i]), i))[:n]
            take = [self._q[i] for i in order]
            picked = set(order)
            self._q = deque(r for i, r in enumerate(self._q)
                            if i not in picked)
        else:
            take = []
            while self._q and len(take) < n:
                take.append(self._q.popleft())
        for req in take:
            self._account(req, -1)
        return take

    def drain(self) -> list[Request]:
        """Empty the queue (legion left the ring — requests re-route)."""
        out = list(self._q)
        self._q.clear()
        self._deadlined = 0
        self._ticks = 0
        return out

    def __len__(self) -> int:
        return len(self._q)
