"""Serving metrics — latency percentiles, goodput, SLO attainment, and
per-phase cost accounting.

Latency is recorded twice per completion: in *rounds* (the legacy unit)
and in *simulated-clock seconds* (``arrival_sim`` → ``complete_sim``, the
cluster's deterministic clock). The sim-seconds numbers are what the
load-curve benchmark asserts on — they are byte-identical across runs
given a seeded campaign, per the repo's structural-benchmark convention —
while wall time (the round's ``serve.round`` span, :mod:`repro_torch.tracing`)
is kept alongside per round for human inspection only, never for pass/fail.

The continuous-batching engine also feeds:

  * **phase accounting** — every prefill tick and decode tick lands in
    ``phase_ticks`` separately, so the prefill/decode cost split is a
    first-class number (and decode-state migration shows up directly as
    decode ticks *not* re-spent);
  * **admission outcomes** — ``shed`` (rejected at the door by SLO
    feasibility) next to the delivery ledger's ``parked``/``abandoned``;
  * **starvation** — a round where a legion had backlog *and* free window
    slots yet admitted nothing. Zero for healthy legions is the
    no-stall acceptance bar (``stalled_rounds`` keeps the legacy
    dispatch-trace view: with multi-tick service a busy window
    legitimately admits nothing, which is not a stall).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class CompletionRecord:
    rid: int
    enqueue_step: int
    complete_step: int
    attempts: int
    legion: int
    node: int
    arrival_sim: float = 0.0
    complete_sim: float = 0.0
    slo_class: str = "standard"
    deadline_sim: float = math.inf
    migrated: bool = False         # decode progress survived a node death

    @property
    def latency_rounds(self) -> int:
        return self.complete_step - self.enqueue_step

    @property
    def latency_sim(self) -> float:
        return self.complete_sim - self.arrival_sim

    @property
    def met_slo(self) -> bool:
        return self.complete_sim <= self.deadline_sim


@dataclass
class ServeMetrics:
    completions: list[CompletionRecord] = field(default_factory=list)
    requeues: int = 0                    # redeliveries (at-least-once cost)
    duplicates_suppressed: int = 0       # dedup guard hits
    parked: list[int] = field(default_factory=list)   # hit serve_max_attempts
    abandoned: list[int] = field(default_factory=list)  # DROP policy losses
    shed: list[int] = field(default_factory=list)     # admission rejections
    migrations: int = 0                  # decode states moved off dead nodes
    decode_ticks_preserved: int = 0      # decode work migration did not redo
    # per-phase cost split (ticks of step_sim_seconds each)
    phase_ticks: dict[str, int] = field(
        default_factory=lambda: {"prefill": 0, "decode": 0})
    # per-round dispatch counts: step -> {legion: n_requests_dispatched}
    dispatch_trace: dict[int, dict[int, int]] = field(default_factory=dict)
    # backlog + free capacity but nothing admitted: step -> [legions]
    starvation_trace: dict[int, list[int]] = field(default_factory=dict)
    # per-round duration, sim seconds and wall seconds side by side
    round_seconds: dict[int, dict[str, float]] = field(default_factory=dict)

    # -- recording -----------------------------------------------------------

    def record_dispatch(self, step: int, legion: int, n: int) -> None:
        row = self.dispatch_trace.setdefault(step, {})
        row[legion] = row.get(legion, 0) + n

    def record_starved(self, step: int, legion: int) -> None:
        self.starvation_trace.setdefault(step, []).append(legion)

    def record_round(self, step: int, sim: float, wall: float) -> None:
        self.round_seconds[step] = {"sim": sim, "wall": wall}

    def record_completion(self, rec: CompletionRecord) -> None:
        self.completions.append(rec)

    def record_phase_tick(self, phase: str, n: int = 1) -> None:
        self.phase_ticks[phase] += n

    # -- aggregates ----------------------------------------------------------

    def latency_percentile(self, p: float,
                           legions: set[int] | None = None,
                           unit: str = "rounds") -> float:
        """p-th percentile of completion latency (nearest-rank method),
        optionally restricted to requests completed by the given legions.
        ``unit`` is "rounds" (legacy) or "sim" (simulated-clock seconds —
        the deterministic number the benchmarks assert on)."""
        if unit not in ("rounds", "sim"):
            raise ValueError(f"unit must be 'rounds' or 'sim', got {unit!r}")
        lat = sorted(
            (r.latency_rounds if unit == "rounds" else r.latency_sim)
            for r in self.completions
            if legions is None or r.legion in legions)
        if not lat:
            return 0.0
        rank = min(len(lat) - 1, max(0, int(round(p / 100.0 * len(lat))) - 1))
        return float(lat[rank])

    def goodput(self, rounds: int) -> float:
        """Completed requests per round over the campaign."""
        return len(self.completions) / rounds if rounds else 0.0

    def goodput_sim(self, sim_seconds: float) -> float:
        """Completed requests per simulated second — the number that stays
        comparable when round durations differ (lock-step rounds stretch
        to their slowest in-flight batch)."""
        return len(self.completions) / sim_seconds if sim_seconds else 0.0

    def slo_attainment(self) -> float:
        """Fraction of completions that met their deadline (deadline-less
        requests count as met)."""
        if not self.completions:
            return 1.0
        return sum(1 for r in self.completions if r.met_slo) \
            / len(self.completions)

    def stalled_rounds(self, legion: int, first: int, last: int) -> int:
        """Rounds in [first, last] where ``legion`` dispatched nothing.
        Zero for a healthy legion with pending work and single-tick
        service — with multi-tick service prefer :meth:`starved_rounds`,
        which only counts rounds where free capacity went unused."""
        return sum(1 for step in range(first, last + 1)
                   if self.dispatch_trace.get(step, {}).get(legion, 0) == 0)

    def starved_rounds(self, legion: int | None = None) -> int:
        """Rounds where a legion (or any, with ``None``) had backlog and a
        free window slot yet admitted nothing — the continuous-batching
        no-stall acceptance metric; must be zero for healthy legions."""
        return sum(
            1 for legions in self.starvation_trace.values()
            for lg in legions if legion is None or lg == legion)

    def summary(self, rounds: int) -> dict:
        return {
            "completed": len(self.completions),
            "requeues": self.requeues,
            "duplicates_suppressed": self.duplicates_suppressed,
            "parked": len(self.parked),
            "abandoned": len(self.abandoned),
            "shed": len(self.shed),
            "migrations": self.migrations,
            "decode_ticks_preserved": self.decode_ticks_preserved,
            "prefill_ticks": self.phase_ticks["prefill"],
            "decode_ticks": self.phase_ticks["decode"],
            "p50_latency_rounds": self.latency_percentile(50),
            "p99_latency_rounds": self.latency_percentile(99),
            "p50_latency_sim": self.latency_percentile(50, unit="sim"),
            "p99_latency_sim": self.latency_percentile(99, unit="sim"),
            "p999_latency_sim": self.latency_percentile(99.9, unit="sim"),
            "slo_attainment": round(self.slo_attainment(), 4),
            "starved_rounds": self.starved_rounds(),
            "max_attempts_seen": max((r.attempts for r in self.completions),
                                     default=0),
            "goodput_rps": self.goodput(rounds),
        }
