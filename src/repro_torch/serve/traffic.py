"""Open-loop traffic generation — seeded Poisson arrivals with diurnal and
burst profiles, per-request SLO classes, and a user population in the
millions.

"Open loop" means arrivals do not wait for the system: the generator emits
whatever the rate function says for a simulated-time window, regardless of
how deep the queues already are. That is the load model under which
admission control and continuous batching earn their keep — a lock-step
engine whose rounds stretch to the slowest in-flight batch accumulates
proportionally more arrivals per round, which is exactly the tail-latency
blowup the load-curve benchmark measures.

Everything is driven by one ``numpy`` Generator seeded at construction:
the same seed and the same sequence of :meth:`arrivals` windows produce a
byte-identical request stream, so benchmarks and the dispatch-determinism
property test can compare whole traces across runs.

    gen = TrafficGenerator(rate=40.0, seed=7, bursts=(Burst(20.0, 30.0, 3.0),))
    while serving:
        engine.submit(gen.arrivals(t_prev, t_now))   # sim-time window
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np

__all__ = ["Arrival", "Burst", "SLOClass", "TrafficGenerator",
           "DEFAULT_SLO_CLASSES"]


@dataclass(frozen=True)
class SLOClass:
    """One request class: its deadline, traffic share, and service shape."""

    name: str
    slo_seconds: float              # deadline from arrival; inf = no SLO
    share: float                    # fraction of traffic
    decode_ticks: tuple[int, int]   # inclusive [lo, hi] decode length range
    prefill_ticks: int = 1


# interactive traffic is short and tight; batch is long and deadline-less —
# the spread is what makes slack scheduling and the phase split observable
DEFAULT_SLO_CLASSES = (
    SLOClass("interactive", slo_seconds=12.0, share=0.50,
             decode_ticks=(1, 2)),
    SLOClass("standard", slo_seconds=40.0, share=0.35,
             decode_ticks=(2, 6)),
    SLOClass("batch", slo_seconds=math.inf, share=0.15,
             decode_ticks=(8, 16)),
)


@dataclass(frozen=True)
class Burst:
    """A transient rate spike: multiply the base rate inside [start, end)."""

    start: float
    end: float
    multiplier: float


@dataclass(frozen=True)
class Arrival:
    """One generated request, ready for ``ServeEngine.submit``."""

    user: int
    slo_class: str
    slo_seconds: float
    prefill_ticks: int
    decode_ticks: int
    payload: Any = None


class TrafficGenerator:
    """Seeded open-loop arrival process over a simulated-seconds clock.

    ``rate`` is the mean arrivals per simulated second; the instantaneous
    rate is modulated by a diurnal sinusoid (``diurnal_amplitude`` around
    the mean, period ``diurnal_period`` seconds) and any active
    :class:`Burst` windows. Each arrival draws a user id from a
    ``n_users``-sized population (default two million simulated users) and
    an :class:`SLOClass` by traffic share, then a decode length uniform in
    the class's range.
    """

    def __init__(self, rate: float, *, seed: int = 0,
                 n_users: int = 2_000_000,
                 diurnal_amplitude: float = 0.0,
                 diurnal_period: float = 1440.0,
                 bursts: tuple[Burst, ...] = (),
                 classes: tuple[SLOClass, ...] = DEFAULT_SLO_CLASSES):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        if not 0.0 <= diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if abs(sum(c.share for c in classes) - 1.0) > 1e-6:
            raise ValueError("SLO class shares must sum to 1")
        self.rate = rate
        self.n_users = n_users
        self.diurnal_amplitude = diurnal_amplitude
        self.diurnal_period = diurnal_period
        self.bursts = tuple(bursts)
        self.classes = tuple(classes)
        self._shares = np.asarray([c.share for c in classes], dtype=float)
        self._shares = self._shares / self._shares.sum()
        self._rng = np.random.default_rng(seed)
        self.generated = 0

    # -- the rate function ---------------------------------------------------

    def rate_at(self, t: float) -> float:
        """Instantaneous arrivals-per-second at simulated time ``t``."""
        r = self.rate * (1.0 + self.diurnal_amplitude
                         * math.sin(2.0 * math.pi * t / self.diurnal_period))
        for b in self.bursts:
            if b.start <= t < b.end:
                r *= b.multiplier
        return r

    # -- generation ----------------------------------------------------------

    def arrivals(self, t0: float, t1: float) -> list[Arrival]:
        """All arrivals in the window (t0, t1] — Poisson with the window's
        midpoint rate as intensity. Call with consecutive windows to walk
        the whole campaign deterministically."""
        if t1 <= t0:
            return []
        lam = self.rate_at((t0 + t1) / 2.0) * (t1 - t0)
        n = int(self._rng.poisson(lam))
        if n == 0:
            return []
        users = self._rng.integers(0, self.n_users, size=n)
        picks = self._rng.choice(len(self.classes), size=n, p=self._shares)
        out = []
        for user, ci in zip(users, picks):
            cls = self.classes[int(ci)]
            lo, hi = cls.decode_ticks
            decode = int(self._rng.integers(lo, hi + 1))
            out.append(Arrival(
                user=int(user), slo_class=cls.name,
                slo_seconds=cls.slo_seconds,
                prefill_ticks=cls.prefill_ticks, decode_ticks=decode))
        self.generated += n
        return out
