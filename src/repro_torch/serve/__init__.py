"""repro_torch.serve — fault-resilient request serving (the Legio shape, served).

Legio's target class is embarrassingly parallel work where failed nodes are
discarded and the survivors keep going; a request-serving fleet is exactly
that shape. This package promotes serving to a first-class subsystem over
the same recovery stack training uses:

  * :class:`RequestRouter` (router) — shards the request stream across
    legions via the topology masters, least-loaded first with fully
    deterministic tie-breaks, and re-homes queues when a repair changes
    the ring;
  * :class:`LegionQueue` / :class:`Request` (queue) — per-legion work
    queues; FIFO until deadlines appear, then slack-ordered; requests
    carry their prefill/decode service spec and phase progress;
  * :class:`MicroBatcher` (batcher) — per-slot batches sized by
    ``LegioPolicy.serve_microbatch``, deadline-aware composition;
  * :class:`ServeEngine` (engine) — continuous batching: per-legion
    in-flight windows admit new micro-batches the moment a slot frees,
    independent of other legions' progress or in-flight repairs; a
    prefill/decode phase split with separate cost accounting; SLO-keyed
    admission control; and decode-state migration off dead nodes through
    the FaultPipeline listener path. The lock-step barrier loop survives
    as the measurable baseline (``continuous=False``);
  * :class:`TrafficGenerator` (traffic) — seeded open-loop Poisson
    arrivals with diurnal/burst profiles and per-request SLO classes over
    a millions-strong simulated user population;
  * :class:`ServeMetrics` (metrics) — latency percentiles in rounds and
    simulated-clock seconds, goodput, SLO attainment, per-phase ticks,
    and starvation accounting.

Invariants the tests assert (tests/test_serve.py + the chaos harness):

  * **at-least-once re-enqueue** — a request on a failed node is always
    redelivered (or explicitly parked/abandoned/shed), never silently
    lost;
  * **exactly-once completion** — the dedup guard collapses redeliveries
    (including migrated decode states), so the client observes one
    completion per request id;
  * **no stall on healthy legions** — serving overlaps repair; a healthy
    legion with backlog and a free window slot admits every round.
"""
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.engine import (
    RECOVERY_PRESETS,
    RoundReport,
    ServeEngine,
    ServeReport,
    recovery_preset,
)
from repro_torch.serve.metrics import CompletionRecord, ServeMetrics
from repro_torch.serve.queue import LegionQueue, Request
from repro_torch.serve.router import RequestRouter
from repro_torch.serve.traffic import (
    DEFAULT_SLO_CLASSES,
    Arrival,
    Burst,
    SLOClass,
    TrafficGenerator,
)

__all__ = [
    "Arrival", "Burst", "CompletionRecord", "DEFAULT_SLO_CLASSES",
    "LegionQueue", "MicroBatcher", "RECOVERY_PRESETS", "Request",
    "RequestRouter", "RoundReport", "SLOClass", "ServeEngine",
    "ServeMetrics", "ServeReport", "TrafficGenerator", "recovery_preset",
]
