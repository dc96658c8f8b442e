"""What the ``program_span`` readers share: the program's own spans
(``repro_torch.tracing``) of a run's window, read after the run in its
process.

Window step ``i`` is the trainer's step ``setup_steps + i`` (the set-up
steps come first); window round ``i`` is the engine's step
``trace["rounds"][i]["step"]``. The top span of a step or round
(``train.step``, ``serve.round``) carries that number as ``step``; where
several do (earlier runs in one process), the newest counts. A child span
is found through its parent chain, not by a number of its own.

Host-clock readings take the steady steps or rounds: neither the repair's
nor the profiled ones (the profiler slows the host).

Where the program keeps no spans (a checkout without
``repro_torch.tracing``), every reading is None.
"""
from __future__ import annotations

import statistics

TOP = {"train": "train.step", "serve": "serve.round"}


def window(trace: dict, ctx) -> dict[int, tuple] | None:
    """``{i: (top span, [the spans under it])}`` for the window's steps or
    rounds that the program's ring still holds; None without a tracer."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    kind = trace["kind"]
    if kind == "train":
        numbers = [ctx.traffic["setup_steps"] + i for i in range(len(trace["steps"]))]
    else:
        numbers = [r["step"] for r in trace["rounds"]]
    records = tracing.spans()
    newest = {}
    for rec in records:
        if rec.name == TOP[kind] and "step" in rec.attrs:
            newest[rec.attrs["step"]] = rec
    at = {id(newest[n]): i for i, n in enumerate(numbers) if n in newest}
    out = {i: (newest[n], []) for i, n in enumerate(numbers) if n in newest}
    for rec in records:
        p = rec.parent
        while p is not None:
            i = at.get(id(p))
            if i is not None:
                out[i][1].append(rec)
                break
            p = p.parent
    return out


def ms_under(entry: tuple, name: str) -> float:
    """Host ms of the spans called ``name`` under a step or round, summed."""
    return sum(r.ms for r in entry[1] if r.name == name)


def steady(trace: dict, spans: dict[int, tuple]) -> list[int]:
    """The window's steps or rounds that neither carried the repair nor ran
    under the profiler, of those the ring holds."""
    lo, hi = trace["traced"]
    return [i for i in sorted(spans) if i != trace.get("repair_at") and not lo <= i < hi]


def repair_ms(trace: dict, ctx) -> float | None:
    """Host ms of the fault pipeline's drains (``pipeline.drain``, detect
    to apply and the listeners) under the window's repair step or round."""
    spans = window(trace, ctx)
    r = trace.get("repair_at")
    if spans is None or r not in spans:
        return None
    drains = [d.ms for d in spans[r][1] if d.name == "pipeline.drain"]
    return sum(drains) if drains else None


def median_steady(trace: dict, ctx, name: str) -> float | None:
    """The median over the steady steps or rounds of the host ms their
    spans called ``name`` take, summed a step or round."""
    spans = window(trace, ctx)
    if spans is None:
        return None
    values = [ms_under(spans[i], name) for i in steady(trace, spans)
              if any(r.name == name for r in spans[i][1])]
    return statistics.median(values) if values else None
