"""What every cell shares: the files found by name, the seeded inputs, the
program's weights, the checks that decide ``correct``, and the reduction
of a profiler trace.

Nothing here imports the program or torch at import time: the drivers do,
inside their ``run``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the top-level module names no run may hold: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# PyTorch's operators that launch a GEMM
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
# the prefixes of the program's profiler regions that ``regions_ms`` charges
REGIONS = ("model.", "optim.")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file, whatever characters its name has (a metric's
    name carries a dot)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) of a cell, by name."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       + ", ".join(w["name"] for w in bench["workloads"]))
    work = found[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    return work, load_json(ROOT / conf["file"]), traffic(work["traffic"])


def cell_file(name: str) -> dict:
    """A cell's own file (``workloads/<cell>.json``): the limits of
    ``correct`` and, for a served cell, how many batches it checks."""
    return load_json(BENCH / "workloads" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def driver(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py")


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py")


def reference(name: str):
    return load_module(BENCH / "reference" / f"{name}.py")


def metrics_of(bench: dict, section: str, cell_name: str) -> list[dict]:
    """The metrics of ``section`` that ``cell_name`` reports."""
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def subseed(seed: int, *tags: int) -> int:
    """A seed for one use of the run's seed, below 2**63."""
    h = seed % (1 << 63)
    for t in tags:
        h = (h * 0x100000001B3 + t + 0x9E3779B97F4A7C15) % (1 << 63)
    return h


def p95(values: list[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def median(values: list[float]) -> float | None:
    return statistics.median(values) if values else None


def recover_ms(trace: dict, walls: list[dict] | None) -> float | None:
    """The repair's step or round, less the median steady one after it
    that was not profiled, in ms."""
    r = trace.get("repair_at")
    if walls is None or r is None:
        return None
    lo, hi = trace["traced"]
    steady = [w["wall_s"] for i, w in enumerate(walls)
              if i > r and not w["repair"] and not lo <= i < hi]
    if not steady:
        return None
    return (walls[r]["wall_s"] - statistics.median(steady)) * 1e3


class Context:
    """What a driver gets: the cell's configuration, traffic and own file
    (the limits of ``correct``), the run's seed, length and trace flag, the device, a
    planted fault and the control (``control.py`` only), and the clock that
    ends set-up."""

    def __init__(self, *, seed: int, seconds: float, trace: bool, config: dict,
                 traffic: dict, device, cell: dict, t0: float,
                 fault: str | None = None, control: bool = False):
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.config, self.traffic, self.device = config, traffic, device
        self.cell, self.limits = cell, cell["limits"]
        self.fault, self.control = fault, control
        self.t0 = t0
        self.setup_s = None

    def setup_done(self) -> None:
        import time

        self.setup_s = time.perf_counter() - self.t0


@dataclass
class Check:
    """One number compared with its limit: it passes while ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def make_weights(torch, layout: dict, seed: int, device) -> dict:
    """The seeded weights, ``path: tensor``: one normal draw per dtype on
    ``device`` (a generator there), each leaf a view of it, scaled and
    shifted in place."""
    by_dtype: dict[str, list[str]] = {}
    for path, (_, dt, _, _) in layout.items():
        by_dtype.setdefault(dt, []).append(path)
    out = {}
    for i, (dt, paths) in enumerate(sorted(by_dtype.items())):
        gen = torch.Generator(device=device).manual_seed(subseed(seed, 1, i))
        sizes = [math.prod(layout[p][0]) for p in paths]
        flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=getattr(torch, dt))
        at = 0
        for p, n in zip(paths, sizes):
            shape, _, mean, std = layout[p]
            w = flat[at:at + n].view(shape)
            w.mul_(std)
            if mean:
                w.add_(mean)
            out[p] = w
            at += n
    return out


def leaf(tree: dict, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def nest(flat: dict) -> dict:
    """``{"a.b": t}`` -> ``{"a": {"b": t}}``."""
    out: dict = {}
    for path, t in flat.items():
        *head, last = path.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = t
    return out


def flat_paths(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for k in sorted(tree):
        p = f"{prefix}{k}"
        out += flat_paths(tree[k], p + ".") if isinstance(tree[k], dict) else [p]
    return out


def copy_into(torch, program: dict, weights: dict) -> None:
    """Write the seeded weights into the program's own parameter tensors.
    Its tree must hold the same leaves, shapes and dtypes."""
    have = set(flat_paths(program))
    if have != set(weights):
        raise ValueError(f"the program's parameters {sorted(have ^ set(weights))} differ "
                         "from the benchmark's layout")
    with torch.no_grad():
        for path, w in weights.items():
            t = leaf(program, path)
            if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
                raise ValueError(f"{path}: the program holds {tuple(t.shape)} {t.dtype}, "
                                 f"the benchmark draws {tuple(w.shape)} {w.dtype}")
            t.copy_(w)


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

def _union_us(spans: list[tuple[float, float]]) -> float:
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _covered_us(starts: list[float], spans: list[tuple[float, float]], lo: float,
                hi: float) -> float:
    """The union of the (sorted) ``spans`` clipped to [lo, hi)."""
    import bisect

    i = max(0, bisect.bisect_left(starts, lo) - 1)
    clipped = []
    while i < len(spans) and spans[i][0] < hi:
        s, e = max(spans[i][0], lo), min(spans[i][1], hi)
        if e > s:
            clipped.append((s, e))
        i += 1
    return _union_us(clipped)


def _regions_ms(records) -> dict[str, float]:
    """Device ms by the program region that launched each operation
    (``reduce_trace``'s ``regions_ms``), from the profiler's own records
    (``prof.profiler.kineto_results.events()``): a ``FunctionEvent`` carries
    no link to its launch in every torch, a record does."""
    import bisect

    from torch.autograd import DeviceType

    device, ops, regions = [], {}, {}
    for e in records:
        if e.is_hidden_event():
            continue
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith("bench."):
                device.append(e)
        elif not e.linked_correlation_id() and e.correlation_id():
            # a host operation (a runtime call is linked to its operation)
            ops[e.correlation_id()] = e
            if e.name().startswith(REGIONS):
                regions.setdefault(e.start_thread_id(), []).append(e)
    # each thread's regions by start, the enclosing one first, and each
    # one's enclosing region (-1 at the top)
    nested = {}
    for thread, rs in regions.items():
        rs = sorted(((r.start_ns(), r.end_ns(), r.name()) for r in rs),
                    key=lambda r: (r[0], -r[1]))
        parent, stack = [], []
        for i, (start, _, _) in enumerate(rs):
            while stack and rs[stack[-1]][1] <= start:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        nested[thread] = ([r[0] for r in rs], rs, parent)

    def region_of(op) -> str:
        """The innermost region around the operation on its thread: the
        operation itself where it is a region."""
        if op.start_thread_id() not in nested:
            return "unattributed"
        starts, rs, parent = nested[op.start_thread_id()]
        i = bisect.bisect_right(starts, op.start_ns()) - 1
        while i >= 0 and rs[i][1] < op.end_ns():
            i = parent[i]
        return rs[i][2] if i >= 0 else "unattributed"

    out: dict[str, float] = {}
    for d in device:
        op = ops.get(d.linked_correlation_id())
        name = "unattributed" if op is None else region_of(op)
        out[name] = out.get(name, 0.0) + (d.end_ns() - d.start_ns()) / 1e6
    return dict(sorted(out.items()))


def reduce_trace(torch, prof, *, vocab: int, window_s: float) -> dict:
    """What the per-layer readers take from a ``torch.profiler`` run:

    * ``busy_s``: the union of the device's operations (kernels, copies,
      sets) over the traced window, ``window_s`` its host-clock length;
    * ``ranges_ms``: for each of the harness's ``bench.*`` ranges, the
      device time of the operations inside the device-side span the
      profiler draws for it (one stream: what the range launched);
    * ``regions_ms``: the device ms of the operations, summed by the
      program's region that launched each. An operation is charged to the
      innermost ``model.*`` or ``optim.*`` region (``repro_torch.tracing.
      region``) open on the host thread that launched it when the runtime
      call that launched it began, or to ``"unattributed"`` where none was
      open. The charge follows the launch, not the kernel's run: the card
      runs behind the host, so a kernel that runs after its region closed
      still belongs to it. Kernel and launch are linked by the profiler's
      correlation ids, never by time on the device (the regions draw no
      device-side span): a device record's ``linked_correlation_id`` names
      the innermost host operation (an operator, a span or a region) open
      when its runtime call began, and the region is that operation, or
      the innermost region around it on its thread (host clock against
      host clock: the runtime call's own time stamp comes from another
      clock, and a launch at a region's very end can read past it). The
      parts sum to the operations' summed durations;
    * ``vocab_gemm_ms``: device ms of the GEMMs with the vocabulary as a
      dimension (the loss's logits, forward and backward);
    * ``breakdown``: the ten device operations that took most time, and the
      ten longest idle gaps, each named by the innermost ``bench.*`` range
      open on the host when it began.
    """
    from torch.autograd import DeviceType

    events = prof.events()
    device, dev_ranges, ranges = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            (dev_ranges if e.name.startswith("bench.") else device).append(e)
        elif e.name.startswith("bench."):
            ranges.append(e)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    starts = [s for s, _ in spans]
    busy_us = _union_us(spans)
    ranges_ms: dict[str, float] = {}
    for r in dev_ranges:
        us = _covered_us(starts, spans, r.time_range.start, r.time_range.end)
        ranges_ms[r.name] = ranges_ms.get(r.name, 0.0) + us / 1e3
    vocab_ms = 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA and e.name in GEMM_OPS:
            shapes = [s for s in (e.input_shapes or []) if isinstance(s, (list, tuple))]
            if any(vocab in s for s in shapes):
                vocab_ms += e.self_device_time_total / 1e3
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    gaps = []
    end = spans[0][1] if spans else 0.0
    for s, e in spans[1:]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for s, e in gaps[:10]:
        open_ = [r for r in ranges if r.time_range.start <= s < r.time_range.end]
        inner = min(open_, key=lambda r: r.time_range.end - r.time_range.start, default=None)
        named.append([inner.name if inner else "bench.outside", (e - s) / 1e6])
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "ranges_ms": ranges_ms,
            "regions_ms": _regions_ms(prof.profiler.kineto_results.events()),
            "vocab_gemm_ms": vocab_ms,
            "breakdown": {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}}


def idle_share(trace: dict, walls: list[dict]) -> float | None:
    """The share of a steady step or round in which the card runs nothing:
    the profiled stretch's device-busy seconds a step or round, over the
    median host wall of the steady ones after the repair that were not
    profiled (the profiler slows the host, not the card), in %."""
    lo, hi = trace["traced"]
    r = trace.get("repair_at")
    steady = [w["wall_s"] for i, w in enumerate(walls)
              if r is not None and i > r and not w["repair"] and not lo <= i < hi]
    if not steady or hi <= lo:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / (hi - lo) / statistics.median(steady))


def region_ms(trace: dict, region: str) -> float | None:
    """Device ms a traced step or round charged to the program's region
    ``region`` and the regions under it (``model.moe`` takes
    ``model.moe.route`` and its siblings): their ``regions_ms`` summed over
    the traced steps or rounds, over their count. None where the run charged
    none of them."""
    lo, hi = trace["traced"]
    ms = [v for k, v in trace["regions_ms"].items()
          if k == region or k.startswith(region + ".")]
    return sum(ms) / (hi - lo) if ms and hi > lo else None


def steady_rate(trace: dict, walls: list[dict]) -> float | None:
    """Model FLOP/s over the window's steady steps or rounds: neither the
    repair's nor the profiled ones (host clock, no profiler in them)."""
    lo, hi = trace["traced"]
    r = trace.get("repair_at")
    keep = [w for i, w in enumerate(walls) if i != r and not lo <= i < hi]
    wall = sum(w["wall_s"] for w in keep)
    return sum(w["flops"] for w in keep) / wall if wall > 0 else None


class Spans:
    """Wraps named attributes of modules or objects in ``bench.*`` ranges
    for the traced part of a run, and puts the originals back after. A
    wrapper may also record each call's arguments (``on_call``)."""

    def __init__(self, torch):
        self.torch = torch
        self.saved: list[tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, label: str, on_call=None) -> None:
        fn = getattr(owner, attr)
        record_function = self.torch.profiler.record_function

        def wrapper(*args, **kwargs):
            if on_call is not None:
                on_call(*args, **kwargs)
            with record_function(label):
                return fn(*args, **kwargs)

        self.saved.append((owner, attr, owner.__dict__.get(attr, _MISSING)
                           if hasattr(owner, "__dict__") else fn))
        setattr(owner, attr, wrapper)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self.saved):
            if fn is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self.saved.clear()


_MISSING = object()
