"""Device ms by program region (``harness.reduce_trace``'s ``regions_ms``)
on a synthetic profiler trace, the reducer's other outputs against a copy
of the reducer as it was before ``regions_ms``, the region metrics'
entries, and their readers."""
import json
import math
from types import SimpleNamespace

import pytest

from bench import harness

B = harness.benchmark()
# name: (layer, moves, cells, region)
REGION_METRICS = {
    "attention_ms.serve": ("attention mixer", "serve_tokens_per_s", ["mixtral-serve"],
                           "model.attention"),
    "moe_ms.serve": ("MoE FFN", "serve_tokens_per_s", ["mixtral-serve"], "model.moe"),
    "attention_ms.serve.hymba": ("attention mixer", "serve_tokens_per_s.hymba",
                                 ["hymba-serve", "granite-serve"], "model.attention"),
    "ssd_ms.serve.hymba": ("Mamba-2 mixer", "serve_tokens_per_s.hymba",
                           ["hymba-serve", "granite-serve"], "model.ssd"),
    "mlp_ms.serve.hymba": ("dense MLP", "serve_tokens_per_s.hymba", ["hymba-serve"],
                           "model.mlp"),
    "moe_ms.serve.hymba": ("MoE FFN", "serve_tokens_per_s.hymba", ["granite-serve"],
                           "model.moe"),
}
VOCAB = 32000


def _event(name, start, end, *, thread=1, id=0, linked=0, cuda=False, shapes=(),
           device_us=0.0, own_thread=None):
    """A ``FunctionEvent`` as ``prof.events()`` gives it (µs from the
    trace's start); ``own_thread`` is a runtime call's system thread, which
    its profiler record keeps and the event replaces by its operation's."""
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=float(start), end=float(end)),
        thread=thread, id=id, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        input_shapes=[list(s) for s in shapes], self_device_time_total=device_us,
        linked=linked, own_thread=thread if own_thread is None else own_thread)


class _Record:
    """The profiler's record (``_KinetoEvent``) of an event (ns)."""

    def __init__(self, e):
        self.e = e

    def name(self):
        return self.e.name

    def device_type(self):
        return self.e.device_type

    def start_ns(self):
        return round(self.e.time_range.start * 1000) + 10**12

    def end_ns(self):
        return round(self.e.time_range.end * 1000) + 10**12

    def start_thread_id(self):
        return self.e.own_thread

    def correlation_id(self):
        return self.e.id

    def linked_correlation_id(self):
        return self.e.linked

    def is_hidden_event(self):
        return False


def _launch(name, op, call_at, run, cid, *, thread=1):
    """A runtime call at ``call_at`` (host µs) on behalf of host operation
    ``op`` (its id), and the device operation it launched, running over
    ``run``: both carry the call's correlation id ``cid``."""
    return [_event("cudaLaunchKernel", call_at, call_at + 2, thread=thread, id=cid, linked=op,
                   own_thread=40000 + thread),
            _event(name, *run, id=cid, linked=op, cuda=True, own_thread=7)]


def profiled(events):
    """A finished profiler over ``events``: ``events()`` and its records."""
    results = SimpleNamespace(events=lambda: [_Record(e) for e in events])
    return SimpleNamespace(events=lambda: events,
                           profiler=SimpleNamespace(kineto_results=results))


def synthetic_events():
    """One host thread serving a prefill under regions, a second thread
    launching beside it, and the card running behind both (µs)."""
    return [
        _event("serve.round", 0, 1000, id=1),
        _event("bench.serve.prefill", 5, 900, id=2),
        _event("bench.serve.prefill", 100, 1520, cuda=True),   # its device-side span
        _event("model.attention", 10, 300, id=3),
        _event("aten::mm", 20, 40, id=4, shapes=[(8, 64), (64, VOCAB)], device_us=100.0),
        *_launch("nvjet_gemm", 4, 25, (100, 200), 1001),
        _event("bench.kernel.flash", 50, 100, id=5),
        *_launch("attn_fwd_wgmma_64", 5, 60, (200, 400), 1002),
        _event("model.moe.route", 150, 250, id=6),
        _event("aten::add", 160, 170, id=7),
        *_launch("elementwise_add", 7, 162, (400, 430), 1003),
        # a host operation whose runtime call the trace lacks
        _event("aten::mul", 270, 280, id=8),
        _event("elementwise_mul", 430, 437, id=1008, linked=8, cuda=True),
        # launched straight under the region, run long after it closed
        _event("model.ssd", 320, 600, id=9),
        *_launch("chunk_output_kernel", 9, 330, (1300, 1500), 1004),
        # outside every region
        _event("aten::copy_", 700, 720, id=10),
        *_launch("Memcpy DtoH", 10, 705, (1505, 1510), 1005),
        # another thread, while thread 1 is inside model.attention, and a
        # region of its own later
        _event("aten::zero_", 30, 35, thread=2, id=11),
        *_launch("memset", 11, 31, (1510, 1511), 1006, thread=2),
        _event("model.mlp", 500, 600, thread=2, id=13),
        # a device operation linked to no host operation
        _event("stray_kernel", 1512, 1515, id=1007, cuda=True),
        # launched last in its region, the runtime call stamped (on the
        # profiler's other clock) past the region's end
        _event("model.moe.combine", 800, 820, id=12),
        *_launch("combine_kernel", 12, 821, (1516, 1520), 1009),
        # launched under a span after the region that opened with it closed
        _event("serve.decode", 900, 950, id=14),
        _event("model.ssd", 900, 920, id=15),
        *_launch("argmax_kernel", 14, 930, (1520, 1522), 1010),
    ]


EXPECTED_MS = {
    "model.attention": (100 + 200 + 7) / 1e3,
    "model.moe.route": 30 / 1e3,
    "model.ssd": 200 / 1e3,
    "model.moe.combine": 4 / 1e3,
    "unattributed": (5 + 1 + 3 + 2) / 1e3,
}


def reduce(events):
    import torch

    return harness.reduce_trace(torch, profiled(events), vocab=VOCAB, window_s=0.002)


def reduce_before(torch, prof, *, vocab: int, window_s: float) -> dict:
    """``harness.reduce_trace`` as it was before ``regions_ms``, verbatim."""
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
    busy_us = harness._union_us(spans)
    ranges_ms: dict[str, float] = {}
    for r in dev_ranges:
        us = harness._covered_us(starts, spans, r.time_range.start, r.time_range.end)
        ranges_ms[r.name] = ranges_ms.get(r.name, 0.0) + us / 1e3
    vocab_ms = 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA and e.name in harness.GEMM_OPS:
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
            "vocab_gemm_ms": vocab_ms,
            "breakdown": {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}}


def test_each_operation_goes_to_the_region_that_launched_it():
    assert reduce(synthetic_events())["regions_ms"] == pytest.approx(EXPECTED_MS, rel=1e-12)


@pytest.mark.parametrize("kernel, region", [
    ("elementwise_add", "model.moe.route"),       # nested regions: the innermost
    ("attn_fwd_wgmma_64", "model.attention"),     # under a bench.* range inside it
    ("elementwise_mul", "model.attention"),       # no runtime call: its host operation
    ("chunk_output_kernel", "model.ssd"),         # run after the region closed
    ("Memcpy DtoH", "unattributed"),              # launched outside every region
    ("memset", "unattributed"),                   # another thread's launch
    ("stray_kernel", "unattributed"),             # linked to nothing
    ("argmax_kernel", "unattributed"),            # under a span, after its region
    ("combine_kernel", "model.moe.combine"),      # its runtime call stamped past the end
])
def test_one_operation(kernel, region):
    from torch.autograd import DeviceType

    events = synthetic_events()
    keep = [e for e in events if e.device_type != DeviceType.CUDA or e.name == kernel]
    (only,) = [e for e in keep if e.name == kernel]
    ms = (only.time_range.end - only.time_range.start) / 1e3
    assert reduce(keep)["regions_ms"] == {region: pytest.approx(ms, rel=1e-12)}


def test_parts_sum_to_the_operations_total():
    from torch.autograd import DeviceType

    events = synthetic_events()
    total = sum(e.time_range.end - e.time_range.start for e in events
                if e.device_type == DeviceType.CUDA and not e.name.startswith("bench."))
    assert math.fsum(reduce(events)["regions_ms"].values()) == pytest.approx(total / 1e3,
                                                                             rel=1e-12)


def test_other_outputs_are_as_before():
    import torch

    events = synthetic_events()
    now = reduce(events)
    before = reduce_before(torch, profiled(events), vocab=VOCAB, window_s=0.002)
    assert set(now) == set(before) | {"regions_ms"}
    assert json.dumps({k: now[k] for k in before}) == json.dumps(before)
    assert now["vocab_gemm_ms"] == 0.1 and now["ranges_ms"]["bench.serve.prefill"] > 0


def test_a_cpu_profile_has_no_device_operations():
    """A real profiler run on the CPU: its events carry every field the
    attribution reads, and it charges nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    x = torch.ones(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.region("model.attention"):
            x @ x
    out = harness.reduce_trace(torch, prof, vocab=VOCAB, window_s=0.001)
    assert out["regions_ms"] == {} and out["busy_s"] == 0.0


def test_entries():
    """Each region metric, field for field, wherever it sits in
    ``per_layer``."""
    entries = {m["name"]: m for m in B["per_layer"]}
    for name, (layer, moves, cells, _) in REGION_METRICS.items():
        assert entries[name] == {"name": name, "unit": "ms", "better": "lower",
                                 "source": "device_trace", "layer": layer,
                                 "moves": moves, "workloads": cells}
    assert entries["mfu.serve.granite"] == {
        "name": "mfu.serve.granite", "unit": "%", "better": "higher", "source": "host_clock",
        "layer": "model step", "moves": "serve_tokens_per_s.hymba",
        "workloads": ["granite-serve"]}


@pytest.mark.parametrize("name", REGION_METRICS)
def test_reader_sums_its_regions_a_traced_round(name):
    region = REGION_METRICS[name][3]
    regions = {"model.attention": 3.0, "model.mlp": 5.0, "model.moe.combine": 7.0,
               "model.moe.dispatch": 11.0, "model.moe.experts": 13.0,
               "model.moe.route": 17.0, "model.moe.shared": 19.0, "model.ssd": 23.0,
               "optim.adamw": 29.0, "unattributed": 31.0}
    want = sum(v for k, v in regions.items() if k == region or k.startswith(region + "."))
    trace = {"traced": [4, 6], "regions_ms": regions}
    assert harness.metric_reader(name).read(trace, None) == want / 2


@pytest.mark.parametrize("name", REGION_METRICS)
def test_reader_gives_none_without_its_regions(name):
    region = REGION_METRICS[name][3]
    others = {k: 1.0 for k in ("model.attention", "model.ssd", "model.mlp",
                               "model.moe.route", "unattributed")
              if not (k == region or k.startswith(region + "."))}
    reader = harness.metric_reader(name)
    for regions in ({}, others):
        assert reader.read({"traced": [4, 5], "regions_ms": regions}, None) is None
