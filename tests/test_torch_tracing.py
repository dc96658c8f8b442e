"""The port's tracer (``repro_torch.tracing``) and its spans in the trainer,
the fault pipeline and the serve engine, on the CPU.

Spans nest and record their parent; the ring keeps its capacity and counts
what it drops; each thread keeps its own enclosing span; spans and
regions open a profiler range only while a profiler records. A trainer run through a
fault records one drain with its stages at the fault's step, and the
action's ``stage_seconds`` are those stages' durations; a served run
records one ``serve.round`` a round and one ``serve.work`` a batch, and
each report's wall time is its span's.
"""
import re
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import FaultInjector, LegioExecutor, LegioPolicy, VirtualCluster
from repro_torch.core.trainer import ResilientTrainer, TrainerReport
from repro_torch.launch.serve import ResilientServer
from repro_torch.mpi import Session
from repro_torch.serve import ServeEngine

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64, attn_block_q=16,
                   attn_block_k=16, xent_chunk=16, remat="none", param_dtype="float32",
                   dtype="float32")
STAGES = ("detect", "notice", "agree", "plan", "apply")


@pytest.fixture(autouse=True)
def ring():
    """An empty ring for each test."""
    tracing.clear()
    yield
    tracing.clear()


def named(name):
    return [s for s in tracing.spans() if s.name == name]


def under(top, name):
    """The spans called ``name`` whose parent chain reaches ``top``."""
    out = []
    for s in named(name):
        p = s.parent
        while p is not None and p is not top:
            p = p.parent
        if p is top:
            out.append(s)
    return out


def trainer(nodes=4, faults=()):
    cl = VirtualCluster(nodes, policy=LegioPolicy(data_plane="sim"),
                        injector=FaultInjector.at(list(faults)), device="cpu")
    tc = TrainConfig(learning_rate=3e-2, total_steps=8, warmup_steps=2, grad_clip=1.0)
    return ResilientTrainer(TINY, tc, cl, per_shard_batch=2, seq_len=16)


def server(faults=(), nodes=4, observe_stragglers=False):
    session = Session(nodes, policy=LegioPolicy(legion_size=2, data_plane="sim"),
                      injector=FaultInjector.at(list(faults)), device="cpu")
    s = ResilientServer(get_smoke_config("llama3.2-3b"), session, prompt_len=8,
                        decode_tokens=2, batch_per_node=2, device="cpu")
    s.engine.observe_stragglers = observe_stragglers
    return s


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_spans_nest_and_record_their_parent():
    with tracing.span("outer", step=3) as outer:
        with tracing.span("inner", node=1) as inner:
            pass
        with tracing.span("inner", node=2) as second:
            with tracing.span("leaf") as leaf:
                pass
    assert [s.name for s in tracing.spans()] == ["inner", "leaf", "inner", "outer"]
    assert outer.parent is None
    assert inner.parent is outer and second.parent is outer and leaf.parent is second
    assert outer.attrs == {"step": 3} and inner.attrs == {"node": 1}
    assert [s.id for s in tracing.spans()] == [0, 1, 2, 3]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns
    assert leaf.end_ns <= second.end_ns <= outer.end_ns
    assert outer.seconds == pytest.approx((outer.end_ns - outer.start_ns) * 1e-9)
    assert outer.ms == pytest.approx(outer.seconds * 1e3)
    # the enclosing span is per thread: a span closes back to its parent
    with tracing.span("after") as after:
        pass
    assert after.parent is None


def test_a_span_that_raises_is_recorded_and_closes():
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("failing"):
                raise ValueError("x")
    assert [s.name for s in tracing.spans()] == ["failing", "outer"]
    with tracing.span("next") as nxt:
        pass
    assert nxt.parent is None


@pytest.mark.parametrize("made", [10, 65536, 65541])
def test_ring_keeps_its_capacity_and_counts_drops(made):
    capacity = tracing.CAPACITY
    assert capacity == 65536
    for i in range(made):
        with tracing.span("s", i=i):
            pass
    kept = tracing.spans()
    assert len(kept) == min(capacity, made)
    assert kept[0].attrs["i"] == max(0, made - capacity) and kept[-1].attrs["i"] == made - 1
    assert tracing.dropped() == max(0, made - capacity)
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_each_thread_keeps_its_own_enclosing_span():
    opened, release = threading.Event(), threading.Event()
    inside = {}

    def worker():
        with tracing.span("thread.outer") as outer:
            opened.set()
            release.wait(5)
            with tracing.span("thread.inner") as inner:
                pass
        inside.update(outer=outer, inner=inner)

    with tracing.span("main.outer") as main_outer:
        t = threading.Thread(target=worker)
        t.start()
        opened.wait(5)
        # the thread's open span is not this thread's parent
        with tracing.span("main.inner") as main_inner:
            pass
        release.set()
        t.join(5)
    assert main_inner.parent is main_outer and main_outer.parent is None
    assert inside["inner"].parent is inside["outer"] and inside["outer"].parent is None
    assert sorted(s.name for s in tracing.spans()) == sorted(
        ["main.outer", "main.inner", "thread.outer", "thread.inner"])


def test_ranges_only_while_a_profiler_records():
    with tracing.span("host.before"), tracing.region("region.before"):
        torch.ones(4).add_(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("host.span", step=1), tracing.region("region.inside"):
            torch.ones(4).add_(1)
    with tracing.span("host.after"), tracing.region("region.after"):
        torch.ones(4).add_(1)
    names = [e.name for e in prof.events()]
    assert "host.span" in names and "region.inside" in names
    assert not {"host.before", "region.before", "host.after", "region.after"} & set(names)
    # the span recorded in all three cases, the region never
    assert [s.name for s in tracing.spans()] == ["host.before", "host.span", "host.after"]
    # the ranges are plain host ranges: none is a user annotation, which the
    # profiler would also draw on the device's timeline
    ranges = [e for e in prof.events() if e.name in ("host.span", "region.inside")]
    assert ranges and all(e.device_type == torch.autograd.DeviceType.CPU for e in ranges)


class _Counting:
    """Counts the profiler ranges the tracer opens."""

    def __init__(self, monkeypatch):
        self.opened = []
        real = tracing._RecordFunctionFast

        def counted(name, *args):
            self.opened.append(name)
            return real(name, *args)

        monkeypatch.setattr(tracing, "_RecordFunctionFast", counted)


def _train_and_serve():
    tr = trainer(faults=[(1, 2)])
    tr.run(3)
    s = server(faults=[(1, 1)])
    s.engine.submit(8)
    s.engine.run_round()
    s.engine.run_round()


def test_no_range_opened_without_a_profiler(monkeypatch):
    count = _Counting(monkeypatch)
    _train_and_serve()
    assert count.opened == []
    assert named("train.step") and named("serve.round") and named("serve.decode")
    with profile(activities=[ProfilerActivity.CPU]):
        _train_and_serve()
    opened = set(count.opened)
    assert {"train.step", "train.batch", "train.sync", "pipeline.drain", "serve.round",
            "serve.work", "serve.decode", "serve.sync", "model.attention", "model.mlp",
            "model.loss", "optim.clip", "optim.adamw"} <= opened


def test_the_port_opens_ranges_and_reads_the_clock_only_in_the_tracer():
    for path in sorted(PORT.rglob("*.py")):
        if path.name == "tracing.py" and path.parent == PORT:
            continue
        text = path.read_text()
        assert not re.search(r"record_function|RecordFunction|perf_counter|time\.time\(",
                             text), path


# ---------------------------------------------------------------------------
# the trainer and the fault pipeline
# ---------------------------------------------------------------------------

def test_trainer_step_batch_sync_spans():
    tr = trainer()
    reports = tr.run(3)
    steps = named("train.step")
    assert [s.attrs["step"] for s in steps] == [0, 1, 2]
    for top in steps:
        assert top.parent is None
        assert len(under(top, "train.batch")) == 1 and len(under(top, "train.sync")) == 1
    assert not hasattr(reports[0], "step_seconds")
    assert "step_seconds" not in TrainerReport.__dataclass_fields__


def test_trainer_fault_records_one_drain_with_its_stages():
    tr = trainer(nodes=4, faults=[(2, 1)])
    reports = tr.run(4)
    assert reports[2].repair is not None
    top = [s for s in named("train.step") if s.attrs["step"] == 2][0]
    drains = [d for d in under(top, "pipeline.drain")
              if under(d, "pipeline.apply")]
    assert len(drains) == 1
    drain = drains[0]
    assert drain.attrs["step"] == 2
    stages = {name: under(drain, f"pipeline.{name}") for name in STAGES}
    assert all(len(v) == 1 and v[0].parent is drain for v in stages.values())
    actions = tr.cluster.pipeline.actions
    assert len(actions) == 1 and actions[0].step == 2
    assert actions[0].stage_seconds == {k: v[0].seconds for k, v in stages.items()}
    assert tr.cluster.pipeline.traces[-1].stage_seconds == actions[0].stage_seconds
    # the repair's own span lies under the apply stage, and its report's wall is it
    shrink = under(stages["apply"][0], "repair.shrink")
    assert len(shrink) == 1 and reports[2].repair.wall_seconds == shrink[0].seconds
    # the other steps repaired nothing
    for other in named("train.step"):
        if other is not top:
            assert not [d for d in under(other, "pipeline.drain") if under(d, "pipeline.apply")]


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

def counted_work(engine):
    """Wrap the engine's work function; returns the list of its calls' rows."""
    calls, fn = [], engine.work_fn

    def work(node, batch, step):
        calls.append(len(batch))
        return fn(node, batch, step)

    engine.work_fn = work
    return calls


def test_server_round_and_work_spans():
    s = server(faults=[(1, 1)])
    calls = counted_work(s.engine)
    s.engine.submit(24)
    reports = [s.engine.run_round() for _ in range(4)]
    rounds = named("serve.round")
    assert [r.attrs["step"] for r in rounds] == [0, 1, 2, 3]
    for rep, rnd in zip(reports, rounds):
        assert rep.wall_seconds == rnd.seconds
        assert s.engine.metrics.round_seconds[rep.step]["wall"] == rnd.seconds
        for w in under(rnd, "serve.work"):
            assert w.parent is rnd
            decodes = under(w, "serve.decode")             # decode_tokens
            assert [d.attrs["index"] for d in decodes] == [0, 1]
            assert len(under(w, "serve.sync")) == 1
    # one work span a batch, in a round, with the batch's rows
    works = named("serve.work")
    assert calls and [w.attrs["rows"] for w in works] == calls
    assert len(works) == sum(len(under(rnd, "serve.work")) for rnd in rounds)
    # the fault's round carries the one drain that repaired
    assert reports[1].actions
    repairing = [d for d in named("pipeline.drain") if under(d, "pipeline.apply")]
    assert len(repairing) == 1 and repairing[0] in under(rounds[1], "pipeline.drain")


def test_straggler_observation_is_the_work_span():
    s = server(observe_stragglers=True)
    seen = []
    s.engine.cluster.straggler.observe = lambda node, latency: seen.append((node, latency))
    s.engine.submit(8)
    s.engine.run_round()
    works = named("serve.work")
    assert works and seen == [(w.attrs["node"], w.seconds) for w in works]


def test_serve_run_wall_is_its_span():
    s = server()
    rep = s.run(8)
    assert rep["wall_seconds"] == named("serve.run")[0].seconds


def test_engine_round_wall_is_its_span():
    cl = VirtualCluster(8, policy=LegioPolicy(legion_size=4, data_plane="sim"),
                        injector=FaultInjector.at([(1, 2)]), device="cpu")
    eng = ServeEngine(cl, lambda node, batch, step: {r.rid: r.rid for r in batch})
    calls = counted_work(eng)
    eng.submit(16)
    reps = [eng.run_round() for _ in range(3)]
    rounds = named("serve.round")
    assert [r.seconds for r in rounds] == [rep.wall_seconds for rep in reps]
    assert [w.attrs["rows"] for w in named("serve.work")] == calls


def test_executor_step_and_work_spans():
    cl = VirtualCluster(8, policy=LegioPolicy(legion_size=4, data_plane="sim"),
                        injector=FaultInjector.at([(1, 3)]), device="cpu")
    seen = []
    cl.straggler.observe = lambda node, latency: seen.append((node, latency))
    ex = LegioExecutor(cl, lambda node, shard, step: float(node + shard))
    reps = [ex.run_step(step) for step in range(3)]
    steps = named("cluster.step")
    assert [s.attrs["step"] for s in steps] == [0, 1, 2]
    assert [s.seconds for s in steps] == [rep.wall_seconds for rep in reps]
    assert seen == [(w.attrs["node"], w.seconds) for w in named("cluster.work")]
    assert reps[1].repair is not None
    shrink = under(steps[1], "repair.shrink")
    assert len(shrink) == 1 and reps[1].repair.wall_seconds == shrink[0].seconds
