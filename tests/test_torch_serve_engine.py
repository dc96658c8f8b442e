"""The port's serving subsystem on the CPU, alone and beside the JAX package's.

First the cases of tests/test_serve.py, run on ``repro_torch.serve`` over
the port's ``VirtualCluster`` with the torch data plane on the host
(``device="cpu"``): at-least-once re-enqueue, exactly-once completion, no
stall on healthy legions for every recovery mode, and the
continuous-batching surface (phase split, decode migration, slack
scheduling, admission control, deterministic dispatch).

Then both engines side by side under the stand-in ``repro.dist.dataplane``
of test_torch_runtime.py: for every recovery preset, continuous and
lock-step, with and without requeue, plus an SLO/admission campaign and a
``TrafficGenerator`` campaign, the ``RoundReport``s (wall seconds aside),
the dispatch trace, the completion order with each ``complete_sim`` and
``metrics.summary()`` must be equal. The numbers chip_smoke.py pins for its
serve phase are computed here from the reference engine.
"""
import functools
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, strategies as st

torch = pytest.importorskip("torch")

from test_torch_runtime import _stand_in_module, norm  # noqa: E402

import repro.core as R  # noqa: E402
import repro.mpi as RM  # noqa: E402
import repro.serve as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.mpi as PM  # noqa: E402
import repro_torch.serve as PS  # noqa: E402
from repro_torch.core import FaultInjector, LegioPolicy, VirtualCluster  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    RECOVERY_PRESETS as MODES,
    Arrival,
    LegionQueue,
    MicroBatcher,
    Request,
    RequestRouter,
    ServeEngine,
    TrafficGenerator,
    recovery_preset,
)

ROOT = Path(__file__).resolve().parents[1]
# the port's default data plane is torch on "cuda": here it runs on the host
cluster = functools.partial(VirtualCluster, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_serve.py on the port
# ---------------------------------------------------------------------------

def work(node, batch, step):
    return {r.rid: float(r.rid) for r in batch}


def make_engine(n=16, mode="shrink", faults=(), microbatch=3, **kw):
    pol = LegioPolicy(legion_size=4, serve_microbatch=microbatch,
                      **recovery_preset(mode, spare_fraction=0.5))
    cl = cluster(n, policy=pol,
                        injector=FaultInjector.at(list(faults)))
    return ServeEngine(cl, work, **kw)


def queued_rids(engine):
    return {r.rid for q in engine.router.queues.values() for r in q._q}


def inflight_rids(engine):
    return {r.rid for b in engine._inflight.values() for r in b}


# ---------------------------------------------------------------------------
# property: no request is lost or double-completed across an injected fault
# ---------------------------------------------------------------------------

@given(data=st.data())
def test_no_request_lost_or_double_completed(data):
    mode = data.draw(st.sampled_from(sorted(MODES)))
    n = data.draw(st.integers(8, 24))
    n_fail = data.draw(st.integers(1, min(4, n - 4)))
    victims = data.draw(st.permutations(list(range(n))))[:n_fail]
    steps = data.draw(st.lists(st.integers(0, 4),
                               min_size=n_fail, max_size=n_fail))
    total = data.draw(st.integers(20, 120))
    eng = make_engine(n=n, mode=mode, faults=list(zip(steps, victims)))
    eng.submit(total)
    rep = eng.serve(max_rounds=200)
    # exactly-once from the client's view: every id, once, no extras
    assert sorted(eng.completed) == list(range(total))
    assert rep.completed == total
    m = rep.metrics_summary
    assert m["parked"] == 0 and m["abandoned"] == 0
    # completions are unique per id in the metrics ledger too
    seen = [r.rid for r in eng.metrics.completions]
    assert len(seen) == len(set(seen))


# ---------------------------------------------------------------------------
# deterministic coverage of the same property (runs without hypothesis)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_zero_loss_across_fault_each_mode(mode):
    """A mid-campaign fault with batches in flight loses nothing: the
    verdict node's requests are re-enqueued (at-least-once) and every id
    completes exactly once."""
    eng = make_engine(mode=mode, faults=[(1, 5), (2, 0)])
    eng.submit(150)
    rep = eng.serve(max_rounds=100)
    assert sorted(eng.completed) == list(range(150))
    m = rep.metrics_summary
    assert m["requeues"] > 0, "faults landed mid-flight: must redeliver"
    assert m["duplicates_suppressed"] == 0
    assert m["max_attempts_seen"] >= 2   # a redelivered request completed
    rids = [r.rid for r in eng.metrics.completions]
    assert len(rids) == len(set(rids)) == 150


def test_request_accounting_invariant_every_round():
    """At every round boundary each request id is in exactly one bucket:
    queued, in-flight, or completed (the queue.py ownership invariant)."""
    eng = make_engine(mode="nonblocking", faults=[(1, 3), (3, 8)])
    eng.submit(90)
    submitted = set(range(90))
    for _ in range(40):
        if not eng.pending:
            break
        eng.run_round()
        q, f, c = queued_rids(eng), inflight_rids(eng), set(eng.completed)
        assert q | f | c == submitted
        assert not (q & f) and not (q & c) and not (f & c)
    assert set(eng.completed) == submitted


# ---------------------------------------------------------------------------
# dedup guard: redelivery of a completed request is suppressed
# ---------------------------------------------------------------------------

def test_dedup_guard_suppresses_double_completion():
    eng = make_engine()
    eng.submit(4)
    eng.run_round()
    assert 0 in eng.completed
    ghost = Request(rid=0, enqueue_step=0, attempts=1)
    eng._redeliver(ghost)                    # stale redelivery of a done id
    assert eng.metrics.duplicates_suppressed == 1
    assert eng.metrics.requeues == 0
    assert len(eng.completed) == 4           # nothing re-entered the system


def test_partial_work_result_redelivers_not_completes():
    """A work_fn that drops an id (partial result dict) is a delivery
    failure: the request redelivers instead of completing as None."""
    first_try_dropped = []

    def flaky(node, batch, step):
        out = {}
        for r in batch:
            if r.rid == 7 and r.attempts == 1:
                first_try_dropped.append(r.rid)
                continue
            out[r.rid] = float(r.rid)
        return out

    cl = cluster(16, policy=LegioPolicy(legion_size=4,
                                               serve_microbatch=3))
    eng = ServeEngine(cl, flaky)
    eng.submit(30)
    eng.serve(max_rounds=20)
    assert first_try_dropped == [7]
    assert eng.completed[7] == 7.0          # real result, via redelivery
    assert sorted(eng.completed) == list(range(30))
    assert eng.metrics.requeues >= 1


def test_completed_results_are_write_once():
    eng = make_engine()
    eng.submit(2)
    eng.run_round()
    first = eng.completed[1]
    eng._complete(Request(rid=1, enqueue_step=0), -999.0, 1, 0)
    assert eng.completed[1] == first
    assert eng.metrics.duplicates_suppressed == 1


# ---------------------------------------------------------------------------
# DROP (requeue=False) and the redelivery ceiling
# ---------------------------------------------------------------------------

def test_drop_mode_abandons_instead_of_requeueing():
    eng = make_engine(faults=[(0, 2)], requeue=False)
    eng.submit(48)
    rep = eng.serve(max_rounds=50)
    m = rep.metrics_summary
    assert m["abandoned"] > 0 and m["requeues"] == 0
    assert rep.completed + m["abandoned"] == 48
    assert not set(eng.metrics.abandoned) & set(eng.completed)


def test_max_attempts_parks_not_drops():
    pol = LegioPolicy(legion_size=4, serve_microbatch=3,
                      serve_max_attempts=1)
    cl = cluster(16, policy=pol,
                        injector=FaultInjector.at([(0, 5)]))
    eng = ServeEngine(cl, work)
    eng.submit(48)
    eng.serve(max_rounds=50)
    parked = set(eng.metrics.parked)
    assert parked, "requests on the dead node hit the ceiling"
    assert not parked & set(eng.completed)
    assert parked | set(eng.completed) == set(range(48))


# ---------------------------------------------------------------------------
# router: queues survive topology changes
# ---------------------------------------------------------------------------

def test_whole_legion_death_rehomes_its_queue():
    """All members of one legion die in one round — its undispatched queue
    must re-home to surviving legions, not strand."""
    eng = make_engine(faults=[(0, 4), (0, 5), (0, 6), (0, 7)], microbatch=1)
    eng.submit(160)                      # deep queues: plenty undispatched
    rep = eng.serve(max_rounds=200)
    assert rep.completed == 160
    assert eng.router.rerouted > 0, "the dead legion's queue was re-homed"
    assert all(idx != 1 for idx in eng.router.queues), \
        "legion 1 left the ring; its queue must be gone"


def test_router_least_loaded_sharding():
    router = RequestRouter()
    cl = cluster(16, policy=LegioPolicy(legion_size=4))
    reqs = [Request(rid=i) for i in range(40)]
    router.submit(reqs, cl.topo.view())
    sizes = {i: len(q) for i, q in router.queues.items()}
    assert sum(sizes.values()) == 40
    assert max(sizes.values()) - min(sizes.values()) <= 1


# ---------------------------------------------------------------------------
# e2e: a mid-campaign fault keeps p99 bounded on healthy legions
# ---------------------------------------------------------------------------

def test_e2e_p99_bounded_on_healthy_legions():
    """Structural acceptance (no wall-clock): during the repair, legions
    untouched by the fault keep dispatching every round, and their
    round-latency p99 does not exceed the campaign-wide p99 — serving
    overlaps the repair instead of barriering on it."""
    faults = [(2, 1), (3, 5)]
    eng = make_engine(mode="nonblocking", faults=faults, microbatch=2)
    cl = eng.cluster
    submitted = 0
    rounds = 0
    while submitted < 240 or eng.pending:
        if rounds < 8:
            eng.submit(30)
            submitted += 30
        eng.run_round()
        rounds += 1
        assert rounds < 100
    assert sorted(eng.completed) == list(range(240))

    fault_legions = {cl.topo.home[v] for _, v in faults}
    healthy = [lg.index for lg in cl.topo.legions
               if lg.members and lg.index not in fault_legions]
    assert healthy, "the campaign must leave untouched legions"
    # no stall: every repair-window round dispatched on every healthy legion
    for lg in healthy:
        assert eng.metrics.stalled_rounds(lg, 2, 4) == 0
    p99_all = eng.metrics.latency_percentile(99)
    p99_healthy = eng.metrics.latency_percentile(99, set(healthy))
    assert p99_healthy <= p99_all
    # the repaired cluster is back at full capacity (nonblocking splices)
    assert cl.topo.size == 16


def test_healthy_legions_dispatch_during_repair_round():
    """The round that repairs legion L still dispatches real batches on
    every other legion (the RoundReport shows both in one round)."""
    eng = make_engine(mode="nonblocking", faults=[(1, 5)])
    eng.submit(200)
    eng.run_round()                                   # round 0: warm
    rep = eng.run_round()                             # round 1: fault + repair
    assert any(5 in a.verdict for a in rep.actions)
    victim_legion = eng.cluster.topo.home[5]
    dispatched_legions = {
        eng.cluster.topo.home.get(n, victim_legion)
        for n in rep.dispatched}
    assert len(dispatched_legions - {victim_legion}) >= 3, \
        "all other legions dispatched in the repair round"


# ---------------------------------------------------------------------------
# continuous batching: multi-tick service, phase split, in-flight windows
# ---------------------------------------------------------------------------

def arr(prefill=1, decode=0, slo=math.inf, user=0):
    return Arrival(user=user, slo_class="standard", slo_seconds=slo,
                   prefill_ticks=prefill, decode_ticks=decode)


def test_multi_tick_service_spans_rounds_with_phase_accounting():
    """A prefill-2/decode-3 request occupies its slot for five ticks, then
    completes; every tick lands in the right phase bucket."""
    eng = make_engine(n=4, microbatch=1)
    eng.submit([arr(prefill=2, decode=3)])
    for _ in range(4):
        eng.run_round()
        assert not eng.completed, "5 ticks of service cannot finish in 4"
    eng.run_round()
    assert sorted(eng.completed) == [0]
    assert eng.metrics.phase_ticks == {"prefill": 2, "decode": 3}
    rec = eng.metrics.completions[0]
    assert rec.latency_sim == pytest.approx(
        5 * eng.cluster.policy.step_sim_seconds)


def test_window_admits_while_previous_batch_still_decoding():
    """With window=2 a node takes a second micro-batch while its first is
    mid-decode — the in-flight window replaces the round barrier."""
    eng = make_engine(n=4, microbatch=1, window=2)
    eng.submit([arr(decode=6), arr(decode=6)])
    eng.run_round()
    inflight = {n: len(b) for n, b in eng._inflight.items()}
    assert sum(inflight.values()) == 2, "both admitted before either done"


def test_default_specs_match_legacy_single_round_completion():
    """Payload-less submits (1 prefill tick, 0 decode) complete in the
    round they are dispatched — byte-compatible with the pre-window
    engine."""
    eng = make_engine()
    eng.submit(9)
    rep = eng.run_round()
    assert rep.completed_now == 9
    assert eng.metrics.phase_ticks == {"prefill": 9, "decode": 0}


def test_round_seconds_records_sim_and_wall():
    """Every round records its duration on both clocks: the simulated one
    (deterministic — one tick per continuous round) and perf_counter."""
    eng = make_engine(n=8)
    eng.submit(12)
    eng.serve(max_rounds=10)
    tick = eng.cluster.policy.step_sim_seconds
    assert eng.metrics.round_seconds, "rounds must be recorded"
    for row in eng.metrics.round_seconds.values():
        assert row["sim"] == pytest.approx(tick)
        assert row["wall"] >= 0.0


# ---------------------------------------------------------------------------
# decode-state migration: progress survives the node, never double-completes
# ---------------------------------------------------------------------------

def test_migration_preserves_decode_progress():
    """A request mid-decode on a dying node re-enters a queue with its
    decode progress intact: total decode ticks spent equal the spec, with
    the preserved ticks never re-spent."""
    eng = make_engine(n=16, mode="nonblocking", microbatch=1,
                      faults=[(3, 0)])
    eng.submit([arr(decode=8)])         # lands on legion 0 / node 0
    eng.serve(max_rounds=40)
    assert sorted(eng.completed) == [0]
    assert eng.metrics.migrations == 1
    assert eng.metrics.decode_ticks_preserved >= 1
    # preserved ticks were not re-executed: spend equals the spec exactly
    assert eng.metrics.phase_ticks["decode"] == 8
    assert len(eng.metrics.completions) == 1
    assert eng.metrics.completions[0].migrated


def test_migration_disabled_restarts_from_prefill():
    """serve_migrate_decode=False is the restart baseline: same fault,
    zero migrations, and the decode ticks before the fault are re-spent."""
    pol = LegioPolicy(legion_size=4, serve_microbatch=1,
                      serve_migrate_decode=False,
                      **recovery_preset("nonblocking", spare_fraction=0.5))
    cl = cluster(16, policy=pol, injector=FaultInjector.at([(3, 0)]))
    eng = ServeEngine(cl, work)
    eng.submit([arr(decode=8)])
    eng.serve(max_rounds=40)
    assert sorted(eng.completed) == [0]
    assert eng.metrics.migrations == 0
    assert eng.metrics.phase_ticks["decode"] > 8, \
        "restart must re-spend the pre-fault decode ticks"
    assert len(eng.metrics.completions) == 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_migration_never_double_completes_under_faults(mode):
    """Decode-heavy traffic + mid-campaign faults in every recovery mode:
    exactly one completion per id, migrated or not."""
    eng = make_engine(n=16, mode=mode, microbatch=2,
                      faults=[(2, 1), (3, 5)])
    eng.submit([arr(decode=4, user=i) for i in range(60)])
    eng.serve(max_rounds=120)
    assert sorted(eng.completed) == list(range(60))
    rids = [r.rid for r in eng.metrics.completions]
    assert len(rids) == len(set(rids)) == 60
    assert eng.metrics.starved_rounds() == 0


# ---------------------------------------------------------------------------
# lock-step baseline: the barrier stretches rounds; continuous beats it
# ---------------------------------------------------------------------------

def test_lockstep_round_stretches_to_slowest_batch():
    eng = make_engine(n=4, microbatch=1, continuous=False)
    eng.submit([arr(decode=5), arr(decode=0)])
    rep = eng.run_round()
    tick = eng.cluster.policy.step_sim_seconds
    assert rep.completed_now == 2, "lock-step drains everything per round"
    assert rep.sim_seconds == pytest.approx(6 * tick), \
        "the round lasts as long as its slowest batch (1+5 ticks)"


def test_continuous_beats_lockstep_p99_at_same_offered_load():
    """The tentpole claim in miniature: identical arrival schedule, same
    faults — continuous batching's p99 (sim-seconds) is strictly better
    than the lock-step barrier's."""
    gen = TrafficGenerator(8.0, seed=3)
    sched = []
    for t in range(12):
        sched.extend((float(t + 1), a)
                     for a in gen.arrivals(float(t), float(t + 1)))
    p99 = {}
    for continuous in (True, False):
        eng = make_engine(n=16, mode="nonblocking", microbatch=2,
                          faults=[(3, 5)], continuous=continuous)
        i, rounds = 0, 0
        while rounds < 200:
            now = eng.cluster.clock.sim_seconds
            while i < len(sched) and sched[i][0] <= now:
                j = i
                while j < len(sched) and sched[j][0] <= now:
                    j += 1
                eng.submit([a for _, a in sched[i:j]])
                i = j
            if i >= len(sched) and not eng.pending:
                break
            eng.run_round()
            rounds += 1
        assert len(eng.completed) == len(sched)
        p99[continuous] = eng.metrics.latency_percentile(99, unit="sim")
    assert p99[True] < p99[False]


# ---------------------------------------------------------------------------
# deadline-aware scheduling: slack orders the batch, FIFO is preserved
# ---------------------------------------------------------------------------

def test_batcher_picks_tightest_slack_first():
    q = LegionQueue(legion=0)
    loose = Request(rid=0, deadline_sim=100.0, decode_ticks=1)
    none = Request(rid=1)                          # no deadline: inf slack
    tight = Request(rid=2, deadline_sim=10.0, decode_ticks=1)
    for r in (loose, none, tight):
        q.push(r)
    batch = MicroBatcher(2).form_one(q, now=0.0, tick_seconds=1.0)
    assert [r.rid for r in batch] == [2, 0], "tightest deadline leaves first"
    assert [r.rid for r in q._q] == [1]


def test_batcher_stays_fifo_without_deadlines():
    q = LegionQueue(legion=0)
    for i in range(5):
        q.push(Request(rid=i))
    assert [r.rid for r in MicroBatcher(3).form_one(q)] == [0, 1, 2]


def test_equal_slack_keeps_queue_order():
    """Front-pushed redeliveries retain priority among equal slack — the
    tie-break is queue position, never rid or dict order."""
    q = LegionQueue(legion=0)
    a = Request(rid=5, deadline_sim=20.0)
    b = Request(rid=1, deadline_sim=20.0)
    q.push(a)
    q.push_front(b)                                # redelivery: skip the line
    batch = q.pop_batch(2, key=lambda r: r.slack(0.0, 1.0))
    assert [r.rid for r in batch] == [1, 5]


# ---------------------------------------------------------------------------
# admission control: backpressure before the queues blow past feasibility
# ---------------------------------------------------------------------------

def test_admission_shed_rejects_infeasible_load():
    """A flood of tight-deadline arrivals on a tiny cluster: admission
    sheds what cannot meet its SLO, the ledger stays conserved, and
    nothing shed ever completes."""
    pol = LegioPolicy(legion_size=4, serve_microbatch=1,
                      serve_admission="shed")
    eng = ServeEngine(cluster(4, policy=pol), work)
    eng.submit([arr(decode=3, slo=6.0, user=i) for i in range(200)])
    eng.serve(max_rounds=300)
    shed = set(eng.metrics.shed)
    assert shed, "infeasible load must be shed at the door"
    assert not shed & set(eng.completed)
    assert shed | set(eng.completed) == set(range(200))


def test_admission_park_keeps_ids_out_of_completions():
    pol = LegioPolicy(legion_size=4, serve_microbatch=1,
                      serve_admission="park")
    eng = ServeEngine(cluster(4, policy=pol), work)
    eng.submit([arr(decode=3, slo=6.0, user=i) for i in range(200)])
    eng.serve(max_rounds=300)
    parked = set(eng.metrics.parked)
    assert parked and not parked & set(eng.completed)
    assert len(eng.metrics.shed) == 0
    assert parked | set(eng.completed) == set(range(200))


def test_admission_none_queues_everything():
    eng = make_engine(n=8)
    eng.submit([arr(decode=3, slo=0.5, user=i) for i in range(50)])
    assert eng.router.backlog + sum(
        len(b) for b in eng._inflight.values()) == 50
    assert not eng.metrics.shed and not eng.metrics.parked


# ---------------------------------------------------------------------------
# parking + DROP semantics across every recovery mode (ledger coverage)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_parking_path_across_modes(mode):
    """serve_max_attempts=1 with a mid-campaign fault: everything the dead
    node held parks (never silently lost, never completed twice)."""
    pol = LegioPolicy(legion_size=4, serve_microbatch=3,
                      serve_max_attempts=1,
                      **recovery_preset(mode, spare_fraction=0.5))
    cl = cluster(16, policy=pol, injector=FaultInjector.at([(0, 5)]))
    eng = ServeEngine(cl, work)
    eng.submit(48)
    eng.serve(max_rounds=60)
    parked = set(eng.metrics.parked)
    assert parked, f"{mode}: the dead node's requests must park"
    assert not parked & set(eng.completed)
    assert parked | set(eng.completed) == set(range(48))
    assert not eng.metrics.abandoned


@pytest.mark.parametrize("mode", sorted(MODES))
def test_drop_semantics_across_modes(mode):
    """requeue=False in every recovery mode: the dead node's requests are
    abandoned explicitly — counted, disjoint from completions, and the
    ledger still adds up."""
    eng = make_engine(mode=mode, faults=[(0, 2)], requeue=False)
    eng.submit(48)
    rep = eng.serve(max_rounds=60)
    m = rep.metrics_summary
    assert m["abandoned"] > 0 and m["requeues"] == 0, \
        f"{mode}: DROP must abandon, not requeue"
    abandoned = set(eng.metrics.abandoned)
    assert not abandoned & set(eng.completed)
    assert abandoned | set(eng.completed) == set(range(48))


# ---------------------------------------------------------------------------
# determinism: identical seeds -> byte-identical dispatch traces
# ---------------------------------------------------------------------------

def _dispatch_trace(seed):
    gen = TrafficGenerator(6.0, seed=seed)
    eng = make_engine(n=16, mode="nonblocking", microbatch=2,
                      faults=[(2, 5)])
    t_prev = 0.0
    for _ in range(25):
        now = eng.cluster.clock.sim_seconds
        if now > t_prev:
            eng.submit(gen.arrivals(t_prev, now))
            t_prev = now
        if t_prev >= 12.0 and not eng.pending:
            break
        eng.run_round()
    return (eng.metrics.dispatch_trace,
            [r.rid for r in eng.metrics.completions],
            [(r.rid, r.complete_sim) for r in eng.metrics.completions])


@given(seed=st.integers(0, 2**31 - 1))
def test_dispatch_trace_byte_identical_across_runs(seed):
    """The tie-break property: at a fixed seed, two independent runs over
    the same traffic produce identical dispatch traces and identical
    completion orders — no dict-order or hash-seed dependence anywhere in
    router selection, slack scheduling, or window admission."""
    assert _dispatch_trace(seed) == _dispatch_trace(seed)


def test_dispatch_trace_deterministic_fixed_seed():
    """Deterministic coverage of the same property (runs without
    hypothesis)."""
    for seed in (0, 7, 123457):
        assert _dispatch_trace(seed) == _dispatch_trace(seed)


# ---------------------------------------------------------------------------
# side by side with the reference engine, under the stand-in data plane
# ---------------------------------------------------------------------------

@pytest.fixture
def reference(monkeypatch):
    """The JAX package's runtime with the stand-in ``repro.dist.dataplane``
    of test_torch_runtime.py, for this test only."""
    monkeypatch.setitem(sys.modules, "repro.dist.dataplane", _stand_in_module())


PKGS = {"reference": (R, RM, RS, {}), "port": (P, PM, PS, {"device": "cpu"})}


def side_by_side(run, **kw):
    """``run(pkg, **kw)`` on both packages; the port's record must equal the
    reference's, and the reference's is returned."""
    want, got = run("reference", **kw), run("port", **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    return want


def engine_record(eng, reports):
    """Everything the engine decided, package-free (wall seconds aside)."""
    m = eng.metrics
    return {
        "round_reports": norm(reports),
        "dispatch_trace": m.dispatch_trace,
        "completion_order": [r.rid for r in m.completions],
        "complete_sim": [r.complete_sim for r in m.completions],
        "completion_records": norm(m.completions),
        "summary": m.summary(max(len(reports), 1)),
        "starvation_trace": m.starvation_trace,
        "round_sim": {s: row["sim"] for s, row in m.round_seconds.items()},
        "ledgers": (m.parked, m.abandoned, m.shed),
        "completed": eng.completed,
        "survivors": sorted(eng.cluster.live_nodes),
        "repairs": norm(eng.cluster.repairs),
    }


def drive(eng, schedule, max_rounds=200):
    """Submit ``schedule[round]`` before each round; run until quiescent."""
    reports = []
    for step in range(max_rounds):
        if step in schedule:
            eng.submit(schedule[step])
        elif step > max(schedule) and not eng.pending:
            break
        if not eng.cluster.live_nodes:
            break
        reports.append(eng.run_round())
    return reports


def campaign(pkg, *, mode, continuous, requeue):
    """16 nodes in legions of 4, three faults mid-flight (one a legion
    master), payload-less one-tick requests and decode-heavy arrivals."""
    core, _, serve, extra = PKGS[pkg]
    pol = core.LegioPolicy(legion_size=4, serve_microbatch=3,
                           **serve.recovery_preset(mode, spare_fraction=0.5))
    cl = core.VirtualCluster(16, policy=pol, injector=core.FaultInjector.at(
        [(1, 5), (2, 0), (4, 9)]), **extra)
    eng = serve.ServeEngine(cl, work, continuous=continuous, requeue=requeue)
    decode = [serve.Arrival(user=i, slo_class="batch", slo_seconds=math.inf,
                            prefill_ticks=1 + i % 2, decode_ticks=2 + i % 5)
              for i in range(30)]
    reports = drive(eng, {0: 40, 1: decode, 3: [None] * 10 + decode[:10]})
    return engine_record(eng, reports)


@pytest.mark.parametrize("requeue", [True, False], ids=["requeue", "no-requeue"])
@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "lockstep"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_reference(reference, mode, continuous, requeue):
    want = side_by_side(campaign, mode=mode, continuous=continuous, requeue=requeue)
    total = 40 + 30 + 20
    s = want["summary"]
    assert s["completed"] + s["abandoned"] == total and s["parked"] == 0
    assert (s["requeues"] > 0) == requeue and (s["abandoned"] > 0) != requeue
    assert any(r[1][1] for r in want["round_reports"][1:3]), "faults dispatched mid-flight"


def admission_campaign(pkg, *, admission):
    """Tight SLOs on 8 nodes with a fault: admission sheds or parks at the door."""
    core, _, serve, extra = PKGS[pkg]
    pol = core.LegioPolicy(legion_size=4, serve_microbatch=1, serve_window=2,
                           serve_admission=admission, serve_slo_seconds=9.0,
                           **serve.recovery_preset("nonblocking", spare_fraction=0.5))
    cl = core.VirtualCluster(8, policy=pol, injector=core.FaultInjector.at([(2, 3)]),
                             **extra)
    eng = serve.ServeEngine(cl, work)
    tight = [serve.Arrival(user=i, slo_class="interactive", slo_seconds=6.0,
                           prefill_ticks=1, decode_ticks=1 + i % 3) for i in range(60)]
    reports = drive(eng, {0: tight[:30], 1: 20, 2: tight[30:]})
    return engine_record(eng, reports)


@pytest.mark.parametrize("admission", ["shed", "park"])
def test_admission_matches_reference(reference, admission):
    want = side_by_side(admission_campaign, admission=admission)
    shed, parked = len(want["ledgers"][2]), len(want["ledgers"][0])
    assert (shed if admission == "shed" else parked) > 0
    assert want["summary"]["slo_attainment"] < 1.0 or shed + parked > 0


def traffic_campaign(pkg, *, seed):
    """Open-loop seeded traffic with a burst and a diurnal swing, submitted by
    sim-time window, lock-step against continuous on the same stream."""
    core, _, serve, extra = PKGS[pkg]
    out = {}
    for continuous in (True, False):
        gen = serve.TrafficGenerator(6.0, seed=seed, diurnal_amplitude=0.3,
                                     diurnal_period=20.0,
                                     bursts=(serve.Burst(4.0, 7.0, 3.0),))
        pol = core.LegioPolicy(legion_size=4, serve_microbatch=2,
                               **serve.recovery_preset("overlap"))
        cl = core.VirtualCluster(16, policy=pol, injector=core.FaultInjector.at([(2, 5)]),
                                 **extra)
        eng = serve.ServeEngine(cl, work, continuous=continuous)
        arrivals, reports, t_prev = [], [], 0.0
        for _ in range(80):
            now = cl.clock.sim_seconds
            if now > t_prev and t_prev < 12.0:
                batch = gen.arrivals(t_prev, now)
                arrivals.extend(norm(batch))
                eng.submit(batch)
                t_prev = now
            if t_prev >= 12.0 and not eng.pending:
                break
            reports.append(eng.run_round())
        out[continuous] = {"arrivals": arrivals, "generated": gen.generated,
                           **engine_record(eng, reports)}
    return {f"{k}:{c}": v for c, rec in out.items() for k, v in rec.items()}


def test_traffic_campaign_matches_reference(reference):
    want = side_by_side(traffic_campaign, seed=11)
    # windows follow each engine's sim clock, so the two modes see different streams
    assert want["generated:True"] > 40 and want["generated:False"] > 40
    assert want["summary:True"]["completed"] == want["generated:True"]
    assert want["summary:False"]["completed"] == want["generated:False"]


def test_traffic_generator_matches_reference():
    """Same seed, same windows: the same arrivals, byte for byte."""
    kw = dict(seed=5, n_users=1000, diurnal_amplitude=0.5, diurnal_period=30.0,
              bursts=(RS.Burst(2.0, 3.0, 4.0),))
    ref = RS.TrafficGenerator(9.0, **kw)
    port = PS.TrafficGenerator(9.0, **{**kw, "bursts": (PS.Burst(2.0, 3.0, 4.0),)})
    for t in range(10):
        t0, t1 = t * 0.5, (t + 1) * 0.5
        assert ref.rate_at(t0) == port.rate_at(t0)
        assert norm(port.arrivals(t0, t1)) == norm(ref.arrivals(t0, t1))
    assert port.generated == ref.generated > 0
    assert norm(PS.DEFAULT_SLO_CLASSES) == norm(RS.DEFAULT_SLO_CLASSES)
    assert PS.RECOVERY_PRESETS == RS.RECOVERY_PRESETS
    for name in RS.RECOVERY_PRESETS:
        assert PS.recovery_preset(name) == RS.recovery_preset(name)


# ---------------------------------------------------------------------------
# the numbers chip_smoke.py holds its serve phase to
# ---------------------------------------------------------------------------

def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chip_serve_config(pkg, *, continuous):
    """chip_smoke.py's serve configuration with a stub work_fn."""
    core, mpi, serve, extra = PKGS[pkg]
    cs = load_chip_smoke()
    calls = []

    def stub(node, batch, step):
        calls.append([r.rid for r in batch])
        return {r.rid: r.rid for r in batch}

    session = mpi.Session(cs.SERVE_NODES, policy=core.LegioPolicy(
        legion_size=cs.SERVE_LEGION, **serve.recovery_preset("shrink")),
        injector=core.FaultInjector.at([cs.SERVE_FAULT]), **extra)
    eng = serve.ServeEngine(session, stub, microbatch=cs.SERVE_PER_NODE,
                            continuous=continuous, observe_stragglers=False)
    eng.submit(cs.SERVE_REQUESTS)
    rep = eng.serve()
    m = rep.metrics_summary
    return {"rounds": rep.rounds, "requeues": m["requeues"], "work_fn_calls": calls,
            "p99_latency_sim": m["p99_latency_sim"], "completed": rep.completed,
            "survivors": rep.survivors, "repairs": rep.repairs}


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "lockstep"])
def test_chip_smoke_serve_numbers_pinned_from_reference(reference, continuous):
    """chip_smoke.py runs where there is no jax; it holds each model's serve
    run to these numbers, which must be the reference engine's."""
    want = side_by_side(chip_serve_config, continuous=continuous)
    assert (want["completed"], want["survivors"], want["repairs"]) == (16, 3, 1)
    pinned = load_chip_smoke().SERVE_PINNED
    assert {k: want[k] for k in pinned} == pinned


# ---------------------------------------------------------------------------
# the model-backed server, beside the reference's
# ---------------------------------------------------------------------------

def test_serve_prompts_byte_equal_to_jax():
    """The port's prompts at a full-width serve shape (B=4, S=2048, llama's
    vocabulary) are ``jax.random.randint(PRNGKey(1234), ...)``'s, byte for
    byte, with the request ids in column 0."""
    import jax
    import jax.numpy as jnp

    from repro_torch.launch.serve import prompt_tokens

    rids, V = [7, 6, 5, 4], 128256
    want = jax.random.randint(jax.random.PRNGKey(1234), (4, 2048), 0, V, jnp.int32)
    want = np.asarray(want.at[:, 0].set(jnp.asarray(rids, jnp.int32) % V))
    got = prompt_tokens(rids, 2048, V)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "lockstep"])
def test_resilient_server_matches_reference(reference, continuous):
    """The smoke config in fp32 through one fault: the same weights (carried
    across with params_from_reference) give every request the reference
    server's tokens, and ``run()`` the same report but for wall time."""
    import jax

    from repro.configs.registry import get_smoke_config as jax_smoke_config
    from repro.launch import serve as jax_serve
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import serve as port_serve
    from repro_torch.models.convert import params_from_reference

    kw = dict(dtype="float32", param_dtype="float32")
    jcfg = jax_smoke_config("llama3.2-3b").replace(**kw)
    pcfg = get_smoke_config("llama3.2-3b").replace(**kw)
    shape = dict(prompt_len=16, decode_tokens=4, batch_per_node=4, continuous=continuous)

    def session(core, mpi, serve, extra):
        return mpi.Session(4, policy=core.LegioPolicy(legion_size=2,
                                                      **serve.recovery_preset("shrink")),
                           injector=core.FaultInjector.at([(0, 1)]), **extra)

    ref = jax_serve.ResilientServer(jcfg, session(*PKGS["reference"]), **shape)
    port = port_serve.ResilientServer(pcfg, session(*PKGS["port"]), device="cpu", **shape)
    port.params = params_from_reference(port.cfg, jax.tree.map(np.asarray, ref.params),
                                        device="cpu")
    want, got = ref.run(16), port.run(16)
    volatile = {"wall_seconds", "throughput_rps"}
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k not in volatile} == \
        {k: v for k, v in want.items() if k not in volatile}
    assert (got["completed"], got["survivors"], got["repairs"], got["requeues"]) == (16, 3, 1, 4)
    assert sorted(port.completed) == sorted(ref.completed) == list(range(16))
    for rid, row in ref.completed.items():
        np.testing.assert_array_equal(port.completed[rid], row, err_msg=f"request {rid}")
