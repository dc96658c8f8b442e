"""Continuous batching vs the lock-step barrier, under a rack outage —
narrated.

A 64-node depth-3 cluster serves a seeded open-loop traffic stream
(Poisson arrivals, three SLO classes, a burst window) while a rack dies
mid-campaign. The same pre-generated arrival schedule runs twice:

  * **continuous** — per-legion in-flight windows admit a new micro-batch
    the moment a slot frees; requests advance prefill-then-decode one tick
    at a time; a request that dies mid-decode migrates its decode progress
    to a survivor instead of restarting from prefill;
  * **lockstep** — the pre-continuous baseline: one batch per node per
    round, and the round's simulated duration stretches to the slowest
    in-flight batch (the barrier everyone waits on).

Prints the ledger (exactly-once accounting including parked/shed), the
migration counters, and the p99 latency of both modes in simulated-clock
seconds.

  PYTHONPATH=src python examples_torch/continuous_serving.py               # on the card
  PYTHONPATH=src python examples_torch/continuous_serving.py --device cpu  # without one

Exits nonzero if the exactly-once ledger breaks, a healthy legion
starves, or continuous batching fails to beat the barrier at p99 — CI
runs this as the serving smoke test (``make serve-demo``).
"""
import argparse
import sys

from repro_torch.core import FaultInjector, LegioPolicy, VirtualCluster
from repro_torch.serve import (
    Burst,
    Request,
    ServeEngine,
    TrafficGenerator,
    recovery_preset,
)

N_NODES = 64
T_END = 16.0                       # arrival window, simulated seconds
RATE = 24.0                        # arrivals per simulated second
FAULTS = [(4, 8), (4, 9), (4, 10)]    # one rack's worth, mid-campaign


def work(node: int, batch: list[Request], step: int) -> dict[int, int]:
    return {r.rid: r.rid for r in batch}


def schedule() -> list[tuple[float, object]]:
    gen = TrafficGenerator(RATE, seed=7, bursts=(Burst(5.0, 8.0, 2.5),))
    out = []
    t = 0.0
    while t < T_END:
        out.extend((t + 1.0, a) for a in gen.arrivals(t, t + 1.0))
        t += 1.0
    return out


def run(mode: str, sched: list[tuple[float, object]], device: str) -> dict:
    policy = LegioPolicy(legion_size=4, serve_microbatch=2, serve_window=2,
                         **recovery_preset("nonblocking"))
    cluster = VirtualCluster(N_NODES, policy=policy,
                             injector=FaultInjector.at(FAULTS), device=device)
    engine = ServeEngine(cluster, work, continuous=(mode == "continuous"))
    i, rounds = 0, 0
    while rounds < 300:
        now = cluster.clock.sim_seconds
        while i < len(sched) and sched[i][0] <= now:
            j = i
            while j < len(sched) and sched[j][0] <= now:
                j += 1
            engine.submit([a for _, a in sched[i:j]])
            i = j
        if i >= len(sched) and not engine.pending:
            break
        engine.run_round()
        rounds += 1
    m = engine.metrics.summary(max(rounds, 1))
    m["mode"] = mode
    m["submitted"] = len(sched)
    m["unserved"] = engine.pending
    m["rounds"] = rounds
    m["sim_seconds"] = cluster.clock.sim_seconds
    m["unique"] = (len(set(engine.completed)) == len(engine.completed)
                   and len(engine.metrics.completions)
                   == len(engine.completed))
    return m


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    sched = schedule()
    print(f"continuous serving demo: n={N_NODES}, {len(sched)} requests "
          f"over {T_END:.0f} sim-seconds, rack of "
          f"{len(FAULTS)} dies at step {FAULTS[0][0]}\n")
    results = {}
    ok = True
    for mode in ("continuous", "lockstep"):
        m = run(mode, sched, args.device)
        results[mode] = m
        accounted = (m["completed"] + m["parked"] + m["abandoned"]
                     + m["shed"] + m["unserved"])
        conserved = accounted == m["submitted"] and m["unserved"] == 0
        print(f"== {mode} ==")
        print(f"   rounds {m['rounds']:3d} spanning "
              f"{m['sim_seconds']:.0f} sim-seconds")
        print(f"   ledger: {m['completed']} completed, {m['parked']} parked, "
              f"{m['abandoned']} abandoned, {m['shed']} shed, "
              f"{m['unserved']} unserved "
              f"{'[conserved]' if conserved else '[BROKEN]'}")
        print(f"   redelivery: {m['requeues']} requeues, "
              f"{m['duplicates_suppressed']} duplicates suppressed, "
              f"{m['migrations']} decode migrations "
              f"({m['decode_ticks_preserved']} ticks preserved)")
        print(f"   phases: {m['prefill_ticks']} prefill ticks, "
              f"{m['decode_ticks']} decode ticks")
        print(f"   latency: p50 {m['p50_latency_sim']:.1f}s, "
              f"p99 {m['p99_latency_sim']:.1f}s, "
              f"p999 {m['p999_latency_sim']:.1f}s (sim); "
              f"starved rounds {m['starved_rounds']}\n")
        ok &= conserved and m["unique"] and m["starved_rounds"] == 0
    cont, lock = results["continuous"], results["lockstep"]
    beat = cont["p99_latency_sim"] < lock["p99_latency_sim"]
    ok &= beat and cont["migrations"] > 0
    print(f"p99: continuous {cont['p99_latency_sim']:.1f}s vs lockstep "
          f"{lock['p99_latency_sim']:.1f}s "
          f"{'[continuous wins]' if beat else '[BARRIER WON]'}")
    print("continuous serving demo:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
