"""The ``serve`` driver: ``ResilientServer`` over ``Session`` through a node fault.

Set-up builds the server on a ``Session`` of the traffic's nodes and
legions (its recovery preset), writes the benchmark's seeded weights into
its parameters, hands it the benchmark's seeded prompts (the server's
``prompts``: request ``r`` gets a prompt drawn from its own seed, made of
the run's seed and ``r``) and serves ``setup_rounds`` rounds of full batches, which warms every shape
the window uses. The window is a closed loop: before each round the
backlog is topped up to ``backlog_rounds`` rounds of requests (live nodes
times ``batch_per_node`` each), and rounds run for ``--seconds``; a fault
lands in one of them. Requests submitted in the window and not delivered
by its end are served after it, untimed: they count in the latency, with
their wait, and not in the tokens. The window records each round's
batches; their model FLOPs are counted after it.

A request's latency runs from its submission to the end of the round that
delivered it. ``serve_tokens_per_s`` counts the prompt and generated
tokens of the requests delivered in the window over its length.

``correct``:

  * ``gap``: for a sample of the window's batches drawn from the seed (the
    failed node's redelivered requests among them), the reference runs
    once over each prompt with its served tokens, routed as the program's
    prefill and decode steps route them, and reads by how much each served
    token's logit lies below the reference's best there; the widest gap;
  * ``gap_share``: the share of those served tokens more than
    ``GAP_FLOOR`` below the reference's best (a cell's limits file says
    which of the two it compares);
  * ``lost``: requests submitted in the window and not delivered exactly
    once with the tokens their batch produced (exact);
  * ``unrequeued``: how many fewer than a batch the failed node's
    requests that were redelivered (exact).

Under the control (``control.py``) the tokens the reference computed in
fp8 would put first take the served tokens' place in ``gap`` and
``gap_share``, against the same limits.
"""
from __future__ import annotations

import functools
import gc
import time

import numpy as np

from bench import flops, harness
from bench.harness import Check

# a served token more than this far below the reference's best logit there
# counts in ``gap_share``
GAP_FLOOR = 0.1


def run(ctx) -> dict:
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import FaultInjector, LegioPolicy
    from repro_torch.launch.serve import ResilientServer
    from repro_torch.mpi import Session
    from repro_torch.serve import recovery_preset

    cfg_d, traffic, dev = ctx.config["model"], ctx.traffic, ctx.device
    ref = harness.reference(ctx.config["reference"])
    layout = ref.layout(cfg_d)
    per, S, gen_n = traffic["batch_per_node"], traffic["prompt_len"], traffic["generated"]
    session = Session(traffic["nodes"], policy=LegioPolicy(
        legion_size=traffic["legion"], **recovery_preset(traffic["recovery"])),
        injector=FaultInjector.at([tuple(f) for f in traffic["faults"]]), device=dev)
    server = ResilientServer(ModelConfig(**cfg_d), session, prompt_len=S,
                             decode_tokens=gen_n, batch_per_node=per, continuous=True,
                             device=dev)
    weights = harness.make_weights(torch, layout, ctx.seed, dev)
    harness.copy_into(torch, server.params, weights)
    del weights
    server.prompts = lambda rids: prompts(torch, ctx.seed, rids, S, cfg_d["vocab_size"], dev)
    engine = server.engine
    calls: list[dict] = []
    work_fn = engine.work_fn

    def recorded(node, batch, step):
        t = time.perf_counter()
        res = work_fn(node, batch, step)
        if ctx.fault == "token":        # a token altered where it is produced
            rid = batch[0].rid
            res[rid] = res[rid].copy()
            res[rid][-1] = (res[rid][-1] + 1) % cfg_d["vocab_size"]
        calls.append({"round": step, "node": node, "rids": [r.rid for r in batch],
                      "attempts": [r.attempts for r in batch],
                      "tokens": np.stack([res[r.rid] for r in batch]),
                      "wall_s": time.perf_counter() - t})
        return res

    engine.work_fn = recorded
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for _ in range(traffic["setup_rounds"]):
        engine.submit(len(engine.cluster.live_nodes) * per)
        engine.run_round()
    if engine.pending:
        raise RuntimeError(f"set-up left {engine.pending} requests undelivered")
    ctx.setup_done()

    out = _window(torch, ctx, engine, calls, per, S, gen_n)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    out["peak"] = peak
    checks = _delivery(engine, calls, out.pop("submitted"), per)
    del server, session, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = pick(ctx.seed, calls, out.pop("window_rounds"), ctx.cell["check_batches"])
    gaps = reference_gaps(torch, ctx, ref, [calls[i] for i in sample], control=ctx.control)
    out["readings"] = dict(gaps, sample=[calls[i]["rids"] for i in sample])
    # the control, the reference in fp8, takes the program's place
    judged = gaps["control"] if ctx.control else gaps
    out["checks"] = [Check(k, judged[k], limit) for k, limit in ctx.limits.items()] + checks
    return out


def prompts(torch, seed: int, rids, S: int, vocab: int, device):
    """The prompts of requests ``rids``, one row each: request ``r``'s
    ``S`` uniform tokens, drawn from its own seed."""
    rows = []
    for rid in rids:
        gen = torch.Generator(device=device).manual_seed(harness.subseed(seed, 3, int(rid)))
        rows.append(torch.randint(0, vocab, (S,), generator=gen, device=device))
    return torch.stack(rows)


def _window(torch, ctx, engine, calls, per, S, gen_n) -> dict:
    """The closed loop for ``--seconds``, then the drain. Returns the
    end-to-end numbers, the rounds, and (in a traced run) the trace."""
    traffic = ctx.traffic
    submitted: dict[int, float] = {}
    done: dict[int, float] = {}
    rounds = []
    prof = traced = None
    flash_calls, ssd_calls = [], []
    t0 = time.perf_counter()
    while True:
        live = len(engine.cluster.live_nodes)
        want = traffic["backlog_rounds"] * live * per - engine.pending
        now = time.perf_counter()
        for rid in engine.submit(max(want, 0)):
            submitted[rid] = now
        i = len(rounds)
        repair_at = next((j for j, r in enumerate(rounds) if r["repair"]), None)
        if ctx.trace and prof is None and repair_at is not None and i == repair_at + 2:
            spans = _spans(torch, flash_calls, ssd_calls)
            prof = _profiler(torch)
            prof.start()
            t_prof = time.perf_counter()
        before, n_calls = len(engine.completed), len(calls)
        ts = time.perf_counter()
        rep = engine.run_round()
        te = time.perf_counter()
        for rid in list(engine.completed)[before:]:
            done[rid] = te
        mine = calls[n_calls:]
        rounds.append({"step": rep.step, "wall_s": te - ts, "repair": bool(rep.actions),
                       "work_s": sum(c["wall_s"] for c in mine),
                       "rows": [len(c["rids"]) for c in mine]})
        if prof is not None and traced is None and i + 1 == repair_at + 2 + traffic["trace_rounds"]:
            prof.stop()
            t_trace = time.perf_counter() - t_prof
            spans.restore()
            traced = (repair_at + 2, i + 1)
        elapsed = te - t0
        if elapsed >= ctx.seconds and (not ctx.trace or traced is not None):
            break
        if elapsed > 3 * ctx.seconds + 120:
            raise RuntimeError("the traced rounds never came: no repair in the window")
    window = time.perf_counter() - t0
    batch_flops = functools.lru_cache(maxsize=None)(
        lambda rows: flops.serve_batch_flops(ctx.config["model"], rows, S, gen_n))
    for r in rounds:
        r["flops"] = sum(batch_flops(n) for n in r["rows"])
    window_rounds = {r["step"] for r in rounds}
    in_window = [rid for rid in submitted if rid in done]
    tokens = len(in_window) * (S + gen_n)
    for _ in range(traffic["drain_rounds"]):
        if all(rid in done for rid in submitted):
            break
        before = len(engine.completed)
        engine.run_round()
        te = time.perf_counter()
        for rid in list(engine.completed)[before:]:
            done[rid] = te
    # a request never delivered waits at least until the drain gave up
    end = time.perf_counter()
    latency = [done.get(rid, end) - t for rid, t in submitted.items()]
    missing = sum(1 for rid in submitted if rid not in done)
    e2e = {"serve_tokens_per_s": tokens / window, "serve_p95_s": harness.p95(latency)}
    out = {"attempted": len(submitted), "failed": missing, "e2e": e2e,
           "submitted": submitted, "window_rounds": window_rounds, "rounds": rounds}
    if ctx.trace:
        lo, hi = traced
        cfg_d = ctx.config["model"]
        trace = harness.reduce_trace(torch, prof, vocab=cfg_d["vocab_size"], window_s=t_trace)
        trace.update(kind="serve", rounds=rounds, repair_at=repair_at, traced=[lo, hi],
                     flash_calls=flash_calls, ssd_calls=ssd_calls)
        out["trace"] = trace
    return out


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _spans(torch, flash_calls: list, ssd_calls: list):
    from repro_torch.kernels import ops
    from repro_torch.models import api

    def flash(q, k, v, *, causal=True, window=0, logit_softcap=0.0, q_offset=0):
        flash_calls.append({"q": list(q.shape), "k": list(k.shape), "causal": causal,
                            "window": window, "q_offset": q_offset,
                            "softcap": logit_softcap, "itemsize": q.element_size()})

    def ssd(x, dt, A, Bm, Cm, *, chunk=256, initial_state=None):
        ssd_calls.append({"x": list(x.shape), "bm": list(Bm.shape), "chunk": chunk,
                          "has_h0": initial_state is not None, "itemsize": x.element_size()})

    spans = harness.Spans(torch)
    spans.wrap(ops, "flash_attention", "bench.kernel.flash", on_call=flash)
    spans.wrap(ops, "ssd_scan", "bench.kernel.ssd", on_call=ssd)
    spans.wrap(api, "prefill", "bench.serve.prefill")
    spans.wrap(api, "decode_step", "bench.serve.decode")
    return spans


def _delivery(engine, calls: list[dict], submitted: dict, per: int) -> list[Check]:
    """Every request of the window delivered once, with the tokens its
    batch produced; the failed node's batch redelivered."""
    produced: dict[int, np.ndarray] = {}
    for c in calls:
        for rid, row in zip(c["rids"], c["tokens"]):
            produced.setdefault(rid, row)
    lost = sum(1 for rid in submitted
               if rid not in engine.completed
               or not np.array_equal(np.asarray(engine.completed[rid]), produced.get(rid)))
    again = {rid for c in calls for rid, a in zip(c["rids"], c["attempts"]) if a > 1}
    redelivered = sum(1 for rid in again if rid in engine.completed)
    return [Check("lost", float(lost), 0.0),
            Check("unrequeued", float(max(0, per - redelivered)), 0.0)]


def pick(seed: int, calls: list[dict], window_rounds: set, k: int) -> list[int]:
    """``k`` of the window's batches, drawn from the seed, with a batch of
    redelivered requests first."""
    idx = [i for i, c in enumerate(calls) if c["round"] in window_rounds]
    again = [i for i in idx if max(calls[i]["attempts"]) > 1]
    rng = np.random.default_rng(harness.subseed(seed, 4))
    rest = [i for i in idx if i not in again[:1]]
    chosen = again[:1] + list(rng.choice(rest, size=min(k - len(again[:1]), len(rest)),
                                         replace=False))
    return sorted(int(i) for i in chosen)


def reference_gaps(torch, ctx, ref, sample: list[dict], control: bool = False) -> dict:
    """The widest gap between the reference's best logit and the served
    token's over the sample, and the share of served tokens more than
    ``GAP_FLOOR`` below; with ``control``, the same of the tokens the fp8
    reference would put first at the same positions."""
    cfg_d, traffic, dev = ctx.config["model"], ctx.traffic, ctx.device
    S, gen_n = traffic["prompt_len"], traffic["generated"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = harness.nest({p: w.float() for p, w in harness.make_weights(
        torch, ref.layout(cfg_d), ctx.seed, dev).items()})
    worst, worst_c, over_c, tops = 0.0, 0.0, 0, []
    with torch.no_grad():
        for c in sample:
            served = torch.as_tensor(c["tokens"], device=dev, dtype=torch.int64)
            prompt = prompts(torch, ctx.seed, c["rids"], S, cfg_d["vocab_size"], dev)
            tokens = torch.cat([prompt, served[:, :gen_n - 1]], dim=1)
            hidden, _ = ref.forward(cfg_d, params, tokens, prompt_len=S)
            lg = ref.logits(cfg_d, params, hidden[:, S - 1:])            # (B, gen, V)
            best = lg.max(-1).values
            gap = best - lg.gather(-1, served[..., None])[..., 0]
            worst = max(worst, float(gap.max()))
            tops += [(float(g), rid, j) for rid, row in zip(c["rids"], gap.tolist())
                     for j, g in enumerate(row)]
            if control:
                mm = ref.Matmul(fp8=True)
                h8, _ = ref.forward(cfg_d, params, tokens, prompt_len=S, mm=mm)
                pick8 = ref.logits(cfg_d, params, h8[:, S - 1:], mm=mm).argmax(-1)
                gap8 = best - lg.gather(-1, pick8[..., None])[..., 0]
                worst_c = max(worst_c, float(gap8.max()))
                over_c += int((gap8 > GAP_FLOOR).sum())
                del h8
            del hidden, lg
    tops.sort(reverse=True)
    out = {"gap": worst, "gap_share": sum(1 for t in tops if t[0] > GAP_FLOOR) / len(tops),
           "top": tops[:8], "tokens": len(tops)}
    if control:
        out["control"] = {"gap": worst_c, "gap_share": over_c / len(tops)}
    return out
