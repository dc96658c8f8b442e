"""The ``train`` driver: ``ResilientTrainer.run_step`` through node faults.

Set-up builds the trainer on a ``VirtualCluster`` of the traffic's nodes
and legions, writes the benchmark's seeded weights into its parameters and
feeds it the benchmark's seeded batches (the trainer's ``_batch_of``), then
runs the first ``setup_steps`` steps through the same call and feed as the
window: they warm every shape and the repair path (a fault lands in them),
and they are the steps the reference follows. The window then runs steps
for ``--seconds``, with a fault of its own, and one more step, untimed,
from the state the window left. Every step holds the batch of the live
shards: ``rows_per_shard`` sequences of ``seq_len`` tokens a shard, DROP
dropping a failed node's shard. The steps' model FLOPs are counted after
the window.

``correct`` compares the set-up steps with the plain reference
(``reference/decoder.py`` plus the AdamW written out below), on the same
weights and batches and the shard set the faults leave (``readings``):

  * ``loss0``, ``loss``: the relative gap of the first step's loss, and the
    largest over the set-up steps;
  * ``grad``, ``grad_median``: the first gradient as the optimizer got it
    (its first moment after one step over ``1 - beta1``), leaf by leaf: the
    gap between the program's norm of the leaf and the reference's, over
    the larger of that reference norm and the median leaf's; the worst
    leaf's and the median leaf's;
  * ``change``, ``change_median``: the parameters' change after the set-up
    steps, alike; leaves whose reference gradient is under a thousandth of
    the median leaf's are left out (Adam moves them by round-off alone);
  * ``window_loss``, ``window_grad``, ``window_grad_median``: the step
    after the window against one reference step from the parameters the
    window left (the reference cannot follow the window's steps, whose
    count the clock sets): the relative gap of its loss, and its clipped
    gradient's leaf gaps as above, read where the optimizer gets it;
  * ``shards``: the steps whose count of live shards is not the one the
    faults leave (exact, always compared).

The cell's own file names the numbers it compares and their limits. Under
the control (``control.py``) the reference computed in fp8 takes the
program's place in every number but ``shards``.
"""
from __future__ import annotations

import functools
import gc
import math
import time

from bench import flops, harness
from bench.harness import Check


def batch_of(torch, seed: int, step: int, shards: list[int], rows: int, seq: int,
             vocab: int, device) -> dict:
    """The seeded batch of ``shards`` at ``step``, concatenated in the given
    order: each shard's ``rows`` sequences of uniform tokens, labels the
    next token."""
    parts = []
    for s in shards:
        gen = torch.Generator(device=device).manual_seed(harness.subseed(seed, 2, step, s))
        parts.append(torch.randint(0, vocab, (rows, seq + 1), generator=gen, device=device))
    stream = torch.cat(parts)
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def live_shards(traffic: dict, step: int) -> list[int]:
    """The shards a step holds: node n owns shard n, and DROP takes away
    the shard of every node failed at or before ``step``."""
    failed = {node for s, node in traffic["faults"] if s <= step}
    return [n for n in range(traffic["nodes"]) if n not in failed]


def _norms(torch, tree: dict, paths: list[str], scale: float = 1.0) -> dict:
    return {p: float(harness.leaf(tree, p).float().norm()) * scale for p in paths}


def run(ctx) -> dict:
    import torch

    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.core import FaultInjector, LegioPolicy, VirtualCluster
    from repro_torch.core import trainer as trainer_mod

    cfg_d, traffic, dev = ctx.config["model"], ctx.traffic, ctx.device
    ref = harness.reference(ctx.config["reference"])
    layout = ref.layout(cfg_d)
    paths = sorted(layout)
    rows, seq, V = traffic["rows_per_shard"], traffic["seq_len"], cfg_d["vocab_size"]
    tc = TrainConfig(seed=ctx.seed % (1 << 63), batch_policy=traffic["batch_policy"],
                     **ctx.config["train"])
    cluster = VirtualCluster(
        traffic["nodes"], policy=LegioPolicy(legion_size=traffic["legion"],
                                             recovery_mode=traffic["recovery"]),
        injector=FaultInjector.at([tuple(f) for f in traffic["faults"]]), device=dev)
    trainer = trainer_mod.ResilientTrainer(ModelConfig(**cfg_d), tc, cluster,
                                           per_shard_batch=rows, seq_len=seq)
    weights = harness.make_weights(torch, layout, ctx.seed, dev)
    harness.copy_into(torch, trainer.params, weights)
    del weights

    def feed(step, shards):
        if ctx.fault == "half_batch":     # half the batch left out, the mean over the rest
            shards = shards[:max(1, len(shards) // 2)]
        return batch_of(torch, ctx.seed, step, shards, rows, seq, V, dev)

    trainer._batch_of = feed
    adamw = trainer_mod.adamw_update_
    if ctx.fault == "unchanged":          # a step that returns its state unchanged
        trainer_mod.adamw_update_ = lambda g, state, p, tc, lr: state._replace(
            step=state.step + 1)
    try:
        out, prog = _run(torch, ctx, trainer_mod, trainer, paths, layout, tc)
        prog["start"] = {p: harness.leaf(trainer.params, p).detach().clone() for p in paths}
        prog["window"] = _step_after(torch, trainer_mod, trainer, paths)
    finally:
        trainer_mod.adamw_update_ = adamw
    prog["shards"].append(prog["window"]["shards"])
    del trainer, cluster
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = [len(live_shards(traffic, i)) for i in range(len(prog["shards"]))]
    out["checks"] = compare(torch, ctx, ref, layout, prog, want, out)
    return out


def _step_after(torch, trainer_mod, trainer, paths) -> dict:
    """One more step through the same call, untimed: its index, loss and
    live shards, and its clipped gradient's leaf norms as the optimizer
    gets them."""
    seen = {}
    clip = trainer_mod.clip_by_global_norm_

    def recording(grads, max_norm):
        norm = clip(grads, max_norm)
        seen.update(_norms(torch, grads, paths))
        return norm

    trainer_mod.clip_by_global_norm_ = recording
    try:
        step = trainer.step
        r = trainer.run_step()
    finally:
        trainer_mod.clip_by_global_norm_ = clip
    return {"step": step, "loss": r.loss, "grad": seen, "shards": r.active_shards}


def _run(torch, ctx, trainer_mod, trainer, paths, layout, tc):
    """Set-up steps, then the window; returns (result, program readings)."""
    cfg_d, traffic, dev = ctx.config["model"], ctx.traffic, ctx.device
    rows, seq = traffic["rows_per_shard"], traffic["seq_len"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    prog = {"loss": [], "shards": []}
    for i in range(traffic["setup_steps"]):
        r = trainer.run_step()
        prog["loss"].append(r.loss)
        prog["shards"].append(r.active_shards)
        if i == 0:
            prog["grad"] = _norms(torch, trainer.opt.mu, paths, 1.0 / (1.0 - tc.beta1))
    init = harness.make_weights(torch, layout, ctx.seed, dev)
    prog["change"] = {p: float((harness.leaf(trainer.params, p).float()
                                - init[p].float()).norm()) for p in paths}
    del init
    ctx.setup_done()

    steps, repair_at, prof, traced = [], None, None, None
    t0 = time.perf_counter()
    while True:
        i = len(steps)
        if ctx.trace and prof is None and repair_at is not None and i == repair_at + 2:
            spans = _spans(torch, trainer_mod, trainer)
            prof = _profiler(torch)
            prof.start()
            t_prof = time.perf_counter()
        ts = time.perf_counter()
        r = trainer.run_step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        steps.append({"wall_s": time.perf_counter() - ts, "shards": r.active_shards,
                      "tokens": r.active_shards * rows * seq, "repair": r.repair is not None})
        if r.repair is not None and repair_at is None:
            repair_at = i
        if prof is not None and traced is None and i + 1 == repair_at + 2 + traffic["trace_steps"]:
            prof.stop()
            t_trace = time.perf_counter() - t_prof
            spans.restore()
            traced = (repair_at + 2, i + 1)
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds and (not ctx.trace or traced is not None):
            break
        if elapsed > 3 * ctx.seconds + 120:
            raise RuntimeError("the traced steps never came: no repair in the window")
    window = time.perf_counter() - t0
    step_flops = functools.lru_cache(maxsize=None)(
        lambda shards: flops.train_step_flops(cfg_d, shards * rows, seq))
    for s in steps:
        s["flops"] = step_flops(s["shards"])
    prog["shards"] += [s["shards"] for s in steps]
    out = {"attempted": len(steps), "failed": 0,
           "peak": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0,
           "e2e": {"train_tokens_per_s": sum(s["tokens"] for s in steps) / window},
           "readings": {"program": prog}}
    if ctx.trace:
        lo, hi = traced
        trace = harness.reduce_trace(torch, prof, vocab=cfg_d["vocab_size"], window_s=t_trace)
        trace.update(kind="train", steps=steps, repair_at=repair_at, traced=[lo, hi])
        out["trace"] = trace
    return out, prog


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=True)


def _spans(torch, trainer_mod, trainer):
    spans = harness.Spans(torch)
    spans.wrap(trainer_mod, "clip_by_global_norm_", "bench.train.optimizer")
    spans.wrap(trainer_mod, "adamw_update_", "bench.train.optimizer")
    spans.wrap(trainer.session, "boundary", "bench.train.boundary")
    spans.wrap(trainer, "_batch_of", "bench.train.batch")
    spans.wrap(trainer, "train_step", "bench.train.step")
    return spans


def reference_steps(torch, ctx, ref, layout, control: bool = False) -> dict:
    """The reference's set-up steps on the same weights, batches and shard
    sets: each step's loss, the first clipped gradient's leaf norms, the
    change of each leaf after the steps. fp32 with TF32 off, or the model
    in fp8 where the program holds bf16 (``control``); AdamW in fp32, each
    parameter rounded after its update to the dtype the configuration
    holds it in."""
    cfg_d, traffic, dev = ctx.config["model"], ctx.traffic, ctx.device
    tr = ctx.config["train"]
    mm = ref.Matmul(fp8=control)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = sorted(layout)
    params = {p: w.float().requires_grad_(True)
              for p, w in harness.make_weights(torch, layout, ctx.seed, dev).items()}
    m = {p: torch.zeros_like(params[p]) for p in paths}
    v = {p: torch.zeros_like(params[p]) for p in paths}
    out = {"loss": []}
    for step in range(traffic["setup_steps"]):
        loss, grads, scale = _grads(torch, ctx, ref, params, step, mm)
        out["loss"].append(loss)
        lr = tr["learning_rate"] * (0.1 + 0.45 * (1.0 + math.cos(
            math.pi * min(max((step - tr["warmup_steps"]) / max(
                tr["total_steps"] - tr["warmup_steps"], 1), 0.0), 1.0))))
        if step < tr["warmup_steps"]:
            lr = tr["learning_rate"] * step / max(tr["warmup_steps"], 1)
        t = step + 1
        bc1, bc2 = 1.0 - tr["beta1"] ** t, 1.0 - tr["beta2"] ** t
        if step == 0:
            out["grad"] = {p: float(g.norm()) * scale for p, g in grads.items()}
        with torch.no_grad():
            for p, g in grads.items():
                g = g * scale
                m[p].mul_(tr["beta1"]).add_(g, alpha=1.0 - tr["beta1"])
                v[p].mul_(tr["beta2"]).add_(g.square(), alpha=1.0 - tr["beta2"])
                upd = (m[p] / bc1) / ((v[p] / bc2).sqrt() + tr["eps"])
                params[p].sub_(lr * (upd + tr["weight_decay"] * params[p]))
                # the parameters are held in the configuration's dtype
                params[p].copy_(params[p].to(getattr(torch, layout[p][1])))
        del grads
    del m, v
    init = harness.make_weights(torch, layout, ctx.seed, dev)
    out["change"] = {p: float((params[p].detach() - init[p].float()).norm()) for p in paths}
    del params, init
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _grads(torch, ctx, ref, params: dict, step: int, mm):
    """The reference's loss at ``params`` (fp32 leaves, ``path: tensor``)
    on step ``step``'s batch of the shards the faults leave, its gradient
    leaf by leaf (``path: tensor``), and the scale that clips it."""
    cfg_d, traffic, dev = ctx.config["model"], ctx.traffic, ctx.device
    rows, seq, V = traffic["rows_per_shard"], traffic["seq_len"], cfg_d["vocab_size"]
    b = batch_of(torch, ctx.seed, step, live_shards(traffic, step), rows, seq, V, dev)
    loss = ref.train_loss(cfg_d, harness.nest(params), b["tokens"], b["labels"], mm=mm)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = min(1.0, ctx.config["train"]["grad_clip"] / max(float(gnorm), 1e-9))
    return float(loss.detach()), grads, scale


def reference_window(torch, ctx, ref, start: dict, step: int, control: bool = False) -> dict:
    """One reference step from the program's parameters ``start`` (the
    window's last), on step ``step``'s batch: its loss and its clipped
    gradient's leaf norms; fp32 with TF32 off, or fp8 (``control``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {p: w.float().requires_grad_(True) for p, w in start.items()}
    loss, grads, scale = _grads(torch, ctx, ref, params, step, ref.Matmul(fp8=control))
    out = {"loss": loss, "grad": {p: float(g.norm()) * scale for p, g in grads.items()}}
    del params, grads
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _gaps(a: dict, r: dict, keys) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = sorted(r[k] for k in keys)[len(keys) // 2]
    return {k: abs(a[k] - r[k]) / max(r[k], med, 1e-30) for k in keys}


def readings(a: dict, r: dict) -> dict:
    """The numbers compared, of readings ``a`` against the reference's ``r``:
    the relative gap of the first step's loss (``loss0``) and the largest
    over the steps (``loss``); the first gradient's and the change's leaf
    gaps, the worst leaf's (``grad``, ``change``) and the median leaf's
    (``grad_median``, ``change_median``)."""
    rel = [abs(x - y) / abs(y) for x, y in zip(a["loss"], r["loss"])]
    grad = _gaps(a["grad"], r["grad"], list(r["grad"]))
    med_g = sorted(r["grad"].values())[len(r["grad"]) // 2]
    moved = [p for p in r["change"] if r["grad"][p] >= 1e-3 * med_g]
    change = _gaps(a["change"], r["change"], moved)
    median = lambda d: sorted(d.values())[len(d) // 2]  # noqa: E731
    return {"loss0": rel[0], "loss": max(rel), "grad": max(grad.values()),
            "grad_median": median(grad), "change": max(change.values()),
            "change_median": median(change),
            "worst": {"grad": max(grad, key=grad.get), "change": max(change, key=change.get)},
            "left_out": sorted(set(r["change"]) - set(moved))}


def window_readings(a: dict, r: dict) -> dict:
    """The step after the window, of readings ``a`` against the
    reference's ``r``: the relative gap of its loss, its gradient's worst
    and median leaf gaps."""
    grad = _gaps(a["grad"], r["grad"], list(r["grad"]))
    return {"window_loss": abs(a["loss"] - r["loss"]) / abs(r["loss"]),
            "window_grad": max(grad.values()),
            "window_grad_median": sorted(grad.values())[len(grad) // 2],
            "window_worst": max(grad, key=grad.get)}


def compare(torch, ctx, ref, layout, prog: dict, want: list[int], out: dict) -> list[Check]:
    start, step = prog.pop("start"), prog["window"]["step"]
    rw = reference_window(torch, ctx, ref, start, step)
    cw = reference_window(torch, ctx, ref, start, step, control=True) if ctx.control else None
    del start
    r = reference_steps(torch, ctx, ref, layout)
    got = dict(readings(prog, r), **window_readings(prog["window"], rw))
    out["readings"]["reference"] = dict(r, window=rw)
    out["readings"]["gaps"] = got
    if ctx.control:
        c = reference_steps(torch, ctx, ref, layout, control=True)
        out["readings"]["control"] = dict(readings(c, r), **window_readings(cw, rw))
    # the control, the reference in fp8, takes the program's place
    judged = out["readings"]["control"] if ctx.control else got
    shards_off = sum(1 for a, b in zip(prog["shards"], want) if a != b)
    return ([Check(k, judged[k], limit) for k, limit in ctx.limits.items()]
            + [Check("shards", float(shards_off), 0.0)])
