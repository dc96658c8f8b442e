#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

From the root of a checkout, with no arguments. It imports only the port
(``src/repro_torch``), never JAX or the JAX package, and runs, in order:

  1. card identity: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: the three CUDA sources (flash attention, SSD scan, the int8
     absmax/quantize pair) from ``src/repro_torch/kernels/csrc`` with one
     nvcc each, in parallel, timed;
  3. kernels vs plain, on the card:
     - flash attention over the JAX package's kernel-test cases in f32 (tol
       2e-5) and bf16 (tol 2e-2) and ragged cases; at llama3.2-3b's serving
       shape (B=4, S=1024, H=24, K=8, hd=128, causal) and at hymba-1.5b's
       (B=4, S=2048, H=25, K=5, hd=64, causal, window 1024), both bf16,
       where it also times the kernel, the plain version and one
       ``scaled_dot_product_attention`` call;
     - the SSD scan over the JAX package's kernel-test sweep in f32 (tol
       2e-4) and bf16 (tol 3e-2) with h0, S = 40 at chunk 16 against the
       token-by-token ``ssd_decode_step`` loop, the two-call state handoff,
       and hymba-1.5b's (H=50, P=64, N=16) and mamba2-130m's (H=24, P=64,
       N=128) path shapes (B=4, S=2048, Q=256, bf16), also with x, B and C
       as strided views into one projection as the model passes them,
       timed with the plain version beside it;
     - absmax and quantize against their plain versions on the card and
       ``compress_int8_np`` on the host, bit for bit, over the CPU tests'
       cases (ties, the reciprocal trap, subnormals, empty), a view off the
       16-byte grid and a stale scale; then at the runtime's path shape, one
       f32 tensor of 128,983,488 elements (mamba2-130m's full gradient),
       timed beside the plain versions and ``vector_norm(ord=inf)``;
  4. models, kernels vs plain: llama3.2-3b and hymba-1.5b at full width cut
     to 2 layers and mamba2-130m at full width and depth, bf16 prefill
     logits with ``use_pallas`` on and off, each held against the same
     weights run in fp32; and the three smoke configs in f32, greedy tokens
     with the kernels against without;
  5. serve at full width: ``ResilientServer`` on llama3.2-3b (28 layers,
     prompts of 1024), hymba-1.5b (32 layers, d=1600, prompts of 2048, past
     its 1024 window) and mamba2-130m (24 layers, prompts of 2048), each
     2 nodes x 4 requests and 16 generated tokens; every request must
     complete, and each kernel must have launched once per layer per
     prefill on the paths that run it (launch counts zeroed just before
     each run and read just after); each model's server is freed before
     the next one is built, so each peak memory is that model's own;
  6. where the time goes: right after the llama3.2-3b and hymba-1.5b serve
     runs, one prefill and one decode step at the serve shape under
     ``torch.profiler``: the device's busy share and the kernels that take
     most of it;
  7. the Legio runtime, this slice's main path: ``Session(16)`` with legions
     of 4, int8 compression on the cross-legion hop, the torch data plane
     on the card and examples/transparent_mpi.py's faults (2, 9), (5, 4),
     (7, 11); ten ``comm.allreduce`` calls over the live ranks, each rank's
     payload 128,983,488 f32 drawn on the card per (rank, step). Every
     allreduce must reach every member, 13 ranks must survive, and the
     absmax and quantize kernels must each have launched once per level-1
     participant of every step's stage list (counts zeroed just before,
     read just after). Per-step times, the peak memory and one profiled
     step follow; then the same script with the plain versions in place of
     the kernels (byte-identical each step), at 1,048,576 elements against
     the sim plane on the host (byte-identical results, stages and
     ``sim_seconds``), and with 1-element payloads (the host's share).

Any failed phase exits non-zero. Without a CUDA device it exits 1 and prints
no result. The last three lines are the card's ``nvidia-smi`` line, the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 on the CUDA cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # flash attention (the reference's)
SSD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}    # SSD scan (the reference's)
# phase 4: the RMS distance of the bf16 kernel path's logits from the fp32
# model's may be at most this multiple of the bf16 plain path's. Both paths
# differ from fp32 by bf16 rounding (the flash kernel also rounds P to bf16
# for P.V); a fault in a kernel (mask, head mapping, softmax, decay) moves
# logits by their own scale, ~80x the rounding noise. The RMS is used, not
# the max: the max of many noisy logits is an extreme value that moves from
# run to run.
MODEL_RMS_RATIO = 2.0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(torch, fn, runs: int, reps: int = 1, warmup: int = 3) -> float:
    """Median over ``runs`` samples of the CUDA-event time per call of ``fn``.

    A sample times ``reps`` back-to-back calls and divides by ``reps``: with
    ``reps`` > 1 the card's queue stays full and the host's launch latency
    drops out, which is how a kernel's time is read. With ``reps`` = 1 each
    call starts on an idle card, which is how a step's latency is read.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def live_pairs(Sq: int, Sk: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the mask lets through: the work this input needs."""
    total = 0
    for i in range(Sq):
        q = q_offset + i
        hi = min(Sk - 1, q) if causal else Sk - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def ssd_flops(B: int, S: int, H: int, P: int, N: int, Q: int,
              has_h0: bool) -> tuple[int, int]:
    """Multiply-adds (x2) the SSD scan needs, as (C.B^T, the rest): per chunk
    of r real rows, the lower triangle of C.B^T (N deep; both operands in
    x's dtype) and of W.x (P wide), C.h^T (skipped for the first chunk when
    the state starts at zero) and the state update (each with an fp32
    operand: the weights W, the state h, the decayed dt)."""
    cb = rest = 0
    for c, start in enumerate(range(0, S, Q)):
        r = min(Q, S - start)
        pairs = r * (r + 1) // 2
        cb += 2 * pairs * N
        rest += 2 * pairs * P + 2 * r * P * N * (2 if (c or has_h0) else 1)
    return B * H * cb, B * H * rest


def bound(op_seconds: float, nbytes: int) -> tuple[float, str]:
    """The larger of the operations' time at their peaks and the bytes' time."""
    t_bytes = nbytes / PEAK_BYTES
    return max(op_seconds, t_bytes) * 1e3, ("operations" if op_seconds >= t_bytes else "bytes")


def profile_step(torch, step):
    """(device-busy ms, wall ms, top kernels) of one ``step`` under the profiler.

    Busy time sums the device kernels' own time; the profiler slows the host,
    so the busy share it gives is a lower bound.
    """
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.cpu_time_total == 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                    for e in kernels[:6])
    return busy_ms, wall_ms, top


def to_float(tree):
    """A parameter pytree with every leaf in fp32."""
    if isinstance(tree, dict):
        return {k: to_float(v) for k, v in tree.items()}
    return tree.float()


# ---- the int8 compression hop's kernels (phase 3) and the runtime (phase 7)
QUANT_SHAPES = [(4,), (130,), (1000,), (64, 257), (3, 5, 7),
                (1,), (127,), (128,), (129,), (100_003,)]
GRAD_ELEMS = 128_983_488        # mamba2-130m's parameter count: its full f32 gradient
RUNTIME_NODES, RUNTIME_LEGION, RUNTIME_STEPS = 16, 4, 10
RUNTIME_FAULTS = [(2, 9), (5, 4), (7, 11)]   # examples/transparent_mpi.py; 4 is a master
RUNTIME_SMALL_ELEMS = 1_048_576


def quantize_cases(np):
    """The CPU tests' inputs (tests/test_torch_quantize.py), made with numpy."""
    cases = {}
    for shape in QUANT_SHAPES:
        rng = np.random.default_rng(sum(shape) * 7919 + len(shape))
        cases[f"normal{shape}"] = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    cases["zeros"] = np.zeros(32, np.float32)
    cases["minus_2_5"] = np.float32([-2.5])
    halves = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)) * np.float32(0.125)
    cases["half_even_ties"] = np.concatenate([np.float32([15.875]), halves])
    absmax = np.float32(11.6982651)
    s = np.maximum(absmax, np.float32(1e-12)) / np.float32(127.0)
    x = ((np.arange(-126, 126, dtype=np.float32) + np.float32(0.5)) * s).astype(np.float32)
    near = [x]
    for direction in (np.inf, -np.inf):
        y = x
        for _ in range(3):
            y = np.nextafter(y, np.float32(direction)).astype(np.float32)
            near.append(y)
    cases["reciprocal_trap"] = np.concatenate([np.float32([absmax]), *near])
    tiny = np.random.default_rng(11).uniform(-1, 1, 64).astype(np.float32) * np.float32(1e-39)
    cases["subnormals_mixed"] = np.concatenate([tiny, np.float32([3.0, -1e-40])])
    cases["subnormals_only"] = tiny
    cases["empty"] = np.zeros((0,), np.float32)
    return cases


def twin_int8(np, C, g):
    """compress_int8_np's (scale, q); for an empty input the reference's
    empty-input scale 1e-12 / 127 (numpy's max of nothing raises)."""
    if g.size == 0:
        return np.float32(1e-12) / np.float32(127.0), np.zeros(g.shape, np.int8)
    c = C.compress_int8_np(g)
    return np.float32(c.scale), c.q


def quantize_bitwise(torch, np, C, Q, name, g, x):
    """absmax + scale + quantize through the kernels, through the plain
    versions on the card, and compress_int8_np on the host: bit for bit."""
    am_k = Q.absmax_cuda(x)
    sk = Q.int8_scale(am_k)
    qk = Q.quantize_int8_cuda(x, sk)
    am_p = Q.absmax_plain(x)
    sp = Q.int8_scale(am_p)
    qp = Q.quantize_plain(x, sp)
    torch.cuda.synchronize()
    ts, tq = twin_int8(np, C, g)
    sk_b, sp_b = sk.cpu().numpy().tobytes(), sp.cpu().numpy().tobytes()
    qk_n, qp_n = qk.cpu().numpy(), qp.cpu().numpy()
    ok = (am_k.cpu().numpy().tobytes() == am_p.cpu().numpy().tobytes()
          and sk_b == sp_b == np.float32(ts).tobytes()
          and qk_n.tobytes() == qp_n.tobytes() == tq.tobytes() and qk_n.shape == g.shape)
    err = float(np.abs(qk_n.astype(np.int32) - tq.astype(np.int32)).max()) if g.size else 0.0
    print(f"[3] quantize {name:<22} n={g.size:<10} absmax {am_k.item():.6e} scale "
          f"{sk.item():.6e} kernel==plain==numpy twin bitwise: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"quantize kernels disagree with the plain versions or "
                             f"compress_int8_np: {name}")
    return err


def device_allocs(torch) -> int:
    """cudaMalloc calls the caching allocator has made so far (0 off the card)."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.memory_stats().get("num_device_alloc", 0)


def draw_grad(torch, dev, rank, step, n):
    """One rank's gradient-like payload for one step, drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(1_000 * step + rank)
    return torch.randn(n, generator=gen, device=dev).mul_(1e-3)


def runtime_run(torch, P, PM, dev, n, plane, keep=True, sync=True):
    """The slice's main path: Session(16) with int8 compression and the
    transparent_mpi fault script, one allreduce over the live ranks a step.
    Returns (session, per-step records)."""
    sess = PM.Session(RUNTIME_NODES,
                      policy=P.LegioPolicy(legion_size=RUNTIME_LEGION, grad_compression="int8",
                                           data_plane=plane),
                      injector=P.FaultInjector.at(RUNTIME_FAULTS), device=dev)
    comm, cl = sess.world, sess.cluster
    records = []
    for step in range(RUNTIME_STEPS):
        t0 = time.perf_counter()
        sess.advance(step)
        contributions = {r: draw_grad(torch, dev, r, step, n) for r in cl.live_nodes}
        if plane == "sim":
            contributions = {r: v.cpu().numpy() for r, v in contributions.items()}
        if sync:
            torch.cuda.synchronize()
        allocs, modules = device_allocs(torch), set(sys.modules)
        t1 = time.perf_counter()
        res = comm.allreduce(contributions)
        t_host = time.perf_counter()
        imported = sorted(set(sys.modules) - modules)
        if sync:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = res.data[comm.members[0]]
        if len(res.data) != comm.size or any(v is not out for v in res.data.values()):
            raise AssertionError(f"step {step}: the allreduce did not reach every member")
        if tuple(out.shape) != (n,):
            raise AssertionError(f"step {step}: result shape {tuple(out.shape)}")
        level1 = next(st for st in res.stages if st[0] == "global")
        records.append(dict(step=step, out=out if keep else None, stages=list(res.stages),
                            sim_seconds=res.sim_seconds, size=comm.size,
                            compressed=level1[1], draw_ms=(t1 - t0) * 1e3,
                            allreduce_ms=(t2 - t1) * 1e3, host_ms=(t_host - t1) * 1e3,
                            device_allocs=device_allocs(torch) - allocs, imported=imported))
        del contributions
    if cl.topo.depth != 2:
        raise AssertionError(f"expected a two-level topology, got depth {cl.topo.depth}")
    return sess, records


@contextlib.contextmanager
def plain_quantize(ops, Q):
    """Within the block the data plane's compression runs the kernels' plain
    versions on CUDA tensors: the second run the runtime phase compares."""
    saved = ops.absmax, ops.quantize_int8
    ops.absmax, ops.quantize_int8 = Q.absmax_plain, Q.quantize_plain
    try:
        yield
    finally:
        ops.absmax, ops.quantize_int8 = saved


def quantize_phase(torch, np, C, Q, dev) -> dict:
    """Phase 3 for the compression hop: absmax and quantize on the card
    against their plain versions on the card and compress_int8_np on the
    host, bit for bit, over the CPU tests' cases, a view off the 16-byte
    grid (the scalar loop) and a stale scale (the clip); then the path shape,
    timed. Returns each kernel's record for the kernels line."""
    cases = quantize_cases(np)
    for name, g in cases.items():
        quantize_bitwise(torch, np, C, Q, name, g, torch.from_numpy(g.copy()).to(dev))
    g = cases["normal(100003,)"]
    shifted = torch.from_numpy(np.concatenate([np.float32([0.0]), g])).to(dev)[1:]
    quantize_bitwise(torch, np, C, Q, "view_off_16_bytes", g, shifted)
    x = torch.from_numpy(g).to(dev)
    stale = Q.int8_scale(Q.absmax_plain(x) * 0.01)
    s_host = stale.cpu().numpy()
    want = np.clip(np.round(g / s_host), -127, 127).astype(np.int8).tobytes()
    clip_ok = (Q.quantize_int8_cuda(x, stale).cpu().numpy().tobytes() == want
               == Q.quantize_plain(x, stale).cpu().numpy().tobytes())
    print(f"[3] quantize stale scale (values past +-127 scales) kernel==plain==numpy "
          f"bitwise: {'ok' if clip_ok else 'FAIL'}")
    if not clip_ok:
        raise AssertionError("quantize kernel clips differently from its plain version")

    xg = draw_grad(torch, dev, 0, 0, GRAD_ELEMS)
    quant_err = quantize_bitwise(torch, np, C, Q, "path_shape", xg.cpu().numpy(), xg)
    absmax_err = (Q.absmax_cuda(xg) - Q.absmax_plain(xg)).abs().item()
    inf_norm = lambda: torch.linalg.vector_norm(xg, ord=float("inf"))  # noqa: E731
    if inf_norm().item() != Q.absmax_cuda(xg).item():
        raise AssertionError("vector_norm(inf) and the absmax kernel disagree")
    scale = Q.int8_scale(Q.absmax_cuda(xg))
    quant_times = dict(
        absmax=(time_ms(torch, lambda: Q.absmax_cuda(xg), runs=20, reps=20),
                time_ms(torch, lambda: Q.absmax_plain(xg), runs=10, reps=5),
                time_ms(torch, inf_norm, runs=20, reps=20)),
        quantize_int8=(time_ms(torch, lambda: Q.quantize_int8_cuda(xg, scale), runs=20, reps=20),
                       time_ms(torch, lambda: Q.quantize_plain(xg, scale), runs=10, reps=5),
                       None))
    n_bytes = {"absmax": 4 * GRAD_ELEMS, "quantize_int8": 5 * GRAD_ELEMS}
    n_ops = {"absmax": 2 * GRAD_ELEMS, "quantize_int8": 5 * GRAD_ELEMS}   # |x|, max / div, round, 2 clips, cast
    quant_records = {}
    for name, (kernel_ms, plain_ms, library_ms) in quant_times.items():
        bound_ms, bound_by = bound(n_ops[name] / PEAK_FP32_FLOPS, n_bytes[name])
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        print(f"[3] {name} path shape f32 ({GRAD_ELEMS},): kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {lib} bound_ms {bound_ms:.4f} ({bound_by}; "
              f"{n_bytes[name]} B) kernel GB/s {n_bytes[name] / kernel_ms / 1e6:.1f}")
        quant_records[name] = dict(max_abs_err=absmax_err if name == "absmax" else quant_err,
                                   ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=library_ms)
    print("[3] quantize_int8 library_ms none: no one PyTorch call computes it "
          "(torch.quantize_per_tensor clamps to -128 and multiplies by 1/scale)")
    del xg, x, shifted
    torch.cuda.empty_cache()
    return quant_records


def runtime_phase(torch, P, PM, ops, Q, dev, counters) -> dict:
    """Phase 7, the slice's main path: the Legio runtime at full size with
    every kernel's count zeroed just before and read just after; then the
    same script with the plain versions (byte-identical per step), at
    1,048,576 elements against the sim plane on the host, and with
    1-element payloads (the host's share). Returns the main path's counts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    sess, kernel_run = runtime_run(torch, P, PM, dev, GRAD_ELEMS, "torch")
    torch.cuda.synchronize()
    rt_launches = {name: fn.launches for name, fn in counters.items()}
    rt_peak = torch.cuda.max_memory_allocated()
    compressed = sum(r["compressed"] for r in kernel_run)
    for r in kernel_run:
        finite = bool(torch.isfinite(r["out"]).all())
        print(f"[7] step {r['step']}: {r['size']} ranks, draw {r['draw_ms']:.3f} ms, allreduce "
              f"{r['allreduce_ms']:.3f} ms (wall, card synchronised; the call returned to the "
              f"host after {r['host_ms']:.3f} ms, {r['device_allocs']} new device "
              f"allocations, {len(r['imported'])} modules imported {r['imported'][:4]}), "
              f"level-1 participants "
              f"{r['compressed']}, stages {len(r['stages'])}, sim_seconds {r['sim_seconds']!r} "
              f"(the alpha-beta model's estimate at the reference's link constants, not a "
              f"card measurement), finite {finite}")
        if not finite:
            raise AssertionError(f"runtime step {r['step']}: non-finite result")
    print(f"[7] runtime launches {json.dumps(rt_launches)}; level-1 participants summed over "
          f"steps {compressed}; peak memory {rt_peak / 2**30:.2f} GiB ({rt_peak} B)")
    want = {"flash_attention": 0, "ssd_scan": 0, "absmax": compressed,
            "quantize_int8": compressed}
    if rt_launches != want or compressed == 0:
        raise AssertionError(f"runtime launches {rt_launches}, expected {want}")
    if kernel_run[-1]["size"] != 13 or sess.world.size != 13:
        raise AssertionError(f"expected 13 survivors, got {sess.world.size}")
    print(f"[7] {RUNTIME_STEPS} allreduces of {GRAD_ELEMS} f32 per rank completed, "
          f"{sess.world.size} of {RUNTIME_NODES} ranks survive")

    def runtime_step():
        sess.advance()
        sess.world.allreduce({r: draw_grad(torch, dev, r, sess.step, GRAD_ELEMS)
                              for r in sess.cluster.live_nodes})

    busy_ms, wall_ms, top = profile_step(torch, runtime_step)
    print(f"[7] one runtime step (13 ranks) under the profiler: wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of wall); top: {top}")
    del sess

    before = {name: fn.launches for name, fn in counters.items()}
    with plain_quantize(ops, Q):
        _, plain_run = runtime_run(torch, P, PM, dev, GRAD_ELEMS, "torch")
    torch.cuda.synchronize()
    if any(fn.launches != before[name] for name, fn in counters.items()):
        raise AssertionError("the plain-version run launched a kernel")
    same = [torch.equal(a["out"].view(torch.int32), b["out"].view(torch.int32))
            and a["stages"] == b["stages"] and a["sim_seconds"] == b["sim_seconds"]
            for a, b in zip(kernel_run, plain_run)]
    print(f"[7] kernels vs plain versions, full size, per step byte-identical: {same}; the "
          f"plain-version run (a second session in this process): allreduce ms "
          f"{[round(r['allreduce_ms'], 3) for r in plain_run]}, returned to the host after "
          f"{[round(r['host_ms'], 3) for r in plain_run]} ms, modules imported "
          f"{[len(r['imported']) for r in plain_run]}")
    if not all(same) or len(same) != RUNTIME_STEPS:
        raise AssertionError("the runtime through the kernels differs from the plain versions")
    del kernel_run, plain_run
    torch.cuda.empty_cache()

    _, small_t = runtime_run(torch, P, PM, dev, RUNTIME_SMALL_ELEMS, "torch")
    _, small_s = runtime_run(torch, P, PM, dev, RUNTIME_SMALL_ELEMS, "sim")
    same = [a["out"].cpu().numpy().tobytes() == b["out"].tobytes()
            and a["stages"] == b["stages"] and a["sim_seconds"] == b["sim_seconds"]
            for a, b in zip(small_t, small_s)]
    print(f"[7] torch plane on the card vs sim plane on the host at {RUNTIME_SMALL_ELEMS} "
          f"elements, per step byte-identical (results, stages, sim_seconds): {same}")
    if not all(same) or len(same) != RUNTIME_STEPS:
        raise AssertionError("the torch plane differs from the sim plane")
    _, tiny = runtime_run(torch, P, PM, dev, 1, "torch", keep=False)
    host_ms = [r["allreduce_ms"] for r in tiny]
    print(f"[7] allreduce of 1-element payloads on the card (host control plane plus "
          f"launches): median {statistics.median(host_ms):.3f} ms, per step "
          f"{[round(t, 3) for t in host_ms]}")
    return rt_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch import core as rt_core, mpi as rt_mpi
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import _build, ops, quantize
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
    from repro_torch.launch.serve import ResilientServer, greedy_generate
    from repro_torch.models import api
    from repro_torch.models.ssd import ssd_decode_step
    from repro_torch.optim import compression

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # ---- 1. card identity -------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] nvidia-smi: {card}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_paths = _build.build(["flash_attention", "ssd_scan", "quantize"])
    print(f"[2] built {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)} "
          f"in {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels vs plain on the card ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def qkv(B, Sq, Sk, H, K, hd, dtype):
        return [randn(s, dtypes[dtype]) for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]

    def check(name, dtype, out, ref, tol=None):
        tol = TOL[dtype] if tol is None else tol
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol + tol * ref.float().abs()).all())
        print(f"[3] {name:<28} {dtype:<8} max_abs_err {err.max().item():.3e} "
              f"tol {tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {name} {dtype}")
        return err.max().item()

    cases = [  # name, (B, Sq, Sk, H, K, hd), kwargs
        ("mha_causal", (1, 128, 128, 4, 4, 32), dict(causal=True)),
        ("gqa_4x", (2, 128, 128, 8, 2, 32), dict(causal=True)),
        ("mqa", (1, 256, 256, 4, 1, 64), dict(causal=True)),
        ("window_64", (1, 128, 128, 4, 2, 32), dict(causal=True, window=64)),
        ("softcap_30", (1, 128, 128, 4, 2, 32), dict(causal=True, logit_softcap=30.0)),
        ("cross_noncausal", (2, 64, 192, 4, 4, 32), dict(causal=False)),
        ("q_offset_64", (1, 64, 128, 4, 4, 32), dict(causal=True, q_offset=64)),
        ("hd_128", (1, 256, 256, 4, 2, 128), dict(causal=True)),
        ("hd_256", (1, 256, 256, 4, 2, 256), dict(causal=True)),
        ("hd_24_ragged_window", (1, 100, 100, 6, 2, 24), dict(causal=True, window=40)),
        ("ragged_1000", (2, 1000, 1000, 8, 2, 128), dict(causal=True)),
    ]
    for dtype in ("float32", "bfloat16"):
        for name, shape, kw in cases:
            q, k, v = qkv(*shape, dtype)
            check(name, dtype, flash_attention_cuda(q, k, v, **kw),
                  flash_attention_plain(q, k, v, **kw))
        # tiling invariance: two query halves with q_offset == the whole
        q, k, v = qkv(1, 256, 256, 4, 2, 32, dtype)
        whole = flash_attention_cuda(q, k, v, causal=True)
        halves = torch.cat([flash_attention_cuda(q[:, :128].contiguous(), k, v, causal=True),
                            flash_attention_cuda(q[:, 128:].contiguous(), k, v, causal=True,
                                                 q_offset=128)], dim=1)
        check("split_q_invariance", dtype, halves, whole)

    def flash_path(label, B, S, H, K, hd, window):
        """Check and time the flash kernel at a serving path's shape (bf16, causal)."""
        q, k, v = qkv(B, S, S, H, K, hd, "bfloat16")
        kw = dict(causal=True, window=window)
        out = flash_attention_cuda(q, k, v, **kw)
        err = check(f"path_shape_{label}", "bfloat16", out, flash_attention_plain(q, k, v, **kw))
        kernel_ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw), runs=20, reps=20)
        plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw), runs=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window:  # the window as a boolean mask (True = attend)
            ones = torch.ones((S, S), dtype=torch.bool, device=dev)
            mask = ones.tril() & ~ones.tril(-window)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
        else:
            lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
        library_ms = time_ms(torch, lib, runs=20, reps=20)
        lib_err = (lib().transpose(1, 2).float() - out.float()).abs().max().item()
        flops = 4 * hd * live_pairs(S, S, True, window, 0) * B * H
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
        bound_ms, bound_by = bound(flops / PEAK_BF16_FLOPS, nbytes)
        print(f"[3] flash path shape {label} B={B} S={S} H={H} K={K} hd={hd} bf16 causal "
              f"window={window}: kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) kernel TFLOP/s "
              f"{flops / kernel_ms / 1e9:.1f} sdpa_vs_kernel_max_abs {lib_err:.3e}")
        return dict(shape=f"{label}: B={B} S={S} H={H} K={K} hd={hd} bf16 causal window={window}",
                    max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms)

    flash_shapes = [flash_path("llama3.2-3b", 4, 1024, 24, 8, 128, 0),
                    flash_path("hymba-1.5b", 4, 2048, 25, 5, 64, 1024)]

    def ssd_inputs(B, S, H, P, G, N, dtype, with_h0=True):
        """The JAX package's kernel-test distribution, drawn on the card."""
        dt = torch.nn.functional.softplus(randn((B, S, H)))
        A = -torch.exp(randn((H,), scale=0.5))
        h0 = randn((B, H, P, N), scale=0.1) if with_h0 else None
        return (randn((B, S, H, P), dtypes[dtype]), dt, A,
                randn((B, S, G, N), dtypes[dtype], 0.3), randn((B, S, G, N), dtypes[dtype], 0.3),
                h0)

    def ssd_check(name, dtype, got, want, tol=None):
        tol = SSD_TOL[dtype] if tol is None else tol
        return max(check(f"{name}_y", dtype, got[0], want[0], tol),
                   check(f"{name}_state", dtype, got[1], want[1], tol))

    sweep = [(2, 128, 4, 16, 2, 32, 32), (1, 256, 8, 32, 2, 64, 64),
             (1, 64, 4, 16, 1, 32, 64), (2, 96, 4, 16, 4, 32, 32)]
    for dtype in ("float32", "bfloat16"):
        for B, S, H, P, G, N, Q in sweep:
            x, dt, A, Bm, Cm, h0 = ssd_inputs(B, S, H, P, G, N, dtype)
            ssd_check(f"ssd_{B}x{S}x{H}x{P}_g{G}_n{N}_q{Q}", dtype,
                      ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q, initial_state=h0),
                      ssd_scan_plain(x, dt, A, Bm, Cm, chunk=Q, initial_state=h0))
    # ground truth: S = 40 at chunk 16 (a padded chunk) vs the token-by-token recurrence
    x, dt, A, Bm, Cm, _ = ssd_inputs(1, 40, 2, 8, 1, 16, "float32", with_h0=False)
    state = torch.zeros((1, 2, 8, 16), device=dev)
    ys = []
    for t in range(40):
        yt, state = ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], state)
        ys.append(yt)
    ssd_check("ssd_s40_q16_vs_sequential", "float32",
              ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=16), (torch.stack(ys, 1), state), tol=1e-4)
    # state handoff: two calls through the state == one call
    x, dt, A, Bm, Cm, _ = ssd_inputs(1, 64, 2, 8, 1, 16, "float32", with_h0=False)
    y1, h1 = ssd_scan_cuda(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], chunk=32)
    y2, h2 = ssd_scan_cuda(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], chunk=32,
                           initial_state=h1)
    ssd_check("ssd_state_handoff", "float32", (torch.cat([y1, y2], 1), h2),
              ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=32), tol=1e-4)

    def ssd_path(label, B, S, H, P, G, N, Q):
        """Check and time the SSD kernel at a serving path's shape (bf16, h0 = 0 as in prefill)."""
        x, dt, A, Bm, Cm, _ = ssd_inputs(B, S, H, P, G, N, "bfloat16", with_h0=False)
        out = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q)
        plain = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=Q)
        err = ssd_check(f"ssd_path_{label}", "bfloat16", out, plain)
        # the model's layout: x, B and C as strided views into one projection
        xbc = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
                         Cm.reshape(B, S, G * N)], dim=-1)
        xv, bv, cv = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
        ssd_check(f"ssd_path_{label}_views", "bfloat16",
                  ssd_scan_cuda(xv.reshape(B, S, H, P), dt, A, bv.reshape(B, S, G, N),
                                cv.reshape(B, S, G, N), chunk=Q), plain)
        del xbc, xv, bv, cv
        kernel_ms = time_ms(torch, lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q),
                            runs=20, reps=20)
        plain_ms = time_ms(torch, lambda: ssd_scan_plain(x, dt, A, Bm, Cm, chunk=Q), runs=10)
        cb_flops, rest_flops = ssd_flops(B, S, H, P, N, Q, has_h0=False)
        flops = cb_flops + rest_flops
        nbytes = sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm, *out))
        # C.B^T multiplies two bf16 operands (exact products, fp32 sums): the
        # bf16 tensor-core peak; the products with an fp32 operand: the fp32 peak
        bound_ms, bound_by = bound(cb_flops / PEAK_BF16_FLOPS + rest_flops / PEAK_FP32_FLOPS,
                                   nbytes)
        print(f"[3] ssd path shape {label} B={B} S={S} H={H} P={P} G={G} N={N} Q={Q} bf16: "
              f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms none "
              f"bound_ms {bound_ms:.4f} ({bound_by}; C.B^T {cb_flops / 1e9:.2f} GFLOP at the "
              f"bf16 peak, the rest {rest_flops / 1e9:.2f} GFLOP at the fp32 peak, "
              f"{nbytes / 1e6:.2f} MB) kernel TFLOP/s {flops / kernel_ms / 1e9:.2f}")
        return dict(shape=f"{label}: B={B} S={S} H={H} P={P} G={G} N={N} Q={Q} bf16",
                    max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None)

    ssd_shapes = [ssd_path("hymba-1.5b", 4, 2048, 50, 64, 1, 16, 256),
                  ssd_path("mamba2-130m", 4, 2048, 24, 64, 1, 128, 256)]
    torch.cuda.empty_cache()

    quant_records = quantize_phase(torch, np, compression, quantize, dev)

    # ---- 4. models: kernels vs plain -------------------------------------
    def model_check(cfg2, batch, seq):
        params = api.init_params(cfg2, torch.Generator(device=dev).manual_seed(0), dev)
        tokens = torch.randint(0, cfg2.vocab_size, (batch, seq),
                               generator=torch.Generator().manual_seed(1)).to(dev)
        cfg32 = cfg2.replace(dtype="float32", param_dtype="float32")
        with torch.no_grad():
            lk, _ = api.prefill(cfg2.replace(use_pallas=True), params, tokens, seq + 16)
            lp, _ = api.prefill(cfg2.replace(use_pallas=False), params, tokens, seq + 16)
            lf, _ = api.prefill(cfg32, to_float(params), tokens, seq + 16)
        torch.cuda.synchronize()
        if not (torch.isfinite(lk).all() and lk.shape == (batch, 1, cfg2.vocab_size)):
            raise AssertionError(f"{cfg2.name}: prefill logits are not finite or misshapen")
        rms_kernel = (lk - lf).square().mean().sqrt().item()
        rms_plain = (lp - lf).square().mean().sqrt().item()
        print(f"[4] {cfg2.name} d={cfg2.d_model} {cfg2.n_layers} layers prefill B={batch} "
              f"S={seq}: logits std {lf.std().item():.3f}; vs the fp32 model: bf16 kernels "
              f"rms {rms_kernel:.3e} max {(lk - lf).abs().max().item():.3e}, bf16 plain rms "
              f"{rms_plain:.3e} max {(lp - lf).abs().max().item():.3e}; rms ratio "
              f"{rms_kernel / rms_plain:.3f} (limit {MODEL_RMS_RATIO})")
        if rms_kernel > MODEL_RMS_RATIO * rms_plain:
            raise AssertionError(f"{cfg2.name}: logits through the kernels are further from "
                                 "fp32 than rounding explains")
        del params
        torch.cuda.empty_cache()

    model_check(get_config("llama3.2-3b").replace(n_layers=2), 2, 1024)
    model_check(get_config("hymba-1.5b").replace(n_layers=2), 2, 2048)
    model_check(get_config("mamba2-130m"), 2, 2048)

    for arch in ("llama3.2-3b", "hymba-1.5b", "mamba2-130m"):
        smoke = get_smoke_config(arch).replace(dtype="float32", param_dtype="float32")
        sparams = api.init_params(smoke, torch.Generator(device=dev).manual_seed(0), dev)
        prompts = torch.randint(0, smoke.vocab_size, (3, 96),
                                generator=torch.Generator().manual_seed(2)).to(dev)
        toks_k = greedy_generate(smoke.replace(use_pallas=True), sparams, prompts, 8)
        toks_p = greedy_generate(smoke.replace(use_pallas=False), sparams, prompts, 8)
        same = bool(torch.equal(toks_k, toks_p))
        print(f"[4] {smoke.name} f32 greedy tokens, kernels vs plain path: "
              f"{'identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{arch}: f32 greedy tokens differ with and without the kernels")
        del sparams

    # ---- 5. serve at full width ------------------------------------------
    nodes, per_node, n_req, n_dec = 2, 4, 8, 16
    counters = {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda,
                "absmax": quantize.absmax_cuda, "quantize_int8": quantize.quantize_int8_cuda}
    launches_by_path = {}

    def serve(arch, prompt_len, profile):
        cfg = get_config(arch)
        server = ResilientServer(cfg, nodes=nodes, prompt_len=prompt_len, decode_tokens=n_dec,
                                 batch_per_node=per_node, device=dev)
        n_params = api.count_params(server.params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        rep = server.run(n_req)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        print(f"[5] serve {arch} full width ({n_params / 1e9:.3f} B params, {cfg.n_layers} "
              f"layers, d={cfg.d_model}, vocab {cfg.vocab_size}): {json.dumps(rep)}")
        print(f"[5] {arch} kernel launches {json.dumps(launches)} over {rep['batches']} "
              f"prefill calls; peak memory {peak / 2**30:.2f} GiB")
        if rep["completed"] != n_req or rep["unserved"]:
            raise AssertionError(f"{arch}: serve incomplete: {rep}")
        expect = {"flash_attention": cfg.family in ("dense", "hybrid"),
                  "ssd_scan": cfg.family in ("hybrid", "ssm"),
                  "absmax": False, "quantize_int8": False}
        for name, used in expect.items():
            want = cfg.n_layers * rep["batches"] if used else 0
            if launches[name] != want or (used and want == 0):
                raise AssertionError(f"{arch}: expected {want} {name} launches "
                                     f"({cfg.n_layers} per prefill), got {launches[name]}")
        for rid, row in server.completed.items():
            if row.shape != (n_dec,) or not ((0 <= row) & (row < cfg.vocab_size)).all():
                raise AssertionError(f"{arch} request {rid}: bad tokens {row}")

        # steady-state phase times at the serve shape (after the counted run)
        ptoks = server.prompts(list(range(per_node)))
        with torch.no_grad():
            prefill_ms = time_ms(torch, lambda: api.prefill(server.cfg, server.params, ptoks,
                                                            prompt_len + n_dec),
                                 runs=5, warmup=1)
            _, cache = api.prefill(server.cfg, server.params, ptoks, prompt_len + n_dec)
            tok = ptoks[:, :1]
            decode_ms = time_ms(torch, lambda: api.decode_step(server.cfg, server.params,
                                                               dict(cache), tok),
                                runs=10, warmup=2)
        print(f"[5] {arch} prefill_ms_per_batch {prefill_ms:.3f} (B={per_node}, "
              f"S={prompt_len}) decode_ms_per_token {decode_ms:.3f} (B={per_node}) "
              f"generated_tokens_per_s {rep['tokens_per_second']:.2f} "
              f"wall_seconds {rep['wall_seconds']:.3f} peak_mem_bytes {peak}")
        launches_by_path[arch] = launches

        # ---- 6. where the time goes (this model) ---------------------------
        steps = (("prefill", lambda: api.prefill(server.cfg, server.params, ptoks,
                                                 prompt_len + n_dec)),
                 ("decode", lambda: api.decode_step(server.cfg, server.params,
                                                    dict(cache), tok)))
        for label, step in steps if profile else ():
            busy_ms, wall_ms, top = profile_step(torch, step)
            print(f"[6] {arch} {label} (B={per_node}) under the profiler: wall {wall_ms:.3f} "
                  f"ms, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of wall); "
                  f"top: {top}")

    serve("llama3.2-3b", 1024, profile=True)
    torch.cuda.empty_cache()
    serve("hymba-1.5b", 2048, profile=True)
    torch.cuda.empty_cache()
    serve("mamba2-130m", 2048, profile=False)
    torch.cuda.empty_cache()

    # ---- 7. the Legio runtime at full size: the slice's main path --------
    rt_launches = runtime_phase(torch, rt_core, rt_mpi, ops, quantize, dev, counters)

    def entry(name, replaces, shapes):
        """One kernel's record at the slice's main path (hymba-1.5b): its shape,
        its launches; every measured shape under ``shapes`` and every serve
        run's launches under ``launches_by_path``."""
        by_path = {arch: launches[name] for arch, launches in launches_by_path.items()}
        main = shapes[-1] if name == "flash_attention" else shapes[0]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": replaces,
                "launches": by_path["hymba-1.5b"], "launches_by_path": by_path,
                **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                "shape": main["shape"], "shapes": shapes}

    def quant_entry(name, replaces):
        """One compression-hop kernel's record: the runtime phase's launches,
        the path shape's numbers."""
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/quantize.cu", "replaces": replaces,
                "launches": rt_launches[name], **quant_records[name],
                "shape": f"f32 ({GRAD_ELEMS},)"}

    record = {"kernels": [
        entry("flash_attention", "src/repro/kernels/flash_attention.py:113", flash_shapes),
        entry("ssd_scan", "src/repro/kernels/ssd_scan.py:100", ssd_shapes),
        quant_entry("absmax", "src/repro/kernels/quantize.py:72"),
        quant_entry("quantize_int8", "src/repro/kernels/quantize.py:88"),
    ]}
    print(card_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
