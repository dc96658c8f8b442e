#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3 for flash and SSD, then stop
    python3 chip_smoke.py --train-only     # phases 1 and 8, then stop
    python3 chip_smoke.py --serve-only     # phases 1-2, 5-6 and 9, then stop

From the root of a checkout. It imports only the port (``src/repro_torch``),
never JAX or the JAX package, and runs, in order:

  1. card identity: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: the three CUDA sources (flash attention, SSD scan, the int8
     absmax/quantize pair) from ``src/repro_torch/kernels/csrc`` with one
     nvcc each, in parallel, timed, with each kernel's ptxas registers and
     spills;
  3. kernels vs plain, on the card:
     - first one tile of the wgmma flash kernel (Sq = Sk = 128, hd 64 and
       128, causal and not): a swizzle or descriptor fault shows here, and
       a launch that has not finished within a minute exits with code 3;
     - flash attention over the JAX package's kernel-test cases in f32 (tol
       2e-5) and bf16 (tol 2e-2), ragged cases and cases at the wgmma
       kernel's tiles (a window that starts inside a tile with q_offset,
       softcap, ragged cross attention), each naming the kernel the
       head-dim rule picks; at llama3.2-3b's serving shape (B=4, S=1024,
       H=24, K=8, hd=128, causal) and at hymba-1.5b's (B=4, S=2048, H=25,
       K=5, hd=64, causal, window 1024), both bf16, where it also times the
       kernel, the plain version and one ``scaled_dot_product_attention``
       call;
     - the SSD scan over the JAX package's kernel-test sweep and a case with
       P and N off the 16-byte grid in f32 (tol 2e-4) and bf16 (tol 3e-2)
       with h0, S = 40 at chunk 16 against the
       token-by-token ``ssd_decode_step`` loop, the two-call state handoff,
       and hymba-1.5b's (H=50, P=64, N=16) and mamba2-130m's (H=24, P=64,
       N=128) path shapes (B=4, S=2048, Q=256, bf16; mamba2's also in f32),
       also with x, B and C as strided views into one projection as the
       model passes them, timed with the plain version beside it and one
       call under the profiler (the time of each of its launches);
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
  5. serve at full width through the engine, through a fault:
     ``ResilientServer`` over ``ServeEngine`` and ``Session(4)`` in legions
     of 2 with the shrink preset and fault (0, 1), 4 requests a node, 16
     requests and 16 generated tokens, on llama3.2-3b (28 layers, prompts
     of 1024), hymba-1.5b (32 layers, d=1600, prompts of 2048, past its
     1024 window) and mamba2-130m (24 layers, prompts of 2048), each run
     continuous and then lock-step. Every request must complete exactly
     once with 16 in-vocab tokens, 3 nodes must survive one repair, and
     the rounds, requeues, ``p99_latency_sim`` and the request ids of every
     work_fn call must equal SERVE_PINNED (pinned from the JAX package's
     engine by tests/test_torch_serve_engine.py); the two modes must serve
     the same tokens; each kernel must have launched once per layer per
     work_fn call on the paths that run it and never elsewhere (counts
     zeroed just before each run and read just after). Each run prints its
     report, its RoundReports, wall seconds, tokens/s and peak memory;
     each model's servers are freed (``gc.collect``) before the next
     model's are built, and the memory still held is checked, so each
     peak is that model's own;
  6. where the time goes: after each model's continuous run, the
     steady-state prefill and decode times at B=4 and one prefill and one
     decode step under ``torch.profiler``: the device's busy share and the
     kernels that take most of it;
  7. the Legio runtime, the runtime's main path: ``Session(16)`` with legions
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
     ``sim_seconds``), and with 1-element payloads (the host's share);
  8. the resilient trainer, the trainer's main path (the earlier phases'
     tensors freed first):
     - llama3.2-3b cut to 2 layers at full width, weights drawn on the CPU:
       ``train_loss`` and its gradients on the card against the CPU in
       fp32 with TF32 off (loss within 1e-4, each gradient leaf within
       1e-3 in norm), then bf16 against fp32 on the card (loss within 2e-2
       relative, global gradient norm within 5%);
     - ``make_batch(0, 0, 0, 1 x 1024, vocab 128256)``'s tokens against
       the SHA-256 that tests/test_torch_data.py pins from jax;
     - full-width llama3.2-3b through ``ResilientTrainer`` on 8 nodes in
       legions of 4, one 1024-token sequence a shard, 6 steps with faults
       (2, 1) and (4, 5): every step runs once, repairs at steps 2 and 4,
       8 -> 7 -> 6 shards, finite losses, and no kernel launched (the
       kernels are forward-only; training runs the plain paths, as the JAX
       package's does); per-step loss, wall ms and tokens/s, the peak
       memory, and one fault-free step under the profiler;
     - full-width mamba2-130m for 3 fault-free steps the same way;
  9. the fault zoo: ``ChaosHarness(seed=0).run_matrix(64)`` with every
     cluster's torch data plane on the card; all 50 (scenario x recovery
     x workload) reports must pass their invariants.

Any failed phase exits non-zero. Without a CUDA device it exits 1 and prints
no result. The last three lines are the card's ``nvidia-smi`` line, the
kernels' JSON record (each kernel's time, bound and share of the bound,
its launches on every path: each model's continuous serve run under its
name, the lock-step run under "<name>/lockstep", the train runs' too) and
``{"ok": true, "device": {...}}``; ``--kernels-only``, ``--train-only``
and ``--serve-only`` print neither of the last two.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense tf32 tensor-core peak
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
FIRST_LAUNCH_TIMEOUT_S = 60   # a new kernel's first launch: longer means a hang
# SHA-256 of make_batch(0, 0, 0, batch=1, seq_len=1024, vocab_size=128256)'s
# int32 tokens as jax produces them; tests/test_torch_data.py pins it from jax
MAKE_BATCH_SHA256 = "8351c80a8896cea2b658f5e7faa50a757eec07c935177296238d9a3a05277bea"
# phase 5's serve runs (4 nodes in legions of 2, shrink, fault (0, 1), 4
# requests a node, 16 requests), continuous and lock-step alike: what the
# reference engine decides, and the requests of each work_fn call in order;
# tests/test_torch_serve_engine.py pins these from the reference
SERVE_NODES, SERVE_LEGION, SERVE_PER_NODE, SERVE_REQUESTS, SERVE_FAULT = 4, 2, 4, 16, (0, 1)
SERVE_PINNED = {"rounds": 2, "requeues": 4, "p99_latency_sim": 2.13,
                "work_fn_calls": [[0, 1, 2, 3], [8, 9, 10, 11], [12, 13, 14, 15], [7, 6, 5, 4]]}


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


def wait_or_exit(torch, what: str, timeout_s: float = FIRST_LAUNCH_TIMEOUT_S) -> None:
    """Wait for the card's queue without blocking on it; if the work has not
    finished within ``timeout_s`` (a kernel that hangs), exit with code 3."""
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > timeout_s:
            print(f"chip_smoke: {what} did not finish within {timeout_s} s", file=sys.stderr,
                  flush=True)
            os._exit(3)
        time.sleep(0.01)
    torch.cuda.synchronize()


def ptxas_summary(log: str) -> list[str]:
    """'kernel: registers, spills' for each kernel ptxas reports in ``log``."""
    lines, name, prev = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            spills = re.findall(r"(\d+) bytes spill (stores|loads)", prev)
            spill = ", ".join(f"{n} B {kind}" for n, kind in spills) or "none"
            lines.append(f"{demangle(name)}: {m.group(1)} registers, spills {spill}")
            name = None
        elif "warning" in line or "Performance Loss" in line:
            lines.append(line.strip())
        prev = line
    return lines


def demangle(name: str) -> str:
    """``c++filt``'s reading of a symbol where the tool is there, else the symbol."""
    if shutil.which("c++filt") is None:
        return name
    out = subprocess.run(["c++filt", name], capture_output=True, text=True, timeout=10)
    return out.stdout.strip() or name


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
    """Multiply-adds (x2) of the SSD scan, as (C.B^T counted per head, the rest): per chunk
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
    """The runtime's main path: Session(16) with int8 compression and the
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
                                   bound_by=bound_by, bound_share=bound_ms / kernel_ms,
                                   library_ms=library_ms)
    print("[3] quantize_int8 library_ms none: no one PyTorch call computes it "
          "(torch.quantize_per_tensor clamps to -128 and multiplies by 1/scale)")
    del xg, x, shifted
    torch.cuda.empty_cache()
    return quant_records


def runtime_phase(torch, P, PM, ops, Q, dev, counters) -> dict:
    """Phase 7, the runtime's main path: the Legio runtime at full size with
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


# ---- serving through the engine (phases 5-6) and the fault zoo (phase 9) ---
SERVE_MODELS = (("llama3.2-3b", 1024), ("hymba-1.5b", 2048), ("mamba2-130m", 2048))
SERVE_DECODE = 16
SERVE_HELD_SLACK = 2 ** 29     # bytes a freed model may leave allocated (caches, workspaces)
CHAOS_NODES, CHAOS_REPORTS = 64, 50


def serve_run(torch, P, PM, serve_mod, cfg, prompt_len, dev, counters, *, continuous):
    """One model through the engine: ``Session(SERVE_NODES)`` in legions of
    SERVE_LEGION, shrink, fault SERVE_FAULT, SERVE_PER_NODE requests a node,
    SERVE_REQUESTS requests. Every kernel's count is zeroed just before
    ``run`` and read just after; the work_fn calls (their request ids) and the
    engine's RoundReports are recorded by wrapping the server's methods.
    Returns (server, report, launches, calls, round reports, peak bytes)."""
    session = PM.Session(SERVE_NODES, policy=P.LegioPolicy(
        legion_size=SERVE_LEGION, **serve_mod.recovery_preset("shrink")),
        injector=P.FaultInjector.at([SERVE_FAULT]), device=dev)
    server = serve_mod.ResilientServer(
        cfg, session, prompt_len=prompt_len, decode_tokens=SERVE_DECODE,
        batch_per_node=SERVE_PER_NODE, continuous=continuous, device=dev)
    calls, reports = [], []
    work_batch, run_round = server._work_batch, server.engine.run_round

    def counted_work_batch(request_ids):
        calls.append(list(request_ids))
        return work_batch(request_ids)

    def recorded_round(step=None):
        reports.append(run_round(step))
        return reports[-1]

    server._work_batch = counted_work_batch
    server.engine.run_round = recorded_round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    rep = server.run(SERVE_REQUESTS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    return server, rep, launches, calls, reports, torch.cuda.max_memory_allocated()


def check_serve_run(cfg, mode, rep, launches, calls, completed):
    """Phase 5's checks of one run: every request completed once, the
    reference's recovery and dispatch (SERVE_PINNED), in-vocab rows of
    SERVE_DECODE tokens, and each kernel launched once per layer per work_fn
    call on the families that run it and nowhere else."""
    label = f"{cfg.name}/{mode}"
    if (rep["completed"], rep["abandoned"], rep["shed"], rep["unserved"]) != \
            (SERVE_REQUESTS, 0, 0, 0) or sorted(completed) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"{label}: not every request completed exactly once: {rep}")
    if (rep["survivors"], rep["repairs"]) != (SERVE_NODES - 1, 1):
        raise AssertionError(f"{label}: expected {SERVE_NODES - 1} survivors and 1 repair: {rep}")
    got = {"rounds": rep["rounds"], "requeues": rep["requeues"],
           "p99_latency_sim": rep["p99_latency_sim"], "work_fn_calls": calls}
    if got != SERVE_PINNED:
        raise AssertionError(f"{label}: {got} differs from the reference's {SERVE_PINNED}")
    for rid, row in completed.items():
        if row.shape != (SERVE_DECODE,) or not ((0 <= row) & (row < cfg.vocab_size)).all():
            raise AssertionError(f"{label} request {rid}: bad tokens {row}")
    expect = {"flash_attention": cfg.family in ("dense", "hybrid"),
              "ssd_scan": cfg.family in ("hybrid", "ssm"),
              "absmax": False, "quantize_int8": False}
    for name, used in expect.items():
        want = cfg.n_layers * len(calls) if used else 0
        if launches[name] != want or (used and want == 0):
            raise AssertionError(f"{label}: expected {want} {name} launches ({cfg.n_layers} "
                                 f"per work_fn call), got {launches[name]}")


def round_lines(reports) -> list[str]:
    return [f"round {r.step}: dispatched {r.dispatched} completed_now {r.completed_now} "
            f"requeued_now {r.requeued_now} verdicts "
            f"{[sorted(a.verdict) for a in r.actions]} sim_seconds {r.sim_seconds!r} "
            f"wall_seconds {r.wall_seconds:.3f}" for r in reports]


def serve_phase(torch, P, PM, api, serve_mod, models, dev, counters) -> dict:
    """Phases 5-6: each (config, prompt length) of ``models`` served through
    the engine at full width, continuous and then lock-step, each run held
    to check_serve_run and the two runs' tokens to each other (their
    dispatch is the same, so their batches are). After the continuous run,
    the steady-state prefill and decode times and one profiled prefill and
    decode step (phase 6). Each model's servers are freed (``gc.collect``:
    the engine's pipeline listener closes a cycle that holds the weights)
    before the next one is built. Returns the launches by path."""
    launches_by_path = {}
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    for cfg, prompt_len in models:
        arch = cfg.name
        held = torch.cuda.memory_allocated()
        print(f"[5] {arch}: {held} B allocated before its servers are built "
              f"(phase 5 began with {base} B)")
        if held > base + SERVE_HELD_SLACK:
            raise AssertionError(f"{arch}: an earlier model's memory is still held")
        tokens_by_mode = {}
        for mode in ("continuous", "lockstep"):
            server, rep, launches, calls, reports, peak = serve_run(
                torch, P, PM, serve_mod, cfg, prompt_len, dev, counters,
                continuous=mode == "continuous")
            tok_s = rep["completed"] * SERVE_DECODE / rep["wall_seconds"]
            n_params = api.count_params(server.params)
            print(f"[5] serve {arch}/{mode} full width ({n_params / 1e9:.3f} B params, "
                  f"{cfg.n_layers} layers, d={cfg.d_model}, vocab {cfg.vocab_size}), "
                  f"{SERVE_NODES} nodes, fault {SERVE_FAULT}: {json.dumps(rep)}")
            for line in round_lines(reports):
                print(f"[5] {arch}/{mode} {line}")
            print(f"[5] {arch}/{mode} kernel launches {json.dumps(launches)} over "
                  f"{len(calls)} work_fn calls {calls}; wall_seconds {rep['wall_seconds']:.3f} "
                  f"generated_tokens_per_s {tok_s:.2f} peak_mem_bytes {peak} "
                  f"({peak / 2**30:.2f} GiB)")
            check_serve_run(cfg, mode, rep, launches, calls, server.completed)
            tokens_by_mode[mode] = dict(server.completed)
            launches_by_path[arch if mode == "continuous" else f"{arch}/{mode}"] = launches
            if mode == "continuous":
                serve_timings(torch, api, server, arch, prompt_len)
            del server
            gc.collect()
            torch.cuda.empty_cache()
        same = all((tokens_by_mode["continuous"][r] == tokens_by_mode["lockstep"][r]).all()
                   for r in range(SERVE_REQUESTS))
        print(f"[5] {arch} tokens, continuous vs lock-step (same dispatch): "
              f"{'identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{arch}: the two modes served different tokens")
    return launches_by_path


def serve_timings(torch, api, server, arch, prompt_len):
    """Steady-state prefill and decode times at the serve shape (after the
    counted run), then one step of each under the profiler (phase 6)."""
    ptoks = server.prompts(list(range(SERVE_PER_NODE)))
    total = prompt_len + SERVE_DECODE
    with torch.no_grad():
        prefill_ms = time_ms(torch, lambda: api.prefill(server.cfg, server.params, ptoks, total),
                             runs=5, warmup=1)
        _, cache = api.prefill(server.cfg, server.params, ptoks, total)
        tok = ptoks[:, :1]
        decode_ms = time_ms(torch, lambda: api.decode_step(server.cfg, server.params,
                                                           dict(cache), tok),
                            runs=10, warmup=2)
    print(f"[5] {arch} prefill_ms_per_batch {prefill_ms:.3f} (B={SERVE_PER_NODE}, "
          f"S={prompt_len}) decode_ms_per_token {decode_ms:.3f} (B={SERVE_PER_NODE})")
    steps = (("prefill", lambda: api.prefill(server.cfg, server.params, ptoks, total)),
             ("decode", lambda: api.decode_step(server.cfg, server.params, dict(cache), tok)))
    for label, step in steps:
        busy_ms, wall_ms, top = profile_step(torch, step)
        print(f"[6] {arch} {label} (B={SERVE_PER_NODE}) under the profiler: wall "
              f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of "
              f"wall); top: {top}")


def chaos_phase(P, dev) -> dict:
    """Phase 9: ``ChaosHarness(seed=0).run_matrix(CHAOS_NODES)`` with every
    cluster's torch data plane on the card: each (scenario x recovery x
    workload) report must pass its invariants."""
    t0 = time.perf_counter()
    reports = P.ChaosHarness(seed=0, device=dev).run_matrix(CHAOS_NODES)
    seconds = time.perf_counter() - t0
    passed = sum(r.passed for r in reports)
    print(f"[9] chaos matrix, {CHAOS_NODES} nodes on {dev}: {passed} of {len(reports)} "
          f"reports passed in {seconds:.3f} s")
    for r in reports:
        if not r.passed:
            print(f"[9] {r.summary()}: {r.failures}")
    if len(reports) != CHAOS_REPORTS or passed != len(reports):
        raise AssertionError(f"chaos matrix: {passed} of {len(reports)} reports passed")
    return {"reports": len(reports), "passed": passed, "seconds": seconds}


# ---- training (phase 8) --------------------------------------------------
TRAIN_NODES, TRAIN_LEGION, TRAIN_STEPS, TRAIN_SEQ = 8, 4, 6, 1024
TRAIN_FAULTS = [(2, 1), (4, 5)]            # (step, node): 8 -> 7 -> 6 shards
TRAIN_REPAIR_STEPS = [2, 4]
TRAIN_SHARDS = [8, 8, 7, 7, 6, 6]
MAMBA_TRAIN_STEPS = 3
CHECK_B, CHECK_S = 2, 128                  # phases 8.1-8.2: the 2-layer cut's batch
CARD_CPU_LOSS_RTOL, CARD_CPU_GRAD_RTOL = 1e-4, 1e-3
BF16_LOSS_RTOL, BF16_GNORM_RTOL = 2e-2, 5e-2
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def loss_and_grads(torch, api, cfg, params, batch):
    """(loss, gradient leaves in sorted-key order) of ``api.train_loss``."""
    from repro_torch.optim.adamw import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = api.train_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


def global_norm_of(torch, grads):
    return torch.sqrt(sum(g.float().square().sum() for g in grads)).item()


def train_checks(torch, api, cfg, dev) -> dict:
    """Phases 8.1-8.2 on ``cfg`` cut to 2 layers at full width: train_loss and
    its gradients on the card against the CPU in fp32 (TF32 off), then bf16
    against fp32 on the card, all from one set of weights drawn on the CPU."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim.adamw import tree_map

    cut = cfg.replace(n_layers=2, dtype="float32", param_dtype="float32")
    params = api.init_params(cut, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(0, 0, 0, batch=CHECK_B, seq_len=CHECK_S, vocab_size=cut.vocab_size,
                       device="cpu")
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads(torch, api, cut, params, batch)
    cpu_s = time.perf_counter() - t0
    on_card = tree_map(lambda t: t.to(dev), params)
    del params
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    loss32, grads32 = loss_and_grads(torch, api, cut, on_card, card_batch)
    loss_rel = abs(loss32.item() - cpu_loss.item()) / abs(cpu_loss.item())
    grad_rel = max((g.cpu() - c).norm().item() / c.norm().item()
                   for g, c in zip(grads32, cpu_grads))
    ok = loss_rel <= CARD_CPU_LOSS_RTOL and grad_rel <= CARD_CPU_GRAD_RTOL
    print(f"[8] {cut.name} 2 layers d={cut.d_model} vocab {cut.vocab_size} fp32, B={CHECK_B} "
          f"S={CHECK_S}: loss card {loss32.item():.6f} cpu {cpu_loss.item():.6f} (rel "
          f"{loss_rel:.3e}, limit {CARD_CPU_LOSS_RTOL:g}); worst gradient leaf rel norm err "
          f"{grad_rel:.3e} (limit {CARD_CPU_GRAD_RTOL:g}); the CPU pass took {cpu_s:.1f} s "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train_loss or its gradients differ between the card and the CPU")
    del cpu_grads

    bf = cut.replace(dtype="bfloat16", param_dtype="bfloat16")
    loss16, grads16 = loss_and_grads(torch, api, bf, tree_map(lambda t: t.bfloat16(), on_card),
                                     card_batch)
    gn32, gn16 = global_norm_of(torch, grads32), global_norm_of(torch, grads16)
    dloss = abs(loss16.item() - loss32.item())
    ok = dloss <= BF16_LOSS_RTOL * abs(loss32.item()) and abs(gn16 - gn32) <= BF16_GNORM_RTOL * gn32
    print(f"[8] bf16 vs fp32 on the card: loss {loss16.item():.6f} vs {loss32.item():.6f} "
          f"(|d| {dloss:.3e}, limit {BF16_LOSS_RTOL:g} x |loss|); global grad norm "
          f"{gn16:.6f} vs {gn32:.6f} (rel {abs(gn16 - gn32) / gn32:.3e}, limit "
          f"{BF16_GNORM_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 training loss or gradient norm is off the fp32 one")
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, bf16_dloss=dloss,
                bf16_gnorm_rel=abs(gn16 - gn32) / gn32)


def train_profile(torch, trainer, vocab: int) -> dict:
    """One fault-free step of ``trainer`` under torch.profiler: wall and busy
    ms (device kernels only); the operators that launched the most kernel
    time; GEMM kernel time split by the op's shapes (the cross-entropy's
    fp32 logit GEMMs have the vocabulary as a dimension; attention's
    einsums are the only batched ones in the dense model; the rest are the
    model's bf16 GEMMs); and the device span of attention's forward and
    recompute and of the optimizer (clip and AdamW), from ranges put around
    them for this step only."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch.core.trainer as trainer_mod
    import repro_torch.models.transformer as transformer_mod

    saved = {}

    def label(mod, name, tag):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            with record_function(tag):
                return fn(*args, **kwargs)

        saved[(mod, name)] = fn
        setattr(mod, name, wrapper)

    label(trainer_mod, "clip_by_global_norm_", "train.optimizer")
    label(trainer_mod, "adamw_update_", "train.optimizer")
    label(transformer_mod, "attention", "train.attention")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            report = trainer.run_step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    averages = prof.key_averages()
    spans = {e.key: e.self_device_time_total / 1e3 for e in averages
             if e.key.startswith("train.")}
    kernels = [e for e in averages if e.self_device_time_total > 0 and e.cpu_time_total == 0
               and not e.key.startswith("train.")]
    ops = sorted((e for e in averages if e.self_device_time_total > 0 and e.cpu_time_total > 0
                  and not e.key.startswith("train.")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = dict(step=report.step, wall_ms=wall_ms, busy_ms=busy_ms, xent_gemm_ms=0.0,
               xent_gemms=0, attn_gemm_ms=0.0, model_gemm_ms=0.0,
               attention_span_ms=spans.get("train.attention", 0.0),
               optimizer_span_ms=spans.get("train.optimizer", 0.0),
               top_ops="; ".join(f"{e.key} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                                 for e in ops[:10]))
    for e in prof.events():
        if e.name in GEMM_OPS:
            ms = e.self_device_time_total / 1e3
            shapes = [s for s in (e.input_shapes or []) if isinstance(s, (list, tuple))]
            if any(vocab in s for s in shapes):
                out["xent_gemm_ms"] += ms
                out["xent_gemms"] += 1
            elif e.name in ("aten::bmm", "aten::baddbmm"):
                out["attn_gemm_ms"] += ms
            else:
                out["model_gemm_ms"] += ms
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    out["top"] = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                           for e in kernels[:6])
    return out


def train_run(torch, P, cfg, dev, *, steps, faults, counters, label):
    """``ResilientTrainer`` on ``VirtualCluster(TRAIN_NODES)`` (legions of
    TRAIN_LEGION, per-shard batch 1, sequence TRAIN_SEQ) for ``steps`` steps
    with every kernel's count zeroed just before and read just after. Returns
    (trainer, per-step records, launches, peak bytes)."""
    from repro_torch.configs.base import TrainConfig

    tc = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1))
    cluster = P.VirtualCluster(TRAIN_NODES, policy=P.LegioPolicy(legion_size=TRAIN_LEGION),
                               injector=P.FaultInjector.at(faults), device=dev)
    trainer = P.ResilientTrainer(cfg, tc, cluster, per_shard_batch=1, seq_len=TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    records = []
    for _ in range(steps):
        t0 = time.perf_counter()
        r = trainer.run_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = r.active_shards * TRAIN_SEQ
        records.append(dict(step=r.step, loss=r.loss, grad_norm=r.grad_norm,
                            shards=r.active_shards, wall_ms=wall * 1e3,
                            tokens_per_s=tokens / wall, repair=r.repair))
        print(f"[8] {label} step {r.step}: loss {r.loss:.6f} grad_norm {r.grad_norm:.4f} "
              f"shards {r.active_shards} wall_ms {wall * 1e3:.3f} (card synchronised) "
              f"tokens_per_s {tokens / wall:.1f}"
              f"{' REPAIR ' + r.repair.summary() if r.repair else ''}")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    return trainer, records, launches, torch.cuda.max_memory_allocated()


def train_phase(torch, P, api, cfgs, dev, counters) -> dict:
    """Phase 8: the resilient trainer. Card vs CPU and bf16 vs fp32 checks on
    the 2-layer cut, the data digest, then full-width llama3.2-3b through
    TRAIN_FAULTS (the main path: every step once, repairs at 2 and 4, 8 -> 7
    -> 6 shards, finite losses, no kernel launched) with a profiled
    fault-free step, then full-width mamba2-130m for MAMBA_TRAIN_STEPS."""
    import hashlib

    from repro_torch.data.pipeline import make_batch

    llama, mamba = cfgs
    checks = train_checks(torch, api, llama, dev)
    torch.cuda.empty_cache()

    tokens = make_batch(0, 0, 0, batch=1, seq_len=1024, vocab_size=128256)["tokens"]
    digest = hashlib.sha256(tokens.cpu().numpy().tobytes()).hexdigest()
    verdict = "ok" if digest == MAKE_BATCH_SHA256 else f"FAIL (jax: {MAKE_BATCH_SHA256})"
    print(f"[8] make_batch(0, 0, 0, 1 x 1024, vocab 128256) on {tokens.device}: sha256 "
          f"{digest} {verdict}")
    if digest != MAKE_BATCH_SHA256 or tokens.dtype != torch.int32:
        raise AssertionError("make_batch's tokens differ from the JAX package's")

    trainer, records, launches, peak = train_run(
        torch, P, llama, dev, steps=TRAIN_STEPS, faults=TRAIN_FAULTS, counters=counters,
        label=llama.name)
    n_params = api.count_params(trainer.params)
    repairs = [r["step"] for r in records if r["repair"] is not None]
    print(f"[8] {llama.name} full width ({n_params} params, {llama.n_layers} layers, "
          f"d={llama.d_model}, remat={llama.remat}): steps {[r['step'] for r in records]}, "
          f"repairs at {repairs}, shards {[r['shards'] for r in records]}, live nodes "
          f"{trainer.cluster.live_nodes}; kernel launches {json.dumps(launches)}; peak memory "
          f"{peak / 2**30:.2f} GiB ({peak} B)")
    if [r["step"] for r in records] != list(range(TRAIN_STEPS)) or repairs != TRAIN_REPAIR_STEPS \
            or [r["shards"] for r in records] != TRAIN_SHARDS \
            or len(trainer.cluster.live_nodes) != TRAIN_SHARDS[-1] \
            or not all(math.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"{llama.name}: the run did not go on through its faults")
    if any(launches.values()):
        raise AssertionError(f"training launched a forward-only kernel: {launches}")

    prof = train_profile(torch, trainer, llama.vocab_size)
    flops = 8 * n_params * TRAIN_SHARDS[-1] * TRAIN_SEQ
    print(f"[8] {llama.name} step {prof['step']} (6 shards, {TRAIN_SHARDS[-1] * TRAIN_SEQ} tokens) "
          f"under the profiler: wall {prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} "
          f"ms ({prof['busy_ms'] / prof['wall_ms']:.3f} of wall); GEMMs: cross-entropy fp32 "
          f"logits {prof['xent_gemm_ms']:.3f} ms ({prof['xent_gemms']} GEMMs), attention "
          f"einsums (fp32) {prof['attn_gemm_ms']:.3f} ms, model bf16 {prof['model_gemm_ms']:.3f} "
          f"ms; device span of attention's forward + recompute {prof['attention_span_ms']:.3f} "
          f"ms, of the optimizer (clip + AdamW) {prof['optimizer_span_ms']:.3f} ms; "
          f"8 x params x tokens = {flops:.3e} FLOP")
    print(f"[8] {llama.name} profiled step, operators by kernel time: {prof['top_ops']}")
    print(f"[8] {llama.name} profiled step, kernels: {prof['top']}")
    steady = [r["wall_ms"] for r in records if r["repair"] is None and r["step"] > 0]
    summary = dict(step_ms=[r["wall_ms"] for r in records],
                   tokens_per_s=[r["tokens_per_s"] for r in records],
                   loss=[r["loss"] for r in records], peak_bytes=peak,
                   median_fault_free_ms=statistics.median(steady), profile=prof,
                   launches=launches, **checks)
    del trainer
    gc.collect()            # the trainer's state getters close a reference cycle
    torch.cuda.empty_cache()

    m_trainer, m_records, m_launches, m_peak = train_run(
        torch, P, mamba, dev, steps=MAMBA_TRAIN_STEPS, faults=[], counters=counters,
        label=mamba.name)
    print(f"[8] {mamba.name} full width ({api.count_params(m_trainer.params)} params, "
          f"{mamba.n_layers} layers, d={mamba.d_model}): shards "
          f"{[r['shards'] for r in m_records]}, kernel launches {json.dumps(m_launches)}, "
          f"peak memory {m_peak / 2**30:.2f} GiB ({m_peak} B)")
    if [r["step"] for r in m_records] != list(range(MAMBA_TRAIN_STEPS)) \
            or any(r["repair"] is not None or r["shards"] != TRAIN_NODES for r in m_records) \
            or not all(math.isfinite(r["loss"]) for r in m_records):
        raise AssertionError(f"{mamba.name}: the fault-free run went wrong")
    if any(m_launches.values()):
        raise AssertionError(f"training launched a forward-only kernel: {m_launches}")
    summary["mamba"] = dict(step_ms=[r["wall_ms"] for r in m_records],
                            tokens_per_s=[r["tokens_per_s"] for r in m_records],
                            loss=[r["loss"] for r in m_records], peak_bytes=m_peak,
                            launches=m_launches)
    del m_trainer
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def main(argv: list[str]) -> int:
    import torch

    kernels_only = "--kernels-only" in argv  # phases 1-3 for flash and SSD, then stop
    train_only = "--train-only" in argv      # phases 1 and 8, then stop
    serve_only = "--serve-only" in argv      # phases 1-2, 5-6 and 9, then stop

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
        kernel_for,
    )
    from repro_torch.kernels.ssd_scan import CB_MIN_STATE, ssd_scan_cuda, ssd_scan_plain
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import greedy_generate
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
    counters = {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda,
                "absmax": quantize.absmax_cuda, "quantize_int8": quantize.quantize_int8_cuda}
    train_cfgs = (get_config("llama3.2-3b"), get_config("mamba2-130m"))
    if train_only:
        train = train_phase(torch, rt_core, api, train_cfgs, dev, counters)
        print(json.dumps({"train_only": train}, default=str))
        return 0

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_paths = _build.build(["flash_attention", "ssd_scan", "quantize"])
    print(f"[2] built {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)} "
          f"in {time.perf_counter() - t0:.2f} s")
    for name, log in sorted(_build.build_logs.items()):
        for line in ptxas_summary(log):
            print(f"[2] ptxas {name}: {line}")
    serve_models = [(get_config(arch), prompt_len) for arch, prompt_len in SERVE_MODELS]
    if serve_only:
        launches_by_path = serve_phase(torch, rt_core, rt_mpi, api, serve_mod, serve_models,
                                       dev, counters)
        chaos = chaos_phase(rt_core, dev)
        print(json.dumps({"serve_only": {"launches_by_path": launches_by_path,
                                         "chaos": chaos}}))
        return 0

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

    # one tile of the wgmma kernel first (Sq = Sk = 128, one block per head):
    # a swizzle or descriptor fault shows here, and a hang exits after a minute
    for hd in (64, 128):
        for kw in (dict(causal=False), dict(causal=True)):
            q, k, v = qkv(1, 128, 128, 2, 1, hd, "bfloat16")
            out = flash_attention_cuda(q, k, v, **kw)
            wait_or_exit(torch, f"the flash kernel's single tile (hd={hd}, {kw})")
            check(f"single_tile_hd{hd}_{'causal' if kw['causal'] else 'full'} "
                  f"({kernel_for(q.dtype, hd)})", "bfloat16", out,
                  flash_attention_plain(q, k, v, **kw))

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
        # the wgmma kernel's tiles (bf16, hd 64 or 128): a window that starts
        # inside a 128-key tile with q_offset > 0 (the first live tile is fully
        # masked for the block's last rows), softcap, ragged cross attention
        ("window_qoffset_hd64", (1, 128, 384, 4, 2, 64),
         dict(causal=True, window=100, q_offset=256)),
        ("softcap_hd128", (2, 256, 256, 4, 2, 128), dict(causal=True, logit_softcap=30.0)),
        ("cross_ragged_hd128", (2, 200, 333, 8, 2, 128), dict(causal=False)),
        ("ragged_window_hd64", (2, 1000, 1000, 5, 1, 64), dict(causal=True, window=300)),
    ]
    for dtype in ("float32", "bfloat16"):
        for name, shape, kw in cases:
            q, k, v = qkv(*shape, dtype)
            check(f"{name} ({kernel_for(q.dtype, shape[-1])})", dtype,
                  flash_attention_cuda(q, k, v, **kw), flash_attention_plain(q, k, v, **kw))
        # tiling invariance: two query halves with q_offset == the whole
        for hd in (32, 128):
            q, k, v = qkv(1, 256, 256, 4, 2, hd, dtype)
            whole = flash_attention_cuda(q, k, v, causal=True)
            halves = torch.cat([flash_attention_cuda(q[:, :128].contiguous(), k, v, causal=True),
                                flash_attention_cuda(q[:, 128:].contiguous(), k, v, causal=True,
                                                     q_offset=128)], dim=1)
            check(f"split_q_invariance_hd{hd} ({kernel_for(q.dtype, hd)})", dtype, halves, whole)

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
        kernel = kernel_for(q.dtype, hd)
        print(f"[3] flash path shape {label} B={B} S={S} H={H} K={K} hd={hd} bf16 causal "
              f"window={window} ({kernel} kernel): kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {library_ms:.4f} (kernel/library "
              f"{kernel_ms / library_ms:.3f}) bound_ms {bound_ms:.4f} ({bound_by}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) share of bound "
              f"{bound_ms / kernel_ms:.3f} kernel TFLOP/s {flops / kernel_ms / 1e9:.1f} "
              f"sdpa_vs_kernel_max_abs {lib_err:.3e}")
        return dict(shape=f"{label}: B={B} S={S} H={H} K={K} hd={hd} bf16 causal window={window}",
                    kernel=kernel, max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / kernel_ms,
                    library_ms=library_ms)

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
             (1, 64, 4, 16, 1, 32, 64), (2, 96, 4, 16, 4, 32, 32),
             # P and N off the 16-byte grid: the kernels' one-element loads
             (1, 96, 4, 10, 2, 18, 32)]
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

    def ssd_path(label, B, S, H, P, G, N, Q, dtype="bfloat16"):
        """Check and time the SSD kernel at a serving path's shape (h0 = 0 as in prefill)."""
        x, dt, A, Bm, Cm, _ = ssd_inputs(B, S, H, P, G, N, dtype, with_h0=False)
        out = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q)
        plain = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=Q)
        err = ssd_check(f"ssd_path_{label}", dtype, out, plain)
        # the model's layout: x, B and C as strided views into one projection
        xbc = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
                         Cm.reshape(B, S, G * N)], dim=-1)
        xv, bv, cv = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
        ssd_check(f"ssd_path_{label}_views", dtype,
                  ssd_scan_cuda(xv.reshape(B, S, H, P), dt, A, bv.reshape(B, S, G, N),
                                cv.reshape(B, S, G, N), chunk=Q), plain)
        del xbc, xv, bv, cv
        kernel_ms = time_ms(torch, lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q),
                            runs=20, reps=20)
        plain_ms = time_ms(torch, lambda: ssd_scan_plain(x, dt, A, Bm, Cm, chunk=Q), runs=10)
        busy_ms, _, top = profile_step(torch, lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=Q))
        print(f"[3] ssd {label} {dtype} one call under the profiler: device {busy_ms:.4f} ms; "
              f"by kernel: {top}")
        cb_flops, rest_flops = ssd_flops(B, S, H, P, N, Q, has_h0=False)
        # the work the function needs forms C.B^T once per group: its heads share it
        cb_needed = cb_flops * G // H
        flops = cb_needed + rest_flops
        nbytes = sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm, *out))
        # each product at the peak of the precision the kernels run it in: for
        # bf16 inputs C.B^T (two bf16 operands) as bf16, the products with an
        # fp32 operand as one tf32 product; for fp32 inputs every product as
        # three tf32 products (3xTF32)
        if dtype == "bfloat16":
            op_s = cb_needed / PEAK_BF16_FLOPS + rest_flops / PEAK_TF32_FLOPS
            priced = "C.B^T once per group at the bf16 peak, the rest at the tf32 peak"
        else:
            op_s = 3 * flops / PEAK_TF32_FLOPS
            priced = "C.B^T once per group; every product as 3 tf32 products"
        bound_ms, bound_by = bound(op_s, nbytes)
        # the first port's pricing (C.B^T per head, fp32-operand products on the CUDA cores)
        fp32_bound_ms, _ = bound(cb_flops / PEAK_BF16_FLOPS + rest_flops / PEAK_FP32_FLOPS,
                                 nbytes)
        device_launches = 4 if N >= CB_MIN_STATE else 3
        print(f"[3] ssd path shape {label} B={B} S={S} H={H} P={P} G={G} N={N} Q={Q} {dtype}: "
              f"kernel_ms {kernel_ms:.4f} ({device_launches} device launches) plain_ms "
              f"{plain_ms:.4f} "
              f"library_ms none bound_ms {bound_ms:.4f} ({bound_by}; {priced}; C.B^T "
              f"{cb_needed / 1e9:.3f} GFLOP, the rest {rest_flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB) share of bound {bound_ms / kernel_ms:.3f}; bound with "
              f"the rest at the fp32 CUDA-core peak {fp32_bound_ms:.4f}; kernel TFLOP/s "
              f"{flops / kernel_ms / 1e9:.2f}")
        return dict(shape=f"{label}: B={B} S={S} H={H} P={P} G={G} N={N} Q={Q} {dtype}",
                    max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bound_share=bound_ms / kernel_ms,
                    bound_ms_fp32_priced=fp32_bound_ms, device_launches_per_call=device_launches,
                    library_ms=None)

    ssd_shapes = [ssd_path("hymba-1.5b", 4, 2048, 50, 64, 1, 16, 256),
                  ssd_path("mamba2-130m", 4, 2048, 24, 64, 1, 128, 256),
                  ssd_path("mamba2-130m", 4, 2048, 24, 64, 1, 128, 256, dtype="float32")]
    torch.cuda.empty_cache()
    if kernels_only:
        print(json.dumps({"kernels_only": {"flash_attention": flash_shapes,
                                           "ssd_scan": ssd_shapes}}))
        return 0

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

    # ---- 5-6. serve at full width through the engine, through a fault ------
    launches_by_path = serve_phase(torch, rt_core, rt_mpi, api, serve_mod, serve_models, dev,
                                   counters)

    # ---- 7. the Legio runtime at full size: the runtime's main path --------
    rt_launches = runtime_phase(torch, rt_core, rt_mpi, ops, quantize, dev, counters)

    # ---- 8. the resilient trainer: the trainer's main path ------------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = train_phase(torch, rt_core, api, train_cfgs, dev, counters)
    train_launches = {f"train:{train_cfgs[0].name}": train["launches"],
                      f"train:{train_cfgs[1].name}": train["mamba"]["launches"]}
    print(json.dumps({"train": train}, default=str))

    # ---- 9. the fault zoo: the chaos matrix on the card --------------------
    chaos = chaos_phase(rt_core, dev)
    print(json.dumps({"chaos": chaos}))

    def entry(name, replaces, shapes):
        """One kernel's record at the serve path (hymba-1.5b, continuous): its
        shape, its launches; every measured shape under ``shapes`` and every
        serve run's launches under ``launches_by_path``, the train runs' (0)
        too."""
        by_path = {arch: launches[name] for arch, launches in launches_by_path.items()}
        by_path.update({path: launches[name] for path, launches in train_launches.items()})
        main = shapes[-1] if name == "flash_attention" else shapes[0]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": replaces,
                "launches": by_path["hymba-1.5b"], "launches_by_path": by_path,
                **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "bound_share")},
                "shape": main["shape"], "shapes": shapes}

    def quant_entry(name, replaces):
        """One compression-hop kernel's record: the runtime phase's launches
        (and the train runs', 0), the path shape's numbers."""
        by_path = {"runtime": rt_launches[name],
                   **{path: launches[name] for path, launches in train_launches.items()}}
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/quantize.cu", "replaces": replaces,
                "launches": rt_launches[name], "launches_by_path": by_path,
                **quant_records[name],
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
    sys.exit(main(sys.argv[1:]))
