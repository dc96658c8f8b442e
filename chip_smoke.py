#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

From the root of a checkout, with no arguments. It imports only the port
(``src/repro_torch``), never JAX or the JAX package, and runs, in order:

  1. card identity: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: both kernels (flash attention, SSD scan) from
     ``src/repro_torch/kernels/csrc`` with one nvcc each, in parallel, timed;
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
     most of it.

Any failed phase exits non-zero. Without a CUDA device it exits 1 and prints
no result. The last three lines are the card's ``nvidia-smi`` line, the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
    from repro_torch.launch.serve import ResilientServer, greedy_generate
    from repro_torch.models import api
    from repro_torch.models.ssd import ssd_decode_step

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
    lib_paths = _build.build(["flash_attention", "ssd_scan"])
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
    counters = {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda}
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
                  "ssd_scan": cfg.family in ("hybrid", "ssm")}
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

    record = {"kernels": [
        entry("flash_attention", "src/repro/kernels/flash_attention.py:113", flash_shapes),
        entry("ssd_scan", "src/repro/kernels/ssd_scan.py:100", ssd_shapes),
    ]}
    print(card_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
