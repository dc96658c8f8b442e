#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

From the root of a checkout, with no arguments. It imports only the port
(``src/repro_torch``), never JAX or the JAX package, and runs, in order:

  1. card identity: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: the flash-attention kernel from ``src/repro_torch/kernels/csrc``
     with nvcc, timed;
  3. kernel vs plain: the CUDA kernel against its plain PyTorch version on
     the card, over the JAX package's kernel-test cases in f32 (tol 2e-5)
     and bf16 (tol 2e-2), a ragged case, and the serving path's shape
     (B=4, S=1024, H=24, K=8, hd=128, bf16, causal), where it also times the
     kernel, the plain version and one ``scaled_dot_product_attention`` call;
  4. model, kernel vs plain: llama3.2-3b at full width cut to 2 layers,
     bf16 prefill logits with ``use_pallas`` on and off, each held against
     the same weights run in fp32; and the smoke config in f32, greedy
     tokens with the kernel against without;
  5. serve at full width: ``ResilientServer`` on llama3.2-3b (28 layers,
     d=3072, vocab 128256), 2 nodes x 4 requests, prompts of 1024, 16
     generated tokens; every request must complete and the kernel must have
     launched 28 times per prefill;
  6. where the time goes: one prefill and one decode step at the serve
     shape under ``torch.profiler``: the device's busy share and the
     kernels that take most of it.

Any failed phase exits non-zero. Without a CUDA device it exits 1 and prints
no result. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
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
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# phase 4: the RMS distance of the bf16 kernel path's logits from the fp32
# model's may be at most this multiple of the bf16 blocked path's. Both paths
# differ from fp32 by bf16 rounding (the kernel also rounds P to bf16 for P.V);
# a fault in the kernel (mask, head mapping, softmax) moves logits by their
# own scale, ~80x the rounding noise. The RMS is used, not the max: the max of
# 256K noisy logits is an extreme value that moves from run to run.
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
    from repro_torch.launch.serve import ResilientServer, greedy_generate
    from repro_torch.models import api

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
    (lib_path,) = _build.build(["flash_attention"])
    print(f"[2] built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernel vs plain on the card ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, Sq, Sk, H, K, hd, dtype):
        return [torch.randn(s, generator=gen, device=dev).to(dtypes[dtype])
                for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]

    def check(name, dtype, out, ref):
        err = (out.float() - ref.float()).abs()
        tol = TOL[dtype]
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

    # the serving path's shape
    B, S, H, K, hd = 4, 1024, 24, 8, 128
    q, k, v = qkv(B, S, S, H, K, hd, "bfloat16")
    out = flash_attention_cuda(q, k, v, causal=True)
    path_err = check("path_shape", "bfloat16", out, flash_attention_plain(q, k, v, causal=True))
    kernel_ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=True),
                        runs=20, reps=20)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, causal=True), runs=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                         runs=20, reps=20)
    lib_err = (sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2).float()
               - out.float()).abs().max().item()
    flops = 4 * hd * live_pairs(S, S, True, 0, 0) * B * H
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[3] path shape B={B} S={S} H={H} K={K} hd={hd} bf16 causal: "
          f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
          f"bound_ms {bound_ms:.4f} ({bound_by}; {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) kernel TFLOP/s {flops / kernel_ms / 1e9:.1f} "
          f"sdpa_vs_kernel_max_abs {lib_err:.3e}")
    del q, k, v, qt, kt, vt, out

    # ---- 4. model: kernel vs plain ---------------------------------------
    cfg2 = get_config("llama3.2-3b").replace(n_layers=2)
    params = api.init_params(cfg2, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg2.vocab_size, (2, 1024),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    cfg32 = cfg2.replace(dtype="float32", param_dtype="float32")
    with torch.no_grad():
        lk, _ = api.prefill(cfg2.replace(use_pallas=True), params, tokens, 1040)
        lp, _ = api.prefill(cfg2.replace(use_pallas=False), params, tokens, 1040)
        lf, _ = api.prefill(cfg32, to_float(params), tokens, 1040)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and lk.shape == (2, 1, cfg2.vocab_size)):
        raise AssertionError("full-width prefill logits are not finite or misshapen")
    rms_kernel = (lk - lf).square().mean().sqrt().item()
    rms_plain = (lp - lf).square().mean().sqrt().item()
    print(f"[4] llama3.2-3b d=3072 2 layers prefill B=2 S=1024: logits std "
          f"{lf.std().item():.3f}; vs the fp32 model: bf16 kernel rms {rms_kernel:.3e} "
          f"max {(lk - lf).abs().max().item():.3e}, bf16 blocked rms {rms_plain:.3e} "
          f"max {(lp - lf).abs().max().item():.3e}; rms ratio "
          f"{rms_kernel / rms_plain:.3f} (limit {MODEL_RMS_RATIO})")
    if rms_kernel > MODEL_RMS_RATIO * rms_plain:
        raise AssertionError("model logits through the kernel are further from fp32 "
                             "than rounding explains")
    del params, lk, lp, lf
    torch.cuda.empty_cache()

    smoke = get_smoke_config("llama3.2-3b").replace(dtype="float32", param_dtype="float32")
    sparams = api.init_params(smoke, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = torch.randint(0, smoke.vocab_size, (3, 96),
                            generator=torch.Generator().manual_seed(2)).to(dev)
    toks_k = greedy_generate(smoke.replace(use_pallas=True), sparams, prompts, 8)
    toks_p = greedy_generate(smoke.replace(use_pallas=False), sparams, prompts, 8)
    same = bool(torch.equal(toks_k, toks_p))
    print(f"[4] smoke config f32 greedy tokens, kernel vs blocked: "
          f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("f32 greedy tokens differ between the kernel and the blocked path")
    del sparams

    # ---- 5. serve at full width ------------------------------------------
    cfg = get_config("llama3.2-3b")
    nodes, per_node, n_req, prompt_len, n_dec = 2, 4, 8, 1024, 16
    server = ResilientServer(cfg, nodes=nodes, prompt_len=prompt_len,
                             decode_tokens=n_dec, batch_per_node=per_node, device=dev)
    n_params = api.count_params(server.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    rep = server.run(n_req)
    torch.cuda.synchronize()
    launches = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"[5] serve llama3.2-3b full width ({n_params / 1e9:.3f} B params): "
          f"{json.dumps(rep)}")
    print(f"[5] flash-kernel launches {launches} over {rep['batches']} prefill calls; "
          f"peak memory {peak / 2**30:.2f} GiB")
    if rep["completed"] != n_req or rep["unserved"]:
        raise AssertionError(f"serve incomplete: {rep}")
    if launches != cfg.n_layers * rep["batches"] or launches == 0:
        raise AssertionError(f"expected {cfg.n_layers} kernel launches per prefill, got "
                             f"{launches} for {rep['batches']} prefills")
    for rid, row in server.completed.items():
        if row.shape != (n_dec,) or not ((0 <= row) & (row < cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: bad tokens {row}")

    # steady-state phase times at the serve shape (after the counted run)
    ptoks = server.prompts(list(range(per_node)))
    with torch.no_grad():
        prefill_ms = time_ms(torch, lambda: api.prefill(server.cfg, server.params, ptoks,
                                                        prompt_len + n_dec), runs=5, warmup=1)
        _, cache = api.prefill(server.cfg, server.params, ptoks, prompt_len + n_dec)
        tok = ptoks[:, :1]
        decode_ms = time_ms(torch, lambda: api.decode_step(server.cfg, server.params,
                                                           dict(cache), tok),
                            runs=10, warmup=2)
    print(f"[5] prefill_ms_per_batch {prefill_ms:.3f} (B={per_node}, S={prompt_len}) "
          f"decode_ms_per_token {decode_ms:.3f} (B={per_node}) "
          f"generated_tokens_per_s {rep['tokens_per_second']:.2f} "
          f"wall_seconds {rep['wall_seconds']:.3f} peak_mem_bytes {peak}")

    # ---- 6. where the time goes ------------------------------------------
    steps = (("prefill", lambda: api.prefill(server.cfg, server.params, ptoks,
                                             prompt_len + n_dec)),
             ("decode", lambda: api.decode_step(server.cfg, server.params, dict(cache), tok)))
    for label, step in steps:
        busy_ms, wall_ms, top = profile_step(torch, step)
        print(f"[6] {label} (B={per_node}) under the profiler: wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of wall); top: {top}")

    record = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": launches,
        "max_abs_err": path_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}
    print(card_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
