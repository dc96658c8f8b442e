#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3 for flash and SSD, then stop
    python3 chip_smoke.py --train-only     # phases 1 and 8, then stop
    python3 chip_smoke.py --serve-only     # phases 1-2, 5-6 and 9, then stop
    python3 chip_smoke.py --families-only  # phases 1-2, 3's new flash shapes, 10
    python3 chip_smoke.py --multirank-only # phases 1, 11 and 12 (builds quantize.cu, adamw.cu)
    python3 chip_smoke.py --dryrun-only    # phases 1, 2 (flash only) and 13
    python3 chip_smoke.py --examples-only  # phases 1, 2 (flash only) and 14
    python3 chip_smoke.py --moe-only       # phases 1 and 15

From the root of a checkout. It imports only the port (``src/repro_torch``),
never JAX or the JAX package, and runs, in order:

  1. card identity: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: the five CUDA sources (flash attention, SSD scan, the int8
     absmax/quantize pair, the optimizer, the served MoE dispatch and
     combine) from ``src/repro_torch/kernels/csrc`` with one
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
       K=5, hd=64, causal, window 1024), and at phase 10's: mixtral-8x22b
       (H=48, K=8, hd=128, window 4096, which never clips), grok-1-314b
       (softcap 30), chameleon-34b (H=64, K=8), all B=4, S=1024, causal,
       and whisper-tiny's encoder (B=4, S=1500, H=K=6, hd=64, non-causal,
       a ragged last tile) and cross-attention (Sq=64, Sk=1500), all bf16,
       where it also times the kernel, the plain version and one
       ``scaled_dot_product_attention`` call (none for the softcap, which
       SDPA lacks);
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
     - the loss's logit GEMMs at one chunk of mixtral-train (6 x 512 rows,
       d 6144, vocab 32768, bf16 from a seed): the tensor-core path
       (``_LogitsF32``: bf16 operands, fp32 sums, the fp32 logit gradient
       as two bf16 terms) against the fp32 upcast on the same tensors
       (logits within 1e-4 of the largest, lse, NLL sum and loss within
       1e-5; fp32 dH and dW within 1e-4, which the gradient rounded once
       to bf16 must miss, and the split alone within 1e-5; bf16 gradients
       through the loss within 2**-8), its counters, and the CUDA-event ms
       of a chunk's forward and backward both ways;
     - 8.1, the optimizer kernels (``csrc/adamw.cu``) on mixtral-8x22b's
       leaves at one layer, the experts cut from 8 to 4 (1.71 B parameters,
       bf16 but the fp32 router) so that a second, eager copy fits: in fp32
       and bf16 moments, the clip engaged and not, the norm the same bits
       twice and within 1e-6 of the eager norm, the clipped gradients
       bit-equal to the eager clip at the kernel's norm, the moments and
       parameters after AdamW bit-equal to the eager update, the launches
       counted; then the CUDA-event ms of the kernels and of the eager code
       and the kernels' share of their byte bound (the norm reads g, the
       clip reads and writes it, AdamW reads g, p, m, v and writes m, v, p);
     - llama3.2-3b cut to 2 layers at full width, weights drawn on the CPU:
       ``train_loss`` and its gradients on the card against the CPU in
       fp32 with TF32 off (loss within 1e-4, each gradient leaf within
       1e-3 in norm), then bf16 against fp32 on the card (loss within 2e-2
       relative, global gradient norm within 5%; the bf16 loss goes through
       ``_LogitsF32``);
     - ``make_batch(0, 0, 0, 1 x 1024, vocab 128256)``'s tokens against
       the SHA-256 that tests/test_torch_data.py pins from jax;
     - full-width llama3.2-3b through ``ResilientTrainer`` on 8 nodes in
       legions of 4, one 1024-token sequence a shard, 6 steps with faults
       (2, 1) and (4, 5): every step runs once, repairs at steps 2 and 4,
       8 -> 7 -> 6 shards, finite losses, the optimizer's kernels launched
       4 times a step, and no other kernel launched (the model's kernels
       are forward-only; training runs the plain paths, as the JAX
       package's does); per-step loss, wall ms and tokens/s, the peak
       memory, and one fault-free step under the profiler;
     - full-width mamba2-130m for 3 fault-free steps the same way;
     - the knobs: llama3.2-3b cut to 4 layers at full width in bf16 (B=2,
       S=1024), ``remat="dots"`` and ``scan_block=2`` against
       ``remat="full"`` (loss within 1e-5, gradient norm within 1e-4
       relative), each one's forward + backward ms and peak memory, and
       the ops the dots policy keeps on this torch (``aten.mm`` only, 7 a
       layer);
  9. the fault zoo: ``ChaosHarness(seed=0).run_matrix(64)`` with every
     cluster's torch data plane on the card; all 50 (scenario x recovery
     x workload) reports must pass their invariants;
 10. the other families (the earlier phases' tensors freed first):
     - the flash kernel against the plain path inside the models:
       mixtral-8x22b and grok-1-314b cut to 2 layers at full width in f32
       (TF32 off; logits within 2 x 2e-5, the plain run replaying the
       kernel run's expert choices), chameleon-34b (2 layers) and
       whisper-tiny in bf16 with phase 4's RMS-ratio check;
     - mixtral-8x22b (4 of 56 layers), grok-1-314b (2 of 64) and
       chameleon-34b (4 of 48) at full width through the engine as phase 5
       serves them, continuous only: every request once, SERVE_PINNED,
       flash 4 x n_layers a run; the timings of phase 6; the MoE layers'
       dropped fraction at prefill; chameleon's prefill on random patch
       embeddings (B=4, S=1024) and 16 decode steps;
     - whisper-tiny at full width and depth: ``api.prefill`` of random
       frames (B=4, 1500 x 384) and a 64-token prompt (12 flash launches:
       4 encoder, 4 decoder self- and 4 cross-attention), then 16 greedy
       decode steps (none);
 11. the multi-rank runtime (the earlier phases' tensors freed first):
     a. NCCL at world size 1: phase 7's path (16 ranks in legions of 4, the
        516 MB payloads, the int8 hop) once on the one-device plane, then
        with the process group started by ``init_from_env("cuda")``, which
        runs the plane's group path: byte-identical per step, the absmax
        and quantize launches counted over the group's run; then the MPI
        reductions beyond add (multiply, the logical and the bitwise ops;
        the bitwise ones and logical_xor fold from bytes on every backend) on
        int32 payloads through a shrink of ``Session(8)``, byte- and
        dtype-equal to the sim plane's numpy fold;
     b. four ranks on the one card over gloo (``backend="gloo"`` named
        explicitly; NCCL refuses two ranks on one card), each a process of
        this script (``--multirank-worker DIR``, started with torchrun's
        variables): a ``Session(8)`` campaign in two legions of 4, int8 on
        the cross-legion hop, through a substitution (node 5 by spare 8) and
        a shrink (node 1, the pool empty), beside the sim plane: every
        result byte-equal to the numpy fold and every error-feedback
        residual to the numpy twins', the kernels counted on every rank;
        then one gather of the survivors' payloads, bytes as sent;
        full-width llama3.2-3b's params (bf16, drawn on the card, 6.4 GB a
        rank) registered as the trainer registers them and resharded after
        each repair, the last time from 4 ranks to 3 (each ``ReshardReport``
        and every leaf's placements printed; every leaf reassembled and its
        fingerprint held to the one taken before registration); the MPI
        reductions of 11a over the four ranks;
     c. on the same four ranks, ``agree_bitmap_inprogram`` and
        ``make_hierarchical_allreduce`` over a (pod=2, data=2) mesh, against
        the AND of the bitmaps' rows and the sum of the blocks.
     A rank that fails, or runs past 600 s, stops every rank and the phase;
 12. the trainer over ranks (the earlier phases' tensors freed first; no
     model kernel launches: training runs the plain paths; the optimizer
     runs its kernels):
     a. NCCL at world size 1: phase 8's llama3.2-3b run (28 layers, 8 nodes
        in legions of 4, 1 x 1024 a shard, faults (2, 1) and (4, 5)) with the
        group that ``init_from_env("cuda")`` starts, so the trainer takes its
        step over the group; every step's loss and grad norm and the final
        params' fingerprints bit-identical to phase 8's run (under
        ``--multirank-only``, to a one-rank run made first and freed);
     b. four ranks on the one card over gloo, each a process of this script
        (``--train-worker DIR``): the same run at full width cut to 6 of 28
        layers (the whole state of four ranks fits on one card), params
        and AdamW moments resharded whole -> 4 ranks at step 2 and 4 -> 3
        at step 4 (rank 1 then holds no block), every leaf checked against
        ``param_specs`` after each repair, every rank's reports equal, loss
        and grad norm within 2e-2 of a one-rank run of the same cut made
        here first and freed; each step's wall seconds, tokens/s, assemble
        and gradient all-reduce seconds, each ``ReshardReport`` and each
        rank's peak memory printed. A rank that fails, or runs past 600 s,
        stops every rank and the phase; then the MoE configs over the same
        four ranks (``--moe-worker DIR``): mixtral-8x22b's and
        grok-1-314b's smoke configs in f32, 8 nodes, three steps through
        fault (1, 1), with the routing group (64 tokens) a shard's 2 x 32,
        spanning two shards on two ranks (shards of 1 x 32), cutting
        shards (1 x 24, the last group padded after the fault) and the
        published group (4096: one group of every live token); every
        rank's shards and repairs equal to the same runs with NCCL at
        world size 1 in this process and each step's loss, grad norm and
        aux loss and router z within 1e-5, every expert choice kept or
        dropped as there;
        then full-width mixtral-8x22b cut to 1 of 56 layers in bf16
        at its published group, 8 shards of 1 x 512 (one group spans all
        eight), three steps through fault (1, 1), on two gloo ranks
        (``--moe-full-worker DIR``; the state placed on their mesh before
        the first step) against NCCL at world size 1 here, loss and grad
        norm within 1e-3, aux loss and router z within 4e-3, at most 16
        of 8192 expert choices kept otherwise, each step's wall
        seconds and each rank's peak memory printed;
 13. placement and the dry-run (the earlier phases' tensors freed first):
     a. full-width llama3.2-3b (28 layers) through ``launch/steps.py``'s
        three step kinds on the card, inputs materialised from
        ``input_specs`` (the params by ``init_params``, the rest from a
        seeded generator): train at B=8, S=1024 with ``remat="full"``
        (the steps' train step is the trainer's ``make_train_step`` at
        gradient scale 1), twice, held bit for bit (loss, grad norm, every
        updated parameter) to the trainer's step called directly on the
        same weights and batch; prefill at B=4,
        S=4096 with ``use_pallas`` on and off, each against the fp32 model
        (phase 4's RMS ratio), flash launching exactly 28 times (counts
        zeroed just before, read just after); decode of one token at
        B=8 against a full 32768-token cache (30 GB), its logits finite
        and shaped, and ``decode_attention`` on layer 0's cache held to
        an fp32 softmax over the whole cache written out in this script
        (2 bf16 ulps of the largest output); each step's wall ms and peak
        memory;
     b. the dry-run of the same three cells on a (1, 1) mesh of a fake
        process group of one, in a process of this script
        (``--dryrun-worker card``, started before 13a, no card): its
        argument bytes equal to the card's input bytes and to the specs'
        sum, its peak estimate within 0.5-2.0 of the card's peak; then
        ``launch/kernel_roofline.report`` of the prefill cell: the
        attention-interior bytes (which must lie strictly between 0 and the
        step's bytes), their share, and the memory terms of the blocked
        path and of the flash kernel on the H100's datasheet figures,
        printed beside 13a's measured plain and kernel prefill times;
     c. the production cells, llama3.2-3b ``train_4k`` and ``decode_32k`` on
        (16, 16) and (2, 16, 16) over fake groups of 256 and 512 ranks
        (``--dryrun-worker production``, beside b): per device the argument
        bytes (checked against the specs' sum), peak bytes, FLOPs and wire
        bytes, the roofline terms on the H100's datasheet figures, the
        useful-FLOP ratio and the seconds each took; beside them, in a third
        worker (``--dryrun-worker repaired``), the decode cells DTensor once
        could not view, at full depth: mixtral-8x22b and grok-1-314b
        ``decode_32k`` on (2, 16, 16), whisper-tiny ``decode_32k`` on both
        meshes, each completing with its argument bytes equal to the
        specs' sum;
 14. the examples: each ``examples_torch/*.py`` in a process of its own on
     the card (their default device), three at a time, at its reference's
     default arguments or the CI form the reference documents
     (``resilient_training.py --tiny``; ``chaos_campaign.py --preset
     rack_outage --preset transient_flap --recovery substitute``), each
     with a 300 s limit of its own, run by this script
     (``--example-worker``), which zeroes every kernel count just before
     the twin starts and reads them when it ends; each must exit 0, and its
     wall seconds, launches and last lines are printed (logs in
     ``build/examples/``);
 15. the served MoE dispatch and combine (``kernels/moe_dispatch.py``) at
     the served cells' shapes, ``bench/configs/mixtral-8x22b-1l.json`` and
     ``granite-4.0-h-small-10l.json``, bf16:
     a. one MoE layer at the node batch's prefill (8 x 4,096 tokens), routed
        by its router from seeded tokens: the gather bit-equal to its plain
        version and to the eager path's buffer (expert-major), the expert
        outputs bit-equal, the combine bit-equal to ``moe_combine_ordered``
        and within one bf16 ulp of the eager ``einsum``, one launch each;
        each kernel's CUDA-event ms beside its byte bound at 3.35 TB/s and
        its plain version's ms, the layer's dispatch, experts and combine
        eager and served, the three expert GEMMs alone, and the peak above
        the inputs of each path;
     b. one node batch of the whole cell (8 prompts of 4,096, 2 greedy
        tokens) on the eager path (the parent's) and the served path, the
        same weights: the greedy tokens equal, the prefill and decode
        logits' largest difference over the largest logit, the served
        peak not above the eager one, the launches (n_layers a step
        served, none eager), the ms of each and one prefill of each under
        the profiler (busy ms, top kernels).

Any failed phase exits non-zero. Without a CUDA device it exits 1 and prints
no result. The last three lines are the card's ``nvidia-smi`` line, the
kernels' JSON record (each kernel's time, bound and share of the bound,
its launches on every path: each model's continuous serve run under its
name, the lock-step run under "<name>/lockstep", the train runs', phase
10's runs under their names, phase 11's as "multirank:nccl1" and
"multirank:gloo4", phase 12's as "train:nccl1" and "train:gloo4",
summed over the ranks, 12b's MoE runs as "train:moe-nccl1",
"train:moe-gloo4" and "train:moe-gloo2", summed over the ranks, phase
13a's as "steps:train",
"steps:prefill" and "steps:decode", and each twin of phase 14 as
"examples:<name>") and ``{"ok":
true, "device": {...}}``; ``--kernels-only``, ``--train-only``,
``--serve-only``, ``--families-only``, ``--multirank-only``,
``--dryrun-only`` and ``--examples-only`` print neither of the last two.
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
DECODE_ATTN_ULPS = 2          # 13a: decode attention vs fp32, bf16 ulps of its largest output
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


def stub_embeds(torch, cfg, batch, seq, dev):
    """Random frame (enc-dec: encoder_seq_len of them) or patch embeddings,
    (batch, n, d_model) fp32 on the card: the stub frontends' input."""
    n = cfg.encoder_seq_len if cfg.is_encoder_decoder else seq
    return torch.randn((batch, n, cfg.d_model), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))


def model_check(torch, api, cfg2, batch, seq, dev, *, embeds=False, tag=4):
    """Phases 4 and 10: bf16 prefill logits with ``use_pallas`` on and off,
    each held against the same weights run in fp32 (RMS, MODEL_RMS_RATIO);
    ``embeds`` feeds the stub frontend random embeddings."""
    params = api.init_params(cfg2, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg2.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    kw = {"embeds": stub_embeds(torch, cfg2, batch, seq, dev)} if embeds else {}
    cfg32 = cfg2.replace(dtype="float32", param_dtype="float32")
    with torch.no_grad():
        lk, _ = api.prefill(cfg2.replace(use_pallas=True), params, tokens, seq + 16, **kw)
        lp, _ = api.prefill(cfg2.replace(use_pallas=False), params, tokens, seq + 16, **kw)
        lf, _ = api.prefill(cfg32, to_float(params), tokens, seq + 16, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and lk.shape == (batch, 1, cfg2.vocab_size)):
        raise AssertionError(f"{cfg2.name}: prefill logits are not finite or misshapen")
    rms_kernel = (lk - lf).square().mean().sqrt().item()
    rms_plain = (lp - lf).square().mean().sqrt().item()
    what = "embeds" if embeds else "tokens"
    print(f"[{tag}] {cfg2.name} d={cfg2.d_model} {cfg2.n_layers} layers prefill B={batch} "
          f"S={seq} ({what}): logits std {lf.std().item():.3f}; vs the fp32 model: bf16 "
          f"kernels rms {rms_kernel:.3e} max {(lk - lf).abs().max().item():.3e}, bf16 plain rms "
          f"{rms_plain:.3e} max {(lp - lf).abs().max().item():.3e}; rms ratio "
          f"{rms_kernel / rms_plain:.3f} (limit {MODEL_RMS_RATIO})")
    if rms_kernel > MODEL_RMS_RATIO * rms_plain:
        raise AssertionError(f"{cfg2.name}: logits through the kernels are further from "
                             "fp32 than rounding explains")
    del params
    torch.cuda.empty_cache()
    return rms_kernel / rms_plain


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


# ---- the multi-rank runtime (phase 11) ------------------------------------
MR_WORLD = 4                    # ranks on the one card, over gloo
MR_NODES, MR_LEGION, MR_SPARES = 8, 4, 1
MR_THRESHOLD = 4                # hierarchical from 4 nodes: two legions of 4, masters 0 and 4
# node 5 (rank 1) dies and spare 8 (rank 0) takes its place; then node 1
# dies with the pool empty and is shrunk away: rank 1 holds no node any
# more, and the survivors' mesh goes from 4 ranks to 3
MR_FAULTS = [(2, 5), (4, 1)]
MR_STEPS = 6
MR_ELEMS = 4_194_304            # an integer-valued f32 payload a node (16 MiB)
MR_ARCH = "llama3.2-3b"         # the registered state: its params at full width
MR_TIMEOUT_S = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world1_group(dev):
    """The process group that ``init_from_env(dev.type)`` starts at world
    size 1 (NCCL on the card), torchrun's variables set for it and put back
    after; yields the backend's name."""
    import torch.distributed as dist

    from repro_torch.dist import init_from_env

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        init_from_env(dev.type)
        yield dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mr_payload(torch, dev, node, step, n):
    """Node ``node``'s payload at ``step``: small integers in f32, whose sums
    are exact in any order."""
    i = torch.arange(n, device=dev, dtype=torch.int64)
    return ((i * (node + 3) + step) % 13 - 6).to(torch.float32)


def fingerprint(torch, t) -> int:
    """A position-weighted sum of ``t``'s bit patterns (int64 on t's device,
    wrapping): equal for equal bytes, and any moved or changed element
    shows."""
    flat = t.detach().reshape(-1)
    bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[flat.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    step = 1 << 26
    for s in range(0, bits.numel(), step):
        b = bits[s:s + step].to(torch.int64)
        total += (b * (torch.arange(s, s + b.numel(), device=t.device) % 65521 + 1)).sum()
    return int(total)


def leaves_of(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_of(v, path + (str(k),))
    else:
        yield path, tree


# the predefined MPI reductions beyond add, run on the torch plane against the
# sim plane's numpy fold: Session(8) in legions of 4 through a shrink (a
# member at step 2, a master at step 3)
MPI_OPS = ("multiply", "logical_and", "logical_or", "logical_xor", "bitwise_and", "bitwise_or",
           "bitwise_xor")
MPI_OPS_FAULTS = [(2, 5), (3, 0)]
MPI_OPS_STEPS = 5


def mpi_ops_run(torch, P, PM, dev) -> dict:
    """Each MPI_OPS op: an allreduce and a reduce a step of int32 payloads
    with zeros among them (the logical ops' False) on the torch plane on
    ``dev`` (over the process group this process holds, if any) and on the
    sim plane; returns {op: every result's bytes and dtype, and every
    stage list and clock, equal at every step}."""
    import numpy as np

    out = {}
    for name in MPI_OPS:
        op = getattr(np, name)
        sess, sim = (PM.Session(8, policy=P.LegioPolicy(legion_size=4, data_plane=plane),
                                injector=P.FaultInjector.at(MPI_OPS_FAULTS), device=device)
                     for plane, device in (("torch", dev), ("sim", "cpu")))
        ok = True
        for step in range(MPI_OPS_STEPS):
            sess.advance(step)
            sim.advance(step)
            live = [m for m in sim.world.members if m not in sim.cluster.failed]
            host = {m: ((np.arange(64) * (m + 3) + step) % 5 - 2).astype(np.int32) for m in live}
            on_dev = {m: torch.from_numpy(v).to(dev) for m, v in host.items()}
            for call in (lambda comm, c: comm.allreduce(c, op),
                         lambda comm, c: comm.reduce(c, root=comm.members[-1], op=op)):
                got, want = call(sess.world, on_dev), call(sim.world, host)
                ok &= got.stages == want.stages and got.sim_seconds == want.sim_seconds
                ok &= set(got.data) == set(want.data) and all(
                    (lambda g, w: g.dtype == w.dtype and g.tobytes() == w.tobytes())(
                        got.data[n].cpu().numpy(), np.asarray(want.data[n])) for n in want.data)
        out[name] = bool(ok)
    return out


def nccl_world1(torch, P, PM, dev, counters) -> dict:
    """Phase 11a: the runtime phase's path (16 ranks in legions of 4, 516 MB
    payloads, the int8 hop) on the one-device plane, then the same script
    with the process group started by ``init_from_env`` (NCCL on the card)
    at world size 1, which runs the plane's group path: byte-equal results,
    stages and clock; the kernels counted over the group's run."""
    _, one = runtime_run(torch, P, PM, dev, GRAD_ELEMS, "torch")
    with world1_group(dev) as backend:
        zero(counters)
        sess, group = runtime_run(torch, P, PM, dev, GRAD_ELEMS, "torch")
        launches = launches_of(torch, counters)
        plane = sess.cluster.dataplane
        if not (plane.distributed and plane.world == 1) or sess.cluster.reshards:
            raise AssertionError("the plane did not take the process group's path")
        del sess
        ops = mpi_ops_run(torch, P, PM, dev)
    print(f"[11a] {backend}, one rank: the MPI reductions on int32 payloads through a shrink "
          f"(the bitwise ones and logical_xor fold from bytes), byte- and dtype-equal to "
          f"the sim plane's numpy fold: {json.dumps(ops)}")
    if not all(ops.values()):
        raise AssertionError(f"phase 11a: an MPI reduction differs from the numpy fold: {ops}")
    same = [torch.equal(a["out"].view(torch.int32), b["out"].view(torch.int32))
            and a["stages"] == b["stages"] and a["sim_seconds"] == b["sim_seconds"]
            for a, b in zip(one, group)]
    compressed = sum(r["compressed"] for r in group)
    print(f"[11a] {backend}, one rank (init_from_env({dev.type!r})): {RUNTIME_STEPS} allreduces "
          f"of {GRAD_ELEMS} f32 a rank over the group path, byte-identical to the one-device "
          f"plane per step (results, stages, sim_seconds): {same}")
    print(f"[11a] allreduce ms (wall, card synchronised), one-device plane "
          f"{[round(r['allreduce_ms'], 3) for r in one]}; {backend}, one rank "
          f"{[round(r['allreduce_ms'], 3) for r in group]}; launches {json.dumps(launches)}")
    want = {"flash_attention": 0, "ssd_scan": 0, "absmax": compressed,
            "quantize_int8": compressed}
    if not all(same) or len(same) != RUNTIME_STEPS:
        raise AssertionError("the group path at world size 1 differs from the one-device plane")
    if launches != want or compressed == 0:
        raise AssertionError(f"phase 11a launches {launches}, expected {want}")
    out = dict(backend=backend, launches=launches,
               allreduce_ms_one_device=[r["allreduce_ms"] for r in one],
               allreduce_ms_group=[r["allreduce_ms"] for r in group])
    del one, group
    torch.cuda.empty_cache()
    return out


def multirank_worker(torch, dev, cfg, elems, out_path: Path) -> dict:
    """Phase 11b and 11c on one rank of MR_WORLD (started by the parent with
    torchrun's variables): the Session campaign through a substitution and a
    shrink with int8 compression, beside the sim plane; cfg's params
    registered and resharded; the in-program functions on a (pod=2, data=2)
    mesh. Writes its record to ``out_path`` and returns it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import core as P, mpi as PM
    from repro_torch.core.agreement import agree_bitmap_inprogram
    from repro_torch.core.collectives import make_hierarchical_allreduce
    from repro_torch.dist import init_from_env
    from repro_torch.dist.sharding import assemble, leaf_spec, placements
    from repro_torch.kernels import quantize as Q
    from repro_torch.models import api

    dev = init_from_env(dev.type, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    tag = f"[11b] rank {rank}"
    print(f"{tag} of {world}: backend {dist.get_backend()} (named explicitly), device {dev}",
          flush=True)
    counters = {"absmax": Q.absmax_cuda, "quantize_int8": Q.quantize_int8_cuda}

    def session(plane, device):
        policy = P.LegioPolicy(legion_size=MR_LEGION, hierarchical_threshold=MR_THRESHOLD,
                               recovery_mode="substitute_then_shrink", spare_nodes=MR_SPARES,
                               grad_compression="int8", data_plane=plane)
        return PM.Session(MR_NODES, policy=policy, injector=P.FaultInjector.at(MR_FAULTS),
                          device=device)

    sess, sim = session("torch", dev), session("sim", "cpu")
    plane = sess.cluster.dataplane
    if not (plane.distributed and plane.world == world and plane.rank == rank):
        raise AssertionError(f"{tag}: the plane did not take the process group")
    holder = {"params": api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)}
    prints = {path: fingerprint(torch, leaf) for path, leaf in leaves_of(holder["params"])}
    n_bytes = sum(leaf.numel() * leaf.element_size() for _, leaf in leaves_of(holder["params"]))
    sess.register_sharded_state("trainer.params", lambda: holder["params"],
                                lambda p: holder.update(params=p))
    torch.cuda.synchronize()
    zero(counters)
    steps = []
    for step in range(MR_STEPS):
        sess.advance(step)
        sim.advance(step)
        if list(sess.cluster.topo.nodes) != list(sim.cluster.topo.nodes):
            raise AssertionError(f"{tag} step {step}: the topologies diverged")
        live = [m for m in sess.world.members if m not in sess.cluster.failed]
        contrib = {m: mr_payload(torch, dev, m, step, elems) for m in live}
        host = {m: v.cpu().numpy() for m, v in contrib.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.world.allreduce(contrib)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        res_s = sim.world.allreduce(host)
        got = res.data[sess.world.members[0]].cpu().numpy()
        want = res_s.data[sim.world.members[0]]
        resid, resid_s = sess.cluster.compress_residuals, sim.cluster.compress_residuals
        steps.append(dict(
            step=step, size=sess.world.size, allreduce_ms=ms,
            repaired=bool(sess.take_actions()),
            level1=next(st[1] for st in res.stages if st[0] == "global"),
            bytes_equal=got.tobytes() == want.tobytes(),
            control_equal=res.stages == res_s.stages and res.sim_seconds == res_s.sim_seconds,
            residuals_equal=set(resid) == set(resid_s) and all(
                resid[m].cpu().numpy().tobytes() == resid_s[m].tobytes() for m in resid_s)))
        del contrib, host, res
    launches = launches_of(torch, counters)
    # a gather of CUDA payloads over gloo: each owner's rows summed as bytes
    live = [m for m in sess.world.members if m not in sess.cluster.failed]
    sent = {m: mr_payload(torch, dev, m, MR_STEPS, elems) for m in live}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gathered = sess.world.gather(sent)
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) * 1e3
    gather_ok = set(gathered) == set(live) and all(
        torch.equal(gathered[m].view(torch.int32), sent[m].view(torch.int32)) for m in live)
    del sent, gathered
    reshards = [dict(leaves=r.leaves, n_devices=r.n_devices, moved_bytes=r.moved_bytes,
                     wall_seconds=r.wall_seconds, mesh_shape=list(r.mesh_shape))
                for r in sess.cluster.reshards]
    mesh = plane.mesh_for(sess.cluster.topo.view())
    placed, held = {}, 0
    for path, leaf in leaves_of(holder["params"]):
        want_p = placements(leaf_spec(path, tuple(leaf.shape), mesh), mesh)
        if leaf.device_mesh != mesh or tuple(leaf.placements) != want_p:
            raise AssertionError(f"{tag}: {'.'.join(path)} placed {leaf.placements}")
        placed[".".join(path)] = dict(placements=[repr(p) for p in leaf.placements],
                                      local=list(leaf.to_local().shape))
        held += leaf.to_local().numel() * leaf.to_local().element_size()
    # every rank assembles every leaf together (a collective): no short cut
    intact = all([fingerprint(torch, assemble(leaf)) == prints[path]
                  for path, leaf in leaves_of(holder["params"])])
    hop = mr_payload(torch, dev, 0, 0, elems)
    hop_ms = time_ms(torch, lambda: plane.compress(hop, "int8", 0.0), runs=10, reps=10)
    ops = mpi_ops_run(torch, P, PM, dev)

    # 11c: the in-program functions on a (pod=2, data=2) mesh of the ranks
    m22 = DeviceMesh(dev.type, torch.arange(world).reshape(2, world // 2),
                     mesh_dim_names=("pod", "data"))
    gen = torch.Generator().manual_seed(11)
    bitmaps = (torch.rand((2 * world, 64), generator=gen) > 0.05).to(torch.int32)
    agreed = agree_bitmap_inprogram(m22, bitmaps.to(dev))
    agree_ok = agreed.tobytes() == bitmaps.amin(0).numpy().tobytes()
    x = torch.randint(-50, 50, (2 * world, 1024), generator=gen).to(torch.float32)
    spec = (("pod", "data"),)
    y = make_hierarchical_allreduce(m22, spec)(
        distribute_tensor(x.to(dev), m22, placements(spec, m22), src_data_rank=None))
    allreduce_ok = torch.equal(y.to_local().cpu(), x.reshape(world, 2, 1024).sum(0))
    record = dict(rank=rank, world=world, backend=dist.get_backend(), steps=steps,
                  launches=launches, gather_ok=gather_ok, gather_ms=gather_ms,
                  gathered=len(live), reshards=reshards, placements=placed, held_bytes=held,
                  state_bytes=n_bytes, intact=intact, hop_ms=hop_ms,
                  agreed_alive=int(agreed.sum()), agree_ok=agree_ok, allreduce_ok=allreduce_ok,
                  mpi_ops=ops,
                  peak_bytes=torch.cuda.max_memory_allocated())
    dist.barrier()
    dist.destroy_process_group()
    out_path.write_text(json.dumps(record))
    return record


def multirank_check(records: list[dict]) -> dict:
    """Phase 11b/c's verdict over every rank's record."""
    launches = {"absmax": 0, "quantize_int8": 0}
    for rec in records:
        tag = f"[11b] rank {rec['rank']}"
        level1 = sum(s["level1"] for s in rec["steps"])
        for s in rec["steps"]:
            print(f"{tag} step {s['step']}: {s['size']} nodes, allreduce {s['allreduce_ms']:.3f} ms "
                  f"(wall, card synchronised{'; a repair and its reshard inside' if s['repaired'] else ''}), "
                  f"level-1 participants {s['level1']}, result == "
                  f"numpy fold bytewise {s['bytes_equal']}, int8 residuals == numpy twins "
                  f"bytewise {s['residuals_equal']}, stages and sim_seconds equal "
                  f"{s['control_equal']}")
        print(f"{tag}: launches {json.dumps(rec['launches'])} (level-1 participants summed "
              f"{level1}); compression hop {rec['hop_ms']:.4f} ms a call at {MR_ELEMS} f32; "
              f"gather of {rec['gathered']} nodes' payloads {rec['gather_ms']:.3f} ms (wall, card "
              f"synchronised), bytes as sent {rec['gather_ok']}; "
              f"reshards {json.dumps(rec['reshards'])}; state held after "
              f"{rec['held_bytes']} B of {rec['state_bytes']} B; reassembled leaves intact "
              f"{rec['intact']}; peak memory {rec['peak_bytes']} B")
        print(f"{tag}: the MPI reductions on int32 payloads through a shrink, byte- and "
              f"dtype-equal to the sim plane's numpy fold: {json.dumps(rec['mpi_ops'])}")
        if not all(rec["mpi_ops"].values()):
            raise AssertionError(f"{tag}: an MPI reduction differs from the numpy fold")
        print(f"[11c] rank {rec['rank']}: agree_bitmap_inprogram on (pod=2, data=2) == AND of "
              f"the rows {rec['agree_ok']} ({rec['agreed_alive']} of 64 alive); "
              f"make_hierarchical_allreduce == sum of the blocks {rec['allreduce_ok']}")
        if rec["backend"] != "gloo" or len(rec["steps"]) != MR_STEPS or not all(
                s["bytes_equal"] and s["residuals_equal"] and s["control_equal"]
                for s in rec["steps"]):
            raise AssertionError(f"{tag}: the campaign differs from the numpy fold")
        if rec["launches"] != {"absmax": level1, "quantize_int8": level1} or level1 == 0:
            raise AssertionError(f"{tag}: launches {rec['launches']}, expected {level1} each")
        shapes = [tuple(r["mesh_shape"]) for r in rec["reshards"]]
        if shapes[-2:] != [(MR_WORLD, 1), (MR_WORLD - 1, 1)] or not all(
                r["wall_seconds"] > 0 and r["moved_bytes"] == rec["state_bytes"]
                for r in rec["reshards"]):
            raise AssertionError(f"{tag}: reshards {rec['reshards']}")
        if not (rec["intact"] and rec["agree_ok"] and rec["allreduce_ok"] and rec["gather_ok"]):
            raise AssertionError(f"{tag}: placed state or in-program results wrong")
        for k in launches:
            launches[k] += rec["launches"][k]
    if len({json.dumps(r["reshards"][-1]["mesh_shape"]) for r in records}) != 1 or \
            len({r["reshards"][-1]["wall_seconds"] for r in records}) != 1:
        raise AssertionError("the ranks disagree on the last reshard")
    first = records[0]
    for name, p in first["placements"].items():
        print(f"[11b] {name}: placements {p['placements']}, rank 0 holds {p['local']}")
    return {"flash_attention": 0, "ssd_scan": 0, **launches}


def run_ranks(flag: str, out_dir: Path, tag: str, world: int = MR_WORLD) -> list[dict]:
    """``world`` copies of this script with ``flag out_dir`` and torchrun's
    variables (gloo on the one card); each rank's log is printed. A rank
    that fails or outlives MR_TIMEOUT_S stops every rank and raises.
    Returns each rank's record, ``out_dir/rank<r>.json``."""
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    port = str(free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        log = open(out_dir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), flag,
                                        str(out_dir)],
                                       env=env, stdout=log, stderr=subprocess.STDOUT,
                                       cwd=str(ROOT)), log))
    deadline = time.monotonic() + MR_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            if any(p.poll() not in (None, 0) for p, _ in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for rank in range(world):
        print((out_dir / f"rank{rank}.log").read_text().rstrip())
    codes = [p.returncode for p, _ in procs]
    if any(codes):
        raise AssertionError(f"phase {tag}: rank exit codes {codes} (a kill means a rank failed "
                             f"first or {MR_TIMEOUT_S} s passed)")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


def multirank_phase(torch, P, PM, dev, counters) -> dict:
    """Phase 11: (a) NCCL at world size 1 in this process; (b, c) MR_WORLD
    ranks on the one card over gloo, each a process of this script with
    ``--multirank-worker``. A rank that fails or outlives MR_TIMEOUT_S
    fails the phase (every rank is stopped). Returns the launches by path."""
    t0 = time.perf_counter()
    a = nccl_world1(torch, P, PM, dev, counters)
    records = run_ranks("--multirank-worker", ROOT / "build" / "multirank", "11b")
    b_launches = multirank_check(records)
    print(f"[11] phase 11 took {time.perf_counter() - t0:.1f} s")
    return {"multirank:nccl1": a["launches"], f"multirank:gloo{MR_WORLD}": b_launches}


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
    expect = {"flash_attention": cfg.family in ("dense", "moe", "vlm", "hybrid"),
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


def serve_phase(torch, P, PM, api, serve_mod, models, dev, counters, *,
                modes=("continuous", "lockstep"), tag=5, after=None) -> dict:
    """Phases 5-6 (and 10): each (config, prompt length) of ``models``
    served through the engine at full width in each of ``modes``, each run
    held to check_serve_run and two runs' tokens to each other (their
    dispatch is the same, so their batches are). After the continuous run,
    the steady-state prefill and decode times and one profiled prefill and
    decode step (phase 6), then ``after(server, numbers)`` where given, with
    the run's report, peak memory, tokens/s and those times. Each model's
    servers are freed (``gc.collect``: the engine's pipeline listener closes
    a cycle that holds the weights) before the next one is built. Lines are
    tagged ``[tag]``. Returns the launches by path."""
    launches_by_path = {}
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    for cfg, prompt_len in models:
        arch = cfg.name
        held = torch.cuda.memory_allocated()
        print(f"[{tag}] {arch}: {held} B allocated before its servers are built "
              f"(phase {tag} began with {base} B)")
        if held > base + SERVE_HELD_SLACK:
            raise AssertionError(f"{arch}: an earlier model's memory is still held")
        tokens_by_mode = {}
        for mode in modes:
            server, rep, launches, calls, reports, peak = serve_run(
                torch, P, PM, serve_mod, cfg, prompt_len, dev, counters,
                continuous=mode == "continuous")
            tok_s = rep["completed"] * SERVE_DECODE / rep["wall_seconds"]
            n_params = api.count_params(server.params)
            print(f"[{tag}] serve {arch}/{mode} full width ({n_params / 1e9:.3f} B params, "
                  f"{cfg.n_layers} layers, d={cfg.d_model}, vocab {cfg.vocab_size}), "
                  f"{SERVE_NODES} nodes, fault {SERVE_FAULT}: {json.dumps(rep)}")
            for line in round_lines(reports):
                print(f"[{tag}] {arch}/{mode} {line}")
            print(f"[{tag}] {arch}/{mode} kernel launches {json.dumps(launches)} over "
                  f"{len(calls)} work_fn calls {calls}; wall_seconds {rep['wall_seconds']:.3f} "
                  f"generated_tokens_per_s {tok_s:.2f} peak_mem_bytes {peak} "
                  f"({peak / 2**30:.2f} GiB)")
            check_serve_run(cfg, mode, rep, launches, calls, server.completed)
            tokens_by_mode[mode] = dict(server.completed)
            launches_by_path[arch if mode == "continuous" else f"{arch}/{mode}"] = launches
            if mode == "continuous":
                timings = serve_timings(torch, api, server, arch, prompt_len, tag)
                if after is not None:
                    after(server, dict(rep, peak_mem_bytes=peak, tokens_per_s=tok_s,
                                       **timings))
            del server
            gc.collect()
            torch.cuda.empty_cache()
        if len(modes) < 2:
            continue
        same = all((tokens_by_mode["continuous"][r] == tokens_by_mode["lockstep"][r]).all()
                   for r in range(SERVE_REQUESTS))
        print(f"[{tag}] {arch} tokens, continuous vs lock-step (same dispatch): "
              f"{'identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{arch}: the two modes served different tokens")
    return launches_by_path


def serve_timings(torch, api, server, arch, prompt_len, tag=5):
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
    print(f"[{tag}] {arch} prefill_ms_per_batch {prefill_ms:.3f} (B={SERVE_PER_NODE}, "
          f"S={prompt_len}) decode_ms_per_token {decode_ms:.3f} (B={SERVE_PER_NODE})")
    steps = (("prefill", lambda: api.prefill(server.cfg, server.params, ptoks, total)),
             ("decode", lambda: api.decode_step(server.cfg, server.params, dict(cache), tok)))
    out = {"prefill_ms": prefill_ms, "decode_ms": decode_ms}
    for label, step in steps:
        busy_ms, wall_ms, top = profile_step(torch, step)
        out[f"{label}_profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms, "top": top}
        print(f"[{tag if tag != 5 else 6}] {arch} {label} (B={SERVE_PER_NODE}) under the "
              f"profiler: wall "
              f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of "
              f"wall); top: {top}")
    return out


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


# ---- the other families (phase 10) ----------------------------------------
# (arch, layers kept of the published depth): full width, cut to fit 80 GB
FAMILY_SERVE = (("mixtral-8x22b", 4), ("grok-1-314b", 2), ("chameleon-34b", 4))
FAMILY_PROMPT = 1024
WHISPER_B, WHISPER_PROMPT = 4, 64
MOE_CHECK_LAYERS, MOE_CHECK_B, MOE_CHECK_S = 2, 1, 1024
# The MoE models' kernel-vs-plain check runs in f32 with TF32 off, so both
# paths make the same products but attention's; per logit |kernel - plain|
# may be at most tol + tol * |plain| with tol = n_layers x flash's own f32
# tolerance (TOL, 2e-5): each layer's attention output may move by the
# kernel's tolerance and the residual stream adds the layers' moves. The
# plain run replays the kernel run's expert choices: a choice is a step
# function of its logits, and a near-tie flips on any rounding difference.


@contextlib.contextmanager
def routing(moe_mod, torch, *, record=None, replay=None):
    """Within the block each MoE call's (expert_idx, slot, keep) is appended to
    ``record``, or taken from ``replay`` with the gates recomputed from this
    run's own router logits. Yields the count of expert choices each replayed
    call would have made otherwise."""
    route = moe_mod._route_group
    replayed = iter(replay or ())
    differ = []

    def wrapped(cfg, logits, capacity):
        out = route(cfg, logits, capacity)
        if record is not None:
            record.append(out[:3])
        if replay is not None:
            idx, slot, keep = next(replayed)
            differ.append(int((idx != out[0]).sum()))
            gates = torch.softmax(logits, dim=-1).gather(-1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
            out = (idx, slot, keep, gates, *out[4:])
        return out

    moe_mod._route_group = wrapped
    try:
        yield differ
    finally:
        moe_mod._route_group = route


def moe_f32_check(torch, api, moe_mod, cfg2, dev) -> dict:
    """Phase 10: ``cfg2`` (a MoE model cut in depth) in f32, prefill logits
    with the flash kernel against without, on the same routing."""
    cfg32 = cfg2.replace(dtype="float32", param_dtype="float32")
    params = api.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg32.vocab_size, (MOE_CHECK_B, MOE_CHECK_S),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    decisions = []
    with torch.no_grad():
        with routing(moe_mod, torch, record=decisions):
            lk, _ = api.prefill(cfg32.replace(use_pallas=True), params, tokens, MOE_CHECK_S + 16)
        with routing(moe_mod, torch, replay=decisions) as differ:
            lp, _ = api.prefill(cfg32.replace(use_pallas=False), params, tokens,
                                MOE_CHECK_S + 16)
    torch.cuda.synchronize()
    tol = cfg2.n_layers * TOL["float32"]
    err = (lk - lp).abs()
    ok = bool(torch.isfinite(lk).all()) and bool((err <= tol + tol * lp.abs()).all())
    dropped = [1.0 - keep.float().mean().item() for _, _, keep in decisions]
    print(f"[10] {cfg2.name} {cfg2.n_layers} layers d={cfg2.d_model} f32 (TF32 off) prefill "
          f"B={MOE_CHECK_B} S={MOE_CHECK_S}: kernel vs plain logits max_abs_err "
          f"{err.max().item():.3e} (limit {tol:g} + {tol:g} x |logit|, logits max "
          f"{lp.abs().max().item():.3f}); expert choices the plain run would have made "
          f"otherwise, per MoE layer {differ} of {MOE_CHECK_B * MOE_CHECK_S * cfg2.experts_per_token}"
          f"; dropped fraction per layer {[round(d, 4) for d in dropped]} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{cfg2.name}: f32 logits through the flash kernel differ from "
                             "the plain path's beyond its tolerance")
    del params
    torch.cuda.empty_cache()
    return dict(max_abs_err=err.max().item(), tol=tol, other_choices=differ, dropped=dropped)


def launches_of(torch, counters):
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters.items()}


def zero(counters):
    for fn in counters.values():
        fn.launches = 0


def greedy_decode(torch, api, cfg, params, logits, cache, steps):
    """``steps`` greedy decode steps from prefill's logits and cache; (B, steps) tokens."""
    out = []
    with torch.no_grad():
        for _ in range(steps):
            tok = logits[:, -1, :].argmax(dim=-1)[:, None]
            out.append(tok)
            logits, cache = api.decode_step(cfg, params, cache, tok)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name}: decode logits are not finite")
    return torch.cat(out, dim=1)


def embeds_run(torch, api, cfg, params, tokens, embeds, dev, counters, label) -> dict:
    """One ``api.prefill`` with the stub frontend's ``embeds`` and
    SERVE_DECODE greedy decode steps, counts zeroed before each and read
    after: the flash kernel once per attention of prefill and never in
    decode. Then the steady-state times of both."""
    B, S = tokens.shape
    total = S + SERVE_DECODE
    zero(counters)
    with torch.no_grad():
        logits, cache = api.prefill(cfg, params, tokens, total, embeds=embeds)
    prefill_launches = launches_of(torch, counters)
    zero(counters)
    toks = greedy_decode(torch, api, cfg, params, logits, cache, SERVE_DECODE)
    decode_launches = launches_of(torch, counters)
    attentions = (cfg.n_encoder_layers + 2 * cfg.n_layers) if cfg.is_encoder_decoder \
        else cfg.n_layers
    want = {name: attentions if name == "flash_attention" else 0 for name in counters}
    ok = (prefill_launches == want and not any(decode_launches.values())
          and logits.shape == (B, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()))
    with torch.no_grad():
        prefill_ms = time_ms(torch, lambda: api.prefill(cfg, params, tokens, total,
                                                        embeds=embeds), runs=5, warmup=1)
        decode_ms = time_ms(torch, lambda: api.decode_step(cfg, params, dict(cache),
                                                           tokens[:, :1]), runs=10, warmup=2)
    print(f"[10] {label} prefill B={B} S={S} embeds {tuple(embeds.shape)}: launches "
          f"{json.dumps(prefill_launches)}; {SERVE_DECODE} greedy decode steps: launches "
          f"{json.dumps(decode_launches)}; prefill_ms {prefill_ms:.3f} decode_ms_per_token "
          f"{decode_ms:.3f} (B={B}); first tokens {toks[0, :8].tolist()} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: expected {want} launches in prefill and none in "
                             f"decode, finite logits and in-vocab tokens")
    return dict(prefill_launches=prefill_launches, decode_launches=decode_launches,
                prefill_ms=prefill_ms, decode_ms=decode_ms)


def families_phase(torch, P, PM, api, serve_mod, dev, counters) -> dict:
    """Phase 10, the other families (the earlier phases' tensors freed first):
    the flash kernel against the plain path inside mixtral and grok (f32, 2
    layers), chameleon (bf16, 2 layers) and whisper (bf16); mixtral (4 of 56
    layers), grok (2 of 64) and chameleon (4 of 48) at full width served
    through the engine as phase 5 serves, continuous, with MoE's dropped
    fraction at prefill and chameleon's prefill on patch embeddings; and
    whisper-tiny at full width and depth, prefill on 1500 frames and a
    64-token prompt and 16 greedy decode steps. Returns the launches by path
    and the numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"checks": {}, "serve": {}}
    for arch in ("mixtral-8x22b", "grok-1-314b"):
        out["checks"][arch] = moe_f32_check(
            torch, api, moe_mod, get_config(arch).replace(n_layers=MOE_CHECK_LAYERS), dev)
    out["checks"]["chameleon-34b"] = model_check(
        torch, api, get_config("chameleon-34b").replace(n_layers=2), 2, FAMILY_PROMPT, dev,
        tag=10)
    whisper = get_config("whisper-tiny")
    out["checks"]["whisper-tiny"] = model_check(torch, api, whisper, 2, WHISPER_PROMPT, dev,
                                                embeds=True, tag=10)

    launches_by_path = {}

    def after(server, numbers):
        cfg, arch = server.cfg, server.cfg.name
        ptoks = server.prompts(list(range(SERVE_PER_NODE)))
        if cfg.is_moe:
            with torch.no_grad():
                _, aux, _ = transformer.forward_hidden(cfg, server.params, ptoks)
            numbers["prefill_moe"] = {k: v.item() for k, v in aux.items()}
            print(f"[10] {arch} MoE layers at prefill (B={SERVE_PER_NODE}, S={FAMILY_PROMPT}, "
                  f"one group of {min(cfg.moe_group_size, ptoks.numel())} tokens, capacity "
                  f"{moe_mod._capacity(cfg, min(cfg.moe_group_size, ptoks.numel()))} an "
                  f"expert): dropped_fraction {numbers['prefill_moe']['dropped']:.4f}, "
                  f"load-balance loss {numbers['prefill_moe']['moe_aux']:.4f}, router z "
                  f"{numbers['prefill_moe']['router_z']:.4f} (means over layers)")
        if cfg.frontend == "patch":
            embeds = stub_embeds(torch, cfg, SERVE_PER_NODE, FAMILY_PROMPT, dev)
            numbers["embeds"] = run = embeds_run(
                torch, api, cfg, server.params, ptoks, embeds, dev, counters,
                f"{arch} (patch embeds)")
            launches_by_path[f"{arch}/embeds"] = run["prefill_launches"]
            launches_by_path[f"{arch}/embeds-decode"] = run["decode_launches"]
        out["serve"][arch] = numbers

    models = [(get_config(arch).replace(n_layers=n), FAMILY_PROMPT) for arch, n in FAMILY_SERVE]
    for (arch, n), (cfg, _) in zip(FAMILY_SERVE, models):
        print(f"[10] {arch}: {n} of {get_config(arch).n_layers} layers at full width, "
              f"{cfg.total_params()} parameters ({cfg.total_params() * 2 / 2**30:.2f} GiB bf16)")
    launches_by_path.update(serve_phase(torch, P, PM, api, serve_mod, models, dev, counters,
                                        modes=("continuous",), tag=10, after=after))

    gc.collect()
    torch.cuda.empty_cache()
    cfg = whisper.replace(use_pallas=True)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    frames = stub_embeds(torch, cfg, WHISPER_B, WHISPER_PROMPT, dev)
    torch.cuda.reset_peak_memory_stats()
    run = embeds_run(torch, api, cfg, params, tokens, frames, dev, counters,
                     f"whisper-tiny full width and depth ({api.count_params(params)} params)")
    run["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["serve"]["whisper-tiny"] = run
    launches_by_path["whisper-tiny"] = run["prefill_launches"]
    launches_by_path["whisper-tiny/decode"] = run["decode_launches"]
    del params
    torch.cuda.empty_cache()
    out["launches_by_path"] = launches_by_path
    out["seconds"] = time.perf_counter() - t0
    print(f"[10] phase 10 took {out['seconds']:.1f} s")
    return out


# ---- training (phase 8) --------------------------------------------------
TRAIN_NODES, TRAIN_LEGION, TRAIN_STEPS, TRAIN_SEQ = 8, 4, 6, 1024
TRAIN_FAULTS = [(2, 1), (4, 5)]            # (step, node): 8 -> 7 -> 6 shards
TRAIN_REPAIR_STEPS = [2, 4]
TRAIN_SHARDS = [8, 8, 7, 7, 6, 6]
MAMBA_TRAIN_STEPS = 3
CHECK_B, CHECK_S = 2, 128                  # phases 8.2-8.3: the 2-layer cut's batch
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
    """Phases 8.2-8.3 on ``cfg`` cut to 2 layers at full width: train_loss and
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

    from repro_torch.models import common

    bf = cut.replace(dtype="bfloat16", param_dtype="bfloat16")
    backwards = common._LogitsF32.backwards
    loss16, grads16 = loss_and_grads(torch, api, bf, tree_map(lambda t: t.bfloat16(), on_card),
                                     card_batch)
    backwards = common._LogitsF32.backwards - backwards
    gn32, gn16 = global_norm_of(torch, grads32), global_norm_of(torch, grads16)
    dloss = abs(loss16.item() - loss32.item())
    ok = dloss <= BF16_LOSS_RTOL * abs(loss32.item()) and abs(gn16 - gn32) <= BF16_GNORM_RTOL * gn32
    print(f"[8] bf16 vs fp32 on the card: loss {loss16.item():.6f} vs {loss32.item():.6f} "
          f"(|d| {dloss:.3e}, limit {BF16_LOSS_RTOL:g} x |loss|); global grad norm "
          f"{gn16:.6f} vs {gn32:.6f} (rel {abs(gn16 - gn32) / gn32:.3e}, limit "
          f"{BF16_GNORM_RTOL:g}); the bf16 loss's logits through _LogitsF32: {backwards} "
          f"backwards {'ok' if ok and backwards else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 training loss or gradient norm is off the fp32 one")
    if not backwards:
        raise AssertionError("the bf16 loss on the card did not take the tensor-core logits")
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, bf16_dloss=dloss,
                bf16_gnorm_rel=abs(gn16 - gn32) / gn32)


# phase 8.0: one chunk of mixtral-train's loss (6 shards x 512 of a 2048
# chunk-4 sequence, d 6144, vocab 32768), bf16 drawn from a seed
LOGIT_B, LOGIT_C, LOGIT_D, LOGIT_V = 6, 512, 6144, 32768
# Against the SIMT fp32 GEMM of the upcast operands the tensor cores sum
# the same exact products less exactly: the logits' largest difference read
# 9.0e-6 of the largest logit (K 6,144), the fp32 dH 3.9e-5 (K 32,768) and
# dW 1.0e-5 (K 6,144) on an H100 (700 W). Limits ~10x (logits) and ~2.5x
# (dH) above; the gradient rounded once to bf16 reads ~2e-3 and must miss
# the gradients' limit.
LOGIT_RTOL, LOGIT_GRAD_RTOL = 1e-4, 1e-4
# lse, the NLL sum and the loss (read 1.3e-6): rows' sums of the above
LOGIT_LOSS_RTOL = 1e-5
# the split alone, both GEMMs SIMT fp32: 16 bits of the gradient. Read
# 3.0e-6: the one-hot entries are -1/3072 (rows), which bf16 cannot hold,
# and each keeps up to 2**-18 of itself off (at most 3.8e-6 in all); the
# CPU test's 1/256, which bf16 holds, reads 3.9e-7
LOGIT_SPLIT_RTOL = 1e-5
# the bf16 gradients through the loss (read 4.4e-4 and 2.4e-4): two
# roundings of fp32 values ~1e-5 apart differ by at most one bf16 step
# (2**-8 relative) an element
LOGIT_BF16_GRAD_RTOL = 2**-8


def logits_check(torch, dev) -> dict:
    """Phase 8.0: the loss's logit GEMMs at mixtral-train's chunk, the
    tensor-core path (``common._LogitsF32``) against the fp32 upcast on the
    same tensors: logits, lse, the chunk's NLL sum, the fp32 dH and dW from
    one logit gradient (and that gradient rounded once to bf16, which the
    limit must refuse; and the split alone, in SIMT fp32), then the loss
    forward and backward through ``cross_entropy_chunked`` both ways (the
    counters must move by two forwards and one backward on the new path
    only); the CUDA-event ms of a chunk's forward and backward both ways."""
    from repro_torch.models import common

    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((LOGIT_B, LOGIT_C, LOGIT_D), generator=gen, device=dev).bfloat16()
    w = (0.02 * torch.randn((LOGIT_V, LOGIT_D), generator=gen, device=dev)).bfloat16()
    y = torch.randint(0, LOGIT_V, (LOGIT_B, LOGIT_C), generator=gen, device=dev)
    h2d, rows = h.reshape(-1, LOGIT_D), torch.arange(LOGIT_B * LOGIT_C, device=dev)
    h32, w32 = h2d.float(), w.float()
    new = common._LogitsF32.apply(h2d, w)
    up = h32 @ w32.T

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def nll_sum(logits):
        lse = torch.logsumexp(logits, dim=-1)
        return lse, (lse - logits[rows, y.flatten()]).sum()

    lse_n, nll_n = nll_sum(new)
    lse_u, nll_u = nll_sum(up)
    out = dict(logits_rel=((new - up).abs().max() / up.abs().max()).item(),
               lse_rel=rel(lse_n, lse_u), nll_rel=abs(nll_n.item() - nll_u.item()) / nll_u.item())
    del new, lse_n, lse_u
    d = torch.softmax(up, dim=-1)
    del up
    d[rows, y.flatten()] -= 1.0
    d /= rows.numel()
    dh_u, dw_u = d @ w32, d.T @ h32
    dh_n, dw_n = common._logit_grads(d, h2d, w)
    out.update(dh_rel=rel(dh_n, dh_u), dw_rel=rel(dw_n, dw_u))
    dh_n, dw_n = common._logit_grads(d.bfloat16().float(), h2d, w)
    out.update(dh_rounded_once_rel=rel(dh_n, dh_u), dw_rounded_once_rel=rel(dw_n, dw_u))
    hi = d.bfloat16()
    split = hi.float() + (d - hi.float()).bfloat16().float()
    out.update(dh_split_rel=rel(split @ w32, dh_u), dw_split_rel=rel(split.T @ h32, dw_u))
    del dh_u, dw_u, dh_n, dw_n, hi, split

    def loss_grads():
        hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        loss, _ = common.cross_entropy_chunked(hh, ww, y, chunk=LOGIT_C, z_loss_weight=1e-4)
        loss.backward()
        return loss.detach(), hh.grad, ww.grad

    counts = (common._LogitsF32.forwards, common._LogitsF32.backwards)
    loss_n, gh_n, gw_n = loss_grads()
    moved = (common._LogitsF32.forwards - counts[0], common._LogitsF32.backwards - counts[1])
    pick = common._tensor_core_logits
    common._tensor_core_logits = lambda a, b: False
    try:
        counts = (common._LogitsF32.forwards, common._LogitsF32.backwards)
        loss_u, gh_u, gw_u = loss_grads()
        still = (common._LogitsF32.forwards - counts[0], common._LogitsF32.backwards - counts[1])
    finally:
        common._tensor_core_logits = pick
    out.update(loss_rel=abs(loss_n.item() - loss_u.item()) / loss_u.item(),
               gh_rel=rel(gh_n.float(), gh_u.float()), gw_rel=rel(gw_n.float(), gw_u.float()),
               counts_new=moved, counts_upcast=still)
    del gh_n, gw_n, gh_u, gw_u

    out["ms"] = dict(
        forward_new=time_ms(torch, lambda: common._LogitsF32.apply(h2d, w), runs=5, reps=4),
        forward_upcast=time_ms(torch, lambda: h2d.float() @ w.float().T, runs=5, reps=4),
        backward_new=time_ms(torch, lambda: [g.bfloat16() for g in
                                             common._logit_grads(d, h2d, w)], runs=5, reps=4),
        backward_upcast=time_ms(torch, lambda: ((d @ w32).bfloat16(), (d.T @ h32).bfloat16()),
                                runs=5, reps=4))
    ok = (out["logits_rel"] <= LOGIT_RTOL and max(out["lse_rel"], out["nll_rel"],
                                                  out["loss_rel"]) <= LOGIT_LOSS_RTOL
          and max(out["dh_rel"], out["dw_rel"]) <= LOGIT_GRAD_RTOL
          and min(out["dh_rounded_once_rel"], out["dw_rounded_once_rel"]) > LOGIT_GRAD_RTOL
          and max(out["dh_split_rel"], out["dw_split_rel"]) <= LOGIT_SPLIT_RTOL
          and max(out["gh_rel"], out["gw_rel"]) <= LOGIT_BF16_GRAD_RTOL
          and moved == (2, 1) and still == (0, 0))
    ms = out["ms"]
    print(f"[8] loss logits, {LOGIT_B} x {LOGIT_C} rows, d {LOGIT_D}, vocab {LOGIT_V}, bf16: "
          f"tensor-core path vs fp32 upcast: logits max |d| {out['logits_rel']:.2e} of max "
          f"(limit {LOGIT_RTOL:g}); lse {out['lse_rel']:.2e}, NLL sum {out['nll_rel']:.2e}, "
          f"loss {out['loss_rel']:.2e} (limit {LOGIT_LOSS_RTOL:g}); fp32 dH {out['dh_rel']:.2e}, "
          f"dW {out['dw_rel']:.2e} (limit {LOGIT_GRAD_RTOL:g}; the gradient rounded once to "
          f"bf16: {out['dh_rounded_once_rel']:.2e}, {out['dw_rounded_once_rel']:.2e}, must "
          f"exceed it; the split alone in SIMT fp32: {out['dh_split_rel']:.2e}, "
          f"{out['dw_split_rel']:.2e}, limit {LOGIT_SPLIT_RTOL:g}); bf16 grads through the "
          f"loss {out['gh_rel']:.2e}, {out['gw_rel']:.2e} (limit {LOGIT_BF16_GRAD_RTOL:g}); "
          f"forwards, backwards of _LogitsF32: {moved} (upcast run {still}) "
          f"{'ok' if ok else 'FAIL'}")
    print(f"[8] loss logits, one chunk, ms (CUDA events, median of 5 x 4): forward "
          f"{ms['forward_new']:.3f} vs upcast {ms['forward_upcast']:.3f}; backward (dH, dW, cast) "
          f"{ms['backward_new']:.3f} vs upcast {ms['backward_upcast']:.3f}")
    if not ok:
        raise AssertionError("the tensor-core logit GEMMs differ from the fp32 upcast")
    del h, w, y, h2d, d, h32, w32
    torch.cuda.empty_cache()
    return out


KNOB_LAYERS, KNOB_B, KNOB_S = 4, 2, 1024
KNOB_LOSS_RTOL, KNOB_GNORM_RTOL = 1e-5, 1e-4     # tests/test_perf_knobs.py's
KNOBS = (("remat=full", {}), ("remat=dots", {"remat": "dots"}), ("scan_block=2", {"scan_block": 2}))


# phase 8.1: the optimizer kernels on mixtral-train's leaves: mixtral-8x22b's
# widths at one layer with the experts cut from 8 to OPT_EXPERTS, so that the
# kernels' copy of the state and the eager copy fit on the card together
OPT_EXPERTS = 4
OPT_STEP = 7                      # the step the update is taken at (bias corrections < 1)
OPT_NORM_RTOL = 1e-6              # the norm against the eager float32 sum (another order)
OPT_LAUNCHES_A_STEP = 4           # 3 for the clip (sum of squares, norm, scale), 1 for AdamW


def optimizer_check(torch, api, dev) -> dict:
    """Phase 8.1: ``clip_by_global_norm_`` and ``adamw_update_`` through the
    kernels (``kernels/adamw.py``) against the eager code on a copy of the
    same leaves, in fp32 and bf16 moments, the clip engaged and not: the
    norm deterministic (the same bits twice) and within OPT_NORM_RTOL of the
    eager norm, the clipped gradients bit-equal to the eager clip at the
    kernel's norm, the moments and parameters after AdamW bit-equal to the
    eager update's, and the launches of each call counted. Then the
    CUDA-event ms of both ways and the kernels' share of their byte bound."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import adamw as opt_kernels
    from repro_torch.models.common import torch_dtype
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    _build.build(["adamw"])
    print(f"[8.1] built csrc/adamw.cu in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_summary(_build.build_logs.get("adamw", "")):
        print(f"[8.1] ptxas adamw: {line}")
    cfg = get_config("mixtral-8x22b").replace(n_layers=1, n_experts=OPT_EXPERTS)
    specs = api.param_specs(cfg)
    n_params = sum(math.prod(shape) for shape, _ in adamw.tree_leaves(specs))
    tc = TrainConfig()
    gen = torch.Generator(device=dev).manual_seed(81)
    bits = lambda t: t.reshape(-1).view(torch.uint8)   # noqa: E731
    counts = (opt_kernels.clip_by_global_norm_cuda, opt_kernels.adamw_update_cuda)

    def draw(scale, dtype=None, positive=False):
        def leaf(spec):
            shape, dt = spec
            fn = torch.rand if positive else torch.randn
            return fn(shape, generator=gen, device=dev, dtype=dtype or torch_dtype(dt)).mul_(scale)
        return adamw.tree_map(leaf, specs)

    def same(a_tree, b_tree):
        return all(torch.equal(bits(a), bits(b))
                   for a, b in zip(adamw.tree_leaves(a_tree), adamw.tree_leaves(b_tree)))

    def eager_clip(grads, scale):          # the clip kernels' plain version at a scale
        with torch.no_grad():
            for g in adamw.tree_leaves(grads):
                g.copy_((g.float() * scale).to(g.dtype))

    def eager_update(grads, state, params, lr):     # the AdamW kernel's plain version
        bc1, bc2 = adamw._bias_corrections(state.step + 1, tc)
        with torch.no_grad():
            for g, m, v, p in zip(*(adamw.tree_leaves(t) for t in (grads, state.mu, state.nu,
                                                                    params))):
                p.add_(adamw._leaf_update(g, m, v, p, tc, lr, bc1, bc2))

    cases, out = [], {}
    for state_dtype in ("float32", "bfloat16"):
        for max_norm in (1.0, 1e9):
            params = draw(0.02)
            grads = draw(4.0 / math.sqrt(n_params))        # a norm near 4
            mdt = getattr(torch, state_dtype)
            step = torch.tensor(OPT_STEP, dtype=torch.int32, device=dev)
            state = adamw.OptState(step, draw(1e-4, mdt), draw(1e-6, mdt, positive=True))
            copy = lambda tree: adamw.tree_map(torch.clone, tree)  # noqa: E731
            e_params, e_grads = copy(params), copy(grads)
            e_state = adamw.OptState(step, copy(state.mu), copy(state.nu))
            lr = adamw.cosine_schedule(tc)(step)
            before = [fn.launches for fn in counts]
            first = adamw.clip_by_global_norm_(grads, 1e30)     # scale 1: g untouched
            norm = adamw.clip_by_global_norm_(grads, max_norm)
            launches = [fn.launches - b for fn, b in zip(counts, before)]
            eager_norm = adamw.global_norm(e_grads)
            scale = adamw._clip_scale(norm, max_norm)
            eager_clip(e_grads, scale)
            clip_same = same(grads, e_grads)
            before = [fn.launches for fn in counts]
            adamw.adamw_update_(grads, state, params, tc, lr)
            launches.append(sum(fn.launches - b for fn, b in zip(counts, before)))
            eager_update(e_grads, e_state, e_params, lr)
            update_same = same(state.mu, e_state.mu) and same(state.nu, e_state.nu) \
                and same(params, e_params)
            rel = abs(norm.item() - eager_norm.item()) / eager_norm.item()
            case = dict(state_dtype=state_dtype, max_norm=max_norm, norm=norm.item(),
                        eager_norm=eager_norm.item(), norm_rel=rel, scale=scale.item(),
                        deterministic=bool(torch.equal(bits(first), bits(norm))),
                        clip_bit_equal=clip_same, adamw_bit_equal=update_same,
                        clip_launches=launches[0] // 2, adamw_launches=launches[2])
            want = (3, 1) if dev.type == "cuda" else (0, 0)    # the CPU runs the eager code
            ok = case["deterministic"] and rel <= OPT_NORM_RTOL and clip_same and update_same \
                and (case["clip_launches"], case["adamw_launches"]) == want
            print(f"[8.1] {cfg.name} ({n_params} params, {OPT_EXPERTS} of "
                  f"{get_config('mixtral-8x22b').n_experts} experts) moments {state_dtype}, "
                  f"max_norm {max_norm:g}: norm {norm.item():.9g} (eager {eager_norm.item():.9g}, "
                  f"rel {rel:.3e}, limit {OPT_NORM_RTOL:g}; the same bits twice: "
                  f"{case['deterministic']}), scale {scale.item():.9g} (clip "
                  f"{'engaged' if scale.item() < 1 else 'not engaged'}); clipped gradients "
                  f"bit-equal to the eager clip at this norm: {clip_same}; moments and params "
                  f"after AdamW bit-equal to the eager update: {update_same}; launches: clip "
                  f"{case['clip_launches']}, AdamW {case['adamw_launches']} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"phase 8.1: the optimizer kernels differ from the eager "
                                     f"optimizer: {case}")
            if (scale.item() < 1) != (max_norm == 1.0):
                raise AssertionError(f"phase 8.1: the clip was meant to be "
                                     f"{'engaged' if max_norm == 1.0 else 'idle'}: {case}")
            cases.append(case)
            if state_dtype == "float32" and max_norm == 1.0:
                # the byte bound: the norm reads g, the clip reads and writes it,
                # AdamW reads g, p, m, v and writes m, v, p
                leaves = [adamw.tree_leaves(t) for t in (grads, state.mu, state.nu, params)]
                clip_bytes = sum(3 * g.nbytes for g in leaves[0])
                adamw_bytes = sum(g.nbytes + 2 * (m.nbytes + v.nbytes + p.nbytes)
                                  for g, m, v, p in zip(*leaves))
                tiny = 1e-30          # every call scales g: the clip's writes always happen
                k_clip = time_ms(torch, lambda: adamw.clip_by_global_norm_(grads, tiny), 5, 3)
                k_adamw = time_ms(torch, lambda: adamw.adamw_update_(grads, state, params, tc,
                                                                     lr), 5, 3)
                e_clip = time_ms(torch, lambda: eager_clip(e_grads, adamw._clip_scale(
                    adamw.global_norm(e_grads), tiny)), 3, 1, warmup=1)
                e_adamw = time_ms(torch, lambda: eager_update(e_grads, e_state, e_params, lr),
                                  3, 1, warmup=1)
                bound = (clip_bytes + adamw_bytes) / PEAK_BYTES * 1e3
                out["timing"] = dict(
                    params=n_params, clip_bytes=clip_bytes,
                    adamw_bytes=adamw_bytes, kernel_clip_ms=k_clip, kernel_adamw_ms=k_adamw,
                    eager_clip_ms=e_clip, eager_adamw_ms=e_adamw, bound_ms=bound,
                    share=bound / (k_clip + k_adamw))
                print(f"[8.1] CUDA-event ms a step ({n_params} params): kernels "
                      f"clip {k_clip:.3f} + AdamW {k_adamw:.3f} = {k_clip + k_adamw:.3f} ms; "
                      f"eager clip {e_clip:.3f} + AdamW {e_adamw:.3f} = {e_clip + e_adamw:.3f} "
                      f"ms; bound {bound:.3f} ms ({clip_bytes + adamw_bytes} B at "
                      f"{PEAK_BYTES / 1e12:g} TB/s: clip {clip_bytes / PEAK_BYTES * 1e3:.3f}, "
                      f"AdamW {adamw_bytes / PEAK_BYTES * 1e3:.3f}), the kernels at "
                      f"{100 * out['timing']['share']:.1f}% of it")
            del params, grads, state, e_params, e_grads, e_state
            torch.cuda.empty_cache()
    out["cases"] = cases
    return out


def knob_checks(torch, api, cfg, dev) -> dict:
    """Phase 8.3: ``cfg`` (bf16, remat full) cut to KNOB_LAYERS layers at full
    width (4, so that ``scan_block=2`` makes two blocks), weights drawn on the
    card: the loss and gradient norm with ``remat="dots"`` and with
    ``scan_block=2`` against ``remat="full"``, each one's forward + backward
    ms and peak memory; and what the dots policy saves on this torch."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer

    cut = cfg.replace(n_layers=KNOB_LAYERS)
    params = api.init_params(cut, torch.Generator(device=dev).manual_seed(0), dev)
    batch = make_batch(0, 0, 0, batch=KNOB_B, seq_len=KNOB_S, vocab_size=cut.vocab_size,
                       device=dev)
    decisions = []
    policy = transformer._save_dots

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((str(op), decision == CheckpointPolicy.MUST_SAVE))
        return decision

    out = {}
    for label, kw in KNOBS:
        c = cut.replace(**kw)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        transformer._save_dots = spy
        try:
            loss, grads = loss_and_grads(torch, api, c, params, batch)
        finally:
            transformer._save_dots = policy
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        gnorm = global_norm_of(torch, grads)
        del grads
        step_ms = time_ms(torch, lambda: loss_and_grads(torch, api, c, params, batch), runs=3,
                          warmup=1)
        out[label] = dict(loss=loss.item(), grad_norm=gnorm, step_ms=step_ms, peak_bytes=peak,
                          peak_above_weights=peak - held)
    base = out["remat=full"]
    saved = [op for op, keep in decisions if keep]
    ok = set(saved) == {"aten.mm.default"} and len(saved) == 7 * KNOB_LAYERS
    for label, r in out.items():
        dl = abs(r["loss"] - base["loss"]) / abs(base["loss"])
        dg = abs(r["grad_norm"] - base["grad_norm"]) / base["grad_norm"]
        ok &= dl <= KNOB_LOSS_RTOL and dg <= KNOB_GNORM_RTOL
        print(f"[8] knob {label}: {cut.name} {KNOB_LAYERS} layers d={cut.d_model} bf16, "
              f"B={KNOB_B} S={KNOB_S}: loss {r['loss']:.6f} (rel {dl:.2e}, limit "
              f"{KNOB_LOSS_RTOL:g}), grad norm {r['grad_norm']:.6f} (rel {dg:.2e}, limit "
              f"{KNOB_GNORM_RTOL:g}); forward + backward {r['step_ms']:.3f} ms; peak memory "
              f"{r['peak_bytes']} B, {r['peak_above_weights']} B above what was allocated "
              f"before")
    print(f"[8] remat=dots on torch {torch.__version__}: the policy kept {len(saved)} outputs "
          f"({sorted(set(saved))}; 7 a layer expected: q, k, v, o and the MLP's three) and "
          f"recomputed {len(decisions) - len(saved)} ops {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a knob changed the loss or gradient norm, or remat=dots kept "
                             "other outputs than the matrix products")
    del params
    torch.cuda.empty_cache()
    return out


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


def train_run(torch, P, cfg, dev, *, steps, faults, counters, label, tag="8"):
    """``ResilientTrainer`` on ``VirtualCluster(TRAIN_NODES)`` (legions of
    TRAIN_LEGION, per-shard batch 1, sequence TRAIN_SEQ) for ``steps`` steps
    with every kernel's count zeroed just before and read just after. Returns
    (trainer, per-step records, launches, peak bytes)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import adamw as opt_kernels

    tc = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1))
    optimizer = (opt_kernels.clip_by_global_norm_cuda, opt_kernels.adamw_update_cuda)
    cluster = P.VirtualCluster(TRAIN_NODES, policy=P.LegioPolicy(legion_size=TRAIN_LEGION),
                               injector=P.FaultInjector.at(faults), device=dev)
    trainer = P.ResilientTrainer(cfg, tc, cluster, per_shard_batch=1, seq_len=TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    records = []
    for _ in range(steps):
        before = sum(fn.launches for fn in optimizer)
        t0 = time.perf_counter()
        r = trainer.run_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = r.active_shards * TRAIN_SEQ
        opt_launches = sum(fn.launches for fn in optimizer) - before
        records.append(dict(step=r.step, loss=r.loss, grad_norm=r.grad_norm,
                            shards=r.active_shards, wall_ms=wall * 1e3,
                            tokens_per_s=tokens / wall, repair=r.repair,
                            optimizer_launches=opt_launches))
        print(f"[{tag}] {label} step {r.step}: loss {r.loss:.6f} grad_norm {r.grad_norm:.4f} "
              f"shards {r.active_shards} wall_ms {wall * 1e3:.3f} (card synchronised) "
              f"tokens_per_s {tokens / wall:.1f} optimizer launches {opt_launches}"
              f"{' REPAIR ' + r.repair.summary() if r.repair else ''}")
        want = OPT_LAUNCHES_A_STEP if dev.type == "cuda" else 0
        if opt_launches != want:
            raise AssertionError(f"{label} step {r.step}: the optimizer launched "
                                 f"{opt_launches} kernels, not {want} on {dev.type}")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    return trainer, records, launches, torch.cuda.max_memory_allocated()


def train_phase(torch, P, api, cfgs, dev, counters) -> dict:
    """Phase 8: the resilient trainer. The loss's logit GEMMs at
    mixtral-train's chunk; card vs CPU and bf16 vs fp32 checks on the
    2-layer cut, the data digest, then full-width llama3.2-3b through
    TRAIN_FAULTS (the main path: every step once, repairs at 2 and 4, 8 -> 7
    -> 6 shards, finite losses, 4 optimizer launches a step and no other
    kernel launched) with a profiled
    fault-free step, then full-width mamba2-130m for MAMBA_TRAIN_STEPS."""
    import hashlib

    from repro_torch.data.pipeline import make_batch

    llama, mamba = cfgs
    base = torch.cuda.memory_allocated()
    logits = logits_check(torch, dev)
    optimizer = optimizer_check(torch, api, dev)
    torch.cuda.empty_cache()
    checks = train_checks(torch, api, llama, dev)
    torch.cuda.empty_cache()
    checks["knobs"] = knob_checks(torch, api, llama, dev)

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
    one_rank = run_numbers(torch, trainer, records)     # phase 12a's reference
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
                   launches=launches, one_rank=one_rank, logits=logits, optimizer=optimizer,
                   optimizer_launches=[r["optimizer_launches"] for r in records], **checks)
    del trainer             # its state getters hold it weakly: freed here, no gc.collect
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - base
    print(f"[8] {llama.name} trainer dropped: {held} B above the phase's start still held")
    if held > 2**31:
        raise AssertionError(f"a dropped trainer still holds {held} B")

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
    torch.cuda.empty_cache()
    return summary


# ---- the trainer over ranks (phase 12) ------------------------------------
# 12b: llama3.2-3b at full width cut to 6 of 28 layers (0.998 B parameters):
# four ranks on the one card each hold the whole state before the first
# repair (bf16 params 2.0 GB, fp32 moments 8.0 GB, gradients 2.0 GB, AdamW's
# fp32 temporaries on the embedding ~6 GB), which 28 layers would not fit
TR_LAYERS = 6
TR_REL_TOL = 2e-2                  # 12b loss and grad norm against one rank (bf16)
TR_MESH_RANKS = {2: [0, 1, 2, 3], 4: [0, 2, 3]}   # the survivors' ranks after each repair


def run_numbers(torch, trainer, records) -> dict:
    """What phase 12 holds a training run to: every step's loss, grad norm
    and shards, and the final params' fingerprints."""
    return dict(loss=[r["loss"] for r in records], grad_norm=[r["grad_norm"] for r in records],
                shards=[r["shards"] for r in records],
                fingerprints={".".join(path): fingerprint(torch, leaf)
                              for path, leaf in leaves_of(trainer.params)})


def step_lines(tag: str, label: str, records: list[dict]) -> None:
    """The step wall seconds and tokens/s at each shard count."""
    by_shards: dict[int, list] = {}
    for r in records:
        by_shards.setdefault(r["shards"], []).append(r)
    for shards, rs in sorted(by_shards.items(), reverse=True):
        print(f"[{tag}] {label}: {shards} shards ({shards * TRAIN_SEQ} tokens a step): step wall "
              f"s {[round(r['wall_ms'] / 1e3, 3) for r in rs]} (card synchronised), tokens/s "
              f"{[round(r['tokens_per_s'], 1) for r in rs]}")


def train_nccl1(torch, P, cfg, dev, counters, one=None) -> dict:
    """Phase 12a: phase 8's training run (``cfg`` at full width and depth
    through TRAIN_FAULTS) with the group that ``init_from_env("cuda")``
    starts, NCCL at world size 1, so the trainer takes its step over the
    group: every step's loss and grad norm, and the final params'
    fingerprints, bit-identical to the one-rank run ``one`` (phase 8's, or
    made here first and freed)."""
    if one is None:
        trainer, records, _, _ = train_run(
            torch, P, cfg, dev, steps=TRAIN_STEPS, faults=TRAIN_FAULTS, counters=counters,
            label=f"{cfg.name}, one rank, no group", tag="12a")
        one = run_numbers(torch, trainer, records)
        del trainer
        torch.cuda.empty_cache()
    with world1_group(dev) as backend:
        trainer, records, launches, peak = train_run(
            torch, P, cfg, dev, steps=TRAIN_STEPS, faults=TRAIN_FAULTS, counters=counters,
            label=f"{cfg.name}, {backend}, one rank", tag="12a")
        distributed = trainer.distributed
        group = run_numbers(torch, trainer, records)
        del trainer
    torch.cuda.empty_cache()
    step_lines("12a", f"{backend}, one rank", records)
    same = {k: group[k] == one[k] for k in ("loss", "grad_norm", "shards", "fingerprints")}
    print(f"[12a] {cfg.name} ({cfg.n_layers} layers) through the step over the group "
          f"({backend}, one rank): bit-identical to the one-rank run in {json.dumps(same)}; "
          f"shards {group['shards']}; kernel launches {json.dumps(launches)}; peak memory "
          f"{peak} B")
    if not distributed or not all(same.values()) or group["shards"] != TRAIN_SHARDS:
        raise AssertionError("phase 12a: the step over the group at world size 1 differs from "
                             "the one-rank step")
    if any(launches.values()):
        raise AssertionError(f"training launched a forward-only kernel: {launches}")
    return dict(backend=backend, launches=launches, peak_bytes=peak,
                step_s=[r["wall_ms"] / 1e3 for r in records],
                tokens_per_s=[r["tokens_per_s"] for r in records])


def train_worker(torch, dev, cfg, out_path: Path) -> dict:
    """Phase 12b on one rank of MR_WORLD (started by the parent with
    torchrun's variables, gloo named): ``cfg`` through TRAIN_FAULTS on 8
    nodes over the four ranks, with the assemble and the gradient all-reduce
    of each step timed (card synchronised); after each repair every leaf of
    params, mu and nu checked against its placement by ``param_specs`` on
    the survivors' mesh. Writes its record to ``out_path`` and returns it."""
    import torch.distributed as dist

    import repro_torch.core.trainer as trainer_mod
    from repro_torch import core as P
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist import init_from_env
    from repro_torch.dist.sharding import leaf_spec, placements
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models import api

    dev = init_from_env(dev.type, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    tag = f"[12b] gloo, four ranks on one card, rank {rank}"
    counters = {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda,
                "absmax": Q.absmax_cuda, "quantize_int8": Q.quantize_int8_cuda}
    seconds = {"assemble": [], "allreduce": []}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    trainer_mod.assemble_params = timed("assemble", trainer_mod.assemble_params)
    trainer_mod.allreduce_grads = timed("allreduce", trainer_mod.allreduce_grads)
    tc = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 10, 1))
    cluster = P.VirtualCluster(TRAIN_NODES, policy=P.LegioPolicy(legion_size=TRAIN_LEGION),
                               injector=P.FaultInjector.at(TRAIN_FAULTS), device=dev)
    trainer = P.ResilientTrainer(cfg, tc, cluster, per_shard_batch=1, seq_len=TRAIN_SEQ)
    plane = cluster.dataplane
    if not (trainer.distributed and plane.world == world and plane.rank == rank):
        raise AssertionError(f"{tag}: the trainer did not take the process group")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    steps = []
    for _ in range(TRAIN_STEPS):
        marks = {k: len(v) for k, v in seconds.items()}
        t0 = time.perf_counter()
        r = trainer.run_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = dict(step=r.step, loss=r.loss, grad_norm=r.grad_norm, shards=r.active_shards,
                   recompiled=r.recompiled, metrics=r.metrics,
                   repair=None if r.repair is None else re.sub(r"wall=\S+", "wall=*",
                                                               r.repair.summary()),
                   wall_ms=wall * 1e3, tokens_per_s=r.active_shards * TRAIN_SEQ / wall,
                   **{f"{k}_s": sum(v[marks[k]:]) for k, v in seconds.items()})
        if r.repair is not None:
            mesh = plane.mesh_for(cluster.topo.view())
            wrong, held = [], 0
            for name, tree in (("params", trainer.params), ("mu", trainer.opt.mu),
                               ("nu", trainer.opt.nu)):
                for path, leaf in leaves_of(tree):
                    want = placements(leaf_spec(path, tuple(leaf.shape), mesh), mesh)
                    if leaf.device_mesh != mesh or tuple(leaf.placements) != want:
                        wrong.append(f"{name}.{'.'.join(path)} {leaf.placements}")
                    local = leaf.to_local()
                    held += local.numel() * local.element_size()
            rec.update(placed_wrong=wrong, mesh_ranks=mesh.mesh.flatten().tolist(),
                       held_bytes=held)
        steps.append(rec)
        print(f"{tag} step {r.step}: loss {r.loss:.6f} grad_norm {r.grad_norm:.4f} shards "
              f"{r.active_shards} wall s {wall:.3f} assemble s {rec['assemble_s']:.3f} "
              f"gradient all-reduce s {rec['allreduce_s']:.3f}"
              f"{' REPAIR ' + rec['repair'] if r.repair else ''}", flush=True)
    record = dict(rank=rank, world=world, backend=dist.get_backend(), steps=steps,
                  launches=launches_of(torch, counters),
                  n_params=api.count_params(trainer.params),
                  reshards=[dict(leaves=x.leaves, n_devices=x.n_devices,
                                 moved_bytes=x.moved_bytes, wall_seconds=x.wall_seconds,
                                 mesh_shape=list(x.mesh_shape)) for x in cluster.reshards],
                  peak_bytes=torch.cuda.max_memory_allocated())
    del trainer
    dist.barrier()
    dist.destroy_process_group()
    out_path.write_text(json.dumps(record))
    return record


def train_ranks_check(records: list[dict], one: dict) -> dict:
    """Phase 12b's verdict over every rank's record, against the one-rank
    run's numbers ``one``. Returns the launches summed over the ranks."""
    label = "gloo, four ranks on one card"
    keys = ("step", "loss", "grad_norm", "shards", "recompiled", "repair", "metrics")
    first = [{k: s[k] for k in keys} for s in records[0]["steps"]]
    launches = {"flash_attention": 0, "ssd_scan": 0, "absmax": 0, "quantize_int8": 0}
    for rec in records:
        tag = f"[12b] {label}, rank {rec['rank']}"
        for s in rec["steps"]:
            if "mesh_ranks" in s:
                print(f"{tag} after the repair at step {s['step']}: mesh ranks "
                      f"{s['mesh_ranks']}, params + mu + nu held {s['held_bytes']} B, every leaf "
                      f"placed by param_specs {not s['placed_wrong']} {s['placed_wrong'][:3]}")
        print(f"{tag}: reshards {json.dumps(rec['reshards'])}; peak memory {rec['peak_bytes']} B; "
              f"kernel launches {json.dumps(rec['launches'])}")
        if [{k: s[k] for k in keys} for s in rec["steps"]] != first:
            raise AssertionError(f"{tag}: its TrainerReports differ from rank 0's")
        for s in rec["steps"]:
            if "mesh_ranks" in s and (s["placed_wrong"] or
                                      s["mesh_ranks"] != TR_MESH_RANKS.get(s["step"])):
                raise AssertionError(f"{tag} step {s['step']}: placed on {s['mesh_ranks']}, "
                                     f"wrong leaves {s['placed_wrong'][:5]}")
        if [r["mesh_shape"] for r in rec["reshards"]] != [[len(r), 1] for r in
                                                          TR_MESH_RANKS.values()]:
            raise AssertionError(f"{tag}: reshards {rec['reshards']}")
        for k in launches:
            launches[k] += rec["launches"][k]
    rank1 = next(s for s in records[1]["steps"] if s["step"] == TRAIN_REPAIR_STEPS[-1])
    print(f"[12b] {label}: rank 1 holds {rank1['held_bytes']} B of params, mu and nu after "
          f"step {rank1['step']}")
    steps = records[0]["steps"]
    for s in steps:
        print(f"[12b] {label}, step {s['step']}: assemble {s['assemble_s']:.3f} s, gradient "
              f"all-reduce {s['allreduce_s']:.3f} s (rank 0, card synchronised)")
    step_lines("12b", f"{label} (rank 0)", steps)
    rel = {k: max(abs(s[k] - w) / abs(w) for s, w in zip(steps, one[k]))
           for k in ("loss", "grad_norm")}
    ok = [s["shards"] for s in steps] == TRAIN_SHARDS == one["shards"] and \
        [s["step"] for s in steps if s["repair"]] == TRAIN_REPAIR_STEPS and \
        all(math.isfinite(s["loss"]) for s in steps) and \
        max(rel.values()) <= TR_REL_TOL and rank1["held_bytes"] == 0
    print(f"[12b] {label}: every rank's reports equal; shards {[s['shards'] for s in steps]}; "
          f"loss and grad norm against one rank, worst relative {json.dumps(rel)} (limit "
          f"{TR_REL_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok or any(launches.values()):
        raise AssertionError(f"phase 12b: the run over the ranks went wrong (launches {launches})")
    return launches


# 12b's MoE runs: mixtral-8x22b's and grok-1-314b's smoke configs in f32 on
# 8 nodes, three steps through one fault, in each routing case: name ->
# (per-shard batch, sequence, config fields). The smoke configs route in
# groups of 64 tokens; where a group spans shards on several ranks the
# trainer sums each layer's router logits over the ranks (models/moe.py).
MOE_RANK_ARCHS = ("mixtral-8x22b", "grok-1-314b")
MOE_RANK_FAULTS = [(1, 1)]
MOE_RANK_STEPS = 3
MOE_RANK_CASES = {
    "divides": (2, 32, {}),                     # a group is one shard's 2 x 32 tokens
    "spans": (1, 32, {}),                       # (a) each group spans two shards, two ranks
    "cuts": (1, 24, {}),                        # (b) groups cut shards; the last padded later
    "published": (1, 32, {"moe_group_size": 4096}),   # (c) one group of every live token
}
# each step's loss, grad norm, aux loss and router z against NCCL at world
# size 1, relative, and ``kept``, the count of kept expert choices behind the
# dropped fraction, in choices: in f32 within 1e-5, every choice the same
MOE_RANK_TOL = dict.fromkeys(("loss", "grad_norm", "moe_aux", "router_z"), 1e-5) | {"kept": 0}
# then the slice at full width: mixtral-8x22b cut to 1 of 56 layers in bf16
# at its published group (4096 tokens), 8 shards of 1 x 512 (one group spans
# all eight), three steps through fault (1, 1), on MOE_FULL_WORLD gloo ranks.
# Each rank holds whole bf16 params and gradients (5.8 GB each) besides its
# blocks of params and fp32 moments; four such ranks do not fit one card,
# nor two whose moments are whole, so each worker places the state on the
# ranks' mesh before the first step (reshard_registered of the full view).
MOE_FULL_ARCH = "mixtral-8x22b"
MOE_FULL_LAYERS = 1
MOE_FULL_SHARD = (1, 512)
MOE_FULL_WORLD = 2
# bf16: the ranks' hidden states differ from world size 1's in the last
# bits (GEMMs of another batch), so a choice near a tie may flip (of 8192
# choices a step)
MOE_FULL_TOL = {"loss": 1e-3, "grad_norm": 1e-3, "moe_aux": 4e-3, "router_z": 4e-3,
                "kept": 16}


def moe_rank_run(torch, P, cfg, dev, shard, *, place=False) -> dict:
    """``cfg`` through MOE_RANK_FAULTS for MOE_RANK_STEPS steps on 8 nodes
    on the process group this process holds, on shards of ``shard`` (per-
    shard batch, sequence); with ``place`` the state is placed on the
    ranks' mesh before the first step. Each step's record, and the peak
    memory."""
    from repro_torch.configs.base import TrainConfig

    batch, seq = shard
    cluster = P.VirtualCluster(TRAIN_NODES, policy=P.LegioPolicy(legion_size=TRAIN_LEGION),
                               injector=P.FaultInjector.at(MOE_RANK_FAULTS), device=dev)
    trainer = P.ResilientTrainer(cfg, TrainConfig(total_steps=MOE_RANK_STEPS, warmup_steps=1),
                                 cluster, per_shard_batch=batch, seq_len=seq)
    if place:
        cluster.dataplane.reshard_registered(cluster.topo.view())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(MOE_RANK_STEPS):
        t0 = time.perf_counter()
        r = trainer.run_step()
        torch.cuda.synchronize()
        # the dropped fraction is 1 - kept / choices over every layer's groups
        tokens = r.active_shards * batch * seq
        g = min(cfg.moe_group_size, tokens)
        choices = cfg.n_layers * -(-tokens // g) * g * cfg.experts_per_token
        steps.append(dict(step=r.step, loss=r.loss, grad_norm=r.grad_norm,
                          shards=r.active_shards, metrics=r.metrics,
                          kept=round((1.0 - r.metrics["dropped"]) * choices),
                          repair=None if r.repair is None else re.sub(r"wall=\S+", "wall=*",
                                                                      r.repair.summary()),
                          wall_s=time.perf_counter() - t0))
    out = dict(distributed=trainer.distributed, world=cluster.dataplane.world, steps=steps,
               peak_bytes=torch.cuda.max_memory_allocated())
    del trainer, cluster
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_smoke_cfg(arch: str, fields: dict):
    from repro_torch.configs.registry import get_smoke_config

    return get_smoke_config(arch).replace(dtype="float32", param_dtype="float32", **fields)


def moe_full_cfg():
    from repro_torch.configs.registry import get_config

    return get_config(MOE_FULL_ARCH).replace(n_layers=MOE_FULL_LAYERS)


def _moe_counters():
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    return {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda,
            "absmax": Q.absmax_cuda, "quantize_int8": Q.quantize_int8_cuda}


def moe_worker(torch, dev, out_path: Path, full: bool = False) -> dict:
    """One rank of 12b's MoE runs over gloo (started with torchrun's
    variables): every MOE_RANK_ARCHS x MOE_RANK_CASES run, or with ``full``
    the full-width run; writes the record to ``out_path``."""
    import torch.distributed as dist

    from repro_torch import core as P
    from repro_torch.dist import init_from_env

    dev = init_from_env(dev.type, backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    counters = _moe_counters()
    record = {"rank": rank}
    zero(counters)
    if full:
        runs = {"full": (moe_full_cfg(), MOE_FULL_SHARD,
                         f"{MOE_FULL_ARCH} {MOE_FULL_LAYERS} layer bf16")}
    else:
        runs = {f"{arch}/{case}": (moe_smoke_cfg(arch, fields), (batch, seq), "smoke f32")
                for arch in MOE_RANK_ARCHS
                for case, (batch, seq, fields) in MOE_RANK_CASES.items()}
    for key, (cfg, shard, label) in runs.items():
        record[key] = moe_rank_run(torch, P, cfg, dev, shard, place=full)
        for st in record[key]["steps"]:
            print(f"[12b] {key} {label}, gloo, rank {rank} of {world} step {st['step']}: loss "
                  f"{st['loss']:.7f} grad_norm {st['grad_norm']:.6f} shards {st['shards']} "
                  f"wall s {st['wall_s']:.3f}{' REPAIR ' + st['repair'] if st['repair'] else ''}",
                  flush=True)
    record["launches"] = launches_of(torch, counters)
    dist.barrier()
    dist.destroy_process_group()
    out_path.write_text(json.dumps(record))
    return record


def _moe_compare(key: str, records: list[dict], want: list[dict], world: int, tol: dict,
                 label: str) -> bool:
    """Every rank's shards and repairs equal to world size 1's and every
    rank's reports equal to rank 0's; each step's loss, grad norm, aux loss
    and router z within ``tol`` of world size 1's, relative, and its count
    of kept choices within ``tol["kept"]`` choices."""
    keys = ("step", "shards", "repair")
    worst = dict.fromkeys(tol, 0.0)

    def diff(g: dict, w: dict, k: str) -> float:
        if k == "kept":
            return abs(g[k] - w[k])
        g, w = (s[k] if k in ("loss", "grad_norm") else s["metrics"][k] for s in (g, w))
        return abs(g - w) / abs(w)

    ok = all(math.isfinite(w["loss"]) for w in want)
    first = [{k: v for k, v in s.items() if k != "wall_s"} for s in records[0][key]["steps"]]
    for rec in records:
        got = rec[key]["steps"]
        ok &= rec[key]["distributed"] and rec[key]["world"] == world
        ok &= [{k: v for k, v in s.items() if k != "wall_s"} for s in got] == first
        ok &= [{k: g[k] for k in keys} for g in got] == [{k: w[k] for k in keys} for w in want]
        for k in worst:
            worst[k] = max([worst[k]] + [diff(g, w, k) for g, w in zip(got, want)])
    ok &= all(worst[k] <= tol[k] for k in tol)
    print(f"[12b] {key} {label} over {world} gloo ranks vs world size 1: shards "
          f"{[w['shards'] for w in want]}, repairs at {[w['step'] for w in want if w['repair']]}; "
          f"losses {[w['loss'] for w in want]}; metrics at the last step "
          f"{json.dumps(want[-1]['metrics'])}; worst (relative, kept in choices) "
          f"{json.dumps(worst)} (limits "
          f"{json.dumps(tol)}) {'ok' if ok else 'FAIL'}; step wall s (rank 0) "
          f"{[round(st['wall_s'], 3) for st in records[0][key]['steps']]}; peak memory a rank "
          f"{[rec[key]['peak_bytes'] for rec in records]} B")
    return ok


def moe_ranks(torch, P, dev, counters) -> dict:
    """12b's MoE part: each MOE_RANK_ARCHS x MOE_RANK_CASES run with NCCL at
    world size 1 in this process, then over MR_WORLD gloo ranks
    (``--moe-worker``); then the full-width run at world size 1 here and
    over MOE_FULL_WORLD gloo ranks (``--moe-full-worker``). Every rank's
    shards, repairs and reports equal, its loss, grad norm, routing losses
    and kept choices within MOE_RANK_TOL (MOE_FULL_TOL at full width) of
    world size 1's. Returns
    the launches of each run by path (none: training runs the plain paths):
    world size 1's counted in this process, the gloo ranks' counted on each
    rank and summed."""
    with world1_group(dev) as backend:
        zero(counters)
        one = {f"{arch}/{case}": moe_rank_run(torch, P, moe_smoke_cfg(arch, fields), dev,
                                              (batch, seq))
               for arch in MOE_RANK_ARCHS for case, (batch, seq, fields) in MOE_RANK_CASES.items()}
        one["full"] = moe_rank_run(torch, P, moe_full_cfg(), dev, MOE_FULL_SHARD)
        one_launches = launches_of(torch, counters)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = moe_full_cfg()
    print(f"[12b] {MOE_FULL_ARCH} at full width, {MOE_FULL_LAYERS} of 56 layers, bf16, "
          f"group {cfg.moe_group_size}, 8 shards of {MOE_FULL_SHARD[0]} x {MOE_FULL_SHARD[1]}, "
          f"{backend} at world size 1: step wall s "
          f"{[round(st['wall_s'], 3) for st in one['full']['steps']]}, peak memory "
          f"{one['full']['peak_bytes']} B")
    records = run_ranks("--moe-worker", ROOT / "build" / "moe_ranks", "12b")
    full = run_ranks("--moe-full-worker", ROOT / "build" / "moe_full", "12b",
                     world=MOE_FULL_WORLD)
    launches = {name: sum(rec["launches"][name] for rec in records) for name in one_launches}
    full_launches = {name: sum(rec["launches"][name] for rec in full) for name in one_launches}
    print(f"[12b] MoE kernel launches: {backend} at world size 1 {json.dumps(one_launches)}; "
          f"{MR_WORLD} gloo ranks, summed {json.dumps(launches)}; {MOE_FULL_WORLD} gloo ranks "
          f"at full width, summed {json.dumps(full_launches)}")
    ok = True
    for key in one:
        if key != "full":
            ok &= _moe_compare(key, records, one[key]["steps"], MR_WORLD, MOE_RANK_TOL,
                               "smoke f32")
    ok &= _moe_compare("full", full, one["full"]["steps"], MOE_FULL_WORLD, MOE_FULL_TOL,
                       f"{MOE_FULL_ARCH} {MOE_FULL_LAYERS} layer bf16 group {cfg.moe_group_size}")
    if not ok or any(launches.values()) or any(one_launches.values()) or \
            any(full_launches.values()):
        raise AssertionError(f"phase 12b: the MoE runs over the ranks differ from world size 1 "
                             f"(launches {one_launches}, over the ranks {launches}, "
                             f"{full_launches})")
    return {"train:moe-nccl1": one_launches, f"train:moe-gloo{MR_WORLD}": launches,
            f"train:moe-gloo{MOE_FULL_WORLD}": full_launches}


def train_ranks_phase(torch, P, cfg, dev, counters, one=None) -> dict:
    """Phase 12: (a) ``train_nccl1`` in this process; (b) a one-rank run of
    ``cfg`` cut to TR_LAYERS layers on the card (freed after), then the same
    run over MR_WORLD ranks on the one card over gloo, each a process of
    this script with ``--train-worker``. A rank that fails or outlives
    MR_TIMEOUT_S fails the phase. Returns the launches by path."""
    t0 = time.perf_counter()
    a = train_nccl1(torch, P, cfg, dev, counters, one)
    cut = cfg.replace(n_layers=TR_LAYERS)
    trainer, records, _, peak = train_run(
        torch, P, cut, dev, steps=TRAIN_STEPS, faults=TRAIN_FAULTS, counters=counters,
        label=f"{cut.name} {TR_LAYERS} of {cfg.n_layers} layers, one rank", tag="12b")
    one_b = run_numbers(torch, trainer, records)
    del trainer
    torch.cuda.empty_cache()
    step_lines("12b", f"{TR_LAYERS} layers, one rank, no group (peak memory {peak} B)", records)
    b_launches = train_ranks_check(
        run_ranks("--train-worker", ROOT / "build" / "train_ranks", "12b"), one_b)
    moe_launches = moe_ranks(torch, P, dev, counters)
    print(f"[12] phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"train:nccl1": a["launches"], f"train:gloo{MR_WORLD}": b_launches, **moe_launches}


# ---- placement and the dry-run (phase 13) ---------------------------------
# (a) llama3.2-3b at full width and depth through launch/steps.py's three
# step kinds on the card; (b) the dry-run of the same cells on a (1, 1)
# mesh of a fake group of one; (c) the dry-run's production cells. The
# shapes fit 80 GB: the decode cache is 28 x 2 x 8 heads x 128 x 2 B a
# token, 30 GB at B = 8 and 32768 tokens.
DRY_ARCH = "llama3.2-3b"
DRY_CELLS = (("train", 8, 1024), ("prefill", 4, 4096), ("decode", 8, 32768))  # kind, B, S
DRY_PEAK_RATIO = (0.5, 2.0)     # the dry-run's peak over the card's, (b)
DRY_PRODUCTION = ("train_4k", "decode_32k")
# 13c: the decode cells DTensor once could not view (MoE routing, whisper's
# new K/V), (arch, multi_pod), at full depth
DRY_REPAIRED = (("mixtral-8x22b", True), ("grok-1-314b", True),
                ("whisper-tiny", False), ("whisper-tiny", True))
DRY_TIMEOUT_S = 900


def dry_cfg():
    from repro_torch.configs.registry import get_config

    return get_config(DRY_ARCH).replace(remat="full")


def dry_shapes():
    from repro_torch.configs.base import ShapeSpec

    return [ShapeSpec(f"card_{kind}", S, B, kind) for kind, B, S in DRY_CELLS]


def dryrun_worker(which: str, out_path: Path) -> None:
    """Phase 13b ("card": the three cells and the kernel roofline of the
    prefill cell), 13c ("production") or 13c's repaired cells ("repaired")
    in a process of its own, with no card: the dry-run's records, written to
    ``out_path``."""
    import logging

    from repro_torch.launch import dryrun, kernel_roofline
    from repro_torch.launch.mesh import make_named_mesh

    # DTensor notes each multi-step redistribution (thousands a cell)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    recs = {}
    if which == "card":
        dryrun.fake_group(1)
        mesh = make_named_mesh((1, 1), ("data", "model"), device="cpu")
        for shape in dry_shapes():
            # the prefill cell runs attributed: its record and its roofline
            # come from the one run (attribution leaves the totals as they are)
            prefill = shape.kind == "prefill"
            m = dryrun.dryrun_step(dry_cfg(), shape, mesh, attribute=prefill)
            recs[shape.kind] = {"argument_bytes": m["argument_bytes"],
                                "spec_bytes": m["spec_bytes"], "peak_bytes": m["peak_bytes"],
                                "flops": m["cost"].flops, "run_s": m["run_s"]}
            if prefill:
                recs["roofline"] = kernel_roofline.report(dry_cfg(), shape, mesh, step=m)
    elif which == "repaired":
        for arch, multi_pod in DRY_REPAIRED:
            rec = dryrun.run_cell(arch, "decode_32k", multi_pod=multi_pod, verbose=False)
            recs[f"{arch}/decode_32k/{'pod2' if multi_pod else 'pod1'}"] = rec
    else:
        for multi_pod in (False, True):
            for name in DRY_PRODUCTION:
                rec = dryrun.run_cell(DRY_ARCH, name, multi_pod=multi_pod, verbose=False)
                recs[f"{name}/{'pod2' if multi_pod else 'pod1'}"] = rec
    out_path.write_text(json.dumps(recs))


def materialize(torch, api, cfg, specs, dev, seed):
    """``specs``' stand-ins as tensors on the card: the params drawn by
    ``api.init_params`` (seed 0; every leaf must match its stand-in), the
    optimizer state zeros as ``adamw_init`` makes it, the rest drawn from a
    generator seeded ``seed`` (token ids in the vocabulary, bf16 normals)."""
    from repro_torch.launch import steps

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    for (path, leaf), (_, stand_in) in zip(leaves_of(params), leaves_of(specs["params"])):
        if leaf.shape != stand_in.shape or leaf.dtype != stand_in.dtype:
            raise AssertionError(f"13: params leaf {path} {leaf.shape} {leaf.dtype} is not "
                                 f"its stand-in's {stand_in.shape} {stand_in.dtype}")

    def draw(leaf):
        if isinstance(leaf, dict):
            return {k: draw(v) for k, v in leaf.items()}
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, leaf.shape, generator=gen, device=dev,
                                 dtype=torch.int32)
        return torch.randn(leaf.shape, generator=gen, device=dev, dtype=leaf.dtype)

    out = {"params": params}
    for k, v in specs.items():
        if k == "opt":
            out[k] = steps.adamw_init(params)
        elif k != "params":
            out[k] = draw(v)
    return out


def card_step(torch, fn, args, counters, label):
    """``fn(**args)`` once on the card, every count zeroed just before and
    read just after; (outputs, wall ms, the cell's peak bytes, launches).
    The peak is the allocator's high-water mark less what was held before
    that is not an input."""
    from repro_torch.launch import steps

    in_bytes = steps.argument_bytes(args)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - in_bytes
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    t0 = time.perf_counter()
    with torch.no_grad() if label != "train" else contextlib.nullcontext():
        out = fn(**args)
    launches = launches_of(torch, counters)
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - held
    return out, wall_ms, peak, in_bytes, launches


def decode_attention_check(torch, cfg, cache, dev) -> tuple[float, float]:
    """``decode_attention`` of a seeded bf16 query on layer 0's whole cache
    against the same attention written out in fp32 (the KV heads repeated
    to the query heads, one softmax over every slot); (max abs error,
    limit). The limit is DECODE_ATTN_ULPS bf16 units in the last place of
    the largest output: the kernel rounds its fp32 result to bf16 once."""
    from repro_torch.models.attention import decode_attention

    k, v = cache["k"][0], cache["v"][0]                  # (B, C, K, hd)
    B, C, K, hd = k.shape
    H = cfg.n_heads
    q = torch.randn((B, 1, H, hd), generator=torch.Generator(device=dev).manual_seed(16),
                    device=dev, dtype=k.dtype)
    with torch.no_grad():
        got = decode_attention(q, k, v, torch.ones((B, C), dtype=torch.bool, device=dev))
        scores = torch.einsum("bhd,bchd->bhc", q[:, 0].float() / math.sqrt(hd),
                              k.float().repeat_interleave(H // K, dim=2))
        want = torch.einsum("bhc,bchd->bhd", torch.softmax(scores, dim=-1),
                            v.float().repeat_interleave(H // K, dim=2))
        err = (got[:, 0].float() - want).abs().max().item()
        limit = DECODE_ATTN_ULPS * 2.0 ** -7 * want.abs().max().item()
    return err, limit


def card_cells(torch, api, dev, counters) -> dict:
    """13a: the three step kinds at full width on the card, each held to
    the port's existing path on the same inputs."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.trainer import make_train_step
    from repro_torch.launch import steps

    cfg = dry_cfg()
    train_s, prefill_s, decode_s = dry_shapes()
    tc = TrainConfig()
    out = {}

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    # train: steps.train_step against the trainer's step (grad scale 1), each
    # from the same weights and batch; the steps' step runs again last, warm
    # (the first step of the process pays the card's one-time set-up)
    specs = steps.input_specs(cfg, train_s)
    runs = {}
    for which in ("steps", "trainer", "steps (warm)"):
        args = materialize(torch, api, cfg, specs, dev, seed=13)
        if which.startswith("steps"):
            fn = steps.step_fn_for(cfg, train_s, tc)
        else:
            step = make_train_step(cfg, tc)
            fn = lambda params, opt, batch: step(params, opt, batch, 1.0)  # noqa: E731
        (params, opt, metrics), wall_ms, peak, in_bytes, launches = card_step(
            torch, fn, args, counters, "train")
        runs[which] = dict(loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(),
                           prints=[fingerprint(torch, t) for _, t in leaves_of(params)],
                           wall_ms=wall_ms, peak=peak, in_bytes=in_bytes, launches=launches)
        print(f"[13a] train {which} B={train_s.global_batch} S={train_s.seq_len} "
              f"{cfg.n_layers} layers remat={cfg.remat}: loss {runs[which]['loss']:.6f} "
              f"grad_norm {runs[which]['grad_norm']:.6f} wall_ms {wall_ms:.3f} peak {peak} B "
              f"inputs {in_bytes} B launches {launches}")
        del args, params, opt, metrics
        fresh()
    a, b, c = runs["steps"], runs["trainer"], runs["steps (warm)"]
    same = all(r[k] == b[k] for r in (a, c) for k in ("loss", "grad_norm", "prints"))
    print(f"[13a] train steps (twice) vs the trainer's step: loss, grad norm and every updated "
          f"parameter {'bit for bit' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("13a: launch/steps.py's train step differs from the trainer's")
    out["train"] = {k: v for k, v in c.items() if k != "prints"}
    out["train"]["first_wall_ms"] = a["wall_ms"]

    # prefill: with the kernels against without, each against the fp32 model
    specs = steps.input_specs(cfg, prefill_s)
    args = materialize(torch, api, cfg, specs, dev, seed=14)
    (lk, _), k_ms, k_peak, in_bytes, launches = card_step(
        torch, steps.step_fn_for(cfg.replace(use_pallas=True), prefill_s), args, counters,
        "prefill")
    fresh()
    (lp, _), p_ms, p_peak, _, plain_launches = card_step(
        torch, steps.step_fn_for(cfg, prefill_s), args, counters, "prefill")
    fresh()
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    with torch.no_grad():
        lf, _ = steps.step_fn_for(cfg32, prefill_s)(to_float(args["params"]), args["batch"])
    rms_kernel = (lk - lf).square().mean().sqrt().item()
    rms_plain = (lp - lf).square().mean().sqrt().item()
    print(f"[13a] prefill B={prefill_s.global_batch} S={prefill_s.seq_len}: kernels wall_ms "
          f"{k_ms:.3f} peak {k_peak} B launches {launches}; plain wall_ms {p_ms:.3f} peak "
          f"{p_peak} B; vs the fp32 model: kernels rms {rms_kernel:.3e}, plain rms "
          f"{rms_plain:.3e}, ratio {rms_kernel / rms_plain:.3f} (limit {MODEL_RMS_RATIO}); "
          f"kernels vs plain max {(lk - lp).abs().max().item():.3e}")
    if not (torch.isfinite(lk).all() and lk.shape == (prefill_s.global_batch, 1,
                                                       cfg.vocab_size)):
        raise AssertionError("13a: prefill logits are not finite or misshapen")
    if rms_kernel > MODEL_RMS_RATIO * rms_plain:
        raise AssertionError("13a: the steps prefill through the kernels is further from fp32 "
                             "than rounding explains")
    if launches["flash_attention"] != cfg.n_layers or any(
            n for name, n in launches.items() if name != "flash_attention") or any(
            plain_launches.values()):
        raise AssertionError(f"13a: steps prefill launches {launches} (plain {plain_launches}); "
                             f"flash must launch {cfg.n_layers} times, nothing else")
    out["prefill"] = dict(wall_ms=p_ms, peak=p_peak, in_bytes=in_bytes, kernel_wall_ms=k_ms,
                          kernel_peak=k_peak, launches=launches, rms_ratio=rms_kernel / rms_plain)
    del args, lk, lp, lf
    fresh()

    # decode: one token against a full cache; its logits finite and shaped,
    # and its attention at this cache (layer 0's, every slot valid, as the
    # step's mask is at this position) against a softmax over the whole
    # cache in fp32 written out here
    specs = steps.input_specs(cfg, decode_s)
    args = materialize(torch, api, cfg, specs, dev, seed=15)
    args["cache"]["pos"] = decode_s.seq_len - 1      # every slot but the last written
    (ls, _), d_ms, d_peak, in_bytes, launches = card_step(
        torch, steps.step_fn_for(cfg, decode_s), args, counters, "decode")
    attn_err, attn_limit = decode_attention_check(torch, cfg, args["cache"], dev)
    print(f"[13a] decode B={decode_s.global_batch} cache {decode_s.seq_len}: wall_ms {d_ms:.3f} "
          f"peak {d_peak} B inputs {in_bytes} B launches {launches}; logits "
          f"{tuple(ls.shape)}; decode_attention on layer 0's cache vs an fp32 softmax over it: "
          f"max_abs_err {attn_err:.3e} (limit {attn_limit:.3e})")
    if not (torch.isfinite(ls).all() and ls.shape == (decode_s.global_batch, 1,
                                                       cfg.vocab_size)):
        raise AssertionError("13a: decode logits are not finite or misshapen")
    if not attn_err <= attn_limit:
        raise AssertionError("13a: decode_attention at the full cache disagrees with the "
                             "fp32 softmax over it")
    out["decode"] = dict(wall_ms=d_ms, peak=d_peak, in_bytes=in_bytes, launches=launches,
                         attn_max_abs_err=attn_err)
    del args, ls
    fresh()
    return out


def dryrun_phase(torch, api, dev, counters) -> dict:
    """Phase 13: the dry-run's workers (13b, 13c) start first, on the host's
    cores, while 13a runs on the card; then each is checked."""
    out_dir = ROOT / "build" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    procs = {}
    for which in ("card", "production", "repaired"):
        log = open(out_dir / f"{which}.log", "w")
        procs[which] = (subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-worker", which,
             str(out_dir / f"{which}.json")], stdout=log, stderr=subprocess.STDOUT,
            cwd=str(ROOT)), log, time.perf_counter())
    try:
        card = card_cells(torch, api, dev, counters)
        done = {}
        for which, (p, log, t0) in procs.items():
            p.wait(timeout=DRY_TIMEOUT_S)
            done[which] = time.perf_counter() - t0
    finally:
        for p, log, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for which, (p, _, _) in procs.items():
        if p.returncode:
            print((out_dir / f"{which}.log").read_text()[-6000:])
            raise AssertionError(f"13: the {which} dry-run exited {p.returncode}")
    dry = json.loads((out_dir / "card.json").read_text())
    roof = dry.pop("roofline")
    for kind, rec in dry.items():
        cell = card[kind]
        ratio = rec["peak_bytes"] / cell["peak"]
        print(f"[13b] dry-run {kind} on a (1, 1) mesh ({rec['run_s']:.1f} s): argument bytes "
              f"{rec['argument_bytes']} (specs {rec['spec_bytes']}, card {cell['in_bytes']}); "
              f"peak estimate {rec['peak_bytes']} B vs the card's {cell['peak']} B: ratio "
              f"{ratio:.3f} (limits {DRY_PEAK_RATIO}); flops {rec['flops']:.4e}")
        if not rec["argument_bytes"] == rec["spec_bytes"] == cell["in_bytes"]:
            raise AssertionError(f"13b: {kind} argument bytes differ from the card's inputs")
        if not DRY_PEAK_RATIO[0] <= ratio <= DRY_PEAK_RATIO[1]:
            raise AssertionError(f"13b: {kind} peak estimate {ratio:.3f} of the card's")
        cell["dryrun"] = rec
    print(f"[13b] kernel roofline of the prefill cell (B={dry_shapes()[1].global_batch}, "
          f"S={dry_shapes()[1].seq_len}, (1, 1) mesh, {roof['chip']} datasheet, blocks "
          f"{roof['block_q']} x {roof['block_k']}; {roof['run_s']:.1f} s): attention-interior "
          f"bytes {roof['interior_bytes']:.6e} of {roof['total_bytes']:.6e} "
          f"({100 * roof['interior_share']:.2f}%); memory term blocked path "
          f"{roof['memory_blocked_s'] * 1e3:.3f} ms, flash kernel "
          f"{roof['memory_flash_s'] * 1e3:.3f} ms; compute {roof['compute_s'] * 1e3:.3f} ms; "
          f"measured on the card (13a): plain {card['prefill']['wall_ms']:.3f} ms, kernels "
          f"{card['prefill']['kernel_wall_ms']:.3f} ms")
    if not 0 < roof["interior_bytes"] < roof["total_bytes"]:
        raise AssertionError("13b: the attention-interior bytes are not within the step's")
    prod = json.loads((out_dir / "production.json").read_text())
    prod.update(json.loads((out_dir / "repaired.json").read_text()))
    print(f"[13c] the repaired decode cells ({', '.join(k for k in prod if '/decode_32k/' in k)}) "
          f"at full depth")
    for name, rec in prod.items():
        ma, terms = rec["memory_analysis"], rec["roofline"]
        print(f"[13c] {name} {rec['mesh']} ({rec['run_s']:.1f} s): argument bytes/dev "
              f"{ma['argument_bytes']} (specs {ma['spec_argument_bytes']}) peak/dev "
              f"{ma['peak_bytes_per_device']} flops/dev "
              f"{rec['cost_analysis']['flops_per_device']:.4e} bytes/dev "
              f"{rec['cost_analysis']['bytes_accessed_per_device']:.4e} wire/dev "
              f"{rec['collectives']['total_wire_bytes']} counts {rec['collectives']['counts']}; "
              f"roofline (H100 SXM datasheet) compute {terms['compute_s'] * 1e3:.3f} ms memory "
              f"{terms['memory_s'] * 1e3:.3f} ms collective {terms['collective_s'] * 1e3:.3f} ms "
              f"-> {terms['dominant']}; useful-FLOP ratio {rec['useful_flops_ratio']:.4f}")
        if ma["argument_bytes"] != ma["spec_argument_bytes"] or not rec["cost_analysis"][
                "flops_per_device"] > 0:
            raise AssertionError(f"13c: {name}: argument bytes differ from the specs' sum")
    print(f"[13] the dry-run workers took {done['card']:.1f} s, {done['production']:.1f} s and "
          f"{done['repaired']:.1f} s")
    return {"card": card, "production": prod, "roofline": roof}


# ---- the examples (phase 14) ---------------------------------------------
# each examples_torch/*.py on the card in a process of its own, at its
# reference's default arguments or the CI form its reference documents,
# EXAMPLE_PARALLEL at a time
MOE_CELLS = ("mixtral-8x22b-1l", "granite-4.0-h-small-10l")   # bench/configs/<name>.json
MOE_BATCH, MOE_PROMPT, MOE_DECODE = 8, 4096, 2   # the served cells' node batch and tokens
MOE_SEED = 1501


def moe_cell_cfg(name: str):
    """The served cell's configuration as the benchmark runs it."""
    from repro_torch.configs.base import ModelConfig

    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())["model"]
    return ModelConfig(**cfg).replace(use_pallas=True)


def bf16_ulps(torch, a, b) -> float:
    """The largest |a - b| in ulps of the larger of the two, element by element."""
    a, b = a.float(), b.float()
    top = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=1e-30))) - 7)
    return ((a - b).abs() / ulp).max().item()


@contextlib.contextmanager
def moe_recorded(moe_mod, ops, seen):
    """``seen[name] = (args, out)`` of each call of the eager path's
    ``_expert_ffn`` and the served path's ``ops.moe_gather``, ``ops.moe_combine``."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in
             ((moe_mod, "_expert_ffn"), (ops, "moe_gather"), (ops, "moe_combine"))]

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[name] = (args, out)
            return out
        return wrapped

    for owner, name, fn in saved:
        setattr(owner, name, wrap(name, fn))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextlib.contextmanager
def eager_moe(moe_mod):
    """The parent's path: ``moe_ffn`` takes ``_dispatch_combine`` under no_grad too."""
    saved = moe_mod._autograd_free
    moe_mod._autograd_free = lambda p, x: False
    try:
        yield
    finally:
        moe_mod._autograd_free = saved


def moe_layer_check(torch, cfg, dev) -> dict:
    """15a: one MoE layer at the node batch's prefill shape (8 x 4,096 tokens
    in groups of the config's size), routed by its router from seeded
    tokens; the eager path against the served path on the same route."""
    from repro_torch.kernels import moe_dispatch as kernels, ops
    from repro_torch.models import moe as moe_mod

    T, D, E, k = MOE_BATCH * MOE_PROMPT, cfg.d_model, cfg.n_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, T)
    n, C = T // g, moe_mod._capacity(cfg, g)
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    p = {name: v[0] for name, v in moe_mod.init_moe_params(cfg, 1, gen, dev,
                                                           torch.bfloat16).items()}
    x = torch.randn((T, D), generator=gen, device=dev).bfloat16()
    xg = x.reshape(n, g, D)
    with torch.no_grad():
        logits = (x.float() @ p["router"].float()).reshape(n, g, E)
        route = tuple(moe_mod._route_group(cfg, logits, C)[:4])
        group = torch.arange(n, device=dev)[:, None]
        eager = lambda: moe_mod._dispatch_combine(cfg, p, xg, route, C, group, n,  # noqa: E731
                                                  buffer_of=x)
        served = lambda: moe_mod._dispatch_combine_served(cfg, p, xg, route, C, T)  # noqa: E731
        seen = {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with moe_recorded(moe_mod, ops, seen):
            y_eager = eager().reshape(T, D)
        torch.cuda.synchronize()
        peak_eager = torch.cuda.max_memory_allocated() - base
        xe, ye = seen["_expert_ffn"][0][2], seen["_expert_ffn"][1]
        xe = xe.transpose(0, 1).reshape(-1, D)
        ye = ye.transpose(0, 1).reshape(-1, D)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launches = [kernels.moe_gather_cuda.launches, kernels.moe_combine_cuda.launches]
        with moe_recorded(moe_mod, ops, seen):
            y_served = served()
        torch.cuda.synchronize()
        peak_served = torch.cuda.max_memory_allocated() - base
        launches = [kernels.moe_gather_cuda.launches - launches[0],
                    kernels.moe_combine_cuda.launches - launches[1]]
        (x_flat, slot_token), buffer = seen["moe_gather"]
        (ye_served, rows, w), _ = seen["moe_combine"]
        out = dict(tokens=T, groups=n, capacity=C, rows=E * n * C,
                   gather_bit_equal_plain=torch.equal(
                       buffer, kernels.moe_gather_plain(x_flat, slot_token)),
                   buffer_bit_equal_eager=torch.equal(buffer, xe),
                   experts_bit_equal_eager=torch.equal(ye_served, ye),
                   combine_bit_equal_ordered=torch.equal(
                       y_served, kernels.moe_combine_ordered(ye_served, rows, w)),
                   combine_ulps_eager=bf16_ulps(torch, y_served, y_eager),
                   launches=launches, peak_eager=peak_eager, peak_served=peak_served,
                   dropped=1.0 - (rows >= 0).sum().item() / rows.numel())
        del xe, ye, y_eager, seen
        kept_rows = (slot_token >= 0).sum().item()
        kept = (rows >= 0).sum().item()
        # the bytes each kernel must move: the gather reads each kept choice's
        # token row and writes every row of the buffer (and reads its map);
        # the combine reads each kept choice's expert row and writes each token
        nb = x.element_size() * D
        gather_bytes = kept_rows * nb + E * n * C * nb + slot_token.numel() * 4
        combine_bytes = kept * nb + T * nb + rows.numel() * (4 + w.element_size())
        act = moe_mod.activation_fn(cfg.activation)
        gemms = lambda: torch.bmm(act(torch.bmm(buffer.view(E, n * C, D), p["we_gate"]))  # noqa: E731
                                  * torch.bmm(buffer.view(E, n * C, D), p["we_in"]),
                                  p["we_out"])
        t = dict(
            gather_ms=time_ms(torch, lambda: kernels.moe_gather_cuda(x_flat, slot_token), 5, 5),
            gather_plain_ms=time_ms(torch, lambda: kernels.moe_gather_plain(x_flat, slot_token),
                                    3, 1),
            combine_ms=time_ms(torch, lambda: kernels.moe_combine_cuda(ye_served, rows, w), 5, 5),
            combine_plain_ms=time_ms(torch, lambda: kernels.moe_combine_plain(ye_served, rows, w),
                                     3, 1),
            gemm_ms=time_ms(torch, gemms, 3, 1),
            eager_layer_ms=time_ms(torch, eager, 3, 1),
            served_layer_ms=time_ms(torch, served, 3, 1))
    t["gather_bound_ms"] = gather_bytes / PEAK_BYTES * 1e3
    t["combine_bound_ms"] = combine_bytes / PEAK_BYTES * 1e3
    t["gather_share"] = t["gather_bound_ms"] / t["gather_ms"]
    t["combine_share"] = t["combine_bound_ms"] / t["combine_ms"]
    out.update(t, gather_bytes=gather_bytes, combine_bytes=combine_bytes)
    print(f"[15a] {cfg.name}: {T} tokens in {n} groups of {g}, {E} experts top-{k}, capacity "
          f"{C}, buffer {E * n * C} x {D} ({E * n * C * nb} B), dropped {out['dropped']:.4f}")
    print(f"[15a] {cfg.name}: gather bit-equal to its plain version {out['gather_bit_equal_plain']}"
          f", buffer bit-equal to the eager path's (expert-major) "
          f"{out['buffer_bit_equal_eager']}, expert outputs bit-equal {out['experts_bit_equal_eager']}"
          f", combine bit-equal to the ordered fp32 sum {out['combine_bit_equal_ordered']}, "
          f"combine vs the eager einsum {out['combine_ulps_eager']:.3f} bf16 ulps; launches "
          f"gather {launches[0]}, combine {launches[1]}")
    print(f"[15a] {cfg.name}: CUDA-event ms: gather {t['gather_ms']:.4f} (bound "
          f"{t['gather_bound_ms']:.4f} ms for {gather_bytes} B at {PEAK_BYTES / 1e12:g} TB/s, "
          f"{100 * t['gather_share']:.1f}%; plain {t['gather_plain_ms']:.4f}); combine "
          f"{t['combine_ms']:.4f} (bound {t['combine_bound_ms']:.4f} ms for {combine_bytes} B, "
          f"{100 * t['combine_share']:.1f}%; plain {t['combine_plain_ms']:.4f}); the layer's "
          f"dispatch, experts and combine: eager {t['eager_layer_ms']:.3f}, served "
          f"{t['served_layer_ms']:.3f}, its three expert GEMMs alone {t['gemm_ms']:.3f}; "
          f"peak above the inputs: eager {peak_eager} B, served {peak_served} B")
    ok = (out["gather_bit_equal_plain"] and out["buffer_bit_equal_eager"]
          and out["experts_bit_equal_eager"] and out["combine_bit_equal_ordered"]
          and out["combine_ulps_eager"] <= 1.0 and launches == [1, 1])
    if not ok:
        raise AssertionError(f"phase 15a: {cfg.name}'s served MoE layer differs from the eager "
                             f"path: {out}")
    del p, x, xg, buffer, ye_served, y_served
    torch.cuda.empty_cache()
    return out


def moe_batch_check(torch, api, cfg, dev) -> dict:
    """15b: one node batch (8 prompts of 4,096, 2 generated tokens) of the
    whole served cell, the eager path (the parent's) and the served path on
    the same weights: the prefill and decode logits, the greedy tokens, the
    ms of each, the peak memory and the launches; one prefill of each path
    under the profiler."""
    from repro_torch.kernels import moe_dispatch as kernels
    from repro_torch.models import moe as moe_mod

    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    params = api.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), generator=gen,
                           device=dev)
    counts = (kernels.moe_gather_cuda, kernels.moe_combine_cuda)

    def run():
        with torch.no_grad():
            logits, cache = api.prefill(cfg, params, tokens, MOE_PROMPT + MOE_DECODE)
            steps, out = [logits[:, -1].float()], []
            for _ in range(MOE_DECODE):
                tok = logits[:, -1, :].argmax(dim=-1)[:, None]
                out.append(tok)
                logits, cache = api.decode_step(cfg, params, cache, tok)
                steps.append(logits[:, -1].float())
        return torch.cat(out, dim=1), steps

    def measured(label):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = [fn.launches for fn in counts]
        toks, steps = run()
        torch.cuda.synchronize()
        rec = dict(peak=torch.cuda.max_memory_allocated(), peak_above_weights=
                   torch.cuda.max_memory_allocated() - base,
                   launches=[fn.launches - b for fn, b in zip(counts, before)],
                   ms=time_ms(torch, run, 3, 1, warmup=1))
        busy, wall, top = profile_step(torch, lambda: api.prefill(cfg, params, tokens,
                                                                  MOE_PROMPT + MOE_DECODE))
        rec.update(prefill_busy_ms=busy, prefill_wall_ms=wall, prefill_top=top)
        print(f"[15b] {cfg.name} {label}: a node batch (prefill + {MOE_DECODE} decode steps) "
              f"{rec['ms']:.1f} ms, peak {rec['peak']} B ({rec['peak_above_weights']} B above "
              f"the weights), launches gather {rec['launches'][0]}, combine "
              f"{rec['launches'][1]}; one prefill under the profiler: busy {busy:.1f} ms of "
              f"{wall:.1f} ms; {top}")
        return toks, steps, rec

    with eager_moe(moe_mod):
        toks0, steps0, eager = measured("eager (the parent's path)")
    toks1, steps1, served = measured("served")
    rel = [((a - b).abs().max() / a.abs().max()).item() for a, b in zip(steps0, steps1)]
    want = [cfg.n_layers * (1 + MOE_DECODE)] * 2     # every layer's FFN is the MoE
    out = dict(eager=eager, served=served, tokens_equal=torch.equal(toks0, toks1),
               logits_rel=rel, want_launches=want)
    print(f"[15b] {cfg.name}: greedy tokens equal {out['tokens_equal']}; largest |logit "
          f"difference| over the largest logit, prefill / decode steps: "
          f"{' / '.join(f'{r:.3e}' for r in rel)}; peak eager {eager['peak']} B, served "
          f"{served['peak']} B; ms eager {eager['ms']:.1f}, served {served['ms']:.1f}")
    if not (out["tokens_equal"] and eager["launches"] == [0, 0]
            and served["launches"] == want and served["peak"] <= eager["peak"]):
        raise AssertionError(f"phase 15b: {cfg.name}'s served node batch differs from the "
                             f"eager path's: {out}")
    del params
    torch.cuda.empty_cache()
    return out


def moe_phase(torch, api, dev) -> dict:
    """Phase 15: the served MoE dispatch and combine kernels at both served
    MoE cells' shapes (15a a layer, 15b a node batch of the whole cell)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(["moe_dispatch"])
    print(f"[15] built csrc/moe_dispatch.cu in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_summary(_build.build_logs.get("moe_dispatch", "")):
        print(f"[15] ptxas moe_dispatch: {line}")
    out = {}
    for name in MOE_CELLS:
        cfg = moe_cell_cfg(name)
        out[name] = {"layer": moe_layer_check(torch, cfg, dev)}
        gc.collect()
        torch.cuda.empty_cache()
        out[name]["batch"] = moe_batch_check(torch, api, cfg, dev)
        gc.collect()
        torch.cuda.empty_cache()
    return out


EXAMPLE_ARGS = {
    "chaos_campaign": ["--preset", "rack_outage", "--preset", "transient_flap",
                       "--recovery", "substitute"],
    "resilient_training": ["--tiny"],
}
EXAMPLE_TIMEOUT_S = 300
EXAMPLE_PARALLEL = 3


def example_worker(torch, path: Path, out_path: Path, argv: list[str]) -> None:
    """One twin of phase 14 in this process: ``path`` run as a script with
    ``argv``, every kernel count zeroed just before; the counts are written
    to ``out_path`` when it ends, and its exit, or its exception, is this
    process's."""
    import runpy

    import repro_torch.models  # noqa: F401  (first: the kernel modules import it)
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    counters = {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda,
                "absmax": Q.absmax_cuda, "quantize_int8": Q.quantize_int8_cuda}
    sys.argv = [str(path), *argv]
    sys.path.insert(0, str(path.parent))
    zero(counters)
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out_path.write_text(json.dumps({name: fn.launches for name, fn in counters.items()}))


def examples_phase() -> dict:
    """Phase 14: every twin of ``examples/`` on the card (their default
    device), each in a process of its own (``--example-worker``, which
    counts the kernels' launches) with EXAMPLE_TIMEOUT_S; each must exit 0.
    Its log is in ``build/examples/``; the last lines, the wall seconds and
    the launches are printed. Returns {example: {exit, wall_s, launches}}."""
    out_dir = ROOT / "build" / "examples"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t_phase = time.perf_counter()
    pending = sorted((ROOT / "examples_torch").glob("*.py"))
    if len(pending) != 10:
        raise AssertionError(f"14: {len(pending)} examples under examples_torch/, not 10")
    running, results = {}, {}
    while pending or running:
        while pending and len(running) < EXAMPLE_PARALLEL:
            path = pending.pop(0)
            log = open(out_dir / f"{path.stem}.log", "w")
            argv = EXAMPLE_ARGS.get(path.stem, [])
            running[path.stem] = (subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--example-worker", str(path),
                 str(out_dir / f"{path.stem}.json"), *argv], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=str(ROOT)), log, time.perf_counter(), argv)
        for name, (p, log, t0, argv) in list(running.items()):
            wall = time.perf_counter() - t0
            if p.poll() is None and wall < EXAMPLE_TIMEOUT_S:
                continue
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
            counts = out_dir / f"{name}.json"
            launches = json.loads(counts.read_text()) if counts.exists() else None
            results[name] = {"exit": p.returncode, "wall_s": wall, "launches": launches}
            del running[name]
            tail = (out_dir / f"{name}.log").read_text().rstrip().splitlines()[-3:]
            command = " ".join([f"examples_torch/{name}.py", *argv])
            print(f"[14] {command}: exit {p.returncode}, wall s {wall:.1f}, kernel launches "
                  f"{json.dumps(launches)}"
                  f"{' (killed at the time limit)' if p.returncode < 0 else ''}")
            for line in tail:
                print(f"[14]   {line}")
        time.sleep(0.2)
    print(f"[14] {len(results)} examples, {EXAMPLE_PARALLEL} at a time, took "
          f"{time.perf_counter() - t_phase:.1f} s")
    failed = sorted(name for name, r in results.items() if r["exit"] != 0 or r["launches"] is None)
    if failed:
        raise AssertionError(f"14: examples failed: {failed}")
    return results


def main(argv: list[str]) -> int:
    import torch

    kernels_only = "--kernels-only" in argv  # phases 1-3 for flash and SSD, then stop
    train_only = "--train-only" in argv      # phases 1 and 8, then stop
    serve_only = "--serve-only" in argv      # phases 1-2, 5-6 and 9, then stop
    families_only = "--families-only" in argv  # phases 1-2, 3's family shapes, 10
    multirank_only = "--multirank-only" in argv  # phases 1, 11 and 12
    dryrun_only = "--dryrun-only" in argv    # phases 1, 2 (flash only) and 13
    examples_only = "--examples-only" in argv  # phases 1, 2 (flash only) and 14
    moe_only = "--moe-only" in argv          # phases 1 and 15

    if "--dryrun-worker" in argv:      # phase 13b or 13c, started by phase 13; no card
        i = argv.index("--dryrun-worker")
        dryrun_worker(argv[i + 1], Path(argv[i + 2]))
        return 0
    if "--example-worker" in argv:     # one twin of phase 14, started by phase 14
        i = argv.index("--example-worker")
        example_worker(torch, Path(argv[i + 1]), Path(argv[i + 2]), argv[i + 3:])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if "--multirank-worker" in argv:   # one rank of phase 11b, started by phase 11
        from repro_torch.configs.registry import get_config

        out_dir = Path(argv[argv.index("--multirank-worker") + 1])
        multirank_worker(torch, torch.device("cuda"), get_config(MR_ARCH), MR_ELEMS,
                         out_dir / f"rank{os.environ['RANK']}.json")
        return 0
    for flag in ("--moe-worker", "--moe-full-worker"):    # one rank of 12b's MoE runs
        if flag in argv:
            moe_worker(torch, torch.device("cuda"),
                       Path(argv[argv.index(flag) + 1]) / f"rank{os.environ['RANK']}.json",
                       full=flag == "--moe-full-worker")
            return 0
    if "--train-worker" in argv:       # one rank of phase 12b, started by phase 12
        from repro_torch.configs.registry import get_config

        out_dir = Path(argv[argv.index("--train-worker") + 1])
        train_worker(torch, torch.device("cuda"), get_config(MR_ARCH).replace(n_layers=TR_LAYERS),
                     out_dir / f"rank{os.environ['RANK']}.json")
        return 0

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
    if multirank_only:
        lib_paths = _build.build(["quantize", "adamw"])
        print(f"[2] built {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)}")
        mr_launches = multirank_phase(torch, rt_core, rt_mpi, dev, counters)
        gc.collect()
        torch.cuda.empty_cache()
        mr_launches.update(train_ranks_phase(torch, rt_core, train_cfgs[0], dev, counters))
        print(json.dumps({"multirank_only": mr_launches}))
        return 0
    if examples_only:
        lib_paths = _build.build(["flash_attention"])
        print(f"[2] built {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)}")
        print(json.dumps({"examples_only": examples_phase()}))
        return 0
    if dryrun_only:
        lib_paths = _build.build(["flash_attention"])
        print(f"[2] built {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)}")
        dry = dryrun_phase(torch, api, dev, counters)
        print(json.dumps({"dryrun_only": dry}, default=str))
        return 0
    if train_only:
        train = train_phase(torch, rt_core, api, train_cfgs, dev, counters)
        print(json.dumps({"train_only": train}, default=str))
        return 0
    if moe_only:
        print(json.dumps({"moe_only": moe_phase(torch, api, dev)}, default=str))
        return 0

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_paths = _build.build(["flash_attention", "ssd_scan", "quantize", "adamw",
                              "moe_dispatch"])
    print(f"[2] built {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)} "
          f"in {time.perf_counter() - t0:.2f} s")
    for name, log in sorted(_build.build_logs.items()):
        for line in ptxas_summary(log):
            print(f"[2] ptxas {name}: {line}")
    serve_models = [(get_config(arch), prompt_len) for arch, prompt_len in SERVE_MODELS]
    if serve_only and not families_only:
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

    def flash_path(label, B, Sq, H, K, hd, window=0, *, Sk=None, causal=True, softcap=0.0):
        """Check and time the flash kernel at a serving path's shape (bf16),
        with one ``scaled_dot_product_attention`` call beside it where SDPA
        computes the same function (it has no softcap)."""
        Sk = Sq if Sk is None else Sk
        q, k, v = qkv(B, Sq, Sk, H, K, hd, "bfloat16")
        kw = dict(causal=causal, window=window, logit_softcap=softcap)
        out = flash_attention_cuda(q, k, v, **kw)
        err = check(f"path_shape_{label}", "bfloat16", out, flash_attention_plain(q, k, v, **kw))
        kernel_ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw), runs=20, reps=20)
        plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw), runs=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = None   # SDPA has no softcap: no library call computes a softcapped score
        if not softcap and 0 < window < Sk:  # the window as a boolean mask (True = attend)
            ones = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
            mask = ones.tril() & ~ones.tril(-window)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
        elif not softcap:   # a window at least as long as the keys never clips
            lib = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
        library_ms = lib_err = None
        if lib is not None:
            library_ms = time_ms(torch, lib, runs=20, reps=20)
            lib_err = (lib().transpose(1, 2).float() - out.float()).abs().max().item()
        flops = 4 * hd * live_pairs(Sq, Sk, causal, window, 0) * B * H
        if softcap:   # tanh and two scalings a score, at the fp32 CUDA-core rate
            op_s = flops / PEAK_BF16_FLOPS + 3 * live_pairs(Sq, Sk, causal, window, 0) * B * H \
                / PEAK_FP32_FLOPS
        else:
            op_s = flops / PEAK_BF16_FLOPS
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
        bound_ms, bound_by = bound(op_s, nbytes)
        kernel = kernel_for(q.dtype, hd)
        shape = (f"{label}: B={B} Sq={Sq} Sk={Sk} H={H} K={K} hd={hd} bf16 "
                 f"{'causal' if causal else 'non-causal'} window={window} softcap={softcap:g}")
        lib_text = ("none (SDPA has no softcap)" if lib is None else
                    f"{library_ms:.4f} (kernel/library {kernel_ms / library_ms:.3f}; "
                    f"sdpa_vs_kernel_max_abs {lib_err:.3e})")
        print(f"[3] flash path shape {shape} ({kernel} kernel): kernel_ms {kernel_ms:.4f} "
              f"plain_ms {plain_ms:.4f} library_ms {lib_text} bound_ms {bound_ms:.4f} "
              f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) share of bound "
              f"{bound_ms / kernel_ms:.3f} kernel TFLOP/s {flops / kernel_ms / 1e9:.1f}")
        return dict(shape=shape, kernel=kernel, max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / kernel_ms,
                    library_ms=library_ms)

    # the other families' serve shapes (phase 10): mixtral's 4096 window
    # never clips its 1024-token prompts; whisper's 1500 frames end in a
    # ragged 128-key tile
    family_shapes = [
        flash_path("mixtral-8x22b", 4, 1024, 48, 8, 128, 4096),
        flash_path("grok-1-314b", 4, 1024, 48, 8, 128, softcap=30.0),
        flash_path("chameleon-34b", 4, 1024, 64, 8, 128),
        flash_path("whisper-tiny/encoder", 4, 1500, 6, 6, 64, causal=False),
        flash_path("whisper-tiny/cross", 4, 64, 6, 6, 64, Sk=1500, causal=False),
    ]
    if families_only:
        families = families_phase(torch, rt_core, rt_mpi, api, serve_mod, dev, counters)
        print(json.dumps({"families_only": {"flash_attention": family_shapes,
                                            "families": families}}, default=str))
        return 0
    flash_shapes = [flash_path("llama3.2-3b", 4, 1024, 24, 8, 128),
                    flash_path("hymba-1.5b", 4, 2048, 25, 5, 64, 1024)] + family_shapes

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
    model_check(torch, api, get_config("llama3.2-3b").replace(n_layers=2), 2, 1024, dev)
    model_check(torch, api, get_config("hymba-1.5b").replace(n_layers=2), 2, 2048, dev)
    model_check(torch, api, get_config("mamba2-130m"), 2, 2048, dev)

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

    # ---- 10. the other families ------------------------------------------
    families = families_phase(torch, rt_core, rt_mpi, api, serve_mod, dev, counters)
    launches_by_path.update(families.pop("launches_by_path"))
    print(json.dumps({"families": families}, default=str))

    # ---- 11. the multi-rank runtime ------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    path_launches = dict(train_launches)
    path_launches.update(multirank_phase(torch, rt_core, rt_mpi, dev, counters))

    # ---- 12. the trainer over ranks -------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    path_launches.update(train_ranks_phase(torch, rt_core, train_cfgs[0], dev, counters,
                                           one=train["one_rank"]))

    # ---- 13. placement and the dry-run -----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun_phase(torch, api, dev, counters)
    path_launches.update({f"steps:{kind}": cell["launches"]
                          for kind, cell in dry["card"].items()})
    print(json.dumps({"dryrun": dry}, default=str))

    # ---- 14. the examples ------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    examples = examples_phase()
    path_launches.update({f"examples:{name}": r["launches"] for name, r in examples.items()})
    print(json.dumps({"examples": examples}))

    # ---- 15. the served MoE dispatch and combine ---------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"moe_dispatch": moe_phase(torch, api, dev)}, default=str))

    def entry(name, replaces, shapes):
        """One kernel's record at the serve path (hymba-1.5b, continuous): its
        shape, its launches; every measured shape under ``shapes`` and every
        serve run's launches under ``launches_by_path``, the train runs' (0)
        too."""
        by_path = {arch: launches[name] for arch, launches in launches_by_path.items()}
        by_path.update({path: launches[name] for path, launches in path_launches.items()})
        main = next(x for x in shapes if x["shape"].startswith("hymba-1.5b"))
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": replaces,
                "launches": by_path["hymba-1.5b"], "launches_by_path": by_path,
                **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "bound_share")},
                "shape": main["shape"], "shapes": shapes}

    def quant_entry(name, replaces):
        """One compression-hop kernel's record: the runtime phase's launches
        (and the train runs', 0, and phase 11's), the path shape's numbers."""
        by_path = {"runtime": rt_launches[name],
                   **{path: launches[name] for path, launches in path_launches.items()}}
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
