"""The yardstick's peaks and the kernels' work, frozen with the benchmark.

Peaks are NVIDIA's H100 SXM datasheet figures (dense, no sparsity) at the
card's full 700 W; a run prints the card's own power limit beside them.
The work of a call is what its inputs need, whatever implements it: every
input byte read once, every output byte written once, and the (query, key)
pairs the mask lets through. ``live_pairs``, ``ssd_flops`` and ``bound``
are copies of the same functions in ``chip_smoke.py``.
"""
from __future__ import annotations

import subprocess

PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak
PEAK_TF32_FLOPS = 495e12   # dense tf32 tensor-core peak
PEAK_FP32_FLOPS = 67e12    # fp32 on the CUDA cores
PEAK_BYTES = 3.35e12       # HBM3


def card_line() -> str:
    """``name, power limit`` of the card as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unreadable ({type(e).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi printed nothing"


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
    """The larger of the operations' time at their peaks and the bytes' time, in ms."""
    t_bytes = nbytes / PEAK_BYTES
    return max(op_seconds, t_bytes) * 1e3, ("operations" if op_seconds >= t_bytes else "bytes")


def _nbytes(shape, itemsize: int) -> int:
    n = itemsize
    for d in shape:
        n *= d
    return n


def flash_call_ms(call: dict) -> float:
    """Bound ms of one ``flash_attention`` call: q (B,Sq,H,hd), k and v
    (B,Sk,K,hd) read, o (B,Sq,H,hd) written; QK^T and PV over the live
    pairs at the bf16 peak (a softcap's tanh at the fp32 rate)."""
    B, Sq, H, hd = call["q"]
    Sk, K = call["k"][1], call["k"][2]
    pairs = live_pairs(Sq, Sk, call["causal"], call["window"], call["q_offset"])
    flops = 4 * hd * pairs * B * H
    op_s = flops / PEAK_BF16_FLOPS
    if call.get("softcap", 0.0) > 0.0:
        op_s += 3 * pairs * B * H / PEAK_FP32_FLOPS
    item = call["itemsize"]
    nbytes = 2 * _nbytes(call["q"], item) + 2 * _nbytes((B, Sk, K, hd), item)
    return bound(op_s, nbytes)[0]


def ssd_call_ms(call: dict) -> float:
    """Bound ms of one ``ssd_scan`` call: x (B,S,H,P), dt (B,S,H) fp32, A
    (H,) fp32, B and C (B,S,G,N) read, the initial state (B,H,P,N) fp32
    read if given; y (B,S,H,P) and the final state written. C.B^T once per
    group at the bf16 peak (two operands in x's dtype), the products with an
    fp32 operand at the tf32 peak; fp32 inputs price every product as three
    tf32 products."""
    B, S, H, P = call["x"]
    G, N = call["bm"][2], call["bm"][3]
    cb, rest = ssd_flops(B, S, H, P, N, call["chunk"], call["has_h0"])
    cb_needed = cb * G // H
    item = call["itemsize"]
    if item == 2:
        op_s = cb_needed / PEAK_BF16_FLOPS + rest / PEAK_TF32_FLOPS
    else:
        op_s = 3 * (cb_needed + rest) / PEAK_TF32_FLOPS
    state = _nbytes((B, H, P, N), 4)
    nbytes = (2 * _nbytes((B, S, H, P), item) + _nbytes((B, S, H), 4) + 4 * H
              + 2 * _nbytes((B, S, G, N), item) + state * (2 if call["has_h0"] else 1))
    return bound(op_s, nbytes)[0]
