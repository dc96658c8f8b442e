"""The served MoE dispatch and combine: the hand-written Hopper kernels' wrappers and their plain versions.

The served path of ``models/moe.py`` builds each layer's expert buffer
expert-major, ``(E, m*C, D)`` for ``m`` groups of capacity ``C``: row
``e*m*C + group*C + slot`` holds the token that took that slot of expert
``e`` in its group, or zeros where no kept choice landed. The expert GEMMs
read it in place (``torch.bmm`` against ``(E, D, F)`` weights), and the
combine reads their ``(E, m*C, D)`` output straight back:

  * ``expert_major_rows`` turns the routing (expert, slot, keep) into the
    two maps both kernels take: each choice's row of the buffer (-1 where
    the choice was dropped) and each row's token (-1 where the row stays
    zero), both int32, with torch ops on the tensors' device;
  * ``moe_gather``: ``out[row] = x[slot_token[row]]``, or zeros;
  * ``moe_combine``: ``y[t] = sum_j w[t, j] * ye[rows[t, j]]`` over the
    kept choices, products and sum in fp32 in choice order, rounded once
    to the dtype of ``ye``.

``moe_gather_cuda`` and ``moe_combine_cuda`` launch ``csrc/moe_dispatch.cu``
(built with ``nvcc`` at first use, see ``_build``) on the current CUDA
stream; each checks its inputs, allocates its output, raises if the launch
was refused, and counts the launch in its ``launches``. They take bfloat16
or float32 rows. ``moe_gather_plain`` and ``moe_combine_plain`` compute the
same functions in PyTorch ops: the CPU path, and on the card the oracle the
kernels are held against. The plain combine is the eager path's own gather
and ``einsum``; the kernel sums in a fixed order where cuBLAS's batched
GEMV chooses its own, so on the card the two agree within a bf16 ulp, and
the kernel is bit-equal to ``moe_combine_ordered``, its order in torch ops.

No TPU kernel is replaced: the JAX package leaves its MoE dispatch and
combine to XLA. Both kernels are bounded by bytes (csrc/moe_dispatch.cu).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def expert_major_rows(expert_idx: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                      capacity: int, n_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The maps of the expert-major buffer of ``m`` groups. ``expert_idx``,
    ``slot``, ``keep``: (m, g, k), the routing of group ``i``'s ``g`` tokens
    (token ``i*g + t`` of the flattened groups). Returns ``rows`` (m, g, k)
    int32, each choice's row of the (E*m*C, D) buffer or -1 where it was
    dropped, and ``slot_token`` (E*m*C,) int32, each row's token or -1. A
    kept choice's slot is below ``capacity``, so no two share a row."""
    m, g, k = keep.shape
    n_rows = n_experts * m * capacity
    group = torch.arange(m, device=keep.device)[:, None, None]
    at = expert_idx * (m * capacity) + group * capacity + slot
    # dropped choices all land on one sink entry past the end, cut off below
    sink = torch.where(keep, at, n_rows).reshape(-1)
    token = torch.arange(m * g, dtype=torch.int32, device=keep.device)
    slot_token = torch.full((n_rows + 1,), -1, dtype=torch.int32, device=keep.device)
    slot_token.scatter_(0, sink, token[:, None].expand(m * g, k).reshape(-1))
    return torch.where(keep, at, -1).to(torch.int32), slot_token[:n_rows]


def _check_maps(index: torch.Tensor, rows: torch.Tensor, what: str) -> None:
    if index.dtype != torch.int32 or index.device != rows.device:
        raise ValueError(f"{what} must be int32 on {rows.device}, got {index.dtype} "
                         f"on {index.device}")


def check_gather(x: torch.Tensor, slot_token: torch.Tensor) -> None:
    """Raise on arguments ``moe_gather`` does not take: ``x`` not (N, D),
    ``slot_token`` not a 1-d int32 tensor on x's device."""
    if x.ndim != 2 or slot_token.ndim != 1:
        raise ValueError(f"moe_gather takes x (N, D) and slot_token (rows,), got "
                         f"{tuple(x.shape)} and {tuple(slot_token.shape)}")
    _check_maps(slot_token, x, "slot_token")


def check_combine(ye: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on arguments ``moe_combine`` does not take: ``ye`` not (R, D),
    ``rows`` not (T, k) int32, ``w`` not (T, k) of ye's dtype, any of them
    on another device."""
    if ye.ndim != 2 or rows.ndim != 2 or w.shape != rows.shape:
        raise ValueError(f"moe_combine takes ye (R, D), rows and w (T, k), got "
                         f"{tuple(ye.shape)}, {tuple(rows.shape)} and {tuple(w.shape)}")
    _check_maps(rows, ye, "rows")
    if w.dtype != ye.dtype or w.device != ye.device:
        raise ValueError(f"w must be {ye.dtype} on {ye.device}, got {w.dtype} on {w.device}")


def moe_gather_plain(x: torch.Tensor, slot_token: torch.Tensor) -> torch.Tensor:
    """``(rows, D)``: row r is ``x[slot_token[r]]``, or zeros where it is -1."""
    check_gather(x, slot_token)
    padded = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return padded[torch.where(slot_token < 0, x.shape[0], slot_token).long()]


def moe_combine_plain(ye: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(T, D)``: each token's ``w``-weighted sum of its choices' rows of
    ``ye``; a dropped choice (row -1) reads a zero row, as the eager path's
    sink does."""
    check_combine(ye, rows, w)
    padded = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))])
    y_k = padded[torch.where(rows < 0, ye.shape[0], rows).long()]
    return torch.einsum("...k,...kd->...d", w, y_k)


def moe_combine_ordered(ye: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The combine kernel's own arithmetic in PyTorch ops, the oracle it is
    held to bit for bit on the card: fp32 products added in choice order to
    an fp32 sum that starts at zero and skips dropped choices, rounded once
    to ye's dtype. Slower than the plain version (one pass a choice)."""
    check_combine(ye, rows, w)
    acc = torch.zeros((rows.shape[0], ye.shape[1]), dtype=torch.float32, device=ye.device)
    for j in range(rows.shape[1]):
        term = w[:, j, None].float() * ye[rows[:, j].clamp(min=0).long()].float()
        acc = torch.where(rows[:, j, None] >= 0, acc + term, acc)
    return acc.to(ye.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("moe_dispatch")
    if lib.moe_gather.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        # src, slot_token, out, rows, row_bytes, stream
        lib.moe_gather.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
        # ye, rows, w, out, tokens, k, d, bf16, stream
        lib.moe_combine.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ctypes.c_int, ptr]
        lib.moe_gather.restype = lib.moe_combine.restype = ctypes.c_int
    return lib


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if type(t) is not torch.Tensor:
        raise TypeError(f"{name} takes plain tensors, not a {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 rows, got {t.dtype}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def moe_gather_cuda(x: torch.Tensor, slot_token: torch.Tensor) -> torch.Tensor:
    """Launch the gather kernel on x's device and current stream."""
    _check_cuda(x, "moe_gather_cuda")
    check_gather(x, slot_token)
    x, slot_token = x.contiguous(), slot_token.contiguous()
    out = torch.empty((slot_token.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(lib.moe_gather(x.data_ptr(), slot_token.data_ptr(), out.data_ptr(),
                                 out.shape[0], x.shape[1] * x.element_size(), stream),
                  "moe_gather")
    moe_gather_cuda.launches += 1
    return out


def moe_combine_cuda(ye: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the combine kernel on ye's device and current stream."""
    _check_cuda(ye, "moe_combine_cuda")
    check_combine(ye, rows, w)
    ye, rows, w = ye.contiguous(), rows.contiguous(), w.contiguous()
    out = torch.empty((rows.shape[0], ye.shape[1]), dtype=ye.dtype, device=ye.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(ye.device):
        stream = torch.cuda.current_stream(ye.device).cuda_stream
        _raise_on(lib.moe_combine(ye.data_ptr(), rows.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  rows.shape[0], rows.shape[1], ye.shape[1],
                                  int(ye.dtype == torch.bfloat16), stream), "moe_combine")
    moe_combine_cuda.launches += 1
    return out


moe_gather_cuda.launches = 0
moe_combine_cuda.launches = 0
