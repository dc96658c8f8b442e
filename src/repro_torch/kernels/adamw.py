"""The optimizer's passes over a parameter tree: the hand-written Hopper kernels' wrappers.

``clip_by_global_norm_cuda`` and ``adamw_update_cuda`` launch
``csrc/adamw.cu`` (built with ``nvcc`` at first use, see ``_build``) on the
current CUDA stream, each over every leaf of a tree at once:

  * the clip is three launches: the sum of squares of every gradient leaf
    into one float64 partial a chunk, the norm and the clip scale from the
    partials (summed in a fixed order, so the norm is the same bits on every
    run), then ``g = to_dtype(float(g) * scale)`` in place, which a chunk
    skips where the scale is exactly 1;
  * AdamW is one launch: the moments and the parameter of every leaf
    updated in place, operation for operation the eager update's, so the
    result is bit-equal to it.

Leaves are cut into chunks of ``CHUNK`` elements, one thread block a chunk.
A launch's table of leaves rides in the kernel's arguments and holds at
most ``MAX_LEAVES`` of them (the port's largest tree has 24).
``launch_table`` builds it and ``chunk_bounds`` reads a chunk's element
range as the kernels do; both are plain Python, so the CPU tests hold
them. ``check_grads`` and ``check_adamw_leaf`` raise on a leaf the kernels
do not take: dtypes other than float32 and bfloat16, a gradient, moment or
parameter on another device, and a moment or parameter that is not
contiguous (the kernels write them in place; the clip writes the gradient,
AdamW only reads it, through ``g.contiguous()``). An empty leaf is left out
of the table: it has nothing to read or write.

Each wrapper counts its device launches in its ``launches``. The plain
versions, the CPU path and the oracle these are held against on the card,
are ``repro_torch.optim.adamw``'s eager code. No TPU kernel is replaced:
the JAX package leaves its optimizer to XLA.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

CHUNK = 1 << 16    # elements a block streams; a multiple of the kernels' 8-element step
MAX_LEAVES = 64    # leaves a launch's table holds (csrc/adamw.cu: kMaxLeaves)
GRAD_BF16, MOMENT_BF16, PARAM_BF16 = 1, 2, 4   # a leaf's kind bits
_DTYPES = (torch.float32, torch.bfloat16)


class Table(NamedTuple):
    """One launch: the tree's leaf indices it covers, and the first chunk
    of each (``chunk0[-1]`` is the launch's chunk count)."""
    leaves: tuple[int, ...]
    chunk0: tuple[int, ...]


def launch_table(numels: list[int], chunk: int = CHUNK, max_leaves: int = MAX_LEAVES) -> Table:
    """The table of a launch over leaves of these lengths; empty leaves are
    left out, and more than ``max_leaves`` others raise."""
    if chunk <= 0 or chunk % 8:
        raise ValueError(f"chunk must be a positive multiple of 8, got {chunk}")
    leaves, chunk0 = [], [0]
    for i, n in enumerate(numels):
        if n < 0:
            raise ValueError(f"leaf {i} has {n} elements")
        if n:
            leaves.append(i)
            chunk0.append(chunk0[-1] + -(-n // chunk))
    if len(leaves) > max_leaves:
        raise ValueError(f"{len(leaves)} non-empty leaves: a launch's table holds {max_leaves}")
    return Table(tuple(leaves), tuple(chunk0))


def chunk_bounds(table: Table, numels: list[int], c: int,
                 chunk: int = CHUNK) -> tuple[int, int, int]:
    """(leaf index, first element, end) of the table's chunk ``c``: the
    kernels' lookup (the last leaf whose first chunk is at or before c)."""
    lo, hi = 0, len(table.leaves) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if table.chunk0[mid] <= c:
            lo = mid
        else:
            hi = mid - 1
    leaf = table.leaves[lo]
    begin = (c - table.chunk0[lo]) * chunk
    return leaf, begin, min(begin + chunk, numels[leaf])


def _check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise ValueError(f"the optimizer kernels take float32 or bfloat16 {what}, got {t.dtype}")


def _check_plain(t: torch.Tensor, what: str) -> None:
    if type(t) is not torch.Tensor:
        raise TypeError(f"the optimizer kernels take plain tensors, not a {type(t).__name__} "
                        f"{what}: run the plain path on a mesh")


def check_grads(grads: list[torch.Tensor]) -> None:
    """Raise on gradients the clip kernels do not take: not float32 or
    bfloat16, on more than one device, or not contiguous (written in place)."""
    for i, g in enumerate(grads):
        _check_plain(g, "gradient")
        _check_dtype(g, "gradients")
        if g.device != grads[0].device:
            raise ValueError(f"gradient {i} is on {g.device}, gradient 0 on {grads[0].device}")
        if not g.is_contiguous():
            raise ValueError(f"gradient {i} is not contiguous: the clip writes it in place")


def check_adamw_leaf(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     p: torch.Tensor) -> None:
    """Raise on a (gradient, moments, parameter) leaf the AdamW kernel does
    not take: shapes that differ, a dtype other than float32 or bfloat16, two
    moments of different dtypes, tensors on different devices, or a moment or
    parameter that is not contiguous (the kernel writes them in place)."""
    for t, what in ((g, "gradient"), (m, "first moment"), (v, "second moment"),
                    (p, "parameter")):
        _check_plain(t, what)
        _check_dtype(t, f"{what}s")
        if t.shape != p.shape:
            raise ValueError(f"{what} {tuple(t.shape)} is not shaped like its parameter "
                             f"{tuple(p.shape)}")
        if t.device != p.device:
            raise ValueError(f"{what} on {t.device}, its parameter on {p.device}")
    if m.dtype != v.dtype:
        raise ValueError(f"the moments differ in dtype: {m.dtype}, {v.dtype}")
    for t, what in ((m, "first moment"), (v, "second moment"), (p, "parameter")):
        if not t.is_contiguous():
            raise ValueError(f"the {what} is not contiguous: the kernel writes it in place")


def _check_scalar(t: torch.Tensor, device: torch.device, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.numel() != 1 or t.dtype != torch.float32 \
            or t.device != device:
        raise ValueError(f"{what} must be a one-element float32 tensor on {device}")


class _LeafTable(ctypes.Structure):
    """``struct LeafTable`` of csrc/adamw.cu, field for field."""
    _fields_ = [("n", ctypes.c_int64 * MAX_LEAVES),
                ("chunk0", ctypes.c_int64 * (MAX_LEAVES + 1)),
                ("g", ctypes.c_void_p * MAX_LEAVES),
                ("m", ctypes.c_void_p * MAX_LEAVES),
                ("v", ctypes.c_void_p * MAX_LEAVES),
                ("p", ctypes.c_void_p * MAX_LEAVES),
                ("kind", ctypes.c_int32 * MAX_LEAVES),
                ("count", ctypes.c_int32)]


def _table(table: Table, g, m=None, v=None, p=None) -> _LeafTable:
    t = _LeafTable()
    t.count = len(table.leaves)
    for j, c0 in enumerate(table.chunk0):
        t.chunk0[j] = c0
    for j, i in enumerate(table.leaves):
        t.n[j] = g[i].numel()
        t.g[j] = g[i].data_ptr()
        kind = GRAD_BF16 if g[i].dtype == torch.bfloat16 else 0
        if p is not None:
            t.m[j], t.v[j], t.p[j] = m[i].data_ptr(), v[i].data_ptr(), p[i].data_ptr()
            kind |= (MOMENT_BF16 if m[i].dtype == torch.bfloat16 else 0) \
                | (PARAM_BF16 if p[i].dtype == torch.bfloat16 else 0)
        t.kind[j] = kind
    return t


def _library() -> ctypes.CDLL:
    lib = _build.load_library("adamw")
    if lib.adamw_step.argtypes is None:
        ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        if lib.adamw_table_bytes() != ctypes.sizeof(_LeafTable):
            raise RuntimeError(f"csrc/adamw.cu's LeafTable is {lib.adamw_table_bytes()} B, "
                               f"the wrapper's {ctypes.sizeof(_LeafTable)} B")
        table = ctypes.POINTER(_LeafTable)
        lib.adamw_sumsq.argtypes = [table, i64, ptr, ptr]          # table, chunk, partials, stream
        lib.adamw_norm_finish.argtypes = [ptr, i64, f32, ptr, ptr, ptr]
        lib.adamw_clip.argtypes = [table, i64, ptr, ptr]           # table, chunk, scale, stream
        lib.adamw_step.argtypes = [table, i64, ptr, ptr, ptr, f32, f32, f32, f32, f32, f32, ptr]
        for fn in (lib.adamw_sumsq, lib.adamw_norm_finish, lib.adamw_clip, lib.adamw_step):
            fn.restype = ctypes.c_int
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def clip_by_global_norm_cuda(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradient leaves in place by ``min(max_norm / norm, 1)``;
    return the global norm, a 0-d float32 tensor on their device."""
    check_grads(grads)
    dev = grads[0].device
    if dev.type != "cuda":
        raise ValueError(f"clip_by_global_norm_cuda needs CUDA tensors, got {dev}")
    table = launch_table([g.numel() for g in grads])
    chunks = table.chunk0[-1]
    partials = torch.empty(chunks, dtype=torch.float64, device=dev)
    norm = torch.empty((), dtype=torch.float32, device=dev)
    scale = torch.empty((), dtype=torch.float32, device=dev)
    lib = _library()
    s = _table(table, grads)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if chunks:
            _raise_on(lib.adamw_sumsq(ctypes.byref(s), CHUNK, partials.data_ptr(), stream),
                      "sum of squares")
        _raise_on(lib.adamw_norm_finish(partials.data_ptr(), chunks, max_norm, norm.data_ptr(),
                                        scale.data_ptr(), stream), "norm")
        if chunks:
            _raise_on(lib.adamw_clip(ctypes.byref(s), CHUNK, scale.data_ptr(), stream), "clip")
    clip_by_global_norm_cuda.launches += 3 if chunks else 1
    return norm


def adamw_update_cuda(grads: list[torch.Tensor], mu: list[torch.Tensor],
                      nu: list[torch.Tensor], params: list[torch.Tensor], *, lr: torch.Tensor,
                      bc1: torch.Tensor, bc2: torch.Tensor, beta1: float, beta2: float,
                      eps: float, weight_decay: float) -> None:
    """One AdamW step over the leaves, in place: the moments take their new
    values in their own dtype, each parameter its update. ``lr``, ``bc1``
    and ``bc2`` are read from device memory by the kernel; the Python
    numbers are rounded to float32, as torch rounds a scalar operand."""
    if not (len(grads) == len(mu) == len(nu) == len(params)):
        raise ValueError("grads, moments and params must have as many leaves")
    for leaf in zip(grads, mu, nu, params):
        check_adamw_leaf(*leaf)
    if not params:
        return
    dev = params[0].device
    if dev.type != "cuda" or any(p.device != dev for p in params):
        raise ValueError(f"adamw_update_cuda needs its leaves on one CUDA device, got {dev}")
    for t, what in ((lr, "lr"), (bc1, "bc1"), (bc2, "bc2")):
        _check_scalar(t, dev, what)
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]   # only read
    table = launch_table([p.numel() for p in params])
    if not table.chunk0[-1]:
        return
    s = _table(table, grads, mu, nu, params)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.adamw_step(ctypes.byref(s), CHUNK, lr.data_ptr(), bc1.data_ptr(),
                                 bc2.data_ptr(), beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                                 weight_decay, stream), "AdamW")
    adamw_update_cuda.launches += 1


clip_by_global_norm_cuda.launches = 0
adamw_update_cuda.launches = 0
