"""Mamba-2 SSD chunked scan: the hand-written Hopper kernel's wrapper and its plain version.

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu`` (built with ``nvcc`` at first
use, see ``_build``) on the current CUDA stream. It checks its inputs
(``launch_plan``), allocates the outputs and the two scratches the source's
three kernels pass between them, launches, raises if a launch was refused,
and counts the call in ``ssd_scan_cuda.launches`` (one call is three device
launches: chunk states, state passing, chunk output; four from
``CB_MIN_STATE`` on, where C·Bᵀ is formed once per chunk and group, shared
by the group's heads). For bf16 inputs C·Bᵀ
runs as a bf16 tensor-core product and the products with an fp32 operand
as tf32 products; fp32 inputs run every product as 3xTF32 (fp32-grade).
Sums are fp32, and y is rounded once to x's dtype at the end.

``ssd_scan_plain`` computes the same function in PyTorch tensor ops: the
zero-padding of the TPU kernel's wrapper, then the model's own plain scan,
``models.ssd.ssd_chunked_reference``. It is the CPU path and the oracle the
kernel is held against on the card; it is no yardstick of speed.

Both take the JAX package's layout: x ``(B, S, H, P)`` f32 or bf16, dt
``(B, S, H)`` f32 (post-softplus), A ``(H,)`` f32, B/C ``(B, S, G, N)`` in
x's dtype, optional h0 ``(B, H, P, N)`` f32. They return y ``(B, S, H, P)``
in x's dtype and the final state ``(B, H, P, N)`` f32. Head ``h`` reads
group ``h // (H/G)``. S is zero-padded to a multiple of the chunk
``Q = min(chunk, S)``: dt = 0 there decays nothing and adds nothing, so the
final state is the unpadded one. They replace
``src/repro/kernels/ssd_scan.py::ssd_scan_pallas``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.models.ssd import ssd_chunked_reference

MAX_CHUNK = 2048   # the kernels keep a chunk's prefix sums and dt in shared memory
MAX_STATE = 256    # ... and 64 rows of C at N + 4 floats
CB_MIN_STATE = 64  # from this N on, C·Bᵀ is formed once per (chunk, group) by its own launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                 initial_state: torch.Tensor | None) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("expected x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, S, G, N) or Cm.shape != Bm.shape):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if min(B, S, H, P, G, N) < 1 or H % G:
        raise ValueError(f"need non-empty shapes and H % G == 0: H={H}, G={G}")
    if chunk < 1 or min(chunk, S) > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"need 1 <= min(chunk, S) <= {MAX_CHUNK} and N <= {MAX_STATE}: "
                         f"chunk={chunk}, S={S}, N={N}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, B and C must share one dtype, float32 or bfloat16: "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32: {dt.dtype}, {A.dtype}")
    tensors = [x, dt, A, Bm, Cm]
    if initial_state is not None:
        if tuple(initial_state.shape) != (B, H, P, N) or initial_state.dtype != torch.float32:
            raise ValueError(f"initial_state must be float32 {(B, H, P, N)}, got "
                             f"{initial_state.dtype} {tuple(initial_state.shape)}")
        tensors.append(initial_state)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")


def ssd_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, *, chunk: int = 256,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops on any device: S zero-padded to a
    multiple of the chunk, then ``ssd_chunked_reference``."""
    check_inputs(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    S = x.shape[1]
    pad = (-S) % min(chunk, S)
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, h = ssd_chunked_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    return y[:, :S], h


class LaunchPlan(NamedTuple):
    """What ``ssd_scan_cuda`` hands the kernels for one call."""

    dims: tuple[int, ...]            # B, S, H, P, G, N, Q
    n_chunks: int                    # ceil(S / Q): the last chunk is zero-padded
    strides: tuple[int, ...]         # x, dt, B/C (batch, sequence), in elements
    y_shape: tuple[int, ...]         # (B, S, H, P) in x's dtype
    state_shape: tuple[int, ...]     # (B, H, P, N) f32
    cum_shape: tuple[int, ...]       # scratch: (B, H, n, Q) f32 in-chunk prefix sums
    chunk_states_shape: tuple[int, ...]  # scratch: (B, H, n, P, N) f32, S_c then h_{c-1}
    cb_shape: tuple[int, ...] | None     # scratch: (B, n, G, Q, Q) f32 C·Bᵀ, for N >= CB_MIN_STATE


def launch_plan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, *, chunk: int,
                initial_state: torch.Tensor | None) -> LaunchPlan:
    """Check the layout the kernels read and work out shapes, scratch and strides.

    x, B and C may be strided views (as ``mamba_block`` makes them from one
    projection) as long as their last two dims are packed: x's P and B/C's
    N contiguous, heads and groups adjacent. B and C share strides. dt's
    heads are contiguous; A and h0 are contiguous. Raises ``ValueError``
    otherwise. Runs on tensors of any device (the CPU tests call it).
    """
    check_inputs(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.stride()[2:] != (P, 1) or dt.stride(2) != 1 or Bm.stride()[2:] != (N, 1):
        raise ValueError(f"x needs packed (H, P), dt contiguous heads and B/C packed "
                         f"(G, N): strides {x.stride()}, {dt.stride()}, {Bm.stride()}")
    if Cm.stride() != Bm.stride():
        raise ValueError(f"B and C must share strides: {Bm.stride()}, {Cm.stride()}")
    if not A.is_contiguous() or (initial_state is not None
                                 and not initial_state.is_contiguous()):
        raise ValueError("A and initial_state must be contiguous")
    Q = min(chunk, S)
    n = -(-S // Q)
    return LaunchPlan(dims=(B, S, H, P, G, N, Q), n_chunks=n,
                      strides=(x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                               Bm.stride(0), Bm.stride(1)),
                      y_shape=(B, S, H, P), state_shape=(B, H, P, N),
                      cum_shape=(B, H, n, Q), chunk_states_shape=(B, H, n, P, N),
                      cb_shape=(B, n, G, Q, Q) if N >= CB_MIN_STATE else None)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,       # x, dt, A, B, C, h0
                       ptr, ptr, ptr, ptr, ptr,            # y, h_out, cum, chunk states, C·Bᵀ
                       i32, i32, i32, i32, i32, i32, i32, i32,  # dtype, B, S, H, P, G, N, Q
                       i64, i64, i64, i64, i64, i64,       # x, dt, B/C strides (batch, seq)
                       ptr]                                # stream
        fn.restype = ctypes.c_int
    return lib


def ssd_scan_cuda(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, *, chunk: int = 256,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the three CUDA kernels on x's device and current stream.

    Takes the layouts ``launch_plan`` accepts. Raises for a tensor that is
    not on a CUDA device, for anything ``launch_plan`` rejects, and when a
    launch is refused.
    """
    plan = launch_plan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
    lib = _library()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(plan.y_shape, dtype=x.dtype, device=x.device)
    h_out = torch.empty(plan.state_shape, **f32)
    cum = torch.empty(plan.cum_shape, **f32)
    chunk_states = torch.empty(plan.chunk_states_shape, **f32)
    cb = torch.empty(plan.cb_shape, **f32) if plan.cb_shape is not None else None
    h0 = initial_state.data_ptr() if initial_state is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), h0,
            y.data_ptr(), h_out.data_ptr(), cum.data_ptr(), chunk_states.data_ptr(),
            cb.data_ptr() if cb is not None else None,
            _DTYPE_CODE[x.dtype], *plan.dims, *plan.strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan_cuda.launches += 1
    return y, h_out


ssd_scan_cuda.launches = 0
