"""Mamba-2 SSD chunked scan: the hand-written Hopper kernel's wrapper and its plain version.

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu`` (built with ``nvcc`` at first
use, see ``_build``) on the current CUDA stream. It checks its inputs,
allocates the outputs, launches, raises if the launch was refused, and
counts the launch in ``ssd_scan_cuda.launches``. The kernel does all its
arithmetic in fp32 on the CUDA cores: no operand is rounded to bf16 for a
product, so bf16 inputs are only widened, and y is rounded once to x's
dtype at the end.

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

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.models.ssd import ssd_chunked_reference

MAX_CHUNK = 2048   # the kernel keeps a chunk's prefix sums and dt in shared memory
MAX_STATE = 256    # ... and 64 rows of B and C at N + 1 floats each
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


def _library() -> ctypes.CDLL:
    lib = _build.load_library("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,       # x, dt, A, B, C, h0
                       ptr, ptr,                           # y, h_out
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
    """Launch the CUDA kernel on x's device and current stream.

    x, B and C may be strided views (as ``mamba_block`` makes them from one
    projection) as long as their last two dims are packed: x's P and B/C's
    N contiguous, heads and groups adjacent. B and C share strides. dt's
    heads are contiguous; A and h0 are contiguous. Raises for a tensor that
    is not on a CUDA device, for anything ``check_inputs`` rejects, for
    other layouts, and when the launch is refused.
    """
    check_inputs(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
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
    lib = _library()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    h0 = initial_state.data_ptr() if initial_state is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), h0,
            y.data_ptr(), h_out.data_ptr(),
            _DTYPE_CODE[x.dtype], B, S, H, P, G, N, min(chunk, S),
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            Bm.stride(0), Bm.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan_cuda.launches += 1
    return y, h_out


ssd_scan_cuda.launches = 0
