"""Int8 absmax quantization: the hand-written Hopper kernels' wrappers and their plain versions.

The compression hop of a compressed hierarchical reduce quantizes one
master's error-fed partial to int8 in two passes:

  1. ``absmax``: ``max |x|`` over the flattened f32 tensor, a () f32;
  2. ``quantize``: ``clip(round_half_even(x / scale), -127, 127)`` as int8,
     shaped like x, with ``scale = max(absmax, 1e-12) / 127`` passed in as
     runtime data (a 0-d f32 tensor on x's device).

``absmax_cuda`` and ``quantize_int8_cuda`` launch ``csrc/quantize.cu``
(built with ``nvcc`` at first use, see ``_build``) on the current CUDA
stream. Each checks its inputs, allocates its output, launches, raises if
the launch was refused, and counts the launch in its ``launches``. An empty
tensor launches nothing: its absmax is 0 and its quantization is empty.

``absmax_plain`` and ``quantize_plain`` compute the same functions in
PyTorch ops on any device. They are the CPU path and the oracle the kernels
are held against on the card. ``quantize_plain`` divides by the scale as a
0-d tensor on x's own device: CUDA true division by a host scalar is a
multiplication by its reciprocal, one ulp off the division numpy does.

``int8_scale`` turns an absmax into the scale with an f32 division by a 0-d
tensor on the absmax's device, bit-equal to the numpy twin's
``np.maximum(am, np.float32(1e-12)) / np.float32(127.0)``.

They replace ``src/repro/kernels/quantize.py::absmax_pallas`` and
``::quantize_int8_with_scale``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SCALE_FLOOR = 1e-12   # absmax floor: an all-zero tensor keeps a finite scale
QMAX = 127.0


def check_input(x: torch.Tensor) -> None:
    """Raise ``ValueError`` for a tensor the kernels do not take."""
    if x.dtype != torch.float32:
        raise ValueError(f"quantize kernels take float32, got {x.dtype}")


def check_scale(x: torch.Tensor, scale: torch.Tensor) -> None:
    if not isinstance(scale, torch.Tensor) or scale.numel() != 1:
        raise ValueError("scale must be a one-element tensor")
    if scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError(f"scale must be float32 on {x.device}, got {scale.dtype} "
                         f"on {scale.device}")


def int8_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-12) / 127`` as a 0-d f32 tensor on absmax's device."""
    # torch.full fills on the device: no host-to-device copy, no stream sync
    floor = torch.full((), SCALE_FLOOR, dtype=torch.float32, device=absmax.device)
    qmax = torch.full((), QMAX, dtype=torch.float32, device=absmax.device)
    return torch.maximum(absmax.reshape(()), floor) / qmax


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` as a 0-d f32 tensor on x's device; 0 for an empty tensor."""
    check_input(x)
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return x.abs().amax()


def quantize_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8, shaped like x."""
    check_input(x)
    check_scale(x, scale)
    return torch.clamp(torch.round(x / scale.reshape(())), -QMAX, QMAX).to(torch.int8)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("quantize")
    if lib.absmax_f32.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.absmax_f32.argtypes = [ptr, i64, ptr, ptr]            # x, n, out, stream
        lib.absmax_f32.restype = ctypes.c_int
        lib.quantize_int8_f32.argtypes = [ptr, ptr, ptr, i64, ptr]  # x, scale, q, n, stream
        lib.quantize_int8_f32.restype = ctypes.c_int
    return lib


def _check_cuda(x: torch.Tensor, name: str) -> None:
    check_input(x)
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")


def absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the absmax kernel on x's device and current stream."""
    _check_cuda(x, "absmax_cuda")
    out = torch.zeros((), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.absmax_f32(x.data_ptr(), x.numel(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"absmax kernel launch failed: CUDA error {rc}")
    absmax_cuda.launches += 1
    return out


def quantize_int8_cuda(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the quantize kernel on x's device and current stream; the
    scale is read from device memory by the kernel."""
    _check_cuda(x, "quantize_int8_cuda")
    check_scale(x, scale)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return q
    scale = scale.contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantize_int8_f32(x.data_ptr(), scale.data_ptr(), q.data_ptr(),
                                   x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {rc}")
    quantize_int8_cuda.launches += 1
    return q


absmax_cuda.launches = 0
quantize_int8_cuda.launches = 0
