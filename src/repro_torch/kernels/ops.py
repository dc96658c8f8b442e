"""Public kernel entry points, dispatched on where the tensors live.

For CUDA tensors ``flash_attention``, ``ssd_scan``, ``absmax`` and
``quantize_int8`` launch the hand-written kernels; for CPU tensors they run the kernels' plain PyTorch
versions (the counterpart of the JAX package's Pallas ``interpret=True`` on
CPU). They never fall back from one to the other: a CUDA launch that fails
raises. They take plain tensors only: a DTensor (a model run on a mesh
with ``use_pallas`` on) raises, naming the kernel, rather than being
unwrapped to its local block; the dry-run runs the plain paths.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.quantize import (
    absmax_cuda,
    absmax_plain,
    quantize_int8_cuda,
    quantize_plain,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain


def _no_dtensor(kernel: str, *tensors) -> None:
    for t in tensors:
        if t is not None and type(t) is not torch.Tensor:
            from torch.distributed.tensor import DTensor

            if isinstance(t, DTensor):
                raise TypeError(f"the {kernel} kernel takes plain tensors, not a DTensor "
                                f"placed {t.placements}: run the plain path on a mesh "
                                "(use_pallas=False)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """(B,Sq,H,hd) x (B,Sk,K,hd)² -> (B,Sq,H,hd); GQA by index, no KV repeat."""
    _no_dtensor("flash_attention", q, k, v)
    kwargs = dict(causal=causal, window=window, logit_softcap=logit_softcap,
                  q_offset=q_offset)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kwargs)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kwargs)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor | None = None):
    """Chunked SSD scan; returns (y (B,S,H,P), final_state (B,H,P,N) f32)."""
    _no_dtensor("ssd_scan", x, dt, A, Bm, Cm, initial_state)
    kwargs = dict(chunk=chunk, initial_state=initial_state)
    if x.device.type == "cuda":
        return ssd_scan_cuda(x, dt, A, Bm, Cm, **kwargs)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, **kwargs)
    raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not {x.device}")


def absmax(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` of an f32 tensor as a 0-d f32 tensor on x's device."""
    _no_dtensor("absmax", x)
    if x.device.type == "cuda":
        return absmax_cuda(x)
    if x.device.type == "cpu":
        return absmax_plain(x)
    raise ValueError(f"absmax runs on CUDA or CPU tensors, not {x.device}")


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8; scale a 0-d f32 tensor on x's device."""
    _no_dtensor("quantize_int8", x, scale)
    if x.device.type == "cuda":
        return quantize_int8_cuda(x, scale)
    if x.device.type == "cpu":
        return quantize_plain(x, scale)
    raise ValueError(f"quantize_int8 runs on CUDA or CPU tensors, not {x.device}")
