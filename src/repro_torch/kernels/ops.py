"""Public kernel entry points, dispatched on where the tensors live.

For CUDA tensors ``flash_attention`` and ``ssd_scan`` launch the
hand-written kernels; for CPU tensors they run the kernels' plain PyTorch
versions (the counterpart of the JAX package's Pallas ``interpret=True`` on
CPU). They never fall back from one to the other: a CUDA launch that fails
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """(B,Sq,H,hd) x (B,Sk,K,hd)² -> (B,Sq,H,hd); GQA by index, no KV repeat."""
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
    kwargs = dict(chunk=chunk, initial_state=initial_state)
    if x.device.type == "cuda":
        return ssd_scan_cuda(x, dt, A, Bm, Cm, **kwargs)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, **kwargs)
    raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not {x.device}")
