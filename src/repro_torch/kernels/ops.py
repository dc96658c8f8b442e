"""Public kernel entry points, dispatched on where the tensors live.

For CUDA tensors ``flash_attention`` launches the hand-written kernel; for
CPU tensors it runs the kernel's plain PyTorch version (the counterpart of
the JAX package's Pallas ``interpret=True`` on CPU). It never falls back
from one to the other: a CUDA launch that fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)


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
