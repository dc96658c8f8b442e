"""Naive oracles for the kernels (the allclose targets).

The same functions as the JAX package's ``kernels/ref.py``:

  * ``flash_attention_ref`` — O(S²) softmax attention with GQA, causal and
    sliding-window masks, logit softcap and query offset, through the
    port's ``mha_reference``;
  * ``ssd_scan_ref`` — the chunked SSD recurrence, through the port's
    ``ssd_chunked_reference``.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import mha_reference
from repro_torch.models.ssd import ssd_chunked_reference


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, logit_softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    return mha_reference(q, k, v, causal=causal, window=window,
                         logit_softcap=logit_softcap, q_offset=q_offset)


def ssd_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, *, chunk: int = 256, initial_state: torch.Tensor | None = None,
):
    return ssd_chunked_reference(x, dt, A, Bm, Cm, chunk=chunk,
                                 initial_state=initial_state)
