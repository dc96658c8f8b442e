"""Naive oracles for the kernels (the allclose targets).

``flash_attention_ref`` is O(S²) softmax attention with GQA, causal and
sliding-window masks, logit softcap and query offset — the same function as
the JAX package's ``kernels/ref.py``, through the port's ``mha_reference``.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import mha_reference


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, logit_softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    return mha_reference(q, k, v, causal=causal, window=window,
                         logit_softcap=logit_softcap, q_offset=q_offset)
