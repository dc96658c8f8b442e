"""Attention implementations (same contracts as the JAX package's).

``blocked_attention`` is the ``use_pallas=False`` path: a flash-attention
style online softmax computed block by block, never materialising the full
(Sq, Sk) score matrix. ``use_pallas=True`` routes prefill attention to the
hand-written kernel through ``repro_torch.kernels.ops.flash_attention``
(CUDA on the card, its plain version for CPU tensors). ``mha_reference`` is
the naive oracle both are held against.

Layouts follow the JAX package at every public function: q ``(B, S, H, hd)``,
k/v ``(B, S, K, hd)``, query head ``h`` reading KV head ``h // (H/K)``.

Distribution, as the reference's: GQA is computed H-major (K/V repeated to
the query head count) and q, k and v are constrained to head parallelism
by ``shard_heads(..., head_shard)``. On DTensors the block loop then runs
on each device's blocks (``dist.sharding.per_shard``). Off a mesh the
constraint returns its input and the loop runs as it always has.

Decode attention stays plain PyTorch: the JAX package computes it outside
any Pallas kernel as well.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import (
    per_shard,
    replicated_like,
    shard_activations,
    shard_gqa,
    shard_heads,
)
from repro_torch.models.common import softcap as _softcap

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int) -> torch.Tensor:
    """(Q, K) boolean mask: True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def mha_reference(
    q: torch.Tensor,             # (B, Sq, H, hd)
    k: torch.Tensor,             # (B, Sk, K, hd)
    v: torch.Tensor,             # (B, Sk, K, hd)
    *,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Naive O(S^2)-memory oracle. Only for tests/small shapes."""
    B, Sq, H, hd = q.shape
    Kh = k.shape[2]
    rep = H // Kh
    qf = q.float() * (1.0 / math.sqrt(hd))
    kf = k.float()
    vf = v.float()
    qf = qf.reshape(B, Sq, Kh, rep, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qf, kf)
    scores = _softcap(scores, logit_softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    m = _mask(q_pos, k_pos, causal=causal, window=window)
    scores = scores.masked_fill(~m[None, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, vf)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def kv_block_range(
    q_start: int, q_len: int, k_len: int, block_k: int,
    *, causal: bool, window: int, q_offset: int, skip: bool = True,
) -> tuple[int, int]:
    """Static [lo, hi) KV-block range a query block can attend to."""
    n_blocks = (k_len + block_k - 1) // block_k
    if not skip:
        return 0, n_blocks
    q_first = q_offset + q_start
    q_last = q_offset + q_start + q_len - 1
    hi = n_blocks if not causal else min(n_blocks, (q_last // block_k) + 1)
    lo = 0
    if window > 0:
        lo = max(0, (q_first - window + 1) // block_k)
    return lo, max(hi, lo + 1)


def blocked_attention(
    q: torch.Tensor,             # (B, Sq, H, hd)
    k: torch.Tensor,             # (B, Sk, K, hd)
    v: torch.Tensor,             # (B, Sk, K, hd)
    *,
    causal: bool = True,
    window: int = 0,
    logit_softcap: float = 0.0,
    q_offset: int = 0,
    block_q: int = 512,
    block_k: int = 1024,
    block_skip: bool = True,
    head_shard: str = "none",
) -> torch.Tensor:
    """Flash-attention (online softmax) in tensor ops; O(Sq·block_k) memory.

    The JAX package scans over KV blocks; here a Python loop does. KV heads
    are repeated to the query head count (H-major GQA), as there.
    """
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    # Pad to block multiples; padded keys are masked via ``k_pos < Sk``.
    Sq_real, Sk_real = Sq, Sk
    pad_q = (-Sq) % block_q
    pad_k = (-Sk) % block_k
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        Sq += pad_q
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        Sk += pad_k

    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    q = shard_heads(q, head_shard)
    k = shard_heads(k, head_shard)
    v = shard_heads(v, head_shard)
    out = per_shard(_blocked_loop, (q, k, v), causal=causal, window=window,
                    logit_softcap=logit_softcap, q_offset=q_offset, block_q=block_q,
                    block_k=block_k, block_skip=block_skip, Sk_real=Sk_real)
    if pad_q:
        out = out[:, :Sq_real]
    return out


def _blocked_loop(q, k, v, *, causal, window, logit_softcap, q_offset, block_q,
                  block_k, block_skip, Sk_real):
    """``blocked_attention``'s loop over (padded, head-repeated) q, k, v."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    pad_k = Sk != Sk_real
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale                                    # (B, Sq, H, hd)
    k_pos_all = torch.arange(Sk, device=dev)

    out_blocks = []
    for qi in range(Sq // block_q):
        q_start = qi * block_q
        qb = qf[:, q_start:q_start + block_q]
        q_pos = q_offset + q_start + torch.arange(block_q, device=dev)
        lo, hi = kv_block_range(
            q_start, block_q, Sk, block_k,
            causal=causal, window=window, q_offset=q_offset, skip=block_skip,
        )
        acc = torch.zeros((B, H, block_q, hd), dtype=torch.float32, device=dev)
        m_prev = torch.full((B, H, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l_prev = torch.zeros((B, H, block_q), dtype=torch.float32, device=dev)
        for j in range(lo, hi):
            # clamped like the reference's dynamic_slice when hi passes the end
            k_start = min(j * block_k, Sk - block_k)
            kb = k[:, k_start:k_start + block_k].float()
            vb = v[:, k_start:k_start + block_k].float()
            k_pos = k_pos_all[k_start:k_start + block_k]
            s = torch.einsum("bqhd,bshd->bhqs", qb, kb)       # (B, H, bq, bk)
            s = _softcap(s, logit_softcap)
            if causal:
                mask = k_pos[None, :] <= q_pos[:, None]
            else:
                mask = torch.ones((block_q, block_k), dtype=torch.bool, device=dev)
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            if pad_k:
                mask &= (k_pos < Sk_real)[None, :]
            s = s.masked_fill(~mask[None, None], NEG_INF)
            m_cur = s.amax(dim=-1)                            # (B, H, bq)
            m_new = torch.maximum(m_prev, m_cur)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_prev - m_new)
            l_prev = l_prev * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqs,bshd->bhqd", p, vb)
            acc = acc * corr[..., None] + pv
            m_prev = m_new
        ob = acc / torch.clamp(l_prev[..., None], min=1e-37)  # (B, H, bq, hd)
        out_blocks.append(ob.permute(0, 2, 1, 3))            # (B, bq, H, hd)

    return torch.cat(out_blocks, dim=1).to(q.dtype)


def decode_attention(
    q: torch.Tensor,             # (B, 1, H, hd) — one new token
    k_cache: torch.Tensor,       # (B, C, K, hd)
    v_cache: torch.Tensor,       # (B, C, K, hd)
    valid_mask: torch.Tensor,    # (B, C) bool — which cache slots hold real keys
    *,
    logit_softcap: float = 0.0,
    head_shard: str = "none",
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) KV cache.

    Grouped: the cache keeps its (K, hd) layout and is never repeated to the
    query head count. On DTensors (``head_shard`` on a mesh) the operands
    are placed alike (``shard_gqa``) and each device attends over its own
    blocks.
    """
    q, k_cache, v_cache = shard_gqa(q, k_cache, v_cache, head_shard)
    valid_mask = shard_activations(replicated_like(valid_mask, q), head_shard)
    return per_shard(_decode_attn, (q, k_cache, v_cache, valid_mask),
                     logit_softcap=logit_softcap)


def _decode_attn(q, k_cache, v_cache, valid_mask, *, logit_softcap):
    B, _, H, hd = q.shape
    Kh = k_cache.shape[2]
    rep = H // Kh
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, Kh, rep, hd)
    s = torch.einsum("bkrd,bckd->bkrc", qf, k_cache.float())
    s = _softcap(s, logit_softcap)
    s = s.masked_fill(~valid_mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrc,bckd->bkrd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention(q, k, v, cfg, *, causal=True, window=None, q_offset=0):
    """Config-dispatched attention entry point used by the models.

    ``cfg.use_pallas`` selects the hand-written kernel; its tile shape is the
    kernel's own, so ``attn_block_q``/``attn_block_k`` only shape the
    blocked path.
    """
    window = cfg.sliding_window if window is None else window
    kwargs = dict(
        causal=causal,
        window=window,
        logit_softcap=cfg.attn_logit_softcap,
        q_offset=q_offset,
    )
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, **kwargs)
    return blocked_attention(
        q, k, v, block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        block_skip=cfg.causal_block_skip, head_shard=cfg.act_shard, **kwargs,
    )
