"""Flash attention: the hand-written Hopper kernel's wrapper and its plain version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (built with
``nvcc`` at first use, see ``_build``) on the current CUDA stream. It checks
its inputs, allocates the output, launches, raises if the launch was
refused, and counts the launch in ``flash_attention_cuda.launches``.

The source holds three kernels; ``kernel_for`` is the rule that picks one,
by dtype and head dim alone (never as a fallback after a failed launch):

  * bf16 with hd 64 or 128 (the serving paths): the wgmma/TMA kernel, tiles
    of ``BLOCK_Q`` = 128 query rows by ``BLOCK_K`` = 128 keys;
  * bf16 with any other hd: the mma.sync kernel, 64 rows by 32 keys;
  * fp32: the scalar fp32 kernel, 64 rows by 32 keys.

``flash_attention_plain`` computes the same function in PyTorch tensor ops
with the tiling of the kernel ``kernel_for`` picks for its inputs: query
blocks by KV tiles over the live KV range, fp32 online softmax with the
finite ``NEG_INF`` mask, ragged tails zero-padded and masked. It is the CPU
path and the oracle the kernel is held against on the card; it is no
yardstick of speed.

Both take the JAX package's layout: q ``(B, Sq, H, hd)``, k/v ``(B, Sk, K, hd)``,
f32 or bf16, ``hd`` a multiple of 8 up to 256; the output has q's dtype.
They replace ``src/repro/kernels/flash_attention.py::flash_attention_pallas``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import NEG_INF, kv_block_range

BLOCK_Q = 128  # the wgmma kernel's tile: query rows per block
BLOCK_K = 128  # ... and keys per KV tile
MMA_BLOCK_Q = 64  # the mma.sync and fp32 kernels' tile
MMA_BLOCK_K = 32
WGMMA_HEAD_DIMS = (64, 128)
_KERNEL_CODE = {"fp32": 0, "mma_sync": 1, "wgmma": 2}
_DTYPES = (torch.float32, torch.bfloat16)


def kernel_for(dtype: torch.dtype, hd: int) -> str:
    """Which kernel of ``csrc/flash_attention.cu`` takes these inputs."""
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma_sync"


def tiles(dtype: torch.dtype, hd: int) -> tuple[int, int]:
    """(query rows, keys) of a tile of the kernel ``kernel_for`` picks."""
    if kernel_for(dtype, hd) == "wgmma":
        return BLOCK_Q, BLOCK_K
    return MMA_BLOCK_Q, MMA_BLOCK_K


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int, q_offset: int) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected 4-D q/k/v, got {q.dim()}, {k.dim()}, {v.dim()}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    Sk, Kh = k.shape[1], k.shape[2]
    if min(B, Sq, Sk, H, Kh) < 1 or H % Kh:
        raise ValueError(f"need non-empty shapes and H % K == 0: H={H}, K={Kh}")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, 256], got {hd}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must all be float32 or bfloat16: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window and q_offset must be >= 0: {window}, {q_offset}")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, logit_softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """The kernel's function in PyTorch ops, tile by tile; any device."""
    check_inputs(q, k, v, window=window, q_offset=q_offset)
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    dev = q.device
    block_q, block_k = tiles(q.dtype, hd)
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, Sq, Kh, rep, hd)
    n_tiles = max(kv_block_range(q_start, min(block_q, Sq - q_start), Sk, block_k,
                                 causal=causal, window=window, q_offset=q_offset)[1]
                  for q_start in range(0, Sq, block_q))
    pad = n_tiles * block_k - Sk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    out = torch.empty((B, Sq, Kh, rep, hd), dtype=torch.float32, device=dev)
    for q_start in range(0, Sq, block_q):
        qb = qf[:, q_start:q_start + block_q]                 # (B, bq, K, rep, hd)
        bq = qb.shape[1]
        q_pos = q_offset + q_start + torch.arange(bq, device=dev)
        lo, hi = kv_block_range(q_start, bq, Sk, block_k, causal=causal,
                                window=window, q_offset=q_offset)
        acc = torch.zeros((B, Kh, rep, bq, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, Kh, rep, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kh, rep, bq), dtype=torch.float32, device=dev)
        for j in range(lo, hi):
            k_start = j * block_k
            kb = kf[:, k_start:k_start + block_k]             # (B, bk, K, hd)
            vb = vf[:, k_start:k_start + block_k]
            k_pos = k_start + torch.arange(block_k, device=dev)
            s = torch.einsum("bqkrd,bskd->bkrqs", qb, kb)
            if logit_softcap > 0.0:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            mask = (k_pos < Sk)[None, :].expand(bq, block_k)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkrqs,bskd->bkrqd", p, vb)
            m = m_new
        ob = acc / torch.clamp(l[..., None], min=1e-37)       # (B, K, rep, bq, hd)
        out[:, q_start:q_start + bq] = ob.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr, ptr, ptr, ptr,                 # q, k, v, o
                       i32, i32, i32, i32, i32, i32, i32,  # kernel, B, Sq, Sk, H, K, hd
                       i32, i32, f32, i32, f32,            # causal, window, softcap, q_offset, scale
                       ptr]                                # stream
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, logit_softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch the CUDA kernel on q's device and current stream; (B,Sq,H,hd) out.

    The kernel is the one ``kernel_for(q.dtype, hd)`` names: the wgmma/TMA
    kernel for bf16 with hd 64 or 128, the mma.sync kernel for bf16 with any
    other hd, the fp32 kernel for fp32. Raises for a tensor that is not on a
    CUDA device, for anything ``check_inputs`` rejects, for non-contiguous or
    misaligned inputs, and when the launch is refused.
    """
    check_inputs(q, k, v, window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} has {t.numel()} elements; the kernel takes < 2**31")
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNEL_CODE[kernel_for(q.dtype, hd)], B, Sq, Sk, H, Kh, hd,
            int(causal), int(window), float(logit_softcap), int(q_offset),
            1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
