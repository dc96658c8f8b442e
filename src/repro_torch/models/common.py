"""Shared model building blocks: norms, RoPE, activations, init helpers.

Same definitions as the JAX package's ``models/common.py``. Two points where
a PyTorch habit would be wrong here:

  * the RMSNorm gain is ``1 + w`` with ``w`` initialised to zero, so
    ``torch.nn.RMSNorm`` (gain ``w``) does not apply;
  * RoPE rotates split halves (``[x1, x2] -> [x1 cos - x2 sin, x2 cos + x1 sin]``),
    not interleaved pairs, with angles taken in fp32 from fp32 positions.

``sinusoidal_positions`` (the encoder-decoder's) takes its fp32 angles as the
reference does and its exp, sin and cos in float64, rounded to fp32.

``cross_entropy_chunked`` is the training loss: fp32 logits a sequence chunk
at a time, each chunk checkpointed so no chunk's logits are kept for the
backward. On the card, bf16 operands go to the tensor cores with fp32 sums
(``_LogitsF32``); elsewhere they are upcast to fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import argmax_last, take_last


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``, ...)."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def layer_params(layers: dict) -> list[dict]:
    """Each layer's parameters as views into the stacked ``(L, ...)`` tensors.

    Every stacked leaf is ``unbind``-ed once, so under autograd its gradient
    is one stacked ``(L, ...)`` buffer; indexing ``leaf[i]`` per layer would
    give each ``select``'s backward a zero gradient of the whole leaf.
    """
    per_leaf = {name: (layer_params(sub) if isinstance(sub, dict) else sub.unbind(0))
                for name, sub in layers.items()}
    n = len(next(iter(per_leaf.values())))
    return [{name: views[i] for name, views in per_leaf.items()} for i in range(n)]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics (weight is a (d,) gain, gemma-style 1+w)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name in ("silu", "swiglu"):
        return F.silu
    if name in ("gelu", "geglu"):
        return _gelu_tanh
    raise ValueError(f"unknown activation {name!r}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., :, None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                          # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Sinusoidal positions (whisper)
# ----------------------------------------------------------------------------

def sinusoid_inv_freq(d_model: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(d_model // 2,) fp32 inverse timescales ``exp(-log(1e4) / (half - 1) * i)``.

    The exponent is the reference's fp32 product; the exp is taken in
    float64 and rounded, since torch's vectorised fp32 transcendentals are
    not correctly rounded.
    """
    half = d_model // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    arg = torch.tensor(-log_timescale, dtype=torch.float32) * torch.arange(
        half, dtype=torch.float32)
    return torch.exp(arg.double()).float().to(device)


def sinusoid(scaled: torch.Tensor) -> torch.Tensor:
    """``[sin, cos]`` of fp32 angles along the last dim, each rounded from float64."""
    s = scaled.double()
    return torch.cat([torch.sin(s), torch.cos(s)], dim=-1).float()


def sinusoidal_positions(seq_len: int, d_model: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings, (S, D) fp32."""
    inv = sinusoid_inv_freq(d_model, device)
    scaled = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return sinusoid(scaled)


# ----------------------------------------------------------------------------
# Init helpers
# ----------------------------------------------------------------------------

def dense_init(out: torch.Tensor, generator: torch.Generator,
               scale: float | None = None) -> torch.Tensor:
    """Fill ``out`` with a truncated-normal (±3σ) fan-in init; returns ``out``.

    Drawn in fp32 and cast, as the JAX package does; σ is ``scale`` or
    ``1/sqrt(fan_in)`` with ``fan_in = shape[-2]``. The draws follow the
    distribution, not the JAX package's bits.
    """
    fan_in = out.shape[-2] if out.dim() >= 2 else out.shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0, generator=generator)
    out.copy_(tmp * std)
    return out


def embed_init(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` with N(0, 0.02) drawn in fp32; returns ``out``."""
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.normal_(tmp, 0.0, 1.0, generator=generator)
    out.copy_(tmp * 0.02)
    return out


# ----------------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------------

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 matrices, summed and returned in fp32: one
    ``aten::mm.dtype`` on the card; on the CPU, which has no kernel for it,
    the GEMM of the operands upcast to fp32, whose products are the same."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _logit_grads(d: torch.Tensor, h: torch.Tensor, w: torch.Tensor):
    """fp32 ``(d @ w, d.T @ h)``, the gradients of ``logits = h @ w.T`` from
    the fp32 logit gradient ``d`` (N, V), with bf16 ``h`` (N, D), ``w`` (V, D).

    ``d`` is truly fp32 (softmax less one-hot, the z-loss and softcap terms):
    rounded once to bf16 it would keep 8 bits. It goes into the GEMMs as two
    bf16 terms, ``hi = bf16(d)`` and ``lo = bf16(d - hi)`` (16 bits, below
    the error of the GEMMs' fp32 sums over the vocabulary), stacked (2N, V)
    so that each gradient is one GEMM: ``hi @ w + lo @ w`` as the halves of
    one product added in fp32, and ``hi.T @ h + lo.T @ h`` in one fp32
    accumulator.
    """
    n = d.shape[0]
    split = torch.empty((2 * n, d.shape[1]), dtype=torch.bfloat16, device=d.device)
    hi, lo = split[:n], split[n:]
    hi.copy_(d)
    torch.sub(d, hi, out=lo)               # the fp32 difference, rounded on the store
    both = _mm_f32(split, w)
    return both[:n] + both[n:], _mm_f32(split.t(), torch.cat([h, h]))


class _LogitsF32(torch.autograd.Function):
    """fp32 logits ``h @ unembed.T`` of bf16 ``h`` (N, D) and ``unembed``
    (V, D) by one GEMM with fp32 sums and output (on the card, the tensor
    cores). A product of two bf16 values is exact in fp32, so this is the
    arithmetic of the fp32 GEMM of upcast operands, in another order of sums
    (on an H100 the tensor cores' fp32 sums read 1e-5 to 4e-5 off the SIMT
    GEMM's, relative: ``chip_smoke.py`` phase 8.0). The backward is
    ``_logit_grads``, cast to the operands' dtypes as the upcast's backward
    casts them. ``aten::mm.dtype`` has no derivative of its own, hence the
    Function.

    ``forwards`` and ``backwards`` count calls, as the kernels' ``launches``
    do: with the chunk checkpointed, a chunk is two forwards and a backward.
    """
    forwards = 0
    backwards = 0

    @staticmethod
    def forward(ctx, h, unembed):
        _LogitsF32.forwards += 1
        ctx.save_for_backward(h, unembed)
        return _mm_f32(h, unembed.t())

    @staticmethod
    def backward(ctx, d):
        _LogitsF32.backwards += 1
        h, w = ctx.saved_tensors
        dh, dw = _logit_grads(d, h, w)
        return dh.to(h.dtype), dw.to(w.dtype)


def _tensor_core_logits(h: torch.Tensor, unembed: torch.Tensor) -> bool:
    """Whether a chunk's logits go through ``_LogitsF32``: both operands bf16,
    plain tensors (no DTensor) on the card. The rest (the CPU, the dry-run's
    meta DTensors, fp32 configs) upcast the operands."""
    return (h.dtype == unembed.dtype == torch.bfloat16 and h.is_cuda and unembed.is_cuda
            and type(h) is torch.Tensor and type(unembed) is torch.Tensor)


def _xent_chunk(h: torch.Tensor, unembed: torch.Tensor, y: torch.Tensor,
                logits_softcap: float):
    """One chunk's (sum of NLL, sum of lse**2, correct count). The logits are
    fp32 sums of exact products of the bf16 operands, as the reference's
    ``preferred_element_type=float32`` einsum."""
    if _tensor_core_logits(h, unembed):
        logits = _LogitsF32.apply(h.reshape(-1, h.shape[-1]), unembed).view(*h.shape[:-1], -1)
    else:
        logits = h.float() @ unembed.float().T                        # (B, c, V)
    logits = softcap(logits, logits_softcap)
    lse = torch.logsumexp(logits, dim=-1)                            # (B, c)
    tgt = take_last(logits, y)
    correct = (argmax_last(logits) == y).sum()
    return torch.sum(lse - tgt), torch.sum(torch.square(lse)), correct


def cross_entropy_chunked(
    hidden: torch.Tensor,       # (B, S, D)
    unembed: torch.Tensor,      # (V, D)
    labels: torch.Tensor,       # (B, S) integer
    *,
    chunk: int,
    z_loss_weight: float = 0.0,
    logits_softcap: float = 0.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean NLL over all tokens without materialising (B, S, V) logits.

    Walks sequence chunks; each computes fp32 logits, their logsumexp and the
    target logit. Each chunk is checkpointed (recomputed in the backward), so
    the (B, chunk, V) fp32 logits of one chunk at a time are alive: at
    llama-3B scale that is the largest buffer of a step.
    """
    B, S, _ = hidden.shape
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by xent chunk {chunk}")
    nll_sum = z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        nll, z, corr = checkpoint(_xent_chunk, hidden[:, sl], unembed, labels[:, sl],
                                  logits_softcap, use_reentrant=False)
        nll_sum, z_sum, correct = nll_sum + nll, z_sum + z, correct + corr
    n_tok = B * S
    loss = nll_sum / n_tok
    z_loss = z_loss_weight * z_sum / n_tok
    metrics = {
        "nll": loss,
        "z_loss": z_loss,
        "accuracy": correct.float() / n_tok,
    }
    return loss + z_loss, metrics
