"""Gradient compression for cross-legion reduction (beyond-paper feature).

Legio's hierarchical topology makes the cross-legion (master-to-master)
reduce the long-haul hop: across hosts it rides links an order of magnitude
slower than the ones inside a legion. Both schemes here are error-feedback
compressors: the compression residual is carried to the next step so the
compressed-SGD iterates stay within O(1) of the exact ones (Karimireddy et
al. 2019).

  int8  : per-tensor absmax scaling, 4x volume cut from f32.
  topk  : keep the top-k fraction of |g| entries (flattened), send values +
          int32 indices; volume ~ 2 * k * |g|.

Two implementations of each, bitwise-identical for float32 inputs:

  * the torch pair (``compress_int8`` / ``decompress_int8``,
    ``compress_topk`` / ``decompress_topk``) on tensors, on the tensor's
    device: int8 runs the absmax and quantize kernels (``kernels.ops``) on a
    CUDA tensor and their plain versions on a CPU tensor;
  * the numpy twins (``*_np``), the sim data plane's compressors, carried
    over unchanged from the JAX package.

absmax / clip / round (half to even) and the q * scale product are
elementwise IEEE f32 ops, the scale is an f32 division (never a
multiplication by 1/127), and top-k takes the stable descending argsort, so
ties go to the lowest index as numpy's stable argsort gives them
(``torch.topk`` leaves the order among ties unspecified).

``make_compressor(scheme)`` wraps a scheme (``none``, ``int8``, ``topk``)
into a pair of functions over a parameter pytree (nested dicts of tensors)
with error feedback: each call compresses ``g + residual`` leaf by leaf and
returns the new residual, what the payload failed to carry.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.quantize import int8_scale
from repro_torch.optim.adamw import tree_map


class Int8Grad(NamedTuple):
    q: Any       # int8 payload, shaped like the input
    scale: Any   # () fp32 max(absmax, 1e-12) / 127


class TopKGrad(NamedTuple):
    values: Any   # (k,) fp32
    indices: Any  # (k,) int32
    size: int     # original flattened size


def compress_int8(g: torch.Tensor) -> Int8Grad:
    """Absmax-quantize ``g`` to int8 on its device (the two kernels on CUDA).
    An empty tensor gets the scale ``1e-12 / 127`` and an empty payload."""
    gf = g.to(torch.float32).contiguous()
    scale = int8_scale(ops.absmax(gf))
    return Int8Grad(q=ops.quantize_int8(gf, scale), scale=scale)


def decompress_int8(c: Int8Grad, dtype=torch.float32) -> torch.Tensor:
    return (c.q.to(torch.float32) * c.scale).to(dtype)


def compress_topk(g: torch.Tensor, fraction: float) -> TopKGrad:
    flat = g.to(torch.float32).reshape(-1)
    k = max(1, int(flat.numel() * fraction))
    idx = torch.argsort(-flat.abs(), stable=True)[:k]
    return TopKGrad(values=flat[idx], indices=idx.to(torch.int32), size=flat.numel())


def decompress_topk(c: TopKGrad, shape, dtype=torch.float32) -> torch.Tensor:
    out = torch.zeros((c.size,), dtype=torch.float32, device=c.values.device)
    out[c.indices.long()] = c.values.to(torch.float32)
    return out.reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# numpy twins: the sim data plane's compressors (the JAX package's, unchanged)
# ---------------------------------------------------------------------------

def compress_int8_np(g: np.ndarray) -> Int8Grad:
    gf = np.asarray(g, dtype=np.float32)
    scale = np.maximum(np.max(np.abs(gf)), np.float32(1e-12)) / np.float32(127.0)
    q = np.clip(np.round(gf / scale), -127, 127).astype(np.int8)
    return Int8Grad(q=q, scale=np.float32(scale))


def decompress_int8_np(c: Int8Grad, dtype=np.float32) -> np.ndarray:
    return (np.asarray(c.q, np.float32) * np.float32(c.scale)).astype(dtype)


def compress_topk_np(g: np.ndarray, fraction: float) -> TopKGrad:
    flat = np.asarray(g, dtype=np.float32).reshape(-1)
    k = max(1, int(flat.size * fraction))
    idx = np.argsort(-np.abs(flat), kind="stable")[:k].astype(np.int32)
    return TopKGrad(values=flat[idx], indices=idx, size=flat.size)


def decompress_topk_np(c: TopKGrad, shape, dtype=np.float32) -> np.ndarray:
    out = np.zeros((c.size,), np.float32)
    out[np.asarray(c.indices)] = np.asarray(c.values, np.float32)
    return out.reshape(shape).astype(dtype)


def compressed_bytes(g, scheme: str, fraction: float = 0.05) -> int:
    """Wire bytes after compression (used by the collective roofline model);
    ``g`` is a numpy array or a tensor."""
    if isinstance(g, torch.Tensor):
        n, itemsize = g.numel(), g.element_size()
    else:
        n, itemsize = g.size, g.dtype.itemsize
    if scheme == "int8":
        return n + 4
    if scheme == "topk":
        k = max(1, int(n * fraction))
        return 8 * k
    return n * itemsize


def make_compressor(scheme: str, fraction: float = 0.05):
    """Returns (compress_tree, decompress_tree) closing over error feedback.

    compress(grads, residual) -> (payload, new_residual); ``residual`` is None
    on the first call, then the tree the previous call returned.
    decompress(payload, template) -> grads, each leaf in its template's dtype.
    """
    if scheme == "none":
        def comp_none(grads, residual):
            return grads, residual

        def decomp_none(payload, template):
            return payload
        return comp_none, decomp_none

    if scheme == "int8":
        compress, decompress = compress_int8, (lambda c, t: decompress_int8(c, t.dtype))
    elif scheme == "topk":
        def compress(g):
            return compress_topk(g, fraction)

        def decompress(c, t):
            return decompress_topk(c, t.shape, t.dtype)
    else:
        raise ValueError(f"unknown compression scheme {scheme!r}")

    def comp(grads, residual):
        def one(g, r):
            gf = g.to(torch.float32) + (r if r is not None else 0.0)
            c = compress(gf)
            return c, gf - decompress(c, gf)
        if residual is None:
            residual = tree_map(lambda _: None, grads)
        pairs = tree_map(one, grads, residual)
        return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)

    def decomp(payload, template):
        return tree_map(decompress, payload, template)
    return comp, decomp
