"""Carry the JAX package's parameters across to the port.

``params_from_reference`` takes the reference's ``init_params`` pytree as
numpy arrays (nested dicts, ``layers`` stacked ``(L, ...)``) and returns the
port's pytree, leaf for leaf and bit for bit. The reference's bf16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects;
they travel as their raw 16-bit patterns instead, which is exact.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import param_shapes, torch_dtype

Params = dict[str, Any]


def _leaf(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # owned and writable, as torch wants
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(cfg: ModelConfig, tree: Params,
                          device: str | torch.device = "cuda") -> Params:
    """The port's parameters from the reference's pytree of numpy arrays.

    Raises if a key, a shape or a dtype differs from what ``cfg`` implies.
    """
    dev = resolve_device(device)
    want_dtype = torch_dtype(cfg.param_dtype)

    def walk(shapes: Params, sub: Params, path: str) -> Params:
        if set(shapes) != set(sub):
            raise ValueError(f"{path or 'params'}: keys {sorted(sub)} != "
                             f"expected {sorted(shapes)}")
        out = {}
        for name, shape in shapes.items():
            where = f"{path}/{name}" if path else name
            if isinstance(shape, dict):
                out[name] = walk(shape, sub[name], where)
                continue
            t = _leaf(np.asarray(sub[name]))
            if tuple(t.shape) != shape or t.dtype != want_dtype:
                raise ValueError(f"{where}: got {tuple(t.shape)} {t.dtype}, "
                                 f"expected {shape} {want_dtype}")
            out[name] = t.to(dev)
        return out

    return walk(param_shapes(cfg), tree, "")
