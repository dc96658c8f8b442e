"""Carry the JAX package's parameters across to the port.

``params_from_reference`` takes the reference's ``init_params`` pytree as
numpy arrays (nested dicts, ``layers`` stacked ``(L, ...)``; for the
encoder-decoder ``enc_layers`` and ``dec_layers``) and returns the port's
pytree, leaf for leaf and bit for bit. The reference's bf16 leaves arrive
as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects; they
travel as their raw 16-bit patterns instead, which is exact. Each leaf's
dtype is checked against its own spec (``api.param_specs``): the SSM's
``A_log``, ``dt_bias`` and ``D`` and the MoE ``router`` are fp32 whatever
``param_dtype``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import param_specs
from repro_torch.models.common import torch_dtype

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

    def walk(specs: Params, sub: Params, path: str) -> Params:
        if set(specs) != set(sub):
            raise ValueError(f"{path or 'params'}: keys {sorted(sub)} != "
                             f"expected {sorted(specs)}")
        out = {}
        for name, spec in specs.items():
            where = f"{path}/{name}" if path else name
            if isinstance(spec, dict):
                out[name] = walk(spec, sub[name], where)
                continue
            shape, want = spec[0], torch_dtype(spec[1])
            t = _leaf(np.asarray(sub[name]))
            if tuple(t.shape) != shape or t.dtype != want:
                raise ValueError(f"{where}: got {tuple(t.shape)} {t.dtype}, "
                                 f"expected {shape} {want}")
            out[name] = t.to(dev)
        return out

    return walk(param_specs(cfg), tree, "")
