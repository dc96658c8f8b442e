"""Family-dispatched model API.

The same five entry points as the JAX package's ``models/api.py``; those
that create tensors take a ``device`` (the card unless the caller asks for
the CPU), and the rest run where their inputs live:

  init_params(cfg, generator, device)          -> params pytree
  train_loss(cfg, params, batch)               -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)      -> decode cache
  prefill(cfg, params, tokens, max_len, ...)   -> (last logits, cache)
  decode_step(cfg, params, cache, tokens)      -> (logits, cache)
  count_params(params)                         -> int

Families: dense, moe, vlm and hybrid go to ``transformer``, ssm to
``mamba``, encdec to ``encdec``. ``prefill`` passes its keywords through:
``embeds`` (B, S, D), the stub frontends' input, which the encoder-decoder
needs (its audio frames) and the VLM takes in place of the prompt's
embeddings.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, mamba, transformer

Params = dict[str, Any]

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "hybrid")


def _mod(cfg: ModelConfig):
    if cfg.family in _TRANSFORMER_FAMILIES:
        return transformer
    if cfg.family == "ssm":
        return mamba
    if cfg.family == "encdec":
        return encdec
    raise ValueError(f"unknown family {cfg.family!r}")


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter pytree's leaves as ``(shape, dtype name)`` pairs."""
    return _mod(cfg).param_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> Params:
    """Random weights on ``device``; ``generator`` defaults to seed 0 there."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _mod(cfg).init_params(cfg, generator, dev)


def train_loss(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor]):
    """(scalar loss, metrics) of ``batch`` (tokens, labels), differentiable.

    Training runs through the plain paths (``blocked_attention``, the plain
    SSD scan), as the JAX package's does: its Pallas kernels cannot be
    differentiated, and the port's kernels are forward-only.
    """
    if cfg.use_pallas:
        raise ValueError(
            f"{cfg.name}: train_loss with use_pallas=True: the JAX package cannot "
            "differentiate its Pallas kernels and the port's kernels are forward-only; "
            "train with use_pallas=False (blocked attention, the plain SSD scan)")
    return _mod(cfg).train_loss(cfg, params, batch)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    return _mod(cfg).init_cache(cfg, batch, max_len, resolve_device(device))


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, max_len: int, **kw):
    return _mod(cfg).prefill(cfg, params, tokens, max_len, **kw)


def decode_step(cfg: ModelConfig, params: Params, cache: dict, tokens: torch.Tensor):
    return _mod(cfg).decode_step(cfg, params, cache, tokens)


def count_params(params: Params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()
