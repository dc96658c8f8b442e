"""Mamba-2 language model (attention-free, family='ssm').

The JAX package's ``models/mamba.py`` with its pytree: ``embed``,
``final_norm`` and ``layers/{norm, ssm/...}``, every leaf under ``layers``
stacked ``(L, ...)``. Its ``lax.scan`` over layers is a Python loop here.
``train_loss`` is the reference's chunked cross-entropy against the tied
embedding.

The cache is ``{"pos": int, "conv": (L, B, K-1, C), "state": (L, B, H, P, N)
fp32}``, O(1) in sequence length. ``decode_step`` writes each layer's new
conv window and state into the cache **in place** and returns the same
tensors, where the JAX package returns fresh arrays; a caller that needs
the old cache clones it first.

As in the reference, ``forward_hidden`` gathers each layer's FSDP-sharded
weights (``gather_fsdp``) and constrains the embeddings and each layer's
output (``shard_activations``); off a mesh these return their input.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import gather_fsdp, shard_activations, take_rows
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.common import (
    cross_entropy_chunked,
    embed_init,
    layer_params,
    logits_f32,
    rms_norm,
    torch_dtype,
)

Params = dict[str, Any]


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter pytree's leaves as ``(shape, dtype name)`` pairs."""
    L, D, dt = cfg.n_layers, cfg.d_model, cfg.param_dtype
    return {
        "embed": ((cfg.vocab_size, D), dt),
        "final_norm": ((D,), dt),
        "layers": {
            "norm": ((L, D), dt),
            "ssm": ssd_mod.ssm_param_specs(cfg, L),
        },
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random weights drawn on ``device``: the JAX package's distribution, not its bits."""
    dtype = torch_dtype(cfg.param_dtype)
    D = cfg.d_model
    embed = torch.empty((cfg.vocab_size, D), dtype=dtype, device=device)
    return {
        "embed": embed_init(embed, generator),
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
        "layers": {
            "norm": torch.zeros((cfg.n_layers, D), dtype=dtype, device=device),
            "ssm": ssd_mod.init_ssm_params(cfg, cfg.n_layers, generator, device, dtype),
        },
    }


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return take_rows(params["embed"], tokens).to(torch_dtype(cfg.dtype))


def _layer_fwd(cfg: ModelConfig, lp: Params, x: torch.Tensor):
    lp = gather_fsdp(lp, cfg.act_shard)
    with tracing.region("model.ssd"):
        out, cache = ssd_mod.mamba_block(cfg, lp["ssm"], rms_norm(x, lp["norm"], cfg.norm_eps))
    return shard_activations(x + out, cfg.act_shard), cache


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   collect_state: bool = False):
    """tokens: (B,S). Returns (hidden (B,S,D), per-layer ``SSMCache`` list or None).

    Without ``collect_state`` and with any ``cfg.remat`` but ``"none"``, each
    layer runs under ``torch.utils.checkpoint``, as the reference applies
    ``jax.checkpoint`` to its layer body.
    """
    x = shard_activations(_embed(cfg, params, tokens), cfg.act_shard)
    remat = cfg.remat != "none" and not collect_state
    caches = []
    for lp in layer_params(params["layers"]):
        if remat:
            x = checkpoint(_layer_fwd, cfg, lp, x, use_reentrant=False)[0]
            continue
        x, cache = _layer_fwd(cfg, lp, x)
        if collect_state:
            caches.append(cache)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), (caches if collect_state else None)


def train_loss(cfg: ModelConfig, params: Params,
               batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B,S), labels (B,S). Returns (scalar loss, metrics)."""
    hidden, _ = forward_hidden(cfg, params, batch["tokens"])
    with tracing.region("model.loss"):
        loss, metrics = cross_entropy_chunked(
            hidden, params["embed"], batch["labels"], chunk=cfg.xent_chunk,
            z_loss_weight=cfg.z_loss_weight,
        )
    metrics["loss"] = loss
    return loss, metrics


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    del max_len  # SSM state is O(1) in sequence length
    return {"pos": 0, **ssd_mod.init_ssm_cache(cfg, cfg.n_layers, batch, device,
                                               torch_dtype(cfg.dtype))}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int, **_) -> tuple[torch.Tensor, dict]:
    """Run the full prompt, build the decode cache. Returns (last-token logits, cache)."""
    del max_len
    hidden, caches = forward_hidden(cfg, params, tokens, collect_state=True)
    cache = {"pos": tokens.shape[1], **ssd_mod.stack_ssm_caches(caches)}
    return logits_f32(hidden[:, -1:, :], params["embed"]), cache


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1). Returns (logits (B,1,V) fp32, cache updated in place)."""
    x = _embed(cfg, params, tokens)
    for i, lp in enumerate(layer_params(params["layers"])):
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        with tracing.region("model.ssd"):
            out, new = ssd_mod.mamba_decode_step(
                cfg, lp["ssm"], h,
                ssd_mod.SSMCache(conv=cache["conv"][i], state=cache["state"][i]))
            cache["conv"][i].copy_(new.conv)
            cache["state"][i].copy_(new.state)
        x = x + out
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_f32(x, params["embed"]), {**cache, "pos": cache["pos"] + 1}
