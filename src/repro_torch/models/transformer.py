"""Decoder-only transformer LM, dense family.

Parameters keep the JAX package's pytree: nested dicts of tensors, with every
leaf under ``params["layers"]`` stacked ``(L, ...)`` and weights laid out
``(in, out)`` and applied as ``x @ W``. The JAX package's ``lax.scan`` over
layers is a Python loop here.

The KV cache is ``{"pos": int, "k": (L, B, C, K, hd), "v": (L, B, C, K, hd)}``
as there, with a ring buffer (slot = pos % C) when ``cfg.sliding_window > 0``.
``decode_step`` writes the new token's K/V into the cache **in place** and
returns the same tensors, where the JAX package returns fresh arrays; a
caller that needs the old cache clones it first.

Settings for training or for many devices (``remat``, ``scan_block``,
``fsdp_gather``, ``act_shard``) are ignored: on one chip the reference's
sharding constraints are identity maps. Only the dense family is ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.common import (
    activation_fn,
    apply_rope,
    dense_init,
    embed_init,
    rms_norm,
    softcap,
)

Params = dict[str, Any]

_LATER = {
    "moe": "a later slice (other model families)",
    "vlm": "a later slice (other model families)",
    "encdec": "a later slice (other model families)",
    "hybrid": "slice 4 (the SSD scan with mamba2 and hymba)",
    "ssm": "slice 4 (the SSD scan with mamba2 and hymba)",
}


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for any family but dense."""
    if cfg.family != "dense" or cfg.is_moe:
        family = "moe" if cfg.is_moe else cfg.family
        if family not in _LATER:
            raise ValueError(f"unknown family {cfg.family!r}")
        raise NotImplementedError(
            f"{cfg.name}: family {family!r} is not ported yet; it comes with "
            f"{_LATER[family]}")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``, ...)."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter pytree's leaf shapes (layers stacked on dim 0)."""
    check_family(cfg)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    mlp = {"w_in": (L, D, F), "w_out": (L, F, D)}
    if cfg.gated_mlp():
        mlp["w_gate"] = (L, D, F)
    shapes: Params = {
        "embed": (cfg.vocab_size, D),
        "final_norm": (D,),
        "layers": {
            "attn_norm": (L, D),
            "mlp_norm": (L, D),
            "attn": {"wq": (L, D, cfg.q_dim), "wk": (L, D, cfg.kv_dim),
                     "wv": (L, D, cfg.kv_dim), "wo": (L, cfg.q_dim, D)},
            "mlp": mlp,
        },
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab_size, D)
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random weights drawn directly on ``device`` (``generator`` lives there).

    Truncated normal at ±3σ with fan-in σ, the ``wo``/``w_out`` output
    scales, N(0, 0.02) embeddings and zero norm gains — the JAX package's
    distribution, not its bits. Drawn layer by layer, so the fp32 scratch
    is one layer's matrix at a time.
    """
    dtype = torch_dtype(cfg.param_dtype)
    shapes = param_shapes(cfg)
    L = cfg.n_layers
    out_scale = {
        "wo": 1.0 / (cfg.q_dim ** 0.5 * L ** 0.5),
        "w_out": 1.0 / (cfg.d_ff ** 0.5 * L ** 0.5),
    }

    def empty(shape):
        return torch.empty(shape, dtype=dtype, device=device)

    layers: Params = {
        "attn_norm": torch.zeros(shapes["layers"]["attn_norm"], dtype=dtype, device=device),
        "mlp_norm": torch.zeros(shapes["layers"]["mlp_norm"], dtype=dtype, device=device),
    }
    for group in ("attn", "mlp"):
        layers[group] = {}
        for name, shape in shapes["layers"][group].items():
            w = empty(shape)
            for i in range(L):
                dense_init(w[i], generator, scale=out_scale.get(name))
            layers[group][name] = w
    params: Params = {
        "embed": embed_init(empty(shapes["embed"]), generator),
        "final_norm": torch.zeros(shapes["final_norm"], dtype=dtype, device=device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(empty(shapes["unembed"]), generator)
    return params


def unembed_matrix(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _layer(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters as views into the stacked tensors."""
    return {name: (_layer(sub, i) if isinstance(sub, dict) else sub[i])
            for name, sub in layers.items()}


# ----------------------------------------------------------------------------
# forward (prefill)
# ----------------------------------------------------------------------------

def _attn_branch(cfg: ModelConfig, lp: Params, h: torch.Tensor,
                 positions: torch.Tensor):
    """Returns (attn_out (B,S,D), k (B,S,K,hd), v (B,S,K,hd))."""
    B, S, _ = h.shape
    q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, cfg, causal=True)
    return o.reshape(B, S, cfg.q_dim) @ lp["wo"], k, v


def _mlp_branch(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    if cfg.gated_mlp():
        mid = act(h @ lp["w_gate"]) * (h @ lp["w_in"])
    else:
        mid = act(h @ lp["w_in"])
    return mid @ lp["w_out"]


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.scale_embeddings:
        # the scale rounded to the activation dtype first, as the reference
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, collect_kv: bool = False):
    """tokens: (B,S) integer. Returns (hidden (B,S,D), kv or None).

    ``kv`` is ``(k, v)``, each stacked ``(L, B, S, K, hd)``.
    """
    check_family(cfg)
    x = _embed(cfg, params, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        attn_out, k, v = _attn_branch(cfg, lp["attn"], h, positions)
        x = x + attn_out
        h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp_branch(cfg, lp["mlp"], h2)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kv


def _logits(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    # fp32 logits against an fp32 copy of the unembedding, as the reference
    logits = hidden.float() @ unembed_matrix(cfg, params).float().T
    return softcap(logits, cfg.logits_softcap)


# ----------------------------------------------------------------------------
# KV cache / decode
# ----------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    window = cfg.hybrid_attn_window if cfg.family == "hybrid" else cfg.sliding_window
    return min(window, max_len) if window and window > 0 else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    check_family(cfg)
    C = cache_len(cfg, max_len)
    shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {
        "pos": 0,
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the full prompt, build the decode cache. Returns (last-token logits, cache)."""
    B, S = tokens.shape
    hidden, (k_all, v_all) = forward_hidden(cfg, params, tokens, collect_kv=True)
    C = cache_len(cfg, max_len)
    if S >= C:
        # ring layout: slot = pos % C. Roll so absolute position p sits at p % C.
        shift = S % C
        k_cache = torch.roll(k_all[:, :, S - C:], shift, dims=2)
        v_cache = torch.roll(v_all[:, :, S - C:], shift, dims=2)
    else:
        pad = (0, 0, 0, 0, 0, C - S)
        k_cache = torch.nn.functional.pad(k_all, pad)
        v_cache = torch.nn.functional.pad(v_all, pad)
    cache = {"pos": S, "k": k_cache.contiguous(), "v": v_cache.contiguous()}
    return _logits(cfg, params, hidden[:, -1:, :]), cache


def _decode_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: int, valid: torch.Tensor) -> torch.Tensor:
    """One layer for one new token; writes its K/V into the cache in place."""
    B = x.shape[0]
    C = k_cache.shape[1]
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    pos_b = torch.full((B, 1), pos, device=x.device)
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    slot = pos % C
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = decode_attention(q, k_cache, v_cache, valid,
                         logit_softcap=cfg.attn_logit_softcap)
    x = x + o.reshape(B, 1, cfg.q_dim) @ lp["attn"]["wo"]
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp_branch(cfg, lp["mlp"], h2)


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1). Returns (logits (B,1,V) fp32, cache).

    The cache's K/V tensors are updated in place; the returned dict holds
    them and the advanced position.
    """
    check_family(cfg)
    x = _embed(cfg, params, tokens)
    B = x.shape[0]
    pos = cache["pos"]
    C = cache["k"].shape[2]
    if pos >= C:
        valid = torch.ones((B, C), dtype=torch.bool, device=x.device)
    else:
        valid = (torch.arange(C, device=x.device) <= pos)[None, :].expand(B, C)
    for i in range(cfg.n_layers):
        x = _decode_layer(cfg, _layer(params["layers"], i), x,
                          cache["k"][i], cache["v"][i], pos, valid)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _logits(cfg, params, x), new_cache
