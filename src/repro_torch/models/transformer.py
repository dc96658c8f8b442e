"""Decoder-only transformer LM, dense and hybrid families.

Parameters keep the JAX package's pytree: nested dicts of tensors, with every
leaf under ``params["layers"]`` stacked ``(L, ...)`` and weights laid out
``(in, out)`` and applied as ``x @ W``. The JAX package's ``lax.scan`` over
layers is a Python loop here.

The KV cache is ``{"pos": int, "k": (L, B, C, K, hd), "v": (L, B, C, K, hd)}``
as there, with a ring buffer (slot = pos % C) when ``cfg.sliding_window > 0``
(for the hybrid family, ``cfg.hybrid_attn_window``). A hybrid layer runs
windowed attention and a Mamba-2 block side by side on the same input,
``x + 0.5 * (attn + ssm)``, and its cache also carries ``conv``
``(L, B, K-1, C)`` and the fp32 SSD ``state`` ``(L, B, H, P, N)``.
``decode_step`` writes the new token's K/V, conv window and state into the
cache **in place** and returns the same tensors, where the JAX package
returns fresh arrays; a caller that needs the old cache clones it first.

``train_loss`` is the reference's: the chunked fp32 cross-entropy over the
final hidden states, with ``remat="full"`` checkpointing each layer and
``"none"`` keeping every activation; ``"dots"`` and ``scan_block > 0`` (no
config uses them) raise. Settings for many devices (``fsdp_gather``,
``act_shard``) are ignored: on one chip the reference's sharding
constraints are identity maps. MoE and VLM are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.common import (
    activation_fn,
    apply_rope,
    cross_entropy_chunked,
    dense_init,
    embed_init,
    layer_params,
    rms_norm,
    softcap,
    torch_dtype,
)

Params = dict[str, Any]

_LATER = {
    "moe": "a later slice (other model families)",
    "vlm": "a later slice (other model families)",
    "encdec": "a later slice (other model families)",
}


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for any family but dense and hybrid."""
    if cfg.family not in ("dense", "hybrid") or cfg.is_moe:
        family = "moe" if cfg.is_moe else cfg.family
        if family not in _LATER:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a transformer family")
        raise NotImplementedError(
            f"{cfg.name}: family {family!r} is not ported yet; it comes with "
            f"{_LATER[family]}")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> Params:
    """The parameter pytree's leaves as ``(shape, dtype name)`` pairs."""
    check_family(cfg)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    mlp = {"w_in": ((L, D, F), dt), "w_out": ((L, F, D), dt)}
    if cfg.gated_mlp():
        mlp["w_gate"] = ((L, D, F), dt)
    layers: Params = {
        "attn_norm": ((L, D), dt),
        "mlp_norm": ((L, D), dt),
        "attn": {"wq": ((L, D, cfg.q_dim), dt), "wk": ((L, D, cfg.kv_dim), dt),
                 "wv": ((L, D, cfg.kv_dim), dt), "wo": ((L, cfg.q_dim, D), dt)},
        "mlp": mlp,
    }
    if cfg.family == "hybrid":
        layers["ssm"] = ssd_mod.ssm_param_specs(cfg, L)
    specs: Params = {
        "embed": ((cfg.vocab_size, D), dt),
        "final_norm": ((D,), dt),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ((cfg.vocab_size, D), dt)
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random weights drawn directly on ``device`` (``generator`` lives there).

    Truncated normal at ±3σ with fan-in σ, the ``wo``/``w_out`` output
    scales, N(0, 0.02) embeddings and zero norm gains — the JAX package's
    distribution, not its bits. Drawn layer by layer, so the fp32 scratch
    is one layer's matrix at a time.
    """
    dtype = torch_dtype(cfg.param_dtype)
    specs = param_specs(cfg)
    L = cfg.n_layers
    out_scale = {
        "wo": 1.0 / (cfg.q_dim ** 0.5 * L ** 0.5),
        "w_out": 1.0 / (cfg.d_ff ** 0.5 * L ** 0.5),
    }

    def empty(shape):
        return torch.empty(shape, dtype=dtype, device=device)

    layers: Params = {
        "attn_norm": torch.zeros(specs["layers"]["attn_norm"][0], dtype=dtype, device=device),
        "mlp_norm": torch.zeros(specs["layers"]["mlp_norm"][0], dtype=dtype, device=device),
    }
    for group in ("attn", "mlp"):
        layers[group] = {}
        for name, (shape, _) in specs["layers"][group].items():
            w = empty(shape)
            for i in range(L):
                dense_init(w[i], generator, scale=out_scale.get(name))
            layers[group][name] = w
    params: Params = {
        "embed": embed_init(empty(specs["embed"][0]), generator),
        "final_norm": torch.zeros(specs["final_norm"][0], dtype=dtype, device=device),
        "layers": layers,
    }
    if cfg.family == "hybrid":
        layers["ssm"] = ssd_mod.init_ssm_params(cfg, L, generator, device, dtype)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(empty(specs["unembed"][0]), generator)
    return params


def unembed_matrix(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


# ----------------------------------------------------------------------------
# forward (train / prefill)
# ----------------------------------------------------------------------------

def _attn_branch(cfg: ModelConfig, lp: Params, h: torch.Tensor,
                 positions: torch.Tensor, window: int | None = None):
    """Returns (attn_out (B,S,D), k (B,S,K,hd), v (B,S,K,hd))."""
    B, S, _ = h.shape
    q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, cfg, causal=True, window=window)
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


def _layer_fwd(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor):
    """One block. Returns (x, k, v, ssm cache or None)."""
    hybrid = cfg.family == "hybrid"
    window = cfg.hybrid_attn_window if hybrid else None
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    attn_out, k, v = _attn_branch(cfg, lp["attn"], h, positions, window=window)
    ssm_cache = None
    if hybrid:
        ssm_out, ssm_cache = ssd_mod.mamba_block(cfg, lp["ssm"], h)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp_branch(cfg, lp["mlp"], h2), k, v, ssm_cache


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, collect_kv: bool = False):
    """tokens: (B,S) integer. Returns (hidden (B,S,D), kv or None).

    ``kv`` is ``(k, v, ssm)``: k and v stacked ``(L, B, S, K, hd)``, and for
    the hybrid family the per-layer ``SSMCache`` list (else None). Without
    ``collect_kv`` and with ``cfg.remat == "full"``, each layer runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward rather than kept, as the reference's ``jax.checkpoint``.
    """
    check_family(cfg)
    x = _embed(cfg, params, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    remat = cfg.remat == "full" and not collect_kv
    ks, vs, ssm = [], [], []
    for lp in layer_params(params["layers"]):
        if remat:
            x = checkpoint(_layer_fwd, cfg, lp, x, positions, use_reentrant=False)[0]
            continue
        x, k, v, ssm_cache = _layer_fwd(cfg, lp, x, positions)
        if collect_kv:
            ks.append(k)
            vs.append(v)
            if ssm_cache is not None:
                ssm.append(ssm_cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs), ssm or None) if collect_kv else None
    return x, kv


def train_loss(cfg: ModelConfig, params: Params,
               batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B,S), labels (B,S). Returns (scalar loss, metrics)."""
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"{cfg.name}: remat={cfg.remat!r} is not ported "
                                  "(no config uses it); use 'full' or 'none'")
    if cfg.scan_block:
        raise NotImplementedError(f"{cfg.name}: scan_block={cfg.scan_block} (the two-level "
                                  "layer scan) is not ported; no config uses it")
    hidden, _ = forward_hidden(cfg, params, batch["tokens"])
    loss, metrics = cross_entropy_chunked(
        hidden, unembed_matrix(cfg, params), batch["labels"],
        chunk=cfg.xent_chunk, z_loss_weight=cfg.z_loss_weight,
        logits_softcap=cfg.logits_softcap,
    )
    metrics["loss"] = loss
    return loss, metrics


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
    L = cfg.n_layers
    shape = (L, batch, C, cfg.n_kv_heads, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    cache = {
        "pos": 0,
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
    if cfg.family == "hybrid":
        cache.update(ssd_mod.init_ssm_cache(cfg, L, batch, device, dtype))
    return cache


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the full prompt, build the decode cache. Returns (last-token logits, cache)."""
    B, S = tokens.shape
    hidden, (k_all, v_all, ssm) = forward_hidden(cfg, params, tokens, collect_kv=True)
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
    if ssm is not None:
        cache.update(ssd_mod.stack_ssm_caches(ssm))
    return _logits(cfg, params, hidden[:, -1:, :]), cache


def _decode_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, lcache: dict,
                  pos: int, valid: torch.Tensor) -> torch.Tensor:
    """One layer for one new token; writes its cache entries in place.

    ``lcache`` holds this layer's views of the stacked cache: ``k``/``v``
    and, for the hybrid family, ``conv``/``state``.
    """
    B = x.shape[0]
    k_cache, v_cache = lcache["k"], lcache["v"]
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
    attn_out = o.reshape(B, 1, cfg.q_dim) @ lp["attn"]["wo"]
    if cfg.family == "hybrid":
        ssm_in = ssd_mod.SSMCache(conv=lcache["conv"], state=lcache["state"])
        ssm_out, ssm_new = ssd_mod.mamba_decode_step(cfg, lp["ssm"], h, ssm_in)
        lcache["conv"].copy_(ssm_new.conv)
        lcache["state"].copy_(ssm_new.state)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _mlp_branch(cfg, lp["mlp"], h2)


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1). Returns (logits (B,1,V) fp32, cache).

    The cache's tensors are updated in place; the returned dict holds them
    and the advanced position.
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
    names = [n for n in ("k", "v", "conv", "state") if n in cache]
    for i, lp in enumerate(layer_params(params["layers"])):
        x = _decode_layer(cfg, lp, x, {n: cache[n][i] for n in names}, pos, valid)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _logits(cfg, params, x), new_cache
