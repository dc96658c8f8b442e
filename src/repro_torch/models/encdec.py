"""Encoder-decoder transformer (whisper-style backbone).

The JAX package's ``models/encdec.py`` with its pytree: ``embed`` (tied
with the output), ``enc_layers/{attn_norm, attn, mlp_norm, mlp}``,
``dec_layers/{attn_norm, attn, cross_norm, cross, mlp_norm, mlp}``,
``enc_norm`` and ``final_norm``, every layer leaf stacked ``(L, ...)``.

The audio frontend is a stub, as there: callers pass precomputed frame
embeddings ``embeds`` (B, S_enc, D). Positions are sinusoidal, added to the
frames and to the token embeddings; ``decode_step`` computes the row at its
position from the position itself. The encoder's self-attention and the
decoder's cross-attention are non-causal, the decoder's self-attention
causal; with ``use_pallas`` all three reach the flash kernel in prefill.
Decode attends through ``decode_attention``, to the cross K/V with an
all-true mask.

The cache is ``{"pos": int, "k"/"v": (L, B, max_len, K, hd), "cross_k"/
"cross_v": (L, B, S_enc, K, hd)}``; ``decode_step`` writes the new token's
K/V into it **in place** and returns the same tensors. As in the
reference, each encoder and decoder layer of the full sequence gathers its
FSDP-sharded weights (``gather_fsdp``) and constrains its output
(``shard_activations``); off a mesh these return their input.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (
    gather_fsdp,
    merge_last,
    shard_activations,
    split_last,
    take_rows,
)
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.common import (
    activation_fn,
    cross_entropy_chunked,
    dense_init,
    embed_init,
    layer_params,
    rms_norm,
    sinusoid,
    sinusoid_inv_freq,
    sinusoidal_positions,
    torch_dtype,
)

Params = dict[str, Any]
_ATTN = ("wq", "wk", "wv", "wo")


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter pytree's leaves as ``(shape, dtype name)`` pairs."""
    D, F, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype

    def attn(L):
        return {"wq": ((L, D, cfg.q_dim), dt), "wk": ((L, D, cfg.kv_dim), dt),
                "wv": ((L, D, cfg.kv_dim), dt), "wo": ((L, cfg.q_dim, D), dt)}

    def layers(L, cross):
        out = {"attn_norm": ((L, D), dt), "attn": attn(L),
               "mlp_norm": ((L, D), dt),
               "mlp": {"w_in": ((L, D, F), dt), "w_out": ((L, F, D), dt)}}
        if cross:
            out.update(cross_norm=((L, D), dt), cross=attn(L))
        return out

    return {
        "embed": ((cfg.vocab_size, D), dt),
        "enc_layers": layers(cfg.n_encoder_layers, cross=False),
        "dec_layers": layers(cfg.n_layers, cross=True),
        "enc_norm": ((D,), dt),
        "final_norm": ((D,), dt),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random weights on ``device``: fan-in truncated normals (no output
    scales, as the reference's encoder-decoder), N(0, 0.02) embeddings and
    zero norm gains; the JAX package's distribution, not its bits."""
    dtype = torch_dtype(cfg.param_dtype)

    def fill(specs):
        out = {}
        for name, spec in specs.items():
            if isinstance(spec, dict):
                out[name] = fill(spec)
                continue
            w = torch.zeros(spec[0], dtype=dtype, device=device)
            if name in _ATTN or name in ("w_in", "w_out"):
                for i in range(w.shape[0]):
                    dense_init(w[i], generator)
            out[name] = w
        return out

    params = fill(param_specs(cfg))
    embed_init(params["embed"], generator)
    return params


def _self_attn(cfg: ModelConfig, lp: Params, h: torch.Tensor, *, causal: bool):
    q = split_last(h @ lp["wq"], cfg.n_heads, cfg.head_dim)
    k = split_last(h @ lp["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = split_last(h @ lp["wv"], cfg.n_kv_heads, cfg.head_dim)
    o = attention(q, k, v, cfg, causal=causal, window=0)
    return merge_last(o) @ lp["wo"], k, v


def _cross_attn(cfg: ModelConfig, lp: Params, h: torch.Tensor,
                enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    q = split_last(h @ lp["wq"], cfg.n_heads, cfg.head_dim)
    o = attention(q, enc_k, enc_v, cfg, causal=False, window=0)
    return merge_last(o) @ lp["wo"]


def _mlp(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    return activation_fn(cfg.activation)(h @ lp["w_in"]) @ lp["w_out"]


def _kv(cfg: ModelConfig, lp: Params, enc_out: torch.Tensor):
    """One decoder layer's cross K/V of the encoder output, (B, S_enc, K, hd) each."""
    B, Se, _ = enc_out.shape
    k = split_last(enc_out @ lp["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = split_last(enc_out @ lp["wv"], cfg.n_kv_heads, cfg.head_dim)
    return k, v


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed embeddings (stub frontend)."""
    dtype = torch_dtype(cfg.dtype)
    S = frames.shape[1]
    x = frames.to(dtype) + sinusoidal_positions(S, cfg.d_model, frames.device).to(dtype)[None]
    for lp in layer_params(params["enc_layers"]):
        lp = gather_fsdp(lp, cfg.act_shard)
        o, _, _ = _self_attn(cfg, lp["attn"], rms_norm(x, lp["attn_norm"], cfg.norm_eps),
                             causal=False)
        x = x + o
        x = x + _mlp(cfg, lp["mlp"], rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
        x = shard_activations(x, cfg.act_shard)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_kv(cfg: ModelConfig, dec_layers: Params, enc_out: torch.Tensor):
    """Per-decoder-layer cross K/V of the encoder output, each (L, B, S_enc, K, hd)."""
    kv = [_kv(cfg, lp["cross"], enc_out) for lp in layer_params(dec_layers)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def _dec_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, enc_out: torch.Tensor):
    """One decoder block of the full sequence. Returns (x, k, v)."""
    lp = gather_fsdp(lp, cfg.act_shard)
    o, k, v = _self_attn(cfg, lp["attn"], rms_norm(x, lp["attn_norm"], cfg.norm_eps),
                         causal=True)
    x = x + o
    hc = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
    x = x + _cross_attn(cfg, lp["cross"], hc, *_kv(cfg, lp["cross"], enc_out))
    x = x + _mlp(cfg, lp["mlp"], rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    return shard_activations(x, cfg.act_shard), k, v


def decode_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 enc_out: torch.Tensor, collect_kv: bool = False):
    """The decoder over the whole sequence. Returns (hidden, (k, v) stacked
    ``(L, B, S, K, hd)`` or None). Each layer is checkpointed unless
    ``cfg.remat == "none"`` (or K/V are collected), as the reference's."""
    dtype = torch_dtype(cfg.dtype)
    S = tokens.shape[1]
    x = take_rows(params["embed"], tokens).to(dtype)
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(dtype)[None]
    remat = cfg.remat != "none" and not collect_kv
    ks, vs = [], []
    for lp in layer_params(params["dec_layers"]):
        if remat:
            x = checkpoint(_dec_layer, cfg, lp, x, enc_out, use_reentrant=False)[0]
            continue
        x, k, v = _dec_layer(cfg, lp, x, enc_out)
        ks.append(k)
        vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return rms_norm(x, params["final_norm"], cfg.norm_eps), kv


def train_loss(cfg: ModelConfig, params: Params,
               batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """batch: embeds (B,S_enc,D) stub audio frames, tokens/labels (B,S)."""
    enc_out = encode(cfg, params, batch["embeds"])
    hidden, _ = decode_train(cfg, params, batch["tokens"], enc_out)
    loss, metrics = cross_entropy_chunked(
        hidden, params["embed"], batch["labels"], chunk=cfg.xent_chunk,
        z_loss_weight=cfg.z_loss_weight,
    )
    metrics["loss"] = loss
    return loss, metrics


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dtype = torch_dtype(cfg.dtype)

    def zeros(S):
        return torch.zeros((L, batch, S, K, hd), dtype=dtype, device=device)

    return {"pos": 0, "k": zeros(max_len), "v": zeros(max_len),
            "cross_k": zeros(cfg.encoder_seq_len), "cross_v": zeros(cfg.encoder_seq_len)}


def _logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    # fp32 logits against an fp32 copy of the tied embedding, as the reference
    return hidden.float() @ params["embed"].float().T


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, max_len: int,
            *, embeds: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Encode ``embeds``, run the prompt, build the decode cache. Returns
    (last-token logits, cache)."""
    B, S = tokens.shape
    enc_out = encode(cfg, params, embeds)
    hidden, (k_all, v_all) = decode_train(cfg, params, tokens, enc_out, collect_kv=True)
    pad = (0, 0, 0, 0, 0, max_len - S)
    ck, cv = _enc_kv(cfg, params["dec_layers"], enc_out)
    cache = {"pos": S, "k": torch.nn.functional.pad(k_all, pad).contiguous(),
             "v": torch.nn.functional.pad(v_all, pad).contiguous(),
             "cross_k": ck, "cross_v": cv}
    return _logits(params, hidden[:, -1:, :]), cache


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1). Returns (logits (B,1,V) fp32, cache).

    The cache's self-attention K/V are updated in place; the returned dict
    holds them and the advanced position.
    """
    dtype = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    pos = cache["pos"]
    x = take_rows(params["embed"], tokens).to(dtype)
    # sinusoidal position embedding at position `pos`
    ang = torch.tensor(pos, dtype=torch.float32) * sinusoid_inv_freq(cfg.d_model)
    x = x + sinusoid(ang).to(x.device, dtype)[None, None, :]
    C = cache["k"].shape[2]
    valid = (torch.arange(C, device=x.device) <= pos)[None, :].expand(B, C)
    Se = cache["cross_k"].shape[2]
    valid_c = torch.ones((B, Se), dtype=torch.bool, device=x.device)
    for i, lp in enumerate(layer_params(params["dec_layers"])):
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        a = lp["attn"]
        q = split_last(h @ a["wq"], cfg.n_heads, cfg.head_dim)
        k_cache[:, pos] = split_last(h @ a["wk"], cfg.n_kv_heads, cfg.head_dim)[:, 0]
        v_cache[:, pos] = split_last(h @ a["wv"], cfg.n_kv_heads, cfg.head_dim)[:, 0]
        o = decode_attention(q, k_cache, v_cache, valid, head_shard=cfg.act_shard)
        x = x + merge_last(o) @ a["wo"]
        hc = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
        qc = split_last(hc @ lp["cross"]["wq"], cfg.n_heads, cfg.head_dim)
        oc = decode_attention(qc, cache["cross_k"][i], cache["cross_v"][i], valid_c,
                              head_shard=cfg.act_shard)
        x = x + merge_last(oc) @ lp["cross"]["wo"]
        x = x + _mlp(cfg, lp["mlp"], rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _logits(params, x), new_cache
