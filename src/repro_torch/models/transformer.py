"""Decoder-only transformer LM covering the dense / moe / vlm / hybrid families.

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

A MoE layer (``cfg.n_experts > 0``) runs ``moe.moe_ffn`` in place of the
MLP; its load-balance and router-z losses and dropped fraction are averaged
over layers (``forward_hidden``'s aux dict) and ``train_loss`` adds the two
losses, weighted, as the reference does. The VLM's stub frontend passes
``embeds`` (B, S, D) in place of tokens to ``forward_hidden``,
``train_loss`` (``batch["embeds"]``) and ``prefill``.

``train_loss`` is the reference's: the chunked fp32 cross-entropy over the
final hidden states. ``remat`` picks what a layer keeps for the backward:
``"none"`` everything; ``"full"`` its input only (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint``); ``"dots"`` the outputs of its matrix
products with no batch dims, ``aten.mm``/``aten.addmm``, recomputing the
rest, ``bmm`` included (a selective checkpoint, the reference's
``dots_with_no_batch_dims_saveable``). ``scan_block = G`` with ``0 < G <
L`` and ``L % G == 0`` adds an outer checkpoint over each block of G layers
(unless ``remat="none"``), the reference's two-level layer scan.

The reference's sharding constraints sit at its call sites: ``gather_fsdp``
of each layer's weights (``fsdp_gather="layer"``) or of the stacked ones
once (``"step"``), ``shard_activations`` of the embeddings and of each
layer's output, ``shard_heads`` of the MLP's intermediate, all under
``cfg.act_shard``. They redistribute DTensors inside a mesh made current
by ``dist.compat.use_mesh`` (the dry-run's) and return their input itself
anywhere else, so the one-card paths are unchanged.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (
    gather_fsdp,
    merge_last,
    shard_activations,
    shard_heads,
    split_last,
    take_rows,
)
from repro_torch.models import moe as moe_mod
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

# what remat="dots" saves: matrix products with no batch dims
DOTS_SAVEABLE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> Params:
    """The parameter pytree's leaves as ``(shape, dtype name)`` pairs."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    layers: Params = {
        "attn_norm": ((L, D), dt),
        "mlp_norm": ((L, D), dt),
        "attn": {"wq": ((L, D, cfg.q_dim), dt), "wk": ((L, D, cfg.kv_dim), dt),
                 "wv": ((L, D, cfg.kv_dim), dt), "wo": ((L, cfg.q_dim, D), dt)},
    }
    if cfg.is_moe:
        layers["moe"] = moe_mod.moe_param_specs(cfg, L)
    else:
        mlp = {"w_in": ((L, D, F), dt), "w_out": ((L, F, D), dt)}
        if cfg.gated_mlp():
            mlp["w_gate"] = ((L, D, F), dt)
        layers["mlp"] = mlp
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
    distribution, not its bits. Drawn layer by layer (expert by expert for
    MoE), so the fp32 scratch is one matrix at a time.
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
    for group in ("attn",) if cfg.is_moe else ("attn", "mlp"):
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
    if cfg.is_moe:
        layers["moe"] = moe_mod.init_moe_params(cfg, L, generator, device, dtype)
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
    with tracing.region("model.attention"):
        q = split_last(h @ lp["wq"], cfg.n_heads, cfg.head_dim)
        k = split_last(h @ lp["wk"], cfg.n_kv_heads, cfg.head_dim)
        v = split_last(h @ lp["wv"], cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attention(q, k, v, cfg, causal=True, window=window)
        return merge_last(o) @ lp["wo"], k, v


def _mlp_branch(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    if cfg.gated_mlp():
        mid = act(h @ lp["w_gate"]) * (h @ lp["w_in"])
    else:
        mid = act(h @ lp["w_in"])
    # (B, S, F) intermediate: F stays tensor-parallel (w_in col-parallel,
    # w_out row-parallel — the Megatron pattern, one all-reduce per layer)
    mid = shard_heads(mid, cfg.act_shard)
    return mid @ lp["w_out"]


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor | None,
           embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings, or the stub frontend's ``embeds`` (B, S, D)."""
    x = (take_rows(params["embed"], tokens) if embeds is None else embeds).to(
        torch_dtype(cfg.dtype))
    if cfg.scale_embeddings:
        # the scale rounded to the activation dtype first, as the reference
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def _ffn(cfg: ModelConfig, lp: Params, h2: torch.Tensor):
    """The MLP or, for MoE, the expert layer. Returns (y, aux (3,) fp32:
    load-balance loss, router z-loss, dropped fraction; zeros for an MLP)."""
    if not cfg.is_moe:
        with tracing.region("model.mlp"):
            return _mlp_branch(cfg, lp["mlp"], h2), torch.zeros(3, device=h2.device)
    B, S, D = h2.shape
    y, m = moe_mod.moe_ffn(cfg, lp["moe"], h2.reshape(B * S, D))
    return y.reshape(B, S, D), torch.stack(list(m))


def _layer_fwd(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor):
    """One block. Returns (x, aux (3,), k, v, ssm cache or None)."""
    if cfg.fsdp_gather == "layer":
        lp = gather_fsdp(lp, cfg.act_shard)
    hybrid = cfg.family == "hybrid"
    window = cfg.hybrid_attn_window if hybrid else None
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    attn_out, k, v = _attn_branch(cfg, lp["attn"], h, positions, window=window)
    ssm_cache = None
    if hybrid:
        with tracing.region("model.ssd"):
            ssm_out, ssm_cache = ssd_mod.mamba_block(cfg, lp["ssm"], h)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    # the row-parallel output projection leaves a partial sum: finish it here,
    # where GSPMD does, or DTensor carries it into the MLP and gathers w_in
    x = shard_activations(x, cfg.act_shard)
    y, aux = _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    return shard_activations(x + y, cfg.act_shard), aux, k, v, ssm_cache


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVEABLE
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``: as is ("none"), checkpointed ("full"), or
    checkpointed keeping the no-batch-dim matrix products ("dots")."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor | None,
                   *, embeds: torch.Tensor | None = None, collect_kv: bool = False):
    """tokens: (B,S) integer (or ``embeds`` (B,S,D) for stub frontends).

    Returns (hidden (B,S,D), aux dict, kv or None). ``aux`` holds the MoE
    layers' ``moe_aux``, ``router_z`` and ``dropped``, each a mean over
    layers (zeros for the other families). ``kv`` is ``(k, v, ssm)``: k and
    v stacked ``(L, B, S, K, hd)``, and for the hybrid family the
    per-layer ``SSMCache`` list (else None). Without ``collect_kv`` each
    layer runs under ``cfg.remat`` and ``cfg.scan_block``'s blocks (module
    docstring).
    """
    x = shard_activations(_embed(cfg, params, tokens, embeds), cfg.act_shard)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    layers = params["layers"]
    if cfg.fsdp_gather == "step":
        # ZeRO-2: gather the whole stacked weight set once per step
        layers = gather_fsdp(layers, cfg.act_shard)
    layers = layer_params(layers)
    auxes, ks, vs, ssm = [], [], [], []
    L, G = cfg.n_layers, cfg.scan_block
    if collect_kv:
        for lp in layers:
            x, aux, k, v, ssm_cache = _layer_fwd(cfg, lp, x, positions)
            auxes.append(aux)
            ks.append(k)
            vs.append(v)
            if ssm_cache is not None:
                ssm.append(ssm_cache)
    else:
        layer = _remat(cfg, _layer_fwd)

        def block(x, blk):
            out = []
            for lp in blk:
                x, aux = layer(cfg, lp, x, positions)[:2]
                out.append(aux)
            return x, out

        if 0 < G < L and L % G == 0:
            # two-level layer loop: the outer checkpoint keeps one input per
            # block of G layers; the (rematted) inner layers are recomputed
            # block by block in the backward
            outer = block if cfg.remat == "none" else functools.partial(
                checkpoint, block, use_reentrant=False)
            for b in range(0, L, G):
                x, out = outer(x, layers[b:b + G])
                auxes.extend(out)
        else:
            x, auxes = block(x, layers)
    aux = torch.stack(auxes).mean(0)
    aux_losses = {"moe_aux": aux[0], "router_z": aux[1], "dropped": aux[2]}
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs), ssm or None) if collect_kv else None
    return x, aux_losses, kv


def train_loss(cfg: ModelConfig, params: Params,
               batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B,S) or embeds (B,S,D), labels (B,S). Returns (scalar loss, metrics)."""
    hidden, aux, _ = forward_hidden(cfg, params, batch.get("tokens"),
                                    embeds=batch.get("embeds"))
    with tracing.region("model.loss"):
        loss, metrics = cross_entropy_chunked(
            hidden, unembed_matrix(cfg, params), batch["labels"],
            chunk=cfg.xent_chunk, z_loss_weight=cfg.z_loss_weight,
            logits_softcap=cfg.logits_softcap,
        )
    if cfg.is_moe:
        loss = loss + cfg.moe_aux_loss_weight * aux["moe_aux"] \
                    + cfg.router_z_loss_weight * aux["router_z"]
        metrics.update(aux)
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


def _roll_seq(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(x, shift, dims=2)`` as two slices joined: DTensor has no
    rule for ``roll`` in every release."""
    C = x.shape[2]
    return torch.cat([x[:, :, C - shift:], x[:, :, :C - shift]], dim=2)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, max_len: int,
            *, embeds: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Run the full prompt (``embeds`` in place of the tokens' embeddings
    when given), build the decode cache. Returns (last-token logits, cache)."""
    B, S = tokens.shape
    hidden, _, (k_all, v_all, ssm) = forward_hidden(cfg, params, tokens, embeds=embeds,
                                                    collect_kv=True)
    C = cache_len(cfg, max_len)
    if S >= C:
        # ring layout: slot = pos % C. Roll so absolute position p sits at p % C.
        shift = S % C
        k_cache = _roll_seq(k_all[:, :, S - C:], shift)
        v_cache = _roll_seq(v_all[:, :, S - C:], shift)
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
    with tracing.region("model.attention"):
        q = split_last(h @ lp["attn"]["wq"], cfg.n_heads, cfg.head_dim)
        k = split_last(h @ lp["attn"]["wk"], cfg.n_kv_heads, cfg.head_dim)
        v = split_last(h @ lp["attn"]["wv"], cfg.n_kv_heads, cfg.head_dim)
        pos_b = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k = apply_rope(k, pos_b, cfg.rope_theta)
        slot = pos % C
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
        o = decode_attention(q, k_cache, v_cache, valid,
                             logit_softcap=cfg.attn_logit_softcap, head_shard=cfg.act_shard)
        attn_out = merge_last(o) @ lp["attn"]["wo"]
    if cfg.family == "hybrid":
        with tracing.region("model.ssd"):
            ssm_in = ssd_mod.SSMCache(conv=lcache["conv"], state=lcache["state"])
            ssm_out, ssm_new = ssd_mod.mamba_decode_step(cfg, lp["ssm"], h, ssm_in)
            lcache["conv"].copy_(ssm_new.conv)
            lcache["state"].copy_(ssm_new.state)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    y, _ = _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    return x + y


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1). Returns (logits (B,1,V) fp32, cache).

    The cache's tensors are updated in place; the returned dict holds them
    and the advanced position.
    """
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
