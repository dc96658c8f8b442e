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

**Layer kinds** (``cfg.layer_kinds``): each layer's mixer is attention
("A"), the hybrid's Mamba-2 block alone ("M"), or both ("H", every layer
of the hybrid family); a layer pattern (``cfg.layer_pattern``, granite's
``MMMMMAMMMM``) mixes the first two in one stack. The attention leaves
are stacked over the layers that attend and the ``ssm`` leaves over those
that run a Mamba-2 block; a layer takes each mixer from its stack at its
rank among those layers (norms and FFN are stacked over all). So is the
cache: ``k``/``v`` ``(L_A, ...)`` and ``conv``/``state`` ``(L_M, ...)``.
Without a pattern every rank is the layer's index. The port's own
multipliers sit where granite's modelling code has them: the embeddings
times ``embedding_multiplier``, each branch times ``residual_multiplier``
as it joins the stream, the logits divided by ``logits_scaling``; a score
scale of its own (``attention_multiplier``) is folded into q, since every
attention path divides by ``sqrt(head_dim)`` (in bf16 this rounds q a
second time); ``rope_theta = 0`` is no positional embedding (``apply_rope``
returns its input). At their defaults none of them issues an operation.

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
    logits_f32,
    rms_norm,
    torch_dtype,
)

Params = dict[str, Any]

# what remat="dots" saves: matrix products with no batch dims
DOTS_SAVEABLE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

# a layer kind's mixer subtrees, and the cache entries of each
_MIXERS = {"A": ("attn",), "M": ("ssm",), "H": ("attn", "ssm")}
_CACHE = {"attn": ("k", "v"), "ssm": ("conv", "state")}


def _mixer_ranks(cfg: ModelConfig) -> list[dict[str, int]]:
    """Each layer's mixer subtrees (``cfg.layer_kinds``), each with the
    layer's rank among the layers that run that mixer."""
    seen = {"attn": 0, "ssm": 0}
    out = []
    for kind in cfg.layer_kinds:
        ranks = {}
        for name in _MIXERS[kind]:
            ranks[name] = seen[name]
            seen[name] += 1
        out.append(ranks)
    return out


def _mixer_counts(cfg: ModelConfig) -> tuple[int, int]:
    """How many layers attend and how many run a Mamba-2 block."""
    kinds = cfg.layer_kinds
    return sum(k in "AH" for k in kinds), sum(k in "MH" for k in kinds)


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter pytree's leaves as ``(shape, dtype name)`` pairs."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    n_attn, n_ssm = _mixer_counts(cfg)
    layers: Params = {
        "attn_norm": ((L, D), dt),
        "mlp_norm": ((L, D), dt),
    }
    if n_attn:
        A = n_attn
        layers["attn"] = {"wq": ((A, D, cfg.q_dim), dt), "wk": ((A, D, cfg.kv_dim), dt),
                          "wv": ((A, D, cfg.kv_dim), dt), "wo": ((A, cfg.q_dim, D), dt)}
    if cfg.is_moe:
        layers["moe"] = moe_mod.moe_param_specs(cfg, L)
    else:
        mlp = {"w_in": ((L, D, F), dt), "w_out": ((L, F, D), dt)}
        if cfg.gated_mlp():
            mlp["w_gate"] = ((L, D, F), dt)
        layers["mlp"] = mlp
    if n_ssm:
        layers["ssm"] = ssd_mod.ssm_param_specs(cfg, n_ssm)
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
        if group not in specs["layers"]:
            continue
        layers[group] = {}
        for name, (shape, _) in specs["layers"][group].items():
            w = empty(shape)
            for i in range(shape[0]):
                dense_init(w[i], generator, scale=out_scale.get(name))
            layers[group][name] = w
    params: Params = {
        "embed": embed_init(empty(specs["embed"][0]), generator),
        "final_norm": torch.zeros(specs["final_norm"][0], dtype=dtype, device=device),
        "layers": layers,
    }
    if cfg.is_moe:
        layers["moe"] = moe_mod.init_moe_params(cfg, L, generator, device, dtype)
    n_ssm = _mixer_counts(cfg)[1]
    if n_ssm:
        layers["ssm"] = ssd_mod.init_ssm_params(cfg, n_ssm, generator, device, dtype)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(empty(specs["unembed"][0]), generator)
    return params


def unembed_matrix(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _layer_views(cfg: ModelConfig, layers: Params) -> list[Params]:
    """Each layer's parameters as views into the stacks, each leaf
    ``unbind``-ed once as ``layer_params`` does: the norms and FFN at the
    layer's index, each mixer it runs at its rank among the layers that
    run that mixer."""
    per_key = {name: layer_params(sub) if isinstance(sub, dict) else sub.unbind(0)
               for name, sub in layers.items()}
    return [{name: views[ranks.get(name, i)] for name, views in per_key.items()
             if name not in _CACHE or name in ranks}
            for i, ranks in enumerate(_mixer_ranks(cfg))]


def _scaled_q(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """q with the config's own score scale folded in (module docstring)."""
    if not cfg.attention_multiplier:
        return q
    return q * (cfg.attention_multiplier * cfg.head_dim ** 0.5)


def _join(cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The residual stream ``x`` with the branch ``y`` joined to it, scaled by
    ``residual_multiplier`` where that is not 1 (one rounding)."""
    if cfg.residual_multiplier == 1.0:
        return x + y
    return torch.add(x, y, alpha=cfg.residual_multiplier)


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
        o = attention(_scaled_q(cfg, q), k, v, cfg, causal=True, window=window)
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
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
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
    """One block. Returns (x, aux (3,), k, v, ssm cache): k and v None in a
    layer without attention, the ssm cache None in one without a Mamba-2
    block. The layer's leaves say which mixers it runs (``_layer_views``)."""
    if cfg.fsdp_gather == "layer":
        lp = gather_fsdp(lp, cfg.act_shard)
    hybrid = cfg.family == "hybrid"
    window = cfg.hybrid_attn_window if hybrid else None
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    out = k = v = ssm_cache = None
    if "attn" in lp:
        out, k, v = _attn_branch(cfg, lp["attn"], h, positions, window=window)
    if "ssm" in lp:
        with tracing.region("model.ssd"):
            ssm_out, ssm_cache = ssd_mod.mamba_block(cfg, lp["ssm"], h)
        out = ssm_out if out is None else 0.5 * (out + ssm_out)
    # the row-parallel output projection leaves a partial sum: finish it here,
    # where GSPMD does, or DTensor carries it into the MLP and gathers w_in
    x = shard_activations(_join(cfg, x, out), cfg.act_shard)
    y, aux = _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    return shard_activations(_join(cfg, x, y), cfg.act_shard), aux, k, v, ssm_cache


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
    layers = _layer_views(cfg, layers)
    auxes, ks, vs, ssm = [], [], [], []
    L, G = cfg.n_layers, cfg.scan_block
    if collect_kv:
        for lp in layers:
            x, aux, k, v, ssm_cache = _layer_fwd(cfg, lp, x, positions)
            auxes.append(aux)
            if k is not None:
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
    kv = ((torch.stack(ks) if ks else None, torch.stack(vs) if vs else None, ssm or None)
          if collect_kv else None)
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
            logits_softcap=cfg.logits_softcap, logits_scaling=cfg.logits_scaling,
        )
    if cfg.is_moe:
        loss = loss + cfg.moe_aux_loss_weight * aux["moe_aux"] \
                    + cfg.router_z_loss_weight * aux["router_z"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


# ----------------------------------------------------------------------------
# KV cache / decode
# ----------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    window = cfg.hybrid_attn_window if cfg.family == "hybrid" else cfg.sliding_window
    return min(window, max_len) if window and window > 0 else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    C = cache_len(cfg, max_len)
    n_attn, n_ssm = _mixer_counts(cfg)
    shape = (n_attn, batch, C, cfg.n_kv_heads, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    cache: dict = {"pos": 0}
    if n_attn:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if n_ssm:
        cache.update(ssd_mod.init_ssm_cache(cfg, n_ssm, batch, device, dtype))
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
    cache: dict = {"pos": S}
    for name, t in (("k", k_all), ("v", v_all)):
        if t is None:
            continue
        if S >= C:
            # ring layout: slot = pos % C. Roll so absolute position p sits at p % C.
            cache[name] = _roll_seq(t[:, :, S - C:], S % C).contiguous()
        else:
            cache[name] = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, C - S)).contiguous()
    if ssm is not None:
        cache.update(ssd_mod.stack_ssm_caches(ssm))
    return logits_f32(hidden[:, -1:, :], unembed_matrix(cfg, params),
                      scaling=cfg.logits_scaling, cap=cfg.logits_softcap), cache


def _decode_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, lcache: dict,
                  pos: int, valid: torch.Tensor) -> torch.Tensor:
    """One layer for one new token; writes its cache entries in place.

    ``lcache`` holds this layer's views of the stacked cache: ``k``/``v``
    where it attends, ``conv``/``state`` where it runs a Mamba-2 block.
    """
    B = x.shape[0]
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    out = None
    if "attn" in lp:
        k_cache, v_cache = lcache["k"], lcache["v"]
        C = k_cache.shape[1]
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
            o = decode_attention(_scaled_q(cfg, q), k_cache, v_cache, valid,
                                 logit_softcap=cfg.attn_logit_softcap,
                                 head_shard=cfg.act_shard)
            out = merge_last(o) @ lp["attn"]["wo"]
    if "ssm" in lp:
        with tracing.region("model.ssd"):
            ssm_in = ssd_mod.SSMCache(conv=lcache["conv"], state=lcache["state"])
            ssm_out, ssm_new = ssd_mod.mamba_decode_step(cfg, lp["ssm"], h, ssm_in)
            lcache["conv"].copy_(ssm_new.conv)
            lcache["state"].copy_(ssm_new.state)
        out = ssm_out if out is None else 0.5 * (out + ssm_out)
    x = _join(cfg, x, out)
    y, _ = _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
    return _join(cfg, x, y)


def _layer_caches(cfg: ModelConfig, cache: dict):
    """Each layer's views of the stacked cache (``_decode_layer``), layer by
    layer: each mixer's entries at the layer's rank among its layers."""
    return ({n: cache[n][rank] for name, rank in ranks.items() for n in _CACHE[name]}
            for ranks in _mixer_ranks(cfg))


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1). Returns (logits (B,1,V) fp32, cache).

    The cache's tensors are updated in place; the returned dict holds them
    and the advanced position.
    """
    x = _embed(cfg, params, tokens)
    B = x.shape[0]
    pos = cache["pos"]
    valid = None
    if "k" in cache:
        C = cache["k"].shape[2]
        if pos >= C:
            valid = torch.ones((B, C), dtype=torch.bool, device=x.device)
        else:
            valid = (torch.arange(C, device=x.device) <= pos)[None, :].expand(B, C)
    layers = _layer_views(cfg, params["layers"])
    for lp, lcache in zip(layers, _layer_caches(cfg, cache)):
        x = _decode_layer(cfg, lp, x, lcache, pos, valid)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits_f32(x, unembed_matrix(cfg, params), scaling=cfg.logits_scaling,
                      cap=cfg.logits_softcap), new_cache
