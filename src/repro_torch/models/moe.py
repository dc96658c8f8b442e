"""Mixture-of-Experts FFN: batched grouped dispatch (scatter) and combine (gather).

The JAX package's ``models/moe.py``. Tokens are split into groups of
``cfg.moe_group_size``, a batched leading dim (the last group padded with
zero rows); capacity per expert within a group is ``C = g * top_k *
capacity_factor / E``, at least ``top_k``. Overflow choices are dropped:
their combine weight is zero and the residual carries the token (GShard /
Switch semantics). ``aux``, ``z`` and ``dropped`` are means over groups.

Routing decisions equal the reference's exactly:

  * top-k is a stable descending sort, so ties go to the lower expert index
    as ``jax.lax.top_k`` gives them (``torch.topk`` promises no order
    among ties);
  * a choice's position in its expert's queue is an integer cumsum over
    choice-major rows (every token's first choice before any second one),
    where the reference sums fp32 one-hots, exact below 2**24.

Dispatch copies each kept choice's token row to row ``expert * C + slot``
of an ``(E*C + 1, D)`` buffer per group. A dropped choice goes to the last
row, a sink that is sliced off: the reference scatters it out of bounds
with ``mode="drop"``, which torch's indexed copies refuse. Combine gathers
each choice's expert output (row ``E*C``, all zeros, for a dropped one)
and sums them weighted by the gates. The expert FFNs are three batched
``einsum``s, as the reference's, which computes them outside any Pallas
kernel.

The reference's sharding constraints sit at its call sites: the groups
and the expert buffers shard their group dim over the data axes
(``shard_activations``), the expert intermediate its F dim over ``model``
(``shard_heads``). Off a mesh they return their input.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard_activations, shard_heads
from repro_torch.models.common import activation_fn, dense_init


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor          # load-balance loss (scalar)
    router_z_loss: torch.Tensor     # scalar
    dropped_fraction: torch.Tensor  # scalar


def _capacity(cfg: ModelConfig, group: int) -> int:
    c = int(group * cfg.experts_per_token * cfg.moe_capacity_factor / cfg.n_experts)
    return max(c, cfg.experts_per_token)


def _route_group(cfg: ModelConfig, router_logits: torch.Tensor, capacity: int):
    """router_logits: (..., g, E) fp32, each leading index a group of its own.

    Returns (expert_idx (..., g, k) int64, slot (..., g, k) int64, keep
    (..., g, k) bool, gates (..., g, k) fp32, aux, z, dropped (...)): all
    the scatter/gather dispatch needs.
    """
    g, E = router_logits.shape[-2:]
    lead = router_logits.shape[:-2]
    k = cfg.experts_per_token
    probs = torch.softmax(router_logits, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = sorted_p[..., :k], order[..., :k]           # (..., g, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(expert_idx, E)                                   # (..., g, k, E)
    # position in expert: choice-major priority (first choices fill first);
    # the running count walks the last dim of the (E, k*g) transpose (a scan
    # over a (k*g, E) tensor's first dim has E-wide parallelism on the card)
    flat = onehot.transpose(-3, -2).reshape(*lead, k * g, E)
    pos = torch.cumsum(flat.transpose(-2, -1), dim=-1).transpose(-2, -1) - flat
    pos = pos.reshape(*lead, k, g, E).transpose(-3, -2)
    slot = torch.gather(pos, -1, expert_idx[..., None])[..., 0]
    keep = slot < capacity

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    f_e = onehot.sum(-2).float().mean(-2)                               # fraction routed to e
    p_e = probs.mean(-2)
    aux = E * (f_e * p_e).sum(-1) / k
    z = torch.logsumexp(router_logits, dim=-1).square().mean(-1)
    dropped = 1.0 - keep.sum((-2, -1)) / (g * k)
    return expert_idx, slot, keep, gate_vals, aux, z, dropped


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, MoEMetrics]:
    """x: (T, D) -> (T, D). p: router (D,E) fp32, we_in/we_gate (E,D,F), we_out (E,F,D)."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, T)
    n = (T + g - 1) // g
    if n * g > T:
        x = F.pad(x, (0, 0, 0, n * g - T))
    # batched (not looped) groups; the group dim shards over the data axes
    xg = shard_activations(x.reshape(n, g, D), cfg.act_shard)
    C = _capacity(cfg, g)
    sink = E * C                                   # the per-group sink row

    # (n*g, D) @ (D, E): a product with no batch dims, as the reference's einsum
    logits = (x.float() @ p["router"].float()).reshape(n, g, E)
    expert_idx, slot, keep, gates, aux, z, dropped = _route_group(cfg, logits, C)
    # rows of the (n * (E*C + 1), D) buffer, group by group
    base = (torch.arange(n, device=x.device) * (sink + 1))[:, None, None]
    rows = (torch.where(keep, expert_idx * C + slot, sink) + base).reshape(-1)   # (n*g*k,)
    src = xg[:, :, None, :].expand(n, g, k, D).reshape(n * g * k, D)
    xe = x.new_zeros((n * (sink + 1), D)).index_copy(0, rows, src)
    xe = xe.reshape(n, sink + 1, D)[:, :sink].reshape(n, E, C, D)
    xe = shard_activations(xe, cfg.act_shard)

    # ---- expert FFNs (the only matmuls), batched over groups ----
    act = activation_fn(cfg.activation)
    h = torch.einsum("necd,edf->necf", xe, p["we_in"])
    if cfg.gated_mlp():
        h = act(torch.einsum("necd,edf->necf", xe, p["we_gate"])) * h
    else:
        h = act(h)
    h = shard_heads(h, cfg.act_shard, head_axis=3)                # F tensor-parallel
    ye = shard_activations(torch.einsum("necf,efd->necd", h, p["we_out"]), cfg.act_shard)

    ye_flat = torch.cat([ye.reshape(n, sink, D), ye.new_zeros((n, 1, D))], dim=1)
    y_tk = ye_flat.reshape(n * (sink + 1), D)[rows].reshape(n, g, k, D)
    w = (gates * keep.to(gates.dtype)).to(x.dtype)
    y = torch.einsum("ngk,ngkd->ngd", w, y_tk).reshape(n * g, D)[:T]
    return y, MoEMetrics(aux.mean(), z.mean(), dropped.mean())


def moe_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    """The stacked MoE leaves as ``(shape, dtype name)``; the router is fp32."""
    L, E, D, F_ = n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    specs = {"router": ((L, D, E), "float32"), "we_in": ((L, E, D, F_), dt),
             "we_out": ((L, E, F_, D), dt)}
    if cfg.gated_mlp():
        specs["we_gate"] = ((L, E, D, F_), dt)
    return specs


def init_moe_params(cfg: ModelConfig, n_layers: int, generator: torch.Generator,
                    device: torch.device, dtype: torch.dtype) -> dict:
    """Stacked ``(L, ...)`` MoE weights: the reference's fan-in truncated
    normals (its distribution, not its bits), drawn one expert matrix at a
    time so the fp32 scratch stays one (D, F) matrix."""
    out = {}
    for name, (shape, dt) in moe_param_specs(cfg, n_layers).items():
        w = torch.empty(shape, dtype=torch.float32 if dt == "float32" else dtype,
                        device=device)
        for i in range(n_layers):
            if name == "router":
                dense_init(w[i], generator)
                continue
            for e in range(cfg.n_experts):
                dense_init(w[i, e], generator)
        out[name] = w
    return out
