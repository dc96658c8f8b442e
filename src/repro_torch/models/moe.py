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

**Served** (``_autograd_free``: autograd records nothing of the call and
every tensor is plain, as under ``greedy_generate``'s ``no_grad``), the
same function without the eager path's copies: the buffer is built
expert-major, ``(E, n*C, D)``, by one gather (``ops.moe_gather``), the
expert FFNs are ``torch.bmm`` on it in place (the products the einsums
issue after their permute), and one combine (``ops.moe_combine``) reads
the outputs back (``kernels/moe_dispatch.py``). On the CPU the kernels'
plain versions give the eager path's output bit for bit. Training (which
needs the eager path's backward), a routing span and a mesh keep the
eager path.

The reference's sharding constraints sit at its call sites: the groups
and the expert buffers shard their group dim over the data axes
(``shard_activations``), the expert intermediate its F dim over ``model``
(``shard_heads``). Off a mesh they return their input.

**A batch spread over ranks.** The reference routes the whole global batch
as one program. When the trainer steps over a process group, each rank
holds only its own shards' tokens, and a routing group may span shards on
several ranks. Inside :func:`routing_span` ``moe_ffn`` routes the global
batch as the reference does while each rank computes its own tokens only:

  * the span names the group, the global token count ``T`` and this
    rank's rows in the global flattened batch (the trainer's shards are
    spread over the ranks, so the rows need not be contiguous);
  * ``g = min(moe_group_size, T)`` and the capacity are the global batch's;
  * each rank writes its rows of the router logits into a zero ``(n*g, E)``
    fp32 buffer that is summed over the group (:class:`_SumOverGroup`,
    exact: each row has one non-zero contributor, and the pad rows stay
    ``0 @ router``); its backward is the same sum of the buffer's gradient;
  * every rank routes the whole buffer (so ``aux``, ``z`` and ``dropped``
    are the global means on every rank) and dispatches, runs the experts
    on and combines only its own tokens: an expert's output for a token
    depends on that token's row and on whether its choice was kept.

Every rank of the group must run every MoE layer, forward, backward and
any recompute, in the same order: a rank with no tokens of its own runs a
stand-in batch (``rows`` None) that writes nothing into the buffer and
keeps no choice. Without a span (one rank, serving, the dry-run) the code
path is the reference's.

**A shared expert** (``cfg.shared_d_ff > 0``, granite's): one gated MLP of
that width that every token passes through, its output added to the routed
experts' combined output. Its leaves ``shared_gate``, ``shared_in`` (D, Fs)
and ``shared_out`` (Fs, D) sit beside the experts'; it runs under the
``model.moe.shared`` region. Without it nothing is drawn or run.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard_activations, shard_heads, unsplit
from repro_torch.kernels import ops
from repro_torch.kernels.moe_dispatch import expert_major_rows
from repro_torch.models.common import activation_fn, dense_init


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor          # load-balance loss (scalar)
    router_z_loss: torch.Tensor     # scalar
    dropped_fraction: torch.Tensor  # scalar


class RoutingSpan(NamedTuple):
    """One step's global batch spread over the ranks of ``group``."""
    group: Any                   # the process group (None: the world)
    rows: torch.Tensor | None    # (T_local,) int64: this rank's tokens' rows in the
    #                              global flattened batch; None: a stand-in batch
    tokens: int                  # T, the global batch's token count


_SPAN: RoutingSpan | None = None


@contextlib.contextmanager
def routing_span(span: RoutingSpan | None):
    """``moe_ffn`` routes over ``span`` inside the block (None: as on one
    rank). A module global, not a context variable: the autograd engine
    runs the backward, and a checkpoint's recompute, on threads of its own,
    so the block must hold the backward as well as the forward."""
    global _SPAN
    before, _SPAN = _SPAN, span
    try:
        yield
    finally:
        _SPAN = before


class _SumOverGroup(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group`` in the forward and of the
    gradient in the backward: each rank's output, and so its part of the
    loss, reads every rank's input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


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


def _expert_ffn(cfg: ModelConfig, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """The expert FFNs (the only matmuls), batched over groups: (n, E, C, D) -> same."""
    act = activation_fn(cfg.activation)
    h = torch.einsum("necd,edf->necf", xe, p["we_in"])
    if cfg.gated_mlp():
        h = act(torch.einsum("necd,edf->necf", xe, p["we_gate"])) * h
    else:
        h = act(h)
    h = shard_heads(h, cfg.act_shard, head_axis=3)                # F tensor-parallel
    return shard_activations(torch.einsum("necf,efd->necd", h, p["we_out"]), cfg.act_shard)


def _dispatch_combine(cfg: ModelConfig, p: dict, x: torch.Tensor, route: tuple,
                      capacity: int, group: torch.Tensor, m: int,
                      buffer_of: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch, the expert FFNs and combine. x: (..., D) tokens; ``route``
    their (expert_idx, slot, keep, gates), each (..., k); ``group`` (...,
    or broadcastable) each token's group in the expert buffer of ``m``
    groups, which is ``buffer_of.new_zeros`` (default ``x``: on a mesh the
    buffer takes that tensor's placement). Returns (..., D): each token's
    gate-weighted expert outputs."""
    expert_idx, slot, keep, gates = route
    D, C = x.shape[-1], capacity
    sink = cfg.n_experts * C                       # the per-group sink row
    with tracing.region("model.moe.dispatch"):
        # rows of the (m * (E*C + 1), D) buffer, group by group
        rows = (torch.where(keep, expert_idx * C + slot, sink)
                + (group * (sink + 1))[..., None]).reshape(-1)
        src = x[..., None, :].expand(*keep.shape, D).reshape(-1, D)
        xe = (x if buffer_of is None else buffer_of).new_zeros((m * (sink + 1), D))
        xe = xe.index_copy(0, rows, src)
        xe = xe.reshape(m, sink + 1, D)[:, :sink].reshape(m, cfg.n_experts, C, D)
    with tracing.region("model.moe.experts"):
        ye = _expert_ffn(cfg, p, shard_activations(xe, cfg.act_shard))
    with tracing.region("model.moe.combine"):
        ye_flat = torch.cat([ye.reshape(m, sink, D), ye.new_zeros((m, 1, D))], dim=1)
        y_tk = ye_flat.reshape(m * (sink + 1), D)[rows].reshape(*keep.shape, D)
        w = (gates * keep.to(gates.dtype)).to(x.dtype)
        return torch.einsum("...k,...kd->...d", w, y_tk)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, MoEMetrics]:
    """x: (T, D) -> (T, D). p: router (D,E) fp32, we_in/we_gate (E,D,F), we_out (E,F,D),
    and the shared expert's leaves where ``cfg.shared_d_ff`` (module docstring)."""
    if _SPAN is not None:
        return _moe_ffn_spanned(cfg, p, x, _SPAN)
    T, D = x.shape
    E = cfg.n_experts
    g = min(cfg.moe_group_size, T)
    n = (T + g - 1) // g
    tokens = x
    if n * g > T:
        x = F.pad(x, (0, 0, 0, n * g - T))
    # batched (not looped) groups; the group dim shards over the data axes
    xg = shard_activations(x.reshape(n, g, D), cfg.act_shard)
    C = _capacity(cfg, g)

    with tracing.region("model.moe.route"):
        # (n*g, D) @ (D, E): a product with no batch dims, as the reference's einsum
        logits = (x.float() @ p["router"].float()).reshape(n, g, E)
        # at decode one group's tokens may span the devices of more than one
        # mesh dim: route the group whole there (its logits are a few KB); where
        # each device holds whole groups, as in training and prefill, these are
        # the logits themselves
        logits = unsplit(logits, 1)
        *route, aux, z, dropped = _route_group(cfg, logits, C)
    if _autograd_free(p, x):
        y = _dispatch_combine_served(cfg, p, xg, route, C, T)
    else:
        y = _dispatch_combine(cfg, p, xg, route, C, torch.arange(n, device=x.device)[:, None],
                              n, buffer_of=x).reshape(n * g, D)[:T]
    y = _with_shared(cfg, p, tokens, y)
    return y, MoEMetrics(aux.mean(), z.mean(), dropped.mean())


def _autograd_free(p: dict, x: torch.Tensor) -> bool:
    """True where autograd records nothing of this call and every tensor
    is plain (none a DTensor on a mesh): serving, whose ``greedy_generate``
    runs under ``no_grad``. Training needs the eager path's backward."""
    leaves = (x, *p.values())
    if any(type(t) is not torch.Tensor for t in leaves):
        return False
    return not torch.is_grad_enabled() or not any(t.requires_grad for t in leaves)


def _dispatch_combine_served(cfg: ModelConfig, p: dict, x: torch.Tensor, route: tuple,
                             capacity: int, T: int) -> torch.Tensor:
    """``_dispatch_combine`` of ``x`` (n, g, D), routed as ``route``'s
    (expert_idx, slot, keep, gates) (n, g, k), without autograd: the expert
    buffer built expert-major by one gather kernel, the expert GEMMs on it
    in place, the combine kernel reading their output straight back
    (``kernels/moe_dispatch.py``). Returns (T, D), the first T tokens'
    outputs: equal to the eager path's on the CPU (the kernels' plain
    versions), bit for bit but the combine's last bf16 ulp on the card."""
    expert_idx, slot, keep, gates = route
    n, g, D = x.shape
    E, k = cfg.n_experts, keep.shape[-1]
    with tracing.region("model.moe.dispatch"):
        rows, slot_token = expert_major_rows(expert_idx, slot, keep, capacity, E)
        xe = ops.moe_gather(x.reshape(n * g, D), slot_token).view(E, n * capacity, D)
    with tracing.region("model.moe.experts"):
        act = activation_fn(cfg.activation)
        h = torch.bmm(xe, p["we_in"])
        h = act(torch.bmm(xe, p["we_gate"])) * h if cfg.gated_mlp() else act(h)
        ye = torch.bmm(h, p["we_out"])
    with tracing.region("model.moe.combine"):
        w = (gates * keep.to(gates.dtype)).to(x.dtype)
        return ops.moe_combine(ye.view(E * n * capacity, D), rows.view(n * g, k)[:T],
                               w.view(n * g, k)[:T])


def _with_shared(cfg: ModelConfig, p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The routed experts' output ``y`` plus the shared expert's of ``x``
    (both (T, D)), where the config has one."""
    if not cfg.shared_d_ff:
        return y
    with tracing.region("model.moe.shared"):
        mid = activation_fn(cfg.activation)(x @ p["shared_gate"]) * (x @ p["shared_in"])
        return y + shard_heads(mid, cfg.act_shard) @ p["shared_out"]


def _moe_ffn_spanned(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     span: RoutingSpan) -> tuple[torch.Tensor, MoEMetrics]:
    """``moe_ffn`` of this rank's tokens ``x`` (T_local, D) as rows
    ``span.rows`` of the global batch (module docstring)."""
    n_local = x.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, span.tokens)
    n = (span.tokens + g - 1) // g
    C = _capacity(cfg, g)

    with tracing.region("model.moe.route"):
        logits = x.float() @ p["router"].float()                      # (T_local, E)
        if span.rows is None:      # a stand-in: writes no row, keeps no choice
            at = torch.zeros(n_local, dtype=torch.int64, device=x.device)
            written, logits = at[:0], logits[:0]
        else:
            at = written = span.rows
        whole = logits.new_zeros((n * g, E)).index_copy(0, written, logits)
        whole = _SumOverGroup.apply(whole, span.group).reshape(n, g, E)
        *route, aux, z, dropped = _route_group(cfg, whole, C)
        expert_idx, slot, keep, gates = (t.reshape(n * g, k)[at] for t in route)
        if span.rows is None:
            keep = torch.zeros_like(keep)
    # the expert buffer holds the groups this rank's tokens lie in, in order
    used, group_of = torch.unique(at // g, return_inverse=True)
    y = _dispatch_combine(cfg, p, x, (expert_idx, slot, keep, gates), C, group_of,
                          used.numel())
    return _with_shared(cfg, p, x, y), MoEMetrics(aux.mean(), z.mean(), dropped.mean())


def moe_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    """The stacked MoE leaves as ``(shape, dtype name)``; the router is fp32."""
    L, E, D, F_ = n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    specs = {"router": ((L, D, E), "float32"), "we_in": ((L, E, D, F_), dt),
             "we_out": ((L, E, F_, D), dt)}
    if cfg.gated_mlp():
        specs["we_gate"] = ((L, E, D, F_), dt)
    if cfg.shared_d_ff:
        Fs = cfg.shared_d_ff
        specs.update(shared_gate=((L, D, Fs), dt), shared_in=((L, D, Fs), dt),
                     shared_out=((L, Fs, D), dt))
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
            if name == "router" or name.startswith("shared_"):
                dense_init(w[i], generator)
                continue
            for e in range(cfg.n_experts):
                dense_init(w[i, e], generator)
        out[name] = w
    return out
