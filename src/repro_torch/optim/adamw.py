"""AdamW + cosine schedule + global-norm clipping over parameter pytrees.

The JAX package's ``optim/adamw.py`` with its pure-function form: trees in,
trees out. A tree is a nested ``dict`` of tensors. The arithmetic is the
reference's, operation for operation, in float32 tensors: the bias
corrections ``1 - beta**t`` and the schedule are computed from a float32
step tensor, not in Python doubles, and each elementwise product and sum
is its own rounding (no fused multiply-add).

``adamw_update`` returns fresh updates and moments. The train step uses
``adamw_update_``, which computes the same values leaf by leaf and writes
the moments and parameters in place under ``torch.no_grad()``: the
counterpart of the JAX step's ``donate_argnums``, so a step holds one
leaf's float32 temporaries at a time rather than a second copy of the
state.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import TrainConfig

PyTree = Any


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: PyTree           # first moment
    nu: PyTree           # second moment


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of nested dicts (the other trees alike in structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """The leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params: PyTree, *, state_dtype: str = "float32") -> OptState:
    dt = getattr(torch, state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return OptState(step=step, mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_schedule(tc: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """lr(step): linear warmup -> cosine decay to 10% of peak (float32)."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = tc.learning_rate * s / max(tc.warmup_steps, 1)
        prog = torch.clamp((s - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
                           0.0, 1.0)
        # cos of the float32 angle, correctly rounded: torch's vectorised
        # float32 cos is off by an ulp for some angles (1 + cos then cancels)
        c = torch.cos((math.pi * prog).double()).float()
        cos = tc.learning_rate * (0.1 + 0.45 * (1.0 + c))
        return torch.where(s < tc.warmup_steps, warm, cos)

    return lr


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def clip_by_global_norm_(grads: PyTree, max_norm: float) -> torch.Tensor:
    """``clip_by_global_norm`` written into ``grads`` leaf by leaf; returns the norm."""
    with tracing.region("optim.clip"):
        norm = global_norm(grads)
        scale = _clip_scale(norm, max_norm)
        with torch.no_grad():
            for g in tree_leaves(grads):
                g.copy_((g.float() * scale).to(g.dtype))
    return norm


def _bias_corrections(step: torch.Tensor, tc: TrainConfig) -> tuple[torch.Tensor, torch.Tensor]:
    t = step.float()
    return 1.0 - tc.beta1 ** t, 1.0 - tc.beta2 ** t


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, in place where it can be. torch's
    vectorised CPU ``sqrt`` is off by an ulp on ~0.6% of float32 inputs; a
    float64 root rounded to float32 is exact (53 >= 2 * 24 + 2 bits), and
    the card's ``sqrtf`` is IEEE-rounded already."""
    if x.device.type == "cpu":
        return x.copy_(x.double().sqrt_())
    return x.sqrt_()


def _leaf_update(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
                 tc: TrainConfig, lr: torch.Tensor, bc1: torch.Tensor,
                 bc2: torch.Tensor) -> torch.Tensor:
    """One leaf: writes the new moments into ``m`` and ``v`` (their own
    dtype) and returns the update ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
    in ``p``'s dtype."""
    gf = g.to(torch.float32, copy=True)
    mf = m if m.dtype == torch.float32 else m.float()
    vf = v if v.dtype == torch.float32 else v.float()
    mf.mul_(tc.beta1).add_(gf * (1.0 - tc.beta1))
    vf.mul_(tc.beta2).add_(gf.square_().mul_(1.0 - tc.beta2))
    del gf
    upd = (mf / bc1).div_(_sqrt_(vf / bc2).add_(tc.eps))
    upd.add_(p.float() * tc.weight_decay)
    if mf is not m:
        m.copy_(mf)
    if vf is not v:
        v.copy_(vf)
    return upd.mul_(-lr).to(p.dtype)


def adamw_update(grads: PyTree, state: OptState, params: PyTree, tc: TrainConfig,
                 lr: torch.Tensor) -> tuple[PyTree, OptState]:
    """Returns (updates, new_state); apply with ``apply_updates``. Pure: the
    inputs are left as they were."""
    step = state.step + 1
    bc1, bc2 = _bias_corrections(step, tc)
    with torch.no_grad():
        mu = tree_map(torch.clone, state.mu)
        nu = tree_map(torch.clone, state.nu)
        updates = tree_map(lambda g, m, v, p: _leaf_update(g, m, v, p, tc, lr, bc1, bc2),
                           grads, mu, nu, params)
    return updates, OptState(step=step, mu=mu, nu=nu)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def adamw_update_(grads: PyTree, state: OptState, params: PyTree, tc: TrainConfig,
                  lr: torch.Tensor) -> OptState:
    """``apply_updates(params, adamw_update(...)[0])`` in place: each leaf's
    moments and parameter are overwritten before the next leaf is touched.
    Returns the state with the advanced step (its moments are the same
    tensors, now updated)."""
    with tracing.region("optim.adamw"):
        step = state.step + 1
        bc1, bc2 = _bias_corrections(step, tc)
        with torch.no_grad():
            def leaf(g, m, v, p):
                p.add_(_leaf_update(g, m, v, p, tc, lr, bc1, bc2))
            tree_map(leaf, grads, state.mu, state.nu, params)
    return OptState(step=step, mu=state.mu, nu=state.nu)
