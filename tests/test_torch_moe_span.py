"""The port's MoE layer routed over a span (``moe.routing_span``) on one
rank, on the CPU.

A one-rank gloo group (a file rendezvous, torn down after each test) holds
the span. Token rows are made with numpy from a seed; the weights are the
reference's ``init_params`` of the mixtral and grok smoke configs
(``test_torch_moe.layer0_moe``).

  * with the span unset ``moe_ffn`` is the one-rank path: its output,
    metrics and gradients bit for bit as without the context;
  * a span over the whole batch in order (rows 0..T-1) gives the one-rank
    path's output, metrics and gradients bit for bit, one group and
    several (the last padded), and so stays within the kernel tests'
    tolerances of the reference's ``moe_ffn``;
  * rows out of order (a rank's shards are not contiguous in the global
    batch) give the one-rank output of the same rows within 1e-6 (f32),
    the metrics within 1e-6;
  * a stand-in (``rows`` None) keeps no choice: its output is zero, and
    its router still reaches the loss, so its backward runs the sum.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_moe import JNP, METRIC_TOL, TOL, TORCH, configs, layer0_moe  # noqa: E402

ARCHS = ["mixtral-8x22b", "grok-1-314b"]


@pytest.fixture
def group1(tmp_path):
    """A gloo group of one rank; destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
                            world_size=1)
    try:
        yield None            # the default group
    finally:
        dist.destroy_process_group()


def _run(cfg, lp, x, span=None, context=True):
    """``moe_ffn`` under ``span`` (outside any ``routing_span`` without
    ``context``): (y, metrics, grads of x and every weight)."""
    x = x.clone().requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in lp.items()}
    with moe.routing_span(span) if context else contextlib.nullcontext():
        y, m = moe.moe_ffn(cfg, leaves, x)
        loss = (y.float() ** 2).sum() + m.aux_loss + m.router_z_loss
        grads = torch.autograd.grad(loss, [x, *leaves.values()])
    return y.detach(), [t.detach() for t in m], dict(zip(["x", *leaves], grads))


def _inputs(arch, dtype, T):
    _, tcfg = configs(arch, dtype=dtype, param_dtype=dtype)
    _, tlp = layer0_moe(arch, tcfg)
    x = np.random.default_rng(T).standard_normal((T, tcfg.d_model)).astype(np.float32)
    return tcfg, tlp, x


def _same(a, b, label):
    assert a.dtype == b.dtype and a.shape == b.shape, label
    assert torch.equal(a, b), label


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_span_unset_is_the_one_rank_path(arch, dtype):
    cfg, lp, x = _inputs(arch, dtype, 100)
    xt = torch.from_numpy(x).to(TORCH[dtype])
    y0, m0, g0 = _run(cfg, lp, xt, context=False)
    y, m, g = _run(cfg, lp, xt, None)
    _same(y, y0, "y")
    for a, b, name in zip(m, m0, moe.MoEMetrics._fields):
        _same(a, b, name)
    for k in g0:
        _same(g[k], g0[k], f"grad {k}")


@pytest.mark.parametrize("T", [64, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_span_in_order_is_bit_identical(group1, arch, dtype, T):
    cfg, lp, x = _inputs(arch, dtype, T)
    xt = torch.from_numpy(x).to(TORCH[dtype])
    y0, m0, g0 = _run(cfg, lp, xt, context=False)
    y, m, g = _run(cfg, lp, xt, moe.RoutingSpan(group1, torch.arange(T), T))
    _same(y, y0, "y")
    for a, b, name in zip(m, m0, moe.MoEMetrics._fields):
        _same(a, b, name)
    assert set(g) == set(g0)
    for k in g0:
        _same(g[k], g0[k], f"grad {k}")
    jcfg, _ = configs(arch, dtype=dtype, param_dtype=dtype)
    jlp, _ = layer0_moe(arch, cfg)
    jy, _ = jax_moe.moe_ffn(jcfg, jlp, jnp.asarray(x).astype(JNP[dtype]))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_span_rows_out_of_order(group1, arch):
    T = 100
    cfg, lp, x = _inputs(arch, "float32", T)
    perm = np.random.default_rng(7).permutation(T)
    y0, m0, g0 = _run(cfg, lp, torch.from_numpy(x), context=False)
    # this rank's row i is row perm[i] of the global batch
    y, m, g = _run(cfg, lp, torch.from_numpy(x[perm]),
                   moe.RoutingSpan(group1, torch.from_numpy(perm), T))
    np.testing.assert_allclose(y.numpy(), y0.numpy()[perm], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(g["x"].numpy(), g0["x"].numpy()[perm], atol=1e-5, rtol=1e-5)
    for a, b, name in zip(m, m0, moe.MoEMetrics._fields):
        np.testing.assert_allclose(a.item(), b.item(), atol=METRIC_TOL, rtol=METRIC_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_in_keeps_no_choice(group1, arch):
    cfg, lp, x = _inputs(arch, "float32", 32)
    y, m, g = _run(cfg, lp, torch.from_numpy(x), moe.RoutingSpan(group1, None, 64))
    assert not y.any()
    assert all(torch.isfinite(t) for t in m)
    assert not g["x"].any()
    assert torch.isfinite(g["router"]).all()
