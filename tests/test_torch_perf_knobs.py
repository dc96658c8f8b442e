"""Performance knobs never change the port's model semantics, on the CPU.

``tests/test_perf_knobs.py`` case for case on the port: every execution-plan
lever (the two-level layer loop ``scan_block``, ``fsdp_gather``, the remat
policy, the xent chunk, ``act_shard``, the MoE group size) leaves the loss
(rtol 1e-5) and the gradient norm (rtol 1e-4) of the default configuration,
on the llama3.2 and mixtral smoke configs (4 layers, bf16, ``remat="full"``)
with the reference's weights carried across. mixtral skips the
``scan_block`` knobs, as the reference's test does. The default's loss is
also held to the reference's own (bf16 2e-2), and ``remat="dots"`` is held
to save exactly the outputs of the no-batch-dim matrix products
(``aten.mm``), one per projection, and recompute the rest.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

KNOBS = [
    {"scan_block": 2},
    {"fsdp_gather": "step"},
    {"remat": "dots"},
    {"remat": "none"},
    {"scan_block": 2, "fsdp_gather": "step", "remat": "dots"},
    {"xent_chunk": 8},
    {"act_shard": "none"},
    {"act_shard": "batch_seq"},
]
ARCHS = ["llama3.2-3b", "mixtral-8x22b"]
CASES = [(arch, i) for arch in ARCHS for i, kw in enumerate(KNOBS)
         if not (arch == "mixtral-8x22b" and kw.get("scan_block"))]


@functools.lru_cache(maxsize=None)
def setup(arch, n_layers=4, S=32, **kw):
    """(jax cfg, port cfg, reference params as numpy, tokens) of the 4-layer smoke config."""
    change = dict(n_layers=n_layers, remat="full", **kw)
    jcfg = jax_smoke_config(arch).replace(**change)
    tcfg = get_smoke_config(arch).replace(**change)
    tree = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    return jcfg, tcfg, tree, tokens


def port_batch(tokens):
    t = torch.from_numpy(tokens).long()
    return {"tokens": t, "labels": t}


@functools.lru_cache(maxsize=None)
def base_loss(arch):
    jcfg, tcfg, tree, tokens = setup(arch)
    params = params_from_reference(tcfg, tree, device="cpu")
    ref, _ = jax_api.train_loss(jcfg, jax.tree.map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)})
    with torch.no_grad():
        loss, _ = api.train_loss(tcfg, params, port_batch(tokens))
    return loss.item(), float(ref)


@pytest.mark.parametrize("arch,knob", CASES, ids=lambda v: str(KNOBS[v]) if isinstance(v, int)
                         else v)
def test_knobs_preserve_loss(arch, knob):
    _, tcfg, tree, tokens = setup(arch)
    base, ref = base_loss(arch)
    np.testing.assert_allclose(base, ref, rtol=2e-2)
    params = params_from_reference(tcfg, tree, device="cpu")
    with torch.no_grad():
        loss, _ = api.train_loss(tcfg.replace(**KNOBS[knob]), params, port_batch(tokens))
    np.testing.assert_allclose(base, loss.item(), rtol=1e-5, err_msg=str(KNOBS[knob]))


def test_moe_group_size_invariance():
    """Group size only affects capacity granularity at full load; with a
    loose capacity factor the output is identical across group sizes."""
    _, tcfg, tree, tokens = setup("mixtral-8x22b", n_layers=2, S=64, moe_capacity_factor=8.0)
    cfg = tcfg.replace(remat="none")
    params = params_from_reference(cfg, tree, device="cpu")
    # compare the cross-entropy (the routed OUTPUT): the load-balance aux
    # metric legitimately varies with grouping (per-group f_e·p_e averages)
    nlls = []
    with torch.no_grad():
        for gs in (32, 64, 128):
            _, metrics = api.train_loss(cfg.replace(moe_group_size=gs), params,
                                        port_batch(tokens))
            nlls.append(metrics["nll"].item())
    np.testing.assert_allclose(nlls[0], nlls[1], rtol=2e-5)
    np.testing.assert_allclose(nlls[0], nlls[2], rtol=2e-5)


def grad_norm(cfg, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = api.train_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return torch.sqrt(sum(g.float().square().sum() for g in grads)).item()


@pytest.mark.parametrize("knob", [{"scan_block": 2}, {"remat": "dots"}, {"fsdp_gather": "step"}],
                         ids=str)
def test_gradients_match_across_knobs(knob):
    """Remat/scan restructuring must leave gradients identical too."""
    _, tcfg, tree, tokens = setup("llama3.2-3b")
    params = params_from_reference(tcfg, tree, device="cpu")
    base = grad_norm(tcfg, params, port_batch(tokens))
    np.testing.assert_allclose(base, grad_norm(tcfg.replace(**knob), params, port_batch(tokens)),
                               rtol=1e-4, err_msg=str(knob))


@pytest.mark.parametrize("arch,per_layer", [("llama3.2-3b", 7), ("mixtral-8x22b", 5)])
def test_dots_saves_the_matrix_products(arch, per_layer, monkeypatch):
    """``x @ W`` on (B, S, D) dispatches ``aten.mm``: what the policy keeps,
    one per projection (q, k, v, o and the MLP's three, or the router for
    MoE) and per layer; attention's and the experts' ``bmm`` are recomputed."""
    _, tcfg, tree, tokens = setup(arch)
    params = params_from_reference(tcfg, tree, device="cpu")
    decisions = []
    policy = transformer._save_dots

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, decision))
        return decision

    monkeypatch.setattr(transformer, "_save_dots", spy)
    grad_norm(tcfg.replace(remat="dots"), params, port_batch(tokens))
    saved = [op for op, d in decisions if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (per_layer * tcfg.n_layers)
    assert torch.ops.aten.bmm.default in {op for op, _ in decisions}
