"""The port's MoE layer (``models/moe.py``) vs the JAX package's, on the CPU.

Router logits and token rows are made with numpy from a seed; the expert
weights are the reference's ``init_params`` of the mixtral and grok smoke
configs, carried across with ``params_from_reference``.

  * ``_route_group``: the expert choices, their slots and which are kept
    equal the reference's exactly, the gates within 1e-6 and the aux,
    z and dropped statistics within 1e-6, with capacity to spare, with
    capacity factor 0.5 (drops forced) and with ties forced at the top-k
    boundary (integer logits);
  * ``moe_ffn``: the output within the kernel tests' tolerances
    (``tests/test_kernels.py``: f32 2e-5, bf16 2e-2) and the metrics
    within 1e-6, one group and several (the last padded), with and
    without drops. Both packages route from the same fp32 router logits of
    the same inputs, so their decisions agree in bf16 too.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
METRIC_TOL = 1e-6
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(arch, **kw):
    return jax_smoke_config(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


def route_logits(case, g, E, seed):
    rng = np.random.default_rng(seed)
    if case == "tie":
        # a handful of integer levels: many rows tie at the k-th choice
        return rng.integers(0, 3, (g, E)).astype(np.float32)
    return rng.standard_normal((g, E)).astype(np.float32) * 2.0


@pytest.mark.parametrize("case,capacity_factor,n_experts,g", [
    ("normal", 1.25, 4, 64),
    ("drops", 0.5, 4, 64),
    ("tie", 1.25, 4, 64),
    ("tie_drops", 0.5, 8, 96),
    ("normal", 1.25, 8, 256),
])
def test_route_group_matches_reference(case, capacity_factor, n_experts, g):
    jcfg, tcfg = configs("mixtral-8x22b", moe_capacity_factor=capacity_factor,
                         n_experts=n_experts)
    C = moe._capacity(tcfg, g)
    assert C == jax_moe._capacity(jcfg, g)
    logits = route_logits(case.split("_")[0], g, n_experts, seed=g + n_experts)
    ref = jax_moe._route_group(jcfg, jnp.asarray(logits), C)
    out = moe._route_group(tcfg, torch.from_numpy(logits), C)
    idx, slot, keep, gates, aux, z, dropped = out
    for name, got, want in (("expert_idx", idx, ref[0]), ("slot", slot, ref[1]),
                            ("keep", keep, ref[2])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    np.testing.assert_allclose(gates.numpy(), np.asarray(ref[3]), atol=METRIC_TOL, rtol=0)
    for name, got, want in (("aux", aux, ref[4]), ("z", z, ref[5]),
                            ("dropped", dropped, ref[6])):
        np.testing.assert_allclose(got.item(), float(want), atol=METRIC_TOL,
                                   rtol=METRIC_TOL, err_msg=name)
    if "drops" in case:
        assert dropped.item() > 0
    if case.startswith("tie"):
        # ties at the top-k boundary: the k-th and (k+1)-th probabilities equal
        p = np.sort(logits, axis=-1)[:, ::-1]
        k = tcfg.experts_per_token
        assert (p[:, k - 1] == p[:, k]).sum() > 0


@functools.lru_cache(maxsize=None)
def reference_params(arch, dtype):
    """The reference's init of the smoke config as numpy (the capacity factor
    shapes no weight, so one init serves every case of an arch and dtype)."""
    jcfg, _ = configs(arch, dtype=dtype, param_dtype=dtype)
    return jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))


def layer0_moe(arch, tcfg):
    """Layer 0's MoE weights of the reference's init, in both packages."""
    tree = reference_params(arch, tcfg.param_dtype)
    tparams = params_from_reference(tcfg, tree, device="cpu")
    jlp = {k: jnp.asarray(v[0]) for k, v in tree["layers"]["moe"].items()}
    tlp = {k: v[0] for k, v in tparams["layers"]["moe"].items()}
    return jlp, tlp


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("T", [64, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b"])
def test_moe_ffn_matches_reference(arch, dtype, T, capacity_factor):
    jcfg, tcfg = configs(arch, dtype=dtype, param_dtype=dtype,
                         moe_capacity_factor=capacity_factor)
    jlp, tlp = layer0_moe(arch, tcfg)
    x = np.random.default_rng(T).standard_normal((T, tcfg.d_model)).astype(np.float32)
    jy, jm = jax_moe.moe_ffn(jcfg, jlp, jnp.asarray(x).astype(JNP[dtype]))
    ty, tm = moe.moe_ffn(tcfg, tlp, torch.from_numpy(x).to(TORCH[dtype]))
    assert ty.dtype == TORCH[dtype] and tuple(ty.shape) == (T, tcfg.d_model)
    tol = TOL[dtype]
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               atol=tol, rtol=tol)
    for name, got, want in zip(moe.MoEMetrics._fields, tm, jm):
        np.testing.assert_allclose(got.item(), float(want), atol=METRIC_TOL,
                                   rtol=METRIC_TOL, err_msg=name)
    if capacity_factor < 1:
        assert tm.dropped_fraction.item() > 0
