"""Port model path vs the JAX package on the llama3.2 smoke config, on the CPU.

Weights come from the reference's ``init_params`` and are carried across with
``params_from_reference``; tokens are made with numpy from a seed. In fp32
the two packages compute the same algorithm and agree to 1e-4. In bf16 they
round at different points (XLA and PyTorch place the bf16 casts of the
matmul outputs differently). So fp32 logits are held to 2e-2 and the bf16
KV caches to 5e-2: their entries reach 2-4, where one bf16 step is 1.6e-2 to
3.1e-2, and an input one step apart can flip the output's rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import api, common  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.transformer import param_specs  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, DECODE = 2, 32, 3


def configs(dtype, use_pallas):
    """The same smoke config from both packages."""
    kw = dict(dtype=dtype, param_dtype=dtype, use_pallas=use_pallas)
    return (jax_smoke_config("llama3.2-3b").replace(**kw),
            get_smoke_config("llama3.2-3b").replace(**kw))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_configs_equal_field_for_field():
    # every field of the reference's config is the port's; the port's own
    # fields (architectures only it runs) stay at their defaults here
    jcfg, tcfg = configs("bfloat16", False)
    shared = {name: tcfg.__dict__[name] for name in jcfg.__dict__}
    assert jcfg.__dict__ == shared
    assert tcfg == type(tcfg)(**shared)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32)
    w = rng.standard_normal((64,), dtype=np.float32) * 0.1
    ref = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 16), dtype=np.float32)
    pos = np.arange(40)[None, :] + 7
    ref = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_round_trips_exactly(dtype):
    jcfg, tcfg = configs(dtype, False)
    tree = np_tree(jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_reference(tcfg, tree, device="cpu")

    def check(ref, ours, specs):
        for name, spec in specs.items():
            if isinstance(spec, dict):
                check(ref[name], ours[name], spec)
                continue
            a, t = ref[name], ours[name]
            assert tuple(t.shape) == a.shape == spec[0]
            bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            back = bits.numpy().view(a.dtype)
            assert back.tobytes() == np.ascontiguousarray(a).tobytes(), name

    check(tree, params, param_specs(tcfg))
    assert api.count_params(params) == sum(x.size for x in jax.tree.leaves(tree))


def test_params_from_reference_rejects_a_wrong_tree():
    jcfg, tcfg = configs("float32", False)
    tree = np_tree(jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    del tree["layers"]["mlp"]["w_gate"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(tcfg, tree, device="cpu")


def _both(dtype, use_pallas):
    jcfg, tcfg = configs(dtype, use_pallas)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(tcfg, np_tree(jparams), device="cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S + DECODE))
    return jcfg, tcfg, jparams, tparams, tokens


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype, use_pallas):
    jcfg, tcfg, jparams, tparams, tokens = _both(dtype, use_pallas)
    max_len = S + DECODE
    jl, jc = jax.jit(lambda p, t: jax_api.prefill(jcfg, p, t, max_len))(
        jparams, jnp.asarray(tokens[:, :S], jnp.int32))
    tl, tc = api.prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]), max_len)
    tol = TOL[dtype]
    assert tl.dtype == torch.float32 and tl.shape == (B, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)
    assert tc["pos"] == int(jc["pos"]) == S
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(as_np(tc[name]), as_np(jc[name]),
                                   atol=CACHE_TOL[dtype], rtol=CACHE_TOL[dtype])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype, use_pallas):
    """Decode from the same prefill cache, feeding both the same tokens."""
    jcfg, tcfg, jparams, tparams, tokens = _both(dtype, use_pallas)
    max_len = S + DECODE
    _, jc = jax.jit(lambda p, t: jax_api.prefill(jcfg, p, t, max_len))(
        jparams, jnp.asarray(tokens[:, :S], jnp.int32))
    # start the port from the reference's own cache, so each step is judged alone
    tc = {"pos": int(jc["pos"]),
          "k": torch.tensor(as_np(jc["k"])).to(tparams["embed"].dtype),
          "v": torch.tensor(as_np(jc["v"])).to(tparams["embed"].dtype)}
    jdecode = jax.jit(lambda p, c, t: jax_api.decode_step(jcfg, p, c, t))
    tol = TOL[dtype]
    for i in range(DECODE):
        tok = tokens[:, S + i:S + i + 1]
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = api.decode_step(tcfg, tparams, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol,
                                   err_msg=f"step {i}")
        assert tc["pos"] == int(jc["pos"]) == S + i + 1
        for name in ("k", "v"):
            np.testing.assert_allclose(as_np(tc[name]), as_np(jc[name]),
                                       atol=CACHE_TOL[dtype], rtol=CACHE_TOL[dtype],
                                       err_msg=f"{name} step {i}")


def test_cache_len_and_init_cache_match_reference():
    jcfg, tcfg = configs("bfloat16", False)
    for window, max_len in ((0, 48), (16, 48), (64, 48)):
        jc = jax_api.init_cache(jcfg.replace(sliding_window=window), B, max_len)
        tc = api.init_cache(tcfg.replace(sliding_window=window), B, max_len, device="cpu")
        assert tc["k"].shape == jc["k"].shape and tc["v"].shape == jc["v"].shape
        assert tc["pos"] == int(jc["pos"]) == 0


def test_sliding_window_ring_cache_matches_reference():
    """S >= C: the prefill cache is rolled into ring order, decode wraps."""
    jcfg, tcfg, jparams, tparams, tokens = _both("float32", False)
    jcfg, tcfg = jcfg.replace(sliding_window=12), tcfg.replace(sliding_window=12)
    max_len = S + DECODE
    jl, jc = jax_api.prefill(jcfg, jparams, jnp.asarray(tokens[:, :S], jnp.int32), max_len)
    tl, tc = api.prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]), max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for i in range(DECODE):
        tok = tokens[:, S + i:S + i + 1]
        jl, jc = jax_api.decode_step(jcfg, jparams, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = api.decode_step(tcfg, tparams, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=1e-4, rtol=1e-4)
