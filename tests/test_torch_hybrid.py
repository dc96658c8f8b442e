"""Port SSM and hybrid models vs the JAX package, on the CPU.

The mamba2-130m (family ``ssm``) and hymba-1.5b (family ``hybrid``) smoke
configs, in f32 and bf16, with ``use_pallas`` on (the SSD scan's and flash
attention's plain versions) and off (``ssd_chunked_reference`` and the
blocked attention). Weights come from the reference's ``init_params``
through ``params_from_reference``; tokens are made with numpy from a seed.
Tolerances are those of ``test_torch_models.py``: logits f32 1e-4, bf16
2e-2; caches f32 1e-4, bf16 5e-2. The SSD state is fp32 but accumulated
from bf16 inputs rounded at other points by XLA and PyTorch, so in bf16 it
takes the cache tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.mpi import Session  # noqa: E402

ARCHS = ["mamba2-130m", "hymba-1.5b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, DECODE = 2, 32, 3   # S = 32 is past hymba-smoke's window of 16


def configs(arch, dtype, use_pallas):
    kw = dict(dtype=dtype, param_dtype=dtype, use_pallas=use_pallas)
    return jax_smoke_config(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def both(arch, dtype, use_pallas, seed=2, length=S + DECODE):
    jcfg, tcfg = configs(arch, dtype, use_pallas)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, length))
    return jcfg, tcfg, jparams, tparams, tokens


def cache_names(cache):
    return sorted(k for k in cache if k != "pos")


def check_cache(tc, jc, dtype, msg=""):
    assert cache_names(tc) == cache_names(jc)
    assert tc["pos"] == int(jc["pos"])
    for name in cache_names(tc):
        assert tuple(tc[name].shape) == jc[name].shape, name
        want = torch.float32 if name == "state" else tc[name].dtype
        assert tc[name].dtype == want, name
        tol = CACHE_TOL[dtype]
        np.testing.assert_allclose(as_np(tc[name]), as_np(jc[name]), atol=tol, rtol=tol,
                                   err_msg=f"{name} {msg}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_round_trips_exactly(arch, dtype):
    jcfg, tcfg = configs(arch, dtype, False)
    tree = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_reference(tcfg, tree, device="cpu")
    ssm = params["layers"]["ssm"]
    for name in ("A_log", "dt_bias", "D"):
        assert ssm[name].dtype == torch.float32, name
    assert ssm["in_proj"].dtype == {"float32": torch.float32,
                                    "bfloat16": torch.bfloat16}[dtype]

    def check(ref, ours):
        for name, a in ref.items():
            if isinstance(a, dict):
                check(a, ours[name])
                continue
            t = ours[name]
            bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            assert bits.numpy().view(a.dtype).tobytes() == np.ascontiguousarray(a).tobytes(), name

    check(tree, params)
    assert api.count_params(params) == sum(x.size for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_rejects_a_wrong_leaf_dtype(arch):
    jcfg, tcfg = configs(arch, "bfloat16", False)
    tree = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    tree["layers"]["ssm"]["A_log"] = tree["layers"]["ssm"]["A_log"].astype(
        tree["layers"]["ssm"]["in_proj"].dtype)
    with pytest.raises(ValueError, match="A_log"):
        params_from_reference(tcfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_match_reference_layout(arch):
    jcfg, tcfg = configs(arch, "bfloat16", True)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = api.init_params(tcfg, device="cpu")

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tree.items()}

    assert layout(tparams) == layout(jax.tree.map(np.asarray, jparams))
    ssm = tparams["layers"]["ssm"]
    # linspace rounds its last bit differently in the two frameworks
    np.testing.assert_allclose(ssm["A_log"].numpy(),
                               np.asarray(jparams["layers"]["ssm"]["A_log"]), rtol=1e-6)
    assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
    jc = jax_api.init_cache(jcfg, B, 48)
    tc = api.init_cache(tcfg, B, 48, device="cpu")
    assert cache_names(tc) == cache_names(jc)
    for name in cache_names(tc):
        assert tuple(tc[name].shape) == jc[name].shape, name


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype, use_pallas):
    jcfg, tcfg, jparams, tparams, tokens = both(arch, dtype, use_pallas)
    max_len = S + DECODE
    jl, jc = jax.jit(lambda p, t: jax_api.prefill(jcfg, p, t, max_len))(
        jparams, jnp.asarray(tokens[:, :S], jnp.int32))
    tl, tc = api.prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]), max_len)
    assert tl.dtype == torch.float32 and tl.shape == (B, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL[dtype], rtol=TOL[dtype])
    check_cache(tc, jc, dtype)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dtype, use_pallas):
    """Three steps from the reference's own prefill cache, same tokens fed."""
    jcfg, tcfg, jparams, tparams, tokens = both(arch, dtype, use_pallas)
    max_len = S + DECODE
    _, jc = jax.jit(lambda p, t: jax_api.prefill(jcfg, p, t, max_len))(
        jparams, jnp.asarray(tokens[:, :S], jnp.int32))
    dtype_t = tparams["embed"].dtype
    tc = {"pos": int(jc["pos"])}
    for name in cache_names(jc):
        tc[name] = torch.tensor(as_np(jc[name])).to(
            torch.float32 if name == "state" else dtype_t)
    jdecode = jax.jit(lambda p, c, t: jax_api.decode_step(jcfg, p, c, t))
    for i in range(DECODE):
        tok = tokens[:, S + i:S + i + 1]
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = api.decode_step(tcfg, tparams, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=f"step {i}")
        check_cache(tc, jc, dtype, msg=f"step {i}")


@pytest.mark.parametrize("prompt", [16, 48])
def test_hymba_ring_wraps_past_the_window(prompt):
    """Prompts at and past the window of 16: prefill rolls the last 16 keys
    into ring order, and decode overwrites slot pos % 16 as it goes. (The
    reference takes only prompts that are multiples of its chunk and
    block, 16.)"""
    jcfg, tcfg, jparams, tparams, tokens = both("hymba-1.5b", "float32", True,
                                                seed=3, length=prompt + 4)
    max_len = prompt + 4
    jl, jc = jax_api.prefill(jcfg, jparams, jnp.asarray(tokens[:, :prompt], jnp.int32),
                             max_len)
    tl, tc = api.prefill(tcfg, tparams, torch.from_numpy(tokens[:, :prompt]), max_len)
    assert tc["k"].shape[2] == tcfg.hybrid_attn_window == 16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    check_cache(tc, jc, "float32")
    for i in range(4):
        tok = tokens[:, prompt + i:prompt + i + 1]
        jl, jc = jax_api.decode_step(jcfg, jparams, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = api.decode_step(tcfg, tparams, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        check_cache(tc, jc, "float32", msg=f"step {i}")


def reference_generate(cfg, params, tokens, decode_tokens):
    """The JAX package's serve loop (``launch/serve.py``), on given prompts."""
    max_len = tokens.shape[1] + decode_tokens
    prefill = jax.jit(lambda p, t: jax_api.prefill(cfg, p, t, max_len))
    decode = jax.jit(lambda p, c, t: jax_api.decode_step(cfg, p, c, t))
    logits, cache = prefill(params, tokens)
    out = []
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    for _ in range(decode_tokens):
        out.append(tok)
        logits, cache = decode(params, cache, tok)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference_tokens(arch, use_pallas):
    jcfg, tcfg, jparams, tparams, _ = both(arch, "float32", use_pallas)
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab_size, (3, 32))
    ref = reference_generate(jcfg, jparams, jnp.asarray(prompts, jnp.int32), 6)
    out = serve.greedy_generate(tcfg, tparams, torch.from_numpy(prompts), 6)
    assert out.shape == (3, 6)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--nodes", "2", "--batch-per-node", "2", "--prompt-len", "20",
                       "--decode-tokens", "2"]) == 0
    out = capsys.readouterr().out
    assert "[serve] OK" in out and f"arch={get_smoke_config(arch).name}" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_server_routes_prefill_through_the_kernels(arch, monkeypatch):
    """With ``use_pallas`` set by the server, every prefill layer calls
    ``ops.ssd_scan`` (and, for hymba, ``ops.flash_attention``) once."""
    from repro_torch.kernels import ops

    calls = {"ssd_scan": 0, "flash_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    cfg = get_smoke_config(arch)
    server = serve.ResilientServer(cfg, Session(1, device="cpu"), prompt_len=20,
                                   decode_tokens=2, batch_per_node=2, device="cpu")
    rep = server.run(2)
    assert rep["completed"] == 2 and rep["rounds"] == 1
    assert calls["ssd_scan"] == cfg.n_layers
    assert calls["flash_attention"] == (cfg.n_layers if arch == "hymba-1.5b" else 0)
