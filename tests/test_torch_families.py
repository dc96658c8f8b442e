"""The moe, vlm and encdec families of the port vs the JAX package's, on the CPU.

mixtral-8x22b and grok-1-314b (moe), chameleon-34b (vlm; tokens, and the
stub frontend's patch ``embeds``) and whisper-tiny (encdec; the stub
frontend's frame ``embeds``), at their smoke sizes. Weights come from the
reference's ``init_params`` and are carried across with
``params_from_reference``; tokens and embeddings are made with numpy from a
seed.

  * ``train_loss``, its metrics and gradients against
    ``jax.value_and_grad`` of the reference's, in f32 (loss 1e-5 relative,
    each gradient leaf 1e-4 relative in norm) and bf16 (loss 2e-2);
    training runs the plain paths in both packages (their kernels are
    forward-only), so ``use_pallas`` is off here;
  * ``prefill`` and three ``decode_step`` calls, with ``use_pallas`` off
    and on (the reference's Pallas kernel in interpret mode, the port's
    kernels' plain versions), in f32 (2e-5) and bf16 (logits 2e-2, KV
    caches 5e-2, as tests/test_torch_models.py). Each decode step starts
    from the reference's own cache, so each is judged alone. The MoE
    models in bf16 are held to the reference run eagerly: under ``jit``
    XLA fuses away bf16 roundings, which moves the router's logits by ~1e-2
    and, for grok's smoke config, one token's expert choice (the
    reference's jitted and eager K caches then differ by 1.08 in layer 1,
    the port's and the eager one's by 0.02);
  * the kernel's calls per prefill (one per attention: 3 per decoder layer
    plus 1 per encoder layer for whisper) and none per decode step;
  * ``init_params``, ``train_loss``, ``prefill`` and ``decode_step`` of all
    ten configs' smoke versions, and the parameter trees in both directions;
  * the moe and vlm smoke configs in f32 through ``ResilientServer`` (every
    request's tokens and the report equal the reference server's through a
    fault) and ``ResilientTrainer`` (steps, shards, repairs, and losses
    within 1e-4) beside the reference's, under the stand-in data plane of
    test_torch_runtime.py.
"""
import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_runtime import _stand_in_module  # noqa: E402
from test_torch_train import TRAJECTORY_TOL, side_by_side  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api, common  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
B, S, DECODE = 2, 32, 3
# (arch, what the model reads): the four configs of the three families
CASES = [("mixtral-8x22b", "tokens"), ("grok-1-314b", "tokens"),
         ("chameleon-34b", "tokens"), ("chameleon-34b", "embeds"),
         ("whisper-tiny", "embeds")]
MOE_METRICS = ("moe_aux", "router_z", "dropped")
# (case, dtype, use_pallas) of the prefill and decode tests
MODEL_RUNS = [(c, d, up) for c in CASES for d in ("float32", "bfloat16") for up in (False, True)]


def run_id(v):
    return case_id(v) if isinstance(v, tuple) else str(v)


def case_id(case):
    return "-".join(case)


def configs(arch, dtype, use_pallas=False):
    kw = dict(dtype=dtype, param_dtype=dtype, use_pallas=use_pallas)
    return jax_smoke_config(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


@functools.lru_cache(maxsize=None)
def reference_tree(arch, dtype):
    jcfg, _ = configs(arch, dtype)
    return jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))


def both(arch, dtype, use_pallas=False):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg, tcfg = configs(arch, dtype, use_pallas)
    tree = reference_tree(arch, dtype)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_reference(tcfg, tree, device="cpu"))


def inputs(cfg, reads, seed=2):
    """tokens (B, S + DECODE) and, for the stub frontends, embeds as numpy:
    whisper's frames are (B, encoder_seq_len, D), chameleon's patches (B, S, D)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + DECODE)).astype(np.int32)
    embeds = None
    if reads == "embeds":
        n = cfg.encoder_seq_len if cfg.is_encoder_decoder else S
        embeds = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return tokens, embeds


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def cache_names(cfg):
    return ("k", "v", "cross_k", "cross_v") if cfg.is_encoder_decoder else ("k", "v")


# ---------------------------------------------------------------------------
# every config runs; parameter trees; sinusoidal positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_runs_on_the_cpu(arch):
    cfg = get_smoke_config(arch)
    params = api.init_params(cfg, device="cpu")
    tokens, embeds = inputs(cfg, "embeds" if cfg.is_encoder_decoder else "tokens")
    toks = torch.from_numpy(tokens).long()
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    kw = {}
    if embeds is not None:
        batch["embeds"] = kw["embeds"] = torch.from_numpy(embeds)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = api.train_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    gn = torch.sqrt(sum(g.float().square().sum() for g in grads))
    assert loss.dim() == 0 and torch.isfinite(loss) and torch.isfinite(gn) and gn > 0
    assert (set(MOE_METRICS) <= set(metrics)) == cfg.is_moe
    with torch.no_grad():
        logits, cache = api.prefill(cfg, params, toks[:, :S], S + DECODE, **kw)
        assert logits.shape == (B, 1, cfg.vocab_size)
        for _ in range(DECODE):
            nxt = logits[:, -1].argmax(-1)[:, None]
            logits, cache = api.decode_step(cfg, params, cache, nxt)
            assert logits.shape == (B, 1, cfg.vocab_size) and torch.isfinite(logits).all()
    assert api.count_params(params) == cfg.total_params()


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b", "chameleon-34b",
                                  "whisper-tiny"])
def test_params_from_reference_round_trips_exactly(arch):
    _, tcfg = configs(arch, "bfloat16")
    tree = reference_tree(arch, "bfloat16")
    params = params_from_reference(tcfg, tree, device="cpu")

    def check(ref, ours):
        assert set(ref) == set(ours)
        for name, a in ref.items():
            if isinstance(a, dict):
                check(a, ours[name])
                continue
            t = ours[name]
            bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            assert bits.numpy().view(a.dtype).tobytes() == np.ascontiguousarray(a).tobytes(), name

    check(tree, params)
    if tcfg.is_moe:   # the router stays fp32 whatever param_dtype
        assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert api.count_params(params) == sum(x.size for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch,path", [("mixtral-8x22b", ("layers", "moe", "we_gate")),
                                       ("whisper-tiny", ("dec_layers", "cross", "wq"))])
def test_params_from_reference_rejects_a_wrong_tree(arch, path):
    _, tcfg = configs(arch, "float32")
    tree = jax.tree.map(lambda a: a, reference_tree(arch, "float32"))
    sub = tree
    for key in path[:-1]:
        sub = sub[key]
    del sub[path[-1]]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(tcfg, tree, device="cpu")


@pytest.mark.parametrize("seq_len,d_model", [(32, 64), (1500, 384)])
def test_sinusoidal_positions_match_reference(seq_len, d_model):
    """Each row within 2e-5 plus the position times two ulps of 1.0: the
    angle is pos x inv_freq, so an ulp of inv_freq (XLA's fp32 exp is not
    correctly rounded either) moves it by pos ulps."""
    ref = np.asarray(jax_common.sinusoidal_positions(seq_len, d_model))
    out = common.sinusoidal_positions(seq_len, d_model)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    atol = 2e-5 + np.arange(seq_len)[:, None] * 2 * np.finfo(np.float32).eps
    assert (np.abs(out.numpy() - ref) <= atol).all()


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,dtype", [(c, "float32") for c in CASES]
                         + [(("mixtral-8x22b", "tokens"), "bfloat16"),
                            (("whisper-tiny", "embeds"), "bfloat16")],
                         ids=lambda v: case_id(v) if isinstance(v, tuple) else v)
def test_train_loss_and_grads_match_reference(case, dtype):
    arch, reads = case
    jcfg, tcfg, jparams, tparams = both(arch, dtype)
    tokens, embeds = inputs(jcfg, reads, seed=1)
    jb = {"labels": jnp.asarray(tokens[:, 1:S + 1])}
    tb = {"labels": torch.from_numpy(tokens[:, 1:S + 1].copy())}
    if reads == "tokens" or jcfg.is_encoder_decoder:
        jb["tokens"] = jnp.asarray(tokens[:, :S])
        tb["tokens"] = torch.from_numpy(tokens[:, :S].copy())
    if embeds is not None:
        jb["embeds"], tb["embeds"] = jnp.asarray(embeds), torch.from_numpy(embeds)
    (jl, jm), jg = jax.value_and_grad(lambda p: jax_api.train_loss(jcfg, p, jb),
                                      has_aux=True)(jparams)
    leaves = tree_leaves(tparams)
    results = {}
    for remat in ("full", "none"):
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = api.train_loss(tcfg.replace(remat=remat), tparams, tb)
        # with embeds in place of tokens the embedding table is unused: no gradient
        grads = [torch.zeros_like(p) if g is None else g for p, g in
                 zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        for p in leaves:
            p.requires_grad_(False)
        results[remat] = (loss.detach(), grads)
        assert abs(loss.item() - float(jl)) <= LOSS_TOL[dtype] * abs(float(jl))
        assert set(metrics) == set(jm)
        for k in metrics:
            np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=LOSS_TOL[dtype],
                                       atol=1e-6, err_msg=k)
        if dtype == "float32":
            for want, got in zip(jax.tree.leaves(jg), grads):
                want = np.asarray(want, np.float32)
                err = np.linalg.norm(got.numpy() - want) / max(np.linalg.norm(want), 1e-30)
                assert err <= GRAD_TOL, err
    (lf, gf), (ln, gn) = results["full"], results["none"]
    assert torch.equal(lf, ln)
    assert all(torch.equal(a, b) for a, b in zip(gf, gn))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def eager(jcfg, dtype):
    """Run the reference eagerly: the MoE models in bf16 (module docstring)."""
    return jcfg.is_moe and dtype == "bfloat16"


def reference_fn(jcfg, dtype, fn):
    return fn if eager(jcfg, dtype) else jax.jit(fn)


def prefill_pair(case, dtype, use_pallas, port=True):
    """Both packages' prefill of the same prompt (the port's only with ``port``)."""
    arch, reads = case
    jcfg, tcfg, jparams, tparams = both(arch, dtype, use_pallas)
    tokens, embeds = inputs(jcfg, reads)
    jkw, tkw = {}, {}
    if embeds is not None:
        jkw["embeds"], tkw["embeds"] = jnp.asarray(embeds), torch.from_numpy(embeds)
    max_len = S + DECODE
    fn = reference_fn(jcfg, dtype, lambda p, t, kw: jax_api.prefill(jcfg, p, t, max_len, **kw))
    with jax.disable_jit(eager(jcfg, dtype)):
        jl, jc = fn(jparams, jnp.asarray(tokens[:, :S]), jkw)
    out = None
    if port:
        out = api.prefill(tcfg, tparams, torch.from_numpy(tokens[:, :S]).long(), max_len, **tkw)
    return jcfg, tcfg, jparams, tparams, tokens, (jl, jc), out


@pytest.mark.parametrize("case,dtype,use_pallas", MODEL_RUNS, ids=run_id)
def test_prefill_matches_reference(case, dtype, use_pallas):
    jcfg, tcfg, *_, (jl, jc), (tl, tc) = prefill_pair(case, dtype, use_pallas)
    tol = TOL[dtype]
    assert tl.dtype == torch.float32 and tl.shape == (B, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)
    assert tc["pos"] == int(jc["pos"]) == S
    assert set(tc) == set(jc)
    for name in cache_names(tcfg):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(as_np(tc[name]), as_np(jc[name]), atol=CACHE_TOL[dtype],
                                   rtol=CACHE_TOL[dtype], err_msg=name)


@pytest.mark.parametrize("case,dtype,use_pallas", MODEL_RUNS, ids=run_id)
def test_decode_step_matches_reference(case, dtype, use_pallas):
    """Decode from the reference's prefill cache, feeding both the same tokens."""
    jcfg, tcfg, jparams, tparams, tokens, (_, jc), _ = prefill_pair(case, dtype, use_pallas,
                                                                    port=False)
    names = cache_names(tcfg)
    tc = {"pos": int(jc["pos"]),
          **{n: torch.tensor(as_np(jc[n])).to(tparams["embed"].dtype) for n in names}}
    jdecode = reference_fn(jcfg, dtype, lambda p, c, t: jax_api.decode_step(jcfg, p, c, t))
    tol = TOL[dtype]
    for i in range(DECODE):
        tok = tokens[:, S + i:S + i + 1]
        with jax.disable_jit(eager(jcfg, dtype)):
            jl, jc = jdecode(jparams, jc, jnp.asarray(tok))
        tl, tc = api.decode_step(tcfg, tparams, tc, torch.from_numpy(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol,
                                   err_msg=f"step {i}")
        assert tc["pos"] == int(jc["pos"]) == S + i + 1
        for name in names:
            np.testing.assert_allclose(as_np(tc[name]), as_np(jc[name]),
                                       atol=CACHE_TOL[dtype], rtol=CACHE_TOL[dtype],
                                       err_msg=f"{name} step {i}")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_calls_per_prefill_and_none_per_decode(case, monkeypatch):
    """The path the card takes: one flash call per attention in prefill
    (3 per decoder layer and 1 per encoder layer for enc-dec), none in decode."""
    arch, reads = case
    _, tcfg = configs(arch, "float32", use_pallas=True)
    params = api.init_params(tcfg, device="cpu")
    calls = []
    plain = ops.flash_attention_plain

    def counted(*args, **kwargs):
        calls.append(kwargs["causal"])
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "flash_attention_plain", counted)
    tokens, embeds = inputs(tcfg, reads)
    kw = {} if embeds is None else {"embeds": torch.from_numpy(embeds)}
    toks = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits, cache = api.prefill(tcfg, params, toks[:, :S], S + DECODE, **kw)
        if tcfg.is_encoder_decoder:
            L, Le = tcfg.n_layers, tcfg.n_encoder_layers
            assert sorted(calls) == sorted([False] * (Le + L) + [True] * L)
        else:
            assert calls == [True] * tcfg.n_layers
        calls.clear()
        for i in range(DECODE):
            logits, cache = api.decode_step(tcfg, params, cache, toks[:, S + i:S + i + 1])
        assert calls == []


# ---------------------------------------------------------------------------
# the server and the trainer, beside the reference's
# ---------------------------------------------------------------------------

SERVED = ["mixtral-8x22b", "grok-1-314b", "chameleon-34b"]


@pytest.fixture
def reference(monkeypatch):
    """The JAX package's runtime with the stand-in ``repro.dist.dataplane``
    of test_torch_runtime.py, for this test only."""
    monkeypatch.setitem(sys.modules, "repro.dist.dataplane", _stand_in_module())
    import repro.core as R
    import repro.mpi as RM
    return R, RM


@pytest.mark.parametrize("arch", SERVED)
def test_resilient_server_matches_reference(reference, arch):
    """The smoke config in f32 through fault (0, 1), continuous: every request
    gets the reference server's tokens, and ``run()`` the same report but
    for wall time."""
    from repro.launch import serve as jax_serve
    from repro_torch import core as P
    from repro_torch import mpi as PM
    from repro_torch.launch import serve as port_serve

    R, RM = reference
    jcfg, pcfg = configs(arch, "float32")
    shape = dict(prompt_len=16, decode_tokens=4, batch_per_node=4)

    def session(core, mpi, serve, **extra):
        return mpi.Session(4, policy=core.LegioPolicy(legion_size=2,
                                                      **serve.recovery_preset("shrink")),
                           injector=core.FaultInjector.at([(0, 1)]), **extra)

    ref = jax_serve.ResilientServer(jcfg, session(R, RM, jax_serve), **shape)
    port = port_serve.ResilientServer(pcfg, session(P, PM, port_serve, device="cpu"),
                                      device="cpu", **shape)
    port.params = params_from_reference(port.cfg, jax.tree.map(np.asarray, ref.params),
                                        device="cpu")
    want, got = ref.run(16), port.run(16)
    volatile = {"wall_seconds", "throughput_rps"}
    assert {k: v for k, v in got.items() if k not in volatile} == \
        {k: v for k, v in want.items() if k not in volatile}
    assert (got["completed"], got["survivors"], got["repairs"]) == (16, 3, 1)
    assert sorted(port.completed) == sorted(ref.completed) == list(range(16))
    for rid, row in ref.completed.items():
        np.testing.assert_array_equal(port.completed[rid], row, err_msg=f"request {rid}")


@pytest.mark.parametrize("arch", SERVED)
def test_trainer_matches_reference(reference, arch):
    """``ResilientTrainer`` on the smoke config in f32, 4 nodes, fault at
    step 3: the same steps, shards and repairs, and losses within 1e-4."""
    R, _ = reference
    jcfg, pcfg = configs(arch, "float32")
    rj, rp = side_by_side(R, jcfg, pcfg, nodes=4, faults=[(3, 1)], steps=6,
                          per_shard_batch=2, seq_len=32,
                          tc=dict(total_steps=6, warmup_steps=2))
    assert rp[3].repair is not None and [r.active_shards for r in rp] == [4, 4, 4, 3, 3, 3]
    np.testing.assert_allclose([r.loss for r in rp], [r.loss for r in rj], rtol=TRAJECTORY_TOL)
