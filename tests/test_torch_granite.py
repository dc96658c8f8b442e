"""Granite-4.0-H (``granite-4.0-h-small``) on the port against its plain
reference, the benchmark's ``bench/reference/granite.py`` (plain torch,
loaded by path), on the CPU at the smoke size.

The smoke config keeps every mechanism: layers of two kinds by a pattern
(``MAM`` twice, so each kind's stack holds more than one layer), Mamba-2
blocks, NoPE attention with its own score scale, routed experts beside a
shared expert, and the embedding, residual and logit multipliers. Seeded
weights are drawn by the reference's ``layout`` (the benchmark's scales)
and written into the program's own parameter tree, which must hold the
same leaves; the reference gets them upcast.

Tolerances, with their reasons:

  * fp32 logits, prefill and decode through both caches, within 1e-5 of
    the largest reference logit: the two compute the same model in fp32,
    the SSD scan in another chunking of its sums and attention's score
    scale in two factors; round-off measured 2.4e-6 to 2.8e-6;
  * fp32 training loss within 1e-6 (relative; 8.6e-8 measured) and each
    leaf's gradient within 5e-5 of that leaf's largest entry (4.1e-6
    measured): the same round-off through the backward;
  * bf16 logits within 0.2 in RMS, relative to the reference's RMS: bf16
    rounds the router's inputs, and a near-tied choice of the top 3 of 8
    experts flips; through attention and the scan a flip moves later
    positions too (0.031 to 0.104 over six seeds). The reference in fp8,
    one precision below, reads 0.51 to 0.67: the limit holds it out.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs.registry import get_config as jax_config
from repro.models import api as jax_api
from repro_torch.configs import registry
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import api, moe

ROOT = Path(__file__).resolve().parents[1]


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "granite_reference", ROOT / "bench" / "reference" / "granite.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load_reference()

ARCH = "granite-4.0-h-small"
B, S, DECODE = 2, 32, 3          # S: two SSD chunks of 16


def config(dtype="float32", **kw):
    return get_smoke_config(ARCH).replace(dtype=dtype, param_dtype=dtype, **kw)


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += paths(v, f"{prefix}{k}.") if isinstance(v, dict) else [prefix + k]
    return out


def nest(flat):
    out = {}
    for path, t in flat.items():
        *head, last = path.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = t
    return out


def weights(cfg, seed):
    """The seeded weights by the reference's layout, in the config's dtypes."""
    gen = torch.Generator().manual_seed(seed)
    return {p: (mean + std * torch.randn(shape, generator=gen)).to(getattr(torch, dt))
            for p, (shape, dt, mean, std) in ref.layout(fields(cfg)).items()}


def both(cfg, seed):
    """(the program's parameters, the reference's fp32 ones) of the same weights."""
    w = weights(cfg, seed)
    params = api.init_params(cfg, device="cpu")
    assert sorted(paths(params)) == sorted(w)
    with torch.no_grad():
        for path, t in w.items():
            assert leaf(params, path).shape == t.shape and leaf(params, path).dtype == t.dtype
            leaf(params, path).copy_(t)
    return params, nest({p: t.float() for p, t in w.items()})


def tokens(cfg, seed, n):
    gen = torch.Generator().manual_seed(seed + 1000)
    return torch.randint(0, cfg.vocab_size, (B, n), generator=gen)


def served_logits(cfg, params, toks):
    """Prefill S tokens, then decode the rest through the cache: the logits
    of each position from S - 1 on, (B, DECODE, V)."""
    with torch.no_grad():
        lg, cache = api.prefill(cfg, params, toks[:, :S], S + DECODE)
        out = [lg[:, 0]]
        for j in range(DECODE - 1):
            lg, cache = api.decode_step(cfg, params, cache, toks[:, S + j:S + j + 1])
            out.append(lg[:, 0])
    return torch.stack(out, dim=1)


def reference_logits(cfg, rparams, toks, mm=None):
    with torch.no_grad():
        hidden, _ = ref.forward(fields(cfg), rparams, toks, prompt_len=S, mm=mm)
        return ref.logits(fields(cfg), rparams, hidden[:, S - 1:S + DECODE - 1], mm)


def rms_rel(got, want):
    return float((got - want).square().mean().sqrt() / want.square().mean().sqrt())


# ---------------------------------------------------------------------------
# the configuration and the registry
# ---------------------------------------------------------------------------

def test_registry_resolves_granite_outside_the_shared_grid():
    assert registry.ARCH_IDS == (
        "mixtral-8x22b", "grok-1-314b", "chameleon-34b", "deepseek-67b", "starcoder2-7b",
        "gemma-7b", "llama3.2-3b", "mamba2-130m", "whisper-tiny", "hymba-1.5b")
    assert registry.PORT_ONLY_IDS == (ARCH,)
    assert ARCH not in {arch for arch, *_ in registry.iter_cells(include_skipped=True)}
    cfg = get_config(ARCH)
    assert cfg.name == ARCH and cfg.family == "moe" and cfg.n_layers == 40
    assert cfg.layer_kinds == "MMMMMAMMMM" * 4
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == "A"] == [5, 15, 25, 35]
    assert get_smoke_config(ARCH).layer_kinds == "MAMMAM"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("granite-nonesuch")


def test_parameter_counts():
    cfg = get_config(ARCH)
    assert cfg.total_params() == 32_207_337_984
    assert cfg.replace(n_layers=10).total_params() == 8_360_118_912
    # a token: a mixer, 10 of the 72 experts, the shared expert, the router, the norms
    mamba, attn = cfg.ssm_params_per_layer(), cfg.attn_params()
    ffn = 10 * 3 * 4096 * 768 + 3 * 4096 * 1536 + 4096 * 72 + 2 * 4096
    assert cfg.active_params() == 36 * mamba + 4 * attn + 40 * ffn + 100352 * 4096 + 4096
    smoke = config()
    assert api.count_params(api.init_params(smoke, device="cpu")) == smoke.total_params()


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_layer_kinds_describe_every_config(arch):
    """Without a pattern every layer is of the family's kind, and the counts
    summed over the kinds are the JAX package's."""
    cfg, ref_cfg = get_config(arch), jax_config(arch)
    kind = {"hybrid": "H", "ssm": "M"}.get(cfg.family, "A")
    assert cfg.layer_kinds == kind * cfg.n_layers
    assert cfg.total_params() == ref_cfg.total_params()
    assert cfg.active_params() == ref_cfg.active_params()


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x22b"])
def test_other_configs_keep_their_parameter_tree(arch):
    """With every new field at its default, the published hymba and mixtral
    trees are the JAX package's, leaf for leaf."""
    shapes = jax.eval_shape(lambda: jax_api.init_params(jax_config(arch), jax.random.PRNGKey(0)))
    want = {".".join(str(k.key) for k in kp): (tuple(v.shape), str(v.dtype))
            for kp, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    specs = api.param_specs(get_config(arch))
    assert {p: (tuple(leaf(specs, p)[0]), leaf(specs, p)[1]) for p in paths(specs)} == want


def test_tree_and_cache_hold_each_kind_only_where_it_runs():
    cfg = config()
    n_attn, n_ssm = cfg.layer_kinds.count("A"), cfg.layer_kinds.count("M")
    assert (n_attn, n_ssm) == (2, 4)
    layers = api.param_specs(cfg)["layers"]
    assert sorted(layers) == ["attn", "attn_norm", "mlp_norm", "moe", "ssm"]
    assert {leaf_[0][0] for leaf_ in layers["attn"].values()} == {n_attn}
    assert {leaf_[0][0] for leaf_ in layers["ssm"].values()} == {n_ssm}
    assert {leaf_[0][0] for leaf_ in layers["moe"].values()} == {cfg.n_layers}
    assert {"shared_gate", "shared_in", "shared_out"} <= set(layers["moe"])
    params = api.init_params(cfg, device="cpu")
    for cache in (api.init_cache(cfg, B, S + DECODE, device="cpu"),
                  api.prefill(cfg, params, tokens(cfg, 0, S), S + DECODE)[1]):
        assert sorted(cache) == ["conv", "k", "pos", "state", "v"]
        assert cache["k"].shape == cache["v"].shape == (n_attn, B, S + DECODE, 2, 16)
        assert cache["conv"].shape[0] == cache["state"].shape[0] == n_ssm
        assert cache["state"].dtype == torch.float32


def test_serve_cli_takes_granite(capsys):
    rc = serve.main(["--arch", ARCH, "--device", "cpu", "--data-plane", "sim", "--nodes", "2",
                     "--requests", "4", "--prompt-len", "16", "--decode-tokens", "2",
                     "--batch-per-node", "2", "--fail", "1:1"])
    out = capsys.readouterr().out
    assert rc == 0 and "arch=granite-smoke" in out and "[serve] OK" in out


# ---------------------------------------------------------------------------
# the program against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_fp32_prefill_and_decode_match_the_reference(use_pallas):
    cfg = config(use_pallas=use_pallas)
    params, rparams = both(cfg, seed=1)
    toks = tokens(cfg, 1, S + DECODE)
    want = reference_logits(cfg, rparams, toks)
    got = served_logits(cfg, params, toks)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_serving_within_its_limit_and_fp8_outside(seed):
    cfg = config("bfloat16", use_pallas=True)
    params, rparams = both(cfg, seed)
    toks = tokens(cfg, seed, S + DECODE)
    want = reference_logits(cfg, rparams, toks)
    assert rms_rel(served_logits(cfg, params, toks), want) < 0.2
    assert rms_rel(reference_logits(cfg, rparams, toks, mm=ref.Matmul(fp8=True)), want) > 0.2


def test_fp32_train_loss_and_gradients_match_the_reference():
    cfg = config()
    params, rparams = both(cfg, seed=3)
    for tree in (params, rparams):
        for p in paths(tree):
            leaf(tree, p).requires_grad_(True)
    toks = tokens(cfg, 3, S + 1)
    loss, metrics = api.train_loss(cfg, params, {"tokens": toks[:, :S], "labels": toks[:, 1:]})
    want = ref.train_loss(fields(cfg), rparams, toks[:, :S], toks[:, 1:])
    loss.backward()
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-6 * abs(want.item())
    assert metrics["moe_aux"].item() > 0
    for p in paths(params):
        g, gw = leaf(params, p).grad, leaf(rparams, p).grad
        assert float((g - gw).abs().max()) <= 5e-5 * float(gw.abs().max()), p


def test_shared_expert_alone_matches_the_reference():
    """The routed experts' output zeroed (``we_out`` = 0): the expert layer
    is the shared expert alone."""
    cfg = config()
    params, rparams = both(cfg, seed=4)
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    rp = {k: v[0] for k, v in rparams["layers"]["moe"].items()}
    p["we_out"] = torch.zeros_like(p["we_out"])
    x = torch.randn(B * S, cfg.d_model, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        y, _ = moe.moe_ffn(cfg, p, x)
    want = ref.swiglu(x, rp["shared_gate"], rp["shared_in"], rp["shared_out"], ref.Matmul())
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_prefill_opens_each_mixer_region_in_the_pattern_ratio():
    cfg = config(use_pallas=True)
    params = api.init_params(cfg, device="cpu")
    toks = tokens(cfg, 0, S)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.prefill(cfg, params, toks, S + DECODE)
    names = [e.name for e in prof.events()]
    kinds = cfg.layer_kinds
    assert names.count("model.attention") == kinds.count("A")
    assert names.count("model.ssd") == kinds.count("M")
    assert names.count("model.moe.shared") == cfg.n_layers
