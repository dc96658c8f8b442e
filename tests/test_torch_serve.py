"""Port serving path vs the JAX package's serve loop, on the CPU.

``greedy_generate`` must emit the same tokens as the loop of the JAX
package's ``launch/serve.py`` (prefill, then greedy ``decode_step``) written
out over ``repro.models.api``, on identical prompts and weights, in fp32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402


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
def test_greedy_generate_matches_reference_tokens(use_pallas):
    kw = dict(dtype="float32", param_dtype="float32", use_pallas=use_pallas)
    jcfg = jax_smoke_config("llama3.2-3b").replace(**kw)
    tcfg = get_smoke_config("llama3.2-3b").replace(**kw)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab_size, (3, 32))
    ref = reference_generate(jcfg, jparams, jnp.asarray(prompts, jnp.int32), 6)
    out = serve.greedy_generate(tcfg, tparams, torch.from_numpy(prompts), 6)
    assert out.shape == (3, 6)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_server_completes_every_request_on_cpu():
    cfg = get_smoke_config("llama3.2-3b")
    server = serve.ResilientServer(cfg, nodes=2, prompt_len=16, decode_tokens=3,
                                   batch_per_node=2, device="cpu")
    assert server.cfg.use_pallas
    rep = server.run(7)
    assert rep["completed"] == 7 and rep["unserved"] == 0
    assert rep["batches"] == 4 and rep["rounds"] == 2
    assert sorted(server.completed) == list(range(7))
    for rid, row in server.completed.items():
        assert row.shape == (3,) and ((0 <= row) & (row < cfg.vocab_size)).all(), rid


def test_work_fn_keeps_the_reference_contract():
    """``_work_fn(node, batch, step)`` maps each request id to its row of
    ``_work_batch``, and serving the same batch again gives the same tokens."""
    cfg = get_smoke_config("llama3.2-3b").replace(dtype="float32", param_dtype="float32")
    server = serve.ResilientServer(cfg, nodes=1, prompt_len=8, decode_tokens=2,
                                   batch_per_node=3, device="cpu")
    batch = [serve.Request(rid=r) for r in (4, 9, 11)]
    out = server._work_fn(0, batch, 0)
    assert sorted(out) == [4, 9, 11]
    again = server._work_batch([4, 9, 11])
    for i, rid in enumerate((4, 9, 11)):
        np.testing.assert_array_equal(out[rid], again[i])
    prompts = server.prompts([4, 9, 11])
    assert prompts.shape == (3, 8)
    assert prompts[:, 0].tolist() == [4, 9, 11]


def test_cli_serves_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "3", "--nodes", "2",
                       "--batch-per-node", "1", "--prompt-len", "8",
                       "--decode-tokens", "2"]) == 0
    assert "[serve] OK" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--fail", "1:2"], ["--recovery", "shrink"]])
def test_cli_rejects_fault_flags_until_the_control_plane(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", *flag])
    assert exc.value.code == 2
    assert "next slice" in capsys.readouterr().err


def test_entry_points_need_the_card_unless_told_cpu(monkeypatch):
    """Without a GPU the defaults raise; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3.2-3b")
    for call in (lambda: api.init_params(cfg),
                 lambda: api.init_cache(cfg, 1, 8),
                 lambda: serve.ResilientServer(cfg),
                 lambda: serve.main(["--requests", "1"]),
                 lambda: params_from_reference(cfg, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert device_mod.resolve_device("cpu").type == "cpu"
