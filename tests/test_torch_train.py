"""The port's training path vs the JAX package's, on the CPU.

  * ``train_loss`` and its gradients against ``jax.value_and_grad`` of the
    reference's, on the same weights (carried across with
    ``params_from_reference``) and tokens (numpy, from a seed): ``TINY`` of
    ``tests/test_trainer.py`` and the llama3.2, hymba and mamba2 smoke
    configs in f32 (loss within 1e-5 relative, each gradient leaf within
    1e-4 relative in norm; measured: 2e-7 and 6e-6), the llama3.2 smoke
    config in bf16 (loss within 2e-2), ``remat`` "full" against "none".
  * ``ResilientTrainer`` side by side with the reference's under the
    stand-in data plane (test_torch_runtime.py's): the same step list, active
    shards, repair summaries (up to the measured wall time), live nodes,
    and losses within 1e-4 in f32 (measured: 3.1e-6 over 30 steps of
    ``TINY``, 5.1e-7 over its first 10, 2.3e-7 on the headline scenario)
    and 2e-2 in bf16 (measured 5.5e-5).
  * the five ``tests/test_trainer.py`` tests and the headline claim of
    ``tests/test_system.py`` on the port alone, and the training CLI
    against the reference's ``main``.
"""
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_runtime import _stand_in_module  # noqa: E402

from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.common import layer_params  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

TINY_FIELDS = dict(
    name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64,
    attn_block_q=16, attn_block_k=16, xent_chunk=16, remat="none",
    param_dtype="float32", dtype="float32",
)
TINY = ModelConfig(**TINY_FIELDS)
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
TRAJECTORY_TOL = 1e-4


@pytest.fixture
def reference(monkeypatch):
    """The JAX package's runtime with the stand-in ``repro.dist.dataplane``
    of test_torch_runtime.py, for this test only."""
    monkeypatch.setitem(sys.modules, "repro.dist.dataplane", _stand_in_module())
    import repro.core as R
    return R


def config_pair(name, dtype):
    if name == "tiny":
        return JaxModelConfig(**TINY_FIELDS), TINY
    kw = dict(dtype=dtype, param_dtype=dtype)
    return jax_smoke_config(name).replace(**kw), get_smoke_config(name).replace(**kw)


def batch_pair(vocab, seed, B=4, S=32):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    pb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    return jb, pb


def port_loss_and_grads(cfg, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = api.train_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", [("tiny", "float32"), ("llama3.2-3b", "float32"),
                                        ("hymba-1.5b", "float32"), ("mamba2-130m", "float32"),
                                        ("llama3.2-3b", "bfloat16")])
def test_train_loss_and_grads_match_reference(name, dtype):
    jcfg, pcfg = config_pair(name, dtype)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_reference(pcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    jb, pb = batch_pair(jcfg.vocab_size, seed=1)
    (jl, jm), jg = jax.value_and_grad(lambda p: jax_api.train_loss(jcfg, p, jb),
                                      has_aux=True)(jparams)
    losses = {}
    for remat in ("full", "none"):
        loss, metrics, grads = port_loss_and_grads(pcfg.replace(remat=remat), params, pb)
        losses[remat] = (loss, grads)
        assert abs(loss.item() - float(jl)) <= LOSS_TOL[dtype] * abs(float(jl))
        for k in ("nll", "z_loss", "accuracy"):
            np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=LOSS_TOL[dtype])
        if dtype == "float32":
            for want, got in zip(jax.tree.leaves(jg), grads):
                want = np.asarray(want, np.float32)
                err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
                assert err <= GRAD_TOL, err
    # remat recomputes the same operations: the same loss and gradients
    (lf, gf), (ln, gn) = losses["full"], losses["none"]
    assert torch.equal(lf, ln)
    assert all(torch.equal(a, b) for a, b in zip(gf, gn))


def test_train_loss_refuses_pallas():
    with pytest.raises(ValueError, match="forward-only"):
        api.train_loss(TINY.replace(use_pallas=True), {}, {})


def test_layer_params_are_views_of_the_stacked_leaves():
    """Serving reads the same elements as per-layer indexing did, and a
    stacked leaf's gradient is one (L, ...) buffer."""
    cfg = get_smoke_config("hymba-1.5b").replace(dtype="float32", param_dtype="float32")
    params = api.init_params(cfg, device="cpu")
    layers = layer_params(params["layers"])
    assert len(layers) == cfg.n_layers
    for i, lp in enumerate(layers):
        for name in ("attn_norm", "mlp_norm"):
            assert lp[name].data_ptr() == params["layers"][name][i].data_ptr()
            assert torch.equal(lp[name], params["layers"][name][i])
        assert torch.equal(lp["ssm"]["A_log"], params["layers"]["ssm"]["A_log"][i])
        assert torch.equal(lp["attn"]["wq"], params["layers"]["attn"]["wq"][i])
    _, pb = batch_pair(cfg.vocab_size, seed=2)
    _, _, grads = port_loss_and_grads(cfg, params, pb)
    for p, g in zip(tree_leaves(params), grads):
        assert g.shape == p.shape and torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# the trainer, side by side with the reference's
# ---------------------------------------------------------------------------

def summary(report):
    """A repair report's summary without its measured wall time."""
    return None if report is None else re.sub(r"wall=\S+", "wall=*", report.summary())


def side_by_side(R, jcfg, pcfg, *, nodes, faults, steps, per_shard_batch, seq_len, tc):
    tj = R.ResilientTrainer(jcfg, JaxTrainConfig(**tc),
                            R.VirtualCluster(nodes, injector=R.FaultInjector.at(faults)),
                            per_shard_batch=per_shard_batch, seq_len=seq_len)
    cluster = P.VirtualCluster(nodes, policy=P.LegioPolicy(data_plane="sim"),
                               injector=P.FaultInjector.at(faults), device="cpu")
    tp = P.ResilientTrainer(pcfg, TrainConfig(**tc), cluster,
                            per_shard_batch=per_shard_batch, seq_len=seq_len)
    tp.params = params_from_reference(pcfg, jax.tree.map(np.asarray, tj.params), device="cpu")
    tp.opt = adamw_init(tp.params)
    rj, rp = tj.run(steps), tp.run(steps)
    assert [r.step for r in rp] == [r.step for r in rj] == list(range(steps))
    assert [r.active_shards for r in rp] == [r.active_shards for r in rj]
    assert [r.recompiled for r in rp] == [r.recompiled for r in rj]
    assert [summary(r.repair) for r in rp] == [summary(r.repair) for r in rj]
    assert cluster.live_nodes == tj.cluster.live_nodes
    batch_j, _ = tj._global_batch(steps - 1)
    batch_p, _ = tp._global_batch(steps - 1)
    assert batch_p["tokens"].numpy().tobytes() == np.asarray(batch_j["tokens"]).tobytes()
    return rj, rp


def test_training_survives_faults_side_by_side(reference):
    """test_trainer.py::test_training_survives_faults on both packages."""
    jcfg, pcfg = config_pair("tiny", "float32")
    rj, rp = side_by_side(reference, jcfg, pcfg, nodes=4, faults=[(10, 1), (20, 3)], steps=30,
                          per_shard_batch=4, seq_len=32,
                          tc=dict(learning_rate=3e-2, total_steps=30, warmup_steps=4,
                                  grad_clip=1.0))
    assert [r.active_shards for r in rp][9:12] == [4, 3, 3]
    np.testing.assert_allclose([r.loss for r in rp], [r.loss for r in rj],
                               rtol=TRAJECTORY_TOL)
    np.testing.assert_allclose([r.grad_norm for r in rp], [r.grad_norm for r in rj],
                               rtol=TRAJECTORY_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_headline_claim_side_by_side(reference, dtype):
    """test_system.py::test_headline_claim_no_restart on both packages: the
    smoke config as configured (bf16) and in f32."""
    jcfg, pcfg = config_pair("llama3.2-3b", dtype)
    rj, rp = side_by_side(reference, jcfg, pcfg, nodes=6, faults=[(4, 1), (4, 2)], steps=10,
                          per_shard_batch=2, seq_len=32,
                          tc=dict(total_steps=10, warmup_steps=2))
    assert rp[4].repair is not None and [r.active_shards for r in rp][3:5] == [6, 4]
    tol = TRAJECTORY_TOL if dtype == "float32" else LOSS_TOL["bfloat16"]
    np.testing.assert_allclose([r.loss for r in rp], [r.loss for r in rj], rtol=tol)


def test_cli_matches_reference(reference, capsys):
    from repro.launch import train as jax_train

    argv = ["--steps", "6", "--nodes", "8", "--fail", "2:3", "--json"]
    assert jax_train.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert train_mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = json.loads(out.strip().splitlines()[-1])
    assert "REPAIR [repair/" in out
    for k in ("arch", "steps", "repairs", "survivors", "sim_seconds"):
        assert got[k] == want[k], k
    assert got["survivors"] == 7 and got["repairs"] == 1
    np.testing.assert_allclose(got["first_loss"], want["first_loss"], rtol=LOSS_TOL["bfloat16"])


# ---------------------------------------------------------------------------
# tests/test_trainer.py and the headline claim, on the port alone
# ---------------------------------------------------------------------------

def make_trainer(nodes=4, injector=None, policy=None, steps=40, **kw):
    tc = TrainConfig(learning_rate=3e-2, total_steps=steps, warmup_steps=4, grad_clip=1.0)
    cl = P.VirtualCluster(nodes, policy=policy or P.LegioPolicy(data_plane="sim"),
                          injector=injector or P.FaultInjector(), device="cpu")
    return P.ResilientTrainer(TINY, tc, cl, per_shard_batch=4, seq_len=32, **kw)


def test_loss_decreases():
    tr = make_trainer(steps=60)
    reports = tr.run(60)
    first = np.mean([r.loss for r in reports[:5]])
    last = np.mean([r.loss for r in reports[-5:]])
    assert last < first - 0.4, (first, last)


def test_training_survives_faults():
    tr = make_trainer(nodes=4, injector=P.FaultInjector.at([(10, 1), (20, 3)]), steps=30)
    reports = tr.run(30)
    assert reports[10].repair is not None
    assert reports[20].repair is not None
    assert reports[10].active_shards == 3
    assert reports[20].active_shards == 2
    assert np.isfinite(reports[-1].loss)
    assert np.mean([r.loss for r in reports[-5:]]) < reports[0].loss


def test_drop_vs_rebalance_batch_sizes():
    tr = make_trainer(nodes=4, injector=P.FaultInjector.at([(2, 0)]),
                      policy=P.LegioPolicy(batch_policy="rebalance", data_plane="sim"), steps=6)
    tr.run(6)
    batch, _ = tr._global_batch(5)
    assert batch["tokens"].shape[0] == 4 * 4
    dropped = make_trainer(nodes=4, injector=P.FaultInjector.at([(2, 0)]), steps=6)
    dropped.run(6)
    assert dropped._global_batch(5)[0]["tokens"].shape[0] == 3 * 4


def test_checkpoint_restart_only_failed(tmp_path):
    ck = P.LegionCheckpointer(str(tmp_path), async_writes=False)
    tr = make_trainer(nodes=4, steps=12)
    tr.checkpointer = ck
    for _ in range(6):
        tr.run_step()
    ck.save(6, tr.cluster.topo, tr._state_of, sync=True)
    # a "replacement" trainer restores ONLY the dead member's shard
    tr2 = make_trainer(nodes=4, steps=12)
    tr2.restore_from(ck, legion=0, node=1)
    for a, b in zip(tree_leaves(tr.params), tree_leaves(tr2.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-6)
    assert tr2.step == 6
    assert int(tr2.opt.step) == int(tr.opt.step) == 6
    # and both continue identically: the CPU step is deterministic
    assert tr.run_step().loss == tr2.run_step().loss


def test_nonfinite_loss_raises():
    tr = make_trainer(steps=4)
    tr.params = {k: v for k, v in tr.params.items()}
    tr.params["embed"] = tr.params["embed"] * float("nan")
    with pytest.raises(FloatingPointError):
        tr.run_step()


def test_headline_claim_no_restart():
    cfg = get_smoke_config("llama3.2-3b")
    cl = P.VirtualCluster(6, policy=P.LegioPolicy(data_plane="sim"),
                          injector=P.FaultInjector.at([(4, 1), (4, 2)]), device="cpu")
    tr = P.ResilientTrainer(cfg, TrainConfig(total_steps=10, warmup_steps=2), cl,
                            per_shard_batch=2, seq_len=32)
    reports = tr.run(10)
    assert [r.step for r in reports] == list(range(10))
    assert reports[4].repair is not None
    assert len(cl.live_nodes) == 4
    assert np.isfinite(reports[-1].loss)


def test_trainer_needs_a_card_unless_told_cpu():
    cl = P.VirtualCluster(2, policy=P.LegioPolicy(data_plane="sim"))
    if torch.cuda.is_available():
        assert P.ResilientTrainer(TINY, TrainConfig(), cl).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ResilientTrainer(TINY, TrainConfig(), cl)
