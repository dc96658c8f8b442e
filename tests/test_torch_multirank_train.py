"""The port's trainer over ranks on the CPU: four gloo ranks against the
reference trainer and the port's own one-rank trainer.

Three groups of processes start once for the module, all at once:

- four ranks (``tests/torch_multirank_ranks.py train``, a file rendezvous)
  train ``TINY_FIELDS`` in f32 on 8 nodes in legions of 4 through each run
  of ``TRAIN_RUNS``: faults (2, 1) and (4, 5) with shrink, the same under
  ``batch_policy="rebalance"``, and a run with ``checkpoint_every=2`` that
  restores node 1 and goes on;
- one rank (``... train1``) starts through ``init_from_env`` at world size 1
  and runs the shrink run through the step over the group, then, with the
  group destroyed, through the one-rank step;
- torchrun starts ``python -m repro_torch.launch.train --device cpu
  --backend gloo`` on four ranks with the smoke config and ``--fail 2:1``.

Meanwhile this process runs the same runs through the JAX package's
trainer (under ``test_torch_runtime``'s stand-in for its uncommitted
data-plane module), through the port's trainer on one rank, and the
one-rank training CLI. The mean gradient over the live shards is the same
number on any count of ranks, so the reference on one device is the
oracle. Tolerances: integers exact; loss and grad norm within
``TRAJECTORY_TOL`` (1e-4) of the reference and 1e-5 of the port's one rank
(measured: 9e-7 and 8e-7); the final params within 1e-5 of the one-rank run's on all
but 0.1% of each leaf's elements and within 2 x lr x steps on every one
(an element whose summed gradient is near zero may take an Adam step of
the other sign; measured: 1.1e-6 at most); bit for bit at world size 1.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_multirank import (  # noqa: E402
    REPO,
    RANKS,
    TIMEOUT_S,
    _check_leaves,
    _free_port,
)
from test_torch_runtime import _stand_in_module  # noqa: E402
from test_torch_train import TINY_FIELDS, TRAJECTORY_TOL  # noqa: E402

import torch_multirank_ranks as rank_program  # noqa: E402
from repro.checkpoint import store as jax_store  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import LegionCheckpointer  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402

WORLD = 4
ONE_RANK_TOL = 1e-5
PARAM_ATOL, PARAM_OUTLIERS = 1e-5, 1e-3
CLI_ARGS = ["--steps", "6", "--nodes", "8", "--fail", "2:1", "--json"]
# the CLI trains the smoke config in bf16: each rank's partial gradient is
# rounded to bf16 before the fp32 sum over the ranks, so after the first
# update the params move apart by single bf16 ulps (measured: the last
# loss 2.2e-5 from the one rank's); the first loss, before any update, is
# bit-equal
CLI_FIRST_TOL, CLI_LAST_TOL = 1e-5, 1e-4
RUNS = list(rank_program.TRAIN_RUNS)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (str(k),))
    else:
        yield "/".join(path), tree


def _reference_run(R, jcfg, init, name, workdir) -> dict:
    """``TRAIN_RUNS[name]`` through the JAX package's trainer."""
    spec = rank_program.TRAIN_RUNS[name]
    ck = R.LegionCheckpointer(str(workdir / f"ref_ckpt_{name}")) if "restore" in spec else None
    tc = JaxTrainConfig(**rank_program.TRAIN_TC,
                        checkpoint_every=rank_program.CHECKPOINT_EVERY if ck else 0)
    cl = R.VirtualCluster(rank_program.TRAIN_NODES,
                          policy=R.LegioPolicy(legion_size=rank_program.TRAIN_LEGION,
                                               **spec["policy"]),
                          injector=R.FaultInjector.at(spec["faults"]))
    tj = R.ResilientTrainer(jcfg, tc, cl, per_shard_batch=rank_program.PER_SHARD_BATCH,
                            seq_len=rank_program.SEQ_LEN, checkpointer=ck)
    for key, leaf in _flat(jax.tree.map(np.asarray, tj.params)):
        assert np.array_equal(leaf, init[key]), key     # the ranks' weights
    reports = rank_program.drive(tj, spec, ck)
    if ck is not None:
        ck.close()
    batch, _ = tj._global_batch(tj.step - 1)
    return {"reports": [rank_program.report_record(r) for r in reports],
            "live_nodes": list(cl.live_nodes), "last_tokens": np.asarray(batch["tokens"])}


def _one_rank_run(pcfg, init_tree, name, workdir) -> dict:
    """``TRAIN_RUNS[name]`` through the port's trainer on one rank."""
    spec = rank_program.TRAIN_RUNS[name]
    ck = LegionCheckpointer(str(workdir / f"one_ckpt_{name}")) if "restore" in spec else None
    tr = rank_program.port_trainer(pcfg, spec, init_tree, "sim", ck)
    reports = rank_program.drive(tr, spec, ck)
    if ck is not None:
        ck.close()
    return {"reports": [rank_program.report_record(r) for r in reports],
            "final": {f"params/{k}": v.numpy() for k, v in _flat(tr.params)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks and torchrun, run the reference and the one-rank
    runs here meanwhile, wait for all, load the ranks' pickles."""
    workdir = tmp_path_factory.mktemp("multirank_train")
    jcfg, pcfg = JaxModelConfig(**TINY_FIELDS), ModelConfig(**TINY_FIELDS)
    init = dict(_flat(jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))))
    np.savez(workdir / "inputs.npz", fields=np.asarray(json.dumps(TINY_FIELDS)),
             **{f"init/{k}": v for k, v in init.items()})
    base = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        base.pop(k, None)
    procs = {}
    for rank in range(WORLD):
        procs[("train", rank)] = subprocess.Popen(
            [sys.executable, str(RANKS), "train", str(rank), str(WORLD), str(workdir)],
            env=base, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    procs[("train1", 0)] = subprocess.Popen(
        [sys.executable, str(RANKS), "train1", "0", "1", str(workdir)],
        env=dict(base, RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                 MASTER_PORT=str(_free_port())),
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", "repro_torch.launch.train", "--device", "cpu",
         "--backend", "gloo", *CLI_ARGS],
        env=base, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    loaded = {"init": init, "workdir": workdir}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "repro.dist.dataplane", _stand_in_module())
            import repro.core as R

            loaded["reference"] = {name: _reference_run(R, jcfg, init, name, workdir)
                                   for name in RUNS}
        init_tree = rank_program.unflatten({f"init/{k}": v for k, v in init.items()}, "init/")
        loaded["one"] = {name: _one_rank_run(pcfg, init_tree, name, workdir) for name in RUNS}
        loaded["cli_one"] = _one_rank_cli()
        failures = []
        for key, proc in procs.items():
            out, _ = proc.communicate(timeout=TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"{key} exited {proc.returncode}:\n{out[-3000:]}")
        cli_out, cli_err = cli.communicate(timeout=TIMEOUT_S)
        if cli.returncode != 0:
            failures.append(f"torchrun exited {cli.returncode}:\n{cli_err[-3000:]}")
    finally:
        for proc in (*procs.values(), cli):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert not failures, "\n".join(failures)
    loaded["cli_out"] = cli_out
    for case, world in (("train", WORLD), ("train1", 1)):
        loaded[case] = []
        for rank in range(world):
            with open(workdir / f"{case}.rank{rank}.pkl", "rb") as f:
                loaded[case].append(pickle.load(f))
    return loaded


def _one_rank_cli() -> dict:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_mod.main(CLI_ARGS + ["--device", "cpu"]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _integers(reports: list[dict]) -> list[tuple]:
    return [(r["step"], r["active_shards"], r["recompiled"], r["repair"]) for r in reports]


def _reference_specs(n: int) -> dict:
    """The reference's param_specs of TINY's params on a (n, 1) mesh, by
    "/"-joined path."""
    from repro.dist import sharding as ref_sharding
    from repro.dist.compat import abstract_mesh

    shapes = jax.eval_shape(lambda: jax_api.init_params(JaxModelConfig(**TINY_FIELDS),
                                                        jax.random.PRNGKey(0)))
    specs = ref_sharding.param_specs(None, shapes, abstract_mesh((n, 1), ("data", "model")))
    return {k: tuple(v) for k, v in _flat(specs)}


def _check_state(seen: dict, n_ranks: list[int], rank: int) -> None:
    """Every leaf of params, mu and nu placed as the reference's spec of its
    parameter says on the (len(n_ranks), 1) mesh of ``n_ranks``, each rank
    holding its block of the whole (nothing outside the mesh)."""
    specs = _reference_specs(len(n_ranks))
    assert {k.split("/", 1)[0] for k in seen} == {"params", "mu", "nu"}
    _check_leaves(seen, {k: specs[k.split("/", 1)[1]] for k in seen},
                  {k: v["whole"] for k, v in seen.items()}, n_ranks, rank)


# ---------------------------------------------------------------------------
# the four ranks against the reference and the one-rank trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", RUNS)
def test_train_world4_matches_reference(runs, name):
    """Steps, active shards, recompiles, repair summaries and live nodes
    equal to the JAX package's trainer on every rank; loss and grad norm
    within TRAJECTORY_TOL; the last step's tokens, the ranks' batches put in
    shard order, byte-equal to its global batch."""
    want = runs["reference"][name]
    assert want["reports"][2]["repair"] is not None
    for rank, out in enumerate(runs["train"]):
        got = out[name]
        assert got["distributed"]
        assert _integers(got["reports"]) == _integers(want["reports"]), (rank, name)
        assert got["live_nodes"] == want["live_nodes"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([r[key] for r in got["reports"]],
                                       [r[key] for r in want["reports"]], rtol=TRAJECTORY_TOL,
                                       err_msg=f"rank {rank} {name} {key}")
    rows = {}
    psb = rank_program.PER_SHARD_BATCH
    for out in runs["train"]:
        got = out[name]
        for i, shard in enumerate(got["last_shards"]):
            assert shard not in rows
            rows[shard] = got["last_tokens"][i * psb:(i + 1) * psb]
    tokens = np.concatenate([rows[s] for s in sorted(rows)])
    assert tokens.tobytes() == want["last_tokens"].tobytes()
    assert len(rows) == want["reports"][-1]["active_shards"]


@pytest.mark.parametrize("name", RUNS)
def test_train_world4_matches_one_rank(runs, name):
    """The port's trainer on four ranks against itself on one: the integers
    equal, loss and grad norm within 1e-5, the final params within the
    module's stated tolerance."""
    one = runs["one"][name]
    lr, steps = rank_program.TRAIN_TC["learning_rate"], len(one["reports"])
    for rank, out in enumerate(runs["train"]):
        got = out[name]
        assert _integers(got["reports"]) == _integers(one["reports"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([r[key] for r in got["reports"]],
                                       [r[key] for r in one["reports"]], rtol=ONE_RANK_TOL,
                                       err_msg=f"rank {rank} {name} {key}")
        assert set(got["final"]) == set(one["final"])
        for key, want in one["final"].items():
            diff = np.abs(got["final"][key] - want)
            assert diff.max() <= 2 * lr * steps, (rank, name, key, diff.max())
            assert np.mean(diff > PARAM_ATOL) <= PARAM_OUTLIERS, (rank, name, key)


@pytest.mark.parametrize("name", RUNS)
def test_train_world4_ranks_report_the_same(runs, name):
    """Every rank's TrainerReports are equal, floats and metrics included,
    rank 1 with no node as well."""
    first = runs["train"][0][name]["reports"]
    assert len(first) == rank_program.TRAIN_RUNS[name]["steps"] + \
        rank_program.TRAIN_RUNS[name].get("after", 0)
    for rank, out in enumerate(runs["train"][1:], start=1):
        assert out[name]["reports"] == first, (rank, name)


@pytest.mark.parametrize("name", ["shrink", "rebalance"])
def test_train_world4_state_placed_after_each_repair(runs, name):
    """After the repair at step 2 params, mu and nu are placed by the
    reference's param_specs on the four ranks' mesh; after the one at step
    4, on ranks 0, 2 and 3, and rank 1 holds no block."""
    for rank, out in enumerate(runs["train"]):
        got = out[name]
        assert sorted(got["after_repair"]) == [2, 4]
        assert [(n, shape) for n, shape, _ in got["reshards"]] == [(4, (4, 1)), (3, (3, 1))]
        _check_state(got["after_repair"][2], [0, 1, 2, 3], rank)
        _check_state(got["after_repair"][4], [0, 2, 3], rank)
    held = [leaf["local"].size for leaf in runs["train"][1][name]["after_repair"][4].values()]
    assert held and not any(held)


def test_train_world4_restore_continues(runs):
    """restore_from of node 1 after the save at step 4 gives back the state
    the ranks held, bit for bit, placed again by param_specs on the (4, 1)
    mesh; the run then goes on as the reference's and the one rank's do
    (the tests above hold its later reports)."""
    for rank, out in enumerate(runs["train"]):
        got = out["checkpoint"]
        before, after = got["before restore"], got["restored"]
        assert set(before) == set(after)
        for key, leaf in after.items():
            assert leaf["whole"].tobytes() == before[key]["whole"].tobytes(), (rank, key)
        _check_state(after, [0, 1, 2, 3], rank)
        assert [r["step"] for r in got["reports"]] == [0, 1, 2, 3, 4, 4, 5]


@pytest.mark.parametrize("step", [2, 4])
def test_train_world4_checkpoint_reads_under_reference_restore(runs, step):
    """The files the four ranks wrote (rank 0 alone writes) read back under
    the reference's ``restore``: one file a live member, each holding the
    whole params and moments the ranks held at that save and the member's
    shards."""
    saved = runs["train"][0]["checkpoint"]["saved"][step]
    manifest, got = jax_store.restore(str(runs["workdir"] / "ckpt_checkpoint"), step)
    assert manifest.step == step
    live = [0, 1, 2, 3, 4, 6, 7]                 # node 5 died at step 2
    # 8 nodes are below the hierarchical threshold (12): one flat legion
    assert sorted(got) == [(0, node) for node in live]
    for (legion, node), tree in got.items():
        assert np.asarray(tree["meta"]["step"]) == step
        assert np.asarray(tree["meta"]["shards"]).tolist() == [node]
        flat = dict(_flat({"params": tree["params"], "mu": tree["opt"]["mu"],
                           "nu": tree["opt"]["nu"]}))
        assert set(flat) == set(saved)
        for key, want in saved.items():
            assert np.asarray(flat[key]).tobytes() == want.tobytes(), (node, key)


def test_train_world1_group_step_is_bit_identical(runs):
    """``init_from_env("cpu")`` at world size 1: the step over the group
    gives every report (losses, grad norms, metrics) and the final params
    bit for bit as the one-rank step does."""
    (out,) = runs["train1"]
    assert out["device"] == "cpu"
    assert (out["group"]["distributed"], out["one"]["distributed"]) == (True, False)
    assert out["group"]["reports"] == out["one"]["reports"]
    assert out["one"]["reports"][4]["active_shards"] == 6
    assert set(out["group"]["final"]) == set(out["one"]["final"])
    for key, want in out["one"]["final"].items():
        assert out["group"]["final"][key].tobytes() == want.tobytes(), key


def test_cli_under_torchrun_world4(runs):
    """Rank 0's JSON report (the other ranks print nothing) against the
    one-rank CLI's: the integer fields equal, the losses within the
    module's stated tolerances."""
    lines = [line for line in runs["cli_out"].splitlines() if line.startswith("{")]
    assert len(lines) == 1, runs["cli_out"]
    got, want = json.loads(lines[0]), runs["cli_one"]
    for k in ("arch", "steps", "repairs", "survivors"):
        assert got[k] == want[k], k
    assert (got["repairs"], got["survivors"]) == (1, 7)
    np.testing.assert_allclose(got["first_loss"], want["first_loss"], rtol=CLI_FIRST_TOL)
    np.testing.assert_allclose(got["last_loss"], want["last_loss"], rtol=CLI_LAST_TOL)
