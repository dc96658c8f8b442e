"""The placement helpers on real values over four gloo ranks.

``tests/torch_multirank_ranks.py helpers`` runs on a (2, 2) ``("data",
"model")`` mesh of four CPU ranks, so every block offset is nonzero on some
rank and every partial-sum mask drops rows somewhere:

- ``take_last`` and ``argmax_last`` on vocab-parallel logits, with maxima
  tied across the two vocab blocks, and on a vocab of 15 that DTensor cuts
  into blocks of 8 and 7;
- ``take_rows`` on a vocab-parallel table (16 and 15 rows), forward and the
  table's gradient;
- ``split_last`` into 4 heads (split in place) and 3 heads (gathered
  first), ``merge_last``, and their gradients;
- ``per_shard`` through ``blocked_attention``, ``decode_attention`` and
  ``ssd_chunked_reference`` (its final state's heads moved to dim 1);
- the steps of ``PLACED_STEPS`` (fp32 smoke configs, 2 layers, batch 4) on
  inputs placed by ``cell_shardings``.

Each result, made whole over the mesh, is held against the plain op on
whole tensors: exactly where the op only selects or moves values, to fp32
rounding (rtol 1e-5, atol 1e-6) where a sum is split over the ranks, and
the steps to rtol 1e-4, atol 1e-5.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
RANKS = REPO / "tests" / "torch_multirank_ranks.py"
WORLD = 4
TIMEOUT_S = 600

EXACT = ("take_last/", "argmax_last/", "take_rows/", "split_last/", "ssd/state_heads_dim")
SUMMED = ("take_rows_grad/", "split_last_grad/", "merge_last", "blocked_attention",
          "decode_attention", "ssd/")


def _inputs() -> dict:
    rng = np.random.default_rng(21)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    logits = normal(4, 3, 16)
    logits[0, 0, [3, 11]] = 9.0          # tie across the blocks: the first wins
    logits[1, 2, [9, 12]] = 9.0          # tie inside the second block
    logits[2, 1, 10] = 9.0               # the maximum only in the second block
    logits15 = normal(4, 3, 15)
    logits15[0, 1, [5, 14]] = 9.0        # tie across blocks of 8 and 7
    logits15[3, 0, 8] = 9.0              # first element of the short block
    return {
        "logits": logits, "labels": rng.integers(0, 16, (4, 3)),
        "logits15": logits15, "labels15": rng.integers(0, 15, (4, 3)),
        "table": normal(16, 6), "ids": rng.integers(0, 16, (4, 3)),
        "table15": normal(15, 6), "ids15": rng.integers(0, 15, (4, 3)),
        "row_w": normal(4, 3, 6),
        "proj": normal(4, 3, 12), "proj_w": normal(4, 3, 12),
        "heads_out": normal(4, 3, 4, 3), "merge_w": normal(12, 5),
        "q": normal(4, 8, 4, 8), "k": normal(4, 8, 2, 8), "v": normal(4, 8, 2, 8),
        "dq": normal(4, 1, 4, 8), "kc": normal(4, 10, 2, 8), "vc": normal(4, 10, 2, 8),
        "valid": rng.random((4, 10)) < 0.7,
        "ssd_x": normal(4, 8, 4, 3),
        "ssd_dt": np.log1p(np.exp(normal(4, 8, 4))).astype(np.float32),
        "ssd_A": -np.exp(normal(4)).astype(np.float32),
        "ssd_B": normal(4, 8, 1, 5), "ssd_C": normal(4, 8, 1, 5),
        "ssd_h0": normal(4, 4, 3, 5),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list[dict]:
    """What each of the four ranks saw, {name: (over the mesh, plain)}."""
    workdir = tmp_path_factory.mktemp("placement_ranks")
    np.savez(workdir / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(RANKS), "helpers", str(rank), str(WORLD),
                               str(workdir)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(WORLD)]
    failures = []
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"rank {rank} exited {proc.returncode}:\n{out[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert not failures, "\n".join(failures)
    seen = []
    for rank in range(WORLD):
        with open(workdir / f"helpers.rank{rank}.pkl", "rb") as f:
            seen.append(pickle.load(f))
    return seen


def _names(prefixes) -> list[str]:
    from_inputs = {
        "take_last/": ["logits", "logits15"], "argmax_last/": ["logits", "logits15"],
        "take_rows/": ["table", "table15"], "take_rows_grad/": ["table", "table15"],
        "split_last/": ["4", "3"], "split_last_grad/": ["4", "3"], "ssd/": ["y", "state"],
    }
    names = []
    for p in prefixes:
        names += [p + s for s in from_inputs.get(p, [""])]
    return [n.rstrip("/") for n in names]


@pytest.mark.parametrize("name", _names(EXACT))
def test_helper_equals_the_plain_op_exactly(ranks, name):
    for rank, seen in enumerate(ranks):
        got, want = seen[name]
        assert got.shape == want.shape and np.array_equal(got, want), (name, rank, got, want)


@pytest.mark.parametrize("name", _names(SUMMED))
def test_helper_matches_the_plain_op(ranks, name):
    for rank, seen in enumerate(ranks):
        got, want = seen[name]
        assert got.shape == want.shape, (name, rank)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{name} rank {rank}")


def test_argmax_ties_resolve_to_the_first_maximum(ranks):
    got, _ = ranks[0]["argmax_last/logits"]
    assert got[0, 0] == 3 and got[1, 2] == 9 and got[2, 1] == 10
    got15, _ = ranks[0]["argmax_last/logits15"]
    assert got15[0, 1] == 5 and got15[3, 0] == 8


@pytest.mark.parametrize("name", [f"step/{a}/{k}" for a, k in (
    ("llama3.2-3b", "train"), ("llama3.2-3b", "prefill"), ("llama3.2-3b", "decode"),
    ("mamba2-130m", "train"), ("mamba2-130m", "prefill"), ("hymba-1.5b", "decode"))])
def test_step_on_placed_inputs_matches_the_plain_step(ranks, name):
    for rank, seen in enumerate(ranks):
        got, want = seen[name]
        assert len(got) == len(want) > 0, (name, rank)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (name, rank, i)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} rank {rank} output leaf {i}")
