"""The per-op attribution of the dry-run step (``hlo_stats.CostMode(
attribute=True)``, ``hlo_stats.contributors``) and ``launch/kernel_roofline``.

- On the mini cells of tests/test_dryrun_mini.py (llama's smoke config at
  4 layers on a (2, 2, 2) mesh of torch's fake group), the rows summed give
  ``CostMode.cost`` exactly (bytes, FLOPs, wire bytes: every term is a
  dyadic rational, so the sums do not depend on their order), and the
  totals with attribution on equal those with it off.
- A lone ``mm`` is one row: 2mnk FLOPs, the bytes of its operands and
  result.
- ``attention_interior_bytes`` of a blocked attention (forward and
  backward) equals the bytes of its (block_q, block_k)-shaped ops counted
  here by a dispatch mode of the test's own; a product of that shape
  outside the attention is not counted.
- The CLI prints the reference's lines.

Not held: the reference's HLO-text cases (while-loop trips, the wire
model of tests/test_sharding.py) have no torch input, and the port's
unfused eager byte count is not XLA's fused one, so its interior share is
not the reference's number.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.launch import hlo_stats, kernel_roofline  # noqa: E402
from repro_torch.models.attention import blocked_attention  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 600
KEYS = {"comp", "name", "opcode", "shape", "scale", "bytes", "flops", "wire", "meta"}

_MINI = textwrap.dedent("""
    import json
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import dryrun, hlo_stats
    from repro_torch.launch.mesh import make_named_mesh

    dryrun.fake_group(8)
    mesh = make_named_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    cfg = get_smoke_config("llama3.2-3b").replace(n_layers=4)
    out = {}
    for shape in (ShapeSpec("mini_train", 64, 8, "train"),
                  ShapeSpec("mini_decode", 64, 8, "decode")):
        off = dryrun.dryrun_step(cfg, shape, mesh)["cost"]
        m = dryrun.dryrun_step(cfg, shape, mesh, attribute=True)
        rows = hlo_stats.contributors(m["cost_mode"], top=None)
        cost = m["cost"]
        out[shape.name] = {
            "cost": [cost.bytes, cost.flops, cost.coll.total_wire_bytes],
            "off": [off.bytes, off.flops, off.coll.total_wire_bytes],
            "sums": [sum(r["bytes"] for r in rows), sum(r["flops"] for r in rows),
                     sum(r["wire"] for r in rows)],
            "keys": sorted({k for r in rows for k in r}),
            "top": hlo_stats.contributors(m["cost_mode"]),
            "sites": sorted({r["comp"] for r in rows}),
        }
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def mini():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _MINI], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["mini_train", "mini_decode"])
def test_contributors_sum_to_the_cost_exactly(mini, cell):
    rec = mini[cell]
    assert rec["sums"] == rec["cost"]
    assert rec["cost"] == rec["off"]
    assert rec["cost"][0] > 0 and rec["cost"][1] > 0 and rec["cost"][2] > 0
    assert set(rec["keys"]) == KEYS


@pytest.mark.parametrize("cell", ["mini_train", "mini_decode"])
def test_contributors_sorted_as_the_reference_sorts(mini, cell):
    top = mini[cell]["top"]
    assert len(top) == 30
    keys = [r["bytes"] + 10 * r["wire"] for r in top]
    assert keys == sorted(keys, reverse=True)
    for r in top:
        assert r["comp"] == r["meta"] and r["scale"] >= 1


def test_sites_are_the_models_functions(mini):
    """The train cell's ops sit in the models' functions, its backward's
    too (the blocked loop's gradient ops), the optimizer's in adamw."""
    sites = set(mini["mini_train"]["sites"])
    assert {"attention._blocked_loop", "common.rms_norm", "common._xent_chunk"} <= sites
    assert any(s.startswith("adamw.") for s in sites)
    assert "attention.decode_attention" in set(mini["mini_decode"]["sites"])


def test_a_lone_mm_is_one_row():
    m, n, k = 24, 40, 56
    a = torch.zeros((m, k), device="meta")
    b = torch.zeros((k, n), device="meta")
    mode = hlo_stats.CostMode(attribute=True)
    with mode:
        torch.mm(a, b)
    (row,) = hlo_stats.contributors(mode)
    assert set(row) == KEYS
    assert (row["opcode"], row["name"], row["shape"], row["scale"]) == \
        ("mm", "aten.mm.default", f"f32[{m},{n}]", 1)
    assert row["flops"] == 2 * m * n * k == mode.cost.flops
    assert row["bytes"] == 4 * (m * k + k * n + m * n) == mode.cost.bytes
    assert row["wire"] == 0


class _ByShape(TorchDispatchMode):
    """The test's own count: operand + result bytes of every non-view aten
    op one of whose outputs has ``dims`` as its last two dims."""

    def __init__(self, dims):
        super().__init__()
        self.dims, self.bytes = dims, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = torch.utils._pytree.tree_leaves
        if func.namespace == "aten" and not func.is_view and any(
                isinstance(t, torch.Tensor) and tuple(t.shape[-2:]) == self.dims
                for t in leaves(out)):
            self.bytes += sum(t.numel() * t.element_size() for t in leaves((args, out))
                              if isinstance(t, torch.Tensor))
        return out


def _attention_step(seed: int, bq: int, bk: int):
    """A blocked attention's forward and backward, then a product of a
    (bq, bk)-shaped output outside the attention."""
    rng = np.random.default_rng(seed)
    B, S, H, K, hd = 2, 96, 4, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    out = blocked_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
    torch.autograd.grad(out.square().sum(), (q, k, v))
    return torch.ones((bq, hd)) @ torch.ones((hd, bk))


def test_attention_interior_bytes_by_hand():
    bq, bk = 16, 32
    mode = hlo_stats.CostMode(attribute=True)
    with mode:
        _attention_step(3, bq, bk)
    rows = hlo_stats.contributors(mode, top=None)
    got = kernel_roofline.attention_interior_bytes(rows, bq, bk)
    # by hand: every (bq, bk)-shaped op of the same run, less the product
    # outside the attention
    counter = _ByShape((bq, bk))
    with counter:
        _attention_step(3, bq, bk)
    outside = 4 * (bq * 8 + 8 * bk + bq * bk)
    assert counter.bytes - outside > 0
    assert got == counter.bytes - outside
    assert any(r["comp"] not in kernel_roofline.BLOCKED_SITES and
               r["shape"] == f"f32[{bq},{bk}]" for r in rows)
    # backward ops are attributed to the blocked loop too
    assert any(r["comp"] == "attention._blocked_loop" and "backward" in r["opcode"]
               for r in rows)


def test_blocks_clip_to_the_sequence():
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config

    cfg = get_config("llama3.2-3b")
    assert kernel_roofline.blocks(cfg, ShapeSpec("s", 4096, 1, "train")) == \
        (cfg.attn_block_q, cfg.attn_block_k)
    assert kernel_roofline.blocks(cfg, ShapeSpec("s", 256, 1, "train")) == (256, 256)


def test_cli_prints_the_reference_lines():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.kernel_roofline", "--arch", "llama3.2-3b",
         "--shape", "train_4k", "--override", "n_layers=1"],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "[kernel-roofline] llama3.2-3b x train_4k (single-pod, per-device, h100_sxm)"
    starts = ["  attention-interior HBM traffic: ", "  memory term   blocked path: ",
              "  memory term   flash kernel: ", "  compute ", "  step bound: "]
    assert [line[:len(s)] for line, s in zip(lines[1:], starts)] == starts
    share = float(lines[1].split("(")[1].split("%")[0])
    assert 0 < share < 100
    assert "roofline fraction" in lines[5]
