"""Kernel-adjusted roofline: what the flash-attention kernel buys.

The dry-run runs the plain blocked attention (the hand-written kernels take
no DTensor), so its memory term includes the (block_q, block_k) score
tensors that go through HBM between the two attention products. The
flash kernel keeps those blocks on chip (shared memory and registers), so
the kernel's roofline subtracts the attention-interior traffic and keeps
only q/k/v/o.

This tool attributes each counted op's bytes to its site
(``hlo_stats.CostMode(attribute=True)``): the interior is every op of the
blocked path whose output's last two dims are (block_q, block_k) — the
scores, masks, exponentials and probabilities between the two products,
forward and backward — and reports both memory terms on the H100.

The port counts bytes op by op, unfused (eager torch fuses nothing), where
the JAX package's tool reads XLA's fused HLO: the two interior shares are
not the same number.

  PYTHONPATH=src python -m repro_torch.launch.kernel_roofline --arch llama3.2-3b \\
      --shape train_4k
"""
from __future__ import annotations

import argparse
import logging
import math
import re
import sys

from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.launch import hlo_stats
from repro_torch.launch.hw import DEFAULT_CHIP

# the sites of the blocked path: the wrapper and its loop over the blocks
BLOCKED_SITES = ("attention.blocked_attention", "attention._blocked_loop")


def attention_interior_bytes(rows: list[dict], block_q: int, block_k: int) -> float:
    """Bytes of score-block-shaped ops inside the blocked attention.

    The flash kernel's on-chip residency removes exactly these: every
    (.., block_q, block_k)-shaped intermediate of the blocked path's sites.
    q/k/v block streaming stays — the kernel re-reads K/V per query block
    just as the blocked path does. ``rows`` are ``hlo_stats.contributors``'
    (every row: ``top=None``)."""
    sig = re.compile(rf"\[[\d,]*\b{block_q},{block_k}\]")
    return float(sum(r["bytes"] for r in rows
                     if r["comp"] in BLOCKED_SITES and sig.search(r["shape"])))


def blocks(cfg, shape) -> tuple[int, int]:
    """The blocked path's tiles for ``shape``, clipped to its sequence."""
    return min(cfg.attn_block_q, shape.seq_len), min(cfg.attn_block_k, shape.seq_len)


def report(cfg, shape, mesh, *, chip=None, step=None) -> dict:
    """The dry-run step of ``cfg`` x ``shape`` on ``mesh`` with attribution
    on: per device, the attention-interior bytes and their share, the
    memory term of the blocked path and of the flash kernel, the compute
    and collective terms, and the step bound and roofline fraction before
    and after (seconds, on ``chip``, the H100 unless given). ``step`` is
    that step's ``dryrun.dryrun_step(..., attribute=True)`` result where the
    caller already ran it."""
    from repro_torch.launch import dryrun

    chip = chip or DEFAULT_CHIP
    m = step or dryrun.dryrun_step(cfg, shape, mesh, attribute=True)
    cost = m["cost"]
    bq, bk = blocks(cfg, shape)
    attn = attention_interior_bytes(hlo_stats.contributors(m["cost_mode"], top=None), bq, bk)
    mem = cost.bytes / chip.hbm_bw
    mem_adj = (cost.bytes - attn) / chip.hbm_bw
    comp = cost.flops / chip.peak_flops_bf16
    coll = cost.coll.total_wire_bytes / chip.ici_bw
    bound, bound_adj = max(comp, mem, coll), max(comp, mem_adj, coll)
    return {"chip": chip.name, "block_q": bq, "block_k": bk,
            "interior_bytes": attn, "total_bytes": cost.bytes,
            "interior_share": attn / cost.bytes if cost.bytes else 0.0,
            "memory_blocked_s": mem, "memory_flash_s": mem_adj, "compute_s": comp,
            "collective_s": coll, "bound_s": bound, "bound_flash_s": bound_adj,
            "roofline_fraction": comp / bound if bound else 0.0,
            "roofline_fraction_flash": comp / bound_adj if bound_adj else 0.0,
            "run_s": m["run_s"]}


def main(argv: list[str] | None = None) -> int:
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, production_shape

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable), e.g. n_layers=1")
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    cfg = get_config(args.arch)
    if args.override:
        cfg = cfg.replace(**dryrun.parse_overrides(args.override))
    shape = get_shape(args.shape)
    dryrun.fake_group(math.prod(production_shape()[0]))
    r = report(cfg, shape, make_production_mesh(device="cpu"))

    print(f"[kernel-roofline] {args.arch} x {args.shape} (single-pod, per-device, "
          f"{r['chip']})")
    print(f"  attention-interior HBM traffic: {r['interior_bytes']:.3e} B "
          f"({100 * r['interior_share']:.1f}% of all bytes)")
    print(f"  memory term   blocked path: {r['memory_blocked_s'] * 1e3:10.1f} ms")
    print(f"  memory term   flash kernel: {r['memory_flash_s'] * 1e3:10.1f} ms "
          f"({r['memory_blocked_s'] / r['memory_flash_s']:.2f}x)")
    print(f"  compute {r['compute_s'] * 1e3:.1f} ms | collective "
          f"{r['collective_s'] * 1e3:.1f} ms")
    print(f"  step bound: {r['bound_s'] * 1e3:.1f} -> {r['bound_flash_s'] * 1e3:.1f} ms "
          f"({r['bound_s'] / r['bound_flash_s']:.2f}x); roofline fraction "
          f"{r['roofline_fraction']:.3f} -> {r['roofline_fraction_flash']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
