"""Resilient training driver (end-to-end entry point).

Trains a model under the Legio runtime on a virtual cluster: injected node
failures are detected, agreed on and repaired (flat or hierarchical
shrink, or substitution), and training continues with the survivors: no
global restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --steps 50 \\
      --nodes 16 --fail 10:3 --fail 20:0 --legion-size 4

The JAX package's driver, flag for flag, plus ``--device`` (the card by
default; ``--device cpu`` on a machine without one). Without ``--full`` it
trains the arch's smoke config; ``--full`` trains the published widths and
depth. ``--json`` prints the same report as the JAX package's driver.

Under torchrun (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set) every rank starts the process group with
``init_from_env(--device, --backend)`` and the trainer steps over the
ranks; rank 0 alone prints. ``--backend`` defaults to NCCL on the card and
gloo on the CPU; name gloo to put several ranks on one card:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --backend gloo --steps 6 --nodes 8 --fail 2:1 --json
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
import torch.distributed as dist

from repro_torch.core import (
    RECOVERY_MODES,
    FaultInjector,
    LegionCheckpointer,
    LegioPolicy,
    ResilientTrainer,
    VirtualCluster,
)


def parse_failures(specs: list[str]) -> FaultInjector:
    pairs = []
    for s in specs:
        step, node = s.split(":")
        pairs.append((int(step), int(node)))
    return FaultInjector.at(pairs)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: smoke config)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--per-shard-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fail", action="append", default=[],
                    help="step:node fault injection (repeatable)")
    ap.add_argument("--legion-size", type=int, default=0,
                    help="k; 0 = optimal from Eq. 3")
    ap.add_argument("--flat", action="store_true",
                    help="flat shrink instead of hierarchical")
    ap.add_argument("--batch-policy", choices=["drop", "rebalance"], default="drop")
    ap.add_argument("--root-policy", choices=["ignore", "stop"], default="ignore")
    ap.add_argument("--spares", type=int, default=0,
                    help="standby nodes for elastic regrow")
    ap.add_argument("--recovery", choices=RECOVERY_MODES, default="shrink",
                    help="recovery mode; 'adaptive' scores shrink/substitute/"
                         "nonblocking per fault (CostModelStrategy)")
    ap.add_argument("--spare-fraction", type=float, default=0.0,
                    help="provision ceil(f*n) warm spares for substitution")
    ap.add_argument("--no-peer-replication", action="store_true",
                    help="disable POV-ring replica checkpoints (store-only restores)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--data-plane", choices=["sim", "torch", "auto"], default="torch",
                    help="what moves collective payloads: the numpy simulator, torch "
                         "tensors on --device, or auto (torch when >1 card is visible)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no GPU and no --device cpu is an error")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="process-group backend under torchrun (default: nccl on "
                         "cuda, gloo on cpu); gloo lets several ranks share one card")
    ap.add_argument("--json", action="store_true", help="JSON report to stdout")
    args = ap.parse_args(argv)

    device = args.device
    under_torchrun = all(k in os.environ
                         for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))
    if under_torchrun:
        from repro_torch.dist import init_from_env

        device = init_from_env(args.device, args.backend)
    try:
        return _train(args, device, printing=not under_torchrun or dist.get_rank() == 0)
    finally:
        if under_torchrun:
            dist.destroy_process_group()


def _train(args, device, *, printing: bool) -> int:
    say = print if printing else (lambda *a, **k: None)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    tc = TrainConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 10, 1),
        legion_size=args.legion_size,
        batch_policy=args.batch_policy,
        root_failure_policy=args.root_policy,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
    )
    policy = LegioPolicy(
        legion_size=args.legion_size,
        hierarchical_threshold=10 ** 9 if args.flat else 12,
        batch_policy=args.batch_policy,
        root_failure_policy=args.root_policy,
        spare_nodes=args.spares,
        recovery_mode=args.recovery,
        spare_fraction=args.spare_fraction,
        peer_replication=not args.no_peer_replication,
        data_plane=args.data_plane,
    )
    cluster = VirtualCluster(args.nodes, policy=policy, injector=parse_failures(args.fail),
                             device=device)
    ckpt = LegionCheckpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    trainer = ResilientTrainer(cfg, tc, cluster, per_shard_batch=args.per_shard_batch,
                               seq_len=args.seq_len, checkpointer=ckpt)

    say(f"[train] arch={cfg.name} nodes={args.nodes} "
        f"legions(k)={cluster.topo.k} steps={args.steps} device={trainer.device}")
    try:
        for _ in range(args.steps):
            r = trainer.run_step()
            say(f"  step {r.step:4d} loss {r.loss:.4f} shards {r.active_shards:3d} "
                f"{'REPAIR ' + r.repair.summary() if r.repair else ''}")
    finally:
        if ckpt is not None:
            ckpt.close()

    losses = [r.loss for r in trainer.history]
    report = {
        "arch": cfg.name,
        "steps": args.steps,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "loss_decreased": losses[-1] < losses[0],
        "repairs": len(cluster.repairs),
        "survivors": len(cluster.live_nodes),
        "sim_seconds": cluster.clock.sim_seconds,
    }
    say(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{report['repairs']} repairs, {report['survivors']} survivors")
    if args.json:
        say(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
