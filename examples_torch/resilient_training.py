"""End-to-end driver: train a llama through node failures.

A small llama (~13M params by default; ``--full`` scales to ~100M,
``--tiny`` shrinks to CI size) trains on the counter-based Markov stream
while the virtual cluster loses two nodes — one mid-warmup, one legion
master. Checkpoints are written per-legion; at the end the script
demonstrates restart-only-failed: a replacement node restores *only* the
dead member's shard and the loss curve continues where it left off.

The default is sized to finish in well under a minute on a laptop CPU
(every file under examples_torch/ is held to that budget — see
tests/test_examples.py); ``--full`` restores the original ~100M/300-step
campaign for overnight-scale runs.

  PYTHONPATH=src python examples_torch/resilient_training.py           # ~13M, fast
  PYTHONPATH=src python examples_torch/resilient_training.py --full    # ~100M
  PYTHONPATH=src python examples_torch/resilient_training.py --tiny    # CI-sized

Add ``--device cpu`` to train without a card.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import (
    FaultInjector,
    LegionCheckpointer,
    LegioPolicy,
    ResilientTrainer,
    VirtualCluster,
)

MODEL_100M = ModelConfig(
    name="llama-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
    attn_block_q=128, attn_block_k=128, xent_chunk=128, remat="none",
)

MODEL_TINY = MODEL_100M.replace(
    name="llama-tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512)

# default: big enough to show a real loss curve, small enough that the
# whole walkthrough (train + 2 repairs + checkpoint restore) stays under
# the examples_torch/ ~60 s budget on CPU
MODEL_SMALL = MODEL_100M.replace(
    name="llama-5m", n_layers=3, d_model=256, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=768, vocab_size=4096)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true", help="CI-sized model")
    ap.add_argument("--full", action="store_true",
                    help="the original ~100M / 300-step campaign")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cfg = (MODEL_TINY if args.tiny
           else MODEL_100M if args.full else MODEL_SMALL)
    steps = args.steps or (60 if args.tiny else 300 if args.full else 40)
    seq_len = 64 if args.tiny else 256 if args.full else 96

    tc = TrainConfig(learning_rate=3e-3, total_steps=steps,
                     warmup_steps=max(steps // 10, 1),
                     checkpoint_every=max(steps // 4, 1))
    injector = FaultInjector.at([
        (steps // 6, 5),        # a worker dies early
        (steps // 2, 0),        # a legion master dies mid-run
    ])
    cluster = VirtualCluster(
        8, policy=LegioPolicy(legion_size=4), injector=injector, device=args.device)

    ckpt_dir = tempfile.mkdtemp(prefix="legio_ckpt_")
    ckpt = LegionCheckpointer(ckpt_dir)
    trainer = ResilientTrainer(cfg, tc, cluster, per_shard_batch=2,
                               seq_len=seq_len, checkpointer=ckpt)
    n_params = sum(x.numel() for x in _leaves(trainer.params))
    print(f"[example] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{steps} steps, 8 nodes (k=4), checkpoints -> {ckpt_dir}")

    for _ in range(steps):
        r = trainer.run_step()
        if r.step % max(steps // 15, 1) == 0 or r.repair:
            extra = f"  {r.repair.summary()}" if r.repair else ""
            print(f"  step {r.step:4d}  loss {r.loss:.4f}  "
                  f"shards {r.active_shards}{extra}")

    losses = [r.loss for r in trainer.history]
    print(f"[example] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"through 2 failures; survivors={len(cluster.live_nodes)}/8")
    assert losses[-1] < losses[0]

    # --- restart-only-failed (§VII): bring a replacement for node 5 back ---
    # Per-member files are self-contained; data-parallel state is replicated,
    # so a replacement restores from ANY single member file (here: the master
    # of node 5's old legion) and regenerates node 5's shards via the
    # counter-based pipeline. No survivor is interrupted.
    ckpt.wait()
    legion = cluster.topo.home.get(5, 1)
    donor = cluster.topo.legion_of(
        min(cluster.live_nodes)).master if cluster.live_nodes else 0
    donor_legion = cluster.topo.home[donor]
    state = ckpt.restore_failed_member(donor_legion, donor)
    restored_step = int(np.asarray(state["meta"]["step"]))
    print(f"[example] replacement for node 5 (legion {legion}) restored from "
          f"member file of node {donor} at step {restored_step} — exactly one "
          f"file read, no surviving member interrupted")
    ckpt.close()


def _leaves(tree):
    import torch
    return torch.utils._pytree.tree_leaves(tree)


if __name__ == "__main__":
    main()
