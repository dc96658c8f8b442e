"""Counter-based deterministic data pipeline.

Every batch shard is a pure function of ``(seed, step, shard_index)``: there
is no consumed-iterator state. That is what makes Legio's policies exact:

  * DROP       — survivors keep their own shards; nothing to recover.
  * REBALANCE  — a survivor can regenerate *any* failed node's shard
                 bit-exactly, so redistributing work costs one fold_in.
  * restart-only-failed — a replacement node resumes mid-run and generates
                 exactly the shards the dead node would have seen.

The stream is the JAX package's, token for token: the keys come from the
numpy threefry of ``data.threefry`` (jax 0.9.0's streams), and the closed
form runs in numpy int32, which wraps as the device int32 does (torch's
int64 would not: ``3**t`` leaves int32 from t = 20), with ``jnp.power``'s
6-bit exponent (``a**(t % 64)``). A shard is a few KB, so it is generated
on the host and copied to the device once. The functions that return
tensors put them on the card unless the caller names another device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data import threefry
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ShardAssignment:
    """Which global shard indices a node computes this step."""
    node: int
    shards: tuple[int, ...]


def _fold(seed: int, *counters: int) -> np.ndarray:
    key = threefry.prng_key(seed)
    for c in counters:
        key = threefry.fold_in(key, c)
    return key


def host_batch_numpy(seed: int, step: int, shard: int, *, batch: int,
                     seq_len: int, vocab_size: int) -> dict[str, np.ndarray]:
    """One shard's (tokens, labels) as int32 numpy arrays on the host.

    labels[t] = tokens[t+1] (next-token prediction); the stream mixes a
    learnable affine recurrence with noise tokens.
    """
    key = _fold(seed, step, shard)
    k_start, k_noise, k_mask = threefry.split(key, 3)
    V = vocab_size
    # x[t+1] = (a * x[t] + b) % V with per-sequence (a, b), a in {1, 3}. As in
    # the JAX package, a, b and x0 are all drawn from k_start.
    a = 2 * threefry.randint(k_start, (batch, 1), 0, 2) + 1
    b = threefry.randint(k_start, (batch, 1), 0, V)
    x0 = threefry.randint(k_start, (batch, 1), 0, V)
    t = np.arange(seq_len + 1, dtype=np.int32)[None, :]
    with np.errstate(over="ignore"):
        # jnp.power of int32 arrays is binary exponentiation over the
        # exponent's low 6 bits only, so the reference computes a**(t % 64)
        pw = np.power(a, t & 63)
        tokens = (x0 * pw + b * (pw - 1) // np.maximum(a - 1, 1)) % np.int32(V)
    noise = threefry.randint(k_noise, tokens.shape, 0, V)
    keep = threefry.uniform(k_mask, tokens.shape) < np.float32(0.9)
    stream = np.where(keep, tokens, noise).astype(np.int32)
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def make_batch(seed: int, step: int, shard: int, *, batch: int, seq_len: int,
               vocab_size: int, device: str | torch.device = "cuda"
               ) -> dict[str, torch.Tensor]:
    """One shard's (tokens, labels): (batch, seq_len) int32 tensors on ``device``."""
    host = host_batch_numpy(seed, step, shard, batch=batch, seq_len=seq_len,
                            vocab_size=vocab_size)
    return _concat([host], device)


def _concat(parts: list[dict[str, np.ndarray]], device) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.concatenate([p[k] for p in parts], axis=0)).to(dev)
            for k in parts[0]}


def global_batch_for_step(seed: int, step: int, *, global_batch: int, seq_len: int,
                          vocab_size: int, n_shards: int,
                          device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The full global batch: its shards in order, concatenated."""
    per = global_batch // n_shards
    return _concat([host_batch_numpy(seed, step, s, batch=per, seq_len=seq_len,
                                     vocab_size=vocab_size) for s in range(n_shards)], device)


def shard_batch(assignments: list[ShardAssignment], seed: int, step: int, *,
                per_shard_batch: int, seq_len: int, vocab_size: int,
                device: str | torch.device = "cuda") -> dict[int, dict[str, torch.Tensor]]:
    """Each node's batch per its (possibly rebalanced) shards."""
    out: dict[int, dict[str, torch.Tensor]] = {}
    for asg in assignments:
        if asg.shards:
            out[asg.node] = _concat([
                host_batch_numpy(seed, step, s, batch=per_shard_batch, seq_len=seq_len,
                                 vocab_size=vocab_size) for s in asg.shards], device)
    return out
