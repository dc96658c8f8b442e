"""Batched serving — model inference on the card, request by request.

Every node owns a slice of the request stream and serves it with prefill +
greedy decode; the only collective is the result gather. This module
supplies the model-backed work function (``ResilientServer._work_fn`` /
``_work_batch``, with the JAX package's contract) and the CLI. Prefill goes
through the hand-written kernels: flash attention for the dense and hybrid
families (windowed for hybrid), the SSD scan for the hybrid and ssm ones.

In this slice ``run(n)`` hands requests out in lock-step rounds: each of
``nodes`` nodes takes up to ``batch_per_node`` requests per round. The
next slice replaces that loop with the port's ``ServeEngine`` over
``Session``, and with it come fault injection and recovery (``--fail``,
``--recovery``), which this CLI refuses until then.

Prompts come from a ``torch.Generator`` seeded 1234 with column 0 set to
``rid % vocab``; the JAX package draws them from ``PRNGKey(1234)``, so the
two packages serve different prompts and hence different tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --full
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve import LegionQueue, Request

_NEXT_SLICE = ("fault injection and recovery come with the next slice of the "
               "port (ServeEngine over Session); this server has no control plane yet")


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, tokens: torch.Tensor,
                    decode_tokens: int) -> torch.Tensor:
    """Prefill ``tokens`` (B, S), then greedy-decode; returns (B, decode_tokens).

    The JAX package's serve loop: the first token is the argmax of the
    prefill logits, and each decode step feeds back the previous argmax.
    """
    logits, cache = api.prefill(cfg, params, tokens, tokens.shape[1] + decode_tokens)
    tok = logits[:, -1, :].argmax(dim=-1)[:, None]
    out = []
    for _ in range(decode_tokens):
        out.append(tok)
        logits, cache = api.decode_step(cfg, params, cache, tok)
        tok = logits[:, -1, :].argmax(dim=-1)[:, None]
    return torch.cat(out, dim=1)


class ResilientServer:
    """Model-backed serving: prefill + greedy decode per micro-batch.

    The model runs with ``use_pallas=True``: prefill attention and the SSD
    scan take the hand-written kernels on the card (their plain versions on
    the CPU).
    """

    def __init__(self, cfg: ModelConfig, *, nodes: int = 8, prompt_len: int = 32,
                 decode_tokens: int = 8, batch_per_node: int = 4,
                 device: str | torch.device = "cuda"):
        if nodes < 1 or batch_per_node < 1 or prompt_len < 1 or decode_tokens < 1:
            raise ValueError("nodes, batch_per_node, prompt_len and decode_tokens must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg.replace(use_pallas=True)
        self.nodes = nodes
        self.prompt_len = prompt_len
        self.decode_tokens = decode_tokens
        self.batch_per_node = batch_per_node
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.params = api.init_params(self.cfg, gen, self.device)
        self.completed: dict[int, np.ndarray] = {}

    def _work_fn(self, node: int, batch: list[Request],
                 step: int) -> dict[int, np.ndarray]:
        rids = [r.rid for r in batch]
        result = self._work_batch(rids)
        return {rid: row for rid, row in zip(rids, result)}

    def prompts(self, request_ids: list[int]) -> torch.Tensor:
        """Deterministic per-request prompts (request id folds into column 0)."""
        gen = torch.Generator(device="cpu").manual_seed(1234)
        tokens = torch.randint(0, self.cfg.vocab_size,
                               (len(request_ids), self.prompt_len), generator=gen)
        tokens[:, 0] = torch.tensor(request_ids) % self.cfg.vocab_size
        return tokens.to(self.device)

    def _work_batch(self, request_ids: list[int]) -> np.ndarray:
        """Prefill + greedy-decode a batch of requests; returns token matrix."""
        tokens = self.prompts(request_ids)
        out = greedy_generate(self.cfg, self.params, tokens, self.decode_tokens)
        return out.cpu().numpy()

    def run(self, n_requests: int) -> dict:
        """Serve requests ``0..n_requests-1`` in lock-step rounds."""
        queue = LegionQueue(legion=0)
        for rid in range(n_requests):
            queue.push(Request(rid=rid))
        t0 = time.perf_counter()
        rounds = batches = 0
        while len(queue):
            for node in range(self.nodes):
                batch = queue.pop_batch(self.batch_per_node)
                if not batch:
                    break
                for req in batch:
                    req.attempts += 1
                self.completed.update(self._work_fn(node, batch, rounds))
                batches += 1
            rounds += 1
        wall = time.perf_counter() - t0
        generated = len(self.completed) * self.decode_tokens
        return {
            "completed": len(self.completed),
            "unserved": len(queue),
            "rounds": rounds,
            "batches": batches,
            "wall_seconds": wall,
            "throughput_rps": len(self.completed) / wall if wall > 0 else 0.0,
            "tokens_per_second": generated / wall if wall > 0 else 0.0,
        }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: smoke config)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no GPU and no --device cpu is an error")
    ap.add_argument("--fail", action="append", default=[],
                    help="not in this slice: " + _NEXT_SLICE)
    ap.add_argument("--recovery", default=None,
                    help="not in this slice: " + _NEXT_SLICE)
    args = ap.parse_args(argv)
    if args.fail or args.recovery is not None:
        ap.error(f"--fail/--recovery: {_NEXT_SLICE}")

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    server = ResilientServer(
        cfg, nodes=args.nodes, prompt_len=args.prompt_len,
        decode_tokens=args.decode_tokens, batch_per_node=args.batch_per_node,
        device=args.device)
    print(f"[serve] arch={cfg.name} nodes={args.nodes} requests={args.requests} "
          f"device={server.device}")
    rep = server.run(args.requests)
    for k, v in rep.items():
        print(f"  {k}: {v}")
    ok = rep["completed"] == args.requests
    print(f"[serve] {'OK' if ok else 'INCOMPLETE'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
