"""Resilient batched-serving driver — model inference over ``repro_torch.serve``.

The paper's target class — embarrassingly parallel work with no inter-worker
interaction until the final reduce — is exactly batched inference: every node
owns a slice of the request stream (prefill + decode), and the only
collective is the result gather. The serving subsystem (``repro_torch.serve``)
owns routing, micro-batching, and fault recovery; this module supplies the
model-backed work function (prefill + greedy decode on the card) and the CLI.

A fault mid-batch no longer loses the in-flight requests and no longer
blocks serving: the ServeEngine re-enqueues them through the FaultPipeline
listener (at-least-once, deduped to exactly-once) while healthy legions
keep dispatching. Prefill goes through the hand-written kernels: flash
attention for the dense, moe, vlm and hybrid families (windowed for hybrid
and mixtral), the SSD scan for the hybrid and ssm ones. The vlm family is
served on tokens. The encoder-decoder is not served here, as in the JAX
package: its prefill needs the audio frames (``embeds``), which the work
function does not take; it runs through ``api.prefill``/``api.decode_step``.

Prompts are the JAX package's: ``randint(PRNGKey(1234), (B, prompt_len), 0,
vocab)`` drawn through :mod:`repro_torch.data.threefry` (byte-equal to
``jax.random.randint``), with column 0 set to ``rid % vocab``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --requests 64 --nodes 8 --decode-tokens 8 --fail 2:3 \\
      --recovery nonblocking
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --fail 0:1
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, PORT_ONLY_IDS, get_config, get_smoke_config
from repro_torch.core import FaultInjector, LegioPolicy
from repro_torch.data import threefry
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.mpi import Session
from repro_torch.serve import RECOVERY_PRESETS, Request, ServeEngine, recovery_preset


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
    for index in range(decode_tokens):
        out.append(tok)
        # the host's time to issue one step (the card runs behind it; step 0
        # also waits for launch-queue room behind the prefill)
        with tracing.span("serve.decode", index=index):
            logits, cache = api.decode_step(cfg, params, cache, tok)
        tok = logits[:, -1, :].argmax(dim=-1)[:, None]
    return torch.cat(out, dim=1)


def prompt_tokens(request_ids: list[int], prompt_len: int, vocab_size: int) -> np.ndarray:
    """The JAX package's serve prompts as int32: ``randint(PRNGKey(1234),
    (B, prompt_len), 0, vocab)`` with the request id folded into column 0.
    A row depends on the request's position in the batch, not its id alone."""
    tokens = threefry.randint(threefry.prng_key(1234),
                              (len(request_ids), prompt_len), 0, vocab_size)
    tokens[:, 0] = np.asarray(request_ids, np.int32) % vocab_size
    return tokens


class ResilientServer:
    """Model-backed serving: prefill + greedy decode per micro-batch, fault
    recovery delegated to :class:`repro_torch.serve.ServeEngine` over the
    ``repro_torch.mpi`` session facade — this driver contains zero fault code.

    The model runs with ``use_pallas=True``: prefill attention and the SSD
    scan take the hand-written kernels on the card (their plain versions on
    the CPU).
    """

    def __init__(self, cfg: ModelConfig, session: Session, *, prompt_len: int = 32,
                 decode_tokens: int = 8, batch_per_node: int = 4,
                 requeue: bool = True, window: int | None = None,
                 continuous: bool = True, device: str | torch.device = "cuda"):
        if batch_per_node < 1 or prompt_len < 1 or decode_tokens < 1:
            raise ValueError("batch_per_node, prompt_len and decode_tokens must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg.replace(use_pallas=True)
        self.prompt_len = prompt_len
        self.decode_tokens = decode_tokens
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.params = api.init_params(self.cfg, gen, self.device)
        # first calls warm cuBLAS and the allocator; that wall-clock noise
        # must not soft-fail healthy nodes as stragglers
        self.engine = ServeEngine(session, self._work_fn,
                                  microbatch=batch_per_node, requeue=requeue,
                                  window=window, continuous=continuous,
                                  observe_stragglers=False)

    @property
    def completed(self) -> dict[int, np.ndarray]:
        return self.engine.completed

    def _work_fn(self, node: int, batch: list[Request],
                 step: int) -> dict[int, np.ndarray]:
        rids = [r.rid for r in batch]
        result = self._work_batch(rids)
        return {rid: row for rid, row in zip(rids, result)}

    def prompts(self, request_ids: list[int]) -> torch.Tensor:
        """:func:`prompt_tokens` as an int64 tensor on the server's device."""
        tokens = prompt_tokens(request_ids, self.prompt_len, self.cfg.vocab_size)
        return torch.from_numpy(tokens.astype(np.int64)).to(self.device)

    def _work_batch(self, request_ids: list[int]) -> np.ndarray:
        """Prefill + greedy-decode a batch of requests; returns token matrix."""
        tokens = self.prompts(request_ids)
        out = greedy_generate(self.cfg, self.params, tokens, self.decode_tokens)
        # the batch's wait for the card: its tokens come to the host
        with tracing.span("serve.sync"):
            return out.cpu().numpy()

    def run(self, n_requests: int) -> dict:
        self.engine.submit(n_requests)
        with tracing.span("serve.run") as run:
            rep = self.engine.serve()
        wall = run.seconds
        m = rep.metrics_summary
        return {
            "completed": rep.completed,
            "abandoned": m["abandoned"],
            "shed": m["shed"],
            "unserved": self.engine.pending,
            "rounds": rep.rounds,
            "requeues": m["requeues"],
            "migrations": m["migrations"],
            "p50_latency_rounds": m["p50_latency_rounds"],
            "p99_latency_rounds": m["p99_latency_rounds"],
            "p99_latency_sim": m["p99_latency_sim"],
            "slo_attainment": m["slo_attainment"],
            "starved_rounds": m["starved_rounds"],
            "wall_seconds": wall,
            "survivors": rep.survivors,
            "repairs": rep.repairs,
            "throughput_rps": rep.completed / wall if wall > 0 else 0.0,
        }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS + PORT_ONLY_IDS, default="llama3.2-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: smoke config)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--fail", action="append", default=[],
                    help="round:node fault injection (repeatable)")
    ap.add_argument("--recovery", choices=sorted(RECOVERY_PRESETS),
                    default="shrink", help="recovery strategy for faults")
    ap.add_argument("--no-requeue", action="store_true",
                    help="DROP failed nodes' requests instead of re-queueing")
    ap.add_argument("--window", type=int, default=None,
                    help="in-flight micro-batches per node (continuous "
                         "batching window; default policy.serve_window)")
    ap.add_argument("--lockstep", action="store_true",
                    help="use the lock-step barrier baseline instead of "
                         "continuous batching")
    ap.add_argument("--slo", type=float, default=0.0,
                    help="per-request SLO deadline in simulated seconds "
                         "(0 = no deadlines)")
    ap.add_argument("--admission", choices=("none", "shed", "park"),
                    default="none",
                    help="SLO-feasibility admission control at submit")
    ap.add_argument("--data-plane", choices=["sim", "torch", "auto"], default="torch",
                    help="what moves collective payloads: the numpy simulator, torch "
                         "tensors on --device, or auto (torch when >1 card is visible)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no GPU and no --device cpu is an error")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    pairs = []
    for s in args.fail:
        step, node = s.split(":")
        pairs.append((int(step), int(node)))
    # batch size flows through the ResilientServer constructor (the engine's
    # explicit microbatch override); the policy only carries recovery setup
    policy = LegioPolicy(**recovery_preset(args.recovery),
                         serve_slo_seconds=args.slo,
                         serve_admission=args.admission,
                         data_plane=args.data_plane)
    session = Session(args.nodes, policy=policy, injector=FaultInjector.at(pairs),
                      device=args.device)
    server = ResilientServer(
        cfg, session, prompt_len=args.prompt_len,
        decode_tokens=args.decode_tokens, batch_per_node=args.batch_per_node,
        requeue=not args.no_requeue, window=args.window,
        continuous=not args.lockstep, device=args.device)
    print(f"[serve] arch={cfg.name} nodes={args.nodes} "
          f"requests={args.requests} recovery={args.recovery} "
          f"mode={'lockstep' if args.lockstep else 'continuous'} device={server.device}")
    rep = server.run(args.requests)
    for k, v in rep.items():
        print(f"  {k}: {v if not isinstance(v, float) else round(v, 3)}")
    ok = rep["completed"] + rep["abandoned"] + rep["shed"] == args.requests
    print(f"[serve] {'OK' if ok else 'INCOMPLETE'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
