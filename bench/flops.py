"""Model FLOPs of a training step and of a served request, frozen with the benchmark.

Counted from the configuration's own sizes (the JSON under ``configs/``):

  * the matrix parameters a token uses, times 2 (a forward) or 6 (a
    forward and a backward): the attention projections, the MLP or the
    ``experts_per_token`` experts and the router, the SSD block's in and
    out projections, and the unembedding (in serving only for the positions
    whose logits are computed);
  * attention: QK^T and PV, 4 * head_dim FLOPs a head for each (query,
    key) pair the mask lets through; a backward counts twice a forward;
  * the SSD scan: the chunked scan's products (``roofline.ssd_flops``),
    with C.B^T once per group;
  * nothing else (norms, activations, the conv), and never recompute.

Whatever runs the model later, a step or a request counts the same work.
"""
from __future__ import annotations

from bench.roofline import live_pairs, ssd_flops


def _window(cfg: dict) -> int:
    return cfg["hybrid_attn_window"] if cfg["family"] == "hybrid" else cfg["sliding_window"]


def _ssm_nheads(cfg: dict) -> int:
    return cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"]


def layer_matmul_params(cfg: dict) -> int:
    """Matrix parameters one token uses in one layer."""
    D, F = cfg["d_model"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    n = D * q + 2 * D * kv + q * D
    mats = 3 if cfg["activation"] in ("silu", "geglu") else 2
    if cfg["n_experts"] > 0:
        n += cfg["experts_per_token"] * mats * D * F + D * cfg["n_experts"]
    else:
        n += mats * D * F
    if cfg["family"] == "hybrid":
        di, N, G = cfg["ssm_expand"] * D, cfg["ssm_state"], cfg["ssm_ngroups"]
        n += D * (2 * di + 2 * G * N + _ssm_nheads(cfg)) + di * D
    return n


def unembed_params(cfg: dict) -> int:
    return cfg["vocab_size"] * cfg["d_model"]


def token_matmul_params(cfg: dict) -> int:
    """Matrix parameters a token uses, all layers and the unembedding."""
    return cfg["n_layers"] * layer_matmul_params(cfg) + unembed_params(cfg)


def attention_flops(cfg: dict, rows: int, Sq: int, Sk: int, q_offset: int) -> int:
    """QK^T and PV of one forward over all layers (causal, the config's window)."""
    pairs = live_pairs(Sq, Sk, True, _window(cfg), q_offset)
    return cfg["n_layers"] * 4 * cfg["head_dim"] * cfg["n_heads"] * pairs * rows


def ssd_forward_flops(cfg: dict, rows: int, S: int) -> int:
    """The SSD scan of one forward over all layers, from a zero state."""
    if cfg["family"] != "hybrid" and cfg["family"] != "ssm":
        return 0
    H, G = _ssm_nheads(cfg), cfg["ssm_ngroups"]
    cb, rest = ssd_flops(rows, S, H, cfg["ssm_head_dim"], cfg["ssm_state"],
                         cfg["ssm_chunk"], has_h0=False)
    return cfg["n_layers"] * (cb * G // H + rest)


def ssd_decode_flops(cfg: dict, rows: int) -> int:
    """One recurrent SSD step over all layers: the state update (4 P N a
    head) and C.h (2 P N a head)."""
    if cfg["family"] != "hybrid" and cfg["family"] != "ssm":
        return 0
    return cfg["n_layers"] * 6 * _ssm_nheads(cfg) * cfg["ssm_head_dim"] * cfg["ssm_state"] * rows


def train_step_flops(cfg: dict, rows: int, seq: int) -> int:
    """A training step over ``rows`` sequences of ``seq`` tokens."""
    tokens = rows * seq
    return (6 * token_matmul_params(cfg) * tokens
            + 3 * attention_flops(cfg, rows, seq, seq, 0)
            + 3 * ssd_forward_flops(cfg, rows, seq))


def serve_batch_flops(cfg: dict, rows: int, prompt: int, generated: int) -> int:
    """A batch of ``rows`` requests: the prefill of ``prompt`` tokens with
    the last position's logits, then the ``generated - 1`` decode steps
    whose logits give the rest of the ``generated`` tokens."""
    body = token_matmul_params(cfg) - unembed_params(cfg)
    total = (2 * body * rows * prompt + 2 * unembed_params(cfg) * rows
             + attention_flops(cfg, rows, prompt, prompt, 0)
             + ssd_forward_flops(cfg, rows, prompt))
    for j in range(generated - 1):
        pos = prompt + j
        total += (2 * token_matmul_params(cfg) * rows
                  + attention_flops(cfg, rows, 1, pos + 1, pos)
                  + ssd_decode_flops(cfg, rows))
    return total
