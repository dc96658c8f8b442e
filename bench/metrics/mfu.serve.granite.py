"""``mfu.serve`` for a configuration with a layer pattern (granite's): the
model FLOPs of the batches counted here, since ``bench/flops.py`` knows no
pattern and no shared expert, over the wall of the window's steady rounds
(``harness.steady_rate``), as a share of the card's bf16 peak. None for a
configuration without a pattern.

A batch of ``rows`` requests is its prefill of ``prompt`` tokens with the
last position's logits, then the ``generated - 1`` decode steps whose
logits give the rest, counted as ``bench/flops.py`` counts:

  * every layer: the router, ``experts_per_token`` experts and the shared
    expert (2 FLOPs a matrix parameter a token);
  * an "M" layer: the Mamba-2 block's in and out projections, and the SSD
    scan (``roofline.ssd_flops``, C.B^T once per group; a decode step 6 P N
    a head);
  * an "A" layer: the attention projections, and QK^T and PV over the
    (query, key) pairs a causal mask lets through (``roofline.live_pairs``);
  * the unembedding at the positions whose logits are computed.
"""
from bench import harness, roofline


def _kinds(cfg: dict) -> str:
    period, L = cfg["layer_pattern"], cfg["n_layers"]
    return (period * -(-L // len(period)))[:L]


def token_params(cfg: dict) -> tuple[int, int, int]:
    """Matrix parameters a token uses in (an "M" layer's mixer, an "A"
    layer's mixer, any layer's expert FFN)."""
    D, F, Fs = cfg["d_model"], cfg["d_ff"], cfg["shared_d_ff"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    di, N, G = cfg["ssm_expand"] * D, cfg["ssm_state"], cfg["ssm_ngroups"]
    H = di // cfg["ssm_head_dim"]
    mamba = D * (2 * di + 2 * G * N + H) + di * D
    attn = D * q + 2 * D * kv + q * D
    ffn = cfg["experts_per_token"] * 3 * D * F + 3 * D * Fs + D * cfg["n_experts"]
    return mamba, attn, ffn


def batch_flops(cfg: dict, rows: int, prompt: int, generated: int) -> int:
    kinds = _kinds(cfg)
    n_m, n_a = kinds.count("M"), kinds.count("A")
    mamba, attn, ffn = token_params(cfg)
    body = n_m * mamba + n_a * attn + len(kinds) * ffn
    unembed = cfg["vocab_size"] * cfg["d_model"]
    H, P, N = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"], cfg["ssm_head_dim"], \
        cfg["ssm_state"]
    cb, rest = roofline.ssd_flops(rows, prompt, H, P, N, cfg["ssm_chunk"], has_h0=False)
    qk_pv = 4 * cfg["head_dim"] * cfg["n_heads"] * rows
    total = (2 * (body * prompt + unembed) * rows
             + n_m * (cb * cfg["ssm_ngroups"] // H + rest)
             + n_a * qk_pv * roofline.live_pairs(prompt, prompt, True, 0, 0))
    for j in range(generated - 1):
        pos = prompt + j
        total += (2 * (body + unembed) * rows + n_m * 6 * H * P * N * rows
                  + n_a * qk_pv * roofline.live_pairs(1, pos + 1, True, 0, pos))
    return total


def read(trace, ctx):
    cfg, traffic = ctx.config["model"], ctx.traffic
    if not cfg.get("layer_pattern"):
        return None
    S, gen = traffic["prompt_len"], traffic["generated"]
    rounds = [dict(r, flops=sum(batch_flops(cfg, n, S, gen) for n in r["rows"]))
              for r in trace["rounds"]]
    rate = harness.steady_rate(trace, rounds)
    return None if rate is None else 100.0 * rate / roofline.PEAK_BF16_FLOPS
