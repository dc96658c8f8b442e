"""Plain PyTorch reference of Granite-4.0-H (``granitemoehybrid``): Mamba-2
and attention layers interleaved by a layer pattern, each followed by routed
experts beside a shared expert.

Written from the published configuration and modelling code alone; it
imports nothing but torch. It computes in float32 (TF32 off: the caller sets
``torch.backends.cuda.matmul.allow_tf32 = False``) from the same weights the
program gets, upcast. ``Matmul(fp8=True)`` computes the same model in
float8 wherever the program holds bfloat16 (products' operands and held
activations e4m3, activations' gradients e5m2, each with a per-tensor
scale): one precision below the configuration's bfloat16.

``cfg`` is a dict of the program's configuration fields. The model (``x``
the residual stream, ``m = residual_multiplier``):

  * ``x = embed[tokens] * embedding_multiplier``;
  * layer ``i`` is of kind ``layer_pattern[i % len(layer_pattern)]``:
    ``x += m * mixer(rmsnorm(x))``, then
    ``x += m * (experts(rmsnorm(x)) + shared(rmsnorm(x)))``, with
    ``rmsnorm(x) = x / rms(x) * (1 + w)`` (fp32 statistics);
  * "A", attention without positional embedding: ``q, k, v = h Wq, h Wk,
    h Wv`` in heads of ``head_dim``, grouped-query heads by index, causal,
    ``softmax(attention_multiplier * q k^T) v``, then ``Wo``;
  * "M", a Mamba-2 block: in_proj to z, x, B, C and dt; a causal depthwise
    conv of width ``conv_kernel`` with bias and SiLU over x, B and C;
    ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD
    recurrence ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T``, ``y_t = s_t
    C_t + D x_t`` in the chunked form of arXiv:2405.21060 §6; ``rmsnorm(y *
    silu(z))`` and out_proj;
  * experts: fp32 router logits; the ``k`` largest (ties to the lower
    index), their gates the softmax over those ``k`` logits; tokens routed
    in groups of ``g`` (zero rows pad the last), each expert taking at most
    ``C = max(int(g k cf / E), k)`` choices of a group in choice-major
    order (every token's first choice before any second one); a dropped
    choice adds nothing; each expert a SwiGLU MLP. The shared expert is a
    SwiGLU MLP every token passes through. The load-balance loss ``E sum_e
    f_e p_e / k`` (``p`` the softmax over all experts), the router z-loss
    (mean logsumexp squared) and the dropped share are means over groups,
    then over layers;
  * the final rmsnorm, and fp32 logits against the tied embedding divided by
    ``logits_scaling``; the loss is the mean NLL plus ``z_loss_weight``
    times the mean logsumexp squared, plus the MoE losses weighted.

How a served batch groups its tokens is part of the semantics: a prefill
routes its ``B * S`` prompt tokens in groups of ``min(g, B S)`` in row
order, and each decode step the batch's ``B`` new tokens as one group.
``forward(..., prompt_len=S)`` routes so.

The capacity is the port's routing (GShard-style, the serving cells'); the
release routes without dropping. A check of a served batch holds the fp32
weights and one group's, one expert's and one row's scan buffers at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30


class Matmul:
    """Where the model's precision shows: its linear layers' products
    (``mm(a, b)``, and ``mm.raw`` for the fp32 logits) and the activations
    it holds between operations (``mm.act``). In fp32 these are the plain
    product and the identity. With ``fp8`` they are the model one precision
    below the configuration's bfloat16, everywhere the program holds
    bfloat16: every product's operands and every held activation are
    rounded to float8 e4m3, and in the backward every activation's gradient
    to float8 e5m2, each under one scale per tensor that maps its largest
    magnitude to the format's largest value."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def raw(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The product with the operands at this precision, the result in fp32."""
        return _Fp8Matmul.apply(a, b) if self.fp8 else a @ b

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as the model holds it."""
        return _Fp8Act.apply(t) if self.fp8 else t

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.act(self.raw(a, b))


def fp8_round(t: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to the float8 format ``fmt`` under one scale that maps
    its largest magnitude to the format's largest value, back in t's dtype."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (t / scale).to(fmt).to(t.dtype) * scale


class _Fp8Act(torch.autograd.Function):
    """e4m3 forward, e5m2 gradient."""

    @staticmethod
    def forward(ctx, t):
        return fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` (a (..., K), b (K, N)) of the e4m3-rounded operands; the
    gradient passes the rounding through."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_round(a) @ fp8_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = g @ fp8_round(b).T
        gb = fp8_round(a).reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return ga, gb


def layer_kinds(cfg: dict) -> str:
    """Each layer's mixer, "A" or "M": the pattern repeated to n_layers."""
    period, L = cfg["layer_pattern"], cfg["n_layers"]
    return (period * -(-L // len(period)))[:L]


def ssm_heads(cfg: dict) -> int:
    return cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"]


def layout(cfg: dict) -> dict[str, tuple[tuple, str, float, float]]:
    """Every weight as ``path: (shape, dtype, mean, std)``: the benchmark's
    seeded weights are drawn as ``mean + std * N(0, 1)``. Attention weights
    are stacked over the "A" layers, the Mamba-2 block's over the "M" ones,
    the rest over all layers; matrices are (in, out), applied as ``x @ W``.

    The configuration names no initializer; these scales keep a random model
    at O(1) activations through the multipliers. The embedding is small
    (0.002), so that ``embedding_multiplier * embed`` stays a few percent of
    the final stream: with tied embeddings a larger share makes each
    position's own token the largest logit. q and k are 3x fan-in, so that
    the 1/128 score scale leaves scores of O(1) spread. The Mamba-2 decay
    ``dt A`` is about -0.08 a step (``A_log`` 0.7, ``dt_bias`` -4): a memory of
    tens of tokens."""
    L, D, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    kinds = layer_kinds(cfg)
    LA, LM = kinds.count("A"), kinds.count("M")
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    E, F_, Fs = cfg["n_experts"], cfg["d_ff"], cfg["shared_d_ff"]
    dt, f32 = cfg["param_dtype"], "float32"
    H, N, G = ssm_heads(cfg), cfg["ssm_state"], cfg["ssm_ngroups"]
    di = cfg["ssm_expand"] * D
    conv_ch = di + 2 * G * N
    return {
        "embed": ((V, D), dt, 0.0, 0.002),
        "final_norm": ((D,), dt, 0.0, 0.1),
        "layers.attn_norm": ((L, D), dt, 0.0, 0.1),
        "layers.mlp_norm": ((L, D), dt, 0.0, 0.1),
        "layers.attn.wq": ((LA, D, q), dt, 0.0, 3 * D ** -0.5),
        "layers.attn.wk": ((LA, D, kv), dt, 0.0, 3 * D ** -0.5),
        "layers.attn.wv": ((LA, D, kv), dt, 0.0, D ** -0.5),
        "layers.attn.wo": ((LA, q, D), dt, 0.0, q ** -0.5),
        "layers.ssm.in_proj": ((LM, D, 2 * di + 2 * G * N + H), dt, 0.0, D ** -0.5),
        "layers.ssm.conv_w": ((LM, cfg["conv_kernel"], conv_ch), dt, 0.0, 0.5),
        "layers.ssm.conv_b": ((LM, conv_ch), dt, 0.0, 0.1),
        "layers.ssm.A_log": ((LM, H), f32, 0.7, 0.5),
        "layers.ssm.dt_bias": ((LM, H), f32, -4.0, 1.0),
        "layers.ssm.D": ((LM, H), f32, 1.0, 0.1),
        "layers.ssm.ssd_norm": ((LM, di), dt, 0.0, 0.1),
        "layers.ssm.out_proj": ((LM, di, D), dt, 0.0, di ** -0.5),
        "layers.moe.router": ((L, D, E), f32, 0.0, D ** -0.5),
        "layers.moe.we_gate": ((L, E, D, F_), dt, 0.0, D ** -0.5),
        "layers.moe.we_in": ((L, E, D, F_), dt, 0.0, D ** -0.5),
        "layers.moe.we_out": ((L, E, F_, D), dt, 0.0, F_ ** -0.5),
        "layers.moe.shared_gate": ((L, D, Fs), dt, 0.0, D ** -0.5),
        "layers.moe.shared_in": ((L, D, Fs), dt, 0.0, D ** -0.5),
        "layers.moe.shared_out": ((L, Fs, D), dt, 0.0, Fs ** -0.5),
    }


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              block: int = 512) -> torch.Tensor:
    """Causal softmax attention, a block of queries at a time. q (B, S, H,
    hd), k and v (B, S, K, hd); query head h reads KV head h // (H / K)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    rep = H // K
    outs = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        qs = q[:, s0:s1].reshape(B, s1 - s0, K, rep, hd) * scale
        sc = torch.einsum("bqkrd,bskd->bkrqs", qs, k[:, :s1])
        see = (torch.arange(s1, device=q.device)[None, :]
               <= torch.arange(s0, s1, device=q.device)[:, None])
        p = torch.softmax(sc.masked_fill(~see, NEG), dim=-1)
        outs.append(torch.einsum("bkrqs,bskd->bqkrd", p, v[:, :s1]).reshape(B, s1 - s0, H, hd))
    return torch.cat(outs, dim=1)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of a[j+1..i] below the diagonal, -inf above."""
    T = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    s = c[..., :, None] - c[..., None, :]
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, -torch.inf)


def ssd(X: torch.Tensor, a: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """The SSD recurrence from a zero state in its chunked form (the
    listing of arXiv:2405.21060 §6), one row of the batch at a time. X (b,
    l, h, p) = dt x; a (b, l, h) = dt A; Bh, Ch (b, l, h, n). The length is
    padded with zeros to a whole number of chunks (a zero step keeps the
    state), which changes no earlier output."""
    return torch.cat([_ssd_row(X[i:i + 1], a[i:i + 1], Bh[i:i + 1], Ch[i:i + 1], chunk)
                      for i in range(X.shape[0])])


def _ssd_row(X, a, Bh, Ch, chunk):
    b, l, h, p = X.shape
    pad = (-l) % chunk
    if pad:
        X, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (X, Bh, Ch))
        a = F.pad(a, (0, 0, 0, pad))
    c = (l + pad) // chunk
    X, Bh, Ch = (t.reshape(b, c, chunk, *t.shape[2:]) for t in (X, Bh, Ch))
    a = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)             # b h c l
    a_cum = torch.cumsum(a, dim=-1)
    Lm = torch.exp(_segsum(a))                                     # b h c l s
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, Lm, X)
    decay = torch.exp(a_cum[..., -1:] - a_cum)                     # b h c l
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))  # b h z c
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states, torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, c * chunk, h, p)[:, :l]


def mamba(cfg: dict, p: dict, h: torch.Tensor, mm: Matmul) -> torch.Tensor:
    """The Mamba-2 block on h (B, S, D)."""
    B_, S, D = h.shape
    di, H, P = cfg["ssm_expand"] * D, ssm_heads(cfg), cfg["ssm_head_dim"]
    N, G, K = cfg["ssm_state"], cfg["ssm_ngroups"], cfg["conv_kernel"]
    z, xbc, dt = torch.split(mm(h, p["in_proj"]), [di, di + 2 * G * N, H], dim=-1)
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K)) + p["conv_b"]
    xs, Bm, Cm = torch.split(mm.act(F.silu(conv)), [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B_, S, H, P)
    group = torch.arange(H, device=h.device) // (H // G)
    Bh = Bm.reshape(B_, S, G, N)[:, :, group]
    Ch = Cm.reshape(B_, S, G, N)[:, :, group]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = mm.act(ssd(xs * dt[..., None], dt * A, Bh, Ch, cfg["ssm_chunk"]) + xs * p["D"][:, None])
    y = mm.act(rmsnorm(y.reshape(B_, S, di) * F.silu(z), p["ssd_norm"], cfg["norm_eps"]))
    return mm(y, p["out_proj"])


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
           mm: Matmul) -> torch.Tensor:
    return mm(mm.act(F.silu(mm(x, w_gate)) * mm(x, w_in)), w_out)


def moe(cfg: dict, p: dict, x: torch.Tensor, g: int, mm: Matmul):
    """The routed experts of x (T, D), tokens in routing order, in groups of
    g. Returns (y (T, D), (load-balance loss, router z-loss, dropped share),
    each a mean over groups)."""
    T = x.shape[0]
    E, k = cfg["n_experts"], cfg["experts_per_token"]
    n = -(-T // g)
    xp = F.pad(x, (0, 0, 0, n * g - T))
    logits = (xp @ p["router"]).reshape(n, g, E)
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]                            # n g k
    gates = torch.softmax(top, dim=-1)
    C = max(int(g * k * cfg["moe_capacity_factor"] / E), k)
    onehot = F.one_hot(idx, E)                                       # n g k E
    order = onehot.transpose(1, 2).reshape(n, k * g, E)              # choice-major
    before = (torch.cumsum(order, dim=1) - order).reshape(n, k, g, E).transpose(1, 2)
    slot = torch.gather(before, -1, idx[..., None])[..., 0]
    keep = slot < C
    f = onehot.sum(2).float().mean(1)
    aux = (E * (f * torch.softmax(logits, dim=-1).mean(1)).sum(-1) / k).mean()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = (1.0 - keep.sum((1, 2)).float() / (g * k)).mean()
    y = torch.zeros_like(xp)
    tok = torch.arange(n * g, device=x.device)[:, None].expand(n * g, k)
    idx, keep, w = idx.reshape(-1, k), keep.reshape(-1, k), (gates * keep).reshape(-1, k)
    for e in range(E):
        t, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        ye = swiglu(xp[t], p["we_gate"][e], p["we_in"][e], p["we_out"][e], mm)
        y = y.index_add(0, tok[t, j], w[t, j, None] * ye)
    return mm.act(y[:T]), torch.stack([aux, z, dropped])


def _ffn(cfg: dict, p: dict, x: torch.Tensor, prompt_len: int | None, mm: Matmul):
    """Routed experts plus the shared expert of x (B, S, D), and the MoE losses."""
    B, S, D = x.shape
    G = cfg["moe_group_size"]
    if prompt_len is None:                    # training: the whole batch, row order
        y, aux = moe(cfg, p, x.reshape(B * S, D), min(G, B * S), mm)
        y = y.reshape(B, S, D)
    else:
        y, aux = moe(cfg, p, x[:, :prompt_len].reshape(-1, D), min(G, B * prompt_len), mm)
        parts = [y.reshape(B, prompt_len, D)]
        for j in range(prompt_len, S):        # each decode step: the batch's tokens
            parts.append(moe(cfg, p, x[:, j], min(G, B), mm)[0][:, None])
        y = torch.cat(parts, dim=1)
    shared = swiglu(x, p["shared_gate"], p["shared_in"], p["shared_out"], mm)
    return mm.act(y + shared), aux


def _attention_mixer(cfg: dict, a: dict, h: torch.Tensor, mm: Matmul) -> torch.Tensor:
    B, S, _ = h.shape
    nh, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = mm(h, a["wq"]).reshape(B, S, nh, hd)
    k = mm(h, a["wk"]).reshape(B, S, kh, hd)
    v = mm(h, a["wv"]).reshape(B, S, kh, hd)
    o = mm.act(attention(q, k, v, cfg["attention_multiplier"]))
    return mm(o.reshape(B, S, nh * hd), a["wo"])


def _layer(cfg: dict, lp: dict, kind: str, x: torch.Tensor, prompt_len: int | None,
           mm: Matmul):
    eps, m = cfg["norm_eps"], cfg["residual_multiplier"]
    h = mm.act(rmsnorm(x, lp["attn_norm"], eps))
    mix = _attention_mixer(cfg, lp["attn"], h, mm) if kind == "A" else mamba(cfg, lp["ssm"], h, mm)
    x = mm.act(x + m * mix)
    y, aux = _ffn(cfg, lp["moe"], mm.act(rmsnorm(x, lp["mlp_norm"], eps)), prompt_len, mm)
    return mm.act(x + m * y), aux


def _layer_params(cfg: dict, params: dict, i: int) -> tuple[str, dict]:
    """Layer ``i``'s kind and weights: its mixer's at its rank among its kind."""
    kinds = layer_kinds(cfg)
    kind = kinds[i]
    rank = kinds[:i].count(kind)
    layers = params["layers"]
    lp = {"attn_norm": layers["attn_norm"][i], "mlp_norm": layers["mlp_norm"][i],
          "moe": {k: v[i] for k, v in layers["moe"].items()}}
    name = "attn" if kind == "A" else "ssm"
    lp[name] = {k: v[rank] for k, v in layers[name].items()}
    return kind, lp


def forward(cfg: dict, params: dict, tokens: torch.Tensor, *,
            prompt_len: int | None = None, mm: Matmul | None = None,
            remat: bool = False):
    """tokens (B, S) -> (final hidden (B, S, D) after the last norm,
    MoE losses (3,) as means over layers). ``prompt_len`` set: a served
    batch, routed as a prefill of that many tokens and decode steps after
    it. ``remat``: each layer is recomputed in the backward (memory)."""
    mm = mm or Matmul()
    x = mm.act(params["embed"][tokens] * cfg["embedding_multiplier"])
    auxes = []
    for i in range(cfg["n_layers"]):
        kind, lp = _layer_params(cfg, params, i)
        if remat:
            x, aux = checkpoint(_layer, cfg, lp, kind, x, prompt_len, mm, use_reentrant=False)
        else:
            x, aux = _layer(cfg, lp, kind, x, prompt_len, mm)
        auxes.append(aux)
    return (mm.act(rmsnorm(x, params["final_norm"], cfg["norm_eps"])),
            torch.stack(auxes).mean(0))


def logits(cfg: dict, params: dict, hidden: torch.Tensor, mm: Matmul | None = None):
    return (mm or Matmul()).raw(hidden, params["embed"].T) / cfg["logits_scaling"]


def train_loss(cfg: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
               mm: Matmul | None = None) -> torch.Tensor:
    """The training loss of the batch (B, S), the mean over all its tokens."""
    mm = mm or Matmul()
    hidden, aux = forward(cfg, params, tokens, mm=mm)
    lg = logits(cfg, params, hidden.reshape(-1, hidden.shape[-1]), mm)
    y = labels.reshape(-1)
    lse = torch.logsumexp(lg, dim=-1)
    loss = (lse - lg.gather(-1, y[:, None])[:, 0]).mean()
    loss = loss + cfg["z_loss_weight"] * lse.square().mean()
    return loss + cfg["moe_aux_loss_weight"] * aux[0] + cfg["router_z_loss_weight"] * aux[1]
