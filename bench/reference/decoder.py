"""Plain PyTorch reference of the decoder LMs the benchmark runs: dense,
mixture-of-experts and hybrid (attention heads beside SSD heads).

Written from the published descriptions and the configuration's JSON
alone; it imports nothing but torch. It computes in float32 (TF32 off:
the caller sets ``torch.backends.cuda.matmul.allow_tf32 = False``) from
the same weights the program gets, upcast. ``Matmul(fp8=True)`` computes
the same model in float8 wherever the program holds bfloat16 (products'
operands and held activations e4m3, activations' gradients e5m2, each with
a per-tensor scale): the benchmark's control, one precision below the
configuration's bfloat16.

The model, layer by layer (``x`` the residual stream):

  * ``h = rmsnorm(x) * (1 + w)`` (fp32 statistics, eps from the config);
  * attention: ``q, k, v = h Wq, h Wk, h Wv`` in heads of ``head_dim``,
    RoPE on split halves, grouped-query heads by index, causal with a
    window (a key ``j`` is seen from ``i`` when ``i - window < j <= i``),
    ``softmax(q k^T / sqrt(hd)) v``, then ``Wo``;
  * hybrid: a Mamba-2 block on the same ``h`` (in_proj to z, x, B, C and
    dt; a causal depthwise conv of width ``conv_kernel`` with bias and
    SiLU; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD
    recurrence ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T``, ``y_t = s_t
    C_t + D x_t``, computed in the chunked form of arXiv:2405.21060 §6;
    ``rmsnorm(y * silu(z))`` and out_proj), and ``x += (attn + ssm) / 2``;
    otherwise ``x += attn``;
  * the FFN on ``rmsnorm(x)``: a SwiGLU MLP, or experts: fp32 router
    logits, softmax, the top ``k`` (ties to the lower index), gates
    renormalised over the ``k``; tokens routed in groups of ``g`` (zero
    rows pad the last), each expert taking at most ``C = max(int(g k cf /
    E), k)`` choices of a group in choice-major order (every token's first
    choice before any second one); a dropped choice adds nothing. The
    load-balance loss ``E sum_e f_e p_e / k``, the router z-loss (mean
    logsumexp squared) and the dropped share are means over groups, then
    over layers;
  * the final rmsnorm and fp32 logits against the (tied or own)
    unembedding; the loss is the mean NLL plus ``z_loss_weight`` times the
    mean logsumexp squared, plus the MoE losses weighted.

How a served batch groups its tokens is part of the semantics: a prefill
routes its ``B * S`` prompt tokens in groups of ``min(g, B S)`` in row
order, and each decode step the batch's ``B`` new tokens as one group.
``forward(..., prompt_len=S)`` routes so.
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
    gradient passes the rounding through. The rounded operands are made
    again in the backward rather than kept."""

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


def _gated(cfg: dict) -> bool:
    return cfg["activation"] in ("silu", "geglu")


def ssm_heads(cfg: dict) -> int:
    return cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"]


def layout(cfg: dict) -> dict[str, tuple[tuple, str, float, float]]:
    """Every weight as ``path: (shape, dtype, mean, std)``: the benchmark's
    own seeded weights are drawn as ``mean + std * N(0, 1)``. Layers are
    stacked on a leading dim; matrices are (in, out), applied as ``x @ W``.
    Every projection back into the residual stream (``wo``, ``w_out``, the
    SSD block's ``out_proj``) is scaled by ``1 / sqrt(n_layers)``, so a
    deep random model stays as well conditioned as a trained one."""
    L, D, F_, V = cfg["n_layers"], cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    dt, f32 = cfg["param_dtype"], "float32"
    out = {
        "embed": ((V, D), dt, 0.0, 0.02),
        "final_norm": ((D,), dt, 0.0, 0.1),
        "layers.attn_norm": ((L, D), dt, 0.0, 0.1),
        "layers.mlp_norm": ((L, D), dt, 0.0, 0.1),
        "layers.attn.wq": ((L, D, q), dt, 0.0, D ** -0.5),
        "layers.attn.wk": ((L, D, kv), dt, 0.0, D ** -0.5),
        "layers.attn.wv": ((L, D, kv), dt, 0.0, D ** -0.5),
        "layers.attn.wo": ((L, q, D), dt, 0.0, (q * L) ** -0.5),
    }
    if not cfg["tie_embeddings"]:
        out["unembed"] = ((V, D), dt, 0.0, 0.02)
    if cfg["n_experts"] > 0:
        E = cfg["n_experts"]
        out["layers.moe.router"] = ((L, D, E), f32, 0.0, D ** -0.5)
        out["layers.moe.we_in"] = ((L, E, D, F_), dt, 0.0, D ** -0.5)
        out["layers.moe.we_out"] = ((L, E, F_, D), dt, 0.0, F_ ** -0.5)
        if _gated(cfg):
            out["layers.moe.we_gate"] = ((L, E, D, F_), dt, 0.0, D ** -0.5)
    else:
        out["layers.mlp.w_in"] = ((L, D, F_), dt, 0.0, D ** -0.5)
        out["layers.mlp.w_out"] = ((L, F_, D), dt, 0.0, (F_ * L) ** -0.5)
        if _gated(cfg):
            out["layers.mlp.w_gate"] = ((L, D, F_), dt, 0.0, D ** -0.5)
    if cfg["family"] == "hybrid":
        H, N, G = ssm_heads(cfg), cfg["ssm_state"], cfg["ssm_ngroups"]
        di = cfg["ssm_expand"] * D
        conv_ch = di + 2 * G * N
        out.update({
            "layers.ssm.in_proj": ((L, D, 2 * di + 2 * G * N + H), dt, 0.0, D ** -0.5),
            "layers.ssm.conv_w": ((L, cfg["conv_kernel"], conv_ch), dt, 0.0, 0.5),
            "layers.ssm.conv_b": ((L, conv_ch), dt, 0.0, 0.1),
            "layers.ssm.A_log": ((L, H), f32, 1.4, 0.6),
            "layers.ssm.dt_bias": ((L, H), f32, 0.0, 0.5),
            "layers.ssm.D": ((L, H), f32, 1.0, 0.1),
            "layers.ssm.ssd_norm": ((L, di), dt, 0.0, 0.1),
            "layers.ssm.out_proj": ((L, di, D), dt, 0.0, (di * L) ** -0.5),
        })
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), pos (S,): rotate the two halves of each head."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
              block: int = 512) -> torch.Tensor:
    """Causal windowed softmax attention, a block of queries at a time.
    q (B, S, H, hd), k and v (B, S, K, hd); query i sees keys j with
    ``i - window < j <= i`` (no lower limit when window is 0)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    rep = H // K
    outs = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        k0 = max(0, s0 - window + 1) if window > 0 else 0
        qs = q[:, s0:s1].reshape(B, s1 - s0, K, rep, hd) / math.sqrt(hd)
        sc = torch.einsum("bqkrd,bskd->bkrqs", qs, k[:, k0:s1])
        qp = torch.arange(s0, s1, device=q.device)[:, None]
        kp = torch.arange(k0, s1, device=q.device)[None, :]
        see = kp <= qp
        if window > 0:
            see = see & (kp > qp - window)
        p = torch.softmax(sc.masked_fill(~see, NEG), dim=-1)
        outs.append(torch.einsum("bkrqs,bskd->bqkrd", p, v[:, k0:s1]).reshape(B, s1 - s0, H, hd))
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
    listing of arXiv:2405.21060 §6). X (b, l, h, p) = dt x; a (b, l, h) =
    dt A; Bh, Ch (b, l, h, n). The length is padded with zeros to a whole
    number of chunks (a zero step keeps the state), which changes no
    earlier output."""
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


def moe(cfg: dict, p: dict, x: torch.Tensor, g: int, mm: Matmul):
    """x (T, D) tokens in routing order, in groups of g. Returns (y (T, D),
    (load-balance loss, router z-loss, dropped share), each a mean over groups)."""
    T = x.shape[0]
    E, k = cfg["n_experts"], cfg["experts_per_token"]
    n = -(-T // g)
    xp = F.pad(x, (0, 0, 0, n * g - T))
    logits = (xp @ p["router"]).reshape(n, g, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, idx = top_p[..., :k], idx[..., :k]                        # n g k
    gates = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    C = max(int(g * k * cfg["moe_capacity_factor"] / E), k)
    onehot = F.one_hot(idx, E)                                       # n g k E
    order = onehot.transpose(1, 2).reshape(n, k * g, E)              # choice-major
    before = (torch.cumsum(order, dim=1) - order).reshape(n, k, g, E).transpose(1, 2)
    slot = torch.gather(before, -1, idx[..., None])[..., 0]
    keep = slot < C
    f = onehot.sum(2).float().mean(1)
    aux = (E * (f * probs.mean(1)).sum(-1) / k).mean()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = (1.0 - keep.sum((1, 2)).float() / (g * k)).mean()
    y = torch.zeros_like(xp)
    tok = torch.arange(n * g, device=x.device)[:, None].expand(n * g, k)
    idx, keep, w = idx.reshape(-1, k), keep.reshape(-1, k), (gates * keep).reshape(-1, k)
    for e in range(E):
        t, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        xe = xp[t]
        he = mm(xe, p["we_in"][e])
        if _gated(cfg):
            he = mm.act(F.silu(mm(xe, p["we_gate"][e])) * he)
        else:
            he = mm.act(F.gelu(he, approximate="tanh"))
        y = y.index_add(0, tok[t, j], w[t, j, None] * mm(he, p["we_out"][e]))
    return mm.act(y[:T]), torch.stack([aux, z, dropped])


def _ffn(cfg: dict, lp: dict, x: torch.Tensor, prompt_len: int | None, mm: Matmul):
    """The FFN of x (B, S, D) and its MoE losses (zeros for an MLP)."""
    if cfg["n_experts"] == 0:
        gate = mm(x, lp["mlp"]["w_gate"]) if _gated(cfg) else None
        hid = mm(x, lp["mlp"]["w_in"])
        hid = mm.act(F.silu(gate) * hid if gate is not None else F.gelu(hid, approximate="tanh"))
        return mm(hid, lp["mlp"]["w_out"]), torch.zeros(3, device=x.device)
    B, S, D = x.shape
    G = cfg["moe_group_size"]
    if prompt_len is None:                    # training: the whole batch, row order
        y, aux = moe(cfg, lp["moe"], x.reshape(B * S, D), min(G, B * S), mm)
        return y.reshape(B, S, D), aux
    y, aux = moe(cfg, lp["moe"], x[:, :prompt_len].reshape(-1, D),
                 min(G, B * prompt_len), mm)
    parts = [y.reshape(B, prompt_len, D)]
    for j in range(prompt_len, S):            # each decode step: the batch's tokens
        parts.append(moe(cfg, lp["moe"], x[:, j], min(G, B), mm)[0][:, None])
    return torch.cat(parts, dim=1), aux


def _layer(cfg: dict, lp: dict, x: torch.Tensor, prompt_len: int | None, mm: Matmul):
    eps = cfg["norm_eps"]
    B, S, _ = x.shape
    nh, kh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    hybrid = cfg["family"] == "hybrid"
    window = cfg["hybrid_attn_window"] if hybrid else cfg["sliding_window"]
    h = mm.act(rmsnorm(x, lp["attn_norm"], eps))
    pos = torch.arange(S, device=x.device)
    a = lp["attn"]
    q = mm.act(rope(mm(h, a["wq"]).reshape(B, S, nh, hd), pos, cfg["rope_theta"]))
    k = mm.act(rope(mm(h, a["wk"]).reshape(B, S, kh, hd), pos, cfg["rope_theta"]))
    v = mm(h, a["wv"]).reshape(B, S, kh, hd)
    att = mm(mm.act(attention(q, k, v, window)).reshape(B, S, nh * hd), a["wo"])
    if hybrid:
        x = mm.act(x + 0.5 * (att + mamba(cfg, lp["ssm"], h, mm)))
    else:
        x = mm.act(x + att)
    y, aux = _ffn(cfg, lp, mm.act(rmsnorm(x, lp["mlp_norm"], eps)), prompt_len, mm)
    return mm.act(x + y), aux


def _layer_params(params: dict, i: int) -> dict:
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return take(params["layers"])


def forward(cfg: dict, params: dict, tokens: torch.Tensor, *,
            prompt_len: int | None = None, mm: Matmul | None = None,
            remat: bool = False):
    """tokens (B, S) -> (final hidden (B, S, D) after the last norm,
    MoE losses (3,) as means over layers). ``prompt_len`` set: a served
    batch, routed as a prefill of that many tokens and decode steps after
    it. ``remat``: each layer is recomputed in the backward (memory)."""
    mm = mm or Matmul()
    x = mm.act(params["embed"][tokens])
    auxes = []
    for i in range(cfg["n_layers"]):
        lp = _layer_params(params, i)
        if remat:
            x, aux = checkpoint(_layer, cfg, lp, x, prompt_len, mm, use_reentrant=False)
        else:
            x, aux = _layer(cfg, lp, x, prompt_len, mm)
        auxes.append(aux)
    return (mm.act(rmsnorm(x, params["final_norm"], cfg["norm_eps"])),
            torch.stack(auxes).mean(0))


def unembed(cfg: dict, params: dict) -> torch.Tensor:
    return params["embed"] if cfg["tie_embeddings"] else params["unembed"]


def logits(cfg: dict, params: dict, hidden: torch.Tensor, mm: Matmul | None = None):
    return (mm or Matmul()).raw(hidden, unembed(cfg, params).T)


def _xent(cfg, w, h, y, mm):
    lg = mm.raw(h, w.T)
    lse = torch.logsumexp(lg, dim=-1)
    return (lse - lg.gather(-1, y[:, None])[:, 0]).sum(), lse.square().sum()


def train_loss(cfg: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
               mm: Matmul | None = None, chunk: int = 4096) -> torch.Tensor:
    """The training loss of the batch (B, S), the mean over all its tokens."""
    mm = mm or Matmul()
    hidden, aux = forward(cfg, params, tokens, mm=mm, remat=cfg["n_layers"] > 1)
    h = hidden.reshape(-1, hidden.shape[-1])
    y = labels.reshape(-1)
    w = unembed(cfg, params)
    nll = lse2 = 0.0
    for s in range(0, h.shape[0], chunk):
        a, b = checkpoint(_xent, cfg, w, h[s:s + chunk], y[s:s + chunk], mm,
                          use_reentrant=False)
        nll, lse2 = nll + a, lse2 + b
    n = h.shape[0]
    loss = nll / n + cfg["z_loss_weight"] * lse2 / n
    if cfg["n_experts"] > 0:
        loss = loss + cfg["moe_aux_loss_weight"] * aux[0] + cfg["router_z_loss_weight"] * aux[1]
    return loss
