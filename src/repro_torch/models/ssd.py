"""Mamba-2 SSD (state-space duality) layer — chunked parallel form.

The same algorithm and contracts as the JAX package's ``models/ssd.py``
(arXiv:2405.21060 §6): the sequence is split into chunks of length Q, each
chunk computed in its quadratic "attention-like" form, and a linear
recurrence carries the (H, P, N) state across chunks.

``ssd_chunked_reference`` is the ``use_pallas=False`` path; with
``use_pallas`` on, ``mamba_block`` routes the scan to the hand-written
kernel through ``repro_torch.kernels.ops.ssd_scan`` (CUDA on the card, its
plain version for CPU tensors).

Shapes: x (B,S,H,P) inputs, dt (B,S,H) timesteps (post-softplus), A (H,)
negative decay rates, B/C (B,S,G,N) input/output projections (G groups
broadcast over heads by index). As in the reference, the chunked views are
constrained to head parallelism (``shard_heads(..., head_shard,
head_axis=3)``); on DTensors the three steps then run on each device's
blocks (``dist.sharding.per_shard``), and off a mesh nothing changes.

Parameters and caches keep the reference's layout. ``A_log``, ``dt_bias``
and ``D`` are fp32 whatever the parameter dtype, as there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import merge_last, per_shard, shard_heads, split_last
from repro_torch.models.common import dense_init, rms_norm


def segsum(la: torch.Tensor) -> torch.Tensor:
    """la: (..., Q) log-decays -> (..., Q, Q) lower-triangular cumulative sums.

    out[..., i, j] = sum_{m=j+1..i} la[..., m]   (for j <= i; -inf above diag)
    """
    Q = la.shape[-1]
    cum = torch.cumsum(la, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=la.device))
    return diff.masked_fill(~mask, float("-inf"))


def chunk_views(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    *, chunk: int,
) -> tuple[torch.Tensor, ...]:
    """The inputs as fp32 chunks: x (B,n,Q,H,P), dt (B,n,Q,H), B and C
    broadcast to heads (B,n,Q,H,N), the log decays dt*A (B,n,Q,H) and their
    in-chunk prefix sums ``cum`` (B,n,Q,H)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    n_chunks = S // Q
    xc = x.float().reshape(B_, n_chunks, Q, H, P)
    dtc = dt.float().reshape(B_, n_chunks, Q, H)
    Bc = Bm.float().reshape(B_, n_chunks, Q, G, N)
    Cc = Cm.float().reshape(B_, n_chunks, Q, G, N)
    lac = dtc * A.float()[None, None, None, :]                   # (B,n,Q,H) log decays
    head_group = torch.arange(H, device=x.device) // (H // G)    # map head -> group
    Bh = Bc[:, :, :, head_group, :]                              # (B,n,Q,H,N)
    Ch = Cc[:, :, :, head_group, :]
    cum = torch.cumsum(lac, dim=2)                               # (B,n,Q,H)
    return xc, dtc, Bh, Ch, lac, cum


def chunk_states(xc: torch.Tensor, dtc: torch.Tensor, Bh: torch.Tensor,
                 cum: torch.Tensor) -> torch.Tensor:
    """Step 1, each chunk's own state (B,n,H,P,N):
    S_c = sum_j exp(cum_end - cum_j) dt_j x_j ⊗ B_j."""
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,n,Q,H)
    return torch.einsum("bnjh,bnjh,bnjhs,bnjhp->bnhps", decay_to_end, dtc, Bh, xc)


def state_passing(states: torch.Tensor, cum: torch.Tensor,
                  initial_state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 2, in chunk order: h_c = exp(cum_end,c) h_{c-1} + S_c from
    h_{-1} = ``initial_state`` (zeros if None). Returns the state entering
    each chunk, h_{c-1} (B,n,H,P,N), and the final state (B,H,P,N)."""
    B_, n_chunks, H, P, N = states.shape
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B,n,H)
    if initial_state is None:
        h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=states.device)
    else:
        h = initial_state.float()
    h_prevs = []
    for c in range(n_chunks):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(h_prevs, dim=1), h


def chunk_output(xc: torch.Tensor, dtc: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor,
                 lac: torch.Tensor, cum: torch.Tensor, h_prevs: torch.Tensor) -> torch.Tensor:
    """Step 3, per chunk (B,n,Q,H,P) fp32:
    y = (C B^T ⊙ L ⊙ dt) x + (C ⊙ exp(cum)) h_{c-1}^T, L[i,j] = exp(cum_i - cum_j), j <= i."""
    L = torch.exp(segsum(lac.permute(0, 1, 3, 2)))               # (B,n,H,Q,Q)
    scores = torch.einsum("bnihd,bnjhd->bnhij", Ch, Bh)          # (B,n,H,Q,Q)
    y_intra = torch.einsum("bnhij,bnhij,bnjh,bnjhp->bnihp", scores, L, dtc, xc)
    in_decay = torch.exp(cum)                                    # (B,n,Q,H)
    y_inter = torch.einsum("bnihs,bnhps,bnih->bnihp", Ch, h_prevs, in_decay)
    return y_intra + y_inter


def ssd_chunked_reference(
    x: torch.Tensor,   # (B,S,H,P)
    dt: torch.Tensor,  # (B,S,H)
    A: torch.Tensor,   # (H,)
    Bm: torch.Tensor,  # (B,S,G,N)
    Cm: torch.Tensor,  # (B,S,G,N)
    *,
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (B,H,P,N)
    head_shard: str = "none",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32). fp32 math.

    The three steps of the chunk-parallel form, as the kernel runs them:
    ``chunk_states``, ``state_passing``, ``chunk_output``.
    """
    views = chunk_views(x, dt, A, Bm, Cm, chunk=chunk)
    # every intra-chunk einsum batches over (B, n, H): pin H to the model axis
    xc, dtc, Bh, Ch, lac, cum = (shard_heads(t, head_shard, head_axis=3) for t in views)
    tensors = (xc, dtc, Bh, Ch, lac, cum)
    if initial_state is not None:
        # (B,H,P,N): the head dim at 1
        initial_state = shard_heads(initial_state, head_shard, head_axis=1)
        tensors += (initial_state,)
    y, h = per_shard(_chunk_scan, tensors, outs=(None, {0: 0, 3: 1}))
    return y.reshape(x.shape).to(x.dtype), h


def _chunk_scan(xc, dtc, Bh, Ch, lac, cum, initial_state=None):
    states = chunk_states(xc, dtc, Bh, cum)
    h_prevs, h = state_passing(states, cum, initial_state)
    return chunk_output(xc, dtc, Bh, Ch, lac, cum, h_prevs), h


def ssd_decode_step(
    x: torch.Tensor,      # (B,H,P)
    dt: torch.Tensor,     # (B,H)
    A: torch.Tensor,      # (H,)
    Bm: torch.Tensor,     # (B,G,N)
    Cm: torch.Tensor,     # (B,G,N)
    state: torch.Tensor,  # (B,H,P,N) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: h = h*exp(dt*A) + dt*B⊗x ; y = C·h."""
    H = x.shape[1]
    G = Bm.shape[1]
    head_group = torch.arange(H, device=x.device) // (H // G)
    Bh = Bm[:, head_group, :].float()                            # (B,H,N)
    Ch = Cm[:, head_group, :].float()
    dtf = dt.float()
    dec = torch.exp(dtf * A.float())                             # (B,H)
    xf = x.float()
    new_state = state * dec[..., None, None] + \
        dtf[..., None, None] * xf[..., :, None] * Bh[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


# ----------------------------------------------------------------------------
# Full Mamba-2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ----------------------------------------------------------------------------

class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, K-1, conv_ch) rolling conv inputs
    state: torch.Tensor   # (B, H, P, N) fp32 SSD state


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    return cfg.d_inner, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups


def ssm_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    """``{name: (shape, dtype name)}`` of the SSM subtree, stacked ``(L, ...)``."""
    di, H, P, N, G = ssm_dims(cfg)
    D, L = cfg.d_model, n_layers
    conv_ch = di + 2 * G * N
    proj_out = 2 * di + 2 * G * N + H   # z, x, B, C, dt
    dt, f32 = cfg.param_dtype, "float32"
    return {
        "in_proj": ((L, D, proj_out), dt),
        "conv_w": ((L, cfg.conv_kernel, conv_ch), dt),
        "conv_b": ((L, conv_ch), dt),
        "A_log": ((L, H), f32),
        "dt_bias": ((L, H), f32),
        "D": ((L, H), f32),
        "ssd_norm": ((L, di), dt),
        "out_proj": ((L, di, D), dt),
    }


def init_ssm_cache(cfg: ModelConfig, n_layers: int, batch: int,
                   device: torch.device, dtype: torch.dtype) -> dict:
    """Zero ``conv`` (L, B, K-1, C) in ``dtype`` and ``state`` (L, B, H, P, N) fp32."""
    di, H, P, N, G = ssm_dims(cfg)
    return {
        "conv": torch.zeros((n_layers, batch, cfg.conv_kernel - 1, di + 2 * G * N),
                            dtype=dtype, device=device),
        "state": torch.zeros((n_layers, batch, H, P, N), dtype=torch.float32, device=device),
    }


def stack_ssm_caches(caches: list[SSMCache]) -> dict:
    """Per-layer prefill caches as the decode cache's stacked ``conv``/``state``."""
    return {"conv": torch.stack([c.conv for c in caches]),
            "state": torch.stack([c.state for c in caches])}


def init_ssm_params(cfg: ModelConfig, n_layers: int, generator: torch.Generator,
                    device: torch.device, dtype: torch.dtype) -> dict:
    """The SSM subtree for ``n_layers`` layers, stacked, drawn on ``device``.

    The JAX package's ``init_ssm_params`` per layer: fan-in truncated
    normals for the projections, ``conv_w`` at σ = 0.5, zero ``conv_b`` and
    ``ssd_norm``, ``A_log = log(linspace(1, 16, H))``, zero ``dt_bias`` and
    unit ``D`` (the last three fp32).
    """
    specs = ssm_param_specs(cfg, n_layers)
    H = cfg.ssm_nheads
    out: dict = {}
    for name, (shape, _) in specs.items():
        if name in ("in_proj", "conv_w", "out_proj"):
            w = torch.empty(shape, dtype=dtype, device=device)
            for i in range(n_layers):
                dense_init(w[i], generator, scale=0.5 if name == "conv_w" else None)
            out[name] = w
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    out["conv_b"] = torch.zeros(specs["conv_b"][0], dtype=dtype, device=device)
    out["A_log"] = a_log.expand(n_layers, H).contiguous()
    out["dt_bias"] = torch.zeros((n_layers, H), **f32)
    out["D"] = torch.ones((n_layers, H), **f32)
    out["ssd_norm"] = torch.zeros(specs["ssd_norm"][0], dtype=dtype, device=device)
    return {name: out[name] for name in specs}


def _split_zxbcdt(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, H, P, N, G = ssm_dims(cfg)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: (B,S,C), w: (K,C). history: (B,K-1,C)."""
    K = w.shape[0]
    S = xbc.shape[1]
    if history is None:
        history = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                              dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([history, xbc], dim=1)                        # (B, S+K-1, C)
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                initial: SSMCache | None = None) -> tuple[torch.Tensor, SSMCache]:
    """x: (B,S,D) -> (B,S,D). Returns output + final cache (for decode handoff)."""
    B_, S, _ = x.shape
    di, H, P, N, G = ssm_dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z, xbc_raw, dt_raw = _split_zxbcdt(cfg, zxbcdt)
    hist = initial.conv if initial is not None else None
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"], hist))
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    # strided views into xbc: the kernel reads them in place
    xs = split_last(xs, H, P)
    Bm = split_last(Bm, G, N)
    Cm = split_last(Cm, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B,S,H) fp32
    A = -torch.exp(p["A_log"])

    init_state = initial.state if initial is not None else None
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops
        y, h_final = kops.ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                                   initial_state=init_state)
    else:
        y, h_final = ssd_chunked_reference(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                                           initial_state=init_state,
                                           head_shard=cfg.act_shard)
    y = y + xs * p["D"][None, None, :, None].to(y.dtype)
    y = merge_last(y)
    y = rms_norm(y * F.silu(z), p["ssd_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    K = cfg.conv_kernel
    if S >= K - 1:
        conv_tail = xbc_raw[:, S - (K - 1):, :]
    else:
        prev = hist if hist is not None else torch.zeros(
            (B_, K - 1, xbc_raw.shape[-1]), dtype=x.dtype, device=x.device)
        conv_tail = torch.cat([prev, xbc_raw], dim=1)[:, -(K - 1):, :]
    return out, SSMCache(conv=conv_tail, state=h_final)


def mamba_decode_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      cache: SSMCache) -> tuple[torch.Tensor, SSMCache]:
    """x: (B,1,D) one token. Returns (out (B,1,D), new cache)."""
    B_ = x.shape[0]
    di, H, P, N, G = ssm_dims(cfg)
    zxbcdt = x[:, 0, :] @ p["in_proj"]                           # (B, proj)
    z, xbc_new, dt_raw = _split_zxbcdt(cfg, zxbcdt)
    window = torch.cat([cache.conv, xbc_new[:, None, :]], dim=1)  # (B,K,C)
    xbc = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B_, H, P)
    Bm = Bm.reshape(B_, G, N)
    Cm = Cm.reshape(B_, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B,H)
    A = -torch.exp(p["A_log"])
    y, new_state = ssd_decode_step(xs, dt, A, Bm, Cm, cache.state)
    y = y + xs * p["D"][None, :, None].to(y.dtype)
    y = y.reshape(B_, di)
    y = rms_norm(y * F.silu(z), p["ssd_norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, SSMCache(conv=window[:, 1:, :], state=new_state)
