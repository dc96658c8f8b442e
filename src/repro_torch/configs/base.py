"""Model/run configuration dataclasses (the port's own copy).

Every assigned architecture is expressed as a :class:`ModelConfig`, field
for field the same as the JAX package's, so a configuration means the same
model in both. The port's own fields follow them: a layer pattern (layers
of two kinds in one stack), a shared expert beside the routed ones, and
the embedding, residual, logit and attention multipliers. They describe
architectures only the port runs (``granite-4.0-h-small``; its lack of a
positional embedding is ``rope_theta = 0``), and at their defaults every
shared configuration is the model it was. The config is a frozen
dataclass: hashable and immutable.
``use_pallas`` keeps its name and reads here as "use the hand-written
kernel" (CUDA on the card, its plain PyTorch version on CPU tensors).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    Families:
      dense   -- standard decoder-only transformer (llama-style)
      moe     -- decoder-only transformer with mixture-of-experts FFN
      ssm     -- attention-free state-space model (Mamba-2 / SSD)
      hybrid  -- parallel attention + SSM heads per layer (hymba-style)
      encdec  -- encoder-decoder transformer (whisper-style)
      vlm     -- early-fusion VLM; the backbone is a dense transformer and the
                 image frontend is a stub (precomputed patch embeddings)
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- layer pattern ---
    # one period, a letter a layer: "A" attention, "M" a Mamba-2 block (the
    # SSM fields below), repeated to n_layers; "" = every layer the family's
    layer_pattern: str = ""

    # --- attention ---
    rope_theta: float = 10000.0      # 0 = no positional embedding (NoPE)
    attention_multiplier: float = 0.0  # the score scale; 0 = 1/sqrt(head_dim)
    sliding_window: int = 0          # 0 = full attention
    attn_logit_softcap: float = 0.0  # 0 = disabled (grok uses 30.0)
    attn_block_q: int = 512          # blocked-attention query tile
    attn_block_k: int = 1024         # blocked-attention key tile
    causal_block_skip: bool = True   # skip fully-masked KV blocks (perf lever)

    # --- mlp ---
    activation: str = "silu"         # silu -> SwiGLU, geglu -> GeGLU, gelu -> plain GELU

    # --- embeddings ---
    tie_embeddings: bool = True
    scale_embeddings: bool = False   # gemma multiplies embeddings by sqrt(d_model)
    embedding_multiplier: float = 1.0  # embeddings times this (granite: 12)
    residual_multiplier: float = 1.0   # each branch times this as it joins the stream
    logits_scaling: float = 1.0        # the logits divided by this

    # --- moe ---
    n_experts: int = 0
    experts_per_token: int = 0
    shared_d_ff: int = 0             # >0: a shared expert this wide beside the routed ones
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 4096       # tokens per dispatch group
    moe_aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 0.001

    # --- ssm (Mamba-2 / SSD) ---
    ssm_state: int = 0               # N: state dimension per head
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_head_dim: int = 64           # P
    ssm_ngroups: int = 1             # B/C groups
    ssm_chunk: int = 256             # SSD chunk length
    conv_kernel: int = 4

    # --- hybrid (hymba) ---
    hybrid_attn_window: int = 1024   # SWA used by the attention branch
    meta_tokens: int = 0             # hymba learnable prefix tokens (0 = off)

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500      # whisper: 30s of audio at 50 Hz

    # --- modality frontend stubs ---
    frontend: str = "none"           # none | audio | patch

    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: str = "full"              # none | full | dots
    scan_block: int = 0              # >0: two-level layer scan (remat over blocks)
    logits_softcap: float = 0.0
    use_pallas: bool = False         # hand-written kernels; False = blocked path
    act_shard: str = "batch"         # none | batch | batch_seq (sequence parallelism)
    fsdp_gather: str = "layer"       # layer (ZeRO-3: re-gather per layer/pass)
                                     # | step (ZeRO-2: gather stacked weights once)

    # --- loss ---
    xent_chunk: int = 512            # sequence chunk for cross-entropy (bounds logits memory)
    z_loss_weight: float = 1e-4

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived quantities ----
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def layer_kinds(self) -> str:
        """Each layer's mixer, a letter a layer: "A" attention, "M" a Mamba-2
        block, "H" both side by side (the hybrid family's layer). Under
        ``layer_pattern`` its period repeated to ``n_layers``; else the
        family's letter on every layer."""
        period = self.layer_pattern
        if set(period) - {"A", "M"}:
            raise ValueError(f"layer_pattern {period!r}: one letter a layer, A or M")
        if not period:
            period = {"hybrid": "H", "ssm": "M"}.get(self.family, "A")
        return (period * -(-self.n_layers // len(period)))[:self.n_layers]

    def gated_mlp(self) -> bool:
        return self.activation in ("silu", "geglu")

    # ---- parameter counting (used by tests + roofline MODEL_FLOPS) ----
    def attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def mlp_params_per_expert(self) -> int:
        mats = 3 if self.gated_mlp() else 2
        return mats * self.d_model * self.d_ff

    def ssm_params_per_layer(self) -> int:
        if self.ssm_state == 0:
            return 0
        d, di, n, h = self.d_model, self.d_inner, self.ssm_state, self.ssm_nheads
        g = self.ssm_ngroups
        in_proj = d * (2 * di + 2 * g * n + h)      # z, x, B, C, dt
        conv = (self.conv_kernel + 1) * (di + 2 * g * n)   # conv_w + conv_b
        out_proj = di * d
        extras = 3 * h + di                          # A_log, dt_bias, D, norm
        return in_proj + conv + out_proj + extras

    def shared_expert_params(self) -> int:
        return 3 * self.d_model * self.shared_d_ff if self.shared_d_ff else 0

    def mixer_params(self, kind: str) -> int:
        """The mixer's parameters in a layer of ``kind`` (``layer_kinds``)."""
        attn, ssm = self.attn_params(), self.ssm_params_per_layer()
        # ssd_norm is already inside ssm_params_per_layer()
        return {"A": attn, "M": ssm, "H": attn + ssm}[kind]

    def params_per_layer(self, kind: str) -> int:
        """One layer's parameters, in a layer of ``kind`` (``layer_kinds``)."""
        d = self.d_model
        if self.family == "ssm":
            return self.ssm_params_per_layer() + d
        ffn = self.mlp_params_per_expert()
        if self.is_moe:
            ffn = (self.n_experts * ffn + self.d_model * self.n_experts
                   + self.shared_expert_params())
        return self.mixer_params(kind) + ffn + 2 * d

    def embed_params(self) -> int:
        e = self.vocab_size * self.d_model
        return e if self.tie_embeddings else 2 * e

    def total_params(self) -> int:
        n = (sum(self.params_per_layer(kind) for kind in self.layer_kinds)
             + self.embed_params() + self.d_model)
        if self.is_encoder_decoder:
            # encoder layers use plain self-attn + mlp; decoder adds cross-attn
            enc = self.n_encoder_layers * (self.attn_params() + self.mlp_params_per_expert() + 2 * self.d_model)
            dec_cross = self.n_layers * (self.attn_params() + self.d_model)
            n += enc + dec_cross + self.d_model    # + enc_norm
        return n

    def active_params(self) -> int:
        """Params touched per token (MoE uses experts_per_token of n_experts)."""
        if not self.is_moe:
            return self.total_params()
        d = self.d_model
        # beside the mixer: the experts a token uses, the router and the norms
        rest = (self.experts_per_token * self.mlp_params_per_expert()
                + self.shared_expert_params() + d * self.n_experts + 2 * d)
        return (sum(self.mixer_params(kind) + rest for kind in self.layer_kinds)
                + self.embed_params() + d)


@dataclass(frozen=True)
class ShapeSpec:
    """An assigned (input-shape) cell: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES: Mapping[str, ShapeSpec] = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention; see DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k":
        subquad = (
            cfg.family in ("ssm", "hybrid")
            or (cfg.sliding_window > 0 and cfg.sliding_window < shape.seq_len)
        )
        if not subquad:
            return False, "full-attention arch: 524k-token decode is quadratic; skipped per assignment"
    if cfg.is_encoder_decoder and shape.kind == "decode" and shape.seq_len > 32768:
        return False, "enc-dec decoder window bounded by encoder context"
    return True, ""


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop hyperparameters."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    # distributed-optimization knobs (beyond-paper)
    grad_compression: str = "none"   # none | int8 | topk
    topk_fraction: float = 0.05
    # legio knobs (the paper's two knobs + policies)
    legion_size: int = 0             # k; 0 = auto (Eq. 3)
    hierarchical_threshold: int = 12 # use hierarchy when cluster size > threshold (paper: s>11)
    root_failure_policy: str = "ignore"  # ignore | stop   (paper §IV)
    batch_policy: str = "drop"       # drop | rebalance
    straggler_threshold: float = 3.0 # x median step time; 0 = off
    checkpoint_every: int = 0        # steps; 0 = off
    checkpoint_dir: str = ""
