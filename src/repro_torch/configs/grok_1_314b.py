"""Grok-1 314B [hf:xai-org/grok-1; unverified]: 64L, d=6144, 48H GQA(kv=8),
d_ff=32768, vocab 131072, MoE 8 experts top-2, attention logit softcap 30."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    experts_per_token=2,
    attn_logit_softcap=30.0,
    logits_softcap=30.0,
    tie_embeddings=True,
    activation="geglu",      # grok-1 MoE MLP is gated GeLU (linear/linear_v/linear_1)
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="grok-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=256, n_experts=4, experts_per_token=2,
        moe_group_size=64, attn_block_q=16, attn_block_k=16, xent_chunk=16,
        remat="none",
    )
