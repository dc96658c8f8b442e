"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L, d=6144, 48H GQA(kv=8), d_ff=16384,
vocab 32768, MoE 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
    tie_embeddings=False,
    activation="silu",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, n_experts=4, experts_per_token=2,
        sliding_window=16, moe_group_size=64, attn_block_q=16, attn_block_k=16,
        xent_chunk=16, remat="none",
    )
