"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B; unverified]: 28L, d=3072,
24H GQA(kv=8), d_ff=8192, vocab 128256, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=True,
    activation="silu",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="llama3.2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, attn_block_q=16, attn_block_k=16,
        xent_chunk=16, remat="none",
    )
