"""Gemma-7B [arXiv:2403.08295; hf]: 28L, d=3072, 16H (kv=16, i.e. MHA on 7b),
head_dim=256, d_ff=24576 GeGLU, vocab 256000, tied + scaled embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    tie_embeddings=True,
    scale_embeddings=True,
    activation="geglu",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=512, attn_block_q=16, attn_block_k=16,
        xent_chunk=16, remat="none",
    )
