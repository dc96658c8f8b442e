"""DeepSeek-67B [arXiv:2401.02954; hf]: llama-arch, 95L, d=8192, 64H GQA(kv=8),
d_ff=22016, vocab 102400."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    tie_embeddings=False,
    activation="silu",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=192, vocab_size=512, attn_block_q=16, attn_block_k=16,
        xent_chunk=16, remat="none",
    )
