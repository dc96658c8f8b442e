"""StarCoder2-7B [arXiv:2402.19173; hf]: 32L, d=4608, 36H GQA(kv=4),
d_ff=18432 (non-gated GELU MLP), vocab 49152, RoPE, sliding window 4096."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    sliding_window=4096,
    rope_theta=1e5,
    tie_embeddings=True,
    activation="gelu",      # starcoder2 uses a plain (non-gated) GELU MLP
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=512, sliding_window=16,
        attn_block_q=16, attn_block_k=16, xent_chunk=16, remat="none",
    )
