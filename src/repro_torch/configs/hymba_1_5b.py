"""Hymba-1.5B [arXiv:2411.13676; hf]: 32L, d=1600, 25H GQA(kv=5) attention heads
in PARALLEL with mamba heads per layer, d_ff=5504, ssm_state=16, vocab 32001."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    hybrid_attn_window=1024,
    tie_embeddings=True,
    activation="silu",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="hymba-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=16,
        ssm_chunk=16, hybrid_attn_window=16, attn_block_q=16, attn_block_k=16,
        xent_chunk=16, remat="none",
    )
