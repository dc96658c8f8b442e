"""Chameleon-34B [arXiv:2405.09818; unverified]: 48L, d=8192, 64H GQA(kv=8),
d_ff=22016, vocab 65536 (early-fusion: text + VQ image tokens share the
vocabulary). The VQ image tokenizer is a STUB — input_specs() provides
precomputed token ids / patch embeddings per the assignment."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    tie_embeddings=False,
    activation="silu",
    frontend="patch",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="chameleon-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=192, vocab_size=512, attn_block_q=16, attn_block_k=16,
        xent_chunk=16, remat="none",
    )
