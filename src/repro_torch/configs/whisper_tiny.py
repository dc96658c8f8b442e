"""Whisper-tiny [arXiv:2212.04356; unverified]: enc-dec, 4+4L, d=384, 6H,
d_ff=1536, vocab 51865. Conv audio frontend is a STUB — input_specs() provides
precomputed 1500-frame encoder embeddings per the assignment."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                 # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq_len=1500,
    rope_theta=0.0,             # whisper uses learned/sinusoidal positions, not RoPE
    tie_embeddings=True,
    activation="gelu",
    frontend="audio",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-smoke", n_layers=2, n_encoder_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        encoder_seq_len=32, attn_block_q=16, attn_block_k=16, xent_chunk=16,
        remat="none",
    )
