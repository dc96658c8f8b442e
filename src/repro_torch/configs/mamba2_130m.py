"""Mamba2-130M [arXiv:2405.21060; unverified]: 24L, d=768, attention-free SSD
(state-space duality), state N=128, expand 2, head_dim 64, vocab 50280."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-smoke", n_layers=2, d_model=64, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, xent_chunk=16, remat="none",
    )
