"""Granite-4.0-H-Small [hf: ibm-granite/granite-4.0-h-small, ``granitemoehybrid``]:
40L of one mixer and one expert FFN each, the mixers Mamba-2 and attention in
the pattern MMMMMAMMMM four times over (attention at layers 5, 15, 25, 35);
d=4096; Mamba-2 128 heads of 64, d_state 128, 1 group, conv 4; attention
32H GQA(kv=8) of 128, no positional embedding, score scale 1/128; 72 experts
of 768 top-10 beside a shared expert of 1536; embeddings x12, each branch
x0.22 into the stream, logits /16; vocab 100352, tied. 32B total, 9B active.

A layer: ``h += 0.22 * mixer(rmsnorm(h))``, then
``h += 0.22 * (moe(rmsnorm(h)) + shared(rmsnorm(h)))``. The router takes
the softmax over the ten chosen logits, which is the port's softmax over all
72 renormalised over the chosen ten. Port-only: the JAX package has no such
model, so the id stays out of the shared ``ARCH_IDS`` grid."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="moe",
    n_layers=40,
    layer_pattern="MMMMMAMMMM",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    rope_theta=0.0,                  # no positional embedding (the release's "nope")
    attention_multiplier=0.0078125,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    n_experts=72,
    experts_per_token=10,
    shared_d_ff=1536,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    conv_kernel=4,
    norm_eps=1e-5,
    activation="silu",
)


def smoke_config() -> ModelConfig:
    # two periods of MAM: attention at layers 1 and 4, so each kind's
    # stack holds more than one layer
    return CONFIG.replace(
        name="granite-smoke", n_layers=6, layer_pattern="MAM", d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256, n_experts=8,
        experts_per_token=3, shared_d_ff=48, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
        moe_group_size=64, attention_multiplier=0.1, attn_block_q=16, attn_block_k=16,
        xent_chunk=16, remat="none",
    )
