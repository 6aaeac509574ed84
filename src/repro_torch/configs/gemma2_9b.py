"""Gemma-2 9B: alternating local/global attention, logit softcaps, sandwich
norms. [arXiv:2408.00118]"""
from repro_torch.configs.base import (
    GLOBAL_ATTN, LOCAL_ATTN, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    block_pattern=(LOCAL_ATTN, GLOBAL_ATTN),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=256.0,
    use_post_block_norm=True,
    act="gelu_tanh",
    embed_scale_by_sqrt_dim=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
))

# The reference's train_4k run: 4 microbatches, full remat, fp32 master
# weights and moments (it sets no sharding override).
register_run("gemma2-9b", "train_4k",
             RunConfig(num_microbatches=4, remat_policy="full"))
