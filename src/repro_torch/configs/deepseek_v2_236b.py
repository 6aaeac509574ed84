"""DeepSeek-V2 (236B, 21B active): MLA (kv_lora=512) + MoE 160 routed top-6
with 2 shared experts; first layer dense. [arXiv:2405.04434]"""
from repro_torch.configs.base import (
    GLOBAL_ATTN, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,             # MLA: per-head K/V expanded from the latent
    head_dim=128,
    d_ff=12288,                   # dense FFN of the first layer
    vocab_size=102_400,
    block_pattern=(GLOBAL_ATTN,),
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_k_dense=1,
    rope_theta=10_000.0,
))

# The reference's train_4k run: bf16 master weights and bf16 moments (fp32
# master and moments would not fit its 256-chip mesh), 16 microbatches,
# full remat, and its sharding override (the residual stream's sequence
# axis over "model"; read by dist/sharding.py, no meaning on one card).
register_run("deepseek-v2-236b", "train_4k",
             RunConfig(num_microbatches=16, remat_policy="full",
                       master_dtype="bfloat16", opt_dtype="bfloat16",
                       sharding_overrides=(("resid_seq", ("model",)),)))
