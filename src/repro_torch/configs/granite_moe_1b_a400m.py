"""Granite-3.0-1B-A400M: 32-expert top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    block_pattern=(GLOBAL_ATTN,),
    num_experts=32,
    num_experts_per_tok=8,
    moe_d_ff=512,
    tie_embeddings=True,
))
