"""Qwen3-0.6B: dense GQA with per-head qk RMSNorm. [hf:Qwen/Qwen3-0.6B]"""
from repro_torch.configs.base import (
    GLOBAL_ATTN, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    block_pattern=(GLOBAL_ATTN,),
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
))

register_run("qwen3-0.6b", "train_4k",
             RunConfig(num_microbatches=2, remat_policy="full"))
