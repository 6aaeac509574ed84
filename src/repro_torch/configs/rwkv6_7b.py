"""RWKV6-7B ("Finch"): attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import (
    RWKV, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                 # = d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65_536,
    block_pattern=(RWKV,),
    rwkv_head_dim=64,
    rwkv_ddlerp_rank=32,
    rwkv_decay_rank=64,
))

register_run("rwkv6-7b", "train_4k",
             RunConfig(num_microbatches=2, remat_policy="full",
                       sharding_overrides=(("resid_seq", ("model",)),)))
