"""Qwen2.5-32B: dense GQA with QKV bias. [hf:Qwen/Qwen2.5-32B]"""
from repro_torch.configs.base import (
    GLOBAL_ATTN, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152_064,
    block_pattern=(GLOBAL_ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
))

# The reference's train_4k run: 16 microbatches, full remat, fp32 master
# weights and moments, context-parallel attention and residuals (the
# sequence axes over "model"); its prefill_32k and decode_32k runs set only
# sharding overrides.  The overrides are read by dist/sharding.py and have
# no meaning on one card.
register_run("qwen2.5-32b", "train_4k",
             RunConfig(num_microbatches=16, remat_policy="full",
                       sharding_overrides=(("seq", ("model",)),
                                           ("resid_seq", ("model",)))))
register_run("qwen2.5-32b", "prefill_32k",
             RunConfig(sharding_overrides=(("seq", ("model",)),
                                           ("resid_seq", ("model",)))))
register_run("qwen2.5-32b", "decode_32k",
             RunConfig(sharding_overrides=(("batch", ()),
                                           ("embed_act", ("data",)))))
