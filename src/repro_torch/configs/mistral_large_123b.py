"""Mistral-Large-2407 (123B): dense GQA.
[hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.configs.base import (
    GLOBAL_ATTN, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32_768,
    block_pattern=(GLOBAL_ATTN,),
    rope_theta=1_000_000.0,
))

# The reference's train_4k run: 8 microbatches, full remat, fp32 master
# weights and moments, sequence-parallel residuals; its decode_32k run sets
# only a weight-stationary decode's overrides.  The overrides are read by
# dist/sharding.py and have no meaning on one card.
register_run("mistral-large-123b", "train_4k",
             RunConfig(num_microbatches=8, remat_policy="full",
                       sharding_overrides=(("resid_seq", ("model",)),)))
register_run("mistral-large-123b", "decode_32k",
             RunConfig(sharding_overrides=(("batch", ()),
                                           ("embed_act", ("data",)))))
