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
# weights and moments.  Its sharding overrides (sequence-parallel
# residuals; the decode_32k run's weight-stationary decode, which sets
# nothing else) have no meaning on one card: they wait for the port of
# the mesh.
register_run("mistral-large-123b", "train_4k",
             RunConfig(num_microbatches=8, remat_policy="full"))
