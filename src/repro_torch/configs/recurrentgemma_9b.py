"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427]"""
from repro_torch.configs.base import (
    LOCAL_ATTN, RECURRENT, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,               # MQA on the local-attention layers
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=(RECURRENT, RECURRENT, LOCAL_ATTN),
    window_size=2048,
    rnn_width=4096,
    conv1d_width=4,
    act="gelu_tanh",
    embed_scale_by_sqrt_dim=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
))

# The reference's train_4k run: 2 microbatches, full remat, fp32 master
# weights and moments.  Its sharding override (the residual stream's
# sequence axis over "model") waits for the port of the mesh.
register_run("recurrentgemma-9b", "train_4k",
             RunConfig(num_microbatches=2, remat_policy="full"))
