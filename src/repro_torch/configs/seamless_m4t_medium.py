"""SeamlessM4T-medium: encoder-decoder, audio frontend STUB (precomputed
frame embeddings). [arXiv:2308.11596]

The frontend has no parameters: a batch carries ``src_embeds`` (B, Ssrc,
d_model), the frames the encoder stack reads (``models/model.py:
_encoder_out``); each decoder layer attends to the encoder's output
through its cross-attention."""
from repro_torch.configs.base import (
    GLOBAL_ATTN, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,                # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    block_pattern=(GLOBAL_ATTN,),
    is_encoder_decoder=True,
    num_encoder_layers=12,
    frontend="audio",
))

register_run("seamless-m4t-medium", "train_4k",
             RunConfig(num_microbatches=2, remat_policy="full"))
