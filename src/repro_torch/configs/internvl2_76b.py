"""InternVL2-Llama3-76B: vision frontend stub (precomputed patch
embeddings) + Llama-3-70B-class dense LLM backbone. [arXiv:2404.16821]

The frontend has no parameters: a batch may carry ``frontend_embeds``
(B, frontend_tokens, d_model), which the model prepends to the text
embeddings (``models/model.py``)."""
from repro_torch.configs.base import (
    GLOBAL_ATTN, ModelConfig, RunConfig, register, register_run,
)

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    block_pattern=(GLOBAL_ATTN,),
    frontend="vision",
    frontend_tokens=256,          # 448px / patch14 pixel-unshuffle x4
    rope_theta=500_000.0,
))

# The reference's two runs.  train_4k: 16 microbatches, full remat, fp32
# master weights and moments, sequence-parallel residuals.  decode_32k sets
# only sharding overrides (weight-stationary decode).  The overrides are
# read by dist/sharding.py and have no meaning on one card.
register_run("internvl2-76b", "train_4k",
             RunConfig(num_microbatches=16, remat_policy="full",
                       sharding_overrides=(("resid_seq", ("model",)),)))
register_run("internvl2-76b", "decode_32k",
             RunConfig(sharding_overrides=(("batch", ()),
                                           ("embed_act", ("data",)))))
