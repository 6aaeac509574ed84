"""The ~100M dense transformer the paper's Fig-2/3/4 benchmarks train
(the LM-substrate stand-in for the paper's ~100M-class vision models)."""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="paper-overhead-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=32_768,
    block_pattern=(GLOBAL_ATTN,),
))
