"""Model configuration of the port: its own copy of the reference's
``ModelConfig`` (fields, ``padded_vocab``, ``layer_kinds``, ``reduced``),
``ShapeConfig`` and ``RunConfig``, and the config and run registries.

The port serves and trains the dense all-global GQA decoders
(``paper-overhead-100m``, ``qwen3-0.6b``, ``qwen2.5-32b``,
``mistral-large-123b``), gemma2's mix of local and global attention with
its softcaps, ``query_pre_attn_scalar`` and post-block norms
(``gemma2-9b``), the attention-free RWKV6 stack (``rwkv6-7b``), the
RG-LRU + local-attention hybrid (``recurrentgemma-9b``) and the
all-global MLA and MoE stacks (``deepseek-v2-236b``,
``granite-moe-1b-a400m``), InternVL2's vision frontend stub (patch
embeddings prepended to the text) on a dense GQA stack
(``internvl2-76b``), and SeamlessM4T's encoder-decoder under its audio
frontend stub (encoder frames in, cross-attention in every decoder
layer; ``seamless-m4t-medium``): all eleven configs of the reference.
:func:`check_ported` rejects the combinations no config has (an
encoder-decoder on MoE, MLA or a hybrid stack; the audio frontend without
an encoder), each by name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

GLOBAL_ATTN = "global"      # full causal attention
LOCAL_ATTN = "local"        # sliding-window causal attention
RECURRENT = "recurrent"     # RG-LRU recurrent block
RWKV = "rwkv"               # RWKV6 time-mix block

BLOCK_KINDS = (GLOBAL_ATTN, LOCAL_ATTN, RECURRENT, RWKV)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for one model family instance."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    block_pattern: Tuple[str, ...] = (GLOBAL_ATTN,)
    window_size: int = 0

    qk_norm: bool = False
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_pre_attn_scalar: float = 0.0
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    moe_group_size: int = 1024

    rnn_width: int = 0
    conv1d_width: int = 4

    rwkv_head_dim: int = 64
    rwkv_ddlerp_rank: int = 32
    rwkv_decay_rank: int = 64

    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    frontend: str = "none"
    frontend_tokens: int = 0

    cache_layout: str = "dense"       # dense | paged
    page_size: int = 128              # tokens per KV page (paged layout)

    norm_eps: float = 1e-6
    act: str = "silu"                 # silu | gelu_tanh
    embed_scale_by_sqrt_dim: bool = False
    use_post_block_norm: bool = False
    pad_vocab_multiple: int = 128
    dtype: str = "bfloat16"           # compute dtype; also the KV-cache dtype
    param_dtype: str = "float32"      # storage dtype

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kinds(self, num_layers: Optional[int] = None) -> Tuple[str, ...]:
        """The per-layer block kinds, pattern tiled to ``num_layers``."""
        n = self.num_layers if num_layers is None else num_layers
        pat = self.block_pattern
        reps = (n + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[:n])

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's
        ``ModelConfig.reduced``, field for field)."""
        few_layers = max(len(self.block_pattern) + 1, 3)
        if self.first_k_dense:
            few_layers = max(few_layers, self.first_k_dense + 2)
        kv = min(self.num_kv_heads, 2) or 1
        heads = max(4, kv * 2)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=few_layers,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=503,
            window_size=min(self.window_size, 16) if self.window_size else 0,
            q_lora_rank=24 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_head_dim=16 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            num_experts=4 if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=32 if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            rnn_width=64 if self.rnn_width else 0,
            rwkv_ddlerp_rank=8,
            rwkv_decay_rank=8,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            frontend_tokens=min(self.frontend_tokens, 4),
            pad_vocab_multiple=32,
            page_size=8,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """A workload shape: sequence length, global batch, and whether it
    trains, prefills or decodes (the reference's ``ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


#: The reference's shapes: the train shape sizes the train runs, and a
#: platform dryrun cell names one of the four (``core/jobspec.py``).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def src_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """The encoder frames of an encoder-decoder's row of ``seq_len``
    decoder tokens (the reference's ``launch/specs.py:src_len_for``: the
    audio stub's frames, a quarter of the tokens and at least 16); 0 for a
    decoder-only config."""
    return max(seq_len // 4, 16) if cfg.is_encoder_decoder else 0


@dataclass(frozen=True)
class RunConfig:
    """The per-(arch, shape) training knobs the port reads (the fields of
    the reference's ``RunConfig`` that its train step and its placement
    rules use).  Microbatches and remat are a memory-fit decision;
    ``master_dtype`` and ``opt_dtype`` are the storage types of the weights
    (matrices) and of the AdamW moments; ``sharding_overrides`` remaps
    logical axes for the run (``dist/sharding.py:ShardingRules.override``;
    no meaning on one card); ``grad_compression``
    (``"none"``, ``"int8"`` or ``"topk"``) compresses the step's gradients
    with error feedback (``dist/compression.py``)."""

    num_microbatches: int = 1
    remat_policy: str = "none"       # none | dots | full
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    master_dtype: str = "float32"
    opt_dtype: str = "float32"
    # ((logical_axis, (mesh_axes, ...)), ...)
    sharding_overrides: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    grad_compression: str = "none"


#: The layer mixes the port serves: all-global attention (GQA or MLA, a
#: dense or MoE FFN), RWKV6, the Griffin hybrid of RG-LRU and
#: sliding-window (local) attention layers, and gemma2's mix of local and
#: global attention layers.
PORTED_KINDS = ({GLOBAL_ATTN}, {RWKV}, {RECURRENT, LOCAL_ATTN},
                {GLOBAL_ATTN, LOCAL_ATTN})


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config that needs a part of the
    model this port does not have yet.  The vision frontend (a stub with
    no parameters) is taken on an all-global dense GQA stack only, and so
    is an encoder-decoder, whose audio frontend stub is its encoder's
    input."""
    missing = []
    kinds = set(cfg.layer_kinds())
    if kinds not in PORTED_KINDS:
        missing.append(f"block kinds {sorted(kinds)}")
    if LOCAL_ATTN in kinds and not cfg.window_size:
        missing.append("local layers without a window")
    if cfg.window_size and LOCAL_ATTN not in kinds:
        missing.append("sliding-window attention on global layers")
    if cfg.use_mla and kinds != {GLOBAL_ATTN}:
        missing.append("MLA mixed with non-global layers")
    if cfg.is_moe and kinds != {GLOBAL_ATTN}:
        missing.append("MoE on a stack that is not all-global")
    if cfg.is_encoder_decoder:
        for where, bad in (("MoE", cfg.is_moe), ("MLA", cfg.use_mla),
                           ("a stack that is not all-global",
                            kinds != {GLOBAL_ATTN})):
            if bad:
                missing.append(f"an encoder-decoder on {where}")
    if cfg.frontend == "vision":
        for where, bad in (("MLA", cfg.use_mla), ("MoE", cfg.is_moe),
                           ("a stack that is not all-global",
                            kinds != {GLOBAL_ATTN})):
            if bad:
                missing.append(f"the vision frontend on {where}")
    elif cfg.frontend == "audio":
        if not cfg.is_encoder_decoder:
            missing.append("the audio frontend without an encoder")
    elif cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} comes in a later slice of "
            "the port")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose training this port
    does not have yet: it trains every stack it serves.  GQA stacks,
    all-global with a dense FFN or an MoE FFN under capacity dispatch with
    the router's load-balancing loss (``paper-overhead-100m``,
    ``qwen3-0.6b``, ``qwen2.5-32b``, ``mistral-large-123b``,
    ``granite-moe-1b-a400m``), or gemma2's local and global layers with
    both softcaps (the attention's through the flash backward at hd 256,
    the final one through autograd; ``gemma2-9b``); the MLA stack with its
    dense first layer and MoE layers with shared experts, attention
    through the flash kernels at qk 192 / v 128 (``deepseek-v2-236b``);
    the RWKV6 stack through the WKV6 backward (``rwkv6-7b``); and the
    RG-LRU hybrid: its recurrent layers through the RG-LRU scan's backward
    and its sliding-window MQA layers through the flash backward at hd 256
    (``recurrentgemma-9b``); and the dense GQA stack under the vision
    frontend stub, whose patch embeddings a batch may carry
    (``frontend_embeds``; ``internvl2-76b``); and the encoder-decoder
    under the audio frontend stub, whose batch carries the encoder's
    frames (``src_embeds``), the gradient reaching the encoder through
    every decoder layer's cross-attention (``seamless-m4t-medium``).  So
    it refuses what :func:`check_ported` refuses, each by name: a
    recurrent layer mixed with a global one, MLA or MoE on a mixed stack,
    an encoder-decoder on MoE, MLA or a hybrid stack, the audio frontend
    without an encoder, and the vision frontend on MLA, on MoE or on a
    stack that is not all-global."""
    check_ported(cfg)


_REGISTRY: Dict[str, ModelConfig] = {}
_RUN_OVERRIDES: Dict[Tuple[str, str], RunConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def register_run(arch: str, shape: str, run: RunConfig) -> None:
    _RUN_OVERRIDES[(arch, shape)] = run


def get_run_config(arch: str, shape: str) -> RunConfig:
    """The registered run of ``(arch, shape)``; training shapes default to
    full remat, as in the reference."""
    _ensure_loaded()
    if (arch, shape) in _RUN_OVERRIDES:
        return _RUN_OVERRIDES[(arch, shape)]
    if shape in SHAPES and SHAPES[shape].kind == "train":
        return RunConfig(remat_policy="full")
    return RunConfig()


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; the port has "
            f"{sorted(_REGISTRY)}") from None


def list_configs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded() -> None:
    """Import every config module (they self-register on import)."""
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_236b, gemma2_9b, granite_moe_1b_a400m, internvl2_76b,
        mistral_large_123b, paper_overhead, qwen2_5_32b, qwen3_0_6b,
        recurrentgemma_9b, rwkv6_7b, seamless_m4t_medium)
