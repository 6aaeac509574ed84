"""The model's parameters as ``nn.Module``s.

Leaf names and shapes follow the reference's abstract tree
(``repro/models/params.py``: dense GQA blocks, RWKV6 blocks, the RG-LRU
and local-attention blocks of the Griffin hybrid, MLA attention and the
MoE FFN): the reference's unrolled ``prefix`` (the first-k-dense layers),
its stacked ``groups`` and its ``tail`` become one :class:`Block` per
layer in a ``ModuleList``.  State-dict keys therefore read
``blocks.{i}.attn.q`` where the reference reads
``decoder/groups/0/attn/q[i]``.  An encoder-decoder's encoder stack is
``encoder_blocks.{i}`` (the reference's ``encoder/groups`` and
``encoder/tail``) and its decoder blocks also hold the cross-attention
leaves ``cross_norm`` and ``cross``.  Every leaf carries its reference
leaf's logical axes (``logical_axes``, without the stacks' ``layers``
dim), which ``dist/sharding.py`` maps to mesh axes.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Union

import torch
from torch import nn

from repro_torch.configs.base import (
    RECURRENT, RWKV, ModelConfig, check_ported,
)

Tree = Dict[str, Union[torch.Tensor, "Tree", List["Tree"]]]


def _leaf(shape, axes, device) -> nn.Parameter:
    """An fp32 leaf of ``shape`` carrying the logical axes of the
    reference's leaf (``logical_axes``, one name or None a dim), which
    ``dist/sharding.py`` maps to mesh axes."""
    assert len(shape) == len(axes), (shape, axes)
    p = nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                     requires_grad=False)
    p.logical_axes = tuple(axes)
    return p


def _norm(d: int, device) -> nn.Parameter:
    return _leaf((d,), ("embed",), device)


class Attention(nn.Module):
    """GQA projections, kept 3-D like the reference: q (D, H, hd),
    k/v (D, K, hd), o (H, hd, D); optional qkv biases and qk-norm gains."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.q = _leaf((D, H, hd), ("embed", "heads", "head_dim"), device)
        self.k = _leaf((D, K, hd), ("embed", "kv_heads", "head_dim"),
                       device)
        self.v = _leaf((D, K, hd), ("embed", "kv_heads", "head_dim"),
                       device)
        self.o = _leaf((H, hd, D), ("heads", "head_dim", "embed"), device)
        if cfg.qkv_bias:
            self.qb = _leaf((H, hd), ("heads", "head_dim"), device)
            self.kb = _leaf((K, hd), ("kv_heads", "head_dim"), device)
            self.vb = _leaf((K, hd), ("kv_heads", "head_dim"), device)
        if cfg.qk_norm:
            self.q_norm = _leaf((hd,), ("head_dim",), device)
            self.k_norm = _leaf((hd,), ("head_dim",), device)


class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention: the joint KV down-projection
    ``kv_a (D, lora + rd)`` (latent and the shared rope key), its norm
    ``kv_norm``, the up-projection ``kv_b (lora, H, nope + vd)`` and the
    output ``o (H, vd, D)``; queries through the low-rank ``q_a (D,
    q_lora)``, ``q_norm`` and ``q_b (q_lora, H, nope + rd)``, or one ``q
    (D, H, nope + rd)`` without a query rank."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, H = cfg.d_model, cfg.num_heads
        lora, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
        self.kv_a = _leaf((D, lora + rd), ("embed", "lora"), device)
        self.kv_norm = _leaf((lora,), ("lora",), device)
        self.kv_b = _leaf((lora, H, nope + vd),
                           ("lora", "heads", "head_dim"), device)
        self.o = _leaf((H, vd, D), ("heads", "head_dim", "embed"), device)
        if cfg.q_lora_rank:
            self.q_a = _leaf((D, cfg.q_lora_rank), ("embed", "lora"),
                             device)
            self.q_norm = _leaf((cfg.q_lora_rank,), ("lora",), device)
            self.q_b = _leaf((cfg.q_lora_rank, H, nope + rd),
                             ("lora", "heads", "head_dim"), device)
        else:
            self.q = _leaf((D, H, nope + rd), ("embed", "heads", "head_dim"),
                           device)


class DenseFFN(nn.Module):
    """SwiGLU weights: wg, wu (D, F) and wd (F, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.wg = _leaf((D, F), ("embed", "ffn"), device)
        self.wu = _leaf((D, F), ("embed", "ffn"), device)
        self.wd = _leaf((F, D), ("ffn", "embed"), device)


class MoEFFN(nn.Module):
    """Routed experts: ``router (D, E)``, SwiGLU expert weights ``we_g``,
    ``we_u (E, D, Fe)`` and ``we_d (E, Fe, D)``; the shared experts as one
    SwiGLU of width ``Fs = Fe · num_shared_experts``: ``ws_g``, ``ws_u
    (D, Fs)`` and ``ws_d (Fs, D)``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        self.router = _leaf((D, E), ("embed", "experts"), device)
        self.we_g = _leaf((E, D, Fe), ("experts", "embed", "expert_ffn"),
                          device)
        self.we_u = _leaf((E, D, Fe), ("experts", "embed", "expert_ffn"),
                          device)
        self.we_d = _leaf((E, Fe, D), ("experts", "expert_ffn", "embed"),
                          device)
        if cfg.num_shared_experts:
            Fs = Fe * cfg.num_shared_experts
            self.ws_g = _leaf((D, Fs), ("embed", "ffn"), device)
            self.ws_u = _leaf((D, Fs), ("embed", "ffn"), device)
            self.ws_d = _leaf((Fs, D), ("ffn", "embed"), device)


class TimeMix(nn.Module):
    """RWKV6 time-mix: the ddlerp token shift (``tm_mu`` holds the input's
    lerp and the five targets w, k, v, r, g; ``tm_A``/``tm_B`` its LoRA),
    r/k/v/g/o projections, the data-dependent decay (``w_base`` and the
    ``ww_A``/``ww_B`` LoRA), the per-head bonus ``u`` and the per-head
    GroupNorm gain ``ln_x``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, N = cfg.d_model, cfg.rwkv_head_dim
        rk, rw = cfg.rwkv_ddlerp_rank, cfg.rwkv_decay_rank
        self.tm_mu = _leaf((6, D), (None, "embed"), device)
        self.tm_A = _leaf((D, 5 * rk), ("embed", "lora"), device)
        self.tm_B = _leaf((5, rk, D), (None, "lora", "embed"), device)
        self.wr = _leaf((D, D), ("embed", "heads"), device)
        self.wk = _leaf((D, D), ("embed", "heads"), device)
        self.wv = _leaf((D, D), ("embed", "heads"), device)
        self.wg = _leaf((D, D), ("embed", "heads"), device)
        self.w_base = _leaf((D,), ("heads",), device)
        self.ww_A = _leaf((D, rw), ("embed", "lora"), device)
        self.ww_B = _leaf((rw, D), ("lora", "heads"), device)
        self.u = _leaf((D // N, N), ("heads", "head_dim"), device)
        self.ln_x = _leaf((D,), ("heads",), device)
        self.wo = _leaf((D, D), ("heads", "embed"), device)


class ChannelMix(nn.Module):
    """RWKV6 channel-mix: token-shift lerps, squared-ReLU key, sigmoid
    receptance."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.cm_mu_k = _leaf((D,), ("embed",), device)
        self.cm_mu_r = _leaf((D,), ("embed",), device)
        self.wk_c = _leaf((D, F), ("embed", "ffn"), device)
        self.wv_c = _leaf((F, D), ("ffn", "embed"), device)
        self.wr_c = _leaf((D, D), ("embed", None), device)


class RGLRU(nn.Module):
    """Griffin recurrent block: input and gate branches ``wx``, ``wy``
    (D, R), the depthwise causal conv ``conv_w`` (CW, R) and ``conv_b``
    (R,), the input and recurrence gates ``gate_i``, ``gate_r`` (R, R), the
    decay parameter ``rglru_lambda`` (R,) and the output ``wo`` (R, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, R, CW = cfg.d_model, cfg.rnn_width, cfg.conv1d_width
        self.wx = _leaf((D, R), ("embed", "rnn"), device)
        self.wy = _leaf((D, R), ("embed", "rnn"), device)
        self.conv_w = _leaf((CW, R), ("conv", "rnn"), device)
        self.conv_b = _leaf((R,), ("rnn",), device)
        self.gate_i = _leaf((R, R), (None, "rnn"), device)
        self.gate_r = _leaf((R, R), (None, "rnn"), device)
        self.rglru_lambda = _leaf((R,), ("rnn",), device)
        self.wo = _leaf((R, D), ("rnn", "embed"), device)


class Block(nn.Module):
    """One decoder layer of ``kind``: pre-norm temporal mixer (attention,
    GQA or MLA, global or local, or the RG-LRU block) + pre-norm FFN
    (dense, or MoE past the first ``first_k_dense`` layers of an MoE
    config), or (RWKV) pre-norm time-mix + pre-norm channel-mix.  Under
    ``use_post_block_norm`` (gemma2) the mixer's and the FFN's outputs
    also pass a norm, ``post_norm`` and ``post_ffn_norm``, before they
    join the residual (the reference's ``_post``).  With ``cross_attn`` (an
    encoder-decoder's decoder layer) a pre-norm cross-attention over the
    encoder's output follows the mixer: ``cross_norm``, ``cross`` (GQA
    projections) and, under ``use_post_block_norm``, ``post_cross_norm``."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None, *,
                 dense_ffn: bool = True, cross_attn: bool = False):
        super().__init__()
        D = cfg.d_model
        self.pre_norm = _norm(D, device)
        if kind == RWKV:
            self.tm = TimeMix(cfg, device)
            if cfg.use_post_block_norm:
                self.post_norm = _norm(D, device)
            self.cm_norm = _norm(D, device)
            self.cm = ChannelMix(cfg, device)
        else:
            if kind == RECURRENT:
                self.rec = RGLRU(cfg, device)
            elif cfg.use_mla:
                self.attn = MLA(cfg, device)
            else:
                self.attn = Attention(cfg, device)
            if cfg.use_post_block_norm:
                self.post_norm = _norm(D, device)
            if cross_attn:
                self.cross_norm = _norm(D, device)
                self.cross = Attention(cfg, device)
                if cfg.use_post_block_norm:
                    self.post_cross_norm = _norm(D, device)
            self.ffn_norm = _norm(D, device)
            if dense_ffn:
                self.ffn = DenseFFN(cfg, device)
            else:
                self.moe = MoEFFN(cfg, device)
        if cfg.use_post_block_norm:
            self.post_ffn_norm = _norm(D, device)


class Model(nn.Module):
    """Embedding table, ``num_layers`` blocks, final norm and (untied)
    LM head; an encoder-decoder also holds ``num_encoder_layers`` encoder
    blocks (dense, no cross leaves) and ``encoder_norm``, and its decoder
    blocks the cross-attention.  Holds the fp32 master weights;
    :func:`cast_params` makes the compute copy the forward pass reads."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        D, V = cfg.d_model, cfg.padded_vocab
        self.embed = _leaf((V, D), ("vocab", "embed"), device)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, device,
                  dense_ffn=not cfg.is_moe or i < cfg.first_k_dense,
                  cross_attn=cfg.is_encoder_decoder)
            for i, kind in enumerate(cfg.layer_kinds()))
        self.final_norm = _norm(D, device)
        if not cfg.tie_embeddings:
            self.lm_head = _leaf((D, V), ("embed", "vocab"), device)
        if cfg.is_encoder_decoder:
            self.encoder_blocks = nn.ModuleList(
                Block(cfg, kind, device)
                for kind in cfg.layer_kinds(cfg.num_encoder_layers))
            self.encoder_norm = _norm(D, device)


# ---------------------------------------------------------------------------
# Init: the reference's per-leaf recipes, drawn on the host from CPU
# generators, one a chunk of DRAW_CHUNK elements of a leaf, each seeded from
# the model seed, the leaf's name and the chunk's index, and copied to the
# leaf's device.  A seed therefore gives the same weights on every device
# (a CUDA generator draws other numbers), and the chunks are drawn in
# parallel threads with at most one chunk a thread on the host.  With
# ``draws="device"`` each chunk is drawn by a generator on the leaf's own
# device, seeded alike: the same recipes, numbers that depend on the device
# kind, and no host work (for a large model on a card, where the host's
# draws take most of a build).  The numbers differ from the
# reference's jax.random draws; tests that compare the two packages load
# converted reference weights instead.
# ---------------------------------------------------------------------------
DRAW_CHUNK = 1 << 22
DRAW_THREADS = min(8, os.cpu_count() or 1)

# The reference's explicit recipes; every other leaf is "fan_in" (norm
# gains "ones", biases "zeros").
_RECIPES = {
    "embed": "normal:0.02",
    "tm_mu": "uniform:0:1", "cm_mu_k": "uniform:0:1", "cm_mu_r": "uniform:0:1",
    "w_base": "uniform:-7:-5",
    "tm_A": "normal:0.02", "tm_B": "normal:0.02", "ww_A": "normal:0.02",
    "ww_B": "normal:0.02", "u": "normal:0.02",
    "ln_x": "ones",
    "conv_w": "normal:0.02", "conv_b": "zeros",
    "rglru_lambda": "rglru_lambda",
    "router": "normal:0.02",
}


def _recipe(name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _RECIPES:
        return _RECIPES[leaf]
    if leaf.endswith("norm"):
        return "ones"
    if leaf in ("qb", "kb", "vb"):
        return "zeros"
    return "fan_in"


def _stable_hash(s: str) -> int:
    h = 2166136261
    for c in s.encode():
        h = ((h ^ c) * 16777619) & 0x7FFFFFFF
    return h


@torch.no_grad()
def _draw_chunk(p: torch.Tensor, name: str, recipe: str, seed: int,
                i: int, on_device: bool = False) -> None:
    """Draw elements ``[i·DRAW_CHUNK, (i+1)·DRAW_CHUNK)`` of leaf ``p``
    (flattened) on the host, or ``on_device`` on its device, and write
    them into it."""
    dst = p.view(-1)[i * DRAW_CHUNK:(i + 1) * DRAW_CHUNK]
    home = dst.device if on_device else torch.device("cpu")
    out = dst if dst.device == home else torch.empty(dst.shape)
    gen = torch.Generator(device=home)
    gen.manual_seed(seed * 1_000_003 + _stable_hash(f"{name}#{i}"))
    kind, *args = recipe.split(":")
    if kind == "rglru_lambda":
        # Λ with σ(Λ) ~ U(0.9, 0.999), the Griffin decay range
        a = torch.empty_like(out).uniform_(0.9, 0.999, generator=gen)
        out.copy_(torch.log(a / (1.0 - a)))
    elif kind == "uniform":
        out.uniform_(float(args[0]), float(args[1]), generator=gen)
    else:
        std = float(args[0]) if kind == "normal" else \
            1.0 / math.sqrt(max(math.prod(p.shape[:-1]), 1))
        out.normal_(0.0, std, generator=gen)
    if out is not dst:
        dst.copy_(out)


@torch.no_grad()
def init_params(model: Model, seed: int, draws: str = "host") -> Model:
    """Initialise every leaf in place: drawn on the host, the same numbers
    on every device, or with ``draws="device"`` on the leaves' device."""
    if draws not in ("host", "device"):
        raise ValueError(f"draws must be 'host' or 'device', not {draws!r}")
    on_device = draws == "device"
    jobs = []
    for name, p in model.named_parameters():
        recipe = _recipe(name)
        if recipe == "ones":
            p.fill_(1.0)
        elif recipe == "zeros":
            p.zero_()
        else:
            jobs += [(p, name, recipe, seed, i, on_device)
                     for i in range(-(-p.numel() // DRAW_CHUNK))]
    with ThreadPoolExecutor(DRAW_THREADS) as pool:
        for f in [pool.submit(_draw_chunk, *j) for j in jobs]:
            f.result()
    return model


def abstract_params(cfg: ModelConfig) -> Dict[str, nn.Parameter]:
    """The model's leaves built on the meta device, by name: shapes,
    dtypes and logical axes (``logical_axes``) with nothing allocated (the
    reference's ``abstract_params``, its layer stacks unstacked)."""
    return dict(Model(cfg, device="meta").named_parameters())


def count_params(cfg: ModelConfig, include_embed: bool = False) -> int:
    """Parameter count from the module shapes (built on the meta device,
    nothing allocated).  ``include_embed=False`` leaves out the embedding
    and LM head, as the reference's 6ND convention does."""
    model = Model(cfg, device="meta")
    return sum(p.numel() for name, p in model.named_parameters()
               if include_embed or name not in ("embed", "lm_head"))


def _tree(model: nn.Module, cast) -> Tree:
    def tree(m: nn.Module):
        if isinstance(m, nn.ModuleList):
            return [tree(c) for c in m]
        out: Tree = {n: cast(p) for n, p in m.named_parameters(recurse=False)}
        out.update({n: tree(c) for n, c in m.named_children()})
        return out
    return tree(model)


def _compute_cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # a bf16 master matrix under fp32 compute goes up to fp32, as the
    # reference's products promote it
    return p.to(dtype) if p.ndim >= 2 and p.dtype != dtype else p


def cast_params(model: nn.Module, dtype: torch.dtype) -> Tree:
    """The compute copy of the weights as a nested tree (the reference's
    ``cast_params``): matrices (ndim >= 2) in ``dtype``, 1-D leaves (norm
    gains, biases) stay in theirs (fp32).  Detached: the serving engine makes it once,
    not per step."""
    return _tree(model, lambda p: _compute_cast(p.detach(), dtype))


def compute_params(model: nn.Module, dtype: torch.dtype) -> Tree:
    """The same cast for training, made inside the step and differentiable:
    gradients flow back to the master leaves (the reference casts inside
    its jitted forward, ``models/model.py:forward``)."""
    return _tree(model, lambda p: _compute_cast(p, dtype))


def make_trainable(model: Model, master_dtype: str = "float32") -> Model:
    """Master leaves for training: matrices stored in ``master_dtype``
    (fp32 unless the run says otherwise), every leaf requiring grad.  The
    reference's ``init_train_state`` casts every leaf of two or more
    dimensions of its tree, and its ``decoder/groups`` leaves are stacked
    over the layers, so there a layer's 1-D leaves (norm gains, biases)
    are cast too; the unstacked ones (the embedding's side, the first
    ``first_k_dense`` layers, the tail) stay fp32.  The port casts the
    same leaves (an encoder's ``encoder/groups`` are stacked the same
    way, from its first layer)."""
    dt = getattr(torch, master_dtype)
    cfg = model.cfg
    pat, first = len(cfg.block_pattern), cfg.first_k_dense
    spans = {"blocks": (first, first + (cfg.num_layers - first) // pat
                        * pat),
             "encoder_blocks": (0, cfg.num_encoder_layers // pat * pat)}
    for name, p in model.named_parameters():
        path = name.split(".")
        lo, hi = spans.get(path[0], (0, 0))
        stacked = lo <= int(path[1]) < hi if hi else False
        if dt != torch.float32 and (p.ndim >= 2 or stacked):
            p.data = p.data.to(dt)
        p.requires_grad_(True)
    return model
