"""Model assembly: embedding → decoder blocks → logits, over the serving
cache (the reference's ``models/model.py``, serving modes).  A block is
GQA attention + dense FFN, or RWKV6 time-mix + channel-mix.

Modes
-----
* ``prefill`` — tokens → last-position logits + a filled cache.  With
  ``lengths`` the prefill is ragged, with ``starts`` also chunked (prefix
  caching); see :func:`forward`.
* ``decode``  — one token per row + cache + per-row positions → next
  logits + the updated cache.

``train`` mode comes with the training slice of the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (
    GLOBAL_ATTN, RWKV, ModelConfig, check_ported,
)
from repro_torch.models.attention import gqa_attention
from repro_torch.models.layers import Ctx, dense_ffn, resolve_device, rms_norm
from repro_torch.models.rwkv import rwkv_channel_mix, rwkv_time_mix
from repro_torch.models.params import (  # noqa: F401
    Model, Tree, cast_params, count_params, init_params,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
RWKV_STATE = ("s", "shift_tm", "shift_cm")   # per-layer RWKV cache leaves


def build_model(cfg: ModelConfig, *, device=None, seed: int = 0) -> Model:
    """A model with the reference's leaf shapes, initialised from
    ``seed`` on ``device`` (``cuda`` unless the caller names one)."""
    check_ported(cfg)
    dev = resolve_device(device)
    return init_params(Model(cfg, device=dev), seed)


def _embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
           ctx: Ctx) -> torch.Tensor:
    return params["embed"][tokens].to(ctx.dtype)


def _unembed(cfg: ModelConfig, params: Tree, h: torch.Tensor) -> torch.Tensor:
    """Final norm, tied or untied head, fp32 logits; vocabulary-padding ids
    get -1e9."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ table.to(h.dtype)).float()
    pad = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
    return torch.where(pad, logits, -1e9)


def forward(
    cfg: ModelConfig,
    params: Tree,
    batch: Dict[str, torch.Tensor],
    ctx: Ctx,
    *,
    mode: str = "prefill",                 # prefill | decode
    cache: Optional[Dict] = None,
    pos: Optional[torch.Tensor] = None,    # decode: (B,) positions, -1 idle
    lengths: Optional[torch.Tensor] = None,  # ragged prefill: (B,) lengths
    starts: Optional[torch.Tensor] = None,   # chunked prefill: (B,) starts
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns ``(logits (B, 1, V), cache)``; ``params`` is the compute
    tree from :func:`cast_params`.  The cache is updated in place: the
    pools by the writers, the RWKV state lists by storing each layer's new
    entries.

    ``lengths`` makes prefill ragged: the (B, S0) token batch is padded to
    the round's longest prompt, row ``b``'s prompt is its first
    ``lengths[b]`` tokens, cache writes are masked per row (length-0 rows
    leave the cache untouched) and the logits are each row's last valid
    position.  RWKV carries are length-masked the same way: padding steps
    neither read nor write the state, and length-0 rows keep theirs.
    ``starts`` makes it chunked: row ``b``'s tokens are the uncached tail
    of its prompt, opening at absolute position ``starts[b]``, and
    attention walks the page table (all-global stacks only)."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r} comes in a later slice of the port")
    if lengths is not None and mode != "prefill":
        raise ValueError("lengths is a prefill-only argument")
    if starts is not None and lengths is None:
        raise ValueError("starts requires ragged prefill (lengths)")
    kinds = cfg.layer_kinds()
    if starts is not None and set(kinds) != {GLOBAL_ATTN}:
        raise NotImplementedError(
            "chunked prefix prefill needs an all-global paged decoder")
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    h = _embed(cfg, params, tokens, ctx)

    if mode == "decode":
        if pos is None or cache is None:
            raise ValueError("decode needs pos and a cache")
        p_arr = pos.to(device=dev, dtype=torch.int32)
    else:
        p_arr = torch.arange(S, dtype=torch.int32, device=dev)
        if starts is not None:
            p_arr = starts.to(dev, torch.int32)[:, None] + p_arr[None, :]
    if lengths is not None:
        lengths = lengths.to(dev, torch.int32)

    amode = "full" if mode == "prefill" else "decode"
    for i, (kind, blk) in enumerate(zip(kinds, params["blocks"])):
        x = rms_norm(h, blk["pre_norm"], cfg.norm_eps)
        if kind == RWKV:
            lc = None if cache is None else {
                name: cache[name][i] for name in RWKV_STATE}
            y, lc = rwkv_time_mix(cfg, blk["tm"], x, ctx, mode=amode,
                                  cache=lc, lengths=lengths)
            h = h + y
            x = rms_norm(h, blk["cm_norm"], cfg.norm_eps)
            y, lc = rwkv_channel_mix(cfg, blk["cm"], x, ctx, mode=amode,
                                     cache=lc, lengths=lengths)
            h = h + y
            if cache is not None:
                for name in RWKV_STATE:
                    cache[name][i] = lc[name]
            continue
        layer_cache = None if cache is None else {
            "k_pages": cache["k_pages"][i], "v_pages": cache["v_pages"][i],
            "page_table": cache["page_table"]}
        y, _ = gqa_attention(cfg, blk["attn"], x, mode=amode,
                             cache=layer_cache, pos=p_arr, lengths=lengths)
        h = h + y
        x = rms_norm(h, blk["ffn_norm"], cfg.norm_eps)
        h = h + dense_ffn(blk["ffn"], x, cfg.act)

    if lengths is not None:
        # each row's last valid position (length-0 rows: garbage, ignored)
        idx = (lengths.long().clamp(min=1) - 1)
        h = h[torch.arange(B, device=dev), idx][:, None]
    else:
        h = h[:, -1:]
    return _unembed(cfg, params, h), cache


def num_pages(seq_len: int, page_size: int) -> int:
    """Logical pages needed to hold ``seq_len`` tokens."""
    return -(-seq_len // page_size)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               page_budget: Optional[int] = None, device=None) -> Dict:
    """The serving cache (``cfg.cache_layout == "paged"``): ONE page table
    ``(B, pps)`` int32 that every layer reads (the reference broadcasts the
    same host table into each layer's leaf), starting at -1 for the
    engine's host-side allocator (the reference's ``paged_tables="empty"``),
    and per layer either a K and a V pool ``(P, K, ps, hd)`` in
    ``cfg.dtype`` (attention), or the RWKV state of the reference's
    ``_layer_cache_ab``: ``s (B, H, N, N)`` fp32 and the token-shift carries
    ``shift_tm``, ``shift_cm (B, D)`` in ``cfg.dtype``.  An RWKV stack has
    no pools; it keeps the table so the engine's page accounting is the
    same for every config."""
    check_ported(cfg)
    if cfg.cache_layout != "paged":
        raise NotImplementedError(
            f"the {cfg.cache_layout!r} cache layout comes in a later slice "
            "of the port")
    dev = resolve_device(device)
    ps = cfg.page_size
    pps = num_pages(max_len, ps)
    pool = page_budget if page_budget is not None else batch_size * pps
    table = torch.full((batch_size, pps), -1, dtype=torch.int32, device=dev)
    dt = DTYPES[cfg.dtype]
    L = cfg.num_layers

    def per_layer(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(L)]

    if set(cfg.layer_kinds()) == {RWKV}:
        N = cfg.rwkv_head_dim
        D = cfg.d_model
        return {
            "s": per_layer((batch_size, D // N, N, N), torch.float32),
            "shift_tm": per_layer((batch_size, D), dt),
            "shift_cm": per_layer((batch_size, D), dt),
            "page_table": table,
        }
    shape = (pool, cfg.num_kv_heads, ps, cfg.head_dim)
    return {
        "k_pages": per_layer(shape, dt),
        "v_pages": per_layer(shape, dt),
        "page_table": table,
    }
