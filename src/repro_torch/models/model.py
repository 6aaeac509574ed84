"""Model assembly: embedding → decoder blocks → logits, over the paged KV
cache (the reference's ``models/model.py``, serving modes).

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

from repro_torch.configs.base import ModelConfig, check_ported
from repro_torch.models.attention import gqa_attention
from repro_torch.models.layers import Ctx, dense_ffn, resolve_device, rms_norm
from repro_torch.models.params import (  # noqa: F401
    Model, Tree, cast_params, count_params, init_params,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    tree from :func:`cast_params`.  The cache's pools are updated in place.

    ``lengths`` makes prefill ragged: the (B, S0) token batch is padded to
    the round's longest prompt, row ``b``'s prompt is its first
    ``lengths[b]`` tokens, cache writes are masked per row (length-0 rows
    leave the cache untouched) and the logits are each row's last valid
    position.  ``starts`` makes it chunked: row ``b``'s tokens are the
    uncached tail of its prompt, opening at absolute position
    ``starts[b]``, and attention walks the page table."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r} comes in a later slice of the port")
    if lengths is not None and mode != "prefill":
        raise ValueError("lengths is a prefill-only argument")
    if starts is not None and lengths is None:
        raise ValueError("starts requires ragged prefill (lengths)")
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
    for i, blk in enumerate(params["blocks"]):
        layer_cache = None if cache is None else {
            "k_pages": cache["k_pages"][i], "v_pages": cache["v_pages"][i],
            "page_table": cache["page_table"]}
        x = rms_norm(h, blk["pre_norm"], cfg.norm_eps)
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
    """The paged KV cache (``cfg.cache_layout == "paged"``): per layer a K
    and a V pool ``(P, K, ps, hd)`` in ``cfg.dtype``, and ONE page table
    ``(B, pps)`` int32 that every layer reads (the reference broadcasts the
    same host table into each layer's leaf).  The table starts at -1 for
    the engine's host-side allocator (the reference's
    ``paged_tables="empty"``)."""
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
    shape = (pool, cfg.num_kv_heads, ps, cfg.head_dim)
    dt = DTYPES[cfg.dtype]
    return {
        "k_pages": [torch.zeros(shape, dtype=dt, device=dev)
                    for _ in range(cfg.num_layers)],
        "v_pages": [torch.zeros(shape, dtype=dt, device=dev)
                    for _ in range(cfg.num_layers)],
        "page_table": table,
    }
