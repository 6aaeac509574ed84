"""Attention over the serving cache (the reference's
``models/attention.py``): GQA, and DeepSeek-V2's MLA over a paged or
dense latent cache (:func:`mla_attention`, at the end of this module).

Global layers keep their K/V in the paged pool, or (the dense layout,
lockstep serving) in a (B, K, S_max, hd) buffer with one shared (S_max,)
map of the position each slot holds; local (sliding-window) layers keep a
per-sequence ring of ``window`` slots with a (B, W) map.  Two modes:

* ``full`` (prefill) — self-attention over the prompt through
  ``ops.flash_attention_bshd`` (the Hopper kernel on the card, its plain
  version on the CPU; local layers pass their window), then the rotated
  K/V are written into the page pool, the dense buffer or the ring
  (:func:`_write_full_kv` for a lockstep batch).  A chunked prefill
  (prefix caching: per-row absolute positions) writes the chunk's K/V
  first and then walks the page table (:func:`prefill_attention_paged`,
  plain torch as in the reference).
* ``decode`` — one new token per sequence: its K/V go into the pool, then
  ``ops.paged_decode_bhd`` walks the page table; a local layer writes its
  ring slot, and a dense global layer its buffer's slot, and attends with
  :func:`decode_attention_torch` (plain, as the reference's dense and
  local decode is plain jnp).  ``pos`` is a scalar (a lockstep batch, every
  row at one position) or (B,) per-row positions (continuous batching,
  paged globals and rings only).

An encoder-decoder's decoder layers also attend to the encoder's output
(``is_cross``): in full mode q comes from the layer's input and K, V from
the encoder's frames, unrotated, through ``ops.flash_attention_bshd``
without a causal mask (Sk, the frames, apart from S); prefill also writes
the layer's cross K and V (B, K, Ssrc, hd) into its cache.  Decode reads
them back and attends with :func:`decode_attention_torch` over every
frame; its q is rotated by the decode position, as the reference's decode
rotates it before its cross branch (ROADMAP R8).  The encoder's own
self-attention is the full mode without the causal mask.

Keys are RoPE-rotated at write time, so cached keys never re-rotate.

The reference's cache is functional; here the page pools, dense buffers
and rings are updated IN PLACE by the writers (``index_put_``,
``index_copy_``), and the writers return the same tensors.  The
reference's ``mode="drop"`` scatters silently drop
rows aimed out of the pool; torch would raise (or fault on the card), so
the writers select the rows to write with a mask first.  Its
``mode="fill"`` gathers read zeros for a ``-1`` entry; torch indexing
with -1 reads the last page, so the gathers here mask instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_torch,
)
from repro_torch.models.layers import apply_rope, rms_norm, softcap

Cache = Dict[str, torch.Tensor]
NEG_INF = -2.0e38


def decode_attention_torch(
    q: torch.Tensor,          # (B, 1, H, hd)
    k: torch.Tensor,          # (B, K, Skv, hd) cache layout, rotated
    v: torch.Tensor,          # (B, K, Skv, vd)
    pos_k: torch.Tensor,      # (Skv,) or (B, Skv) positions; -1 = invalid
    pos_q: torch.Tensor,      # scalar or (B,)
    *,
    scale: float,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """One-token attention against a dense view of the cache, plain
    softmax (the reference's ``decode_attention_jnp``)."""
    B, _, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    vd = v.shape[-1]
    qg = q.reshape(B, K, G, hd).float() * scale
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float())
    s = softcap(s, logit_cap)
    pk = pos_k if pos_k.ndim == 2 else pos_k[None, :]
    pq = torch.as_tensor(pos_q, device=q.device).reshape(-1, 1)
    valid = (pk >= 0) & (pk <= pq)
    if window:
        valid = valid & (pq - pk < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return out.reshape(B, 1, H, vd).to(q.dtype)


def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """(B, K, pps·ps, d) view of each row's pages; ``-1`` entries read as
    zeros (the reference's fill-mode take), never as the last page."""
    B, pps = page_table.shape
    _, K, ps, d = pages.shape
    held = (page_table >= 0)[:, :, None, None, None]
    g = torch.where(held, pages[page_table.long().clamp(min=0)], 0)
    return g.permute(0, 2, 1, 3, 4).reshape(B, K, pps * ps, d)


def _table_positions(page_table: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, pps·ps) position of each gathered slot, -1 on unallocated
    pages."""
    T = page_table.shape[1] * ps
    alloc = (page_table >= 0).repeat_interleave(ps, dim=1)
    t = torch.arange(T, device=page_table.device)[None, :]
    return torch.where(alloc, t, -1)


def prefill_attention_paged(
    q: torch.Tensor,            # (B, S0, H, hd) chunk queries, rotated
    k_pages: torch.Tensor,      # (P, K, ps, hd)
    v_pages: torch.Tensor,      # (P, K, ps, vd)
    page_table: torch.Tensor,   # (B, pps); -1 = unallocated
    pos_q: torch.Tensor,        # (B, S0) absolute positions of the chunk
    lengths: torch.Tensor,      # (B,) valid chunk tokens; 0 = inactive row
    *,
    scale: float,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Chunked-prefill attention over the page table (prefix caching).
    The chunk's own K/V are already in the pool (write-then-read), so one
    masked walk covers the cached prefix and within-chunk causality: a
    key at slot ``t`` is live iff its page is allocated and
    ``t <= pos_q[b, s]``.  Rows with ``lengths == 0`` return zeros."""
    B, S0, H, hd = q.shape
    _, K, ps, _ = k_pages.shape
    G = H // K
    kb = _gather_pages(k_pages, page_table)
    vb = _gather_pages(v_pages, page_table)
    pos_k = _table_positions(page_table, ps)                      # (B, T)
    qg = q.reshape(B, S0, K, G, hd).float() * scale
    s = torch.einsum("bskgd,bktd->bskgt", qg, kb.float())
    s = softcap(s, logit_cap)
    rows = torch.arange(S0, device=q.device)[None, :, None] \
        < lengths.long()[:, None, None]
    valid = (pos_k[:, None, :] >= 0) \
        & (pos_k[:, None, :] <= pos_q.long()[:, :, None]) & rows  # (B,S0,T)
    vm = valid[:, :, None, None, :]
    s = torch.where(vm, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # mask p explicitly: fully-dead rows (inactive slots) would otherwise
    # see exp(NEG_INF - NEG_INF) == 1 (NEG_INF is a finite sentinel)
    p = torch.where(vm, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bskgt,bktd->bskgd", p, vb.float())
    out = out / l.clamp_min(1e-37)[..., None]
    return out.reshape(B, S0, H, vb.shape[-1]).to(q.dtype)


def decode_attention_paged(
    q: torch.Tensor,            # (B, 1, H, hd)
    k_pages: torch.Tensor,      # (P, K, ps, hd)
    v_pages: torch.Tensor,      # (P, K, ps, vd)
    page_table: torch.Tensor,   # (B, pps); -1 = unallocated
    pos_q: torch.Tensor,        # scalar or (B,)
    *,
    scale: float,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """The reference walk and the decode oracle: gather each row's pages
    into a dense view and run :func:`decode_attention_torch`."""
    kb = _gather_pages(k_pages, page_table)
    vb = _gather_pages(v_pages, page_table)
    pos_k = _table_positions(page_table, k_pages.shape[2])
    return decode_attention_torch(q, kb, vb, pos_k, pos_q, scale=scale,
                                  logit_cap=logit_cap)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------
def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.query_pre_attn_scalar > 0:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.head_dim ** -0.5


def gqa_attention(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # (B, S, D)
    *,
    kind: str = GLOBAL_ATTN,
    mode: str,                       # full | decode
    cache: Optional[Cache],
    pos: torch.Tensor,               # full: (S,) or (B, S0); decode: (B,)
    lengths: Optional[torch.Tensor] = None,
    causal: bool = True,
    enc_out: Optional[torch.Tensor] = None,   # full-mode cross: (B, Ssrc, D)
    is_cross: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Self-attention of one layer; returns (out (B, S, D), cache).
    ``cache`` is the layer's ``{"k_pages", "v_pages", "page_table"}``
    (global, paged), its dense buffer ``{"k", "v" (B, K, S_max, hd), "pos"
    (S_max,)}`` (global, dense) or its ring ``{"k", "v", "pos" (B, W)}``
    (local).  A dense global buffer is lockstep-only, as in the
    reference: a ragged prefill or per-row decode positions raise
    ``NotImplementedError``.  ``causal`` False
    is an encoder's self-attention (train mode, no cache).  With
    ``is_cross`` it is a decoder layer's cross-attention over the
    encoder's output ``enc_out`` (full mode) or over the layer's cached
    encoder K and V, ``cache`` ``{"k", "v"}`` (B, K, Ssrc, hd) (decode)."""
    scale = _attn_scale(cfg)
    cap = cfg.attn_logit_softcap
    window = cfg.window_size if kind == LOCAL_ATTN else 0

    q = torch.einsum("bsd,dhk->bshk", x, p["q"])
    if "qb" in p:
        q = q + p["qb"].to(q.dtype)
    if cfg.qk_norm:                  # before rope, as in the reference
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if is_cross:
        return _cross_attention(cfg, p, q, mode=mode, cache=cache, pos=pos,
                                enc_out=enc_out, scale=scale, cap=cap)
    k = torch.einsum("bsd,dhk->bshk", x, p["k"])
    v = torch.einsum("bsd,dhk->bshk", x, p["v"])
    if "qb" in p:
        k = k + p["kb"].to(k.dtype)
        v = v + p["vb"].to(v.dtype)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    new_cache = cache
    if mode == "full":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        if pos.ndim == 2:
            # chunked prefix prefill: write the chunk, then one masked walk
            # over the page table covers the cached prefix and the chunk
            if cache is None or "k_pages" not in cache or lengths is None \
                    or window:
                raise ValueError("chunked prefill needs the paged cache of "
                                 "a global layer and lengths")
            new_cache = _write_prefill_paged_offset(cache, k, v, lengths, pos)
            out = prefill_attention_paged(
                q, cache["k_pages"], cache["v_pages"], cache["page_table"],
                pos, lengths, scale=scale, logit_cap=cap)
        else:
            if cache is not None and lengths is not None and not window \
                    and "k_pages" not in cache:
                raise NotImplementedError(
                    "ragged prefill needs the paged layout for global "
                    "layers (dense caches are lockstep-only)")
            out = ops.flash_attention_bshd(
                q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
                causal=causal, window=window, logit_cap=cap)
            if cache is not None and "k_pages" in cache:
                new_cache = _write_prefill_paged(cache, k, v, lengths)
            elif cache is not None and lengths is not None:
                # a ring: each row keeps the last window of its own tokens
                new_cache = _write_prefill_ring_ragged(cache, k, v, lengths)
            elif cache is not None:      # lockstep: every row all S tokens
                new_cache = _write_full_kv(cache, k, v, pos, window)
    elif mode == "decode":
        pos_r = pos.reshape(-1, 1)       # (B, 1), or (1, 1) for a scalar
        q = apply_rope(q, pos_r, cfg.rope_theta)
        k = apply_rope(k, pos_r, cfg.rope_theta)
        if "k_pages" in cache:
            # a scalar position is every row's (the reference's broadcast)
            posb = pos.reshape(-1).to(torch.int32).expand(q.shape[0])
            new_cache = _update_decode_kv_paged(cache, k, v, posb)
            out = ops.paged_decode_bhd(
                q.contiguous(), cache["k_pages"], cache["v_pages"],
                cache["page_table"], posb.contiguous(), scale=scale,
                logit_cap=cap)
        else:
            new_cache, k_all, v_all, pos_all = _update_decode_kv(
                cache, k, v, pos, window)
            out = decode_attention_torch(
                q, k_all, v_all, pos_all, pos, scale=scale, window=window,
                logit_cap=cap)
    else:
        raise ValueError(mode)
    return torch.einsum("bshk,hkd->bsd", out, p["o"]), new_cache


def _cross_attention(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     q: torch.Tensor, *, mode: str, cache: Optional[Cache],
                     pos: torch.Tensor, enc_out: Optional[torch.Tensor],
                     scale: float, cap: float
                     ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """A decoder layer's cross-attention from its projected (and
    qk-normed) queries (the reference's ``gqa_attention`` with
    ``is_cross``).  Full mode: K and V from ``enc_out`` (biases, k-norm,
    no rope; q unrotated too), every frame live for every query through
    the flash kernel at Sk = Ssrc; prefill writes K and V into ``cache``
    ``{"k", "v"}`` (B, K, Ssrc, hd) in place.  Decode: q rotated by
    ``pos`` (the reference's decode rotates it before its cross branch;
    the cached K never is: ROADMAP R8), then plain one-token attention over
    every cached frame (the reference's ``pos_q = 2**30``)."""
    if mode == "full":
        if enc_out is None:
            raise ValueError("full-mode cross-attention needs enc_out")
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["k"])
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["v"])
        if "kb" in p:
            k = k + p["kb"].to(k.dtype)
            v = v + p["vb"].to(v.dtype)
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        out = ops.flash_attention_bshd(
            q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
            causal=False, logit_cap=cap)
        if cache is not None:
            cache["k"].copy_(k.transpose(1, 2))
            cache["v"].copy_(v.transpose(1, 2))
    elif mode == "decode":
        if cache is None:
            raise ValueError("cross-attention decode reads the cached "
                             "encoder K and V")
        q = apply_rope(q, pos.reshape(-1, 1), cfg.rope_theta)
        ck = cache["k"]
        pos_k = torch.arange(ck.shape[2], dtype=torch.int32,
                             device=ck.device)
        out = decode_attention_torch(q, ck, cache["v"], pos_k, 2 ** 30,
                                     scale=scale, logit_cap=cap)
    else:
        raise ValueError(mode)
    return torch.einsum("bshk,hkd->bsd", out, p["o"]), cache


# ---------------------------------------------------------------------------
# Writers of the dense global buffers and of the local layers' rings (in
# place)
# ---------------------------------------------------------------------------
def _write_full_kv(cache: Cache, k, v, pos, window: int) -> Cache:
    """Lockstep prefill of every row's S tokens at positions ``pos`` (S,)
    (consecutive, from ``pos[0]``).  A dense global buffer (B, K, S_max,
    hd) takes them at their positions and its shared ``pos (S_max,)`` map
    records them; a ring (``window``, W = window slots) keeps only the
    last ``window`` positions, at slot ``pos % window``, and its per-row
    ``pos (B, W)`` map records them.  ``k, v`` arrive as (B, S, K, hd),
    rotated.  Index copies, so no host sync."""
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    pos = pos.to(device=ck.device, dtype=torch.long)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # (B, K, S, hd)
    if window:
        # only the last window positions survive; slicing to them first
        # makes the slots unique
        kt, vt, pos = kt[:, :, -window:], vt[:, :, -window:], pos[-window:]
        slots = torch.remainder(pos, window)
        ck.index_copy_(2, slots, kt.to(ck.dtype))
        cv.index_copy_(2, slots, vt.to(cv.dtype))
        cp.index_copy_(1, slots, pos.to(cp.dtype)[None, :].expand(
            cp.shape[0], -1))
        return cache
    ck.index_copy_(2, pos, kt.to(ck.dtype))
    cv.index_copy_(2, pos, vt.to(cv.dtype))
    cp.index_copy_(0, pos, pos.to(cp.dtype))
    return cache


def _update_decode_kv(cache: Cache, k, v, pos, window: int):
    """Insert one token's K/V per row; returns ``(cache, k_all, v_all,
    pos_all)``, the buffers the decode attends over.  ``k, v`` arrive as
    (B, 1, K, hd).  A scalar ``pos`` (a lockstep batch) writes slot ``pos``
    of a dense global buffer and its shared map, or ring slot ``pos %
    window`` of every row; per-row ``pos`` (B,) is a ring's only
    (:func:`_update_decode_kv_ring`): a dense global buffer is
    lockstep-only, as in the reference."""
    if pos.ndim == 1:
        if not window:
            raise NotImplementedError(
                "per-sequence decode positions on a dense global cache; "
                "use cache_layout='paged' for continuous batching")
        cache = _update_decode_kv_ring(cache, k, v, pos)
        return cache, cache["k"], cache["v"], cache["pos"]
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    p = pos.to(device=ck.device, dtype=torch.long).reshape(1)
    slot = torch.remainder(p, window) if window else p
    ck.index_copy_(2, slot, k.transpose(1, 2).to(ck.dtype))
    cv.index_copy_(2, slot, v.transpose(1, 2).to(cv.dtype))
    if cp.ndim == 2:                     # a ring's per-row (B, W) map
        cp.index_copy_(1, slot, p.to(cp.dtype).expand(cp.shape[0], 1))
    else:                                # a global buffer's shared map
        cp.index_copy_(0, slot, p.to(cp.dtype))
    return cache, ck, cv, cp


def _write_prefill_ring_ragged(cache: Cache, k, v,
                               lengths: torch.Tensor) -> Cache:
    """Ragged prefill into the (B, K, W, hd) ring: row ``b`` keeps the last
    ``min(W, lengths[b])`` of its own tokens.  Ring slot ``s`` receives the
    largest position ``t < lengths[b]`` with ``t ≡ s (mod W)``; slots with
    no such token (short rows, length-0 rows) keep their contents and
    their ``pos`` entry.  ``k, v`` arrive as (B, S0, K, hd), rotated."""
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    B, S0 = k.shape[:2]
    W = ck.shape[2]
    s = torch.arange(W, device=k.device)
    lens = lengths.to(device=k.device, dtype=torch.long)[:, None]  # (B, 1)
    lm1 = lens - 1
    # floor mod (jnp's %): lm1 is -1 for length-0 rows
    t = lm1 - torch.remainder(lm1 - s[None, :], W)                 # (B, W)
    valid = (lens > 0) & (t >= 0) & (t >= lens - W)
    tc = t.clamp(0, S0 - 1)
    rows = torch.arange(B, device=k.device)[:, None]
    kg = k[rows, tc].transpose(1, 2)                               # (B,K,W,hd)
    vg = v[rows, tc].transpose(1, 2)
    vm = valid[:, None, :, None]
    ck.copy_(torch.where(vm, kg.to(ck.dtype), ck))
    cv.copy_(torch.where(vm, vg.to(cv.dtype), cv))
    cp.copy_(torch.where(valid, t.to(cp.dtype), cp))
    return cache


def _update_decode_kv_ring(cache: Cache, k, v, pos) -> Cache:
    """Insert one token's K/V per row into ring slot ``max(pos, 0) % W``
    and record ``pos`` there.  ``k, v`` arrive as (B, 1, K, hd).  An
    inactive row (``pos = -1``) writes its slot 0 and marks it invalid,
    as in the reference."""
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    B = k.shape[0]
    W = ck.shape[2]
    rows = torch.arange(B, device=k.device)
    posb = pos.to(device=k.device, dtype=torch.long)
    slot = torch.remainder(posb.clamp(min=0), W)
    ck[rows, :, slot] = k[:, 0].to(ck.dtype)
    cv[rows, :, slot] = v[:, 0].to(cv.dtype)
    cp[rows, slot] = posb.to(cp.dtype)
    return cache


# ---------------------------------------------------------------------------
# Paged cache writers (in place)
# ---------------------------------------------------------------------------
def _write_prefill_paged(cache: Cache, k, v,
                         lengths: Optional[torch.Tensor] = None) -> Cache:
    """Prefill from position 0: logical page ``i`` of row ``b`` receives
    tokens ``i·ps .. min((i+1)·ps, S0)`` when its entry is allocated and
    (ragged prefill) ``i·ps < lengths[b]``; length-0 rows write nothing.
    ``k, v`` arrive as (B, S0, K, hd), rotated."""
    kp, vp, pt = cache["k_pages"], cache["v_pages"], cache["page_table"]
    ps = kp.shape[2]
    B, S0 = k.shape[:2]
    n = -(-S0 // ps)
    lo = torch.arange(n, device=pt.device) * ps                    # (n,)
    write = pt[:, :n] >= 0                                         # (B, n)
    if lengths is not None:
        write = write & (lo[None, :] < lengths[:, None])
    rows, pages = write.nonzero(as_tuple=True)
    phys = pt[rows, pages].long()
    pad = n * ps - S0
    kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)) if pad else k
    vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) if pad else v
    # (B, n, K, ps, hd): page i of row b holds tokens i*ps .. (i+1)*ps-1
    kc = kc.reshape(B, n, ps, *k.shape[2:]).transpose(2, 3)
    vc = vc.reshape(B, n, ps, *v.shape[2:]).transpose(2, 3)
    full = ps - pad                  # slots of the last page that hold tokens
    last = pages == n - 1
    head = ~last if pad else torch.ones_like(last)
    kp[phys[head]] = kc[rows[head], pages[head]].to(kp.dtype)
    vp[phys[head]] = vc[rows[head], pages[head]].to(vp.dtype)
    if pad:
        kp[phys[last], :, :full] = kc[rows[last], n - 1, :, :full].to(kp.dtype)
        vp[phys[last], :, :full] = vc[rows[last], n - 1, :, :full].to(vp.dtype)
    return cache


def _write_prefill_paged_offset(cache: Cache, k, v, lengths, pos) -> Cache:
    """Chunked prefill: token ``s`` of row ``b`` lands at absolute
    position ``pos[b, s]`` (slot ``pos % ps`` of logical page
    ``pos // ps``).  Only tokens ``s < lengths[b]`` with an allocated
    entry write.  The engine's copy-on-write rule keeps every target page
    private, so the targets are unique."""
    kp, vp, pt = cache["k_pages"], cache["v_pages"], cache["page_table"]
    S0 = k.shape[1]
    ps = kp.shape[2]
    pps = pt.shape[1]
    pos = pos.long()
    pidx = pos // ps
    entry = pt.gather(1, pidx.clamp(0, pps - 1)).long()           # (B, S0)
    valid = (torch.arange(S0, device=pt.device)[None, :]
             < lengths.long()[:, None]) & (entry >= 0) & (pidx < pps)
    rows, toks = valid.nonzero(as_tuple=True)
    phys, off = entry[rows, toks], pos[rows, toks] % ps
    kp[phys, :, off] = k[rows, toks].to(kp.dtype)
    vp[phys, :, off] = v[rows, toks].to(vp.dtype)
    return cache


def _update_decode_kv_paged(cache: Cache, k, v, pos) -> Cache:
    """Insert one token's K/V per row at position ``pos[b]``.  ``k, v``
    arrive as (B, 1, K, hd).  Rows with ``pos < 0`` (inactive slots) and
    unallocated entries write nothing."""
    kp, vp, pt = cache["k_pages"], cache["v_pages"], cache["page_table"]
    ps = kp.shape[2]
    pps = pt.shape[1]
    posb = pos.long()
    posc = posb.clamp(min=0)
    pidx = posc // ps
    entry = pt.gather(1, pidx.clamp(max=pps - 1)[:, None])[:, 0].long()
    rows = ((posb >= 0) & (entry >= 0) & (pidx < pps)).nonzero()[:, 0]
    phys, off = entry[rows], posc[rows] % ps
    kp[phys, :, off] = k[rows, 0].to(kp.dtype)
    vp[phys, :, off] = v[rows, 0].to(vp.dtype)
    return cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2) over the paged latent cache
# ---------------------------------------------------------------------------
# The latent cache is MQA-shaped: ONE latent "kv head" of width lora + rd
# (the compressed latent ``ckv`` and the shared rotated rope key) serves
# all H query heads, once each query is absorbed through ``W_kc`` (the key
# half of ``kv_b``); the latent itself is the value, and ``W_vc`` (the
# value half) expands the latent context outside the walk.  Prefill walks
# score (B, S, H, T) in fp32; the port takes them a chunk of heads at a
# time (each head's softmax is independent), so the transient stays near
# MLA_SCORE_BUDGET elements instead of 4 GB per tensor at B 8, S 1,024,
# H 128.
MLA_SCORE_BUDGET = 1 << 26


def _head_chunks(H: int, per_head: int):
    """Slices of the H heads whose fp32 scores (``per_head`` elements a
    head) fit MLA_SCORE_BUDGET (at least one head a chunk)."""
    hc = max(1, min(H, MLA_SCORE_BUDGET // max(per_head, 1)))
    return [slice(h, min(h + hc, H)) for h in range(0, H, hc)]


def _gather_latent(pages: torch.Tensor, page_table: torch.Tensor
                   ) -> torch.Tensor:
    """(B, pps·ps, d) view of each row's pages of a latent pool (P, ps, d),
    the one-kv-head case of :func:`_gather_pages`."""
    return _gather_pages(pages[:, None], page_table)[:, 0]


def mla_prefill_attention_paged(
    q_eff: torch.Tensor,        # (B, S0, H, lora) W_kc-absorbed queries
    q_rope: torch.Tensor,       # (B, S0, H, rd) rotated rope queries
    ckv_pages: torch.Tensor,    # (P, ps, lora) shared latent pool
    krope_pages: torch.Tensor,  # (P, ps, rd)
    page_table: torch.Tensor,   # (B, pps); -1 = unallocated
    pos_q: torch.Tensor,        # (B, S0) absolute positions of the chunk
    lengths: torch.Tensor,      # (B,) valid chunk tokens; 0 = inactive row
    *,
    scale: float,
) -> torch.Tensor:
    """Chunked MLA prefill over the latent page table (prefix caching),
    plain as in the reference: the chunk's latents are already in the
    pool, so one masked walk covers the cached prefix and within-chunk
    causality.  Scores are ``(q_eff·ckv + q_rope·krope)·scale``; returns
    the latent context (B, S0, H, lora) in q_eff's dtype, zeros for rows
    with ``lengths == 0``.  Heads are independent, so a caller may pass
    any subset of them."""
    S0 = q_eff.shape[1]
    ps = ckv_pages.shape[1]
    cb = _gather_latent(ckv_pages, page_table).float()            # (B, T, l)
    rb = _gather_latent(krope_pages, page_table).float()          # (B, T, r)
    pos_k = _table_positions(page_table, ps)                      # (B, T)
    s = torch.einsum("bshl,btl->bsht", q_eff.float(), cb)
    s = s + torch.einsum("bshr,btr->bsht", q_rope.float(), rb)
    s = s * scale
    rows = torch.arange(S0, device=q_eff.device)[None, :, None] \
        < lengths.long()[:, None, None]
    valid = (pos_k[:, None, :] >= 0) \
        & (pos_k[:, None, :] <= pos_q.long()[:, :, None]) & rows  # (B,S0,T)
    vm = valid[:, :, None, :]
    s = torch.where(vm, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # explicit p-masking: fully-dead rows would see exp(NEG_INF - NEG_INF)
    p = torch.where(vm, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    ctx = torch.einsum("bsht,btl->bshl", p, cb)
    return (ctx / l.clamp_min(1e-37)[..., None]).to(q_eff.dtype)


def mla_decode_attention_paged(
    q_eff: torch.Tensor,        # (B, H, lora)
    q_rope: torch.Tensor,       # (B, H, rd)
    ckv_pages: torch.Tensor,    # (P, ps, lora)
    krope_pages: torch.Tensor,  # (P, ps, rd)
    page_table: torch.Tensor,   # (B, pps)
    pos_q: torch.Tensor,        # (B,)
    *,
    scale: float,
) -> torch.Tensor:
    """The reference's paged MLA decode walk (gather + dense softmax), the
    decode oracle: returns the latent context (B, H, lora); rows with
    ``pos_q < 0`` return zeros."""
    ps = ckv_pages.shape[1]
    cb = _gather_latent(ckv_pages, page_table).float()
    rb = _gather_latent(krope_pages, page_table).float()
    pos_k = _table_positions(page_table, ps)                      # (B, T)
    s = torch.einsum("bhl,btl->bht", q_eff.float(), cb)
    s = s + torch.einsum("bhr,btr->bht", q_rope.float(), rb)
    s = s * scale
    valid = (pos_k >= 0) & (pos_k <= pos_q.long()[:, None])       # (B, T)
    vm = valid[:, None, :]
    s = torch.where(vm, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vm, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    ctx = torch.einsum("bht,btl->bhl", p, cb)
    return (ctx / l.clamp_min(1e-37)[..., None]).to(q_eff.dtype)


def _mla_fresh_walk(q_eff, q_rope, ckv, krope, *, scale: float
                    ) -> torch.Tensor:
    """Prefill from position 0 against the chunk's own fresh latents
    (B, S, lora) and rope keys (B, S, rd), causal, fp32 softmax (the
    reference's lines for a 1-D ``pos``).  Causality keeps each row's last
    valid query off the ragged padding keys, which sit later.  Returns the
    latent context (B, S, h, lora) in fp32 for the heads of ``q_eff``."""
    S = q_eff.shape[1]
    ckv = ckv.float()
    s = torch.einsum("bshl,btl->bsht", q_eff.float(), ckv)
    s = s + torch.einsum("bshr,btr->bsht", q_rope.float(), krope.float())
    s = s * scale
    i = torch.arange(S, device=q_eff.device)
    causal = (i[:, None] >= i[None, :])[None, :, None, :]
    s = torch.where(causal, s, NEG_INF)
    return torch.einsum("bsht,btl->bshl", torch.softmax(s, dim=-1), ckv)


def _mla_q(cfg: ModelConfig, p, x, pos):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rd)), rope applied at
    ``pos``."""
    nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        qa = rms_norm(x @ p["q_a"], p["q_norm"], cfg.norm_eps)
        q = torch.einsum("bsl,lhk->bshk", qa, p["q_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["q"])
    return q[..., :nope], apply_rope(q[..., nope:], pos, cfg.rope_theta)


def mla_attention(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # (B, S, D)
    *,
    mode: str,                       # full | decode
    cache: Optional[Cache],
    pos: torch.Tensor,               # full: (S,) or (B, S0); decode: ()
    lengths: Optional[torch.Tensor] = None,   # or (B,)
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """MLA self-attention of one layer; returns (out (B, S, D), cache).

    Train mode (``mode="full"``, ``cache=None``, ``pos`` 1-D from position
    0) expands the latent into per-head keys and values, as the reference
    trains: q and k at nope + rd (the shared rope key broadcast over the
    heads), v at vd, through ``ops.flash_attention_bshd`` (causal, scale
    (nope + rd)^-1/2; the flash kernels at qk 192 / v 128 on the card,
    forward and backward).

    Serving runs over the paged latent cache ``{"ckv_pages",
    "krope_pages", "page_table"}`` or the dense one ``{"ckv" (B, S_max,
    lora), "krope" (B, S_max, rd), "pos" (S_max,)}``.  Paged: prefill
    writes the chunk's latents, then scores the fresh latents (``pos`` 1-D,
    from position 0) or walks the page table (``pos`` 2-D, chunked prefix
    prefill); decode writes the new latent and runs
    ``ops.mla_paged_decode_bhd`` (the Hopper kernel on the card, its plain
    version on the CPU).  Dense (a lockstep batch): prefill is train mode's
    expanded attention, the flash kernel at qk 192 / v 128 (forward only),
    and writes the latents; decode at a scalar position writes the new
    latent and scores every slot in latent space with the weight
    absorption (:func:`_mla_dense_decode`, plain as in the reference)."""
    B, S = x.shape[:2]
    H = cfg.num_heads
    nope, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    scale = (nope + rd) ** -0.5
    w_kc = p["kv_b"][..., :nope]                          # (lora, H, nope)
    w_vc = p["kv_b"][..., nope:]                          # (lora, H, vd)
    paged = cache is not None and "ckv_pages" in cache
    if mode == "decode" and cache is None:
        raise NotImplementedError("MLA decode without a cache: it reads "
                                  "the paged latent cache or the dense one")

    kv_a = x @ p["kv_a"]                                  # (B, S, lora+rd)
    ckv = rms_norm(kv_a[..., :lora], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., None, lora:]                       # (B, S, 1, rd)

    if mode == "full" and not paged:
        if cache is not None and (pos.ndim != 1 or lengths is not None):
            raise NotImplementedError(
                "ragged or chunked MLA prefill needs the paged latent cache "
                "(cache_layout='paged'); the dense cache is lockstep-only")
        q_nope, q_rope = _mla_q(cfg, p, x, pos)
        k_rope = apply_rope(k_rope, pos, cfg.rope_theta)
        kv = torch.einsum("bsl,lhe->bshe", ckv, p["kv_b"])  # expand
        k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rd)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.flash_attention_bshd(q, k, kv[..., nope:].contiguous(),
                                       scale=scale, causal=True)
        if cache is not None:
            _write_full_latent(cache, ckv, k_rope[:, :, 0], pos)
    elif mode == "full":
        pos_q = pos if pos.ndim == 2 else pos[None, :].expand(B, S)
        lens = torch.full((B,), S, dtype=torch.int32, device=x.device) \
            if lengths is None else lengths
        q_nope, q_rope = _mla_q(cfg, p, x, pos)
        k_rope = apply_rope(k_rope, pos, cfg.rope_theta)[:, :, 0]
        _write_prefill_latent_paged(cache, ckv, k_rope, lens, pos_q)
        T = cache["page_table"].shape[1] * cache["ckv_pages"].shape[1] \
            if pos.ndim == 2 else S
        out = torch.empty((B, S, H, vd), dtype=x.dtype, device=x.device)
        for hs in _head_chunks(H, B * S * T):
            q_eff = torch.einsum("bshe,lhe->bshl", q_nope[:, :, hs],
                                 w_kc[:, hs])
            if pos.ndim == 2:
                ctx_lat = mla_prefill_attention_paged(
                    q_eff, q_rope[:, :, hs], cache["ckv_pages"],
                    cache["krope_pages"], cache["page_table"], pos_q, lens,
                    scale=scale)
            else:
                ctx_lat = _mla_fresh_walk(q_eff, q_rope[:, :, hs], ckv,
                                          k_rope, scale=scale)
            out[:, :, hs] = torch.einsum("bshl,lhe->bshe",
                                         ctx_lat.to(x.dtype), w_vc[:, hs])
    elif mode == "decode" and paged:
        # a scalar position is every row's (the reference's broadcast)
        posb = pos.reshape(-1).to(torch.int32).expand(B).contiguous()
        pos_r = posb[:, None]                             # (B, 1) for rope
        q_nope, q_rope = _mla_q(cfg, p, x, pos_r)
        k_rope = apply_rope(k_rope, pos_r, cfg.rope_theta)
        _update_decode_latent_paged(cache, ckv[:, 0], k_rope[:, 0, 0], posb)
        q_eff = torch.einsum("bshe,lhe->bshl", q_nope, w_kc)  # (B,1,H,lora)
        q_lat = torch.cat([q_eff[:, 0], q_rope[:, 0]], dim=-1).contiguous()
        ctx_lat = ops.mla_paged_decode_bhd(
            q_lat, cache["ckv_pages"], cache["krope_pages"],
            cache["page_table"], posb, scale=scale)
        out = torch.einsum("bshl,lhe->bshe", ctx_lat[:, None].to(x.dtype),
                           w_vc)
    elif mode == "decode":
        out = _mla_dense_decode(cfg, p, x, ckv, k_rope, cache, pos,
                                w_kc=w_kc, w_vc=w_vc, scale=scale)
    else:
        raise ValueError(mode)
    return torch.einsum("bshe,hed->bsd", out, p["o"]), cache


def _mla_dense_decode(cfg: ModelConfig, p, x, ckv, k_rope, cache: Cache,
                      pos, *, w_kc, w_vc, scale: float) -> torch.Tensor:
    """The reference's dense MLA decode with weight absorption: the new
    token's latent and rotated rope key go into slot ``pos`` of the dense
    latent cache, then every row's query, absorbed through ``W_kc``,
    scores the latents in fp32 (``(cp >= 0) & (cp <= pos)`` live), and the
    softmax-weighted latent context is read out through ``W_vc``.
    Returns the per-head values (B, 1, H, vd).  ``pos`` is a scalar: the
    dense cache keeps one shared position map, so per-row positions raise
    as in the reference."""
    if pos.ndim != 0:
        raise NotImplementedError(
            "per-sequence MLA decode positions need the paged latent cache "
            "(cache_layout='paged'); the dense cache is lockstep-only")
    p1 = pos.to(device=x.device, dtype=torch.long).reshape(1)
    q_nope, q_rope = _mla_q(cfg, p, x, p1)
    k_rope = apply_rope(k_rope, p1, cfg.rope_theta)
    _write_full_latent(cache, ckv, k_rope[:, :, 0], p1)
    c, r, cp = cache["ckv"], cache["krope"], cache["pos"]
    q_eff = torch.einsum("bshe,lhe->bshl", q_nope, w_kc)  # absorb W_kc
    cf = c.float()
    s = torch.einsum("bshl,btl->bsht", q_eff.float(), cf)
    s = s + torch.einsum("bshr,btr->bsht", q_rope.float(), r.float())
    s = s * scale
    valid = (cp >= 0) & (cp <= p1)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    ctx_lat = torch.einsum("bsht,btl->bshl", torch.softmax(s, dim=-1), cf)
    return torch.einsum("bshl,lhe->bshe", ctx_lat.to(x.dtype), w_vc)


def _write_full_latent(cache: Cache, ckv, krope, pos) -> Cache:
    """Write a lockstep batch's latents ``ckv (B, S, lora)`` and rotated
    rope keys ``krope (B, S, rd)`` at positions ``pos`` (S,) of the dense
    latent cache, and record the positions in its shared ``pos`` map (the
    reference's ``dynamic_update_slice`` at ``pos[0]``; index copies, so
    no host sync)."""
    c, r, cp = cache["ckv"], cache["krope"], cache["pos"]
    pos = pos.to(device=c.device, dtype=torch.long)
    c.index_copy_(1, pos, ckv.to(c.dtype))
    r.index_copy_(1, pos, krope.to(r.dtype))
    cp.index_copy_(0, pos, pos.to(cp.dtype))
    return cache


def _write_prefill_latent_paged(cache: Cache, ckv, krope, lengths,
                                pos) -> Cache:
    """Scatter a prefill chunk's latents ``ckv (B, S0, lora)`` and rotated
    rope keys ``krope (B, S0, rd)`` into the latent pools: token ``s`` of
    row ``b`` lands at absolute position ``pos[b, s]`` (slot ``pos % ps``
    of logical page ``pos // ps``).  Only tokens ``s < lengths[b]`` with
    an allocated entry write; the reference drops the others with
    ``mode="drop"``, here they are masked before ``index_put_``."""
    cp, rp, pt = cache["ckv_pages"], cache["krope_pages"], cache["page_table"]
    S0 = ckv.shape[1]
    ps = cp.shape[1]
    pps = pt.shape[1]
    pos = pos.long()
    pidx = pos // ps
    entry = pt.gather(1, pidx.clamp(0, pps - 1)).long()           # (B, S0)
    valid = (torch.arange(S0, device=pt.device)[None, :]
             < lengths.long()[:, None]) & (entry >= 0) & (pidx < pps)
    rows, toks = valid.nonzero(as_tuple=True)
    phys, off = entry[rows, toks], pos[rows, toks] % ps
    cp[phys, off] = ckv[rows, toks].to(cp.dtype)
    rp[phys, off] = krope[rows, toks].to(rp.dtype)
    return cache


def _update_decode_latent_paged(cache: Cache, ckv, krope, pos) -> Cache:
    """Insert one token's latent ``ckv (B, lora)`` and rope key ``krope (B,
    rd)`` per row at position ``pos[b]``.  Rows with ``pos < 0`` (inactive
    slots) and unallocated entries write nothing."""
    cp, rp, pt = cache["ckv_pages"], cache["krope_pages"], cache["page_table"]
    ps = cp.shape[1]
    pps = pt.shape[1]
    posb = pos.long()
    posc = posb.clamp(min=0)
    pidx = posc // ps
    entry = pt.gather(1, pidx.clamp(max=pps - 1)[:, None])[:, 0].long()
    rows = ((posb >= 0) & (entry >= 0) & (pidx < pps)).nonzero()[:, 0]
    phys, off = entry[rows], posc[rows] % ps
    cp[phys, off] = ckv[rows].to(cp.dtype)
    rp[phys, off] = krope[rows].to(rp.dtype)
    return cache
