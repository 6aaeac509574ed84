"""Model assembly: embedding → decoder blocks → logits (the reference's
``models/model.py``): training, and serving over the paged cache or the
dense one (lockstep batches, :func:`init_cache`).  A block is
GQA attention (global or sliding-window) or MLA + a dense or MoE FFN, the
RG-LRU block + dense FFN, or RWKV6 time-mix + channel-mix; under gemma2's
``use_post_block_norm`` each of the two outputs passes a norm of its own
before it joins the residual, and its logits pass the final softcap.  An
encoder-decoder (seamless-m4t-medium) first runs its encoder stack over
the batch's ``src_embeds`` (:func:`_encoder_out`), and each decoder block
adds a cross-attention over the encoder's output between its
self-attention and its FFN; decode reads the cross K and V its prefill
cached and runs no encoder.

Modes
-----
* ``train``   — tokens → fp32 logits for every position and the aux loss
  (the MoE layers' load-balancing losses summed in layer order, 0 for a
  dense stack), no cache; per-layer remat (:func:`_remat`); each layer
  by its kind, as in prefill.
  :func:`repro_torch.configs.base.check_trainable` says which configs
  train.
* ``prefill`` — tokens → last-position logits + a filled cache.  With
  ``lengths`` the prefill is ragged, with ``starts`` also chunked (prefix
  caching); see :func:`forward`.
* ``decode``  — one token per row + cache + positions → next logits + the
  updated cache: a scalar position for a lockstep batch (every row at one
  position; the dense cache takes only this), or per-row positions (B,)
  for continuous batching over the paged cache.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import (
    GLOBAL_ATTN, LOCAL_ATTN, RECURRENT, RWKV, ModelConfig, check_ported,
    check_trainable,
)
from repro_torch.models.attention import gqa_attention, mla_attention
from repro_torch.models.layers import (
    Ctx, dense_ffn, resolve_device, rms_norm, softcap,
)
from repro_torch.models.moe import check_row_length, moe_ffn
from repro_torch.models.recurrent import rglru_block
from repro_torch.models.rwkv import rwkv_channel_mix, rwkv_time_mix
from repro_torch.models.params import (  # noqa: F401
    Model, Tree, cast_params, compute_params, count_params, init_params,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LAYOUTS = ("dense", "paged")
# The per-layer cache leaves of each block kind under the paged layout.
# ``cache[name]`` lists one entry per layer of that kind, in layer order
# (in a hybrid stack a leaf exists only on the layers of its kind).  An
# MLA global layer pages its latent cache instead of K and V, and under
# the dense layout a global layer holds a whole-length buffer instead of
# pools (:func:`layer_leaves`).
LAYER_LEAVES = {
    GLOBAL_ATTN: ("k_pages", "v_pages"),
    LOCAL_ATTN: ("k", "v", "pos"),
    RECURRENT: ("h", "conv"),
    RWKV: ("s", "shift_tm", "shift_cm"),
}
MLA_LEAVES = ("ckv_pages", "krope_pages")
# The dense layout's global leaves: names of their own, so that a gemma2
# global layer never indexes the lists of the local rings (``k``, ``v``,
# ``pos``); the attention reads them by the reference's names
# (:data:`ATTN_NAMES`).
DENSE_LEAVES = ("k_dense", "v_dense", "pos_dense")
MLA_DENSE_LEAVES = ("ckv", "krope", "pos_dense")
ATTN_NAMES = {"k_dense": "k", "v_dense": "v", "pos_dense": "pos"}


def layer_leaves(cfg: ModelConfig, kind: str, layout: Optional[str] = None):
    """The cache leaves a layer of ``kind`` holds under ``cfg`` and
    ``layout`` (default ``cfg.cache_layout``)."""
    layout = cfg.cache_layout if layout is None else layout
    if kind == GLOBAL_ATTN and layout == "dense":
        return MLA_DENSE_LEAVES if cfg.use_mla else DENSE_LEAVES
    if cfg.use_mla and kind == GLOBAL_ATTN:
        return MLA_LEAVES
    return LAYER_LEAVES[kind]


def cache_layout_of(cache: Dict) -> str:
    """``"paged"`` for a cache with a page table, else ``"dense"``."""
    return "paged" if "page_table" in cache else "dense"


def build_model(cfg: ModelConfig, *, device=None, seed: int = 0,
                draws: str = "host") -> Model:
    """A model with the reference's leaf shapes, initialised from
    ``seed`` on ``device`` (``cuda`` unless the caller names one), its
    numbers drawn as :func:`init_params`'s ``draws`` says."""
    check_ported(cfg)
    dev = resolve_device(device)
    return init_params(Model(cfg, device=dev), seed, draws)


def _embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
           ctx: Ctx) -> torch.Tensor:
    h = params["embed"][tokens].to(ctx.dtype)
    if cfg.embed_scale_by_sqrt_dim:
        # the scale is rounded to the compute dtype before it multiplies,
        # as in the reference (√d is not a power of two at every width)
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=ctx.dtype,
                             device=h.device)
    return h


def _prepend_frontend(cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                      h: torch.Tensor, ctx: Ctx) -> Tuple[torch.Tensor, int]:
    """The vision frontend stub: a vision config's batch may carry
    ``frontend_embeds`` (B, F, D), precomputed patch embeddings, which are
    cast to the compute dtype and prepended to the text embeddings, as in
    the reference's ``forward``.  ``(h, F)``; F is 0 without them."""
    if cfg.frontend != "vision" or "frontend_embeds" not in batch:
        return h, 0
    fe = batch["frontend_embeds"].to(device=h.device, dtype=ctx.dtype)
    return torch.cat([fe, h], dim=1), fe.shape[1]


def _unembed(cfg: ModelConfig, params: Tree, h: torch.Tensor) -> torch.Tensor:
    """Final norm, tied or untied head, fp32 logits, the final-logit
    softcap (gemma2; before the padding mask, as in the reference);
    vocabulary-padding ids get -1e9."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = softcap((h @ table.to(h.dtype)).float(), cfg.final_logit_softcap)
    pad = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
    return torch.where(pad, logits, -1e9)


# The matrix products whose outputs ``remat_policy="dots"`` keeps (the
# counterpart of jax's ``checkpoint_dots_with_no_batch_dims``: the weight
# products, the experts' batched ones and the MoE combine included; the
# attention's and WKV6's own products run inside their Functions).
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """A layer's function under the reference's remat policies: ``none``
    keeps every activation, ``full`` keeps only the layer's input and runs
    its forward again in the backward (so the flash, WKV6 or RG-LRU
    forward launches twice a layer), ``dots`` keeps the matrix products' outputs and recomputes
    the rest."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat_policy {policy!r}: none, dots or full")


def _post(cfg: ModelConfig, blk: Tree, name: str,
          y: torch.Tensor) -> torch.Tensor:
    """A mixer's or FFN's output through its post-block norm ``name``
    where the layer has one (gemma2), as it joins the residual (the
    reference's ``_post``)."""
    return rms_norm(y, blk[name], cfg.norm_eps) if name in blk else y


def _attend(cfg: ModelConfig, blk: Tree, h: torch.Tensor,
            pos: torch.Tensor, kind: str = GLOBAL_ATTN,
            causal: bool = True) -> torch.Tensor:
    """The residual stream after a layer's attention, no cache (train
    mode): global GQA or MLA, or (``kind`` LOCAL_ATTN) GQA over the
    config's sliding window; ``causal`` False for an encoder's layer."""
    x = rms_norm(h, blk["pre_norm"], cfg.norm_eps)
    if cfg.use_mla:
        y, _ = mla_attention(cfg, blk["attn"], x, mode="full", cache=None,
                             pos=pos)
    else:
        y, _ = gqa_attention(cfg, blk["attn"], x, kind=kind, mode="full",
                             cache=None, pos=pos, causal=causal)
    return h + _post(cfg, blk, "post_norm", y)


def _cross(cfg: ModelConfig, blk: Tree, h: torch.Tensor, *, mode: str,
           cache: Optional[Dict], pos: torch.Tensor,
           enc_out: Optional[torch.Tensor]) -> torch.Tensor:
    """The residual stream after a decoder layer's cross-attention (the
    reference's ``apply_block`` between the mixer and the FFN): over
    ``enc_out`` in full mode, over ``cache`` (the layer's cross K and V)
    in decode."""
    x = rms_norm(h, blk["cross_norm"], cfg.norm_eps)
    y, _ = gqa_attention(cfg, blk["cross"], x, mode=mode, cache=cache,
                         pos=pos, enc_out=enc_out, is_cross=True)
    return h + _post(cfg, blk, "post_cross_norm", y)


def _dense_layer(cfg: ModelConfig, blk: Tree, h: torch.Tensor,
                 pos: torch.Tensor, enc_out: Optional[torch.Tensor] = None,
                 kind: str = GLOBAL_ATTN, causal: bool = True
                 ) -> torch.Tensor:
    """One attention layer (GQA or MLA, global or local) with a dense FFN,
    no cache (train mode); a decoder layer of an encoder-decoder also
    attends to ``enc_out``, an input of the layer, so that remat's
    backward carries its gradient to the encoder."""
    h = _attend(cfg, blk, h, pos, kind, causal)
    if "cross" in blk:
        h = _cross(cfg, blk, h, mode="full", cache=None, pos=pos,
                   enc_out=enc_out)
    x = rms_norm(h, blk["ffn_norm"], cfg.norm_eps)
    return h + _post(cfg, blk, "post_ffn_norm",
                     dense_ffn(blk["ffn"], x, cfg.act))


def _moe_layer(cfg: ModelConfig, blk: Tree, h: torch.Tensor,
               pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One all-global layer (GQA or MLA) with an MoE FFN under capacity
    dispatch, shared experts included (train mode): ``(h, aux)``, ``aux``
    the layer's load-balancing loss."""
    h = _attend(cfg, blk, h, pos)
    x = rms_norm(h, blk["ffn_norm"], cfg.norm_eps)
    y, aux = moe_ffn(cfg, blk["moe"], x, mode="train")
    return h + _post(cfg, blk, "post_ffn_norm", y), aux


def _recurrent_layer(cfg: ModelConfig, ctx: Ctx, blk: Tree,
                     h: torch.Tensor) -> torch.Tensor:
    """One RG-LRU layer, no cache (train mode): the recurrent block and
    the dense FFN, each after its norm and added to the residual, as in
    prefill."""
    x = rms_norm(h, blk["pre_norm"], cfg.norm_eps)
    y, _ = rglru_block(cfg, blk["rec"], x, ctx, mode="full", cache=None)
    h = h + _post(cfg, blk, "post_norm", y)
    x = rms_norm(h, blk["ffn_norm"], cfg.norm_eps)
    return h + _post(cfg, blk, "post_ffn_norm",
                     dense_ffn(blk["ffn"], x, cfg.act))


def _rwkv_layer(cfg: ModelConfig, ctx: Ctx, blk: Tree,
                h: torch.Tensor) -> torch.Tensor:
    """One RWKV6 layer, no cache (train mode): time mix and channel mix,
    each after its norm and added to the residual, as in prefill."""
    x = rms_norm(h, blk["pre_norm"], cfg.norm_eps)
    y, _ = rwkv_time_mix(cfg, blk["tm"], x, ctx, mode="full", cache=None)
    h = h + _post(cfg, blk, "post_norm", y)
    x = rms_norm(h, blk["cm_norm"], cfg.norm_eps)
    y, _ = rwkv_channel_mix(cfg, blk["cm"], x, ctx, mode="full", cache=None)
    return h + _post(cfg, blk, "post_ffn_norm", y)


def _encoder_out(cfg: ModelConfig, params: Tree,
                 src_embeds: Optional[torch.Tensor], ctx: Ctx,
                 remat_policy: str = "none") -> torch.Tensor:
    """The encoder stack over the audio frontend stub's frames (the
    reference's ``_encoder_out``): ``src_embeds`` (B, Ssrc, D) cast to the
    compute dtype, positions ``0..Ssrc-1``, every layer without the causal
    mask under ``remat_policy``, then ``encoder_norm``."""
    if src_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its batch "
                         "carries src_embeds (B, Ssrc, d_model)")
    h = src_embeds.to(device=ctx.device, dtype=ctx.dtype)
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    for blk in params["encoder_blocks"]:
        h = _remat(functools.partial(_dense_layer, cfg, blk, causal=False),
                   remat_policy)(h, pos)
    return rms_norm(h, params["encoder_norm"], cfg.norm_eps)


def forward_train(cfg: ModelConfig, params: Tree,
                  batch: Dict[str, torch.Tensor], ctx: Ctx, *,
                  remat_policy: str = "none"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits (B, S, V) fp32, aux)`` for every text position;
    ``params`` is the differentiable compute tree (:func:`compute_params`).
    Vocabulary padding ids get -1e9, as in the reference's ``_unembed``.
    ``aux`` is the fp32 sum of the MoE layers' load-balancing losses in
    layer order (the reference's ``run_stack``); a layer's forward that
    remat runs again in the backward adds nothing to it.  A vision
    config's ``frontend_embeds`` (B, F, D) go before the text
    (:func:`_prepend_frontend`): positions run over all F + S rows, and
    the F frontend rows are dropped before the head, so the logits match
    the (B, S) labels.  An encoder-decoder's batch carries ``src_embeds``
    (B, Ssrc, D): the encoder runs first (:func:`_encoder_out`, under the
    same remat policy) and every decoder layer attends to its output."""
    check_trainable(cfg)
    tokens = batch["tokens"]
    if cfg.is_moe:
        check_row_length(cfg, tokens.shape[1])
    enc_out = _encoder_out(cfg, params, batch.get("src_embeds"), ctx,
                           remat_policy) if cfg.is_encoder_decoder else None
    h, n_front = _prepend_frontend(cfg, batch,
                                   _embed(cfg, params, tokens, ctx), ctx)
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for kind, blk in zip(cfg.layer_kinds(), params["blocks"]):
        if kind == RWKV:
            h = _remat(functools.partial(_rwkv_layer, cfg, ctx, blk),
                       remat_policy)(h)
        elif kind == RECURRENT:
            h = _remat(functools.partial(_recurrent_layer, cfg, ctx, blk),
                       remat_policy)(h)
        elif "moe" in blk:
            layer = _remat(functools.partial(_moe_layer, cfg, blk),
                           remat_policy)
            h, a = layer(h, pos)
            aux = aux + a
        else:
            layer = _remat(functools.partial(_dense_layer, cfg, blk,
                                             kind=kind), remat_policy)
            h = layer(h, pos, enc_out)
    return _unembed(cfg, params, h[:, n_front:]), aux


def forward(
    cfg: ModelConfig,
    params: Tree,
    batch: Dict[str, torch.Tensor],
    ctx: Ctx,
    *,
    mode: str = "prefill",                 # train | prefill | decode
    cache: Optional[Dict] = None,
    pos: Optional[torch.Tensor] = None,    # decode: () or (B,), -1 idle
    lengths: Optional[torch.Tensor] = None,  # ragged prefill: (B,) lengths
    starts: Optional[torch.Tensor] = None,   # chunked prefill: (B,) starts
    remat_policy: str = "none",              # train: none | dots | full
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns ``(logits (B, 1, V), cache)``; ``params`` is the compute
    tree from :func:`cast_params`.  ``mode="train"`` returns ``(logits
    (B, S, V), aux)`` instead (:func:`forward_train`).  The cache is updated in place: the
    page pools and local rings by the writers, the recurrent state lists
    (RWKV, RG-LRU) by storing each layer's new entries.

    ``lengths`` makes prefill ragged: the (B, S0) token batch is padded to
    the round's longest prompt, row ``b``'s prompt is its first
    ``lengths[b]`` tokens, cache writes are masked per row (length-0 rows
    leave the cache untouched) and the logits are each row's last valid
    position.  RWKV and RG-LRU carries are length-masked the same way:
    padding steps neither read nor write the state, and length-0 rows
    keep theirs; a local ring keeps each row's last ``window`` tokens.
    ``starts`` makes it chunked: row ``b``'s tokens are the uncached tail
    of its prompt, opening at absolute position ``starts[b]``, and
    attention walks the page table (all-global stacks without a frontend
    only).

    ``pos`` is decode's position: a scalar (0-d) for a lockstep batch,
    every row at one position (the reference's form; the dense cache takes
    only this), or (B,) per-row positions, -1 for an idle row (the
    engine's form over the paged cache).  The layout is read from the
    cache: a page table makes it paged (:func:`cache_layout_of`).  A dense
    cache is lockstep-only, as in the reference: a ragged or chunked
    prefill into a dense global buffer or latent cache raises.

    A vision config's batch may carry ``frontend_embeds`` (B, F, D): they
    are prepended to the text (:func:`_prepend_frontend`), positions run
    over all F + S0 rows, a ragged row's length counts them (a length-0
    row stays untouched) and the paged writers put their K/V in the row's
    first pages, so the cache must hold F + P + G tokens a row.

    An encoder-decoder's prefill batch carries ``src_embeds`` (B, Ssrc,
    D): the encoder runs (:func:`_encoder_out`) and each decoder layer's
    cross-attention writes its K and V into the cache's ``cross_k``,
    ``cross_v`` (B, K, Ssrc, hd) entries; decode runs no encoder and reads
    them.  Its prefill takes neither ``lengths`` nor ``starts``, as in the
    reference: a batched prefill would overwrite the cross K and V of rows
    not in the round, so the engine prefills such a stack a slot at a
    time."""
    if mode == "train":
        if cache is not None or lengths is not None or starts is not None:
            raise ValueError("train mode takes no cache, lengths or starts")
        return forward_train(cfg, params, batch, ctx,
                             remat_policy=remat_policy)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: train, prefill or decode")
    if lengths is not None and mode != "prefill":
        raise ValueError("lengths is a prefill-only argument")
    if starts is not None and lengths is None:
        raise ValueError("starts requires ragged prefill (lengths)")
    if lengths is not None and cfg.use_mla and cache is not None \
            and cache_layout_of(cache) == "dense":
        raise NotImplementedError(
            "ragged prefill over MLA needs the paged latent cache (the dense "
            "MLA cache keeps a lockstep shared position slot)")
    if lengths is not None and cfg.is_encoder_decoder:
        raise NotImplementedError(
            "ragged prefill needs a decoder-only stack: the cross-attention "
            "K/V of rows not in this round would be overwritten by the new "
            "encoder output")
    kinds = cfg.layer_kinds()
    if starts is not None and (set(kinds) != {GLOBAL_ATTN}
                               or cfg.frontend == "vision"):
        raise NotImplementedError(
            "chunked prefix prefill needs an all-global paged decoder "
            "without a frontend")
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = tokens.device
    # decode reuses the cross K/V its prefill cached: no encoder run
    enc_out = _encoder_out(cfg, params, batch.get("src_embeds"), ctx) \
        if cfg.is_encoder_decoder and mode == "prefill" else None
    h, n_front = _prepend_frontend(cfg, batch,
                                   _embed(cfg, params, tokens, ctx), ctx)

    if mode == "decode":
        if pos is None or cache is None:
            raise ValueError("decode needs pos and a cache")
        p_arr = pos.to(device=dev, dtype=torch.int32)
    else:
        p_arr = torch.arange(h.shape[1], dtype=torch.int32, device=dev)
        if starts is not None:
            p_arr = starts.to(dev, torch.int32)[:, None] + p_arr[None, :]
    if lengths is not None:
        lengths = lengths.to(dev, torch.int32)
        if n_front:
            # the frontend rows are each row's first content: a ragged
            # length counts them, and a length-0 row stays untouched
            lengths = torch.where(lengths > 0, lengths + n_front, 0)

    amode = "full" if mode == "prefill" else "decode"
    layout = None if cache is None else cache_layout_of(cache)
    seen = {kind: 0 for kind in LAYER_LEAVES}
    for i, (kind, blk) in enumerate(zip(kinds, params["blocks"])):
        j = seen[kind]               # this layer's entry in its kind's lists
        seen[kind] += 1
        leaves = layer_leaves(cfg, kind, layout)
        lc = None if cache is None else {
            ATTN_NAMES.get(name, name): cache[name][j] for name in leaves}
        x = rms_norm(h, blk["pre_norm"], cfg.norm_eps)
        if kind == RWKV:
            y, lc = rwkv_time_mix(cfg, blk["tm"], x, ctx, mode=amode,
                                  cache=lc, lengths=lengths)
            h = h + _post(cfg, blk, "post_norm", y)
            x = rms_norm(h, blk["cm_norm"], cfg.norm_eps)
            y, lc = rwkv_channel_mix(cfg, blk["cm"], x, ctx, mode=amode,
                                     cache=lc, lengths=lengths)
        elif kind == RECURRENT:
            y, lc = rglru_block(cfg, blk["rec"], x, ctx, mode=amode,
                                cache=lc, lengths=lengths)
        else:
            if layout == "paged" and kind == GLOBAL_ATTN:
                lc["page_table"] = cache["page_table"]
            if cfg.use_mla:
                y, lc = mla_attention(cfg, blk["attn"], x, mode=amode,
                                      cache=lc, pos=p_arr, lengths=lengths)
            else:
                y, lc = gqa_attention(cfg, blk["attn"], x, kind=kind,
                                      mode=amode, cache=lc, pos=p_arr,
                                      lengths=lengths)
        if kind == RWKV:                 # y is the channel mix
            h = h + _post(cfg, blk, "post_ffn_norm", y)
        else:
            h = h + _post(cfg, blk, "post_norm", y)
            if "cross" in blk:
                cc = None if cache is None else {
                    "k": cache["cross_k"][i], "v": cache["cross_v"][i]}
                h = _cross(cfg, blk, h, mode=amode, cache=cc, pos=p_arr,
                           enc_out=enc_out)
            x = rms_norm(h, blk["ffn_norm"], cfg.norm_eps)
            y = moe_ffn(cfg, blk["moe"], x) if "moe" in blk \
                else dense_ffn(blk["ffn"], x, cfg.act)
            h = h + _post(cfg, blk, "post_ffn_norm", y)
        if cache is not None:
            for name in leaves:
                cache[name][j] = lc[ATTN_NAMES.get(name, name)]

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
               src_len: int = 0, layout: Optional[str] = None,
               page_budget: Optional[int] = None,
               paged_tables: str = "empty", device=None) -> Dict:
    """The serving cache of the reference's ``init_cache`` and
    ``_layer_cache_ab``: the per-layer leaves, one list entry per layer
    of their kind (:func:`layer_leaves`), for ``layout`` (default
    ``cfg.cache_layout``):

    * global attention, ``"paged"``: a K and a V pool ``k_pages``,
      ``v_pages (P, K, ps, hd)`` in ``cfg.dtype``, or under MLA a latent
      pool ``ckv_pages (P, ps, lora)`` and a rope-key pool ``krope_pages
      (P, ps, rd)``; P = ``page_budget``, by default the worst case B·pps;
    * global attention, ``"dense"`` (lockstep serving): a whole-length
      buffer ``k_dense``, ``v_dense (B, K, max_len, hd)`` in ``cfg.dtype``
      and one shared ``pos_dense (max_len,)`` int32 starting at -1, or
      under MLA ``ckv (B, max_len, lora)``, ``krope (B, max_len, rd)`` and
      ``pos_dense``;
    * local attention: a ring ``k``, ``v (B, K, W, hd)`` in ``cfg.dtype``
      and ``pos (B, W)`` int32 starting at -1, W = ``window_size``, in
      either layout;
    * RG-LRU: ``h (B, R)`` fp32 and ``conv (B, CW-1, R)`` in ``cfg.dtype``;
    * RWKV: ``s (B, H, N, N)`` fp32 and the token-shift carries
      ``shift_tm``, ``shift_cm (B, D)`` in ``cfg.dtype``;
    * an encoder-decoder's decoder layers: the cross-attention's K and V
      over the encoder's ``src_len`` frames, ``cross_k``, ``cross_v (B,
      K, src_len, hd)`` in ``cfg.dtype`` (the reference's ``cross``
      leaves), one entry a decoder layer.

    The paged layout has ONE page table ``(B, pps)`` int32 that every
    layer reads (the reference broadcasts the same table into each
    layer's leaf); a stack without global layers keeps it too, so the
    engine's page accounting is the same for every config.
    ``paged_tables`` ``"empty"`` starts it at -1 for the engine's
    host-side allocator; ``"identity"`` gives row ``b`` pages ``b·pps ..
    (b+1)·pps - 1`` (lockstep serving over a worst-case pool; a smaller
    ``page_budget`` raises).  The reference's default is ``"identity"``;
    the port's is ``"empty"``, which its engine takes (ROADMAP D15).  A
    dense cache has no page table.

    The ring must hold a whole window (``max_len >= window_size``): the
    reference sizes it ``min(window, max_len)`` but decodes per sequence
    only into a full ring, and its lockstep prefill cannot fill a shorter
    one, so it fails there (ROADMAP R5, R10).  ``device="meta"`` sizes a
    cache without memory (the reference's ``abstract_cache``)."""
    check_ported(cfg)
    layout = cfg.cache_layout if layout is None else layout
    if layout not in LAYOUTS:
        raise ValueError(f"unknown cache layout {layout!r}: dense or paged")
    if paged_tables not in ("empty", "identity"):
        raise ValueError(f"paged_tables {paged_tables!r}: empty or identity")
    kinds = cfg.layer_kinds()
    W = cfg.window_size
    if LOCAL_ATTN in kinds and max_len < W:
        raise ValueError(
            f"{cfg.name}: max_len {max_len} (prompt_len + gen) is shorter "
            f"than the local window {W}; the local layers' ring buffer needs "
            "max_len >= window_size (the reference fails there: its engine "
            "at the first decode step, its lockstep prefill at the write)")
    ps = cfg.page_size
    pps = num_pages(max_len, ps)
    B = batch_size
    if layout == "paged" and paged_tables == "identity" and \
            page_budget is not None and page_budget < B * pps:
        raise ValueError(
            "identity page tables need the worst-case pool; pass "
            "paged_tables='empty' with a reduced page_budget")
    dev = resolve_device(device)
    pool = page_budget if page_budget is not None else B * pps
    K, hd, dt = cfg.num_kv_heads, cfg.head_dim, DTYPES[cfg.dtype]
    R, CW, D, N = cfg.rnn_width, cfg.conv1d_width, cfg.d_model, \
        cfg.rwkv_head_dim
    lora, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    shapes = {
        "k_pages": ((pool, K, ps, hd), dt, 0),
        "v_pages": ((pool, K, ps, hd), dt, 0),
        "ckv_pages": ((pool, ps, lora), dt, 0),
        "krope_pages": ((pool, ps, rd), dt, 0),
        "k_dense": ((B, K, max_len, hd), dt, 0),
        "v_dense": ((B, K, max_len, hd), dt, 0),
        "pos_dense": ((max_len,), torch.int32, -1),
        "ckv": ((B, max_len, lora), dt, 0),
        "krope": ((B, max_len, rd), dt, 0),
        "k": ((B, K, W, hd), dt, 0),
        "v": ((B, K, W, hd), dt, 0),
        "pos": ((B, W), torch.int32, -1),
        "h": ((B, R), torch.float32, 0),
        "conv": ((B, CW - 1, R), dt, 0),
        "s": ((B, D // N, N, N), torch.float32, 0),
        "shift_tm": ((B, D), dt, 0),
        "shift_cm": ((B, D), dt, 0),
    }
    cache: Dict = {}
    for kind in kinds:
        for name in layer_leaves(cfg, kind, layout):
            shape, dtype, fill = shapes[name]
            cache.setdefault(name, []).append(
                torch.full(shape, fill, dtype=dtype, device=dev))
    if cfg.is_encoder_decoder:
        if src_len < 1:
            raise ValueError(f"{cfg.name}: an encoder-decoder's cache holds "
                             "the cross K/V of src_len >= 1 frames")
        for name in ("cross_k", "cross_v"):
            cache[name] = [torch.zeros((B, K, src_len, hd), dtype=dt,
                                       device=dev)
                           for _ in range(cfg.num_layers)]
    if layout == "paged":
        if paged_tables == "identity":
            table = torch.arange(B * pps, dtype=torch.int32,
                                 device=dev).reshape(B, pps)
        else:
            table = torch.full((B, pps), -1, dtype=torch.int32, device=dev)
        cache["page_table"] = table
    return cache
