"""RWKV6 ("Finch") blocks: time-mix (WKV6) + channel-mix (the reference's
``models/rwkv.py``).

WKV6 recurrence, per head (hd_k = hd_v = N, decay on the key channel):

    o_t = r_t · S_{t-1}  +  (r_t · (u ⊙ k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ          w_t = exp(-exp(ww_t)) ∈ (0,1)

Full mode (prefill) runs ``ops.wkv6_bshn``: the Hopper kernel on the card,
its plain chunked version on the CPU (:func:`wkv6_chunked`, the eager
oracle).  Decode runs :func:`wkv6_step`, plain PyTorch as in the
reference.  Decay, state and the recurrence are fp32 throughout.

The functions keep the reference's functional contract: they return the
layer's new cache entries (``s``, ``shift_tm``, ``shift_cm``) and the
caller stores them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_wkv import (  # noqa: F401
    wkv6_torch as wkv6_chunked,
)
from repro_torch.models.layers import Ctx

Cache = Dict[str, torch.Tensor]


def _token_shift(x: torch.Tensor,
                 state: Optional[torch.Tensor]) -> torch.Tensor:
    """shift(x)_t = x_{t-1}; position -1 comes from ``state`` (decode) or
    0."""
    prev = torch.zeros_like(x[:, :1]) if state is None \
        else state[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, xx: torch.Tensor) -> List[torch.Tensor]:
    """RWKV6 data-dependent lerp: 5 mixed inputs (w, k, v, r, g)."""
    B, S, D = x.shape
    rk = p["tm_B"].shape[1]
    base = x + xx * p["tm_mu"][0].to(x.dtype)
    lora = torch.tanh(base @ p["tm_A"]).reshape(B, S, 5, rk)
    dyn = torch.einsum("bsjr,jrd->bsjd", lora, p["tm_B"])      # (B,S,5,D)
    mus = p["tm_mu"][1:6].to(x.dtype)                          # (5,D)
    mixed = x[:, :, None] + xx[:, :, None] * (mus + dyn.to(x.dtype))
    return [mixed[:, :, j] for j in range(5)]                  # w,k,v,r,g


def wkv6_step(r, k, v, lw, u, s):
    """One decode step.  r, k, v, lw (B, H, N); u (H, N); s (B, H, N, N)
    fp32.  Returns (o (B, H, N) fp32, s_new)."""
    rf, kf, vf = (t.float() for t in (r, k, v))
    at = kf[..., :, None] * vf[..., None, :]                   # (B,H,N,N)
    o = torch.einsum("bhc,bhcv->bhv", rf, s + u[..., None] * at)
    s_new = torch.exp(lw)[..., None] * s + at
    return o, s_new


def _group_norm_heads(o: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """LayerNorm within each head (RWKV 'ln_x' GroupNorm), scale (H*N,)."""
    B, S, H, N = o.shape
    of = o.float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, unbiased=False, keepdim=True)
    normed = (of - mu) * torch.rsqrt(var + eps)
    return (normed.reshape(B, S, H * N) * scale.float()).to(o.dtype)


def _last_valid(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Each row's value at its last valid position ``lens - 1`` (row 0's
    first position for a length-0 row, which the caller discards)."""
    last = (lens.long() - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), last]


def rwkv_time_mix(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    ctx: Ctx,
    *,
    mode: str,                                 # full | decode
    cache: Optional[Cache],
    lengths: Optional[torch.Tensor] = None,    # ragged prefill: (B,) lens
) -> Tuple[torch.Tensor, Optional[Cache]]:
    B, S, D = x.shape
    N = cfg.rwkv_head_dim
    H = D // N
    shift_state = cache["shift_tm"] \
        if (cache is not None and mode == "decode") else None
    xx = _token_shift(x, shift_state) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, xx)

    r = (xr @ p["wr"]).reshape(B, S, H, N)
    k = (xk @ p["wk"]).reshape(B, S, H, N)
    v = (xv @ p["wv"]).reshape(B, S, H, N)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (fp32, log space):  lw = -exp(ww) <= 0
    ww = p["w_base"].float() + \
        (torch.tanh(xw @ p["ww_A"]) @ p["ww_B"]).float()
    lw = -torch.exp(ww).reshape(B, S, H, N)
    u = p["u"].float()

    if lengths is not None and mode != "decode":
        # ragged prefill: padding steps neither read nor write the state —
        # k = 0 kills their outer-product write and u-bonus, lw = 0
        # (decay 1) stops them decaying the carry, so s_fin is each row's
        # state at lengths-1
        lens = lengths.to(x.device, torch.int32)
        pad_t = (torch.arange(S, dtype=torch.int32, device=x.device)[None]
                 >= lens[:, None])[..., None, None]           # (B,S,1,1)
        k = torch.where(pad_t, torch.zeros_like(k), k)
        lw = torch.where(pad_t, 0.0, lw)

    if mode == "decode":
        o, s_new = wkv6_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0], u,
                             cache["s"].float())
        o = o[:, None]
        new_cache = {"s": s_new.to(cache["s"].dtype),
                     "shift_tm": x[:, -1], "shift_cm": cache["shift_cm"]}
    else:
        s0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
        o, s_fin = ops.wkv6_bshn(r, k, v, lw, u, s0, chunk=ctx.rwkv_chunk)
        new_cache = None
        if cache is not None:
            shift_fin = x[:, -1]
            if lengths is not None:
                shift_fin = _last_valid(x, lens)
                keep = lens > 0
                s_fin = torch.where(keep[:, None, None, None], s_fin,
                                    cache["s"].to(s_fin.dtype))
                shift_fin = torch.where(keep[:, None], shift_fin,
                                        cache["shift_tm"].to(shift_fin.dtype))
            new_cache = {"s": s_fin.to(cache["s"].dtype),
                         "shift_tm": shift_fin.to(cache["shift_tm"].dtype),
                         "shift_cm": cache["shift_cm"]}
    o = o.to(x.dtype)
    o = _group_norm_heads(o, p["ln_x"], cfg.norm_eps)
    o = o * g
    return o @ p["wo"], new_cache


def rwkv_channel_mix(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    ctx: Ctx,
    *,
    mode: str,                                 # full | decode
    cache: Optional[Cache],
    lengths: Optional[torch.Tensor] = None,    # ragged prefill: (B,) lens
) -> Tuple[torch.Tensor, Optional[Cache]]:
    shift_state = cache["shift_cm"] \
        if (cache is not None and mode == "decode") else None
    xx = _token_shift(x, shift_state) - x
    xk = x + xx * p["cm_mu_k"].to(x.dtype)
    xr = x + xx * p["cm_mu_r"].to(x.dtype)
    k = torch.square(torch.relu(xk @ p["wk_c"]))
    out = torch.sigmoid(xr @ p["wr_c"]) * (k @ p["wv_c"])
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        shift_fin = x[:, -1]
        if lengths is not None and mode != "decode":
            lens = lengths.to(x.device, torch.int32)
            shift_fin = torch.where((lens > 0)[:, None],
                                    _last_valid(x, lens),
                                    cache["shift_cm"].to(shift_fin.dtype))
        new_cache["shift_cm"] = shift_fin.to(cache["shift_cm"].dtype)
    return out, new_cache
