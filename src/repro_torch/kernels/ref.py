"""Naive torch oracles of the kernels: attention, the RG-LRU scan and
WKV6."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, group: int, scale: float, causal: bool = True,
                  window: int = 0, logit_cap: float = 0.0) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BK, Sk, hd): full masked softmax attention in
    fp32, the kv head of q head ``bh`` being ``bh // group``."""
    Sq, Sk = q.shape[1], k.shape[1]
    kq = k.repeat_interleave(group, dim=0)
    vq = v.repeat_interleave(group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), kq.float()) * scale
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    pq = torch.arange(Sq, device=q.device)[:, None]
    pk = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pk <= pq
    if window:
        mask &= pq - pk < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vq.float()).to(q.dtype)


def rglru_ref(log_a, b, h0) -> torch.Tensor:
    """Step-by-step linear recurrence h_t = exp(log_a_t)·h_{t-1} + b_t.
    log_a/b (B, S, R), h0 (B, R); returns the h sequence (B, S, R)."""
    h = h0
    hs = []
    for t in range(log_a.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def wkv6_ref(r, k, v, lw, u, s0):
    """Step-by-step WKV6, the oracle of the chunked forms.  r/k/v/lw
    (BH, S, N), u (BH, 1, N), s0 (BH, N, N); returns (o (BH, S, N) in
    r's dtype, s_final (BH, N, N) fp32)."""
    rf, kf, vf = (t.float() for t in (r, k, v))
    uf = u.float()[:, 0]                                  # (BH, N)
    s = s0.float()
    outs = []
    for t in range(r.shape[1]):
        at = kf[:, t, :, None] * vf[:, t, None, :]        # (BH, N, N)
        outs.append(torch.einsum("bc,bcv->bv", rf[:, t],
                                 s + uf[:, :, None] * at))
        s = torch.exp(lw[:, t].float())[:, :, None] * s + at
    return torch.stack(outs, dim=1).to(r.dtype), s
