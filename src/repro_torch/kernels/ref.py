"""Naive torch oracle for the flash-attention kernel."""
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
