"""RG-LRU recurrent block of Griffin / RecurrentGemma (the reference's
``models/recurrent.py``).

Block:  x-branch = conv1d(W_x · u) → RG-LRU ;  y-branch = GeLU(W_y · u)
        out = W_o (y ⊙ RGLRU(x))

RG-LRU, per channel:

    r_t = σ(x_t W_r),  i_t = σ(x_t W_i)
    a_t = exp(c · r_t · log σ(Λ))        (c = 8, Griffin §2.4)
    h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

Full mode (prefill) runs ``ops.rglru_scan_bsr``: the Hopper kernel on the
card, its plain step loop on the CPU.  :func:`rglru_scan_assoc` is the
whole-sequence associative scan (the reference's non-Pallas path), kept
as a second oracle.  Decode is one plain step, as in the reference.  The
cache of a layer is the carry ``h`` (B, R) in fp32 and the conv window
``conv`` (B, CW-1, R) of pre-conv inputs in ``cfg.dtype``; the functions
return the layer's new entries and the caller stores them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Ctx

Cache = Dict[str, torch.Tensor]
RGLRU_C = 8.0


def rglru_gates(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_a, b): the per-step decay in log space (<= 0) and the gated
    input sqrt(1 - a²)·i·x, both fp32 (B, S, R)."""
    r = torch.sigmoid((x @ p["gate_r"]).float())
    i = torch.sigmoid((x @ p["gate_i"]).float())
    log_lam = -F.softplus(-p["rglru_lambda"].float())       # log σ(Λ)
    log_a = RGLRU_C * r * log_lam
    a_sq = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a_sq, min=1e-12)) * i * x.float()
    return log_a, gated


def rglru_scan_assoc(log_a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = exp(log_a_t)·h_{t-1} + b_t over dim 1 as an associative scan
    of the affine maps h → a·h + b (Hillis–Steele doubling: log2 S passes
    of ``(la1, b1) ∘ (la2, b2) = (la1 + la2, b1·exp(la2) + b2)``)."""
    la, bb = log_a.float(), b.float()
    if h0 is not None:
        # fold the incoming state into the first step's additive term
        bb = bb.clone()
        la = la.clone()
        bb[:, 0] = bb[:, 0] + torch.exp(la[:, 0]) * h0.float()
        la[:, 0] = 0.0
    S = la.shape[1]
    d = 1
    while d < S:
        la_prev, b_prev = la[:, :-d], bb[:, :-d]
        la_cur, b_cur = la[:, d:], bb[:, d:]
        bb = torch.cat([bb[:, :d], b_prev * torch.exp(la_cur) + b_cur], 1)
        la = torch.cat([la[:, :d], la_prev + la_cur], 1)
        d *= 2
    return bb


def conv1d_causal(p, x: torch.Tensor, state: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  ``state`` is the trailing
    (CW-1)-step window of the previous segment (decode), zeros for a
    prefill.  Returns (out (B, S, R), the new trailing window)."""
    CW = p["conv_w"].shape[0]
    B, S, R = x.shape
    if state is None:
        state = torch.zeros((B, CW - 1, R), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(CW):
        out = out + xp[:, i:i + S] * p["conv_w"][i].to(x.dtype)
    out = out + p["conv_b"].to(x.dtype)
    return out, xp[:, -(CW - 1):]


def rglru_block(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    u: torch.Tensor,                         # (B, S, D)
    ctx: Ctx,
    *,
    mode: str,                               # full | decode
    cache: Optional[Cache],
    lengths: Optional[torch.Tensor] = None,  # ragged prefill: (B,) lengths
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (out (B, S, D), the layer's new ``{"h", "conv"}`` or
    ``None`` without a cache).  A ragged prefill (``lengths``) turns every
    padding step into log_a = 0, b = 0, so the scan's last step holds
    each row's h at its length; the conv window is gathered per row at
    the row's last valid steps, and length-0 rows keep their h and conv."""
    B, S, _ = u.shape
    x = u @ p["wx"]                                          # (B, S, R)
    y = F.gelu(u @ p["wy"], approximate="tanh")

    conv_state = cache["conv"] if cache is not None and mode == "decode" \
        else None
    xc, new_conv = conv1d_causal(p, x, conv_state)

    log_a, b = rglru_gates(p, xc)
    if lengths is not None and mode != "decode":
        lens = lengths.to(device=u.device, dtype=torch.long)
        pad_t = (torch.arange(S, device=u.device)[None, :]
                 >= lens[:, None])[..., None]                # (B, S, 1)
        log_a = torch.where(pad_t, 0.0, log_a)
        b = torch.where(pad_t, 0.0, b)
    new_cache = None
    if mode == "decode":
        h = torch.exp(log_a[:, 0]) * cache["h"].float() + b[:, 0]
        h_seq = h[:, None]
        new_cache = {"h": h.to(cache["h"].dtype), "conv": new_conv}
    else:
        h_seq = ops.rglru_scan_bsr(log_a.contiguous(), b.contiguous())
        if cache is not None:            # prefill: expose the final state
            h_fin = h_seq[:, -1]
            conv_fin = new_conv
            if lengths is not None:
                # the CW-1 pre-conv inputs ending at each row's last valid
                # step (lengths == S gives the trailing window)
                CW = p["conv_w"].shape[0]
                xp = torch.cat([torch.zeros((B, CW - 1, x.shape[-1]),
                                            dtype=x.dtype, device=x.device),
                                x], dim=1)
                idx = lens[:, None] + torch.arange(CW - 1, device=u.device)
                conv_fin = xp.gather(
                    1, idx[..., None].expand(-1, -1, x.shape[-1]))
                # length-0 rows are active slots mid-decode: keep theirs
                keep = lens > 0
                h_fin = torch.where(keep[:, None], h_fin,
                                    cache["h"].to(h_fin.dtype))
                conv_fin = torch.where(keep[:, None, None], conv_fin,
                                       cache["conv"].to(conv_fin.dtype))
            new_cache = {"h": h_fin.to(cache["h"].dtype),
                         "conv": conv_fin.to(cache["conv"].dtype)}
    out = (y * h_seq.to(u.dtype)) @ p["wo"]
    return out, new_cache
