"""Mixture-of-Experts FFN for serving (the reference's
``models/moe.py:moe_ffn`` with ``dropless=True``).

The reference serves by sweeping every token through all E experts and
weighting the experts it did not choose by 0 (one dense einsum per
projection).  An unchosen expert adds exactly 0, so the port computes the
same function over the chosen (token, expert) pairs only: the pairs are
sorted by expert and each expert that has tokens runs its SwiGLU as one
``torch.matmul`` per projection.  At deepseek-v2's width a prefill round
of 8,192 tokens would otherwise build (8,192, 160, 1,536) activations,
4 GB for each of the gate and up projections, for 160 / 6 ≈ 27× the work.

Numerics follow the reference's mixed dtypes: router logits from a matmul
in the compute dtype, then fp32 softmax, top-k and renormalisation; each
expert's SwiGLU in the compute dtype; the combine in fp32 and ONE cast to
the compute dtype; the shared experts in the compute dtype.

Training's capacity dispatch and its load-balancing loss come in a later
training slice (this one trains the dense GQA stacks).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation

MOE_GROUP_SIZE = 1024     # the reference's tokens per dispatch group


def check_row_length(cfg: ModelConfig, S: int) -> None:
    """The reference groups each row's tokens by ``Sg = min(group, S)``
    and asserts ``S % Sg == 0`` on every call, serving included
    (moe.py:48): a row longer than one group must be a whole number of
    groups."""
    Sg = min(cfg.moe_group_size or MOE_GROUP_SIZE, S)
    if S % Sg:
        raise ValueError(
            f"{cfg.name}: a row of {S} tokens is not a whole number of MoE "
            f"dispatch groups of {Sg}; the reference asserts S % Sg == 0 "
            "(moe.py) and refuses it, so the port does too")


def route(logits: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` routing of fp32 router ``logits (T, E)``: softmax, the
    ``k`` most probable experts, their probabilities renormalised to sum
    to 1 (divided by ``max(sum, 1e-9)``).  Returns ``(weights (T, k) fp32,
    experts (T, k) int64)``, most probable first.

    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them:
    ``torch.topk`` promises no order among equal values, and bf16 router
    logits tie often, so the experts come from a stable descending sort."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
            *, mode: str = "serve") -> torch.Tensor:
    """Routed experts (top-k of ``num_experts``) plus the shared experts,
    for ``x (B, S, D)`` in the compute dtype; returns ``(B, S, D)``.  Each
    token's output depends on that token alone (dropless routing)."""
    if mode == "train":
        raise NotImplementedError(
            "the MoE's training path (capacity dispatch and the "
            "load-balancing aux loss) comes in a later training slice of "
            "the port; this one trains the dense GQA stacks")
    if mode != "serve":
        raise ValueError(mode)
    B, S, D = x.shape
    check_row_length(cfg, S)
    k = cfg.num_experts_per_tok
    dt = x.dtype
    xt = x.reshape(B * S, D)
    T = xt.shape[0]
    weights, experts = route((xt @ p["router"]).float(), k)

    # the (token, choice) pairs grouped by expert; one host read of the
    # per-expert counts sizes the slices
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=cfg.num_experts).tolist()
    ye = torch.empty((T * k, D), dtype=dt, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        pairs = order[start:start + n]
        start += n
        xe = xt[pairs // k]
        h = activation(xe @ p["we_g"][e], cfg.act) * (xe @ p["we_u"][e])
        ye[pairs] = h @ p["we_d"][e]
    ye = ye.view(T, k, D)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(k):
        out.addcmul_(ye[:, j].float(), weights[:, j:j + 1])
    out = out.to(dt).view(B, S, D)

    if cfg.num_shared_experts:
        hs = activation(x @ p["ws_g"], cfg.act) * (x @ p["ws_u"])
        out = out + hs @ p["ws_d"]
    return out
