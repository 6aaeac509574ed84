"""AdamW with the warmup-cosine schedule (the reference's
``optim/adamw.py``).

Parameters, gradients and moments are dicts keyed by the model's
parameter names.  The update follows the reference step for step: the
global norm of the gradients and the clip scale, then ``count + 1``, the
schedule's lr and the bias corrections at that count, then per leaf the
fp32 moments, the bias-corrected step and weight decay on every leaf (1-D
leaves included).  Unlike the reference's pure function it updates the
parameters and the moments in place (the moments are as large as the
weights twice over).

A leaf of more than :data:`SLICE_ELEMENTS` elements is squared and
summed for the norm, and updated, in slices along its first axis, so its
fp32 temporaries never span the whole leaf: deepseek-v2's expert leaves
hold 1.26 B elements (160 x 5,120 x 1,536), and a whole-leaf update of
one in bf16 would make about six fp32 copies of it, 30 GB.  The update's
arithmetic is elementwise, so a sliced update is bit-equal to a whole
one; the norm sums the same squares in another order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

#: leaves above this many elements are summed and updated in slices of at
#: most this many (a whole number of rows of the first axis, at least one)
SLICE_ELEMENTS = 1 << 28


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``learning_rate``, then a cosine decay to
    ``min_lr_frac`` of it at ``total_steps``; fp32, on ``step``'s
    device."""
    step = step.to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = ((step - cfg.warmup_steps) / decay_steps).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm,
                       cfg.learning_rate * cos)


def _slices(t: torch.Tensor):
    """``t`` whole, or in slices along its first axis of at most
    :data:`SLICE_ELEMENTS` elements (one row at the least)."""
    if t.numel() <= SLICE_ELEMENTS or t.ndim == 0:
        return [t]
    rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    return list(torch.split(t, rows))


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(x.float().square().sum() for t in tree.values()
                          for x in _slices(t)))


def adamw_init(params: Tensors, opt_dtype=torch.float32) -> Dict:
    """Zero moments ``m``, ``v`` per leaf in ``opt_dtype`` and ``count``
    0 (int32)."""
    dev = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=opt_dtype, device=p.device)
                for n, p in params.items()}
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tensors, params: Tensors,
                 state: Dict) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One AdamW step over ``params`` (updated in place) from ``grads``;
    returns ``(state, {"grad_norm", "lr"})`` with the moments updated in
    place and ``count`` advanced."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cosine_schedule(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    for name, p in params.items():
        for p_, g_, m, v in zip(*(_slices(t) for t in (
                p, grads[name], state["m"][name], state["v"][name]))):
            g = g_.float() * scale
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
            vf = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
            step = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps) \
                + cfg.weight_decay * p_.float()
            p_.copy_(p_.float() - lr * step)
            m.copy_(mf)
            v.copy_(vf)
    state["count"] = count
    return state, {"grad_norm": gnorm, "lr": lr}
