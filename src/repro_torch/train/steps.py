"""Train and serve steps (the reference's ``train/steps.py``).

Training: :func:`loss_fn` (masked mean cross-entropy plus the aux loss),
:func:`init_train_state` and :func:`make_train_step` (microbatch
accumulation, global-norm clip, AdamW with the warmup-cosine schedule).
PyTorch runs eagerly, so there is nothing to jit; a step updates the
master weights and the moments in place.  The train state is a dict
``{"params": Model, "opt": {"m", "v", "count"}, "step"}``, the moments
keyed like the model's parameters (``convert.train_state_to_jax`` gives
the reference's tree).

Serving: the prefill and decode steps run under ``torch.inference_mode``
and update the cache's pools in place (the reference donates the cache
buffer to the same effect).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig, check_trainable
from repro_torch.models.layers import Ctx, resolve_device
from repro_torch.models.model import forward
from repro_torch.models.params import (
    Model, Tree, compute_params, init_params, make_trainable,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

TrainState = Dict                       # {params: Model, opt, step}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def loss_fn(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor],
            ctx: Ctx, remat_policy: str = "none"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(ce + aux, {"ce", "aux"})``: mean next-token cross-entropy over
    the labels >= 0 (masked ones are < 0), from the fp32 logits of every
    position; ``params`` is the compute tree (``compute_params``)."""
    logits, aux = forward(cfg, params, batch, ctx, mode="train",
                          remat_policy=remat_policy)
    labels = batch["labels"]
    valid = labels >= 0
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          torch.where(valid, labels, 0).reshape(-1).long(),
                          reduction="none").reshape(labels.shape)
    ce = (nll * valid).sum() / valid.sum().clamp_min(1)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def init_train_state(cfg: ModelConfig, *, seed: int = 0,
                     run: Optional[RunConfig] = None,
                     device=None, draws: str = "host") -> TrainState:
    """Fresh master weights from ``seed`` (fp32, matrices in the run's
    ``master_dtype``; drawn as :func:`init_params`'s ``draws`` says), zero
    AdamW moments in its ``opt_dtype`` and step 0, on ``device`` (``cuda``
    unless the caller names one)."""
    run = run or RunConfig()
    check_trainable(cfg)
    model = make_trainable(
        init_params(Model(cfg, device=resolve_device(device)), seed, draws),
        run.master_dtype)
    return new_train_state(model, run)


def new_train_state(model: Model, run: Optional[RunConfig] = None
                    ) -> TrainState:
    """A train state around ``model``'s master weights (made trainable by
    the caller): zero moments and step 0."""
    run = run or RunConfig()
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return {"params": model,
            "opt": adamw_init(params, getattr(torch, run.opt_dtype)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_train_step(cfg: ModelConfig, ctx: Ctx, run: RunConfig,
                    opt_cfg: Optional[AdamWConfig] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict]]:
    """(state, batch) -> (state, metrics {loss, ce, aux, grad_norm, lr}).
    With ``run.num_microbatches`` > 1 the batch is split along its rows
    (every entry: tokens, labels, an encoder-decoder's ``src_embeds``, a
    vision config's ``frontend_embeds``);
    the fp32 gradients of the microbatches are summed and divided by their
    count, the loss and metrics averaged.  The state is updated in
    place."""
    check_trainable(cfg)
    if run.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression {run.grad_compression!r} comes with the port "
            "of dist/compression.py")
    opt_cfg = opt_cfg or AdamWConfig(
        learning_rate=run.learning_rate, weight_decay=run.weight_decay,
        grad_clip_norm=run.grad_clip_norm, warmup_steps=run.warmup_steps,
        total_steps=run.total_steps)
    n_mb = run.num_microbatches

    def grads_of(model: Model, mb):
        names, leaves = zip(*model.named_parameters())
        loss, metrics = loss_fn(cfg, compute_params(model, ctx.dtype), mb,
                                ctx, run.remat_policy)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state["params"]
        if n_mb == 1:
            loss, metrics, grads = grads_of(model, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % n_mb:
                raise ValueError(f"batch {B} does not split into {n_mb} "
                                 "microbatches")
            size = B // n_mb
            gsum, lsum, msum = None, 0.0, {}
            for i in range(n_mb):
                mb = {k: t[i * size:(i + 1) * size] for k, t in batch.items()}
                loss_i, m_i, g_i = grads_of(model, mb)
                if gsum is None:
                    gsum = {n: g.float() for n, g in g_i.items()}
                else:
                    for n, g in g_i.items():
                        gsum[n] += g.float()
                del g_i
                lsum = lsum + loss_i
                msum = {k: msum.get(k, 0.0) + v for k, v in m_i.items()}
            grads = {n: g / n_mb for n, g in gsum.items()}
            loss = lsum / n_mb
            metrics = {k: v / n_mb for k, v in msum.items()}
        params = dict(model.named_parameters())
        state["opt"], opt_metrics = adamw_update(opt_cfg, grads, params,
                                                 state["opt"])
        state["step"] = state["step"] + 1
        return state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, ctx: Ctx):
    """(params, batch, cache, lengths=None, starts=None) ->
    (last_logits, cache).  ``lengths`` (B,) makes the prefill ragged,
    ``starts`` (B,) also chunked (see ``models.model.forward``)."""
    @torch.inference_mode()
    def prefill_step(params, batch, cache, lengths=None, starts=None):
        return forward(cfg, params, batch, ctx, mode="prefill", cache=cache,
                       lengths=lengths, starts=starts)
    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: Ctx):
    """(params, batch {tokens (B, 1)}, cache, pos) -> (logits, cache).
    ``pos`` is a 0-d tensor for a lockstep batch (every row at that
    position; the dense cache takes only this form) or (B,) per-row
    positions, -1 for an idle row (the engine's, over the paged cache)."""
    @torch.inference_mode()
    def decode_step(params, batch, cache, pos):
        return forward(cfg, params, batch, ctx, mode="decode", cache=cache,
                       pos=pos)
    return decode_step


def make_serve_steps(cfg: ModelConfig, ctx: Ctx):
    """The (prefill, decode) pair the serving engine drives."""
    return make_prefill_step(cfg, ctx), make_decode_step(cfg, ctx)
