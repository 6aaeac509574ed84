"""Serve steps (the reference's ``train/steps.py``, serving part).

The loss, optimizer and train step come with the training slice.  PyTorch
runs eagerly, so there is nothing to jit; both steps run under
``torch.inference_mode`` and update the cache's pools in place (the
reference donates the cache buffer to the same effect).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.model import forward


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
    """(params, batch {tokens (B, 1)}, cache, pos (B,)) -> (logits, cache)."""
    @torch.inference_mode()
    def decode_step(params, batch, cache, pos):
        return forward(cfg, params, batch, ctx, mode="decode", cache=cache,
                       pos=pos)
    return decode_step


def make_serve_steps(cfg: ModelConfig, ctx: Ctx):
    """The (prefill, decode) pair the serving engine drives."""
    return make_prefill_step(cfg, ctx), make_decode_step(cfg, ctx)
