"""Lockstep serving, the reference's default serve path (its
``launch/executor.py:run_lockstep``): one prefill of the whole batch,
then greedy decode of every row at one shared position a step, over the
dense cache or the paged one with identity page tables.

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --batch 2 --prompt-len 16 --gen 6 [--layout paged]

The prompts are drawn with numpy from the seed (the reference draws them
with ``jax.random``, ROADMAP D5), and an encoder-decoder's frames are
``0.02·N(0, 1)`` from numpy too (D13).  Continuous batching over the
paged cache is :mod:`repro_torch.launch.engine`; the rest of the
reference's executor (``execute``, its train and dry-run drivers) is not
ported.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import LOCAL_ATTN, check_ported
from repro_torch.launch.spec import ServeSpec, check_serve_spec
from repro_torch.models.layers import Ctx, resolve_device
from repro_torch.models.model import init_cache
from repro_torch.models.moe import check_row_length
from repro_torch.models.params import cast_params
from repro_torch.train.steps import make_serve_steps


def lockstep_inputs(cfg, sv: ServeSpec, seed: int):
    """``(prompts (B, P) int64, src_embeds (B, src_len, d) fp32 or None)``
    drawn from numpy's ``default_rng(seed)``; an encoder-decoder gets
    ``max(P // 4, 16)`` frames, as the reference's lockstep run."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(sv.batch, sv.prompt_len))
    src = None
    if cfg.is_encoder_decoder:
        src_len = max(sv.prompt_len // 4, 16)
        src = (0.02 * rng.standard_normal(
            (sv.batch, src_len, cfg.d_model))).astype(np.float32)
    return prompts, src


def check_lockstep(cfg, sv: ServeSpec) -> None:
    """Refuse what the reference's lockstep run refuses or fails on: an
    MoE prompt row longer than one dispatch group and not a whole number
    of them (ROADMAP R6), and a ring shorter than its window (R5, R10)."""
    check_ported(cfg)
    check_serve_spec(sv, cfg, continuous=False)
    if sv.gen < 1 or sv.prompt_len < 1:
        raise ValueError(f"lockstep needs prompt_len >= 1 and gen >= 1 "
                         f"(got {sv.prompt_len}, {sv.gen})")
    if cfg.is_moe:
        check_row_length(cfg, sv.prompt_len)
    if LOCAL_ATTN in cfg.layer_kinds() and \
            sv.prompt_len + sv.gen < cfg.window_size:
        raise ValueError(
            f"{cfg.name}: prompt_len + gen = {sv.prompt_len + sv.gen} is "
            f"shorter than the local window {cfg.window_size}; the ring "
            "needs max_len >= window_size (the reference's lockstep prefill "
            "fails to write a shorter one)")


def run_lockstep(cfg, model, sv: ServeSpec, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.bfloat16,
                 prompts: Optional[np.ndarray] = None,
                 src_embeds: Optional[np.ndarray] = None,
                 record: Optional[Callable] = None, quiet: bool = False
                 ) -> dict:
    """Batched prefill and lockstep greedy decode of ``sv.batch`` prompts
    of ``sv.prompt_len`` tokens for ``sv.gen`` tokens each, on
    ``cfg.cache_layout`` (the paged layout with identity page tables over
    a worst-case pool).  ``model`` holds the master weights on ``device``
    (``cuda`` unless the caller names one); the forward computes in
    ``dtype``.  ``prompts`` and ``src_embeds`` default to
    :func:`lockstep_inputs`.  ``record(kind, step, logits)`` sees each
    step's last-position logits (B, V) on the device.

    Returns ``{"tokens": (B, G) int64 on the host, "prefill_s",
    "decode_s", "layout"}`` (seconds on the host clock, each ending in a
    device sync) and prints the reference's lines with ``device=``
    added."""
    check_lockstep(cfg, sv)
    dev = resolve_device(device)
    held = {p.device for p in model.parameters()}
    if held != {dev}:
        raise ValueError(f"model weights on {sorted(map(str, held))}, "
                         f"lockstep device {dev}")
    B, P, G = sv.batch, sv.prompt_len, sv.gen
    if prompts is None:
        prompts, drawn = lockstep_inputs(cfg, sv, seed)
        src_embeds = drawn if src_embeds is None else src_embeds
    prompts = np.asarray(prompts)
    if prompts.shape != (B, P):
        raise ValueError(f"prompts of shape {prompts.shape}, expected "
                         f"({B}, {P})")
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long,
                                       device=dev)}
    src_len = 0
    if cfg.is_encoder_decoder:
        if src_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "src_embeds (B, src_len, d_model)")
        batch["src_embeds"] = torch.as_tensor(src_embeds, device=dev)
        src_len = batch["src_embeds"].shape[1]

    ctx = Ctx(device=dev, dtype=dtype)
    params = cast_params(model, dtype)
    prefill, decode = make_serve_steps(cfg, ctx)
    cache = init_cache(cfg, B, P + G, src_len=src_len,
                       paged_tables="identity", device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    if record is not None:
        record("prefill", 0, logits[:, -1])
    tok = logits[:, -1].argmax(-1, keepdim=True)
    sync()
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i, t in enumerate(range(P, P + G - 1)):
        pos = torch.tensor(t, dtype=torch.int32, device=dev)
        logits, cache = decode(params, {"tokens": tok}, cache, pos)
        if record is not None:
            record("decode", i + 1, logits[:, -1])
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    tokens = torch.cat(out, dim=1).cpu()
    if not quiet:
        print(f"[serve] arch={cfg.name} layout={cfg.cache_layout} "
              f"device={dev} dtype={str(dtype).replace('torch.', '')} "
              f"batch={B} prompt={P} gen={G}")
        print(f"  prefill: {t_prefill * 1e3:.1f} ms "
              f"({B * P / max(t_prefill, 1e-9):.0f} tok/s)")
        print(f"  decode:  {t_decode * 1e3:.1f} ms "
              f"({B * (G - 1) / max(t_decode, 1e-9):.0f} tok/s)")
        print(f"  sample continuations: {tokens[:2, :10].tolist()}")
    return {"tokens": tokens, "prefill_s": t_prefill, "decode_s": t_decode,
            "layout": cfg.cache_layout}
