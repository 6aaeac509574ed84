"""Serving CLI of the port, the reference's ``launch/serve.py``: lockstep
serving (one batched prefill, then every row decoded at one shared
position a step; ``launch.executor.run_lockstep``) over the dense KV
cache or, with ``--layout paged``, over the paged one with identity page
tables; or with ``--continuous``, continuous batching over the paged
cache (``launch.engine.ServingEngine``: admission, ragged prefill, page
allocation, eviction, prefix caching).

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --batch 2 --prompt-len 16 --gen 6
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --layout paged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --arch qwen3-0.6b --batch 8 --prompt-len 1024 --gen 32 --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --reduced --device cpu --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --arch rwkv6-7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --arch recurrentgemma-9b --reduced --device cpu --prompt-len 24
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --arch deepseek-v2-236b --layers 3 --no-prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --arch seamless-m4t-medium --reduced --device cpu

Without ``--continuous`` the layout is ``--layout`` or the config's own
(``dense`` for every registered config); ``--continuous`` pages its
cache, and ``--continuous --layout dense`` exits nonzero, as in the
reference.  Weights are random, drawn from ``--seed``; lockstep's prompts
(and an encoder-decoder's frames) are drawn with numpy from it
(``launch.executor.lockstep_inputs``), the engine's workload is
synthesized (``launch.engine.synthesize_requests``).  It runs on ``cuda``
unless ``--device`` names another device.  A stack with local attention
layers (recurrentgemma, gemma2) needs ``--prompt-len`` + ``--gen`` >= its
window (16 when ``--reduced``, 2,048 and 4,096 at full width); the
engine's prefix cache is always off for it.  ``--layers`` cuts a config's
depth and keeps its widths: deepseek-v2-236b (60 layers, 234.7 B
parameters without the embeddings) fits one 80 GB card at 3 layers (the
dense first layer and two MoE layers, 9.33 B parameters); the cut is
printed.  The engine serves an encoder-decoder (seamless-m4t-medium) at
full-length prompts, each prefilled alone with its own encoder frames, as
the reference's engine serves it; ``--layers`` cuts its decoder.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.engine import ServingEngine, synthesize_requests
from repro_torch.launch.executor import run_lockstep
from repro_torch.launch.spec import ServeSpec
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import build_model


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config, fp32 compute")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers, widths kept "
                         "(0 = the config's depth)")
    ap.add_argument("--batch", type=int, default=4,
                    help="concurrent decode slots")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per KV page (0 = config default)")
    ap.add_argument("--layout", default=None, choices=["dense", "paged"],
                    help="KV-cache layout (default: the config's; paged "
                         "under --continuous)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged cache")
    ap.add_argument("--requests", type=int, default=8,
                    help="request-queue length for --continuous")
    ap.add_argument("--page-budget", type=int, default=0,
                    help="physical pages in the pool (0 = worst case)")
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="optimistic admission factor; page exhaustion "
                         "evicts the youngest sequence (1.0 = never)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="hash-addressed prefix caching with copy-on-write "
                         "pages")
    ap.add_argument("--shared-prefix", type=float, default=0.0,
                    help="fraction of prompt-len every request shares")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked "
                         "for)")
    return ap.parse_args(argv)


def run_continuous(cfg, model, sv: ServeSpec, *, seed: int, device,
                   dtype: torch.dtype) -> ServingEngine:
    """Drain a synthesized workload through a fresh engine and print the
    summary; returns the drained engine."""
    try:
        engine = ServingEngine(cfg, model, sv, device=device, dtype=dtype)
    except ValueError as e:          # CLI contract: bad flags exit nonzero
        raise SystemExit(str(e)) from e
    t0 = time.perf_counter()
    for request in synthesize_requests(cfg, sv, seed, engine.ragged):
        engine.submit(request)
    engine.run()
    if engine.ctx.device.type == "cuda":
        torch.cuda.synchronize(engine.ctx.device)
    dt = time.perf_counter() - t0
    print(f"[serve/continuous] arch={cfg.name} device={engine.ctx.device} "
          f"dtype={str(dtype).replace('torch.', '')} requests={sv.requests} "
          f"slots={engine.B} prompt<= {sv.prompt_len} gen<= {sv.gen} "
          f"page_size={engine.ps}")
    print(f"  pool: {engine.pool.n_pages} pages, high-water "
          f"{engine.pool.high_water}, admission stalls "
          f"{engine.stalled_admissions}, evictions {engine.evictions} "
          f"(overcommit {engine.overcommit:g})")
    if engine.prefix_cache:
        total = engine.prefill_tokens + engine.cached_tokens
        print(f"  prefix cache: {engine.prefix_hits} hits / "
              f"{engine.prefix_misses} misses, {engine.cached_tokens}/"
              f"{total} prompt tokens served from cache, "
              f"{engine.cow_copies} CoW copies")
    print(f"  completed {len(engine.responses)}/{sv.requests} in "
          f"{engine.decode_steps} decode steps, {dt * 1e3:.1f} ms "
          f"({engine.generated / max(dt, 1e-9):.0f} generated tok/s)")
    if len(engine.responses) != sv.requests:
        raise SystemExit(f"only {len(engine.responses)} of {sv.requests} "
                         "requests completed")
    return engine


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.continuous and args.layout == "dense":
        raise SystemExit("--continuous serves the paged cache; --layout "
                         "dense is lockstep's (drop --continuous)")
    layout = args.layout or ("paged" if args.continuous
                             else cfg.cache_layout)
    overrides = {"cache_layout": layout}
    if args.layers:
        if not 0 < args.layers <= cfg.num_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.num_layers} layers")
        if args.layers < cfg.num_layers:
            print(f"[serve] depth cut: {cfg.name} {cfg.num_layers} -> "
                  f"{args.layers} layers, widths kept")
        overrides["num_layers"] = args.layers
    if args.page_size:
        overrides["page_size"] = args.page_size
    cfg = dataclasses.replace(cfg, **overrides)
    sv = ServeSpec(batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, requests=args.requests,
                   page_budget=args.page_budget, overcommit=args.overcommit,
                   prefix_cache=args.prefix_cache,
                   shared_prefix_frac=args.shared_prefix,
                   cache_layout=layout, continuous=args.continuous)
    model = build_model(cfg, device=device, seed=args.seed)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    if args.continuous:
        run_continuous(cfg, model, sv, seed=args.seed, device=device,
                       dtype=dtype)
        return 0
    try:
        run_lockstep(cfg, model, sv, seed=args.seed, device=device,
                     dtype=dtype)
    except ValueError as e:          # CLI contract: bad flags exit nonzero
        raise SystemExit(str(e)) from e
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
