"""Training CLI of the port (the reference's ``launch/train.py`` and its
executor's ``_run_train``): random init from ``--seed``, the synthetic
data stream, AdamW with warmup (a twentieth of the steps) and cosine
decay.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 10 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch paper-overhead-100m --steps 30 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 6 --batch 4 --seq 4096 --microbatches 2 --remat full
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --steps 6 --batch 4 --seq 4096 \\
        --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
        --layers 12 --steps 6 --batch 4 --seq 4096 --microbatches 2 \\
        --remat full --lr 3e-4
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-236b --layers 2 --steps 6 --batch 2 --seq 4096 \\
        --remat full
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-9b --layers 6 --steps 6 --batch 2 --seq 4096 \\
        --microbatches 2 --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
        --layers 2 --steps 6 --batch 2 --seq 4096 --microbatches 2 \\
        --remat full
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mistral-large-123b --layers 2 --steps 6 --batch 1 \\
        --seq 4096 --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
        --layers 6 --steps 6 --batch 4 --seq 4096 --microbatches 4 \\
        --remat full

It trains every config the port serves: paper-overhead-100m, qwen3-0.6b,
qwen2.5-32b, mistral-large-123b, gemma2-9b, granite-moe-1b-a400m,
rwkv6-7b, deepseek-v2-236b and recurrentgemma-9b
(``configs.base.check_trainable``).  It runs on ``cuda`` unless
``--device`` names another device; on the card every attention layer
takes the flash kernels (forward and backward; MLA's at qk 192 / v 128,
recurrentgemma's local layers at hd 256 over their window, gemma2's
local and global layers at hd 256 under its softcap), every RWKV6
layer the WKV6 kernels and every RG-LRU layer the RG-LRU scan's kernels
(forward and backward).  Compute is bf16 at full width and fp32 under ``--reduced``, as
in the reference's executor; the master weights and moments take the
dtypes of the config's registered ``train_4k`` run (bf16 for
deepseek-v2-236b, as the reference's run has them; fp32 for the others).  An MoE
config trains under capacity dispatch, its rows a whole number of
dispatch groups (``--seq`` otherwise refused before the first step, as
the reference asserts), and its loss adds the router's aux loss.  It prints
the loss, grad norm and lr of the logged steps, then steps/s and tokens/s
on a host clock that ends in a device synchronise.  ``--layers`` cuts a
config's depth and keeps its widths.

An encoder-decoder (seamless-m4t-medium) trains through :func:`train`,
whose batch source then adds the encoder frames (``src_embeds``,
``data.pipeline.SourceFramesData``); the CLI refuses it, as the
reference's CLI cannot train it (its batches carry no ``src_embeds``;
ROADMAP R9).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.configs import RunConfig, get_config, get_run_config
from repro_torch.configs.base import src_len_for
from repro_torch.data.pipeline import SourceFramesData, SyntheticLMData
from repro_torch.launch.spec import TrainSpec, check_train_spec
from repro_torch.models.layers import Ctx, resolve_device
from repro_torch.models.moe import check_row_length
from repro_torch.models.params import count_params
from repro_torch.train.steps import init_train_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-overhead-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config, fp32 compute")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers, widths kept "
                         "(0 = the config's depth)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu must be asked "
                         "for)")
    return ap.parse_args(argv)


def spec_of(args: argparse.Namespace) -> TrainSpec:
    return TrainSpec(total_steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, learning_rate=args.lr,
                     num_microbatches=args.microbatches,
                     remat_policy=args.remat, reduced=args.reduced,
                     log_every=args.log_every)


def config_of(arch: str, *, reduced: bool, layers: int = 0):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def run_config_of(t: TrainSpec, arch: str) -> RunConfig:
    """The run of ``t``: its microbatches, remat and learning rate, warmup
    a twentieth of the steps, and the master weights' and moments' dtypes
    of ``arch``'s registered ``train_4k`` run (fp32 without one)."""
    registered = get_run_config(arch, "train_4k")
    return RunConfig(num_microbatches=t.num_microbatches,
                     remat_policy=t.remat_policy,
                     learning_rate=t.learning_rate,
                     warmup_steps=max(t.total_steps // 20, 1),
                     total_steps=t.total_steps,
                     master_dtype=registered.master_dtype,
                     opt_dtype=registered.opt_dtype)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def batches_of(cfg, t: TrainSpec, seed: int):
    """The train loop's batch source: the synthetic token stream, and for
    an encoder-decoder also its encoder frames at the dry-run shape (B,
    ``src_len_for(cfg, S)``, d_model)."""
    data = SyntheticLMData(cfg.vocab_size, t.seq_len, t.global_batch, seed)
    if cfg.is_encoder_decoder:
        return SourceFramesData(data, cfg.d_model,
                                src_len_for(cfg, t.seq_len))
    return data


def train(cfg, t: TrainSpec, *, seed: int, device, run: RunConfig = None,
          state=None, log=print) -> Dict:
    """Run ``t.total_steps`` steps from a fresh state (or ``state``) on
    the batches of :func:`batches_of`;
    returns ``{"state", "metrics": [per-step floats], "seconds",
    "steps_per_s", "tokens_per_s"}``.  The clock starts after the first
    step has been issued and synchronised, so it leaves out the kernels'
    build and the first step's warm-up (``first_step_s``).  Metrics reach
    the host only at logged steps and at the end, so steps queue on the
    device without waiting for each other."""
    check_train_spec(t)
    if cfg.is_moe:
        check_row_length(cfg, t.seq_len)
    dev = resolve_device(device)
    run = run or run_config_of(t, cfg.name.removesuffix("-reduced"))
    ctx = Ctx(device=dev, dtype=torch.float32 if t.reduced
              else torch.bfloat16)
    if state is None:
        state = init_train_state(cfg, seed=seed, run=run, device=dev)
    data = batches_of(cfg, t, seed)
    step = make_train_step(cfg, ctx, run)
    metrics: List[Dict[str, torch.Tensor]] = []
    start = int(state["step"])
    t0 = time.perf_counter()
    first_s = None
    for i in range(start, start + t.total_steps):
        state, m = step(state, data.batch_at(i, dev))
        metrics.append(m)
        if i == start:
            _sync(dev)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        if (i - start) % t.log_every == 0 or i == start + t.total_steps - 1:
            aux = f"  aux {float(m['aux']):.6f}" if cfg.is_moe else ""
            log(f"  step {i:5d}  loss {float(m['loss']):.4f}{aux}  gnorm "
                f"{float(m['grad_norm']):.3f}  lr {float(m['lr']):.2e}")
    _sync(dev)
    secs = time.perf_counter() - t0
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    timed = t.total_steps - 1
    out = {"state": state, "metrics": metrics, "first_step_s": first_s,
           "seconds": secs, "timed_steps": timed}
    if timed > 0:
        out["steps_per_s"] = timed / secs
        out["tokens_per_s"] = timed * t.global_batch * t.seq_len / secs
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    t = spec_of(args)
    cfg = config_of(args.arch, reduced=t.reduced, layers=args.layers)
    if cfg.is_encoder_decoder:
        raise SystemExit(
            f"{args.arch} is an encoder-decoder: the reference's train CLI "
            "feeds it tokens and labels only and stops at the missing "
            "src_embeds (ROADMAP R9); train it through "
            "repro_torch.launch.train.train, whose batch source adds them")
    dev = resolve_device(args.device)
    n = count_params(cfg, include_embed=True)
    run = run_config_of(t, args.arch)
    cut = f" (cut to {cfg.num_layers} layers)" if args.layers else ""
    print(f"[train] arch={cfg.name}{cut} params={n / 1e6:.1f}M "
          f"device={dev} batch={t.global_batch} seq={t.seq_len} "
          f"microbatches={t.num_microbatches} remat={t.remat_policy} "
          f"master={run.master_dtype} moments={run.opt_dtype}")
    r = train(cfg, t, seed=args.seed, device=dev, run=run)
    rate = (f"{r['steps_per_s']:.3f} steps/s, {r['tokens_per_s']:.0f} "
            f"tokens/s over the last {r['timed_steps']} steps"
            if "steps_per_s" in r else "one step: no rate")
    print(f"[train] {t.total_steps} steps; first {r['first_step_s']:.2f} s, "
          f"{rate}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
