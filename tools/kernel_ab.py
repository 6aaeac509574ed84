#!/usr/bin/env python3
"""In-turn A/B of the port's WKV6, paged-decode, MLA latent-decode, flash
(forward and backward), WKV6-backward and RG-LRU (forward and backward)
kernels between this checkout and another one (an earlier design), on one
card.

    mkdir -p build/ab/parent
    git archive <rev> | tar -x -C build/ab/parent
    python3 tools/kernel_ab.py --parent build/ab/parent [--kernels K,...]
        [--trace [CELLS]]

Each checkout is driven through its own ``repro_torch`` package: its
wrappers ``ops.wkv6_bshn``, ``ops.paged_decode_bhd``,
``ops.mla_paged_decode_bhd``, ``ops.flash_attention_bshd``,
``ops.flash_attention_bwd``,
``ops.wkv6_bwd``, ``ops.rglru_scan_bsr`` and ``ops.rglru_scan_bwd`` (the
port keeps their signatures), its plain versions,
its forward's state checkpoints at its own ``SEG``, its build of its own CUDA
sources (into that checkout's ``build/``) and, with ``--trace``, its model
and engine.  So nothing here depends on a kernel's C interface.  Every
design runs in a worker process of its own, four in turns: parent, this
checkout, this checkout, parent.  A worker makes the same inputs from a
seed on the card, holds each kernel to its checkout's plain version at
``chip_smoke.py``'s tolerances, and times it with this checkout's
``chip_smoke.py`` helpers: device time (torch.profiler, 20 calls)
L2-warm and L2-cold (a 256 MB write before each call).  ``--kernels``
picks some of wkv6, paged_decode, mla_decode, flash, flash_bwd,
wkv6_bwd, rglru and rglru_bwd (all eight by default); wkv6_bwd is the WKV6 backward at
rwkv6-7b's training shape in bf16 and fp32, from the checkout's forward
with checkpoints, beside that forward's time with and without them;
rglru is the RG-LRU scan at recurrentgemma-9b's training microbatch
((t6): B 1, S 4,096, R 4,096) and serving prefill ((d): B 8, S 2,560),
rglru_bwd its backward at (t6)'s B 1 and at B 2 with an h0, from the
checkout's own forward, each held to the checkout's plain loop at
``chip_smoke.py``'s tolerances; flash is the forward at qwen3-0.6b's
serving prefill (B 4, S 1,024, H 16, K 8, hd 128), the three training
shapes below and granite-moe-1b-a400m's (B 4, S 4,096, H 16, K 8, hd
64), causal, bf16, held to the plain forward at ``chip_smoke.py``'s
tolerances; for these four the outputs' sha256 (the flash backward's
too) is compared across the turns, and whether every turn gave the same
bytes on the same inputs is reported ("bit-equal across checkouts");
flash_bwd is the backward at three training shapes (paper-overhead-100m: B 8, S
1,024, H 12, K 4, hd 64; qwen3-0.6b's train_4k: B 2, S 4,096, H 16, K 8,
hd 128; recurrentgemma-9b's local layers at (t6): B 1, S 4,096, H 16, K
1, hd 256, window 2,048; causal, bf16), each gradient held to the plain
backward at ``chip_smoke.bwd_tol``, with its device ms by part (the dQ
kernel, the dK/dV kernel and, at hd 256, the partials' sum) and SDPA's
backward timed beside it in every turn.  With ``--trace`` it also traces
the serving windows of cells (a), qwen3-0.6b, (c), rwkv6-7b, and (e),
deepseek-v2-236b at 3 layers, as ``chip_smoke.py`` does (one warm-up
window first; ``--trace e`` or ``--trace a,c`` picks cells): each
kernel's device time in the window and the launches a step.  The last
line is one JSON object of the numbers (with ``bit_equal``: for each
RG-LRU and flash row, whether every turn's outputs had the same digest).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 900


KERNELS = ("wkv6", "paged_decode", "mla_decode", "flash", "flash_bwd",
           "wkv6_bwd", "rglru", "rglru_bwd")
SOURCES = {"wkv6": ("rwkv6_wkv",), "paged_decode": ("paged_decode",),
           "mla_decode": ("mla_decode",), "flash": ("flash_attention",),
           "flash_bwd": ("flash_attention_bwd",),
           "wkv6_bwd": ("rwkv6_wkv", "rwkv6_wkv_bwd"),
           "rglru": ("rglru_scan",), "rglru_bwd": ("rglru_scan",)}
# (label, B, S, R, nonzero h0): recurrentgemma-9b's training microbatch
# ((t6): B 1, S 4,096), its serving prefill ((d): B 8, S 2,560) and the
# smoke's "(t6) B2 h0" backward
RGLRU_FWD_SHAPES = (("rglru (t6)", 1, 4096, 4096, False),
                    ("rglru (d)", 8, 2560, 4096, False))
RGLRU_BWD_SHAPES = (("rglru_bwd (t6)", 1, 4096, 4096, False),
                    ("rglru_bwd (t6) B2 h0", 2, 4096, 4096, True))


def digest(*tensors):
    """sha256 of the tensors' bytes (None skipped): two checkouts whose
    outputs on the same inputs have the same digest are bit-equal."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().reshape(-1)
                     .view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def time_rglru(cs, dev, gen):
    """The RG-LRU forward at (t6)'s and (d)'s shapes: held to the
    checkout's plain step loop at ``chip_smoke.RGLRU_TOL``, its output's
    digest, its device ms warm and L2-cold."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg

    rows = {}
    for label, B, S, R, nz in RGLRU_FWD_SHAPES:
        log_a, b, h0 = cs.rglru_inputs(dev, gen, B, S, R, nz, None)
        h = ops.rglru_scan_bsr(log_a, b, h0)
        torch.cuda.synchronize()
        cs.rglru_check(h, rg.rglru_scan_torch(log_a, b, h0), label)
        call = lambda: ops.rglru_scan_bsr(log_a, b, h0)  # noqa: E731
        rows[label] = dict(shape=f"B {B}, S {S}, R {R}, fp32"
                           + (", h0" if nz else ""), digest=digest(h),
                           warm=cs.device_ms(call),
                           cold=cs.cold_device_ms(call))
        del log_a, b, h0, h
        torch.cuda.empty_cache()
    return rows


def time_rglru_bwd(cs, dev, gen):
    """The RG-LRU backward at (t6)'s B 1 and at "(t6) B2 h0", from the
    checkout's own forward: each gradient held to the checkout's plain
    reverse loop at ``chip_smoke.rglru_bwd_tol``, the gradients' digest,
    the device ms warm and L2-cold."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg

    rows = {}
    for label, B, S, R, nz in RGLRU_BWD_SHAPES:
        log_a, b, h0 = cs.rglru_inputs(dev, gen, B, S, R, nz, None)
        dh = torch.randn(B, S, R, device=dev, generator=gen)
        h = ops.rglru_scan_bsr(log_a, b, h0)
        got = ops.rglru_scan_bwd(log_a, h, dh, h0)
        plain = rg.rglru_scan_bwd_torch(log_a, h, dh, h0)
        torch.cuda.synchronize()
        for name, g, p, tol in zip(("dlog_a", "db", "dh0"), got, plain,
                                   cs.rglru_bwd_tol(plain)):
            if p is not None:
                cs.compare(g, p, tol, f"{label} {name}")
        call = lambda: ops.rglru_scan_bwd(log_a, h, dh, h0)  # noqa: E731
        rows[label] = dict(shape=f"B {B}, S {S}, R {R}, fp32"
                           + (", h0" if nz else ""), digest=digest(*got),
                           warm=cs.device_ms(call),
                           cold=cs.cold_device_ms(call))
        del log_a, b, h0, dh, h, got, plain
        torch.cuda.empty_cache()
    return rows
# label: (B, S, H, K, hd, window), causal
BWD_SHAPES = {"paper train": (8, 1024, 12, 4, 64, 0),
              "qwen3 train": (2, 4096, 16, 8, 128, 0),
              "rg train (t6)": (1, 4096, 16, 1, 256, 2048)}
FWD_SHAPES = dict({"qwen3 S1024": (4, 1024, 16, 8, 128, 0),
                   "granite train": (4, 4096, 16, 8, 64, 0)}, **BWD_SHAPES)


def time_flash(cs, dev, gen):
    """The flash forward at FWD_SHAPES: held to the plain forward at the
    smoke's tolerances, its output's digest, its device ms warm and
    L2-cold."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rows = {}
    for label, (B, S, H, K, hd, window) in FWD_SHAPES.items():
        q, k, v = (torch.randn(B, S, n, hd, device=dev,
                               generator=gen).to(torch.bfloat16)
                   for n in (H, K, K))
        kw = dict(scale=hd ** -0.5, causal=True, window=window,
                  logit_cap=0.0)
        out = ops.flash_attention_bshd(q, k, v, **kw)
        plain = fa.flash_attention_torch(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = (cs.FLASH_HD256_VSCALE * v.float().abs().max().item(), 2 ** -7) \
            if hd == 256 else cs.FLASH_TOL["bfloat16"]
        cs.compare(out, plain, tol, f"flash {label}")
        call = lambda: ops.flash_attention_bshd(q, k, v, **kw)  # noqa: E731
        rows["flash " + label] = dict(
            shape=f"B {B}, S {S}, H {H}, K {K}, hd {hd}, bf16, causal"
            + (f", window {window}" if window else ""), digest=digest(out),
            warm=cs.device_ms(call), cold=cs.cold_device_ms(call))
        del q, k, v, out, plain
        torch.cuda.empty_cache()
    return rows


def time_flash_bwd(cs, dev, gen):
    """The flash backward at the training shapes: held to the plain
    backward, then its device ms warm, by part and L2-cold, and SDPA's
    backward."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rows = {}
    for label, (B, S, H, K, hd, window) in BWD_SHAPES.items():
        q, k, v, do = (torch.randn(B, S, n, hd, device=dev,
                                   generator=gen).to(torch.bfloat16)
                       for n in (H, K, K, H))
        kw = dict(scale=hd ** -0.5, causal=True, window=window,
                  logit_cap=0.0)
        o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        used = []
        for name, g, p in zip("qkv", got, plain):
            tol = cs.bwd_tol(p, torch.bfloat16)
            cs.compare(g, p, tol, f"flash bwd {label} d{name}")
            used.append(cs.tol_used(g, p, tol))
        out_digest = digest(*got)
        del got, plain
        call = lambda: ops.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, **kw)
        sdpa_ms, _ = cs.sdpa_backward_ms(q, k, v, do, True, window)
        rows["flash_bwd " + label] = dict(
            shape=f"B {B}, S {S}, H {H}, K {K}, hd {hd}, bf16, causal"
            + (f", window {window}" if window else ""),
            warm=cs.device_ms(call),
            parts=cs.bwd_parts(cs.device_ms_by_kernel(call)),
            cold=cs.cold_device_ms(call), sdpa_ms=sdpa_ms, tol_used=used,
            digest=out_digest)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def time_wkv6(cs, dev, gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv

    r, k, v, lw, u, s0 = cs.wkv_inputs(dev, gen, 8, 1024, 64, 64,
                                       torch.bfloat16, False, None)
    o, s_fin = ops.wkv6_bshn(r, k, v, lw, u, s0)
    plain_o, plain_s = wkv.wkv6_torch(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    cs.wkv_check(o, plain_o, cs.WKV_SCALE["chunked"], torch.bfloat16,
                 "wkv6 o")
    cs.wkv_check(s_fin, plain_s, cs.WKV_SCALE["chunked"], torch.float32,
                 "wkv6 s_fin")
    call = lambda: ops.wkv6_bshn(r, k, v, lw, u, s0)  # noqa: E731
    return {"wkv6": dict(shape="B 8, S 1024, H 64, N 64, bf16",
                         warm=cs.device_ms(call),
                         cold=cs.cold_device_ms(call))}


def time_paged_decode(cs, dev, gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    rows = {}
    B, K, G, hd, ps, pps = 8, 8, 2, 128, 128, 9
    q, kp, vp, table, pos = cs.decode_inputs(
        dev, gen, B, K, G, hd, ps, pps, torch.bfloat16,
        [1055, 700, 1023, -1, 512, 127, 128, 900])
    qm = q.reshape(B, 1, K * G, hd)
    kw = dict(scale=hd ** -0.5, logit_cap=0.0)
    plain = pa.paged_decode_torch(q, kp, vp, table, pos, **kw)
    for grouped in (True, False):
        out = ops.paged_decode_bhd(qm, kp, vp, table, pos, grouped=grouped,
                                   **kw).reshape(B, K, G, hd)
        torch.cuda.synchronize()
        cs.compare(out, plain, cs.DECODE_TOL["bfloat16"],
                   f"paged decode grouped={grouped}")
        call = lambda g=grouped: ops.paged_decode_bhd(  # noqa: E731
            qm, kp, vp, table, pos, grouped=g, **kw)
        rows["paged_decode" + ("" if grouped else "_per_head")] = dict(
            shape="B 8, K 8, G 2, hd 128, page 128, bf16, ragged",
            warm=cs.device_ms(call), cold=cs.cold_device_ms(call))
    return rows


def time_mla_decode(cs, dev, gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    q, ckv, krope, table, pos = cs.mla_inputs(
        dev, gen, 8, 128, 128, 9, torch.bfloat16, torch.bfloat16,
        [1055, 700, 1023, -1, 512, 127, 128, 900])
    kw = dict(scale=(128 + 64) ** -0.5)      # deepseek-v2: (nope + rd)^-0.5
    out = ops.mla_paged_decode_bhd(q, ckv, krope, table, pos, **kw)
    plain = pa.mla_paged_decode_torch(q, ckv, krope, table, pos, **kw)
    torch.cuda.synchronize()
    cs.compare(out, plain, cs.DECODE_TOL["bfloat16"], "mla decode")
    call = lambda: ops.mla_paged_decode_bhd(  # noqa: E731
        q, ckv, krope, table, pos, **kw)
    return {"mla_decode": dict(
        shape="B 8, H 128, lora 512, rd 64, page 128, bf16, ragged",
        warm=cs.device_ms(call), cold=cs.cold_device_ms(call))}


def time_wkv6_bwd(cs, dev, gen):
    """The WKV6 backward at rwkv6-7b's training shape (B 2, S 4,096, H 64,
    N 64) in bf16 and fp32, from the checkout's own forward with
    checkpoints every ``SEG`` steps of that checkout: each gradient held
    to the checkout's plain backward at ``chip_smoke.wkv_bwd_tol``, then
    the backward's device ms warm and L2-cold and the forward's with and
    without checkpoints."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv

    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        B, S, H, N = 2, 4096, 64, 64
        r, k, v, lw, u, s0 = cs.wkv_inputs(dev, gen, B, S, H, N, dt, False,
                                           None)
        do = torch.randn(B, S, H, N, device=dev, generator=gen).to(dt)
        _, _, ck = wkv.wkv6_cuda(r, k, v, lw, u, s0, seg=wkv.SEG)
        got = ops.wkv6_bwd(r, k, v, lw, u, ck, do)
        plain = wkv.wkv6_bwd_torch(r, k, v, lw, u, ck, do)
        torch.cuda.synchronize()
        used = []
        for name, g, p, tol in zip(("dr", "dk", "dv", "dlw", "du", "ds0"),
                                   got, plain, cs.wkv_bwd_tol(
                                       plain, dt,
                                       cs.wkv_du_terms(r, k, v, do))):
            cs.compare(g, p, tol, f"wkv6 bwd {name}")
            used.append(cs.tol_used(g, p, tol))
        del got, plain
        call = lambda: ops.wkv6_bwd(r, k, v, lw, u, ck, do)  # noqa: E731
        name = cs.dtype_name(dt)
        rows[f"wkv6_bwd {name}"] = dict(
            shape=f"B {B}, S {S}, H {H}, N {N}, {name}, checkpoints every "
            f"{wkv.SEG} steps", warm=cs.device_ms(call),
            cold=cs.cold_device_ms(call), tol_used=used,
            fwd_ckpt=cs.device_ms(lambda: wkv.wkv6_cuda(
                r, k, v, lw, u, s0, seg=wkv.SEG)),
            fwd=cs.device_ms(lambda: wkv.wkv6_cuda(r, k, v, lw, u, s0)))
        del r, k, v, lw, u, s0, do, ck
        torch.cuda.empty_cache()
    return rows


TIMERS = {"wkv6": time_wkv6, "paged_decode": time_paged_decode,
          "mla_decode": time_mla_decode, "flash": time_flash,
          "flash_bwd": time_flash_bwd,
          "wkv6_bwd": time_wkv6_bwd, "rglru": time_rglru,
          "rglru_bwd": time_rglru_bwd}


def time_kernels(cs, dev, kernels):
    """Each kernel of ``kernels`` at its serving or training shape: held
    to the plain version, then its device ms warm and L2-cold."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    for name in KERNELS:
        if name in kernels:
            rows.update(TIMERS[name](cs, dev, gen))
    return rows


CELLS = {"a": ("qwen3-0.6b", None), "c": ("rwkv6-7b", None),
         "e": ("deepseek-v2-236b", 3)}        # arch, layers (None: all)


def trace_cells(cs, dev, cells):
    """Traced serving windows of ``cells`` with the checkout's model,
    engine and kernels, after one warm-up window each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    out = {}
    for cell in cells:
        arch, layers = CELLS[cell]
        cfg = dataclasses.replace(get_config(arch), cache_layout="paged",
                                  page_size=128)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        model = build_model(cfg, device=dev, seed=0)
        cs.trace_serving(cfg, model, dev, 0)                 # warm-up
        print(f"[cell ({cell}) {arch}]", flush=True)
        out[cell] = cs.trace_serving(cfg, model, dev, 0)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def worker(tree: Path, kernels: list, cells: str) -> int:
    """One turn: this process imports ``tree``'s ``repro_torch``."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    here = Path(repro_torch.__file__).resolve()
    if tree.resolve() not in here.parents:
        raise RuntimeError(f"repro_torch came from {here}, not {tree}")
    sys.path.append(str(ROOT))                 # this checkout's helpers
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build

    _build.build(tuple(sorted({n for k in kernels for n in SOURCES[k]})))
    dev = torch.device("cuda", 0)
    result = {"kernels": time_kernels(cs, dev, kernels)}
    for name, row in result["kernels"].items():
        print(f"  {name} ({row['shape']}): device {cs.fmt_ms(row['warm'])} "
              f"ms, L2-cold {cs.fmt_ms(row['cold'])} ms"
              + (f", SDPA's backward {cs.fmt_ms(row['sdpa_ms'])} ms"
                 if "sdpa_ms" in row else "")
              + ("; device by part " + ", ".join(
                  f"{n} {t:.4f}" for n, t in row["parts"].items())
                 if "parts" in row else "")
              + (f"; the forward {cs.fmt_ms(row['fwd'])} ms, with "
                 f"checkpoints {cs.fmt_ms(row['fwd_ckpt'])} ms"
                 if "fwd_ckpt" in row else ""), flush=True)
    if cells:
        result["trace"] = trace_cells(cs, dev, cells.split(","))
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked checkout of the design to compare "
                    "with (git archive <rev>)")
    ap.add_argument("--trace", nargs="?", const="a,c,e", default="",
                    help="also trace the serving windows of these cells "
                    "(comma-separated of a, c, e; all three if none given)")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated of " + ", ".join(KERNELS)
                    + " (all by default)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if any(c not in CELLS for c in filter(None, args.trace.split(","))):
        ap.error(f"--trace takes cells of {sorted(CELLS)}")
    kernels = [k for k in args.kernels.split(",") if k]
    if not kernels or any(k not in KERNELS for k in kernels):
        ap.error(f"--kernels takes some of {', '.join(KERNELS)}")
    if args.worker is not None:
        return worker(args.worker, kernels, args.trace)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if not (args.parent / "src" / "repro_torch").is_dir():
        print(f"kernel_ab: {args.parent} holds no src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.append(str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    turns = []
    for name in ("parent", "new", "new", "parent"):
        tree = args.parent if name == "parent" else ROOT
        print(f"[turn {len(turns) + 1}: {name}, {tree}]", flush=True)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--parent",
               str(args.parent), "--worker", str(tree),
               "--kernels", ",".join(kernels)]
        if args.trace:
            cmd.append(f"--trace={args.trace}")
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=WORKER_TIMEOUT_S)
        print(p.stdout, end="", flush=True)
        if p.returncode:
            print(p.stderr[-4000:], file=sys.stderr)
            print(f"kernel_ab: the {name} worker failed "
                  f"(exit {p.returncode})", file=sys.stderr)
            return 1
        turns.append(dict(design=name, **json.loads(
            p.stdout.strip().splitlines()[-1])))
    # outputs on the same inputs (the same draws of the generator in every
    # turn), compared across the turns by digest
    equal = {}
    for row in turns[0]["kernels"]:
        got = {t["kernels"][row].get("digest") for t in turns}
        if None not in got:
            equal[row] = len(got) == 1
            print(f"  {row}: outputs bit-equal across checkouts: "
                  f"{'yes' if equal[row] else 'NO'}", flush=True)
    print(json.dumps({"card": card, "turns": turns, "bit_equal": equal}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
