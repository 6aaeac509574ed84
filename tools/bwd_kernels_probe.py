#!/usr/bin/env python3
"""A short first call of the RG-LRU backward and the flash backward at hd
256 on one card: build them (printing ``-Xptxas -v``'s registers, stack
frames and spills), launch each once under a host-side timeout on a CUDA
event (an mbarrier bug would hang the card), hold each to its plain
version (max |kernel - plain| and max |plain| per output, two calls
bit-equal), and time it with CUDA events.

    python3 tools/bwd_kernels_probe.py

RG-LRU backward at B 1 and 2 x S 4,096 x R 4,096 (recurrentgemma's
training microbatch), ragged S 17, 1 and 1,000; flash backward at hd 256
with MQA (G 16) and a window at S 77 and at (t6)'s B 1, S 4,096, window
2,048, around the window (S 2,049), K 8 G 2, in bf16 and fp32, with the
forward's log-sum-exp against the plain one.  The tolerance checks are
``chip_smoke.py``'s; this prints the raw numbers.
"""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402


def guard(what, secs=60):
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.time()
    while not ev.query():
        if time.time() - t0 > secs:
            print(f"HANG in {what}", flush=True)
            os._exit(3)
        time.sleep(0.01)


def ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


t0 = time.time()
logs = _build.build(("rglru_scan", "flash_attention_bwd", "flash_attention"))
print(f"build {time.time() - t0:.1f} s", flush=True)
for name, log in logs.items():
    for line in log.splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line or "stack" in line or "error" in line \
                or "warning" in line.lower():
            print(f"  {name}: {line.strip()}")
dev = torch.device("cuda")
g = torch.Generator(device=dev)
g.manual_seed(0)

# --- RG-LRU backward
for B, S, R, h0 in ((1, 4096, 4096, False), (2, 4096, 4096, True),
                    (2, 17, 100, True), (1, 1, 64, True), (2, 1000, 4096, True)):
    log_a = -torch.rand(B, S, R, device=dev, generator=g) * 3
    b = torch.randn(B, S, R, device=dev, generator=g)
    dh = torch.randn(B, S, R, device=dev, generator=g)
    hz = torch.randn(B, R, device=dev, generator=g) if h0 else None
    h = rg.rglru_scan_cuda(log_a, b, hz)
    got = ops.rglru_scan_bwd(log_a, h, dh, hz)
    guard("rglru bwd")
    again = ops.rglru_scan_bwd(log_a, h, dh, hz)
    plain = rg.rglru_scan_bwd_torch(log_a, h, dh, hz)
    torch.cuda.synchronize()
    errs = []
    for x, y, z in zip(got, again, plain):
        if z is None:
            continue
        errs.append(((x - z).abs().max().item(), z.abs().max().item(),
                     torch.equal(x, y)))
    t = ms(lambda: ops.rglru_scan_bwd(log_a, h, dh, hz))
    print(f"rglru bwd B{B} S{S} R{R} h0 {h0}: {errs} {t:.4f} ms "
          f"bound {20 * B * S * R / 3.35e12 * 1e3:.4f}", flush=True)

# --- flash backward hd 256
for B, S, H, K, dt, window in ((1, 77, 16, 1, torch.bfloat16, 32),
                               (1, 300, 4, 2, torch.bfloat16, 64),
                               (1, 4096, 16, 1, torch.bfloat16, 2048),
                               (1, 2049, 16, 1, torch.bfloat16, 2048),
                               (2, 1000, 16, 8, torch.bfloat16, 2048),
                               (1, 77, 16, 1, torch.float32, 32),
                               (1, 4096, 16, 1, torch.float32, 2048)):
    hd = 256
    q, k, v, do = (torch.randn(B, S, n, hd, device=dev, generator=g).to(dt)
                   for n in (H, K, K, H))
    kw = dict(scale=hd ** -0.5, causal=True, window=window, logit_cap=0.0)
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    _, lse_k = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    guard(f"flash bwd {B} {S} {dt}")
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    res = []
    for x, y, z in zip(got, again, plain):
        res.append((round((x.float() - z.float()).abs().max().item(), 5),
                    round(z.float().abs().max().item(), 4), torch.equal(x, y),
                    bool(torch.isfinite(x).all())))
    t = ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, **kw), 5)
    plan = fa.flash_bwd_card_plan(q, k, v, True, window, 0.0)[0]
    print(f"flash bwd hd256 B{B} S{S} H{H} K{K} {dt} w{window}: {res} "
          f"lse {(lse_k - lse).abs().max().item():.3g} {t:.4f} ms split "
          f"{plan['kv_split']} kv items {len(plan['kv']['items'])}",
          flush=True)
print("probe done")
