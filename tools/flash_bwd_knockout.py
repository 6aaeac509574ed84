#!/usr/bin/env python3
"""Where the flash backward's hd-256 dK/dV pass spends its time, on one
card: knock-out copies of ``src/repro_torch/csrc/flash_attention_bwd.cu``
with parts removed, timed beside the kernel itself.

    python3 tools/flash_bwd_knockout.py

Each variant replaces marker text of the source (timing only: its
outputs are wrong): ``no_qdo_loads`` the producer's Q and dO boxes of
every ring stage (the statistics still load, so the ring still turns),
``no_hand_waits`` the consumers' waits on the P^T handover buffers,
``no_exp`` consumer 0's exponentials and mask, ``no_score_products`` the
two score products (S^T = K Q^T, dP^T = V dO^T), ``no_grad_products``
the two register-A products (dV += P^T dO, dK += dS^T Q),
``no_products`` all four and ``no_products_no_loads`` all four and the
Q/dO boxes.  Every variant is built with ``nvcc`` into
``build/flash_bwd_knockout/`` (the flags of ``kernels/_build.py``, all at
once), loaded with ``ctypes`` and launched through the same C interface
at recurrentgemma-9b's training shape ((t6): B 1, S 4,096, 16 q heads
over one kv head of 256, window 2,048, causal, bf16) with the plan of
``kernels/flash_attention.py:flash_bwd_plan``.  Device time by part (the
dQ kernel, the dK/dV kernel, the partials' sum) is torch.profiler's over
20 calls, L2-warm, in two rounds, the second in reverse order.  A marker
whose text is no longer in the source stops the script.  The last line is
one JSON object of the numbers.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_bwd_knockout"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (marker text, its replacement)
LOADS = [("mbar_expect_tx(full(s), ST_BYTES + BR * 8);",
          "mbar_expect_tx(full(s), BR * 8);"),
         ("for (int prt = 0; prt < BR / QBOX; ++prt) {",
          "for (int prt = 0; prt < (Tile::SPLIT ? 0 : BR / QBOX); ++prt) {")]
HAND = [("mbar_wait(hand_full(hb), hpar);", ""),
        ("mbar_wait(hand_empty(hb), hpar ^ 1);", "")]
EXP = [("""          if (mask)
            p_cols<true, NS>(sv, st, a.sc, col0, lo, hi);
          else
            p_cols<false, NS>(sv, st, a.sc, col0, lo, hi);""",
        "(void)mask; (void)col0;")]
SCORES = [("ss_tile<DV, BR>(sv, va, BC, os);   // dP^T = V dO^T",
           "for (int i = 0; i < NS; ++i) sv[i] = 0.f;"),
          ("ss_tile<DQK, BR>(sv, ka, BC, qs);  // S^T = K Q^T",
           "for (int i = 0; i < NS; ++i) sv[i] = 0.f;")]
GRADS = [("rs_tile<DQK, BR>(acc, fa, qs);     // dK += dS^T Q", ";"),
         ("rs_tile<DV, BR>(acc, fa, os);      // dV += P^T dO", ";")]
VARIANTS = {
    "base": [],
    "no_qdo_loads": LOADS,
    "no_hand_waits": HAND,
    "no_exp": EXP,
    "no_score_products": SCORES,
    "no_grad_products": GRADS,
    "no_products": SCORES + GRADS,
    "no_products_no_loads": SCORES + GRADS + LOADS,
}
SHAPE = (1, 4096, 16, 1, 256, 2048)        # B, S, H, K, hd, window


def build() -> dict:
    """Every variant's library path, compiled in parallel; prints the
    dK/dV kernel's registers, stack frame and spills for each."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for marker, repl in subs:
            if text.count(marker) != 1:
                raise SystemExit(f"{name}: marker not found once: {marker!r}")
            text = text.replace(marker, repl)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line \
                    and "dkdv_wgmmaILi256" in line:
                print(f"  {name}: " + " | ".join(
                    x.strip() for x in lines[i + 1:i + 3]), flush=True)
        libs[name] = OUT / f"{name}.so"
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_knockout: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    paths = build()
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.flash_attention_bwd
        fn.argtypes = fa._BWD_SIGNATURES["flash_attention_bwd"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    B, S, H, K, hd, window = SHAPE
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v, do = (torch.randn(B, S, n, hd, device=dev, generator=gen)
                   .to(torch.bfloat16) for n in (H, K, K, H))
    scale = hd ** -0.5
    o, lse = fa.flash_attention_torch(q, k, v, scale=scale, causal=True,
                                      window=window, return_lse=True)
    plan, fields, work = fa.flash_bwd_card_plan(q, k, v, True, window, 0.0)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty(B * H * plan["s_pad"] * 2 + plan["part_floats"],
                          dtype=torch.float32, device=dev)

    def call(fn):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), scratch.data_ptr(), 1, B, S, H, K, hd, hd,
                scale, 1, window, 0.0,
                torch.cuda.current_stream(dev).cuda_stream, fields,
                len(fields), work.data_ptr())
        if rc:
            raise RuntimeError(f"launch failed: status {rc}")

    rounds = []
    for order in (list(libs), list(libs)[::-1]):
        got = {}
        for name in order:
            parts = cs.bwd_parts(cs.device_ms_by_kernel(
                lambda fn=libs[name]: call(fn)))
            got[name] = parts
            print(f"  {name:<22} device ms: "
                  + ", ".join(f"{p} {t:.4f}" for p, t in parts.items()),
                  flush=True)
        rounds.append(got)
    print(json.dumps({"card": card, "shape": dict(zip(
        ("B", "S", "H", "K", "hd", "window"), SHAPE)), "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
