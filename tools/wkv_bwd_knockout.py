#!/usr/bin/env python3
"""Where the WKV6 backward kernel's time goes, on one card: knock-out
copies of ``src/repro_torch/csrc/rwkv6_wkv_bwd.cu`` with parts removed,
timed beside the kernel itself.

    python3 tools/wkv_bwd_knockout.py

Each variant is the source with parts of pass 2 (``wkv6_bwd_chunks``)
wrapped in ``#ifndef`` and the macro defined (timing only: its outputs are
wrong): ``walk`` the walks that form r ⊙ Pex, k ⊙ Psuf and A within the
chunk's halves, ``walk_pairs`` only A's pairs, ``products`` X, Y, Z, Bm
and A's cross block, ``dv`` the A^T dO product and dv's stores, ``rq``
the R and Q products, ``steps`` the walks that add the pair terms and
write dr, dk and dlw, ``rebuild`` the states' rebuild, ``load`` the
staging of the segment; ``walks`` both walks, and ``skeleton`` everything
but the staging, the barriers and du.  Every variant is built with
``nvcc`` into ``build/wkv_bwd_knockout/`` (the flags of
``kernels/_build.py``, all at once), loaded with ``ctypes`` and launched
through the same C interface at rwkv6-7b's training shape (B 2, S 4,096,
H 64, N 64, bf16, checkpoints from the forward kernel).  Device time per
kernel (pass 1 ``wkv6_bwd_dstate``, pass 2 ``wkv6_bwd_chunks``) is
torch.profiler's over 10 calls, L2-warm, in two rounds.  A marker whose
text is no longer in the source stops the script.  The last line is one
JSON object of the numbers.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "wkv_bwd_knockout"

# part: (the first line of the part, the text that follows its end)
PARTS = {
    "WALK_PAIRS": ("      // A[t][i] within half hh",
                   "    }\n    __syncthreads();\n\n    // (2) all warps"),
    "REBUILD": ("  // -- rebuild the state before every chunk",
                "  cp_async_wait_all();\n  __syncthreads();\n\n"
                "  // -- the chunks in reverse"),
    "WALK": ("    // (1) walks:", "    __syncthreads();\n\n    // (2) all warps"),
    "PRODUCTS": ("    {\n      const float* s0p = sst + ch * N * LD;\n"
                 "      // main products",
                 "    __syncthreads();      // dS1, Bm and A across"),
    "DV": ("      auto a_at = [&](int t, int i) {",
           "      // R (D rows g + 8) and Q"),
    "RQ": ("      // R (D rows g + 8) and Q",
           "      const float* s0p = sst + ch * N * LD;\n      const float pa"),
    "STEPS": ("    switch (part) {", "  }\n  // du: the parts' sums"),
    "LOAD": ("  stage_rows<TI, N>(sk, LD, k + base",
             "  cp_async_commit();\n  stage_rows<TI, N>(sr"),
    "LOAD_REST": ("  stage_rows<TI, N>(sr, LD, r + base",
                  "  cp_async_commit();\n  cp_async_wait<1>();"),
}
VARIANTS = {
    "base": [],
    "walk": ["WALK"],
    "walk_pairs": ["WALK_PAIRS"],
    "products": ["PRODUCTS"],
    "dv": ["DV"],
    "rq": ["RQ"],
    "steps": ["STEPS"],
    "rebuild": ["REBUILD"],
    "load": ["LOAD", "LOAD_REST"],
    "walks": ["WALK", "STEPS"],
    "skeleton": ["WALK", "STEPS", "PRODUCTS", "DV", "RQ", "REBUILD"],
}


def marked_source() -> str:
    """The source with every part between ``#ifndef KO_<part>`` and
    ``#endif``."""
    src = (ROOT / "src/repro_torch/csrc/rwkv6_wkv_bwd.cu").read_text()
    for name in ("WALK_PAIRS", "REBUILD", "WALK", "PRODUCTS", "DV", "RQ",
                 "STEPS", "LOAD", "LOAD_REST"):
        start, end = PARTS[name]
        a = src.find(start)
        b = src.find(end, a)
        if a < 0 or b < 0:
            sys.exit(f"wkv_bwd_knockout: the source has no part {name}")
        macro = "KO_LOAD" if name == "LOAD_REST" else f"KO_{name}"
        src = src[:a] + f"#ifndef {macro}\n" + src[a:b] + "#endif\n" \
            + src[b:]
    return src


def build() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_wkv as wkv
    OUT.mkdir(parents=True, exist_ok=True)
    source = OUT / "rwkv6_wkv_bwd_ko.cu"
    source.write_text(marked_source())
    jobs = {}
    for name, parts in VARIANTS.items():
        target = OUT / f"{name}.so"
        flags = [f"-DKO_{'LOAD' if p == 'LOAD_REST' else p}"
                 for p in parts]
        jobs[name] = (target, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(target),
             str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (target, proc) in jobs.items():
        out, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode:
            sys.exit(f"wkv_bwd_knockout: {name} did not build:\n{out}")
        lib = ctypes.CDLL(str(target))
        lib.wkv6_bwd.argtypes = wkv._BWD_SIGNATURES["wkv6_bwd"]
        lib.wkv6_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("wkv_bwd_knockout: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import rwkv6_wkv as wkv

    libs = build()
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, S, H, N, dt = 2, 4096, 64, 64, torch.bfloat16
    r, k, v, lw, u, s0 = cs.wkv_inputs(dev, gen, B, S, H, N, dt, False,
                                       None)
    do = torch.randn(B, S, H, N, device=dev, generator=gen).to(dt)
    _, _, ck = wkv.wkv6_cuda(r, k, v, lw, u, s0, seg=wkv.SEG)
    nseg = ck.shape[2]
    outs = [torch.empty_like(r) for _ in range(3)] + [
        torch.empty_like(lw), torch.empty(B, H, nseg, N, device=dev),
        torch.empty(B, H, N, N, device=dev), torch.empty_like(ck)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(lib):
        rc = lib.wkv6_bwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          lw.data_ptr(), u.data_ptr(), ck.data_ptr(),
                          do.data_ptr(), None,
                          *(o.data_ptr() for o in outs),
                          wkv.DTYPE_CODES[dt], B, S, H, N, wkv.SEG, stream)
        if rc:
            raise RuntimeError(f"wkv6_bwd launch failed: status {rc}")

    rounds = []
    for _ in range(2):
        times = {}
        for name, lib in libs.items():
            for _ in range(3):
                call(lib)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call(lib)
                torch.cuda.synchronize()
            times[name] = {re.search(r"wkv6_bwd_\w+", e.key)[0]:
                           e.self_device_time_total / 1e3 / 10
                           for e in prof.key_averages()
                           if "wkv6_bwd_" in e.key}
            print(f"  {name:<12} " + ", ".join(
                f"{kname} {ms:.4f} ms" for kname, ms in
                sorted(times[name].items())), flush=True)
        rounds.append(times)
    print(json.dumps({"card": card, "shape": f"B {B}, S {S}, H {H}, N {N}, "
                      "bf16", "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
