#!/usr/bin/env python3
"""Wall seconds of ``chip_smoke.py``'s serving phases of rwkv6-7b,
recurrentgemma-9b and deepseek-v2-236b (each: the build, a warm-up, the
served workload, the traced windows and the fp32 cuda-vs-cpu parity) in
one checkout, and each phase's parity alone, on one card.

    mkdir -p build/ab/parent
    git archive <rev> | tar -x -C build/ab/parent
    python3 tools/serving_phase_times.py --root build/ab/parent
    python3 tools/serving_phase_times.py --root .

Run both in one chip call to compare two checkouts' phases on the same
card.  The checkout at ``--root`` supplies its own ``chip_smoke.py`` and
``repro_torch`` (its kernels built into its own ``build/``); no parity
worker runs beside the phases, so they are not slowed by one as in the
smoke.  Prints a ``[phase-time]`` line a phase.
"""
import argparse
import gc
import importlib.util
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="a checkout holding chip_smoke.py and src/")
    args = ap.parse_args()
    sys.path.insert(0, args.root + "/src")
    spec = importlib.util.spec_from_file_location(
        "smoke", args.root + "/chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["smoke"] = cs
    spec.loader.exec_module(cs)
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("serving_phase_times: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    parity_s = {}
    parity_run = cs.parity_run

    def timed(cfg, *a, **kw):
        t = time.perf_counter()
        out = parity_run(cfg, *a, **kw)
        parity_s[cfg.name] = time.perf_counter() - t
        return out

    cs.parity_run = timed
    dev = torch.device("cuda", 0)
    for name in ("run_rwkv_phase", "run_recurrentgemma_phase",
                 "run_deepseek_phase"):
        t = time.perf_counter()
        getattr(cs, name)(dev, 0)
        print(f"[phase-time] {args.root} {name} "
              f"{time.perf_counter() - t:.1f} s; parity {parity_s}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
