#!/usr/bin/env python3
"""How close the WKV6 backward kernel's du comes to an exact du at S 1,
in this checkout and in another one (an earlier design), on one card.

    mkdir -p build/ab/parent
    git archive <rev> | tar -x -C build/ab/parent
    python3 tools/wkv_du_precision.py --parent build/ab/parent [--draws N]

At S 1, du = r ⊙ k (dO · v) summed over the batch: a dot product over the
value channels that can cancel.  Each checkout runs in a worker process of
its own (its ``repro_torch``, its build of its own CUDA sources) and
draws the same ``--draws`` cases (300 by default) of ``chip_smoke.py``'s
fp32 S 1 case of the WKV6 backward (B 1, H 4, N 64, nonzero s0 and
ds_final, the smoke's ``wkv_inputs`` from one generator seeded 1).  For
each it reports:

* how many draws put du past the smoke's tolerance against the plain
  backward (``chip_smoke.wkv_bwd_tol``: 1e-5 of the head's largest |du|
  + 1e-6 + 2·gamma_{N+3} times the root-sum-square of its terms' summed
  magnitudes) and the worst share of it, and the same for the share of
  the head's largest |du| alone (the allowance before the rounding term);
* the largest |du - du_exact| over the summed magnitudes of du's terms,
  for the kernel and for the plain backward, du_exact computed in fp64.

The last line is one JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 900


def worker(tree: Path, draws: int) -> int:
    """One checkout: this process imports ``tree``'s ``repro_torch``."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    here = Path(repro_torch.__file__).resolve()
    if tree.resolve() not in here.parents:
        raise RuntimeError(f"repro_torch came from {here}, not {tree}")
    sys.path.append(str(ROOT))                 # this checkout's helpers
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import rwkv6_wkv as wkv

    _build.build(("rwkv6_wkv", "rwkv6_wkv_bwd"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    past, used_max, kernel_rel, plain_rel = 0, 0.0, 0.0, 0.0
    past_share, share_max = 0, 0.0
    for _ in range(draws):
        r, k, v, lw, u, s0 = cs.wkv_inputs(dev, gen, 1, 1, 4, 64,
                                           torch.float32, True, None)
        do = torch.randn(1, 1, 4, 64, device=dev, generator=gen)
        dsf = 0.3 * torch.randn(1, 4, 64, 64, device=dev, generator=gen)
        _, _, ck = wkv.wkv6_cuda(r, k, v, lw, u, s0, seg=wkv.SEG)
        got = ops.wkv6_bwd(r, k, v, lw, u, ck, do, dsf)[4]
        plain_all = wkv.wkv6_bwd_torch(r, k, v, lw, u, ck, do, dsf)
        plain = plain_all[4]
        allowance = cs.wkv_bwd_tol(plain_all, torch.float32,
                                   cs.wkv_du_terms(r, k, v, do))[4][0]
        legacy = cs.WKV_BWD_TOL["float32"][0] * plain.abs().amax(
            -1, keepdim=True) + cs.WKV_BWD_NOISE
        used = float(((got - plain).abs() / allowance).max())
        past += used > 1
        used_max = max(used_max, used)
        share = float(((got - plain).abs() / legacy).max())
        past_share += share > 1
        share_max = max(share_max, share)
        d = lambda t: t.double()  # noqa: E731
        exact = (d(r) * d(k) * (d(do) * d(v)).sum(-1, keepdim=True)).sum(
            (0, 1))
        terms = (d(r).abs() * d(k).abs()
                 * (d(do) * d(v)).abs().sum(-1, keepdim=True)).sum((0, 1))
        kernel_rel = max(kernel_rel,
                         float(((d(got) - exact).abs() / terms).max()))
        plain_rel = max(plain_rel,
                        float(((d(plain) - exact).abs() / terms).max()))
    result = dict(draws=draws, past_tolerance=past, worst_tol_used=used_max,
                  past_share_alone=past_share, worst_share_used=share_max,
                  kernel_vs_exact=kernel_rel, plain_vs_exact=plain_rel)
    print(f"  {draws} draws: {past} past the smoke's tolerance (worst "
          f"{used_max:.3f} of it; {past_share} past its share of the head's "
          f"largest |du| alone, worst {share_max:.3f}); |du - du_exact| / "
          f"sum |terms| at most {kernel_rel:.3g} (kernel), {plain_rel:.3g} "
          f"(plain)", flush=True)
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked checkout of the design to compare "
                    "with (git archive <rev>)")
    ap.add_argument("--draws", type=int, default=300)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.worker, args.draws)
    import torch
    if not torch.cuda.is_available():
        print("wkv_du_precision: no CUDA device", file=sys.stderr)
        return 2
    if not (args.parent / "src" / "repro_torch").is_dir():
        print(f"wkv_du_precision: {args.parent} holds no src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.append(str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    out = {}
    for name in ("parent", "new"):
        tree = args.parent if name == "parent" else ROOT
        print(f"[{name}, {tree}]", flush=True)
        p = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--parent",
             str(args.parent), "--worker", str(tree), "--draws",
             str(args.draws)], capture_output=True, text=True,
            timeout=WORKER_TIMEOUT_S)
        print(p.stdout, end="", flush=True)
        if p.returncode:
            print(p.stderr[-4000:], file=sys.stderr)
            print(f"wkv_du_precision: the {name} worker failed (exit "
                  f"{p.returncode})", file=sys.stderr)
            return 1
        out[name] = json.loads(p.stdout.strip().splitlines()[-1])
    print(json.dumps({"card": card, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
