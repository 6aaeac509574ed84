#!/usr/bin/env python3
"""Where the MLA latent decode kernel's time goes, on one card: knock-out
copies of ``src/repro_torch/csrc/mla_decode.cu`` with one phase removed,
timed beside the kernel itself.

    python3 tools/mla_knockout.py

Each variant is the source with one edit (timing only: its outputs are
wrong): ``no_s`` skips the score product, ``no_pv`` the P·V product,
``no_s_no_pv`` both, ``no_merge`` the cluster merge of the ranges (the
barriers stay), ``empty`` returns at once (launch and block scheduling
alone).  Every variant is built with ``nvcc`` into ``build/mla_knockout/``
(the flags of ``kernels/_build.py``), loaded with ``ctypes`` and launched
through the same C interface with the plan the wrapper uses, at
deepseek-v2's serving shape (B 8, H 128, lora 512, rd 64, page 128, bf16)
over four tables: the smoke's ragged positions ("serving"), every row
near 1K keys ("full"), one tile a row ("one tile") and rows to 8K keys
("long").  Device time is ``chip_smoke.device_ms`` (torch.profiler, 20
calls, L2-warm).  Then the kernel itself over the cluster sizes 4, 6 and 8
at "serving" and "full", and the card's capacity for clusters of each
size.  An edit whose text is no longer in the source stops the script.
The last line is one JSON object of the numbers.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mla_knockout"

# variant: (text in the source, its replacement)
QK = ("                                           uint32_t kb) {\n"
      "#pragma unroll\n  for (int ks = 0;")
PV = "                                           uint32_t kb, int c) {\n"
MERGE = ("                             int bar, TO* out, int rows_valid) {\n"
         "  using ML = MlLayout<ROWS>;\n")
ENTRY = ("                 float sc) {\n"
         "  extern __shared__ unsigned char smem_raw[];\n")


def early_return(after: str) -> tuple:
    head, _, tail = after.partition("\n")
    return after, f"{head}\n  return;\n{tail}"


VARIANTS = {
    "base": [],
    "no_s": [early_return(QK)],
    "no_pv": [early_return(PV)],
    "no_s_no_pv": [early_return(QK), early_return(PV)],
    "no_merge": [early_return(MERGE)],
    "empty": [early_return(ENTRY)],
}
TABLES = {
    "serving": [1055, 700, 1023, -1, 512, 127, 128, 900],
    "full": [1050, 1040, 1030, 1020, 1010, 1000, 990, 980],
    "one tile": [20, 25, 30, 31, 28, 27, 26, 29],
    "long": [8191, 5000, 8000, -1, 3000, 127, 2048, 6500],
}


def build(kb) -> dict:
    """Every variant's library, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (kb.CSRC / "mla_decode.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"mla_knockout: variant {name}: the text "
                                 f"{old[:50]!r} is not in the source")
            text = text.replace(old, new, 1)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=kb.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise SystemExit(f"mla_knockout: {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mla_knockout: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.append(str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa

    card = cs.card_line()
    print(card, flush=True)
    libs = build(_build)
    for lib in libs.values():
        for fn, argtypes in pa._MLA_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf16 = torch.bfloat16
    scale = (128 + 64) ** -0.5
    inputs = {name: cs.mla_inputs(dev, gen, 8, 128, 128,
                                  64 if name == "long" else 9, bf16, bf16,
                                  pos)
              for name, pos in TABLES.items()}

    def launch(lib, q, ckv, krope, table, pos, plan):
        out = torch.empty(q.shape[:2] + (512,), dtype=bf16, device=dev)
        rc = lib.mla_decode_fwd(
            q.data_ptr(), ckv.data_ptr(), krope.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(), 1, 1,
            q.shape[0], q.shape[1], 512, 64, ckv.shape[1], table.shape[1],
            ckv.shape[0], plan["ht"], plan["n_split"], plan["tpr"],
            plan["ntp"], plan["stages"], plan["cols"], *plan["offs"],
            plan["smem"], scale, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"mla_decode_fwd: status {rc}")
        return out

    result = {"card": card, "variants": {}, "cluster_sizes": {}}
    for name, lib in libs.items():
        row = {}
        for table, args in inputs.items():
            plan = pa.mla_card_plan(*args[:4])
            row[table] = cs.device_ms(lambda: launch(lib, *args, plan))
        result["variants"][name] = row
        print(f"  {name:<11} " + "  ".join(
            f"{t} {cs.fmt_ms(ms)}" for t, ms in row.items()), flush=True)
    for table in ("serving", "full"):
        args = inputs[table]
        plan = pa.mla_card_plan(*args[:4])
        tiles = plan["ntp"] * args[3].shape[1]
        row = {}
        for n in (4, 6, 8):
            tpr = -(-tiles // n)
            k = -(-tiles // tpr)
            cols, stages, offs, smem = pa._mla_layout(True, 64, tpr, k, 2,
                                                      512, 64)
            p = dict(plan, n_split=k, tpr=tpr, cols=cols, stages=stages,
                     offs=offs, smem=smem)
            row[n] = cs.device_ms(lambda: launch(libs["base"], *args, p))
        result["cluster_sizes"][table] = dict(plan=plan["n_split"], ms=row)
        print(f"  {table}: plan {plan['n_split']} ranges of {plan['tpr']} "
              "tiles; by cluster size " + ", ".join(
                  f"{n}: {cs.fmt_ms(ms)}" for n, ms in row.items()),
              flush=True)
    result["cluster_slots"] = {f"{k[3]} blocks of {k[4]} B": v
                               for k, v in pa._cluster_slots.items()
                               if k[1:3] == (1, 1)}
    print(f"  clusters the card holds: {result['cluster_slots']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
