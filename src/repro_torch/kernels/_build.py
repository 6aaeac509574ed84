"""Build and load the CUDA sources under ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``.  Libraries go to ``build/repro_torch_kernels/`` at the root of
the checkout, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built when
a module is imported: the first launch builds what it needs, and
:func:`build` compiles several sources at once (one ``nvcc`` each, all
started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "mla_decode",
           "paged_decode", "rglru_scan", "rwkv6_wkv", "rwkv6_wkv_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}
_sm_counts: Dict[int, int] = {}


def sm_count(device) -> int:
    """The SM count of ``device``'s card, queried once per device (the
    kernels' plans size their grids by it)."""
    import torch
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit was not found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet; returns
    each compiled source's ``nvcc`` output (registers, shared memory and
    spills from ``-Xptxas -v``).  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[tuple] = []
    logs: Dict[str, str] = {}
    try:
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs.append((name, target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, target, tmp, proc in jobs:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            logs[name] = out
            (BUILD_DIR / f"{name}.log").write_text(out)
            if proc.returncode:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return logs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each exported function to its ``argtypes``; every
    function returns an ``int`` status (0 = launched)."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
