"""RG-LRU linear recurrence: the Hopper kernel and its plain version.

Per channel, with the carry h:

    h_t = exp(log_a_t) · h_{t-1} + b_t,        log_a_t <= 0

The CUDA kernel (``csrc/rglru_scan.cu``) replaces the reference's Pallas
``kernels/rglru_scan.py:_rglru_kernel``.  The TPU walked time blocks of
16 steps as a sequential grid axis with the carry in VMEM; here one
thread owns one (batch, channel), keeps the carry in a register and walks
the steps in order, loading 16 steps of ``log_a`` and ``b`` at a time
(neighbouring threads read neighbouring channels, so loads coalesce).  It
reads any S: there is no padding to a time block.

:func:`rglru_scan_torch` is the plain PyTorch version: the step loop of
``ref.rglru_ref``, the same arithmetic in the same order as the kernel
(the kernel fuses the multiply-add), the CPU path and the oracle the kernel
is held against on the card.  A padding step (``log_a = 0``, ``b = 0``)
leaves the carry exactly as it was in both.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "rglru_scan_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


def rglru_scan_torch(log_a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step loop in fp32.  log_a/b (B, S, R), h0 (B, R) or ``None``
    (zero state); returns h (B, S, R) fp32."""
    B, S, R = log_a.shape
    h = torch.zeros((B, R), dtype=torch.float32, device=log_a.device) \
        if h0 is None else h0.float()
    out = torch.empty((B, S, R), dtype=torch.float32, device=log_a.device)
    a = torch.exp(log_a.float())
    bf = b.float()
    for t in range(S):
        h = a[:, t] * h + bf[:, t]
        out[:, t] = h
    return out


def rglru_scan_cuda(log_a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on the current stream.  The caller
    (``ops.rglru_scan_bsr``) has checked devices, dtypes, shapes and
    contiguity."""
    lib = _build.load("rglru_scan", _SIGNATURES)
    B, S, R = log_a.shape
    out = torch.empty_like(log_a)
    rc = lib.rglru_scan_fwd(
        log_a.data_ptr(), b.data_ptr(),
        None if h0 is None else h0.data_ptr(), out.data_ptr(), B, S, R,
        torch.cuda.current_stream(log_a.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rglru_scan_fwd launch failed: status {rc}")
    return out
