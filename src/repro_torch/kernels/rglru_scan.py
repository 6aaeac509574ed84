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

The backward (``rglru_scan_bwd`` in the same source) is the gradient of
the scan as ``jax.grad`` takes it of the reference's jnp
``models/recurrent.py:rglru_scan_assoc`` when it trains (the reference
has no Pallas backward).  Per channel, walking t in reverse with the
carry g (0 past the last step):

    g_t       = dh_t + exp(log_a_{t+1}) · g_{t+1}
    db_t      = g_t
    dlog_a_t  = g_t · exp(log_a_t) · h_{t-1}      (h_{-1} = h0, or 0)
    dh0       = exp(log_a_0) · g_0

h_{t-1} is read from the forward's output, not rebuilt as h_t - b_t,
which cancels.  One thread owns one (batch, channel) and walks the steps
in reverse as the forward walks them in order.
:func:`rglru_scan_bwd_torch` is its plain version, the same arithmetic
in the same order (the kernel fuses the carry's multiply-add).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "rglru_scan_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "rglru_scan_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
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


def rglru_scan_bwd_torch(log_a: torch.Tensor, h: torch.Tensor,
                         dh: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """The reverse step loop in fp32: ``(dlog_a, db, dh0)`` of
    :func:`rglru_scan_torch` from its inputs, its output ``h`` and the
    output's gradient ``dh`` (all (B, S, R)); ``dh0`` (B, R) is ``None``
    without an ``h0``."""
    B, S, R = log_a.shape
    a = torch.exp(log_a.float())
    hf, dhf = h.float(), dh.float()
    dlog_a = torch.empty((B, S, R), dtype=torch.float32, device=log_a.device)
    db = torch.empty_like(dlog_a)
    g = torch.zeros((B, R), dtype=torch.float32, device=log_a.device)
    h_first = torch.zeros_like(g) if h0 is None else h0.float()
    for t in range(S - 1, -1, -1):
        g = dhf[:, t] + (a[:, t + 1] * g if t + 1 < S else 0.0)
        db[:, t] = g
        h_prev = hf[:, t - 1] if t > 0 else h_first
        dlog_a[:, t] = g * a[:, t] * h_prev
    dh0 = None if h0 is None else a[:, 0] * g
    return dlog_a, db, dh0


def rglru_scan_bwd_cuda(log_a: torch.Tensor, h: torch.Tensor,
                        dh: torch.Tensor, h0: Optional[torch.Tensor]):
    """Launch the backward kernel on the current stream; returns
    ``(dlog_a, db, dh0)``.  The caller (``ops.rglru_scan_bwd``) has
    checked devices, dtypes, shapes and contiguity."""
    lib = _build.load("rglru_scan", _SIGNATURES)
    B, S, R = log_a.shape
    dlog_a = torch.empty_like(log_a)
    db = torch.empty_like(log_a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    rc = lib.rglru_scan_bwd(
        log_a.data_ptr(), h.data_ptr(), dh.data_ptr(),
        None if h0 is None else h0.data_ptr(), dlog_a.data_ptr(),
        db.data_ptr(), None if dh0 is None else dh0.data_ptr(), B, S, R,
        torch.cuda.current_stream(log_a.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rglru_scan_bwd launch failed: status {rc}")
    return dlog_a, db, dh0
