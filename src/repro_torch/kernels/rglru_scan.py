"""RG-LRU linear recurrence: the Hopper kernel and its plain version.

Per channel, with the carry h:

    h_t = exp(log_a_t) · h_{t-1} + b_t,        log_a_t <= 0

The CUDA kernel (``csrc/rglru_scan.cu``) replaces the reference's Pallas
``kernels/rglru_scan.py:_rglru_kernel``.  The TPU walked time blocks of
16 steps as a sequential grid axis with the carry in VMEM.  Here one
thread still owns one (batch, channel), keeps the carry in a register and
walks the steps in order, so a channel's arithmetic does not depend on
how the work is cut; what is cut is how the bytes reach the walk.  A
block owns ``C`` channels of one batch row, and a producer warp keeps a
ring of ``stages`` tiles of ``steps`` x ``C`` of each input in flight in
shared memory (TMA boxes of 3-D tensor maps where every row stride is a
multiple of 16 bytes, else 4-byte ``cp.async`` copies).  Exponential
warps turn each ``log_a`` tile into ``exp(log_a)`` in place, and walk
warps run the chain of fused multiply-adds and stores over it, so that
at a batch of one a walk does not set the pace.
:func:`rglru_plan` picks ``C`` so that the blocks
cover the card's SMs even at a training microbatch of one sequence, and
``steps`` and ``stages`` so that each SM keeps about ``RING_BYTES`` of
loads in flight.  It reads any S: there is no padding to a time block.

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
which cancels.  It is cut as the forward is (:func:`rglru_plan` with
``backward=True``: three input tiles a stage, walked in reverse).
:func:`rglru_scan_bwd_torch` is its plain version, the same arithmetic
in the same order (the kernel fuses the carry's multiply-add).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "rglru_scan_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "rglru_scan_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}

CHANNELS = (128, 64, 32)     # channels a block: the consumers' warps x 32
STAGE_BYTES = 16 * 1024      # a stage's input tiles, at most
RING_BYTES = 96 * 1024       # loads in flight an SM, shared by its blocks
MAX_RESIDENT = 4             # blocks an SM the ring budget is split among
MAX_STAGES = 8               # csrc/rglru_scan.cu: MAX_STAGES
SMEM_BYTES = 232_448         # shared memory a block can use on an H100
ALIGN = 128                  # the kernel aligns its ring to 128 bytes


def stage_bytes(C: int, steps: int, backward: bool) -> int:
    """A stage's bytes: a (steps x C) fp32 tile of each input (log_a and
    b; or log_a, dh and h_{t-1}, whose tile has one spare row)."""
    return ((3 if backward else 2) * steps + (1 if backward else 0)) * C * 4


def rglru_plan(B: int, S: int, R: int, n_sm: int, backward: bool = False,
               aligned: bool = True) -> dict:
    """How the kernel cuts a (B, S, R) scan, from shapes alone.

    ``channels`` (C): the largest of CHANNELS whose B·ceil(R/C) blocks
    reach ``n_sm``, else the smallest (most blocks).  ``steps``: the
    largest power of two up to 64 whose stage fits STAGE_BYTES, and no
    more than S needs.  ``stages``: as many as the SM's share of
    RING_BYTES holds (the blocks an SM runs at once split it), between 2
    and MAX_STAGES, and no more than there are tiles.  ``tma``: whether
    the TMA path takes it (R % 4 == 0, so every row stride is a multiple of
    16 bytes, and the caller's operands ``aligned`` to 16 bytes); else the
    cp.async path.  ``smem``: the block's bytes of dynamic shared memory,
    as the kernel lays them out.  None of this changes a channel's
    arithmetic.  The kernel takes the plan as it is."""
    if min(B, S, R, n_sm) <= 0:
        raise ValueError(f"rglru_plan: B {B}, S {S}, R {R}, n_sm {n_sm}")
    C = next((c for c in CHANNELS if B * -(-R // c) >= n_sm), CHANNELS[-1])
    blocks = B * -(-R // C)
    resident = min(-(-blocks // n_sm), MAX_RESIDENT)
    n_in = 3 if backward else 2
    steps = 64
    while steps > 1 and steps * C * 4 * n_in > STAGE_BYTES:
        steps //= 2
    steps = min(steps, 1 << (S - 1).bit_length())
    stage = stage_bytes(C, steps, backward)
    tiles = -(-S // steps)
    stages = max(2, min(MAX_STAGES, RING_BYTES // resident // stage))
    stages = max(1, min(stages, tiles))
    return dict(channels=C, steps=steps, stages=stages,
                tma=R % 4 == 0 and aligned, blocks=blocks, tiles=tiles,
                grid=(-(-R // C), B), threads=2 * C + 32, stage_bytes=stage,
                smem=ALIGN + stages * stage + 3 * stages * 8)


def _card_plan(t: torch.Tensor, operands, backward: bool) -> dict:
    """:func:`rglru_plan` for ``t``'s shape on its card, with the TMA path
    only where every operand is 16-byte aligned."""
    B, S, R = t.shape
    return rglru_plan(B, S, R, _build.sm_count(t.device), backward,
                      all(x.data_ptr() % 16 == 0 for x in operands))


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
    p = _card_plan(log_a, (log_a, b), False)
    rc = lib.rglru_scan_fwd(
        log_a.data_ptr(), b.data_ptr(),
        None if h0 is None else h0.data_ptr(), out.data_ptr(), B, S, R,
        p["channels"], p["steps"], p["stages"], int(p["tma"]),
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
    p = _card_plan(log_a, (log_a, h, dh), True)
    rc = lib.rglru_scan_bwd(
        log_a.data_ptr(), h.data_ptr(), dh.data_ptr(),
        None if h0 is None else h0.data_ptr(), dlog_a.data_ptr(),
        db.data_ptr(), None if dh0 is None else dh0.data_ptr(), B, S, R,
        p["channels"], p["steps"], p["stages"], int(p["tma"]),
        torch.cuda.current_stream(log_a.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rglru_scan_bwd launch failed: status {rc}")
    return dlog_a, db, dh0
