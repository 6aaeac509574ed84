"""RWKV6 WKV: the Hopper kernel and its plain version.

Per (batch, head), with the (N, N) state S carried through time:

    o_t = r_t · S_{t-1} + (r_t · (u ⊙ k_t)) v_t
    S_t = diag(exp lw_t) S_{t-1} + k_t v_tᵀ,        lw_t <= 0

The CUDA kernel (``csrc/rwkv6_wkv.cu``) replaces the reference's Pallas
``kernels/rwkv6_wkv.py:_wkv_kernel``.  It computes the same chunked form,
in chunks of 8 steps, with its matrix products (the read-out of the
state, the intra-chunk term and the state update) on the tensor cores in
split TF32 (hi + lo, three products for an fp32 operand, two for a bf16
one), and with every decay a product of factors exp(lw) <= 1, so nothing
overflows at any decay.  One thread block owns one (batch, head); TMA
loads stage r, k, v and lw a few chunks ahead straight from the model
layout (B, S, H, N), so there is no fold, transpose or chunk padding, and
steps past a ragged S load as zeros, which leave the state as it was.
``tests/test_torch_rwkv.py`` holds an emulation of its arithmetic on the
CPU.

:func:`wkv6_torch` is the plain PyTorch version: the chunked formulation
of ``_wkv_kernel``, the CPU path and the oracle the kernel is held against
on the card.  It masks the strictly-lower-triangular intra-chunk decays
with ``torch.where`` on the exponent, so the upper triangle, whose
exponent is positive, is never exponentiated (the reference's jnp
``wkv6_chunked`` multiplies an overflowing ``exp`` by 0 there and returns
NaN at strong decays).

A step with k = 0 and lw = 0 (a padding step of a ragged prefill) leaves
the state exactly as it was in both versions.

Training: given ``seg``, both versions also return the state before every
``seg``-th step (:data:`SEG`).  The plain backward :func:`wkv6_bwd_torch`
rebuilds each segment's states from them by the step recurrence and walks
the steps in reverse; its kernel ``csrc/rwkv6_wkv_bwd.cu``
(:func:`wkv6_bwd_cuda`) first scans the segments in reverse for the
state's gradient at each segment's end, then takes every (batch, head,
segment) on its own in the chunked form on the tensor cores.  The
reference has no Pallas backward: it differentiates its jnp
``models/rwkv.py:wkv6_chunked`` with ``jax.grad``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # r, k, v and o
HEAD_SIZES = (16, 32, 64)     # N: a warp per 16 value columns of the state

#: Steps between two of the forward's state checkpoints in training: a
#: multiple of the forward kernel's chunk of 8 and of the backward
#: kernel's chunk of 16, compiled into the backward kernel.  Each segment
#: is one block of the backward, which also writes the state's gradient
#: at every segment's end: two (B, H, ceil(S/SEG), N, N) fp32 buffers,
#: 134 MB each at B 2, S 4,096, H 64, N 64 (537 MB at 16), against a
#: segment's rebuild in shared memory (its four chunk states).
SEG = 64

_SIGNATURES = {
    "wkv6_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "wkv6_bwd": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def wkv6_torch(
    r: torch.Tensor,          # (B, S, H, N)
    k: torch.Tensor,          # (B, S, H, N)
    v: torch.Tensor,          # (B, S, H, N)
    lw: torch.Tensor,         # (B, S, H, N) log-decay <= 0
    u: torch.Tensor,          # (H, N) bonus
    s0: torch.Tensor,         # (B, H, N, N) initial state
    *,
    chunk: int = 32,
    seg: int = 0,
):
    """Chunked WKV6 in fp32 over chunks of ``chunk`` steps (a ragged tail
    is padded with k = 0, lw = 0 steps, which neither read nor write the
    state).  Returns ``(o (B, S, H, N) in r's dtype, s_final (B, H, N, N)
    fp32)``; with ``seg`` also the state before every ``seg``-th step,
    ``(B, H, ceil(S / seg), N, N)`` fp32 (a chunk then ends where a
    segment does)."""
    B, S, H, N = r.shape
    L = chunk
    pad = (-S) % L
    rf, kf, vf, lwf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad))
                       for t in (r, k, v, lw))
    uf = u.float()
    s = s0.float()
    tri = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    tri = tri[None, :, :, None, None]                       # strict i < t
    outs, ckpts = [], []
    c0 = 0
    while c0 < S + pad:
        c1 = c0 + L
        if seg:
            if c0 % seg == 0 and c0 < S:
                ckpts.append(s)
            c1 = min(c1, (c0 // seg + 1) * seg)
        n = c1 - c0
        rc, kc, vc, lwc = (t[:, c0:c1] for t in (rf, kf, vf, lwf))
        clw = lwc.cumsum(dim=1)                             # inclusive
        clw_ex = clw - lwc                                  # exclusive
        o_inter = torch.einsum("blhc,bhcv->blhv", rc * torch.exp(clw_ex), s)
        expo = clw_ex[:, :, None] - clw[:, None]            # (B, t, i, H, N)
        decay = torch.exp(torch.where(tri[:, :n, :n], expo, float("-inf")))
        a = (rc[:, :, None] * kc[:, None] * decay).sum(-1)  # (B, t, i, H)
        bonus = (rc * uf * kc).sum(-1)                      # (B, L, H)
        o_intra = torch.einsum("btih,bihv->bthv", a, vc) \
            + bonus[..., None] * vc
        outs.append(o_inter + o_intra)
        k_dec = kc * torch.exp(clw[:, -1:] - clw)           # prod_{s>i} w_s
        s = torch.exp(clw[:, -1])[..., None] * s \
            + torch.einsum("bihc,bihv->bhcv", k_dec, vc)
        c0 = c1
    o = torch.cat(outs, dim=1)[:, :S].to(r.dtype)
    if seg:
        return o, s, torch.stack(ckpts, dim=2)
    return o, s


def wkv6_bwd_torch(
    r: torch.Tensor,          # (B, S, H, N)
    k: torch.Tensor,          # (B, S, H, N)
    v: torch.Tensor,          # (B, S, H, N)
    lw: torch.Tensor,         # (B, S, H, N) fp32 log-decay <= 0
    u: torch.Tensor,          # (H, N) fp32
    ckpt: torch.Tensor,       # (B, H, ceil(S / SEG), N, N) fp32
    do: torch.Tensor,         # (B, S, H, N) the output's gradient
    ds_fin=None,              # (B, H, N, N) fp32 s_final's gradient; None = 0
):
    """The gradient of WKV6, plain fp32, walking the steps in reverse from
    dS = ds_fin.  Each segment's states S_{t-1} are rebuilt step by step
    from its checkpoint; then, with w = exp(lw) and dS_t the gradient of
    S_t::

        dr_t  = (S_{t-1} + u k_t v_tᵀ) do_t
        dk_t  = dS_t v_t + u r_t (do_t · v_t)
        dv_t  = dS_tᵀ k_t + (r_t · (u k_t)) do_t
        dlw_t = w_t (dS_t ⊙ S_{t-1}) 1
        du   += r_t k_t (do_t · v_t)
        dS_{t-1} = diag(w_t) dS_t + r_t do_tᵀ

    Returns ``(dr, dk, dv)`` in r's dtype, ``dlw`` fp32, ``du (H, N)``
    (summed over the batch) and ``ds0 (B, H, N, N)`` fp32."""
    B, S, H, N = r.shape
    rf, kf, vf, dof = (t.float() for t in (r, k, v, do))
    w = torch.exp(lw.float())
    uf = u.float()
    ds = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) \
        if ds_fin is None else ds_fin.float().clone()
    dr, dk, dv, dlw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((B, H, N), dtype=torch.float32, device=r.device)
    for j in reversed(range(ckpt.shape[2])):
        t0, t1 = j * SEG, min((j + 1) * SEG, S)
        s = ckpt[:, :, j].float()
        prev = []
        for t in range(t0, t1):
            prev.append(s)
            s = w[:, t, :, :, None] * s \
                + kf[:, t, :, :, None] * vf[:, t, :, None, :]
        for t in reversed(range(t0, t1)):
            sp = prev[t - t0]
            rt, kt, vt, dt, wt = (x[:, t] for x in (rf, kf, vf, dof, w))
            dov = (dt * vt).sum(-1, keepdim=True)                  # (B, H, 1)
            dr[:, t] = torch.einsum("bhcv,bhv->bhc", sp, dt) + uf * kt * dov
            dk[:, t] = torch.einsum("bhcv,bhv->bhc", ds, vt) + uf * rt * dov
            dv[:, t] = torch.einsum("bhcv,bhc->bhv", ds, kt) \
                + (rt * uf * kt).sum(-1, keepdim=True) * dt
            dlw[:, t] = wt * (ds * sp).sum(-1)
            du += rt * kt * dov
            ds = wt[..., None] * ds + rt[..., :, None] * dt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw, du.sum(0),
            ds)


def wkv6_cuda(r, k, v, lw, u, s0, *, seg: int = 0):
    """Launch the kernel on the current stream; with ``seg`` it also
    writes the state before every ``seg``-th step and returns it third
    (:func:`wkv6_torch`'s checkpoints).  The caller (``ops``) has checked
    devices, dtypes, shapes and contiguity."""
    lib = _build.load("rwkv6_wkv", _SIGNATURES)
    B, S, H, N = r.shape
    o = torch.empty_like(r)
    s_fin = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    ckpt = torch.empty((B, H, -(-S // seg), N, N), dtype=torch.float32,
                       device=r.device) if seg else None
    rc = lib.wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(),
        DTYPE_CODES[r.dtype], B, S, H, N, seg,
        torch.cuda.current_stream(r.device).cuda_stream)
    if rc:
        raise RuntimeError(f"wkv6_fwd launch failed: status {rc}")
    return (o, s_fin) if ckpt is None else (o, s_fin, ckpt)


def wkv6_bwd_cuda(r, k, v, lw, u, ckpt, do, ds_fin):
    """Launch the backward kernels (``csrc/rwkv6_wkv_bwd.cu``) on the
    current stream; ``ds_fin`` None is a zero gradient.  The caller
    (``ops.wkv6_bwd``) has checked devices, dtypes, shapes, contiguity and
    alignment.  The kernels also write the state's gradient at every
    segment's end (a scratch buffer the size of ``ckpt``) and ``du`` per
    (batch, head, segment), summed here (no atomics: two calls are
    bit-equal)."""
    lib = _build.load("rwkv6_wkv_bwd", _BWD_SIGNATURES)
    B, S, H, N = r.shape
    nseg = ckpt.shape[2]
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlw = torch.empty_like(lw)
    du = torch.empty((B, H, nseg, N), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    dsb = torch.empty_like(ckpt)
    rc = lib.wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), ckpt.data_ptr(), do.data_ptr(),
        None if ds_fin is None else ds_fin.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
        du.data_ptr(), ds0.data_ptr(), dsb.data_ptr(), DTYPE_CODES[r.dtype],
        B, S, H, N, SEG, torch.cuda.current_stream(r.device).cuda_stream)
    if rc:
        raise RuntimeError(f"wkv6_bwd launch failed: status {rc}")
    return dr, dk, dv, dlw, du.sum((0, 2)), ds0
