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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # r, k, v and o
HEAD_SIZES = (16, 32, 64)     # N: a warp per 16 value columns of the state

_SIGNATURES = {
    "wkv6_fwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
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
):
    """Chunked WKV6 in fp32 over chunks of ``chunk`` steps (a ragged tail
    is padded with k = 0, lw = 0 steps, which neither read nor write the
    state).  Returns ``(o (B, S, H, N) in r's dtype, s_final (B, H, N, N)
    fp32)``."""
    B, S, H, N = r.shape
    L = chunk
    pad = (-S) % L
    rf, kf, vf, lwf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad))
                       for t in (r, k, v, lw))
    uf = u.float()
    s = s0.float()
    tri = torch.ones(L, L, dtype=torch.bool, device=r.device).tril(-1)
    tri = tri[None, :, :, None, None]                       # strict i < t
    outs = []
    for c0 in range(0, S + pad, L):
        rc, kc, vc, lwc = (t[:, c0:c0 + L] for t in (rf, kf, vf, lwf))
        clw = lwc.cumsum(dim=1)                             # inclusive
        clw_ex = clw - lwc                                  # exclusive
        o_inter = torch.einsum("blhc,bhcv->blhv", rc * torch.exp(clw_ex), s)
        expo = clw_ex[:, :, None] - clw[:, None]            # (B, t, i, H, N)
        decay = torch.exp(torch.where(tri, expo, float("-inf")))
        a = (rc[:, :, None] * kc[:, None] * decay).sum(-1)  # (B, t, i, H)
        bonus = (rc * uf * kc).sum(-1)                      # (B, L, H)
        o_intra = torch.einsum("btih,bihv->bthv", a, vc) \
            + bonus[..., None] * vc
        outs.append(o_inter + o_intra)
        k_dec = kc * torch.exp(clw[:, -1:] - clw)           # prod_{s>i} w_s
        s = torch.exp(clw[:, -1])[..., None] * s \
            + torch.einsum("bihc,bihv->bhcv", k_dec, vc)
    o = torch.cat(outs, dim=1)[:, :S]
    return o.to(r.dtype), s


def wkv6_cuda(r, k, v, lw, u, s0):
    """Launch the kernel on the current stream.  The caller
    (``ops.wkv6_bshn``) has checked devices, dtypes, shapes and
    contiguity."""
    lib = _build.load("rwkv6_wkv", _SIGNATURES)
    B, S, H, N = r.shape
    o = torch.empty_like(r)
    s_fin = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    rc = lib.wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
        DTYPE_CODES[r.dtype], B, S, H, N,
        torch.cuda.current_stream(r.device).cuda_stream)
    if rc:
        raise RuntimeError(f"wkv6_fwd launch failed: status {rc}")
    return o, s_fin
