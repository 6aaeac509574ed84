"""Flash attention for prefill: the Hopper kernel and its plain version.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the reference's
Pallas ``kernels/flash_attention.py:_flash_kernel``: blocked online-softmax
attention with GQA (kv head = q head // G), causal and sliding-window
masks, a tanh logit softcap applied before the mask, fp32 (m, l, acc) and
dead kv tiles skipped.  The TPU walked its kv blocks as a sequential grid
axis; here a loop inside the thread block does.  In bf16 a persistent
block per SM walks 128-row q tiles of one (batch, head): a producer
warpgroup loads Q and 128-key kv tiles (64 at hd 256) by TMA into a ring
of shared-memory stages, and two consumer warpgroups of 64 q rows each
run both products as wgmma (fp32 has its own CUDA-core walk, for exact
checks).  Both sides take the model's (B, S, heads, hd) layout directly,
and the kernel masks a ragged S itself, so there is no S % 128 gate and no
transpose.  Head dims 64 and 128 (qwen3, paper-overhead) and 256 (the
local layers of recurrentgemma, 16 q heads over one kv head, window
2,048).

:func:`flash_attention_torch` is the plain PyTorch version of the same
contract (the reference's ``flash_attention_jnp``): the CPU path, and the
oracle the kernel is held against on the card.  With ``return_lse`` both
also give each row's softmax log-sum-exp, which training saves for the
backward.

The backward (``csrc/flash_attention_bwd.cu``) is the gradient of the
reference's ``flash_attention_jnp`` as ``jax.grad`` takes it when the
reference trains; the reference has no Pallas backward.  It recomputes P
from the log-sum-exp and walks key tiles (dK, dV, summed over the G q
heads of a kv head in registers) and q tiles (dQ) in separate launches,
with ``mma.sync`` bf16 products and an fp32 CUDA-core path, no atomics.
:func:`flash_attention_bwd_torch` is its plain version, blockwise in fp32:
the CPU path and the card's oracle.  The backward takes hd 64 and 128
(:data:`BWD_HEAD_DIMS`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128)

_SIGNATURES = {
    "flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p],
}


def _live(S: int, t0: int, t1: int, causal: bool, window: int,
          dev) -> torch.Tensor:
    """(S, t1 - t0) mask of the pairs (query row, key t0..t1-1) that
    attend."""
    pq = torch.arange(S, device=dev)[:, None]
    pk = torch.arange(t0, t1, device=dev)[None, :]
    valid = torch.ones((S, t1 - t0), dtype=torch.bool, device=dev)
    if causal:
        valid = valid & (pk <= pq)
    if window:
        valid = valid & (pq - pk < window)
    return valid


def flash_attention_torch(
    q: torch.Tensor,          # (B, S, H, hd), positions 0..S-1
    k: torch.Tensor,          # (B, S, K, hd)
    v: torch.Tensor,          # (B, S, K, hd)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
    kv_block: int = 64,
    return_lse: bool = False,
):
    """Online-softmax attention in fp32 over kv tiles of ``kv_block`` keys
    (all q rows at once).  Masked probabilities are zeroed explicitly and
    the result is ``acc / max(l, 1e-37)``, as in the kernel.  With
    ``return_lse`` returns ``(out, lse)``, lse (B, H, S) fp32 = m + log
    max(l, 1e-37), the log of the row's sum of exp(score) over live keys."""
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    qg = q.reshape(B, S, K, G, hd).float() * scale
    m = torch.full((B, S, K, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, K, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, K, G, hd), dtype=torch.float32, device=dev)
    for t0 in range(0, Sk, kv_block):
        t1 = min(t0 + kv_block, Sk)
        kc = k[:, t0:t1].float()
        vc = v[:, t0:t1].float()
        s = torch.einsum("bskgd,btkd->bskgt", qg, kc)
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        vm = _live(S, t0, t1, causal, window, dev)[None, :, None, None, :]
        s = torch.where(vm, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(vm, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgt,btkd->bskgd", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]
    out = out.reshape(B, S, H, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = m + torch.log(l.clamp_min(1e-37))
    return out, lse.reshape(B, S, H).permute(0, 2, 1).contiguous()


def flash_attention_bwd_torch(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, S, K, hd)
    v: torch.Tensor,          # (B, S, K, hd)
    o: torch.Tensor,          # (B, S, H, hd) the forward's output
    lse: torch.Tensor,        # (B, H, S) fp32 the forward's log-sum-exp
    do: torch.Tensor,         # (B, S, H, hd) the output's gradient
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
    kv_block: int = 64,
):
    """(dq, dk, dv) in the inputs' dtypes, the kernel's arithmetic in fp32
    over kv tiles of ``kv_block`` keys: P = exp(s - lse) on live pairs, D
    = rowsum(dO o), dV = P^T dO, dS = P (dO V^T - D) (times 1 - tanh^2
    under a softcap), dQ = scale dS K, dK = scale dS^T Q, dK and dV summed
    over the G q heads of each kv head."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    dev = q.device
    qf = q.reshape(B, S, K, G, hd).float()
    dof = do.reshape(B, S, K, G, hd).float()
    lse_g = lse.permute(0, 2, 1).reshape(B, S, K, G)
    delta = (dof * o.reshape(B, S, K, G, hd).float()).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, S, K, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for t0 in range(0, S, kv_block):
        t1 = min(t0 + kv_block, S)
        kc = k[:, t0:t1].float()
        vc = v[:, t0:t1].float()
        s = torch.einsum("bskgd,btkd->bskgt", qf, kc) * scale
        dcap = None
        if logit_cap:
            th = torch.tanh(s / logit_cap)
            s = logit_cap * th
            dcap = 1.0 - th * th
        vm = _live(S, t0, t1, causal, window, dev)[None, :, None, None, :]
        p = torch.where(vm, torch.exp(s - lse_g[..., None]), 0.0)
        dv[:, t0:t1] = torch.einsum("bskgt,bskgd->btkd", p, dof)
        ds = p * (torch.einsum("bskgd,btkd->bskgt", dof, vc)
                  - delta[..., None])
        if dcap is not None:
            ds = ds * dcap
        dq += torch.einsum("bskgt,btkd->bskgd", ds, kc) * scale
        dk[:, t0:t1] = torch.einsum("bskgt,bskgd->btkd", ds, qf) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool,
                         window: int, logit_cap: float,
                         return_lse: bool = False):
    """Launch the kernel on the current stream; with ``return_lse`` also
    the (B, H, S) fp32 log-sum-exp, as ``(out, lse)``.  The caller
    (``ops.flash_attention_bshd``) has checked devices, dtypes, shapes
    and contiguity."""
    lib = _build.load("flash_attention", _SIGNATURES)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        DTYPE_CODES[q.dtype], B, S, H, k.shape[2], hd,
        float(scale), int(causal), int(window), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: status {rc}")
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, scale: float,
                             causal: bool, window: int, logit_cap: float):
    """Launch the backward's three kernels on the current stream; returns
    (dq, dk, dv).  The caller (``ops.flash_attention_bwd``) has checked
    devices, dtypes, shapes, contiguity and alignment."""
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    B, S, H, hd = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), DTYPE_CODES[q.dtype], B, S, H,
        k.shape[2], hd, float(scale), int(causal), int(window),
        float(logit_cap), torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd launch failed: status {rc}")
    return dq, dk, dv
