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
oracle the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)

_SIGNATURES = {
    "flash_attention_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p],
}


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
) -> torch.Tensor:
    """Online-softmax attention in fp32 over kv tiles of ``kv_block`` keys
    (all q rows at once).  Masked probabilities are zeroed explicitly and
    the result is ``acc / max(l, 1e-37)``, as in the kernel."""
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    qg = q.reshape(B, S, K, G, hd).float() * scale
    m = torch.full((B, S, K, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, K, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, K, G, hd), dtype=torch.float32, device=dev)
    pq = torch.arange(S, device=dev)
    for t0 in range(0, Sk, kv_block):
        t1 = min(t0 + kv_block, Sk)
        kc = k[:, t0:t1].float()
        vc = v[:, t0:t1].float()
        s = torch.einsum("bskgd,btkd->bskgt", qg, kc)
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        pk = torch.arange(t0, t1, device=dev)
        valid = torch.ones((S, t1 - t0), dtype=torch.bool, device=dev)
        if causal:
            valid &= pk[None, :] <= pq[:, None]
        if window:
            valid &= pq[:, None] - pk[None, :] < window
        vm = valid[None, :, None, None, :]
        s = torch.where(vm, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(vm, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgt,btkd->bskgd", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool,
                         window: int, logit_cap: float) -> torch.Tensor:
    """Launch the kernel on the current stream.  The caller
    (``ops.flash_attention_bshd``) has checked devices, dtypes, shapes
    and contiguity."""
    lib = _build.load("flash_attention", _SIGNATURES)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, S, H, k.shape[2], hd,
        float(scale), int(causal), int(window), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: status {rc}")
    return out
