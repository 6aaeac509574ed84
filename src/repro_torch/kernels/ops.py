"""Model-layout wrappers around the Hopper kernels (the reference's
``kernels/ops.py:flash_attention_bshd`` / ``paged_decode_bhd`` /
``mla_paged_decode_bhd`` / ``rglru_scan_bsr`` / ``wkv6_bshn``).

Each wrapper checks devices, dtypes, shapes and contiguity, then:

* a CPU tensor goes to the kernel's plain PyTorch version;
* a CUDA tensor launches the kernel, or the wrapper raises.  There is no
  fallback from a CUDA tensor to the plain version.

``launches`` counts kernel launches per wrapper, so a run can show that
its path went through the kernels; :func:`reset_launches` zeroes it.

Training takes ``flash_attention_bshd`` through :class:`FlashAttention`,
``wkv6_bshn`` through :class:`WKV6` and ``rglru_scan_bsr`` through
:class:`RGLRUScan`, ``torch.autograd.Function``s whose backwards are
:func:`flash_attention_bwd`, :func:`wkv6_bwd` and :func:`rglru_scan_bwd`
(the backward kernels on the card, their plain versions on the CPU), whenever
grad is enabled and an input requires it; under ``torch.inference_mode``
the serving call is the plain forward launch it always was.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_wkv as wkv

launches = {"flash_attention_bshd": 0, "flash_attention_bwd": 0,
            "paged_decode_bhd": 0, "mla_paged_decode_bhd": 0,
            "rglru_scan_bsr": 0, "rglru_scan_bwd": 0, "wkv6_bshn": 0,
            "wkv6_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _cuda_operands(name: str, tensors, dtypes, head_dim: int = 0,
                   head_dims=(0,)) -> None:
    """What the CUDA kernels take: one card, supported dtypes and head
    dims (where the kernel has one), contiguous row-major operands."""
    dev = tensors[0].device
    _require(dev.type == "cuda", f"{name}: tensors on {dev}, expected cpu "
             "or cuda")
    _require(all(t.device == dev for t in tensors),
             f"{name}: operands on different devices")
    _require(all(t.dtype in dtypes for t in tensors),
             f"{name}: dtypes {[t.dtype for t in tensors]}, kernel takes "
             f"{sorted(map(str, dtypes))}")
    _require(head_dim in head_dims,
             f"{name}: head_dim {head_dim}, kernel takes {head_dims}")
    _require(all(t.is_contiguous() for t in tensors),
             f"{name}: operands must be contiguous")


def flash_attention_bshd(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, Sk, K, hd)
    v: torch.Tensor,          # (B, Sk, K, hdv)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Query positions ``0..S-1`` against key positions ``0..Sk-1``, any
    S and Sk; returns (B, S, H, hdv).  Self-attention (prefill, training)
    has Sk = S; cross-attention (an encoder-decoder's decoder over the
    encoder's frames) has Sk apart from S, and then neither a causal mask
    nor a window.  v may be narrower than q and k (MLA trains at hd 192
    over hdv 128); on the card (hd, hdv) must be one of
    ``fa.HEAD_DIM_PAIRS``."""
    _require(q.ndim == 4 and k.ndim == 4 and v.ndim == 4
             and k.shape[:3] == v.shape[:3],
             f"flash_attention_bshd: shapes {q.shape} {k.shape} {v.shape}")
    B, S, H, hd = q.shape
    _require(k.shape[0] == B and k.shape[3] == hd and H % k.shape[2] == 0,
             f"flash_attention_bshd: q {tuple(q.shape)} vs k "
             f"{tuple(k.shape)}")
    _rectangular_ok("flash_attention_bshd", S, k.shape[1], causal, window)
    _require(q.dtype == k.dtype == v.dtype,
             "flash_attention_bshd: q, k, v dtypes differ")
    kw = dict(scale=scale, causal=causal, window=window, logit_cap=logit_cap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kw)
    return _flash_forward(q, k, v, kw, return_lse=False)


def _rectangular_ok(name: str, S: int, Sk: int, causal: bool,
                    window: int) -> None:
    """Sk != S is cross-attention: every key is live for every query, so
    no causal mask and no window (no path needs them; ROADMAP D9)."""
    _require(Sk == S or not (causal or window),
             f"{name}: {S} queries against {Sk} keys take neither a causal "
             f"mask nor a window (causal={causal}, window={window})")


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _flash_pair(name: str, q, v, kw, pairs) -> None:
    """The card's (qk, v) head-dim pairs, and no softcap on MLA's."""
    pair = (q.shape[3], v.shape[3])
    _require(pair in pairs,
             f"{name}: head_dim (qk, v) {pair}, kernel takes {pairs}")
    _require(pair[0] == pair[1] or not kw["logit_cap"],
             f"{name}: a softcap at head dims {pair}; the kernel takes one "
             "only with equal head dims")


def _flash_forward(q, k, v, kw, *, return_lse: bool):
    if _on_cpu((q, k, v)):
        return fa.flash_attention_torch(q, k, v, return_lse=return_lse, **kw)
    _cuda_operands("flash_attention_bshd", (q, k, v), fa.DTYPE_CODES)
    _flash_pair("flash_attention_bshd", q, v, kw, fa.HEAD_DIM_PAIRS)
    launches["flash_attention_bshd"] += 1
    return fa.flash_attention_cuda(q, k, v, return_lse=return_lse, **kw)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward also writes the
    log-sum-exp and saves (q, k, v, out, lse); the backward is
    :func:`flash_attention_bwd` on them."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = _flash_forward(q, k, v, kw, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None


def flash_attention_bwd(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, Sk, K, hd)
    v: torch.Tensor,          # (B, Sk, K, hdv)
    o: torch.Tensor,          # (B, S, H, hdv) the forward's output
    lse: torch.Tensor,        # (B, H, S) fp32 log-sum-exp
    do: torch.Tensor,         # (B, S, H, hdv) the output's gradient
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    logit_cap: float = 0.0,
):
    """(dq, dk, dv) of :func:`flash_attention_bshd`.  The kernel takes
    (hd, hdv) in ``fa.BWD_HEAD_DIM_PAIRS``: (64, 64), (128, 128), (256,
    256) and MLA's (192, 128); a softcap at each but the last."""
    B, S, H, hd = q.shape
    hdv = v.shape[-1]
    _require(v.ndim == 4 and k.shape[:3] == v.shape[:3]
             and k.shape[0] == B
             and k.shape[3] == hd and H % k.shape[2] == 0
             and tuple(o.shape) == (B, S, H, hdv) and do.shape == o.shape
             and tuple(lse.shape) == (B, H, S),
             f"flash_attention_bwd: q {tuple(q.shape)}, k {tuple(k.shape)}, "
             f"v {tuple(v.shape)}, o {tuple(o.shape)}, lse "
             f"{tuple(lse.shape)}, do "
             f"{tuple(do.shape)}")
    _require(q.dtype == k.dtype == v.dtype == o.dtype == do.dtype
             and lse.dtype == torch.float32,
             "flash_attention_bwd: q, k, v, o, do must share a dtype, lse "
             "must be fp32")
    _rectangular_ok("flash_attention_bwd", S, k.shape[1], causal, window)
    kw = dict(scale=scale, causal=causal, window=window, logit_cap=logit_cap)
    operands = (q, k, v, o, lse, do)
    if _on_cpu(operands):
        return fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    _cuda_operands("flash_attention_bwd", operands[:4] + operands[5:],
                   fa.DTYPE_CODES)
    _flash_pair("flash_attention_bwd", q, v, kw, fa.BWD_HEAD_DIM_PAIRS)
    _require(lse.device == q.device and lse.is_contiguous(),
             "flash_attention_bwd: lse must be contiguous on the card")
    _require(all(t.data_ptr() % 16 == 0 for t in operands),
             "flash_attention_bwd: operands must be 16-byte aligned (the "
             "kernel reads 16-byte chunks)")
    launches["flash_attention_bwd"] += 1
    return fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)


def paged_decode_bhd(
    q: torch.Tensor,            # (B, 1, H, hd): one new token per sequence
    k_pages: torch.Tensor,      # (P, K, ps, hd) shared physical pool
    v_pages: torch.Tensor,      # (P, K, ps, hd)
    page_table: torch.Tensor,   # (B, pps) int32; -1 = unallocated
    pos_q: torch.Tensor,        # (B,) int32; -1 = inactive slot
    *,
    scale: float,
    logit_cap: float = 0.0,
    grouped: bool = True,
) -> torch.Tensor:
    """Regroup the q heads per kv head, run the paged flash-decode, and
    ungroup.  ``grouped`` picks the kernel's head-tile grid (default) or
    its per-kv-head grid; both give the same numbers."""
    _require(q.ndim == 4 and q.shape[1] == 1 and k_pages.ndim == 4
             and k_pages.shape == v_pages.shape,
             f"paged_decode_bhd: shapes {tuple(q.shape)} "
             f"{tuple(k_pages.shape)} {tuple(v_pages.shape)}")
    B, _, H, hd = q.shape
    K = k_pages.shape[1]
    _require(H % K == 0 and k_pages.shape[3] == hd,
             f"paged_decode_bhd: q {tuple(q.shape)} vs pool "
             f"{tuple(k_pages.shape)}")
    _require(page_table.ndim == 2 and page_table.shape[0] == B
             and tuple(pos_q.shape) == (B,),
             f"paged_decode_bhd: table {tuple(page_table.shape)}, pos "
             f"{tuple(pos_q.shape)} for batch {B}")
    _require(k_pages.dtype == v_pages.dtype,
             "paged_decode_bhd: k and v pools differ in dtype")
    qg = q.reshape(B, K, H // K, hd)
    operands = (qg, k_pages, v_pages, page_table, pos_q)
    if all(t.device.type == "cpu" for t in operands):
        out = pa.paged_decode_torch(qg, k_pages, v_pages, page_table, pos_q,
                                    scale=scale, logit_cap=logit_cap)
        return out.reshape(B, 1, H, hd)
    _cuda_operands("paged_decode_bhd", (qg, k_pages, v_pages),
                   pa.DTYPE_CODES, hd, pa.HEAD_DIMS)
    _require(page_table.device == q.device and pos_q.device == q.device
             and page_table.dtype == torch.int32
             and pos_q.dtype == torch.int32
             and page_table.is_contiguous() and pos_q.is_contiguous(),
             "paged_decode_bhd: page_table and pos_q must be contiguous "
             "int32 on the card")
    _require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
             "paged_decode_bhd: pools must be 16-byte aligned (the kernel "
             "reads 16-byte chunks)")
    launches["paged_decode_bhd"] += 1
    out = pa.paged_decode_cuda(qg, k_pages, v_pages, page_table, pos_q,
                               scale=scale, logit_cap=logit_cap,
                               grouped=grouped)
    return out.reshape(B, 1, H, hd)


def mla_paged_decode_bhd(
    q_lat: torch.Tensor,        # (B, H, lora + rd) absorbed query
    ckv_pages: torch.Tensor,    # (P, ps, lora) shared latent pool
    krope_pages: torch.Tensor,  # (P, ps, rd)
    page_table: torch.Tensor,   # (B, pps) int32; -1 = unallocated
    pos_q: torch.Tensor,        # (B,) int32; -1 = inactive slot
    *,
    scale: float,
) -> torch.Tensor:
    """MLA latent flash-decode over the paged latent pool; returns the
    latent context ``(B, H, lora)`` in q's dtype (the caller applies
    ``W_vc`` and the output projection)."""
    _require(q_lat.ndim == 3 and ckv_pages.ndim == 3 and krope_pages.ndim == 3
             and ckv_pages.shape[:2] == krope_pages.shape[:2],
             f"mla_paged_decode_bhd: shapes {tuple(q_lat.shape)} "
             f"{tuple(ckv_pages.shape)} {tuple(krope_pages.shape)}")
    B, H, qd = q_lat.shape
    lora, rd = ckv_pages.shape[2], krope_pages.shape[2]
    _require(qd == lora + rd, f"mla_paged_decode_bhd: q width {qd} is not "
             f"lora {lora} + rd {rd}")
    _require(page_table.ndim == 2 and page_table.shape[0] == B
             and tuple(pos_q.shape) == (B,),
             f"mla_paged_decode_bhd: table {tuple(page_table.shape)}, pos "
             f"{tuple(pos_q.shape)} for batch {B}")
    _require(ckv_pages.dtype == krope_pages.dtype,
             "mla_paged_decode_bhd: latent pools differ in dtype")
    operands = (q_lat, ckv_pages, krope_pages, page_table, pos_q)
    if all(t.device.type == "cpu" for t in operands):
        return pa.mla_paged_decode_torch(q_lat, ckv_pages, krope_pages,
                                         page_table, pos_q, scale=scale)
    _cuda_operands("mla_paged_decode_bhd", (q_lat, ckv_pages, krope_pages),
                   pa.DTYPE_CODES)
    _require((lora, rd) in pa.MLA_DIMS,
             f"mla_paged_decode_bhd: lora {lora}, rd {rd}; the kernel takes "
             f"(lora, rd) in {pa.MLA_DIMS}")
    _require(not (q_lat.dtype == torch.bfloat16
                  and ckv_pages.dtype == torch.float32),
             "mla_paged_decode_bhd: a bf16 query over fp32 pools")
    _require(page_table.device == q_lat.device
             and pos_q.device == q_lat.device
             and page_table.dtype == torch.int32
             and pos_q.dtype == torch.int32
             and page_table.is_contiguous() and pos_q.is_contiguous(),
             "mla_paged_decode_bhd: page_table and pos_q must be contiguous "
             "int32 on the card")
    _require(ckv_pages.data_ptr() % 16 == 0
             and krope_pages.data_ptr() % 16 == 0,
             "mla_paged_decode_bhd: pools must be 16-byte aligned (the "
             "kernel reads 16-byte chunks)")
    launches["mla_paged_decode_bhd"] += 1
    return pa.mla_paged_decode_cuda(q_lat, ckv_pages, krope_pages,
                                    page_table, pos_q, scale=scale)


def _rglru_operands(name: str, log_a, others, h0) -> tuple:
    """The scan's operands checked as its kernels take them: (B, S, R)
    tensors of log_a's shape, h0 (B, R) or None, all fp32; on the card one
    device and contiguous.  Returns them; whether they lie on the CPU is
    for the caller."""
    _require(log_a.ndim == 3 and all(t.shape == log_a.shape for t in others),
             f"{name}: shapes {tuple(log_a.shape)} "
             + " ".join(str(tuple(t.shape)) for t in others))
    B, S, R = log_a.shape
    _require(S > 0, f"{name}: S {S}")
    _require(h0 is None or tuple(h0.shape) == (B, R),
             f"{name}: h0 {None if h0 is None else tuple(h0.shape)} "
             f"for ({B}, {R})")
    operands = (log_a, *others) + (() if h0 is None else (h0,))
    _require(all(t.dtype == torch.float32 for t in operands),
             f"{name}: operands must be fp32, got "
             f"{[t.dtype for t in operands]}")
    if not _on_cpu(operands):
        dev = log_a.device
        _require(dev.type == "cuda", f"{name}: tensors on {dev}, expected "
                 "cpu or cuda")
        _require(all(t.device == dev for t in operands),
                 f"{name}: operands on different devices")
        _require(all(t.is_contiguous() for t in operands),
                 f"{name}: operands must be contiguous")
    return operands


def rglru_scan_bsr(
    log_a: torch.Tensor,                 # (B, S, R) fp32, <= 0
    b: torch.Tensor,                     # (B, S, R) fp32
    h0: Optional[torch.Tensor] = None,   # (B, R) fp32; None = zero state
) -> torch.Tensor:
    """The RG-LRU scan h_t = exp(log_a_t)·h_{t-1} + b_t over dim 1; returns
    h (B, S, R) fp32.  Any S: nothing is padded.  With grad enabled and an
    input requiring it, the call goes through :class:`RGLRUScan`."""
    operands = _rglru_operands("rglru_scan_bsr", log_a, (b,), h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return RGLRUScan.apply(log_a, b, h0)
    return _rglru_forward(log_a, b, h0)


def _rglru_forward(log_a, b, h0):
    if _on_cpu((log_a, b) if h0 is None else (log_a, b, h0)):
        return rg.rglru_scan_torch(log_a, b, h0)
    launches["rglru_scan_bsr"] += 1
    return rg.rglru_scan_cuda(log_a, b, h0)


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan with its backward: the forward saves (log_a, h,
    h0); the backward is :func:`rglru_scan_bwd` on them."""

    @staticmethod
    def forward(ctx, log_a, b, h0):
        h = _rglru_forward(log_a, b, h0)
        ctx.save_for_backward(log_a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h, h0 = ctx.saved_tensors
        dlog_a, db, dh0 = rglru_scan_bwd(log_a, h, dh.contiguous(), h0)
        return dlog_a, db, dh0


def rglru_scan_bwd(
    log_a: torch.Tensor,                 # (B, S, R) fp32
    h: torch.Tensor,                     # (B, S, R) fp32 the forward's output
    dh: torch.Tensor,                    # (B, S, R) fp32 the output's gradient
    h0: Optional[torch.Tensor] = None,   # (B, R) fp32; None = zero state
):
    """``(dlog_a, db, dh0)`` of :func:`rglru_scan_bsr`
    (``rg.rglru_scan_bwd_torch`` says what each is); ``dh0`` is ``None``
    without an ``h0``."""
    operands = _rglru_operands("rglru_scan_bwd", log_a, (h, dh), h0)
    if _on_cpu(operands):
        return rg.rglru_scan_bwd_torch(log_a, h, dh, h0)
    launches["rglru_scan_bwd"] += 1
    return rg.rglru_scan_bwd_cuda(log_a, h, dh, h0)


def wkv6_bshn(
    r: torch.Tensor,          # (B, S, H, N)
    k: torch.Tensor,          # (B, S, H, N)
    v: torch.Tensor,          # (B, S, H, N)
    lw: torch.Tensor,         # (B, S, H, N) fp32 log-decay <= 0
    u: torch.Tensor,          # (H, N) fp32 bonus
    s0: torch.Tensor,         # (B, H, N, N) fp32 initial state
    *,
    chunk: int = 32,
):
    """WKV6 over the model layout.  Returns ``(o (B, S, H, N) in r's
    dtype, s_final (B, H, N, N) fp32)``.  ``chunk`` is the plain version's
    chunk length; the kernel's own is fixed (8 steps).  With grad enabled
    and an input requiring it, the call goes through :class:`WKV6`."""
    _require(r.ndim == 4 and k.shape == r.shape and v.shape == r.shape
             and lw.shape == r.shape,
             f"wkv6_bshn: shapes {tuple(r.shape)} {tuple(k.shape)} "
             f"{tuple(v.shape)} {tuple(lw.shape)}")
    B, S, H, N = r.shape
    _require(tuple(u.shape) == (H, N) and tuple(s0.shape) == (B, H, N, N),
             f"wkv6_bshn: u {tuple(u.shape)}, s0 {tuple(s0.shape)} for r "
             f"{tuple(r.shape)}")
    _require(S > 0 and chunk > 0, f"wkv6_bshn: S {S}, chunk {chunk}")
    _require(r.dtype == k.dtype == v.dtype,
             "wkv6_bshn: r, k, v dtypes differ")
    _require(lw.dtype == u.dtype == s0.dtype == torch.float32,
             "wkv6_bshn: lw, u and s0 must be fp32")
    operands = (r, k, v, lw, u, s0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return WKV6.apply(r, k, v, lw, u, s0, chunk)
    return _wkv6_forward(operands, chunk, seg=0)


def _wkv6_forward(operands, chunk: int, *, seg: int):
    """The forward kernel on the card, its plain version on the CPU; with
    ``seg`` also the state checkpoints (:func:`wkv.wkv6_torch`)."""
    if _on_cpu(operands):
        return wkv.wkv6_torch(*operands, chunk=chunk, seg=seg)
    r, k, v, lw = operands[:4]
    _cuda_operands("wkv6_bshn", operands, wkv.DTYPE_CODES, r.shape[3],
                   wkv.HEAD_SIZES)
    _require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, lw)),
             "wkv6_bshn: r, k, v and lw must be 16-byte aligned (the "
             "kernel loads them by TMA)")
    launches["wkv6_bshn"] += 1
    return wkv.wkv6_cuda(*operands, seg=seg)


class WKV6(torch.autograd.Function):
    """WKV6 with its backward: the forward also writes the state before
    every ``wkv.SEG``-th step and saves (r, k, v, lw, u, checkpoints); the
    backward is :func:`wkv6_bwd` on them.  A gradient that autograd does
    not pass (s_final unused, as in training) is a zero one."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk):
        o, s_fin, ckpt = _wkv6_forward((r, k, v, lw, u, s0), chunk,
                                       seg=wkv.SEG)
        ctx.save_for_backward(r, k, v, lw, u, ckpt)
        ctx.set_materialize_grads(False)
        return o, s_fin

    @staticmethod
    def backward(ctx, do, ds_fin):
        r, k, v, lw, u, ckpt = ctx.saved_tensors
        do = torch.zeros_like(r) if do is None else do.contiguous()
        if do.data_ptr() % 16:      # a view into a gradient's storage
            do = do.clone()
        grads = wkv6_bwd(r, k, v, lw, u, ckpt, do,
                         None if ds_fin is None else ds_fin.contiguous())
        return (*grads, None)


def wkv6_bwd(
    r: torch.Tensor,          # (B, S, H, N)
    k: torch.Tensor,          # (B, S, H, N)
    v: torch.Tensor,          # (B, S, H, N)
    lw: torch.Tensor,         # (B, S, H, N) fp32
    u: torch.Tensor,          # (H, N) fp32
    ckpt: torch.Tensor,       # (B, H, ceil(S / SEG), N, N) fp32
    do: torch.Tensor,         # (B, S, H, N) the output's gradient
    ds_fin: Optional[torch.Tensor] = None,   # (B, H, N, N) fp32; None = 0
):
    """(dr, dk, dv, dlw, du, ds0) of :func:`wkv6_bshn` from the forward's
    checkpoints (``wkv.wkv6_bwd_torch`` says what each is).  The kernel
    takes N in ``wkv.HEAD_SIZES``, as the forward."""
    B, S, H, N = r.shape
    _require(k.shape == r.shape and v.shape == r.shape
             and lw.shape == r.shape and do.shape == r.shape
             and tuple(u.shape) == (H, N)
             and tuple(ckpt.shape) == (B, H, -(-S // wkv.SEG), N, N)
             and (ds_fin is None or tuple(ds_fin.shape) == (B, H, N, N)),
             f"wkv6_bwd: r {tuple(r.shape)}, u {tuple(u.shape)}, ckpt "
             f"{tuple(ckpt.shape)}, do {tuple(do.shape)}")
    _require(r.dtype == k.dtype == v.dtype == do.dtype,
             "wkv6_bwd: r, k, v and do dtypes differ")
    fp32 = (lw, u, ckpt) if ds_fin is None else (lw, u, ckpt, ds_fin)
    _require(all(t.dtype == torch.float32 for t in fp32),
             "wkv6_bwd: lw, u, the checkpoints and ds_fin must be fp32")
    operands = (r, k, v, do) + fp32
    if _on_cpu(operands):
        return wkv.wkv6_bwd_torch(r, k, v, lw, u, ckpt, do, ds_fin)
    _cuda_operands("wkv6_bwd", (r, k, v, do), wkv.DTYPE_CODES, N,
                   wkv.HEAD_SIZES)
    _require(all(t.device == r.device and t.is_contiguous() for t in fp32),
             "wkv6_bwd: lw, u, the checkpoints and ds_fin must be "
             "contiguous on the card")
    _require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, do, lw, ckpt)),
             "wkv6_bwd: r, k, v, do, lw and the checkpoints must be 16-byte "
             "aligned (the kernels stage them by cp.async)")
    launches["wkv6_bwd"] += 1
    return wkv.wkv6_bwd_cuda(r, k, v, lw, u, ckpt, do, ds_fin)
