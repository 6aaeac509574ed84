"""Paged flash-decode: the Hopper kernels and their plain versions.

One new token per sequence attends the paged KV cache: a shared pool
``(P, K, ps, hd)`` walked through per-sequence page tables ``(B, pps)``.
The CUDA kernel (``csrc/paged_decode.cu``) replaces both Pallas kernels of
the reference's ``kernels/paged_attention.py``: ``_decode_kernel_grouped``
(``grouped=True``, a block per tile of ``group_tile(K, G)`` kv heads) and
``_decode_kernel`` (``grouped=False``, a block per kv head).  The two give
the same numbers, bit for bit.  It is one launch: the key axis of each
(row, kv head) is cut into tiles of 32 keys and the tiles into ranges of
:func:`split_tiles` tiles, sized from the shapes alone so that a serving
batch fills the card; a warp walks one range of one group of at most
:func:`decode_plan`'s ``gt`` query rows, copying each live tile's K and V
rows into shared memory with ``cp.async.bulk``, and the warp that ends a
(row, kv head, row group) last merges its ranges in the same launch.  A
warp loads its own page-table row and position (the TPU scalar-prefetched
them), and a range that starts past ``pos_q`` exits at once, so nothing
is read past the last live key and the host reads neither.

Contract (shared with :func:`paged_decode_torch` and the reference):

* slot ``t`` of a sequence holds absolute position ``t``: a key is live iff
  ``t <= pos_q`` and its page-table entry is ``>= 0``;
* ``pos_q < 0`` marks an inactive slot and gives a zero output row;
* a ``-1`` entry is never dereferenced: on the card an out-of-range page
  is an illegal address (the kernel also skips an entry past the pool),
  and in torch indexing with -1 would read the LAST page, so the plain
  version masks instead of indexing.

Layouts: q ``(B, K, G, hd)``, pools ``(P, K, ps, hd)``, table ``(B, pps)``
int32, pos_q ``(B,)`` int32.

The MLA latent flash-decode (``csrc/mla_decode.cu``, replacing the
reference's ``_decode_kernel_mla``) keeps the same contract over the
latent pools: the absorbed query ``q_lat (B, H, lora + rd)`` scores the
keys ``[ckv ‖ krope]`` of ``ckv_pages (P, ps, lora)`` and ``krope_pages
(P, ps, rd)`` (one latent kv head shared by all H heads), and the latent
itself is the value: the output is the latent context ``(B, H, lora)``.
It is one launch too: :func:`mla_decode_plan` cuts a row's keys into
32-key tiles and the tiles into ranges, the ranges of a (row, head tile)
form one thread-block cluster and merge in distributed shared memory.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
TILE_KEYS = 32         # keys a tile: one a lane
WARPS_PER_SM = 32      # work items a range size aims at, per SM
SMEM_BYTES = 227 * 1024
MAX_WARPS = 8          # warps a block of the kernel

_SIGNATURES = {
    "paged_decode_fwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}
# the MLA kernel's widths (deepseek-v2), tiles, head tiles and merge
MLA_DIMS = ((512, 64),)        # (lora, rd) pairs the kernel is built for
MLA_MAX_CLUSTER = 8            # ranges a (row, head tile): one cluster
MLA_WG_HEADS = 64              # heads a block of the bf16 (wgmma) route
MLA_SIMT_HEADS = 16            # heads a block of the fp32-q (SIMT) route
MLA_STAGES = 3                 # ring depth of the wgmma route
MLA_SIMT_BLOCKS = 2            # blocks an SM of the SIMT route
_MLA_SIGNATURES = {
    "mla_decode_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 20
    + [ctypes.c_float, ctypes.c_void_p],
    "mla_decode_cluster_slots": [ctypes.c_int] * 4,
}


def group_tile(K: int, G: int) -> int:
    """kv heads per block of the grouped grid: the largest divisor of K
    keeping the tile's query rows (kt·G) within 8 (the reference's MXU
    band).  G >= 8 tiles one kv head at a time."""
    kt = 1
    for d in range(1, K + 1):
        if K % d == 0 and d * G <= max(G, 8):
            kt = d
    return kt


def paged_decode_torch(
    q: torch.Tensor,            # (B, K, G, hd)
    k_pages: torch.Tensor,      # (P, K, ps, hd)
    v_pages: torch.Tensor,      # (P, K, ps, hd)
    page_table: torch.Tensor,   # (B, pps); -1 = unallocated
    pos_q: torch.Tensor,        # (B,); -1 = inactive slot
    *,
    scale: float,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """The reference's ``paged_decode_jnp``: a loop over logical pages
    carrying the online-softmax (m, l, acc) in fp32, one (B, K, ps, hd)
    page gather per step."""
    B, K, G, hd = q.shape
    ps = k_pages.shape[2]
    pps = page_table.shape[1]
    dev = q.device
    qf = q.float() * scale
    pq = pos_q.long()
    m = torch.full((B, K, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, G, hd), dtype=torch.float32, device=dev)
    for i in range(pps):
        entry = page_table[:, i].long()
        alloc = entry >= 0
        held = alloc[:, None, None, None]
        kb = torch.where(held, k_pages[entry.clamp(min=0)], 0).float()
        vb = torch.where(held, v_pages[entry.clamp(min=0)], 0).float()
        s = torch.einsum("bkgd,bktd->bkgt", qf, kb)
        if logit_cap:
            s = logit_cap * torch.tanh(s / logit_cap)
        t = i * ps + torch.arange(ps, device=dev)
        valid = alloc[:, None] & (t[None, :] <= pq[:, None])       # (B, ps)
        vm = valid[:, None, None, :]
        s = torch.where(vm, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # mask p explicitly: a fully-dead row would otherwise see
        # exp(NEG_INF - NEG_INF) == 1 (NEG_INF is a finite sentinel)
        p = torch.where(vm, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgt,bktd->bkgd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-37)[..., None]).to(q.dtype)


def split_tiles(B: int, K: int, ps: int, pps: int, n_sm: int) -> int:
    """Tiles of 32 keys a range of the kernel's key walk holds: enough
    ranges for WARPS_PER_SM (row, kv head, range) work items an SM if the
    table were full, at least one tile.  It depends on neither the head
    tile nor the data, so both grids and every call at a shape run the same
    arithmetic."""
    tiles = pps * -(-ps // TILE_KEYS)
    want = -(-WARPS_PER_SM * n_sm // (B * K))       # ranges a (row, head)
    return max(1, -(-tiles // want))


def decode_plan(B: int, K: int, G: int, hd: int, ps: int, pps: int,
                elt: int, n_sm: int, grouped: bool) -> dict:
    """The kernel's work decomposition, from shapes alone.  ``gt``: query
    rows a warp keeps in registers (a power of two: 8, or 4 at hd 256) for
    ``n_gg`` row groups of ``ceil(G / n_gg)`` rows a kv head; ``kt`` kv
    heads and ``ggb`` row groups a block (``group_tile`` for the grouped
    grid, cut where the block would pass MAX_WARPS warps or the shared
    memory); ``tps`` tiles a range, ``n_split`` ranges; ``stages`` tiles a
    head in flight; ``smem`` the block's bytes of dynamic shared memory
    (the kernel's layout: K and V rings, per-warp probability buffers,
    mbarriers).  Only ``kt``, ``ggb``, ``stages`` and ``smem`` differ
    between the grids, and none of them changes a head's arithmetic.  The
    kernel takes this plan as it is and computes none of it."""
    gt_max = 4 if hd > 128 else 8
    n_gg = -(-G // gt_max)
    rows = -(-G // n_gg)
    n_gg = -(-G // rows)                     # every row group non-empty
    gt = 1 << (rows - 1).bit_length()
    ggb = max(d for d in range(1, MAX_WARPS + 1) if n_gg % d == 0)
    kt = group_tile(K, G) if grouped else 1
    tps = split_tiles(B, K, ps, pps, n_sm)
    tile = 2 * TILE_KEYS * hd * elt          # K and V of one tile

    def smem(kt, stages):
        return kt * stages * tile + kt * ggb * TILE_KEYS * gt * 4 \
            + kt * stages * 16

    while kt > 1 and (kt * ggb > MAX_WARPS or smem(kt, 1) > SMEM_BYTES):
        kt = max(d for d in range(1, kt) if K % d == 0)
    stages = 1
    while stages < min(3, tps) and smem(kt, stages + 1) <= SMEM_BYTES:
        stages += 1
    n_split = -(-pps * -(-ps // TILE_KEYS) // tps)
    return dict(gt=gt, n_gg=n_gg, ggb=ggb, kt=kt, tps=tps, stages=stages,
                n_split=n_split, smem=smem(kt, stages))


_tickets = {}


def _ticket_counters(device, n: int) -> torch.Tensor:
    """The kernel's merge counters on ``device``: zeroed once, and left at
    zero by every launch, so they are kept and only grown.  Launches that
    share them must not overlap: one stream a device (the engine's)."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def paged_decode_cuda(q, k_pages, v_pages, page_table, pos_q, *,
                      scale: float, logit_cap: float,
                      grouped: bool) -> torch.Tensor:
    """Launch the kernel on the current stream.  The caller
    (``ops.paged_decode_bhd``) has checked devices, dtypes, shapes and
    contiguity."""
    lib = _build.load("paged_decode", _SIGNATURES)
    B, K, G, hd = q.shape
    ps = k_pages.shape[2]
    pps = page_table.shape[1]
    plan = decode_plan(B, K, G, hd, ps, pps, k_pages.element_size(),
                       _build.sm_count(q.device), grouped)
    ws = torch.empty(B * K * G * plan["n_split"] * (2 + hd),
                     dtype=torch.float32, device=q.device)
    tickets = _ticket_counters(q.device, B * K * plan["n_gg"])
    out = torch.empty_like(q)
    rc = lib.paged_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos_q.data_ptr(), ws.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
        DTYPE_CODES[k_pages.dtype], B, K, G, hd, ps, pps, k_pages.shape[0],
        plan["kt"], plan["n_gg"], plan["ggb"], plan["gt"], plan["tps"],
        plan["n_split"], plan["stages"], plan["smem"], float(scale),
        float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_decode_fwd launch failed: status {rc}")
    return out


def mla_paged_decode_torch(
    q_lat: torch.Tensor,        # (B, H, lora + rd) absorbed query
    ckv_pages: torch.Tensor,    # (P, ps, lora)
    krope_pages: torch.Tensor,  # (P, ps, rd)
    page_table: torch.Tensor,   # (B, pps); -1 = unallocated
    pos_q: torch.Tensor,        # (B,); -1 = inactive slot
    *,
    scale: float,
) -> torch.Tensor:
    """The reference's ``mla_paged_decode_jnp``: a loop over logical pages
    carrying the online-softmax (m, l, acc) in fp32, one (B, ps, lora + rd)
    page gather per step (masked for ``-1`` entries, never indexed with
    them).  Returns the latent context ``(B, H, lora)`` in q's dtype;
    inactive rows are zero."""
    B, H, _ = q_lat.shape
    ps, lora = ckv_pages.shape[1], ckv_pages.shape[2]
    pps = page_table.shape[1]
    dev = q_lat.device
    qf = q_lat.float() * scale
    pq = pos_q.long()
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, lora), dtype=torch.float32, device=dev)
    for i in range(pps):
        entry = page_table[:, i].long()
        alloc = entry >= 0
        held = alloc[:, None, None]
        idx = entry.clamp(min=0)
        cb = torch.where(held, ckv_pages[idx], 0).float()      # (B, ps, lora)
        rb = torch.where(held, krope_pages[idx], 0).float()    # (B, ps, rd)
        s = torch.einsum("bhe,bte->bht", qf, torch.cat([cb, rb], dim=-1))
        t = i * ps + torch.arange(ps, device=dev)
        valid = alloc[:, None] & (t[None, :] <= pq[:, None])   # (B, ps)
        vm = valid[:, None, :]
        s = torch.where(vm, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # mask p explicitly: a fully-dead row would otherwise see
        # exp(NEG_INF - NEG_INF) == 1 (NEG_INF is a finite sentinel)
        p = torch.where(vm, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bht,btl->bhl", p, cb)
        m = m_new
    return (acc / l.clamp_min(1e-37)[..., None]).to(q_lat.dtype)


def _mla_layout(wgmma: bool, ht: int, tpr: int, n_split: int, kv_elt: int,
                lora: int, rd: int):
    """(cols, stages, region offsets, dynamic shared memory bytes) of a
    block of the MLA kernel: see :func:`mla_decode_plan`."""
    tk, dq = TILE_KEYS, lora + rd
    cols = -(-lora // (4 * n_split)) * 4
    staged = 4 * ht * (lora + 4)             # the partial accumulator
    # the (m, l) block: own m, l; the sources' m, l, weights; 1 / L; the
    # (SIMT) rescale factors
    ml = 4 * ht * (2 + 3 * MLA_MAX_CLUSTER + 2)
    if wgmma:
        q_bytes = ht * dq * 2
        stage = tk * dq * 2                  # ckv and krope of a tile
        stages = min(MLA_STAGES, tpr)
        pbuf = 2 * (2 * (tk // 16) * 4 * 128 * 4 + 128 * 8)
        main = -(-max(q_bytes + stages * stage, staged) // 1024) * 1024
        offs = (q_bytes, main, main + pbuf, main + pbuf + ml)
        # mbarriers: full and empty a stage, P full and empty a slot; then
        # room to align the base to 1,024 bytes (the 128-byte swizzle)
        return cols, stages, offs, offs[3] + 8 * (2 * stages + 4) + 1024
    key_row = (dq + 16 // kv_elt) * kv_elt   # padded by 16 bytes
    main = -(-max(ht * dq * 4, staged) // 16) * 16     # the scaled query
    offs = (main, main + tk * key_row, main + tk * key_row + ht * tk * 4,
            main + tk * key_row + 2 * ht * tk * 4)
    return cols, 1, offs, offs[3] + ml


def mla_decode_plan(B: int, H: int, ps: int, pps: int, q_elt: int,
                    kv_elt: int, n_sm: int,
                    slots: Optional[Callable[[int, int], int]] = None,
                    lora: int = 512, rd: int = 64) -> dict:
    """The MLA kernel's work decomposition and shared-memory layout, from
    the shapes and the card.  ``route``: "wgmma" for a bf16 query over
    bf16 pools (the serving path), else "simt" (an fp32 query).  ``ht``
    heads a block (one wgmma row band of 64, or 16), ``n_ht`` head tiles;
    ``ntp`` tiles of TILE_KEYS a page; a row's ``pps * ntp`` tiles are cut
    into ``n_split`` ranges of ``tpr`` tiles, and the ranges of a (row,
    head tile) are one cluster.  ``n_split`` (at most MLA_MAX_CLUSTER) is
    the one whose critical path, waves of clusters times tiles a range, is
    shortest (the fewer ranges on a tie: less to merge); ``slots(n,
    smem)`` is how many clusters of n blocks of smem bytes the card holds
    at once (by default n_sm / n, or twice that for the SIMT route's two
    blocks an SM; a card that must fit a cluster into one GPC holds
    fewer).  ``cols`` latent columns each block of a cluster merges;
    ``stages`` ring depth; ``offs`` the kernel's region offsets (wgmma:
    ring, P hand-over slots, (m, l) block, mbarriers; simt: key tile,
    scores, probabilities, (m, l) block) and ``smem`` the block's dynamic
    shared memory in bytes.  After the walk the block's partial
    accumulator, [ht][lora + 4] fp32, overlays the query tile (and the
    ring), where the other blocks of its cluster read their columns of it.
    The kernel takes this plan as it is and computes none of it."""
    wgmma = q_elt == 2 and kv_elt == 2
    ht = MLA_WG_HEADS if wgmma else MLA_SIMT_HEADS
    per_sm = 1 if wgmma else MLA_SIMT_BLOCKS
    if slots is None:
        slots = lambda n, smem: per_sm * n_sm // n  # noqa: E731
    n_ht = -(-H // ht)
    ntp = -(-ps // TILE_KEYS)
    tiles = pps * ntp
    best = None
    for n in range(1, min(MLA_MAX_CLUSTER, tiles) + 1):
        tpr = -(-tiles // n)
        if -(-tiles // tpr) != n:            # the ranges of a smaller n
            continue
        cols, stages, offs, smem = _mla_layout(wgmma, ht, tpr, n, kv_elt,
                                               lora, rd)
        cap = slots(n, smem)
        if cap < 1:
            continue
        cost = -(-B * n_ht // cap) * tpr
        if best is None or cost < best[0]:
            best = (cost, n, tpr, cols, stages, offs, smem)
    _, n_split, tpr, cols, stages, offs, smem = best
    return dict(route="wgmma" if wgmma else "simt", ht=ht, n_ht=n_ht,
                ntp=ntp, tpr=tpr, n_split=n_split, cols=cols, stages=stages,
                offs=offs, smem=smem)


_mla_plans = {}
_cluster_slots = {}


def mla_card_plan(q_lat, ckv_pages, krope_pages, page_table) -> dict:
    """The plan :func:`mla_paged_decode_cuda` launches with: the card's
    own cluster capacity (asked of the CUDA runtime once per cluster size
    and layout), kept per shape, so a decode step makes no plan."""
    lib = _build.load("mla_decode", _MLA_SIGNATURES)
    device = q_lat.device
    B, H, _ = q_lat.shape
    ps, lora = ckv_pages.shape[1], ckv_pages.shape[2]
    rd, pps = krope_pages.shape[2], page_table.shape[1]
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    qdt, kvdt = DTYPE_CODES[q_lat.dtype], DTYPE_CODES[ckv_pages.dtype]
    key = (idx, B, H, ps, pps, qdt, kvdt, lora, rd)
    plan = _mla_plans.get(key)
    if plan is None:
        def slots(n, smem):
            k = (idx, qdt, kvdt, n, smem)
            if k not in _cluster_slots:
                with torch.cuda.device(idx):
                    got = lib.mla_decode_cluster_slots(qdt, kvdt, n, smem)
                if got < 0:
                    raise RuntimeError(
                        f"mla_decode_cluster_slots failed: status {-got}")
                _cluster_slots[k] = got
            return _cluster_slots[k]
        plan = mla_decode_plan(B, H, ps, pps, q_lat.element_size(),
                               ckv_pages.element_size(), _build.sm_count(device),
                               slots, lora, rd)
        _mla_plans[key] = plan
    return plan


def mla_paged_decode_cuda(q_lat, ckv_pages, krope_pages, page_table, pos_q,
                          *, scale: float) -> torch.Tensor:
    """Launch the MLA kernel on the current stream.  The caller
    (``ops.mla_paged_decode_bhd``) has checked devices, dtypes, shapes and
    contiguity."""
    lib = _build.load("mla_decode", _MLA_SIGNATURES)
    B, H, _ = q_lat.shape
    n_pool, ps, lora = ckv_pages.shape
    rd = krope_pages.shape[2]
    pps = page_table.shape[1]
    plan = mla_card_plan(q_lat, ckv_pages, krope_pages, page_table)
    out = torch.empty((B, H, lora), dtype=q_lat.dtype, device=q_lat.device)
    rc = lib.mla_decode_fwd(
        q_lat.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
        page_table.data_ptr(), pos_q.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q_lat.dtype], DTYPE_CODES[ckv_pages.dtype], B, H, lora,
        rd, ps, pps, n_pool, plan["ht"], plan["n_split"], plan["tpr"],
        plan["ntp"], plan["stages"], plan["cols"], *plan["offs"],
        plan["smem"],
        float(scale), torch.cuda.current_stream(q_lat.device).cuda_stream)
    if rc:
        raise RuntimeError(f"mla_decode_fwd launch failed: status {rc}")
    return out
