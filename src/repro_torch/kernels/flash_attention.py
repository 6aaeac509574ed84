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
transpose.  The keys may number Sk apart from the S queries (the TPU
kernel's (BH, Sq, hd) against (BK, Sk, hd)) where there is neither a causal
mask nor a window: seamless-m4t-medium's cross-attention, 4,096 decoder
rows against 1,024 encoder frames in training.  Head dims 64 and 128 (qwen3, paper-overhead, qwen2.5 and
mistral-large at G 5 and 12), 256 (the local layers of recurrentgemma,
16 q heads over one kv head, window 2,048; gemma2's local and global
layers, 16 q heads over 8 kv heads, a softcap of 50) and MLA's pair, q and k 192 wide (128 nope + 64 rope) over v 128,
the shape deepseek-v2 trains at (:data:`HEAD_DIM_PAIRS`).

:func:`flash_attention_torch` is the plain PyTorch version of the same
contract (the reference's ``flash_attention_jnp``): the CPU path, and the
oracle the kernel is held against on the card.  With ``return_lse`` both
also give each row's softmax log-sum-exp, which training saves for the
backward.

The backward (``csrc/flash_attention_bwd.cu``) is the gradient of the
reference's ``flash_attention_jnp`` as ``jax.grad`` takes it when the
reference trains; the reference has no Pallas backward.  It recomputes P
from the log-sum-exp.  In bf16 it is two kernels built like the forward:
persistent blocks of a TMA producer warpgroup and two wgmma consumer
warpgroups, one walking (b, q head, 128-row) items over their key tiles
(dQ, and each row's D = rowsum(dO o) for the other), one walking (b, kv
head, 128-key) items over the G q heads and their q tiles (dK, dV summed
in registers); :func:`flash_bwd_plan` gives both their work items,
longest first, and every tile size and shared-memory offset.  fp32 has a
CUDA-core path; there are no atomics.
:func:`flash_attention_bwd_torch` is its plain version, blockwise in fp32:
the CPU path and the card's oracle.  The backward takes hd 64, 128 and
256 and MLA's pair (:data:`BWD_HEAD_DIM_PAIRS`), a softcap at all but
MLA's; at hd 256 (recurrentgemma's and gemma2's layers) its dK/dV
consumers split an item's dK and dV between them (one computes S^T once
and hands P^T, under a softcap P^T (1 - tanh^2), to the other in shared
memory), its
items also split the group's q heads into ``kv_split`` parts, and a third
launch sums the parts' fp32 partials.
"""
from __future__ import annotations

import ctypes
import heapq

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (qk head dim, v head dim) of each kernel: square, or MLA's (192, 128),
# which takes no softcap (no config has both)
MLA_PAIR = (192, 128)
HEAD_DIM_PAIRS = ((64, 64), (128, 128), (256, 256), MLA_PAIR)
BWD_HEAD_DIM_PAIRS = ((64, 64), (128, 128), (256, 256), MLA_PAIR)

_SIGNATURES = {
    "flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
       ctypes.c_void_p],
}

# The bf16 backward's tiles: the dK/dV kernel's items are BWD_BC keys (64
# a consumer warpgroup; at hd 256 BWD_BC_SPLIT, both consumers on the same
# keys), the dQ kernel's items BWD_BM q rows (64 a consumer); the streamed
# tiles are :func:`bwd_stream_tiles` (``BwdTile`` in the CUDA source).
BWD_BC, BWD_BM = 128, 128
BWD_BC_SPLIT = 64
# hd 256's dK/dV items are split over the group's q heads until there are
# at least this many items an SM (or every head is a part of its own)
BWD_SPLIT_ITEMS_PER_SM = 2
BWD_SMEM_LIMIT = 232_448      # dynamic shared memory a block may take
BWD_MAX_STAGES = 4
BWD_HANDS = 2                 # hd 256: P^T handover buffers, dK/dV kernel
# The plan's integers in the order of ``BwdPlan`` in the CUDA source.
BWD_PLAN_FIELDS = (
    "br", "bc", "bm", "bn", "s_pad",
    "kv_blocks", "kv_slots", "kv_stages", "kv_off_kv", "kv_off_ring",
    "kv_off_stats", "kv_off_bars", "kv_smem", "kv_items", "kv_starts",
    "kv_split", "kv_hands", "kv_off_hand", "dq_blocks", "dq_slots",
    "dq_stages", "dq_off_q", "dq_off_ring", "dq_off_bars", "dq_smem",
    "dq_items", "dq_starts")


def bwd_stream_tiles(hd: int, softcap: bool = False, hd_v: int = 0):
    """(q rows of a dK/dV ring stage, keys of a dQ ring stage) of the bf16
    backward for qk width ``hd`` and v width ``hd_v`` (``hd`` if 0): 128
    where a consumer's registers hold the 128-wide score tiles beside its
    accumulators without spilling, else 64 (the softcapped hd-64 dK/dV and
    hd-128 dQ consumers); MLA's pair (192, 128) 32 and 64, its dK and dV
    accumulators taking 160 of a consumer's 240 registers; hd 256 64 and
    32, its dK, dV or dQ taking 128 (the dK/dV consumers hold one 64-wide
    score tile each, the dQ consumer two 32-wide ones: ``BwdTile`` in the
    CUDA source)."""
    if (hd, hd_v or hd) == MLA_PAIR:
        return 32, 64
    if hd == 256:
        return 64, 32
    br = 64 if hd == 128 or softcap else 128
    bn = 64 if hd == 128 and softcap else 128
    return br, bn


def _live(S: int, t0: int, t1: int, causal: bool, window: int,
          dev) -> torch.Tensor:
    """(S, t1 - t0) mask of the pairs (query row 0..S-1, key t0..t1-1)
    that attend."""
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
    k: torch.Tensor,          # (B, Sk, K, hd), positions 0..Sk-1
    v: torch.Tensor,          # (B, Sk, K, hdv)
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
    max(l, 1e-37), the log of the row's sum of exp(score) over live keys.
    The output is (B, S, H, hdv): v's width may differ from q's and k's
    (MLA), and the keys may number Sk apart from the S queries."""
    B, S, H, hd = q.shape
    Sk, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    dev = q.device
    qg = q.reshape(B, S, K, G, hd).float() * scale
    m = torch.full((B, S, K, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, K, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, K, G, hdv), dtype=torch.float32, device=dev)
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
    out = out.reshape(B, S, H, hdv).to(q.dtype)
    if not return_lse:
        return out
    lse = m + torch.log(l.clamp_min(1e-37))
    return out, lse.reshape(B, S, H).permute(0, 2, 1).contiguous()


def flash_attention_bwd_torch(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, Sk, K, hd)
    v: torch.Tensor,          # (B, Sk, K, hdv)
    o: torch.Tensor,          # (B, S, H, hdv) the forward's output
    lse: torch.Tensor,        # (B, H, S) fp32 the forward's log-sum-exp
    do: torch.Tensor,         # (B, S, H, hdv) the output's gradient
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
    over the G q heads of each kv head.  v, o and dO may be narrower than q
    and k (MLA's hdv), and k and v may hold Sk keys apart from S."""
    B, S, H, hd = q.shape
    Sk, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    dev = q.device
    qf = q.reshape(B, S, K, G, hd).float()
    dof = do.reshape(B, S, K, G, hdv).float()
    lse_g = lse.permute(0, 2, 1).reshape(B, S, K, G)
    delta = (dof * o.reshape(B, S, K, G, hdv).float()).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, Sk, K, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, K, hdv), dtype=torch.float32, device=dev)
    for t0 in range(0, Sk, kv_block):
        t1 = min(t0 + kv_block, Sk)
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _longest_first(costs, n_blocks: int):
    """Items dealt to ``n_blocks`` blocks, longest first, each to the block
    with the least work so far (ties to the lower block): per block, its
    items in the order it runs them."""
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    heap = [(0, blk) for blk in range(n_blocks)]
    lists = [[] for _ in range(n_blocks)]
    for i in order:
        load, blk = heapq.heappop(heap)
        lists[blk].append(i)
        heapq.heappush(heap, (load + costs[i], blk))
    return lists


def _bwd_ring(slot: int, stage: int, hand: int = 0):
    """(slots, stages, hands, smem) of a kernel whose shared memory is
    ``slot`` bytes a slot, ``stage`` a ring stage and, where ``hand`` is
    not 0, BWD_HANDS handover buffers of ``hand`` bytes, with a full and an
    empty mbarrier each: two slots if they fit with two stages, then as
    many stages (up to BWD_MAX_STAGES) as fit; 1,024 bytes of slack align
    the block's base."""
    hands = BWD_HANDS if hand else 0
    for slots in (2, 1):
        for stages in range(BWD_MAX_STAGES, 1, -1):
            smem = (slots * slot + stages * stage + hands * hand
                    + 2 * 8 * (slots + stages + hands) + 1024)
            if smem <= BWD_SMEM_LIMIT:
                return slots, stages, hands, smem
    raise ValueError("flash backward: no ring fits in shared memory")


def _kv_split(n_items: int, G: int, n_sm: int) -> int:
    """The parts hd 256's dK/dV items split the group's q heads into: the
    fewest (a divisor of G) that make BWD_SPLIT_ITEMS_PER_SM items an SM,
    else G."""
    for d in range(1, G + 1):
        if G % d == 0 and n_items * d >= BWD_SPLIT_ITEMS_PER_SM * n_sm:
            return d
    return G


def flash_bwd_plan(B: int, S: int, H: int, K: int, hd: int, causal: bool,
                   window: int, n_sm: int, softcap: bool = False,
                   hd_v: int = 0, Sk: int = 0) -> dict:
    """The bf16 backward's work and shared-memory layout, from the shapes
    and the card's SM count.  The kernels take it as it is and compute
    none of it.

    ``kv`` is the dK/dV kernel: an item (x, key tile, first, end) owns
    ``bc`` keys (BWD_BC, at hd 256 BWD_BC_SPLIT) and walks, for each q head
    of its part of the group, the ``br``-row q tiles first .. end - 1 (from
    the causal frontier to the window's end); x is (b K + kv head)
    ``kv_split`` + part, the part's q heads G / ``kv_split`` of the G
    (``kv_split`` is 1 but at hd 256).  ``dq`` is the dQ kernel: an item (b
    H + q head, row tile, first, end) owns BWD_BM q rows and walks the
    ``bn``-key tiles first .. end - 1 (``br``, ``bn``:
    :func:`bwd_stream_tiles`).  In each, ``blocks`` persistent
    blocks (at most one an SM) take the items longest first, each item to
    the block with the least work so far; ``items`` lists them block by
    block in the order they run, ``starts`` each block's first.  ``slots``
    buffers hold an item's K and V (dK/dV) or Q and dO, and O but at hd 256
    (dQ), ``stages`` ring stages the streamed tiles, and at hd 256 (dK/dV)
    ``hands`` buffers hand P^T (``bc`` x ``br`` fp32) from one consumer to
    the other; ``offs`` are byte offsets of the regions (kv: K/V slots,
    Q/dO stages, the stages' (lse log2 e, D) rows, handover buffers,
    mbarriers; dq: Q/dO/O slots, K/V stages, mbarriers) and ``smem`` a
    block's dynamic shared memory.  ``s_pad`` is S rounded
    up to BWD_BM: the statistics scratch is (B, H, s_pad, 2) fp32, followed
    at hd 256 by ``part_floats`` floats of dK and dV partials.  ``fields``
    are the plan's integers in BWD_PLAN_FIELDS order, ``work`` the int32
    buffer the kernels read (kv items, dq items, kv starts, dq starts).
    ``hd`` is the qk width, ``hd_v`` the v width (``hd`` if 0); S counts
    the queries, ``Sk`` the keys (S if 0): the dK/dV items tile the keys,
    the dQ items the queries."""
    G = H // K
    hd_v = hd_v or hd
    Sk = Sk or S
    br, bn = bwd_stream_tiles(hd, softcap, hd_v)
    split = hd == 256                # BwdTile::SPLIT in the CUDA source
    bc = BWD_BC_SPLIT if split else BWD_BC
    n_kt, n_mt = _cdiv(Sk, bc), _cdiv(S, BWD_BM)
    s_pad = n_mt * BWD_BM
    kv_split = _kv_split(B * K * n_kt, G, n_sm) if split else 1
    kv_items, kv_cost = [], []
    for bh in range(B * K):
        for kt in range(n_kt):
            q_lo = kt * bc if causal else 0
            k_last = min(Sk, (kt + 1) * bc) - 1
            q_hi = min(S, k_last + window) if window else S
            first, end = q_lo // br, _cdiv(q_hi, br)
            for part in range(kv_split):
                kv_items.append((bh * kv_split + part, kt, first, end))
                kv_cost.append(G // kv_split * (end - first) + 1)
    dq_items, dq_cost = [], []
    for bh in range(B * H):
        for mt in range(n_mt):
            r_last = min(S, (mt + 1) * BWD_BM) - 1
            k_lo = max(0, mt * BWD_BM - window + 1) if window else 0
            k_hi = min(r_last + 1, Sk) if causal else Sk
            first, end = k_lo // bn, _cdiv(k_hi, bn)
            dq_items.append((bh, mt, first, end))
            dq_cost.append(end - first + 1)

    def deal(items, costs):
        lists = _longest_first(costs, min(len(items), n_sm))
        order = [items[i] for blk in lists for i in blk]
        starts = [0]
        for blk in lists:
            starts.append(starts[-1] + len(blk))
        return order, starts, [[costs[i] for i in blk] for blk in lists]

    kv_order, kv_starts, kv_costs = deal(kv_items, kv_cost)
    dq_order, dq_starts, dq_costs = deal(dq_items, dq_cost)
    # dK/dV: a slot holds K and V of bc keys, a stage Q and dO of br rows,
    # each stage its rows' statistics (8 bytes a row), and at hd 256 a
    # handover buffer P^T (fp32, bc x br)
    kv_slot, q_tile = bc * (hd + hd_v) * 2, br * (hd + hd_v) * 2
    hand = bc * br * 4 if split else 0
    kv_slots, kv_stages, kv_hands, kv_smem = _bwd_ring(
        kv_slot, q_tile + br * 8, hand)
    kv_offs = dict(kv=0, ring=kv_slots * kv_slot)
    kv_offs["stats"] = kv_offs["ring"] + kv_stages * q_tile
    kv_offs["hand"] = kv_offs["stats"] + kv_stages * br * 8
    kv_offs["bars"] = kv_offs["hand"] + kv_hands * hand
    # dQ: a slot holds Q, dO and (but at hd 256, which reads D's O from
    # device memory) O of BWD_BM rows, a stage K and V of bn keys
    dq_slot = BWD_BM * (hd + (1 if split else 2) * hd_v) * 2
    k_tile = bn * (hd + hd_v) * 2
    dq_slots, dq_stages, _, dq_smem = _bwd_ring(dq_slot, k_tile)
    dq_offs = dict(q=0, ring=dq_slots * dq_slot)
    dq_offs["bars"] = dq_offs["ring"] + dq_stages * k_tile

    work = [x for it in kv_order for x in it] + \
        [x for it in dq_order for x in it]
    at = dict(kv_items=0, dq_items=4 * len(kv_order), kv_starts=len(work))
    work += kv_starts
    at["dq_starts"] = len(work)
    work += dq_starts
    kv = dict(items=kv_order, starts=kv_starts, costs=kv_costs,
              blocks=len(kv_starts) - 1, slots=kv_slots, stages=kv_stages,
              hands=kv_hands, offs=kv_offs, smem=kv_smem)
    dq = dict(items=dq_order, starts=dq_starts, costs=dq_costs,
              blocks=len(dq_starts) - 1, slots=dq_slots, stages=dq_stages,
              offs=dq_offs, smem=dq_smem)
    values = dict(
        br=br, bc=bc, bm=BWD_BM, bn=bn, s_pad=s_pad,
        kv_blocks=kv["blocks"], kv_slots=kv_slots, kv_stages=kv_stages,
        kv_off_kv=kv_offs["kv"], kv_off_ring=kv_offs["ring"],
        kv_off_stats=kv_offs["stats"], kv_off_bars=kv_offs["bars"],
        kv_smem=kv_smem, kv_items=at["kv_items"], kv_starts=at["kv_starts"],
        kv_split=kv_split, kv_hands=kv_hands, kv_off_hand=kv_offs["hand"],
        dq_blocks=dq["blocks"], dq_slots=dq_slots, dq_stages=dq_stages,
        dq_off_q=dq_offs["q"], dq_off_ring=dq_offs["ring"],
        dq_off_bars=dq_offs["bars"], dq_smem=dq_smem,
        dq_items=at["dq_items"], dq_starts=at["dq_starts"])
    part_floats = 2 * kv_split * B * Sk * K * hd if split else 0
    return dict(br=br, bc=bc, bm=BWD_BM, bn=bn, s_pad=s_pad,
                kv_split=kv_split, part_floats=part_floats, kv=kv, dq=dq,
                fields=[values[f] for f in BWD_PLAN_FIELDS], work=work)


_bwd_plans = {}


def flash_bwd_card_plan(q, k, v, causal: bool, window: int,
                        logit_cap: float):
    """(plan, its fields as a ctypes array, its work buffer on q's card)
    for :func:`flash_attention_bwd_cuda`, kept per shape, so a training
    step makes no plan and copies nothing to the card."""
    B, S, H, hd = q.shape
    hd_v = v.shape[3]
    idx = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    key = (idx, B, S, k.shape[1], H, k.shape[2], hd, hd_v, bool(causal),
           int(window), bool(logit_cap))
    got = _bwd_plans.get(key)
    if got is None:
        n_sm = torch.cuda.get_device_properties(idx).multi_processor_count
        plan = flash_bwd_plan(B, S, H, k.shape[2], hd, causal, window, n_sm,
                              bool(logit_cap), hd_v, k.shape[1])
        fields = (ctypes.c_int * len(plan["fields"]))(*plan["fields"])
        work = torch.tensor(plan["work"], dtype=torch.int32,
                            device=q.device)
        got = _bwd_plans[key] = (plan, fields, work)
    return got


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool,
                         window: int, logit_cap: float,
                         return_lse: bool = False):
    """Launch the kernel on the current stream; with ``return_lse`` also
    the (B, H, S) fp32 log-sum-exp, as ``(out, lse)``.  The caller
    (``ops.flash_attention_bshd``) has checked devices, dtypes, shapes
    and contiguity."""
    lib = _build.load("flash_attention", _SIGNATURES)
    B, S, H, hd = q.shape
    hd_v = v.shape[3]
    out = torch.empty((B, S, H, hd_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        DTYPE_CODES[q.dtype], B, S, k.shape[1], H, k.shape[2], hd, hd_v,
        float(scale), int(causal), int(window), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: status {rc}")
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, scale: float,
                             causal: bool, window: int, logit_cap: float):
    """Launch the backward's kernels on the current stream; returns (dq,
    dk, dv).  The caller (``ops.flash_attention_bwd``) has checked
    devices, dtypes, shapes, contiguity and alignment."""
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    B, S, H, hd = q.shape
    plan, fields, work = flash_bwd_card_plan(q, k, v, causal, window,
                                             logit_cap)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # (B, H, S) D for fp32; (B, H, s_pad, 2) (lse log2 e, D) for bf16, at
    # hd 256 followed by the dK/dV partials
    delta = torch.empty(B * H * plan["s_pad"] * 2 + plan["part_floats"],
                        dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), DTYPE_CODES[q.dtype], B, S,
        k.shape[1], H, k.shape[2], hd, v.shape[3], float(scale), int(causal),
        int(window),
        float(logit_cap), torch.cuda.current_stream(q.device).cuda_stream,
        fields, len(fields), work.data_ptr())
    if rc:
        raise RuntimeError(f"flash_attention_bwd launch failed: status {rc}")
    return dq, dk, dv
