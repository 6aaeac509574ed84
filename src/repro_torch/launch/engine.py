"""Resumable continuous-batching serving engine over the paged KV cache
(the reference's ``launch/engine.py:ServingEngine``).

The state machine is the reference's: **admit** (FIFO into free slots,
worst-case page reservation scaled by ``overcommit``, prefix-cache hits
attached read-only, a copy-on-write page for a mid-page divergence, one
ragged prefill per round), **step** (one batched decode over every
active slot, pages grown on demand, the youngest sequence evicted back to
the queue on page exhaustion), **finish**, and **snapshot / restore** of
the whole state as plain host data, so a restored engine continues
byte-identically.

What differs from the reference: the engine serves on one card (the
port's ``dist/`` builds meshes, but serving on one comes later), so the
page pool has one shard; the cache (KV pools, local rings, RG-LRU or RWKV state,
cross K/V) is updated in place, so :meth:`snapshot` copies every device
tensor to the host.  A decoder-only stack prefills ragged, one batched
prefill a round; an encoder-decoder (seamless-m4t-medium) prefills each
admitted request alone on its slot's views of the page table and the
cross K/V (the reference's per-slot path), with its encoder frames drawn
from numpy keyed on the request id (:meth:`ServingEngine._src_embeds`;
the reference draws them with ``jax.random``, ROADMAP D13), and its
prefix cache stays off, as the reference's does without ragged prefill.
A stack without global layers (RWKV, the RG-LRU + local-attention
hybrid) keeps the page accounting of an attention stack (its table has
no pools behind it) and no prefix cache; an admitted row starts from zero
state inside the ragged prefill, and rows not in the round keep theirs.
A stack with local layers needs ``prompt_len + gen >= window_size``, so
that every ring holds a whole window (``models.model.init_cache``).  An
MoE stack refuses a ``prompt_len`` whose page-bucketed prefill rows could
be longer than one MoE dispatch group and not a whole number of groups:
the reference asserts on such a row (``models.moe.check_row_length``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import GLOBAL_ATTN, check_ported, src_len_for
from repro_torch.launch.spec import ServeSpec, check_serve_spec
from repro_torch.models.layers import Ctx, resolve_device
from repro_torch.models.model import build_model, init_cache, num_pages
from repro_torch.models.moe import check_row_length
from repro_torch.models.params import cast_params
from repro_torch.train.steps import make_serve_steps

#: Parent hash of a prompt's first page in the chained prefix hash.
PREFIX_ROOT = "root"


def page_chain_hashes(tokens, page_size: int) -> List[Tuple[str, str]]:
    """``(parent_hash, chain_hash)`` for every FULL page of a prompt.  The
    chain hash of page ``i`` commits to every token through page ``i``, so
    two prompts share page ``i`` iff they agree on all of them.  blake2b,
    not the builtin ``hash``: the index must round-trip snapshots across
    processes, and builtin hashes are salted per process."""
    toks = np.asarray(tokens, np.int64)
    out: List[Tuple[str, str]] = []
    parent = PREFIX_ROOT
    for i in range(len(toks) // page_size):
        chunk = toks[i * page_size:(i + 1) * page_size]
        h = hashlib.blake2b(parent.encode() + chunk.tobytes(),
                            digest_size=16).hexdigest()
        out.append((parent, h))
        parent = h
    return out


class PagePool:
    """Host-side refcounted allocator of physical pages ``0 .. n_pages-1``
    with a hash-addressed prefix index (the reference's ``PagePool``).

    ``alloc`` hands pages out at refcount 1, ``attach`` bumps a cached page
    (pulling it off the free list if it was cached-but-free), ``free``
    decrements and returns a page to its shard's free list at zero.  A
    freed page keeps its prefix metadata until ``alloc`` reuses it."""

    def __init__(self, n_pages: int, n_shards: int = 1):
        if n_shards < 1 or n_pages % n_shards:
            raise ValueError(f"{n_pages} pages do not split into {n_shards} "
                             "shards")
        self.n_pages = n_pages
        self.n_shards = n_shards
        per = n_pages // n_shards
        self.free_lists: List[List[int]] = [
            list(range(s * per, (s + 1) * per)) for s in range(n_shards)]
        self.high_water = 0
        self.refcount: List[int] = [0] * n_pages
        # page -> {"parent": str, "hash": str, "tokens": [int]}
        self.page_meta: Dict[int, dict] = {}
        # per shard: parent_hash -> {chain_hash: page}
        self.prefix_index: List[Dict[str, Dict[str, int]]] = [
            {} for _ in range(n_shards)]

    @property
    def in_use(self) -> int:
        """Unique resident pages (each aliased page counts once)."""
        return self.n_pages - sum(len(f) for f in self.free_lists)

    def shard_of(self, p: int) -> int:
        per = self.n_pages // self.n_shards
        return min(p // per, self.n_shards - 1)

    def alloc(self, n: int, shard: int = 0) -> Optional[List[int]]:
        fl = self.free_lists[shard]
        if n > len(fl):
            return None
        pages, self.free_lists[shard] = fl[:n], fl[n:]
        for p in pages:
            if self.refcount[p]:
                raise RuntimeError(f"free page {p} has refcount "
                                   f"{self.refcount[p]}")
            self.refcount[p] = 1
            self._deregister(p)          # physical reuse ends its cache life
        self.high_water = max(self.high_water, self.in_use)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if self.refcount[p] <= 0:
                raise RuntimeError(f"free of unreferenced page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.free_lists[self.shard_of(p)].append(p)

    def attach(self, p: int) -> None:
        """Add a reference to a cached page (prefix hit)."""
        if self.refcount[p] == 0:
            self.free_lists[self.shard_of(p)].remove(p)
        self.refcount[p] += 1
        self.high_water = max(self.high_water, self.in_use)

    def lookup(self, shard: int, parent: str, chain: str) -> Optional[int]:
        return self.prefix_index[shard].get(parent, {}).get(chain)

    def candidates(self, shard: int, parent: str) -> Dict[str, int]:
        """All cached continuations of ``parent`` (CoW donor search)."""
        return self.prefix_index[shard].get(parent, {})

    def publish(self, page: int, parent: str, chain: str, tokens) -> bool:
        """Register a full, immutable page; the first publisher wins."""
        idx = self.prefix_index[self.shard_of(page)]
        kids = idx.setdefault(parent, {})
        if chain in kids or page in self.page_meta:
            if not kids:
                del idx[parent]
            return False
        kids[chain] = page
        self.page_meta[page] = {"parent": parent, "hash": chain,
                                "tokens": [int(t) for t in tokens]}
        return True

    def _deregister(self, p: int) -> None:
        meta = self.page_meta.pop(p, None)
        if meta is None:
            return
        idx = self.prefix_index[self.shard_of(p)]
        kids = idx.get(meta["parent"])
        if kids is not None and kids.get(meta["hash"]) == p:
            del kids[meta["hash"]]
            if not kids:
                del idx[meta["parent"]]


def _set_page_tables(cache, host_table: np.ndarray):
    """Copy the (B, pps) host page table into the cache's one device table,
    which every layer reads."""
    cache["page_table"].copy_(torch.from_numpy(host_table))
    return cache


#: The paged pools, every one indexed by physical page on its leading dim:
#: GQA K and V, and MLA's latent and rope-key pools.
POOL_LEAVES = ("k_pages", "v_pages", "ckv_pages", "krope_pages")


def _slot_view(cache, b: int):
    """Row ``b`` of the cache as a batch of one: the page table's row and
    the per-row leaves (an encoder-decoder's cross K/V) as views, so a
    prefill through it writes the full cache in place; the pools are
    indexed by physical page and shared whole."""
    view = {}
    for name, leaf in cache.items():
        if name == "page_table":
            view[name] = leaf[b:b + 1]
        elif name in POOL_LEAVES:
            view[name] = leaf
        else:
            view[name] = [t[b:b + 1] for t in leaf]
    return view


def _copy_pool_pages(cache, pairs: List[Tuple[int, int]]):
    """``src -> dst`` page copies in every global layer's pools (K and V,
    or MLA's latent and rope-key pools): the copy half of copy-on-write.
    A stack without pools has nothing to copy."""
    dev = cache["page_table"].device
    srcs = torch.tensor([s for s, _ in pairs], dtype=torch.long, device=dev)
    dsts = torch.tensor([d for _, d in pairs], dtype=torch.long, device=dev)
    for name in POOL_LEAVES:
        for pool in cache.get(name, []):
            pool.index_copy_(0, dsts, pool.index_select(0, srcs))
    return cache


@dataclass
class Request:
    """One serving request: a prompt and a greedy generation budget."""

    req: int                       # stable id
    tokens: np.ndarray             # (L,) prompt token ids
    gen_len: int                   # tokens to generate (incl. prefill token)


@dataclass
class SeqRecord:
    """Everything the engine knows about one active decode slot."""

    request: Request
    pages: List[int]               # physical pages held, table order
    shard: int
    need_worst: int                # reserved pages (worst case minus shared)
    remaining: int                 # tokens still to generate
    out_tokens: List[int] = field(default_factory=list)
    admit_seq: int = 0             # admission order; larger = younger
    n_shared: int = 0              # leading pages attached from the index
    cached_tokens: int = 0         # prompt tokens served from the cache


class ServingEngine:
    """Continuous batching over the paged cache as a resumable state
    machine.  ``model`` holds the fp32 master weights on ``device``
    (``cuda`` unless the caller names one); the engine keeps one compute
    copy in ``dtype``."""

    def __init__(self, cfg, model, sv: ServeSpec, *, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        check_ported(cfg)
        check_serve_spec(sv, cfg, continuous=True)
        dev = resolve_device(device)
        held = {p.device for p in model.parameters()}
        if held != {dev}:
            raise ValueError(f"model weights on {sorted(map(str, held))}, "
                             f"engine device {dev}")
        if cfg.cache_layout != "paged":
            raise ValueError("continuous batching needs cache_layout='paged'")
        # an encoder-decoder prefills per slot: a batched prefill would
        # overwrite the cross K/V of the rows not in the round
        self.ragged = not cfg.is_encoder_decoder
        # prefix caching needs the chunked-prefill seam: ragged prefill on
        # an all-global stack (ring locals would have to replay the
        # evicted prefix) and no vision frontend (its embeddings precede
        # position 0), as in the reference's engine, which feeds no
        # frontend: it serves such a config text-only
        self.prefix_cache = bool(sv.prefix_cache) and self.ragged \
            and set(cfg.layer_kinds()) == {GLOBAL_ATTN} \
            and cfg.frontend != "vision"

        B, P, G = sv.batch, sv.prompt_len, sv.gen
        self.cfg, self.sv = cfg, sv
        self.ctx = Ctx(device=dev, dtype=dtype)
        self.params = cast_params(model, dtype)
        self.B = B
        self.ps = cfg.page_size
        self.max_len = P + G
        self.pps = num_pages(self.max_len, self.ps)
        budget = sv.page_budget or B * self.pps
        if budget < self.pps:
            raise ValueError(f"page budget {budget} cannot hold one "
                             f"request ({self.pps} pages)")
        self.overcommit = sv.overcommit or 1.0
        if self.overcommit < 1.0:
            raise ValueError(f"overcommit {self.overcommit} must be >= 1")
        if cfg.is_moe:
            # a prefill round pads its rows to a page multiple up to P
            for S0 in range(self.ps, num_pages(P, self.ps) * self.ps + 1,
                            self.ps):
                check_row_length(cfg, S0)

        self.prefill, self.decode = make_serve_steps(cfg, self.ctx)
        self.src_len = src_len_for(cfg, self.max_len)
        self.cache = init_cache(cfg, B, self.max_len, src_len=self.src_len,
                                page_budget=budget, device=dev)
        self.pool = PagePool(budget)
        self.per_shard = budget
        self.reserved = [0]                    # worst-case pages admitted
        self.host_table = np.full((B, self.pps), -1, np.int32)

        self.slots: List[Optional[SeqRecord]] = [None] * B
        self.toks = np.zeros((B, 1), np.int64)
        self.pos = np.full((B,), -1, np.int64)
        self.queue: Deque[Request] = deque()
        self.responses: Dict[int, List[int]] = {}
        self.journal: List[dict] = []

        self.decode_steps = 0
        self.generated = 0
        self.stalled_admissions = 0
        self.evictions = 0
        self._admit_seq = 0
        self.prefill_tokens = 0      # prompt tokens actually computed
        self.cached_tokens = 0       # prompt tokens served from the cache
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cow_copies = 0

    # -- queue -------------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Enqueue a request (FIFO); rejects one whose worst-case page need
        exceeds the pool (admitting it would deadlock)."""
        need = num_pages(len(request.tokens) + request.gen_len, self.ps)
        if need > self.per_shard:
            raise ValueError(
                f"request {request.req} needs {need} pages worst-case; "
                f"the pool holds {self.per_shard}")
        self.queue.append(request)

    def free_slot_count(self) -> int:
        return sum(1 for s in self.slots if s is None)

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    def active_records(self) -> List[SeqRecord]:
        return [s for s in self.slots if s is not None]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.ctx.device)

    def _src_embeds(self, req_id: int) -> torch.Tensor:
        """The audio stub's encoder frames of one request, ``0.02 N(0,
        1)`` of shape (1, src_len, d_model) in fp32, drawn from numpy's
        generator keyed on the request id alone: an evict-replay or a
        restored engine rebuilds the same cross K/V, and so the same
        continuation.  (The reference draws them with ``jax.random``;
        ROADMAP D13.)"""
        rng = np.random.default_rng(req_id)
        x = 0.02 * rng.standard_normal((1, self.src_len, self.cfg.d_model))
        return self._tensor(x.astype(np.float32))

    # -- prefix matching ---------------------------------------------------
    def _match_prefix(self, req: Request, shard: int, pending) -> tuple:
        """``(shared, cow, C, hashes, defer)`` for one prompt: the cached
        pages to attach, an optional ``(src_page, overlap)`` CoW donor for
        the first divergent page, the cached token count, the prompt's
        chain hashes, and whether to wait one round for a page THIS round
        publishes.  At least one prompt token is always computed."""
        L = len(req.tokens)
        if not self.prefix_cache:
            return [], None, 0, [], False
        hashes = page_chain_hashes(req.tokens, self.ps)
        shared: List[int] = []
        for i in range((L - 1) // self.ps):
            parent, chain = hashes[i]
            page = self.pool.lookup(shard, parent, chain)
            if page is None:
                if chain in pending:
                    return [], None, 0, hashes, True
                break
            shared.append(page)
        m = len(shared)
        cow = None
        parent = hashes[m - 1][1] if m else PREFIX_ROOT
        limit = min(self.ps, L - 1 - m * self.ps)
        if limit > 0:
            chunk = np.asarray(req.tokens[m * self.ps:
                                          m * self.ps + limit], np.int64)
            best_page, best_ov = None, 0
            for chain in sorted(self.pool.candidates(shard, parent)):
                page = self.pool.candidates(shard, parent)[chain]
                ptoks = np.asarray(
                    self.pool.page_meta[page]["tokens"][:limit], np.int64)
                n = min(len(chunk), len(ptoks))
                ne = chunk[:n] != ptoks[:n]
                ov = int(np.argmax(ne)) if ne.any() else n
                if ov > best_ov:
                    best_page, best_ov = page, ov
            if best_ov > 0:
                cow = (best_page, best_ov)
        C = m * self.ps + (cow[1] if cow else 0)
        return shared, cow, C, hashes, False

    # -- admission ---------------------------------------------------------
    def admit(self) -> List[int]:
        """One admission round and ONE ragged prefill over the admitted
        prompts' uncached tails (an encoder-decoder: one prefill an
        admitted request, on its slot).  Returns the admitted request
        ids."""
        admitted: List[tuple] = []               # (slot, request)
        plans: Dict[int, tuple] = {}             # slot -> (C, hashes, m)
        cow_pairs: List[Tuple[int, int]] = []
        pending: set = set()                     # hashes this round publishes
        shard = 0
        for b in range(self.B):
            if self.slots[b] is not None or not self.queue:
                continue
            req = self.queue[0]
            L = len(req.tokens)
            need_worst = num_pages(L + req.gen_len, self.ps)
            cap = int(self.overcommit * self.per_shard)
            prompt_pages = num_pages(L, self.ps)
            shared, cow, C, hashes, defer = self._match_prefix(
                req, shard, pending)
            if defer:
                self.stalled_admissions += 1
                break                            # FIFO: no out-of-order admit
            m = len(shared)
            reserve = need_worst - m
            if self.reserved[shard] + reserve > cap:
                self.stalled_admissions += 1
                break
            # attach BEFORE alloc: a cached-but-free shared page must leave
            # the free list before the allocator could hand it out
            for p in shared:
                self.pool.attach(p)
            pages = self.pool.alloc(prompt_pages - m, shard)
            if pages is None:
                self.pool.free(shared)
                self.stalled_admissions += 1
                break
            self.queue.popleft()
            self.reserved[shard] += reserve
            pages = shared + pages
            self.host_table[b, :prompt_pages] = pages
            self.host_table[b, prompt_pages:] = -1
            self._admit_seq += 1
            self.slots[b] = SeqRecord(
                request=req, pages=pages, shard=shard,
                need_worst=reserve, remaining=req.gen_len,
                admit_seq=self._admit_seq, n_shared=m, cached_tokens=C)
            if cow is not None:
                cow_pairs.append((cow[0], pages[m]))
                self.cow_copies += 1
            if self.prefix_cache:
                if C > 0:
                    self.prefix_hits += 1
                else:
                    self.prefix_misses += 1
                pending.update(ch for _, ch in hashes[m:L // self.ps])
            plans[b] = (C, hashes, m)
            admitted.append((b, req))

        if not admitted:
            return []
        _set_page_tables(self.cache, self.host_table)

        nxt_tok = self._prefill_round(admitted, plans, cow_pairs) \
            if self.ragged else None

        out: List[int] = []
        for b, r in admitted:
            tok = int(nxt_tok[b]) if self.ragged \
                else self._prefill_slot(b, r)
            rec = self.slots[b]
            C, hashes, m = plans[b]
            if self.prefix_cache:
                # the round's freshly prefilled full pages become cache
                # content (a full CoW page included)
                for i in range(m, len(r.tokens) // self.ps):
                    parent, chain = hashes[i]
                    self.pool.publish(
                        rec.pages[i], parent, chain,
                        r.tokens[i * self.ps:(i + 1) * self.ps])
            self.prefill_tokens += len(r.tokens) - C
            self.cached_tokens += C
            rec.out_tokens.append(tok)
            rec.remaining -= 1
            self.toks[b, 0] = tok
            self.pos[b] = len(r.tokens)
            self.generated += 1
            self.journal.append({"ev": "admit", "req": r.req, "slot": b,
                                 "cached": C})
            out.append(r.req)
            if rec.remaining <= 0:
                self.finish(b)                   # gen_len == 1: prefill was it
        return out

    def _prefill_round(self, admitted, plans, cow_pairs) -> np.ndarray:
        """One ragged prefill over the round's uncached prompt tails;
        returns every slot's next token (only the admitted ones are
        read)."""
        # pad to the round's longest uncached tail, bucketed to a page
        # multiple (as the reference does to bound its recompiles)
        round_max = max(len(r.tokens) - plans[b][0] for b, r in admitted)
        S0 = -(-round_max // self.ps) * self.ps
        toks_in = np.zeros((self.B, S0), np.int64)
        lens = np.zeros((self.B,), np.int32)
        starts = np.zeros((self.B,), np.int32)
        for b, r in admitted:
            C = plans[b][0]
            toks_in[b, :len(r.tokens) - C] = r.tokens[C:]
            lens[b] = len(r.tokens) - C
            starts[b] = C
        if cow_pairs:
            _copy_pool_pages(self.cache, cow_pairs)
        batch = {"tokens": self._tensor(toks_in)}
        if self.prefix_cache:
            # the chunked path even at starts == 0: one numeric family for
            # every prefill, so evict-replay stays byte-identical
            logits, _ = self.prefill(self.params, batch, self.cache,
                                     self._tensor(lens), self._tensor(starts))
        else:
            logits, _ = self.prefill(self.params, batch, self.cache,
                                     self._tensor(lens))
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    def _prefill_slot(self, b: int, r: Request) -> int:
        """Prefill request ``r`` alone on slot ``b`` (an encoder-decoder:
        its tokens and its encoder frames, over the row's views of the
        cache) and return its next token."""
        batch = {"tokens": self._tensor(np.asarray(r.tokens)[None]),
                 "src_embeds": self._src_embeds(r.req)}
        logits, _ = self.prefill(self.params, batch,
                                 _slot_view(self.cache, b))
        return int(logits[0, -1].argmax())

    # -- eviction ------------------------------------------------------------
    def evict(self, b: int) -> int:
        """Preempt slot ``b`` back to the FRONT of the queue: free its
        pages and reservation, drop its partial generation (greedy decode
        regenerates it identically).  Returns the evicted request id."""
        rec = self.slots[b]
        if rec is None:
            raise ValueError(f"evict of empty slot {b}")
        self.pool.free(rec.pages)
        self.reserved[rec.shard] -= rec.need_worst
        self.host_table[b, :] = -1
        _set_page_tables(self.cache, self.host_table)
        self.slots[b] = None
        self.pos[b] = -1
        self.toks[b, 0] = 0
        self.queue.appendleft(rec.request)
        self.evictions += 1
        self.journal.append({"ev": "evict", "req": rec.request.req,
                             "slot": b})
        return rec.request.req

    def _youngest_in_shard(self, shard: int) -> Optional[int]:
        best, best_seq = None, -1
        for b, rec in enumerate(self.slots):
            if rec is not None and rec.shard == shard \
                    and rec.admit_seq > best_seq:
                best, best_seq = b, rec.admit_seq
        return best

    def _ensure_pages(self) -> None:
        """Grow every active sequence's pages to cover its next decode
        write; on exhaustion evict the youngest sequence (possibly the
        needy one).  The oldest is never evicted, so it completes."""
        dirty = False
        for b in range(self.B):
            rec = self.slots[b]
            if rec is None:
                continue
            needed = int(self.pos[b]) // self.ps + 1
            while rec is not None and len(rec.pages) < needed:
                got = self.pool.alloc(1, rec.shard)
                if got is not None:
                    self.host_table[b, len(rec.pages)] = got[0]
                    rec.pages.extend(got)
                    dirty = True
                    continue
                victim = self._youngest_in_shard(rec.shard)
                if victim is None:
                    raise RuntimeError("page exhaustion with no active "
                                       "sequence to evict")
                self.evict(victim)
                dirty = False                    # evict() pushed the table
                if victim == b:
                    rec = None
        if dirty:
            _set_page_tables(self.cache, self.host_table)

    # -- decode ------------------------------------------------------------
    def step(self) -> List[int]:
        """One batched decode step over every active slot (inactive rows
        carry pos = -1).  Returns the request ids this step finished."""
        if all(s is None for s in self.slots):
            return []
        self._ensure_pages()
        if all(s is None for s in self.slots):
            return []                            # everything got evicted
        logits, _ = self.decode(self.params, {"tokens": self._tensor(self.toks)},
                                self.cache,
                                self._tensor(self.pos.astype(np.int32)))
        self.decode_steps += 1
        nxt = logits[:, -1].argmax(dim=-1).cpu().numpy()
        finished: List[int] = []
        for b in range(self.B):
            rec = self.slots[b]
            if rec is None:
                continue
            tok = int(nxt[b])
            self.toks[b, 0] = tok
            self.pos[b] += 1
            rec.out_tokens.append(tok)
            self.generated += 1
            rec.remaining -= 1
            if rec.remaining <= 0:
                finished.append(rec.request.req)
                self.finish(b)
        return finished

    def finish(self, b: int) -> None:
        """Complete slot ``b``: free pages, release the reservation, log
        the response (exactly-once by request id)."""
        rec = self.slots[b]
        if rec is None:
            raise ValueError(f"finish of empty slot {b}")
        self.pool.free(rec.pages)
        self.reserved[rec.shard] -= rec.need_worst
        self.host_table[b, :] = -1
        _set_page_tables(self.cache, self.host_table)
        prev = self.responses.get(rec.request.req)
        if prev is not None and prev != rec.out_tokens:
            raise RuntimeError(f"request {rec.request.req} answered twice "
                               f"differently: {prev} vs {rec.out_tokens}")
        self.responses[rec.request.req] = list(rec.out_tokens)
        self.journal.append({"ev": "finish", "req": rec.request.req,
                             "tokens": list(rec.out_tokens)})
        self.slots[b] = None
        self.pos[b] = -1
        self.toks[b, 0] = 0

    # -- snapshot / restore --------------------------------------------------
    def snapshot(self) -> dict:
        """The complete engine state as plain host data; every cache
        tensor (KV pools, local rings, recurrent state, page table; one
        list entry per layer that holds the leaf) is copied off the device
        (the cache is updated in place, so a view would change under the
        snapshot)."""
        def rec_doc(rec: Optional[SeqRecord]):
            if rec is None:
                return None
            return {"req": rec.request.req,
                    "tokens": np.asarray(rec.request.tokens).copy(),
                    "gen_len": rec.request.gen_len,
                    "pages": list(rec.pages), "shard": rec.shard,
                    "need_worst": rec.need_worst,
                    "remaining": rec.remaining,
                    "out_tokens": list(rec.out_tokens),
                    "admit_seq": rec.admit_seq,
                    "n_shared": rec.n_shared,
                    "cached_tokens": rec.cached_tokens}

        return {
            "queue": [(r.req, np.asarray(r.tokens).copy(), r.gen_len)
                      for r in self.queue],
            "slots": [rec_doc(s) for s in self.slots],
            "host_table": self.host_table.copy(),
            "free_lists": [list(f) for f in self.pool.free_lists],
            "high_water": self.pool.high_water,
            "refcount": list(self.pool.refcount),
            "page_meta": {int(p): {"parent": m["parent"], "hash": m["hash"],
                                   "tokens": list(m["tokens"])}
                          for p, m in self.pool.page_meta.items()},
            "prefix_index": [{par: dict(kids) for par, kids in idx.items()}
                             for idx in self.pool.prefix_index],
            "reserved": list(self.reserved),
            "toks": self.toks.copy(),
            "pos": self.pos.copy(),
            "responses": {r: list(t) for r, t in self.responses.items()},
            "journal": [dict(e) for e in self.journal],
            "stats": {"decode_steps": self.decode_steps,
                      "generated": self.generated,
                      "stalled_admissions": self.stalled_admissions,
                      "evictions": self.evictions,
                      "admit_seq": self._admit_seq,
                      "prefill_tokens": self.prefill_tokens,
                      "cached_tokens": self.cached_tokens,
                      "prefix_hits": self.prefix_hits,
                      "prefix_misses": self.prefix_misses,
                      "cow_copies": self.cow_copies},
            "cache": {name: [t.cpu().clone() for t in leaf]
                      if isinstance(leaf, list) else leaf.cpu().clone()
                      for name, leaf in self.cache.items()},
        }

    def restore(self, snap: dict) -> None:
        """Load a :meth:`snapshot` into this (freshly built) engine."""
        if set(snap["cache"]) != set(self.cache):
            raise ValueError(f"snapshot cache holds {sorted(snap['cache'])}, "
                             f"this engine's {sorted(self.cache)}")
        self.queue = deque(Request(req=r, tokens=np.asarray(t), gen_len=g)
                           for r, t, g in snap["queue"])
        self.slots = []
        for doc in snap["slots"]:
            if doc is None:
                self.slots.append(None)
                continue
            self.slots.append(SeqRecord(
                request=Request(req=doc["req"],
                                tokens=np.asarray(doc["tokens"]),
                                gen_len=doc["gen_len"]),
                pages=list(doc["pages"]), shard=doc["shard"],
                need_worst=doc["need_worst"], remaining=doc["remaining"],
                out_tokens=list(doc["out_tokens"]),
                admit_seq=doc["admit_seq"], n_shared=doc["n_shared"],
                cached_tokens=doc["cached_tokens"]))
        self.host_table = np.asarray(snap["host_table"]).copy()
        self.pool.free_lists = [list(f) for f in snap["free_lists"]]
        self.pool.high_water = snap["high_water"]
        self.pool.refcount = list(snap["refcount"])
        self.pool.page_meta = {
            int(p): {"parent": m["parent"], "hash": m["hash"],
                     "tokens": [int(t) for t in m["tokens"]]}
            for p, m in snap["page_meta"].items()}
        self.pool.prefix_index = [
            {par: dict(kids) for par, kids in idx.items()}
            for idx in snap["prefix_index"]]
        self.reserved = list(snap["reserved"])
        self.toks = np.asarray(snap["toks"]).copy()
        self.pos = np.asarray(snap["pos"]).copy()
        self.responses = {r: list(t) for r, t in snap["responses"].items()}
        self.journal = [dict(e) for e in snap["journal"]]
        st = snap["stats"]
        self.decode_steps = st["decode_steps"]
        self.generated = st["generated"]
        self.stalled_admissions = st["stalled_admissions"]
        self.evictions = st["evictions"]
        self._admit_seq = st["admit_seq"]
        self.prefill_tokens = st["prefill_tokens"]
        self.cached_tokens = st["cached_tokens"]
        self.prefix_hits = st["prefix_hits"]
        self.prefix_misses = st["prefix_misses"]
        self.cow_copies = st["cow_copies"]
        c = snap["cache"]
        for name, leaf in self.cache.items():
            if isinstance(leaf, list):
                for i, (dst, src) in enumerate(zip(leaf, c[name],
                                                   strict=True)):
                    if dst.dtype == src.dtype:
                        dst.copy_(src)
                    else:
                        # a carry that decode leaves in the compute dtype
                        # (RWKV's token shift, as the reference's does)
                        leaf[i] = src.to(dst.device, copy=True)
            else:
                leaf.copy_(c[name])

    # -- drive to completion --------------------------------------------------
    def run(self) -> None:
        """Drain the queue: alternate admission rounds and decode steps
        until nothing is queued or active."""
        while not self.idle:
            self.admit()
            if all(s is None for s in self.slots):
                if not self.queue:
                    break                        # drained at prefill
                continue                         # re-admit (gen_len == 1 round)
            self.step()


def synthesize_requests(cfg, sv: ServeSpec, seed: int,
                        ragged: bool = True) -> List[Request]:
    """The deterministic request workload of a ServeSpec, drawn from
    numpy's ``default_rng(seed)``: prompts of ``prompt_len`` tokens cut to
    ragged lengths in [P/2, P] (full length under a shared prefix, so the
    share ratio is exact, and for an engine that is not ragged, as the
    reference's lockstep fallback serves them) and generation budgets in
    [G/2, G]."""
    rng = np.random.default_rng(seed)
    n_req, P, G = sv.requests, sv.prompt_len, sv.gen
    prompts = rng.integers(0, cfg.vocab_size, size=(n_req, P))
    C = int(round(P * sv.shared_prefix_frac))
    if C > 0:
        prompts[:, :C] = prompts[0, :C]
    gen_lens = rng.integers(max(G // 2, 1), G + 1, size=n_req)
    prompt_lens = rng.integers(max(P // 2, 1), P + 1, size=n_req) \
        if ragged and C == 0 else np.full(n_req, P, np.int64)
    return [Request(req=r, tokens=prompts[r, :int(prompt_lens[r])].copy(),
                    gen_len=int(gen_lens[r])) for r in range(n_req)]


# ---------------------------------------------------------------------------
# The real payload of a platform serve job (core/jobspec.py:
# ArchitectureAdapter.payload)
# ---------------------------------------------------------------------------
class RealServePayload:
    """Builds the real serving engine for one platform serve job (the
    reference's ``launch/engine.py:RealServePayload``).  Each pod
    incarnation calls :meth:`build` fresh: the weights are drawn again
    from the job seed, so a restarted container holds the exact model the
    dead one did, and ``ServingEngine.restore`` plus the journal replay
    (``core/server.py``) recover the serving state.  It runs on ``cuda``
    unless constructed with another ``device``, on one card (no mesh)."""

    def __init__(self, spec, device=None):
        self.spec = spec
        self.device = device

    def build(self):
        """``(engine, requests)`` for this job's ServeSpec: fp32 compute
        under ``reduced``, bf16 otherwise, as in the reference."""
        spec, sv = self.spec, self.spec.serve
        cfg = get_config(spec.framework)
        if sv.reduced:
            cfg = cfg.reduced()
        overrides = {"cache_layout": sv.cache_layout or "paged"}
        if sv.page_size:
            overrides["page_size"] = sv.page_size
        cfg = dataclasses.replace(cfg, **overrides)
        dev = resolve_device(self.device)
        model = build_model(cfg, device=dev, seed=spec.seed)
        engine = ServingEngine(
            cfg, model, sv, device=dev,
            dtype=torch.float32 if sv.reduced else torch.bfloat16)
        return engine, synthesize_requests(cfg, sv, spec.seed, engine.ragged)
