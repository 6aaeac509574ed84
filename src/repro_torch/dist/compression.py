"""Gradient compression with error feedback (the reference's
``dist/compression.py``).

The gradient all-reduce is a learner step's dominant cross-learner
traffic; compressing it shrinks both the wire time and the window in
which a slow or flaky link stalls the gang, the paper's trade-off between
per-step efficiency and gang-wide robustness.  Every scheme carries its
residual into the next step (error feedback), so the cumulative sent
gradient is exact::

    sum_k  sent_k  +  err_n  ==  sum_k  grad_k          (up to fp rounding)

Two schemes, selected by :class:`CompressionConfig`:

* ``int8``: max-abs scaling to int8 levels, packed for real: the values
  go through :func:`pack_int8` / :func:`unpack_int8` (a flat ``int8``
  payload and one fp32 scale per chunk), so the optimizer sees what the
  int8 all-reduce delivers.  ``chunk_size=0`` scales per tensor.
* ``topk``: magnitude top-k sparsification (the largest ``topk_ratio`` of
  |grad + err| is sent, the rest carried).

The arithmetic follows the reference's order (a division by the scale,
round half to even, clip, then ``int8``; decode as ``payload * scale``),
so pack, unpack and :func:`compress_grads` give the reference's bits on
the CPU.  Top-k selects by a stable descending sort of the magnitudes:
ties go to the lower index, as ``lax.top_k``'s do (``torch.topk``
promises no order among ties).

:func:`allreduce_int8` and :func:`sharded_allreduce_int8` run the int8
wire on ``torch.distributed``: each rank passes its own tensor (the
reference's ``shard_map`` row), the group agrees on the largest scale of
each chunk (a ``MAX`` all-reduce), quantises against it, sums the
payloads as ``int32`` and decodes once.

Trees here are flat ``{name: tensor}`` dicts (the port's parameter
names).  The reference stacks the repeated layers of a model into one
leaf; ``stacks`` (see :func:`compress_grads`) names the port's leaves
that form one reference leaf, so a per-tensor scale or a top-k spans the
same elements on both sides.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class CompressionConfig:
    kind: str = "int8"         # int8 | topk | none
    topk_ratio: float = 0.05   # fraction of entries kept per tensor (topk)
    levels: int = 127          # quantization levels per sign (int8)
    chunk_size: int = 0        # int8 scale granularity; 0 = per tensor

    def __post_init__(self):
        if self.kind not in ("int8", "topk", "none"):
            raise ValueError(f"unknown compression kind {self.kind!r}")
        if self.chunk_size < 0:
            raise ValueError(f"chunk_size must be >= 0, got {self.chunk_size}")


def resolve_compression(
    flag: Union[None, bool, str, CompressionConfig],
) -> Optional[CompressionConfig]:
    """Normalize the bool knob, a kind string or a full config into
    Optional[CompressionConfig] (None = no compression)."""
    if isinstance(flag, CompressionConfig):
        return None if flag.kind == "none" else flag
    if flag is True:
        return CompressionConfig()
    if not flag or flag == "none":
        return None
    return CompressionConfig(kind=str(flag))


def init_error_buffers(params: Tree) -> Tree:
    """An fp32 zero residual per leaf, on the leaf's device (only its
    shape and device are read: a meta-device leaf gives a meta buffer)."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _blocks(t: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """``t`` flattened in fp32, zero-padded to whole chunks, as (n_chunks,
    chunk)."""
    flat = t.detach().float().reshape(-1)
    chunk = chunk_size or flat.numel()
    pad = (-flat.numel()) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, chunk)


def _scales(blocks: torch.Tensor, levels: int) -> torch.Tensor:
    """Each chunk's max-abs / ``levels``.  The divisor is a tensor on the
    blocks' device: CUDA divides by a host scalar as a product with its
    reciprocal, one rounding more than the reference's division."""
    return blocks.abs().amax(dim=1) / torch.full(
        (), float(levels), dtype=torch.float32, device=blocks.device)


def _quantize(blocks: torch.Tensor, scales: torch.Tensor,
              levels: int) -> torch.Tensor:
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.round(blocks / safe[:, None]).clamp_(-levels, levels)
    return q.to(torch.int8)


def pack_int8(t: torch.Tensor, cfg: Optional[CompressionConfig] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a tensor to the int8 wire format.

    Returns ``(payload, scales)``: ``payload`` is a flat ``int8`` tensor of
    ``ceil(size/chunk)·chunk`` entries (zero-padded tail), the bytes the
    all-reduce puts on the wire, and ``scales`` one fp32 max-abs scale per
    chunk (``chunk_size=0``: one chunk spanning the tensor).  A zero chunk
    packs to scale 0 and decodes to exact zeros."""
    cfg = cfg or CompressionConfig()
    blocks = _blocks(t, cfg.chunk_size)
    scales = _scales(blocks, cfg.levels)                     # (n_chunks,)
    return _quantize(blocks, scales, cfg.levels).reshape(-1), scales


def unpack_int8(payload: torch.Tensor, scales: torch.Tensor, shape,
                dtype=torch.float32) -> torch.Tensor:
    """Decode the int8 wire format back to values (``shape`` drops the
    pack-time zero padding)."""
    n = 1
    for d in shape:
        n *= int(d)
    blocks = payload.reshape(scales.shape[0], -1).float()
    vals = blocks * torch.where(scales > 0, scales,
                                torch.zeros_like(scales))[:, None]
    return vals.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def wire_bytes_int8(t: torch.Tensor, cfg: Optional[CompressionConfig] = None,
                    ) -> int:
    """Bytes an int8-compressed all-reduce puts on the wire for ``t``:
    1 byte an element (padded to the chunk) + 4 bytes a chunk scale."""
    cfg = cfg or CompressionConfig()
    size = t.numel()
    chunk = cfg.chunk_size or size
    n_chunks = -(-size // chunk) if size else 0
    return n_chunks * chunk + 4 * n_chunks


def allreduce_int8(x: torch.Tensor, group=None,
                   cfg: Optional[CompressionConfig] = None) -> torch.Tensor:
    """int8 all-reduce of each rank's ``x`` over ``group`` (the default
    group when None), the reference's ``allreduce_int8`` under
    ``shard_map``.  Per chunk of ``cfg.chunk_size`` elements:

    1. every rank computes its local max-abs scale and the group takes
       the largest (a ``MAX`` all-reduce): all ranks must quantize against
       the same scale or the summed payloads mean nothing;
    2. each rank quantizes against the shared scale (a real ``int8``
       payload: the bytes on the wire);
    3. the payloads are summed widened to ``int32`` (ndev · 127 a lane,
       far from overflow);
    4. the sum is decoded once with the shared scale.

    Each rank rounds to its nearest level, at most scale/2 an element, so
    ``|int8_sum - exact_sum| <= ndev · scale/2`` (scale = the chunk's
    max-abs over ranks / levels); error feedback in :func:`compress_grads`
    carries such a residual forward.  On one rank the result is the
    pack/unpack round trip.  Returns the sum, on every rank, in ``x``'s
    shape and dtype."""
    import torch.distributed as dist

    cfg = cfg or CompressionConfig()
    blocks = _blocks(x, cfg.chunk_size)
    scales = _scales(blocks, cfg.levels)
    dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=group)
    total = _quantize(blocks, scales, cfg.levels).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    vals = total.float() * torch.where(scales > 0, scales,
                                       torch.zeros_like(scales))[:, None]
    return vals.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)


def sharded_allreduce_int8(x: torch.Tensor, mesh, axis: str = "data",
                           cfg: Optional[CompressionConfig] = None,
                           ) -> torch.Tensor:
    """All-reduce the learners' contributions over mesh axis ``axis`` of a
    ``DeviceMesh``: each rank passes its own tensor (the reference's row of
    its stacked ``(ndev, ...)`` input) and gets the int8-wire sum, the
    same on every rank of the axis's group (:func:`allreduce_int8`)."""
    return allreduce_int8(x, mesh.get_group(axis), cfg)


def _int8_leaf(t: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    # the values path IS the wire path: quantize to the packed int8
    # payload and per-chunk scales, then decode what the wire delivers
    payload, scales = pack_int8(t, cfg)
    return unpack_int8(payload, scales, t.shape, t.dtype)


def _topk_leaf(t: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """Keep (at most) the k largest-magnitude entries, ties to the lower
    index.  Selecting by index, not by a threshold ``|t| >= kth``, keeps a
    zero (1 - ratio) quantile from turning top-k into the identity and
    ties at the threshold from sending more than k entries; a selected
    zero is not sent (sending a zero is sending nothing)."""
    k = max(1, int(round(t.numel() * cfg.topk_ratio)))
    flat = t.reshape(-1)
    mag = flat.abs()
    idx = torch.sort(mag, descending=True, stable=True).indices[:k]
    keep = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    keep[idx] = mag[idx] > 0
    return torch.where(keep.reshape(t.shape), t, torch.zeros_like(t))


def _leaf_groups(names: Iterable[str],
                 stacks: Optional[Sequence[Sequence[str]]]):
    """The names in groups: each stack as one group, every other name
    alone."""
    names = list(names)
    groups = [list(s) for s in stacks or ()]
    stacked = {n for s in groups for n in s}
    return groups + [[n] for n in names if n not in stacked]


def compress_grads(grads: Tree, err: Tree,
                   cfg: Optional[CompressionConfig] = None,
                   stacks: Optional[Sequence[Sequence[str]]] = None,
                   ) -> Tuple[Tree, Tree]:
    """(grads, err) -> (sent grads, new err): what the wire delivers after
    the all-reduce, and the residual ``(grad + err) - sent`` carried
    forward.  ``stacks`` lists groups of names compressed as one tensor,
    stacked in the order given along a new leading dim (the reference's
    scanned layer stacks; ``convert.reference_stacks``); every other leaf
    is compressed alone.  ``grads`` and ``err`` are not changed."""
    cfg = cfg or CompressionConfig()
    if cfg.kind == "none":
        return grads, err
    leaf = _int8_leaf if cfg.kind == "int8" else _topk_leaf
    sent_all: Tree = {}
    err_all: Tree = {}
    for group in _leaf_groups(grads, stacks):
        # a leaf alone is a stack of one: the same elements in the same
        # order, so the same scale and the same top k
        target = torch.stack([grads[n].float() + err[n] for n in group])
        sent = leaf(target, cfg)
        new_err = target - sent
        for i, n in enumerate(group):
            sent_all[n] = sent[i].to(grads[n].dtype)
            err_all[n] = new_err[i]
    return ({n: sent_all[n] for n in grads}, {n: err_all[n] for n in grads})
