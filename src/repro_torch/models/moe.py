"""Mixture-of-Experts FFN (the reference's ``models/moe.py:moe_ffn``):
dropless routing for serving, capacity dispatch and the load-balancing
aux loss for training.

Serving (``dropless=True`` in the reference) sweeps every token through
all E experts and weights the experts it did not choose by 0 (one dense
einsum per projection).  An unchosen expert adds exactly 0, so the port
computes the same function over the chosen (token, expert) pairs only:
the pairs are sorted by expert and each expert that has tokens runs its
SwiGLU as one ``torch.matmul`` per projection.  At deepseek-v2's width a
prefill round of 8,192 tokens would otherwise build (8,192, 160, 1,536)
activations, 4 GB for each of the gate and up projections, for 160 / 6
≈ 27× the work.

Training (``dropless=False``) is GShard's capacity dispatch: each row's
tokens in groups of ``Sg = min(moe_group_size, S)``, each expert taking
at most ``C`` (token, choice) pairs a group in token-major, choice-major
order; a pair past its expert's ``C`` is dropped (gate 0).  The
reference builds one-hot (G, Sg, E, C) dispatch and combine tensors and
contracts them with einsums; the port computes the same function with
static shapes and no host sync: slots from a ``cumsum`` over the
one-hot choices (laid out (G, E, Sg·k)), the kept tokens gathered into an
(E, G·C, D) buffer, each SwiGLU projection one ``torch.bmm`` over the
experts, and each token's k outputs gathered back and combined by a
batched product with its gates.  An empty slot or a dropped pair adds
exactly 0 in the reference's einsums; here an empty slot computes some
token's row that no gate reads, and a dropped pair reads some slot
through gate 0, so for finite values the function and its gradients
are the reference's (ROADMAP D8).  Gradients come from autograd
through the index ops.  Each part runs in a ``torch.profiler`` range
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
``moe.aux``) that a traced step's breakdown reads.

Numerics follow the reference's mixed dtypes: router logits from a matmul
in the compute dtype, then fp32 softmax, top-k and renormalisation; each
expert's SwiGLU in the compute dtype; the shared experts in the compute
dtype.  The combine differs by mode, as in the reference: serving sums
the weighted experts in fp32 and casts once; training casts the gates to
the compute dtype and contracts in it (``comb.astype(dt)``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation

MOE_GROUP_SIZE = 1024     # the reference's tokens per dispatch group


def group_size(cfg: ModelConfig, S: int) -> int:
    """Tokens per dispatch group for rows of ``S`` tokens: groups never
    span rows (the reference's ``Sg = min(group, S)``)."""
    return min(cfg.moe_group_size or MOE_GROUP_SIZE, S)


def check_row_length(cfg: ModelConfig, S: int) -> None:
    """The reference groups each row's tokens by ``Sg = min(group, S)``
    and asserts ``S % Sg == 0`` on every call, serving included
    (moe.py:48): a row longer than one group must be a whole number of
    groups."""
    Sg = group_size(cfg, S)
    if S % Sg:
        raise ValueError(
            f"{cfg.name}: a row of {S} tokens is not a whole number of MoE "
            f"dispatch groups of {Sg}; the reference asserts S % Sg == 0 "
            "(moe.py) and refuses it, so the port does too")


def capacity(cfg: ModelConfig, Sg: int) -> int:
    """(token, choice) pairs an expert takes per group in training (the
    reference's ``max(1, int(Sg·k/E·capacity_factor))``; 320 for
    granite-moe at S >= 1,024)."""
    return max(1, int(Sg * cfg.num_experts_per_tok / cfg.num_experts
                      * cfg.capacity_factor))


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def route(logits: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` routing of fp32 router ``logits (T, E)``: softmax, the
    ``k`` most probable experts, their probabilities renormalised to sum
    to 1 (divided by ``max(sum, 1e-9)``).  Returns ``(weights (T, k) fp32,
    experts (T, k) int64)``, most probable first.

    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them:
    ``torch.topk`` promises no order among equal values, and bf16 router
    logits tie often, so the experts come from a stable descending sort."""
    return _top_k(torch.softmax(logits, dim=-1), k)


def moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
            *, mode: str = "serve"):
    """Routed experts (top-k of ``num_experts``) plus the shared experts,
    for ``x (B, S, D)`` in the compute dtype.  ``mode="serve"`` returns
    ``(B, S, D)``, each token's output depending on that token alone
    (dropless routing); ``mode="train"`` returns ``(out (B, S, D), aux)``
    under capacity dispatch (:func:`moe_ffn_train`)."""
    if mode == "train":
        return moe_ffn_train(cfg, p, x)
    if mode != "serve":
        raise ValueError(f"mode {mode!r}: serve or train")
    B, S, D = x.shape
    check_row_length(cfg, S)
    k = cfg.num_experts_per_tok
    dt = x.dtype
    xt = x.reshape(B * S, D)
    T = xt.shape[0]
    weights, experts = route((xt @ p["router"]).float(), k)

    # the (token, choice) pairs grouped by expert; one host read of the
    # per-expert counts sizes the slices
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=cfg.num_experts).tolist()
    ye = torch.empty((T * k, D), dtype=dt, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        pairs = order[start:start + n]
        start += n
        xe = xt[pairs // k]
        h = activation(xe @ p["we_g"][e], cfg.act) * (xe @ p["we_u"][e])
        ye[pairs] = h @ p["we_d"][e]
    ye = ye.view(T, k, D)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(k):
        out.addcmul_(ye[:, j].float(), weights[:, j:j + 1])
    out = out.to(dt).view(B, S, D)

    return _shared(cfg, p, x, out)


def _shared(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    """``out`` plus the always-on shared experts, if the config has any."""
    if not cfg.num_shared_experts:
        return out
    hs = activation(x @ p["ws_g"], cfg.act) * (x @ p["ws_u"])
    return out + hs @ p["ws_d"]


def moe_ffn_train(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_ffn(..., dropless=False)`` for ``x (B, S, D)``
    in the compute dtype: ``(out (B, S, D), aux)``, ``aux`` the fp32
    load-balancing loss ``E · Σ_e mean(probs)_e · (choices of e / (T·k))
    · router_aux_loss_coef``, counting every chosen pair, kept or
    dropped.  Static shapes, no host sync (see the module docstring)."""
    B, S, D = x.shape
    check_row_length(cfg, S)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    Sg = group_size(cfg, S)
    G, C = T // Sg, capacity(cfg, Sg)
    dt, dev = x.dtype, x.device
    xt = x.reshape(T, D)
    with record_function("moe.route"):
        probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
        weights, experts = _top_k(probs, k)                # (T, k)

    with record_function("moe.dispatch"):
        # GShard priority: a pair's slot is the number of pairs of its
        # group ahead of it (token-major, then choice-major) that chose
        # its expert; the one-hot choices are laid out (G, E, Sg·k) so
        # that the count runs along the innermost dimension
        flat = experts.reshape(G, 1, Sg * k)
        onehot = (flat == torch.arange(E, device=dev)[:, None]).int()
        ahead = onehot.cumsum(-1, dtype=torch.int32) - onehot
        pos = ahead.gather(1, flat).view(T, k)
        keep = pos < C
        # row of each kept pair in the (E·G·C, D) buffer
        group = torch.arange(T, device=dev).div(Sg, rounding_mode="floor")
        slot = experts * (G * C) + group[:, None] * C + pos
        # the token of every slot.  An empty slot takes some token's row
        # and a dropped pair reads some slot, both spread so that no row
        # is read many times (the index ops' backward accumulates a row's
        # reads one after another); nothing combines them but gate 0.
        # Dropped pairs all write one spare entry past the end.
        rows = E * G * C
        src = torch.arange(rows + 1, device=dev) % T
        tok = torch.arange(T, device=dev)[:, None].expand(T, k)
        src[torch.where(keep, slot, rows)] = tok
        xd = xt[src[:-1]].view(E, G * C, D)
        pair = torch.arange(T * k, device=dev).view(T, k) % rows
        slot = torch.where(keep, slot, pair)

    with record_function("moe.experts"):
        h = activation(torch.bmm(xd, p["we_g"]), cfg.act) \
            * torch.bmm(xd, p["we_u"])
        ye = torch.bmm(h, p["we_d"]).view(E * G * C, D)

    with record_function("moe.combine"):
        # in the compute dtype: each token's k outputs by its gates
        gates = (weights * keep).to(dt)
        out = torch.bmm(gates[:, None], ye[slot]).view(B, S, D)
    out = _shared(cfg, p, x, out)

    with record_function("moe.aux"):
        me = probs.mean(0)                                 # mean prob per e
        ce = onehot.sum((0, 2)).float() / T / k            # share of choices
        aux = E * torch.sum(me * ce) * cfg.router_aux_loss_coef
    return out, aux
