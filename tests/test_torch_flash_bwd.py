"""The flash-attention backward's plain version against the reference on
the CPU.

The reference trains by ``jax.grad`` through ``flash_attention_jnp``
(it has no Pallas backward), so the port's plain backward
``flash_attention_bwd_torch`` (P recomputed from the forward's
log-sum-exp) is held against that gradient and against torch autograd of
the plain forward, on the same inputs made with numpy from a seed: hd 64
and 128, G 2 and 3, S 128 and a ragged 77, causal and not, and a window of
32 with a softcap of 30.  Everything is fp32; tolerance 1e-5 of the
largest magnitude of each gradient (the three compute the same sums in
other orders).  The card's kernel is held against this plain version in
``tests/test_torch_cuda.py``.

The bf16 kernels' plan (``flash_bwd_plan``) is checked on its own: every
live (q, k) pair of every head falls in exactly one dK/dV item's walk and
in exactly one dQ item's walk, blocks run their items longest first, and
a block's shared memory fits the card.  Also at hd 256 (recurrentgemma's
local layers: MQA, G 16, a window), where the dK/dV items split the
group's q heads into parts whose fp32 partials are summed: the plain
backward against ``jax.grad``, the plan, and the emulation.  An emulation of the bf16 route
that walks the plan's items with the kernels' roundings (P^T and dS^T
rounded to bf16 before their products, fp32 sums, the exponent in log2
units, each output rounded once) stays within the card's tolerance of
the plain version and of ``jax.grad``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


TOL = 1e-5
LOG2E = 1.4426950408889634

# (B, S, K, G, hd, causal, window, cap)
CASES = [
    (2, 128, 2, 2, 64, True, 0, 0.0),
    (1, 77, 2, 3, 64, True, 0, 0.0),
    (1, 128, 2, 3, 128, True, 0, 0.0),
    (2, 77, 2, 2, 128, False, 0, 0.0),
    (1, 128, 2, 3, 64, False, 0, 0.0),
    (1, 128, 2, 2, 64, True, 32, 30.0),
    (1, 77, 1, 3, 128, True, 32, 30.0),
]


def _ids(c):
    B, S, K, G, hd, causal, window, cap = c
    return (f"S{S}-K{K}-G{G}-hd{hd}-{'causal' if causal else 'full'}"
            + (f"-w{window}-cap{cap:g}" if window else ""))


def _inputs(B, S, K, G, hd, seed=0, hdv=0):
    """q, k at ``hd``; v and dO at ``hdv`` (``hd`` if 0)."""
    hdv = hdv or hd
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, K * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hdv)).astype(np.float32)
    do = rng.normal(size=(B, S, K * G, hdv)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max |err| {err} > {TOL} * {scale}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_jax_grad_and_autograd(case):
    B, S, K, G, hd, causal, window, cap = case
    q, k, v, do = _inputs(B, S, K, G, hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)

    def ref(q_, k_, v_):
        return flash_attention_jnp(q_, k_, v_, **kw)
    out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ot = fa.flash_attention_torch(qt, kt, vt, **kw)
    auto = torch.autograd.grad(ot, (qt, kt, vt), torch.from_numpy(do))

    o, lse = fa.flash_attention_torch(*(torch.from_numpy(a) for a in
                                        (q, k, v)), return_lse=True, **kw)
    _close(o.numpy(), out, "forward")
    got = fa.flash_attention_bwd_torch(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse,
        torch.from_numpy(do), **kw)
    for name, g, w, a in zip("qkv", got, want, auto):
        _close(g.numpy(), w, f"d{name} vs jax.grad")
        _close(g.numpy(), a.numpy(), f"d{name} vs autograd")


@pytest.mark.parametrize("case", CASES[:2] + CASES[-2:], ids=_ids)
def test_plain_forward_lse_is_the_masked_logsumexp(case):
    B, S, K, G, hd, causal, window, cap = case
    q, k, v, _ = _inputs(B, S, K, G, hd, seed=1)
    scale = hd ** -0.5
    _, lse = fa.flash_attention_torch(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=scale,
        causal=causal, window=window, logit_cap=cap, return_lse=True)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64),
                  np.repeat(k, G, axis=2).astype(np.float64)) * scale
    if cap:
        s = cap * np.tanh(s / cap)
    i = np.arange(S)
    live = np.ones((S, S), bool)
    if causal:
        live &= i[None, :] <= i[:, None]
    if window:
        live &= i[:, None] - i[None, :] < window
    s = np.where(live, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    assert lse.shape == (B, K * G, S)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)


def test_the_autograd_function_is_taken_only_for_training():
    """With grad on, ``ops.flash_attention_bshd`` goes through the
    Function, whose backward on CPU tensors is the plain backward (no
    kernel launch counted); under ``inference_mode`` it is the plain
    forward with no graph."""
    B, S, K, G, hd = 1, 77, 2, 3, 64
    q, k, v, do = _inputs(B, S, K, G, hd, seed=2)
    kw = dict(scale=hd ** -0.5, causal=True, window=0, logit_cap=0.0)
    ops.reset_launches()
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention_bshd(qt, kt, vt, **kw)
    assert out.grad_fn is not None \
        and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    o, lse = fa.flash_attention_torch(qt.detach(), kt.detach(), vt.detach(),
                                      return_lse=True, **kw)
    want = fa.flash_attention_bwd_torch(qt.detach(), kt.detach(),
                                        vt.detach(), o, lse,
                                        torch.from_numpy(do), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.launches["flash_attention_bshd"] == 0
    assert ops.launches["flash_attention_bwd"] == 0
    with torch.inference_mode():
        served = ops.flash_attention_bshd(qt, kt, vt, **kw)
    assert served.grad_fn is None
    assert torch.equal(served, out.detach())


def test_backward_wrapper_checks_its_operands():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 2, 64))
    o, lse = fa.flash_attention_torch(q, k, v, scale=0.125, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, lse[:, :, :8], do, scale=0.125)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention_bwd(q, k, v, o, lse.double(), do, scale=0.125)


# -- the bf16 route's plan --------------------------------------------------
PLAN_S = (1, 63, 77, 127, 128, 129, 1000, 4096)
PLAN_MASKS = ((True, 0), (False, 0), (True, 100), (True, 256), (False, 100))
_BLK = 64          # every tile of the plan is a multiple of 64 rows or keys
# (but MLA's 32-row dK/dV stages: its plan is walked in 32-blocks)


def _live_blocks(S, causal, window, blk=_BLK):
    """(nb, nb) bool: whether the blk-row x blk-key block has a live
    pair."""
    i = np.arange(S)
    live = np.ones((S, S), bool)
    if causal:
        live &= i[None, :] <= i[:, None]
    if window:
        live &= i[:, None] - i[None, :] < window
    nb = -(-S // blk)
    pad = np.zeros((nb * blk, nb * blk), bool)
    pad[:S, :S] = live
    return pad.reshape(nb, blk, nb, blk).any(axis=(1, 3))


def _coverage(plan, B, S, H, K, blk=_BLK):
    """Times each (b, head, blk-row block, blk-key block) is walked by
    the dK/dV items (each over its part of the group's q heads: all of
    them but at hd 256) and by the dQ items."""
    G, nb = H // K, -(-S // blk)
    br, bc, bm, bn = (plan[x] // blk for x in ("br", "bc", "bm", "bn"))
    split = plan["kv_split"]
    kv = np.zeros((B, H, nb, nb), np.int32)
    for x, kt, first, end in plan["kv"]["items"]:
        (b, kh), part = divmod(x // split, K), x % split
        assert 0 <= first < end <= -(-S // plan["br"])
        for gi in range(part * G // split, (part + 1) * G // split):
            kv[b, kh * G + gi, first * br:end * br, kt * bc:(kt + 1) * bc] += 1
    dq = np.zeros((B, H, nb, nb), np.int32)
    for bh, mt, first, end in plan["dq"]["items"]:
        b, h = divmod(bh, H)
        assert 0 <= first < end <= -(-S // plan["bn"])
        dq[b, h, mt * bm:(mt + 1) * bm, first * bn:end * bn] += 1
    return kv, dq


@pytest.mark.parametrize("causal,window", PLAN_MASKS,
                         ids=lambda x: str(x))
@pytest.mark.parametrize("S", PLAN_S)
def test_backward_plan_walks_every_live_pair_once(S, causal, window):
    live = _live_blocks(S, causal, window)
    for G in (1, 2, 3, 16):
        for hd, softcap in ((64, False), (64, True), (128, False)):
            B, K = (2, 2) if S <= 1000 else (1, 2)
            H = K * G
            n_sm = 132 if hd == 128 else 7
            plan = fa.flash_bwd_plan(B, S, H, K, hd, causal, window, n_sm,
                                     softcap)
            kv, dq = _coverage(plan, B, S, H, K)
            what = f"S {S} G {G} hd {hd} softcap {softcap}"
            for name, cov in (("dK/dV", kv), ("dQ", dq)):
                assert cov.max() <= 1, f"{what}: {name} walks a block twice"
                assert (cov[:, :, live] == 1).all(), \
                    f"{what}: {name} misses a live block"
            for kern in ("kv", "dq"):
                part = plan[kern]
                assert part["smem"] <= 232_448, (what, kern, part["smem"])
                assert 1 <= part["blocks"] <= n_sm
                assert part["starts"][0] == 0 \
                    and part["starts"][-1] == len(part["items"])
                for costs in part["costs"]:
                    assert costs == sorted(costs, reverse=True), \
                        f"{what}: a {kern} block's items are not longest first"
                offs = sorted(part["offs"].values())
                assert offs[0] == 0 and all(o % 8 == 0 for o in offs)
                assert all(part["offs"][r] % 1024 == 0 for r in
                           (("kv", "ring") if kern == "kv" else ("q", "ring")))
            assert plan["s_pad"] % plan["bm"] == 0 and plan["s_pad"] >= S
            fields = dict(zip(fa.BWD_PLAN_FIELDS, plan["fields"]))
            work = plan["work"]
            n_kv = len(plan["kv"]["items"])
            assert work[fields["kv_items"]:fields["kv_items"] + 4 * n_kv] \
                == [x for it in plan["kv"]["items"] for x in it]
            assert work[fields["dq_starts"]:] == plan["dq"]["starts"]


def test_backward_plan_deals_the_training_shapes_evenly():
    """At the two training shapes on 132 SMs every block gets work and the
    busiest block has at most 5 % more than the average."""
    for B, S, H, K, hd in ((8, 1024, 12, 4, 64), (2, 4096, 16, 8, 128)):
        plan = fa.flash_bwd_plan(B, S, H, K, hd, True, 0, 132)
        for kern in ("kv", "dq"):
            loads = [sum(c) for c in plan[kern]["costs"]]
            assert len(loads) == 132 and min(loads) > 0
            assert max(loads) <= 1.05 * sum(loads) / len(loads), (kern, loads)


# -- the bf16 route's arithmetic ----------------------------------------------
def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulate_bf16_route(q, k, v, o, lse, do, plan, *, scale, causal, window,
                        logit_cap):
    """The bf16 kernels' arithmetic, walking the plan's items: scores and
    dP from bf16 operands with fp32 sums; P = 2^(s scale log2 e - lse log2
    e) (under a softcap 2^(tanh(s scale / cap) cap log2 e - lse log2 e));
    dS = P (dP - D) (times 1 - tanh^2: ((dP - D)(1 - tanh^2)) P, but in
    the hd-256 dK/dV kernel, whose consumer 0 hands P^T (1 - tanh^2) to
    consumer 1, which multiplies it by dP^T - D); P^T and dS^T rounded to
    bf16 for dV += P^T dO, dK += dS^T Q and dQ += dS K; each output scaled
    and rounded to bf16 once.  At hd 256 an item sums its part of the
    group's q heads and the parts' fp32 sums are added in part order before
    the rounding.  Returns (dq, dk, dv) in bf16; an element no item writes
    stays NaN."""
    B, S, H, hd = q.shape
    K, hdv = k.shape[2], v.shape[3]
    G = H // K
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dd = (dof * o.float()).sum(-1)                        # (B, S, H)
    l2 = lse * LOG2E                                      # (B, H, S)
    pos = torch.arange(S)

    def live(rows, keys):
        ok = torch.ones((len(rows), len(keys)), dtype=torch.bool)
        if causal:
            ok &= keys[None, :] <= rows[:, None]
        if window:
            ok &= rows[:, None] - keys[None, :] < window
        return ok

    def p_ds(s, dp, l2r, dr, ok, handed=False):
        if logit_cap:
            th = torch.tanh(s * (scale / logit_cap))
            p = torch.exp2(th * (logit_cap * LOG2E) - l2r)
            ds = (p * (1.0 - th * th)) * (dp - dr) if handed \
                else ((dp - dr) * (1.0 - th * th)) * p
        else:
            p = torch.exp2(s * (scale * LOG2E) - l2r)
            ds = p * (dp - dr)
        return torch.where(ok, p, 0.0), torch.where(ok, ds, 0.0)

    nan = float("nan")
    dq = torch.full((B, S, H, hd), nan)
    dk = torch.full((B, S, K, hd), nan)
    dv = torch.full((B, S, K, hdv), nan)
    split = plan["kv_split"]
    parts = {}
    for x, kt, first, end in plan["kv"]["items"]:
        (b, kh), part = divmod(x // split, K), x % split
        k0, k1 = kt * plan["bc"], min(S, (kt + 1) * plan["bc"])
        acc_k = torch.zeros(k1 - k0, hd)
        acc_v = torch.zeros(k1 - k0, hdv)
        for h in range(kh * G + part * G // split,
                       kh * G + (part + 1) * G // split):
            for qt in range(first, end):
                q0, q1 = qt * plan["br"], min(S, (qt + 1) * plan["br"])
                st = kf[b, k0:k1, kh] @ qf[b, q0:q1, h].T     # S^T
                dpt = vf[b, k0:k1, kh] @ dof[b, q0:q1, h].T   # dP^T
                p, ds = p_ds(st, dpt, l2[b, h, q0:q1][None, :],
                             dd[b, q0:q1, h][None, :],
                             live(pos[q0:q1], pos[k0:k1]).T,
                             handed=plan["bc"] == fa.BWD_BC_SPLIT)
                acc_v += _bf(p) @ dof[b, q0:q1, h]
                acc_k += _bf(ds) @ qf[b, q0:q1, h]
        parts.setdefault((b, kh, k0, k1), [None] * split)[part] = \
            (acc_k, acc_v)
    for (b, kh, k0, k1), got in parts.items():
        acc_k, acc_v = got[0]
        for more_k, more_v in got[1:]:
            acc_k, acc_v = acc_k + more_k, acc_v + more_v
        dk[b, k0:k1, kh] = _bf(acc_k * scale)
        dv[b, k0:k1, kh] = _bf(acc_v)
    for bh, mt, first, end in plan["dq"]["items"]:
        b, h = divmod(bh, H)
        kh = h // G
        r0, r1 = mt * plan["bm"], min(S, (mt + 1) * plan["bm"])
        acc = torch.zeros(r1 - r0, hd)
        for j in range(first, end):
            t0, t1 = j * plan["bn"], min(S, (j + 1) * plan["bn"])
            s = qf[b, r0:r1, h] @ kf[b, t0:t1, kh].T
            dp = dof[b, r0:r1, h] @ vf[b, t0:t1, kh].T
            _, ds = p_ds(s, dp, l2[b, h, r0:r1][:, None],
                         dd[b, r0:r1, h][:, None], live(pos[r0:r1], pos[t0:t1]))
            acc += _bf(ds) @ kf[b, t0:t1, kh]
        dq[b, r0:r1, h] = _bf(acc * scale)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _card_tol(plain):
    """The card's bf16 tolerance (``tests/test_torch_cuda.py:_bwd_tol``,
    ``chip_smoke.py:bwd_tol``): 2^-7 of the largest |plain| of the
    element's 64-row or 64-key tile + 1e-5 + 2^-7·|plain|."""
    B, S, n, hd = plain.shape
    pad = -S % 64
    a = torch.nn.functional.pad(plain.float().abs(), (0, 0, 0, 0, 0, pad))
    a = a.view(B, (S + pad) // 64, 64, n, hd)
    t = a.amax(dim=(2, 4), keepdim=True).expand_as(a)
    t = t.reshape(B, S + pad, n, hd)[:, :S]
    return 2 ** -7 * t + 1e-5 + 2 ** -7 * plain.float().abs()


EMU_CASES = [
    # B, S, K, G, hd, causal, window, cap
    (1, 200, 2, 3, 64, True, 0, 0.0),
    (2, 77, 2, 2, 128, True, 0, 0.0),
    (1, 300, 2, 2, 128, False, 100, 0.0),
    (1, 257, 1, 3, 64, True, 100, 30.0),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=_ids)
def test_bf16_route_emulation_stays_within_the_card_tolerance(case):
    B, S, K, G, hd, causal, window, cap = case
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(B, S, K, G, hd, seed=3))
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    plan = fa.flash_bwd_plan(B, S, K * G, K, hd, causal, window, n_sm=3,
                             softcap=bool(cap))
    got = _emulate_bf16_route(q, k, v, o, lse, do, plan, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)

    def ref(q_, k_, v_):
        return flash_attention_jnp(q_, k_, v_, **kw)
    _, vjp = jax.vjp(ref, *(jnp.asarray(t.float().numpy())
                            for t in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    for name, g, p, w in zip("qkv", got, plain, want):
        assert not torch.isnan(g.float()).any(), f"d{name}: unwritten"
        for what, r in (("plain", p.float()),
                        ("jax.grad", torch.from_numpy(np.array(w)))):
            over = (g.float() - r).abs() / _card_tol(r)
            assert float(over.max()) <= 1.0, \
                f"d{name} vs {what}: {float(over.max()):.3f} of the tolerance"


# -- MLA's pair: q and k 192 wide over v 128 ---------------------------------
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", (1, 31, 77, 129, 1000))
def test_backward_plan_walks_every_live_pair_once_at_mla_s_pair(S, causal):
    """The plan at (192, 128), 32-row dK/dV stages and 64-key dQ stages,
    walked in 32-blocks: every live pair once per kernel, G 1 and 2."""
    live = _live_blocks(S, causal, 0, blk=32)
    for G in (1, 2):
        B, K = 2, 2
        plan = fa.flash_bwd_plan(B, S, K * G, K, 192, causal, 0, 7,
                                 hd_v=128)
        assert (plan["br"], plan["bn"]) == (32, 64)
        kv, dq = _coverage(plan, B, S, K * G, K, blk=32)
        for name, cov in (("dK/dV", kv), ("dQ", dq)):
            assert cov.max() <= 1, f"S {S} G {G}: {name} walks a block twice"
            assert (cov[:, :, live] == 1).all(), \
                f"S {S} G {G}: {name} misses a live block"
        for kern in ("kv", "dq"):
            assert plan[kern]["smem"] <= 232_448
            assert plan[kern]["offs"]["ring"] % 1024 == 0


@pytest.mark.parametrize("S,G", [(77, 1), (257, 2)])
def test_bf16_route_emulation_at_mla_s_pair_stays_within_the_card_tolerance(
        S, G):
    """The bf16 kernels' arithmetic at (192, 128), walking MLA's plan,
    against the plain backward and ``jax.grad``, within the card's
    tolerance."""
    B, K, hd, hdv = 1, 2, 192, 128
    kw = dict(scale=hd ** -0.5, causal=True, window=0, logit_cap=0.0)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(B, S, K, G, hd, seed=5, hdv=hdv))
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    plan = fa.flash_bwd_plan(B, S, K * G, K, hd, True, 0, n_sm=3, hd_v=hdv)
    got = _emulate_bf16_route(q, k, v, o, lse, do, plan, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_jnp(a, b, c, **kw),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    for name, g, p, w in zip("qkv", got, plain, want):
        assert g.shape == p.shape, name
        assert not torch.isnan(g.float()).any(), f"d{name}: unwritten"
        for what, r in (("plain", p.float()),
                        ("jax.grad", torch.from_numpy(np.array(w)))):
            over = (g.float() - r).abs() / _card_tol(r)
            assert float(over.max()) <= 1.0, \
                f"d{name} vs {what}: {float(over.max()):.3f} of the tolerance"


# -- hd 256: recurrentgemma's local layers (MQA, G 16, a window) -------------
@pytest.mark.parametrize("S,window", [(5, 4), (77, 32), (200, 64)])
def test_plain_backward_at_hd256_matches_jax_grad(S, window):
    """K 1, G 16, causal with a window shorter than S: the
    plain backward against ``jax.grad`` of ``flash_attention_jnp`` and
    autograd of the plain forward, within 1e-5 of each gradient's
    largest magnitude."""
    B, K, G, hd = 1, 1, 16, 256
    q, k, v, do = _inputs(B, S, K, G, hd, seed=S)
    kw = dict(scale=hd ** -0.5, causal=True, window=window, logit_cap=0.0)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_jnp(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    auto = torch.autograd.grad(fa.flash_attention_torch(qt, kt, vt, **kw),
                               (qt, kt, vt), torch.from_numpy(do))
    o, lse = fa.flash_attention_torch(*(torch.from_numpy(a) for a in
                                        (q, k, v)), return_lse=True, **kw)
    got = fa.flash_attention_bwd_torch(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse,
        torch.from_numpy(do), **kw)
    for name, g, w, a in zip("qkv", got, want, auto):
        _close(g.numpy(), w, f"d{name} vs jax.grad")
        _close(g.numpy(), a.numpy(), f"d{name} vs autograd")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 100), (False, 64)],
                         ids=lambda x: str(x))
@pytest.mark.parametrize("S", (1, 31, 63, 64, 65, 127, 200, 1000))
def test_backward_plan_walks_every_live_pair_once_at_hd256(S, causal, window):
    """64-key dK/dV items split over parts of the group's q heads,
    64-row q stages and 32-key dQ stages, walked in 32-blocks: every live
    pair of every head once per kernel, at G 1, 2 and 16 (MQA) and on 7
    and 132 SMs; the dK/dV kernel holds one K/V slot, two Q/dO stages and
    two P^T handover buffers; the dQ slot holds Q and dO only (D's O is
    read from device memory) and three stages fit beside it."""
    live = _live_blocks(S, causal, window, blk=32)
    for G in (1, 2, 16):
        for n_sm in (7, 132):
            B, K = 2, 1
            plan = fa.flash_bwd_plan(B, S, K * G, K, 256, causal, window,
                                     n_sm)
            what = f"S {S} G {G} n_sm {n_sm}"
            assert (plan["br"], plan["bc"], plan["bn"]) == (64, 64, 32)
            split = plan["kv_split"]
            assert G % split == 0, what
            n_base = B * K * -(-S // 64)
            assert split == G or n_base * split >= 2 * n_sm, what
            assert plan["part_floats"] == 2 * split * B * S * K * 256
            kv, dq = _coverage(plan, B, S, K * G, K, blk=32)
            for name, cov in (("dK/dV", kv), ("dQ", dq)):
                assert cov.max() <= 1, f"{what}: {name} walks a block twice"
                assert (cov[:, :, live] == 1).all(), \
                    f"{what}: {name} misses a live block"
            assert (plan["kv"]["slots"], plan["kv"]["stages"],
                    plan["kv"]["hands"]) == (1, 2, 2), what
            assert (plan["dq"]["slots"], plan["dq"]["stages"]) == (1, 3)
            assert plan["dq"]["offs"]["ring"] == 128 * 512 * 2
            for kern in ("kv", "dq"):
                assert plan[kern]["smem"] <= 232_448, (what, kern)
                assert plan[kern]["offs"]["ring"] % 1024 == 0
            assert plan["dq"]["stages"] >= 3
            fields = dict(zip(fa.BWD_PLAN_FIELDS, plan["fields"]))
            assert fields["kv_split"] == split and fields["bc"] == 64
            assert (fields["kv_hands"], fields["kv_off_hand"]) == (
                2, plan["kv"]["offs"]["hand"])


HD256_S = (1, 31, 63, 64, 65, 127, 200, 1000)


@pytest.mark.parametrize("S", HD256_S)
def test_hd256_dkdv_regions_are_disjoint_aligned_and_fit(S):
    """The hd-256 dK/dV kernel's shared memory, G 2 and 16, causal with a
    window of 64: the K/V slot, the Q/dO stages, their statistics, the P^T
    handover buffers (64 keys x 64 rows of fp32 each) and the mbarriers
    (a full and an empty one a slot, a stage and a buffer) lie side by
    side without overlap, in that order; the regions a TMA box lands in
    (K/V, stages) start on 1,024 bytes, the buffers on 16 (float4 stores)
    and the mbarriers on 8; the block's end, with 1,024 bytes of slack to
    align its base, is within 232,448."""
    for G in (2, 16):
        plan = fa.flash_bwd_plan(1, S, G, 1, 256, True, 64, 132)
        kv, br, bc = plan["kv"], plan["br"], plan["bc"]
        offs = kv["offs"]
        sizes = dict(kv=kv["slots"] * bc * 512 * 2,
                     ring=kv["stages"] * br * 512 * 2,
                     stats=kv["stages"] * br * 8,
                     hand=kv["hands"] * bc * br * 4,
                     bars=2 * 8 * (kv["slots"] + kv["stages"] + kv["hands"]))
        order = ("kv", "ring", "stats", "hand", "bars")
        assert list(offs) == list(order), offs
        assert offs["kv"] == 0
        for a, b in zip(order, order[1:]):
            assert offs[a] + sizes[a] <= offs[b], (S, G, a, b, offs)
        assert offs["kv"] % 1024 == 0 and offs["ring"] % 1024 == 0
        assert (br * 512 * 2) % 1024 == 0 and (bc * 512 * 2) % 1024 == 0
        assert offs["hand"] % 16 == 0 and offs["bars"] % 8 == 0
        assert offs["bars"] + sizes["bars"] + 1024 == kv["smem"]
        assert kv["smem"] <= fa.BWD_SMEM_LIMIT == 232_448
        fields = dict(zip(fa.BWD_PLAN_FIELDS, plan["fields"]))
        for region in ("kv", "ring", "stats", "hand", "bars"):
            assert fields[f"kv_off_{region}"] == offs[region]


def test_backward_plan_at_recurrentgemma_s_training_shape():
    """(t6)'s microbatch on 132 SMs: 64 key tiles of one kv head split
    into 8 parts of 2 q heads (512 dK/dV items, none longer than 33
    64-row q tiles of 2 heads) and 512 dQ items; the dK/dV kernel holds
    one 64 KB K/V slot, two 64 KB Q/dO stages with 512 bytes of
    statistics each and two 16 KB P^T handover buffers."""
    plan = fa.flash_bwd_plan(1, 4096, 16, 1, 256, True, 2048, 132)
    assert plan["kv_split"] == 8 and plan["br"] == 64
    assert len(plan["kv"]["items"]) == 512
    assert max(it[3] - it[2] for it in plan["kv"]["items"]) == 33
    assert len(plan["dq"]["items"]) == 512
    kv = plan["kv"]
    assert (kv["slots"], kv["stages"], kv["hands"]) == (1, 2, 2)
    assert kv["offs"] == dict(kv=0, ring=65_536, stats=196_608,
                              hand=197_632, bars=230_400)
    assert kv["smem"] == 231_504 <= 232_448
    assert plan["kv"]["blocks"] == plan["dq"]["blocks"] == 132
    loads = [sum(c) for c in plan["kv"]["costs"]]
    assert max(loads) <= 1.05 * sum(loads) / len(loads)


@pytest.mark.parametrize("S,G", [(77, 16), (200, 16), (130, 2)])
def test_bf16_route_emulation_at_hd256_stays_within_the_card_tolerance(S, G):
    """The bf16 kernels' arithmetic at hd 256 with a window, walking the
    plan's items (their q heads split into parts, the parts' fp32 sums
    added in order), against the plain backward and ``jax.grad``, within
    the card's tolerance."""
    B, K, hd = 1, 1, 256
    kw = dict(scale=hd ** -0.5, causal=True, window=64, logit_cap=0.0)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(B, S, K, G, hd, seed=6))
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    plan = fa.flash_bwd_plan(B, S, K * G, K, hd, True, 64, n_sm=3)
    assert G == 2 or plan["kv_split"] > 1
    got = _emulate_bf16_route(q, k, v, o, lse, do, plan, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_jnp(a, b, c, **kw),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    for name, g, p, w in zip("qkv", got, plain, want):
        assert not torch.isnan(g.float()).any(), f"d{name}: unwritten"
        for what, r in (("plain", p.float()),
                        ("jax.grad", torch.from_numpy(np.array(w)))):
            over = (g.float() - r).abs() / _card_tol(r)
            assert float(over.max()) <= 1.0, \
                f"d{name} vs {what}: {float(over.max()):.3f} of the tolerance"


def test_backward_wrapper_refuses_a_softcap_at_hd256():
    """hd 256 trains with a softcap (gemma2's local and global layers) as
    it does without one (recurrentgemma): the card's wrapper takes the cap
    there and refuses it only at MLA's unequal pair, before any launch.
    On the CPU the wrapper is the plain version, cap and all."""
    q = torch.zeros(1, 16, 2, 256, dtype=torch.bfloat16)
    ops._flash_pair("flash_attention_bwd", q, q, dict(logit_cap=50.0),
                    fa.BWD_HEAD_DIM_PAIRS)
    with pytest.raises(ValueError, match="softcap"):
        ops._flash_pair("flash_attention_bwd", q[..., :192], q[..., :128],
                        dict(logit_cap=50.0), fa.BWD_HEAD_DIM_PAIRS)
    qf, kf, vf, dof = (torch.from_numpy(a) for a in
                       _inputs(1, 40, 1, 2, 256, seed=9))
    kw = dict(scale=0.0625, causal=True, window=16, logit_cap=2.0)
    o, lse = fa.flash_attention_torch(qf, kf, vf, return_lse=True, **kw)
    got = ops.flash_attention_bwd(qf, kf, vf, o, lse, dof, **kw)
    want = fa.flash_attention_bwd_torch(qf, kf, vf, o, lse, dof, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


HD256_CAP_CASES = [
    # S, K, G, window, cap: gemma2's G 2 with a window and without; MQA's
    # G 16, whose items split the q heads into parts (kv_split > 1); caps
    # that bind at unit scores (2) and gemma2's 50
    (77, 2, 2, 32, 2.0),
    (130, 2, 2, 0, 2.0),
    (200, 1, 16, 64, 2.0),
    (130, 2, 2, 64, 50.0),
]


def _cap_ids(c):
    S, K, G, window, cap = c
    return f"S{S}-K{K}-G{G}-w{window}-cap{cap:g}"


@pytest.mark.parametrize("case", HD256_CAP_CASES, ids=_cap_ids)
def test_plain_backward_at_hd256_with_a_softcap_matches_jax_grad(case):
    """gemma2's softcap at hd 256: the plain backward against ``jax.grad``
    of ``flash_attention_jnp`` and autograd of the plain forward, within
    1e-5 of each gradient's largest magnitude."""
    S, K, G, window, cap = case
    q, k, v, do = _inputs(1, S, K, G, 256, seed=S + G)
    kw = dict(scale=256 ** -0.5, causal=True, window=window, logit_cap=cap)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_jnp(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    auto = torch.autograd.grad(fa.flash_attention_torch(qt, kt, vt, **kw),
                               (qt, kt, vt), torch.from_numpy(do))
    o, lse = fa.flash_attention_torch(*(torch.from_numpy(a) for a in
                                        (q, k, v)), return_lse=True, **kw)
    got = fa.flash_attention_bwd_torch(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse,
        torch.from_numpy(do), **kw)
    for name, g, w, a in zip("qkv", got, want, auto):
        _close(g.numpy(), w, f"d{name} vs jax.grad")
        _close(g.numpy(), a.numpy(), f"d{name} vs autograd")


@pytest.mark.parametrize("case", HD256_CAP_CASES, ids=_cap_ids)
def test_bf16_route_emulation_at_hd256_with_a_softcap_stays_within_the_card_tolerance(
        case):
    """The bf16 kernels' arithmetic at hd 256 under a softcap: the dK/dV
    kernel's consumer 0 hands P^T (1 - tanh^2) over and consumer 1
    multiplies it by dP^T - D; the dQ kernel forms ((dP - D)(1 - tanh^2))
    P.  Walking the plan (the same as without the cap), against the plain
    backward and ``jax.grad``, within the card's tolerance; the plan's
    tiles and layout are those of the uncapped plan."""
    S, K, G, window, cap = case
    B, hd = 1, 256
    kw = dict(scale=hd ** -0.5, causal=True, window=window, logit_cap=cap)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(B, S, K, G, hd, seed=7 + S))
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    plan = fa.flash_bwd_plan(B, S, K * G, K, hd, True, window, n_sm=3,
                             softcap=True)
    uncapped = fa.flash_bwd_plan(B, S, K * G, K, hd, True, window, n_sm=3)
    assert plan["fields"] == uncapped["fields"]
    assert plan["work"] == uncapped["work"]
    assert G == 2 or plan["kv_split"] > 1
    got = _emulate_bf16_route(q, k, v, o, lse, do, plan, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_jnp(a, b, c, **kw),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    for name, g, p, w in zip("qkv", got, plain, want):
        assert not torch.isnan(g.float()).any(), f"d{name}: unwritten"
        for what, r in (("plain", p.float()),
                        ("jax.grad", torch.from_numpy(np.array(w)))):
            over = (g.float() - r).abs() / _card_tol(r)
            assert float(over.max()) <= 1.0, \
                f"d{name} vs {what}: {float(over.max()):.3f} of the tolerance"
