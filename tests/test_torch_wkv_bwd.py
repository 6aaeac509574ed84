"""The WKV6 backward kernel's chunked algebra, emulated on the CPU.

``csrc/rwkv6_wkv_bwd.cu`` computes WKV6's gradient in two passes:

* pass 1 walks the segments of ``wkv.SEG`` steps in reverse and keeps the
  state's gradient G at every segment's last step, G <- diag(P) G +
  (r ⊙ Pex)ᵀ dO;
* pass 2 takes every (batch, head, segment) on its own: it rebuilds the
  state before every chunk of 16 steps from the segment's checkpoint, then
  walks the chunks in reverse with the chunked form transposed, dlw
  included as rowsum(dS_t ⊙ S_{t-1}) expanded into the chunk's boundary
  matrices and its steps, and the pairs of steps across the chunk's two
  halves as matrix products (their decay factors into the halves' own).

Every decay is a running product of factors exp(lw) <= 1.  ``_emulate``
below is that algebra in plain PyTorch, its matrix products in split TF32
as the tensor cores take them (an fp32 operand as hi + lo, rounded by bit
operations as ``cvt.rna.tf32.f32`` rounds; lo.hi + hi.lo + hi.hi; the
kernel truncates instead where a product's result is an output, which
moves it by less than 2^-20 of each term), but for Bm's diagonal do_t ·
v_t, which du and the bonus terms of dr and dk take alone: an fp32 dot
product, as the kernel computes it on the CUDA cores.  It is
held against ``jax.grad`` of the reference's ``models/rwkv.py:
wkv6_chunked`` and against the plain backward ``wkv6_bwd_torch``, over
N 16, 32 and 64, S 1, S below, at and one past a segment, a ragged S over
several segments, with nonzero s0 and ds_final; and where the reference
goes NaN (R4: lw -3, -8, down to -e^4) against autograd through the step
oracle.  Change it with the kernel.

Tolerance: each gradient within 1e-5 of its largest magnitude (fp32; the
sums run in another order than the reference's and the step recurrence's).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv as ref_rwkv  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


CHUNK = 16            # pass 2's chunk (csrc/rwkv6_wkv_bwd.cu: L)
TOL = 1e-5
NAMES = ("dr", "dk", "dv", "dlw", "du", "ds0")


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b):
    """a @ b from the operands' TF32 parts (a bf16 or smaller value is
    exact in TF32, so its lo is 0 and the kernel leaves that product out:
    the sum is the same)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulate(r, k, v, lw, u, ckpt, do, ds_fin, seg=wkv.SEG, L=CHUNK):
    """The two passes on (B, S, H, N) inputs; returns what
    ``wkv6_bwd_torch`` returns."""
    B, S, H, N = r.shape
    BH = B * H

    def fold(t):
        return t.float().transpose(1, 2).reshape(BH, S, N)

    r, k, v, do = map(fold, (r, k, v, do))
    w = torch.exp(fold(lw))
    u = u.float()[None].expand(B, H, N).reshape(BH, N)
    ckpt = ckpt.float().reshape(BH, -1, N, N)
    nseg = ckpt.shape[1]
    ones = torch.ones(BH, N)

    # pass 1: G at every segment's last step, then ds0
    g = torch.zeros(BH, N, N) if ds_fin is None \
        else ds_fin.float().reshape(BH, N, N).clone()
    ds_end = [None] * nseg
    for j in reversed(range(nseg)):
        t0, t1 = j * seg, min((j + 1) * seg, S)
        ds_end[j] = g
        p, rd = ones, []
        for t in range(t0, t1):
            rd.append(r[:, t] * p)
            p = p * w[:, t]
        g = p[..., None] * g + _mm(torch.stack(rd, 1).transpose(1, 2),
                                   do[:, t0:t1])
    ds0 = g

    # pass 2: each segment on its own
    dr, dk, dv, dlw = (torch.zeros(BH, S, N) for _ in range(4))
    du = torch.zeros(BH, N)
    for j in range(nseg):
        t0, t1 = j * seg, min((j + 1) * seg, S)
        chunks = [(a, min(a + L, t1)) for a in range(t0, t1, L)]
        states = [ckpt[:, j]]                  # before every chunk
        for a, b in chunks[:-1]:
            p, kd = ones, [None] * (b - a)
            for t in reversed(range(a, b)):
                kd[t - a] = k[:, t] * p
                p = p * w[:, t]
            states.append(p[..., None] * states[-1]
                          + _mm(torch.stack(kd, 1).transpose(1, 2),
                                v[:, a:b]))
        ds = ds_end[j]
        for (a, b), s0 in reversed(list(zip(chunks, states))):
            _chunk(a, b, s0, ds, w, r, k, v, do, u, dr, dk, dv, dlw, du)
            p = ones
            for t in range(a, b):
                p = p * w[:, t]
            rd = torch.stack([r[:, t] * _prod(w, a, t, ones)
                              for t in range(a, b)], 1)
            ds = p[..., None] * ds + _mm(rd.transpose(1, 2), do[:, a:b])

    def unfold(t):
        return t.reshape(B, H, S, N).transpose(1, 2)

    return (unfold(dr), unfold(dk), unfold(dv), unfold(dlw),
            du.reshape(B, H, N).sum(0), ds0.reshape(B, H, N, N))


def _prod(w, a, b, ones):
    """prod_{a <= s < b} w_s, channel-wise, as a running product."""
    p = ones
    for s in range(a, b):
        p = p * w[:, s]
    return p


def _chunk(a, b, s0, ds, w, r, k, v, do, u, dr, dk, dv, dlw, du):
    """One chunk [a, b) of pass 2, given the state before it (s0) and the
    gradient at its last step (ds), as the kernel splits it: halves of
    L / 2 steps; the pairs (i < t) within a half by running products of
    w; the pairs across the halves, whose decay D(i, t) = Psuf_i Pex_t
    factors into the halves' own products, as matrix products."""
    BH, N = u.shape
    ones = torch.ones(BH, N)
    n, hl = b - a, CHUNK // 2
    wc, rc, kc, vc, dc = (x[:, a:b] for x in (w, r, k, v, do))

    def half(t):
        return (0, min(hl, n)) if t < hl else (hl, n)

    # the halves' own decays: r Pex and k Psuf within the half (rds, kds)
    # and their products; the chunk's from them
    rds, kds = torch.zeros(BH, n, N), torch.zeros(BH, n, N)
    for t in range(n):
        h0, h1 = half(t)
        rds[:, t] = rc[:, t] * _prod(wc, h0, t, ones)
        kds[:, t] = kc[:, t] * _prod(wc, t + 1, h1, ones)
    p0, p1 = _prod(wc, 0, min(hl, n), ones), _prod(wc, hl, n, ones)
    p_l = p0 * p1
    pex = torch.stack([_prod(wc, 0, t, ones) for t in range(n)], 1)
    psuf = torch.stack([_prod(wc, t + 1, n, ones) for t in range(n)], 1)
    rd, kd = rc * pex, kc * psuf
    x = _mm(dc, s0.transpose(1, 2))                     # [t][c]
    y = _mm(vc, ds.transpose(1, 2))                     # [i][c]
    bm = _mm(dc, vc.transpose(1, 2))                    # [t][i]
    tt = (s0 * ds).sum(-1)
    # across the halves (t in the second, i in the first): A, R = Bm kds,
    # Q = Bm^T rds
    lo, hi = slice(0, min(hl, n)), slice(hl, n)
    a_x = _mm(rds[:, hi], kds[:, lo].transpose(1, 2))   # [t - hl][i]
    rr_ = _mm(bm[:, hi, lo], kds[:, lo])                # [t - hl][c]
    qq = _mm(bm[:, hi, lo].transpose(1, 2), rds[:, hi])  # [i][c]
    a_mat = torch.zeros(BH, n, n)
    for t in range(n):
        h0, _ = half(t)
        xx = rc[:, t]
        for i in reversed(range(h0, t)):
            a_mat[:, t, i] = (xx * kc[:, i]).sum(-1)
            xx = xx * wc[:, i]
        a_mat[:, t, t] = (rc[:, t] * u * kc[:, t]).sum(-1)
    a_mat[:, hi, lo] = a_x
    dv[:, a:b] = _mm(kd, ds) + _mm(a_mat.transpose(1, 2), dc)
    rx, ky = rd * x, kd * y
    # the cross terms of dlw: sum_{i<t} kds_i Q_i in the first half,
    # sum_{s>t} rds_s R_s in the second
    kq = kds[:, lo] * qq
    rr2 = rds[:, hi] * rr_
    for t in range(n):
        h0, h1 = half(t)
        alpha = {i: _prod(wc, i + 1, t, ones) * kc[:, i] for i in range(h0, t)}
        beta = {s: _prod(wc, t + 1, s, ones) * rc[:, s]
                for s in range(t + 1, h1)}
        diag = (dc[:, t] * vc[:, t]).sum(-1, keepdim=True)
        g_r = pex[:, t] * x[:, t] + u * kc[:, t] * diag
        for i in alpha:
            g_r = g_r + alpha[i] * bm[:, t, i, None]
        g_k = psuf[:, t] * y[:, t] + u * rc[:, t] * diag
        for s in beta:
            g_k = g_k + beta[s] * bm[:, s, t, None]
        tri = torch.zeros(BH, N)
        for s in beta:
            inner = torch.zeros(BH, N)
            for i in alpha:
                inner = inner + alpha[i] * bm[:, s, i, None]
            tri = tri + beta[s] * inner
        if t >= hl:        # the second half: pairs with the first
            g_r = g_r + _prod(wc, hl, t, ones) * rr_[:, t - hl]
            cross = rr2[:, t - hl + 1:].sum(1)
        else:
            g_k = g_k + _prod(wc, t + 1, min(hl, n), ones) * qq[:, t]
            cross = kq[:, :t].sum(1)
        dr[:, a + t], dk[:, a + t] = g_r, g_k
        dlw[:, a + t] = p_l * tt + rx[:, t + 1:].sum(1) \
            + ky[:, :t].sum(1) + wc[:, t] * tri + cross
        du += rc[:, t] * kc[:, t] * diag


def _case(seed, B, S, H, N, decay="mixed"):
    """r, k, v, dO ~ N(0, 1); lw = -exp(U(-6, 1)) ("mixed"), a constant,
    or -exp(U(-6, 4)) ("strong"); u ~ 0.5 N(0, 1); s0 and ds_final ~
    0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.normal(size=(B, S, H, N)) for _ in range(4))
    if decay == "mixed":
        lw = -np.exp(rng.uniform(-6, 1, (B, S, H, N)))
    elif decay == "strong":
        lw = -np.exp(rng.uniform(-6, 4, (B, S, H, N)))
    else:
        lw = np.full((B, S, H, N), decay)
    u = 0.5 * rng.normal(size=(H, N))
    s0, dsf = (0.3 * rng.normal(size=(B, H, N, N)) for _ in range(2))
    return [a.astype(np.float32) for a in (r, k, v, lw, u, s0, do, dsf)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _both(args):
    """The emulation and ``wkv6_bwd_torch`` from the plain forward's
    checkpoints."""
    r, k, v, lw, u, s0, do, dsf = map(_t, args)
    _, _, ckpt = wkv.wkv6_torch(r, k, v, lw, u, s0, seg=wkv.SEG)
    return (_emulate(r, k, v, lw, u, ckpt, do, dsf),
            wkv.wkv6_bwd_torch(r, k, v, lw, u, ckpt, do, dsf))


def test_segment_matches_the_kernels():
    """SEG is a multiple of the forward kernel's chunk (8) and of pass 2's
    (16), and is the segment the backward kernel is compiled for."""
    src = (_build.CSRC / "rwkv6_wkv_bwd.cu").read_text()
    assert int(re.search(r"constexpr int SEG = (\d+);", src)[1]) == wkv.SEG
    assert int(re.search(r"constexpr int L = (\d+);", src)[1]) == CHUNK
    assert wkv.SEG % 8 == 0 and wkv.SEG % CHUNK == 0


SEG = wkv.SEG
LENGTHS = {"S1": 1, "below a segment": SEG - 24, "one short of a segment":
           SEG - 1, "a segment": SEG, "a segment and a step": SEG + 1,
           "ragged over three segments": 2 * SEG + 22}


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("S", sorted(LENGTHS.values()),
                         ids=sorted(LENGTHS, key=LENGTHS.get))
def test_emulation_matches_jax_grad_and_the_plain_backward(S, N):
    """The reference at its chunk of 32."""
    args = _case(S * N + 7, 2, S, 2, N)
    r, k, v, lw, u, s0, do, dsf = args

    def loss(r, k, v, lw, u, s0):
        o, s_fin = ref_rwkv.wkv6_chunked(r, k, v, lw, u, s0, 32)
        return (o * do).sum() + (s_fin * dsf).sum()

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (r, k, v, lw, u, s0)))
    got, plain = _both(args)
    for name, g, w, p in zip(NAMES, got, want, plain):
        _close(g.numpy(), np.asarray(jax.device_get(w)), name)
        _close(g.numpy(), p.numpy(), f"{name} vs plain")


def _step_oracle(r, k, v, lw, u, s0):
    B, S, H, N = r.shape

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, N)

    o, s_fin = ref.wkv6_ref(fold(r), fold(k), fold(v), fold(lw),
                            u[None].expand(B, H, N).reshape(B * H, 1, N),
                            s0.reshape(B * H, N, N))
    return o.reshape(B, H, S, N).transpose(1, 2), s_fin.reshape(B, H, N, N)


@pytest.mark.parametrize("decay", [-3.0, -8.0, "strong"])
def test_emulation_at_strong_decays(decay):
    """Where the reference's jnp chunks go NaN (R4): against autograd
    through the step oracle; the decays underflow to 0 as running products
    and nothing overflows."""
    args = _case(13, 2, SEG + 30, 2, 64, decay)
    r, k, v, lw, u, s0, do, dsf = args
    got, plain = _both(args)
    leaves = [_t(a).requires_grad_(True) for a in (r, k, v, lw, u, s0)]
    o, s_fin = _step_oracle(*leaves)
    want = torch.autograd.grad((o * _t(do)).sum() + (s_fin * _t(dsf)).sum(),
                               leaves)
    for name, g, w, p in zip(NAMES, got, want, plain):
        assert bool(torch.isfinite(g).all()), name
        _close(g.numpy(), w.numpy(), name)
        _close(g.numpy(), p.numpy(), f"{name} vs plain")


def _dlw_f64(r, k, v, lw, u, s0, do, dsf):
    """dlw_t = w_t rowsum(dS_t ⊙ S_{t-1}) by the step recurrence in fp64."""
    r, k, v, lw, do = (torch.from_numpy(a).double().transpose(1, 2)
                       for a in (r, k, v, lw, do))
    w = torch.exp(lw)
    s = [torch.from_numpy(s0).double()]
    for t in range(r.shape[2]):
        s.append(w[:, :, t, :, None] * s[-1]
                 + k[:, :, t, :, None] * v[:, :, t, None, :])
    ds = torch.from_numpy(dsf).double()
    out = torch.empty_like(r)
    for t in reversed(range(r.shape[2])):
        out[:, :, t] = w[:, :, t] * (ds * s[t]).sum(-1)
        ds = w[:, :, t, :, None] * ds \
            + r[:, :, t, :, None] * do[:, :, t, None, :]
    return out.transpose(1, 2), s


def test_dlw_expansion_keeps_its_precision_where_cumulative_sums_lose_it(
        capsys):
    """dlw against the fp64 step recurrence, within 1e-5 of its largest
    magnitude, at decays down to -e^4 and at lw -8 and -3: the kernel's
    expansion (every term a sum of products of factors w <= 1) holds it
    everywhere; the cumulative-sum identity, a difference of sums as large
    as the state terms, misses it by more than 10x at lw -8, where dlw is
    small (w = 3.4e-4).  Prints both errors."""
    for decay in ("strong", -8.0, -3.0):
        args = _case(29, 1, 2 * SEG, 2, 64, decay)
        want, states = _dlw_f64(*args)
        got, _ = _both(args)
        scale = want.abs().max().item()
        err = (got[3].double() - want).abs().max().item() / scale
        # the boundary term at every segment's last step from the fp64
        # recurrence, the rest from the emulation's fp32 gradients
        ends = _segment_end_terms(args, states)
        ident = _cumulative_identity(args, got, ends)
        ident_err = (ident.double() - want).abs().max().item() / scale
        with capsys.disabled():
            print(f"\n  dlw at decay {decay}: expansion {err:.3g}, "
                  f"cumulative sums {ident_err:.3g} of max |dlw| "
                  f"{scale:.4g}")
        assert err <= TOL, (decay, err)
        if decay == -8.0:
            assert ident_err > 10 * TOL, ident_err


def _segment_end_terms(args, states):
    """rowsum(dS_e ⊙ S_e) at every segment's last step e, in fp64."""
    r, k, v, lw, u, s0, do, dsf = args
    r, lw, do = (torch.from_numpy(a).double().transpose(1, 2)
                 for a in (r, lw, do))
    w = torch.exp(lw)
    S = r.shape[2]
    ds = torch.from_numpy(dsf).double()
    ends = {}
    for t in reversed(range(S)):
        if (t + 1) % SEG == 0 or t == S - 1:
            ends[t] = (ds * states[t + 1]).sum(-1)     # (B, H, N)
        ds = w[:, :, t, :, None] * ds \
            + r[:, :, t, :, None] * do[:, :, t, None, :]
    return ends


def _cumulative_identity(args, grads, ends):
    """dlw_t = rowsum(dS_e ⊙ S_e) + sum_{t<s<=e} r_s ⊙ dr'_s -
    sum_{t<=s<=e} k_s ⊙ dk'_s within the segment ending at e, in fp32
    (dr', dk' the gradients without the bonus)."""
    r, k, v, lw, u, s0, do, dsf = map(_t, args)
    dr, dk = grads[0].float(), grads[1].float()
    dov = (do * v).sum(-1, keepdim=True)
    term_r = r * (dr - u * k * dov)
    term_k = k * (dk - u * r * dov)
    S = r.shape[1]
    out = torch.empty_like(r)
    for j in range(-(-S // SEG)):
        t0, t1 = j * SEG, min((j + 1) * SEG, S)
        acc = ends[t1 - 1].float()
        for t in reversed(range(t0, t1)):
            if t + 1 < t1:
                acc = acc + term_r[:, t + 1]
            acc = acc - term_k[:, t]
            out[:, t] = acc
    return out


def _chip_smoke():
    """``chip_smoke.py`` as a module (its checks are plain functions of
    tensors; importing it touches no card)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_du_allowance_at_s1_covers_fp32_rounding_and_rejects_a_fault():
    """At S 1, du = r k (dO · v): one term whose dot product can cancel.
    Over 300 seeded draws of the smoke's fp32 S 1 case (B 1, H 4, N 64)
    the plain fp32 du stays within the smoke's du allowance
    (``chip_smoke.wkv_bwd_tol``) of an fp64 du, and a backward that
    dropped the step's dO lands at least WKV_BWD_FAULT (10) times over
    it.  The allowance's rounding term is 2·gamma_{N+3} times du's terms'
    summed magnitudes; half of it covers one side's fp32 rounding, the
    other half the kernel's."""
    cs = _chip_smoke()
    rng = np.random.default_rng(26)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    worst, fault = 0.0, float("inf")
    for _ in range(300):
        r, k, v, do = (f32(rng.normal(size=(1, 1, 4, 64))) for _ in range(4))
        lw = -torch.exp(f32(rng.uniform(-6, 2, (1, 1, 4, 64))))
        u = f32(0.5 * rng.normal(size=(4, 64)))
        s0 = f32(0.3 * rng.normal(size=(1, 4, 64, 64)))
        _, _, ck = wkv.wkv6_torch(r, k, v, lw, u, s0, seg=wkv.SEG)
        plain = wkv.wkv6_bwd_torch(r, k, v, lw, u, ck, do)
        atol, _ = cs.wkv_bwd_tol(plain, torch.float32,
                                 cs.wkv_du_terms(r, k, v, do))[4]
        d = lambda t: t.double()  # noqa: E731
        exact = (d(r) * d(k) * (d(do) * d(v)).sum(-1, keepdim=True)).sum(
            (0, 1))
        # one side's rounding against exact: within half the allowance
        worst = max(worst, float(((d(plain[4]) - exact).abs()
                                  / (0.5 * d(atol))).max()))
        dropped = wkv.wkv6_bwd_torch(r, k, v, lw, u, ck,
                                     torch.zeros_like(do))[4]
        fault = min(fault, cs.tol_used(dropped, plain[4], (atol, 0.0)))
    assert worst <= 1.0, worst
    assert fault >= cs.WKV_BWD_FAULT, fault
    assert cs.wkv_du_rounding(64) == pytest.approx(2 * 67 * 2.0 ** -24,
                                                   rel=1e-5)
