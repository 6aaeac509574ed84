"""The port's CUDA kernels and its engine on a card.

Every test here is marked ``cuda`` and skips itself where
``torch.cuda.is_available()`` is false (the CUDA kernels have no CPU mode).
On a machine with a card and ``nvcc``:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no jax, so it runs where only PyTorch is installed.  Each
kernel is held against its plain PyTorch version on the same inputs, made
with numpy from a seed, element by element: fp32 to 1e-4 (flash) and 1e-5
(decode); bf16 to one bf16 ulp of the value (2^-7·|plain|, both kernels
round their fp32 result once) plus 1e-4 (decode) or 4e-3 (flash, which
also rounds P to bf16 for its tensor-core P·V product).  The WKV6 kernel
is held against the step-by-step oracle ``ref.wkv6_ref`` within 1e-5 of
the output's largest magnitude (also at constant lw -3 and -8 and at
decays down to -e^4), and against the chunked plain version
within 3e-5 of it (that version's own fp32 error reaches 1e-5 of the
scale at lw = -e^2, from its log-space cumulative sums); bf16 outputs
also get one bf16 ulp of the value.  The RG-LRU kernel is held against its
plain step loop and the oracle ``ref.rglru_ref`` within 1e-5 of the
carry's largest magnitude plus 1e-5 of the value (the kernel fuses the
multiply-add, the plain loop rounds twice a step), and a padded tail must
leave the carry bit-equal.  The MLA latent decode kernel is held to its
plain version with the decode tolerances (its bf16 route splits P into
bf16 hi + lo for the P·V product, which keeps it within them).

The flash backward is held against its plain version on the same (q, k,
v, O, lse, dO), the forward's outputs taken from the plain fp32 forward:
fp32 within 1e-4 of each gradient's largest magnitude; bf16 within 2^-7
of it plus 2^-7·|plain| (the kernel rounds P and dS to bf16 for its
tensor-core products, 2^-9 relative each with random signs over the sums,
and both sides round the result once).  The largest magnitude is taken
at least 1: the inputs are unit normals, so the products' terms are of
order 1, and a gradient that cancels to rounding (dQ at S 1, where P = 1
and dS = P (dP - D) = 0) is held to that scale.  Two calls are bit-equal (no
atomics).  The forward kernel's log-sum-exp is held to the plain one
within 1e-5 (fp32 statistics in both types).  A reduced train step on the
card in fp32 with TF32 off matches the same step on the CPU.  At hd 256
(recurrentgemma's local layers) the backward is held the same way, and
its tolerance rejects planted faults at least 10 times over.

The RG-LRU backward is held against its plain reverse loop on the same
(log_a, h, dh, h0): within 1e-5 of the largest |plain| of the element's
64-step tile of a batch row (dh0: of the row) plus 1e-6 (the kernel fuses
the carry's multiply-add, the plain loop rounds twice a step); two calls
bit-equal; planted faults (a step's dh dropped, h read one step late) at
least 10 times over.

The WKV6 backward is held against its plain backward on the same inputs
and the forward kernel's state checkpoints: within 1e-5 of the largest
|plain| of the element's tile (64 steps of one batch row and head; du:
its head; ds0: its state) plus 1e-6, du also within both sides' rounding
of its terms (2·gamma_{N+3} times the root-sum-square over steps of
|r k|·sum_j |dO_j v_j|, ``chip_smoke.wkv_bwd_tol``), and bf16 dr, dk, dv
one bf16 ulp of the value more (both sides rebuild the states by the same fp32 step
recurrence and round once; they sum in other orders).  The forward's o
and s_final are bit-equal with and without the checkpoints, which are
held to the plain forward's within 3e-5 of their largest (the chunked
plain version's own error, as for the forward).  Two backward calls are
bit-equal (no atomics).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402
from repro_torch.launch.engine import (  # noqa: E402
    ServingEngine, synthesize_requests)
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Model, compute_params, make_trainable)
from repro_torch.train import steps  # noqa: E402

pytestmark = pytest.mark.cuda

# (atol, rtol): |kernel - plain| <= atol + rtol·|plain| for every element
FLASH_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (4e-3, 2 ** -7)}
DECODE_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-4, 2 ** -7)}
# WKV6: (share of max |plain| as atol, rtol) against the oracle and the
# chunked plain version
WKV_TOL = {"oracle": 1e-5, "chunked": 3e-5}
WKV_RTOL = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}
# the WKV6 backward: (share of its tile's max |plain|, rtol) by dtype
WKV_BWD_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2 ** -7)}
# RG-LRU: (share of max |plain| as atol, rtol)
RGLRU_TOL = (1e-5, 1e-5)
# the flash backward: |kernel - plain| <= share·T + BWD_NOISE + rtol·|plain|,
# T the largest |plain| of the element's tile of 64 rows (dq) or 64 keys
# (dk, dv) of one batch row and head (the reasons are in chip_smoke.py);
# (share, rtol) by dtype
BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2 ** -7, 2 ** -7)}
BWD_NOISE = 1e-5


def _within(out, plain, tol):
    atol, rtol = tol
    d = (out.float() - plain.float()).abs()
    return bool((d <= atol + rtol * plain.float().abs()).all())


def _bwd_tol(plain, dt):
    """(atol per element, rtol) of the flash backward for ``plain``."""
    share, rtol = BWD_TOL[dt]
    B, S, n, hd = plain.shape
    pad = -S % 64
    a = torch.nn.functional.pad(plain.float().abs(), (0, 0, 0, 0, 0, pad))
    a = a.view(B, (S + pad) // 64, 64, n, hd)
    t = a.amax(dim=(2, 4), keepdim=True).expand_as(a)
    return share * t.reshape(B, S + pad, n, hd)[:, :S] + BWD_NOISE, rtol


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dev, dt):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, dt)


# The bf16 kernel's tile edges: 128-row q tiles (64 rows a consumer
# warpgroup) and 128-key kv tiles (64 at hd 256).
FLASH_CASES = [
    # B, S, H, K, hd, causal, window, cap
    (2, 128, 4, 2, 64, True, 0, 0.0),
    (1, 200, 6, 2, 128, True, 0, 0.0),     # ragged S, G 3
    (1, 333, 4, 2, 64, True, 50, 20.0),    # ragged, window, softcap
    (2, 64, 16, 8, 128, True, 0, 0.0),
    *[(1, S, 4, 2, hd, True, 0, 0.0)       # S around the tile edges
      for hd in (64, 128) for S in (1, 63, 65, 127, 129, 257)],
    (1, 300, 4, 2, 128, True, 1, 0.0),     # window 1: the diagonal only
    (1, 300, 4, 2, 64, True, 100, 0.0),    # window shorter than a kv tile
    (1, 400, 4, 2, 128, True, 128, 0.0),   # window edge on a tile boundary
    (1, 400, 4, 2, 64, True, 129, 0.0),
    (2, 200, 4, 2, 128, False, 0, 0.0),    # not causal
    (1, 129, 8, 8, 64, False, 0, 0.0),     # not causal, G 1
    (1, 300, 4, 2, 128, False, 100, 0.0),  # not causal, window
    (1, 260, 4, 4, 128, True, 0, 0.0),     # G 1
    (1, 260, 16, 1, 128, True, 0, 0.0),    # G 16
    (1, 300, 6, 2, 128, True, 64, 30.0),   # softcap with a window
    (1, 300, 10, 2, 128, True, 0, 0.0),    # qwen2.5's G 5
    (1, 257, 24, 2, 128, True, 0, 0.0),    # mistral-large's G 12
    (1, 300, 16, 2, 128, True, 0, 0.0),    # internvl2's G 8
    (2, 1000, 64, 8, 128, True, 0, 0.0),   # internvl2's heads, ragged
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,causal,window,cap", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dt, B, S, H, K, hd, causal, window,
                                    cap):
    rng = np.random.default_rng(S)
    q = _randn(rng, (B, S, H, hd), cuda, dt)
    k = _randn(rng, (B, S, K, hd), cuda, dt)
    v = _randn(rng, (B, S, K, hd), cuda, dt)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)
    before = ops.launches["flash_attention_bshd"]
    out = ops.flash_attention_bshd(q, k, v, **kw)
    plain = fa.flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bshd"] == before + 1
    assert out.dtype == dt and out.shape == q.shape
    assert _within(out, plain, FLASH_TOL[dt])


def _paged(rng, dev, dt, B, K, G, hd, ps, pps, positions):
    P = B * pps
    q = _randn(rng, (B, K, G, hd), dev, dt)
    kp = _randn(rng, (P, K, ps, hd), dev, dt)
    vp = _randn(rng, (P, K, ps, hd), dev, dt)
    perm = rng.permutation(P).astype(np.int32)
    table = np.full((B, pps), -1, np.int32)
    for b, p in enumerate(positions):
        if p >= 0:
            table[b, :p // ps + 1] = perm[b * pps:b * pps + p // ps + 1]
    table[1, 0] = table[0, 0]                         # aliased page
    table[2, 1] = -1                                  # hole mid-prefix
    assert positions[2] >= ps and positions[3] < 0
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(positions, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [2, 3, 4, 5, 8, 12, 16])
def test_paged_decode_kernel_grids_match_plain(cuda, dt, G):
    rng = np.random.default_rng(G)
    B, K, hd, ps, pps = 4, 2, 64, 16, 10
    q, kp, vp, table, pos = _paged(rng, cuda, dt, B, K, G, hd, ps, pps,
                                   [150, 31, 100, -1])
    qm = q.reshape(B, 1, K * G, hd)
    kw = dict(scale=hd ** -0.5, logit_cap=30.0 if G == 3 else 0.0)
    grouped = ops.paged_decode_bhd(qm, kp, vp, table, pos, grouped=True,
                                   **kw).reshape(B, K, G, hd)
    ungrouped = ops.paged_decode_bhd(qm, kp, vp, table, pos, grouped=False,
                                     **kw).reshape(B, K, G, hd)
    plain = pa.paged_decode_torch(q, kp, vp, table, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(grouped, ungrouped)            # same arithmetic
    assert _within(grouped, plain, DECODE_TOL[dt])
    assert bool((grouped[pos < 0] == 0).all())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_at_the_qwen3_serving_shape(cuda, dt):
    """The instantiation serving uses (K 8, G 2, hd 128, page 128),
    ragged rows up to 1,056 keys, both grids."""
    rng = np.random.default_rng(7)
    B, K, G, hd, ps, pps = 8, 8, 2, 128, 128, 9
    q, kp, vp, table, pos = _paged(rng, cuda, dt, B, K, G, hd, ps, pps,
                                   [1055, 700, 1023, -1, 512, 127, 128, 900])
    qm = q.reshape(B, 1, K * G, hd)
    kw = dict(scale=hd ** -0.5, logit_cap=0.0)
    plain = pa.paged_decode_torch(q, kp, vp, table, pos, **kw)
    outs = []
    for grouped in (True, False):
        out = ops.paged_decode_bhd(qm, kp, vp, table, pos, grouped=grouped,
                                   **kw).reshape(B, K, G, hd)
        torch.cuda.synchronize()
        assert _within(out, plain, DECODE_TOL[dt])
        assert bool((out[pos < 0] == 0).all())
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32 q"])
@pytest.mark.parametrize("K,G,hd", [(8, 2, 256), (8, 12, 128), (1, 16, 256),
                                    (2, 5, 256), (4, 1, 256), (8, 8, 128)])
def test_paged_decode_kernel_at_hd256_and_large_groups(cuda, qdt, K, G, hd):
    """gemma2-9b's global layers (K 8, G 2, hd 256), mistral-large's group
    (G 12), MQA at hd 256 (G 16), two odd shapes and internvl2-76b's group
    (K 8, G 8: a kv head a block of the grouped grid), over bf16 pools with
    a bf16 or an fp32 query; pages of 128, rows up to 1,056 keys; both
    grids bit-equal, with and without the softcap."""
    rng = np.random.default_rng(K * 100 + G)
    B, ps, pps = 8, 128, 9
    q, kp, vp, table, pos = _paged(rng, cuda, torch.bfloat16, B, K, G, hd,
                                   ps, pps,
                                   [1055, 700, 1023, -1, 512, 127, 128, 900])
    q = q.to(qdt)
    qm = q.reshape(B, 1, K * G, hd)
    for cap in (0.0, 30.0):
        kw = dict(scale=hd ** -0.5, logit_cap=cap)
        plain = pa.paged_decode_torch(q, kp, vp, table, pos, **kw)
        outs = [ops.paged_decode_bhd(qm, kp, vp, table, pos, grouped=g,
                                     **kw).reshape(B, K, G, hd)
                for g in (True, False)]
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert outs[0].dtype == qdt
        assert _within(outs[0], plain, DECODE_TOL[qdt])
        assert bool((outs[0][pos < 0] == 0).all())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,pps,G", [(8, 64, 2), (1, 160, 2), (8, 64, 8)])
def test_paged_decode_kernel_walks_long_tables(cuda, dt, B, pps, G):
    """Tables long enough that a range holds several tiles (qwen3's heads,
    pages of 128): a warp walks them through its ring, the producer waits
    on the empty barrier and reuses stages, the ring's parity flips, and at
    B 1 the merge takes its 320 ranges in rounds of 32.  Rows up to 8,192
    (B 8) or 20,001 keys (B 1) with a -1 hole; both grids bit-equal (the
    fp32 grouped grid has one stage, the others two or three); also at
    internvl2-76b's group (G 8, a kv head a block)."""
    rng = np.random.default_rng(B * pps)
    K, hd, ps = 8, 128, 128
    if B == 8:
        q, kp, vp, table, pos = _paged(
            rng, cuda, dt, B, K, G, hd, ps, pps,
            [8191, 5000, 8000, -1, 3000, 127, 2048, 6500])
    else:
        q = _randn(rng, (B, K, G, hd), cuda, dt)
        kp = _randn(rng, (pps, K, ps, hd), cuda, dt)
        vp = _randn(rng, (pps, K, ps, hd), cuda, dt)
        table = rng.permutation(pps).astype(np.int32)[None]
        table[0, 3] = -1                              # hole mid-prefix
        table = torch.from_numpy(table).to(cuda)
        pos = torch.tensor([20000], dtype=torch.int32, device=cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans = [pa.decode_plan(B, K, G, hd, ps, pps, kp.element_size(), n_sm,
                            grouped=g) for g in (True, False)]
    assert plans[0]["tps"] > 1 and max(p["stages"] for p in plans) >= 2
    qm = q.reshape(B, 1, K * G, hd)
    kw = dict(scale=hd ** -0.5, logit_cap=0.0)
    plain = pa.paged_decode_torch(q, kp, vp, table, pos, **kw)
    outs = [ops.paged_decode_bhd(qm, kp, vp, table, pos, grouped=g,
                                 **kw).reshape(B, K, G, hd)
            for g in (True, False)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert _within(outs[0], plain, DECODE_TOL[dt])
    assert bool((outs[0][pos < 0] == 0).all())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 64, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_bshd(x, x[:, :, :2], x[:, :, :2], scale=0.25)
    y = torch.zeros(1, 64, 8, 64, device=cuda)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_bshd(y, y, y, scale=0.125)
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention_bshd(y.contiguous(), y.cpu().contiguous(),
                                 y.cpu().contiguous(), scale=0.125)


def test_engine_serves_on_the_card(cuda):
    """A narrow qwen3 (hd 64, the kernels' smallest head dim) through the
    engine on the card: every request completes and both kernels ran."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              head_dim=64, page_size=16,
                              cache_layout="paged")
    model = build_model(cfg, device=cuda, seed=0)
    sv = ServeSpec(batch=3, prompt_len=40, gen=6, requests=5,
                   prefix_cache=False)
    eng = ServingEngine(cfg, model, sv, dtype=torch.bfloat16)
    requests = synthesize_requests(cfg, sv, seed=0)
    for r in requests:
        eng.submit(r)
    ops.reset_launches()
    eng.run()
    assert sorted(eng.responses) == [r.req for r in requests]
    assert ops.launches["flash_attention_bshd"] > 0
    assert ops.launches["paged_decode_bhd"] > 0


def _wkv_within(out, plain, scale, dt):
    return _within(out, plain, (scale * plain.float().abs().max().item(),
                                WKV_RTOL[dt]))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N", [
    (2, 64, 3, 64),
    (1, 77, 4, 64),        # ragged tail
    (2, 40, 2, 16),
    (1, 100, 2, 32),
    (2, 1, 3, 64),         # S shorter than one chunk of 8 (the TMA box)
    (1, 5, 4, 64),
    (2, 8, 2, 32),         # one whole chunk
    (1, 9, 2, 16),         # a chunk and one step
])
def test_wkv6_kernel_matches_plain_and_oracle(cuda, dt, B, S, H, N):
    """Decays from -e^-6 to -e^2, a nonzero s0, and row 0 padded past
    step min(25, S - 1) (k = 0, lw = 0): its final state is bit-equal to
    the kernel's state at that step."""
    rng = np.random.default_rng(S * N)
    r, k, v = (_randn(rng, (B, S, H, N), cuda, dt) for _ in range(3))
    lw = -torch.from_numpy(np.exp(rng.uniform(-6, 2, (B, S, H, N))).astype(
        np.float32)).to(cuda)
    u = 0.5 * _randn(rng, (H, N), cuda, torch.float32)
    s0 = 0.3 * _randn(rng, (B, H, N, N), cuda, torch.float32)
    pad = min(25, S - 1)
    if pad:
        k[0, pad:] = 0
        lw[0, pad:] = 0
    before = ops.launches["wkv6_bshn"]
    o, s_fin = ops.wkv6_bshn(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert ops.launches["wkv6_bshn"] == before + 1
    assert o.dtype == dt and o.shape == r.shape
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s_fin).all())
    po, ps = wkv.wkv6_torch(r, k, v, lw, u, s0)
    assert _wkv_within(o, po, WKV_TOL["chunked"], dt)
    assert _wkv_within(s_fin, ps, WKV_TOL["chunked"], torch.float32)
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, N)  # noqa: E731
    ro, rs = ref.wkv6_ref(fold(r), fold(k), fold(v), fold(lw),
                          u[None].expand(B, H, N).reshape(B * H, 1, N),
                          s0.reshape(B * H, N, N))
    ro = ro.reshape(B, H, S, N).transpose(1, 2)
    assert _wkv_within(o, ro, WKV_TOL["oracle"], dt)
    assert _wkv_within(s_fin, rs.reshape(B, H, N, N), WKV_TOL["oracle"],
                       torch.float32)
    if pad:
        cut = [t[:1, :pad].contiguous() for t in (r, k, v, lw)]
        _, s_cut = ops.wkv6_bshn(*cut, u, s0[:1].contiguous())
        assert torch.equal(s_fin[0], s_cut[0])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", [-3.0, -8.0, "strong"])
@pytest.mark.parametrize("S", [64, 203])
def test_wkv6_kernel_at_strong_decays(cuda, dt, decay, S):
    """Constant lw -3 and -8, and lw = -exp(U(-6, 4)) (down to -e^4 a
    step): finite, within the tolerances of the chunked plain version and
    the step oracle; row 0 padded from step 100 (a ragged S with a padded
    tail) leaves its state bit-equal to the run cut there."""
    B, H, N = 2, 4, 64
    rng = np.random.default_rng(S + N)
    r, k, v = (_randn(rng, (B, S, H, N), cuda, dt) for _ in range(3))
    if decay == "strong":
        lw = -np.exp(rng.uniform(-6, 4, (B, S, H, N)))
    else:
        lw = np.full((B, S, H, N), decay)
    lw = torch.from_numpy(lw.astype(np.float32)).to(cuda)
    u = 0.5 * _randn(rng, (H, N), cuda, torch.float32)
    s0 = 0.3 * _randn(rng, (B, H, N, N), cuda, torch.float32)
    pad = min(100, S - 1)
    k[0, pad:] = 0
    lw[0, pad:] = 0
    o, s_fin = ops.wkv6_bshn(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s_fin).all())
    po, ps = wkv.wkv6_torch(r, k, v, lw, u, s0)
    assert _wkv_within(o, po, WKV_TOL["chunked"], dt)
    assert _wkv_within(s_fin, ps, WKV_TOL["chunked"], torch.float32)
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, N)  # noqa: E731
    ro, rs = ref.wkv6_ref(fold(r), fold(k), fold(v), fold(lw),
                          u[None].expand(B, H, N).reshape(B * H, 1, N),
                          s0.reshape(B * H, N, N))
    assert _wkv_within(o, ro.reshape(B, H, S, N).transpose(1, 2),
                       WKV_TOL["oracle"], dt)
    assert _wkv_within(s_fin, rs.reshape(B, H, N, N), WKV_TOL["oracle"],
                       torch.float32)
    cut = [t[:1, :pad].contiguous() for t in (r, k, v, lw)]
    _, s_cut = ops.wkv6_bshn(*cut, u, s0[:1].contiguous())
    assert torch.equal(s_fin[0], s_cut[0])


def test_wkv6_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 48, device=cuda)
    u, s0 = torch.zeros(2, 48, device=cuda), torch.zeros(1, 2, 48, 48,
                                                         device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.wkv6_bshn(x, x, x, x, u, s0)
    y = torch.zeros(1, 8, 4, 64, device=cuda)[:, :, ::2]
    u, s0 = torch.zeros(2, 64, device=cuda), torch.zeros(1, 2, 64, 64,
                                                         device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6_bshn(y, y, y, y, u, s0)
    with pytest.raises(ValueError, match="different devices"):
        ops.wkv6_bshn(y.contiguous(), y.contiguous(), y.contiguous(),
                      y.contiguous(), u.cpu(), s0)
    # a contiguous view 4 bytes into its storage: refused before any TMA
    # map is made, and the card works on after it
    z = torch.zeros(1 * 8 * 2 * 64 + 1, device=cuda)[1:].view(1, 8, 2, 64)
    assert z.is_contiguous() and z.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.wkv6_bshn(z, z, z, z, u, s0)
    o, s_fin = ops.wkv6_bshn(*(z.clone() for _ in range(4)), u, s0)
    torch.cuda.synchronize()
    assert bool((o == 0).all()) and bool((s_fin == 0).all())


def _wkv_du_terms(r, k, v, do):
    """sqrt(sum over (b, t) of tau_t²) per (head, channel), tau_t = |r_t
    k_t| · sum_j |dO_tj v_tj|: du's terms' summed magnitudes
    (``chip_smoke.wkv_du_terms``)."""
    f = lambda x: x.float()  # noqa: E731
    tau = (f(r) * f(k)).abs() * (f(do) * f(v)).abs().sum(-1, keepdim=True)
    return tau.square().sum((0, 1)).sqrt()


def _wkv_bwd_tol(plain, dt, du_terms):
    """(atol per element, rtol) of the WKV6 backward for each of (dr, dk,
    dv, dlw, du, ds0), as ``chip_smoke.wkv_bwd_tol``: du also gets both
    sides' rounding of its terms, 2·gamma_{N+3} times ``du_terms``."""
    share, rtol = WKV_BWD_TOL[dt]
    out = []
    for i, p in enumerate(plain):
        a = p.float().abs()
        if i < 4:
            B, S, H, N = a.shape
            pad = -S % 64
            t = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)).view(
                B, (S + pad) // 64, 64, H, N)
            t = t.amax(dim=(2, 4), keepdim=True).expand_as(t)
            t = t.reshape(B, S + pad, H, N)[:, :S]
        else:
            t = a.amax(dim=(-2, -1) if i == 5 else -1,
                       keepdim=True).expand_as(a)
        atol = share * t + 1e-6
        if i == 4:
            g = (a.shape[-1] + 3) * 2.0 ** -24
            atol = atol + 2 * g / (1 - g) * du_terms
        out.append((atol, rtol if i < 3 else 0.0))
    return out


def _wkv_bwd_inputs(rng, B, S, H, N, dev, dt, decay="mixed"):
    r, k, v, do = (_randn(rng, (B, S, H, N), dev, dt) for _ in range(4))
    if decay == "mixed":
        lw = -np.exp(rng.uniform(-6, 2, (B, S, H, N)))
    elif decay == "strong":
        lw = -np.exp(rng.uniform(-6, 4, (B, S, H, N)))
    else:
        lw = np.full((B, S, H, N), decay)
    lw = torch.from_numpy(lw.astype(np.float32)).to(dev)
    u = 0.5 * _randn(rng, (H, N), dev, torch.float32)
    s0, dsf = (0.3 * _randn(rng, (B, H, N, N), dev, torch.float32)
               for _ in range(2))
    return r, k, v, lw, u, s0, do, dsf


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N,decay", [
    (2, 300, 4, 64, "mixed"),         # four segments of 64 and a tail
    (1, 77, 4, 64, "mixed"),          # a segment and a ragged chunk
    (2, 1, 3, 64, "mixed"),
    (2, 65, 2, 64, "mixed"),          # a segment and one step
    (2, 63, 2, 64, "mixed"),          # one step short of a segment
    (1, 9, 2, 16, "mixed"),
    (2, 100, 2, 32, "mixed"),
    (2, 130, 4, 64, "strong"),        # down to -e^4
    (1, 64, 2, 64, -8.0),
])
def test_wkv6_bwd_kernel_matches_plain(cuda, dt, B, S, H, N, decay):
    rng = np.random.default_rng(S * N + 1)
    r, k, v, lw, u, s0, do, dsf = _wkv_bwd_inputs(rng, B, S, H, N, cuda, dt,
                                                  decay)
    o, s_fin = wkv.wkv6_cuda(r, k, v, lw, u, s0)
    o_c, s_fin_c, ck = wkv.wkv6_cuda(r, k, v, lw, u, s0, seg=wkv.SEG)
    torch.cuda.synchronize()
    assert torch.equal(o, o_c) and torch.equal(s_fin, s_fin_c)
    _, _, pck = wkv.wkv6_torch(r, k, v, lw, u, s0, seg=wkv.SEG)
    assert _wkv_within(ck, pck, WKV_TOL["chunked"], torch.float32)
    before = ops.launches["wkv6_bwd"]
    got = ops.wkv6_bwd(r, k, v, lw, u, ck, do, dsf)
    again = ops.wkv6_bwd(r, k, v, lw, u, ck, do, dsf)
    torch.cuda.synchronize()
    assert ops.launches["wkv6_bwd"] == before + 2
    plain = wkv.wkv6_bwd_torch(r, k, v, lw, u, ck, do, dsf)
    for name, g, g2, p, tol in zip(("dr", "dk", "dv", "dlw", "du", "ds0"),
                                   got, again, plain,
                                   _wkv_bwd_tol(plain, dt, _wkv_du_terms(
                                       r, k, v, do))):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert torch.equal(g, g2), name
        assert _within(g, p, tol), name


def test_wkv6_autograd_launches_both_kernels_and_no_plain_version(
        cuda, monkeypatch):
    """With grad on, a CUDA tensor goes through ops.WKV6: the forward
    kernel with checkpoints, then the backward kernel; the plain versions
    are never called."""
    rng = np.random.default_rng(3)
    r, k, v, lw, u, s0, do, _ = _wkv_bwd_inputs(rng, 2, 50, 2, 64, cuda,
                                                torch.bfloat16)
    _, _, ck = wkv.wkv6_cuda(r, k, v, lw, u, s0, seg=wkv.SEG)
    want = ops.wkv6_bwd(r, k, v, lw, u, ck, do)

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(wkv, "wkv6_torch", plain)
    monkeypatch.setattr(wkv, "wkv6_bwd_torch", plain)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, lw, u)]
    before = dict(ops.launches)
    o, _ = ops.wkv6_bshn(*leaves, s0)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert ops.launches["wkv6_bshn"] == before["wkv6_bshn"] + 1
    assert ops.launches["wkv6_bwd"] == before["wkv6_bwd"] + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wkv6_backward_du_at_s1_is_as_accurate_as_fp32(cuda):
    """At S 1, du = r k (dO · v): a dot product over the value channels
    that can cancel, so the kernel computes Bm's diagonal dO_t · v_t as an
    fp32 dot product.  Over 100 draws (B 1, H 4, N 64, fp32) du is held to
    an fp64 du within 2.5e-7 of the sum of its terms' magnitudes: the
    plain backward's fp32 reaches 1.1e-7 of it, the split-TF32 diagonal
    (truncated operands, 2^-20 of each term) 6.3e-7, which put du of a
    head whose dO · v cancelled past the smoke's tolerance in 22 of 300
    draws."""
    rng = np.random.default_rng(25)
    worst = 0.0
    for _ in range(100):
        r, k, v, do = (torch.from_numpy(rng.normal(size=(1, 1, 4, 64)).astype(
            np.float32)).to(cuda) for _ in range(4))
        lw = -torch.exp(torch.from_numpy(rng.uniform(-6, 2, (1, 1, 4, 64))
                                         .astype(np.float32))).to(cuda)
        u = torch.from_numpy(0.5 * rng.normal(size=(4, 64)).astype(
            np.float32)).to(cuda)
        s0 = torch.from_numpy(0.3 * rng.normal(size=(1, 4, 64, 64)).astype(
            np.float32)).to(cuda)
        _, _, ck = wkv.wkv6_cuda(r, k, v, lw, u, s0, seg=wkv.SEG)
        du = ops.wkv6_bwd(r, k, v, lw, u, ck, do)[4].double()
        d = lambda t: t.double()  # noqa: E731
        exact = (d(r) * d(k) * (d(do) * d(v)).sum(-1, keepdim=True)).sum(
            (0, 1))
        terms = (d(r).abs() * d(k).abs()
                 * (d(do) * d(v)).abs().sum(-1, keepdim=True)).sum((0, 1))
        worst = max(worst, float(((du - exact).abs() / terms).max()))
    assert worst <= 2.5e-7, worst


def test_wkv6_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 48, device=cuda)
    u = torch.zeros(2, 48, device=cuda)
    ck = torch.zeros(1, 2, 1, 48, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.wkv6_bwd(x, x, x, x, u, ck, x)
    x = torch.zeros(1, 8, 2, 64, device=cuda)
    u = torch.zeros(2, 64, device=cuda)
    ck = torch.zeros(1, 2, 1, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="on the card"):
        ops.wkv6_bwd(x, x, x, x, u.cpu(), ck, x)
    with pytest.raises(ValueError, match="fp32"):
        ops.wkv6_bwd(x, x, x, x, u, ck.bfloat16(), x)


def test_rwkv_engine_serves_on_the_card(cuda):
    """rwkv6-7b .reduced() with four heads of 16 through the engine on the
    card, in bf16: every request completes and each prefill round launched
    the WKV6 kernel once a layer."""
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              rwkv_head_dim=16, cache_layout="paged")
    model = build_model(cfg, device=cuda, seed=0)
    sv = ServeSpec(batch=3, prompt_len=40, gen=6, requests=5)
    eng = ServingEngine(cfg, model, sv, dtype=torch.bfloat16)
    requests = synthesize_requests(cfg, sv, seed=0)
    for r in requests:
        eng.submit(r)
    rounds = []
    prefill = eng.prefill

    def counted(*args):
        rounds.append(1)
        return prefill(*args)

    eng.prefill = counted
    ops.reset_launches()
    eng.run()
    assert sorted(eng.responses) == [r.req for r in requests]
    assert ops.launches["wkv6_bshn"] == cfg.num_layers * len(rounds) > 0


FLASH_HD256_CASES = [
    # B, S, H, K, causal, window, cap
    (2, 200, 16, 1, True, 64, 0.0),        # recurrentgemma's MQA: G 16
    (1, 333, 16, 1, True, 2048, 0.0),      # ragged S, window longer than S
    (1, 130, 4, 2, True, 50, 0.0),         # G 2
    *[(1, S, 16, 1, True, 2048, 0.0)       # S around the tile edges
      for S in (1, 63, 65, 127, 129, 257)],
    (1, 300, 16, 1, True, 1, 0.0),         # window 1: the diagonal only
    (1, 300, 16, 1, True, 40, 0.0),        # window shorter than a kv tile
    (1, 300, 16, 1, True, 128, 0.0),       # window edge on a tile boundary
    (1, 200, 4, 2, False, 0, 0.0),         # not causal
    (1, 200, 4, 4, True, 0, 0.0),          # G 1
    (1, 200, 6, 2, True, 0, 0.0),          # G 3
    (1, 300, 16, 1, True, 100, 30.0),      # softcap with a window
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,causal,window,cap", FLASH_HD256_CASES)
def test_flash_kernel_at_hd256_matches_plain(cuda, dt, B, S, H, K, causal,
                                             window, cap):
    rng = np.random.default_rng(S + window)
    hd = 256
    q = _randn(rng, (B, S, H, hd), cuda, dt)
    k = _randn(rng, (B, S, K, hd), cuda, dt)
    v = _randn(rng, (B, S, K, hd), cuda, dt)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)
    before = ops.launches["flash_attention_bshd"]
    out = ops.flash_attention_bshd(q, k, v, **kw)
    plain = fa.flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bshd"] == before + 1
    assert out.dtype == dt and out.shape == q.shape
    assert _within(out, plain, FLASH_TOL[dt])


def _rglru_inputs(rng, dev, B, S, R):
    """log_a at the model's initial decays (8·r·log σ(Λ), σ(Λ) in
    [0.9, 0.999]) on half the channels and strong ones (-U(1, 20)) on the
    rest; b ~ N(0, 1); h0 ~ 3·N(0, 1)."""
    lam = rng.uniform(0.9, 0.999, size=(R,))
    log_a = 8.0 * rng.uniform(0, 1, size=(B, S, R)) * np.log(lam)
    log_a[..., R // 2:] = -rng.uniform(1, 20, size=(B, S, R - R // 2))
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return (to(log_a), to(rng.normal(size=(B, S, R))),
            to(3.0 * rng.normal(size=(B, R))))


def _rglru_within(out, plain):
    scale, rtol = RGLRU_TOL
    return _within(out, plain, (scale * plain.abs().max().item(), rtol))


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("B,S,R", [
    (2, 64, 256),
    (1, 77, 100),          # ragged S and R
    (3, 5, 4096),          # shorter than one pass
    (2, 1, 33),
    (8, 300, 4096),        # the serving width
    (1, 4095, 4096),       # (t6)'s microbatch, a ragged last tile
    (2, 300, 4094),        # rows not 16-byte multiples: the cp.async path
])
def test_rglru_kernel_matches_plain_and_oracle(cuda, with_h0, B, S, R):
    """Row 0 is padded past step n (log_a = 0, b = 0): its carry stays
    bit-equal to the kernel's carry at step n - 1."""
    rng = np.random.default_rng(S * R + with_h0)
    log_a, b, h0 = _rglru_inputs(rng, cuda, B, S, R)
    n = max(S - 20, 1)
    log_a[0, n:] = 0
    b[0, n:] = 0
    h0 = h0 if with_h0 else None
    before = ops.launches["rglru_scan_bsr"]
    h = ops.rglru_scan_bsr(log_a, b, h0)
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan_bsr"] == before + 1
    assert h.dtype == torch.float32 and h.shape == log_a.shape
    assert bool(torch.isfinite(h).all())
    zero = torch.zeros(B, R, device=cuda)
    assert _rglru_within(h, rg.rglru_scan_torch(log_a, b, h0))
    assert _rglru_within(h, ref.rglru_ref(log_a, b,
                                          zero if h0 is None else h0))
    assert bool((h[0, n:] == h[0, n - 1]).all())
    cut = ops.rglru_scan_bsr(log_a[:1, :n].contiguous(),
                             b[:1, :n].contiguous(),
                             None if h0 is None else h0[:1].contiguous())
    assert torch.equal(h[0, -1], cut[0, -1])


def test_rglru_kernels_take_operands_off_a_16_byte_boundary(cuda):
    """log_a 4 bytes past a 16-byte boundary (a view into a larger
    buffer) cannot go through a TMA map: the plan takes the cp.async path,
    whose outputs equal the TMA path's bit for bit, forward and
    backward."""
    rng = np.random.default_rng(17)
    log_a, b, h0 = _rglru_inputs(rng, cuda, 2, 300, 4096)
    buf = torch.empty(log_a.numel() + 1, device=cuda)
    buf[1:] = log_a.flatten()
    off = buf[1:].view_as(log_a)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    assert rg._card_plan(log_a, (log_a, b), False)["tma"]
    assert not rg._card_plan(off, (off, b), False)["tma"]
    h = ops.rglru_scan_bsr(log_a, b, h0)
    assert torch.equal(ops.rglru_scan_bsr(off, b, h0), h)
    dh = torch.from_numpy(rng.normal(size=tuple(h.shape)).astype(
        np.float32)).to(cuda)
    want = ops.rglru_scan_bwd(log_a, h, dh, h0)
    got = ops.rglru_scan_bwd(off, h, dh, h0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rglru_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan_bsr(x[:, :, ::2], x[:, :, ::2])
    with pytest.raises(ValueError, match="different devices"):
        ops.rglru_scan_bsr(x, x, torch.zeros(2, 64))
    with pytest.raises(ValueError, match="fp32"):
        ops.rglru_scan_bsr(x.bfloat16(), x.bfloat16())


def test_recurrentgemma_engine_serves_on_the_card(cuda):
    """recurrentgemma-9b .reduced() with hd 256 (the flash kernel's new
    head dim) through the engine on the card in bf16, prompts longer than
    the 16-token window: every request completes, each prefill round
    launched the RG-LRU kernel once a recurrent layer and the flash kernel
    once a local layer, and decode launched no kernel of its own."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              head_dim=256, cache_layout="paged")
    model = build_model(cfg, device=cuda, seed=0)
    sv = ServeSpec(batch=3, prompt_len=40, gen=6, requests=5)
    eng = ServingEngine(cfg, model, sv, dtype=torch.bfloat16)
    requests = synthesize_requests(cfg, sv, seed=0)
    for r in requests:
        eng.submit(r)
    rounds = []
    prefill = eng.prefill

    def counted(*args):
        rounds.append(1)
        return prefill(*args)

    eng.prefill = counted
    ops.reset_launches()
    eng.run()
    kinds = cfg.layer_kinds()
    assert sorted(eng.responses) == [r.req for r in requests]
    assert ops.launches["rglru_scan_bsr"] == \
        kinds.count("recurrent") * len(rounds) > 0
    assert ops.launches["flash_attention_bshd"] == \
        kinds.count("local") * len(rounds)
    assert ops.launches["paged_decode_bhd"] == ops.launches["wkv6_bshn"] == 0


def _latent(rng, dev, dt, B, H, ps, pps, positions, lora=512, rd=64,
            qdt=None):
    """A ragged latent batch as the smoke builds it: shuffled pages, rows 0
    and 1 share their first page, row 2 has a -1 hole in its live range,
    row 3 is inactive; a single row maps its first page again at slot 2
    and has the hole at slot 1."""
    P = B * pps
    q = _randn(rng, (B, H, lora + rd), dev, qdt or dt)
    ckv = _randn(rng, (P, ps, lora), dev, dt)
    krope = _randn(rng, (P, ps, rd), dev, dt)
    perm = rng.permutation(P).astype(np.int32)
    table = np.full((B, pps), -1, np.int32)
    for b, p in enumerate(positions):
        if p >= 0:
            table[b, :p // ps + 1] = perm[b * pps:b * pps + p // ps + 1]
    if B == 1:
        assert positions[0] >= 3 * ps
        table[0, 2] = table[0, 0]
        table[0, 1] = -1
    else:
        assert positions[2] >= ps and positions[3] < 0
        table[1, 0] = table[0, 0]
        table[2, 1] = -1
    return (q, ckv, krope, torch.from_numpy(table).to(dev),
            torch.tensor(positions, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dt,qdt", [(torch.float32, None),
                                    (torch.bfloat16, None),
                                    (torch.bfloat16, torch.float32)],
                         ids=["fp32", "bf16", "fp32-q-bf16-pools"])
@pytest.mark.parametrize("H,ps,pps,positions", [
    (128, 128, 9, [1055, 700, 1023, -1, 512, 127, 128, 900]),
    (16, 16, 12, [150, 31, 100, -1, 0]),
    (20, 128, 3, [300, 5, 200, -1]),          # a partial head tile
    # long tables: several tiles a range, the ring's stages reused
    (128, 128, 64, [8191, 5000, 8000, -1, 3000, 127, 2048, 6500]),
    (128, 128, 160, [20000]),
], ids=["H128-ps128", "H16-ps16", "H20-ps128", "long-B8-pps64",
        "long-B1-pps160"])
def test_mla_decode_kernel_matches_plain(cuda, dt, qdt, H, ps, pps,
                                         positions):
    rng = np.random.default_rng(H + ps)
    B = len(positions)
    q, ckv, krope, table, pos = _latent(rng, cuda, dt, B, H, ps, pps,
                                        positions, qdt=qdt)
    if pps >= 64:
        plan = pa.mla_card_plan(q, ckv, krope, table)
        assert plan["tpr"] > max(1, plan["stages"])
    scale = (128 + 64) ** -0.5
    before = ops.launches["mla_paged_decode_bhd"]
    out = ops.mla_paged_decode_bhd(q, ckv, krope, table, pos, scale=scale)
    plain = pa.mla_paged_decode_torch(q, ckv, krope, table, pos,
                                      scale=scale)
    torch.cuda.synchronize()
    assert ops.launches["mla_paged_decode_bhd"] == before + 1
    assert out.dtype == q.dtype and tuple(out.shape) == (B, H, 512)
    assert bool(torch.isfinite(out).all())
    assert _within(out, plain, DECODE_TOL[q.dtype])
    assert bool((out[pos < 0] == 0).all())


def test_mla_decode_calls_leave_no_state_behind(cuda):
    """The ranges merge through each cluster's shared memory and nothing
    else: calls at different shapes back to back (the serving shape, pages
    of 16 with a partial head tile, the serving shape again) each match
    the plain version, and the repeated call is bit-equal to the first."""
    rng = np.random.default_rng(7)
    scale = (128 + 64) ** -0.5
    shapes = [(128, 128, 9, [1055, 700, 1023, -1, 512, 127, 128, 900]),
              (20, 16, 12, [150, 31, 100, -1, 0])]
    batches = [_latent(rng, cuda, torch.bfloat16, len(p), H, ps, pps, p)
               for H, ps, pps, p in shapes]
    outs = []
    for args in batches + batches[:1]:
        out = ops.mla_paged_decode_bhd(*args, scale=scale)
        plain = pa.mla_paged_decode_torch(*args, scale=scale)
        torch.cuda.synchronize()
        assert _within(out, plain, DECODE_TOL[torch.bfloat16])
        assert bool((out[args[-1] < 0] == 0).all())
        outs.append(out)
    assert torch.equal(outs[0], outs[2])


def test_mla_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(0)
    q, ckv, krope, table, pos = _latent(rng, cuda, torch.bfloat16, 4, 16,
                                        16, 4, [40, 10, 30, -1])
    with pytest.raises(ValueError, match="lora"):
        ops.mla_paged_decode_bhd(q[..., 64:].contiguous(),
                                 ckv[..., 64:].contiguous(), krope, table,
                                 pos, scale=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mla_paged_decode_bhd(q, ckv, krope, table.long().int().t()
                                 .contiguous().t(), pos, scale=0.1)
    with pytest.raises(ValueError, match="different devices"):
        ops.mla_paged_decode_bhd(q, ckv.cpu(), krope, table, pos, scale=0.1)
    with pytest.raises(ValueError, match="bf16 query over fp32"):
        ops.mla_paged_decode_bhd(q, ckv.float(), krope.float(), table, pos,
                                 scale=0.1)


def test_deepseek_engine_serves_on_the_card(cuda):
    """deepseek-v2 .reduced() with the kernel's latent widths (lora 512, rd
    64) through the engine on the card in bf16: every request completes,
    every decode step launched the MLA kernel once a layer, and no other
    attention kernel ran."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              kv_lora_rank=512, qk_rope_head_dim=64,
                              cache_layout="paged")
    model = build_model(cfg, device=cuda, seed=0)
    sv = ServeSpec(batch=3, prompt_len=40, gen=6, requests=5,
                   prefix_cache=False)
    eng = ServingEngine(cfg, model, sv, dtype=torch.bfloat16)
    requests = synthesize_requests(cfg, sv, seed=0)
    for r in requests:
        eng.submit(r)
    ops.reset_launches()
    eng.run()
    assert sorted(eng.responses) == [r.req for r in requests]
    assert ops.launches["mla_paged_decode_bhd"] == \
        cfg.num_layers * eng.decode_steps > 0
    assert ops.launches["flash_attention_bshd"] == \
        ops.launches["paged_decode_bhd"] == 0


# B, S, H, K, hd, causal, window, cap: G 2 and 3, hd 64 and 128, the
# 64-row tiles' edges, ragged S, not causal, a window with a softcap
BWD_CASES = [
    (2, 128, 4, 2, 64, True, 0, 0.0),
    (1, 77, 6, 2, 64, True, 0, 0.0),
    (1, 128, 6, 2, 128, True, 0, 0.0),
    (2, 77, 4, 2, 128, False, 0, 0.0),
    (1, 200, 6, 2, 64, False, 0, 0.0),
    (1, 128, 4, 2, 64, True, 32, 30.0),
    (1, 77, 3, 1, 128, True, 32, 30.0),
    *[(1, S, 6, 2, hd, True, 0, 0.0) for hd in (64, 128)
      for S in (1, 63, 65, 129)],
    (1, 300, 16, 1, 128, True, 0, 0.0),    # G 16
    (1, 300, 4, 2, 64, False, 100, 0.0),   # not causal, window
    # the bf16 kernels' tile edges: 128-key dK/dV items with 64-row (hd
    # 128) or 128-row (hd 64) q stages, 128-row dQ items with 128-key K/V
    # stages
    (1, 127, 4, 2, 64, True, 0, 0.0),
    (1, 255, 6, 2, 128, True, 0, 0.0),
    (2, 257, 6, 2, 64, True, 0, 0.0),
    (1, 257, 4, 2, 128, True, 0, 0.0),
    # more work items than an H100 runs at once (256 dK/dV, 512 dQ on 132
    # SMs): the persistent loops and the rings' phases wrap
    (2, 2048, 16, 8, 128, True, 0, 0.0),
    # qwen2.5's G 5 and mistral-large's G 12, ragged
    (1, 300, 10, 2, 128, True, 0, 0.0),
    (1, 257, 24, 2, 128, True, 0, 0.0),
    (1, 1000, 40, 8, 128, True, 0, 0.0),
    # internvl2-76b's G 8, ragged
    (1, 300, 16, 2, 128, True, 0, 0.0),
    (1, 1000, 64, 8, 128, True, 0, 0.0),
]


def _bwd_inputs(rng, dev, dt, B, S, H, K, hd, kw):
    q = _randn(rng, (B, S, H, hd), dev, dt)
    k = _randn(rng, (B, S, K, hd), dev, dt)
    v = _randn(rng, (B, S, K, hd), dev, dt)
    do = _randn(rng, (B, S, H, hd), dev, dt)
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,causal,window,cap", BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda, dt, B, S, H, K, hd,
                                             causal, window, cap):
    rng = np.random.default_rng(S + hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)
    q, k, v, o, lse, do = _bwd_inputs(rng, cuda, dt, B, S, H, K, hd, kw)
    before = ops.launches["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == before + 2
    for name, g, g2, p in zip("qkv", got, again, plain):
        assert g.dtype == dt and g.shape == p.shape, name
        assert torch.equal(g, g2), f"d{name}: two calls differ"
        assert _within(g, p, _bwd_tol(p, dt)), name


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,causal,window,cap", [
    (1, 200, 6, 2, 64, True, 0, 0.0),       # G 3, a partial last tile
    (1, 300, 4, 2, 128, False, 0, 0.0),
    (1, 128, 4, 2, 64, True, 32, 30.0),
])
def test_flash_backward_tolerance_rejects_planted_faults(
        cuda, dt, B, S, H, K, hd, causal, window, cap):
    """The tolerance the kernel meets rejects a kernel that dropped one q
    head of each group or the last q tile from dK and dV (planted by
    setting those rows of dO to 0: dQ of those rows then goes to 0 too,
    which such a kernel would not give, so only dK and dV are held), or
    moved the window's frontier by one key (the window one key off over
    the same lse)."""
    rng = np.random.default_rng(S + hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)
    q, k, v, o, lse, do = _bwd_inputs(rng, cuda, dt, B, S, H, K, hd, kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    tols = [_bwd_tol(p, dt) for p in plain]
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(_within(g, p, t) for g, p, t in zip(got, plain, tols))
    G, last = H // K, (S - 1) // 64 * 64
    faults = []
    for rows in ((slice(None), slice(None), slice(G - 1, None, G)),
                 (slice(None), slice(last, None))):
        d = do.clone()
        d[rows] = 0
        faults.append((ops.flash_attention_bwd(q, k, v, o, lse, d, **kw),
                       (1, 2)))
    for w in ((window - 1, window + 1) if window else ()):
        faults.append((ops.flash_attention_bwd(
            q, k, v, o, lse, do, **dict(kw, window=w)), (0, 1, 2)))
    for i, (wrong, held) in enumerate(faults):
        assert not all(_within(wrong[j], plain[j], tols[j]) for j in held), i


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,causal,window,cap",
                         [c for c in FLASH_CASES if c[4] in (64, 128)]
                         + [(1, 300, 16, 1, 256, True, 64, 0.0)])
def test_flash_forward_kernel_writes_the_log_sum_exp(cuda, dt, B, S, H, K,
                                                     hd, causal, window, cap):
    """The bf16 kernel keeps its running max in log2 units: a units slip
    in its lse (a factor ln 2 or scale·log2 e) fails here."""
    rng = np.random.default_rng(S)
    q = _randn(rng, (B, S, H, hd), cuda, dt)
    k = _randn(rng, (B, S, K, hd), cuda, dt)
    v = _randn(rng, (B, S, K, hd), cuda, dt)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    alone = fa.flash_attention_cuda(q, k, v, **kw)
    _, plain = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert torch.equal(out, alone)       # the lse store changes nothing
    assert float((lse - plain).abs().max()) <= 1e-5 * max(
        1.0, float(plain.abs().max()))


# MLA's pair: q and k 192 wide (128 nope + 64 rope) over v 128, the
# expanded heads deepseek-v2 trains at (K = H); the bf16 backward streams
# 32-row q tiles (dK/dV) and 64-key tiles (dQ)
MLA_CASES = [(1, S, 4, 4, True) for S in (1, 31, 77, 129, 257)] \
    + [(2, 1000, 8, 8, True), (1, 300, 4, 2, True), (1, 200, 4, 4, False)]


def _mla_inputs(rng, dev, dt, B, S, H, K):
    q = _randn(rng, (B, S, H, 192), dev, dt)
    k = _randn(rng, (B, S, K, 192), dev, dt)
    v = _randn(rng, (B, S, K, 128), dev, dt)
    do = _randn(rng, (B, S, H, 128), dev, dt)
    return q, k, v, do


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,causal", MLA_CASES)
def test_flash_kernels_at_mla_s_pair_match_plain(cuda, dt, B, S, H, K,
                                                 causal):
    """The forward (output within FLASH_TOL, the lse within 1e-5 of
    max(1, |lse|), the output with the lse equal to the one without) and
    the backward (within the tile-scaled tolerance, two calls bit-equal)
    at qk 192 / v 128."""
    rng = np.random.default_rng(S + H)
    kw = dict(scale=192 ** -0.5, causal=causal, window=0, logit_cap=0.0)
    q, k, v, do = _mla_inputs(rng, cuda, dt, B, S, H, K)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    alone = ops.flash_attention_bshd(q, k, v, **kw)
    plain, plain_lse = fa.flash_attention_torch(q, k, v, return_lse=True,
                                                **kw)
    torch.cuda.synchronize()
    assert out.shape == (B, S, H, 128) and torch.equal(out, alone)
    assert _within(out, plain, FLASH_TOL[dt])
    assert float((lse - plain_lse).abs().max()) <= 1e-5 * max(
        1.0, float(plain_lse.abs().max()))
    got = ops.flash_attention_bwd(q, k, v, plain, plain_lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, plain, plain_lse, do, **kw)
    want = fa.flash_attention_bwd_torch(q, k, v, plain, plain_lse, do, **kw)
    torch.cuda.synchronize()
    for name, g, g2, p in zip("qkv", got, again, want):
        assert g.dtype == dt and g.shape == p.shape, name
        assert torch.equal(g, g2), f"d{name}: two calls differ"
        assert _within(g, p, _bwd_tol(p, dt)), name


def _tol_used(g, p, tol):
    atol, rtol = tol
    return float(((g.float() - p.float()).abs()
                  / (atol + rtol * p.float().abs())).max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_backward_tolerance_rejects_planted_faults_at_mla_s_pair(
        cuda, dt):
    """At qk 192 / v 128 the tolerance rejects, at least 10 times over, a
    kernel that contracted S over the nope columns only (k's rope columns
    zeroed) or dropped the last q tile from dK and dV."""
    B, S, H, K = 1, 300, 4, 4
    rng = np.random.default_rng(7)
    kw = dict(scale=192 ** -0.5, causal=True, window=0, logit_cap=0.0)
    q, k, v, do = _mla_inputs(rng, cuda, dt, B, S, H, K)
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    tols = [_bwd_tol(p, dt) for p in plain]
    kz = k.clone()
    kz[..., 128:] = 0
    d = do.clone()
    d[:, (S - 1) // 64 * 64:] = 0
    for wrong, held in ((ops.flash_attention_bwd(q, kz, v, o, lse, do, **kw),
                         (0, 1, 2)),
                        (ops.flash_attention_bwd(q, k, v, o, lse, d, **kw),
                         (1, 2))):
        assert max(_tol_used(wrong[j], plain[j], tols[j])
                   for j in held) >= 10


def test_autograd_at_mla_s_pair_launches_both_kernels_and_no_plain_version(
        cuda, monkeypatch):
    rng = np.random.default_rng(3)
    q, k, v, do = _mla_inputs(rng, cuda, torch.bfloat16, 2, 200, 4, 4)
    leaves = [t.requires_grad_() for t in (q, k, v)]

    def barred(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(fa, "flash_attention_torch", barred)
    monkeypatch.setattr(fa, "flash_attention_bwd_torch", barred)
    ops.reset_launches()
    out = ops.flash_attention_bshd(*leaves, scale=192 ** -0.5)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [g.shape for g in grads] == [t.shape for t in (q, k, v)]
    assert ops.launches == dict(ops.launches, flash_attention_bshd=1,
                                flash_attention_bwd=1)


def test_flash_wrappers_refuse_other_unequal_pairs_and_mla_softcaps(cuda):
    rng = np.random.default_rng(0)
    q, k, v, do = _mla_inputs(rng, cuda, torch.bfloat16, 1, 64, 2, 2)
    lse = torch.zeros(1, 2, 64, device=cuda)
    q2, k2, v2, do2 = (t[..., :n].contiguous()
                       for t, n in ((q, 128), (k, 128), (v, 64), (do, 64)))
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_bshd(q2, k2, v2, scale=0.1)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_bwd(q2, k2, v2, do2, lse, do2, scale=0.1)
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention_bshd(q, k, v, scale=0.1, logit_cap=30.0)
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention_bwd(q, k, v, do, lse, do, scale=0.1,
                                logit_cap=30.0)


def test_flash_backward_wrapper_refuses_hd256(cuda):
    """hd 256 trains with a softcap (gemma2) as without one
    (recurrentgemma): the wrapper takes it and launches once, within the
    tolerance of the plain version; an unequal pair at 256 is refused
    before any launch."""
    rng = np.random.default_rng(2)
    x, k, v, do = (_randn(rng, (1, 64, n, 256), cuda, torch.bfloat16)
                   for n in (2, 1, 1, 2))
    kw = dict(scale=0.0625, causal=True, window=0, logit_cap=30.0)
    o, lse = fa.flash_attention_torch(x, k, v, return_lse=True, **kw)
    before = ops.launches["flash_attention_bwd"]
    got = ops.flash_attention_bwd(x, k, v, o, lse, do, **kw)
    plain = fa.flash_attention_bwd_torch(x, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == before + 1
    for g, p in zip(got, plain):
        assert _within(g, p, _bwd_tol(p, torch.bfloat16))
    v2 = x[..., :128].contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_bwd(x, x, v2, v2, lse, v2, scale=0.0625)
    assert ops.launches["flash_attention_bwd"] == before + 1


# recurrentgemma's local layers: MQA (K 1, G 16) at hd 256 with a window;
# also K 8, G 2, around the window's edge and past it, and a window of 100
# at B 2, S 1,000 (its edge cuts the dK/dV kernel's 64-row stages).
# gemma2's layers: K 8, G 2 under its softcap of 50 (scale 1/16), local
# (a window) and global (none), ragged; a cap that binds at unit scores
# (2); MQA under the cap, so the kv_split parts see it
FLASH_BWD_HD256_CASES = [(1, S, 16, 1, 64, 0.0)
                         for S in (1, 31, 77, 129, 300)] \
    + [(1, 1000, 16, 1, 512, 0.0), (2, 257, 16, 8, 100, 0.0),
       (1, 2049, 16, 1, 2048, 0.0), (2, 1000, 16, 1, 100, 0.0),
       (1, 1000, 16, 8, 0, 50.0), (2, 257, 16, 8, 100, 50.0),
       (1, 300, 16, 8, 64, 2.0), (1, 300, 16, 1, 64, 2.0),
       (1, 77, 16, 8, 0, 50.0)]


def _bwd_without_dcap(q, k, v, o, lse, do, *, scale, causal, window,
                      logit_cap, kv_block=64):
    """The plain backward with the softcap's factor 1 - tanh^2 dropped from
    dS (P keeps the cap): a planted fault, what a kernel that forgot the
    factor would give (``chip_smoke.py:bwd_without_dcap``, keep equal)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, hd).float()
    dof = do.reshape(B, S, K, G, hd).float()
    lse_g = lse.permute(0, 2, 1).reshape(B, S, K, G)
    delta = (dof * o.reshape(B, S, K, G, hd).float()).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, S, K, hd), device=q.device)
    dv = torch.zeros((B, S, K, hd), device=q.device)
    pq = torch.arange(S, device=q.device)[:, None]
    for t0 in range(0, S, kv_block):
        t1 = min(t0 + kv_block, S)
        kc, vc = k[:, t0:t1].float(), v[:, t0:t1].float()
        s = torch.einsum("bskgd,btkd->bskgt", qf, kc) * scale
        s = logit_cap * torch.tanh(s / logit_cap)
        pk = torch.arange(t0, t1, device=q.device)[None, :]
        live = (pk <= pq) if causal else torch.ones_like(pq - pk, dtype=bool)
        if window:
            live = live & (pq - pk < window)
        p = torch.where(live[None, :, None, None, :],
                        torch.exp(s - lse_g[..., None]), 0.0)
        dv[:, t0:t1] = torch.einsum("bskgt,bskgd->btkd", p, dof)
        ds = p * (torch.einsum("bskgd,btkd->bskgt", dof, vc)
                  - delta[..., None])
        dq += torch.einsum("bskgt,btkd->bskgd", ds, kc) * scale
        dk[:, t0:t1] = torch.einsum("bskgt,bskgd->btkd", ds, qf) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,window,cap", FLASH_BWD_HD256_CASES)
def test_flash_backward_at_hd256_matches_plain(cuda, dt, B, S, H, K, window,
                                               cap):
    """The backward at hd 256 (dK/dV items split over parts of the q
    heads, their fp32 partials summed; under a softcap consumer 0 hands
    P^T (1 - tanh^2) over) within the tile-scaled tolerance, two calls
    bit-equal, one wrapper call counted; the forward's lse within 1e-5 of
    max(1, |lse|)."""
    rng = np.random.default_rng(S + K + window)
    hd = 256
    q, k, v, do = (_randn(rng, (B, S, n, hd), cuda, dt)
                   for n in (H, K, K, H))
    kw = dict(scale=hd ** -0.5, causal=True, window=window, logit_cap=cap)
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    _, lse_k = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    before = ops.launches["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == before + 2
    assert float((lse_k - lse).abs().max()) <= 1e-5 * max(
        1.0, float(lse.abs().max()))
    for name, g, g2, p in zip("qkv", got, again, want):
        assert g.dtype == dt and g.shape == p.shape, name
        assert torch.equal(g, g2), f"d{name}: two calls differ"
        assert _within(g, p, _bwd_tol(p, dt)), name


def test_flash_backward_tolerance_rejects_planted_faults_at_hd256(cuda):
    """At hd 256 (MQA, window 64 under S 300; sharp scores, q drawn 4
    times wider, so that a row's weight can sit on its frontier key) the
    tolerance rejects, at least 10 times over, a kernel that dropped one
    q head of the group or the last q tile from dK and dV, or put the
    window's frontier one key off."""
    B, S, H, K, hd, w = 1, 300, 16, 1, 256, 64
    rng = np.random.default_rng(11)
    kw = dict(scale=hd ** -0.5, causal=True, window=w, logit_cap=0.0)
    q, k, v, do = (_randn(rng, (B, S, n, hd), cuda, torch.bfloat16)
                   for n in (H, K, K, H))
    q = (q.float() * 4).bfloat16()
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    tols = [_bwd_tol(p, torch.bfloat16) for p in plain]
    head, tile = do.clone(), do.clone()
    head[:, :, H - 1] = 0
    tile[:, (S - 1) // 64 * 64:] = 0
    faults = [(ops.flash_attention_bwd(q, k, v, o, lse, head, **kw), (1, 2)),
              (ops.flash_attention_bwd(q, k, v, o, lse, tile, **kw), (1, 2))]
    for ww in (w - 1, w + 1):
        faults.append((ops.flash_attention_bwd(q, k, v, o, lse, do,
                                               **dict(kw, window=ww)),
                       (0, 1, 2)))
    for wrong, held in faults:
        assert max(_tol_used(wrong[j], plain[j], tols[j])
                   for j in held) >= 10


def test_flash_backward_tolerance_rejects_planted_faults_at_hd256_with_a_softcap(
        cuda):
    """gemma2's local layers (K 8, G 2, window 64 under S 300, its cap of
    50, q drawn 40 times wider so that the scores spread over the cap's
    bend: tanh(s / 50) of about 0.8 a standard deviation): the tolerance
    rejects, at least 10 times over, a q head or the last q tile dropped
    from dK and dV, the window's frontier one key off, and the softcap's
    factor 1 - tanh^2 dropped from dS."""
    B, S, H, K, hd, w = 1, 300, 16, 8, 256, 64
    rng = np.random.default_rng(13)
    kw = dict(scale=hd ** -0.5, causal=True, window=w, logit_cap=50.0)
    q, k, v, do = (_randn(rng, (B, S, n, hd), cuda, torch.bfloat16)
                   for n in (H, K, K, H))
    q = (q.float() * 40).bfloat16()
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    tols = [_bwd_tol(p, torch.bfloat16) for p in plain]
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(_within(g, p, t) for g, p, t in zip(got, plain, tols))
    head, tile = do.clone(), do.clone()
    head[:, :, 1::2] = 0
    tile[:, (S - 1) // 64 * 64:] = 0
    faults = [(ops.flash_attention_bwd(q, k, v, o, lse, head, **kw), (1, 2)),
              (ops.flash_attention_bwd(q, k, v, o, lse, tile, **kw), (1, 2)),
              (_bwd_without_dcap(q, k, v, o, lse, do, **kw), (0, 1))]
    for ww in (w - 1, w + 1):
        faults.append((ops.flash_attention_bwd(q, k, v, o, lse, do,
                                               **dict(kw, window=ww)),
                       (0, 1, 2)))
    for wrong, held in faults:
        assert max(_tol_used(wrong[j], plain[j], tols[j])
                   for j in held) >= 10


def test_autograd_at_hd256_launches_both_kernels_and_no_plain_version(
        cuda, monkeypatch):
    rng = np.random.default_rng(4)
    q, k, v, do = (_randn(rng, (1, 200, n, 256), cuda, torch.bfloat16)
                   for n in (16, 1, 1, 16))
    leaves = [t.requires_grad_() for t in (q, k, v)]

    def barred(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(fa, "flash_attention_torch", barred)
    monkeypatch.setattr(fa, "flash_attention_bwd_torch", barred)
    ops.reset_launches()
    out = ops.flash_attention_bshd(*leaves, scale=1 / 16, window=64)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [g.shape for g in grads] == [t.shape for t in (q, k, v)]
    assert ops.launches == dict(ops.launches, flash_attention_bshd=1,
                                flash_attention_bwd=1)


# the RG-LRU backward: |kernel - plain| <= 1e-5 of the largest |plain| of
# the element's 64-step tile of a batch row (dh0: of the row) + 1e-6
RGLRU_BWD_TOL, RGLRU_BWD_NOISE = 1e-5, 1e-6


def _rglru_bwd_within(g, p):
    a = p.abs()
    if a.ndim == 3:
        B, S, R = a.shape
        pad = -S % 64
        t = torch.nn.functional.pad(a, (0, 0, 0, pad)).view(
            B, (S + pad) // 64, 64, R)
        t = t.amax(dim=(2, 3), keepdim=True).expand_as(t)
        t = t.reshape(B, S + pad, R)[:, :S]
    else:
        t = a.amax(dim=-1, keepdim=True).expand_as(a)
    return bool(((g - p).abs() <= RGLRU_BWD_TOL * t + RGLRU_BWD_NOISE).all())


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("B,S,R", [
    (2, 64, 256),
    (1, 77, 100),          # ragged S and R
    (3, 5, 4096),          # shorter than one pass
    (2, 1, 33),
    (1, 1000, 4096),       # the training width
    (1, 4095, 4096),       # (t6)'s microbatch, a ragged last tile
    (2, 300, 4094),        # rows not 16-byte multiples: the cp.async path
])
def test_rglru_backward_kernel_matches_plain(cuda, with_h0, B, S, R):
    """Row 0 is padded past step n (log_a = 0, b = 0): its carry there is
    the running sum of dh.  Two calls bit-equal; the Function launches the
    forward and the backward kernel once each and no plain version."""
    rng = np.random.default_rng(S * R + with_h0 + 1)
    log_a, b, h0 = _rglru_inputs(rng, cuda, B, S, R)
    n = max(S - 20, 1)
    log_a[0, n:] = 0
    b[0, n:] = 0
    h0 = h0 if with_h0 else None
    dh = torch.from_numpy(rng.normal(size=(B, S, R)).astype(
        np.float32)).to(cuda)
    h = ops.rglru_scan_bsr(log_a, b, h0)
    before = ops.launches["rglru_scan_bwd"]
    got = ops.rglru_scan_bwd(log_a, h, dh, h0)
    again = ops.rglru_scan_bwd(log_a, h, dh, h0)
    want = rg.rglru_scan_bwd_torch(log_a, h, dh, h0)
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan_bwd"] == before + 2
    assert (got[2] is None) == (h0 is None)
    for name, g, g2, p in zip(("dlog_a", "db", "dh0"), got, again, want):
        if p is None:
            continue
        assert g.dtype == torch.float32 and g.shape == p.shape, name
        assert torch.equal(g, g2), f"{name}: two calls differ"
        assert _rglru_bwd_within(g, p), name
    if S > n:
        tail = dh[0, n:].flip(0).cumsum(0).flip(0)
        assert bool(((got[1][0, n:] - tail).abs()
                     <= 1e-5 * tail.abs().max() + 1e-5).all())
    leaves = [t.clone().requires_grad_() for t in (log_a, b)]
    ops.reset_launches()
    out = ops.rglru_scan_bsr(*leaves, h0)
    assert type(out.grad_fn).__name__ == "RGLRUScanBackward"
    fn = torch.autograd.grad(out, leaves, dh)
    torch.cuda.synchronize()
    assert ops.launches == dict(ops.launches, rglru_scan_bsr=1,
                                rglru_scan_bwd=1)
    for g, p in zip(fn, got):
        assert torch.equal(g, p)


def test_rglru_backward_tolerance_rejects_planted_faults(cuda):
    """At the training width the tolerance rejects, at least 10 times
    over, a kernel that dropped one step's dh or read h one step late."""
    rng = np.random.default_rng(9)
    log_a, b, h0 = _rglru_inputs(rng, cuda, 2, 300, 4096)
    dh = torch.from_numpy(rng.normal(size=(2, 300, 4096)).astype(
        np.float32)).to(cuda)
    h = ops.rglru_scan_bsr(log_a, b, h0)
    plain = rg.rglru_scan_bwd_torch(log_a, h, dh, h0)
    d = dh.clone()
    d[:, 150] = 0
    late = torch.roll(h, -1, dims=1).contiguous()
    for wrong, j in ((ops.rglru_scan_bwd(log_a, h, d, h0), 1),
                     (ops.rglru_scan_bwd(log_a, late, dh, h0), 0)):
        p = plain[j]
        assert not _rglru_bwd_within(wrong[j], p)
        over = (wrong[j] - p).abs().max() / (
            RGLRU_BWD_TOL * p.abs().max() + RGLRU_BWD_NOISE)
        assert float(over) >= 10


def test_rglru_backward_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan_bwd(x[:, :, ::2], x[:, :, ::2], x[:, :, ::2])
    with pytest.raises(ValueError, match="different devices"):
        ops.rglru_scan_bwd(x, x, x, torch.zeros(2, 64))
    with pytest.raises(ValueError, match="fp32"):
        ops.rglru_scan_bwd(x, x, x.bfloat16())


def test_serving_does_not_take_the_autograd_function(cuda):
    rng = np.random.default_rng(0)
    q = _randn(rng, (1, 64, 4, 64), cuda, torch.bfloat16).requires_grad_()
    k = _randn(rng, (1, 64, 2, 64), cuda, torch.bfloat16).requires_grad_()
    ops.reset_launches()
    with torch.inference_mode():
        out = ops.flash_attention_bshd(q, k, k, scale=0.125)
    assert out.grad_fn is None
    out = ops.flash_attention_bshd(q, k, k, scale=0.125)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.float().sum().backward()
    assert ops.launches == dict(ops.launches, flash_attention_bshd=2,
                                flash_attention_bwd=1)


@pytest.mark.parametrize("arch", ["paper-overhead-100m", "qwen3-0.6b",
                                  "rwkv6-7b", "deepseek-v2-236b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two fp32 steps (2 microbatches) of a reduced config (hd widened to
    64, the backward kernel's smallest) from the same init (drawn on the
    CPU and copied: a CUDA generator draws other numbers) and batches, TF32
    off: each step's gradients within 1e-4 of each leaf's largest
    magnitude, losses within 1e-5 relative, and the weights after them
    within 1e-5 except where Adam amplifies fp32 noise (an element whose
    gradient was below 1e-4 of its leaf's largest in a step can move by
    up to 2 lr more: m / sqrt(v) ~ sign(g)), and there within 2 lr a
    step.  rwkv6-7b's gradients amplify rounding in the WKV6 output, which
    the forward kernel (3xTF32) rounds otherwise than the plain version
    (``tools/rwkv_grad_sensitivity.py``): its gradients are held within
    5e-4 of each leaf's largest and its weights within 1e-4, as in
    ``chip_smoke.py``'s train parity and ``tests/test_torch_rwkv_train.py``.
    deepseek-v2's MLA is widened to the kernels' pair instead: q and k
    192 (128 nope + 64 rope), v 128."""
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64)
    if cfg.use_mla:
        cfg = dataclasses.replace(cfg, qk_nope_head_dim=128,
                                  qk_rope_head_dim=64, v_head_dim=128)
    lr, n_steps = 1e-3, 2
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        run = RunConfig(num_microbatches=2, learning_rate=lr,
                        warmup_steps=1, total_steps=n_steps)
        data = SyntheticLMData(cfg.vocab_size, 96, 4, seed=0)
        out = []
        init = steps.init_train_state(cfg, seed=0, run=run,
                                      device=torch.device("cpu"))
        for dev in (cuda, torch.device("cpu")):
            model = Model(cfg, device=dev)
            model.load_state_dict(init["params"].state_dict())
            state = steps.new_train_state(make_trainable(model), run)
            ctx = Ctx(device=dev, dtype=torch.float32)
            step = steps.make_train_step(cfg, ctx, run)
            ops.reset_launches()
            losses, grads = [], []
            for i in range(n_steps):
                batch = data.batch_at(i, dev)
                names, leaves = zip(*model.named_parameters())
                loss, _ = steps.loss_fn(cfg, compute_params(model,
                                                            torch.float32),
                                        batch, ctx)
                grads.append({n: g.cpu() for n, g in zip(
                    names, torch.autograd.grad(loss, leaves))})
                losses.append(float(step(state, batch)[1]["loss"]))
            out.append((losses, grads, dict(ops.launches), {
                n: p.detach().cpu() for n, p in model.named_parameters()}))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (lc, gc, launches, pc), (lp, gp, _, pp) = out
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    # the train steps' flash or WKV6 calls (the gradient probes' calls add
    # one forward and one backward a layer a step)
    fwd, bwd = ("wkv6_bshn", "wkv6_bwd") if arch == "rwkv6-7b" \
        else ("flash_attention_bshd", "flash_attention_bwd")
    assert launches[fwd] == cfg.num_layers * 3 * n_steps
    assert launches[bwd] == cfg.num_layers * 3 * n_steps
    grad_tol, weight_tol = (5e-4, 1e-4) if arch == "rwkv6-7b" \
        else (1e-4, 1e-5)
    noisy = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in pp.items()}
    for g_c, g_p in zip(gc, gp):
        for n, g in g_p.items():
            scale = max(g.abs().max().item(), 1e-30)
            err = (g_c[n] - g).abs().max().item()
            assert err <= grad_tol * scale, (n, err, scale)
            noisy[n] |= g.abs() < 1e-4 * scale
    for n, w in pp.items():
        err = (pc[n] - w).abs()
        assert err.max().item() <= 2 * lr * n_steps, (n, err.max().item())
        assert not bool((err[~noisy[n]] > weight_tol).any()), \
            (n, err[~noisy[n]].max().item())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b",
                                  "recurrentgemma-9b", "deepseek-v2-236b",
                                  "granite-moe-1b-a400m",
                                  "paper-overhead-100m"])
def test_a_model_built_on_the_card_equals_the_cpu_s(cuda, arch):
    """The weights are drawn on the host and copied, so one seed gives
    the same reduced model on both devices, bit for bit."""
    cfg = get_config(arch).reduced()
    on_cpu = build_model(cfg, device="cpu", seed=5)
    on_card = build_model(cfg, device=cuda, seed=5)
    for (n, a), (_, b) in zip(on_cpu.named_parameters(),
                              on_card.named_parameters()):
        assert torch.equal(a, b.cpu()), n


# Cross-attention: Sq queries against Sk keys, no causal mask, no window
# (seamless-m4t-medium's decoder over its encoder frames).  B, Sq, Sk, H, K,
# hd: G 1 at hd 64 as seamless, the kernels' tile edges on both lengths
# (Sk 1, 65, 77, 1000; Sq 1; Sq < Sk), and G 2 at hd 128 so the group
# sum runs at Sq != Sk.
CROSS_CASES = [
    (2, 256, 64, 4, 4, 64),
    (1, 300, 77, 16, 16, 64),
    (2, 130, 1, 4, 4, 64),
    (1, 200, 65, 4, 4, 64),
    (1, 130, 1000, 4, 4, 64),
    (1, 1, 264, 4, 4, 64),
    (1, 100, 1024, 4, 4, 64),
    (1, 500, 300, 8, 4, 128),
]


def _cross_inputs(rng, dev, dt, B, Sq, Sk, H, K, hd):
    return (_randn(rng, (B, Sq, H, hd), dev, dt),
            _randn(rng, (B, Sk, K, hd), dev, dt),
            _randn(rng, (B, Sk, K, hd), dev, dt),
            _randn(rng, (B, Sq, H, hd), dev, dt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd", CROSS_CASES)
def test_flash_kernels_at_a_key_length_apart_match_plain(cuda, dt, B, Sq,
                                                         Sk, H, K, hd):
    """The forward (output within FLASH_TOL, lse within 1e-5 of max(1,
    |lse|)) and the backward (within the tile-scaled tolerance, two calls
    bit-equal) at Sq != Sk, launched through the wrappers."""
    rng = np.random.default_rng(Sq * 7 + Sk)
    kw = dict(scale=hd ** -0.5, causal=False, window=0, logit_cap=0.0)
    q, k, v, do = _cross_inputs(rng, cuda, dt, B, Sq, Sk, H, K, hd)
    before = dict(ops.launches)
    alone = ops.flash_attention_bshd(q, k, v, **kw)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    plain, plain_lse = fa.flash_attention_torch(q, k, v, return_lse=True,
                                                **kw)
    got = ops.flash_attention_bwd(q, k, v, plain, plain_lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, plain, plain_lse, do, **kw)
    want = fa.flash_attention_bwd_torch(q, k, v, plain, plain_lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bshd"] == \
        before["flash_attention_bshd"] + 1
    assert ops.launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 2
    assert out.shape == (B, Sq, H, hd) and torch.equal(out, alone)
    assert _within(out, plain, FLASH_TOL[dt])
    assert lse.shape == (B, H, Sq)
    assert float((lse - plain_lse).abs().max()) <= 1e-5 * max(
        1.0, float(plain_lse.abs().max()))
    for name, g, g2, p in zip("qkv", got, again, want):
        assert g.dtype == dt and g.shape == p.shape, name
        assert torch.equal(g, g2), f"d{name}: two calls differ"
        assert _within(g, p, _bwd_tol(p, dt)), name


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_tolerances_at_a_key_length_apart_reject_planted_faults(
        cuda, dt):
    """At Sq 256 against Sk 300 the tolerances reject, at least 10 times
    over, a backward that dropped the last key tile of Sk from dQ (the dQ
    of the keys before it) and a forward that read the key past Sk as live
    (the zero key the card's loads give past Sk, taken into the softmax;
    shown on scores below zero, where a key of score 0 weighs)."""
    B, Sq, Sk, H, K, hd = 1, 256, 300, 4, 4, 64
    rng = np.random.default_rng(11)
    kw = dict(scale=hd ** -0.5, causal=False, window=0, logit_cap=0.0)
    q, k, v, do = _cross_inputs(rng, cuda, dt, B, Sq, Sk, H, K, hd)
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    tol = _bwd_tol(plain[0], dt)
    bn = fa.bwd_stream_tiles(hd)[1]
    cut = (Sk - 1) // bn * bn
    dropped = ops.flash_attention_bwd(q, k[:, :cut].contiguous(),
                                      v[:, :cut].contiguous(), o, lse, do,
                                      **kw)[0]
    assert _tol_used(dropped, plain[0], tol) >= 10
    qs = (q.float().abs() * 2).to(dt)
    ks = (-k.float().abs() * 2).to(dt)
    vs = (v.float() + 1).to(dt)
    want = fa.flash_attention_torch(qs, ks, vs, **kw)
    zero = torch.zeros_like(ks[:, :1])
    past = ops.flash_attention_bshd(qs, torch.cat([ks, zero], 1),
                                    torch.cat([vs, zero], 1), **kw)
    assert _within(ops.flash_attention_bshd(qs, ks, vs, **kw), want,
                   FLASH_TOL[dt])
    assert _tol_used(past, want, FLASH_TOL[dt]) >= 10


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_kernels_at_g1_hd64_match_plain(cuda, dt, causal):
    """seamless's self-attention: G 1 at hd 64 (H = K = 16), the decoder's
    causal and the encoder's full attention, forward and backward."""
    B, S, H, K, hd = 1, 333, 16, 16, 64
    rng = np.random.default_rng(333)
    kw = dict(scale=hd ** -0.5, causal=causal, window=0, logit_cap=0.0)
    q, k, v, do = _cross_inputs(rng, cuda, dt, B, S, S, H, K, hd)
    out = ops.flash_attention_bshd(q, k, v, **kw)
    plain, plain_lse = fa.flash_attention_torch(q, k, v, return_lse=True,
                                                **kw)
    got = ops.flash_attention_bwd(q, k, v, plain, plain_lse, do, **kw)
    want = fa.flash_attention_bwd_torch(q, k, v, plain, plain_lse, do, **kw)
    torch.cuda.synchronize()
    assert _within(out, plain, FLASH_TOL[dt])
    for name, g, p in zip("qkv", got, want):
        assert _within(g, p, _bwd_tol(p, dt)), name
