"""The port's RWKV6 slice against the JAX reference on the CPU: the WKV6
kernel's plain version, the time- and channel-mix, the model's logits and
RWKV cache, and the serving engine.

All inputs are made with numpy from a seed and handed to both packages;
the reference runs with ``Ctx(mesh=None, dtype=float32)`` and its Pallas
WKV kernel in interpret mode (``repro.kernels.ops.wkv6_bshn`` on the CPU).
Both sides compute in fp32 and keep fp32 caches (``cfg.dtype="float32"``).

Tolerances:

* WKV6: 2e-4 absolute / 1e-3 relative on outputs of magnitude up to ~100
  (the state sums hundreds of k vᵀ terms; only the order of the fp32
  sums differs between the chunked and step-by-step forms);
* time/channel mix, logits and caches: 1e-4 absolute, as in
  ``test_torch_model.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.jobspec import ServeSpec as RefServeSpec  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.launch import engine as ref_engine  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import rwkv as ref_rwkv  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import count_params as ref_count  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import wkv6_torch  # noqa: E402
from repro_torch.launch import engine, serve  # noqa: E402
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import rwkv as port_rwkv  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import Model, cast_params, count_params  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

WKV_ATOL, WKV_RTOL = 2e-4, 1e-3


ATOL = 1e-4
CPU = torch.device("cpu")
ARCH = "rwkv6-7b"
STATE = ("s", "shift_tm", "shift_cm")


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------
def test_rwkv_config_is_a_faithful_copy():
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    for a, b in ((rcfg, tcfg), (rcfg.reduced(), tcfg.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.layer_kinds() == b.layer_kinds()
        assert (a.rwkv_head_dim, a.rwkv_ddlerp_rank, a.rwkv_decay_rank) == \
            (b.rwkv_head_dim, b.rwkv_ddlerp_rank, b.rwkv_decay_rank)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_rwkv_count_params_matches_reference(reduced):
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    if reduced:
        rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
    for embed in (False, True):
        assert count_params(tcfg, include_embed=embed) == \
            ref_count(rcfg, include_embed=embed)
    if not reduced:
        assert 7.0e9 < count_params(tcfg) < 7.1e9      # 7.04 B


def test_rwkv_init_follows_the_reference_recipes():
    """Decay biases in [-7, -5] (lw ≈ -exp(-6)), lerps in [0, 1], LoRAs
    and the bonus at std 0.02, GroupNorm gain ones, untied head."""
    cfg = get_config(ARCH).reduced()
    model = port_model.build_model(cfg, device="cpu", seed=0)
    tm, cm = model.blocks[0].tm, model.blocks[0].cm
    assert -7 <= tm.w_base.min() and tm.w_base.max() <= -5
    for mu in (tm.tm_mu, cm.cm_mu_k, cm.cm_mu_r):
        assert 0 <= mu.min() and mu.max() <= 1
    for leaf in (tm.tm_A, tm.tm_B, tm.ww_A, tm.ww_B, tm.u):
        assert 0.01 < leaf.std() < 0.03
    assert torch.equal(tm.ln_x, torch.ones_like(tm.ln_x))
    assert torch.equal(model.blocks[0].cm_norm,
                       torch.ones_like(model.blocks[0].cm_norm))
    assert model.lm_head.shape == (cfg.d_model, cfg.padded_vocab)


@pytest.mark.parametrize("narrow", [{}, dict(rwkv_head_dim=16)],
                         ids=["reduced", "heads4"])
def test_converted_reference_tree_matches_the_state_dict(narrow):
    """``params_from_jax`` unstacks the reference's RWKV groups into
    exactly the port's state-dict keys and shapes."""
    rcfg, tcfg = (dataclasses.replace(c.reduced(), **narrow)
                  for c in (ref_get_config(ARCH), get_config(ARCH)))
    tree = params_from_jax(
        jax.device_get(ref_init_params(rcfg, jax.random.key(0))), tcfg)
    want = Model(tcfg, device="meta").state_dict()
    assert sorted(tree) == sorted(want)
    assert all(tuple(tree[k].shape) == tuple(want[k].shape) for k in want)


# ---------------------------------------------------------------------------
# WKV6: the plain version against the Pallas kernel and the oracles
# ---------------------------------------------------------------------------
def _wkv_inputs(seed, B, S, H, N, decay):
    """r/k/v ~ N(0,1), u ~ 0.5·N(0,1), a nonzero s0; ``decay`` is a
    constant lw or "mixed" (lw = -exp(U(-6, 2)): -e^-6 .. -e^2)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, N)).astype(np.float32)
               for _ in range(3))
    if decay == "mixed":
        lw = -np.exp(rng.uniform(-6, 2, (B, S, H, N))).astype(np.float32)
    else:
        lw = np.full((B, S, H, N), decay, np.float32)
    u = (0.5 * rng.normal(size=(H, N))).astype(np.float32)
    s0 = (0.3 * rng.normal(size=(B, H, N, N))).astype(np.float32)
    return r, k, v, lw, u, s0


def _fold(a):
    B, S, H, N = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, N)


def _unfold(a, B, H):
    BH, S, N = a.shape
    return a.reshape(B, H, S, N).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("decay", ["mixed", -3.0, -8.0])
@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("S", [32, 70, 128])
def test_wkv6_plain_matches_pallas_and_oracle(S, chunk, N, decay):
    B, H = 2, 2
    args = _wkv_inputs(S * N + chunk, B, S, H, N, decay)
    r, k, v, lw, u, s0 = args
    o, s_fin = wkv6_torch(*map(_t, args), chunk=chunk)
    o, s_fin = o.numpy(), s_fin.numpy()
    assert np.isfinite(o).all() and np.isfinite(s_fin).all()

    po, ps = ref_ops.wkv6_bshn(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(o, _np(po), atol=WKV_ATOL, rtol=WKV_RTOL)
    np.testing.assert_allclose(s_fin, _np(ps), atol=WKV_ATOL, rtol=WKV_RTOL)

    uf = np.broadcast_to(u[None], (B, H, N)).reshape(B * H, 1, N)
    s0f = s0.reshape(B * H, N, N)
    jo, js = ref_ref.wkv6_ref(*(jnp.asarray(_fold(a)) for a in (r, k, v, lw)),
                              jnp.asarray(uf), jnp.asarray(s0f))
    to, ts = ref.wkv6_ref(*(_t(_fold(a)) for a in (r, k, v, lw)), _t(uf),
                          _t(s0f))
    for oracle_o, oracle_s in ((_np(jo), _np(js)),
                               (to.numpy(), ts.numpy())):
        np.testing.assert_allclose(o, _unfold(oracle_o, B, H), atol=WKV_ATOL,
                                   rtol=WKV_RTOL)
        np.testing.assert_allclose(s_fin, oracle_s.reshape(B, H, N, N),
                                   atol=WKV_ATOL, rtol=WKV_RTOL)


@pytest.mark.parametrize("S,chunk", [(64, 32), (70, 16)])
def test_wkv6_plain_matches_reference_chunked(S, chunk):
    """The port's eager oracle ``models.rwkv.wkv6_chunked`` against the
    reference's jnp one (the model's non-Pallas path) at decays where the
    reference's multiply-mask does not overflow (lw >= -1)."""
    B, H, N = 2, 3, 16
    args = list(_wkv_inputs(S, B, S, H, N, "mixed"))
    args[3] = np.maximum(args[3], -1.0)
    o, s_fin = port_rwkv.wkv6_chunked(*map(_t, args), chunk=chunk)
    ro, rs = ref_rwkv.wkv6_chunked(*map(jnp.asarray, args), chunk)
    np.testing.assert_allclose(o.numpy(), _np(ro), atol=WKV_ATOL,
                               rtol=WKV_RTOL)
    np.testing.assert_allclose(s_fin.numpy(), _np(rs), atol=WKV_ATOL,
                               rtol=WKV_RTOL)


def test_wkv6_padding_steps_leave_the_state_unchanged():
    """Steps with k = 0 and lw = 0 past a row's length: the step oracle's
    final state is bit-equal to the state at the length, the chunked
    version's within tolerance, and both agree on the valid outputs."""
    B, S, H, N, n = 2, 50, 2, 16, 23
    r, k, v, lw, u, s0 = _wkv_inputs(1, B, S, H, N, "mixed")
    k[:, n:] = 0.0
    lw[:, n:] = 0.0
    cut = [a[:, :n] for a in (r, k, v, lw)]
    uf = _t(np.broadcast_to(u[None], (B, H, N)).reshape(B * H, 1, N).copy())
    s0f = _t(s0.reshape(B * H, N, N))
    _, s_pad = ref.wkv6_ref(*(_t(_fold(a)) for a in (r, k, v, lw)), uf, s0f)
    _, s_cut = ref.wkv6_ref(*(_t(_fold(a)) for a in cut), uf, s0f)
    assert torch.equal(s_pad, s_cut)
    o_pad, sp = wkv6_torch(*map(_t, (r, k, v, lw, u, s0)), chunk=16)
    o_cut, sc = wkv6_torch(*map(_t, (*cut, u, s0)), chunk=16)
    np.testing.assert_allclose(sp.numpy(), sc.numpy(), atol=1e-5)
    np.testing.assert_allclose(o_pad[:, :n].numpy(), o_cut.numpy(),
                               atol=1e-5)


# The CUDA kernel's arithmetic, emulated on the CPU: chunks of 8 steps,
# every decay a running product of exp(lw) factors (never the exp of a
# difference of cumulative sums), its three products in split TF32 (an fp32
# operand as hi + lo, both rounded to TF32 by bit operations as
# cvt.rna.tf32.f32 rounds, or for the state's read-out truncated as the
# kernel splits it; lo.hi + hi.lo + hi.hi, or lo.V + hi.V when V is bf16
# and so exact in TF32) and the state update added with one rounding.
# Held against the step oracle at the kernel's own tolerance on the card
# (1e-5 of the largest magnitude), this catches a factorisation that
# overflows or a split that loses precision before the card does.
KERNEL_CHUNK = 8
KERNEL_SCALE = 1e-5


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _trunc_tf32(x):
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_split(a, b, b_exact, a_trunc=False):
    """a . b from the TF32 parts; ``a_trunc``: a's hi truncated and its lo
    truncated by the tensor core (the kernel's split of the state)."""
    if a_trunc:
        ah = _trunc_tf32(a)
        al = _trunc_tf32(a - ah)
    else:
        ah, al = _split_tf32(a)
    if b_exact:
        return al @ b + ah @ b
    bh, bl = _split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _wkv6_kernel_emulation(r, k, v, lw, u, s0, v_exact):
    """r, k, v, lw (BH, S, N) fp32 (r, k, v already in their dtype's
    values), u (BH, N), s0 (BH, N, N); returns (o, s_final) fp32."""
    BH, S, N = r.shape
    L = KERNEL_CHUNK
    pad = (-S) % L
    r, k, v, lw = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (r, k, v, lw))
    s = s0.clone()
    outs = []
    for c0 in range(0, S + pad, L):
        rc, kc, vc, lwc = (t[:, c0:c0 + L] for t in (r, k, v, lw))
        w = torch.exp(lwc)
        rd, kd = torch.empty_like(rc), torch.empty_like(kc)
        p = torch.ones(BH, N)
        for t in range(L):                   # r (*) prod_{s<t} w_s
            rd[:, t] = rc[:, t] * p
            p = p * w[:, t]
        p_chunk = p
        p = torch.ones(BH, N)
        for t in reversed(range(L)):         # k (*) prod_{s>t} w_s
            kd[:, t] = kc[:, t] * p
            p = p * w[:, t]
        a = torch.zeros(BH, L, L)
        for tau in range(L):
            x = rc[:, tau].clone()
            a[:, tau, tau] = (x * u * kc[:, tau]).sum(-1)
            for i in range(tau - 1, -1, -1):
                a[:, tau, i] = (x * kc[:, i]).sum(-1)
                x = x * w[:, i]
        o_inter = _mm_split(s.transpose(1, 2), rd.transpose(1, 2), False,
                            a_trunc=True).transpose(1, 2)
        outs.append(o_inter + _mm_split(a, vc, v_exact))
        upd = _mm_split(kd.transpose(1, 2), vc, v_exact)
        s = (s.double() * p_chunk[..., None].double()
             + upd.double()).float()
    return torch.cat(outs, dim=1)[:, :S], s


@pytest.mark.parametrize("decay", ["mixed", -3.0, -8.0, "strong"])
@pytest.mark.parametrize("N,S", [(16, 77), (64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_arithmetic_matches_the_oracle(decay, N, S, dtype):
    """"strong": lw = -exp(U(-6, 4)), decays down to -e^4 a step."""
    B, H = 2, 2
    r, k, v, lw, u, s0 = _wkv_inputs(S + N, B, S, H, N,
                                     "mixed" if decay == "strong" else decay)
    if decay == "strong":
        rng = np.random.default_rng(S)
        lw = -np.exp(rng.uniform(-6, 4, lw.shape)).astype(np.float32)
    if dtype == "bfloat16":                 # the values a bf16 input holds
        r, k, v = (_t(a).bfloat16().float().numpy() for a in (r, k, v))
    uf = np.broadcast_to(u[None], (B, H, N)).reshape(B * H, N)
    s0f = _t(s0.reshape(B * H, N, N))
    folded = [_t(_fold(a)) for a in (r, k, v, lw)]
    o, s_fin = _wkv6_kernel_emulation(*folded, _t(uf.copy()), s0f,
                                      v_exact=dtype == "bfloat16")
    assert torch.isfinite(o).all() and torch.isfinite(s_fin).all()
    ro, rs = ref.wkv6_ref(*folded, _t(uf.reshape(B * H, 1, N).copy()), s0f)
    for got, want in ((o, ro), (s_fin, rs)):
        atol = KERNEL_SCALE * want.abs().max().item()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                                   rtol=0)


def test_ops_wkv6_bshn_takes_the_plain_version_on_cpu():
    args = [_t(a) for a in _wkv_inputs(0, 1, 40, 2, 16, "mixed")]
    before = dict(ops.launches)
    o, s = ops.wkv6_bshn(*args, chunk=16)
    assert ops.launches == before               # no kernel launched
    po, ps = wkv6_torch(*args, chunk=16)
    assert torch.equal(o, po) and torch.equal(s, ps)
    r, k, v, lw, u, s0 = args
    with pytest.raises(ValueError, match="fp32"):
        ops.wkv6_bshn(r, k, v, lw.double(), u, s0)
    with pytest.raises(ValueError, match="shapes"):
        ops.wkv6_bshn(r, k[:, :-1], v, lw, u, s0)
    with pytest.raises(ValueError, match="s0"):
        ops.wkv6_bshn(r, k, v, lw, u, s0[:, :1])
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.wkv6_bshn(r, k.bfloat16(), v, lw, u, s0)


# ---------------------------------------------------------------------------
# Time-mix and channel-mix, one layer
# ---------------------------------------------------------------------------
def _configs(**narrow):
    over = dict(cache_layout="paged", dtype="float32", **narrow)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def _weights(rcfg, tcfg):
    rparams = ref_init_params(rcfg, jax.random.key(0))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rparams, model


@pytest.fixture(scope="module")
def heads4():
    """rwkv6-7b .reduced() with rwkv_head_dim 16, so d 64 has H 4."""
    rcfg, tcfg = _configs(rwkv_head_dim=16)
    rparams, model = _weights(rcfg, tcfg)
    return rcfg, tcfg, rparams, cast_params(model, torch.float32)


def _layer_state(rng, B, H, N, D):
    return {"s": (0.3 * rng.normal(size=(B, H, N, N))).astype(np.float32),
            "shift_tm": rng.normal(size=(B, D)).astype(np.float32),
            "shift_cm": rng.normal(size=(B, D)).astype(np.float32)}


@pytest.mark.parametrize("mixer", ["time", "channel"])
@pytest.mark.parametrize("mode", ["full", "ragged", "decode"])
def test_mixers_match_reference(heads4, mixer, mode):
    rcfg, tcfg, rparams, tparams = heads4
    B, D, N = 3, rcfg.d_model, rcfg.rwkv_head_dim
    S = 1 if mode == "decode" else 45       # a 32-step chunk and a tail
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    state = _layer_state(rng, B, D // N, N, D)
    lengths = np.array([45, 0, 30], np.int32) if mode == "ragged" else None
    amode = "decode" if mode == "decode" else "full"
    key = "tm" if mixer == "time" else "cm"
    rp = jax.tree.map(lambda a: a[0], rparams["decoder"]["groups"]["0"][key])
    tp = tparams["blocks"][0][key]
    rfn = ref_rwkv.rwkv_time_mix if mixer == "time" \
        else ref_rwkv.rwkv_channel_mix
    tfn = port_rwkv.rwkv_time_mix if mixer == "time" \
        else port_rwkv.rwkv_channel_mix
    ry, rc = rfn(rcfg, rp, jnp.asarray(x),
                 RefCtx(mesh=None, dtype=jnp.float32), mode=amode,
                 cache={n: jnp.asarray(a) for n, a in state.items()},
                 lengths=None if lengths is None else jnp.asarray(lengths))
    ty, tc = tfn(tcfg, tp, _t(x), Ctx(device=CPU, dtype=torch.float32),
                 mode=amode, cache={n: _t(a) for n, a in state.items()},
                 lengths=None if lengths is None else _t(lengths))
    valid = np.ones((B, S), bool) if lengths is None \
        else np.arange(S)[None] < lengths[:, None]
    np.testing.assert_allclose(ty.numpy()[valid], _np(ry)[valid], atol=ATOL)
    for name in STATE:
        np.testing.assert_allclose(tc[name].numpy(), _np(rc[name]),
                                   atol=ATOL, err_msg=name)
    if mode == "ragged":                    # the length-0 row keeps its state
        for name in STATE:
            assert torch.equal(tc[name][1], _t(state[name][1])), name


# ---------------------------------------------------------------------------
# The model: logits and the RWKV cache
# ---------------------------------------------------------------------------
MODEL_CASES = {"reduced": {}, "heads4": dict(rwkv_head_dim=16)}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def pair(request):
    rcfg, tcfg = _configs(**MODEL_CASES[request.param])
    rparams, model = _weights(rcfg, tcfg)
    return rcfg, tcfg, rparams, cast_params(model, torch.float32)


def _ref_state(cache, name):
    return _np(cache["groups"]["0"]["rwkv"][name])       # (L, B, ...)


def _port_state(cache, name):
    return np.stack([t.float().numpy() for t in cache[name]])


def _assert_same_cache(tc, rc):
    for name in STATE:
        np.testing.assert_allclose(_port_state(tc, name), _ref_state(rc, name),
                                   atol=ATOL, err_msg=name)


def test_forward_prefill_ragged_decode_match_reference(pair):
    """A plain prefill fills every row's state; a ragged prefill then
    re-prefills rows 0 and 2 (row 1 has length 0 and must keep its state
    byte for byte); three decode steps follow.  Logits and the per-layer
    RWKV state agree with the reference at every stage."""
    rcfg, tcfg, rparams, tparams = pair
    B, max_len = 3, 64
    rng = np.random.default_rng(11)
    first = rng.integers(0, rcfg.vocab_size, (B, 40)).astype(np.int32)
    second = rng.integers(0, rcfg.vocab_size, (B, 37)).astype(np.int32)
    lengths = np.array([37, 0, 20], np.int32)
    rc = ref_model.init_cache(rcfg, B, max_len, layout="paged",
                              page_budget=B * 8, paged_tables="empty")
    tc = port_model.init_cache(tcfg, B, max_len, page_budget=B * 8,
                               device=CPU)
    rctx = RefCtx(mesh=None, dtype=jnp.float32)
    tctx = Ctx(device=CPU, dtype=torch.float32)

    rl, rc, _ = ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(first)},
                                  rctx, mode="prefill", cache=rc)
    tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(first).long()},
                                tctx, mode="prefill", cache=tc)
    np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
    _assert_same_cache(tc, rc)

    kept = {name: [t[1].clone() for t in tc[name]] for name in STATE}
    rl, rc, _ = ref_model.forward(rcfg, rparams,
                                  {"tokens": jnp.asarray(second)}, rctx,
                                  mode="prefill", cache=rc,
                                  lengths=jnp.asarray(lengths))
    tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(second).long()},
                                tctx, mode="prefill", cache=tc,
                                lengths=_t(lengths))
    live = lengths > 0
    np.testing.assert_allclose(tl.numpy()[live], _np(rl)[live], atol=ATOL)
    _assert_same_cache(tc, rc)
    for name in STATE:
        for before, after in zip(kept[name], tc[name]):
            assert torch.equal(before, after[1]), name

    pos = np.array([37, 40, 20], np.int32)
    tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
    for _ in range(3):
        rl, rc, _ = ref_model.forward(rcfg, rparams, {"tokens": jnp.asarray(tok)},
                                      rctx, mode="decode", cache=rc,
                                      pos=jnp.asarray(pos))
        tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(tok).long()},
                                    tctx, mode="decode", cache=tc,
                                    pos=_t(pos))
        np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
        tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        pos = pos + 1
    _assert_same_cache(tc, rc)


def test_rwkv_cache_layout():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), cache_layout="paged",
                              rwkv_head_dim=16)
    cache = port_model.init_cache(cfg, 2, 20, device=CPU)
    assert sorted(cache) == ["page_table", "s", "shift_cm", "shift_tm"]
    assert tuple(cache["page_table"].shape) == (2, 3)
    assert all(tuple(t.shape) == (2, 4, 16, 16) and t.dtype == torch.float32
               for t in cache["s"])
    assert all(tuple(t.shape) == (2, 64) and t.dtype == torch.bfloat16
               for t in cache["shift_tm"] + cache["shift_cm"])
    assert len(cache["s"]) == cfg.num_layers


def test_chunked_prefill_is_refused_for_rwkv(pair):
    _, tcfg, _, tparams = pair
    cache = port_model.init_cache(tcfg, 2, 16, device=CPU)
    with pytest.raises(NotImplementedError, match="all-global"):
        port_model.forward(tcfg, tparams, {"tokens": torch.zeros(2, 4).long()},
                           Ctx(device=CPU, dtype=torch.float32),
                           mode="prefill", cache=cache,
                           lengths=torch.tensor([4, 4]),
                           starts=torch.tensor([0, 2]))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
ENGINE_CASES = {
    "rwkv": dict(batch=3, prompt_len=40, gen=6, requests=7),
    "rwkv-evict": dict(batch=3, prompt_len=40, gen=6, requests=7,
                       page_budget=14, overcommit=2.0),
}
HOST_STATE = ("host_table", "free_lists", "refcount", "reserved", "toks",
              "pos", "responses", "journal", "stats")


@pytest.fixture(scope="module")
def engine_weights():
    rcfg, tcfg = _configs(rwkv_head_dim=16)
    rparams, model = _weights(rcfg, tcfg)
    return rcfg, tcfg, rparams, model


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_rwkv_engine_token_streams_match_reference(engine_weights, case):
    rcfg, tcfg, rparams, model = engine_weights
    spec = ENGINE_CASES[case]
    ref = ref_engine.ServingEngine(rcfg, RefCtx(mesh=None, dtype=jnp.float32),
                                   rparams, RefServeSpec(**spec))
    port = engine.ServingEngine(tcfg, model, ServeSpec(**spec), device=CPU,
                                dtype=torch.float32)
    assert not port.prefix_cache and not ref.prefix_cache
    requests = engine.synthesize_requests(tcfg, ServeSpec(**spec), seed=3)
    for r in requests:
        ref.submit(ref_engine.Request(req=r.req, tokens=r.tokens.copy(),
                                      gen_len=r.gen_len))
        port.submit(r)
    while not port.idle:
        for eng in (ref, port):
            eng.admit()
        if all(s is None for s in port.slots):
            assert all(s is None for s in ref.slots)
            continue
        for eng in (ref, port):
            eng.step()
        ps, rs = port.snapshot(), ref.snapshot()
        for key in HOST_STATE:
            if isinstance(ps[key], np.ndarray):
                np.testing.assert_array_equal(ps[key], rs[key], err_msg=key)
            else:
                assert ps[key] == rs[key], key
    assert ref.idle
    assert port.responses == ref.responses
    assert sorted(port.responses) == [r.req for r in requests]
    for r in requests:
        assert len(port.responses[r.req]) == r.gen_len
    if "evict" in case:
        assert port.evictions > 0
    _assert_same_cache(port.cache, ref.cache)


def test_rwkv_snapshot_restore_continues_byte_identically(engine_weights):
    _, tcfg, _, model = engine_weights
    spec = ServeSpec(**ENGINE_CASES["rwkv-evict"])
    requests = engine.synthesize_requests(tcfg, spec, seed=5)
    run = engine.ServingEngine(tcfg, model, spec, device=CPU,
                               dtype=torch.float32)
    for r in requests:
        run.submit(r)
    run.admit()
    run.step()
    run.step()
    snap = run.snapshot()
    assert sorted(snap["cache"]) == ["page_table", "s", "shift_cm",
                                     "shift_tm"]
    run.run()

    fresh = engine.ServingEngine(tcfg, model, spec, device=CPU,
                                 dtype=torch.float32)
    fresh.restore(snap)
    again = fresh.snapshot()
    for name in STATE:
        for a, b in zip(again["cache"][name], snap["cache"][name],
                        strict=True):
            assert torch.equal(a, b), name
    # the snapshot is a copy: the live engine's later steps did not reach it
    assert not all(torch.equal(a, b) for a, b in
                   zip(snap["cache"]["s"], run.cache["s"]))
    fresh.run()
    assert fresh.responses == run.responses
    assert fresh.journal == run.journal
    for name in STATE:
        for a, b in zip(fresh.cache[name], run.cache[name], strict=True):
            assert torch.equal(a, b), name


def test_restore_refuses_a_snapshot_of_another_stack(engine_weights):
    _, tcfg, _, model = engine_weights
    spec = ServeSpec(batch=2, prompt_len=16, gen=4, requests=2)
    snap = engine.ServingEngine(tcfg, model, spec, device=CPU,
                                dtype=torch.float32).snapshot()
    qcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               cache_layout="paged")
    qmodel = port_model.build_model(qcfg, device="cpu")
    with pytest.raises(ValueError, match="snapshot cache"):
        engine.ServingEngine(qcfg, qmodel, spec, device=CPU).restore(snap)


def test_serve_cli_serves_rwkv_on_cpu(capsys):
    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--continuous",
                     "--batch", "3", "--prompt-len", "40", "--gen", "5",
                     "--requests", "5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b-reduced" in out and "completed 5/5" in out
    assert "prefix cache:" not in out      # off for a non-attention stack
