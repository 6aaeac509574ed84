"""The port's recurrentgemma slice against the JAX reference on the CPU: the
RG-LRU scan's plain version, the recurrent block, the local-attention ring,
the hd-256 windowed flash attention, the model's logits and hybrid cache,
and the serving engine.

All inputs are made with numpy from a seed and handed to both packages;
the reference runs with ``Ctx(mesh=None, dtype=float32)`` (its model path
takes the associative scan and ``flash_attention_jnp``) and its Pallas
RG-LRU kernel in interpret mode (``repro.kernels.ops.rglru_scan_bsr`` on
the CPU).  Both sides compute in fp32 and keep fp32 caches
(``cfg.dtype="float32"``).

Tolerances:

* RG-LRU scan: 1e-5 absolute + 1e-5 relative (carries of magnitude up to
  ~30; the step loop, the doubling scan and the reference's associative
  scan round their fp32 products in different orders);
* flash attention at hd 256: 1e-5 absolute on outputs of magnitude ~1;
* the ring writer and the decode update only move values: bit-equal;
* recurrent block, attention layer, logits and caches: 1e-4 absolute,
  as in ``test_torch_model.py``.
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
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro.models.attention import (  # noqa: E402
    flash_attention_jnp as ref_flash_jnp,
)
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import count_params as ref_count  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_torch,
)
from repro_torch.kernels.rglru_scan import rglru_scan_torch  # noqa: E402
from repro_torch.launch import engine, serve  # noqa: E402
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import recurrent as port_rec  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import Model, cast_params, count_params  # noqa: E402

SCAN_ATOL, SCAN_RTOL = 1e-5, 1e-5
FLASH_ATOL = 1e-5
ATOL = 1e-4
CPU = torch.device("cpu")
ARCH = "recurrentgemma-9b"
REC_LEAVES = ("h", "conv")
RING_LEAVES = ("k", "v", "pos")


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------
def test_recurrentgemma_config_is_a_faithful_copy():
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    for a, b in ((rcfg, tcfg), (rcfg.reduced(), tcfg.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.layer_kinds() == b.layer_kinds()
    kinds = tcfg.layer_kinds()
    assert len(kinds) == 38 and kinds.count("recurrent") == 26 \
        and kinds.count("local") == 12
    assert tcfg.reduced().layer_kinds() == ("recurrent", "recurrent",
                                            "local", "recurrent")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_recurrentgemma_count_params_matches_reference(reduced):
    rcfg, tcfg = ref_get_config(ARCH), get_config(ARCH)
    if reduced:
        rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
    for embed in (False, True):
        assert count_params(tcfg, include_embed=embed) == \
            ref_count(rcfg, include_embed=embed)
    if not reduced:
        assert count_params(tcfg, include_embed=True) == 9_396_195_328


def test_recurrentgemma_init_follows_the_reference_recipes():
    """σ(Λ) in [0.9, 0.999] (Griffin's decay range), conv taps at std
    0.02, zero conv bias, GeGLU FFN on every layer, tied embeddings."""
    cfg = get_config(ARCH).reduced()
    model = port_model.build_model(cfg, device="cpu", seed=0)
    rec = model.blocks[0].rec
    a = torch.sigmoid(rec.rglru_lambda)
    assert 0.9 - 1e-6 <= a.min() and a.max() <= 0.999 + 1e-6
    assert a.std() > 0.02                              # spread, not constant
    assert 0.01 < rec.conv_w.std() < 0.03
    assert torch.equal(rec.conv_b, torch.zeros_like(rec.conv_b))
    assert all(hasattr(b, "ffn") for b in model.blocks)
    assert hasattr(model.blocks[2], "attn") and not hasattr(model.blocks[2],
                                                            "rec")
    assert not hasattr(model, "lm_head")


@pytest.mark.parametrize("over", [{}, dict(num_layers=7)],
                         ids=["group-and-tail", "two-groups-and-tail"])
def test_converted_reference_tree_matches_the_state_dict(over):
    """``params_from_jax`` unstacks the reference's (R, R, L) groups and
    its tail into exactly the port's state-dict keys and shapes, and every
    value lands on its layer."""
    rcfg, tcfg = (dataclasses.replace(c.reduced(), **over)
                  for c in (ref_get_config(ARCH), get_config(ARCH)))
    rtree = jax.device_get(ref_init_params(rcfg, jax.random.key(0)))
    tree = params_from_jax(rtree, tcfg)
    want = Model(tcfg, device="meta").state_dict()
    assert sorted(tree) == sorted(want)
    assert all(tuple(tree[k].shape) == tuple(want[k].shape) for k in want)
    groups = rtree["decoder"]["groups"]
    n_groups = tcfg.num_layers // 3
    np.testing.assert_array_equal(
        tree[f"blocks.{3 * (n_groups - 1) + 1}.rec.gate_r"].numpy(),
        np.asarray(groups["1"]["rec"]["gate_r"][n_groups - 1]))
    np.testing.assert_array_equal(
        tree[f"blocks.{3 * n_groups}.rec.rglru_lambda"].numpy(),
        np.asarray(rtree["decoder"]["tail"]["0"]["rec"]["rglru_lambda"]))


# ---------------------------------------------------------------------------
# The RG-LRU scan: the plain version against the Pallas kernel and oracles
# ---------------------------------------------------------------------------
def _scan_inputs(seed, B, S, R, decay):
    """b ~ N(0, 1); ``decay`` "init" draws log_a the way the model does at
    its initial Λ (8·r·log σ(Λ), r ~ U(0, 1), σ(Λ) ~ U(0.9, 0.999)),
    "strong" draws log_a = -U(1, 20)."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(B, S, R)).astype(np.float32)
    if decay == "init":
        lam = rng.uniform(0.9, 0.999, size=(R,))
        log_a = 8.0 * rng.uniform(0, 1, size=(B, S, R)) * np.log(lam)
    else:
        log_a = -rng.uniform(1, 20, size=(B, S, R))
    h0 = (3.0 * rng.normal(size=(B, R))).astype(np.float32)
    return log_a.astype(np.float32), b, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("decay", ["init", "strong"])
@pytest.mark.parametrize("S", [1, 16, 37, 64])
def test_rglru_plain_matches_pallas_and_oracles(S, decay, with_h0):
    B, R = 2, 24
    log_a, b, h0 = _scan_inputs(S + len(decay), B, S, R, decay)
    if not with_h0:
        h0 = np.zeros_like(h0)
    before = dict(ops.launches)
    h = ops.rglru_scan_bsr(_t(log_a), _t(b), _t(h0) if with_h0 else None)
    assert ops.launches == before               # the plain version, no kernel
    h = h.numpy()
    assert h.shape == (B, S, R) and np.isfinite(h).all()
    tol = dict(atol=SCAN_ATOL, rtol=SCAN_RTOL)
    pallas = _np(ref_ops.rglru_scan_bsr(jnp.asarray(log_a), jnp.asarray(b),
                                        jnp.asarray(h0)))
    np.testing.assert_allclose(h, pallas, **tol)
    oracles = {
        "jax rglru_ref": _np(ref_ref.rglru_ref(
            jnp.asarray(log_a), jnp.asarray(b), jnp.asarray(h0))),
        "port rglru_ref": ref.rglru_ref(_t(log_a), _t(b), _t(h0)).numpy(),
        "jax assoc": _np(ref_rec.rglru_scan_assoc(
            jnp.asarray(log_a), jnp.asarray(b), jnp.asarray(h0))),
        "port assoc": port_rec.rglru_scan_assoc(_t(log_a), _t(b),
                                                _t(h0)).numpy(),
    }
    for name, want in oracles.items():
        np.testing.assert_allclose(h, want, err_msg=name, **tol)


def test_rglru_padding_steps_leave_the_carry_unchanged():
    """Steps with log_a = 0 and b = 0 past a row's length: the carry at
    the last step is bit-equal to the carry at the length, in the plain
    version and the step oracle alike."""
    B, S, R, n = 2, 40, 16, 23
    log_a, b, h0 = _scan_inputs(4, B, S, R, "init")
    log_a[:, n:] = 0.0
    b[:, n:] = 0.0
    for fn in (rglru_scan_torch, ref.rglru_ref):
        h = fn(_t(log_a), _t(b), _t(h0))
        cut = fn(_t(log_a[:, :n]), _t(b[:, :n]), _t(h0))
        assert torch.equal(h[:, -1], cut[:, -1])
        assert torch.equal(h[:, :n], cut)


def test_ops_rglru_scan_bsr_checks_its_operands():
    log_a, b, h0 = map(_t, _scan_inputs(0, 2, 8, 4, "init"))
    with pytest.raises(ValueError, match="fp32"):
        ops.rglru_scan_bsr(log_a.double(), b)
    with pytest.raises(ValueError, match="shapes"):
        ops.rglru_scan_bsr(log_a, b[:, :-1])
    with pytest.raises(ValueError, match="h0"):
        ops.rglru_scan_bsr(log_a, b, h0[:1])
    with pytest.raises(ValueError, match="fp32"):
        ops.rglru_scan_bsr(log_a, b, h0.bfloat16())


# ---------------------------------------------------------------------------
# The recurrent block, one layer
# ---------------------------------------------------------------------------
def _configs(**narrow):
    over = dict(cache_layout="paged", dtype="float32", **narrow)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def _weights(rcfg, tcfg, seed=0):
    rparams = ref_init_params(rcfg, jax.random.key(seed))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rparams, model


@pytest.fixture(scope="module")
def pair():
    rcfg, tcfg = _configs()
    rparams, model = _weights(rcfg, tcfg)
    return rcfg, tcfg, rparams, cast_params(model, torch.float32)


def _rctx():
    return RefCtx(mesh=None, dtype=jnp.float32)


def _tctx():
    return Ctx(device=CPU, dtype=torch.float32)


def test_rglru_gates_and_conv_match_reference(pair):
    rcfg, _, rparams, tparams = pair
    rp = jax.tree.map(lambda a: a[0], rparams["decoder"]["groups"]["1"]["rec"])
    tp = tparams["blocks"][1]["rec"]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 11, rcfg.rnn_width)).astype(np.float32)
    state = rng.normal(size=(3, rcfg.conv1d_width - 1,
                             rcfg.rnn_width)).astype(np.float32)
    for la, lb in zip(port_rec.rglru_gates(tp, _t(x)),
                      ref_rec.rglru_gates(rp, jnp.asarray(x))):
        np.testing.assert_allclose(la.numpy(), _np(lb), atol=ATOL)
    for st in (None, state):
        to, ts = port_rec.conv1d_causal(tp, _t(x),
                                        None if st is None else _t(st))
        ro, rs = ref_rec.conv1d_causal(rp, jnp.asarray(x),
                                       None if st is None else jnp.asarray(st))
        np.testing.assert_allclose(to.numpy(), _np(ro), atol=ATOL)
        np.testing.assert_array_equal(ts.numpy(), _np(rs))


@pytest.mark.parametrize("mode", ["full", "ragged", "decode"])
def test_rglru_block_matches_reference(pair, mode):
    """Outputs and the layer's new (h, conv) from a nonzero state: the
    ragged batch has a full row, a length-0 row (keeps its state byte for
    byte) and a row shorter than the conv window's reach."""
    rcfg, tcfg, rparams, tparams = pair
    B, R, CW = 3, rcfg.rnn_width, rcfg.conv1d_width
    S = 1 if mode == "decode" else 21
    rng = np.random.default_rng(5)
    u = rng.normal(size=(B, S, rcfg.d_model)).astype(np.float32)
    state = {"h": rng.normal(size=(B, R)).astype(np.float32),
             "conv": rng.normal(size=(B, CW - 1, R)).astype(np.float32)}
    lengths = np.array([21, 0, 2], np.int32) if mode == "ragged" else None
    amode = "decode" if mode == "decode" else "full"
    rp = jax.tree.map(lambda a: a[0], rparams["decoder"]["groups"]["0"]["rec"])
    ry, rc = ref_rec.rglru_block(
        rcfg, rp, jnp.asarray(u), _rctx(), mode=amode,
        cache={n: jnp.asarray(a) for n, a in state.items()},
        lengths=None if lengths is None else jnp.asarray(lengths))
    ty, tc = port_rec.rglru_block(
        tcfg, tparams["blocks"][0]["rec"], _t(u), _tctx(), mode=amode,
        cache={n: _t(a) for n, a in state.items()},
        lengths=None if lengths is None else _t(lengths))
    valid = np.ones((B, S), bool) if lengths is None \
        else np.arange(S)[None] < lengths[:, None]
    np.testing.assert_allclose(ty.numpy()[valid], _np(ry)[valid], atol=ATOL)
    for name in REC_LEAVES:
        np.testing.assert_allclose(tc[name].numpy(), _np(rc[name]),
                                   atol=ATOL, err_msg=name)
    assert tc["h"].dtype == torch.float32
    if mode == "ragged":
        for name in REC_LEAVES:
            assert torch.equal(tc[name][1], _t(state[name][1])), name


# ---------------------------------------------------------------------------
# Local attention: the ring, and flash attention at hd 256
# ---------------------------------------------------------------------------
def _ring(rng, B, K, W, hd):
    """A ring holding earlier contents: random K/V, positions or -1."""
    pos = rng.integers(-1, 50, size=(B, W)).astype(np.int32)
    return {"k": rng.normal(size=(B, K, W, hd)).astype(np.float32),
            "v": rng.normal(size=(B, K, W, hd)).astype(np.float32),
            "pos": pos}


def test_ring_prefill_writer_matches_reference():
    """Rows longer than the ring (wrap), shorter than it, exactly W, and
    of length 0 (keeps every slot): bit-equal K, V and position map."""
    B, S0, K, W, hd = 5, 29, 2, 8, 4
    rng = np.random.default_rng(9)
    ring = _ring(rng, B, K, W, hd)
    k = rng.normal(size=(B, S0, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S0, K, hd)).astype(np.float32)
    lengths = np.array([29, 0, 5, 8, 19], np.int32)
    want = ref_attn._write_prefill_ring_ragged(
        {n: jnp.asarray(a) for n, a in ring.items()}, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(lengths), W)
    got = port_attn._write_prefill_ring_ragged(
        {n: _t(a.copy()) for n, a in ring.items()}, _t(k), _t(v),
        _t(lengths))
    for name in RING_LEAVES:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    for name in RING_LEAVES:                      # the length-0 row
        np.testing.assert_array_equal(got[name][1].numpy(), ring[name][1])


def test_ring_decode_update_matches_reference():
    """Positions that wrap the ring, that do not, and inactive rows
    (pos = -1: slot 0 is written and marked invalid), three steps."""
    B, K, W, hd = 4, 1, 8, 4
    rng = np.random.default_rng(10)
    ring = _ring(rng, B, K, W, hd)
    rc = {n: jnp.asarray(a) for n, a in ring.items()}
    tc = {n: _t(a.copy()) for n, a in ring.items()}
    pos = np.array([3, 8, -1, 21], np.int32)
    for _ in range(3):
        k = rng.normal(size=(B, 1, K, hd)).astype(np.float32)
        v = rng.normal(size=(B, 1, K, hd)).astype(np.float32)
        rc, *_ = ref_attn._update_decode_kv(rc, jnp.asarray(k),
                                            jnp.asarray(v),
                                            jnp.asarray(pos), W)
        tc = port_attn._update_decode_kv_ring(tc, _t(k), _t(v), _t(pos))
        for name in RING_LEAVES:
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(rc[name]), err_msg=name)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    assert tc["pos"][2, 0] == -1


@pytest.mark.parametrize("S,window", [(128, 32), (77, 20), (70, 100)])
def test_flash_hd256_windowed_plain_matches_reference(S, window):
    """hd 256 with 16 q heads over one kv head (the local layers' MQA),
    causal, a window that cuts keys (or, at 100 > S, none)."""
    B, H, K, hd = 1, 16, 1, 256
    rng = np.random.default_rng(S + window)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    kw = dict(scale=hd ** -0.5, causal=True, window=window, logit_cap=0.0)
    before = dict(ops.launches)
    port = ops.flash_attention_bshd(_t(q), _t(k), _t(v), **kw)
    assert ops.launches == before
    np.testing.assert_array_equal(
        port.numpy(), flash_attention_torch(_t(q), _t(k), _t(v),
                                            **kw).numpy())
    want = _np(ref_flash_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw))
    np.testing.assert_allclose(port.numpy(), want, atol=FLASH_ATOL)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, S, hd)  # noqa: E731
    oracle = ref.attention_ref(_t(fold(q)), _t(fold(k)), _t(fold(v)),
                               group=H // K, **kw).numpy()
    np.testing.assert_allclose(fold(port.numpy()), oracle, atol=FLASH_ATOL)


def test_local_attention_layer_matches_reference(pair):
    """A ragged prefill into a nonzero ring (a row that wraps it, a
    length-0 row, a short row), then three decode steps with an inactive
    row: outputs and ring within tolerance."""
    rcfg, tcfg, rparams, tparams = pair
    B, K, W, hd = 3, rcfg.num_kv_heads, rcfg.window_size, rcfg.head_dim
    S0 = 27
    rng = np.random.default_rng(12)
    ring = _ring(rng, B, K, W, hd)
    x = rng.normal(size=(B, S0, rcfg.d_model)).astype(np.float32)
    lengths = np.array([27, 0, 6], np.int32)
    rp = jax.tree.map(lambda a: a[0],
                      rparams["decoder"]["groups"]["2"]["attn"])
    tp = tparams["blocks"][2]["attn"]
    rc = {n: jnp.asarray(a) for n, a in ring.items()}
    tc = {n: _t(a.copy()) for n, a in ring.items()}
    ry, rc = ref_attn.gqa_attention(
        rcfg, rp, jnp.asarray(x), _rctx(), kind="local", mode="full",
        cache=rc, pos=jnp.arange(S0, dtype=jnp.int32),
        lengths=jnp.asarray(lengths))
    ty, tc = port_attn.gqa_attention(
        tcfg, tp, _t(x), kind="local", mode="full", cache=tc,
        pos=torch.arange(S0, dtype=torch.int32), lengths=_t(lengths))
    valid = np.arange(S0)[None] < lengths[:, None]
    np.testing.assert_allclose(ty.numpy()[valid], _np(ry)[valid], atol=ATOL)
    for name in RING_LEAVES:
        np.testing.assert_allclose(tc[name].numpy(), _np(rc[name]),
                                   atol=ATOL, err_msg=name)
    pos = np.array([27, -1, 6], np.int32)
    for _ in range(3):
        xd = rng.normal(size=(B, 1, rcfg.d_model)).astype(np.float32)
        ry, rc = ref_attn.gqa_attention(
            rcfg, rp, jnp.asarray(xd), _rctx(), kind="local", mode="decode",
            cache=rc, pos=jnp.asarray(pos))
        ty, tc = port_attn.gqa_attention(
            tcfg, tp, _t(xd), kind="local", mode="decode", cache=tc,
            pos=_t(pos))
        act = pos >= 0
        np.testing.assert_allclose(ty.numpy()[act], _np(ry)[act], atol=ATOL)
        for name in RING_LEAVES:
            np.testing.assert_allclose(tc[name].numpy(), _np(rc[name]),
                                       atol=ATOL, err_msg=name)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)


# ---------------------------------------------------------------------------
# The model: logits and the hybrid cache
# ---------------------------------------------------------------------------
_GROUP = {"recurrent": "rec", "local": "attn"}


def _ref_leaf(cfg, cache, kind, name):
    """The reference's per-layer leaves of ``kind`` in layer order, stacked
    (groups are stacked on a leading dim, the tail is not)."""
    pat = len(cfg.block_pattern)
    n_body = cfg.num_layers // pat * pat
    out = []
    for i, k in enumerate(cfg.layer_kinds()):
        if k != kind:
            continue
        if i < n_body:
            leaf = cache["groups"][str(i % pat)][_GROUP[kind]][name][i // pat]
        else:
            leaf = cache["tail"][str(i - n_body)][_GROUP[kind]][name]
        out.append(_np(leaf))
    return np.stack(out)


def _assert_same_cache(cfg, tc, rc):
    for kind, names in (("recurrent", REC_LEAVES), ("local", RING_LEAVES)):
        for name in names:
            port = np.stack([t.float().numpy() for t in tc[name]])
            np.testing.assert_allclose(port, _ref_leaf(cfg, rc, kind, name),
                                       atol=ATOL, err_msg=name)


def test_hybrid_cache_layout():
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              cache_layout="paged")
    cache = port_model.init_cache(cfg, 2, 20, device=CPU)
    assert sorted(cache) == ["conv", "h", "k", "page_table", "pos", "v"]
    assert len(cache["h"]) == len(cache["conv"]) == 3
    assert len(cache["k"]) == len(cache["pos"]) == 1
    assert all(tuple(t.shape) == (2, 64) and t.dtype == torch.float32
               for t in cache["h"])
    assert all(tuple(t.shape) == (2, 3, 64) and t.dtype == torch.bfloat16
               for t in cache["conv"])
    assert tuple(cache["k"][0].shape) == (2, 1, 16, 16)
    assert bool((cache["pos"][0] == -1).all())
    assert tuple(cache["page_table"].shape) == (2, 3)


def test_forward_prefill_ragged_decode_match_reference(pair):
    """A plain prefill (prompts longer than the window) fills every row; a
    ragged prefill re-prefills rows 0 and 2 (row 1 has length 0 and keeps
    its h, conv and ring byte for byte); four decode steps follow, the
    rings wrapping.  Logits and every cache leaf agree with the reference
    at each stage."""
    rcfg, tcfg, rparams, tparams = pair
    B, max_len = 3, 48
    rng = np.random.default_rng(11)
    first = rng.integers(0, rcfg.vocab_size, (B, 21)).astype(np.int32)
    second = rng.integers(0, rcfg.vocab_size, (B, 30)).astype(np.int32)
    lengths = np.array([30, 0, 9], np.int32)
    rc = ref_model.init_cache(rcfg, B, max_len, layout="paged",
                              page_budget=B * 8, paged_tables="empty")
    tc = port_model.init_cache(tcfg, B, max_len, page_budget=B * 8,
                               device=CPU)

    rl, rc, _ = ref_model.forward(rcfg, rparams,
                                  {"tokens": jnp.asarray(first)}, _rctx(),
                                  mode="prefill", cache=rc)
    tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(first).long()},
                                _tctx(), mode="prefill", cache=tc)
    np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
    _assert_same_cache(tcfg, tc, rc)

    names = REC_LEAVES + RING_LEAVES
    kept = {name: [t[1].clone() for t in tc[name]] for name in names}
    rl, rc, _ = ref_model.forward(rcfg, rparams,
                                  {"tokens": jnp.asarray(second)}, _rctx(),
                                  mode="prefill", cache=rc,
                                  lengths=jnp.asarray(lengths))
    tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(second).long()},
                                _tctx(), mode="prefill", cache=tc,
                                lengths=_t(lengths))
    live = lengths > 0
    np.testing.assert_allclose(tl.numpy()[live], _np(rl)[live], atol=ATOL)
    _assert_same_cache(tcfg, tc, rc)
    for name in names:
        for before, after in zip(kept[name], tc[name]):
            assert torch.equal(before, after[1]), name

    pos = np.array([30, 21, 9], np.int32)
    tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
    for _ in range(4):
        rl, rc, _ = ref_model.forward(rcfg, rparams,
                                      {"tokens": jnp.asarray(tok)}, _rctx(),
                                      mode="decode", cache=rc,
                                      pos=jnp.asarray(pos))
        tl, tc = port_model.forward(tcfg, tparams, {"tokens": _t(tok).long()},
                                    _tctx(), mode="decode", cache=tc,
                                    pos=_t(pos))
        np.testing.assert_allclose(tl.numpy(), _np(rl), atol=ATOL)
        tok = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        pos = pos + 1
    _assert_same_cache(tcfg, tc, rc)


def test_embedding_scale_is_rounded_to_the_compute_dtype():
    """√d multiplies in the compute dtype: at d 64 it is 8 exactly; at
    d 96 √d = 9.798 rounds to 9.8125 in bf16, as in the reference."""
    for d in (64, 96):
        rcfg, tcfg = (dataclasses.replace(c, d_model=d) for c in _configs())
        rtree = ref_init_params(rcfg, jax.random.key(1))
        model = Model(tcfg, device=CPU)
        model.load_state_dict(params_from_jax(jax.device_get(rtree), tcfg))
        tokens = np.arange(6, dtype=np.int32)[None]
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = port_model._embed(tcfg, cast_params(model, dt),
                                    _t(tokens).long(),
                                    Ctx(device=CPU, dtype=dt))
            want = ref_model._embed(rcfg, ref_model.cast_params(rtree, jdt),
                                    jnp.asarray(tokens),
                                    RefCtx(mesh=None, dtype=jdt))
            np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_chunked_prefill_is_refused_for_the_hybrid(pair):
    _, tcfg, _, tparams = pair
    cache = port_model.init_cache(tcfg, 2, 16, device=CPU)
    with pytest.raises(NotImplementedError, match="all-global"):
        port_model.forward(tcfg, tparams, {"tokens": torch.zeros(2, 4).long()},
                           _tctx(), mode="prefill", cache=cache,
                           lengths=torch.tensor([4, 4]),
                           starts=torch.tensor([0, 2]))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
ENGINE_CASES = {
    # prompts of 12..24 tokens: the rings wrap in prefill
    "rg": dict(batch=3, prompt_len=24, gen=6, requests=7),
    # prompts of 7..14 tokens, up to 8 new ones: rings wrap in decode
    "rg-wrap-in-decode": dict(batch=3, prompt_len=14, gen=8, requests=6),
    "rg-evict": dict(batch=3, prompt_len=24, gen=6, requests=7,
                     page_budget=9, overcommit=2.0),
}
HOST_STATE = ("host_table", "free_lists", "refcount", "reserved", "toks",
              "pos", "responses", "journal", "stats")


@pytest.fixture(scope="module")
def engine_weights():
    rcfg, tcfg = _configs()
    rparams, model = _weights(rcfg, tcfg, seed=1)
    return rcfg, tcfg, rparams, model


def _ring_wrapped(requests, max_pos, window):
    return any(len(r.tokens) + r.gen_len - 1 > window for r in requests) \
        and max_pos >= window


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_recurrentgemma_engine_token_streams_match_reference(engine_weights,
                                                             case):
    rcfg, tcfg, rparams, model = engine_weights
    spec = ENGINE_CASES[case]
    ref = ref_engine.ServingEngine(rcfg, _rctx(), rparams,
                                   RefServeSpec(**spec))
    port = engine.ServingEngine(tcfg, model, ServeSpec(**spec), device=CPU,
                                dtype=torch.float32)
    assert not port.prefix_cache and not ref.prefix_cache
    requests = engine.synthesize_requests(tcfg, ServeSpec(**spec), seed=3)
    for r in requests:
        ref.submit(ref_engine.Request(req=r.req, tokens=r.tokens.copy(),
                                      gen_len=r.gen_len))
        port.submit(r)
    max_pos = 0
    while not port.idle:
        for eng in (ref, port):
            eng.admit()
        if all(s is None for s in port.slots):
            assert all(s is None for s in ref.slots)
            continue
        max_pos = max(max_pos, int(port.pos.max()))
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
    assert _ring_wrapped(requests, max_pos, tcfg.window_size)
    if "evict" in case:
        assert port.evictions > 0
    if "decode" in case:                  # a decode write wrapped the ring
        assert any(len(r.tokens) <= tcfg.window_size
                   < len(r.tokens) + r.gen_len - 1 for r in requests)
    _assert_same_cache(tcfg, port.cache, ref.cache)


def test_recurrentgemma_snapshot_restore_continues_byte_identically(
        engine_weights):
    _, tcfg, _, model = engine_weights
    spec = ServeSpec(**ENGINE_CASES["rg-evict"])
    requests = engine.synthesize_requests(tcfg, spec, seed=5)
    run = engine.ServingEngine(tcfg, model, spec, device=CPU,
                               dtype=torch.float32)
    for r in requests:
        run.submit(r)
    run.admit()
    run.step()
    run.step()
    snap = run.snapshot()
    assert sorted(snap["cache"]) == ["conv", "h", "k", "page_table", "pos",
                                     "v"]
    run.run()

    fresh = engine.ServingEngine(tcfg, model, spec, device=CPU,
                                 dtype=torch.float32)
    fresh.restore(snap)
    again = fresh.snapshot()
    names = REC_LEAVES + RING_LEAVES
    for name in names:
        for a, b in zip(again["cache"][name], snap["cache"][name],
                        strict=True):
            assert torch.equal(a, b), name
    # the snapshot is a copy: the live engine's later steps did not reach it
    assert not all(torch.equal(a, b) for a, b in
                   zip(snap["cache"]["h"], run.cache["h"]))
    fresh.run()
    assert fresh.responses == run.responses
    assert fresh.journal == run.journal
    for name in names:
        for a, b in zip(fresh.cache[name], run.cache[name], strict=True):
            assert torch.equal(a, b), name


def test_a_ring_shorter_than_the_window_is_refused_on_both_sides(
        engine_weights):
    """prompt_len + gen < window: the reference builds a short dense ring
    and raises at the first decode step (with a message about dense global
    caches); the port refuses the engine up front and says why."""
    rcfg, tcfg, rparams, model = engine_weights
    spec = dict(batch=2, prompt_len=8, gen=4, requests=2)
    ref = ref_engine.ServingEngine(rcfg, _rctx(), rparams,
                                   RefServeSpec(**spec))
    for r in engine.synthesize_requests(tcfg, ServeSpec(**spec), seed=0):
        ref.submit(ref_engine.Request(req=r.req, tokens=r.tokens.copy(),
                                      gen_len=r.gen_len))
    ref.admit()
    with pytest.raises(NotImplementedError, match="per-sequence decode"):
        ref.step()
    with pytest.raises(ValueError, match="shorter than the local window"):
        engine.ServingEngine(tcfg, model, ServeSpec(**spec), device=CPU,
                             dtype=torch.float32)
    with pytest.raises(ValueError, match="max_len >= window_size"):
        port_model.init_cache(tcfg, 2, 12, device=CPU)


def test_serve_cli_serves_recurrentgemma_on_cpu(capsys):
    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--continuous",
                     "--batch", "3", "--prompt-len", "24", "--gen", "5",
                     "--requests", "5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-9b-reduced" in out and "completed 5/5" in out
    assert "prefix cache:" not in out      # off for a stack with no globals
    with pytest.raises(SystemExit, match="shorter than the local window"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--continuous", "--prompt-len", "8", "--gen", "4"])


# The CUDA kernels' plan (``kernels/rglru_scan.py:rglru_plan``): pure
# Python, checked over every R from 1 to 4,096 at the training microbatch
# ((t6): B 1, S 4,096), the serving prefill ((d): B 8, S 2,560) and short
# and ragged S, for the forward and the backward, on an H100's 132 SMs.
H100_SMS = 132
PLAN_SHAPES = [(1, 4096), (8, 2560), (1, 1), (8, 77), (1, 4095)]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("B,S", PLAN_SHAPES,
                         ids=[f"B{b}-S{s}" for b, s in PLAN_SHAPES])
def test_rglru_plan_covers_every_channel_and_step_once(B, S, backward):
    """The blocks' channels (grid x: C channels each, masked past R) and
    the ring's tiles (steps each, the last one cut at S) cover every
    (channel, step) once; the ring and its barriers fit the 232,448
    bytes a block may use; the kernel's limits hold (C a warp multiple,
    steps a TMA box's 256 at most, 1 to 8 stages)."""
    from repro_torch.kernels.rglru_scan import SMEM_BYTES, rglru_plan
    for R in range(1, 4097):
        p = rglru_plan(B, S, R, H100_SMS, backward)
        C, steps, stages = p["channels"], p["steps"], p["stages"]
        assert C in (32, 64, 128) and 1 <= steps <= 256
        assert 1 <= stages <= 8 and p["threads"] == 2 * C + 32
        nx = p["grid"][0]
        assert p["grid"] == (nx, B) and p["blocks"] == nx * B
        # channels: block x owns [x·C, x·C + C) ∩ [0, R), every block some
        assert (nx - 1) * C < R <= nx * C
        owned = np.zeros(nx * C, dtype=np.int64)
        owned[:R] += 1
        assert (owned.reshape(nx, C).sum(1) > 0).all()
        assert (owned[:R] == 1).all()
        # steps: tile k holds [k·steps, min(k·steps + steps, S))
        starts = np.arange(p["tiles"]) * steps
        lens = np.minimum(steps, S - starts)
        assert (lens > 0).all() and lens.sum() == S
        assert p["smem"] <= SMEM_BYTES
        assert p["smem"] >= 128 + stages * p["stage_bytes"]


def test_rglru_plan_fills_the_card_at_the_training_microbatch():
    """At (t6)'s microbatch (B 1, S 4,096, R 4,096) both directions run
    at least 100 blocks on 132 SMs (the previous design ran 32 blocks of
    128 channels), and at (d)'s serving batch at least one block an SM."""
    from repro_torch.kernels.rglru_scan import rglru_plan
    for backward in (False, True):
        t6 = rglru_plan(1, 4096, 4096, H100_SMS, backward)
        assert t6["blocks"] >= 100 and t6["channels"] == 32
        d = rglru_plan(8, 2560, 4096, H100_SMS, backward)
        assert d["blocks"] >= H100_SMS
        # each SM's share of the ring: the blocks it runs at once, all
        # held within the SM's 228 KB
        for p in (t6, d):
            resident = -(-p["blocks"] // H100_SMS)
            assert resident * p["smem"] <= 228 * 1024


def test_rglru_plan_takes_cp_async_where_tma_cannot():
    """TMA needs 16-byte row strides and operands: R % 4 != 0 (R 4,094,
    R 33) or an operand off a 16-byte boundary takes the cp.async path,
    which the kernel takes at any R."""
    from repro_torch.kernels.rglru_scan import rglru_plan
    for backward in (False, True):
        for R in range(1, 4097):
            p = rglru_plan(1, 77, R, H100_SMS, backward)
            assert p["tma"] == (R % 4 == 0)
        assert not rglru_plan(1, 4096, 4096, H100_SMS, backward,
                              aligned=False)["tma"]
    with pytest.raises(ValueError):
        rglru_plan(1, 0, 4096, H100_SMS)
