"""The port's layers, GQA block and paged-cache writers against the JAX
reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
writers only move fp32 values, so their pools must be bit-identical to the
reference's, including the rows the reference drops (``mode="drop"``:
inactive slots, unallocated entries, length-0 rows) and the reads it fills
with zeros (``mode="fill"`` on ``-1`` entries).  Arithmetic is held to
1e-5 absolute in fp32 (summation order), and bf16 results to one bf16 unit
in the last place (2**-7 relative): both packages round the same fp32
value, but an fp32 difference of one unit can still cross a bf16 rounding
boundary.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ATOL = 1e-5
BF16_RTOL = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    rng = _rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    pos1 = np.arange(9, dtype=np.int32)
    pos2 = (np.array([[3], [40]], np.int32) + pos1[None, :]).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    tol = dict(atol=ATOL) if dtype == "float32" else \
        dict(rtol=BF16_RTOL, atol=ATOL)
    np.testing.assert_allclose(
        layers.rms_norm(tx, _t(g), 1e-6).float().numpy(),
        _np(ref_layers.rms_norm(jx, jnp.asarray(g), 1e-6)), **tol)
    for pos in (pos1, pos2):
        np.testing.assert_allclose(
            layers.apply_rope(tx, _t(pos), 1e6).float().numpy(),
            _np(ref_layers.apply_rope(jx, jnp.asarray(pos), 1e6)), **tol)
        assert layers.apply_rope(tx, _t(pos), 1e6).dtype == tx.dtype


def test_ffn_activation_softcap_match_reference():
    rng = _rng(1)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    p = {n: rng.normal(size=s).astype(np.float32) * 0.3
         for n, s in (("wg", (8, 12)), ("wu", (8, 12)), ("wd", (12, 8)))}
    ctx = ref_layers.Ctx(mesh=None, dtype=jnp.float32)
    for act in ("silu", "gelu_tanh"):
        np.testing.assert_allclose(
            layers.dense_ffn({k: _t(v) for k, v in p.items()}, _t(x),
                             act).numpy(),
            _np(ref_layers.dense_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x), act, ctx)), atol=ATOL)
    s = rng.normal(size=(3, 7)).astype(np.float32) * 40
    np.testing.assert_allclose(layers.softcap(_t(s), 30.0).numpy(),
                               _np(ref_layers.softcap(jnp.asarray(s), 30.0)),
                               atol=ATOL)
    ts = _t(s)
    assert layers.softcap(ts, 0.0) is ts


# ---------------------------------------------------------------------------
# paged-cache writers and the chunked-prefill walk
# ---------------------------------------------------------------------------
def _pool_case(seed, B=4, K=2, hd=8, ps=4, pps=5):
    """Random pools (so untouched pages show), a table with -1 tails and a
    -1 entry inside row 1's range."""
    rng = _rng(seed)
    P = B * pps
    kp = rng.normal(size=(P, K, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(P, K, ps, hd)).astype(np.float32)
    perm = rng.permutation(P).astype(np.int32)
    table = np.full((B, pps), -1, np.int32)
    for b, n in enumerate([5, 4, 2, 3]):
        table[b, :n] = perm[b * pps:b * pps + n]
    table[1, 2] = -1
    return rng, kp, vp, table


def _caches(kp, vp, table):
    ref = {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp),
           "page_table": jnp.asarray(table)}
    port = {"k_pages": _t(kp), "v_pages": _t(vp), "page_table": _t(table)}
    return ref, port


def _same_pools(port, ref):
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(port[name].numpy(), _np(ref[name]))


@pytest.mark.parametrize("ragged", [False, True])
def test_write_prefill_paged_matches_reference(ragged):
    rng, kp, vp, table = _pool_case(2)
    B, S0 = 4, 18                      # 5 pages, the last one partial
    k = rng.normal(size=(B, S0, 2, 8)).astype(np.float32)
    v = rng.normal(size=(B, S0, 2, 8)).astype(np.float32)
    lengths = np.array([18, 13, 0, 5], np.int32) if ragged else None
    rc, tc = _caches(kp, vp, table)
    rc = ref_attn._write_prefill_paged(
        rc, jnp.asarray(k), jnp.asarray(v),
        lengths=None if lengths is None else jnp.asarray(lengths))
    out = tattn._write_prefill_paged(
        tc, _t(k), _t(v), None if lengths is None else _t(lengths))
    assert out["k_pages"] is tc["k_pages"]       # updated in place
    _same_pools(tc, rc)


def test_write_prefill_paged_offset_matches_reference():
    rng, kp, vp, table = _pool_case(3)
    B, S0 = 4, 7
    k = rng.normal(size=(B, S0, 2, 8)).astype(np.float32)
    v = rng.normal(size=(B, S0, 2, 8)).astype(np.float32)
    starts = np.array([9, 2, 0, 6], np.int32)
    lengths = np.array([7, 7, 0, 5], np.int32)   # row 1 crosses its hole
    pos = starts[:, None] + np.arange(S0, dtype=np.int32)[None, :]
    rc, tc = _caches(kp, vp, table)
    rc = ref_attn._write_prefill_paged_offset(
        rc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(pos))
    tattn._write_prefill_paged_offset(tc, _t(k), _t(v), _t(lengths), _t(pos))
    _same_pools(tc, rc)


def test_update_decode_kv_paged_drops_inactive_and_unallocated():
    rng, kp, vp, table = _pool_case(4)
    k = rng.normal(size=(4, 1, 2, 8)).astype(np.float32)
    v = rng.normal(size=(4, 1, 2, 8)).astype(np.float32)
    # row 1 writes into its -1 hole (page 2), row 2 is inactive
    pos = np.array([17, 9, -1, 11], np.int32)
    rc, tc = _caches(kp, vp, table)
    rc = ref_attn._update_decode_kv_paged(rc, jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(pos))
    tattn._update_decode_kv_paged(tc, _t(k), _t(v), _t(pos))
    _same_pools(tc, rc)
    changed = (tc["k_pages"].numpy() != kp).any(axis=(1, 2, 3))
    assert changed.sum() == 2                    # rows 0 and 3 only


def test_prefill_attention_paged_fills_holes_with_zeros():
    """The chunked walk over a table with -1 entries: a -1 must read as an
    unallocated page, never as the pool's last page (torch's -1 index)."""
    rng, kp, vp, table = _pool_case(5)
    last = kp.shape[0] - 1               # what a -1 index would read
    free = sorted(set(range(last)) - set(table.ravel().tolist()))
    table[table == last] = free[0]
    B, S0, H, hd = 4, 6, 4, 8
    q = rng.normal(size=(B, S0, H, hd)).astype(np.float32)
    starts = np.array([10, 1, 0, 4], np.int32)
    lengths = np.array([6, 6, 0, 3], np.int32)
    pos = starts[:, None] + np.arange(S0, dtype=np.int32)[None, :]
    kw = dict(scale=hd ** -0.5, logit_cap=0.0)
    want = _np(ref_attn.prefill_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(lengths), **kw))
    got = tattn.prefill_attention_paged(_t(q), _t(kp), _t(vp), _t(table),
                                        _t(pos), _t(lengths), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[2], 0.0)
    # the -1 entries of row 1 must not read the pool's last page
    kp2 = kp.copy()
    kp2[last] += 100.0
    got2 = tattn.prefill_attention_paged(_t(q), _t(kp2), _t(vp), _t(table),
                                         _t(pos), _t(lengths), **kw).numpy()
    np.testing.assert_array_equal(got2, got)


# ---------------------------------------------------------------------------
# the GQA block with qkv biases and qk-norm
# ---------------------------------------------------------------------------
def test_gqa_attention_block_matches_reference():
    over = dict(cache_layout="paged", dtype="float32", qkv_bias=True)
    rcfg = dataclasses.replace(ref_get_config("qwen3-0.6b").reduced(), **over)
    tcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), **over)
    rp = jax.tree.map(lambda a: a[0], ref_init_params(
        rcfg, jax.random.key(3))["decoder"]["groups"]["0"]["attn"])
    rng = _rng(6)
    rp = {n: jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.2)
          if n in ("qb", "kb", "vb", "q_norm", "k_norm") else a
          for n, a in rp.items()}
    tp = {n: _t(_np(a)) for n, a in rp.items()}
    B, S0, ps = 3, 8, rcfg.page_size
    table = np.arange(B * 3, dtype=np.int32).reshape(B, 3)
    kp = np.zeros((B * 3, rcfg.num_kv_heads, ps, rcfg.head_dim), np.float32)
    rc, tc = _caches(kp, kp.copy(), table)
    x = rng.normal(size=(B, S0, rcfg.d_model)).astype(np.float32)
    lengths = np.array([8, 5, 0], np.int32)
    rctx = ref_layers.Ctx(mesh=None, dtype=jnp.float32)
    ry, rc = ref_attn.gqa_attention(
        rcfg, rp, jnp.asarray(x), rctx, kind="global", mode="full", cache=rc,
        pos=jnp.arange(S0, dtype=jnp.int32), lengths=jnp.asarray(lengths))
    ty, tc = tattn.gqa_attention(tcfg, tp, _t(x), mode="full", cache=tc,
                                 pos=torch.arange(S0, dtype=torch.int32),
                                 lengths=_t(lengths))
    live = lengths > 0
    np.testing.assert_allclose(ty.numpy()[live], _np(ry)[live], atol=ATOL)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc[name].numpy(), _np(rc[name]), atol=ATOL)

    pos = np.array([8, 5, -1], np.int32)
    xd = rng.normal(size=(B, 1, rcfg.d_model)).astype(np.float32)
    ry, rc = ref_attn.gqa_attention(rcfg, rp, jnp.asarray(xd), rctx,
                                    kind="global", mode="decode", cache=rc,
                                    pos=jnp.asarray(pos))
    ty, tc = tattn.gqa_attention(tcfg, tp, _t(xd), mode="decode", cache=tc,
                                 pos=_t(pos))
    act = pos >= 0
    np.testing.assert_allclose(ty.numpy()[act], _np(ry)[act], atol=ATOL)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc[name].numpy(), _np(rc[name]), atol=ATOL)
