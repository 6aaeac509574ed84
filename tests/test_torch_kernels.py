"""The port's kernel modules against the JAX reference on the CPU.

Here the wrappers in ``repro_torch.kernels.ops`` take their kernels' plain
PyTorch versions, because the tensors lie on the CPU; the JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_kernels.py`` and
``tests/test_paged_kernel.py`` run them.  All inputs are made with numpy
from a seed and handed to both packages.

Tolerances (fp32 on both sides): 1e-5 absolute on attention outputs of
magnitude ~1; only the order of the fp32 sums differs.  Inactive decode
rows (``pos_q < 0``) must be exact zeros.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    group_tile as ref_group_tile,
    paged_decode_attention as ref_paged_kernel,
    paged_decode_jnp as ref_paged_jnp,
)
from repro.models.attention import (  # noqa: E402
    decode_attention_paged as ref_decode_paged,
    flash_attention_jnp as ref_flash_jnp,
)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Flash attention (prefill)
# ---------------------------------------------------------------------------
FLASH_CASES = {
    # label: (B, S, H, K, hd, causal, window, cap)
    "causal-G2-hd16-S128": (2, 128, 4, 2, 16, True, 0, 0.0),
    "causal-G3-hd64-S128": (1, 128, 6, 2, 64, True, 0, 0.0),
    "window-G2-hd16-S128": (1, 128, 4, 2, 16, True, 32, 0.0),
    "softcap-G3-hd16-S128": (1, 128, 6, 2, 16, True, 0, 20.0),
    "ragged-G2-hd64-S100": (1, 100, 4, 2, 64, True, 0, 0.0),
    "ragged-window-softcap-G3-hd16-S77": (1, 77, 6, 2, 16, True, 20, 15.0),
}


def _flash_inputs(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))


def _folded(x):
    """(B, S, heads, hd) -> (B·heads, S, hd), the kernels' own layout."""
    B, S, n, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * n, S, hd)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_matches_reference_kernel_and_oracles(case):
    B, S, H, K, hd, causal, window, cap = FLASH_CASES[case]
    q, k, v = _flash_inputs(B, S, H, K, hd, seed=len(case))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, logit_cap=cap)
    before = dict(ops.launches)

    port = ops.flash_attention_bshd(_t(q), _t(k), _t(v), **kw).numpy()
    jax_kernel = _np(ref_ops.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    jax_jnp = _np(ref_flash_jnp(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw))
    oracle_kw = dict(group=H // K, scale=hd ** -0.5, causal=causal,
                     window=window, logit_cap=cap)
    port_oracle = ref.attention_ref(_t(_folded(q)), _t(_folded(k)),
                                    _t(_folded(v)), **oracle_kw).numpy()
    jax_oracle = _np(ref_ref.attention_ref(
        jnp.asarray(_folded(q)), jnp.asarray(_folded(k)),
        jnp.asarray(_folded(v)), **oracle_kw))

    np.testing.assert_allclose(port, jax_kernel, atol=ATOL)
    np.testing.assert_allclose(port, jax_jnp, atol=ATOL)
    np.testing.assert_allclose(_folded(port), port_oracle, atol=ATOL)
    np.testing.assert_allclose(port_oracle, jax_oracle, atol=ATOL)
    assert ops.launches == before, "a CPU call must not count as a launch"


@pytest.mark.parametrize("kv_block", [16, 48, 128])
def test_flash_plain_version_is_block_size_free(kv_block):
    """The plain version's kv tiling only reorders fp32 sums."""
    q, k, v = map(_t, _flash_inputs(1, 96, 6, 2, 16, seed=7))
    kw = dict(scale=0.25, causal=True, window=40, logit_cap=10.0)
    a = fa.flash_attention_torch(q, k, v, kv_block=kv_block, **kw)
    b = fa.flash_attention_torch(q, k, v, kv_block=96, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_flash_wrapper_rejects_bad_operands():
    q, k, v = map(_t, _flash_inputs(1, 16, 4, 2, 16, seed=1))
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention_bshd(q[0], k, v, scale=0.25)
    with pytest.raises(ValueError):
        ops.flash_attention_bshd(q, k[:, :8], v[:, :8], scale=0.25)
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.flash_attention_bshd(q, k.double(), v.double(), scale=0.25)
    with pytest.raises(ValueError):                      # H % K != 0
        ops.flash_attention_bshd(q[:, :, :3], k, v, scale=0.25)


# ---------------------------------------------------------------------------
# Paged flash-decode
# ---------------------------------------------------------------------------
def _paged_inputs(G, seed, B=4, K=2, hd=16, ps=8, pps=6):
    """Ragged tables: rows hold 3, 6, 1 and 4 live pages of shuffled
    physical ids with -1 tails; row 3 also has a -1 hole inside its live
    prefix; rows 0 and 1 alias their first page.  Positions: a partial last
    page, the full table, a single token, and an inactive slot."""
    rng = np.random.default_rng(seed)
    P = B * pps
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(P, K, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(P, K, ps, hd)).astype(np.float32)
    perm = rng.permutation(P).astype(np.int32)
    table = np.full((B, pps), -1, np.int32)
    for b, n in enumerate([3, 6, 1, 4]):
        table[b, :n] = perm[b * pps:b * pps + n]
    table[1, 0] = table[0, 0]
    table[3, 1] = -1
    pos = np.array([19, 47, 0, -1], np.int32)
    return q, kp, vp, table, pos


def _with_active_hole(pos):
    """Row 3 active at position 29: its -1 hole at page 1 is live range."""
    pos = pos.copy()
    pos[3] = 29
    return pos


PAGED_CASES = [  # (G, cap, hd): the CUDA kernel takes hd 64, 128, 256, any G
    (2, 0.0, 16), (3, 0.0, 16), (3, 30.0, 16), (4, 0.0, 16), (5, 0.0, 16),
    (8, 0.0, 16), (2, 0.0, 256), (2, 30.0, 256), (16, 0.0, 256),
    (12, 0.0, 16), (12, 30.0, 128), (16, 0.0, 64)]


@pytest.mark.parametrize(
    "G,cap,hd", PAGED_CASES,
    ids=[f"{G}-{cap}" if hd == 16 else f"{G}-{cap}-hd{hd}"
         for G, cap, hd in PAGED_CASES])
def test_paged_decode_matches_reference_kernels(G, cap, hd):
    q, kp, vp, table, pos = _paged_inputs(G, seed=G, hd=hd)
    B, K, _, hd = q.shape
    kw = dict(scale=hd ** -0.5, logit_cap=cap)
    for positions in (pos, _with_active_hole(pos)):
        port = pa.paged_decode_torch(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(positions), **kw).numpy()
        jargs = tuple(map(jnp.asarray, (q, kp, vp, table, positions)))
        grouped = _np(ref_paged_kernel(*jargs, interpret=True, grouped=True,
                                       **kw))
        ungrouped = _np(ref_paged_kernel(*jargs, interpret=True,
                                         grouped=False, **kw))
        scan = _np(ref_paged_jnp(*jargs, **kw))
        oracle = _np(ref_decode_paged(
            jargs[0].reshape(B, 1, K * G, hd), *jargs[1:], **kw)
        ).reshape(B, K, G, hd)
        port_oracle = tattn.decode_attention_paged(
            _t(q).reshape(B, 1, K * G, hd), _t(kp), _t(vp), _t(table),
            _t(positions), **kw).numpy().reshape(B, K, G, hd)
        act = positions >= 0
        for other in (grouped, ungrouped, scan, oracle, port_oracle):
            np.testing.assert_allclose(port[act], other[act], atol=ATOL)
        np.testing.assert_array_equal(port[~act], 0.0)
        np.testing.assert_array_equal(grouped[~act], 0.0)


def test_paged_decode_wrapper_cpu_path_and_checks():
    q, kp, vp, table, pos = map(_t, _paged_inputs(2, seed=11))
    B, K, G, hd = q.shape
    qm = q.reshape(B, 1, K * G, hd)
    before = dict(ops.launches)
    out = ops.paged_decode_bhd(qm, kp, vp, table, pos, scale=0.25)
    plain = pa.paged_decode_torch(q, kp, vp, table, pos, scale=0.25)
    np.testing.assert_array_equal(out.reshape(B, K, G, hd).numpy(),
                                  plain.numpy())
    assert ops.launches == before
    with pytest.raises(ValueError):                      # two new tokens
        ops.paged_decode_bhd(torch.cat([qm, qm], 1), kp, vp, table, pos,
                             scale=0.25)
    with pytest.raises(ValueError):                      # table rows != B
        ops.paged_decode_bhd(qm, kp, vp, table[:2], pos, scale=0.25)
    with pytest.raises(ValueError):                      # pools differ
        ops.paged_decode_bhd(qm, kp, vp[:, :, :4], table, pos, scale=0.25)


def test_group_tile_matches_reference():
    for K in range(1, 17):
        for G in range(1, 11):
            assert pa.group_tile(K, G) == ref_group_tile(K, G), (K, G)


SPLIT_CASES = [  # (B, K, ps, pps)
    (1, 1, 128, 1), (8, 8, 128, 9), (1, 8, 128, 256), (64, 8, 128, 9),
    (3, 2, 16, 5), (8, 8, 16, 80), (2, 1, 8, 6), (128, 8, 128, 64)]


@pytest.mark.parametrize("B,K,ps,pps", SPLIT_CASES)
def test_split_tiles_fills_the_card_within_the_table(B, K, ps, pps):
    """Ranges of 32-key tiles: at least one tile, no more than the table
    holds, no more ranges than WARPS_PER_SM (row, kv head, range) work
    items an SM over a full table ask for, and, unless a range is a single
    tile, at least half as many (ranges are whole tiles)."""
    n_sm = 132
    tiles = pps * -(-ps // pa.TILE_KEYS)
    tps = pa.split_tiles(B, K, ps, pps, n_sm)
    assert 1 <= tps <= tiles
    n_split = -(-tiles // tps)
    want = pa.WARPS_PER_SM * n_sm
    assert B * K * n_split <= max(want, B * K) + B * K
    if tps > 1:
        assert 2 * B * K * n_split >= want
    plan = pa.decode_plan(B, K, 2, 128, ps, pps, 2, n_sm, grouped=True)
    assert plan["tps"] == tps and plan["n_split"] == n_split


PLAN_CASES = [  # (K, G, hd, elt)
    (8, 2, 128, 2), (8, 2, 256, 2), (8, 12, 128, 2), (1, 16, 256, 2),
    (1, 16, 256, 4), (4, 3, 64, 4), (8, 1, 256, 4), (2, 5, 256, 2),
    (1, 64, 128, 2), (16, 1, 64, 2)]


@pytest.mark.parametrize("K,G,hd,elt", PLAN_CASES)
def test_decode_plan_covers_every_row_and_fits_a_block(K, G, hd, elt):
    """Both grids cut the query rows alike (only the head tile, the row
    groups a block and the ring depth differ, none of which changes a
    head's arithmetic); every row group is non-empty and within a warp's
    registers; a block fits the card's warps and shared memory; the
    grouped grid keeps the reference's head tile where it fits."""
    plans = [pa.decode_plan(8, K, G, hd, 128, 9, elt, 132, grouped=g)
             for g in (True, False)]
    for key in ("gt", "n_gg", "tps", "n_split"):
        assert plans[0][key] == plans[1][key]
    for p in plans:
        rows = -(-G // p["n_gg"])
        assert rows <= p["gt"] <= (4 if hd == 256 else 8)
        assert rows * (p["n_gg"] - 1) < G            # no empty row group
        assert K % p["kt"] == 0 and p["n_gg"] % p["ggb"] == 0
        assert p["kt"] * p["ggb"] <= pa.MAX_WARPS
        smem = p["kt"] * p["stages"] * 2 * pa.TILE_KEYS * hd * elt \
            + p["kt"] * p["ggb"] * pa.TILE_KEYS * p["gt"] * 4 \
            + p["kt"] * p["stages"] * 16
        assert p["smem"] == smem <= pa.SMEM_BYTES
    assert plans[1]["kt"] == 1
    kt = pa.group_tile(K, G)
    tile = 2 * pa.TILE_KEYS * hd * elt
    if kt * tile <= pa.SMEM_BYTES // 2:
        assert plans[0]["kt"] == kt


LONG_CASES = [  # (B, K, G, pps, elt, grouped): tables past one tile a range
    (8, 8, 2, 64, 2, True), (8, 8, 2, 64, 2, False), (8, 8, 2, 64, 4, True),
    (8, 8, 2, 64, 4, False), (1, 8, 2, 160, 2, True), (1, 8, 2, 160, 2, False)]


@pytest.mark.parametrize("B,K,G,pps,elt,grouped", LONG_CASES)
def test_decode_plan_walks_long_tables_in_several_tiles(B, K, G, pps, elt,
                                                        grouped):
    """The long-table shapes the card tests and chip_smoke.py's ``long``
    cases hold the kernel to: a range holds several tiles, so a warp walks
    them through its ring and the producer reuses stages (the fp32 grouped
    grid has room for one stage only, the others for two or three); B 1
    has more than 32 ranges, so the merge takes its ranges in rounds."""
    p = pa.decode_plan(B, K, G, 128, 128, pps, elt, 132, grouped)
    assert p["tps"] > 1
    assert p["n_split"] * p["tps"] >= pps * 128 // pa.TILE_KEYS
    assert p["stages"] == (1 if elt == 4 and grouped else min(3, p["tps"]))
    assert p["smem"] <= pa.SMEM_BYTES
    if B == 1:
        assert p["n_split"] > 32
