"""The port's deepseek-v2 slice against the JAX reference on the CPU: the
plain MLA latent decode, the latent page writers, MLA attention in its
three serving modes, the parameters and their conversion, the model's
logits and latent caches, and the serving engine (with granite-moe, the
GQA + MoE config this slice also makes servable).

All inputs are made with numpy from a seed and handed to both packages;
the reference runs with ``Ctx(mesh=None, dtype=float32)`` and its Pallas
MLA kernel in interpret mode.  Both sides compute in fp32 and keep fp32
caches (``cfg.dtype="float32"``).

Tolerances:

* MLA latent decode: 1e-5 absolute on outputs of magnitude ~1 (only the
  order of the fp32 sums differs); inactive rows are exact zeros;
* the latent writers only move values: bit-equal;
* MLA attention, logits and latent caches: 1e-4 absolute, as in
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
from repro.kernels.paged_attention import (  # noqa: E402
    mla_paged_decode_attention as ref_mla_kernel,
    mla_paged_decode_jnp as ref_mla_jnp,
)
from repro.launch import engine as ref_engine  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import count_params as ref_count  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import engine, serve  # noqa: E402
from repro_torch.launch.spec import ServeSpec  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import Model, cast_params, count_params  # noqa: E402

DECODE_ATOL = 1e-5
ATOL = 1e-4
CPU = torch.device("cpu")
ARCH = "deepseek-v2-236b"
LATENT = ("ckv_pages", "krope_pages")


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rctx():
    return RefCtx(mesh=None, dtype=jnp.float32)


def _tctx():
    return Ctx(device=CPU, dtype=torch.float32)


# ---------------------------------------------------------------------------
# The plain MLA latent decode against the Pallas kernel and both oracles
# ---------------------------------------------------------------------------
def _latent_inputs(seed, B=5, H=3, lora=16, rd=8, ps=8, pps=6):
    """Ragged tables over shuffled pages: rows 0 and 1 share their first
    page, row 3 is inactive (pos -1, table all -1), row 4 has a -1 hole
    inside its live range.  The pool's last page is never mapped: it is
    what a -1 entry used as an index would read (torch's last page)."""
    rng = np.random.default_rng(seed)
    P = B * pps + 1
    q = rng.normal(size=(B, H, lora + rd)).astype(np.float32)
    ckv = rng.normal(size=(P, ps, lora)).astype(np.float32)
    krope = rng.normal(size=(P, ps, rd)).astype(np.float32)
    pos = np.array([19, 47, 0, -1, 29], np.int32)[:B]
    perm = rng.permutation(P - 1).astype(np.int32)
    table = np.full((B, pps), -1, np.int32)
    for b, p in enumerate(pos):
        if p >= 0:
            table[b, :p // ps + 1] = perm[b * pps:b * pps + p // ps + 1]
    table[1, 0] = table[0, 0]
    table[4, 1] = -1
    return q, ckv, krope, table, pos


@pytest.mark.parametrize("H,ps,pps", [(3, 8, 6), (16, 8, 6), (4, 16, 3)],
                         ids=["H3-ps8", "H16-ps8", "H4-ps16"])
def test_mla_plain_decode_matches_reference_kernel_and_oracles(H, ps, pps):
    q, ckv, krope, table, pos = _latent_inputs(H + ps, H=H, ps=ps, pps=pps)
    lora = ckv.shape[-1]
    scale = 0.2
    port = pa.mla_paged_decode_torch(_t(q), _t(ckv), _t(krope), _t(table),
                                     _t(pos), scale=scale).numpy()
    jargs = tuple(map(jnp.asarray, (q, ckv, krope, table, pos)))
    kernel = _np(ref_mla_kernel(*jargs, scale=scale, interpret=True))
    scan = _np(ref_mla_jnp(*jargs, scale=scale))
    oracle = _np(ref_attn.mla_decode_attention_paged(
        jargs[0][..., :lora], jargs[0][..., lora:], *jargs[1:], scale=scale))
    port_oracle = port_attn.mla_decode_attention_paged(
        _t(q[..., :lora]), _t(q[..., lora:]), _t(ckv), _t(krope), _t(table),
        _t(pos), scale=scale).numpy()
    act = pos >= 0
    for other in (kernel, scan, oracle, port_oracle):
        np.testing.assert_allclose(port[act], other[act], atol=DECODE_ATOL)
    np.testing.assert_array_equal(port[~act], 0.0)
    np.testing.assert_array_equal(kernel[~act], 0.0)
    # poison the unmapped last page: neither port walk may read it for the
    # -1 entries (the hole of row 4, the inactive row, dead tails)
    ckv[-1] = np.nan
    krope[-1] = np.nan
    again = pa.mla_paged_decode_torch(_t(q), _t(ckv), _t(krope), _t(table),
                                      _t(pos), scale=scale).numpy()
    np.testing.assert_array_equal(again, port)
    again = port_attn.mla_decode_attention_paged(
        _t(q[..., :lora]), _t(q[..., lora:]), _t(ckv), _t(krope), _t(table),
        _t(pos), scale=scale).numpy()
    np.testing.assert_array_equal(again, port_oracle)


def test_mla_decode_wrapper_cpu_path_and_checks():
    q, ckv, krope, table, pos = map(_t, _latent_inputs(7))
    before = dict(ops.launches)
    out = ops.mla_paged_decode_bhd(q, ckv, krope, table, pos, scale=0.2)
    plain = pa.mla_paged_decode_torch(q, ckv, krope, table, pos, scale=0.2)
    assert torch.equal(out, plain)
    assert ops.launches == before
    assert "mla_paged_decode_bhd" in ops.launches
    with pytest.raises(ValueError, match="q width"):
        ops.mla_paged_decode_bhd(q[..., :-1], ckv, krope, table, pos,
                                 scale=0.2)
    with pytest.raises(ValueError, match="table"):
        ops.mla_paged_decode_bhd(q, ckv, krope, table[:2], pos, scale=0.2)
    with pytest.raises(ValueError, match="shapes"):
        ops.mla_paged_decode_bhd(q, ckv, krope[:3], table, pos, scale=0.2)


def _gpc_slots(n, smem):
    """A model of an H100's cluster capacity: 132 SMs in GPCs of 16 and
    18, a cluster within one GPC, one block an SM."""
    return sum(g // n for g in (16,) * 6 + (18,) * 2)


@pytest.mark.parametrize("slots", [None, _gpc_slots], ids=["even", "gpc"])
@pytest.mark.parametrize("B,H,ps,pps,q_elt,kv_elt", [
    (8, 128, 128, 9, 2, 2),        # deepseek-v2 serving, bf16
    (8, 128, 128, 64, 2, 2),       # long tables: rows to 8K keys
    (1, 128, 128, 160, 2, 2),      # one row of 20K keys
    (4, 16, 16, 12, 2, 2),         # pages of 16: a tile a page
    (4, 20, 128, 3, 2, 2),         # a partial head tile
    (64, 128, 128, 9, 2, 2),       # more rows than the card has SMs
    (1, 16, 128, 1, 2, 2),         # one tile in all
    (8, 128, 128, 9, 4, 4),        # fp32
    (8, 128, 128, 9, 4, 2),        # fp32 q over bf16 pools
    (3, 4, 5, 5, 4, 4),            # a page smaller than a tile
])
def test_mla_decode_plan_fills_the_card_within_the_table(B, H, ps, pps,
                                                         q_elt, kv_elt,
                                                         slots):
    n_sm = 132
    plan = pa.mla_decode_plan(B, H, ps, pps, q_elt, kv_elt, n_sm, slots)
    wgmma = q_elt == kv_elt == 2
    assert plan["route"] == ("wgmma" if wgmma else "simt")
    ht, n_ht = plan["ht"], plan["n_ht"]
    assert ht == (pa.MLA_WG_HEADS if wgmma else pa.MLA_SIMT_HEADS)
    assert (n_ht - 1) * ht < H <= n_ht * ht
    assert plan["ntp"] == -(-ps // pa.TILE_KEYS)
    tiles = pps * plan["ntp"]
    n, tpr = plan["n_split"], plan["tpr"]
    # the ranges cover the table, and none starts past it
    assert 1 <= n <= pa.MLA_MAX_CLUSTER
    assert (n - 1) * tpr < tiles <= n * tpr
    # the card is used as well as it can be: no other cluster size has a
    # shorter critical path (waves of clusters x tiles a range), and on a
    # tie none with fewer ranges
    cap = slots or (lambda k, smem: (1 if wgmma else 2) * n_sm // k)

    def cost(k, tpr_k):
        smem = pa._mla_layout(wgmma, ht, tpr_k, k, kv_elt, 512, 64)[3]
        return -(-B * n_ht // cap(k, smem)) * tpr_k
    for k in range(1, min(pa.MLA_MAX_CLUSTER, tiles) + 1):
        tpr_k = -(-tiles // k)
        if -(-tiles // tpr_k) == k and k != n:
            assert cost(k, tpr_k) > cost(n, tpr) or \
                (cost(k, tpr_k) == cost(n, tpr) and k > n)
    # the ring and the shared memory: regions in order, within 227 KB
    assert 1 <= plan["stages"] <= min(pa.MLA_STAGES, tpr)
    offs = plan["offs"]
    assert list(offs) == sorted(offs) and offs[0] > 0
    assert offs[-1] < plan["smem"] <= 227 * 1024
    # the last region, the (m, l) block of the kernel's MlLayout (28 rows
    # of floats), and on the wgmma route the mbarriers after it, fit
    ml_end = offs[-1] if wgmma else plan["smem"]
    assert ml_end - offs[2 if wgmma else 3] >= 4 * ht * 28
    # the merge: the blocks of a cluster split the 512 latent columns in
    # 16-byte pieces, and a block's partial accumulator (fp32 rows padded
    # by 16 bytes) fits where its query tile and ring were
    cols = plan["cols"]
    assert cols % 4 == 0 and (n - 1) * cols < 512 <= n * cols
    assert offs[1 if wgmma else 0] >= 4 * ht * (512 + 4)


# ---------------------------------------------------------------------------
# The bf16 kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634


def _mla_kernel_emulation(q, ckv, krope, table, pos, scale, plan, split=True):
    """The wgmma route of ``csrc/mla_decode.cu`` step by step in torch:
    per range of the plan, per live 32-key tile, S = q·kᵀ of the bf16
    values with fp32 sums, scaled on the fp32 score into log2 units; an
    online softmax with exp2; P split into bf16 hi and lo = bf16(p − hi)
    and P·V as hi·V + lo·V in fp32 (``split=False``: P rounded once);
    then the ranges merged with weights 2^(m_r − M).  Returns q's dtype."""
    B, H, _ = q.shape
    P, ps, lora = ckv.shape
    tk, ntp, tpr = pa.TILE_KEYS, plan["ntp"], plan["tpr"]
    keys = torch.cat([ckv, krope], dim=-1).float()
    qf, sc = q.float(), scale * LOG2E
    neg = torch.tensor(pa.NEG_INF)
    out = torch.zeros(B, H, lora)
    for b in range(B):
        p = int(pos[b])
        if p < 0:
            continue
        page, pps = p // ps, table.shape[1]
        last = pps * ntp - 1 if page >= pps \
            else page * ntp + (p - page * ps) // tk
        parts = []
        for r in range(plan["n_split"]):
            m = torch.full((H,), pa.NEG_INF)
            l = torch.zeros(H)
            acc = torch.zeros(H, lora)
            for tau in range(r * tpr, min((r + 1) * tpr, last + 1)):
                e = int(table[b, tau // ntp])
                if e < 0 or e >= P:
                    continue
                slot = (tau % ntp) * tk
                nv = min(tk, ps - slot, p - ((tau // ntp) * ps + slot) + 1)
                s = (qf[b] @ keys[e, slot:slot + nv].T) * sc
                m_new = torch.maximum(m, s.amax(dim=-1))
                corr = torch.exp2(m - m_new)
                pr = torch.exp2(s - m_new[:, None])
                l = l * corr + pr.sum(dim=-1)
                v = ckv[e, slot:slot + nv].float()
                hi = pr.bfloat16().float()
                pv = hi @ v
                if split:
                    pv = pv + (pr - hi).bfloat16().float() @ v
                acc = acc * corr[:, None] + pv
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        L = torch.zeros(H)
        A = torch.zeros(H, lora)
        for m, l, acc in parts:
            w = torch.where(m == neg, 0.0, torch.exp2(m - M))
            L = L + w * l
            A = A + w[:, None] * acc
        out[b] = A / L.clamp_min(1e-37)[:, None]
    return out.to(q.dtype)


def _bf16_latent(seed, B, H, ps, pps, positions, lora=512, rd=64):
    """The smoke's ragged latent batch in bf16: shuffled pages, rows 0 and
    1 alias their first page, the last row reaching two pages has a -1
    hole, -1 positions are inactive."""
    rng = np.random.default_rng(seed)
    P = B * pps
    bf = lambda *shape: _t(rng.normal(size=shape).astype(np.float32)) \
        .bfloat16()  # noqa: E731
    q, ckv, krope = bf(B, H, lora + rd), bf(P, ps, lora), bf(P, ps, rd)
    perm = rng.permutation(P).astype(np.int32)
    table = np.full((B, pps), -1, np.int32)
    for b, p in enumerate(positions):
        if p >= 0:
            table[b, :p // ps + 1] = perm[b * pps:b * pps + p // ps + 1]
    table[1, 0] = table[0, 0]
    holed = [b for b, p in enumerate(positions) if p >= 2 * ps]
    table[holed[-1], 1] = -1
    return q, ckv, krope, _t(table), _t(np.array(positions, np.int32))


def _within(out, plain, atol, rtol):
    d = (out.float() - plain.float()).abs()
    return bool((d <= atol + rtol * plain.float().abs()).all())


@pytest.mark.parametrize("B,H,ps,pps,positions", [
    (8, 128, 128, 9, [1055, 700, 1023, -1, 512, 127, 128, 900]),
    (4, 128, 16, 12, [150, 31, -1, 47]),
    (3, 20, 128, 3, [300, 5, 200]),
], ids=["serving", "H128-ps16", "H20"])
def test_mla_kernel_bf16_arithmetic_matches_the_plain_version(B, H, ps, pps,
                                                              positions):
    """The wgmma route's arithmetic (bf16 scores with fp32 sums, P split
    hi + lo, the ranges merged) stays within the card's bf16 tolerance of
    the fp32 plain version, 1e-4 + 2^-7·|plain|, at the smoke's positions;
    P rounded once to bf16 instead does not, which is why the kernel runs
    the second (lo) product."""
    q, ckv, krope, table, pos = _bf16_latent(B + H + ps, B, H, ps, pps,
                                             positions)
    scale = (128 + 64) ** -0.5
    plan = pa.mla_decode_plan(B, H, ps, pps, 2, 2, 132, _gpc_slots)
    plain = pa.mla_paged_decode_torch(q, ckv, krope, table, pos, scale=scale)
    emu = _mla_kernel_emulation(q, ckv, krope, table, pos, scale, plan)
    assert emu.dtype == torch.bfloat16 and torch.isfinite(emu).all()
    assert _within(emu, plain, 1e-4, 2 ** -7)
    assert torch.equal(emu[pos < 0], torch.zeros_like(emu[pos < 0]))
    if B == 8:
        once = _mla_kernel_emulation(q, ckv, krope, table, pos, scale, plan,
                                     split=False)
        assert not _within(once, plain, 1e-4, 2 ** -7)


# ---------------------------------------------------------------------------
# The latent writers
# ---------------------------------------------------------------------------
def _pools(rng, P, ps, lora, rd):
    return (rng.normal(size=(P, ps, lora)).astype(np.float32),
            rng.normal(size=(P, ps, rd)).astype(np.float32))


def test_latent_prefill_writer_matches_reference():
    """Ragged prefill from position 0 (a length-0 row writes nothing) and
    a chunked one at per-row starts: the pools equal the reference's, bit
    for bit; unallocated entries and tokens past a row's length write
    nothing."""
    rng = np.random.default_rng(2)
    B, S0, ps, pps, lora, rd = 3, 11, 4, 6, 16, 8
    P = B * pps
    cp, rp = _pools(rng, P, ps, lora, rd)
    table = rng.permutation(P).astype(np.int32).reshape(B, pps)
    table[2, 4:] = -1
    ckv = rng.normal(size=(B, S0, lora)).astype(np.float32)
    kr = rng.normal(size=(B, S0, rd)).astype(np.float32)
    for lengths, starts in (([11, 0, 6], [0, 0, 0]), ([5, 11, 9], [7, 2, 9])):
        lengths, starts = (np.array(a, np.int32) for a in (lengths, starts))
        pos = starts[:, None] + np.arange(S0, dtype=np.int32)[None, :]
        rc = {"ckv_pages": jnp.asarray(cp), "krope_pages": jnp.asarray(rp),
              "page_table": jnp.asarray(table)}
        want = ref_attn._write_prefill_latent_paged(
            rc, jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(lengths),
            jnp.asarray(pos))
        tc = {"ckv_pages": _t(cp.copy()), "krope_pages": _t(rp.copy()),
              "page_table": _t(table)}
        port_attn._write_prefill_latent_paged(tc, _t(ckv), _t(kr),
                                              _t(lengths), _t(pos))
        for name in LATENT:
            np.testing.assert_array_equal(tc[name].numpy(), _np(want[name]),
                                          err_msg=name)


def test_latent_decode_writer_matches_reference():
    """One token per row: an inactive row (pos -1) and a row whose page is
    unallocated write nothing; three steps, bit-equal to the reference."""
    rng = np.random.default_rng(4)
    B, ps, pps, lora, rd = 4, 4, 5, 16, 8
    P = B * pps
    cp, rp = _pools(rng, P, ps, lora, rd)
    table = rng.permutation(P).astype(np.int32).reshape(B, pps)
    table[2, 3:] = -1
    pos = np.array([5, -1, 12, 0], np.int32)
    tc = {"ckv_pages": _t(cp.copy()), "krope_pages": _t(rp.copy()),
          "page_table": _t(table)}
    rc = {"ckv_pages": jnp.asarray(cp), "krope_pages": jnp.asarray(rp),
          "page_table": jnp.asarray(table)}
    for _ in range(3):
        ckv = rng.normal(size=(B, lora)).astype(np.float32)
        kr = rng.normal(size=(B, rd)).astype(np.float32)
        rc = ref_attn._update_decode_latent_paged(
            rc, jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(pos))
        port_attn._update_decode_latent_paged(tc, _t(ckv), _t(kr), _t(pos))
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    for name in LATENT:
        np.testing.assert_array_equal(tc[name].numpy(), _np(rc[name]),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# Config, parameters and conversion
# ---------------------------------------------------------------------------
def _configs(arch=ARCH, **narrow):
    over = dict(cache_layout="paged", dtype="float32", **narrow)
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


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


@pytest.mark.parametrize("arch", [ARCH, "granite-moe-1b-a400m"])
def test_moe_configs_are_faithful_copies(arch):
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    for a, b in ((rcfg, tcfg), (rcfg.reduced(), tcfg.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.layer_kinds() == b.layer_kinds()
        assert a.padded_vocab == b.padded_vocab


@pytest.mark.parametrize("arch,layers", [
    (ARCH, None), (ARCH, 3), (ARCH, "reduced"),
    ("granite-moe-1b-a400m", None), ("granite-moe-1b-a400m", "reduced")])
def test_moe_count_params_matches_reference(arch, layers):
    """Shapes only (the port builds on the meta device): the full 60-layer
    deepseek-v2, its 3-layer cut (the dense layer and two MoE layers of
    160 experts) and .reduced(); granite-moe full and reduced."""
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    if layers == "reduced":
        rcfg, tcfg = rcfg.reduced(), tcfg.reduced()
    elif layers:
        rcfg, tcfg = (dataclasses.replace(c, num_layers=layers)
                      for c in (rcfg, tcfg))
    for embed in (False, True):
        assert count_params(tcfg, include_embed=embed) == \
            ref_count(rcfg, include_embed=embed)
    if arch == ARCH and layers is None:
        assert count_params(tcfg) == 234_692_858_880
    if arch == ARCH and layers == 3:
        assert count_params(tcfg) == 8_282_219_520
        assert count_params(tcfg, include_embed=True) == 9_330_795_520


@pytest.mark.parametrize("over", [{}, dict(num_layers=5)],
                         ids=["prefix-and-groups", "prefix-and-four-groups"])
def test_converted_reference_tree_matches_the_state_dict(over):
    """``params_from_jax`` puts the reference's ``prefix`` (the dense first
    layer) at block 0 and its stacked ``groups`` (MoE layers) after it:
    exactly the port's state-dict keys and shapes, every value on its
    layer."""
    rcfg, tcfg = (dataclasses.replace(c.reduced(), **over)
                  for c in (ref_get_config(ARCH), get_config(ARCH)))
    rtree = jax.device_get(ref_init_params(rcfg, jax.random.key(0)))
    tree = params_from_jax(rtree, tcfg)
    want = Model(tcfg, device="meta").state_dict()
    assert sorted(tree) == sorted(want)
    assert all(tuple(tree[k].shape) == tuple(want[k].shape) for k in want)
    assert "blocks.0.ffn.wg" in tree and "blocks.0.moe.router" not in tree
    groups = rtree["decoder"]["groups"]["0"]
    n = tcfg.num_layers - 1
    for g in range(n):
        assert f"blocks.{g + 1}.ffn.wg" not in tree
        np.testing.assert_array_equal(
            tree[f"blocks.{g + 1}.moe.we_g"].numpy(),
            np.asarray(groups["moe"]["we_g"][g]))
        np.testing.assert_array_equal(
            tree[f"blocks.{g + 1}.attn.kv_b"].numpy(),
            np.asarray(groups["attn"]["kv_b"][g]))
    np.testing.assert_array_equal(
        tree["blocks.0.attn.q_b"].numpy(),
        np.asarray(rtree["decoder"]["prefix"]["0"]["attn"]["q_b"]))


def test_deepseek_init_follows_the_reference_recipes():
    """Router at std 0.02, norm gains at one, the dense first layer and MoE
    layers with shared experts after it, MLA leaves instead of q/k/v."""
    cfg = get_config(ARCH).reduced()
    model = port_model.build_model(cfg, device="cpu", seed=0)
    router = model.blocks[1].moe.router
    assert 0.015 < router.std() < 0.025
    assert torch.equal(model.blocks[0].attn.kv_norm,
                       torch.ones_like(model.blocks[0].attn.kv_norm))
    assert hasattr(model.blocks[0], "ffn") and not hasattr(model.blocks[0],
                                                           "moe")
    assert all(hasattr(b, "moe") and hasattr(b.moe, "ws_d")
               for b in model.blocks[1:])
    assert not hasattr(model.blocks[0].attn, "k")


# ---------------------------------------------------------------------------
# MLA attention, one layer, in its three modes
# ---------------------------------------------------------------------------
def _layer_caches(rng, cfg, B, table):
    P = int(table.max()) + 1
    cp, rp = _pools(rng, P, cfg.page_size, cfg.kv_lora_rank,
                    cfg.qk_rope_head_dim)
    rc = {"ckv_pages": jnp.asarray(cp), "krope_pages": jnp.asarray(rp),
          "page_table": jnp.asarray(table)}
    tc = {"ckv_pages": _t(cp.copy()), "krope_pages": _t(rp.copy()),
          "page_table": _t(table)}
    return rc, tc


def _assert_same_latents(tc, rc):
    for name in LATENT:
        np.testing.assert_allclose(tc[name].numpy(), _np(rc[name]),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("budget", [port_attn.MLA_SCORE_BUDGET, 1],
                         ids=["all-heads-a-chunk", "one-head-a-chunk"])
def test_mla_attention_matches_reference_in_every_mode(pair, monkeypatch,
                                                      budget):
    """Fresh-latent ragged prefill (a length-0 row), then a chunked prefix
    prefill at per-row starts (2-D positions, reading the pool), then
    three paged decode steps with an inactive row: outputs and latent
    pools agree with the reference's ``mla_attention`` at each stage.
    With a budget of one element, every head is its own chunk."""
    monkeypatch.setattr(port_attn, "MLA_SCORE_BUDGET", budget)
    rcfg, tcfg, rparams, tparams = pair
    rp = ref_model.cast_params(rparams, jnp.float32)["decoder"]["prefix"][
        "0"]["attn"]
    tp = tparams["blocks"][0]["attn"]
    rng = np.random.default_rng(8)
    B, S, D, ps = 3, 12, tcfg.d_model, tcfg.page_size
    pps = 4
    table = rng.permutation(B * pps).astype(np.int32).reshape(B, pps)
    rc, tc = _layer_caches(rng, tcfg, B, table)

    def both(x, mode, pos, lengths=None):
        nonlocal rc
        r_out, rc = ref_attn.mla_attention(
            rcfg, rp, jnp.asarray(x), _rctx(), mode=mode, cache=rc,
            pos=jnp.asarray(pos),
            lengths=None if lengths is None else jnp.asarray(lengths))
        t_out, _ = port_attn.mla_attention(
            tcfg, tp, _t(x), mode=mode, cache=tc, pos=_t(pos),
            lengths=None if lengths is None else _t(lengths))
        return _np(r_out), t_out.numpy()

    x = rng.normal(size=(B, S, D)).astype(np.float32)
    lengths = np.array([12, 0, 7], np.int32)
    r_out, t_out = both(x, "full", np.arange(S, dtype=np.int32), lengths)
    np.testing.assert_allclose(t_out, r_out, atol=ATOL)
    _assert_same_latents(tc, rc)

    S0 = 9
    starts = np.array([12, 0, 7], np.int32)
    lengths = np.array([4, 9, 0], np.int32)
    pos2 = starts[:, None] + np.arange(S0, dtype=np.int32)[None, :]
    x = rng.normal(size=(B, S0, D)).astype(np.float32)
    r_out, t_out = both(x, "full", pos2, lengths)
    live = lengths > 0
    np.testing.assert_allclose(t_out[live], r_out[live], atol=ATOL)
    np.testing.assert_array_equal(t_out[~live], 0.0)
    _assert_same_latents(tc, rc)

    pos = np.array([16, 9, -1], np.int32)
    for _ in range(3):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        r_out, t_out = both(x, "decode", pos)
        act = pos >= 0
        np.testing.assert_allclose(t_out[act], r_out[act], atol=ATOL)
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    _assert_same_latents(tc, rc)


def test_mla_attention_needs_the_paged_latent_cache(pair):
    """Decode reads the paged latent cache (``mode="full"`` without a
    cache is train mode: ``tests/test_torch_mla_train.py``)."""
    _, tcfg, _, tparams = pair
    x = torch.zeros(1, 1, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="paged latent cache"):
        port_attn.mla_attention(tcfg, tparams["blocks"][0]["attn"], x,
                                mode="decode", cache=None,
                                pos=torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The model: logits and the latent cache
# ---------------------------------------------------------------------------
def _ref_latents(cfg, cache, name):
    """(L, P, ps, d) pool of every layer: the unrolled prefix, then the
    stacked groups."""
    out = [_np(cache["prefix"][str(i)]["attn"][name])[None]
           for i in range(cfg.first_k_dense)]
    out.append(_np(cache["groups"]["0"]["attn"][name]))
    return np.concatenate(out)


def _assert_same_cache(cfg, tc, rc):
    for name in LATENT:
        port = np.stack([t.numpy() for t in tc[name]])
        np.testing.assert_allclose(port, _ref_latents(cfg, rc, name),
                                   atol=ATOL, err_msg=name)


def test_deepseek_cache_layout():
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              cache_layout="paged")
    cache = port_model.init_cache(cfg, 2, 20, device=CPU)
    assert sorted(cache) == ["ckv_pages", "krope_pages", "page_table"]
    assert len(cache["ckv_pages"]) == len(cache["krope_pages"]) == 3
    assert all(tuple(t.shape) == (6, 8, 16) and t.dtype == torch.bfloat16
               for t in cache["ckv_pages"])
    assert all(tuple(t.shape) == (6, 8, 8) for t in cache["krope_pages"])
    assert port_model.layer_leaves(cfg, "global") == LATENT


def test_forward_prefill_chunked_decode_match_reference(pair):
    """A ragged prefill (a length-0 row), a chunked prefill at per-row
    starts, and four decode steps with an idle row: logits and every
    layer's latent pools agree with the reference at each stage."""
    rcfg, tcfg, rparams, tparams = pair
    B, S0, ps = 3, 14, tcfg.page_size
    max_len = 40
    pps = -(-max_len // ps)
    table = np.random.default_rng(3).permutation(B * pps).astype(
        np.int32).reshape(B, pps)
    rc = ref_model.init_cache(rcfg, B, max_len, layout="paged",
                              page_budget=B * pps, paged_tables="empty")
    rc = ref_engine._set_page_tables(rc, table)
    tc = port_model.init_cache(tcfg, B, max_len, page_budget=B * pps,
                               device=CPU)
    tc["page_table"].copy_(_t(table))
    rng = np.random.default_rng(12)

    def both(tokens, **kw):
        nonlocal rc, tc
        rkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: _t(v) for k, v in kw.items()}
        mode = "decode" if "pos" in kw else "prefill"
        rl, rc, _ = ref_model.forward(rcfg, rparams,
                                      {"tokens": jnp.asarray(tokens)},
                                      _rctx(), mode=mode, cache=rc, **rkw)
        tl, tc = port_model.forward(tcfg, tparams,
                                    {"tokens": _t(tokens).long()}, _tctx(),
                                    mode=mode, cache=tc, **tkw)
        return _np(rl), tl.numpy()

    tokens = rng.integers(0, tcfg.vocab_size, (B, S0)).astype(np.int32)
    lengths = np.array([14, 0, 9], np.int32)
    rl, tl = both(tokens, lengths=lengths)
    live = lengths > 0
    np.testing.assert_allclose(tl[live], rl[live], atol=ATOL)
    _assert_same_cache(tcfg, tc, rc)

    tokens = rng.integers(0, tcfg.vocab_size, (B, 10)).astype(np.int32)
    lengths = np.array([6, 10, 0], np.int32)
    starts = np.array([14, 0, 9], np.int32)
    rl, tl = both(tokens, lengths=lengths, starts=starts)
    live = lengths > 0
    np.testing.assert_allclose(tl[live], rl[live], atol=ATOL)
    _assert_same_cache(tcfg, tc, rc)

    pos = np.array([20, 10, -1], np.int32)
    tok = tl[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(4):
        rl, tl = both(tok, pos=pos)
        act = pos >= 0
        np.testing.assert_allclose(tl[act], rl[act], atol=ATOL)
        tok = tl[:, -1].argmax(-1).astype(np.int32)[:, None]
        pos = np.where(pos >= 0, pos + 1, pos).astype(np.int32)
    _assert_same_cache(tcfg, tc, rc)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
ENGINE_CASES = {
    # (arch, ServeSpec fields); a small page budget with overcommit forces
    # evictions, a shared prefix copy-on-write of partly shared pages
    "prefix-cache": (ARCH, dict(batch=3, prompt_len=20, gen=6, requests=7,
                                prefix_cache=True, shared_prefix_frac=0.5)),
    "no-prefix-cache": (ARCH, dict(batch=3, prompt_len=20, gen=6,
                                   requests=7, prefix_cache=False)),
    "evict-prefix-cache": (ARCH, dict(batch=3, prompt_len=20, gen=6,
                                      requests=7, prefix_cache=True,
                                      shared_prefix_frac=0.4, page_budget=8,
                                      overcommit=2.0)),
    "granite-moe": ("granite-moe-1b-a400m",
                    dict(batch=3, prompt_len=20, gen=6, requests=7,
                         prefix_cache=True, shared_prefix_frac=0.5)),
}
HOST_STATE = ("host_table", "free_lists", "refcount", "page_meta",
              "prefix_index", "reserved", "toks", "pos", "responses",
              "journal", "stats")
_ENGINE_WEIGHTS = {}


def _engine_weights(arch):
    if arch not in _ENGINE_WEIGHTS:
        rcfg, tcfg = _configs(arch)
        _ENGINE_WEIGHTS[arch] = (rcfg, tcfg, *_weights(rcfg, tcfg, seed=1))
    return _ENGINE_WEIGHTS[arch]


def _assert_same_host_state(port_snap, ref_snap):
    for key in HOST_STATE:
        a, b = port_snap[key], ref_snap[key]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_moe_engine_token_streams_match_reference(case):
    arch, spec = ENGINE_CASES[case]
    rcfg, tcfg, rparams, model = _engine_weights(arch)
    ref = ref_engine.ServingEngine(rcfg, _rctx(), rparams,
                                   RefServeSpec(**spec))
    port = engine.ServingEngine(tcfg, model, ServeSpec(**spec), device=CPU,
                                dtype=torch.float32)
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
        _assert_same_host_state(port.snapshot(), ref.snapshot())
    assert ref.idle
    assert port.responses == ref.responses
    assert sorted(port.responses) == [r.req for r in requests]
    for r in requests:
        assert len(port.responses[r.req]) == r.gen_len
    if case.startswith("evict"):
        assert port.evictions > 0
    if spec["prefix_cache"]:
        assert port.prefix_hits > 0
    if spec.get("shared_prefix_frac") == 0.5:       # a partly shared page
        assert port.cow_copies > 0
    if tcfg.use_mla:
        _assert_same_cache(tcfg, port.cache, ref.cache)


def test_deepseek_snapshot_restore_continues_byte_identically():
    _, tcfg, _, model = _engine_weights(ARCH)
    spec = ServeSpec(**ENGINE_CASES["evict-prefix-cache"][1])
    requests = engine.synthesize_requests(tcfg, spec, seed=5)
    run = engine.ServingEngine(tcfg, model, spec, device=CPU,
                               dtype=torch.float32)
    for r in requests:
        run.submit(r)
    run.admit()
    run.step()
    run.step()
    snap = run.snapshot()
    assert sorted(snap["cache"]) == ["ckv_pages", "krope_pages",
                                     "page_table"]
    run.run()

    fresh = engine.ServingEngine(tcfg, model, spec, device=CPU,
                                 dtype=torch.float32)
    fresh.restore(snap)
    again = fresh.snapshot()
    _assert_same_host_state(again, snap)
    for name in LATENT:
        for a, b in zip(again["cache"][name], snap["cache"][name],
                        strict=True):
            assert torch.equal(a, b), name
    # the snapshot is a copy: the live engine's later writes did not reach it
    assert not all(torch.equal(a, b) for a, b in
                   zip(snap["cache"]["ckv_pages"], run.cache["ckv_pages"]))
    fresh.run()
    assert fresh.responses == run.responses
    assert fresh.journal == run.journal
    for name in LATENT:
        for a, b in zip(fresh.cache[name], run.cache[name], strict=True):
            assert torch.equal(a, b), name


def test_copy_on_write_copies_the_latent_pools():
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              cache_layout="paged", dtype="float32")
    cache = port_model.init_cache(cfg, 2, 16, device=CPU)
    for name in LATENT:
        for pool in cache[name]:
            pool.copy_(torch.randn(pool.shape))
    before = {name: [p.clone() for p in cache[name]] for name in LATENT}
    engine._copy_pool_pages(cache, [(1, 3), (0, 2)])
    for name in LATENT:
        for old, new in zip(before[name], cache[name]):
            assert torch.equal(new[3], old[1]) and torch.equal(new[2], old[0])
            assert torch.equal(new[[0, 1]], old[[0, 1]])


def test_a_prefill_row_past_one_moe_group_is_refused_on_both_sides():
    """A prompt of 1,030 tokens pads (page 8) to a 1,032-token prefill row:
    the reference's MoE asserts S % 1024 == 0 and fails in the round; the
    port refuses the engine up front and says why."""
    rcfg, tcfg, rparams, model = _engine_weights(ARCH)
    spec = dict(batch=1, prompt_len=1030, gen=2, requests=1,
                prefix_cache=False)
    ref = ref_engine.ServingEngine(rcfg, _rctx(), rparams,
                                   RefServeSpec(**spec))
    ref.submit(ref_engine.Request(req=0, tokens=np.arange(1030) % 97,
                                  gen_len=2))
    with pytest.raises(AssertionError, match="not divisible by group size"):
        ref.admit()
    with pytest.raises(ValueError, match="whole number of MoE dispatch"):
        engine.ServingEngine(tcfg, model, ServeSpec(**spec), device=CPU,
                             dtype=torch.float32)
    # a row of 1,024 tokens is one group on both sides
    engine.ServingEngine(tcfg, model, ServeSpec(**dict(spec,
                                                       prompt_len=1024)),
                         device=CPU, dtype=torch.float32)


def test_deepseek_entry_points_need_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              cache_layout="paged")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model.build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model.init_cache(cfg, 2, 16)
    model = port_model.build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServingEngine(cfg, model, ServeSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--reduced", "--layers", "2"])


def test_serve_cli_serves_deepseek_on_cpu(capsys):
    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--continuous",
                     "--batch", "3", "--prompt-len", "20", "--gen", "5",
                     "--requests", "5", "--shared-prefix", "0.5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=deepseek-v2-236b-reduced" in out and "completed 5/5" in out
    assert "prefix cache:" in out
    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--continuous",
                     "--layers", "2", "--prompt-len", "12", "--gen", "3",
                     "--requests", "2", "--no-prefix-cache"])
    assert rc == 0
    assert "depth cut: deepseek-v2-236b-reduced 3 -> 2 layers" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit, match="has 3 layers"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--continuous", "--layers", "4"])
