"""The port's MLA training path (deepseek-v2-236b) against the JAX reference
on the CPU.

The reference trains MLA by expanding the latent into per-head keys and
values (q and k at nope + rd with the shared rope key broadcast over the
heads, v at vd) and differentiating ``flash_attention_jnp`` with
``jax.grad``.  The port runs the same through ``ops.flash_attention_bshd``
(the plain versions here; the flash kernels at qk 192 / v 128 on the
card, ``tests/test_torch_cuda.py``).  Both packages get the same numpy
inputs from a seed: the reference's own weights and train states
(converted by tree path, ``repro_torch.convert``) and batches (ROADMAP
D10).  The reference runs with ``Ctx(mesh=None, dtype=float32)``.  The
reduced config has qk 24 (16 nope + 8 rope) over v 16, so unequal head
dims run everywhere below.

Tolerances (fp32, sums in another order than XLA's):
* the plain flash forward within 1e-5 of the largest |output|, each
  gradient within 1e-4 of its largest magnitude plus 1e-5 (at S 1, dq and
  dk are 0 but for fp32 rounding: dP - D cancels); ``mla_attention``'s
  output and gradients within 1e-4 of their largest magnitude;
* the reduced model's loss, ce and aux within 1e-5 relative, each
  gradient leaf within 1e-4 of that leaf's largest magnitude;
* three AdamW steps under the reference's own run (bf16 master weights
  and bf16 moments, full remat): loss and ce within 1e-5 relative; grad
  norm within 2^-8 relative (the gradients are bf16, the leaves' dtype,
  and may round one ulp apart, which moves a norm by at most 2^-8 of
  it); every weight within 2 lr n of the reference's (n steps of AdamW
  move a weight by at most about lr each: the normalised step is at most
  about 1 and the decay adds lr wd |w|), and all but 1/200 of each leaf's
  weights within one bf16 ulp of their value (both sides round every
  update to bf16, so a weight whose updates differ by little may still
  land an ulp or a few apart, and later steps carry that on); the
  moments within n 2^-7 of their leaf's largest magnitude (one bf16 ulp
  of the largest element a step, on each side).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RefData  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig, check_trainable, get_config, get_run_config)
from repro_torch.convert import (  # noqa: E402
    overlay_train_state, params_from_jax, params_to_jax,
    train_state_from_jax, train_state_to_jax)
from repro_torch.core.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.learner import RealPayload  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Model, compute_params, make_trainable)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


CPU = torch.device("cpu")
CTX = Ctx(device=CPU, dtype=torch.float32)
RCTX = RefCtx(mesh=None, dtype=jnp.float32)
ARCH = "deepseek-v2-236b"
BF16_RUN = dict(remat_policy="full", master_dtype="bfloat16",
                opt_dtype="bfloat16")


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _configs(**over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def _close(got, want, share, what, floor=0.0):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= share * max(np.abs(want).max(), 1e-30) + floor, (what, err)


# ---------------------------------------------------------------------------
# The plain flash forward and backward at unequal head dims
# ---------------------------------------------------------------------------
FLASH_CASES = [(hd, hdv, S, G) for hd, hdv in ((24, 16), (192, 128))
               for S in (1, 37, 130) for G in (1, 2)]


@pytest.mark.parametrize("hd,hdv,S,G", FLASH_CASES,
                         ids=lambda x: str(x))
def test_plain_flash_at_unequal_head_dims_matches_reference_and_grad(
        hd, hdv, S, G):
    """``flash_attention_torch`` and ``flash_attention_bwd_torch`` with v
    narrower than q and k against ``flash_attention_jnp`` and its
    ``jax.grad``, causal, fp32; the autograd Function on the CPU is the
    same pair."""
    B, K = 2, 2
    rng = np.random.default_rng(hd + S + G)
    q = rng.normal(size=(B, S, K * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hdv)).astype(np.float32)
    do = rng.normal(size=(B, S, K * G, hdv)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, causal=True)
    want, vjp = jax.vjp(lambda a, b, c: flash_attention_jnp(
        a, b, c, q_block=64, kv_block=32, **kw), *map(jnp.asarray, (q, k, v)))
    o, lse = fa.flash_attention_torch(_t(q), _t(k), _t(v), return_lse=True,
                                      **kw)
    assert o.shape == (B, S, K * G, hdv)
    _close(o.numpy(), _np(want), 1e-5, "o")
    grads = fa.flash_attention_bwd_torch(_t(q), _t(k), _t(v), o, lse,
                                         _t(do), **kw)
    wants = vjp(jnp.asarray(do))
    for name, g, w in zip("qkv", grads, wants):
        assert g.shape == w.shape, name
        # at S 1, dq and dk are 0 but for fp32 rounding (dP - D cancels)
        _close(g.numpy(), _np(w), 1e-4, f"d{name}", floor=1e-5)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention_bshd(*leaves, **kw)
    auto = torch.autograd.grad(out, leaves, _t(do))
    for name, a, g in zip("qkv", auto, grads):
        torch.testing.assert_close(a, g, rtol=0, atol=0, msg=name)


def test_flash_wrappers_refuse_mismatched_shapes_and_pairs():
    """Shapes are checked on every device; the card's head-dim pairs (and
    no softcap at MLA's) by ``ops._flash_pair``, which reads shapes only."""
    q = torch.zeros(1, 8, 4, 24)
    k = torch.zeros(1, 8, 2, 24)
    kw = dict(scale=0.2)
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention_bshd(q, k, torch.zeros(1, 8, 1, 16), **kw)
    with pytest.raises(ValueError, match="vs k"):
        ops.flash_attention_bshd(q, torch.zeros(1, 8, 2, 16),
                                 torch.zeros(1, 8, 2, 16), **kw)
    v = torch.zeros(1, 8, 2, 16)
    o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
    with pytest.raises(ValueError, match="flash_attention_bwd"):
        ops.flash_attention_bwd(q, k, v, q, lse, q, **kw)    # o at hd 24
    assert all(g.shape == t.shape for g, t in zip(
        ops.flash_attention_bwd(q, k, v, o, lse, o, **kw), (q, k, v)))
    mla = dict(scale=0.1, causal=True, window=0, logit_cap=0.0)
    for pairs, name in ((fa.HEAD_DIM_PAIRS, "fwd"),
                        (fa.BWD_HEAD_DIM_PAIRS, "bwd")):
        ops._flash_pair(name, torch.zeros(1, 1, 1, 192),
                        torch.zeros(1, 1, 1, 128), mla, pairs)
        for hd, hdv in ((24, 16), (128, 64), (192, 192), (256, 128)):
            with pytest.raises(ValueError, match="head_dim"):
                ops._flash_pair(name, torch.zeros(1, 1, 1, hd),
                                torch.zeros(1, 1, 1, hdv), mla, pairs)
        with pytest.raises(ValueError, match="softcap"):
            ops._flash_pair(name, torch.zeros(1, 1, 1, 192),
                            torch.zeros(1, 1, 1, 128),
                            dict(mla, logit_cap=30.0), pairs)
    # hd 256 trains with a softcap too (gemma2): only MLA's pair refuses
    assert (256, 256) in fa.BWD_HEAD_DIM_PAIRS
    ops._flash_pair("bwd", torch.zeros(1, 1, 1, 256),
                    torch.zeros(1, 1, 1, 256), dict(mla, logit_cap=30.0),
                    fa.BWD_HEAD_DIM_PAIRS)
    assert fa.MLA_PAIR in fa.BWD_HEAD_DIM_PAIRS


def test_backward_tiles_and_plan_at_mla_s_pair():
    """MLA's streamed tiles (32 q rows, 64 keys) and its plan at (t5)'s
    shape: two K/V slots and three 32-row stages for dK/dV, one Q/dO/O slot
    and two 64-key stages for dQ, within the card's shared memory."""
    assert fa.bwd_stream_tiles(192, False, 128) == (32, 64)
    assert fa.bwd_stream_tiles(128) == (64, 128)
    plan = fa.flash_bwd_plan(2, 4096, 128, 128, 192, True, 0, 132,
                             hd_v=128)
    assert (plan["br"], plan["bn"]) == (32, 64)
    kv, dq = plan["kv"], plan["dq"]
    assert (kv["slots"], kv["stages"]) == (2, 3)
    assert (dq["slots"], dq["stages"]) == (1, 2)
    assert kv["offs"]["ring"] == 2 * 128 * 320 * 2
    assert kv["offs"]["stats"] == kv["offs"]["ring"] + 3 * 32 * 320 * 2
    assert dq["offs"]["ring"] == 128 * (192 + 256) * 2
    assert max(kv["smem"], dq["smem"]) <= fa.BWD_SMEM_LIMIT
    assert kv["blocks"] == dq["blocks"] == 132


# ---------------------------------------------------------------------------
# mla_attention in train mode
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced():
    rcfg, tcfg = _configs()
    rparams = ref_init_params(rcfg, jax.random.key(0))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rcfg, tcfg, rparams, make_trainable(model)


@pytest.mark.parametrize("layer", ["prefix", "groups"])
def test_mla_attention_train_mode_matches_reference(reduced, layer):
    """One layer's train-mode attention (``mode="full"``, no cache):
    output, and the gradients of a weighted sum of it with respect to the
    input and every MLA leaf, against the reference's."""
    rcfg, tcfg, rparams, _ = reduced
    tree = jax.device_get(rparams)["decoder"][layer]["0"]["attn"]
    if layer == "groups":
        tree = {n: a[0] for n, a in tree.items()}
    rp = {n: np.array(a, np.float32) for n, a in tree.items()}
    assert sorted(rp) == ["kv_a", "kv_b", "kv_norm", "o", "q_a", "q_b",
                          "q_norm"]
    rng = np.random.default_rng(4)
    B, S = 2, 13
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)

    def ref_loss(p, x):
        out, cache = ref_attn.mla_attention(rcfg, p, x, RCTX, mode="full",
                                            cache=None, pos=jnp.asarray(pos))
        assert cache is None
        return (out * w).sum(), out

    (_, want), wgrads = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(
        {n: jnp.asarray(a) for n, a in rp.items()}, jnp.asarray(x))
    leaves = {n: _t(a).requires_grad_(True) for n, a in rp.items()}
    xt = _t(x).requires_grad_(True)
    out, cache = port_attn.mla_attention(tcfg, leaves, xt, mode="full",
                                         cache=None, pos=torch.from_numpy(pos))
    assert cache is None and out.shape == (B, S, tcfg.d_model)
    _close(out.detach().numpy(), _np(want), 1e-4, "out")
    names = sorted(leaves)
    got = torch.autograd.grad((out * _t(w)).sum(),
                              [leaves[n] for n in names] + [xt])
    for n, g in zip(names, got):
        _close(g.numpy(), _np(wgrads[0][n]), 1e-4, n)
    _close(got[-1].numpy(), _np(wgrads[1]), 1e-4, "x")


# ---------------------------------------------------------------------------
# The reduced deepseek-v2: loss, gradients, AdamW steps, remat
# ---------------------------------------------------------------------------
def _batch(rcfg, S=16, B=2, step=0, seed=3):
    b = RefData(rcfg.vocab_size, S, B, seed=seed).batch_at(step)
    b = {k: np.array(v) for k, v in b.items()}
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


def test_loss_and_gradients_match_reference_by_tree_path(reduced):
    rcfg, tcfg, rparams, model = reduced
    rb, tb = _batch(rcfg)
    rb["labels"][0, :5] = -1
    tb["labels"][0, :5] = -1
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_steps.loss_fn(rcfg, p, rb, RCTX), has_aux=True))(
        rparams)
    names, leaves = zip(*model.named_parameters())
    loss, met = steps.loss_fn(tcfg, compute_params(model, torch.float32), tb,
                              CTX)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(met[key].detach()),
                                   float(rmet[key]), rtol=1e-5)
    assert float(rmet["aux"]) > 0
    got = dict(_leaves(params_to_jax(dict(zip(names, grads)), tcfg)))
    want = dict(_leaves(jax.device_get(rgrads)))
    assert sorted(got) == sorted(want)
    assert any("/attn/kv_b" in p for p in want) \
        and any("/moe/ws_g" in p for p in want) \
        and any("prefix/0/ffn/wg" in p for p in want)
    for path, w in want.items():
        _close(got[path], w, 1e-4, path)


def run_bf16_steps(n_mb, n_steps=3, lr=1e-3, B=4, S=16):
    """``n_steps`` AdamW steps of both packages under the reference's
    deepseek-v2 run (bf16 master and moments, full remat) from the
    reference's initial state, on its batches.  Returns both final states
    (numpy trees) and each step's (port, reference) metrics."""
    rcfg, tcfg = _configs()
    kw = dict(BF16_RUN, num_microbatches=n_mb, learning_rate=lr,
              warmup_steps=2, total_steps=n_steps)
    run = RefRunConfig(**kw)
    rstate = ref_steps.init_train_state(rcfg, jax.random.key(1), run)
    tstate = train_state_from_jax(jax.device_get(rstate), tcfg, device=CPU)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, RCTX, run))
    tstep = steps.make_train_step(tcfg, CTX, RunConfig(**kw))
    data = RefData(rcfg.vocab_size, S, B, seed=5)
    metrics = []
    for i in range(n_steps):
        batch = {k: np.array(v) for k, v in data.batch_at(i).items()}
        rstate, rm = rstep(rstate, batch)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v).long()
                                    for k, v in batch.items()})
        metrics.append(({k: float(v) for k, v in tm.items()},
                        {k: float(v) for k, v in rm.items()}))
    return (jax.device_get(rstate), train_state_to_jax(tstate, tcfg),
            metrics)


def _bf16_ulp(a):
    """The spacing of bf16 numbers at |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a.astype(np.float32)), np.float32(1e-38))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("n_mb", [1, 2])
def test_three_bf16_steps_match_reference_under_its_run(n_mb):
    n_steps, lr = 3, 1e-3
    rstate, tstate, metrics = run_bf16_steps(n_mb, n_steps, lr)
    for i, (tm, rm) in enumerate(metrics):
        for key, rtol in (("loss", 1e-5), ("ce", 1e-5), ("aux", 1e-5),
                          ("grad_norm", 2 ** -8), ("lr", 1e-6)):
            np.testing.assert_allclose(tm[key], rm[key], rtol=rtol,
                                       err_msg=f"{key}, step {i}")
    assert int(tstate["step"]) == int(rstate["step"]) == n_steps
    got = dict(_leaves(tstate["params"]))
    for path, w in _leaves(rstate["params"]):
        g = got[path]
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        err = np.abs(g.astype(np.float32) - w.astype(np.float32))
        assert err.max() <= 2 * lr * n_steps, (path, err.max())
        if w.dtype != np.float32:         # the bf16 masters
            off = err > _bf16_ulp(w)
            assert off.mean() <= 1 / 200, (path, off.sum(), off.size)
    for part in ("m", "v"):
        got = dict(_leaves(tstate["opt"][part]))
        for path, w in _leaves(rstate["opt"][part]):
            assert got[path].dtype == w.dtype, (part, path)
            _close(got[path], w, n_steps * 2 ** -7, f"{part} {path}")


def test_port_init_casts_the_reference_s_leaves():
    """Under bf16 masters the port's fresh state holds every leaf in the
    reference's dtype: matrices and the stacked layers' 1-D leaves in
    bf16, the first (dense) layer's and the final norm in fp32."""
    rcfg, tcfg = _configs()
    kw = dict(BF16_RUN, total_steps=3)
    rstate = jax.device_get(ref_steps.init_train_state(
        rcfg, jax.random.key(1), RefRunConfig(**kw)))
    tstate = train_state_to_jax(steps.init_train_state(
        tcfg, run=RunConfig(**kw), device=CPU), tcfg)
    for part in (("params",), ("opt", "m"), ("opt", "v")):
        r, t = rstate, tstate
        for key in part:
            r, t = r[key], t[key]
        got = dict(_leaves(t))
        for path, w in _leaves(r):
            assert got[path].dtype == w.dtype, (part, path)
            assert got[path].shape == w.shape, (part, path)
    assert dict(_leaves(tstate["params"]))[
        "decoder/groups/0/pre_norm"].dtype.name == "bfloat16"
    assert dict(_leaves(tstate["params"]))[
        "decoder/prefix/0/pre_norm"].dtype == np.float32


def test_remat_policies_give_equal_loss_aux_and_gradients(reduced):
    _, tcfg, _, model = reduced
    _, tb = _batch(_configs()[0], S=16, B=3)
    names, leaves = zip(*model.named_parameters())
    res = {}
    for policy in ("none", "full", "dots"):
        loss, met = steps.loss_fn(tcfg, compute_params(model, torch.float32),
                                  tb, CTX, remat_policy=policy)
        res[policy] = (loss.detach(), met["aux"].detach(),
                       torch.autograd.grad(loss, leaves))
    loss0, aux0, g0 = res["none"]
    assert float(aux0) > 0
    for policy in ("full", "dots"):
        loss, aux, g = res[policy]
        assert torch.equal(loss, loss0) and torch.equal(aux, aux0), policy
        for n, a, b in zip(names, g0, g):
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=n)


def test_sliced_adamw_update_is_bit_equal_to_the_whole_one(monkeypatch):
    """Leaves past ``SLICE_ELEMENTS`` are updated in slices along their
    first axis: the update is elementwise, so weights and moments come out
    bit for bit as from a whole-leaf update.  The gradients' norm is below
    the clip, so the clip scale is exactly 1 on both sides.  The norm sums
    the same squares in another order: within 1e-6 relative, here and for
    gradients 1e4 times larger."""
    gen = torch.Generator().manual_seed(3)
    shapes = {"experts": (5, 7, 3), "embed": (11, 4), "gain": (4,),
              "one_row": (1, 40)}
    params = {n: torch.randn(s, generator=gen).to(torch.bfloat16)
              for n, s in shapes.items()}
    grads = {n: (torch.randn(s, generator=gen) * 1e-3).to(torch.bfloat16)
             for n, s in shapes.items()}
    cfg = adamw.AdamWConfig(learning_rate=1e-2, warmup_steps=1)
    runs, norms = {}, {}
    for limit in (1 << 28, 8):
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", limit)
        p = {n: t.clone() for n, t in params.items()}
        state = adamw.adamw_init(p, torch.bfloat16)
        for n in state["v"]:
            state["v"][n].copy_(grads[n].float().square())
        runs[limit] = (p, *adamw.adamw_update(cfg, grads, p, state))
        norms[limit] = float(adamw.global_norm(
            {n: g.float() * 1e4 for n, g in grads.items()}))
    assert [tuple(x.shape) for x in adamw._slices(params["experts"])] == \
        [(1, 7, 3)] * 5
    assert len(adamw._slices(params["one_row"])) == 1
    (p0, s0, m0), (p1, s1, m1) = runs[1 << 28], runs[8]
    assert float(m0["grad_norm"]) < cfg.grad_clip_norm
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m0["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(norms[8], norms[1 << 28], rtol=1e-6)
    for n in shapes:
        assert torch.equal(p0[n], p1[n]), n
        assert torch.equal(s0["m"][n], s1["m"][n]), n
        assert torch.equal(s0["v"][n], s1["v"][n]), n


# ---------------------------------------------------------------------------
# Train state, the CLI and the platform
# ---------------------------------------------------------------------------
def _random_state_tree(rcfg, seed=2):
    run = RefRunConfig(**BF16_RUN)
    rstate = jax.device_get(ref_steps.init_train_state(
        rcfg, jax.random.key(seed), run))
    rng = np.random.default_rng(seed)

    def draw(a):
        return rng.normal(size=a.shape).astype(a.dtype)
    return {"params": jax.tree.map(draw, rstate["params"]),
            "opt": {"m": jax.tree.map(draw, rstate["opt"]["m"]),
                    "v": jax.tree.map(lambda a: np.abs(draw(a)),
                                      rstate["opt"]["v"]),
                    "count": np.int32(5)},
            "step": np.int32(5)}


def test_train_state_round_trips_exactly_with_the_mla_leaves():
    """A reference train state under its bf16 run (bf16 masters, moments
    and stacked norms; fp32 unstacked norms) through the port and back:
    every leaf's bytes, dtype and shape; then loaded into a live port
    state in place."""
    rcfg, tcfg = _configs()
    tree = _random_state_tree(rcfg)
    prefix = tree["params"]["decoder"]["prefix"]["0"]["attn"]
    groups = tree["params"]["decoder"]["groups"]["0"]["attn"]
    assert sorted(prefix) == ["kv_a", "kv_b", "kv_norm", "o", "q_a", "q_b",
                              "q_norm"]
    assert groups["kv_b"].shape == (
        tcfg.num_layers - 1, tcfg.kv_lora_rank, tcfg.num_heads,
        tcfg.qk_nope_head_dim + tcfg.v_head_dim)
    assert groups["kv_b"].dtype.name == "bfloat16"
    assert prefix["kv_norm"].dtype == np.float32
    state = train_state_from_jax(tree, tcfg, device=CPU)
    np.testing.assert_array_equal(
        state["params"].blocks[2].attn.kv_b.detach().float().numpy(),
        groups["kv_b"][1].astype(np.float32))
    back = train_state_to_jax(state, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(_leaves(tree), _leaves(back)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape, pa
        np.testing.assert_array_equal(a, b, err_msg=pa)
    fresh = steps.init_train_state(
        tcfg, seed=9, run=RunConfig(**BF16_RUN), device=CPU)
    overlay_train_state(fresh, tree)
    for (pa, a), (_, b) in zip(_leaves(tree),
                               _leaves(train_state_to_jax(fresh, tcfg))):
        assert a.dtype == b.dtype, pa
        np.testing.assert_array_equal(a, b, err_msg=pa)


def test_cli_trains_deepseek_on_the_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", "2", "--seq", "16",
                           "--remat", "full", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "deepseek-v2-236b-reduced" in out and "steps/s" in out
    assert "master=bfloat16 moments=bfloat16" in out
    assert out.count("  step ") == 3 and out.count(" aux ") == 3
    check_trainable(get_config(ARCH))
    run = get_run_config(ARCH, "train_4k")
    assert (run.num_microbatches, run.remat_policy, run.master_dtype,
            run.opt_dtype) == (16, "full", "bfloat16", "bfloat16")
    assert train_cli.run_config_of(train_cli.spec_of(train_cli.parse_args(
        ["--steps", "2"])), "qwen3-0.6b").master_dtype == "float32"


JOB_STEPS, JOB_LR = 8, 2e-3


def _job_payload(tcfg, init):
    run = RunConfig(learning_rate=JOB_LR, warmup_steps=2,
                    total_steps=JOB_STEPS, **BF16_RUN)
    rdata = RefData(tcfg.vocab_size, 16, 4, seed=0)

    class Batches:
        def batch_at(self, step):
            return {k: np.asarray(v, np.int64)
                    for k, v in rdata.batch_at(step).items()}

    class Payload(RealPayload):
        def __init__(self):
            super().__init__(
                lambda: train_state_from_jax(init, tcfg, device=CPU),
                steps.make_train_step(tcfg, CTX, run), Batches())
            self.losses = []

        def step(self, i):
            loss = super().step(i)
            self.losses.append((i, loss))
            return loss
    return Payload()


def test_deepseek_job_killed_after_a_checkpoint_equals_an_uninterrupted_run():
    """A reduced deepseek-v2 learner under its bf16 run as a real payload
    under the port's platform: the pod is killed after a checkpoint, the
    job restores it and completes; every loss (replayed steps included)
    and the final state equal, bit for bit, those of the same payload run
    without the platform."""
    rcfg, tcfg = _configs()
    init = jax.device_get(ref_steps.init_train_state(
        rcfg, jax.random.key(0), RefRunConfig(**BF16_RUN)))
    plain = _job_payload(tcfg, init)
    plain.restore(None)
    want = [plain.step(i) for i in range(JOB_STEPS)]

    payload = _job_payload(tcfg, init)
    p = port_core.DLaaSPlatform(seed=21)
    p.run(10)
    h = p.submit(port_core.JobManifest(
        name="deepseek", framework=ARCH, learners=1,
        total_steps=JOB_STEPS, step_time_s=0.5, checkpoint_interval_s=1.5,
        real_compute=True))
    p.run(5)
    assert h.acked, h.rejected
    p.register_payload(h.job_id, payload)
    ck = CheckpointManager(p.objectstore, h.job_id)
    while True:
        p.run(0.25)
        vol = p.volumes.get(f"vol-{h.job_id}")
        at = vol.read("progress/0", {"step": 0})["step"] if vol else 0
        if ck.steps() and at > max(ck.steps()):
            break
        assert p.sim.now < 600, "no checkpoint to kill after"
    saved = max(ck.steps())
    assert p.kill_pod(f"learner-{h.job_id}-0")
    assert p.run_until_terminal(h.job_id, timeout=900) == "COMPLETED"
    assert p.client.status(h.job_id)["restarts"] == 1
    assert f"restored checkpoint step {saved}" in p.client.logs(h.job_id, 0)
    ran = [i for i, _ in payload.losses]
    assert len(ran) > len(set(ran)) == JOB_STEPS          # steps replayed
    for i, loss in payload.losses:
        assert loss == want[i], (i, loss, want[i])
    for (pa, a), (_, b) in zip(_leaves(payload.snapshot()),
                               _leaves(plain.snapshot())):
        assert a.dtype == b.dtype, pa
        np.testing.assert_array_equal(a, b, err_msg=pa)


def test_train_logits_match_reference(reduced):
    rcfg, tcfg, rparams, model = reduced
    rb, tb = _batch(rcfg)
    want, _, want_aux = ref_model.forward(rcfg, rparams, rb, RCTX,
                                          mode="train")
    got, aux = port_model.forward(tcfg, compute_params(model, torch.float32),
                                  tb, CTX, mode="train")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=1e-5)
