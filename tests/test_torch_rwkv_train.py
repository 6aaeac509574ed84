"""The port's RWKV6 training path against the JAX reference on the CPU.

The reference trains RWKV6 by ``jax.grad`` through its plain jnp
``models/rwkv.py:wkv6_chunked``; the port runs ``ops.wkv6_bshn`` through
the ``WKV6`` autograd Function, whose forward also keeps the state before
every ``SEG``-th step and whose backward is ``wkv6_bwd_torch`` on the CPU
(the CUDA kernel on a card, held against it by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``).  Both packages get the same numpy inputs: the
reference's own weights (converted by tree path, ``repro_torch.convert``)
and batches.  The reference runs with ``Ctx(mesh=None, dtype=float32)``.

Covered: the plain backward against ``jax.grad`` of ``wkv6_chunked`` (S 1,
a ragged S, several segments; N 16, 32, 64; nonzero s0 and ds_final) and,
at the decays where the reference goes NaN (R4: constant lw -3 and -8,
down to -e^4), against autograd through the plain forward; the autograd
Function and its wrapper's contract; the time and channel mix's
gradients; reduced ``rwkv6-7b``'s loss and every gradient, three AdamW
steps with one and two microbatches, remat; the train state's round trip
and checkpoint bytes; the CLI; a job under the port's platform killed
after a checkpoint.

Tolerances (fp32; the backward sums in another order and rebuilds the
states step by step where the reference differentiates its chunks):
* WKV6 gradients within 1e-5 of each gradient's largest magnitude
  (against autograd through the plain chunked forward at strong decays
  1e-4, dlw 1e-3: that form's own fp32 error);
* mixers' and model gradients within 1e-4 of each leaf's largest
  magnitude; loss 1e-5 relative, lr 1e-6;
* the model's gradient amplifies rounding in WKV6's output o (with
  decays near 1 at init the state sums every step;
  ``tools/rwkv_grad_sensitivity.py`` measures it), and the port's and the
  reference's chunked fp32 forwards round o differently, so their
  gradients differ by more than the sum orders of the other stacks'
  would make them.  Over three AdamW steps the grad norm is held within
  1e-4 relative, the weights within 1e-4 where the reference's gradient
  was not below 1e-4 of its leaf's largest in some step (elsewhere
  within 2·lr a step, Adam's sign amplification) and the moments within
  1e-3 of each leaf's largest.
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
from repro.core.checkpoint import CheckpointManager as RefCkpt  # noqa: E402
from repro.core.objectstore import ObjectStore as RefStore  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RefData  # noqa: E402
from repro.models import rwkv as ref_rwkv  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig, check_trainable, get_config, get_run_config)
from repro_torch.convert import (  # noqa: E402
    params_from_jax, params_to_jax, train_state_from_jax, train_state_to_jax)
from repro_torch.core.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.learner import RealPayload  # noqa: E402
from repro_torch.core.objectstore import ObjectStore  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import rwkv as port_rwkv  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Model, cast_params, compute_params, init_params, make_trainable)
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


CPU = torch.device("cpu")
CTX = Ctx(device=CPU, dtype=torch.float32)
RCTX = RefCtx(mesh=None, dtype=jnp.float32)
ARCH = "rwkv6-7b"
WKV_GRAD_TOL = 1e-5
GRAD_TOL = 1e-4
NAMES = ("dr", "dk", "dv", "dlw", "du", "ds0")


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


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


# ---------------------------------------------------------------------------
# The WKV6 backward
# ---------------------------------------------------------------------------
def _wkv_case(seed, B, S, H, N, decay="mixed"):
    """r, k, v, dO ~ N(0, 1); lw = -exp(U(-6, 1)) ("mixed"), a constant,
    or -exp(U(-6, 4)) ("strong"); u ~ 0.5 N(0, 1); s0 and ds_final ~
    0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.normal(size=(B, S, H, N)).astype(np.float32)
                   for _ in range(4))
    if decay == "mixed":
        lw = -np.exp(rng.uniform(-6, 1, (B, S, H, N)))
    elif decay == "strong":
        lw = -np.exp(rng.uniform(-6, 4, (B, S, H, N)))
    else:
        lw = np.full((B, S, H, N), decay)
    u = 0.5 * rng.normal(size=(H, N))
    s0, dsf = (0.3 * rng.normal(size=(B, H, N, N)) for _ in range(2))
    return [a.astype(np.float32) for a in (r, k, v, lw, u, s0, do, dsf)]


def _plain_grads(r, k, v, lw, u, s0, do, dsf):
    """``wkv6_bwd_torch`` from the plain forward's checkpoints."""
    _, _, ckpt = wkv.wkv6_torch(*map(_t, (r, k, v, lw, u, s0)), seg=wkv.SEG)
    assert ckpt.shape[2] == -(-r.shape[1] // wkv.SEG)
    return wkv.wkv6_bwd_torch(*map(_t, (r, k, v, lw, u)), ckpt, _t(do),
                              _t(dsf))


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 37, 80])
def test_wkv6_plain_backward_matches_jax_grad(S, N):
    """S 1, S below one segment of ``wkv.SEG`` (64) steps, and a segment
    and a ragged tail (80); the reference at its chunk of 32
    (``tests/test_torch_wkv_bwd.py`` covers more lengths)."""
    r, k, v, lw, u, s0, do, dsf = _wkv_case(S + N, 2, S, 3, N)

    def loss(r, k, v, lw, u, s0):
        o, s_fin = ref_rwkv.wkv6_chunked(r, k, v, lw, u, s0, 32)
        return (o * do).sum() + (s_fin * dsf).sum()

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (r, k, v, lw, u, s0)))
    got = _plain_grads(r, k, v, lw, u, s0, do, dsf)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), _np(w), WKV_GRAD_TOL, name)


def _step_oracle(r, k, v, lw, u, s0):
    """``ref.wkv6_ref`` (the step-by-step forward) in the model layout."""
    B, S, H, N = r.shape
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, N)  # noqa: E731
    o, s_fin = ref.wkv6_ref(fold(r), fold(k), fold(v), fold(lw),
                            u[None].expand(B, H, N).reshape(B * H, 1, N),
                            s0.reshape(B * H, N, N))
    return o.reshape(B, H, S, N).transpose(1, 2), s_fin.reshape(B, H, N, N)


@pytest.mark.parametrize("decay", [-3.0, -8.0, "strong"])
def test_wkv6_plain_backward_at_strong_decays(decay):
    """Where the reference's jnp chunks go NaN (R4), the plain backward
    against autograd through the step oracle (within 1e-5) and through
    the plain chunked forward, which masks with ``where``.  That form's
    gradients come through exponentials of cumulative log-decays, whose
    fp32 cancellation moves them most at strong decays and dlw most of
    all (``tools/rwkv_grad_sensitivity.py --device cpu``: 1.1e-5 of a
    gradient's largest at decays down to -e^4, dlw 2e-4 at lw -8, where
    the step oracle agrees within 4.1e-6): they are held to it within
    1e-4, dlw within 1e-3."""
    args = _wkv_case(11, 2, 70, 2, 64, decay)
    r, k, v, lw, u, s0, do, dsf = args
    got = _plain_grads(*args)
    for forward, tol, dlw_tol in ((_step_oracle, WKV_GRAD_TOL, WKV_GRAD_TOL),
                                  (wkv.wkv6_torch, 1e-4, 1e-3)):
        leaves = [_t(a).requires_grad_(True) for a in (r, k, v, lw, u, s0)]
        o, s_fin = forward(*leaves)
        want = torch.autograd.grad(
            (o * _t(do)).sum() + (s_fin * _t(dsf)).sum(), leaves)
        for name, g, w in zip(NAMES, got, want):
            assert bool(torch.isfinite(g).all()), name
            _close(g.numpy(), w.numpy(), dlw_tol if name == "dlw" else tol,
                   name)


def test_wkv6_function_gives_the_plain_backward_on_cpu():
    """With grad on, ``ops.wkv6_bshn`` goes through ``ops.WKV6``: the same
    forward as without grad, the gradients of ``wkv6_bwd_torch`` (s_final
    unused: a zero ds_final), and no kernel launch."""
    r, k, v, lw, u, s0, do, _ = _wkv_case(5, 2, 45, 2, 16)
    leaves = [_t(a).requires_grad_(True) for a in (r, k, v, lw, u)]
    before = dict(ops.launches)
    o, s_fin = ops.wkv6_bshn(*leaves, _t(s0), chunk=16)
    assert o.grad_fn is not None and "WKV6" in type(o.grad_fn).__name__
    with torch.no_grad():
        po, ps = ops.wkv6_bshn(*leaves, _t(s0), chunk=16)
    assert torch.equal(o.detach(), po) and torch.equal(s_fin.detach(), ps)
    got = torch.autograd.grad((o * _t(do)).sum(), leaves)
    _, _, ckpt = wkv.wkv6_torch(*map(_t, (r, k, v, lw, u, s0)), chunk=16,
                                seg=wkv.SEG)
    want = wkv.wkv6_bwd_torch(*map(_t, (r, k, v, lw, u)), ckpt, _t(do))
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    assert ops.launches == before


def test_wkv6_bwd_wrapper_refuses_and_never_takes_the_plain_version_off_cpu(
        monkeypatch):
    # two segments, so a buffer cut to one is short
    r, k, v, lw, u, s0, do, dsf = map(_t, _wkv_case(3, 1, wkv.SEG + 4, 2,
                                                    16))
    _, _, ckpt = wkv.wkv6_torch(r, k, v, lw, u, s0, seg=wkv.SEG)
    assert ckpt.shape[2] == 2
    with pytest.raises(ValueError, match="ckpt"):
        ops.wkv6_bwd(r, k, v, lw, u, ckpt[:, :, :1], do)
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.wkv6_bwd(r, k, v, lw, u, ckpt, do.bfloat16())
    with pytest.raises(ValueError, match="fp32"):
        ops.wkv6_bwd(r, k, v, lw, u, ckpt.double(), do)

    def plain(*a, **kw):
        raise AssertionError("a tensor off the CPU reached the plain version")
    monkeypatch.setattr(wkv, "wkv6_bwd_torch", plain)
    monkeypatch.setattr(wkv, "wkv6_torch", plain)
    meta = [t.to("meta") for t in (r, k, v, lw, u, ckpt, do, dsf)]
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        ops.wkv6_bwd(*meta)
    leaves = [t.to("meta").requires_grad_(True) for t in (r, k, v, lw, u)]
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        ops.wkv6_bshn(*leaves, s0.to("meta"))


# ---------------------------------------------------------------------------
# Time mix and channel mix: gradients
# ---------------------------------------------------------------------------
def _configs(**over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def _weights(rcfg, tcfg):
    rparams = ref_init_params(rcfg, jax.random.key(0))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rparams, model


@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("mixer", ["time", "channel"])
def test_mixer_gradients_match_jax_grad(mixer, N):
    """Gradients of a weighted sum of a mixer's output (full mode, no
    cache; 45 steps: a 32-step chunk of the reference and a ragged one,
    part of one segment of the port) with respect to its input and every
    leaf."""
    rcfg, tcfg = _configs(rwkv_head_dim=N)
    rparams, model = _weights(rcfg, tcfg)
    key = "tm" if mixer == "time" else "cm"
    rp = jax.tree.map(lambda a: a[0], rparams["decoder"]["groups"]["0"][key])
    rng = np.random.default_rng(N)
    x = rng.normal(size=(2, 45, rcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    rfn = ref_rwkv.rwkv_time_mix if mixer == "time" \
        else ref_rwkv.rwkv_channel_mix
    tfn = port_rwkv.rwkv_time_mix if mixer == "time" \
        else port_rwkv.rwkv_channel_mix
    want = jax.jit(jax.grad(lambda p, x: (rfn(rcfg, p, x, RCTX, mode="full",
                                              cache=None)[0] * w).sum(),
                            argnums=(0, 1)))(rp, jnp.asarray(x))
    tp = {n: _t(_np(a)).requires_grad_(True) for n, a in rp.items()}
    xt = _t(x).requires_grad_(True)
    y, _ = tfn(tcfg, tp, xt, CTX, mode="full", cache=None)
    names = sorted(tp)
    got = torch.autograd.grad((y * _t(w)).sum(), [tp[n] for n in names]
                              + [xt])
    for n, g in zip(names, got):
        _close(g.numpy(), _np(want[0][n]), GRAD_TOL, n)
    _close(got[-1].numpy(), _np(want[1]), GRAD_TOL, "x")


# ---------------------------------------------------------------------------
# Reduced rwkv6-7b: loss, gradients, AdamW steps, remat
# ---------------------------------------------------------------------------
MODEL_CASES = {"reduced": {}, "heads4": dict(rwkv_head_dim=16)}


def _batch(rcfg, S=40, B=2, step=0, seed=3):
    b = RefData(rcfg.vocab_size, S, B, seed=seed).batch_at(step)
    b = {k: np.array(v) for k, v in b.items()}
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_loss_and_gradients_match_reference_by_tree_path(case):
    rcfg, tcfg = _configs(**MODEL_CASES[case])
    rparams, model = _weights(rcfg, tcfg)
    model = make_trainable(model)
    rb, tb = _batch(rcfg)
    rb["labels"][0, :5] = -1
    tb["labels"][0, :5] = -1
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_steps.loss_fn(rcfg, p, rb, RCTX), has_aux=True))(
        rparams)
    names, leaves = zip(*model.named_parameters())
    loss, _ = steps.loss_fn(tcfg, compute_params(model, torch.float32), tb,
                            CTX)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    got = dict(_leaves(params_to_jax(dict(zip(names, grads)), tcfg)))
    want = dict(_leaves(jax.device_get(rgrads)))
    assert sorted(got) == sorted(want)
    assert any("/tm/u" in p for p in want)
    for path, w in want.items():
        _close(got[path], w, GRAD_TOL, path)


def run_steps(rcfg, tcfg, n_mb, n_steps, lr=1e-3, B=4, S=40):
    """``n_steps`` AdamW steps of both packages from the reference's
    initial state on the reference's batches: both final states (numpy
    trees), each step's (port, reference) metrics and, with one
    microbatch, where each step's reference gradient was below 1e-4 of its
    leaf's largest."""
    run = RefRunConfig(num_microbatches=n_mb, learning_rate=lr,
                       warmup_steps=2, total_steps=n_steps)
    rstate = ref_steps.init_train_state(rcfg, jax.random.key(1), run)
    tstate = train_state_from_jax(jax.device_get(rstate), tcfg, device=CPU)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, RCTX, run))
    tstep = steps.make_train_step(
        tcfg, CTX, RunConfig(num_microbatches=n_mb, learning_rate=lr,
                             warmup_steps=2, total_steps=n_steps))
    rgrad = jax.jit(jax.grad(
        lambda p, b: ref_steps.loss_fn(rcfg, p, b, RCTX)[0]))
    data = RefData(rcfg.vocab_size, S, B, seed=5)
    metrics, small = [], []
    for i in range(n_steps):
        batch = {k: np.array(v) for k, v in data.batch_at(i).items()}
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        rgrads = rgrad(rstate["params"], batch) if n_mb == 1 else None
        rstate, rm = rstep(rstate, batch)
        tstate, tm = tstep(tstate, tb)
        metrics.append(({k: float(v) for k, v in tm.items()},
                        {k: float(v) for k, v in rm.items()}))
        if rgrads is not None:
            small.append({p: np.abs(g) < 1e-4 * np.abs(g).max()
                          for p, g in _leaves(jax.device_get(rgrads))})
    return (jax.device_get(rstate), train_state_to_jax(tstate, tcfg),
            metrics, small)


@pytest.mark.parametrize("n_mb", [1, 2])
def test_three_train_steps_match_reference(n_mb):
    rcfg, tcfg = _configs()
    lr, n_steps = 1e-3, 3
    rstate, tstate, metrics, small = run_steps(rcfg, tcfg, n_mb, n_steps,
                                               lr=lr)
    for i, (tm, rm) in enumerate(metrics):
        for key, rtol in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4),
                          ("lr", 1e-6)):
            np.testing.assert_allclose(tm[key], rm[key], rtol=rtol,
                                       err_msg=f"{key}, step {i}")
    assert int(tstate["step"]) == int(rstate["step"]) == n_steps
    got = dict(_leaves(tstate["params"]))
    for path, w in _leaves(rstate["params"]):
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w)
        assert err.max() <= 2 * lr * n_steps, (path, err.max())
        off = err > 1e-4
        if small:
            noisy = np.any([s[path] for s in small], axis=0)
            assert not np.any(off & ~noisy), (path, err[~noisy].max())
        else:
            assert off.mean() <= 1e-3, (path, off.sum())
    for part in ("m", "v"):
        got = dict(_leaves(tstate["opt"][part]))
        for path, w in _leaves(rstate["opt"][part]):
            _close(got[path], w, 1e-3, f"{part} {path}")


def test_remat_policies_give_equal_loss_and_gradients():
    _, tcfg = _configs(rwkv_head_dim=16)
    model = make_trainable(init_params(Model(tcfg, device=CPU), 0))
    _, tb = _batch(_configs()[0], S=40, B=3)
    names, leaves = zip(*model.named_parameters())
    res = {}
    for policy in ("none", "full", "dots"):
        loss, _ = steps.loss_fn(tcfg, compute_params(model, torch.float32),
                                tb, CTX, remat_policy=policy)
        res[policy] = (loss.detach(), torch.autograd.grad(loss, leaves))
    loss0, g0 = res["none"]
    for policy in ("full", "dots"):
        loss, g = res[policy]
        assert torch.equal(loss, loss0), policy
        for n, a, b in zip(names, g0, g):
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=n)


def test_remat_full_runs_the_wkv6_forward_twice_a_layer(monkeypatch):
    """WKV6 forwards and backwards a step: L and L without remat, 2L and L
    under full remat; a served prefill runs the forward without
    checkpoints."""
    _, tcfg = _configs()
    model = make_trainable(init_params(Model(tcfg, device=CPU), 0))
    _, tb = _batch(_configs()[0], S=24, B=2)
    calls = []
    fwd, bwd = wkv.wkv6_torch, wkv.wkv6_bwd_torch
    monkeypatch.setattr(wkv, "wkv6_torch", lambda *a, seg=0, **kw: (
        calls.append(("fwd", seg)), fwd(*a, seg=seg, **kw))[1])
    monkeypatch.setattr(wkv, "wkv6_bwd_torch", lambda *a, **kw: (
        calls.append(("bwd", None)), bwd(*a, **kw))[1])
    L = tcfg.num_layers
    for policy, n_fwd in (("none", L), ("full", 2 * L)):
        calls.clear()
        loss, _ = steps.loss_fn(tcfg, compute_params(model, torch.float32),
                                tb, CTX, remat_policy=policy)
        torch.autograd.grad(loss, list(model.parameters()))
        assert calls.count(("fwd", wkv.SEG)) == n_fwd, (policy, calls)
        assert calls.count(("bwd", None)) == L and len(calls) == n_fwd + L
    calls.clear()
    cache = port_model.init_cache(dataclasses.replace(
        tcfg, cache_layout="paged"), 2, 32, device=CPU)
    with torch.inference_mode():
        port_model.forward(tcfg, cast_params(model, torch.float32),
                           {"tokens": tb["tokens"]}, CTX, mode="prefill",
                           cache=cache)
    assert calls == [("fwd", 0)] * L


# ---------------------------------------------------------------------------
# Train state, checkpoints, the CLI and the platform
# ---------------------------------------------------------------------------
def _random_state_tree(rcfg, seed=2):
    rstate = jax.device_get(ref_steps.init_train_state(rcfg,
                                                       jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    return {
        "params": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            a.dtype), rstate["params"]),
        "opt": {"m": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
                    a.dtype), rstate["opt"]["m"]),
                "v": jax.tree.map(lambda a: rng.random(size=a.shape).astype(
                    jnp.bfloat16), rstate["opt"]["v"]),
                "count": np.int32(5)},
        "step": np.int32(5),
    }


def test_train_state_round_trips_exactly_with_the_rwkv_leaves():
    rcfg, tcfg = _configs()
    tree = _random_state_tree(rcfg)
    tm = tree["params"]["decoder"]["groups"]["0"]["tm"]
    assert {"u", "w_base", "tm_mu", "ln_x"} <= set(tm)
    state = train_state_from_jax(tree, tcfg, device=CPU)
    np.testing.assert_array_equal(
        state["params"].blocks[1].tm.u.detach().numpy(), tm["u"][1])
    back = train_state_to_jax(state, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(_leaves(tree), _leaves(back)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape, pa
        np.testing.assert_array_equal(a, b, err_msg=pa)


def test_checkpoint_bytes_equal_the_reference_s():
    rcfg, tcfg = _configs()
    tree = _random_state_tree(rcfg, seed=4)
    ref, port = RefStore(), ObjectStore()
    RefCkpt(ref, "job").save(5, tree)
    state = train_state_from_jax(tree, tcfg, device=CPU)
    CheckpointManager(port, "job").save(5, train_state_to_jax(state, tcfg))
    assert {k: bytes(v) for k, v in port._blobs.items()} == \
        {k: bytes(v) for k, v in ref._blobs.items()}


def test_cli_trains_rwkv_on_the_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", "4", "--seq", "40",
                           "--microbatches", "2", "--remat", "full",
                           "--layers", "2", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "rwkv6-7b-reduced (cut to 2 layers)" in out and "steps/s" in out
    assert out.count("  step ") == 3
    check_trainable(get_config(ARCH))
    run = get_run_config(ARCH, "train_4k")
    assert (run.num_microbatches, run.remat_policy) == (2, "full")
    assert (run.master_dtype, run.opt_dtype) == ("float32", "float32")


JOB_STEPS, JOB_LR = 8, 2e-3


def _job_payload(tcfg, init):
    run = RunConfig(learning_rate=JOB_LR, warmup_steps=2,
                    total_steps=JOB_STEPS)
    rdata = RefData(tcfg.vocab_size, 24, 4, seed=0)

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


def test_rwkv_job_killed_after_a_checkpoint_equals_an_uninterrupted_run():
    """A reduced rwkv6 learner as a real payload under the port's
    platform: the pod is killed after a checkpoint, the job restores it
    and completes; every loss (replayed steps included) and the final
    state equal, bit for bit, those of the same payload run without the
    platform."""
    rcfg, tcfg = _configs(rwkv_head_dim=16)
    init = jax.device_get(ref_steps.init_train_state(rcfg,
                                                     jax.random.key(0)))
    plain = _job_payload(tcfg, init)
    plain.restore(None)
    want = [plain.step(i) for i in range(JOB_STEPS)]

    payload = _job_payload(tcfg, init)
    p = port_core.DLaaSPlatform(seed=21)
    p.run(10)
    h = p.submit(port_core.JobManifest(
        name="rwkv", framework=ARCH, learners=1, total_steps=JOB_STEPS,
        step_time_s=0.5, checkpoint_interval_s=1.5, real_compute=True))
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
        np.testing.assert_array_equal(a, b, err_msg=pa)
