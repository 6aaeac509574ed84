"""The port's recurrentgemma training path against the JAX reference on the
CPU.

The reference trains the RG-LRU hybrid by ``jax.grad`` through its jnp
``models/recurrent.py:rglru_scan_assoc`` and ``flash_attention_jnp``; the
port runs ``ops.rglru_scan_bsr`` through the ``RGLRUScan`` autograd
Function, whose backward is ``rglru_scan_bwd_torch`` on the CPU (the
CUDA kernel on a card, held against it by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``), and its local layers through ``FlashAttention`` over
their window.  Both packages get the same numpy inputs: the reference's
own weights (converted by tree path, ``repro_torch.convert``) and
batches.  The reference runs with ``Ctx(mesh=None, dtype=float32)``.

Covered: the plain RG-LRU backward and the Function's CPU backward
against ``jax.grad`` of ``rglru_scan_assoc`` (S 1, 37, 80; h0 zero and
nonzero; padding steps; strong decays); the Function's and the backward
wrapper's contracts; ``rglru_block``'s gradients; reduced
``recurrentgemma-9b``'s loss and every gradient by tree path, three AdamW
steps with one and two microbatches, remat; the train state's round trip
and checkpoint bytes; the CLI; a job under the port's platform killed
after a checkpoint; ``check_trainable``'s reach.

Tolerances (fp32; the backward walks the steps in reverse where the
reference differentiates its doubling scan, and sums in other orders):
* the scan's gradients within 1e-5 of each gradient's largest magnitude;
* the block's and the model's gradients within 1e-4 of each leaf's
  largest magnitude; loss 1e-5 relative, grad norm 1e-4, lr 1e-6;
* over three AdamW steps the weights within 1e-4 where the reference's
  gradient was not below 1e-4 of its leaf's largest in some step
  (elsewhere within 2·lr a step: Adam's sign amplification), the moments
  within 1e-3 of each leaf's largest.
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
from repro.models import recurrent as ref_rec  # noqa: E402
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import recurrent as port_rec  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Model, cast_params, compute_params, init_params, make_trainable)
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


CPU = torch.device("cpu")
CTX = Ctx(device=CPU, dtype=torch.float32)
RCTX = RefCtx(mesh=None, dtype=jnp.float32)
ARCH = "recurrentgemma-9b"
SCAN_GRAD_TOL = 1e-5
GRAD_TOL = 1e-4


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
# The RG-LRU scan's backward
# ---------------------------------------------------------------------------
def _scan_case(seed, B, S, R, decay="init", pad_from=None):
    """log_a on half the channels as the model draws it at init (8·r·log
    σ(Λ), σ(Λ) in [0.9, 0.999]) and on the rest -U(1, 20) ("init"), or
    -exp(U(-6, ln 8 + 4)) everywhere, down to -8·e^4 ("strong"); b, dh ~
    N(0, 1); h0 ~ 3·N(0, 1); row 0 padded from ``pad_from`` (log_a = 0,
    b = 0)."""
    rng = np.random.default_rng(seed)
    if decay == "init":
        lam = rng.uniform(0.9, 0.999, size=(R,))
        log_a = 8.0 * rng.uniform(0, 1, size=(B, S, R)) * np.log(lam)
        log_a[..., R // 2:] = -rng.uniform(1, 20, size=(B, S, R - R // 2))
    else:
        log_a = -np.exp(rng.uniform(-6, np.log(8.0) + 4, size=(B, S, R)))
    b = rng.normal(size=(B, S, R))
    dh = rng.normal(size=(B, S, R))
    h0 = 3.0 * rng.normal(size=(B, R))
    if pad_from is not None:
        log_a[0, pad_from:] = 0
        b[0, pad_from:] = 0
    return [a.astype(np.float32) for a in (log_a, b, dh, h0)]


def _jax_scan_grads(log_a, b, dh, h0):
    """``jax.grad`` of sum(h · dh) through the reference's associative
    scan: (dlog_a, db) and dh0 when ``h0`` is given."""
    if h0 is None:
        return jax.jit(jax.grad(lambda la, bb: (
            ref_rec.rglru_scan_assoc(la, bb) * dh).sum(), argnums=(0, 1)))(
            jnp.asarray(log_a), jnp.asarray(b))
    return jax.jit(jax.grad(lambda la, bb, h: (
        ref_rec.rglru_scan_assoc(la, bb, h) * dh).sum(),
        argnums=(0, 1, 2)))(jnp.asarray(log_a), jnp.asarray(b),
                            jnp.asarray(h0))


@pytest.mark.parametrize("decay", ["init", "strong"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("S", [1, 37, 80])
def test_rglru_plain_backward_and_function_match_jax_grad(S, with_h0, decay):
    """The plain reverse loop, and the Function's backward on CPU tensors,
    against ``jax.grad`` of the reference's associative scan; row 0 is
    padded over its last steps."""
    log_a, b, dh, h0 = _scan_case(S + 7 * with_h0, 2, S, 48, decay,
                                  pad_from=max(S - 9, 1) if S > 1 else None)
    h0 = h0 if with_h0 else None
    want = _jax_scan_grads(log_a, b, dh, h0)
    h = rg.rglru_scan_torch(_t(log_a), _t(b), None if h0 is None else _t(h0))
    plain = rg.rglru_scan_bwd_torch(_t(log_a), h, _t(dh),
                                    None if h0 is None else _t(h0))
    assert (plain[2] is None) == (h0 is None)
    leaves = [_t(a).requires_grad_(True) for a in (log_a, b)] \
        + ([] if h0 is None else [_t(h0).requires_grad_(True)])
    out = ops.rglru_scan_bsr(*leaves)
    fn = torch.autograd.grad(out, leaves, _t(dh))
    for name, p, f, w in zip(("dlog_a", "db", "dh0"), plain, fn, want):
        assert bool(torch.isfinite(p).all()), name
        _close(p.numpy(), _np(w), SCAN_GRAD_TOL, f"{name} vs jax.grad")
        assert torch.equal(f, p), f"{name}: the Function differs"


def test_rglru_padding_steps_pass_the_carry_through():
    """Past a row's length (log_a = 0, b = 0) the backward's carry is
    the running sum of dh: db at the last valid step is dh there plus the
    padding steps' dh, and dlog_a there is unchanged by them."""
    log_a, b, dh, h0 = map(_t, _scan_case(3, 1, 30, 16, pad_from=20))
    h = rg.rglru_scan_torch(log_a, b, h0)
    dla, db, dh0 = rg.rglru_scan_bwd_torch(log_a, h, dh, h0)
    torch.testing.assert_close(db[0, 20:], dh[0, 20:].flip(0).cumsum(0)
                               .flip(0), rtol=1e-6, atol=1e-6)
    dh_cut = dh[:, :20].clone()
    dh_cut[:, 19] += dh[:, 20:].sum(1)
    cut = rg.rglru_scan_bwd_torch(log_a[:, :20], h[:, :20], dh_cut, h0)
    for name, a, c in zip(("dlog_a", "db"), (dla, db), cut):
        torch.testing.assert_close(a[:, :20], c, rtol=1e-6, atol=1e-6,
                                   msg=name)
    torch.testing.assert_close(dh0, cut[2], rtol=1e-6, atol=1e-6)


def test_rglru_function_is_taken_only_for_training():
    """With grad on, ``ops.rglru_scan_bsr`` goes through ``RGLRUScan``:
    the same forward as without grad, no kernel launch on CPU tensors;
    under ``inference_mode`` (serving) it is the plain forward with no
    graph."""
    log_a, b, dh, _ = _scan_case(5, 2, 45, 32)
    leaves = [_t(a).requires_grad_(True) for a in (log_a, b)]
    ops.reset_launches()
    h = ops.rglru_scan_bsr(*leaves)
    assert h.grad_fn is not None \
        and type(h.grad_fn).__name__ == "RGLRUScanBackward"
    with torch.no_grad():
        assert ops.rglru_scan_bsr(*leaves).grad_fn is None
    torch.autograd.grad(h, leaves, _t(dh))
    with torch.inference_mode():
        served = ops.rglru_scan_bsr(*leaves)
    assert served.grad_fn is None and torch.equal(served, h.detach())
    h_plain = ops.rglru_scan_bsr(*(t.detach() for t in leaves))
    assert h_plain.grad_fn is None and torch.equal(h_plain, h.detach())
    assert ops.launches["rglru_scan_bsr"] == 0
    assert ops.launches["rglru_scan_bwd"] == 0


def test_rglru_bwd_wrapper_refuses_and_never_takes_the_plain_version_off_cpu(
        monkeypatch):
    log_a, b, dh, h0 = map(_t, _scan_case(1, 2, 8, 16))
    h = rg.rglru_scan_torch(log_a, b, h0)
    with pytest.raises(ValueError, match="shapes"):
        ops.rglru_scan_bwd(log_a, h[:, :-1], dh, h0)
    with pytest.raises(ValueError, match="fp32"):
        ops.rglru_scan_bwd(log_a, h, dh.bfloat16(), h0)
    with pytest.raises(ValueError, match="fp32"):
        ops.rglru_scan_bwd(log_a, h, dh, h0.double())
    with pytest.raises(ValueError, match="h0"):
        ops.rglru_scan_bwd(log_a, h, dh, h0[:1])

    def plain(*a, **kw):
        raise AssertionError("a tensor off the CPU reached the plain version")
    monkeypatch.setattr(rg, "rglru_scan_bwd_torch", plain)
    monkeypatch.setattr(rg, "rglru_scan_torch", plain)
    meta = [t.to("meta") for t in (log_a, h, dh, h0)]
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        ops.rglru_scan_bwd(*meta)
    leaves = [t.to("meta").requires_grad_(True) for t in (log_a, b)]
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        ops.rglru_scan_bsr(*leaves)


# ---------------------------------------------------------------------------
# The recurrent block: gradients
# ---------------------------------------------------------------------------
def _configs(**over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


@pytest.fixture(scope="module")
def ref_init():
    """The reference's initial train state at key 0 on the host, made once
    for the module: its params are ``init_params(rcfg, key 0)`` (fp32
    master weights), which the block's and the model's gradient tests
    take, and the platform job starts from the whole state.  Nothing
    writes to it (the port's conversion copies)."""
    rcfg, _ = _configs()
    return jax.device_get(ref_steps.init_train_state(rcfg,
                                                     jax.random.key(0)))


@pytest.fixture(scope="module")
def ref_init_steps():
    """The reference's initial train state at key 1 on the host, which the
    three-step tests start from at one and at two microbatches (their run
    configs differ only in the microbatches, which the state does not
    depend on)."""
    rcfg, _ = _configs()
    return jax.device_get(ref_steps.init_train_state(rcfg,
                                                     jax.random.key(1)))


def _weights(tcfg, rparams):
    """The port's model holding the reference's params (converted)."""
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(rparams, tcfg))
    return model


def test_ref_init_is_the_reference_s_init_params(ref_init):
    """The shared state's params are ``init_params(rcfg, key 0)``, bit for
    bit: what the gradient tests drew before they shared it."""
    rcfg, _ = _configs()
    want = dict(_leaves(jax.device_get(ref_init_params(
        rcfg, jax.random.key(0)))))
    got = dict(_leaves(ref_init["params"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.mark.parametrize("S", [1, 21])
def test_rglru_block_gradients_match_jax_grad(S, ref_init):
    """Gradients of a weighted sum of the block's output (full mode, no
    cache) with respect to its input and every leaf."""
    rcfg, tcfg = _configs()
    rparams = ref_init["params"]
    rp = jax.tree.map(lambda a: a[0], rparams["decoder"]["groups"]["1"]["rec"])
    rng = np.random.default_rng(S)
    u = rng.normal(size=(2, S, rcfg.d_model)).astype(np.float32)
    w = rng.normal(size=u.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda p, x: (ref_rec.rglru_block(
        rcfg, p, x, RCTX, mode="full", cache=None)[0] * w).sum(),
        argnums=(0, 1)))(rp, jnp.asarray(u))
    tp = {n: _t(_np(a)).requires_grad_(True) for n, a in rp.items()}
    ut = _t(u).requires_grad_(True)
    y, cache = port_rec.rglru_block(tcfg, tp, ut, CTX, mode="full",
                                    cache=None)
    assert cache is None
    names = sorted(tp)
    got = torch.autograd.grad((y * _t(w)).sum(), [tp[n] for n in names]
                              + [ut])
    assert {"rglru_lambda", "gate_r", "gate_i", "conv_w", "wx"} <= set(names)
    for n, g in zip(names, got):
        _close(g.numpy(), _np(want[0][n]), GRAD_TOL, n)
    _close(got[-1].numpy(), _np(want[1]), GRAD_TOL, "u")


# ---------------------------------------------------------------------------
# Reduced recurrentgemma-9b: loss, gradients, AdamW steps, remat
# ---------------------------------------------------------------------------
def _batch(rcfg, S=40, B=2, step=0, seed=3):
    b = RefData(rcfg.vocab_size, S, B, seed=seed).batch_at(step)
    b = {k: np.array(v) for k, v in b.items()}
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


def test_loss_and_gradients_match_reference_by_tree_path(ref_init):
    """Reduced recurrentgemma (R, R, L, R: the groups and a tail; window
    16 under S 40, so the local layer's window clips), masked labels."""
    rcfg, tcfg = _configs()
    rparams = ref_init["params"]
    model = make_trainable(_weights(tcfg, rparams))
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
    assert any("/rec/rglru_lambda" in p for p in want)
    assert any("tail/0/rec" in p for p in want)
    assert any("/attn/k" in p for p in want)
    for path, w in want.items():
        _close(got[path], w, GRAD_TOL, path)


def run_steps(rcfg, tcfg, init, n_mb, n_steps, lr=1e-3, B=4, S=40):
    """``n_steps`` AdamW steps of both packages from the reference's
    initial state ``init`` (a host tree) on the reference's batches: both
    final states (numpy trees), each step's (port, reference) metrics
    and, with one microbatch, where each step's reference gradient was
    below 1e-4 of its leaf's largest."""
    run = RefRunConfig(num_microbatches=n_mb, learning_rate=lr,
                       warmup_steps=2, total_steps=n_steps)
    rstate = jax.tree.map(jnp.asarray, init)
    tstate = train_state_from_jax(init, tcfg, device=CPU)
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
def test_three_train_steps_match_reference(n_mb, ref_init_steps):
    rcfg, tcfg = _configs()
    lr, n_steps = 1e-3, 3
    rstate, tstate, metrics, small = run_steps(rcfg, tcfg, ref_init_steps,
                                               n_mb, n_steps, lr=lr)
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
    _, tcfg = _configs()
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


def test_remat_full_runs_the_rglru_and_flash_forwards_twice_a_layer(
        monkeypatch):
    """RG-LRU and flash forwards and backwards a step: one a layer of
    their kind each without remat, the forwards twice under full remat;
    a served prefill runs each forward once a layer and no backward."""
    _, tcfg = _configs()
    model = make_trainable(init_params(Model(tcfg, device=CPU), 0))
    _, tb = _batch(_configs()[0], S=24, B=2)
    calls = []

    def counted(mod, name):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **kw: (
            calls.append(name), orig(*a, **kw))[1])
    counted(rg, "rglru_scan_torch")
    counted(rg, "rglru_scan_bwd_torch")
    counted(fa, "flash_attention_torch")
    counted(fa, "flash_attention_bwd_torch")
    kinds = tcfg.layer_kinds()
    n_rec, n_loc = kinds.count("recurrent"), kinds.count("local")
    assert (n_rec, n_loc) == (3, 1)
    for policy, twice in (("none", 1), ("full", 2)):
        calls.clear()
        loss, _ = steps.loss_fn(tcfg, compute_params(model, torch.float32),
                                tb, CTX, remat_policy=policy)
        torch.autograd.grad(loss, list(model.parameters()))
        assert calls.count("rglru_scan_torch") == twice * n_rec, policy
        assert calls.count("rglru_scan_bwd_torch") == n_rec, policy
        assert calls.count("flash_attention_torch") == twice * n_loc, policy
        assert calls.count("flash_attention_bwd_torch") == n_loc, policy
    calls.clear()
    cfg = dataclasses.replace(tcfg, cache_layout="paged")
    cache = port_model.init_cache(cfg, 2, 32, device=CPU)
    with torch.inference_mode():
        port_model.forward(cfg, cast_params(model, torch.float32),
                           {"tokens": tb["tokens"]}, CTX, mode="prefill",
                           cache=cache)
    assert sorted(calls) == sorted(["rglru_scan_torch"] * n_rec
                                   + ["flash_attention_torch"] * n_loc)


# ---------------------------------------------------------------------------
# Train state, checkpoints, the CLI, the platform and check_trainable
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


def test_train_state_round_trips_exactly_with_the_rec_and_local_leaves():
    rcfg, tcfg = _configs()
    tree = _random_state_tree(rcfg)
    dec = tree["params"]["decoder"]
    rec, attn = dec["groups"]["0"]["rec"], dec["groups"]["2"]["attn"]
    assert {"rglru_lambda", "gate_r", "conv_w", "conv_b"} <= set(rec)
    assert {"q", "k", "v", "o"} <= set(attn)
    assert "rec" in dec["tail"]["0"]
    state = train_state_from_jax(tree, tcfg, device=CPU)
    blocks = state["params"].blocks
    np.testing.assert_array_equal(
        blocks[0].rec.rglru_lambda.detach().numpy(), rec["rglru_lambda"][0])
    np.testing.assert_array_equal(blocks[2].attn.k.detach().numpy(),
                                  attn["k"][0])
    np.testing.assert_array_equal(
        blocks[3].rec.conv_w.detach().numpy(),
        dec["tail"]["0"]["rec"]["conv_w"])
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


def test_cli_trains_recurrentgemma_on_the_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", "4", "--seq", "64",
                           "--microbatches", "2", "--remat", "full",
                           "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "recurrentgemma-9b-reduced" in out and "steps/s" in out
    assert out.count("  step ") == 3
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "40",
                           "--layers", "3", "--log-every", "1"]) == 0
    assert "(cut to 3 layers)" in capsys.readouterr().out
    run = get_run_config(ARCH, "train_4k")
    assert (run.num_microbatches, run.remat_policy) == (2, "full")
    assert (run.master_dtype, run.opt_dtype) == ("float32", "float32")


def test_check_trainable_takes_the_hybrid_and_refuses_the_rest_by_name():
    """recurrentgemma trains, full and reduced; a mix of recurrent and
    global layers (alone or beside local ones), encoder-decoders and
    frontends are refused by name."""
    check_trainable(get_config(ARCH))
    check_trainable(get_config(ARCH).reduced())
    base = get_config(ARCH).reduced()
    for over, what in ((dict(block_pattern=("recurrent", "global")),
                        r"block kinds \['global', 'recurrent'\]"),
                       (dict(block_pattern=("recurrent", "local", "global")),
                        r"block kinds \['global', 'local', 'recurrent'\]"),
                       (dict(is_encoder_decoder=True, num_encoder_layers=2),
                        "encoder-decoder"),
                       (dict(frontend="vision", frontend_tokens=4),
                        "frontend")):
        with pytest.raises(NotImplementedError, match=what):
            check_trainable(dataclasses.replace(base, **over))


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


def test_recurrentgemma_job_killed_after_a_checkpoint_equals_an_uninterrupted_run(
        ref_init):
    """A reduced recurrentgemma learner as a real payload under the port's
    platform: the pod is killed after a checkpoint, the job restores it
    and completes; every loss (replayed steps included) and the final
    state equal, bit for bit, those of the same payload run without the
    platform."""
    _, tcfg = _configs()
    init = ref_init
    plain = _job_payload(tcfg, init)
    plain.restore(None)
    want = [plain.step(i) for i in range(JOB_STEPS)]

    payload = _job_payload(tcfg, init)
    p = port_core.DLaaSPlatform(seed=21)
    p.run(10)
    h = p.submit(port_core.JobManifest(
        name="rgemma", framework=ARCH, learners=1, total_steps=JOB_STEPS,
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
