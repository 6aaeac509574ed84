"""The port's gemma2 training path against the JAX reference on the CPU.

The reference trains gemma2 by ``jax.grad`` through ``flash_attention_jnp``
(local layers over their window, global ones over the whole row, both
under the attention-logit softcap), the post-block norms and the
final-logit softcap.  The port runs its attention through the
``FlashAttention`` autograd Function, whose backward is
``flash_attention_bwd_torch`` on the CPU (the hd-256 kernel with the
softcap on a card, held against it by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``), and the final softcap through autograd.  Both
packages get the same numpy inputs: the reference's own weights
(converted by tree path, ``repro_torch.convert``) and batches.  The
reference runs with ``Ctx(mesh=None, dtype=float32)``; its gradients and
steps run under ``jax.jit``, its initial states are made once a module.

Covered, at ``.reduced()`` (local, global, local; window 16 under S 40,
so the local layers' window clips): the loss and every gradient by tree
path, the post-block norms' and the softcaps' part in them, three AdamW
steps at one microbatch and at the registered run's four, the remat
policies, the flash forwards a layer under full remat, the train state's
round trip and checkpoint bytes, the CLI, and a job under the port's
platform killed after a checkpoint.

Tolerances (fp32, sums in other orders than XLA's), as
``test_torch_recurrent_train.py``: the loss 1e-5 relative, each gradient
leaf within 1e-4 of its largest magnitude, grad norm 1e-4, lr 1e-6; over
three steps the weights within 1e-4 where the reference's gradient was
not below 1e-4 of its leaf's largest in some step (elsewhere within
2·lr a step: Adam's sign amplification), the moments within 1e-3 of each
leaf's largest.
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
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig, check_trainable, get_config, get_run_config)
from repro_torch.convert import (  # noqa: E402
    params_from_jax, params_to_jax, train_state_from_jax, train_state_to_jax)
from repro_torch.core.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.learner import RealPayload  # noqa: E402
from repro_torch.core.objectstore import ObjectStore  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Model, cast_params, compute_params, init_params, make_trainable)
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


CPU = torch.device("cpu")
CTX = Ctx(device=CPU, dtype=torch.float32)
RCTX = RefCtx(mesh=None, dtype=jnp.float32)
ARCH = "gemma2-9b"
GRAD_TOL = 1e-4


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _configs(**over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


@pytest.fixture(scope="module")
def ref_init():
    """The reference's initial train state at key 0 on the host, made once
    for the module: the gradient test takes its params, the platform job
    starts from the whole state.  Nothing writes to it (the port's
    conversion copies)."""
    rcfg, _ = _configs()
    return jax.device_get(ref_steps.init_train_state(rcfg,
                                                     jax.random.key(0)))


@pytest.fixture(scope="module")
def ref_init_steps():
    """The reference's initial train state at key 1 on the host, which the
    three-step tests start from at one and at four microbatches."""
    rcfg, _ = _configs()
    return jax.device_get(ref_steps.init_train_state(rcfg,
                                                     jax.random.key(1)))


def _weights(tcfg, rparams):
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(rparams, tcfg))
    return model


def _batch(rcfg, S=40, B=2, step=0, seed=3):
    b = RefData(rcfg.vocab_size, S, B, seed=seed).batch_at(step)
    b = {k: np.array(v) for k, v in b.items()}
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


# At init the reduced model's scores and logits are far below gemma2's caps
# (50, 30), where tanh is nearly the identity; the second case caps them
# where tanh bends, so its gradient's factor 1 - tanh^2 is far from 1.
CAPS = {"gemma2": {}, "binding": dict(attn_logit_softcap=0.05,
                                      final_logit_softcap=0.5)}


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_loss_and_gradients_match_reference_by_tree_path(ref_init, caps):
    """Reduced gemma2 (local, global, local: the group and a tail; window
    16 under S 40), masked labels: the loss and every gradient leaf,
    the post-block norms' and the attention's among them, under gemma2's
    softcaps and under caps that bind (the largest logit past half its
    cap)."""
    rcfg, tcfg = _configs(**CAPS[caps])
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
    for leaf in ("/post_norm", "/post_ffn_norm", "tail/0/attn/q",
                 "groups/1/attn/k"):
        assert any(leaf in p for p in want), leaf
    for path, w in want.items():
        _close(got[path], w, GRAD_TOL, path)
    with torch.no_grad():
        logits, _ = port_model.forward(tcfg, compute_params(
            model, torch.float32), tb, CTX, mode="train")
    top = float(logits[..., :tcfg.vocab_size].abs().max())
    assert top < tcfg.final_logit_softcap
    assert caps == "gemma2" or top > 0.5 * tcfg.final_logit_softcap


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


@pytest.mark.parametrize("n_mb", [1, 4])
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


def test_remat_full_runs_the_flash_forward_twice_a_layer(monkeypatch):
    """Flash forwards and backwards a step, each with the layer's window
    and the softcap: one forward and one backward a layer without remat,
    the forward twice under full remat; a served prefill runs one forward
    a layer and no backward."""
    _, tcfg = _configs()
    model = make_trainable(init_params(Model(tcfg, device=CPU), 0))
    _, tb = _batch(_configs()[0], S=24, B=2)
    calls = []

    def counted(name):
        orig = getattr(fa, name)

        def call(*a, **kw):
            calls.append((name, kw["window"], kw["logit_cap"]))
            return orig(*a, **kw)
        monkeypatch.setattr(fa, name, call)
    counted("flash_attention_torch")
    counted("flash_attention_bwd_torch")
    W, cap = tcfg.window_size, tcfg.attn_logit_softcap
    per_layer = sorted((0 if k == "global" else W, cap)
                       for k in tcfg.layer_kinds())
    for policy, twice in (("none", 1), ("full", 2)):
        calls.clear()
        loss, _ = steps.loss_fn(tcfg, compute_params(model, torch.float32),
                                tb, CTX, remat_policy=policy)
        torch.autograd.grad(loss, list(model.parameters()))
        fwd = sorted(c[1:] for c in calls if c[0] == "flash_attention_torch")
        bwd = sorted(c[1:] for c in calls
                     if c[0] == "flash_attention_bwd_torch")
        assert fwd == sorted(per_layer * twice), policy
        assert bwd == per_layer, policy
    calls.clear()
    cfg = dataclasses.replace(tcfg, cache_layout="paged")
    cache = port_model.init_cache(cfg, 2, 32, device=CPU)
    with torch.inference_mode():
        port_model.forward(cfg, cast_params(model, torch.float32),
                           {"tokens": tb["tokens"]}, CTX, mode="prefill",
                           cache=cache)
    assert sorted(c[1:] for c in calls) == per_layer
    assert {c[0] for c in calls} == {"flash_attention_torch"}


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
                    a.dtype), rstate["opt"]["v"]),
                "count": np.int32(5)},
        "step": np.int32(5),
    }


def test_train_state_round_trips_exactly_with_the_post_block_norms():
    rcfg, tcfg = _configs()
    tree = _random_state_tree(rcfg)
    dec = tree["params"]["decoder"]
    assert {"post_norm", "post_ffn_norm"} <= set(dec["groups"]["1"])
    assert {"post_norm", "post_ffn_norm"} <= set(dec["tail"]["0"])
    state = train_state_from_jax(tree, tcfg, device=CPU)
    blocks = state["params"].blocks
    np.testing.assert_array_equal(blocks[1].post_norm.detach().numpy(),
                                  dec["groups"]["1"]["post_norm"][0])
    np.testing.assert_array_equal(blocks[2].post_ffn_norm.detach().numpy(),
                                  dec["tail"]["0"]["post_ffn_norm"])
    np.testing.assert_array_equal(
        state["opt"]["m"]["blocks.0.post_norm"].numpy(),
        tree["opt"]["m"]["decoder"]["groups"]["0"]["post_norm"][0])
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


def test_cli_trains_gemma2_on_the_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", "4", "--seq", "40",
                           "--microbatches", "4", "--remat", "full",
                           "--layers", "2", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "gemma2-9b-reduced" in out and "steps/s" in out
    assert "(cut to 2 layers)" in out
    assert out.count("  step ") == 3
    run = get_run_config(ARCH, "train_4k")
    assert (run.num_microbatches, run.remat_policy) == (4, "full")
    assert (run.master_dtype, run.opt_dtype) == ("float32", "float32")
    check_trainable(get_config(ARCH))


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


def test_gemma2_job_killed_after_a_checkpoint_equals_an_uninterrupted_run(
        ref_init):
    """A reduced gemma2 learner as a real payload under the port's
    platform (the registry admits gemma2-9b): the pod is killed after a
    checkpoint, the job restores it and completes; every loss (replayed
    steps included) and the final state equal, bit for bit, those of the
    same payload run without the platform."""
    _, tcfg = _configs()
    init = ref_init
    plain = _job_payload(tcfg, init)
    plain.restore(None)
    want = [plain.step(i) for i in range(JOB_STEPS)]

    payload = _job_payload(tcfg, init)
    p = port_core.DLaaSPlatform(seed=21)
    p.run(10)
    h = p.submit(port_core.JobManifest(
        name="gemma2", framework=ARCH, learners=1, total_steps=JOB_STEPS,
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
