"""The port's training path against the JAX reference on the CPU.

The reference's own weights and train state are converted by tree path
(``repro_torch.convert``) and both sides run in fp32 on the reference's
own batches (the port's data stream is drawn with numpy, ROADMAP D10).
The reference runs with ``Ctx(mesh=None, dtype=float32)``.  Covered: the
train-mode logits, the loss and every gradient leaf, three AdamW steps
with one and two microbatches (loss, grad norm and lr each step, then
weights and moments), the schedule and the update on their own, remat,
the data contract, the train-state round trip, the CLI and the configs
this slice refuses.

Tolerances (fp32, sums in another order than XLA's):
* logits 1e-4 absolute (as ``tests/test_torch_model.py``);
* loss and grad norm 1e-5 relative, lr 1e-6 relative;
* each gradient leaf within 1e-4 of that leaf's largest magnitude;
* after three steps, the weights within 1e-5 absolute, except where Adam
  amplifies gradient noise: an element whose gradients are within the
  fp32 noise of zero moves by m / sqrt(v) ~ sign(g) lr, so a sign flip
  there is up to 2 lr a step.  Each leaf may hold such elements only
  where the reference's own gradient was below 1e-4 of the leaf's
  largest in some step, and they stay within 2 lr x steps; the moments
  within 1e-4 of each leaf's largest magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RefData  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig, check_trainable, get_config, get_run_config, list_configs)
from repro_torch.convert import (  # noqa: E402
    params_from_jax, params_to_jax, train_state_from_jax, train_state_to_jax)
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
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

# as tests/test_torch_model.py: the dense configs at .reduced(), and
# paper-overhead, qwen2.5-32b, mistral-large-123b and internvl2-76b
# narrowed with their own groups kept (G 3, 5, 12 and 8; qwen2.5's qkv bias
# comes along); internvl2's batches carry its frontend embeddings
CASES = {
    "qwen3": ("qwen3-0.6b", {}),
    "paper": ("paper-overhead-100m", {}),
    "paper-g3": ("paper-overhead-100m", dict(num_heads=6, num_kv_heads=2)),
    "qwen2.5-g5": ("qwen2.5-32b", dict(num_heads=10, num_kv_heads=2)),
    "mistral-g12": ("mistral-large-123b", dict(num_heads=24,
                                               num_kv_heads=2)),
    "internvl2-g8": ("internvl2-76b", dict(num_heads=16, num_kv_heads=2)),
}


def _configs(name):
    arch, narrow = CASES[name]
    over = dict(dtype="float32", **narrow)
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _batch(rcfg, S=24, B=2, step=0):
    """The reference's batch; under a vision frontend also seeded patch
    embeddings (0.02·N(0, 1), as the reference's tests draw them)."""
    b = RefData(rcfg.vocab_size, S, B, seed=3).batch_at(step)
    b = {k: np.array(v) for k, v in b.items()}
    t = {k: torch.from_numpy(v).long() for k, v in b.items()}
    if rcfg.frontend == "vision":
        b["frontend_embeds"] = (0.02 * np.random.default_rng(step).normal(
            size=(B, rcfg.frontend_tokens, rcfg.d_model))).astype(np.float32)
        t["frontend_embeds"] = torch.from_numpy(b["frontend_embeds"])
    return b, t


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    rcfg, tcfg = _configs(request.param)
    rparams = ref_init_params(rcfg, jax.random.key(0))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rcfg, tcfg, rparams, make_trainable(model)


def test_train_logits_match_reference(pair):
    rcfg, tcfg, rparams, model = pair
    rb, tb = _batch(rcfg)
    want, _, _ = ref_model.forward(rcfg, rparams, rb, RCTX, mode="train")
    got, aux = port_model.forward(tcfg, compute_params(model, torch.float32),
                                  tb, CTX, mode="train")
    assert got.shape == want.shape == (2, 24, tcfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-4,
                               rtol=0)


def test_loss_and_gradients_match_reference_by_tree_path(pair):
    rcfg, tcfg, rparams, model = pair
    rb, tb = _batch(rcfg)
    rb["labels"][0, :5] = -1                 # masked labels count for nothing
    tb["labels"][0, :5] = -1
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_steps.loss_fn(rcfg, p, rb, RCTX), has_aux=True))(
        rparams)
    names, leaves = zip(*model.named_parameters())
    loss, met = steps.loss_fn(tcfg, compute_params(model, torch.float32), tb,
                              CTX)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"].detach()), float(rmet["ce"]),
                               rtol=1e-5)
    got = dict(_leaves(params_to_jax(dict(zip(names, grads)), tcfg)))
    want = dict(_leaves(jax.device_get(rgrads)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (path, err)


def _run_steps(rcfg, tcfg, n_mb, n_steps=3):
    run = RefRunConfig(num_microbatches=n_mb, learning_rate=1e-3,
                       warmup_steps=2, total_steps=n_steps)
    rstate = ref_steps.init_train_state(rcfg, jax.random.key(1), run)
    tstate = train_state_from_jax(jax.device_get(rstate), tcfg, device=CPU)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, RCTX, run))
    tstep = steps.make_train_step(
        tcfg, CTX, RunConfig(num_microbatches=n_mb, learning_rate=1e-3,
                             warmup_steps=2, total_steps=n_steps))
    rgrad = jax.jit(jax.grad(
        lambda p, b: ref_steps.loss_fn(rcfg, p, b, RCTX)[0]))
    data = RefData(rcfg.vocab_size, 16, 4, seed=5)
    small = []                      # per step: where |g_ref| < 1e-4 max
    for i in range(n_steps):
        batch = {k: np.array(v) for k, v in data.batch_at(i).items()}
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        rgrads = rgrad(rstate["params"], batch) if n_mb == 1 else None
        rstate, rm = rstep(rstate, batch)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"grad norm, step {i}")
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=1e-6, err_msg=f"lr, step {i}")
        if rgrads is not None:
            small.append({p: np.abs(g) < 1e-4 * np.abs(g).max()
                          for p, g in _leaves(jax.device_get(rgrads))})
    return jax.device_get(rstate), train_state_to_jax(tstate, tcfg), small


@pytest.mark.parametrize("name,n_mb", [("qwen3", 1), ("paper-g3", 1),
                                       ("paper", 2), ("qwen3", 2),
                                       ("qwen2.5-g5", 1),
                                       ("mistral-g12", 2)])
def test_three_train_steps_match_reference(name, n_mb):
    rcfg, tcfg = _configs(name)
    rstate, tstate, small = _run_steps(rcfg, tcfg, n_mb)
    assert int(tstate["step"]) == int(rstate["step"]) == 3
    assert int(tstate["opt"]["count"]) == int(rstate["opt"]["count"]) == 3
    got = dict(_leaves(tstate["params"]))
    for path, w in _leaves(rstate["params"]):
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w)
        assert err.max() <= 2 * 1e-3 * 3, (path, err.max())
        off = err > 1e-5
        if small:
            noisy = np.any([s[path] for s in small], axis=0)
            assert not np.any(off & ~noisy), (path, err[~noisy].max())
        else:               # two microbatches: no per-step gradient kept
            assert off.mean() <= 1e-3, (path, off.sum())
    for part in ("m", "v"):
        got = dict(_leaves(tstate["opt"][part]))
        for path, w in _leaves(rstate["opt"][part]):
            w = np.asarray(w, np.float32)
            err = np.abs(got[path] - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (part, path,
                                                               err)


def test_schedule_and_adamw_update_match_reference():
    cfg = dict(learning_rate=1e-3, warmup_steps=3, total_steps=10)
    rcfg = ref_adamw.AdamWConfig(**cfg)
    tcfg = adamw.AdamWConfig(**cfg)
    for s in range(13):
        np.testing.assert_allclose(
            float(adamw.cosine_schedule(tcfg, torch.tensor(s))),
            float(ref_adamw.cosine_schedule(rcfg, jnp.int32(s))), rtol=1e-6)
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "e": (3, 2, 4)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    rp, rs = {n: jnp.asarray(a) for n, a in p0.items()}, None
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    rs = ref_adamw.adamw_init(rp)
    ts = adamw.adamw_init(tp)
    for step in range(3):
        # the second step's gradients are large enough to be clipped
        g = {n: (rng.normal(size=s) * (3.0 if step == 1 else 0.1)
                 ).astype(np.float32) for n, s in shapes.items()}
        rp, rs, rm = ref_adamw.adamw_update(
            rcfg, {n: jnp.asarray(a) for n, a in g.items()}, rp, rs)
        ts, tm = adamw.adamw_update(
            tcfg, {n: torch.from_numpy(a) for n, a in g.items()}, tp, ts)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                       rtol=1e-6)
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), _np(rp[n]), atol=1e-6)
            np.testing.assert_allclose(ts["m"][n].numpy(), _np(rs["m"][n]),
                                       atol=1e-7)
            np.testing.assert_allclose(ts["v"][n].numpy(), _np(rs["v"][n]),
                                       atol=1e-7)
    assert int(ts["count"]) == int(rs["count"]) == 3


def test_remat_policies_give_equal_gradients():
    _, tcfg = _configs("paper-g3")
    model = make_trainable(port_model.init_params(Model(tcfg, device=CPU), 0))
    _, tb = _batch(_configs("paper-g3")[0], S=20)
    names, leaves = zip(*model.named_parameters())
    grads = {}
    for policy in ("none", "full", "dots"):
        loss, _ = steps.loss_fn(tcfg, compute_params(model, torch.float32),
                                tb, CTX, remat_policy=policy)
        grads[policy] = torch.autograd.grad(loss, leaves)
    for policy in ("full", "dots"):
        for n, a, b in zip(names, grads["none"], grads[policy]):
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=n)
    with pytest.raises(ValueError, match="remat_policy"):
        steps.loss_fn(tcfg, compute_params(model, torch.float32), tb, CTX,
                      remat_policy="some")


def test_synthetic_data_is_a_pure_function_of_seed_and_step():
    data = SyntheticLMData(vocab_size=997, seq_len=64, global_batch=8, seed=4)
    a, b = data.batch_at(3), data.batch_at(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], data.batch_at(4)["tokens"])
    other = SyntheticLMData(997, 64, 8, seed=5).batch_at(3)
    assert not torch.equal(a["tokens"], other["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (8, 64)
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    toks = torch.cat([a["tokens"], a["labels"][:, -1:]], 1).numpy()
    assert toks.min() >= 0 and toks.max() < 997
    chain = (31 * toks[:, :-1] + 17) % 997 == toks[:, 1:]
    # a step follows the chain unless it was resampled (noise 0.1; a
    # resample hits the chain's value with probability 1 / V)
    assert chain.mean() >= 1 - 0.1 - 0.03, chain.mean()


def test_train_state_round_trips_exactly():
    rcfg, tcfg = _configs("paper-g3")
    rstate = jax.device_get(ref_steps.init_train_state(rcfg,
                                                       jax.random.key(2)))
    rng = np.random.default_rng(1)
    tree = {
        "params": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            a.dtype), rstate["params"]),
        "opt": {"m": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
                    a.dtype), rstate["opt"]["m"]),
                # bf16 moments (a run's opt_dtype) keep their type
                "v": jax.tree.map(lambda a: rng.random(size=a.shape).astype(
                    jnp.bfloat16), rstate["opt"]["v"]),
                "count": np.int32(7)},
        "step": np.int32(7),
    }
    back = train_state_to_jax(train_state_from_jax(tree, tcfg, device=CPU),
                              tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(_leaves(tree), _leaves(back)):
        assert pa == pb
        assert a.dtype == b.dtype and a.shape == b.shape, pa
        np.testing.assert_array_equal(a, b, err_msg=pa)


def test_cli_trains_on_the_cpu_and_needs_a_device_without_a_card(
        capsys, monkeypatch):
    assert train_cli.main(["--reduced", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq", "16",
                           "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "paper-overhead-100m-reduced" in out and "steps/s" in out
    assert out.count("  step ") == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1"])


def test_configs_this_slice_does_not_train_are_refused():
    """Every registered config trains; what the port lacks (the audio
    frontend without an encoder, the vision frontend on an MoE stack, an
    encoder-decoder on MoE, a recurrent layer mixed with a global one) is
    refused by name, also when a train state is built."""
    assert len(list_configs()) == 11
    for arch in list_configs():
        check_trainable(get_config(arch))
    base = get_config("qwen3-0.6b").reduced()
    for over in (dict(attn_logit_softcap=30.0), dict(final_logit_softcap=5.0),
                 dict(frontend="vision", frontend_tokens=4),
                 dict(is_encoder_decoder=True, num_encoder_layers=2,
                      frontend="audio")):
        check_trainable(dataclasses.replace(base, **over))
    for over, what in ((dict(frontend="audio", frontend_tokens=4),
                        "the audio frontend"),
                       (dict(frontend="vision", frontend_tokens=4,
                             num_experts=4, num_experts_per_tok=2,
                             moe_d_ff=32),
                        "the vision frontend on MoE"),
                       (dict(is_encoder_decoder=True, num_encoder_layers=2,
                             num_experts=4, num_experts_per_tok=2,
                             moe_d_ff=32),
                        "an encoder-decoder on MoE"),
                       (dict(block_pattern=("recurrent", "global")),
                        r"block kinds \['global', 'recurrent'\]")):
        cfg = dataclasses.replace(base, **over)
        with pytest.raises(NotImplementedError, match=what):
            check_trainable(cfg)
        with pytest.raises(NotImplementedError, match=what):
            steps.init_train_state(cfg, device=CPU)
    # gradient compression is taken (dist/compression.py): the state
    # carries error buffers, and a step fills them
    run = RunConfig(grad_compression="int8")
    state = steps.init_train_state(base, device=CPU, run=run)
    _, tb = _batch(_configs("qwen3")[0], S=8, B=2)
    state, m = steps.make_train_step(base, CTX, run)(state, tb)
    assert int(state["step"]) == 1 and np.isfinite(float(m["loss"]))
    assert set(state["err"]) == set(state["opt"]["m"])
    assert any(e.abs().max() > 0 for e in state["err"].values())
    run = get_run_config("qwen3-0.6b", "train_4k")
    assert (run.num_microbatches, run.remat_policy) == (2, "full")
    assert get_run_config("paper-overhead-100m", "train_4k").remat_policy \
        == "full"
