"""The port's MoE training path (capacity dispatch and the router's
load-balancing aux loss) against the JAX reference on the CPU.

Both packages get the same numpy inputs from a seed: the reference's own
weights (converted by tree path, ``repro_torch.convert``) and batches
(the port's data stream is drawn with numpy, ROADMAP D10).  The reference
runs with ``Ctx(mesh=None, dtype=float32)``; ``moe_ffn(dropless=False)``
is what its train mode calls.  Covered: the MoE train function (one group
a row, several groups a row, drops forced by a small capacity factor and
by a router biased toward one expert, the shared experts of deepseek-v2's
MoE block) and its gradients; reduced ``granite-moe-1b-a400m``'s logits,
loss and every gradient leaf, three AdamW steps with one and two
microbatches; remat; the train-state round trip and the checkpoint bytes;
the CLI; a job under the port's platform killed after a checkpoint.

Tolerances (fp32, sums in another order than XLA's; as
``tests/test_torch_train.py``):
* outputs within 1e-5 of the largest magnitude of the reference's
  output, aux within 1e-5 relative;
* each gradient leaf within 1e-4 of that leaf's largest magnitude;
* logits 1e-4 absolute; loss and grad norm 1e-5 relative, lr 1e-6;
* after three steps, the weights and moments as in
  ``tests/test_torch_train.py`` (Adam's sign amplification only where the
  reference's own gradient was below 1e-4 of the leaf's largest).
Routing must agree: each case's inputs keep the margin between the k-th
and the (k+1)-th router probability above ``MARGIN``, far above the
fp32 noise of the router's products, and the test checks that it does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.core.checkpoint import CheckpointManager as RefCkpt  # noqa: E402
from repro.core.objectstore import ObjectStore as RefStore  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RefData  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
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
from repro_torch.core.objectstore import ObjectStore  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Model, compute_params, make_trainable)
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


CPU = torch.device("cpu")
CTX = Ctx(device=CPU, dtype=torch.float32)
RCTX = RefCtx(mesh=None, dtype=jnp.float32)
GRANITE = "granite-moe-1b-a400m"
MARGIN = 1e-6       # least gap at the top-k frontier of the router's probs


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


def _configs(arch, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


# ---------------------------------------------------------------------------
# The MoE train function
# ---------------------------------------------------------------------------
#: name -> (arch, config overrides, B, S, router bias toward expert 0)
FFN_CASES = {
    "one-group": (GRANITE, {}, 2, 16, 0.0),
    "groups-a-row": (GRANITE, dict(moe_group_size=8), 2, 16, 0.0),
    "drops-small-capacity": (GRANITE, dict(moe_group_size=8,
                                           capacity_factor=0.5), 2, 16, 0.0),
    "drops-biased-router": (GRANITE, dict(moe_group_size=8), 3, 16, 1.0),
    "shared-experts": ("deepseek-v2-236b", dict(capacity_factor=0.75), 2, 16,
                       0.0),
}


def _ffn_case(name):
    arch, over, B, S, bias = FFN_CASES[name]
    rcfg, tcfg = _configs(arch, **over)
    tree = ref_init_params(rcfg, jax.random.key(0))["decoder"]["groups"]
    rp = {n: np.array(_np(a[0])) for n, a in tree["0"]["moe"].items()}
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    if bias:
        # a router column along the mean input: most tokens rank expert 0
        # first, so its queue overflows
        rp["router"][:, 0] += bias * x.reshape(-1, tcfg.d_model).mean(0)
    return rcfg, tcfg, rp, x


def _routing(rcfg, rp, x):
    """The reference's routing of ``x``: ``(experts (T, k), kept (T, k)
    as GShard's queue keeps them, the least top-k margin)``."""
    E, k = rcfg.num_experts, rcfg.num_experts_per_tok
    logits = x.reshape(-1, x.shape[-1]) @ rp["router"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    _, experts = jax.lax.top_k(jnp.asarray(probs), k)
    experts = np.asarray(experts)
    order = -np.sort(-probs, axis=-1)
    margin = (order[:, k - 1] - order[:, k]).min()
    Sg = min(rcfg.moe_group_size, x.shape[1])
    C = max(1, int(Sg * k / E * rcfg.capacity_factor))
    kept = np.zeros_like(experts, bool)
    for g0 in range(0, experts.shape[0], Sg):
        seen = np.zeros(E, int)
        for t in range(g0, g0 + Sg):
            for j in range(k):
                e = experts[t, j]
                kept[t, j] = seen[e] < C
                seen[e] += 1
    return experts, kept, margin


def _ref_ffn(rcfg, rp, x):
    return ref_moe.moe_ffn(rcfg, rp, x, RCTX, dropless=False)


@pytest.mark.parametrize("name", sorted(FFN_CASES))
def test_moe_train_function_matches_reference(name):
    rcfg, tcfg, rp, x = _ffn_case(name)
    experts, kept, margin = _routing(rcfg, rp, x)
    assert margin > MARGIN, margin
    if name.startswith("drops"):
        assert not kept.all()              # the case does drop pairs
    want, want_aux = _ref_ffn(rcfg, {n: jnp.asarray(a) for n, a in
                                     rp.items()}, jnp.asarray(x))
    got, aux = moe.moe_ffn(tcfg, {n: _t(a) for n, a in rp.items()}, _t(x),
                           mode="train")
    want = _np(want)
    assert got.shape == want.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    # the drops matter: the output is not the dropless one
    if not kept.all():
        dropless, _ = ref_moe.moe_ffn(rcfg, {n: jnp.asarray(a) for n, a in
                                             rp.items()}, jnp.asarray(x),
                                      RCTX, dropless=True)
        assert np.abs(_np(dropless) - want).max() > 1e-3


def test_groups_never_span_rows():
    """Row b's output depends on row b alone: a row's queue positions
    restart with the row, so shuffling the other rows changes nothing."""
    rcfg, tcfg, rp, x = _ffn_case("drops-small-capacity")
    p = {n: _t(a) for n, a in rp.items()}
    both, _ = moe.moe_ffn(tcfg, p, _t(x), mode="train")
    for b in range(x.shape[0]):
        alone, _ = moe.moe_ffn(tcfg, p, _t(x[b:b + 1]), mode="train")
        torch.testing.assert_close(alone[0], both[b], rtol=0, atol=0)
    assert moe.capacity(get_config(GRANITE), 1024) == 320
    assert moe.capacity(tcfg, moe.group_size(tcfg, 16)) == 2


@pytest.mark.parametrize("name", ["groups-a-row", "drops-small-capacity",
                                  "drops-biased-router", "shared-experts"])
def test_moe_train_gradients_match_jax_grad(name):
    """Gradients of a weighted sum of the outputs and, separately, of the
    aux loss, with respect to the input and every MoE leaf."""
    rcfg, tcfg, rp, x = _ffn_case(name)
    assert _routing(rcfg, rp, x)[2] > MARGIN
    w = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def ref_losses(p, x):
        out, aux = _ref_ffn(rcfg, p, x)
        return (out * w).sum(), aux

    rp_j = {n: jnp.asarray(a) for n, a in rp.items()}
    leaves = {n: _t(a).requires_grad_(True) for n, a in rp.items()}
    xt = _t(x).requires_grad_(True)
    out, aux = moe.moe_ffn(tcfg, leaves, xt, mode="train")
    for i, port_loss in enumerate(((out * _t(w)).sum(), aux)):
        want = jax.jit(jax.grad(lambda p, x: ref_losses(p, x)[i],
                                argnums=(0, 1)))(rp_j, jnp.asarray(x))
        names = sorted(leaves)
        got = torch.autograd.grad(port_loss, [leaves[n] for n in names]
                                  + [xt], retain_graph=True,
                                  allow_unused=True)
        pairs = [(n, g, want[0][n]) for n, g in zip(names, got)]
        pairs.append(("x", got[-1], want[1]))
        for n, g, wg in pairs:
            wg = _np(wg)
            g = np.zeros_like(wg) if g is None else g.numpy()
            err = np.abs(g - wg).max()
            assert err <= 1e-4 * max(np.abs(wg).max(), 1e-30), (i, n, err)


# ---------------------------------------------------------------------------
# The reduced granite model: loss, gradients, AdamW steps, remat
# ---------------------------------------------------------------------------
MODEL_CASES = {"default": {}, "groups-drops": dict(moe_group_size=8,
                                                   capacity_factor=0.75)}


def _batch(rcfg, S=16, B=2, step=0, seed=3):
    b = RefData(rcfg.vocab_size, S, B, seed=seed).batch_at(step)
    b = {k: np.array(v) for k, v in b.items()}
    return b, {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def granite(request):
    rcfg, tcfg = _configs(GRANITE, **MODEL_CASES[request.param])
    rparams = ref_init_params(rcfg, jax.random.key(0))
    model = Model(tcfg, device=CPU)
    model.load_state_dict(params_from_jax(jax.device_get(rparams), tcfg))
    return rcfg, tcfg, rparams, make_trainable(model)


def test_train_logits_and_aux_match_reference(granite):
    rcfg, tcfg, rparams, model = granite
    rb, tb = _batch(rcfg)
    want, _, want_aux = ref_model.forward(rcfg, rparams, rb, RCTX,
                                          mode="train")
    got, aux = port_model.forward(tcfg, compute_params(model, torch.float32),
                                  tb, CTX, mode="train")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-4,
                               rtol=0)
    assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=1e-5)


def test_loss_and_gradients_match_reference_by_tree_path(granite):
    rcfg, tcfg, rparams, model = granite
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
    got = dict(_leaves(params_to_jax(dict(zip(names, grads)), tcfg)))
    want = dict(_leaves(jax.device_get(rgrads)))
    assert sorted(got) == sorted(want)
    assert any("/moe/we_g" in p for p in want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (path, err)


def run_steps(rcfg, tcfg, n_mb, n_steps, lr=1e-3, B=4, S=16):
    """``n_steps`` AdamW steps of both packages from the reference's
    initial state on the reference's batches.  Returns both final states
    (numpy trees), each step's (port, reference) metrics and, with one
    microbatch, where each step's reference gradient was below 1e-4 of its
    leaf's largest; ``on_step(i, rstate, tstate)`` sees the states after
    step ``i``."""
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
    metrics, small, states = [], [], []
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
        states.append((jax.device_get(rstate),
                       train_state_to_jax(tstate, tcfg)))
    return states, metrics, small


def assert_states_close(rstate, tstate, small, lr, n_steps):
    """``tests/test_torch_train.py``'s tolerances after ``n_steps``."""
    assert int(tstate["step"]) == int(rstate["step"]) == n_steps
    assert int(tstate["opt"]["count"]) == int(rstate["opt"]["count"])
    got = dict(_leaves(tstate["params"]))
    for path, w in _leaves(rstate["params"]):
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w)
        assert err.max() <= 2 * lr * n_steps, (path, err.max())
        off = err > 1e-5
        if small:
            noisy = np.any([s[path] for s in small], axis=0)
            assert not np.any(off & ~noisy), (path, err[~noisy].max())
        else:
            assert off.mean() <= 1e-3, (path, off.sum())
    for part in ("m", "v"):
        got = dict(_leaves(tstate["opt"][part]))
        for path, w in _leaves(rstate["opt"][part]):
            w = np.asarray(w, np.float32)
            err = np.abs(got[path] - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (part, path,
                                                               err)


@pytest.mark.parametrize("case,n_mb", [("default", 1), ("groups-drops", 1),
                                       ("default", 2), ("groups-drops", 2)])
def test_three_train_steps_match_reference(case, n_mb):
    rcfg, tcfg = _configs(GRANITE, **MODEL_CASES[case])
    states, metrics, small = run_steps(rcfg, tcfg, n_mb, 3)
    for i, (tm, rm) in enumerate(metrics):
        for key, rtol in (("loss", 1e-5), ("ce", 1e-5), ("aux", 1e-5),
                          ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(tm[key], rm[key], rtol=rtol,
                                       err_msg=f"{key}, step {i}")
    rstate, tstate = states[-1]
    assert_states_close(rstate, tstate, small, 1e-3, 3)


def test_remat_policies_give_equal_loss_aux_and_gradients():
    _, tcfg = _configs(GRANITE, moe_group_size=8, capacity_factor=0.75)
    model = make_trainable(port_model.init_params(Model(tcfg, device=CPU),
                                                  0))
    _, tb = _batch(_configs(GRANITE)[0], S=16, B=3)
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


class ExpertProducts(TorchDispatchMode):
    """Counts the batched products over the experts (a first operand
    ``(E, rows, cols)``) that run while it is on."""

    def __init__(self, E):
        super().__init__()
        self.E, self.count = E, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default and args[0].shape[0] == self.E:
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_keeps_the_expert_products():
    """The backward of a layer's three expert products is six products;
    ``full`` remat runs the three again, ``dots`` keeps their outputs and
    runs none again."""
    _, tcfg = _configs(GRANITE)
    model = make_trainable(port_model.init_params(Model(tcfg, device=CPU),
                                                  0))
    _, tb = _batch(_configs(GRANITE)[0], S=16, B=3)
    counts = {}
    for policy in ("none", "dots", "full"):
        loss, _ = steps.loss_fn(tcfg, compute_params(model, torch.float32),
                                tb, CTX, remat_policy=policy)
        with ExpertProducts(tcfg.num_experts) as products:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[policy] = products.count
    L = tcfg.num_layers
    assert counts == {"none": 6 * L, "dots": 6 * L, "full": 9 * L}, counts


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


def test_train_state_round_trips_exactly_with_the_moe_leaves():
    rcfg, tcfg = _configs(GRANITE)
    tree = _random_state_tree(rcfg)
    moe_leaves = tree["params"]["decoder"]["groups"]["0"]["moe"]
    assert sorted(moe_leaves) == ["router", "we_d", "we_g", "we_u"]
    assert moe_leaves["we_g"].shape == (
        tcfg.num_layers, tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff)
    state = train_state_from_jax(tree, tcfg, device=CPU)
    np.testing.assert_array_equal(
        state["params"].blocks[1].moe.we_d.detach().numpy(),
        moe_leaves["we_d"][1])
    back = train_state_to_jax(state, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(_leaves(tree), _leaves(back)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape, pa
        np.testing.assert_array_equal(a, b, err_msg=pa)
    # the same tree loaded into a live state in place
    fresh = steps.init_train_state(tcfg, seed=9, device=CPU)
    overlay_train_state(fresh, tree)
    for (pa, a), (_, b) in zip(_leaves(tree),
                               _leaves(train_state_to_jax(fresh, tcfg))):
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32), err_msg=pa)


def test_checkpoint_bytes_equal_the_reference_s():
    """A granite train state saved by the port (torch leaves, through
    ``train_state_to_jax``) writes the keys and bytes that the reference's
    manager writes for the same state."""
    rcfg, tcfg = _configs(GRANITE)
    tree = _random_state_tree(rcfg, seed=4)
    ref, port = RefStore(), ObjectStore()
    RefCkpt(ref, "job").save(5, tree)
    state = train_state_from_jax(tree, tcfg, device=CPU)
    CheckpointManager(port, "job").save(5, train_state_to_jax(state, tcfg))
    assert {k: bytes(v) for k, v in port._blobs.items()} == \
        {k: bytes(v) for k, v in ref._blobs.items()}


def test_cli_trains_granite_on_the_cpu_and_refuses_a_ragged_row(capsys):
    assert train_cli.main(["--arch", GRANITE, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", "2", "--seq", "16",
                           "--remat", "full", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "granite-moe-1b-a400m-reduced" in out and "steps/s" in out
    assert out.count("  step ") == 3 and out.count(" aux ") == 3
    with pytest.raises(ValueError, match="whole number of MoE dispatch"):
        train_cli.main(["--arch", GRANITE, "--reduced", "--device", "cpu",
                        "--steps", "1", "--batch", "1", "--seq", "1536"])
    assert "  step " not in capsys.readouterr().out
    check_trainable(get_config(GRANITE))
    run = get_run_config(GRANITE, "train_4k")
    assert (run.num_microbatches, run.remat_policy) == (1, "full")


JOB_STEPS, JOB_LR = 8, 2e-3


def _job_payload(tcfg, init):
    run = RunConfig(learning_rate=JOB_LR, warmup_steps=2,
                    total_steps=JOB_STEPS)
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


def test_granite_job_killed_after_a_checkpoint_equals_an_uninterrupted_run():
    """A reduced granite learner (several dispatch groups a row, drops) as
    a real payload under the port's platform: the pod is killed after a
    checkpoint, the job restores it and completes; every loss (replayed
    steps included) and the final state equal, bit for bit, those of the
    same payload run without the platform."""
    rcfg, tcfg = _configs(GRANITE, moe_group_size=8, capacity_factor=0.75)
    init = jax.device_get(ref_steps.init_train_state(rcfg,
                                                     jax.random.key(0)))
    plain = _job_payload(tcfg, init)
    plain.restore(None)
    want = [plain.step(i) for i in range(JOB_STEPS)]

    payload = _job_payload(tcfg, init)
    p = port_core.DLaaSPlatform(seed=21)
    p.run(10)
    h = p.submit(port_core.JobManifest(
        name="granite", framework=GRANITE, learners=1,
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
        np.testing.assert_array_equal(a, b, err_msg=pa)
