"""How the port's fp32 train state drifts from the reference's over many
steps, on the CPU (the direct loop, no platform).

``tests/test_torch_train.py`` holds three AdamW steps to the reference.
Over more steps the weights part where Adam amplifies fp32 noise: an
element whose gradient is within the noise of zero moves by m / sqrt(v)
~ sign(g) lr, so a sign that differs costs up to 2 lr a step there.  A
weight that has parted that way changes the later gradients of whatever
reads it (an embedding row of a token the next batches hold), so the
moments part by more than the per-step noise too.  This file pins both
halves of that account over ``STEPS`` steps of reduced
``paper-overhead-100m`` (at the platform job's lr and rows,
``tests/test_torch_platform.py``) and reduced ``granite-moe-1b-a400m``:

* running free: the loss within 1e-5 relative every step; every weight
  within 2 lr a step of the reference's, and off by more than 1e-5 only
  where the reference's own gradient was below 1e-4 of its leaf's
  largest in some step so far (the noise model);
* re-anchored: each step taken by both packages from the reference's
  state keeps its moments within 1e-4 of each leaf's largest magnitude
  and its weights within the same noise model for that one step, at
  every one of the steps.  So each step is right, and the moments' drift
  in the free run is the weights' noise fed forward.
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
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    overlay_train_state, train_state_from_jax, train_state_to_jax)
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


CPU = torch.device("cpu")
STEPS = 24
#: arch -> (lr, rows of the batch, tokens a row)
CASES = {"paper-overhead-100m": (2e-3, 4, 32),
         "granite-moe-1b-a400m": (2e-3, 4, 32)}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree, np.float32)


def _weights_within_noise(got, want, small, lr, n):
    """Weights within 2 lr a step over ``n`` steps, off by more than 1e-5
    only where ``small`` (elements whose reference gradient was below
    1e-4 of the leaf's largest in some step) says the noise may move
    them.  Returns the largest error."""
    got = dict(_leaves(got))
    worst = 0.0
    for path, w in _leaves(want):
        err = np.abs(got[path] - w)
        assert err.max() <= 2 * lr * n, (path, err.max(), n)
        assert not np.any((err > 1e-5) & ~small[path]), (path, n)
        worst = max(worst, float(err.max()))
    return worst


def _moments_close(got, want):
    for part in ("m", "v"):
        g = dict(_leaves(got["opt"][part]))
        for path, w in _leaves(want["opt"][part]):
            err = np.abs(g[path] - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (part, path)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_drift_over_many_steps_stays_within_the_noise_model(arch):
    lr, B, S = CASES[arch]
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    rctx = RefCtx(mesh=None, dtype=jnp.float32)
    rrun = RefRunConfig(learning_rate=lr, warmup_steps=3, total_steps=STEPS)
    rstate = ref_steps.init_train_state(rcfg, jax.random.key(0), rrun)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, rctx, rrun))
    rgrad = jax.jit(jax.grad(lambda p, b: ref_steps.loss_fn(rcfg, p, b,
                                                            rctx)[0]))
    tstep = steps.make_train_step(
        tcfg, Ctx(device=CPU, dtype=torch.float32),
        RunConfig(learning_rate=lr, warmup_steps=3, total_steps=STEPS))
    free = train_state_from_jax(jax.device_get(rstate), tcfg, device=CPU)
    anchored = train_state_from_jax(jax.device_get(rstate), tcfg,
                                    device=CPU)
    data = RefData(rcfg.vocab_size, S, B, seed=0)
    seen = None                   # where the reference's gradient was small
    for i in range(STEPS):
        batch = {k: np.array(v) for k, v in data.batch_at(i).items()}
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        small = {p: np.abs(g) < 1e-4 * np.abs(g).max()
                 for p, g in _leaves(jax.device_get(
                     rgrad(rstate["params"], batch)))}
        seen = small if seen is None else \
            {p: seen[p] | s for p, s in small.items()}
        overlay_train_state(anchored, jax.device_get(rstate))
        rstate, rm = rstep(rstate, batch)
        free, fm = tstep(free, tb)
        anchored, _ = tstep(anchored, tb)
        want = jax.device_get(rstate)
        np.testing.assert_allclose(float(fm["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        _weights_within_noise(train_state_to_jax(free, tcfg)["params"],
                              want["params"], seen, lr, i + 1)
        one = train_state_to_jax(anchored, tcfg)
        _weights_within_noise(one["params"], want["params"], small, lr, 1)
        _moments_close(one, want)
