"""The port's gradient compression (``repro_torch.dist.compression``) and
its place in the train step and the platform's checkpoints, against the
reference's ``repro.dist.compression`` on the CPU.

* The wire format and the leaves: ``pack_int8``, ``unpack_int8``,
  ``wire_bytes_int8``, the int8 and top-k leaves (magnitude ties, a tensor
  whose (1 - ratio) quantile is zero, chunked and per-tensor scales) give
  the reference's bits, run op by op as written.  Under ``jax.jit`` XLA's
  CPU code divides by a constant or a broadcast scale as a product with
  the reciprocal, one rounding more: there the scale is within one ulp of
  the division's, and a payload entry moves by one level only where the
  quotient lies within 2^-20 of a half level (the test states both).
* ``compress_grads`` over a model's gradient tree, the reference's layer
  stacks compressed as one tensor each (``convert.reference_stacks``):
  four steps bit-equal to the reference's, and the cumulative sent
  gradient plus the residual equal to the summed gradient (as
  ``tests/test_train.py``).
* Three train steps under int8 and top-k against the reference's
  ``make_train_step(..., grad_compression=...)`` (jitted) for reduced
  paper-overhead-100m and reduced qwen3-0.6b in two microbatches.
  Tolerances are ``tests/test_torch_train.py``'s (losses and grad norms
  1e-5 relative, lr 1e-6; weights within 2 lr a step) with one addition
  for int8: the two packages' fp32 gradients differ by rounding, and an
  element whose target lies within that rounding of a half level is sent
  one level apart (the residual carries the difference).  Such elements
  may hold weights more than 1e-5 off, moments past 1e-4 of their leaf's
  largest and residuals up to one level apart; at most a thousandth of
  the tree's elements may be one.
* The train state's round trip with ``err``, checkpoint bytes equal to
  the reference's, and a compressed job under the port's platform killed
  after a checkpoint, equal bit for bit to an uninterrupted run.
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
from repro.dist import compression as ref  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    overlay_train_state, params_from_jax, params_to_jax, reference_stacks,
    train_state_from_jax, train_state_to_jax)
from repro_torch.core.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.learner import RealPayload  # noqa: E402
from repro_torch.core.objectstore import ObjectStore  # noqa: E402
from repro_torch.dist import compression as port  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


CPU = torch.device("cpu")
CTX = Ctx(device=CPU, dtype=torch.float32)
RCTX = RefCtx(mesh=None, dtype=jnp.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _configs(arch):
    return (dataclasses.replace(ref_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


# ---------------------------------------------------------------------------
# The wire format and the leaves
# ---------------------------------------------------------------------------
def _tensor(kind, rng, shape=(7, 45)):
    """A (7, 45) tensor of ``kind`` (315 elements: a ragged last chunk of
    16)."""
    if kind == "dense":
        return (rng.normal(size=shape) * 3e-3).astype(np.float32)
    if kind == "sparse":      # the (1 - ratio) quantile is zero
        x = (rng.normal(size=shape) * 50).astype(np.float32)
        x[rng.random(shape) < 0.97] = 0
        return x
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    # magnitude ties across the top-k boundary
    return np.resize(np.array([1, -1, 0.5, 1, -1, 1, 0, -1], np.float32),
                     shape)


KINDS = ("dense", "sparse", "zeros", "ties")


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_int8_wire_format_is_bit_equal_to_the_reference(kind, chunk):
    x = _tensor(kind, np.random.default_rng(len(kind) + chunk))
    rcfg = ref.CompressionConfig(chunk_size=chunk)
    cfg = port.CompressionConfig(chunk_size=chunk)
    rp, rs = ref.pack_int8(jnp.asarray(x), rcfg)
    pp, ps = port.pack_int8(torch.from_numpy(x), cfg)
    assert pp.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        port.unpack_int8(pp, ps, x.shape).numpy(),
        np.asarray(ref.unpack_int8(rp, rs, x.shape)))
    assert port.wire_bytes_int8(torch.from_numpy(x), cfg) == \
        ref.wire_bytes_int8(jnp.asarray(x), rcfg)
    np.testing.assert_array_equal(
        port._int8_leaf(torch.from_numpy(x), cfg).numpy(),
        np.asarray(ref._int8_leaf(jnp.asarray(x), rcfg)))


@pytest.mark.parametrize("kind", KINDS)
def test_int8_wire_format_under_jit_moves_only_next_to_a_half_level(kind):
    """Under ``jax.jit`` the reference multiplies by reciprocals: its
    scale within one ulp of the port's division, a payload entry one
    level off only where the quotient lies within 2^-20 of a half
    level."""
    x = _tensor(kind, np.random.default_rng(len(kind) + 16))
    rcfg = ref.CompressionConfig(chunk_size=16)
    pp, ps = port.pack_int8(torch.from_numpy(x),
                            port.CompressionConfig(chunk_size=16))
    jp, js = jax.jit(lambda a: ref.pack_int8(a, rcfg))(jnp.asarray(x))
    js = np.asarray(js)
    assert np.all(np.abs(js - ps.numpy())
                  <= np.spacing(np.maximum(js, ps.numpy()))), kind
    moved = np.asarray(jp).astype(int) != pp.numpy().astype(int)
    assert np.all(np.abs(np.asarray(jp).astype(int)
                         - pp.numpy().astype(int)) <= 1)
    blocks = np.pad(x.ravel(), (0, pp.numel() - x.size)).reshape(
        ps.numel(), -1)
    safe = np.where(ps.numpy() > 0, ps.numpy(), 1)[:, None]
    quotient = (blocks / safe).ravel()
    near = np.abs(np.abs(quotient - np.trunc(quotient)) - 0.5) \
        <= 2 ** -20 * np.maximum(np.abs(quotient), 1)
    assert not np.any(moved & ~near), kind


@pytest.mark.parametrize("ratio", [0.05, 0.1, 0.3])
@pytest.mark.parametrize("kind", KINDS)
def test_topk_leaf_is_bit_equal_to_the_reference(kind, ratio):
    x = _tensor(kind, np.random.default_rng(7))
    rcfg = ref.CompressionConfig(kind="topk", topk_ratio=ratio)
    cfg = port.CompressionConfig(kind="topk", topk_ratio=ratio)
    want = np.asarray(jax.jit(lambda a: ref._topk_leaf(a, rcfg))(
        jnp.asarray(x)))
    got = port._topk_leaf(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    # k entries sent, or every nonzero one where fewer are (a selected
    # zero is not sent: on the sparse x the (1 - ratio) quantile is zero)
    k = max(1, int(round(x.size * ratio)))
    assert np.count_nonzero(got) == min(k, np.count_nonzero(x))


def test_resolve_compression_takes_the_reference_s_forms():
    for flag in (None, False, True, "none", "int8", "topk",
                 port.CompressionConfig(kind="topk", topk_ratio=0.1),
                 port.CompressionConfig(kind="none")):
        got = port.resolve_compression(flag)
        rflag = ref.CompressionConfig(**dataclasses.asdict(flag)) \
            if isinstance(flag, port.CompressionConfig) else flag
        want = ref.resolve_compression(rflag)
        assert (got is None) == (want is None), flag
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="kind"):
        port.CompressionConfig(kind="fp8")
    with pytest.raises(ValueError, match="chunk_size"):
        port.CompressionConfig(chunk_size=-1)


# ---------------------------------------------------------------------------
# compress_grads over a model's gradient tree
# ---------------------------------------------------------------------------
def _grad_trees(rcfg, n, seed):
    """``n`` gradient trees shaped like the reference's parameters, each
    leaf at its own magnitude."""
    shapes = jax.eval_shape(lambda: ref_init_params(rcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    mags = jax.tree.map(lambda s: 10.0 ** rng.uniform(-4, 1), shapes)
    return [jax.tree.map(lambda s, m: (rng.normal(size=s.shape) * m)
                         .astype(np.float32), shapes, mags)
            for _ in range(n)]


@pytest.mark.parametrize("kind,chunk", [("int8", 0), ("topk", 0)])
def test_compress_grads_over_four_steps_is_the_reference_s(kind, chunk):
    rcfg, tcfg = _configs("paper-overhead-100m")
    rc = ref.CompressionConfig(kind=kind, chunk_size=chunk)
    pc = port.CompressionConfig(kind=kind, chunk_size=chunk)
    grads = _grad_trees(rcfg, 4, seed=chunk + len(kind))
    stacks = reference_stacks(tcfg)
    assert stacks and all(len(s) == tcfg.num_layers for s in stacks)
    rerr = ref.init_error_buffers(grads[0])
    perr = port.init_error_buffers(params_from_jax(grads[0], tcfg))
    assert all(e.dtype == torch.float32 and not e.any()
               for e in perr.values())
    sent_sum = None
    for g in grads:
        rsent, rerr = ref.compress_grads(
            jax.tree.map(jnp.asarray, g), rerr, rc)
        psent, perr = port.compress_grads(params_from_jax(g, tcfg), perr,
                                          pc, stacks)
        for part, got, want in (("sent", psent, rsent), ("err", perr, rerr)):
            got = dict(_leaves(params_to_jax(got, tcfg)))
            for path, w in _leaves(jax.device_get(want)):
                np.testing.assert_array_equal(got[path], w,
                                              err_msg=f"{part} {path}")
        sent = params_to_jax(psent, tcfg)
        sent_sum = sent if sent_sum is None else jax.tree.map(
            np.add, sent_sum, sent)
    # error feedback: what was sent plus what is carried is what came in
    total = jax.tree.map(lambda *a: np.sum(a, axis=0, dtype=np.float64),
                         *grads)
    err = params_to_jax(perr, tcfg)
    for (path, s), (_, e), (_, t) in zip(_leaves(sent_sum), _leaves(err),
                                         _leaves(total)):
        np.testing.assert_allclose(s + e, t, rtol=1e-4,
                                   atol=1e-5 * np.abs(t).max(), err_msg=path)


# ---------------------------------------------------------------------------
# Three compressed train steps against the reference's
# ---------------------------------------------------------------------------
LR, N_STEPS = 1e-3, 3


def _compressed_steps(arch, n_mb, kind):
    rcfg, tcfg = _configs(arch)
    rrun = RefRunConfig(num_microbatches=n_mb, learning_rate=LR,
                        warmup_steps=2, total_steps=N_STEPS,
                        grad_compression=kind)
    rstate = ref_steps.init_train_state(rcfg, jax.random.key(1), rrun)
    assert "err" in rstate
    tstate = train_state_from_jax(jax.device_get(rstate), tcfg, device=CPU)
    run = RunConfig(num_microbatches=n_mb, learning_rate=LR, warmup_steps=2,
                    total_steps=N_STEPS)
    # the explicit argument wins over the run's "none", as in the reference
    rstep = jax.jit(ref_steps.make_train_step(rcfg, RCTX, rrun))
    tstep = steps.make_train_step(tcfg, CTX, run, grad_compression=kind)
    data = RefData(rcfg.vocab_size, 16, 4, seed=5)
    for i in range(N_STEPS):
        batch = {k: np.array(v) for k, v in data.batch_at(i).items()}
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        rstate, rm = rstep(rstate, batch)
        tstate, tm = tstep(tstate, tb)
        for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                       rtol=rtol, err_msg=f"{key}, step {i}")
    return jax.device_get(rstate), train_state_to_jax(tstate, tcfg)


@pytest.mark.parametrize("arch,n_mb", [("paper-overhead-100m", 1),
                                       ("qwen3-0.6b", 2)])
@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_three_compressed_train_steps_match_reference(arch, n_mb, kind):
    rstate, tstate = _compressed_steps(arch, n_mb, kind)
    assert int(tstate["step"]) == int(rstate["step"]) == N_STEPS
    flips, total = 0, 0
    for part in ("params", "m", "v", "err"):
        want_tree = rstate["opt"][part] if part in ("m", "v") \
            else rstate[part]
        got_tree = tstate["opt"][part] if part in ("m", "v") \
            else tstate[part]
        got = dict(_leaves(got_tree))
        for path, w in _leaves(want_tree):
            w = np.asarray(w, np.float32)
            err = np.abs(got[path] - w)
            if part == "params":
                assert err.max() <= 2 * LR * N_STEPS, (path, err.max())
                off = err > 1e-5
            elif part == "err":
                # one level: |err| <= scale / 2 on either side
                assert err.max() <= 2 * np.abs(w).max() + 1e-5, path
                off = err > 1e-5
            else:
                off = err > 1e-4 * max(np.abs(w).max(), 1e-30)
            total += w.size
            flips += int(off.sum())
    if kind == "topk":
        assert flips == 0
    assert flips <= 1e-3 * total, (flips, total)


def test_train_state_with_error_buffers_round_trips_exactly():
    rcfg, tcfg = _configs("paper-overhead-100m")
    rstate = jax.device_get(ref_steps.init_train_state(
        rcfg, jax.random.key(2), grad_compression="int8"))
    rng = np.random.default_rng(3)

    def draw(t, dt=None):
        return jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            dt or a.dtype), t)
    tree = {"params": draw(rstate["params"]),
            "opt": {"m": draw(rstate["opt"]["m"]),
                    "v": draw(rstate["opt"]["v"], jnp.bfloat16),
                    "count": np.int32(4)},
            "step": np.int32(4), "err": draw(rstate["err"])}
    state = train_state_from_jax(tree, tcfg, device=CPU)
    assert set(state["err"]) == {n for n, _ in
                                 state["params"].named_parameters()}
    back = train_state_to_jax(state, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (pa, a), (pb, b) in zip(_leaves(tree), _leaves(back)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape, pa
        np.testing.assert_array_equal(a, b, err_msg=pa)
    # a restore into a state of the other kind is refused, both ways
    plain = train_state_from_jax({k: v for k, v in tree.items()
                                  if k != "err"}, tcfg, device=CPU)
    with pytest.raises(ValueError, match="err"):
        overlay_train_state(plain, tree)
    with pytest.raises(ValueError, match="err"):
        overlay_train_state(state, {k: v for k, v in tree.items()
                                    if k != "err"})
    # the checkpoint of the state is the reference's, byte for byte
    ref_store, port_store = RefStore(), ObjectStore()
    RefCkpt(ref_store, "job").save(4, tree)
    CheckpointManager(port_store, "job").save(4, train_state_to_jax(state,
                                                                    tcfg))
    assert {k: bytes(v) for k, v in port_store._blobs.items()} == \
        {k: bytes(v) for k, v in ref_store._blobs.items()}
    assert any("/blob/err/" in k for k in port_store._blobs)


def test_init_train_state_takes_the_run_s_knob_and_the_argument():
    _, tcfg = _configs("paper-overhead-100m")
    state = steps.init_train_state(tcfg, device=CPU,
                                   run=RunConfig(grad_compression="topk"))
    assert set(state["err"]) == set(state["opt"]["m"])
    assert "err" not in steps.init_train_state(
        tcfg, device=CPU, run=RunConfig(grad_compression="topk"),
        grad_compression=False)
    assert "err" in steps.init_train_state(tcfg, device=CPU,
                                           grad_compression="int8")
    # a compressing step refuses a state without error buffers
    plain = steps.init_train_state(tcfg, device=CPU)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="no error buffers"):
        steps.make_train_step(tcfg, CTX, RunConfig(),
                              grad_compression="int8")(
            plain, {"tokens": tokens, "labels": tokens})


# ---------------------------------------------------------------------------
# A compressed job under the port's platform
# ---------------------------------------------------------------------------
JOB_STEPS, JOB_LR = 8, 2e-3


def _job_payload(tcfg, init):
    run = RunConfig(learning_rate=JOB_LR, warmup_steps=2,
                    total_steps=JOB_STEPS, grad_compression="int8")
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


def test_compressed_job_killed_after_a_checkpoint_equals_a_straight_run():
    """A reduced paper-overhead learner under int8 compression as a real
    payload: killed after a checkpoint (which carries the error buffers),
    restored, completed; every loss and the final state, ``err``
    included, equal those of the same payload run without the platform,
    bit for bit."""
    rcfg, tcfg = _configs("paper-overhead-100m")
    init = jax.device_get(ref_steps.init_train_state(
        rcfg, jax.random.key(0), grad_compression="int8"))
    plain = _job_payload(tcfg, init)
    plain.restore(None)
    want = [plain.step(i) for i in range(JOB_STEPS)]

    payload = _job_payload(tcfg, init)
    p = port_core.DLaaSPlatform(seed=21)
    p.run(10)
    h = p.submit(port_core.JobManifest(
        name="int8", framework="paper-overhead-100m", learners=1,
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
    _, tree = ck.load(saved)
    assert int(tree["step"]) == saved > 0
    assert any(np.abs(a).max() > 0 for _, a in _leaves(tree["err"]))
    assert p.kill_pod(f"learner-{h.job_id}-0")
    assert p.run_until_terminal(h.job_id, timeout=900) == "COMPLETED"
    assert p.client.status(h.job_id)["restarts"] == 1
    assert f"restored checkpoint step {saved}" in p.client.logs(h.job_id, 0)
    ran = [i for i, _ in payload.losses]
    assert len(ran) > len(set(ran)) == JOB_STEPS          # steps replayed
    for i, loss in payload.losses:
        assert loss == want[i], (i, loss, want[i])
    got, final = payload.snapshot(), plain.snapshot()
    assert sorted(got) == sorted(final) and "err" in got
    for (pa, a), (pb, b) in zip(_leaves(got), _leaves(final)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=pa)
