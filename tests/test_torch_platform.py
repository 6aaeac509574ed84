"""The port's copy of the platform (``repro_torch.core``) and its real
payloads against the reference's ``repro.core`` on the CPU.

* Virtual time: the same calls from the same seed through both platforms
  give the same job documents (state histories included), restarts,
  logs, recovery times and clock, scenario by scenario.  Every counter
  in ``core`` is per instance, so equality is exact.
* The verbatim copies: each listed module's source equals the
  reference's after the one rewrite ``repro.core`` -> ``repro_torch.core``.
* The checkpoint format: the same tree through both managers gives the
  same object-store keys and bytes; a bf16 leaf crosses both ways; a
  corrupted blob is skipped by both alike.
* Real payloads: a reduced ``paper-overhead-100m`` learner in fp32 trains
  under both platforms from the same initial state (the reference's,
  through ``convert``) on the reference's own batches (ROADMAP D10), is
  killed in both and completes with the same logs; checkpoints cross
  between the learners both ways; a snapshot does not alias the live
  state; a reduced ``qwen3-0.6b`` serve job recovers from a pod kill.

Tolerances (fp32, sums in another order than XLA's; as
``tests/test_torch_train.py``): losses 1e-5 relative each step; after
the job the weights within 2 lr a step of the reference's, with at most
a thousandth of each leaf's elements more than 1e-5 off (Adam's sign
amplification where a gradient is within fp32 noise of zero), the
moments within 1e-4 of each leaf's largest magnitude.
"""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.core.checkpoint import CheckpointManager as RefCkpt  # noqa: E402
from repro.core.learner import RealPayload as RefPayload  # noqa: E402
from repro.core.objectstore import ObjectStore as RefStore  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RefData  # noqa: E402
from repro.models.layers import Ctx as RefCtx  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.core.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.jobspec import (  # noqa: E402
    ArchitectureAdapter, FrameworkRegistry)
from repro_torch.core.learner import RealPayload  # noqa: E402
from repro_torch.core.objectstore import ObjectStore  # noqa: E402
from repro_torch.launch import spec as port_spec  # noqa: E402
from repro_torch.launch.engine import RealServePayload  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401


ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

#: copied verbatim: only ``repro.core`` -> ``repro_torch.core`` differs.  A
#: change that must alter one of them takes it off this list.
VERBATIM = ("__init__", "sim", "states", "raft", "statestore", "metadata",
            "objectstore", "volumes", "tenancy", "cluster", "scheduler",
            "manifest", "failures", "recovery", "helper", "elastic",
            "guardian", "lcm", "api", "platform", "server")
#: the port's own versions (config look-ups, the payloads, the checkpoint
#: leaves); every other module of the reference's core is in VERBATIM
CHANGED = ("jobspec", "checkpoint", "learner")


def _rewrite(src: str) -> str:
    return src.replace("repro.core", "repro_torch.core")


@pytest.mark.parametrize("name", VERBATIM)
def test_verbatim_copies_equal_the_reference(name):
    ref = (ROOT / "src" / "repro" / "core" / f"{name}.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "core" / f"{name}.py").read_text()
    assert port == _rewrite(ref)


def test_every_module_of_the_core_is_copied_or_listed_as_changed():
    ref = {p.stem for p in (ROOT / "src" / "repro" / "core").glob("*.py")}
    port = {p.stem for p in
            (ROOT / "src" / "repro_torch" / "core").glob("*.py")}
    assert ref == port == set(VERBATIM) | set(CHANGED)


def test_learner_proc_is_the_reference_s():
    import inspect

    import repro.core.learner as ref_learner
    import repro_torch.core.learner as port_learner
    assert inspect.getsource(port_learner.make_learner_proc) == _rewrite(
        inspect.getsource(ref_learner.make_learner_proc))
    for name in ("HEARTBEAT_STALE", "RESTORE_TIME", "SAVE_TIME"):
        assert getattr(port_learner, name) == getattr(ref_learner, name)


# ---------------------------------------------------------------------------
# Virtual time: both platforms, the same calls
# ---------------------------------------------------------------------------
def _boot(core, seed, **kw):
    p = core.DLaaSPlatform(seed=seed, **kw)
    p.run(10)
    return p


def _submit(p, spec):
    h = p.submit(spec)
    p.run(5)
    assert h.acked and h.job_id, h.rejected
    return h


def _train(core, name, **kw):
    return core.JobManifest(name=name, **kw)


def _learner_kill(core):
    p = _boot(core, 11)
    h = _submit(p, _train(core, "kill", learners=4, total_steps=80,
                          step_time_s=0.5, checkpoint_interval_s=8))
    p.run(45)
    t = p.sim.now
    assert p.kill_pod(f"learner-{h.job_id}-2")
    p.run_until_terminal(h.job_id, timeout=900)
    return p, [(h.job_id, 4)], [(f"learner-{h.job_id}-2", t)]


def _node_crash(core):
    p = _boot(core, 5, n_nodes=8, gpus_per_node=4)
    h = _submit(p, _train(core, "node", learners=3, gpus_per_learner=2,
                          total_steps=60, step_time_s=0.5,
                          checkpoint_interval_s=10))
    p.run(40)
    t = p.sim.now
    assert p.crash_node_of(f"learner-{h.job_id}-0") is not None
    p.run_until_terminal(h.job_id, timeout=1200)
    return p, [(h.job_id, 3)], [(f"learner-{h.job_id}-0", t)]


def _fault_plan(core):
    p = _boot(core, 23)
    h = _submit(p, core.JobSpec(
        name="chaos", kind="train", max_restarts=20,
        resources=core.Resources(replicas=2, gpus_per_replica=1),
        train=core.TrainSpec(total_steps=60, step_time_s=0.5,
                             checkpoint_interval_s=10.0,
                             restart_budgets={"OOM": 5})))
    now = p.sim.now
    p.inject(core.FaultPlan((
        core.Fault(kind="oom", at=now, job=h.job_id, learner=0, at_step=5),
        core.Fault(kind="wedge", at=now + 20, job=h.job_id, learner=1,
                   at_step=15, detail="segfault in a custom op"),
        core.Fault(kind="straggler", at=now, job=h.job_id, learner=1,
                   slow_factor=4.0))))
    p.run_until_terminal(h.job_id, timeout=1500)
    return p, [(h.job_id, 2)], [(f"learner-{h.job_id}-0", now)]


def _corrupt_checkpoint(core):
    p = _boot(core, 41)
    h = _submit(p, _train(core, "corrupt", learners=2, total_steps=60,
                          step_time_s=0.5, checkpoint_interval_s=6))
    t = p.sim.now + 30
    p.inject(core.FaultPlan((core.Fault(kind="ckpt_corrupt", at=t,
                                        job=h.job_id, learner=0),)))
    p.run_until_terminal(h.job_id, timeout=1200)
    return p, [(h.job_id, 2)], [(f"learner-{h.job_id}-0", t)]


def _rejoin(core):
    p = _boot(core, 11)
    h = _submit(p, _train(core, "rejoin", learners=4, total_steps=80,
                          step_time_s=0.5, checkpoint_interval_s=8,
                          extras={"recovery_mode": "rejoin"}))
    p.run(45)
    t = p.sim.now
    assert p.kill_pod(f"learner-{h.job_id}-2")
    p.run_until_terminal(h.job_id, timeout=900)
    return p, [(h.job_id, 4)], [(f"learner-{h.job_id}-2", t)]


def _api_kill(core):
    p = _boot(core, 3)
    h = _submit(p, _train(core, "api", learners=1, total_steps=50,
                          step_time_s=0.3))
    t = p.sim.now
    p.kill_pod("api-0")
    p.run(0.5)
    assert p.client.status(h.job_id)["state"]
    p.run_until_terminal(h.job_id, timeout=600)
    return p, [(h.job_id, 1)], [("api-0", t)]


def _metadata_outage(core):
    p = _boot(core, 2)
    h = _submit(p, _train(core, "meta", learners=2, total_steps=40,
                          step_time_s=0.3))
    p.run(8)
    p.metadata.crash()
    late = p.submit(_train(core, "late", learners=1, total_steps=10,
                           step_time_s=0.2))
    p.run(12)
    assert not late.acked
    p.metadata.restart()
    p.run(5)
    assert late.acked
    p.run_until_terminal(h.job_id, timeout=600)
    p.run_until_terminal(late.job_id, timeout=600)
    return p, [(h.job_id, 2), (late.job_id, 1)], []


def _virtual_serve(core):
    p = _boot(core, 31)
    h = _submit(p, core.JobSpec(
        name="serve", kind="serve", framework="qwen3-0.6b",
        resources=core.Resources(replicas=2),
        serve=core.ServeSpec(requests=40, request_time_s=0.5)))
    p.run(10)
    t = p.sim.now
    assert p.kill_pod(f"server-{h.job_id}-1")
    p.run_until_terminal(h.job_id, timeout=900)
    return p, [(h.job_id, 2)], [(f"server-{h.job_id}-1", t)]


def _virtual_dryrun(core):
    p = _boot(core, 35)
    cells = (core.SweepCell("qwen3-0.6b", "train_4k"),
             core.SweepCell("paper-overhead-100m", "decode_32k", True),
             core.SweepCell("rwkv6-7b", "prefill_32k"))
    h = _submit(p, core.JobSpec(
        name="sweep", kind="dryrun", framework="qwen3-0.6b",
        dryrun=core.DryRunSpec(cells=cells, cell_time_s=6.0)))
    p.run(12)
    t = p.sim.now
    assert p.kill_pod(f"dryrun-{h.job_id}-0")
    p.run_until_terminal(h.job_id, timeout=900)
    return p, [(h.job_id, 1)], [(f"dryrun-{h.job_id}-0", t)]


SCENARIOS = {
    "learner-kill": _learner_kill, "node-crash": _node_crash,
    "fault-plan": _fault_plan, "corrupt-checkpoint": _corrupt_checkpoint,
    "rejoin": _rejoin, "api-kill": _api_kill,
    "metadata-outage": _metadata_outage, "virtual-serve": _virtual_serve,
    "virtual-dryrun": _virtual_dryrun,
}


def _record(p, jobs, kills):
    out = {"now": p.sim.now, "jobs": {}, "recovery": {}}
    for job_id, replicas in jobs:
        doc = p.metadata.get("jobs", job_id)
        out["jobs"][job_id] = {
            "doc": doc, "restarts": p.client.status(job_id)["restarts"],
            "events": p.client.events(job_id),
            "logs": [p.client.logs(job_id, i) for i in range(replicas)]}
    for pod, t in kills:
        out["recovery"][pod] = p.recovery_time(pod, t)
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_virtual_time_platform_equals_the_reference(scenario):
    ref = _record(*SCENARIOS[scenario](ref_core))
    port = _record(*SCENARIOS[scenario](port_core))
    for rec in ref["jobs"].values():             # the scenario did its work
        assert rec["doc"]["state"] in ("COMPLETED", "FAILED"), rec["doc"]
        assert any(rec["logs"]), rec
    if scenario not in ("metadata-outage", "api-kill"):
        assert all(v is not None for v in ref["recovery"].values()), ref
        assert any(r["restarts"] for r in ref["jobs"].values())
    assert port == ref


def test_port_registry_knows_its_configs_and_refuses_the_rest():
    """The port's registry holds the reference's 11 configs (D11 closed):
    a job naming seamless-m4t-medium is admitted, and its
    ``serve.real_compute`` refused at the gateway with the reference's
    reason, in both platforms; a framework neither knows is refused."""
    assert FrameworkRegistry.default().known() == (
        "deepseek-v2-236b", "gemma2-9b", "granite-moe-1b-a400m",
        "internvl2-76b", "mistral-large-123b", "paper-overhead-100m",
        "qwen2.5-32b", "qwen3-0.6b", "recurrentgemma-9b", "rwkv6-7b",
        "seamless-m4t-medium")
    assert FrameworkRegistry.default().known() == \
        ref_core.FrameworkRegistry.default().known()
    reasons = {}
    for core in (ref_core, port_core):
        p = _boot(core, 1)
        h = p.submit(core.JobManifest(name="g",
                                      framework="seamless-m4t-medium"))
        real = p.submit(core.JobSpec(
            name="s", kind="serve", framework="seamless-m4t-medium",
            serve=core.ServeSpec(reduced=True, real_compute=True)))
        other = p.submit(core.JobManifest(name="x", framework="whisper"))
        p.run(5)
        assert h.acked, h.rejected
        assert "unknown framework 'whisper'" in other.rejected
        reasons[core] = real.rejected
    assert reasons[port_core] == reasons[ref_core]
    assert "enc-dec caches are lockstep-only" in reasons[port_core]


def test_real_dryrun_needs_a_registered_payload():
    spec = port_core.JobSpec(name="d", kind="dryrun", dryrun=port_core.
                             DryRunSpec(cells=(port_core.SweepCell(
                                 "qwen3-0.6b", "train_4k"),),
                                 real_compute=True))
    p = _boot(port_core, 1)
    with pytest.raises(NotImplementedError, match="launch/dryrun.py"):
        ArchitectureAdapter("qwen3-0.6b").payload(p, "job-x", spec)
    p.register_payload("job-x", object())
    assert ArchitectureAdapter("qwen3-0.6b").payload(
        p, "job-x", spec) is p.payloads["job-x"]


# ---------------------------------------------------------------------------
# One job spec; fields the port does not implement are refused
# ---------------------------------------------------------------------------
def test_the_port_has_one_spec_with_the_reference_s_fields():
    assert port_spec.TrainSpec is port_core.TrainSpec
    assert port_spec.ServeSpec is port_core.ServeSpec
    for port_cls, ref_cls in ((port_core.TrainSpec, ref_core.TrainSpec),
                              (port_core.ServeSpec, ref_core.ServeSpec)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(
            ref_cls())


@pytest.mark.parametrize("field,value,what", [
    ("cache_layout", "dense", "paged cache only"),
    ("mesh", "prod", "one card"),
    ("ragged_prefill", False, "always ragged"),
    ("page_size", 3, "page_size"),
])
def test_engine_refuses_serve_fields_it_does_not_implement(field, value,
                                                           what):
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              cache_layout="paged")
    model = build_model(cfg, device=CPU)
    ServingEngine(cfg, model, port_core.ServeSpec(), device=CPU)
    sv = dataclasses.replace(port_core.ServeSpec(), **{field: value})
    with pytest.raises(NotImplementedError, match=what):
        ServingEngine(cfg, model, sv, device=CPU)


def test_train_loop_refuses_a_mesh():
    from repro_torch.launch import train as train_cli
    t = port_core.TrainSpec(total_steps=1, global_batch=2, seq_len=8,
                            mesh="prod")
    with pytest.raises(NotImplementedError, match="one card"):
        train_cli.train(get_config("paper-overhead-100m").reduced(), t,
                        seed=0, device=CPU)


# ---------------------------------------------------------------------------
# The checkpoint format
# ---------------------------------------------------------------------------
def _tree(rng):
    return {"params": {"w": rng.normal(size=(3, 5)).astype(np.float32),
                       "b": rng.normal(size=(5,)).astype(np.float32)},
            "opt": {"count": np.int32(7),
                    "m": {"w": rng.normal(size=(3, 5)).astype(np.float32)}},
            "step": np.int32(7), "flag": np.array([True, False])}


def _blobs(store):
    return {k: bytes(v) for k, v in store._blobs.items()}


def test_both_managers_write_the_same_keys_and_bytes():
    tree = _tree(np.random.default_rng(0))
    ref, port = RefStore(), ObjectStore()
    for step in (3, 9):
        assert RefCkpt(ref, "job").save(step, tree) == \
            CheckpointManager(port, "job").save(step, tree)
    assert _blobs(ref) == _blobs(port)
    # torch leaves (here on the CPU) write the bytes of their numpy twins
    as_torch = {"params": {k: torch.from_numpy(v)
                           for k, v in tree["params"].items()},
                "opt": tree["opt"], "step": torch.tensor(7, dtype=torch.int32),
                "flag": torch.tensor([True, False])}
    again = ObjectStore()
    for step in (3, 9):
        CheckpointManager(again, "job").save(step, as_torch)
    assert _blobs(again) == _blobs(ref)
    step, back = CheckpointManager(ref_to_port(ref), "job").load()
    assert step == 9
    for path in ("w", "b"):
        np.testing.assert_array_equal(back["params"][path],
                                      tree["params"][path])


def ref_to_port(store) -> ObjectStore:
    """The port's store holding the reference store's bytes."""
    out = ObjectStore()
    out._blobs = dict(store._blobs)
    return out


def test_bf16_leaves_cross_both_ways_without_ml_dtypes_in_the_port(
        monkeypatch):
    vals = np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)
    ref_bf16 = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    ref2 = RefStore()
    RefCkpt(ref2, "j").save(1, {"x": ref_bf16})
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)   # import fails
    t = torch.from_numpy(vals).to(torch.bfloat16)
    port = ObjectStore()
    CheckpointManager(port, "j").save(1, {"x": t})
    assert _blobs(ref2) == _blobs(port)
    _, back = CheckpointManager(ref_to_port(ref2), "j").load()
    assert back["x"].dtype == torch.bfloat16
    assert torch.equal(back["x"], t)
    monkeypatch.undo()
    ref = RefStore()
    ref._blobs = dict(port._blobs)
    _, got = RefCkpt(ref, "j").load()
    assert got["x"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["x"], np.float32),
                                  t.float().numpy())


def test_a_corrupted_blob_is_skipped_by_both_alike():
    rng = np.random.default_rng(2)
    trees = {s: _tree(rng) for s in (4, 8)}
    ref, port = RefStore(), ObjectStore()
    for s, tree in trees.items():
        RefCkpt(ref, "job").save(s, tree)
        CheckpointManager(port, "job").save(s, tree)
    for store in (ref, port):
        store.corrupt("ckpt/job/000000000008/blob/params/w", byte_index=5)
    r, p = RefCkpt(ref, "job"), CheckpointManager(port, "job")
    assert r.newest_invalid() == p.newest_invalid() == 8
    assert r.latest_valid_step() == p.latest_valid_step() == 4
    (rs, rt), (ps, pt) = r.load(), p.load()
    assert rs == ps == 4
    np.testing.assert_array_equal(pt["params"]["w"], rt["params"]["w"])
    assert r.load(8) is None and p.load(8) is None
    assert r.fallback_one() == p.fallback_one() == 4
    assert _blobs(ref) == _blobs(port)


# ---------------------------------------------------------------------------
# Real payloads: a reduced paper-overhead-100m learner in fp32
# ---------------------------------------------------------------------------
LR, WARMUP = 2e-3, 3
JOB_STEPS = 6       # the stated tolerances hold for the first 6 steps


def _cfgs():
    return (dataclasses.replace(ref_get_config("paper-overhead-100m")
                                .reduced(), dtype="float32"),
            dataclasses.replace(get_config("paper-overhead-100m").reduced(),
                                dtype="float32"))


class RefBatches:
    """The reference's own batches as numpy (the port's stream is drawn
    with numpy, D10)."""

    def __init__(self, rcfg):
        self.data = RefData(rcfg.vocab_size, 32, 4, seed=0)

    def batch_at(self, step):
        return {k: np.asarray(v, np.int64)
                for k, v in self.data.batch_at(step).items()}


class Recorded:
    """A payload whose steps are recorded as (step, loss)."""

    def __init__(self, inner):
        self.inner = inner
        self.losses = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, i):
        loss = self.inner.step(i)
        self.losses.append((i, loss))
        return loss


@pytest.fixture(scope="module")
def learners():
    """``(rcfg, make_ref, make_port, init)``: payload factories of both
    packages over one initial state (the reference's) and one run."""
    rcfg, tcfg = _cfgs()
    total = JOB_STEPS
    rrun = RefRunConfig(learning_rate=LR, warmup_steps=WARMUP,
                        total_steps=total)
    run = RunConfig(learning_rate=LR, warmup_steps=WARMUP, total_steps=total)
    init = jax.device_get(ref_steps.init_train_state(
        rcfg, jax.random.key(0), rrun))
    rstep = jax.jit(ref_steps.make_train_step(
        rcfg, RefCtx(mesh=None, dtype=jnp.float32), rrun))
    tstep = steps.make_train_step(tcfg, Ctx(device=CPU, dtype=torch.float32),
                                  run)

    def make_ref():
        return RefPayload(
            make_state=lambda: jax.tree.map(jnp.asarray, init),
            train_step=rstep, data=RefData(rcfg.vocab_size, 32, 4, seed=0))

    def make_port():
        return RealPayload(
            make_state=lambda: train_state_from_jax(init, tcfg, device=CPU),
            train_step=tstep, data=RefBatches(rcfg))

    return rcfg, make_ref, make_port, init


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _assert_states_close(got, want, steps_run):
    """``tests/test_torch_train.py``'s tolerances after ``steps_run``
    steps: weights within 2 lr a step, at most a thousandth of a leaf's
    elements more than 1e-5 off; moments within 1e-4 of each leaf's
    largest; count and step equal."""
    assert int(got["step"]) == int(want["step"])
    assert int(got["opt"]["count"]) == int(want["opt"]["count"])
    g = dict(_leaves(got["params"]))
    for path, w in _leaves(want["params"]):
        err = np.abs(g[path] - np.asarray(w, np.float32))
        assert err.max() <= 2 * LR * steps_run, (path, err.max())
        assert (err > 1e-5).mean() <= 1e-3, (path, (err > 1e-5).sum())
    for part in ("m", "v"):
        g = dict(_leaves(got["opt"][part]))
        for path, w in _leaves(want["opt"][part]):
            w = np.asarray(w, np.float32)
            err = np.abs(g[path] - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (part, path)


def _train_job(core, payload, kill_at_step):
    p = _boot(core, 21)
    h = _submit(p, core.JobManifest(
        name="real", learners=1, total_steps=JOB_STEPS, step_time_s=0.5,
        checkpoint_interval_s=1.5, real_compute=True))
    p.register_payload(h.job_id, payload)
    vol = p.volumes.get(f"vol-{h.job_id}")
    while vol.read("progress/0", {"step": 0})["step"] < kill_at_step:
        p.run(0.25)
    assert p.kill_pod(f"learner-{h.job_id}-0")
    state = p.run_until_terminal(h.job_id, timeout=900)
    return state, p.client.logs(h.job_id, 0), \
        p.client.status(h.job_id)["restarts"]


def test_real_training_job_under_both_platforms(learners):
    rcfg, make_ref, make_port, _ = learners
    ref, port = Recorded(make_ref()), Recorded(make_port())
    r_state, r_logs, r_restarts = _train_job(ref_core, ref, 5)
    p_state, p_logs, p_restarts = _train_job(port_core, port, 5)
    assert r_state == p_state == "COMPLETED"
    assert r_restarts == p_restarts == 1
    assert p_logs == r_logs
    assert "restored checkpoint step" in p_logs
    steps_run = [i for i, _ in port.losses]
    assert steps_run == [i for i, _ in ref.losses]
    assert len(steps_run) > len(set(steps_run)) == JOB_STEPS  # replayed
    for (i, got), (_, want) in zip(port.losses, ref.losses):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"loss of step {i}")
    _assert_states_close(port.snapshot(), jax.device_get(ref.state),
                         len(steps_run))


def _continue(payload, start, n):
    return [payload.step(i) for i in range(start, start + n)]


def test_checkpoints_cross_between_the_learners_both_ways(learners):
    _, make_ref, make_port, _ = learners
    # the JAX learner writes at step 6; the torch learner restores it
    ref = make_ref()
    ref.restore(None)
    _continue(ref, 0, 6)
    store = RefStore()
    RefCkpt(store, "job").save(6, jax.tree.map(np.asarray, ref.state))
    port = make_port()
    step, tree = CheckpointManager(ref_to_port(store), "job").load()
    assert port.restore(tree) == step == 6
    want = _continue(ref, 6, 4)
    np.testing.assert_allclose(_continue(port, 6, 4), want, rtol=1e-5)
    # the torch learner writes at step 10; the JAX learner restores it
    store = ObjectStore()
    CheckpointManager(store, "job").save(10, port.snapshot())
    other = make_ref()
    ref_store = RefStore()
    ref_store._blobs = dict(store._blobs)
    step, tree = RefCkpt(ref_store, "job").load()
    assert other.restore(tree) == step == 10
    np.testing.assert_allclose(_continue(other, 10, 3),
                               _continue(port, 10, 3), rtol=1e-5)


def test_snapshot_does_not_alias_the_live_state(learners):
    _, _, make_port, _ = learners
    port = make_port()
    port.restore(None)
    port.step(0)
    snap = port.snapshot()
    kept = copy.deepcopy(snap)
    port.step(1)
    for (pa, a), (pb, b) in zip(_leaves(snap), _leaves(kept)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=pa)
    assert int(port.snapshot()["step"]) == 2
    # a restore builds a new state and drops the old one
    old = port.state
    port.restore(kept)
    assert port.state is not old and int(port.state["step"]) == 1
    for (pa, a), (_, b) in zip(_leaves(port.snapshot()), _leaves(kept)):
        np.testing.assert_array_equal(a, b, err_msg=pa)


def test_restore_refuses_a_tree_of_another_layout(learners):
    _, _, make_port, init = learners
    port = make_port()
    tree = copy.deepcopy(init)
    del tree["opt"]["m"]["embed"]
    with pytest.raises(ValueError, match="lacks"):
        port.restore(tree)
    tree = copy.deepcopy(init)
    tree["params"]["embed"] = tree["params"]["embed"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        port.restore(tree)


def test_rejoin_restores_the_published_step_s_parameters(learners):
    """Rejoin mode: the chief publishes its snapshot to the volume after
    every step; the restarted learner restores it, and it holds the
    parameters of the step it names (later steps did not change it)."""
    _, _, make_port, _ = learners
    payload = make_port()
    restored = []
    inner_restore = payload.restore

    def restore(tree):
        out = inner_restore(tree)
        restored.append((out, None if tree is None else copy.deepcopy(tree)))
        return out
    payload.restore = restore
    p = _boot(port_core, 21)
    h = _submit(p, port_core.JobManifest(
        name="rejoin", learners=1, total_steps=JOB_STEPS, step_time_s=0.5,
        checkpoint_interval_s=100, real_compute=True,
        extras={"recovery_mode": "rejoin"}))
    p.register_payload(h.job_id, payload)
    vol = p.volumes.get(f"vol-{h.job_id}")
    while vol.read("progress/0", {"step": 0})["step"] < 4:
        p.run(0.25)
    assert p.kill_pod(f"learner-{h.job_id}-0")
    assert p.run_until_terminal(h.job_id, timeout=900) == "COMPLETED"
    logs = p.client.logs(h.job_id, 0)
    (first, _), (step, tree) = restored
    assert first == 0 and f"rejoined at step {step}" in logs
    assert step >= 4 and int(tree["step"]) == step
    fresh = make_port()
    fresh.restore(None)
    _continue(fresh, 0, step)
    for (pa, a), (_, b) in zip(_leaves(fresh.snapshot()), _leaves(tree)):
        np.testing.assert_array_equal(a, b, err_msg=pa)
    assert int(payload.state["step"]) == JOB_STEPS


# ---------------------------------------------------------------------------
# A real serve job under the port's platform
# ---------------------------------------------------------------------------
def test_serve_job_recovers_from_a_pod_kill_with_its_streams():
    spec = port_core.JobSpec(
        name="serve", kind="serve", framework="qwen3-0.6b",
        serve=port_core.ServeSpec(batch=3, prompt_len=24, gen=6, requests=7,
                                  reduced=True, real_compute=True,
                                  snapshot_every=2, request_time_s=2.0))
    p = _boot(port_core, 32)
    h = _submit(p, spec)
    p.register_payload(h.job_id, RealServePayload(spec, device=CPU))
    vol = p.volumes.get(f"vol-{h.job_id}")
    while vol.read("engine/0/snapshot") is None or vol.read("served", 0) < 1:
        p.run(0.2)
    assert vol.read("served") < spec.serve.requests
    assert p.kill_pod(f"server-{h.job_id}-0")
    assert p.run_until_terminal(h.job_id, timeout=900) == "COMPLETED"
    assert p.client.status(h.job_id)["restarts"] == 1
    assert "engine restored" in p.client.logs(h.job_id, 0)
    shipped = {}
    for r in range(spec.serve.requests):
        doc = json.loads(p.objectstore.get(
            f"cos/{h.job_id}/responses/{r}").decode())
        shipped[doc["req"]] = doc["tokens"]
    engine, requests = RealServePayload(spec, device=CPU).build()
    for r in requests:
        engine.submit(r)
    engine.run()
    assert shipped == engine.responses
    assert all(len(shipped[r.req]) == r.gen_len for r in requests)
