"""Helper pod: load-data, controller, log-collector, store-results.

The helper pod is isolated from the learner pods (different pod, same NFS
volume).  The controller detects learner completion/failure from exit files
and heartbeats on the shared volume and records per-learner status in the
replicated state store (ETCD) — resilient to crashes of the controller
(restart re-reads the volume), of the Guardian (statuses wait in ETCD) and
of learners (stale heartbeats).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import states
from repro_torch.core.jobspec import JobSpec

DATA_BW_GBPS = 0.5           # object-store → volume streaming bandwidth


def make_load_data_proc(platform, job_id: str, spec: JobSpec):
    def proc(pod):
        vol = platform.volumes.get(f"vol-{job_id}")
        # stream the dataset from COS to the shared volume
        remaining = vol.read("data_remaining_gb", spec.dataset_gb)
        while remaining > 0:
            yield 1.0
            remaining = max(0.0, remaining - DATA_BW_GBPS)
            vol.write("data_remaining_gb", remaining)   # resumable download
        vol.write("data_ready", True)
        return 0
    return proc


def make_controller_proc(platform, job_id: str, spec: JobSpec):
    """Watches the volume; writes learner statuses to ETCD; decides
    checkpoint-mode rollbacks on learner failure."""

    def proc(pod):
        sim = platform.sim
        vol = platform.volumes.get(f"vol-{job_id}")
        store = platform.statestore
        stale_after = 3.0 * spec.step_time_s + 2.0
        was_unreachable = False

        while True:
            world = vol.read("world", spec.learners)
            any_running = False
            for i in range(world):
                ex = vol.read(f"exit/{i}")
                pr = vol.read(f"progress/{i}")
                if ex == 0:
                    st = states.learner_status(
                        "SUCCEEDED", step=pr["step"] if pr else None,
                        t=sim.now)
                elif ex is not None:
                    st = states.learner_status("FAILED", exit=ex, t=sim.now)
                elif pr is None:
                    st = states.learner_status("STARTING", t=sim.now)
                    any_running = True
                elif sim.now - pr["t"] > stale_after:
                    st = states.learner_status(
                        "UNREACHABLE", step=pr["step"], t=sim.now,
                        last_seen=pr["t"])
                    any_running = True
                else:
                    st = states.learner_status(
                        "RUNNING", step=pr["step"], t=sim.now,
                        stalled=pr.get("stalled", False))
                    any_running = True
                ok = yield from store.put(f"status/{job_id}/learner/{i}", st)
                if not ok:
                    # statestore momentarily without quorum; retry next tick
                    pass

            # checkpoint-mode group rollback: once per failure incident
            if spec.recovery_mode == "checkpoint" \
                    and world > 1:
                sts = [store.try_get(f"status/{job_id}/learner/{i}")
                       for i in range(world)]
                unreachable = any(s and s["state"] == "UNREACHABLE" for s in sts)
                if unreachable and not was_unreachable:
                    from repro_torch.core.checkpoint import CheckpointManager
                    ck = CheckpointManager(platform.objectstore, job_id)
                    target = ck.latest_valid_step() or 0
                    # re-read per incident: the Guardian's checkpoint-
                    # fallback repair also bumps this counter, and a stale
                    # cached value here would reuse its epoch (learners
                    # would ack one rollback and skip the other)
                    rb_epoch = vol.read("rollback_epoch", 0) + 1
                    vol.write("rollback_epoch", rb_epoch)
                    vol.write("rollback_to", {"step": target, "epoch": rb_epoch})
                    vol.append("log/controller",
                               f"[{sim.now:.2f}] rollback to {target}")
                was_unreachable = unreachable

            if not any_running:
                return 0
            yield 1.0

    return proc


def make_log_collector_proc(platform, job_id: str, spec: JobSpec):
    def proc(pod):
        vol = platform.volumes.get(f"vol-{job_id}")
        store = platform.objectstore
        shipped: Dict[str, int] = {}
        while True:
            done = all(vol.read(f"exit/{i}") is not None
                       for i in range(vol.read("world", spec.learners)))
            for path in vol.ls("log/"):
                lines = vol.read(path, [])
                n0 = shipped.get(path, 0)
                if len(lines) > n0:
                    # append-only shipping: logs survive learner crashes,
                    # and the blob grows in place — get()+put() here wrote
                    # O(n²) bytes over a job's lifetime
                    key = f"cos/{job_id}/logs/{path.split('/', 1)[1]}"
                    new = "\n".join(lines[n0:]).encode()
                    store.append(key, new + b"\n")
                    shipped[path] = len(lines)
            if done:
                return 0
            yield 2.0
    return proc


def make_store_results_proc(platform, job_id: str, spec: JobSpec):
    def proc(pod):
        vol = platform.volumes.get(f"vol-{job_id}")
        while True:
            world = vol.read("world", spec.learners)
            exits = [vol.read(f"exit/{i}") for i in range(world)]
            if all(e is not None for e in exits):
                if all(e == 0 for e in exits):
                    platform.objectstore.put(
                        f"cos/{job_id}/results/model",
                        f"trained:{spec.framework}:{spec.total_steps}"
                        .encode())
                return 0
            yield 2.0
    return proc
