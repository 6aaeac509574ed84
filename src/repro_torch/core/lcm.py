"""Lifecycle Manager: owns jobs from submission to completion (§III-c/d).

Reconciliation-loop design (our K8S-idiomatic adaptation of the paper's
API→LCM gRPC handoff, recorded in DESIGN.md): the LCM polls Mongo for
SUBMITTED jobs and creates a **Guardian K8S Job** for each — a quick single
step (paper: <3 s), after which K8S owns guardian restarts.  An LCM crash
loses nothing: the next incarnation resumes from Mongo state.  Garbage
collection reaps resources of terminal jobs whose guardian died for good.
"""
from __future__ import annotations

from repro_torch.core import states
from repro_torch.core.cluster import ContainerSpec, KJob, PodSpec
from repro_torch.core.guardian import make_guardian_proc, _rollback
from repro_torch.core.jobspec import spec_from_job_doc
from repro_torch.core.metadata import Unavailable

GUARDIAN_STARTUP = (1.0, 2.0)        # Fig-4: guardian creation < 3 s
GUARDIAN_BACKOFF_LIMIT = 6
POLL = 1.0


def make_lcm_proc(platform):
    def proc(pod):
        sim = platform.sim
        while True:
            yield POLL
            try:
                subs = platform.metadata.find(
                    "jobs", lambda d: d["state"] == "SUBMITTED")
                terminal = platform.metadata.find(
                    "jobs", lambda d: d["state"] in
                    ("COMPLETED", "FAILED", "HALTED"))
            except Unavailable:
                continue

            for doc in subs:
                job_id = doc["id"]
                if job_id in platform.guardians:
                    continue                     # another LCM replica won
                spec = spec_from_job_doc(doc)    # v2 doc or legacy manifest
                pod_spec = PodSpec(
                    name=f"guardian-{job_id}",
                    containers=[ContainerSpec(
                        "guardian",
                        make_guardian_proc(platform, job_id, spec))],
                    startup_range=GUARDIAN_STARTUP,
                    labels={"role": "guardian", "job": job_id})

                def on_exhausted(job_id=job_id, spec=spec):
                    # guardian retries exhausted -> FAIL the job + reap
                    def reaper():
                        res = platform.statestore.try_get(
                            f"deploy/{job_id}/resources", [])
                        yield from _rollback(platform, job_id, spec, res)
                        # settle metering if the guardian died after
                        # job_started — otherwise the dead job would accrue
                        # in-flight GPU-seconds forever
                        platform.tenancy.metering.job_stopped(job_id, sim.now)
                        try:
                            states.job_transition(
                                platform.metadata, sim.now, job_id, "FAILED",
                                event="FAILED: guardian backoff exhausted")
                        except Unavailable:
                            pass
                    sim.spawn(reaper())

                platform.guardians[job_id] = KJob(
                    platform.cluster, f"guardian-{job_id}", pod_spec,
                    backoff_limit=GUARDIAN_BACKOFF_LIMIT,
                    on_exhausted=on_exhausted)
                try:
                    states.job_transition(
                        platform.metadata, sim.now, job_id, "DEPLOYING",
                        event="DEPLOYING (guardian created)")
                except Unavailable:
                    pass
                sim.log(f"lcm: guardian created for {job_id}")

            # GC: terminal job whose learner set still exists (guardian died
            # before teardown) — safety net
            for doc in terminal:
                job_id = doc["id"]
                name = f"learners-{job_id}"
                if name in platform.statefulsets:
                    spec = spec_from_job_doc(doc)
                    res = platform.statestore.try_get(
                        f"deploy/{job_id}/resources", [])
                    if res:
                        sim.log(f"lcm: gc {job_id}")
                        yield from _rollback(platform, job_id, spec, res)
                        yield from platform.statestore.put(
                            f"deploy/{job_id}/resources", [])

    return proc
