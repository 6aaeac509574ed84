"""The Guardian: per-job agent run as a K8S Job (paper §III-d/e/f).

Atomic deployment: the Guardian performs the multi-step deploy (volume,
network policy, gang admission, helper pod, workload pod set).  Because
it runs under K8S-Job semantics, a crash at ANY step restarts it with fresh
process state; the restarted incarnation first **rolls back** whatever the
previous incarnation partially deployed (recorded step-by-step in ETCD),
then redeploys from scratch.  After ``backoff_limit`` exhaustion the job is
marked FAILED in Mongo by the LCM.

Job API v2: the Guardian dispatches on ``JobSpec.kind`` through the
framework-adapter registry.  Train jobs get the full helper-pod + learner
StatefulSet topology with straggler detection and elastic DP; serve and
dryrun jobs get a gang of workload pods (servers / sweep runners) under
the same quota, metering, restart-budget, halt and teardown machinery —
every kind is a first-class, dependable platform job.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.core import states
from repro_torch.core.cluster import ContainerSpec, Deployment, PodSpec, StatefulSet
from repro_torch.core.failures import SelfHealer, action_for
from repro_torch.core.helper import (
    make_controller_proc, make_load_data_proc, make_log_collector_proc,
    make_store_results_proc)
from repro_torch.core.jobspec import JobSpec
from repro_torch.core.metadata import Unavailable
from repro_torch.core.recovery import StragglerDetector

DEPLOY_STEP_TIME = (0.1, 0.4)        # per multi-step-deploy action
MONITOR_PERIOD = 1.0

# Fig-4 startup ranges
HELPER_STARTUP = (3.0, 4.0)
LEARNER_STARTUP = (10.0, 20.0)
SERVER_STARTUP = (5.0, 10.0)         # inference replicas boot faster


def make_guardian_proc(platform, job_id: str, spec: JobSpec):
    def proc(pod):
        sim = platform.sim
        store = platform.statestore
        cluster = platform.cluster
        adapter = platform.frameworks.get(spec.framework)

        # -- helpers --------------------------------------------------------
        def update_job(fields: Dict[str, Any], event: str = None, *,
                       state: str = None):
            while True:
                try:
                    if state is not None:
                        states.job_transition(
                            platform.metadata, sim.now, job_id, state,
                            fields, event)
                    else:
                        platform.metadata.update("jobs", job_id, fields)
                        if event:
                            platform.metadata.append_event(
                                "jobs", job_id,
                                {"t": sim.now, "event": event})
                    return
                except Unavailable:
                    yield 0.5

        # ---- 1. read prior deploy record; roll back partial deployment ----
        prior = store.try_get(f"deploy/{job_id}/resources", [])
        if prior:
            sim.log(f"guardian/{job_id}: rolling back partial deploy {prior}")
            yield from _rollback(platform, job_id, spec, prior)
            yield from store.put(f"deploy/{job_id}/resources", [])
            yield from update_job(
                {}, event="ROLLBACK of partial deployment")

        # ---- 2. multi-step atomic deploy ------------------------------------
        resources: List[str] = []

        def record(res: str):
            resources.append(res)
            return store.put(f"deploy/{job_id}/resources", resources)

        yield from update_job({}, "DEPLOYING", state="DEPLOYING")

        # (a) shared NFS volume
        yield sim.rng.uniform(*DEPLOY_STEP_TIME)
        platform.volumes.provision(f"vol-{job_id}")
        ok = yield from record(f"volume/vol-{job_id}")
        if not ok:
            raise RuntimeError("etcd unavailable during deploy")

        # (b) network policy for tenant isolation
        yield sim.rng.uniform(*DEPLOY_STEP_TIME)
        platform.netpolicies[job_id] = {"tenant": spec.tenant,
                                        "job": job_id}
        yield from record(f"netpolicy/{job_id}")

        # (c) gang admission (quota + capacity, all-or-nothing).  Elastic
        # train jobs admit the largest feasible world when full capacity is
        # gone (e.g. a redeploy after a node died) instead of failing.
        yield sim.rng.uniform(*DEPLOY_STEP_TIME)
        gang = adapter.gang(spec)
        world, gpus_each = gang.replicas, gang.gpus_per_replica
        # gang_sizes must be updated in the same synchronous step as the
        # admission: a guardian crash happens only at a yield, and a yield
        # between admit_gang and the record would strand quota the next
        # incarnation's rollback cannot see (SC302 flags this window).
        try:
            platform.scheduler.admit_gang(
                cluster, spec.tenant, world, gpus_each)
            platform.gang_sizes[job_id] = world
        except Exception:
            if not (spec.elastic and spec.kind == "train"):
                raise
            world = platform.scheduler.max_feasible_gang(
                cluster, gpus_each, gang.replicas)
            if world < 1:
                raise
            platform.scheduler.admit_gang(
                cluster, spec.tenant, world, gpus_each)
            platform.gang_sizes[job_id] = world
            yield from update_job(
                {"world": world},
                f"ELASTIC admission {gang.replicas} -> {world}")
        platform.volumes.get(f"vol-{job_id}").write("world", world)
        yield from record(f"gang/{job_id}")

        # (d) helper pod (controller, load-data, log-collector,
        #     store-results) — train kind only; serve/dryrun workloads
        #     heartbeat straight through the volume and ship their own logs
        if spec.kind == "train":
            yield sim.rng.uniform(*DEPLOY_STEP_TIME)
            helper_spec = lambda i: PodSpec(
                name=f"helper-{job_id}",
                containers=[
                    ContainerSpec("load-data", make_load_data_proc(platform, job_id, spec)),
                    ContainerSpec("controller", make_controller_proc(platform, job_id, spec)),
                    ContainerSpec("log-collector", make_log_collector_proc(platform, job_id, spec)),
                    ContainerSpec("store-results", make_store_results_proc(platform, job_id, spec)),
                ],
                startup_range=HELPER_STARTUP,
                labels={"role": "helper", "job": job_id},
                tenant=spec.tenant)
            platform.deployments[f"helper-{job_id}"] = Deployment(
                cluster, f"helper-{job_id}", helper_spec, replicas=1)
            yield from record(f"deployment/helper-{job_id}")

        # (e) workload pod set (stable identities <role>-<job>-i), built by
        #     the framework adapter: learners / servers / sweep runners
        yield sim.rng.uniform(*DEPLOY_STEP_TIME)
        role = spec.role
        startup = LEARNER_STARTUP if spec.kind == "train" else SERVER_STARTUP
        mk = lambda i: PodSpec(
            name=f"{role}-{job_id}-{i}",
            containers=[ContainerSpec(
                role, adapter.workload_proc(platform, job_id, spec, i))],
            gpus=gpus_each,
            startup_range=startup,
            labels={"role": role, "job": job_id,
                    "tenant": spec.tenant},
            tenant=spec.tenant)
        ss = StatefulSet(cluster, f"learners-{job_id}", mk, replicas=world)
        platform.statefulsets[f"learners-{job_id}"] = ss
        yield from record(f"statefulset/learners-{job_id}")

        platform.tenancy.metering.job_started(
            job_id, spec.tenant, gang.replicas * gpus_each, sim.now)
        yield from update_job({}, "PROCESSING", state="PROCESSING")

        # ---- 3. monitor until completion/failure/halt -------------------------
        if spec.kind == "train":
            yield from _monitor_train(platform, job_id, spec, ss, store,
                                      update_job)
        else:
            yield from _monitor_gang(platform, job_id, spec, ss, store,
                                     update_job, world)
        return 0

    return proc


def _finish(platform, job_id: str, spec: JobSpec, store, update_job,
            state: str, event: str):
    """Shared terminal sequence: teardown, final state + event, settle
    metering.  Every monitor endgame (halt/fail/complete, any kind) runs
    through here so the bookkeeping can never drift apart."""
    yield from _teardown(platform, job_id, spec, store)
    yield from update_job({}, event, state=state)
    platform.tenancy.metering.job_stopped(job_id, platform.sim.now)


# ---------------------------------------------------------------------------
# Self-healing: classify → journal → safe-list repair → per-category budget
# ---------------------------------------------------------------------------
def _journal(platform, job_id: str, report):
    """Journal a FailureReport as a job event (Unavailable-tolerant, same
    retry discipline as update_job)."""
    while True:
        try:
            states.journal_failure(platform.metadata, platform.sim.now,
                                   job_id, report.to_doc())
            return
        except Unavailable:
            yield 0.5


def _heal_restarts(platform, job_id: str, spec: JobSpec, ss, update_job,
                   healer: SelfHealer):
    """Process restart bumps since the last monitor tick: classify each
    failure from pod-exit evidence, journal the report, apply the safe-list
    repair (or a plain restart for unknown/low-confidence failures), and
    charge the restart to its category's budget.

    Returns a FAILED message when some category's budget is exhausted,
    else None.  Repair-initiated kills (straggler restarts, poisoned-node
    evictions) were pre-announced via ``healer.expect_restart`` and are
    not charged; secondary pod deaths of an already-repaired poisoned-node
    incident are journaled but charged only once per incident.
    """
    role = healer.role
    healer.align(len(ss.restarts_total))
    for i in range(min(len(ss.restarts_total), len(healer.seen))):
        while ss.restarts_total[i] > healer.seen[i]:
            healer.seen[i] += 1
            healer.total += 1
            yield from update_job(
                {"restarts": healer.total},
                f"{role}-{i} RESTARTED (total restarts {healer.total})")
            if healer.absorb_expected(i):
                continue                  # our own kill — not a failure
            report = healer.classifier.classify(i, restarts=healer.seen[i])
            yield from _journal(platform, job_id, report)
            if healer.absorb_poison_incident(report):
                continue                  # incident already charged+repaired
            count = healer.charge(report.category)
            yield from update_job(
                {"failures_by_category": dict(healer.counts)})
            if count > healer.budget_for(report.category):
                return (f"FAILED: {report.category} failures {count} > "
                        f"budget {healer.budget_for(report.category)}")
            action, is_repair = action_for(
                report, healer.policy, healer.min_confidence)
            if is_repair:
                yield from _apply_repair(platform, job_id, spec, healer,
                                         report, action, update_job)
            else:
                yield from update_job(
                    {}, f"RESTART plain (no auto-repair: {report.category}, "
                        f"confidence {report.confidence:.2f})")
    return None


def _apply_repair(platform, job_id: str, spec: JobSpec, healer: SelfHealer,
                  report, action: str, update_job):
    """Apply one registered safe-list action (see failures.SAFE_REPAIRS).
    Every branch is bounded and reversible-by-restart; nothing here guesses.
    """
    vol = platform.volumes.get(f"vol-{job_id}")
    if action == "reduce_memory":
        # halve the learner page/memory budget; learners read the knob from
        # the shared volume on every step
        if vol is not None:
            vol.write("repair/mem_scale",
                      vol.read("repair/mem_scale", 1.0) * 0.5)
    elif action == "checkpoint_fallback":
        # drop exactly one (integrity-failed) newest generation and roll
        # the gang back to the newest valid one
        from repro_torch.core.checkpoint import CheckpointManager
        ck = CheckpointManager(platform.objectstore, job_id)
        target = ck.fallback_one()
        if vol is not None:
            epoch = vol.read("rollback_epoch", 0) + 1
            vol.write("rollback_epoch", epoch)
            vol.write("rollback_to", {"step": target or 0, "epoch": epoch})
    elif action == "reschedule_exclude_node":
        _repair_exclude_node(platform, job_id, report.node, healer)
        healer.note_poison_repaired(report.node)
    # restart_in_place: the StatefulSet already recreated the pod with a
    # fresh identity — the restart itself IS the registered repair
    yield from update_job(
        {}, f"REPAIR {action} ({report.category}, pod {report.pod})")


def _repair_exclude_node(platform, job_id: str, node: str,
                         healer: SelfHealer) -> None:
    """POISONED_NODE repair: exclude ``node`` from this job's placement and
    evict the job's remaining pods there so their controllers reschedule
    them elsewhere.  Synchronous on purpose (SC302 node_exclusion provider):
    no yield can separate the acquire from the evictions, so a Guardian
    crash cannot leave pods pinned to a node the job just excluded.  The
    exclusion is held until ``_rollback``'s sweep releases it."""
    platform.scheduler.exclude_node(job_id, node)
    prefix = f"{healer.role}-{job_id}-"
    for pod in list(platform.cluster.pods.values()):
        if pod.spec.labels.get("job") != job_id:
            continue
        if pod.node is None or pod.node.name != node:
            continue
        if pod.status not in ("PENDING", "RUNNING"):
            continue
        name = pod.spec.name
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            healer.expect_restart(int(name[len(prefix):]))
        pod.fail()


def _monitor_train(platform, job_id: str, spec: JobSpec, ss, store,
                   update_job):
    """Training monitor: elastic DP shrink, straggler detection, failure
    classification + safe auto-repair, per-category restart budgets,
    ETCD→Mongo status aggregation, halt, completion."""
    sim = platform.sim
    cluster = platform.cluster
    from repro_torch.core.elastic import ElasticPolicy
    straggler = StragglerDetector(spec.learners)
    elastic = ElasticPolicy(min_world=1)
    healer = SelfHealer(platform, job_id, spec, spec.role, spec.learners)
    tr = spec.train
    pending_stuck_s = tr.pending_stuck_s if tr is not None else 25.0
    helper_drain_s = tr.helper_drain_s if tr is not None else 60.0
    last_agg = None
    pending_since: Dict[int, float] = {}
    vol = platform.volumes.get(f"vol-{job_id}")
    while True:
        yield MONITOR_PERIOD

        # ---- elastic DP shrink: a learner stuck PENDING (capacity lost,
        # e.g. node died with no spare GPUs) stalls synchronous training
        # forever; if the job opted in, shrink the world instead.
        if spec.elastic:
            world = vol.read("world", spec.learners)
            stuck = 0
            for i, p in enumerate(ss.pods[:world]):
                if p.status == "PENDING":
                    pending_since.setdefault(i, sim.now)
                    if sim.now - pending_since[i] > pending_stuck_s:
                        stuck += 1
                else:
                    pending_since.pop(i, None)
            if stuck:
                new_world = elastic.decide(world, world - stuck)
                if new_world and new_world < world:
                    plan = elastic.remesh_plan(world, new_world, 256)
                    vol.write("world", new_world)
                    vol.write("remesh",
                              {"old": world, "new": new_world,
                               "shard_map": {str(k): v for k, v in
                                             plan.shard_map.items()}})
                    ss.resize(new_world)
                    platform.scheduler.release_gang(
                        spec.tenant, world - new_world,
                        spec.gpus_per_learner)
                    platform.gang_sizes[job_id] = new_world
                    yield from update_job(
                        {"world": new_world},
                        f"ELASTIC shrink {world} -> {new_world} "
                        f"(capacity lost; DP re-mesh)")
                    pending_since.clear()

        # user-initiated halt?
        try:
            doc = platform.metadata.get("jobs", job_id)
        except Unavailable:
            doc = None
        if doc and doc.get("desired_state") == "HALTED":
            yield from _finish(platform, job_id, spec, store, update_job,
                               "HALTED", "HALTED by user")
            return 0

        # failure detection: classify each restart from pod-exit evidence,
        # journal it, auto-repair from the safe list, charge its budget
        fail = yield from _heal_restarts(platform, job_id, spec, ss,
                                         update_job, healer)
        if fail:
            yield from _finish(platform, job_id, spec, store, update_job,
                               "FAILED", fail)
            return 0

        # aggregate learner statuses from ETCD -> Mongo
        world = vol.read("world", spec.learners) if vol else \
            spec.learners
        sts = [store.try_get(f"status/{job_id}/learner/{i}")
               for i in range(world)]
        if all(s and s["state"] == "SUCCEEDED" for s in sts):
            # let the helper finish log shipping + results upload first
            helper = platform.deployments.get(f"helper-{job_id}")
            deadline = sim.now + helper_drain_s
            while helper is not None and not helper.all_succeeded() \
                    and sim.now < deadline:
                yield 1.0
            yield from _finish(platform, job_id, spec, store, update_job,
                               "COMPLETED", "COMPLETED")
            return 0

        agg = _aggregate(sts)
        if agg != last_agg:
            yield from update_job(
                {"learner_states": agg}, f"status: {agg}")
            last_agg = agg

        # straggler detection from heartbeat progress; the restart is a
        # registered repair (restart_in_place), pre-announced so the bump
        # is absorbed instead of being classified as a fresh failure
        steps_list = [s.get("step") if s else None for s in sts]
        steps_list += [None] * (spec.learners - len(steps_list))
        slow = straggler.update(sim.now, steps_list)
        for i in slow:
            report = healer.classifier.straggler_report(
                i, step=steps_list[i] if i < len(steps_list) else None)
            yield from _journal(platform, job_id, report)
            count = healer.charge("STRAGGLER")
            yield from update_job(
                {"failures_by_category": dict(healer.counts)},
                f"learner-{i} STRAGGLER (progress lag); restarting")
            if count > healer.budget_for("STRAGGLER"):
                yield from _finish(
                    platform, job_id, spec, store, update_job, "FAILED",
                    f"FAILED: STRAGGLER failures {count} > "
                    f"budget {healer.budget_for('STRAGGLER')}")
                return 0
            action, is_repair = action_for(
                report, healer.policy, healer.min_confidence)
            healer.expect_restart(i)
            cluster.kubectl_delete_pod(f"learner-{job_id}-{i}")
            if is_repair:
                yield from update_job(
                    {}, f"REPAIR {action} ({report.category}, "
                        f"pod {report.pod})")


def _monitor_gang(platform, job_id: str, spec: JobSpec, ss, store,
                  update_job, world: int):
    """Generic gang monitor for serve/dryrun kinds: halt, failure
    classification + per-category restart budgets, volume-exit completion,
    progress surfaced into the job document."""
    vol = platform.volumes.get(f"vol-{job_id}")
    healer = SelfHealer(platform, job_id, spec, spec.role, world)
    last_note = None
    while True:
        yield MONITOR_PERIOD

        # user-initiated halt?
        try:
            doc = platform.metadata.get("jobs", job_id)
        except Unavailable:
            doc = None
        if doc and doc.get("desired_state") == "HALTED":
            yield from _finish(platform, job_id, spec, store, update_job,
                               "HALTED", "HALTED by user")
            return 0

        # failure classification + per-category budgets (K8S recreates
        # crashed replicas in place; every bump is classified + journaled)
        fail = yield from _heal_restarts(platform, job_id, spec, ss,
                                         update_job, healer)
        if fail:
            yield from _finish(platform, job_id, spec, store, update_job,
                               "FAILED", fail)
            return 0

        # completion: every workload pod wrote its exit file
        exits = [vol.read(f"exit/{i}") for i in range(world)]
        if all(e is not None for e in exits):
            ok = all(e == 0 for e in exits)
            yield from _finish(
                platform, job_id, spec, store, update_job,
                "COMPLETED" if ok else "FAILED",
                "COMPLETED" if ok else f"FAILED: exit codes {exits}")
            return 0

        # surface gang progress into the job document
        if spec.kind == "serve":
            note = f"RUNNING (served {vol.read('served', 0)})"
        else:
            done = len(vol.ls("cell/"))
            note = f"RUNNING (cells {done})"
        if note != last_note:
            yield from update_job({"learner_states": note}, f"status: {note}")
            last_note = note


def _aggregate(sts) -> str:
    seen = [s["state"] if s else states.UNKNOWN for s in sts]
    worst = states.UNKNOWN
    for o in states.LEARNER_PRIORITY:
        if o in seen:
            worst = o
            break
    steps = [s.get("step") for s in sts if s and s.get("step") is not None]
    return f"{worst} (min step {min(steps) if steps else 0})"


def _delete_pod_set(registry, name):
    ctl = registry.pop(name, None)
    if ctl is not None:
        ctl.delete()
        for p in ctl.pods:
            p.fail()


def _release_gang(platform, job_id, spec):
    # gang_sizes (not spec.learners) is the amount actually admitted —
    # elastic jobs may hold less, and releasing a gang that was never
    # admitted would corrupt another tenant's quota.
    n = platform.gang_sizes.pop(job_id, None)
    if n is not None:
        platform.scheduler.release_gang(
            spec.tenant, n, spec.gpus_per_learner)


def _rollback(platform, job_id, spec, resources):
    """Delete partially-created resources in reverse creation order, then
    sweep anything the deploy created but never recorded — a crash can
    land between a resource's creation and its ETCD record, and resource
    names are deterministic per job, so the sweep is idempotent."""
    for res in reversed(resources):
        kind, name = res.split("/", 1)
        yield platform.sim.rng.uniform(*DEPLOY_STEP_TIME)
        if kind == "statefulset":
            _delete_pod_set(platform.statefulsets, name)
        elif kind == "deployment":
            _delete_pod_set(platform.deployments, name)
        elif kind == "gang":
            _release_gang(platform, job_id, spec)
        elif kind == "netpolicy":
            platform.netpolicies.pop(job_id, None)
        elif kind == "volume":
            platform.volumes.release(name)
    # safety-net sweep for unrecorded leftovers, reverse creation order
    _delete_pod_set(platform.statefulsets, f"learners-{job_id}")
    _delete_pod_set(platform.deployments, f"helper-{job_id}")
    _release_gang(platform, job_id, spec)
    # node exclusions acquired by the POISONED_NODE repair die with the
    # job (or with the incarnation that held them — a restarted Guardian
    # re-learns them from fresh evidence if the node is still bad)
    platform.scheduler.clear_exclusions(job_id)
    platform.netpolicies.pop(job_id, None)
    platform.volumes.release(f"vol-{job_id}")


def _teardown(platform, job_id, spec, store):
    """Orderly cleanup at job end (volume contents are shipped already)."""
    res = store.try_get(f"deploy/{job_id}/resources", [])
    yield from _rollback(platform, job_id, spec, res)
    yield from store.put(f"deploy/{job_id}/resources", [])
