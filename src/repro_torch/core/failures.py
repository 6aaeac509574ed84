"""Failure taxonomy: typed fault injection + evidence-based classification.

The paper's dependability story stops at "detect failure, restart within
budget"; FfDL (arXiv:1909.06526) and the IBM DLaaS paper (arXiv:1709.05871)
both diagnose failure *causes* before choosing a remedy.  This module is
that diagnose-then-repair layer for our platform, in three pieces:

* **FaultPlan / FaultInjector** — chaos injection as a first-class platform
  API.  A plan is a tuple of typed, timed faults (OOM, checkpoint
  corruption, flaky pod, poisoned node, slow-loss straggler, wedge); the
  injector schedules them on the sim's virtual clock (``Sim.at``), so a
  chaos scenario is scripted and replayable — never a hand-rolled
  ``kill_pod`` at an eyeballed time.
* **FailureClassifier** — turns pod exit evidence (exit detail, node
  co-occurrence from the cluster's tombstone history, checkpoint
  integrity, ETCD status docs, restart history) into a
  :class:`FailureReport` with a category from
  ``states.FAILURE_CATEGORIES`` and a confidence.
* **Repair registry** — the *safe list*: each category maps to exactly one
  registered repair action.  ``UNKNOWN`` is deliberately absent — an
  unrecognized or low-confidence failure gets a plain restart, never a
  guessed repair.  The Guardian applies the action and charges the restart
  to the category's own budget (``TrainSpec.restart_budgets``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.states import FAILURE_CATEGORIES

FAULT_KINDS = ("oom", "ckpt_corrupt", "flaky_pod", "poison_node",
               "straggler", "wedge")

#: exit-detail signature the OOM gate raises with (exit 137 = SIGKILL by
#: the kernel OOM killer — the signature real K8s surfaces)
OOM_SIGNATURE = "OOMKilled (exit 137)"


class InjectedOOM(RuntimeError):
    """Learner memory budget exceeded (injected).  RuntimeError so the pod
    fails its own job under the sim's sandbox (SC101)."""


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Fault:
    """One typed, timed fault.

    ``at`` is absolute virtual time.  Gate kinds (``oom``, ``straggler``,
    ``wedge``) arm a condition the learner procs consult; trigger kinds
    (``flaky_pod``, ``ckpt_corrupt``, ``poison_node``) act on the cluster
    when their time arrives.
    """

    kind: str
    at: float = 0.0
    job: str = ""                 # job id the fault targets
    learner: int = 0              # learner/replica index
    pod: str = ""                 # explicit pod name (default learner-job-i)
    node: str = ""                # poison_node: explicit node (default: the
                                  # node hosting the target pod)
    at_step: int = 0              # oom/wedge: fire once step >= at_step
    clears_below: float = 0.5     # oom: gate clears once the repair has
                                  # lowered repair/mem_scale to <= this
    slow_factor: float = 4.0      # straggler: per-step slowdown multiplier
    incarnations: int = 1         # straggler: how many incarnations stay slow
    detail: str = ""              # wedge: the (unrecognized) crash message

    def pod_name(self) -> str:
        return self.pod or f"learner-{self.job}-{self.learner}"


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seed-independent chaos script."""

    faults: Tuple[Fault, ...] = ()

    def validate(self) -> Optional[str]:
        for f in self.faults:
            if f.kind not in FAULT_KINDS:
                return (f"unknown fault kind {f.kind!r}; "
                        f"known: {list(FAULT_KINDS)}")
            if f.kind != "poison_node" and not f.job and not f.pod:
                return f"fault {f.kind!r} needs a target job or pod"
            if f.kind == "poison_node" and not (f.node or f.job or f.pod):
                return "poison_node needs a node or a target pod"
            if f.at < 0:
                return f"fault {f.kind!r}: at must be >= 0"
            if f.kind == "straggler" and (f.slow_factor <= 1.0
                                          or f.incarnations < 1):
                return ("straggler needs slow_factor > 1 and "
                        "incarnations >= 1")
        return None


class FaultInjector:
    """Platform-resident executor for :class:`FaultPlan`s.

    Owned by ``DLaaSPlatform`` (``platform.faults``); armed via
    ``platform.inject(plan)``.  Learner procs consult the gate hooks
    (``learner_gate`` / ``incarnation_factor``) every step, so gates fire
    deterministically at the declared step regardless of restart timing.
    """

    CKPT_RETRY_S = 5.0     # ckpt_corrupt waits for a checkpoint to exist

    def __init__(self, platform):
        self.platform = platform
        self._oom: Dict[Tuple[str, int], Fault] = {}
        self._wedge: Dict[Tuple[str, int], Fault] = {}
        self._slow: Dict[Tuple[str, int], Fault] = {}
        self._slow_left: Dict[Tuple[str, int], int] = {}

    # -- arming ---------------------------------------------------------
    def arm(self, plan: FaultPlan) -> None:
        err = plan.validate()
        if err:
            raise ValueError(f"invalid FaultPlan: {err}")
        for f in plan.faults:
            self.platform.sim.at(f.at, self._trigger, f)

    def _trigger(self, f: Fault) -> None:
        sim = self.platform.sim
        key = (f.job, f.learner)
        if f.kind == "oom":
            self._oom[key] = f
        elif f.kind == "wedge":
            self._wedge[key] = f
        elif f.kind == "straggler":
            self._slow[key] = f
            self._slow_left[key] = f.incarnations
        elif f.kind == "flaky_pod":
            sim.log(f"fault: flaky_pod kills {f.pod_name()}")
            self.platform.cluster.kubectl_delete_pod(f.pod_name())
        elif f.kind == "poison_node":
            node = f.node or self._node_of(f.pod_name())
            if node is None:
                sim.log(f"fault: poison_node target {f.pod_name()} "
                        f"not placed yet; retrying")
                sim.schedule(self.CKPT_RETRY_S, self._trigger, f)
                return
            self.platform.cluster.poison_node(node)
        elif f.kind == "ckpt_corrupt":
            self._corrupt_newest(f)

    def _node_of(self, pod_name: str) -> Optional[str]:
        for pod in self.platform.cluster.pods.values():
            if pod.spec.name == pod_name and pod.node is not None:
                return pod.node.name
        return None

    def _corrupt_newest(self, f: Fault) -> None:
        """Flip bytes in every blob of the newest checkpoint generation,
        then kill the chief (the incident a corrupt write rides in on).
        Retries until the job has published a checkpoint."""
        from repro_torch.core.checkpoint import CheckpointManager
        sim = self.platform.sim
        store = self.platform.objectstore
        ck = CheckpointManager(store, f.job)
        steps = ck.steps()
        if not steps:
            sim.schedule(self.CKPT_RETRY_S, self._trigger, f)
            return
        base = f"ckpt/{f.job}/{steps[-1]:012d}/blob/"
        for path in store.list_prefix(base):
            store.corrupt(path)
        sim.log(f"fault: ckpt_corrupt step {steps[-1]} of {f.job}")
        self.platform.cluster.kubectl_delete_pod(f.pod_name())

    # -- gates consulted by learner procs -------------------------------
    def learner_gate(self, job_id: str, idx: int, step: int, vol) -> None:
        """Called once per training step; raises to crash the learner."""
        key = (job_id, idx)
        f = self._oom.get(key)
        if f is not None and step >= f.at_step:
            if vol.read("repair/mem_scale", 1.0) > f.clears_below:
                raise InjectedOOM(
                    f"{OOM_SIGNATURE}: learner memory budget exceeded "
                    f"at step {step}")
        w = self._wedge.get(key)
        if w is not None and step >= w.at_step:
            del self._wedge[key]          # one-shot
            raise RuntimeError(
                w.detail or "container terminated unexpectedly "
                            "(cause undetermined)")

    def incarnation_factor(self, job_id: str, idx: int) -> float:
        """Per-incarnation step-time multiplier (slow-loss straggler).
        Consumes one armed incarnation per call; after the budgeted
        incarnations a restarted learner runs at full speed — so the
        registered restart repair genuinely cures the straggler."""
        key = (job_id, idx)
        if self._slow_left.get(key, 0) > 0:
            self._slow_left[key] -= 1
            return self._slow[key].slow_factor
        return 1.0


# ---------------------------------------------------------------------------
# Failure reports + classification
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FailureReport:
    """Classified failure: category + confidence + the evidence used."""

    category: str
    confidence: float
    pod: str = ""
    learner: int = -1
    node: str = ""
    evidence: Dict[str, Any] = field(default_factory=dict)

    def to_doc(self) -> Dict[str, Any]:
        return {"category": self.category, "confidence": self.confidence,
                "pod": self.pod, "learner": self.learner, "node": self.node,
                "evidence": dict(self.evidence)}


class FailureClassifier:
    """Evidence → FailureReport, priority-ordered by signature strength.

    1. ``OOM``            — the OOM-killer signature in the exit detail;
    2. ``CKPT_CORRUPT``   — the newest checkpoint generation fails
       integrity (a restore now silently loses work);
    3. ``POISONED_NODE``  — >= 2 *distinct* pods recently died on the same
       still-alive node (a dead node is the scheduler's problem already);
    4. ``UNKNOWN``        — an exit detail nobody recognizes (low
       confidence: never auto-repaired);
    5. ``FLAKY_POD``      — a detail-free one-shot crash.
    """

    CO_OCCUR_WINDOW_S = 120.0
    CO_OCCUR_MIN_PODS = 2

    def __init__(self, platform, job_id: str, spec, role: str = "learner"):
        self.platform = platform
        self.job_id = job_id
        self.spec = spec
        self.role = role

    # -- evidence gathering ---------------------------------------------
    def _latest_failed_record(self, name: str):
        for rec in reversed(self.platform.cluster.pod_history):
            if rec.name == name and rec.status == "FAILED":
                return rec
        return None

    def _node_cofailures(self, node: str) -> Set[str]:
        now = self.platform.sim.now
        return {rec.name for rec in self.platform.cluster.pod_history
                if rec.node == node and rec.status == "FAILED"
                and now - rec.finished_at <= self.CO_OCCUR_WINDOW_S}

    def _node_alive(self, node: str) -> bool:
        return any(n.name == node and n.alive
                   for n in self.platform.cluster.nodes)

    # -- classification --------------------------------------------------
    def classify(self, idx: int, restarts: int = 0) -> FailureReport:
        name = f"{self.role}-{self.job_id}-{idx}"
        rec = self._latest_failed_record(name)
        detail = rec.exit_detail if rec is not None else ""
        node = (rec.node or "") if rec is not None else ""
        status = self.platform.statestore.try_get(
            f"status/{self.job_id}/learner/{idx}")
        evidence: Dict[str, Any] = {
            "exit_detail": detail, "restarts": restarts,
            "last_status": status.get("state") if status else None,
        }
        mk = lambda cat, conf: FailureReport(
            category=cat, confidence=conf, pod=name, learner=idx,
            node=node, evidence=evidence)

        if OOM_SIGNATURE in detail or "exit 137" in detail:
            return mk("OOM", 0.95)

        if self.spec.kind == "train":
            from repro_torch.core.checkpoint import CheckpointManager
            bad = CheckpointManager(
                self.platform.objectstore, self.job_id).newest_invalid()
            if bad is not None:
                evidence["corrupt_step"] = bad
                return mk("CKPT_CORRUPT", 0.9)

        if node and self._node_alive(node):
            cofailed = self._node_cofailures(node)
            if len(cofailed) >= self.CO_OCCUR_MIN_PODS:
                evidence["co_failed"] = sorted(cofailed)
                return mk("POISONED_NODE", 0.85)

        if detail:
            return mk("UNKNOWN", 0.3)
        return mk("FLAKY_POD", 0.6)

    def straggler_report(self, idx: int, **evidence: Any) -> FailureReport:
        """STRAGGLER reports come from the progress detector, not from
        crash evidence — the pod is alive, just lagging."""
        name = f"{self.role}-{self.job_id}-{idx}"
        ev: Dict[str, Any] = {"detector": "progress-lag"}
        ev.update(evidence)
        return FailureReport(category="STRAGGLER", confidence=0.9,
                             pod=name, learner=idx, evidence=ev)


# ---------------------------------------------------------------------------
# Safe-repair registry
# ---------------------------------------------------------------------------
#: category -> registered repair action.  THE safe list: the Guardian will
#: only ever apply an action found here.  UNKNOWN is deliberately absent.
SAFE_REPAIRS: Dict[str, str] = {
    "OOM": "reduce_memory",
    "CKPT_CORRUPT": "checkpoint_fallback",
    "FLAKY_POD": "restart_in_place",
    "POISONED_NODE": "reschedule_exclude_node",
    "STRAGGLER": "restart_in_place",
}

PLAIN_RESTART = "restart"


def action_for(report: FailureReport, policy: str = "auto",
               min_confidence: float = 0.6) -> Tuple[str, bool]:
    """Resolve the repair for a report.  Returns ``(action, is_repair)``;
    ``is_repair=False`` means plain restart (no safe-list action applies:
    unknown category, confidence below threshold, or restart-only policy).
    """
    action = SAFE_REPAIRS.get(report.category)
    if (policy != "auto" or action is None
            or report.confidence < min_confidence):
        return PLAIN_RESTART, False
    return action, True


class SelfHealer:
    """Per-job failure bookkeeping shared by both Guardian monitors:
    expected-restart absorption (repair-initiated kills are not failures),
    per-category charge counters, and poisoned-node incident dedup (one
    node incident = one charge, however many pods it took down)."""

    POISON_INCIDENT_S = 60.0

    def __init__(self, platform, job_id: str, spec, role: str, n: int):
        self.platform = platform
        self.job_id = job_id
        self.spec = spec
        self.role = role
        self.classifier = FailureClassifier(platform, job_id, spec, role)
        self.counts: Dict[str, int] = {}
        self.total = 0
        self.seen: List[int] = [0] * n        # restarts already processed
        self.expected: List[int] = [0] * n
        self._poison_repaired: Dict[str, float] = {}

    # -- knobs (train block when present, envelope defaults otherwise) --
    @property
    def _train(self):
        return getattr(self.spec, "train", None)

    @property
    def policy(self) -> str:
        tr = self._train
        return tr.repair_policy if tr is not None else "auto"

    @property
    def min_confidence(self) -> float:
        tr = self._train
        return tr.min_repair_confidence if tr is not None else 0.6

    def budget_for(self, category: str) -> int:
        tr = self._train
        budgets = tr.restart_budgets if tr is not None else {}
        return budgets.get(category, self.spec.max_restarts)

    # -- bookkeeping -----------------------------------------------------
    def align(self, n: int) -> None:
        """Track elastic growth (shrink keeps stale slots harmlessly)."""
        while len(self.seen) < n:
            self.seen.append(0)
            self.expected.append(0)

    def expect_restart(self, idx: int) -> None:
        if 0 <= idx < len(self.expected):
            self.expected[idx] += 1

    def absorb_expected(self, idx: int) -> bool:
        if 0 <= idx < len(self.expected) and self.expected[idx] > 0:
            self.expected[idx] -= 1
            return True
        return False

    def absorb_poison_incident(self, report: FailureReport) -> bool:
        """True if this POISONED_NODE report belongs to an incident the
        Guardian already repaired — same node, within the window."""
        if report.category != "POISONED_NODE":
            return False
        t = self._poison_repaired.get(report.node)
        return t is not None and \
            self.platform.sim.now - t <= self.POISON_INCIDENT_S

    def note_poison_repaired(self, node: str) -> None:
        self._poison_repaired[node] = self.platform.sim.now

    def charge(self, category: str) -> int:
        """Charge one failure to the category's budget; returns the count."""
        if category not in FAILURE_CATEGORIES:
            raise ValueError(f"unknown failure category {category!r}")
        self.counts[category] = self.counts.get(category, 0) + 1
        return self.counts[category]
