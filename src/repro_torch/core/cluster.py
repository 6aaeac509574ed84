"""Kubernetes analog: nodes, pods, containers, and the three controller
abstractions the paper's design rests on.

* **Job**         — run-to-completion exactly-once semantics: a crashed pod is
                    recreated (fresh process state) until it succeeds or the
                    backoff limit is hit.  The Guardian runs under this.
* **StatefulSet** — N replicas with stable identities (``name-i``) that are
                    individually restarted in place.  Learners run under this.
* **Deployment**  — N interchangeable always-restart replicas behind a
                    service name (API, LCM, helper pods, core services).

Crash injection is first-class: ``kubectl_delete_pod`` / ``crash_node``
model the manual kills used for the paper's Fig. 4 and the node failures of
§II.  Restart latencies are sampled per component class from configured
ranges so recovery-time measurements are honest.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Generator, List, Optional, Tuple

from repro_torch.core.sim import Sim
from repro_torch.core.states import pod_transition

PENDING, RUNNING, SUCCEEDED, FAILED = "PENDING", "RUNNING", "SUCCEEDED", "FAILED"


class RpcError(Exception):
    """Target service has no live endpoint (connection refused)."""


class Unschedulable(Exception):
    """No node can host the pod right now — placement retries, k8s-style.
    Lives here (not in ``scheduler``) so ``_try_place`` can catch exactly
    this type instead of a broad ``except Exception`` that would also
    swallow scheduler bugs; ``scheduler`` re-exports it."""


@dataclass
class ContainerSpec:
    name: str
    # factory(pod) -> generator yielding sleep durations; return value = exit 0
    proc: Callable[["Pod"], Generator[float, None, Any]]


@dataclass
class PodSpec:
    name: str
    containers: List[ContainerSpec]
    gpus: int = 0
    startup_range: Tuple[float, float] = (1.0, 2.0)   # image pull/bind time
    labels: Dict[str, str] = field(default_factory=dict)
    tenant: str = "default"


class Pod:
    def __init__(self, spec: PodSpec, node: Optional["Node"], cluster: "Cluster"):
        self.spec = spec
        self.node = node
        self.cluster = cluster
        pod_transition(self, PENDING)
        self.incarnation = 0
        self.exit_codes: Dict[str, Any] = {}
        self.exit_detail = ""          # container crash message (evidence)
        self.restarts = 0
        self.started_at: Optional[float] = None

    @property
    def name(self) -> str:
        return self.spec.name

    def alive(self) -> bool:
        return self.status == RUNNING and self.node is not None \
            and self.node.alive

    # ------------------------------------------------------------------
    def _start(self) -> None:
        if self.status != PENDING:
            return   # failed/replaced while its start was queued — stay dead
        if self.node is None or not self.node.alive:
            self.fail()
            return
        sim = self.cluster.sim
        self.incarnation += 1
        inc = self.incarnation
        pod_transition(self, RUNNING)
        self.started_at = sim.now
        self.exit_codes = {}
        self.exit_detail = ""
        sim.log(f"pod/{self.name} RUNNING on {self.node.name} (inc {inc})")
        if self.node.poisoned:
            # poisoned node: every pod placed here dies shortly after
            # starting, with no diagnostic detail — the classifier must
            # infer the cause from node co-occurrence, not from the pod
            sim.schedule(self.cluster.POISON_KILL_DELAY,
                         lambda inc=inc: self.incarnation == inc and
                         self.fail())
        for c in self.spec.containers:
            gen = c.proc(self)
            guard = lambda inc=inc: (self.incarnation == inc and
                                     self.status == RUNNING and self.node.alive)
            sim.spawn(gen, guard=guard,
                      on_exit=lambda v, c=c, inc=inc: self._on_exit(c, inc, v),
                      on_error=lambda e, c=c, inc=inc: self._on_exit(c, inc, e, err=True))

    def _on_exit(self, c: ContainerSpec, inc: int, value: Any, err: bool = False):
        if self.incarnation != inc or self.status != RUNNING:
            return
        self.exit_codes[c.name] = value if not err else f"error:{value}"
        if err:
            self.exit_detail = str(value)
            self.cluster.sim.log(f"pod/{self.name} container {c.name} crashed: {value}")
            self.fail()
        elif len(self.exit_codes) == len(self.spec.containers):
            pod_transition(self, SUCCEEDED)
            self.cluster.sim.log(f"pod/{self.name} SUCCEEDED")
            self.cluster._pod_done(self)

    def fail(self) -> None:
        if self.status in (FAILED, SUCCEEDED):
            return
        pod_transition(self, FAILED)
        self.cluster.sim.log(f"pod/{self.name} FAILED")
        self.cluster._pod_done(self)


@dataclass
class Node:
    name: str
    gpus: int = 8
    alive: bool = True
    # a poisoned node stays alive and schedulable (the failure is hidden
    # from the control plane) but kills every pod placed on it — the
    # §III-f gray-failure mode behind the POISONED_NODE classification
    poisoned: bool = False
    pods: List[Pod] = field(default_factory=list)

    def gpus_free(self) -> int:
        return self.gpus - sum(p.spec.gpus for p in self.pods
                               if p.status in (PENDING, RUNNING))


# ---------------------------------------------------------------------------
class Controller:
    """Base for Job / StatefulSet / Deployment restart semantics."""

    def __init__(self, cluster: "Cluster", name: str):
        self.cluster = cluster
        self.name = name
        self.deleted = False

    def on_pod_done(self, pod: Pod) -> None:
        raise NotImplementedError

    def delete(self) -> None:
        self.deleted = True


class KJob(Controller):
    """K8S Job: reliably run ONE pod to completion; restart on failure up to
    ``backoff_limit`` times."""

    def __init__(self, cluster, name, spec: PodSpec, backoff_limit: int = 6,
                 on_exhausted: Optional[Callable[[], None]] = None,
                 on_success: Optional[Callable[[Any], None]] = None):
        super().__init__(cluster, name)
        self.spec = spec
        self.backoff_limit = backoff_limit
        self.failures = 0
        self.on_exhausted = on_exhausted
        self.on_success = on_success
        self.pod = cluster._create_pod(spec, self)

    def on_pod_done(self, pod: Pod) -> None:
        if self.deleted:
            return
        if pod.status == SUCCEEDED:
            if self.on_success:
                self.on_success(pod.exit_codes)
            return
        self.failures += 1
        if self.failures > self.backoff_limit:
            self.cluster.sim.log(f"job/{self.name} backoff limit exceeded")
            if self.on_exhausted:
                self.on_exhausted()
            return
        self.pod = self.cluster._create_pod(self.spec, self)


class StatefulSet(Controller):
    """Stable-identity replicas; each crashed replica is recreated in place."""

    def __init__(self, cluster, name, make_spec: Callable[[int], PodSpec],
                 replicas: int):
        super().__init__(cluster, name)
        self.make_spec = make_spec
        self.replicas = replicas
        self.restarts_total: List[int] = [0] * replicas
        self.pods: List[Pod] = [
            cluster._create_pod(make_spec(i), self) for i in range(replicas)]

    def on_pod_done(self, pod: Pod) -> None:
        if self.deleted or pod.status == SUCCEEDED:
            return
        idx = next((i for i, p in enumerate(self.pods) if p is pod), None)
        if idx is None or idx >= self.replicas:
            return                            # stale / resized away
        self.restarts_total[idx] += 1
        self.pods[idx] = self.cluster._create_pod(self.make_spec(idx), self)

    def resize(self, n: int) -> None:
        """Elastic shrink/grow.  Shrunk-away replicas are killed and not
        recreated; growth appends fresh stable identities."""
        old = self.replicas
        self.replicas = n
        if n < old:
            for p in self.pods[n:]:
                p.fail()
            self.pods = self.pods[:n]
            self.restarts_total = self.restarts_total[:n]
        else:
            for i in range(old, n):
                self.restarts_total.append(0)
                self.pods.append(
                    self.cluster._create_pod(self.make_spec(i), self))

    def all_succeeded(self) -> bool:
        return all(p.status == SUCCEEDED for p in self.pods)


class Deployment(Controller):
    """Restart-on-failure replicas behind a service name (load-balanced RPC).
    A pod whose containers all exit 0 is left SUCCEEDED (helper pods finish;
    service pods never return)."""

    def __init__(self, cluster, name, make_spec: Callable[[int], PodSpec],
                 replicas: int = 1, service: Optional[str] = None):
        super().__init__(cluster, name)
        self.make_spec = make_spec
        self.pods: List[Pod] = [
            cluster._create_pod(make_spec(i), self) for i in range(replicas)]
        if service:
            cluster.services.setdefault(service, []).append(self)

    def on_pod_done(self, pod: Pod) -> None:
        if self.deleted or pod.status == SUCCEEDED:
            return
        # Stale notifications happen (a watch event for a pod this
        # controller already replaced) — same guard as StatefulSet.
        idx = next((i for i, p in enumerate(self.pods) if p is pod), None)
        if idx is None:
            return
        self.pods[idx] = self.cluster._create_pod(self.make_spec(idx), self)

    def all_succeeded(self) -> bool:
        return all(p.status == SUCCEEDED for p in self.pods)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PodRecord:
    """Lightweight tombstone for a garbage-collected terminal pod, kept in
    a bounded ring so recovery-time measurements still see short-lived
    incarnations without the live dict growing forever."""

    uid: str
    name: str
    status: str
    started_at: Optional[float]
    finished_at: float
    node: Optional[str] = None        # where the last incarnation ran
    exit_detail: str = ""             # crash message (classifier evidence)


class Cluster:
    """The K8S control plane + scheduler (see core/scheduler.py for policy)."""

    #: terminal-pod tombstones retained for observability (Fig-4 scans)
    HISTORY_LIMIT = 512

    def __init__(self, sim: Sim, n_nodes: int = 16, gpus_per_node: int = 8):
        self.sim = sim
        self.nodes = [Node(f"node-{i}", gpus_per_node) for i in range(n_nodes)]
        self.pods: Dict[str, Pod] = {}
        self.pod_history: Deque[PodRecord] = deque(maxlen=self.HISTORY_LIMIT)
        self.services: Dict[str, List[Deployment]] = {}
        self._uid = itertools.count()
        self.scheduler = None      # injected by platform (core/scheduler.py)

    # -- pod lifecycle --------------------------------------------------
    def _create_pod(self, spec: PodSpec, owner: Controller) -> Pod:
        """Create a pod.  If it is unschedulable NOW (e.g. its node just
        died and no spare capacity exists) it stays PENDING and placement
        retries every few seconds — exactly k8s semantics; the Guardian's
        elastic policy watches for prolonged PENDING."""
        pod = Pod(spec, None, self)
        pod.owner = owner
        pod.uid = f"{spec.name}#{next(self._uid)}"
        self.pods[pod.uid] = pod
        self._try_place(pod)
        return pod

    def _try_place(self, pod: Pod) -> None:
        if pod.status not in (PENDING,):
            return
        try:
            node = self._place(pod.spec)
        except Unschedulable:
            self.sim.schedule(3.0, self._try_place, pod)   # stay PENDING
            return
        pod.node = node
        node.pods.append(pod)
        lo, hi = pod.spec.startup_range
        self.sim.schedule(self.sim.rng.uniform(lo, hi), pod._start)

    def _place(self, spec: PodSpec) -> Node:
        if self.scheduler is not None:
            return self.scheduler.place(self, spec)
        for n in self.nodes:
            if n.alive and n.gpus_free() >= spec.gpus:
                return n
        raise Unschedulable(f"unschedulable pod {spec.name}")

    def _pod_done(self, pod: Pod) -> None:
        if pod.node is not None and pod in pod.node.pods:
            pod.node.pods.remove(pod)
        owner = getattr(pod, "owner", None)
        if owner is not None:
            # controller notices via watch after a short delay
            self.sim.schedule(0.2, self._notify_owner_and_gc, owner, pod)
        else:
            self._gc_pod(pod)

    def _notify_owner_and_gc(self, owner: Controller, pod: Pod) -> None:
        try:
            owner.on_pod_done(pod)
        finally:
            self._gc_pod(pod)

    def _gc_pod(self, pod: Pod) -> None:
        """Drop a terminal pod from the live dict once its controller has
        reacted.  Controllers keep their own references (a Deployment's
        SUCCEEDED helper pods stay visible through ``dep.pods``); this only
        bounds the cluster-wide ``name#uid`` map, which otherwise grows by
        one entry per restart for the life of the simulation."""
        if pod.status not in (SUCCEEDED, FAILED):
            return
        uid = getattr(pod, "uid", None)
        if uid is not None and self.pods.get(uid) is pod:
            del self.pods[uid]
            self.pod_history.append(PodRecord(
                uid=uid, name=pod.spec.name, status=pod.status,
                started_at=pod.started_at, finished_at=self.sim.now,
                node=pod.node.name if pod.node is not None else None,
                exit_detail=pod.exit_detail))

    # -- fault injection (kubectl of the paper's Fig. 4) -----------------
    def kubectl_delete_pod(self, name: str) -> bool:
        for pod in list(self.pods.values()):
            if pod.spec.name == name and pod.status == RUNNING:
                pod.fail()
                return True
        return False

    def crash_node(self, node_name: str) -> None:
        node = next(n for n in self.nodes if n.name == node_name)
        node.alive = False
        self.sim.log(f"node/{node_name} DOWN")
        for pod in list(node.pods):
            pod.fail()

    def heal_node(self, node_name: str) -> None:
        node = next(n for n in self.nodes if n.name == node_name)
        node.alive = True
        node.poisoned = False
        self.sim.log(f"node/{node_name} UP")

    #: poisoned-node kill latency: the pod comes up, then dies
    POISON_KILL_DELAY = 0.5

    def poison_node(self, node_name: str) -> None:
        """Gray failure: the node stays alive and schedulable but every
        pod on it dies shortly after starting (no diagnostic detail)."""
        node = next(n for n in self.nodes if n.name == node_name)
        node.poisoned = True
        self.sim.log(f"node/{node_name} POISONED")
        for pod in list(node.pods):
            if pod.status == RUNNING:
                self.sim.schedule(
                    self.POISON_KILL_DELAY,
                    lambda p=pod, inc=pod.incarnation:
                    p.incarnation == inc and p.fail())

    def cure_node(self, node_name: str) -> None:
        node = next(n for n in self.nodes if n.name == node_name)
        node.poisoned = False
        self.sim.log(f"node/{node_name} CURED")

    # -- service RPC ------------------------------------------------------
    def rpc(self, service: str):
        """Resolve a live endpoint pod for ``service`` (round-robin over live
        replicas); raises RpcError when none — callers retry with backoff."""
        for dep in self.services.get(service, []):
            live = [p for p in dep.pods if p.alive()]
            if live:
                return live[self.sim.rng.randrange(len(live))]
        raise RpcError(f"service {service!r} unavailable")
