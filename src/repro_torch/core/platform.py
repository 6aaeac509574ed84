"""DLaaSPlatform: the assembled system (paper Fig. 1).

Layers:
* platform layer — cluster (K8S analog), 3-replica Raft statestore (ETCD),
  metadata store (Mongo), object store (COS), volume manager (NFS);
* core services — API (2-replica Deployment), LCM (Deployment);
* per-job — Guardian (K8S Job), helper pod, learner StatefulSet.

Fault injection mirrors the paper's evaluation: ``kubectl_delete_pod`` for
Fig-4 component kills, ``crash_node`` for machine failures, plus statestore
replica crashes and metadata-store outages.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.core.api import ApiClient, SubmitHandle, make_api_proc
from repro_torch.core.cluster import Cluster, ContainerSpec, Deployment, PodSpec
from repro_torch.core.failures import FaultInjector, FaultPlan
from repro_torch.core.jobspec import FrameworkRegistry, JobSpec
from repro_torch.core.lcm import make_lcm_proc
from repro_torch.core.manifest import JobManifest
from repro_torch.core.metadata import MetadataStore, Unavailable
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.sim import Sim
from repro_torch.core.statestore import StateStore
from repro_torch.core.tenancy import NetworkPolicy, TenancyManager
from repro_torch.core.volumes import VolumeManager

# Fig-4 startup ranges for core-service pods
API_STARTUP = (3.0, 5.0)
LCM_STARTUP = (4.0, 6.0)


class DLaaSPlatform:
    def __init__(self, seed: int = 0, n_nodes: int = 16,
                 gpus_per_node: int = 8, api_replicas: int = 2,
                 lcm_replicas: int = 1):
        self.sim = Sim(seed=seed)
        self.cluster = Cluster(self.sim, n_nodes=n_nodes,
                               gpus_per_node=gpus_per_node)
        self.tenancy = TenancyManager()
        self.scheduler = Scheduler(self.tenancy)
        self.cluster.scheduler = self.scheduler
        self.statestore = StateStore(self.sim, n_replicas=3)
        self.metadata = MetadataStore()
        self.objectstore = ObjectStore()
        self.volumes = VolumeManager()
        self.netpolicy = NetworkPolicy()
        # framework-adapter registry: one adapter per architecture by
        # default; register() more to plug in new frameworks (Job API v2)
        self.frameworks = FrameworkRegistry.default()
        # chaos injection as a first-class API: scripted, typed, replayable
        # fault plans (see core/failures.py and the chaos benchmark lane)
        self.faults = FaultInjector(self)

        # mutable registries
        self.api_queue: List[SubmitHandle] = []
        self.guardians: Dict[str, Any] = {}
        self.statefulsets: Dict[str, Any] = {}
        self.deployments: Dict[str, Any] = {}
        self.netpolicies: Dict[str, Dict] = {}
        self.gang_sizes: Dict[str, int] = {}
        self.payloads: Dict[str, Any] = {}      # job_id -> RealPayload

        # core services
        self.api_deployment = Deployment(
            self.cluster, "dlaas-api",
            lambda i: PodSpec(name=f"api-{i}",
                              containers=[ContainerSpec(
                                  "api", make_api_proc(self))],
                              startup_range=API_STARTUP,
                              labels={"role": "api"}),
            replicas=api_replicas, service="dlaas-api")
        self.lcm_deployment = Deployment(
            self.cluster, "dlaas-lcm",
            lambda i: PodSpec(name=f"lcm-{i}",
                              containers=[ContainerSpec(
                                  "lcm", make_lcm_proc(self))],
                              startup_range=LCM_STARTUP,
                              labels={"role": "lcm"}),
            replicas=lcm_replicas, service="dlaas-lcm")
        self.client = ApiClient(self)

    # ------------------------------------------------------------------
    def run(self, seconds: float) -> None:
        self.sim.run_for(seconds)

    def run_until_terminal(self, job_id: str, timeout: float = 3600.0,
                           tick: float = 5.0) -> str:
        deadline = self.sim.now + timeout
        while self.sim.now < deadline:
            self.run(tick)
            try:
                doc = self.metadata.get("jobs", job_id)
            except Unavailable:
                continue            # store outage window: poll again
            if doc and doc["state"] in ("COMPLETED", "FAILED", "HALTED"):
                return doc["state"]
        return "TIMEOUT"

    # -- convenience passthroughs ------------------------------------------
    def submit(self, spec: "JobSpec | JobManifest",
               request_id: Optional[str] = None) -> SubmitHandle:
        return self.client.submit(spec, request_id=request_id)

    def register_payload(self, job_id: str, payload) -> None:
        self.payloads[job_id] = payload

    # -- fault injection -------------------------------------------------------
    def inject(self, plan: FaultPlan) -> None:
        """Arm a scripted chaos plan (typed faults at absolute sim times)."""
        self.faults.arm(plan)

    def kill_pod(self, name: str) -> bool:
        return self.cluster.kubectl_delete_pod(name)

    def crash_node_of(self, pod_name: str) -> Optional[str]:
        for pod in self.cluster.pods.values():
            if pod.spec.name == pod_name and pod.status == "RUNNING":
                node = pod.node.name
                self.cluster.crash_node(node)
                return node
        return None

    # -- observability ------------------------------------------------------------
    def recovery_time(self, pod_name: str, after_t: float) -> Optional[float]:
        """Virtual seconds from ``after_t`` until a pod with this name is
        RUNNING again (Fig-4 measurement).

        Scans live pods plus the cluster's bounded tombstone history, so
        an incarnation that recovered and then terminated again before the
        measurement is read still counts its first recovery.  A non-None
        ``started_at`` means the pod reached RUNNING — the same criterion
        for live and tombstoned pods, so there is no blind window between
        a pod going terminal and its GC tombstone being written."""
        candidates = [
            (pod.spec.name, pod.started_at)
            for pod in self.cluster.pods.values()
        ] + [
            (rec.name, rec.started_at)
            for rec in self.cluster.pod_history
        ]
        return min(
            (started_at - after_t for name, started_at in candidates
             if name == pod_name and started_at is not None
             and started_at >= after_t),
            default=None)
