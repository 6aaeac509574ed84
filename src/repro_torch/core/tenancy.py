"""Multi-tenancy: quotas, metering, network isolation (paper §II, §III-d).

DL frameworks run arbitrary customer code, so learner pods must be isolated
from DLaaS system processes and from each other.  ``NetworkPolicy.allowed``
is the single enforcement point — the cluster's RPC layer and the learner
processes consult it; tests assert cross-tenant and learner→control-plane
traffic is refused.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass
class Tenant:
    name: str
    gpu_quota: int = 64


class QuotaExceeded(Exception):
    pass


class Metering:
    """GPU-seconds per tenant (the API layer's 'metering')."""

    def __init__(self):
        self.usage: Dict[str, float] = {}
        self._running: Dict[str, Tuple[str, int, float]] = {}  # job: tenant,gpus,t0

    def job_started(self, job_id: str, tenant: str, gpus: int, now: float):
        self._running[job_id] = (tenant, gpus, now)

    def job_stopped(self, job_id: str, now: float):
        rec = self._running.pop(job_id, None)
        if rec:
            tenant, gpus, t0 = rec
            self.usage[tenant] = self.usage.get(tenant, 0.0) + gpus * (now - t0)

    def gpu_seconds(self, tenant: str, now: Optional[float] = None) -> float:
        """Metered usage.  With ``now``, in-flight jobs accrue up to the
        read time — a tenant with only running jobs no longer meters 0.0
        until the first ``job_stopped``."""
        total = self.usage.get(tenant, 0.0)
        if now is not None:
            for t, gpus, t0 in self._running.values():
                if t == tenant:
                    total += gpus * max(0.0, now - t0)
        return total


class TenancyManager:
    def __init__(self):
        self.tenants: Dict[str, Tenant] = {"default": Tenant("default", 10_000)}
        self.allocated: Dict[str, int] = {}
        self.metering = Metering()

    def add_tenant(self, name: str, gpu_quota: int) -> Tenant:
        t = Tenant(name, gpu_quota)
        self.tenants[name] = t
        return t

    def reserve(self, tenant: str, gpus: int) -> None:
        t = self.tenants.get(tenant)
        if t is None:
            raise KeyError(f"unknown tenant {tenant}")
        used = self.allocated.get(tenant, 0)
        if used + gpus > t.gpu_quota:
            raise QuotaExceeded(
                f"tenant {tenant}: {used}+{gpus} > quota {t.gpu_quota}")
        self.allocated[tenant] = used + gpus

    def release(self, tenant: str, gpus: int) -> None:
        self.allocated[tenant] = max(0, self.allocated.get(tenant, 0) - gpus)


class NetworkPolicy:
    """Workload pods (learners, servers, dryrun runners — they all execute
    customer code) may talk only to their own job's resources."""

    SYSTEM_SERVICES = ("dlaas-api", "dlaas-lcm", "mongo", "etcd")
    WORKLOAD_ROLES = ("learner", "server", "dryrun")

    @staticmethod
    def allowed(src_labels: Dict[str, str], dst: str) -> bool:
        role = src_labels.get("role", "")
        if role not in NetworkPolicy.WORKLOAD_ROLES:
            return True                        # system pods are trusted
        job = src_labels.get("job", "")
        # workloads: own volume, own status prefix, object store paths of
        # own job.  Prefix matches are segment-anchored: job-001 must NOT
        # be allowed to read cos/job-0010/... .
        if dst in NetworkPolicy.SYSTEM_SERVICES:
            return False
        if dst.startswith("volume/"):
            return dst == f"volume/{job}"
        if dst.startswith("status/"):
            return dst.startswith(f"status/{job}/")
        if dst.startswith("cos/"):
            return (dst == f"cos/{job}" or dst.startswith(f"cos/{job}/")
                    or dst == "cos/datasets"
                    or dst.startswith("cos/datasets/"))
        return False
