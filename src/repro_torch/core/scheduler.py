"""Placement: gang scheduling + tenant quotas + bin-packing.

Distributed DL learners are useless in fractions — a job's learner pods are
admitted all-or-nothing (gang).  Placement packs GPUs to minimize
fragmentation; spread across nodes is available for fault-domain diversity.
"""
from __future__ import annotations

from typing import Dict, FrozenSet

# Unschedulable is defined next to the retry loop that catches it and
# re-exported here for its historical import path.
from repro_torch.core.cluster import Cluster, Node, PodSpec, Unschedulable
from repro_torch.core.tenancy import TenancyManager


class Scheduler:
    def __init__(self, tenancy: TenancyManager, strategy: str = "binpack"):
        self.tenancy = tenancy
        self.strategy = strategy
        # per-job node exclusions (POISONED_NODE repair).  Guardian-owned:
        # acquired only through the `_repair_exclude_node` provider and
        # swept by `_rollback` — the SC302 node_exclusion pair checks that
        # an exclusion can never leak past the job that acquired it.
        self._excluded: Dict[str, FrozenSet[str]] = {}

    # -- node exclusion (self-healing repair: reschedule off a node) ----
    def exclude_node(self, job_id: str, node: str) -> None:
        self._excluded[job_id] = \
            self._excluded.get(job_id, frozenset()) | {node}

    def clear_exclusions(self, job_id: str) -> None:
        self._excluded.pop(job_id, None)

    def excluded_for(self, job_id: str) -> FrozenSet[str]:
        return self._excluded.get(job_id, frozenset())

    # per-pod placement hook used by Cluster._create_pod
    def place(self, cluster: Cluster, spec: PodSpec) -> Node:
        excluded = self._excluded.get(spec.labels.get("job"), frozenset())
        nodes = [n for n in cluster.nodes if n.alive and
                 n.name not in excluded and n.gpus_free() >= spec.gpus]
        if not nodes:
            raise Unschedulable(f"no node fits pod {spec.name} "
                                f"({spec.gpus} GPUs)")
        # system pods (0 GPUs) spread across nodes for fault-domain
        # diversity; GPU pods bin-pack to minimize fragmentation
        if spec.gpus == 0:
            return min(nodes, key=lambda n: sum(1 for p in n.pods
                                                if p.spec.gpus == 0))
        if self.strategy == "binpack":      # fullest node that still fits
            return min(nodes, key=lambda n: n.gpus_free())
        return max(nodes, key=lambda n: n.gpus_free())   # spread

    def max_feasible_gang(self, cluster: Cluster, gpus_each: int,
                          upper: int) -> int:
        """Largest world size ≤ upper that fits current live capacity."""
        free = sorted((n.gpus_free() for n in cluster.nodes if n.alive),
                      reverse=True)
        world = 0
        for _ in range(upper):
            for i, f in enumerate(free):
                if f >= gpus_each:
                    free[i] -= gpus_each
                    world += 1
                    break
            else:
                break
        return world

    # gang admission used by the Guardian before creating learner pods
    def admit_gang(self, cluster: Cluster, tenant: str, n_pods: int,
                   gpus_each: int) -> None:
        """All-or-nothing: quota + capacity for every learner, atomically."""
        self.tenancy.reserve(tenant, n_pods * gpus_each)     # raises on quota
        free = sorted((n.gpus_free() for n in cluster.nodes if n.alive),
                      reverse=True)
        need = [gpus_each] * n_pods
        for g in need:                      # first-fit-decreasing feasibility
            for i, f in enumerate(free):
                if f >= g:
                    free[i] -= g
                    break
            else:
                self.tenancy.release(tenant, n_pods * gpus_each)
                raise Unschedulable(
                    f"gang of {n_pods}×{gpus_each} GPUs does not fit")

    def release_gang(self, tenant: str, n_pods: int, gpus_each: int) -> None:
        self.tenancy.release(tenant, n_pods * gpus_each)
