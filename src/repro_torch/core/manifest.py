"""Job manifest v1 — DEPRECATED in favor of ``repro_torch.core.jobspec.JobSpec``.

``framework`` names one of the registry architectures: the platform treats
architectures the way DLaaS treats frameworks (opaque learner payloads).

This flat, training-only manifest predates the multi-kind Job API v2.  It
is kept as a compatibility shim: the gateway accepts it and converts via
:meth:`JobManifest.to_jobspec` (equivalence is pinned by tests), and the
LCM still reconciles legacy job documents that carry ``manifest`` instead
of ``spec``.  New code should construct a ``JobSpec`` directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class JobManifest:
    name: str
    tenant: str = "default"
    framework: str = "paper-overhead-100m"    # architecture id
    learners: int = 1
    gpus_per_learner: int = 1
    # training params
    total_steps: int = 100
    step_time_s: float = 0.5                  # virtual step time (sim learners)
    checkpoint_interval_s: float = 30.0       # user-configured (paper §III-g)
    max_restarts: int = 3
    elastic: bool = False                     # allow DP shrink on learner loss
    priority: int = 0
    # data / results
    data_source: str = "cos://datasets/synthetic"
    dataset_gb: float = 1.0
    result_location: str = "cos://results"
    # learner payload knobs (real learners)
    real_compute: bool = False                # run actual JAX steps
    seed: int = 0
    extras: Dict[str, str] = field(default_factory=dict)

    def validate(self) -> Optional[str]:
        if self.learners < 1:
            return "learners must be >= 1"
        if self.gpus_per_learner < 0:
            return "gpus_per_learner must be >= 0"
        if self.checkpoint_interval_s <= 0:
            return "checkpoint_interval_s must be > 0"
        return None

    def to_jobspec(self):
        """Convert to the v2 resource model (kind ``train``)."""
        from repro_torch.core.jobspec import JobSpec, Resources, TrainSpec
        return JobSpec(
            name=self.name,
            kind="train",
            tenant=self.tenant,
            framework=self.framework,
            resources=Resources(replicas=self.learners,
                                gpus_per_replica=self.gpus_per_learner),
            max_restarts=self.max_restarts,
            elastic=self.elastic,
            priority=self.priority,
            seed=self.seed,
            extras=dict(self.extras),
            train=TrainSpec(
                total_steps=self.total_steps,
                step_time_s=self.step_time_s,
                checkpoint_interval_s=self.checkpoint_interval_s,
                data_source=self.data_source,
                dataset_gb=self.dataset_gb,
                result_location=self.result_location,
                real_compute=self.real_compute,
                recovery_mode=self.extras.get("recovery_mode", "checkpoint"),
            ))
