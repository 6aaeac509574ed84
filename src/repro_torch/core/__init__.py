"""The paper's primary contribution: the DLaaS dependability/orchestration
layer (API → LCM → Guardian → helpers/learners on K8S/ETCD/Mongo analogs).

Job API v2 (``repro_torch.core.jobspec``) is the public resource model: one
versioned ``JobSpec`` envelope with per-kind blocks for train/serve/dryrun
workloads, behind a framework-adapter registry.  ``JobManifest`` is the
deprecated v1 shim."""
from repro_torch.core.jobspec import (                       # noqa: F401
    DryRunSpec,
    FrameworkAdapter,
    FrameworkRegistry,
    JobSpec,
    Resources,
    ServeSpec,
    SweepCell,
    TrainSpec,
)
from repro_torch.core.api import InvalidJobState, JobNotFound  # noqa: F401
from repro_torch.core.failures import (                      # noqa: F401
    SAFE_REPAIRS,
    FailureClassifier,
    FailureReport,
    Fault,
    FaultInjector,
    FaultPlan,
)
from repro_torch.core.manifest import JobManifest            # noqa: F401
from repro_torch.core.platform import DLaaSPlatform          # noqa: F401
from repro_torch.core.checkpoint import CheckpointManager    # noqa: F401
from repro_torch.core.objectstore import ObjectStore         # noqa: F401
from repro_torch.core.sim import Sim                         # noqa: F401
