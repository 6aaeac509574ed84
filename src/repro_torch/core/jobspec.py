"""JobSpec v2 — the versioned, multi-kind job resource model (paper §III-a).

The paper's platform fronts every workload with ONE declarative manifest
submitted to a multi-tenant service; "multi-framework" means heterogeneous
workloads ride the same submission path (FfDL does this in production with
one manifest schema + framework plugins behind a single gateway).  This
module is that resource model for our platform:

* ``JobSpec`` — the versioned envelope (``api_version``, ``kind``, tenant,
  framework id, gang resources, restart policy) with exactly one per-kind
  spec block: ``TrainSpec`` | ``ServeSpec`` | ``DryRunSpec``.  The blocks
  carry the knobs that used to live in three disconnected argparse CLIs
  (arch/mesh/steps/batch/seq, cache layout, continuous batching, sweep
  cells), so every workload kind is schedulable and meterable.
* ``FrameworkAdapter`` / ``FrameworkRegistry`` — pluggable mapping from a
  ``framework`` id to payload builders (validate → resources → workload
  pod procs), replacing the implicit "framework is an architecture string"
  convention.  The default registry wraps the architecture registry
  (``repro_torch.configs``): every registered arch is a framework, the way
  DLaaS treats Caffe/TF/Torch as opaque learner payloads.

This is the port's copy of the reference's ``core/jobspec.py``.  What
differs: the registry is the port's (all of the reference's 11
architectures), a real serve payload is the port's
``launch/engine.py:RealServePayload``, and a dryrun job with
``real_compute`` raises ``NotImplementedError`` until the port has its own
``launch/dryrun.py`` (a virtual dryrun runs as in the reference).  The
fields are the reference's; the port's engine and train loop refuse those
they do not implement (``launch/spec.py``), and ``use_pallas`` chooses no
kernel: on the card every kernel runs, on the CPU its plain version.

``JobManifest`` (v1) remains as a deprecated shim that converts to a
``JobSpec`` via :meth:`repro_torch.core.manifest.JobManifest.to_jobspec`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

API_VERSION = "dlaas/v2"
KINDS = ("train", "serve", "dryrun")


# ---------------------------------------------------------------------------
# Per-kind spec blocks
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Resources:
    """Gang resources: how many workload pods, how many GPUs each."""

    replicas: int = 1
    gpus_per_replica: int = 1


@dataclass(frozen=True)
class TrainSpec:
    """Training knobs — the union of the old CLI flags and JobManifest."""

    total_steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    learning_rate: float = 1e-3
    num_microbatches: int = 1
    remat_policy: str = "none"                # none | dots | full
    mesh: str = "host"                        # host | prod | multipod
    use_pallas: bool = False
    reduced: bool = True
    log_every: int = 10
    # platform-sim knobs (virtual learners)
    step_time_s: float = 0.5
    checkpoint_interval_s: float = 30.0       # user-configured (paper §III-g)
    data_source: str = "cos://datasets/synthetic"
    dataset_gb: float = 1.0
    result_location: str = "cos://results"
    real_compute: bool = False                # run actual train steps
    recovery_mode: str = "checkpoint"         # checkpoint | rejoin (§III-h)
    # self-healing Guardian knobs (failure classification + safe repair).
    # restart_budgets charges restarts per failure category (keys from
    # states.FAILURE_CATEGORIES); categories without an entry fall back to
    # the envelope's max_restarts, so one pathology cannot exhaust
    # another's budget.
    restart_budgets: Dict[str, int] = field(default_factory=dict)
    repair_policy: str = "auto"               # auto | restart-only
    min_repair_confidence: float = 0.6        # below this: plain restart
    # formerly hard-coded Guardian monitor thresholds
    pending_stuck_s: float = 25.0             # elastic shrink trigger
    helper_drain_s: float = 60.0              # helper log/results drain


@dataclass(frozen=True)
class ServeSpec:
    """Serving knobs: batched prefill + decode, dense or paged KV cache."""

    batch: int = 4                            # concurrent decode slots
    prompt_len: int = 64
    gen: int = 32
    mesh: str = "host"
    reduced: bool = True
    cache_layout: Optional[str] = None        # None = the config's default
    page_size: int = 0                        # 0 = config default
    continuous: bool = False                  # continuous batching (paged)
    requests: int = 8                         # 0 = serve until halted
    page_budget: int = 0                      # 0 = worst case
    use_pallas: bool = False                  # paged flash-decode kernel
    ragged_prefill: Optional[bool] = None     # None = auto (attn-only archs)
    # optimistic admission: reserve worst-case pages up to overcommit ×
    # budget; on page exhaustion the engine evicts the youngest sequence
    # back to the queue (1.0 = conservative, never evicts)
    overcommit: float = 1.0
    # hash-addressed prefix caching + copy-on-write pages: full prompt
    # pages are content-hashed against a refcounted index; hits attach
    # read-only (no prefill compute, no new residency).  Auto-disabled on
    # configs without the chunked-prefill seam (non-all-global stacks)
    prefix_cache: bool = True
    # synthetic-workload knob: fraction of prompt_len every request shares
    # as a common leading prefix (0 = fully independent prompts)
    shared_prefix_frac: float = 0.0
    # platform-sim knob (virtual servers)
    request_time_s: float = 0.2
    # platform real-payload knobs: run the actual ServingEngine inside the
    # server pods (journal + snapshots on the job volume) instead of the
    # virtual-time loop
    real_compute: bool = False
    snapshot_every: int = 8                   # decode steps between snapshots


@dataclass(frozen=True)
class SweepCell:
    """One dry-run cell: lower + compile (arch × shape × mesh)."""

    arch: str
    shape: str
    multi_pod: bool = False

    @property
    def mesh_name(self) -> str:
        return "2x16x16" if self.multi_pod else "16x16"


@dataclass(frozen=True)
class DryRunSpec:
    """Compile-sweep knobs (the roofline evidence generator)."""

    cells: Tuple[SweepCell, ...] = ()
    sweep_all: bool = False                   # full (arch × shape × mesh) grid
    force: bool = False                       # recompute cached cells
    timeout_s: int = 3600                     # per-cell (local execution)
    # platform-sim knob: virtual lower+compile time per cell
    cell_time_s: float = 2.0
    # platform real-payload knob: lower + compile the cells for real
    real_compute: bool = False


def resolve_cells(dr: DryRunSpec) -> Tuple[SweepCell, ...]:
    """Expand ``sweep_all`` into the explicit cell grid (both meshes)."""
    if not dr.sweep_all:
        return tuple(dr.cells)
    from repro_torch.configs.base import SHAPES, list_configs
    return tuple(SweepCell(arch, shape, mp)
                 for arch in list_configs() if arch != "paper-overhead-100m"
                 for shape in SHAPES for mp in (False, True))


# ---------------------------------------------------------------------------
# The envelope
# ---------------------------------------------------------------------------
_KIND_ROLE = {"train": "learner", "serve": "server", "dryrun": "dryrun"}


@dataclass(frozen=True)
class JobSpec:
    name: str
    kind: str = "train"
    api_version: str = API_VERSION
    tenant: str = "default"
    framework: str = "paper-overhead-100m"    # id in the FrameworkRegistry
    resources: Resources = field(default_factory=Resources)
    max_restarts: int = 3
    elastic: bool = False                     # allow DP shrink (train only)
    priority: int = 0
    seed: int = 0
    extras: Dict[str, str] = field(default_factory=dict)
    train: Optional[TrainSpec] = None
    serve: Optional[ServeSpec] = None
    dryrun: Optional[DryRunSpec] = None

    def __post_init__(self):
        # exactly one kind block is active; default-construct it if absent
        # so `JobSpec(name="j", kind="serve")` is valid shorthand
        if self.kind in KINDS and self.workload is None:
            block = {"train": TrainSpec, "serve": ServeSpec,
                     "dryrun": DryRunSpec}[self.kind]()
            object.__setattr__(self, self.kind, block)

    # -- kind block access -------------------------------------------------
    @property
    def workload(self):
        """The active per-kind spec block."""
        return getattr(self, self.kind, None) if self.kind in KINDS else None

    @property
    def role(self) -> str:
        """Pod role label for this kind's workload pods."""
        return _KIND_ROLE.get(self.kind, "worker")

    # -- v1 compatibility accessors (guardian/learner/helper paths) --------
    @property
    def learners(self) -> int:
        return self.resources.replicas

    @property
    def gpus_per_learner(self) -> int:
        return self.resources.gpus_per_replica

    @property
    def total_steps(self) -> int:
        return self.train.total_steps if self.train else 0

    @property
    def step_time_s(self) -> float:
        return self.train.step_time_s if self.train else 0.5

    @property
    def checkpoint_interval_s(self) -> float:
        return self.train.checkpoint_interval_s if self.train else 30.0

    @property
    def dataset_gb(self) -> float:
        return self.train.dataset_gb if self.train else 0.0

    @property
    def real_compute(self) -> bool:
        return bool(self.train and self.train.real_compute)

    @property
    def recovery_mode(self) -> str:
        if self.train is not None:
            return self.train.recovery_mode
        return self.extras.get("recovery_mode", "checkpoint")

    # -- validation ---------------------------------------------------------
    def validate(self, frameworks: Optional["FrameworkRegistry"] = None
                 ) -> Optional[str]:
        """Full submission-time validation; returns an error string or None.

        With a registry, unknown ``framework`` ids are rejected HERE — at
        the gateway — instead of being acked and failing deep inside the
        Guardian."""
        if self.api_version != API_VERSION:
            return (f"unsupported api_version {self.api_version!r} "
                    f"(expected {API_VERSION!r})")
        if self.kind not in KINDS:
            return f"unknown kind {self.kind!r} (expected one of {KINDS})"
        if not self.name:
            return "name must be non-empty"
        if self.resources.replicas < 1:
            return "resources.replicas must be >= 1"
        if self.resources.gpus_per_replica < 0:
            return "resources.gpus_per_replica must be >= 0"
        if self.max_restarts < 0:
            return "max_restarts must be >= 0"
        if frameworks is not None and self.framework not in frameworks:
            return (f"unknown framework {self.framework!r}; "
                    f"known: {frameworks.known()}")
        for k in KINDS:
            if k != self.kind and getattr(self, k) is not None:
                return (f"kind={self.kind!r} but a {k!r} spec block is set "
                        f"(exactly one per-kind block; it must match kind)")
        err = self._validate_workload()
        if err:
            return err
        if frameworks is not None:
            return frameworks.get(self.framework).validate(self)
        return None

    def _validate_workload(self) -> Optional[str]:
        w = self.workload
        if w is None:
            return f"missing {self.kind!r} spec block"
        if self.kind == "train":
            if w.total_steps < 1:
                return "train.total_steps must be >= 1"
            if w.step_time_s <= 0:
                return "train.step_time_s must be > 0"
            if w.checkpoint_interval_s <= 0:
                return "train.checkpoint_interval_s must be > 0"
            if w.repair_policy not in ("auto", "restart-only"):
                return (f"train.repair_policy {w.repair_policy!r} must be "
                        f"'auto' or 'restart-only'")
            if not 0.0 <= w.min_repair_confidence <= 1.0:
                return "train.min_repair_confidence must be in [0, 1]"
            if w.pending_stuck_s <= 0:
                return "train.pending_stuck_s must be > 0"
            if w.helper_drain_s <= 0:
                return "train.helper_drain_s must be > 0"
            from repro_torch.core.states import FAILURE_CATEGORIES
            for cat, budget in w.restart_budgets.items():
                if cat not in FAILURE_CATEGORIES:
                    return (f"train.restart_budgets: unknown category "
                            f"{cat!r}; known: {list(FAILURE_CATEGORIES)}")
                if budget < 0:
                    return (f"train.restart_budgets[{cat!r}] must be >= 0")
        elif self.kind == "serve":
            if w.batch < 1:
                return "serve.batch must be >= 1"
            if w.prompt_len < 1 or w.gen < 1:
                return "serve.prompt_len and serve.gen must be >= 1"
            if w.requests < 0:
                return "serve.requests must be >= 0 (0 = run until halted)"
            if w.request_time_s <= 0:
                return "serve.request_time_s must be > 0"
            if w.overcommit < 1.0:
                return "serve.overcommit must be >= 1.0"
            if not 0.0 <= w.shared_prefix_frac <= 1.0:
                return "serve.shared_prefix_frac must be in [0, 1]"
            if w.snapshot_every < 1:
                return "serve.snapshot_every must be >= 1"
            if w.real_compute and w.requests < 1:
                return "serve.real_compute needs a bounded request count"
        elif self.kind == "dryrun":
            if not w.sweep_all and not w.cells:
                return "dryrun needs cells or sweep_all=True"
            from repro_torch.configs.base import SHAPES, list_configs
            known = set(list_configs())
            for c in w.cells:
                if c.arch not in known:
                    return f"dryrun cell: unknown arch {c.arch!r}"
                if c.shape not in SHAPES:
                    return (f"dryrun cell: unknown shape {c.shape!r}; "
                            f"known: {sorted(SHAPES)}")
        return None

    # -- serialization (the metadata store holds plain dicts) ---------------
    def to_doc(self) -> dict:
        return {
            "api_version": self.api_version, "kind": self.kind,
            "name": self.name, "tenant": self.tenant,
            "framework": self.framework,
            "resources": dataclasses.asdict(self.resources),
            "max_restarts": self.max_restarts, "elastic": self.elastic,
            "priority": self.priority, "seed": self.seed,
            "extras": dict(self.extras),
            "train": dataclasses.asdict(self.train) if self.train else None,
            "serve": dataclasses.asdict(self.serve) if self.serve else None,
            "dryrun": dataclasses.asdict(self.dryrun) if self.dryrun else None,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "JobSpec":
        d = dict(doc)
        d["resources"] = Resources(**d.get("resources") or {})
        for key, block in (("train", TrainSpec), ("serve", ServeSpec)):
            d[key] = block(**d[key]) if d.get(key) else None
        dr = d.get("dryrun")
        if dr:
            dr = dict(dr)
            dr["cells"] = tuple(SweepCell(**c) for c in dr.get("cells") or ())
            d["dryrun"] = DryRunSpec(**dr)
        else:
            d["dryrun"] = None
        return cls(**d)


def spec_from_job_doc(doc: dict) -> JobSpec:
    """Extract the JobSpec from a job document — v2 docs carry ``spec``;
    legacy v1 docs carry ``manifest`` and go through the shim, so jobs
    persisted before the redesign still reconcile after an upgrade."""
    if doc.get("spec") is not None:
        return JobSpec.from_doc(doc["spec"])
    from repro_torch.core.manifest import JobManifest
    return JobManifest(**doc["manifest"]).to_jobspec()


# ---------------------------------------------------------------------------
# Framework adapters
# ---------------------------------------------------------------------------
class FrameworkAdapter:
    """Maps a ``framework`` id to its payload builders.

    The platform calls, in order: :meth:`validate` (at the API gateway),
    :meth:`gang` (at Guardian admission) and :meth:`workload_proc` (one
    call per workload pod); the workload pods call :meth:`payload` to
    obtain the *real* compute payload — or ``None`` for the virtual-time
    default.  LCM/Guardian never look inside any of these: dispatch is
    payload-agnostic, so plugging in a new framework (or a real payload
    for an existing kind) touches neither the gateway nor the Guardian."""

    def __init__(self, framework: str):
        self.framework = framework

    def validate(self, spec: JobSpec) -> Optional[str]:
        return None

    def gang(self, spec: JobSpec) -> Resources:
        return spec.resources

    def workload_proc(self, platform, job_id: str, spec: JobSpec, idx: int):
        raise NotImplementedError

    def payload(self, platform, job_id: str, spec: JobSpec):
        """Payload-builder hook: the real compute object a workload pod
        should drive, or ``None`` to run the virtual-time loop (the
        default — fast tests never build a model).  ``real_compute`` on the
        workload block is the virtual-vs-real switch (the pre-v2 learner
        contract); when it is set, the base implementation returns the
        payload registered via ``platform.register_payload`` — the
        external-trainer seam and the test-injection point — so EVERY
        adapter inherits registration without overriding."""
        if not getattr(spec.workload, "real_compute", False):
            return None
        return platform.payloads.get(job_id)


class ArchitectureAdapter(FrameworkAdapter):
    """Default adapter: the framework id is a registry architecture, the
    workload pods are the stock learner/server/dryrun container procs."""

    def validate(self, spec: JobSpec) -> Optional[str]:
        if spec.kind == "serve" and spec.serve.continuous:
            if spec.serve.cache_layout == "dense":
                return "serve.continuous requires the paged cache layout"
        if spec.kind == "serve" and spec.serve.real_compute:
            sv = spec.serve
            if sv.cache_layout == "dense":
                return "serve.real_compute runs the paged serving engine"
            from repro_torch.configs import get_config
            from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN
            cfg = get_config(spec.framework)
            if cfg.use_mla or cfg.is_encoder_decoder:
                return ("serve.real_compute needs per-sequence decode "
                        "positions; MLA / enc-dec caches are lockstep-only")
            # reject engine-constructor failures HERE, at the gateway —
            # inside a pod they would burn the job's whole restart budget
            if sv.reduced:
                cfg = cfg.reduced()
            ps = sv.page_size or cfg.page_size
            pps = -(-(sv.prompt_len + sv.gen) // ps)
            if sv.page_budget and sv.page_budget < pps:
                return (f"serve.page_budget {sv.page_budget} cannot hold "
                        f"one request ({pps} pages)")
            attn_only = set(cfg.layer_kinds()) <= {GLOBAL_ATTN, LOCAL_ATTN}
            if sv.ragged_prefill and not attn_only:
                return ("serve.ragged_prefill needs an attention-only "
                        "decoder; recurrent/RWKV state would scan the "
                        "padding")
        return None

    def workload_proc(self, platform, job_id: str, spec: JobSpec, idx: int):
        if spec.kind == "train":
            from repro_torch.core.learner import make_learner_proc
            return make_learner_proc(platform, job_id, spec, idx)
        from repro_torch.core.server import make_dryrun_proc, make_server_proc
        if spec.kind == "serve":
            return make_server_proc(platform, job_id, spec, idx)
        return make_dryrun_proc(platform, job_id, spec, idx)

    def payload(self, platform, job_id: str, spec: JobSpec):
        """Real payloads, by kind: an explicitly registered payload wins
        (base behavior); a serve kind otherwise builds the port's stock
        real payload when the spec asks for real compute, and a dryrun
        kind raises (no real compile cells in the port yet).  Train has
        no default builder — real training state (step fn, data) must be
        registered."""
        registered = super().payload(platform, job_id, spec)
        if registered is not None:
            return registered
        if not getattr(spec.workload, "real_compute", False):
            return None
        if spec.kind == "serve":
            from repro_torch.launch.engine import RealServePayload
            return RealServePayload(spec)
        if spec.kind == "dryrun":
            raise NotImplementedError(
                "dryrun.real_compute: the port's real compile cells come "
                "with its launch/dryrun.py (ROADMAP Queue 1 item 6); "
                "register a payload or run the virtual sweep")
        return None


class FrameworkRegistry:
    def __init__(self):
        self._adapters: Dict[str, FrameworkAdapter] = {}

    def register(self, adapter: FrameworkAdapter) -> FrameworkAdapter:
        self._adapters[adapter.framework] = adapter
        return adapter

    def get(self, framework: str) -> FrameworkAdapter:
        if framework not in self._adapters:
            raise KeyError(f"unknown framework {framework!r}; "
                           f"known: {self.known()}")
        return self._adapters[framework]

    def __contains__(self, framework: str) -> bool:
        return framework in self._adapters

    def known(self) -> Tuple[str, ...]:
        return tuple(sorted(self._adapters))

    @classmethod
    def default(cls) -> "FrameworkRegistry":
        """One adapter per registered architecture (configs are pure
        dataclasses — importing them pulls in no accelerator deps)."""
        from repro_torch.configs import list_configs
        reg = cls()
        for arch in list_configs():
            reg.register(ArchitectureAdapter(arch))
        return reg
