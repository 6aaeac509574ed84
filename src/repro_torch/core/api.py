"""API gateway: submission, list, status, logs, halt, delete (paper §III-c).

Runs as a multi-replica Deployment behind the ``dlaas-api`` service name —
requests fail over to a live replica.  Job API v2 semantics:

* **Durable ack** — a job is acked **only after** its document is durably
  in Mongo, so acked jobs are never lost, even if every other component
  crashes immediately after.  The LCM discovers SUBMITTED jobs from Mongo
  (reconciliation), so the API→LCM handoff carries no state that can be
  lost.
* **Idempotent submission** — every submission carries a client-supplied
  ``request_id``; the job document records it.  Resubmitting after an ack
  was lost to an API-pod failover returns the SAME job, never a duplicate
  (the dedup index is the durable job collection itself, so it survives
  any number of API-pod deaths).
* **Metadata-backed id allocation** — job ids come from a durable counter
  in Mongo, so ids are unique per platform, survive API-pod restarts, and
  never bleed across ``DLaaSPlatform`` instances in one process.
* **Uniform verbs** — ``get/events/logs/halt/delete`` all raise
  :class:`JobNotFound` for unknown jobs (no more KeyError-vs-empty
  inconsistency), and ``list`` filters by tenant/state/kind with
  pagination.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core import states
from repro_torch.core.jobspec import JobSpec
from repro_torch.core.manifest import JobManifest
from repro_torch.core.metadata import Unavailable


class JobNotFound(KeyError):
    """No job with this id exists (uniform across every API verb)."""


class InvalidJobState(Exception):
    """The verb is not applicable in the job's current state."""


@dataclass
class SubmitHandle:
    spec: JobSpec
    request_id: str = ""
    job_id: Optional[str] = None
    acked: bool = False
    rejected: Optional[str] = None
    deduplicated: bool = False          # ack resolved by the request_id index


def _alloc_job_id(platform) -> str:
    """Allocate the next job id from the durable metadata counter.  The
    defensive existence probe keeps allocation collision-free even against
    job documents written by an older platform incarnation."""
    while True:
        n = platform.metadata.bump_counter("job-id")
        job_id = f"job-{n:04d}"
        if platform.metadata.get("jobs", job_id) is None:
            return job_id


def make_api_proc(platform):
    """API pod main loop: serves queued requests (submissions)."""

    def proc(pod):
        q = platform.api_queue
        while True:
            if not q:
                yield 0.05
                continue
            handle = q.pop(0)
            spec = handle.spec
            err = spec.validate(platform.frameworks)
            if err:
                handle.rejected = err
                continue
            if spec.tenant not in platform.tenancy.tenants:
                handle.rejected = f"unknown tenant {spec.tenant}"
                continue
            rid = handle.request_id
            while True:
                try:
                    # idempotency: the durable job collection IS the dedup
                    # index — a lost ack is recovered by resubmission.
                    # Scoped per tenant: request_ids are a client-chosen
                    # namespace, and tenant A reusing tenant B's id must
                    # never be handed B's job.
                    dup = platform.metadata.find(
                        "jobs", lambda d: rid
                        and d.get("request_id") == rid
                        and d.get("tenant") == spec.tenant)
                    if dup:
                        handle.job_id = dup[0]["id"]
                        handle.acked = True
                        handle.deduplicated = True
                        platform.sim.log(
                            f"api: dedup {rid} -> {handle.job_id}")
                        break
                    job_id = _alloc_job_id(platform)
                    doc = {"id": job_id, "request_id": rid,
                           "name": spec.name, "kind": spec.kind,
                           "tenant": spec.tenant, "spec": spec.to_doc(),
                           "state": states.JOB.initial,
                           "desired_state": "RUNNING",
                           "restarts": 0,
                           "events": [{"t": platform.sim.now,
                                       "event": states.JOB.initial}]}
                    # persist BEFORE ack (jobs are never lost once acked);
                    # the insert is the atomicity unit, so a crash between
                    # id allocation and insert only burns an id
                    platform.metadata.insert("jobs", job_id, doc)
                    handle.job_id = job_id
                    handle.acked = True
                    platform.sim.log(f"api: acked {job_id}")
                    break
                except Unavailable:
                    yield 0.5

    return proc


class ApiClient:
    """User-facing client: resolves a live API pod per call (load-balanced,
    fails over); raises RpcError when the API service is fully down."""

    def __init__(self, platform):
        self.platform = platform
        # auto request_ids draw from a per-PLATFORM counter: two client
        # instances must never generate the same id and silently dedup
        # each other's unrelated submissions
        self._auto_rid = platform.__dict__.setdefault(
            "_auto_rid_counter", itertools.count(1))

    def _endpoint(self):
        return self.platform.cluster.rpc("dlaas-api")    # RpcError if down

    def _doc(self, job_id: str) -> Dict[str, Any]:
        doc = self.platform.metadata.get("jobs", job_id)
        if doc is None:
            raise JobNotFound(job_id)
        return doc

    # -- submission --------------------------------------------------------
    def submit(self, spec: Union[JobSpec, JobManifest],
               request_id: Optional[str] = None) -> SubmitHandle:
        """Submit a job.  Pass the SAME ``request_id`` to resubmit after a
        lost ack — the platform returns the original job, never a
        duplicate.  v1 ``JobManifest`` is accepted via the shim."""
        if isinstance(spec, JobManifest):
            spec = spec.to_jobspec()
        self._endpoint()
        if request_id is None:
            request_id = f"req-auto-{next(self._auto_rid):06d}"
        h = SubmitHandle(spec=spec, request_id=request_id)
        self.platform.api_queue.append(h)
        return h

    # -- read verbs --------------------------------------------------------
    def get(self, job_id: str) -> Dict[str, Any]:
        self._endpoint()
        doc = self._doc(job_id)
        return {"id": doc["id"], "name": doc.get("name"),
                "kind": doc.get("kind", "train"),
                "tenant": doc.get("tenant"),
                "state": doc["state"],
                "restarts": doc.get("restarts", 0),
                "failures_by_category": doc.get("failures_by_category", {}),
                "learner_states": doc.get("learner_states")}

    # v1 alias
    def status(self, job_id: str) -> Dict[str, Any]:
        return self.get(job_id)

    def list(self, tenant: Optional[str] = None, state: Optional[str] = None,
             kind: Optional[str] = None, limit: int = 50,
             page_token: Optional[str] = None
             ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
        """Filtered listing, paginated by job id.  Returns
        ``(jobs, next_page_token)``; pass the token back to continue."""
        self._endpoint()
        if limit < 1:
            return [], None

        def pred(d):
            return ((tenant is None or d.get("tenant") == tenant)
                    and (state is None or d.get("state") == state)
                    and (kind is None or d.get("kind", "train") == kind))

        # length-first ordering keeps allocation order once ids outgrow
        # the zero padding ("job-10000" must sort after "job-9999")
        order = lambda jid: (len(jid), jid)
        docs = sorted(self.platform.metadata.find("jobs", pred),
                      key=lambda d: order(d["id"]))
        if page_token is not None:
            docs = [d for d in docs if order(d["id"]) > order(page_token)]
        page, rest = docs[:limit], docs[limit:]
        items = [{"id": d["id"], "name": d.get("name"),
                  "kind": d.get("kind", "train"),
                  "tenant": d.get("tenant"), "state": d["state"],
                  "restarts": d.get("restarts", 0)} for d in page]
        next_token = page[-1]["id"] if rest else None
        return items, next_token

    def events(self, job_id: str) -> List[dict]:
        self._endpoint()
        return list(self._doc(job_id).get("events", []))

    def logs(self, job_id: str, learner: int = 0) -> str:
        """Logs stream from the object store — readable even after crashes.
        Empty string means the job exists but shipped nothing yet."""
        self._endpoint()
        self._doc(job_id)
        key = f"cos/{job_id}/logs/{learner}"
        if not self.platform.objectstore.exists(key):
            return ""
        return self.platform.objectstore.get(key).decode()

    # -- write verbs -------------------------------------------------------
    def halt(self, job_id: str) -> None:
        self._endpoint()
        self._doc(job_id)
        self.platform.metadata.update("jobs", job_id,
                                      {"desired_state": "HALTED"})

    def delete(self, job_id: str) -> None:
        """Remove a TERMINAL job's document (its COS artifacts remain —
        results may outlive the job resource)."""
        self._endpoint()
        doc = self._doc(job_id)
        if doc["state"] not in ("COMPLETED", "FAILED", "HALTED"):
            raise InvalidJobState(
                f"cannot delete {job_id} in state {doc['state']}; halt first")
        self.platform.metadata.delete("jobs", job_id)

    # -- metering ----------------------------------------------------------
    def gpu_seconds(self, tenant: str) -> float:
        self._endpoint()
        return self.platform.tenancy.metering.gpu_seconds(
            tenant, now=self.platform.sim.now)
