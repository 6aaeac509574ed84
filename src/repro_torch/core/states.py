"""Declared lifecycle state machines for jobs and pods.

This module is the single source of truth for platform lifecycle
vocabulary and legal transitions.  Runtime components (LCM, Guardian,
cluster, helper) route every state write through the helpers below, and
``repro.staticcheck``'s SC301 checker independently model-checks the
declared graphs (reachability, terminal absorption, settlement) and
verifies that no component writes state by hand — the same
declared-artifact seam as ``kernels/layout.py``.

Graph notes:

* ``(None, X)`` edges mark entry points (the API inserts jobs at the
  job machine's initial state; pods are born PENDING).
* ``PROCESSING -> DEPLOYING`` is the restart back-edge: a Guardian
  incarnation that finds a half-deployed or crashed predecessor rolls
  the job back to DEPLOYING before redeploying.
* Same-state re-assertion (``X -> X``) is deliberately NOT a table
  edge; terminal states stay absorbing in the declared graph.  The
  ``job_transition`` helper still tolerates it at runtime, because a
  retry after a partially-committed write (update landed, event append
  hit ``Unavailable``) legitimately re-asserts the state it already
  wrote.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


class InvalidTransition(ValueError):
    """An undeclared lifecycle transition was attempted.

    Subclasses ValueError so in-pod failures keep the platform's error
    contract (pods fail their own job; they never exit the simulator).
    """


@dataclass(frozen=True)
class StateMachine:
    name: str
    initial: str
    # (from_state, to_state); from_state None marks an entry point.
    transitions: Tuple[Tuple[Optional[str], str], ...]
    terminal: Tuple[str, ...]
    states: frozenset = field(init=False)

    def __post_init__(self) -> None:
        states = {t for _, t in self.transitions}
        states |= {f for f, _ in self.transitions if f is not None}
        object.__setattr__(self, "states", frozenset(states))

    def allowed(self, cur: Optional[str], new: str) -> bool:
        if cur == new and new in self.states:
            return True  # idempotent re-assertion (retry/race tolerance)
        return (cur, new) in self.transitions

    def check(self, cur: Optional[str], new: str) -> None:
        if not self.allowed(cur, new):
            edges = sorted(self.transitions, key=lambda e: (e[0] or "", e[1]))
            raise InvalidTransition(
                f"{self.name}: illegal transition {cur!r} -> {new!r} "
                f"(declared edges: {edges})"
            )


JOB = StateMachine(
    name="job",
    initial="SUBMITTED",
    transitions=(
        (None, "SUBMITTED"),          # API gateway inserts the job doc
        ("SUBMITTED", "DEPLOYING"),   # LCM creates the guardian
        ("SUBMITTED", "FAILED"),      # guardian exhausted before first write
        ("DEPLOYING", "PROCESSING"),  # deploy finished, monitors take over
        ("DEPLOYING", "FAILED"),      # restart budget exhausted mid-deploy
        ("PROCESSING", "DEPLOYING"),  # restart back-edge (guardian redeploy)
        ("PROCESSING", "COMPLETED"),
        ("PROCESSING", "FAILED"),
        ("PROCESSING", "HALTED"),
    ),
    terminal=("COMPLETED", "FAILED", "HALTED"),
)

POD = StateMachine(
    name="pod",
    initial="PENDING",
    transitions=(
        (None, "PENDING"),
        ("PENDING", "RUNNING"),
        ("PENDING", "FAILED"),        # node died / pod deleted before start
        ("RUNNING", "SUCCEEDED"),
        ("RUNNING", "FAILED"),
    ),
    terminal=("SUCCEEDED", "FAILED"),
)

# Failure-classification vocabulary (self-healing Guardian).  The
# FailureClassifier (core/failures.py) may only emit these categories;
# ``journal_failure`` validates reports the same way ``job_transition``
# validates states, so a typo'd category can never reach the journal.
FAILURE_CATEGORIES = (
    "OOM",              # learner memory/page budget exceeded (exit 137)
    "CKPT_CORRUPT",     # newest checkpoint generation fails integrity
    "FLAKY_POD",        # one-shot pod crash, no deeper signature
    "POISONED_NODE",    # co-occurring pod deaths on one live node
    "STRAGGLER",        # alive but lagging the gang (gray failure)
    "UNKNOWN",          # unrecognized evidence — never auto-repaired
)


def journal_failure(
    metadata: Any,
    now: float,
    job_id: str,
    report: Dict[str, Any],
) -> None:
    """Journal a validated FailureReport doc as a job event.

    The event carries no ``state`` key — classification never moves the
    lifecycle machine by itself; repairs and budget exhaustion go through
    ``job_transition`` like every other write.
    """
    category = report.get("category")
    if category not in FAILURE_CATEGORIES:
        raise InvalidTransition(
            f"failure: unknown category {category!r} "
            f"(vocabulary: {list(FAILURE_CATEGORIES)})"
        )
    confidence = float(report.get("confidence", 0.0))
    if not 0.0 <= confidence <= 1.0:
        raise InvalidTransition(
            f"failure: confidence {confidence!r} outside [0, 1]"
        )
    metadata.append_event(
        "jobs", job_id,
        {"t": now,
         "event": f"FAILURE {category} "
                  f"(confidence {confidence:.2f}, pod {report.get('pod')})",
         "failure": dict(report)},
    )


# Learner status vocabulary as reported by the helper controller.
# UNKNOWN is synthetic: the aggregator's placeholder for a learner with
# no status doc yet.
LEARNER_STATES = frozenset(
    {"STARTING", "RUNNING", "UNREACHABLE", "SUCCEEDED", "FAILED"}
)
UNKNOWN = "UNKNOWN"

# Aggregation priority, worst first: any FAILED learner fails the gang
# before an UNREACHABLE one marks it degraded, and only an all-SUCCEEDED
# gang reads SUCCEEDED.
LEARNER_PRIORITY = (
    "FAILED", "UNREACHABLE", "STARTING", UNKNOWN, "RUNNING", "SUCCEEDED",
)


def job_transition(
    metadata: Any,
    now: float,
    job_id: str,
    state: str,
    fields: Optional[Dict[str, Any]] = None,
    event: Optional[str] = None,
) -> None:
    """Validated job state write: get -> check -> update -> journal.

    Raises InvalidTransition on an undeclared edge, and propagates the
    metadata store's own errors (Unavailable, KeyError) so callers keep
    their retry semantics.  Not atomic: a crash between update and
    append_event loses the event but never the state, and the
    idempotent-same-state rule makes the retry safe.
    """
    doc = metadata.get("jobs", job_id)
    cur = (doc or {}).get("state")
    JOB.check(cur, state)
    payload = dict(fields) if fields else {}
    payload["state"] = state
    metadata.update("jobs", job_id, payload)
    metadata.append_event(
        "jobs", job_id,
        {"t": now, "event": event or state, "from": cur, "to": state},
    )


def learner_status(state: str, **fields: Any) -> Dict[str, Any]:
    """Build a learner status doc, validating the state vocabulary."""
    if state not in LEARNER_STATES:
        raise InvalidTransition(
            f"learner: unknown status {state!r} "
            f"(vocabulary: {sorted(LEARNER_STATES)})"
        )
    doc: Dict[str, Any] = {"state": state}
    doc.update(fields)
    return doc


def pod_transition(pod: Any, status: str) -> None:
    """Validated pod status write — the only place pod.status is set."""
    POD.check(getattr(pod, "status", None), status)
    pod.status = status


def render_mermaid(machine: StateMachine) -> str:
    """Render a machine as a mermaid stateDiagram-v2 (for the README)."""
    lines = ["stateDiagram-v2"]
    for cur, new in machine.transitions:
        if cur is None:
            lines.append(f"    [*] --> {new}")
        else:
            lines.append(f"    {cur} --> {new}")
    for t in machine.terminal:
        lines.append(f"    {t} --> [*]")
    return "\n".join(lines)
