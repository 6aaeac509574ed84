"""MongoDB analog: the job-metadata system of record.

Semantics the platform depends on (paper §III-c):
* **Durable**: documents survive pod crashes (disk-backed).
* **Available or refusing**: while the mongo pod is down, reads/writes raise
  ``Unavailable`` — callers (API, LCM, Guardian) retry.  Jobs acked by the
  API are therefore never lost: the ack happens only *after* a successful
  write here.

A write-ahead journal makes crash-during-write atomic: a document is either
fully present or absent (torn writes are discarded on recovery).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional


class Unavailable(Exception):
    pass


class MetadataStore:
    def __init__(self):
        self._disk: Dict[str, Dict[str, dict]] = {}     # collection -> id -> doc
        self._journal: List[tuple] = []
        self.alive = True                               # pod up?

    # -- fault injection ---------------------------------------------------
    def crash(self) -> None:
        self.alive = False
        # torn journal entries are discarded; _disk only ever holds
        # fully-committed docs (commit is the dict assignment below)
        self._journal.clear()

    def restart(self) -> None:
        self.alive = True

    def _check(self) -> None:
        if not self.alive:
            raise Unavailable("metadata store down")

    # -- API -----------------------------------------------------------------
    def insert(self, coll: str, doc_id: str, doc: dict) -> None:
        self._check()
        self._journal.append(("insert", coll, doc_id))
        self._disk.setdefault(coll, {})[doc_id] = copy.deepcopy(doc)

    def update(self, coll: str, doc_id: str, fields: dict) -> None:
        self._check()
        d = self._disk.get(coll, {}).get(doc_id)
        if d is None:
            raise KeyError(f"{coll}/{doc_id}")
        self._journal.append(("update", coll, doc_id))
        d.update(copy.deepcopy(fields))

    def get(self, coll: str, doc_id: str) -> Optional[dict]:
        self._check()
        d = self._disk.get(coll, {}).get(doc_id)
        return copy.deepcopy(d) if d is not None else None

    def find(self, coll: str, pred: Callable[[dict], bool]) -> List[dict]:
        self._check()
        return [copy.deepcopy(d) for d in self._disk.get(coll, {}).values()
                if pred(d)]

    def delete(self, coll: str, doc_id: str) -> None:
        self._check()
        d = self._disk.get(coll, {})
        if doc_id not in d:
            raise KeyError(f"{coll}/{doc_id}")
        self._journal.append(("delete", coll, doc_id))
        del d[doc_id]

    def bump_counter(self, name: str) -> int:
        """Durable monotonic counter (findAndModify analog): returns the
        next value and persists the advance atomically.  Survives API-pod
        restarts, so id allocation never rewinds."""
        self._check()
        doc = self._disk.get("counters", {}).get(name)
        n = (doc or {}).get("next", 1)
        self._journal.append(("counter", name, n))
        self._disk.setdefault("counters", {})[name] = {"next": n + 1}
        return n

    def append_event(self, coll: str, doc_id: str, event: dict) -> None:
        self._check()
        d = self._disk.get(coll, {}).get(doc_id)
        if d is None:
            raise KeyError(f"{coll}/{doc_id}")
        d.setdefault("events", []).append(copy.deepcopy(event))
