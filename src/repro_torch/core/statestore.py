"""ETCD analog: replicated KV on top of core/raft.py.

The controller records learner statuses here; the Guardian reads and
aggregates them (paper §III-f).  Writes are quorum-committed: they succeed
with one replica down and *stall* with two down — the availability property
tests assert both.

Client calls are generator helpers (``yield from store.put(...)``) so
platform processes block in virtual time while Raft replicates.
"""
from __future__ import annotations

from typing import Any, Dict, Generator, Optional

from repro_torch.core.raft import LEADER, RaftNode
from repro_torch.core.sim import Sim

PUT_TIMEOUT = 5.0
POLL = 0.01


class StateStore:
    def __init__(self, sim: Sim, n_replicas: int = 3):
        self.sim = sim
        self.replicas = [RaftNode(sim, i) for i in range(n_replicas)]
        for r in self.replicas:
            r.set_peers(self.replicas)

    # -- admin / fault injection -----------------------------------------
    def leader(self) -> Optional[RaftNode]:
        live = [r for r in self.replicas if r.alive and r.state == LEADER]
        if not live:
            return None
        # the real leader is the one with the highest term
        return max(live, key=lambda r: r.current_term)

    def crash_replica(self, idx: int) -> None:
        self.replicas[idx].crash()

    def restart_replica(self, idx: int) -> None:
        self.replicas[idx].restart()

    def available(self) -> bool:
        return sum(r.alive for r in self.replicas) >= \
            (len(self.replicas) // 2 + 1)

    # -- client API (generators: run inside platform processes) -----------
    def put(self, key: str, value: Any,
            timeout: float = PUT_TIMEOUT) -> Generator[float, None, bool]:
        """Quorum write; returns True on commit, False on timeout."""
        deadline = self.sim.now + timeout
        while self.sim.now < deadline:
            ldr = self.leader()
            if ldr is None:
                yield POLL
                continue
            idx = ldr.propose(("put", key, value))
            if idx is None:
                yield POLL
                continue
            term = ldr.current_term
            while self.sim.now < deadline and ldr.alive and \
                    ldr.current_term == term:
                if ldr.committed(idx):
                    return True
                yield POLL
            # leader changed / crashed before commit: retry via new leader
        return False

    def delete(self, key: str, timeout: float = PUT_TIMEOUT):
        deadline = self.sim.now + timeout
        while self.sim.now < deadline:
            ldr = self.leader()
            if ldr is not None:
                idx = ldr.propose(("del", key))
                if idx is not None:
                    term = ldr.current_term
                    while self.sim.now < deadline and ldr.alive and \
                            ldr.current_term == term:
                        if ldr.committed(idx):
                            return True
                        yield POLL
                    continue
            yield POLL
        return False

    def get(self, key: str, default: Any = None) -> Any:
        """Read from the leader's applied state (leader read)."""
        ldr = self.leader()
        if ldr is None:
            raise TimeoutError("statestore unavailable (no leader)")
        return ldr.kv.get(key, default)

    def get_prefix(self, prefix: str) -> Dict[str, Any]:
        ldr = self.leader()
        if ldr is None:
            raise TimeoutError("statestore unavailable (no leader)")
        return {k: v for k, v in ldr.kv.items() if k.startswith(prefix)}

    def try_get(self, key: str, default: Any = None) -> Any:
        try:
            return self.get(key, default)
        except TimeoutError:
            return default
