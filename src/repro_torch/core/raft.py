"""Minimal Raft (leader election + replicated log + quorum commit).

The paper coordinates controller ↔ Guardian status through a 3-way
replicated ETCD.  This is a faithful small Raft: randomized election
timeouts, term-checked votes, log-matching AppendEntries, commit on
majority *of the leader's current term*, deterministic state-machine
apply.  No snapshots / membership changes (the paper's usage doesn't
need them).

Persistence model: ``current_term``, ``voted_for`` and ``log`` survive a
crash (they are on disk in real Raft); volatile state (commit/applied
indices, leadership) is rebuilt.  The KV state machine is rebuilt by
replaying the log on restart — honest crash semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.sim import Sim

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

ELECTION_TIMEOUT = (0.15, 0.30)
HEARTBEAT = 0.05
NET_DELAY = (0.001, 0.005)


@dataclass
class Entry:
    term: int
    cmd: Tuple             # ("put", key, value) | ("del", key)


class RaftNode:
    def __init__(self, sim: Sim, idx: int):
        self.sim = sim
        self.idx = idx
        self.peers: List["RaftNode"] = []
        self.alive = True
        # persistent
        self.current_term = 0
        self.voted_for: Optional[int] = None
        self.log: List[Entry] = []
        # volatile
        self.state = FOLLOWER
        self.commit_index = 0       # 1-based count of committed entries
        self.last_applied = 0
        self.kv: Dict[str, Any] = {}
        self.next_index: Dict[int, int] = {}
        self.match_index: Dict[int, int] = {}
        self._timer = None
        self._reset_election_timer()
        # telemetry for safety property tests
        self.leader_history: List[Tuple[int, int]] = []   # (term, idx)

    # -- wiring ----------------------------------------------------------
    def set_peers(self, nodes: List["RaftNode"]) -> None:
        self.peers = [n for n in nodes if n is not self]

    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def _send(self, to: "RaftNode", fn: str, **msg) -> None:
        if not self.alive:
            return
        delay = self.sim.rng.uniform(*NET_DELAY)

        def deliver():
            if to.alive:
                getattr(to, fn)(**msg)

        self.sim.schedule(delay, deliver)

    # -- crash / restart ---------------------------------------------------
    def crash(self) -> None:
        self.alive = False
        self.sim.log(f"raft-{self.idx} CRASH")

    def restart(self) -> None:
        self.alive = True
        self.state = FOLLOWER
        self.commit_index = 0
        self.last_applied = 0
        self.kv = {}
        self._reset_election_timer()
        self.sim.log(f"raft-{self.idx} RESTART")

    # -- timers --------------------------------------------------------------
    def _reset_election_timer(self) -> None:
        if self._timer is not None:
            self.sim.cancel(self._timer)
        t = self.sim.rng.uniform(*ELECTION_TIMEOUT)
        self._timer = self.sim.schedule(t, self._election_timeout)

    def _election_timeout(self) -> None:
        if not self.alive or self.state == LEADER:
            self._reset_election_timer()
            return
        self._start_election()

    def _start_election(self) -> None:
        self.state = CANDIDATE
        self.current_term += 1
        self.voted_for = self.idx
        self._votes = {self.idx}
        self.sim.log(f"raft-{self.idx} candidate term {self.current_term}")
        lt = self.log[-1].term if self.log else 0
        for p in self.peers:
            self._send(p, "on_request_vote", term=self.current_term,
                       candidate=self.idx, last_log_index=len(self.log),
                       last_log_term=lt)
        self._reset_election_timer()

    # -- RPC handlers ---------------------------------------------------------
    def _maybe_step_down(self, term: int) -> None:
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self.state = FOLLOWER

    def on_request_vote(self, term, candidate, last_log_index, last_log_term):
        self._maybe_step_down(term)
        grant = False
        if term == self.current_term and self.voted_for in (None, candidate):
            my_lt = self.log[-1].term if self.log else 0
            up_to_date = (last_log_term, last_log_index) >= (my_lt, len(self.log))
            if up_to_date:
                grant = True
                self.voted_for = candidate
                self._reset_election_timer()
        peer = next(p for p in self.peers if p.idx == candidate)
        self._send(peer, "on_vote_reply", term=self.current_term, granted=grant,
                   voter=self.idx)

    def on_vote_reply(self, term, granted, voter):
        self._maybe_step_down(term)
        if self.state != CANDIDATE or term != self.current_term or not granted:
            return
        self._votes.add(voter)
        if len(self._votes) >= self.quorum():
            self._become_leader()

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_history.append((self.current_term, self.idx))
        self.sim.log(f"raft-{self.idx} LEADER term {self.current_term}")
        for p in self.peers:
            self.next_index[p.idx] = len(self.log) + 1
            self.match_index[p.idx] = 0
        self._broadcast_append()
        self._heartbeat_loop()

    def _heartbeat_loop(self) -> None:
        if not self.alive or self.state != LEADER:
            return
        self._broadcast_append()
        self.sim.schedule(HEARTBEAT, self._heartbeat_loop)

    def _broadcast_append(self) -> None:
        for p in self.peers:
            ni = self.next_index.get(p.idx, len(self.log) + 1)
            prev_idx = ni - 1
            prev_term = self.log[prev_idx - 1].term if prev_idx >= 1 and prev_idx <= len(self.log) else 0
            entries = self.log[prev_idx:]
            self._send(p, "on_append", term=self.current_term, leader=self.idx,
                       prev_index=prev_idx, prev_term=prev_term,
                       entries=list(entries), leader_commit=self.commit_index)

    def on_append(self, term, leader, prev_index, prev_term, entries, leader_commit):
        self._maybe_step_down(term)
        ok = False
        if term == self.current_term:
            if self.state != FOLLOWER:
                self.state = FOLLOWER
            self._reset_election_timer()
            # log matching
            if prev_index == 0 or (prev_index <= len(self.log) and
                                   self.log[prev_index - 1].term == prev_term):
                ok = True
                # append/overwrite
                self.log = self.log[:prev_index] + list(entries)
                if leader_commit > self.commit_index:
                    self.commit_index = min(leader_commit, len(self.log))
                    self._apply()
        peer = next(p for p in self.peers if p.idx == leader)
        self._send(peer, "on_append_reply", term=self.current_term,
                   follower=self.idx, ok=ok,
                   match=prev_index + len(entries) if ok else 0)

    def on_append_reply(self, term, follower, ok, match):
        self._maybe_step_down(term)
        if self.state != LEADER or term != self.current_term:
            return
        if ok:
            self.match_index[follower] = max(self.match_index.get(follower, 0), match)
            self.next_index[follower] = self.match_index[follower] + 1
            self._advance_commit()
        else:
            self.next_index[follower] = max(1, self.next_index.get(follower, 1) - 1)

    def _advance_commit(self) -> None:
        for n in range(len(self.log), self.commit_index, -1):
            if self.log[n - 1].term != self.current_term:
                break                       # §5.4.2: only current-term entries
            votes = 1 + sum(1 for p in self.peers
                            if self.match_index.get(p.idx, 0) >= n)
            if votes >= self.quorum():
                self.commit_index = n
                self._apply()
                break

    # -- state machine ---------------------------------------------------------
    def _apply(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            cmd = self.log[self.last_applied - 1].cmd
            if cmd[0] == "put":
                self.kv[cmd[1]] = cmd[2]
            elif cmd[0] == "del":
                self.kv.pop(cmd[1], None)

    # -- client interface --------------------------------------------------------
    def propose(self, cmd: Tuple) -> Optional[int]:
        """Leader-only: append a command; returns its (1-based) log index."""
        if not self.alive or self.state != LEADER:
            return None
        self.log.append(Entry(self.current_term, cmd))
        self._broadcast_append()
        return len(self.log)

    def committed(self, index: int) -> bool:
        return self.commit_index >= index
