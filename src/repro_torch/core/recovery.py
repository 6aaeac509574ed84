"""Failure detection & straggler mitigation primitives.

Heartbeat staleness handles *crash* failures; stragglers are the gray
failures — a learner that is alive but progressing far slower than its
peers stalls synchronous training for everyone.  The detector flags a
learner whose progress falls behind the group median by more than
``lag_factor`` × the median per-window progress, sustained over
``patience`` windows.
"""
from __future__ import annotations

from typing import List, Optional


class StragglerDetector:
    def __init__(self, n_learners: int, lag_factor: float = 0.5,
                 patience: int = 3, window_s: float = 10.0):
        self.n = n_learners
        self.lag_factor = lag_factor
        self.patience = patience
        self.window_s = window_s
        self._last_t: Optional[float] = None
        self._last_steps: Optional[List[Optional[int]]] = None
        self._strikes = [0] * n_learners

    def update(self, now: float, steps: List[Optional[int]]) -> List[int]:
        """Feed current per-learner steps; returns learners to restart."""
        if self.n < 3:
            return []                       # need a quorum of peers to judge
        if self._last_t is None or now - self._last_t < self.window_s:
            if self._last_t is None:
                self._last_t, self._last_steps = now, list(steps)
            return []
        deltas = []
        for i in range(self.n):
            if steps[i] is None or self._last_steps[i] is None:
                deltas.append(None)
            else:
                deltas.append(steps[i] - self._last_steps[i])
        self._last_t, self._last_steps = now, list(steps)
        known = sorted(d for d in deltas if d is not None)
        if len(known) < max(3, self.n // 2):
            return []
        median = known[len(known) // 2]
        if median <= 0:
            return []                       # whole group stalled — not a straggler
        out = []
        for i, d in enumerate(deltas):
            if d is not None and d < self.lag_factor * median:
                self._strikes[i] += 1
                if self._strikes[i] >= self.patience:
                    self._strikes[i] = 0
                    out.append(i)
            else:
                self._strikes[i] = 0
        return out
