"""Deterministic discrete-event simulation kernel (virtual time).

The paper's platform runs on a real Kubernetes cluster; this container is a
single CPU host, so the *control plane* runs in virtual time while learner
compute can be real JAX work (see core/learner.py).  Every dependability
mechanism — atomic deployment, quorum writes, restart policies, rollback —
is implemented for real on top of this kernel; only the clock is simulated.

Processes are generator functions yielding sleep durations (seconds of
virtual time).  A crashed process is simply an abandoned generator; a
*restart* creates a fresh generator from the same factory — exactly the
semantics of a restarted OS process, which is what makes mid-operation
crash testing honest (no hidden state survives).
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Generator, Iterator, Optional

ProcFn = Callable[..., Generator[float, None, Any]]


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class Sim:
    def __init__(self, seed: int = 0):
        self.now = 0.0
        self.rng = random.Random(seed)
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self.trace: list[tuple[float, str]] = []

    # ------------------------------------------------------------------
    def log(self, msg: str) -> None:
        self.trace.append((self.now, msg))

    def schedule(self, delay: float, fn: Callable, *args, **kw) -> _Event:
        ev = _Event(self.now + max(delay, 0.0), next(self._seq),
                    lambda: fn(*args, **kw))
        heapq.heappush(self._heap, ev)
        return ev

    def at(self, t: float, fn: Callable, *args, **kw) -> _Event:
        """Schedule at an *absolute* virtual time (the FaultPlan seam):
        scripted fault injection declares event times, not delays, so a
        plan replays identically regardless of when it is armed.  Times
        already in the past fire on the next dispatch."""
        return self.schedule(t - self.now, fn, *args, **kw)

    def cancel(self, ev: _Event) -> None:
        ev.cancelled = True

    # ------------------------------------------------------------------
    def spawn(self, gen: Iterator[float], guard: Optional[Callable[[], bool]] = None,
              on_exit: Optional[Callable[[Any], None]] = None,
              on_error: Optional[Callable[[BaseException], None]] = None) -> None:
        """Drive a generator: each yielded float is a virtual-time sleep.
        ``guard`` is re-checked before every step — returning False abandons
        the generator (models a killed process).  ``on_exit(value)`` fires on
        normal return; ``on_error(exc)`` on an uncaught exception."""

        def step():
            if guard is not None and not guard():
                return
            try:
                delay = next(gen)
            except StopIteration as stop:
                if on_exit is not None:
                    on_exit(stop.value)
                return
            except Exception as e:           # process "exits nonzero"
                if on_error is not None:
                    on_error(e)
                else:
                    raise
                return
            self.schedule(float(delay), step)

        self.schedule(0.0, step)

    # ------------------------------------------------------------------
    def run(self, until: Optional[float] = None, max_events: int = 2_000_000) -> int:
        n = 0
        while self._heap and n < max_events:
            ev = self._heap[0]
            if until is not None and ev.time > until:
                break
            heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = max(self.now, ev.time)
            ev.fn()
            n += 1
        if until is not None:
            self.now = max(self.now, until)
        if n >= max_events:
            raise RuntimeError("sim event budget exceeded (livelock?)")
        return n

    def run_for(self, seconds: float) -> int:
        return self.run(until=self.now + seconds)
