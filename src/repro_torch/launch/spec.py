"""The training and serving knobs the port's CLIs and engine read (the
fields of the reference's ``core/jobspec.py:TrainSpec`` and ``ServeSpec``
that they use)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TrainSpec:
    total_steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    learning_rate: float = 1e-3
    num_microbatches: int = 1
    remat_policy: str = "none"       # none | dots | full
    reduced: bool = True             # tiny same-family config, fp32 compute
    log_every: int = 10


@dataclass(frozen=True)
class ServeSpec:
    batch: int = 4                   # concurrent decode slots
    prompt_len: int = 64
    gen: int = 32
    requests: int = 8
    page_budget: int = 0             # physical pages in the pool; 0 = worst case
    # optimistic admission: reserve worst-case pages up to overcommit ×
    # budget; on page exhaustion the engine evicts the youngest sequence
    # back to the queue (1.0 = conservative, never evicts)
    overcommit: float = 1.0
    # hash-addressed prefix caching with copy-on-write pages
    prefix_cache: bool = True
    # synthetic workload: fraction of prompt_len every request shares as a
    # common leading prefix
    shared_prefix_frac: float = 0.0
