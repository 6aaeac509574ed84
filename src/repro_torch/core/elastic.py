"""Elastic data parallelism: shrink/grow the learner group.

When a node dies and no spare capacity exists, a synchronous DP job is
stuck (the paper's stateful-set restart assumes a schedulable replacement).
``ElasticPolicy`` decides a new world size; the re-mesh math
(``remesh_plan``) maps the old data-parallel shards onto the survivors so
per-learner batch shares stay balanced.  Growth on healed capacity is the
mirror operation.  The platform applies a plan by rewriting the learner
StatefulSet size and letting learners re-read their shard assignment from
the volume (tested in tests/test_platform_dependability.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class RemeshPlan:
    old_world: int
    new_world: int
    # shard_of[new_learner] = list of old data shards it takes over
    shard_map: Dict[int, List[int]]
    global_batch: int
    per_learner_batch: Dict[int, int]


class ElasticPolicy:
    def __init__(self, min_world: int = 1, allow_grow: bool = True):
        self.min_world = min_world
        self.allow_grow = allow_grow

    def decide(self, desired_world: int, schedulable_world: int) -> Optional[int]:
        """Return the new world size, or None if the job must wait."""
        w = min(desired_world, schedulable_world)
        if w < self.min_world:
            return None
        if w == desired_world:
            return desired_world
        return w

    def remesh_plan(self, old_world: int, new_world: int,
                    global_batch: int) -> RemeshPlan:
        assert new_world >= 1
        shard_map: Dict[int, List[int]] = {i: [] for i in range(new_world)}
        for old in range(old_world):
            shard_map[old % new_world].append(old)
        base, rem = divmod(global_batch, new_world)
        per = {i: base + (1 if i < rem else 0) for i in range(new_world)}
        return RemeshPlan(old_world, new_world, shard_map, global_batch, per)
