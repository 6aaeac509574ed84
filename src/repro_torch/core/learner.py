"""Learner container processes (the DL job's compute).

Synchronous data-parallel semantics are modeled honestly: each learner
advances a step only when every peer's heartbeat is fresh — a dead peer
stalls the group exactly like a blocking all-reduce.  Recovery follows the
paper §III-h:

* ``checkpoint`` mode — the whole group rolls back to the latest checkpoint
  (work lost = time since last checkpoint, set by the user's interval);
* ``rejoin`` mode — the restarted learner fetches current parameters from
  its peers (parameter-server style) and the group continues (work lost ≈
  restart time only).

``real_compute`` learners run actual training steps and persist real
parameter trees through the CheckpointManager.

This is the port's copy of the reference's ``core/learner.py``:
``make_learner_proc`` is the reference's, ``RealPayload`` drives the
port's torch train step.
"""
from __future__ import annotations

import gc
from typing import Any, Optional

import torch

from repro_torch.convert import overlay_train_state, train_state_to_jax
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.jobspec import JobSpec

HEARTBEAT_STALE = 3.0          # × step_time ⇒ peer considered unreachable
RESTORE_TIME = (1.0, 3.0)      # checkpoint download+load (virtual)
SAVE_TIME = (0.5, 1.5)         # checkpoint upload (virtual)


class RealPayload:
    """Actual torch training, injected via platform.register_payload().

    ``make_state() -> TrainState`` builds a fresh state of the port's train
    step (``train.steps.init_train_state``) on its device (``cuda`` unless
    the caller's ``make_state`` names another); ``train_step(state,
    batch) -> (state, metrics)`` updates it in place; ``data.batch_at(step)``
    gives a batch (torch tensors or numpy arrays), moved to the state's
    device.  Trees in and out (:meth:`restore`, :meth:`snapshot`) are numpy
    trees in the reference's layout (``convert.train_state_to_jax``), so a
    checkpoint of either package restores in the other; a job whose train
    step compresses its gradients carries its error buffers (``err``) in
    both, as the reference's state does.

    The payload object outlives its pod: the platform keeps it in
    ``platform.payloads`` across incarnations.  :meth:`restore` therefore
    drops the old incarnation's state and frees its device memory before
    it builds the new one, and :meth:`snapshot` copies the state to the
    host (the train step updates parameters and moments in place, so a
    snapshot that shared their storage would change under a later
    step)."""

    def __init__(self, make_state, train_step, data, loss_key="loss"):
        self.make_state = make_state        # () -> TrainState
        self.train_step = train_step        # (state, batch) -> (state, metrics)
        self.data = data                    # .batch_at(step)
        self.loss_key = loss_key
        self.state = None

    def restore(self, tree: Optional[Any]) -> int:
        if self.state is not None:
            dev = self._device()
            self.state = None               # the old incarnation is gone
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        self.state = self.make_state()
        if tree is None:
            return 0
        overlay_train_state(self.state, tree)
        return int(self.state["step"])

    def _device(self):
        return next(self.state["params"].parameters()).device

    def step(self, step_idx: int) -> float:
        dev = self._device()
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in self.data.batch_at(step_idx).items()}
        self.state, metrics = self.train_step(self.state, batch)
        return float(metrics[self.loss_key])

    def snapshot(self):
        return train_state_to_jax(self.state, self.state["params"].cfg)


def make_learner_proc(platform, job_id: str, spec: JobSpec, idx: int):
    """Container process for learner ``idx`` of ``job_id``."""

    def proc(pod):
        sim = platform.sim
        vol = platform.volumes.get(f"vol-{job_id}")
        if vol is None:
            raise RuntimeError("volume not mounted")
        ckpt = CheckpointManager(platform.objectstore, job_id)
        # payload-agnostic dispatch: the framework adapter decides whether
        # this pod drives real compute or stays virtual-time
        payload = platform.frameworks.get(spec.framework).payload(
            platform, job_id, spec)
        # chaos seam: the platform's FaultInjector gates each step (OOM,
        # wedge) and scales this incarnation's step time (straggler)
        faults = getattr(platform, "faults", None)
        slow = faults.incarnation_factor(job_id, idx) \
            if faults is not None else 1.0

        # -- wait for load-data helper ------------------------------------
        while not vol.read("data_ready"):
            yield 0.2

        # -- restore ---------------------------------------------------------
        yield sim.rng.uniform(*RESTORE_TIME)
        step = 0
        group_steps = [vol.read(f"progress/{j}", {"step": 0})["step"]
                       for j in range(spec.learners)]
        if spec.recovery_mode == "rejoin" and \
                max(group_steps) > 0:
            step = max(group_steps)           # catch up from peers (PS-style)
            if payload is not None:
                # A restarted container has no parameters in memory: fetch
                # the peers' current snapshot from the shared volume, or
                # fall back to the latest checkpoint.  Jump-starting ``step``
                # without restoring would make the first payload.step() crash
                # (state=None) — or worse, silently pretend the parameters
                # caught up.
                snap = vol.read("param_snapshot")
                if snap is not None and snap.get("tree") is not None:
                    payload.restore(snap["tree"])
                    step = int(snap["step"])
                else:
                    loaded = ckpt.load()
                    if loaded is not None:
                        payload.restore(loaded[1])
                        step = int(loaded[0])   # params only caught up to here
                    else:
                        payload.restore(None)
                        step = 0
            vol.append(f"log/{idx}", f"[{sim.now:.2f}] rejoined at step {step}")
        else:
            bad = ckpt.newest_invalid()
            if bad is not None:
                # restore evidence for the FailureClassifier: the newest
                # generation failed integrity and is being skipped
                vol.append(f"log/{idx}",
                           f"[{sim.now:.2f}] checkpoint step {bad} failed "
                           f"integrity; falling back")
            loaded = ckpt.load()
            if loaded is not None:
                step = int(loaded[0])
                if payload is not None:
                    payload.restore(loaded[1])
                vol.append(f"log/{idx}",
                           f"[{sim.now:.2f}] restored checkpoint step {step}")
            elif payload is not None:
                payload.restore(None)
        last_ckpt_t = sim.now

        vol.write(f"progress/{idx}", {"step": step, "t": sim.now})

        # -- train loop ---------------------------------------------------------
        while step < spec.total_steps:
            if faults is not None:      # armed faults crash the pod here
                faults.learner_gate(job_id, idx, step, vol)
            # group rollback marker (checkpoint-mode recovery)
            rb = vol.read("rollback_to")
            if rb is not None and rb.get("epoch", -1) > \
                    vol.read(f"rb_ack/{idx}", -1):
                step = min(step, rb["step"])
                vol.write(f"rb_ack/{idx}", rb["epoch"])
                if payload is not None:
                    loaded = ckpt.load(rb["step"]) or ckpt.load()
                    if loaded is not None:
                        payload.restore(loaded[1])
                vol.append(f"log/{idx}",
                           f"[{sim.now:.2f}] rolled back to step {step}")

            # synchronous DP: stall while any peer heartbeat is stale
            # (a finished peer — exit file present — no longer heartbeats).
            # World size is dynamic (elastic re-meshing shrinks it).
            world = vol.read("world", spec.learners)
            if idx >= world:
                return 0                      # resized away (defensive)
            stale = False
            for j in range(world):
                if j == idx or vol.read(f"exit/{j}") is not None:
                    continue
                pr = vol.read(f"progress/{j}")
                allow = HEARTBEAT_STALE * spec.step_time_s + 2.0
                if pr is not None and pr.get("saving"):
                    # peer announced a checkpoint upload: extend the lease by
                    # the worst-case save time so a slow save (or a short
                    # checkpoint interval) doesn't read as a dead peer
                    allow += SAVE_TIME[1]
                if pr is None or (sim.now - pr["t"]) > allow:
                    stale = True
            if stale:
                vol.write(f"progress/{idx}",
                          {"step": step, "t": sim.now, "stalled": True})
                yield spec.step_time_s
                continue

            # one training step
            if payload is not None:
                loss = payload.step(step)
                vol.write("last_loss", loss)
            yield spec.step_time_s * slow
            step += 1
            vol.write(f"progress/{idx}", {"step": step, "t": sim.now})
            if payload is not None and idx == 0 and \
                    spec.recovery_mode == "rejoin":
                # publish the current parameters for rejoin-mode peers
                # (PS-style fetch through the shared volume; cheap — the
                # snapshot holds references, not copies)
                vol.write("param_snapshot",
                          {"step": step, "tree": payload.snapshot()})
            if step % 50 == 0:
                vol.append(f"log/{idx}", f"[{sim.now:.2f}] step {step}")

            # periodic checkpoint (chief learner)
            if idx == 0 and (sim.now - last_ckpt_t) >= spec.checkpoint_interval_s:
                tree = payload.snapshot() if payload is not None \
                    else {"step": step}
                import numpy as np
                tree = tree if payload is not None else {
                    "step": np.asarray(step)}
                ckpt.save(step, tree)
                last_ckpt_t = sim.now
                vol.append(f"log/{idx}", f"[{sim.now:.2f}] checkpoint @ {step}")
                # heartbeat with a save lease, then refresh once the upload
                # finishes — peers must not mistake the save window for a
                # dead chief and spuriously stall the gang
                vol.write(f"progress/{idx}",
                          {"step": step, "t": sim.now, "saving": True})
                yield sim.rng.uniform(*SAVE_TIME)
                vol.write(f"progress/{idx}", {"step": step, "t": sim.now})

        # -- orderly exit: write exit code to the shared volume --------------
        vol.write(f"exit/{idx}", 0)
        vol.append(f"log/{idx}", f"[{sim.now:.2f}] done ({step} steps)")
        return 0

    return proc
