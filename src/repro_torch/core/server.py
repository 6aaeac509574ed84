"""Serve- and dryrun-kind workload pods (Job API v2 kinds beyond training).

Server pods model inference replicas: each drains requests from the job's
shared queue and heartbeats through the shared NFS volume — the same
contract learners use, so the Guardian's generic gang monitor covers every
kind.  Dispatch is **payload-agnostic**: the framework adapter's
``payload`` hook decides whether a pod runs the virtual-time loop (the
default — fast tests) or drives real compute:

* **serve + RealServePayload** — the pod runs the actual
  :class:`repro.launch.engine.ServingEngine` (paged cache, continuous
  batching, optimistic admission).  The replica gang shares one claim
  counter on the volume (claim-then-serve: the claim is atomic, so R
  replicas serve EXACTLY ``requests`` requests); every claim is journaled,
  engine snapshots land on the volume every ``serve.snapshot_every`` decode
  steps, and completed responses ship to the job's COS prefix.  A killed
  pod restarts, rebuilds the model from the job seed (pure function),
  restores the last snapshot and replays the journal suffix — greedy
  decode is deterministic, so the recovered token streams are
  byte-identical to an uninterrupted run and every request completes
  exactly once across the gang.
* **dryrun + RealDryRunPayload** — the pod lowers + compiles the sweep
  cells for real, publishing genuine compile artifacts (memory/cost/
  collectives) to COS.  Cell completion markers on the volume keep the
  sweep resumable across restarts, as in the virtual path.

Both pod types run customer code and are therefore labelled with restricted
``NetworkPolicy`` roles: they may only touch their own volume and their own
job's object-store prefix (where they ship their logs through
``ObjectStore.append`` — O(line) per shipment, keeping ``ApiClient.logs``
uniform across kinds).
"""
from __future__ import annotations

import json

from repro_torch.core.jobspec import JobSpec, resolve_cells

LOG_SHIP_EVERY = 10              # requests between log shipments


def _ship_log(platform, job_id: str, idx: int, line: str) -> None:
    """Append one line to the job's COS log key (own-prefix write — the
    only object-store path NetworkPolicy allows a workload pod)."""
    platform.objectstore.append(f"cos/{job_id}/logs/{idx}",
                                line.encode() + b"\n")


def make_server_proc(platform, job_id: str, spec: JobSpec, idx: int):
    """Container process for server replica ``idx`` of a serve-kind job."""

    def proc(pod):
        sim = platform.sim
        vol = platform.volumes.get(f"vol-{job_id}")
        if vol is None:
            raise RuntimeError("volume not mounted")
        payload = platform.frameworks.get(spec.framework).payload(
            platform, job_id, spec)
        if payload is not None:
            yield from _real_server_loop(platform, job_id, spec, idx, vol,
                                         payload)
            return 0
        sv = spec.serve
        _ship_log(platform, job_id, idx,
                  f"[{sim.now:.2f}] server {idx} up "
                  f"(framework {spec.framework})")
        while True:
            # claim-then-serve: the claim is atomic (no yield between read
            # and write), so a gang of R replicas serves EXACTLY
            # ``requests`` — no stale-read overshoot of up to R-1
            claimed = vol.read("claimed", 0)
            if sv.requests and claimed >= sv.requests:
                break                         # queue drained by the gang
            vol.write("claimed", claimed + 1)
            yield sv.request_time_s           # process one request
            served = vol.read("served", 0) + 1
            vol.write("served", served)
            vol.write(f"progress/{idx}", {"served": served, "t": sim.now})
            if served % LOG_SHIP_EVERY == 0:
                _ship_log(platform, job_id, idx,
                          f"[{sim.now:.2f}] served {served}")
        vol.write(f"exit/{idx}", 0)
        _ship_log(platform, job_id, idx,
                  f"[{sim.now:.2f}] server {idx} done "
                  f"({vol.read('served', 0)} served)")
        return 0

    return proc


def _real_server_loop(platform, job_id: str, spec: JobSpec, idx: int, vol,
                      payload):
    """Drive the real serving engine under the platform's recovery
    contract: claim-then-serve from the shared volume counter, journal
    every claim, snapshot the engine periodically, ship each completed
    response to COS exactly once."""
    sim = platform.sim
    sv = spec.serve
    skey = f"engine/{idx}/snapshot"
    jkey = f"engine/{idx}/journal"

    engine, requests = payload.build()      # fresh params from the job seed
    snap = vol.read(skey)
    journal = vol.read(jkey, [])
    replay_from = 0
    if snap is not None:
        engine.restore(snap)
        replay_from = snap["vol_journal_len"]
    # journal replay: claims made after the last snapshot are not in the
    # restored queue/slots — resubmit them (order preserved, dedup against
    # everything the snapshot already carries)
    have = (set(engine.responses)
            | {r.request.req for r in engine.active_records()}
            | {r.req for r in engine.queue})
    for ev in journal[replay_from:]:
        if ev["ev"] == "claim" and ev["req"] not in have:
            engine.submit(requests[ev["req"]])
            have.add(ev["req"])
    _ship_log(platform, job_id, idx,
              f"[{sim.now:.2f}] server {idx} up (framework "
              f"{spec.framework}, engine "
              f"{'restored' if snap is not None else 'fresh'})")

    n_req = sv.requests
    # one decode step generates one token per active slot; price a request
    # at ~request_time_s of virtual time spread over its gen tokens
    tick = sv.request_time_s / max(sv.gen, 1)
    steps_since_snap = 0
    shipped = set()                          # ids this incarnation shipped

    def ship_completed():
        """Drain every not-yet-shipped completed response to COS —
        completions happen in admit() too (gen_len == 1 finishes at
        prefill), so drain the response log, not step()'s return."""
        if len(engine.responses) == len(shipped):
            return                       # O(1): nothing new finished
        for r in sorted(set(engine.responses) - shipped):
            body = json.dumps({"req": r, "tokens": engine.responses[r]},
                              sort_keys=True).encode()
            key = f"cos/{job_id}/responses/{r}"
            if platform.objectstore.exists(key):
                # deterministic re-execution after restore: the recovered
                # stream must be byte-identical to what the dead
                # incarnation shipped (exactly-once, nothing re-served)
                assert platform.objectstore.get(key) == body, \
                    f"response divergence on replay: request {r}"
            else:
                # not a read-modify-write: the get() above only *verifies*
                # an already-shipped response on replay; put() runs on the
                # disjoint not-yet-shipped branch and writes fresh bytes
                platform.objectstore.put(key, body)  # staticcheck: ignore[SC103]
                served = vol.read("served", 0) + 1
                vol.write("served", served)
                if served % LOG_SHIP_EVERY == 0:
                    _ship_log(platform, job_id, idx,
                              f"[{sim.now:.2f}] served {served}")
            shipped.add(r)

    while True:
        # claim one request per free slot (atomic: no yield in the loop)
        while len(engine.queue) < engine.free_slot_count():
            claimed = vol.read("claimed", 0)
            if claimed >= n_req:
                break
            vol.write("claimed", claimed + 1)
            vol.append(jkey, {"ev": "claim", "req": claimed})
            engine.submit(requests[claimed])
        engine.admit()
        if engine.idle:
            ship_completed()                 # gen_len==1 round completions
            if vol.read("claimed", 0) >= n_req:
                break                        # gang drained the queue
            yield tick
            continue
        engine.step()
        ship_completed()
        vol.write(f"progress/{idx}",
                  {"served": vol.read("served", 0), "t": sim.now})
        steps_since_snap += 1
        if steps_since_snap >= sv.snapshot_every:
            snap_doc = engine.snapshot()
            snap_doc["vol_journal_len"] = len(vol.read(jkey, []))
            vol.write(skey, snap_doc)
            steps_since_snap = 0
        yield tick

    vol.write(f"exit/{idx}", 0)
    _ship_log(platform, job_id, idx,
              f"[{sim.now:.2f}] server {idx} done "
              f"({vol.read('served', 0)} served, "
              f"{engine.decode_steps} decode steps, "
              f"{engine.evictions} evictions)")


def make_dryrun_proc(platform, job_id: str, spec: JobSpec, idx: int):
    """Container process for a dryrun-kind job: walk the sweep cells,
    publishing one artifact per cell to the job's COS prefix.  With a real
    payload the cells are lowered + compiled for real; cell completion
    markers live on the volume either way, so a restarted runner resumes
    the sweep instead of recompiling finished cells."""

    def proc(pod):
        sim = platform.sim
        vol = platform.volumes.get(f"vol-{job_id}")
        if vol is None:
            raise RuntimeError("volume not mounted")
        dr = spec.dryrun
        payload = platform.frameworks.get(spec.framework).payload(
            platform, job_id, spec)
        cells = resolve_cells(dr)
        for ci, cell in enumerate(cells):
            if vol.read(f"cell/{ci}") is not None and not dr.force:
                continue                      # resumable sweep
            if payload is None:
                yield dr.cell_time_s          # virtual lower + compile
                rec = {"ok": True}
            else:
                rec = dict(payload.run_cell(cell))   # real lower + compile
                yield 0.01                    # publish tick (work was real)
            rec.update(arch=cell.arch, shape=cell.shape,
                       mesh=cell.mesh_name, job=job_id)
            rec.setdefault("ok", True)
            key = (f"cos/{job_id}/dryrun/"
                   f"{cell.arch}__{cell.shape}__{cell.mesh_name}.json")
            platform.objectstore.put(key, json.dumps(rec).encode())
            vol.write(f"cell/{ci}", key)
            vol.write(f"progress/{idx}", {"cells": ci + 1, "t": sim.now})
            _ship_log(platform, job_id, idx,
                      f"[{sim.now:.2f}] cell {cell.arch}×{cell.shape}×"
                      f"{cell.mesh_name} done")
        vol.write(f"exit/{idx}", 0)
        _ship_log(platform, job_id, idx,
                  f"[{sim.now:.2f}] sweep complete ({len(cells)} cells)")
        return 0

    return proc
