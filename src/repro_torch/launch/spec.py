"""The training and serving knobs of the port: the reference's
``TrainSpec`` and ``ServeSpec``, from the port's copy of the job resource
model (``core/jobspec.py``), so a platform job and a CLI run read one
definition with the reference's fields and defaults.

A field the port's engine or train loop does not implement is refused,
never silently ignored (:func:`check_serve_spec`,
:func:`check_train_spec`).  ``use_pallas`` is accepted and chooses
nothing: on the card every kernel runs, on the CPU its plain version
(ROADMAP, deliberate differences).  The platform knobs
(``real_compute``, ``step_time_s``, ``request_time_s``, ``snapshot_every``,
...) are read by the platform's workload pods, not here.
"""
from __future__ import annotations

from repro_torch.core.jobspec import ServeSpec, TrainSpec  # noqa: F401


def check_serve_spec(sv: ServeSpec, cfg, continuous=None) -> None:
    """Raise ``NotImplementedError`` for a ServeSpec field the port's
    serving path does not implement: the engine's (``continuous``, by
    default ``sv.continuous``), which pages its cache, or lockstep
    serving's (:mod:`repro_torch.launch.executor`), which serves either
    layout and has no prefill policy to choose."""
    continuous = sv.continuous if continuous is None else continuous
    if sv.cache_layout not in (None, "dense", "paged"):
        raise NotImplementedError(
            f"serve.cache_layout {sv.cache_layout!r}: dense or paged")
    if continuous and sv.cache_layout == "dense":
        raise NotImplementedError(
            "serve.cache_layout 'dense': continuous batching serves the "
            "paged cache only (lockstep serving takes the dense one)")
    if sv.mesh != "host":
        raise NotImplementedError(
            f"serve.mesh {sv.mesh!r}: the port serves on one card (meshes "
            "come with dist/, ROADMAP Queue 1 item 6)")
    if continuous and cfg.is_encoder_decoder and sv.ragged_prefill:
        # the reference's reason (launch/engine.py), as a refusal
        raise NotImplementedError(
            "serve.ragged_prefill needs a decoder-only stack; the "
            "encoder output is per-round, so enc-dec prefills per slot")
    if continuous and not cfg.is_encoder_decoder \
            and sv.ragged_prefill is False:
        raise NotImplementedError(
            "serve.ragged_prefill=False: the port's prefill of a "
            "decoder-only stack is always ragged (an encoder-decoder's is "
            "per slot)")
    if sv.page_size not in (0, cfg.page_size):
        raise NotImplementedError(
            f"serve.page_size {sv.page_size}: the engine pages by its "
            f"config's page_size ({cfg.page_size}); set it on the config "
            "(RealServePayload and the serve CLI do)")


def check_train_spec(t: TrainSpec) -> None:
    """Raise ``NotImplementedError`` for a TrainSpec field the port's train
    loop does not implement."""
    if t.mesh != "host":
        raise NotImplementedError(
            f"train.mesh {t.mesh!r}: the port trains on one card (meshes "
            "come with dist/, ROADMAP Queue 1 item 6)")
