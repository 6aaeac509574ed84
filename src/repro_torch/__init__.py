"""PyTorch/CUDA port of the ``repro`` learner substrate.

The package imports ``torch`` and ``numpy`` and nothing of ``jax`` or of
``repro``: what it needs from the JAX package it keeps as its own copy.
Its entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Every Pallas kernel on the ported path is a CUDA C++
kernel under ``csrc/``, built for ``sm_90a`` at first use.
"""
