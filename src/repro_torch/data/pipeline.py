"""Deterministic, resumable synthetic data (the reference's
``data/pipeline.py:SyntheticLMData`` contract).

``batch_at(step)`` is a pure function of ``(seed, step)``: a learner
restored from a step-``k`` checkpoint continues with batch ``k + 1``
bit-identically, with no iterator state to save.  The stream is an
order-2 noisy chain over the vocabulary, ``x_{t+1} = (31 x_t + 17) mod V``
resampled uniformly with probability ``noise``, so cross-entropy can fall
while no files are read; ``labels[t] = tokens[t + 1]``.

The draws come from numpy's generator seeded with ``(seed, step)``; the
reference draws with ``jax.random``, whose stream cannot be reproduced
bit for bit (ROADMAP D10), so tests that compare the two packages feed
both the reference's own batches.  :class:`SourceFramesData` adds an
encoder-decoder's encoder frames (the audio stub's ``src_embeds``) to
each batch, drawn from ``(seed, step)`` too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

CHAIN_A, CHAIN_B = 31, 17


@dataclass(frozen=True)
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1            # fraction of purely random tokens

    def batch_at(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """{tokens, labels} (B, S) int64 on ``device`` (the CPU by
        default)."""
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        rng = np.random.default_rng([self.seed, int(step)])
        x = rng.integers(0, V, size=B, dtype=np.int64)
        noise_tok = rng.integers(0, V, size=(B, S + 1), dtype=np.int64)
        is_noise = rng.random((B, S + 1)) < self.noise
        seq = np.empty((B, S + 1), dtype=np.int64)
        for t in range(S + 1):
            x = np.where(is_noise[:, t], noise_tok[:, t],
                         (CHAIN_A * x + CHAIN_B) % V)
            seq[:, t] = x
        seq_t = torch.from_numpy(seq).to(device)
        return {"tokens": seq_t[:, :S], "labels": seq_t[:, 1:S + 1]}


@dataclass(frozen=True)
class SourceFramesData:
    """An encoder-decoder's training stream: ``lm``'s tokens and labels
    and, at the reference's dry-run shape (``launch/specs.py``), the audio
    stub's encoder frames ``src_embeds`` (B, src_len, d_model) fp32, ``0.02
    N(0, 1)`` from numpy's generator seeded with ``(seed, step, 1)``, so a
    batch is still a pure function of ``(seed, step)``."""
    lm: SyntheticLMData
    d_model: int
    src_len: int

    def batch_at(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        batch = self.lm.batch_at(step, device)
        rng = np.random.default_rng([self.lm.seed, int(step), 1])
        x = rng.standard_normal(
            (self.lm.global_batch, self.src_len, self.d_model),
            dtype=np.float32)
        batch["src_embeds"] = torch.from_numpy(0.02 * x).to(device)
        return batch
