#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on the first failure:

1. build   -- compiles every CUDA source of the port with ``nvcc`` for
              ``sm_90a`` (one process per source, all started together).
2. kernels -- holds each hand-written kernel against its plain PyTorch
              version on the card, at the shapes the serving paths give
              it, and times kernel, plain version and (where one PyTorch
              call computes the same function) the library call.  The
              WKV6 and RG-LRU kernels are also held against their
              step-by-step oracles, WKV6 also at constant lw -3 and -8,
              at decays down to -e^4 and at S 1, 5 and 9 (around its
              chunk of 8); the paged decode also at gemma2-9b's global
              shape (K 8, G 2, hd 256), mistral-large's group (K 8, G 12)
              and MQA at hd 256 (K 1, G 16), each in bf16 and as fp32 q
              over bf16 pools, and over long tables (several tiles a
              range), its two grids bit-equal; the MLA latent decode at
              deepseek-v2's serving shape, at H 16 and 128 over pages of
              16, in fp32 and as fp32 q over bf16 pools, and over long
              tables (B 8 to 8K keys a row, B 1 to 20K; bf16 and fp32).
              The paged decode, MLA decode and WKV6 are also timed with
              the L2 cold (a 256 MB write before each call).  The flash
              forward also at paper-overhead-100m's training shape (B 8,
              S 1,024, hd 64) and granite-moe's (B 4, S 4,096, H 16, K 8,
              hd 64); the flash backward against its plain
              backward on the same (q, k, v, O, lse, dO) at the three
              training shapes (paper: B 8, S 1,024, H 12, K 4, hd 64;
              qwen3: B 2, S 4,096, H 16, K 8, hd 128; granite: B 4, S
              4,096, H 16, K 8, hd 64), ragged S 1,000 and
              77, deepseek-v2's (t5) (B 2, S 4,096, H 128, q and k 192
              wide over v 128; bf16 and fp32, ragged S 1,000, 77 and 1;
              the forward also there, with its log-sum-exp, beside the
              SDPA backend that takes the shape, if one does; a planted
              fault more: k's rope columns dropped, and every fault at
              least 10 times over the tolerance), the bf16 kernels' tile
              edges (S 127, 255, 257 with G 2
              and 3), more work items than the card runs at once (B 2, S
              2,048, hd 128), not causal and with a window and softcap,
              bf16 and fp32, two calls bit-equal, each within a tolerance
              scaled by its 64-row or 64-key tile that rejects planted
              faults (a q head of each group or the last q tile dropped
              from dK and dV, the window's frontier one key off), timed
              beside SDPA's backward and split by kernel (dQ with the
              statistics, dK/dV); the forward kernel's log-sum-exp
              against the plain one.  The WKV6 backward against its plain
              backward on the same inputs and state checkpoints (the
              forward kernel's, which must leave o and s_final as they
              are without them) at rwkv6-7b's training shape (B 2, S
              4,096, H 64, N 64) in bf16 and fp32, N 16 and 32, ragged S
              (1,000, 77, 65, 63, 1), nonzero s0 and ds_final, decays
              down to -e^4 and constant -3 and -8, two calls bit-equal,
              each within a tolerance scaled by its 64-step tile that
              planted faults (a step's dO dropped, a checkpoint zeroed,
              ds_final dropped) pass at least 10 times over.  The flash
              backward also at recurrentgemma's (t6) (B 1, S 4,096, 16 q
              heads over one kv head of 256, window 2,048; bf16 and fp32,
              ragged S 1,000, 77 and 1, S 2,047, 2,049 and 4,095 around the
              window, K 8 G 2), its planted faults at least 10 times over
              (the window's frontier on a case of sharp scores); the
              forward at (t6)'s shape.  The RG-LRU forward at (t6)'s shape
              and the RG-LRU backward against its plain reverse loop at
              (t6)'s microbatch (B 1, S 4,096, R 4,096) and at B 2,
              ragged S 1,000, 17, 15 and 1, nonzero h0 (dh0), padding
              steps, decays down to -8·e^4 and up to 0, two calls
              bit-equal, each element within a tolerance scaled by its
              64-step tile that planted faults (a step's dh dropped, h
              read one step late) pass at least 10 times over, timed
              against its bound.  The flash forward and backward also at
              qwen2.5-32b's training row (B 1, S 4,096, H 40, K 8: G 5)
              and mistral-large-123b's (H 96, K 8: G 12), bf16 and fp32,
              each ragged (S 1,000, 2,049); the backward at hd 256 under
              gemma2-9b's softcap (50, scale 1/16) at its training row (B
              1, S 4,096, H 16, K 8), local (window 4,096) and global,
              bf16 and fp32, ragged S 1,000 and 2,049, a window of 100, K 1
              G 16, and a case of sharp scores (q 40 times wider) where
              the planted faults include the softcap's 1 - tanh^2 dropped
              from dS; the forward at gemma2's training row and at its
              serving prefill (B 8, S 3,072).  The flash forward and
              backward also at internvl2-76b's training row (B 1, S
              4,096, H 64, K 8: G 8), bf16 and fp32, ragged (S 1,000), and
              the forward at its frontend prefill (B 8, S 1,280); the
              paged decode also at its group (K 8, G 8, hd 128) over the
              frontend's table and a long one, bf16 and fp32 q.  The
              planted faults of each of these backward cases at least 10
              times over its tolerance.  The flash forward and backward
              at a key length apart from the query length
              (:func:`run_cross_flash_phase`): seamless-m4t-medium's
              cross-attention at (t11) (B 2, 4,096 queries over 1,024
              keys, H = K = 16, hd 64) and (j) (1,024 over 264), its
              encoder's full and its decoder's causal self-attention (G 1
              at hd 64), (t11)'s cross in fp32, and Sk 1, 77, 1,000 and
              65, Sq 1, Sq < Sk and G 2 at hd 128: outputs, log-sum-exp
              and gradients within the tolerances above, two backward
              calls bit-equal, planted faults at least 10 times over (the
              last key tile dropped from dQ; the key past Sk read as live,
              on scores below zero), timed beside SDPA (which takes L != S
              without a mask) and its backward.
3. serve   -- serves ``qwen3-0.6b`` at full width in bf16 through the
              port's continuous-batching engine, twice: (a) without the
              prefix cache, so ragged prefill runs the flash kernel and
              decode the paged-decode kernel; (b) with the prefix cache and
              a shared prompt prefix (chunked prefill, copy-on-write).
              Launch counters are zeroed just before each run and read
              just after it.  Then one prefill round and four decode
              steps of (a) run again under torch.profiler (where the time
              goes, the device's idle share); the numbers above are
              taken with the profiler off.
3b. lockstep -- the reference's default serve path
              (``launch.executor.run_lockstep``: one prefill of the whole
              batch, then every row decoded at one shared position a
              step), bf16, the same numpy prompts over the dense cache and
              then over the paged one with identity page tables: (k)
              ``qwen3-0.6b`` at full width, B 8, P 1,024, G 32; (l)
              ``deepseek-v2-236b`` at full width cut to 3 layers, B 8, P
              1,024, G 16.  Each run's launches checked exact (flash a
              layer a prefill but in (l)'s paged prefill, which scores
              the fresh latents in plain PyTorch; the paged and MLA
              decodes a layer a step on the paged layout, none on the
              dense one, whose decode is plain PyTorch as the
              reference's), its seconds, rate and peak memory; one traced
              decode step of each layout; the two bf16 streams compared
              (the share of equal tokens; where they part, the step and
              the dense row's top-2 margin); the dense decode attention
              timed beside the paged kernel at (k)'s decode shape, and
              the flash forward at MLA's pair at (l)'s prefill shape
              (kernel, plain, SDPA's memory-efficient backend, bound).
              Then fp32 parity of cuda dense, cuda paged and cpu dense
              ((k) at 2 layers, B 4, P 256, G 8; (l) at the deepseek
              parity's cut): live logits within tolerance, streams equal
              or parting at a tie.
4. parity  -- the same weights (built on each device, equal bit for bit:
              the draws are the host's) and requests through the engine
              on ``cuda`` and on ``cpu`` in fp32 with TF32 off (full
              width, 4 layers):
              the live logits of every prefill and decode step within
              tolerance (up to the first divergent step, which must be a
              tie, if the token streams part), then a byte-identical
              snapshot/restore on ``cuda``.
5. rwkv    -- the same for ``rwkv6-7b`` (32 layers, d 4096, 64 heads of 64,
              7.04 B parameters without the embeddings; its build
              timed): serve at full
              width in bf16 with the WKV6 kernel in every prefill of every
              layer (its launches must be 32 a prefill round, none of
              them writing state checkpoints), one traced
              prefill round and four decode steps, then fp32 cuda vs cpu
              parity at full width and 2 layers (prompts up to 90 tokens:
              a chunk, a ragged tail and padded rows; the vocabulary cut
              to 16,384 and d_ff to 4,096, SERVE_PARITY_VOCAB and
              SERVE_PARITY_FFN, as in 6, 7 and 7c) and
              snapshot/restore of the RWKV state on ``cuda``.
6. recurrentgemma -- the same for ``recurrentgemma-9b`` (38 layers: 26
              RG-LRU and 12 local-attention layers, d 4096, 16 q heads over
              one kv head of 256, window 2,048; 9.40 B parameters), run after
              rwkv6-7b's weights are freed: serve at full width in bf16 with
              prompts up to 2,560 tokens and one pinned at 2,040 whose ring
              wraps during decode (the RG-LRU kernel 26 times and the flash
              kernel at hd 256 12 times a prefill round), one traced
              prefill round and four decode steps, then fp32 cuda vs cpu
              parity at full width and 3 layers (R, R, L) with the window
              cut to 64 so prompts up to 150 tokens wrap the rings on the
              cpu, and snapshot/restore of h, conv and the rings on
              ``cuda``.
7. deepseek -- the same for ``deepseek-v2-236b`` at full width cut to 3
              layers (MLA with 128 heads over a 512 + 64 latent, the dense
              first layer and two MoE layers of 160 experts, top-6 and 2
              shared; 9.33 B parameters), run after recurrentgemma-9b's
              weights are freed: serve in bf16 with the MLA kernel 3 times
              a decode step, one traced prefill round and four decode
              steps, then fp32 cuda vs cpu parity at full width and 2
              layers with the experts cut to 8 and the dense FFN to 1,536
              (prefix cache on, so every
              prefill is the chunked walk, a shared-prefix request for
              copy-on-write and a page budget that forces an eviction; a
              routing flip counts as a tie only within PARITY_TIE_TOL) and
              snapshot/restore of the latent pools on ``cuda``.

7b. dense  -- serves qwen2.5-32b (f: 16 of 64 layers, prompts up to
              1,024), mistral-large-123b (g: 7 of 88 layers) and gemma2-9b
              (h: 40 of its 42 local and global layers, prompts up to
              3,072 on an
              engine sized for 4,096 tokens, the ring of a local layer a
              whole window) at full width in bf16, 8 slots, 16 requests:
              every request completes its budget, the flash kernel once a
              layer a prefill round, the paged decode once a global layer
              a decode step (gemma2's local layers decode from their rings
              in plain PyTorch), no other kernel, peak memory at most 70
              GB; then (i) internvl2-76b (10 of 80 layers, G 8) the same
              way, served text-only as the reference's engine serves it,
              its prefix cache asked for and turned off, and on the same
              weights its vision frontend: 8 rows of 256 patch embeddings
              and ragged prompts up to 1,024 through one ragged prefill
              and 16 decode steps (the flash kernel once a layer, the
              paged decode once a layer a step, logits finite), then the
              same in fp32 on cuda and cpu at 2 layers (d_ff 4,096,
              vocabulary 16,384; 4 rows of prompts up to 128): live
              logits within 2e-3, greedy tokens equal but at a tie.
7c. seamless -- (j) serves seamless-m4t-medium at full depth (12 encoder
              and 12 decoder layers, 977.9 M parameters) in bf16: 8
              slots, 16 full-length prompts of 1,024 tokens, each
              prefilled alone on its slot over its own 264 frames, 16-32
              new tokens; the flash kernel 36 times a prefill (12 of them
              cross-attention at Sk 264), the paged decode 12 times a
              step, no other kernel; a traced prefill round and four
              decode steps; fp32 cuda-vs-cpu parity at 2 + 2 layers with
              evictions, snapshot/restore, and an evicted request
              replayed into its slot with its cross and paged K/V
              byte-identical.
8. train   -- trains ``paper-overhead-100m`` at full width (12 layers, B 8,
              S 1,024, 30 steps, lr 1e-3, warmup 3), ``qwen3-0.6b`` at
              full width (28 layers, S 4,096, global batch 4 in 2
              microbatches, full remat, 6 steps) and
              ``granite-moe-1b-a400m`` at full width (24 layers, 32
              experts top-8, S 4,096, global batch 4, full remat, 6
              steps; its remat check on one row, B 4 does not fit
              without remat; aux beside the CE; MFU over the active
              parameters; the traced step split by the MoE's profiler
              ranges), ``deepseek-v2-236b`` at full width cut to 2 layers
              ((t5): the dense layer and an MoE layer of 160 experts,
              top-6, 2 shared; MLA through the flash kernels at qk 192 /
              v 128, 2 x 2 forward and 2 backward a step; its train_4k run
              at B 2, S 4,096, 1 microbatch of its 16, full remat, bf16
              master weights and moments; peak memory at most 70 GB; its
              remat check on one row) and ``rwkv6-7b`` at full width cut
              to 6 layers
              (half of the 12 that leave 8 GB of the card free; its
              train_4k run: S 4,096, global batch 4 in 2 microbatches,
              full remat, 6 steps; WKV6 forward 2 x 6 x 2 and backward 6
              x 2 a step; its remat check on one row) and
              ``recurrentgemma-9b`` at full width cut to 3 layers ((t6):
              one (R, R, L) group, 1.70 B parameters; its train_4k run:
              S 4,096, global batch 2 in 2 microbatches, full remat, 6
              steps; RG-LRU forward 2 x 2 x 2 and backward 2 x 2 a step,
              flash at hd 256 forward 2 x 1 x 2 and backward 1 x 2; peak
              at most 70 GB; its remat check on one row) and the dense
              decoders' train_4k runs at full width cut in depth, one row
              a microbatch: (t7) qwen2.5-32b at 2 layers, B 2 in 2
              microbatches; (t8) mistral-large-123b at 2 layers, B 1;
              (t9) gemma2-9b at 2 layers (one (local, global) pair, both
              softcaps, the flash backward at hd 256 with its cap), B 4 in
              its 4 microbatches; (t10) internvl2-76b at 1 layer, B 1 in 1
              of its 16, text-only, then one step on a batch of the
              reference's dry-run shape (256 patch embeddings and 3,840
              tokens a row: the flash kernels at S 4,096, loss finite);
              peak at most 70 GB, remat checks on one
              row), (t11) seamless-m4t-medium at full depth, its
              train_4k run (B 4 in 2 microbatches, S 4,096 over 1,024
              frames a row, full remat; flash 144 forward and 72
              backward a step) in bf16 with fp32 master
              weights (deepseek-v2's bf16), through
              ``repro_torch.launch.train``'s loop (the
              trained kernels' plain versions barred), after
              deepseek-v2's weights are freed: every loss finite, a
              held-out batch's loss lower after training than at init,
              one batch's loss more than 1 nat lower after 6 steps on it
              from a fresh init, and (paper; qwen3's 6 steps move its
              loss less than its batches differ) the last 5 losses' mean
              below the first 5's, qwen3's first step under remat equal
              bit for bit to the same step without it, the flash
              launches a step (paper 12 forward and 12 backward; qwen3
              2 x 28 x 2 forward under remat and 28 x 2 backward),
              steps/s, tokens/s, MFU and peak
              memory, then one more step under torch.profiler (device busy
              and idle share, device ms by part).  Their weights, like
              those of every full-width serving build (3, 5-7c), are
              drawn on the card (``init_params``'s ``draws="device"``):
              no CPU side holds them to anything, and the host's draws
              took 12-18 s a serving build; the parity builds draw on
              the host, where both devices must hold the same numbers.
              (t5) runs after (t4), (t6) after (t5), (t7)-(t10) after
              (t6).
              Before granite, one
              MoE FFN at its width and shape runs forward and backward
              with ``torch.cuda.set_sync_debug_mode("error")`` (no host
              sync), twice bit-equal.  Then fp32 cuda vs cpu
              parity of the eleven configs at full width and 2 layers (B 2,
              S 256, 3 steps; deepseek-v2 with 8 experts, d_ff 1,536, a
              vocabulary of 16,384 and B 1; recurrentgemma-9b at 3 layers
              (R, R, L), its window cut to 64 and a vocabulary of 16,384;
              rwkv6-7b at 1 layer, a vocabulary of 16,384 and lr 3e-4, its
              gradients within
              5e-4; qwen2.5-32b (d_ff 4,096), mistral-large-123b (1 layer,
              d_ff 4,096) and gemma2-9b (one (local, global) pair, window
              64) at a vocabulary of 16,384; internvl2-76b (1 layer, d_ff
              4,096, vocabulary 16,384) on rows of 32 patch embeddings and
              224 tokens;
              seamless-m4t-medium at 2 + 2 layers and 16,384 on rows of
              256 tokens over 64 frames.  Its CPU side runs from right after
              the build in a second process on 4 of the host's cores (this
              process keeps the others, and takes all of them back once
              the worker has finished; the host-bound rates taken
              meanwhile say so) and the phase computes the card's side:
              the initial states equal (their digests), the MoE's routing
              equal or parted at a tie, losses within 1e-5 relative, the
              first batch's gradients within 1e-4 of each leaf's largest)
              and a checkpoint round trip through the reference's tree
              (``train_state_to_jax`` and back) whose next step's loss
              equals the unrestored state's.
9. platform -- the learner and the server as real payloads under the
              port's copy of the platform (``repro_torch.core``): (p1)
              paper-overhead-100m at full width (B 8, S 1,024, bf16
              compute, fp32 master) as a 40-step job (0.5 virtual s a
              step, a checkpoint every 5 virtual s), the learner pod killed
              two steps after the first checkpoint at or past step 20: the
              job completes with one restart, the log restores the last
              checkpoint before the kill, the state right after the restore
              is byte-equal to the saved tree, every loss (replayed steps
              included) and the final state are bit-equal to an
              uninterrupted 40-step run of the same payload, the flash
              launches are 12 forward and 12 backward a step run; the job's
              wall seconds split into steps, checkpoint saves (device to
              host, serialise, hash and store), the restore and the rest
              (the simulation), beside the uninterrupted run's steps/s.
              (p3) the same job for granite-moe-1b-a400m at full width
              cut to 2 layers (B 4, S 4,096; a checkpoint of 1.9 GB), the
              same checks.
              (p2) a qwen3-0.6b serve job at full width in bf16 (8 slots,
              16 requests, prompts up to 1,024 tokens, a snapshot every 8
              decode steps, no prefix cache), once uninterrupted and once
              with the server pod killed after its first snapshot: both
              complete, every request shipped once with its full budget,
              the streams equal (where they part, at a recorded top-2 gap
              within PARITY_TIE_TOL).
10. compression -- the train step's gradient compression with error
              feedback (``dist/compression.py``): (t1c) paper-overhead-100m
              as (t1) (B 8, S 1,024, bf16 compute, fp32 master, 30 steps)
              under grad_compression none, int8 and topk in turns, flash
              launches exact, finite losses, the held-out batch lower,
              steps/s, tokens/s, MFU, peak memory, and one traced step of
              each compression with its ``dist.compress_grads`` range's
              device ms and launches; the int8 wire bytes of (t1)'s
              gradient tree against fp32; sent + err_new == grad + err_old
              on (t1)'s gradient tree, element by element; three fp32 int8
              steps on the card and the CPU (2 layers, vocabulary 16,384):
              losses within 1e-5, levels apart only as far as the devices'
              quotients target / scale allow (where the targets agree, only
              across a half level), residuals within one level; (p4)
              (t1) under int8 as a 14-step platform job killed after its
              checkpoint at step 10, bit-equal to an uninterrupted run,
              error buffers included; the int8
              all-reduce over a one-rank NCCL group bit-equal to the
              pack/unpack round trip.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  With no CUDA device, or
without the repository's sources beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
# (float32 outside the tensor cores, tfloat32 on them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 494.7e12}
FLUSH_BYTES = 256 * 2 ** 20   # written between calls of an L2-cold timing

# (atol, rtol): every element must satisfy |kernel - plain| <= atol +
# rtol·|plain|.  Both kernels compute in fp32 and round the output once, so
# bf16 outputs may differ by one bf16 ulp of the value (rtol 2^-7); the
# flash kernel also rounds P to bf16 for its tensor-core P·V product, which
# its atol covers.  One key dropped from a 1,000-key row breaks both.
FLASH_TOL = {"bfloat16": (4e-3, 2 ** -7), "float32": (1e-4, 0.0)}
# bf16 at hd 256 (recurrentgemma's local layers): 2^-8·max|v| + 2^-7·|plain|.
# Rounding P to bf16 (2^-9 relative) moves an output by at most
# 2^-9·Σ p|v| / Σ p <= 2^-9·max|v|; the bound doubles that as a margin for
# the fp32 differences (exp, sum order), and both sides round the output
# once (the rtol).  Rows with few live keys (large p, little averaging)
# come near it; at the serving shape (84 M outputs, 10× the
# hd-128 case) one output below |plain| 1.5 was 0.0156 (2 ulps) off, past
# the 4e-3 + 2^-7·|plain| of FLASH_TOL, which stays for hd 64 and 128.
FLASH_HD256_VSCALE = 2 ** -8
DECODE_TOL = {"bfloat16": (1e-4, 2 ** -7), "float32": (1e-5, 0.0)}
# WKV6 sums hundreds of k vᵀ terms into outputs of magnitude ~100, so its
# absolute term is a share of the output's largest magnitude: 1e-5 against
# the step-by-step oracle (the kernel's own arithmetic order), 3e-5
# against the chunked plain version, whose own fp32 error reaches 1e-5 of
# that scale at lw = -e^2 (cancellation in its log-space cumulative sums,
# measured against an fp64 recurrence on the CPU).  bf16 outputs are
# rounded once from fp32 in both versions: one bf16 ulp of the value more.
WKV_SCALE = {"oracle": 1e-5, "chunked": 3e-5}
WKV_RTOL = {"bfloat16": 2 ** -7, "float32": 0.0}
# RG-LRU: |kernel - plain| <= 1e-5·max|plain| + 1e-5·|plain|.  The kernel
# fuses each step's multiply-add (one rounding), the plain loop rounds the
# product and the sum, and the carries (up to ~30 at decays near 1) pass
# the difference on through thousands of steps.
RGLRU_TOL = (1e-5, 1e-5)
# The RG-LRU backward: |kernel - plain| <= share·T + RGLRU_BWD_NOISE for
# every element, T the largest |plain| of the element's tile: BWD_TILE steps
# of one batch row over every channel (dlog_a, db), or the row's channels
# (dh0).  Both sides walk the same fp32 reverse recurrence; the kernel fuses
# the carry's multiply-add (one rounding where the plain loop has two), and
# carries near decay 1 pass the difference on over thousands of steps
# (measured: 1.3e-7 of the largest at (t6)'s shape).  Planted faults (one
# step's dh dropped, h read one step late) must land at least
# RGLRU_BWD_FAULT times over it.
RGLRU_BWD_TOL = 1e-5
RGLRU_BWD_NOISE = 1e-6
RGLRU_BWD_FAULT = 10.0
# The flash backward: |kernel - plain| <= share·T + BWD_NOISE + rtol·|plain|
# for every element, T the largest |plain| of the element's tile: 64 rows
# (dq) or 64 keys (dk, dv) of one batch row and head, the tiles the kernel
# computes.  The scale is the tile's and not the tensor's because a
# gradient's size falls along the keys (a causal key k gets its dK and dV
# from S - k rows, each p about 1/row): one scale for the whole tensor
# would set an allowance as large as the late keys' gradients.
# bf16: the kernel rounds P and dS to bf16 for its tensor-core products
# (2^-9 relative each; over sums of many terms of random sign that is
# about 2^-9 of a typical element, a few times less than 2^-7 of its
# tile's largest), and both sides round the result to bf16 once (one
# ulp, 2^-7·|plain|).  fp32: 1e-4 of the tile's largest (sums in another
# order).  BWD_NOISE covers the gradients that are 0 but for fp32
# rounding (dQ and dK at S 1: dP - D cancels), whose tile has no scale.
# The smoke checks that the allowance rejects planted faults: one q head
# of each group dropped from dK and dV, the last q tile dropped from them
# (at a ragged S the partial tile), the window's frontier one key off.
FLASH_BWD_TOL = {"bfloat16": (2 ** -7, 2 ** -7), "float32": (1e-4, 0.0)}
BWD_NOISE = 1e-5
BWD_TILE = 64
# The WKV6 backward: |kernel - plain| <= share·T + WKV_BWD_NOISE +
# rtol·|plain| for every element, T the largest |plain| of the element's
# tile: BWD_TILE steps of one (batch, head) for dr, dk, dv and dlw, one
# head's N channels for du, one (batch, head) state for ds0.  Both sides
# rebuild the states from the same checkpoints by the same fp32 step
# recurrence and sum in other orders (fp32: 1e-5 of the tile's largest;
# du sums over every step of the batch); bf16 dr, dk, dv are rounded once
# from fp32 on both sides (one ulp, 2^-7·|plain|).  The smoke checks that
# planted faults (one step's dO dropped, a segment's checkpoint zeroed,
# ds_fin dropped) land at least WKV_BWD_FAULT times over it.
WKV_BWD_TOL = {"bfloat16": (1e-5, 2 ** -7), "float32": (1e-5, 0.0)}
WKV_BWD_NOISE = 1e-6
WKV_BWD_FAULT = 10.0
# du = sum over (b, t) of r_t ⊙ k_t (dO_t · v_t), per head and channel.
# A share of its head's largest |du| covers the sum over steps, but not a
# step's own term where dO_t · v_t cancels (S 1: du is that one term, far
# below its terms' magnitudes, and both sides' rounding of the dot product
# reached 3.8 times the share).  So du's allowance also holds each term to
# the rounding of what it takes alone: each side rounds the N products and
# N - 1 partial sums of dO_t · v_t and the two products with r_t and k_t,
# at most N + 3 roundings of relative size u = 2^-24 over the term's
# summed magnitude tau_t = |r_t k_t| · sum_j |dO_tj v_tj| (the forward
# error bound of a recursive dot product, gamma_{N+3} = (N + 3) u / (1 -
# (N + 3) u), Higham, Accuracy and Stability of Numerical Algorithms,
# §3.1); the kernel and the plain side are two such, so the factor is
# 2·gamma_{N+3} (8.0e-6 at N 64: 35 times what the two sides reach
# against fp64 over 300 draws at S 1, 1.15e-7 and 1.12e-7 of their summed
# terms).  The steps' roundings are independent, so their bounds add in
# quadrature: 2·gamma_{N+3}·sqrt(sum over (b, t) of tau_t²).  A planted
# fault (one step's dO dropped) must land WKV_BWD_FAULT times over du's
# allowance too.


def wkv_du_rounding(N: int) -> float:
    """2·gamma_{N+3}: both sides' rounding of a du term over its summed
    magnitude (see WKV_BWD_TOL)."""
    g = (N + 3) * 2.0 ** -24
    return 2.0 * g / (1.0 - g)


def wkv_du_terms(r, k, v, do):
    """sqrt(sum over (b, t) of tau_t²) for every (head, channel): tau_t =
    |r_t k_t| · sum_j |dO_tj v_tj|, du's terms' summed magnitudes, in
    fp32 (an allowance, not an output)."""
    f = lambda x: x.float()  # noqa: E731
    tau = (f(r) * f(k)).abs() * (f(do) * f(v)).abs().sum(-1, keepdim=True)
    return tau.square().sum((0, 1)).sqrt()


# the forward kernel's log-sum-exp against the plain one: 1e-5 of max(1,
# |lse|) (fp32 statistics in both types; the bf16 walk's ex2.approx)
LSE_TOL = 1e-5
PARITY_LOGIT_TOL = 2e-3      # fp32 cuda vs cpu, 2-4 layers, summation order
# The serving parity of rwkv6-7b, recurrentgemma-9b, deepseek-v2-236b and
# seamless-m4t-medium runs its full-width sequence mixers over a
# vocabulary cut to 16,384 (65,536, 256,000, 102,400, 256,206) and FFNs
# cut as the train parity cuts them (SERVE_PARITY_FFN): what it holds the
# card to is the engine and the kernels of its mixers (WKV6; the RG-LRU
# scan and flash at hd 256; the MLA decode and its routing; the flash
# kernels at Sk != Sq), which neither reaches, while the host's draws of
# both devices' weights and the CPU side's head and FFNs were most of each
# phase's parity
SERVE_PARITY_VOCAB = 16_384
SERVE_PARITY_FFN = {"rwkv6-7b": dict(d_ff=4_096),
                    "recurrentgemma-9b": dict(d_ff=4_096),
                    "deepseek-v2-236b": dict(d_ff=1_536, num_experts=8)}
PARITY_TIE_TOL = 2e-3        # top-2 gap below which a divergence is a tie
# rwkv6-7b's (t4) depth: 12 layers are the most that leave 8 GB of the
# card's 80 GB free (a layer adds 220 M parameters at 22 bytes in
# training, 4.84 GB: fp32 master and moments, two microbatches' fp32
# gradients, the bf16 compute copy); the smoke trains half of them, 1.86
# B parameters, to stay inside its time limit (12 took 63 s of it)
RWKV_TRAIN_LAYERS = 6
PEAK_MEM_LIMIT_GB = 70.0     # deepseek-v2 at 3 layers: 56 GB of weights
# deepseek-v2's (t5) depth: layer 0 dense, layer 1 MoE; 5.36 B parameters
# at 8 bytes in training (bf16 weights, moments and gradients), 42.9 GB;
# a third layer adds 3.97 B (31.8 GB) and does not fit
DEEPSEEK_TRAIN_LAYERS = 2
# the train parity's cuts beyond 2 layers: deepseek-v2's experts 160 -> 8,
# dense d_ff 12,288 -> 1,536, vocabulary 102,400 -> 16,384 and one row of
# 256 tokens keep its CPU side near a minute (at 8 experts, 16,384 and B 2
# it took 150 s) and its host memory (fp32 state and trees) well inside
# the host's; the attention keeps its widths (d 5,120, H 128, qk 192, v
# 128, lora 512)
# recurrentgemma-9b's: 3 layers (R, R, L), the window 2,048 -> 64 (S 256
# crosses it) and the vocabulary 256,000 -> 16,384 (its CPU side's logits).
# rwkv6-7b's: 1 layer and the vocabulary 65,536 -> 16,384, so that the
# smoke stays in its time limit with recurrentgemma's parity added (at 2
# layers and 65,536 its CPU side took 140-153 s of the smoke's ~1,060-1,090)
# qwen2.5-32b's, mistral-large-123b's and gemma2-9b's: the vocabulary ->
# 16,384 (152,064, 32,768, 256,000); mistral-large's d_ff 28,672 -> 4,096
# (at 2 layers its FFN alone would hold 2.1 B fp32 parameters on the
# host) and qwen2.5's 27,648 -> 4,096 (its CPU side took 127 s of the
# worker's ~590, and the card side, compare and round trip 23 s of the
# phase's 142); gemma2's window 4,096 -> 64 (S 256 crosses it) and one (local,
# global) pair, both softcaps and the post-block norms kept;
# seamless-m4t-medium's: 2 encoder and 2 decoder layers, the vocabulary
# 256,206 -> 16,384, rows of 256 tokens over 64 frames
PARITY_CUTS = {"deepseek-v2-236b": dict(num_experts=8, d_ff=1_536,
                                        vocab_size=16_384),
               "recurrentgemma-9b": dict(window_size=64,
                                         vocab_size=16_384),
               "rwkv6-7b": dict(vocab_size=16_384),
               "qwen2.5-32b": dict(d_ff=4_096, vocab_size=16_384),
               "mistral-large-123b": dict(d_ff=4_096, vocab_size=16_384),
               "gemma2-9b": dict(window_size=64, vocab_size=16_384),
               "internvl2-76b": dict(d_ff=4_096, vocab_size=16_384),
               "seamless-m4t-medium": dict(num_encoder_layers=2,
                                           vocab_size=16_384)}
PARITY_BATCH = {"deepseek-v2-236b": 1}
# mistral-large-123b and internvl2-76b at 1 layer: the widest dense stacks
# (d 12,288 and 8,192), whose fp32 states (16.3 and 9.3 GB at 2 layers,
# master weights and moments) made their round trips and gradient
# comparisons the phase's longest (29 and 19 s) and their CPU sides 124
# and 67 s of the worker's; a layer's gradient flowing into another is
# held at 2 layers by the other dense GQA stacks
PARITY_LAYERS = {"recurrentgemma-9b": 3, "rwkv6-7b": 1,
                 "mistral-large-123b": 1, "internvl2-76b": 1}
# internvl2-76b's parity batches carry its frontend: 32 patch embeddings
# and 224 tokens a row of 256
PARITY_FRONTEND = {"internvl2-76b": 32}
TRAIN_PARITY_ARCHS = ("paper-overhead-100m", "qwen3-0.6b",
                      "granite-moe-1b-a400m", "rwkv6-7b", "deepseek-v2-236b",
                      "recurrentgemma-9b", "qwen2.5-32b",
                      "mistral-large-123b", "gemma2-9b", "internvl2-76b",
                      "seamless-m4t-medium")
# The train parity's CPU side runs in a second process (:class:`ParityWorker`)
# from right after the build, on PARITY_WORKER_CORES of the host's cores
# (its threads and its affinity), the smoke's own process on the others;
# the parity phase computes the card's side and compares.  Host-bound
# rates taken meanwhile say so (:func:`host_note`).
PARITY_WORKER_CORES = 4
PARITY_WORKER_WAIT_S = 900.0   # the most the parity phase waits for a result
# recurrentgemma-9b's (t6) depth: one (R, R, L) group, 1.70 B parameters
# with the tied 256,000 x 4,096 embedding (two groups, 2.36 B, fit too:
# 55.5 GB; one keeps the smoke inside its time limit); fp32 master
# weights and moments, two microbatches' fp32 gradients and a row's 4,096
# x 256,000 fp32 logits with their softmax and gradient
RG_TRAIN_LAYERS = 3
# The dense decoders of this slice, at full width cut in depth to fit the
# card's 70 GB (PEAK_MEM_LIMIT_GB).  Serving holds fp32 weights and their
# bf16 compute copy, 6 bytes a parameter: (f) qwen2.5-32b 488 M a layer
# (2.9 GB) and its untied 1.56 B embedding and head (9.3 GB); (g)
# mistral-large-123b 1.38 B a layer (8.3 GB) and 0.81 B (4.8 GB); (h)
# gemma2-9b 198 M a layer (1.2 GB), its tied 0.92 B (5.5 GB), and its
# caches at max_len 4,096: a global layer's pages 268 MB, a local layer's
# ring 268 MB.  Training holds fp32 master weights and moments, the fp32
# gradients (two of them with microbatches) and the bf16 copy, 18 to 22
# bytes a parameter, and a row's fp32 logits with their softmax and
# gradient: (t7) qwen2.5 at 2 layers, 2.53 B parameters; (t8)
# mistral-large at 2 layers, 3.57 B; (t9) gemma2 at 2 layers (one (local,
# global) pair; three, 2.11 B, fit too but cost the smoke's time), 1.31
# B, a row's 4,096 x 256,000 logits passing the final softcap (its tanh
# kept for the backward: about 21 GB at the backward's start).  gemma2
# serves 40 of its 42 layers: all 42 hold 55.5 GB of weights and 11.3 GB
# of caches, and a prefill round of 8 rows of 3,072 tokens adds about 3.5
# GB, past 70 GB
QWEN25_SERVE_LAYERS = 16
MISTRAL_SERVE_LAYERS = 7
GEMMA2_SERVE_LAYERS = 40
QWEN25_TRAIN_LAYERS = 2
MISTRAL_TRAIN_LAYERS = 2
GEMMA2_TRAIN_LAYERS = 2
# internvl2-76b (a Llama-3-70B-class GQA backbone, G 8, under the vision
# frontend stub): 855.65 M parameters a layer, an untied 1.05 B embedding
# and head.  (i) serves 10 of its 80 layers, 10.66 B parameters at 6 bytes
# a parameter (64 GB; (g)'s 10.49 B peaked at 65.35 GB).  (t10) trains 1
# layer: 2.96 B parameters at 18 bytes a parameter (fp32 master weights
# and moments, the fp32 gradient, the bf16 copy: 53 GB) and a row's fp32
# logits, softmax and gradient over 128,256 tokens (about 6 GB); at 2
# layers the state alone, 3.81 B x 18 bytes = 68.6 GB, would pass
# PEAK_MEM_LIMIT_GB
INTERNVL2_SERVE_LAYERS = 10
INTERNVL2_TRAIN_LAYERS = 1
# The frontend on the card, after (i): FRONTEND_ROWS rows, each the
# config's 256 seeded patch embeddings and a ragged prompt of up to
# FRONTEND_PROMPT tokens, one ragged prefill into a paged cache of 256 +
# 1,024 + 16 tokens a row, then FRONTEND_STEPS decode steps; its fp32
# cuda-vs-cpu parity at the cut depth and widths of FRONTEND_PARITY, on
# FRONTEND_PARITY_ROWS rows of prompts up to FRONTEND_PARITY_PROMPT (the
# CPU side's prefill: about 1.6 TFLOP)
FRONTEND_ROWS, FRONTEND_PROMPT, FRONTEND_STEPS = 8, 1024, 16
FRONTEND_PARITY = dict(num_layers=2, d_ff=4_096, vocab_size=16_384)
FRONTEND_PARITY_ROWS, FRONTEND_PARITY_PROMPT = 4, 128
# Phase 3b, lockstep serving: (k) qwen3-0.6b at full width and (l)
# deepseek-v2-236b at full width cut to 3 layers, bf16, 8 rows of 1,024
# prompt tokens, 32 and 16 generated; the fp32 parity of cuda dense, cuda
# paged and cpu dense at 4 rows of 256 tokens, 8 generated, (k) at 2
# layers and (l) at the deepseek parity's cut (2 layers, 8 experts, dense
# d_ff 1,536, vocabulary 16,384)
LOCKSTEP_K = dict(batch=8, prompt_len=1024, gen=32)
LOCKSTEP_L = dict(batch=8, prompt_len=1024, gen=16)
LOCKSTEP_PARITY = dict(batch=4, prompt_len=256, gen=8)
LOCKSTEP_PARITY_LAYERS = 2


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_ms_of(fn) -> float:
    """A plain version's time: one call, its ops already warm from the
    oracle call the check made just before.  The plain version repeats
    the kernel's arithmetic and is no yardstick of speed, so the smoke
    spends one call on it, not an average."""
    return time_ms(fn, reps=1, warmup=0)


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn()``: the summed durations of the
    kernels it launched, from torch.profiler, over ``reps`` calls.  Unlike
    :func:`time_ms` it leaves out host gaps, so a kernel whose wrapper
    costs more host time than the kernel takes on the card still gets its
    own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None   # None: nothing recorded


_flush = []


def cold_device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn()`` with the L2 cold: a 256 MB buffer
    (five times the 50 MB L2) is written before each call, and only the
    kernels ``fn`` launched are summed (the profiler's keys of the flush
    itself, taken from a run of it alone, are left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES // 4, device="cuda"))
    buf = _flush[0]
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        buf.fill_(1.0)
        torch.cuda.synchronize()
    flush_keys = {e.key for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            buf.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.key not in flush_keys)
    return us / 1e3 / reps if us > 0 else None   # None: nothing recorded


def fmt_ms(x) -> str:
    return "not recorded" if x is None else f"{x:.4f}"


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def compare(out, plain, tol, what: str) -> float:
    """Max |out - plain|; fails unless every element is within
    ``atol + rtol·|plain|`` (``atol`` a number or a tensor of the
    elements' own)."""
    atol, rtol = tol
    d = (out.float() - plain.float()).abs()
    over = (d > atol + rtol * plain.float().abs()).sum().item()
    err = d.max().item()
    worst = plain.float().flatten()[d.argmax()].item()
    text = tol_text(tol) if isinstance(atol, float) else "the tolerance"
    check(over == 0, f"{what}: {over} elements beyond {text} "
          f"(max |kernel - plain| {err}, at plain {worst})")
    return err


def tol_used(out, plain, tol) -> float:
    """max |out - plain| / (atol + rtol·|plain|) over the elements: below 1
    within the tolerance, above 1 beyond it."""
    atol, rtol = tol
    p = plain.float()
    return ((out.float() - p).abs()
            / (atol + rtol * p.abs())).max().item()


def bwd_tol(plain, dt):
    """The flash backward's (atol per element, rtol) for ``plain`` (B, S,
    heads, hd): FLASH_BWD_TOL's share of the largest |plain| of each
    element's tile of BWD_TILE positions of one batch row and head, plus
    BWD_NOISE."""
    import torch.nn.functional as F
    share, rtol = FLASH_BWD_TOL[dtype_name(dt)]
    B, S, n, hd = plain.shape
    pad = -S % BWD_TILE
    a = F.pad(plain.float().abs(), (0, 0, 0, 0, 0, pad))
    a = a.view(B, (S + pad) // BWD_TILE, BWD_TILE, n, hd)
    t = a.amax(dim=(2, 4), keepdim=True).expand_as(a)
    t = t.reshape(B, S + pad, n, hd)[:, :S]
    return share * t + BWD_NOISE, rtol


def tol_text(tol) -> str:
    atol, rtol = tol
    return f"{atol:g} + {rtol:g}·|plain|" if rtol else f"{atol:g}"


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def flash_cases():
    """(label, B, S, H, K, hd, hdv, dtype, causal, window, cap): hdv the
    v width, hd's but for deepseek-v2's training attention
    (:func:`mla_train_cases`)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, K, hd, dtype, causal, window, cap)
    square = [
        ("qwen3 S512", 4, 512, 16, 8, 128, bf16, True, 0, 0.0),
        ("qwen3 S1024", 4, 1024, 16, 8, 128, bf16, True, 0, 0.0),
        ("paper G3 hd64 S512", 4, 512, 12, 4, 64, bf16, True, 0, 0.0),
        ("paper hd64 S1024", 4, 1024, 12, 4, 64, bf16, True, 0, 0.0),
        # paper-overhead-100m's training shape (the train phase's forward)
        ("paper train B8 S1024", 8, 1024, 12, 4, 64, bf16, True, 0, 0.0),
        # granite-moe-1b-a400m's training shape ((t3): G 2, hd 64, S 4,096)
        ("granite train B4 S4096", 4, 4096, 16, 8, 64, bf16, True, 0, 0.0),
        ("qwen3 ragged S1000", 2, 1000, 16, 8, 128, bf16, True, 0, 0.0),
        ("window 256 softcap 30", 2, 640, 16, 8, 128, bf16, True, 256, 30.0),
        ("fp32 window 100 cap 20", 2, 384, 12, 4, 64, f32, True, 100, 20.0),
        ("fp32 qwen3 S256", 2, 256, 16, 8, 128, f32, True, 0, 0.0),
        # recurrentgemma's local layers: MQA (G 16), hd 256, window 2,048
        ("rg hd256 S2560 w2048", 8, 2560, 16, 1, 256, bf16, True, 2048, 0.0),
        ("rg hd256 ragged S2501", 8, 2501, 16, 1, 256, bf16, True, 2048,
         0.0),
        ("fp32 rg hd256 S2560", 8, 2560, 16, 1, 256, f32, True, 2048, 0.0),
        # recurrentgemma's training shape ((t6): B 1, S 4,096)
        (RG_FWD_T6, 1, 4096, 16, 1, 256, bf16, True, 2048, 0.0),
        # one q tile and one row past it (the bf16 kernel's 128-row tiles)
        ("edge hd64 S129", 2, 129, 12, 4, 64, bf16, True, 0, 0.0),
        ("edge hd128 S129", 2, 129, 16, 8, 128, bf16, True, 0, 0.0),
        ("edge hd256 S129", 2, 129, 16, 1, 256, bf16, True, 2048, 0.0),
        # the dense decoders' training shapes ((t7), (t8): a row of 4,096,
        # qwen2.5's G 5, mistral-large's G 12, hd 128), bf16 and fp32,
        # each ragged too
        (QWEN25_T7, 1, 4096, 40, 8, 128, bf16, True, 0, 0.0),
        ("fp32 qwen2.5 (t7)", 1, 4096, 40, 8, 128, f32, True, 0, 0.0),
        ("qwen2.5 ragged S1000", 2, 1000, 40, 8, 128, bf16, True, 0, 0.0),
        (MISTRAL_T8, 1, 4096, 96, 8, 128, bf16, True, 0, 0.0),
        ("fp32 mistral (t8)", 1, 4096, 96, 8, 128, f32, True, 0, 0.0),
        ("mistral ragged S2049", 1, 2049, 96, 8, 128, bf16, True, 0, 0.0),
        # gemma2's local and global layers at (t9)'s shape (G 2, hd 256,
        # the softcap 50 at the scale 1/16 of its query_pre_attn_scalar)
        # and at (h)'s prefill rounds (8 rows up to 3,072)
        (GEMMA2_FWD_T9, 1, 4096, 16, 8, 256, bf16, True, 4096, 50.0),
        ("gemma2 global (t9)", 1, 4096, 16, 8, 256, bf16, True, 0, 50.0),
        (GEMMA2_FWD_H, 8, 3072, 16, 8, 256, bf16, True, 4096, 50.0),
        # internvl2-76b's G 8 (H 64 over K 8, hd 128): its training row
        # ((t10)), bf16 and fp32, ragged, and the frontend phase's prefill
        # (8 rows of 256 patch embeddings and up to 1,024 tokens)
    ] + internvl2_cases() + [
        (INTERNVL2_FRONTEND, 8, 1280, 64, 8, 128, bf16, True, 0, 0.0),
    ]
    return [c[:6] + (c[5],) + c[6:] for c in square] + mla_train_cases()


QWEN25_T7 = "qwen2.5 train (t7)"
MISTRAL_T8 = "mistral train (t8)"
INTERNVL2_T10 = "internvl2 train (t10)"
INTERNVL2_FRONTEND = "internvl2 frontend B8 S1280"


def internvl2_cases():
    """internvl2-76b's training row ((t10): B 1, S 4,096, H 64, K 8, hd
    128, causal), bf16 and fp32, and ragged (B 2, S 1,000): the same
    cases for the flash forward and its backward, (label, B, S, H, K, hd,
    dtype, causal, window, cap)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    return [(INTERNVL2_T10, 1, 4096, 64, 8, 128, bf16, True, 0, 0.0),
            ("fp32 internvl2 (t10)", 1, 4096, 64, 8, 128, f32, True, 0, 0.0),
            ("internvl2 ragged S1000", 2, 1000, 64, 8, 128, bf16, True, 0,
             0.0)]
GEMMA2_FWD_T9 = "gemma2 local (t9)"
GEMMA2_FWD_H = "gemma2 serving (h)"


MLA_T5 = "mla t5 B2 S4096"
RG_FWD_T6 = "rg train (t6) S4096 w2048"


def mla_train_cases():
    """deepseek-v2's training attention, (t5)'s shape: B 2, S 4,096, 128
    heads (K = H: the latent is expanded per head), q and k 192 wide (128
    nope + 64 rope) over v 128, causal; bf16 and fp32, ragged S 1,000, 77
    and 1.  The same cases for the forward and the backward."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    return [(MLA_T5, 2, 4096, 128, 128, 192, 128, bf16, True, 0, 0.0),
            ("fp32 mla t5", 2, 4096, 128, 128, 192, 128, f32, True, 0, 0.0),
            ("mla ragged S1000", 2, 1000, 128, 128, 192, 128, bf16, True, 0,
             0.0),
            ("mla ragged S77", 2, 77, 128, 128, 192, 128, bf16, True, 0,
             0.0),
            ("mla S1", 2, 1, 128, 128, 192, 128, bf16, True, 0, 0.0)]


def timing_reps(dt, rows) -> int:
    """Calls a flash timing averages: 20, but 3 in fp32 past 2^18 (batch,
    row, head) rows, where a CUDA-core walk takes 0.1 s (forward) to 0.5 s
    (backward) a call at (t5)'s shape (1 M rows; (t8)'s 393 K)."""
    import torch
    return 3 if dt == torch.float32 and rows > 2 ** 18 else 20


def flash_work(B, S, H, K, hd, elt, causal, window, hdv=0):
    """(flops, bytes) the function needs: live (q, k) pairs times 2·(hd +
    hdv) (4·hd at equal widths), and q, k, v read once, o written once
    (q, k hd wide; v, o hdv)."""
    hdv = hdv or hd
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        pairs += hi - lo
    flops = 2.0 * (hd + hdv) * B * H * pairs
    nbytes = (B * S * H * (hd + hdv) + B * S * K * (hd + hdv)) * elt
    return flops, nbytes


def sdpa_forward_ms(q, k, v, causal, reps=20):
    """One PyTorch call at the same shape, as a yardstick:
    ``F.scaled_dot_product_attention`` trying the flash, memory-efficient,
    cuDNN and math backends in turn.  Returns (ms, the backend that ran),
    or (None, "none: ...") if none takes these head dims."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    tried = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=q.shape[3] ** -0.5),
                    reps=reps)
            return ms, backend.name
        except RuntimeError as e:
            tried.append(f"{backend.name}: {str(e).splitlines()[0][:60]}")
        finally:
            torch.cuda.synchronize()
    return None, "none: " + "; ".join(tried)


def run_flash_phase(dev, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rows = []
    for label, B, S, H, K, hd, hdv, dt, causal, window, cap in flash_cases():
        q = torch.randn(B, S, H, hd, device=dev, generator=gen).to(dt)
        k = torch.randn(B, S, K, hd, device=dev, generator=gen).to(dt)
        v = torch.randn(B, S, K, hdv, device=dev, generator=gen).to(dt)
        kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                  logit_cap=cap)
        out = ops.flash_attention_bshd(q, k, v, **kw)
        plain, plain_lse = fa.flash_attention_torch(q, k, v, return_lse=True,
                                                    **kw)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype_name(dt)]
        if hd == 256 and dt == torch.bfloat16:
            tol = (FLASH_HD256_VSCALE * v.float().abs().max().item(),
                   2 ** -7)
        check(bool(torch.isfinite(out).all()), f"flash {label}: non-finite")
        err = compare(out, plain, tol, f"flash {label}")
        used = tol_used(out, plain, tol)
        lse_err = None
        if hdv != hd:
            # the training forward's log-sum-exp, and its output equal to
            # the serving call's
            out_t, lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                 **kw)
            torch.cuda.synchronize()
            check(torch.equal(out_t, out), f"flash {label}: the output with "
                  "the lse differs from the one without")
            lse_err = (lse - plain_lse).abs().max().item()
            check(lse_err <= LSE_TOL * max(1.0, plain_lse.abs().max().item()),
                  f"flash lse {label}: max |kernel - plain| {lse_err}")
            del out_t, lse
        del plain_lse
        reps = timing_reps(dt, B * S * H)
        ms = time_ms(lambda: ops.flash_attention_bshd(q, k, v, **kw),
                     reps=reps)
        dev_ms = device_ms(lambda: ops.flash_attention_bshd(q, k, v, **kw),
                           reps=reps)
        plain_ms = plain_ms_of(lambda: fa.flash_attention_torch(q, k, v,
                                                                **kw))
        lib_ms, lib = None, None
        if hdv != hd:
            lib_ms, lib = sdpa_forward_ms(q, k, v, causal, reps=reps)
        elif not cap:
            # SDPA on the same inputs; a window goes in as a boolean
            # causal-window mask (True = attend)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = None
            if window:
                i = torch.arange(S, device=dev)
                mask = (i[None, :] <= i[:, None]) \
                    & (i[:, None] - i[None, :] < window)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
                scale=hd ** -0.5, enable_gqa=True))
            del qt, kt, vt, mask
        flops, nbytes = flash_work(B, S, H, K, hd, q.element_size(), causal,
                                   window, hdv)
        t_ops = flops / PEAK_FLOPS[dtype_name(dt)]
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        # achieved rate and share of the bound, from the device time
        k_ms = dev_ms if dev_ms is not None else ms
        rows.append(dict(label=label, dtype=dtype_name(dt), max_abs_err=err,
                         tol=tol_text(tol), tol_used=used, ms=ms,
                         device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, lse_err=lse_err, library=lib,
                         shape=f"B {B}, S {S}, H {H}, K {K}, hd {hd}"
                         + (f", hdv {hdv}" if hdv != hd else "")
                         + f", {dtype_name(dt)}"
                         + (", causal" if causal else "")
                         + (f", window {window}" if window else ""),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes",
                         tflops=flops / (k_ms * 1e-3) / 1e12,
                         bound_share=bound_ms / k_ms))
        rate = (f", {rows[-1]['tflops']:.0f} TFLOP/s, {bound_ms / k_ms:.1%} "
                f"of bound" if dt == torch.bfloat16 else "")
        print(f"  flash {label:<24} {dtype_name(dt):<8} err {err:.3g} "
              f"(tol {tol_text(tol)}; {used:.3f} of it) kernel {ms:.4f} ms "
              f"(device "
              f"{fmt_ms(dev_ms)}{rate}) "
              f"plain {plain_ms:.4f} ms "
              f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms "
              + (f"({lib}) " if lib else "")
              + ("" if lse_err is None else f"lse {lse_err:.3g} ")
              + f"bound {bound_ms:.4f} ms", flush=True)
        del q, k, v, out, plain
        torch.cuda.empty_cache()
    return rows


def decode_inputs(dev, gen, B, K, G, hd, ps, pps, dt, positions, qdt=None):
    """A ragged paged batch: each active row owns the pages its position
    needs (shuffled physical ids), rows 0 and 1 alias their first page, one
    row has a -1 hole inside its live prefix, and ``positions`` may hold
    -1 (inactive slot, table all -1).  q is in ``qdt`` (default: the
    pools' ``dt``)."""
    import torch
    P = B * pps
    q = torch.randn(B, K, G, hd, device=dev, generator=gen).to(qdt or dt)
    kp = torch.randn(P, K, ps, hd, device=dev, generator=gen).to(dt)
    vp = torch.randn(P, K, ps, hd, device=dev, generator=gen).to(dt)
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, pps), -1, dtype=torch.int32, device=dev)
    for b, p in enumerate(positions):
        if p >= 0:
            n = p // ps + 1
            table[b, :n] = perm[b * pps:b * pps + n]
    if B > 1 and positions[0] >= 0 and positions[1] >= 0:
        table[1, 0] = table[0, 0]                       # aliased prefix page
    holed = [b for b, p in enumerate(positions) if p >= 2 * ps]
    if holed:
        table[holed[-1], 1] = -1                        # hole mid-prefix
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, kp, vp, table, pos


def decode_live_keys(table, pos, ps):
    """(keys the function must read, (row, key) pairs it must score).  A
    key is a slot t <= pos of an allocated page.  A physical page that
    several rows map (an aliased prefix) is read once: its live slots are
    those that any of these rows reaches."""
    live = {}                      # physical page -> its live slots 0..n-1
    pairs = 0
    for row, p in zip(table.tolist(), pos.tolist()):
        for i in range(p // ps + 1 if p >= 0 else 0):
            if row[i] >= 0:
                n = min(ps, p - i * ps + 1)
                pairs += n
                live[row[i]] = max(live.get(row[i], 0), n)
    return sum(live.values()), pairs


def decode_cases():
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    # qwen3 serve shape: 8 slots, prompts up to 1024 + 32 generated tokens
    qwen_pos = [1055, 700, 1023, -1, 512, 127, 128, 900]
    long_pos = [8191, 5000, 8000, -1, 3000, 127, 2048, 6500]
    # the frontend phase's last decode step: 256 + a prompt + 15
    frontend_pos = [1294, 1100, 783, 1290, 900, 1037, 655, 1201]
    # (label, B, K, G, hd, ps, pps, q dtype, pool dtype, positions)
    return [
        ("qwen3 G2", 8, 8, 2, 128, 128, 9, bf16, bf16, qwen_pos),
        ("paper G3 hd64", 8, 4, 3, 64, 128, 9, bf16, bf16, qwen_pos),
        ("G4", 4, 2, 4, 128, 128, 9, bf16, bf16, [1000, 300, -1, 129]),
        ("G5", 4, 2, 5, 128, 128, 9, bf16, bf16, [1000, 300, -1, 129]),
        ("G8", 4, 2, 8, 128, 128, 9, bf16, bf16, [1000, 300, -1, 129]),
        ("fp32 qwen3 G2", 8, 8, 2, 128, 128, 9, f32, f32, qwen_pos),
        ("fp32 G3 ps16", 4, 2, 3, 64, 16, 12, f32, f32, [150, 31, -1, 47]),
        # gemma2-9b's global layers, mistral-large's group, MQA at hd 256;
        # each in bf16 and as fp32 q over bf16 pools
        ("gemma2 K8 G2 hd256", 8, 8, 2, 256, 128, 9, bf16, bf16, qwen_pos),
        ("gemma2 fp32 q", 8, 8, 2, 256, 128, 9, f32, bf16, qwen_pos),
        ("mistral K8 G12", 8, 8, 12, 128, 128, 9, bf16, bf16, qwen_pos),
        ("mistral fp32 q", 8, 8, 12, 128, 128, 9, f32, bf16, qwen_pos),
        ("MQA K1 G16 hd256", 8, 1, 16, 256, 128, 9, bf16, bf16, qwen_pos),
        ("MQA fp32 q", 8, 1, 16, 256, 128, 9, f32, bf16, qwen_pos),
        # long tables (rows up to 8K and 20K keys): several tiles a range,
        # so the ring's stages are reused; B 1 merges 320 ranges in rounds
        ("long B8 pps64", 8, 8, 2, 128, 128, 64, bf16, bf16, long_pos),
        ("long fp32 B8 pps64", 8, 8, 2, 128, 128, 64, f32, f32, long_pos),
        ("long B1 pps160", 1, 8, 2, 128, 128, 160, bf16, bf16, [20000]),
        # internvl2-76b's group (K 8, G 8, hd 128: the first config on
        # group_tile's boundary, a kv head a block): the frontend phase's
        # table (256 + 1,024 + 16 tokens a row) and a long one, bf16 and
        # fp32 q over bf16 pools
        (INTERNVL2_G8, 8, 8, 8, 128, 128, 11, bf16, bf16, frontend_pos),
        ("long B8 pps64 G8", 8, 8, 8, 128, 128, 64, bf16, bf16, long_pos),
        ("long fp32 q G8", 8, 8, 8, 128, 128, 64, f32, bf16, long_pos),
    ]


INTERNVL2_G8 = "internvl2 K8 G8"


def run_decode_phase(dev, gen):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    rows = []
    for label, B, K, G, hd, ps, pps, qdt, dt, positions in decode_cases():
        q, kp, vp, table, pos = decode_inputs(dev, gen, B, K, G, hd, ps,
                                              pps, dt, positions, qdt)
        qm = q.reshape(B, 1, K * G, hd)
        kw = dict(scale=hd ** -0.5, logit_cap=0.0)
        plain = pa.paged_decode_torch(q, kp, vp, table, pos, **kw)
        tol = DECODE_TOL[dtype_name(qdt)]
        errs, outs = [], []
        for grouped in (True, False):
            out = ops.paged_decode_bhd(qm, kp, vp, table, pos, grouped=grouped,
                                       **kw).reshape(B, K, G, hd)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"decode {label}: "
                  "non-finite")
            inactive = pos < 0
            check(bool((out[inactive] == 0).all()),
                  f"decode {label} grouped={grouped}: inactive row not zero")
            errs.append(compare(out, plain, tol,
                                f"decode {label} grouped={grouped}"))
            outs.append(out)
        check(torch.equal(outs[0], outs[1]),
              f"decode {label}: the grouped and per-head grids differ")
        if label.startswith("long"):
            plans = [pa.decode_plan(B, K, G, hd, ps, pps, kp.element_size(),
                                    _build.sm_count(q.device), g)
                     for g in (True, False)]
            check(plans[0]["tps"] > 1
                  and max(p["stages"] for p in plans) >= 2,
                  f"decode {label}: plans {plans} walk one tile a range")
        capped = ops.paged_decode_bhd(qm, kp, vp, table, pos, scale=hd ** -0.5,
                                      logit_cap=30.0).reshape(B, K, G, hd)
        plain_c = pa.paged_decode_torch(q, kp, vp, table, pos,
                                        scale=hd ** -0.5, logit_cap=30.0)
        torch.cuda.synchronize()
        err = max(errs + [compare(capped, plain_c, tol,
                                  f"decode {label} softcap")])
        ms = time_ms(lambda: ops.paged_decode_bhd(qm, kp, vp, table, pos,
                                                  **kw))
        dev_ms = device_ms(lambda: ops.paged_decode_bhd(qm, kp, vp, table,
                                                        pos, **kw))
        ms_ung = time_ms(lambda: ops.paged_decode_bhd(
            qm, kp, vp, table, pos, grouped=False, **kw))
        dev_ung = device_ms(lambda: ops.paged_decode_bhd(
            qm, kp, vp, table, pos, grouped=False, **kw))
        plain_ms = plain_ms_of(lambda: pa.paged_decode_torch(
            q, kp, vp, table, pos, **kw))
        cold_ms = cold_device_ms(lambda: ops.paged_decode_bhd(
            qm, kp, vp, table, pos, **kw)) if label == "qwen3 G2" else None
        keys, pairs = decode_live_keys(table, pos, ps)
        elt = kp.element_size()
        nbytes = keys * K * hd * 2 * elt + 2 * q.numel() * q.element_size() \
            + table.numel() * 4 + pos.numel() * 4
        flops = 4.0 * pairs * K * G * hd
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype_name(qdt)]
        dtypes = dtype_name(qdt) if qdt == dt \
            else f"q {dtype_name(qdt)}, pools {dtype_name(dt)}"
        rows.append(dict(label=label, dtype=dtypes, max_abs_err=err,
                         tol=tol_text(tol), ms=ms, device_ms=dev_ms,
                         ms_ungrouped=ms_ung, device_ms_ungrouped=dev_ung,
                         cold_ms=cold_ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", live_keys=keys, scored=pairs))
        cold = "" if cold_ms is None else f", L2-cold {cold_ms:.4f}"
        print(f"  decode {label:<18} {dtypes:<8} err {err:.3g} "
              f"(tol {tol_text(tol)}) kernel {ms:.4f} ms (device "
              f"{fmt_ms(dev_ms)}{cold}; ungrouped {ms_ung:.4f}, device "
              f"{fmt_ms(dev_ung)}) plain {plain_ms:.4f} ms bound "
              f"{rows[-1]['bound_ms']:.4f} ms ({keys} distinct live keys "
              f"read, {pairs} row-key pairs scored)", flush=True)
    return rows


def wkv_cases():
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, N, dtype, nonzero s0, padded row 0 from step,
    #  decays: None = -exp(U(-6, 2)), a constant lw, or "strong" =
    #  -exp(U(-6, 4)), down to -e^4 a step)
    return [
        ("rwkv6-7b serving", 8, 1024, 64, 64, bf16, False, None, None),
        ("fp32 serving", 8, 1024, 64, 64, f32, False, None, None),
        ("ragged S1000 s0 padded", 2, 1000, 64, 64, bf16, True, 700, None),
        ("fp32 ragged S77 s0 padded", 2, 77, 8, 64, f32, True, 41, None),
        ("fp32 N32 S100", 2, 100, 4, 32, f32, True, 60, None),
        ("N16 S40", 2, 40, 4, 16, bf16, True, 25, None),
        ("lw -3", 2, 300, 8, 64, bf16, True, None, -3.0),
        ("fp32 lw -8", 2, 300, 8, 64, f32, True, None, -8.0),
        ("lw to -e^4 padded", 2, 300, 8, 64, bf16, True, 150, "strong"),
        # S within and just past one chunk of 8 (the kernel's TMA box)
        ("fp32 S1", 1, 1, 4, 64, f32, True, None, None),
        ("S5 padded", 2, 5, 8, 64, bf16, True, 3, None),
        ("S9 padded", 2, 9, 8, 64, bf16, True, 8, None),
    ]


def wkv_inputs(dev, gen, B, S, H, N, dt, nonzero_s0, pad_from, decay=None):
    """r/k/v ~ N(0,1) in ``dt``; lw = -exp(U(-6, 2)), decays from -e^-6 to
    -e^2 (the model's initial decays sit near -e^-6), or the constant
    ``decay``, or with ``decay="strong"`` -exp(U(-6, 4)); u ~ 0.5·N(0,1);
    s0 zero (a prefill) or 0.3·N(0,1); row 0 padded from ``pad_from`` on
    (k = 0, lw = 0), as the ragged prefill pads."""
    import torch
    r, k, v = (torch.randn(B, S, H, N, device=dev, generator=gen).to(dt)
               for _ in range(3))
    span = 10 if decay == "strong" else 8
    lw = -torch.exp(torch.rand(B, S, H, N, device=dev, generator=gen) * span
                    - 6)
    if isinstance(decay, float):
        lw = torch.full_like(lw, decay)
    u = 0.5 * torch.randn(H, N, device=dev, generator=gen)
    s0 = 0.3 * torch.randn(B, H, N, N, device=dev, generator=gen) \
        if nonzero_s0 else torch.zeros(B, H, N, N, device=dev)
    if pad_from is not None:
        k[0, pad_from:] = 0
        lw[0, pad_from:] = 0
    return r, k, v, lw, u, s0


WKV_CHUNK = 8   # the kernel's chunk of steps (csrc/rwkv6_wkv.cu: L)


def wkv_work(B, S, H, N, elt):
    """The least time (ms) the card could take for WKV6 and what bounds
    it, as a dict.  Bytes: r, k, v and o in the compute dtype, lw, u, s0
    and s_fin in fp32, each read or written once, over 3.35 TB/s.
    Operations, in the chunked form of chunk L = 8 the kernel computes,
    per step and head: on the tensor cores at the TF32 rate (494.7
    TFLOP/s) the read-out (r ⊙ Pex)·S, 2N², the update (k ⊙ Psuf)ᵀ·V,
    2N², and the intra-chunk A·V, 2LN, each counted once (the split-TF32
    extra products are the kernel's cost, not the function's); at the fp32
    rate (67 TFLOP/s) the chunk's decay-and-add of the state, 2N²/L, the
    intra-chunk pairs, (L - 1)N, and exp, the two decay walks and the
    bonus, 10N.  Bound = max(bytes, tensor + fp32 operations).  Also the
    per-step recurrence's count at the fp32 rate, B·H·S·(5N² + 5N)
    (0.1628 ms at the serving shape), the bound stated for the earlier
    per-step kernel."""
    L = WKV_CHUNK
    steps = B * H * S
    tc = steps * (4.0 * N * N + 2.0 * L * N)
    simt = steps * (2.0 * N * N / L + (L - 1.0) * N + 10.0 * N)
    nbytes = B * S * H * N * (4 * elt + 4) + H * N * 4 + 2 * B * H * N * N * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tc / PEAK_FLOPS["tfloat32"] + simt / PEAK_FLOPS["float32"]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, tensor_flops=tc, fp32_flops=simt,
                recurrence_bound_ms=steps * (5.0 * N * N + 5.0 * N)
                / PEAK_FLOPS["float32"] * 1e3)


def wkv_check(out, plain, scale, dt, what):
    """Element-wise: |kernel - plain| <= scale·max|plain| + rtol·|plain|."""
    atol = scale * plain.float().abs().max().item()
    return compare(out, plain, (atol, WKV_RTOL[dtype_name(dt)]), what)


def run_wkv_phase(dev, gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv

    rows = []
    for label, B, S, H, N, dt, nz, pad_from, decay in wkv_cases():
        r, k, v, lw, u, s0 = wkv_inputs(dev, gen, B, S, H, N, dt, nz,
                                        pad_from, decay)
        o, s_fin = ops.wkv6_bshn(r, k, v, lw, u, s0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o).all() and torch.isfinite(s_fin).all()),
              f"wkv6 {label}: non-finite")
        po, ps = wkv.wkv6_torch(r, k, v, lw, u, s0)
        fold = lambda t: t.transpose(1, 2).reshape(B * H, S, N)  # noqa: E731
        ro, rs = ref.wkv6_ref(fold(r), fold(k), fold(v), fold(lw),
                              u[None].expand(B, H, N).reshape(B * H, 1, N),
                              s0.reshape(B * H, N, N))
        ro = ro.reshape(B, H, S, N).transpose(1, 2)
        rs = rs.reshape(B, H, N, N)
        err = wkv_check(o, po, WKV_SCALE["chunked"], dt, f"wkv6 {label} o")
        s_err = wkv_check(s_fin, ps, WKV_SCALE["chunked"], torch.float32,
                          f"wkv6 {label} s_fin")
        o_err = wkv_check(o, ro, WKV_SCALE["oracle"], dt,
                          f"wkv6 {label} o vs oracle")
        so_err = wkv_check(s_fin, rs, WKV_SCALE["oracle"], torch.float32,
                           f"wkv6 {label} s_fin vs oracle")
        if pad_from is not None:
            cut = [t[:1, :pad_from].contiguous() for t in (r, k, v, lw)]
            _, s_cut = ops.wkv6_bshn(*cut, u, s0[:1].contiguous())
            torch.cuda.synchronize()
            check(torch.equal(s_fin[0], s_cut[0]),
                  f"wkv6 {label}: padding steps changed the state")
        row = dict(label=label, dtype=dtype_name(dt), max_abs_err=err,
                   s_fin_err=s_err, oracle_err=o_err, oracle_s_fin_err=so_err,
                   max_abs_plain=po.float().abs().max().item(),
                   tol=f"{WKV_SCALE['chunked']:g}·max|plain| + "
                   f"{WKV_RTOL[dtype_name(dt)]:g}·|plain| (oracle "
                   f"{WKV_SCALE['oracle']:g}·max)")
        timing = ""
        if S >= 1000 and pad_from is None:
            call = lambda: ops.wkv6_bshn(r, k, v, lw, u, s0)  # noqa: E731
            row.update(ms=time_ms(call), device_ms=device_ms(call),
                       cold_ms=cold_device_ms(call),
                       plain_ms=plain_ms_of(lambda: wkv.wkv6_torch(
                           r, k, v, lw, u, s0)),
                       library_ms=None,
                       **wkv_work(B, S, H, N, r.element_size()),
                       shape=f"B {B}, S {S}, H {H}, N {N}, {dtype_name(dt)}")
            timing = (f" kernel {row['ms']:.4f} ms (device "
                      f"{fmt_ms(row['device_ms'])}, L2-cold "
                      f"{fmt_ms(row['cold_ms'])}) plain "
                      f"{row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']}; the per-step recurrence's "
                      f"fp32 count {row['recurrence_bound_ms']:.4f} ms)")
        rows.append(row)
        print(f"  wkv6 {label:<26} {dtype_name(dt):<8} err o {err:.3g} "
              f"s_fin {s_err:.3g}, vs oracle {o_err:.3g} / {so_err:.3g} "
              f"(max |o| {row['max_abs_plain']:.4g}; tol {row['tol']})"
              f"{timing}", flush=True)
    return rows


def wkv_bwd_cases():
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, N, dtype, nonzero s0 and ds_fin, decays as in
    #  wkv_cases, timed)
    return [
        ("rwkv6-7b train (t4)", 2, 4096, 64, 64, bf16, False, None, True),
        ("fp32 (t4)", 2, 4096, 64, 64, f32, False, None, True),
        ("ragged S1000 s0 ds_fin", 2, 1000, 64, 64, bf16, True, None, False),
        ("fp32 ragged S77 s0 ds_fin", 2, 77, 8, 64, f32, True, None, False),
        ("fp32 N32 S100", 2, 100, 4, 32, f32, True, None, False),
        ("N32 S130", 2, 130, 4, 32, bf16, True, None, False),
        ("N16 S40", 2, 40, 4, 16, bf16, True, None, False),
        ("lw to -e^4", 2, 300, 8, 64, bf16, True, "strong", False),
        ("fp32 lw -8", 2, 300, 8, 64, f32, True, -8.0, False),
        ("fp32 lw -3", 2, 300, 8, 64, f32, True, -3.0, False),
        # a segment (wkv.SEG, 64 steps) and one step past it; one short
        # of a segment
        ("S65", 2, 65, 8, 64, bf16, True, None, False),
        ("S63", 2, 63, 8, 64, bf16, True, None, False),
        ("fp32 S1", 1, 1, 4, 64, f32, True, None, False),
    ]


def wkv_bwd_work(B, S, H, N, elt):
    """The least time (ms) the card could take for WKV6's gradient and
    what bounds it, as a dict.  Bytes: r, k, v, dO read and dr, dk, dv
    written in the compute dtype, lw read and dlw written in fp32, u and
    du, s0, ds_fin and ds0 in fp32, each once, over 3.35 TB/s.
    Operations, per step and head in a chunked form of chunk L = 8 (as
    wkv_work counts the forward): on the tensor cores at the TF32 rate
    the state's products for dr (S·dO), dk (dS·v) and dv (dSᵀ·k) and the
    chunk's update of dS ((r ⊙ Pex)ᵀ·dO), 8N², and their intra-chunk
    terms, 6LN; at the fp32 rate the chunk's decay-and-add of dS and the
    state term of dlw, 4N²/L, and the decay walks, bonus and cumulative
    sums, 20N.  Bound = max(bytes, tensor + fp32 operations).  Also the
    step recurrence's fp32 count, B·H·S·14N² (what PR 22's kernel
    computed), and what the two-pass kernel moves (``moved_bytes``, see
    wkv_bwd_moved)."""
    L = WKV_CHUNK
    steps = B * H * S
    tc = steps * (8.0 * N * N + 6.0 * L * N)
    simt = steps * (4.0 * N * N / L + 20.0 * N)
    nbytes = B * S * H * N * (7 * elt + 8) + 2 * H * N * 4 \
        + 3 * B * H * N * N * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tc / PEAK_FLOPS["tfloat32"] + simt / PEAK_FLOPS["float32"]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, tensor_flops=tc, fp32_flops=simt,
                recurrence_ms=steps * 14.0 * N * N / PEAK_FLOPS["float32"]
                * 1e3, moved_bytes=wkv_bwd_moved(B, S, H, N, elt))


def wkv_bwd_moved(B, S, H, N, elt):
    """The bytes the backward kernel (csrc/rwkv6_wkv_bwd.cu) moves, by
    part: pass 1 reads r, lw and dO and writes dS at every segment's end
    (``dsb``, the checkpoints' size) and ds0; pass 2 reads r, k, v, dO,
    lw, the checkpoints and dsb and writes dr, dk, dv, dlw and du's
    partials per (b, h, segment).  Not the bound: the function needs
    none of the checkpoints, dsb or the second reads."""
    from repro_torch.kernels import rwkv6_wkv as wkv
    seq = B * S * H * N
    states = B * H * -(-S // wkv.SEG) * N * N * 4
    return dict(pass1_inputs=seq * (2 * elt + 4),
                pass2_inputs=seq * (4 * elt + 4),
                outputs=seq * (3 * elt + 4),
                checkpoints=states, dsb_written=states, dsb_read=states,
                du_partials=B * H * -(-S // wkv.SEG) * N * 4,
                states=3 * B * H * N * N * 4)


def wkv_bwd_tol(plain, dt, du_terms):
    """The WKV6 backward's (atol per element, rtol) for each of (dr, dk,
    dv, dlw, du, ds0): WKV_BWD_TOL's share of the largest |plain| of the
    element's tile (see WKV_BWD_TOL) plus WKV_BWD_NOISE, and for du also
    ``wkv_du_rounding(N)`` times ``du_terms`` (``wkv_du_terms`` of the
    inputs); rtol only for the outputs in ``dt``."""
    import torch.nn.functional as F
    share, rtol = WKV_BWD_TOL[dtype_name(dt)]
    out = []
    for i, p in enumerate(plain):
        a = p.float().abs()
        if i < 4:                                   # (B, S, H, N) by steps
            B, S, H, N = a.shape
            pad = -S % BWD_TILE
            t = F.pad(a, (0, 0, 0, 0, 0, pad)).view(
                B, (S + pad) // BWD_TILE, BWD_TILE, H, N)
            t = t.amax(dim=(2, 4), keepdim=True).expand_as(t)
            t = t.reshape(B, S + pad, H, N)[:, :S]
        else:                                       # du (H, N), ds0 per (b, h)
            t = a.amax(dim=(-2, -1) if i == 5 else -1,
                       keepdim=True).expand_as(a)
        atol = share * t + WKV_BWD_NOISE
        if i == 4:
            atol = atol + wkv_du_rounding(a.shape[-1]) * du_terms
        out.append((atol, rtol if i < 3 else 0.0))
    return out


def wkv_bwd_faults(r, k, v, lw, u, ck, do, dsf):
    """The backward kernel's gradients with a fault planted through its
    inputs, for the tolerance to reject: (what, gradients, the indices of
    the outputs a kernel with that fault would get wrong)."""
    from repro_torch.kernels import ops
    S = r.shape[1]
    out = []
    d = do.clone()
    d[:, S // 2] = 0
    wrong = ops.wkv6_bwd(r, k, v, lw, u, ck, d, dsf)
    out.append((f"dO of step {S // 2} dropped", wrong, (0, 2)))
    out.append((f"dO of step {S // 2} dropped, du", wrong, (4,)))
    c = ck.clone()
    c[:, :, -1] = 0
    if bool(ck[:, :, -1].any()):
        out.append(("the last checkpoint zeroed",
                    ops.wkv6_bwd(r, k, v, lw, u, c, do, dsf), (0, 3)))
    if dsf is not None:
        out.append(("ds_fin dropped", ops.wkv6_bwd(r, k, v, lw, u, ck, do,
                                                   None), (1, 2, 5)))
    return out


def run_wkv_bwd_phase(dev, gen):
    """The WKV6 backward kernel against its plain version on the same
    inputs and checkpoints (from the forward kernel, which must give the
    same o and s_fin with and without them, and checkpoints within
    WKV_SCALE of the plain forward's); two calls bit-equal; planted faults
    at least WKV_BWD_FAULT times over the tolerance; kernel, device and
    plain ms at the timed shapes beside the bound, and the forward's cost
    of writing the checkpoints."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv

    names = ("dr", "dk", "dv", "dlw", "du", "ds0")
    rows = []
    for label, B, S, H, N, dt, nz, decay, timed in wkv_bwd_cases():
        r, k, v, lw, u, s0 = wkv_inputs(dev, gen, B, S, H, N, dt, nz, None,
                                        decay)
        do = torch.randn(B, S, H, N, device=dev, generator=gen).to(dt)
        dsf = 0.3 * torch.randn(B, H, N, N, device=dev, generator=gen) \
            if nz else None
        o, s_fin = wkv.wkv6_cuda(r, k, v, lw, u, s0)
        o_c, s_fin_c, ck = wkv.wkv6_cuda(r, k, v, lw, u, s0, seg=wkv.SEG)
        torch.cuda.synchronize()
        check(torch.equal(o, o_c) and torch.equal(s_fin, s_fin_c),
              f"wkv6 {label}: the forward's o or s_fin changed when it "
              "wrote checkpoints")
        _, _, pck = wkv.wkv6_torch(r, k, v, lw, u, s0, seg=wkv.SEG)
        ck_err = wkv_check(ck, pck, WKV_SCALE["chunked"], torch.float32,
                           f"wkv6 {label} checkpoints")
        del o_c, s_fin_c, pck
        got = ops.wkv6_bwd(r, k, v, lw, u, ck, do, dsf)
        again = ops.wkv6_bwd(r, k, v, lw, u, ck, do, dsf)
        plain = wkv.wkv6_bwd_torch(r, k, v, lw, u, ck, do, dsf)
        torch.cuda.synchronize()
        tols = wkv_bwd_tol(plain, dt, wkv_du_terms(r, k, v, do))
        errs, used = [], []
        for name, g, g2, p, tol in zip(names, got, again, plain, tols):
            check(bool(torch.isfinite(g).all()),
                  f"wkv6 bwd {label}: {name} non-finite")
            check(torch.equal(g, g2),
                  f"wkv6 bwd {label}: {name} differs between two calls")
            errs.append(compare(g, p, tol, f"wkv6 bwd {label} {name}"))
            used.append(tol_used(g, p, tol))
        faults = {}
        for what, wrong, held in wkv_bwd_faults(r, k, v, lw, u, ck, do, dsf):
            x = max(tol_used(wrong[i], plain[i], tols[i]) for i in held)
            check(x >= WKV_BWD_FAULT, f"wkv6 bwd {label}: a kernel with "
                  f"{what} lands only {x:.3g} times over the tolerance")
            faults[what] = x
        del wrong
        share, rtol = WKV_BWD_TOL[dtype_name(dt)]
        row = dict(label=label, dtype=dtype_name(dt), max_abs_err=max(errs),
                   errs=dict(zip(names, errs)), tol_used=dict(zip(names,
                                                                  used)),
                   faults_tol_used=faults, checkpoint_err=ck_err,
                   tol=f"{share:g}·(max |plain| of its {BWD_TILE}-step tile "
                   f"of a (batch, head); du: of its head; ds0: of its state) "
                   f"+ {WKV_BWD_NOISE:g} + {rtol:g}·|plain| (dr, dk, dv) + "
                   f"{wkv_du_rounding(N):.3g}·sqrt(sum of du's squared "
                   f"term magnitudes) (du)",
                   shape=f"B {B}, S {S}, H {H}, N {N}, {dtype_name(dt)}")
        timing = ""
        if timed:
            call = lambda: ops.wkv6_bwd(  # noqa: E731
                r, k, v, lw, u, ck, do, dsf)
            row.update(ms=time_ms(call), device_ms=device_ms(call),
                       device_ms_by_kernel={
                           re.search(r"wkv6_bwd_\w+", k)[0]: x
                           for k, x in device_ms_by_kernel(call).items()
                           if "wkv6_bwd_" in k},
                       plain_ms=plain_ms_of(lambda: wkv.wkv6_bwd_torch(
                           r, k, v, lw, u, ck, do, dsf)),
                       library_ms=None,
                       fwd_ms=time_ms(lambda: wkv.wkv6_cuda(
                           r, k, v, lw, u, s0)),
                       fwd_ckpt_ms=time_ms(lambda: wkv.wkv6_cuda(
                           r, k, v, lw, u, s0, seg=wkv.SEG)),
                       fwd_ckpt_device_ms=device_ms(lambda: wkv.wkv6_cuda(
                           r, k, v, lw, u, s0, seg=wkv.SEG)),
                       fwd_ckpt_plain_ms=plain_ms_of(lambda: wkv.wkv6_torch(
                           r, k, v, lw, u, s0, seg=wkv.SEG)),
                       checkpoint_every=wkv.SEG,
                       **wkv_bwd_work(B, S, H, N, r.element_size()))
            moved = row["moved_bytes"]
            timing = (f" kernel {row['ms']:.4f} ms (device "
                      f"{fmt_ms(row['device_ms'])}) plain "
                      f"{row['plain_ms']:.4f} ms bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                      f"{row['bytes'] / 1e9:.3f} GB; the step recurrence's "
                      f"fp32 count {row['recurrence_ms']:.4f} ms; the "
                      f"kernel moves {sum(moved.values()) / 1e9:.3f} GB: "
                      + ", ".join(f"{k} {x / 1e9:.3f}"
                                  for k, x in moved.items())
                      + f"); the forward {row['fwd_ms']:.4f} ms, with "
                      f"checkpoints every {wkv.SEG} steps "
                      f"{row['fwd_ckpt_ms']:.4f} ms (device "
                      f"{fmt_ms(row['fwd_ckpt_device_ms'])}, plain "
                      f"{row['fwd_ckpt_plain_ms']:.4f} ms); by kernel "
                      + ", ".join(f"{k} {x:.4f}" for k, x in
                                  row["device_ms_by_kernel"].items()))
        rows.append(row)
        print(f"  wkv6 bwd {label:<26} {dtype_name(dt):<8} err "
              + "/".join(f"{e:.3g}" for e in errs) + " (of the tolerance "
              + "/".join(f"{x:.3f}" for x in used) + "; planted faults "
              + ", ".join(f"{w} {x:.3g}x" for w, x in faults.items())
              + f"; checkpoints {ck_err:.3g}) bit-equal{timing}",
              flush=True)
        del r, k, v, lw, u, s0, do, dsf, o, s_fin, ck, got, again, plain
        torch.cuda.empty_cache()
    return rows


RGLRU_T6 = "recurrentgemma train (t6)"


def rglru_cases():
    # (label, B, S, R, nonzero h0, padded row 0 from step)
    return [
        ("recurrentgemma serving", 8, 2560, 4096, False, None),
        # (t6)'s microbatch: the forward of every RG-LRU layer in training
        (RGLRU_T6, 1, 4096, 4096, False, None),
        ("serving h0 padded", 8, 2560, 4096, True, 2040),
        ("ragged S77 R100 h0 padded", 2, 77, 100, True, 41),
        ("S5 R4096 h0", 3, 5, 4096, True, None),
        # (t6)'s microbatch with a ragged last tile; rows that are not
        # 16-byte multiples (R 4,094: the kernel's cp.async path)
        ("(t6) S4095", 1, 4095, 4096, False, None),
        ("R4094 h0 padded", 2, 300, 4094, True, 250),
    ]


def rglru_plan_of(dev, B, S, R, backward):
    """The kernel's plan for a (B, S, R) scan on ``dev`` (fp32 operands
    from the allocator, so 16-byte aligned): the fields a row prints."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as rg
    p = rg.rglru_plan(B, S, R, _build.sm_count(dev), backward)
    return {k: p[k] for k in ("channels", "steps", "stages", "tma",
                              "blocks", "smem")}


def fmt_plan(p):
    return (f"plan C {p['channels']}, {p['steps']} steps x {p['stages']} "
            f"stages, {'TMA' if p['tma'] else 'cp.async'}, {p['blocks']} "
            f"blocks, {p['smem']} B")


def rglru_inputs(dev, gen, B, S, R, nonzero_h0, pad_from):
    """b ~ N(0, 1); log_a on the first half of the channels as the model
    draws it at its initial Λ (8·r·log σ(Λ), r ~ U(0, 1), σ(Λ) ~ U(0.9,
    0.999)), on the second half strong decays -U(1, 20); h0 zero (a
    prefill) or 3·N(0, 1); row 0 padded from ``pad_from`` on (log_a = 0,
    b = 0), as the ragged prefill pads."""
    import torch
    lam = 0.9 + 0.099 * torch.rand(R, device=dev, generator=gen)
    log_a = 8.0 * torch.rand(B, S, R, device=dev, generator=gen) \
        * torch.log(lam)
    log_a[..., R // 2:] = -1.0 - 19.0 * torch.rand(
        B, S, R - R // 2, device=dev, generator=gen)
    b = torch.randn(B, S, R, device=dev, generator=gen)
    h0 = 3.0 * torch.randn(B, R, device=dev, generator=gen) \
        if nonzero_h0 else None
    if pad_from is not None:
        log_a[0, pad_from:] = 0
        b[0, pad_from:] = 0
    return log_a, b, h0


def rglru_check(out, plain, what):
    scale, rtol = RGLRU_TOL
    return compare(out, plain, (scale * plain.abs().max().item(), rtol), what)


def run_rglru_phase(dev, gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg

    rows = []
    for label, B, S, R, nz, pad_from in rglru_cases():
        log_a, b, h0 = rglru_inputs(dev, gen, B, S, R, nz, pad_from)
        h = ops.rglru_scan_bsr(log_a, b, h0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(h).all()), f"rglru {label}: non-finite")
        plain = rg.rglru_scan_torch(log_a, b, h0)
        oracle = ref.rglru_ref(log_a, b, torch.zeros(B, R, device=dev)
                               if h0 is None else h0)
        err = rglru_check(h, plain, f"rglru {label}")
        o_err = rglru_check(h, oracle, f"rglru {label} vs oracle")
        if pad_from is not None:
            check(bool((h[0, pad_from:] == h[0, pad_from - 1]).all()),
                  f"rglru {label}: padding steps changed the carry")
            cut = ops.rglru_scan_bsr(
                log_a[:1, :pad_from].contiguous(),
                b[:1, :pad_from].contiguous(),
                None if h0 is None else h0[:1].contiguous())
            torch.cuda.synchronize()
            check(torch.equal(h[0, -1], cut[0, -1]),
                  f"rglru {label}: padded carry differs from the cut run's")
        row = dict(label=label, max_abs_err=err, oracle_err=o_err,
                   max_abs_plain=plain.abs().max().item(),
                   tol=f"{RGLRU_TOL[0]:g}·max|plain| + "
                   f"{RGLRU_TOL[1]:g}·|plain|")
        timing = ""
        if label in ("recurrentgemma serving", RGLRU_T6):
            call = lambda: ops.rglru_scan_bsr(log_a, b, h0)  # noqa: E731
            # log_a and b read once, h written once, fp32; exp and FMA
            # per element are far below the bytes
            nbytes = 3 * B * S * R * 4
            flops = 3.0 * B * S * R
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS["float32"]
            row.update(ms=time_ms(call), device_ms=device_ms(call),
                       plain_ms=plain_ms_of(lambda: rg.rglru_scan_torch(
                           log_a, b, h0)),
                       library_ms=None, bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       shape=f"B {B}, S {S}, R {R}, fp32",
                       plan=rglru_plan_of(dev, B, S, R, False))
            timing = (f" kernel {row['ms']:.4f} ms (device "
                      f"{fmt_ms(row['device_ms'])}) plain "
                      f"{row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']}; {fmt_plan(row['plan'])})")
        rows.append(row)
        print(f"  rglru {label:<26} err {err:.3g}, vs oracle {o_err:.3g} "
              f"(max |h| {row['max_abs_plain']:.4g}; tol {row['tol']})"
              f"{timing}", flush=True)
    return rows


def rglru_bwd_cases():
    # (label, B, S, R, nonzero h0, padded row 0 from step, decays, timed)
    return [
        (RGLRU_T6, 1, 4096, 4096, False, None, "init", True),
        ("(t6) B2 h0", 2, 4096, 4096, True, None, "init", True),
        ("S1000 h0 padded", 2, 1000, 4096, True, 977, "init", False),
        ("S17 R100 h0", 2, 17, 100, True, None, "init", False),
        ("S15 padded", 3, 15, 4096, False, 9, "init", False),
        ("S1 h0", 2, 1, 4096, True, None, "init", False),
        ("decays -8e^4 to 0", 2, 700, 4096, True, 650, "strong", False),
        ("(t6) S4095", 1, 4095, 4096, False, None, "init", False),
        ("R4094 h0 padded", 2, 300, 4094, True, 250, "init", False),
    ]


def rglru_bwd_tol(plain):
    """The RG-LRU backward's atol per element for each of (dlog_a, db,
    dh0): RGLRU_BWD_TOL of the largest |plain| of its tile (BWD_TILE steps
    of a batch row, all channels; dh0: the row) plus RGLRU_BWD_NOISE."""
    import torch.nn.functional as F
    out = []
    for p in plain:
        if p is None:
            out.append(None)
            continue
        a = p.float().abs()
        if a.ndim == 3:
            B, S, R = a.shape
            pad = -S % BWD_TILE
            t = F.pad(a, (0, 0, 0, pad)).view(B, (S + pad) // BWD_TILE,
                                              BWD_TILE, R)
            t = t.amax(dim=(2, 3), keepdim=True).expand_as(t)
            t = t.reshape(B, S + pad, R)[:, :S]
        else:
            t = a.amax(dim=-1, keepdim=True).expand_as(a)
        out.append((RGLRU_BWD_TOL * t + RGLRU_BWD_NOISE, 0.0))
    return out


def run_rglru_bwd_phase(dev, gen):
    """The RG-LRU backward kernel against its plain reverse loop on the
    same (log_a, h, dh, h0), h the forward kernel's; two calls bit-equal;
    planted faults (one step's dh dropped; h read one step late, as a
    kernel that took h_t for h_{t-1}) at least RGLRU_BWD_FAULT times over
    the tolerance; kernel, device and plain ms at the timed shapes beside
    the bound (20 bytes a step and channel)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg

    names = ("dlog_a", "db", "dh0")
    rows = []
    for label, B, S, R, nz, pad_from, decay, timed in rglru_bwd_cases():
        log_a, b, h0 = rglru_inputs(dev, gen, B, S, R, nz, pad_from)
        if decay == "strong":
            # -exp(U(-6, ln 8 + 4)): down to -8·e^4; every 7th channel 0
            log_a = -torch.exp(torch.empty_like(log_a).uniform_(
                -6.0, math.log(8.0) + 4.0, generator=gen))
            log_a[..., ::7] = 0
            if pad_from is not None:
                log_a[0, pad_from:] = 0
        dh = torch.randn(B, S, R, device=dev, generator=gen)
        h = ops.rglru_scan_bsr(log_a, b, h0)
        got = ops.rglru_scan_bwd(log_a, h, dh, h0)
        again = ops.rglru_scan_bwd(log_a, h, dh, h0)
        plain = rg.rglru_scan_bwd_torch(log_a, h, dh, h0)
        torch.cuda.synchronize()
        tols = rglru_bwd_tol(plain)
        errs, used = {}, {}
        for name, g, g2, p, tol in zip(names, got, again, plain, tols):
            if p is None:
                check(g is None, f"rglru bwd {label}: dh0 without an h0")
                continue
            check(bool(torch.isfinite(g).all()),
                  f"rglru bwd {label}: {name} non-finite")
            check(torch.equal(g, g2),
                  f"rglru bwd {label}: {name} differs between two calls")
            errs[name] = compare(g, p, tol, f"rglru bwd {label} {name}")
            used[name] = tol_used(g, p, tol)
        if pad_from is not None:
            # past the row's length the carry is the running sum of dh
            tail = dh[0, pad_from:].flip(0).cumsum(0).flip(0)
            check(bool(((got[1][0, pad_from:] - tail).abs()
                        <= 1e-5 * tail.abs().max() + 1e-5).all()),
                  f"rglru bwd {label}: padding steps changed the carry")
        faults = {}
        t_mid = S // 2
        d = dh.clone()
        d[:, t_mid] = 0
        wrong = ops.rglru_scan_bwd(log_a, h, d, h0)
        faults[f"dh of step {t_mid} dropped"] = tol_used(
            wrong[1], plain[1], tols[1])
        if S > 1:
            late = torch.roll(h, -1, dims=1).contiguous()
            wrong = ops.rglru_scan_bwd(log_a, late, dh, h0)
            faults["h read one step late"] = tol_used(wrong[0], plain[0],
                                                      tols[0])
        for what, x in faults.items():
            check(x >= RGLRU_BWD_FAULT, f"rglru bwd {label}: a kernel with "
                  f"{what} lands only {x:.3g} times over the tolerance")
        del wrong, d
        row = dict(label=label, max_abs_err=max(errs.values()), errs=errs,
                   tol_used=used, faults_tol_used=faults,
                   tol=f"{RGLRU_BWD_TOL:g}·(max |plain| of its {BWD_TILE}-"
                   f"step tile of a batch row; dh0: of the row) + "
                   f"{RGLRU_BWD_NOISE:g}",
                   shape=f"B {B}, S {S}, R {R}, fp32"
                   + (", h0" if nz else "")
                   + (f", row 0 padded from {pad_from}" if pad_from else "")
                   + (", decays to -8e^4 and 0" if decay == "strong" else ""))
        timing = ""
        if timed:
            call = lambda: ops.rglru_scan_bwd(log_a, h, dh, h0)  # noqa: E731
            # log_a, h and dh read, dlog_a and db written once, fp32 (h0
            # and dh0 a row each); the exponentials and the carry's FMA are
            # far below the bytes
            nbytes = 20 * B * S * R + (8 * B * R if nz else 0)
            flops = 5.0 * B * S * R
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS["float32"]
            row.update(ms=time_ms(call), device_ms=device_ms(call),
                       plain_ms=plain_ms_of(lambda: rg.rglru_scan_bwd_torch(
                           log_a, h, dh, h0)),
                       library_ms=None,
                       library="none: no PyTorch call computes the scan's "
                       "gradient",
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       plan=rglru_plan_of(dev, B, S, R, True))
            k_ms = row["device_ms"] or row["ms"]
            row["bound_share"] = row["bound_ms"] / k_ms
            timing = (f" kernel {row['ms']:.4f} ms (device "
                      f"{fmt_ms(row['device_ms'])}, "
                      f"{row['bound_share']:.1%} of bound) plain "
                      f"{row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']}, {nbytes / 1e6:.1f} MB; "
                      f"{fmt_plan(row['plan'])})")
        rows.append(row)
        print(f"  rglru bwd {label:<22} err "
              + "/".join(f"{e:.3g}" for e in errs.values())
              + " (of the tolerance "
              + "/".join(f"{x:.3f}" for x in used.values())
              + "; planted faults "
              + ", ".join(f"{w} {x:.3g}x" for w, x in faults.items())
              + f") bit-equal{timing}", flush=True)
        del log_a, b, h0, dh, h, got, again, plain
        torch.cuda.empty_cache()
    return rows


def mla_cases():
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    # deepseek-v2 serve shape: 8 slots, prompts up to 1024 + 32 generated
    serve_pos = [1055, 700, 1023, -1, 512, 127, 128, 900]
    long_pos = [8191, 5000, 8000, -1, 3000, 127, 2048, 6500]
    # (label, B, H, ps, pps, q dtype, pool dtype, positions)
    return [
        ("deepseek-v2 serving", 8, 128, 128, 9, bf16, bf16, serve_pos),
        ("fp32 serving", 8, 128, 128, 9, f32, f32, serve_pos),
        ("fp32 q bf16 pools", 8, 128, 128, 9, f32, bf16, serve_pos),
        ("H16 ps16", 4, 16, 16, 12, bf16, bf16, [150, 31, -1, 47]),
        ("fp32 H16 ps16", 4, 16, 16, 12, f32, f32, [150, 31, -1, 47]),
        ("H128 ps16", 4, 128, 16, 12, bf16, bf16, [150, 31, -1, 47]),
        # long tables (rows up to 8K and 20K keys): several tiles a range,
        # the ring's stages reused and its mbarrier parity flipping
        ("long B8 pps64", 8, 128, 128, 64, bf16, bf16, long_pos),
        ("long fp32 B8 pps64", 8, 128, 128, 64, f32, f32, long_pos),
        ("long B1 pps160", 1, 128, 128, 160, bf16, bf16, [20000]),
        ("long fp32 B1 pps160", 1, 128, 128, 160, f32, f32, [20000]),
    ]


def mla_inputs(dev, gen, B, H, ps, pps, qdt, dt, positions, lora=512,
               rd=64):
    """A ragged latent batch, laid out as :func:`decode_inputs` lays out
    the GQA one: shuffled pages, rows 0 and 1 alias their first page (a
    single row maps its first page again at slot 2), one row has a -1 hole
    inside its live prefix, ``positions`` may hold -1."""
    import torch
    P = B * pps
    q = torch.randn(B, H, lora + rd, device=dev, generator=gen).to(qdt)
    ckv = torch.randn(P, ps, lora, device=dev, generator=gen).to(dt)
    krope = torch.randn(P, ps, rd, device=dev, generator=gen).to(dt)
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, pps), -1, dtype=torch.int32, device=dev)
    for b, p in enumerate(positions):
        if p >= 0:
            n = p // ps + 1
            table[b, :n] = perm[b * pps:b * pps + n]
    if B == 1 and positions[0] >= 3 * ps:
        table[0, 2] = table[0, 0]                       # aliased page
    elif B > 1 and positions[0] >= 0 and positions[1] >= 0:
        table[1, 0] = table[0, 0]                       # aliased prefix page
    holed = [b for b, p in enumerate(positions) if p >= 2 * ps]
    if holed:
        table[holed[-1], 1] = -1                        # hole mid-prefix
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, ckv, krope, table, pos


def run_mla_phase(dev, gen):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    rows = []
    scale = (128 + 64) ** -0.5           # deepseek-v2: (nope + rd) ** -0.5
    for label, B, H, ps, pps, qdt, dt, positions in mla_cases():
        q, ckv, krope, table, pos = mla_inputs(dev, gen, B, H, ps, pps, qdt,
                                               dt, positions)
        out = ops.mla_paged_decode_bhd(q, ckv, krope, table, pos,
                                       scale=scale)
        plain = pa.mla_paged_decode_torch(q, ckv, krope, table, pos,
                                          scale=scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"mla {label}: non-finite")
        check(bool((out[pos < 0] == 0).all()),
              f"mla {label}: inactive row not zero")
        tol = DECODE_TOL[dtype_name(qdt)]
        err = compare(out, plain, tol, f"mla {label}")
        row = dict(label=label, dtype=f"q {dtype_name(qdt)}, pools "
                   f"{dtype_name(dt)}", max_abs_err=err, tol=tol_text(tol))
        plan = pa.mla_card_plan(q, ckv, krope, table)
        row["plan"] = {k: plan[k] for k in ("route", "n_split", "tpr",
                                            "stages")}
        if label.startswith("long"):
            check(plan["tpr"] > max(1, plan["stages"]),
                  f"mla {label}: plan {plan} does not reuse the ring")
        timing = ""
        if "serving" in label or label.startswith("long"):
            call = lambda: ops.mla_paged_decode_bhd(  # noqa: E731
                q, ckv, krope, table, pos, scale=scale)
            keys, pairs = decode_live_keys(table, pos, ps)
            lora, rd = ckv.shape[2], krope.shape[2]
            nbytes = keys * (lora + rd) * ckv.element_size() \
                + (q.numel() + B * H * lora) * q.element_size() \
                + table.numel() * 4 + pos.numel() * 4
            flops = 2.0 * pairs * H * ((lora + rd) + lora)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[dtype_name(dt)]
            row.update(ms=time_ms(call), device_ms=device_ms(call),
                       cold_ms=cold_device_ms(call),
                       plain_ms=plain_ms_of(lambda: pa.mla_paged_decode_torch(
                           q, ckv, krope, table, pos, scale=scale)),
                       library_ms=None, bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       live_keys=keys, scored=pairs, bytes=nbytes,
                       flops=flops, shape=f"B {B}, H {H}, lora {lora}, rd "
                       f"{rd}, ps {ps}, {row['dtype']}, ragged")
            timing = (f" kernel {row['ms']:.4f} ms (device "
                      f"{fmt_ms(row['device_ms'])}, L2-cold "
                      f"{fmt_ms(row['cold_ms'])}) plain "
                      f"{row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']}; {keys} distinct live keys, "
                      f"{pairs} row-key pairs)")
        rows.append(row)
        print(f"  mla {label:<20} {row['dtype']:<26} err {err:.3g} (tol "
              f"{tol_text(tol)}; {plan['route']}, {plan['n_split']} ranges "
              f"of {plan['tpr']} tiles){timing}", flush=True)
    return rows


def flash_bwd_cases():
    """(label, B, S, H, K, hd, hdv, dtype, causal, window, cap), as
    :func:`flash_cases`."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, K, hd, dtype, causal, window, cap)
    square = [
        ("paper train", 8, 1024, 12, 4, 64, bf16, True, 0, 0.0),
        ("qwen3 train", 2, 4096, 16, 8, 128, bf16, True, 0, 0.0),
        ("granite train", 4, 4096, 16, 8, 64, bf16, True, 0, 0.0),
        ("ragged S1000", 2, 1000, 16, 8, 128, bf16, True, 0, 0.0),
        ("ragged S77 G3", 2, 77, 12, 4, 64, bf16, True, 0, 0.0),
        # the bf16 kernels' tile edges: 128-key dK/dV items with 64-row
        # (hd 128) or 128-row (hd 64) q stages, 128-row dQ items with
        # 128-key K/V stages
        ("edge S127 G2", 1, 127, 4, 2, 64, bf16, True, 0, 0.0),
        ("edge S255 G3", 1, 255, 6, 2, 128, bf16, True, 0, 0.0),
        ("edge S257 G3", 2, 257, 6, 2, 64, bf16, True, 0, 0.0),
        ("edge S257 G2", 1, 257, 4, 2, 128, bf16, True, 0, 0.0),
        # more work items than the card runs at once (256 dK/dV, 512 dQ
        # on 132 SMs): the persistent loops and the rings' phases wrap
        ("wrap B2 S2048", 2, 2048, 16, 8, 128, bf16, True, 0, 0.0),
        ("not causal", 2, 512, 12, 4, 64, bf16, False, 0, 0.0),
        ("window 256 cap 30", 2, 640, 16, 8, 128, bf16, True, 256, 30.0),
        ("fp32 paper", 2, 1024, 12, 4, 64, f32, True, 0, 0.0),
        ("fp32 qwen3 S1000", 1, 1000, 16, 8, 128, f32, True, 0, 0.0),
        ("fp32 S77 not causal", 2, 77, 12, 4, 64, f32, False, 0, 0.0),
        ("fp32 window 100 cap 20", 2, 384, 12, 4, 64, f32, True, 100, 20.0),
        # the dense decoders' training shapes, as the forward's
        (QWEN25_T7, 1, 4096, 40, 8, 128, bf16, True, 0, 0.0),
        ("fp32 qwen2.5 (t7)", 1, 4096, 40, 8, 128, f32, True, 0, 0.0),
        ("qwen2.5 ragged S1000", 2, 1000, 40, 8, 128, bf16, True, 0, 0.0),
        (MISTRAL_T8, 1, 4096, 96, 8, 128, bf16, True, 0, 0.0),
        ("fp32 mistral (t8)", 1, 4096, 96, 8, 128, f32, True, 0, 0.0),
        ("mistral ragged S2049", 1, 2049, 96, 8, 128, bf16, True, 0, 0.0),
    ] + internvl2_cases()
    return [c[:6] + (c[5],) + c[6:] for c in square] + mla_train_cases() \
        + rg_train_cases() + gemma2_train_cases()


RG_T6 = "rg train (t6)"
# hd 256's window faults are planted on one case whose scores are sharp (q
# drawn 4 times wider: scale·q·k ~ N(0, 16)), where a row's weight can sit
# on its window's frontier key.  At unit scores a frontier pair carries
# about 1/2,048 of its row, far under any tile-scaled tolerance, so the
# other hd-256 cases plant the head and tile faults only.
RG_SHARP = "rg (t6) sharp scores"
# gemma2's softcap of 50 at its scale 1/16 leaves unit scores near tanh's
# linear part (1 - tanh^2 within 4e-4 of 1), where a kernel that dropped
# that factor from dS would pass any tolerance.  Its sharp case draws q 40
# times wider (scale·q·k ~ N(0, 1,600): tanh(s / 50) about 0.8 a standard
# deviation), where the factor is far from 1; that fault, and the window's,
# are planted there.
GEMMA2_SHARP = "gemma2 sharp scores"
Q_SCALE = {RG_SHARP: 4.0, GEMMA2_SHARP: 40.0}
GEMMA2_T9 = "gemma2 train (t9)"
GEMMA2_GLOBAL_T9 = "gemma2 global (t9) bwd"


def rg_train_cases():
    """recurrentgemma's local layers in training, (t6)'s microbatch: B 1,
    S 4,096, 16 q heads over one kv head of 256, window 2,048, causal;
    bf16 and fp32, ragged S 1,000, 77 and 1, S 2,047, 2,049 and 4,095
    around the window, K 8 G 2 (any G), a window of 100 (no multiple of
    64: its edge cuts the dK/dV kernel's 64-row stages and the P^T handed
    between its consumers), and the sharp-score case of the window
    faults.  The same cases for the forward's log-sum-exp (checked in
    every backward case) and the backward."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, K, hd, hdv, dtype, causal, window, cap)
    return [(RG_T6, 1, 4096, 16, 1, 256, 256, bf16, True, 2048, 0.0),
            ("fp32 rg (t6)", 1, 4096, 16, 1, 256, 256, f32, True, 2048, 0.0),
            (RG_SHARP, 1, 4096, 16, 1, 256, 256, bf16, True, 2048, 0.0),
            ("rg ragged S1000", 1, 1000, 16, 1, 256, 256, bf16, True, 2048,
             0.0),
            ("rg ragged S77", 2, 77, 16, 1, 256, 256, bf16, True, 2048, 0.0),
            ("rg S1", 2, 1, 16, 1, 256, 256, bf16, True, 2048, 0.0),
            ("rg S2047", 1, 2047, 16, 1, 256, 256, bf16, True, 2048, 0.0),
            ("rg S2049", 1, 2049, 16, 1, 256, 256, bf16, True, 2048, 0.0),
            ("rg S4095", 1, 4095, 16, 1, 256, 256, bf16, True, 2048, 0.0),
            ("hd256 K8 G2", 2, 1000, 16, 8, 256, 256, bf16, True, 2048, 0.0),
            ("rg window 100", 2, 1000, 16, 1, 256, 256, bf16, True, 100,
             0.0),
            ("fp32 hd256 S77", 2, 77, 16, 1, 256, 256, f32, True, 32, 0.0)]


def gemma2_train_cases():
    """gemma2's layers in training, (t9)'s microbatch: B 1, S 4,096, 16 q
    heads over 8 kv heads of 256, the softcap 50 at the scale 1/16; local
    (window 4,096) and global (none), bf16 and fp32; ragged S 1,000 and
    2,049, a window of 100 (its edge cuts the dK/dV kernel's 64-row
    stages), MQA (K 1, G 16: the dK/dV items' q heads split in parts that
    each see the cap), and the sharp-score case of the window and softcap
    faults."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, K, hd, hdv, dtype, causal, window, cap)
    return [(GEMMA2_T9, 1, 4096, 16, 8, 256, 256, bf16, True, 4096, 50.0),
            ("fp32 gemma2 (t9)", 1, 4096, 16, 8, 256, 256, f32, True, 4096,
             50.0),
            (GEMMA2_GLOBAL_T9, 1, 4096, 16, 8, 256, 256, bf16, True, 0,
             50.0),
            ("fp32 gemma2 global (t9)", 1, 4096, 16, 8, 256, 256, f32, True,
             0, 50.0),
            ("gemma2 ragged S1000", 1, 1000, 16, 8, 256, 256, bf16, True,
             4096, 50.0),
            ("gemma2 ragged S2049", 1, 2049, 16, 8, 256, 256, bf16, True, 0,
             50.0),
            ("gemma2 window 100", 2, 1000, 16, 8, 256, 256, bf16, True, 100,
             50.0),
            ("gemma2 cap K1 G16", 1, 4096, 16, 1, 256, 256, bf16, True, 4096,
             50.0),
            (GEMMA2_SHARP, 1, 4096, 16, 8, 256, 256, bf16, True, 1000,
             50.0)]


def new_case_labels():
    """The forward and backward cases of the dense decoders' slices."""
    qm = [QWEN25_T7, "fp32 qwen2.5 (t7)", "qwen2.5 ragged S1000", MISTRAL_T8,
          "fp32 mistral (t8)", "mistral ragged S2049"]
    return set(qm + [c[0] for c in gemma2_train_cases()]
               + [GEMMA2_FWD_T9, "gemma2 global (t9)", GEMMA2_FWD_H]
               + [c[0] for c in internvl2_cases()])


def bwd_without_dcap(q, k, v, o, lse, do, *, scale, causal, window,
                     logit_cap, kv_block=64):
    """The plain backward with the softcap's factor 1 - tanh^2 dropped from
    dS (P keeps the cap): a planted fault, what a kernel that forgot the
    factor would give (``tests/test_torch_cuda.py:_bwd_without_dcap``,
    keep equal)."""
    import torch
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, hd).float()
    dof = do.reshape(B, S, K, G, hd).float()
    lse_g = lse.permute(0, 2, 1).reshape(B, S, K, G)
    delta = (dof * o.reshape(B, S, K, G, hd).float()).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, S, K, hd), device=q.device)
    dv = torch.zeros((B, S, K, hd), device=q.device)
    pq = torch.arange(S, device=q.device)[:, None]
    for t0 in range(0, S, kv_block):
        t1 = min(t0 + kv_block, S)
        kc, vc = k[:, t0:t1].float(), v[:, t0:t1].float()
        s = torch.einsum("bskgd,btkd->bskgt", qf, kc) * scale
        s = logit_cap * torch.tanh(s / logit_cap)
        pk = torch.arange(t0, t1, device=q.device)[None, :]
        live = (pk <= pq) if causal else torch.ones_like(pq - pk, dtype=bool)
        if window:
            live = live & (pq - pk < window)
        p = torch.where(live[None, :, None, None, :],
                        torch.exp(s - lse_g[..., None]), 0.0)
        dv[:, t0:t1] = torch.einsum("bskgt,bskgd->btkd", p, dof)
        ds = p * (torch.einsum("bskgd,btkd->bskgt", dof, vc)
                  - delta[..., None])
        dq += torch.einsum("bskgt,btkd->bskgd", ds, kc) * scale
        dk[:, t0:t1] = torch.einsum("bskgt,bskgd->btkd", ds, qf) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_bwd_work(B, S, H, K, hd, elt, causal, window, hdv=0):
    """(flops, bytes) of the backward: 2·(3·hd + 2·hdv) per live (q, k)
    pair and head (S, dK, dQ over hd; dP, dV over hdv; 10·hd at equal
    widths), q, k, v, o, dO and lse read once, dq, dk, dv written once."""
    hdv = hdv or hd
    fwd_flops, _ = flash_work(B, S, H, K, hd, elt, causal, window, hdv)
    flops = fwd_flops * (3 * hd + 2 * hdv) / (hd + hdv)
    nbytes = (2 * B * S * H * (hd + hdv) + 2 * B * S * K * (hd + hdv)) \
        * elt + 4 * B * H * S
    return flops, nbytes


def sdpa_backward_ms(q, k, v, do, causal, window):
    """One PyTorch call's backward at the same shape, as a yardstick:
    autograd through ``F.scaled_dot_product_attention`` (a window as a
    boolean mask), trying the flash, memory-efficient and math backends in
    turn with the kv heads shared (``enable_gqa``), then with k and v
    expanded to H heads.  Returns (ms, which backend ran and how)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S, hd = q.shape[1], q.shape[3]
    mask = None
    if window:
        i = torch.arange(S, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    G = q.shape[2] // k.shape[2]
    for expanded in (False, True):
        if expanded:
            kt = kt.repeat_interleave(G, dim=1)
            vt = vt.repeat_interleave(G, dim=1)
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
            leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            try:
                with sdpa_kernel([backend]):
                    out = F.scaled_dot_product_attention(
                        *leaves, attn_mask=mask,
                        is_causal=causal and not window, scale=hd ** -0.5,
                        enable_gqa=not expanded)
                    torch.autograd.grad(out, leaves, dot, retain_graph=True)
                    ms = time_ms(lambda: torch.autograd.grad(
                        out, leaves, dot, retain_graph=True))
            except RuntimeError:
                continue
            finally:
                torch.cuda.synchronize()
            how = (f"{backend.name}, k and v "
                   f"{'expanded to H heads' if expanded else 'shared (enable_gqa)'}"
                   + (", boolean window mask" if window else ""))
            return ms, how
    return None, "no SDPA backend ran"


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Device time per call of ``fn()`` split by kernel name (the summed
    durations of each kernel over ``reps`` calls, torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def bwd_parts(by_kernel: dict) -> dict:
    """The backward's device ms by part, from :func:`device_ms_by_kernel`:
    the dQ kernel (which also writes the statistics) and the dK/dV kernel;
    in fp32 also the D pass, at hd 256 in bf16 the partials' sum."""
    parts = {}
    for name, ms in by_kernel.items():
        part = next((p for p in ("delta", "dkdv_sum", "dkdv", "dq")
                     if f"flash_bwd_{p}" in name), "other")
        parts[part] = parts.get(part, 0.0) + ms
    return parts


def bwd_planted_faults(q, k, v, o, lse, do, kw, window_faults=True,
                       dcap_fault=False):
    """The backward kernel's gradients with a fault planted through its
    inputs, for the tolerance to reject: (what, (dq, dk, dv), the indices
    of the gradients a kernel with that fault would get wrong).  dO's rows
    of one q head of each group, or of the last q tile, set to 0 take their
    terms out of dK and dV, as a kernel that skipped them would; dQ of
    those rows is then 0, which such a kernel would not give, so only dK
    and dV are held.  A window one key shorter or longer over the same lse
    moves its frontier by one key, in all three (with ``window_faults``,
    where the window is shorter than S).  With ``dcap_fault`` the plain
    backward with the softcap's factor 1 - tanh^2 dropped from dS
    (:func:`bwd_without_dcap`): dQ and dK wrong."""
    from repro_torch.kernels import ops

    S, G = q.shape[1], q.shape[2] // k.shape[2]
    out = []
    if q.shape[3] != v.shape[3]:
        # MLA: the rope part of the keys (columns 128-191) zeroed, as a
        # kernel that contracted S over the first 128 columns only would
        kz = k.clone()
        kz[..., 128:] = 0
        out.append(("the rope columns of k dropped",
                    ops.flash_attention_bwd(q, kz, v, o, lse, do, **kw),
                    (0, 1, 2)))
    if G > 1:
        d = do.clone()
        d[:, :, G - 1::G] = 0
        out.append(("one q head of each group dropped",
                    ops.flash_attention_bwd(q, k, v, o, lse, d, **kw), (1, 2)))
    last = (S - 1) // BWD_TILE * BWD_TILE
    d = do.clone()
    d[:, last:] = 0
    out.append((f"q rows {last}-{S - 1} dropped",
                ops.flash_attention_bwd(q, k, v, o, lse, d, **kw), (1, 2)))
    if window_faults and kw["window"] and kw["window"] < S:
        for w in (kw["window"] - 1, kw["window"] + 1):
            out.append((f"window {w}", ops.flash_attention_bwd(
                q, k, v, o, lse, do, **dict(kw, window=w)), (0, 1, 2)))
    if dcap_fault:
        out.append(("the softcap's 1 - tanh^2 dropped",
                    bwd_without_dcap(q, k, v, o, lse, do, **kw), (0, 1)))
    return out


def run_flash_bwd_phase(dev, gen):
    """The backward kernel against its plain version on the same (q, k, v,
    O, lse, dO), O and lse from the plain fp32 forward; two calls
    bit-equal; the tolerance rejects the planted faults of
    :func:`bwd_planted_faults`; the forward kernel's log-sum-exp against
    the plain one."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rows = []
    for label, B, S, H, K, hd, hdv, dt, causal, window, cap in \
            flash_bwd_cases():
        q, k, v, do = (torch.randn(B, S, n, d, device=dev,
                                   generator=gen).to(dt)
                       for n, d in ((H, hd), (K, hd), (K, hdv), (H, hdv)))
        if label in Q_SCALE:
            q = (q.float() * Q_SCALE[label]).to(dt)
        kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                  logit_cap=cap)
        # planted faults must land FAULT_MIN times over the tolerance at
        # MLA's pair, at hd 256 and in the cases of the dense decoders'
        # slice (any excess at the others, as before)
        new = label in new_case_labels()
        fault_min = 10.0 if hdv != hd or hd == 256 or new else 1.0
        o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
        _, lse_k = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        lse_err = (lse_k - lse).abs().max().item()
        check(lse_err <= LSE_TOL * max(1.0, lse.abs().max().item()),
              f"flash lse {label}: max |kernel - plain| {lse_err}")
        errs, tols = [], [bwd_tol(p, dt) for p in plain]
        for name, g, g2, p, tol in zip("qkv", got, again, plain, tols):
            check(bool(torch.isfinite(g).all()),
                  f"flash bwd {label}: d{name} non-finite")
            check(torch.equal(g, g2),
                  f"flash bwd {label}: d{name} differs between two calls")
            errs.append(compare(g, p, tol, f"flash bwd {label} d{name}"))
        used = [tol_used(g, p, tol) for g, p, tol in zip(got, plain, tols)]
        faults = {}
        for what, wrong, held in bwd_planted_faults(
                q, k, v, o, lse, do, kw,
                window_faults=hd != 256 or label in Q_SCALE,
                dcap_fault=bool(cap) and label in Q_SCALE):
            r = max(tol_used(wrong[i], plain[i], tols[i]) for i in held)
            check(r > fault_min, f"flash bwd {label}: the tolerance passes a "
                  f"kernel with {what} by less than {fault_min:g} times "
                  f"(its largest error is {r:.3g} of it)")
            faults[what] = r
        del wrong
        call = lambda: ops.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, **kw)
        reps = timing_reps(dt, B * S * H)
        ms, by_kernel = time_ms(call, reps=reps), \
            device_ms_by_kernel(call, reps=reps)
        dev_ms, parts = sum(by_kernel.values()) or None, bwd_parts(by_kernel)
        plan = fa.flash_bwd_card_plan(q, k, v, causal, window, cap)[0]
        plan_text = (f"dK/dV {len(plan['kv']['items'])} items on "
                     f"{plan['kv']['blocks']} blocks, {plan['kv']['slots']} "
                     f"slots x {plan['kv']['stages']} stages, "
                     f"{plan['kv']['smem']} B; dQ "
                     f"{len(plan['dq']['items'])} items on "
                     f"{plan['dq']['blocks']} blocks, {plan['dq']['slots']} "
                     f"x {plan['dq']['stages']}, {plan['dq']['smem']} B")
        plain_ms = plain_ms_of(lambda: fa.flash_attention_bwd_torch(
            q, k, v, o, lse, do, **kw))
        lib_ms, lib = (None, "none: SDPA has no softcap") if cap else \
            sdpa_backward_ms(q, k, v, do, causal, window)
        flops, nbytes = flash_bwd_work(B, S, H, K, hd, q.element_size(),
                                       causal, window, hdv)
        t_ops = flops / PEAK_FLOPS[dtype_name(dt)]
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        k_ms = dev_ms if dev_ms is not None else ms
        share, rtol = FLASH_BWD_TOL[dtype_name(dt)]
        rows.append(dict(label=label, dtype=dtype_name(dt),
                         max_abs_err=max(errs), errs=errs, lse_err=lse_err,
                         tol=f"{share:g}·(max |plain| of its {BWD_TILE}-row "
                         f"or {BWD_TILE}-key tile) + {BWD_NOISE:g} + "
                         f"{rtol:g}·|plain|", tol_used=used,
                         faults_tol_used=faults,
                         ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library=lib, bound_ms=bound_ms,
                         parts_device_ms=parts, plan=plan_text,
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes",
                         tflops=flops / (k_ms * 1e-3) / 1e12,
                         bound_share=bound_ms / k_ms,
                         shape=f"B {B}, S {S}, H {H}, K {K}, hd {hd}, "
                         + (f"hdv {hdv}, " if hdv != hd else "")
                         + f"{dtype_name(dt)}, "
                         f"{'causal' if causal else 'not causal'}"
                         + (f", window {window}" if window else "")
                         + (f", cap {cap:g}" if cap else "")))
        print(f"  flash bwd {label:<22} {dtype_name(dt):<8} err dq/dk/dv "
              f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (of the tolerance "
              f"{used[0]:.3f}/{used[1]:.3f}/{used[2]:.3f}; planted faults "
              + ", ".join(f"{w} {r:.3g}" for w, r in faults.items())
              + f") lse {lse_err:.3g} bit-equal kernel {ms:.4f} ms "
              f"(device {fmt_ms(dev_ms)}, "
              f"{rows[-1]['tflops']:.1f} TFLOP/s, "
              f"{rows[-1]['bound_share']:.1%} of bound) plain "
              f"{plain_ms:.4f} ms library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms "
              f"({lib}) bound {bound_ms:.4f} ms; device by part "
              + ", ".join(f"{n} {t:.4f}" for n, t in parts.items())
              + f"; plan: {plan_text}", flush=True)
        del q, k, v, do, o, lse, lse_k, got, again, plain
        torch.cuda.empty_cache()
    return rows


# seamless-m4t-medium's attention (H = K = 16, hd 64, G 1): (t11)'s row of
# 4,096 decoder tokens over 1,024 encoder frames and (j)'s prompt of 1,024
# over 264 frames.  The cross-attention has Sk apart from Sq and no mask;
# the encoder's self-attention is full, the decoder's causal.
T11_CROSS = "seamless (t11) cross"
T11_ENCODER = "seamless (t11) encoder"
T11_DECODER = "seamless (t11) decoder"
J_CROSS = "seamless (j) cross"
J_ENCODER = "seamless (j) encoder"


def cross_cases():
    """(label, B, Sq, Sk, H, K, hd, dtype, causal, timed): seamless's five
    attention shapes in bf16 (timed), (t11)'s cross-attention in fp32, and
    the kernels' edges at Sq != Sk: Sk 1, 77, 1,000 and 65, Sq 1, Sq < Sk,
    and G 2 at hd 128 (the group sum at Sq != Sk)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        (T11_CROSS, 2, 4096, 1024, 16, 16, 64, bf16, False, True),
        (T11_ENCODER, 2, 1024, 1024, 16, 16, 64, bf16, False, True),
        (T11_DECODER, 2, 4096, 4096, 16, 16, 64, bf16, True, True),
        (J_CROSS, 1, 1024, 264, 16, 16, 64, bf16, False, True),
        (J_ENCODER, 1, 264, 264, 16, 16, 64, bf16, False, True),
        ("fp32 (t11) cross", 2, 4096, 1024, 16, 16, 64, f32, False, False),
        ("cross Sk1", 2, 300, 1, 16, 16, 64, bf16, False, False),
        ("cross Sk77", 1, 1000, 77, 16, 16, 64, bf16, False, False),
        ("cross Sk1000", 1, 130, 1000, 16, 16, 64, bf16, False, False),
        ("cross Sk65", 1, 200, 65, 16, 16, 64, bf16, False, False),
        ("cross Sq1", 2, 1, 264, 16, 16, 64, bf16, False, False),
        ("cross Sq<Sk", 1, 100, 1024, 16, 16, 64, bf16, False, False),
        ("fp32 cross Sk77", 1, 1000, 77, 16, 16, 64, f32, False, False),
        ("cross G2 hd128", 2, 500, 300, 16, 8, 128, bf16, False, False),
        ("fp32 cross G2 hd128", 2, 500, 300, 16, 8, 128, f32, False, False),
    ]


def cross_work(B, Sq, Sk, H, K, hd, elt, causal):
    """((forward flops, bytes), (backward flops, bytes)): 4·hd and 10·hd
    FLOPs a live (q, k) pair and head; the forward reads q, k, v once and
    writes o, the backward reads q, k, v, o, dO and the lse and writes dq,
    dk, dv."""
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    fwd = (4.0 * hd * B * H * pairs,
           (2 * B * Sq * H * hd + 2 * B * Sk * K * hd) * elt)
    bwd = (10.0 * hd * B * H * pairs,
           (4 * B * Sq * H * hd + 4 * B * Sk * K * hd) * elt + 4 * B * H * Sq)
    return fwd, bwd


def bound_of(work, dt):
    """(bound ms, what bounds it) of (flops, bytes) on the card."""
    flops, nbytes = work
    t_ops = flops / PEAK_FLOPS[dtype_name(dt)]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def run_cross_flash_phase(dev, gen):
    """The flash forward and backward at a key length apart from the query
    length (seamless's cross-attention) and at its G 1, hd 64 self-
    attention: each against its plain version (the forward's output and
    log-sum-exp, the backward's dq, dk, dv on the plain forward's O and
    lse, two backward calls bit-equal), planted faults at least 10 times
    over the tolerance (the backward: the last key tile of Sk dropped from
    dQ, a q head of each group or the last q tile dropped from dK and dV;
    the forward: the key past Sk read as live, the zero key the card's
    loads give there, on scores below zero where a key of score 0 weighs),
    and the timed cases' kernel, plain and SDPA times beside the bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rows = []
    for label, B, Sq, Sk, H, K, hd, dt, causal, timed in cross_cases():
        q, k, v, do = (torch.randn(B, n, h, hd, device=dev,
                                   generator=gen).to(dt)
                       for n, h in ((Sq, H), (Sk, K), (Sk, K), (Sq, H)))
        kw = dict(scale=hd ** -0.5, causal=causal, window=0, logit_cap=0.0)
        ftol = FLASH_TOL[dtype_name(dt)]
        out = ops.flash_attention_bshd(q, k, v, **kw)
        out_l, lse_k = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **kw)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        plain = fa.flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"flash {label}: non-finite")
        check(torch.equal(out, out_l), f"flash {label}: the output with the "
              "lse differs from the one without")
        err = compare(out, o, ftol, f"flash {label}")
        used = tol_used(out, o, ftol)
        lse_err = (lse_k - lse).abs().max().item()
        check(lse_err <= LSE_TOL * max(1.0, lse.abs().max().item()),
              f"flash lse {label}: max |kernel - plain| {lse_err}")
        tols = [bwd_tol(p, dt) for p in plain]
        errs = []
        for name, g, g2, p, tol in zip("qkv", got, again, plain, tols):
            check(bool(torch.isfinite(g).all()),
                  f"flash bwd {label}: d{name} non-finite")
            check(torch.equal(g, g2),
                  f"flash bwd {label}: d{name} differs between two calls")
            errs.append(compare(g, p, tol, f"flash bwd {label} d{name}"))
        bwd_used = [tol_used(g, p, t) for g, p, t in zip(got, plain, tols)]
        faults = {}
        for what, wrong, held in bwd_planted_faults(q, k, v, o, lse, do, kw):
            faults[what] = max(tol_used(wrong[i], plain[i], tols[i])
                               for i in held)
        bn = fa.bwd_stream_tiles(hd)[1]
        cut = (Sk - 1) // bn * bn
        if cut and not causal:       # fewer keys than queries: no mask
            wrong = ops.flash_attention_bwd(q, k[:, :cut].contiguous(),
                                            v[:, :cut].contiguous(), o, lse,
                                            do, **kw)[0]
            faults[f"keys {cut}-{Sk - 1} dropped from dQ"] = tol_used(
                wrong, plain[0], tols[0])
        if not causal:
            # scores below zero (q >= 0, k <= 0, twice as wide) and v about
            # 1: the zero key past Sk, if read as live, takes the weight
            qs = (q.float().abs() * 2).to(dt)
            ks = (-k.float().abs() * 2).to(dt)
            vs = (v.float() + 1).to(dt)
            want = fa.flash_attention_torch(qs, ks, vs, **kw)
            zero = torch.zeros_like(ks[:, :1])
            compare(ops.flash_attention_bshd(qs, ks, vs, **kw), want, ftol,
                    f"flash {label} (negative scores)")
            faults[f"key {Sk} read as live"] = tol_used(
                ops.flash_attention_bshd(qs, torch.cat([ks, zero], 1),
                                         torch.cat([vs, zero], 1), **kw),
                want, ftol)
            del qs, ks, vs, want, zero
        for what, r in faults.items():
            check(r >= 10.0, f"flash {label}: the tolerance passes a kernel "
                  f"with {what} by less than 10 times (its largest error is "
                  f"{r:.3g} of it)")
        row = dict(label=label, dtype=dtype_name(dt), max_abs_err=err,
                   tol_used=used, lse_err=lse_err, bwd_max_abs_err=max(errs),
                   bwd_errs=errs, bwd_tol_used=bwd_used,
                   faults_tol_used=faults,
                   shape=f"B {B}, Sq {Sq}, Sk {Sk}, H {H}, K {K}, hd {hd}, "
                   f"{dtype_name(dt)}, "
                   f"{'causal' if causal else 'not causal'}")
        line = (f"  flash {label:<22} {dtype_name(dt):<8} fwd err {err:.3g} "
                f"({used:.3f} of the tolerance), lse {lse_err:.3g}; bwd "
                f"dq/dk/dv {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} "
                f"({bwd_used[0]:.3f}/{bwd_used[1]:.3f}/{bwd_used[2]:.3f} of "
                "it), bit-equal; planted faults "
                + ", ".join(f"{w} {r:.3g}" for w, r in faults.items()))
        if timed:
            fwd_call = lambda: ops.flash_attention_bshd(  # noqa: E731
                q, k, v, **kw)
            bwd_call = lambda: ops.flash_attention_bwd(  # noqa: E731
                q, k, v, o, lse, do, **kw)
            fwork, bwork = cross_work(B, Sq, Sk, H, K, hd, q.element_size(),
                                      causal)
            f_bound, f_by = bound_of(fwork, dt)
            b_bound, b_by = bound_of(bwork, dt)
            lib_ms, lib = sdpa_forward_ms(q, k, v, causal)
            blib_ms, blib = sdpa_backward_ms(q, k, v, do, causal, 0)
            by_kernel = device_ms_by_kernel(bwd_call)
            row.update(
                ms=time_ms(fwd_call), device_ms=device_ms(fwd_call),
                plain_ms=plain_ms_of(lambda: fa.flash_attention_torch(
                    q, k, v, **kw)),
                library_ms=lib_ms, library=f"SDPA ({lib})",
                bound_ms=f_bound, bound_by=f_by,
                bwd_ms=time_ms(bwd_call),
                bwd_device_ms=sum(by_kernel.values()) or None,
                bwd_parts_device_ms=bwd_parts(by_kernel),
                bwd_plain_ms=plain_ms_of(lambda: fa.flash_attention_bwd_torch(
                    q, k, v, o, lse, do, **kw)),
                bwd_library_ms=blib_ms, bwd_library=f"SDPA's backward ({blib})",
                bwd_bound_ms=b_bound, bwd_bound_by=b_by)
            f_ms = row["device_ms"] or row["ms"]
            b_ms = row["bwd_device_ms"] or row["bwd_ms"]
            row.update(bound_share=f_bound / f_ms,
                       bwd_bound_share=b_bound / b_ms)
            line += (f"; forward {row['ms']:.4f} ms (device "
                     f"{fmt_ms(row['device_ms'])}, "
                     f"{f_bound / f_ms:.1%} of its "
                     f"{f_bound:.4f} ms bound) plain {row['plain_ms']:.4f} "
                     f"SDPA {fmt_ms(lib_ms)} ({lib}); backward "
                     f"{row['bwd_ms']:.4f} ms (device "
                     f"{fmt_ms(row['bwd_device_ms'])}, "
                     f"{b_bound / b_ms:.1%} of its "
                     f"{b_bound:.4f} ms bound; "
                     + ", ".join(f"{n} {t:.4f}" for n, t in
                                 row["bwd_parts_device_ms"].items())
                     + f") plain {row['bwd_plain_ms']:.4f} SDPA "
                     f"{fmt_ms(blib_ms)} ({blib})")
        rows.append(row)
        print(line, flush=True)
        del q, k, v, do, out, out_l, lse_k, o, lse, got, again, plain
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 3: serve qwen3-0.6b at full width
# ---------------------------------------------------------------------------
class StepTimer:
    """Wraps an engine's prefill/decode callables: device-synchronised
    wall time per call."""

    def __init__(self, fn):
        self.fn, self.calls, self.seconds = fn, 0, 0.0

    def __call__(self, *args, **kw):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def serve_once(cfg, model, sv, dev, seed, extra=(), requests=None):
    """Drain ``requests`` (by default ``synthesize_requests(cfg, sv,
    seed)``) plus the ``extra`` requests through a fresh bf16 engine,
    launch counters zeroed just before ``engine.run()`` and read just after
    it."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import ServingEngine, synthesize_requests

    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(cfg, model, sv, device=dev, dtype=torch.bfloat16)
    engine.prefill = pre = StepTimer(engine.prefill)
    engine.decode = dec = StepTimer(engine.decode)
    if requests is None:
        requests = synthesize_requests(cfg, sv, seed, engine.ragged)
    requests = list(requests) + list(extra)
    for r in requests:
        engine.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    check(len(engine.responses) == len(requests),
          f"{len(engine.responses)} of {len(requests)} requests completed")
    for r in requests:
        check(len(engine.responses[r.req]) == r.gen_len,
              f"request {r.req}: {len(engine.responses[r.req])} tokens, "
              f"expected {r.gen_len}")
    prompt = sum(len(r.tokens) for r in requests)
    return dict(engine=engine, wall_s=wall, prefill_s=pre.seconds,
                prefill_calls=pre.calls, decode_s=dec.seconds,
                decode_calls=dec.calls, generated=engine.generated,
                prompt_tokens=prompt, launches=launches,
                tok_per_s=engine.generated / wall)


def run_serve_phase(dev, seed):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), cache_layout="paged",
                              page_size=128)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    torch.cuda.synchronize()
    print(f"  built {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"H {cfg.num_heads}, K {cfg.num_kv_heads}, hd {cfg.head_dim}, "
          f"vocab {cfg.vocab_size} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    # warm-up: cuBLAS handles, allocator and kernel libraries loaded
    serve_once(cfg, model, ServeSpec(batch=2, prompt_len=256, gen=4,
                                     requests=2, prefix_cache=False),
               dev, seed)
    runs = {}
    specs = {
        "a_no_prefix_cache": ServeSpec(batch=8, prompt_len=1024, gen=32,
                                       requests=16, prefix_cache=False),
        "b_prefix_cache": ServeSpec(batch=8, prompt_len=1024, gen=32,
                                    requests=16, prefix_cache=True,
                                    shared_prefix_frac=0.5),
    }
    for name, sv in specs.items():
        r = serve_once(cfg, model, sv, dev, seed)
        eng = r.pop("engine")
        check(r["launches"]["paged_decode_bhd"] > 0,
              f"serve {name}: the paged-decode kernel never launched")
        if not sv.prefix_cache:
            check(r["launches"]["flash_attention_bshd"] > 0,
                  f"serve {name}: the flash kernel never launched")
            check(r["launches"]["flash_attention_bshd"]
                  == cfg.num_layers * r["prefill_calls"],
                  f"serve {name}: flash launches {r['launches']} for "
                  f"{r['prefill_calls']} prefill rounds")
        check(r["launches"]["paged_decode_bhd"]
              == cfg.num_layers * r["decode_calls"],
              f"serve {name}: decode launches {r['launches']} for "
              f"{r['decode_calls']} decode steps")
        r.update(prefix_hits=eng.prefix_hits, cached_tokens=eng.cached_tokens,
                 prefill_tokens=eng.prefill_tokens, cow_copies=eng.cow_copies,
                 evictions=eng.evictions, decode_steps=eng.decode_steps,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del eng                 # its pools must not count in the next peak
        r["host_note"] = host_note()
        runs[name] = r
        print(f"  serve {name}: {sv.requests} requests, {r['generated']} "
              f"tokens generated, {r['prompt_tokens']} prompt tokens "
              f"({r['cached_tokens']} from the prefix cache, "
              f"{r['cow_copies']} CoW copies) in {r['wall_s']:.3f} s = "
              f"{r['tok_per_s']:.1f} generated tok/s{host_note()}; prefill "
              f"{r['prefill_s']:.3f} s over {r['prefill_calls']} rounds, "
              f"decode {r['decode_s']:.3f} s over {r['decode_calls']} steps; "
              f"launches {r['launches']}", flush=True)
    return runs


# the port's own CUDA kernels, by a part of their names that earlier
# designs of each kernel share (the paged decode's split and merge kernels,
# the per-step WKV6 kernel), so a trace of either design reads alike
PORT_KERNELS = {"flash": "flash_fwd_", "paged_decode": "paged_decode_",
                "wkv6": "wkv6_", "rglru": "rglru_scan_",
                "mla_decode": "mla_decode_"}


def trace_window(fn):
    """Run ``fn`` under torch.profiler; returns (wall_s, device-busy s,
    kernel launches, top ops by self CPU time, top device activities by
    time, {port kernel: (launches, device ms)}).  Busy time sums the
    device-side events alone (kernels, copies), so an operator and the
    kernel it launched are not counted twice; launches count the host's
    kernel-launch calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host, dev = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dev.append((e.key, e.count, e.self_device_time_total))
        else:
            host.append((e.key, e.count, e.self_cpu_time_total))
    busy = sum(r[2] for r in dev) * 1e-6
    launches = sum(n for key, n, _ in host if "LaunchKernel" in key)
    ours = {}
    for name, part in PORT_KERNELS.items():
        hits = [(n, us) for key, n, us in dev if part in key]
        if hits:
            ours[name] = (sum(n for n, _ in hits),
                          sum(us for _, us in hits) / 1e3)
    return (wall, busy, launches, sorted(host, key=lambda r: -r[2])[:10],
            sorted(dev, key=lambda r: -r[2])[:8], ours)


def trace_serving(cfg, model, dev, seed, prompt_len=1024):
    """One prefill round and four decode steps of an 8-slot workload of
    prompts up to ``prompt_len`` tokens under the profiler: where the
    time goes, the device's idle share and the kernel launches per
    step."""
    import torch
    from repro_torch.launch.engine import ServingEngine, synthesize_requests
    from repro_torch.launch.spec import ServeSpec

    sv = ServeSpec(batch=8, prompt_len=prompt_len, gen=32, requests=8,
                   prefix_cache=False)
    out = {}
    eng = ServingEngine(cfg, model, sv, device=dev, dtype=torch.bfloat16)
    for r in synthesize_requests(cfg, sv, seed, eng.ragged):
        eng.submit(r)
    for name, steps, fn in (("prefill_round", 1, eng.admit),
                            ("decode_4_steps", 4,
                             lambda: [eng.step() for _ in range(4)])):
        wall, busy, launches, by_cpu, by_dev, ours = trace_window(fn)
        # one stream: busy time beyond the wall means events counted twice
        check(busy <= wall * 1.05, f"traced {name}: device busy {busy} s "
              f"exceeds the window's wall time {wall} s")
        check(busy > 0, f"traced {name}: no device activity recorded")
        out[name] = dict(wall_s=wall, device_busy_s=busy,
                         idle_share=1 - busy / wall,
                         launches_per_step=launches / steps,
                         port_kernels_ms={k: ms for k, (_, ms) in ours.items()})
        print(f"  traced {name}: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy * 1e3:.2f} ms, idle share {out[name]['idle_share']:.3f}"
              f", {launches / steps:.0f} kernel launches a step; the port's "
              f"kernels " + ", ".join(f"{k} x{n} {ms:.3f} ms"
                                      for k, (n, ms) in ours.items()),
              flush=True)
        for key, n, us in by_cpu:
            print(f"    host {key[:56]:<56} x{n:<6} {us / 1e3:9.3f} ms")
        for key, n, us in by_dev:
            print(f"    dev  {key[:56]:<56} x{n:<6} {us / 1e3:9.3f} ms")
    return out


def run_trace_phase(dev, seed):
    """The trace of serve cell (a), qwen3-0.6b."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), cache_layout="paged",
                              page_size=128)
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    return trace_serving(cfg, model, dev, seed)


# ---------------------------------------------------------------------------
# Phase 3b: lockstep serving over the dense cache and identity page tables
# ---------------------------------------------------------------------------
class StepLogits:
    """A ``run_lockstep`` recorder: each step's last-position logits (B,
    V), cloned on the device (no host sync inside the timed loop); with a
    :class:`RouteRecorder` also each step's MoE routing, every token
    live."""

    def __init__(self, routes=None):
        self.steps, self.routes, self.routed = [], routes, []
        if routes is not None:
            routes.sink = []

    def __call__(self, kind, step, logits):
        self.steps.append((kind, logits.float().clone()))
        if self.routes is not None:
            self.routed.append(self.routes.sink)
            self.routes.sink = []

    def calls(self, B, P):
        """The steps in :func:`parity_walk`'s form, on the host."""
        import torch
        out = []
        for i, (kind, logits) in enumerate(self.steps):
            routed = None
            if self.routes is not None:
                n = B * P if kind == "prefill" else B
                routed = (self.routed[i], torch.ones(n, dtype=torch.bool))
            out.append((kind, logits.cpu(), torch.ones(B, dtype=torch.bool),
                        routed))
        return out


def lockstep_once(cfg, model, sv, dev, prompts, layout, record=None):
    """One bf16 ``run_lockstep`` on ``layout``, launch counters zeroed just
    before it and read just after, peak device memory from its start."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.executor import run_lockstep

    lcfg = dataclasses.replace(cfg, cache_layout=layout)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    out = run_lockstep(lcfg, model, sv, device=dev, dtype=torch.bfloat16,
                       prompts=prompts, record=record, quiet=True)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    B, G = sv.batch, sv.gen
    check(tuple(out["tokens"].shape) == (B, G), f"lockstep {cfg.name} "
          f"{layout}: tokens of shape {tuple(out['tokens'].shape)}, not "
          f"({B}, {G})")
    wall = out["prefill_s"] + out["decode_s"]
    return dict(tokens=out["tokens"], prefill_s=out["prefill_s"],
                decode_s=out["decode_s"], decode_steps=G - 1,
                tok_per_s=B * G / wall,
                decode_tok_per_s=B * (G - 1) / out["decode_s"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches)


def check_lockstep_launches(name, r, expected):
    """Every kernel's launches in run ``r`` equal ``expected`` (0 where not
    named)."""
    bad = {k: (n, expected.get(k, 0)) for k, n in r["launches"].items()
           if n != expected.get(k, 0)}
    check(not bad, f"lockstep {name}: launches (run, expected) {bad}")


def trace_lockstep_decode(cfg, model, dev, prompts, G, layout):
    """A bf16 prefill on ``layout``, one decode step untraced, then one
    under the profiler: its wall, busy ms, idle share and launches."""
    import torch
    from repro_torch.models.layers import Ctx
    from repro_torch.models.model import init_cache
    from repro_torch.models.params import cast_params
    from repro_torch.train.steps import make_serve_steps

    lcfg = dataclasses.replace(cfg, cache_layout=layout)
    B, P = prompts.shape
    ctx = Ctx(device=dev, dtype=torch.bfloat16)
    params = cast_params(model, torch.bfloat16)
    prefill, decode = make_serve_steps(lcfg, ctx)
    cache = init_cache(lcfg, B, P + G, paged_tables="identity", device=dev)
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    pos = [torch.tensor(P + i, dtype=torch.int32, device=dev)
           for i in range(2)]
    decode(params, {"tokens": tok}, cache, pos[0])
    wall, busy, launches, _, by_dev, ours = trace_window(
        lambda: decode(params, {"tokens": tok}, cache, pos[1]))
    check(busy > 0, f"traced lockstep {layout} decode step: no device "
          "activity recorded")
    out = dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3,
               idle_share=1 - busy / wall, launches=launches,
               port_kernels_ms={k: ms for k, (_, ms) in ours.items()},
               top_device=[(k[:56], n, us / 1e3) for k, n, us in by_dev[:4]])
    print(f"    traced {layout} decode step: wall {out['wall_ms']:.2f} ms, "
          f"device busy {out['busy_ms']:.2f} ms, idle share "
          f"{out['idle_share']:.3f}, {launches} kernel launches; "
          + ", ".join(f"{k[:40]} x{n} {ms:.3f} ms"
                      for k, n, ms in out["top_device"]), flush=True)
    del params, cache
    return out


def compare_streams(dense, paged, rec_dense):
    """The share of equal tokens of two bf16 runs and, where a row first
    parts, the step and the dense run's top-2 logit margin there."""
    eq = dense["tokens"] == paged["tokens"]
    out = dict(equal_share=eq.float().mean().item(), parted=None)
    bad = (~eq).nonzero()
    if len(bad):
        step = int(bad[:, 1].min())
        row = int(bad[bad[:, 1] == step][0, 0])
        top2 = rec_dense.steps[step][1][row].topk(2).values
        out["parted"] = dict(step=step, row=row,
                             margin=float(top2[0] - top2[1]))
    return out


def lockstep_arch(cfg, model, dev, seed, sv, label, expected):
    """Phase 3b for one config: the dense run, the paged run, their
    launches checked, one traced decode step each, the streams
    compared."""
    from repro_torch.launch.executor import lockstep_inputs

    prompts, _ = lockstep_inputs(cfg, sv, seed)
    runs, recs, traces, parts = {}, {}, {}, {}
    for layout in ("dense", "paged"):
        recs[layout] = StepLogits()
        t0 = time.perf_counter()
        r = lockstep_once(cfg, model, sv, dev, prompts, layout,
                          record=recs[layout])
        parts[f"{layout} run"] = time.perf_counter() - t0
        check_lockstep_launches(f"({label}) {layout}", r, expected[layout])
        runs[layout] = r
        print(f"  ({label}) {cfg.name} {layout}: prefill {r['prefill_s']:.3f}"
              f" s, decode {r['decode_s']:.3f} s for {r['decode_steps']} "
              f"steps ({r['decode_tok_per_s']:.1f} tok/s), "
              f"{r['tok_per_s']:.1f} generated tok/s{host_note()}; peak "
              f"{r['peak_mem_gb']:.2f} GB; launches {r['launches']}",
              flush=True)
        t0 = time.perf_counter()
        traces[layout] = trace_lockstep_decode(cfg, model, dev, prompts,
                                               sv.gen, layout)
        parts[f"{layout} trace"] = time.perf_counter() - t0
    streams = compare_streams(runs["dense"], runs["paged"], recs["dense"])
    print(f"  ({label}) bf16 streams dense vs paged: "
          f"{streams['equal_share']:.4f} of the tokens equal"
          + ("" if streams["parted"] is None else
             f"; first parted at step {streams['parted']['step']}, row "
             f"{streams['parted']['row']}, the dense row's top-2 margin "
             f"{streams['parted']['margin']:.4g}"), flush=True)
    for layout in runs:
        runs[layout].pop("tokens")
        runs[layout]["trace"] = traces[layout]
    return dict(runs, streams=streams, seconds_by_part=parts)


def dense_vs_paged_decode(dev, gen, B=8, K=8, G=2, hd=128, S_max=1056,
                          live=1041, ps=128):
    """The dense decode attention (``decode_attention_torch``, plain, as
    the reference's) over (B, K, S_max, hd) beside ``ops.paged_decode_bhd``
    at the same live keys under identity tables, bf16, CUDA events over
    20 calls; both agree, and each bound is its live K and V read once."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.attention import decode_attention_torch

    dt = torch.bfloat16
    q = torch.randn(B, 1, K * G, hd, device=dev, generator=gen).to(dt)
    k = torch.randn(B, K, S_max, hd, device=dev, generator=gen).to(dt)
    v = torch.randn(B, K, S_max, hd, device=dev, generator=gen).to(dt)
    pos_k = torch.arange(S_max, dtype=torch.int32, device=dev)
    pos_k = torch.where(pos_k < live, pos_k, -1)
    pos_q = torch.tensor(live - 1, dtype=torch.int32, device=dev)
    pps = -(-S_max // ps)
    pad = pps * ps - S_max

    def pages(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.reshape(B, K, pps, ps, hd).transpose(1, 2).reshape(
            B * pps, K, ps, hd).contiguous()
    kp, vp = pages(k), pages(v)
    table = torch.arange(B * pps, dtype=torch.int32, device=dev).reshape(
        B, pps)
    posb = pos_q.reshape(1).expand(B).contiguous()
    scale = hd ** -0.5
    dense = decode_attention_torch(q, k, v, pos_k, pos_q, scale=scale)
    paged = ops.paged_decode_bhd(q, kp, vp, table, posb, scale=scale)
    torch.cuda.synchronize()
    err = compare(paged, dense, DECODE_TOL["bfloat16"],
                  "paged decode vs the dense decode attention")
    dense_ms = time_ms(lambda: decode_attention_torch(
        q, k, v, pos_k, pos_q, scale=scale))
    paged_ms = time_ms(lambda: ops.paged_decode_bhd(q, kp, vp, table, posb,
                                                    scale=scale))
    paged_dev = device_ms(lambda: ops.paged_decode_bhd(q, kp, vp, table,
                                                       posb, scale=scale))
    live_bytes = 2 * B * K * live * hd * 2 + 2 * B * K * G * hd * 2
    full_bytes = 2 * B * K * S_max * hd * 2 + 2 * B * K * G * hd * 2
    out = dict(shape=f"B {B}, K {K}, G {G}, hd {hd}, S_max {S_max}, "
               f"{live} live keys, bf16", max_abs_err=err,
               dense_ms=dense_ms, paged_ms=paged_ms,
               paged_device_ms=paged_dev,
               bound_ms=live_bytes / HBM_BYTES_PER_S * 1e3,
               dense_reads_bound_ms=full_bytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    print(f"  dense decode attention (plain) vs the paged kernel at "
          f"{out['shape']}: {dense_ms:.4f} vs {paged_ms:.4f} ms (kernel "
          f"device {fmt_ms(paged_dev)}); err {err:.3g}; bound "
          f"{out['bound_ms']:.4f} ms (the dense buffer's whole read "
          f"{out['dense_reads_bound_ms']:.4f})", flush=True)
    del q, k, v, kp, vp
    return out


def mla_prefill_flash(dev, gen, B, S, H=128, hd=192, hdv=128):
    """The flash forward at MLA's pair at (l)'s dense prefill shape against
    its plain version; kernel (events), device (profiler), plain, SDPA's
    memory-efficient backend, bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    dt = torch.bfloat16
    q = torch.randn(B, S, H, hd, device=dev, generator=gen).to(dt)
    k = torch.randn(B, S, H, hd, device=dev, generator=gen).to(dt)
    v = torch.randn(B, S, H, hdv, device=dev, generator=gen).to(dt)
    kw = dict(scale=hd ** -0.5, causal=True, window=0, logit_cap=0.0)
    out = ops.flash_attention_bshd(q, k, v, **kw)
    plain = fa.flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = FLASH_TOL["bfloat16"]
    err = compare(out, plain, tol, "flash at MLA's pair, (l)'s prefill")
    used = tol_used(out, plain, tol)
    del out, plain
    ms = time_ms(lambda: ops.flash_attention_bshd(q, k, v, **kw))
    dev_ms = device_ms(lambda: ops.flash_attention_bshd(q, k, v, **kw))
    plain_ms = plain_ms_of(lambda: fa.flash_attention_torch(q, k, v, **kw))
    lib_ms, lib = sdpa_forward_ms(q, k, v, True)
    flops, nbytes = flash_work(B, S, H, H, hd, 2, True, 0, hdv)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    row = dict(label="(l) mla prefill", shape=f"B {B}, S {S}, H {H}, K {H},"
               f" hd {hd}, hdv {hdv}, bf16, causal", max_abs_err=err,
               tol_used=used, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library=lib, bound_ms=bound_ms,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"  flash at MLA's pair, (l)'s prefill ({row['shape']}): err "
          f"{err:.3g} ({used:.3f} of the tolerance) kernel {ms:.4f} ms "
          f"(device {fmt_ms(dev_ms)}) plain {plain_ms:.4f} ms library "
          f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms ({lib}) "
          f"bound {bound_ms:.4f} ms", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def lockstep_parity(cfg, dev, seed, routes=False):
    """fp32 with TF32 off, the same weights and numpy prompts: cuda dense,
    cuda paged and cpu dense.  Each pair's live logits within tolerance up
    to the first step where an argmax (or with ``routes`` an MoE routing)
    differs, which must be a tie; every row generates G tokens."""
    import torch
    from repro_torch.launch.executor import lockstep_inputs, run_lockstep
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sv = ServeSpec(**LOCKSTEP_PARITY)
    cpu_model = build_model(cfg, device="cpu", seed=seed)
    gpu_model = build_model(cfg, device=dev, seed=seed)
    check(models_equal(cpu_model, gpu_model), f"lockstep parity {cfg.name}: "
          "the model built on cuda differs from the one built on cpu")
    prompts, _ = lockstep_inputs(cfg, sv, seed)
    recorder = RouteRecorder(moe.route) if routes else None
    if recorder is not None:
        moe.route = recorder
    recs, tokens = {}, {}
    try:
        for name, model, d, layout in (("cpu dense", cpu_model, "cpu",
                                        "dense"),
                                       ("cuda dense", gpu_model, dev,
                                        "dense"),
                                       ("cuda paged", gpu_model, dev,
                                        "paged")):
            rec = StepLogits(recorder)
            out = run_lockstep(dataclasses.replace(cfg, cache_layout=layout),
                               model, sv, device=d, dtype=torch.float32,
                               prompts=prompts, record=rec, quiet=True)
            check(tuple(out["tokens"].shape) == (sv.batch, sv.gen),
                  f"lockstep parity {name}: tokens "
                  f"{tuple(out['tokens'].shape)}")
            recs[name] = rec.calls(sv.batch, sv.prompt_len)
            tokens[name] = out["tokens"]
    finally:
        if recorder is not None:
            moe.route = recorder.fn
    del cpu_model, gpu_model
    pairs = {}
    for a, b in (("cpu dense", "cuda dense"), ("cpu dense", "cuda paged"),
                 ("cuda dense", "cuda paged")):
        err, compared, diverged, margin = parity_walk(recs[a], recs[b])
        check(err <= PARITY_LOGIT_TOL, f"lockstep parity {cfg.name} {a} vs "
              f"{b}: live logits differ by {err} > {PARITY_LOGIT_TOL}")
        same = torch.equal(tokens[a], tokens[b])
        if diverged is not None:
            check(diverged[3] <= PARITY_TIE_TOL, f"lockstep parity "
                  f"{cfg.name} {a} vs {b}: parted at {diverged}, its "
                  f"margin above {PARITY_TIE_TOL}")
        else:
            check(same, f"lockstep parity {cfg.name} {a} vs {b}: streams "
                  "differ but no recorded step does")
        pairs[f"{a} vs {b}"] = dict(logit_err=err, steps_compared=compared,
                                    streams_equal=same, diverged=diverged,
                                    router_margin=margin)
        print(f"  lockstep parity fp32 ({cfg.name}, {cfg.num_layers} layers)"
              f" {a} vs {b}: live logit max err {err:.3g} over {compared} of"
              f" {len(recs[a])} steps (tol {PARITY_LOGIT_TOL}); streams "
              f"{'equal' if same else f'part at a tie {diverged}'}"
              + ("" if margin is None else
                 f"; smallest router margin {margin:.3g}"), flush=True)
    return dict(pairs=pairs, seconds=time.perf_counter() - t0)


def run_lockstep_phase(dev, seed, gen):
    """(k) and (l), each dense then paged, then the fp32 parity."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models.model import build_model

    out = {}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), page_size=128)
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    sv = ServeSpec(**LOCKSTEP_K)
    L, steps = cfg.num_layers, sv.gen - 1
    lockstep_once(cfg, model, ServeSpec(batch=2, prompt_len=128, gen=4),
                  dev, None, "dense")                         # warm-up
    t_setup = time.perf_counter() - t0
    out["k"] = lockstep_arch(cfg, model, dev, seed, sv, "k", {
        "dense": {"flash_attention_bshd": L},
        "paged": {"flash_attention_bshd": L, "paged_decode_bhd": L * steps}})
    out["k"]["seconds_by_part"]["build and warm-up"] = t_setup
    t1 = time.perf_counter()
    out["k"]["dense_decode"] = dense_vs_paged_decode(dev, gen)
    out["k"]["seconds_by_part"]["decode timing"] = time.perf_counter() - t1
    del model
    out["k"]["seconds"] = time.perf_counter() - t0
    print(f"  (k) seconds by part {out['k']['seconds_by_part']}", flush=True)

    t0 = time.perf_counter()
    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, num_layers=3, page_size=128)
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    sv = ServeSpec(**LOCKSTEP_L)
    L, steps = cfg.num_layers, sv.gen - 1
    out["l"] = lockstep_arch(cfg, model, dev, seed, sv, "l", {
        "dense": {"flash_attention_bshd": L},
        "paged": {"mla_paged_decode_bhd": L * steps}})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["l"]["mla_flash"] = mla_prefill_flash(dev, gen, sv.batch,
                                              sv.prompt_len)
    out["l"]["seconds_by_part"]["flash timing"] = time.perf_counter() - t1
    out["l"]["seconds"] = time.perf_counter() - t0
    print(f"  (l) seconds by part {out['l']['seconds_by_part']}", flush=True)

    t0 = time.perf_counter()
    kcfg = dataclasses.replace(get_config("qwen3-0.6b"),
                               num_layers=LOCKSTEP_PARITY_LAYERS,
                               page_size=128, dtype="float32")
    lcfg = dataclasses.replace(cfg, num_layers=2, page_size=16,
                               dtype="float32",
                               vocab_size=SERVE_PARITY_VOCAB,
                               **SERVE_PARITY_FFN[cfg.name])
    out["parity"] = {"k": lockstep_parity(kcfg, dev, seed),
                     "l": lockstep_parity(lcfg, dev, seed, routes=True)}
    out["parity"]["seconds"] = time.perf_counter() - t0
    print(f"  lockstep parity {out['parity']['k']['seconds']:.1f} s (k), "
          f"{out['parity']['l']['seconds']:.1f} s (l)", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4: cuda vs cpu parity in fp32, then snapshot/restore on cuda
# ---------------------------------------------------------------------------
class LogitRecorder:
    """Wraps an engine's prefill or decode step and appends, per call, to
    the list ``calls`` the step's kind, the last-position logits on the
    host, which rows were live (prefill: length > 0; decode: position
    >= 0; other rows hold garbage) and, with a :class:`RouteRecorder`, the
    routing of every MoE layer in the step with the mask of its live
    tokens."""

    def __init__(self, fn, kind, calls, routes=None):
        self.fn, self.kind, self.calls, self.routes = fn, kind, calls, routes

    def __call__(self, params, batch, cache, rows=None, *rest):
        import torch
        if self.routes is not None:
            self.routes.sink = []
        if rows is None:     # an encoder-decoder's prefill: one slot, live
            logits, cache = self.fn(params, batch, cache)
            self.calls.append((self.kind, logits[:, -1].float().cpu(),
                               torch.ones(1, dtype=torch.bool), None))
            return logits, cache
        logits, cache = self.fn(params, batch, cache, rows, *rest)
        live = (rows > 0) if self.kind == "prefill" else (rows >= 0)
        routed = None
        if self.routes is not None:
            S = batch["tokens"].shape[1]
            tok = torch.arange(S, device=rows.device)[None, :] < rows[:, None] \
                if self.kind == "prefill" else live[:, None]
            routed = (self.routes.sink, tok.reshape(-1).cpu())
            self.routes.sink = None
        self.calls.append((self.kind, logits[:, -1].float().cpu(),
                           live.cpu(), routed))
        return logits, cache


class RouteRecorder:
    """Wraps ``repro_torch.models.moe.route`` (router logits in) or, with
    ``of_probs``, ``moe._top_k`` (the training path's; probabilities in):
    while ``sink`` is a list, each call appends the chosen experts of
    every token (sorted, on the host) and the margin between its k-th and
    (k+1)-th router probability."""

    def __init__(self, fn, of_probs=False):
        self.fn, self.sink, self.of_probs = fn, None, of_probs

    def __call__(self, logits, k):
        import torch
        weights, experts = self.fn(logits, k)
        if self.sink is not None:
            probs = logits if self.of_probs else torch.softmax(logits, -1)
            top = probs.topk(k + 1, dim=-1).values
            self.sink.append((experts.sort(dim=-1).values.cpu(),
                              (top[:, k - 1] - top[:, k]).cpu()))
        return weights, experts


def route_flip(routed_a, routed_b):
    """(first live token whose expert set differs, its margin on the
    first device, the smallest live-token margin) of one step's routing
    on two devices; the token is None when every live token routed the
    same."""
    calls_a, tok = routed_a
    calls_b, _ = routed_b
    check(len(calls_a) == len(calls_b), "parity: the devices routed a "
          "different number of MoE layers")
    low = float("inf")
    for (ea, ma), (eb, _) in zip(calls_a, calls_b):
        low = min(low, ma[tok].min().item())
        bad = ((ea != eb).any(dim=-1) & tok).nonzero()
        if len(bad):
            t = int(bad[0])
            return t, ma[t].item(), low
    return None, None, low


def parity_walk(calls_a, calls_b):
    """Walks two engines' recorded steps in order.  Returns (max live-row
    logit difference, steps compared, first divergence or None, smallest
    router margin of a live token or None).  The walk stops after the
    first step where a live row's argmax differs (kind, step, row, top-2
    gap): that step still ran on equal inputs, the steps after it do not.
    With recorded routing it stops before the logits of the first step
    where a live token chose other experts ("route", step, token, router
    margin): from that layer on the two devices computed different
    functions."""
    import torch
    err, diverged, margin = 0.0, None, None
    for i, ((kind, a, live, ra), (kind_b, b, live_b, rb)) in enumerate(
            zip(calls_a, calls_b)):
        check(kind == kind_b and torch.equal(live, live_b),
              f"parity: step {i} is a {kind} on one device and a {kind_b} "
              "on the other, or its live rows differ")
        if ra is not None:
            tok, m, low = route_flip(ra, rb)
            margin = low if margin is None else min(margin, low)
            if tok is not None:
                return err, i + 1, ("route", i, tok, m), margin
        if live.any():
            err = max(err, (a - b)[live].abs().max().item())
        diff = ((a.argmax(-1) != b.argmax(-1)) & live).nonzero()
        if len(diff):
            row = int(diff[0])
            top2 = a[row].topk(2).values
            diverged = (kind, i, row, float(top2[0] - top2[1]))
            return err, i + 1, diverged, margin
    return err, min(len(calls_a), len(calls_b)), diverged, margin


def caches_equal(a, b) -> bool:
    """Every leaf of two host or device caches (lists per layer, or one
    tensor) equal byte for byte."""
    import torch
    if set(a) != set(b):
        return False
    for name in a:
        xs, ys = (a[name], b[name]) if isinstance(a[name], list) \
            else ([a[name]], [b[name]])
        if len(xs) != len(ys) or not all(
                torch.equal(x.cpu(), y.cpu()) for x, y in zip(xs, ys)):
            return False
    return True


def models_equal(a, b) -> bool:
    """Every parameter of two models equal bit for bit (``b`` may live on
    another device)."""
    import torch
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    return pa.keys() == pb.keys() and all(
        torch.equal(t, pb[n].detach().cpu()) for n, t in pa.items())


def parity_run(cfg, sv, dev, seed, requests=None, routes=False):
    """The same weights and requests (``requests``, by default
    ``synthesize_requests``) through the engine on ``cuda`` and on ``cpu``
    in fp32 (TF32 off): live logits of every step within tolerance, then
    snapshot/restore on ``cuda`` byte-identical, every cache leaf (KV or
    latent pools or RWKV state, and the page table) included.  With
    ``routes`` the MoE routing of every live token is compared too."""
    import torch
    from repro_torch.launch.engine import ServingEngine, synthesize_requests
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = build_model(cfg, device="cpu", seed=seed)
    gpu_model = build_model(cfg, device=dev, seed=seed)
    check(models_equal(cpu_model, gpu_model), f"parity {cfg.name}: the "
          "model built on cuda differs from the one built on cpu")
    if requests is None:
        requests = synthesize_requests(cfg, sv, seed,
                                       ragged=not cfg.is_encoder_decoder)
    recorder = RouteRecorder(moe.route) if routes else None
    streams, recs, stats = {}, {}, {}
    if recorder is not None:
        moe.route = recorder
    try:
        for name, model, d in (("cpu", cpu_model, "cpu"),
                               ("cuda", gpu_model, dev)):
            eng = ServingEngine(cfg, model, sv, device=d, dtype=torch.float32)
            recs[name] = []
            eng.prefill = LogitRecorder(eng.prefill, "prefill", recs[name],
                                        recorder)
            eng.decode = LogitRecorder(eng.decode, "decode", recs[name],
                                       recorder)
            for r in requests:
                eng.submit(r)
            eng.run()
            streams[name] = eng.responses
            stats[name] = dict(evictions=eng.evictions,
                               cow_copies=eng.cow_copies,
                               prefix_hits=eng.prefix_hits,
                               cached_tokens=eng.cached_tokens)
    finally:
        if recorder is not None:
            moe.route = recorder.fn
    del cpu_model
    # the schedule depends on lengths only, so the steps line up; every
    # step up to the first differing argmax of a live row is compared
    perr, compared, diverged, margin = parity_walk(recs["cpu"], recs["cuda"])
    check(perr <= PARITY_LOGIT_TOL, f"parity: live logits differ by {perr} "
          f"> {PARITY_LOGIT_TOL} over {compared} steps")
    if diverged is not None and diverged[0] == "route":
        check(diverged[3] <= PARITY_TIE_TOL, f"parity: a live token routed "
              f"differently at {diverged}, its router margin above "
              f"{PARITY_TIE_TOL}")
    elif streams["cpu"] == streams["cuda"]:
        check(diverged is None and len(recs["cpu"]) == len(recs["cuda"]),
              f"parity: equal token streams but steps part at {diverged}")
    else:
        check(diverged is not None, "parity: token streams differ but no "
              "recorded step differs")
        check(diverged[3] <= PARITY_TIE_TOL, f"parity: streams part at "
              f"{diverged} with a top-2 gap above {PARITY_TIE_TOL}")
    routing = "" if margin is None else \
        f"; smallest router margin of a live token {margin:.3g}"
    print(f"  parity fp32 cuda vs cpu ({cfg.name}, {cfg.num_layers} layers): "
          f"live logit max err {perr:.3g} over "
          f"{compared} of {len(recs['cuda'])} prefill and decode steps "
          f"(tol {PARITY_LOGIT_TOL}); token streams "
          f"{'equal' if diverged is None else f'part at a tie {diverged}'} "
          f"over {len(requests)} requests{routing}; engine {stats['cuda']}",
          flush=True)

    # snapshot/restore on cuda: interrupt after one round and two steps
    eng = ServingEngine(cfg, gpu_model, sv, device=dev, dtype=torch.float32)
    for r in requests:
        eng.submit(r)
    eng.admit()
    eng.step()
    eng.step()
    snap = eng.snapshot()
    eng.run()
    fresh = ServingEngine(cfg, gpu_model, sv, device=dev, dtype=torch.float32)
    fresh.restore(snap)
    check(caches_equal(snap["cache"], fresh.snapshot()["cache"]),
          "restore is not byte-identical")
    fresh.run()
    check(fresh.responses == eng.responses,
          "restored engine answered differently")
    check(caches_equal(eng.cache, fresh.cache),
          "restored run left a different cache")
    secs = time.perf_counter() - t_start
    print(f"  snapshot/restore on cuda: {len(fresh.responses)} responses and "
          f"the final cache ({', '.join(sorted(eng.cache))}) byte-identical;"
          f" parity and snapshot/restore took {secs:.1f} s", flush=True)
    out = dict(logit_err=perr, steps_compared=compared, diverged=diverged,
               seconds=secs)
    if routes:
        out.update(router_margin=margin, engine=stats["cuda"])
    return out


def run_parity_phase(dev, seed):
    """qwen3-0.6b at full width and 4 layers, prompts up to 384 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.spec import ServeSpec

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), num_layers=4,
                              cache_layout="paged", page_size=128,
                              dtype="float32")
    return parity_run(cfg, ServeSpec(batch=4, prompt_len=384, gen=8,
                                     requests=6, prefix_cache=False),
                      dev, seed)


# ---------------------------------------------------------------------------
# Phase 5: rwkv6-7b (the WKV6 kernel's path)
# ---------------------------------------------------------------------------
def run_rwkv_phase(dev, seed):
    """Serve rwkv6-7b at full width in bf16 (no WKV6 launch writes state
    checkpoints: those are training's), trace it, then fp32 parity and
    snapshot/restore at 2 layers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models.model import build_model
    from repro_torch.models.params import count_params

    cfg = dataclasses.replace(get_config("rwkv6-7b"), cache_layout="paged",
                              page_size=128)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"  built {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{count_params(cfg) / 1e9:.2f} B parameters without the "
          f"embeddings, in {build_s:.2f} s (drawn on the card)", flush=True)
    serve_once(cfg, model, ServeSpec(batch=2, prompt_len=256, gen=4,
                                     requests=2, prefix_cache=False),
               dev, seed)                                      # warm-up
    sv = ServeSpec(batch=8, prompt_len=1024, gen=32, requests=16,
                   prefix_cache=False)
    segs = []                    # each launch's checkpoint segment (0: none)
    fwd = wkv.wkv6_cuda

    def recorded(*a, seg=0, **kw):
        segs.append(seg)
        return fwd(*a, seg=seg, **kw)
    wkv.wkv6_cuda = recorded
    try:
        r = serve_once(cfg, model, sv, dev, seed)
    finally:
        wkv.wkv6_cuda = fwd
    eng = r.pop("engine")
    L = cfg.num_layers
    check(r["launches"]["wkv6_bshn"] > 0,
          "serve rwkv6-7b: the WKV6 kernel never launched")
    check(len(segs) == r["launches"]["wkv6_bshn"] and not any(segs)
          and r["launches"]["wkv6_bwd"] == 0,
          f"serve rwkv6-7b: {sum(map(bool, segs))} WKV6 launches wrote "
          f"checkpoints, backward launches {r['launches']['wkv6_bwd']}")
    check(r["launches"]["wkv6_bshn"] == L * r["prefill_calls"],
          f"serve rwkv6-7b: WKV6 launches {r['launches']} for "
          f"{r['prefill_calls']} prefill rounds")
    check(r["launches"]["flash_attention_bshd"] == 0
          and r["launches"]["paged_decode_bhd"] == 0,
          f"serve rwkv6-7b: attention kernels launched {r['launches']}")
    r.update(decode_steps=eng.decode_steps, evictions=eng.evictions,
             prefill_tokens=eng.prefill_tokens,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng
    print(f"  serve rwkv6-7b: {sv.requests} requests, {r['generated']} tokens "
          f"generated, {r['prompt_tokens']} prompt tokens in "
          f"{r['wall_s']:.3f} s = {r['tok_per_s']:.1f} generated "
          f"tok/s{host_note()}; "
          f"prefill {r['prefill_s']:.3f} s over {r['prefill_calls']} rounds, "
          f"decode {r['decode_s']:.3f} s over {r['decode_calls']} steps; "
          f"peak memory {r['peak_mem_gb']:.2f} GB; launches {r['launches']}",
          flush=True)
    print("[rwkv trace] profiler on (not used for the numbers above)",
          flush=True)
    trace = trace_serving(cfg, model, dev, seed)
    del model
    torch.cuda.empty_cache()
    print("[rwkv parity]", flush=True)
    # page size 16: rounds pad to 48..96 steps, so the plain version on the
    # cpu crosses a 32-step chunk and a ragged tail; rows are padded too
    pcfg = dataclasses.replace(cfg, num_layers=2, page_size=16,
                               dtype="float32",
                               vocab_size=SERVE_PARITY_VOCAB,
                               **SERVE_PARITY_FFN[cfg.name])
    parity = parity_run(pcfg, ServeSpec(batch=4, prompt_len=90, gen=8,
                                        requests=6, prefix_cache=False),
                        dev, seed)
    return dict(serve=r, trace=trace, parity=parity, build_s=build_s,
                parity_cuts="2 layers, d_ff 4,096, "
                f"page 16, vocabulary {SERVE_PARITY_VOCAB:,}")


# ---------------------------------------------------------------------------
# Phase 6: recurrentgemma-9b (the RG-LRU kernel's path, flash at hd 256)
# ---------------------------------------------------------------------------
def run_recurrentgemma_phase(dev, seed):
    """Serve recurrentgemma-9b at full width in bf16, trace it, then fp32
    parity and snapshot/restore at 3 layers with the window cut to 64."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Request
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models.model import build_model
    from repro_torch.models.params import count_params

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              cache_layout="paged", page_size=128)
    kinds = cfg.layer_kinds()
    n_rec, n_loc = kinds.count("recurrent"), kinds.count("local")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    torch.cuda.synchronize()
    print(f"  built {cfg.name}: {cfg.num_layers} layers ({n_rec} RG-LRU, "
          f"{n_loc} local attention), d {cfg.d_model}, R {cfg.rnn_width}, "
          f"H {cfg.num_heads}, K {cfg.num_kv_heads}, hd {cfg.head_dim}, "
          f"window {cfg.window_size}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, "
          f"{count_params(cfg, include_embed=True) / 1e9:.2f} B parameters "
          f"({count_params(cfg) / 1e9:.2f} B without the "
          f"embeddings), in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card",
          flush=True)
    serve_once(cfg, model, ServeSpec(batch=2, prompt_len=2048, gen=4,
                                     requests=2, prefix_cache=False),
               dev, seed)                                      # warm-up
    sv = ServeSpec(batch=8, prompt_len=2560, gen=32, requests=16,
                   prefix_cache=False)
    # one more request pinned at 2,040 prompt tokens: its decode positions
    # 2,040..2,071 cross the 2,048-slot ring, so decode wraps it
    rng = np.random.default_rng(seed + 1)
    pinned = Request(req=sv.requests, tokens=rng.integers(
        0, cfg.vocab_size, size=2040), gen_len=sv.gen)
    r = serve_once(cfg, model, sv, dev, seed, extra=[pinned])
    eng = r.pop("engine")
    rounds = r["prefill_calls"]
    check(rounds > 0 and r["launches"]["rglru_scan_bsr"] == n_rec * rounds,
          f"serve {cfg.name}: RG-LRU launches {r['launches']} for "
          f"{rounds} prefill rounds of {n_rec} recurrent layers")
    check(r["launches"]["flash_attention_bshd"] == n_loc * rounds,
          f"serve {cfg.name}: flash launches {r['launches']} for "
          f"{rounds} prefill rounds of {n_loc} local layers")
    check(r["launches"]["paged_decode_bhd"] == 0
          and r["launches"]["wkv6_bshn"] == 0,
          f"serve {cfg.name}: other kernels launched {r['launches']}")
    check(len(eng.responses[pinned.req]) == pinned.gen_len,
          "the pinned request did not complete")
    r.update(decode_steps=eng.decode_steps, evictions=eng.evictions,
             prefill_tokens=eng.prefill_tokens,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_per_round={k: v / rounds
                                 for k, v in r["launches"].items()})
    del eng
    print(f"  serve {cfg.name}: {sv.requests + 1} requests, "
          f"{r['generated']} tokens generated, {r['prompt_tokens']} prompt "
          f"tokens in {r['wall_s']:.3f} s = {r['tok_per_s']:.1f} generated "
          f"tok/s{host_note()}; prefill {r['prefill_s']:.3f} s over {rounds} "
          f"rounds, "
          f"decode {r['decode_s']:.3f} s over {r['decode_calls']} steps; "
          f"peak memory {r['peak_mem_gb']:.2f} GB; launches {r['launches']} "
          f"({r['launches_per_round']} a prefill round)", flush=True)
    print("[recurrentgemma trace] profiler on (not used for the numbers "
          "above)", flush=True)
    trace = trace_serving(cfg, model, dev, seed, prompt_len=2560)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print("[recurrentgemma parity]", flush=True)
    # full width, layers (R, R, L); the window cut to 64 and pages of 16 so
    # prompts of 75..150 tokens wrap the ring in prefill on the cpu too
    pcfg = dataclasses.replace(cfg, num_layers=3, window_size=64,
                               page_size=16, dtype="float32",
                               vocab_size=SERVE_PARITY_VOCAB,
                               **SERVE_PARITY_FFN[cfg.name])
    parity = parity_run(pcfg, ServeSpec(batch=4, prompt_len=150, gen=8,
                                        requests=6, prefix_cache=False),
                        dev, seed)
    return dict(serve=r, trace=trace, parity=parity,
                parity_cuts="3 layers (R, R, L), window 64, d_ff 4,096, "
                f"page 16, vocabulary {SERVE_PARITY_VOCAB:,}")


# ---------------------------------------------------------------------------
# Phase 7: deepseek-v2 (the MLA latent decode kernel's path)
# ---------------------------------------------------------------------------
def run_deepseek_phase(dev, seed):
    """Serve deepseek-v2-236b at full width cut to 3 layers in bf16, trace
    it, then fp32 parity (2 layers, 8 experts, prefix cache, an eviction)
    and snapshot/restore of the latent pools."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Request, synthesize_requests
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models.model import build_model
    from repro_torch.models.params import count_params

    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, num_layers=3, cache_layout="paged",
                              page_size=128)
    cut = (f"depth {full.num_layers} -> {cfg.num_layers} layers (the dense "
           f"first layer and {cfg.num_layers - cfg.first_k_dense} MoE "
           "layers), every width kept")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    torch.cuda.synchronize()
    print(f"  built {cfg.name}, {cut}: d {cfg.d_model}, H {cfg.num_heads}, "
          f"q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, nope "
          f"{cfg.qk_nope_head_dim}, rope {cfg.qk_rope_head_dim}, v "
          f"{cfg.v_head_dim}, {cfg.num_experts} experts top-"
          f"{cfg.num_experts_per_tok} + {cfg.num_shared_experts} shared of "
          f"{cfg.moe_d_ff}, dense d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{count_params(cfg, include_embed=True) / 1e9:.2f} B parameters "
          f"({count_params(cfg) / 1e9:.2f} B without the embeddings; "
          f"{count_params(full) / 1e9:.1f} B at 60 layers), in "
          f"{time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card",
          flush=True)
    serve_once(cfg, model, ServeSpec(batch=2, prompt_len=256, gen=4,
                                     requests=2, prefix_cache=False),
               dev, seed)                                      # warm-up
    sv = ServeSpec(batch=8, prompt_len=1024, gen=32, requests=16,
                   prefix_cache=False)
    r = serve_once(cfg, model, sv, dev, seed)
    eng = r.pop("engine")
    steps = r["decode_calls"]
    check(steps > 0 and r["launches"]["mla_paged_decode_bhd"]
          == cfg.num_layers * steps,
          f"serve {cfg.name}: MLA decode launches {r['launches']} for "
          f"{steps} decode steps of {cfg.num_layers} layers")
    check(all(r["launches"][k] == 0 for k in r["launches"]
              if k != "mla_paged_decode_bhd"),
          f"serve {cfg.name}: other kernels launched {r['launches']}")
    r.update(decode_steps=eng.decode_steps, evictions=eng.evictions,
             prefill_tokens=eng.prefill_tokens,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_per_step={k: v / steps
                                for k, v in r["launches"].items()})
    del eng
    check(r["peak_mem_gb"] < PEAK_MEM_LIMIT_GB,
          f"serve {cfg.name}: peak device memory {r['peak_mem_gb']:.2f} GB "
          f">= {PEAK_MEM_LIMIT_GB} GB")
    print(f"  serve {cfg.name}: {sv.requests} requests, {r['generated']} "
          f"tokens generated, {r['prompt_tokens']} prompt tokens in "
          f"{r['wall_s']:.3f} s = {r['tok_per_s']:.1f} generated "
          f"tok/s{host_note()}; "
          f"prefill {r['prefill_s']:.3f} s over {r['prefill_calls']} rounds, "
          f"decode {r['decode_s']:.3f} s over {steps} steps; peak memory "
          f"{r['peak_mem_gb']:.2f} GB; launches {r['launches']} "
          f"({r['launches_per_step']} a decode step)", flush=True)
    print("[deepseek trace] profiler on (not used for the numbers above)",
          flush=True)
    trace = trace_serving(cfg, model, dev, seed, prompt_len=1024)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print("[deepseek parity]", flush=True)
    # full width, 2 layers (dense, MoE), experts cut to 8 (top-6 and the 2
    # shared kept) and the dense FFN to 1,536, as the train parity cuts
    # them; pages of 16; the prefix cache on,
    # so every prefill is the chunked walk over the latent pool; one more
    # request, queued right after request 0, shares its first 40 tokens (2
    # whole pages and a partial one: a prefix hit and copy-on-write); 18
    # pages for 4 slots force an eviction
    pcfg = dataclasses.replace(cfg, num_layers=2, page_size=16,
                               dtype="float32",
                               vocab_size=SERVE_PARITY_VOCAB,
                               **SERVE_PARITY_FFN[cfg.name])
    psv = ServeSpec(batch=4, prompt_len=150, gen=8, requests=6,
                    page_budget=18, overcommit=2.0, prefix_cache=True)
    requests = synthesize_requests(pcfg, psv, seed)
    rng = np.random.default_rng(seed + 1)
    shared = Request(req=psv.requests, tokens=np.concatenate(
        [requests[0].tokens[:40], rng.integers(0, pcfg.vocab_size, size=60)]),
        gen_len=psv.gen)
    parity = parity_run(pcfg, psv, dev, seed, routes=True,
                        requests=requests[:1] + [shared] + requests[1:])
    check(parity["engine"]["evictions"] > 0,
          f"deepseek parity: no eviction ({parity['engine']})")
    check(parity["engine"]["cow_copies"] > 0
          and parity["engine"]["prefix_hits"] > 0,
          f"deepseek parity: no prefix hit or copy-on-write "
          f"({parity['engine']})")
    return dict(serve=r, trace=trace, parity=parity, cut=cut,
                parity_cuts="2 layers (dense, MoE), 8 experts, dense d_ff "
                f"1,536, page 16, vocabulary {SERVE_PARITY_VOCAB:,}")


# ---------------------------------------------------------------------------
# Phase 7b: the dense decoders of the port's last slice
# ---------------------------------------------------------------------------
def run_dense_serve_phase(dev, seed, arch, layers, *, label,
                          prompt_len=1024, max_len=None, prefix_cache=False,
                          after=None):
    """Serve ``arch`` at full width cut to ``layers`` in bf16: 8 slots, 16
    requests, prompts in [prompt_len / 2, prompt_len], 16 to 32 new tokens
    (seed 0, as (a)-(e)); with ``max_len`` the engine is sized for it (a
    local layer's ring must hold its window, R5) while the requests keep
    their prompt length.  Every request completes its budget; a prefill
    round launches the flash kernel once a layer, a decode step the paged
    decode once a global layer (a local layer decodes from its ring in
    plain PyTorch, as the reference's local decode is plain jnp), and no
    other kernel runs; peak memory at most PEAK_MEM_LIMIT_GB.  A vision
    config is served text-only, as the reference's engine serves it, and
    its engine must turn off the ``prefix_cache`` asked for.  ``after(cfg,
    model, dev, seed)`` runs on the same weights once the engine is gone,
    its result under ``"after"``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import GLOBAL_ATTN
    from repro_torch.launch.engine import synthesize_requests
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models.model import build_model
    from repro_torch.models.params import count_params

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers, cache_layout="paged",
                              page_size=128)
    kinds = cfg.layer_kinds()
    n_glob = kinds.count(GLOBAL_ATTN)
    cut = (f"depth {full.num_layers} -> {layers} layers, every width kept"
           if layers < full.num_layers else f"all {layers} layers")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    torch.cuda.synchronize()
    print(f"  built {cfg.name}, {cut}: d {cfg.d_model}, H {cfg.num_heads}, "
          f"K {cfg.num_kv_heads}, hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}"
          + (f", window {cfg.window_size} on {layers - n_glob} local layers"
             if layers > n_glob else "")
          + f", {count_params(cfg, include_embed=True) / 1e9:.2f} B "
          f"parameters ({count_params(full, include_embed=True) / 1e9:.1f} B "
          f"at {full.num_layers} layers), in {time.perf_counter() - t0:.2f} "
          f"s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card",
          flush=True)
    P = max_len - 32 if max_len else prompt_len
    warm = ServeSpec(batch=2, prompt_len=P, gen=32, requests=2,
                     prefix_cache=False)
    serve_once(cfg, model, warm, dev, seed, requests=synthesize_requests(
        cfg, ServeSpec(batch=2, prompt_len=min(256, prompt_len), gen=4,
                       requests=2), seed))
    sv = ServeSpec(batch=8, prompt_len=P, gen=32, requests=16,
                   prefix_cache=prefix_cache)
    requests = synthesize_requests(cfg, dataclasses.replace(
        sv, prompt_len=prompt_len), seed)
    r = serve_once(cfg, model, sv, dev, seed, requests=requests)
    eng = r.pop("engine")
    check(not (cfg.frontend == "vision" and eng.prefix_cache),
          f"serve {cfg.name}: the engine kept the prefix cache on under the "
          "vision frontend")
    rounds, steps = r["prefill_calls"], r["decode_calls"]
    check(rounds > 0 and r["launches"]["flash_attention_bshd"]
          == layers * rounds,
          f"serve {cfg.name}: flash launches {r['launches']} for {rounds} "
          f"prefill rounds of {layers} layers")
    check(steps > 0 and r["launches"]["paged_decode_bhd"] == n_glob * steps,
          f"serve {cfg.name}: paged decode launches {r['launches']} for "
          f"{steps} decode steps of {n_glob} global layers")
    check(all(n == 0 for k, n in r["launches"].items() if k not in (
        "flash_attention_bshd", "paged_decode_bhd")),
          f"serve {cfg.name}: other kernels launched {r['launches']}")
    r.update(layers=layers, cut=cut, max_len=eng.max_len,
             decode_steps=eng.decode_steps, evictions=eng.evictions,
             prefill_tokens=eng.prefill_tokens,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_per_round=r["launches"]["flash_attention_bshd"]
             / rounds,
             launches_per_step=r["launches"]["paged_decode_bhd"] / steps,
             prefix_cache=(prefix_cache, eng.prefix_cache))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if after is not None:
        r["after"] = after(cfg, model, dev, seed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    check(r["peak_mem_gb"] <= PEAK_MEM_LIMIT_GB,
          f"serve {cfg.name}: peak device memory {r['peak_mem_gb']:.2f} GB "
          f"> {PEAK_MEM_LIMIT_GB} GB")
    print(f"  serve ({label}) {cfg.name}: {sv.requests} requests (prompts "
          f"up to {prompt_len}, engine max_len {r['max_len']}), "
          f"{r['generated']} tokens generated, {r['prompt_tokens']} prompt "
          f"tokens in {r['wall_s']:.3f} s = {r['tok_per_s']:.1f} generated "
          f"tok/s{host_note()}; prefill {r['prefill_s']:.3f} s over {rounds} "
          f"rounds, "
          f"decode {r['decode_s']:.3f} s over {steps} steps; peak memory "
          f"{r['peak_mem_gb']:.2f} GB; launches {r['launches']} (flash "
          f"{r['launches_per_round']:g} a prefill round, paged decode "
          f"{r['launches_per_step']:g} a decode step)"
          + (f"; prefix cache asked {prefix_cache}, kept "
             f"{r['prefix_cache'][1]}" if prefix_cache else ""), flush=True)
    return r


# ---------------------------------------------------------------------------
# Phase 7b, (i): internvl2-76b's vision frontend on the card
# ---------------------------------------------------------------------------
def frontend_inputs(cfg, rows, prompt, seed):
    """(tokens (rows, prompt) int64, lengths (rows,) int32 in [prompt / 2,
    prompt], the first row's the longest, patch embeddings (rows, F, d)
    fp32 0.02·N(0, 1)), drawn on the host from ``seed``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (rows, prompt), generator=g)
    lengths = torch.randint(prompt // 2, prompt + 1, (rows,), generator=g,
                            dtype=torch.int32)
    lengths[0] = prompt
    embeds = 0.02 * torch.randn(rows, cfg.frontend_tokens, cfg.d_model,
                                generator=g)
    return tokens, lengths, embeds


def frontend_serve(cfg, params, ctx, tokens, lengths, embeds, steps,
                   forced=None):
    """One ragged prefill of ``tokens`` after their rows' patch embeddings
    (``models/model.py:forward`` with ``frontend_embeds`` and
    ``lengths``) into a paged cache of F + P + ``steps`` tokens a row
    (each row its own pages, the frontend's K/V in the first), then
    ``steps`` decode steps at positions shifted by F.  Returns each step's
    live logits on the host (fp32) and their greedy tokens; ``forced``
    feeds its tokens to the decode steps in place of the greedy ones."""
    import torch
    from repro_torch.models.model import init_cache
    from repro_torch.train.steps import make_serve_steps

    dev = ctx.device
    (B, P), F = tokens.shape, embeds.shape[1]
    cache = init_cache(cfg, B, F + P + steps, device=dev)
    table = cache["page_table"]
    table.copy_(torch.arange(table.numel(), dtype=torch.int32,
                             device=dev).reshape(table.shape))
    prefill, decode = make_serve_steps(cfg, ctx)
    logits, cache = prefill(params, {"tokens": tokens.to(dev),
                                     "frontend_embeds": embeds.to(dev)},
                            cache, lengths.to(dev))
    pos = (lengths + F).to(dev)
    live, greedy = [], []
    for i in range(steps + 1):
        lv = logits[:, -1, :cfg.vocab_size].float()
        live.append(lv.cpu())
        greedy.append(lv.argmax(-1).cpu())
        if i == steps:
            break
        tok = greedy[-1] if forced is None else forced[i]
        logits, cache = decode(params, {"tokens": tok[:, None].to(dev)},
                               cache, pos)
        pos = pos + 1
    return live, greedy


def run_frontend_phase(cfg, model, dev, seed):
    """internvl2-76b's vision frontend on (i)'s weights: FRONTEND_ROWS rows
    of the config's 256 patch embeddings (bf16) and ragged prompts of up
    to FRONTEND_PROMPT tokens through one ragged prefill and
    FRONTEND_STEPS decode steps in bf16: the flash kernel once a layer,
    the paged decode once a layer a step, no other kernel, every logit
    finite, peak memory at most PEAK_MEM_LIMIT_GB.  Then the same in fp32
    on ``cuda`` and on ``cpu`` (TF32 off) at FRONTEND_PARITY's depth and
    widths on FRONTEND_PARITY_ROWS rows of prompts up to
    FRONTEND_PARITY_PROMPT, the CPU fed the card's greedy tokens: the live
    logits of every step within PARITY_LOGIT_TOL, the greedy tokens equal
    but at a tie (a top-2 gap within PARITY_TIE_TOL)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.layers import Ctx
    from repro_torch.models.model import build_model
    from repro_torch.models.params import cast_params

    tokens, lengths, embeds = frontend_inputs(cfg, FRONTEND_ROWS,
                                              FRONTEND_PROMPT, seed)
    torch.cuda.reset_peak_memory_stats()
    params = cast_params(model, torch.bfloat16)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    live, _ = frontend_serve(cfg, params, Ctx(device=dev,
                                              dtype=torch.bfloat16),
                             tokens, lengths, embeds.bfloat16(),
                             FRONTEND_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    L = cfg.num_layers
    check(launches["flash_attention_bshd"] == L
          and launches["paged_decode_bhd"] == L * FRONTEND_STEPS
          and all(n == 0 for k, n in launches.items() if k not in (
              "flash_attention_bshd", "paged_decode_bhd")),
          f"frontend {cfg.name}: launches {launches}, expected flash {L} and "
          f"paged decode {L} x {FRONTEND_STEPS}")
    check(all(bool(torch.isfinite(x).all()) for x in live),
          f"frontend {cfg.name}: non-finite logits")
    check(peak <= PEAK_MEM_LIMIT_GB, f"frontend {cfg.name}: peak device "
          f"memory {peak:.2f} GB > {PEAK_MEM_LIMIT_GB} GB")
    F = cfg.frontend_tokens
    print(f"  frontend {cfg.name} ({L} layers, bf16): {FRONTEND_ROWS} rows "
          f"of {F} patch embeddings and prompts of {int(lengths.min())}-"
          f"{int(lengths.max())} tokens, one ragged prefill and "
          f"{FRONTEND_STEPS} decode steps at positions from F + length "
          f"(cache of {F + FRONTEND_PROMPT + FRONTEND_STEPS} tokens a row) in "
          f"{wall:.3f} s; logits finite; launches {launches}; peak "
          f"{peak:.2f} GB", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = dataclasses.replace(cfg, dtype="float32", **FRONTEND_PARITY)
    cpu = torch.device("cpu")
    models = {name: build_model(pcfg, device=d, seed=seed)
              for name, d in (("cpu", cpu), ("cuda", dev))}
    check(models_equal(models["cpu"], models["cuda"]), f"frontend parity "
          f"{pcfg.name}: the model built on cuda differs from the one built "
          "on cpu")
    ptok, plen, pemb = frontend_inputs(pcfg, FRONTEND_PARITY_ROWS,
                                       FRONTEND_PARITY_PROMPT, seed + 1)
    t0 = time.perf_counter()
    run = {}
    for name, d in (("cuda", dev), ("cpu", cpu)):
        forced = None if name == "cuda" else run["cuda"][1]
        run[name] = frontend_serve(
            pcfg, cast_params(models[name], torch.float32),
            Ctx(device=d, dtype=torch.float32), ptok, plen, pemb,
            FRONTEND_STEPS, forced=forced)
    parity_s = time.perf_counter() - t0
    del models
    gc.collect()
    torch.cuda.empty_cache()
    err, ties = 0.0, []
    for i, (lc, lp, gc_, gp) in enumerate(zip(run["cuda"][0], run["cpu"][0],
                                               run["cuda"][1],
                                               run["cpu"][1])):
        err = max(err, (lc - lp).abs().max().item())
        for b in torch.nonzero(gc_ != gp).flatten().tolist():
            top2 = lp[b].topk(2).values
            gap = (top2[0] - top2[1]).item()
            check(gap <= PARITY_TIE_TOL, f"frontend parity: step {i} row {b} "
                  f"greedy token {int(gc_[b])} on cuda, {int(gp[b])} on cpu, "
                  f"top-2 gap {gap} above {PARITY_TIE_TOL}")
            ties.append((i, b, gap))
    check(err <= PARITY_LOGIT_TOL, f"frontend parity: live logits differ by "
          f"{err} > {PARITY_LOGIT_TOL}")
    print(f"  frontend parity fp32 cuda vs cpu ({pcfg.num_layers} layers, d_ff "
          f"{pcfg.d_ff}, vocab {pcfg.vocab_size}; {FRONTEND_PARITY_ROWS} rows "
          f"of {F} patch embeddings and prompts of {int(plen.min())}-"
          f"{int(plen.max())} tokens, {FRONTEND_STEPS} decode steps): live "
          f"logit max err {err:.3g} (tol {PARITY_LOGIT_TOL}); greedy tokens "
          + ("equal" if not ties else f"equal but at ties {ties}")
          + f"; {parity_s:.1f} s", flush=True)
    return dict(rows=FRONTEND_ROWS, frontend_tokens=F,
                prompt_lengths=lengths.tolist(), steps=FRONTEND_STEPS,
                wall_s=wall, launches=launches, peak_mem_gb=peak,
                parity=dict(layers=pcfg.num_layers, rows=FRONTEND_PARITY_ROWS,
                            prompt_lengths=plen.tolist(), logit_err=err,
                            ties=ties, seconds=parity_s))


# ---------------------------------------------------------------------------
# Phase 7c: seamless-m4t-medium, the encoder-decoder (cross-attention: the
# flash kernels at Sk apart from Sq)
# ---------------------------------------------------------------------------
SEAMLESS = "seamless-m4t-medium"
# its serving parity and evict-replay: 2 encoder and 2 decoder layers at
# full width over a vocabulary of 16,384 (SERVE_PARITY_VOCAB), pages of 16, prompts of 128 tokens over 34 frames; 33 pages
# for 4 slots of 9 force evictions at the first decode page past the
# prompts
SEAMLESS_PARITY = dict(num_layers=2, num_encoder_layers=2, page_size=16,
                       dtype="float32", vocab_size=SERVE_PARITY_VOCAB)
SEAMLESS_PARITY_SV = dict(batch=4, prompt_len=128, gen=8, requests=6,
                          page_budget=33, overcommit=2.0, prefix_cache=False)


def seamless_evict_replay(cfg, dev, seed):
    """On the card in fp32: admit, two decode steps, evict the youngest
    request and admit again.  It must come back to its slot with its cross
    K and V and its prompt's paged K and V byte-identical (its frames are
    drawn from its id), and the drained engine must answer as one that
    never evicted it."""
    import torch
    from repro_torch.launch.engine import ServingEngine, synthesize_requests
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models.model import build_model

    model = build_model(cfg, device=dev, seed=seed)
    sv = ServeSpec(**dict(SEAMLESS_PARITY_SV, page_budget=0, overcommit=1.0))
    requests = synthesize_requests(cfg, sv, seed, ragged=False)
    whole = ServingEngine(cfg, model, sv, device=dev, dtype=torch.float32)
    for r in requests:
        whole.submit(r)
    whole.run()
    eng = ServingEngine(cfg, model, sv, device=dev, dtype=torch.float32)
    for r in requests:
        eng.submit(r)
    eng.admit()
    eng.step()
    eng.step()
    b = eng._youngest_in_shard(0)
    rec = eng.slots[b]
    n_prompt = -(-len(rec.request.tokens) // eng.ps)

    def held(slot):
        pages = eng.slots[slot].pages[:n_prompt]
        return [t[slot].clone() for n in ("cross_k", "cross_v")
                for t in eng.cache[n]] + [
            pool[pages].clone() for n in ("k_pages", "v_pages")
            for pool in eng.cache[n]]
    before = held(b)
    eng.evict(b)
    eng.admit()
    check(eng.slots[b] is not None
          and eng.slots[b].request.req == rec.request.req,
          "seamless evict-replay: the evicted request did not come back to "
          "its slot")
    after = held(b)
    check(all(torch.equal(x, y) for x, y in zip(before, after)),
          "seamless evict-replay: the replayed request's cross or paged K/V "
          "differ from the evicted ones")
    eng.run()
    check(eng.evictions == 1 and eng.responses == whole.responses,
          "seamless evict-replay: the evicting engine answered differently")
    print(f"  evict-replay on cuda: request {rec.request.req} evicted from "
          f"slot {b} after 2 decode steps and prefilled again: its cross K/V "
          f"({len(before) // 2} tensors) and prompt pages byte-identical, "
          f"{len(eng.responses)} responses equal to an engine that never "
          "evicted it", flush=True)
    return dict(request=rec.request.req, slot=b, tensors=len(before))


def run_seamless_serve_phase(dev, seed):
    """(j): serve seamless-m4t-medium at full depth in bf16 (12 encoder and
    12 decoder layers, 977.9 M parameters): 8 slots, 16 full-length
    prompts of 1,024 tokens, each prefilled alone on its slot with its own
    264 frames, 16 to 32 new tokens.  A prefill launches the flash kernel
    36 times (12 encoder, 12 decoder and 12 cross-attention calls, the last
    at Sk 264 against Sq 1,024), a decode step the paged decode 12 times
    (the cross-attention decodes in plain PyTorch over the cached frames,
    as the reference's is plain jnp), no other kernel.  One traced prefill
    round (8 prefills) and four decode steps; then fp32 cuda-vs-cpu parity
    at 2 + 2 layers with evictions, snapshot/restore, and an evict-replay
    byte-identical (:func:`seamless_evict_replay`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.spec import ServeSpec
    from repro_torch.models.model import build_model
    from repro_torch.models.params import count_params

    cfg = dataclasses.replace(get_config(SEAMLESS), cache_layout="paged",
                              page_size=128)
    L, E = cfg.num_layers, cfg.num_encoder_layers
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed, draws="device")
    torch.cuda.synchronize()
    print(f"  built {cfg.name}: {E} encoder and {L} decoder layers, d "
          f"{cfg.d_model}, H {cfg.num_heads}, K {cfg.num_kv_heads}, hd "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{count_params(cfg, include_embed=True) / 1e6:.1f} M parameters "
          f"({count_params(cfg) / 1e6:.1f} M without the embeddings), in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    serve_once(cfg, model, ServeSpec(batch=2, prompt_len=256, gen=4,
                                     requests=2, prefix_cache=False),
               dev, seed)                                      # warm-up
    sv = ServeSpec(batch=8, prompt_len=1024, gen=32, requests=16,
                   prefix_cache=False)
    r = serve_once(cfg, model, sv, dev, seed)
    eng = r.pop("engine")
    check(not eng.ragged and eng.src_len == 264
          and r["prompt_tokens"] == sv.requests * sv.prompt_len,
          f"serve {cfg.name}: ragged {eng.ragged}, {eng.src_len} frames, "
          f"{r['prompt_tokens']} prompt tokens")
    rounds, steps = r["prefill_calls"], r["decode_calls"]
    check(rounds >= sv.requests and r["launches"]["flash_attention_bshd"]
          == (E + 2 * L) * rounds,
          f"serve {cfg.name}: flash launches {r['launches']} for {rounds} "
          "prefills")
    check(r["launches"]["paged_decode_bhd"] == L * steps,
          f"serve {cfg.name}: paged decode launches {r['launches']} for "
          f"{steps} decode steps")
    check(all(n == 0 for k, n in r["launches"].items()
              if k not in ("flash_attention_bshd", "paged_decode_bhd")),
          f"serve {cfg.name}: other kernels launched {r['launches']}")
    r.update(decode_steps=eng.decode_steps, evictions=eng.evictions,
             prefill_tokens=eng.prefill_tokens, src_len=eng.src_len,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches_per_prefill=r["launches"]["flash_attention_bshd"]
             / rounds,
             launches_per_step=r["launches"]["paged_decode_bhd"] / steps)
    del eng
    check(r["peak_mem_gb"] < PEAK_MEM_LIMIT_GB,
          f"serve {cfg.name}: peak {r['peak_mem_gb']:.2f} GB")
    print(f"  serve {cfg.name} (j): {sv.requests} requests, "
          f"{r['generated']} tokens generated, {r['prompt_tokens']} prompt "
          f"tokens over {r['src_len']} frames each in {r['wall_s']:.3f} s = "
          f"{r['tok_per_s']:.1f} generated tok/s{host_note()}; prefill "
          f"{r['prefill_s']:.3f} s over {rounds} prefills, decode "
          f"{r['decode_s']:.3f} s over {steps} steps; peak memory "
          f"{r['peak_mem_gb']:.2f} GB; launches {r['launches']} (flash "
          f"{r['launches_per_prefill']:g} a prefill, paged decode "
          f"{r['launches_per_step']:g} a step)", flush=True)
    print("[seamless trace] profiler on (not used for the numbers above)",
          flush=True)
    trace = trace_serving(cfg, model, dev, seed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print("[seamless parity]", flush=True)
    pcfg = dataclasses.replace(cfg, **SEAMLESS_PARITY)
    parity = parity_run(pcfg, ServeSpec(**SEAMLESS_PARITY_SV), dev, seed)
    replay = seamless_evict_replay(pcfg, dev, seed)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(serve=r, trace=trace, parity=parity, evict_replay=replay,
                parity_cuts="2 encoder and 2 decoder layers, page 16, "
                f"vocabulary {SERVE_PARITY_VOCAB:,}")


# ---------------------------------------------------------------------------
# Phase 8: training (paper-overhead-100m, qwen3-0.6b) at full width
# ---------------------------------------------------------------------------
# Kernel names by part, for the traced train step
TRAIN_KERNEL_GROUPS = (
    ("flash forward", ("flash_fwd_",)),
    ("flash backward", ("flash_bwd_",)),
    ("WKV6 forward", ("wkv6_chunked",)),
    ("WKV6 backward", ("wkv6_bwd_",)),
    ("RG-LRU forward", ("rglru_scan_kernel",)),
    ("RG-LRU backward", ("rglru_scan_bwd_kernel",)),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("CE", ("softmax", "nll_loss", "cross_entropy")),
)


def train_flops(cfg, tokens, S, B):
    """Model FLOPs of a step: 6·N·tokens for the weight products (N the
    active non-embedding parameters plus the vocabulary projection, tied
    or not) and 12·hd per live causal (q, k) pair and head for attention
    (4·hd forward, 8·hd backward; under MLA 6·(qk + v), the expanded
    heads' 192 and 128; a local layer's pairs within its window), or for
    RWKV6 12·N² per token and head for the recurrence (the state's
    read-out and update, 4·N² forward; dr, dk, dv and dS, 8·N² backward;
    N the head size).  An MoE layer counts the k experts a token runs, not
    the other E - k, nor the router or the capacity padding.  The RG-LRU's
    elementwise scan is not counted, nor remat's recomputed forward."""
    from repro_torch.configs.base import (
        GLOBAL_ATTN, LOCAL_ATTN, RWKV, src_len_for)
    from repro_torch.models.params import count_params
    n = count_params(cfg) + cfg.d_model * cfg.padded_vocab
    if cfg.is_encoder_decoder:
        return encdec_flops(cfg, tokens, S, src_len_for(cfg, S)), n
    if cfg.is_moe:
        moe_layers = cfg.num_layers - cfg.first_k_dense
        idle = (cfg.num_experts - cfg.num_experts_per_tok) \
            * 3 * cfg.d_model * cfg.moe_d_ff
        n -= moe_layers * (idle + cfg.d_model * cfg.num_experts)
    if RWKV in cfg.layer_kinds():
        mix = 12.0 * cfg.rwkv_head_dim * cfg.d_model * cfg.num_layers \
            * tokens
    else:
        kinds = cfg.layer_kinds()
        full, w = S * (S + 1) // 2, cfg.window_size
        windowed = full if not w or w >= S else \
            w * (w + 1) // 2 + (S - w) * w
        pairs = kinds.count(GLOBAL_ATTN) * full \
            + kinds.count(LOCAL_ATTN) * windowed
        widths = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                  + cfg.v_head_dim) if cfg.use_mla else 2 * cfg.head_dim
        mix = 6.0 * widths * pairs * cfg.num_heads * (tokens // S)
    return 6.0 * n * tokens + mix, n


def encdec_flops(cfg, tokens, S, Ssrc):
    """Model FLOPs of an encoder-decoder's step of ``tokens`` decoder tokens
    in rows of S over Ssrc frames a row: 6 FLOPs a parameter and token it
    acts on (the encoder's layers and every decoder layer's cross K and V
    projections on the Ssrc frames, the rest of the decoder and the
    vocabulary projection on the S tokens), and 12·hd a live (q, k) pair
    and head of its three attentions (the decoder's causal, the encoder's
    full Ssrc², the cross-attention's S·Ssrc)."""
    from repro_torch.models.params import count_params
    D, K, hd, H = cfg.d_model, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    rows = tokens // S
    encdec = dataclasses.replace(cfg, num_encoder_layers=0)
    cross_kv = 2 * D * K * hd * cfg.num_layers
    n_enc = count_params(cfg) - count_params(encdec) + cross_kv
    n_dec = count_params(cfg) - n_enc + D * cfg.padded_vocab
    pairs = (cfg.num_layers * S * (S + 1) // 2
             + cfg.num_encoder_layers * Ssrc * Ssrc
             + cfg.num_layers * S * Ssrc)
    attn = 12.0 * hd * H * rows * pairs
    return 6.0 * (n_dec * tokens + n_enc * rows * Ssrc) + attn


def train_launches_per_step(cfg, microbatches, remat):
    """The kernel launches a train step must make: each layer's sequence
    mixer's forward once a layer and microbatch (twice under remat) and
    its backward once (WKV6; RG-LRU; flash for the attention layers);
    every other kernel none."""
    from repro_torch.configs.base import RECURRENT, RWKV
    kernels = {RWKV: ("wkv6_bshn", "wkv6_bwd"),
               RECURRENT: ("rglru_scan_bsr", "rglru_scan_bwd")}
    out = {}
    # an encoder-decoder's encoder layers and every decoder layer's
    # cross-attention take the flash kernels too
    extra = cfg.num_encoder_layers + cfg.num_layers \
        if cfg.is_encoder_decoder else 0
    for kind in cfg.layer_kinds() + ("global",) * extra:
        fwd, bwd = kernels.get(kind, ("flash_attention_bshd",
                                      "flash_attention_bwd"))
        out[fwd] = out.get(fwd, 0) \
            + microbatches * (2 if remat != "none" else 1)
        out[bwd] = out.get(bwd, 0) + microbatches
    return out


class PlainVersionsBarred:
    """While on, a call of a trained kernel's plain version (the flash,
    WKV6 and RG-LRU forwards and backwards) fails the smoke: the card's
    train path must go through the kernels."""

    NAMES = {"flash_attention": ("flash_attention_torch",
                                 "flash_attention_bwd_torch"),
             "rwkv6_wkv": ("wkv6_torch", "wkv6_bwd_torch"),
             "rglru_scan": ("rglru_scan_torch", "rglru_scan_bwd_torch")}

    def __enter__(self):
        import importlib
        self.saved = []
        for mod_name, fns in self.NAMES.items():
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            for fn in fns:
                self.saved.append((mod, fn, getattr(mod, fn)))

                def barred(*a, _fn=fn, **kw):
                    raise SmokeFailure(f"the train path reached {_fn}")
                setattr(mod, fn, barred)
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self.saved:
            setattr(mod, fn, orig)


# The MoE train path's profiler ranges (models/moe.py:moe_ffn_train) and
# the part of a traced step each one's kernels, forward and backward, go to
MOE_RANGES = {"moe.route": "MoE route and dispatch",
              "moe.dispatch": "MoE route and dispatch",
              "moe.experts": "MoE expert SwiGLU (GEMMs and gating)",
              "moe.combine": "MoE combine", "moe.aux": "MoE aux loss"}


def moe_parts(events):
    """Device ms of the MoE train path's parts in a profile's events: a
    kernel belongs to the part of the nearest enclosing ``moe.*`` range or,
    where a backward node comes first, to the part of the range that ran
    the node's forward op (matched by thread and sequence number); remat's
    recomputed forward outside the ranges belongs to no part.
    Returns (ms by part, ids of the events whose kernels were counted)."""
    def backward_node(e):
        return e.name.endswith(("Backward0", "Backward1"))

    def nearest(e):
        # an op that records autograd (a sequence number) below the
        # backward node is remat's recomputed forward, not the node's work
        forward_op = False
        while e is not None:
            if e.name in MOE_RANGES:
                return e
            if backward_node(e):
                return None if forward_op else e
            forward_op |= e.sequence_nr >= 0
            e = e.cpu_parent
        return None
    forward = {}                     # (thread, sequence nr) -> part
    for e in events:
        if e.sequence_nr >= 0 and not backward_node(e):
            owner = nearest(e)
            if owner is not None and owner.name in MOE_RANGES:
                forward[(e.thread, e.sequence_nr)] = MOE_RANGES[owner.name]
    parts, counted = {}, set()
    for e in events:
        us = sum(k.duration for k in getattr(e, "kernels", ()))
        if not us:
            continue
        owner = nearest(e)
        if owner is None:
            continue
        part = MOE_RANGES.get(owner.name) or forward.get(
            (owner.fwd_thread, owner.sequence_nr))
        if part is not None:
            parts[part] = parts.get(part, 0.0) + us / 1e3
            counted.add(e.id)
    return parts, counted


def range_totals(events, names):
    """Device ms and kernel launches of the ops inside each profiler range
    of ``names`` (an op belongs to the nearest enclosing range of them)."""
    out = {name: {"device_ms": 0.0, "launches": 0} for name in names}
    for e in events:
        owner = e.cpu_parent
        while owner is not None and owner.name not in out:
            owner = owner.cpu_parent
        if owner is None:
            continue
        out[owner.name]["device_ms"] += sum(
            k.duration for k in getattr(e, "kernels", ())) / 1e3
        out[owner.name]["launches"] += "LaunchKernel" in e.name
    return out


def trace_train_step(step, state, batch, ranges=()):
    """One train step under torch.profiler: wall and device-busy time, the
    idle share and device ms by part (an MoE stack's parts from its
    profiler ranges, ``moe_parts``; then the kernels named in
    TRAIN_KERNEL_GROUPS, the rest as 'elementwise and other').  Each
    kernel's time outside the MoE parts comes from the profiler's device
    totals by kernel name, so no kernel counts twice.  ``ranges`` names
    profiler ranges whose device ms and launches are also returned
    (``range_totals``; the step's gradient compression is
    ``dist.compress_grads``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    moe, counted = moe_parts(events)
    in_moe = {}                      # kernel name -> ms in the MoE parts
    for e in events:
        if e.id in counted:
            for k in e.kernels:
                in_moe[k.name] = in_moe.get(k.name, 0.0) + k.duration / 1e3
    parts = dict(moe)
    parts.update({name: 0.0 for name, _ in TRAIN_KERNEL_GROUPS})
    parts["elementwise and other"] = 0.0
    summed = 0.0
    launches = 0
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            if "LaunchKernel" in e.key:
                launches += e.count
            continue
        if e.key in MOE_RANGES:      # a range's span on the device timeline
            continue
        us = e.self_device_time_total
        summed += us
        top.append((e.key, e.count, us))
        ms = us / 1e3 - in_moe.get(e.key, 0.0)
        key = e.key.lower()
        group = next((name for name, parts_of in TRAIN_KERNEL_GROUPS
                      if any(p in key for p in parts_of)),
                     "elementwise and other")
        parts[group] += ms
    # busy: the union of the device activities' intervals (summed
    # durations count twice where two run at once)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name not in MOE_RANGES)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy *= 1e-6
    check(busy > 0, "traced train step: no device activity recorded")
    check(busy <= wall * 1.05, f"traced train step: device busy {busy} s "
          f"exceeds the wall time {wall} s")
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
                device_summed_s=summed * 1e-6,
                launches=launches, device_ms_by_part=parts,
                ranges=range_totals(events, ranges),
                top_kernels=[(k[:80], n, us / 1e3) for k, n, us in
                             sorted(top, key=lambda r: -r[2])[:8]])


def optimizer_device_ms(state, run):
    """Device ms of one AdamW update over the state's parameter set, on
    copies (the state is left as it was).  Where the copies (params, m,
    v and a gradient: 16 bytes a parameter in fp32, 8 in bf16) and the
    update's temporaries do not fit beside the state,
    the update is timed over the leading leaves that do and scaled by the
    parameter count (AdamW is elementwise: its time is linear in it).
    Returns (ms, the share of the parameters timed)."""
    import torch
    from repro_torch.optim.adamw import (
        SLICE_ELEMENTS, AdamWConfig, adamw_update)
    gc.collect()
    torch.cuda.empty_cache()
    named = list(state["params"].named_parameters())
    # the update's fp32 temporaries of one leaf, or of one slice of a
    # leaf past SLICE_ELEMENTS (g, the moments, the step; 10 of them as a
    # margin) and 2 GB more stay free; a leaf's copies are its weights, a
    # gradient in its dtype and its two moments
    largest = min(max(p.numel() for _, p in named), SLICE_ELEMENTS)
    budget = torch.cuda.mem_get_info()[0] - 40 * largest - 2e9
    total = sum(p.numel() for _, p in named)
    take, n, nbytes = [], 0, 0
    for name, p in named:
        nbytes += p.numel() * (2 * p.element_size() + sum(
            state["opt"][part][name].element_size() for part in ("m", "v")))
        if nbytes > budget:
            break
        take.append(name)
        n += p.numel()
    check(n > 0, "AdamW timing: no leaf's copies fit on the card")
    params = {name: p.detach().clone() for name, p in named if name in take}
    grads = {name: torch.randn_like(p) * 1e-3 for name, p in params.items()}
    opt = {"m": {name: state["opt"]["m"][name].clone() for name in take},
           "v": {name: state["opt"]["v"][name].clone() for name in take},
           "count": state["opt"]["count"].clone()}
    cfg = AdamWConfig(learning_rate=run.learning_rate,
                      warmup_steps=run.warmup_steps,
                      total_steps=run.total_steps)
    ms = device_ms(lambda: adamw_update(cfg, grads, params, opt), reps=3)
    del params, grads, opt
    torch.cuda.empty_cache()
    return (None if ms is None else ms * total / n), n / total


def run_moe_layer_phase(dev, seed):
    """One MoE FFN of (t3) (granite-moe-1b-a400m's width: 32 experts,
    top-8, moe_d_ff 512, d 1,024; B 4 x S 4,096 in bf16, random weights)
    forward and backward under ``torch.cuda.set_sync_debug_mode("error")``
    (a host sync raises), twice, outputs and gradients bit-equal; then
    its device ms by part (the ``moe.*`` ranges, forward and backward) and
    the share of (token, choice) pairs that capacity drops."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite-moe-1b-a400m")
    B, S, D, E, F = 4, 4096, cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def draw(*shape, std=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * std).to(
            torch.bfloat16).requires_grad_(True)
    p = {"router": draw(D, E, std=0.02), "we_g": draw(E, D, F, std=D ** -.5),
         "we_u": draw(E, D, F, std=D ** -.5),
         "we_d": draw(E, F, D, std=F ** -.5)}
    x = draw(B, S, D)
    w = torch.randn(B, S, D, device=dev, generator=g)
    leaves = [x] + [p[n] for n in sorted(p)]

    def fwd_bwd():
        out, aux = moe.moe_ffn(cfg, p, x, mode="train")
        return [out, aux] + list(torch.autograd.grad(
            (out.float() * w).sum() + aux, leaves))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, again = fwd_bwd(), fwd_bwd()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "MoE layer: two forward-backward passes differ")
    check(all(bool(torch.isfinite(t).all()) for t in first),
          "MoE layer: non-finite output or gradient")
    reps = 5
    wall = time_ms(fwd_bwd, reps=reps, warmup=1)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fwd_bwd()
        torch.cuda.synchronize()
    parts, _ = moe_parts(prof.events())
    parts = {k: v / reps for k, v in parts.items()}
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and e.key not in MOE_RANGES) / 1e3 / reps
    with torch.no_grad():
        probs = torch.softmax((x.reshape(-1, D) @ p["router"]).float(), -1)
        experts = moe._top_k(probs, cfg.num_experts_per_tok)[1]
        Sg = moe.group_size(cfg, S)
        C = moe.capacity(cfg, Sg)
        counts = torch.nn.functional.one_hot(
            experts.reshape(-1, Sg * cfg.num_experts_per_tok), E).sum(1)
        dropped = int((counts - C).clamp_min(0).sum())
    pairs = B * S * cfg.num_experts_per_tok
    out = dict(shape=f"B {B}, S {S}, d {D}, E {E}, k "
               f"{cfg.num_experts_per_tok}, moe_d_ff {F}, bf16",
               group=Sg, capacity=C, dropped_pairs=dropped, pairs=pairs,
               sync_free=True, bit_equal=True, ms=wall, device_ms=busy,
               device_ms_by_part=parts)
    print(f"  MoE layer ({out['shape']}; groups of {Sg}, capacity {C}): "
          f"forward and backward ran with no host sync "
          f"(set_sync_debug_mode error), twice bit-equal; {wall:.3f} ms "
          f"(device {busy:.3f} ms: " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(parts.items()))
          + f"); {dropped} of {pairs} pairs dropped by capacity", flush=True)
    del first, again, p, x, w, leaves, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


HELD_OUT_STEP = 10_000      # a batch of the stream no run here trains on
# Learning rates of the train runs and the parity steps: 1e-3, but
# rwkv6-7b's and mistral-large-123b's the RunConfig default, 3e-4: at
# 1e-3 their losses climb over the first steps (rwkv6's (t4) held-out
# loss rose; mistral-large's (t8), a row of 4,096 at d 12,288, reached a
# grad norm of 91 by step 5 and its held-out loss rose 10.92 -> 11.31),
# and the unstable steps amplify the two devices' rounding in the parity
# phase.
TRAIN_LR = {"rwkv6-7b": 3e-4, "mistral-large-123b": 3e-4}
# fp32 cuda-vs-cpu gradients: within 1e-4 of each leaf's largest, and
# rwkv6-7b's within 5e-4.  Its gradients at init amplify rounding in the
# WKV6 output (with decays near 1 the state sums hundreds of steps), and
# the forward kernel's 3xTF32 o is rounded otherwise than the plain
# version's.  tools/rwkv_grad_sensitivity.py measures the amplification
# and the gap with each of the forward and the backward taken as the
# kernel or as the plain version: the backward kernel adds nothing to it.
PARITY_GRAD_TOL = {"rwkv6-7b": 5e-4}
# One batch trained on 6 times must lose more than 1 nat: the learning
# check that reads the backward.  A few steps on fresh batches move
# qwen3's loss (tied embeddings over 151,936 tokens) less than its batches
# differ, and a held-out batch's loss would also fall with a wrong
# attention gradient (the embeddings and FFNs still learn).  The drop
# each run reaches is printed and written to PERF.md §5.
REPEAT_STEPS, REPEAT_DROP = 6, 1.0


def run_train_phase(dev, seed, arch, *, steps, batch, seq, microbatches,
                    remat, lr=1e-3, warmup=3, falling_mean=True,
                    remat_rows=None, layers=0, min_free_gb=None,
                    max_peak_gb=None, after=None):
    """Train ``arch`` at full width in bf16 (the master weights and
    moments in the dtypes of its registered ``train_4k`` run: fp32, bf16
    for deepseek-v2) through ``repro_torch.launch.train``'s own loop: launch
    counts per step, finite losses, the loss of a held-out batch lower
    after training than at init and (``falling_mean``) the mean loss of
    the last 5 steps below that of the first 5, steps/s, tokens/s, MFU,
    peak memory; then one more step under the profiler; then, from a
    fresh init, REPEAT_STEPS steps on one batch, whose loss must fall by
    more than REPEAT_DROP.  Under remat, the run's first step must equal
    the same step without remat bit for bit; with ``remat_rows`` (a batch
    whose activations do not fit without remat) the two first steps are
    taken on the batch's first ``remat_rows`` rows instead (in as many
    microbatches as the rows allow).  ``layers`` cuts the config's depth;
    with ``min_free_gb`` the run's peak memory must leave that much of the
    card free, with ``max_peak_gb`` stay at or below it.  The plain
    versions of the trained kernels are barred
    during the run (:class:`PlainVersionsBarred`).  ``after(cfg, run,
    state, step, dev, seed)`` then takes the repeated batch's state and
    step, its result under ``"after"``."""
    import torch
    from repro_torch.configs import RunConfig, get_run_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.spec import TrainSpec
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import compute_params
    from repro_torch.train.steps import (
        init_train_state, loss_fn, make_train_step)

    cfg = train_cli.config_of(arch, reduced=False, layers=layers)
    registered = get_run_config(arch, "train_4k")
    ctx = Ctx(device=dev, dtype=torch.bfloat16)
    # the train loop's own batch source (an encoder-decoder's rows carry
    # their frames too)
    data = train_cli.batches_of(cfg, TrainSpec(seq_len=seq,
                                               global_batch=batch), seed)
    held = {k: v[:batch // microbatches] for k, v in
            data.batch_at(HELD_OUT_STEP, dev).items()}

    def held_out_loss(st):
        with torch.no_grad():
            return float(loss_fn(cfg, compute_params(st["params"], ctx.dtype),
                                 held, ctx)[0])

    t = TrainSpec(total_steps=steps, global_batch=batch, seq_len=seq,
                  learning_rate=lr, num_microbatches=microbatches,
                  remat_policy=remat, reduced=False, log_every=5)
    run = RunConfig(num_microbatches=microbatches, remat_policy=remat,
                    learning_rate=lr, warmup_steps=warmup, total_steps=steps,
                    master_dtype=registered.master_dtype,
                    opt_dtype=registered.opt_dtype)

    def fresh_state():
        """A train state at the run's init, drawn from ``seed`` on the card
        (the same bits at every call)."""
        return init_train_state(cfg, seed=seed, run=run, device=dev,
                                draws="device")

    parts_s = {}                    # the phase's wall seconds by part
    t_part = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts_s[name] = parts_s.get(name, 0.0) + now - t_part[0]
        t_part[0] = now

    no_remat = with_remat = None
    if remat != "none":
        # the first step without remat, for the remat run to equal: the
        # recomputed forward is the same arithmetic, kernels included
        first = data.batch_at(0, dev)
        policies = ("none",)
        if remat_rows:
            first = {k: v[:remat_rows] for k, v in first.items()}
            policies = ("none", remat)
        pair = []
        for policy in policies:
            state = fresh_state()
            m = make_train_step(cfg, ctx, dataclasses.replace(
                run, remat_policy=policy, num_microbatches=min(
                    microbatches, first["tokens"].shape[0])))(state,
                                                               first)[1]
            pair.append((float(m["loss"]), float(m["grad_norm"])))
            del state, m
            gc.collect()
            torch.cuda.empty_cache()
        no_remat = pair[0]
        with_remat = pair[1] if remat_rows else None
    lap("remat check")
    torch.cuda.reset_peak_memory_stats()
    state = fresh_state()
    held_before = held_out_loss(state)
    lap("init and held-out loss")
    torch.cuda.synchronize()
    ops.reset_launches()
    with PlainVersionsBarred():
        r = train_cli.train(cfg, t, seed=seed, device=dev, run=run,
                            state=state, log=lambda s: print(s, flush=True))
    launches = dict(ops.launches)
    lap("train loop")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    check(min_free_gb is None or card_gb - peak_gb >= min_free_gb,
          f"train {arch}: peak {peak_gb:.2f} GB leaves less than "
          f"{min_free_gb} GB of the card's {card_gb:.2f} GB free")
    check(max_peak_gb is None or peak_gb <= max_peak_gb,
          f"train {arch}: peak {peak_gb:.2f} GB above {max_peak_gb} GB")
    losses = [m["loss"] for m in r["metrics"]]
    check(all(map(math.isfinite, losses)),
          f"train {arch}: non-finite loss in {losses}")
    held_after = held_out_loss(r["state"])
    check(held_after < held_before, f"train {arch}: the held-out batch's "
          f"loss did not fall ({held_before} at init, {held_after} after)")
    if no_remat is not None:
        if with_remat is None:
            m0 = r["metrics"][0]
            with_remat = (m0["loss"], m0["grad_norm"])
        check(with_remat == no_remat,
              f"train {arch}: the first step's (loss, grad norm) "
              f"{with_remat} under remat {remat} differ from {no_remat} "
              f"without remat")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(not falling_mean or last < first, f"train {arch}: loss did not "
          f"fall (first 5 mean {first}, last 5 mean {last})")
    per_step = train_launches_per_step(cfg, microbatches, remat)
    check(all(n == per_step.get(name, 0) * steps
              for name, n in launches.items()),
          f"train {arch}: launches {launches}, expected {per_step} a step "
          f"over {steps} steps and no other kernel")
    tokens = batch * seq
    flops, n = train_flops(cfg, tokens, seq, batch)
    mfu = flops * r["steps_per_s"] / PEAK_FLOPS["bfloat16"]
    lap("held-out loss")
    opt_ms, opt_share = optimizer_device_ms(r["state"], run)
    lap("AdamW timing")
    step = make_train_step(cfg, ctx, run)
    tr = trace_train_step(step, r["state"], data.batch_at(steps, dev))
    lap("traced step")
    if cfg.is_moe:
        check(all(tr["device_ms_by_part"].get(part, 0.0) > 0
                  for part in set(MOE_RANGES.values())),
              f"train {arch}: the traced step's MoE parts are missing "
              f"({tr['device_ms_by_part']})")
    aux = [m["aux"] for m in r["metrics"]]
    ce = [m["ce"] for m in r["metrics"]]
    out = dict(arch=arch, layers=cfg.num_layers, steps=steps, batch=batch,
               seq=seq, microbatches=microbatches, remat=remat, lr=lr,
               master_dtype=run.master_dtype, opt_dtype=run.opt_dtype,
               warmup=warmup, losses=losses, first5=first, last5=last,
               held_out_before=held_before, held_out_after=held_after,
               first_step_without_remat=no_remat,
               first_step_with_remat=with_remat, remat_rows=remat_rows,
               ce=ce, aux=aux,
               first_step_s=r["first_step_s"], steps_per_s=r["steps_per_s"],
               tokens_per_s=r["tokens_per_s"], timed_steps=r["timed_steps"],
               model_flops_per_step=flops, matmul_params=n, mfu=mfu,
               peak_mem_gb=peak_gb, card_gb=card_gb, launches=launches,
               launches_per_step=per_step,
               optimizer_device_ms=opt_ms, optimizer_timed_share=opt_share,
               trace=tr, host_note=host_note())
    print(f"  train {arch} ({cfg.num_layers} layers): {steps} steps of B "
          f"{batch} x S {seq} "
          f"({microbatches} microbatches, remat {remat}, master "
          f"{run.master_dtype}, moments {run.opt_dtype}); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 5 mean {first:.4f}, "
          f"last 5 {last:.4f}; held-out batch {held_before:.4f} -> "
          f"{held_after:.4f}); CE {ce[0]:.4f} -> {ce[-1]:.4f}, aux "
          f"{aux[0]:.6f} -> {aux[-1]:.6f}; {r['steps_per_s']:.3f} steps/s, "
          f"{r['tokens_per_s']:.0f} tokens/s over {r['timed_steps']} "
          f"steps{host_note()}, "
          f"MFU {mfu:.3f} ({flops / 1e12:.2f} TFLOP a step over "
          f"{n / 1e6:.1f} M active matmul parameters vs 989 TFLOP/s "
          f"bf16), peak {peak_gb:.2f} GB of {card_gb:.2f}; launches "
          f"{launches}; AdamW "
          f"{fmt_ms(opt_ms)} ms device a step"
          + ("" if opt_share == 1 else f" (timed over {opt_share:.1%} of "
             "the parameters and scaled)"), flush=True)
    print(f"  traced step: wall {tr['wall_s'] * 1e3:.1f} ms, device busy "
          f"{tr['device_busy_s'] * 1e3:.1f} ms (kernels summed "
          f"{tr['device_summed_s'] * 1e3:.1f} ms), idle share "
          f"{tr['idle_share']:.3f}, {tr['launches']} launches; device ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      tr["device_ms_by_part"].items()), flush=True)
    for key, cnt, ms in tr["top_kernels"]:
        print(f"    dev  {key[:60]:<60} x{cnt:<5} {ms:9.3f} ms")
    del r, state, step
    gc.collect()
    torch.cuda.empty_cache()
    state = fresh_state()
    step, one = make_train_step(cfg, ctx, run), data.batch_at(0, dev)
    rep = [float(step(state, one)[1]["loss"]) for _ in range(REPEAT_STEPS)]
    check(rep[0] - rep[-1] > REPEAT_DROP, f"train {arch}: one batch trained "
          f"on {REPEAT_STEPS} times lost {rep[0] - rep[-1]} nats, not more "
          f"than {REPEAT_DROP} ({rep})")
    out["repeated_batch_losses"] = rep
    print(f"  one batch {REPEAT_STEPS} times: loss "
          + " ".join(f"{x:.4f}" for x in rep), flush=True)
    lap("repeated batch")
    if after is not None:
        with PlainVersionsBarred():
            out["after"] = after(cfg, run, state, step, dev, seed)
        lap("after")
    out["seconds_by_part"] = parts_s
    print("  seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts_s.items()), flush=True)
    del state, step, one
    gc.collect()
    torch.cuda.empty_cache()
    return out


def frontend_train_step(cfg, run, state, step, dev, seed):
    """One more step of ``state`` on a batch in the reference's dry-run
    shape (``launch/specs.py:batch_specs``): the config's F bf16 patch
    embeddings and S - F tokens and labels a row, S the train_4k row of
    4,096.  The loss must be finite, the flash forward must launch twice a
    layer and microbatch (full remat) and its backward once, each at S
    rows.  A row a microbatch, as (t10) trains."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    S, F = SHAPES["train_4k"].seq_len, cfg.frontend_tokens
    B = run.num_microbatches            # one row a microbatch
    batch = SyntheticLMData(cfg.vocab_size, S - F, B, seed).batch_at(1, dev)
    g = torch.Generator().manual_seed(seed)
    batch["frontend_embeds"] = (0.02 * torch.randn(
        B, F, cfg.d_model, generator=g)).to(dev, torch.bfloat16)
    rows = []
    saved = {n: getattr(fa, n) for n in ("flash_attention_cuda",
                                         "flash_attention_bwd_cuda")}

    def recorder(name):
        def call(q, *a, **kw):
            rows.append((name, q.shape[1]))
            return saved[name](q, *a, **kw)
        return call
    for name in saved:
        setattr(fa, name, recorder(name))
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        loss = float(step(state, batch)[1]["loss"])
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(fa, name, fn)
    launches = dict(ops.launches)
    L = cfg.num_layers
    fwd = [n for k, n in rows if k == "flash_attention_cuda"]
    bwd = [n for k, n in rows if k == "flash_attention_bwd_cuda"]
    check(math.isfinite(loss), f"frontend train step {cfg.name}: loss {loss}")
    check(launches["flash_attention_bshd"] == len(fwd) == 2 * L * B
          and launches["flash_attention_bwd"] == len(bwd) == L * B
          and set(fwd + bwd) == {S},
          f"frontend train step {cfg.name}: launches {launches}, rows of "
          f"the flash calls {rows}, expected {2 * L * B} forwards and "
          f"{L * B} backwards at S {S}")
    print(f"  frontend train step {cfg.name}: {B} row(s) of {F} patch "
          f"embeddings (bf16) and {S - F} tokens and labels: loss "
          f"{loss:.4f}; flash forward {len(fwd)} and backward {len(bwd)} "
          f"launches, each at S {S}", flush=True)
    return dict(loss=loss, frontend_tokens=F, text_tokens=S - F,
                launches=launches, flash_rows=sorted(set(fwd + bwd)))


class FrontendBatches:
    """A batch stream whose rows also carry ``n`` patch embeddings of
    width ``d`` (fp32 0.02·N(0, 1), drawn on the host from (``seed``,
    step)), the frontend of a vision config."""

    def __init__(self, data, n, d, seed):
        self.data, self.n, self.d, self.seed = data, n, d, seed

    def batch_at(self, step, device=None):
        import torch
        b = self.data.batch_at(step, device)
        g = torch.Generator().manual_seed(self.seed * 1_000_003 + step)
        b["frontend_embeds"] = (0.02 * torch.randn(
            b["tokens"].shape[0], self.n, self.d, generator=g)).to(device)
        return b


class FirstGrads:
    """Wraps ``train/steps.py``'s ``adamw_update``: keeps (on the host) the
    gradients of the first update after ``grads`` is reset to None, the
    first batch's gradients of a one-microbatch step."""

    def __init__(self, fn):
        self.fn, self.grads = fn, None

    def __call__(self, cfg, grads, params, opt):
        if self.grads is None:
            self.grads = {n: g.detach().cpu() for n, g in grads.items()}
        return self.fn(cfg, grads, params, opt)


def parity_config(arch):
    """(config, run, batch) of ``arch``'s train parity: full width cut to
    PARITY_LAYERS (2 by default) and PARITY_CUTS, the run's lr, one warmup
    step, PARITY_BATCH rows (2 by default) of 256 positions (a vision
    config's PARITY_FRONTEND patch embeddings among them)."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch import train as train_cli
    cfg = dataclasses.replace(
        train_cli.config_of(arch, reduced=False,
                            layers=PARITY_LAYERS.get(arch, 2)),
        **PARITY_CUTS.get(arch, {}))
    run = RunConfig(learning_rate=TRAIN_LR.get(arch, 1e-3), warmup_steps=1,
                    total_steps=4)
    return cfg, run, PARITY_BATCH.get(arch, 2)


def state_digest(state) -> str:
    """sha256 over the sha256 of each leaf of a train state (its name and
    bytes), in name order (the master weights, both moments, the count and
    the step), whatever its device; the leaves are hashed in threads
    (hashlib lets go of the GIL).  A moment whose every bit is 0 (a fresh
    state's) enters as its dtype and shape, found on its own device: two
    such leaves are byte equal, and their gigabytes need not cross to the
    host."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import torch
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    leaves = sorted(state["params"].named_parameters()) \
        + sorted(("m." + n, t) for n, t in state["opt"]["m"].items()) \
        + sorted(("v." + n, t) for n, t in state["opt"]["v"].items()) \
        + [("count", state["opt"]["count"]), ("step", state["step"])]

    def leaf(item):
        name, t = item
        h = hashlib.sha256(name.encode())
        t = t.detach().contiguous().reshape(-1)
        if name.startswith(("m.", "v.")) \
                and not bool(t.view(bits[t.element_size()]).any()):
            h.update(f"all bits 0: {t.dtype} {t.numel()}".encode())
        else:
            h.update(t.cpu().view(torch.uint8).numpy())
        return h.digest()

    with ThreadPoolExecutor(PARITY_WORKER_CORES) as pool:
        parts = list(pool.map(leaf, leaves))
    return hashlib.sha256(b"".join(parts)).hexdigest()


def parity_side(arch, seed, d):
    """One device's side of ``arch``'s train parity, fp32 (TF32 off): the
    initial state's digest, the first batch's gradients per leaf on the
    host (those the first AdamW update receives, :class:`FirstGrads`), 3
    steps' losses, the kernel launches, the MoE routings of every layer
    call (:class:`RouteRecorder`), and the state and step after them."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.spec import TrainSpec
    from repro_torch.models import moe
    from repro_torch.models.layers import Ctx
    from repro_torch.train import steps
    from repro_torch.train.steps import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, run, B = parity_config(arch)
    n_front = PARITY_FRONTEND.get(arch, 0)
    data = train_cli.batches_of(cfg, TrainSpec(seq_len=256 - n_front,
                                               global_batch=B), seed)
    if n_front:
        data = FrontendBatches(data, n_front, cfg.d_model, seed)
    state = init_train_state(cfg, seed=seed, run=run, device=d)
    digest = state_digest(state)
    recorder = RouteRecorder(moe._top_k, of_probs=True)
    plain_top_k, moe._top_k = moe._top_k, recorder
    first_grads = FirstGrads(steps.adamw_update)
    steps.adamw_update = first_grads
    try:
        recorder.sink = []
        step = make_train_step(cfg, Ctx(device=d, dtype=torch.float32), run)
        ops.reset_launches()
        losses = [float(step(state, data.batch_at(i, d))[1]["loss"])
                  for i in range(3)]
    finally:
        moe._top_k = plain_top_k
        steps.adamw_update = first_grads.fn
    return dict(digest=digest, grads=first_grads.grads, losses=losses,
                launches=dict(ops.launches), routes=recorder.sink,
                state=state, step=step, data=data)


def pin_threads(cores) -> None:
    """Every thread of this process onto ``cores`` (``sched_setaffinity``
    of pid 0 moves the calling thread only: the thread pools started
    before it, OpenMP's among them, keep every core), and the threads
    started later with them."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except OSError:                 # a thread that has just ended
            pass


def _parity_worker(out_dir, cores, seed):
    """The train parity's CPU side (:class:`ParityWorker`'s process): every
    config of TRAIN_PARITY_ARCHS in order on ``cores`` (its affinity and
    its threads; no CUDA device visible), each result written to
    ``out_dir/<arch>.pt`` as soon as it is computed (by a rename, so a
    reader never sees half of one), a failure to ``out_dir/error.txt``.
    Files, not a pipe: a pipe moved the gradients at a few MB/s on the
    card's host."""
    pin_threads(cores)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, str(SRC))
    import torch
    pin_threads(cores)
    torch.set_num_threads(len(cores))
    out = Path(out_dir)
    try:
        for arch in TRAIN_PARITY_ARCHS:
            t0 = time.perf_counter()
            r = parity_side(arch, seed, torch.device("cpu"))
            keep = dict(digest=r["digest"], losses=r["losses"],
                        grads={n: g.detach() for n, g in r["grads"].items()},
                        routes=[(e.detach(), m.detach())
                                for e, m in r["routes"]],
                        seconds=time.perf_counter() - t0)
            torch.save(keep, out / f"{arch}.part")
            os.replace(out / f"{arch}.part", out / f"{arch}.pt")
            del r, keep
            gc.collect()
    except BaseException as e:        # the parent reads it and fails
        (out / "error.txt").write_text(f"{type(e).__name__}: {e}")
        raise


_workers = []         # the running ParityWorker, for host_note


def host_note() -> str:
    """Said beside a host-clock rate taken while the train parity's CPU
    worker runs: the decode steps and small train steps it slows are host
    bound."""
    w = next((w for w in _workers if w.proc.is_alive()), None)
    if w is None:
        return ""
    return (f" (host-bound; taken while the train parity's CPU worker runs "
            f"on {len(w.cores)} of the host's {len(w.own) + len(w.cores)} "
            "cores)")


class ParityWorker:
    """The train parity's CPU side in a second process (spawned right after
    the build) on the host's last PARITY_WORKER_CORES cores; this process
    keeps the others, its threads too.  Results come as files under the
    checkout's ``build/parity_cpu``.  :meth:`result` waits for one
    config's result, loads it and deletes its file (the smoke fails if the
    worker failed or died); :meth:`release` gives this process the
    worker's cores once it has exited; :meth:`stop` ends the worker,
    removes what it left and gives this process its cores back."""

    def __init__(self, seed):
        import multiprocessing
        import shutil
        import torch
        cores = sorted(os.sched_getaffinity(0))
        n = min(PARITY_WORKER_CORES, len(cores) - 1)
        self.cores, self.own = cores[-n:], cores[:-n]
        self.dir = ROOT / "build" / "parity_cpu"
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        ctx = multiprocessing.get_context("spawn")
        self.proc = ctx.Process(target=_parity_worker,
                                args=(str(self.dir), self.cores, seed),
                                daemon=True)
        self.proc.start()
        self.released = False
        pin_threads(self.own)
        torch.set_num_threads(len(self.own))
        _workers.append(self)

    def release(self):
        """All the host's cores for this process once the worker has
        exited (its results stay on disk for :meth:`result`)."""
        import torch
        if not self.released and not self.proc.is_alive():
            self.released = True
            pin_threads(self.own + self.cores)
            torch.set_num_threads(len(self.own) + len(self.cores))

    def result(self, arch):
        """(the CPU side of ``arch``'s parity, seconds waited for it)."""
        import torch
        path, err = self.dir / f"{arch}.pt", self.dir / "error.txt"
        t0 = time.perf_counter()
        while not path.exists():
            check(not err.exists(), "train parity: the CPU worker failed ("
                  + (err.read_text() if err.exists() else "") + ")")
            check(self.proc.is_alive() or path.exists(), f"train parity: "
                  f"the CPU worker exited with {self.proc.exitcode} before "
                  f"{arch}")
            check(time.perf_counter() - t0 < PARITY_WORKER_WAIT_S,
                  f"train parity: no CPU result for {arch} after "
                  f"{PARITY_WORKER_WAIT_S:g} s")
            time.sleep(0.5)
        msg = torch.load(path, weights_only=False)
        path.unlink()
        return msg, time.perf_counter() - t0

    def stop(self):
        import shutil
        if self in _workers:
            _workers.remove(self)
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join()
        shutil.rmtree(self.dir, ignore_errors=True)
        self.released = False
        self.release()


def run_train_parity_phase(dev, seed, worker):
    """fp32 on ``cuda`` (the kernels' fp32 paths) against ``cpu`` (the
    plain versions, computed by the :class:`ParityWorker`), TF32 off, each
    config at full width cut as :func:`parity_config` says, B 2, S 256,
    from the same init (built on each device: the draws are the host's, so
    their digests must be equal) and batches: the first batch's gradients
    per leaf, 3 steps' losses, then a checkpoint round trip
    (``train_state_to_jax`` and back) and the next step's loss equal to
    the unrestored state's on ``cuda``.  The MoE's routing (the experts of
    every token in every MoE layer call) is compared first: it must be the
    same on both devices, or part at a tie (a margin within
    PARITY_TIE_TOL), where the two devices compute different functions
    from then on and nothing after it is compared."""
    import torch
    from repro_torch.convert import train_state_from_jax, train_state_to_jax

    out = {}
    for arch in TRAIN_PARITY_ARCHS:
        t_arch = time.perf_counter()
        c = parity_side(arch, seed, dev)
        cfg, _, B = parity_config(arch)
        t_card = time.perf_counter() - t_arch
        cpu, waited = worker.result(arch)
        check(c["digest"] == cpu["digest"], f"train parity {arch}: the "
              "state initialised on cuda differs from the one on cpu")
        g_c, l_c, r_c = c["grads"], c["losses"], c["routes"]
        g_p, l_p, r_p = cpu["grads"], cpu["losses"], cpu["routes"]
        per_step = train_launches_per_step(cfg, 1, "none")
        check(all(n == per_step.get(name, 0) * 3
                  for name, n in c["launches"].items()),
              f"train parity {arch}: launches {c['launches']}, expected "
              f"{per_step} a step")
        flip = margin = None
        if cfg.is_moe:
            moe_layers = cfg.num_layers - cfg.first_k_dense
            check(len(r_c) == moe_layers * 3, f"train parity {arch}: "
                  f"{len(r_c)} routings recorded, expected {moe_layers} MoE "
                  "layers x 3 steps")
            tok, m, margin = route_flip(
                (r_c, torch.ones(B * 256, dtype=bool)), (r_p, None))
            if tok is not None:
                flip = (tok, m)
                check(m <= PARITY_TIE_TOL, f"train parity {arch}: token "
                      f"{tok} routed differently with a router margin {m} "
                      f"above the tie limit {PARITY_TIE_TOL}")
        rel = worst = None
        if flip is None:
            rel = max(abs(x - y) / abs(y) for x, y in zip(l_c, l_p))
            check(rel <= 1e-5, f"train parity {arch}: losses {l_c} vs {l_p}")
            worst = 0.0
            for n in g_p:
                scale = g_p[n].abs().max().item()
                err = (g_c[n] - g_p[n]).abs().max().item()
                check(err <= PARITY_GRAD_TOL.get(arch, 1e-4)
                      * max(scale, 1e-30),
                      f"train parity {arch}: gradient {n} max |cuda - cpu| "
                      f"{err}, max |g| {scale}")
                worst = max(worst, err / max(scale, 1e-30))
        s_c, step_c = c["state"], c["step"]
        restored = train_state_from_jax(train_state_to_jax(s_c, cfg), cfg,
                                        device=dev)
        nxt = c["data"].batch_at(3, dev)
        a = float(step_c(restored, nxt)[1]["loss"])
        b = float(step_c(s_c, nxt)[1]["loss"])
        check(a == b, f"train parity {arch}: the restored state's next loss "
              f"{a} differs from {b}")
        out[arch] = dict(losses_cuda=l_c, losses_cpu=l_p, loss_rel_err=rel,
                         grad_rel_err=worst, restored_next_loss=a,
                         route_flip=flip, least_router_margin=margin,
                         seconds=time.perf_counter() - t_arch,
                         card_seconds=t_card, cpu_seconds=cpu["seconds"],
                         waited_seconds=waited)
        routing = "" if not cfg.is_moe else (
            f"; routing equal in {len(r_c)} MoE layer calls (least router "
            f"margin {margin:.3g})" if flip is None else
            f"; routing parted at token {flip[0]} (margin {flip[1]:.3g}, a "
            "tie): losses and gradients not compared")
        cuts = "".join(f", {k} {v:,}" for k, v in PARITY_CUTS.get(
            arch, {}).items()) + f", B {B}"
        layers = f"{cfg.num_layers} layer" + ("s" if cfg.num_layers > 1
                                               else "")
        print(f"  train parity {arch} ({layers}{cuts}, fp32): "
              f"losses cuda {l_c} "
              f"cpu {l_p}" + ("" if rel is None else
                              f" (max rel {rel:.3g}); gradients within "
                              f"{worst:.3g}·max|g| of their leaves")
              + f"{routing}; init equal on both devices; restored state's "
              f"next loss {a} equal; {out[arch]['seconds']:.1f} s here "
              f"(card {t_card:.1f} s, waited {waited:.1f} s for the CPU "
              f"side, which took {cpu['seconds']:.1f} s in the worker)",
              flush=True)
        del c, cpu, s_c, restored, step_c, g_c, g_p
        gc.collect()
        torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# Phase 9: the learner and the server as real payloads under the platform
# ---------------------------------------------------------------------------
PLATFORM_STEPS = 40          # (p1): the job's steps
PLATFORM_KILL_AFTER = 20     # (p1): kill after the first checkpoint at or
PLATFORM_KILL_BEFORE = 30    # past step 20, before one at or past step 30,
PLATFORM_KILL_LAG = 2        # two steps after it (so two steps replay)
PLATFORM_BATCH, PLATFORM_SEQ = 8, 1024     # (p1): (t1)'s training shape
PLATFORM_PROMPT = 1024       # (p2): prompts up to 1,024 tokens, as (a)
PLATFORM_DEADLINE_S = 600.0  # virtual seconds a kill may wait for its moment


class MethodTimer:
    """While active, wraps methods of classes so that each call adds its
    wall seconds (and one call) to ``seconds[key]`` (``calls[key]``); the
    originals are put back on exit.  Host-side instrumentation of the
    platform phase: every timed method ends in a host-device sync (a copy
    to the host, a loss read) or runs on the host."""

    def __init__(self, targets):
        self.targets = targets          # [(cls, method name, key)]
        self.seconds = {key: 0.0 for _, _, key in targets}
        self.calls = {key: 0 for _, _, key in targets}
        self.saved = []

    def __enter__(self):
        for cls, name, key in self.targets:
            orig = getattr(cls, name)
            self.saved.append((cls, name, orig))

            def timed(*a, _orig=orig, _key=key, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    self.seconds[_key] += time.perf_counter() - t0
                    self.calls[_key] += 1
            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self.saved):
            setattr(cls, name, orig)
        return False


def tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def trees_byte_equal(a, b) -> bool:
    """Every leaf of two numpy trees (the reference's layout) equal in
    path, dtype, shape and bytes."""
    import numpy as np
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return len(la) == len(lb) and all(
        pa == pb and np.asarray(x).dtype == np.asarray(y).dtype
        and np.asarray(x).shape == np.asarray(y).shape
        and np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for (pa, x), (pb, y) in zip(la, lb))


def run_platform_train(dev, seed, arch="paper-overhead-100m", layers=0,
                       batch=PLATFORM_BATCH, seq=PLATFORM_SEQ, label="p1",
                       n_steps=PLATFORM_STEPS, kill_after=PLATFORM_KILL_AFTER,
                       kill_before=PLATFORM_KILL_BEFORE,
                       grad_compression="none"):
    """(p1): ``arch`` at full width, cut to ``layers`` if given
    (paper-overhead-100m; (p3): granite-moe-1b-a400m at 2 layers), in bf16
    compute with fp32 master and moments, B ``batch`` x S ``seq`` (8 x
    1,024; 4 x 4,096), the synthetic stream at seed 0, as a real
    payload of a 40-step job under the port's platform (seed 21, one
    learner, 0.5 s virtual steps, a checkpoint every 5 virtual seconds);
    the learner pod is killed two steps after the first checkpoint at or
    past step 20, restores and finishes.  Checks: COMPLETED with one
    restart; the log's ``restored checkpoint step N`` for the last step
    saved before the kill; the state right after the restore byte-equal,
    leaf by leaf, to the tree that was saved; every loss of the job (the
    replayed steps included) and the final state bit-equal to an
    uninterrupted 40-step run of the same payload; the flash forward and
    backward launches one a layer a step actually run.  Times the job's
    wall seconds by part.  (p4): ``n_steps``, ``kill_after`` and
    ``kill_before`` in place of 40, 20 and 30, and the train step under
    ``grad_compression``, whose error buffers the checkpoints, the
    restore and the bit-equal final state carry."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.core import DLaaSPlatform, JobManifest
    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.learner import RealPayload
    from repro_torch.core.objectstore import ObjectStore
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models.layers import Ctx
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = train_cli.config_of(arch, reduced=False, layers=layers)
    run = RunConfig(learning_rate=1e-3, warmup_steps=3,
                    total_steps=n_steps, grad_compression=grad_compression)
    train_step = make_train_step(cfg, Ctx(device=dev, dtype=torch.bfloat16),
                                 run)
    data = SyntheticLMData(cfg.vocab_size, seq, batch,
                           seed=0)
    saved = {}                       # step -> the tree handed to save()
    plain_snapshot = RealPayload.snapshot      # not timed

    class Payload(RealPayload):
        """Records every step's loss and checks each restore (outside the
        timed ``RealPayload`` methods)."""

        def __init__(self):
            super().__init__(
                lambda: init_train_state(cfg, seed=seed, run=run, device=dev),
                train_step, data)
            self.losses, self.restores = [], []

        def step(self, i):
            loss = super().step(i)
            self.losses.append((i, loss))
            return loss

        def restore(self, tree):
            out = super().restore(tree)
            if tree is not None:
                self.restores.append((out, trees_byte_equal(
                    plain_snapshot(self), saved[out])))
            return out

    def save_hook(orig):
        def save(ck, step, tree):
            saved[step] = tree
            return orig(ck, step, tree)
        return save

    payload = Payload()
    orig_save = CheckpointManager.save
    CheckpointManager.save = save_hook(orig_save)
    timer = MethodTimer([
        (RealPayload, "step", "steps"), (RealPayload, "snapshot", "ckpt_d2h"),
        (CheckpointManager, "save", "ckpt_save"),
        (ObjectStore, "put", "ckpt_hash_store"),
        (RealPayload, "restore", "restore"),
        (CheckpointManager, "load", "restore_load"),
        (CheckpointManager, "_valid", "restore_verify")])
    try:
        p = DLaaSPlatform(seed=21)
        p.run(10)
        h = p.submit(JobManifest(
            name=label, framework=arch, learners=1,
            total_steps=n_steps, step_time_s=0.5,
            checkpoint_interval_s=5, real_compute=True))
        p.run(5)
        check(h.acked, f"platform ({label}): the train job was not acked "
              f"({h.rejected})")
        ck = CheckpointManager(p.objectstore, h.job_id)
        torch.cuda.synchronize()
        ops.reset_launches()
        with timer:
            t0 = time.perf_counter()
            p.register_payload(h.job_id, payload)
            deadline = p.sim.now + PLATFORM_DEADLINE_S
            while True:
                check(p.sim.now < deadline, f"platform ({label}): no "
                      f"checkpoint at or "
                      f"past step {kill_after} by virtual time "
                      f"{p.sim.now} (job state "
                      f"{p.metadata.get('jobs', h.job_id)['state']})")
                p.run(0.25)
                vol = p.volumes.get(f"vol-{h.job_id}")
                done = [s for s in ck.steps() if s >= kill_after]
                at = vol.read("progress/0", {"step": 0})["step"] \
                    if vol is not None else 0
                if done and at >= done[0] + PLATFORM_KILL_LAG:
                    break
            kill_step, ckpt_before = at, max(ck.steps())
            check(ckpt_before < kill_before,
                  f"platform ({label}): the kill came after checkpoint "
                  f"{ckpt_before}")
            t_kill_sim, t_kill = p.sim.now, time.perf_counter()
            check(p.kill_pod(f"learner-{h.job_id}-0"),
                  f"platform ({label}): no learner pod to kill")
            final = p.run_until_terminal(h.job_id, timeout=900)
            wall = time.perf_counter() - t0
            after_kill = time.perf_counter() - t_kill
        launches = dict(ops.launches)
    finally:
        CheckpointManager.save = orig_save
    sec = timer.seconds
    logs = p.client.logs(h.job_id, 0)
    restarts = p.client.status(h.job_id)["restarts"]
    recovery = p.recovery_time(f"learner-{h.job_id}-0", t_kill_sim)
    check(final == "COMPLETED" and restarts == 1,
          f"platform ({label}): the train job ended {final} with "
          f"{restarts} restarts")
    check(f"restored checkpoint step {ckpt_before}" in logs,
          f"platform ({label}): no 'restored checkpoint step "
          f"{ckpt_before}' in the "
          f"log:\n{logs}")
    check([s for s, _ in payload.restores] == [ckpt_before]
          and all(ok for _, ok in payload.restores),
          f"platform ({label}): restores {payload.restores}, expected step "
          f"{ckpt_before} byte-equal to the saved tree")
    ran = [i for i, _ in payload.losses]
    check(sorted(set(ran)) == list(range(n_steps))
          and len(ran) > n_steps,
          f"platform ({label}): the job ran steps {ran}")
    n_run = len(ran)
    check(launches["flash_attention_bshd"] == cfg.num_layers * n_run
          and launches["flash_attention_bwd"] == cfg.num_layers * n_run,
          f"platform ({label}): launches {launches}, expected "
          f"{cfg.num_layers} a step "
          f"over {n_run} steps run")
    job_losses = list(payload.losses)
    final_tree = RealPayload.snapshot(payload)
    check(("err" in final_tree) == (grad_compression != "none")
          and ("err" in saved[ckpt_before]) == (grad_compression != "none"),
          f"platform ({label}): error buffers in the state and the "
          f"checkpoint under grad_compression {grad_compression!r}: "
          f"{'err' in final_tree}, {'err' in saved[ckpt_before]}")
    ckpt_bytes = sum(np.asarray(x).nbytes for _, x in
                     tree_leaves(saved[ckpt_before]))
    n_saved = timer.calls["ckpt_save"]
    del p, saved, ck
    gc.collect()

    # the same payload, uninterrupted, in this call
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    RealPayload.restore(payload, None)
    straight = [RealPayload.step(payload, i) for i in range(n_steps)]
    torch.cuda.synchronize()
    straight_s = time.perf_counter() - t0
    straight_launches = dict(ops.launches)
    check(straight_launches["flash_attention_bwd"]
          == cfg.num_layers * n_steps,
          f"platform ({label}): the uninterrupted run's launches "
          f"{straight_launches}")
    diffs = [abs(loss - straight[i]) for i, loss in job_losses]
    worst = max(diffs)
    state_equal = trees_byte_equal(RealPayload.snapshot(payload), final_tree)
    check(worst == 0.0 and state_equal,
          f"platform ({label}): the job's losses differ from the "
          f"uninterrupted run's "
          f"by up to {worst} (state byte-equal: {state_equal}); every op "
          "of the step is deterministic on the card, so they must be "
          "bit-equal")
    steps_s = sec["steps"]
    ckpt_s = sec["ckpt_d2h"] + sec["ckpt_save"]
    restore_s = sec["restore"] + sec["restore_load"] + sec["restore_verify"]
    other_s = wall - steps_s - ckpt_s - restore_s
    out = dict(
        job=dict(arch=arch, layers=cfg.num_layers, steps=n_steps,
                 grad_compression=grad_compression,
                 batch=batch, seq=seq,
                 step_time_s=0.5,
                 checkpoint_interval_s=5, platform_seed=21),
        final=final, restarts=restarts, kill_at_step=kill_step,
        restored_step=ckpt_before, steps_run=n_run,
        checkpoints=n_saved, checkpoint_bytes=ckpt_bytes,
        recovery_virtual_s=recovery, wall_s=wall, after_kill_wall_s=after_kill,
        seconds=dict(steps=steps_s, checkpoint=ckpt_s,
                     checkpoint_d2h=sec["ckpt_d2h"],
                     checkpoint_serialize=sec["ckpt_save"]
                     - sec["ckpt_hash_store"],
                     checkpoint_hash_store=sec["ckpt_hash_store"],
                     restore=restore_s, restore_rebuild=sec["restore"],
                     restore_load=sec["restore_load"],
                     restore_verify=sec["restore_verify"],
                     simulation_and_other=other_s),
        steps_per_s=n_run / wall, useful_steps_per_s=n_steps / wall,
        uninterrupted_s=straight_s,
        uninterrupted_steps_per_s=n_steps / straight_s,
        launches=launches, losses_bit_equal=worst == 0.0,
        final_state_byte_equal=state_equal,
        loss_first=job_losses[0][1], loss_last=job_losses[-1][1])
    print(f"  ({label}) {arch} ({cfg.num_layers} layers), "
          f"{n_steps}-step job: killed at "
          f"step {kill_step}, restored checkpoint step {ckpt_before} "
          f"(byte-equal to the saved tree), {final} with {restarts} "
          f"restart; {n_run} steps run; losses {job_losses[0][1]:.4f} -> "
          f"{job_losses[-1][1]:.4f}, every one and the final state "
          f"bit-equal to the uninterrupted run; launches {launches} "
          f"({cfg.num_layers} a step)", flush=True)
    print(f"  ({label}) wall {wall:.3f} s: steps {steps_s:.3f}, checkpoints "
          f"{ckpt_s:.3f} ({n_saved} x {ckpt_bytes / 1e9:.3f} GB: device to "
          f"host {sec['ckpt_d2h']:.3f}, serialise "
          f"{sec['ckpt_save'] - sec['ckpt_hash_store']:.3f}, hash and store "
          f"{sec['ckpt_hash_store']:.3f}), restore {restore_s:.3f} "
          f"(rebuild {sec['restore']:.3f}, load {sec['restore_load']:.3f}, "
          f"verify {sec['restore_verify']:.3f}), simulation and other "
          f"{other_s:.3f}; {n_run / wall:.3f} steps/s under the platform "
          f"({n_steps / wall:.3f} useful) vs "
          f"{n_steps / straight_s:.3f} uninterrupted; recovery "
          f"{recovery:.2f} virtual s", flush=True)
    del payload, final_tree
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The compression phase ((t1c), (p4)): (t1) under each of the train
# step's gradient compressions, in turns within one call
COMP_KINDS = ("none", "int8", "topk")     # topk at CompressionConfig's 0.05
COMP_STEPS = 30
COMP_PARITY = dict(num_layers=2, vocab_size=16_384)   # fp32 cuda vs cpu
COMP_PARITY_BATCH, COMP_PARITY_SEQ, COMP_PARITY_STEPS = 2, 256, 3
COMP_LOSS_TOL = 1e-5
# across devices an int8 element may be a level apart only where its
# quotient lies this near a half level; after three steps at most this
# share of the weights may lie more than 1e-5 apart
COMP_HALF_LEVEL, COMP_PARAM_OFF_SHARE = 2 ** -20, 1e-3
# (p4): (t1) under int8 as a 14-step job, killed two steps after its one
# checkpoint, at step 10 (the next would fall at 18 at platform seed 21)
P4_STEPS, P4_KILL_AFTER, P4_KILL_BEFORE = 14, 10, 18


def compression_run(kind, total_steps=COMP_STEPS):
    """(t1)'s run (lr 1e-3, warmup 3, fp32 master and moments) under
    ``grad_compression=kind``."""
    from repro_torch.configs import RunConfig
    return RunConfig(learning_rate=1e-3, warmup_steps=3,
                     total_steps=total_steps, grad_compression=kind)


def compressed_train_run(cfg, dev, seed, kind, data, held_out_loss):
    """(t1) from a fresh card-drawn init under ``grad_compression=kind``
    through ``launch/train.py``'s loop: COMP_STEPS steps of B 8 x S 1,024,
    flash launches exact (the plain versions barred), finite losses, the
    held-out batch lower after than before; steps/s, tokens/s, MFU, peak
    memory."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.spec import TrainSpec
    from repro_torch.train.steps import init_train_state

    B, S = PLATFORM_BATCH, PLATFORM_SEQ
    run = compression_run(kind)
    t = TrainSpec(total_steps=COMP_STEPS, global_batch=B, seq_len=S,
                  learning_rate=1e-3, reduced=False, log_every=10)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, seed=seed, run=run, device=dev,
                             draws="device")
    check(("err" in state) == (kind != "none"),
          f"(t1c) {kind}: error buffers in the fresh state")
    before = held_out_loss(state)
    torch.cuda.synchronize()
    ops.reset_launches()
    with PlainVersionsBarred():
        r = train_cli.train(cfg, t, seed=seed, device=dev, run=run,
                            state=state, log=lambda s: None)
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in r["metrics"]]
    after = held_out_loss(r["state"])
    check(all(map(math.isfinite, losses)),
          f"(t1c) {kind}: non-finite loss in {losses}")
    check(after < before, f"(t1c) {kind}: the held-out batch's loss did not "
          f"fall ({before} at init, {after} after)")
    per_step = train_launches_per_step(cfg, 1, "none")
    check(all(n == per_step.get(name, 0) * COMP_STEPS
              for name, n in launches.items()),
          f"(t1c) {kind}: launches {launches}, expected {per_step} a step "
          f"over {COMP_STEPS} steps and no other kernel")
    flops, _ = train_flops(cfg, B * S, S, B)
    return dict(kind=kind, losses=losses, held_out_before=before,
                held_out_after=after, steps_per_s=r["steps_per_s"],
                tokens_per_s=r["tokens_per_s"], timed_steps=r["timed_steps"],
                mfu=flops * r["steps_per_s"] / PEAK_FLOPS["bfloat16"],
                peak_mem_gb=peak_gb, launches=launches), r["state"]


def error_feedback_identity(cfg, state, batch, ctx, comp, stacks):
    """On (t1)'s gradient tree (the state's weights on ``batch``) and the
    state's carried error: elements where sent + err_new differs from
    grad + err_old, over all of them (fp32, leaf by leaf)."""
    import torch
    from repro_torch.dist.compression import compress_grads
    from repro_torch.models.params import compute_params
    from repro_torch.train.steps import loss_fn

    names, leaves = zip(*state["params"].named_parameters())
    loss, _ = loss_fn(cfg, compute_params(state["params"], ctx.dtype), batch,
                      ctx)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    with torch.no_grad():
        sent, err = compress_grads(grads, state["err"], comp, stacks)
        bad = sum(int(((sent[n].float() + err[n])
                       != (grads[n].float() + state["err"][n])).sum())
                  for n in names)
        sent_nonzero = sum(int(sent[n].count_nonzero()) for n in names)
    return dict(mismatched=bad, elements=sum(p.numel() for p in leaves),
                sent_nonzero=sent_nonzero)


def compress_cuda_vs_cpu(grads, err, comp, groups, stacks):
    """``compress_grads`` of one gradient tree and residual on the card and,
    copied, on the CPU.  The sent values and the new residuals must be
    bit-equal; an int8 element may be one level apart only where its
    quotient target / scale lies within COMP_HALF_LEVEL of a half level
    (as ``tests/test_torch_compression.py`` allows XLA's reciprocal).
    Returns the elements compared, those that differ and those of them
    the half level does not explain."""
    import torch
    from repro_torch.dist.compression import _blocks, _scales, compress_grads

    host_g = {n: t.cpu() for n, t in grads.items()}
    host_e = {n: t.cpu() for n, t in err.items()}
    with torch.no_grad():
        sc, ec = compress_grads(grads, err, comp, stacks)
        sh, eh = compress_grads(host_g, host_e, comp, stacks)
        sc = {n: t.cpu() for n, t in sc.items()}
        ec = {n: t.cpu() for n, t in ec.items()}
    total = differ = unexplained = 0
    for g in groups:
        a = torch.stack([sc[n] for n in g]).reshape(-1)
        b = torch.stack([sh[n] for n in g]).reshape(-1)
        off = (a != b) | (torch.stack([ec[n] for n in g]).reshape(-1)
                          != torch.stack([eh[n] for n in g]).reshape(-1))
        total += a.numel()
        n_off = int(off.sum())
        differ += n_off
        if not n_off:
            continue
        if comp.kind != "int8":
            unexplained += n_off
            continue
        blocks = _blocks(torch.stack([host_g[n].float() + host_e[n]
                                      for n in g]), comp.chunk_size)
        scales = _scales(blocks, comp.levels)
        safe = torch.where(scales > 0, scales, torch.ones_like(scales))
        q = (blocks / safe[:, None]).reshape(-1)[:a.numel()].double().abs()
        level = safe[:, None].expand_as(blocks).reshape(-1)[:a.numel()]
        near = (q.frac() - 0.5).abs() <= COMP_HALF_LEVEL * q.clamp(min=1)
        one = (a - b).abs() <= level * (1 + 1e-6)
        unexplained += int((off & ~((a != b) & near & one)).sum())
    return dict(elements=total, differ=differ, unexplained=unexplained)


def compression_parity(cfg, dev, seed):
    """fp32 cuda vs cpu under int8 at (t1) cut to 2 layers and a
    vocabulary of 16,384 (B 2 x S 256).

    The compression itself: one gradient tree computed on the card (the
    card's weights after three int8 steps, on the next batch) and the
    card's residual, copied to the CPU; ``compress_grads`` on both devices
    must give the same sent values and residuals bit for bit
    (``compress_cuda_vs_cpu``), under int8 per tensor over the tree and
    under top-k over its layer stacks.

    The train step: three int8 steps on the card and on the CPU from the
    same host-drawn weights.  Losses within COMP_LOSS_TOL relative; the
    devices' fp32 gradients differ by rounding, so an element near a half
    level is sent one level apart and its weight moves apart: at most
    COMP_PARAM_OFF_SHARE of the weights may lie more than 1e-5 apart.
    Three uncompressed steps on the card from the same weights must lie
    past that bound, so that it tells int8 from no compression."""
    import torch
    from repro_torch.convert import reference_stacks
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.dist.compression import CompressionConfig
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import abstract_params, compute_params
    from repro_torch.train import steps as steps_mod

    cfg = dataclasses.replace(cfg, **COMP_PARITY)
    data = SyntheticLMData(cfg.vocab_size, COMP_PARITY_SEQ,
                           COMP_PARITY_BATCH, seed)
    stacks = reference_stacks(cfg)
    stacked = {n for st in stacks for n in st}
    groups = stacks + [[n] for n in abstract_params(cfg) if n not in stacked]
    cpu = torch.device("cpu")

    def three_steps(d, kind):
        run = compression_run(kind, COMP_PARITY_STEPS)
        state = steps_mod.init_train_state(cfg, seed=seed, run=run, device=d)
        step = steps_mod.make_train_step(
            cfg, Ctx(device=d, dtype=torch.float32), run)
        losses = [float(step(state, data.batch_at(i, d))[1]["loss"])
                  for i in range(COMP_PARITY_STEPS)]
        return losses, state

    losses, weights = {}, {}
    card, host, plain = "card int8", "cpu int8", "card none"
    for key, d, kind in ((card, dev, "int8"), (host, cpu, "int8"),
                         (plain, dev, "none")):
        losses[key], state = three_steps(d, kind)
        weights[key] = {n: p.detach().cpu() for n, p in
                        state["params"].named_parameters()}
        if key == card:
            ctx = Ctx(device=dev, dtype=torch.float32)
            names, leaves = zip(*state["params"].named_parameters())
            loss, _ = steps_mod.loss_fn(
                cfg, compute_params(state["params"], ctx.dtype),
                data.batch_at(COMP_PARITY_STEPS, dev), ctx)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            err = dict(state["err"])
        del state
    compress = {}
    # int8 over the whole tree; top-k (a sort on the CPU, seconds) over
    # the layer stacks
    for label, kw, names, gs in (
            ("int8 per tensor", {}, list(grads), groups),
            ("topk 0.05, layer stacks", dict(kind="topk"), sorted(stacked),
             stacks)):
        compress[label] = compress_cuda_vs_cpu(
            {n: grads[n] for n in names}, {n: err[n] for n in names},
            CompressionConfig(**kw), gs, stacks)
        check(compress[label]["unexplained"] == 0,
              f"compression parity: {label} on the card and on the CPU "
              f"differ at {compress[label]['unexplained']} elements of one "
              f"gradient tree away from a half level")
    del grads, err
    worst_loss = max(abs(a - b) / abs(b) for a, b in
                     zip(losses[card], losses[host]))
    check(worst_loss <= COMP_LOSS_TOL, f"compression parity: losses "
          f"{losses} differ by {worst_loss} relative")
    n_weights = sum(w.numel() for w in weights[host].values())
    bound = int(COMP_PARAM_OFF_SHARE * n_weights)

    def off(key):
        return sum(int(((weights[key][n] - w).abs() > 1e-5).sum())
                   for n, w in weights[host].items())

    param_off, plain_off = off(card), off(plain)
    check(param_off <= bound, f"compression parity: {param_off:,} weights "
          f"more than 1e-5 apart, past {bound:,}")
    check(plain_off > bound, f"compression parity: uncompressed steps leave "
          f"only {plain_off:,} weights more than 1e-5 from the CPU's int8 "
          f"run, within the bound {bound:,}: it cannot tell them apart")
    return dict(config=f"paper-overhead-100m, {cfg.num_layers} layers, "
                f"vocabulary {cfg.vocab_size:,}, B {COMP_PARITY_BATCH} x S "
                f"{COMP_PARITY_SEQ}, fp32",
                steps=COMP_PARITY_STEPS, losses=losses,
                loss_rel_diff=worst_loss,
                loss_rel_diff_uncompressed=max(
                    abs(a - b) / abs(b) for a, b in
                    zip(losses[plain], losses[host])),
                compress_one_tree=compress, weights=n_weights,
                weights_off_1e5=param_off, weights_off_1e5_bound=bound,
                weights_off_1e5_uncompressed=plain_off,
                weights_max_abs_diff=max(
                    float((weights[card][n] - w).abs().max())
                    for n, w in weights[host].items()))


def one_rank_allreduce(dev, x, comp):
    """The int8 all-reduce over a one-rank NCCL group (a world of one on
    the card): bit-equal to the pack/unpack round trip."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.compression import (
        pack_int8, sharded_allreduce_int8, unpack_int8)
    from repro_torch.dist.mesh import init_world_of_one, make_host_mesh

    check(not dist.is_initialized(), "a process group was already "
          "initialised before the one-rank all-reduce")
    init_world_of_one(dev)
    try:
        mesh = make_host_mesh(dev)
        out = sharded_allreduce_int8(x, mesh, "data", comp)
        want = unpack_int8(*pack_int8(x, comp), x.shape)
        torch.cuda.synchronize()
        ok = bool(torch.equal(out, want))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    check(ok, "one-rank NCCL all-reduce: not bit-equal to pack/unpack")
    return dict(backend=backend, shape=list(x.shape),
                chunk_size=comp.chunk_size, bit_equal=ok)


def run_compression_phase(dev, seed):
    """The train step's gradient compression on the card.  (t1c): (t1)
    under grad_compression none, int8 and topk in turns (its own loop,
    one call), one traced step of each kind, a compression's with its
    ``dist.compress_grads`` range (one pass in a fixed order: its rates
    carry the order's warm-up, so the kinds are compared by the traced
    steps' device busy time and launches); the int8 wire bytes of (t1)'s gradient tree against fp32; the
    error-feedback identity on (t1)'s gradient tree; fp32 cuda-vs-cpu
    parity of three compressed steps; (p4) an int8 platform job killed
    after a checkpoint, bit-equal to an uninterrupted run, error buffers
    included; the int8 all-reduce on a one-rank NCCL group."""
    import torch
    from repro_torch.convert import reference_stacks
    from repro_torch.dist.compression import (
        CompressionConfig, resolve_compression, wire_bytes_int8)
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.spec import TrainSpec
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import abstract_params, compute_params
    from repro_torch.train.steps import loss_fn, make_train_step

    t0 = time.perf_counter()
    parts_s = {}
    cfg = train_cli.config_of("paper-overhead-100m", reduced=False)
    ctx = Ctx(device=dev, dtype=torch.bfloat16)
    data = train_cli.batches_of(cfg, TrainSpec(seq_len=PLATFORM_SEQ,
                                               global_batch=PLATFORM_BATCH),
                                seed)
    held = data.batch_at(HELD_OUT_STEP, dev)

    def held_out_loss(st):
        with torch.no_grad():
            return float(loss_fn(cfg, compute_params(st["params"],
                                                     ctx.dtype), held,
                                 ctx)[0])

    runs, traces, identity = {}, {}, {}
    stacks = reference_stacks(cfg)
    for kind in COMP_KINDS:
        runs[kind], state = compressed_train_run(cfg, dev, seed, kind, data,
                                                 held_out_loss)
        r = runs[kind]
        print(f"  (t1c) {kind}: {COMP_STEPS} steps, loss {r['losses'][0]:.4f}"
              f" -> {r['losses'][-1]:.4f} (held-out {r['held_out_before']:.4f}"
              f" -> {r['held_out_after']:.4f}); {r['steps_per_s']:.3f} "
              f"steps/s, {r['tokens_per_s']:.0f} tokens/s, MFU "
              f"{r['mfu']:.3f}, peak {r['peak_mem_gb']:.2f} GB; launches "
              f"{r['launches']}", flush=True)
        step = make_train_step(cfg, ctx, compression_run(kind))
        tr = trace_train_step(step, state, data.batch_at(COMP_STEPS, dev),
                              ranges=() if kind == "none"
                              else ("dist.compress_grads",))
        traces[kind] = tr
        del step
        rg = tr["ranges"].get("dist.compress_grads")
        print(f"    traced step: wall {tr['wall_s'] * 1e3:.1f} ms, busy "
              f"{tr['device_busy_s'] * 1e3:.1f} ms, idle share "
              f"{tr['idle_share']:.3f}, {tr['launches']} launches" + (
                  f"; dist.compress_grads {rg['device_ms']:.2f} device ms, "
                  f"{rg['launches']} launches" if rg else ""), flush=True)
        if kind != "none":
            identity[kind] = error_feedback_identity(
                cfg, state, data.batch_at(COMP_STEPS + 1, dev), ctx,
                resolve_compression(kind), stacks)
            print(f"    error feedback: sent + err_new != grad + err_old at "
                  f"{identity[kind]['mismatched']} of "
                  f"{identity[kind]['elements']:,} elements", flush=True)
            check(identity[kind]["mismatched"] == 0,
                  f"(t1c) {kind}: the error-feedback identity fails at "
                  f"{identity[kind]['mismatched']} elements")
        if kind == "int8":
            # the largest leaf of (t1)'s gradient tree, at the card
            x = next(t for n, t in state["err"].items()
                     if t.numel() == max(e.numel()
                                         for e in state["err"].values()))
        del state
        gc.collect()
        torch.cuda.empty_cache()
    parts_s["t1c"] = time.perf_counter() - t0
    shapes = abstract_params(cfg)
    fp32_bytes = 4 * sum(p.numel() for p in shapes.values())
    by_leaf = [sum(shapes[n].numel() for n in g) for g in stacks] + [
        shapes[n].numel() for n in shapes
        if not any(n in g for g in stacks)]
    wire = sum(wire_bytes_int8(torch.empty(n, device="meta"))
               for n in by_leaf)
    wire_chunked = sum(wire_bytes_int8(torch.empty(n, device="meta"),
                                       CompressionConfig(chunk_size=4096))
                       for n in by_leaf)
    print(f"  int8 wire bytes of (t1)'s gradient tree ({len(by_leaf)} "
          f"reference leaves): {wire:,} per tensor, {wire_chunked:,} in "
          f"chunks of 4,096, against {fp32_bytes:,} in fp32 "
          f"({fp32_bytes / wire:.3f}x)", flush=True)
    t1 = time.perf_counter()
    parity = compression_parity(cfg, dev, seed)
    parts_s["parity"] = time.perf_counter() - t1
    print(f"  fp32 cuda vs cpu ({parity['config']}): one gradient tree of "
          f"the card compressed on both devices, elements apart: " + ", ".join(
              f"{k} {v['differ']} of {v['elements']:,}" for k, v in
              parity["compress_one_tree"].items()) +
          f"; three int8 steps: losses within {parity['loss_rel_diff']:.2e} "
          f"relative, weights more than 1e-5 apart at "
          f"{parity['weights_off_1e5']:,} (bound "
          f"{parity['weights_off_1e5_bound']:,}, max "
          f"{parity['weights_max_abs_diff']:.3e}); uncompressed card steps: "
          f"losses {parity['loss_rel_diff_uncompressed']:.2e} relative, "
          f"weights at {parity['weights_off_1e5_uncompressed']:,}",
          flush=True)
    t1 = time.perf_counter()
    p4 = run_platform_train(dev, seed, label="p4", n_steps=P4_STEPS,
                            kill_after=P4_KILL_AFTER,
                            kill_before=P4_KILL_BEFORE,
                            grad_compression="int8")
    parts_s["p4"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    allreduce = {"per_tensor": one_rank_allreduce(dev, x, CompressionConfig()),
                 "chunked": one_rank_allreduce(
                     dev, x, CompressionConfig(chunk_size=4096))}
    del x
    parts_s["allreduce"] = time.perf_counter() - t1
    print(f"  one-rank NCCL all-reduce of a {allreduce['chunked']['shape']} "
          f"leaf, per tensor and in chunks of 4,096: bit-equal to "
          f"pack/unpack", flush=True)
    # one pass in a fixed order: the rates carry the order's warm-up, so
    # what is compared across kinds is the traced step's device work
    base = traces["none"]
    out = dict(runs=runs, traces=traces, error_feedback=identity,
               wire_bytes=dict(per_tensor=wire, chunked_4096=wire_chunked,
                               fp32=fp32_bytes, reference_leaves=len(by_leaf)),
               traced_vs_none={k: dict(
                   busy_ms=(traces[k]["device_busy_s"]
                            - base["device_busy_s"]) * 1e3,
                   launches=traces[k]["launches"] - base["launches"])
                   for k in COMP_KINDS if k != "none"},
               parity=parity, platform=p4, allreduce=allreduce,
               seconds_by_part=parts_s)
    print("  seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts_s.items()), flush=True)
    return out


class GapRecorder:
    """Wraps a serving engine's prefill or decode step: for each live row,
    the gap between its two largest last-position logits, keyed by
    (request, tokens generated before the step)."""

    def __init__(self, engine, fn, kind, sink):
        self.engine, self.fn, self.kind, self.sink = engine, fn, kind, sink

    def __call__(self, params, batch, cache, rows, *rest):
        logits, cache = self.fn(params, batch, cache, rows, *rest)
        live = (rows > 0) if self.kind == "prefill" else (rows >= 0)
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).cpu()
        for b in live.nonzero().flatten().tolist():
            rec = self.engine.slots[b]
            self.sink[(rec.request.req, len(rec.out_tokens))] = \
                float(gaps[b])
        return logits, cache


def run_platform_serve(dev, seed):
    """(p2): a qwen3-0.6b serve job at full width in bf16 (8 slots, 16
    requests, prompts up to 1,024 tokens, a snapshot every 8 decode
    steps, no prefix cache: prefill takes the flash kernel, decode the
    paged decode) under the port's platform, twice from the same seed: once
    uninterrupted (its top-2 logit gaps recorded) and once with the
    server pod killed after its first snapshot and before the drain (the
    platform builds that job's payload itself).  Checks: both complete,
    every request shipped once with its full budget, the streams equal
    (where they part, at a tie within PARITY_TIE_TOL)."""
    import torch
    from repro_torch.core import DLaaSPlatform, JobSpec, ServeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import RealServePayload, ServingEngine

    spec = JobSpec(name="p2", kind="serve", framework="qwen3-0.6b", seed=seed,
                   serve=ServeSpec(batch=8, prompt_len=PLATFORM_PROMPT, gen=32,
                                   requests=16, snapshot_every=8,
                                   prefix_cache=False, reduced=False,
                                   real_compute=True))
    n_req = spec.serve.requests
    gaps = {}

    class Recorded(RealServePayload):
        def build(self):
            engine, requests = super().build()
            engine.prefill = GapRecorder(engine, engine.prefill, "prefill",
                                         gaps)
            engine.decode = GapRecorder(engine, engine.decode, "decode",
                                        gaps)
            return engine, requests

    def serve_job(kill):
        p = DLaaSPlatform(seed=21)
        p.run(10)
        h = p.submit(spec)
        p.run(5)
        check(h.acked, f"platform: the serve job was not acked "
              f"({h.rejected})")
        if not kill:
            p.register_payload(h.job_id, Recorded(spec, device=dev))
        timer = MethodTimer([
            (RealServePayload, "build", "build"),
            (ServingEngine, "snapshot", "snapshot"),
            (ServingEngine, "restore", "restore")])
        ops.reset_launches()
        t_kill = kill_served = snap_bytes = None
        with timer:
            t0 = time.perf_counter()
            if kill:
                deadline = p.sim.now + PLATFORM_DEADLINE_S
                while True:
                    check(p.sim.now < deadline, "platform: the serve job "
                          f"took no snapshot by virtual time {p.sim.now}")
                    vol = p.volumes.get(f"vol-{h.job_id}")
                    if vol is not None and \
                            vol.read("engine/0/snapshot") is not None:
                        break
                    p.run(0.05)
                kill_served = vol.read("served", 0)
                check(kill_served < n_req, "platform: the serve job drained "
                      "before its first snapshot")
                snap = vol.read("engine/0/snapshot")
                snap_bytes = sum(t.numel() * t.element_size()
                                 for leaf in snap["cache"].values()
                                 for t in (leaf if isinstance(leaf, list)
                                           else [leaf]))
                t_kill = p.sim.now
                check(p.kill_pod(f"server-{h.job_id}-0"),
                      "platform: no server pod to kill")
                del snap, vol
            final = p.run_until_terminal(h.job_id, timeout=900)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        streams = {}
        for r in range(n_req):
            key = f"cos/{h.job_id}/responses/{r}"
            check(p.objectstore.exists(key),
                  f"platform: request {r} was never shipped")
            doc = json.loads(p.objectstore.get(key).decode())
            streams[doc["req"]] = doc["tokens"]
        logs = p.client.logs(h.job_id, 0)
        rec = dict(final=final, restarts=p.client.status(h.job_id)["restarts"],
                   wall_s=wall, launches=dict(ops.launches),
                   seconds=dict(timer.seconds), calls=dict(timer.calls),
                   served_line=[ln for ln in logs.splitlines()
                                if "done (" in ln])
        if kill:
            rec.update(killed_after_served=kill_served,
                       snapshot_cache_bytes=snap_bytes,
                       recovery_virtual_s=p.recovery_time(
                           f"server-{h.job_id}-0", t_kill),
                       engine_restored="engine restored" in logs)
        del p
        gc.collect()
        torch.cuda.empty_cache()
        return streams, rec

    golden, g = serve_job(kill=False)
    streams, v = serve_job(kill=True)
    for name, rec in (("uninterrupted", g), ("killed", v)):
        check(rec["final"] == "COMPLETED", f"platform: the {name} serve job "
              f"ended {rec['final']}")
        check(any(f"({n_req} served" in ln for ln in rec["served_line"]),
              f"platform: the {name} job's log does not show {n_req} "
              f"served: {rec['served_line']}")
    for name, rec in (("uninterrupted", g), ("killed", v)):
        la = rec["launches"]
        check(la["flash_attention_bshd"] > 0 and la["paged_decode_bhd"] > 0
              and la["flash_attention_bshd"] % 28 == 0
              and la["paged_decode_bhd"] % 28 == 0,
              f"platform: the {name} serve job's launches {la}: flash 28 a "
              "prefill round and the paged decode 28 a decode step")
    check(v["restarts"] == 1 and v["engine_restored"],
          f"platform: the killed serve job restarted {v['restarts']} times "
          f"(engine restored: {v['engine_restored']})")
    budgets = {r.req: r.gen_len for r in synthesize_for(spec)}
    for name, st in (("uninterrupted", golden), ("killed", streams)):
        check(sorted(st) == list(range(n_req)) and all(
            len(st[r]) == budgets[r] for r in st),
            f"platform: the {name} job shipped {sorted(st)} with lengths "
            f"{ {r: len(t) for r, t in st.items()} }, budgets {budgets}")
    parted = []
    for r in range(n_req):
        a, b = golden[r], streams[r]
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            parted.append((r, j, gaps.get((r, j))))
    for r, j, gap in parted:
        check(gap is not None and gap <= PARITY_TIE_TOL,
              f"platform: request {r}'s streams part at token {j} with a "
              f"top-2 gap of {gap}, above {PARITY_TIE_TOL}")
    where = "equal" if not parted else \
        "part at ties " + ", ".join(f"request {r} token {j} (gap {gap:.3g})"
                                    for r, j, gap in parted)
    print(f"  (p2) qwen3-0.6b serve job, 16 requests: killed after "
          f"{v['killed_after_served']} served (snapshot "
          f"{v['snapshot_cache_bytes'] / 1e9:.3f} GB of cache), "
          f"{v['final']} with {v['restarts']} restart, engine restored; "
          f"every request shipped once with its full budget; streams "
          f"{where} against the uninterrupted job; wall {v['wall_s']:.3f} s "
          f"(uninterrupted {g['wall_s']:.3f}): build "
          f"{v['seconds']['build']:.3f} ({v['calls']['build']} x), "
          f"snapshots {v['seconds']['snapshot']:.3f} "
          f"({v['calls']['snapshot']} x), restore "
          f"{v['seconds']['restore']:.3f}; recovery "
          f"{v['recovery_virtual_s']:.2f} virtual s; launches {v['launches']}",
          flush=True)
    return dict(uninterrupted=g, killed=v, streams_parted=parted)


def synthesize_for(spec):
    """The requests of a serve job's spec (the workload draws on the host
    from the job seed; prompt_len and gen set their lengths)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import synthesize_requests
    cfg = dataclasses.replace(get_config(spec.framework),
                              cache_layout="paged")
    return synthesize_requests(cfg, spec.serve, spec.seed)


def platform_launches(platform, name):
    """A kernel's launches in the platform phase's runs: (p1) the killed
    job (replayed steps included) and (p2) the uninterrupted and the
    killed serve job."""
    return {"p1_job": platform["train"]["launches"][name],
            "p2_uninterrupted": platform["serve"]["uninterrupted"]
            ["launches"][name],
            "p2_killed": platform["serve"]["killed"]["launches"][name]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside this script "
              f"({SRC / 'repro_torch'} is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import SHAPES, get_run_config
    from repro_torch.kernels import _build

    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | python "
          f"{sys.version.split()[0]}", flush=True)

    t_start = t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(logs)} CUDA sources compiled for sm_90a in "
          f"{build_s:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line:        # names the lines below
                print(f"  {name}: {line.strip().split()[-3]}")
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase_s = {"build": build_s}      # wall seconds of each phase
    t_mark = [time.perf_counter()]
    worker = ParityWorker(0)
    print(f"[parity worker] the train parity's CPU side started in a second "
          f"process on cores {worker.cores}; this process keeps "
          f"{worker.own}", flush=True)
    try:
        return run_phases(dev, card, build_s, phase_s, t_mark, t_start,
                          worker)
    finally:
        worker.stop()


def run_phases(dev, card, build_s, phase_s, t_mark, t_start, worker) -> int:
    """Phases 2-9 (the build and the parity worker are :func:`main`'s)."""
    import torch
    from repro_torch.configs.base import SHAPES, get_run_config

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        released = worker.released
        worker.release()
        print(f"[time] {name} {phase_s[name]:.1f} s, "
              f"{now - t_start:.1f} s in all"
              + ("" if released or not worker.released else
                 "; the parity worker has finished: its cores are this "
                 "process's again"), flush=True)

    seed = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    print("[kernels]", flush=True)
    flash_rows = run_flash_phase(dev, gen)
    decode_rows = run_decode_phase(dev, gen)
    wkv_rows = run_wkv_phase(dev, gen)
    rglru_rows = run_rglru_phase(dev, gen)
    mla_rows = run_mla_phase(dev, gen)
    mark("kernels")
    bwd_rows = run_flash_bwd_phase(dev, gen)
    mark("flash backward")
    print("[cross] flash forward and backward at Sk apart from Sq "
          "(seamless-m4t-medium)", flush=True)
    cross_rows = run_cross_flash_phase(dev, gen)
    mark("flash cross")
    wkv_bwd_rows = run_wkv_bwd_phase(dev, gen)
    mark("WKV6 backward")
    rglru_bwd_rows = run_rglru_bwd_phase(dev, gen)
    mark("RG-LRU backward")
    _flush.clear()              # the L2-cold timings' buffer: out of the
    torch.cuda.empty_cache()    # serve runs' peak memory
    print("[serve] qwen3-0.6b full width, bf16", flush=True)
    runs = run_serve_phase(dev, seed)
    print("[trace] cell (a), profiler on (not used for the numbers above)",
          flush=True)
    traces = run_trace_phase(dev, seed)
    mark("serve")
    print("[lockstep] the reference's default serve path, bf16: (k) "
          "qwen3-0.6b full width, (l) deepseek-v2-236b full width cut to 3 "
          "layers, dense then paged (identity tables); fp32 parity",
          flush=True)
    lockstep = run_lockstep_phase(dev, seed, gen)
    mark("lockstep")
    print("[parity]", flush=True)
    parity = run_parity_phase(dev, seed)
    mark("parity")
    print("[rwkv] rwkv6-7b full width, bf16", flush=True)
    rwkv = run_rwkv_phase(dev, seed)
    mark("rwkv")
    gc.collect()
    torch.cuda.empty_cache()
    print("[recurrentgemma] recurrentgemma-9b full width, bf16", flush=True)
    rgemma = run_recurrentgemma_phase(dev, seed)
    mark("recurrentgemma")
    gc.collect()
    torch.cuda.empty_cache()
    print("[deepseek] deepseek-v2-236b full width, 3 layers, bf16",
          flush=True)
    deepseek = run_deepseek_phase(dev, seed)
    mark("deepseek")
    gc.collect()
    torch.cuda.empty_cache()
    dense = {}
    for key, arch, layers, kw in (
            ("f", "qwen2.5-32b", QWEN25_SERVE_LAYERS, {}),
            ("g", "mistral-large-123b", MISTRAL_SERVE_LAYERS, {}),
            ("h", "gemma2-9b", GEMMA2_SERVE_LAYERS,
             dict(prompt_len=3072, max_len=4096)),
            # served text-only with the prefix cache asked for, then the
            # frontend on the same weights
            ("i", "internvl2-76b", INTERNVL2_SERVE_LAYERS,
             dict(prefix_cache=True, after=run_frontend_phase))):
        print(f"[serve ({key})] {arch} full width, {layers} layers, bf16",
              flush=True)
        dense[key] = run_dense_serve_phase(dev, seed, arch, layers,
                                           label=key, **kw)
        mark(f"serve ({key})")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve (j)] {SEAMLESS} full depth (12 + 12 layers), bf16",
          flush=True)
    seamless = run_seamless_serve_phase(dev, seed)
    mark("serve (j)")
    print("[train] paper-overhead-100m full width (12 layers), bf16 compute,"
          " fp32 master", flush=True)
    train = {"paper-overhead-100m": run_train_phase(
        dev, seed, "paper-overhead-100m", steps=30, batch=8, seq=1024,
        microbatches=1, remat="none")}
    print("[train] qwen3-0.6b full width (28 layers), its train_4k run (S "
          "4096, 2 microbatches, full remat)", flush=True)
    # 6 steps on fresh batches move qwen3's loss less than its batches
    # differ (tied embeddings over a 151,936-token vocabulary), so its
    # learning is read from the held-out and the repeated batch
    q_run = get_run_config("qwen3-0.6b", "train_4k")
    train["qwen3-0.6b"] = run_train_phase(
        dev, seed, "qwen3-0.6b", steps=6, batch=4,
        seq=SHAPES["train_4k"].seq_len,
        microbatches=q_run.num_microbatches, remat=q_run.remat_policy,
        falling_mean=False)
    mark("train (t1), (t2)")
    gc.collect()
    torch.cuda.empty_cache()
    print("[moe-layer] granite-moe-1b-a400m's MoE FFN at (t3)'s shape, "
          "bf16", flush=True)
    moe_layer = run_moe_layer_phase(dev, seed)
    mark("moe layer")
    print("[train] granite-moe-1b-a400m full width (24 layers), its "
          "train_4k run (S 4096, 1 microbatch, full remat)", flush=True)
    # B 4 does not fit without remat: the remat check takes one row
    g_run = get_run_config("granite-moe-1b-a400m", "train_4k")
    train["granite-moe-1b-a400m"] = run_train_phase(
        dev, seed, "granite-moe-1b-a400m", steps=6, batch=4,
        seq=SHAPES["train_4k"].seq_len,
        microbatches=g_run.num_microbatches, remat=g_run.remat_policy,
        falling_mean=False, remat_rows=1)
    mark("train (t3)")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] rwkv6-7b full width cut to {RWKV_TRAIN_LAYERS} layers, "
          "its train_4k run (S 4096, 2 microbatches, full remat)",
          flush=True)
    # B 4 does not fit without remat: the remat check takes one row
    w_run = get_run_config("rwkv6-7b", "train_4k")
    train["rwkv6-7b"] = run_train_phase(
        dev, seed, "rwkv6-7b", steps=6, batch=4,
        seq=SHAPES["train_4k"].seq_len,
        microbatches=w_run.num_microbatches, remat=w_run.remat_policy,
        lr=TRAIN_LR["rwkv6-7b"], falling_mean=False, remat_rows=1,
        layers=RWKV_TRAIN_LAYERS, min_free_gb=8.0)
    mark("train (t4)")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] deepseek-v2-236b full width cut to "
          f"{DEEPSEEK_TRAIN_LAYERS} layers, its train_4k run at B 2 (S "
          "4096, 1 microbatch, full remat, bf16 master and moments)",
          flush=True)
    # B 2 does not fit without remat: the remat check takes one row.  One
    # microbatch, not the run's 16: a second would add an fp32 gradient
    # sum of 21.4 GB (train/steps.py)
    d_run = get_run_config("deepseek-v2-236b", "train_4k")
    train["deepseek-v2-236b"] = run_train_phase(
        dev, seed, "deepseek-v2-236b", steps=6, batch=2,
        seq=SHAPES["train_4k"].seq_len, microbatches=1,
        remat=d_run.remat_policy, falling_mean=False, remat_rows=1,
        layers=DEEPSEEK_TRAIN_LAYERS, max_peak_gb=PEAK_MEM_LIMIT_GB)
    mark("train (t5)")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] recurrentgemma-9b full width cut to {RG_TRAIN_LAYERS} "
          "layers, its train_4k run (S 4096, global batch 2 in 2 "
          "microbatches, full remat)", flush=True)
    # B 2 without remat would not leave the 70 GB limit: the remat check
    # takes one row
    r_run = get_run_config("recurrentgemma-9b", "train_4k")
    train["recurrentgemma-9b"] = run_train_phase(
        dev, seed, "recurrentgemma-9b", steps=6, batch=2,
        seq=SHAPES["train_4k"].seq_len,
        microbatches=r_run.num_microbatches, remat=r_run.remat_policy,
        falling_mean=False, remat_rows=1, layers=RG_TRAIN_LAYERS,
        max_peak_gb=PEAK_MEM_LIMIT_GB)
    mark("train (t6)")
    gc.collect()
    torch.cuda.empty_cache()
    # (t7)-(t9): one row a microbatch.  (t7) B 2 in 2 microbatches of the
    # run's 16, (t9) B 4 in its 4; (t8) B 1 in 1 of its 8 (a second
    # microbatch's fp32 gradient sum, 14.3 GB at 2 layers, does not fit)
    # (t10) B 1 in 1 of its 16, text-only through the train loop as the
    # reference's CLI trains, then a step with the frontend; (t11)
    # seamless-m4t-medium at full depth, B 4 in its 2, its rows' frames
    # from the train loop's batch source
    for key, arch, layers, batch, mb in (
            ("t7", "qwen2.5-32b", QWEN25_TRAIN_LAYERS, 2, 2),
            ("t8", "mistral-large-123b", MISTRAL_TRAIN_LAYERS, 1, 1),
            ("t9", "gemma2-9b", GEMMA2_TRAIN_LAYERS, 4, 4),
            ("t10", "internvl2-76b", INTERNVL2_TRAIN_LAYERS, 1, 1),
            ("t11", SEAMLESS, 0, 4, 2)):
        t_run = get_run_config(arch, "train_4k")
        depth = f"cut to {layers} layers" if layers else "at full depth"
        print(f"[train ({key})] {arch} full width {depth}, "
              f"its train_4k run (S 4096, {t_run.num_microbatches} "
              f"microbatches, {t_run.remat_policy} remat) at B {batch} in "
              f"{mb} microbatch{'es' if mb > 1 else ''}", flush=True)
        train[arch] = run_train_phase(
            dev, seed, arch, steps=6, batch=batch,
            seq=SHAPES["train_4k"].seq_len, microbatches=mb,
            remat=t_run.remat_policy, lr=TRAIN_LR.get(arch, 1e-3),
            falling_mean=False, remat_rows=1, layers=layers,
            max_peak_gb=PEAK_MEM_LIMIT_GB,
            after=frontend_train_step if key == "t10" else None)
        mark(f"train ({key})")
        gc.collect()
        torch.cuda.empty_cache()
    print("[train-parity] fp32 cuda vs cpu, full width, 2 layers "
          "(recurrentgemma-9b 3; rwkv6-7b, mistral-large-123b, "
          "internvl2-76b 1; internvl2-76b with 32 patch embeddings a row), "
          "the CPU side from the worker", flush=True)
    train["parity"] = run_train_parity_phase(dev, seed, worker)
    worker.stop()
    mark("train parity")
    gc.collect()
    torch.cuda.empty_cache()
    print("[platform] the learner and the server as real payloads under "
          "the port's platform", flush=True)
    # (p3): the MoE learner under the platform, cut to 2 layers (a
    # checkpoint of all 24 would hold 16 GB)
    platform = {"train": run_platform_train(dev, seed),
                "train_moe": run_platform_train(
                    dev, seed, arch="granite-moe-1b-a400m", layers=2,
                    batch=4, seq=4096, label="p3"),
                "serve": run_platform_serve(dev, seed)}
    mark("platform")
    gc.collect()
    torch.cuda.empty_cache()
    print("[compression] (t1c) paper-overhead-100m's (t1) under the train "
          "step's gradient compression (none, int8, topk), the "
          "error-feedback identity, fp32 parity, (p4) an int8 platform job "
          "killed and restored, the int8 all-reduce on one NCCL rank",
          flush=True)
    compression = run_compression_phase(dev, seed)
    mark("compression")

    main_run = runs["a_no_prefix_cache"]
    fl = next(r for r in flash_rows if r["label"] == "qwen3 S1024")
    dc = next(r for r in decode_rows if r["label"] == "qwen3 G2")
    wk = next(r for r in wkv_rows if r["label"] == "rwkv6-7b serving")
    fl256 = next(r for r in flash_rows if r["label"] == "rg hd256 S2560 w2048")
    rl = next(r for r in rglru_rows if r["label"] == "recurrentgemma serving")
    rg_launches = rgemma["serve"]["launches"]
    ml = next(r for r in mla_rows if r["label"] == "deepseek-v2 serving")
    fl64 = next(r for r in flash_rows if r["label"] == "paper train B8 S1024")
    pb = next(r for r in bwd_rows if r["label"] == "paper train")
    qb = next(r for r in bwd_rows if r["label"] == "qwen3 train")
    fl_g = next(r for r in flash_rows if r["label"] ==
                "granite train B4 S4096")
    gb = next(r for r in bwd_rows if r["label"] == "granite train")
    paper_train = train["paper-overhead-100m"]
    granite_launches = train["granite-moe-1b-a400m"]["launches"]
    wb = next(r for r in wkv_bwd_rows if r["label"] == "rwkv6-7b train (t4)")
    rwkv_launches = train["rwkv6-7b"]["launches"]
    ds_launches = train["deepseek-v2-236b"]["launches"]
    rg_train = train["recurrentgemma-9b"]["launches"]
    rgb = next(r for r in rglru_bwd_rows if r["label"] == RGLRU_T6)
    rlt = next(r for r in rglru_rows if r["label"] == RGLRU_T6)
    fbt = next(r for r in bwd_rows if r["label"] == RG_T6)
    fft = next(r for r in flash_rows if r["label"] == RG_FWD_T6)
    keys = ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library")

    def row_of(rows, label, launches):
        r = next(r for r in rows if r["label"] == label)
        return dict({k: r[k] for k in keys}, launches=launches,
                    max_abs_err=r["max_abs_err"], tol_used=r["tol_used"])

    q_l = train["qwen2.5-32b"]["launches"]
    m_l = train["mistral-large-123b"]["launches"]
    g_l = train["gemma2-9b"]["launches"]
    i_l = train["internvl2-76b"]["launches"]
    i_front = dense["i"]["after"]["launches"]
    i_dec = next(r for r in decode_rows if r["label"] == "long B8 pps64 G8")
    gem_bwd = [c[0] for c in gemma2_train_cases()]
    mf = next(r for r in flash_rows if r["label"] == MLA_T5)
    mb = next(r for r in bwd_rows if r["label"] == MLA_T5)
    mla_fwd = dict({k: mf[k] for k in keys},
                   launches=ds_launches["flash_attention_bshd"],
                   max_abs_err=max(r["max_abs_err"] for r in flash_rows
                                   if "mla" in r["label"]))
    mla_bwd = dict({k: mb[k] for k in keys},
                   launches=ds_launches["flash_attention_bwd"],
                   max_abs_err=max(r["max_abs_err"] for r in bwd_rows
                                   if "mla" in r["label"]))
    s_l = train[SEAMLESS]["launches"]
    j_l = seamless["serve"]["launches"]

    def cross_of(label, bwd):
        r = next(r for r in cross_rows if r["label"] == label)
        pre = "bwd_" if bwd else ""
        return dict(shape=r["shape"], ms=r[pre + "ms"],
                    device_ms=r[pre + "device_ms"],
                    plain_ms=r[pre + "plain_ms"],
                    library_ms=r[pre + "library_ms"],
                    library=r[pre + "library"], bound_ms=r[pre + "bound_ms"],
                    bound_by=r[pre + "bound_by"],
                    max_abs_err=r["bwd_max_abs_err" if bwd
                                  else "max_abs_err"],
                    tol_used=r["bwd_tol_used" if bwd else "tol_used"])

    def seamless_of(bwd):
        name = "flash_attention_bwd" if bwd else "flash_attention_bshd"
        return dict(
            {lab: cross_of(lab, bwd) for lab in
             (T11_CROSS, T11_ENCODER, T11_DECODER)
             + (() if bwd else (J_CROSS, J_ENCODER))},
            launches=s_l[name] + (0 if bwd else j_l[name]),
            launches_t11=s_l[name], launches_j=0 if bwd else j_l[name],
            max_abs_err=max(r["bwd_max_abs_err" if bwd else "max_abs_err"]
                            for r in cross_rows),
            faults_tol_used={r["label"]: r["faults_tol_used"]
                             for r in cross_rows})
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:57",
             launches=main_run["launches"]["flash_attention_bshd"],
             max_abs_err=max([r["max_abs_err"] for r in flash_rows]
                             + [r["max_abs_err"] for r in cross_rows]),
             ms=fl["ms"], device_ms=fl["device_ms"], plain_ms=fl["plain_ms"],
             bound_ms=fl["bound_ms"],
             bound_by=fl["bound_by"], library_ms=fl["library_ms"],
             shape="B 4, S 1024, H 16, K 8, hd 128, bf16, causal",
             hd256=dict(
                 shape="B 8, S 2560, H 16, K 1, hd 256, bf16, causal, "
                 "window 2048",
                 launches=rg_launches["flash_attention_bshd"],
                 max_abs_err=max(r["max_abs_err"] for r in flash_rows
                                 if "hd256" in r["label"]),
                 ms=fl256["ms"], device_ms=fl256["device_ms"],
                 plain_ms=fl256["plain_ms"], bound_ms=fl256["bound_ms"],
                 bound_by=fl256["bound_by"],
                 library_ms=fl256["library_ms"],
                 library="SDPA, boolean causal-window mask, enable_gqa"),
             hd64=dict(
                 shape="B 8, S 1024, H 12, K 4, hd 64, bf16, causal "
                 "(paper-overhead-100m's training shape)",
                 launches=paper_train["launches"]["flash_attention_bshd"],
                 max_abs_err=fl64["max_abs_err"], ms=fl64["ms"],
                 device_ms=fl64["device_ms"], plain_ms=fl64["plain_ms"],
                 bound_ms=fl64["bound_ms"], bound_by=fl64["bound_by"],
                 library_ms=fl64["library_ms"],
                 library="SDPA, is_causal, enable_gqa"),
             granite=dict(
                 shape="B 4, S 4096, H 16, K 8, hd 64, bf16, causal "
                 "(granite-moe-1b-a400m's training shape)",
                 launches=granite_launches["flash_attention_bshd"],
                 max_abs_err=fl_g["max_abs_err"], ms=fl_g["ms"],
                 device_ms=fl_g["device_ms"], plain_ms=fl_g["plain_ms"],
                 bound_ms=fl_g["bound_ms"], bound_by=fl_g["bound_by"],
                 library_ms=fl_g["library_ms"],
                 library="SDPA, is_causal, enable_gqa"),
             mla=mla_fwd,
             rg_train=dict({k: fft[k] for k in keys},
                           launches=rg_train["flash_attention_bshd"],
                           max_abs_err=fft["max_abs_err"],
                           lse_err=max(r["lse_err"] for r in bwd_rows
                                       if r["label"] in {c[0] for c in
                                                         rg_train_cases()})),
             qwen2_5=row_of(flash_rows, QWEN25_T7,
                            q_l["flash_attention_bshd"]),
             mistral=row_of(flash_rows, MISTRAL_T8,
                            m_l["flash_attention_bshd"]),
             gemma2=row_of(flash_rows, GEMMA2_FWD_T9,
                           g_l["flash_attention_bshd"]),
             gemma2_serving=row_of(
                 flash_rows, GEMMA2_FWD_H,
                 dense["h"]["launches"]["flash_attention_bshd"]),
             internvl2=row_of(flash_rows, INTERNVL2_T10,
                              i_l["flash_attention_bshd"]),
             internvl2_frontend=row_of(flash_rows, INTERNVL2_FRONTEND,
                                       i_front["flash_attention_bshd"]),
             seamless=seamless_of(False),
             serving_launches={k: dense[k]["launches"]["flash_attention_bshd"]
                               for k in dense},
             lockstep=dict(
                 launches={f"{c}_{lay}": lockstep[c][lay]["launches"][
                     "flash_attention_bshd"] for c in "kl"
                     for lay in ("dense", "paged")},
                 mla_prefill=dict(
                     {k: lockstep["l"]["mla_flash"][k] for k in keys},
                     launches=lockstep["l"]["dense"]["launches"][
                         "flash_attention_bshd"],
                     max_abs_err=lockstep["l"]["mla_flash"]["max_abs_err"],
                     tol_used=lockstep["l"]["mla_flash"]["tol_used"])),
             platform=platform_launches(platform, "flash_attention_bshd")),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/models/attention.py:34",
             gradient_of="flash_attention_jnp (src/repro/models/attention.py"
             ":34) under jax.grad; the reference has no Pallas backward",
             launches=paper_train["launches"]["flash_attention_bwd"],
             max_abs_err=max([r["max_abs_err"] for r in bwd_rows]
                             + [r["bwd_max_abs_err"] for r in cross_rows]),
             ms=pb["ms"], device_ms=pb["device_ms"], plain_ms=pb["plain_ms"],
             bound_ms=pb["bound_ms"], bound_by=pb["bound_by"],
             library_ms=pb["library_ms"], library=pb["library"],
             shape=pb["shape"],
             qwen3={k: qb[k] for k in ("shape", "max_abs_err", "ms",
                                       "device_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "library")},
             granite=dict({k: gb[k] for k in (
                 "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms", "library")},
                 launches=granite_launches["flash_attention_bwd"]),
             mla=mla_bwd,
             qwen2_5=row_of(bwd_rows, QWEN25_T7,
                            q_l["flash_attention_bwd"]),
             mistral=row_of(bwd_rows, MISTRAL_T8,
                            m_l["flash_attention_bwd"]),
             internvl2=row_of(bwd_rows, INTERNVL2_T10,
                              i_l["flash_attention_bwd"]),
             seamless=seamless_of(True),
             platform=platform_launches(platform, "flash_attention_bwd")),
        dict(name="flash_attention_bwd_hd256", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/models/attention.py:34",
             gradient_of="flash_attention_jnp (src/repro/models/attention.py"
             ":34) under jax.grad at recurrentgemma-9b's local layers (hd "
             "256, MQA, window 2,048); the reference has no Pallas backward",
             launches=rg_train["flash_attention_bwd"],
             max_abs_err=max(r["max_abs_err"] for r in bwd_rows
                             if r["label"] in {c[0] for c in
                                               rg_train_cases()}),
             ms=fbt["ms"], device_ms=fbt["device_ms"],
             plain_ms=fbt["plain_ms"], bound_ms=fbt["bound_ms"],
             bound_by=fbt["bound_by"], library_ms=fbt["library_ms"],
             library=fbt["library"], shape=fbt["shape"],
             parts_device_ms=fbt["parts_device_ms"], plan=fbt["plan"],
             faults_tol_used={r["label"]: r["faults_tol_used"]
                              for r in bwd_rows if r["label"] in
                              {c[0] for c in rg_train_cases()}
                              | set(gem_bwd)},
             gemma2=dict(row_of(bwd_rows, GEMMA2_T9,
                                g_l["flash_attention_bwd"]),
                         max_abs_err_all=max(r["max_abs_err"]
                                             for r in bwd_rows
                                             if r["label"] in gem_bwd),
                         parts_device_ms=next(
                             r["parts_device_ms"] for r in bwd_rows
                             if r["label"] == GEMMA2_T9),
                         global_layers=row_of(bwd_rows, GEMMA2_GLOBAL_T9,
                                              g_l["flash_attention_bwd"]))),
        dict(name="paged_decode_fwd", route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/paged_attention.py:120",
             launches=main_run["launches"]["paged_decode_bhd"],
             max_abs_err=max(r["max_abs_err"] for r in decode_rows),
             ms=dc["ms"], device_ms=dc["device_ms"], plain_ms=dc["plain_ms"],
             bound_ms=dc["bound_ms"], bound_by=dc["bound_by"],
             library_ms=None, cold_ms=dc["cold_ms"],
             ms_ungrouped=dc["ms_ungrouped"],
             device_ms_ungrouped=dc["device_ms_ungrouped"],
             also_replaces="src/repro/kernels/paged_attention.py:76",
             lockstep_launches=lockstep["k"]["paged"]["launches"][
                 "paged_decode_bhd"],
             dense_decode_attention=lockstep["k"]["dense_decode"],
             platform=platform_launches(platform, "paged_decode_bhd"),
             serving_launches=dict(
                 {k: dense[k]["launches"]["paged_decode_bhd"]
                  for k in dense}, j=j_l["paged_decode_bhd"]),
             internvl2=dict(
                 {k: i_dec[k] for k in (
                     "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "max_abs_err", "live_keys")},
                 shape="B 8, K 8, G 8, hd 128, ps 128, 64 pages a row, bf16",
                 launches=dense["i"]["launches"]["paged_decode_bhd"]
                 + i_front["paged_decode_bhd"],
                 max_abs_err_g8=max(r["max_abs_err"] for r in decode_rows
                                    if r["label"].endswith("G8"))),
             shape="B 8, K 8, G 2, hd 128, ps 128, bf16, ragged"),
        dict(name="wkv6_fwd", route="cuda",
             source="src/repro_torch/csrc/rwkv6_wkv.cu",
             replaces="src/repro/kernels/rwkv6_wkv.py:49",
             launches=rwkv["serve"]["launches"]["wkv6_bshn"],
             max_abs_err=max(r["max_abs_err"] for r in wkv_rows),
             ms=wk["ms"], device_ms=wk["device_ms"], plain_ms=wk["plain_ms"],
             bound_ms=wk["bound_ms"], bound_by=wk["bound_by"],
             library_ms=None, cold_ms=wk["cold_ms"],
             shape=wk["shape"],
             training=dict(
                 shape=wb["shape"] + f", state checkpoints every "
                 f"{wb['checkpoint_every']} steps",
                 launches=rwkv_launches["wkv6_bshn"], ms=wb["fwd_ckpt_ms"],
                 device_ms=wb["fwd_ckpt_device_ms"],
                 plain_ms=wb["fwd_ckpt_plain_ms"],
                 ms_without_checkpoints=wb["fwd_ms"])),
        dict(name="wkv6_bwd", route="cuda",
             source="src/repro_torch/csrc/rwkv6_wkv_bwd.cu",
             replaces="src/repro/models/rwkv.py:45",
             gradient_of="wkv6_chunked (src/repro/models/rwkv.py:45) under "
             "jax.grad; the reference has no Pallas backward",
             launches=rwkv_launches["wkv6_bwd"],
             max_abs_err=max(r["max_abs_err"] for r in wkv_bwd_rows),
             ms=wb["ms"], device_ms=wb["device_ms"], plain_ms=wb["plain_ms"],
             bound_ms=wb["bound_ms"], bound_by=wb["bound_by"],
             library_ms=None,
             library="none: no PyTorch call computes WKV6's gradient",
             moved_bytes=sum(wb["moved_bytes"].values()),
             device_ms_by_kernel=wb["device_ms_by_kernel"],
             shape=wb["shape"]),
        dict(name="rglru_scan_fwd", route="cuda",
             source="src/repro_torch/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan.py:46",
             launches=rg_launches["rglru_scan_bsr"],
             max_abs_err=max(r["max_abs_err"] for r in rglru_rows),
             ms=rl["ms"], device_ms=rl["device_ms"], plain_ms=rl["plain_ms"],
             bound_ms=rl["bound_ms"], bound_by=rl["bound_by"],
             library_ms=None, shape=rl["shape"], plan=rl["plan"],
             training=dict({k: rlt[k] for k in (
                 "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "plan")},
                 launches=rg_train["rglru_scan_bsr"])),
        dict(name="rglru_scan_bwd", route="cuda",
             source="src/repro_torch/csrc/rglru_scan.cu",
             replaces="src/repro/models/recurrent.py:40",
             gradient_of="rglru_scan_assoc (src/repro/models/recurrent.py:40)"
             " under jax.grad; the reference has no Pallas backward",
             launches=rg_train["rglru_scan_bwd"],
             max_abs_err=max(r["max_abs_err"] for r in rglru_bwd_rows),
             ms=rgb["ms"], device_ms=rgb["device_ms"],
             plain_ms=rgb["plain_ms"], bound_ms=rgb["bound_ms"],
             bound_by=rgb["bound_by"], library_ms=None,
             library=rgb["library"], shape=rgb["shape"], plan=rgb["plan"],
             b2={k: r[k] for r in rglru_bwd_rows if r["label"] == "(t6) B2 h0"
                 for k in ("shape", "ms", "device_ms", "bound_ms", "plan")},
             faults_tol_used={r["label"]: r["faults_tol_used"]
                              for r in rglru_bwd_rows}),
        dict(name="mla_paged_decode_fwd", route="cuda",
             source="src/repro_torch/csrc/mla_decode.cu",
             replaces="src/repro/kernels/paged_attention.py:182",
             launches=deepseek["serve"]["launches"]["mla_paged_decode_bhd"],
             max_abs_err=max(r["max_abs_err"] for r in mla_rows),
             ms=ml["ms"], device_ms=ml["device_ms"], plain_ms=ml["plain_ms"],
             bound_ms=ml["bound_ms"], bound_by=ml["bound_by"],
             library_ms=None, cold_ms=ml["cold_ms"],
             library="none: no PyTorch call reads a paged latent pool",
             shape=ml["shape"],
             lockstep_launches=lockstep["l"]["paged"]["launches"][
                 "mla_paged_decode_bhd"],
             long_tables=[{k: r[k] for k in ("label", "device_ms", "cold_ms",
                                             "bound_ms", "live_keys")}
                          for r in mla_rows if r["label"].startswith("long")]),
    ]
    serve = {name: {k: v for k, v in r.items()} for name, r in runs.items()}
    print(json.dumps({"serve": serve, "trace": traces, "lockstep": lockstep,
                      "parity": parity,
                      "wkv6": wkv_rows, "rwkv": rwkv, "rglru": rglru_rows,
                      "flash": flash_rows, "recurrentgemma": rgemma,
                      "mla": mla_rows, "deepseek": deepseek,
                      "dense_serve": dense, "seamless": seamless,
                      "flash_cross": cross_rows,
                      "flash_bwd": bwd_rows, "wkv6_bwd": wkv_bwd_rows,
                      "rglru_bwd": rglru_bwd_rows,
                      "train": train,
                      "moe_layer": moe_layer,
                      "platform": platform,
                      "compression": compression,
                      "build_s": build_s, "phase_s": phase_s,
                      "total_s": time.perf_counter() - t_start}))
    print("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items())
          + f"; total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
