#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with one H100:

    python3 chip_smoke.py

Phases, each printing JSON objects, one per line:

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and read the card's name and power
   limit from ``nvidia-smi``;
2. kernels: hold every kernel against its plain PyTorch version on the card
   (the sort and gather kernels bit for bit: ``sort_blocks`` at every block
   2^1..2^14, ``merge_pass`` at every run 2^0..2^20 and at n = 2^22 up to
   run 2^21, the widest strided pass, on tied int32 keys and float32 keys
   with -0.0 beside +0.0, compared by their bits; on every tied input past
   block 2 and run 1 the plain version must place some tie elsewhere than
   ``torch.sort(..., stable=True)``, so tie order is exercised, and on every
   float input some zero key must leave with another sign than the key that
   entered with its value, so signed zeros are exercised; float keys with
   NaNs of both signs and several payloads beside signed zeros and
   infinities, where NaNs must spread and some must leave other than
   canonical, so the NaN rule is exercised; ``gather_rows`` on every route
   and unit of its plan, ragged, misaligned, blocked, on the partition
   argsort's indices and a wide bf16 row; the merge-sort and gather
   kernels' registers, spills and shared memory, no spills allowed; the
   attention kernels within
   ``ATTN_TOL``, which must also reject three planted faults; the flash kernel
   on both routes, each check printing the route it took: bf16 at hd 64,
   128 and 256 on the tensor cores, at gemma-2b's, qwen3-0.6b's and
   granite-20b's widths and a ragged hd-64 prefill, f32 and bf16 hd 32 on
   the CUDA cores; the split paged kernel at gemma-2b's decode shape at
   lengths 1, S, mid-chunk and ragged, at granite-20b's 48 query heads on
   one KV head, and in f32, against its plain version at the same split
   plan, which must also reject a ragged last page skipped and a middle
   chunk dropped), print the registers and spills of every tensor-core
   flash and every paged instantiation, and time kernel, plain version and
   the PyTorch library call that computes the same function with CUDA
   events (the flash kernel also at qwen3-0.6b's and granite-moe-3b's widths,
   the paged kernel also at granite-moe-3b's, and with P rounded
   once to bf16, a probe; the sort, gather, flash, paged and scan kernels
   and the library calls beside them also by device time from a profiler
   window; ``sort_blocks`` also on float32 keys, without and with a NaN in
   every block; the gather also on the partition argsort's indices, on the
   identity beside a copy of the same rows, on a wide bf16 row, and with x
   already in L2);
3. session: drive the spill engine's main path, ``Session(make_backend(...))
   .run(tasks)``, at a TPC-H SF1-shaped size (EMS over ``l_orderkey``, EHJ of
   orders with lineitem, EAGG of lineitem by key), with the launch counters
   set to 0 just before and read just after; hold it against the port's own
   simulator (ledgers field for field, output pages byte for byte) and the
   operators' oracles; then (3b) the TPC-H Q3 and Q18 skeletons of
   ``benchmarks/bench_tpch.py`` at SF1 (lineitem, orders, customer) through
   the logical-plan frontend, ``compile_plan(...).run(replan="measured")``
   on the card's backend, each held to the same plan on the simulator (DAG,
   join choice, ledgers, every task's output pages), its final sort's output
   sorted, its DAG makespan no longer than the serial latency, no fallback,
   and every sort and gather kernel launched;
4. serve: serve gemma-2b at full width (random bf16 weights from a seeded
   generator on the card) through ``ServeEngine.submit``: 4 requests, 2
   slots, the launch counters set to 0 just before and read just after;
   every attention call must have gone through the flash (prefill, every
   launch on its tensor-core route) and paged (decode) kernels, and the
   last decode step of two requests must
   agree with a prefill of the same tokens (final hidden state and logits);
   then a profiler window over one prefill and a few decode steps splits
   the device time into attention kernels, matrix products and the rest;
5. mamba: hold the SSD scan kernel against its plain version bit for bit
   (and reject a planted fault), then serve mamba2-370m at full width and
   all 48 layers the same way (4 requests, 2 slots; every prefill layer's
   inter-chunk scan through the kernel), with two decode-against-prefill
   checks, the second across chunks and shown to reject a planted state
   fault, and profiler windows over a prefill and over decode steps split
   into the scan kernel, matrix products and the rest;
5b. moe: serve granite-moe-3b-a800m at full width and all 32 layers the same
   way (4 requests, 2 slots, capacity factor 1.25, dropped assignments
   counted per prefill; every prefill layer through the flash kernel's
   tensor-core route, every decode layer through the paged kernel), check
   decode against prefill at capacity factor 40 (nothing drops) on hidden
   state, logits and the share of routings that agree, and reject a planted
   misrouting decode; split a 2048-token prefill and 8 decode steps into
   attention kernels, expert products, other products and the rest; then
   hold ``remop_dispatch``/``remop_combine`` at the prefill's shape, on the
   expert ids of a served layer, bit for bit to their plain versions and by
   value to the MoE layer's dense scatter, and time them beside it;
5c. mla: hold the flash kernel at deepseek-v2-lite's prefill widths (q/k
   192, v 128, 16 heads, on the tensor cores, in the kernel's and the
   model's layouts) and the paged kernel's latent route (q [B, 16, 576]
   against the latent cache [B, S, 576], the values its first 512 columns)
   at S 64, 2048 and 4096 in bf16 and f32 against their plain versions under
   ``ATTN_TOL``, with lengths below S and NaN rows past them that must never
   reach the output; reject two planted faults (the scale 1/sqrt(576) for
   1/sqrt(192), the rope term dropped); hold one MLA layer's absorbed decode
   to ``mla_forward``'s rows at 16 positions of 2048 tokens at full width
   within ``MLA_LAYER_TOL`` and reject a decode roped one position late;
   serve deepseek-v2-lite-16b at full width and all 27 layers the same way
   as 5b (every prefill layer through the flash kernel at 192 / 128 on the
   tensor cores, every decode layer through the latent route, dropped
   assignments at cf 1.25), split a prefill and 8 decode steps as in 5b, and
   time both routes beside their bounds and SDPA;
5d. hybrid: hold the flash kernel with a sliding window (recurrentgemma's
   ``[1, 10, S, 256]`` on one KV head at W 2048, S 2048 / 3000 / 4096, and
   a GQA shape at W 1000) on both routes against its plain version under
   ``ATTN_TOL`` (the route read from the launch counters), reject the
   kernel at W against a plain version without it, and a kernel whose
   window's edge is a key off (on keys
   planted to dominate at distance W and W - 1, both classes shown to
   decide their rows), show window 0 bit for bit a window as wide as the
   keys; hold the paged kernel over a 2048-slot ring at G = 10 (full, below
   full, wrapped); hold one local-attention layer's ring decode to its
   windowed forward at full width across the wrap within
   ``HYBRID_LAYER_TOL`` and reject a ring written a slot ahead and one read
   a slot short; serve recurrentgemma-2b at full width and all 26 layers
   the same way as 4 (prompts up to 4096 tokens, past the window; every
   local-attention prefill through the windowed flash kernel on the tensor
   cores, every local-attention decode through the paged kernel over its
   ring, the RG-LRU in PyTorch), check decode against prefill across the
   ring's wrap within ``HYBRID_TOL`` (hidden state, logits, every RG-LRU
   state, every ring) and print what the two ring faults do there, split a
   4096-token prefill and a decode step into attention kernels, the
   RG-LRU's scan and other elementwise work, products and the rest, and
   time both kernel routes beside their bounds and SDPA;
5e. vlm: hold the flash kernel with a prefix (paligemma's ``[1, 8, P + L,
   256]`` on one KV head at P 256 under text of 8, 200 and 512, P 1024, an
   unaligned P 100) on both routes against its plain version under
   ``ATTN_TOL``, on keys planted at P - 1 and P (both classes shown to
   decide their rows) reject prefix P - 1 and P + 1 on both routes, show
   prefix 0 (and 1) bit for bit the causal call; hold one paligemma
   attention layer at full width to its plain path and its paged decode to
   the forward (``VLM_LAYER_TOL``; a layer without the prefix rejected);
   run paligemma-3b at full width and all 18 layers through ``prefill`` and
   ``decode_step`` (4 requests of 256 patches and 8 to 512 text tokens, 32
   greedy tokens each; every prefill layer through the flash kernel at
   prefix 256 on the tensor cores, every decode layer through the paged
   kernel), every request's last step against a prefill replay within
   ``VLM_TOL``, a prefill and decode breakdown, and time the prefix kernel
   beside its bound and SDPA with the prefix mask;
5f. encdec: hold the flash kernel over every key (bidirectional at
   seamless's ``[1, 16, T, 64]``, T 4096 and 2500; cross-attention from
   decoder rows 1, 64, 300 onto 4096 and 200 encoder rows, S > T included)
   on both routes against its plain version, reject a kernel without the
   ``k >= T`` mask where T is no multiple of the block, hold the paged
   kernel over cross caches of 4096 and 2500 rows at G 1, hd 64; hold one
   encoder layer and one cross-attention at full width to their plain path
   and the cross decode to the forward (``ENCDEC_LAYER_TOL``; a causal
   encoder and a roped cross decode rejected); run seamless-m4t-large-v2 at
   full width and all 48 layers (4 requests of 4096 to 333 frames and 1 to
   64 decoder tokens, 32 greedy tokens each; 24 bidirectional, 24 causal and
   24 cross flash launches a request, 48 paged launches a step), every
   request's last step against a prefill replay within ``ENCDEC_TOL``, a
   breakdown, and time both kernels beside their bounds and SDPA;
5g. softcap: hold the flash kernel with a cap that bites (cap 5 on q times
   8; at least 10% of each check's visible scores past it, the uncapped
   kernel missing ``ATTN_TOL`` by more than 10 times) on both routes
   against its plain version (gemma-2b's prefill in bf16 and f32,
   deepseek's 192 / 128, recurrentgemma's window 2048, paligemma's prefix
   256, hd 32 and f32 on the CUDA cores), and the paged kernel with it
   (gemma-2b's G 8, granite-moe's G 3, a full 2048-slot ring at G 10; bf16
   and f32); hold the paged kernel's int8 route bit for bit to the bf16
   route on the dequantized caches at those shapes and G 1, hd 64, with and
   without a cap, and ``quantize_kv`` on the card byte for byte to the CPU
   on ties at .5 and zero rows; reject four planted faults (the cap after
   the mask, the cap before the scale, the int8 route reading the next
   position's scale, and head 0's scale for every head); time the capped
   kernels at the model's cap of 50 and the int8 route beside their bounds
   (the capped rows' library call: ``flex_attention`` compiled with a tanh
   ``score_mod``); serve gemma-2b with Gemma 2's caps (attention 50, final
   logits 30) as phase 4 does (every flash and paged launch on the capped
   instantiation, the last decode step of two requests against a prefill
   replay), with its breakdown; then decode gemma-2b over its int8 cache
   (one prompt of 2040 tokens, ``pad_caches`` to 4096,
   ``quantize_kv`` on every layer, 32 greedy steps each, timed with only
   the int8 caches on the card, after one full-width layer's int8 decode
   within ``INT8_LAYER_TOL`` of its plain path: every ``gqa_decode`` call
   of those steps replayed on the plain path within ``INT8_LAYER_TOL``,
   every step's logits and hidden state within ``INT8_TOL`` of the plain
   path, every new row byte for byte ``quantize_kv`` on the CPU, the caches
   (hd + 2) / (2 hd) of the bf16 caches' bytes, 18 x 32 int8 launches a
   request), beside the same tokens through the bf16 caches, timed with
   only those on the card (the logits' gap and argmax agreement printed,
   tokens/s, step time, peak memory and idle share of both);
5h. train: hold the flash backward kernel (``flash_attention_bwd``: dq, dk,
   dv of the flash kernel, on its tensor-core route ``tc`` at every bf16
   width, dkdv split over several CTAs a key block where KV heads are few,
   and its CUDA-core route ``simt`` for f32) against its plain version
   under ``ATTN_TOL`` at ``BWD_CHECKS``' shapes (qwen3-0.6b's training
   shape, gemma-2b, every key, MLA's 192 / 128, window 2048, prefix 256,
   softcap 50, 8 query heads on one KV head at hd 128 and 64 with q 8 times
   the unit scale (their dkdv split into runs of at most 4,096 rows), 48
   on one KV head at hd 128 (past the split's cap: runs of 1,024 rows),
   granite-moe-3b-a800m's training shape (G 3 split in two inside a head)
   plain and with q 8 times the unit scale, recurrentgemma-2b's training
   shape, ragged, S < T, cross S > T, f32, paligemma-3b's training shape
   (prefix 256 on one KV head at B 4, S 2048: a call with a prefix walks
   runs of at most 256 rows) plain and with q 8 times the unit scale; each
   row's route and mask kinds
   asserted by the launch counters), two calls equal bit for bit (gemma-2b's with
   its dkdv split over several CTAs), the Function's forward equal to the
   no-grad forward bit for bit, the forward's lse against its plain version
   (qwen3-0.6b's shape, prefix 200 at hd 64, gemma-2b's and MLA's), seven
   planted faults rejected (D dropped, on the tc route and at hd 16, dK and
   dV from head 0 of a group, a key one past the prefix, the cap's
   derivative left out, lse one row off, one split's partial dropped, dK's
   scale dropped), the forward at reduced MLA's (24, 16) against its plain
   version, registers and spills of every instantiation, and time the
   ``tc`` route at qwen3-0.6b's shape, gemma-2b's, MLA's and G 48's, and
   the ``simt`` route at the f32 shape and at the reduced widths (hd 16,
   32, (24, 16)), beside each bound, plain version and SDPA's backward;
   hold one qwen3-0.6b block's gradients at 4 x 2048 tokens to the plain
   path (``TRAIN_LAYER_TOL``; a backward without D rejected); train
   qwen3-0.6b at full width through ``launch.train.main`` (20 steps of 4 x
   2048 tokens, f32 masters, bf16 activations, full remat, no checkpoints;
   the launch counters set to 0 just before and read just after; every
   backward launch on the ``tc`` route), every loss and grad
   norm finite and the loss falling; train gemma-2b at its published widths
   cut to ``TRAIN_GEMMA_LAYERS`` layers for ``TRAIN_GEMMA_STEPS`` steps (hd
   256, one KV head: every backward launch on the ``tc`` route, its dkdv
   split), then one f32 call of ``remop_flash_attention`` under autograd
   (the ``simt`` route's launches: no model trains in f32); repro's
   fixed-batch rule (30 steps on one [1, 2048] batch, the last loss below
   0.7 of the first); one step's whole-model gradients on the state those
   steps leave, kernel against plain, within ``CONSISTENCY_TOL``; one
   profiled step split into
   products, the flash forward and backward, the optimizer and the rest,
   with step seconds, tokens/s, model FLOPs and their share of the bf16
   peak, and peak memory; then at the published widths cut to
   ``TRAIN_RESUME_LAYERS`` layers, the step-10 checkpoint restored and
   steps 11..20 run again (losses within ``TRAIN_RESUME_TOL``);
8b. train_ssm: hold the scan's backward kernel (``ssd_scan_bwd``: dstates
   and ddecays of the forward kernel) against its plain version at
   ``SCAN_BWD_CASES``' shapes (mamba2-370m's training shape, the forward
   checks' shapes: sigmoid decays, decays near 1, bf16, P * N = 15,
   misaligned bases; dstates bit for bit, ddecays within its sum-order
   bound, two calls equal bit for bit), reject a backward that drops the
   carried G, and time it beside its bound and plain version; hold one
   mamba2-370m SSD block's gradients at 4 x 2048 tokens with Mamba-2's dt
   initialisation to the plain path (``SSM_LAYER_TOL``; a backward without
   ddecays rejected); train mamba2-370m at full width and all 48 layers
   through ``launch.train.main`` (20 steps of 4 x 2048 tokens, full remat,
   no checkpoints; the launch counters set to 0 just before and read just
   after: the scan forward twice a layer a step, its backward once), every
   loss and grad norm finite, one profiled step split into products, the
   scan, its backward, the optimizer and the rest, one step's whole-model
   gradients at Mamba-2's dt initialisation, kernel against plain, within
   ``CONSISTENCY_TOL``, and steps 11..20 again from the step-10 checkpoint
   at ``SSM_RESUME_LAYERS`` layers;
8c. train_moe: train the MoE families at their published widths through
   ``launch.train.main`` (20 steps of 4 x 2048 tokens, f32 masters updated
   in place, full remat; the launch counters set to 0 just before and read
   just after: every flash backward on the ``tc`` route, one a layer a
   step, deepseek-v2-lite's at (192, 128)): granite-moe-3b-a800m cut to 8
   layers without checkpoints, deepseek-v2-lite-16b (MLA with MoE) cut to
   2 layers (``MOE_TRAIN_FAMILIES``); per family the losses finite and
   falling, step seconds, tokens/s, model FLOPs of the active parameters
   and their share of the bf16 peak, peak memory, the assignments the
   dispatch drops a step, one profiled step by kind, the first step's
   whole-model gradients kernel against plain within ``CONSISTENCY_TOL``
   (the plain path replays the kernel path's routing; under remat the
   recomputed forward must route as the forward did), and steps 11..20
   again from the step-10 checkpoint (granite-moe at 2 layers, deepseek at
   its 2);
8d. train_hybrid: hold one recurrentgemma-2b local-attention block's
   gradients at 2 x 4096 tokens to the plain path (``TRAIN_LAYER_TOL``; a
   backward handed window 0 rejected); train recurrentgemma-2b at its
   published widths cut to 14 of 26 layers through ``launch.train.main`` (20
   steps of 2 x 4096 tokens, past the window of 2048; f32 masters updated in
   place, full remat, no checkpoints; the launch counters set to 0 just
   before and read just after: one windowed ``tc`` backward a local layer
   a step, the windowed forward twice), the losses finite and falling, step
   seconds, tokens/s, model FLOPs over the window's pairs and their share
   of the bf16 peak, peak memory, one profiled step split into products,
   the flash forward and backward, AdamW, the RG-LRU's scan and its other
   work (each with its backward) and the rest, the first step's
   whole-model gradients kernel against plain within ``CONSISTENCY_TOL``,
   steps 11..20 again from the step-10 checkpoint at one Griffin period (3
   layers), and the windowed backward timed at the trainer's shape beside
   its bound, plain version and SDPA's backward with the band as a mask;
8e. train_vlm: hold one paligemma-3b attn block's gradients at 4 x 2048
   positions with the 256 patches as prefix to the plain path
   (``TRAIN_LAYER_TOL``; a backward handed prefix 0 rejected); train
   paligemma-3b at its published widths and all 18 layers through
   ``launch.train.main`` (20 steps of 4 x 2048 positions, 256 patches and
   1792 text tokens each; f32 masters updated in place, full remat, no
   checkpoints; the launch counters set to 0 just before and read just
   after: one prefix ``tc`` backward a layer a step, the prefix forward
   twice), the losses finite and falling, step seconds, tokens/s, model
   FLOPs over the prefix mask's pairs and their share of the bf16 peak,
   peak memory, one profiled step by kind, the first step's whole-model
   gradients (``frontend/proj_in/w`` and the embedding among them) kernel
   against plain within ``CONSISTENCY_TOL`` beyond the plain path's own
   floor (a backward handed prefix 0 rejected), steps 11..20 again from the
   step-10 checkpoint at ``VLM_RESUME_LAYERS`` layers, and the prefix
   backward timed at the trainer's shape beside its bound, plain version
   and SDPA's backward with the prefix-LM mask;
8f. train_encdec: hold one seamless-m4t-large-v2 encoder block's (every
   key) and one decoder block's (causal self-attention, then
   cross-attention over an encoder output drawn apart) gradients at 4 x
   2048 rows to the plain path (``TRAIN_LAYER_TOL``; a cross backward
   handed prefix 0 rejected); train seamless-m4t-large-v2 at its published
   widths and all 24 + 24 layers through ``launch.train.main`` (20 steps of
   4 x 2048 tokens and 4 x 2048 frames in two microbatches; f32 masters
   updated in place, the decoder rematted, the encoder not; no
   checkpoints; the launch counters set to 0 just before and read just
   after: ``encdec_launches``, 48 every-key ``tc`` backwards and 24 causal
   ones a step and microbatch), the losses finite and falling, step
   seconds, tokens/s, model FLOPs and their share of the bf16 peak, peak
   memory, one profiled step by kind, the first step's whole-model
   gradients (``frontend/proj_in/w`` and the encoder's among them) kernel
   against plain within ``CONSISTENCY_TOL`` beyond the plain path's own
   floor (a cross backward handed prefix 0 rejected), steps 11..20 again
   from the step-10 checkpoint at ``ENCDEC_RESUME_LAYERS`` +
   ``ENCDEC_RESUME_LAYERS`` layers, and the encoder's every-key backward
   timed at the trainer's shape beside its bound, plain version and SDPA's
   ``is_causal=False`` backward;
8g. train_reduced: every config of ``ARCHS`` at ``configs.reduced()``
   (heads of 16; MLA's q/k 24 over v 16) through ``launch.train.main``
   (20 steps of 4 x 64 tokens, no checkpoints; the launch counters set to
   0 just before and read just after: every flash launch on the simt
   route, one backward an attention call a step), repro's fixed-batch
   rule, and one step's loss and whole-model gradients on the card held to
   the same state and batch on the CPU (``REDUCED_LOSS_TOL``,
   ``REDUCED_GRAD_TOL``; a backward that drops D rejected);
   the trainers' checkpoint bytes are reckoned before the run
   (``checkpoint_reckoning``, at most ``CHECKPOINT_LIMIT_GIB``);
6. matmul: print the H100 planner's REMOP and conventional tile plans for
   the five LLM products of ``benchmarks/bench_kernel_policy.py`` (full
   widths and token blocks) with each kernel instantiation's occupancy,
   registers and spills, run ``remop_matmul`` in bf16 at every product
   under both plans with the launch counters set to 0 just before and read
   just after (every call must take the tensor-core kernel's TMA route),
   then hold every result to the plain version within
   ``MM_NOISE``/``MM_ULP``/``MM_REL`` (TF32 off), check the JAX tests' small
   shapes and explicit tiles in f32 and bf16, a misaligned A (the
   element-staged route) and the conventional f32 plan at deepseek qkv (the
   f32 kernel's sub-steps), reject two planted faults (a dropped last K
   step, a B column tile rolled by one), and time kernel, ``remop_matmul``,
   plain version and ``torch.matmul`` with CUDA events (the report row's
   kernel and ``torch.matmul`` also by device time), and three tile
   probes;
7. report: per-query and per-request seconds, the card's peak memory, and
   one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the script exits non-zero without that line; it also exits non-zero when
no CUDA device is present or when ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import typing
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks.  HBM3 bandwidth and dense bf16 tensor-core
# operations (attention's and the matmul's products) are the port's
# ``H100.hbm_bandwidth`` and ``H100.peak_flops`` (``core/cost_model.py``),
# read by load_peaks() once the port is importable.  32-bit operations
# outside the tensor cores (the float32 rate; the sort kernels compare 32-bit
# keys), which the spec does not carry, are stated here.
HBM_BYTES_PER_S = float("nan")
BF16_OPS_PER_S = float("nan")
ALU_OPS_PER_S = 67e12

# TPC-H SF1, spilled in DuckDB's 256 KiB blocks.
KEY_PAGE_ROWS = 32_768  # int64 keys per page
ROW_PAGE_ROWS = 16_384  # (key, payload) int64 rows per page
EMS_PAGES = 184  # 6,029,312 l_orderkey values
ORDERS_ROWS = 1_500_000
LINEITEM_ROWS = 6_001_215
KEY_DOMAIN = 6_000_000
PARTITIONS = 64
LEVELS = (("dram", 256), ("rdma", 4096), "ssd")
BUDGET_PAGES = 128.0  # 32 MiB
# The Q3 and Q18 DAGs (phase 3b) add SF1's customer table; Q3's filter
# c_mktsegment = 'BUILDING' keeps one market segment of five.
CUSTOMER_ROWS = 150_000
CUSTOMER_FILTER = 0.2
TPCH_QUERIES = ("q3", "q18")

# gemma-2b serving: 4 requests through 2 slots, so that a slot takes a
# second request after its first; every phase through ServeEngine serves as
# many (the "scale" line names the cut).
SERVE_ARCH = "gemma-2b"
PROMPT_LENS = (2048, 1000, 777, 64)
MAX_NEW_TOKENS = 32
MAX_LEN = 4096
SLOTS = 2
SEED = 0
CHECK_RIDS = (1, 2)  # the 1000- and 777-token prompts: ragged blocks and pages
# Decode step against a prefill of the same tokens, relative L2 error of the
# final hidden state and of the logits: the two paths round differently in
# bf16 (matrix products of 1 row against products of S rows, the paged
# kernel against the flash kernel), nothing else.
CONSISTENCY_TOL = 3e-2

# mamba2-370m serving: 4 requests through SLOTS slots.  A prompt is at most
# one chunk (256) or a multiple of it, as ``ssd_forward`` requires.
MAMBA_ARCH = "mamba2-370m"
MAMBA_PROMPT_LENS = (2048, 1280, 768, 225)
MAMBA_CHECK_RID = 3  # 225 + 31 = 256 tokens at its last decode step: one chunk
MAMBA_CROSS = (1792, 2048)  # prefill 7 chunks, decode to 8; against a prefill of 8
# Decode against prefill, set before the first run at 48 layers: the
# relative L2 error of the final hidden state and of the logits (bf16
# products of one row against products of S rows, the recurrent step
# against the chunked form; gemma-2b's check reads 1.4-1.5% after its 18
# layers), and, per SSM head of every layer, the relative L2 error of the
# state after the last token (the recurrence is in f32; its inputs carry
# the bf16 noise of the layers below).  At random init the SSM adds well
# under 1% to the residual stream, so hidden state and logits barely see
# the scan: the per-head states are what rejects a wrong carry.
MAMBA_TOL = {"hidden": 5e-2, "logits": 5e-2, "state": 1e-1}

# granite-moe-3b-a800m serving: gemma-2b's traffic (PROMPT_LENS, MAX_NEW_TOKENS,
# SLOTS, MAX_LEN), 40 experts top-8 at capacity_factor 1.25.
MOE_ARCH = "granite-moe-3b-a800m"
# Decode against prefill at capacity_factor = n_experts (nothing drops), set
# before the first card run: the relative L2 error of the final hidden state
# and of the logits (gemma-2b's check reads 1.4-1.5% after 18 layers; here 32
# layers, and a router whose near-ties the two paths' bf16 rounding may
# decide otherwise, each such flip moving one token's expert mix in one
# layer).  The share of (token, layer) routings, as sets of experts, on which
# the two paths agree is reported beside them: at random init it reads
# 0.83-0.90, the 8th and 9th experts' logits lying closer than the paths'
# rounding moves them, so it is no gate.
MOE_TOL = {"hidden": 5e-2, "logits": 5e-2}

# deepseek-v2-lite-16b serving (MLA + MoE): gemma-2b's traffic (PROMPT_LENS,
# MAX_NEW_TOKENS, SLOTS, MAX_LEN), 64 experts top-6 and 2 shared at
# capacity_factor 1.25, every prefill layer through the flash kernel at q/k
# width 192 and v width 128, every decode layer through the paged kernel's
# latent route (576 / 512).
MLA_ARCH = "deepseek-v2-lite-16b"
# The latent route's checks: cache lengths S and, per S, the lengths (all
# below S, a NaN tail past each) of a batch of two.
LATENT_CHECKS = ((64, (50, 1)), (2048, (2047, 1000)), (4096, (4095, 2077)))
# One MLA layer at full width: its absorbed decode at MLA_LAYER_POSITIONS
# against mla_forward's rows of the same S = MLA_LAYER_SEQ tokens.  Both
# compute the same function in bf16 along other paths (forward: per-head
# K = c_kv W_uk and V = c_kv W_uv, rounded to bf16, through the flash
# kernel; decode: q W_uk^T rounded to bf16 against c_kv, the context then
# through W_uv), so each row's relative L2 error is bf16 rounding, about
# 2^-8 per rounding.  Set before the first card run from a CPU rehearsal at
# the same widths and seed with the plain kernels: 0.39-0.43% a row (0 at
# position 0, where both attend to one row).  A decode that ropes the step
# at the next position (an off-by-one in the step's position) read 6.3-49%
# there, and must be rejected on every row but the first.
MLA_LAYER_SEQ = 2048
MLA_LAYER_POSITIONS = (0, 1, 2, 5, 17, 63, 64, 127, 300, 511, 777, 1024, 1500, 1999, 2046, 2047)
MLA_LAYER_TOL = 2e-2

# recurrentgemma-2b serving (RG-LRU + local attention, window 2048): 4
# requests through SLOTS slots, 32 new tokens each.  4096 and 3000 exceed the
# window in prefill, 2040's decode crosses the ring's wrap at position
# 2048, 777 is ragged.
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_PROMPT_LENS = (4096, 2040, 3000, 777)
HYBRID_MAX_LEN = 4160
HYBRID_CHECK_RID = 1  # the 2040-token prompt: its decode steps 2040 .. 2070
# jax.eval_shape of repro's init_params(recurrentgemma-2b), counted.
HYBRID_PARAMS = 2_894_435_840
# The windowed flash kernel's checks: recurrentgemma's prefill, 10 query
# heads on one KV head of 256 at W 2048 (S 2048: the window does not bind;
# 3000 ragged; 4096), and a GQA shape whose window is no multiple of the
# block (W 1000, S 1500, 8 heads on 2 of 128); bf16 on the tensor cores,
# f32 on the CUDA cores.
WINDOW_CHECKS = ((1, 10, 1, 2048, 256, 2048), (1, 10, 1, 3000, 256, 2048),
                 (1, 10, 1, 4096, 256, 2048), (1, 8, 2, 1500, 128, 1000))
# The paged kernel over a ring of 2048 slots at recurrentgemma's decode
# shape (G = 10, hd 256): the ring full (every position after the wrap) and
# below it.
RING_LENGTHS = (2048, 2047, 1000, 1)
# One local-attention layer at full width on HYBRID_LAYER_SEQ tokens: its
# decode at HYBRID_LAYER_POSITIONS (the ring packed from the forward's rows
# before the position) against gqa_forward's row there.  Both compute the
# same function in bf16 along other paths (one-row products and the paged
# kernel against S-row products and the flash kernel), so each row's
# relative L2 error is bf16 rounding.  Set before the first card run from a
# CPU rehearsal at the same widths and seed with the plain kernels: 0-0.14%
# a row (MLA's layer check read 0.4% on the card, where one-row products
# round otherwise).  A ring written a slot ahead read 1.97-100% on every
# row, one read a slot short 2.0-100% on every row before the wrap (after
# it the ring is full either way, and the fault changes nothing).  Set at
# 1e-2 for the first card run, which read 0-0.095% a row and the faults
# 1.14-100% and 1.72-100% where they bite (their draws differ from the
# CPU's): the ring written a slot ahead came within 14% of 1e-2 at position
# 2047, so the rule was tightened to 5e-3, 5x the worst correct row.
HYBRID_LAYER_SEQ = 2600
HYBRID_LAYER_POSITIONS = (0, 1, 2, 63, 777, 2046, 2047, 2048, 2049, 2100, 2599)
HYBRID_LAYER_TOL = 5e-3
# Decode against prefill for the 2040-token request after its decode crossed
# the wrap (2071 tokens at the last step; the window binds for the last
# rows): the relative L2 error of the final hidden state and of the logits,
# of each RG-LRU layer's f32 state after the last token, and of each
# local-attention layer's ring against the prefill's packed ring (the
# largest over layers).  Set before the first card run from CPU rehearsals
# at full width with the plain kernels, cut to 5 and 11 layers: hidden
# state 0.71% / 1.22%, logits 0.75% / 1.25%, states 0.63% / 1.13%, rings
# 0.05% / 0.85%, growing with depth (gemma-2b's 18 layers read 1.4-1.5% on
# the card).  A ring written a slot ahead read 17.4% in the rings (5
# layers) and must be rejected; hidden state, logits and states did not see
# it (0.74%), nor any metric a ring read a slot short: the fault touches
# only the 8 steps before the wrap, by ~2% of one attention output each, and
# the layer check is what rejects it.  All four were 5e-2 for the first
# card run (26 layers): hidden state 2.35%, logits 2.36%, states 0.43%,
# rings 0.26%, and the slot fault 5.7% in the rings (greedy decoding
# repeats the prompt's last token at random init, so the shifted slots hold
# near-equal keys), within 14% of 5e-2; the ring rule was tightened to
# 2e-2, 7.7x the correct run's and 2.4x the CPU's 11-layer reading.
HYBRID_TOL = {"hidden": 5e-2, "logits": 5e-2, "h": 5e-2, "ring": 2e-2}

# paligemma-3b (prefix-LM VLM: 256 SigLIP patch embeddings of 1152 projected
# in, the gemma-2b backbone, every position seeing the patches): 4 requests
# of the 256 patches and text prompts of VLM_TEXT_LENS tokens, 32 greedy
# tokens each, each request alone at batch 1 through prefill, pad_caches
# and decode_step (ServeEngine takes no patches, as repro's does not).
VLM_ARCH = "paligemma-3b"
VLM_TEXT_LENS = (8, 64, 200, 512)
VLM_MAX_LEN = 1024  # the decode caches: 256 patches + 512 + 32 tokens fit
# jax.eval_shape of repro's init_params(paligemma-3b), counted.
VLM_PARAMS = 2_511_022_080
# The flash kernel's prefix checks, (P, text tokens) at paligemma's prefill
# shape (8 query heads on one KV head of 256, S = T = P + text): its 256
# patches under text of 8, 200 and 512; the 448-px variant's 1024 patches;
# an unaligned P of 100.  bf16 on the tensor cores, f32 on the CUDA cores.
PREFIX_CHECKS = ((256, 8), (256, 200), (256, 512), (1024, 200), (100, 512))
PREFIX_EDGE_CHECKS = ((256, 200), (100, 512))  # keys planted at P - 1 and P
# One paligemma attention layer at full width over 256 patches and 200 text
# rows: the kernel path (the flash kernel at prefix 256) against the plain
# path (flash_attention_plain on the same card tensors), row by row, and the
# paged decode at VLM_LAYER_DECODE against the forward's rows.  Both paths
# compute one function in f32 from the same bf16 inputs and round once, so
# each row's relative L2 error is bf16 rounding.  Set before the first card
# run: 1e-2, the hybrid layer check's first rule (it read 0-0.095% on the
# card).  A planted fault drops the prefix (the causal mask only) and must
# be rejected on every checked row before P / 2; a CPU rehearsal at full
# width read 98-1242% there (and 4% at row 254, which loses one key of 256;
# the CPU's kernel and plain paths are one function there, 0 apart).
VLM_LAYER_TEXT = 200
VLM_LAYER_ROWS = (0, 1, 17, 100, 127, 200, 254, 255, 256, 300, 455)
VLM_LAYER_DECODE = (256, 300, 455)
VLM_LAYER_TOL = 1e-2
# Decode against a prefill replay of the same tokens, every request:
# relative L2 error of the final hidden state and of the logits.  The
# backbone is gemma-2b's at its depth (its check reads 1.4-1.5% on the card);
# set before the first card run at the MoE and hybrid checks' first rule.
VLM_TOL = {"hidden": 5e-2, "logits": 5e-2}

# seamless-m4t-large-v2 (encoder-decoder: 24 bidirectional encoder layers
# over frame embeddings of 1024, 24 decoder layers each with causal
# self-attention and cross-attention): 4 requests of ENCDEC_FRAMES encoder
# frames and ENCDEC_PROMPT_LENS decoder tokens, 32 greedy tokens each, each
# request alone at batch 1 through prefill, pad_caches and decode_step.
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_FRAMES = (4096, 2500, 1024, 333)
ENCDEC_PROMPT_LENS = (1, 64, 17, 40)
ENCDEC_MAX_LEN = 128  # the self caches: 64 + 32 tokens fit; cross caches stay T_enc
# jax.eval_shape of repro's init_params(seamless-m4t-large-v2), counted.
ENCDEC_PARAMS = 1_370_824_704
# The flash kernel over every key: bidirectional at seamless's encoder
# shape (16 heads on 16 KV heads of 64) at T 4096 and an unaligned 2500,
# and cross-attention from decoder rows S onto T_enc encoder rows (S > T
# at 300 over 200); the paged kernel over the cross cache at G 1, hd 64.
BIDIR_CHECKS = (4096, 2500)
CROSS_CHECKS = tuple((s, t) for t in (4096, 200) for s in (1, 64, 300))
CROSS_SIMT_CHECKS = ((300, 200), (64, 4096))  # f32, on the CUDA cores
CROSS_FAULT = (64, 200)  # where the dropped k >= T mask is planted: T % bk != 0
CROSS_DECODE_LENGTHS = (4096, 2500)
# One encoder layer over ENCDEC_LAYER_FRAMES frames and one decoder layer's
# cross-attention from ENCDEC_LAYER_SEQ rows over as many encoder rows, at full
# width: kernel path against plain path row by row, and cross_decode at
# each of ENCDEC_LAYER_POSITIONS against the kernel forward's row.  Set
# before the first card run as VLM_LAYER_TOL.  Planted faults: a causal
# encoder (rejected on every checked row before T / 2) and a cross decode
# that ropes q at the step's position (every position past 0); a CPU
# rehearsal at full width read 99-3824% and 22-92% there, the correct paths
# at most 0.11% apart (the plain path's blocks of 64 against the planned 128).
ENCDEC_LAYER_FRAMES = 2500
ENCDEC_LAYER_SEQ = 64
ENCDEC_LAYER_ROWS = (0, 1, 100, 777, 1000, 1249, 2000, 2498, 2499)
ENCDEC_LAYER_POSITIONS = (0, 1, 2, 31, 63)
ENCDEC_LAYER_TOL = 1e-2
# Decode against a prefill replay, every request, as VLM_TOL: 24 decoder
# layers over an encoder output both paths share.
ENCDEC_TOL = {"hidden": 5e-2, "logits": 5e-2}

# Phase 5g: gemma-2b with Gemma 2's attention and final logit softcaps
# (arXiv 2408.00118: attn_logit_softcapping 50, final_logit_softcapping 30),
# set on repro's flags, served as phase 4 serves gemma-2b; then gemma-2b's
# decode over its int8 KV cache.
SOFTCAP_ARCH = "gemma-2b"
ATTN_SOFTCAP, LOGIT_SOFTCAP = 50.0, 30.0
# The kernel checks' cap and gain on q: a score of size 1 under a cap of 50
# moves by 1e-4, below bf16's grain, so the checks cap at 5 scores made up
# to 20 and more (q times 8).
CHECK_CAP, CHECK_GAIN = 5.0, 8.0
# The capped rows' library call, timed beside the kernels (flex_softcap).
FLEX_LIBRARY = "flex_attention under torch.compile, score_mod tanh(s / 50) * 50"
# (what, b, h, kv, s, t, hd, hd_v, dtype, route, window, prefix)
SOFTCAP_FLASH_CHECKS = (
    ("gemma-2b prefill", 1, 8, 1, 2048, 2048, 256, 256, "bf16", "tc", 0, 0),
    ("gemma-2b prefill", 1, 8, 1, 2048, 2048, 256, 256, "f32", "simt", 0, 0),
    ("deepseek prefill 192/128", 1, 16, 16, 2048, 2048, 192, 128, "bf16", "tc", 0, 0),
    ("recurrentgemma window 2048", 1, 10, 1, 4096, 4096, 256, 256, "bf16", "tc", 2048, 0),
    ("paligemma prefix 256", 1, 8, 1, 768, 768, 256, 256, "bf16", "tc", 0, 256),
    ("hd 32", 2, 16, 8, 300, 333, 32, 32, "bf16", "simt", 0, 0),
    ("GQA f32", 2, 16, 8, 300, 333, 128, 128, "f32", "simt", 0, 0),
)
# (what, b, kv, g, hd, s, lengths): the paged kernel with a cap (bf16 and
# f32) and its int8 route (bit for bit the bf16 route on the dequantized
# caches, with and without a cap).
SOFTCAP_PAGED_CHECKS = (
    ("gemma-2b decode", 1, 1, 8, 256, 4096, (2077,)),
    ("granite-moe decode", 1, 8, 3, 64, 4096, (2077,)),
    ("recurrentgemma full 2048-slot ring", 1, 1, 10, 256, 2048, (2048,)),
)
INT8_CHECKS = SOFTCAP_PAGED_CHECKS + (("G 1, hd 64", 1, 16, 1, 64, 4096, (4096,)),)
INT8_FAULTS = (
    ("gemma-2b decode", 1, 1, 8, 256, 4096, (2077,), "reads the scale of the next position"),
    ("granite-moe decode", 1, 8, 3, 64, 4096, (2077,), "reads head 0's scale for every head"),
)
# Cut from (64, 512, 1024, 2040) to the longest prompt, so that the run
# keeps its time with phase 8b added.
INT8_PROMPT_LENS = (2040,)
INT8_MAX_LEN = 4096
INT8_STEPS = 32
# The int8 decode's kernel path against its plain path, both on the card,
# three ways.  One attention layer at full width (positions of a 2048-token
# prefix, its rows quantized) and, along the model's own decode, every
# gqa_decode call of the 32 steps after each prompt replayed on the plain
# path with its recorded inputs: the relative L2 error of each call's output
# within INT8_LAYER_TOL, 1e-2, as the layer checks of phases 5c-5f read a
# layer's two paths.  The whole model, 32 steps after each prompt: the
# relative L2 error of each step's logits and final hidden state within
# phase 4's CONSISTENCY_TOL; max|got - want| / max|want| is printed beside
# it.  Gated at 1e-2, the whole model failed twice on the card (0.0236 max
# abs of scale, 0.016 relative L2): 18 random-init bf16 layers grow the
# paths' one-ulp differences to the 1.5% that phase 4's decode against
# prefill reads too.
INT8_LAYER_TOL = 1e-2
INT8_LAYER_SEQ = 2048
INT8_LAYER_POSITIONS = (1, 2, 63, 777, 1500, 2047)
INT8_TOL = CONSISTENCY_TOL

SOURCES = {
    "sort_blocks": "src/repro_torch/kernels/csrc/merge_sort.cu",
    "merge_pass": "src/repro_torch/kernels/csrc/merge_sort.cu",
    "gather_rows": "src/repro_torch/kernels/csrc/gather_rows.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "flash_attention_tc_192x128": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention_latent": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_attention_windowed": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention_ring": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_attention_prefix": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_full": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention_cross": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_attention_softcap": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention_softcap": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_attention_int8": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_attention_bwd_tc": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_simt": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "ssd_scan_bwd": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}
REPLACES = {
    "sort_blocks": "src/repro/kernels/merge_sort/merge_sort.py:97",
    "merge_pass": "src/repro/kernels/merge_sort/merge_sort.py:115",
    "gather_rows": "src/repro/kernels/dispatch/dispatch.py:26",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:72",
    "paged_attention": "src/repro/kernels/paged_attention/paged_attention.py:65",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:50",
    "matmul": "src/repro/kernels/matmul/matmul.py:47",
    "flash_attention_tc_192x128": "src/repro/kernels/flash_attention/flash_attention.py:72",
    "paged_attention_latent": "src/repro/kernels/paged_attention/paged_attention.py:65",
    "flash_attention_windowed": "src/repro/kernels/flash_attention/flash_attention.py:72",
    "paged_attention_ring": "src/repro/kernels/paged_attention/paged_attention.py:65",
    "flash_attention_prefix": "src/repro/kernels/flash_attention/flash_attention.py:72",
    "flash_attention_full": "src/repro/kernels/flash_attention/flash_attention.py:72",
    "paged_attention_cross": "src/repro/kernels/paged_attention/paged_attention.py:65",
    "flash_attention_softcap": "src/repro/kernels/flash_attention/flash_attention.py:72",
    "paged_attention_softcap": "src/repro/kernels/paged_attention/paged_attention.py:65",
    "paged_attention_int8": "src/repro/kernels/paged_attention/paged_attention.py:65",
    # The forward's gradient (both routes): repro takes it by XLA autodiff,
    # no Pallas kernel.
    "flash_attention_bwd_tc": "src/repro/kernels/flash_attention/flash_attention.py:72",
    "flash_attention_bwd_simt": "src/repro/kernels/flash_attention/flash_attention.py:72",
    # The scan's gradient: repro takes it by XLA autodiff of jax.lax.scan.
    "ssd_scan_bwd": "ssd_scan's gradient (repro: XLA autodiff of lax.scan, "
                    "src/repro/models/ssm.py:116)",
}
SESSION_KERNELS = ("sort_blocks", "merge_pass", "gather_rows")
SERVE_KERNELS = ("flash_attention", "paged_attention")
# deepseek-v2-lite's routes of the flash and paged kernels (the kernels line
# lists them beside the two kernels' other rows).
MLA_KERNELS = ("flash_attention_tc_192x128", "paged_attention_latent")
# recurrentgemma's: the flash kernel's windowed launches (counted by the
# wrapper under "flash_attention_windowed") and the paged kernel over its
# 2048-slot rings (the paged launches of phase 5d's serving window).
HYBRID_KERNELS = ("flash_attention_windowed", "paged_attention_ring")
# paligemma's and seamless's: the flash kernel's launches with a prefix
# (paligemma's patches) and over every key (seamless's encoder and
# cross-attention), counted by the wrapper under "flash_attention_prefix"
# and "flash_attention_full", and the paged kernel over the cross caches.

# The blocked matmul at the LLM products of benchmarks/bench_kernel_policy.py
# (lines 25-31), (m, k, n): token block x weight, at published widths.
MATMUL_SHAPES = {
    "gemma-7b ffn up": (4096, 3072, 24576),
    "granite-20b ffn up": (4096, 6144, 24576),
    "deepseek qkv": (8192, 2048, 2048),
    "qwen3 unembed": (4096, 1024, 151936),
    "deepseek expert": (16384, 2048, 1408),
}
MATMUL_POLICIES = ("remop", "conventional")
MATMUL_REPORT = ("gemma-7b ffn up", "remop")  # the kernels line's shape and plan
# Tiles no plan picks, timed at the report shape to tell the plans' causes
# apart: the conventional plan's (bm, bn) with the REMOP plan's K step, the
# REMOP plan under 64-row alignment (planner lane = sublane = 64), and a
# tile shaped for this card (128 rows of A feed each B byte; 4 warpgroups of
# wgmma m64n128).
MATMUL_PROBE_TILES = ((8, 128, 128), (64, 64, 128), (128, 256, 64))
# The JAX tests' shapes (m, k, n) and explicit tiles (tests/test_kernels.py).
JAX_MM_SHAPES = ((64, 64, 64), (128, 256, 64), (200, 130, 70), (33, 257, 129))
JAX_MM_TILES = ((16, 16, 16), (32, 64, 16), (64, 32, 32))
# Timed repetitions of each matmul call, after one warm-up: the plain
# version and the conventional plan take tens of milliseconds a call at
# these products.
MATMUL_REPS = 5
# The f32 kernel's check: the conventional f32 plan, (8, 128, 512), whose K
# step does not fit a CTA at once, at deepseek qkv.
MATMUL_F32_SHAPE = ("deepseek qkv", "conventional")
# Kernel against plain version, set before the first card run.  Both sum the
# same products (exact for bf16 inputs) in f32, in different orders, and
# round once to the output type, so elementwise
#     |got - want| <= MM_ULP * |want| + MM_NOISE * K * 2^-24 * rms(a) * rms(b)
# (one unit of the output type's last place, plus the f32 noise of a sum of
# K terms: sqrt(K) roundings of partial sums of size sqrt(K) rms(a) rms(b),
# with a margin of 16), and the relative L2 error of the whole output must
# be at most MM_REL (one-ulp flips on a small share of the elements).
MM_NOISE = 16.0
MM_ULP = {"torch.bfloat16": 2.0 ** -7, "torch.float32": 2.0 ** -23}
MM_REL = {"torch.bfloat16": 1e-3, "torch.float32": 1e-6}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def load_peaks() -> None:
    """Set the bounds' peaks from the port's H100 spec (needs ``src`` on the path)."""
    from repro_torch.core.cost_model import H100

    global HBM_BYTES_PER_S, BF16_OPS_PER_S
    HBM_BYTES_PER_S, BF16_OPS_PER_S = H100.hbm_bandwidth, H100.peak_flops


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


# Bench.device_ms: the spin launches that open each profiler window, the
# windows taken at most, and the kernels of the primer (torch.cuda._sleep)
# and of the L2 flush (zero_ of a uint8 tensor), known by name.  A run has
# seen the profiler drop 64 spins and a call's records in three windows in
# a row (phase 5c's SDPA timing), so the primer is 256 spins (about a
# millisecond) and a window is taken up to five times.
PRIMER = 256
WINDOWS = 5
SPIN_KERNEL = "spin_kernel"
FLUSH_KERNEL = "FillFunctor<unsigned char>"


class Bench:
    """Median CUDA-event times with the L2 cache flushed before each launch."""

    def __init__(self, torch, device, reps: int = 15, warmup: int = 3):
        self.torch = torch
        self.reps = reps
        self.warmup = warmup
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(self, fn, reps: int = 50) -> dict:
        """Device milliseconds a call: the device events of ``reps`` calls in
        one profiler window, L2 flushed before each, per call; the device
        events a call; how many of the window's first records the profiler
        dropped; and the windows it took.

        The profiler at times drops the first device records of a window (up
        to a few dozen, whole calls with their flushes, mostly in windows late
        in a long process).  So each window opens with ``PRIMER`` launches of
        ``torch.cuda._sleep``'s spin kernel, which take that loss.  The spin
        and flush kernels, known by name, are left out.  A window must hold
        every flush and the same number of events for every call; one that
        does not is taken again, at most ``WINDOWS`` times, then the check
        fails."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        for _ in range(self.warmup):
            fn()
        for taken in range(1, WINDOWS + 1):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(PRIMER):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(reps):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
            primed = sum(e.count for e in events if SPIN_KERNEL in e.key)
            fills = sum(e.count for e in events if FLUSH_KERNEL in e.key)
            ours = [e for e in events if SPIN_KERNEL not in e.key and FLUSH_KERNEL not in e.key]
            count = sum(e.count for e in ours)
            if fills == reps and count > 0 and count % reps == 0:
                break
        check(fills == reps and count > 0 and count % reps == 0,
              f"{WINDOWS} profiler windows of {reps} calls: the last holds {primed} of {PRIMER} "
              f"spins, {fills} flushes and {count} events of the calls "
              f"({ {e.key[:60]: e.count for e in ours} }), not the same number for every call")
        return {"device_ms": sum(e.self_device_time_total for e in ours) / reps / 1e3,
                "device_events_per_call": count // reps, "profiler_dropped": PRIMER - primed,
                "profiler_windows": taken}


def max_abs_err(torch, got, want) -> float:
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"dtype/shape differ: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    return float((got.double() - want.double()).abs().max().item())


def equal_bits(torch, names, got_pair, want_pair, errs):
    """Check kernel outputs equal to the plain version's, bit for bit (float
    keys by their bits, so -0.0 and +0.0 differ); record the largest absolute
    difference under each kernel in ``names``."""
    for got, want in zip(got_pair, want_pair):
        err = max_abs_err(torch, got, want)
        for name in names:
            errs[name] = max(errs.get(name, 0.0), err)
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        check(torch.equal(got, want), f"{names}: kernel differs from its plain version (max abs err {err})")


def ties_decide(torch, what, keys, values, span, plain_values):
    """Check that the tie order is exercised: the plain version's values differ
    somewhere from a stable sort of each ``span`` of ``keys``."""
    order = torch.sort(keys.view(-1, span), dim=1, stable=True).indices
    stable = values.view(-1, span).gather(1, order).reshape(-1)
    check(not torch.equal(stable, plain_values),
          f"{what}: the plain version places every tie as a stable sort does; "
          "the input does not exercise tie order")


def zeros_decide(torch, what, keys, values, plain_keys, plain_values):
    """Check that signed zeros are exercised: in the plain version's output
    some zero key has another sign than the key that entered with its value,
    so a kernel that moves each (key, value) pair whole, taking ``a`` on
    ties, would differ from it.  ``values`` is a permutation of ``0..n-1``."""
    where = torch.empty_like(values)
    where[values.long()] = torch.arange(values.shape[0], device=values.device,
                                        dtype=values.dtype)
    carried = keys[where[plain_values.long()].long()]
    check(not torch.equal(carried.view(torch.int32), plain_keys.view(torch.int32)),
          f"{what}: every key moves with its value; the input does not exercise signed zeros")


# NaN keys by their bits: quiet and signalling, with payloads, of both signs.
NAN_BITS = (0x7FC00000, -0x00400000, 0x7FC00001, -0x003FFFFF, 0x7F800001, -0x007EDCBB)
NAN_CANONICAL = 0x7FC00000  # what torch.minimum/maximum give for any NaN


def with_nans(torch, gen, keys):
    """A copy of float ``keys`` (holding -0.0 and +0.0) with every pattern of
    ``NAN_BITS`` at a few places, -inf and +inf at others, and a NaN right
    beside each of -0.0, +0.0, -inf and +inf."""
    n = keys.shape[0]
    bits = keys.clone().view(torch.int32)
    count = max(2 * len(NAN_BITS), n >> 16)
    # Even n: where ^ 1 is in range (an odd n leaves its last key out).
    where = torch.randperm(n - n % 2, device=keys.device, generator=gen)[:3 * count]
    pattern = torch.tensor(NAN_BITS, dtype=torch.int32, device=keys.device)
    bits[where[:count]] = pattern.repeat(count // len(NAN_BITS) + 1)[:count]
    bits[where[count:2 * count]] = torch.tensor(
        [0x7F800000, -0x00800000], dtype=torch.int32, device=keys.device).repeat(count)[:count]
    for i, special in enumerate((0, -(1 << 31), 0x7F800000, -0x00800000)):
        bits[where[i] ^ 1] = special  # where[i] holds a NaN
    return bits.view(torch.float32)


def nans_decide(torch, what, keys, plain_keys):
    """Check that NaN keys are exercised: the input holds NaNs of both signs
    and several payloads beside signed zeros and infinities, and the plain
    version's output holds more NaNs than its input (a kernel that moves each
    key whole keeps the count) and NaNs other than the canonical one (a
    kernel through min/max that makes NaNs canonical gives only that)."""
    bits, out = keys.view(torch.int32), plain_keys.view(torch.int32)
    nan_in, nan_out = torch.isnan(keys), torch.isnan(plain_keys)
    patterns = torch.unique(bits[nan_in])
    check(bool((patterns < 0).any()) and bool((patterns >= 0).any()) and patterns.numel() >= 4,
          f"{what}: the input's NaNs do not hold both signs and several payloads")
    for special in (0, -(1 << 31), 0x7F800000, -0x00800000):
        check(bool((bits == special).any()), f"{what}: the input has no key of bits {special:#x}")
    check(int(nan_out.sum()) > int(nan_in.sum()),
          f"{what}: no NaN spread; the input does not exercise NaN keys")
    check(bool((out[nan_out] != NAN_CANONICAL).any()),
          f"{what}: every NaN out is canonical; the input does not exercise NaN bits")


def bound(bytes_moved: float, ops: float, ops_per_s: float = ALU_OPS_PER_S):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sort_key_types(torch, device, bench) -> dict:
    """Device ms of ``sort_blocks`` at the kernels line's shape (n = 2^22,
    blocks of 2^14) on int32 keys, on the same keys as float32, and on those
    with a NaN in every block, which takes the NaN rule."""
    from repro_torch.kernels.merge_sort.merge_sort import sort_blocks

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    n, b = 1 << 22, 1 << 14
    keys = torch.randint(0, KEY_DOMAIN, (n,), device=device, generator=gen, dtype=torch.int32)
    vals = torch.arange(n, dtype=torch.int32, device=device)
    nans = keys.float()
    nans[::b] = float("nan")
    return {f"{name}_{k}": v
            for name, key in (("int32", keys), ("float32", keys.float()),
                              ("float32_nan_every_block", nans))
            for k, v in bench.device_ms(lambda key=key: sort_blocks(key, vals, b)).items()}


def phase_kernels(torch, device):
    from repro_torch.kernels.dispatch.dispatch import gather_rows, gather_rows_plain
    from repro_torch.kernels.dispatch.dispatch import attributes as gather_attributes
    from repro_torch.kernels.dispatch.dispatch import plan as gather_plan
    from repro_torch.kernels.merge_sort.merge_sort import (
        merge_pass, merge_pass_plain, sort_blocks, sort_blocks_plain)
    from repro_torch.kernels.merge_sort.merge_sort import attributes as merge_sort_attributes
    from repro_torch.kernels.merge_sort.ops import (
        argsort_by_key, argsort_by_key_plain, remop_sort, remop_sort_plain)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    errs = {}
    rows = {}
    sorts = ["sort_blocks", "merge_pass"]  # remop_sort and argsort_by_key run both

    def tied(n, dtype, hi=1000):
        keys = torch.randint(0, hi, (n,), device=device, generator=gen,
                             dtype=torch.int32).to(dtype)
        if dtype == torch.float32:  # signed zeros beside each other: 5% of the keys
            zero = keys < max(1, hi // 20)
            sign = torch.rand(n, device=device, generator=gen) < 0.5
            keys[zero] = torch.where(sign, -0.0, 0.0)[zero]
            if n >= 1 << 14:
                neg = torch.signbit(keys[zero])
                check(bool(neg.any()) and not bool(neg.all()),
                      f"tied float keys of {n}: the zero keys do not hold both signs")
        return keys

    # -- correctness: ties, every block and merge run, ragged lengths, bit for bit
    # (block 2 and run 1 are one ascending compare-exchange, which keeps ties in
    # order as a stable sort does; every other call must place some tie elsewhere).
    for dtype in (torch.int32, torch.float32):
        n = 1 << 21
        keys = tied(n, dtype)
        vals = torch.randperm(n, device=device, generator=gen).to(torch.int32)
        for e in range(1, 15):
            want = sort_blocks_plain(keys, vals, 1 << e)
            equal_bits(torch, ["sort_blocks"], sort_blocks(keys, vals, 1 << e), want, errs)
            if e > 1:
                ties_decide(torch, f"sort_blocks block 2^{e} {dtype}", keys, vals, 1 << e, want[1])
            if dtype == torch.float32:
                zeros_decide(torch, f"sort_blocks block 2^{e}", keys, vals, *want)
        emit({"phase": "kernels", "check": "sort_blocks", "dtype": str(dtype), "n": n,
              "blocks": "2^1..2^14", "equal": True})
    keys = with_nans(torch, gen, tied(n, torch.float32))
    for e in range(1, 15):
        want = sort_blocks_plain(keys, vals, 1 << e)
        equal_bits(torch, ["sort_blocks"], sort_blocks(keys, vals, 1 << e), want, errs)
        nans_decide(torch, f"sort_blocks block 2^{e}", keys, want[0])
    emit({"phase": "kernels", "check": "sort_blocks", "dtype": "torch.float32 with NaNs",
          "n": n, "blocks": "2^1..2^14", "equal": True})
    for dtype in (torch.int32, torch.float32):
        for n, exps in ((1 << 21, range(0, 21) if dtype == torch.int32 else (1, 13, 14, 20)),
                        (1 << 22, (14, 21))):
            base = tied(n, dtype)
            perm = torch.randperm(n, device=device, generator=gen).to(torch.int32)
            for e in exps:
                # Sorted runs with ties inside and across them (the library sort
                # only prepares inputs here).
                keys = torch.sort(base.view(-1, 1 << e), dim=1).values.reshape(-1)
                want = merge_pass_plain(keys, perm, 1 << e)
                equal_bits(torch, ["merge_pass"], merge_pass(keys, perm, 1 << e), want, errs)
                if e > 0:
                    ties_decide(torch, f"merge_pass run 2^{e} {dtype}", keys, perm, 2 << e, want[1])
                if dtype == torch.float32:
                    zeros_decide(torch, f"merge_pass run 2^{e}", keys, perm, *want)
            emit({"phase": "kernels", "check": "merge_pass", "dtype": str(dtype), "n": n,
                  "runs": [1 << e for e in exps], "equal": True})
    for n, exps in ((1 << 21, (0, 1, 5, 13, 14, 20)), (1 << 22, (21,))):
        base = with_nans(torch, gen, tied(n, torch.float32))
        perm = torch.randperm(n, device=device, generator=gen).to(torch.int32)
        for e in exps:
            # Sorted runs, NaNs last, moved by index so that their bits stay.
            runs = base.view(-1, 1 << e)
            keys = runs.gather(1, torch.sort(runs, dim=1).indices).reshape(-1)
            want = merge_pass_plain(keys, perm, 1 << e)
            equal_bits(torch, ["merge_pass"], merge_pass(keys, perm, 1 << e), want, errs)
            nans_decide(torch, f"merge_pass run 2^{e}", keys, want[0])
        emit({"phase": "kernels", "check": "merge_pass", "dtype": "torch.float32 with NaNs",
              "n": n, "runs": [1 << e for e in exps], "equal": True})
    for n in (3, (1 << 14) + 1, 1 << 21):
        for dtype in (torch.int32, torch.float32):
            keys = tied(n, dtype, hi=max(2, n // 8))
            equal_bits(torch, sorts, remop_sort(keys), remop_sort_plain(keys), errs)
        if n > 1 << 14:
            keys = with_nans(torch, gen, tied(n, torch.float32, hi=n // 8))
            want = remop_sort_plain(keys)
            equal_bits(torch, sorts, remop_sort(keys), want, errs)
            nans_decide(torch, f"remop_sort n={n}", keys, want[0])
        parts = tied(n, torch.int32, hi=64)
        equal_bits(torch, sorts, (argsort_by_key(parts, max_key=63),),
                   (argsort_by_key_plain(parts, max_key=63),), errs)
        emit({"phase": "kernels", "check": "remop_sort+argsort_by_key", "n": n, "equal": True})
    # gather_rows: every route and unit of its plan, ragged tails, misaligned
    # bases, blocks (and a partial last block), the main path's index pattern
    # and a wide bf16 row.
    m = 1 << 20
    x = torch.randint(-(1 << 30), 1 << 30, (m, 2), device=device,
                      generator=gen, dtype=torch.int32)
    perm = torch.randperm(m, device=device, generator=gen).to(torch.int32)
    parts = tied(m, torch.int32, hi=PARTITIONS)
    gather_idx = {"random": perm, "partitions": argsort_by_key(parts, max_key=PARTITIONS - 1),
                  "identity": torch.arange(m, dtype=torch.int32, device=device)}
    narrow = [x, x[:, :1].contiguous(),
              torch.randint(0, 1 << 30, (m // 4 + 3, 4), device=device, generator=gen,
                            dtype=torch.int32)]
    plans = set()

    def hold_gather(src, idx, rpb=1):
        if rpb == 1:  # the plan the wrapper takes; its output is a new, aligned tensor
            plans.add(gather_plan(src.shape[1] * src.element_size(), src.data_ptr(),
                                  idx.data_ptr(), 0))
        equal_bits(torch, ["gather_rows"], (gather_rows(src, idx, rpb),),
                   (gather_rows_plain(src, idx, rpb),), errs)

    for idx in gather_idx.values():
        hold_gather(x, idx)
    for src in narrow:
        hold_gather(src, perm[perm < src.shape[0]][: src.shape[0] - 5])  # a ragged tail
    for rpb in (2, 8):
        hold_gather(x, perm, rpb)
    # m - 3 rows: x's last block of 8 is partial, and no index reaches it.
    hold_gather(x[: m - 3], perm[perm < m - 8], 8)
    hold_gather(x, perm[1:])  # indices 4 bytes off a 16-byte line
    shifted = x.view(-1)[1:2 * m - 1].view(m - 1, 2)  # rows 4 bytes off their alignment
    hold_gather(shifted, perm[perm < m - 1])
    wide = torch.randn(32768, 1536, device=device, generator=gen).to(torch.bfloat16)
    wide_idx = torch.randperm(32768, device=device, generator=gen).to(torch.int32)
    hold_gather(wide, wide_idx)
    for shape, dtype in (((4096, 3), torch.int64), ((1000, 5), torch.int16),
                         ((777, 8), torch.float32), ((513, 7), torch.uint8)):
        src = torch.randint(0, 100, shape, device=device, generator=gen).to(dtype)
        idx = torch.randint(0, shape[0], (shape[0] // 2 * 2,), device=device,
                            generator=gen, dtype=torch.int32)
        hold_gather(src, idx)
    want_plans = {(route, u) for route, units in (("narrow", (4, 8, 16)),
                                                   ("grouped", (1, 2, 4, 8, 16)))
                  for u in units}
    check({p[:2] for p in plans} == want_plans,
          f"gather_rows checks took plans {sorted(plans)}, not every instantiation")
    emit({"phase": "kernels", "check": "gather_rows", "plans": sorted(plans), "equal": True})
    torch.cuda.synchronize()
    emit({"phase": "kernels", "check": "bit-identical to the plain versions",
          "max_abs_err": errs})

    # -- registers and spills of the tile kernel and the gather instantiations ---
    inst = {str(dt)[6:]: merge_sort_attributes(dt) for dt in (torch.int32, torch.float32)}
    emit({"phase": "kernels", "merge_sort_instantiations": inst})
    check(all(a["local_bytes"] == 0 for a in inst.values()), f"a merge-sort kernel spills: {inst}")
    inst = {f"{p.route} unit {p.unit}": gather_attributes(p) for p in sorted(plans)}
    emit({"phase": "kernels", "gather_rows_instantiations": inst})
    check(all(a["local_bytes"] == 0 for a in inst.values()), f"a gather kernel spills: {inst}")

    # -- timing at the main path's widest shapes -------------------------------
    bench = Bench(torch, device)

    def timed(kernel, plain, library, **row):
        """CUDA-event ms of kernel, plain version and library call, and the
        device ms of kernel and library call from a profiler window."""
        return dict(row, ms=bench.ms(kernel), **bench.device_ms(kernel),
                    plain_ms=bench.ms(plain), library_ms=bench.ms(library),
                    **{f"library_{k}": v for k, v in bench.device_ms(library).items()})

    n = 1 << 22  # EMS run formation over 128 key pages: 4,194,304 keys
    keys = tied(n, torch.int32, hi=KEY_DOMAIN)
    vals = torch.arange(n, dtype=torch.int32, device=device)
    b = 1 << 14
    stages = 14 * 15 // 2
    ms_bound, by = bound(16 * n, n / 2 * stages)
    rows["sort_blocks"] = timed(
        lambda: sort_blocks(keys, vals, b), lambda: sort_blocks_plain(keys, vals, b),
        lambda: torch.sort(keys.view(-1, b), dim=1, stable=True),
        shape=f"n={n}, block={b}, int32 keys + int32 values", bound_ms=ms_bound, bound_by=by)

    runs_sorted, _ = sort_blocks(keys, vals, b)
    merge_runs = [1 << e for e in range(14, 22)]

    def ladder(fn):
        k, v = runs_sorted, vals
        for run in merge_runs:
            k, v = fn(k, v, run)
        return k, v

    merge_stages = sum(e + 1 for e in range(14, 22))
    ms_bound, by = bound(16 * n * len(merge_runs), n / 2 * merge_stages)
    rows["merge_pass"] = timed(
        lambda: ladder(merge_pass), lambda: ladder(merge_pass_plain),
        lambda: torch.sort(runs_sorted, stable=True),
        shape=f"n={n}, runs 2^14..2^21 (8 passes), int32 keys + int32 values",
        bound_ms=ms_bound, bound_by=by)
    emit({"phase": "kernels", "timing": "sort_blocks by key type",
          "shape": rows["sort_blocks"]["shape"], **sort_key_types(torch, device, bench)})

    # gather_rows, row 1 (the kernels line): a partition block of 2^20 (key,
    # payload) rows narrowed to int32, a random permutation.  Rows 2-4: the
    # main path's own indices (the stable argsort of 64 partition ids), the
    # identity beside a copy of the same bytes (x.clone()), and a wide bf16
    # row off the main path (granite-moe-3b's d_model, 4096 tokens x top-8).
    gather_cases = (("gather_rows", x, perm),
                    ("gather_rows partitions", x, gather_idx["partitions"]),
                    ("gather_rows identity", x, gather_idx["identity"]),
                    ("gather_rows wide", wide, wide_idx))
    for name, src, idx in gather_cases:
        n_rows, d = idx.shape[0], src.shape[1]
        ms_bound, by = bound(2 * n_rows * d * src.element_size() + 4 * n_rows, 0)
        row = timed(lambda src=src, idx=idx: gather_rows(src, idx),
                    lambda src=src, idx=idx: gather_rows_plain(src, idx),
                    lambda src=src, idx=idx: torch.index_select(src, 0, idx),
                    shape=f"x=[{src.shape[0]}, {d}] {str(src.dtype)[6:]}, idx=[{n_rows}] int32, "
                          f"rows_per_block=1", bound_ms=ms_bound, bound_by=by)
        if name == "gather_rows identity":
            row.update(copy_ms=bench.ms(src.clone),
                       **{f"copy_{k}": v for k, v in bench.device_ms(src.clone).items()})
        rows[name] = row
    # What a gather takes with x already in L2 (read by a copy just before),
    # less the copy's own time: random and identity indices.
    warm = {}
    for turn in range(2):
        warm.setdefault("copy", []).append(bench.device_ms(x.clone)["device_ms"])
        for name, idx in (("random", perm), ("identity", gather_idx["identity"])):
            both = bench.device_ms(lambda idx=idx: (x.clone(), gather_rows(x, idx)))["device_ms"]
            warm.setdefault(name, []).append(both - warm["copy"][-1])
    emit({"phase": "kernels", "timing": "gather_rows with x in L2", "device_ms": warm})
    for name, row in rows.items():
        emit({"phase": "kernels", "timing": name, **row})
    for name, _, _ in gather_cases[1:]:
        del rows[name]

    # The composite ops on the main path, with the library sort beside them.
    keys = tied(n, torch.int32, hi=KEY_DOMAIN)
    parts = tied(m, torch.int32, hi=PARTITIONS)
    emit({"phase": "kernels", "timing": "remop_sort", "n": n,
          "ms": bench.ms(lambda: remop_sort(keys)),
          **bench.device_ms(lambda: remop_sort(keys)),
          "plain_ms": bench.ms(lambda: remop_sort_plain(keys)),
          "library_ms": bench.ms(lambda: torch.sort(keys, stable=True))})
    emit({"phase": "kernels", "timing": "argsort_by_key", "n": m,
          "ms": bench.ms(lambda: argsort_by_key(parts, max_key=PARTITIONS - 1)),
          **bench.device_ms(lambda: argsort_by_key(parts, max_key=PARTITIONS - 1)),
          "plain_ms": bench.ms(lambda: argsort_by_key_plain(parts, max_key=PARTITIONS - 1)),
          "library_ms": bench.ms(lambda: torch.argsort(parts, stable=True)),
          **{f"library_{k}": v for k, v in bench.device_ms(
              lambda: torch.argsort(parts, stable=True)).items()}})
    del bench
    return errs, rows


# An attention kernel against its plain version: |got - want| <= atol +
# rtol * |want| elementwise, and a relative L2 error <= rel.  f32 keeps the
# JAX tests' 2e-5 (tests/test_kernels.py).  In bf16 both compute in f32 and
# round once, so they differ by at most one bf16 ulp of the output (<= 2^-7
# |want|) plus f32 summation noise.  The JAX tests' bf16 3e-2, set at
# T <= 256, is as large as the outputs themselves at serving lengths
# (|o| ~ 0.03 over 2048 keys) and passes a kernel that drops a page.
ATTN_TOL = {"torch.float32": dict(atol=2e-5, rtol=2e-5, rel=None),
            "torch.bfloat16": dict(atol=1e-4, rtol=2.0 ** -7, rel=5e-3)}
JAX_BF16_TOL = 3e-2


def attn_close(torch, got, want):
    """(within ``ATTN_TOL``, max abs error, relative L2 error, within the JAX
    tests' bf16 rule ``|got - want| <= 3e-2 + 3e-2 |want|``)."""
    tol = ATTN_TOL[str(want.dtype)]
    err, rel = max_abs_err(torch, got, want), rel_err(torch, got, want)
    d, w = (got.double() - want.double()).abs(), want.double().abs()
    ok = bool((d <= tol["atol"] + tol["rtol"] * w).all())
    ok = ok and (tol["rel"] is None or rel <= tol["rel"])
    return ok, err, rel, bool((d <= JAX_BF16_TOL * (1 + w)).all())


def allclose(torch, names, got, want, errs):
    """Check ``got`` against ``want`` under ``ATTN_TOL``; record the largest
    absolute difference under each kernel in ``names``; return (max abs
    error, relative L2 error)."""
    ok, err, rel, _ = attn_close(torch, got, want)
    for name in names:
        errs[name] = max(errs.get(name, 0.0), err)
    check(ok, f"{names}: kernel differs from its plain version beyond "
              f"{ATTN_TOL[str(want.dtype)]} (max abs err {err}, relative L2 {rel})")
    return err, rel


def reject_fault(torch, name, what, got, want):
    """Check that ``ATTN_TOL`` rejects ``got``, a planted fault of ``name``."""
    ok, err, rel, jax_ok = attn_close(torch, got, want)
    emit({"phase": "kernels", "planted_fault": name, "fault": what, "max_abs_err": err,
          "rel_err": rel, "rejected": not ok, "jax_rule_passes": jax_ok})
    check(not ok, f"{name}: the tolerance passes a kernel that {what}")


def flash_cost(b, h, kv, s, t, hd, elem, hd_v=None, window=0, prefix=0):
    """(bytes, flops) of causal flash attention (with ``window``, local;
    with ``prefix``, every key below it seen too): q, k, v read once, o
    written once; 2 (hd + hd_v) flops (q.k and p.v) per unmasked (query,
    key) pair."""
    hd_v = hd if hd_v is None else hd_v
    offset = t - s
    pairs = sum(min(t, max(i + offset + 1, prefix), window or t) for i in range(s))
    return ((b * h * s + b * kv * t) * (hd + hd_v) * elem,
            2 * (hd + hd_v) * pairs * b * h)


def phase_attention(torch, device):
    """The flash and paged kernels against their plain versions, then timed."""
    import torch.nn.functional as F
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import plan_blocks, remop_flash_attention
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention, paged_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    errs, rows = {}, {}

    def randn(*shape, dtype):
        return torch.randn(*shape, device=device, generator=gen).to(dtype)

    def flash_on(path, q, k, v, **kw):
        """The flash kernel on q, k, v; checks that the call took ``path``."""
        before = runtime.launches[f"flash_attention_{path}"]
        out = fa.flash_attention(q, k, v, **kw) if kw else remop_flash_attention(q, k, v)
        check(fa.route(q, k, v) == path
              and runtime.launches[f"flash_attention_{path}"] == before + 1,
              f"flash {tuple(q.shape)} {q.dtype} did not take the {path} route")
        return out

    # -- correctness: the main path's shapes, ragged lengths, both dtypes, both
    # routes: bf16 at hd 64 / 128 / 256 on the tensor cores ("tc"), f32 and
    # bf16 hd 32 on the CUDA cores ("simt") -------------------------------------
    for b, h, kv, s, t, hd, dtype, path in (
            (1, 8, 1, 2048, 2048, 256, torch.bfloat16, "tc"),  # gemma-2b prefill
            (1, 8, 1, 777, 777, 256, torch.bfloat16, "tc"),
            (1, 16, 8, 2048, 2048, 128, torch.bfloat16, "tc"),  # qwen3-0.6b widths
            (2, 4, 2, 300, 333, 64, torch.bfloat16, "tc"),      # hd 64, ragged suffix
            (1, 48, 1, 1000, 1000, 128, torch.bfloat16, "tc"),  # granite-20b, G = 48
            (1, 24, 8, 2048, 2048, 64, torch.bfloat16, "tc"),   # granite-moe-3b, G = 3
            (1, 24, 8, 777, 777, 64, torch.bfloat16, "tc"),
            (2, 16, 8, 300, 333, 32, torch.bfloat16, "simt"),
            (2, 16, 8, 512, 512, 128, torch.float32, "simt"),   # GQA, qwen3-0.6b widths
            (2, 16, 8, 300, 333, 128, torch.float32, "simt")):  # ragged suffix prefill
        q = randn(b, h, s, hd, dtype=dtype)
        k, v = randn(b, kv, t, hd, dtype=dtype), randn(b, kv, t, hd, dtype=dtype)
        want = flash_attention_plain(q, k, v)
        err, rel = allclose(torch, ["flash_attention"], flash_on(path, q, k, v), want, errs)
        # The model's layout: [B, S, heads, hd] memory seen as [B, heads, S, hd].
        qm, km, vm = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
        got = flash_on(path, qm, km, vm)
        check(got.stride() == qm.stride(), "flash output lost q's layout")
        err2, rel2 = allclose(torch, ["flash_attention"], got, want, errs)
        emit({"phase": "kernels", "check": "flash_attention", "shape": [b, h, kv, s, t, hd],
              "dtype": str(dtype), "route": path, "blocks": plan_blocks(s, t, hd, q.element_size(),
                                                                        path=path),
              "tol": ATTN_TOL[str(dtype)], "max_abs_err": max(err, err2),
              "rel_err": max(rel, rel2)})
    # Registers and local (spilled) bytes of every tensor-core instantiation.
    emit({"phase": "kernels", "flash_attention_tc_instantiations": {
        f"hd {hd} bq {bq} bk {bk}": fa.occupancy(hd, bq, bk)
        for hd in fa.TC_HEAD_DIMS for bq in fa.TC_BLOCKS for bk in fa.TC_BLOCKS
        if fa.smem_bytes(bq, bk, hd, 2, "tc") <= fa.SMEM_LIMIT}})
    for b, kv, g, hd, s, lengths, dtype in (
            (1, 1, 8, 256, 4096, (2077,), torch.bfloat16),  # gemma-2b decode
            (1, 1, 8, 256, 4096, (1,), torch.bfloat16),
            (1, 1, 8, 256, 4096, (4096,), torch.bfloat16),
            # Lengths that end mid-chunk: 132 splits of 32, 16 and 16 positions.
            (1, 1, 8, 256, 4096, (4095,), torch.bfloat16),
            (1, 1, 8, 256, 4096, (33,), torch.bfloat16),
            (1, 1, 8, 256, 4096, (2049,), torch.bfloat16),
            (1, 1, 48, 128, 4096, (2077,), torch.bfloat16),  # granite-20b decode
            (1, 1, 48, 128, 4096, (4096,), torch.bfloat16),
            (1, 8, 3, 64, 4096, (2077,), torch.bfloat16),  # granite-moe-3b decode
            (1, 8, 3, 64, 4096, (777,), torch.bfloat16),
            (4, 8, 2, 128, 4096, (1, 1000, 2049, 4096), torch.float32)):
        q = randn(b, kv, g, hd, dtype=dtype)
        kc, vc = randn(b, s, kv, hd, dtype=dtype), randn(b, s, kv, hd, dtype=dtype)
        ln = torch.tensor(lengths, dtype=torch.int32, device=device)
        err, rel = allclose(torch, ["paged_attention"], paged_attention(q, kc, vc, ln),
                            paged_attention_plain(q, kc, vc, ln), errs)
        emit({"phase": "kernels", "check": "paged_attention", "shape": [b, kv, g, hd, s],
              "lengths": list(lengths), "dtype": str(dtype), "plan": pa.plan(b, kv, g, s),
              "tol": ATTN_TOL[str(dtype)], "max_abs_err": err, "rel_err": rel})
    # Registers, local (spilled) bytes, shared memory and resident CTAs of
    # every split-kernel instantiation at 8, 48 and 64 heads a CTA.
    emit({"phase": "kernels", "paged_attention_instantiations": {
        f"{str(dtype)[6:]} hd {hd} gc {gc}": pa.attributes(dtype, hd, gc)
        for dtype in (torch.bfloat16, torch.float32) for hd in pa.HEAD_DIMS
        for gc in (8, 48, 64)}})

    # -- planted faults, made with the kernels, that the rule must reject ------
    # A paged kernel that skips the ragged last page of 2077 positions is the
    # kernel at length 2048 (bytes identical to a kernel that stops a page
    # early).  A flash kernel that skips KV block [a, a + 64) is, for the rows
    # after it, the kernel on the keys without that block: the offset T - S
    # keeps every row's causal limit on the same key.
    q = randn(1, 1, 8, 256, dtype=torch.bfloat16)
    kc, vc = (randn(1, 4096, 1, 256, dtype=torch.bfloat16) for _ in range(2))
    ln = torch.tensor([2077], dtype=torch.int32, device=device)
    reject_fault(torch, "paged_attention", "skips the ragged last page of 2077 positions",
                 paged_attention(q, kc, vc, ln - 29), paged_attention_plain(q, kc, vc, ln))
    # A split kernel that loses one chunk's partial is the kernel on the cache
    # with that chunk's positions cut out.
    c = pa.chunk_len(2077, pa.plan(1, 1, 8, 4096)[0])
    a = 1024 // c * c
    k_cut, v_cut = (torch.cat([x[:, :a], x[:, a + c:]], dim=1) for x in (kc, vc))
    reject_fault(torch, "paged_attention",
                 f"drops the chunk {a}..{a + c - 1} of 2077 positions",
                 paged_attention(q, k_cut, v_cut, ln - c), paged_attention_plain(q, kc, vc, ln))
    a, s = 1024, 2048
    q = randn(1, 8, s, 256, dtype=torch.bfloat16)
    k, v = (randn(1, 1, s, 256, dtype=torch.bfloat16) for _ in range(2))
    k_cut, v_cut = (torch.cat([x[:, :, :a], x[:, :, a + 64:]], dim=2) for x in (k, v))
    reject_fault(torch, "flash_attention",
                 f"skips KV block {a}..{a + 63} of {s} positions (route "
                 f"{fa.route(q[:, :, a + 64:], k_cut, v_cut)})",
                 flash_on("tc", q[:, :, a + 64:], k_cut, v_cut),
                 flash_attention_plain(q, k, v)[:, :, a + 64:])
    torch.cuda.synchronize()

    # -- timing at the main path's widest shapes -------------------------------
    bench = Bench(torch, device)
    b, h, kv, s, hd = 1, 8, 1, 2048, 256
    q = randn(b, h, s, hd, dtype=torch.bfloat16)
    k, v = randn(b, kv, s, hd, dtype=torch.bfloat16), randn(b, kv, s, hd, dtype=torch.bfloat16)
    nbytes, flops = flash_cost(b, h, kv, s, s, hd, 2)
    ms_bound, by = bound(nbytes, flops, BF16_OPS_PER_S)
    # ms: the kernel's wrapper at the planned blocks; remop_flash_attention_ms
    # adds the route and the plan on the host, as the model calls it.
    bq, bk = plan_blocks(s, s, hd)

    def flash_kernel():
        return fa.flash_attention(q, k, v, bq=bq, bk=bk)

    def flash_sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    rows["flash_attention"] = dict(
        shape=f"q [{b},{h},{s},{hd}], k/v [{b},{kv},{s},{hd}] bf16, causal, blocks {(bq, bk)}",
        ms=bench.ms(flash_kernel),
        remop_flash_attention_ms=bench.ms(lambda: remop_flash_attention(q, k, v)),
        plain_ms=bench.ms(lambda: flash_attention_plain(q, k, v)),
        library_ms=bench.ms(flash_sdpa),
        bound_ms=ms_bound, bound_by=by,
        **bench.device_ms(flash_kernel),
        **{f"library_{k}": v for k, v in bench.device_ms(flash_sdpa).items()})
    # What keeping P at f32 precision (P_hi + P_lo, two PV products) costs:
    # the same call with P rounded once to bf16, a probe off the main path.
    single = fa.flash_attention(q, k, v, bq=bq, bk=bk, split_p=False)
    ok, err, rel, _ = attn_close(torch, single, flash_attention_plain(q, k, v))
    emit({"phase": "kernels", "timing": "flash_attention single-bf16-P probe",
          "shape": rows["flash_attention"]["shape"],
          "ms": bench.ms(lambda: fa.flash_attention(q, k, v, bq=bq, bk=bk, split_p=False)),
          "split_ms": bench.ms(lambda: fa.flash_attention(q, k, v, bq=bq, bk=bk)),
          "max_abs_err": err, "rel_err": rel, "within_attn_tol": ok})
    # qwen3-0.6b's widths: 16 query heads on 8 KV heads of 128.
    b, h, kv, s, hd = 1, 16, 8, 2048, 128
    q = randn(b, h, s, hd, dtype=torch.bfloat16)
    k, v = randn(b, kv, s, hd, dtype=torch.bfloat16), randn(b, kv, s, hd, dtype=torch.bfloat16)
    ms_bound, by = bound(*flash_cost(b, h, kv, s, s, hd, 2), BF16_OPS_PER_S)
    bq, bk = plan_blocks(s, s, hd)
    emit({"phase": "kernels", "timing": "flash_attention qwen3-0.6b",
          "shape": f"q [{b},{h},{s},{hd}], k/v [{b},{kv},{s},{hd}] bf16, causal, "
                   f"blocks {(bq, bk)}",
          "ms": bench.ms(lambda: fa.flash_attention(q, k, v, bq=bq, bk=bk)),
          "remop_flash_attention_ms": bench.ms(lambda: remop_flash_attention(q, k, v)),
          "plain_ms": bench.ms(lambda: flash_attention_plain(q, k, v)),
          "library_ms": bench.ms(lambda: F.scaled_dot_product_attention(
              q, k, v, is_causal=True, enable_gqa=True)),
          "bound_ms": ms_bound, "bound_by": by})

    # granite-moe-3b-a800m's widths: 24 query heads on 8 KV heads of 64.
    b, h, kv, s, hd = 1, 24, 8, 2048, 64
    q = randn(b, h, s, hd, dtype=torch.bfloat16)
    k, v = randn(b, kv, s, hd, dtype=torch.bfloat16), randn(b, kv, s, hd, dtype=torch.bfloat16)
    ms_bound, by = bound(*flash_cost(b, h, kv, s, s, hd, 2), BF16_OPS_PER_S)
    bq, bk = plan_blocks(s, s, hd)
    emit({"phase": "kernels", "timing": "flash_attention granite-moe-3b",
          "shape": f"q [{b},{h},{s},{hd}], k/v [{b},{kv},{s},{hd}] bf16, causal, "
                   f"blocks {(bq, bk)}",
          "ms": bench.ms(lambda: fa.flash_attention(q, k, v, bq=bq, bk=bk)),
          **bench.device_ms(lambda: fa.flash_attention(q, k, v, bq=bq, bk=bk)),
          "plain_ms": bench.ms(lambda: flash_attention_plain(q, k, v)),
          "library_ms": bench.ms(lambda: F.scaled_dot_product_attention(
              q, k, v, is_causal=True, enable_gqa=True)),
          **{f"library_{key}": val for key, val in bench.device_ms(
              lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True, enable_gqa=True)).items()},
          "bound_ms": ms_bound, "bound_by": by})

    # Decode at gemma-2b's (8 query heads on one KV head of 256, the kernels
    # line's row), granite-20b's (48 on one of 128) and granite-moe-3b's (3
    # on each of 8 of 64) widths.  ms: CUDA events
    # around one call, which at this size mostly read the wrapper's host time;
    # device_ms: the device events of a profiler window of calls.
    b, s, length = 1, 4096, 2048
    ln = torch.full((b,), length, dtype=torch.int32, device=device)
    mask = (torch.arange(s, device=device) < length)[None, None, None, :]
    paged_rows = {}
    for name, kv, g, hd in (("paged_attention", 1, 8, 256),
                            ("paged_attention granite-20b", 1, 48, 128),
                            ("paged_attention granite-moe-3b", 8, 3, 64)):
        q = randn(b, kv, g, hd, dtype=torch.bfloat16)
        kc, vc = (randn(b, s, kv, hd, dtype=torch.bfloat16) for _ in range(2))
        ms_bound, by = bound((2 * length * kv * hd + 2 * kv * g * hd) * 2 * b,
                             4 * hd * length * kv * g * b, BF16_OPS_PER_S)

        def kernel(q=q, kc=kc, vc=vc):
            return paged_attention(q, kc, vc, ln)

        def sdpa(q=q, kc=kc, vc=vc, kv=kv, g=g, hd=hd):
            return F.scaled_dot_product_attention(
                q.reshape(b, kv * g, 1, hd), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        paged_rows[name] = dict(
            shape=f"q [{b},{kv},{g},{hd}], caches [{b},{s},{kv},{hd}] bf16, length {length}, "
                  f"plan {pa.plan(b, kv, g, s)}",
            ms=bench.ms(kernel),
            plain_ms=bench.ms(lambda q=q, kc=kc, vc=vc: paged_attention_plain(q, kc, vc, ln)),
            library_ms=bench.ms(sdpa),
            bound_ms=ms_bound, bound_by=by,
            **bench.device_ms(kernel),
            **{f"library_{k}": v for k, v in bench.device_ms(sdpa).items()})
    rows["paged_attention"] = paged_rows["paged_attention"]
    for name, row in {**rows, **paged_rows}.items():
        emit({"phase": "kernels", "timing": name, **row})
    del bench
    return errs, rows


# --------------------------------------------------------------------------
# Phase 3: the Session at a TPC-H SF1-shaped size
# --------------------------------------------------------------------------


def sf1_queries(remote):
    """Seed the SF1-shaped data on ``remote``; one task per query."""
    from repro_torch.remote.simulator import make_key_pages, make_relation

    keys = make_key_pages(remote, EMS_PAGES, KEY_PAGE_ROWS, key_domain=KEY_DOMAIN, seed=1)
    orders = make_relation(remote, ORDERS_ROWS, ROW_PAGE_ROWS, KEY_DOMAIN, seed=2)
    lineitem = make_relation(remote, LINEITEM_ROWS, ROW_PAGE_ROWS, KEY_DOMAIN, seed=3)
    o_pages, l_pages = len(orders.page_ids), len(lineitem.page_ids)
    return [
        ("ems", dict(size_r=EMS_PAGES), {"page_ids": keys}, {"rows_per_page": KEY_PAGE_ROWS}),
        ("ehj", dict(size_r=o_pages, size_s=l_pages, out=o_pages, partitions=PARTITIONS,
                     sigma=0.5), {"build": orders, "probe": lineitem}, {}),
        ("eagg", dict(size_r=l_pages, out=0.63 * l_pages, partitions=PARTITIONS, sigma=0.5),
         {"rel": lineitem}, {}),
    ]


def run_queries(remote, on_query=None):
    """One Session per query over ``remote``, each with the full budget.

    A query is one ``Session(remote, budget).run([task])``, so each reports
    its own wall clock and ledger; ``on_query`` snapshots the backend's wall
    clock before and after each.
    """
    from repro_torch.engine import Session, WorkloadStats

    out = []
    for op, stats, inputs, opts in sf1_queries(remote):
        sess = Session(remote, budget=BUDGET_PAGES)
        task = sess.task(op, WorkloadStats(**stats), inputs=inputs, **opts)
        before = on_query() if on_query else None
        t0 = time.perf_counter()
        res = sess.run([task])
        host_s = time.perf_counter() - t0
        after = on_query() if on_query else None
        out.append((op, inputs, res, host_s, before, after))
    return out


def wall_state(backend):
    w = backend.wall
    return dict(transfer_seconds=w.transfer_seconds, kernel_seconds=w.kernel_seconds,
                kernel_calls=w.kernel_calls)


def output_ids(op, result):
    from repro_torch.engine import registry

    return registry.get(op).output_of(result)


def check_oracle(remote, op, inputs, result):
    from repro_torch.engine import registry
    import numpy as np

    oracle = registry.get(op).oracle(remote, *inputs.values())
    if op == "ems":
        got = np.concatenate([p.ravel() for p in remote.peek_batch(result.run_page_ids)])
        check(np.array_equal(got, oracle), "EMS output is not the sorted keys")
        check(result.passes >= 1, "EMS formed a single run: nothing spilled")
    elif op == "ehj":
        check(result.output_rows == oracle, f"EHJ rows {result.output_rows} != oracle {oracle}")
        check(result.per_phase_rounds["P3"] > 0, "EHJ spilled no partition")
    else:
        got = np.concatenate(remote.peek_batch(result.output_page_ids), axis=0)
        got = got[np.argsort(got[:, 0], kind="stable")]
        check(np.array_equal(got, oracle), "EAGG groups differ from the oracle")
        check(result.per_phase_rounds["P2"] > 0, "EAGG spilled no partition")


def phase_session(torch, device):
    import numpy as np
    from repro_torch.kernels import runtime
    from repro_torch.remote import make_backend, make_hierarchy

    backend = make_backend(*LEVELS, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    queries = run_queries(backend, on_query=lambda: wall_state(backend))
    torch.cuda.synchronize()
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    simulator = make_hierarchy(*LEVELS)
    sim_queries = run_queries(simulator)
    check(backend.wall.kernel_fallbacks == 0, "a kernel hook fell back to numpy")
    check(backend.wall.host_pinned_pages == 0, "a page was pinned to the host")
    for name in SESSION_KERNELS:
        check(launches.get(name, 0) > 0, f"the main path never launched {name}")

    for (op, inputs, res, host_s, before, after), (_, _, sim, _, _, _) in zip(queries, sim_queries):
        check(dataclasses.asdict(res.total) == dataclasses.asdict(sim.total),
              f"{op}: backend ledger differs from the simulator's")
        (tr,), (str_,) = res.per_task, sim.per_task
        pages = backend.peek_batch(output_ids(op, tr.result))
        sim_pages = simulator.peek_batch(output_ids(op, str_.result))
        check(len(pages) == len(sim_pages) and all(
            a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
            for a, b in zip(pages, sim_pages)), f"{op}: output pages differ from the simulator's")
        check_oracle(backend, op, inputs, tr.result)
        calls = after["kernel_calls"] - before["kernel_calls"]
        check(calls > 0, f"{op}: its kernel hook never ran")
        emit({"phase": "session", "query": op, "m_pages": tr.m_pages,
              "placement": tr.placement, "output_pages": len(pages),
              "wall_seconds": res.wall_seconds,
              "transfer_seconds": after["transfer_seconds"] - before["transfer_seconds"],
              "kernel_seconds": after["kernel_seconds"] - before["kernel_seconds"],
              "kernel_calls": calls,
              "host_seconds": host_s,
              "simulated_seconds": res.latency_seconds(),
              "d_total": res.total.d_total, "c_total": res.total.c_total,
              "ledger_equal": True, "outputs_equal": True, "oracle_equal": True})
    emit({"phase": "session", "launches": launches,
          "kernel_calls": backend.wall.kernel_calls,
          "kernel_fallbacks": backend.wall.kernel_fallbacks,
          "host_pinned_pages": backend.wall.host_pinned_pages,
          "wall": backend.wall.to_dict(),
          "peak_device_bytes": peak})
    return launches


# --------------------------------------------------------------------------
# Phase 3b: TPC-H SF1 query DAGs through the logical-plan frontend
# --------------------------------------------------------------------------


def join_rows(rows_l: float, rows_r: float) -> float:
    """Rows of an equi-join on keys drawn uniformly from KEY_DOMAIN."""
    return rows_l * rows_r / KEY_DOMAIN


def groups(rows: float) -> float:
    """Distinct keys among ``rows`` uniform draws from KEY_DOMAIN: the groups
    of an aggregate by key (0.632 of lineitem's rows, 1 - 1/e)."""
    return KEY_DOMAIN * (1.0 - math.exp(-rows / KEY_DOMAIN))


def tpch_plan(remote, query: str):
    """Seed SF1's lineitem, orders and customer on ``remote`` and build the
    Q3 or Q18 skeleton of ``benchmarks/bench_tpch.py`` (lines 67-79 and
    101-114) over them, every ``out_pages`` estimated from the row counts and
    the key domain (``join_rows``, ``groups``), in ROW_PAGE_ROWS-row pages."""
    from repro_torch.engine.plan import LogicalPlan
    from repro_torch.remote.simulator import make_relation

    lineitem = make_relation(remote, LINEITEM_ROWS, ROW_PAGE_ROWS, KEY_DOMAIN, seed=3)
    orders = make_relation(remote, ORDERS_ROWS, ROW_PAGE_ROWS, KEY_DOMAIN, seed=2)
    customer = make_relation(remote, CUSTOMER_ROWS, ROW_PAGE_ROWS, KEY_DOMAIN, seed=4)
    lp = LogicalPlan(query)
    l_n = lp.scan("lineitem", lineitem, rows_per_page=ROW_PAGE_ROWS)
    o_n = lp.scan("orders", orders, rows_per_page=ROW_PAGE_ROWS)
    c_n = lp.scan("customer", customer, rows_per_page=ROW_PAGE_ROWS)
    opts = dict(sigma=0.5, partitions=PARTITIONS)
    if query == "q3":
        # lineitem |><| orders |><| sigma(customer) -> group-by -> order-by.
        lo = join_rows(LINEITEM_ROWS, ORDERS_ROWS)  # 1,500,304 rows
        loc = join_rows(lo, CUSTOMER_ROWS * CUSTOMER_FILTER)  # 7,502 rows
        j = lp.join(lp.join(l_n, o_n, out_pages=lo / ROW_PAGE_ROWS),
                    lp.filter(c_n, CUSTOMER_FILTER), out_pages=loc / ROW_PAGE_ROWS, **opts)
        lp.sort(lp.aggregate(j, out_pages=groups(loc) / ROW_PAGE_ROWS, **opts), k_cap=8)
    else:
        # (customer |><| orders) |><| agg(lineitem) -> order-by.
        agg_rows = groups(LINEITEM_ROWS)  # 3,793,458 groups
        co = join_rows(CUSTOMER_ROWS, ORDERS_ROWS)  # 37,500 rows
        big = lp.aggregate(l_n, out_pages=agg_rows / ROW_PAGE_ROWS, **opts)
        j = lp.join(lp.join(c_n, o_n, out_pages=co / ROW_PAGE_ROWS), big,
                    out_pages=join_rows(co, agg_rows) / ROW_PAGE_ROWS, **opts)
        lp.sort(j, k_cap=8)
    return lp


def run_dag(remote, query: str):
    """Compile ``query`` on a Session over ``remote`` and run it with
    measured re-planning; returns (compiled plan, result, host seconds)."""
    from repro_torch.engine import Session
    from repro_torch.engine.plan import compile_plan

    sess = Session(remote, budget=BUDGET_PAGES)
    cp = compile_plan(sess, tpch_plan(remote, query))
    t0 = time.perf_counter()
    res = cp.run(sess, replan="measured")
    return cp, res, time.perf_counter() - t0


def dag_shape(cp):
    """The compiled DAG as data: per task its operator, label, stats and the
    tasks it reads; and each join cluster's costed choice."""
    index = {id(t): i for i, t in enumerate(cp.tasks)}
    tasks = [(t.op, t.label, dataclasses.asdict(t.stats),
              sorted(index[id(v.task)] for v in t.inputs.values() if hasattr(v, "task")))
             for t in cp.tasks]
    return tasks, [dataclasses.asdict(c) for c in cp.join_choices]


def phase_dag(torch, device):
    """Q3 and Q18 at SF1 on the card's backend against the simulator."""
    import numpy as np
    from repro_torch.kernels import runtime
    from repro_torch.remote import make_backend, make_hierarchy

    launches = {}
    for query in TPCH_QUERIES:
        backend = make_backend(*LEVELS, device=device)
        torch.cuda.synchronize()
        runtime.reset_launches()
        cp, res, host_s = run_dag(backend, query)
        torch.cuda.synchronize()
        ran = dict(runtime.launches)
        simulator = make_hierarchy(*LEVELS)
        sim_cp, sim, _ = run_dag(simulator, query)

        check(dag_shape(cp) == dag_shape(sim_cp), f"{query}: compiled DAG or join choice "
                                                  "differs from the simulator's")
        check(dataclasses.asdict(res.total) == dataclasses.asdict(sim.total),
              f"{query}: backend ledger differs from the simulator's")
        for tr, str_ in zip(res.per_task, sim.per_task):
            check(dataclasses.asdict(tr.delta) == dataclasses.asdict(str_.delta),
                  f"{query} {tr.label}: task ledger differs from the simulator's")
            pages = backend.peek_batch(output_ids(tr.op, tr.result))
            sim_pages = simulator.peek_batch(output_ids(str_.op, str_.result))
            check(len(pages) == len(sim_pages) and all(
                a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
                for a, b in zip(pages, sim_pages)),
                f"{query} {tr.label}: output pages differ from the simulator's")
        final = np.concatenate([p.ravel() for p in backend.peek_batch(
            res.per_task[-1].result.run_page_ids)])
        check(res.per_task[-1].op == "ems" and bool((np.diff(final) >= 0).all()),
              f"{query}: the final sort's output is not sorted")
        check(res.schedule == "dag" and res.makespan_seconds <= res.latency_seconds(),
              f"{query}: schedule {res.schedule}, makespan {res.makespan_seconds} > "
              f"serial {res.latency_seconds()}")
        check(backend.wall.kernel_fallbacks == 0, f"{query}: a kernel hook fell back to numpy")
        check(backend.wall.host_pinned_pages == 0, f"{query}: a page was pinned to the host")
        for name in SESSION_KERNELS:
            check(ran.get(name, 0) > 0, f"{query}: the DAG never launched {name}")
        spilled = [tr.label for tr in res.per_task
                   if sum(getattr(tr.result, "per_phase_rounds", {}).values()) > 0]
        check(bool(spilled), f"{query}: no task spilled")
        wall = backend.wall
        emit({"phase": "dag", "query": query, "tasks": [(t.op, t.label) for t in cp.tasks],
              "join_order": [c.chosen for c in cp.join_choices],
              "m_pages": [tr.m_pages for tr in res.per_task],
              "placement": [tr.placement for tr in res.per_task],
              "replan_events": len(res.replan_events), "spilled_tasks": spilled,
              "host_seconds": host_s, "wall_seconds": res.wall_seconds,
              "transfer_seconds": wall.transfer_seconds, "kernel_seconds": wall.kernel_seconds,
              "kernel_calls": wall.kernel_calls, "simulated_seconds": res.latency_seconds(),
              "makespan_seconds": res.makespan_seconds,
              "d_total": res.total.d_total, "c_total": res.total.c_total,
              "output_values": int(final.shape[0]), "launches": ran,
              "kernel_fallbacks": wall.kernel_fallbacks,
              "host_pinned_pages": wall.host_pinned_pages,
              "ledger_equal": True, "outputs_equal": True, "dag_equal": True})
        for name, n in ran.items():
            launches[name] = launches.get(name, 0) + n
        del backend, simulator
    return launches


# --------------------------------------------------------------------------
# Phase 4: gemma-2b serving at full width
# --------------------------------------------------------------------------


def rel_err(torch, got, want) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double())
                 / torch.linalg.vector_norm(want.double()))


def phase_serve(torch, device, cfg=None, phase="serve"):
    """Serve ``cfg`` (gemma-2b by default) through ``ServeEngine.submit``;
    with ``cfg.attn_softcap`` every flash and paged launch must also count
    as capped.  Returns (launches, params)."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cfg = cfg or ARCHS[SERVE_ARCH]
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    emit({"phase": phase, "arch": cfg.name, "params": tf.param_count(params),
          "attn_softcap": cfg.attn_softcap, "logit_softcap": cfg.logit_softcap,
          "init_seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in PROMPT_LENS]
    last = {}

    def keep_last(req, logits, hidden):
        if req.rid in CHECK_RIDS:
            last[req.rid] = (logits.float().clone(), hidden.float().clone())

    engine = ServeEngine(cfg, params, max_len=MAX_LEN, batch_slots=SLOTS, device=device,
                         on_step=keep_last)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    t0 = time.perf_counter()
    results = engine.submit(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    steps = sum(len(r.out_tokens) - 1 for r in reqs)  # the first token is prefill's
    check(sorted(results) == list(range(len(reqs))), "a request did not finish")
    check(all(len(r.out_tokens) == MAX_NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in reqs),
          "a request's tokens are not MAX_NEW_TOKENS ids of the vocabulary")
    check(launches.get("flash_attention", 0) == cfg.n_layers * len(reqs),
          f"flash launches {launches.get('flash_attention')} != {cfg.n_layers} x {len(reqs)}")
    check(launches.get("flash_attention_tc", 0) == launches["flash_attention"],
          f"only {launches.get('flash_attention_tc', 0)} of {launches['flash_attention']} "
          "flash launches took the tensor-core route")
    check(launches.get("paged_attention", 0) == cfg.n_layers * steps,
          f"paged launches {launches.get('paged_attention')} != {cfg.n_layers} x {steps}")
    for name in ("flash_attention", "paged_attention"):
        capped = launches.get(f"{name}_softcap", 0)
        check(capped == (launches[name] if cfg.attn_softcap else 0),
              f"{capped} of {launches[name]} {name} launches took the capped instantiation, "
              f"with attn_softcap {cfg.attn_softcap}")
    for rid, (logits, hidden) in last.items():
        check(bool(torch.isfinite(logits).all() and torch.isfinite(hidden).all()),
              f"request {rid}: non-finite logits or hidden state")

    # The last decode step against a prefill of the same tokens.
    for rid in CHECK_RIDS:
        req = reqs[rid]
        tokens = np.concatenate([req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
        with torch.inference_mode():
            logits, _, hidden = tf.prefill(
                params, cfg, {"tokens": torch.as_tensor(tokens[None], device=device)},
                return_hidden=True)
        dec_logits, dec_hidden = last[rid]
        err_h = rel_err(torch, dec_hidden, hidden[0])
        err_l = rel_err(torch, dec_logits, logits[0])
        emit({"phase": phase, "consistency": rid, "tokens": len(tokens),
              "hidden_rel_err": err_h, "logits_rel_err": err_l, "tol": CONSISTENCY_TOL,
              "max_abs_logit_diff": float((dec_logits - logits[0].float()).abs().max())})
        check(err_h <= CONSISTENCY_TOL and err_l <= CONSISTENCY_TOL,
              f"request {rid}: decode and prefill disagree (hidden {err_h}, logits {err_l})")

    for r in reqs:
        n_dec = len(r.out_tokens) - 1
        emit({"phase": phase, "request": r.rid, "prompt_tokens": len(r.prompt),
              "new_tokens": len(r.out_tokens), "prefill_seconds": r.prefill_seconds,
              "decode_seconds_per_token": r.decode_seconds / n_dec,
              "tokens_per_second": len(r.out_tokens) / (r.prefill_seconds + r.decode_seconds)})
    emit({"phase": phase, "requests": len(reqs), "new_tokens": steps + len(reqs),
          "decode_steps": steps, "wall_seconds": wall,
          "tokens_per_second": (steps + len(reqs)) / wall,
          "launches": launches, "peak_device_bytes": peak})
    return launches, params


def phase_breakdown(torch, device, params, cfg=None, phase="breakdown"):
    """Device time of a 2048-token prefill, 8 decode steps and a 64-token
    prefill of ``cfg`` (gemma-2b by default), by kind, from one profiler
    window."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as tf

    cfg = cfg or ARCHS[SERVE_ARCH]
    rng = np.random.default_rng(SEED + 1)
    long_prompt, short_prompt = (
        torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n), dtype=np.int32), device=device)
        for n in (max(PROMPT_LENS), min(PROMPT_LENS)))

    def timed_prefill(tokens):
        t0 = time.perf_counter()
        logits, caches = tf.prefill(params, cfg, {"tokens": tokens})
        caches = tf.pad_caches(cfg, caches, MAX_LEN)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, tok, caches

    def window():
        with torch.inference_mode():
            prefill_s, tok, caches = timed_prefill(long_prompt)
            t0 = time.perf_counter()
            for pos in range(long_prompt.shape[1], long_prompt.shape[1] + 8):
                logits, caches = tf.decode_step(params, cfg, caches, tok, pos)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            decode_s = (time.perf_counter() - t0) / 8
            short_s, _, _ = timed_prefill(short_prompt)
            return prefill_s, decode_s, short_s

    unprofiled = window()  # also the warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = window()
    kinds = device_seconds(torch, prof, ("flash_attention_kernel", "paged_attention_kernel"),
                           "attention_kernels")
    flash = device_seconds(torch, prof, ("flash_attention_kernel",), "flash")[0]["flash"]
    names = ("prefill_2048_seconds", "decode_step_seconds", "prefill_64_seconds")
    emit({"phase": phase,
          "window": "prefill of 2048 tokens, 8 decode steps, prefill of 64 tokens",
          "unprofiled": dict(zip(names, unprofiled)), "profiled": dict(zip(names, profiled)),
          "flash_attention_device_seconds": flash,
          **busy_and_idle(kinds, profiled[0] + 8 * profiled[1] + profiled[2],
                          unprofiled[0] + 8 * unprofiled[1] + unprofiled[2])})


MATMUL_NAMES = ("gemm", "xmma", "cutlass", "cublas", "nvjet", "matmul", "sm90")


def device_seconds(torch, prof, ours, label):
    """Device seconds of a profiler window by kind: our kernels (names
    containing one of ``ours``), matrix products, and the rest; and the
    number of device events (kernels, copies, fills) in the window.

    Only device events count.  ``key_averages()`` also lists each aten op
    with the device time of the kernels it launched as its own, so summing
    every entry counts those kernels twice."""
    kinds = {label: 0.0, "matmul": 0.0, "other": 0.0}
    events = 0
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = e.self_device_time_total
        events += e.count
        name = e.key.lower()
        if any(w in name for w in ours):
            kinds[label] += us / 1e6
        elif any(w in name for w in MATMUL_NAMES):
            kinds["matmul"] += us / 1e6
        else:
            kinds["other"] += us / 1e6
    return kinds, events


def busy_and_idle(kinds_events, profiled_s, unprofiled_s):
    """Busy device seconds and the idle share, over the profiled window's
    host seconds and over the same work's unprofiled host seconds (the
    profiler slows the host's launches, not the device's kernels)."""
    kinds, events = kinds_events
    busy = sum(kinds.values())
    if not busy:
        return {"device_seconds": kinds, "device_idle_share": "not measured"}
    return {"device_seconds": kinds, "device_events": events, "device_busy_seconds": busy,
            "device_idle_share": 1 - busy / profiled_s,
            "device_idle_share_of_unprofiled_wall": 1 - busy / unprofiled_s}


# --------------------------------------------------------------------------
# Phase 5: the SSD scan kernel and mamba2-370m serving at full width
# --------------------------------------------------------------------------


def phase_ssd_scan(torch, device):
    """The scan kernel against its plain version, bit for bit; a planted
    fault; then timed at the serving shape (S = 2048: 8 chunks)."""
    import numpy as np
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    rng = np.random.default_rng(SEED + 2)
    errs = {}

    def sigmoid_decays(shape, dtype):  # as the JAX test draws them
        return torch.sigmoid(torch.randn(shape, device=device, generator=gen)).to(dtype)

    def near_one_decays(shape):
        # One position's decay exp(dt * A) at A = -1 over Mamba-2's dt range
        # (log-uniform in [1e-3, 1e-1]): 0.905 .. 0.999.
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
        return torch.as_tensor(np.exp(-dt), dtype=torch.float32, device=device)

    serving = (1, 8, 32, 64, 128)
    cases = [(serving, torch.float32, "sigmoid"), (serving, torch.float32, "near 1"),
             ((2, 3, 32, 64, 128), torch.bfloat16, "sigmoid"),
             ((3, 7, 1, 5, 3), torch.float32, "sigmoid"),  # P * N = 15: element-wise path
             ((3, 7, 1, 5, 3), torch.bfloat16, "sigmoid"),
             ((2, 5, 3, 8, 16), torch.float32, "misaligned")]  # 16-byte rows, base + 4 bytes
    for shape, dtype, kind in cases:
        if kind == "misaligned":
            n = int(np.prod(shape))
            states = torch.randn(n + 1, device=device, generator=gen)[1:].view(shape)
        else:
            states = torch.randn(shape, device=device, generator=gen).to(dtype)
        decays = (near_one_decays(shape[:3]) if kind == "near 1"
                  else sigmoid_decays(shape[:3], dtype))
        equal_bits(torch, ["ssd_scan"], ssd_scan(states, decays),
                   ssd_scan_plain(states, decays), errs)
        emit({"phase": "kernels", "check": "ssd_scan", "shape": list(shape),
              "dtype": str(dtype), "decays": kind, "equal": True})

    # The planted fault: the kernel on states whose middle chunk is zeroed,
    # against the plain version on the full states.
    states = torch.randn(serving, device=device, generator=gen)
    decays = near_one_decays(serving[:3])
    cut = states.clone()
    cut[:, serving[1] // 2] = 0
    got, want = ssd_scan(cut, decays), ssd_scan_plain(states, decays)
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    emit({"phase": "kernels", "planted_fault": "ssd_scan",
          "fault": f"zeroes chunk {serving[1] // 2} of {serving[1]}",
          "max_abs_err": max(max_abs_err(torch, g, w) for g, w in zip(got, want)),
          "rejected": not equal})
    check(not equal, "ssd_scan: the bit-for-bit check passes a kernel that drops a chunk")
    torch.cuda.synchronize()

    bench = Bench(torch, device)
    b, nc, h, p, n = serving
    states = torch.randn(serving, device=device, generator=gen)
    decays = sigmoid_decays(serving[:3], torch.float32)
    numel = states.numel()
    ms_bound, by = bound(4 * (2 * numel + numel // nc + decays.numel()), 2 * numel)
    row = dict(
        shape=f"states [{b},{nc},{h},{p},{n}] f32, decays [{b},{nc},{h}]",
        ms=bench.ms(lambda: ssd_scan(states, decays)),
        **bench.device_ms(lambda: ssd_scan(states, decays)),
        plain_ms=bench.ms(lambda: ssd_scan_plain(states, decays)),
        library_ms=None,  # no single PyTorch call computes this scan
        bound_ms=ms_bound, bound_by=by)
    emit({"phase": "kernels", "timing": "ssd_scan", **row})
    del bench
    return errs, {"ssd_scan": row}


def mamba2_dt_bias(rng, n_layers, n_heads):
    """Mamba-2's dt initialisation: per layer and head, the inverse softplus
    of a log-uniform draw in [1e-3, 1e-1]."""
    import numpy as np

    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (n_layers, n_heads)))
    return (dt + np.log(-np.expm1(-dt))).astype(np.float32)


def mamba_params(torch, device, cfg):
    import numpy as np
    from repro_torch.models import transformer as tf

    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    bias = mamba2_dt_bias(np.random.default_rng(SEED), cfg.n_layers, cfg.n_ssm_heads)
    for layer, row in zip(params["layers"], bias):
        layer["ssm"]["dt_bias"] = torch.as_tensor(row, device=device)
    return params


def head_state_err(torch, got, want) -> float:
    """Largest relative L2 error of one head's state [P, N] over every layer,
    batch row and head."""
    worst = 0.0
    for (_, g), (_, w) in zip(got, want):
        g, w = g.double(), w.double()
        num = torch.linalg.vector_norm(g - w, dim=(-2, -1))
        den = torch.linalg.vector_norm(w, dim=(-2, -1)).clamp_min(1e-30)
        worst = max(worst, float((num / den).max()))
    return worst


def phase_mamba_serve(torch, device):
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cfg = ARCHS[MAMBA_ARCH]
    t0 = time.perf_counter()
    params = mamba_params(torch, device, cfg)
    torch.cuda.synchronize()
    emit({"phase": "mamba", "arch": cfg.name, "params": tf.param_count(params),
          "layers": cfg.n_layers, "init_seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in MAMBA_PROMPT_LENS]
    last = {}

    def keep_last(req, logits, hidden):
        if req.rid == MAMBA_CHECK_RID:
            last[req.rid] = (logits.float().clone(), hidden.float().clone())

    engine = ServeEngine(cfg, params, max_len=MAX_LEN, batch_slots=SLOTS, device=device,
                         on_step=keep_last)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    t0 = time.perf_counter()
    results = engine.submit(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    steps = sum(len(r.out_tokens) - 1 for r in reqs)
    check(sorted(results) == list(range(len(reqs))), "a request did not finish")
    check(all(len(r.out_tokens) == MAX_NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in reqs),
          "a request's tokens are not MAX_NEW_TOKENS ids of the vocabulary")
    check(launches.get("ssd_scan", 0) == cfg.n_layers * len(reqs),
          f"ssd_scan launches {launches.get('ssd_scan')} != {cfg.n_layers} x {len(reqs)}")
    logits, hidden = last[MAMBA_CHECK_RID]
    check(bool(torch.isfinite(logits).all() and torch.isfinite(hidden).all()),
          "non-finite logits or hidden state")
    for r in reqs:
        n_dec = len(r.out_tokens) - 1
        emit({"phase": "mamba", "request": r.rid, "prompt_tokens": len(r.prompt),
              "new_tokens": len(r.out_tokens), "prefill_seconds": r.prefill_seconds,
              "decode_seconds_per_token": r.decode_seconds / n_dec,
              "tokens_per_second": len(r.out_tokens) / (r.prefill_seconds + r.decode_seconds)})
    emit({"phase": "mamba", "requests": len(reqs), "new_tokens": steps + len(reqs),
          "decode_steps": steps, "wall_seconds": wall,
          "tokens_per_second": (steps + len(reqs)) / wall,
          "launches": launches, "peak_device_bytes": peak})

    # Check 1: request 7's last decode step against a one-chunk prefill.
    req = reqs[MAMBA_CHECK_RID]
    tokens = np.concatenate([req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
    with torch.inference_mode():
        p_logits, _, p_hidden = tf.prefill(
            params, cfg, {"tokens": torch.as_tensor(tokens[None], device=device)},
            return_hidden=True)
    errs = {"hidden": rel_err(torch, hidden, p_hidden[0]),
            "logits": rel_err(torch, logits, p_logits[0])}
    emit({"phase": "mamba", "consistency": MAMBA_CHECK_RID, "tokens": len(tokens),
          "hidden_rel_err": errs["hidden"], "logits_rel_err": errs["logits"],
          "tol": {k: MAMBA_TOL[k] for k in errs}})
    check(all(errs[k] <= MAMBA_TOL[k] for k in errs),
          f"request {MAMBA_CHECK_RID}: decode and prefill disagree ({errs})")

    # Check 2, across chunks: prefill 7 chunks through the kernel,
    # teacher-force the next 256 tokens, against a prefill of all 8.
    head, total = MAMBA_CROSS
    cross = cross_chunk_check(torch, device, cfg, params)
    emit({"phase": "mamba", "consistency": "across chunks", "prefill_tokens": head,
          "decoded_tokens": total - head, **{f"{k}_rel_err": v for k, v in cross.items()},
          "tol": MAMBA_TOL})
    check(all(cross[k] <= MAMBA_TOL[k] for k in MAMBA_TOL),
          f"cross-chunk decode and prefill disagree ({cross})")
    fault = cross_chunk_check(torch, device, cfg, params, fault=True)
    rejected = any(fault[k] > MAMBA_TOL[k] for k in MAMBA_TOL)
    emit({"phase": "mamba", "planted_fault": "state after prefill",
          "fault": "every layer's post-prefill state replaced by the kernel's prev[:, -1]",
          **{f"{k}_rel_err": v for k, v in fault.items()}, "tol": MAMBA_TOL,
          "rejected": rejected,
          "rejected_by": [k for k in MAMBA_TOL if fault[k] > MAMBA_TOL[k]]})
    check(rejected, "the cross-chunk check passes a prefill that drops its last chunk")
    return launches, params


def cross_chunk_check(torch, device, cfg, params, fault: bool = False):
    """Relative errors of the final hidden state, the logits and the per-head
    SSM states after prefilling ``MAMBA_CROSS[0]`` tokens and decoding up to
    ``MAMBA_CROSS[1]``, against a prefill of all of them.  With ``fault``,
    every layer's post-prefill state is the state entering its last chunk."""
    import numpy as np
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf

    head, total = MAMBA_CROSS
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, total), dtype=np.int32),
                             device=device)
    scan = ssm_mod.remop_ssd_scan

    def entering_last_chunk(states, decays):
        prev, _ = scan(states, decays)
        return prev, prev[:, -1].contiguous()

    with torch.inference_mode():
        if fault:
            ssm_mod.remop_ssd_scan = entering_last_chunk
        try:
            _, caches = tf.prefill(params, cfg, {"tokens": tokens[:, :head]})
        finally:
            ssm_mod.remop_ssd_scan = scan
        for pos in range(head, total):
            logits, caches, hidden = tf.decode_step(params, cfg, caches, tokens[:, pos], pos,
                                                    return_hidden=True)
        p_logits, p_caches, p_hidden = tf.prefill(params, cfg, {"tokens": tokens},
                                                  return_hidden=True)
    return {"hidden": rel_err(torch, hidden[0], p_hidden[0]),
            "logits": rel_err(torch, logits[0], p_logits[0]),
            "state": head_state_err(torch, caches, p_caches)}


def phase_mamba_breakdown(torch, device, params):
    """Device time of a 2048-token prefill and of 8 decode steps of
    mamba2-370m, by kind, each from its own profiler window."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as tf

    cfg = ARCHS[MAMBA_ARCH]
    rng = np.random.default_rng(SEED + 4)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, max(MAMBA_PROMPT_LENS)),
                                          dtype=np.int32), device=device)
    state = {}

    def prefill():
        logits, state["caches"] = tf.prefill(params, cfg, {"tokens": prompt})
        state["tok"] = logits.argmax(-1)

    def decode():
        for pos in range(prompt.shape[1], prompt.shape[1] + 8):
            logits, state["caches"] = tf.decode_step(params, cfg, state["caches"],
                                                     state["tok"], pos)
            state["tok"] = logits.argmax(-1)

    def timed(fn):
        with torch.inference_mode():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    for name, fn, steps in (("prefill of 2048 tokens", prefill, 1),
                            ("8 decode steps after it", decode, 8)):
        torch.cuda.reset_peak_memory_stats(device)
        unprofiled = timed(fn)  # also the warm-up
        peak = torch.cuda.max_memory_allocated(device)
        if fn is decode:
            prefill()  # the same 8 steps again, from the prefill's state
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = timed(fn)
        kinds = device_seconds(torch, prof, ("ssd_scan_kernel",), "ssd_scan_kernel")
        emit({"phase": "mamba_breakdown", "window": name,
              "unprofiled_seconds_per_call": unprofiled / steps,
              "profiled_seconds_per_call": profiled / steps,
              **busy_and_idle(kinds, profiled, unprofiled),
              "peak_device_bytes": peak})


# --------------------------------------------------------------------------
# Phase 5b: granite-moe-3b-a800m serving at full width
# --------------------------------------------------------------------------


@contextlib.contextmanager
def routing_recorded(log: list):
    """Append ``(ids [B, S, k], keep [B, S*k])`` of every MoE layer call to
    ``log`` (device tensors, no sync): the layer's dense dispatch, wrapped
    while the block runs."""
    from repro_torch.models import moe

    dispatch = moe.dispatch_dense

    def recording(x, ids, n_experts, cap):
        out = dispatch(x, ids, n_experts, cap)
        log.append((ids, out[1]))
        return out

    moe.dispatch_dense = recording
    try:
        yield log
    finally:
        moe.dispatch_dense = dispatch


def moe_drops(log) -> int:
    """Dropped assignments over the routing log's calls (one device sync)."""
    return int(sum((~keep).sum() for _, keep in log)) if log else 0


def phase_moe_serve(torch, device):
    """Serve granite-moe-3b-a800m at full width and all 32 layers: the
    flash kernel in every prefill layer, the paged kernel in every decode
    layer, the dense capacity dispatch at cf 1.25.  Then the decode-against-
    prefill check at cf = n_experts (nothing drops) with a planted routing
    fault, and the routing a dispatch check takes its expert ids from."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cfg = ARCHS[MOE_ARCH]
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    emit({"phase": "moe", "arch": cfg.name, "params": tf.param_count(params),
          "layers": cfg.n_layers, "experts": cfg.n_experts, "top_k": cfg.experts_per_token,
          "capacity_factor": cfg.capacity_factor, "init_seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in PROMPT_LENS]
    log = []
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, batch_slots=SLOTS, device=device)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    t0 = time.perf_counter()
    with routing_recorded(log):
        results = engine.submit(reqs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    steps = sum(len(r.out_tokens) - 1 for r in reqs)
    check(sorted(results) == list(range(len(reqs))), "a request did not finish")
    check(all(len(r.out_tokens) == MAX_NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in reqs),
          "a request's tokens are not MAX_NEW_TOKENS ids of the vocabulary")
    check(launches.get("flash_attention", 0) == cfg.n_layers * len(reqs),
          f"flash launches {launches.get('flash_attention')} != {cfg.n_layers} x {len(reqs)}")
    check(launches.get("flash_attention_tc", 0) == launches["flash_attention"],
          f"only {launches.get('flash_attention_tc', 0)} of {launches['flash_attention']} "
          "flash launches took the tensor-core route")
    check(launches.get("paged_attention", 0) == cfg.n_layers * steps,
          f"paged launches {launches.get('paged_attention')} != {cfg.n_layers} x {steps}")
    check(len(log) == cfg.n_layers * (len(reqs) + steps),
          f"{len(log)} MoE calls, not {cfg.n_layers} x {len(reqs) + steps}")

    # The slots admit requests in order, so the prefills' calls come n_layers
    # at a time, request by request.
    calls = [entry for entry in log if entry[0].shape[1] > 1]
    prefills = [calls[i:i + cfg.n_layers] for i in range(0, len(calls), cfg.n_layers)]
    check(len(prefills) == len(reqs) and all(
        ids.shape[1] == len(r.prompt) for r, chunk in zip(reqs, prefills) for ids, _ in chunk),
        "the prefills' MoE calls are not n_layers a request in request order")
    prefill_drops = {r.rid: moe_drops(chunk) for r, chunk in zip(reqs, prefills)}
    decode_drops = moe_drops([entry for entry in log if entry[0].shape[1] == 1])
    check(decode_drops == 0, f"{decode_drops} assignments dropped in decode (capacity 1)")
    check(any(prefill_drops.values()), "no prefill dropped an assignment at cf "
                                       f"{cfg.capacity_factor}")

    step_bound = moe_decode_bound_ms(cfg)
    for r in reqs:
        n_dec = len(r.out_tokens) - 1
        emit({"phase": "moe", "request": r.rid, "prompt_tokens": len(r.prompt),
              "new_tokens": len(r.out_tokens), "prefill_seconds": r.prefill_seconds,
              "decode_seconds_per_token": r.decode_seconds / n_dec,
              "decode_step_bound_ms": step_bound,
              "tokens_per_second": len(r.out_tokens) / (r.prefill_seconds + r.decode_seconds),
              "capacity": moe.capacity(cfg, len(r.prompt)),
              "assignments": cfg.n_layers * len(r.prompt) * cfg.experts_per_token,
              "dropped_assignments": prefill_drops[r.rid]})
    emit({"phase": "moe", "requests": len(reqs), "new_tokens": steps + len(reqs),
          "decode_steps": steps, "wall_seconds": wall,
          "tokens_per_second": (steps + len(reqs)) / wall,
          "dropped_assignments": sum(prefill_drops.values()),
          "launches": launches, "peak_device_bytes": peak})

    # The dispatch check's ids: the layer of the first 2048-token prefill that
    # dropped the most assignments.
    entries = prefills[PROMPT_LENS.index(max(PROMPT_LENS))]
    layer = max(range(cfg.n_layers), key=lambda i: int((~entries[i][1]).sum()))
    routing = entries[layer][0]
    del log, calls, prefills, entries

    moe_consistency(torch, device, cfg, params, prompts)
    return launches, params, (layer, routing)


def moe_decode_bound_ms(cfg) -> float:
    """The least time of one decode step at batch 1: every weight read once
    (the dense path computes all experts at capacity 1), at the card's
    memory rate.  The caches' reads are left out (up to 4096 positions x 8
    KV heads x 64 x 2 x 2 B a layer, ~4% more at the longest request)."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim + cfg.n_heads * cfg.head_dim * d
    layer = attn + d * e + 3 * e * d * ff
    weights = cfg.n_layers * layer + cfg.vocab_size * d
    return weights * 2 / HBM_BYTES_PER_S * 1e3


def moe_consistency(torch, device, cfg, params, prompts):
    """The last decode step of CHECK_RIDS against a prefill of the same
    tokens, at capacity_factor = n_experts (nothing drops, as the JAX
    package's smoke tests run it): hidden state, logits and the share of
    (token, layer) routings on which decode and prefill agree, as sets of
    experts.  Then the same with a planted routing fault in decode: the
    9th-ranked expert in place of the 8th, which the check must reject."""
    import numpy as np
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    k = cfg.experts_per_token
    top_k = moe._top_k

    def ninth_for_eighth(probs, n):
        values, ids = top_k(probs, n + 1)
        keep = list(range(n - 1)) + [n]
        return values[..., keep], ids[..., keep]

    def decode_vs_prefill(rid, fault):
        last, log = {}, []

        def keep_last(req, logits, hidden):
            last["logits"], last["hidden"] = logits.float().clone(), hidden.float().clone()
            if len(req.out_tokens) == 1 and fault:  # decode from here on misroutes
                moe._top_k = ninth_for_eighth

        engine = ServeEngine(cfg, params, max_len=MAX_LEN, batch_slots=1, device=device,
                             on_step=keep_last)
        req = Request(rid=rid, prompt=prompts[rid], max_new_tokens=MAX_NEW_TOKENS)
        try:
            with routing_recorded(log):
                engine.submit([req])
        finally:
            moe._top_k = top_k
        decoded = [ids[0, 0] for ids, _ in log if ids.shape[1] == 1]  # per step and layer
        tokens = np.concatenate([req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
        with routing_recorded([]) as plog, torch.inference_mode():
            logits, _, hidden = tf.prefill(
                params, cfg, {"tokens": torch.as_tensor(tokens[None], device=device)},
                return_hidden=True)
        n = len(req.prompt)
        prefilled = [ids[0, n + step] for step in range(len(tokens) - n) for ids, _ in plog]
        check(len(decoded) == len(prefilled) == cfg.n_layers * (len(tokens) - n),
              f"request {rid}: {len(decoded)} decode and {len(prefilled)} prefill routings")
        agree = sum(bool(torch.equal(a.sort().values, b.sort().values))
                    for a, b in zip(decoded, prefilled))
        drops = moe_drops(log) + moe_drops(plog)
        check(drops == 0, f"request {rid}: {drops} assignments dropped at cf {cfg.n_experts}")
        return {"tokens": len(tokens), "routings": len(decoded),
                "routing_agreement": agree / len(decoded),
                "hidden_rel_err": rel_err(torch, last["hidden"], hidden[0]),
                "logits_rel_err": rel_err(torch, last["logits"], logits[0]),
                "max_abs_logit_diff": float((last["logits"] - logits[0].float()).abs().max())}

    def within(r):
        return all(r[f"{name}_rel_err"] <= tol for name, tol in MOE_TOL.items())

    for rid in CHECK_RIDS:
        r = decode_vs_prefill(rid, fault=False)
        emit({"phase": "moe", "consistency": rid, "capacity_factor": cfg.capacity_factor,
              **r, "tol": MOE_TOL})
        check(within(r), f"request {rid}: decode and prefill disagree ({r})")
    r = decode_vs_prefill(CHECK_RIDS[0], fault=True)
    rejected_by = [name for name, tol in MOE_TOL.items() if r[f"{name}_rel_err"] > tol]
    emit({"phase": "moe", "planted_fault": "routing",
          "fault": f"decode routes to the {k + 1}th-ranked expert in place of the {k}th",
          **r, "tol": MOE_TOL, "rejected": bool(rejected_by), "rejected_by": rejected_by})
    check(bool(rejected_by), "the decode-against-prefill check passes a misrouting decode")


def phase_moe_dispatch(torch, device, layer, routing):
    """``remop_dispatch``/``remop_combine`` at the 2048-token prefill's shape
    (A = 2048 x 8 rows of d_model bf16, E = 40, C = 512) on the expert ids
    of one served layer: bit for bit against their plain versions, by value
    against the oracle and the MoE layer's dense scatter, drops asserted;
    then timed beside the dense scatter."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.dispatch.ops import (
        remop_combine, remop_combine_plain, remop_dispatch, remop_dispatch_plain)
    from repro_torch.kernels.dispatch.ref import dispatch_ref
    from repro_torch.models import moe

    cfg = ARCHS[MOE_ARCH]
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    s, k, e = routing.shape[1], cfg.experts_per_token, cfg.n_experts
    cap = moe.capacity(cfg, s)
    x = torch.randn(1, s, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    rows = x[0].repeat_interleave(k, dim=0)  # assignment rows, token-major
    ids = routing.reshape(-1).to(torch.int32)
    errs = {}

    got = remop_dispatch(rows, ids, e, cap)
    want = remop_dispatch_plain(rows, ids, e, cap)
    equal_bits(torch, ["gather_rows"], (got[1], got[0].view(torch.int16)),
               (want[1], want[0].view(torch.int16)), errs)
    ref_in, ref_slot = dispatch_ref(rows, ids, e, cap)
    check(torch.equal(got[1], ref_slot) and torch.equal(got[0], ref_in),
          "remop_dispatch differs from dispatch_ref")
    dense_in, keep, _ = moe.dispatch_dense(x, routing, e, cap)
    dropped = int((~keep).sum())
    check(dropped > 0, f"layer {layer}'s routing drops nothing at capacity {cap}")
    check(torch.equal(got[0].view(torch.int16), dense_in[0].view(torch.int16))
          and torch.equal(got[1] >= 0, keep[0]),
          "remop_dispatch's buffers differ from the MoE layer's dense scatter")
    expert_out = torch.randn(e, cap, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    weights = torch.rand(s * k, device=device, generator=gen).to(torch.bfloat16)
    y = remop_combine(expert_out, got[1], weights, k)
    equal_bits(torch, ["gather_rows"], (y.view(torch.int16),),
               (remop_combine_plain(expert_out, got[1], weights, k).view(torch.int16),), errs)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "check": "remop_dispatch+remop_combine", "layer": layer,
          "assignments": s * k, "experts": e, "capacity": cap, "dropped": dropped,
          "plain_equal": True, "ref_equal": True, "dense_scatter_equal": True})

    bench = Bench(torch, device)
    moved = e * cap  # destination rows the gather fills
    ms_bound, by = bound(2 * moved * cfg.d_model * 2 + 4 * moved, 0)
    emit({"phase": "kernels", "timing": "remop_dispatch",
          "shape": f"x [{s * k}, {cfg.d_model}] bf16, ids of layer {layer}, E {e}, C {cap}",
          "bound_ms": ms_bound, "bound_by": by,
          "ms": bench.ms(lambda: remop_dispatch(rows, ids, e, cap)),
          **bench.device_ms(lambda: remop_dispatch(rows, ids, e, cap)),
          "plain_ms": bench.ms(lambda: remop_dispatch_plain(rows, ids, e, cap)),
          "dense_scatter_ms": bench.ms(lambda: moe.dispatch_dense(x, routing, e, cap)),
          **{f"dense_scatter_{key}": v for key, v in bench.device_ms(
              lambda: moe.dispatch_dense(x, routing, e, cap)).items()},
          "combine_ms": bench.ms(lambda: remop_combine(expert_out, got[1], weights, k)),
          **{f"combine_{key}": v for key, v in bench.device_ms(
              lambda: remop_combine(expert_out, got[1], weights, k)).items()}})
    del bench
    return errs


def phase_moe_breakdown(torch, device, params, arch=MOE_ARCH, step_bound_ms=None):
    """Device time of a 2048-token prefill and of 8 decode steps of an MoE
    model (granite-moe-3b-a800m unless ``arch`` says otherwise), each from
    its own profiler window: attention kernels, expert products (the batched
    products, ``aten::bmm``; in MLA's decode also its two small absorption
    products), other products and the rest, with the device's idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as tf

    cfg = ARCHS[arch]
    if step_bound_ms is None:
        step_bound_ms = moe_decode_bound_ms(cfg)
    rng = np.random.default_rng(SEED + 5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, max(PROMPT_LENS)),
                                          dtype=np.int32), device=device)
    state = {}

    def prefill():
        logits, caches = tf.prefill(params, cfg, {"tokens": prompt})
        state["caches"] = tf.pad_caches(cfg, caches, MAX_LEN)
        state["tok"] = logits.argmax(-1)

    def decode():
        for pos in range(prompt.shape[1], prompt.shape[1] + 8):
            logits, state["caches"] = tf.decode_step(params, cfg, state["caches"],
                                                     state["tok"], pos)
            state["tok"] = logits.argmax(-1)

    def timed(fn):
        with torch.inference_mode():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    for name, fn, steps in (("prefill of 2048 tokens", prefill, 1),
                            ("8 decode steps after it", decode, 8)):
        unprofiled = timed(fn)  # also the warm-up
        if fn is decode:
            timed(prefill)  # the same 8 steps again, from the prefill's caches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = timed(fn)
        kinds, events = device_seconds(torch, prof, ("flash_attention_kernel",
                                                     "paged_attention_kernel"),
                                       "attention_kernels")
        expert = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
                     if e.key == "aten::bmm") / 1e6
        check(0 < expert <= kinds["matmul"], f"{name}: expert products {expert} s of "
                                             f"{kinds['matmul']} s of products")
        kinds = {"attention_kernels": kinds["attention_kernels"], "expert_products": expert,
                 "other_products": kinds["matmul"] - expert, "other": kinds["other"]}
        emit({"phase": "moe_breakdown", "arch": cfg.name, "window": name,
              "unprofiled_seconds_per_call": unprofiled / steps,
              "profiled_seconds_per_call": profiled / steps,
              "decode_step_bound_ms": step_bound_ms,
              **busy_and_idle((kinds, events), profiled, unprofiled)})


# --------------------------------------------------------------------------
# Phase 5c: deepseek-v2-lite-16b (MLA + MoE): the flash kernel at 192 / 128,
# the paged kernel's latent route, one MLA layer, serving at full width
# --------------------------------------------------------------------------


def with_nan_tail(torch, latent, lengths):
    """``latent`` with every row at or past its ``lengths`` set to NaN, and
    the same with those rows zeroed."""
    nan, zero = latent.clone(), latent.clone()
    for i, n in enumerate(lengths.tolist()):
        nan[i, n:] = float("nan")
        zero[i, n:] = 0
    return nan, zero


def phase_mla_kernels(torch, device):
    """The flash kernel at deepseek's prefill widths (q/k 192, v 128) and the
    latent route (576 / 512) against their plain versions under ATTN_TOL; a
    NaN tail past ``lengths`` must never reach the latent route's output; two
    planted faults; registers and spills; then both timed beside their bounds
    and SDPA."""
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import plan_blocks, remop_flash_attention
    from repro_torch.kernels.paged_attention import paged_attention as pa

    cfg = ARCHS[MLA_ARCH]
    h, hd, hd_v = cfg.n_heads, cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim
    width, lora = cfg.kv_lora_rank + cfg.rope_head_dim, cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(hd)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    errs, rows = {}, {}
    pair = f"flash_attention_tc_{hd}x{hd_v}"

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=device, generator=gen).to(dtype)

    # -- the flash kernel at 192 / 128: the kernel's layout, the model's
    # transposed [B, S, H, hd] views, a ragged prefill --------------------------
    for s, t in ((2048, 2048), (777, 777), (300, 333)):
        q, k, v = randn(1, h, s, hd), randn(1, h, t, hd), randn(1, h, t, hd_v)
        want = fa.flash_attention_plain(q, k, v)
        for layout, (qx, kx, vx) in (("kernel", (q, k, v)), ("model", tuple(
                x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)))):
            before = runtime.launches[pair]
            got = remop_flash_attention(qx, kx, vx)
            check(runtime.launches[pair] == before + 1 and fa.route(qx, kx, vx) == "tc",
                  f"flash {hd}/{hd_v} {layout} did not take the tensor-core route")
            check(layout == "kernel" or got.stride()[1] == hd_v,
                  "flash 192/128 output lost the model's layout")
            err, rel = allclose(torch, [pair], got, want, errs)
            emit({"phase": "mla", "check": pair, "shape": [1, h, h, s, t, hd, hd_v],
                  "layout": layout, "blocks": plan_blocks(s, t, hd, 2, hd_v=hd_v),
                  "tol": ATTN_TOL["torch.bfloat16"], "max_abs_err": err, "rel_err": rel})
    emit({"phase": "mla", "flash_attention_tc_instantiations": {
        f"hd {hd}/{hd_v} bq {bq} bk {bk}": fa.occupancy(hd, bq, bk, hd_v=hd_v)
        for bq in fa.TC_BLOCKS for bk in fa.TC_BLOCKS}})

    # -- the latent route: lengths below S, a NaN tail past them ---------------------
    for s, lengths in LATENT_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            ln = torch.tensor(lengths, dtype=torch.int32, device=device)
            q = randn(len(lengths), h, width, dtype=dtype)
            latent, clean = with_nan_tail(torch, randn(len(lengths), s, width, dtype=dtype), ln)
            got = pa.latent_decode(q, latent, ln, scale)
            check(bool(torch.isfinite(got).all()), f"latent S {s}: the NaN tail reached the output")
            check(torch.equal(got, pa.latent_decode(q, clean, ln, scale)),
                  f"latent S {s}: the output depends on the rows past lengths")
            err, rel = allclose(torch, ["paged_attention_latent"], got,
                                pa.latent_decode_plain(q, clean, ln, scale), errs)
            emit({"phase": "mla", "check": "paged_attention_latent", "shape": [len(lengths), h, s],
                  "lengths": list(lengths), "dtype": str(dtype), "nan_tail": True,
                  "plan": pa.latent_plan(len(lengths), h, s), "tol": ATTN_TOL[str(dtype)],
                  "max_abs_err": err, "rel_err": rel})
    emit({"phase": "mla", "paged_attention_latent_instantiations": {
        f"{str(dtype)[6:]} gc {h}": pa.latent_attributes(dtype, h)
        for dtype in (torch.bfloat16, torch.float32)}})
    # Planted faults, made with the kernel: the scale of the latent width
    # (1/sqrt(576)) for the per-head width's, and scores without the rope
    # term (q's 64 rope columns zeroed).
    ln = torch.tensor([2077], dtype=torch.int32, device=device)
    q, latent = randn(1, h, width), randn(1, 4096, width)
    want = pa.latent_decode_plain(q, latent, ln, scale)
    reject_fault(torch, "paged_attention_latent", "scales the scores by 1/sqrt(576)",
                 pa.latent_decode(q, latent, ln, 1.0 / math.sqrt(width)), want)
    no_rope = q.clone()
    no_rope[..., lora:] = 0
    reject_fault(torch, "paged_attention_latent", "drops the rope term from the scores",
                 pa.latent_decode(no_rope, latent, ln, scale), want)
    torch.cuda.synchronize()

    # -- timing at deepseek's shapes: a 2048-token prefill, a decode step at
    # length 2048 of a 4096-slot cache ------------------------------------------
    bench = Bench(torch, device)
    s = 2048
    q, k, v = randn(1, h, s, hd), randn(1, h, s, hd), randn(1, h, s, hd_v)
    ms_bound, by = bound(*flash_cost(1, h, h, s, s, hd, 2, hd_v), BF16_OPS_PER_S)
    bq, bk = plan_blocks(s, s, hd, 2, hd_v=hd_v)

    def flash_kernel():
        return fa.flash_attention(q, k, v, bq=bq, bk=bk)

    def flash_sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)

    rows[pair] = dict(
        shape=f"q/k [1,{h},{s},{hd}], v [1,{h},{s},{hd_v}] bf16, causal, blocks {(bq, bk)}",
        ms=bench.ms(flash_kernel),
        remop_flash_attention_ms=bench.ms(lambda: remop_flash_attention(q, k, v)),
        plain_ms=bench.ms(lambda: fa.flash_attention_plain(q, k, v)),
        library_ms=bench.ms(flash_sdpa),
        bound_ms=ms_bound, bound_by=by,
        **bench.device_ms(flash_kernel),
        **{f"library_{key}": val for key, val in bench.device_ms(flash_sdpa).items()})
    s, length = MAX_LEN, max(PROMPT_LENS)
    ln = torch.full((1,), length, dtype=torch.int32, device=device)
    q, latent = randn(1, h, width), randn(1, s, width)
    mask = (torch.arange(s, device=device) < length)[None, None, None, :]
    ms_bound, by = bound((length * width + h * width + h * lora) * 2,
                         2 * h * length * (width + lora), BF16_OPS_PER_S)

    def latent_kernel():
        return pa.latent_decode(q, latent, ln, scale)

    def latent_sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None], latent[:, None], latent[:, None, :, :lora], attn_mask=mask,
            scale=scale, enable_gqa=True)

    rows["paged_attention_latent"] = dict(
        shape=f"q [1,{h},{width}], latent [1,{s},{width}] bf16, values its first {lora} "
              f"columns, length {length}, plan {pa.latent_plan(1, h, s)}",
        ms=bench.ms(latent_kernel),
        plain_ms=bench.ms(lambda: pa.latent_decode_plain(q, latent, ln, scale)),
        library_ms=bench.ms(latent_sdpa),
        bound_ms=ms_bound, bound_by=by,
        partial_bytes=pa.scratch_floats(1, 1, h, lora, sum(
            hi > lo for lo, hi in pa.chunk_bounds(length, pa.latent_plan(1, h, s)[0],
                                                  pa.LATENT_MIN_CHUNK))) * 4,
        cache_bytes=length * width * 2,
        **bench.device_ms(latent_kernel),
        **{f"library_{key}": val for key, val in bench.device_ms(latent_sdpa).items()})
    for name, row in rows.items():
        emit({"phase": "mla", "timing": name, **row})
    del bench
    return errs, rows


def mla_layer_errors(torch, device, cfg, fault: bool = False):
    """One MLA layer at ``cfg``'s widths on MLA_LAYER_SEQ tokens: the
    relative L2 error of its absorbed decode at each of MLA_LAYER_POSITIONS
    against ``mla_forward``'s row there, the decode's cache the forward's
    rows before the position.  ``fault`` ropes the step (query and cache row)
    at the next position."""
    from repro_torch.models import attention as attn

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    p = attn.init_mla(cfg, gen, device)
    s = MLA_LAYER_SEQ
    x = torch.randn(1, s, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    positions = torch.arange(s, dtype=torch.int32, device=device)[None]
    with torch.inference_mode():
        want, (c_kv, k_rope) = attn.mla_forward(p, cfg, x, positions, return_cache=True)
        errs = []
        for pos in MLA_LAYER_POSITIONS:
            cache = attn.mla_pad(attn.mla_cache(c_kv[:, :pos], k_rope[:, :pos]), s)
            got, _ = attn.mla_decode(p, cfg, x[:, pos:pos + 1], cache, pos + 1 if fault else pos)
            errs.append(rel_err(torch, got[0, 0], want[0, pos]))
    return errs


def phase_mla_layer(torch, device):
    """One MLA layer of deepseek-v2-lite at full width: the absorbed decode
    against the forward pass, row by row; a planted off-by-one position must
    fail every row past the first."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[MLA_ARCH]
    errs = mla_layer_errors(torch, device, cfg)
    emit({"phase": "mla", "layer_check": "absorbed decode against mla_forward",
          "seq": MLA_LAYER_SEQ, "positions": list(MLA_LAYER_POSITIONS), "rel_l2": errs,
          "max_rel_l2": max(errs), "tol": MLA_LAYER_TOL})
    check(max(errs) <= MLA_LAYER_TOL, f"MLA absorbed decode differs from the forward pass: {errs}")
    bad = mla_layer_errors(torch, device, cfg, fault=True)
    rejected = all(e > MLA_LAYER_TOL for e in bad[1:])
    emit({"phase": "mla", "planted_fault": "layer", "fault": "ropes the step at position + 1",
          "rel_l2": bad, "min_rel_l2_past_first": min(bad[1:]), "tol": MLA_LAYER_TOL,
          "rejected": rejected})
    check(rejected, "the layer check passes a decode that ropes at the next position")


def nbytes(tree) -> int:
    """Bytes of the tensors in a tree of dicts and lists."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def weights_bound_ms(params) -> float:
    """The least time of one decode step at batch 1 when every weight is
    read once (the dense MoE path computes all experts at capacity 1), at the
    card's memory rate; the caches' reads are left out (at most 4096 x 576 x 2
    bytes a layer, 0.15% more)."""
    return nbytes(params) / HBM_BYTES_PER_S * 1e3


def phase_mla_serve(torch, device):
    """Serve deepseek-v2-lite-16b at full width and all 27 layers: the flash
    kernel at 192 / 128 in every prefill layer, the latent route in every
    decode layer, the dense capacity dispatch at cf 1.25."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cfg = ARCHS[MLA_ARCH]
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    emit({"phase": "mla", "arch": cfg.name, "params": tf.param_count(params),
          "layers": cfg.n_layers, "experts": cfg.n_experts, "top_k": cfg.experts_per_token,
          "shared_experts": cfg.n_shared_experts, "kv_lora_rank": cfg.kv_lora_rank,
          "capacity_factor": cfg.capacity_factor, "init_seconds": time.perf_counter() - t0,
          "weight_bytes_on_device": torch.cuda.memory_allocated(device)})
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in PROMPT_LENS]
    log = []
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, batch_slots=SLOTS, device=device)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    t0 = time.perf_counter()
    with routing_recorded(log):
        results = engine.submit(reqs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    steps = sum(len(r.out_tokens) - 1 for r in reqs)
    pair = f"flash_attention_tc_{cfg.nope_head_dim + cfg.rope_head_dim}x{cfg.v_head_dim}"
    check(sorted(results) == list(range(len(reqs))), "a request did not finish")
    check(all(len(r.out_tokens) == MAX_NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in reqs),
          "a request's tokens are not MAX_NEW_TOKENS ids of the vocabulary")
    check(launches.get("flash_attention", 0) == launches.get(pair, 0) == cfg.n_layers * len(reqs),
          f"flash launches {launches.get('flash_attention')}, at 192/128 on the tensor cores "
          f"{launches.get(pair)}, not {cfg.n_layers} x {len(reqs)}")
    check(launches.get("paged_attention_latent", 0) == cfg.n_layers * steps
          and not launches.get("paged_attention"),
          f"latent launches {launches.get('paged_attention_latent')} != {cfg.n_layers} x "
          f"{steps}, or a GQA paged launch")
    n_moe = cfg.n_layers - cfg.first_k_dense
    check(len(log) == n_moe * (len(reqs) + steps),
          f"{len(log)} MoE calls, not {n_moe} x {len(reqs) + steps}")
    calls = [entry for entry in log if entry[0].shape[1] > 1]
    prefills = [calls[i:i + n_moe] for i in range(0, len(calls), n_moe)]
    check(len(prefills) == len(reqs) and all(
        ids.shape[1] == len(r.prompt) for r, chunk in zip(reqs, prefills) for ids, _ in chunk),
        "the prefills' MoE calls are not n_moe a request in request order")
    prefill_drops = {r.rid: moe_drops(chunk) for r, chunk in zip(reqs, prefills)}
    decode_drops = moe_drops([entry for entry in log if entry[0].shape[1] == 1])
    check(decode_drops == 0, f"{decode_drops} assignments dropped in decode (capacity 1)")
    del log, calls, prefills

    step_bound = weights_bound_ms(params)
    for r in reqs:
        n_dec = len(r.out_tokens) - 1
        emit({"phase": "mla", "request": r.rid, "prompt_tokens": len(r.prompt),
              "new_tokens": len(r.out_tokens), "prefill_seconds": r.prefill_seconds,
              "decode_seconds_per_token": r.decode_seconds / n_dec,
              "decode_step_bound_ms": step_bound,
              "tokens_per_second": len(r.out_tokens) / (r.prefill_seconds + r.decode_seconds),
              "capacity": moe.capacity(cfg, len(r.prompt)),
              "assignments": n_moe * len(r.prompt) * cfg.experts_per_token,
              "dropped_assignments": prefill_drops[r.rid]})
    emit({"phase": "mla", "requests": len(reqs), "new_tokens": steps + len(reqs),
          "decode_steps": steps, "wall_seconds": wall,
          "tokens_per_second": (steps + len(reqs)) / wall,
          "dropped_assignments": sum(prefill_drops.values()),
          "launches": launches, "peak_device_bytes": peak})
    return launches, params, step_bound


# --------------------------------------------------------------------------
# Phase 5d: recurrentgemma-2b (RG-LRU + local attention): the flash kernel's
# window, the paged kernel over a ring, one local-attention layer, serving
# at full width
# --------------------------------------------------------------------------


def windowed_flash(torch, q, k, v, window, path):
    """The flash kernel at ``window`` through the model's entry point; checks
    by the launch counters that the call took ``path`` and counted as
    windowed."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention.ops import remop_flash_attention

    before = (runtime.launches[f"flash_attention_{path}"],
              runtime.launches["flash_attention_windowed"])
    out = remop_flash_attention(q, k, v, window=window)
    check((runtime.launches[f"flash_attention_{path}"],
           runtime.launches["flash_attention_windowed"])
          == (before[0] + 1, before[1] + bool(window)),
          f"windowed flash {tuple(q.shape)} {q.dtype} W {window} did not take the {path} route")
    return out


def planted_edge(torch, device, gen, s, hd, window, dtype):
    """recurrentgemma's prefill shape (10 query heads on one KV head) with a
    key planted for each of some rows 200 apart, alternately at distance
    exactly W from it (outside the window) and W - 1 (inside): the row's
    query is 8 e_j in every head, its key 60 e_j (a score of 30, where the
    random keys score about N(0, 1/4) for it and e_j is the row's own axis,
    so no other planted row's key scores for it), its value 4 in every
    column.  Returns (q, k, v, rows outside, rows inside)."""
    q = torch.randn(1, 10, s, hd, device=device, generator=gen)
    k = torch.randn(1, 1, s, hd, device=device, generator=gen)
    v = torch.randn(1, 1, s, hd, device=device, generator=gen)
    outside, inside = [], []
    for j, r in enumerate(range(window + 52, s, 200)):
        d = window if j % 2 == 0 else window - 1
        q[0, :, r] = 0.0
        q[0, :, r, j] = 8.0
        k[0, 0, r - d] = 0.0
        k[0, 0, r - d, j] = 60.0
        v[0, 0, r - d] = 4.0
        (outside if d == window else inside).append(r)
    return (*(x.to(dtype) for x in (q, k, v)), outside, inside)


def phase_hybrid_kernels(torch, device):
    """The flash kernel's window against its plain version under ATTN_TOL on
    both routes; two planted faults (no window; the window's edge one key
    off, on keys planted at distance W and W - 1); window 0 bit for bit as
    wide a window as the keys; the paged kernel over a 2048-slot ring at
    G = 10; then both timed beside their bounds and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import plan_blocks
    from repro_torch.kernels.paged_attention import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    errs, rows = {}, {}
    name = "flash_attention_windowed"

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=device, generator=gen).to(dtype)

    # -- the window on both routes --------------------------------------------------------
    for b, h, kv, s, hd, window in WINDOW_CHECKS:
        for dtype, path in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
            q, k, v = randn(b, h, s, hd, dtype=dtype), *(randn(b, kv, s, hd, dtype=dtype)
                                                         for _ in range(2))
            bq, bk = plan_blocks(s, s, hd, q.element_size(), path=path)
            got = windowed_flash(torch, q, k, v, window, path)
            err, rel = allclose(torch, [name], got,
                                fa.flash_attention_plain(q, k, v, bk, window=window), errs)
            emit({"phase": "hybrid", "check": name, "shape": [b, h, kv, s, s, hd],
                  "window": window, "dtype": str(dtype), "route": path, "blocks": [bq, bk],
                  "tol": ATTN_TOL[str(dtype)], "max_abs_err": err, "rel_err": rel})
    # -- planted faults: no window at all; the window's edge one key off -------------------
    b, h, kv, s, hd, window = WINDOW_CHECKS[2]
    q, k, v = randn(b, h, s, hd), randn(b, kv, s, hd), randn(b, kv, s, hd)
    bq, bk = plan_blocks(s, s, hd, 2)
    reject_fault(torch, name, f"applies a window ({window}, S {s}) the plain version lacks",
                 windowed_flash(torch, q, k, v, window, "tc"),
                 fa.flash_attention_plain(q, k, v, bk))
    for dtype, path in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        q, k, v, outside, inside = planted_edge(torch, device, gen, s, hd, window, dtype)
        bq, bk = plan_blocks(s, s, hd, q.element_size(), path=path)
        want = fa.flash_attention_plain(q, k, v, bk, window=window)
        far = (want[0, :, outside].float() - 4.0).abs().amin(dim=-1)  # [heads, rows]
        near = (want[0, :, inside].float() - 4.0).abs().amax(dim=-1)
        emit({"phase": "hybrid", "edge_classes": str(dtype), "rows_at_distance_w": outside,
              "rows_at_distance_w_minus_1": inside,
              "min_distance_from_planted_value_outside": float(far.min()),
              "max_distance_from_planted_value_inside": float(near.max())})
        check(len(outside) >= 4 and len(inside) >= 4 and float(far.min()) > 1.0
              and float(near.max()) < 0.1,
              "the planted keys do not decide their rows: the data does not exercise the "
              "window's edge")
        allclose(torch, [name], windowed_flash(torch, q, k, v, window, path), want, errs)
        for wrong, what in ((window + 1, "sees the key at distance W"),
                            (window - 1, "misses the key at distance W - 1")):
            reject_fault(torch, name, f"{what} ({path}, window {wrong} for {window})",
                         windowed_flash(torch, q, k, v, wrong, path), want)
    # -- window 0 launches what it launched: bit for bit the kernel with a
    # window as wide as the keys (never masks, starts at block 0) ---------------------------
    q, k, v = randn(1, 8, 2048, 256), randn(1, 1, 2048, 256), randn(1, 1, 2048, 256)
    causal = windowed_flash(torch, q, k, v, 0, "tc")
    check(torch.equal(causal, windowed_flash(torch, q, k, v, 2048, "tc")),
          "window 0 and a window as wide as the keys differ at gemma-2b's shape")
    emit({"phase": "hybrid", "check": "flash_attention window 0",
          "shape": [1, 8, 1, 2048, 2048, 256], "equal_bits_to_window_2048": True})
    # -- the paged kernel over a 2048-slot ring at G = 10 ---------------------------------
    q = randn(1, 1, 10, 256)
    ring_k, ring_v = randn(1, window, 1, 256), randn(1, window, 1, 256)
    for length in RING_LENGTHS:
        ln = torch.full((1,), length, dtype=torch.int32, device=device)
        err, rel = allclose(torch, ["paged_attention_ring"],
                            pa.paged_attention(q, ring_k, ring_v, ln),
                            pa.paged_attention_plain(q, ring_k, ring_v, ln), errs)
        emit({"phase": "hybrid", "check": "paged_attention_ring", "shape": [1, 1, 10, 256, window],
              "lengths": [length], "plan": pa.plan(1, 1, 10, window),
              "tol": ATTN_TOL["torch.bfloat16"], "max_abs_err": err, "rel_err": rel})
    # A wrapped ring (position p at slot p % W, the oldest at slot 1901)
    # against the plain version over the same rows in position order.
    shift = 1901
    err, rel = allclose(torch, ["paged_attention_ring"],
                        pa.paged_attention(q, ring_k, ring_v, ln.fill_(window)),
                        pa.paged_attention_plain(q, ring_k.roll(-shift, 1),
                                                 ring_v.roll(-shift, 1), ln), errs)
    emit({"phase": "hybrid", "check": "paged_attention_ring", "wrapped_at_slot": shift,
          "max_abs_err": err, "rel_err": rel})
    torch.cuda.synchronize()

    # -- timing: recurrentgemma's 4096-token prefill, and a decode step over a
    # full ring -----------------------------------------------------------------------------
    bench = Bench(torch, device)
    b, h, kv, s, hd, window = WINDOW_CHECKS[2]
    q, k, v = randn(b, h, s, hd), randn(b, kv, s, hd), randn(b, kv, s, hd)
    bq, bk = plan_blocks(s, s, hd, 2)
    pos = torch.arange(s, device=device)
    band = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
    ms_bound, by = bound(*flash_cost(b, h, kv, s, s, hd, 2, window=window), BF16_OPS_PER_S)

    def kernel(window=window, q=q, k=k, v=v):
        return fa.flash_attention(q, k, v, bq=bq, bk=bk, window=window)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=True)

    q2, k2, v2 = (x[:, :, :2048] for x in (q, k, v))
    rows[name] = dict(
        shape=f"q [{b},{h},{s},{hd}], k/v [{b},{kv},{s},{hd}] bf16, window {window}, "
              f"blocks {(bq, bk)}",
        ms=bench.ms(kernel),
        plain_ms=bench.ms(lambda: fa.flash_attention_plain(q, k, v, bk, window=window)),
        library_ms=bench.ms(sdpa),
        bound_ms=ms_bound, bound_by=by,
        **bench.device_ms(kernel),
        **{f"library_{key}": val for key, val in bench.device_ms(sdpa).items()},
        causal_at_s_4096_device_ms=bench.device_ms(lambda: kernel(0))["device_ms"],
        causal_at_s_4096_bound_ms=bound(*flash_cost(b, h, kv, s, s, hd, 2), BF16_OPS_PER_S)[0],
        windowed_at_s_2048_device_ms=bench.device_ms(
            lambda: kernel(window, q2, k2, v2))["device_ms"],
        causal_at_s_2048_device_ms=bench.device_ms(lambda: kernel(0, q2, k2, v2))["device_ms"])
    q = randn(1, 1, 10, 256)
    ln = torch.full((1,), window, dtype=torch.int32, device=device)
    ms_bound, by = bound((2 * window * 256 + 2 * 10 * 256) * 2, 4 * 256 * window * 10,
                         BF16_OPS_PER_S)

    def ring_kernel():
        return pa.paged_attention(q, ring_k, ring_v, ln)

    def ring_sdpa():
        return F.scaled_dot_product_attention(q.reshape(1, 10, 1, 256), ring_k.transpose(1, 2),
                                              ring_v.transpose(1, 2), enable_gqa=True)

    rows["paged_attention_ring"] = dict(
        shape=f"q [1,1,10,256], ring [1,{window},1,256] bf16, length {window}, "
              f"plan {pa.plan(1, 1, 10, window)}",
        ms=bench.ms(ring_kernel),
        plain_ms=bench.ms(lambda: pa.paged_attention_plain(q, ring_k, ring_v, ln)),
        library_ms=bench.ms(ring_sdpa),
        bound_ms=ms_bound, bound_by=by,
        **bench.device_ms(ring_kernel),
        **{f"library_{key}": val for key, val in bench.device_ms(ring_sdpa).items()})
    for key, row in rows.items():
        emit({"phase": "hybrid", "timing": key, **row})
    del bench
    return errs, rows


def window_zero_probe(torch, device) -> dict:
    """The flash kernel at gemma-2b's prefill shape called as every earlier
    slice calls it (no window argument): a digest of its output's bits and
    its device ms.  Not run by ``main``: a parent/change A/B calls it with
    either checkout's kernels first on ``sys.path``."""
    import hashlib
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import plan_blocks

    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn(1, h, 2048, 256, device=device, generator=gen).to(torch.bfloat16)
               for h in (8, 1, 1))
    bq, bk = plan_blocks(2048, 2048, 256)

    def kernel():
        return fa.flash_attention(q, k, v, bq=bq, bk=bk)

    digest = hashlib.sha256(kernel().view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    return {"digest": digest, "blocks": [bq, bk], **Bench(torch, device).device_ms(kernel)}


@contextlib.contextmanager
def ring_fault(fault):
    """The decode's ring rules with a planted fault: ``"slot"`` writes
    position pos at slot (pos + 1) % W, ``"length"`` attends to min(pos, W)
    slots; None plants nothing."""
    from repro_torch.models import attention as attn

    slot, length = attn.cache_slot, attn.cache_length
    if fault == "slot":
        attn.cache_slot = lambda pos, size, window: (pos + 1) % size if window else slot(
            pos, size, window)
    elif fault == "length":
        attn.cache_length = lambda pos, size: min(pos, size)
    try:
        yield
    finally:
        attn.cache_slot, attn.cache_length = slot, length


def hybrid_layer_errors(torch, device, cfg, fault=None):
    """One local-attention layer at ``cfg``'s widths on HYBRID_LAYER_SEQ
    tokens: the relative L2 error of its decode at each of
    HYBRID_LAYER_POSITIONS against ``gqa_forward``'s row there, the decode's
    ring packed from the forward's K/V before the position; ``fault`` as
    :func:`ring_fault` plants it."""
    from repro_torch.models import attention as attn

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    p = attn.init_gqa(cfg, gen, device)
    s, window = HYBRID_LAYER_SEQ, cfg.window
    x = torch.randn(1, s, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    positions = torch.arange(s, dtype=torch.int32, device=device)[None]
    with torch.inference_mode():
        want, (k, v) = attn.gqa_forward(p, cfg, x, positions, window=window, return_kv=True)
        errs = []
        for pos in HYBRID_LAYER_POSITIONS:
            ring = attn.ring_pack((k[:, :pos], v[:, :pos]), positions[:, :pos], window)
            with ring_fault(fault):
                got, _ = attn.gqa_decode(p, cfg, x[:, pos:pos + 1], ring, pos, window=window)
            errs.append(rel_err(torch, got[0, 0], want[0, pos]))
    return errs


def phase_hybrid_layer(torch, device):
    """One local-attention layer of recurrentgemma at full width: the ring
    decode against the windowed forward, row by row, across the wrap; a ring
    written one slot ahead must fail every row, and one read a slot short
    every row before the wrap (after it the ring is full either way)."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[HYBRID_ARCH]
    errs = hybrid_layer_errors(torch, device, cfg)
    emit({"phase": "hybrid", "layer_check": "ring decode against the windowed gqa_forward",
          "seq": HYBRID_LAYER_SEQ, "window": cfg.window, "positions": list(HYBRID_LAYER_POSITIONS),
          "rel_l2": errs, "max_rel_l2": max(errs), "tol": HYBRID_LAYER_TOL})
    check(max(errs) <= HYBRID_LAYER_TOL, f"the ring decode differs from the forward pass: {errs}")
    for fault, what, bites in (
            ("slot", "writes position pos at slot (pos + 1) % W", lambda pos: True),
            ("length", "attends to min(pos, W) slots", lambda pos: pos < cfg.window)):
        bad = hybrid_layer_errors(torch, device, cfg, fault)
        hit = [e for pos, e in zip(HYBRID_LAYER_POSITIONS, bad) if bites(pos)]
        rejected = all(e > HYBRID_LAYER_TOL for e in hit)
        emit({"phase": "hybrid", "planted_fault": "layer", "fault": what, "rel_l2": bad,
              "min_rel_l2_where_it_bites": min(hit), "tol": HYBRID_LAYER_TOL,
              "rejected": rejected})
        check(rejected, f"the layer check passes a decode that {what}")


def hybrid_consistency(torch, device, cfg, params, tokens, decode_from, fault=None):
    """Prefill ``tokens[:decode_from]``, decode the rest one token at a time
    (teacher-forced), and compare with a prefill of all of them: the
    relative L2 error of the final hidden state and of the logits, and the
    largest over RG-LRU layers of the f32 state's after the last token and
    over local-attention layers of the ring's against the prefill's packed
    ring (each layer's too, in layer order).  ``fault`` as
    :func:`ring_fault` plants it in the decode.  Returns (errors, logits)."""
    from repro_torch.models import transformer as tf

    tokens = torch.as_tensor(tokens[None], device=device)
    with torch.inference_mode():
        logits, caches = tf.prefill(params, cfg, {"tokens": tokens[:, :decode_from]})
        caches = tf.pad_caches(cfg, caches, HYBRID_MAX_LEN)
        with ring_fault(fault):
            for pos in range(decode_from, tokens.shape[1]):
                logits, caches, hidden = tf.decode_step(params, cfg, caches, tokens[:, pos], pos,
                                                        return_hidden=True)
        want_logits, want_caches, want_hidden = tf.prefill(
            params, cfg, {"tokens": tokens}, return_hidden=True)
    layers = {"h": [], "ring": []}
    for kind, got, want in zip(tf.layer_kinds(cfg), caches, want_caches):
        if kind == "rec":
            layers["h"].append(rel_err(torch, got[1], want[1]))
        elif kind == "attn_local":
            layers["ring"].append(max(rel_err(torch, a, b) for a, b in zip(got, want)))
    errs = {"hidden": rel_err(torch, hidden, want_hidden),
            "logits": rel_err(torch, logits, want_logits),
            "h": max(layers["h"]), "ring": max(layers["ring"])}
    return errs, layers, logits


def phase_hybrid_serve(torch, device):
    """Serve recurrentgemma-2b at full width and all 26 layers: every
    local-attention prefill through the flash kernel with its window on the
    tensor cores, every local-attention decode through the paged kernel over
    a 2048-slot ring, every RG-LRU block in PyTorch; then decode against
    prefill across the wrap, with two planted ring faults."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.serve_loop import Request, ServeEngine

    cfg = ARCHS[HYBRID_ARCH]
    kinds = tf.layer_kinds(cfg)
    n_local = kinds.count("attn_local")
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    emit({"phase": "hybrid", "arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
          "rglru_layers": kinds.count("rec"), "local_attention_layers": n_local,
          "window": cfg.window, "init_seconds": time.perf_counter() - t0,
          "weight_bytes_on_device": torch.cuda.memory_allocated(device)})
    check(n_params == HYBRID_PARAMS, f"{n_params} parameters, not {HYBRID_PARAMS}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in HYBRID_PROMPT_LENS]
    last = {}

    def keep_last(req, logits, hidden):
        if req.rid == HYBRID_CHECK_RID:
            last["logits"] = logits.float().clone()

    engine = ServeEngine(cfg, params, max_len=HYBRID_MAX_LEN, batch_slots=SLOTS, device=device,
                         on_step=keep_last)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    t0 = time.perf_counter()
    results = engine.submit(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    steps = sum(len(r.out_tokens) - 1 for r in reqs)
    check(sorted(results) == list(range(len(reqs))), "a request did not finish")
    check(all(len(r.out_tokens) == MAX_NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in reqs),
          "a request's tokens are not MAX_NEW_TOKENS ids of the vocabulary")
    check(launches.get("flash_attention", 0) == launches.get("flash_attention_windowed", 0)
          == launches.get("flash_attention_tc", 0) == n_local * len(reqs),
          f"flash launches {launches.get('flash_attention')}, windowed "
          f"{launches.get('flash_attention_windowed')}, on the tensor cores "
          f"{launches.get('flash_attention_tc')}, not {n_local} x {len(reqs)}")
    check(launches.get("paged_attention", 0) == n_local * steps,
          f"paged launches {launches.get('paged_attention')} != {n_local} x {steps}")
    check(bool(torch.isfinite(last["logits"]).all()), "non-finite logits")

    # Decode against prefill across the wrap, then with each planted fault.
    req = reqs[HYBRID_CHECK_RID]
    tokens = np.concatenate([req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
    errs, layers, logits = hybrid_consistency(torch, device, cfg, params, tokens,
                                              len(req.prompt))
    emit({"phase": "hybrid", "consistency": HYBRID_CHECK_RID, "prompt_tokens": len(req.prompt),
          "tokens": len(tokens), "rel_l2": errs, "tol": HYBRID_TOL,
          "h_rel_l2_per_rglru_layer": layers["h"],
          "ring_rel_l2_per_local_layer": layers["ring"],
          "replay_equals_served_logits": torch.equal(logits[0].float(), last["logits"])})
    check(all(errs[key] <= HYBRID_TOL[key] for key in HYBRID_TOL),
          f"decode and prefill disagree across the wrap: {errs}")
    for fault, what in (("slot", "writes position pos at slot (pos + 1) % W"),
                        ("length", "attends to min(pos, W) slots")):
        bad, _, _ = hybrid_consistency(torch, device, cfg, params, tokens, len(req.prompt),
                                       fault)
        over = sorted(key for key in HYBRID_TOL if bad[key] > HYBRID_TOL[key])
        emit({"phase": "hybrid", "planted_fault": "consistency", "fault": what, "rel_l2": bad,
              "tol": HYBRID_TOL, "rejected_by": over, "rejected": bool(over)})
        check(fault != "slot" or "ring" in over,
              f"decode against prefill passes a ring that {what}")

    step_bound = weights_bound_ms(params)
    for r in reqs:
        n_dec = len(r.out_tokens) - 1
        emit({"phase": "hybrid", "request": r.rid, "prompt_tokens": len(r.prompt),
              "new_tokens": len(r.out_tokens), "prefill_seconds": r.prefill_seconds,
              "decode_seconds_per_token": r.decode_seconds / n_dec,
              "decode_step_bound_ms": step_bound,
              "tokens_per_second": len(r.out_tokens) / (r.prefill_seconds + r.decode_seconds)})
    emit({"phase": "hybrid", "requests": len(reqs), "new_tokens": steps + len(reqs),
          "decode_steps": steps, "wall_seconds": wall,
          "tokens_per_second": (steps + len(reqs)) / wall,
          "launches": launches, "peak_device_bytes": peak})
    return launches, params


@contextlib.contextmanager
def annotated(module, names):
    """Each of ``module``'s functions ``names`` wrapped in a profiler range
    of its own name while the context lasts."""
    from torch.profiler import record_function

    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def ranged(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return ranged

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _innermost(spans, items):
    """For each item ``(start, end, thread, key)`` the name of the
    innermost span ``(start, end, thread, name)`` on its thread that holds
    it, or None; the spans nest or are disjoint, as profiler ranges are."""
    found = {}
    for thread in {sp[2] for sp in spans}:
        marks = sorted([(lo, 0, -hi, hi, name) for lo, hi, th, name in spans if th == thread]
                       + [(lo, 1, 0, hi, key) for lo, hi, th, key in items if th == thread],
                       key=lambda mark: mark[:3])
        stack = []
        for lo, is_item, _, hi, what in marks:
            while stack and stack[-1][0] < lo:
                stack.pop()
            if not is_item:
                stack.append((hi, what))
            elif stack and stack[-1][0] >= hi:
                found[what] = stack[-1][1]
    return [found.get(key) for *_, key in items]


def ranged_kernels(torch, prof, names):
    """Device seconds and kernels launched inside each profiler range of
    ``names`` (innermost wins: the forward and, under remat, its recompute)
    and by the autograd nodes whose forward op ran inside it (matched by
    thread and sequence number: the backward pass), split into products
    and the rest."""
    events = [e for e in prof.events() if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end, e.thread, e.name) for e in events
             if e.name in names]
    ops = [e for e in events if e.sequence_nr >= 0 and e.name not in names
           and not e.name.startswith("autograd::")]
    owner = {(e.thread, e.sequence_nr): name for e, name in zip(ops, _innermost(
        spans, [(e.time_range.start, e.time_range.end, e.thread, i) for i, e in enumerate(ops)]))
        if name}
    spans += [(e.time_range.start, e.time_range.end, e.thread,
               owner[(e.fwd_thread, e.sequence_nr)])
              for e in events if e.name.startswith("autograd::engine::evaluate_function")
              and (e.fwd_thread, e.sequence_nr) in owner]
    launching = [e for e in events if e.kernels and e.name not in names]
    out = {f"{name}_{kind}": 0.0 for name in names for kind in ("matmul", "other", "kernels")}
    for e, name in zip(launching, _innermost(
            spans, [(e.time_range.start, e.time_range.end, e.thread, i)
                    for i, e in enumerate(launching)])):
        if name is None:
            continue
        for kernel in e.kernels:
            kind = "matmul" if any(w in kernel.name.lower() for w in MATMUL_NAMES) else "other"
            out[f"{name}_{kind}"] += kernel.duration / 1e6
            out[f"{name}_kernels"] += 1
    return out


def phase_hybrid_breakdown(torch, device, params):
    """Device time of a 4096-token prefill and of one decode step after it,
    each from its own profiler window: attention kernels, the RG-LRU's scan
    and its other elementwise work, products, and the rest, with the idle
    share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.models import rglru
    from repro_torch.models import transformer as tf

    cfg = ARCHS[HYBRID_ARCH]
    rng = np.random.default_rng(SEED + 11)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, max(HYBRID_PROMPT_LENS)),
                                          dtype=np.int32), device=device)
    state = {}

    def prefill():
        logits, caches = tf.prefill(params, cfg, {"tokens": prompt})
        state["caches"] = tf.pad_caches(cfg, caches, HYBRID_MAX_LEN)
        state["tok"] = logits.argmax(-1)

    def decode():
        logits, state["caches"] = tf.decode_step(params, cfg, state["caches"], state["tok"],
                                                 prompt.shape[1])
        state["tok"] = logits.argmax(-1)

    def timed(fn):
        with torch.inference_mode():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    ranges = ("associative_scan", "rglru_forward", "rglru_decode")
    for name, fn in (("prefill of 4096 tokens", prefill), ("one decode step after it", decode)):
        unprofiled = timed(fn)  # also the warm-up
        if fn is decode:
            timed(prefill)  # the same step again, from the prefill's caches
        with annotated(rglru, ranges):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profiled = timed(fn)
        kinds, events = device_seconds(torch, prof, ("flash_attention_kernel",
                                                     "paged_attention_kernel"),
                                       "attention_kernels")
        ranged = ranged_kernels(torch, prof, ranges)
        scan = ranged["associative_scan_other"]
        rec_other = ranged["rglru_forward_other"] + ranged["rglru_decode_other"]
        rec_products = sum(ranged[f"{r}_matmul"] for r in ranges)
        split = dict(kinds)
        if rec_other > 0:  # the profiler tied kernels to their ranges
            check(scan + rec_other <= kinds["other"] * (1 + 1e-6)
                  and rec_products <= kinds["matmul"] * (1 + 1e-6),
                  f"{name}: RG-LRU ranges {ranged} exceed the window's {kinds}")
            split = {"attention_kernels": kinds["attention_kernels"],
                     "rglru_scan": scan, "rglru_other_elementwise": rec_other,
                     "rglru_products": rec_products,
                     "other_products": kinds["matmul"] - rec_products,
                     "other": kinds["other"] - scan - rec_other}
        emit({"phase": "hybrid_breakdown", "arch": cfg.name, "window": name,
              "unprofiled_seconds": unprofiled, "profiled_seconds": profiled,
              "decode_step_bound_ms": weights_bound_ms(params),
              "rglru_split": "measured" if rec_other > 0 else "not measured",
              **busy_and_idle((split, events), profiled, unprofiled)})


# --------------------------------------------------------------------------
# Phases 5e and 5f: the flash kernel's prefix (keys every query sees), then
# paligemma-3b (prefix-LM VLM) and seamless-m4t-large-v2 (encoder-decoder)
# at full width through prefill and decode_step
# --------------------------------------------------------------------------


def prefix_flash(torch, q, k, v, prefix, path, **blocks):
    """The flash kernel at ``prefix`` through the model's entry point (or
    ``flash_attention`` at the ``bq``/``bk`` given); checks by the launch
    counters that the call took ``path`` and counted under
    ``flash_attention_prefix`` (and ``flash_attention_full`` when the prefix
    covers every key)."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import remop_flash_attention

    names = (f"flash_attention_{path}", "flash_attention_prefix", "flash_attention_full")
    before = [runtime.launches[n] for n in names]
    out = (fa.flash_attention(q, k, v, prefix=prefix, **blocks) if blocks
           else remop_flash_attention(q, k, v, prefix=prefix))
    want = [before[0] + 1, before[1] + bool(prefix), before[2] + (prefix >= k.shape[2])]
    check([runtime.launches[n] for n in names] == want,
          f"flash {tuple(q.shape)} over {k.shape[2]} keys, {q.dtype}, prefix {prefix}: not "
          f"the {path} route, or not counted")
    return out


def planted_prefix(torch, device, gen, s, hd, p, dtype):
    """paligemma's prefill shape (8 query heads on one KV head) over ``s``
    positions, prefix ``p``, with keys planted on both sides of its edge.
    The key at P - 1 (60 e_0, value 4 in every column) decides the rows
    ``through`` (all before P - 1, query 8 e_0 in every head: a score of 30
    where the random keys score about N(0, 1/4)), which see it only through
    the prefix; the key at P (60 e_1, value -4) decides the rows of query
    8 e_1 that see it: those ``after`` P, not those ``before`` it.  Returns
    (q, k, v, through, before, after)."""
    q = torch.randn(1, 8, s, hd, device=device, generator=gen)
    k = torch.randn(1, 1, s, hd, device=device, generator=gen)
    v = torch.randn(1, 1, s, hd, device=device, generator=gen)
    rows = list(range(1, p - 1, max(1, (p - 2) // 12)))
    through, before = rows[0::2], rows[1::2]
    after = list(range(p, s, max(1, (s - p) // 6)))
    for r in rows + after:
        q[0, :, r] = 0.0
        q[0, :, r, 0 if r in through else 1] = 8.0
    for key, axis, value in ((p - 1, 0, 4.0), (p, 1, -4.0)):
        k[0, 0, key] = 0.0
        k[0, 0, key, axis] = 60.0
        v[0, 0, key] = value
    return (*(x.to(dtype) for x in (q, k, v)), through, before, after)


def phase_vlm_kernels(torch, device):
    """The flash kernel's prefix on both routes against its plain version at
    paligemma's prefill shape (PREFIX_CHECKS); keys planted at P - 1 and P,
    both classes shown to decide their rows, and prefix P - 1 and P + 1
    rejected on both routes; prefix 0 bit for bit the causal call; then
    timed beside its bound and SDPA with the prefix mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import plan_blocks

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    errs, rows = {}, {}
    name, hd = "flash_attention_prefix", 256

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=device, generator=gen).to(dtype)

    # -- the prefix on both routes -------------------------------------------------------
    for p, text in PREFIX_CHECKS:
        s = p + text
        for dtype, path in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
            q, k, v = randn(1, 8, s, hd, dtype=dtype), *(randn(1, 1, s, hd, dtype=dtype)
                                                         for _ in range(2))
            bq, bk = plan_blocks(s, s, hd, q.element_size(), path=path)
            got = prefix_flash(torch, q, k, v, p, path)
            err, rel = allclose(torch, [name], got,
                                fa.flash_attention_plain(q, k, v, bk, prefix=p), errs)
            emit({"phase": "vlm", "check": name, "shape": [1, 8, 1, s, s, hd], "prefix": p,
                  "dtype": str(dtype), "route": path, "blocks": [bq, bk],
                  "tol": ATTN_TOL[str(dtype)], "max_abs_err": err, "rel_err": rel})
    # -- keys planted at P - 1 and P; the prefix's edge one key off ----------------------
    for p, text in PREFIX_EDGE_CHECKS:
        s = p + text
        for dtype, path in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
            q, k, v, through, before, after = planted_prefix(torch, device, gen, s, hd, p, dtype)
            bq, bk = plan_blocks(s, s, hd, q.element_size(), path=path)
            want = fa.flash_attention_plain(q, k, v, bk, prefix=p)

            def dist(rows, value):  # [heads, rows]: each row's largest distance from value
                return (want[0, :, rows].float() - value).abs().amax(dim=-1)

            emit({"phase": "vlm", "edge_classes": str(dtype), "prefix": p, "seq": s,
                  "rows_through_prefix": through, "rows_before_p": before,
                  "rows_after_p": after,
                  "max_distance_from_key_p_minus_1_value_through": float(dist(through, 4.0).max()),
                  "min_distance_from_key_p_value_before": float(dist(before, -4.0).min()),
                  "max_distance_from_key_p_value_after": float(dist(after, -4.0).max())})
            check(min(len(through), len(before), len(after)) >= 4
                  and float(dist(through, 4.0).max()) < 0.1
                  and float(dist(before, -4.0).min()) > 1.0
                  and float(dist(after, -4.0).max()) < 0.1,
                  "the planted keys do not decide their rows: the data does not exercise the "
                  "prefix's edge")
            allclose(torch, [name], prefix_flash(torch, q, k, v, p, path), want, errs)
            for wrong, what in ((p - 1, "hides the key at P - 1 from the rows before it"),
                                (p + 1, "shows the key at P to the rows before it")):
                reject_fault(torch, name, f"{what} ({path}, prefix {wrong} for {p})",
                             prefix_flash(torch, q, k, v, wrong, path), want)
    # -- prefix 0 launches what it launched: bit for bit the causal call, and a
    # prefix of 1 (key 0, which every row sees anyway) -------------------------------------
    for shape, dtype, path in (((1, 8, 2048), torch.bfloat16, "tc"),
                               ((1, 8, 456), torch.float32, "simt")):
        b, h, s = shape
        q, k, v = randn(b, h, s, hd, dtype=dtype), *(randn(b, 1, s, hd, dtype=dtype)
                                                     for _ in range(2))
        causal = fa.flash_attention(q, k, v, *plan_blocks(s, s, hd, q.element_size(), path=path))
        same = [torch.equal(causal, prefix_flash(torch, q, k, v, p, path)) for p in (0, 1)]
        emit({"phase": "vlm", "check": "flash_attention prefix 0", "shape": [b, h, 1, s, s, hd],
              "dtype": str(dtype), "route": path,
              "equal_bits_to_causal": same[0], "equal_bits_prefix_1_to_causal": same[1]})
        check(all(same), f"prefix 0 or 1 differs from the causal call at {shape} {dtype}")
    torch.cuda.synchronize()

    # -- timing: paligemma's prefill of 256 patches and 512 text tokens ----------------------
    bench = Bench(torch, device)
    p, s = 256, 768
    q, k, v = randn(1, 8, s, hd), randn(1, 1, s, hd), randn(1, 1, s, hd)
    bq, bk = plan_blocks(s, s, hd, 2)
    pos = torch.arange(s, device=device)
    mask = (pos[:, None] >= pos[None, :]) | (pos[None, :] < p)
    ms_bound, by = bound(*flash_cost(1, 8, 1, s, s, hd, 2, prefix=p), BF16_OPS_PER_S)

    def kernel(prefix=p):
        return fa.flash_attention(q, k, v, bq=bq, bk=bk, prefix=prefix)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    rows[name] = dict(
        shape=f"q [1,8,{s},{hd}], k/v [1,1,{s},{hd}] bf16, prefix {p}, blocks {(bq, bk)}",
        ms=bench.ms(kernel),
        plain_ms=bench.ms(lambda: fa.flash_attention_plain(q, k, v, bk, prefix=p)),
        library_ms=bench.ms(sdpa),
        bound_ms=ms_bound, bound_by=by,
        **bench.device_ms(kernel),
        **{f"library_{key}": val for key, val in bench.device_ms(sdpa).items()},
        causal_device_ms=bench.device_ms(lambda: kernel(0))["device_ms"],
        causal_bound_ms=bound(*flash_cost(1, 8, 1, s, s, hd, 2), BF16_OPS_PER_S)[0])
    for key, row in rows.items():
        emit({"phase": "vlm", "timing": key, **row})
    del bench
    return errs, rows


@contextlib.contextmanager
def plain_attention():
    """The model's attention entry points (``models.attention``'s
    ``remop_flash_attention``, ``remop_paged_attention`` and
    ``remop_paged_attention_int8``) on the kernels' plain versions while the
    context lasts, CUDA tensors included: the layer checks' reference path."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention_int8_plain, paged_attention_plain)
    from repro_torch.models import attention as attn

    saved = (attn.remop_flash_attention, attn.remop_paged_attention,
             attn.remop_paged_attention_int8)
    attn.remop_flash_attention = (
        lambda q, k, v, window=0, prefix=0, softcap=0.0: flash_attention_plain(
            q, k, v, window=window, prefix=prefix, softcap=softcap))
    attn.remop_paged_attention = lambda q, kc, vc, lengths, softcap=0.0: paged_attention_plain(
        q, kc, vc, lengths.int(), softcap=softcap)
    attn.remop_paged_attention_int8 = (
        lambda q, kq, vq, ks, vs, lengths, softcap=0.0: paged_attention_int8_plain(
            q, kq, vq, ks, vs, lengths.int(), softcap=softcap))
    try:
        yield
    finally:
        (attn.remop_flash_attention, attn.remop_paged_attention,
         attn.remop_paged_attention_int8) = saved


@contextlib.contextmanager
def flash_prefix_fault(rule):
    """The model's flash entry with ``prefix`` replaced by ``rule(q, k,
    prefix)`` while the context lasts: a planted mask fault."""
    from repro_torch.models import attention as attn

    saved = attn.remop_flash_attention

    def faulty(q, k, v, window=0, prefix=0, softcap=0.0):
        return saved(q, k, v, window=window, prefix=rule(q, k, prefix), softcap=softcap)

    attn.remop_flash_attention = faulty
    try:
        yield
    finally:
        attn.remop_flash_attention = saved


def row_errors(torch, got, want, rows):
    """Relative L2 error of each of ``rows`` of [1, S, d] outputs."""
    return [rel_err(torch, got[0, r], want[0, r]) for r in rows]


def vlm_layer_errors(torch, device, cfg, fault: bool = False):
    """One paligemma attention layer at ``cfg``'s widths over the patches
    and VLM_LAYER_TEXT text rows: per row of VLM_LAYER_ROWS, the relative
    L2 error of the kernel path against the plain path; per position of
    VLM_LAYER_DECODE, of the paged decode (its cache the forward's rows
    before the position) against the kernel forward's row.  ``fault`` runs
    the kernel path without the prefix (the causal mask only)."""
    import torch.nn.functional as F
    from repro_torch.models import attention as attn

    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    p = attn.init_gqa(cfg, gen, device)
    prefix, s = cfg.frontend_seq, cfg.frontend_seq + VLM_LAYER_TEXT
    x = torch.randn(1, s, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    positions = torch.arange(s, dtype=torch.int32, device=device)[None]
    with torch.inference_mode():
        with flash_prefix_fault(lambda q, k, pre: 0 if fault else pre):
            got, (k, v) = attn.gqa_forward(p, cfg, x, positions, prefix=prefix, return_kv=True)
        with plain_attention():
            want = attn.gqa_forward(p, cfg, x, positions, prefix=prefix)
        decode = []
        for pos in VLM_LAYER_DECODE:
            cache = tuple(F.pad(a[:, :pos], (0, 0, 0, 0, 0, s - pos)) for a in (k, v))
            out, _ = attn.gqa_decode(p, cfg, x[:, pos:pos + 1], cache, pos)
            decode.append(rel_err(torch, out[0, 0], got[0, pos]))
    return row_errors(torch, got, want, VLM_LAYER_ROWS), decode


def phase_vlm_layer(torch, device):
    """One paligemma attention layer at full width: the flash kernel at
    prefix 256 against the plain path row by row, the paged decode against
    the forward's rows; a kernel path without the prefix must fail every
    checked row before P / 2."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[VLM_ARCH]
    rows, decode = vlm_layer_errors(torch, device, cfg)
    emit({"phase": "vlm", "layer_check": "flash at prefix P against the plain path; paged "
          "decode against the forward", "prefix": cfg.frontend_seq, "text": VLM_LAYER_TEXT,
          "rows": list(VLM_LAYER_ROWS), "rel_l2": rows, "decode_positions": list(VLM_LAYER_DECODE),
          "decode_rel_l2": decode, "max_rel_l2": max(rows + decode), "tol": VLM_LAYER_TOL})
    check(max(rows + decode) <= VLM_LAYER_TOL, f"the VLM layer's kernel path differs: {rows}, "
          f"{decode}")
    bad, _ = vlm_layer_errors(torch, device, cfg, fault=True)
    hit = [e for r, e in zip(VLM_LAYER_ROWS, bad) if r < cfg.frontend_seq // 2]
    rejected = all(e > VLM_LAYER_TOL for e in hit)
    emit({"phase": "vlm", "planted_fault": "layer", "fault": "drops the prefix (causal mask only)",
          "rel_l2": bad, "min_rel_l2_where_it_bites": min(hit), "tol": VLM_LAYER_TOL,
          "rejected": rejected})
    check(rejected, "the layer check passes a VLM layer without its prefix")


@contextlib.contextmanager
def kernel_calls(log):
    """Each call the model makes to its attention entry points while the
    context lasts, appended to ``log`` as (kernel, role, S, T, prefix, the
    launches the wrapper counted): ``"flash"`` for ``remop_flash_attention``
    (prefix its argument), ``"paged"`` for ``remop_paged_attention`` (S 1,
    T the cache's positions, prefix None); role ``"cross"`` inside a
    cross-attention ``gqa_forward`` or ``cross_decode``, else ``"self"``."""
    from repro_torch.kernels import runtime
    from repro_torch.models import attention as attn

    names = ("gqa_forward", "cross_decode", "remop_flash_attention", "remop_paged_attention")
    saved = {n: getattr(attn, n) for n in names}
    role = ["self"]

    def tagged(fn, is_cross):
        def call(*args, **kwargs):
            cross = is_cross(kwargs)
            role.append("cross" if cross else role[-1])
            try:
                return fn(*args, **kwargs)
            finally:
                role.pop()
        return call

    def recorded(fn, kernel, counter):
        def call(q, k, *args, **kwargs):
            before = runtime.launches[counter]
            out = fn(q, k, *args, **kwargs)
            s, t = (q.shape[2], k.shape[2]) if kernel == "flash" else (1, k.shape[1])
            log.append((kernel, role[-1], s, t, kwargs.get("prefix", 0) if kernel == "flash"
                        else None, runtime.launches[counter] - before))
            return out
        return call

    attn.gqa_forward = tagged(saved["gqa_forward"], lambda kw: kw.get("xa") is not None)
    attn.cross_decode = tagged(saved["cross_decode"], lambda kw: True)
    attn.remop_flash_attention = recorded(saved["remop_flash_attention"], "flash",
                                          "flash_attention")
    attn.remop_paged_attention = recorded(saved["remop_paged_attention"], "paged",
                                          "paged_attention")
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(attn, n, fn)


def serve_greedy(torch, device, cfg, params, batches, starts, max_len):
    """Each request alone at batch 1, as ServeEngine serves a slot:
    ``prefill``, ``pad_caches`` to ``max_len``, then MAX_NEW_TOKENS - 1
    greedy ``decode_step`` calls from position ``starts[i]`` (each step
    ends in its argmax read back).  Per request: its tokens, host seconds
    of the prefill and of the decode steps, and the last step's logits and
    final hidden state."""
    from repro_torch.models import transformer as tf

    served = []
    with torch.inference_mode():
        for batch, start in zip(batches, starts):
            t0 = time.perf_counter()
            logits, caches = tf.prefill(params, cfg, batch)
            caches = tf.pad_caches(cfg, caches, max_len)
            tokens = [int(logits[0].argmax())]
            t1 = time.perf_counter()
            for pos in range(start, start + MAX_NEW_TOKENS - 1):
                token = torch.tensor([tokens[-1]], device=device)
                logits, caches, hidden = tf.decode_step(params, cfg, caches, token, pos,
                                                        return_hidden=True)
                tokens.append(int(logits[0].argmax()))
            served.append({"tokens": tokens, "prefill_seconds": t1 - t0,
                           "decode_seconds": time.perf_counter() - t1,
                           "logits": logits[0].float(), "hidden": hidden[0].float()})
            del caches
    return served


def replay_errors(torch, device, cfg, params, batch, served):
    """The served request's last decode step against a prefill of its
    prompt and every token it decoded from: relative L2 error of the final
    hidden state and of the logits."""
    from repro_torch.models import transformer as tf

    tokens = torch.cat([batch["tokens"], torch.tensor([served["tokens"][:-1]],
                                                      dtype=batch["tokens"].dtype, device=device)],
                       dim=1)
    with torch.inference_mode():
        logits, _, hidden = tf.prefill(params, cfg, dict(batch, tokens=tokens), return_hidden=True)
    return {"hidden": rel_err(torch, served["hidden"], hidden[0]),
            "logits": rel_err(torch, served["logits"], logits[0])}


def decode_bound_ms(params) -> float:
    """:func:`weights_bound_ms` of the parameters a decode step reads: the
    decoder layers, the tied embedding (its unembedding) and the final norm;
    no frontend, no encoder."""
    return weights_bound_ms({key: params[key] for key in ("embed", "final_norm", "layers")})


def family_breakdown(torch, device, cfg, params, batch, start, max_len, phase):
    """Device time of one prefill and of 8 decode steps after it, each from
    its own profiler window after an unprofiled warm-up: attention kernels,
    products and the rest, with the idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf

    state = {}

    def prefill():
        logits, caches = tf.prefill(params, cfg, batch)
        state["caches"] = tf.pad_caches(cfg, caches, max_len)
        state["tok"] = logits.argmax(-1)

    def decode():
        for pos in range(start, start + 8):
            logits, state["caches"] = tf.decode_step(params, cfg, state["caches"], state["tok"],
                                                     pos)
            state["tok"] = logits.argmax(-1)

    def timed(fn):
        with torch.inference_mode():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    for name, fn in (("one prefill", prefill), ("8 decode steps after it", decode)):
        unprofiled = timed(fn)  # also the warm-up
        if fn is decode:
            timed(prefill)  # the same steps again, from the prefill's caches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = timed(fn)
        kinds = device_seconds(torch, prof, ("flash_attention_kernel", "paged_attention_kernel"),
                               "attention_kernels")
        emit({"phase": f"{phase}_breakdown", "arch": cfg.name, "window": name,
              "tokens": batch["tokens"].shape[1], "unprofiled_seconds": unprofiled,
              "profiled_seconds": profiled, **busy_and_idle(kinds, profiled, unprofiled)})
    del state


def phase_vlm_serve(torch, device):
    """paligemma-3b at full width and all 18 layers: 4 requests of 256
    patches and VLM_TEXT_LENS text tokens, 32 greedy tokens each; every
    prefill layer through the flash kernel at prefix 256 on the tensor
    cores, every decode layer through the paged kernel; every request's
    last step against a prefill replay."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tf

    cfg = ARCHS[VLM_ARCH]
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    emit({"phase": "vlm", "arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
          "patches": cfg.frontend_seq, "patch_width": cfg.frontend_dim,
          "init_seconds": time.perf_counter() - t0,
          "weight_bytes_on_device": torch.cuda.memory_allocated(device)})
    check(n_params == VLM_PARAMS, f"{n_params} parameters, not {VLM_PARAMS}")
    rng = np.random.default_rng(SEED + 21)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n), dtype=np.int32),
                                          device=device),
                "patches": torch.randn(1, cfg.frontend_seq, cfg.frontend_dim, device=device,
                                       generator=gen)} for n in VLM_TEXT_LENS]
    starts = [cfg.frontend_seq + n for n in VLM_TEXT_LENS]
    log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    t0 = time.perf_counter()
    with kernel_calls(log):
        served = serve_greedy(torch, device, cfg, params, batches, starts, VLM_MAX_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    n_req, steps = len(batches), len(batches) * (MAX_NEW_TOKENS - 1)
    check(all(len(r["tokens"]) == MAX_NEW_TOKENS and all(0 <= t < cfg.vocab_size
                                                         for t in r["tokens"]) for r in served),
          "a request's tokens are not MAX_NEW_TOKENS ids of the vocabulary")
    check(all(bool(torch.isfinite(r["logits"]).all()) for r in served), "non-finite logits")
    flash = cfg.n_layers * n_req
    check(launches.get("flash_attention", 0) == launches.get("flash_attention_tc", 0)
          == launches.get("flash_attention_prefix", 0) == flash
          and not launches.get("flash_attention_full"),
          f"flash launches {launches.get('flash_attention')}, on the tensor cores "
          f"{launches.get('flash_attention_tc')}, with a prefix "
          f"{launches.get('flash_attention_prefix')}, over every key "
          f"{launches.get('flash_attention_full')}: not {cfg.n_layers} x {n_req} with a prefix")
    want = sorted([("flash", "self", t, t, cfg.frontend_seq, 1) for t in starts] * cfg.n_layers)
    check(sorted(e for e in log if e[0] == "flash") == want,
          "a prefill layer did not reach the flash kernel once over patches and text at prefix P")
    check(launches.get("paged_attention", 0) == cfg.n_layers * steps,
          f"paged launches {launches.get('paged_attention')} != {cfg.n_layers} x {steps}")

    step_bound = decode_bound_ms(params)
    replays = []
    for i, (batch, r) in enumerate(zip(batches, served)):
        errs = replay_errors(torch, device, cfg, params, batch, r)
        replays.append(errs)
        cache_bytes = cfg.n_layers * 2 * (starts[i] + MAX_NEW_TOKENS) * cfg.n_kv_heads \
            * cfg.head_dim * 2
        emit({"phase": "vlm", "request": i, "patches": cfg.frontend_seq,
              "text_tokens": VLM_TEXT_LENS[i], "new_tokens": len(r["tokens"]),
              "prefill_seconds": r["prefill_seconds"],
              "decode_seconds_per_token": r["decode_seconds"] / (MAX_NEW_TOKENS - 1),
              "decode_step_bound_ms": step_bound,
              "decode_step_bound_with_caches_ms": step_bound + cache_bytes / HBM_BYTES_PER_S * 1e3,
              "tokens_per_second": len(r["tokens"]) / (r["prefill_seconds"] + r["decode_seconds"]),
              "consistency": errs, "tol": VLM_TOL})
    check(all(e[key] <= VLM_TOL[key] for e in replays for key in VLM_TOL),
          f"decode and its prefill replay disagree: {replays}")
    emit({"phase": "vlm", "requests": n_req, "new_tokens": steps + n_req, "decode_steps": steps,
          "wall_seconds": wall, "tokens_per_second": (steps + n_req) / wall,
          "launches": launches, "peak_device_bytes": peak})
    family_breakdown(torch, device, cfg, params, batches[-1], starts[-1], VLM_MAX_LEN, "vlm")
    return launches


def phase_encdec_kernels(torch, device):
    """The flash kernel over every key (bidirectional at seamless's encoder
    shape, cross-attention from decoder rows onto encoder rows, S > T
    included) on both routes against its plain version; a kernel without
    the ``k >= T`` mask rejected where T is no multiple of the block; the
    paged kernel over the cross cache at G 1, hd 64; then both timed beside
    their bounds and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import plan_blocks
    from repro_torch.kernels.paged_attention import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(19)
    errs, rows = {}, {}
    name, h, hd = "flash_attention_full", 16, 64

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=device, generator=gen).to(dtype)

    def full_check(what, s, t, dtype, path, fault=False):
        q, k, v = randn(1, h, s, hd, dtype=dtype), *(randn(1, h, t, hd, dtype=dtype)
                                                     for _ in range(2))
        bq, bk = plan_blocks(s, t, hd, q.element_size(), path=path)
        want = fa.flash_attention_plain(q, k, v, bk, prefix=t)
        err, rel = allclose(torch, [name], prefix_flash(torch, q, k, v, t, path), want, errs)
        emit({"phase": "encdec", "check": name, "what": what, "shape": [1, h, h, s, t, hd],
              "prefix": t, "dtype": str(dtype), "route": path, "blocks": [bq, bk],
              "tol": ATTN_TOL[str(dtype)], "max_abs_err": err, "rel_err": rel})
        pad = -t % bk
        if fault and pad:
            # A kernel without the k >= T mask scores the block's rows past T,
            # which TMA fills with zeros, as keys of score 0 and value 0: the
            # kernel on K/V padded with zeros to whole blocks, every key seen.
            planted.append((what, t, bk))
            k_pad, v_pad = (F.pad(x, (0, 0, 0, pad)) for x in (k, v))
            reject_fault(torch, name, f"drops the k >= T mask ({what}, T {t}, bk {bk}: "
                                      f"{pad} zero keys scored)",
                         prefix_flash(torch, q, k_pad, v_pad, t + pad, path, bq=bq, bk=bk),
                         want)

    # -- bidirectional (S = T, prefix T) and cross-attention (prefix T_enc); the
    # dropped k >= T mask planted where T is no multiple of the block -----------------------
    planted = []
    for t in BIDIR_CHECKS:
        for dtype, path in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
            full_check("bidirectional", t, t, dtype, path, fault=path == "tc")
    for s, t in CROSS_CHECKS:
        full_check("cross", s, t, torch.bfloat16, "tc", fault=(s, t) == CROSS_FAULT)
    for s, t in CROSS_SIMT_CHECKS:
        full_check("cross", s, t, torch.float32, "simt")
    check(len(planted) >= 2 and {what for what, _, _ in planted} == {"bidirectional", "cross"},
          f"the dropped k >= T mask was planted at {planted}, not at a bidirectional and a "
          "cross shape whose T is no multiple of the block")
    # -- the paged kernel over the cross cache: G 1, hd 64, 16 KV heads --------------------
    for t in CROSS_DECODE_LENGTHS:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(1, h, 1, hd, dtype=dtype)
            kc, vc = (randn(1, t, h, hd, dtype=dtype) for _ in range(2))
            ln = torch.full((1,), t, dtype=torch.int32, device=device)
            err, rel = allclose(torch, ["paged_attention_cross"], pa.paged_attention(q, kc, vc, ln),
                                pa.paged_attention_plain(q, kc, vc, ln), errs)
            emit({"phase": "encdec", "check": "paged_attention_cross", "shape": [1, h, 1, hd, t],
                  "lengths": [t], "dtype": str(dtype), "plan": pa.plan(1, h, 1, t),
                  "tol": ATTN_TOL[str(dtype)], "max_abs_err": err, "rel_err": rel})
    torch.cuda.synchronize()

    # -- timing: the 4096-frame encoder's attention, and a cross decode step over
    # 4096 frames ----------------------------------------------------------------------------
    bench = Bench(torch, device)
    t = ENCDEC_FRAMES[0]
    q, k, v = (randn(1, h, t, hd) for _ in range(3))
    bq, bk = plan_blocks(t, t, hd, 2)
    ms_bound, by = bound(*flash_cost(1, h, h, t, t, hd, 2, prefix=t), BF16_OPS_PER_S)

    def kernel():
        return fa.flash_attention(q, k, v, bq=bq, bk=bk, prefix=t)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=False)

    rows[name] = dict(
        shape=f"q/k/v [1,{h},{t},{hd}] bf16, every key (prefix {t}), blocks {(bq, bk)}",
        ms=bench.ms(kernel),
        plain_ms=bench.ms(lambda: fa.flash_attention_plain(q, k, v, bk, prefix=t)),
        library_ms=bench.ms(sdpa),
        bound_ms=ms_bound, bound_by=by,
        **bench.device_ms(kernel),
        **{f"library_{key}": val for key, val in bench.device_ms(sdpa).items()},
        causal_device_ms=bench.device_ms(
            lambda: fa.flash_attention(q, k, v, bq=bq, bk=bk))["device_ms"])
    s = 64
    xq = randn(1, h, s, hd)
    xb = plan_blocks(s, t, hd, 2)
    emit({"phase": "encdec", "timing": "flash_attention cross prefill",
          "shape": f"q [1,{h},{s},{hd}], k/v [1,{h},{t},{hd}] bf16, every key, blocks {xb}",
          "bound_ms": bound(*flash_cost(1, h, h, s, t, hd, 2, prefix=t), BF16_OPS_PER_S)[0],
          **bench.device_ms(lambda: fa.flash_attention(xq, k, v, *xb, prefix=t)),
          **{f"library_{key}": val for key, val in bench.device_ms(
              lambda: F.scaled_dot_product_attention(xq, k, v)).items()}})
    q = randn(1, h, 1, hd)
    kc, vc = (randn(1, t, h, hd) for _ in range(2))
    ln = torch.full((1,), t, dtype=torch.int32, device=device)
    ms_bound, by = bound((2 * t * h * hd + 2 * h * hd) * 2, 4 * hd * t * h, BF16_OPS_PER_S)

    def cross_kernel():
        return pa.paged_attention(q, kc, vc, ln)

    def cross_sdpa():
        return F.scaled_dot_product_attention(q.reshape(1, h, 1, hd), kc.transpose(1, 2),
                                              vc.transpose(1, 2))

    rows["paged_attention_cross"] = dict(
        shape=f"q [1,{h},1,{hd}], cross cache [1,{t},{h},{hd}] bf16, length {t}, "
              f"plan {pa.plan(1, h, 1, t)}",
        ms=bench.ms(cross_kernel),
        plain_ms=bench.ms(lambda: pa.paged_attention_plain(q, kc, vc, ln)),
        library_ms=bench.ms(cross_sdpa),
        bound_ms=ms_bound, bound_by=by,
        **bench.device_ms(cross_kernel),
        **{f"library_{key}": val for key, val in bench.device_ms(cross_sdpa).items()})
    for key, row in rows.items():
        emit({"phase": "encdec", "timing": key, **row})
    del bench
    return errs, rows


def roped_cross_decode(torch, p, cfg, x, cache, pos):
    """A planted fault: ``cross_decode`` with q roped at the step's position
    (as self-attention's is; cross-attention's is not)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_rope, dense, rope_tables

    b, h, kv, hd = x.shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(dense(p["wq"], x).view(b, 1, h, hd), cos, sin).view(b, kv, h // kv, hd)
    ck, cv = cache
    lengths = torch.full((b,), ck.shape[1], dtype=torch.int32, device=x.device)
    return dense(p["wo"], attn.remop_paged_attention(q, ck, cv, lengths).view(b, 1, h * hd))


def encdec_layer_errors(torch, device, cfg, fault=None):
    """One encoder layer's attention over ENCDEC_LAYER_FRAMES frames and one
    decoder layer's cross-attention from ENCDEC_LAYER_SEQ rows over as many
    encoder rows (drawn apart: an attention output's rows, each a softmax
    average of the same values, barely differ), at ``cfg``'s widths: the
    relative L2 error of the kernel path against the plain path at each row
    of ENCDEC_LAYER_ROWS (encoder) and of ENCDEC_LAYER_POSITIONS (cross
    forward), and of ``cross_decode`` at each position against the kernel
    forward's row.  ``fault``:
    ``"causal"`` runs the encoder's kernel path causally, ``"roped"``
    ropes the cross decode's q."""
    from repro_torch.models import attention as attn

    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    enc, xattn = attn.init_gqa(cfg, gen, device), attn.init_gqa(cfg, gen, device)
    t, s = ENCDEC_LAYER_FRAMES, ENCDEC_LAYER_SEQ
    h, enc_out = (torch.randn(1, t, cfg.d_model, device=device, generator=gen)
                  .to(torch.bfloat16) for _ in range(2))
    x = torch.randn(1, s, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    enc_pos = torch.arange(t, dtype=torch.int32, device=device)[None]
    dec_pos = torch.arange(s, dtype=torch.int32, device=device)[None]
    with torch.inference_mode():
        with flash_prefix_fault(lambda q, k, pre: 0 if fault == "causal" else pre):
            enc_got = attn.gqa_forward(enc, cfg, h, enc_pos, prefix=t)
        with plain_attention():
            enc_want = attn.gqa_forward(enc, cfg, h, enc_pos, prefix=t)
            x_want = attn.gqa_forward(xattn, cfg, x, dec_pos, xa=enc_out)
        x_got, kv = attn.gqa_forward(xattn, cfg, x, dec_pos, xa=enc_out, return_kv=True)
        decode = []
        for pos in ENCDEC_LAYER_POSITIONS:
            row = x[:, pos:pos + 1]
            out = (roped_cross_decode(torch, xattn, cfg, row, kv, pos) if fault == "roped"
                   else attn.cross_decode(xattn, cfg, row, kv))
            decode.append(rel_err(torch, out[0, 0], x_got[0, pos]))
    return (row_errors(torch, enc_got, enc_want, ENCDEC_LAYER_ROWS),
            row_errors(torch, x_got, x_want, ENCDEC_LAYER_POSITIONS), decode)


def phase_encdec_layer(torch, device):
    """One seamless encoder layer and one decoder layer's cross-attention at
    full width: the flash kernel over every key against the plain path row
    by row, the paged cross decode against the forward's rows; a causal
    encoder must fail every checked row before T / 2, a roped cross decode
    every position past 0."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[ENCDEC_ARCH]
    enc, cross, decode = encdec_layer_errors(torch, device, cfg)
    worst = max(enc + cross + decode)
    emit({"phase": "encdec", "layer_check": "bidirectional encoder and cross-attention "
          "against the plain path; cross decode against the forward",
          "frames": ENCDEC_LAYER_FRAMES, "seq": ENCDEC_LAYER_SEQ,
          "encoder_rows": list(ENCDEC_LAYER_ROWS), "encoder_rel_l2": enc,
          "cross_positions": list(ENCDEC_LAYER_POSITIONS), "cross_rel_l2": cross,
          "cross_decode_rel_l2": decode, "max_rel_l2": worst, "tol": ENCDEC_LAYER_TOL})
    check(worst <= ENCDEC_LAYER_TOL, f"the encoder-decoder layer's kernel path differs: "
          f"{enc}, {cross}, {decode}")
    for fault, what in (("causal", "runs the encoder causally"),
                        ("roped", "ropes the cross decode's q at the step's position")):
        enc, _, decode = encdec_layer_errors(torch, device, cfg, fault)
        if fault == "causal":
            bad = enc
            hit = [e for r, e in zip(ENCDEC_LAYER_ROWS, enc) if r < ENCDEC_LAYER_FRAMES // 2]
        else:
            bad = decode
            hit = [e for pos, e in zip(ENCDEC_LAYER_POSITIONS, decode) if pos > 0]
        rejected = all(e > ENCDEC_LAYER_TOL for e in hit)
        emit({"phase": "encdec", "planted_fault": "layer", "fault": what, "rel_l2": bad,
              "min_rel_l2_where_it_bites": min(hit), "tol": ENCDEC_LAYER_TOL,
              "rejected": rejected})
        check(rejected, f"the layer check passes a layer that {what}")


def phase_encdec_serve(torch, device):
    """seamless-m4t-large-v2 at full width, all 24 encoder and 24 decoder
    layers: 4 requests of ENCDEC_FRAMES frames and ENCDEC_PROMPT_LENS tokens,
    32 greedy tokens each; every encoder layer through the flash kernel over
    every key, every decoder layer through it causally and over the encoder's
    rows, every decode layer through the paged kernel twice (self, cross);
    every request's last step against a prefill replay."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tf

    cfg = ARCHS[ENCDEC_ARCH]
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    emit({"phase": "encdec", "arch": cfg.name, "params": n_params,
          "encoder_layers": cfg.n_encoder_layers, "decoder_layers": cfg.n_layers,
          "init_seconds": time.perf_counter() - t0,
          "weight_bytes_on_device": torch.cuda.memory_allocated(device)})
    check(n_params == ENCDEC_PARAMS, f"{n_params} parameters, not {ENCDEC_PARAMS}")
    rng = np.random.default_rng(SEED + 31)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n), dtype=np.int32),
                                          device=device),
                "frames": torch.randn(1, t, cfg.frontend_dim, device=device, generator=gen)}
               for t, n in zip(ENCDEC_FRAMES, ENCDEC_PROMPT_LENS)]
    log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runtime.reset_launches()
    t0 = time.perf_counter()
    with kernel_calls(log):
        served = serve_greedy(torch, device, cfg, params, batches, ENCDEC_PROMPT_LENS,
                              ENCDEC_MAX_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated(device)

    n_req, steps = len(batches), len(batches) * (MAX_NEW_TOKENS - 1)
    check(all(len(r["tokens"]) == MAX_NEW_TOKENS and all(0 <= t < cfg.vocab_size
                                                         for t in r["tokens"]) for r in served),
          "a request's tokens are not MAX_NEW_TOKENS ids of the vocabulary")
    check(all(bool(torch.isfinite(r["logits"]).all()) for r in served), "non-finite logits")
    layers = cfg.n_layers
    check(launches.get("flash_attention", 0) == launches.get("flash_attention_tc", 0)
          == 3 * layers * n_req
          and launches.get("flash_attention_full", 0) == launches.get("flash_attention_prefix", 0)
          == 2 * layers * n_req,
          f"flash launches {launches.get('flash_attention')}, on the tensor cores "
          f"{launches.get('flash_attention_tc')}, over every key "
          f"{launches.get('flash_attention_full')}: not 3 x {layers} x {n_req}, two thirds "
          "over every key")
    flash = sorted(e[1:] for e in log if e[0] == "flash")
    want = sorted([("self", t, t, t, 1) for t in ENCDEC_FRAMES] * cfg.n_encoder_layers
                  + [("self", n, n, 0, 1) for n in ENCDEC_PROMPT_LENS] * layers
                  + [("cross", n, t, t, 1) for n, t in zip(ENCDEC_PROMPT_LENS, ENCDEC_FRAMES)]
                  * layers)
    check(flash == want, "the prefills' flash calls are not 24 bidirectional, 24 causal and 24 "
                         "cross a request at their shapes")
    paged = [e for e in log if e[0] == "paged"]
    cross = [e for e in paged if e[1] == "cross"]
    check(launches.get("paged_attention", 0) == sum(e[5] for e in paged) == 2 * layers * steps
          and len(cross) == sum(e[5] for e in cross) == layers * steps
          and sorted({e[3] for e in cross}) == sorted(ENCDEC_FRAMES),
          f"paged launches {launches.get('paged_attention')}, {len(cross)} over cross caches: "
          f"not 2 x {layers} x {steps}, half over the encoder's rows")
    launches["paged_attention_cross"] = sum(e[5] for e in cross)
    del log

    step_bound = decode_bound_ms(params)
    replays = []
    for i, (batch, r) in enumerate(zip(batches, served)):
        errs = replay_errors(torch, device, cfg, params, batch, r)
        replays.append(errs)
        kv_row = cfg.n_kv_heads * cfg.head_dim * 2 * 2  # k and v, bf16
        cache_bytes = layers * kv_row * (ENCDEC_FRAMES[i] + ENCDEC_PROMPT_LENS[i] + MAX_NEW_TOKENS)
        emit({"phase": "encdec", "request": i, "frames": ENCDEC_FRAMES[i],
              "prompt_tokens": ENCDEC_PROMPT_LENS[i], "new_tokens": len(r["tokens"]),
              "prefill_seconds": r["prefill_seconds"],
              "decode_seconds_per_token": r["decode_seconds"] / (MAX_NEW_TOKENS - 1),
              "decode_step_bound_ms": step_bound,
              "decode_step_bound_with_caches_ms": step_bound + cache_bytes / HBM_BYTES_PER_S * 1e3,
              "tokens_per_second": len(r["tokens"]) / (r["prefill_seconds"] + r["decode_seconds"]),
              "consistency": errs, "tol": ENCDEC_TOL})
    check(all(e[key] <= ENCDEC_TOL[key] for e in replays for key in ENCDEC_TOL),
          f"decode and its prefill replay disagree: {replays}")
    emit({"phase": "encdec", "requests": n_req, "new_tokens": steps + n_req,
          "decode_steps": steps, "wall_seconds": wall, "tokens_per_second": (steps + n_req) / wall,
          "launches": launches, "peak_device_bytes": peak})
    family_breakdown(torch, device, cfg, params, batches[0], ENCDEC_PROMPT_LENS[0],
                     ENCDEC_MAX_LEN, "encdec")
    return launches


# --------------------------------------------------------------------------
# Phase 5g: the attention softcap in the flash and paged kernels, the paged
# kernel's int8 route, and gemma-2b served with both
# --------------------------------------------------------------------------


def capped_launch(torch, counter, fn):
    """``fn()`` through a wrapper that must count one launch under
    ``counter`` and one under its ``*_softcap`` sibling (or, for the int8
    route, ``paged_attention_softcap``)."""
    from repro_torch.kernels import runtime

    capped = "flash_attention_softcap" if counter.startswith("flash") else "paged_attention_softcap"
    before = runtime.launches[counter], runtime.launches[capped]
    out = fn()
    check((runtime.launches[counter], runtime.launches[capped]) == (before[0] + 1, before[1] + 1),
          f"a capped call did not launch the capped instantiation under {counter}")
    return out


def tol_excess(torch, got, want) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` of ``ATTN_TOL``:
    how many times the rule's bound an output misses by."""
    tol = ATTN_TOL[str(want.dtype)]
    d, w = (got.double() - want.double()).abs(), want.double().abs()
    return float((d / (tol["atol"] + tol["rtol"] * w)).max())


def bite_share(torch, scores, visible) -> float:
    """The share of the visible scores above ``CHECK_CAP`` in magnitude."""
    return float((scores.abs() > CHECK_CAP)[visible.expand_as(scores)].float().mean())


def phase_softcap_kernels(torch, device):
    """The flash (both routes) and paged kernels with a cap that bites
    against their plain versions under ``ATTN_TOL`` (each check showing at
    least 10% of its visible scores past the cap and the uncapped kernel
    missing the rule by more than 10 times); the int8 route bit for bit
    against the bf16 route on the dequantized caches, with and without a
    cap; ``quantize_kv`` on the card byte for byte against the CPU on ties
    and zero rows; four planted faults; then the capped kernels and the int8
    route timed beside their bounds."""
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import plan_blocks, remop_flash_attention
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(29)
    errs, rows = {}, {}
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=device, generator=gen).to(dtype)

    # -- flash with a cap that bites, both routes ----------------------------------------
    for what, b, h, kv, s, t, hd, hd_v, dt, path, window, prefix in SOFTCAP_FLASH_CHECKS:
        dtype = dtypes[dt]
        q = randn(b, h, s, hd, dtype=dtype) * CHECK_GAIN
        k, v = randn(b, kv, t, hd, dtype=dtype), randn(b, kv, t, hd_v, dtype=dtype)
        check(fa.route(q, k, v) == path, f"{what} {dt} does not take the {path} route")
        want = fa.flash_attention_plain(q, k, v, window=window, prefix=prefix, softcap=CHECK_CAP)
        got = capped_launch(torch, f"flash_attention_{path}", lambda: remop_flash_attention(
            q, k, v, window=window, prefix=prefix, softcap=CHECK_CAP))
        err, rel = allclose(torch, ["flash_attention_softcap"], got, want, errs)
        g = h // kv
        sc = torch.einsum("gsd,td->gst", q[0, :min(g, 2)].float(), k[0, 0].float()) / math.sqrt(hd)
        qp = torch.arange(s, device=device)[:, None] + (t - s)
        kp = torch.arange(t, device=device)[None, :]
        seen = (kp <= qp) | (kp < prefix)
        if window:
            seen &= qp - kp < window
        share = bite_share(torch, sc, seen)
        excess = tol_excess(torch, remop_flash_attention(q, k, v, window=window, prefix=prefix),
                            want)
        emit({"phase": "softcap", "check": "flash_attention_softcap", "what": what,
              "shape": [b, h, kv, s, t, hd, hd_v], "dtype": str(dtype), "route": path,
              "window": window, "prefix": prefix, "softcap": CHECK_CAP, "q_gain": CHECK_GAIN,
              "tol": ATTN_TOL[str(dtype)], "max_abs_err": err, "rel_err": rel,
              "visible_scores_past_cap": share, "uncapped_tol_excess": excess})
        check(share >= 0.1 and excess > 10, f"{what}: the cap does not bite (share {share}, "
                                             f"uncapped {excess} x the rule)")
    emit({"phase": "softcap", "flash_attention_tc_capped_instantiations": {
        f"hd {hd}/{hd_v} bq {bq} bk {bk}": fa.occupancy(hd, bq, bk, hd_v=hd_v, capped=True)
        for hd, hd_v in fa.TC_HEAD_PAIRS for bq in fa.TC_BLOCKS for bk in fa.TC_BLOCKS
        if fa.smem_bytes(bq, bk, hd, 2, "tc", hd_v) <= fa.SMEM_LIMIT}})

    # -- paged with a cap that bites, bf16 and f32 -----------------------------------------
    for what, b, kv, g, hd, s, lengths in SOFTCAP_PAGED_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(b, kv, g, hd, dtype=dtype) * CHECK_GAIN
            kc, vc = randn(b, s, kv, hd, dtype=dtype), randn(b, s, kv, hd, dtype=dtype)
            ln = torch.tensor(lengths, dtype=torch.int32, device=device)
            want = pa.paged_attention_plain(q, kc, vc, ln, softcap=CHECK_CAP)
            got = capped_launch(torch, "paged_attention", lambda: pa.paged_attention(
                q, kc, vc, ln, softcap=CHECK_CAP))
            err, rel = allclose(torch, ["paged_attention_softcap"], got, want, errs)
            sc = torch.einsum("bkgd,bskd->bkgs", q.float(), kc.float()) / math.sqrt(hd)
            share = bite_share(torch, sc, (torch.arange(s, device=device)[None, :]
                                           < ln[:, None])[:, None, None, :])
            excess = tol_excess(torch, pa.paged_attention(q, kc, vc, ln), want)
            emit({"phase": "softcap", "check": "paged_attention_softcap", "what": what,
                  "shape": [b, kv, g, hd, s], "lengths": list(lengths), "dtype": str(dtype),
                  "plan": pa.plan(b, kv, g, s), "softcap": CHECK_CAP, "q_gain": CHECK_GAIN,
                  "tol": ATTN_TOL[str(dtype)], "max_abs_err": err, "rel_err": rel,
                  "visible_scores_past_cap": share, "uncapped_tol_excess": excess})
            check(share >= 0.1 and excess > 10, f"{what}: the cap does not bite")

    # -- the int8 route: bit for bit the bf16 route on the dequantized caches --------------
    for what, b, kv, g, hd, s, lengths in INT8_CHECKS:
        for cap in (0.0, CHECK_CAP):
            q = randn(b, kv, g, hd) * (CHECK_GAIN if cap else 1.0)
            (kq, ks), (vq, vs) = (attn.quantize_kv(randn(b, s, kv, hd)) for _ in range(2))
            ln = torch.tensor(lengths, dtype=torch.int32, device=device)

            def int8():
                return pa.paged_attention_int8(q, kq, vq, ks, vs, ln, softcap=cap)

            got = capped_launch(torch, "paged_attention_int8", int8) if cap else int8()
            bf16 = pa.paged_attention(q, attn.dequantize_kv(kq, ks), attn.dequantize_kv(vq, vs),
                                      ln, softcap=cap)
            equal = torch.equal(got.view(torch.int16), bf16.view(torch.int16))
            err, rel = allclose(torch, ["paged_attention_int8"], got,
                                pa.paged_attention_int8_plain(q, kq, vq, ks, vs, ln,
                                                              softcap=cap), errs)
            emit({"phase": "softcap", "check": "paged_attention_int8", "what": what,
                  "shape": [b, kv, g, hd, s], "lengths": list(lengths), "softcap": cap,
                  "plan": pa.plan(b, kv, g, s), "equal_bits_to_bf16_route": equal,
                  "max_abs_err_to_plain": err, "rel_err_to_plain": rel})
            check(equal, f"int8 route {what} (cap {cap}) differs from the bf16 route on the "
                         "dequantized caches")
    emit({"phase": "softcap", "paged_attention_int8_instantiations": {
        f"hd {hd} gc {gc}": pa.attributes(torch.int8, hd, gc)
        for hd in pa.HEAD_DIMS for gc in (8, 48, 64)}})

    # -- quantize_kv on the card, byte for byte the CPU's, on ties and zero rows ------------
    rng = np.random.default_rng(SEED + 29)
    x = rng.standard_normal((4, 512, 8, 64)).astype(np.float32)
    x[:, ::7] = 0.0  # zero rows
    pow2 = np.float32(2.0) ** rng.integers(-8, 3, (4, 512, 8, 1)).astype(np.float32)
    ties = rng.choice(np.float32([2.5, -2.5, 3.5, -3.5, 10.5, -100.5, 0.5, -0.5]), (4, 512, 8, 64))
    x[:, 3::7] = (ties * pow2)[:, 3::7]
    x[:, 3::7, :, 0] = (127.0 * pow2)[:, 3::7, :, 0]  # the max: the scale is pow2 exactly
    xc = torch.from_numpy(x).to(torch.bfloat16)
    (q_cpu, s_cpu), (q_dev, s_dev) = attn.quantize_kv(xc), attn.quantize_kv(xc.to(device))
    same = (torch.equal(q_cpu, q_dev.cpu())
            and torch.equal(s_cpu.view(torch.int16), s_dev.cpu().view(torch.int16)))
    xf = xc.float()
    ratio = xf / (torch.clamp_min(xf.abs().amax(-1, keepdim=True), 1e-6) / 127.0)
    n_ties = int(((ratio - ratio.floor()) == 0.5).sum())
    n_zero = int((xf == 0).all(-1).sum())
    emit({"phase": "softcap", "check": "quantize_kv", "shape": list(x.shape),
          "equal_bytes_card_cpu": same, "ties_at_half": n_ties, "zero_rows": n_zero,
          "extremes": [int((q_cpu == 127).sum()), int((q_cpu == -127).sum())]})
    check(same and n_ties > 0 and n_zero > 0, f"quantize_kv on the card differs from the CPU "
          f"({same}) or the data lack ties ({n_ties}) or zero rows ({n_zero})")

    # -- planted faults --------------------------------------------------------------------
    b, h, kv, s, hd = 1, 8, 1, 2048, 256
    q = randn(b, h, s, hd) * CHECK_GAIN
    k, v = randn(b, kv, s, hd), randn(b, kv, s, hd)
    want = fa.flash_attention_plain(q, k, v, softcap=CHECK_CAP)
    raw = torch.einsum("hsd,td->hst", q[0].float(), k[0, 0].float())
    hidden = torch.ones(s, s, dtype=torch.bool, device=device).triu(1)
    scale = 1.0 / math.sqrt(hd)

    def dense(scores):
        out = torch.softmax(scores, dim=-1) @ v[0, 0].float()
        return out[None].to(q.dtype)

    capped = lambda x: torch.tanh(x / CHECK_CAP) * CHECK_CAP  # noqa: E731
    reject_fault(torch, "flash_attention_softcap", "applies the cap after the mask",
                 dense(capped((raw * scale).masked_fill(hidden, -1e30))), want)
    reject_fault(torch, "flash_attention_softcap", "applies the cap before the scale",
                 dense((capped(raw) * scale).masked_fill(hidden, -1e30)), want)
    del raw, hidden
    for what, b, kv, g, hd, s, lengths, fault in INT8_FAULTS:
        q = randn(b, kv, g, hd)
        (kq, ks), (vq, vs) = (attn.quantize_kv(randn(b, s, kv, hd)) for _ in range(2))
        ln = torch.tensor(lengths, dtype=torch.int32, device=device)
        if "next position" in fault:
            bad_ks, bad_vs = (torch.roll(x, -1, dims=1) for x in (ks, vs))
        else:  # head 0's scale for every head
            bad_ks, bad_vs = (x[:, :, :1].expand_as(x) for x in (ks, vs))
        reject_fault(torch, "paged_attention_int8", f"{fault} ({what})",
                     pa.paged_attention(q, attn.dequantize_kv(kq, bad_ks),
                                        attn.dequantize_kv(vq, bad_vs), ln),
                     pa.paged_attention_int8_plain(q, kq, vq, ks, vs, ln))
    torch.cuda.synchronize()

    # -- timing: the model's cap (50) at gemma-2b's prefill and decode shapes; the int8
    # route at row 5's shape and at G 1, hd 64 ---------------------------------------------
    bench = Bench(torch, device)
    b, h, kv, s, hd = 1, 8, 1, 2048, 256
    q, k, v = randn(b, h, s, hd), randn(b, kv, s, hd), randn(b, kv, s, hd)
    bq, bk = plan_blocks(s, s, hd)
    ms_bound, by = bound(*flash_cost(b, h, kv, s, s, hd, 2), BF16_OPS_PER_S)

    flex, block_mask, tanh_cap = flex_softcap(torch)

    def flash_capped():
        return fa.flash_attention(q, k, v, bq=bq, bk=bk, softcap=ATTN_SOFTCAP)

    causal = block_mask(lambda b, h, q_idx, kv_idx: q_idx >= kv_idx, None, None, s, s,
                        device=device)

    def flash_flex():
        return flex(q, k, v, score_mod=tanh_cap, block_mask=causal, enable_gqa=True)

    plain = fa.flash_attention_plain(q, k, v, softcap=ATTN_SOFTCAP)
    rows["flash_attention_softcap"] = dict(
        shape=f"q [{b},{h},{s},{hd}], k/v [{b},{kv},{s},{hd}] bf16, causal, softcap "
              f"{ATTN_SOFTCAP}, blocks {(bq, bk)}",
        ms=bench.ms(flash_capped),
        plain_ms=bench.ms(lambda: fa.flash_attention_plain(q, k, v, softcap=ATTN_SOFTCAP)),
        library_ms=bench.ms(flash_flex), library=FLEX_LIBRARY,
        library_rel_err_to_plain=rel_err(torch, flash_flex(), plain),
        bound_ms=ms_bound, bound_by=by, **bench.device_ms(flash_capped),
        **{f"library_{k}": v for k, v in bench.device_ms(flash_flex).items()},
        uncapped_device_ms=bench.device_ms(
            lambda: fa.flash_attention(q, k, v, bq=bq, bk=bk))["device_ms"])
    del plain, causal
    s, length = 4096, 2048
    ln = torch.full((1,), length, dtype=torch.int32, device=device)
    for name, kv, g, hd in (("paged_attention_softcap", 1, 8, 256),
                            ("paged_attention_int8", 1, 8, 256),
                            ("paged_attention_int8 G 1 hd 64", 16, 1, 64)):
        q = randn(1, kv, g, hd)
        kc, vc = randn(1, s, kv, hd), randn(1, s, kv, hd)
        (kq, ks), (vq, vs) = attn.quantize_kv(kc), attn.quantize_kv(vc)
        n = s if g == 1 else length  # G 1: row 5d's full 4096-row cache
        lens = torch.full((1,), n, dtype=torch.int32, device=device)
        if name == "paged_attention_softcap":
            cache_bytes = 2 * n * kv * hd * 2

            def kernel(q=q, kc=kc, vc=vc, lens=lens):
                return pa.paged_attention(q, kc, vc, lens, softcap=ATTN_SOFTCAP)

            def plain(q=q, kc=kc, vc=vc, lens=lens):
                return pa.paged_attention_plain(q, kc, vc, lens, softcap=ATTN_SOFTCAP)

            seen = block_mask(lambda b, h, q_idx, kv_idx, n=n: kv_idx < n, None, None, 1, s,
                              device=device)
            qf, kf, vf = q.view(1, kv * g, 1, hd), kc.transpose(1, 2), vc.transpose(1, 2)

            def library(qf=qf, kf=kf, vf=vf, seen=seen):
                return flex(qf, kf, vf, score_mod=tanh_cap, block_mask=seen, enable_gqa=True)

            flex_row = dict(library_ms=bench.ms(library), library=FLEX_LIBRARY,
                            library_rel_err_to_plain=rel_err(
                                torch, library().view(q.shape), plain()),
                            **{f"library_{k}": v for k, v in bench.device_ms(library).items()})
        else:
            cache_bytes = 2 * n * kv * (hd + 2)

            def kernel(q=q, kq=kq, vq=vq, ks=ks, vs=vs, lens=lens):
                return pa.paged_attention_int8(q, kq, vq, ks, vs, lens)

            def plain(q=q, kq=kq, vq=vq, ks=ks, vs=vs, lens=lens):
                return pa.paged_attention_int8_plain(q, kq, vq, ks, vs, lens)

            flex_row = dict(library_ms=None,
                            library="none: no single PyTorch call reads an int8 cache")
        ms_bound, by = bound(cache_bytes + 2 * kv * g * hd * 2, 4 * hd * n * kv * g,
                             BF16_OPS_PER_S)
        row = dict(
            shape=f"q [1,{kv},{g},{hd}], caches [1,{s},{kv},{hd}] "
                  f"{'bf16' if name.endswith('softcap') else 'int8, bf16 scales'}, length {n}, "
                  f"plan {pa.plan(1, kv, g, s)}",
            ms=bench.ms(kernel), plain_ms=bench.ms(plain), **flex_row, bound_ms=ms_bound,
            bound_by=by, cache_bytes=cache_bytes, **bench.device_ms(kernel),
            bf16_route_device_ms=bench.device_ms(lambda q=q, kc=kc, vc=vc, lens=lens:
                                                 pa.paged_attention(q, kc, vc, lens))["device_ms"])
        if name in ("paged_attention_softcap", "paged_attention_int8"):
            rows[name] = row
        else:
            emit({"phase": "softcap", "timing": name, **row})
    for key, row in rows.items():
        emit({"phase": "softcap", "timing": key, **row})
    del bench
    return errs, rows


def flex_softcap(torch):
    """The one PyTorch call that computes the capped kernels' function:
    ``flex_attention`` under ``torch.compile`` with ``score_mod = tanh(s /
    ATTN_SOFTCAP) * ATTN_SOFTCAP`` (after flex's own 1/sqrt(hd) scale, as
    the kernels cap), compiled in this process (``main`` sets where its
    caches go).  Returns (the compiled call, ``create_block_mask``, the
    score_mod)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def tanh_cap(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / ATTN_SOFTCAP) * ATTN_SOFTCAP

    return torch.compile(flex_attention, dynamic=False), create_block_mask, tanh_cap


def softcap_config():
    """gemma-2b with Gemma 2's published caps (``ATTN_SOFTCAP``,
    ``LOGIT_SOFTCAP``) set on ``repro``'s flags."""
    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS[SOFTCAP_ARCH], attn_softcap=ATTN_SOFTCAP,
                               logit_softcap=LOGIT_SOFTCAP)


@contextlib.contextmanager
def recorded(module, name, log):
    """Each call of ``module.<name>`` while the context lasts appended to
    ``log`` as (its positional arguments, its keyword arguments, its
    result)."""
    saved = getattr(module, name)

    def recording(*args, **kwargs):
        out = saved(*args, **kwargs)
        log.append((args, kwargs, out))
        return out

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, saved)


def scale_err(torch, got, want) -> float:
    """``max|got - want| / max|want|``: the model rule's measure."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def int8_decode(torch, cfg, params, caches, first, start, feed=None, steps=None):
    """``steps`` (INT8_STEPS) ``decode_step`` calls from position ``start``
    on ``caches`` (written in place): greedy from ``first``, or fed the
    tokens of ``feed``.  Returns (the tokens fed, each step's (logits,
    hidden) in f32, host seconds, peak device bytes)."""
    from repro_torch.models import transformer as tf

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tok, fed, out = first, [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i, pos in enumerate(range(start, start + (steps or INT8_STEPS))):
            tok = tok if feed is None else feed[i]
            fed.append(tok)
            logits, caches, hidden = tf.decode_step(params, cfg, caches, tok, pos,
                                                    return_hidden=True)
            out.append((logits.float(), hidden.float()))
            tok = logits.argmax(-1)
    torch.cuda.synchronize()
    return fed, out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def profiled_decode(torch, cfg, params, caches, token, start, steps, unprofiled):
    """``steps`` greedy decode steps from ``token`` at ``start`` under the
    profiler: the busy device seconds and the idle share, beside
    ``unprofiled``, the host seconds of the same steps in the timed pass."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf

    tok = token
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pos in range(start, start + steps):
            logits, caches = tf.decode_step(params, cfg, caches, tok, pos)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    kinds = device_seconds(torch, prof, ("paged_attention_kernel",), "attention_kernels")
    return {"steps": steps, "unprofiled_seconds": unprofiled, "profiled_seconds": profiled,
            **busy_and_idle(kinds, profiled, unprofiled)}


def int8_layer_errors(torch, device, cfg):
    """One gemma-2b attention layer at full width over INT8_LAYER_SEQ random
    rows: at each of INT8_LAYER_POSITIONS, the decode over the int8 cache of
    the rows before it (``quantize_kv`` of the forward's K/V) on the kernel
    path against the plain path: relative L2 errors of the output."""
    import torch.nn.functional as F
    from repro_torch.models import attention as attn

    gen = torch.Generator(device=device).manual_seed(SEED + 37)
    p = attn.init_gqa(cfg, gen, device)
    s = INT8_LAYER_SEQ
    x = torch.randn(1, s, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    positions = torch.arange(s, dtype=torch.int32, device=device)[None]
    errs = []
    with torch.inference_mode():
        _, (k, v) = attn.gqa_forward(p, cfg, x, positions, return_kv=True)
        for pos in INT8_LAYER_POSITIONS:
            (kq, ks), (vq, vs) = (attn.quantize_kv(F.pad(a[:, :pos], (0, 0, 0, 0, 0, s - pos)))
                                  for a in (k, v))
            cache = (kq, vq, ks, vs)
            got, _ = attn.gqa_decode(p, cfg, x[:, pos:pos + 1], tuple(t.clone() for t in cache),
                                     pos)
            with plain_attention():
                want, _ = attn.gqa_decode(p, cfg, x[:, pos:pos + 1], cache, pos)
            errs.append(rel_err(torch, got[0, 0], want[0, 0]))
    return errs


def phase_int8_decode(torch, device, params):
    """gemma-2b at full width: each of INT8_PROMPT_LENS through ``prefill``,
    ``pad_caches(INT8_MAX_LEN)`` and ``quantize_kv`` on every layer's cache,
    then INT8_STEPS greedy ``decode_step`` calls on the int8 caches, timed
    with only those caches on the card, each ``quantize_kv`` and
    ``gqa_decode`` call recorded.  After the timed pass: every new cache row
    byte for byte ``quantize_kv`` of the same k and v on the CPU; every
    recorded ``gqa_decode`` call replayed on the plain path within
    ``INT8_LAYER_TOL``; the whole model's steps on the plain path (from a
    copy of the caches, the same tokens) within ``INT8_TOL``.  Then the same
    tokens through the bf16 caches, timed with only those on the card (the
    logits' gap and the argmax agreement printed, not gated).  First one
    attention layer's int8 decode, kernel path against plain path, within
    ``INT8_LAYER_TOL``."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf

    cfg = ARCHS[SOFTCAP_ARCH]
    layer = int8_layer_errors(torch, device, cfg)
    emit({"phase": "int8", "layer_check": "int8 decode of one attention layer, kernel path "
          "against plain path", "positions": list(INT8_LAYER_POSITIONS), "rel_l2": layer,
          "max_rel_l2": max(layer), "tol": INT8_LAYER_TOL})
    check(max(layer) <= INT8_LAYER_TOL, f"the int8 layer's kernel path differs: {layer}")
    rng = np.random.default_rng(SEED + 31)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n), dtype=np.int32),
                               device=device) for n in INT8_PROMPT_LENS]
    launches, runs = collections.Counter(), {"int8": [], "bf16": []}
    gaps, agree, first_step = [], [], []
    worst = {"hidden": 0.0, "logits": 0.0}  # relative L2, gated
    worst_scale = {"hidden": 0.0, "logits": 0.0}  # max abs of scale, printed
    calls_worst, calls_checked, rows_checked, ratios = 0.0, 0, 0, set()
    idle = {}

    def copies(caches, where):  # copies even where the caches lie already
        return [tuple(t.to(where, copy=True) for t in c) for c in caches]

    for n, tokens in zip(INT8_PROMPT_LENS, prompts):
        with torch.inference_mode():
            logits, caches = tf.prefill(params, cfg, {"tokens": tokens})
            caches = tf.pad_caches(cfg, caches, INT8_MAX_LEN)
            q8 = []
            for k, v in caches:
                (kq, ks), (vq, vs) = attn.quantize_kv(k), attn.quantize_kv(v)
                q8.append((kq, vq, ks, vs))
        bytes8 = sum(t.numel() * t.element_size() for c in q8 for t in c)
        bytes16 = sum(t.numel() * t.element_size() for c in caches for t in c)
        ratios.add((bytes8, bytes16))
        check(bytes8 * 2 * cfg.head_dim == bytes16 * (cfg.head_dim + 2),
              f"int8 caches {bytes8} bytes against {bytes16}: not (hd + 2) / (2 hd)")
        first = logits.argmax(-1)
        # Each run keeps only its own caches on the card: the others wait on the host.
        bf16_host, q8_host = copies(caches, "cpu"), copies(q8, "cpu")
        del logits, caches
        last = n == INT8_PROMPT_LENS[-1]
        if n == INT8_PROMPT_LENS[0]:  # both paths once before the first timed pass
            for host in (q8_host, bf16_host):
                int8_decode(torch, cfg, params, copies(host, device), first, n, steps=2)

        # The int8 caches on the kernel path, timed; its tokens go to the other paths.
        quant, calls = [], []
        runtime.reset_launches()
        with recorded(attn, "quantize_kv", quant), recorded(attn, "gqa_decode", calls):
            seq, out8, seconds, peak = int8_decode(torch, cfg, params, q8, first, n)
        launches.update(runtime.launches)
        check(runtime.launches["paged_attention_int8"] == cfg.n_layers * INT8_STEPS
              and not runtime.launches["paged_attention"],
              f"request {n}: {dict(runtime.launches)} int8 launches, not "
              f"{cfg.n_layers} x {INT8_STEPS} on the int8 route alone")
        runs["int8"].append({"prompt": n, "decode_seconds_per_step": seconds / INT8_STEPS,
                             "steps": INT8_STEPS, "peak_device_bytes": peak})
        if last:
            idle["int8"] = profiled_decode(torch, cfg, params, copies(q8_host, device), first,
                                           n, 8, seconds * 8 / INT8_STEPS)

        # Every new row (k_q, v_q, k_scale, v_scale) against quantize_kv of its k and v
        # on the CPU: one copy to the host a tensor.
        check(len(quant) == 2 * len(calls) == 2 * cfg.n_layers * INT8_STEPS,
              f"{len(quant)} quantize_kv and {len(calls)} gqa_decode calls recorded")
        want = [attn.quantize_kv(torch.stack([a[0] for a, _, _ in quant[j::2]]).cpu())
                for j in (0, 1)]
        got = [torch.stack([a[3][i][:, a[4]] for a, _, _ in calls]).cpu() for i in range(4)]
        check(torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])
              and torch.equal(got[2].view(torch.int16), want[0][1].view(torch.int16))
              and torch.equal(got[3].view(torch.int16), want[1][1].view(torch.int16)),
              f"request {n}: a new int8 row is not quantize_kv of its k and v on the CPU")
        rows_checked += len(calls)
        del quant, got, want

        # Every gqa_decode call replayed on the plain path with the same inputs.  The
        # cache read is the final one: a call reads no row past its own position.
        with torch.inference_mode(), plain_attention():
            clones = {}
            for (p, c, x, cache, pos), kw, (out, _) in calls:
                mine = clones.setdefault(id(cache[0]), tuple(t.clone() for t in cache))
                ref, _ = attn.gqa_decode(p, c, x, mine, pos, **kw)
                calls_worst = max(calls_worst, rel_err(torch, out, ref))
                calls_checked += 1
        del calls, clones, q8

        # The whole model on the plain path, the same tokens, from a copy of the caches.
        with plain_attention():
            _, plain, _, _ = int8_decode(torch, cfg, params, copies(q8_host, device), first,
                                         n, feed=seq)
        for (l8, h8), (lp, hp) in zip(out8, plain):
            for key, g, w in (("logits", l8, lp), ("hidden", h8, hp)):
                worst[key] = max(worst[key], rel_err(torch, g, w))
                worst_scale[key] = max(worst_scale[key], scale_err(torch, g, w))
        first_step.append(rel_err(torch, out8[0][1], plain[0][1]))
        logits8 = [lg.cpu() for lg, _ in out8]  # off the card for the bf16 run's peak
        del plain, q8_host, out8

        # The bf16 caches, the same tokens, timed.
        runtime.reset_launches()
        _, out16, seconds, peak = int8_decode(torch, cfg, params, copies(bf16_host, device),
                                              first, n, feed=seq)
        launches.update(runtime.launches)
        runs["bf16"].append({"prompt": n, "decode_seconds_per_step": seconds / INT8_STEPS,
                             "steps": INT8_STEPS, "peak_device_bytes": peak})
        if last:
            idle["bf16"] = profiled_decode(torch, cfg, params, copies(bf16_host, device),
                                           first, n, 8, seconds * 8 / INT8_STEPS)
        for l8, (l16, _) in zip(logits8, out16):
            l16 = l16.cpu()
            gaps.append(scale_err(torch, l8, l16))
            agree.append(bool((l8.argmax(-1) == l16.argmax(-1)).all()))
        del logits8, out16, bf16_host
    check(calls_worst <= INT8_LAYER_TOL,
          f"a gqa_decode call's int8 kernel path differs from its plain path: {calls_worst}")
    check(worst["logits"] <= INT8_TOL and worst["hidden"] <= INT8_TOL,
          f"the int8 decode's kernel path differs from its plain path: {worst}")
    n_req = len(INT8_PROMPT_LENS)
    check(launches["paged_attention_int8"] == cfg.n_layers * INT8_STEPS * n_req,
          f"{launches['paged_attention_int8']} int8 launches, not {cfg.n_layers} x "
          f"{INT8_STEPS} x {n_req}")
    for label in ("int8", "bf16"):
        per = statistics.mean(r["decode_seconds_per_step"] for r in runs[label])
        emit({"phase": "int8", "run": label, "requests": runs[label],
              "decode_seconds_per_step": per, "tokens_per_second": 1.0 / per,
              "peak_device_bytes": max(r["peak_device_bytes"] for r in runs[label]),
              "decode_window": idle[label]})
    emit({"phase": "int8", "arch": cfg.name, "prompts": list(INT8_PROMPT_LENS),
          "steps": INT8_STEPS, "gqa_decode_calls_replayed": calls_checked,
          "gqa_decode_kernel_vs_plain_rel_l2_max": calls_worst, "call_tol": INT8_LAYER_TOL,
          "kernel_vs_plain_rel_l2": worst, "tol": INT8_TOL,
          "kernel_vs_plain_scale_err": worst_scale, "first_step_hidden_rel_l2": first_step,
          "new_rows_byte_equal_to_cpu_quantize_kv": rows_checked,
          "cache_bytes_int8_bf16": sorted(ratios), "cache_ratio": (cfg.head_dim + 2) / (
              2 * cfg.head_dim),
          "int8_vs_bf16_logits_scale_err_max": max(gaps),
          "int8_vs_bf16_logits_scale_err_mean": statistics.mean(gaps),
          "argmax_agreement": sum(agree) / len(agree),
          "launches": {k: launches[k] for k in ("paged_attention_int8", "paged_attention")}})
    return dict(launches)


# --------------------------------------------------------------------------
# Phase 6: the REMOP-planned blocked matmul at five LLM products
# --------------------------------------------------------------------------


def mm_close(torch, got, want, k: int, rms_ab: float):
    """(within the matmul rule, max abs error, relative L2 error, atol)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"dtype/shape differ: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    key = str(want.dtype)
    atol = MM_NOISE * k * 2.0 ** -24 * rms_ab
    d = (got.float() - want.float()).abs()  # exact for bf16 outputs
    w = want.float().abs()
    ok = bool((d <= atol + MM_ULP[key] * w).all())
    rel = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(w))
    return ok and rel <= MM_REL[key], float(d.max()), rel, atol


def rms(torch, x) -> float:
    return float(x.float().pow(2).mean().sqrt())


def padded(torch, x, m0: int, m1: int):
    import torch.nn.functional as F
    return F.pad(x, (0, (-x.shape[1]) % m1, 0, (-x.shape[0]) % m0))


def mm_row_rates(m, n, k, ms, d_bytes):
    """TFLOP/s of ``ms`` and the plan's bytes D read at the card's rate."""
    return {"tflops": 2.0 * m * n * k / (ms * 1e-3) / 1e12,
            "d_bound_ms": d_bytes / HBM_BYTES_PER_S * 1e3}


def phase_matmul(torch, device, card: str):
    """``remop_matmul`` under the REMOP and the conventional plan at the five
    products, against the plain version; JAX-test shapes and tiles; the
    element route and the f32 kernel; two planted faults; then timed."""
    from repro_torch.core.cost_model import H100
    from repro_torch.core.planner import matmul_costs
    from repro_torch.kernels import runtime
    from repro_torch.kernels.matmul.matmul import (
        MMA_N, check_tiles, launch, matmul_tiled, matmul_tiled_plain, occupancy, ring_bytes,
        ring_sub)
    from repro_torch.kernels.matmul.ops import clamped_tiles, plan_for, remop_matmul

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 products in f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # cuBLAS sums in f32
    emit({"phase": "matmul", "card": card, "spec": dataclasses.asdict(H100),
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction})
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    plans, inputs = {}, {}
    for name, (m, k, n) in MATMUL_SHAPES.items():
        for policy in MATMUL_POLICIES:
            t0 = time.perf_counter()
            plan = plan_for.__wrapped__((m, k), (k, n), torch.bfloat16, policy)  # uncached
            plan_host_ms = (time.perf_counter() - t0) * 1e3
            tiles = clamped_tiles(plan, m, n, k)
            check_tiles(*tiles, 2)  # raises before any launch if the kernel cannot take it
            plans[name, policy] = (plan, tiles)
            emit({"phase": "matmul", "plan": name, "mkn": [m, k, n], "policy": plan.policy,
                  "tiles": list(tiles), "vmem_bytes": plan.vmem_bytes,
                  "ring_sub": ring_sub(*tiles, True),
                  **occupancy(*tiles),
                  "d_bytes": plan.d_bytes, "c_rounds": plan.c_rounds, "l_cost": plan.l_cost,
                  "plan_host_ms": plan_host_ms})
        inputs[name] = (torch.randn(m, k, device=device, generator=gen).to(torch.bfloat16),
                        torch.randn(k, n, device=device, generator=gen).to(torch.bfloat16))

    # Registers and local (spilled) bytes of every instantiation of the two
    # kernels: bf16 by wgmma N (one warpgroup), f32 by accumulators a thread.
    inst = {f"bf16 N={nn}": occupancy(nn, 64, 64) for nn in MMA_N}
    inst.update({f"f32 NR={nr}{' wide' if wide else ''}":
                 occupancy(nr, 256, 64, torch.float32, tma=wide)
                 for nr in (1, 2, 4, 8, 12, 16, 24, 32) for wide in (False, True)})
    emit({"phase": "matmul", "instantiations": {
        name: {key: o[key] for key in ("registers", "local_bytes")} for name, o in inst.items()}})

    # -- the path: remop_matmul at every product under both plans -------------
    torch.cuda.synchronize()
    runtime.reset_launches()
    outs = {}
    for name in MATMUL_SHAPES:
        a, b = inputs[name]
        for policy in MATMUL_POLICIES:
            outs[name, policy] = remop_matmul(a, b, policy=policy)
    torch.cuda.synchronize()
    launches = runtime.launches["matmul"]
    staged = runtime.launches["matmul_staged"]
    emit({"phase": "matmul", "launches": launches, "staged_launches": staged,
          "remop_matmul_calls": len(outs)})
    check(launches == len(outs) and staged == 0,
          f"remop_matmul made {launches} TMA-route and {staged} element-route launches in "
          f"{len(outs)} calls")

    # -- against the plain version on the same (padded) inputs ----------------
    errs = {"matmul": 0.0}

    def hold(what, got, want, k, rms_ab):
        ok, err, rel, atol = mm_close(torch, got, want, k, rms_ab)
        errs["matmul"] = max(errs["matmul"], err)
        emit({"phase": "matmul", "check": what, "dtype": str(got.dtype), "max_abs_err": err,
              "rel_err": rel, "atol": atol, "ulp": MM_ULP[str(want.dtype)],
              "rel_tol": MM_REL[str(want.dtype)], "within": ok})
        check(ok, f"matmul {what}: kernel differs from its plain version (max abs err {err}, "
                  f"relative L2 {rel})")

    def plain(a, b, bm, bn, bk, out_dtype=None):
        (m, k), n = a.shape, b.shape[1]
        return matmul_tiled_plain(padded(torch, a, bm, bk), padded(torch, b, bk, bn),
                                  bm, bn, bk, out_dtype)[:m, :n]

    for (name, policy), got in outs.items():
        a, b = inputs[name]
        bm, bn, bk = plans[name, policy][1]
        hold(f"{name}, {policy} {[bm, bn, bk]}", got, plain(a, b, bm, bn, bk), a.shape[1],
             rms(torch, a) * rms(torch, b))
    del outs

    # -- the JAX tests' shapes (every policy) and explicit tiles, f32 and bf16 --
    for m, k, n in JAX_MM_SHAPES:
        for dtype, policies in ((torch.bfloat16, ("remop", "conventional", "closed-form")),
                                (torch.float32, ("conventional",))):  # f32 REMOP plans assert
            a = torch.randn(m, k, device=device, generator=gen).to(dtype)
            b = torch.randn(k, n, device=device, generator=gen).to(dtype)
            for policy in policies:
                bm, bn, bk = clamped_tiles(plan_for((m, k), (k, n), dtype, policy), m, n, k)
                hold(f"jax shape {[m, k, n]}, {policy} {[bm, bn, bk]}",
                     remop_matmul(a, b, policy=policy), plain(a, b, bm, bn, bk), k,
                     rms(torch, a) * rms(torch, b))
    for tiles in JAX_MM_TILES:
        for dtype, out_dtype in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                 (torch.bfloat16, torch.bfloat16)):
            a = torch.randn(128, 64, device=device, generator=gen).to(dtype)
            b = torch.randn(64, 128, device=device, generator=gen).to(dtype)
            hold(f"jax tiles {list(tiles)}", matmul_tiled(a, b, *tiles, out_dtype=out_dtype),
                 matmul_tiled_plain(a, b, *tiles, out_dtype=out_dtype), 64,
                 rms(torch, a) * rms(torch, b))

    # -- ragged K and N on the TMA route: views that keep 16-byte row strides --
    name = "deepseek qkv"
    a, b = inputs[name]
    a_r, b_r = a[:, :2000], b[:2000, :2008]
    bm, bn, bk = plans[name, "remop"][1]
    before = runtime.launches["matmul"]
    hold(f"{name}, ragged views A[:, :2000] @ B[:2000, :2008] (TMA route) {[bm, bn, bk]}",
         launch(a_r, b_r, bm, bn, bk), plain(a_r, b_r, bm, bn, bk), 2000,
         rms(torch, a) * rms(torch, b))
    check(runtime.launches["matmul"] == before + 1, "the ragged views missed the TMA route")

    # -- the element route at a product's shape: A starts 2 bytes past 16 ------
    name = "deepseek expert"
    a, b = inputs[name]
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = plans[name, "remop"][1]
    a_odd = torch.empty(m * k + 1, dtype=a.dtype, device=device)[1:].view(m, k)
    a_odd.copy_(a)
    before = runtime.launches["matmul_staged"]
    hold(f"{name}, A misaligned by 2 bytes (element route) {[bm, bn, bk]}",
         remop_matmul(a_odd, b), plain(a, b, bm, bn, bk), k, rms(torch, a) * rms(torch, b))
    check(runtime.launches["matmul_staged"] == before + 1, "the misaligned A took the TMA route")
    del a_odd

    # -- the f32 kernel at the conventional f32 plan ----------------------------
    name, policy = MATMUL_F32_SHAPE
    m, k, n = MATMUL_SHAPES[name]
    a32 = torch.randn(m, k, device=device, generator=gen)
    b32 = torch.randn(k, n, device=device, generator=gen)
    plan32 = plan_for((m, k), (k, n), torch.float32, policy)
    t32 = clamped_tiles(plan32, m, n, k)
    before = runtime.launches["matmul_f32"]
    hold(f"{name}, {policy} f32 {list(t32)}", remop_matmul(a32, b32, policy=policy),
         plain(a32, b32, *t32), k, rms(torch, a32) * rms(torch, b32))
    check(runtime.launches["matmul_f32"] == before + 1, "the f32 product missed the f32 kernel")

    # -- a strided A, and two planted faults the rule must reject --------------
    name, policy = MATMUL_REPORT
    a, b = inputs[name]
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = plans[name, policy][1]
    ap, bp = padded(torch, a, bm, bk), padded(torch, b, bk, bn)
    rms_ab = rms(torch, a) * rms(torch, b)
    a_cut, b_cut = ap[:, :k - bk], bp[:k - bk]  # a view: rows keep their stride k
    hold(f"{name}, A as a strided view [:, :{k - bk}]", matmul_tiled(a_cut, b_cut, bm, bn, bk),
         matmul_tiled_plain(a_cut, b_cut, bm, bn, bk), k - bk, rms_ab)
    want = matmul_tiled_plain(ap, bp, bm, bn, bk)
    b_roll = bp.clone()
    b_roll[:, -bn:] = bp[:, -2 * bn:-bn]
    for what, got in ((f"drops the last K step ({bk} of {k})", matmul_tiled(a_cut, b_cut, bm, bn, bk)),
                      (f"reads B's column tile before the last ({bn} of {n} columns)",
                       matmul_tiled(ap, b_roll, bm, bn, bk))):
        ok, err, rel, _ = mm_close(torch, got, want, k, rms_ab)
        emit({"phase": "matmul", "planted_fault": name, "fault": what, "max_abs_err": err,
              "rel_err": rel, "rejected": not ok})
        check(not ok, f"matmul: the rule passes a kernel that {what}")
    del want, b_roll
    torch.cuda.synchronize()

    # -- timing ---------------------------------------------------------------
    bench = Bench(torch, device, reps=MATMUL_REPS, warmup=1)
    rows = {}
    for name, (m, k, n) in MATMUL_SHAPES.items():
        a, b = inputs[name]
        library_ms = bench.ms(lambda: torch.matmul(a, b))
        ms_bound, by = bound((m * k + k * n + m * n) * 2, 2.0 * m * n * k, BF16_OPS_PER_S)
        for policy in MATMUL_POLICIES:
            plan, (bm, bn, bk) = plans[name, policy]
            ap, bp = padded(torch, a, bm, bk), padded(torch, b, bk, bn)
            row = dict(
                shape=f"{name}: a [{m},{k}] @ b [{k},{n}] bf16, {policy} tiles {[bm, bn, bk]}",
                ms=bench.ms(lambda: matmul_tiled(ap, bp, bm, bn, bk)),
                remop_matmul_ms=bench.ms(lambda: remop_matmul(a, b, policy=policy)),
                plain_ms=bench.ms(lambda: matmul_tiled_plain(ap, bp, bm, bn, bk)),
                library_ms=library_ms, bound_ms=ms_bound, bound_by=by,
                c_rounds=plan.c_rounds, d_bytes=plan.d_bytes, l_cost=plan.l_cost)
            row.update(mm_row_rates(m, n, k, row["ms"], plan.d_bytes))
            if (name, policy) == MATMUL_REPORT:  # the table's device columns
                row.update(bench.device_ms(lambda: matmul_tiled(ap, bp, bm, bn, bk), reps=10))
                row.update({f"library_{k}": v for k, v in bench.device_ms(
                    lambda: torch.matmul(a, b), reps=10).items()})
            rows[name, policy] = row
            emit({"phase": "matmul", "timing": "matmul", "reps": MATMUL_REPS, **row})
            del ap, bp
    name = MATMUL_REPORT[0]
    a, b = inputs[name]
    (m, k), n = a.shape, b.shape[1]
    for bm, bn, bk in MATMUL_PROBE_TILES:
        ap, bp = padded(torch, a, bm, bk), padded(torch, b, bk, bn)
        hold(f"{name}, probe tiles {[bm, bn, bk]}", matmul_tiled(ap, bp, bm, bn, bk)[:m, :n],
             matmul_tiled_plain(ap, bp, bm, bn, bk)[:m, :n], k, rms(torch, a) * rms(torch, b))
        d, c = matmul_costs(m, n, k, bm, bn, bk, 2, 4)
        ms = bench.ms(lambda: matmul_tiled(ap, bp, bm, bn, bk))
        emit({"phase": "matmul", "timing": "probe tiles", "shape": name, "tiles": [bm, bn, bk],
              **occupancy(bm, bn, bk), "ring_bytes": ring_bytes(bm, bn, ring_sub(bm, bn, bk, True)),
              "reps": MATMUL_REPS, "ms": ms, **mm_row_rates(m, n, k, ms, d),
              "c_rounds": c, "d_bytes": d, "l_cost": d + H100.tau_dma_bytes * c})
        del ap, bp
    # The f32 kernel, timed once after one warm-up.
    name, policy = MATMUL_F32_SHAPE
    m, k, n = MATMUL_SHAPES[name]
    bench32 = Bench(torch, device, reps=1, warmup=1)
    ms = bench32.ms(lambda: remop_matmul(a32, b32, policy=policy))
    emit({"phase": "matmul", "timing": "matmul f32", "shape": f"{name} f32, {policy} tiles "
          f"{list(t32)}", **occupancy(*t32, dtype=torch.float32), "reps": 1, "ms": ms,
          **mm_row_rates(m, n, k, ms, plan32.d_bytes),
          "library_ms": bench32.ms(lambda: torch.matmul(a32, b32))})
    del bench, bench32, inputs, a32, b32
    return errs, {"matmul": rows[MATMUL_REPORT]}, launches


# --------------------------------------------------------------------------
# Phase 8: train (the flash backward kernel, a qwen3-0.6b block, the trainer)
# --------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-0.6b"
# The flash backward against its plain version: (name, b, h, kv, s, t, hd,
# hd_v, window, prefix, softcap, q gain, dtype).  The softcap row scales q
# by 8 so the cap of 50 bites (scores to about 30, the cap's derivative
# 0.7..1); "q gain 8" does so without a cap: dK's entries reach 60 while
# some cancel to near 0, which ATTN_TOL's atol holds to 1e-4.  The two "G 8"
# rows do so at hd 128 and 64 (dkdv_tc) with 8 query heads on one KV head:
# with one CTA summing a key block's 16,384 (head, query) rows dK missed
# ATTN_TOL there (a walk that long now flushes, bwd_flushes).  "G 48" is
# granite-20b's 48 heads on one KV head: 98,304 rows a key block, past the 16
# CTAs' cap.  The two "granite-moe" rows are the shape its trainer gives the
# kernel (24 heads on 8 KV heads of 64: G 3, 6,144 rows a key block),
# plain and with q 8 times the unit scale.  "recurrentgemma train" is the
# shape recurrentgemma-2b's trainer gives the kernel (2 x 4096 tokens, 10
# heads on one KV head of 256, window 2048: half the queries lose keys to
# the window).  "paligemma train" is the shape paligemma-3b's trainer gives
# the kernel (4 x 2048 positions, 8 heads on one KV head of 256, prefix
# 256: each key block of the prefix is seen by all 16,384 (head, query) rows
# of a sequence, the longest walk the prefix takes), plain and with q 8
# times the unit scale (with parts of 4,096 rows a CTA its dK missed
# ATTN_TOL against f64 by 1.15x).  Every call that may sum more than
# BWD_RUN_ROWS rows into one accumulator, or has a prefix, now flushes its
# sums every BWD_FLUSH_ROWS (256) rows.  "qwen3-0.6b q gain 8" and "mla q
# gain 8" are the two trainers' shapes whose walks fit one 4,096-row part
# (4,096 and 2,048 rows), at q 8 times the unit scale: qwen3-0.6b's missed
# ATTN_TOL against f64 on some draws without a flush, so it flushes too.
# "seamless encoder train" is the encoder's every-key call in
# seamless-m4t-large-v2's trainer (4 x 2048 frames, 16 heads on 16 KV heads
# of 64), plain and at q gain 8; "seamless cross train" is its
# cross-attention at the trainer's shape: the decoder's 2048 queries over the
# encoder's 2048 rows (prefix = T), keys and values drawn apart from the
# queries.  Inputs in the model's [B, S, heads, hd] memory, seen as [B, heads, S, hd]; dout too, all
# drawn from one generator in row order, so new rows go last and the other
# rows keep their inputs (flash_probe.py --bwd-run-rows also reads "q gain
# 8" on the inputs it gets with the paligemma rows drawn before it).  The
# last rows are the CUDA-core route at the reduced configs' widths
# (configs.reduced: hd 16, MLA's q/k 24 over v 16, which the kernels take
# at (32, 16) on q and k zero-padded to 32; hd 32 beside them): "... train"
# at the timing shape [4, 16, 2048, hd] on 8 KV heads (MLA's on 16), "G 8"
# on one KV head plain and at q gain 8, and f32 at hd 32.
BWD_CHECKS = (
    ("qwen3-0.6b train", 4, 16, 8, 2048, 2048, 128, 128, 0, 0, 0.0, 1.0, "bfloat16"),
    ("gemma-2b", 1, 8, 1, 2048, 2048, 256, 256, 0, 0, 0.0, 1.0, "bfloat16"),
    ("every key", 1, 16, 16, 4096, 4096, 64, 64, 0, 4096, 0.0, 1.0, "bfloat16"),
    ("mla 192/128", 1, 16, 16, 2048, 2048, 192, 128, 0, 0, 0.0, 1.0, "bfloat16"),
    ("window 2048", 1, 10, 1, 4096, 4096, 256, 256, 2048, 0, 0.0, 1.0, "bfloat16"),
    ("recurrentgemma train", 2, 10, 1, 4096, 4096, 256, 256, 2048, 0, 0.0, 1.0, "bfloat16"),
    ("prefix 256", 1, 8, 1, 768, 768, 256, 256, 0, 256, 0.0, 1.0, "bfloat16"),
    ("softcap 50", 1, 8, 1, 2048, 2048, 256, 256, 0, 0, 50.0, 8.0, "bfloat16"),
    ("q gain 8", 1, 8, 1, 2048, 2048, 256, 256, 0, 0, 0.0, 8.0, "bfloat16"),
    ("window 1000 hd 128", 1, 16, 8, 2048, 2048, 128, 128, 1000, 0, 0.0, 1.0, "bfloat16"),
    ("prefix 200 hd 64", 1, 8, 2, 700, 700, 64, 64, 0, 200, 0.0, 1.0, "bfloat16"),
    ("softcap 50 hd 128", 1, 8, 8, 1024, 1024, 128, 128, 0, 0, 50.0, 8.0, "bfloat16"),
    ("G 8 softcap 50 hd 128", 1, 8, 1, 2048, 2048, 128, 128, 0, 0, 50.0, 8.0, "bfloat16"),
    ("G 8 q gain 8 hd 64", 1, 8, 1, 2048, 2048, 64, 64, 0, 0, 0.0, 8.0, "bfloat16"),
    ("G 48 q gain 8 hd 128", 1, 48, 1, 2048, 2048, 128, 128, 0, 0, 0.0, 8.0, "bfloat16"),
    ("granite-moe train", 4, 24, 8, 2048, 2048, 64, 64, 0, 0, 0.0, 1.0, "bfloat16"),
    ("granite-moe q gain 8", 4, 24, 8, 2048, 2048, 64, 64, 0, 0, 0.0, 8.0, "bfloat16"),
    ("ragged", 2, 8, 2, 1000, 1000, 128, 128, 0, 0, 0.0, 1.0, "bfloat16"),
    ("S < T", 1, 8, 8, 300, 1000, 128, 128, 0, 0, 0.0, 1.0, "bfloat16"),
    ("cross S > T", 1, 16, 16, 300, 200, 64, 64, 0, 200, 0.0, 1.0, "bfloat16"),
    ("f32", 1, 16, 8, 512, 512, 128, 128, 0, 0, 0.0, 1.0, "float32"),
    ("f32 hd 256", 1, 8, 1, 300, 333, 256, 256, 0, 0, 0.0, 1.0, "float32"),
    ("paligemma train", 4, 8, 1, 2048, 2048, 256, 256, 0, 256, 0.0, 1.0, "bfloat16"),
    ("paligemma q gain 8", 4, 8, 1, 2048, 2048, 256, 256, 0, 256, 0.0, 8.0, "bfloat16"),
    ("qwen3-0.6b q gain 8", 4, 16, 8, 2048, 2048, 128, 128, 0, 0, 0.0, 8.0, "bfloat16"),
    ("mla q gain 8", 4, 16, 16, 2048, 2048, 192, 128, 0, 0, 0.0, 8.0, "bfloat16"),
    ("seamless encoder train", 4, 16, 16, 2048, 2048, 64, 64, 0, 2048, 0.0, 1.0, "bfloat16"),
    ("seamless encoder q gain 8", 4, 16, 16, 2048, 2048, 64, 64, 0, 2048, 0.0, 8.0,
     "bfloat16"),
    ("seamless cross train", 4, 16, 16, 2048, 2048, 64, 64, 0, 2048, 0.0, 1.0, "bfloat16"),
    ("hd 16 train", 4, 16, 8, 2048, 2048, 16, 16, 0, 0, 0.0, 1.0, "bfloat16"),
    ("hd 32 train", 4, 16, 8, 2048, 2048, 32, 32, 0, 0, 0.0, 1.0, "bfloat16"),
    ("mla reduced train", 4, 16, 16, 2048, 2048, 24, 16, 0, 0, 0.0, 1.0, "bfloat16"),
    ("G 8 hd 16", 1, 8, 1, 2048, 2048, 16, 16, 0, 0, 0.0, 1.0, "bfloat16"),
    ("G 8 q gain 8 hd 16", 1, 8, 1, 2048, 2048, 16, 16, 0, 0, 0.0, 8.0, "bfloat16"),
    ("G 8 hd 32", 1, 8, 1, 2048, 2048, 32, 32, 0, 0, 0.0, 1.0, "bfloat16"),
    ("G 8 q gain 8 hd 32", 1, 8, 1, 2048, 2048, 32, 32, 0, 0, 0.0, 8.0, "bfloat16"),
    ("f32 hd 32", 1, 8, 2, 512, 512, 32, 32, 0, 0, 0.0, 1.0, "float32"),
    ("mla reduced q gain 8", 4, 16, 16, 2048, 2048, 24, 16, 0, 0, 0.0, 8.0, "bfloat16"),
)
BWD_REPORT = "qwen3-0.6b train"  # the kernels line's shape of the tc route
BWD_SIMT_REPORT = "f32"  # and of the simt route (f32 only, since hd 256 went to tc)
# Further timing rows of the tc route: hd 256 (dkdv split over CTAs), (192, 128)
# and G 48 (dkdv split 16 ways, flushing).
BWD_TC_WIDE_REPORTS = ("gemma-2b", "mla 192/128", "G 48 q gain 8 hd 128")
# Timing rows of the simt route at the reduced configs' widths.
BWD_SIMT_NARROW_REPORTS = ("hd 16 train", "hd 32 train", "mla reduced train")
# The rows whose calls keep one run a CTA and no flush (their plan and bits
# before the flush: walks of at most BWD_RUN_ROWS, 2,048 rows, and no
# prefix); every other bf16 row flushes.
BWD_UNFLUSHED = ("mla 192/128", "softcap 50 hd 128", "S < T", "mla q gain 8")


def bwd_cost(b, h, kv, s, t, hd, hd_v, elem, window=0, prefix=0):
    """(bytes, flops) of the flash backward: q, k, v, o, do read once, dq,
    dk, dv written once; 2 (3 hd + 2 hd_v) flops (S = Q K^T, dP = dO V^T,
    dV, dQ, dK: 10 hd at equal widths) a visible (query, key) pair."""
    pairs = sum(min(t, max(i + t - s + 1, prefix), window or t) for i in range(s))
    return ((b * h * s * (2 * hd + 2 * hd_v) + b * kv * t * 2 * (hd + hd_v)) * elem,
            2 * (3 * hd + 2 * hd_v) * pairs * b * h)


def bwd_mask_kinds(window, prefix, t):
    """The mask kinds a backward call also counts its launch under."""
    return [kind for kind, on in (("windowed", window), ("prefix", prefix),
                                  ("full", prefix >= t)) if on]


def grads_close(torch, got, want):
    """(every one of dq, dk, dv within ``ATTN_TOL``, the largest max abs
    error, the largest relative L2 error)."""
    res = [attn_close(torch, g, w) for g, w in zip(got, want)]
    return (all(r[0] for r in res), max(r[1] for r in res), max(r[2] for r in res))


def _bwd_route_of(dtype, hd, hd_v):
    """The backward route a TMA-aligned call at these widths takes."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

    return "tc" if dtype == "bfloat16" and (hd, hd_v) in fab.BWD_TC_HEAD_PAIRS else "simt"


def forward_with_lse(torch, q, k, v, **mask):
    """The tensor-core forward's output and each row's log-sum-exp, at the
    blocks ``remop_flash_attention`` plans."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import plan_blocks

    bq, bk = plan_blocks(q.shape[2], k.shape[2], q.shape[3], 2, path="tc", hd_v=v.shape[3])
    with torch.no_grad():
        return fa.flash_attention(q, k, v, bq=bq, bk=bk, return_lse=True, **mask)


def phase_train_kernels(torch, device):
    """The flash backward kernel against its plain version at the shapes of
    ``BWD_CHECKS``, each on the route its dtype and widths give (asserted by
    the launch counters); two calls equal bit for bit (gemma-2b's with dkdv
    split over several CTAs a key block); the Function's forward equal to
    the no-grad forward bit for bit; the forward's lse against its plain
    version; seven planted faults rejected; registers and spills of every
    instantiation (none in what the plan launches); then the ``tc`` route
    timed at the training shape, gemma-2b's, MLA's and G 48's, and ``simt``
    at the f32 shape, beside each bound, plain version and SDPA's backward."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import remop_flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    errs, rows, kept = {}, {}, {}

    def model_layout(b, heads, s, hd, dtype, gain=1.0):
        x = torch.randn(b, s, heads, hd, device=device, generator=gen) * gain
        return x.to(getattr(torch, dtype)).transpose(1, 2)

    def bits(x):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)

    for (name, b, h, kv, s, t, hd, hd_v, window, prefix, cap, gain,
         dtype) in BWD_CHECKS:
        q = model_layout(b, h, s, hd, dtype, gain)
        k, v = model_layout(b, kv, t, hd, dtype), model_layout(b, kv, t, hd_v, dtype)
        mask = dict(window=window, prefix=prefix, softcap=cap)
        with torch.no_grad():
            out = remop_flash_attention(q, k, v, **mask)
        dout = model_layout(b, h, s, hd_v, dtype)
        path = fab.bwd_route(q, k, v, out, dout)
        check(path == _bwd_route_of(dtype, hd, hd_v),
              f"flash_attention_bwd {name}: route {path}")
        lse, blocks = None, fab.plan_bwd_blocks(hd, hd_v, q.element_size())
        if path == "tc":
            out_lse, lse = forward_with_lse(torch, q, k, v, **mask)
            check(torch.equal(bits(out_lse), bits(out)),
                  f"flash_attention {name}: the forward writing lse changed its output")
            blocks = fab.plan_bwd_tc_blocks(hd, hd_v, cap > 0)
            blocks["kv_split"] = fab.bwd_tc_kv_split(b, h, kv, s, t, hd, hd_v, prefix)
            blocks["flush_steps"] = fab.plan_bwd_flush_steps(h // kv, s, blocks["dkdv"][1],
                                                             prefix)
            check((blocks["flush_steps"] == 0) == (name in BWD_UNFLUSHED),
                  f"flash_attention_bwd {name}: flush steps {blocks['flush_steps']}")
        before = dict(runtime.launches)
        got = fab.flash_attention_bwd(q, k, v, out, dout, **mask, lse=lse)
        again = fab.flash_attention_bwd(q, k, v, out, dout, **mask, lse=lse)
        added = {key: n - before.get(key, 0) for key, n in runtime.launches.items()
                 if n != before.get(key, 0)}
        want_added = {"flash_attention_bwd": 2, f"flash_attention_bwd_{path}": 2,
                      **{f"flash_attention_bwd_{kind}": 2 for kind in bwd_mask_kinds(
                          window, prefix, t)}}
        check(added == want_added,
              f"flash_attention_bwd {name}: launches {added}, not {want_added}")
        same = all(torch.equal(bits(a), bits(c)) for a, c in zip(got, again))
        check(same, f"flash_attention_bwd {name}: two calls differ")
        check(all(g.shape == x.shape and g.dtype == x.dtype for g, x in zip(got, (q, k, v))),
              f"flash_attention_bwd {name}: gradients not in their inputs' shapes and dtypes")
        want = fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)
        ok, err, rel = grads_close(torch, got, want)
        key = f"flash_attention_bwd_{path}"
        errs[key] = max(errs.get(key, 0.0), err)
        emit({"phase": "train", "check": "flash_attention_bwd", "case": name, "route": path,
              "shape": [b, h, kv, s, t, hd, hd_v], "dtype": dtype, **mask, "q_gain": gain,
              "blocks": blocks, "tol": ATTN_TOL[str(q.dtype)], "max_abs_err": err, "rel_err": rel,
              "per_grad_rel_err": [rel_err(torch, g, w) for g, w in zip(got, want)],
              "per_grad_tol_excess": [tol_excess(torch, g, w) for g, w in zip(got, want)],
              "equal_bits_twice": same})
        check(ok, f"flash_attention_bwd {name}: kernel differs from its plain version beyond "
                  f"ATTN_TOL (max abs err {err}, relative L2 {rel})")
        if name in ("gemma-2b", "G 8 softcap 50 hd 128", "G 8 q gain 8 hd 64"):
            check(blocks["kv_split"] > 1, f"{name}'s dkdv is not split: {blocks}")
        if name in ("qwen3-0.6b train", "prefix 256", "softcap 50", "prefix 200 hd 64",
                    "gemma-2b", "mla 192/128", "G 8 hd 16", "mla reduced train"):
            kept[name] = (q, k, v, out, dout, mask, got, lse)
        if name == "qwen3-0.6b train":
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            fn_out = remop_flash_attention(qg, kg, vg)
            check(fn_out.grad_fn is not None and torch.equal(fn_out.detach(), out),
                  "FlashAttentionFn's forward differs from the no-grad forward")
            emit({"phase": "train", "check": "function_forward", "case": name,
                  "equal_bits_to_no_grad": True, "grad_fn": type(fn_out.grad_fn).__name__})
            del qg, kg, vg, fn_out
        del got, again, want

    # The forward's lse (tensor-core route) against its plain version, f32.
    for name in ("qwen3-0.6b train", "prefix 200 hd 64", "gemma-2b", "mla 192/128"):
        q, k, v, _, _, mask, _, _ = kept[name]
        _, lse = forward_with_lse(torch, q, k, v, **mask)
        _, want = flash_attention_plain(q, k, v, **mask, return_lse=True)
        ok, err, rel, _ = attn_close(torch, lse, want)
        errs["flash_attention_bwd_tc"] = max(errs["flash_attention_bwd_tc"], err)
        emit({"phase": "train", "check": "forward_lse", "case": name, "shape": list(lse.shape),
              "tol": ATTN_TOL["torch.float32"], "max_abs_err": err, "rel_err": rel})
        check(ok, f"flash_attention {name}: lse differs from its plain version (max abs err "
                  f"{err}, relative L2 {rel})")

    # The forward at reduced MLA's (24, 16): the CUDA-core kernel at (32, 16)
    # on q and k zero-padded to 32, counted under its logical widths.
    q, k, v, _, _, mask, _, _ = kept["mla reduced train"]
    before = dict(runtime.launches)
    with torch.no_grad():
        got = remop_flash_attention(q, k, v, **mask)
    added = {key: n - before.get(key, 0) for key, n in runtime.launches.items()
             if n != before.get(key, 0)}
    want_added = {"flash_attention": 1, "flash_attention_simt": 1,
                  "flash_attention_simt_24x16": 1}
    ok, err, rel, _ = attn_close(torch, got, flash_attention_plain(q, k, v, **mask))
    emit({"phase": "train", "check": "flash_attention", "case": "mla reduced train",
          "shape": list(q.shape) + [v.shape[3]], "launches": added,
          "tol": ATTN_TOL["torch.bfloat16"], "max_abs_err": err, "rel_err": rel})
    check(added == want_added, f"flash_attention at (24, 16): launches {added}, not {want_added}")
    check(ok, f"flash_attention at (24, 16) differs from its plain version (max abs err {err}, "
              f"relative L2 {rel})")

    def fault(name, what, want, got=None):
        got = kept[name][6] if got is None else got
        ok, err, rel = grads_close(torch, got, want)
        emit({"phase": "train", "planted_fault": "flash_attention_bwd", "case": name,
              "fault": what, "max_abs_err": err, "rel_err": rel, "rejected": not ok})
        check(not ok, f"flash_attention_bwd: ATTN_TOL passes a backward that {what}")

    q, k, v, out, dout, mask, _, lse = kept["qwen3-0.6b train"]
    fault("qwen3-0.6b train", "drops D = sum(dO * O)",
          fab.flash_attention_bwd_plain(q, k, v, torch.zeros_like(out), dout, **mask))
    q, k, v, out, dout, mask, _, _ = kept["G 8 hd 16"]
    fault("G 8 hd 16", "drops D = sum(dO * O) (the simt kernel at hd 16)",
          fab.flash_attention_bwd_plain(q, k, v, torch.zeros_like(out), dout, **mask))
    q, k, v, out, dout, mask, _, lse = kept["qwen3-0.6b train"]
    g = q.shape[1] // k.shape[1]
    _, dk0, dv0 = fab.flash_attention_bwd_plain(q[:, ::g], k, v, out[:, ::g], dout[:, ::g],
                                                **mask)
    dq_ok = fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)[0]
    fault("qwen3-0.6b train", "sums dK and dV over head 0 of each group only", (dq_ok, dk0, dv0))
    shifted = fab.flash_attention_bwd(q, k, v, out, dout, **mask, lse=torch.roll(lse, 1, dims=2))
    fault("qwen3-0.6b train", "reads the lse of the row before (the tc kernel)",
          fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask), got=shifted)
    del shifted
    q, k, v, out, dout, mask, _, _ = kept["prefix 256"]
    fault("prefix 256", "shows every query the key one past the prefix",
          fab.flash_attention_bwd_plain(q, k, v, out, dout, **{**mask, "prefix": 257}))
    q, k, v, out, dout, mask, _, _ = kept["softcap 50"]
    cap_grad = fab.cap_grad
    fab.cap_grad = lambda capped, softcap: torch.ones_like(capped)
    try:
        want = fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)
    finally:
        fab.cap_grad = cap_grad
    fault("softcap 50", "leaves out the cap's derivative", want)
    # The split's sum, planted through the kernel's own pieces: dkdv's
    # partials of gemma-2b summed without the last one, then without dK's scale.
    q, k, v, out, dout, mask, got, lse = kept["gemma-2b"]
    scale = 1.0 / math.sqrt(q.shape[3])
    dq_, dk_, dv_, part, n_split = fab.bwd_tc_launch(q, k, v, out, dout, lse, scale, **mask)
    fab.kv_reduce(part, dk_, dv_, n_split, scale)
    check(n_split > 1 and all(torch.equal(bits(a), bits(c)) for a, c in zip((dq_, dk_, dv_), got)),
          "gemma-2b: the backward's pieces (dkdv's partials, their sum) differ from the call")
    want = fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)
    fab.kv_reduce(part, dk_, dv_, n_split - 1, scale)
    fault("gemma-2b", f"drops the last of {n_split} split partials of dK and dV", want,
          got=(dq_, dk_, dv_))
    fab.kv_reduce(part, dk_, dv_, n_split, 1.0)
    fault("gemma-2b", "drops dK's scale in the split's sum", want, got=(dq_, dk_, dv_))
    del kept, want, dq_ok, dk0, dv0, dq_, dk_, dv_, part

    emit({"phase": "train", "flash_attention_bwd_instantiations": {
        f"{dt} {hd}x{hd_v}": fab.bwd_attributes(getattr(torch, dt), hd, hd_v)
        for dt in ("bfloat16", "float32") for hd, hd_v in fab.BWD_HEAD_PAIRS}})
    tc_inst = {}
    for (hd, hd_v), table in fab.BWD_TC_BLOCKS.items():
        for blocks in table["dkdv"]:
            for capped in (False, True):
                for flush in (False, True):
                    tc_inst[f"{hd}x{hd_v} dkdv {list(blocks)}{' capped' if capped else ''}"
                            f"{' flush' if flush else ''}"] = fab.bwd_tc_attributes(
                        hd, hd_v, capped, {"dq": table["dq"][0], "dkdv": blocks}, flush)
    emit({"phase": "train", "flash_attention_bwd_tc_instantiations": tc_inst})
    for (hd, hd_v), table in fab.BWD_TC_BLOCKS.items():
        for capped in (False, True):
            for flush in (False, True):
                plan = fab.plan_bwd_tc_blocks(hd, hd_v, capped)
                attrs = fab.bwd_tc_attributes(hd, hd_v, capped, plan, flush)
                check(all(attrs[kernel]["local_bytes"] == 0 for kernel in fab.BWD_TC_KERNELS),
                      f"the tc plan at {(hd, hd_v)}{' capped' if capped else ''}"
                      f"{' flushing' if flush else ''} launches an instantiation that spills: "
                      f"{attrs}; add it to BWD_TC_SPILLS")

    # Timing of each route at its report shape (bwd_timing).
    bench = Bench(torch, device)

    def timing(path, report):
        return bwd_timing(torch, device, bench, gen, report, path)

    for path, report in (("tc", BWD_REPORT), ("simt", BWD_SIMT_REPORT)):
        rows[f"flash_attention_bwd_{path}"] = timing(path, report)
        emit({"phase": "train", "timing": "flash_attention_bwd", "route": path, "case": report,
              **rows[f"flash_attention_bwd_{path}"]})
    for report in BWD_TC_WIDE_REPORTS:
        emit({"phase": "train", "timing": "flash_attention_bwd", "route": "tc", "case": report,
              **timing("tc", report)})
    for report in BWD_SIMT_NARROW_REPORTS:
        emit({"phase": "train", "timing": "flash_attention_bwd", "route": "simt",
              "case": report, **timing("simt", report)})
    del bench
    return errs, rows


def bwd_timing(torch, device, bench, gen, report, path="tc"):
    """The backward at ``BWD_CHECKS``' row ``report`` (its mask and q
    gain): the kernel's event and device ms beside its bound, its plain
    version and SDPA's backward (``torch.autograd.grad`` of one GQA call,
    causal, with the band or the prefix-LM mask as a bool ``attn_mask``
    where the row has a window or a prefix, ``is_causal=False`` where the
    prefix covers every key) on the same inputs, in the model's layout."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention.ops import remop_flash_attention

    (_, b, h, kv, s, t, hd, hd_v, window, prefix, cap, gain, dtype), = (
        c for c in BWD_CHECKS if c[0] == report)
    check(not cap and s == t, f"bwd_timing takes no cap and S = T only: {report}")
    mask = dict(window=window, prefix=prefix)

    def model_layout(heads, n, width, scale=1.0):
        x = torch.randn(b, n, heads, width, device=device, generator=gen) * scale
        return x.to(getattr(torch, dtype)).transpose(1, 2)

    q, k, v = model_layout(h, s, hd, gain), model_layout(kv, t, hd), model_layout(kv, t, hd_v)
    with torch.no_grad():
        out = remop_flash_attention(q, k, v, **mask)
    lse = forward_with_lse(torch, q, k, v, **mask)[1] if path == "tc" else None
    dout = model_layout(h, s, hd_v)
    check(fab.bwd_route(q, k, v, out, dout) == path, f"the {report} timing is not {path}")
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    if prefix >= t:  # every key
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=False, enable_gqa=True)
    elif window or prefix:
        pos = torch.arange(s, device=device)
        seen = pos[:, None] >= pos[None, :]
        if window:
            seen &= pos[:, None] - pos[None, :] < window
        seen |= pos[None, :] < prefix
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=seen, enable_gqa=True)
    else:
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    def kernel():
        return fab.flash_attention_bwd(q, k, v, out, dout, **mask, lse=lse)

    def library():
        return torch.autograd.grad(lib_out, (qs, ks, vs), dout, retain_graph=True)

    elem = q.element_size()
    cost = bwd_cost(b, h, kv, s, t, hd, hd_v, elem, **mask)
    ms_bound, by = bound(*cost, BF16_OPS_PER_S if elem == 2 else ALU_OPS_PER_S)
    # The simt route multiplies in f32 on the CUDA cores, bf16 inputs too:
    # beside the bound at the inputs' type, the one at the CUDA cores' rate.
    cores = {"cuda_core_bound_ms": bound(*cost)[0]} if path == "simt" else {}
    if path == "tc":
        blocks = fab.plan_bwd_tc_blocks(hd, hd_v)
        blocks["kv_split"] = fab.bwd_tc_kv_split(b, h, kv, s, t, hd, hd_v, prefix)
        blocks["flush_steps"] = fab.plan_bwd_flush_steps(h // kv, s, blocks["dkdv"][1], prefix)
    else:
        blocks = fab.plan_bwd_blocks(hd, hd_v, elem)
    kind = f"window {window}" if window else f"prefix {prefix}" if prefix else "causal"
    return dict(
        shape=f"q [{b},{h},{s},{hd}], k [{b},{kv},{t},{hd}], v [{b},{kv},{t},{hd_v}] "
              f"{dtype}, {kind}, q gain {gain}, the model's layout, route {path}, blocks "
              f"{blocks}",
        ms=bench.ms(kernel), **bench.device_ms(kernel, reps=10),
        plain_ms=bench.ms(lambda: fab.flash_attention_bwd_plain(q, k, v, out, dout, **mask)),
        library_ms=bench.ms(library),
        **{f"library_{name}": val for name, val in bench.device_ms(library, reps=10).items()},
        bound_ms=ms_bound, bound_by=by, **cores)


# One qwen3-0.6b block at full width under training: f32 masters, bf16
# activations; parameter and input gradients through the kernels against
# the plain path (the flash kernel's plain forward and plain backward on
# the card, plain_flash_training), per leaf.  Set before the first card run: the two forwards differ by an ulp
# of bf16 here and there (the tensor-core kernel against the plain f32
# softmax), which the backward carries into every gradient at about 1e-3.
TRAIN_LAYER_BATCH, TRAIN_LAYER_SEQ = 4, 2048
TRAIN_LAYER_TOL = 1e-2
# The trainer: launch.train's command line at full width, without
# checkpoints; then repro's fixed-batch rule; then, at the published widths
# cut to TRAIN_RESUME_LAYERS layers (a checkpoint of all 28 layers' state is
# 7.15 GB, of 2 layers 2.2 GB), a resume of steps 11..20 from the step-10
# checkpoint, whose losses must equal the first run's within
# TRAIN_RESUME_TOL relative (the same bits but for the order of the
# embedding's gradient sum).
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10
TRAIN_ARGV = ("--arch", TRAIN_ARCH, "--global-batch", "4", "--seq-len", "2048", "--steps",
              str(TRAIN_STEPS), "--checkpoint-every", str(TRAIN_CKPT_EVERY), "--seed", "0")
TRAIN_RESUME_LAYERS = 2
TRAIN_RESUME_TOL = 1e-5
FIXED_BATCH_STEPS, FIXED_BATCH_RULE = 30, 0.7


@contextlib.contextmanager
def plain_flash_training(forward: bool = True, backward: bool = True, key_blocks: int = 1):
    """``FlashAttentionFn`` on the flash kernel's plain forward and plain
    backward while the context lasts, CUDA tensors included: the training
    checks' reference path (each kernel replaced by its plain version);
    ``forward``/``backward`` False keeps that half on the kernel (which
    then reads the plain forward's lse); ``key_blocks`` times the call's
    key block in the plain forward sums its f32 softmax in another order."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain

    saved = fab.flash_attention, fab.flash_attention_bwd

    def plain_fwd(q, k, v, bq=None, bk=64, scale=None, window=0, prefix=0, softcap=0.0,
                  return_lse=False):
        return flash_attention_plain(q, k, v, bk * key_blocks, scale, window, prefix, softcap,
                                     return_lse)

    def plain_bwd(q, k, v, out, dout, scale, window, prefix, softcap, lse=None):
        # The reference recomputes each row's log-sum-exp.
        return fab.flash_attention_bwd_plain(q, k, v, out, dout, scale, window, prefix, softcap)

    fab.flash_attention, fab.flash_attention_bwd = (
        plain_fwd if forward else saved[0], plain_bwd if backward else saved[1])
    try:
        yield
    finally:
        fab.flash_attention, fab.flash_attention_bwd = saved


def planted_in_backward(wrap):
    """A planted fault as a context manager: while it lasts, the flash
    backward's wrapper is ``wrap`` of it (``wrap``'s name and doc kept)."""
    @contextlib.contextmanager
    def plant():
        from repro_torch.kernels.flash_attention import flash_attention_bwd as fab

        bwd = fab.flash_attention_bwd
        fab.flash_attention_bwd = wrap(bwd)
        try:
            yield
        finally:
            fab.flash_attention_bwd = bwd
    return functools.wraps(wrap)(plant)


@planted_in_backward
def drop_delta(bwd):
    """The backward with D dropped from its inputs (its ``out`` zeroed)."""
    def faulty(q, k, v, out, dout, *args):
        return bwd(q, k, v, out.new_zeros(out.shape), dout, *args)
    return faulty


@planted_in_backward
def window_zero(bwd):
    """The backward handed ``window = 0`` whatever its forward saw."""
    def faulty(q, k, v, out, dout, scale, window, *args):
        return bwd(q, k, v, out, dout, scale, 0, *args)
    return faulty


@planted_in_backward
def prefix_zero(bwd):
    """The backward handed ``prefix = 0`` whatever its forward saw."""
    def faulty(q, k, v, out, dout, scale, window, prefix, *args):
        return bwd(q, k, v, out, dout, scale, window, 0, *args)
    return faulty


@contextlib.contextmanager
def cross_prefix_zero():
    """Every cross-attention call's backward handed ``prefix = 0`` (causal)
    whatever its forward saw, while the context lasts: each
    ``attention.gqa_forward`` over an encoder's output (``xa``, every key
    seen) runs its flash call through a ``FlashAttentionFn`` whose forward
    saves prefix 0 for the backward; the encoder's every-key calls and the
    decoder's causal ones are untouched."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention

    class CausalBackward(fab.FlashAttentionFn):
        @staticmethod
        def forward(ctx, *args):
            out = fab.FlashAttentionFn.forward(ctx, *args)
            scale, window, _, softcap = ctx.args
            ctx.args = (scale, window, 0, softcap)
            return out

    gqa = attention.gqa_forward

    def gqa_forward(*args, xa=None, **kwargs):
        if xa is None:
            return gqa(*args, **kwargs)
        fn, ops.FlashAttentionFn = ops.FlashAttentionFn, CausalBackward
        try:
            return gqa(*args, xa=xa, **kwargs)
        finally:
            ops.FlashAttentionFn = fn

    attention.gqa_forward = gqa_forward
    try:
        yield
    finally:
        attention.gqa_forward = gqa


def block_bwd_calls(kind, window, prefix, s, t_enc):
    """(window, prefix, T) of each flash backward one ``kind`` block takes
    at ``s`` query rows: a ``"cross"`` block its causal self-attention and
    its cross-attention over ``t_enc`` encoder rows (every key), an
    ``"enc"`` block every key of its own."""
    if kind == "cross":
        return [(0, 0, s), (0, t_enc, t_enc)]
    return [(window, s if kind == "enc" else prefix, s)]


def train_layer_errors(torch, device, fault=None, arch=TRAIN_ARCH, kind="attn",
                       tokens=(TRAIN_LAYER_BATCH, TRAIN_LAYER_SEQ), prefix=0):
    """Per-leaf relative L2 of one ``kind`` block's parameter and input
    gradients at ``arch``'s widths, kernel path against plain path, at
    ``tokens`` = (batch, sequence), every query seeing the first ``prefix``
    keys (a ``"cross"`` block over an encoder output of as many rows, drawn
    apart from its input, whose gradient is a leaf too); ``fault`` is a
    planted fault's context (:func:`drop_delta` and the like)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    cfg = ARCHS[arch]
    gen = torch.Generator(device=device).manual_seed(SEED)
    with layers.matrix_dtype(torch.float32):
        block = tf.init_block(cfg, gen, device, kind)
    b, s = tokens
    x = torch.randn(b, s, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    w = torch.randn(b, s, cfg.d_model, device=device, generator=gen)
    pos = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    enc = None
    if kind == "cross":
        apart = torch.Generator(device=device).manual_seed(SEED + 1)
        enc = torch.randn(b, s, cfg.d_model, device=device, generator=apart).to(torch.bfloat16)

    def grads():
        live = tree_map(lambda t: t.detach().clone().requires_grad_(), block)
        xg = x.clone().requires_grad_()
        eg = None if enc is None else enc.clone().requires_grad_()
        out, _, _ = tf.block_forward(live, cfg, kind, xg, pos, prefix=prefix, enc_out=eg)
        return torch.autograd.grad((out.float() * w).sum(),
                                   leaves(live) + [xg] + ([] if eg is None else [eg]))

    before = dict(runtime.launches)
    with fault() if fault else contextlib.nullcontext():
        got = grads()
    added = {k: n - before.get(k, 0) for k, n in runtime.launches.items()
             if k.startswith("flash_attention_bwd") and n != before.get(k, 0)}
    calls = block_bwd_calls(kind, tf._window(cfg, kind), prefix, s, s)
    want_added = collections.Counter({"flash_attention_bwd": len(calls),
                                      "flash_attention_bwd_tc": len(calls)})
    for window_, prefix_, t in calls:
        want_added.update(f"flash_attention_bwd_{m}"
                          for m in bwd_mask_kinds(window_, prefix_, t))
    check(fault is not None or added == dict(want_added),
          f"the {kind} block's backward launched {added}, not {dict(want_added)}")
    with plain_flash_training():
        want = grads()
    names = ["/".join(p) for p, _ in leaves_with_paths(block)] + ["x"] + (
        [] if enc is None else ["enc_out"])
    return {n: rel_err(torch, g.float(), w_.float()) for n, g, w_ in zip(names, got, want)}


def phase_train_layer(torch, device):
    errs = train_layer_errors(torch, device)
    emit({"phase": "train", "layer_check": TRAIN_ARCH, "tokens": [TRAIN_LAYER_BATCH,
                                                                 TRAIN_LAYER_SEQ],
          "per_leaf_rel_err": errs, "max_rel_err": max(errs.values()), "tol": TRAIN_LAYER_TOL})
    check(max(errs.values()) <= TRAIN_LAYER_TOL,
          f"{TRAIN_ARCH} block gradients: kernel path against plain path {max(errs.values())} "
          f"beyond {TRAIN_LAYER_TOL}")
    bad = train_layer_errors(torch, device, fault=drop_delta)
    emit({"phase": "train", "planted_fault": "layer", "fault": "the backward kernel drops D",
          "max_rel_err": max(bad.values()), "rejected": max(bad.values()) > TRAIN_LAYER_TOL})
    check(max(bad.values()) > TRAIN_LAYER_TOL, "the layer check passes a backward without D")
    torch.cuda.empty_cache()


def train_model_flops(cfg, params, b, s) -> float:
    """Model FLOPs of one training step (forward and backward, no remat):
    3 x (2 x the matrix parameters x tokens, the tied unembedding once, plus
    the attention's 4 hd H flops a visible pair a layer)."""
    from repro_torch.tree import leaves

    matrices = sum(x.numel() for x in leaves(params) if x.dim() == 2)
    pairs = s * (s + 1) // 2
    attention = 4 * cfg.head_dim * cfg.n_heads * pairs * b * cfg.n_layers
    return 3.0 * (2.0 * matrices * b * s + attention)


# A training step's kernels by kind, beside products, the optimizer and the
# rest: (kind, substrings of its kernels' names), the first that matches.
FLASH_KINDS = (("flash_backward", ("prep_kernel", "dq_kernel", "dkdv_kernel", "dq_tc_kernel",
                                   "dkdv_tc_kernel", "dkdv_wg_kernel", "kv_reduce_kernel")),
               ("flash_forward", ("flash_attention_kernel",)))
SCAN_KINDS = (("scan_backward", ("ssd_scan_bwd_kernel", "ssd_scan_bwd_reduce_kernel")),
              ("scan", ("ssd_scan_kernel",)))


def train_breakdown(torch, step_fn, state, batch, kernel_kinds=FLASH_KINDS, rglru=False):
    """One profiled training step: device seconds by kind (products, the
    ``kernel_kinds``, the optimizer, the rest) and the idle share, beside
    the same step unprofiled; with ``rglru`` the RG-LRU's scan, its other
    elementwise work and its products apart, each with the backward of its
    ops (:func:`ranged_kernels` over ``HYBRID_RANGES``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps as steps_lib

    def step():
        t0 = time.perf_counter()
        out, metrics = step_fn(state, batch)
        float(metrics["loss_total"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    from repro_torch.models import rglru as rglru_mod

    unprofiled, _ = step()
    updates = ("adamw_update", "adamw_update_")  # the pure step's, the donating step's
    with annotated(steps_lib, updates), annotated(rglru_mod, HYBRID_RANGES if rglru else ()):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled, _ = step()
        optimizer = sum(v for k, v in ranged_kernels(torch, prof, updates).items()
                        if not k.endswith("_kernels"))
    kinds = {"products": 0.0, **{kind: 0.0 for kind, _ in kernel_kinds}, "other": 0.0}
    others = collections.Counter()
    events = 0
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        name, us = e.key.lower(), e.self_device_time_total / 1e6
        events += e.count
        kind = next((k for k, words in kernel_kinds if any(w in name for w in words)), None)
        if kind:
            kinds[kind] += us
        elif any(w in name for w in MATMUL_NAMES):
            kinds["products"] += us
        else:
            kinds["other"] += us
            others[e.key[:80]] += us
    kinds["optimizer"] = optimizer
    kinds["elementwise"] = kinds.pop("other") - optimizer
    split = {}
    if rglru:
        rec = ranged_kernels(torch, prof, HYBRID_RANGES)
        scan, products = rec["associative_scan_other"], sum(
            rec[f"{name}_matmul"] for name in HYBRID_RANGES)
        check(scan + rec["rglru_forward_other"] <= kinds["elementwise"] * (1 + 1e-6)
              and products <= kinds["products"] * (1 + 1e-6),
              f"RG-LRU ranges {rec} exceed the step's {kinds}")
        kinds.update(rglru_scan=scan, rglru_other_elementwise=rec["rglru_forward_other"],
                     rglru_products=products, products=kinds["products"] - products,
                     elementwise=kinds["elementwise"] - scan - rec["rglru_forward_other"])
        split = {"rglru_split": "measured" if scan > 0 else "not measured",
                 "rglru_scan_kernels": rec["associative_scan_kernels"],
                 "rglru_outside_scan_kernels": rec["rglru_forward_kernels"]}
    return {"unprofiled_step_seconds": unprofiled, "profiled_step_seconds": profiled,
            **busy_and_idle((kinds, events), profiled, unprofiled), **split,
            "largest_other_kernels_seconds": dict(others.most_common(8))}


# gemma-2b's training main path: launch.train at its published widths (hd
# 256, 8 heads on one KV head: the tc route with dkdv split over CTAs) with
# the depth cut to TRAIN_GEMMA_LAYERS.
TRAIN_GEMMA_LAYERS, TRAIN_GEMMA_STEPS = 2, 3
TRAIN_GEMMA_ARGV = ("--arch", "gemma-2b", "--reduced", "--reduced-overrides",
                    f"n_layers={TRAIN_GEMMA_LAYERS},d_model=2048,n_heads=8,n_kv_heads=1,"
                    "head_dim=256,d_ff=16384,vocab_size=256000", "--global-batch", "1",
                    "--seq-len", "2048", "--steps", str(TRAIN_GEMMA_STEPS), "--checkpoint-every",
                    "1000", "--seed", "0")


def phase_train_gemma_tc_run(torch, device):
    """Train gemma-2b (hd 256, one KV head) at its published widths, cut to
    TRAIN_GEMMA_LAYERS layers, for TRAIN_GEMMA_STEPS steps through
    ``launch.train.main``, the launch counters set to 0 just before and read
    just after: every backward launch on the ``tc`` route, the losses
    finite, the median step seconds printed.  Then the ``simt`` route's
    main path, which no model trains on any more (every model's activations
    are bf16 at a width the ``tc`` route takes): one f32 call of
    ``remop_flash_attention`` under autograd at ``BWD_SIMT_REPORT``'s
    shape, the counters set to 0 just before its backward and read just
    after.  Returns the launches of both runs."""
    import statistics as stats

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention.ops import remop_flash_attention
    from repro_torch.launch import train as train_mod

    argv = [*TRAIN_GEMMA_ARGV, "--device", str(device)]
    cfg = train_mod.setup(train_mod.parse_args(argv))[0]
    full = ARCHS["gemma-2b"]
    check(all(getattr(cfg, f) == getattr(full, f) for f in
              ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size")),
          "the gemma-2b trainer's config is not gemma-2b's widths")
    log = {}
    runtime.reset_launches()
    t0 = time.perf_counter()
    state, losses = train_mod.main(argv, metrics_cb=lambda step, m: log.__setitem__(
        step, (time.perf_counter(), float(m["loss_total"]))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launches)
    del state
    torch.cuda.empty_cache()
    bwd_calls = TRAIN_GEMMA_STEPS * TRAIN_GEMMA_LAYERS
    steps = sorted(log)
    median = stats.median(log[s][0] - log[s - 1][0] for s in steps[1:])
    emit({"phase": "train", "gemma_tc_trainer": "gemma-2b", "layers": TRAIN_GEMMA_LAYERS,
          "tokens_per_step": int(TRAIN_GEMMA_ARGV[TRAIN_GEMMA_ARGV.index("--seq-len") + 1]),
          "losses": losses, "wall_seconds": wall, "step_seconds_median": median,
          "launches": launches})
    print(f"gemma-2b tc trainer: median step {median:.4f} s", flush=True)
    check(all(math.isfinite(x) for x in losses), "the gemma-2b trainer's loss is not finite")
    check(launches.get("flash_attention_bwd") == launches.get("flash_attention_bwd_tc")
          == bwd_calls and "flash_attention_bwd_simt" not in launches,
          f"the gemma-2b trainer launched the backward {launches}; want {bwd_calls}, all tc")

    (_, b, h, kv, s, t, hd, hd_v, *_), = (c for c in BWD_CHECKS if c[0] == BWD_SIMT_REPORT)
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = (torch.randn(b, n, length, w, device=device, generator=gen).requires_grad_()
               for n, length, w in ((h, s, hd), (kv, t, hd), (kv, t, hd_v)))
    out = remop_flash_attention(q, k, v)
    runtime.reset_launches()
    grads = torch.autograd.grad(out, (q, k, v), torch.randn_like(out))
    torch.cuda.synchronize()
    simt = dict(runtime.launches)
    emit({"phase": "train", "simt_main_path": "remop_flash_attention f32 under autograd",
          "shape": [b, h, kv, s, t, hd, hd_v], "launches": simt,
          "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads)})
    check(simt == {"flash_attention_bwd": 1, "flash_attention_bwd_simt": 1}
          and all(bool(torch.isfinite(g).all()) for g in grads),
          f"the f32 backward launched {simt}, not one simt launch, or its gradients are not "
          "finite")
    launches["flash_attention_bwd_simt"] = simt["flash_attention_bwd_simt"]
    return launches


def train_window(torch, device, argv):
    """``launch.train.main(argv + ["--device", device])``, the launch
    counters set to 0 just before and read just after, the peak memory
    reset before: every loss and grad norm finite.  Returns the run: its
    final state, launches, logged values, step seconds (median of steps 3
    on), wall seconds, peak memory and parsed setup."""
    import statistics as stats

    from repro_torch.kernels import runtime
    from repro_torch.launch import train as train_mod

    argv = [*argv, "--device", str(device)]
    log = {}

    def record(step, m):
        log[step] = (time.perf_counter(), float(m["loss_total"]), float(m["grad_norm"]),
                     float(m["lr"]))

    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    t0 = time.perf_counter()
    state, _ = train_mod.main(argv, metrics_cb=record)
    torch.cuda.synchronize()
    run = {"wall": time.perf_counter() - t0, "launches": dict(runtime.launches),
           "peak": torch.cuda.max_memory_allocated(), "state": state}
    args = train_mod.parse_args(argv)
    steps = sorted(log)
    check(steps == list(range(1, args.steps + 1)) and int(state["step"]) == args.steps,
          f"the trainer logged steps {steps}")
    run.update(loss=[log[s][1] for s in steps], gnorm=[log[s][2] for s in steps],
               lr=[log[s][3] for s in steps],
               step_s=stats.median(log[s][0] - log[s - 1][0] for s in steps[2:]))
    check(all(math.isfinite(x) for x in run["loss"] + run["gnorm"]),
          "a loss or grad norm is not finite")
    cfg, shape, opt_cfg, _ = train_mod.setup(args)
    run.update(args=args, cfg=cfg, shape=shape, opt_cfg=opt_cfg)
    return run


def train_and_resume(torch, device, argv, ckpt_name: str):
    """:func:`train_window` with checkpoints under the gitignored
    ``kernels/_build/<ckpt_name>`` (``disk_free_gb`` printed first; the
    trainer's store writes only the step-``TRAIN_CKPT_EVERY`` checkpoint of
    the three its loop asks for, 10, 20 and 20 again: a card's machine may
    write 45 GiB to its disk a run, and recurrentgemma-2b's 3 layers take
    10.95 GB a checkpoint), then steps ``TRAIN_CKPT_EVERY + 1 ..
    TRAIN_STEPS`` again from that checkpoint through the donating step,
    whose losses must equal the first run's within ``TRAIN_RESUME_TOL`` (the
    ``resume_from_step`` line).  Returns the run (its ``checkpoints`` too)."""
    import shutil

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.pipeline import PrefetchingLoader, synthetic_batches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.train_loop import LoopConfig, train

    class ResumeStore(CheckpointStore):
        def save(self, step, state, metadata=None, blocking=True):
            if step == TRAIN_CKPT_EVERY:
                super().save(step, state, metadata, blocking)

    ckpt = ROOT / "src" / "repro_torch" / "kernels" / "_build" / ckpt_name
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = [*argv, "--ckpt-dir", str(ckpt)]
    emit({"phase": "train", "argv": argv, "disk_free_gb": shutil.disk_usage(ROOT).free / 1e9})
    train_mod.CheckpointStore = ResumeStore
    try:
        run = train_window(torch, device, argv)
    finally:
        train_mod.CheckpointStore = CheckpointStore
    run["checkpoints"] = {f: os.path.getsize(ckpt / f) for f in sorted(os.listdir(ckpt))}
    state, cfg, shape, args = run["state"], run["cfg"], run["shape"], run["args"]

    # Resume: the step-10 checkpoint into the final state's structure, then
    # steps 11..20 again.
    store = CheckpointStore(str(ckpt))
    t1 = time.perf_counter()
    mid, meta = store.restore(TRAIN_CKPT_EVERY, state)
    restore_s = time.perf_counter() - t1
    check(int(mid["step"]) == TRAIN_CKPT_EVERY and meta["step"] == TRAIN_CKPT_EVERY,
          "the step-10 checkpoint holds another step")
    step_fn = steps_lib.make_train_step(cfg, run["opt_cfg"], microbatches=args.microbatches,
                                        donate=True)
    again = {}

    def batches(start):
        return PrefetchingLoader(synthetic_batches(cfg, shape, seed=args.seed,
                                                   start_step=start), device=device)

    out = train(step_fn, mid, batches, None,
                LoopConfig(total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_STEPS + 1,
                           log_every=1),
                metrics_cb=lambda s, m: again.__setitem__(s, float(m["loss_total"])))
    del mid, out
    resumed = [again[s] for s in range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS + 1)]
    first = run["loss"][TRAIN_CKPT_EVERY:]
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, first))
    emit({"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
          "resume_from_step": TRAIN_CKPT_EVERY, "restore_seconds": restore_s,
          "checkpoint_bytes": sum(run["checkpoints"].values()),
          "losses": resumed, "first_run_losses": first, "max_rel_diff": worst,
          "equal_bits": resumed == first, "tol": TRAIN_RESUME_TOL})
    check(worst <= TRAIN_RESUME_TOL, f"resumed losses differ from the first run's by {worst}")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return run


def run_line(run, card, flops, params) -> dict:
    """The trainer's line: losses, step seconds, tokens/s, model FLOPs and
    their share of the bf16 peak, peak memory, launches."""
    tokens = run["shape"].global_batch * run["shape"].seq_len
    return {"phase": "train", "card": card, "arch": run["cfg"].name, "params": params,
            "tokens_per_step": tokens, "losses": run["loss"], "grad_norms": run["gnorm"],
            "lr": run["lr"], "wall_seconds": run["wall"],
            "step_seconds_median_3_20": run["step_s"],
            "tokens_per_second": tokens / run["step_s"], "model_flops_per_step": flops,
            "model_flops_share_of_peak": flops / run["step_s"] / BF16_OPS_PER_S,
            "peak_memory_bytes": run["peak"], "launches": run["launches"],
            "checkpoints": run.get("checkpoints", [])}


def loss_and_grads(torch, cfg, params, batch, context=contextlib.nullcontext):
    """One step's loss and whole-model gradients (full remat) under
    ``context``, the gradients by leaf path."""
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    with context():
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        total, _ = tf.loss_fn(live, cfg, batch, remat=True)
        grads = torch.autograd.grad(total, leaves(live))
    paths = ("/".join(p) for p, _ in leaves_with_paths(params))
    return float(total.detach()), dict(zip(paths, grads))


def path_grad_errors(torch, cfg, params, batch, plain, paths):
    """Per-leaf relative L2 of one step's whole-model gradients under each
    context of ``paths`` against those under ``plain``; one path's
    gradients beside the plain path's at a time."""
    want = loss_and_grads(torch, cfg, params, batch, plain)[1]
    return [{n: rel_err(torch, g, want[n])
             for n, g in loss_and_grads(torch, cfg, params, batch, path)[1].items()}
            for path in paths]


def model_grad_errors(torch, cfg, params, batch, plain):
    """Per-leaf relative L2 of one step's whole-model gradients (full
    remat), the kernel path (run first: the MoE checks replay its routing)
    against the ``plain`` context's path."""
    got = loss_and_grads(torch, cfg, params, batch, contextlib.nullcontext)[1]
    want = loss_and_grads(torch, cfg, params, batch, plain)[1]
    return {n: rel_err(torch, g, want[n]) for n, g in got.items()}


def floor_consistency(torch, cfg, params, batch, fault, fault_name: str, phase: str,
                      named_leaves: tuple = ()) -> None:
    """Whole-model gradients of one step on ``params`` and ``batch``, the
    kernel path against the plain path, each leaf within CONSISTENCY_TOL of
    the plain path plus the plain path's own floor: how far it moves when
    its forward sums the same f32 softmax in another order (twice the key
    block), measured here.  Deep random-init models amplify the forward's
    bf16 noise past a flat tolerance: at 26 layers of recurrentgemma-2b that
    order alone moved layer 23's wq and wk gradients by 3.6% on an H100, the
    kernel path 3.9%.  The run under the planted fault ``fault`` (a
    context: :func:`drop_delta` and the like) must miss the rule.  Emits the line."""
    errs, floor, bad = path_grad_errors(
        torch, cfg, params, batch, plain_flash_training,
        (contextlib.nullcontext, lambda: plain_flash_training(key_blocks=2),
         fault))
    check(set(named_leaves) <= set(errs),
          f"the gradient check's leaves miss {set(named_leaves) - set(errs)}")
    over = {n: errs[n] - floor[n] for n in errs}
    bad_over = {n: e - floor[n] for n, e in bad.items()}
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "consistency": "whole-model gradients, kernel vs plain", "step": 1,
          "microbatch": 1, "tokens": list(batch["tokens"].shape),
          "per_leaf_rel_err_max": max(errs.values()),
          "worst_leaves": sorted(errs.items(), key=lambda kv: -kv[1])[:5],
          "named_leaves": {n: errs[n] for n in named_leaves},
          "plain_floor_max": max(floor.values()),
          "worst_floor_leaves": sorted(floor.items(), key=lambda kv: -kv[1])[:5],
          "per_leaf_rel_err_over_floor_max": max(over.values()),
          "within_tol_without_floor": max(errs.values()) <= CONSISTENCY_TOL,
          "tol": CONSISTENCY_TOL, "planted_fault": f"the backward {fault_name}",
          "fault_rel_err_over_floor_max": max(bad_over.values()),
          "fault_worst_leaf": max(bad_over, key=bad_over.get),
          "fault_rejected": max(bad_over.values()) > CONSISTENCY_TOL})
    check(max(over.values()) <= CONSISTENCY_TOL,
          f"{cfg.name}: whole-model gradients, kernel against plain, past the plain path's "
          f"own floor by {max(over.values())}")
    check(max(bad_over.values()) > CONSISTENCY_TOL,
          f"the whole-model check passes a backward that {fault_name}")


def phase_train_run(torch, device, card: str):
    """Train qwen3-0.6b at full width through ``launch.train.main`` (the
    launch counters set to 0 just before, read just after), run repro's
    fixed-batch rule, hold one step's whole-model gradients to the plain
    path, profile a step, and resume steps 11..20 from the step-10
    checkpoint at ``TRAIN_RESUME_LAYERS`` layers.  Returns the launches of
    the training windows."""
    import statistics as stats

    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig

    emit({"phase": "train", "argv": list(TRAIN_ARGV)})
    run = train_window(torch, device, TRAIN_ARGV)
    state, launches, loss = run.pop("state"), run["launches"], run["loss"]
    cfg, shape, opt_cfg, args = run["cfg"], run["shape"], run["opt_cfg"], run["args"]
    check(stats.mean(loss[-5:]) < stats.mean(loss[:5]),
          f"the loss did not fall: first 5 {loss[:5]}, last 5 {loss[-5:]}")
    flops = train_model_flops(cfg, state["params"], shape.global_batch, shape.seq_len)
    bwd_calls = TRAIN_STEPS * cfg.n_layers
    check(launches.get("flash_attention_bwd") == launches.get("flash_attention_bwd_tc")
          == bwd_calls and "flash_attention_bwd_simt" not in launches,
          f"training launched the backward {launches.get('flash_attention_bwd')} times, "
          f"{launches.get('flash_attention_bwd_tc')} on the tc route; want {bwd_calls}, all tc")
    emit(run_line(run, card, flops, tf.param_count(state["params"])))
    del state

    # repro's fixed-batch rule (tests/test_runtime.py:37) at full width.
    fixed_cfg = AdamWConfig(lr=3e-3, total_steps=FIXED_BATCH_STEPS, warmup_steps=2,
                            weight_decay=0.0)
    step_fn = steps_lib.make_train_step(cfg, fixed_cfg)
    state = steps_lib.init_state(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    raw = next(synthetic_batches(cfg, dataclasses.replace(shape, global_batch=1), seed=1))
    batch = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    fixed = []
    for _ in range(FIXED_BATCH_STEPS):
        state, m = step_fn(state, batch)
        fixed.append(float(m["loss"]))
    emit({"phase": "train", "fixed_batch": [1, shape.seq_len], "losses": fixed,
          "last_over_first": fixed[-1] / fixed[0], "rule": FIXED_BATCH_RULE})
    check(fixed[-1] < FIXED_BATCH_RULE * fixed[0],
          f"fixed batch: last loss {fixed[-1]} not below {FIXED_BATCH_RULE} of {fixed[0]}")

    # Whole-model gradients of one step at [1, 2048], kernel against plain.
    errs = model_grad_errors(torch, cfg, state["params"], batch, plain_flash_training)
    emit({"phase": "train", "consistency": "whole-model gradients, kernel vs plain",
          "tokens": [1, shape.seq_len], "per_leaf_rel_err_max": max(errs.values()),
          "worst_leaves": sorted(errs.items(), key=lambda kv: -kv[1])[:5],
          "tol": CONSISTENCY_TOL})
    check(max(errs.values()) <= CONSISTENCY_TOL,
          f"whole-model gradients: kernel against plain {max(errs.values())}")

    # Where a step's time goes: one profiled step at the trainer's shape.
    big = next(synthetic_batches(cfg, shape, seed=args.seed))
    big = {k: torch.as_tensor(v, device=device) for k, v in big.items()}
    step_fn = steps_lib.make_train_step(cfg, opt_cfg)
    emit({"phase": "train_breakdown", "card": card, "tokens": [shape.global_batch,
                                                               shape.seq_len],
          **train_breakdown(torch, step_fn, state, big)})
    del state, batch, big
    torch.cuda.empty_cache()

    cut = train_and_resume(torch, device, family_argv(TRAIN_ARCH, TRAIN_RESUME_LAYERS,
                                                      TRAIN_ARGV[2:]), "train_ckpt")
    del cut["state"]
    torch.cuda.empty_cache()
    return {"flash_attention_bwd_tc": launches["flash_attention_bwd_tc"]
            + cut["launches"]["flash_attention_bwd_tc"]}


# --------------------------------------------------------------------------
# Phase 8b: train mamba2-370m (the scan's backward kernel, an SSD block, the
# trainer)
# --------------------------------------------------------------------------

# The scan's backward against its plain version: the training shape (4 x
# 2048 tokens: 8 chunks of 256, 32 heads of 64 x 128), then the forward
# checks' shapes (phase_ssd_scan).  dstates must equal the plain version
# bit for bit (the same f32 recurrence, rounded as the plain loop rounds);
# ddecays, a sum over a row's n = P * N elements that the kernel takes in
# another order, within n * 2^-24 * sum |G * prev| (each partial sum's
# rounding at most 2^-24 of the terms summed so far), plus one ulp of the
# dtype where both round an f32 sum to bf16.  Set before the first card run.
SCAN_TRAIN_SHAPE = (4, 8, 32, 64, 128)
SCAN_BWD_CASES = ((SCAN_TRAIN_SHAPE, "float32", "near 1"),
                  (SCAN_TRAIN_SHAPE, "float32", "sigmoid"),
                  ((1, 8, 32, 64, 128), "float32", "near 1"),
                  ((2, 3, 32, 64, 128), "bfloat16", "sigmoid"),
                  ((3, 7, 1, 5, 3), "float32", "sigmoid"),  # P * N = 15: element-wise path
                  ((3, 7, 1, 5, 3), "bfloat16", "sigmoid"),
                  ((2, 5, 3, 8, 16), "float32", "misaligned"))  # bases + 4 bytes
# One SSD block of mamba2-370m at full width under training, [4, 2048]
# tokens, f32 masters, bf16 activations, Mamba-2's dt initialisation:
# parameter and input gradients through the scan's kernels against the plain
# path (autograd of the plain loop on the card, plain_scan_training), per
# leaf.  Set before the first card run: the forwards agree bit for bit and
# so do dstates, so only ddecays' summation order (f32, ~1e-7 of the sum)
# separates the paths, and bf16 roundings downstream of it.
SSM_LAYER_BATCH, SSM_LAYER_SEQ = 4, 2048
SSM_LAYER_TOL = 1e-3
# The trainer at the published widths and all 48 layers, qwen3-0.6b's
# command line otherwise: 4 x 2048 synthetic tokens a step (8 chunks of
# 256), 20 steps, checkpoints every 10.
SSM_TRAIN_ARGV = ("--arch", MAMBA_ARCH, "--global-batch", "4", "--seq-len", "2048", "--steps",
                  str(TRAIN_STEPS), "--checkpoint-every", str(TRAIN_CKPT_EVERY), "--seed", "0")
# The resume check at the published widths cut to 2 layers of 48 (a
# checkpoint of all 48 layers' state is 4.42 GB, of 2 layers 0.80 GB), so
# that phase 8f's checkpoint fits CHECKPOINT_LIMIT_GIB; the timed run trains
# all 48 layers without checkpoints.
SSM_RESUME_LAYERS = 2


@contextlib.contextmanager
def plain_scan_training():
    """The scan's plain loop, differentiated by autograd, in place of the
    kernels while the context lasts, CUDA tensors included: the training
    checks' reference path."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_plain

    saved = ops.ssd_scan
    ops.ssd_scan = ssd_scan_plain
    try:
        yield
    finally:
        ops.ssd_scan = saved


def scan_bwd_bound(torch, dstates, prev, want_dd):
    """The ddecays bound of SCAN_BWD_CASES, elementwise."""
    n = prev.shape[-1] * prev.shape[-2]
    terms = (dstates.double() * prev.double()).abs().sum(dim=(-2, -1))
    ulp = 2.0 ** -7 if want_dd.dtype == torch.bfloat16 else 0.0
    return n * 2.0 ** -24 * terms + ulp * want_dd.double().abs()


def phase_scan_bwd_kernels(torch, device):
    """The scan's backward kernel against its plain version at
    SCAN_BWD_CASES' shapes on the forward kernel's prev (dstates bit for
    bit, ddecays within its bound, two calls equal bit for bit), a planted
    fault (the carried G dropped) rejected, then timed at the training
    shape beside its bound and plain version."""
    import numpy as np
    from repro_torch.kernels import runtime
    from repro_torch.kernels.ssd_scan.ssd_scan import (
        ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain)

    gen = torch.Generator(device=device).manual_seed(30)
    rng = np.random.default_rng(SEED + 30)
    errs = {"ssd_scan_bwd": 0.0}

    def randn(shape, dtype, misaligned=False):
        if misaligned:  # a 16-byte row at base + 4 bytes: the element-wise path
            n = int(np.prod(shape))
            return torch.randn(n + 1, device=device, generator=gen)[1:].view(shape)
        return torch.randn(shape, device=device, generator=gen).to(dtype)

    def inputs(shape, dtype, kind):
        dtype = getattr(torch, dtype)
        if kind == "near 1":  # exp(dt * A) at A = -1 over Mamba-2's dt range
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape[:3]))
            decays = torch.as_tensor(np.exp(-dt), dtype=torch.float32, device=device).to(dtype)
        else:
            decays = torch.sigmoid(torch.randn(shape[:3], device=device, generator=gen)).to(dtype)
        mis = kind == "misaligned"
        states = randn(shape, dtype, mis)
        prev, _ = ssd_scan(states, decays)
        if mis:  # prev as the kernel wrote it, copied to base + 4 bytes
            prev = randn(shape, dtype, True).copy_(prev)
        return (randn(shape, dtype, mis), randn((shape[0], *shape[2:]), dtype, mis), prev,
                decays)

    for shape, dtype, kind in SCAN_BWD_CASES:
        args = inputs(shape, dtype, kind)
        before = runtime.launches["ssd_scan_bwd"]
        got = ssd_scan_bwd(*args)
        again = ssd_scan_bwd(*args)
        check(runtime.launches["ssd_scan_bwd"] == before + 2,
              "ssd_scan_bwd: not one launch a call")
        want = ssd_scan_bwd_plain(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ds_equal = torch.equal(got[0], want[0])
        over = float(((got[1].double() - want[1].double()).abs()
                      / scan_bwd_bound(torch, want[0], args[2], want[1]).clamp_min(1e-300)).max())
        err = max_abs_err(torch, got[1], want[1])
        errs["ssd_scan_bwd"] = max(errs["ssd_scan_bwd"], err, max_abs_err(torch, got[0], want[0]))
        emit({"phase": "train_ssm", "check": "ssd_scan_bwd", "shape": list(shape),
              "dtype": dtype, "decays": kind, "dstates_equal_bits": ds_equal,
              "ddecays_max_abs_err": err, "ddecays_share_of_bound": over,
              "equal_bits_twice": same})
        check(ds_equal and over <= 1.0 and same,
              f"ssd_scan_bwd {shape} {dtype} {kind}: dstates equal {ds_equal}, ddecays at "
              f"{over} of its bound, equal twice {same}")

    # The planted fault: the kernel with the carried G dropped (its decays
    # zeroed: G_c = dprev[:, c]) against the plain version with them.
    dprev, dfinal, prev, decays = inputs(SCAN_TRAIN_SHAPE, "float32", "near 1")
    got = ssd_scan_bwd(dprev, dfinal, prev, torch.zeros_like(decays))
    want = ssd_scan_bwd_plain(dprev, dfinal, prev, decays)
    over = float(((got[1].double() - want[1].double()).abs()
                  / scan_bwd_bound(torch, want[0], prev, want[1]).clamp_min(1e-300)).max())
    rejected = not torch.equal(got[0], want[0]) and over > 1.0
    emit({"phase": "train_ssm", "planted_fault": "ssd_scan_bwd",
          "fault": "drops the carried G (G_c = dprev[:, c])",
          "dstates_max_abs_err": max_abs_err(torch, got[0], want[0]),
          "ddecays_share_of_bound": over, "rejected": rejected})
    check(rejected, "ssd_scan_bwd: the checks pass a backward that drops the carried G")
    torch.cuda.synchronize()

    bench = Bench(torch, device)
    b, nc, h, p, n = SCAN_TRAIN_SHAPE
    numel = dprev.numel()
    # dprev[:, 1:] (dprev[:, 0] is the gradient of the zero initial carry),
    # prev and dfinal read, dstates written, the decays read and ddecays
    # written; four f32 operations an element a chunk.
    moved = 4 * (numel * (nc - 1) // nc + numel + numel // nc + numel + 2 * decays.numel())
    ms_bound, by = bound(moved, 4 * numel)
    row = dict(
        shape=f"dprev, prev [{b},{nc},{h},{p},{n}] f32, dfinal [{b},{h},{p},{n}], "
              f"decays [{b},{nc},{h}]",
        ms=bench.ms(lambda: ssd_scan_bwd(dprev, dfinal, prev, decays)),
        **bench.device_ms(lambda: ssd_scan_bwd(dprev, dfinal, prev, decays)),
        plain_ms=bench.ms(lambda: ssd_scan_bwd_plain(dprev, dfinal, prev, decays)),
        library_ms=None,  # no single PyTorch call computes this gradient
        bound_ms=ms_bound, bound_by=by)
    emit({"phase": "train_ssm", "timing": "ssd_scan_bwd", **row})
    del bench
    return errs, {"ssd_scan_bwd": row}


def ssm_layer_errors(torch, device, fault: bool = False):
    """Per-leaf relative L2 of one SSD block's parameter and input
    gradients, kernel path against plain path, at SSM_LAYER_BATCH x
    SSM_LAYER_SEQ tokens with Mamba-2's dt initialisation; ``fault`` drops
    ddecays from the backward kernel's output."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import runtime
    from repro_torch.kernels.ssd_scan import ssd_scan as scan_mod
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    cfg = ARCHS[MAMBA_ARCH]
    gen = torch.Generator(device=device).manual_seed(SEED)
    with layers.matrix_dtype(torch.float32):
        block = tf.init_block(cfg, gen, device, "ssm")
    bias = mamba2_dt_bias(np.random.default_rng(SEED), 1, cfg.n_ssm_heads)[0]
    block["ssm"]["dt_bias"] = torch.as_tensor(bias, device=device)
    b, s = SSM_LAYER_BATCH, SSM_LAYER_SEQ
    x = torch.randn(b, s, cfg.d_model, device=device, generator=gen).to(torch.bfloat16)
    w = torch.randn(b, s, cfg.d_model, device=device, generator=gen)
    pos = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)

    def grads():
        live = tree_map(lambda t: t.detach().clone().requires_grad_(), block)
        xg = x.clone().requires_grad_()
        out, _, _ = tf.block_forward(live, cfg, "ssm", xg, pos)
        return torch.autograd.grad((out.float() * w).sum(), leaves(live) + [xg])

    bwd = scan_mod.ssd_scan_bwd
    if fault:
        def dropped(*args):
            dstates, ddecays = bwd(*args)
            return dstates, torch.zeros_like(ddecays)
        scan_mod.ssd_scan_bwd = dropped
    try:
        before = runtime.launches["ssd_scan_bwd"]
        got = grads()
        check(runtime.launches["ssd_scan_bwd"] == before + 1,
              "the block's backward did not launch ssd_scan_bwd once")
    finally:
        scan_mod.ssd_scan_bwd = bwd
    with plain_scan_training():
        want = grads()
    names = ["/".join(p) for p, _ in leaves_with_paths(block)] + ["x"]
    return {n: rel_err(torch, g.float(), w_.float()) for n, g, w_ in zip(names, got, want)}


def phase_ssm_train_layer(torch, device):
    errs = ssm_layer_errors(torch, device)
    emit({"phase": "train_ssm", "layer_check": MAMBA_ARCH, "dt_init": "mamba2",
          "tokens": [SSM_LAYER_BATCH, SSM_LAYER_SEQ], "per_leaf_rel_err": errs,
          "max_rel_err": max(errs.values()), "tol": SSM_LAYER_TOL})
    check(max(errs.values()) <= SSM_LAYER_TOL,
          f"{MAMBA_ARCH} block gradients: kernel path against plain path {max(errs.values())} "
          f"beyond {SSM_LAYER_TOL}")
    bad = ssm_layer_errors(torch, device, fault=True)
    emit({"phase": "train_ssm", "planted_fault": "layer",
          "fault": "the backward kernel drops ddecays", "max_rel_err": max(bad.values()),
          "worst_leaf": max(bad, key=bad.get), "rejected": max(bad.values()) > SSM_LAYER_TOL})
    check(max(bad.values()) > SSM_LAYER_TOL, "the layer check passes a backward without ddecays")
    torch.cuda.empty_cache()


def ssm_train_model_flops(cfg, params, b, s) -> float:
    """Model FLOPs of one training step of the SSM family (forward and
    backward, no remat): 3 x (2 x the matrix parameters x tokens, the tied
    unembedding once and the depthwise conv's 2 W C a token among them,
    plus each layer's chunk products: C B^T 2 S Q N, its product with dt x
    2 S Q H P, the chunk states 2 S H P N and the carried states' output
    2 S H P N a batch row, Q the chunk)."""
    from repro_torch.tree import leaves

    matrices = sum(x.numel() for x in leaves(params) if x.dim() == 2)
    q, n, h, p = min(cfg.ssm_chunk, s), cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    chunks = 2 * s * (q * n + q * h * p + 2 * h * p * n) * b * cfg.n_layers
    return 3.0 * (2.0 * matrices * b * s + chunks)


def phase_ssm_train_run(torch, device, card: str):
    """Train mamba2-370m at full width through ``launch.train.main`` (the
    launch counters set to 0 just before, read just after: every layer's
    scan through the forward kernel twice a step under remat and through the
    backward kernel once), hold one step's whole-model gradients at
    Mamba-2's dt initialisation to the plain path, profile a step, then
    resume steps 11..20 from the step-10 checkpoint at
    ``SSM_RESUME_LAYERS`` layers.  Returns the launches of the training
    windows."""
    import numpy as np
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tf

    emit({"phase": "train_ssm", "argv": list(SSM_TRAIN_ARGV)})
    run = train_window(torch, device, SSM_TRAIN_ARGV)
    state, launches = run.pop("state"), dict(run["launches"])
    cfg, shape, opt_cfg, args = run["cfg"], run["shape"], run["opt_cfg"], run["args"]
    check(launches.get("ssd_scan") == 2 * TRAIN_STEPS * cfg.n_layers
          and launches.get("ssd_scan_bwd") == TRAIN_STEPS * cfg.n_layers,
          f"training launched the scan {launches.get('ssd_scan')} and its backward "
          f"{launches.get('ssd_scan_bwd')} times; want {2 * TRAIN_STEPS * cfg.n_layers} and "
          f"{TRAIN_STEPS * cfg.n_layers}")
    flops = ssm_train_model_flops(cfg, state["params"], shape.global_batch, shape.seq_len)
    emit(run_line(run, card, flops, tf.param_count(state["params"])))

    # Where a step's time goes: one profiled step at the trainer's shape.
    big = next(synthetic_batches(cfg, shape, seed=args.seed))
    big = {k: torch.as_tensor(v, device=device) for k, v in big.items()}
    step_fn = steps_lib.make_train_step(cfg, opt_cfg)
    emit({"phase": "train_breakdown", "card": card, "arch": cfg.name,
          "tokens": [shape.global_batch, shape.seq_len],
          **train_breakdown(torch, step_fn, state, big, SCAN_KINDS)})
    del big

    # Whole-model gradients of one step at [1, 2048], kernel against plain,
    # with every layer's dt_bias from Mamba-2's initialisation (at the CLI's
    # init of 0 each chunk's decay underflows to 0 and the scan is unseen).
    params = state["params"]
    bias = mamba2_dt_bias(np.random.default_rng(SEED), cfg.n_layers, cfg.n_ssm_heads)
    for layer, row in zip(params["layers"], bias):
        layer["ssm"]["dt_bias"] = torch.as_tensor(row, device=device)
    raw = next(synthetic_batches(cfg, dataclasses.replace(shape, global_batch=1), seed=1))
    batch = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    errs = model_grad_errors(torch, cfg, params, batch, plain_scan_training)
    emit({"phase": "train_ssm", "consistency": "whole-model gradients, kernel vs plain",
          "dt_init": "mamba2", "tokens": [1, shape.seq_len],
          "per_leaf_rel_err_max": max(errs.values()),
          "worst_leaves": sorted(errs.items(), key=lambda kv: -kv[1])[:5],
          "tol": CONSISTENCY_TOL})
    check(max(errs.values()) <= CONSISTENCY_TOL,
          f"whole-model gradients: kernel against plain {max(errs.values())}")
    del state, params, batch
    torch.cuda.empty_cache()
    cut = train_and_resume(torch, device, family_argv(MAMBA_ARCH, SSM_RESUME_LAYERS,
                                                      SSM_TRAIN_ARGV[2:]), "train_ckpt_ssm")
    del cut["state"]
    torch.cuda.empty_cache()
    for name in ("ssd_scan", "ssd_scan_bwd"):
        launches[name] += cut["launches"][name]
    return launches


# --------------------------------------------------------------------------
# Phase 8c: train the MoE families (granite-moe-3b-a800m; deepseek-v2-lite-16b,
# MLA with MoE)
# --------------------------------------------------------------------------

# (arch, layers of the timed run (0: all), layers of the resume check), each
# at its published widths.  granite-moe-3b-a800m trains at 8 of its 32
# layers (all 32, 3.30B parameters, 53 GB of f32 masters, gradients and AdamW
# moments, until phase 8f needed the time; 16 until phase 8g did), without
# checkpoints; its resume runs at 2 layers (3.3 GB), so that the run's
# checkpoints stay within
# CHECKPOINT_LIMIT_GIB.  deepseek-v2-lite-16b's 15.7B would take 251 GB: 2
# layers (the dense first and one MoE layer, 876M parameters, 14 GB; 10.5 GB
# a checkpoint), timed and resumed in the one run.
MOE_TRAIN_FAMILIES = ((MOE_ARCH, 8, 2), (MLA_ARCH, 2, 2))
MOE_TRAIN_ARGV = ("--global-batch", "4", "--seq-len", "2048", "--steps", str(TRAIN_STEPS),
                  "--checkpoint-every", str(TRAIN_CKPT_EVERY), "--seed", "0")
MOE_FLOPS_FORMULA = ("3 (2 (M + X C / S) B S + 2 (hd_qk + hd_v) H B L S (S + 1) / 2): M the 2-D "
                     "matrices (tied unembedding once, routers and shared experts whole), X the "
                     "routed experts' parameters, C = int(cf S k / E) the rows each expert "
                     "computes a sequence, so X C / S is top-k times the capacity factor over E")


def family_argv(arch: str, layers: int, tail: tuple | None = None) -> tuple:
    """``launch.train``'s command line (``tail`` after the config, by
    default ``MOE_TRAIN_ARGV``) for ``arch`` at its published widths, cut to
    ``layers`` layers (an encoder-decoder's encoder too) through
    ``--reduced --reduced-overrides`` (0: all, no cut)."""
    from repro_torch.configs import ARCHS, reduced

    tail = MOE_TRAIN_ARGV if tail is None else tail
    if not layers:
        return ("--arch", arch, *tail)
    full = ARCHS[arch]
    small = reduced(full)
    over = {f.name: getattr(full, f.name) for f in dataclasses.fields(full)
            if getattr(small, f.name) != getattr(full, f.name)}
    over["n_layers"] = layers
    if full.n_encoder_layers:  # an encoder-decoder: as many encoder layers
        over["n_encoder_layers"] = layers
    return ("--arch", arch, "--reduced", "--reduced-overrides",
            ",".join(f"{k}={v}" for k, v in over.items()), *tail)


def moe_train_model_flops(cfg, params, b, s) -> float:
    """Model FLOPs of one training step of an MoE decoder, its active
    parameters only (``MOE_FLOPS_FORMULA``; forward and backward, no remat)."""
    from repro_torch.models import moe
    from repro_torch.tree import leaves_with_paths

    matrices = experts = 0
    for path, x in leaves_with_paths(params):
        if "experts" in path:
            experts += x.numel()
        elif x.dim() == 2:
            matrices += x.numel()
    if cfg.attn_type == "mla":
        hd_qk, hd_v = cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim
    else:
        hd_qk = hd_v = cfg.head_dim
    attention = 2 * (hd_qk + hd_v) * cfg.n_heads * b * cfg.n_layers * s * (s + 1) // 2
    return 3.0 * (2.0 * (matrices + experts * moe.capacity(cfg, s) / s) * b * s + attention)


@contextlib.contextmanager
def counted_drops(torch, device):
    """The dense dispatch's calls and the assignments they drop (summed on
    the card) while the context lasts."""
    from repro_torch.models import moe

    dispatch = moe.dispatch_dense
    tally = {"calls": 0, "dropped": torch.zeros((), dtype=torch.int64, device=device)}

    def counting(x, ids, n_experts, cap):
        out = dispatch(x, ids, n_experts, cap)
        tally["calls"] += 1
        tally["dropped"] += (~out[1]).sum()
        return out

    moe.dispatch_dense = counting
    try:
        yield tally
    finally:
        moe.dispatch_dense = dispatch


class RoutingLog:
    """In place of ``moe._top_k``: records each call's expert ids (the
    kernel path's), then, once ``replaying``, hands them back in the same
    order (the plain path's calls follow the kernel path's: the forward in
    layer order, under remat the recompute in reverse), with the top-k
    values gathered from the plain path's own probabilities, and keeps the
    share of rows whose own top-k would have agreed."""

    def __init__(self, top_k):
        self.top_k, self.calls, self.agree, self.replaying = top_k, [], [], False

    def __call__(self, probs, k):
        if not self.replaying:
            values, ids = self.top_k(probs, k)
            self.calls.append(ids)
            return values, ids
        ids = self.calls[len(self.agree)].to(probs.device)
        own = self.top_k(probs, k)[1]
        self.agree.append(float((own == ids).all(-1).float().mean()))
        return probs.gather(-1, ids), ids


def moe_grad_errors(torch, cfg, params, batch):
    """:func:`model_grad_errors` of an MoE decoder with the plain path on
    the kernel path's routing (a near-tie that the two paths' last bits
    route apart would move the gradients by far more than the tolerance);
    the kernel path's recomputed forward must route as its forward did.
    Returns (errors, routing facts)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    log = RoutingLog(moe._top_k)

    @contextlib.contextmanager
    def plain():
        log.replaying = True
        with plain_flash_training():
            yield

    moe._top_k = log
    try:
        errs = model_grad_errors(torch, cfg, params, batch, plain)
    finally:
        moe._top_k = log.top_k
    n = sum(tf.is_moe_layer(cfg, i) for i in range(cfg.n_layers))
    check(len(log.calls) == len(log.agree) == 2 * n,
          f"{len(log.calls)} routings on the kernel path, {len(log.agree)} replayed; want "
          f"{2 * n} (forward and recompute of {n} MoE layers)")
    same = all(torch.equal(a, b) for a, b in zip(log.calls[:n], reversed(log.calls[n:])))
    check(same, "under remat the recomputed forward routed otherwise than the forward")
    return errs, {"moe_calls": len(log.calls), "remat_recompute_routes_equal": same,
                  "plain_path_routing": "the kernel path's, replayed",
                  "unforced_agreement_min": min(log.agree)}


def phase_moe_train(torch, device, card: str):
    """Train each of ``MOE_TRAIN_FAMILIES`` (see 8c in the module's text).
    Returns the launches of the training windows."""
    import statistics as stats

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    launches = collections.Counter()
    for arch, layers, resume_layers in MOE_TRAIN_FAMILIES:
        argv = family_argv(arch, layers)
        with counted_drops(torch, device) as drops:
            if layers == resume_layers:
                run = train_and_resume(torch, device, argv, "train_ckpt_moe")
            else:
                emit({"phase": "train_moe", "argv": list(argv)})
                run = train_window(torch, device, argv)
        state, cfg, shape, args = run.pop("state"), run["cfg"], run["shape"], run["args"]
        check(cfg == dataclasses.replace(ARCHS[arch], n_layers=cfg.n_layers),
              f"the {arch} trainer's config is not {arch}'s widths")
        loss, found = run["loss"], run["launches"]
        check(stats.mean(loss[-5:]) < stats.mean(loss[:5]),
              f"{arch}: the loss did not fall: first 5 {loss[:5]}, last 5 {loss[-5:]}")
        bwd_calls = TRAIN_STEPS * cfg.n_layers
        check(found.get("flash_attention_bwd") == found.get("flash_attention_bwd_tc")
              == bwd_calls and "flash_attention_bwd_simt" not in found,
              f"{arch}: training launched the backward {found.get('flash_attention_bwd')} "
              f"times, {found.get('flash_attention_bwd_tc')} on the tc route; want {bwd_calls}")
        if cfg.attn_type == "mla":  # every forward (and its recompute) at (192, 128)
            check(found.get("flash_attention_tc_192x128") == found.get("flash_attention")
                  == 2 * bwd_calls, f"{arch}: the flash forward's launches {found}")
        launches["flash_attention_bwd_tc"] += found["flash_attention_bwd_tc"]
        n_moe = sum(tf.is_moe_layer(cfg, i) for i in range(cfg.n_layers))
        b, s = shape.global_batch, shape.seq_len
        line = run_line(run, card, moe_train_model_flops(cfg, state["params"], b, s),
                        tf.param_count(state["params"]))
        line.update(phase="train_moe", layers=cfg.n_layers,
                    active_params=tf.active_param_count(state["params"], cfg),
                    capacity=moe.capacity(cfg, s), model_flops_formula=MOE_FLOPS_FORMULA,
                    dropped_assignments_per_step=int(drops["dropped"]) / drops["calls"] * n_moe,
                    assignments_per_step=b * s * cfg.experts_per_token * n_moe)
        emit(line)

        # Where a step's time goes: one profiled step, the state updated in place.
        big = next(synthetic_batches(cfg, shape, seed=args.seed))
        big = {k: torch.as_tensor(v, device=device) for k, v in big.items()}
        step_fn = steps_lib.make_train_step(cfg, run["opt_cfg"], donate=True)
        emit({"phase": "train_breakdown", "card": card, "arch": cfg.name,
              "layers": cfg.n_layers, "tokens": [b, s],
              **train_breakdown(torch, step_fn, state, big)})
        del state, step_fn
        torch.cuda.empty_cache()

        # Whole-model gradients of the run's first step (its initial weights,
        # its first batch), kernel against plain.  A trained state reads
        # larger (granite-moe 2.1% after 20 steps, 8.5% after the profiled
        # step's two more updates on this batch), and all but 0.5% of it
        # follows the flash forward's bf16 output: the plain forward under
        # the kernel backward reads 0.5% there (flash_probe.py --grad-swap).
        params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                                device, dtype=torch.float32)
        errs, routing = moe_grad_errors(torch, cfg, params, big)
        emit({"phase": "train_moe", "arch": cfg.name, "layers": cfg.n_layers,
              "consistency": "whole-model gradients, kernel vs plain", "step": 1,
              "tokens": [b, s],
              "per_leaf_rel_err_max": max(errs.values()),
              "worst_leaves": sorted(errs.items(), key=lambda kv: -kv[1])[:5],
              "routing": routing, "tol": CONSISTENCY_TOL})
        check(max(errs.values()) <= CONSISTENCY_TOL,
              f"{arch}: whole-model gradients, kernel against plain {max(errs.values())}")
        del params, big
        torch.cuda.empty_cache()

        if layers != resume_layers:  # the resume check at its own depth
            cut = train_and_resume(torch, device, family_argv(arch, resume_layers),
                                   "train_ckpt_moe")
            del cut["state"]
            launches["flash_attention_bwd_tc"] += cut["launches"]["flash_attention_bwd_tc"]
            torch.cuda.empty_cache()
    return launches


# A chip call may write 45 GiB to its machine's disk, counted even when
# deleted; the trainers' step-10 checkpoints (train_and_resume) may take
# CHECKPOINT_LIMIT_GIB of it, the rest is for the builds and caches.
CHECKPOINT_LIMIT_GIB = 41.0


def checkpointed_argvs() -> dict:
    """The command line of every trainer that writes a checkpoint, by name."""
    return {f"{TRAIN_ARCH} at {TRAIN_RESUME_LAYERS} layers (5h)": family_argv(
                TRAIN_ARCH, TRAIN_RESUME_LAYERS, TRAIN_ARGV[2:]),
            f"{MAMBA_ARCH} at {SSM_RESUME_LAYERS} layers (8b)": family_argv(
                MAMBA_ARCH, SSM_RESUME_LAYERS, SSM_TRAIN_ARGV[2:]),
            **{f"{arch} at {n} layers (8c)": family_argv(arch, n)
               for arch, _, n in MOE_TRAIN_FAMILIES},
            f"{HYBRID_ARCH} at {HYBRID_RESUME_LAYERS} layers (8d)": family_argv(
                HYBRID_ARCH, HYBRID_RESUME_LAYERS, HYBRID_TRAIN_ARGV),
            f"{VLM_ARCH} at {VLM_RESUME_LAYERS} layers (8e)": family_argv(
                VLM_ARCH, VLM_RESUME_LAYERS, VLM_TRAIN_ARGV),
            f"{ENCDEC_ARCH} at {ENCDEC_RESUME_LAYERS} + {ENCDEC_RESUME_LAYERS} layers (8f)":
                family_argv(ENCDEC_ARCH, ENCDEC_RESUME_LAYERS, ENCDEC_TRAIN_ARGV)}


def checkpoint_reckoning(torch) -> dict:
    """Bytes of each trainer's step-10 checkpoint, reckoned before any runs:
    its parameters (counted on the meta device) times 12 (f32 masters and
    both AdamW moments).  Fails past CHECKPOINT_LIMIT_GIB."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    out = {}
    for name, argv in checkpointed_argvs().items():
        cfg = train_mod.setup(train_mod.parse_args([*argv, "--device", "cpu"]))[0]
        with layers.matrix_dtype(torch.float32):
            params = tf._init_params(cfg, torch.Generator(), torch.device("meta"))
        out[name] = 12 * tf.param_count(params)
    total = sum(out.values()) / 2 ** 30
    emit({"phase": "disk", "checkpoint_bytes": out, "total_gib": total,
          "limit_gib": CHECKPOINT_LIMIT_GIB})
    check(total <= CHECKPOINT_LIMIT_GIB, f"the trainers' checkpoints would take {total} GiB")
    return out


# --------------------------------------------------------------------------
# Phase 8d: train recurrentgemma-2b (RG-LRU + local attention)
# --------------------------------------------------------------------------

# 2 x 4096 tokens a step: the same 8,192 tokens as the other trainers, but
# past the window of 2048, so half the queries lose keys to it (at 2048 the
# largest gap is 2047 and the window hides nothing).  At the published widths
# cut to HYBRID_TIMED_LAYERS of 26 layers, 20 steps, f32 masters, bf16
# activations, full remat, the donating step, no checkpoints (all 26 layers'
# state is 34.7 GB a checkpoint); the resume check at one Griffin period (rec, rec,
# attn_local: 912M parameters, 10.95 GB a checkpoint).  In two microbatches
# (repro's --microbatches): in one, the f32 logits of 2 x 4096 x 256,000
# (7.8 GiB) and their softmax's backward on top of the 46 GB of state and
# gradients ran out of the card's memory at step 3 on an H100.  One local
# block's gradients at the trainer's tokens are held to the plain path
# within TRAIN_LAYER_TOL, and a backward handed window 0 must miss it.
HYBRID_TRAIN_TOKENS = (2, 4096)
HYBRID_MICROBATCHES = 2
HYBRID_TRAIN_ARGV = ("--global-batch", str(HYBRID_TRAIN_TOKENS[0]), "--seq-len",
                     str(HYBRID_TRAIN_TOKENS[1]), "--microbatches", str(HYBRID_MICROBATCHES),
                     "--steps", str(TRAIN_STEPS), "--checkpoint-every", str(TRAIN_CKPT_EVERY),
                     "--seed", "0")
# The timed run at 14 of the 26 layers (4 Griffin periods and 2 rec layers;
# all 26 until phase 8f took the time): 4 attn_local layers of the 8.
HYBRID_TIMED_LAYERS = 14
HYBRID_RESUME_LAYERS = 3
HYBRID_REPORT = "recurrentgemma train"  # BWD_CHECKS' row at the trainer's shape
# The RG-LRU's profiler ranges in a training step (models/rglru.py).
HYBRID_RANGES = ("associative_scan", "rglru_forward")
HYBRID_FLOPS_FORMULA = ("3 (2 M B S + 4 hd H B L P): M the 2-D parameters (tied unembedding "
                        "once; the RG-LRU's projections, gates and depthwise conv among them), "
                        "L the attn_local layers (8 of 26), P = sum over i < S of min(i + 1, W) "
                        "the (query, key) pairs the window W lets through a sequence")


def hybrid_train_model_flops(cfg, params, b, s) -> float:
    """Model FLOPs of one training step of the RG-LRU hybrid
    (``HYBRID_FLOPS_FORMULA``; forward and backward, no remat)."""
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves

    matrices = sum(x.numel() for x in leaves(params) if x.dim() == 2)
    pairs = sum(min(i + 1, cfg.window) for i in range(s))
    local = tf.layer_kinds(cfg).count("attn_local")
    return 3.0 * (2.0 * matrices * b * s + 4 * cfg.head_dim * cfg.n_heads * b * local * pairs)


def masked_launches(kind: str, mask: str):
    """The flash launches of one training step and microbatch of a family
    whose ``kind`` layers take the flash kernels with ``mask`` (the only
    flash layers): one backward a layer, the forward twice (the forward
    and remat's recompute), each counted under ``mask`` too."""
    def launches(cfg) -> dict:
        from repro_torch.models import transformer as tf

        n = tf.layer_kinds(cfg).count(kind)
        return {"flash_attention_bwd": n, "flash_attention_bwd_tc": n,
                f"flash_attention_bwd_{mask}": n, "flash_attention": 2 * n,
                "flash_attention_tc": 2 * n, f"flash_attention_{mask}": 2 * n}
    return launches


class MaskedTrainer(typing.NamedTuple):
    """A family whose ``kind`` layers train through the flash kernels with a
    mask they count (``mask``: "windowed", "prefix" or "full"), as phases
    8d-8f run it (:func:`phase_masked_train_layer`,
    :func:`phase_masked_train`): one block of each of ``layer_kinds`` (by
    default ``kind``) at ``tokens`` (every query seeing the first ``prefix``
    keys), the family at ``layers`` layers (0: all) with ``launch.train``'s
    ``tail`` (its
    flash launches a step and microbatch ``launches(cfg)``, by default
    :func:`masked_launches`'), its first-step gradients, a resume at
    ``resume_layers``, the backward timed at ``BWD_CHECKS``' row ``report``;
    ``fault`` wraps the backward as the checks' planted fault (the backward
    handed ``fault_name``; in the layer check on the ``fault_kind`` block,
    by default ``kind``); ``extras(cfg, b, s)`` adds to the trainer's line."""
    phase: str
    arch: str
    kind: str
    mask: str
    tokens: tuple
    tail: tuple
    resume_layers: int
    report: str
    fault: object
    fault_name: str
    flops: object
    flops_formula: str
    extras: object
    prefix: int = 0
    rglru: bool = False
    named_leaves: tuple = ()
    layer_kinds: tuple = ()
    fault_kind: str = ""
    launches: object = None
    layers: int = 0


HYBRID_TRAINER = MaskedTrainer(
    phase="train_hybrid", arch=HYBRID_ARCH, kind="attn_local", mask="windowed",
    tokens=HYBRID_TRAIN_TOKENS, tail=HYBRID_TRAIN_ARGV, resume_layers=HYBRID_RESUME_LAYERS,
    report=HYBRID_REPORT, fault=window_zero, fault_name="window 0",
    flops=hybrid_train_model_flops, flops_formula=HYBRID_FLOPS_FORMULA,
    extras=lambda cfg, b, s: {"window": cfg.window}, rglru=True, layers=HYBRID_TIMED_LAYERS)


def phase_masked_train_layer(torch, device, fam: MaskedTrainer):
    """One block of each of ``fam.layer_kinds`` (by default ``fam.kind``) of
    ``fam.arch`` at full width under training at ``fam.tokens``, kernel path
    against plain path; the ``fam.fault_kind`` block's backward handed
    ``fam.fault_name`` must be rejected."""
    for kind in fam.layer_kinds or (fam.kind,):
        kw = dict(arch=fam.arch, kind=kind, tokens=fam.tokens, prefix=fam.prefix)
        errs = train_layer_errors(torch, device, **kw)
        emit({"phase": fam.phase, "layer_check": fam.arch, "kind": kind, "prefix": fam.prefix,
              "tokens": list(fam.tokens), "per_leaf_rel_err": errs,
              "max_rel_err": max(errs.values()), "tol": TRAIN_LAYER_TOL})
        check(max(errs.values()) <= TRAIN_LAYER_TOL,
              f"{fam.arch} {kind} block gradients: kernel path against plain path "
              f"{max(errs.values())} beyond {TRAIN_LAYER_TOL}")
        if kind != (fam.fault_kind or fam.kind):
            continue
        bad = train_layer_errors(torch, device, fault=fam.fault, **kw)
        rejected = not max(bad.values()) <= TRAIN_LAYER_TOL  # a NaN is rejected too
        emit({"phase": fam.phase, "planted_fault": "layer", "kind": kind,
              "fault": f"the backward kernel handed {fam.fault_name}",
              "max_rel_err": max(bad.values()), "worst_leaf": max(bad, key=bad.get),
              "rejected": rejected})
        check(rejected, f"the layer check passes a backward handed {fam.fault_name}")
        torch.cuda.empty_cache()


def phase_masked_train(torch, device, card: str, fam: MaskedTrainer):
    """Train ``fam.arch`` at ``fam.layers`` layers (0: all) through
    ``launch.train.main`` (the launch counters set to 0 just before, read just
    after: every
    ``fam.kind`` layer's backward on the tc route and counted under
    ``fam.mask``, its forward so twice a step under remat), profile a step,
    hold the first step's whole-model gradients to the plain path, resume
    at ``fam.resume_layers`` layers from the step-10 checkpoint, and time
    the backward at the trainer's shape.  Returns (the launches of the
    training windows, the timing row)."""
    import statistics as stats

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tf

    argv = family_argv(fam.arch, fam.layers, fam.tail)
    emit({"phase": fam.phase, "argv": list(argv)})
    run = train_window(torch, device, argv)
    state, cfg, shape, args = run.pop("state"), run["cfg"], run["shape"], run["args"]
    check(cfg == dataclasses.replace(ARCHS[fam.arch], n_layers=cfg.n_layers)
          and cfg.n_layers == (fam.layers or ARCHS[fam.arch].n_layers)
          and fam.prefix == (cfg.frontend_seq if cfg.family == "vlm" else 0),
          f"the {fam.arch} trainer's config is not its own, or its prefix not its patches")
    loss, found = run["loss"], run["launches"]
    check(stats.mean(loss[-5:]) < stats.mean(loss[:5]),
          f"{fam.arch}: the loss did not fall: first 5 {loss[:5]}, last 5 {loss[-5:]}")
    n = tf.layer_kinds(cfg).count(fam.kind)
    a_step = (fam.launches or masked_launches(fam.kind, fam.mask))(cfg)
    want = {k: TRAIN_STEPS * args.microbatches * v for k, v in a_step.items()}
    got = {k: v for k, v in found.items() if k.startswith("flash_attention")}
    check(got == want, f"{fam.arch}: the flash launches {got}; want {want} ({a_step} a step "
                       f"and microbatch x {TRAIN_STEPS} steps x {args.microbatches} "
                       "microbatches)")
    b, s = shape.global_batch, shape.seq_len
    line = run_line(run, card, fam.flops(cfg, state["params"], b, s),
                    tf.param_count(state["params"]))
    line.update(phase=fam.phase, layers=cfg.n_layers, **{f"{fam.kind}_layers": n},
                microbatches=args.microbatches, model_flops_formula=fam.flops_formula,
                **fam.extras(cfg, b, s))
    emit(line)

    # Where a step's time goes: one profiled step, the state updated in place.
    big = next(synthetic_batches(cfg, shape, seed=args.seed))
    big = {k: torch.as_tensor(v, device=device) for k, v in big.items()}
    step_fn = steps_lib.make_train_step(cfg, run["opt_cfg"], microbatches=args.microbatches,
                                        donate=True)
    emit({"phase": "train_breakdown", "card": card, "arch": cfg.name, "layers": cfg.n_layers,
          "tokens": [b, s], **train_breakdown(torch, step_fn, state, big, rglru=fam.rglru)})
    del state, step_fn, run
    torch.cuda.empty_cache()

    # Whole-model gradients of the run's first step (its initial weights, its
    # first batch's first microbatch), kernel against plain beyond the plain
    # path's own floor.
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device,
                            dtype=torch.float32)
    first = {k: v[:b // args.microbatches] for k, v in big.items()}
    floor_consistency(torch, cfg, params, first, fam.fault, f"handed {fam.fault_name}",
                      fam.phase, fam.named_leaves)
    del params, big, first
    torch.cuda.empty_cache()

    cut = train_and_resume(torch, device, family_argv(fam.arch, fam.resume_layers, fam.tail),
                           fam.phase.replace("train_", "train_ckpt_"))
    del cut["state"]
    torch.cuda.empty_cache()
    launches = {k: found[k] + cut["launches"].get(k, 0)
                for k in ("flash_attention_bwd_tc", f"flash_attention_bwd_{fam.mask}")}

    # The backward at the trainer's shape (rows 4l and 4m of PERF.md).
    bench = Bench(torch, device)
    row = bwd_timing(torch, device, bench, torch.Generator(device=device).manual_seed(33),
                     fam.report)
    emit({"phase": fam.phase, "timing": "flash_attention_bwd", "route": "tc",
          "case": fam.report, "launches": launches[f"flash_attention_bwd_{fam.mask}"], **row})
    del bench
    return launches, row


# --------------------------------------------------------------------------
# Phase 8e: train paligemma-3b (prefix-LM VLM)
# --------------------------------------------------------------------------

# 4 x 2048 positions a step: 256 patch embeddings (of 1152, through
# frontend.proj_in) then 1792 text tokens a sequence, every position seeing
# the 256 patches (the flash kernel's prefix), the loss on text positions
# only.  All 18 layers at the published widths, 20 steps in one microbatch
# (peak 68.9 GB on an H100), f32 masters, bf16 activations, full remat, the
# donating step, no checkpoints (all 18 layers' state is 30.1 GB a
# checkpoint); the resume check at 2 layers (749.3M parameters, the
# embedding's 526.8M among them: 9.0 GB a checkpoint).  One attn block's
# gradients at the trainer's tokens are held to the plain path within
# TRAIN_LAYER_TOL, and a backward handed prefix 0 must miss it.
VLM_TRAIN_TOKENS = (4, 2048)
VLM_PREFIX = 256  # paligemma-3b's frontend_seq: the patches every position sees
VLM_TRAIN_ARGV = ("--global-batch", str(VLM_TRAIN_TOKENS[0]), "--seq-len",
                  str(VLM_TRAIN_TOKENS[1]), "--steps", str(TRAIN_STEPS), "--checkpoint-every",
                  str(TRAIN_CKPT_EVERY), "--seed", "0")
VLM_RESUME_LAYERS = 2
VLM_REPORT = "paligemma train"  # BWD_CHECKS' row at the trainer's shape
VLM_FLOPS_FORMULA = ("3 (2 M B S + 2 F B P + 4 hd H B L Q): M the 2-D parameters but "
                     "frontend.proj_in (tied unembedding once, over all S positions as the "
                     "logits are), F proj_in's parameters over the B P patch rows only, P the "
                     "patches a sequence, Q = sum over i < S of max(i + 1, P) the (query, key) "
                     "pairs the prefix-LM mask lets through a sequence")


def vlm_train_model_flops(cfg, params, b, s) -> float:
    """Model FLOPs of one training step of the prefix-LM VLM
    (``VLM_FLOPS_FORMULA``; forward and backward, no remat)."""
    from repro_torch.tree import leaves_with_paths

    frontend = matrices = 0
    for path, x in leaves_with_paths(params):
        if x.dim() == 2:
            if path[0] == "frontend":
                frontend += x.numel()
            else:
                matrices += x.numel()
    p = cfg.frontend_seq
    pairs = sum(max(i + 1, p) for i in range(s))
    return 3.0 * (2.0 * matrices * b * s + 2.0 * frontend * b * p
                  + 4 * cfg.head_dim * cfg.n_heads * b * cfg.n_layers * pairs)


VLM_TRAINER = MaskedTrainer(
    phase="train_vlm", arch=VLM_ARCH, kind="attn", mask="prefix", tokens=VLM_TRAIN_TOKENS,
    tail=VLM_TRAIN_ARGV, resume_layers=VLM_RESUME_LAYERS, report=VLM_REPORT, fault=prefix_zero,
    fault_name="prefix 0", flops=vlm_train_model_flops, flops_formula=VLM_FLOPS_FORMULA,
    extras=lambda cfg, b, s: {"prefix": VLM_PREFIX,
                              "text_tokens_per_step": b * (s - VLM_PREFIX)},
    prefix=VLM_PREFIX, named_leaves=("frontend/proj_in/w", "embed/table"))


# --------------------------------------------------------------------------
# Phase 8f: train seamless-m4t-large-v2 (encoder-decoder)
# --------------------------------------------------------------------------

# 4 x 2048 tokens and 4 x 2048 frames a step (repro's pipeline draws as many
# frames as tokens, so cross-attention runs at S = T = 2048): the frames (of
# 1024, the w2v-BERT stub) through frontend.proj_in and 24 bidirectional
# encoder layers (every key: the flash kernel's prefix = T), then 24 decoder
# layers, each causal self-attention then cross-attention over the
# encoder's output (every key, prefix = T).  All 24 + 24 layers at the
# published widths, 20 steps in two microbatches (repro's --microbatches: in
# one, the f32 logits of 4 x 2048 x 256,206 on top of the un-rematted
# encoder's activations ran out of the card's memory at step 3 with 71.2 GiB
# allocated, a step's gradients then still held by a reference cycle in
# tree_unflatten, since removed), f32 masters, bf16 activations, the decoder
# rematted and the encoder not (repro's training scan), the donating step,
# no checkpoints (all layers' state is 16.4 GB a checkpoint); the resume
# check at 2 + 2 layers (355.5M parameters, the embedding's 262.4M among
# them: 4.27 GB a checkpoint).  An enc and a cross block's gradients at the
# trainer's tokens are held to the plain path within TRAIN_LAYER_TOL, and a
# cross backward handed prefix 0 (causal) must miss it.
ENCDEC_TRAIN_TOKENS = (4, 2048)
ENCDEC_MICROBATCHES = 2
ENCDEC_TRAIN_ARGV = ("--global-batch", str(ENCDEC_TRAIN_TOKENS[0]), "--seq-len",
                     str(ENCDEC_TRAIN_TOKENS[1]), "--microbatches", str(ENCDEC_MICROBATCHES),
                     "--steps", str(TRAIN_STEPS), "--checkpoint-every", str(TRAIN_CKPT_EVERY),
                     "--seed", "0")
ENCDEC_RESUME_LAYERS = 2  # encoder and decoder layers each
ENCDEC_REPORT = "seamless encoder train"  # BWD_CHECKS' row of the encoder's calls
ENCDEC_FLOPS_FORMULA = ("3 (2 M B S + 4 hd H B (E S T + L S (S + 1) / 2 + L S T)): M the 2-D "
                        "parameters (tied unembedding once; the encoder's and proj_in over the "
                        "B T frame rows, T = S), E the encoder layers (every key), L the "
                        "decoder layers (causal self-attention, then cross-attention over the "
                        "T encoder rows)")


def encdec_train_model_flops(cfg, params, b, s) -> float:
    """Model FLOPs of one training step of the encoder-decoder
    (``ENCDEC_FLOPS_FORMULA``, T = S frames; forward and backward, no
    remat)."""
    from repro_torch.tree import leaves

    matrices = sum(x.numel() for x in leaves(params) if x.dim() == 2)
    e, d = cfg.n_encoder_layers, cfg.n_layers
    pairs = e * s * s + d * s * (s + 1) // 2 + d * s * s
    return 3.0 * (2.0 * matrices * b * s + 4 * cfg.head_dim * cfg.n_heads * b * pairs)


def encdec_launches(cfg) -> dict:
    """The flash launches of one encoder-decoder training step and
    microbatch: each encoder layer's every-key forward once (not rematted),
    each decoder layer's causal and cross forwards twice (the forward and
    remat's recompute), one backward an encoder layer and two a decoder
    layer; every-key calls (the encoder's and cross-attention's) counted
    under ``_prefix`` and ``_full`` too."""
    e, d = cfg.n_encoder_layers, cfg.n_layers
    return {"flash_attention": e + 4 * d, "flash_attention_tc": e + 4 * d,
            "flash_attention_prefix": e + 2 * d, "flash_attention_full": e + 2 * d,
            "flash_attention_bwd": e + 2 * d, "flash_attention_bwd_tc": e + 2 * d,
            "flash_attention_bwd_prefix": e + d, "flash_attention_bwd_full": e + d}


ENCDEC_TRAINER = MaskedTrainer(
    phase="train_encdec", arch=ENCDEC_ARCH, kind="cross", mask="full",
    tokens=ENCDEC_TRAIN_TOKENS, tail=ENCDEC_TRAIN_ARGV, resume_layers=ENCDEC_RESUME_LAYERS,
    report=ENCDEC_REPORT, fault=cross_prefix_zero, fault_name="prefix 0 on cross-attention",
    flops=encdec_train_model_flops, flops_formula=ENCDEC_FLOPS_FORMULA,
    extras=lambda cfg, b, s: {"encoder_layers": cfg.n_encoder_layers, "frames_per_step": b * s},
    named_leaves=("frontend/proj_in/w", "encoder/0/attn/wq/w", "layers/0/xattn/wk/w"),
    layer_kinds=("enc", "cross"), fault_kind="cross", launches=encdec_launches)


# --------------------------------------------------------------------------
# Phase 8g: train every config of ARCHS at its reduced widths
# --------------------------------------------------------------------------

# launch.train's command line for every config of ARCHS at configs.reduced()
# (d_model 64, 4 heads of 16 on at most 2 KV heads, 2 layers; deepseek's MLA
# at q/k 24 over v 16; recurrentgemma one Griffin period at window 32;
# mamba2 SSD heads of 16, state 16, chunks of 32; paligemma 8 patch rows;
# seamless 2 + 2 layers): 4 x 64 tokens a step (past the reduced window and
# two SSD chunks), TRAIN_STEPS steps, no checkpoints.  At these widths every
# flash call, forward and backward, runs on the CUDA cores (simt).
REDUCED_TRAIN_TOKENS = (4, 64)
REDUCED_TRAIN_ARGV = ("--reduced", "--global-batch", str(REDUCED_TRAIN_TOKENS[0]), "--seq-len",
                      str(REDUCED_TRAIN_TOKENS[1]), "--steps", str(TRAIN_STEPS),
                      "--checkpoint-every", "1000", "--seed", "0")
# One step's loss and whole-model gradients on the card against the same f32
# state and batch on the CPU, where every kernel takes its plain version:
# the loss within REDUCED_LOSS_TOL relative, each leaf within
# REDUCED_GRAD_TOL relative L2 (tests/test_torch_train.py's LOSS_TOL and
# MODEL_TOL, which hold the port's CPU path to repro's).  The MoE configs'
# CPU step replays the card's routing (a near-tie routed apart by the two
# paths' last bits would move an expert's gradient past any tolerance).
# The planted fault drops D = sum(dO * O) from REDUCED_FAULT_ARCH's flash
# backward on the card.  Set before the first card run.
REDUCED_LOSS_TOL, REDUCED_GRAD_TOL = 2e-3, 3e-2
REDUCED_FAULT_ARCH = "qwen3-0.6b"


def reduced_bwd_calls(cfg) -> int:
    """The flash backward's calls a training step of ``cfg``: one for each
    attention layer, two for a decoder layer with cross-attention, one for
    each encoder layer."""
    from repro_torch.models import transformer as tf

    per_kind = {"attn": 1, "attn_local": 1, "mla": 1, "mla_moe": 1, "moe": 1, "cross": 2}
    return cfg.n_encoder_layers + sum(per_kind.get(k, 0) for k in tf.layer_kinds(cfg))


def card_cpu_errors(torch, cfg, params, batch, fault=contextlib.nullcontext):
    """One step on the card (``params`` and ``batch`` there, under
    ``fault``) against the same step on copies on the CPU: (the loss's
    relative difference, per-leaf relative L2 of the gradients); an MoE's
    CPU step replays the card's routing (:class:`RoutingLog`)."""
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    log = RoutingLog(moe._top_k)
    moe._top_k = log
    try:
        loss, got = loss_and_grads(torch, cfg, params, batch, fault)
        log.replaying = True
        want_loss, want = loss_and_grads(
            torch, cfg, tree_map(lambda t: t.detach().cpu(), params),
            {k: v.cpu() for k, v in batch.items()})
    finally:
        moe._top_k = log.top_k
    check(len(log.agree) == len(log.calls), f"{cfg.name}: {len(log.calls)} routings on the "
                                            f"card, {len(log.agree)} replayed on the CPU")
    return (abs(loss - want_loss) / abs(want_loss),
            {n: rel_err(torch, g.cpu(), want[n]) for n, g in got.items()})


def phase_train_reduced(torch, device, card: str):
    """Every config of ARCHS at ``configs.reduced()`` on the card: trained
    through ``launch.train.main`` (``REDUCED_TRAIN_ARGV``; the launch
    counters set to 0 just before and read just after: every flash launch
    on the simt route, none on tc, the backward once for each attention
    call of each step; the SSD scan's forward and backward for mamba2),
    repro's fixed-batch rule (``FIXED_BATCH_STEPS`` steps on one batch,
    the last loss below ``FIXED_BATCH_RULE`` of the first), and one step's
    loss and gradients held to the CPU's (``card_cpu_errors``), with
    ``REDUCED_FAULT_ARCH``'s planted fault rejected.  Returns the launches
    of the training windows."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_map

    total = collections.Counter()
    for arch in sorted(ARCHS):
        t0 = time.perf_counter()
        run = train_window(torch, device, ("--arch", arch, *REDUCED_TRAIN_ARGV))
        state, launches, loss = run.pop("state"), run["launches"], run["loss"]
        cfg, shape = run["cfg"], run["shape"]
        total.update(launches)
        calls = TRAIN_STEPS * reduced_bwd_calls(cfg)
        flash = {k: n for k, n in launches.items() if k.startswith("flash_attention")}
        tc = {k: n for k, n in flash.items() if "_tc" in k}
        check(not tc and launches.get("flash_attention_bwd", 0)
              == launches.get("flash_attention_bwd_simt", 0) == calls,
              f"{arch} reduced: flash launches {flash}; want {calls} backward calls, all simt")
        if cfg.family == "ssm":
            check(launches.get("ssd_scan", 0) > 0 and launches.get("ssd_scan_bwd", 0) > 0,
                  f"{arch} reduced: the SSD scan launches {launches}")
        del state

        # repro's fixed-batch rule (tests/test_runtime.py:37) at the reduced config.
        fixed_cfg = AdamWConfig(lr=3e-3, total_steps=FIXED_BATCH_STEPS, warmup_steps=2,
                                weight_decay=0.0)
        step_fn = steps_lib.make_train_step(cfg, fixed_cfg)
        state = steps_lib.init_state(cfg, torch.Generator(device=device).manual_seed(SEED),
                                     device)
        raw = next(synthetic_batches(cfg, shape, seed=1))
        batch = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
        params = tree_map(lambda t: t.clone(), state["params"])
        fixed = []
        for _ in range(FIXED_BATCH_STEPS):
            state, m = step_fn(state, batch)
            fixed.append(float(m["loss"]))
        del state

        # One step on the card against the CPU, on the initial state.
        loss_err, errs = card_cpu_errors(torch, cfg, params, batch)
        line = {"phase": "train_reduced", "card": card, "arch": arch, "family": cfg.family,
                "layers": cfg.n_layers, "head_dim": cfg.head_dim,
                "tokens_per_step": list(REDUCED_TRAIN_TOKENS), "losses": loss,
                "step_seconds_median_3_20": run["step_s"], "launches": launches,
                "fixed_batch_losses": fixed, "last_over_first": fixed[-1] / fixed[0],
                "rule": FIXED_BATCH_RULE, "card_vs_cpu_loss_rel_err": loss_err,
                "card_vs_cpu_per_leaf_rel_err_max": max(errs.values()),
                "worst_leaves": sorted(errs.items(), key=lambda kv: -kv[1])[:3],
                "tol": {"loss": REDUCED_LOSS_TOL, "grads": REDUCED_GRAD_TOL}}
        if arch == REDUCED_FAULT_ARCH:
            bad_loss, bad = card_cpu_errors(torch, cfg, params, batch, drop_delta)
            line.update(planted_fault="the flash backward drops D = sum(dO * O)",
                        fault_per_leaf_rel_err_max=max(bad.values()),
                        fault_rejected=max(bad.values()) > REDUCED_GRAD_TOL)
            check(line["fault_rejected"], "the card-against-CPU check passes a backward that "
                                          "drops D")
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        check(fixed[-1] < FIXED_BATCH_RULE * fixed[0],
              f"{arch} reduced, fixed batch: last loss {fixed[-1]} not below "
              f"{FIXED_BATCH_RULE} of {fixed[0]}")
        check(loss_err <= REDUCED_LOSS_TOL and max(errs.values()) <= REDUCED_GRAD_TOL,
              f"{arch} reduced: the card's step against the CPU's, loss {loss_err}, "
              f"gradients {max(errs.values())}")
        del params, batch
    torch.cuda.empty_cache()
    return dict(total)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # torch.compile (phase 5g's library call) compiles in this process and
    # keeps its caches in the kernels' gitignored build directory.
    build = ROOT / "src" / "repro_torch" / "kernels" / "_build"
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_COMPILE_THREADS"] = "1"
    # The allocator grows its segments in place: with fixed cached segments
    # recurrentgemma-2b's trainer (phase 8d) ran out of the card's memory at
    # step 18 of 20 with 13.7 GiB cached but unallocated between them.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime

    load_peaks()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    laps, last_lap = {}, [t0]

    def lap(name):  # host seconds of each part of the run
        now = time.perf_counter()
        laps[name], last_lap[0] = now - last_lap[0], now
    compiled = runtime.build()  # one nvcc per source, all started together
    for name in runtime.SOURCES:
        runtime.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "compiled": compiled,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    lap("build")
    card = nvidia_smi()
    print(card, flush=True)
    emit({"phase": "scale", "reduced": [
              "gemma-2b's int8 decode (phase 5g): one prompt of 2040 tokens, cut from four "
              "(64, 512, 1024 and 2040), to keep the run's time with phase 8b added",
              "the trainers' checkpoints (phases 5h, 8b-8f): only step 10's of the three "
              "the loop asks for (10, 20, 20 again), which the resume reads: a run may write "
              "45 GiB to the machine's disk",
              "deepseek-v2-lite-16b trained (phase 8c) at its published widths cut to 2 layers "
              "of 27 (the dense first layer and one MoE layer, 876M parameters; 3 until phase "
              "8d took the time and the disk): all 27 layers' f32 masters, gradients and AdamW "
              "moments would take 251 GB",
              "granite-moe-3b-a800m's resume check (phase 8c) at its published widths cut to "
              "2 layers of 32 (4 until phase 8d's checkpoint needed the disk): a checkpoint "
              "of all 32 layers' state would be 40 GB (its timed run trains without "
              "checkpoints)",
              "granite-moe-3b-a800m's timed run (phase 8c) at its published widths cut to 8 "
              "layers of 32 (all 32 until phase 8f took the time, 16 until phase 8g did)",
              "serving through ServeEngine (phases 4, 5, 5b, 5c, 5d, 5g): four requests each "
              "through two slots, cut from eight through four, to keep the run's time with "
              "phase 8d added",
              f"recurrentgemma-2b's timed run (phase 8d) at its published widths cut to "
              f"{HYBRID_TIMED_LAYERS} layers of 26 (4 of its 8 attn_local layers; all 26 "
              "until phase 8f took the time)",
              f"recurrentgemma-2b's resume check (phase 8d) at its published widths cut to "
              f"{HYBRID_RESUME_LAYERS} layers of 26 (one Griffin period: rec, rec, "
              "attn_local): a checkpoint of all 26 layers' state would be 34.7 GB (its timed "
              "run trains without checkpoints)",
              f"qwen3-0.6b's resume check (phase 5h) at its published widths cut to "
              f"{TRAIN_RESUME_LAYERS} layers of 28 (all 28 until phase 8e's checkpoint needed "
              "the disk): a checkpoint of all 28 layers' state is 7.15 GB, of 2 layers 2.2 GB "
              "(its timed run trains all 28 layers, without checkpoints)",
              f"paligemma-3b's resume check (phase 8e) at its published widths cut to "
              f"{VLM_RESUME_LAYERS} layers of 18: a checkpoint of all 18 layers' state would be "
              "30.1 GB (its timed run trains all 18 layers, without checkpoints)",
              f"mamba2-370m's resume check (phase 8b) at its published widths cut to "
              f"{SSM_RESUME_LAYERS} layers of 48 (all 48 until phase 8f's checkpoint needed the "
              "disk): a checkpoint of all 48 layers' state is 4.42 GB, of 2 layers 0.80 GB (its "
              "timed run trains all 48 layers, without checkpoints)",
              f"seamless-m4t-large-v2's resume check (phase 8f) at its published widths cut to "
              f"{ENCDEC_RESUME_LAYERS} encoder and {ENCDEC_RESUME_LAYERS} decoder layers of 24 + "
              "24: a checkpoint of all layers' state would be 16.4 GB (its timed run trains all "
              "48 layers, without checkpoints)",
              f"seamless-m4t-large-v2's training (phase 8f) in {ENCDEC_MICROBATCHES} "
              "microbatches of its 4 x 2048 tokens and frames (repro's --microbatches): in one, "
              "its f32 logits ran out of the card's memory at step 3; its first-step gradient "
              "check on the first microbatch",
              f"recurrentgemma-2b's training (phase 8d) in {HYBRID_MICROBATCHES} microbatches "
              "of its 2 x 4096 tokens (repro's --microbatches): in one, its f32 logits and "
              "their softmax's backward ran out of the card's memory; its first-step gradient "
              "check on the first microbatch",
              "phase 8g trains every config of ARCHS at configs.reduced() (d_model 64, 4 heads "
              "of 16, 2 layers, vocab 128; 4 x 64 tokens, 20 steps): the reduced widths are "
              "what the phase checks (the CUDA-core flash route at hd 16 and MLA's (24, 16)); "
              "each config's published widths train, or are cut in depth, in its own phase"],
          "note": "TPC-H SF1 row counts and 256 KiB pages as stated; gemma-2b at its "
                  "published widths and all 18 layers, random weights; mamba2-370m at "
                  "its published widths and all 48 layers, random weights with dt_bias "
                  "per layer and head the inverse softplus of a log-uniform draw in "
                  "[1e-3, 1e-1] (Mamba-2's dt initialisation); the blocked matmul at the "
                  "five LLM products of benchmarks/bench_kernel_policy.py, published widths "
                  "and full token blocks; TPC-H Q3 and Q18 DAGs at SF1 row counts; "
                  "granite-moe-3b-a800m at its published widths and all 32 layers, random "
                  "weights; deepseek-v2-lite-16b at its published widths (MLA, kv_lora_rank "
                  "512, 64 experts top-6 and 2 shared) and all 27 layers, random weights; "
                  "recurrentgemma-2b at its published widths (RG-LRU 2560, local attention "
                  "window 2048) and all 26 layers, random weights; paligemma-3b at its "
                  "published widths (the gemma-2b backbone, 18 layers, 256 patch embeddings "
                  "of 1152 projected in, prefix-LM mask), random weights and patches; "
                  "seamless-m4t-large-v2 at its published widths (24 bidirectional encoder "
                  "and 24 decoder layers with cross-attention, d_model 1024, 4096 frames of "
                  "1024), random weights and frames; gemma-2b with Gemma 2's attention and "
                  "final logit softcaps (50, 30) at its published widths and all 18 layers, "
                  "its decode also over its int8 KV cache at max_len 4096; qwen3-0.6b "
                  "trained at its published widths and all 28 layers (4 x 2048 tokens a "
                  "step, 20 steps), random weights and synthetic tokens; mamba2-370m "
                  "trained at its published widths and all 48 layers (4 x 2048 tokens a "
                  "step, 20 steps), random weights and synthetic tokens; granite-moe-3b-a800m "
                  "trained at its published widths and 8 of its 32 layers (4 x 2048 tokens a "
                  "step, 20 steps, capacity factor 1.25), random weights and synthetic tokens; "
                  "recurrentgemma-2b trained at its published widths and 14 of its 26 layers (2 x "
                  "4096 tokens a step, past its window of 2048; 20 steps), random weights and "
                  "synthetic tokens; paligemma-3b trained at its published widths and all 18 "
                  "layers (4 x 2048 positions a step: 256 patches and 1792 text tokens, "
                  "one microbatch, 20 steps), random weights, patches and "
                  "synthetic tokens; seamless-m4t-large-v2 trained at its published widths and "
                  "all 24 + 24 layers (4 x 2048 tokens and 4 x 2048 frames a step, two "
                  "microbatches, 20 steps), random weights and frames and synthetic tokens; "
                  "nothing else cut"})

    checkpoint_reckoning(torch)
    errs, rows = phase_kernels(torch, device)
    attn_errs, attn_rows = phase_attention(torch, device)
    errs.update(attn_errs)
    rows.update(attn_rows)
    lap("kernels")
    launches = phase_session(torch, device)
    for name, n in phase_dag(torch, device).items():
        launches[name] = launches.get(name, 0) + n
    lap("session_dag")
    serve_launches, params = phase_serve(torch, device)
    phase_breakdown(torch, device, params)
    del params
    launches.update({name: serve_launches[name] for name in SERVE_KERNELS})
    lap("gemma-2b")
    scan_errs, scan_rows = phase_ssd_scan(torch, device)
    errs.update(scan_errs)
    rows.update(scan_rows)
    mamba_launches, params = phase_mamba_serve(torch, device)
    phase_mamba_breakdown(torch, device, params)
    del params
    launches["ssd_scan"] = mamba_launches["ssd_scan"]
    lap("mamba")
    moe_launches, params, (layer, routing) = phase_moe_serve(torch, device)
    phase_moe_breakdown(torch, device, params)
    del params
    for name in SERVE_KERNELS:
        launches[name] += moe_launches[name]
    for name, err in phase_moe_dispatch(torch, device, layer, routing).items():
        errs[name] = max(errs.get(name, 0.0), err)
    del routing
    lap("granite-moe")
    torch.cuda.empty_cache()  # granite-moe's 6.6 GB back before deepseek's 31 GB
    mla_errs, mla_rows = phase_mla_kernels(torch, device)
    errs.update(mla_errs)
    rows.update(mla_rows)
    phase_mla_layer(torch, device)
    mla_launches, params, step_bound = phase_mla_serve(torch, device)
    phase_moe_breakdown(torch, device, params, arch=MLA_ARCH, step_bound_ms=step_bound)
    del params
    torch.cuda.empty_cache()
    launches.update({name: mla_launches[name] for name in MLA_KERNELS})
    lap("deepseek")
    hyb_errs, hyb_rows = phase_hybrid_kernels(torch, device)
    errs.update(hyb_errs)
    rows.update(hyb_rows)
    phase_hybrid_layer(torch, device)
    hyb_launches, params = phase_hybrid_serve(torch, device)
    phase_hybrid_breakdown(torch, device, params)
    del params
    torch.cuda.empty_cache()
    for name in SERVE_KERNELS:
        launches[name] += hyb_launches[name]
    launches["flash_attention_windowed"] = hyb_launches["flash_attention_windowed"]
    launches["paged_attention_ring"] = hyb_launches["paged_attention"]
    lap("recurrentgemma")
    vlm_errs, vlm_rows = phase_vlm_kernels(torch, device)
    errs.update(vlm_errs)
    rows.update(vlm_rows)
    phase_vlm_layer(torch, device)
    vlm_launches = phase_vlm_serve(torch, device)
    torch.cuda.empty_cache()
    lap("paligemma")
    enc_errs, enc_rows = phase_encdec_kernels(torch, device)
    errs.update(enc_errs)
    rows.update(enc_rows)
    phase_encdec_layer(torch, device)
    enc_launches = phase_encdec_serve(torch, device)
    torch.cuda.empty_cache()
    lap("seamless")
    for name in SERVE_KERNELS:
        launches[name] += vlm_launches[name] + enc_launches[name]
    launches["flash_attention_prefix"] = vlm_launches["flash_attention_prefix"]
    launches["flash_attention_full"] = enc_launches["flash_attention_full"]
    launches["paged_attention_cross"] = enc_launches["paged_attention_cross"]
    sc_errs, sc_rows = phase_softcap_kernels(torch, device)
    errs.update(sc_errs)
    rows.update(sc_rows)
    lap("softcap_kernels")
    sc_launches, params = phase_serve(torch, device, softcap_config(), "softcap")
    phase_breakdown(torch, device, params, softcap_config(), "softcap_breakdown")
    lap("softcap_serve")
    int8_launches = phase_int8_decode(torch, device, params)
    lap("int8_decode")
    del params
    torch.cuda.empty_cache()
    for name in SERVE_KERNELS:
        launches[name] += sc_launches[name]
    for name in ("flash_attention_softcap", "paged_attention_softcap"):
        launches[name] = sc_launches[name]
    launches["paged_attention_int8"] = int8_launches["paged_attention_int8"]
    tr_errs, tr_rows = phase_train_kernels(torch, device)
    errs.update(tr_errs)
    rows.update(tr_rows)
    lap("train_kernels")
    phase_train_layer(torch, device)
    launches["flash_attention_bwd_tc"] = phase_train_run(torch, device,
                                                         card)["flash_attention_bwd_tc"]
    launches["flash_attention_bwd_simt"] = phase_train_gemma_tc_run(
        torch, device)["flash_attention_bwd_simt"]
    lap("train")
    ssm_errs, ssm_rows = phase_scan_bwd_kernels(torch, device)
    errs.update(ssm_errs)
    rows.update(ssm_rows)
    phase_ssm_train_layer(torch, device)
    ssm_launches = phase_ssm_train_run(torch, device, card)
    launches["ssd_scan"] += ssm_launches["ssd_scan"]
    launches["ssd_scan_bwd"] = ssm_launches["ssd_scan_bwd"]
    lap("train_ssm")
    launches["flash_attention_bwd_tc"] += phase_moe_train(torch, device,
                                                          card)["flash_attention_bwd_tc"]
    lap("train_moe")
    for fam in (HYBRID_TRAINER, VLM_TRAINER, ENCDEC_TRAINER):
        phase_masked_train_layer(torch, device, fam)
        trained, _ = phase_masked_train(torch, device, card, fam)
        launches["flash_attention_bwd_tc"] += trained["flash_attention_bwd_tc"]
        lap(fam.phase)
    reduced_launches = phase_train_reduced(torch, device, card)
    launches["flash_attention_bwd_simt"] += reduced_launches["flash_attention_bwd_simt"]
    launches["ssd_scan"] += reduced_launches["ssd_scan"]
    launches["ssd_scan_bwd"] += reduced_launches["ssd_scan_bwd"]
    lap("train_reduced")
    mm_errs, mm_rows, launches["matmul"] = phase_matmul(torch, device, card)
    errs.update(mm_errs)
    rows.update(mm_rows)
    lap("matmul")

    kernels = []
    for name, row in rows.items():
        check(launches.get(name, 0) > 0, f"the main path never launched {name}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "device_ms": row.get("device_ms"),
        })
    emit({"phase": "seconds", "by_part": laps, "total": time.perf_counter() - t0})
    emit({"card": card, "kernel_shapes": {n: r["shape"] for n, r in rows.items()}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
