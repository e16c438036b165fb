#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths (``src/repro_torch``) on the card at the full
width of the ``dade_ivf`` workload and fails (nonzero exit, no result line)
on any fault.  Phases, one line each:

  1. build: ``nvcc`` builds the five kernels (ivf_scan, graph_scan,
     dade_dco, quant_dco, l2_scan) and ivf_scan's timing build from
     ``csrc/``, all at once; the card's name and power limit as
     ``nvidia-smi`` reports them;
  2. parity: ivf_scan against its plain PyTorch version on identical
     inputs — awkward small shapes at both query-tile widths (8, 16),
     split into 2 and 8 segments, and one full-width slice unsplit and
     split as served;
  3. ivf: ``build_ivf`` (twice: the two builds must be identical) +
     ``search_ivf_fused`` on a 2^20 x 256 corpus, the kernel held against
     the plain version on the search's own inputs;
  4. serve: the flat serving route (``repro_torch.launch.serve``) at the
     ``dade_ivf`` configuration, 40 requests, recall@100 >= 0.95, with one
     shard and then (the main path) with the served shard count;
  5. ivf_scan at the serving shape as served: time beside its bound, the
     plain version's time (its output held against the kernel's at that
     shape) and one library call's time; then the design alternatives of
     phase 5b: every (query-tile width, segments) pair timed in this run with its fetched bytes, slabs and recall per query, and the
     phase clocks of the timing build at the one-walk 8-query configuration
     and at the served one;
  6. graph parity: the one-wave graph_scan kernel against its plain
     version on awkward waves (EF 1/48/128, both threshold columns, frozen
     r², bf16 rows, Δd 32/64, -1 gaps with repeats across them, vis_base
     != 0, bit 31 set); then (6b, once the graph of phase 7 is built) the
     walk kernel, which runs a whole search in one launch, against the
     plain walk on 203 queries of that graph: defaults, seed_r, coupled,
     route_mult 1.2, bf16 rows and a max_waves cap, bit for bit on the
     window, every wave's stats rows, the final bitmap and each tile's wave
     count, the tiles converging at different waves;
  7. graph route: the NSW graph of a 16,384 x 256 corpus (m = 16,
     ef_construction 96, f32 rows, Δd = 64, DADE at p_s = 0.02) and
     ``search_graph_fused`` for 1024 queries (k = 10, ef = 48, expand 2):
     one walk launch per search and none of the host's per-wave selection,
     the search's wall time, the card's busy share (``torch.profiler``) and
     the rest on the host; the walk held against the plain walk
     (``search_graph_beam_host``) bit for bit, recall@10 >= 0.80; the walk
     timed beside its bound and the plain walk, and every wave of the search
     through the one-wave kernel (the route it replaced) for comparison;
  8. graph serve: ``serve --index graph`` on the same graph, 200 requests
     (about 250 batches) served twice, one walk launch per batch;
  9. flat screen parity: dade_dco, quant_dco and l2_scan against their
     plain versions on awkward cases (D 64/200/384/256 at Δd 32/64/128/64,
     ragged N and Q, bf16 inputs, r² = 0, 1e30 and inf, DADE, ADSampling
     and FDScanning tables, a query tile that retires after one block);
     the two screens on each path of their kernel (``_screen.PATH_CASES``:
     a 128 x 64 tile with exactly the list's capacity of block-1 survivors
     and with one more, every pair surviving every block at r² = 1e30, Q
     and N ragged against the tile at D 384 / Δd 128 and at Δd 16), the
     path each tile took read off dims (``_screen.screen_work``); then at
     the full shape (1024 x 2^20 x 256, Δd = 64): the main path's outputs
     of phase 10 against the plain versions run over 64 Ki-row chunks of
     the corpus;
 10. the flat DCO screen (the paper's Fig. 3 workload): ``build_flat``
     (DADE, Δd = 64, p_s = 0.02, int8) of the 2^20 x 256 corpus, the
     1024 queries of phase 3 and r² = the squared 100th exact distance;
     ``ops.dco_screen_kernel``, ``ops.quant_screen_kernel`` and
     ``l2_scan_kernel_call`` once each: l2's top-100 is the exact top-100,
     the fp32 screen passes >= 0.95 of it, the int8 prefilter prunes no
     row inside r² and nothing the fp32 screen passes; the dense (tile,
     block) steps and list entries each screen ran; each kernel timed
     beside its bound, its plain version and (l2_scan) ``torch.cdist``,
     timed in the same run, the screens also beside the instruction floor (a
     separate rounded multiply and add per product) and their time before
     the redesign;
 11. the flat index: ``search_flat`` (k = 100, wave 8192), fp32 and
     ``use_quant``, recall@100 >= 0.95 and the same ids from both;
 12. continuous graph serving (run after phase 8, on its graph): ``serve
     --index graph --continuous`` at max_live 1024 (k = 10, ef = 48,
     expand 2) — 8 interleaved queries bit-identical to each served alone
     by the walk kernel and by the plain walk (``--verify-graph-oracle``);
     a closed loop of 10 requests in which every query served (warm-up
     and verify included) returns the ids and distances of the same query
     walked alone by the walk kernel (one-query tiles stacked in one
     launch), and the recall@10 of those solo walks; an open loop of 200
     requests of 32-127 queries at half the closed loop's query rate under
     a deadline, a watermark, 2 retries and a ``step_error:count=2`` drill
     (every request served, none shed for an error, the drill's two
     errors retried); each metrics JSON through
     ``scripts/check_metrics_schema.py``; then at full occupancy the
     wave's host split (tracer spans), the reference's per-slot loop on
     the same state, the card's busy share, and one stacked launch of the
     one-wave kernel at the 1024-tile bucket held against its plain
     version and timed; and phase 7's queries walked alone at expand 2, 4,
     8 and 16;
 13. continuous IVF (run after phase 3, on its index): 64 queries through
     ``ContinuousIVFEngine`` (n_probe 16, two probes a launch) under a
     seeded random admission schedule, each bit-identical to its solo
     ``search_ivf_fused(block_q=8)``: ids, distances, ledger; and the
     engine's widest launch with carried windows (``top0_sq``/``top0_ids``)
     held against the plain version on the same inputs;
 14. churn serving (run after phase 8): ``serve --index graph --mutate-rate
     32`` over 4,096 nodes of the same width and settings (40 requests,
     1,280 mutations, 3:1 upserts to deletes, upserts from the drifted
     distribution, a write-ahead log, ``--chaos torn_upsert:after=2`` and
     ``--verify-graph-oracle``): (a) after the crash and its recovery the
     mutated index returns the ids of a from-scratch ``build_graph`` of the
     final corpus under the same tombstones, distances to rtol 5e-5 /
     atol 1e-5; (b) its arrays (neighbours, codes, scales, the adjacency
     slabs, the entry) equal the rebuild's bit for bit; (c) one request's
     walk launch, deleted rows pre-set in its bitmap, equals the plain walk
     bit for bit and expands no tombstoned node; (d) the mutation ledger
     closes, the replay reports the torn tail, the metrics pass the schema
     check, recall@10 against the live corpus is printed; (e) phase 7's
     graph saved by ``serve --index-ckpt`` and restored by a second serve
     that builds nothing serves the same ids, its arrays and searches equal
     the original's bit for bit, and the flat route's estimator snapshot
     serves the ids the built estimator served;
 15. multi-device serving (run after phase 14, from its snapshot of phase
     7's graph), ranks sharing the one card: (a) ``search_graph_sharded``
     for S = 1, 2, 4 (one one-wave launch per shard a wave over its slab
     rows, the threshold frozen), ids and distances bit-identical across S
     and to the plain oracle (``num_shards=1, use_ref=True``), the same
     waves, per-shard fetch tuples summing to the S = 1 totals, each S
     timed; one sliced-slab launch (S = 4, shard 3, a middle wave) against
     ``ref.graph_scan_ref`` bit for bit; (b) the process-group engine
     (``annservice.sharded_graph_engine``) spawned at S = 2 and 4 over gloo,
     each rank loading its slab rows from the snapshot: (a)'s ids and
     distances, every rank's window and bitmap equal after every wave, the
     exchange bytes, the all-gather's ms a wave and the card's busy share;
     (c) ``serve --graph-shards 4`` (4 requests of phase 8's sizes, metrics
     schema), then under ``shard_death:shard=1:after=2`` with
     ``--verify-degraded-oracle``; (d)
     ``serve --continuous --graph-shards 2`` on a short closed loop, every
     retired query equal to its solo sharded walk (ids, distances,
     ledger); (e) ``serve --index flat --ranks 2 --shards 4`` with phase
     4's arguments (40 requests) returning phase 4's one-process ``--shards
     4`` ids, its QPS, recall@100 and merge ms.  Each serve's timed window is printed
     beside its rate.
 16. LM serving (``repro_torch.models``, plain PyTorch, no hand-written
     kernel): (a) ``gemma2-9b`` at full width in bf16, its depth cut from
     42 to 10 layers (room for phase 20), from the port's seeded
     initializer through ``launch.steps.build_cell``: a prefill of 4 x
     8,192 tokens (cut from ``prefill_32k``'s 32 x 32,768), the median of 2 timed runs after a warm one, and 16 decode steps after
     2 warm ones at batch 4 against ``decode_32k``'s 32,768-token caches
     (batch cut from 128), each beside its bound, with the peak memory;
     (b) the same model in float32 with its window cut to 16: the
     prefill's last-position logits of a 64-token prompt against 64
     teacher-forced decode steps from zeroed 64-slot caches (the windowed
     layers' 16-slot rings wrap), rtol = atol = 1e-3, and the same decode
     with the rings one slot short must fail it; (c) every LM
     architecture at its reduced config, the port's seeded model on the
     CPU and the same state on the card: prefill logits, every cache leaf
     and 4 decode steps, card against CPU at rtol = atol = 1e-4 (int8 KV
     codes equal but for near-ties, at most one in a thousand);
 17. LM training (``launch.steps.train_step``: ``LM.loss_fn`` with its
     backward through autograd, AdamW, gradient accumulation; plain
     PyTorch, no hand-written kernel): (a) ``gemma-2b`` at full width and
     depth in bf16 with remat through ``build_cell("gemma-2b", "train_4k")``
     on ``TokenPipeline`` batches of train_4k's 4,096 tokens, the batch cut
     from 256 to 4 (``grad_accum`` 2: two microbatches of 2): one warm-up
     step, the median of 2 timed steps beside the FLOP bound
     (``lm_train_flops``), tokens/s, peak memory, and one profiled step's
     busy share and device time by op; every loss and grad_norm finite, the
     last loss below the first; (b) float32 identities, each beside a
     planted fault that must fail it: gemma-2b at full width cut to 2
     layers, the same batch, grad_accum 2 against 1 at the reference's
     ``test_grad_accum_matches_full_batch`` tolerance (rtol 2e-3, atol
     2e-4; fault: the summed gradients not divided by 2), remat on against
     off within 1e-6 (fault: a weight moved between the forward and its
     recomputation), and every architecture's reduced train step on the
     card against the CPU within 1e-4 (loss, every gradient leaf, the
     parameters after one step); (c) the trainer drill: ``python -m
     repro_torch.launch.train --arch mamba2-130m`` at full width, 40 steps
     of 8 x 128 tokens, checkpoints every 20, a failure injected at step
     27, under ``--deterministic``; one restart, the loss improves, and
     the step-40 checkpoint equals an uninterrupted run's bit for bit
     (every leaf's sha256: parameters, both moments, the step).
 18. multi-device LM training (``launch.steps.DataParallel``: each rank
     holds its pieces of the parameters and AdamW moments, gathers the
     parameters, takes its rows of every microbatch and sums the gradients
     over the ranks; ``compressed_grad_allreduce``; plain PyTorch, no
     hand-written kernel): two ranks share the card over gloo (every
     collective staged through the host: the protocol, not NVLink); (c)'s
     trainer starts beside phase 17(b)-(c) and runs on beside (b), then (a)
     is timed alone on the card.  (a)
     ``mamba2-130m`` at full width and depth through ``build_cell``'s
     2-rank train step on 8 x 128 tokens, plain and with
     ``--grad-compress``: ms a step (median of 2 after a warm one) beside
     phase 17(c)'s one-process trainer, the bytes each collective kind
     carried and its share of the step, each rank's peak memory beside
     ``spec_bytes`` of its state; (b) float32 identities beside planted
     faults: the 2-rank step against the one-process step (loss, aux, every
     gradient leaf, the parameters after one step; rtol 2e-3, atol 2e-4) on
     mamba2-130m at full width cut to 2 layers and on every reduced
     architecture (MoE at grad_accum 2), with the summed gradients not
     divided by 2 and a MoE aux from rank-local counts failing it; the
     compressed all-reduce equal bit for bit on both ranks with ``mean +
     new_e`` equal to ``g + e`` within 1e-5; (c) ``python -m
     repro_torch.launch.train --devices 2 --grad-compress --dist-backend
     gloo --deterministic`` at full width, 20 steps, checkpoints every 10,
     a failure at 13: one restart, the loss falls; its step-20 checkpoint
     restored in one process (``elastic_restore``), every leaf's sha256
     equal to the 2-rank leaves', written again by that process and
     restored onto the two ranks, the gathered leaves' sha256 the same.
 19. the launch tooling (``launch.{op_census, roofline, dryrun, perf,
     report}``): (a) ``python -m repro_torch.launch.dryrun`` of every cell
     on both production layouts (16 x 16 and 2 x 16 x 16 ranks, on
     ``device="meta"``), started at phase 1 beside the card phases (niced,
     one torch thread a worker) and collected after phase 18: no record an
     error, the skips the reference's (long_500k for the six
     full-attention architectures, its words), every ``argument_bytes``
     the sum of ``spec_bytes`` of the cell's in_shardings (recomputed
     here), the dry run's wall time, the train cells whose argument +
     temp bytes of one (data, model) rank exceed the card's 80 GB, and
     ``roofline --md`` / ``report`` over the records; (b) one more step
     of phase 17(a)'s gemma-2b under ``op_census.census`` on the card, against the same cell's census on
     meta at the same rows (also started at phase 1): FLOPs equal exactly,
     the bytes side by side with the ops that differ, the FLOPs beside
     ``lm_train_flops``, the one-card roofline bound beside 17(a)'s
     measured step, the allocator's peak beside the census's; (c) phase
     5's served batch through ``build_search_step`` under the census: the
     kernel's reported operations and bytes equal phase 5's
     (``ivf_scan.work`` on the same counters), and (checked in (a)) the
     least work the same step counts on meta, in the dry run's
     ``dade-ivf`` record, is no more.  Every figure of (a) and of the
     bound in (b) is a count at the H100's data-sheet constants
     (``launch.roofline``), not a measurement.
 20. tensor parallelism (``launch.steps.DataParallel`` over a (data=1,
     model=2) mesh, the model executing the reference's ``constrain``
     sites over the model axis; plain PyTorch, no hand-written kernel):
     two gloo ranks share the card (every collective staged through the
     host: the protocol, not NVLink), started beside phase 7's host graph
     build, where the card is idle, and collected after it.  (a)
     ``gemma-2b`` at full width and depth in bf16 (the vocabulary, the
     MQA rule's gathered K/V columns, the GeGLU ``ffn`` split): one remat
     train step at grad_accum 2 on 2 x 1,024 tokens after a warm one, a
     prefill of 2 x 2,048 tokens, then 16 decode steps at batch 2 against
     4,096-token ``kv_seq``-split caches (the slots written across both
     ranks' blocks): ms a step, tokens/s, each collective kind's bytes and
     share, each rank's peak memory beside ``spec_bytes`` of its share,
     and the dry run's temp bytes of the same rank step counted on meta
     (``dryrun.rank_step``'s census peak plus ``model_piece_bytes``; a
     background run from phase 1), which must be no more than the
     allocator's peak, read after ``reset_peak_memory_stats()`` following
     the bind;
     (b) float32 identities: the 2-rank train step (loss, every gradient
     leaf gathered, the parameters after one step; rtol 2e-3, atol 2e-4),
     prefill and 8 decode steps' logits (1e-4) against one process, on
     ``gemma-2b`` at full width cut to 2 layers, beside two planted faults
     that must fail them (``wo``'s partial sums sliced, not reduced; the
     decode combine without rank 1's block of slots), and on every reduced
     architecture, mixtral also under ``{"expert": ("model",)}``.
 21. the pod axis (``launch.steps.DataParallel`` over a ("pod", "data",
     "model") = (2, 1, 2) mesh: the batch over pod x data, the gradients
     summed over both, the parameters and moments split over "data" only
     and replicated between pods; plain PyTorch, no hand-written kernel):
     four gloo ranks share the card (the protocol, not NVLink), started
     beside phase 7's build with phase 20 and begun once phase 20(a) is
     done.  (a) ``mamba2-130m`` at full width and depth on phase 18's 8 x
     128 tokens: one warm and two timed train steps: ms a step, tokens/s,
     each collective kind's bytes and share (the "pod" kinds included),
     each rank's peak memory beside ``spec_bytes`` of its share; (b)
     float32 identities against one process on ``mamba2-130m`` at full
     width cut to 2 layers (loss, every gradient leaf gathered, the
     parameters after one AdamW step; rtol 2e-3, atol 2e-4), beside two
     planted faults that must fail them: the gradients summed over "data"
     only (not "pod"), and every pod taking the same rows; (c)
     ``gemma2-9b`` at its reduced config under long_500k's rules, its
     cache slots split over model x data x pod, 12 decode steps against
     one process within 1e-4.

Each phase's start is stamped with the script's elapsed seconds.

The ``kernels`` line reports, for each kernel, its launches on the main
paths (phases 3 and 4's served run for ivf_scan, 7-8 for graph_scan's
walk, 10 for the flat screens): the launches of the call its ``ms``
times.  Its worst deviation from the plain version covers every parity
case of the kernel, the continuous phases' included.  Beside them stand
graph_scan's one-wave launches in phase 12 and their time at the
1024-tile bucket (``one_wave_launches``, ``one_wave_ms``) and ivf_scan's
launches in phase 13 and their median time (``continuous_launches``,
``continuous_ms``), graph_scan's walk launches in phase 14's churn serving
and snapshot serves (``churn_launches``, ``snapshot_launches``) and
ivf_scan's in phase 14's flat snapshot serves (``snapshot_launches``);
phase 15's one-wave launches over every rank (``sharded_launches``) and the
S = 4 host-simulated search's median ms (``sharded_s4_search_ms``), and
ivf_scan's launches in its flat serve over 2 ranks, every rank's
(``ranked_launches``).

Kernel parity rule: the top-K ids, the squared distances, every stats
counter, the visited bitmap and every screen output (estimates, flags,
dims) are equal bit for bit (tolerance zero): a kernel and its plain
version round every float operation alike, in the same order.  Float32
matmuls run in full float32 here: TF32 is switched off explicitly.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, the script fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The H100 SXM's data-sheet peaks at 700 W, from the port's roofline.
from repro_torch.launch.roofline import (  # noqa: E402
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS, PEAK_FP32_INSTR, PEAK_INT8_OPS)

DEV = "cuda"
# l2_scan's time at 1024 x 2^20 x 256 before its register-tiled body: the
# 16 x 128 screen skeleton's no-screen mode, in this script's final run on
# the commit that shipped it.
L2_SCAN_BEFORE_MS = 43.503
# dade_dco's and quant_dco's times at 1024 x 2^20 x 256 before their
# redesign (one CTA per 16 x 128 tile walking every block while any pair
# of the tile survived): this script's final run on the commit that
# shipped the redesign's parent, on an NVIDIA H100 80GB HBM3 at 700.00 W.
DADE_DCO_BEFORE_MS = 25.741
QUANT_DCO_BEFORE_MS = 35.322
# Requests served per run (each about 1.25 batches of 1024 queries), so
# that a timed window lasts seconds: phase 4's flat serving (one run per
# shard count) and phase 8's graph serving (SERVE_RUNS runs over the same
# requests, for the spread).
FLAT_REQUESTS = 40
GRAPH_REQUESTS = 200
SERVE_RUNS = 2
# Phase 7's graph (and so phases 8, 12, 14's snapshots and 15's): cut from
# serve's default of 32,768 nodes so that the script stays well inside its
# time limit: the host-side NSW build inserts one node at a time and took
# 155-242 s at 32,768 nodes on the card's host.
GRAPH_NODES = 16384
# Phase 12's requests per closed-loop continuous run (14,425 queries),
# chosen for a closed-loop window of 2-10 s, and its live-slot cap; the
# open loop's request count and batch (requests of 32-127 queries), enough
# requests for a latency tail.
CONT_REQUESTS = 10
CONT_MAX_LIVE = 1024
OPEN_REQUESTS = 200
OPEN_BATCH = 64
# Phase 13: queries served through the continuous IVF engine.
CONT_IVF_QUERIES = 64
# Phase 14: churn serving over CHURN_NODES rows (cut from serve's 32,768,
# and halved from 8,192 so that the script with phase 16 stays well inside
# its time limit: a boot, the recovery after the torn write and the
# oracle's rebuild each run the host NSW build), CHURN_REQUESTS requests
# with CHURN_RATE mutations before each, the walk launch held against the
# plain walk (the CHURN_CAPTURE-th of the run, mid-churn), and
# SNAPSHOT_REQUESTS requests per snapshot serve.
CHURN_NODES = 4096
CHURN_REQUESTS = 40
CHURN_RATE = 32
CHURN_CAPTURE = 30
SNAPSHOT_REQUESTS = 4
# Phase 15: the shard counts of the host-simulated walk and its timed runs
# each; the requests of each sharded graph serve (phase 8's sizes; few, so
# that the whole script stays well inside its time limit: at about 1,300
# queries/s they still make a window of seconds), and the batch of the
# continuous sharded serve (requests of 32-127 queries, each retired query
# then checked against its solo walk).  The flat route over ranks serves
# phase 4's FLAT_REQUESTS.
SHARDED_COUNTS = (1, 2, 4)
SHARDED_REPS = 2
SHARDED_REQUESTS = 4
SHARDED_CONT_BATCH = 64
# Phase 16: LM serving at full width.  gemma2-9b (bf16) prefills
# LM_PREFILL_BATCH x LM_PREFILL_SEQ tokens (cut from prefill_32k's 32 x
# 32,768 so that the phase fits the script's time; at 8,192 tokens the
# 4,096-token window binds) LM_PREFILL_RUNS timed times, and decodes
# LM_DECODE_STEPS timed steps after LM_DECODE_WARM at batch LM_DECODE_BATCH
# against decode_32k's cache length (batch cut from 128, whose caches
# would take about 811 GB).  (b)'s float32 self-consistency check: a
# LM_CHECK_SEQ-token prompt, the window cut to LM_CHECK_WINDOW so that the
# ring wraps, at LM_CHECK_TOL: 20x under the reference's own 2e-2
# (tests/test_models_smoke.py::test_decode_matches_forward), about 60x over
# what a sound run reads; the same decode with its windowed rings one slot
# short (a wrong window) must exceed it.  (c): the card against the CPU,
# float32 with TF32 off.
LM_ARCH = "gemma2-9b"
# (a)'s depth, cut from 42 to make room for phase 20 within the script's
# time (5 windowed, then 5 global layers); (b) and (c) keep their own
# depths.
LM_LAYERS = 10
LM_PREFILL_BATCH, LM_PREFILL_SEQ, LM_PREFILL_RUNS = 4, 8192, 2
LM_DECODE_BATCH, LM_DECODE_WARM, LM_DECODE_STEPS = 4, 2, 16
LM_CHECK_SEQ, LM_CHECK_WINDOW, LM_CHECK_TOL = 64, 16, 1e-3
LM_CARD_TOL = 1e-4
# Phase 17: LM training at full width.  (a) gemma-2b (bf16, remat,
# grad_accum 2) trains on TRAIN_BATCH rows of train_4k's 4,096 tokens (cut
# from 256 rows for memory and time: two microbatches of 2), TRAIN_WARM
# warm-up step(s), TRAIN_STEPS timed ones, then one profiled; if the whole
# script nears its limit, TRAIN_STEPS is cut first, never the width, depth
# or sequence.  (b) the float32 identities at full width, depth cut to
# TRAIN_CHECK_LAYERS, at the reference's grad-accumulation tolerance and
# remat's; every reduced architecture card against CPU at TRAIN_CARD_TOL,
# one AdamW step at TRAIN_CARD_LR (a near-zero gradient's sign, which the
# two devices may round apart, then moves a parameter by at most 2 x lr,
# inside the tolerance).  (c) the trainer drill's arguments.
TRAIN_ARCH = "gemma-2b"
TRAIN_BATCH, TRAIN_WARM, TRAIN_STEPS = 4, 1, 2
# (a)'s learning rate, reached at the first step: Adam moves every one of
# the 2.5 B weights by about lr on its first steps, and at the trainer's
# 3e-4 that overshoots (the loss rose 10.70 -> 14.05 over three steps on
# the card); a run this short has no room for the schedule's warmup.
TRAIN_LR = 1e-5
TRAIN_CHECK_LAYERS = 2
TRAIN_ACCUM_RTOL, TRAIN_ACCUM_ATOL = 2e-3, 2e-4
TRAIN_REMAT_TOL = 1e-6
TRAIN_CARD_TOL, TRAIN_CARD_LR = 1e-4, 3e-5
DRILL_ARGS = ["--arch", "mamba2-130m", "--steps", "40", "--batch", "8", "--seq", "128",
              "--ckpt-every", "20", "--deterministic"]
DRILL_FAIL_AT = 27
# Phase 18: multi-device training.  DP_RANKS gloo ranks on the card; (a)
# the reference trainer's default model at full width, DP_BATCH x DP_SEQ
# tokens (its default batch), DP_WARM warm-up and DP_STEPS timed steps of
# each of the plain and the compressed step at DP_LR; (b) the identities at
# phase 17(b)'s grad-accumulation tolerance, the full-width model cut to
# DP_CHECK_LAYERS layers, one AdamW step at TRAIN_CARD_LR; the compressed
# all-reduce's reconstruction gate DP_RECON_TOL (the reference's); (c) the
# trainer drill's arguments.
DP_ARCH, DP_RANKS = "mamba2-130m", 2
DP_BATCH, DP_SEQ, DP_WARM, DP_STEPS, DP_LR = 8, 128, 1, 2, 3e-4
DP_CHECK_LAYERS = 2
DP_RECON_TOL = 1e-5
DP_DRILL_ARGS = ["--arch", DP_ARCH, "--devices", str(DP_RANKS), "--grad-compress",
                 "--dist-backend", "gloo", "--deterministic", "--steps", "20",
                 "--batch", str(DP_BATCH), "--seq", str(DP_SEQ), "--ckpt-every", "10",
                 "--fail-at", "13"]
DP_DRILL_STEP = 20
# Phase 20: tensor parallelism.  TP_RANKS gloo ranks on the card as a
# (data=1, model=TP_RANKS) mesh, started beside phase 7's host graph build
# (the card idle) and collected after it.  (a) TP_ARCH at full width and
# depth in bf16: TP_WARM warm-up and TP_STEPS timed remat train steps at
# grad_accum 2 on TP_TRAIN (rows, seq) tokens at TRAIN_LR, a prefill of
# TP_PREFILL tokens, then TP_DECODE decode steps against TP_CACHE-token
# kv_seq-split caches; (b) the float32 identities at phase 17(b)'s
# tolerances (TP_CHECK_LAYERS layers at full width; TP_CHECK (rows, seq)
# tokens; TP_CHECK_DECODE decode steps into TP_CHECK_CACHE-slot caches, so
# that both ranks' blocks of slots are written and read) and every reduced
# architecture, mixtral also under the expert-parallel rules (TP_EP).
TP_ARCH, TP_RANKS = "gemma-2b", 2
TP_TRAIN, TP_WARM, TP_STEPS = (2, 1024), 1, 1
TP_PREFILL, TP_DECODE, TP_CACHE = (2, 2048), 16, 4096
TP_CHECK_LAYERS, TP_CHECK = 2, (4, 128)
TP_CHECK_CACHE, TP_CHECK_DECODE = 8, 8
TP_LM_TOL = 1e-4
TP_EP = {"expert": ("model",)}
# Phase 21: the pod axis.  POD_RANKS gloo ranks on the card as a POD_MESH
# ("pod", "data", "model") mesh.  (a) DP_ARCH at full width and depth on
# phase 18's DP_BATCH x DP_SEQ tokens: POD_WARM warm-up and POD_STEPS timed
# train steps at DP_LR; (b) the float32 identities at phase 17(b)'s
# tolerances (DP_ARCH at full width cut to DP_CHECK_LAYERS layers, phase
# 18's batch), each beside two planted faults; (c) gemma2-9b at its reduced
# config under long_500k's rules, POD_DECODE decode steps into
# POD_CACHE-slot caches against one process at TP_LM_TOL.
POD_MESH = (2, 1, 2)
POD_RANKS = 4
POD_WARM, POD_STEPS = 1, 2
POD_CACHE, POD_DECODE = 16, 12
# Phase 19: the launch tooling.  The dry run of every cell on both
# production layouts runs beside phases 1-18 (DRYRUN_JOBS worker processes
# at one torch thread each, niced), as does gemma-2b's train_4k step on
# meta at TRAIN_BATCH rows; the wall seconds of 19's own parts, by part.
# Four workers (done in 168-214 s) slowed phases 2-5 by about 30 s on the
# card's 8-vCPU host; two leave a core to the card phases.
DRYRUN_JOBS = 2
PHASE19_S: dict = {}
# 19(c)'s census row of the served ivf_scan launch, for 19(a)'s meta bound.
CENSUS_FLAT: dict = {}
# The background runs of phase 1 (start_launch_tooling's dict), read by
# phase 20 for its meta count.
LAUNCH: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def stamp(what: str) -> None:
    """Log the script's elapsed seconds as ``what`` starts (where the time
    goes, for the next cut)."""
    log(f"[{time.perf_counter() - T_START:.1f}s] {what}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int):
    """(median milliseconds of ``fn()`` over ``reps`` runs, CUDA events;
    the last run's output)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def compare(name, args, kw, **how):
    """Kernel vs plain version on identical inputs, walked as ``how`` says
    (``segments``); see :func:`agree`."""
    from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call, ivf_scan_plain

    out_k = ivf_scan_kernel_call(*args, **kw, **how)
    out_p = ivf_scan_plain(*args, **kw, segments=how.get("segments", 1))
    sync()
    return agree(name, out_k, out_p, kw["block_q"])


def agree(name, out_k, out_p, block_q):
    """Holds the kernel's (top_sq, top_ids, stats) against the plain
    version's on the same inputs; returns the largest absolute deviation of
    the squared distances (0 when they agree).

    The two evaluate every float operation in the same order with the same
    rounding (stage 1's int8 products are exact integers; stage 2 sums one
    dimension at a time with rounded multiplies and adds), so the windows,
    the squared distances and every stats counter must be equal bit for
    bit; the tolerance is zero."""
    import torch

    (sq_k, ids_k, st_k), (sq_p, ids_p, st_p) = out_k, out_p
    fin = torch.isfinite(sq_p)
    err = float((sq_k[fin] - sq_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    diff_ids = int((ids_k != ids_p).sum())
    diff_rows = int((st_k != st_p).any(dim=1).sum())
    log(f"parity {name}: ids_differ={diff_ids} stats_rows_differ={diff_rows} "
        f"max_abs_err={err:.3e} rows_passed={float(st_k[:, 3].sum()):.0f} "
        f"s2_slabs={float(st_k[::block_q, 4].sum()):.0f}")
    check(torch.equal(ids_k, ids_p), f"{name}: top-K ids differ")
    check(torch.equal(st_k, st_p), f"{name}: stats counters differ")
    check(torch.equal(torch.isfinite(sq_k), fin) and err == 0.0,
          f"{name}: squared distances differ")
    return err


def awkward_case(seed, *, k, block_q=8, block_c=128, n_rows=4096, dim=256,
                 block_d=64, qn=30, probes=6, bf16=False, seeded=False):
    """Unaligned windows, id holes, -1 steps, cross-gap tile reuse, padded
    query rows, optionally seeded windows and bf16 rows."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.quant.scalar import (
        fit_block_scales, quantize_block, quantize_queries_block)

    dev = DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    scales = torch.exp(-0.02 * torch.arange(dim, device=dev))
    rows = torch.randn((n_rows, dim), generator=g, device=dev) * scales
    ids = torch.arange(n_rows, dtype=torch.int32, device=dev)
    ids[torch.rand(n_rows, generator=g, device=dev) < 0.1] = -1
    ids[-2 * block_c:] = -1
    clean = torch.where(ids[:, None] >= 0, rows, torch.zeros_like(rows))
    bs = fit_block_scales(clean, block_d)
    codes = quantize_block(clean, bs, block_d)
    rows = torch.where(ids[:, None] >= 0, rows, torch.full_like(rows, 1e18))
    pick = torch.randint(0, n_rows // 2, (qn,), generator=g, device=dev)
    q = clean[pick] + 0.2 * torch.randn((qn, dim), generator=g, device=dev) * scales
    q_pad = ((qn + block_q - 1) // block_q) * block_q
    q = torch.cat([q, torch.zeros((q_pad - qn, dim), device=dev)])
    q_tiles = q_pad // block_q
    rng = np.random.default_rng(seed)
    ws = rng.integers(0, n_rows - 4 * block_c, (q_tiles, probes))
    wr = rng.integers(1, 3 * block_c, (q_tiles, probes))
    ws[:, 1] = ws[:, 1] // block_c * block_c + 3
    ws[:, 2], wr[:, 1], wr[:, 2] = ws[:, 1], 5, 5  # reuse across -1 steps
    ws[:, 4], wr[:, 4] = ws[:, 0], wr[:, 0]  # revisit after other tiles
    cap = ops.ivf_cap_tiles(int(wr.max()), block_c, starts_aligned=False)
    offs = ops.build_window_offsets(torch.as_tensor(ws, device=dev),
                                    torch.as_tensor(wr, device=dev),
                                    block_c=block_c, cap_tiles=cap, n_pad=n_rows)
    qcodes, qscales = quantize_queries_block(q, block_d)
    s = dim // block_d
    eps = torch.linspace(0.4, 0.0, s, device=dev)
    scale = torch.linspace(float(s), 1.0, s, device=dev)
    d2 = torch.cdist(q, clean) ** 2
    r0 = torch.quantile(d2, 0.02, dim=1)
    r0[qn:] = 0.0  # pad query rows carry r² = 0
    r0[1] = float("inf")
    top0_sq = torch.full((q_pad, k), float("inf"), device=dev)
    top0_ids = torch.full((q_pad, k), -1, dtype=torch.int32, device=dev)
    if seeded:  # a window resumed from an earlier scan: sorted, some filled
        fill = max(k // 2, 1)
        vals, order = torch.sort(d2[:qn, 2048:2048 + fill], dim=1)
        top0_sq[:qn, :fill] = vals
        top0_ids[:qn, :fill] = 2048 + order.to(torch.int32)
    rows_in = rows.to(torch.bfloat16) if bf16 else rows
    args = (offs, qcodes, q, qscales, r0, top0_sq, top0_ids, codes, rows_in,
            ids, bs, eps, scale)
    return args, dict(k=k, block_q=block_q, block_c=block_c, block_d=block_d,
                      cap_tiles=cap)


def run(svc, *, n_clusters: int, n_queries: int, slice_rows: int,
        slice_queries: int, card: str) -> tuple:
    """Phases 2-5 on ``DEV``; returns the ivf_scan kernels entry and phase
    4's served ``--shards`` run (its arguments and report)."""
    import torch
    from repro_torch.core.topk import exact_knn
    from repro_torch.data.pipeline import synthetic_queries
    from repro_torch.index.ivf import build_ivf, fused_search_inputs, search_ivf_fused
    from repro_torch.kernels import ivf_scan
    from repro_torch.launch import serve
    from repro_torch.launch.annservice import FUSED_BLOCK_Q, SHARDS, fused_scan_inputs, seed_rsq

    kernel = ivf_scan.ivf_scan_kernel_call
    t_start = time.perf_counter()

    # ---- 2. parity: kernel vs plain on identical inputs ----
    stamp("phase 2")
    # Both query-tile widths the kernel holds, and split walks (6 or 12 waves in 2 or 8 segments, some of them all
    # gaps) from empty windows.
    max_err = 0.0
    cases = [
        ("k1", dict(seed=1, k=1)),
        ("k10_seeded", dict(seed=2, k=10, seeded=True)),
        ("k100_bf16", dict(seed=3, k=100, bf16=True)),
        ("k100_seeded_bf16", dict(seed=4, k=100, seeded=True, bf16=True)),
        ("k7_d128_bd32", dict(seed=5, k=7, dim=128, block_d=32)),
        ("k128_many_probes", dict(seed=6, k=128, n_rows=8192, probes=12)),
        ("k100_bq16", dict(seed=7, k=100, block_q=16)),
        ("k10_seeded_bf16_bq16", dict(seed=8, k=10, seeded=True, bf16=True, block_q=16)),
        ("k128_many_probes_bq16", dict(seed=10, k=128, n_rows=8192, probes=12, block_q=16)),
        ("k100_bf16_G2", dict(seed=11, k=100, bf16=True), dict(segments=2)),
        ("k7_d128_bd32_bq16_G8", dict(seed=12, k=7, dim=128, block_d=32, block_q=16),
         dict(segments=8)),
        ("k128_many_probes_bq16_G2", dict(seed=13, k=128, n_rows=8192, probes=12,
                                          block_q=16, bf16=True), dict(segments=2)),
        ("k100_many_probes_G8", dict(seed=14, k=100, n_rows=8192, probes=12),
         dict(segments=8)),
    ]
    for name, kw, *how in cases:
        args, kkw = awkward_case(**kw)
        max_err = max(max_err, compare(name, args, kkw, **(how[0] if how else {})))

    t0 = time.perf_counter()
    srv = serve.prepare_service(svc, "dade", DEV)
    log(f"prepare: {svc.corpus_per_device}x{svc.dim} corpus rotated and encoded "
        f"in {time.perf_counter() - t0:.1f}s")
    qs = srv.prep(synthetic_queries(slice_queries, svc.dim, srv.corpus, seed=5))
    rows_s, codes_s = srv.rows[:slice_rows], srv.codes[:slice_rows]
    for g in dict.fromkeys([1, SHARDS]):
        r0 = seed_rsq(svc, rows_s, qs, srv.eps, segments=g)
        args, kw = fused_scan_inputs(svc, rows_s, codes_s, srv.bscales, qs,
                                     srv.eps, srv.scale, r0)
        max_err = max(max_err, compare(f"full_width_{slice_queries}x{slice_rows}_G{g}",
                                       args, kw, segments=g))

    # ---- 3. IVF search at full width ----
    stamp("phase 3")
    t0 = time.perf_counter()
    ivf_kw = dict(n_clusters=n_clusters, scan_block_d=svc.delta_d, delta_d=svc.delta_d,
                  p_s=svc.p_s, device=DEV)
    idx = build_ivf(srv.corpus_t, generator=torch.Generator().manual_seed(0), **ivf_kw)
    sync()
    build_s = time.perf_counter() - t0
    # The build repeats bit for bit: k-means sums its clusters in a fixed
    # order on the card.
    again = build_ivf(srv.corpus_t, generator=torch.Generator().manual_seed(0), **ivf_kw)
    same = (torch.equal(idx.centroids, again.centroids)
            and torch.equal(idx.flat_ids, again.flat_ids)
            and torch.equal(idx.starts, again.starts))
    log(f"ivf: rebuilt with the same seed: centroids and buckets identical={same}")
    check(same, "two build_ivf runs on the card gave different centroids or buckets")
    del again
    queries = synthetic_queries(n_queries, svc.dim, srv.corpus, seed=1)
    _, gt = exact_knn(queries, srv.corpus_t, svc.k, device=DEV)
    args, kw, _ = fused_search_inputs(idx, queries, k=svc.k, n_probe=16)
    max_err = max(max_err, compare(f"ivf_search_{n_queries}q_probe16", args, kw))
    del args
    kernel.launches = 0
    t0 = time.perf_counter()
    d, ids, st = search_ivf_fused(idx, queries, k=svc.k, n_probe=16)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    ivf_launches = kernel.launches
    check(ivf_launches > 0, "search_ivf_fused launched no ivf_scan kernel")
    check(tuple(ids.shape) == (n_queries, svc.k) and bool(torch.isfinite(d).all()),
          "search_ivf_fused output malformed")
    ids_np, gt_np = ids.cpu().numpy(), gt.cpu().numpy()
    rec = sum(len(set(ids_np[i]) & set(gt_np[i])) for i in range(n_queries)) / (
        n_queries * svc.k)
    t0 = time.perf_counter()
    search_ivf_fused(idx, queries, k=svc.k, n_probe=16)
    sync()
    warm_ms = (time.perf_counter() - t0) * 1e3
    log(f"ivf: build {build_s:.1f}s max_bucket={idx.max_bucket} recall@{svc.k}={rec:.4f} "
        f"fetched_B_per_query={st.fetched_bytes_per_query:.0f} "
        f"bytes_per_query={st.bytes_per_query:.0f} s2_skip_rate={st.s2_skip_rate:.3f} "
        f"search_ms(first)={first_ms:.1f} search_ms(warm)={warm_ms:.1f} "
        f"launches={ivf_launches}")
    # Right answers for what was returned: unique ids per row, ascending
    # distances, each the exact distance of its id (fp32 rounding).  Recall
    # at 16 of 1024 buckets with 8-query tile routing is a property of the
    # workload and is reported, not gated.
    rows_ok = all(len(set(r)) == svc.k for r in ids_np)
    check(rows_ok and bool((d[:, 1:] >= d[:, :-1]).all()), "ivf ids repeat or unsorted")
    exact = torch.linalg.vector_norm(
        srv.corpus_t[ids.long()] - torch.as_tensor(queries, device=DEV)[:, None, :], dim=-1)
    check(bool(torch.allclose(d, exact, rtol=1e-4, atol=1e-4)),
          "ivf distances are not the exact distances of the returned ids")
    cont = run_continuous_ivf(idx, queries[:CONT_IVF_QUERIES], svc.k, card)
    max_err = max(max_err, cont["max_err"])
    del idx

    # ---- 4. serving route at the dade_ivf configuration ----
    stamp("phase 4")
    # The one-walk route first, for comparison; then the served shard count,
    # whose launches are the main path's.
    serve_argv = [
        "--device", DEV, "--requests", str(FLAT_REQUESTS),
        "--corpus", str(svc.corpus_per_device),
        "--dim", str(svc.dim), "--k", str(svc.k), "--batch", str(svc.query_batch),
        "--wave", str(svc.wave), "--delta-d", str(svc.delta_d), "--dtype", svc.dtype,
        "--p-s", str(svc.p_s)]
    for g in dict.fromkeys([1, SHARDS]):
        kernel.launches = 0
        report = serve.main(serve_argv + ["--shards", str(g)])
        if g == SHARDS:
            # Phase 15's flat route over ranks serves the same requests.
            served = (serve_argv + ["--shards", str(g)], report)
        serve_launches = kernel.launches
        check(serve_launches > 0, "the serving route launched no ivf_scan kernel")
        check(report["recall"] >= 0.95, f"serving recall@{svc.k} {report['recall']} < 0.95")
        check(report["requests_served"] == FLAT_REQUESTS and report["requests_shed"] == 0,
              f"flat serving answered {report['requests_served']} of {FLAT_REQUESTS} "
              f"requests ({report['requests_shed']} shed)")
        log(f"serve: ok shards={g} recall@{svc.k}={report['recall']:.4f} "
            f"qps={report['qps']:.1f} fetched_B_per_query="
            f"{report['fetched_bytes_per_query']:.0f} launches={serve_launches} over "
            f"{report['queries']} queries, a timed window of "
            f"{report['queries'] / report['qps']:.3f} s")

    # ---- 5. the kernel at the serving shape: time, bound, plain, library ----
    stamp("phase 5")
    q_raw = synthetic_queries(svc.query_batch, svc.dim, srv.corpus, seed=7)
    qb = srv.prep(q_raw)
    r0 = seed_rsq(svc, srv.rows, qb, srv.eps, segments=SHARDS)
    args, kw = fused_scan_inputs(svc, srv.rows, srv.codes, srv.bscales, qb,
                                 srv.eps, srv.scale, r0)
    kw = dict(kw, segments=SHARDS)
    kernel(*args, **kw)  # warm
    ms, out_k = cuda_ms(lambda: kernel(*args, **kw), 5)
    st_k = out_k[2]
    # What the segments' own seeds change: the same split walk from the
    # corpus's first wave alone, the seed every segment took before.
    r0_one = seed_rsq(svc, srv.rows, qb, srv.eps)
    st_one = kernel(*args[:4], r0_one, *args[5:], **kw)[2].double()
    st_seg = st_k.double()
    log(f"seed: {SHARDS} segments' own seeds are tighter for "
        f"{int((r0 < r0_one).sum())} of {r0.shape[0]} queries (median r0 ratio "
        f"{float((r0 / r0_one).median()):.4f}); stage-2 dims, passes, stage-2 slabs "
        f"{float(st_seg[:, 1].sum()):.0f} / {float(st_seg[:, 3].sum()):.0f} / "
        f"{float(st_seg[::FUSED_BLOCK_Q, 4].sum()):.0f} against "
        f"{float(st_one[:, 1].sum()):.0f} / {float(st_one[:, 3].sum()):.0f} / "
        f"{float(st_one[::FUSED_BLOCK_Q, 4].sum()):.0f} from the first wave's seed")
    del st_one
    t0 = time.perf_counter()
    stamp("phase 5: the plain ivf_scan")
    plain_ms, out_p = cuda_ms(lambda: ivf_scan.ivf_scan_plain(*args, **kw), 1)
    log(f"plain: one call at the serving shape in {time.perf_counter() - t0:.1f}s")
    max_err = max(max_err, agree(f"serving_shape_{qb.shape[0]}x{srv.rows.shape[0]}",
                                 out_k, out_p, kw["block_q"]))
    del out_p
    a8, b8 = args[1], srv.codes
    library_ms, _ = cuda_ms(lambda: torch._int_mm(a8, b8.T), 3)
    _, gt = exact_knn(q_raw, srv.corpus_t, svc.k, device=DEV)
    stamp("phase 5b")
    design = scan_design(svc, srv, qb, gt, card, widths=ivf_scan.KERNEL_BLOCK_QS,
                         segment_counts=(1, 2, 4, 8, 16), served=(FUSED_BLOCK_Q, SHARDS))
    del design

    qn, n, dim = qb.shape[0], srv.rows.shape[0], svc.dim
    bq = kw["block_q"]
    # The work this run's data needed (``ivf_scan.work`` on the kernel's
    # counters): int8 and fp32 multiply-adds, and the bytes it must move.
    work = ivf_scan.work(queries=qn, rows=n, dim=dim, k=svc.k, block_q=bq,
                         block_c=kw["block_c"], block_d=kw["block_d"],
                         row_bytes=srv.rows.element_size(), stats=st_k)
    ops_s = work["int8_ops"] / PEAK_INT8_OPS + work["fp32_ops"] / PEAK_FP32_FLOPS
    bytes_s = work["bytes"] / PEAK_BYTES
    entry = {
        "name": "ivf_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ivf_scan.cu",
        "replaces": "src/repro/kernels/ivf_scan.py:451",
        "launches": ivf_launches + serve_launches,
        "continuous_launches": cont["launches"], "continuous_ms": cont["ms"],
        "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": library_ms,
    }
    log(f"kernels: ivf_scan launches={entry['launches']} (ivf={ivf_launches} "
        f"serve={serve_launches}; continuous_launches={cont['launches']}, "
        f"{cont['ms']:.4f} ms a launch) max_abs_err={max_err:.3e} "
        f"ms={ms:.3f} plain_ms={plain_ms:.1f} bound_ms={entry['bound_ms']:.4f} "
        f"({entry['bound_by']}) library_ms(_int_mm {qn}x{n}x{dim})={library_ms:.3f} "
        f"at block_q={bq} segments={SHARDS} on {card}; phases 2-5 took "
        f"{time.perf_counter() - t_start:.0f}s")
    census_flat(svc, srv, qb, work, card)
    return entry, served


def census_flat(svc, srv, qb, work: dict, card: str) -> None:
    """Phase 19(c): the served flat step (phase 5's batch, ``SHARDS``
    segments) under ``op_census``: the kernel's reported operations and
    bytes must equal phase 5's ``work`` (the same inputs, the same
    counters).  The least work the same step counts on meta is held
    against them in phase 19(a), from the dry run's ``dade-ivf`` record
    (one rank's step at these shapes), so that this process pays no
    first use of the meta kernels (5.6 s on the card's host)."""
    from repro_torch.launch.annservice import SHARDS, build_search_step
    from repro_torch.launch.op_census import census

    t0 = time.perf_counter()
    step = build_search_step(svc, with_stats=True, shards=SHARDS)
    cen = census(step, srv.rows, srv.codes, srv.bscales, qb, srv.eps, srv.scale, srv.eps_lo)
    sync()
    got = cen["by_op"]["ivf_scan"]
    want = {"int8": work["int8_ops"], "fp32": work["fp32_ops"]}
    check(got["count"] == 1 and got["ops_by_class"] == want and got["bytes"] == work["bytes"],
          f"launch census (c): the kernel reported {got}, phase 5's work is {want}, "
          f"{work['bytes']} B")
    CENSUS_FLAT.update(got, shape=(qb.shape[0], srv.rows.shape[0], qb.shape[1]))
    PHASE19_S["c"] = time.perf_counter() - t0
    log(f"launch census (c): the served flat step ({qb.shape[0]} queries, {SHARDS} "
        f"segments) on the card: ivf_scan reported {want['int8']:.6g} int8 + "
        f"{want['fp32']:.6g} fp32 ops and {got['bytes']:.6g} B, equal to phase 5's work; "
        f"the step's census {cen['flops']:.6g} FLOP and {cen['bytes']:.6g} B in "
        f"{len(cen['by_op'])} ops, peak {cen['peak_bytes'] / 1e9:.3f} GB of tensors the "
        f"step allocated; {PHASE19_S['c']:.1f}s on {card}")


def scan_design(svc, srv, qb, gt, card, *, widths, segment_counts, served) -> dict:
    """Phase 5b: ``ivf_scan`` at the serving shape for each (block_q,
    segments) alternative, in this run: its time, stage-2 slabs and
    fetched bytes per query and recall@k; then the phase clocks (the timing
    build, ``ivf_scan_phase_clocks``) of the one-walk, 8-query configuration
    and of the served one ``served`` = (block_q, segments), each run's
    outputs held against the served kernel's at the same configuration, bit
    for bit."""
    import torch
    from repro_torch.kernels import ivf_scan
    from repro_torch.launch.annservice import fused_scan_inputs, seed_rsq

    kernel = ivf_scan.ivf_scan_kernel_call
    # Each segment count seeds as the served step does: from the minimum
    # of its segments' first waves.
    r0s = {g: seed_rsq(svc, srv.rows, qb, srv.eps, segments=g) for g in segment_counts}
    args, kw = fused_scan_inputs(svc, srv.rows, srv.codes, srv.bscales, qb,
                                 srv.eps, srv.scale, r0s[1])
    qn, d_pad = qb.shape
    bc, bd = kw["block_c"], kw["block_d"]
    gt_np = gt.cpu().numpy()

    def inputs(bq, g):
        # The flat route's step table is the same for every query tile.
        return ((args[0][:1].expand(qn // bq, -1, -1),) + args[1:4] + (r0s[g],)
                + args[5:], dict(kw, block_q=bq))

    rows = {}
    for bq in widths:
        smem = ivf_scan.smem_bytes(dim=d_pad, block_d=bd, k=svc.k, block_q=bq,
                                   row_bytes=srv.rows.element_size())
        log(f"design: block_q={bq}: {smem} B of shared memory a CTA")
        for g in segment_counts:
            a, k = inputs(bq, g)
            try_kw = dict(k, segments=g)
            kernel(*a, **try_kw)  # warm
            ms, out = cuda_ms(lambda: kernel(*a, **try_kw), 3)
            st = out[2].double()
            s1, s2 = float(st[::bq, 5].sum()), float(st[::bq, 4].sum())
            fetched = (s1 * bc * (d_pad + 4)
                       + s2 * bc * bd * srv.rows.element_size()) / qn
            ids = out[1].cpu().numpy()
            rec = sum(len(set(ids[i]) & set(gt_np[i])) for i in range(qn)) / gt_np.size
            rows[(bq, g)] = dict(ms=ms, s2_slabs_per_query=s2 / qn,
                                 fetched_bytes_per_query=fetched, recall=rec)
            log(f"design: ivf_scan block_q={bq} segments={g}: "
                f"ms={ms:.3f} s2_slabs_per_query={s2 / qn:.1f} "
                f"fetched_B_per_query={fetched:.0f} recall@{svc.k}={rec:.4f} on {card}")
    clocks = {}
    for bq, g in dict.fromkeys([(8, 1), served]):
        a, k = inputs(bq, g)
        out_k = kernel(*a, segments=g, **k)
        *out_c, clk = ivf_scan.ivf_scan_phase_clocks(*a, segments=g, **k)
        sync()
        agree(f"clocks_build_bq{bq}_G{g}", out_c, out_k, bq)
        steps = -(-args[0].shape[1] // g) * args[0].shape[2]
        cyc = clk.double()
        total = float(cyc.sum())
        per_step = float(cyc.sum(1).mean()) / steps
        shares = {p: float(cyc[:, i].sum()) / total for i, p in enumerate(ivf_scan.PHASES)}
        clocks[(bq, g)] = dict(cycles_per_step=per_step, steps_per_cta=steps, shares=shares)
        log(f"clocks: block_q={bq} segments={g} {clk.shape[0]} CTAs x {steps} steps: "
            f"{per_step:.0f} cycles/step; " + " ".join(
                f"{p}={100 * v:.1f}%" for p, v in shares.items()))
    return {"variants": rows, "clocks": clocks}


def agree_graph(name, out_k, out_p, block_q):
    """Holds the graph kernel's (top_sq, top_ids, stats, vis) against the
    plain version's on the same inputs, bit for bit (see :func:`agree`);
    returns the largest absolute deviation of the squared distances."""
    import torch

    err = agree(name, out_k[:3], out_p[:3], block_q)
    diff_words = int((out_k[3] != out_p[3]).sum())
    log(f"parity {name}: bitmap_words_differ={diff_words} "
        f"bits_set={int(sum(bin(w & 0xffffffff).count('1') for w in out_k[3].flatten().tolist()))}")
    check(torch.equal(out_k[3], out_p[3]), f"{name}: visited bitmaps differ")
    return err


def graph_case(seed, *, ef, thresh_col=None, tighten=True, bf16=False,
               block_d=64, vis_base=0, n_nodes=2048, dim=256, qn=32, steps=16):
    """An adjacency-flat slab of 32-row neighbour blocks (16 real rows,
    sentinel pad rows, id -1), a step table with -1 gaps and offsets that
    repeat across them, a partly filled unsorted window, thresholds from
    loose to tight (pad-like rows at r² = 0) and a carried bitmap with bit
    31 of its words set."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.quant.scalar import (
        fit_block_scales, quantize_block, quantize_queries_block)

    dev = DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    scales = torch.exp(-0.02 * torch.arange(dim, device=dev))
    base = torch.randn((n_nodes, dim), generator=g, device=dev) * scales
    nbrs = torch.randint(0, n_nodes, (n_nodes, 16), generator=g, device=dev)
    rows = torch.full((n_nodes, 32, dim), 1e18, device=dev)
    rows[:, :16] = base[nbrs]
    ids = torch.full((n_nodes, 32), -1, dtype=torch.int32, device=dev)
    ids[:, :16] = nbrs.to(torch.int32)
    bs = fit_block_scales(base, block_d)
    codes = torch.zeros((n_nodes, 32, dim), dtype=torch.int8, device=dev)
    codes[:, :16] = quantize_block(base, bs, block_d)[nbrs]
    pick = torch.randint(0, n_nodes, (qn,), generator=g, device=dev)
    q = base[pick] + 0.2 * torch.randn((qn, dim), generator=g, device=dev) * scales
    q_tiles = qn // 8
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, n_nodes, (q_tiles, steps)).astype(np.int32)
    offs[:, 3] = -1
    offs[:, 4] = offs[:, 2]  # the resident tile again, across a gap
    offs[:, 9:11] = -1
    offs[:, 11] = offs[:, 8]
    offs[0, 13:] = -1  # a row that ends early
    qcodes, qscales = quantize_queries_block(q, block_d)
    s = dim // block_d
    d2 = torch.cdist(q, base) ** 2
    r0 = torch.full((qn,), float("inf"), device=dev)
    r0[::3] = torch.quantile(d2[::3], 0.01, dim=1)
    r0[-1] = 0.0  # a pad-like row: prunes at the first checkpoint
    top0_sq = torch.full((qn, ef), float("inf"), device=dev)
    top0_ids = torch.full((qn, ef), -1, dtype=torch.int32, device=dev)
    fill = min(3, ef)
    seeds = torch.randint(0, n_nodes, (qn, fill), generator=g, device=dev)
    top0_sq[:, :fill] = torch.gather(d2, 1, seeds)
    top0_ids[:, :fill] = seeds.to(torch.int32)
    words = ops.graph_vis_words(n_nodes + vis_base)
    vis0 = torch.as_tensor(rng.integers(0, 2**32, (q_tiles, words), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32), device=dev)
    vis0[:, :4] = torch.tensor([-(2**31), 1, 0, -1], dtype=torch.int32)
    args = (torch.as_tensor(offs, device=dev), qcodes, q, qscales, top0_sq, top0_ids,
            r0, vis0, codes.reshape(-1, dim),
            (rows.to(torch.bfloat16) if bf16 else rows).reshape(-1, dim),
            ids.reshape(-1), bs, torch.linspace(0.4, 0.0, s, device=dev),
            torch.linspace(float(s), 1.0, s, device=dev), vis_base)
    return args, dict(ef=ef, thresh_col=thresh_col, block_q=8, block_c=32,
                      block_d=block_d, tighten=tighten)


def agree_walk(name, out_k, out_p, block_q):
    """Holds the walk kernel's (top_sq, top_ids, stats (max_waves, Q, 6),
    vis, waves) against the plain walk's on the same inputs, bit for bit:
    the window, every wave's stats rows, the final bitmap and each tile's
    wave count; returns the largest absolute deviation of the squared
    distances."""
    import torch

    sq_k, ids_k, st_k, vis_k, w_k = out_k
    sq_p, ids_p, st_p, vis_p, w_p = out_p
    err = agree(name, (sq_k, ids_k, st_k.sum(0)), (sq_p, ids_p, st_p.sum(0)), block_q)
    rows = int((st_k != st_p).any(dim=2).sum())
    words = int((vis_k != vis_p).sum())
    waves = w_k.tolist()
    log(f"parity {name}: per-wave stats rows differ={rows} of {st_k.shape[0]}x{st_k.shape[1]} "
        f"bitmap_words_differ={words} waves per tile {min(waves)}..{max(waves)} "
        f"({len(set(waves))} distinct) waves_differ={int((w_k != w_p).sum())}")
    check(torch.equal(st_k, st_p), f"{name}: per-wave stats rows differ")
    check(torch.equal(vis_k, vis_p), f"{name}: visited bitmaps differ")
    check(torch.equal(w_k, w_p), f"{name}: wave counts differ")
    return err


def run_graph(card: str, flat_served) -> dict:
    """Phases 6-8 (and 12, 14, 15, and 20 beside 7's build) on ``DEV``;
    ``flat_served`` is phase 4's served flat run (:func:`run`), phase 15's
    one-process reference.  Returns the graph_scan kernels entry."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs.dade_ivf import ServiceConfig
    from repro_torch.core.topk import exact_knn
    from repro_torch.data.pipeline import synthetic_queries
    from repro_torch.index import graph as graph_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.graph_scan import graph_scan_kernel_call, graph_walk_kernel_call
    from repro_torch.launch import serve

    wave_kernel, walk_kernel = graph_scan_kernel_call, graph_walk_kernel_call
    t_start = time.perf_counter()

    # ---- 6. parity: the one-wave kernel vs plain on identical inputs ----
    stamp("phase 6")
    max_err = 0.0
    cases = [
        ("ef1", dict(seed=11, ef=1)),
        ("ef48_k10", dict(seed=12, ef=48, thresh_col=9)),
        ("ef48_frozen", dict(seed=13, ef=48, tighten=False)),
        ("ef128_bf16", dict(seed=14, ef=128, bf16=True)),
        ("ef48_k10_bd32_base77", dict(seed=15, ef=48, thresh_col=9, block_d=32,
                                      vis_base=77)),
        ("ef128_k10_bf16_bd32", dict(seed=16, ef=128, thresh_col=9, bf16=True,
                                     block_d=32)),
    ]
    for name, kw in cases:
        args, kkw = graph_case(**kw)
        out_k = wave_kernel(*args, **kkw)
        out_p = ref.graph_scan_ref(*args, **kkw)
        sync()
        max_err = max(max_err, agree_graph(f"graph_{name}", out_k, out_p, 8))

    # ---- 7. the graph route at GRAPH_NODES x 256 ----
    stamp("phase 7 (phases 20 and 21 beside its build)")
    # The reference's host-side NSW build inserts one node at a time, so
    # 2^20 nodes would take hours to build.
    nodes = GRAPH_NODES
    gsvc = ServiceConfig(corpus_per_device=nodes, dim=256, query_batch=1024,
                         k=10, delta_d=64, p_s=0.02, dtype="float32")
    # phases 20 and 21's six ranks need the card's memory this process
    # holds cached from phases 2-5
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"graph: this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB of the card "
        f"as phases 20 and 21 start")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tp_tmp:
        tp = start_tp(tp_tmp)  # phase 20, on the card while the host builds
        # phase 21 beside it, once phase 20's timed part is done
        pod = start_pod(tp_tmp, after=os.path.join(tp_tmp, "tp_a_done"))
        try:
            gsrv = serve.prepare_graph(gsvc, "dade", m=16, ef=48, device=DEV)
            sync()
            build_s = time.perf_counter() - t0
            stamp("phase 7's build done")
            finish_tp(tp, card)
            finish_pod(pod, card)
        finally:
            tp[0].terminate()
            pod[0].terminate()
    gidx = gsrv.index
    log(f"graph: built {nodes}x{gsvc.dim} m=16 ef_construction=96 "
        f"adj_block={gidx.adj_block} scan_block_d={gidx.scan_block_d} "
        f"adj_rot={tuple(gidx.adj_rot.shape)} {gidx.adj_rot.dtype} in {build_s:.1f}s")
    search_kw = dict(k=10, ef=48, expand=2, block_q=8, max_waves=64, seed_r=False,
                     decoupled=True, route_mult=1.0)

    # ---- 6b. the walk kernel vs the plain walk on this graph ----
    stamp("phase 6b")
    # 203 queries: 26 tiles, the last with 5 pad rows; every case's tiles
    # converge at different waves but the cap's.
    q_cases = synthetic_queries(203, gsvc.dim, gsrv.corpus, seed=3)
    walk_cases = [("defaults", {}), ("seed_r", dict(seed_r=True)),
                  ("coupled", dict(decoupled=False)), ("route_mult_1.2", dict(route_mult=1.2)),
                  ("bf16_rows", dict(bf16=True)), ("max_waves_4", dict(max_waves=4))]
    for name, extra in walk_cases:
        kw = dict(search_kw, **extra)
        index = gidx
        if kw.pop("bf16", False):
            index = dataclasses.replace(gidx, adj_rot=gidx.adj_rot.to(torch.bfloat16))
        args, wkw, _ = graph_mod.walk_inputs(index, q_cases, **kw)
        out_k = walk_kernel(*args, **wkw)
        out_p = ref.graph_walk_ref(*args, **wkw)
        sync()
        max_err = max(max_err, agree_walk(f"walk_{name}", out_k, out_p, 8))
        waves = out_k[4].tolist()
        if "max_waves" in extra:
            check(max(waves) == extra["max_waves"], f"walk_{name}: the cap did not cut the walk")
        else:
            check(len(set(waves)) > 1 and max(waves) < kw["max_waves"],
                  f"walk_{name}: the tiles did not converge at different waves")
        del index, out_k, out_p

    queries = synthetic_queries(1024, gsvc.dim, gsrv.corpus, seed=1)
    _, gt = exact_knn(queries, gsrv.corpus_t, 10, device=DEV)
    fused = lambda: graph_mod.search_graph_fused(gidx, queries, k=10, ef=48,  # noqa: E731
                                                 expand=2, device=DEV)
    # The first search in the process carries one-time costs: timed alone.
    t0 = time.perf_counter()
    fused()
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    # The main path: launches counted, its walk's inputs and outputs kept,
    # and the host's per-wave selection of the old route (the plain
    # selection, the bitmap unpacking, the per-wave plain scan) counted:
    # none of it may run on the card's path.
    kept, host_calls = [], {"ops.unpack_vis": 0, "ref.select_wave_ref": 0,
                            "ref.graph_scan_ref": 0}

    def recording(*args, **kw):
        out = walk_kernel(*args, **kw)
        kept.append((args, kw, out))
        return out

    def counted(mod, name):
        fn = getattr(mod, name)

        def run(*args, **kw):
            host_calls[f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"] += 1
            return fn(*args, **kw)
        return run

    patches = [(graph_mod, "graph_walk_kernel_call", recording),
               (ops, "unpack_vis", counted(ops, "unpack_vis")),
               (ref, "select_wave_ref", counted(ref, "select_wave_ref")),
               (ref, "graph_scan_ref", counted(ref, "graph_scan_ref"))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    walk_kernel.launches = wave_kernel.launches = 0
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        t0 = time.perf_counter()
        d, ids, st = fused()
        sync()
        fused_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    route_launches = walk_kernel.launches
    check(route_launches == 1 and wave_kernel.launches == 0,
          f"search_graph_fused launched {route_launches} walk and "
          f"{wave_kernel.launches} one-wave kernels, not one walk")
    check(not any(host_calls.values()),
          f"the card's path ran the host's per-wave selection: {host_calls}")
    (args, wkw, out_k), = kept
    del kept
    # The card's share of a search: a profiler trace of the same search, its
    # device activities (kernels and copies) summed against the wall time.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused()
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in device
                    if "graph_walk_kernel" in e.key) / 1e3
    log(f"graph: search_ms(first)={first_ms:.1f} search_ms(counted)={fused_ms:.1f}, "
        f"launches per search {route_launches} (one-wave kernel {wave_kernel.launches}); "
        f"host per-wave selection calls {host_calls}; profiled search {prof_ms:.1f} ms: "
        f"card busy {busy_ms:.3f} ms ({100 * busy_ms / prof_ms:.2f} %, idle "
        f"{100 - 100 * busy_ms / prof_ms:.2f} %), graph_walk {kernel_ms:.3f} ms "
        f"({100 * kernel_ms / prof_ms:.2f} %), the rest of the search on the host "
        f"{prof_ms - busy_ms:.1f} ms")

    # The host's share, part by part: the prologue (rotation, tile sort,
    # seeds, padding and query codes), the one launch, and the readback with
    # the ledger (the rest of the search).
    t0 = time.perf_counter()
    p_args, p_kw, _ = graph_mod.walk_inputs(gidx, queries, **search_kw)
    sync()
    t1 = time.perf_counter()
    walk_kernel(*p_args, **p_kw)
    sync()
    t2 = time.perf_counter()
    fused()
    sync()
    t3 = time.perf_counter()
    del p_args
    log(f"graph: host parts of a search: prologue {(t1 - t0) * 1e3:.2f} ms, the walk "
        f"launch to its end {(t2 - t1) * 1e3:.2f} ms, the whole search {(t3 - t2) * 1e3:.2f} "
        f"ms, so readback and ledger {(t3 - t2 - (t2 - t0)) * 1e3:.2f} ms")

    # The plain walk of the same search: its outputs held against the
    # kernel's bit for bit, its waves' inputs kept (for the widest wave).
    waves_in, plain_out = [], []

    def plain_walk(*a, **k):
        out = ref.graph_walk_ref(*a, **k)
        plain_out.append(out)
        return out

    def plain_wave(*a, **k):
        waves_in.append((a, k))
        return scan_ref(*a, **k)

    scan_ref = ref.graph_scan_ref
    saved = [(graph_mod, "graph_walk_ref", graph_mod.graph_walk_ref),
             (ref, "graph_scan_ref", scan_ref)]
    try:
        graph_mod.graph_walk_ref, ref.graph_scan_ref = plain_walk, plain_wave
        t0 = time.perf_counter()
        d_p, ids_p, st_p = graph_mod.search_graph_beam_host(gidx, queries, k=10, ef=48,
                                                            expand=2, device=DEV)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    max_err = max(max_err, agree_walk("walk_main_path_1024q", out_k, plain_out[0], 8))
    check(torch.equal(ids, ids_p), "fused and plain walks return different ids")
    check(torch.equal(d, d_p), "fused and plain walks return different distances")
    check(st == st_p, f"fused and plain walks book different ledgers: {st} vs {st_p}")
    ids_np, gt_np = ids.cpu().numpy(), gt.cpu().numpy()
    rec = sum(len(set(ids_np[i]) & set(gt_np[i])) for i in range(len(ids_np))) / ids_np.size
    check(tuple(ids.shape) == (1024, 10) and bool(torch.isfinite(d).all()),
          "search_graph_fused output malformed")
    check(all(len(set(r)) == 10 for r in ids_np) and bool((d[:, 1:] >= d[:, :-1]).all()),
          "graph ids repeat or unsorted")
    exact = torch.linalg.vector_norm(
        gsrv.corpus_t[ids.long()] - torch.as_tensor(queries, device=DEV)[:, None, :], dim=-1)
    check(bool(torch.allclose(d, exact, rtol=1e-4, atol=1e-4)),
          "graph distances are not the exact distances of the returned ids")
    log(f"graph: recall@10={rec:.4f} waves={st.waves:.0f} launches={route_launches} "
        f"expansions_per_q={st.expansions_per_query:.1f} "
        f"fetched_B_per_query={st.fetched_bytes_per_query:.0f} "
        f"bytes_per_query={st.bytes_per_query:.0f} s2_skip_rate={st.s2_skip_rate:.3f} "
        f"search_ms(fused)={fused_ms:.1f} search_ms(plain walk)={plain_ms:.1f}; "
        f"fused and plain walks equal (ids, distances, every ledger field)")
    check(rec >= 0.80, f"graph recall@10 {rec} < 0.80")

    # The walk alone, at the main path's inputs, against its bound.
    walk_kernel(*args, **wkw)  # warm
    ms, out_t = cuda_ms(lambda: walk_kernel(*args, **wkw), 11)
    check(all(torch.equal(a, b) for a, b in zip(out_t, out_k)),
          "the walk kernel's repeated runs differ")
    del out_t
    stw = out_k[2].double()
    qp, dim = args[1].shape
    bq, bc, bd, ef = wkw["block_q"], wkw["block_c"], wkw["block_d"], wkw["ef"]
    vis0, vis = args[6], out_k[3]
    words = vis.shape[1]
    # Operations this walk's data needs: one multiply-add per int8 dim each
    # (query, row) pair consumed (stats column 0) and per fp dim stage 2
    # consumed (column 1), the latter in float32 outside the tensor cores.
    ops_s = (2.0 * float(stw[..., 0].sum()) / PEAK_INT8_OPS
             + 2.0 * float(stw[..., 1].sum()) / PEAK_FP32_FLOPS)
    # Bytes: each neighbour block some tile expanded (the union of the final
    # bitmaps) read once as int8 codes and ids, the fp slabs of the busiest
    # query tile over the walk (a lower bound on the distinct slabs), the
    # queries with their codes and scales, seeds, window and bitmap in and
    # out, the per-wave stats and the wave counts.
    union = vis[0].clone()
    for row in vis[1:]:
        union |= row
    distinct = int(sum(bin(w & 0xffffffff).count("1") for w in union.tolist()))
    slab_bytes = float(stw[:, ::bq, 4].sum(0).max()) * bc * bd * args[8].element_size()
    in_bytes = (distinct * bc * (dim + 4) + slab_bytes + qp * dim * 5
                + qp * (dim // bd) * 4 + qp * ef * 8 + qp * 4 + vis0.numel() * 4)
    out_bytes = qp * ef * 8 + stw.numel() * 4 + vis.numel() * 4 + (qp // bq) * 4
    bytes_s = (in_bytes + out_bytes) / PEAK_BYTES
    log(f"graph walk: {ms:.4f} ms per {len(queries)}-query search (one launch, "
        f"{int(out_k[4].max())} waves, {distinct} distinct blocks expanded, "
        f"{words} bitmap words a tile) against a bound of "
        f"{max(ops_s, bytes_s) * 1e3:.5f} ms "
        f"({'operations' if ops_s >= bytes_s else 'bytes'}); the plain walk "
        f"{plain_ms:.1f} ms")
    log("library: none — no single PyTorch call computes a graph walk (a "
        "data-dependent walk of seeded windows, two-stage screens, bitmap "
        "marks and frontier picks), so library_ms is null")

    # The route the walk replaced launched the one-wave kernel once per
    # wave: every wave of the same search through it, timed alone, gives
    # that route's kernel time per search; the widest wave is also held
    # against its plain version.
    wave_times = []
    for a, k in waves_in:
        wave_kernel(*a, **k)  # warm
        wave_times.append(cuda_ms(lambda: wave_kernel(*a, **k), 5)[0])
    waves_sum_ms = sum(wave_times)
    real, wargs, wkw1 = max(((int((a[0] >= 0).sum()), a, k) for a, k in waves_in),
                            key=lambda w: w[0])
    del waves_in
    wave_kernel(*wargs, **wkw1)  # warm
    wave_ms, out_wk = cuda_ms(lambda: wave_kernel(*wargs, **wkw1), 21)
    wave_plain_ms, out_wp = cuda_ms(lambda: ref.graph_scan_ref(*wargs, **wkw1), 3)
    max_err = max(max_err, agree_graph(f"graph_widest_wave_{real}_steps", out_wk, out_wp, 8))
    log(f"graph wave: the search's {len(wave_times)} waves through the one-wave kernel, "
        f"a launch each, {waves_sum_ms:.4f} ms summed (per wave "
        f"{' '.join(f'{t:.4f}' for t in wave_times)}) against the walk's {ms:.4f} ms in "
        f"one launch; the widest wave ({real} real steps) {wave_ms:.4f} ms, its plain "
        f"version {wave_plain_ms:.1f} ms")

    # ---- 8. graph serving route on the same graph ----
    stamp("phase 8")
    walk_kernel.launches = 0
    reports = []
    for _ in range(SERVE_RUNS):
        before = walk_kernel.launches
        report = serve.main(["--index", "graph", "--device", DEV,
                             "--requests", str(GRAPH_REQUESTS),
                             "--corpus", str(nodes), "--dim", str(gsvc.dim),
                             "--k", "10", "--batch", "1024", "--delta-d", "64",
                             "--p-s", "0.02", "--ef", "48", "--expand", "2", "--m", "16"],
                            graph=gsrv)
        check(report["requests_served"] == GRAPH_REQUESTS and report["requests_shed"] == 0,
              f"the graph serving route did not answer {GRAPH_REQUESTS} requests")
        run_launches = walk_kernel.launches - before
        check(run_launches == report["batches"] + 1,  # the warm-up batch's search too
              f"graph serving launched {run_launches} walks for {report['batches']} "
              f"batches and the warm-up")
        reports.append(report)
    serve_launches = walk_kernel.launches
    qps = sorted(r["qps"] for r in reports)
    runs_qps = " ".join(f"{r['qps']:.1f}" for r in reports)
    windows_s = " ".join(f"{r['queries'] / r['qps']:.3f}" for r in reports)
    log(f"graph serve: ok {SERVE_RUNS} runs of {GRAPH_REQUESTS} requests "
        f"({reports[0]['queries']} queries, {reports[0]['batches']} batches each): "
        f"qps {runs_qps} (median {statistics.median(qps):.1f}, spread "
        f"{100 * (qps[-1] - qps[0]) / qps[0]:.1f} %), timed windows {windows_s} s; "
        f"recall@10={reports[0]['recall']:.4f} waves={reports[0]['waves']:.0f} "
        f"launches={serve_launches}")
    stamp("phase 14")
    churn = run_churn(gsrv, gsvc, queries, card)
    max_err = max(max_err, churn["max_err"])
    stamp("phase 12")
    cont = run_continuous_graph(gsrv, gsvc, (queries, gt.cpu().numpy(), rec), card)
    max_err = max(max_err, cont["max_err"])
    stamp("phase 15")
    shard = run_sharded(gsrv, gsvc, queries, gt, churn["snapshot"], card, flat_served)
    max_err = max(max_err, shard["max_err"])
    sharded_launches = (shard["host_launches"] + shard["pg_launches"]
                        + shard["serve_launches"] + shard["cont_launches"])
    entry = {
        "name": "graph_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/graph_scan.cu",
        "replaces": "src/repro/kernels/graph_scan.py:477",
        "launches": route_launches + serve_launches,
        "one_wave_launches": cont["launches"], "one_wave_ms": cont["ms"],
        "churn_launches": churn["launches"], "churn_walk_ms": churn["tombstoned_walk_ms"],
        "snapshot_launches": churn["snapshot_walks"],
        "flat_snapshot_launches": churn["snapshot_scans"],
        "sharded_launches": sharded_launches, "sharded_s4_search_ms": shard["s4_ms"],
        "ranked_flat_launches": shard["flat_launches"],
        "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
    }
    log(f"kernels: graph_scan launches={entry['launches']} (the walk: route={route_launches} "
        f"serve={serve_launches}; churn_launches={churn['launches']} in churn serving, "
        f"snapshot_launches={churn['snapshot_walks']}; sharded_launches={sharded_launches} "
        f"one-wave launches in phase 15; one_wave_launches={cont['launches']} in continuous "
        f"serving, {cont['ms']:.4f} ms a launch at {CONT_MAX_LIVE} tiles) "
        f"max_abs_err={max_err:.3e} "
        f"ms={ms:.4f} per search plain_ms={plain_ms:.1f} "
        f"bound_ms={entry['bound_ms']:.5f} ({entry['bound_by']}); the search's waves "
        f"through the one-wave kernel {waves_sum_ms:.4f} ms summed, the widest "
        f"{wave_ms:.4f} ms; on {card}; phases 6-8, 12, 14 and 15 took "
        f"{time.perf_counter() - t_start:.0f}s")
    return entry


def run_schedule(engine, rows, schedule):
    """Admit ``rows`` into a continuous engine per the arrival ``schedule``
    (admissions before each wave; leftovers at the end) and step until
    drained; returns {row: RetiredQuery}."""
    pending, hmap, out, arrivals = list(range(len(rows))), {}, {}, list(schedule)
    while pending or engine.live_count():
        for _ in range(min(arrivals.pop(0) if arrivals else len(pending), len(pending))):
            i = pending.pop(0)
            hmap[engine.admit(rows[i])] = i
        if engine.live_count():
            for rq in engine.step():
                out[hmap[rq.handle]] = rq
    return out


def run_churn(gsrv, gsvc, queries, card) -> dict:
    """Phase 14: churn serving on the card, then the index snapshots.

    ``serve --index graph --mutate-rate 32`` over CHURN_NODES rows (the
    reference's churn route: 1,280 mutations, 3:1 upserts to deletes from
    ``drifted_vectors(seed=11)``, a write-ahead log, a ``torn_upsert`` crash
    after two batches and its recovery, the drift watchdog) with
    ``--verify-graph-oracle``: the serve itself fails unless the mutated
    index returns a from-scratch rebuild's ids (distances to ``rtol=5e-5,
    atol=1e-5``) and holds its arrays bit for bit (a, b).  One request's
    walk launch, deleted rows pre-set in its bitmap, is held against
    ``ref.graph_walk_ref`` bit for bit (c).  The ledger closes, the replay
    reports the torn tail, the snapshot passes the schema check (d).  Then
    phase 7's graph is saved by ``serve --index-ckpt`` and restored by a
    second serve that builds nothing, searches on it equal the original's
    bit for bit, and the flat route's estimator snapshot serves the ids the
    built estimator served (e).  Returns the launch counts."""
    import shutil

    import torch
    from repro_torch.checkpoint.index_io import load_graph_index
    from repro_torch.index import graph as graph_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.graph_scan import graph_walk_kernel_call as walk_kernel
    from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call
    from repro_torch.kernels.ops import unpack_vis
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    work = ROOT / "build" / "phase14"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    argv = ["--index", "graph", "--device", DEV, "--corpus", str(CHURN_NODES),
            "--dim", str(gsvc.dim), "--k", "10", "--batch", "1024", "--delta-d",
            str(gsvc.delta_d), "--p-s", "0.02", "--ef", "48", "--expand", "2", "--m", "16"]
    captured = {}

    def capturing(*a, **k):
        out = walk_kernel(*a, **k)
        captured["calls"] = captured.get("calls", 0) + 1
        if captured["calls"] == CHURN_CAPTURE:
            captured["case"] = (tuple(x.clone() if isinstance(x, torch.Tensor) else x
                                      for x in a), dict(k), tuple(x.clone() for x in out))
        return out

    walk_kernel.launches = 0
    graph_mod.graph_walk_kernel_call = capturing
    try:
        t0 = time.perf_counter()
        rep = serve.main(argv + [
            "--requests", str(CHURN_REQUESTS), "--mutate-rate", str(CHURN_RATE),
            "--wal", str(work / "churn.wal"), "--chaos", "torn_upsert:after=2",
            "--verify-graph-oracle", "--metrics-json", str(work / "churn.json")])
        churn_s = time.perf_counter() - t0
    finally:
        graph_mod.graph_walk_kernel_call = walk_kernel
    churn_launches = walk_kernel.launches
    check(rep["verified"], "the churn oracle did not run")
    check(churn_launches == captured["calls"] and churn_launches >= CHURN_REQUESTS,
          f"churn serving launched the walk {churn_launches} times for "
          f"{CHURN_REQUESTS} requests")
    check(rep["requests_served"] == CHURN_REQUESTS and rep["requests_shed"] == 0,
          "churn serving did not answer every request")
    check(rep["mutations_applied"] == rep["upserts"] + rep["deletes"] + rep["rejected"]
          == round(CHURN_REQUESTS * CHURN_RATE), f"the mutation ledger does not close: {rep}")
    check(rep["wal_recovered_torn"] == 1 and rep["boots"] == 2,
          "the torn upsert was not recovered by one replay")
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
                          str(work / "churn.json")], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"churn metrics schema: {out.stdout} {out.stderr}")

    # (c) the captured request's walk, tombstones pre-set, against the plain walk.
    args, wkw, out_k = captured["case"]
    vis0 = args[6]
    out_p = ref.graph_walk_ref(*args, **wkw)
    sync()
    max_err = agree_walk("walk_churn_tombstoned", out_k, out_p, 8)
    n_rows = args[8].shape[0] // wkw["block_c"]
    pre = unpack_vis(vis0, n_rows)
    added = unpack_vis(out_k[3], n_rows) & ~pre
    check(bool(pre[0].any()) and bool((pre == pre[0]).all()),
          "the captured walk carried no tombstones in its starting bitmap")
    check(bool(added.any()) and not bool((added & pre[0][None, :]).any()),
          "the walk expanded a tombstoned node")
    # The walk's time on these inputs, and with the bitmap cleared (the
    # same walk without tombstones): measurement launches, not counted.
    walk_kernel(*args, **wkw)  # warm
    tomb_ms, _ = cuda_ms(lambda: walk_kernel(*args, **wkw), 11)
    clear = args[:6] + (torch.zeros_like(vis0),) + args[7:]
    clear_ms, _ = cuda_ms(lambda: walk_kernel(*clear, **wkw), 11)
    split = rep["split"]
    med = {k: statistics.median(v) for k, v in split.items()}
    log(f"churn: {CHURN_REQUESTS} requests over {CHURN_NODES} nodes, "
        f"{rep['mutations_applied']} mutations ({rep['upserts']} upserts, "
        f"{rep['deletes']} deletes, {rep['rejected']} rejected, {rep['requantizes']} "
        f"requantizes, {rep['tombstones']} tombstones), wal records {rep['wal_records']} "
        f"after the recovery; QPS under churn {rep['qps']:.1f}, recall@10 against the "
        f"live corpus {rep['recall']:.4f}; per request (mean / median ms): mutations "
        f"{rep['mean_mutate_ms']:.2f} / {med['mutate_ms']:.2f}, drift check "
        f"{rep['mean_drift_ms']:.2f} / {med['drift_ms']:.2f}, index view refresh "
        f"{rep['mean_view_ms']:.4f} / {med['view_ms']:.4f}, search {rep['mean_search_ms']:.2f} "
        f"/ {med['search_ms']:.2f}; boot {rep['boot_s']:.1f} s, recovery (fresh base + "
        f"replay) {rep['recovery_s']:.1f} s; drift checks {rep['drift_checks']} fired "
        f"{rep['drift_fired']} swaps {rep['drift_recalibrations']} suppressed "
        f"{rep['drift_suppressed']}; walk launches {churn_launches}; the oracle's ids, "
        f"distances and arrays equal the rebuild's; the launch of call {CHURN_CAPTURE} "
        f"({int(pre[0].sum())} tombstones pre-set, {int(added.sum())} expansions, none "
        f"tombstoned) equals the plain walk bit for bit; that walk takes {tomb_ms:.4f} ms "
        f"({args[1].shape[0]} query rows, {int(out_k[4].max())} waves), {clear_ms:.4f} ms "
        f"with its bitmap cleared; the churn serve took {churn_s:.0f}s on {card}")

    # (e) snapshots: the graph route's whole index, the flat route's estimator.
    g_argv = ["--index", "graph", "--device", DEV, "--corpus", str(gsvc.corpus_per_device),
              "--dim", str(gsvc.dim), "--k", "10", "--batch", "1024", "--delta-d",
              str(gsvc.delta_d), "--p-s", "0.02", "--ef", "48", "--expand", "2",
              "--m", "16", "--requests", str(SNAPSHOT_REQUESTS),
              "--index-ckpt", str(work / "graph_ckpt")]
    walk_kernel.launches = ivf_scan_kernel_call.launches = 0
    t0 = time.perf_counter()
    saved = serve.main(g_argv, graph=gsrv)
    t1 = time.perf_counter()
    restored = serve.main(g_argv)
    t2 = time.perf_counter()
    check(saved["ckpt"] == "saved" and restored["ckpt"] == "restored",
          f"graph snapshot: {saved['ckpt']} then {restored['ckpt']}")
    check(restored["ids_sha256"] == saved["ids_sha256"],
          "the restored graph served other ids than the saved one")
    back = load_graph_index(str(work / "graph_ckpt"), device=DEV)
    gidx = gsrv.index
    for f in serve.CHURN_ARRAYS:
        check(torch.equal(getattr(back, f), getattr(gidx, f)), f"restored graph's {f} differs")
    a = graph_mod.search_graph_fused(gidx, queries, k=10, ef=48, expand=2, device=DEV)
    b = graph_mod.search_graph_fused(back, queries, k=10, ef=48, expand=2, device=DEV)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2],
          "searches on the restored graph differ from the original's")
    graph_launches = walk_kernel.launches
    del back, a, b
    f_argv = ["--device", DEV, "--requests", str(SNAPSHOT_REQUESTS),
              "--index-ckpt", str(work / "flat_ckpt")]
    t3 = time.perf_counter()
    f_saved = serve.main(f_argv)
    f_restored = serve.main(f_argv)
    t4 = time.perf_counter()
    check(f_saved["ckpt"] == "saved" and f_restored["ckpt"] == "restored",
          f"flat snapshot: {f_saved['ckpt']} then {f_restored['ckpt']}")
    check(f_restored["ids_sha256"] == f_saved["ids_sha256"] and f_restored["recall"] >= 0.95,
          "the restored estimator served other ids than the built one")
    flat_launches = ivf_scan_kernel_call.launches
    log(f"snapshots: the {gsvc.corpus_per_device}-node graph saved by one serve "
        f"({t1 - t0:.1f} s, {SNAPSHOT_REQUESTS} requests) and restored by the next, which "
        f"built nothing ({t2 - t1:.1f} s), served the same ids; its arrays and phase 7's "
        f"{len(queries)}-query search equal the original's bit for bit; the flat route's "
        f"estimator saved and restored, the same ids served ({t4 - t3:.1f} s for both "
        f"serves); walk launches {graph_launches}, ivf_scan launches {flat_launches}; "
        f"phase 14 took {time.perf_counter() - t_start:.0f}s")
    # Phase 15 serves from the graph's snapshot, then removes the directory.
    return {"max_err": max_err, "launches": churn_launches, "snapshot_walks": graph_launches,
            "snapshot_scans": flat_launches, "tombstoned_walk_ms": tomb_ms,
            "snapshot": str(work / "graph_ckpt")}


def run_sharded(gsrv, gsvc, queries, gt, snapshot, card, flat_served) -> dict:
    """Phase 15: multi-device serving on phase 7's graph, as ranks on one card.

    (a) ``search_graph_sharded`` at S = 1, 2, 4 (the host-simulated walk, one
    launch of the one-wave kernel per shard a wave over the shard's slab
    rows, ``tighten=False``, ``vis_base`` the shard's first node) against
    the plain oracle (``num_shards=1, use_ref=True``): ids and distances
    bit for bit across S and to the oracle, the same waves, per-shard
    fetch tuples that sum to the S = 1 totals; one captured sliced-slab
    launch (S = 4, shard 3, a middle wave) against ``ref.graph_scan_ref``
    bit for bit.  (b) The process-group engine spawned at S = 2 and 4 over
    gloo, its ranks loading their slabs from phase 14's snapshot of this
    graph: (a)'s ids and distances, every rank's merged window and bitmap
    equal after every wave; the exchange and all-gather figures.  (c)
    ``serve --graph-shards 4`` (metrics through the schema check), then a
    ``shard_death`` drill with ``--verify-degraded-oracle``.  (d) ``serve --continuous --graph-shards
    2``: every retired query equals its solo sharded walk.  (e) ``serve
    --index flat --ranks 2 --shards 4`` with phase 4's arguments returns
    the ids of phase 4's one-process run (``flat_served``).  Returns the
    launch counts and times."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.index import graph as graph_mod
    from repro_torch.kernels import graph_scan, ref
    from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call
    from repro_torch.launch import serve
    from repro_torch.launch.annservice import sharded_graph_engine

    t_start = time.perf_counter()
    gidx = gsrv.index
    wave_kernel = graph_scan.graph_scan_kernel_call
    kw = dict(k=10, ef=48, expand=2, device=DEV)
    max_err = 0.0

    # (a) the host-simulated walk at S = 1, 2, 4 against the plain oracle.
    t0 = time.perf_counter()
    d_o, i_o, st_o = graph_mod.search_graph_sharded(gidx, queries, num_shards=1,
                                                    use_ref=True, **kw)
    sync()
    oracle_s = time.perf_counter() - t0
    wave_kernel.launches = 0
    runs, times = {}, {}
    for shards in SHARDED_COUNTS:
        before = wave_kernel.launches
        runs[shards] = graph_mod.search_graph_sharded(gidx, queries, num_shards=shards, **kw)
        sync()
        d, i, st = runs[shards]
        check(torch.equal(i, i_o) and torch.equal(d, d_o),
              f"the {shards}-shard walk diverges from the plain oracle")
        check(st.waves == st_o.waves, f"{shards} shards walked {st.waves} waves, the "
              f"oracle {st_o.waves}")
        check(sum(st.shard_s1_tiles_fetched) == sum(runs[1][2].shard_s1_tiles_fetched)
              and sum(st.shard_s2_slabs_fetched) == sum(runs[1][2].shard_s2_slabs_fetched),
              f"{shards} shards' fetch tuples do not sum to one shard's")
        check(wave_kernel.launches - before == shards * st.waves,
              f"{shards} shards made {wave_kernel.launches - before} launches in "
              f"{st.waves:.0f} waves")
        ts = []
        for _ in range(SHARDED_REPS):
            t0 = time.perf_counter()
            graph_mod.search_graph_sharded(gidx, queries, num_shards=shards, **kw)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        times[shards] = ts
    host_launches = wave_kernel.launches
    # One sliced-slab launch captured mid-walk: S = 4, shard 3.
    waves4 = int(runs[4][2].waves)
    target = 4 * (waves4 // 2) + 3
    captured = {}

    def capturing(*a, **k):
        out = wave_kernel(*a, **k)
        captured["n"] = captured.get("n", 0) + 1
        if captured["n"] == target + 1:
            captured["case"] = (a, dict(k), out)
        return out

    graph_mod.graph_scan_kernel_call = capturing
    try:
        graph_mod.search_graph_sharded(gidx, queries, num_shards=4, **kw)
    finally:
        graph_mod.graph_scan_kernel_call = wave_kernel
    args, ckw, out_k = captured["case"]
    check(args[14] == 3 * gidx.corpus_rot.shape[0] // 4 and not ckw["tighten"],
          "the captured launch is not shard 3's frozen wave")
    out_p = ref.graph_scan_ref(*args, **ckw)
    sync()
    max_err = max(max_err, agree_graph(f"graph_sliced_slab_s4_shard3_wave{waves4 // 2}",
                                       out_k, out_p, 8))
    st4 = runs[4][2]
    log(f"sharded walk: {len(queries)} queries, S=1/2/4 ids and distances bit-identical "
        f"to the plain oracle ({oracle_s:.1f} s), {st_o.waves:.0f} waves each; per search "
        + "; ".join(f"S={s} {statistics.median(t):.2f} ms (runs {' '.join(f'{x:.2f}' for x in t)})"
                    for s, t in times.items())
        + f"; S=4 fetch tuples s1={st4.shard_s1_tiles_fetched} "
        f"s2={st4.shard_s2_slabs_fetched}, exchange {st4.exchange_bytes_per_wave:.0f} B a "
        f"wave, {st4.exchange_bytes_per_query:.0f} B a query; one-wave launches "
        f"{host_launches}; on {card}")

    # (b) the process-group engine, ranks spawned on this card.
    pg = {}
    for shards in (2, 4):
        t0 = time.perf_counter()
        with sharded_graph_engine(gidx, snapshot, num_shards=shards, backend="gloo", k=10,
                                  ef=48, expand=2, record=True, timed=True,
                                  device=DEV) as engine:
            spawn_s = time.perf_counter() - t0
            d, i, st = engine(queries)
            sync()
            eng = engine.local
            base_gather, base_waves = eng.gather_ms, eng.waves
            t1 = time.perf_counter()
            d2, i2, _ = engine(queries)
            sync()
            wall_ms = (time.perf_counter() - t1) * 1e3
            gather_ms = (eng.gather_ms - base_gather) / max(eng.waves - base_waves, 1)
        check(np.array_equal(i, i_o.cpu().numpy()) and np.array_equal(d, d_o.cpu().numpy())
              and np.array_equal(i, i2) and np.array_equal(d, d2),
              f"the {shards}-rank engine diverges from the walks")
        ranks = engine.ranks
        digests = ranks[0]["digests"]
        check(all(r["digests"] == digests for r in ranks.values()) and len(digests) == 2 * st.waves,
              f"the {shards} ranks ended a wave with different windows or bitmaps")
        launches = sum(r["launches"] for r in ranks.values())
        check(launches == 2 * shards * st.waves,
              f"{shards} ranks made {launches} launches in {2 * st.waves:.0f} waves")
        kernel_ms = sum(r["kernel_ms"] for r in ranks.values()) / 2  # per search
        pg[shards] = dict(launches=launches, wall_ms=wall_ms, gather_ms=gather_ms,
                          busy=kernel_ms / wall_ms)
        log(f"process-group engine: {shards} ranks on one card, backend gloo (each "
            f"collective staged through the host), spawned and "
            f"loaded in {spawn_s:.1f} s; {len(queries)} queries, {st.waves:.0f} waves, "
            f"ids and distances equal to (a)'s; every rank's window and bitmap equal after "
            f"each of {len(digests)} waves; exchange {st.exchange_bytes_per_wave:.0f} B a "
            f"wave, {st.exchange_bytes_per_query:.0f} B a query; a search {wall_ms:.1f} ms, "
            f"its all-gather {gather_ms:.3f} ms a wave on rank 0, the kernels "
            f"{kernel_ms:.2f} ms summed over ranks (card busy {100 * kernel_ms / wall_ms:.1f} %"
            f" of the search); launches {launches}; on {card}")

    # (c) serve --graph-shards 4 from phase 14's snapshot, then a shard death.
    g_argv = ["--index", "graph", "--device", DEV, "--corpus", str(gsvc.corpus_per_device),
              "--dim", str(gsvc.dim), "--k", "10", "--batch", "1024", "--delta-d",
              str(gsvc.delta_d), "--p-s", "0.02", "--ef", "48", "--expand", "2", "--m", "16",
              "--index-ckpt", snapshot, "--requests", str(SHARDED_REQUESTS),
              "--graph-shards", "4", "--dist-backend", "gloo"]
    work = Path(snapshot).parent
    serves = {}
    for name, extra in (("healthy", []),
                        ("degraded", ["--chaos", "shard_death:shard=1:after=2",
                                      "--verify-degraded-oracle"])):
        path = work / f"sharded_{name}.json"
        t0 = time.perf_counter()
        rep = serve.main(g_argv + extra + ["--metrics-json", str(path)])
        serves[name] = (rep, time.perf_counter() - t0)
        check(rep["requests_served"] == SHARDED_REQUESTS and rep["requests_shed"] == 0,
              f"sharded serving ({name}) did not answer every request")
        out = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
                              str(path)], capture_output=True, text=True, timeout=60)
        check(out.returncode == 0, f"sharded metrics schema ({name}): {out.stdout}")
    rep_h, rep_d = serves["healthy"][0], serves["degraded"][0]
    check(rep_d.get("degraded_requests", 0) > 0, "the shard death degraded no request")
    serve_launches = sum(sum(r["rank_launches"]) for r, _ in serves.values())
    log(f"sharded serve: --graph-shards 4, backend {rep_h['backend']}, {SHARDED_REQUESTS} requests "
        f"({rep_h['queries']} queries, {rep_h['batches']} batches) from phase 14's snapshot: "
        f"QPS {rep_h['qps']:.1f} over {window_s(rep_h):.2f} s (4 ranks on one card, not 4 "
        f"chips) recall@10 "
        f"{rep_h['recall']:.4f}, exchange {rep_h['exchange_bytes_per_wave']:.0f} B a wave, "
        f"metrics schema ok, "
        f"{serves['healthy'][1]:.0f} s; shard_death:shard=1:after=2: QPS "
        f"{rep_d['qps']:.1f} over {window_s(rep_d):.2f} s, {rep_d['degraded_requests']} degraded requests at recall@10 "
        f"{rep_d['degraded_recall']:.4f} (delta {rep_d['degraded_recall_delta']:+.4f}), "
        f"survivors equal to the surviving-corpus oracle, {serves['degraded'][1]:.0f} s; "
        f"rank launches {rep_h['rank_launches']} / {rep_d['rank_launches']}; on {card}")

    # (d) continuous sharded serving: every retired query against its solo walk.
    c_argv = [a for a in g_argv if a not in ("--dist-backend", "gloo")]
    c_argv[c_argv.index("--batch") + 1] = str(SHARDED_CONT_BATCH)
    c_argv[c_argv.index("--graph-shards") + 1] = "2"
    before = wave_kernel.launches
    with served_walks() as done:
        rep_c = serve.main(c_argv + ["--continuous", "--max-live", str(CONT_MAX_LIVE),
                                     "--verify-graph-oracle"])
    cont_launches = wave_kernel.launches - before
    rows = np.stack([r for r, _ in done])
    for row, rq in done:
        d, i, st = graph_mod.search_graph_sharded(gidx, row[None], num_shards=2, **kw)
        check(np.array_equal(rq.ids, i.cpu().numpy()[0])
              and np.array_equal(rq.dists, d.cpu().numpy()[0]) and rq.stats == st,
              "a continuous sharded query diverges from its solo sharded walk")
    log(f"continuous sharded serve: --graph-shards 2 (host-simulated), "
        f"{SHARDED_REQUESTS} requests of {SHARDED_CONT_BATCH // 2}-"
        f"{2 * SHARDED_CONT_BATCH - 1} queries: QPS {rep_c['qps']:.1f} over "
        f"{window_s(rep_c):.2f} s, recall@10 "
        f"{rep_c['recall']:.4f}, {rep_c['waves']:.0f} waves; all {len(rows)} retired "
        f"queries (warm-up and verify included) equal their solo sharded walks: ids, "
        f"distances, ledgers; one-wave launches {cont_launches}; on {card}")

    # (e) the flat route over two ranks against phase 4's one-process run of
    # the same requests.
    f_argv, one = flat_served
    ivf_scan_kernel_call.launches = 0
    ranked = serve.main(f_argv + ["--ranks", "2", "--dist-backend", "gloo"])
    check(ranked["ids_sha256"] == one["ids_sha256"],
          "the flat route over 2 ranks served other ids than phase 4's one-process run")
    log(f"flat over ranks: {FLAT_REQUESTS} requests ({one['queries']} queries), --ranks 2 "
        f"--shards 4 (backend {ranked['backend']}, 2 ranks on one card) QPS "
        f"{ranked['qps']:.1f} over {window_s(ranked):.2f} s, recall@100 "
        f"{ranked['recall']:.4f}, the rank merge "
        f"{ranked['merge_ms_per_batch']:.3f} ms a batch; phase 4's one process --shards 4: "
        f"QPS {one['qps']:.1f} over {window_s(one):.2f} s, recall@100 {one['recall']:.4f}; "
        f"the same ids; ivf_scan "
        f"launches {ivf_scan_kernel_call.launches} (ranks {ranked['rank_launches']}); "
        f"on {card}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"phase 15 took {time.perf_counter() - t_start:.0f}s on {card}")
    return {"max_err": max_err, "host_launches": host_launches,
            "pg_launches": sum(p["launches"] for p in pg.values()),
            "serve_launches": serve_launches, "cont_launches": cont_launches,
            "flat_launches": ivf_scan_kernel_call.launches + sum(ranked["rank_launches"][1:]),
            "s4_ms": statistics.median(times[4]), "pg": pg}


def run_continuous_ivf(idx, queries, k: int, card: str) -> dict:
    """Phase 13: ``ContinuousIVFEngine`` on phase 3's index (n_probe 16, two
    probes a launch) serving ``queries`` under a seeded random admission
    schedule; each result held against the query's solo
    ``search_ivf_fused(block_q=8)`` on the card, bit for bit: ids,
    distances and the ``FusedScanStats`` ledger; then the run's launch
    with the most carried windows (``top0_sq`` rows holding a finite
    entry) held against the plain version on its own inputs.  Returns the
    engine run's ``ivf_scan`` launches, their median ms and that launch's
    deviation from the plain version."""
    import numpy as np
    import torch
    from repro_torch.index.ivf import search_ivf_fused
    from repro_torch.kernels import ivf_scan, ops
    from repro_torch.kernels.ivf_scan import ivf_scan_kernel_call
    from repro_torch.launch.annservice import ContinuousIVFEngine

    rows = np.asarray(queries, np.float32)
    schedule = np.random.default_rng(13).integers(0, 9, size=24).tolist()
    events, widest = [], {"seeded": 0}
    real = ops.ivf_scan_kernel_call

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*a, **kw)
        ev[1].record()
        events.append(ev)
        seeded = int(torch.isfinite(a[5]).any(dim=1).sum())  # a[5] is top0_sq
        if seeded > widest["seeded"]:
            widest.update(seeded=seeded, call=(a, kw))
        return out

    ivf_scan_kernel_call.launches = 0
    ops.ivf_scan_kernel_call = timed
    try:
        t0 = time.perf_counter()
        out = run_schedule(ContinuousIVFEngine(idx, k=k, n_probe=16, probe_chunk=2),
                           rows, schedule)
        sync()
        wall = time.perf_counter() - t0
    finally:
        ops.ivf_scan_kernel_call = real
    launches = ivf_scan_kernel_call.launches
    check(launches > 0 and launches == len(events),
          f"continuous IVF launched {launches} ivf_scan kernels ({len(events)} timed)")
    ms = statistics.median(a.elapsed_time(b) for a, b in events)
    same = 0
    for i in range(len(rows)):
        d, ids, st = search_ivf_fused(idx, rows[i][None], k=k, n_probe=16, block_q=8)
        rq = out[i]
        check(np.array_equal(rq.ids, ids.cpu().numpy()[0]), f"continuous IVF query {i}: ids")
        check(np.array_equal(rq.dists, d.cpu().numpy()[0]), f"continuous IVF query {i}: dists")
        check(rq.stats == st, f"continuous IVF query {i}: ledger {rq.stats} vs {st}")
        same += 1
    check(widest["seeded"] > 0, "no continuous IVF launch carried a window")
    a, kw = widest["call"]
    tiles = a[0].shape[0]
    err = agree(f"continuous_ivf_{tiles}_tiles_{widest['seeded']}_carried", real(*a, **kw),
                ivf_scan.ivf_scan_plain(*a, **kw), kw["block_q"])
    waves = sorted({rq.waves for rq in out.values()})
    log(f"continuous ivf: {len(rows)} queries admitted on schedule {schedule}: {launches} "
        f"ivf_scan launches (median {ms:.4f} ms each, slots {waves} launches each) in "
        f"{wall * 1e3:.1f} ms; {same} of {len(rows)} bit-identical to their solo "
        f"search_ivf_fused (ids, distances, ledger); the launch with {widest['seeded']} "
        f"carried windows ({tiles} tiles) bit-identical to its plain version on {card}")
    return {"launches": launches, "ms": ms, "max_err": err}


def per_slot_wave_ms(eng) -> dict:
    """The reference engine's per-slot host loop, timed on a continuous
    graph engine's live state: each slot's frontier picked alone (its tile
    through ``_select_wave``, its pick list read back), the launch stacked
    slot by slot, and the window and bitmap read back and cut per slot."""
    import torch
    from repro_torch.index.graph import _select_wave

    bq, tc, n = eng.block_q, eng.thresh_col, len(eng._handles)
    sync()
    t0 = time.perf_counter()
    for t in range(n):
        rows = slice(t * bq, (t + 1) * bq)
        r0 = torch.minimum(eng._seed[rows], eng._top_sq[rows, tc])
        _select_wave(eng._top_sq[rows], eng._top_ids[rows], eng._vis[t: t + 1],
                     r0, block_q=bq, qn=1, expand=eng.expand,
                     ef=eng.ef).tolist()
    t1 = time.perf_counter()
    stacked = [torch.cat([x[t * bq: (t + 1) * bq] for t in range(n)])
               for x in (eng._q, eng._top_sq, eng._top_ids)]
    stacked.append(torch.cat([eng._vis[t: t + 1] for t in range(n)]))
    sync()
    t2 = time.perf_counter()
    sq, ids, vis = (x.cpu().numpy() for x in (eng._top_sq, eng._top_ids, eng._vis))
    [(sq[t * bq: (t + 1) * bq], ids[t * bq: (t + 1) * bq], vis[t: t + 1]) for t in range(n)]
    t3 = time.perf_counter()
    return {"select": (t1 - t0) * 1e3, "stack": (t2 - t1) * 1e3, "readback": (t3 - t2) * 1e3}


def window_s(report: dict) -> float:
    """The seconds of a serve run's timed window (its queries over its QPS)."""
    return report["queries"] / report["qps"]


def requests_queries(gsrv, gsvc):
    """The queries and exact neighbours of phase 12's closed-loop requests,
    made as ``serve`` makes its payloads (``default_rng(9)`` sizes,
    ``synthetic_queries(seed=100 + r)``)."""
    import numpy as np
    from repro_torch.core.topk import exact_knn
    from repro_torch.data.pipeline import synthetic_queries

    rng = np.random.default_rng(9)
    out = []
    for r in range(CONT_REQUESTS):
        nq = int(rng.integers(gsvc.query_batch // 2, 2 * gsvc.query_batch))
        q = synthetic_queries(nq, gsvc.dim, gsrv.corpus, seed=100 + r)
        _, gt = exact_knn(q, gsrv.corpus_t, 10, device=DEV)
        out.append((q, gt.cpu().numpy()))
    return out


def mean_request_rows(batch: int, requests: int) -> float:
    """The mean query count of ``serve``'s requests at ``--batch batch``
    (its ``default_rng(9)`` sizes)."""
    import numpy as np

    rng = np.random.default_rng(9)
    return float(np.mean([int(rng.integers(batch // 2, 2 * batch)) for _ in range(requests)]))


def solo_walks(gsrv, rows, *, expand: int = 2):
    """Each query of ``rows`` walked alone — a tile of its own, seeded by
    ``_prep_wave_state`` as a one-query batch — by the walk kernel, all
    tiles in one launch (tiles are independent, so each is its solo walk);
    returns each query's top-10 distances (as the engine takes them, the
    root of the squared window), ids and waves."""
    import numpy as np
    import torch
    from repro_torch.index.graph import _prep_wave_state
    from repro_torch.kernels.graph_scan import graph_walk_kernel_call
    from repro_torch.kernels.ops import graph_walk_inputs

    ix = gsrv.index
    parts = [_prep_wave_state(ix, np.asarray(r, np.float32)[None], k=10, ef=48, block_q=8,
                              seed_r=False) for r in rows]
    q, top_sq, top_ids, seed = (torch.cat([p[i] for p in parts]) for i in (1, 6, 7, 8))
    args, kw = graph_walk_inputs(
        ix.estimator, q, top_sq, top_ids, seed, ix.adj_rot, ix.adj_codes, ix.adj_ids,
        ix.gscales, entry=ix.entry, ef=48, thresh_col=9, expand=expand, max_waves=64,
        block_q=8, block_c=ix.adj_block, block_d=ix.scan_block_d)
    t_sq, t_ids, _, _, waves = graph_walk_kernel_call(*args, **kw)
    sq = t_sq[::8, :10].cpu().numpy()
    return (np.sqrt(np.maximum(sq, 0.0)), t_ids[::8, :10].cpu().numpy(),
            waves.cpu().numpy())


def solo_walk_recall(gsrv, requests, *, expand: int = 2):
    """The queries of ``requests`` ([(queries, gt), ...]) walked alone
    (:func:`solo_walks`); returns the serve report's recall@10 (the mean
    over requests of the mean over their queries) and the mean waves a
    query walked."""
    import numpy as np

    _, ids, waves = solo_walks(gsrv, np.concatenate([q for q, _ in requests]), expand=expand)
    recs, at = [], 0
    for qs, gt in requests:
        recs.append(np.mean([len(set(ids[at + i]) & set(gt[i])) / 10 for i in range(len(gt))]))
        at += len(gt)
    return float(np.mean(recs)), float(waves.astype(np.float64).mean())


@contextlib.contextmanager
def served_walks():
    """While open, every ``ContinuousGraphEngine`` keeps each admitted
    query's row and its retirement: yields a list that fills with
    (row, RetiredQuery) pairs, in retirement order."""
    import numpy as np
    from repro_torch.launch.annservice import ContinuousGraphEngine as Engine

    admit, step = Engine.admit, Engine.step
    rows, done, engines = {}, [], {}

    def admit_(self, row):
        h = admit(self, row)
        engines[id(self)] = self  # keeps id(self) unique while open
        rows[(id(self), h)] = np.asarray(row, np.float32)
        return h

    def step_(self):
        out = step(self)
        done.extend((rows.pop((id(self), rq.handle)), rq) for rq in out)
        return out

    Engine.admit, Engine.step = admit_, step_
    try:
        yield done
    finally:
        Engine.admit, Engine.step = admit, step


def run_continuous_graph(gsrv, gsvc, phase7, card: str) -> dict:
    """Phase 12: ``serve --index graph --continuous`` on phase 7's graph
    (max_live 1024, k 10, ef 48, expand 2): the closed loop with
    ``--verify-graph-oracle`` (8 interleaved queries bit-identical to each
    served alone by the walk kernel and by the plain walk), every query it
    serves returning the ids and distances of its solo walk; then the open
    loop at half the closed loop's query rate under a deadline, a
    watermark, 2 retries and a ``step_error:count=2`` drill.  Each metrics
    JSON passes ``scripts/check_metrics_schema.py`` (a subprocess).  Then
    one engine at full occupancy: the wave's split (tracer spans), the
    per-slot loop's host time on the same state, the card's busy share
    (``torch.profiler``), and one stacked launch of the one-wave kernel at
    the largest live bucket held against ``ref.graph_scan_ref`` and timed;
    and phase 7's 1024 queries (``phase7``: queries, exact neighbours, the
    batch route's recall) walked alone at expand 2, 4, 8 and 16.  Returns
    the one-wave kernel's launches in the two serving runs, its ms at that
    bucket and its deviation from the plain version."""
    import json
    import tempfile

    import numpy as np
    import torch
    from repro_torch.data.pipeline import synthetic_queries
    from repro_torch.kernels import graph_scan, ops, ref
    from repro_torch.launch import serve
    from repro_torch.launch.annservice import ContinuousGraphEngine
    from repro_torch.obs import Tracer, span_totals, use_tracer

    wave_kernel = graph_scan.graph_scan_kernel_call
    t_start = time.perf_counter()

    def argv(batch):
        return ["--index", "graph", "--device", DEV, "--continuous",
                "--max-live", str(CONT_MAX_LIVE),
                "--corpus", str(gsvc.corpus_per_device), "--dim", str(gsvc.dim), "--k", "10",
                "--batch", str(batch), "--delta-d", str(gsvc.delta_d),
                "--p-s", "0.02", "--ef", "48", "--expand", "2", "--m", "16"]

    def schema(path):
        out = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_metrics_schema.py"),
                              path], capture_output=True, text=True, timeout=60)
        check(out.returncode == 0, f"metrics schema: {out.stdout} {out.stderr}")
        return json.load(open(path))["metrics"]

    with tempfile.TemporaryDirectory() as tmp:
        wave_kernel.launches = 0
        with served_walks() as walks:
            closed = serve.main(argv(gsvc.query_batch) + [
                "--requests", str(CONT_REQUESTS), "--verify-graph-oracle",
                "--metrics-json", f"{tmp}/closed.json"], graph=gsrv)
        closed_launches = wave_kernel.launches
        check(closed_launches > 0, "continuous serving launched no one-wave graph_scan kernel")
        check(closed["requests_served"] == CONT_REQUESTS and closed["requests_shed"] == 0,
              "continuous serving shed requests")
        # Every served query is its solo walk: each retirement (warm-up and
        # verify included) returns the ids and distances of its own query
        # walked alone by the walk kernel.
        check(len(walks) >= closed["queries"], f"{len(walks)} retirements for "
              f"{closed['queries']} served queries")
        solo_d, solo_ids, _ = solo_walks(gsrv, [row for row, _ in walks])
        bad = [i for i, (_, rq) in enumerate(walks)
               if not (np.array_equal(rq.ids, solo_ids[i]) and np.array_equal(rq.dists, solo_d[i]))]
        check(not bad, f"{len(bad)} of {len(walks)} continuous walks differ from their solo "
              f"walks (first: {bad[:5]})")
        n_walks = len(walks)
        del walks, solo_d, solo_ids
        solo_rec, solo_waves = solo_walk_recall(gsrv, requests_queries(gsrv, gsvc))
        check(closed["recall"] == solo_rec,
              f"continuous recall@10 {closed['recall']} != its solo walks' {solo_rec}")
        m = schema(f"{tmp}/closed.json")
        window = closed["queries"] / closed["qps"]
        log(f"continuous graph serve: closed loop {CONT_REQUESTS} requests "
            f"({closed['queries']} queries, max_live {CONT_MAX_LIVE}), a timed window of "
            f"{window:.3f} s: qps={closed['qps']:.1f} recall@10={closed['recall']:.4f} "
            f"waves={closed['waves']:.0f} occupancy={closed['occupancy']:.1f} "
            f"waves_per_query={closed['mean_depth']:.2f} one-wave launches={closed_launches} "
            f"admitted={m['serve.admission.admitted']['value']:.0f} "
            f"retired={m['serve.admission.retired']['value']:.0f}; metrics schema ok; "
            f"all {n_walks} retirements (warm-up and verify included) equal in ids and "
            f"distances to their solo walks; the "
            f"same queries walked alone by the walk kernel (stacked one-query tiles, one "
            f"launch): recall@10={solo_rec:.4f}, {solo_waves:.2f} waves a query"
            + ("" if 2.0 <= window <= 10.0 else " (window outside 2-10 s)"))
        # Half the closed loop's query rate, in requests of --batch OPEN_BATCH.
        rate = 0.5 * closed["qps"] / mean_request_rows(OPEN_BATCH, OPEN_REQUESTS)
        deadline_ms = round(1e3 * window)
        wave_kernel.launches = 0
        opened = serve.main(argv(OPEN_BATCH) + [
            "--requests", str(OPEN_REQUESTS), "--open-loop", f"{rate:.4f}",
            "--deadline-ms", str(deadline_ms), "--queue-watermark", "8192",
            "--retries", "2", "--chaos", "step_error:count=2",
            "--metrics-json", f"{tmp}/open.json"], graph=gsrv)
        open_launches = wave_kernel.launches
        m = schema(f"{tmp}/open.json")
        check(opened["retries"] == 2, f"the step_error drill was not retried: {opened}")
        p = {q: m[f"serve.request.p{q}_ms"]["value"] for q in (50, 95, 99)}
        samples = m["serve.request.latency_ms"]["count"]
        shed = {k: m.get(f"serve.shed.{k}", {}).get("value", 0.0)
                for k in ("queue", "deadline", "error")}
        check(shed["error"] == 0, f"the open loop shed {shed['error']} requests for errors")
        check(opened["requests_served"] + opened["requests_shed"]
              == opened["requests_submitted"] == OPEN_REQUESTS,
              f"the open loop's requests do not close: {opened}")
        log(f"continuous graph serve: open loop, {OPEN_REQUESTS} requests of --batch "
            f"{OPEN_BATCH} ({OPEN_BATCH // 2}-{2 * OPEN_BATCH - 1} queries) at {rate:.3f} "
            f"requests/s (half the closed loop's query rate), deadline {deadline_ms} ms, "
            f"watermark 8192 rows, retries 2, chaos step_error:count=2: "
            f"qps={opened['qps']:.1f} recall@10={opened['recall']:.4f} "
            f"latency_ms p50={p[50]:.1f} p95={p[95]:.1f} p99={p[99]:.1f} over {samples} "
            f"samples served={opened['requests_served']}/{opened['requests_submitted']} shed={shed} "
            f"retries={opened['retries']} admitted={m['serve.admission.admitted']['value']:.0f} "
            f"retired={m['serve.admission.retired']['value']:.0f} "
            f"admission_shed={opened['admission_shed']}; metrics schema ok")

    # One engine at full occupancy: admit 1024 queries, stack them (wave 0),
    # then trace, profile and time the waves that follow.
    eng = ContinuousGraphEngine(gsrv.index, k=10, ef=48, expand=2)
    qs = synthetic_queries(CONT_MAX_LIVE, gsvc.dim, gsrv.corpus, seed=11)
    sync()
    t0 = time.perf_counter()
    for row in qs:
        eng.admit(row)
    sync()
    admit_ms = (time.perf_counter() - t0) * 1e3 / len(qs)
    eng.step()
    tr = Tracer()
    with use_tracer(tr):
        for _ in range(3):
            eng.step()
    tot = span_totals(tr)
    parts = ("continuous.select", "continuous.retire", "continuous.stack", "continuous.wave",
             "continuous.commit")
    split = {p.split(".")[1]: tot[p]["total_ms"] / tot[p]["count"] for p in parts if p in tot}
    per_slot = per_slot_wave_ms(eng)
    live = eng.live_count()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    kernel_busy = sum(e.self_device_time_total for e in device
                      if "graph_scan_kernel" in e.key) / 1e3
    kept = []
    wrapper = ops.graph_scan_kernel
    ops.graph_scan_kernel = lambda *a, **k: kept.append((a, k)) or wrapper(*a, **k)
    try:
        eng.step()
    finally:
        ops.graph_scan_kernel = wrapper
    (a, k), = kept
    a, k = ops.graph_scan_inputs(*a, **k)  # the launch's own inputs
    tiles = a[1].shape[0] // k["block_q"]
    wave_kernel(*a, **k)  # warm
    ms, out_k = cuda_ms(lambda: wave_kernel(*a, **k), 11)
    err = agree_graph(f"graph_continuous_bucket{tiles}", out_k, ref.graph_scan_ref(*a, **k),
                      k["block_q"])
    q7, gt7, batch_rec = phase7
    sweep = {e: solo_walk_recall(gsrv, [(q7, gt7)], expand=e) for e in (2, 4, 8, 16)}
    log(f"continuous graph: phase 7's {len(q7)} queries walked alone (one-query tiles), "
        f"recall@10 / waves a query by expand: " + " ".join(
            f"{e}: {r:.4f} / {w:.2f}" for e, (r, w) in sweep.items())
        + f"; the batch route's 8-query tiles at expand 2: {batch_rec:.4f}")
    log(f"continuous graph wave at {live} live queries ({tiles}-tile bucket, "
        f"{a[0].shape[1]} steps): host split per wave (tracer spans, fenced) "
        + " ".join(f"{n}={v:.3f} ms" for n, v in split.items())
        + f"; admission {admit_ms:.4f} ms a query; the per-slot loop on the same state "
        f"select={per_slot['select']:.1f} ms stack={per_slot['stack']:.1f} ms "
        f"readback={per_slot['readback']:.1f} ms; 3 profiled waves {prof_ms:.2f} ms: card "
        f"busy {busy_ms:.3f} ms ({100 * busy_ms / prof_ms:.2f} %), graph_scan "
        f"{kernel_busy:.3f} ms; the one-wave kernel alone {ms:.4f} ms a launch on {card}; "
        f"phase 12 took {time.perf_counter() - t_start:.0f}s")
    return {"launches": closed_launches + open_launches, "ms": ms, "max_err": err}


def agree_screen(name, out_k, out_p):
    """Holds a flat screen kernel's outputs (estimate, flag, dims — or the
    l2 distances alone) against its plain version's, bit for bit; returns
    the largest absolute deviation of the finite estimates (0 when they
    agree)."""
    import torch

    est_k, est_p = out_k[0], out_p[0]
    fin = torch.isfinite(est_p)
    err = float((est_k[fin] - est_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    same_inf = torch.equal(torch.isfinite(est_k), fin) and torch.equal(
        est_k[~fin], est_p[~fin])
    check(same_inf and err == 0.0, f"{name}: estimates differ (max_abs_err={err:.3e})")
    for what, a, b in zip(("flag", "dims"), out_k[1:], out_p[1:]):
        check(torch.equal(a, b), f"{name}: {what} differ in {int((a != b).sum())} pairs")
    return err


def screen_case(seed, *, method, dim, block_d, n, qn=40, bf16=False, tile=(8, 128)):
    """A calibrated estimator of ``method`` on a 4096-row corpus, ``qn``
    queries near corpus rows, ``n`` candidates, int8 codes, and thresholds
    from each query's 2 % quantile, with query rows 16-31 (one kernel tile)
    at r² = 0 (retired after one block), row 32 at 1e30 and row 33 at inf."""
    import torch
    from repro_torch.core.estimators import build_estimator
    from repro_torch.quant.scalar import quantize_corpus

    g = torch.Generator(device=DEV).manual_seed(seed)
    scales = torch.exp(-0.03 * torch.arange(dim, device=DEV))
    data = torch.randn((4096, dim), generator=g, device=DEV) * scales
    est = build_estimator(method, data, torch.Generator().manual_seed(seed),
                          delta_d=32, device=DEV)
    c = est.rotate(data[:n])
    q = est.rotate(data[:qn] + 0.3 * torch.randn((qn, dim), generator=g, device=DEV)
                   * scales)
    r_sq = torch.quantile(torch.cdist(q, c) ** 2, 0.02, dim=1)
    r_sq[16:32] = 0.0
    r_sq[32], r_sq[33] = 1e30, float("inf")
    if bf16:
        q, c = q.bfloat16(), c.bfloat16()
    qc = quantize_corpus(c.float())
    return est, q, c, qc, r_sq, dict(block_q=tile[0], block_c=tile[1], block_d=block_d)


def run_flat(svc, card: str) -> list:
    """Phases 9-11 on ``DEV``; returns the dade_dco, quant_dco and l2_scan
    kernels entries."""
    import torch
    from repro_torch.core.estimators import kernel_spec
    from repro_torch.core.topk import exact_knn
    from repro_torch.data.pipeline import synthetic_queries, synthetic_vectors
    from repro_torch.index.flat import build_flat, search_flat
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels._screen import KERNEL_TILE, LIST_CAP, PATH_CASES, path_case, \
        screen_work
    from repro_torch.kernels.tiles import sqrt_rn
    from repro_torch.quant.scalar import cum_err_sq
    from repro_torch.kernels.dade_dco import dade_dco_kernel_call
    from repro_torch.kernels.l2_scan import l2_scan_kernel_call
    from repro_torch.kernels.quant_dco import quant_dco_kernel_call

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    errs = {"dade_dco": 0.0, "quant_dco": 0.0, "l2_scan": 0.0}

    # ---- 9. parity on awkward cases: kernel vs plain on identical inputs ----
    stamp("phase 9")
    cases = [
        ("dade_d64_bd32", dict(seed=21, method="dade", dim=64, block_d=32, n=1037)),
        ("adsampling_d200_bd64_bf16", dict(seed=22, method="adsampling", dim=200,
                                           block_d=64, n=777, bf16=True)),
        ("fdscanning_d384_bd128", dict(seed=23, method="fdscanning", dim=384,
                                       block_d=128, n=555, tile=(1, 1))),
        ("dade_d256_bd64_bf16_ragged", dict(seed=24, method="dade", dim=256, block_d=64,
                                            n=3001, qn=37, bf16=True, tile=(1, 1))),
    ]
    for name, kw in cases:
        est, q, c, qc, r_sq, kkw = screen_case(**kw)
        out_k = ops.dco_screen_kernel(est, q, c, r_sq, **kkw)
        out_p = ops.dco_screen_kernel(est, q, c, r_sq, use_ref=True, **kkw)
        errs["dade_dco"] = max(errs["dade_dco"], agree_screen(f"dade_dco {name}", out_k, out_p))
        passed, dims = out_k[1], out_k[2]
        lq = ops.quant_screen_kernel(est, q, qc.codes, qc.scales, r_sq, **kkw)
        lp = ops.quant_screen_kernel(est, q, qc.codes, qc.scales, r_sq, use_ref=True, **kkw)
        errs["quant_dco"] = max(errs["quant_dco"], agree_screen(f"quant_dco {name}", lq, lp))
        bd = kkw["block_d"]
        pad = (-q.shape[1]) % bd
        qp = torch.nn.functional.pad(q.float(), (0, pad))
        cp = torch.cat([torch.nn.functional.pad(c.float(), (0, pad)),
                        torch.full((5, q.shape[1] + pad), 1e18, device=DEV)])
        dk = l2_scan_kernel_call(qp, cp, block_q=1, block_c=1, block_d=bd)
        errs["l2_scan"] = max(errs["l2_scan"], agree_screen(
            f"l2_scan {name}", (dk,), (ref.l2_scan_ref(qp, cp, block_d=bd),)))
        sync()
        log(f"parity flat {name}: bit for bit; passed={float(passed.float().mean()):.4f} "
            f"pruned={float(lq[1].float().mean()):.4f} "
            f"mean_dims={float(dims.float().mean()):.1f} "
            f"tile_16_31_dims_max={int(dims[16:32].max())} inf_l2={int(torch.isinf(dk).sum())}")
        check(int(dims[16:32].max()) == bd, f"{name}: the r²=0 tile did not retire at block 1")
    # Each path of the kernel's design, bit for bit, the path read off dims.
    for case in PATH_CASES:
        fp_args, q_args, bd, survivors = path_case(case, DEV)
        kw = dict(block_q=1, block_c=1, block_d=bd)
        s_count = q_args[0].shape[1] // bd
        works = []
        for name, kern, plain, args in (
                ("dade_dco", dade_dco_kernel_call, ref.dade_dco_ref, fp_args),
                ("quant_dco", quant_dco_kernel_call, ref.quant_dco_ref, q_args)):
            out_k = kern(*args, **kw)
            errs[name] = max(errs[name], agree_screen(f"{name} {case}", out_k,
                                                      plain(*args, block_d=bd)))
            dims = out_k[2]
            work = screen_work(dims, bd)
            works.append(f"{name} dense_steps={work['dense_steps']} "
                         f"list_entries={work['list_entries']} tiles={work['tiles']}")
            if survivors is not None:
                check(int((dims > bd).sum()) == survivors,
                      f"{name} {case}: {int((dims > bd).sum())} block-1 survivors")
                check(work["dense_steps"] == (1 if case == "cap" else 2)
                      and work["list_entries"] > 0, f"{name} {case}: path {work}")
            elif case == "all_survive":
                check(work["dense_steps"] == work["tiles"] * s_count
                      and work["list_entries"] == 0, f"{name} {case}: path {work}")
            else:
                check(work["list_entries"] > 0, f"{name} {case}: no list ran")
        sync()
        log(f"parity flat path {case} {tuple(q_args[0].shape)} x {q_args[1].shape[0]} "
            f"block_d {bd}: bit for bit; {'; '.join(works)} (tile {KERNEL_TILE}, "
            f"list capacity {LIST_CAP})")

    # ---- 10. the flat DCO screen at full width ----
    n, dim, qn, k, bd = svc.corpus_per_device, svc.dim, svc.query_batch, svc.k, svc.delta_d
    t0 = time.perf_counter()
    corpus = synthetic_vectors(n, dim, seed=0)
    queries = synthetic_queries(qn, dim, corpus, seed=1)
    corpus_t = torch.as_tensor(corpus, device=DEV)
    del corpus
    idx = build_flat(corpus_t, method="dade", delta_d=bd, p_s=svc.p_s, quant="int8",
                     generator=torch.Generator().manual_seed(0), device=DEV)
    gt_d, gt = exact_knn(queries, corpus_t, k, device=DEV)
    r_sq = (gt_d[:, -1] ** 2).contiguous()
    q_rot = idx.estimator.rotate(torch.as_tensor(queries, device=DEV)).contiguous()
    c_rot, codes, qscales = idx.corpus_rot, idx.corpus_q, idx.qscales
    sync()
    log(f"flat: build_flat {n}x{dim} (DADE, delta_d={bd}, p_s={svc.p_s}, int8) and "
        f"ground truth in {time.perf_counter() - t0:.1f}s")
    kernels = (dade_dco_kernel_call, quant_dco_kernel_call, l2_scan_kernel_call)
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    est_sq, passed, dims = ops.dco_screen_kernel(idx.estimator, q_rot, c_rot, r_sq, block_d=bd)
    lb_sq, pruned, lb_dims = ops.quant_screen_kernel(idx.estimator, q_rot, codes, qscales,
                                                     r_sq, block_d=bd)
    dist_sq = l2_scan_kernel_call(q_rot, c_rot, block_d=bd)
    sync()
    path_s = time.perf_counter() - t0
    launches = {kern.__name__.removesuffix("_kernel_call"): kern.launches for kern in kernels}
    for name, count in launches.items():
        check(count > 0, f"the flat screen path launched no {name} kernel")
    check(tuple(est_sq.shape) == (qn, n) and tuple(dist_sq.shape) == (qn, n),
          "flat screen outputs malformed")
    check(bool(torch.isfinite(dist_sq).all()) and bool(torch.isfinite(est_sq).all()),
          "flat screen outputs not finite")
    top = torch.topk(dist_sq, k, dim=1, largest=False).indices
    l2_rec = float(sum(len(set(a) & set(b)) for a, b in zip(top.tolist(), gt.tolist()))
                   / (qn * k))
    check(l2_rec >= 0.999, f"l2_scan top-{k} recall {l2_rec} < 0.999")
    kept = float(torch.gather(passed, 1, gt).float().mean())
    check(kept >= 0.95, f"dco_screen_kernel passed {kept} of the exact top-{k} < 0.95")
    inside = dist_sq <= r_sq[:, None] * (1 - 1e-6)
    false_prunes = int((pruned & inside).sum())
    check(false_prunes == 0, f"quant_screen_kernel pruned {false_prunes} rows inside r²")
    both = int((pruned & passed).sum())
    check(both == 0, f"quant_screen_kernel pruned {both} rows the fp32 screen passed")
    s_count = dim // bd
    pass_rate = float(passed.double().mean())
    dims_frac = float(dims.double().mean()) / dim
    prune_rate = float(pruned.double().mean())
    # The kernel's paths, read off dims: (tile, block) steps run dense and
    # list entries (a survivor per later block).
    work = {"dade_dco": screen_work(dims, bd), "quant_dco": screen_work(lb_dims, bd)}
    work_s = "; ".join(f"{name} dense_steps={w['dense_steps']} (of {w['tiles'] * s_count}) "
                       f"list_entries={w['list_entries']}" for name, w in work.items())
    log(f"flat screen: launches {launches} in {path_s:.2f}s; l2 top-{k} recall={l2_rec:.4f}; "
        f"fp32 screen keeps {kept:.4f} of the exact top-{k}, pass_rate={pass_rate:.6f} "
        f"dims_frac={dims_frac:.4f}; int8 prefilter prune_rate={prune_rate:.6f} "
        f"lb_dims_frac={float(lb_dims.double().mean()) / dim:.4f}; false prunes 0, "
        f"pruned∧passed 0; paths (tile {KERNEL_TILE}, list capacity {LIST_CAP}): {work_s}")

    # ---- 9 (full shape). the main path's outputs against the plain versions ----
    chunk = 1 << 16
    plain_ms = {"dade_dco": 0.0, "quant_dco": 0.0, "l2_scan": 0.0}
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        ms_, out_p = cuda_ms(lambda: ops.dco_screen_kernel(
            idx.estimator, q_rot, c_rot[sl], r_sq, block_d=bd, use_ref=True), 1)
        plain_ms["dade_dco"] += ms_
        errs["dade_dco"] = max(errs["dade_dco"], agree_screen(
            "dade_dco full", (est_sq[:, sl], passed[:, sl], dims[:, sl]), out_p))
        ms_, out_p = cuda_ms(lambda: ops.quant_screen_kernel(
            idx.estimator, q_rot, codes[sl], qscales, r_sq, block_d=bd, use_ref=True), 1)
        plain_ms["quant_dco"] += ms_
        errs["quant_dco"] = max(errs["quant_dco"], agree_screen(
            "quant_dco full", (lb_sq[:, sl], pruned[:, sl], lb_dims[:, sl]), out_p))
        ms_, out_p = cuda_ms(lambda: ref.l2_scan_ref(q_rot, c_rot[sl], block_d=bd), 1)
        plain_ms["l2_scan"] += ms_
        errs["l2_scan"] = max(errs["l2_scan"], agree_screen(
            "l2_scan full", (dist_sq[:, sl],), (out_p,)))
        del out_p
    log(f"parity flat full shape {qn}x{n}x{dim}: all three kernels bit for bit over "
        f"{-(-n // chunk)} row chunks; plain ms {plain_ms}")

    # Bounds from this run's data: one multiply-add (2 fp32 operations) per
    # (query, row) dim consumed, plus the norms; bytes: the queries once,
    # each row's dims that the deepest query still needed once, the per-dim
    # scales, and the three (Q, N) outputs once.
    need_rows = dims.amax(dim=0).double().sum()
    need_codes = lb_dims.amax(dim=0).double().sum()
    # The instruction floor: the products at the dims the data consumes, each a
    # separate rounded multiply and add (exactness rules out the FMA).
    instr_ms = {"dade_dco": 2e3 * float(dims.double().sum()) / PEAK_FP32_INSTR,
                "quant_dco": 2e3 * float(lb_dims.double().sum()) / PEAK_FP32_INSTR}
    out_b = 3 * 4 * qn * n
    bounds = {
        "dade_dco": (2.0 * (float(dims.double().sum()) + float(need_rows) + qn * dim)
                     / PEAK_FP32_FLOPS,
                     (4 * qn * dim + 4 * float(need_rows) + out_b) / PEAK_BYTES),
        "quant_dco": (2.0 * (float(lb_dims.double().sum()) + float(need_codes) + qn * dim)
                      / PEAK_FP32_FLOPS,
                      (4 * qn * dim + float(need_codes) + 4 * dim + out_b) / PEAK_BYTES),
        "l2_scan": (2.0 * (qn * n * dim + n * dim + qn * dim) / PEAK_FP32_FLOPS,
                    (4 * qn * dim + 4 * n * dim + 4 * qn * n) / PEAK_BYTES),
    }
    screen_stats = (pass_rate, dims_frac, prune_rate)
    del est_sq, passed, dims, lb_sq, pruned, lb_dims, dist_sq, inside, top
    torch.cuda.empty_cache()

    # ---- 10 (timing). each kernel at the full shape ----
    spec = kernel_spec(idx.estimator, dim, bd)
    eps, scale = spec.eps.to(DEV), spec.scale.to(DEV)
    ecum = sqrt_rn(cum_err_sq(qscales, (torch.arange(s_count, device=DEV) + 1) * bd))
    calls = {
        "dade_dco": lambda: dade_dco_kernel_call(q_rot, c_rot, eps, scale, r_sq, block_d=bd),
        "quant_dco": lambda: quant_dco_kernel_call(q_rot, codes, qscales, eps, scale, ecum,
                                                   r_sq, block_d=bd),
        "l2_scan": lambda: l2_scan_kernel_call(q_rot, c_rot, block_d=bd),
    }
    ms = {}
    for name, fn in calls.items():
        fn()  # warm
        ms[name], out = cuda_ms(fn, 5)
        del out
        torch.cuda.empty_cache()
    cdist = lambda: torch.cdist(  # noqa: E731
        q_rot, c_rot, compute_mode="use_mm_for_euclid_dist").square_()
    cdist()  # warm
    library_ms, out = cuda_ms(cdist, 5)
    del out
    torch.cuda.empty_cache()
    log("library: dade_dco and quant_dco null — no single PyTorch call computes a "
        "checkpointed early-exit screen; l2_scan against torch.cdist "
        "(use_mm_for_euclid_dist, TF32 off) squared")
    for name, before in (("dade_dco", DADE_DCO_BEFORE_MS), ("quant_dco", QUANT_DCO_BEFORE_MS)):
        ops_s, bytes_s = bounds[name]
        log(f"{name} {qn}x{n}x{dim} (block_d {bd}): {ms[name]:.3f} ms; the 16 x 128 "
            f"skeleton it replaced took {before} ms on an NVIDIA H100 80GB HBM3 at 700.00 W "
            f"({before / ms[name]:.2f}x); bound {max(ops_s, bytes_s) * 1e3:.4f} ms "
            f"({ms[name] / (max(ops_s, bytes_s) * 1e3):.2f}x: bytes {bytes_s * 1e3:.4f}, "
            f"FMA-counted operations {ops_s * 1e3:.4f}); instruction floor with separate "
            f"multiplies and adds {instr_ms[name]:.4f} ms")
    log(f"l2_scan {qn}x{n}x{dim} (block_d {bd}): {ms['l2_scan']:.3f} ms against "
        f"torch.cdist {library_ms:.3f} ms in this run "
        f"({'faster' if ms['l2_scan'] < library_ms else 'SLOWER'}, "
        f"{library_ms / ms['l2_scan']:.2f}x); the shared-skeleton kernel it replaced "
        f"took {L2_SCAN_BEFORE_MS} ms on an NVIDIA H100 80GB HBM3 at 700.00 W")

    # ---- 11. the flat index ----
    res = {}
    for name, kw in (("fp32", {}), ("use_quant", {"use_quant": True})):
        t0 = time.perf_counter()
        out = search_flat(idx, queries, k=k, wave=svc.wave, **kw)
        sync()
        wall = time.perf_counter() - t0
        ids = out.ids.cpu().numpy()
        rec = sum(len(set(ids[i]) & set(gt[i].tolist())) for i in range(qn)) / (qn * k)
        res[name] = out
        log(f"flat index: search_flat {name} k={k} wave={svc.wave} recall@{k}={rec:.4f} "
            f"avg_dims={float(out.avg_dims):.3f} in {wall:.2f}s")
        check(tuple(out.ids.shape) == (qn, k) and bool(torch.isfinite(out.dists).all()),
              f"search_flat {name} output malformed")
        check(rec >= 0.95, f"search_flat {name} recall@{k} {rec} < 0.95")
    check(torch.equal(res["fp32"].ids, res["use_quant"].ids),
          "search_flat fp32 and use_quant return different ids")

    entries = []
    for name in ("dade_dco", "quant_dco", "l2_scan"):
        ops_s, bytes_s = bounds[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": {"dade_dco": "src/repro/kernels/dade_dco.py:148",
                         "quant_dco": "src/repro/kernels/quant_dco.py:160",
                         "l2_scan": "src/repro/kernels/l2_scan.py:62"}[name],
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": library_ms if name == "l2_scan" else None,
        })
        e = entries[-1]
        log(f"kernels: {name} launches={e['launches']} max_abs_err={e['max_abs_err']:.3e} "
            f"ms={e['ms']:.3f} plain_ms={e['plain_ms']:.1f} bound_ms={e['bound_ms']:.4f} "
            f"({e['bound_by']}) library_ms={e['library_ms']} on {card}")
    log(f"flat screen: pass_rate={screen_stats[0]:.6f} dims_frac={screen_stats[1]:.4f} "
        f"prune_rate={screen_stats[2]:.6f}; {work_s}; "
        f"phases 9-11 took {time.perf_counter() - t_start:.0f}s")
    return entries


def lm_prefill_flops(model, b: int, s: int) -> float:
    """Operations a prefill of ``b`` x ``s`` tokens needs: 2 per token per
    weight of every layer's matrices, QK^T and PV (2 x 2 x head_dim per
    head) over the keys each query attends (causal, inside its window),
    and the last position's logits."""
    cfg = model.cfg
    mats = sum(p.numel() for st in model.stacks for p in st.parameters() if p.ndim == 2)
    flops = 2.0 * mats * b * s
    for w in cfg.layer_windows():
        w = w if 0 < w < s else s
        attended = w * (w + 1) // 2 + (s - w) * w
        flops += 4.0 * b * cfg.n_heads * cfg.hdim * attended
    return flops + 2.0 * b * cfg.d_model * cfg.vocab_padded


def lm_train_flops(model, b: int, s: int) -> float:
    """Operations a training step over ``b`` x ``s`` tokens needs: 3 x the
    forward's (every layer's matrices, QK^T and PV over the attended keys,
    as :func:`lm_prefill_flops`, and the LM head over EVERY token): the
    forward and the backward's two products for each of its products.
    Remat's recomputed forward is not useful work and is not counted."""
    cfg = model.cfg
    head = 2.0 * cfg.d_model * cfg.vocab_padded
    return 3.0 * (lm_prefill_flops(model, b, s) - b * head + b * s * head)


def profiled(fn, top: int = 6):
    """(``fn()``, a line: the card's busy share of that call under
    ``torch.profiler`` and its device time by ATen op (each op's own
    kernels, copies and fills), largest first).  Only ATen ops count: the
    profiler's own markers (a full launch queue, say) carry device time
    too.  The device events are read raw and each is credited to the op
    that launched it (its linked correlation id: the attribution
    ``key_averages`` makes) without building the profiler's Python event
    tree, which took 25 s for a training step's events."""
    from collections import Counter, defaultdict

    import torch
    from torch.autograd import DeviceType
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.profiler.kineto_results.events()
    op_of, calls, dev_ns = {}, Counter(), defaultdict(int)
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name().startswith("aten::"):
            op_of[e.correlation_id()] = e.name()
            calls[e.name()] += 1
    for e in events:
        if e.device_type() != DeviceType.CPU and e.linked_correlation_id() in op_of:
            dev_ns[op_of[e.linked_correlation_id()]] += e.duration_ns()
    busy = sum(dev_ns.values()) / 1e6
    parts = ", ".join(f"{name} {ns / 1e6:.1f} ms ({100 * ns / 1e6 / wall_ms:.1f} %, "
                      f"{calls[name]} calls)"
                      for name, ns in sorted(dev_ns.items(), key=lambda kv: -kv[1])[:top])
    return out, (f"card busy {busy:.1f} of {wall_ms:.1f} ms ({100 * busy / wall_ms:.1f} %); "
                 f"by op: {parts}")


def lm_card_against_cpu(arch: str) -> tuple[float, int]:
    """Phase 16c for one architecture: the same seeded reduced model on the
    CPU and on the card; returns (largest absolute deviation, int8 near-
    ties) over prefill logits, every cache leaf and 4 decode steps."""
    import copy

    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.interop import lm_caches_close
    from repro_torch.models.model import build_model

    cfg = reduced_config(arch)
    cpu = build_model(cfg, seed=1, device="cpu")
    card = copy.deepcopy(cpu).to(DEV)
    g = torch.Generator().manual_seed(2)
    b, s = 2, 64
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((b, cfg.vision_seq, cfg.vision_dim), generator=g)

    def close(ref, got, what):
        nonlocal worst
        got = got.cpu()
        ok = torch.allclose(got, ref, rtol=LM_CARD_TOL, atol=LM_CARD_TOL)
        check(ok, f"lm (c) {arch} {what}: card and CPU differ by "
                  f"{(got - ref).abs().max().item():.3e}")
        worst = max(worst, (got - ref).abs().max().item())

    lc, cc = cpu.prefill(batch)
    lg, cg = card.prefill({k: v.to(DEV) for k, v in batch.items()})
    worst, ties = lm_caches_close(cc, cg, rtol=LM_CARD_TOL, atol=LM_CARD_TOL,
                                  what=f"lm (c) {arch} prefill")
    close(lc, lg, "prefill logits")
    (cc, _), (cg, _) = cpu.init_caches(b, 16), card.init_caches(b, 16)
    for t in range(4):
        tok = batch["tokens"][:, t:t + 1]
        lc, cc = cpu.decode_step(tok, cc, t)
        lg, cg = card.decode_step(tok.to(DEV), cg, torch.tensor(t, device=DEV))
        close(lc, lg, f"decode step {t} logits")
    w, n = lm_caches_close(cc, cg, rtol=LM_CARD_TOL, atol=LM_CARD_TOL,
                           what=f"lm (c) {arch} decode")
    return max(worst, w), ties + n


def run_lm(card: str) -> None:
    """Phase 16: LM serving on the card (no hand-written kernel on this
    path)."""
    import gc

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.launch.specs import SHAPES
    from repro_torch.launch.steps import build_cell, serve_step

    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = 1e9

    # (a) full width, depth cut to LM_LAYERS, bf16
    t0 = time.perf_counter()
    cell = build_cell(LM_ARCH, "prefill_32k", device=DEV, cfgset={"num_layers": LM_LAYERS})
    model, cfg = cell.model, cell.model.cfg
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"lm (a): {LM_ARCH} {cfg.dtype}, {n_params:,} parameters ({param_bytes / gib:.2f} "
        f"GB), {cfg.num_layers} layers run as {len(model.stacks)} stacks (windowed, then "
        f"global), built in {time.perf_counter() - t0:.1f}s on {card}")
    g = torch.Generator(device=DEV).manual_seed(0)
    b, s = LM_PREFILL_BATCH, LM_PREFILL_SEQ
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=DEV,
                                     dtype=torch.int32)}
    _, pre_profile = profiled(lambda: cell.step_fn(batch))  # the warm-up run
    times = []
    for _ in range(LM_PREFILL_RUNS):
        logits = caches = None
        sync()
        t0 = time.perf_counter()
        logits, caches = cell.step_fn(batch)
        sync()
        times.append(time.perf_counter() - t0)
    check(tuple(logits.shape) == (b, cfg.vocab_padded)
          and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "lm (a): prefill logits not finite or of the wrong shape")
    check(all(tuple(c.k.shape) == (cfg.num_layers // 2, b, s, cfg.n_kv_heads, cfg.hdim)
              for c in caches.values()), "lm (a): prefill caches of the wrong shape")
    pre_s = statistics.median(times)
    flops = lm_prefill_flops(model, b, s)
    pre_bound = flops / PEAK_BF16_FLOPS
    log(f"lm (a): prefill {b} x {s} tokens: {pre_s * 1e3:.1f} ms (median of "
        f"{LM_PREFILL_RUNS} runs: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms), "
        f"{b * s / pre_s:,.1f} tokens/s; bound {pre_bound * 1e3:.1f} ms ({flops:.4g} FLOP "
        f"at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense), {pre_s / pre_bound:.2f}x it; "
        f"on {card}")
    log(f"lm (a): prefill, the profiled warm-up run: {pre_profile}")
    logits = caches = None

    spec = SHAPES["decode_32k"]
    db = LM_DECODE_BATCH
    caches, _ = cell.model.init_caches(db, spec.seq)
    cache_bytes = sum(t.numel() * t.element_size() for c in caches.values() for t in c)
    n_steps = LM_DECODE_WARM + LM_DECODE_STEPS
    positions = torch.arange(spec.seq - n_steps, spec.seq, device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (n_steps, db, 1), generator=g, device=DEV,
                           dtype=torch.int32)
    for i in range(LM_DECODE_WARM - 1):
        logits, caches = serve_step(model, tokens[i], caches, positions[i])
    i = LM_DECODE_WARM - 1  # the last warm step, profiled
    (logits, caches), dec_profile = profiled(
        lambda: serve_step(model, tokens[i], caches, positions[i]))
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    ev0.record()
    for i in range(LM_DECODE_WARM, n_steps):
        logits, caches = serve_step(model, tokens[i], caches, positions[i])
    ev1.record()
    sync()
    step_ms = ev0.elapsed_time(ev1) / LM_DECODE_STEPS
    check(tuple(logits.shape) == (db, cfg.vocab_padded)
          and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "lm (a): decode logits not finite or of the wrong shape")
    step_bytes = param_bytes + cache_bytes
    dec_bound_ms = step_bytes / PEAK_BYTES * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"lm (a): decode batch {db} against {spec.seq:,}-token caches ({cache_bytes / gib:.2f} "
        f"GB): {step_ms:.3f} ms a step ({LM_DECODE_STEPS} steps after {LM_DECODE_WARM} warm, "
        f"positions {int(positions[0])}-{int(positions[-1])}), {db / step_ms * 1e3:,.1f} "
        f"tokens/s; bound {dec_bound_ms:.3f} ms ({step_bytes / gib:.2f} GB of weights and "
        f"caches read a step at {PEAK_BYTES / 1e12:.2f} TB/s), {step_ms / dec_bound_ms:.2f}x it; "
        f"on {card}")
    log(f"lm (a): decode, the profiled last warm step: {dec_profile}")
    log(f"lm (a): peak memory {peak / gib:.2f} GB (torch.cuda.max_memory_allocated) of the "
        f"card's {torch.cuda.get_device_properties(0).total_memory / gib:.2f} GB; on {card}")
    del cell, model, logits, caches, tokens, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (b) full width in float32, the window cut so that the ring wraps
    t0 = time.perf_counter()
    cell = build_cell(LM_ARCH, "prefill_32k", device=DEV,
                      cfgset={"dtype": "float32", "sliding_window": LM_CHECK_WINDOW})
    model, cfg = cell.model, cell.model.cfg
    n = LM_CHECK_SEQ
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g, device=DEV)
    p_logits, _ = cell.step_fn({"tokens": toks})
    caches, _ = model.init_caches(1, n)
    check(caches["kv0"].k.shape[2] == LM_CHECK_WINDOW and caches["kv1"].k.shape[2] == n,
          "lm (b): the windowed layers' ring is not the window's length")
    v = cfg.vocab_size
    p_l = p_logits[:, :v]

    def decode_err(caches):
        for t in range(n):
            d_logits, caches = serve_step(model, toks[:, t:t + 1], caches, t)
        d_l = d_logits[:, :v]
        return (p_l - d_l).abs().max().item(), torch.allclose(d_l, p_l, rtol=LM_CHECK_TOL,
                                                              atol=LM_CHECK_TOL)

    err, ok = decode_err(caches)
    check(bool(torch.isfinite(p_l).all()) and ok,
          f"lm (b): decode and prefill logits differ by {err:.3e}")
    # the planted fault: the windowed layers' rings one slot short
    short, _ = model.init_caches(1, n)
    short["kv0"] = type(short["kv0"])(*(torch.zeros_like(t[:, :, 1:]) for t in short["kv0"]))
    fault_err, fault_ok = decode_err(short)
    check(not fault_ok, f"lm (b): a decode with a {LM_CHECK_WINDOW - 1}-slot window passes "
                        f"the check (max |diff| {fault_err:.3e})")
    log(f"lm (b): {LM_ARCH} float32, window {LM_CHECK_WINDOW}: the prefill's last logits of "
        f"a {n}-token prompt against {n} teacher-forced decode steps from zeroed {n}-slot "
        f"caches: max |diff| {err:.3e} (|logit| up to "
        f"{p_l.abs().max().item():.2f}; tolerance rtol = atol = {LM_CHECK_TOL}); the planted "
        f"fault, the windowed rings {LM_CHECK_WINDOW - 1} slots: {fault_err:.3e}; "
        f"{time.perf_counter() - t0:.1f}s")
    del cell, model, caches, short, p_logits
    gc.collect()
    torch.cuda.empty_cache()

    # (c) every architecture at reduced config, card against CPU
    t0 = time.perf_counter()
    worst = {}
    ties = 0
    for arch in LM_ARCHS:
        worst[arch], n_ties = lm_card_against_cpu(arch)
        ties += n_ties
    log(f"lm (c): {len(LM_ARCHS)} architectures at reduced config, card against CPU within "
        f"rtol = atol = {LM_CARD_TOL}: largest |diff| "
        + ", ".join(f"{a} {e:.2e}" for a, e in worst.items())
        + f"; {ties} int8 near-ties; {time.perf_counter() - t0:.1f}s")
    log(f"phase 16 took {time.perf_counter() - t_start:.0f}s on {card}")


def train_card_against_cpu(arch: str) -> float:
    """Phase 17(b) for one architecture: the same seeded reduced model on the
    CPU and on the card; the train step's loss and every gradient leaf,
    then every parameter after one AdamW step, card against CPU.  Returns
    the largest absolute deviation."""
    import copy

    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import train_grads, train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = reduced_config(arch)
    cpu = build_model(cfg, seed=1, device="cpu").requires_grad_(True)
    card = copy.deepcopy(cpu).to(DEV)
    b = 4  # every reduced config's grad_accum (1, 2 or 4) divides it
    batch = TokenPipeline(vocab_size=cfg.vocab_size, batch=b, seq=64, seed=2).batch_at(0)
    g = torch.Generator().manual_seed(3)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((b, cfg.vision_seq, cfg.vision_dim), generator=g)
    worst = 0.0

    def close(ref, got, what):
        nonlocal worst
        ref, got = ref.detach().float(), got.detach().float().cpu()
        err = (got - ref).abs().max().item() if ref.numel() else 0.0
        check(torch.allclose(got, ref, rtol=TRAIN_CARD_TOL, atol=TRAIN_CARD_TOL),
              f"train (b) {arch} {what}: card and CPU differ by {err:.3e}")
        worst = max(worst, err)

    lc, _, gc = train_grads(cpu, batch)
    lg, _, gg = train_grads(card, batch)
    close(lc, lg, "loss")
    for k in gc:
        close(gc[k], gg[k], f"gradient {k}")
    opt = AdamWConfig(lr=TRAIN_CARD_LR, warmup_steps=1, total_steps=10)
    pc, pg = dict(cpu.named_parameters()), dict(card.named_parameters())
    train_step(cpu, opt, pc, adamw_init(pc), batch)
    train_step(card, opt, pg, adamw_init(pg), batch)
    for k in pc:
        close(pc[k], pg[k], f"parameter {k} after one step")
    return worst


def train_identities(first: dict, b: int, s: int) -> None:
    """Phase 17(b): the float32 identities at full width, each beside its
    planted fault, then every reduced architecture card against CPU."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.launch.steps import build_cell, train_grads

    t0 = time.perf_counter()
    cell = build_cell(TRAIN_ARCH, "train_4k", device=DEV,
                      cfgset={"num_layers": TRAIN_CHECK_LAYERS, "dtype": "float32"})
    model, cfg = cell.model, cell.model.cfg

    def with_cfg(**kw):  # the blocks read the config from the model at each call
        model.cfg = dataclasses.replace(cfg, **kw)

    def diff(x, y):
        return max((x[k] - y[k]).abs().max().item() for k in x)

    def all_close(x, y, rtol, atol):
        return all(torch.allclose(x[k], y[k], rtol=rtol, atol=atol) for k in x)

    _, _, g2 = train_grads(model, first)  # grad_accum 2, remat
    with_cfg(grad_accum=1)
    _, _, g1 = train_grads(model, first)
    acc_err = diff(g2, g1)
    check(all_close(g2, g1, TRAIN_ACCUM_RTOL, TRAIN_ACCUM_ATOL),
          f"train (b): grad_accum 2 and 1 differ by {acc_err:.3e}")
    undivided = {k: v * 2 for k, v in g2.items()}
    check(not all_close(undivided, g1, TRAIN_ACCUM_RTOL, TRAIN_ACCUM_ATOL),
          "train (b): gradients not divided by grad_accum pass the check")
    acc_fault = diff(undivided, g1)
    del g1, undivided
    with_cfg(remat=False)  # grad_accum 2 again, no remat
    _, _, g2n = train_grads(model, first)
    remat_err = diff(g2, g2n)
    check(all_close(g2, g2n, TRAIN_REMAT_TOL, TRAIN_REMAT_TOL),
          f"train (b): remat on and off differ by {remat_err:.3e}")
    del g2, g2n
    # the planted fault: a weight moved between the forward and its
    # recomputation (one microbatch, remat on)
    with_cfg(grad_accum=1)
    mb = {k: torch.as_tensor(v[:b // 2], device=DEV) for k, v in first.items()}
    _, _, clean = train_grads(model, mb)
    own = dict(model.named_parameters())
    loss, _ = model.loss_fn(mb)
    w = own["stacks.0.0.mlp.w_up"]
    saved = w.detach().clone()
    with torch.no_grad():
        w.mul_(1.01)
    moved = dict(zip(own, torch.autograd.grad(loss, list(own.values()), allow_unused=True)))
    with torch.no_grad():
        w.copy_(saved)
    moved = {k: torch.zeros_like(own[k]) if v is None else v for k, v in moved.items()}
    remat_fault = diff(moved, clean)
    check(not all_close(moved, clean, TRAIN_REMAT_TOL, TRAIN_REMAT_TOL),
          "train (b): a recomputation with moved weights passes the remat check")
    log(f"train (b): {TRAIN_ARCH} float32 at full width, {TRAIN_CHECK_LAYERS} layers, "
        f"{b} x {s} tokens: grad_accum 2 against 1 max |diff| {acc_err:.3e} (rtol "
        f"{TRAIN_ACCUM_RTOL}, atol {TRAIN_ACCUM_ATOL}; the planted fault, gradients not "
        f"divided by 2: {acc_fault:.3e}); remat on against off {remat_err:.3e} (tolerance "
        f"{TRAIN_REMAT_TOL}; the planted fault, a weight moved 1 % between the forward and "
        f"its recomputation: {remat_fault:.3e}); {time.perf_counter() - t0:.1f}s")
    del cell, model, clean, moved, loss, own, saved
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst = {arch: train_card_against_cpu(arch) for arch in LM_ARCHS}
    log(f"train (b): {len(LM_ARCHS)} architectures at reduced config, the train step card "
        f"against CPU within rtol = atol = {TRAIN_CARD_TOL} (loss, every gradient leaf, every "
        f"parameter after one step at lr {TRAIN_CARD_LR}): largest |diff| "
        + ", ".join(f"{a} {e:.2e}" for a, e in worst.items())
        + f"; {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()


def start_dp_drill(tmp: str) -> subprocess.Popen:
    """Phase 18(c)'s trainer drill, started beside phase 17(b)-(c) (which
    are not timed) so that the script stays inside its limit; its
    checkpoints go under ``tmp/drill``.  (Phase 18's ranks start later:
    started here too, their (b) slowed 17(b)-(c) and the drill by more
    than it saved.)"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *DP_DRILL_ARGS,
         "--ckpt-dir", os.path.join(tmp, "drill")], env=env, cwd=tmp,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run_train(card: str, dp_tmp: str, started: list, launch: dict) -> tuple:
    """Phase 17: LM training on the card (no hand-written kernel on this
    path), and phase 19(b) on its model (``launch``: the launch tooling's
    background runs).  Starts phase 18's drill once 17(a) is timed,
    appending it to ``started`` (the caller stops it).  Returns (the
    uninterrupted trainer's p50 a step (17(c)), the drill's start)."""
    import gc
    import re
    import tempfile

    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.specs import SHAPES
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = 1e9

    # (a) gemma-2b at full width and depth, bf16, remat, grad_accum 2
    t0 = time.perf_counter()
    n_steps = TRAIN_WARM + TRAIN_STEPS + 1  # the last one profiled
    cell = build_cell(TRAIN_ARCH, "train_4k", device=DEV,
                      opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=n_steps))
    model, cfg = cell.model, cell.model.cfg
    check(cfg.remat and cfg.grad_accum == 2 and cfg.dtype == "bfloat16",
          f"train (a): {TRAIN_ARCH}'s config is not bf16 with remat and grad_accum 2")
    params = dict(model.named_parameters())
    opt_state = adamw_init(params)
    n_params = sum(p.numel() for p in params.values())
    state_bytes = sum(p.numel() * p.element_size() for p in params.values()) + sum(
        t.numel() * t.element_size() for m in ("m", "v") for t in opt_state[m].values())
    sync()
    s = SHAPES["train_4k"].seq
    b = TRAIN_BATCH
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=b, seq=s, seed=0)
    log(f"train (a): {TRAIN_ARCH} {cfg.dtype}, {n_params:,} parameters, {cfg.num_layers} "
        f"layers, remat, grad_accum {cfg.grad_accum}, AdamW at lr {TRAIN_LR}; parameters and moments "
        f"{state_bytes / gib:.2f} GB; built in {time.perf_counter() - t0:.1f}s on {card}")
    losses, norms, times = [], [], []
    profile = ""
    for i in range(n_steps):
        batch = pipe.batch_at(i)
        sync()
        t0 = time.perf_counter()
        if i < n_steps - 1:
            params, opt_state, mets = cell.step_fn(params, opt_state, batch)
            sync()
        else:
            (params, opt_state, mets), profile = profiled(
                lambda: cell.step_fn(params, opt_state, batch))
        times.append(time.perf_counter() - t0)
        losses.append(float(mets["loss"]))
        norms.append(float(mets["grad_norm"]))
    check(all(map(math.isfinite, losses + norms)),
          f"train (a): a loss or grad_norm is not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"train (a): the loss did not fall: {losses}")
    timed = times[TRAIN_WARM:TRAIN_WARM + TRAIN_STEPS]
    step_s = statistics.median(timed)
    flops = lm_train_flops(model, b, s)
    bound = flops / PEAK_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    log(f"train (a): {b} x {s} tokens a step: {step_s * 1e3:.1f} ms (median of {TRAIN_STEPS} "
        f"steps after {TRAIN_WARM} warm-up: {', '.join(f'{t * 1e3:.1f}' for t in timed)} ms; "
        f"the warm-up {times[0] * 1e3:.1f} ms), {b * s / step_s:,.1f} tokens/s; bound "
        f"{bound * 1e3:.1f} ms ({flops:.4g} FLOP at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 "
        f"dense), {step_s / bound:.2f}x it; on {card}")
    log(f"train (a): loss by step {', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
        f"{', '.join(f'{x:.3f}' for x in norms)}")
    log(f"train (a): the profiled step ({times[-1] * 1e3:.1f} ms): {profile}")
    log(f"train (a): peak memory {peak / gib:.2f} GB (torch.cuda.max_memory_allocated) of the "
        f"card's {torch.cuda.get_device_properties(0).total_memory / gib:.2f} GB; on {card}")
    census_train(cell, params, opt_state, pipe.batch_at(n_steps), step_s, flops, launch, card)
    first = pipe.batch_at(0)
    del cell, model, params, opt_state, mets
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the trainer drill's two runs start here and load while (b) runs
    # (only (a) is timed); so does phase 18's drill
    t_dp = time.perf_counter()
    started.append(start_dp_drill(dp_tmp))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        runs = {}
        try:
            for name, extra in (("drill", ["--fail-at", str(DRILL_FAIL_AT)]), ("clean", [])):
                cmd = [sys.executable, "-m", "repro_torch.launch.train", *DRILL_ARGS, *extra,
                       "--ckpt-dir", os.path.join(tmp, name)]
                runs[name] = subprocess.Popen(cmd, env=env, cwd=tmp, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True)
            train_identities(first, b, s)
            outs = {name: proc.communicate(timeout=300)[0] for name, proc in runs.items()}
        finally:
            for proc in runs.values():
                proc.kill()
                proc.wait()
        for name, proc in runs.items():
            check(proc.returncode == 0, f"train (c): the {name} run failed "
                                        f"(rc {proc.returncode}): {outs[name][-2000:]}")
        restarts = {n: int(re.search(r"restarts=(\d+)", o).group(1)) for n, o in outs.items()}
        check(restarts == {"drill": 1, "clean": 0}, f"train (c): restarts {restarts}")
        trees = {n: json.loads((Path(tmp) / n / "step_000000040" / "tree.json").read_text())
                 for n in outs}
        check(trees["drill"]["leaves"] == trees["clean"]["leaves"],
              "train (c): the restarted run's step-40 state differs from the "
              "uninterrupted run's")
        loss_line = re.search(r"\[loss\][^\n]*", outs["drill"]).group(0)
        p50 = {n: re.search(r"p50=(\S+)", o).group(1) for n, o in outs.items()}
    log(f"train (c): launch.train --arch mamba2-130m (full width) 40 steps of 8 x 128, "
        f"a failure at step {DRILL_FAIL_AT}: restarts=1, {loss_line}, p50 {p50['drill']} "
        f"a step ({p50['clean']} uninterrupted; the two runs share the card with phase 18's "
        f"drill); its step-40 "
        f"checkpoint equals the uninterrupted run's bit for bit "
        f"({len(trees['drill']['leaves'])} leaves' sha256, --deterministic); (b) and (c) "
        f"{time.perf_counter() - t0:.1f}s")
    log(f"phase 17 took {time.perf_counter() - t_start:.0f}s on {card}")
    return p50["clean"], t_dp


def start_launch_tooling(tmp: str) -> dict:
    """Phase 19's background runs, started at phase 1 beside the card
    phases (niced, one torch thread each): the dry run of every cell on
    both production layouts into ``tmp/dryrun``, gemma-2b's train_4k
    step on meta at TRAIN_BATCH rows (``launch.perf``) into ``tmp``, and
    phase 20(a)'s rank step counted on meta (:func:`tp_meta_count`)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = {"results": os.path.join(tmp, "dryrun"), "meta_json": os.path.join(tmp, "meta.json"),
           "t0": time.perf_counter()}
    out["tp_meta_json"] = os.path.join(tmp, "tp_meta.json")
    cmds = {"dryrun": ["-m", "repro_torch.launch.dryrun", "--jobs", str(DRYRUN_JOBS),
                       "--results", out["results"]],
            "meta": ["-m", "repro_torch.launch.perf", "--arch", TRAIN_ARCH, "--shape",
                     "train_4k", "--rows", str(TRAIN_BATCH), "--json", out["meta_json"]],
            "tp_meta": ["-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import "
                              f"chip_smoke; chip_smoke.tp_meta_count({out['tp_meta_json']!r})"]}
    for name, cmd in cmds.items():
        log_f = open(os.path.join(tmp, f"{name}.log"), "w")
        out[name] = subprocess.Popen([sys.executable, *cmd], env=env, cwd=tmp, stdout=log_f,
                                     stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))
        out[f"{name}_log"] = log_f.name
    return out


def tp_meta_count(path: str) -> None:
    """Phase 20(a)'s train step counted on meta, written to ``path`` as
    JSON: one (data=1, model=TP_RANKS) rank's step of TP_ARCH's train_4k
    cell at TP_TRAIN (rows, seq) tokens, as the dry run counts a record's
    temp bytes (``dryrun.rank_step``'s census peak plus the rank's model
    pieces whole along "data", ``dryrun.model_piece_bytes``)."""
    import torch
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    mesh = AbstractMesh((1, TP_RANKS), ("data", "model"))
    cell = build_cell(TP_ARCH, "train_4k", mesh=mesh, device="meta")
    params, opt_state, batch = cell.args
    cell.args = (params, opt_state, {k: torch.empty(TP_TRAIN, dtype=v.dtype, device="meta")
                                     for k, v in batch.items()})
    rank, _ = dryrun.rank_step(cell, mesh)
    pieces = dryrun.model_piece_bytes(cell, mesh)
    Path(path).write_text(json.dumps({"peak_bytes": rank["peak_bytes"], "pieces": pieces,
                                      "temp_bytes": rank["peak_bytes"] + pieces,
                                      "s": time.perf_counter() - t0}))


def _finished(launch: dict, name: str, timeout: float) -> str:
    """Wait for background run ``name``; its output (it must succeed)."""
    proc = launch[name]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    text = Path(launch[f"{name}_log"]).read_text()
    check(proc.returncode == 0, f"launch {name}: rc {proc.returncode}: {text[-3000:]}")
    return text


def census_train(cell, params, opt_state, batch, step_s: float, useful: float,
                 launch: dict, card: str) -> None:
    """Phase 19(b): one more train step of phase 17(a)'s gemma-2b under
    ``op_census`` on the card, against the same cell's census on meta at
    the same rows (the background ``perf`` run): FLOPs equal exactly; the
    bytes side by side with the ops whose bytes differ; the census's FLOPs
    beside ``lm_train_flops``; the one-card roofline bound (compute and
    memory terms at the H100's data-sheet constants) beside 17(a)'s
    measured step; the allocator's peak beside the census's."""
    import torch
    from repro_torch.launch import perf

    t0 = time.perf_counter()
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    res = perf.run(TRAIN_ARCH, "train_4k", device=DEV, cell=cell,
                   args=(params, opt_state, batch), quiet=True)
    card_s = time.perf_counter() - t0
    _finished(launch, "meta", 600)
    meta = json.loads(Path(launch["meta_json"]).read_text())
    cen, mcen = res["census"], meta["census"]
    check(cen["flops"] == mcen["flops"],
          f"launch census (b): {TRAIN_ARCH}'s FLOPs on the card {cen['flops']} != on meta "
          f"{mcen['flops']}")
    diff = sorted(((k, cen["by_op"].get(k, {}).get("bytes", 0),
                    mcen["by_op"].get(k, {}).get("bytes", 0))
                   for k in set(cen["by_op"]) | set(mcen["by_op"])
                   if cen["by_op"].get(k) != mcen["by_op"].get(k)),
                  key=lambda r: -abs(r[1] - r[2]))
    ops = "; ".join(f"{k} {a:.4g} / {b:.4g} B" for k, a, b in diff[:6]) or "none"
    t = res["terms"]
    bound = max(t["compute"], t["memory"])
    PHASE19_S["b"] = time.perf_counter() - t0
    log(f"launch census (b): {TRAIN_ARCH} train_4k at {TRAIN_BATCH} rows, one step under "
        f"the census on the card ({card_s:.1f}s) and on meta: {cen['flops']:.6g} FLOP on both "
        f"({', '.join(f'{k} {v:.4g}' for k, v in cen['flops_by_class'].items())}), "
        f"{cen['flops'] / useful:.4f}x lm_train_flops (remat's recomputed forward); bytes "
        f"{cen['bytes']:.6g} (card) / {mcen['bytes']:.6g} (meta) in {len(cen['by_op'])} / "
        f"{len(mcen['by_op'])} ops; ops whose counts differ (card / meta): {ops}")
    log(f"launch census (b): one-card roofline at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 "
        f"and {PEAK_BYTES / 1e12:.2f} TB/s (data-sheet counts): compute "
        f"{t['compute'] * 1e3:.1f} ms, memory {t['memory'] * 1e3:.1f} ms, bound "
        f"{bound * 1e3:.1f} ms against 17(a)'s measured {step_s * 1e3:.1f} ms a step "
        f"({step_s / bound:.2f}x); torch.cuda.max_memory_allocated "
        f"{res['max_memory_allocated'] / 1e9:.2f} GB against the census's peak "
        f"{cen['peak_bytes'] / 1e9:.2f} GB of tensors the step allocated (meta "
        f"{mcen['peak_bytes'] / 1e9:.2f} GB); on {card}")


def collect_dryrun(launch: dict, card: str) -> None:
    """Phase 19(a): the background dry run's records: none an error, the
    skips the reference's (long_500k for each full-attention architecture,
    its words), every ``argument_bytes`` the sum of ``spec_bytes`` of the
    cell's in_shardings (recomputed here), then ``roofline --md`` and
    ``report`` over them."""
    import io

    from repro_torch.configs import LM_ARCHS, get_config
    from repro_torch.configs.dade_ivf import CONFIG
    from repro_torch.distributed.sharding import Sharding, spec_bytes
    from repro_torch.launch import annservice, report, roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import SHAPES, cell_is_runnable
    from repro_torch.launch.steps import build_cell

    text = _finished(launch, "dryrun", 900)
    t0 = time.perf_counter()
    wall = next(ln for ln in reversed(text.splitlines()) if ln.startswith("Dry-run complete"))

    def pairs(tensors, shardings):
        if isinstance(shardings, Sharding):
            return [(tensors, shardings)]
        if isinstance(shardings, dict):
            return [p for k in shardings for p in pairs(tensors[k], shardings[k])]
        return [p for t, sh in zip(tensors, shardings) for p in pairs(t, sh)]

    big, n = [], 0
    for name, multi in (("pod16x16", False), ("pod2x16x16", True)):
        mesh = make_production_mesh(multi_pod=multi)
        recs = {(r["arch"], r["shape"]): r
                for r in roofline.load_records(name, launch["results"])}
        want = {(a, s) for a in LM_ARCHS for s in SHAPES} | {("dade-ivf", "search_1m")}
        check(set(recs) == want, f"dry run {name}: records for {sorted(set(recs) ^ want)}")
        for (arch, shape), rec in recs.items():
            check(rec["status"] != "error", f"dry run {name} {arch} {shape}: {rec.get('error')}")
            if arch == "dade-ivf":
                devices = mesh.size()
                args_b = sum(math.prod(sp.shape) * sp.dtype.itemsize
                             // (devices if sp.placements[0].is_shard() else 1)
                             for sp in annservice.search_input_specs(CONFIG, mesh,
                                                                     quant="int8", fused=True))
            else:
                ok, why = cell_is_runnable(get_config(arch), shape)
                check(rec["status"] == ("ok" if ok else "skipped")
                      and rec.get("reason", "") == why,
                      f"dry run {name} {arch} {shape}: {rec['status']} "
                      f"{rec.get('reason')!r}, the reference's rule says {ok} {why!r}")
                if not ok:
                    continue
                cell = build_cell(arch, shape, mesh=mesh, device="meta")
                args = cell.args if cell.kind == "train" else (
                    dict(cell.model.named_parameters()), *cell.args)
                args_b = sum(spec_bytes(t, sh.spec, mesh)
                             for t, sh in pairs(args, cell.in_shardings))
            if arch == "dade-ivf":
                # the least work on meta of phase 19(c)'s step, at its shapes
                least, got = rec["census"]["kernels"]["ivf_scan"], CENSUS_FLAT
                check((CONFIG.query_batch, CONFIG.corpus_per_device, CONFIG.dim)
                      == got["shape"]
                      and least["ops_by_class"]["int8"] <= got["ops_by_class"]["int8"]
                      and least["bytes"] <= got["bytes"],
                      f"dry run {name}: ivf_scan's least work on meta {least} exceeds the "
                      f"card's {got}")
            m = rec["memory"]
            check(m["argument_bytes"] == args_b,
                  f"dry run {name} {arch} {shape}: argument_bytes {m['argument_bytes']} != "
                  f"the sum of spec_bytes {args_b}")
            n += 1
            if rec.get("kind") == "train" and m["argument_bytes"] + m["temp_bytes"] > 80e9:
                big.append(f"{name} {arch} {shape} "
                           f"{(m['argument_bytes'] + m['temp_bytes']) / 1e9:.1f} GB")
    tables = io.StringIO()
    with contextlib.redirect_stdout(tables):
        roofline.main(["--md", "--results", launch["results"]])
        report.main(["--results", launch["results"]])
    PHASE19_S["a"] = time.perf_counter() - t0
    least = roofline.load_records("pod16x16", launch["results"])
    least = next(r for r in least if r["arch"] == "dade-ivf")["census"]["kernels"]["ivf_scan"]
    log(f"launch dry run (a): {wall} ({n} records ok, the 12 long_500k skips the "
        f"reference's; every argument_bytes the sum of spec_bytes; ivf_scan's least work on "
        f"meta {least['ops_by_class']['int8']:.6g} int8 ops and {least['bytes']:.6g} B, "
        f"at most 19(c)'s {CENSUS_FLAT['ops_by_class']['int8']:.6g} and "
        f"{CENSUS_FLAT['bytes']:.6g}); train cells whose (data, model) rank's argument + "
        f"temp bytes exceed the card's 80 GB: {'; '.join(big) or 'none'}; these are counts at "
        f"data-sheet constants, not measurements; checked in {PHASE19_S['a']:.1f}s")
    log("launch dry run (a): roofline --md over pod16x16 at the H100's data-sheet "
        "constants:\n" + tables.getvalue().split("\n## Dry-run")[0].strip())


def _dp_batch(cfg, b: int, s: int, seed: int) -> dict:
    """A seeded global batch (``TokenPipeline``, + the stub modality inputs)."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline

    batch = TokenPipeline(vocab_size=cfg.vocab_size, batch=b, seq=s, seed=seed).batch_at(0)
    g = torch.Generator().manual_seed(seed + 1)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((b, cfg.vision_seq, cfg.vision_dim), generator=g)
    return batch


def _dp_identity(model, cfg_name: str, dp, batch, opt) -> dict:
    """Phase 18(b) for one model: the 2-rank step against the one-process
    step on the same card (loss, aux, every gradient leaf, the parameters
    after one AdamW step), and the planted fault of undivided gradients.
    Returns the largest deviations."""
    import torch
    from repro_torch.launch.steps import train_grads, train_step
    from repro_torch.optim.adamw import adamw_init

    def close(x, y):
        return torch.allclose(x, y, rtol=TRAIN_ACCUM_RTOL, atol=TRAIN_ACCUM_ATOL)

    l_dp, m_dp, g_dp = train_grads(model, batch, dp)
    l_one, m_one, g_one = train_grads(model, batch)
    err = {"loss": abs(float(l_dp) - float(l_one)), "aux": abs(float(m_dp["aux"])
                                                               - float(m_one["aux"]))}
    check(close(l_dp, l_one) and close(m_dp["aux"], m_one["aux"]),
          f"dp (b) {cfg_name}: loss or aux differ: {err}")
    bad = [k for k in g_one if not close(g_dp[k], g_one[k].float())]
    err["grad"] = max((g_dp[k] - g_one[k].float()).abs().max().item() for k in g_one)
    check(not bad, f"dp (b) {cfg_name}: gradients differ ({bad[:3]}, max {err['grad']:.3e})")
    undivided = [k for k in g_one if not close(g_dp[k] * dp.size, g_one[k].float())]
    check(bool(undivided), f"dp (b) {cfg_name}: gradients summed, not divided by "
                           f"{dp.size}, pass the check")
    err["fault"] = max((g_dp[k] * dp.size - g_one[k].float()).abs().max().item() for k in g_one)
    del g_dp, g_one
    local = dp.local_params(model)
    one = {k: v.detach().clone() for k, v in model.named_parameters()}
    own = dict(model.named_parameters())
    local, _, _ = train_step(model, opt, local, adamw_init(local), batch, dp=dp)
    full = {k: gather(v, dp.shardings[k]) for k, v in local.items()}
    train_step(model, opt, one, adamw_init(one), batch)
    model.bind_params(own)  # the model computes with its own tensors again
    bad = [k for k in one if not close(full[k].float(), one[k].float())]
    err["param"] = max((full[k].float() - one[k].float()).abs().max().item() for k in one)
    check(not bad, f"dp (b) {cfg_name}: parameters after a step differ ({bad[:3]})")
    return err


def gather(x, sh):
    from repro_torch.distributed.collectives import gather_sharded
    return gather_sharded(x, sh.spec, sh.mesh)


def dp_train_rank(rank, world, dev, tmp):
    """Phase 18 on one rank (spawned; the card shared over gloo): (b) the
    identities, beside the parent's trainer drill; once the drill is done
    and the parent has written ``tmp/one`` (marker ``tmp/one_ready``), (a)
    the timed steps, alone on the card, then (c)'s restore of that
    one-process checkpoint onto the ranks.  Returns what the parent logs."""
    import dataclasses
    import hashlib

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager, to_host
    from repro_torch.configs import LM_ARCHS, get_config, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import spec_bytes, tree_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import DataParallel, build_cell, compress_grads, train_grads
    from repro_torch.models.common import DataShare
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(world, 1)
    out = {"device": str(dev)}

    # (b) the identities: mamba2-130m at full width, DP_CHECK_LAYERS layers, float32
    opt = AdamWConfig(lr=TRAIN_CARD_LR, warmup_steps=1, total_steps=10)
    cfg = dataclasses.replace(get_config(DP_ARCH), num_layers=DP_CHECK_LAYERS, dtype="float32")
    model = build_model(cfg, device=dev).requires_grad_(True)
    dp = DataParallel(mesh, tree_shardings(model.param_axes(), dict(model.named_parameters()),
                                           mesh))
    batch = _dp_batch(cfg, DP_BATCH, DP_SEQ, seed=5)
    errs = {f"{DP_ARCH} x{DP_CHECK_LAYERS}": _dp_identity(model, DP_ARCH, dp, batch, opt)}
    # the compressed all-reduce: identical on every rank, mean + new_e = g + e
    _, _, g = train_grads(model, batch, dp)
    e = {k: torch.zeros_like(v) for k, v in g.items()}
    recon = 0.0
    digests = []
    for _ in range(2):  # from a zero error buffer, then from the residual it left
        mean, new_e = compress_grads(g, e, dp.stripes)
        recon = max(recon, max((mean[k] + new_e[k] - (g[k] + e[k])).abs().max().item()
                               for k in g))
        digests.append(hashlib.sha256(b"".join(to_host(mean[k]).tobytes()
                                               for k in sorted(mean))).hexdigest())
        e = new_e
    check(recon <= DP_RECON_TOL, f"dp (b): mean + new_e misses g + e by {recon:.3e}")
    seen = [None] * world
    dist.all_gather_object(seen, digests)
    check(all(d == seen[0] for d in seen), "dp (b): the ranks' compressed gradients differ")
    out["recon"], out["gmax"] = recon, max(v.abs().max().item() for v in g.values())
    del model, dp, g, e, mean, new_e
    torch.cuda.empty_cache()
    for arch in LM_ARCHS:
        cfg = reduced_config(arch)
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, grad_accum=2)
        model = build_model(cfg, seed=1, device=dev).requires_grad_(True)
        dp = DataParallel(mesh, tree_shardings(model.param_axes(),
                                               dict(model.named_parameters()), mesh))
        batch = _dp_batch(cfg, DP_BATCH, 64, seed=2)
        errs[arch] = _dp_identity(model, arch, dp, batch, opt)
        if cfg.family == "moe" and "aux_fault" not in out:
            # the planted fault: each rank's aux from its own counts
            _, m_one, _ = train_grads(model, batch)
            dp.share = DataShare(dp.size, lambda t: t)
            _, m_bad, _ = train_grads(model, batch, dp)
            fault = abs(float(m_bad["aux"]) - float(m_one["aux"]))
            check(not torch.allclose(m_bad["aux"], m_one["aux"], rtol=TRAIN_ACCUM_RTOL,
                                     atol=TRAIN_ACCUM_ATOL),
                  f"dp (b) {arch}: an aux from rank-local counts passes the check")
            out["aux_fault"] = (arch, fault)
        del model, dp
    out["errs"] = errs

    # the trainer drill runs beside (b); (a) is timed once it is done and
    # the parent has written its one-process checkpoint
    deadline = time.monotonic() + 600
    while not (Path(tmp) / "one_ready").exists():
        check(time.monotonic() < deadline, "dp (c): the one-process checkpoint never came")
        time.sleep(0.5)
    torch.cuda.empty_cache()
    dist.barrier()

    # (a) the full-width model, plain then --grad-compress
    n = DP_WARM + DP_STEPS
    cell = build_cell(DP_ARCH, "train_4k", mesh=mesh, device=dev,
                      opt=AdamWConfig(lr=DP_LR, warmup_steps=1, total_steps=2 * n))
    model, dp = cell.model, cell.data_parallel
    dp.traffic.clock = True  # the collectives' share of a step
    cfg = model.cfg
    full = dict(model.named_parameters())
    out["params"] = sum(p.numel() for p in full.values())
    out["dtype"] = str(cfg.param_dtype).replace("torch.", "")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=DP_BATCH, seq=DP_SEQ, seed=0)
    for mode in ("plain", "compress"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = dp.local_params(model)
        opt_state = adamw_init(params)
        ebuf = ({k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for k, p in full.items()} if mode == "compress" else None)
        state_bytes = sum(spec_bytes(p, dp.shardings[k].spec, mesh) for k, p in full.items()) \
            + 2 * sum(spec_bytes(torch.empty(p.shape, device="meta"), dp.shardings[k].spec, mesh)
                      for k, p in full.items()) \
            + (0 if ebuf is None else sum(e.numel() * 4 for e in ebuf.values()))
        times, losses, shares, kinds = [], [], [], []
        for i in range(n):
            batch = pipe.batch_at(i)
            dp.traffic.reset()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt_state, mets = cell.step_fn(params, opt_state, batch, ebuf=ebuf)
            torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            losses.append(float(mets["loss"]))
            if i >= DP_WARM:
                times.append(dt)
                shares.append(sum(dp.traffic.seconds.values()) / dt)
                kinds.append((dict(dp.traffic.bytes), dict(dp.traffic.seconds)))
        check(all(map(math.isfinite, losses)), f"dp (a) {mode}: a loss is not finite: {losses}")
        out[mode] = dict(ms=[t * 1e3 for t in times], losses=losses, share=shares,
                         kinds=kinds[len(kinds) // 2], peak=torch.cuda.max_memory_allocated(dev),
                         state_bytes=state_bytes)
        del params, opt_state, ebuf
    del cell, model, dp, full
    torch.cuda.empty_cache()

    # (c) the parent's one-process checkpoint, restored onto the ranks
    model = build_model(get_config(DP_ARCH), device=dev)
    full = dict(model.named_parameters())
    ebuf = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in full.items()}
    dp = DataParallel(mesh, tree_shardings(model.param_axes(), full, mesh))
    params = dp.local_params(model)
    shardings = dp.state_shardings(model, ebuf)
    t0 = time.perf_counter()
    state = CheckpointManager(str(Path(tmp) / "one"), async_save=False).restore(
        DP_DRILL_STEP, (params, adamw_init(params), ebuf), shardings=shardings)
    out["restore_s"] = time.perf_counter() - t0
    # written again from the ranks' pieces (gathered; rank 0 writes): the
    # parent holds its leaves' sha256 against the one-process checkpoint's
    CheckpointManager(str(Path(tmp) / "two"), async_save=False).save(
        DP_DRILL_STEP, state, shardings=shardings)
    out["piece_shapes"] = {k: tuple(state[0][k].shape) for k in ("tok_embed",)}
    return out


def run_train_dp(card: str, one_process_p50: str, drill, t_drill: float, tmp: str) -> None:
    """Phase 18: multi-device LM training, two ranks sharing the card over
    gloo (no hand-written kernel on this path).  The trainer ``drill`` (c),
    started at ``t_drill`` beside phase 17(b)-(c) with its checkpoints under
    ``tmp``, runs on beside the ranks' (b); once it is done and its
    checkpoint restored here, the ranks time (a), alone on the card, then
    restore this process's checkpoint (c)."""
    import gc
    import hashlib
    import re

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.fault_tolerance import elastic_restore

    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mb = 1e6
    procs = spawn(dp_train_rank, DP_RANKS, backend="gloo", args=(tmp,), device=DEV,
                  init_file=os.path.join(tmp, "init"))
    try:
        drill_out = drill.communicate(timeout=600)[0]
        drill_s = time.perf_counter() - t_drill
        check(drill.returncode == 0, f"dp (c): the drill failed (rc {drill.returncode}): "
                                     f"{drill_out[-2000:]}")
        restarts = int(re.search(r"restarts=(\d+)", drill_out).group(1))
        check(restarts == 1, f"dp (c): restarts={restarts}")
        # the step-20 checkpoint the two ranks wrote, restored in one process
        t0 = time.perf_counter()
        model = build_model(get_config(DP_ARCH), device=DEV)
        full = {k: v.detach() for k, v in model.named_parameters()}
        zeros = {k: torch.zeros(v.shape, dtype=torch.float32, device=DEV)
                 for k, v in full.items()}
        two = CheckpointManager(os.path.join(tmp, "drill"))
        state = elastic_restore(two, DP_DRILL_STEP, (full, adamw_init(full), zeros), None)
        one_s = time.perf_counter() - t0
        CheckpointManager(os.path.join(tmp, "one"), async_save=False).save(
            DP_DRILL_STEP, state)
        del model, full, zeros, state
        torch.cuda.empty_cache()
        (Path(tmp) / "one_ready").touch()
        out = procs.join(timeout_s=900)
    finally:
        procs.terminate()

    def shas(d):
        meta = json.loads((Path(tmp) / d / f"step_{DP_DRILL_STEP:09d}" / "tree.json")
                          .read_text())
        return [leaf["sha256"] for leaf in meta["leaves"]]

    drill_sha, one_sha, two_sha = shas("drill"), shas("one"), shas("two")
    check(one_sha == drill_sha, "dp (c): the one-process restore of the 2-rank "
                                "checkpoint differs from its leaves")
    check(two_sha == one_sha, "dp (c): the 2-rank restore of the one-process "
                              "checkpoint differs from its leaves")
    digest = hashlib.sha256("".join(drill_sha).encode()).hexdigest()[:12]
    r0 = out[0]
    log(f"dp: {DP_RANKS} ranks on {r0['device']} over gloo (host-staged; the protocol, not "
        f"NVLink): {DP_ARCH} {r0['dtype']} at full width, {r0['params']:,} parameters, "
        f"{DP_BATCH} x {DP_SEQ} tokens a step, lr {DP_LR}")
    for mode in ("plain", "compress"):
        for r in sorted(out):
            a = out[r][mode]
            step_ms = statistics.median(a["ms"])
            b, sec = a["kinds"]
            kinds = ", ".join(f"{k} {b[k] / mb:.1f} MB {sec[k] * 1e3:.1f} ms" for k in sorted(b))
            log(f"dp (a) {mode} rank {r}: {step_ms:.1f} ms a step (median of {DP_STEPS} after "
                f"{DP_WARM} warm-up: {', '.join(f'{t:.1f}' for t in a['ms'])} ms; phase 17(c)'s "
                f"one-process trainer at 8 x 128: p50 {one_process_p50} in this run beside "
                f"this phase's drill); "
                f"collectives {100 * statistics.median(a['share']):.1f} % of the step "
                f"(the median step's: {kinds}); peak memory {a['peak'] / 1e9:.2f} GB "
                f"(spec_bytes of its state {a['state_bytes'] / 1e9:.3f} GB); loss "
                f"{', '.join(f'{x:.4f}' for x in a['losses'])}; on {card}")
    errs = r0["errs"]
    worst = {k: max(v["grad"], v["param"], v["loss"], v["aux"]) for k, v in errs.items()}
    first = next(iter(errs))
    log(f"dp (b): the 2-rank step against the one-process step within rtol "
        f"{TRAIN_ACCUM_RTOL}, atol {TRAIN_ACCUM_ATOL} (loss, aux, every gradient leaf, every "
        f"parameter after one step at lr {TRAIN_CARD_LR}), largest |diff|: "
        + ", ".join(f"{a} {e:.2e}" for a, e in worst.items())
        + f"; planted faults: the summed gradients not divided by {DP_RANKS} "
        f"{errs[first]['fault']:.3e} ({first}), aux from rank-local counts "
        f"{r0['aux_fault'][1]:.3e} ({r0['aux_fault'][0]}), both failing the check; the "
        f"compressed all-reduce identical on both ranks, mean + new_e against g + e "
        f"{r0['recon']:.3e} (gate {DP_RECON_TOL}; max |g| {r0['gmax']:.3e})")
    loss_line = re.search(r"\[loss\][^\n]*", drill_out).group(0)
    p50 = re.search(r"p50=(\S+)", drill_out).group(1)
    log(f"dp (c): launch.train {' '.join(DP_DRILL_ARGS)}: restarts=1, {loss_line}, p50 "
        f"{p50} a step, {drill_s:.1f}s (beside phase 17(b)-(c), 18(b) and the ranks' "
        f"start); its "
        f"step-{DP_DRILL_STEP} checkpoint "
        f"restored in one process ({one_s:.1f}s) equals the 2-rank leaves "
        f"({len(drill_sha)} sha256, digest {digest}), and that process's checkpoint "
        f"restored onto {DP_RANKS} ranks ({r0['restore_s']:.1f}s; pieces "
        f"{r0['piece_shapes']}) gathers to the same leaves")
    log(f"phase 18 took {time.perf_counter() - t_start:.0f}s on {card}")


def _tp_close(x, y, rtol=TRAIN_ACCUM_RTOL, atol=TRAIN_ACCUM_ATOL) -> bool:
    import torch
    return torch.allclose(x.float(), y.float(), rtol=rtol, atol=atol)


def _tp_identity(cfg, mesh, dev, overrides, faults: bool) -> dict:
    """Phase 20(b) for one model: the 2-rank (data=1, model=2) train step,
    prefill and decode against one process on the same card, from the same
    seeded parameters: loss, every gradient leaf (gathered), the parameters
    after one AdamW step (rtol 2e-3, atol 2e-4), the prefill's and every
    decode step's logits (this rank's vocabulary piece; 1e-4).  With
    ``faults``: the ``wo`` partial sums taken as they are (sliced, not
    reduced) must fail the loss check, and a decode combine that drops
    rank 1's block of slots must fail the logits check.  Returns the
    largest deviations."""
    import torch
    from repro_torch.distributed.collectives import gather_sharded
    from repro_torch.distributed.sharding import constrain, tree_shardings
    from repro_torch.launch.steps import (DataParallel, prefill_step, serve_step, train_grads,
                                          train_step)
    from repro_torch.models import attention
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    opt = AdamWConfig(lr=TRAIN_CARD_LR, warmup_steps=1, total_steps=10)
    b, s = TP_CHECK
    batch = _dp_batch(cfg, b, s, seed=5)
    prompt = {k: torch.as_tensor(v).to(dev) for k, v in batch.items() if k != "labels"}
    steps = [prompt["tokens"][:, t:t + 1] for t in range(TP_CHECK_DECODE)]

    # one process
    model = build_model(cfg, seed=1, device=dev)
    with torch.no_grad():
        lg1, _ = model.prefill(prompt)
        caches, _ = model.init_caches(b, TP_CHECK_CACHE)
        dec1 = [model.decode_step(tok, caches, t)[0] for t, tok in enumerate(steps)]
    model.requires_grad_(True)
    l1, _, g1 = train_grads(model, batch)
    g1 = {k: v.float() for k, v in g1.items()}
    p1 = {k: v.detach().clone() for k, v in model.named_parameters()}
    train_step(model, opt, p1, adamw_init(p1), batch)
    del model, caches

    # the ranks, from the same seed
    model = build_model(cfg, seed=1, device=dev)
    dp = DataParallel(mesh, tree_shardings(model.param_axes(), dict(model.named_parameters()),
                                           mesh, overrides), model, overrides)
    vp = lg1.shape[-1] // dp.model_size
    lo = dp.mesh.get_coordinate()[1] * vp
    err = {}
    with torch.no_grad():
        lg, _ = prefill_step(model, prompt, dp=dp)
        err["prefill"] = (lg - lg1[:, lo:lo + vp]).abs().max().item()
        check(_tp_close(lg, lg1[:, lo:lo + vp], TP_LM_TOL, TP_LM_TOL),
              f"tp (b) {cfg.arch_id}: prefill logits differ by {err['prefill']:.3e}")

        def decode():
            with dp.rules():
                cs, _ = model.init_caches(b, TP_CHECK_CACHE)
            return [serve_step(model, tok, cs, t, dp=dp)[0] for t, tok in enumerate(steps)]

        got = decode()
        err["decode"] = max((x - y[:, lo:lo + vp]).abs().max().item() for x, y in zip(got, dec1))
        check(all(_tp_close(x, y[:, lo:lo + vp], TP_LM_TOL, TP_LM_TOL)
                  for x, y in zip(got, dec1)),
              f"tp (b) {cfg.arch_id}: decode logits differ by {err['decode']:.3e}")
        if faults:  # rank 1's block of slots dropped from the combine
            flash = attention._flash_decode
            attention._flash_decode = lambda qg, k, v, valid, cfg_, comm: flash(
                qg, k, v, valid & (comm.index == 0), cfg_, comm)
            try:
                bad = decode()
            finally:
                attention._flash_decode = flash
            err["decode_fault"] = max((x - y[:, lo:lo + vp]).abs().max().item()
                                      for x, y in zip(bad, dec1))
            check(not all(_tp_close(x, y[:, lo:lo + vp], TP_LM_TOL, TP_LM_TOL)
                          for x, y in zip(bad, dec1)),
                  f"tp (b) {cfg.arch_id}: a decode without rank 1's slots passes the check")
    model.requires_grad_(True)
    loss, _, g = train_grads(model, batch, dp)
    err["loss"] = abs(float(loss) - float(l1))
    check(_tp_close(loss, l1), f"tp (b) {cfg.arch_id}: loss {float(loss)} against {float(l1)}")
    full = {k: gather_sharded(v.contiguous(), dp.model_specs[k], mesh) for k, v in g.items()}
    bad = [k for k in g1 if not _tp_close(full[k], g1[k])]
    err["grad"] = max((full[k].float() - g1[k]).abs().max().item() for k in g1)
    check(not bad, f"tp (b) {cfg.arch_id}: gradients differ ({bad[:3]}, {err['grad']:.3e})")
    del g, full
    if faults:  # the wo partial sums sliced, not reduced
        def unreduced(x, *axes, src=None, partial=False):
            return constrain(x, *axes, src=src)

        attention.constrain = unreduced
        try:
            bad_loss, _, _ = train_grads(model, batch, dp)
        finally:
            attention.constrain = constrain
        err["wo_fault"] = abs(float(bad_loss) - float(l1))
        check(not _tp_close(bad_loss, l1),
              f"tp (b) {cfg.arch_id}: unreduced wo partial sums pass the check")
    params = dp.local_params(model)
    params, _, _ = train_step(model, opt, params, adamw_init(params), batch, dp=dp)
    after = {k: gather_sharded(v, dp.shardings[k].spec, mesh) for k, v in params.items()}
    bad = [k for k in p1 if not _tp_close(after[k], p1[k])]
    err["param"] = max((after[k].float() - p1[k].float()).abs().max().item() for k in p1)
    check(not bad, f"tp (b) {cfg.arch_id}: parameters after a step differ ({bad[:3]})")
    return err


def tp_rank(rank, world, dev, tmp=None):
    """Phase 20 on one rank (spawned; the card shared over gloo): (a) the
    timed full-width bf16 steps, then (b) the identities.  With ``tmp``,
    rank 0 marks the end of (a) there (``tp_a_done``: phase 21's ranks
    wait for it).  Returns what the parent logs."""
    import dataclasses

    import torch
    from repro_torch.configs import LM_ARCHS, get_config, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import spec_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, prefill_step, serve_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    mesh = make_host_mesh(1, world)
    out = {"device": str(dev)}

    # (a) gemma-2b at full width and depth, bf16
    n = TP_WARM + TP_STEPS
    cell = build_cell(TP_ARCH, "train_4k", mesh=mesh, device=dev,
                      opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=2 * n))
    model, dp = cell.model, cell.data_parallel
    dp.traffic.clock = True  # each collective kind's share of a step
    cfg = model.cfg
    out["params"] = sum(math.prod(v) for v in model._param_shapes.values())
    out["dtype"] = str(cfg.param_dtype).replace("torch.", "")
    out["grad_accum"], out["remat"] = cfg.grad_accum, cfg.remat
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = dp.local_params(model)
    opt_state = adamw_init(params)
    out["state_bytes"] = sum(
        spec_bytes(torch.empty(shape, dtype=dt, device="meta"), dp.shardings[k].spec, mesh)
        for k, shape in model._param_shapes.items()
        for dt in (cfg.param_dtype, torch.float32, torch.float32))
    out["piece_bytes"] = sum(p.numel() * p.element_size() for p in params.values())
    out["whole_bytes"] = out["params"] * torch.empty((), dtype=cfg.param_dtype).element_size()
    rows, seq = TP_TRAIN
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=rows, seq=seq, seed=0)
    times, losses = [], []
    for i in range(n):
        batch = pipe.batch_at(i)
        dp.traffic.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, mets = cell.step_fn(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        losses.append(float(mets["loss"]))
        if i >= TP_WARM:
            times.append(dt)
            kinds = (dict(dp.traffic.bytes), dict(dp.traffic.seconds))
    check(all(map(math.isfinite, losses)), f"tp (a): a loss is not finite: {losses}")
    out["train"] = dict(s=times, losses=losses, kinds=kinds,
                        peak=torch.cuda.max_memory_allocated(dev))
    del params, opt_state, mets
    torch.cuda.empty_cache()
    model.requires_grad_(False)

    rows, seq = TP_PREFILL
    prompt = {"tokens": torch.as_tensor(TokenPipeline(vocab_size=cfg.vocab_size, batch=rows,
                                                      seq=seq, seed=1).batch_at(0)["tokens"],
                                        device=dev)}
    with torch.no_grad():
        prefill_step(model, prompt, dp=dp)  # warm
        dp.traffic.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = prefill_step(model, prompt, dp=dp)
        torch.cuda.synchronize(dev)
        prefill_s = time.perf_counter() - t0
        prefill_kinds = (dict(dp.traffic.bytes), dict(dp.traffic.seconds))
        with dp.rules():
            caches, _ = model.init_caches(rows, TP_CACHE)
        tok = prompt["tokens"][:, -1:]  # the same token on every rank
        for t in range(2):  # warm
            serve_step(model, tok, caches, t, dp=dp)
        dp.traffic.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for t in range(TP_DECODE):
            lg, caches = serve_step(model, tok, caches, TP_CACHE // 2 - 1 + t, dp=dp)
        torch.cuda.synchronize(dev)
        decode_s = (time.perf_counter() - t0) / TP_DECODE
        decode_kinds = (dict(dp.traffic.bytes), dict(dp.traffic.seconds))
        check(bool(torch.isfinite(lg).all()), "tp (a): decode logits not finite")
    out["prefill"] = dict(s=prefill_s, kinds=prefill_kinds)
    out["decode"] = dict(s=decode_s, kinds=decode_kinds,
                         cache_bytes=sum(t.numel() * t.element_size()
                                         for c in caches.values() for t in c))
    out["serve_peak"] = torch.cuda.max_memory_allocated(dev)
    del cell, model, dp, caches, logits, lg
    torch.cuda.empty_cache()
    out["a_s"] = time.perf_counter() - t_start
    if tmp is not None and rank == 0:
        (Path(tmp) / "tp_a_done").touch()

    # (b) the float32 identities
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TP_ARCH), num_layers=TP_CHECK_LAYERS, dtype="float32")
    errs = {f"{TP_ARCH} x{TP_CHECK_LAYERS}": _tp_identity(cfg, mesh, dev, None, faults=True)}
    torch.cuda.empty_cache()
    for arch in LM_ARCHS:
        errs[arch] = _tp_identity(reduced_config(arch), mesh, dev, None, faults=False)
        if arch == "mixtral-8x7b":
            errs[f"{arch} expert=model"] = _tp_identity(reduced_config(arch), mesh, dev,
                                                        TP_EP, faults=False)
    out["errs"] = errs
    out["b_s"] = time.perf_counter() - t0
    return out


def start_tp(tmp: str):
    """Phase 20's ranks, started (see :func:`tp_rank`)."""
    from repro_torch.launch.mesh import spawn
    return spawn(tp_rank, TP_RANKS, backend="gloo", device=DEV, args=(tmp,),
                 init_file=os.path.join(tmp, "tp_init")), time.perf_counter()


def finish_tp(started, card: str) -> None:
    """Phase 20: join the ranks started beside phase 7's build and log."""
    procs, t_started = started
    t_wait = time.perf_counter()
    try:
        out = procs.join(timeout_s=900)
    finally:
        procs.terminate()
    own = time.perf_counter() - t_wait
    mb = 1e6
    r0 = out[0]
    rows, seq = TP_TRAIN
    log(f"tp: {TP_RANKS} ranks on {r0['device']} as a (data=1, model={TP_RANKS}) mesh over "
        f"gloo (host-staged: the protocol, not NVLink): {TP_ARCH} {r0['dtype']} at full width "
        f"and depth, {r0['params']:,} parameters ({r0['whole_bytes'] / 1e9:.2f} GB whole; a "
        f"rank's pieces {r0['piece_bytes'] / 1e9:.2f} GB)")

    def kinds(k):
        b, sec = k
        return ", ".join(f"{name} {b[name] / mb:.1f} MB {sec.get(name, 0) * 1e3:.1f} ms"
                         for name in sorted(b))

    for r in sorted(out):
        a = out[r]
        step = statistics.median(a["train"]["s"])
        share = sum(a["train"]["kinds"][1].values()) / step
        log(f"tp (a) rank {r}: train (remat, grad_accum {a['grad_accum']}, {rows} x {seq} "
            f"tokens) {step * 1e3:.1f} ms a step "
            f"({', '.join(f'{t * 1e3:.1f}' for t in a['train']['s'])} ms after {TP_WARM} warm-up), {rows * seq / step:.1f} tokens/s; collectives "
            f"{100 * share:.1f} % of the step ({kinds(a['train']['kinds'])}); loss "
            f"{', '.join(f'{x:.4f}' for x in a['train']['losses'])}; peak memory "
            f"{a['train']['peak'] / 1e9:.2f} GB beside spec_bytes of its share (parameters and "
            f"both moments) {a['state_bytes'] / 1e9:.2f} GB; on {card}")
        p, d = a["prefill"], a["decode"]
        pr, ps = TP_PREFILL
        log(f"tp (a) rank {r}: prefill {pr} x {ps} {p['s'] * 1e3:.1f} ms "
            f"({pr * ps / p['s']:.1f} tokens/s; collectives "
            f"{100 * sum(p['kinds'][1].values()) / p['s']:.1f} %: {kinds(p['kinds'])}); "
            f"decode at batch {pr} against {TP_CACHE}-token kv_seq-split caches "
            f"({d['cache_bytes'] / mb:.1f} MB a rank) {d['s'] * 1e3:.2f} ms a step "
            f"({pr / d['s']:.1f} tokens/s; collectives "
            f"{100 * sum(d['kinds'][1].values()) / (d['s'] * TP_DECODE):.1f} % over "
            f"{TP_DECODE} steps: {kinds(d['kinds'])}); serving peak "
            f"{a['serve_peak'] / 1e9:.2f} GB; on {card}")
    _finished(LAUNCH, "tp_meta", 300)
    meta = json.loads(Path(LAUNCH["tp_meta_json"]).read_text())
    for r in sorted(out):
        peak = out[r]["train"]["peak"]
        check(meta["temp_bytes"] <= peak,
              f"tp (a) rank {r}: the dry run's count of this step on meta "
              f"{meta['temp_bytes'] / 1e9:.3f} GB exceeds the allocator's peak {peak / 1e9:.3f} GB")
        log(f"tp (a) rank {r}: the dry run's temp bytes of this step counted on meta (the same "
            f"(1, {TP_RANKS}) mesh, {rows} x {seq} tokens; {meta['s']:.1f}s in the background): "
            f"census peak {meta['peak_bytes'] / 1e9:.3f} GB + the rank's model pieces "
            f"{meta['pieces'] / 1e9:.3f} GB = {meta['temp_bytes'] / 1e9:.3f} GB, "
            f"{meta['temp_bytes'] / peak:.4f} of torch.cuda.max_memory_allocated "
            f"{peak / 1e9:.3f} GB (read after reset_peak_memory_stats() following the bind; "
            f"it also holds the arguments: pieces and moments); on {card}")
    errs = r0["errs"]
    first = next(iter(errs))
    worst = {k: max(v.values()) if k != first else max(
        v[x] for x in ("loss", "grad", "param", "prefill", "decode")) for k, v in errs.items()}
    log(f"tp (b): the 2-rank train step against one process within rtol {TRAIN_ACCUM_RTOL}, "
        f"atol {TRAIN_ACCUM_ATOL} (loss, every gradient leaf, every parameter after one step), "
        f"prefill and {TP_CHECK_DECODE} decode steps' logits within {TP_LM_TOL} "
        f"({TP_CHECK_CACHE}-slot caches, both ranks' blocks written), float32, largest "
        f"|diff|: " + ", ".join(f"{a} {e:.2e}" for a, e in worst.items())
        + f"; planted faults: wo's partial sums not reduced (loss off by "
        f"{errs[first]['wo_fault']:.3e}), the decode combine without rank 1's block "
        f"(logits off by {errs[first]['decode_fault']:.3e}), both failing the check")
    log(f"phase 20 took {time.perf_counter() - t_started:.0f}s beside phase 7 "
        f"((a) {r0['a_s']:.1f}s, (b) {r0['b_s']:.1f}s on rank 0), {own:.1f}s of the "
        f"script's own (the wait after phase 7's build); on {card}")


def _pod_identity(cfg, mesh, dev) -> dict:
    """Phase 21(b): the (pod, data, model) train step against one process
    on the same card, from the same seeded parameters: loss, every
    gradient leaf (gathered), the parameters after one AdamW step (rtol
    2e-3, atol 2e-4); beside two planted faults that must fail the loss and
    gradient check: the gradients summed over "data" only (not "pod"), and
    every pod taking the same rows.  Returns the largest deviations."""
    import torch
    from repro_torch.distributed.collectives import gather_sharded
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.steps import DataParallel, train_grads, train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    opt = AdamWConfig(lr=TRAIN_CARD_LR, warmup_steps=1, total_steps=10)
    batch = _dp_batch(cfg, DP_BATCH, DP_SEQ, seed=5)
    model = build_model(cfg, seed=1, device=dev).requires_grad_(True)
    l1, _, g1 = train_grads(model, batch)
    g1 = {k: v.float() for k, v in g1.items()}
    p1 = {k: v.detach().clone() for k, v in model.named_parameters()}
    train_step(model, opt, p1, adamw_init(p1), batch)
    del model

    model = build_model(cfg, seed=1, device=dev).requires_grad_(True)
    dp = DataParallel(mesh, tree_shardings(model.param_axes(), dict(model.named_parameters()),
                                           mesh), model)

    def step_err():
        loss, _, g = train_grads(model, batch, dp)
        full = {k: gather_sharded(v.contiguous(), dp.model_specs[k], mesh) for k, v in g.items()}
        bad = [k for k in g1 if not _tp_close(full[k], g1[k])]
        worst = max((full[k].float() - g1[k]).abs().max().item() for k in g1)
        return abs(float(loss) - float(l1)), worst, _tp_close(loss, l1) and not bad, bad

    err = {}
    err["loss"], err["grad"], ok, bad = step_err()
    check(ok, f"pod (b): loss off by {err['loss']:.3e}, gradients differ ({bad[:3]})")
    keep = dp.sum  # planted: the gradients summed over "data" only, not "pod"
    dp.sum = lambda t, kind, axes=(), model_too=(): keep(
        t, kind, tuple(a for a in axes if a != "pod"), model_too)
    try:
        err["data_only_loss"], err["data_only_grad"], ok, _ = step_err()
    finally:
        dp.sum = keep
    check(not ok, "pod (b): gradients summed over 'data' only pass the check")
    coord = dp.coord  # planted: every pod takes pod 0's rows
    dp.coord = dict(coord, pod=0)
    try:
        err["same_rows_loss"], err["same_rows_grad"], ok, _ = step_err()
    finally:
        dp.coord = coord
    check(not ok, "pod (b): every pod taking the same rows passes the check")
    params = dp.local_params(model)
    params, _, _ = train_step(model, opt, params, adamw_init(params), batch, dp=dp)
    after = {k: gather_sharded(v, dp.shardings[k].spec, mesh) for k, v in params.items()}
    bad = [k for k in p1 if not _tp_close(after[k], p1[k])]
    err["param"] = max((after[k].float() - p1[k].float()).abs().max().item() for k in p1)
    check(not bad, f"pod (b): parameters after a step differ ({bad[:3]})")
    return err


def pod_rank(rank, world, dev, after=None):
    """Phase 21 on one rank (spawned; the card shared over gloo): (a) the
    timed full-width steps, (b) the identities, (c) long_500k's decode,
    once the file ``after`` exists (None: at once).  Returns what the
    parent logs."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import spec_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.common import split_axes
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    mesh = make_mesh(POD_MESH, ("pod", "data", "model"), "cpu")
    out = {"device": str(dev), "coord": tuple(mesh.get_coordinate())}
    deadline = time.monotonic() + 600
    while after is not None and not Path(after).exists():
        check(time.monotonic() < deadline, f"pod: {after} never came")
        time.sleep(0.2)
    out["waited_s"] = time.perf_counter() - t_start
    t_start = time.perf_counter()

    # (a) DP_ARCH at full width and depth
    n = POD_WARM + POD_STEPS
    cell = build_cell(DP_ARCH, "train_4k", mesh=mesh, device=dev,
                      opt=AdamWConfig(lr=DP_LR, warmup_steps=1, total_steps=2 * n))
    model, dp = cell.model, cell.data_parallel
    dp.traffic.clock = True
    cfg = model.cfg
    out["params"] = sum(math.prod(v) for v in model._param_shapes.values())
    out["dtype"] = str(cfg.param_dtype).replace("torch.", "")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = dp.local_params(model)
    opt_state = adamw_init(params)
    out["state_bytes"] = sum(
        spec_bytes(torch.empty(shape, dtype=dt, device="meta"), dp.shardings[k].spec, mesh)
        for k, shape in model._param_shapes.items()
        for dt in (cfg.param_dtype, torch.float32, torch.float32))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=DP_BATCH, seq=DP_SEQ, seed=0)
    times, losses = [], []
    for i in range(n):
        batch = pipe.batch_at(i)
        dp.traffic.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, mets = cell.step_fn(params, opt_state, batch)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        losses.append(float(mets["loss"]))
        if i >= POD_WARM:
            times.append(dt)
            kinds = (dict(dp.traffic.bytes), dict(dp.traffic.seconds))
    check(all(map(math.isfinite, losses)), f"pod (a): a loss is not finite: {losses}")
    out["train"] = dict(s=times, losses=losses, kinds=kinds,
                        peak=torch.cuda.max_memory_allocated(dev))
    del cell, model, dp, params, opt_state, mets
    torch.cuda.empty_cache()
    out["a_s"] = time.perf_counter() - t_start

    # (b) the float32 identities
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(DP_ARCH), num_layers=DP_CHECK_LAYERS, dtype="float32")
    out["errs"] = _pod_identity(cfg, mesh, dev)
    torch.cuda.empty_cache()
    out["b_s"] = time.perf_counter() - t0

    # (c) long_500k: one row, the slots over model x data x pod
    t0 = time.perf_counter()
    cfgset = dataclasses.asdict(reduced_config("gemma2-9b"))
    cfgset.pop("arch_id")
    cell = build_cell("gemma2-9b", "long_500k", mesh=mesh, device=dev, cfgset=cfgset)
    dp = cell.data_parallel
    one = build_model(cell.model.cfg, device=dev)  # build_cell's seed
    caches = dp.init_caches(cell.model, 1, POD_CACHE)
    with dp.rules():
        out["slots"] = (caches["kv1"].k.shape[2], split_axes(caches["kv1"].k))
    ones, _ = one.init_caches(1, POD_CACHE)
    tokens = _dp_batch(one.cfg, 1, POD_DECODE, seed=9)["tokens"]
    v = one.cfg.vocab_padded // dp.model_size
    lo = dp.coord["model"] * v
    worst = 0.0
    with torch.no_grad():
        for t in range(POD_DECODE):
            tok = torch.as_tensor(tokens[:, t:t + 1], device=dev)
            lg, caches = cell.step_fn(tok, caches, t)
            ref, _ = one.decode_step(tok, ones, t)
            check(_tp_close(lg, ref[:, lo:lo + v], TP_LM_TOL, TP_LM_TOL),
                  f"pod (c): decode step {t} differs from one process")
            worst = max(worst, (lg - ref[:, lo:lo + v]).abs().max().item())
    out["long_500k"] = worst
    out["c_s"] = time.perf_counter() - t0
    return out


def start_pod(tmp: str, after: str | None = None):
    """Phase 21's ranks, started (see :func:`pod_rank`); they begin once
    the file ``after`` exists."""
    from repro_torch.launch.mesh import spawn
    return spawn(pod_rank, POD_RANKS, backend="gloo", device=DEV, args=(after,),
                 init_file=os.path.join(tmp, "pod_init")), time.perf_counter()


def finish_pod(started, card: str) -> None:
    """Phase 21: join the ranks and log."""
    procs, t_started = started
    t_wait = time.perf_counter()
    try:
        out = procs.join(timeout_s=600)
    finally:
        procs.terminate()
    own = time.perf_counter() - t_wait
    mb = 1e6
    r0 = out[0]
    log(f"pod: {POD_RANKS} ranks on {r0['device']} as a (pod, data, model) = {POD_MESH} mesh "
        f"over gloo (host-staged: the protocol, not NVLink): {DP_ARCH} {r0['dtype']} at full "
        f"width and depth, {r0['params']:,} parameters, {DP_BATCH} x {DP_SEQ} tokens a step "
        f"(the batch over pod x data), lr {DP_LR}")
    for r in sorted(out):
        a = out[r]
        step = statistics.median(a["train"]["s"])
        b, sec = a["train"]["kinds"]
        kinds = ", ".join(f"{k} {b[k] / mb:.1f} MB {sec.get(k, 0) * 1e3:.1f} ms"
                          for k in sorted(b))
        log(f"pod (a) rank {r} {a['coord']}: {step * 1e3:.1f} ms a step (median of "
            f"{POD_STEPS} after {POD_WARM} warm-up: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in a['train']['s'])} ms), "
            f"{DP_BATCH * DP_SEQ / step:.1f} tokens/s; collectives "
            f"{100 * sum(sec.values()) / step:.1f} % of the step ({kinds}); loss "
            f"{', '.join(f'{x:.4f}' for x in a['train']['losses'])}; peak memory "
            f"{a['train']['peak'] / 1e9:.3f} GB beside spec_bytes of its share (parameters and "
            f"both moments) {a['state_bytes'] / 1e9:.3f} GB; on {card}")
    e = r0["errs"]
    log(f"pod (b): the {POD_MESH} train step against one process within rtol "
        f"{TRAIN_ACCUM_RTOL}, atol {TRAIN_ACCUM_ATOL} ({DP_ARCH} at full width, "
        f"{DP_CHECK_LAYERS} layers, float32; loss, every gradient leaf gathered, every parameter "
        f"after one step): largest |diff| loss {e['loss']:.2e}, gradient {e['grad']:.2e}, "
        f"parameter {e['param']:.2e}; planted faults: the gradients summed over 'data' only "
        f"(loss off by {e['data_only_loss']:.3e}, a gradient by {e['data_only_grad']:.3e}), "
        f"every pod on the same rows (loss {e['same_rows_loss']:.3e}, gradient "
        f"{e['same_rows_grad']:.3e}), both failing the check")
    slots, axes = r0["slots"]
    log(f"pod (c): gemma2-9b (reduced) long_500k decode over {POD_MESH}: the global layers' "
        f"{POD_CACHE} slots in blocks of {slots} over {'+'.join(axes)} (\"data\" of size 1), "
        f"{POD_DECODE} steps against one process within {TP_LM_TOL}: largest |diff| "
        f"{max(out[r]['long_500k'] for r in out):.2e} over the ranks")
    log(f"phase 21 took {time.perf_counter() - t_started:.0f}s from its start beside phase 7 "
        f"(rank 0 waited {r0['waited_s']:.1f}s for phase 20(a) to end; then (a) "
        f"{r0['a_s']:.1f}s, (b) {r0['b_s']:.1f}s, (c) {r0['c_s']:.1f}s), {own:.1f}s of the "
        f"script's own (the wait after phase 20); on {card}")


def build_kernels() -> None:
    """Phase 1: the five kernels and the scan's timing build built at once,
    one nvcc each."""
    from repro_torch.kernels import dade_dco, graph_scan, ivf_scan, l2_scan, quant_dco

    t0 = time.perf_counter()
    builds = {"ivf_scan": ivf_scan.build, "ivf_scan_clocks": ivf_scan.build_clocks,
              "graph_scan": graph_scan.build, "dade_dco": dade_dco.build,
              "quant_dco": quant_dco.build, "l2_scan": l2_scan.build}
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        jobs = [(name, pool.submit(fn)) for name, fn in builds.items()]
        for name, job in jobs:
            lib, ptxas = job.result()
            res = [ln.strip() for ln in ptxas.splitlines()
                   if "registers" in ln or "spill" in ln]
            log(f"build: ok {name} {lib.name}; ptxas: {' | '.join(res)}")
    log(f"build: all {len(builds)} libraries in {time.perf_counter() - t0:.1f}s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.configs.dade_ivf import CONFIG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build (and phase 19's background runs) ----
    import tempfile
    launch_tmp = tempfile.TemporaryDirectory()
    launch = start_launch_tooling(launch_tmp.name)
    LAUNCH.update(launch)
    build_kernels()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(card)

    t0 = time.perf_counter()
    ivf, flat_served = run(CONFIG, n_clusters=1024, n_queries=1024, slice_rows=65536,
                           slice_queries=64, card=card)
    graph = run_graph(card, flat_served)
    flat = run_flat(CONFIG, card)
    ivf["snapshot_launches"] = graph.pop("flat_snapshot_launches")
    ivf["ranked_launches"] = graph.pop("ranked_flat_launches")
    stamp("phase 16")
    run_lm(card)
    with tempfile.TemporaryDirectory() as dp_tmp:
        started = []  # phase 18's drill, started in phase 17
        try:
            stamp("phase 17")
            one_process_p50, t_drill = run_train(card, dp_tmp, started, launch)
            stamp("phase 18")
            run_train_dp(card, one_process_p50, started[0], t_drill, dp_tmp)
        finally:
            for proc in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    log(f"phases 2-18 took {time.perf_counter() - t0:.0f}s")
    try:
        stamp("phase 19")
        collect_dryrun(launch, card)
    finally:
        for name in ("dryrun", "meta", "tp_meta"):
            if launch[name].poll() is None:
                launch[name].kill()
                launch[name].wait()
        launch_tmp.cleanup()
    log(f"phase 19 (the launch tooling) took {sum(PHASE19_S.values()):.1f}s of the "
        f"script's own time ((a) {PHASE19_S['a']:.1f}s, (b) {PHASE19_S['b']:.1f}s, (c) "
        f"{PHASE19_S['c']:.1f}s; the dry run itself ran beside phases 1-18); the script "
        f"{time.perf_counter() - T_START:.0f}s on {card}")
    log(json.dumps({"kernels": [ivf, *flat[:2], graph, flat[2]]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
