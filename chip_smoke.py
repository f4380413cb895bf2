#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python chip_smoke.py

Phases, each of which asserts (nothing is caught):

  1. build   — compile all nine kernels from the nine sources in this
               checkout (one nvcc per source, all started together;
               flash_attention and ssd_scan have two each: bf16 on the
               tensor cores, fp32 on the CUDA cores; fleetlint's three
               mutant kernels share ``mutants.cu``);
  2. kernels — hold each kernel against its plain PyTorch version on the
               card over the reference test matrix and at the full-width
               shapes (flash_attention over head dims 16-160: the SMOKE
               configs' 16, 20 (with KV 1, a row TMA cannot stride), 24,
               32, and 36, 48 and 100, causal, windowed and not, in both
               dtypes, and 64, 80, 128 and 160 at the served shapes of
               olmo-1b, h2o-danube-1.8b,
               jamba-v0.1, stablelm-12b (hd 160), codeqwen1.5-7b,
               llama4-maverick, internvl2-26b and whisper-tiny (its
               encoder's in fp32 without the causal mask, as the
               reference's promotion of fp32 frames runs it; its
               decoder's in bf16), and at h2o's heads over S 8192, where
               its window skips tiles; ssd_scan at P 16 (the SMOKE
               configs', N 16, 32 and 128), at chunks 16, 32, 48 and 80
               beside 64-256, and at mamba2-780m's and jamba-v0.1's; fused_map, hist and bucket_slots bit
               for bit, flash_attention, ssd_scan and flash_decode at the
               reference's per-dtype tolerance), and time both with CUDA
               events, beside the library call where there is one;
               fused_map also by device time, and at rep 1 and 16 on its
               hot rank (the cost of one pass), over a second matrix of
               task sizes 1,025-16,384 (``fused_wide_matrix``: each side
               of every change of its block, the global scratch past S
               4,096), and at S 4,096 and 16,384 at fig9's width, rep 1
               and 8 on its hot rank, by device time; ssd_scan also by
               device time, its device kernels a call (three passes in bf16),
               the fp32 kernel at the same shape, and the share of its
               bf16 outputs off the plain version's bits against a
               control's (``check_ssd_bits``). The
               three kernels that their own entry points reach (hist,
               bucket_slots, flash_decode; bucket_slots is also on phase
               4's MoE path) run that path here:
               ``wordcount_hist`` on the job's 2**27-token corpus and on
               as many uniform keys over V, in count and owner mode (also
               by device time), ``bucket_slots`` on deepseek-v2-lite's
               routing of a served batch and on one segment's owner
               window, ``flash_decode`` on the olmo-1b and h2o-danube-1.8b
               served caches;
  2c. lint   — fleetlint (``python -m repro_torch.analysis.lint``) on
               the card: ``--all`` clean over the 82 shipping programs
               (run on seeded inputs at P = 8 under SPMD001, SPMD002 and
               REP001; the 18 ``+fused`` handles launch fused_map once a
               step through their step graphs, as many launches as their
               steps) and the six shipping wrappers, and ``--selftest``
               PASS over the 20 mutants, each near twin's kernel
               (copy_rows, table_add, copy_rows_i32) launched once on
               that path; each ``+fused`` program's finish outputs equal
               to its unfused twin's, bit for bit; the phase's wall; then
               each near twin's kernel held bit for bit to its plain
               version on seeded inputs and timed beside ``x.clone()`` or
               ``table + recs[0]``, by events and, in turns with that
               call, by device time;
  2d. memcheck — the script again, in child processes under
               ``compute-sanitizer --tool memcheck`` with PyTorch's
               caching allocator off: a probe, then (a) every shipping
               kernel's small matrix and the near twins, 0 errors, and
               (b) each PAL001 bad twin in a child of its own, an invalid
               global read in its kernel. Where the tool is absent or does
               not run on the card, one line says so and nothing is held;
               the phase's seconds;
  2e. guard  — a bounds check that needs no tool: every shipping
               kernel's cases of 2d, each input copied between two 1 MiB
               bands of a pattern in one allocation (``banded``), run under
               two fills (floats NaN and 1e4, integers two keys the kernel
               counts apart): every band untouched and every output equal
               to the unbanded call's (integers bit for bit, floats at the
               smoke's tolerance, finite). fused_map's table, which it
               updates in place, is banded as an input; hist also writes
               through its C entry point into a banded output, on its
               matrix and on the 2**27-token corpus in both modes. Each
               PAL001 bad twin over banded inputs must change its output
               between the fills. Per kernel its cases and launches, and
               the phase's seconds;
  3. job     — MR-1S WordCount through the Job API at the documented
               fused width (V = 262,144, P = 8, S = 256, cap = 64) on a
               Zipf corpus with one 8x-hot rank: records equal to the
               numpy oracle and the kernel launched once a step on the
               main path, each step a CUDA graph replay; the feed's
               prefetch hits and its host seconds a segment; on a
               2**22-token corpus of the same width the fused job, its
               eager step loop (the graph's baseline) and the unfused
               job (~9x slower), all equal; then, over a segment whose
               input is read, the graph's and the eager loop's host
               microseconds a step and device busy share;
  3b. compare — MR-2S against the fused MR-1S, without and with work
               stealing (``1s+steal``), at phase 3's width on its
               2**27-token corpus, read once into host memory and fed as
               an array, after a warm-up of each, under three repeat
               grids (balanced, phase 3's unbalanced, and the Zipf rank
               skew s 1.1, mean repeat 4 of the reference's
               fig9_imbalance): every job's records equal to the oracle;
               each job's wall, tokens/s, the feed's host seconds a
               segment, fused_map launches (1S one a step, 2S none), the
               device's busy share and kernels over one segment, and the
               hot rank's repeats; the stealing job's lockstep passes
               (the max repeats its steps ran with), and its steals and
               work row as the card advanced them from the gathered
               columns, equal to the host replay's (no steal on the
               balanced grid), and its schedule's host seconds a
               segment; then 2S and 1S oneshot on the unbalanced grid,
               each peak of device memory beside the Fig 6 buffers from
               their shapes;
  3c. snapshots — on the same corpus and unbalanced grid, the segmented
               fused 1S job without and with ``handle.checkpoint`` after
               every 8th segment (keep 2), in turns, and its overhead; the
               older kept snapshot restored into a fresh handle and
               finished; the same for 2S; a 1S job re-planned halfway by
               ``replan_handle``; every job's records equal to the
               uninterrupted job's;
  3d. keyskew — the reference's fig10_keyskew: ``ZipfSource`` keys at
               a 1.3 and 1.8 (2**24 tokens, read once into host memory) at
               phase 3's width on the unbalanced grid, each partitioner
               (hash, sampled, sampled+split with split_threshold 0.05)
               through the fused 1S without and with stealing, and a 2S
               job with sampled+split at a 1.8: every job's records equal
               to the oracle, split keys in every sampled+split job; its
               wall, the pre-pass's seconds and tasks read, split keys,
               and max over mean of the owner loads modelled under the
               job's own maps and of the records each rank's window
               holds;
  3e. fleet  — the reference's fig11_multitenant through the port's
               ``JobScheduler``, one FeedBudget a fleet: (a) at its own
               width (P 8, S 1024, cap 512, V 4096, segment 1, 3,145,728
               tokens) unfused WordCount/Histogram/InvertedIndex jobs of
               Zipf(2.0) sizes, biggest first, for K 1, 4 and 16, budget
               8 segments; (b) the main path, 8 fused WordCount tenants
               at phase 3's width over Zipf(2.0) slices of its 2**27
               corpus, balanced grid, budget 4 segments (16,777,216 B);
               fifo, fair and priority (``priority=k``): every job's
               records equal to its solo run, 3 programs in (a) (K >= 3)
               and 1 in (b), in (b) one fused_map graph replay a step and
               one graph captured a tenant, fifo finishing in admission
               order and priority in descending priority, and no pinned
               byte left; makespan, mean and p95 latency, Jain's index
               over solo_wall / latency, budget denials (the feeds' and
               the budget's), graphs captured, the feeds' pinned bytes'
               high-water; (b) also makespan over the solo walls' sum and
               the device's busy share over one fair slice cycle;
  3f. overlap — the reference's fig8_io_overlap, its real run: the
               fused job at phase 3's width on the first 2**25 tokens of
               its corpus (written once to a temporary file), unbalanced
               grid, resident (the array, ``prefetch=False``) against
               streamed (``MmapTokenSource``, ``prefetch=True``), in turns
               twice each: records equal, one launch a step; each wall,
               ``1 - streamed/resident``, prefetch hits of segments built,
               the feed's host seconds a segment;
  3g. coded  — the reference's fig15_coded real run at its full width:
               WordCount on ``synth_corpus(786,432, 65,536, seed=0)`` in
               host memory, P 6, S 4096, cap 1024, oneshot (32 steps),
               repeats ``zipf_skew_repeats(6, 32, s, mean_rep=4, seed=1)``
               for s 0.0, 0.6, 1.1 and 1.6; arms r1, r2, r3 and r2+steal
               (unfused, as the reference's coded jobs must be) and
               r1-fused, the main path's kernel job at the same S 4096 on
               r1's own grid; a warm-up of each arm, then
               two timed runs in turns: every run's records equal to the
               oracle, fused_map launches 0 on every coded arm and one a
               step on r1-fused, r2+steal's steals, passes and work row
               equal to the group host replay's and a group's members
               equal; each arm's wall, tokens/s, ms a step, steals, feed
               bytes, the modelled shuffle bytes and their ratio to r1's
               (0.60 at r 2, 0.40 at r 3), and at s 1.6 the device's busy
               share over one segment of 8 steps of each arm, traced;
  3h. crossjob — the reference's fig14_crossjob real run at its full
               width: P 8, S 1024, cap 512, V 4096, segment 1, stealing;
               for K 4 and 16 jobs of Zipf(2.0) sizes of 786,432 tokens
               over ``ZipfSource(n, 4096, seed=2000 + k)``, job k's hot
               rank rolled to k, ``priority=k``; each job solo, then
               ``fair`` against ``fair`` + ``coschedule=True, copack=4``:
               every job's records equal to its solo run, no fused_map
               launch, one domain, cross-rank steals in it and its
               ``job_work`` equal to the members' repeats; makespan, mean
               and p95 latency, Jain's index over solo_wall / latency,
               steals and ``job_work``;
  3i. elastic — (a) the reference's fig13_elastic real run at its own
               width, uncut: K 4 unfused jobs (WordCount and
               ``Histogram(n_bins=64)`` in turn) of 49,152 uniform tokens
               from ``default_rng(13)``, V 512, P 8 -> 6, S 64, cap 256,
               segment 4, ``ckpt_every=2``, 4 slices a tick, under the
               ``FleetSupervisor``; solo runs at P 8 and 6, a killed
               mini-fleet (warm-up), then the campaigns clean, recover
               (ranks 0 and 1 killed at 2/3 of clean's ticks) and restart
               (``restore_on_remesh=False``): every job in every campaign
               equal to its solo run, both killed arms ending at P 6,
               recover restoring every live job and restarting none, no
               fused_map launch; each arm's wall and ticks, MTTR,
               recover/clean, restart/clean, restart - recover; (b) the
               main path: the fused job at phase 3's width on the first
               2**25 tokens of its corpus, unbalanced grid, snapshotted at
               half its segments and finished (the uninterrupted job,
               records equal to the oracle), the snapshot
               ``elastic_restore``d into a fresh fused handle at P 6,
               snapshotted at half its segments and finished, that
               snapshot restored at P 8 and finished: every arm's records
               equal to the uninterrupted job's, the fold's checksum equal
               to the host twin's, one fused_map launch a step on every
               side, each restored handle capturing its own graphs; the
               host twin's, the device fold's and ``rebucketize_tasks``'
               seconds, each part's wall and steps, and the P 6 part's
               wall over the P 8 job's second half;
  3j. imbalance — the reference's fig9_imbalance real run at its own
               width: WordCount on ``synth_corpus(2,000,000, 65,536,
               seed=0)`` in host memory, P 8, S 4096, cap 1024, oneshot (62
               steps), repeats ``zipf_skew_repeats(8, 62, s, mean_rep=4,
               seed=1)`` for s 0.0, 0.6, 1.1 and 1.6; fig9's arms
               2s, 1s and 1s+steal (unfused) and the main path's 1s-fused
               and 1s-fused+steal, each warmed up (the fused ones traced
               for the kernel's device time a step) and run once: every
               job's records equal to the oracle and the unfused 1S job's,
               fused_map launched once a step (a graph replay) on the fused
               arms and never on the others, the stealing arms' steals,
               passes and work row equal to the host replay's; then the
               fused job at S 16,384 (fig8's largest task, its sort in the
               kernel's global scratch) on the balanced grid, held the
               same way; each arm's wall, tokens/s, 2s/1s and 2s/1s-fused;
  4. serve   — olmo-1b, mamba2-780m, h2o-danube-1.8b (head dim 80),
               deepseek-v2-lite-16b (its width, 9 of its 27 layers: MLA,
               one leading dense layer, 8 MoE layers of 64 experts top-6
               and 2 shared),
               jamba-v0.1-52b (its width, one period of 8 layers: SSD
               layers of 128 heads x 64 with state 16, GQA 32/8 attention
               at slot 4, MoE of 16 experts top-2 on the odd slots),
               codeqwen1.5-7b (its width, 8 of its 32 layers: MHA 32
               with the qkv bias),
               stablelm-12b (its width, 20 of its 40 layers, LayerNorm,
               qk-norm, GQA 32/8 at head dim 160), llama4-maverick (its width, 2 of its 48
               layers: one dense, one MoE of 128 experts top-1 and a
               shared expert, GQA 40/8), internvl2-26b (its width, 24 of
               its 48 layers, GQA 48/8, a vision prefix) and whisper-tiny (a 4-layer encoder
               over fp32 frames, cross-attention in its 4 decoder layers)
               at full width through ``ServeEngine.generate``: one batch
               of 8 requests each at a context of 2048 positions (split
               as ``frontend_geometry`` splits it: internvl2 512 seeded
               fp32 prefix rows and 1,536 text tokens, whisper 1,024
               seeded fp32 frames and 2,048 text tokens), 32 new tokens,
               greedy, a cache of the context + 40 positions; (a) each of
               the arch's kernels launched as the code says
               (``serve_launches``): flash_attention once an attention
               layer (an encoder's too) and prefill, ssd_scan once an SSD
               layer and prefill, bucket_slots 2 (G + 1) times an MoE
               layer at the prefill and at every decode step; (b) the
               kernel path's last-position logits within 3e-2 *
               max|logits| of the reference path's (an MoE stack's with
               the kernel path's routing, ``same_routing``) and finite;
               (c) the first served token a maximum of them; (d) for an
               MoE stack every bucket_slots call of one prefill bit for
               bit equal to
               bucket_slots_ref (``served_slots``); (e) every call of one
               decode step of the engine likewise, and that step's logits
               and caches bit for bit equal to the plain path's
               (``served_decode``); the kernel timed at the first MoE
               layer's four served shapes (deepseek: T 24,576 at E 1 and
               T 30,721 at E 64 at prefill, T 12 at E 1 and T 16 at E 64
               at decode; jamba: T 8,192 at E 1, T 10,241 at E 16, T 4 at
               E 1, T 6 at E 16; llama4: T 4,096 at E 1, T 5,121 at E 128,
               T 2 at E 1, T 3 at E 128) by events and device time beside its
               plain version and bound, and its share of the prefill's
               and a decode step's device time; every attention and SSD
               layer's mixer, kernel against plain on the kernel path's
               input, within 3e-2 * max|out| (whisper's encoder layers
               too); for mamba2, jamba and internvl2, whose bf16 paths
               drift apart with depth, (b) is reported and the stack
               held instead to the same weights in fp32 (mamba2 each
               served batch, jamba and internvl2 their first 2 prompts
               with the weights upcast a layer at a time): the fp32 kernel path
               within 1e-3 * max|logits| of the fp32 reference path, and
               the bf16 kernel path no more than 1.5 times as far from it
               as the bf16 reference path; the weights, a prefill's peak
               and what it leaves in memory;
  5. train  — olmo-1b at full width (16 layers, d_model 2048, bf16
               parameters, fp32 AdamW moments) through
               ``make_train_step``: 20 steps of 8 x 512 tokens of
               ``lm_token_stream`` behind the ``DoubleBufferedLoader``, two
               microbatches of 4 a step, full remat, ``save_async`` after
               step 3; no kernel is launched: the reference's train step
               reaches no Pallas kernel. Then deepseek-v2-lite-16b at full
               width cut to 4 layers (the leading dense layer and 3 MoE
               layers, 1s dispatch), 10 steps of the same shape, no
               snapshot: its MoE layers slot every pipeline step's records
               through bucket_slots, twice under full remat, and it
               launches no other kernel. Each: the losses of the first and
               last step, median ms a step split into fwd+bwd and
               optimizer by CUDA events, tokens/s, the model-FLOPs share
               over the active parameters at 989 TFLOP/s, peak memory and
               the busy share over two steps, the launches (equal to the
               code's count, ``train_launches``); (a) every loss finite
               and the last 5 below the first 5 on average, (b) on one
               batch from a fresh state one step at A = 2 and one at A = 1
               within 1e-2 (loss) and 2e-2 (grad norm) relative, (c) for
               olmo the snapshot restored into a fresh state and steps 3-5
               rerun on ``lm_batches(skip=3)`` within 1e-3 of the
               uninterrupted run's losses, (d) no parameter non-finite,
               (e) for deepseek one microbatch's gradients under full
               remat and under remat none, every slot call of each bit for
               bit equal to bucket_slots_ref, the recompute's calls equal
               to the forward's and the forward's to remat none's, and the
               two gradients within 1e-2 of each leaf's max
               (``train_slots``);
  4m. serve-mesh — deepseek-v2-lite-16b (its width, 4 of its 27
               layers: MLA, the dense layer and 3 MoE layers of 64
               experts top-6) and llama4-maverick (its width, phase 4's 2
               layers: GQA 40/8, 128 experts top-1 and a shared expert)
               through ``ServeEngine(mesh=, dp_entry="data")`` on a
               virtual (data 2, model 4) mesh (``distributed/mesh.py``:
               the MoE layers dispatch in one shard_map region, tokens
               and experts over "model"; the MLA and GQA decode caches
               sequence-sharded over "model"), bf16, seed 0: one batch
               of 8 prompts of 2048 tokens, 16 new, a cache of 2088;
               then the same unsharded. (a) every bucket_slots call of
               a prefill and of one decode step under the mesh bit for
               bit equal to bucket_slots_ref, and that step's logits and
               caches to the mesh's plain path's; (b) at the capacity
               factor no shard drops a record at (the config's own
               doubled until none), the last prefill logits and one
               decode step's within 3e-2 * max|logits| of the unsharded
               run's on the mesh's routing; (c) the launches equal to
               the code's count (``mesh_serve_launches``: one
               bucket_slots call a slotting step for all 8 shards while
               shards x buckets fit 256). Each engine's prefill ms,
               decode ms a token, tokens/s and peak memory; the drops at
               the config's own factor; a prefill under 2s beside 1s;
               bucket_slots at the mesh's shapes by events and device
               time beside its plain version and bound;
  5m. train-mesh — deepseek-v2-lite-16b at 4 layers through the
               launcher's path under the mesh (``make_run``,
               ``dp_entry_for``, ``make_train_step(mesh=, dp_entry=)``
               behind the ``DoubleBufferedLoader``): 3 steps of 8 x 512
               tokens, A = 2, full remat, then the same unsharded: every
               loss finite, the mesh's bucket_slots launches equal to
               the code's count; at the capacity factor no shard drops
               at, step 0's loss under the mesh within 1e-2 relative of
               the unsharded step 0's. The median ms a step and peak
               memory of each;
  5p. train-pp — olmo-1b at full width trained by GPipe over the pod
               axis of a virtual (pod 2, data 2) mesh
               (``distributed/pipeline.py``): on one batch from a fresh
               state, step 0's loss within 1e-2 (relative) of
               ``loss_fn``'s and its gradients within 1e-2 of each
               leaf's max of ``make_train_step``'s (A = 1, unsharded),
               the forward's collective-permutes M + S - 1 = 5, each one
               (2, 512, 2048) bf16 block of one pod rank; then 4 steps
               of ``make_pp_train_step`` (8 x 512 tokens, M = 4, full
               remat) behind the ``DoubleBufferedLoader`` and 4
               unsharded steps on the same batches: losses finite,
               the pipelined ones falling and each within 1e-2
               (relative) of the unsharded step's, every step's
               permutes as step 0's, no kernel launched (the
               reference's pipeline reaches no Pallas kernel); ms a
               step by CUDA events, tokens/s and peak memory of each,
               the bubble fraction;
  2f. dryrun — the dry run (``launch/dryrun.py``): (a) in a child
               process, alone on the host (it needs no card;
               ``--dryrun-child``), ``DRYRUN_CELLS`` at full width on
               meta tensors over the production meshes (olmo-1b
               train_4k calibrated, prefill_32k, decode_32k and
               ``pp_pod``; deepseek-v2-lite-16b train_4k), every cell
               ``ok``, each cell's per-device argument bytes, FLOPs,
               collective bytes and seconds; (b) olmo-1b's prefill
               (``unroll=True``, plain path) at 8 x 2048 on meta and
               on the card under the same counters: FLOPs equal, the
               collective records equal, meta's peak live bytes within
               15 % of the rise of ``max_memory_allocated`` over the
               card's call;
  4s. smoke-serve — every arch of the registry at its SMOKE config,
               unmodified (head dims 16-32, whose flash_attention runs on
               the 16- and 32-column instantiations, 20 and 24 with the
               columns past hd zero; mamba2's and jamba's scans at P 16,
               N 16, chunk 16), through ``ServeEngine.generate`` in bf16:
               a batch of 4 prompts of 64 tokens (whisper 64 fp32 frames,
               internvl2 a 16-row fp32 prefix), 8 new tokens: the
               launches equal to the code's count (``serve_launches``:
               flash_attention once an attention layer and prefill,
               ssd_scan once an SSD layer and prefill, bucket_slots as in
               phase 4), the last prefill logits within 3e-2 *
               max|logits| of the plain path's on the card (jamba and
               internvl2, whose bf16 paths drift apart, with the weights
               upcast to fp32; the bf16 gap printed), prefill ms and
               decode ms a token;
  6. examples — the five ``examples/*_torch.py`` ports on the card, in a
               child each at a reduced size (the WordCount ones at 2**19
               tokens, ``train_lm_torch.py --steps 4``,
               ``serve_lm_torch.py --requests 8 --new-tokens 8``), side
               by side (wordcount_puma's walls beside the others' work):
               each exits 0; its seconds and last lines;
  7. report  — the ``kernels`` JSON line, the card's name and power
               limit, and the final ``{"ok": true, ...}`` line.

The launch counts are set to 0 just before each path (the entry points
of 2, the lint of 2c, the guard band of 2e, then 3, each job of 3b, 3c,
3d, 3g and 3j, each fleet of 3e and 3h, each run of 3f, each campaign
and each rank count's part of 3i, each arch of 4 and of 4s, each training
run of 5,
each engine's run of 4m and each training run of 5m and 5p) and read
just after it.

Exits non-zero, printing no result, when no CUDA card is present.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit rate
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
# the peak rate of a flash_attention call by its dtype: the bf16 kernel
# runs on the tensor cores, the fp32 one on the CUDA cores
FLOPS_PER_S = {"bfloat16": BF16_FLOPS_PER_S, "float32": SCALAR_OPS_PER_S}

# the documented fused configuration and its PUMA-like input: the PUMA
# Wikipedia corpus cut to 2**27 tokens (a fused run of 2**25 took under
# 20 s on an H100, so the input was raised to keep the run measurable)
VOCAB, N_PROCS, TASK, CAP, SEGMENT = 262_144, 8, 256, 64, 512
N_TOKENS = 2**27
# the fused-vs-unfused comparison's corpus: the unfused job takes ~4 us a
# token on an H100 (60.2-63.5 s at 2**24 on one host), so it runs at 2**22
# to keep the smoke, with 2f's dry run in line, under 950 s
N_UNFUSED = 2**22


# the served configurations at full width (width as published, depth as
# published unless ``SERVE_LAYERS`` cuts it), random weights from seed 0,
# and the requests each serves: one batch each, so that the MoE phases
# fit the smoke's time
REQUESTS, BATCH, PROMPT_LEN, NEW_TOKENS = 16, 8, 2048, 32
MOE_ARCH = "deepseek-v2-lite-16b"
HYBRID_ARCH = "jamba-v0.1-52b"
LLAMA4_ARCH = "llama4-maverick-400b-a17b"
VISION_ARCH = "internvl2-26b"
AUDIO_ARCH = "whisper-tiny"
SERVE_ARCHS = {"olmo-1b": BATCH, "mamba2-780m": BATCH,
               "h2o-danube-1.8b": BATCH, MOE_ARCH: BATCH, HYBRID_ARCH: BATCH,
               "codeqwen1.5-7b": BATCH, "stablelm-12b": BATCH,
               LLAMA4_ARCH: BATCH, VISION_ARCH: BATCH, AUDIO_ARCH: BATCH}
# depth cuts, the width kept: jamba-v0.1's 32 layers (51.5 B parameters,
# ~103 GB in bf16) do not fit one 80 GB card; one period of 8 layers
# (13.3 B, 26.5 GB) holds every layer kind of the family. deepseek-v2-lite's
# 27 layers took 58-78 s of the smoke on an H100 (its decode is host-bound,
# ~10,000 ops a step); the leading dense layer and 8 MoE layers keep every
# layer kind and the smoke within 800 s. llama4-maverick's 48 layers hold
# 397.7 B parameters; its first 2, one dense and one MoE layer of 128
# experts, hold 18.55 B (37.1 GB; 4 layers would take 70.1 GB).
# codeqwen1.5-7b's 32 layers: with internvl2-26b and whisper-tiny served
# the smoke took 827.8 s on an H100, past its 820 s aim; 8 of them (every
# layer is the same MHA layer with the qkv bias) keep the layer on the path.
# internvl2-26b's 48 layers and stablelm-12b's 40 (the phase's two longest
# serves, 43.6 and 29.5 s): with phases 4s and 6 the smoke took 988.4 s,
# past its 950 s aim; half of each stack (every layer of each is the same
# layer) keeps its layer on the path. mamba2-780m, the one SSM-only
# stack, stays whole
SERVE_LAYERS = {HYBRID_ARCH: 8, MOE_ARCH: 9, LLAMA4_ARCH: 2,
                "codeqwen1.5-7b": 8, VISION_ARCH: 24, "stablelm-12b": 20}


def _port():
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    import repro_torch.data as data
    from repro_torch.kernels import backend
    from repro_torch.kernels.fused_map import ops, ref
    return core, data, backend, ops, ref


def _fa():
    """The flash_attention kernel's wrapper and plain version."""
    _port()
    from repro_torch.kernels.flash_attention import ops, ref
    return ops, ref


def _ssd():
    """The ssd_scan kernel's wrapper and plain version."""
    _port()
    from repro_torch.kernels.ssd_scan import ops, ref
    return ops, ref


def _wc():
    """The wordcount histogram kernel's wrapper and plain versions."""
    _port()
    from repro_torch.kernels.wordcount_hash import ops, ref
    return ops, ref


def _slots():
    """The bucket-slot kernel's wrapper and plain version."""
    _port()
    from repro_torch.kernels.moe_dispatch import ops, ref
    return ops, ref


def _fd():
    """The flash_decode kernel's wrapper and plain versions."""
    _port()
    from repro_torch.kernels.flash_decode import ops, ref
    return ops, ref


def _lint():
    """The port's fleetlint: its corpus, CLI, and the mutant kernels'
    wrappers and plain versions."""
    _port()
    from repro_torch.analysis import corpus, lint
    from repro_torch.analysis.mutant_kernels import ops, ref
    return corpus, lint, ops, ref


def wrappers() -> dict:
    """Every kernel's name and its wrapper, which carries the count."""
    mutant_ops = _lint()[2]
    return {"fused_map": _port()[3].fused_map,
            "flash_attention": _fa()[0].flash_attention,
            "ssd_scan": _ssd()[0].ssd,
            "hist": _wc()[0].wordcount_hist,
            "bucket_slots": _slots()[0].bucket_slots,
            "flash_decode": _fd()[0].flash_decode,
            **{k: getattr(mutant_ops, k) for k in MUTANT_KERNELS.values()}}


def zero_counts():
    """Set every kernel's launch count to 0."""
    for fn in wrappers().values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    """One nvcc per kernel source, all started together."""
    _, _, backend, fm_ops, _ = _port()
    fa_src = _fa()[0].SOURCES
    ssd_src = _ssd()[0].SOURCES
    sources = {"fused_map": fm_ops.SOURCE,
               "flash_attention": fa_src[torch.bfloat16],
               "flash_attention_fp32": fa_src[torch.float32],
               "ssd_scan": ssd_src[torch.bfloat16],
               "ssd_scan_fp32": ssd_src[torch.float32],
               "hist": _wc()[0].SOURCE,
               "bucket_slots": _slots()[0].SOURCE,
               "flash_decode": _fd()[0].SOURCE,
               "mutants": _lint()[2].SOURCE}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {k: pool.submit(backend.build, v) for k, v in sources.items()}
        built = {k: f.result() for k, f in futures.items()}
    print(f"build: wall {time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        print(f"  {name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    return built


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def fused_case(seed: int, P: int, S: int, V: int, cap: int, rep, *,
               split=False, dupes=False, near_sat=False, task_id=None):
    """Seeded inputs of one fused step for P ranks (each rank its own
    records), following the reference kernel tests' generator."""
    sent = 2**31 - 1
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, V, (P, S)).astype(np.int32)
    if dupes:
        keys[:] = keys[:, :1]
    keys[rng.random((P, S)) < 0.15] = sent
    vals = rng.integers(0, 100, (P, S)).astype(np.int32)
    if near_sat:
        vals = (sent - rng.integers(0, 4, (P, S))).astype(np.int32)
    omap = rng.integers(0, P, (P, V)).astype(np.int32)
    osplit = np.ones((P, V), np.int32)
    if split:
        osplit[rng.random((P, V)) < 0.3] = rng.integers(2, P + 1)
    pk = rng.integers(0, V, (P, P, cap)).astype(np.int32)
    pk[rng.random((P, P, cap)) < 0.2] = sent
    pv = rng.integers(0, 50, (P, P, cap)).astype(np.int32)
    table = rng.integers(0, 1000, (P, V)).astype(np.int32)
    rep = np.broadcast_to(np.asarray(rep, np.int32), (P,)).copy()
    tid = (np.arange(P, dtype=np.int32) * 7 + seed if task_id is None
           else np.broadcast_to(np.asarray(task_id, np.int32), (P,)).copy())
    return dict(keys=keys, vals=vals, rep=rep, task_id=tid, owner_map=omap,
                owner_split=osplit, pending_k=pk, pending_v=pv,
                table=table), P, cap


def fused_matrix():
    """The reference kernel-test matrix (capacity-1 buckets, all-duplicate
    keys, near-SAT sums at several repeats, split-key routing, vocab not a
    multiple of a tile, S up to 1024), the sort's edges (S = 1, L = 2,000
    records at the shared-memory limit, an all-sentinel task, negative
    keys, a hot rank at rep 16), plus the full-width shapes."""
    sat = 2**31 - 1
    for i, (S, V, P, cap, rep) in enumerate(
            [(32, 256, 4, 8, 1), (64, 512, 8, 16, 1), (64, 500, 8, 16, 2),
             (128, 64, 4, 8, 3), (16, 2048, 2, 4, 1)]):
        yield f"sweep{i}", fused_case(i, P, S, V, cap, rep, split=True)
    yield "cap1", fused_case(10, 4, 48, 128, 1, 1)
    yield "all_dup", fused_case(11, 3, 32, 100, 4, 2, dupes=True)
    yield "S1", fused_case(18, 4, 1, 64, 2, [1, 2, 1, 3])
    yield "S1000_rep3", fused_case(19, 4, 1000, 4096, 32, 3, split=True)
    args, P, cap = fused_case(20, 4, 64, 256, 8, [1, 2, 1, 3])
    args["keys"][:] = sat
    yield "all_sentinel", (args, P, cap)
    args, P, cap = fused_case(21, 4, 96, 256, 8, [1, 3, 2, 1])
    rng = np.random.default_rng(21)       # signed order; ghost owner
    neg = rng.random(args["keys"].shape) < 0.3
    args["keys"][neg] = rng.choice([-2**31, -257, -256, -5, -1],
                                   int(neg.sum()))
    yield "negative_keys", (args, P, cap)
    yield "hot_rep16", fused_case(22, 8, 256, 4096, 16, [16] + [1] * 7)
    for rep in (1, 2, 3, 5, 8):
        yield f"near_sat_rep{rep}", fused_case(12, 4, 24, 128, 4, rep,
                                               near_sat=True)
    # wrap-negative sums: rep 1, 2, 3 give three different steps
    args, P, cap = fused_case(13, 3, 6, 16, 2, [1, 2, 3])
    args["keys"][:] = [3, 3, 5, 7, 7, 7]
    args["vals"][:] = [sat, 5, 1, sat, sat, 2]
    yield "wrap_negative_rep123", (args, P, cap)
    for tid in range(8):                       # a hot key over 4 replicas
        args, P, cap = fused_case(14, 8, 16, 64, 4, 1, task_id=tid)
        args["keys"][:] = 7
        args["owner_map"][:] = 0
        args["owner_split"][:] = 1
        args["owner_split"][:, 7] = 4
        yield f"split_tid{tid}", (args, P, cap)
    yield "S1024", fused_case(15, 4, 1024, 4096, 32, [1, 2, 1, 3],
                              split=True)
    yield "full_width", full_width_case()


def fused_wide_matrix():
    """Task sizes past 1,024, each side of every change of the kernel's
    block: 2,048 pairs (S 1,024) -> 4,096 (1,025-2,048), 8,192
    (2,049-4,096, the last in shared memory), 16,384 (4,097-8,192) and
    32,768 (8,193-16,384, both through the global scratch); at cap 1 and
    1,024, split keys, all-duplicate keys, near-SAT sums at rep 8,
    negative keys, an all-sentinel task and a hot rank at rep 16."""
    sat = 2**31 - 1
    yield "S1025_cap1", fused_case(30, 4, 1025, 4096, 1, [1, 2, 1, 3],
                                   split=True)
    yield "S2048_cap1024", fused_case(31, 4, 2048, 8192, 1024,
                                      [2, 1, 1, 1], split=True)
    args, P, cap = fused_case(32, 4, 2049, 4096, 64, [1, 3, 2, 1])
    rng = np.random.default_rng(32)
    neg = rng.random(args["keys"].shape) < 0.3
    args["keys"][neg] = rng.choice([-2**31, -4097, -4096, -5, -1],
                                   int(neg.sum()))
    yield "S2049_negative_keys", (args, P, cap)
    yield "S4096_near_sat_rep8", fused_case(33, 2, 4096, 512, 64, 8,
                                            near_sat=True)
    yield "S4096_hot_rep16", fused_case(34, 8, 4096, 65536, 1024,
                                        [16] + [1] * 7, split=True)
    yield "S4097_all_dup", fused_case(35, 3, 4097, 1000, 4, [2, 1, 3],
                                      dupes=True)
    yield "S8192_cap1024", fused_case(36, 4, 8192, 65536, 1024,
                                      [1, 2, 1, 3], split=True)
    yield "S8193_near_sat_rep8", fused_case(37, 2, 8193, 2048, 16, 8,
                                            near_sat=True)
    yield "S16384_cap1", fused_case(38, 2, 16384, 65536, 1, [1, 2])
    args, P, cap = fused_case(39, 2, 16384, 4096, 8, [1, 3])
    args["keys"][:] = sat
    yield "S16384_all_sentinel", (args, P, cap)
    yield "S16384_hot_rep16", fused_case(40, 8, 16384, 65536, 1024,
                                         [16] + [1] * 7, split=True)


def full_width_case():
    reps = [8] + [1] * (N_PROCS - 1)           # the hot rank of the job
    return fused_case(16, N_PROCS, TASK, VOCAB, CAP, reps)


def _on(args: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in args.items()}


def phase_kernel_vs_plain(device, cases) -> float:
    """Compare ``fused_map`` with ``fused_step_ref`` on every case, bit
    for bit on every output. Returns the max abs difference (0)."""
    _, _, _, ops, ref = _port()
    worst = 0
    for name, (args, P, cap) in cases:
        a = _on(args, device)
        want = ref.fused_step_ref(**a, n_procs=P, cap=cap)
        a["table"] = a["table"].clone()
        got = ops.fused_map(**a, n_procs=P, cap=cap)
        for out, g, w in zip(("table", "bk", "bv", "counts"), got, want):
            diff = (g.long() - w.long()).abs().max().item()
            worst = max(worst, diff)
            if not torch.equal(g, w):
                raise AssertionError(f"fused_map != plain on {name}: {out} "
                                     f"differs (max abs {diff})")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return float(worst)


def _event_ms(fn, iters: int) -> float:
    fn()                                   # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def window_slots(args: dict, P: int, cap: int) -> tuple[int, int]:
    """(unique keys after the record pass, window slots the step folds
    into), summed over the ranks. Only two kinds of record reach the
    window: the pending chunk and the records past ``cap`` of an owner's
    bucket, found here by the port's own composition on the host."""
    from repro_torch.core.kv import (KEY_SENTINEL, bucketize,
                                     local_reduce_repeated)
    from repro_torch.core.partition import lookup_owner
    a = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in args.items()}
    uk, uv = local_reduce_repeated(a["keys"], a["vals"], a["keys"].shape[1],
                                   a["rep"], int(a["rep"].max()))
    owners = lookup_owner(a["owner_map"], a["owner_split"], uk,
                          a["task_id"], P)
    _, _, _, (ofk, _) = bucketize(uk, uv, P, cap, owners=owners)
    folded = torch.cat([a["pending_k"].reshape(P, -1), ofk], dim=1)
    slots = sum(int(torch.unique(r[r != KEY_SENTINEL]).numel())
                for r in folded)
    return int((uk != KEY_SENTINEL).sum()), slots


def fused_bound(args: dict, P: int, cap: int) -> tuple[float, str, dict]:
    """Least time of one fused step on these inputs: bytes the step must
    move (each input read once, each output written once, the window
    read and written only at the slots the step folds into) over the
    memory rate, against the operations of a sort-based record pass
    over the scalar rate."""
    keys, rep = args["keys"], args["rep"]
    S = keys.shape[1]
    uniq, slots = window_slots(args, P, cap)
    nbytes = (2 * keys.size * 4 + 2 * P * 4      # records, rep, task id
              + 2 * uniq * 4                     # owner_map/split lookups
              + 2 * args["pending_k"].size * 4   # the pending chunk
              + 2 * slots * 4                    # window read+write
              + 2 * P * P * cap * 4 + P * P * 4)  # bk, bv, counts
    ops = sum(S * math.log2(S) + (max(int(r), 1) - 1) * 2 * S
              * math.log2(2 * S) for r in rep)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "ops": ops,
                                     "unique": uniq, "window_slots": slots}


def time_fused(device) -> dict:
    """Time per launch of the kernel at the full-width shapes, CUDA
    events around 200 launches back to back (``ms``) and the profiler's
    device time (``device_ms``), beside the step's bound and its plain
    version."""
    _, _, _, ops, ref = _port()
    args, P, cap = full_width_case()
    a = _on(args, device)
    ms = _event_ms(lambda: ops.fused_map(**a, n_procs=P, cap=cap), 200)
    device_ms = _device_ms(lambda: ops.fused_map(**a, n_procs=P, cap=cap),
                           200)[0]
    chain = {}                  # the hot rank's chain: rep 1 and 16 on it
    for rep0 in (1, 16):
        c = _on(fused_case(16, P, TASK, VOCAB, cap,
                           [rep0] + [1] * (P - 1))[0], device)
        chain[rep0] = _device_ms(
            lambda: ops.fused_map(**c, n_procs=P, cap=cap), 200)[0]
    plain_ms = _event_ms(lambda: ref.fused_step_ref(**a, n_procs=P, cap=cap),
                         20)
    bound_ms, bound_by, work = fused_bound(args, P, cap)
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                rep1_device_ms=chain[1], rep16_device_ms=chain[16],
                pass_ms=(chain[16] - chain[1]) / 15, **work,
                wide={S: time_fused_wide(device, S) for S in WIDE_TIMED})


# the task sizes timed past 1,024: the JobConfig default (fig9's) and
# fig8's largest, at fig9's width (P 8, cap 1024, V 65,536)
WIDE_TIMED = (4096, 16384)


def time_fused_wide(device, S: int) -> dict:
    """The kernel at task size ``S`` and fig9's width, its hot rank at rep
    1 and 8, by device time, beside its plain version and the bound at
    rep 8."""
    _, _, _, ops, ref = _port()
    w = IMBALANCE_W
    P, cap = w.n_procs, w.cap
    out = {}
    for rep0 in (1, 8):
        args = fused_case(16, P, S, w.vocab, cap, [rep0] + [1] * (P - 1))[0]
        a = _on(args, device)
        out[f"rep{rep0}_device_ms"] = _device_ms(
            lambda: ops.fused_map(**a, n_procs=P, cap=cap), 50)[0]
    out["ms"] = _event_ms(lambda: ops.fused_map(**a, n_procs=P, cap=cap),
                          50)
    out["plain_ms"] = _event_ms(
        lambda: ref.fused_step_ref(**a, n_procs=P, cap=cap), 5)
    bound_ms, bound_by, work = fused_bound(args, P, cap)
    out.update(bound_ms=bound_ms, bound_by=bound_by, **work,
               pass_ms=(out["rep8_device_ms"] - out["rep1_device_ms"]) / 7)
    return out


def print_fused_wide(wide: dict):
    w = IMBALANCE_W
    for S, t in wide.items():
        print(f"fused_map at P={w.n_procs} S={S} cap={w.cap} V={w.vocab}: "
              f"{t['rep1_device_ms']:.5f} / {t['rep8_device_ms']:.5f} ms a "
              f"launch on the device at rep 1 / 8 on rank 0 "
              f"({t['pass_ms']:.5f} ms a pass over L = {2 * S}; "
              f"{t['ms']:.5f} ms back to back at rep 8, events), plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}, {t['bytes']} B at 3.35 TB/s)")


# the reference's flash_attention test matrix (tests/test_kernels.py::
# test_flash_attention_sweep) and the served shape: (B, S, H, KV, hd,
# causal, window, dtype), and for k and v of another length than q, Skv
FLASH_MATRIX = {
    "mha_f32": (2, 256, 4, 4, 64, True, 0, "float32"),
    "gqa4_f32": (1, 512, 8, 2, 64, True, 0, "float32"),
    "mqa_hd128_f32": (2, 256, 4, 1, 128, True, 0, "float32"),
    "bidir_f32": (1, 384, 4, 4, 64, False, 0, "float32"),
    "swa128_f32": (1, 512, 4, 4, 64, True, 128, "float32"),
    "mha_bf16": (2, 256, 4, 4, 64, True, 0, "bfloat16"),
    "swa256_gqa_ragged640_bf16": (1, 640, 4, 2, 64, True, 256, "bfloat16"),
    # head dim 80 (h2o-danube-1.8b): bf16 GQA G = 4 over a ragged S, and
    # fp32 with a window
    "gqa4_hd80_ragged333_bf16": (1, 333, 8, 2, 80, True, 0, "bfloat16"),
    "swa96_hd80_f32": (1, 384, 4, 4, 80, True, 96, "float32"),
    # the tensor-core kernel's other branches: no causal mask (every KV
    # tile, kt_hi = n_kt), MQA (KV = 1), and Sq != Skv both ways, ragged
    # (TMA's zero fill on both tails); past Skv + window a row sees no key
    # and comes out 0
    "bidir_bf16": (1, 384, 4, 4, 64, False, 0, "bfloat16"),
    "mqa_hd128_bf16": (2, 256, 4, 1, 128, True, 0, "bfloat16"),
    "sq128_skv384_gqa_bf16": (1, 128, 8, 2, 64, True, 0, "bfloat16", 384),
    "sq384_skv128_bf16": (1, 384, 4, 4, 64, True, 0, "bfloat16", 128),
    "bidir_mqa_sq200_skv333_hd80_bf16": (1, 200, 8, 1, 80, False, 0,
                                         "bfloat16", 333),
    "swa64_sq512_skv192_bf16": (1, 512, 4, 2, 64, True, 64, "bfloat16",
                                192),
    # head dim 160 (stablelm-12b): in both dtypes GQA over a ragged S, a
    # window, no causal mask and Sq != Skv both ways (the bf16 kernel's
    # third panel, 32 columns in 64-byte swizzle, and its 2-stage ring;
    # the fp32 kernel's two tail columns)
    "gqa4_hd160_ragged333_bf16": (1, 333, 8, 2, 160, True, 0, "bfloat16"),
    "gqa2_hd160_ragged200_f32": (1, 200, 4, 2, 160, True, 0, "float32"),
    "swa96_hd160_ragged300_bf16": (1, 300, 4, 2, 160, True, 96, "bfloat16"),
    "swa64_hd160_f32": (1, 256, 4, 4, 160, True, 64, "float32"),
    "bidir_gqa_hd160_bf16": (1, 256, 4, 2, 160, False, 0, "bfloat16"),
    "bidir_hd160_ragged130_f32": (1, 130, 2, 2, 160, False, 0, "float32"),
    "sq128_skv384_gqa_hd160_bf16": (1, 128, 8, 2, 160, True, 0, "bfloat16",
                                    384),
    "sq320_skv130_hd160_bf16": (1, 320, 4, 4, 160, True, 0, "bfloat16",
                                130),
    "bidir_sq100_skv260_hd160_f32": (1, 100, 4, 2, 160, False, 0, "float32",
                                     260),
    "sq256_skv96_hd160_f32": (1, 256, 2, 1, 160, True, 0, "float32", 96),
    # the SMOKE configs' head dims (16: olmo, codeqwen, jamba, whisper; 20:
    # h2o-danube, window 32; 24: stablelm, internvl2; 32: llama4) and 48,
    # in both dtypes, causal, windowed and not; 16, 32 and 48 run on their
    # own widths (in bf16 through TMA), 20 and 24 on 32 with the columns
    # past hd zero (in bf16 through the producer's own loads: at hd 20
    # with KV 1 a row of k is 40 bytes, which TMA cannot stride), and 36
    # and 100 on 48 and 128
    "gqa2_hd16_ragged200_bf16": (1, 200, 4, 2, 16, True, 0, "bfloat16"),
    "hd16_ragged130_f32": (2, 130, 4, 4, 16, True, 0, "float32"),
    "mqa_hd20_bf16": (1, 200, 4, 1, 20, True, 0, "bfloat16"),
    "mqa_hd20_f32": (1, 200, 4, 1, 20, True, 0, "float32"),
    "swa32_hd20_gqa_ragged160_bf16": (1, 160, 4, 2, 20, True, 32,
                                      "bfloat16"),
    "swa32_hd20_gqa_f32": (1, 192, 4, 2, 20, True, 32, "float32"),
    "gqa2_hd24_ragged130_bf16": (2, 130, 4, 2, 24, True, 0, "bfloat16"),
    "bidir_hd24_bf16": (1, 192, 4, 4, 24, False, 0, "bfloat16"),
    "bidir_gqa_hd24_ragged100_f32": (1, 100, 4, 2, 24, False, 0, "float32"),
    "gqa2_hd32_bf16": (1, 256, 4, 2, 32, True, 0, "bfloat16"),
    "swa48_hd32_ragged300_bf16": (1, 300, 4, 4, 32, True, 48, "bfloat16"),
    "hd32_f32": (1, 192, 4, 4, 32, True, 0, "float32"),
    "gqa2_hd48_bf16": (1, 200, 4, 2, 48, True, 0, "bfloat16"),
    "bidir_sq100_skv260_hd48_bf16": (1, 100, 4, 2, 48, False, 0,
                                     "bfloat16", 260),
    "swa64_hd48_f32": (1, 256, 4, 2, 48, True, 64, "float32"),
    "gqa2_hd36_ragged150_bf16": (1, 150, 4, 2, 36, True, 0, "bfloat16"),
    "gqa2_hd100_bf16": (1, 200, 4, 2, 100, True, 0, "bfloat16"),
    "bidir_hd100_f32": (1, 130, 2, 2, 100, False, 0, "float32"),
    # the padded path of every width, causal and not, in both dtypes: 36
    # and 44 on 48, 100 on 128, 60 on 64, 76 on 80 (bf16: panel 1 of 16
    # columns in 32-byte swizzle) and 156 on 160 (bf16: the third panel
    # and the 2-stage ring)
    "bidir_hd36_ragged130_bf16": (1, 130, 4, 4, 36, False, 0, "bfloat16"),
    "swa32_hd36_gqa_f32": (1, 160, 4, 2, 36, True, 32, "float32"),
    "bidir_mqa_hd44_f32": (1, 100, 4, 1, 44, False, 0, "float32"),
    "gqa2_hd100_ragged150_f32": (1, 150, 4, 2, 100, True, 0, "float32"),
    "bidir_hd100_ragged130_bf16": (1, 130, 2, 2, 100, False, 0, "bfloat16"),
    "gqa2_hd60_ragged150_bf16": (1, 150, 4, 2, 60, True, 0, "bfloat16"),
    "bidir_hd60_bf16": (1, 192, 4, 4, 60, False, 0, "bfloat16"),
    "gqa2_hd60_ragged130_f32": (1, 130, 4, 2, 60, True, 0, "float32"),
    "bidir_mqa_hd60_f32": (1, 100, 4, 1, 60, False, 0, "float32"),
    "mqa_hd76_ragged200_bf16": (1, 200, 4, 1, 76, True, 0, "bfloat16"),
    "bidir_gqa_hd76_bf16": (1, 128, 4, 2, 76, False, 0, "bfloat16"),
    "swa48_hd76_f32": (1, 192, 4, 4, 76, True, 48, "float32"),
    "bidir_hd76_ragged100_f32": (1, 100, 2, 2, 76, False, 0, "float32"),
    "gqa2_hd156_ragged200_bf16": (1, 200, 4, 2, 156, True, 0, "bfloat16"),
    "bidir_sq130_skv260_hd156_bf16": (1, 130, 2, 2, 156, False, 0,
                                      "bfloat16", 260),
    "mqa_hd156_f32": (1, 192, 4, 1, 156, True, 0, "float32"),
    "bidir_gqa_hd156_ragged100_f32": (1, 100, 4, 2, 156, False, 0,
                                      "float32"),
}
# the served shapes: olmo-1b's prefill, and h2o-danube-1.8b's (its window
# of 4096 is wider than the prompt); h2o's heads at S 8192, where the
# window hides whole KV tiles at full width
FLASH_SERVED = (BATCH, PROMPT_LEN, 16, 16, 128, True, 0, "bfloat16")
FLASH_H2O = (BATCH, PROMPT_LEN, 32, 8, 80, True, 4096, "bfloat16")
FLASH_H2O_LONG = (1, 8192, 32, 8, 80, True, 4096, "bfloat16")
# jamba-v0.1's attention layer at prefill: GQA 32 / 8 at head dim 128
FLASH_JAMBA = (BATCH, PROMPT_LEN, 32, 8, 128, True, 0, "bfloat16")
# stablelm-12b's (GQA 32 / 8 at head dim 160), codeqwen1.5-7b's (MHA 32 at
# 128) and llama4-maverick's (GQA 40 / 8 at 128)
FLASH_STABLELM = (BATCH, PROMPT_LEN, 32, 8, 160, True, 0, "bfloat16")
FLASH_CODEQWEN = (BATCH, PROMPT_LEN, 32, 32, 128, True, 0, "bfloat16")
FLASH_LLAMA4 = (BATCH, PROMPT_LEN, 40, 8, 128, True, 0, "bfloat16")
# internvl2-26b's (GQA 48 / 8 at 128, a 512-row prefix and 1,536 text
# tokens), whisper-tiny's encoder (MHA 6 at 64 over its 1,024 frames,
# no causal mask, in fp32: the frames are fp32 and JAX's promotion keeps
# the encoder there) and its decoder's self-attention
FLASH_INTERNVL2 = (BATCH, PROMPT_LEN, 48, 8, 128, True, 0, "bfloat16")
FLASH_WHISPER_ENC = (BATCH, PROMPT_LEN // 2, 6, 6, 64, False, 0, "float32")
FLASH_WHISPER_DEC = (BATCH, PROMPT_LEN, 6, 6, 64, True, 0, "bfloat16")
FLASH_FULL = {"served": FLASH_SERVED, "h2o_served": FLASH_H2O,
              "h2o_long8192": FLASH_H2O_LONG, "jamba_served": FLASH_JAMBA,
              "stablelm_served": FLASH_STABLELM,
              "codeqwen_served": FLASH_CODEQWEN,
              "llama4_served": FLASH_LLAMA4,
              "internvl2_served": FLASH_INTERNVL2,
              "whisper_encoder_served": FLASH_WHISPER_ENC,
              "whisper_decoder_served": FLASH_WHISPER_DEC}
# the served shapes ``time_flash`` times, by the arch whose prefill has
# them (the first is olmo-1b's, the ``kernels`` line's headline)
FLASH_TIMED = {"olmo-1b": FLASH_SERVED, "h2o-danube-1.8b": FLASH_H2O,
               HYBRID_ARCH: FLASH_JAMBA, "stablelm-12b": FLASH_STABLELM,
               "codeqwen1.5-7b": FLASH_CODEQWEN, LLAMA4_ARCH: FLASH_LLAMA4,
               VISION_ARCH: FLASH_INTERNVL2,
               f"{AUDIO_ARCH} encoder": FLASH_WHISPER_ENC,
               AUDIO_ARCH: FLASH_WHISPER_DEC}


def flash_tol(dtype: str) -> dict:
    """The reference's ``_tol``: 2e-2 for bf16, 2e-3 for fp32."""
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=2e-3, rtol=2e-3))


def flash_inputs(case, device):
    """Seeded q, k, v of one case, made in fp32 and cast to its dtype; k
    and v have the case's Skv positions where it names one."""
    B, S, H, KV, hd, _, _, dtype = case[:8]
    Skv = case[8] if len(case) > 8 else S
    rng = np.random.default_rng(S + H)
    dt = getattr(torch, dtype)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=device, dtype=dt)
        for shape in ((B, S, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))


def phase_flash_vs_plain(device, cases: dict) -> dict:
    """Hold ``flash_attention`` to ``flash_attention_plain`` on every case
    at the case's tolerance. Returns the max abs difference per case."""
    fa_ops, fa_ref = _fa()
    errs = {}
    for name, case in cases.items():
        q, k, v = flash_inputs(case, device)
        causal, window, dtype = case[5:8]
        got = fa_ops.flash_attention(q, k, v, causal=causal,
                                     window=window).float()
        want = fa_ref.flash_attention_plain(q, k, v, causal=causal,
                                            window=window).float()
        tol = flash_tol(dtype)
        diff = (got - want).abs()
        errs[name] = diff.max().item()
        if not bool(torch.isfinite(got).all()) or bool(
                (diff > tol["atol"] + tol["rtol"] * want.abs()).any()):
            raise AssertionError(f"flash_attention != plain on {name}: max "
                                 f"abs err {errs[name]} ({tol})")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return errs


def flash_bound(case) -> tuple[float, str, dict]:
    """Least time of one attention call: the FLOPs of the (query, key)
    pairs the masks leave visible (2 products of 2 * hd each) at the
    peak rate of the case's dtype (bf16 on the tensor cores, fp32 on
    the CUDA cores, ``FLOPS_PER_S``), against q, k, v read once and o
    written once at the memory rate."""
    B, S, H, KV, hd, causal, window, dtype = case
    qp = np.arange(S)
    hi = qp + 1 if causal else np.full(S, S)
    lo = np.maximum(0, qp - window + 1) if window > 0 else np.zeros(S)
    pairs = int((hi - lo).sum())
    flops = 4 * B * H * hd * pairs
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * \
        torch.finfo(getattr(torch, dtype)).bits // 8
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"flops": flops, "bytes": nbytes}


def time_flash(device) -> dict:
    """CUDA-event time per call at each served shape of ``FLASH_TIMED``,
    by arch: the kernel, its plain version and
    ``scaled_dot_product_attention`` (the library yardstick, never on the
    port's path; ``enable_gqa`` for GQA; h2o's 4096 window is wider than
    the prompt, so ``is_causal`` is the same function), beside the
    bound; and the fp32 kernel on the same shape in fp32 (``fp32_ms``,
    on the CUDA cores, whose fp32 bound is 14.8x the bf16 one; for an
    fp32 case, whisper's encoder, that is ``ms``)."""
    fa_ops, fa_ref = _fa()
    out = {}
    for name, case in FLASH_TIMED.items():
        causal, window, dtype = case[5:8]
        fp32_ms = None
        if dtype != "float32":
            q, k, v = flash_inputs(case[:7] + ("float32",), device)
            fp32_ms = _event_ms(lambda: fa_ops.flash_attention(
                q, k, v, causal=causal, window=window), 5)
        q, k, v = flash_inputs(case, device)
        ms = _event_ms(lambda: fa_ops.flash_attention(
            q, k, v, causal=causal, window=window), 20)
        plain_ms = _event_ms(lambda: fa_ref.flash_attention_plain(
            q, k, v, causal=causal, window=window), 3)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=case[2] != case[3])
        library_ms = _event_ms(sdpa, 20)
        sdpa_err = (sdpa().transpose(1, 2).float() - fa_ops.flash_attention(
            q, k, v, causal=causal, window=window).float()).abs().max().item()
        bound_ms, bound_by, work = flash_bound(case)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         fp32_ms=ms if fp32_ms is None else fp32_ms,
                         sdpa_vs_kernel_max_abs=sdpa_err,
                         bound_ms=bound_ms, bound_by=bound_by,
                         shape=case[:7], dtype=dtype, **work)
        del q, k, v
    return out


# the reference's ssd_scan test matrix (tests/test_kernels.py::
# test_ssd_scan_sweep; its "ragged" 384/128 divides), a truly ragged S, a
# two-group case, a case whose decay overflows above the diagonal, in bf16
# a single row, S below one chunk, a chain of 32 chunks, four groups at the
# served P and N, the overflow and the (P, N) pairs not covered above, and
# the served shape: (B, S, H, P, N, G, chunk, dtype of x/B/C, dtype of dt,
# A of every head with dt = 1, or None for the reference's random dt, A)
SSD_MATRIX = {
    "sweep0_f32": (2, 512, 4, 64, 32, 1, 128, "float32", "float32", None),
    "sweep1_f32": (1, 256, 8, 32, 16, 1, 64, "float32", "float32", None),
    "sweep2_f32": (1, 384, 4, 64, 32, 1, 128, "float32", "float32", None),
    "sweep3_bf16": (2, 256, 4, 64, 16, 1, 128, "bfloat16", "float32", None),
    "ragged200_f32": (1, 200, 4, 32, 16, 1, 64, "float32", "float32", None),
    "g2_ragged320_bf16": (1, 320, 8, 64, 32, 2, 128, "bfloat16", "bfloat16",
                          None),
    # cum falls by 50 a row: exp(cum_i - cum_j) is inf for j > i + 1
    "overflow_f32": (1, 160, 2, 32, 16, 1, 64, "float32", "float32", -50.0),
    "s1_bf16": (2, 1, 4, 64, 32, 1, 256, "bfloat16", "bfloat16", None),
    "s37_bf16": (1, 37, 4, 32, 16, 1, 64, "bfloat16", "float32", None),
    "chain32_bf16": (1, 2048, 2, 64, 128, 1, 64, "bfloat16", "bfloat16",
                     None),
    "g4_bf16": (1, 256, 8, 64, 128, 4, 128, "bfloat16", "bfloat16", None),
    "overflow_bf16": (1, 160, 2, 32, 16, 1, 64, "bfloat16", "bfloat16",
                      -50.0),
    "p32n128_bf16": (2, 192, 4, 32, 128, 2, 64, "bfloat16", "float32", None),
    "p32n32_bf16": (1, 320, 4, 32, 32, 1, 128, "bfloat16", "bfloat16", None),
    # the SMOKE configs' scan (mamba2, jamba: P 16, N 16, chunk 16) and
    # chunks that are not a multiple of 64 rows: 32 over a ragged S, 48,
    # 80 (a chunk of a whole and a short 64-row tile), an overflowing
    # decay at chunk 16, P 16 at N 32 and 128
    "p16_chunk16_bf16": (2, 64, 8, 16, 16, 1, 16, "bfloat16", "bfloat16",
                         None),
    "p16_chunk16_f32": (2, 64, 8, 16, 16, 1, 16, "float32", "float32",
                        None),
    "p16_chunk32_ragged100_bf16": (1, 100, 8, 16, 16, 1, 32, "bfloat16",
                                   "float32", None),
    "p16_chunk32_ragged100_f32": (1, 100, 4, 16, 16, 1, 32, "float32",
                                  "float32", None),
    "overflow_p16_chunk16_bf16": (1, 80, 2, 16, 16, 1, 16, "bfloat16",
                                  "bfloat16", -50.0),
    "p16n128_chunk16_bf16": (1, 64, 4, 16, 128, 1, 16, "bfloat16",
                             "bfloat16", None),
    "p16n32_g2_chunk32_f32": (1, 96, 4, 16, 32, 2, 32, "float32", "float32",
                              None),
    "p32_g2_chunk48_ragged150_f32": (1, 150, 4, 32, 16, 2, 48, "float32",
                                     "float32", None),
    "p64n32_chunk80_ragged200_bf16": (1, 200, 4, 64, 32, 1, 80, "bfloat16",
                                      "bfloat16", None),
}
SSD_SERVED = (BATCH, PROMPT_LEN, 48, 64, 128, 1, 256, "bfloat16", "bfloat16",
              None)
# jamba-v0.1's SSD layers at prefill: 128 heads of 64, state 16
SSD_JAMBA = (BATCH, PROMPT_LEN, 128, 64, 16, 1, 256, "bfloat16", "bfloat16",
             None)
SSD_FULL = {"served": SSD_SERVED, "jamba_served": SSD_JAMBA}


def ssd_inputs(case, device):
    """Seeded x, dt, A, B, C of one case, following the reference test's
    generator: x, B, C standard normal, dt = softplus(normal), A =
    -exp(normal) in fp32 (or dt = 1 and the case's A), each cast to its
    dtype."""
    Bb, S, H, P, N, G, _, dtype, dt_dtype, a_value = case
    rng = np.random.default_rng(S + N)
    x = rng.standard_normal((Bb, S, H, P), np.float32)
    dt = np.logaddexp(rng.standard_normal((Bb, S, H), np.float32), 0)
    A = -np.exp(rng.standard_normal((H,), np.float32))
    if a_value is not None:
        dt, A = np.ones_like(dt), np.full_like(A, a_value)
    Bm = rng.standard_normal((Bb, S, G, N), np.float32)
    C = rng.standard_normal((Bb, S, G, N), np.float32)

    def on(a, dt_):
        return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dt_))
    return (on(x, dtype), on(dt, dt_dtype), on(A, "float32"), on(Bm, dtype),
            on(C, dtype))


def phase_ssd_vs_plain(device, cases: dict) -> dict:
    """Hold ``ssd`` to ``ssd_plain`` on every case, y and the final state
    at the reference's per-dtype tolerance (``flash_tol``: the same
    ``_tol``). Returns the max abs difference per case."""
    ssd_ops, ssd_ref = _ssd()
    errs = {}
    for name, case in cases.items():
        args = ssd_inputs(case, device)
        chunk, dtype = case[6], case[7]
        got = ssd_ops.ssd(*args, chunk=chunk)
        want = ssd_ref.ssd_plain(*args, chunk=chunk)
        tol = flash_tol(dtype)
        errs[name] = 0.0
        for what, g, w in zip(("y", "state"), got, want):
            g, w = g.float(), w.float()
            diff = (g - w).abs()
            errs[name] = max(errs[name], diff.max().item())
            if not bool(torch.isfinite(g).all()) or bool(
                    (diff > tol["atol"] + tol["rtol"] * w.abs()).any()):
                raise AssertionError(f"ssd != plain on {name}: {what} max "
                                     f"abs err {diff.max().item()} ({tol})")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return errs


def ssd_bound(case) -> tuple[float, str, dict]:
    """Least time of one scan: x, dt, A, B, C read once and y and the
    state written once at the memory rate, against the FLOPs these
    inputs need at the rate of their type (bf16 tensor cores, else the
    fp32 rate): the visible (i >= j) pairs of each chunk (C·B and the
    product with x·dt, 2(N + P) each), the carried-in term of every row
    past the first chunk (the state is zero before it) and every row's
    state update (2PN each)."""
    Bb, S, H, P, N, G, chunk, dtype, dt_dtype, _ = case
    size = torch.finfo(getattr(torch, dtype)).bits // 8
    dt_size = torch.finfo(getattr(torch, dt_dtype)).bits // 8
    nbytes = (2 * Bb * S * H * P * size + Bb * S * H * dt_size + H * 4
              + 2 * Bb * S * G * N * size + Bb * H * P * N * 4)
    lens = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    per_head = (sum(n * (n + 1) // 2 for n in lens) * 2 * (N + P)
                + 2 * P * N * (S - lens[0]) + 2 * P * N * S)
    flops = Bb * H * per_head
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else SCALAR_OPS_PER_S
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"flops": flops, "bytes": nbytes}


def _plain_scores_bf16(x, dt, A, B, C, chunk):
    """The control of ``check_ssd_bits``: ``ssd_plain`` with the decayed
    scores (C Bᵀ ∘ L times dt_j) rounded to one bf16 before the product
    with x, as a kernel that gave the tensor cores bf16 scores would
    compute. Returns y."""
    Bb, S, H, P = x.shape
    rep = H // B.shape[2]
    chunk = min(chunk, S)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    state = torch.zeros((Bb, H, P, B.shape[3]), device=x.device)
    y = torch.empty_like(x)
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        n = c1 - c0
        xc, dtc = xf[:, c0:c1].transpose(1, 2), dtf[:, c0:c1].transpose(1, 2)
        Bc, Cc = Bh[:, c0:c1].transpose(1, 2), Ch[:, c0:c1].transpose(1, 2)
        cum = torch.cumsum(dtc * Af[None, :, None], -1)
        L = torch.where(causal[:n, :n],
                        torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        M = (Cc @ Bc.transpose(-1, -2)) * L * dtc[..., None, :]
        yc = M.bfloat16().float() @ xc + (
            Cc @ state.transpose(-1, -2)) * torch.exp(cum)[..., None]
        y[:, c0:c1] = yc.transpose(1, 2).to(x.dtype)
        last = cum[..., -1:]
        upd = (xc * (dtc * torch.exp(last - cum))[..., None]).transpose(
            -1, -2) @ Bc
        state = state * torch.exp(last)[..., None] + upd
    return y


def check_ssd_bits(device, cases: dict) -> dict:
    """For each bf16 case, the share of ``ssd``'s y outputs whose bits
    differ from ``ssd_plain``'s, and the share of the control's
    (``_plain_scores_bf16``). The kernel hands the tensor cores its fp32
    operands as bf16 parts, so its outputs leave the plain version's only
    where fp32 sums in another order cross a bf16 rounding step; scores
    rounded to one bf16 move a large share of them. Raises where the
    kernel's share is not below a quarter of the control's."""
    ssd_ops, ssd_ref = _ssd()
    shares = {}
    for name, case in cases.items():
        if case[7] != "bfloat16":
            continue
        args = ssd_inputs(case, device)
        chunk = case[6]
        want = ssd_ref.ssd_plain(*args, chunk=chunk)[0]
        kernel = (ssd_ops.ssd(*args, chunk=chunk)[0] != want).float().mean()
        control = (_plain_scores_bf16(*args, chunk) != want).float().mean()
        kernel, control = kernel.item(), control.item()
        if kernel > control / 4:
            raise AssertionError(f"ssd_scan on {name}: {kernel} of y leave "
                                 f"the plain version's bits, scores rounded "
                                 f"to bf16 {control}")
        shares[name] = {"kernel": kernel, "scores_bf16": control}
    return shares


def time_ssd(device) -> dict:
    """At the served shapes (mamba2-780m's, and jamba-v0.1's under
    ``"jamba"``): CUDA-event and profiler device time per call of the bf16
    kernel, its device kernels a call (checked against the wrapper's
    ``DEVICE_KERNELS``), and the plain version's, beside the bound; at
    mamba2's also the fp32 kernel's event time on the same inputs in
    fp32. No single PyTorch call computes the scan, so there is no
    library time."""
    ssd_ops, ssd_ref = _ssd()
    out = {}
    for name, case in (("mamba2", SSD_SERVED), ("jamba", SSD_JAMBA)):
        args = ssd_inputs(case, device)
        chunk = case[6]
        run = lambda: ssd_ops.ssd(*args, chunk=chunk)   # noqa: E731
        ms = _event_ms(run, 20)
        expect = ssd_ops.DEVICE_KERNELS[torch.bfloat16]
        device_ms, kernels, per_call = _device_ms(run, 20, tries=5,
                                                  per_call=expect)
        assert round(per_call) == expect, (per_call, kernels)
        if name == "mamba2":
            args32 = ssd_inputs((*case[:7], "float32", "float32", None),
                                device)
            fp32_ms = _event_ms(lambda: ssd_ops.ssd(*args32, chunk=chunk), 5)
            del args32
        plain_ms = _event_ms(lambda: ssd_ref.ssd_plain(*args, chunk=chunk),
                             3)
        bound_ms, bound_by, work = ssd_bound(case)
        out[name] = dict(ms=ms, device_ms=device_ms,
                         device_kernels=round(per_call),
                         device_kernel_names=kernels, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by, **work)
        del args
    return {**out["mamba2"], "fp32_ms": fp32_ms, "jamba": out["jamba"]}


# ---------------------------------------------------------------------------
# 2b. the entry-point kernels: hist, bucket_slots, flash_decode
# ---------------------------------------------------------------------------

SENT = 2**31 - 1

# the reference's wordcount_hist matrix (tests/test_kernels.py::
# test_wordcount_hist_sweep, ..._with_sentinels) and edge cases: keys below
# 0 and at or past vocab, vocabs that are no multiple of the TPU's 512-key
# tile, all tokens SENTINEL, one token, owner mode into fewer bins than
# hash_mod; the CUDA kernel's limits: vocab at and one past its 16 keys
# counted a thread and its 40,960 keys counted a CTA (the keys at both ends
# present), owner mode at and past 16 bins and into the CTA's counters,
# hash_mod 2**31 - 1 and a non-power of two near it (tokens whose hashes
# land at the ends of the divisor's periods), n a multiple of the 4-token
# vector plus 3, and Zipf tokens with runs that give whole warps one key
# (a counter of a thread, of the CTA, and a global one): (n, vocab,
# hash_mod, kind of tokens)
HIST_MATRIX = {
    "sweep0": (256, 128, 0, "uniform"),
    "sweep1": (1024, 512, 0, "uniform"),
    "sweep2_vocab1000": (4096, 1000, 0, "uniform"),
    "sweep3_owner8": (1024, 512, 8, "uniform"),
    "sweep4_owner16": (2048, 300, 16, "uniform"),
    "sentinels": (256, 8, 0, "sentinels"),
    "out_of_range": (256, 8, 0, "out_of_range"),
    "wide_vocab777": (3000, 777, 0, "wide"),
    "wide_owner8": (3000, 777, 8, "wide"),
    "all_sentinel": (1000, 600, 0, "all_sentinel"),
    "one_token": (1, 5, 0, "uniform"),
    "owner8_into5": (1500, 5, 8, "uniform"),
    "vocab16": (2048, 16, 0, "ends"),
    "vocab17": (2048, 17, 0, "ends"),
    "vocab40960": (2048, 40960, 0, "ends"),
    "vocab40961": (2048, 40961, 0, "ends"),
    "owner16": (2048, 16, 16, "uniform"),
    "owner17": (2048, 17, 17, "uniform"),
    "owner5000_into4000": (2048, 4000, 5000, "uniform"),
    "hash_mod_2p31m1": (2048, 25000, 2**31 - 1, "hash_ends"),
    "hash_mod_2147483629": (2048, 25000, 2_147_483_629, "hash_ends"),
    "hash_mod_2p31m1_into16": (2048, 16, 2**31 - 1, "hash_ends"),
    "n4099": (4099, 1000, 0, "uniform"),
    "zipf_warp_runs": (2048, 50000, 0, "zipf_runs"),
}


def _unmix32(h: np.ndarray) -> np.ndarray:
    """The tokens (int32) whose Murmur3 fmix32 is ``h`` (uint32 values):
    fmix32 is a bijection, undone step by step (xorshifts and the
    multiplicative inverses of its two constants mod 2**32)."""
    m32 = np.uint64(0xFFFFFFFF)
    h = h.astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x7ED1B41D)) & m32
    h ^= (h >> np.uint64(13)) ^ (h >> np.uint64(26))
    h = (h * np.uint64(0xA5CB9243)) & m32
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32).view(np.int32)


def hist_tokens(case) -> np.ndarray:
    """Seeded tokens of one HIST_MATRIX case."""
    n, vocab, mod, kind = case
    rng = np.random.default_rng(n + vocab)
    if kind in ("uniform", "ends"):
        t = rng.integers(0, vocab, n).astype(np.int32)
        if kind == "ends":
            t[:4] = [0, vocab - 1, vocab - 1, vocab - 2]
        return t
    if kind == "wide":                 # keys in [-vocab - 3, 2 vocab)
        t = rng.integers(-vocab - 3, 2 * vocab, n)
        t[rng.random(n) < 0.1] = SENT
        t[:3] = [-2**31, -1, SENT - 1]
        return t.astype(np.int32)
    if kind == "hash_ends":            # hashes k * mod + r, r < vocab + 8
        k = rng.integers(0, 2**32 // mod, n)
        h = k * mod + rng.integers(0, vocab + 8, n)
        h[:6] = [mod - 1, mod, mod + 1, 2**32 - 1, 2**32 - 2, 0]
        return _unmix32(np.minimum(h, 2**32 - 1))
    if kind == "zipf_runs":            # warp-wide runs of one key
        t = (rng.zipf(1.3, n) % vocab).astype(np.int32)
        for start, key in ((64, 1), (256, 700), (512, vocab - 1)):
            t[start: start + 128] = key
        return t
    head = {"sentinels": [1, 2, 1, SENT, 3, SENT],
            "out_of_range": [-1, -2, 3, 8, 9, 3, 5],
            "all_sentinel": []}[kind]
    return np.array(head + [SENT] * (n - len(head)), np.int32)


# the reference's bucket_slots matrix (tests/test_kernels.py::
# test_moe_bucket_slots_sweep) and edge cases: invalid ids (-1, E and
# 2**31 - 1), all ids equal, one record, a record past the first 1,024-id
# block, the most experts the kernel takes; the CUDA kernel's limits: T
# one below, at and one above its tile (1,024 ids at these sizes) and
# two tiles, one id in every tile and in a run across a tile's edge (the
# carry crosses tiles), every id invalid, one expert, 256 experts over
# eight tiles, a T that is no multiple of 4, and llama4-maverick's expert
# buffers at prefill (5,121 records at E 128, a fifth of them empty):
# (T, E, kind of ids)
SLOTS_MATRIX = {
    "sweep0": (256, 8, "uniform"),
    "sweep1": (1024, 16, "uniform"),
    "sweep2": (512, 64, "uniform"),
    "sweep3": (333, 7, "uniform"),
    "invalid": (2000, 16, "invalid"),
    "all_equal": (3000, 8, "equal"),
    "T1": (1, 4, "uniform"),
    "T1025": (1025, 32, "uniform"),
    "E256": (5000, 256, "uniform"),
    "T1023": (1023, 16, "uniform"),
    "T1024": (1024, 32, "uniform"),
    "T2047": (2047, 16, "uniform"),
    "T2048": (2048, 16, "uniform"),
    "T2049": (2049, 16, "uniform"),
    "repeat_across_tiles": (8192, 16, "repeat"),
    "all_invalid": (3000, 8, "all_invalid"),
    "E1": (4100, 1, "invalid"),
    "E256_eight_tiles": (8192, 256, "uniform"),
    "T4099": (4099, 32, "uniform"),
    "E128_llama4": (5121, 128, "invalid"),
}
# card only (too long for the Pallas kernel's interpret mode): tiles
# enough that the kernel's look-back over earlier tiles takes several
# rounds (32 tiles a round at E = 256, 128 at E = 64, 256 at E = 9; 98,
# 256 and 513 tiles of 4, 8 and 8 ids a thread on 132 SMs)
SLOTS_LOOKBACK = {
    "lookback_E256": (400_000, 256, "uniform"),
    "lookback_E64": (2**21, 64, "repeat"),
    "lookback_E9": (2**22 + 3, 9, "invalid"),
}


def slot_ids(case) -> np.ndarray:
    """Seeded ids of one SLOTS_MATRIX or SLOTS_LOOKBACK case."""
    T, E, kind = case
    rng = np.random.default_rng(T * E)
    ids = rng.integers(0, E, T)
    if kind == "invalid":
        bad = rng.random(T) < 0.3
        ids[bad] = rng.choice([-1, E, SENT], int(bad.sum()))
    elif kind == "all_invalid":
        ids = rng.choice([-1, E, SENT, -2**31], T)
    elif kind == "equal":
        ids[:] = 5
    elif kind == "repeat":      # id 3 in every tile, and 80 across a tile edge
        ids[::5] = 3
        ids[T // 2 - 40: T // 2 + 40] = 3
    return ids.astype(np.int32)


# the reference's flash_decode matrix (tests/test_kernels.py::
# test_flash_decode_sweep, ..._masks_future_slots) and edge cases: t = 0,
# 1, S and S + 5, G = 4 at hd 80 (h2o-danube-1.8b's heads): (B, S, H, KV,
# hd, t, dtype)
DECODE_MATRIX = {
    "sweep0_f32": (2, 512, 8, 2, 64, 300, "float32"),
    "sweep1_f32": (1, 1024, 4, 4, 64, 1023, "float32"),
    "mqa_hd128_t17_f32": (4, 256, 8, 1, 128, 17, "float32"),
    "sweep3_bf16": (2, 512, 8, 2, 64, 300, "bfloat16"),
    "future_hd32_f32": (1, 256, 2, 2, 32, 64, "float32"),
    "t0_f32": (1, 256, 4, 2, 64, 0, "float32"),
    "t1_f32": (1, 256, 4, 2, 64, 1, "float32"),
    "tS_f32": (1, 256, 4, 2, 64, 256, "float32"),
    "tS5_bf16": (1, 256, 4, 2, 64, 261, "bfloat16"),
    "g4_hd80_f32": (2, 384, 8, 2, 80, 200, "float32"),
    "g4_hd80_bf16": (2, 384, 8, 2, 80, 383, "bfloat16"),
    # the kernel's ring (4 stages of 32 keys): 600 heads take one split
    # each on any H100, so a split of 3 tiles, fewer than the stages, and
    # t at the ring's first wrap (128 keys) and one either side of it
    "ring_short_bf16": (75, 96, 8, 8, 32, 90, "bfloat16"),
    "wrap127_f32": (75, 192, 8, 8, 32, 127, "float32"),
    "wrap128_g2_bf16": (75, 192, 16, 8, 32, 128, "bfloat16"),
    "wrap129_f32": (75, 192, 8, 8, 32, 129, "float32"),
    # k and v as views of the first S positions of a max_len cache
    "view_maxlen_bf16": (2, 300, 8, 2, 128, 290, "bfloat16", 1024),
    "g16_hd128_bf16": (2, 512, 32, 2, 128, 500, "bfloat16"),
    "hd80_long_f32": (2, 1500, 8, 2, 80, 1499, "float32"),
}
# decode on the served caches (prompt 2048 + 32 new tokens): olmo-1b, and
# h2o-danube-1.8b's grouped heads
DECODE_FULL = {
    "olmo-1b": (BATCH, PROMPT_LEN + NEW_TOKENS, 16, 16, 128,
                PROMPT_LEN + NEW_TOKENS - 1, "bfloat16"),
    "h2o-danube-1.8b": (BATCH, PROMPT_LEN + NEW_TOKENS, 32, 8, 80,
                        PROMPT_LEN + NEW_TOKENS - 1, "bfloat16"),
}
# the served caches in fp32, held at its tighter tolerance: 7 and 4 tiles
# a split on 132 SMs, so the online softmax rescales across tiles
DECODE_FULL_F32 = {f"{arch}_f32": case[:-1] + ("float32",)
                   for arch, case in DECODE_FULL.items()}
# deepseek-v2-lite's routing of one served batch: 8 x 2048 tokens, each to
# 6 of 64 experts
ROUTING = (BATCH * PROMPT_LEN * 6, 64)


def decode_inputs(case, device):
    """Seeded q, k, v of one case, made in fp32 and cast to its dtype; a
    case with an 8th entry, max_len, gets k and v as views of the first S
    positions of (B, max_len, KV, hd) caches."""
    B, S, H, KV, hd, t, dtype = case[:7]
    max_len = case[7] if len(case) > 7 else S
    rng = np.random.default_rng(S + t)
    dt = getattr(torch, dtype)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=device, dtype=dt)
        for shape in ((B, H, hd), (B, max_len, KV, hd), (B, max_len, KV, hd)))
    return q, k[:, :S], v[:, :S]


def _int_diff(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0


def decode_case(case, device) -> dict:
    """One flash_decode case: its seeded inputs with t as a device tensor,
    and calls of the entry point and of its plain version on them."""
    fd_ops, fd_ref = _fd()
    q, k, v = decode_inputs(case, device)
    t_dev = torch.tensor(case[5], dtype=torch.int32, device=device)
    return dict(kernel="flash_decode", exact=False, dtype=case[6],
                args=(q, k, v, t_dev), t=case[5],
                run=functools.partial(fd_ops.flash_decode, q, k, v, t_dev),
                plain=lambda: fd_ref.flash_decode_plain(q, k, v, t_dev))


def matrix_cases(device, hist=HIST_MATRIX, slots=SLOTS_MATRIX,
                 decode=DECODE_MATRIX) -> dict:
    """The three entry-point kernels' matrices in ``entry_cases``' form:
    each case names its kernel and holds zero-argument calls of the entry
    point (a ``functools.partial`` that carries its inputs) and of its
    plain version."""
    wc_ops, wc_ref = _wc()
    sl_ops, sl_ref = _slots()
    cases = {}
    for name, case in hist.items():
        tokens = torch.from_numpy(hist_tokens(case)).to(device)
        _, vocab, mod, _ = case
        cases[f"hist_{name}"] = dict(
            kernel="hist", exact=True,
            run=functools.partial(wc_ops.wordcount_hist, tokens, vocab, mod),
            plain=functools.partial(wc_ref.hist_plain, tokens, vocab,
                                    hash_mod=mod))
    for name, (T, E, kind) in slots.items():
        ids = torch.from_numpy(slot_ids((T, E, kind))).to(device)
        cases[f"slots_{name}"] = dict(
            kernel="bucket_slots", exact=True,
            run=functools.partial(sl_ops.bucket_slots, ids, E),
            plain=functools.partial(sl_ref.bucket_slots_ref, ids, E))
    for name, case in decode.items():
        cases[f"decode_{name}"] = decode_case(case, device)
    return cases


def _check_decode(name, got, want, dtype) -> float:
    """Max abs error of ``got``; raises past the reference's per-dtype
    tolerance, whose atol is scaled down by max|want| where that is below
    1: over a long cache the output averages down to a few hundredths,
    where the plain atol would pass a dropped tile."""
    tol = flash_tol(dtype)
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    atol = tol["atol"] * min(1.0, want.abs().max().item())
    if not bool(torch.isfinite(got).all()) or bool(
            (diff > atol + tol["rtol"] * want.abs()).any()):
        raise AssertionError(f"flash_decode != plain on {name}: max abs err "
                             f"{diff.max().item()} (atol {atol}, rtol "
                             f"{tol['rtol']})")
    return diff.max().item()


def check_cases(cases: dict, outs: dict | None = None) -> dict:
    """Hold each case's output (``outs``, else one call of its entry point)
    to its plain version: bit for bit, every output, for hist and
    bucket_slots; at ``_check_decode``'s tolerance for flash_decode.
    Returns the max abs difference per case."""
    errs = {}
    for name, c in cases.items():
        got = outs[name] if outs is not None else c["run"]()
        want = c["plain"]()
        if c["exact"]:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, x in zip(got, want, strict=True):
                if not torch.equal(g, x):
                    raise AssertionError(f"{name} != plain (max abs "
                                         f"{_int_diff(g, x)})")
            errs[name] = 0
        else:
            errs[name] = _check_decode(name, got, want, c["dtype"])
    return errs


def _plain_p_bf16(q, k, v, t):
    """The control of ``check_decode_bits``: ``flash_decode_plain`` with p
    rounded to bf16 before P·V, as a kernel that gave the tensor cores
    bf16 p would compute."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    s = torch.einsum("bkgh,bskh->bkgs",
                     q.float().reshape(B, KV, H // KV, hd) * hd ** -0.5,
                     k.float())
    valid = torch.arange(S, device=q.device) < t
    s = s.masked_fill(~valid, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~valid, 0.0)
    o = torch.einsum("bkgs,bskh->bkgh", p.bfloat16().float(), v.float())
    o = o / p.sum(-1).clamp_min(1e-30)[..., None]
    return o.reshape(B, H, hd).to(q.dtype)


def check_decode_bits(cases: dict, outs: dict | None = None) -> dict:
    """For each bf16 flash_decode case, the share of outputs (``outs``,
    else one call of its entry point) whose bits differ from the plain
    version's, and the share of the control's (``_plain_p_bf16``). The
    kernel's P·V takes fp32 p, so its outputs leave the plain version's
    only where fp32 sums in another order cross a bf16 rounding step;
    p rounded to bf16 moves a large share of them. Raises where the
    kernel's share is not below a quarter of the control's."""
    shares = {}
    for name, c in cases.items():
        if c["kernel"] != "flash_decode" or c["dtype"] != "bfloat16":
            continue
        got = outs[name] if outs is not None else c["run"]()
        want = c["plain"]()
        kernel = (got != want).float().mean().item()
        control = (_plain_p_bf16(*c["args"]) != want).float().mean().item()
        if kernel > control / 4:
            raise AssertionError(f"flash_decode on {name}: {kernel} of the "
                                 f"outputs leave the plain version's bits, "
                                 f"p rounded to bf16 {control}")
        shares[name] = {"kernel": kernel, "p_bf16": control}
    return shares


def check_decode_edges(cases: dict):
    """flash_decode on each of its cases: t as an int gives the bits of t
    as a device tensor, and so do k and v overwritten at positions >= t
    (never read)."""
    fd_ops, _ = _fd()
    for name, c in cases.items():
        if c["kernel"] != "flash_decode":
            continue
        q, k, v, t_dev = c["args"]
        t = c["t"]
        got = c["run"]()
        if not torch.equal(fd_ops.flash_decode(q, k, v, t), got):
            raise AssertionError(f"flash_decode on {name}: int t != tensor t")
        if t < k.shape[1]:
            k2, v2 = k.clone(), v.clone()
            k2[:, t:], v2[:, t:] = 999.0, -999.0
            if not torch.equal(fd_ops.flash_decode(q, k2, v2, t_dev), got):
                raise AssertionError(f"flash_decode on {name}: positions >= "
                                     f"t change the output")


def hist_bound(n: int, vocab: int, hash_mod: int) -> tuple[float, str, dict]:
    """Least time of one histogram: the tokens read once and the bins
    written once at the memory rate, against ~2 integer operations a token
    (~10 with the owner hash) at the scalar rate."""
    nbytes = 4 * n + 4 * vocab
    ops = n * (10 if hash_mod else 2)
    return _bound(nbytes, ops, SCALAR_OPS_PER_S)


def slots_bound(T: int, E: int) -> tuple[float, str, dict]:
    """Least time of one bucket_slots call: ids read once, slots and counts
    written once, against ~4 integer operations an id."""
    return _bound(8 * T + 4 * E, 4 * T, SCALAR_OPS_PER_S)


def decode_bound(case) -> tuple[float, str, dict]:
    """Least time of one decode call: q and the K and V rows below t read
    once and the output written once, against 2 products of 2 hd FLOPs per
    (query head, visible key) at the rate of the type."""
    B, S, H, KV, hd, t, dtype = case[:7]
    visible = min(max(t, 0), S)
    size = torch.finfo(getattr(torch, dtype)).bits // 8
    nbytes = (2 * B * H * hd + 2 * B * visible * KV * hd) * size
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else SCALAR_OPS_PER_S
    return _bound(nbytes, 4 * B * H * hd * visible, rate)


def _bound(nbytes: int, ops: int, rate: float) -> tuple[float, str, dict]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "ops": ops}


def _sdpa_decode(q, k, v, t: int):
    """``scaled_dot_product_attention`` of the one-token query over
    ``k[:, :t]`` (the library yardstick; never on the port's path), or
    None where the installed torch cannot group heads."""
    G = q.shape[1] // k.shape[2]
    kw = {}
    if G > 1:
        if tuple(int(x) for x in torch.__version__.split(".")[:2]) < (2, 5):
            return None
        kw["enable_gqa"] = True
    kt, vt = k[:, :t].transpose(1, 2), v[:, :t].transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kt, vt, **kw)


def entry_cases(device, corpus: np.ndarray, w=None, routing=ROUTING,
                decode=None) -> dict:
    """The three entry points at full width (``w``, ``routing`` and
    ``decode`` shrink them for a rehearsal): the histogram of the job's
    corpus in count mode (vocab V) and owner mode (P bins), and of as many
    uniform keys over V, seeded on the device (the worst case for the
    kernel's per-CTA counters: most keys go to global atomics); the slots
    of one served batch's routing (deepseek-v2-lite) and of one segment's
    owner window (P x segment x task records, ids mix32(token) % P); and
    decode on the served caches. Each case names its kernel and holds
    zero-argument calls of the entry point, its plain version and the
    library yardstick (or None), and its bound."""
    w = w or FULL
    wc_ops, wc_ref = _wc()
    sl_ops, sl_ref = _slots()
    tokens = torch.from_numpy(corpus).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    uniform = torch.randint(0, w.vocab, tokens.shape, generator=gen,
                            device=device, dtype=torch.int32)
    cases = {}
    for corpus_name, toks in (("", tokens), ("_uniform", uniform)):
        for mode, vocab, mod in (("count", w.vocab, 0),
                                 ("owner", w.n_procs, w.n_procs)):
            cases[f"hist_{mode}{corpus_name}"] = dict(
                kernel="hist", exact=True,
                run=functools.partial(wc_ops.wordcount_hist, toks, vocab,
                                      mod),
                plain=functools.partial(wc_ref.hist_plain, toks, vocab,
                                        hash_mod=mod),
                library=None if mod else functools.partial(
                    torch.bincount, toks, minlength=vocab),
                bound=hist_bound(toks.numel(), vocab, mod))
    for name, (ids, E) in slots_inputs(device, tokens, w, routing).items():
        cases[f"slots_{name}"] = dict(
            kernel="bucket_slots", exact=True,
            run=lambda i=ids, e=E: sl_ops.bucket_slots(i, e),
            plain=lambda i=ids, e=E: sl_ref.bucket_slots_ref(i, e),
            library=None, bound=slots_bound(ids.numel(), E))
    cases.update(decode_entry_cases(device, decode))
    return cases


def slots_inputs(device, tokens, w=None, routing=ROUTING) -> dict:
    """bucket_slots' two full-width inputs as ``name: (ids, E)``: the
    routing of one served batch (``routing`` = (T, E), ids seeded
    uniform over the E experts) and one segment's owner window (the
    first P x segment x task of the corpus ``tokens``, ids mix32(token)
    % P)."""
    w = w or FULL
    _port()
    from repro_torch.core.kv import owner_of
    route = torch.from_numpy(np.random.default_rng(0).integers(
        0, routing[1], routing[0]).astype(np.int32)).to(device)
    window = owner_of(tokens[:w.n_procs * w.segment * w.task], w.n_procs)
    return {"routing": (route, routing[1]),
            "owner_window": (window, w.n_procs)}


def decode_entry_cases(device, decode=None) -> dict:
    """``entry_cases``' decode on the served caches (``decode`` shrinks
    them for a rehearsal), each with its SDPA yardstick and its bound."""
    cases = {}
    for arch, case in (DECODE_FULL if decode is None else decode).items():
        c = cases[f"decode_{arch}"] = decode_case(case, device)
        c.update(library=_sdpa_decode(*c["args"][:3], c["t"]),
                 bound=decode_bound(case))
    return cases


def phase_entry(device, cases: dict) -> dict:
    """The entry-point path: every case's entry point once (launch counts
    zeroed just before, read just after), then each output held to its
    plain version (``check_cases``)."""
    fns = wrappers()
    zero_counts()
    outs = {name: c["run"]() for name, c in cases.items()}
    _sync(device)
    kernels = {c["kernel"] for c in cases.values()}
    launches = {k: fns[k].launches for k in kernels}
    if device.type == "cuda":
        for k in kernels:
            want = sum(c["kernel"] == k for c in cases.values())
            assert launches[k] == want, (k, launches[k], want)
    return dict(launches=launches, max_abs_err=check_cases(cases, outs),
                bits_off=check_decode_bits(cases, outs))


FLUSH_BYTES = 128 * 2**20      # zeroed between cold calls: > the 50 MB L2
HOLD_CYCLES = 400_000           # ~0.2 ms of spinning: the host runs ahead


def _cold_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of single calls of ``fn``, each after
    FLUSH_BYTES are zeroed outside the timed span, so that the call finds
    its inputs in device memory and not in the L2 (as a decode step does,
    whose other layers pass through the L2 between two calls of one).
    A spin kernel after the flush holds the stream while the host
    enqueues the call, so the span is the device's and not the host's."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(iters):
        flush.zero_()
        flush.view(torch.int32).max()        # evicts the dirty lines
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / iters


def _device_ms(fn, iters: int, tries: int = 3,
               per_call: int | None = None) -> tuple[float, list, float]:
    """Device time per call of ``fn`` run back to back: the summed time of
    the device's own activities in a ``torch.profiler`` trace of ``iters``
    calls, over ``iters``; their names; and their number over ``iters``
    (a trace can miss its first activity, so not one call's trace). The
    host's cost per call is the event time less this. Every call timed
    here launches at least one activity, so a trace that holds fewer
    than ``iters`` has dropped some: it is taken again, up to ``tries``
    times. Where the caller knows that a call launches ``per_call``
    activities, a trace that holds any other number than ``per_call *
    iters`` is taken again in the same way, and the last one is returned
    for the caller to check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    want = None if per_call is None else per_call * iters
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if (len(events) == want) if want else (len(events) >= iters):
            break
    total_us = sum(e.time_range.elapsed_us() for e in events)
    return (total_us / 1e3 / iters, sorted({e.name[:80] for e in events}),
            len(events) / iters)


def _in_turns(fns: dict, measure) -> dict:
    """``measure(fn)`` of each of ``fns`` in turns, forward and then
    backward (a, b, c, c, b, a), averaged per name."""
    names = list(fns)
    got = {n: [] for n in names}
    for n in names + names[::-1]:
        got[n].append(measure(fns[n]))
    return {n: sum(v) / len(v) for n, v in got.items()}


def time_decode(c: dict) -> dict:
    """The decode kernel on one served cache in three regimes, each taken
    in turns with SDPA: CUDA events around 200 calls back to back
    (``ms``), around single calls with a cold L2 (``cold_ms``), and the
    profiler's device time per call back to back (``device_ms``)."""
    q, k, _, _ = c["args"]
    fns = {"kernel": c["run"]}
    if c["library"]:
        fns["library"] = c["library"]
    warm = _in_turns(fns, lambda f: _event_ms(f, 200))
    cold = _in_turns(fns, lambda f: _cold_ms(f, 100))
    dev = _in_turns(fns, lambda f: _device_ms(f, 100)[0])
    out = {}
    for n in fns:
        key = "" if n == "kernel" else f"{n}_"
        out.update({f"{key}ms": warm[n], f"{key}cold_ms": cold[n],
                    f"{key}device_ms": dev[n]})
    out["device_kernels"] = _device_ms(c["run"], 3)[1]
    out["plan"] = _fd()[0].plan(q, k)
    return out


def time_entry(cases: dict) -> dict:
    """CUDA-event time per call of each case's entry point, its plain
    version and its library yardstick, beside its bound; for hist and
    bucket_slots also the profiler's device time and device activities a
    call (bucket_slots: one, or this raises), and the seconds all this
    took; for flash_decode ``time_decode``'s regimes."""
    out = {}
    for name, c in cases.items():
        t0 = time.perf_counter()
        fast = c["kernel"] != "hist"
        bound_ms, bound_by, work = c["bound"]
        out[name] = dict(plain_ms=_event_ms(c["plain"], 10 if fast else 3),
                         library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by, **work)
        if c["kernel"] == "flash_decode":
            out[name].update(time_decode(c))
        else:
            out[name].update(
                ms=_event_ms(c["run"], 200 if fast else 50),
                library_ms=(_event_ms(c["library"], 50)
                            if c["library"] else None))
        if c["kernel"] in ("hist", "bucket_slots"):
            dev, acts, per_call = _device_ms(
                c["run"], 50 if c["kernel"] == "hist" else 200)
            out[name].update(device_ms=dev, device_activities=acts,
                             device_activities_per_call=per_call)
            # one kernel a call: one name, never more than one a call (a
            # trace drops activities, and never adds one)
            if c["kernel"] == "bucket_slots" and not (
                    len(acts) == 1 and 0 < per_call <= 1.0):
                raise AssertionError(f"bucket_slots on {name}: {per_call} "
                                     f"device activities a call ({acts})")
        out[name]["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# 2c. fleetlint on the card: its programs, kernels and mutant kernels
# ---------------------------------------------------------------------------

# the mutant corpus's near twins and the kernel each one launches
MUTANT_KERNELS = {"pal001-near": "copy_rows",
                  "pal001-fused-near": "table_add",
                  "pal002-near": "copy_rows_i32"}
# the PAL001 bad twins, whose maps leave their arrays, and the device
# kernel that memcheck must name in each one's report
PAL001_BAD = {"pal001-bad": "copy_blocks",
              "pal001-fused-bad": "table_add_kernel"}
# the TPU kernel each replaces: the function that reaches pallas_call
MUTANT_REPLACES = {"copy_rows": "corpus.py:372",
                   "table_add": "corpus.py:397",
                   "copy_rows_i32": "corpus.py:415"}


def mutant_call(name: str, device) -> dict:
    """One kernel mutant of the corpus in ``entry_cases``' form: its
    wrapper with its declared spec (the map PAL001 checks), on the spec's
    input operands made from a seed (f32 standard normal; int32 over its
    whole range, so table_add's sums wrap), its plain version, the
    one-call library yardstick (``x.clone()``, ``table + recs[0]``) and
    the bound: each operand read or written once (of recs, the one entry
    the kernel reads)."""
    corpus, _, _, ref = _lint()
    kc = next(m for m in corpus.MUTANTS if m.name == name).build()
    fn, _, kw = kc.build(device)
    rng = np.random.default_rng(len(name))
    args = []
    for op in kc.spec.operands:
        if op.output:
            continue
        a = (rng.standard_normal(op.shape, np.float32)
             if op.dtype == torch.float32
             else rng.integers(-2**31, 2**31, op.shape).astype(np.int32))
        args.append(torch.from_numpy(a).to(device))
    add = fn.__name__ == "table_add"
    plain = ref.table_add_plain if add else ref.copy_rows_plain
    nbytes = sum(math.prod(op.shape) * op.dtype.itemsize
                 for op in kc.spec.operands if op.name != "recs") + 4 * add
    return dict(kernel=fn.__name__, exact=True,
                run=functools.partial(fn, *args, **kw),
                plain=lambda: plain(*args, kc.spec),
                library=((lambda: args[0] + args[1][0]) if add
                         else (lambda: args[0].clone())),
                bound=_bound(nbytes, 0, SCALAR_OPS_PER_S))


def fused_twins(device) -> list[str]:
    """Each ``+fused`` shipping program's finish outputs against its
    unfused twin's on the same seeded inputs, bit for bit; returns the
    pairs' names."""
    corpus = _lint()[0]
    from repro_torch.analysis.rules import run_program
    handles = {h.name: h for h in corpus.shipping_programs(device)}
    pairs = [(n, n.replace("+fused", "")) for n in handles
             if "+fused/finish" in n]
    for fused, plain in pairs:
        (*_, (_, got, _)) = run_program(handles[fused], watched=False)
        (*_, (_, want, _)) = run_program(handles[plain], watched=False)
        for path, x in want.items():
            if not torch.equal(got[path], x):
                raise AssertionError(f"{fused}: {path} differs from "
                                     f"{plain}'s")
    return [f for f, _ in pairs]


def phase_lint(device) -> dict:
    """fleetlint on ``device``, the path of its programs and mutant
    kernels: ``--all`` (the 82 shipping programs at P = 8, the ``+fused``
    ones launching fused_map once a step; the six shipping wrappers, none
    launched) and ``--selftest`` (the 20 mutants: each near twin's
    kernel launched once, no bad twin), launch counts zeroed just before
    and read just after; fused_map's launches equal to the steps of the
    ``+fused`` handles (``ProgramHandle.steps``) on the card; each
    ``+fused`` finish equal to its unfused twin's (``fused_twins``); the
    phase's wall; then each near twin's kernel held bit for bit to its
    plain version on seeded inputs (``check_cases``)."""
    corpus, lint, _, _ = _lint()
    fns = wrappers()
    t0 = time.perf_counter()
    zero_counts()
    rc_all = lint.main(["--all", "--device", str(device)])
    rc_selftest = lint.main(["--selftest", "--device", str(device)])
    _sync(device)
    launches = {k: fns[k].launches for k in
                ("fused_map", *MUTANT_KERNELS.values())}
    assert rc_all == 0 and rc_selftest == 0, (rc_all, rc_selftest)
    steps = sum(h.steps for h in corpus.shipping_programs(device)
                if "+fused" in h.name)
    if device.type == "cuda":
        assert all(launches[k] == 1 for k in MUTANT_KERNELS.values()), \
            launches
        assert launches["fused_map"] == steps > 0, (launches, steps)
    else:
        assert all(n == 0 for n in launches.values()), launches
    twins = fused_twins(device)
    wall = time.perf_counter() - t0
    cases = {name: mutant_call(name, device) for name in MUTANT_KERNELS}
    return dict(launches=launches, fused_steps=steps, fused_twins=twins,
                seconds=wall, cases=cases, max_abs_err=check_cases(cases))


# ---------------------------------------------------------------------------
# 2d. memcheck: the kernels under compute-sanitizer, each run a child
# ---------------------------------------------------------------------------

MEMCHECK = ("--tool", "memcheck", "--error-exitcode", "1")
# unowned bytes after each allocation, so that a one-block overrun lands
# in no live allocation (with PyTorch's caching allocator off)
MEMCHECK_PADDING = 4096
MEMCHECK_TIMEOUT = 600


def sanitizer() -> Path | None:
    """``$CUDA_HOME/bin/compute-sanitizer``, or None where it is absent."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = Path(CUDA_HOME or "/nonexistent") / "bin" / "compute-sanitizer"
    return tool if tool.exists() else None


def memcheck_cases(device) -> dict:
    """What memcheck (a) runs: every shipping kernel over its small
    matrix (never a full-width shape; every dtype, causal and not,
    window, GQA and MQA, ragged S, hist's two modes) and the three near
    twins, as ``name: (kernel, zero-argument call)``; each call is a
    ``functools.partial`` of the wrapper, so its inputs can be re-bound
    (the guard band, phase 2e)."""
    fm_ops, fa_ops, ssd_ops = _port()[3], _fa()[0], _ssd()[0]
    calls = {}
    for name, (args, P, cap) in fused_matrix():
        if name != "full_width":
            calls[f"fused_{name}"] = ("fused_map", functools.partial(
                fm_ops.fused_map, **_on(args, device), n_procs=P, cap=cap))
    for name, case in FLASH_MATRIX.items():
        calls[f"flash_{name}"] = ("flash_attention", functools.partial(
            fa_ops.flash_attention, *flash_inputs(case, device),
            causal=case[5], window=case[6]))
    for name, case in SSD_MATRIX.items():
        calls[f"ssd_{name}"] = ("ssd_scan", functools.partial(
            ssd_ops.ssd, *ssd_inputs(case, device), chunk=case[6]))
    for name, c in matrix_cases(device).items():
        calls[name] = (c["kernel"], c["run"])
    for name in MUTANT_KERNELS:
        c = mutant_call(name, device)
        calls[name] = (c["kernel"], c["run"])
    return calls


def memcheck_child(what: str) -> int:
    """The smoke's child under memcheck: ``probe`` (one allocation and
    one sum: does the tool run here at all), ``shipping`` (memcheck (a):
    every call of ``memcheck_cases``, each synchronised, then the launch
    counts) or a PAL001 bad twin's name (memcheck (b): its kernel once,
    on purpose, with the map that leaves its array)."""
    device = torch.device("cuda", 0)
    if what == "probe":
        x = torch.arange(1024, dtype=torch.float32, device=device)
        print(f"memcheck-child: probe {x.sum().item()}", flush=True)
        return 0
    if what == "shipping":
        calls = memcheck_cases(device)
        fns = wrappers()
        zero_counts()
        for name, (kernel, run) in calls.items():
            run()
            torch.cuda.synchronize()
            print(f"memcheck-case: {kernel} {name}", flush=True)
        print("memcheck-launches: " + json.dumps(
            {k: fns[k].launches for k, _ in calls.values()}), flush=True)
        return 0
    if what not in PAL001_BAD:
        raise SystemExit(f"unknown memcheck child {what!r}")
    c = mutant_call(what, device)
    c["run"]()
    torch.cuda.synchronize()
    print(f"memcheck-case: {c['kernel']} {what}", flush=True)
    return 0


def _memcheck(tool: Path, what: str, padding: bool) -> tuple[int, str]:
    """Run ``memcheck_child(what)`` under memcheck in its own process
    group (killed whole at the time limit), with PyTorch's caching
    allocator off: an overrun inside a cached segment is no error to the
    tool. Returns the exit code and the merged output."""
    cmd = [str(tool), *MEMCHECK,
           *(("--padding", str(MEMCHECK_PADDING)) if padding else ()),
           sys.executable, str(Path(__file__).resolve()), "--memcheck-child",
           what]
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    with subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          start_new_session=True) as proc:
        try:
            out, _ = proc.communicate(timeout=MEMCHECK_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
    return proc.returncode, out


def _error_summary(out: str) -> int | None:
    m = re.search(r"ERROR SUMMARY: (\d+) error", out)
    return int(m.group(1)) if m else None


def _report(out: str, limit: int = 40) -> str:
    """The tool's own lines of ``out`` without host stack frames."""
    lines = [ln for ln in out.splitlines()
             if ln.startswith("=========") and "Host Frame" not in ln]
    return "\n".join(lines[:limit])


def phase_memcheck() -> dict:
    """memcheck of the kernels on the card, each run a child of this
    script under ``compute-sanitizer --tool memcheck --error-exitcode 1``
    (``--padding`` where the tool has it). A probe first: where the tool
    is absent or does not run on this card, that is printed on a line of
    its own and nothing is held. Else (a) every shipping kernel's small
    matrix and the near twins: 0 errors, each case's kernel launched; (b)
    each PAL001 bad twin in a child of its own (an out-of-bounds read can
    poison the context): an invalid __global__ read in that kernel and a
    non-zero exit, which shows that (a)'s 0 means something."""
    t0 = time.perf_counter()
    tool = sanitizer()
    if tool is None:
        print("memcheck: no compute-sanitizer under CUDA_HOME: not run; the "
              "kernels' bounds are unchecked on this card")
        return dict(ran=False, reason="compute-sanitizer not found",
                    seconds=time.perf_counter() - t0)
    version = subprocess.run([str(tool), "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    padding = "--padding" in subprocess.run(
        [str(tool), "--help"], capture_output=True, text=True).stdout
    rc, out = _memcheck(tool, "probe", padding)
    if rc != 0 or "memcheck-child: probe" not in out \
            or _error_summary(out) != 0:
        reason = next((ln.strip("= ") for ln in out.splitlines()
                       if "Error:" in ln), f"exit code {rc}")
        print(f"memcheck: {version}: the tool does not run on this card "
              f"({reason!r}; a probe of one allocation and one sum under "
              f"memcheck exits {rc}): not run; the bounds of the six "
              f"shipping kernels and the near twins are unchecked here")
        print(f"memcheck: the probe's report:\n{_report(out, 12)}")
        return dict(ran=False, version=version, reason=reason, probe_rc=rc,
                    padding=padding, seconds=time.perf_counter() - t0)

    rc, out = _memcheck(tool, "shipping", padding)
    errors = _error_summary(out)
    if rc != 0 or errors != 0:
        raise AssertionError(f"memcheck (a): exit {rc}, {errors} errors\n"
                             f"{_report(out)}\n{out[-2000:]}")
    ran: dict[str, int] = {}
    for ln in out.splitlines():
        if ln.startswith("memcheck-case: "):
            kernel = ln.split()[1]
            ran[kernel] = ran.get(kernel, 0) + 1
    launched = next((json.loads(ln.split(" ", 1)[1]) for ln in out.splitlines()
                     if ln.startswith("memcheck-launches: ")), None)
    assert launched == ran, (launched, ran)
    for kernel, n in ran.items():
        print(f"memcheck: {kernel}: {n} cases, {n} launches, 0 errors")
    bad = {}
    for name, symbol in PAL001_BAD.items():
        rc, out = _memcheck(tool, name, padding)
        reads = sum("Invalid __global__ read" in ln for ln in out.splitlines())
        if rc == 0 or not reads or symbol not in out:
            raise AssertionError(f"memcheck (b) missed {name}'s read past its "
                                 f"array: exit {rc}\n{_report(out)}")
        bad[name] = dict(rc=rc, invalid_reads=reads, kernel=symbol,
                         errors=_error_summary(out))
        print(f"memcheck: {name} ({symbol}): {reads} invalid __global__ "
              f"reads reported, exit {rc}")
    return dict(ran=True, version=version, padding=padding, cases=ran,
                bad=bad, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 2e. guard band: each kernel's inputs and outputs between bands of a pattern
# ---------------------------------------------------------------------------

# each band: larger than any tile one block of the six kernels reads or
# writes, and a multiple of 256 bytes, so the view keeps the allocation's
# alignment (the kernels demand 16 bytes)
GUARD_BAND_BYTES = 2**20
# the two fills of a float band: values no kernel would pass over unchanged
GUARD_FLOAT_FILLS = (float("nan"), 1e4)
# the inputs a kernel updates in place, copied for the unbanded call
GUARD_WRITES = {"fused_map": ("table",)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as integers of the same width, so that NaN bands
    compare bit for bit."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def banded(t: torch.Tensor, fill):
    """A copy of ``t`` with ``t``'s shape and strides, on its device, as a
    view into one larger allocation that puts a band of GUARD_BAND_BYTES
    filled with ``fill`` before it and at least as much after it (up to a
    256-byte boundary), and fills every element that ``t``'s strides skip
    as well. Returns ``(view, intact)``:
    ``intact()`` is True while every element outside the view still holds
    ``fill``, bit for bit."""
    device = t.device
    size = t.element_size()
    extent = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride())) \
        if t.numel() else 0
    front = GUARD_BAND_BYTES // size
    back = (GUARD_BAND_BYTES + (-extent * size) % 256) // size
    buf = torch.full((front + extent + back,), fill, dtype=t.dtype,
                     device=device)
    view = buf.as_strided(t.shape, t.stride(), front)
    view.copy_(t)
    want = _bits(torch.full((), fill, dtype=t.dtype))
    outside = None
    if extent != t.numel():                  # a view with gaps
        outside = torch.ones(buf.shape, dtype=torch.bool, device=device)
        outside.as_strided(t.shape, t.stride(), front).fill_(False)

    def intact() -> bool:
        b = _bits(buf)
        b = torch.cat((b[:front], b[front + extent:])) if outside is None \
            else b[outside]
        return bool((b == want.to(device)).all())
    return view, intact


def guard_fills(kernel: str, run) -> tuple:
    """The two fills of an integer band of ``run``'s inputs: two keys the
    kernel counts into different bins (bucket_slots: experts 0 and E - 1;
    hist, fused_map's keys and tables: 0 and 1)."""
    return (0, run.args[1] - 1) if kernel == "bucket_slots" else (0, 1)


def hist_into_band(tokens, vocab: int, hash_mod: int, fill: int):
    """hist's C entry point (``ops._launcher()``) on ``tokens`` into a
    zero-filled (vocab,) output view between bands of ``fill``: its
    global atomics are the writes a band must see. Returns the counts and
    the output's ``intact``."""
    ops = _wc()[0]
    out, intact = banded(torch.zeros(vocab, dtype=torch.int32,
                                     device=tokens.device), fill)
    rc = ops._launcher()(tokens.data_ptr(), tokens.numel(), out.data_ptr(),
                         vocab, hash_mod,
                         torch.cuda.current_stream(tokens.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed: CUDA error {rc}")
    return out, intact


def slots_into_band(ids, n_experts: int, fill: int):
    """bucket_slots' C entry point (``ops._launcher()``) on ``ids`` into
    slots, counts and scratch (zeroed, as the wrapper allocates it) that
    are views between bands of ``fill``, twice: the second call finds the
    status words the first left. Raises where the two calls' outputs
    differ. Returns the first call's slots and counts and ``intact`` over
    the three views."""
    ops = _slots()[0]
    T, dev = ids.numel(), ids.device
    items, tiles = ops.plan(T, ops.sm_count(dev))
    scratch, ok_w = banded(torch.zeros(1 + tiles * n_experts,
                                       dtype=torch.int64, device=dev), fill)
    outs = []
    for _ in range(2):
        slots, ok_s = banded(torch.empty(T, dtype=torch.int32, device=dev),
                             fill)
        counts, ok_c = banded(torch.empty(n_experts, dtype=torch.int32,
                                          device=dev), fill)
        rc = ops._launcher()(ids.data_ptr(), T, n_experts, items,
                             slots.data_ptr(), counts.data_ptr(),
                             scratch.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bucket_slots kernel launch failed: CUDA "
                               f"error {rc}")
        outs.append(((slots, counts), (ok_s, ok_c)))
    (first, oks), (second, _) = outs
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError("bucket_slots: a second call on the same "
                                 "scratch changed the output")
    checks = [ok_w, *oks, *outs[1][1]]
    return first, lambda: all(ok() for ok in checks)


def guard_call(kernel: str, run, fill: int):
    """``run`` once with each tensor input copied between bands (the
    ``fill``-th of GUARD_FLOAT_FILLS or of ``guard_fills``), hist and
    bucket_slots on the card through their C entry points into banded
    outputs (and bucket_slots' scratch) too. Returns its outputs (a tuple)
    and whether every band is still intact."""
    ints = guard_fills(kernel, run)
    checks = []

    def band(x):
        if not torch.is_tensor(x):
            return x
        v, ok = banded(x, (GUARD_FLOAT_FILLS if x.is_floating_point()
                           else ints)[fill])
        checks.append(ok)
        return v
    args = [band(a) for a in run.args]
    kw = {k: band(v) for k, v in run.keywords.items()}
    if kernel == "hist" and args[0].is_cuda:
        out, ok = hist_into_band(*args, ints[fill])
        checks.append(ok)
    elif kernel == "bucket_slots" and args[0].is_cuda:
        out, ok = slots_into_band(*args, ints[fill])
        checks.append(ok)
    else:
        out = run.func(*args, **kw)
    return (out if isinstance(out, tuple) else (out,),
            all(ok() for ok in checks))


def guard_diff(name: str, got: tuple, want: tuple) -> float:
    """The largest difference of a banded call's outputs from the
    unbanded call's; raises where they differ: integers bit for bit,
    floats past the smoke's tolerance of the dtype (``flash_tol``) or not
    finite."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if not g.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"guard band: {name}'s output changed "
                                     f"(max abs {_int_diff(g, w)})")
            continue
        tol = flash_tol("bfloat16" if g.dtype == torch.bfloat16
                        else "float32")
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        if not bool(torch.isfinite(g).all()) or bool(
                (diff > tol["atol"] + tol["rtol"] * w.abs()).any()):
            raise AssertionError(f"guard band: {name}'s output changed (max "
                                 f"abs {diff.max().item()}, {tol})")
        worst = max(worst, diff.max().item())
    return worst


def phase_guard(device, corpus=None) -> dict:
    """The guard band of every shipping kernel: each case of
    ``memcheck_cases`` once unbanded (inputs it writes copied) and once
    with each pair of fills, hist through its C entry point into a banded
    output; every band intact and every output equal to the unbanded
    call's. Then, on ``corpus`` (the full-width Zipf tokens), hist in
    count and owner mode the same way. Launch counts are zeroed just
    before and read just after. On the card, each PAL001 bad twin runs
    over banded inputs too, and its read past the array must change its
    output between the two fills (on the CPU their plain versions raise
    instead)."""
    t0 = time.perf_counter()
    calls = {n: c for n, c in memcheck_cases(device).items()
             if c[0] not in MUTANT_KERNELS.values()}
    if corpus is not None:
        wc_ops = _wc()[0]
        for mode, vocab, mod in (("count", VOCAB, 0),
                                 ("owner", N_PROCS, N_PROCS)):
            calls[f"hist_full_width_{mode}"] = ("hist", functools.partial(
                wc_ops.wordcount_hist, corpus, vocab, mod))
    fns = wrappers()
    zero_counts()
    kernels: dict[str, dict] = {}
    for name, (kernel, run) in calls.items():
        writes = GUARD_WRITES.get(kernel, ())
        want = run.func(*run.args, **{k: v.clone() if k in writes else v
                                      for k, v in run.keywords.items()})
        want = want if isinstance(want, tuple) else (want,)
        k = kernels.setdefault(kernel, dict(cases=0, max_abs_diff=0.0,
                                            seconds=0.0))
        k["cases"] += 1
        t_case = time.perf_counter()
        for fill in (0, 1):
            got, intact = guard_call(kernel, run, fill)
            if not intact:
                raise AssertionError(f"guard band: {name} wrote a band "
                                     f"(fill {fill})")
            k["max_abs_diff"] = max(k["max_abs_diff"],
                                    guard_diff(name, got, want))
        k["seconds"] += time.perf_counter() - t_case
    _sync(device)
    for kernel, k in kernels.items():
        k["launches"] = fns[kernel].launches
    # guard_call's calls of hist's and bucket_slots' C entry points, which
    # no wrapper counts
    for kernel, calls_a_case in (("hist", 2), ("bucket_slots", 4)):
        kernels[kernel]["c_entry_calls"] = \
            calls_a_case * kernels[kernel]["cases"] \
            if device.type == "cuda" else 0
    bad = {}
    if device.type == "cuda":
        for name in PAL001_BAD:
            run = mutant_call(name, device)["run"]
            outs = [guard_call("mutant", run, fill)[0][0] for fill in (0, 1)]
            if torch.equal(_bits(outs[0]), _bits(outs[1])):
                raise AssertionError(f"guard band missed {name}'s read past "
                                     f"its array")
            bad[name] = "flagged: its output changed between the two fills"
    return dict(kernels=kernels, bad=bad, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 3. the slice at full width
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Width:
    """Shapes of a job: the full-width one by default."""
    vocab: int = VOCAB
    n_procs: int = N_PROCS
    task: int = TASK
    cap: int = CAP
    segment: int = SEGMENT


FULL = Width()


def job_config(fused: bool, w: Width = FULL):
    core, _, _, _, _ = _port()
    return core.JobConfig(core.WordCount(vocab=w.vocab), backend="1s",
                          task_size=w.task, push_cap=w.cap,
                          n_procs=w.n_procs, segment=w.segment,
                          fused_map=fused)


def tasks_per_rank(n: int, w: Width = FULL) -> int:
    return -(-(-(-n // w.task)) // w.n_procs)


def job_input(n: int, w: Width = FULL):
    """The PUMA-like corpus and its imbalance grid (one hot rank at 8x)."""
    _, data, _, _, _ = _port()
    source = data.ZipfSource(n=n, vocab=w.vocab, a=1.3, seed=0)
    return source, grid_repeats("unbalanced", tasks_per_rank(n, w), w)


def submit_job(cfg, source, reps, device, eager: bool = False):
    """A job's handle through the user entry point. ``eager=True`` runs
    the fused step in the engine's eager loop instead of replaying its
    CUDA graphs (the engine's ``graphs`` released before the first
    segment): the graphs' baseline on the card."""
    core, _, _, _, _ = _port()
    h = core.submit(cfg, source, device=device, repeats=reps)
    if eager:
        h.engine.graphs = None
    return h


def run_job(cfg, source, reps, device, eager: bool = False) -> tuple:
    """One job through the user entry points; (result, wall seconds, the
    feed's stats)."""
    t0 = time.perf_counter()
    h = submit_job(cfg, source, reps, device, eager)
    res = h.result()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dataclasses.asdict(h.feed.stats)


def phase_job(device, n: int, n_unfused: int, w: Width = FULL) -> dict:
    """Warm up, run the fused job on ``n`` tokens (the main path, launch
    counts zeroed just before and read just after: on the card one
    fused_map launch for each step's graph replay) and check it against
    the oracle; then, on a corpus of ``n_unfused`` tokens of the same
    width, the fused job, its eager loop and the unfused job, each
    checked against its oracle."""
    core, data, _, ops, _ = _port()
    source, reps = job_input(n, w)
    oracle = core.wordcount_oracle(data.read_all(source), w.vocab)
    warm_src, warm_reps = job_input(1 << 16, w)
    for fused in (True, False):
        run_job(job_config(fused, w), warm_src, warm_reps, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    fused_res, fused_wall, feed = run_job(job_config(True, w), source, reps,
                                          device)
    launches = ops.fused_map.launches
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    assert fused_res.records == oracle, "fused records != numpy oracle"
    assert fused_res.n_tasks == -(-n // w.task)
    assert int(fused_res.tasks_per_rank.sum()) == fused_res.n_tasks
    steps = -(-reps.shape[1] // w.segment) * w.segment
    if cuda:
        assert launches == steps, (launches, steps)
    from repro_torch.core import planner
    t0 = time.perf_counter()
    plan = planner.plan_input(n, w.task, w.n_procs)
    planner.gather_segment(source, plan, planner.shard_task_ids(plan)[
        :, w.segment:2 * w.segment])
    feed_s = time.perf_counter() - t0             # one segment's host read

    source, reps = job_input(n_unfused, w)
    small_res, small_wall, _ = run_job(job_config(True, w), source, reps,
                                       device)
    assert small_res.records == core.wordcount_oracle(
        data.read_all(source), w.vocab), "fused records != numpy oracle"
    eager_res, eager_wall, _ = run_job(job_config(True, w), source, reps,
                                       device, eager=True)
    assert eager_res.records == small_res.records, "eager != graph"
    unfused_res, unfused_wall, _ = run_job(job_config(False, w), source,
                                           reps, device)
    assert unfused_res.records == small_res.records, "fused != unfused"
    return dict(n=n, steps=steps, launches=launches, fused_wall=fused_wall,
                tokens_per_s=n / fused_wall, peak_bytes=peak, feed=feed,
                feed_s_per_segment=feed_s, segments=steps // w.segment,
                n_records=len(oracle), imbalance=fused_res.imbalance,
                n_unfused=n_unfused, fused_wall_at_n_unfused=small_wall,
                eager_wall_at_n_unfused=eager_wall,
                unfused_wall=unfused_wall,
                unfused_tokens_per_s=n_unfused / unfused_wall)


def device_profile(fn, keep: tuple = ()) -> dict:
    """Device busy share of ``fn()``: the summed time of the device's own
    activities (kernels, copies) in the profiler's trace against the host
    wall of the same window, the six costliest names, every name that
    holds one of ``keep``, and the count of kernels (copies and fills
    apart)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us()
            t[1] += 1
    device_us = sum(t for t, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    kept = [kv for kv in ranked if any(k in kv[0] for k in keep)]
    return dict(wall_s=wall, device_s=device_us / 1e6,
                busy_share=device_us / 1e6 / wall,
                top=[(k, t / 1e3, c) for k, (t, c) in ranked[:6]],
                kept=[(k, t / 1e3, c) for k, (t, c) in kept],
                kernels=sum(c for k, (_, c) in ranked
                            if not k.startswith(("Memcpy", "Memset"))))


def phase_profile(device, n: int, w: Width = FULL,
                  eager: bool = False) -> dict:
    """The fused engine's own pace over a segment whose input the feed
    has read already (its graph replays, or with ``eager=True`` its eager
    loop), after a warm one: the device's busy share, then the host's
    seconds to enqueue the segment (until ``step()`` returns) and to finish
    it."""
    def read_ahead():
        while not h.feed.ready():
            time.sleep(1e-3)

    source, reps = job_input(n, w)
    with submit_job(job_config(True, w), source, reps, device, eager) as h:
        h.step()                                  # warm; captures
        read_ahead()
        prof = device_profile(h.step)
        read_ahead()
        t0 = time.perf_counter()
        h.step()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        segment_s = time.perf_counter() - t0
        # the profiler's host tracing slows the host's side, so the share
        # without it mixes two segments of the same work (the same grid of
        # repeats, each input read already): the device time traced in one
        # over the wall of the next, untraced one
        prof.update(enqueue_s=enqueue, segment_s=segment_s, steps=w.segment,
                    untraced_busy_share=prof["device_s"] / segment_s)
        return prof


def print_profile(what: str, prof: dict):
    print(f"profile: {what} {prof['wall_s']:.4f} s wall, "
          f"{prof['device_s']:.4f} s device kernels, busy share "
          f"{prof['busy_share']}")
    for key, ms, count in prof["top"]:
        print(f"  {ms:10.3f} ms  x{count:<6d} {key[:100]}")
    for key, ms, count in prof.get("kept", []):
        print(f"  named: {ms:10.3f} ms  x{count:<6d} {key[:100]}")


# ---------------------------------------------------------------------------
# 3b. MR-1S against MR-2S, 3c. snapshots and re-planning
# ---------------------------------------------------------------------------

# the comparison's repeat grids: the balanced one, phase 3's (one rank of
# 8 at 8x, the paper's footnote 5) and the Zipf rank skew of the
# reference's fig9_imbalance (s 1.1, mean repeat 4, seed 1)
GRIDS = ("balanced", "unbalanced", "zipf")
# the engines the comparison runs: 2S, the fused 1S, and the fused 1S
# with work stealing (the reference's fig9_imbalance runs it too)
ENGINES = ("2s", "1s", "1s+steal")
CKPT_EVERY, CKPT_KEEP = 8, 2


def grid_repeats(name: str, T: int, w: Width = FULL) -> np.ndarray:
    _, data, _, _, _ = _port()
    if name == "zipf":
        return data.zipf_skew_repeats(w.n_procs, T, 1.1, mean_rep=4, seed=1)
    return data.imbalance_repeats(w.n_procs, T, mode=name, hot_factor=8,
                                  hot_fraction=0.125)


def engine_config(backend: str, w: Width = FULL, segment: int | None = None,
                  partitioner="hash"):
    """WordCount at the width ``w`` under ``backend``: ``"1s"`` with the
    fused step (its CUDA graphs on the card), ``"1s+steal"`` the same
    with work stealing, ``"2s"`` as it is (it has no fused path)."""
    core, _, _, _, _ = _port()
    engine = backend.split("+")[0]
    return core.JobConfig(core.WordCount(vocab=w.vocab), backend=engine,
                          task_size=w.task, push_cap=w.cap,
                          n_procs=w.n_procs,
                          segment=w.segment if segment is None else segment,
                          fused_map=engine == "1s",
                          stealing=backend.endswith("+steal"),
                          partitioner=partitioner)


def run_engine(cfg, corpus, reps, device, every: int = 0, mgr=None,
               maps: bool = False) -> dict:
    """One job through ``submit``, step by step, its fused_map launches
    counted from 0; with ``mgr``, ``handle.checkpoint(mgr)`` after every
    ``every``-th segment and the writes waited for inside the wall. A
    job also returns its steals and the records each rank's window holds
    at the end (with ``maps``, the owner maps it ran with), a stealing
    job its engine's ``StealStats``, a sampled job the pre-pass's seconds
    (``step(0)``, inside the wall)."""
    core, _, _, ops, _ = _port()
    zero_counts()
    t0 = time.perf_counter()
    h = core.submit(cfg, corpus, device=device, repeats=reps)
    extra = {}
    if cfg.partitioner != "hash":
        h.engine                              # the carry, before the sample
        t1 = time.perf_counter()
        h.step(0)                             # the pre-pass alone
        extra["prepass_s"] = time.perf_counter() - t1
    k, more = 0, cfg.segment > 0
    while more:
        more = h.step()
        k += 1
        if mgr is not None and k % every == 0:
            h.checkpoint(mgr)
    res = h.result()
    if mgr is not None:
        mgr.wait()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = h.feed.stats
    if cfg.stealing:
        extra["steal"] = dataclasses.asdict(h.engine.steal)
    extra["window_records"] = (h.carry.table != 0).sum(dim=1).tolist()
    if maps:
        extra["owner_map"] = h.carry.owner_map[0].cpu().numpy()
        extra["owner_split"] = h.carry.owner_split[0].cpu().numpy()
    return dict(result=res, wall_s=wall, tokens_per_s=len(corpus) / wall,
                n_steals=res.n_steals,
                launches=ops.fused_map.launches,
                segments=st.segments_built,
                feed_s_per_segment=st.build_seconds / st.segments_built,
                prefetch_hits=st.prefetch_hits,
                sample_tasks_read=st.sample_tasks_read, **extra)


def steal_replay(n: int, reps: np.ndarray, w: Width = FULL) -> dict:
    """The port's host replay of a stealing job's schedule over the grid
    of ``n`` tokens and ``reps``, segment by segment as the feed pads
    them (oneshot: one segment), ``work0`` carried: the lockstep passes,
    steals and final work row that the job must realize."""
    _port()
    from repro_torch.core import planner, steal
    ids = planner.shard_task_ids(planner.plan_input(n, w.task, w.n_procs))
    T = ids.shape[1]
    seg = w.segment or T                 # oneshot: one segment of T
    work, passes, steals = None, 0, 0
    for lo in range(0, T, seg):
        g = np.full((w.n_procs, seg), -1, np.int32)
        r = np.ones((w.n_procs, seg), np.int32)
        g[:, :min(seg, T - lo)] = ids[:, lo:lo + seg]
        r[:, :min(seg, T - lo)] = reps[:, lo:lo + seg]
        s = steal.steal_schedule(g, r, work0=work)
        work, passes, steals = s.work, passes + s.passes, steals + s.n_stolen
    return {"passes": passes, "steals": steals, "work": work.tolist()}


def segment_profile(cfg, corpus, reps, device) -> dict:
    """``device_profile`` over one segment whose input the feed has read
    already, after a warm one: the device's busy share and its kernels
    (copies and fills apart) a segment."""
    core, _, _, _, _ = _port()
    with core.submit(cfg, corpus, device=device, repeats=reps) as h:
        h.step()
        while not h.feed.ready():
            time.sleep(1e-3)
        return device_profile(h.step, keep=("fused_map",))


def fig6_bytes(n: int, w: Width = FULL) -> dict:
    """The oneshot job's device buffers from their shapes (the reference's
    ``benchmarks/fig6_memory.py`` model, all P ranks on one card):
    both hold the input, the windows and owner maps; 1S its graph path's
    packed copy of the input; 2S every task's buckets to send and as
    received (keys and values) and the local overflow."""
    T = tasks_per_rank(n, w)
    tokens = w.n_procs * T * w.task * 4
    carry = 3 * w.n_procs * w.vocab * 4
    send = 2 * w.n_procs * w.n_procs * T * w.cap * 4
    overflow = 2 * w.n_procs * T * w.task * 4
    return {"input": tokens, "carry": carry, "send": send,
            "received": send, "overflow": overflow,
            "1s": tokens + tokens + carry,
            "2s": tokens + carry + 2 * send + overflow}


def warm_up(device, corpus: np.ndarray, w: Width = FULL):
    """Each engine once over four segments of ``corpus`` (the first fused
    job builds ``fused_map``)."""
    warm = corpus[: 4 * w.segment * w.task * w.n_procs]
    T = tasks_per_rank(len(warm), w)
    for backend in ("2s", "1s"):
        run_engine(engine_config(backend, w), warm,
                   grid_repeats("unbalanced", T, w), device)


def phase_compare(device, corpus: np.ndarray, w: Width = FULL) -> dict:
    """MR-2S against the fused MR-1S, without and with work stealing, on
    ``corpus`` held in host memory, after a warm-up of each, under each of
    ``GRIDS``: each job's records equal to the numpy oracle, its wall,
    tokens/s, feed seconds a segment and fused_map launches (1S: one a
    step; 2S: none), and on the card its device busy share and kernels a
    segment. The stealing job's passes (the max repeats its steps ran
    with) and the steals and work row that the card advanced from the
    columns it gathered equal the host replay's (``steal_replay``), with
    no steal on the balanced grid. Then 2S and 1S oneshot on the
    unbalanced grid, each from a reset peak: its peak device memory
    beside ``fig6_bytes``."""
    core, data, _, _, _ = _port()
    cuda = device.type == "cuda"
    n = len(corpus)
    oracle = core.wordcount_oracle(corpus, w.vocab)
    T = tasks_per_rank(n, w)
    warm_up(device, corpus, w)
    out = {"n": n, "steps": -(-T // w.segment) * w.segment}
    for grid in GRIDS:
        reps = grid_repeats(grid, T, w)
        work = reps.sum(axis=1)
        row = out[grid] = {"hot_rank_repeats": int(work.max()),
                           "mean_rank_repeats": float(work.mean()),
                           "lockstep_passes": int(reps.max(axis=0).sum())}
        for backend in ENGINES:
            cfg = engine_config(backend, w)
            r = run_engine(cfg, corpus, reps, device)
            res = r.pop("result")
            assert res.records == oracle, (grid, backend)
            if cuda:
                want = 0 if backend == "2s" else out["steps"]
                assert r["launches"] == want, (grid, backend, r["launches"])
                r["profile"] = segment_profile(cfg, corpus, reps, device)
            if cfg.stealing:
                replay = r["replay"] = steal_replay(n, reps, w)
                assert r["steal"]["passes"] == replay["passes"], grid
                assert r["n_steals"] == replay["steals"], grid
                assert res.work_per_rank.tolist() == replay["work"], grid
                assert grid != "balanced" or r["n_steals"] == 0
            row[backend] = r
        row["wall_2s_over_1s"] = row["2s"]["wall_s"] / row["1s"]["wall_s"]
        row["wall_2s_over_1s_steal"] = (row["2s"]["wall_s"]
                                        / row["1s+steal"]["wall_s"])
    reps = grid_repeats("unbalanced", T, w)
    one = out["oneshot"] = {"analytic": fig6_bytes(n, w)}
    for backend in ("2s", "1s"):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        r = run_engine(engine_config(backend, w, segment=0), corpus, reps,
                       device)
        assert r.pop("result").records == oracle, ("oneshot", backend)
        if cuda:
            r["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        one[backend] = r
    return out


def phase_snapshots(device, corpus: np.ndarray, w: Width = FULL) -> dict:
    """Checkpoints on the unbalanced grid, after a warm-up: the fused 1S
    job segmented,
    without and with ``handle.checkpoint`` after every ``CKPT_EVERY``-th
    segment into a temporary directory keeping ``CKPT_KEEP``, in turns
    (without, with, with, without); the older kept snapshot restored
    into a fresh handle and finished. The same for 2S (one pair). Then a
    1S job re-planned halfway by ``replan_handle``, its hot rank slowed
    in the tracker. Every job's records equal to the uninterrupted
    job's."""
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ft.straggler import ThroughputTracker, replan_handle
    core, _, _, _, _ = _port()
    T = tasks_per_rank(len(corpus), w)
    reps = grid_repeats("unbalanced", T, w)
    warm_up(device, corpus, w)
    out = {}
    for backend, turns in (("1s", (False, True, True, False)),
                           ("2s", (False, True))):
        cfg = engine_config(backend, w)
        row = out[backend] = {"plain_s": [], "ckpt_s": []}
        want = None
        for ckpt in turns:
            with tempfile.TemporaryDirectory() as d:
                mgr = CheckpointManager(d, keep=CKPT_KEEP)
                r = run_engine(cfg, corpus, reps, device, CKPT_EVERY,
                               mgr if ckpt else None)
                records = r["result"].records
                want = records if want is None else want
                assert records == want, (backend, ckpt)
                row["ckpt_s" if ckpt else "plain_s"].append(r["wall_s"])
                if not ckpt or "restored_s" in row:
                    continue
                steps = mgr.steps()
                assert len(steps) == CKPT_KEEP, steps
                t0 = time.perf_counter()
                h = core.submit(cfg, corpus, device=device, repeats=reps)
                res = h.restore(mgr, step=steps[0]).result()
                row["restored_s"] = time.perf_counter() - t0
                row["restored_from"] = steps[0]
                assert res.records == want, (backend, "restored")
        row["overhead"] = (sum(row["ckpt_s"]) / len(row["ckpt_s"])
                           / (sum(row["plain_s"]) / len(row["plain_s"]))
                           - 1.0)
    t0 = time.perf_counter()
    h = core.submit(engine_config("1s", w), corpus, device=device,
                    repeats=reps)
    h.step(-(-T // w.segment) // 2)
    before = h.feed.total_columns - h.cursor
    tracker = ThroughputTracker(n_procs=w.n_procs, alpha=1.0)
    tracker.update(reps.sum(axis=1))          # seconds follow each work
    grid = replan_handle(h, tracker)
    res = h.result()
    if device.type == "cuda":
        torch.cuda.synchronize()
    assert res.records == want, "replanned"
    out["replan"] = {"wall_s": time.perf_counter() - t0,
                     "columns_before": before,
                     "columns_after": int(grid.shape[1]),
                     "hot_rank_tasks_after": int((grid[0] >= 0).sum()),
                     "tasks_after": int((grid >= 0).sum())}
    return out


def print_compare(c: dict, w: Width = FULL):
    print(f"compare: MR-2S against MR-1S (fused), N={c['n']} in host "
          f"memory, V={w.vocab} P={w.n_procs} S={w.task} cap={w.cap} "
          f"segment={w.segment}, {c['steps']} 1S steps; every job's records "
          f"== oracle")
    for grid in GRIDS:
        row = c[grid]
        print(f"compare: {grid}: hot rank {row['hot_rank_repeats']} repeats "
              f"(mean {row['mean_rank_repeats']:.1f}; the lockstep runs "
              f"{row['lockstep_passes']} repeat passes a rank); 2S/1S wall "
              f"{row['wall_2s_over_1s']:.4f}, 2S/(1S+steal) "
              f"{row['wall_2s_over_1s_steal']:.4f}")
        for backend in ENGINES:
            r = row[backend]
            prof = r.get("profile")
            dev = (f", busy share {prof['busy_share']:.3f} and "
                   f"{prof['kernels']} device kernels over one segment"
                   if prof else "")
            print(f"compare: {grid} {backend}: {r['wall_s']:.3f} s, "
                  f"{r['tokens_per_s']:.0f} tokens/s, feed "
                  f"{r['feed_s_per_segment']:.5f} s a segment "
                  f"({r['prefetch_hits']} prefetch hits of {r['segments']}), "
                  f"fused_map launches {r['launches']}{dev}")
        st = row["1s+steal"]["steal"]
        print(f"compare: {grid} 1s+steal: {row['1s+steal']['n_steals']} "
              f"steals, "
              f"{st['passes']} lockstep passes (== the host replay's; "
              f"{row['lockstep_passes']} unstolen), work row == the "
              f"replay's; schedule {st['schedule_s'] / st['segments']:.5f} "
              f"s a segment on the host ({st['segments']} segments)")
    one = c["oneshot"]
    a = one["analytic"]
    for backend in ("2s", "1s"):
        r = one[backend]
        peak = r.get("peak_bytes")
        peak = "not measured" if peak is None else f"{peak / 1e9:.3f} GB"
        print(f"compare: oneshot unbalanced {backend}: {r['wall_s']:.3f} s "
              f"(feed {r['feed_s_per_segment']:.3f} s), peak device memory "
              f"{peak} against {a[backend] / 1e9:.3f} GB of buffers from "
              f"their shapes")
    print(f"compare: buffers (GB): input {a['input'] / 1e9:.3f}, carry "
          f"{a['carry'] / 1e9:.3f}, 2S send {a['send'] / 1e9:.3f}, "
          f"received {a['received'] / 1e9:.3f}, overflow "
          f"{a['overflow'] / 1e9:.3f}")
    print(f"compare: {c['seconds']:.1f} s")


# 3d: the reference's fig10_keyskew, its real-run half: Zipf keys at two
# skews, each partitioner through the fused 1S without and with stealing,
# and one 2S job with hot keys split; at 2**24 tokens (the phase took
# 16.0 s on an H100) to keep the smoke, with 2f's dry run in line, under
# 950 s
KEYSKEW_N = 2**24
KEYSKEW_A = (1.3, 1.8)
PARTITIONERS = ("hash", "sampled", "sampled+split")
# the sampled histogram counts a key once a task, so a key weighs at most
# the 16 sampled tasks (1637 records at a 1.3, 472 at 1.8): the default
# split_threshold, half a rank's share, splits no key at this width, and
# 0.05 splits those in nearly every sampled task
KEYSKEW_SPLIT_THRESHOLD = 0.05


def keyskew_partitioner(name: str):
    """``name`` as 3d runs it: ``sampled+split`` at the threshold that
    splits keys at this width."""
    _port()
    from repro_torch.core import partition
    if name == "sampled+split":
        return partition.SampledPartitioner(
            split=True, split_threshold=KEYSKEW_SPLIT_THRESHOLD)
    return name


def key_histogram(corpus: np.ndarray, w: Width = FULL) -> np.ndarray:
    """The sampled partitioners' histogram of ``corpus`` (16 tasks spread
    over it, as their pre-pass reads them)."""
    core, data, _, _, _ = _port()
    from repro_torch.core import partition, planner
    plan = planner.plan_input(len(corpus), w.task, w.n_procs)
    src = data.ArraySource(corpus)
    return partition.sample_key_histogram(
        lambda ids: planner.read_tasks(src, plan, ids), plan,
        core.WordCount(vocab=w.vocab), 16, window=w.vocab)


def imbalance(x) -> float:
    x = np.asarray(x, np.float64)
    return float(x.max() / x.mean())


def phase_keyskew(device, w: Width = FULL, n: int = KEYSKEW_N,
                  skews=KEYSKEW_A) -> dict:
    """For each Zipf skew ``a``: ``ZipfSource(n, V, a, seed 0)`` read once
    into host memory, each of ``PARTITIONERS`` through the fused 1S on the
    unbalanced grid without and with stealing (a warm-up first), and at
    the largest ``a`` a 2S job with ``sampled+split``: every job's
    records equal to the oracle, and split keys in every ``sampled+split``
    job; its wall, pre-pass seconds and tasks read, split keys, the
    model's owner loads (``owner_loads`` of the sampled histogram under
    the maps the job ran with) and the measured records of each rank's
    window, each as max over mean."""
    core, data, _, _, _ = _port()
    from repro_torch.core import partition
    split = keyskew_partitioner("sampled+split")
    cuda = device.type == "cuda"
    out = {"n": n}
    for a in skews:
        corpus = data.read_all(data.ZipfSource(n=n, vocab=w.vocab, a=a,
                                               seed=0))
        oracle = core.wordcount_oracle(corpus, w.vocab)
        T = tasks_per_rank(n, w)
        reps = grid_repeats("unbalanced", T, w)
        hist = key_histogram(corpus, w)
        steps = -(-T // w.segment) * w.segment
        jobs = [(p, e) for p in PARTITIONERS for e in ("1s", "1s+steal")]
        if a == max(skews):
            jobs.append(("sampled+split", "2s"))
        warm = corpus[: 2 * w.segment * w.task * w.n_procs]
        for backend in ("1s", "1s+steal", "2s"):
            run_engine(engine_config(backend, w, partitioner=split),
                       warm, grid_repeats("unbalanced", tasks_per_rank(
                           len(warm), w), w), device)
        rows = out[str(a)] = {"records": len(oracle)}
        for part, backend in jobs:
            cfg = engine_config(backend, w,
                                partitioner=keyskew_partitioner(part))
            r = run_engine(cfg, corpus, reps, device, maps=True)
            res = r.pop("result")
            assert res.records == oracle, (a, part, backend)
            assert part != "sampled+split" or res.n_split_keys > 0, (a,
                                                                     backend)
            if cuda:
                want = 0 if backend == "2s" else steps
                assert r["launches"] == want, (a, part, backend)
            r.update(n_split_keys=res.n_split_keys,
                     model_imbalance=imbalance(partition.owner_loads(
                         hist, r.pop("owner_map"), r.pop("owner_split"),
                         w.n_procs)),
                     window_imbalance=imbalance(r["window_records"]))
            rows[f"{part} {backend}"] = r
    return out


def print_keyskew(c: dict, w: Width = FULL):
    print(f"keyskew: ZipfSource N={c['n']} V={w.vocab} seed 0 in host "
          f"memory, P={w.n_procs} S={w.task} cap={w.cap} "
          f"segment={w.segment}, the unbalanced grid, sampled+split at "
          f"split_threshold {KEYSKEW_SPLIT_THRESHOLD}; every job's records "
          f"== oracle")
    for a, rows in c.items():
        if a in ("n", "seconds"):
            continue
        print(f"keyskew: a={a}: {rows['records']} distinct keys")
        for job, r in rows.items():
            if job == "records":
                continue
            pre = (f"pre-pass {r['prepass_s']:.4f} s, "
                   f"{r['sample_tasks_read']} tasks read; "
                   if "prepass_s" in r else "")
            print(f"keyskew: a={a} {job}: {r['wall_s']:.3f} s "
                  f"({r['tokens_per_s']:.0f} tokens/s); {pre}"
                  f"{r['n_split_keys']} split keys, {r['n_steals']} steals; "
                  f"owner loads max/mean {r['model_imbalance']:.4f} (model), "
                  f"window records max/mean {r['window_imbalance']:.4f} "
                  f"(measured: {r['window_records']})")
    print(f"keyskew: {c['seconds']:.1f} s")


def print_snapshots(c: dict):
    for backend in ("1s", "2s"):
        r = c[backend]
        print(f"snapshots: {backend}: plain {r['plain_s']} s, with a "
              f"checkpoint every {CKPT_EVERY}th segment (keep "
              f"{CKPT_KEEP}) {r['ckpt_s']} s: overhead "
              f"{r['overhead'] * 100:.2f} %; step {r['restored_from']} "
              f"restored into a fresh handle and finished in "
              f"{r['restored_s']:.3f} s; records == uninterrupted")
    r = c["replan"]
    print(f"snapshots: 1s re-planned halfway by replan_handle (hot rank "
          f"slowed in the tracker): {r['tasks_after']} unread tasks from "
          f"{r['columns_before']} columns to {r['columns_after']}, "
          f"{r['hot_rank_tasks_after']} on the hot rank; {r['wall_s']:.3f} s; "
          f"records == uninterrupted")
    print(f"snapshots: {c['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# 3e. the fleet (fig11_multitenant), 3f. io overlap (fig8_io_overlap)
# ---------------------------------------------------------------------------

# (a) the reference's fig11_multitenant at its own width: unfused jobs of
# the three use-cases, 3,145,728 tokens in all, one task a segment
FLEET_A = Width(vocab=4096, n_procs=8, task=1024, cap=512, segment=1)
FLEET_A_TOKENS = 3_145_728
FLEET_KS = (1, 4, 16)
# (b) the main path: K fused WordCount tenants at phase 3's width over
# slices of its 2**27-token corpus
FLEET_K = 8
FLEET_POLICIES = ("fifo", "fair", "priority")
SIZE_ZIPF = 2.0                 # job sizes: one giant tenant, many small
FLEET_BUDGET_SEGMENTS = {"a": 8, "b": 4}
OVERLAP_N = 2**25


def fleet_usecases(vocab: int) -> list:
    """fig11's rotation: (label, use-case)."""
    core, _, _, _, _ = _port()
    return [("wordcount", core.WordCount(vocab=vocab)),
            ("histogram", core.Histogram(vocab=vocab, n_bins=64)),
            ("inverted-index", core.InvertedIndex(
                queries=(3, 17, 42, 99), n_docs=8, tasks_per_doc=2))]


def zipf_weights(K: int) -> np.ndarray:
    w = np.arange(1, K + 1, dtype=np.float64) ** -SIZE_ZIPF
    return w / w.sum()


def fleet_a_sizes(K: int, total: int, w: Width) -> list[int]:
    """fig11's job sizes: Zipf(2.0) shares of ``total``, biggest first,
    at least P tasks each, in whole tasks."""
    sizes = []
    for share in zipf_weights(K):
        n = max(int(round(total * share)), w.n_procs * w.task)
        sizes.append(n - n % w.task)
    return sizes


def fleet_b_sizes(K: int, total: int, w: Width) -> list[int]:
    """Zipf(2.0) shares of ``total`` tokens, biggest first, in whole
    tasks that sum to ``total`` (largest remainders to the biggest)."""
    tasks = total // w.task
    n = np.floor(tasks * zipf_weights(K)).astype(np.int64)
    n[: tasks - int(n.sum())] += 1
    return (n * w.task).tolist()


def fleet_pinned_bytes(sched) -> int:
    """The pinned host bytes the fleet's feeds hold now (their staging
    pairs: made at a feed's first build on the card, given back at its
    close)."""
    return sum(t.nbytes for j in sched.jobs
               for t in (j.handle.feed._pinned or ()))


def fleet_steps(jobs: list, w: Width) -> int:
    return sum(-(-tasks_per_rank(j["n"], w) // w.segment) * w.segment
               for j in jobs)


def solo_runs(jobs: list, device):
    """Each job alone through ``submit``: its records (the fleet's gate)
    and its wall, synchronized."""
    for j in jobs:
        res, j["solo_wall"], _ = run_job(j["cfg"], j["data"], None, device)
        j["solo"] = res.records


def run_fleet(jobs: list, policy: str, device, budget_bytes: int,
              programs: int) -> dict:
    """One fleet through ``JobScheduler``: ``jobs`` submitted in order
    (biggest first), job k in its own tenant at ``priority=k``, under one
    FeedBudget of ``budget_bytes``, driven a slice at a time with the
    counts zeroed just before. Asserts every job's records equal its solo
    run, ``programs`` unique programs, and the finish order of ``fifo``
    (admission) and ``priority`` (descending). Returns makespan, mean and
    p95 latency, Jain's index over solo_wall / latency, the denials
    (summed over the feeds and the budget's own), graphs captured,
    fused_map launches and the pinned bytes' high-water."""
    core, _, _, ops, _ = _port()
    sched = core.JobScheduler(policy=policy, device=device,
                              max_live_bytes=budget_bytes)
    for k, j in enumerate(jobs):
        sched.submit(j["cfg"], j["data"], tenant=f"tenant-{k}",
                     name=j["name"], priority=k)
    zero_counts()
    captured = ops.fused_map.captured
    pinned = 0
    while any(j.state in ("queued", "live") for j in sched.jobs):
        sched.run_until_complete(max_slices=1)
        pinned = max(pinned, fleet_pinned_bytes(sched))
    launches = ops.fused_map.launches
    res = sched.results()
    names = [j["name"] for j in jobs]
    for j in jobs:
        assert res[j["name"]].records == j["solo"], (policy, j["name"])
    assert sched.n_unique_programs == programs, (policy,
                                                 sched.n_unique_programs)
    order = [j.name for j in sorted(sched.jobs,
                                    key=lambda j: j.finished_at)]
    if policy == "fifo":
        assert order == names, order
    if policy == "priority":
        assert order == names[::-1], order
    assert fleet_pinned_bytes(sched) == 0     # every finished feed freed
    lat = np.array([sched.latency(n) for n in names])
    x = np.array([j["solo_wall"] for j in jobs]) / lat
    return dict(makespan_s=float(lat.max()), mean_latency_s=float(lat.mean()),
                p95_latency_s=float(np.percentile(lat, 95)),
                jain=float(x.sum() ** 2 / (len(x) * (x ** 2).sum())),
                latencies_s=lat.tolist(), finish_order=order,
                feed_denials=sum(j.handle.feed.stats.budget_denials
                                 for j in sched.jobs),
                budget_denials=sched.budget.denials,
                graphs_captured=ops.fused_map.captured - captured,
                launches=launches, pinned_high_water_bytes=pinned,
                n_unique_programs=sched.n_unique_programs)


def fair_cycle_profile(jobs: list, device, budget_bytes: int) -> dict:
    """The device's busy share over one fair slice cycle (a slice of each
    of the K jobs) of the fleet, after a warm cycle (every tenant's
    graphs captured, every job still live): ``device_profile`` of
    ``run_until_complete(max_slices=K)``, the fleet then closed
    unfinished. The smallest tenants of (b) finish in that cycle."""
    core, _, _, _, _ = _port()
    sched = core.JobScheduler(policy="fair", device=device,
                              max_live_bytes=budget_bytes)
    for k, j in enumerate(jobs):
        sched.submit(j["cfg"], j["data"], tenant=f"tenant-{k}",
                     name=j["name"], priority=k)
    K = len(jobs)
    sched.run_until_complete(max_slices=K)
    assert all(j.state == "live" for j in sched.jobs)
    prof = device_profile(lambda: sched.run_until_complete(max_slices=K),
                          keep=("fused_map",))
    sched.close()
    return prof


def phase_fleet(device, corpus: np.ndarray, wa: Width = FLEET_A,
                total_a: int = FLEET_A_TOKENS, ks=FLEET_KS,
                wb: Width = FULL, k_full: int = FLEET_K) -> dict:
    """The reference's fig11_multitenant through the port's
    ``JobScheduler``: (a) at its own width ``wa``, for each K in ``ks`` a
    rotation of WordCount, Histogram and InvertedIndex unfused jobs of
    ``ZipfSource(n_k, V, seed=1000 + k)`` (``fleet_a_sizes``); (b) the
    main path, ``k_full`` fused WordCount tenants at ``wb`` over slices
    of ``corpus`` (``fleet_b_sizes``, the balanced grid), where each step
    must be one fused_map graph replay. Each job is run solo first; then
    each policy's fleet (``run_fleet``) under one FeedBudget of
    ``FLEET_BUDGET_SEGMENTS`` segments' bytes. For (b) also the solo
    walls' sum and the device's busy share over one fair slice cycle."""
    core, data, _, _, _ = _port()
    cuda = device.type == "cuda"
    out = {"a": {}, "b": {}}
    usecases = fleet_usecases(wa.vocab)
    for _, uc in usecases:                       # warm each program
        cfg = core.JobConfig(usecase=uc, task_size=wa.task,
                             push_cap=wa.cap, n_procs=wa.n_procs,
                             segment=wa.segment)
        run_job(cfg, data.ZipfSource(2 * wa.n_procs * wa.task, wa.vocab,
                                     seed=7), None, device)
    budget_a = FLEET_BUDGET_SEGMENTS["a"] * wa.n_procs * wa.segment \
        * wa.task * 4
    for K in ks:
        jobs = []
        for k, n in enumerate(fleet_a_sizes(K, total_a, wa)):
            label, uc = usecases[k % len(usecases)]
            jobs.append(dict(
                name=f"job-{k}", label=label, n=n,
                cfg=core.JobConfig(usecase=uc, task_size=wa.task,
                                   push_cap=wa.cap, n_procs=wa.n_procs,
                                   segment=wa.segment),
                data=data.ZipfSource(n, wa.vocab, seed=1000 + k)))
        solo_runs(jobs, device)
        row = out["a"][str(K)] = {
            "jobs": [dict(k=k, usecase=j["label"], n_tokens=j["n"],
                          solo_wall_s=j["solo_wall"])
                     for k, j in enumerate(jobs)],
            "steps": fleet_steps(jobs, wa)}
        for policy in FLEET_POLICIES:
            row[policy] = run_fleet(jobs, policy, device, budget_a,
                                    programs=min(K, len(usecases)))
            assert row[policy]["launches"] == 0      # unfused
    run_job(job_config(True, wb), corpus[: 2 * wb.segment * wb.task
                                         * wb.n_procs], None, device)
    jobs, lo = [], 0                             # warm, fused_map built
    for k, n in enumerate(fleet_b_sizes(k_full, len(corpus), wb)):
        jobs.append(dict(name=f"job-{k}", n=n, cfg=job_config(True, wb),
                         data=corpus[lo:lo + n]))
        lo += n
    assert lo == len(corpus)
    solo_runs(jobs, device)
    budget_b = FLEET_BUDGET_SEGMENTS["b"] * wb.n_procs * wb.segment \
        * wb.task * 4
    steps = fleet_steps(jobs, wb)
    b = out["b"] = {"jobs": [dict(k=k, n_tokens=j["n"],
                                  solo_wall_s=j["solo_wall"])
                             for k, j in enumerate(jobs)],
                    "solo_sum_s": sum(j["solo_wall"] for j in jobs),
                    "steps": steps, "budget_bytes": budget_b}
    for policy in FLEET_POLICIES:
        r = b[policy] = run_fleet(jobs, policy, device, budget_b, programs=1)
        r["makespan_over_solo_sum"] = r["makespan_s"] / b["solo_sum_s"]
        if cuda:
            assert r["launches"] == steps, (policy, r["launches"], steps)
            assert r["graphs_captured"] == len(jobs), r["graphs_captured"]
    if cuda:
        b["fair_cycle"] = fair_cycle_profile(jobs, device, budget_b)
    return out


def print_fleet(c: dict, wa: Width = FLEET_A, wb: Width = FULL):
    def line(tag, r):
        print(f"fleet: {tag}: makespan {r['makespan_s']:.3f} s, latency "
              f"mean {r['mean_latency_s']:.3f} s p95 "
              f"{r['p95_latency_s']:.3f} s, Jain {r['jain']:.4f}; budget "
              f"denials {r['feed_denials']} over the feeds, "
              f"{r['budget_denials']} by the FeedBudget; graphs captured "
              f"{r['graphs_captured']}, fused_map launches "
              f"{r['launches']}; pinned high-water "
              f"{r['pinned_high_water_bytes']} B; "
              f"{r['n_unique_programs']} programs")

    print(f"fleet: (a) fig11 at its width: unfused WordCount/Histogram/"
          f"InvertedIndex, P={wa.n_procs} S={wa.task} cap={wa.cap} "
          f"V={wa.vocab} segment={wa.segment}, Zipf({SIZE_ZIPF}) sizes "
          f"biggest first, FeedBudget of {FLEET_BUDGET_SEGMENTS['a']} "
          f"segments; every job's records == its solo run")
    for K, row in c["a"].items():
        solo = sum(j["solo_wall_s"] for j in row["jobs"])
        print(f"fleet: (a) K={K}: {row['steps']} steps, solo walls sum "
              f"{solo:.3f} s")
        for policy in FLEET_POLICIES:
            line(f"(a) K={K} {policy}", row[policy])
    b = c["b"]
    print(f"fleet: (b) K={len(b['jobs'])} fused WordCount tenants at "
          f"P={wb.n_procs} S={wb.task} cap={wb.cap} V={wb.vocab} "
          f"segment={wb.segment} over slices of the corpus "
          f"({[j['n_tokens'] for j in b['jobs']]} tokens), balanced grid, "
          f"FeedBudget {b['budget_bytes']} B; {b['steps']} steps; every "
          f"job's records == its solo run; solo walls sum "
          f"{b['solo_sum_s']:.3f} s")
    for policy in FLEET_POLICIES:
        r = b[policy]
        line(f"(b) {policy}", r)
        print(f"fleet: (b) {policy}: makespan / solo sum "
              f"{r['makespan_over_solo_sum']:.4f}; finish order "
              f"{r['finish_order']}")
    if "fair_cycle" in b:
        print_profile("fleet (b) one fair slice cycle", b["fair_cycle"])
    print(f"fleet: {c['seconds']:.1f} s")


def phase_overlap(device, corpus: np.ndarray, w: Width = FULL,
                  n: int = OVERLAP_N) -> dict:
    """The reference's fig8_io_overlap, its real run: the first ``n``
    tokens of ``corpus`` (phase 3's 2**25-token corpus) written once to a
    temporary file; the fused job at ``w`` on phase 3's unbalanced grid,
    resident (the array, ``prefetch=False``) against streamed
    (``MmapTokenSource``, ``prefetch=True``), in turns (resident,
    streamed, streamed, resident), each timed from its engine's creation
    to its records, synchronized: every run's records equal. Returns each
    wall, ``1 - streamed/resident`` of the means, prefetch hits, segments
    built and the feed's host seconds a segment."""
    import tempfile
    core, data, _, ops, _ = _port()
    tokens = corpus[:n]
    oracle = core.wordcount_oracle(tokens, w.vocab)
    T = tasks_per_rank(n, w)
    reps = grid_repeats("unbalanced", T, w)
    steps = -(-T // w.segment) * w.segment
    out = {"n": n, "steps": steps, "resident": [], "streamed": []}
    run_job(job_config(True, w), tokens[: 2 * w.segment * w.task
                                        * w.n_procs], None, device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.bin")
        tokens.tofile(path)
        for mode in ("resident", "streamed", "streamed", "resident"):
            src = tokens if mode == "resident" else data.MmapTokenSource(
                path)
            h = core.submit(job_config(True, w), src, device=device,
                            repeats=reps, prefetch=mode == "streamed")
            h.engine                               # the carry, untimed
            zero_counts()
            t0 = time.perf_counter()
            res = h.result()
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert res.records == oracle, mode
            if device.type == "cuda":
                assert ops.fused_map.launches == steps, mode
            st = h.feed.stats
            out[mode].append(dict(
                wall_s=wall, launches=ops.fused_map.launches,
                prefetch_hits=st.prefetch_hits,
                segments=st.segments_built,
                feed_s_per_segment=st.build_seconds / st.segments_built))
    mean = {m: float(np.mean([r["wall_s"] for r in out[m]]))
            for m in ("resident", "streamed")}
    out["overlap_win"] = 1 - mean["streamed"] / mean["resident"]
    return out


def print_overlap(c: dict, w: Width = FULL):
    print(f"overlap: fig8 real run, fused WordCount N={c['n']} at "
          f"P={w.n_procs} S={w.task} cap={w.cap} V={w.vocab} "
          f"segment={w.segment}, unbalanced grid, in turns; every run's "
          f"records == oracle")
    for mode in ("resident", "streamed"):
        for r in c[mode]:
            print(f"overlap: {mode}: {r['wall_s']:.3f} s, fused_map "
                  f"launches {r['launches']} of {c['steps']} steps, "
                  f"{r['prefetch_hits']} prefetch hits of {r['segments']} "
                  f"segments, {r['feed_s_per_segment']:.4f} s a segment on "
                  f"the host")
    print(f"overlap: 1 - streamed/resident {c['overlap_win']:.4f}")
    print(f"overlap: {c['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# 3g. the coded shuffle; 3h. cross-job co-scheduling
# ---------------------------------------------------------------------------

# 3g: the reference's fig15_coded real run at its full width (oneshot)
CODED_W = Width(vocab=65536, n_procs=6, task=4096, cap=1024, segment=0)
CODED_N = 786_432
CODED_SKEWS = (0.0, 0.6, 1.1, 1.6)
CODED_MEAN_REP = 4
CODED_ARMS = ("r1", "r2", "r3", "r2+steal", "r1-fused")
CODED_RUNS = 2
CODED_PROFILE_STEPS = 8         # the busy share's segment, in steps
# 3h: the reference's fig14_crossjob real run at its full width
CROSS_W = Width(vocab=4096, n_procs=8, task=1024, cap=512, segment=1)
CROSS_TOTAL = 786_432
CROSS_KS = (4, 16)
CROSS_PACK = 4
CROSS_TAIL_SKEW, CROSS_MEAN_REP = 1.6, 3


def coded_arm(arm: str, w: Width = CODED_W):
    """A 3g arm's JobConfig: ``r<k>`` the unfused job at code rate k,
    ``+steal`` with work stealing, ``r1-fused`` the fused job (the main
    path) at the same task size."""
    core, _, _, _, _ = _port()
    return core.JobConfig(
        core.WordCount(vocab=w.vocab), backend="1s", task_size=w.task,
        push_cap=w.cap, n_procs=w.n_procs, segment=w.segment,
        fused_map=arm == "r1-fused", stealing=arm.endswith("+steal"),
        code_rate=int(arm[1]))


def run_coded(cfg, corpus, reps, device) -> dict:
    """One 3g job through ``submit``, its launch counts zeroed just
    before, synchronized: its result, wall, fused_map launches, the
    feed's bytes and, stealing, its engine's ``StealStats``."""
    core, _, _, ops, _ = _port()
    zero_counts()
    t0 = time.perf_counter()
    h = core.submit(cfg, corpus, device=device, repeats=reps)
    res = h.result()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(result=res, wall_s=wall, launches=ops.fused_map.launches,
               feed_bytes_read=h.feed.stats.bytes_read)
    if cfg.stealing:
        out["steal"] = dataclasses.asdict(h.engine.steal)
    return out


def coded_replay(n: int, reps: np.ndarray, r: int, w: Width) -> dict:
    """The group host replay of a oneshot coded stealing job (one segment
    of the r-replicated grid): steals, passes and the work row."""
    _port()
    from repro_torch.core import coded, planner, steal
    ids = planner.shard_task_ids(planner.plan_input(n, w.task, w.n_procs))
    s = steal.coded_steal_schedule(*coded.replicate_grids(ids, reps, r), r)
    return {"steals": s.n_stolen, "passes": s.passes,
            "work": s.work.tolist()}


def phase_coded(device, corpus: np.ndarray | None = None,
                w: Width = CODED_W, skews=CODED_SKEWS,
                runs: int = CODED_RUNS) -> dict:
    """The reference's fig15_coded real run: WordCount over
    ``synth_corpus(N, V, seed=0)`` (host memory) at ``w``, under
    ``zipf_skew_repeats(P, T, s, mean_rep=4, seed=1)`` for each skew, the
    arms r1, r2, r3 and r2+steal unfused and r1-fused, all on one grid;
    a warm-up of each arm, then ``runs`` timed runs of each in turns
    (arms forward, then backward). Every run's records equal the
    oracle's (and so r1's);
    fused_map launches 0 on every coded arm and one a step on r1-fused
    (on the card); r2+steal's steals, passes and work row equal the group
    replay's, a group's members equal. Also the modelled shuffle bytes,
    and at the top skew each arm's device busy share over one segment of
    ``CODED_PROFILE_STEPS`` steps (``segment_profile``)."""
    core, data, _, _, _ = _port()
    from repro_torch.core import coded
    cuda = device.type == "cuda"
    if corpus is None:
        corpus = data.synth_corpus(CODED_N, w.vocab, seed=0)
    n = len(corpus)
    oracle = core.wordcount_oracle(corpus, w.vocab)
    T = tasks_per_rank(n, w)
    t0 = time.perf_counter()
    warm = data.zipf_skew_repeats(w.n_procs, T, skews[0],
                                  mean_rep=CODED_MEAN_REP, seed=1)
    for arm in CODED_ARMS:
        run_coded(coded_arm(arm, w), corpus, warm, device)
    out = {"n": n, "tasks_per_rank": T, "skews": {},
           "warm_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for s in skews:
        reps = data.zipf_skew_repeats(w.n_procs, T, s,
                                      mean_rep=CODED_MEAN_REP, seed=1)
        row = {arm: {"walls_s": []} for arm in CODED_ARMS}
        for turn in range(runs):
            for arm in (CODED_ARMS if turn % 2 == 0 else CODED_ARMS[::-1]):
                cfg = coded_arm(arm, w)
                run = run_coded(cfg, corpus, reps, device)
                res = run["result"]
                assert res.records == oracle, (s, arm)
                steps = T
                if arm != "r1-fused" or not cuda:
                    assert run["launches"] == 0, (s, arm, run["launches"])
                else:
                    assert run["launches"] == steps, (s, run["launches"])
                r = cfg.code_rate
                e = row[arm]
                e["walls_s"].append(run["wall_s"])
                e.update(r=r, steps=steps, launches=run["launches"],
                         n_steals=res.n_steals,
                         feed_bytes_read=run["feed_bytes_read"],
                         work_per_rank=res.work_per_rank.tolist(),
                         shuffle_bytes=coded.shuffle_bytes(
                             w.n_procs, steps, w.cap, r))
                if cfg.stealing:
                    rep = coded_replay(n, reps, r, w)
                    assert res.n_steals == rep["steals"], (s, res.n_steals,
                                                           rep)
                    assert res.work_per_rank.tolist() == rep["work"], s
                    assert run["steal"]["passes"] == rep["passes"], s
                    wk = res.work_per_rank.reshape(-1, r)
                    assert (wk == wk[:, :1]).all(), wk
                    e.update(passes=rep["passes"],
                             schedule_s=run["steal"]["schedule_s"])
        for arm, e in row.items():
            e["wall_s"] = float(np.mean(e["walls_s"]))
            e["tokens_per_s"] = n / e["wall_s"]
            e["ms_per_step"] = e["wall_s"] / e["steps"] * 1e3
            e["shuffle_ratio_to_r1"] = (e["shuffle_bytes"]
                                        / row["r1"]["shuffle_bytes"])
            e["wall_over_r1"] = e["wall_s"] / row["r1"]["wall_s"]
        out["skews"][str(s)] = row
    out["runs_s"] = time.perf_counter() - t0
    if cuda:
        t0 = time.perf_counter()
        reps = data.zipf_skew_repeats(w.n_procs, T, skews[-1],
                                      mean_rep=CODED_MEAN_REP, seed=1)
        out["profiles"] = {arm: segment_profile(
            dataclasses.replace(coded_arm(arm, w),
                                segment=CODED_PROFILE_STEPS),
            corpus, reps, device) for arm in CODED_ARMS}
        out["profile_s"] = time.perf_counter() - t0
    return out


def print_coded(c: dict, w: Width = CODED_W):
    print(f"coded: fig15 real run, WordCount N={c['n']} at P={w.n_procs} "
          f"S={w.task} cap={w.cap} V={w.vocab}, oneshot, "
          f"{c['tasks_per_rank']} steps, r1-fused on r1's grid; every "
          f"run's records == oracle; fused_map launches 0 on every coded "
          f"arm")
    print("coded: on one card the exchange is a transpose in device memory "
          "and no byte crosses a wire: the shuffle bytes are the model's "
          "(core/coded.shuffle_bytes); what is measured is the r x map work")
    for s, row in c["skews"].items():
        for arm, e in row.items():
            steal = (f", passes {e['passes']} == replay, schedule "
                     f"{e['schedule_s']:.4f} s" if "passes" in e else "")
            print(f"coded: s={s} {arm}: {e['wall_s']:.3f} s "
                  f"({[round(x, 4) for x in e['walls_s']]}), "
                  f"{e['tokens_per_s']:.0f} tokens/s, {e['ms_per_step']:.3f} "
                  f"ms a step, wall/r1 {e['wall_over_r1']:.3f}; steals "
                  f"{e['n_steals']}{steal}; feed bytes "
                  f"{e['feed_bytes_read']}; shuffle bytes (model) "
                  f"{e['shuffle_bytes']}, {e['shuffle_ratio_to_r1']:.2f} of "
                  f"r1's; fused_map launches {e['launches']}; work "
                  f"{e['work_per_rank']}")
    for arm, p in c.get("profiles", {}).items():
        print_profile(f"coded {arm} at s={list(c['skews'])[-1]}, one "
                      f"segment of {CODED_PROFILE_STEPS} steps", p)
    print(f"coded: {c['seconds']:.1f} s (warm-up {c['warm_s']:.1f} s, "
          f"timed runs {c['runs_s']:.1f} s, profiles "
          f"{c.get('profile_s', 0.0):.1f} s)")


def cross_jobs(K: int, total: int, w: Width) -> list:
    """fig14's jobs: Zipf(2.0) sizes of ``total`` (``fleet_a_sizes``),
    job k over ``ZipfSource(n, V, seed=2000 + k)`` with its hot rank
    rolled to k (``np.roll(zipf_skew_repeats(P, T, 1.6, mean_rep=3,
    seed=k), k, axis=0)``), stealing, segment 1."""
    core, data, _, _, _ = _port()
    jobs = []
    for k, n in enumerate(fleet_a_sizes(K, total, w)):
        T = tasks_per_rank(n, w)
        reps = np.roll(data.zipf_skew_repeats(
            w.n_procs, T, CROSS_TAIL_SKEW, mean_rep=CROSS_MEAN_REP, seed=k),
            k, axis=0)
        jobs.append(dict(
            k=k, name=f"job-{k}", n=n, reps=reps,
            work=int(reps[planner_ids(n, w) >= 0].sum()),
            cfg=core.JobConfig(core.WordCount(vocab=w.vocab),
                               task_size=w.task, push_cap=w.cap,
                               n_procs=w.n_procs, segment=w.segment,
                               stealing=True),
            data=data.ZipfSource(n, w.vocab, seed=2000 + k)))
    return jobs


def planner_ids(n: int, w: Width) -> np.ndarray:
    _port()
    from repro_torch.core import planner
    return planner.shard_task_ids(planner.plan_input(n, w.task, w.n_procs))


def run_cross_fleet(jobs: list, cosched: bool, device,
                    pack: int = CROSS_PACK) -> dict:
    """One fig14 fleet under fair share (``coschedule`` and ``copack``
    when ``cosched``), job k at ``priority=k`` in its own tenant, launch
    counts zeroed just before: every job's records equal its solo run's,
    no fused_map launch; co-scheduled, one domain, cross-rank steals in
    it and its ``job_work`` summing to the members' repeats. Returns
    makespan, mean and p95 latency, Jain's index over solo_wall /
    latency, the steals and ``job_work``."""
    core, _, _, ops, _ = _port()
    sched = core.JobScheduler(policy="fair", device=device,
                              coschedule=cosched,
                              copack=pack if cosched else None)
    for j in jobs:
        sched.submit(j["cfg"], j["data"], tenant=f"tenant-{j['k']}",
                     name=j["name"], repeats=j["reps"], priority=j["k"])
    zero_counts()
    res = sched.run_until_complete()
    for j in jobs:
        assert res[j["name"]].records == j["solo"], (cosched, j["name"])
    assert ops.fused_map.launches == 0
    lat = np.array([sched.latency(j["name"]) for j in jobs])
    x = np.array([j["solo_wall"] for j in jobs]) / lat
    out = dict(makespan_s=float(lat.max()), mean_latency_s=float(lat.mean()),
               p95_latency_s=float(np.percentile(lat, 95)),
               jain=float(x.sum() ** 2 / (len(x) * (x ** 2).sum())),
               latencies_s=lat.tolist(),
               steals=int(sum(res[j["name"]].n_steals for j in jobs)),
               n_unique_programs=sched.n_unique_programs)
    if cosched:
        assert len(sched._domains) == 1, len(sched._domains)
        d = sched._domains[0]
        jw = d.job_work()
        out.update(n_domains=1, job_work=jw.tolist(),
                   steals=int(d.handle._carry.stolen[0].sum()),
                   domain_steps=int(d.handle.feed.total_columns))
        assert out["steals"] > 0, "no cross-rank steal in the domain"
        assert int(jw.sum()) == sum(j["work"] for j in jobs), jw
        assert jw.tolist() == [j["work"] for j in jobs], jw
    return out


def phase_crossjob(device, w: Width = CROSS_W, total: int = CROSS_TOTAL,
                   ks=CROSS_KS) -> dict:
    """The reference's fig14_crossjob real run: for each K, ``cross_jobs``
    each run solo (its records, the gate, and its wall), then warm, then
    ``fair`` against ``fair`` + ``coschedule=True, copack=4``
    (``run_cross_fleet``)."""
    core, _, _, _, _ = _port()
    out = {}
    for K in ks:
        jobs = cross_jobs(K, total, w)
        for j in jobs:
            t0 = time.perf_counter()
            res = core.submit(j["cfg"], j["data"], device=device,
                              repeats=j["reps"]).result()
            if device.type == "cuda":
                torch.cuda.synchronize()
            j["solo_wall"] = time.perf_counter() - t0
            j["solo"] = res.records
        row = out[str(K)] = {
            "jobs": [dict(k=j["k"], n_tokens=j["n"],
                          solo_wall_s=j["solo_wall"], work=j["work"])
                     for j in jobs],
            "solo_sum_s": sum(j["solo_wall"] for j in jobs),
            "steps": sum(tasks_per_rank(j["n"], w) for j in jobs)}
        for label, cos in (("fair", False), ("fair+cosched", True)):
            if K == ks[0]:
                run_cross_fleet(jobs, cos, device)        # warm
            row[label] = run_cross_fleet(jobs, cos, device)
        row["cosched_over_fair_makespan"] = (
            row["fair+cosched"]["makespan_s"] / row["fair"]["makespan_s"])
    return out


def print_crossjob(c: dict, w: Width = CROSS_W):
    print(f"crossjob: fig14 real run, WordCount at P={w.n_procs} "
          f"S={w.task} cap={w.cap} V={w.vocab} segment={w.segment}, "
          f"stealing, Zipf({SIZE_ZIPF}) sizes of {CROSS_TOTAL} tokens, "
          f"job k's hot rank k (skew {CROSS_TAIL_SKEW}, mean repeat "
          f"{CROSS_MEAN_REP}), priority=k; fair against fair + coschedule "
          f"(copack {CROSS_PACK}); every job's records == its solo run, no "
          f"fused_map launch")
    for K, row in c.items():
        if K == "seconds":
            continue
        print(f"crossjob: K={K}: {row['steps']} solo steps, solo walls sum "
              f"{row['solo_sum_s']:.3f} s")
        for label in ("fair", "fair+cosched"):
            r = row[label]
            dom = (f"; 1 domain of {r['domain_steps']} columns, job_work "
                   f"{r['job_work']} == the members' repeats"
                   if "job_work" in r else "")
            print(f"crossjob: K={K} {label}: makespan {r['makespan_s']:.3f} "
                  f"s, latency mean {r['mean_latency_s']:.3f} s p95 "
                  f"{r['p95_latency_s']:.3f} s, Jain {r['jain']:.4f}, steals "
                  f"{r['steals']}{dom}")
        print(f"crossjob: K={K}: cosched/fair makespan "
              f"{row['cosched_over_fair_makespan']:.4f}")
    print(f"crossjob: {c['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# 3i. the elastic fleet: fig13_elastic, and the main path re-meshed
# ---------------------------------------------------------------------------

# (a): the reference's fig13_elastic real run at its own width, uncut: K 4
# unfused jobs of 49,152 uniform tokens from default_rng(13), P 8 -> 6
ELASTIC_W = Width(vocab=512, n_procs=8, task=64, cap=256, segment=4)
ELASTIC_P_NEW, ELASTIC_K, ELASTIC_TOKENS = 6, 4, 49_152
ELASTIC_CKPT_EVERY, ELASTIC_SLICES = 2, 4
# (b): the fused MR-1S at phase 3's width on the first 2**25 tokens of its
# corpus, re-meshed 8 -> 6 at half its segments and 6 -> 8 at half of the
# restored job's
ELASTIC_N = 2**25


def elastic_jobs(w: Width, n: int, K: int) -> dict:
    """fig13's jobs: WordCount and ``Histogram(n_bins=64)`` in turn, each
    over ``n`` uniform tokens drawn in order from ``default_rng(13)``."""
    core, _, _, _, _ = _port()
    rng = np.random.default_rng(13)
    ucs = (core.WordCount(vocab=w.vocab),
           core.Histogram(vocab=w.vocab, n_bins=64))
    return {f"job-{k}": (ucs[k % len(ucs)],
                         rng.integers(0, w.vocab, size=n).astype(np.int32))
            for k in range(K)}


def elastic_config(uc, P: int, w: Width):
    core, _, _, _, _ = _port()
    return core.JobConfig(usecase=uc, backend="1s", task_size=w.task,
                          push_cap=w.cap, segment=w.segment, n_procs=P)


def run_campaign(jobs: dict, solo: dict | None, device, w: Width,
                 p_new: int, *, ckpt_every: int, slices: int,
                 kill_tick: int | None = None, restore: bool = True,
                 n: int | None = None) -> dict:
    """One fig13 campaign: the jobs (cut to ``n`` tokens when given)
    under a ``FleetSupervisor`` at ``w.n_procs`` ranks, ranks ``0 ..
    P - p_new - 1`` killed at ``kill_tick``, launch counts zeroed just
    before: no job failed, no fused_map launch, every job's records equal
    to ``solo``'s. Returns the wall, ticks, final rank count and the
    recoveries."""
    import tempfile

    from repro_torch.fleet import FaultEvent, FaultPlan, FleetSupervisor
    _, _, _, ops, _ = _port()
    kill = tuple(range(w.n_procs - p_new))
    events = (() if kill_tick is None
              else (FaultEvent(kill_tick, "kill", ranks=kill),))
    with tempfile.TemporaryDirectory() as d:
        sup = FleetSupervisor(n_procs=w.n_procs, ckpt_dir=d,
                              plan=FaultPlan(events), ckpt_every=ckpt_every,
                              slices_per_tick=slices,
                              restore_on_remesh=restore, device=device)
        for name, (uc, toks) in jobs.items():
            sup.submit(elastic_config(uc, w.n_procs, w),
                       toks if n is None else toks[:n], name=name)
        zero_counts()
        t0 = time.perf_counter()
        res = sup.run(max_ticks=100_000)
        _sync(device)
        wall = time.perf_counter() - t0
        sup.close()
    assert not sup.failed, sup.failed
    assert ops.fused_map.launches == 0
    assert set(res) == set(jobs)
    for name in solo or ():
        assert res[name].records == solo[name], (name, kill_tick, restore)
    return dict(wall_s=wall, ticks=sup.ticks_run, final_p=sup.n_procs,
                recoveries=[dataclasses.asdict(r) for r in sup.recoveries])


def phase_elastic_fleet(device, w: Width = ELASTIC_W,
                        n: int = ELASTIC_TOKENS, K: int = ELASTIC_K,
                        p_new: int = ELASTIC_P_NEW) -> dict:
    """fig13's real run: each job solo at P and at P_new (the baselines,
    and the engines warm), a killed mini-fleet (the re-mesh path warm),
    then the campaigns clean, recover (killed at 2/3 of clean's ticks,
    every live job elastic-restored) and restart (the same kill, the
    snapshots ignored): every job in every campaign equal to its solo
    run, both killed arms ending at P_new, recover restoring every live
    job and restarting none."""
    core, _, _, _, _ = _port()
    jobs = elastic_jobs(w, n, K)
    solo, solo_s = {}, {}
    for P in (w.n_procs, p_new):
        for name, (uc, toks) in jobs.items():
            t0 = time.perf_counter()
            res = core.submit(elastic_config(uc, P, w), toks,
                              device=device).result()
            _sync(device)
            solo_s[f"{name}@{P}"] = time.perf_counter() - t0
            if P == w.n_procs:
                solo[name] = res.records
            assert res.records == solo[name], (name, P)
    t0 = time.perf_counter()
    warm = run_campaign(jobs, None, device, w, p_new, ckpt_every=1,
                        slices=1, kill_tick=2,
                        n=w.task * w.n_procs * w.segment * 4)
    assert warm["recoveries"], "the warm-up fleet did not re-mesh"
    warm_s = time.perf_counter() - t0
    kw = dict(ckpt_every=ELASTIC_CKPT_EVERY, slices=ELASTIC_SLICES)
    clean = run_campaign(jobs, solo, device, w, p_new, **kw)
    assert clean["final_p"] == w.n_procs and not clean["recoveries"]
    kill_tick = max(2, 2 * clean["ticks"] // 3)
    recover = run_campaign(jobs, solo, device, w, p_new, kill_tick=kill_tick,
                           **kw)
    restart = run_campaign(jobs, solo, device, w, p_new, kill_tick=kill_tick,
                           restore=False, **kw)
    for arm in (recover, restart):
        assert arm["final_p"] == p_new, arm["final_p"]
        [r] = arm["recoveries"]
        assert (r["kind"], r["p_old"], r["p_new"]) == ("kill", w.n_procs,
                                                       p_new), r
    rec, res_ = recover["recoveries"][0], restart["recoveries"][0]
    assert rec["jobs_scratch"] == 0 and rec["jobs_restored"] > 0, rec
    assert res_["jobs_restored"] == 0 and res_["jobs_scratch"] > 0, res_
    return dict(n=n, K=K, p=w.n_procs, p_new=p_new, solo_s=solo_s,
                warm_s=warm_s, kill_tick=kill_tick,
                clean=clean, recover=recover, restart=restart,
                mttr_s=rec["seconds"],
                recover_over_clean=recover["wall_s"] / clean["wall_s"],
                restart_over_clean=restart["wall_s"] / clean["wall_s"],
                restart_minus_recover_s=restart["wall_s"]
                - recover["wall_s"])


def _run_part(h, device, n_segments: int | None = None) -> dict:
    """Step ``h`` ``n_segments`` segments (all, when None), synchronised:
    the part's wall and steps (columns run, padding included)."""
    c0 = h.cursor
    t0 = time.perf_counter()
    if n_segments is None:
        while h.step():
            pass
    else:
        h.step(n_segments)
    _sync(device)
    wall = time.perf_counter() - t0
    seg = h.feed.segment
    return dict(wall_s=wall, steps=-(-(h.cursor - c0) // seg) * seg,
                columns=h.cursor - c0)


def _restored(core, cfg, corpus, mgr, device) -> tuple:
    """A fresh fused handle at ``cfg.n_procs`` elastic-restored from
    ``mgr``: (handle, its step graphs, seconds of the restore). The
    handle's graphs write its own carry and hold no capture yet."""
    from repro_torch.fleet import elastic_restore
    t0 = time.perf_counter()
    h = elastic_restore(core.submit(cfg, corpus, device=device), mgr)
    _sync(device)
    s = time.perf_counter() - t0
    graphs = h.engine.graphs
    if device.type == "cuda":
        assert graphs is not None and graphs.carry is h.carry
        assert not graphs.graphs, "graphs captured before the first step"
    return h, graphs, s


def _fold_seconds(mgr, P_new: int, device) -> dict:
    """The fold's parts on the snapshot in ``mgr``, each timed alone: the
    host twin (``fold_windows`` and its wrapped sum), the device fold
    (``fold_program``, inputs already on the device, its second call),
    and ``rebucketize_tasks``; the checksum equal to the twin's."""
    from repro_torch.fleet.remesh import (_wrap_i32_sum, _zeros_like_carry,
                                          fold_inputs, fold_program)
    from repro_torch.ft.elastic import fold_windows, rebucketize_tasks
    _, carry, extra = mgr.restore(_zeros_like_carry())
    tables, groups, om, osplit = fold_inputs(carry, P_new, "hash")
    t0 = time.perf_counter()
    twin = _wrap_i32_sum(fold_windows(tables, P_new))
    host_s = time.perf_counter() - t0
    fn = fold_program(tables.shape[0], P_new, tables.shape[1], device)
    args = [torch.from_numpy(a).to(device) for a in (groups, om, osplit)]
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    device_s = time.perf_counter() - t0
    assert int(out[3][0]) == twin, (int(out[3][0]), twin)
    t0 = time.perf_counter()
    ids, _ = rebucketize_tasks(np.asarray(extra["task_ids"], np.int32),
                               np.asarray(extra["repeats"], np.int32),
                               int(extra["cursor"]), P_new)
    rebucket_s = time.perf_counter() - t0
    return dict(host_twin_s=host_s, device_fold_s=device_s,
                rebucketize_s=rebucket_s, checksum=twin,
                windows=list(tables.shape), tasks_left=int((ids >= 0).sum()),
                columns_left=int(ids.shape[1]))


def phase_elastic_job(device, corpus: np.ndarray, w: Width = FULL,
                      n: int = ELASTIC_N,
                      p_new: int = ELASTIC_P_NEW) -> dict:
    """The main path re-meshed: the fused MR-1S on the first ``n``
    tokens of ``corpus`` at P on phase 3's unbalanced grid, snapshotted
    at half its segments and run on (the uninterrupted job: records equal
    to the oracle); the snapshot elastic-restored into a fresh fused
    handle at ``p_new`` (8 -> 6), snapshotted again at half its segments
    and finished; that snapshot restored into a fresh handle at P
    (8 -> 6 -> 8) and finished. Every arm's records equal the
    uninterrupted job's; on the card one fused_map launch a step on every
    side (counts zeroed just before each), each restored handle capturing
    its own graphs. The fold's parts timed alone (``_fold_seconds``)."""
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    core, _, _, ops, _ = _port()
    corpus = corpus[:n]
    oracle = core.wordcount_oracle(corpus, w.vocab)
    T = tasks_per_rank(n, w)
    reps = grid_repeats("unbalanced", T, w)
    cfg8 = engine_config("1s", w)
    cfg6 = engine_config("1s", dataclasses.replace(w, n_procs=p_new))
    cuda = device.type == "cuda"
    out = {}

    def counted(part, graphs=None, captured0=0):
        part["launches"] = ops.fused_map.launches
        if cuda:
            assert part["launches"] == part["steps"], part
            assert graphs.replays == part["steps"], graphs.replays
            part["graphs_captured"] = len(graphs.graphs)
            assert ops.fused_map.captured - captured0 == len(graphs.graphs)
        return part

    with tempfile.TemporaryDirectory() as d:
        mgr8 = CheckpointManager(os.path.join(d, "p8"))
        mgr6 = CheckpointManager(os.path.join(d, "p6"))
        zero_counts()
        cap0 = ops.fused_map.captured
        h = core.submit(cfg8, corpus, device=device, repeats=reps)
        graphs = h.engine.graphs          # released by result()
        half = -(-T // w.segment) // 2
        first = _run_part(h, device, half)
        t0 = time.perf_counter()
        h.checkpoint(mgr8).result()
        snap_s = time.perf_counter() - t0
        second = _run_part(h, device)
        want = h.result().records
        assert want == oracle, "the uninterrupted job"
        steps8 = first["steps"] + second["steps"]
        out["p8"] = counted(dict(first=first, second=second,
                                 snapshot_s=snap_s, steps=steps8),
                            graphs, cap0)
        out["fold"] = _fold_seconds(mgr8, p_new, device)

        zero_counts()
        cap0 = ops.fused_map.captured
        h6, graphs6, restore_s = _restored(core, cfg6, corpus, mgr8, device)
        half6 = -(-h6.feed.total_columns // w.segment) // 2
        a = _run_part(h6, device, half6)
        t0 = time.perf_counter()
        h6.checkpoint(mgr6).result()
        snap6_s = time.perf_counter() - t0
        b = _run_part(h6, device)
        assert h6.result().records == want, "8 -> 6"
        out["p6"] = counted(dict(restore_s=restore_s, first=a, second=b,
                                 snapshot_s=snap6_s,
                                 steps=a["steps"] + b["steps"],
                                 wall_s=a["wall_s"] + b["wall_s"]),
                            graphs6, cap0)

        zero_counts()
        cap0 = ops.fused_map.captured
        h8, graphs8, restore8_s = _restored(core, cfg8, corpus, mgr6,
                                            device)
        c = _run_part(h8, device)
        assert h8.result().records == want, "8 -> 6 -> 8"
        out["p6p8"] = counted(dict(restore_s=restore8_s, **c), graphs8,
                              cap0)
    out["p6_over_p8_second_half"] = (out["p6"]["wall_s"]
                                     / out["p8"]["second"]["wall_s"])
    out.update(n=n, p=w.n_procs, p_new=p_new, n_records=len(want),
               tasks=int((planner_ids(n, w) >= 0).sum()))
    return out


def phase_elastic(device, corpus: np.ndarray) -> dict:
    """Phase 3i: (a) ``phase_elastic_fleet``, (b) ``phase_elastic_job``,
    each part's seconds."""
    t0 = time.perf_counter()
    a = phase_elastic_fleet(device)
    a["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = phase_elastic_job(device, corpus)
    b["seconds"] = time.perf_counter() - t0
    return {"a": a, "b": b}


def print_elastic(c: dict, wa: Width = ELASTIC_W, wb: Width = FULL):
    a, b = c["a"], c["b"]
    print(f"elastic: (a) fig13 real run, K={a['K']} unfused jobs "
          f"(WordCount, Histogram(n_bins=64)) of {a['n']} uniform "
          f"tokens, V={wa.vocab} P={a['p']} -> {a['p_new']} "
          f"S={wa.task} cap={wa.cap} segment={wa.segment}, ckpt_every "
          f"{ELASTIC_CKPT_EVERY}, {ELASTIC_SLICES} slices a tick, kill at "
          f"tick {a['kill_tick']}; every job in every campaign == its solo "
          f"run, no fused_map launch; solo runs and warm-up "
          f"{sum(a['solo_s'].values()) + a['warm_s']:.2f} s")
    for arm in ("clean", "recover", "restart"):
        r = a[arm]
        rec = "".join(f"; {x['kind']} {x['p_old']} -> {x['p_new']} in "
                      f"{x['seconds']:.4f} s, {x['jobs_restored']} restored, "
                      f"{x['jobs_scratch']} from scratch"
                      for x in r["recoveries"])
        print(f"elastic: (a) {arm}: {r['wall_s']:.3f} s, {r['ticks']} ticks, "
              f"ends at P={r['final_p']}{rec}")
    print(f"elastic: (a) MTTR {a['mttr_s']:.4f} s; recover/clean "
          f"{a['recover_over_clean']:.4f}, restart/clean "
          f"{a['restart_over_clean']:.4f}, restart - recover "
          f"{a['restart_minus_recover_s']:.3f} s")
    f = b["fold"]
    print(f"elastic: (b) the fused MR-1S, N={b['n']} V={wb.vocab} "
          f"P={wb.n_procs} S={wb.task} cap={wb.cap} segment={wb.segment}, "
          f"unbalanced grid, {b['tasks']} tasks: {b['p']} -> {b['p_new']} -> "
          f"{b['p']}, "
          f"every arm's {b['n_records']} records == the uninterrupted "
          f"job's (== oracle), checksum {f['checksum']} == the host twin's")
    print(f"elastic: (b) fold of {f['windows'][0]} x {f['windows'][1]} "
          f"windows onto {b['p_new']}: host twin {f['host_twin_s']:.4f} "
          f"s, device fold {f['device_fold_s']:.6f} s, rebucketize_tasks "
          f"{f['rebucketize_s']:.4f} s ({f['tasks_left']} tasks left in "
          f"{f['columns_left']} columns)")
    p8, p6, p68 = b["p8"], b["p6"], b["p6p8"]
    print(f"elastic: (b) P={b['p']}: first half {p8['first']['wall_s']:.3f} s "
          f"({p8['first']['steps']} steps), snapshot "
          f"{p8['snapshot_s']:.3f} s, second half "
          f"{p8['second']['wall_s']:.3f} s ({p8['second']['steps']} steps); "
          f"fused_map launches {p8['launches']}")
    print(f"elastic: (b) {b['p']} -> {b['p_new']}: restore "
          f"{p6['restore_s']:.3f}"
          f" s, {p6['wall_s']:.3f} s for {p6['steps']} steps (snapshot at "
          f"half {p6['snapshot_s']:.3f} s), launches {p6['launches']}, "
          f"graphs captured {p6.get('graphs_captured', 0)}; over the "
          f"P={b['p']} job's second half {b['p6_over_p8_second_half']:.4f}")
    print(f"elastic: (b) {b['p_new']} -> {b['p']}: restore "
          f"{p68['restore_s']:.3f} s, {p68['wall_s']:.3f} s for "
          f"{p68['steps']} steps, launches {p68['launches']}, graphs "
          f"captured {p68.get('graphs_captured', 0)}")
    print(f"elastic: {c['seconds']:.1f} s ((a) {a['seconds']:.1f} s, (b) "
          f"{b['seconds']:.1f} s)")


# ---------------------------------------------------------------------------
# 3j. the reference's fig9_imbalance real run at its own width
# ---------------------------------------------------------------------------

# fig9's job (benchmarks/fig9_imbalance.py): oneshot WordCount at the
# JobConfig defaults, S 4096 and cap 1024
IMBALANCE_W = Width(vocab=65536, n_procs=8, task=4096, cap=1024, segment=0)
IMBALANCE_N = 2_000_000
IMBALANCE_SKEWS = (0.0, 0.6, 1.1, 1.6)     # fig9's four
IMBALANCE_MEAN_REP = 4
# fig9's arms (all unfused there) and the main path's fused ones
IMBALANCE_ARMS = ("2s", "1s", "1s+steal", "1s-fused", "1s-fused+steal")
IMBALANCE_WIDE_TASK = 16384     # fig8's largest task


def imbalance_arm(arm: str, w: Width = IMBALANCE_W):
    """A 3j arm's JobConfig: ``2s``, ``1s`` unfused, ``-fused`` the fused
    step (its CUDA graphs on the card), ``+steal`` with work stealing."""
    core, _, _, _, _ = _port()
    return core.JobConfig(core.WordCount(vocab=w.vocab), backend=arm[:2],
                          task_size=w.task, push_cap=w.cap,
                          n_procs=w.n_procs, segment=w.segment,
                          fused_map="-fused" in arm,
                          stealing=arm.endswith("+steal"))


def fused_kernel_ms(prof: dict) -> dict:
    """The fused_map kernel's device ms a launch and launches in a
    ``device_profile`` kept on ``fused_map``."""
    ms = sum(t for _, t, _ in prof["kept"])
    n = sum(c for _, _, c in prof["kept"])
    return {"kernel_device_ms": ms / n if n else None,
            "kernel_launches_traced": n}


def imbalance_job(cfg, corpus, reps, device, oracle, steps: int) -> dict:
    """One 3j arm: a warm-up (on the card the fused arms' traced, for the
    kernel's device time a step), then one timed run through
    ``run_engine``: records equal to the oracle, fused_map launched once a
    step on the fused arms on the card and never elsewhere."""
    cuda = device.type == "cuda"
    traced = {}
    if cuda and cfg.fused_map:
        traced = fused_kernel_ms(device_profile(
            lambda: run_engine(cfg, corpus, reps, device),
            keep=("fused_map",)))
    else:
        run_engine(cfg, corpus, reps, device)
    r = run_engine(cfg, corpus, reps, device)
    res = r.pop("result")
    assert res.records == oracle, (cfg.task_size, cfg.backend)
    want = steps if cuda and cfg.fused_map else 0
    assert r["launches"] == want, (cfg, r["launches"], want)
    r.update(traced, steps=steps, records=res.records,
             work_per_rank=res.work_per_rank.tolist(),
             imbalance=res.imbalance)
    return r


def phase_imbalance(device, corpus: np.ndarray | None = None,
                    w: Width = IMBALANCE_W, skews=IMBALANCE_SKEWS,
                    wide_task: int = IMBALANCE_WIDE_TASK) -> dict:
    """The reference's fig9_imbalance real run at its width: WordCount over
    ``synth_corpus(N, V, seed=0)`` (host memory) at ``w``, under
    ``zipf_skew_repeats(P, T, s, mean_rep=4, seed=1)`` for each skew, each
    of ``IMBALANCE_ARMS`` warmed up and run once (``imbalance_job``).
    Every job's records equal the oracle and the unfused 1S job's; the
    stealing arms' steals, passes and work row equal the host replay's
    (``steal_replay``). Then the fused job at ``wide_task`` (fig8's
    largest task) on the balanced grid, held the same way."""
    core, data, _, _, _ = _port()
    if corpus is None:
        corpus = data.synth_corpus(IMBALANCE_N, w.vocab, seed=0)
    n = len(corpus)
    oracle = core.wordcount_oracle(corpus, w.vocab)
    T = tasks_per_rank(n, w)
    out = {"n": n, "tasks_per_rank": T, "skews": {}}
    t0 = time.perf_counter()
    for s in skews:
        reps = data.zipf_skew_repeats(w.n_procs, T, s,
                                      mean_rep=IMBALANCE_MEAN_REP, seed=1)
        work = reps.sum(axis=1)
        replay = steal_replay(n, reps, w)
        row = out["skews"][str(s)] = {
            "hot_rank_repeats": int(work.max()),
            "mean_rank_repeats": float(work.mean()),
            "lockstep_passes": int(reps.max(axis=0).sum()),
            "replay": replay}
        for arm in IMBALANCE_ARMS:
            cfg = imbalance_arm(arm, w)
            r = imbalance_job(cfg, corpus, reps, device, oracle, T)
            if cfg.stealing:
                assert r["steal"]["passes"] == replay["passes"], (s, arm)
                assert r["n_steals"] == replay["steals"], (s, arm)
                assert r["work_per_rank"] == replay["work"], (s, arm)
            row[arm] = r
        base = row["1s"]["records"]           # the unfused 1S job's
        for arm in IMBALANCE_ARMS:
            assert row[arm].pop("records") == base, (s, arm)
        row["wall_2s_over_1s"] = row["2s"]["wall_s"] / row["1s"]["wall_s"]
        row["wall_2s_over_1s_fused"] = (row["2s"]["wall_s"]
                                        / row["1s-fused"]["wall_s"])
    out["skews_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = dataclasses.replace(w, task=wide_task)
    Tw = tasks_per_rank(n, wide)
    r = imbalance_job(imbalance_arm("1s-fused", wide), corpus,
                      np.ones((w.n_procs, Tw), np.int32), device, oracle, Tw)
    r.pop("records")
    out["wide"] = {"task": wide_task, **r}
    out["wide_s"] = time.perf_counter() - t0
    return out


def print_imbalance(c: dict, w: Width = IMBALANCE_W):
    print(f"imbalance: fig9 real run, WordCount N={c['n']} at P={w.n_procs} "
          f"S={w.task} cap={w.cap} V={w.vocab}, oneshot, "
          f"{c['tasks_per_rank']} steps; every job's records == oracle == "
          f"the unfused 1S job's; fused_map launches one a step on the "
          f"fused arms")
    for s, row in c["skews"].items():
        print(f"imbalance: s={s}: hot rank {row['hot_rank_repeats']} "
              f"repeats, mean {row['mean_rank_repeats']:.1f}, lockstep "
              f"passes {row['lockstep_passes']}; 2s/1s "
              f"{row['wall_2s_over_1s']:.3f}, 2s/1s-fused "
              f"{row['wall_2s_over_1s_fused']:.3f}")
        for arm in IMBALANCE_ARMS:
            e = row[arm]
            steal = (f", steals {e['n_steals']} and passes "
                     f"{e['steal']['passes']} == replay"
                     if "steal" in e else "")
            kern = (f", kernel {e['kernel_device_ms']:.5f} ms a step on the "
                    f"device ({e['kernel_launches_traced']} traced)"
                    if e.get("kernel_device_ms") is not None else "")
            print(f"imbalance: s={s} {arm}: {e['wall_s']:.3f} s, "
                  f"{e['tokens_per_s']:.0f} tokens/s, fused_map launches "
                  f"{e['launches']}{steal}{kern}; work {e['work_per_rank']}")
    e = c["wide"]
    kern = (f", kernel {e['kernel_device_ms']:.5f} ms a step on the device "
            f"({e['kernel_launches_traced']} traced)"
            if e.get("kernel_device_ms") is not None else "")
    print(f"imbalance: fused 1S at S={e['task']} (fig8's largest), balanced "
          f"grid: {e['wall_s']:.3f} s, {e['steps']} steps, fused_map "
          f"launches {e['launches']}{kern}; records == oracle")
    print(f"imbalance: {c['seconds']:.1f} s (skews {c['skews_s']:.1f} s, "
          f"S={e['task']} {c['wide_s']:.1f} s)")


# ---------------------------------------------------------------------------
# 4. serving every arch of the registry at full width
# ---------------------------------------------------------------------------

def _serve():
    _port()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine
    return get_config, tf, engine


def serve_prompts(cfg, requests: int, prompt_len: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size,
                        (requests, prompt_len)).astype(np.int32)


def serve_inputs(cfg, requests: int, context: int) -> tuple:
    """What ``requests`` of ``cfg`` send at a context of ``context``
    positions, split as the reference's ``frontend_geometry`` splits it:
    (prompts, frontend_embeds, the positions the cache holds ahead of
    the first new token). A VLM sends a prefix of ``vlm_prefix_len``
    rows and the rest as text, an audio stack ``context / 2`` frames and
    ``context`` text tokens; the stub frontend's rows are seeded fp32
    (None without a frontend)."""
    _port()
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.specs import frontend_geometry
    text, rows, _ = frontend_geometry(
        cfg, ShapeConfig("serve", context, requests, "prefill"))
    fe = None
    if rows:
        fe = np.random.default_rng(1).standard_normal(
            (requests, rows, cfg.d_model), dtype=np.float32)
    ahead = text + (rows if cfg.frontend == "vision_stub" else 0)
    return serve_prompts(cfg, requests, text), fe, ahead


def serve_batch(prompts, fe, lo: int, hi: int, device) -> dict:
    """Requests ``lo:hi`` as a batch of ``transformer.forward``."""
    batch = {"tokens": torch.from_numpy(prompts[lo:hi]).to(device)}
    if fe is not None:
        batch["frontend_embeds"] = torch.from_numpy(fe[lo:hi]).to(device)
    return batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def layer_kinds(cfg) -> list:
    """``layer_kind`` of every layer of ``cfg``'s stack."""
    _, tf, _ = _serve()
    return [tf.layer_kind(cfg, i) for i in range(cfg.n_layers)]


def serve_kernels(cfg) -> dict:
    """The kernels that serving ``cfg``'s stack runs, by name, each its
    counted wrapper: flash_attention for GQA or MHA layers (MLA's prefill
    takes no kernel), ssd_scan for SSD layers, bucket_slots for MoE
    layers."""
    mixers = {m for m, _ in layer_kinds(cfg)}
    out = {}
    if "attn" in mixers:
        out["flash_attention"] = _fa()[0].flash_attention
    if "ssm" in mixers:
        out["ssd_scan"] = _ssd()[0].ssd
    if cfg.n_experts:
        out["bucket_slots"] = _slots()[0].bucket_slots
    return out


def slot_shapes(cfg, T: int) -> list:
    """The (records, buckets) of each bucket_slots call that one MoE
    layer makes over ``T`` tokens (tp 1), in order: one
    ``_bucket_indices`` (peer buckets, E = 1) and one ``_expert_gemm``
    (expert buffers, E = n_experts) a step; 1s runs G + 1 steps over
    groups of T / G tokens (G = ``dispatch_groups`` capped at T), 2s
    one step over all T."""
    one_s = cfg.dispatch_mode == "1s"
    G = max(1, min(cfg.dispatch_groups, T)) if one_s else 1
    Tkg = T // G * cfg.top_k
    cap = int(cfg.capacity_factor * Tkg) + 1
    return [(Tkg, 1), (cap, cfg.n_experts)] * (G + 1 if one_s else 1)


def serve_launches(cfg, requests: int, batch: int, prompt_len: int,
                   new_tokens: int) -> dict:
    """Launches of each of ``serve_kernels(cfg)`` while
    ``ServeEngine.generate`` serves ``requests`` in batches:
    flash_attention once an attention layer (an encoder's too) and
    prefill, ssd_scan once an SSD layer and prefill; bucket_slots
    ``slot_shapes``' calls an MoE layer, at the prefill and at each of
    the ``new_tokens - 1`` decode steps."""
    batches = [min(batch, requests - lo) for lo in range(0, requests, batch)]
    kinds = layer_kinds(cfg)
    out = {}
    for name, mixer, extra in (("flash_attention", "attn", cfg.n_enc_layers),
                               ("ssd_scan", "ssm", 0)):
        n = sum(m == mixer for m, _ in kinds) + extra
        if n:
            out[name] = n * len(batches)
    if cfg.n_experts:
        moe = sum(f == "moe" for _, f in kinds)
        out["bucket_slots"] = sum(
            moe * (len(slot_shapes(cfg, B * prompt_len))
                   + (new_tokens - 1) * len(slot_shapes(cfg, B)))
            for B in batches)
    return out


# the bucket_slots kernel, as the profiler names it
SLOTS_KERNEL = ("slots_kernel",)


def served_slots(run, grad: bool = False) -> dict:
    """Every bucket_slots call of ``run()``, a program through the kernel
    path (under ``inference_mode`` unless ``grad``), held bit for bit to
    ``bucket_slots_ref`` on the same ids (through ``models.moe.slot_ops``:
    the counted wrapper is called as the program calls it). Returns
    ``run()``'s result (``out``), the calls checked, each call's ids and
    outputs in order (``calls_made``, with ``grad``) and, by (records,
    buckets), the first ids of each shape that hold a valid id (the first
    MoE layer's): the served shapes."""
    import contextlib
    import types

    from repro_torch.models import moe
    ops, ref = _slots()
    real = ops.bucket_slots
    seen = {"calls": 0, "ids": {}, "calls_made": []}

    def checked(ids, n, **kw):
        slots, counts = real(ids, n, **kw)
        want = ref.bucket_slots_ref(ids, n)
        assert torch.equal(slots, want[0]) and torch.equal(counts, want[1]), \
            ("bucket_slots != plain on the served routing", seen["calls"],
             ids.numel(), n)
        seen["calls"] += 1
        if grad:
            seen["calls_made"].append((ids.clone(), slots, counts))
        if (ids.numel(), n) not in seen["ids"] and bool((ids >= 0).any()):
            seen["ids"][(ids.numel(), n)] = ids.clone()
        return slots, counts

    moe.slot_ops = types.SimpleNamespace(bucket_slots=checked)
    try:
        with (contextlib.nullcontext() if grad else torch.inference_mode()):
            seen["out"] = run()
    finally:
        moe.slot_ops = ops
    return seen


def _copy_cache(cache: dict) -> dict:
    return {"blocks": [{k: v.clone() for k, v in c.items()}
                       for c in cache["blocks"]]}


def served_decode(cfg, engine, model, cache, tok, t: int) -> dict:
    """Gate (e) of phase 4: one step of the engine (the kernel path) on a
    copy of ``cache``, its slot calls held bit for bit by
    ``served_slots``, and its logits and caches equal bit for bit to
    ``decode_step(use_kernel=False)``'s on another copy (under the
    engine's mesh, if it has one): the port combines expert rows by
    gathers, so equal slots give equal bits. Returns ``served_slots``'
    calls and ids."""
    _, tf, _ = _serve()
    seen = served_slots(lambda: engine._step(model, _copy_cache(cache),
                                             tok, t))
    lk, ck = seen.pop("out")
    with torch.inference_mode():
        lr, cr = tf.decode_step(cfg, model, _copy_cache(cache), tok, t,
                                mesh=engine.mesh, dp_entry=engine.dp_entry,
                                use_kernel=False)
    assert bool(torch.isfinite(lk).all()), "non-finite decode logits"
    assert torch.equal(lk, lr), \
        ("a decode step's logits, kernel path != plain path",
         (lk.float() - lr.float()).abs().max().item())
    assert all(torch.equal(a[k], b[k]) for a, b in
               zip(ck["blocks"], cr["blocks"]) for k in a), \
        "a decode step's caches, kernel path != plain path"
    return seen


def time_served_slots(ids_by_shape: dict) -> dict:
    """``time_entry``'s numbers of bucket_slots on the served ids: CUDA
    events and device time a call, the plain version, the bound."""
    ops, ref = _slots()
    cases = {f"served_T{T}_E{n}": dict(
        kernel="bucket_slots", exact=True,
        run=functools.partial(ops.bucket_slots, ids, n),
        plain=functools.partial(ref.bucket_slots_ref, ids, n),
        library=None, bound=slots_bound(T, n))
        for (T, n), ids in sorted(ids_by_shape.items())}
    return time_entry(cases)


# the kernels of phase 4's served paths, as the profiler names them (the
# fp32 flash_attention kernel serves whisper's encoder)
FLASH_KERNEL = ("fa_bf16_kernel", "flash_attention_kernel")
SSD_PASSES = ("chunk_state_kernel", "state_pass_kernel", "chunk_out_kernel")
PROFILE_NAMES = {"flash_attention": FLASH_KERNEL, "ssd_scan": SSD_PASSES,
                 "bucket_slots": SLOTS_KERNEL}


def same_routing(*runs) -> tuple:
    """``runs[0]()``, then each of the other ``runs`` with each MoE layer
    routed as the first routed it (routing is discrete: where two
    experts' router probabilities tie within two paths' rounding, they
    would pick apart, and a token's output would move by a whole
    expert's). A later run's gates are its own probabilities of those
    experts, renormalised. Returns the runs' results and, for each later
    run, its MoE calls, the rows it would have routed otherwise and the
    largest probability gap among them."""
    from repro_torch.models import moe
    real, calls = moe._route, []

    def record(cfg, router_w, x_flat):
        out = real(cfg, router_w, x_flat)
        calls.append(out[0])
        return out

    def replay(routed):
        def route(cfg, router_w, x_flat):
            ids, _, probs = real(cfg, router_w, x_flat)
            want = calls[routed["calls"]]
            routed["calls"] += 1
            differ = (ids.sort(-1)[0] != want.sort(-1)[0]).any(-1)
            gap = probs.gather(1, ids.long()).amin(-1)[:, None] \
                - probs.gather(1, want.long())
            routed["rows"] += int(differ.sum())
            routed["max_gap"] = max(routed["max_gap"], float(
                torch.where(differ[:, None], gap, 0.0).max()))
            g = probs.gather(1, want.long())
            return want, g / g.sum(-1, keepdim=True).clamp_min(1e-9), probs
        return route

    outs, reroutes = [], []
    try:
        moe._route = record
        outs.append(runs[0]())
        for run in runs[1:]:
            reroutes.append({"calls": 0, "rows": 0, "max_gap": 0.0})
            moe._route = replay(reroutes[-1])
            outs.append(run())
            assert reroutes[-1]["calls"] == len(calls), (reroutes, len(calls))
    finally:
        moe._route = real
    return outs, reroutes


def streamed_prefill(cfg, model, tokens, use_kernel: bool):
    """``transformer.prefill`` of ``model``'s weights in fp32, upcast one
    layer at a time (a stack whose fp32 copy does not fit beside its
    model-dtype weights): the embedding, head and final norm upcast once,
    each layer upcast, run and dropped; a VLM's prefix
    (``frontend_embeds``) prepended in fp32. Returns the last-position
    logits."""
    from repro_torch.models import layers
    _, tf, _ = _serve()
    assert not cfg.n_enc_layers, "an encoder stack is not streamed"
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    head = {k: model[k].float() for k in ("embed_tokens", "lm_head")
            if k in model}
    x = layers.embed_tokens(cfg32, head, tokens["tokens"])
    if "frontend_embeds" in tokens:
        x = torch.cat([tokens["frontend_embeds"].float(), x], 1)
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    for i, layer in enumerate(model["blocks"]):
        p32 = {sub: {k: t.float() for k, t in leaves.items()}
               for sub, leaves in layer.items()}
        x = tf._layer_forward(cfg32, p32, x, pos, i, causal=True,
                              use_kernel=use_kernel,
                              slot_kernel=use_kernel)[0]
        del p32
    norm = {k: t.float() for k, t in model["final_norm"].items()}
    x = layers.apply_norm(cfg32, norm, x[:, -1:])
    return layers.unembed(cfg32, head, x)


# the streamed fp32 drift check runs on this many prompts of a batch
DRIFT_ROWS = 2


def streamed_drift(cfg, model, tokens) -> dict:
    """``drift_check`` of a stack whose fp32 copy does not fit beside its
    bf16 weights (jamba's, internvl2's) on the first ``DRIFT_ROWS``
    prompts of ``tokens``: the model-dtype kernel and reference paths'
    last-position logits against the same weights in fp32
    (``streamed_prefill``) through both paths, all four with the
    model-dtype kernel path's routing (``same_routing``)."""
    _, tf, _ = _serve()
    few = {k: t[:DRIFT_ROWS] for k, t in tokens.items()}
    runs = [functools.partial(fn, cfg, model, few, use_kernel=k)
            for fn in (tf.prefill, streamed_prefill) for k in (True, False)]
    (lk, lr, lk32, lr32), reroutes = same_routing(*runs)
    out = drift_check(*(t[:, 0].float() for t in (lk, lr, lk32, lr32)))
    return dict(out, rows=DRIFT_ROWS, reroutes=reroutes)


def phase_serve(device, cfg, requests: int = REQUESTS, batch: int = BATCH,
                prompt_len: int = PROMPT_LEN,
                new_tokens: int = NEW_TOKENS) -> dict:
    """Serve ``requests`` prompts through ``ServeEngine.generate`` (the
    main path: counts zeroed just before, read just after), then check
    the served tokens (gates (a)-(e) of the module's docstring) and time
    the engine's prefill and decode step."""
    _, tf, eng = _serve()
    kernels = serve_kernels(cfg)
    cuda = device.type == "cuda"
    moe = bool(cfg.n_experts)
    ssm = cfg.family == "ssm"
    # a bf16 stack with SSD layers drifts between its two paths with depth,
    # and so does internvl2's at 48 layers (1.096x the 3e-2 limit, PERF.md)
    drifts_apart = (cfg.family in ("ssm", "hybrid")
                    or cfg.name == VISION_ARCH) and cfg.dtype != "float32"
    t0 = time.perf_counter()
    model = tf.init_model(cfg, 0, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    # ``prompt_len`` is the context: with a frontend, prefix or frames
    # and text as ``frontend_geometry`` splits it
    prompts, fe, ctx = serve_inputs(cfg, requests, prompt_len)
    engine = eng.ServeEngine(cfg, model, max_len=ctx + new_tokens + 8,
                             device=device)
    engine.generate(prompts[:batch, :128], 2,                    # warm
                    frontend_embeds=None if fe is None else fe[:batch, :128])
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    zero_counts()
    t0 = time.perf_counter()
    outs = [engine.generate(prompts[lo:lo + batch], new_tokens,
                            frontend_embeds=None if fe is None
                            else fe[lo:lo + batch])
            for lo in range(0, requests, batch)]
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    out = np.concatenate(outs)
    assert out.shape == (requests, new_tokens), out.shape
    assert out.min() >= 0 and out.max() < cfg.vocab_size
    want_launches = serve_launches(cfg, requests, batch, prompt_len,
                                   new_tokens)
    if cuda:
        assert launches == want_launches, (launches, want_launches)

    # the kernel path's prefill against the reference path's (chunked
    # attention, ssd_ref, bucket_slots_ref), and the first served token a
    # maximum of the kernel path's logits. An MoE stack's plain path takes
    # the kernel path's routing (``same_routing``). In bf16 a stack with
    # SSD layers drifts apart between its two paths with depth, as the
    # bf16 reference drifts from its own fp32 run (PERF.md, Findings):
    # that gap is reported, and the stack is held instead to the same
    # weights run in fp32 (``ssm_drift`` each batch of an ssm stack,
    # ``streamed_drift`` the first prompts of a hybrid stack or of
    # internvl2). Each attention and SSD layer's mixer is held on the
    # kernel path's own input too (``mixer_layer_errs``).
    if ssm and drifts_apart:
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        model32 = copy.deepcopy(model).float()
    worst, drifts, reroutes = 0.0, [], []
    with torch.inference_mode():
        for i, lo in enumerate(range(0, requests, batch)):
            tokens = serve_batch(prompts, fe, lo, lo + batch, device)
            runs = [functools.partial(tf.prefill, cfg, model, tokens,
                                      use_kernel=k) for k in (True, False)]
            if moe:
                (lk, lr), routed = same_routing(*runs)
                reroutes += routed
            else:
                lk, lr = (run() for run in runs)
            lk, lr = lk[:, 0].float(), lr[:, 0].float()
            assert bool(torch.isfinite(lk).all()), "non-finite logits"
            err = (lk - lr).abs().max().item()
            lim = 3e-2 * lr.abs().max().item()
            assert drifts_apart or err <= lim, (err, lim)
            worst = max(worst, err / lim)
            first = torch.from_numpy(outs[i][:, :1]).to(device).long()
            assert bool((lk.gather(1, first)[:, 0] == lk.amax(1)).all()), \
                "the first served token is not a maximum of its logits"
            if ssm and drifts_apart:
                drifts.append(ssm_drift(cfg32, model32, tokens, lk, lr))
            elif drifts_apart and i == 0:
                drifts.append(streamed_drift(cfg, model, tokens))
        if ssm and drifts_apart:
            del model32

        # the engine's two programs, timed alone on the first batch
        tokens = serve_batch(prompts, fe, 0, batch, device)
        B = tokens["tokens"].shape[0]
        slots = None
        if moe:     # gate (d): every slot call of one prefill
            slots = served_slots(lambda: tf.prefill(cfg, model, tokens,
                                                    use_kernel=True))
            del slots["out"]
            assert set(slots["ids"]) == set(slot_shapes(cfg, B * prompt_len))
        layer_errs = mixer_layer_errs(cfg, model, tokens)
        assert max(layer_errs, default=0.0) <= 1.0, layer_errs
        _sync(device)
        base = torch.cuda.memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        logits, _, raw = engine._prefill(model, tokens)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        memory = dict(
            weights_bytes=sum(t.numel() * t.element_size()
                              for t in model.state_dict().values()),
            before_prefill_bytes=base,
            prefill_peak_bytes=(torch.cuda.max_memory_allocated(device)
                                if cuda else 0),
            logits_bytes=logits.numel() * logits.element_size(),
            **cache_bytes(raw))
        cache = eng.prefill_to_decode_cache(cfg, raw, ctx, engine.max_len)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        _sync(device)
        t0 = time.perf_counter()
        for step in range(new_tokens - 1):
            logits, cache = engine._step(model, cache, tok, ctx + step)
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        _sync(device)
        decode_s = (time.perf_counter() - t0) / (new_tokens - 1)
        if moe:     # gate (e): one decode step, slots and logits
            dec = served_decode(cfg, engine, model, cache, tok,
                                ctx + new_tokens - 1)
            moe_layers = sum(f == "moe" for _, f in layer_kinds(cfg))
            assert dec["calls"] == moe_layers * len(slot_shapes(cfg, B))
            assert set(dec["ids"]) == set(slot_shapes(cfg, B)), dec["ids"]
            slots["decode_calls"] = dec["calls"]
            slots["ids"].update(dec["ids"])
        profiles = {}
        # an MoE decode step runs ~10,000 ops: the profiler's trace of
        # four took ~40 s to read, so it traces one
        steps = 1 if moe else 4
        decode = f"decode_{steps}_steps"
        keep = tuple(n for k in kernels for n in PROFILE_NAMES[k])
        if cuda:
            profiles["prefill"] = device_profile(
                lambda: engine._prefill(model, tokens), keep=keep)
            t = ctx + new_tokens - 1
            profiles[decode] = device_profile(
                lambda: [engine._step(model, cache, tok, t + i)
                         for i in range(steps)], keep=keep)
        if moe:
            slots["times"] = time_served_slots(slots["ids"]) if cuda else {}
            slots["shapes"] = sorted(slots.pop("ids"))
            slots["prefill_share"] = kept_share(profiles.get("prefill"),
                                                SLOTS_KERNEL)
            slots["decode_share"] = kept_share(profiles.get(decode),
                                               SLOTS_KERNEL)
    return dict(arch=cfg.name, n_layers=cfg.n_layers,
                params=cfg.param_count(), kernels=list(kernels),
                requests=requests, batch=batch,
                prompt_len=prompt_len, new_tokens=new_tokens,
                text_len=prompts.shape[1],
                frontend_rows=0 if fe is None else fe.shape[1],
                launches=launches, want_launches=want_launches, wall_s=wall,
                served_tokens_per_s=out.size / wall,
                prompt_tokens_per_s=requests * prompt_len / wall,
                prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s * 1e3,
                peak_bytes=peak, init_s=init_s,
                kernel_vs_ref_err_over_limit=worst,
                layer_err_over_limit=max(layer_errs, default=None),
                drift=drifts, reroutes=reroutes, memory=memory,
                profiles=profiles, slots=slots)


def phase_serves(device, archs) -> dict:
    """Phase 4: ``phase_serve`` for each arch of ``archs`` at its
    ``SERVE_ARCHS`` requests and its ``SERVE_LAYERS`` depth, with its
    seconds, printed as it ends; the card's cache freed between."""
    get_config, _, _ = _serve()
    out = {}
    for arch in archs:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if arch in SERVE_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
        out[arch] = phase_serve(device, cfg, SERVE_ARCHS[arch])
        out[arch]["seconds"] = time.perf_counter() - t0
        print_serve(out[arch])
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def kept_share(prof, names: tuple) -> float | None:
    """The share of a ``device_profile``'s device time that its kept
    activities holding one of ``names`` took (None without a profile)."""
    if not prof:
        return None
    return sum(ms for k, ms, _ in prof["kept"] if any(n in k for n in names)) \
        / 1e3 / prof["device_s"]


def print_serve(serve: dict):
    """Phase 4's lines for one served arch."""
    arch = serve["arch"]
    frontend = (f", {serve['frontend_rows']} fp32 frontend rows"
                if serve["frontend_rows"] else "")
    print(f"serve: {arch} at full width ({serve['n_layers']} layers, "
          f"{serve['params']:,} parameters), {serve['requests']} "
          f"requests in batches of {serve['batch']}, context "
          f"{serve['prompt_len']} ({serve['text_len']} text tokens"
          f"{frontend}), {serve['new_tokens']} new tokens, "
          f"greedy: {serve['wall_s']:.3f} s, "
          f"{serve['served_tokens_per_s']:.1f} served tokens/s (the "
          f"phase {serve['seconds']:.1f} s); prefill "
          f"{serve['prefill_ms']:.1f} ms per batch, decode "
          f"{serve['decode_ms_per_token']:.2f} ms per token; launches "
          f"{serve['launches']} (expected {serve['want_launches']}); peak "
          f"device memory {serve['peak_bytes'] / 2**30:.2f} GiB; "
          f"kernel-vs-reference logits at "
          f"{serve['kernel_vs_ref_err_over_limit']:.3f} of the 3e-2 * "
          f"max|logits| limit")
    for i, r in enumerate(serve["reroutes"]):
        print(f"serve: {arch} batch {i}: the plain path took the kernel "
              f"path's routing of {r['calls']} MoE calls; it would have "
              f"routed {r['rows']} rows otherwise (largest probability gap "
              f"{r['max_gap']:.3g})")
    mem = serve["memory"]
    print(f"serve: {arch} memory: weights "
          f"{mem['weights_bytes'] / 2**30:.3f} GiB; one prefill from "
          f"{mem['before_prefill_bytes'] / 2**30:.3f} GiB allocated to a "
          f"peak of {mem['prefill_peak_bytes'] / 2**30:.3f} GiB, leaving "
          f"logits of {mem['logits_bytes'] / 2**30:.3f} GiB and a cache "
          f"of {mem['cache_bytes'] / 2**30:.3f} GiB that holds "
          f"{mem['cache_storage_bytes'] / 2**30:.3f} GiB of storage")
    if serve["layer_err_over_limit"] is not None:
        print(f"serve: {arch} per-layer mixer (attention, SSD), kernel vs "
              f"plain on the same input: worst layer at "
              f"{serve['layer_err_over_limit']:.3f} of the 3e-2 * "
              f"max|out| limit")
    for i, d in enumerate(serve["drift"]):
        rows = (f"its first {d['rows']} prompts, all four paths with the "
                f"bf16 kernel path's routing ({d['reroutes']}), "
                if "rows" in d else "")
        print(f"serve: {arch} batch {i} against the same weights in "
              f"fp32 ({rows}upcast{' a layer at a time' if rows else ''}): "
              f"fp32 kernel path at "
              f"{d['fp32_err_over_limit']:.4f} of 1e-3 * max|logits|; "
              f"bf16 kernel path {d['kernel_low_vs_fp32']:.4f}, bf16 "
              f"reference path {d['ref_low_vs_fp32']:.4f} of "
              f"max|logits|, ratio "
              f"{d['kernel_low_vs_fp32'] / d['ref_low_vs_fp32']:.3f} "
              f"(limit {SSM_DRIFT_FACTOR})")
    sl = serve["slots"]
    if sl is not None:
        shapes = ", ".join(f"T {t} at E {e}" for t, e in sl["shapes"])
        print(f"serve: {arch} bucket_slots: {sl['calls']} calls of one "
              f"prefill and {sl['decode_calls']} of one decode step == "
              f"bucket_slots_ref bit for bit (the first MoE layer's: "
              f"{shapes}); that decode step's logits and caches == the "
              f"plain path's bit for bit; share of the device time: "
              f"prefill {sl['prefill_share']}, a decode step "
              f"{sl['decode_share']}")
        for shape, t in sl["times"].items():
            print(f"serve: {arch} bucket_slots at {shape}: {t['ms']:.5f} "
                  f"ms by events (device {t['device_ms']:.5f} ms, "
                  f"{t['device_activities_per_call']:.2f} device "
                  f"activities a call), plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.3g} ms ({t['bound_by']}: {t['bytes']} B "
                  f"at 3.35 TB/s, {t['ops']} operations)")
    for what, p in serve["profiles"].items():
        print_profile(f"serve {arch} {what}", p)


def mixer_layer_errs(cfg, model, batch) -> list:
    """Each attention (GQA, MHA) and SSD layer's mixer on the kernel
    path's own input: the mixer through its kernel against the mixer
    through its plain version (chunked attention, ``ssd_ref``), max abs
    error over 3e-2 * max|plain|, layer by layer, an encoder's layers
    (without the causal mask) first; the kernel path's layer, its MLP or
    MoE (and cross-attention) included, makes the next layer's input. An
    MLA layer takes no kernel and is passed. ``batch`` is
    ``transformer.forward``'s: a VLM's prefix is prepended, an audio
    stack's frames go through the encoder."""
    _port()
    from repro_torch.models import attention, layers, ssm
    _, tf, _ = _serve()
    errs = []

    def walk(cfg, blocks, x, causal, enc_out=None):
        B, S = x.shape[:2]
        pos = torch.arange(S, dtype=torch.int32,
                           device=x.device).expand(B, S)
        for i, p in enumerate(blocks):
            mixer, ff = tf.layer_kind(cfg, i)
            h = layers.apply_norm(cfg, p["norm1"], x)
            if mixer == "ssm":
                outs = [ssm.ssm_forward(cfg, p["ssm"], h, use_kernel=k)[0]
                        for k in (True, False)]
            elif mixer == "attn":
                outs = [attention.attention_forward(cfg, p["attn"], h, pos,
                                                    causal=causal,
                                                    use_kernel=k)[0]
                        for k in (True, False)]
            else:
                outs = None
            if outs is not None:
                ok, ref = outs
                assert bool(torch.isfinite(ok).all()), \
                    f"non-finite {mixer} output, layer {i}"
                errs.append((ok - ref).abs().max().item()
                            / (3e-2 * ref.abs().max().item()))
            if ff == "none":
                x = x + ok
            else:
                x = tf._layer_forward(cfg, p, x, pos, i, causal=causal,
                                      enc_out=enc_out, use_kernel=True)[0]
        return x

    x = layers.embed_tokens(cfg, model, batch["tokens"])
    fe, enc_out = batch.get("frontend_embeds"), None
    if cfg.frontend == "vision_stub" and fe is not None:
        x = torch.cat([fe.to(x.dtype), x], 1)
    elif cfg.n_enc_layers and fe is not None:
        enc_out = layers.apply_norm(cfg, model["enc_norm"], walk(
            tf._enc_cfg(cfg), model["enc_blocks"], fe, causal=False))
    walk(cfg, model["blocks"], x, causal=True, enc_out=enc_out)
    return errs


# the bf16 kernel path may sit this many times further from the fp32
# reference than the bf16 reference path does: 1.24 was read at B 2, S 512
# on an H100 and 0.80 at B 1, S 512 on the CPU (PERF.md, Findings)
SSM_DRIFT_FACTOR = 1.5


def ssm_drift(cfg32, model32, tokens, lk, lr) -> dict:
    """``drift_check`` of one batch: its last-position logits ``lk`` and
    ``lr`` of the model-dtype kernel and reference paths against the
    stack in fp32 (``model32``, the served weights upcast) through both
    prefill paths."""
    _, tf, _ = _serve()
    lk32 = tf.prefill(cfg32, model32, tokens, use_kernel=True)[:, 0]
    lr32 = tf.prefill(cfg32, model32, tokens, use_kernel=False)[:, 0]
    return drift_check(lk, lr, lk32, lr32)


def drift_check(lk, lr, lk32, lr32) -> dict:
    """Holds the fp32 kernel path's logits ``lk32`` within 1e-3 *
    max|logits| of the fp32 reference path's ``lr32``, and the
    model-dtype kernel path's ``lk`` within ``SSM_DRIFT_FACTOR`` times
    the model-dtype reference path's ``lr`` distance from ``lr32``.
    Distances are fractions of max|logits|."""
    assert bool(torch.isfinite(lk32).all()), "non-finite fp32 logits"
    top = lr32.abs().max().item()
    err32 = (lk32 - lr32).abs().max().item()
    assert err32 <= 1e-3 * top, (err32, top)
    kernel = (lk - lr32).abs().max().item() / top
    ref = (lr - lr32).abs().max().item() / top
    assert kernel <= SSM_DRIFT_FACTOR * ref, (kernel, ref)
    return dict(fp32_err_over_limit=err32 / (1e-3 * top),
                kernel_low_vs_fp32=kernel, ref_low_vs_fp32=ref)


def cache_bytes(raw) -> dict:
    """Bytes of a prefill cache's tensors, and bytes of the storages they
    keep alive (more when a leaf is a view into a larger tensor)."""
    leaves = [t for c in raw["blocks"] for t in c.values()]
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in leaves}
    return dict(cache_bytes=sum(t.numel() * t.element_size()
                                for t in leaves),
                cache_storage_bytes=sum(held.values()))


# ---------------------------------------------------------------------------
# 5. training olmo-1b and deepseek-v2-lite at full width
# ---------------------------------------------------------------------------

# the runs: bf16 parameters and fp32 AdamW moments (``train_config_for``),
# batches of 8 x 512 tokens in two microbatches of 4, full remat. olmo-1b
# as published: 20 steps of the LM token stream, a snapshot after step 3
# and steps 3-5 again from it. deepseek-v2-lite at its full width cut to
# 4 layers (the leading dense layer and 3 MoE layers of 64 experts top-6,
# 1s dispatch): all 27 layers hold 15.65 B parameters, whose fp32 moments
# alone take ~125 GB; 4 layers hold 2.196 B, ~35 GB with the moments, the
# fp32 accumulator and a microbatch's gradients. 10 steps, no snapshot.
TRAIN_ARCH = "olmo-1b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCH = 512, 8, 4
TRAIN_STEPS, TRAIN_RESUME_AT, TRAIN_TOKENS = 20, 3, 2_000_000
TRAIN_LR = 3e-3
TRAIN_LAYERS = {MOE_ARCH: 4}
TRAIN_ARCHS = {TRAIN_ARCH: dict(steps=TRAIN_STEPS, resume_at=TRAIN_RESUME_AT),
               MOE_ARCH: dict(steps=10, resume_at=0)}
# step A = 2 against A = 1 on one batch (bf16 on the card), and the
# resumed losses against the uninterrupted run's
TRAIN_ACCUM_RTOL = {"loss": 1e-2, "grad_norm": 2e-2}
TRAIN_RESUME_RTOL = 1e-3
# a full-remat step's gradients against a remat "none" step's on the
# same state and batch, max |difference| over max |gradient| of each leaf
TRAIN_REMAT_RTOL = 1e-2


def _train():
    _port()
    import repro_torch.config as config
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import corpus, pipeline
    from repro_torch.launch import specs
    from repro_torch.models import transformer as tf
    from repro_torch.train import train_step as ts
    return config, CheckpointManager, corpus, pipeline, specs, tf, ts


def train_flops(cfg, seq: int, batch: int) -> int:
    """Model FLOPs of a step: 6 N a token over the active parameters N
    (an MoE token passes top_k routed experts and the shared ones), plus
    the causal attention's 12 L S d a token halved (remat's recomputation
    is not counted)."""
    tokens = seq * batch
    return (6 * cfg.active_param_count() * tokens
            + 12 * cfg.n_layers * seq * cfg.d_model * tokens // 2)


def train_launches(cfg, run, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps: bucket_slots
    ``slot_shapes``' calls an MoE layer and microbatch, twice where remat
    recomputes the layer in the backward pass; no other kernel (the
    reference's train step reaches no Pallas kernel)."""
    moe = sum(f == "moe" for _, f in layer_kinds(cfg))
    if not moe:
        return {}
    mb = run.resolved_microbatch() * run.shape.seq_len
    again = 2 if run.train.remat_policy in ("full", "dots") else 1
    return {"bucket_slots": moe * len(slot_shapes(cfg, mb)) * again
            * run.grad_accum_steps * steps}


def train_state(cfg, device, seq: int, batch: int, microbatch: int,
                steps: int, remat: str | None = None, mesh=None):
    """(run, step function, a fresh state): ``make_run`` at (seq,
    batch) with ``TrainConfig(lr=3e-3, warmup_steps=1,
    total_steps=steps)`` (and ``remat``, where given, for full) and the
    model of seed 0; with ``mesh``, as ``launch/train`` assembles a mesh
    run: the run on its ``MeshConfig`` and the step under the mesh with
    ``dp_entry_for``'s entry."""
    config, _, _, _, specs, tf, ts = _train()
    mesh_cfg = config.MeshConfig(tuple(mesh.shape) if mesh else (1, 1))
    shape = config.ShapeConfig("smoke", seq, batch, "train")
    run = specs.make_run(cfg, shape, mesh_cfg, microbatch=microbatch)
    tcfg = config.TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    if remat is not None:
        tcfg = config.replace(tcfg, remat_policy=remat)
    run = config.replace(run, train=tcfg)
    state = ts.init_train_state(cfg, run.train,
                                tf.init_model(cfg, 0, device=device))
    dp = specs.dp_entry_for(shape, mesh_cfg) if mesh else None
    return run, ts.make_train_step(cfg, run, mesh=mesh, dp_entry=dp), state


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_slots(cfg, device, seq: int, batch: int, fixed: dict) -> dict:
    """One step's slots on the card: the gradients of one batch of
    ``batch`` rows (one microbatch of the main run) at A = 1 from a fresh
    state, under full remat and under remat "none", every
    bucket_slots call of each held bit for bit to ``bucket_slots_ref``
    (``served_slots``); full remat's calls are the forward's, then each
    MoE layer's again, last layer first, on the same ids with the same
    slots, and the forward's are "none"'s. Full remat's gradients
    against "none"'s: max |difference| over max |gradient| of each
    leaf, at most ``TRAIN_REMAT_RTOL``."""
    runs = {}
    for remat in ("full", "none"):
        _, fn, st = train_state(cfg, device, seq, batch, batch, 1,
                                remat=remat)
        seen = served_slots(lambda: fn.grads(st, fixed)[0], grad=True)
        runs[remat] = (seen, [g.float() for g in seen.pop("out")])
        del fn, st
    (full, gf), (none, gn) = runs["full"], runs["none"]
    per_layer = len(slot_shapes(cfg, batch * seq))
    fwd, again = full["calls_made"][:none["calls"]], \
        full["calls_made"][none["calls"]:]
    assert full["calls"] == 2 * none["calls"] > 0, (full["calls"],
                                                    none["calls"])
    blocks = [fwd[i:i + per_layer] for i in range(0, len(fwd), per_layer)]
    for got, want in zip(again, [c for b in blocks[::-1] for c in b]):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            "a recomputed slot call differs from the forward's"
    for got, want in zip(fwd, none["calls_made"]):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            "full remat's forward slots differ from remat none's"
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(gf, gn))
    assert rel <= TRAIN_REMAT_RTOL, rel
    return dict(calls_full=full["calls"], calls_none=none["calls"],
                shapes=sorted(full["ids"]), remat_grad_rel=rel,
                remat_grads_bitwise=all(torch.equal(a, b)
                                        for a, b in zip(gf, gn)))


def phase_train(device, cfg, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
                microbatch: int = TRAIN_MICROBATCH, steps: int = TRAIN_STEPS,
                resume_at: int = TRAIN_RESUME_AT,
                n_tokens: int = TRAIN_TOKENS) -> dict:
    """Train ``cfg`` for ``steps`` steps through ``make_train_step`` on
    ``lm_batches`` behind the ``DoubleBufferedLoader`` (the main path:
    counts zeroed just before, read just after; its MoE layers, if any,
    slot through bucket_slots, and it reaches no other kernel, as the
    reference's train step reaches no Pallas kernel), each step's two
    halves timed by CUDA events and, with ``resume_at``, ``save_async``
    after step ``resume_at``; then the checks (a)-(e) (module
    docstring), (c) only with ``resume_at``, (e) only with MoE layers."""
    import tempfile
    _, Manager, corpus, pipeline, _, _, ts = _train()
    cuda = device.type == "cuda"
    stream = corpus.lm_token_stream(n_tokens, cfg.vocab_size, seed=0)
    t_phase = time.perf_counter()
    run, step_fn, state = train_state(cfg, device, seq, batch, microbatch,
                                      steps)
    loader = pipeline.DoubleBufferedLoader(
        pipeline.lm_batches(stream, batch, seq), device)
    if resume_at:
        tmp = tempfile.TemporaryDirectory(prefix="train-ckpt-")
        mgr = Manager(tmp.name, keep=1)

    def timed_step(b):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if cuda else []
        t0 = time.perf_counter()
        if cuda:
            marks[0].record()
        out = step_fn.grads(state, b)
        if cuda:
            marks[1].record()
        new, metrics = step_fn.update(state, *out)
        if cuda:
            marks[2].record()
        return new, metrics, marks, time.perf_counter() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    losses, marks, host_s, snap_peak = [], [], [], 0
    t0 = time.perf_counter()
    for i in range(steps):
        state, m, mk, hs = timed_step(next(loader))
        losses.append(m["loss"])
        marks.append(mk)
        host_s.append(hs)
        if resume_at and i == resume_at - 1:
            mgr.save_async(i, ts.state_tree(cfg, state),
                           extra={"next_step": resume_at})
            if cuda:        # the snapshot's stacked copy, apart from steps
                snap_peak = torch.cuda.max_memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers().items()}
    want_launches = train_launches(cfg, run, steps)
    if cuda:
        assert {k: v for k, v in launches.items() if v} == want_launches, \
            (launches, want_launches)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    losses = [float(x) for x in losses]
    metrics = {k: float(v) for k, v in m.items()}
    if cuda:
        grads_ms = [a.elapsed_time(b) for a, b, _ in marks]
        update_ms = [b.elapsed_time(c) for _, b, c in marks]
    else:
        grads_ms = update_ms = []
    t0 = time.perf_counter()
    if resume_at:
        mgr.wait()
    save_wait_s = time.perf_counter() - t0

    # (a) finite and falling; (d) every parameter finite
    assert all(math.isfinite(x) for x in losses), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert all(bool(torch.isfinite(p).all())
               for p in state.params.parameters()), "a parameter is not finite"
    profile = (device_profile(lambda: [step_fn(state, next(loader))
                                       for _ in range(2)],
                              keep=SLOTS_KERNEL)
               if cuda else None)
    del state, loader, m

    resume = {}
    if resume_at:
        # (c) a fresh state from the snapshot, the batches from resume_at
        t0 = time.perf_counter()
        _, step_fn, state = train_state(cfg, device, seq, batch, microbatch,
                                        steps)
        at, extra = ts.restore_state(mgr, cfg, state)
        restore_s = time.perf_counter() - t0
        assert (at, extra["next_step"]) == (resume_at - 1, resume_at), \
            (at, extra)
        loader = pipeline.DoubleBufferedLoader(
            pipeline.lm_batches(stream, batch, seq, skip=resume_at), device)
        resumed = [float(step_fn(state, next(loader))[1]["loss"])
                   for _ in range(resume_at, 2 * resume_at)]
        want = losses[resume_at:2 * resume_at]
        resume_diff = max(_rel(a, b) for a, b in zip(resumed, want))
        assert resume_diff <= TRAIN_RESUME_RTOL, (resumed, want)
        del state, loader
        tmp.cleanup()
        resume = dict(snapshot_peak_bytes=snap_peak, save_wait_s=save_wait_s,
                      restore_s=restore_s, resumed=resumed,
                      resumed_want=want, resume_max_rel_diff=resume_diff,
                      resume_bitwise=resumed == want)
    del step_fn

    # (b) one step at A = 2 and one at A = 1 from fresh states, one batch
    fixed = {k: torch.from_numpy(v).to(device) for k, v in
             next(pipeline.lm_batches(stream, batch, seq, seed=1)).items()}
    accum = {}
    for mb in (microbatch, batch):
        r, fn, st = train_state(cfg, device, seq, batch, mb, steps)
        m = fn(st, fixed)[1]
        accum[r.grad_accum_steps] = {k: float(m[k]) for k in
                                     TRAIN_ACCUM_RTOL}
        del st, fn
    (a_many, many), (a_one, one) = sorted(accum.items(), reverse=True)
    for k, tol in TRAIN_ACCUM_RTOL.items():
        assert _rel(many[k], one[k]) <= tol, (k, accum)
    # (e) one step's slots, and the gradients they give, against remat none
    slots = (train_slots(cfg, device, seq, microbatch,
                         {k: v[:microbatch] for k, v in fixed.items()})
             if want_launches else None)
    if cuda:
        torch.cuda.empty_cache()

    step_ms = ([g + u for g, u in zip(grads_ms, update_ms)] if cuda
               else [s * 1e3 for s in host_s])
    med = float(np.median(step_ms))
    tokens = seq * batch
    flops = train_flops(cfg, seq, batch)
    return dict(
        arch=cfg.name, n_layers=cfg.n_layers, seq=seq, batch=batch,
        microbatch=microbatch, grad_accum=run.grad_accum_steps,
        remat=run.train.remat_policy, dispatch=cfg.dispatch_mode,
        steps=steps, params=cfg.param_count(),
        active_params=cfg.active_param_count(), losses=losses,
        last_metrics=metrics, launches=launches,
        want_launches=want_launches,
        launches_per_step={k: v / steps for k, v in want_launches.items()},
        slots=slots, wall_s=wall,
        host_s=host_s, grads_ms=grads_ms, update_ms=update_ms,
        median_step_ms=med,
        median_grads_ms=float(np.median(grads_ms)) if cuda else None,
        median_update_ms=float(np.median(update_ms)) if cuda else None,
        tokens_per_s=tokens / (med / 1e3),
        wall_tokens_per_s=steps * tokens / wall,
        model_flops=flops,
        mfu=flops / (med / 1e3) / BF16_FLOPS_PER_S if cuda else None,
        peak_bytes=peak, accum={str(k): v for k, v in accum.items()},
        accum_rel={k: _rel(many[k], one[k]) for k in TRAIN_ACCUM_RTOL},
        profile=profile, seconds=time.perf_counter() - t_phase, **resume)


def phase_trains(device, archs) -> dict:
    """Phase 5: ``phase_train`` for each arch of ``archs`` at its
    ``TRAIN_LAYERS`` depth with its ``TRAIN_ARCHS`` steps, printed as it
    ends; the card's cache freed between."""
    get_config, _, _ = _serve()
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        if arch in TRAIN_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[arch])
        out[arch] = phase_train(device, cfg, **TRAIN_ARCHS[arch])
        print_train(out[arch])
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def print_train(t: dict):
    print(f"train: {t['arch']} at full width ({t['n_layers']} layers, "
          f"{t['params']:,} parameters, {t['active_params']:,} active), "
          f"{t['steps']} steps of {t['batch']} x {t['seq']} tokens, "
          f"A = {t['grad_accum']} (microbatch {t['microbatch']}), remat "
          f"{t['remat']}: loss {t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}; "
          f"kernel launches {({k: v for k, v in t['launches'].items() if v})}"
          f" (expected {t['want_launches']}, a step "
          f"{t['launches_per_step']})")
    print(f"train: median step {t['median_step_ms']:.2f} ms"
          + (f" (fwd+bwd {t['median_grads_ms']:.2f} ms, optimizer "
             f"{t['median_update_ms']:.2f} ms; CUDA events)"
             if t["median_grads_ms"] is not None else " (host clock)")
          + f", {t['tokens_per_s']:,.0f} tokens/s, model-FLOPs share "
          f"{t['mfu']} at 989 TFLOP/s ({t['model_flops'] / 1e12:.2f} TFLOP "
          f"a step over the active parameters); wall {t['wall_s']:.2f} s for "
          f"the run ({t['wall_tokens_per_s']:,.0f} tokens/s)")
    print(f"train: peak device memory {t['peak_bytes'] / 2**30:.2f} GiB over "
          f"the steps")
    if "resumed" in t:
        print(f"train: {t['snapshot_peak_bytes'] / 2**30:.2f} GiB up to the "
              f"snapshot's staging; the snapshot's write waited "
              f"{t['save_wait_s']:.2f} s after the run, a restore took "
              f"{t['restore_s']:.2f} s; resumed at step {TRAIN_RESUME_AT}: "
              f"losses {t['resumed']} against {t['resumed_want']}, max rel "
              f"diff {t['resume_max_rel_diff']} (bitwise equal: "
              f"{t['resume_bitwise']})")
    print(f"train: one batch from a fresh state, A = 2 / A = 1: {t['accum']}, "
          f"rel diff {t['accum_rel']}")
    if t["slots"] is not None:
        s = t["slots"]
        shapes = ", ".join(f"T {n} at E {e}" for n, e in s["shapes"])
        print(f"train: one microbatch's slots: {s['calls_full']} "
              f"bucket_slots calls under full remat (the backward's "
              f"recompute equal to the forward's), {s['calls_none']} under "
              f"remat none, each == bucket_slots_ref bit for bit "
              f"({shapes}); gradients against remat none's: max rel "
              f"{s['remat_grad_rel']} (bitwise equal: "
              f"{s['remat_grads_bitwise']})")
    if t["profile"] is not None:
        print_profile("train, two steps", t["profile"])
    print(f"train: {t['arch']} {t['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# 4s. every SMOKE config served on the card
# ---------------------------------------------------------------------------

# a batch of 4 prompts of 64 tokens (whisper: 64 fp32 frames; internvl2 a
# prefix of 16 fp32 rows, as the launcher's), 8 new tokens, greedy
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW = 4, 64, 8
SMOKE_PREFIX = 16
# the stacks whose logits gate holds in fp32 (the weights upcast), as
# phase 4 holds them: their bf16 kernel and plain paths drift apart
SMOKE_FP32 = (HYBRID_ARCH, VISION_ARCH)
SMOKE_LOGITS_TOL = 3e-2          # x max|logits|, against the plain path


def smoke_inputs(cfg, batch: int, prompt_len: int) -> tuple:
    """Seeded prompts of ``cfg``'s SMOKE run and its frontend rows (None
    without a frontend): a VLM's ``SMOKE_PREFIX`` rows, an audio stack's
    ``prompt_len`` frames, fp32."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    rows = (SMOKE_PREFIX if cfg.frontend == "vision_stub"
            else prompt_len if cfg.n_enc_layers else 0)
    fe = (rng.standard_normal((batch, rows, cfg.d_model), np.float32)
          if rows else None)
    return prompts, fe


def smoke_logits_err(cfg, model, tokens) -> float:
    """The kernel path's last-position logits against the plain path's
    (``use_kernel=False``) on the same card, max abs error over
    ``SMOKE_LOGITS_TOL`` * max|plain|; an MoE stack's plain path takes
    the kernel path's routing (``same_routing``)."""
    _, tf, _ = _serve()
    runs = [functools.partial(tf.prefill, cfg, model, tokens, use_kernel=k)
            for k in (True, False)]
    with torch.inference_mode():
        if cfg.n_experts:
            (lk, lr), _ = same_routing(*runs)
        else:
            lk, lr = (run() for run in runs)
    lk, lr = lk[:, 0].float(), lr[:, 0].float()
    assert bool(torch.isfinite(lk).all()), f"{cfg.name}: non-finite logits"
    return (lk - lr).abs().max().item() / (
        SMOKE_LOGITS_TOL * lr.abs().max().item())


def phase_smoke_serve(device, cfg, fp32_gate: bool = False) -> dict:
    """Serve ``cfg`` (a SMOKE config, unmodified) through
    ``ServeEngine.generate`` on ``device``: its kernels' launches (counts
    zeroed just before, read just after) equal to the code's count
    (``serve_launches``: flash_attention once an attention layer and
    prefill, ssd_scan once an SSD layer and prefill, bucket_slots as
    phase 4 counts it); the last logits within ``SMOKE_LOGITS_TOL`` *
    max|logits| of the plain path's (with ``fp32_gate`` on the weights
    upcast to fp32, the bf16 gap reported); the prefill's ms and the
    decode's ms a token."""
    _, tf, eng = _serve()
    batch, prompt_len, new_tokens = SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW
    kernels = serve_kernels(cfg)
    model = tf.init_model(cfg, 0, device=device)
    prompts, fe = smoke_inputs(cfg, batch, prompt_len)
    ctx = prompt_len + (fe.shape[1] if cfg.frontend == "vision_stub" else 0)
    engine = eng.ServeEngine(cfg, model, max_len=ctx + new_tokens + 8,
                             device=device)
    engine.generate(prompts, 2, frontend_embeds=fe)                  # warm
    zero_counts()
    out = engine.generate(prompts, new_tokens, frontend_embeds=fe)
    _sync(device)
    launches = {name: fn.launches for name, fn in kernels.items()}
    want = serve_launches(cfg, batch, batch, prompt_len, new_tokens)
    if device.type == "cuda":     # the CPU takes the plain versions
        assert launches == want, (cfg.name, launches, want)
    assert out.shape == (batch, new_tokens), out.shape
    assert out.min() >= 0 and out.max() < cfg.vocab_size

    tokens = serve_batch(prompts, fe, 0, batch, device)
    err, err_fp32 = smoke_logits_err(cfg, model, tokens), None
    if fp32_gate:
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        err_fp32 = smoke_logits_err(cfg32, copy.deepcopy(model).float(),
                                    tokens)
    assert (err if err_fp32 is None else err_fp32) <= 1.0, \
        (cfg.name, err, err_fp32)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, _, raw = engine._prefill(model, tokens)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        cache = eng.prefill_to_decode_cache(cfg, raw, ctx, engine.max_len)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        _sync(device)
        t0 = time.perf_counter()
        for step in range(new_tokens - 1):
            logits, cache = engine._step(model, cache, tok, ctx + step)
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        _sync(device)
        decode_s = (time.perf_counter() - t0) / (new_tokens - 1)
    return dict(arch=cfg.name, n_layers=cfg.n_layers, batch=batch,
                prompt_len=prompt_len, new_tokens=new_tokens,
                frontend_rows=0 if fe is None else fe.shape[1],
                launches=launches, want_launches=want,
                logits_err_over_limit=err,
                fp32_logits_err_over_limit=err_fp32,
                prefill_ms=prefill_s * 1e3,
                decode_ms_per_token=decode_s * 1e3)


def phase_smoke_serves(device, archs=None) -> dict:
    """Phase 4s: ``phase_smoke_serve`` for each arch of ``archs`` (every
    arch of the registry by default) at its SMOKE config, unmodified,
    printed as it ends."""
    _port()
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    t0 = time.perf_counter()
    out = {}
    for arch in archs or ARCH_IDS:
        out[arch] = phase_smoke_serve(device, get_smoke_config(arch),
                                      fp32_gate=arch in SMOKE_FP32)
        print_smoke_serve(arch, out[arch])
    out["seconds"] = time.perf_counter() - t0
    return out


def print_smoke_serve(arch: str, r: dict):
    fp32 = ("" if r["fp32_logits_err_over_limit"] is None else
            f" (bf16 {r['logits_err_over_limit']:.3f}, gated in fp32 at "
            f"{r['fp32_logits_err_over_limit']:.3f})")
    err = (r["logits_err_over_limit"] if not fp32
           else r["fp32_logits_err_over_limit"])
    frontend = (f", {r['frontend_rows']} fp32 frontend rows"
                if r["frontend_rows"] else "")
    print(f"smoke-serve: {arch} ({r['arch']}, {r['n_layers']} layers) batch "
          f"{r['batch']} x {r['prompt_len']} tokens{frontend}, "
          f"{r['new_tokens']} new: launches {r['launches']} (expected "
          f"{r['want_launches']}); prefill {r['prefill_ms']:.2f} ms, decode "
          f"{r['decode_ms_per_token']:.2f} ms a token; logits at {err:.3f} "
          f"of {SMOKE_LOGITS_TOL} * max|logits| of the plain path{fp32}")


# ---------------------------------------------------------------------------
# 4m / 5m. serve and train under a (data, model) mesh
# ---------------------------------------------------------------------------

# The reference's mesh of 2 x 4 host devices as the port's virtual mesh
# on the one card (``distributed/mesh.py``): the MoE layers dispatch in
# one shard_map region (each shard's tokens and experts over "model",
# the batch over "data"), the GQA and MLA decode caches are
# sequence-sharded over "model". deepseek-v2-lite at 4 of its 27 layers
# (the dense layer and 3 MoE layers of 64 experts top-6: the MLA cache)
# and llama4-maverick at phase 4's 2 layers (GQA 40/8, 128 experts top-1
# and a shared expert): one batch of 8 prompts of 2048 tokens, 16 new, a
# cache of the context + 40 positions (2088, divisible by 4).
MESH_SHAPE = (2, 4)
MESH_DP = "data"
MESH_ARCHS = {MOE_ARCH: 4, LLAMA4_ARCH: 2}          # arch -> layers served
MESH_REQUESTS, MESH_NEW_TOKENS, MESH_CACHE_EXTRA = 8, 16, 40
MESH_LOGITS_TOL = 3e-2       # x max|logits|, against the unsharded run
MESH_MAX_FACTOR = 64.0       # the capacity factor search's end
# 5m: launch/train's path, deepseek-v2-lite at 4 layers, 3 steps of
# 8 x 512 tokens, A = 2; step 0 at the raised capacity within 1e-2
# relative of the unsharded step 0
MESH_TRAIN_STEPS, MESH_TRAIN_RTOL = 3, 1e-2


def _mesh(device):
    _port()
    from repro_torch.distributed.mesh import local_mesh
    return local_mesh(MESH_SHAPE, ("data", "model"), device)


def mesh_slot_shapes(cfg, B: int, S: int, shape=MESH_SHAPE) -> list:
    """The (records, buckets) of each bucket_slots call that one MoE layer
    makes under a (data, model) mesh of ``shape`` with the batch over
    "data", over B x S tokens. Each rank holds B / d rows; with S
    dividing by m each holds S / m positions and runs the pipeline
    (``slot_shapes``' steps), its peer buckets (m) and its expert
    buffers (E / m experts, m x cap records); otherwise (decode) the
    tokens replicate over "model" and each rank slots its B / d x S x k
    records into its expert buffers once. A call slots as many ranks'
    records as fit MAX_EXPERTS buckets (``moe.shard_slot_calls``)."""
    d, m = shape
    ranks, k, E_loc = d * m, cfg.top_k, cfg.n_experts // m
    most = _slots()[0].MAX_EXPERTS

    def calls(records: int, buckets: int) -> list:
        per = max(1, most // buckets)
        return [(n * records, n * buckets) for n in
                (min(per, ranks - lo) for lo in range(0, ranks, per))]
    rows = B // d
    if S % m:
        return calls(rows * S * k, E_loc)
    T = rows * S // m
    one_s = cfg.dispatch_mode == "1s"
    G = max(1, min(cfg.dispatch_groups, T)) if one_s else 1
    Tkg = T // G * k
    cap = int(cfg.capacity_factor * Tkg / m) + 1
    return (calls(Tkg, m) + calls(m * cap, E_loc)) * (G + 1 if one_s else 1)


def mesh_serve_launches(cfg, B: int, prompt_len: int, new_tokens: int
                        ) -> dict:
    """``serve_launches`` of one batch of B prompts served under the mesh:
    flash_attention once a GQA layer at the prefill, bucket_slots
    ``mesh_slot_shapes``' calls an MoE layer at the prefill and at each
    decode step."""
    kinds = layer_kinds(cfg)
    out = {}
    n = sum(mixer == "attn" for mixer, _ in kinds)
    if n:
        out["flash_attention"] = n
    moe = sum(f == "moe" for _, f in kinds)
    out["bucket_slots"] = moe * (
        len(mesh_slot_shapes(cfg, B, prompt_len))
        + (new_tokens - 1) * len(mesh_slot_shapes(cfg, B, 1)))
    return out


def count_drops(run) -> tuple:
    """``run()`` with the records each MoE slotting call leaves out at
    capacity counted: (its result, the records dropped)."""
    from repro_torch.models import moe
    real, dropped = moe._bucket_indices, [0]

    def counting(ids, valid, n, cap, **kw):
        idx = real(ids, valid, n, cap, **kw)
        dropped[0] += int(valid.sum()) - int((idx >= 0).sum())
        return idx

    moe._bucket_indices = counting
    try:
        out = run()
    finally:
        moe._bucket_indices = real
    return out, dropped[0]


def no_drop_factor(cfg, runs) -> tuple:
    """The capacity factor, ``cfg``'s own doubled until each of ``runs``
    (functions of a config) drops no record, and the drops of each
    factor tried: [(factor, [drops of each run])]."""
    f, tried = cfg.capacity_factor, []
    while True:
        c = dataclasses.replace(cfg, capacity_factor=f)
        drops = [count_drops(lambda: run(c))[1] for run in runs]
        tried.append((f, drops))
        if not any(drops):
            return f, tried
        f *= 2
        assert f <= MESH_MAX_FACTOR, tried


def global_routing(ids, mesh, B: int, S: int):
    """The mesh's routing of one MoE call (each rank's tokens, rank after
    rank: ``_route`` of the region's rows) in the unsharded call's token
    order: blocks of (B / d) x (S / m) tokens (sequence-sharded), or B / d
    rows on every model rank (replicated; rank 0's kept)."""
    from repro_torch.distributed import collectives
    k = ids.shape[-1]
    d, m = mesh.shape
    if ids.shape[0] == B * S:
        blocks = ids.view(d, m, B // d, S // m, k)
        spec = (MESH_DP, "model")
    else:
        blocks = ids.view(d, m, B // d, S, k)
        spec = (MESH_DP, None)
    return collectives.unblock(blocks, spec, mesh).reshape(B * S, k)


def mesh_against_unsharded(cfg, model, tokens, mesh, max_len: int) -> dict:
    """Gate (b) of phase 4m at ``cfg``'s capacity: the last prefill
    logits and one decode step's logits under the mesh, and the same
    unsharded, on the mesh's routing (``global_routing``; a row the
    unsharded run would route otherwise must be a tie) and the mesh
    run's first token: max |difference| over max |unsharded logits|."""
    _, tf, eng = _serve()
    from repro_torch.models import moe
    B, S = tokens["tokens"].shape
    real, calls = moe._route, []

    def run(m, tok=None):
        with torch.inference_mode():
            logits, _, raw = tf.forward(cfg, model, tokens, mesh=m,
                                        dp_entry=MESH_DP if m else None,
                                        use_kernel=True, want_cache=True)
            last = logits[:, -1].float()
            del logits
            cache = eng.prefill_to_decode_cache(cfg, raw, S, max_len)
            del raw
            if tok is None:
                tok = last.argmax(-1, keepdim=True).to(torch.int32)
            step, _ = tf.decode_step(cfg, model, cache, tok, S, mesh=m,
                                     dp_entry=MESH_DP if m else None,
                                     use_kernel=True)
        return last, step[:, -1].float(), tok

    def record(c, router_w, x_flat):
        out = real(c, router_w, x_flat)
        calls.append(out[0])
        return out

    routed = {"rows": 0, "max_gap": 0.0}
    it = iter(calls)

    def replay(c, router_w, x_flat):
        ids, _, probs = real(c, router_w, x_flat)
        n = x_flat.shape[0]
        want = global_routing(next(it), mesh, B, n // B)
        differ = (ids.sort(-1)[0] != want.sort(-1)[0]).any(-1)
        gap = probs.gather(1, ids.long()).amin(-1)[:, None] \
            - probs.gather(1, want.long())
        routed["rows"] += int(differ.sum())
        routed["max_gap"] = max(routed["max_gap"], float(
            torch.where(differ[:, None], gap, 0.0).max()))
        g = probs.gather(1, want.long())
        return want, g / g.sum(-1, keepdim=True).clamp_min(1e-9), probs

    try:
        moe._route = record
        mesh_last, mesh_step, tok = run(mesh)
        moe._route = replay
        last, step, _ = run(None, tok)
    finally:
        moe._route = real
    assert next(it, None) is None, "the unsharded run routed fewer calls"
    out = {}
    for name, a, b in (("prefill", mesh_last, last),
                       ("decode", mesh_step, step)):
        assert bool(torch.isfinite(a).all()), f"non-finite {name} logits"
        out[name] = (a - b).abs().max().item() / b.abs().max().item()
        assert out[name] <= MESH_LOGITS_TOL, (name, out[name])
    return dict(err_over_max=out, reroutes=routed, calls=len(calls))


def phase_mesh_serve(device, cfg, requests: int = MESH_REQUESTS,
                     prompt_len: int = PROMPT_LEN,
                     new_tokens: int = MESH_NEW_TOKENS) -> dict:
    """Phase 4m: one batch of ``requests`` prompts through
    ``ServeEngine(mesh=, dp_entry="data").generate`` (the main path:
    counts zeroed just before, read just after), and the same unsharded;
    then (a) every bucket_slots call of one prefill under the mesh and of
    one decode step bit for bit equal to bucket_slots_ref, and that
    step's logits and caches to the mesh's plain path's; (b) at the
    capacity factor no shard drops a record at, the last prefill logits
    and one decode step's within 3e-2 * max|logits| of the unsharded
    run's; (c) the launches equal to ``mesh_serve_launches``. Each
    engine's prefill and decode step timed alone, its tokens/s and peak
    memory; a prefill under 2s beside 1s; bucket_slots at the mesh's
    shapes by events and device time beside its plain version."""
    _, tf, eng = _serve()
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    kernels = serve_kernels(cfg)
    mesh = _mesh(device)
    model = tf.init_model(cfg, 0, device=device)
    prompts = serve_prompts(cfg, requests, prompt_len)
    B = requests
    max_len = prompt_len + MESH_CACHE_EXTRA
    tokens = serve_batch(prompts, None, 0, B, device)
    runs = {}
    for name, m in (("mesh", mesh), ("unsharded", None)):
        engine = eng.ServeEngine(cfg, model, max_len=max_len, mesh=m,
                                 dp_entry=MESH_DP if m else None,
                                 device=device)
        engine.generate(prompts[:, :128], 2)                     # warm
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        t0 = time.perf_counter()
        out = engine.generate(prompts, new_tokens)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        assert out.shape == (B, new_tokens) and out.min() >= 0 \
            and out.max() < cfg.vocab_size, out.shape
        want = (mesh_serve_launches(cfg, B, prompt_len, new_tokens) if m
                else serve_launches(cfg, B, B, prompt_len, new_tokens))
        if cuda:                                                 # (c)
            assert launches == want, (name, launches, want)
        with torch.inference_mode():
            _sync(device)
            t0 = time.perf_counter()
            logits, _, raw = engine._prefill(model, tokens)
            _sync(device)
            prefill_s = time.perf_counter() - t0
            cache = eng.prefill_to_decode_cache(cfg, raw, prompt_len,
                                                max_len)
            del raw
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            del logits
            _sync(device)
            t0 = time.perf_counter()
            for step in range(new_tokens - 1):
                logits, cache = engine._step(model, cache, tok,
                                             prompt_len + step)
                tok = logits[:, -1:].argmax(-1).to(torch.int32)
            _sync(device)
            decode_s = (time.perf_counter() - t0) / (new_tokens - 1)
        runs[name] = dict(launches=launches, want_launches=want,
                          wall_s=wall, served_tokens_per_s=out.size / wall,
                          prompt_tokens_per_s=B * prompt_len / wall,
                          prefill_ms=prefill_s * 1e3,
                          decode_ms_per_token=decode_s * 1e3,
                          peak_bytes=peak)
        if m is None:
            del cache
            continue
        # (a) the prefill's slot calls, one decode step's calls, logits
        # and caches, against the plain path on the same routing
        slots = served_slots(lambda: tf.prefill(
            cfg, model, tokens, mesh=mesh, dp_entry=MESH_DP,
            use_kernel=True))
        del slots["out"]
        assert set(slots["ids"]) == set(mesh_slot_shapes(cfg, B,
                                                         prompt_len))
        dec = served_decode(cfg, engine, model, cache, tok,
                            prompt_len + new_tokens - 1)
        moe_layers = sum(f == "moe" for _, f in layer_kinds(cfg))
        assert dec["calls"] == moe_layers * len(mesh_slot_shapes(cfg, B, 1))
        slots["decode_calls"] = dec["calls"]
        slots["ids"].update(dec["ids"])
        del cache
        # the prefill under 2s beside 1s (on one card the push is a
        # transpose: printed, not held)
        dispatch_ms = {}
        for mode in ("1s", "2s"):
            c = dataclasses.replace(cfg, dispatch_mode=mode)
            with torch.inference_mode():
                tf.prefill(c, model, tokens, mesh=mesh, dp_entry=MESH_DP,
                           use_kernel=True)
                _sync(device)
                t0 = time.perf_counter()
                tf.prefill(c, model, tokens, mesh=mesh, dp_entry=MESH_DP,
                           use_kernel=True)
                _sync(device)
            dispatch_ms[mode] = (time.perf_counter() - t0) * 1e3
    # (b) at a capacity no shard drops at, against the unsharded run
    with torch.inference_mode():
        factor, tried = no_drop_factor(cfg, [
            lambda c, m=m: tf.prefill(c, model, tokens, mesh=m,
                                      dp_entry=MESH_DP if m else None,
                                      use_kernel=True)
            for m in (mesh, None)])
    close = mesh_against_unsharded(dataclasses.replace(
        cfg, capacity_factor=factor), model, tokens, mesh, max_len)
    slots["times"] = time_served_slots(slots["ids"]) if cuda else {}
    slots["shapes"] = sorted(slots.pop("ids"))
    del model
    if cuda:
        torch.cuda.empty_cache()
    return dict(arch=cfg.name, n_layers=cfg.n_layers, mesh=MESH_SHAPE,
                dp_entry=MESH_DP, requests=B, prompt_len=prompt_len,
                new_tokens=new_tokens, max_len=max_len,
                launches=runs["mesh"]["launches"],
                want_launches=runs["mesh"]["want_launches"], runs=runs,
                own_factor=cfg.capacity_factor,
                own_factor_drops=tried[0][1][0],
                unsharded_own_factor_drops=tried[0][1][1],
                no_drop_factor=factor, factors_tried=tried,
                against_unsharded=close, dispatch_prefill_ms=dispatch_ms,
                slots=slots, seconds=time.perf_counter() - t_phase)


def phase_mesh_serves(device, archs) -> dict:
    """Phase 4m: ``phase_mesh_serve`` for each arch of ``archs`` at its
    ``MESH_ARCHS`` depth, printed as it ends."""
    get_config, _, _ = _serve()
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=MESH_ARCHS[arch])
        out[arch] = phase_mesh_serve(device, cfg)
        print_mesh_serve(out[arch])
    return out


def print_mesh_serve(s: dict):
    mesh, unsh = s["runs"]["mesh"], s["runs"]["unsharded"]
    print(f"serve-mesh: {s['arch']} at full width ({s['n_layers']} layers) "
          f"under mesh {s['mesh'][0]}x{s['mesh'][1]} (dp_entry "
          f"{s['dp_entry']}), {s['requests']} x {s['prompt_len']} tokens, "
          f"{s['new_tokens']} new, cache {s['max_len']}: launches "
          f"{s['launches']} (expected {s['want_launches']}); unsharded "
          f"{unsh['launches']}")
    for what, key, unit in (("prefill", "prefill_ms", "ms"),
                            ("decode", "decode_ms_per_token", "ms a token"),
                            ("served", "served_tokens_per_s", "tokens/s")):
        print(f"serve-mesh: {s['arch']} {what} {mesh[key]:.3f} {unit} "
              f"(unsharded {unsh[key]:.3f})")
    print(f"serve-mesh: {s['arch']} peak {mesh['peak_bytes'] / 2**30:.2f} "
          f"GiB (unsharded {unsh['peak_bytes'] / 2**30:.2f} GiB); prefill "
          f"under 2s {s['dispatch_prefill_ms']['2s']:.3f} ms, 1s "
          f"{s['dispatch_prefill_ms']['1s']:.3f} ms")
    c = s["against_unsharded"]
    print(f"serve-mesh: {s['arch']} records dropped at its own capacity "
          f"factor {s['own_factor']}: {s['own_factor_drops']} under the "
          f"mesh, {s['unsharded_own_factor_drops']} unsharded; none at "
          f"{s['no_drop_factor']}, where the last prefill logits and one "
          f"decode step's sit {c['err_over_max']} x max|logits| from the "
          f"unsharded run's (limit {MESH_LOGITS_TOL}; rows routed apart "
          f"{c['reroutes']['rows']}, max gap {c['reroutes']['max_gap']})")
    sl = s["slots"]
    print(f"serve-mesh: {s['arch']} bucket_slots == plain on "
          f"{sl['calls']} prefill calls and {sl['decode_calls']} of a decode "
          f"step; that step's logits and caches == the plain path's")
    for name, t in sl["times"].items():
        print(f"serve-mesh: bucket_slots {name}: {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.5f} ms), plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    print(f"serve-mesh: {s['arch']} {s['seconds']:.1f} s")


def mesh_train_launches(cfg, run, steps: int, shape=MESH_SHAPE) -> dict:
    """``train_launches`` under the mesh: ``mesh_slot_shapes``' calls an
    MoE layer and microbatch, twice under full remat."""
    moe = sum(f == "moe" for _, f in layer_kinds(cfg))
    again = 2 if run.train.remat_policy in ("full", "dots") else 1
    calls = len(mesh_slot_shapes(cfg, run.resolved_microbatch(),
                                 run.shape.seq_len, shape))
    return {"bucket_slots": moe * calls * again * run.grad_accum_steps
            * steps}


def phase_mesh_train(device, cfg, seq: int = TRAIN_SEQ,
                     batch: int = TRAIN_BATCH,
                     microbatch: int = TRAIN_MICROBATCH,
                     steps: int = MESH_TRAIN_STEPS) -> dict:
    """Phase 5m: ``steps`` steps of the launcher's path under the mesh
    (``train_state(mesh=)``: ``make_run``, ``dp_entry_for``,
    ``make_train_step(mesh=, dp_entry=)``, behind the
    ``DoubleBufferedLoader``; the main path: counts zeroed just before,
    read just after) and the same unsharded, each step timed with the
    host clock after its loss is read; every loss finite and the mesh's
    launches equal to ``mesh_train_launches``; then one step from a fresh
    state under the mesh and one unsharded at the capacity factor no
    shard drops at, their losses within 1e-2 relative."""
    _, _, corpus, pipeline, _, tf, _ = _train()
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    mesh = _mesh(device)
    stream = corpus.lm_token_stream(TRAIN_TOKENS, cfg.vocab_size, seed=0)
    runs = {}
    for name, m in (("mesh", mesh), ("unsharded", None)):
        run, fn, state = train_state(cfg, device, seq, batch, microbatch,
                                     steps, mesh=m)
        loader = pipeline.DoubleBufferedLoader(
            pipeline.lm_batches(stream, batch, seq), device)
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        losses, step_ms = [], []
        for _, b in zip(range(steps), loader):
            t0 = time.perf_counter()
            state, metrics = fn(state, b)
            losses.append(float(metrics["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: f.launches for k, f in wrappers().items() if f.launches}
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        assert all(math.isfinite(x) for x in losses), (name, losses)
        want = (mesh_train_launches(cfg, run, steps) if m
                else train_launches(cfg, run, steps))
        if cuda:
            assert launches == want, (name, launches, want)
        runs[name] = dict(losses=losses, step_ms=step_ms,
                          median_step_ms=float(np.median(step_ms)),
                          tokens_per_s=seq * batch / float(
                              np.median(step_ms)) * 1e3,
                          launches=launches, want_launches=want,
                          peak_bytes=peak, grad_accum=run.grad_accum_steps)
        del state, fn, loader
        if cuda:
            torch.cuda.empty_cache()
    # step 0 at the raised capacity, under the mesh and unsharded
    fixed = {k: torch.from_numpy(v).to(device) for k, v in
             next(pipeline.lm_batches(stream, batch, seq)).items()}
    model = tf.init_model(cfg, 0, device=device)
    with torch.no_grad():
        factor, tried = no_drop_factor(cfg, [
            lambda c, m=m: tf.loss_fn(c, model, {
                k: v[:microbatch] for k, v in fixed.items()}, mesh=m,
                dp_entry=MESH_DP if m else None, slot_kernel=True)
            for m in (mesh, None)])
    del model
    raised = dataclasses.replace(cfg, capacity_factor=factor)
    step0 = {}
    for name, m in (("mesh", mesh), ("unsharded", None)):
        _, fn, state = train_state(raised, device, seq, batch, microbatch,
                                   1, mesh=m)
        step0[name] = float(fn(state, fixed)[1]["loss"])
        del state, fn
        if cuda:
            torch.cuda.empty_cache()
    rel = _rel(step0["mesh"], step0["unsharded"])
    assert rel <= MESH_TRAIN_RTOL, step0
    return dict(arch=cfg.name, n_layers=cfg.n_layers, mesh=MESH_SHAPE,
                seq=seq, batch=batch, microbatch=microbatch, steps=steps,
                runs=runs, launches=runs["mesh"]["launches"],
                want_launches=runs["mesh"]["want_launches"],
                own_factor=cfg.capacity_factor, no_drop_factor=factor,
                factors_tried=tried, step0_raised=step0, step0_rel=rel,
                seconds=time.perf_counter() - t_phase)


def phase_mesh_trains(device, archs=(MOE_ARCH,)) -> dict:
    """Phase 5m for each arch of ``archs`` at its ``TRAIN_LAYERS``
    depth, printed as it ends."""
    get_config, _, _ = _serve()
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        if arch in TRAIN_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[arch])
        out[arch] = phase_mesh_train(device, cfg)
        print_mesh_train(out[arch])
    return out


def print_mesh_train(t: dict):
    mesh, unsh = t["runs"]["mesh"], t["runs"]["unsharded"]
    print(f"train-mesh: {t['arch']} at full width ({t['n_layers']} layers) "
          f"under mesh {t['mesh'][0]}x{t['mesh'][1]}, {t['steps']} steps of "
          f"{t['batch']} x {t['seq']} tokens, A = {mesh['grad_accum']}: "
          f"losses {mesh['losses']} (unsharded {unsh['losses']}); "
          f"launches {t['launches']} (expected {t['want_launches']})")
    print(f"train-mesh: median step {mesh['median_step_ms']:.2f} ms, "
          f"{mesh['tokens_per_s']:,.0f} tokens/s, peak "
          f"{mesh['peak_bytes'] / 2**30:.2f} GiB (unsharded "
          f"{unsh['median_step_ms']:.2f} ms, {unsh['tokens_per_s']:,.0f} "
          f"tokens/s, {unsh['peak_bytes'] / 2**30:.2f} GiB)")
    print(f"train-mesh: step 0 at capacity factor {t['no_drop_factor']} "
          f"(no record dropped; tried {t['factors_tried']}): "
          f"{t['step0_raised']}, rel {t['step0_rel']} (limit "
          f"{MESH_TRAIN_RTOL}); {t['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# 5p. train pipelined over the pod axis; 2f. the dry run on meta tensors
# ---------------------------------------------------------------------------

# 5p: olmo-1b at full width over a virtual (pod 2, data 2) mesh, GPipe
# over "pod" (``distributed/pipeline.py``): 8 x 512 tokens, M = 4
# microbatches, full remat, 4 steps, against ``make_train_step`` at A = 1
# unsharded on the same batches
PP_MESH, PP_AXES = (2, 2), ("pod", "data")
PP_MICROBATCHES, PP_STEPS = 4, 4
# step 0: the loss (relative) and each gradient leaf (over its max)
# against the unsharded step's; every step's loss against the unsharded
# step's on the same batch
PP_RTOL = 1e-2
# 2f: the dry run's cells on meta (part (a), in a child process that
# needs no card): (arch, shape, multipod, variant, calibrate)
DRYRUN_CELLS = (("olmo-1b", "train_4k", False, "base", True),
                ("olmo-1b", "prefill_32k", False, "base", False),
                ("olmo-1b", "decode_32k", False, "base", False),
                ("olmo-1b", "train_4k", True, "pp_pod", False),
                (MOE_ARCH, "train_4k", False, "base", False))
DRYRUN_TIMEOUT = 900
# part (b): meta's peak live bytes against the card's rise of
# ``max_memory_allocated`` over the same program
DRYRUN_PEAK_RTOL = 0.15


def _pp():
    _port()
    from repro_torch.distributed import pipeline as pp
    from repro_torch.distributed.mesh import local_mesh
    from repro_torch.launch import hlo_stats
    return pp, local_mesh, hlo_stats


def _leaf_rels(names, got, want) -> dict:
    """Each leaf's max |got - want| over max |want|, by name."""
    return {n: ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()
            for n, a, b in zip(names, got, want)}


def phase_pp_train(device, cfg, seq: int = TRAIN_SEQ,
                   batch: int = TRAIN_BATCH, steps: int = PP_STEPS,
                   M: int = PP_MICROBATCHES) -> dict:
    """Phase 5p: step 0's gates on one batch from a fresh state (seed 0):
    ``gpipe_loss_fn``'s loss within ``PP_RTOL`` (relative) of
    ``loss_fn``'s and its gradients (summed over the microbatches in the
    run's ``accum_dtype``, as ``make_pp_train_step`` sums them) within
    ``PP_RTOL`` of each leaf's max of ``make_train_step``'s (A = 1,
    unsharded), and the forward's
    collective-permutes M + S - 1, each one (B / M, seq, d) block of one
    pod rank; then ``steps`` steps of ``make_pp_train_step`` behind the
    ``DoubleBufferedLoader`` (the main path: counts zeroed just before,
    read just after; no kernel is launched, the reference's pipeline
    reaching no Pallas kernel) and as many unsharded steps on the same
    batches, each step timed by CUDA events and its permutes recorded:
    losses finite, the pipelined ones falling and each within
    ``PP_RTOL`` (relative) of the unsharded step's on the same batch,
    every step's permutes as step 0's."""
    config, _, corpus, pipeline, _, tf, _ = _train()
    pp, local_mesh, hlo_stats = _pp()
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    mesh = local_mesh(PP_MESH, PP_AXES, device)
    S = mesh.axis_size("pod")
    n_perm = M + S - 1
    block = (batch // M) * seq * cfg.d_model * torch.empty(
        (), dtype=getattr(torch, cfg.dtype)).element_size()
    stream = corpus.lm_token_stream(TRAIN_TOKENS, cfg.vocab_size, seed=0)
    fixed = {k: torch.from_numpy(v).to(device) for k, v in
             next(pipeline.lm_batches(stream, batch, seq, seed=1)).items()}

    run, fn, state = train_state(cfg, device, seq, batch, batch, steps)
    names = [n for n, _ in state.params.named_parameters()]
    leaves = list(state.params.parameters())
    g_ref, loss_ref, _ = fn.grads(state, fixed)
    with hlo_stats.CollectiveCounter() as cc:
        loss_pp, _ = pp.gpipe_loss_fn(
            cfg, state.params, fixed, mesh=mesh, n_microbatches=M,
            remat=run.train.remat_policy,
            accum_dtype=getattr(torch, run.train.accum_dtype))
    g_pp = torch.autograd.grad(loss_pp, leaves)
    rels = _leaf_rels(names, g_pp, g_ref)
    loss_pp = float(loss_pp.detach())
    step0 = dict(loss=loss_pp, loss_unsharded=float(loss_ref),
                 loss_rel=_rel(loss_pp, float(loss_ref)),
                 grad_rel=max(rels.values()),
                 worst_leaves=sorted(rels.items(), key=lambda kv: -kv[1])[:3],
                 collectives=hlo_stats.collective_bytes(cc.records))
    del g_ref, g_pp, loss_pp, state, fn, leaves
    assert step0["loss_rel"] <= PP_RTOL, step0
    assert step0["grad_rel"] <= PP_RTOL, step0
    col = step0["collectives"]
    assert (col["n_collective-permute"],
            col["collective-permute_result_bytes"]) == \
        (n_perm, n_perm * block), (col, n_perm, block)

    runs = {}
    for name in ("pipelined", "unsharded"):
        run, fn, state = train_state(cfg, device, seq, batch, batch, steps)
        if name == "pipelined":
            fn = pp.make_pp_train_step(cfg, run.train, mesh=mesh,
                                       n_microbatches=M)
        loader = pipeline.DoubleBufferedLoader(
            pipeline.lm_batches(stream, batch, seq), device)
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        losses, marks, perms = [], [], []
        for _, b in zip(range(steps), loader):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if cuda else []
            with hlo_stats.CollectiveCounter() as cc:
                if cuda:
                    ev[0].record()
                state, m = fn(state, b)
                if cuda:
                    ev[1].record()
            losses.append(m["loss"])
            marks.append(ev)
            perms.append(hlo_stats.collective_bytes(cc.records))
        _sync(device)
        launches = {k: f.launches for k, f in wrappers().items()
                    if f.launches}
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        losses = [float(x) for x in losses]
        step_ms = [a.elapsed_time(b) for a, b in marks] if cuda else []
        assert all(math.isfinite(x) for x in losses), (name, losses)
        assert not launches, (name, launches)
        med = float(np.median(step_ms)) if cuda else None
        runs[name] = dict(losses=losses, step_ms=step_ms,
                          median_step_ms=med,
                          tokens_per_s=seq * batch / med * 1e3 if cuda
                          else None, peak_bytes=peak, launches=launches,
                          collectives=perms[0])
        if name == "pipelined":
            assert losses[-1] < losses[0], losses
            assert all(p == col for p in perms), (perms, col)
        del state, fn, loader
        if cuda:
            torch.cuda.empty_cache()
    pp_losses, un_losses = (runs[n]["losses"]
                            for n in ("pipelined", "unsharded"))
    assert all(_rel(a, b) <= PP_RTOL for a, b in zip(pp_losses, un_losses)), \
        (pp_losses, un_losses)
    return dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                mesh=PP_MESH, axes=PP_AXES, seq=seq, batch=batch,
                microbatches=M, stages=S, steps=steps, remat="full",
                bubble=(S - 1) / (M + S - 1), step0=step0, runs=runs,
                permutes_per_step=n_perm, permute_block_bytes=block,
                seconds=time.perf_counter() - t_phase)


def phase_pp_trains(device) -> dict:
    """Phase 5p for ``TRAIN_ARCH`` at full width, printed as it ends."""
    get_config, _, _ = _serve()
    out = {TRAIN_ARCH: phase_pp_train(device, get_config(TRAIN_ARCH))}
    print_pp_train(out[TRAIN_ARCH])
    return out


def print_pp_train(t: dict):
    pp, un = t["runs"]["pipelined"], t["runs"]["unsharded"]
    s0, col = t["step0"], t["step0"]["collectives"]
    print(f"train-pp: {t['arch']} at full width ({t['n_layers']} layers, d "
          f"{t['d_model']}), GPipe over pod of a virtual "
          f"{t['mesh'][0]}x{t['mesh'][1]} {t['axes']} mesh, {t['steps']} "
          f"steps of {t['batch']} x {t['seq']} tokens, M = "
          f"{t['microbatches']}, remat {t['remat']}: losses {pp['losses']} "
          f"(unsharded A = 1 {un['losses']}); no kernel launched")
    print(f"train-pp: step 0 loss {s0['loss']:.6f} against loss_fn's "
          f"{s0['loss_unsharded']:.6f} (rel {s0['loss_rel']:.3e}), gradients "
          f"within {s0['grad_rel']:.3e} of each leaf's max (limit "
          f"{PP_RTOL}); forward permutes {col['n_collective-permute']} of "
          f"{col['collective-permute_result_bytes']:,} B (M + S - 1 = "
          f"{t['permutes_per_step']} x {t['permute_block_bytes']:,} B), "
          f"all-reduces {col.get('n_all-reduce', 0)}")
    if pp["median_step_ms"] is not None:
        print(f"train-pp: median step {pp['median_step_ms']:.2f} ms, "
              f"{pp['tokens_per_s']:,.0f} tokens/s, peak "
              f"{pp['peak_bytes'] / 2**30:.2f} GiB (unsharded "
              f"{un['median_step_ms']:.2f} ms, {un['tokens_per_s']:,.0f} "
              f"tokens/s, {un['peak_bytes'] / 2**30:.2f} GiB; CUDA events, "
              f"steps {pp['step_ms']} / {un['step_ms']}); bubble "
              f"{t['bubble']:.3f}; {t['seconds']:.1f} s")


def dryrun_cells(out_dir: str) -> list:
    """Phase 2f (a): each of ``DRYRUN_CELLS`` through
    ``launch.dryrun.run_cell`` on meta tensors over the production mesh,
    its JSON under ``out_dir``."""
    _port()
    from repro_torch.launch import dryrun as dr
    return [dr.run_cell(arch, shape, multi_pod=mp, do_calibrate=cal,
                        out_dir=out_dir, variant=variant)
            for arch, shape, mp, variant, cal in DRYRUN_CELLS]


def dryrun_child(out: str) -> int:
    """The smoke's child for 2f (a): the cells on meta, one thread, no
    card; their records as JSON into ``out``."""
    import tempfile
    torch.set_num_threads(1)
    os.nice(10)             # a low priority: it needs no card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun-") as d:
        recs = dryrun_cells(d)
    Path(out).write_text(json.dumps({"cells": recs,
                                     "wall_s": time.perf_counter() - t0}))
    return 0


def start_dryrun() -> dict:
    """Start 2f (a) in a child process (it needs no card); the child is
    stopped at exit if it still runs."""
    import atexit
    import tempfile
    d = tempfile.mkdtemp(prefix="smoke-dryrun-")
    out, log = os.path.join(d, "cells.json"), os.path.join(d, "child.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-child",
             out], stdout=f, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return dict(proc=proc, out=out, log=log)


def meta_against_card(device, cfg, B: int = BATCH,
                      S: int = PROMPT_LEN) -> dict:
    """Phase 2f (b): ``prefill(unroll=True)`` of ``cfg`` at (B, S),
    unsharded, plain path, measured by ``dryrun.measure`` once on meta
    and once on the card (after a warm-up call): FLOPs equal, the
    collective records equal, meta's peak live bytes within
    ``DRYRUN_PEAK_RTOL`` of the rise of ``max_memory_allocated`` over
    the card's call."""
    _, _, _, _, _, tf, _ = _train()
    from repro_torch.launch import dryrun as dr
    fn = functools.partial(tf.prefill, cfg, unroll=True)
    recs = {}
    for where in ("meta", "card"):
        dev = torch.device("meta") if where == "meta" else device
        params = tf.init_model(cfg, 0, device=dev)
        tokens = (torch.empty((B, S), dtype=torch.int32, device=dev)
                  if where == "meta" else torch.randint(
                      0, cfg.vocab_size, (B, S), dtype=torch.int32,
                      device=dev, generator=torch.Generator(
                          device=dev).manual_seed(0)))
        args = (params, {"tokens": tokens})
        cuda = where == "card" and device.type == "cuda"
        if cuda:
            fn(*args)                           # warm-up
            _sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        rec = dr.measure(fn, args, None, n_devices=1)
        if cuda:
            _sync(device)
            rec["card_rise_bytes"] = \
                torch.cuda.max_memory_allocated(device) - base
        recs[where] = rec
        del params, tokens, args
    meta, card = recs["meta"], recs["card"]
    assert meta["cost_analysis"]["flops_total"] == \
        card["cost_analysis"]["flops_total"], recs
    assert meta["collectives"] == card["collectives"], recs
    ratio = None
    if "card_rise_bytes" in card:       # the CPU has no allocator's peak
        ratio = (meta["memory_analysis"]["peak_live_bytes"]
                 / card["card_rise_bytes"])
        assert abs(ratio - 1) <= DRYRUN_PEAK_RTOL, (ratio, recs)
    return dict(arch=cfg.name, batch=B, seq=S, meta=meta, card=card,
                peak_ratio=ratio,
                card_peak_live_bytes=card["memory_analysis"][
                    "peak_live_bytes"])


def phase_dryrun(device) -> dict:
    """Phase 2f: (a) the cells in a child, alone on the host (beside the
    card's phases it slowed their host-bound timings:
    ``tools/dryrun_beside.py``), every one ``ok``; (b) meta against the
    card on olmo-1b's prefill at the served shape."""
    get_config, _, _ = _serve()
    t0 = time.perf_counter()
    child = start_dryrun()
    proc = child["proc"]
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    log = Path(child["log"]).read_text()
    assert rc == 0, f"the dry run's child ended {rc}:\n{log[-4000:]}"
    got = json.loads(Path(child["out"]).read_text())
    cells = got["cells"]
    bad = [(c["arch"], c["shape"], c.get("error", "")[-600:]) for c in cells
           if c["status"] != "ok"]
    assert not bad, bad
    waited = time.perf_counter() - t0
    versus = meta_against_card(device, get_config(TRAIN_ARCH))
    return dict(cells=cells, child_wall_s=got["wall_s"], waited_s=waited,
                meta_vs_card=versus, seconds=time.perf_counter() - t0)


def print_dryrun(d: dict):
    for c in d["cells"]:
        f = c["full"]
        ca, col = f["cost_analysis"], f["collectives"]
        cal = c.get("calibration")
        cal_s = (f"; calibrated: extrapolated flops/dev "
                 f"{cal['extrapolated']['flops']:.4e}, minus the direct "
                 f"count {cal['check']['flops']}" if cal else "")
        print(f"dryrun: {c['arch']} x {c['shape']} x {c['mesh']}"
              f"{'' if c['variant'] == 'base' else ' ' + c['variant']}: "
              f"args/dev {f['memory_analysis']['argument_size_in_bytes']:,.0f}"
              f" B, flops/dev {ca['flops']:.4e} (total "
              f"{ca['flops_total']:.4e}), collectives/dev "
              f"{col['total']:,.0f} B "
              f"{ {k: v for k, v in col.items() if k.startswith('n_')} }, "
              f"peak live {f['memory_analysis']['peak_live_bytes'] / 2**30:.2f}"
              f" GiB, {f['measure_s']:.2f} s{cal_s}")
    v = d["meta_vs_card"]
    print(f"dryrun: {v['arch']} prefill at B {v['batch']} S {v['seq']} "
          f"(unroll, plain path) on meta and on the card: flops "
          f"{v['meta']['cost_analysis']['flops_total']:.6e} both, "
          f"collectives equal; peak live bytes meta "
          f"{v['meta']['memory_analysis']['peak_live_bytes']:,.0f} / card "
          f"rise {v['card']['card_rise_bytes']:,.0f} = "
          f"{v['peak_ratio']:.4f} (limit 1 +- {DRYRUN_PEAK_RTOL}); meta "
          f"{v['meta']['measure_s']:.2f} s, card {v['card']['measure_s']:.2f} s")
    print(f"dryrun: the child's cells took {d['child_wall_s']:.1f} s, "
          f"{d['waited_s']:.1f} s from its start to its end; phase "
          f"{d['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# 6. the examples
# ---------------------------------------------------------------------------

# each ``examples/*_torch.py`` and its reduced size: the WordCount ones on
# 2**19 tokens, training 4 steps, serving 8 requests of 8 new tokens
EXAMPLE_RUNS = {
    "serve_lm_torch.py": ("--requests", "8", "--new-tokens", "8"),
    "train_lm_torch.py": ("--steps", "4"),
    "skewed_wordcount_torch.py": ("--tokens", str(2**19)),
    "streaming_wordcount_torch.py": ("--tokens", str(2**19)),
    "wordcount_puma_torch.py": ("--tokens", str(2**19)),
}
EXAMPLE_TIMEOUT = 300


def run_example(name: str, tmp: str, extra: tuple = ()) -> dict:
    """``examples/<name>`` on the card in a child of its own at its
    ``EXAMPLE_RUNS`` size and with ``extra`` flags (training's snapshots
    under ``tmp``); raises with the child's output on a non-zero exit.
    Its seconds and the last lines it printed."""
    argv = [sys.executable, str(ROOT / "examples" / name),
            *EXAMPLE_RUNS[name], *extra]
    if name.startswith("train_lm"):
        argv += ["--ckpt-dir", os.path.join(tmp, "train_ckpt")]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=EXAMPLE_TIMEOUT, cwd=ROOT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return dict(seconds=seconds, lines=proc.stdout.strip().splitlines()[-9:])


def phase_examples(names=None, extra: tuple = ()) -> dict:
    """Phase 6: each example of ``names`` (all of ``EXAMPLE_RUNS`` by
    default) through ``run_example`` (``extra`` flags, e.g. ``--device
    cpu``, for each), side by side (so wordcount_puma's walls are taken
    beside the others' work); the phase's seconds."""
    import tempfile
    names = list(names or EXAMPLE_RUNS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke-examples-") as tmp:
        with ThreadPoolExecutor(len(names)) as pool:
            runs = {n: pool.submit(run_example, n, tmp, extra)
                    for n in names}
            out = {n: f.result() for n, f in runs.items()}
    out["seconds"] = time.perf_counter() - t0
    return out


def print_examples(ex: dict):
    for name, r in ex.items():
        if name == "seconds":
            continue
        print(f"examples: {name} {' '.join(EXAMPLE_RUNS[name])}: exit 0 in "
              f"{r['seconds']:.1f} s")
        for line in r["lines"]:
            if line.strip():
                print(f"examples:   {line}")
    print(f"examples: {ex['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# 7. report
# ---------------------------------------------------------------------------

def entry_kernel(name: str, source: str, replaces: str, entry: dict,
                 times: dict, main: str, others: tuple, built: dict,
                 matrix_err: float) -> dict:
    """The ``kernels`` line's entry of an entry-point kernel: its numbers
    at its ``main`` full-width case, and those of its ``others``."""
    t = times[main]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = [k for k in t if (k.endswith("ms") and k not in keys)
             or k == "device_activities_per_call"]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": entry["launches"][name],
            "max_abs_err": max(matrix_err, *(entry["max_abs_err"][c]
                                             for c in (main, *others))),
            "matches_plain": True, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "build_s": built[name].seconds,
            **{k: t[k] for k in extra}, "shape": main,
            **{o: {k: times[o][k] for k in (*keys, *extra)} for o in others}}


def served_slots_kernel(serves: dict, train: dict, entry: dict,
                        mesh_serves: dict | None = None,
                        mesh_train: dict | None = None,
                        smoke: dict | None = None) -> dict:
    """The ``kernels`` line's bucket_slots entry: its launches on the
    served paths (phase 4's MoE archs, 4m's under the mesh and 4s's SMOKE
    configs) and the training paths (phase 5's MoE run, 5m's), its
    numbers at
    deepseek-v2-lite's served shape of the expert buffers (the larger),
    then its other served shapes, jamba's, the mesh's (all shards'
    records in a call) and the entry-point shapes of phase 2
    (``entry``)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "device_activities_per_call")
    by_path = {f"serve {a}": r["launches"]["bucket_slots"]
               for a, r in serves.items() if "bucket_slots" in r["launches"]}
    by_path.update({f"train {a}": r["launches"]["bucket_slots"]
                    for a, r in train.items() if r["want_launches"]})
    mesh_serves, mesh_train = mesh_serves or {}, mesh_train or {}
    by_path.update({f"serve-mesh {a}": r["launches"]["bucket_slots"]
                    for a, r in mesh_serves.items()})
    by_path.update({f"train-mesh {a}": r["launches"]["bucket_slots"]
                    for a, r in mesh_train.items()})
    by_path.update({f"smoke-serve {a}": r["launches"]["bucket_slots"]
                    for a, r in (smoke or {}).items()
                    if a != "seconds" and "bucket_slots" in r["launches"]})
    times = {f"{a} {n}": t for a, r in serves.items() if r["slots"]
             for n, t in r["slots"]["times"].items()}
    times.update({f"mesh {a} {n}": t for a, r in mesh_serves.items()
                  for n, t in r["slots"]["times"].items()})
    sl = serves[MOE_ARCH]["slots"]
    main = max(sl["times"], key=lambda n: sl["times"][n]["bytes"])
    main = f"{MOE_ARCH} {main}"
    return {**entry, **{k: times[main][k] for k in keys},
            "launches": sum(by_path.values()),
            "launches_by_path": {**by_path,
                                 "entry points": entry["launches"]},
            "served_calls_checked": {
                **{a: {"prefill": r["slots"]["calls"],
                       "decode_step": r["slots"]["decode_calls"]}
                   for a, r in serves.items() if r["slots"]},
                **{f"mesh {a}": {"prefill": r["slots"]["calls"],
                                 "decode_step": r["slots"]["decode_calls"]}
                   for a, r in mesh_serves.items()}},
            "train_calls_checked": {a: r["slots"]["calls_full"]
                                    for a, r in train.items() if r["slots"]},
            "prefill_share": {a: r["slots"]["prefill_share"]
                              for a, r in serves.items() if r["slots"]},
            "decode_share": {a: r["slots"]["decode_share"]
                             for a, r in serves.items() if r["slots"]},
            "shape": main,
            **{n: {k: t[k] for k in keys} for n, t in times.items()
               if n != main},
            entry["shape"]: {k: entry[k] for k in keys if k in entry}}


def mutant_kernel(name: str, lint: dict, times: dict, built: dict) -> dict:
    """The ``kernels`` line's entry of a near twin's mutant kernel."""
    t = times[name]
    kernel = MUTANT_KERNELS[name]
    return {"name": kernel, "route": "cuda",
            "source": "src/repro_torch/analysis/mutant_kernels/csrc/"
                      "mutants.cu",
            "replaces": f"src/repro/analysis/{MUTANT_REPLACES[kernel]}",
            "launches": lint["launches"][kernel],
            "max_abs_err": lint["max_abs_err"][name],
            "matches_plain": True, "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "build_s": built["mutants"].seconds, "shape": name}


def print_decode_times(times: dict):
    for name, e in times.items():
        if not name.startswith("decode_"):
            continue
        line = ", ".join(f"{k} {e[k]:.4f}" for k in sorted(e)
                         if k.endswith("ms") and e[k] is not None)
        print(f"entry: {name} (ms): {line}; device kernels "
              f"{e['device_kernels']}")


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if argv[:1] == ["--memcheck-child"]:
        return memcheck_child(argv[1])
    if argv[:1] == ["--dryrun-child"]:
        return dryrun_child(argv[1])
    if argv:
        raise SystemExit(f"chip_smoke.py takes no arguments, got {argv}")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    built = phase_build()

    err = phase_kernel_vs_plain(device, fused_matrix())
    print(f"kernels: fused_map == plain on every matrix case "
          f"(max abs err {err})")
    wide_err = phase_kernel_vs_plain(device, fused_wide_matrix())
    print(f"kernels: fused_map == plain on every wide case, S 1,025-16,384 "
          f"(max abs err {wide_err})")
    timing = time_fused(device)
    print(f"fused_map at P={N_PROCS} S={TASK} cap={CAP} V={VOCAB}, rep 8 on "
          f"rank 0: {timing['device_ms'] * 1e3:.2f} us/launch on the device "
          f"({timing['ms'] * 1e3:.2f} us back to back, events), plain "
          f"{timing['plain_ms'] * 1e3:.1f} us, bound "
          f"{timing['bound_ms'] * 1e3:.3f} us ({timing['bound_by']}, "
          f"{timing['bytes']} B at 3.35 TB/s; {timing['unique']} unique "
          f"keys, {timing['window_slots']} window slots)")
    print(f"fused_map: the hot rank at rep 1 / 16: "
          f"{timing['rep1_device_ms'] * 1e3:.2f} / "
          f"{timing['rep16_device_ms'] * 1e3:.2f} us/launch on the device, "
          f"{timing['pass_ms'] * 1e3:.3f} us a pass over L = {2 * TASK}")
    print_fused_wide(timing["wide"])

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    fa_errs = phase_flash_vs_plain(device, {**FLASH_MATRIX, **FLASH_FULL})
    for name, e in fa_errs.items():
        print(f"kernels: flash_attention ~ plain on {name}: max abs err {e}")
    fa = time_flash(device)
    for arch, t in fa.items():
        B, S, H, KV, hd, causal, window = t["shape"]
        shape = (f"B={B} S={S} H={H} KV={KV} hd={hd}"
                 f"{' causal' if causal else ''}"
                 f"{f' window={window}' if window else ''} ({arch})")
        bf16 = t["dtype"] == "bfloat16"
        fp32 = (f" (the fp32 kernel in fp32 {t['fp32_ms']:.3f} ms)"
                if bf16 else " (the fp32 kernel, CUDA cores)")
        print(f"flash_attention at {shape} {'bf16' if bf16 else 'fp32'}: "
              f"{t['ms']:.4f} ms{fp32}, plain "
              f"{t['plain_ms']:.3f} ms, SDPA {t['library_ms']:.4f} ms (max "
              f"abs diff to the kernel {t['sdpa_vs_kernel_max_abs']}), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
              f"{t['flops'] / 1e9:.1f} GFLOP at "
              f"{FLOPS_PER_S[t['dtype']] / 1e12:.0f} TFLOP/s, "
              f"{t['bytes'] / 1e6:.1f} MB at 3.35 TB/s)")

    ssd_errs = phase_ssd_vs_plain(device, {**SSD_MATRIX, **SSD_FULL})
    for name, e in ssd_errs.items():
        print(f"kernels: ssd_scan ~ plain on {name}: max abs err {e}")
    ssd_bits = check_ssd_bits(device, {**SSD_MATRIX, **SSD_FULL})
    for name, b in ssd_bits.items():
        print(f"kernels: ssd_scan on {name}: y off the plain version's bits "
              f"{b['kernel']}, scores rounded to bf16 {b['scores_bf16']}")
    ssd = time_ssd(device)
    for shape, t in (("H=48 P=64 N=128 G=1 chunk=256", ssd),
                     ("H=128 P=64 N=16 G=1 chunk=256 (jamba-v0.1)",
                      ssd["jamba"])):
        fp32 = (f", fp32 kernel in fp32 {t['fp32_ms']:.3f} ms"
                if "fp32_ms" in t else "")
        print(f"ssd_scan at B={BATCH} S={PROMPT_LEN} {shape} bf16: "
              f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms, "
              f"{t['device_kernels']} device kernels a call: "
              f"{t['device_kernel_names']}){fp32}, plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {t['bytes'] / 1e6:.1f} MB at 3.35 TB/s, "
              f"{t['flops'] / 1e9:.1f} GFLOP at 989 TFLOP/s)")

    matrix = matrix_cases(device, slots={**SLOTS_MATRIX, **SLOTS_LOOKBACK},
                          decode={**DECODE_MATRIX, **DECODE_FULL_F32})
    m_errs = check_cases(matrix)
    check_decode_edges(matrix)
    fd_bits = check_decode_bits(matrix)
    _sync(device)
    fd_errs = {n: e for n, e in m_errs.items()
               if matrix[n]["kernel"] == "flash_decode"}
    del matrix
    print(f"kernels: hist and bucket_slots == plain on every matrix case: "
          f"{', '.join(n for n in m_errs if n not in fd_errs)}")
    for name, e in fd_errs.items():
        print(f"kernels: flash_decode ~ plain on {name}: max abs err {e}")
    for name, b in fd_bits.items():
        print(f"kernels: flash_decode on {name}: outputs off the plain "
              f"version's bits {b['kernel']}, p rounded to bf16 "
              f"{b['p_bf16']}")
    _, data, _, _, _ = _port()
    corpus = data.read_all(job_input(N_TOKENS)[0])   # 2, 3b-3c, 3e-3f, 3i
    cases = entry_cases(device, corpus)
    entry = phase_entry(device, cases)
    print(f"entry: hist, bucket_slots and flash_decode at full width through "
          f"their entry points, launches {entry['launches']}; max abs err "
          f"to plain {entry['max_abs_err']}; flash_decode outputs off the "
          f"plain version's bits (p rounded to bf16) {entry['bits_off']}")
    entry_t = time_entry(cases)
    zipf = cases["hist_count"]["run"].args[0]     # kept for phase 2e
    del cases
    for name, e in entry_t.items():
        lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
        dev = (f" (device {e['device_ms']:.5f} ms, "
               f"{e['device_activities_per_call']:.2f} device activities a "
               f"call: {e['device_activities']}; timed in "
               f"{e['seconds']:.1f} s)"
               if "device_activities_per_call" in e else "")
        print(f"entry: {name}: {e['ms']:.4f} ms{dev}, plain "
              f"{e['plain_ms']:.4f} ms, "
              f"library {lib}, bound {e['bound_ms']:.5f} ms ({e['bound_by']}: "
              f"{e['bytes']} B at 3.35 TB/s, {e['ops']} operations)")
    print_decode_times(entry_t)

    lint = phase_lint(device)
    lint_t = time_entry(lint["cases"])
    for name, c in lint["cases"].items():    # device time, in turns
        dev = _in_turns({"kernel": c["run"], "library": c["library"]},
                        lambda f: _device_ms(f, 200)[0])
        lint_t[name].update(device_ms=dev["kernel"],
                            library_device_ms=dev["library"])
    print(f"lint: fleetlint --all and --selftest on the card: 82 programs, "
          f"6 kernels clean and 20 mutants PASS in {lint['seconds']:.1f} s; "
          f"launches {lint['launches']} (fused_map == the +fused handles' "
          f"{lint['fused_steps']} steps); {len(lint['fused_twins'])} +fused "
          f"finishes == their unfused twins' bit for bit; near twins == "
          f"plain bit for bit on seeded inputs")
    for name, e in lint_t.items():
        print(f"lint: {MUTANT_KERNELS[name]} ({name}): {e['ms']:.5f} ms "
              f"(device {e['device_ms']:.5f} ms), plain "
              f"{e['plain_ms']:.5f} ms, library {e['library_ms']:.5f} ms "
              f"(device {e['library_device_ms']:.5f} ms), "
              f"bound {e['bound_ms']:.7f} ms ({e['bound_by']}: {e['bytes']} B "
              f"at 3.35 TB/s; launch-bound)")
    memcheck = phase_memcheck()
    print(f"memcheck: {memcheck['seconds']:.1f} s")
    guard = phase_guard(device, zipf)
    del zipf
    for kernel, k in guard["kernels"].items():
        direct = (f" and {k['c_entry_calls']} calls of its C entry point "
                  f"into banded outputs" if "c_entry_calls" in k else "")
        print(f"guard: {kernel}: {k['cases']} cases x 2 fills, launches "
              f"{k['launches']}{direct}; bands untouched, outputs unchanged "
              f"(max abs diff {k['max_abs_diff']}); {k['seconds']:.2f} s")
    for name, verdict in guard["bad"].items():
        print(f"guard: {name} ({PAL001_BAD[name]}) over banded inputs: "
              f"{verdict}")
    print(f"guard: {guard['seconds']:.1f} s")

    job = phase_job(device, N_TOKENS, N_UNFUSED)
    print(f"job: N={job['n']} WordCount V={VOCAB} P={N_PROCS} S={TASK} "
          f"cap={CAP} segment={SEGMENT}, {job['steps']} steps, "
          f"{job['n_records']} records == oracle; fused (graph) == fused "
          f"(eager loop) == unfused at N={job['n_unfused']}")
    print(f"job: fused {job['fused_wall']:.2f} s "
          f"({job['tokens_per_s']:.0f} tokens/s), fused_map launches "
          f"{job['launches']} (one a graph replay), peak device memory "
          f"{job['peak_bytes'] / 2**20:.1f} MiB, imbalance "
          f"{job['imbalance']:.2f}; feed {job['feed']['prefetch_hits']} "
          f"prefetch hits, {job['feed']['prefetch_misses']} misses of "
          f"{job['segments']} segments, {job['feed_s_per_segment']:.4f} s "
          f"to read one on the host")
    print(f"job: at N={job['n_unfused']}: fused with the graph "
          f"{job['fused_wall_at_n_unfused']:.2f} s, fused in the eager loop "
          f"{job['eager_wall_at_n_unfused']:.2f} s, unfused "
          f"{job['unfused_wall']:.2f} s "
          f"({job['unfused_tokens_per_s']:.0f} tokens/s)")
    prof = {}
    for what, eager in (("graph", False), ("eager", True)):
        p = prof[what] = phase_profile(device, 4 * SEGMENT * TASK * N_PROCS,
                                       eager=eager)
        print_profile(f"one fused segment ({SEGMENT} steps, {what})", p)
        print(f"profile: {what}: host {p['enqueue_s'] / p['steps'] * 1e6:.2f} "
              f"us a step to enqueue, {p['segment_s'] / p['steps'] * 1e6:.2f} "
              f"us a step to finish, its input read already; busy share "
              f"{p['untraced_busy_share']:.3f} without the profiler (device "
              f"time of the traced segment over the next one's wall)")

    t0 = time.perf_counter()
    compare = phase_compare(device, corpus)
    compare["seconds"] = time.perf_counter() - t0
    print_compare(compare)
    t0 = time.perf_counter()
    snaps = phase_snapshots(device, corpus)
    snaps["seconds"] = time.perf_counter() - t0
    print_snapshots(snaps)
    t0 = time.perf_counter()
    keyskew = phase_keyskew(device)
    keyskew["seconds"] = time.perf_counter() - t0
    print_keyskew(keyskew)
    t0 = time.perf_counter()
    fleet = phase_fleet(device, corpus)
    fleet["seconds"] = time.perf_counter() - t0
    print_fleet(fleet)
    t0 = time.perf_counter()
    overlap = phase_overlap(device, corpus)
    overlap["seconds"] = time.perf_counter() - t0
    print_overlap(overlap)
    t0 = time.perf_counter()
    coded = phase_coded(device)
    coded["seconds"] = time.perf_counter() - t0
    print_coded(coded)
    t0 = time.perf_counter()
    crossjob = phase_crossjob(device)
    crossjob["seconds"] = time.perf_counter() - t0
    print_crossjob(crossjob)
    t0 = time.perf_counter()
    elastic = phase_elastic(device, corpus)
    elastic["seconds"] = time.perf_counter() - t0
    print_elastic(elastic)
    del corpus
    t0 = time.perf_counter()
    imbalance = phase_imbalance(device)
    imbalance["seconds"] = time.perf_counter() - t0
    print_imbalance(imbalance)

    serves = phase_serves(device, SERVE_ARCHS)
    smoke = phase_smoke_serves(device)
    print(f"smoke-serve: {smoke['seconds']:.1f} s")
    train = phase_trains(device, TRAIN_ARCHS)
    mesh_serves = phase_mesh_serves(device, MESH_ARCHS)
    mesh_train = phase_mesh_trains(device)
    pp_train = phase_pp_trains(device)
    dryrun = phase_dryrun(device)
    print_dryrun(dryrun)
    examples = phase_examples()
    print_examples(examples)
    print(json.dumps({"job": job, "profile": prof, "compare": compare,
                      "snapshots": snaps, "keyskew": keyskew,
                      "fleet": fleet, "overlap": overlap,
                      "coded": coded, "crossjob": crossjob,
                      "elastic": elastic, "imbalance": imbalance,
                      "fused_map": timing,
                      "flash_attention": {**fa, "max_abs_err": fa_errs},
                      "ssd_scan": {**ssd, "max_abs_err": ssd_errs,
                                   "bits_off": ssd_bits},
                      "entry": {**entry, "times": entry_t,
                                "flash_decode_matrix_err": fd_errs,
                                "flash_decode_matrix_bits_off": fd_bits},
                      "lint": {"launches": lint["launches"],
                               "fused_steps": lint["fused_steps"],
                               "fused_twins": lint["fused_twins"],
                               "seconds": lint["seconds"],
                               "max_abs_err": lint["max_abs_err"],
                               "times": lint_t},
                      "memcheck": memcheck, "guard": guard,
                      "serve": serves, "smoke_serve": smoke,
                      "train": train, "examples": examples,
                      "mesh_serve": mesh_serves, "mesh_train": mesh_train,
                      "pp_train": pp_train, "dryrun": dryrun}))

    def by_arch(kernel: str) -> dict:
        return {**{a: r["launches"][kernel] for a, r in serves.items()
                   if kernel in r["launches"]},
                **{f"mesh {a}": r["launches"][kernel]
                   for a, r in mesh_serves.items()
                   if kernel in r["launches"]},
                **{f"smoke {a}": r["launches"][kernel]
                   for a, r in smoke.items()
                   if a != "seconds" and kernel in r["launches"]}}
    print(json.dumps({"kernels": [{
        "name": "fused_map", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_map/csrc/fused_map.cu",
        "replaces": "src/repro/kernels/fused_map/kernel.py:162",
        "launches": job["launches"],
        "launches_by_path": {
            "job": job["launches"],
            "1s+steal": {g: compare[g]["1s+steal"]["launches"]
                         for g in GRIDS},
            "keyskew": {f"{a} {k}": r["launches"]
                        for a in map(str, KEYSKEW_A)
                        for k, r in keyskew[a].items() if k != "records"},
            "fleet": {p: fleet["b"][p]["launches"]
                      for p in FLEET_POLICIES},
            "coded r1-fused": {s: row["r1-fused"]["launches"]
                               for s, row in coded["skews"].items()},
            "elastic": {arm: elastic["b"][arm]["launches"]
                        for arm in ("p8", "p6", "p6p8")},
            "imbalance": {f"{s} {arm}": row[arm]["launches"]
                          for s, row in imbalance["skews"].items()
                          for arm in IMBALANCE_ARMS if "-fused" in arm},
            f"imbalance S{imbalance['wide']['task']}":
                imbalance["wide"]["launches"],
            "lint": lint["launches"]["fused_map"]},
        "max_abs_err": max(err, wide_err),
        "matches_plain": True,
        "ms": timing["ms"], "device_ms": timing["device_ms"],
        "pass_ms": timing["pass_ms"],
        "wide": {str(S): {k: t[k] for k in (
            "ms", "rep1_device_ms", "rep8_device_ms", "plain_ms", "bound_ms",
            "bound_by")} for S, t in timing["wide"].items()},
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
        "build_s": built["fused_map"].seconds}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bf16.cu",
        "fp32_source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
        "launches": sum(by_arch("flash_attention").values()),
        "launches_by_arch": by_arch("flash_attention"),
        "max_abs_err": max(fa_errs.values()),
        **{k: fa["olmo-1b"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "fp32_ms")},
        "build_s": built["flash_attention"].seconds,
        "fp32_build_s": built["flash_attention_fp32"].seconds,
        "shape": "olmo-1b", **{arch: {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "fp32_ms")} for arch, t in fa.items() if arch != "olmo-1b"}}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bf16.cu",
        "fp32_source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:77",
        "launches": sum(by_arch("ssd_scan").values()),
        "launches_by_arch": by_arch("ssd_scan"),
        "device_kernels_per_launch": ssd["device_kernels"],
        "max_abs_err": max(ssd_errs.values()),
        "ms": ssd["ms"], "device_ms": ssd["device_ms"],
        "fp32_ms": ssd["fp32_ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": None,
        "build_s": built["ssd_scan"].seconds,
        "fp32_build_s": built["ssd_scan_fp32"].seconds,
        "shape": "mamba2-780m", HYBRID_ARCH: {k: ssd["jamba"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}},
        entry_kernel("hist", "wordcount_hash/csrc/hist.cu",
                     "wordcount_hash/kernel.py:66", entry, entry_t,
                     "hist_count", ("hist_owner", "hist_count_uniform",
                                    "hist_owner_uniform"), built, 0),
        served_slots_kernel(serves, train, entry_kernel(
            "bucket_slots", "moe_dispatch/csrc/bucket_slots.cu",
            "moe_dispatch/kernel.py:51", entry, entry_t, "slots_routing",
            ("slots_owner_window",), built, 0), mesh_serves, mesh_train,
            smoke),
        entry_kernel("flash_decode", "flash_decode/csrc/flash_decode.cu",
                     "flash_decode/kernel.py:71", entry, entry_t,
                     "decode_olmo-1b", ("decode_h2o-danube-1.8b",), built,
                     max(fd_errs.values())),
        *(mutant_kernel(name, lint, lint_t, built) for name in MUTANT_KERNELS)
    ]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
