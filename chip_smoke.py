"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. report   the card's name, the device count, name and power limit;
  2. build    the CUDA kernels from src/repro_torch/kernels/csrc with nvcc
              (each library holds one kernel's fused and raw entry points);
  3. kernels  each fused and each raw kernel against its plain PyTorch
              version at depth 8, 500 trees, 28 features on 16,421 rows
              (a ragged last block) with NaN rows: fused sums bit-identical
              on integer leaves and within TOL on float leaves, raw [B, T]
              scores bit-identical (bit for bit, sign of zero included);
              then every kernel, fused and raw, at shallower depths with
              -0.0 leaves, all bit for bit: predicated and HummingBird at
              1, 3 and 5, QuickScorer at 1, 3, 5 and 6 (the first depth
              whose top node clears a whole 32-leaf word); then the wide
              rows: at F = 968, 1,185, 2,000, 4,096 and 10,000 the
              feature-major transpose (forest_transpose_rows) bit for bit
              its plain version, and every kernel, fused and raw, in the
              wide-row x mode (wide-tiled for fused predicated and both
              HummingBird kernels) and (where a
              32-sample tile fits) staged, at depth 8 on 16,421 rows with
              NaN rows, and from 1,185 up the shallower depths with -0.0
              leaves likewise, all bit for bit; then the three fused
              kernels over bf16 tree tiles (tree_dtype=torch.bfloat16: a
              4-byte node record and bf16 leaves), bit for bit against
              their plain versions: on the 16,421 rows at depth 8, at the
              shallower depths with -0.0 leaves, at F = 968 and 2,000 in
              both x modes, and over 40,000 features (past the narrow
              record, so the 8-byte one);
  4. path     the in-database query on a HIGGS-shaped table (11,000,000 x
              28 rows from a seed, on the device tier):
              infer(plan="udf", algorithm="predicated_pallas_fused") twice
              (the second must hit the plan cache), launches counted,
              predictions held against the eager "predicated" algorithm;
              then the HummingBird and QuickScorer kernels over 1,000,000
              rows of the same table;
  5. timing   each fused kernel at the shapes the path gave it (CUDA events
              over warmed-up repeats) beside its bound and its plain
              version; then bf16 tree tiles: predict_sum_pallas(...,
              tree_dtype=torch.bfloat16) for each fused kernel at those
              shapes and at Epsilon's 100,352 x 2,000 (wide-row), counted,
              bit for bit the f32 path over the bf16-rounded forest, and
              each bf16 kernel timed beside the f32 one;
  6. rel      the relation-centric plans at the large-model shape (1600
              depth-8 trees): infer(plan="rel+reuse",
              algorithm="predicated_pallas") twice over the 11M-row table
              (the repeat hits the model and the plan cache), plan="rel"
              once, infer_rows at 8/32/128 rows (udf with the fused kernel,
              rel+reuse with the raw one, each called twice), the
              HummingBird and QuickScorer raw kernels through rel+reuse on
              the 1M-row cut (twice each: the repeat is the query time),
              and udf with predicated_pallas (one raw launch over all 1600
              trees) on that cut.  Every query counts its own launches
              (raw = n_parts x scan batches, no other kernel) and holds its
              first rows against the eager oracle;
  7. timing   each raw kernel at one rel launch's shape (16 trees);
  8. tiers    the same 11M-row table off the card: a store with a 256 MiB
              device budget (the auto cascade puts it on the pinned host
              tier) and one with 256 MiB host and device budgets (disk
              tier, mmap page files in a temporary spill directory deleted
              at the end).  udf "predicated_pallas_fused" at 500 trees
              over both, at prefetch depths 2 and 1, and rel+reuse
              "predicated_pallas" at 1600 trees twice over the host tier,
              each bit-identical to the device tier at the same batch
              (10 batches of 1,170 pages), with exact launch counts; the
              scan's telemetry, the overlap fraction, the link rate of one
              pinned 128 MiB H2D copy and the scan's bound; a
              torch.profiler trace of one host-tier query, before any
              disk-tier scan (device busy share, the device's wait before
              and between the kernels, H2D overlapping the kernel, flagged
              when it misses page copies); then phases 8b and 8c; a move round
              trip device -> host -> disk -> device on the 1M-row cut;
 8b. obs      the observability plane (repro_torch.obs) over phase 8's
              tables, the only phase with TRACER enabled: a traced udf
              "predicated_pallas_fused" query on the host and the disk
              tier (span counts = ScanStats.batches, scan.disk_read one a
              batch on disk, every scan.drain_write a device span on the
              cuda:drain track under its scan.batch and inside
              scan.execute, the stage spans' device_s summing to the
              StageReport seconds, the counter deltas = ScanStats; the
              stage turnaround and the drain's overlap with scan.compute
              printed), each trace exported to chiprun_out/obs_<tier>.json
              and validated; the 1600-tree rel+reuse query on the device
              tier traced twice (the repeat's trace shows the plan-cache
              hit); a traced infer_rows at 8 rows; traced / untraced
              walls, medians of interleaved pairs, for the device-tier udf
              query (fails past 1.05), the host-tier one and infer_rows
              at 8 rows; a disabled tracer records nothing;
 8c. faults   the fault plane (repro_torch.db.faults) over phase 8's
              tables, each run held bit for bit against the unfaulted
              result on its tier, with its ScanStats fault fields, its
              injector's calls per site and its launches checked: one
              transient fault (each site's 2nd call) at disk_page_read on
              the disk tier, at page_dma_in, kernel_launch,
              drain_copy_out and drain_worker (degraded to the
              synchronous drain, a longer drain_wait_s) on the host tier
              and at kernel_launch under the 1600-tree rel+reuse query;
              the page_dma_in halving ladder (11 batches) and the
              disk_page_read re-enqueue ladder; kernel_launch and
              drain_copy_out exhausted (ScanFault, its rows_completed,
              then a clean query on the same store); deadlines: half the
              host query's wall (a partial in whole batches, scored rows
              bit-identical, the rest NaN), 0 on the device and host
              tiers (all NaN, no launch) and 3600 (not degraded); a move
              off disk rolled back on an exhausted disk_page_read and
              then retried; a transient page_dma_in in load_csv_external
              over 100,000 HIGGS rows written as CSV; an armed but
              silent injector against none, medians of interleaved pairs
              (the device-tier udf query fails past 1.05);
  9. sparse   wide rows and the CSR plane.  x modes: each kernel, fused
              (500 trees) and raw (16), staged and wide-row, on 65,536
              rows at widths from 28 to 10,000, beside its bound, and each
              kernel's crossover.  Epsilon (100,000 x 2,000 dense, device
              tier): udf with the three fused kernels, rel+reuse with
              predicated_pallas twice (the repeat hits both caches) and
              with the raw HummingBird and QuickScorer kernels, each held
              against the eager oracle; the wide-row kernels timed at that
              shape, each line with its design (the wide-tiled kernels'
              tiles and the transpose's share of their ms), and the
              transpose beside its plain version and x.t().contiguous().
              Bosch (1,184,000 x 968, 81 % missing) dense and as
              CSR on the device tier, both on the pinned host tier (256 MiB
              device budget) and the CSR copy on the disk tier: udf with
              the fused predicated and HummingBird kernels, rel+reuse
              predicated_pallas twice, each CSR result bit for bit the
              device tier's dense one, with a trace of each host-tier udf
              scan.  Criteo-shaped (2,000,000 x 10,000, 96 % missing, CSR
              made on the card in 64-page chunks, 6.4 GB on the device
              tier): udf with the fused predicated and HummingBird kernels
              at 64 pages a batch, the gather's share of the stage time,
              and both held bit for bit against the dense plane over the
              first 65,536 rows, densified on the card.
 10. load     the paper's external load against in-database inference.
              HIGGS 1,000,000 x 28 written as CSV, load_csv_external, then
              the fused predicated kernel + postprocess over the loaded
              rows at 10 and 500 depth-8 trees, against infer(plan="udf")
              over the same rows put on the device tier: both stage
              breakdowns, the ratio, predictions bit-identical.  A
              Criteo-shaped LIBSVM file (20,000 x 10,000 at 96 % missing)
              loaded by load_libsvm_csr_external onto the device, host and
              disk tiers and put_sparse(pages=) zero-copy, udf predicated
              and HummingBird over each, bit for bit put_sparse(data=) of
              the same rows; the dense fallback load_libsvm_external beside
              it.  Epsilon 10,000 x 2,000 as array rows through
              load_array_rows_external and udf predicated (wide-row).
              Writing the files is untimed set-up; they go to a temporary
              directory deleted at the end.
 11. serve    the forest serving plane (repro_torch.serve) over request
              rows from the HIGGS table's head: four tenants in one
              ForestServeEngine, each warmed over the ladder 8 / 32 / 128
              at registration: udf-pred (predicated_pallas_fused, 500
              integer-leaf trees), udf-hb (hummingbird_pallas_fused,
              phase 4's forest), udf-qs (quickscorer_pallas_fused, 500
              integer-leaf trees), udf, and rel (predicated_pallas, the
              1600-tree forest, rel+reuse in 100 partitions).  A
              correctness pass (200 requests of 1-4 rows a tenant,
              submit + drain: each tick bit for bit infer_rows over its
              padded bucket, bit for bit or within TOL of the eager
              oracle, 1 fused or 100 raw launches a tick and no other
              kernel); open-loop single-row interactive traffic with the
              ticker running on udf-pred and rel at 200, 800, 3,000 and
              20,000 req/s for 1 s each (latency from the scheduled
              arrival, queue wait, coalesce width, ticks, padding, shed,
              served in the window, kernel busy share under a CUDA-only
              profiler; no plan miss, every request served, launches =
              ticks x launches a tick); a traced window (serve.tick spans
              = ticks, no plan.build); the per-request baseline
              (store.put of one row, infer, read-back) at 200, 800 and
              3,000 req/s, at most 1,000 requests, beside the coalesced
              p50; tenancy (max_plans 3: a fourth tenant evicts the
              first, whose next request misses and re-serves bit for
              bit); shedding (a timeout below the interactive deadline:
              shed, counted, served after the batch deadline).
 12. optimizer the cost-based optimizer (repro_torch.db.optimizer): the
              card's calibrated peaks (every key positive, the H2D source
              pinned; its rate beside phase 8's plain pinned copy); a regret
              grid over the paper's quadrants at the HIGGS width, 10 and
              1,600 depth-8 trees x 16,384 and 1,000,448 rows on the device
              tier: all 12 static cells (the six kernels x udf /
              rel+reuse, min of 3 warm walls each) and then
              infer(plan="auto", algorithm="auto") on a fresh engine, its
              first call and 3 repeats (no autotune re-run, 3 catalog hits,
              only the decided cell's kernel launched, bit for bit its
              static run), printing the decision, regret_vs_best,
              win_vs_worst and each cell's predicted_s beside its static
              wall; tier advice on 1,000,448 rows put on the host tier
              under a 256 MiB device budget (500 integer-leaf regression
              trees: advice "device", the query on the host tier, the
              hillclimbed batch), then auto_move=True (moved, a second
              decision, bit for bit the host-tier run); a ForestServeEngine
              tenant registered with "auto" (a #rows decision at B = 128,
              the other tenant's plan misses after it reported) under 400
              open-loop single-row requests at 800 req/s (no plan miss,
              only the decided kernel, every request bit for bit
              infer_rows of the decided cell; p50 / p99).
 13. train    in-database training (repro_torch.db.train) at HIGGS's width
              on 1,000,448 rows (cut from 11M: the histograms run on the
              host) with 10 % missing and labels from a seeded linear rule,
              depth 8, 64 bins: XGBoost classification, 4 trees, streamed
              through engine.train on the pinned host tier (256 MiB device
              budget, batches of 100 pages), bit for bit train_forest run
              resident on the card with the same edges; LightGBM (GOSS) and
              RandomForest (colsample 0.5), 2 trees each, streamed on the
              device tier, each bit for bit its resident run; the XGBoost
              forest from the model catalog scored by infer(plan="udf",
              algorithm="predicated_pallas_fused"): one fused launch, within
              TOL of the eager "predicated", training-set accuracy above
              0.6; ForestRouter() trained and routing 1,000 rows on the card
              (bit for bit the CPU router's forest).  Prints each pass's
              wall, per level the routing stage's device time beside the
              host histogram time, rows x trees / s, the bins relation's
              bytes and tier, one level scan's ScanStats, and one level's
              host histogram over the whole bins relation in one np.add.at
              call against row chunks of 102,400 (a host-tier batch),
              32,768, HIST_CHUNK_ROWS and 2,048 (bit for bit).
 14. mesh     multi-device forest inference (repro_torch.dist.sharding) on
              a (data 2, model 4) mesh of eight explicit cuda:0 positions
              (one card: the mesh's semantics, not scaling): the 11M-row
              table put once on a mesh store (the allocation grows by one
              padded copy), udf predicated_pallas_fused at 500 trees twice
              (2 launches a batch, the repeat hits the plan cache), bit for
              bit phase 4's mesh-less udf; rel+reuse at 1600 trees with the
              fused predicated kernel twice (8 launches a batch, the repeat
              hits both caches), bit for bit the mesh-less rel+reuse at
              n_parts = 4; rel with fused HummingBird and QuickScorer and
              raw predicated on the 1,000,448-row cut, each bit for bit
              its mesh-less n_parts = 4 run; infer_rows at 8 / 32 / 128
              rows (udf and rel+reuse); one host-tier scan in batches of
              100 pages, bit for bit the mesh's device tier; one CSR scan
              (65,536 rows), bit for bit the mesh-less CSR scan; one
              transient kernel_launch fault, recovered bit for bit; one
              XGBoost tree (depth 6) trained on the mesh over the 1M cut,
              bit for bit the mesh-less tree.  Prints every wall beside its
              mesh-less wall and their ratio.
 15. lm       the LM serving path (repro_torch.models, serve/engine.py,
              launch/serve.py) on olmo-1b at full width (16 layers, d_model
              2,048, 16 heads x 128, SwiGLU d_ff 8,192, non-parametric LN,
              tied embeddings over 50,432 padded ids; random weights drawn
              on the card from SEED).  In f32 with TF32 off: a 4 x 96
              prefill, 4 teacher-forced decode steps each within
              rtol = atol = 1e-3 of lm_prefill over the same prefix, and 4
              requests through a 2-slot ServeEngine, token for token the
              single-request greedy loop up to that loop's first near-tie
              (top-two logits within 1e-3).  In bf16 (the engine's default
              caches): ServeEngine(slots=8, max_ctx=1024, buckets 128 / 256
              / 512) serving 16 requests (prompts of 32-500 tokens, 32-128
              new tokens, from a seed) routed by the forest router on the
              card; prints stats(), prefill ms a bucket, decode tick ms
              p50 / p99 beside its byte bound (weights + the whole KV cache
              once a tick), tokens/s, peak memory and a profile of decode
              ticks (device busy share, kernels a tick).  Then the CLI
              (launch/serve.main) at the reduced config on the card.
 16. lm-families  the SSD, hybrid and MoE serving paths, one block a
              model, each freed before the next: mamba2-2.7b (64 SSD
              layers) and zamba2-2.7b (54 SSD layers, 9 shared-attention
              call sites with LoRA) at full width, uncut, and
              llama4-scout-17b-a16e at full width (d_model 5,120, 16
              experts, vocab 202,048) cut to 8 layers for bf16 serving and
              4 (one iRoPE period) for the f32 checks, so that both fit the
              card.  Each tree's parameter count equals the reference's.
              In f32 with TF32 off: a 2 x 300 prefill (two SSD chunks, a
              padded tail), 3 teacher-forced decode steps each within
              rtol = atol = 1e-3 of lm_prefill over the same prefix
              (llama4 at capacity_factor = 16, so that no token drops),
              and 3 requests through a 2-slot ServeEngine, token for token
              the single-request loop up to its first near-tie.  In bf16:
              ServeEngine(slots=8, max_ctx=1024, buckets 128 / 256 / 512)
              serving 8 requests (prompts of 32-500 tokens, 16-64 new
              tokens, from a seed); prints stats(), prefill ms a bucket,
              decode tick p50 / p99 beside its byte bound (weights + the
              whole cache once a tick), tokens/s, peak memory, a profile of
              5 decode ticks (device busy share, kernels a tick), and for
              llama4 the bytes the decode's per-token expert-weight
              gathers copy a tick.
 17. lm-train  the LM training path (the loss with remat and the chunked
              cross-entropy, the optimizers, train/trainer.py, checkpoints,
              TrainLoop, launch/train.py) and the enc-dec model.  (a) In
              f32 with TF32 off, every config at reduced(): one AdamW
              make_train_step step on the card from a state_from_arrays
              state, loss, gnorm, every parameter and mu within 1e-4 of
              the same step on the CPU; reduced olmo's 2 microbatches
              within 2e-5 of one batch.  (b) Reduced olmo through
              TrainLoop (checkpoints every 5 steps in a temporary
              directory, a failure injected at step 7, a restore, the rest
              of 12 steps): bit for bit an uninterrupted run on the card;
              then launch/train.main with --ckpt-dir and --resume.
              (c) chunked_xent over olmo-1b's 50,432 padded ids and 512
              tokens against a dense log-softmax loss (loss within 1e-5
              relative, the gradients of h and w within 1e-4).
              (d) seamless-m4t-large-v2 at full width (24 + 24 layers,
              d_model 1,024, vocab 256,256 padded, untied), f32: 8
              token-by-token decode steps on 2 x 1,024 frames within 1e-3
              of encdec_prefill over each prefix, and the copied
              prefill-then-decode defect.  (e) bf16 training at full
              width, AdamW, the configs' remat ("full"), deterministic
              steps: olmo-1b on 8 x 1,024 tokens and seamless on 8 x 1,024
              frames + 8 x 256 decoder tokens (batch_for), 10 steps each
              through TrainLoop, each model freed before the next: losses
              and gnorm (finite at every step), step wall p50 / p99
              without step 0, training tokens/s, model FLOPs a step over
              the wall against the 989.4 TFLOP/s dense bf16 peak, peak
              memory, a 2-step profile (busy share, kernels a step, the
              top 8 kernels) and the step without deterministic mode.
 18. lm-mesh  the LM on a mesh of positions, all on cuda:0 (dist/sharding
              make_plan / param_specs / tree_named, the constraint checks
              of models/layers.shard, expert parallelism, the train step's
              cross-pod compression, restore_checkpoint(mesh=)).  (a) In
              f32 with TF32 off, every config at reduced(): one AdamW
              jit_train_step step with grad_compress on (pod 2, data 2,
              model 2), the card's against the same step on CPU positions
              from the same state: loss and gnorm within 1e-4, every
              parameter within 1e-4 where the card's and the CPU's int8
              gradient levels agree, the elements whose level differs at
              most 1e-3 of the tree (both counted).  (b) llama4-scout at
              full width on (data 1, model 4), phase 16's cut: in f32 at 4
              layers, the EP prefill (per-block dispatch, the all_to_all's
              order) at capacity_factor 16 (no block drops) and 3 EP
              decode steps (each position's masked products over its 4
              local experts, summed in model order) within 1e-3 of the
              mesh-less paths; at the config's capacity the tokens kept
              equal the sum over blocks and experts of min(routed,
              cap_src); then bf16 serving of phase 16's script at 8 layers
              through ServeEngine on the mesh plan beside its mesh-less
              twin: tokens/s, decode tick p50 / p99, kernels a tick, busy
              share, the expert-weight bytes a tick reads, each mesh /
              twin.  (c) olmo-1b at full width (8 x 1,024, bf16, AdamW,
              full remat, deterministic) on (2, 2, 2) with grad_compress:
              step 1's loss bit for bit the mesh-less twin's and every new
              parameter bit for bit the twin's update over its
              int8-round-tripped gradients; the step-1 state saved,
              restored with restore_checkpoint(mesh=) and stepped, bit for
              bit the unrestored loop; 4 timed steps a side (p50 mesh /
              twin, peak memory).
 19. dryrun   the dry-run tools (launch/hlo_cost.analyze, dryrun,
              hillclimb).  (a) Phase 18 (c)'s olmo-1b step, counted once
              on cuda:0 positions and once on meta: FLOPs and the
              collective record equal, and every aten op's count and
              bytes equal or the difference explained in DRY_DEVICE_OPS;
              timed steps (wall p50), a profile (device time and kernels
              a step), the H100 roofline terms and the count's bound as a
              share of the device time (raising past 1), the counted peak
              of live bytes beside max_memory_allocated.  (b) llama4-scout
              at phase 16's cut (8 layers, 8 slots x 1,024 positions,
              bf16): one decode call of the EP path on (data 1, model 4)
              and of the mesh-less gather, each counted on the card and
              on meta (the psum's bytes included) and profiled; each
              memory bound against its device time and the two ranked.
              (c) The CLIs on meta at production shapes: olmo-1b's four
              shapes on both meshes, every status ok or skipped, and the
              hillclimb example (llama4-scout decode_32k, moe_decode_ep
              true and false) under the H100 table.  (d), run after phase
              21 whose measurements it reads: phase 21 (a)'s own-shards
              olmo-1b step and phase 20 (a)'s own-shards decode call,
              built by launch/dryrun.build_cell(own_shards=True), each
              counted once on cuda:0 positions and once on meta: equal op
              for op (DRY_DEVICE_OPS' rule), the collective records equal
              kind for kind, and on the card moved_bytes() across the
              counted call equal to the records' received_bytes; the
              count's H100 terms beside the measured step and tick.
 20. lm-spmd  LM serving over positions that own their shards, all on
              cuda:0 (models/positions.py): (a) olmo-1b, (b) llama4-scout
              (EP), (c) qwen2-7b (cp), (d) distinct cards when there are
              two, (e) mamba2-2.7b and (f) zamba2-2.7b cut to
              LMS_FAM_LAYERS, (g) seamless-m4t-large-v2: f32 against the
              held-once path, both engines' tokens up to a near-tie, tick
              p50 / p99, kernels a tick, bytes moved (the constants'
              comment says each part's gates).
 21. lm-spmd-train  LM training over positions that own their shards,
              all on cuda:0 (train/trainer.py, dist/collectives' transposes,
              the optimizers over pieces, checkpoints as pieces): (a)
              olmo-1b at full width, an f32 AdamW step at 4 layers against
              the held-once step (loss, gnorm, each leaf's update), then
              bf16 steps at full depth beside the held-once step: p50 /
              p99, kernels a step, busy share, bytes moved a step, peak
              memory, each position's resident state; (b) qwen2 (cp),
              llama4-scout (EP, Adafactor), mamba2, zamba2 and seamless at
              reduced() as (a)'s check; (c) the int8 round trip bit for
              bit that of the gathered gradients; (d) TrainLoop's failure,
              restore as pieces and continuation bit for bit, the save
              restored onto (2, 2, 2) as pieces and held once.
The last lines are the kernels' JSON record (each kernel twice: staged x,
timed at the HIGGS shapes, and ``<name>_wide``, timed at the Epsilon
shape; each fused kernel a third time as ``<name>_bf16``, over bf16 tree
tiles at the HIGGS shapes; and ``feature_major_wide``, the transpose
before each wide-tiled launch, timed at the Epsilon shape beside
``x.t().contiguous()``), the nvidia-smi line, and {"ok": true,
"device": {...}}.  A wide-tiled call over more than XT_CHUNK_BYTES of x
launches its kernel and the transpose once a chunk, and counts each.

It imports nothing of the JAX package.  The forests' weights and the tables
are random, made from SEED on the card, at the published shapes (depth-8
XGBoost trees, 500 and 1600 for the rel plans; HIGGS's 28 features,
Epsilon's 2,000, Bosch's 968, Criteo's 10,000 of DATASETS).
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEPTH, TREES, FEATURES = 8, 500, 28
REL_TREES = 1600                # the large-model regime of the rel plans
HIGGS_ROWS = 11_000_000
CUT_ROWS = 1_000_000            # HummingBird / QuickScorer path rows
CHECK_ROWS = 16_421             # phase 3 kernel-vs-plain rows (ragged)
#: phase 3 depths beside DEPTH; QuickScorer adds 6, where its top node
#: first clears a whole word
SHALLOW = dict(predicated=(1, 3, 5), hummingbird=(1, 3, 5),
               quickscorer=(1, 3, 5, 6))
#: phase 3's wide-row checks (all but Bosch's 968 also at SHALLOW depths)
WIDE_CHECK_F = (968, 1185, 2000, 4096, 10000)
COMPARE_ROWS = 65_536           # path rows held against the oracle
ROW_BATCHES = (8, 32, 128)      # the serving plane's bucket ladder
TOL = 1e-6                      # rtol = atol for float sums (order differs)
TIER_BUDGET = 256 << 20         # phase 8's device (and host) budget
LINK_BYTES = 128 << 20          # phase 8's plain pinned H2D copy
MOVE_BATCH_PAGES = 100          # phase 8's move round trip, 1M-row cut
PROFILE_H2D_SHARE = 0.75        # least H2D time of a complete phase 8
#                                 trace, as a share of bytes / link rate
#: phase 9: the x-mode timings' widths and rows (65,536 rows: 500 trees
#: fused, one 16-tree partition raw)
XMODE_F = (28, 200, 400, 512, 640, 768, 968, 1184, 1536, 2000, 10000)
XMODE_ROWS = 65_536
#: phase 9's tables, at the datasets' shapes (src/repro/db/loader.py:
#: DATASETS): Epsilon dense at its full 100,000 x 2,000; Bosch at its full
#: 1,184,000 x 968 with 81 % missing; Criteo-shaped 10,000 features at 96 %
#: missing, cut from 51M to 2M rows
EPSILON_ROWS, EPSILON_F = 100_000, 2000
BOSCH_ROWS, BOSCH_F, BOSCH_MISSING = 1_184_000, 968, 0.81
CRITEO_ROWS, CRITEO_F, CRITEO_MISSING = 2_000_000, 10_000, 0.96
CRITEO_BATCH_PAGES = 64         # pages of 1,024 rows a scan batch
#: phase 3's bf16 checks: the wide-row widths, and a width past the narrow
#: record's 32,768 features
BF16_WIDE_F = (968, 2000)
BF16_PAST_NARROW_F = 40_000
#: phase 10's tables, cut to fit the phase's ~90 s beside the text parse
#: (HIGGS from 11M rows, Criteo-shaped from 51M, Epsilon from 100,000)
LOAD_HIGGS_ROWS = 1_000_000
LOAD_TREES = (10, 500)          # the paper's small- and large-model ends
LOAD_CRITEO_ROWS = 20_000
LOAD_CRITEO_BATCH_PAGES = 4
LOAD_EPSILON_ROWS = 10_000
FAULT_LOAD_ROWS = 100_000       # phase 8c's CSV (phase 10 writes its own)
#: phase 11, the serving plane: request rows (the HIGGS table's head), the
#: correctness pass's requests a tenant, the open-loop rates (the
#: reference's RATES_HZ, benchmarks/bench_serve.py:65, and one past the
#: coalescer's saturation), each rate's window, the baseline's cap a rate
SERVE_ROWS = 65_536
SERVE_CHECK_REQUESTS = 200
SERVE_RATES_HZ = (200, 800, 3000, 20000)
SERVE_WINDOW_S = 1.0
SERVE_BASELINE_MAX = 1000
OPT_TREES = (10, 1600)          # phase 12's regret grid: the paper's
OPT_ROWS = (16_384, 1_000_448)  # small / large model x data quadrants
OPT_STATIC_RUNS = 3             # warm walls a static cell (min taken)
OPT_AUTO_REPEATS = 3
OPT_REGRET = 1.25               # the reference's regret bar (reported)
ADVICE_ROWS, ADVICE_TREES = 1_000_448, 500
OPT_SERVE_REQUESTS, OPT_SERVE_RATE_HZ = 400, 800
#: phase 13, in-database training: HIGGS's width at a 1,000,448-row cut of
#: its 11M rows (the histograms are host float64 np.add.at, ~0.45 s a level
#: at this cut), 10 % missing, labels from a seeded linear rule; depth 8,
#: 64 bins; trees a family (streamed, then resident)
TRAIN_ROWS, TRAIN_MISSING = 1_000_448, 0.1
TRAIN_DEPTH, TRAIN_BINS = 8, 64
TRAIN_TREES = dict(xgboost=4, lightgbm=2, randomforest=2)
TRAIN_BATCH_PAGES = 100         # the host-tier scans' batch (10 a scan)
TRAIN_ACCURACY = 0.6            # training-set accuracy gate (XGBoost)
ROUTER_ROWS = 1000
PEAK_KEYS = ("peak_flops_bf16", "hbm_bandwidth", "ici_bandwidth",
             "gather_bandwidth", "h2d_bandwidth", "dispatch_s")
PAGE_ROWS = 1024                # the store's default page
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
SCALAR_OPS_PER_S = 67e12        # f32 outside the tensor cores
#: phase 14, the mesh: (data, model) positions, all on cuda:0; the host
#: tier's batch; the CSR cut; the trained tree's depth
MESH_DATA, MESH_MODEL = 2, 4
MESH_HOST_BATCH_PAGES = 100
MESH_CSR_ROWS = 65_536
MESH_TRAIN_DEPTH = 6
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate
#: phase 15, the LM serving path: olmo-1b at full width with random
#: weights from SEED; the f32 checks (a prefill, teacher-forced decode steps
#: within LM_TOL, an engine of 2 slots against the single-request loop up
#: to the loop's first near-tie); the bf16 serving run (the engine's
#: default cache dtype) at its slots, context and prompt buckets
LM_ARCH = "olmo-1b"
LM_CHECK_BATCH, LM_CHECK_LEN, LM_CHECK_STEPS = 4, 96, 4
LM_TOL = 1e-3
LM_TIE_GAP = 1e-3
LM_CHECK_REQUESTS, LM_CHECK_NEW = 4, 12
LM_SLOTS, LM_MAX_CTX, LM_BUCKETS = 8, 1024, (128, 256, 512)
LM_REQUESTS = 16
LM_PROMPT_LEN, LM_NEW_TOKENS = (32, 500), (32, 128)
LM_PROFILE_TICKS = 5
#: phase 16, the SSD / hybrid / MoE serving paths: the three models and,
#: for one cut in depth, its (bf16 serving, f32 checks) layers; an arch not
#: listed runs uncut
LMF_ARCHS = ("mamba2-2.7b", "zamba2-2.7b", "llama4-scout-17b-a16e")
LMF_LAYERS = {"llama4-scout-17b-a16e": (8, 4)}
LMF_CHECK_BATCH, LMF_CHECK_LEN, LMF_CHECK_STEPS = 2, 300, 3
LMF_CHECK_REQUESTS, LMF_CHECK_NEW = 3, 8
LMF_REQUESTS = 8
LMF_PROMPT_LEN, LMF_NEW_TOKENS = (32, 500), (16, 64)
#: phases 15-16: the reference's init_lm tree at each depth run (leaves'
#: sizes summed over jax.eval_shape of repro.models.get_bundle(cfg).init
#: on the CPU)
LM_TREE_PARAMS = {("olmo-1b", 16): 1_177_026_560,
                  ("seamless-m4t-large-v2", 24): 1_632_358_400,
                  ("mamba2-2.7b", 64): 2_832_074_240,
                  ("zamba2-2.7b", 54): 2_451_183_520,
                  ("llama4-scout-17b-a16e", 8): 19_687_758_848,
                  ("llama4-scout-17b-a16e", 4): 10_879_350_784}

#: phase 17, LM training: (a) one AdamW step of each config at reduced()
#: on the card against the CPU, in f32, with phase 18's optimizer LMM_OPT
#: (lr 1e-2 from step 0: a first update of ~1e-2 an element): loss, gnorm
#: and mu (0.1 x the clipped gradients) within LMT_TOL, each leaf's update
#: new - old within LMM_UPDATE_RTOL of the CPU's largest update of that
#: leaf wherever the CPU's gradient is 0 or at least LMT_G_FLOOR in size
#: (the first update lr g / (|g| + eps) moves by at most lr eps / g^2 = 100
#: a unit of gradient error there; under it, a rounding-sized gradient
#: error moves the update past the limit), those under it at most
#: LMT_SMALL_G_SHARE of a tree (6.4 % in reduced llama4-scout's, the most);
#: microbatches within the reference test's 2e-5; (b) TrainLoop's failure,
#: restore and continuation at reduced olmo, bit for bit; (c) chunked_xent
#: over olmo's vocabulary against a dense loss; (d) enc-dec decode at full
#: width within LM_TOL of prefill; (e) bf16 training at full width
LMT_TOL = 1e-4
LMT_G_FLOOR = 1e-6
LMT_SMALL_G_SHARE = 0.1
LMT_MICRO_TOL = 2e-5
LMT_CHECK_BATCH, LMT_CHECK_SEQ = 4, 64
LMT_LOOP_STEPS, LMT_LOOP_CKPT, LMT_LOOP_FAIL = 12, 5, 7
LMT_XENT_TOKENS = 512
LMT_XENT_LOSS_RTOL, LMT_XENT_GRAD_TOL = 1e-5, 1e-4
LMT_ED_BATCH, LMT_ED_FRAMES, LMT_ED_CTX, LMT_ED_STEPS = 2, 1024, 64, 8
LMT_ARCHS = ("olmo-1b", "seamless-m4t-large-v2")
LMT_BATCH, LMT_SEQ, LMT_STEPS = 8, 1024, 10
LMT_PROFILE_STEPS, LMT_LOOSE_STEPS = 2, 4
BF16_TENSOR_FLOPS = 989.4e12     # H100 SXM dense bf16 tensor-core peak
#: phase 18, the LM on a mesh of positions, all on cuda:0: (a) one f32
#: AdamW step of each config at reduced() on (pod 2, data 2, model 2) with
#: grad_compress, held against the port's CPU step on the same positions:
#: the loss within LMT_TOL, gnorm within LMM_GNORM_RTOL relative and
#: within 1 / LMM_MISS_GNORM of the card's uncompressed step's gap from
#: the CPU's (yi-34b's gap is 4.6e-6 relative, under that limit), each leaf's
#: update new - old within LMM_UPDATE_RTOL of the CPU's largest update of
#: that leaf wherever the card's and the CPU's int8 gradient levels agree,
#: the elements where they differ at most LMM_FLIP_SHARE of a tree; the
#: optimizer LMM_OPT (lr 1e-2 from step 0: a first update of ~1e-2 an
#: element, 1,000 x that limit), and the card's step without compression
#: must miss the update limit by LMM_MISS x; (b) llama4-scout at full width
#: (phase 16's cut) on (data 1, model 4); (c) olmo-1b at full width on the
#: (2, 2, 2) mesh, LMM_STEPS timed steps a side and LMM_RT_REPS timed int8
#: round trips of its gradients
LMM_TRAIN_MESH = (("pod", 2), ("data", 2), ("model", 2))
LMM_SERVE_MESH = (("data", 1), ("model", 4))
LMM_FLIP_SHARE = 1e-3
LMM_OPT = dict(lr=1e-2, warmup_steps=1)
LMM_UPDATE_RTOL = 1e-3
LMM_GNORM_RTOL = 1e-5
LMM_MISS = 100.0
LMM_MISS_GNORM = 4.0
LMM_RT_REPS = 5
LMM_ARCH_EP = "llama4-scout-17b-a16e"
LMM_STEPS = 4

#: phase 19, the dry-run tools (launch/hlo_cost, dryrun, hillclimb) on the
#: card: (a) phase 18 (c)'s olmo-1b step counted on the card and on meta,
#: DRY_STEPS timed steps and DRY_PROFILE_STEPS profiled; (b) one decode
#: call of llama4-scout at phase 16's cut, EP on LMM_SERVE_MESH and the
#: mesh-less gather, counted on both, DRY_TICKS profiled calls a side; (c)
#: the CLIs on meta at production shapes: DRY_CLI_ARCH's cells on both
#: meshes and DRY_HILLCLIMB's.  DRY_DEVICE_OPS lists the aten ops whose
#: count or bytes the card and meta may differ by, with why (an unlisted
#: difference fails the phase); none has been found on an H100
DRY_STEPS, DRY_PROFILE_STEPS, DRY_TICKS = 3, 2, 5
DRY_DEVICE_OPS: dict[str, str] = {}
DRY_CLI_ARCH = "olmo-1b"
DRY_HILLCLIMB = ("llama4-scout-17b-a16e", "decode_32k")
#: phase 19 (d): phase 21 (a)'s step (LMT_BATCH x LMT_SEQ on LMP_MESH) and
#: phase 20 (a)'s decode call (LM_SLOTS x LM_MAX_CTX on LMS_MESH_A), both
#: olmo-1b bf16 at full width over own shards; DRY_SPMD_MEASURED holds
#: what phases 20 (a) and 21 (a) measured of them ("decode", "train")
DRY_SPMD_ARCH = "olmo-1b"
DRY_SPMD_MEASURED: dict[str, dict] = {}

#: phase 20, LM serving over positions that own their shards, every
#: position on cuda:0: (a) olmo-1b on LMS_MESH_A (tp): f32 prefill and
#: LMS_CHECK steps teacher-forced against the held-once path on the same
#: mesh, then LMS_REQUESTS bf16 requests through LM_SLOTS x LM_MAX_CTX on
#: both engines, tokens equal up to a near-tie (where a request parts,
#: the first argmax of the replays that differs, a route or the token,
#: has the held-once run's top two within LMS_TIE_GAP); (b) llama4-scout
#: on LMS_MESH_B (EP): one MoE layer's EP prefill (kept sets) and decode
#: in f32 against the held-once layer, LMS_LAYERS_B_F32 layers f32 as (a),
#: then phase 16's 8-layer cut served in bf16 on both engines, as (a);
#: (c) LMS_ARCH_C cut to LMS_LAYERS_C layers on LMS_MESH_C (cp),
#: f32 prefill and decode against held-once; (d) (a)'s f32 check on
#: distinct cards when the machine has two or more; (e) mamba2-2.7b
#: (``cp``: no attention heads) and (f) zamba2-2.7b (``tp``) at full width
#: cut to LMS_FAM_LAYERS on LMS_MESH_A: f32 as (a), then LMS_REQUESTS bf16
#: requests of LMS_FAM_PROMPT_LEN / LMS_FAM_NEW_TOKENS through both engines
#: as (a), prefill timed at LMS_FAM_TIMED only; (g) seamless-m4t-large-v2 at full
#: width on LMS_MESH_A: ``encdec_prefill`` of LMS_ED_CHECK[0] x
#: DECODE_MEMORY_FRAMES seeded frames and LMS_ED_CHECK[1] decoder tokens,
#: then LMS_ED_CHECK[2] decode steps, f32, against the held-once path
LMS_MESH_A = (("data", 2), ("model", 4))
LMS_MESH_B = (("data", 1), ("model", 4))
LMS_MESH_C = (("data", 2), ("model", 8))
LMS_ARCH_C, LMS_LAYERS_C = "qwen2-7b", 4
LMS_LAYERS_B_F32 = 4                   # one global NoPE layer, three local
LMS_CHECK = (2, 64, 4)                 # batch, prefix, decode steps
LMS_MOE_TOKENS = (2, 256)              # the MoE layer's [B, S]
LMS_REQUESTS, LMS_PROMPT_LEN, LMS_NEW_TOKENS = 8, (32, 200), (8, 24)
LMS_TIE_GAP = 0.125
LMS_FAMILIES = ("mamba2-2.7b", "zamba2-2.7b")
LMS_FAM_PROMPT_LEN, LMS_FAM_NEW_TOKENS = (32, 120), (4, 8)
LMS_FAM_TIMED = (128,)                 # the buckets whose prefill is timed
LMS_ED_CHECK = (2, 64, 4)              # batch, decoder prefix, decode steps
LMS_F32_REQUESTS, LMS_F32_NEW = 2, 4   # (e) / (f)'s f32 engines
#: (e) / (f)'s depth: mamba2-2.7b's 64 layers and zamba2-2.7b's 54 cut to
#: these (zamba2's 6 keep one shared block), to make room for phases 21
#: and 19 (d)
LMS_FAM_LAYERS = {"mamba2-2.7b": 4, "zamba2-2.7b": 6}

#: phase 21, LM training over positions that own their shards, every
#: position on cuda:0: (a) olmo-1b at full width on LMP_MESH: one f32
#: AdamW step (LMM_OPT) cut to LMP_F32_LAYERS layers, own shards against
#: the held-once step on the same mesh from the same state, on
#: LMT_CHECK_BATCH x LMT_CHECK_SEQ tokens (loss, gnorm and each leaf's
#: gradient within LMP_RTOL relative, a gradient of its leaf's largest;
#: each leaf's update within LMM_UPDATE_RTOL of its largest update of the
#: held-once optimizer fed the own-shards gradients: ``lmp_update_check``
#: says why), then the bf16 step at full depth on LMT_BATCH x
#: LMT_SEQ tokens, LMP_STEPS steps timed a side (own shards, then held
#: once), the first steps' losses within LMP_BF16_RTOL; (b) each of
#: LMP_FAMILIES at reduced() on LMP_MESH, one f32 step checked as (a)'s
#: with its optimizer; (c) reduced olmo's gradients on LMM_TRAIN_MESH:
#: the int8 round trip of the own-shards gradients bit for bit
#: compress_grads_crosspod of the gathered ones; (d) TrainLoop over own
#: shards at reduced olmo (phase 17's LMT_LOOP_*), deterministic, a
#: failure, a restore as pieces and the continuation bit for bit the
#: uninterrupted run; its last save restored onto LMM_TRAIN_MESH as pieces
#: and held once, bit for bit
LMP_MESH = (("data", 2), ("model", 4))
LMP_F32_LAYERS = 4
LMP_RTOL = 1e-4
LMP_BF16_RTOL = 1e-2
LMP_STEPS = 4
LMP_FAMILIES = (("qwen2-7b", "adamw"), ("llama4-scout-17b-a16e", "adafactor"),
                ("mamba2-2.7b", "adamw"), ("zamba2-2.7b", "adamw"),
                ("seamless-m4t-large-v2", "adamw"))

KINDS = ("predicated", "hummingbird", "quickscorer")
SOURCES = {k: f"src/repro_torch/kernels/csrc/forest_{k}.cu" for k in KINDS}
REPLACES = {
    "predicated": "src/repro/kernels/forest_predicated.py:143",
    "hummingbird": "src/repro/kernels/forest_hummingbird.py:139",
    "quickscorer": "src/repro/kernels/forest_quickscorer.py:172",
}
RAW_REPLACES = {
    "predicated": "src/repro/kernels/forest_predicated.py:110",
    "hummingbird": "src/repro/kernels/forest_hummingbird.py:115",
    "quickscorer": "src/repro/kernels/forest_quickscorer.py:142",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fresh_engine(store):
    """A ``ForestQueryEngine`` over ``store`` with caches of its own: each
    phase's first-query checks and cold timings count from empty caches,
    where an engine built without caches shares the process-global ones
    (``core/reuse.global_caches``)."""
    from repro_torch.core.reuse import ModelReuseCache
    from repro_torch.db.query import ForestQueryEngine
    return ForestQueryEngine(store, reuse_cache=ModelReuseCache(),
                             plan_cache=ModelReuseCache())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_forest_arrays(rng, *, integer_leaves: bool, trees: int = TREES,
                       leaf_scale: float = 0.1, depth: int = DEPTH,
                       features: int = FEATURES):
    I, L = (1 << depth) - 1, 1 << depth
    feature = rng.integers(0, features, (trees, I)).astype(np.int32)
    threshold = rng.normal(size=(trees, I)).astype(np.float32)
    default_left = rng.random((trees, I)) < 0.5
    if integer_leaves:
        leaves = rng.integers(-8, 9, (trees, L)).astype(np.float32)
    else:
        leaves = (leaf_scale * rng.normal(size=(trees, L))).astype(
            np.float32)
    return feature, threshold, default_left, leaves


def card_rows(rows: int, features: int, *, seed: int, missing: float = 0.0,
              nan_every: int = 0) -> torch.Tensor:
    """[rows, features] f32 made on the card from ``seed``: normal values,
    each missing (NaN) with probability ``missing``, and every
    ``nan_every``-th row all NaN."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, features), generator=gen, device="cuda")
    if missing:
        x[torch.rand((rows, features), generator=gen, device="cuda")
          < missing] = float("nan")
    if nan_every:
        x[::nan_every] = float("nan")
    return x


def stage_sums(r) -> str:
    """A query's stage reports summed by stage name: "name n x total s"."""
    sums: dict[str, list] = {}
    for rep in r.stage_reports:
        entry = sums.setdefault(rep.name, [0, 0.0])
        entry[0] += 1
        entry[1] += rep.seconds
    return ", ".join(f"{name} {n} x {sec:.6f} s"
                     for name, (n, sec) in sums.items())


def pinned_bytes() -> str:
    """The pinned host allocator's bytes (current / peak), where this
    torch reports them."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return "pinned total not reported by this torch"
    st = stats()
    return (f"pinned allocator {st.get('allocated_bytes.current', 'n/a')} B "
            f"now, {st.get('allocated_bytes.peak', 'n/a')} B peak")


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, so that equality is bit for bit."""
    return t.contiguous().view(torch.int32)


def nan_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the entries that are not NaN in both (a
    copied NaN is no error; a NaN on one side only makes it NaN)."""
    both = got.isnan() & want.isnan()
    return float(torch.where(both, 0.0, (got - want).abs()).max())


def cuda_ms(fn, *, warmup: int, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, CUDA events, warmed up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plain_rows(plain, args, depth: int, rows: int) -> torch.Tensor:
    """A plain version over all rows of args[0], ``rows`` at a time (its
    per-row arithmetic does not depend on the chunking)."""
    x = args[0]
    return torch.cat([plain(x[lo:lo + rows], *args[1:], depth=depth)
                      for lo in range(0, x.shape[0], rows)])


def timed_plain(plain, args, depth: int) -> tuple[torch.Tensor, float]:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain_rows(plain, args, depth, rows=262_144)
    end.record()
    end.synchronize()
    return want, start.elapsed_time(end)


def bound(kind: str, B: int, F: int, T: int = TREES, *,
          raw: bool = False, record: int = 8) -> tuple[float, str, dict]:
    """Least time (ms) the card could take for one launch over B rows and
    T trees: the larger of bytes over HBM rate and operations over peak.
    Bytes: x read once, the trees (a ``record``-byte node record per node
    slot and a leaf of half that: 12 bytes a slot, 6 over bf16 tiles) and
    the structure tensors a kernel reads once, the output ([B], or [B, T]
    for a raw launch) written once."""
    from repro_torch.core.forest import qs_bitvectors

    I, L = (1 << DEPTH) - 1, 1 << DEPTH
    W = (L + 31) // 32
    nbytes = (4 * B * F + T * (record + record // 2) * L
              + 4 * B * (T if raw else 1))
    pairs = B * T
    add = 0 if raw else 1         # the fused kernels add each pair's leaf
    if kind == "predicated":      # depth compares (+ 1 add) per pair
        ops, rate = pairs * (DEPTH + add), SCALAR_OPS_PER_S
    elif kind == "hummingbird":   # S.C contraction: I x L MACs per pair
        ops, rate = pairs * I * L * 2, INT8_TENSOR_OPS_PER_S
        nbytes += max(32, L) * max(8, L) + 4 * max(8, L)   # C^T int8, D
    else:   # I compares + an AND per mask word not all-ones + W ffs (+ 1)
        masks = int((qs_bitvectors(DEPTH) != 0xFFFFFFFF).sum())
        ops, rate = pairs * (I + masks + W + add), SCALAR_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, dict(bytes=nbytes, ops=ops,
                                           bytes_ms=bytes_ms, ops_ms=ops_ms)


def traced(run):
    """``run()`` under torch.profiler: (the profile, wall microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def log_device_time(prof, top: int) -> None:
    """The trace's device time by kernel (and copy) name, largest first."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name[:90], [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us()
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                                 )[:top]:
        log(f"[profile]   {us / 1e3:10.3f} ms  {n:5d} x  {kname}")


def profile_query(run, what: str, smi: str, top: int = 8) -> None:
    """One run under torch.profiler: device time by kernel and the share
    of the run's wall time the card was busy (kernels do not overlap on
    the one stream)."""
    from torch.autograd import DeviceType

    prof, wall_us = traced(run)
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms under the profiler, "
        f"device busy {busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f} "
        f"% (idle {100 - 100 * busy_us / wall_us:.1f} %), on {smi}")
    log_device_time(prof, top)


def device_intervals(prof) -> tuple[list, list, list]:
    """(all, kernel, host-to-device copy) device intervals of a trace, in
    microseconds."""
    from torch.autograd import DeviceType

    every, kernels, h2d = [], [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        every.append(span)
        if e.name.startswith("Memcpy"):
            if "HtoD" in e.name:
                h2d.append(span)
        elif not e.name.startswith("Memset"):
            kernels.append(span)
    return every, kernels, h2d


def union_us(spans: list) -> float:
    total, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def overlap_us(a: list, b: list) -> float:
    """Time during which an interval of ``a`` and one of ``b`` both run."""
    return union_us(a) + union_us(b) - union_us(a + b)


def scan_trace(prof, wall_us: float) -> str:
    """One scan's trace, summarised: the device busy share of the wall,
    how long before the first kernel the device started (the first
    batch's copy), how long no kernel ran between the first and the last
    (the host's turnaround at each batch's stage boundary), and the page
    copies and their overlap with the kernels."""
    every, kernels, h2d = device_intervals(prof)
    busy = union_us(every)
    k_lo = min(lo for lo, _ in kernels)
    k_hi = max(hi for _, hi in kernels)
    return (f"wall {wall_us / 1e3:.3f} ms under the profiler, device busy "
            f"{busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f} % (idle "
            f"{100 - 100 * busy / wall_us:.1f} %); first kernel "
            f"{(k_lo - min(lo for lo, _ in every)) / 1e3:.3f} ms after the "
            f"first device event, no kernel running for "
            f"{(k_hi - k_lo - union_us(kernels)) / 1e3:.3f} ms between the "
            f"first kernel and the last; kernels {union_us(kernels) / 1e3:.3f}"
            f" ms over {len(kernels)} launches, Memcpy HtoD "
            f"{union_us(h2d) / 1e3:.3f} ms over {len(h2d)} copies, HtoD "
            f"overlapping a kernel {overlap_us(kernels, h2d) / 1e3:.3f} ms")


def validate_chrome_trace(payload: dict) -> dict:
    """The checks of ``benchmarks/bench_obs.validate_chrome_trace`` (which
    imports the reference, so it is not imported here): the payload
    round-trips through JSON, every span has numeric ts / dur / tid / pid,
    every parent resolves, and some span is nested.  Returns counts."""
    data = json.loads(json.dumps(payload))
    events = data["traceEvents"]
    if not events:
        raise AssertionError("exported trace is empty")
    spans = {}
    for ev in events:
        if not isinstance(ev.get("name"), str) or "ph" not in ev:
            raise AssertionError(f"malformed trace event: {ev}")
        if ev["ph"] == "X":
            for field in ("ts", "dur", "tid", "pid"):
                if not isinstance(ev.get(field), (int, float)):
                    raise AssertionError(f"span {ev['name']!r} missing "
                                         f"numeric {field}")
            spans[ev["args"]["span_id"]] = ev
    nested = cross_thread = 0
    for ev in spans.values():
        pid = ev["args"].get("parent_id")
        if pid is None:
            continue
        if pid not in spans:
            raise AssertionError(f"span {ev['name']!r} parent_id {pid} "
                                 f"unresolved")
        nested += 1
        cross_thread += spans[pid]["tid"] != ev["tid"]
    if nested == 0:
        raise AssertionError("no nested spans in exported trace")
    return {"events": len(events), "spans": len(spans), "nested": nested,
            "cross_thread": cross_thread,
            "threads": len({ev["tid"] for ev in spans.values()})}


def obs_phase(*, forest, big, engine, engines, counted, only, smi: str,
              batches: int) -> dict:
    """Phase 8b: the observability plane on the card, over phase 8's host
    and disk tiers and phase 4's device tier.  Returns the launches of its
    queries by kernel."""
    from repro_torch.obs import TRACER

    launches: dict[str, int] = {}

    def count(c: dict) -> None:
        for k, n in c.items():
            if n:
                launches[k] = launches.get(k, 0) + n

    def traced(run):
        TRACER.reset()
        TRACER.enable()
        try:
            out, c = counted(run)
        finally:
            TRACER.disable()
        count(c)
        return out, c, TRACER.finished()

    def udf(eng, dataset="higgs"):
        return eng.infer(dataset, forest, plan="udf",
                         algorithm="predicated_pallas_fused")

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for tier in ("host", "disk"):
        r, c, spans = traced(lambda: udf(engines[tier]))
        s, tr = r.scan, r.trace
        only(c, "predicated_fused", s.batches, f"[obs] traced {tier} udf")
        n = tr.span_counts
        by_id = {sp.span_id: sp for sp in spans}
        execute = next(sp for sp in spans if sp.name == "scan.execute")
        drains = [sp for sp in spans if sp.name == "scan.drain_write"]
        stages = [sp for sp in spans if sp.name.startswith("stage:")]
        reports = sum(rep.seconds for rep in r.stage_reports)
        device_s = sum(sp.attrs["device_s"] for sp in stages)
        stage_wall = sum(sp.duration_s for sp in stages)
        drain_iv = [(sp.start_ns, sp.end_ns) for sp in drains]
        compute_iv = [(sp.start_ns, sp.end_ns) for sp in spans
                      if sp.name == "scan.compute"]
        drain_ns = union_us(drain_iv)
        share = overlap_us(drain_iv, compute_iv) / drain_ns
        checks = {
            "span counts = ScanStats.batches": (
                n["scan.batch"] == n["scan.dma_in"] == n["scan.compute"]
                == n["scan.drain_write"] == s.batches == batches),
            "scan.disk_read = batches on disk": (
                n.get("scan.disk_read", 0) == (s.batches if tier == "disk"
                                               else 0)),
            "drain_write on cuda:drain under its scan.batch": all(
                sp.track == "cuda:drain"
                and by_id[sp.parent_id].name == "scan.batch"
                for sp in drains),
            "drain_write inside scan.execute": all(
                execute.start_ns <= lo <= hi <= execute.end_ns
                for lo, hi in drain_iv),
            "stage device_s sum = StageReport.seconds sum": (
                len(stages) == len(r.stage_reports)
                and abs(device_s - reports) <= 1e-9 * max(1.0, reports)),
            "counter deltas = ScanStats": (
                tr.counters.get("scan.batches") == s.batches
                and tr.counters.get("scan.bytes_streamed")
                == s.bytes_streamed),
        }
        log(f"[obs] traced {tier} udf predicated_pallas_fused: span counts "
            f"{dict(sorted(n.items()))}; counters {tr.counters}; wall_s "
            f"{s.wall_s:.6f}, trace wall {tr.wall_s:.6f}, seconds by span "
            f"{ {k: round(v, 6) for k, v in sorted(tr.phase_s.items())} }; "
            f"stage spans: "
            f"host wall {stage_wall:.6f} s, device_s {device_s:.6f} s, "
            f"turnaround {stage_wall - device_s:.6f} s over {len(stages)} "
            f"stages ({(stage_wall - device_s) / len(stages) * 1e3:.3f} "
            f"ms a stage); drain device {drain_ns / 1e9:.6f} s (ScanStats "
            f"drain_s {s.drain_s:.6f}), overlapping scan.compute "
            f"{share:.4f} of it; on {smi}")
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"[obs] traced {tier} udf: {bad}")
        payload = TRACER.export_chrome(str(out_dir / f"obs_{tier}.json"))
        shape = validate_chrome_trace(payload)
        lanes = {e["args"]["name"] for e in payload["traceEvents"]
                 if e["name"] == "thread_name"}
        want = {"cuda:drain"} | ({"scan-reader"} if tier == "disk" else set())
        if not want <= lanes:
            raise AssertionError(f"[obs] {tier} trace lanes {lanes}")
        log(f"[obs] exported chiprun_out/obs_{tier}.json: {shape}, lanes "
            f"{sorted(lanes)}: valid")

    for i in range(2):
        r, c, spans = traced(lambda: engine.infer(
            "higgs", big, plan="rel+reuse", algorithm="predicated_pallas"))
        only(c, "predicated_raw", r.n_parts * r.scan.batches,
             f"[obs] traced device rel+reuse #{i}")
        tr = r.trace
        log(f"[obs] traced device rel+reuse predicated_pallas #{i}: span "
            f"counts {dict(sorted(tr.span_counts.items()))}, events "
            f"{tr.event_counts}, counters {tr.counters}, wall "
            f"{tr.wall_s:.6f} s; on {smi}")
    if tr.counters.get("plan.cache_hits") != 1 \
            or "plan.partition" in tr.span_counts:
        raise AssertionError("[obs] the repeated rel+reuse query's trace "
                             "shows no plan-cache hit")

    rows = engine.store.get("higgs").data[:8]

    def infer_rows():
        return engine.infer_rows(big, rows, plan="udf",
                                 algorithm="predicated_pallas_fused")

    infer_rows()                                   # the plan is built
    r, c, spans = traced(infer_rows)
    only(c, "predicated_fused", 1, "[obs] traced infer_rows")
    names = sorted(sp.name for sp in spans)
    stage = next(sp for sp in spans if sp.name.startswith("stage:"))
    if names.count("query.infer_rows") != 1 or "device_s" not in stage.attrs:
        raise AssertionError(f"[obs] traced infer_rows spans {names}")
    log(f"[obs] traced infer_rows(8 rows): spans {names}, stage host wall "
        f"{stage.duration_s * 1e3:.4f} ms, device_s "
        f"{stage.attrs['device_s'] * 1e3:.4f} ms; on {smi}")

    def wall(run) -> float:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def overhead(run, pairs: int) -> tuple[float, float, float]:
        """Median walls untraced and traced over interleaved pairs (the
        order alternating), and their ratio."""
        walls = {False: [], True: []}
        for i in range(pairs):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                TRACER.reset()
                if on:
                    TRACER.enable()
                try:
                    walls[on].append(wall(run))
                finally:
                    TRACER.disable()
        med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
        return med[False], med[True], med[True] / med[False]

    ratios = {}
    for what, run, pairs in (
            ("device udf 11M rows", lambda: udf(engine), 11),
            ("host udf 11M rows", lambda: udf(engines["host"]), 5),
            ("infer_rows 8 rows", infer_rows, 21)):
        (off, on, ratio), c = counted(lambda: overhead(run, pairs))
        count(c)
        ratios[what] = ratio
        log(f"[obs] overhead {what}: untraced {off:.6f} s, traced "
            f"{on:.6f} s (medians of {pairs} interleaved pairs), traced / "
            f"untraced {ratio:.4f}; on {smi}")
    if ratios["device udf 11M rows"] > 1.05:
        raise AssertionError("[obs] tracing costs the device-tier udf query "
                             "more than 5 %")

    TRACER.reset()
    r = udf(engines["host"])
    if r.trace is not None or TRACER.finished():
        raise AssertionError("[obs] a disabled tracer recorded spans")
    log(f"[obs] disabled tracer: trace None, no span recorded; launches "
        f"{launches}")
    return launches


def faults_phase(*, forest, big, engine, engines, refs, counted, only,
                 smi: str, batches: int, cut, load_rows, spill: str) -> dict:
    """Phase 8c: the fault plane on the card, over phase 8's host and disk
    tiers and phase 4's device tier.  Returns the launches of its queries
    by kernel."""
    from repro_torch.db import loader
    from repro_torch.db.faults import FaultInjector, RetryPolicy, ScanFault

    fast = RetryPolicy(backoff_base_s=0.0, max_backoff_s=0.0)
    launches: dict[str, int] = {}
    sites = ("page_dma_in", "drain_copy_out", "disk_page_read",
             "kernel_launch", "drain_worker")

    def armed(**arming) -> FaultInjector:
        inj = FaultInjector()
        for site, kw in arming.items():
            inj.inject(site, **kw)
        return inj

    def calls(tier: str, n: int, **extra) -> dict:
        """Each site's calls over an n-batch scan at depth 2, plus
        ``extra``: one call a batch at every site the tier has."""
        out = {site: n for site in sites}
        if tier != "disk":
            out["disk_page_read"] = 0
        for site, v in extra.items():
            out[site] += v
        return out

    def query(tier: str, plan: str = "udf", **kw):
        """One query, its launches checked and tallied.  A ScanFault is
        returned in place of the result."""
        f, algorithm, name_ = ((forest, "predicated_pallas_fused",
                                "predicated_fused") if plan == "udf"
                               else (big, "predicated_pallas",
                                     "predicated_raw"))
        eng = engine if tier == "device" else engines[tier]
        if kw.get("injector") is not None:
            kw["retry_policy"] = fast

        def run():
            try:
                return eng.infer("higgs", f, plan=plan, algorithm=algorithm,
                                 **kw)
            except ScanFault as e:
                return e

        r, c = counted(run)
        for k, n in c.items():
            if n:
                launches[k] = launches.get(k, 0) + n
        return r, c, name_

    def want(plan: str) -> torch.Tensor:
        return bits(refs[plan])

    def line(r) -> str:
        s = r.scan
        return (f"wall_s {s.wall_s:.6f}, total_s {r.total_s:.6f}, batches "
                f"{s.batches}, retries {s.retries}, faults_injected "
                f"{s.faults_injected}, batch_resubmits {s.batch_resubmits}, "
                f"degraded_to_sync {s.degraded_to_sync}, deadline_hit "
                f"{s.deadline_hit}, max_in_flight {s.max_in_flight}, "
                f"drain_wait_s {s.drain_wait_s:.6f}")

    def recovered(label: str, tier: str, arming: dict, expect: dict,
                  want_calls: dict, plan: str = "udf", n: int = batches):
        inj = armed(**arming)
        r, c, name_ = query(tier, plan, injector=inj)
        if isinstance(r, ScanFault):
            raise AssertionError(f"[faults] {label}: {r}")
        s = r.scan
        only(c, name_, r.n_parts * s.batches, f"[faults] {label}")
        ok = (s.batches == n and s.max_in_flight <= 2
              and all(getattr(s, k) == v for k, v in expect.items())
              and inj.calls == want_calls and r.degraded is None
              and torch.equal(bits(r.predictions.cpu()), want(plan)))
        log(f"[faults] {label}: {line(r)}; calls {inj.calls}; "
            f"{c[name_]} {name_} launches; bit-identical to the unfaulted "
            f"run: {'ok' if ok else 'FAIL'}; on {smi}")
        if not ok:
            raise AssertionError(f"[faults] {label} failed its checks "
                                 f"(calls {inj.calls}, want {want_calls})")
        return r

    clean = query("host")[0]
    batch_rows = clean.scan.batch_pages * PAGE_ROWS

    # -- transient faults (each site's 2nd call) ----------------------------
    one = dict(retries=1, faults_injected=1, batch_resubmits=0,
               degraded_to_sync=False)
    recovered("transient disk_page_read, disk udf", "disk",
              {"disk_page_read": dict(fail_at=2)}, one,
              calls("disk", batches, disk_page_read=1))
    for site in ("page_dma_in", "kernel_launch", "drain_copy_out"):
        recovered(f"transient {site}, host udf", "host",
                  {site: dict(fail_at=2)}, one,
                  calls("host", batches, **{site: 1}))
    r = recovered("transient drain_worker, host udf", "host",
                  {"drain_worker": dict(fail_at=2)},
                  dict(retries=0, faults_injected=1, degraded_to_sync=True),
                  calls("host", batches, drain_worker=2 - batches))
    if not r.scan.drain_wait_s > clean.scan.drain_wait_s:
        raise AssertionError("[faults] the degraded drain waited no longer "
                             "than the asynchronous one")
    log(f"[faults] degraded drain_wait_s {r.scan.drain_wait_s:.6f} against "
        f"the clean host scan's {clean.scan.drain_wait_s:.6f} (wall_s "
        f"{clean.scan.wall_s:.6f}); on {smi}")
    recovered("transient kernel_launch, host rel+reuse", "host",
              {"kernel_launch": dict(fail_at=2)}, one,
              calls("host", batches, kernel_launch=1), plan="rel+reuse")

    # -- the ladders --------------------------------------------------------
    t0 = time.perf_counter()
    r = recovered("ladder page_dma_in halving, host udf", "host",
                  {"page_dma_in": dict(fail_at=1, times=3)},
                  dict(retries=2, faults_injected=3, batch_resubmits=1),
                  calls("host", batches + 1, page_dma_in=3), n=batches + 1)
    log(f"[faults] halved scan: {batches + 1} batches, wall_s "
        f"{r.scan.wall_s:.6f} (query {time.perf_counter() - t0:.6f} s) "
        f"against the clean {clean.scan.wall_s:.6f}; on {smi}")
    recovered("ladder disk_page_read re-enqueue, disk udf", "disk",
              {"disk_page_read": dict(fail_at=1, times=3)},
              dict(retries=2, faults_injected=3, batch_resubmits=1),
              calls("disk", batches, disk_page_read=3))

    # -- exhaustion ---------------------------------------------------------
    for site, n_launch, extra in (
            ("kernel_launch", 2, dict(page_dma_in=4, kernel_launch=5,
                                      drain_copy_out=2, drain_worker=2)),
            ("drain_copy_out", 3, dict(page_dma_in=4, kernel_launch=3,
                                       drain_copy_out=5, drain_worker=3))):
        inj = armed(**{site: dict(fail_at=3, times=10**6)})
        e, c, name_ = query("host", injector=inj)
        want_rows = 2 * batch_rows
        want_calls = dict(calls("host", 0), **extra)
        ok = (isinstance(e, ScanFault) and e.site == site
              and e.attempts == fast.max_attempts
              and e.rows_completed == want_rows
              and inj.calls == want_calls and c[name_] == n_launch)
        log(f"[faults] exhausted {site}, host udf: {e!r}; rows_completed "
            f"{getattr(e, 'rows_completed', None)}; calls {inj.calls}; "
            f"{c[name_]} launches: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[faults] exhausted {site} failed its "
                                 f"checks")
        r = query("host")[0]
        if not torch.equal(bits(r.predictions.cpu()), want("udf")):
            raise AssertionError(f"[faults] the query after the {site} "
                                 f"ScanFault is not the full result")
        log(f"[faults] after the {site} ScanFault a clean host query: "
            f"{line(r)}; full result bit-identical: ok")

    # -- deadlines ----------------------------------------------------------
    budget = clean.total_s / 2
    r = query("host", deadline_s=budget)[0]
    d, s = r.degraded, r.scan
    mask = torch.from_numpy(d.row_mask) if d is not None else None
    ref = refs["udf"]
    whole = mask is not None and all(
        bool(mask[i:i + batch_rows].all()) or not mask[i:i + batch_rows].any()
        for i in range(0, ref.shape[0], batch_rows))
    ok = (s.deadline_hit and d is not None and 0 < d.rows_scored < ref.shape[0]
          and d.rows_scored == int(mask.sum()) and whole
          and d.rows_scored + d.rows_missing == ref.shape[0]
          and torch.equal(bits(r.predictions[mask]), bits(ref[mask]))
          and bool(torch.isnan(r.predictions[~mask]).all()))
    log(f"[faults] deadline_s {budget:.6f} (half the clean host query's "
        f"total_s {clean.total_s:.6f}): {line(r)}; rows_scored "
        f"{getattr(d, 'rows_scored', None)} of {ref.shape[0]} in whole "
        f"batches, scored rows bit-identical, the rest NaN: "
        f"{'ok' if ok else 'FAIL'}; on {smi}")
    if not ok:
        raise AssertionError("[faults] the half-budget partial failed its "
                             "checks")
    for tier in ("device", "host"):
        r, c, _ = query(tier, deadline_s=0.0)
        d = r.degraded
        ok = (d is not None and d.rows_scored == 0 and not any(c.values())
              and bool(torch.isnan(r.predictions).all())
              and r.predictions.device.type == (
                  engine.store.device.type if tier == "device" else "cpu"))
        log(f"[faults] deadline_s 0 on the {tier} tier: rows_scored "
            f"{getattr(d, 'rows_scored', None)}, all NaN, no launch: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[faults] deadline_s=0 failed its checks")
    r = query("host", deadline_s=3600.0)[0]
    if r.degraded is not None or r.scan.deadline_hit \
            or not torch.equal(bits(r.predictions.cpu()), want("udf")):
        raise AssertionError("[faults] deadline_s=3600 degraded the query")
    log(f"[faults] deadline_s 3600: {line(r)}; not degraded, "
        f"bit-identical: ok")

    # -- move off disk, rolled back -----------------------------------------
    store = engines["disk"].store
    store.put("fault-cut", cut, tier="disk")
    files = sorted(os.listdir(spill))
    tiers0 = (store.device_nbytes, store.host_nbytes, store.disk_nbytes)
    store.injector = armed(disk_page_read=dict(fail_at=1, times=3))
    store.retry_policy = fast
    try:
        try:
            store.move("fault-cut", "host")
            raise AssertionError("[faults] the armed move did not fail")
        except ScanFault as e:
            fault = e
        rolled = (store.get("fault-cut").tier == "disk"
                  and sorted(os.listdir(spill)) == files
                  and (store.device_nbytes, store.host_nbytes,
                       store.disk_nbytes) == tiers0
                  and fault.site == "disk_page_read"
                  and fault.attempts == 3 and fault.rows_completed == 0)
        moved = store.move("fault-cut", "host")
    finally:
        store.injector = store.retry_policy = None
    ok = (rolled and moved.tier == "host" and moved.data.is_pinned()
          and torch.equal(bits(moved.data[:cut.shape[0]].cuda()),
                          bits(cut)))
    log(f"[faults] move {cut.shape[0]} rows disk -> host with disk_page_read "
        f"exhausted: {fault!r}; spill files, tier bytes and catalog "
        f"unchanged, the retried move lands the rows: "
        f"{'ok' if ok else 'FAIL'}")
    store.drop("fault-cut")
    if not ok:
        raise AssertionError("[faults] the move rollback failed its checks")

    # -- a loader -----------------------------------------------------------
    d = tempfile.mkdtemp(prefix="chip-smoke-faults-")
    try:
        path = os.path.join(d, "higgs.csv")
        rows = load_rows
        loader.write_csv(path, rows)
        clean_rows, t_clean = loader.load_csv_external(path, device="cuda")
        inj = armed(page_dma_in=dict(fail_at=1))
        got, t_got = loader.load_csv_external(path, device="cuda",
                                              injector=inj,
                                              retry_policy=fast)
        ok = (inj.calls["page_dma_in"] == 2 and inj.total_fired == 1
              and torch.equal(bits(got), bits(clean_rows)))
        log(f"[faults] load_csv_external {rows.shape[0]} x {rows.shape[1]} "
            f"with a transient page_dma_in: transfer_s "
            f"{t_got.transfer_s:.6f} (clean {t_clean.transfer_s:.6f}), "
            f"total_s {t_got.total_s:.6f}; calls {inj.calls['page_dma_in']}"
            f", bit-identical to the clean load: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[faults] the loader's transient fault")
    finally:
        shutil.rmtree(d, ignore_errors=True)

    # -- zero-fault overhead: an armed-but-silent injector against none -----
    def wall(tier: str, inj) -> float:
        t0 = time.perf_counter()
        r = query(tier, injector=inj)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if r.scan.faults_injected or r.scan.retries:
            raise AssertionError("[faults] the silent injector fired")
        return dt

    ratios = {}
    for tier, pairs in (("device", 11), ("host", 5)):
        walls = {False: [], True: []}
        for i in range(pairs):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                inj = armed(kernel_launch=dict(fail_at=10**9)) if on else None
                walls[on].append(wall(tier, inj))
        med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
        ratios[tier] = med[True] / med[False]
        log(f"[faults] overhead {tier} udf 11M rows: no injector "
            f"{med[False]:.6f} s, armed but silent {med[True]:.6f} s "
            f"(medians of {pairs} interleaved pairs), armed / none "
            f"{ratios[tier]:.4f}; on {smi}")
    if ratios["device"] > 1.05:
        raise AssertionError("[faults] an armed injector costs the "
                             "device-tier udf query more than 5 %")
    log(f"[faults] launches {launches}")
    return launches


def tiers_phase(*, forest, big, store, engine, counted, only, smi: str,
                fused_ms: float, rel_device_s: float) -> tuple[dict, float]:
    """Phase 8: the 11M-row table on the host and disk tiers.  Returns the
    launches of its queries by kernel and the plain pinned H2D link rate
    (GB/s)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.db.store import TensorBlockStore

    launches: dict[str, int] = {}
    table = store.get("higgs")
    rows = table.data[:HIGGS_ROWS]
    batch_pages = (TIER_BUDGET // 2) // table.page_nbytes
    batches = -(-table.num_pages // batch_pages)
    spill = tempfile.mkdtemp(prefix="chip-smoke-spill-")
    try:
        t0 = time.perf_counter()
        host_store = TensorBlockStore(device="cuda",
                                      device_budget_bytes=TIER_BUDGET)
        hds = host_store.put("higgs", rows)
        host_put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        disk_store = TensorBlockStore(device="cuda",
                                      device_budget_bytes=TIER_BUDGET,
                                      host_budget_bytes=TIER_BUDGET,
                                      spill_dir=spill)
        dds = disk_store.put("higgs", rows)
        disk_put_s = time.perf_counter() - t0
        if (hds.tier, dds.tier) != ("host", "disk"):
            raise AssertionError(f"auto cascade put the table on "
                                 f"{hds.tier} and {dds.tier}")
        if not host_store.get("higgs").data.is_pinned():
            raise AssertionError("the host tier's pages are not pinned")
        if hds.nbytes != table.nbytes or dds.nbytes != table.nbytes:
            raise AssertionError("the tiers hold another page layout")
        log(f"[tiers] put: host tier {hds.nbytes} B pinned in "
            f"{host_put_s:.3f} s, disk tier {dds.nbytes} B in "
            f"{len(os.listdir(spill))} spill file(s) in {disk_put_s:.3f} s "
            f"(set-up); budgets {TIER_BUDGET} B, default batch "
            f"{batch_pages} pages of {table.page_rows} rows = {batches} "
            f"batches")
        engines = {"host": fresh_engine(host_store),
                   "disk": fresh_engine(disk_store)}
        refs = {}
        for plan, algorithm, f in (("udf", "predicated_pallas_fused",
                                    forest),
                                   ("rel+reuse", "predicated_pallas", big)):
            r = engine.infer("higgs", f, plan=plan, algorithm=algorithm,
                             batch_pages=batch_pages)
            refs[plan] = r.predictions.cpu()
        torch.cuda.synchronize()

        def run(tier: str, plan: str, algorithm: str, f, depth: int,
                label: str):
            fused = algorithm.endswith("_fused")
            name_ = f"predicated_{'fused' if fused else 'raw'}"
            r, c = counted(lambda: engines[tier].infer(
                "higgs", f, plan=plan, algorithm=algorithm,
                prefetch_depth=depth))
            s = r.scan
            only(c, name_, r.n_parts * s.batches, f"[tiers] {label}")
            launches[name_] = launches.get(name_, 0) + c[name_]
            want = refs[plan]
            ok = (s.batches == batches and s.batch_pages == batch_pages
                  and s.max_in_flight == depth <= 2 and s.pinned_staging
                  and s.drain_async == (depth == 2)
                  and s.bytes_streamed == table.nbytes
                  and r.tier == tier and r.predictions.is_pinned()
                  and r.predictions.shape == want.shape
                  and torch.equal(bits(r.predictions), bits(want)))
            log(f"[tiers] run {label}: wall_s {s.wall_s:.6f}, "
                f"{HIGGS_ROWS / s.wall_s:.1f} rows/s; total_s "
                f"{r.total_s:.6f}, transfer_issue_s {s.transfer_issue_s:.6f}"
                f", transfer_wait_s {s.transfer_wait_s:.6f}, compute_s "
                f"{s.compute_s:.6f}, drain_s {s.drain_s:.6f}, drain_wait_s "
                f"{s.drain_wait_s:.6f}, drain_overlap_s "
                f"{s.drain_overlap_s:.6f}; {s.batches} batches of "
                f"{s.batch_pages} pages, max_in_flight {s.max_in_flight}, "
                f"bytes_streamed {s.bytes_streamed}, pinned_staging "
                f"{s.pinned_staging}, drain_async {s.drain_async}, "
                f"reuse_hit {r.reuse_hit}, {c[name_]} {name_} launches = "
                f"n_parts {r.n_parts} x {s.batches} batches, bit-identical "
                f"to the device tier: {'ok' if ok else 'FAIL'}; on {smi}")
            if not ok:
                raise AssertionError(f"[tiers] {label} failed its checks")
            return r

        waits = {}

        def udf_runs(tier: str) -> None:
            for i, depth in enumerate((2, 2, 1, 2, 1)):
                r = run(tier, "udf", "predicated_pallas_fused", forest,
                        depth, f"{tier} udf predicated_pallas_fused depth "
                        f"{depth} #{i}")
                if i:                       # #0 is the warm-up run
                    waits.setdefault((tier, depth), []).append(
                        r.scan.transfer_wait_s)
                del r

        udf_runs("host")
        src = torch.empty(LINK_BYTES // 4, dtype=torch.float32,
                          pin_memory=True)
        dst = torch.empty(LINK_BYTES // 4, dtype=torch.float32,
                          device="cuda")
        link_ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True),
                          warmup=2, reps=10)
        link = LINK_BYTES / link_ms / 1e6
        del src, dst
        h2d_ms = table.nbytes / link / 1e6
        log(f"[tiers] link: one pinned {LINK_BYTES} B H2D copy_ "
            f"{link_ms:.4f} ms = {link:.3f} GB/s; the table's "
            f"{table.nbytes} B at that rate {h2d_ms:.4f} ms; scan bound "
            f"udf max(H2D, fused kernel {fused_ms:.4f} ms) = "
            f"{max(h2d_ms, fused_ms):.4f} ms, rel+reuse max(H2D, device-"
            f"tier query {1e3 * rel_device_s:.4f} ms) = "
            f"{max(h2d_ms, 1e3 * rel_device_s):.4f} ms; on {smi}")

        # A trace is complete when it holds one page copy per batch, as
        # long together as the table's bytes take at the link rate (within
        # PROFILE_H2D_SHARE: the scan's copies may run faster than the one
        # plain copy).  An incomplete trace is flagged: its busy share
        # misplaces the idle.  In this process the trace has missed page
        # copies in every run so far, before the disk-tier scans too;
        # chip_tiers_probe.py traces the query in a fresh process.
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = engines["host"].infer("higgs", forest, plan="udf",
                                      algorithm="predicated_pallas_fused")
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        del r
        _, _, h2d = device_intervals(prof)
        complete = (len(h2d) == batches and union_us(h2d) / 1e3
                    >= PROFILE_H2D_SHARE * h2d_ms)
        log(f"[tiers] profile host udf predicated_pallas_fused depth 2: "
            f"{scan_trace(prof, wall_us)}; trace complete: "
            f"{'yes' if complete else 'NO, the shares above miss copies'} "
            f"({len(h2d)} of {batches} copies, {union_us(h2d) / 1e3:.3f} of "
            f"the {h2d_ms:.4f} ms the table takes at the link rate); on "
            f"{smi}")

        udf_runs("disk")
        for tier in ("host", "disk"):
            w2 = sum(waits[tier, 2]) / 2
            w1 = sum(waits[tier, 1]) / 2
            log(f"[tiers] overlap_fraction {tier} udf: {1 - w2 / w1:.4f} "
                f"(= 1 - transfer_wait depth 2 / depth 1 = 1 - {w2:.6f} / "
                f"{w1:.6f}, means of runs #1-#4) on {smi}")
        rel = [run("host", "rel+reuse", "predicated_pallas", big, 2,
                   f"host rel+reuse predicated_pallas depth 2 #{i}")
               for i in range(2)]
        if rel[0].reuse_hit or not (rel[1].reuse_hit
                                    and rel[1].plan_reuse_hit) \
                or rel[1].partition_s != 0.0:
            raise AssertionError("[tiers] the repeated host-tier rel+reuse "
                                 "query did not hit both caches")
        log(f"[tiers] host rel+reuse repeat total_s {rel[1].total_s:.6f} "
            f"against the device tier's {rel_device_s:.6f} (phase 6, one "
            f"batch) on {smi}")
        del rel

        t8b = time.perf_counter()
        for name_, n in obs_phase(forest=forest, big=big, engine=engine,
                                  engines=engines, counted=counted,
                                  only=only, smi=smi,
                                  batches=batches).items():
            launches[name_] = launches.get(name_, 0) + n
        log(f"[obs] phase wall {time.perf_counter() - t8b:.3f} s")

        cut = store.get("higgs_1m").data[:CUT_ROWS]
        t8c = time.perf_counter()
        for name_, n in faults_phase(
                forest=forest, big=big, engine=engine, engines=engines,
                refs=refs, counted=counted, only=only, smi=smi,
                batches=batches, cut=cut, spill=spill,
                load_rows=cut[:FAULT_LOAD_ROWS].cpu().numpy()).items():
            launches[name_] = launches.get(name_, 0) + n
        log(f"[faults] phase wall {time.perf_counter() - t8c:.3f} s")

        disk_store.put("cut", cut, tier="device")
        eng = engines["disk"]

        def cut_query():
            return eng.infer("cut", forest, plan="udf",
                             algorithm="predicated_pallas_fused",
                             batch_pages=MOVE_BATCH_PAGES)

        want, c = counted(cut_query)
        want = want.predictions.cpu()
        launches["predicated_fused"] += c["predicated_fused"]
        for tier in ("host", "disk", "device"):
            moved = disk_store.move("cut", tier)
            r, c = counted(cut_query)
            only(c, "predicated_fused", r.scan.batches,
                 f"[tiers] move to {tier}")
            launches["predicated_fused"] += c["predicated_fused"]
            ok = (moved.tier == r.tier == tier and r.plan_reuse_hit
                  and (tier != "host" or moved.data.is_pinned())
                  and torch.equal(bits(r.predictions.cpu()), bits(want)))
            files = sorted(os.listdir(spill))
            log(f"[tiers] move cut ({CUT_ROWS} rows) -> {tier}: "
                f"predictions unchanged, plan reused: "
                f"{'ok' if ok else 'FAIL'}; spill files {files}")
            if not ok:
                raise AssertionError(f"[tiers] move to {tier} changed the "
                                     f"query")
        if len(os.listdir(spill)) != 1:
            raise AssertionError("[tiers] moving off the disk tier left a "
                                 "spill file")
        disk_store.drop("higgs")
        host_store.drop("higgs")
        if os.listdir(spill):
            raise AssertionError("[tiers] drop left a spill file")
        log(f"[tiers] drop: spill directory empty; launches {launches}")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    return launches, link


def sparse_phase(*, counted, only, smi: str, tally) -> dict:
    """Phase 9: wide rows and the CSR plane.  The x-mode timings; Epsilon
    dense wide; Bosch as CSR against dense on the device, host and disk
    tiers; a Criteo-shaped CSR table.  ``tally(counts)`` adds a query's
    launches to the kernels' record.  Returns the wide-row kernels' record
    numbers at the Epsilon shape."""
    from repro_torch.core.forest import (compact_forest, make_forest,
                                         tree_slice)
    from repro_torch.core.postprocess import predict_proba
    from repro_torch.db.sparse import (concat_pages, csr_from_dense,
                                       densify_csr, paginate_csr)
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.kernels.common import (WIDE_ROWS, X_STAGED_MAX_F,
                                            feature_major,
                                            feature_major_plain, wide_ldx,
                                            wide_tiled, x_staged, xt_chunks)
    from repro_torch.kernels.forest_hummingbird import (
        hummingbird_fused_plain, hummingbird_raw_plain)
    from repro_torch.kernels.forest_predicated import (predicated_fused_plain,
                                                       predicated_raw_plain)
    from repro_torch.kernels.forest_quickscorer import (
        quickscorer_fused_plain, quickscorer_raw_plain)
    from repro_torch.kernels.gather import (csr_block_to_dense,
                                            gather_inverse_map)
    from repro_torch.kernels.ops import (KERNEL_WRAPPERS, RAW_KERNEL_WRAPPERS,
                                         prepare_inputs)

    plain = dict(predicated=predicated_fused_plain,
                 hummingbird=hummingbird_fused_plain,
                 quickscorer=quickscorer_fused_plain)
    raw_plain = dict(predicated=predicated_raw_plain,
                     hummingbird=hummingbird_raw_plain,
                     quickscorer=quickscorer_raw_plain)

    def forests(F: int, seed: int):
        """(500-tree, 1600-tree) random forests over F features."""
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(seed),
                                            integer_leaves=False, features=F)
        f = make_forest(fe, th, lv, default_left=dl, n_features=F,
                        device="cuda")
        fe, th, dl, lv = make_forest_arrays(
            np.random.default_rng(seed + 1), integer_leaves=False,
            trees=REL_TREES, leaf_scale=0.1 * math.sqrt(TREES / REL_TREES),
            features=F)
        big = make_forest(fe, th, lv, default_left=dl, n_features=F,
                          device="cuda")
        return f, big

    # -- x modes: each kernel staged and wide-row across widths ----------
    times: dict = {}
    for F in XMODE_F:
        x = card_rows(XMODE_ROWS, F, seed=SEED + 20)
        f, _ = forests(F, SEED + 21)
        part = tree_slice(f, 0, 16)
        for kind in KINDS:
            for fused in (True, False):
                variant = "fused" if fused else "raw"
                forest_ = f if fused else part
                wrapper = (KERNEL_WRAPPERS if fused
                           else RAW_KERNEL_WRAPPERS)[kind]
                got, tiles = {}, {}
                for staged in (True, False):
                    try:
                        args, tiles[staged] = prepare_inputs(
                            kind, forest_, x, fused=fused, staged=staged)
                    except ValueError:
                        got[staged] = None
                        continue
                    got[staged] = cuda_ms(
                        lambda: wrapper(*args, **tiles[staged]), warmup=1,
                        reps=3)
                times[kind, variant, F] = got
                bound_ms, bound_by, _ = bound(kind, XMODE_ROWS, F,
                                              forest_.num_trees,
                                              raw=not fused)
                st = ("does not fit" if got[True] is None
                      else f"{got[True]:.4f} ms")
                log(f"[sparse] xmode {kind} {variant} F={F}: staged {st}, "
                    f"wide {got[False]:.4f} ms ({XMODE_ROWS} rows x "
                    f"{forest_.num_trees} trees, tiles staged "
                    f"{tiles.get(True)} / wide {tiles[False]}); bound "
                    f"{bound_ms:.4f} ms by {bound_by}; on {smi}")
        del x
    for kind in KINDS:
        for variant in ("fused", "raw"):
            cross = next((F for F in XMODE_F
                          if times[kind, variant, F][True] is None
                          or times[kind, variant, F][False]
                          < times[kind, variant, F][True]), None)
            limit = X_STAGED_MAX_F[kind, variant == "fused"]
            log(f"[sparse] xmode crossover {kind} {variant}: the wide-row "
                f"mode is first faster at F={cross} of {XMODE_F}; the port "
                f"stages x up to "
                f"{'where a tile fits' if limit is None else limit}")

    def launches_of(name, f, r, dataset):
        """Kernel launches a query makes: one a batch and partition, or,
        for a wide-tiled kernel in the wide-row mode, one a chunk of each
        batch (``xt_chunks``).  A batch's x is its whole pages, as wide as
        the forest's features (dense) or the ones it uses (CSR, the
        gather's compact tile)."""
        kind, variant = name.rsplit("_", 1)
        fused, s = variant == "fused", r.scan
        F = (compact_forest(f)[1].numel() if r.storage_format == "csr"
             else f.n_features)
        if not wide_tiled(kind, fused) or x_staged(kind, F, DEPTH, fused):
            return r.n_parts * s.batches
        pages = [min(s.batch_pages, dataset.num_pages - i * s.batch_pages)
                 for i in range(s.batches)]
        return r.n_parts * sum(len(xt_chunks(n * dataset.page_rows, F))
                               for n in pages)

    def query(engine, dataset, f, plan, algorithm, label, *, n_rows,
              oracle=None, **kw):
        """One counted query: exact launches, finite predictions of the
        right shape, and (``oracle``) its first rows against the eager
        oracle."""
        kind = algorithm.split("_")[0]
        name = f"{kind}_{'fused' if algorithm.endswith('_fused') else 'raw'}"
        r, c = counted(lambda: engine.infer(dataset, f, plan=plan,
                                            algorithm=algorithm, **kw))
        s = r.scan
        only(c, name, launches_of(name, f, r, engine.store.get(dataset)),
             f"[sparse] {label}")
        tally(c)
        preds = r.predictions
        if tuple(preds.shape) != (n_rows,) or not bool(
                torch.isfinite(preds).all()):
            raise AssertionError(f"[sparse] {label}: bad predictions")
        err = ""
        if oracle is not None:
            k = oracle.shape[0]
            got = preds[:k].to(oracle.device)
            e = float((got - oracle).abs().max())
            if not torch.allclose(got, oracle, rtol=TOL, atol=TOL):
                raise AssertionError(f"[sparse] {label}: {e} from the "
                                     f"eager oracle")
            err = f"; max |pred - eager predicated| over {k} rows = {e!r}"
        log(f"[sparse] run {label}: wall_s {s.wall_s:.6f}, "
            f"{n_rows / s.wall_s:.1f} rows/s; total_s {r.total_s:.6f}, "
            f"storage_format {r.storage_format}, tier {r.tier}, n_parts "
            f"{r.n_parts} x {s.batches} batches of {s.batch_pages} pages = "
            f"{c[name]} {name} launches ({c[name + '_wide']} wide-row), "
            f"reuse_hit {r.reuse_hit}, bytes_streamed {s.bytes_streamed}, "
            f"transfer_wait_s {s.transfer_wait_s:.6f}, compute_s "
            f"{s.compute_s:.6f}; stages {stage_sums(r)}{err}; on {smi}")
        return r

    # -- Epsilon: dense, 2,000 features, device tier ---------------------
    t0 = time.perf_counter()
    store = TensorBlockStore(device="cuda")
    x = card_rows(EPSILON_ROWS, EPSILON_F, seed=SEED + 30)
    eps = store.put("epsilon", x)
    del x
    f, big = forests(EPSILON_F, SEED + 31)
    sample = eps.data[:COMPARE_ROWS]
    oracle = predict_proba(f, sample, algorithm="predicated")
    big_oracle = predict_proba(big, sample, algorithm="predicated")
    torch.cuda.synchronize()
    log(f"[sparse] epsilon: {EPSILON_ROWS} x {EPSILON_F} f32 dense, "
        f"{eps.nbytes} B on the device tier, {time.perf_counter() - t0:.3f} "
        f"s set-up")
    engine = fresh_engine(store)
    for algorithm in ("predicated_pallas_fused", "hummingbird_pallas_fused",
                      "quickscorer_pallas_fused"):
        query(engine, "epsilon", f, "udf", algorithm,
              f"epsilon udf {algorithm}", n_rows=EPSILON_ROWS,
              oracle=oracle)
    rel = [query(engine, "epsilon", big, "rel+reuse", "predicated_pallas",
                 f"epsilon rel+reuse predicated_pallas #{i}",
                 n_rows=EPSILON_ROWS, oracle=big_oracle) for i in range(2)]
    if rel[0].reuse_hit or not (rel[1].reuse_hit and rel[1].plan_reuse_hit):
        raise AssertionError("[sparse] the repeated Epsilon rel+reuse query "
                             "did not hit both caches")
    for algorithm in ("hummingbird_pallas", "quickscorer_pallas"):
        query(engine, "epsilon", big, "rel+reuse", algorithm,
              f"epsilon rel+reuse {algorithm}", n_rows=EPSILON_ROWS,
              oracle=big_oracle)
    # the wide-row kernels' and the transpose's record numbers, at the
    # Epsilon shape
    record = {}
    part = tree_slice(big, 0, 16)
    transpose_ms = cuda_ms(lambda: feature_major(eps.data), warmup=1,
                           reps=3)
    got, want = feature_major(eps.data), feature_major_plain(eps.data)
    plain_ms = cuda_ms(lambda: feature_major_plain(eps.data), warmup=1,
                       reps=3)
    library_ms = cuda_ms(lambda: eps.data.t().contiguous(), warmup=1,
                         reps=3)
    B = eps.data.shape[0]
    nbytes = 4 * EPSILON_F * (B + wide_ldx(B))
    err = nan_err(got, want)
    log(f"[sparse] timing feature-major transpose: {B} rows x {EPSILON_F} "
        f"features -> {tuple(got.shape)}: kernel {transpose_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (x.t().contiguous()) "
        f"{library_ms:.4f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms by bytes ({nbytes} B read and written), max_abs_err {err!r}: "
        f"{'ok' if torch.equal(bits(got), bits(want)) else 'FAIL'}; on {smi}")
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError("[sparse] the transpose at the Epsilon shape")
    record["feature_major_wide"] = dict(
        max_abs_err=err, ms=transpose_ms, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms)
    del got, want
    for kind in KINDS:
        for fused in (True, False):
            variant = "fused" if fused else "raw"
            args, tiles = prepare_inputs(kind, f if fused else part,
                                         eps.data, fused=fused)
            wrapper = (KERNEL_WRAPPERS if fused
                       else RAW_KERNEL_WRAPPERS)[kind]
            ms = cuda_ms(lambda: wrapper(*args, **tiles), warmup=1, reps=3)
            if wide_tiled(kind, fused):
                design = (f"wide-tiled: {WIDE_ROWS}-row blocks, "
                          f"{tiles['block_b'] // 32} warps over "
                          f"{tiles['block_t']}-tree tiles, feature-major x; "
                          f"the transpose {transpose_ms:.4f} ms = "
                          f"{transpose_ms / ms:.1%} of the kernel ms")
            else:
                design = (f"row-major: {tiles['block_b']}-thread blocks, "
                          f"{tiles['block_t']}-tree tiles, no transpose")
            got = wrapper(*args, **tiles)
            want, plain_ms = timed_plain((plain if fused
                                          else raw_plain)[kind], args,
                                         DEPTH)
            err = float((got - want).abs().max())
            ok = (torch.allclose(got, want, rtol=TOL, atol=TOL) if fused
                  else torch.equal(bits(got), bits(want)))
            B, T = eps.data.shape[0], args[1].shape[0]
            bound_ms, bound_by, parts = bound(kind, B, EPSILON_F, T,
                                              raw=not fused)
            log(f"[sparse] timing {kind} {variant} wide-row x: {B} rows x "
                f"{EPSILON_F} features x {T} trees, tiles {tiles} "
                f"({design}): kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({parts}), max_abs_err "
                f"{err!r}: {'ok' if ok else 'FAIL'}; on {smi}")
            if not ok or tiles["staged"]:
                raise AssertionError(f"[sparse] {kind} {variant} at the "
                                     f"Epsilon shape")
            record[f"{kind}_{variant}_wide"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)
            del args, got, want
    store.drop("epsilon")
    del eps, sample, oracle, big_oracle, engine, store, rel

    # -- Bosch: CSR against dense, device / host / disk tiers --------------
    t0 = time.perf_counter()
    x = card_rows(BOSCH_ROWS, BOSCH_F, seed=SEED + 40, missing=BOSCH_MISSING)
    f, big = forests(BOSCH_F, SEED + 41)
    dev_store = TensorBlockStore(device="cuda")
    dense = dev_store.put("dense", x)
    csr = dev_store.put_sparse("csr", x)
    oracle = predict_proba(f, x[:COMPARE_ROWS], algorithm="predicated")
    del x
    torch.cuda.synchronize()
    f_used = compact_forest(f)[1].numel()
    log(f"[sparse] bosch: {BOSCH_ROWS} x {BOSCH_F}, {BOSCH_MISSING:.0%} "
        f"missing: dense {dense.nbytes} B, CSR {csr.nbytes} B "
        f"({csr.nbytes / dense.nbytes:.4f} of dense; {csr.nnz} entries, "
        f"capacity {csr.pages.capacity} a page of {csr.page_rows} rows); "
        f"F_used {f_used} (500 trees), "
        f"{compact_forest(big)[1].numel()} (1600); "
        f"{time.perf_counter() - t0:.3f} s set-up")
    runs = (("udf", "predicated_pallas_fused", f),
            ("udf", "hummingbird_pallas_fused", f),
            ("rel+reuse", "predicated_pallas", big),
            ("rel+reuse", "predicated_pallas", big))

    def bosch(engine, dataset: str, tier: str, fmt: str, want=None):
        out = []
        for i, (plan, algorithm, forest_) in enumerate(runs):
            r = query(engine, dataset, forest_, plan, algorithm,
                      f"bosch {tier} {fmt} {plan} {algorithm} #{i}",
                      n_rows=BOSCH_ROWS,
                      oracle=oracle if i == 0 and want is None else None)
            if (r.storage_format, r.tier) != (fmt, tier):
                raise AssertionError(f"[sparse] bosch ran {r.storage_format}"
                                     f" on {r.tier}")
            if i == 3 and not (r.reuse_hit and r.plan_reuse_hit):
                raise AssertionError("[sparse] the repeated rel+reuse query "
                                     "missed a cache")
            preds = r.predictions.cpu()
            if want is not None and not torch.equal(bits(preds),
                                                    bits(want[i])):
                raise AssertionError(f"[sparse] bosch {tier} {fmt} "
                                     f"{algorithm} differs from the device "
                                     f"tier's dense predictions")
            out.append(preds)
        return out

    engine = fresh_engine(dev_store)
    want = bosch(engine, "dense", "device", "dense")
    bosch(engine, "csr", "device", "csr", want)
    log("[sparse] bosch device tier: CSR == dense bit for bit, every query")
    spill = tempfile.mkdtemp(prefix="chip-smoke-sparse-")
    try:
        host_store = TensorBlockStore(device="cuda",
                                      device_budget_bytes=TIER_BUDGET)
        host_engine = fresh_engine(host_store)
        for fmt in ("dense", "csr"):
            t0 = time.perf_counter()
            if fmt == "dense":
                ds = host_store.put("dense", dense.data[:BOSCH_ROWS])
            else:
                ds = host_store.put_sparse("csr", pages=csr.pages,
                                           num_rows=BOSCH_ROWS)
            if ds.tier != "host":
                raise AssertionError(f"[sparse] the auto cascade put {fmt} "
                                     f"on {ds.tier}")
            log(f"[sparse] bosch host tier {fmt}: {ds.nbytes} B pinned in "
                f"{time.perf_counter() - t0:.3f} s (set-up); "
                f"{pinned_bytes()}")
            bosch(host_engine, fmt, "host", fmt, want)
            # where a streamed scan's time goes: the kernel, the gather's
            # torch ops, the page copies (a copy stream beside the kernels,
            # so the busy share is the union of the device intervals)
            prof, wall_us = traced(lambda: host_engine.infer(
                fmt, f, plan="udf", algorithm="predicated_pallas_fused"))
            log(f"[profile] bosch host-tier {fmt} udf "
                f"predicated_pallas_fused: {scan_trace(prof, wall_us)}; on "
                f"{smi}")
            log_device_time(prof, top=10)
            del prof
            host_store.drop(fmt)
            del ds
            gc.collect()
        log("[sparse] bosch host tier: CSR == dense == the device tier, "
            "bit for bit")
        disk_store = TensorBlockStore(device="cuda",
                                      device_budget_bytes=TIER_BUDGET,
                                      host_budget_bytes=TIER_BUDGET,
                                      spill_dir=spill)
        t0 = time.perf_counter()
        ds = disk_store.put_sparse("csr", pages=csr.pages,
                                   num_rows=BOSCH_ROWS)
        log(f"[sparse] bosch disk tier csr: {ds.nbytes} B in "
            f"{sorted(os.listdir(spill))} in {time.perf_counter() - t0:.3f} "
            f"s (set-up)")
        if ds.tier != "disk" or len(os.listdir(spill)) != 3:
            raise AssertionError("[sparse] the CSR table is not three spill "
                                 "files on the disk tier")
        bosch(fresh_engine(disk_store), "csr", "disk", "csr", want)
        disk_store.drop("csr")
        if os.listdir(spill):
            raise AssertionError("[sparse] drop left a spill file")
        log("[sparse] bosch disk tier: CSR == the device tier's dense, bit "
            "for bit; spill files removed")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    del ds, dense, csr, want, oracle, engine, dev_store, host_store
    gc.collect()
    torch.cuda.empty_cache()

    # -- Criteo-shaped: CSR only, 2M x 10,000 at 96 % missing ----------------
    t0 = time.perf_counter()
    chunk = CRITEO_BATCH_PAGES * PAGE_ROWS
    gen_seed = SEED + 50
    blocks = []
    for lo in range(0, CRITEO_ROWS, chunk):
        n = min(chunk, CRITEO_ROWS - lo)
        x = card_rows(n, CRITEO_F, seed=gen_seed + lo // chunk,
                      missing=CRITEO_MISSING)
        blocks.append(paginate_csr(*csr_from_dense(x), num_rows=n,
                                   page_rows=PAGE_ROWS, n_features=CRITEO_F))
        del x
    pages = concat_pages(blocks, n_features=CRITEO_F)
    del blocks
    store = TensorBlockStore(device="cuda")
    ds = store.put_sparse("criteo", pages=pages, num_rows=CRITEO_ROWS)
    if ds.pages.indices is not pages.indices:
        raise AssertionError("[sparse] a device-tier pages= handoff copied")
    f, _ = forests(CRITEO_F, SEED + 51)
    torch.cuda.synchronize()
    gather_idx = compact_forest(f)[1]
    log(f"[sparse] criteo: {CRITEO_ROWS} x {CRITEO_F}, {CRITEO_MISSING:.0%} "
        f"missing, made on the card in {chunk}-row chunks: CSR {ds.nbytes} B "
        f"on the device tier ({ds.nnz} entries, capacity "
        f"{ds.pages.capacity}; dense would be {CRITEO_ROWS * CRITEO_F * 4} "
        f"B); F_used {gather_idx.numel()}; "
        f"{time.perf_counter() - t0:.3f} s set-up")
    engine = fresh_engine(store)
    inv = gather_inverse_map(gather_idx, CRITEO_F, device="cuda")
    block = ds.page_slice(0, CRITEO_BATCH_PAGES)
    gather_ms = cuda_ms(lambda: csr_block_to_dense(block, inv,
                                                   gather_idx.numel()),
                        warmup=1, reps=3)
    head = {}
    for algorithm in ("predicated_pallas_fused", "hummingbird_pallas_fused"):
        r = query(engine, "criteo", f, "udf", algorithm,
                  f"criteo csr udf {algorithm}", n_rows=CRITEO_ROWS,
                  batch_pages=CRITEO_BATCH_PAGES)
        if r.storage_format != "csr":
            raise AssertionError("[sparse] criteo did not run the CSR plane")
        stage_s = sum(x.seconds for x in r.stage_reports)
        share = r.scan.batches * gather_ms / 1e3 / stage_s
        log(f"[sparse] criteo udf {algorithm}: {CRITEO_ROWS / r.total_s:.1f}"
            f" rows/s (total_s {r.total_s:.6f}); the gather of one "
            f"{CRITEO_BATCH_PAGES}-page block {gather_ms:.4f} ms (CUDA "
            f"events), x {r.scan.batches} batches = {share:.4f} of the "
            f"stage time {stage_s:.6f} s; on {smi}")
        head[algorithm] = r.predictions[:chunk].clone()
        del r
    dense_head = densify_csr(*block.tensors(), CRITEO_F)
    dstore = TensorBlockStore(device="cuda")
    dstore.put("criteo_head", dense_head)
    del dense_head
    dengine = fresh_engine(dstore)
    for algorithm, want in head.items():
        r = query(dengine, "criteo_head", f, "udf", algorithm,
                  f"criteo dense head udf {algorithm}", n_rows=chunk)
        if not torch.equal(bits(r.predictions), bits(want)):
            raise AssertionError(f"[sparse] criteo {algorithm}: CSR and the "
                                 f"densified head differ")
        log(f"[sparse] criteo {algorithm}: CSR == the dense plane (F="
            f"{CRITEO_F}, full forest) on the first {chunk} rows, bit for "
            f"bit")
    store.drop("criteo")
    dstore.drop("criteo_head")
    return record


def register_report(text: str) -> dict[bool, set]:
    """ptxas's register lines of one library, split by the kernels' node
    record: {False: the f32 instantiations' (and the transpose's), True:
    the bf16 ones'} (the record is the last template argument,
    ``NARROW``: a mangled name whose template arguments end ``Lb1E``)."""
    import re

    out: dict[bool, set] = {False: set(), True: set()}
    narrow = None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            narrow = re.search(r"Lb1EEEv", m.group(1)) is not None
        elif "registers" in ln and narrow is not None:
            out[narrow].add(ln.split(":", 1)[1].strip())
            narrow = None
    return out


def timing_line(t) -> str:
    return (f"parse_s {t.parse_s:.6f}, convert_s {t.convert_s:.6f}, "
            f"transfer_s {t.transfer_s:.6f}, total_s {t.total_s:.6f}")


def host_s(fn):
    """``fn()`` timed on the host clock, ending in a device synchronise:
    (its result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def load_phase(*, counted, only, smi: str, tally) -> None:
    """Phase 10: the paper's external load (parse, convert, transfer, then
    inference over the loaded tensor) against in-database inference over
    the same rows already in the store.  ``tally(counts)`` adds each
    query's launches to the kernels' record."""
    from repro_torch.core.forest import make_forest
    from repro_torch.core.postprocess import postprocess
    from repro_torch.db import loader as ld
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.kernels.ops import predicated_pallas_fused

    def forest_over(F: int, trees: int, seed: int):
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(seed),
                                            integer_leaves=False,
                                            trees=trees, features=F)
        return make_forest(fe, th, lv, default_left=dl, n_features=F,
                           model_type="xgboost", task="classification",
                           device="cuda")

    def written(path: str, what: str, t0: float) -> None:
        log(f"[load] set-up: {what} written to {os.path.basename(path)}, "
            f"{os.path.getsize(path)} B, in {time.perf_counter() - t0:.3f} "
            f"s (untimed)")

    def loaded(name: str, t, nbytes: int) -> None:
        rate = (f", {nbytes / t.transfer_s / 1e9:.2f} GB/s"
                if t.transfer_s else "")
        log(f"[load] {name} LoadTiming {timing_line(t)} ({nbytes} B "
            f"on the tier{rate}); on {smi}")

    def udf(engine, dataset, forest, algorithm, label, n_rows, **kw):
        """One counted in-database query: exact launches, finite
        predictions of the right shape."""
        kind = algorithm.split("_")[0]
        r, c = counted(lambda: engine.infer(dataset, forest, plan="udf",
                                            algorithm=algorithm, **kw))
        only(c, f"{kind}_fused", r.scan.batches, f"[load] {label}")
        tally(c)
        if tuple(r.predictions.shape) != (n_rows,) or not bool(
                torch.isfinite(r.predictions).all()):
            raise AssertionError(f"[load] {label}: bad predictions")
        log(f"[load] run {label}: total_s {r.total_s:.6f}, tier {r.tier}, "
            f"storage_format {r.storage_format}, {r.scan.batches} batches "
            f"= {c[f'{kind}_fused']} {kind}_fused launches "
            f"({c[f'{kind}_fused_wide']} wide-row), plan_reuse_hit "
            f"{r.plan_reuse_hit}; stages {stage_sums(r)}; on {smi}")
        return r

    def external_against_in_database(what, rows, t_load, forest, engine,
                                     dataset):
        """The fused predicated kernel + postprocess over the loaded rows
        against the in-database udf query over the same rows: both
        breakdowns, the ratio, the predictions bit for bit."""
        def external():
            sums = predicated_pallas_fused(forest, rows)
            return postprocess(sums, model_type=forest.model_type,
                               task=forest.task, num_trees=forest.num_trees,
                               base_score=forest.base_score)

        external()          # builds the forest's kernel trees, kept after
        (ext, infer_s), c = counted(lambda: host_s(external))
        only(c, "predicated_fused", 1, f"[load] {what} external inference")
        tally(c)
        n = rows.shape[0]
        label = f"{what} in-database udf predicated_pallas_fused"
        first = udf(engine, dataset, forest, "predicated_pallas_fused",
                    f"{label} #0", n)
        repeat = udf(engine, dataset, forest, "predicated_pallas_fused",
                     f"{label} #1", n)
        if not torch.equal(bits(ext), bits(repeat.predictions)):
            raise AssertionError(f"[load] {what}: the external and the "
                                 f"in-database predictions differ")
        ext_s = t_load.total_s + infer_s
        log(f"[load] ratio {what}: external {ext_s:.6f} s (load "
            f"{t_load.total_s:.6f}: {timing_line(t_load)}; inference "
            f"{infer_s:.6f}) / in-database {repeat.total_s:.6f} s (repeat; "
            f"first {first.total_s:.6f}) = {ext_s / repeat.total_s:.1f}; "
            f"predictions bit-identical over {n} rows; on {smi}")

    tmp = tempfile.mkdtemp(prefix="chip-smoke-load-")
    try:
        # -- HIGGS as CSV, at the small and the large model ------------------
        t0 = time.perf_counter()
        x = card_rows(LOAD_HIGGS_ROWS, FEATURES, seed=SEED + 60).cpu().numpy()
        csv = os.path.join(tmp, "higgs.csv")
        ld.write_csv(csv, x)
        written(csv, f"HIGGS {LOAD_HIGGS_ROWS} x {FEATURES} as CSV", t0)
        del x
        rows, t_csv = ld.load_csv_external(csv, device="cuda")
        loaded("load_csv_external higgs", t_csv, rows.nbytes)
        if not (rows.is_cuda and tuple(rows.shape)
                == (LOAD_HIGGS_ROWS, FEATURES)):
            raise AssertionError("[load] the CSV did not land on the card")
        store = TensorBlockStore(device="cuda")
        store.put("higgs_csv", rows)
        engine = fresh_engine(store)
        for trees in LOAD_TREES:
            external_against_in_database(
                f"higgs {trees} trees", rows, t_csv,
                forest_over(FEATURES, trees, SEED + 61 + trees), engine,
                "higgs_csv")
        store.drop("higgs_csv")
        del rows

        # -- Criteo-shaped LIBSVM onto every tier -----------------------------
        t0 = time.perf_counter()
        n, F = LOAD_CRITEO_ROWS, CRITEO_F
        x = card_rows(n, F, seed=SEED + 62, missing=CRITEO_MISSING)
        y = (torch.rand(n, generator=torch.Generator().manual_seed(SEED))
             < 0.5).float().numpy()
        svm = os.path.join(tmp, "criteo.svm")
        ld.write_libsvm(svm, x.cpu().numpy(), y)
        written(svm, f"Criteo-shaped {n} x {F} at {CRITEO_MISSING:.0%} "
                f"missing as LIBSVM ({int(torch.isfinite(x).sum())} "
                f"entries)", t0)
        del x
        dense, labels, t_dense = ld.load_libsvm_external(svm, F,
                                                         device="cuda")
        loaded("load_libsvm_external criteo (dense fallback)", t_dense,
               dense.nbytes)
        if not np.array_equal(labels, y):
            raise AssertionError("[load] the LIBSVM labels differ")
        forest = forest_over(F, TREES, SEED + 63)
        want = {}
        # the same rows, put_sparse(data=) on the device tier
        store.put_sparse("criteo_rows", data=dense, tier="device")
        for algorithm in ("predicated_pallas_fused",
                          "hummingbird_pallas_fused"):
            for i in range(2):      # the repeat is the in-database time
                want[algorithm] = udf(
                    engine, "criteo_rows", forest, algorithm,
                    f"criteo put_sparse(data=) device udf {algorithm} #{i}",
                    n, batch_pages=LOAD_CRITEO_BATCH_PAGES)
        del dense
        store.drop("criteo_rows")
        for tier in ("device", "host", "disk"):
            pages, labels, t = ld.load_libsvm_csr_external(
                svm, F, page_rows=PAGE_ROWS, tier=tier, spill_dir=tmp,
                device="cuda")
            loaded(f"load_libsvm_csr_external criteo tier={tier}", t,
                   pages.nbytes)
            ds = store.put_sparse(f"criteo_{tier}", pages=pages,
                                  num_rows=n, labels=labels, tier=tier)
            handed = all(a is b for a, b in zip(ds.pages.arrays(),
                                                pages.arrays()))
            where = dict(device=lambda a: a.is_cuda,
                         host=lambda a: a.is_pinned(),
                         disk=lambda a: isinstance(a, np.memmap))[tier]
            if not (handed and all(map(where, pages.arrays()))
                    and ds.tier == tier) or (
                    tier != "device" and t.transfer_s != 0.0):
                raise AssertionError(f"[load] the {tier}-tier load was not "
                                     f"handed over zero-copy")
            names = sorted(os.path.basename(a.filename)
                           for a in pages.arrays()) if tier == "disk" else ""
            log(f"[load] criteo tier={tier}: put_sparse(pages=) zero-copy "
                f"(every array 'is' the loader's), transfer_s "
                f"{t.transfer_s!r} {names}")
            for algorithm, ref in want.items():
                r = udf(engine, f"criteo_{tier}", forest, algorithm,
                        f"criteo {tier} csr udf {algorithm}", n,
                        batch_pages=LOAD_CRITEO_BATCH_PAGES)
                if not torch.equal(bits(r.predictions.cpu()),
                                   bits(ref.predictions.cpu())):
                    raise AssertionError(f"[load] criteo {tier} "
                                         f"{algorithm}: not put_sparse("
                                         f"data=)'s predictions")
                log(f"[load] ratio criteo {tier} {algorithm}: external "
                    f"{t.total_s + r.total_s:.6f} s (load {t.total_s:.6f} "
                    f"+ query {r.total_s:.6f}) / in-database "
                    f"{ref.total_s:.6f} s = "
                    f"{(t.total_s + r.total_s) / ref.total_s:.1f}; "
                    f"predictions bit for bit put_sparse(data=)'s")
            store.drop(f"criteo_{tier}")
            del ds, pages
            gc.collect()

        # -- Epsilon as array rows ------------------------------------------
        t0 = time.perf_counter()
        x = card_rows(LOAD_EPSILON_ROWS, EPSILON_F,
                      seed=SEED + 64).cpu().numpy()
        arr = os.path.join(tmp, "epsilon.arr")
        ld.write_array_rows(arr, x)
        written(arr, f"Epsilon {LOAD_EPSILON_ROWS} x {EPSILON_F} as array "
                f"rows", t0)
        del x
        rows, t_arr = ld.load_array_rows_external(arr, device="cuda")
        loaded("load_array_rows_external epsilon", t_arr, rows.nbytes)
        store.put("epsilon_arr", rows)
        external_against_in_database(
            f"epsilon {TREES} trees", rows, t_arr,
            forest_over(EPSILON_F, TREES, SEED + 65), engine, "epsilon_arr")
        store.drop("epsilon_arr")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def window_stats(reqs: list, due: np.ndarray, t0: float) -> dict:
    """One open-loop window's requests: latency from the scheduled arrival,
    queue wait (submit to coalesce), and how many were served within the
    window (by the last scheduled arrival plus 1/rate)."""
    lat = np.array([r.finished_at - d for r, d in zip(reqs, due)])
    wait = np.array([r.admitted_at - r.submitted_at for r in reqs])
    end = due[-1] + (due[-1] - due[0]) / max(len(due) - 1, 1)
    return dict(
        p50_ms=float(np.percentile(lat, 50)) * 1e3,
        p99_ms=float(np.percentile(lat, 99)) * 1e3,
        wait_p50_ms=float(np.percentile(wait, 50)) * 1e3,
        wait_p99_ms=float(np.percentile(wait, 99)) * 1e3,
        in_window=sum(r.finished_at <= end for r in reqs),
        span_s=max(r.finished_at for r in reqs) - t0)


def open_loop(submit, rate_hz: float, n: int) -> tuple[list, np.ndarray,
                                                       float]:
    """Call ``submit(i)`` for ``n`` requests on a fixed schedule (request
    i is due at t0 + i / rate on the perf_counter clock; a late loop
    submits at once): returns what each call returned, the schedule and
    t0."""
    t0 = time.perf_counter() + 0.01
    due = t0 + np.arange(n) / float(rate_hz)
    reqs = []
    for i in range(n):
        now = time.perf_counter()
        if now < due[i]:
            time.sleep(due[i] - now)
        reqs.append(submit(i))
    return reqs, due, t0


def serve_phase(*, rows: np.ndarray, forest, big, counted, only, smi: str,
                tally) -> None:
    """Phase 11: the forest serving plane on the card.  Four tenants in one
    ``ForestServeEngine`` over HIGGS-shaped request rows: a correctness
    pass, open-loop traffic with the ticker running, the per-request
    baseline, tenancy under a small plan cache, and shedding.
    ``tally(counts)`` adds each counted run's launches to the kernels'
    record."""
    from repro_torch.core.forest import make_forest
    from repro_torch.core.postprocess import predict_proba
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.obs import METRICS, TRACER
    from repro_torch.serve.forest import ForestServeEngine
    from repro_torch.serve.router import TIER_BATCH, TIER_INTERACTIVE

    def int_forest(seed: int):
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(seed),
                                            integer_leaves=True)
        return make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                           model_type="xgboost", task="regression",
                           device="cuda")

    # tenant: (forest, algorithm, plan, integer leaves, kernel record name)
    tenants = {
        "udf-pred": (int_forest(SEED + 21), "predicated_pallas_fused", "udf",
                     True, "predicated_fused"),
        "udf-hb": (forest, "hummingbird_pallas_fused", "udf", False,
                   "hummingbird_fused"),
        "udf-qs": (int_forest(SEED + 22), "quickscorer_pallas_fused", "udf",
                   True, "quickscorer_fused"),
        "rel": (big, "predicated_pallas", "rel+reuse", False,
                "predicated_raw"),
    }
    store = TensorBlockStore(device="cuda")
    eng = ForestServeEngine(store)
    t_reg = time.perf_counter()
    for name, (f_, alg, plan, _, _) in tenants.items():
        t0 = time.perf_counter()
        eng.register_model(name, f_, algorithm=alg, plan=plan)
        torch.cuda.synchronize()
        log(f"[serve] register_model('{name}', {f_.num_trees} trees, "
            f"algorithm='{alg}', plan='{plan}') with warmup over buckets "
            f"{eng.buckets}: {time.perf_counter() - t0:.3f} s")
    rel_parts = eng.qe._resolve_n_parts(big, "predicated_pallas", None)
    if rel_parts != REL_TREES // 16:
        raise AssertionError(f"rel tenant: {rel_parts} partitions, expected "
                             f"{REL_TREES // 16}")
    per_tick = {n: (rel_parts if t[2] == "rel+reuse" else 1)
                for n, t in tenants.items()}
    log(f"[serve] 4 tenants registered in {time.perf_counter() - t_reg:.3f} "
        f"s; launches a tick: {per_tick}")

    # -- 1. correctness pass: submit + drain, each tick held bit for bit --
    rng = np.random.default_rng(SEED + 23)
    for name, (f_, alg, plan, exact, kname) in tenants.items():
        sizes = rng.integers(1, 5, SERVE_CHECK_REQUESTS)
        starts = rng.integers(0, len(rows) - 4, SERVE_CHECK_REQUESTS)
        ticks0 = eng.stats(name)["ticks"]
        reqs, counts = counted(lambda: (
            [eng.submit(name, rows[s:s + k], priority=TIER_BATCH)
             for s, k in zip(starts, sizes)], eng.drain())[0])
        ticks = eng.stats(name)["ticks"] - ticks0
        only(counts, kname, ticks * per_tick[name],
             f"serve {name} correctness pass ({ticks} ticks)")
        tally(counts)
        # the ticks as the coalescer took them: FIFO prefixes of <= 128 rows
        groups, cur, n = [], [], 0
        for r in reqs:
            if n + r.num_rows > eng.buckets[-1]:
                groups.append(cur)
                cur, n = [], 0
            cur.append(r)
            n += r.num_rows
        groups.append(cur)
        if len(groups) != ticks:
            raise AssertionError(f"serve {name}: {ticks} ticks, expected "
                                 f"{len(groups)}")
        err = 0.0
        for group in groups:
            n = sum(r.num_rows for r in group)
            bucket = eng._bucket(n)
            x = np.zeros((bucket, FEATURES), np.float32)
            x[:n] = np.concatenate([r.rows for r in group])
            direct = eng.qe.infer_rows(
                f_, x, row_mask=np.arange(bucket) < n, algorithm=alg,
                plan=plan, model_id=eng._get(name).model_id)
            if not direct.plan_reuse_hit:
                raise AssertionError(f"serve {name}: the direct infer_rows "
                                     f"missed the plan cache")
            want = direct.predictions[:n]
            got = torch.from_numpy(np.concatenate(
                [r.wait(0) for r in group])).cuda()
            if got.shape != (n,) or not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"serve {name}: a tick differs from "
                                     f"infer_rows over its bucket")
            eager = predict_proba(f_, torch.from_numpy(x[:n]).cuda(),
                                  algorithm="predicated")
            err = max(err, float((got - eager).abs().max()))
            if exact and not torch.equal(bits(got), bits(eager)):
                raise AssertionError(f"serve {name}: integer leaves, not "
                                     f"bit for bit the eager oracle")
            if not torch.allclose(got, eager, rtol=TOL, atol=TOL):
                raise AssertionError(f"serve {name}: {err} off the eager "
                                     f"oracle")
        log(f"[serve] correctness {name}: {len(reqs)} requests of 1-4 rows "
            f"({int(sizes.sum())} rows) in {ticks} ticks, buckets "
            f"{[eng._bucket(sum(r.num_rows for r in g)) for g in groups]}; "
            f"each request bit for bit infer_rows over its padded bucket, "
            f"{counts[kname]} {kname} launches = {per_tick[name]} a tick, "
            f"no other kernel; max |served - eager predicated| = {err!r} "
            f"({'bit for bit' if exact else f'within {TOL}'})")

    # -- 2-3. open-loop traffic with the ticker running ---------------------
    from torch.profiler import ProfilerActivity, profile

    coalesced_p50: dict[int, float] = {}
    for name in ("udf-pred", "rel"):
        kname = tenants[name][4]
        m = eng._get(name)
        for rate in SERVE_RATES_HZ:
            n = int(rate * SERVE_WINDOW_S)
            keys = ("serve.ticks", "serve.padding_rows", "serve.shed",
                    "serve.plan_misses")
            before = {k: m.metrics.counter(k).value for k in keys}
            misses0 = METRICS.counter("plan.cache_misses").value
            torch.cuda.synchronize()

            def window():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    with eng:
                        reqs, due, t0 = open_loop(
                            lambda i: eng.submit(name, rows[i % len(rows)],
                                                 priority=TIER_INTERACTIVE),
                            rate, n)
                        for r in reqs:
                            r.done.wait(120.0)
                    torch.cuda.synchronize()
                return reqs, due, t0, prof

            (reqs, due, t0, prof), counts = counted(window)
            errors = [r for r in reqs if not r.done.is_set()
                      or r.error is not None]
            if errors:
                raise AssertionError(f"serve {name} at {rate} req/s: "
                                     f"{len(errors)} requests failed or "
                                     f"were not served: {errors[0].error!r}")
            d = {k: m.metrics.counter(k).value - before[k] for k in keys}
            if d["serve.plan_misses"] or \
                    METRICS.counter("plan.cache_misses").value != misses0:
                raise AssertionError(f"serve {name} at {rate} req/s: a plan "
                                     f"miss after warmup")
            only(counts, kname, d["serve.ticks"] * per_tick[name],
                 f"serve {name} at {rate} req/s ({d['serve.ticks']} ticks)")
            tally(counts)
            st = window_stats(reqs, due, t0)
            every, kernels, _ = device_intervals(prof)
            busy_k, busy = union_us(kernels) / 1e3, union_us(every) / 1e3
            window_ms = st["span_s"] * 1e3
            if name == "udf-pred":
                coalesced_p50[rate] = st["p50_ms"]
            log(f"[serve] traffic {name} {rate} req/s x {SERVE_WINDOW_S} s: "
                f"submitted {n}, served in the window {st['in_window']} "
                f"({st['in_window'] / n:.4f}), served in all {n} (1.0); "
                f"latency from scheduled arrival p50 {st['p50_ms']:.4f} ms "
                f"p99 {st['p99_ms']:.4f} ms; queue wait p50 "
                f"{st['wait_p50_ms']:.4f} ms p99 {st['wait_p99_ms']:.4f} ms; "
                f"ticks {d['serve.ticks']}, mean coalesce width "
                f"{n / max(d['serve.ticks'], 1):.2f}, padding rows "
                f"{d['serve.padding_rows']}, shed {d['serve.shed']}, plan "
                f"misses 0; throughput {n / st['span_s']:.1f} req/s over "
                f"{window_ms:.3f} ms; kernels busy {busy_k:.3f} ms = "
                f"{100 * busy_k / window_ms:.2f} % of the window (device "
                f"incl. copies {100 * busy / window_ms:.2f} %, CUDA-only "
                f"profiler); {counts[kname]} {kname} launches = "
                f"{per_tick[name]} a tick, no other kernel; on {smi}")

    # steady state, traced: serve.tick spans = ticks, no plan.build
    m = eng._get("udf-pred")
    ticks0 = m.metrics.counter("serve.ticks").value
    TRACER.reset()
    TRACER.enable()
    try:
        with eng:
            reqs, _, _ = open_loop(
                lambda i: eng.submit("udf-pred", rows[i],
                                     priority=TIER_INTERACTIVE), 800, 400)
            for r in reqs:
                r.wait(60.0)
    finally:
        TRACER.disable()
    spans = [s.name for s in TRACER.finished()]
    ticks = m.metrics.counter("serve.ticks").value - ticks0
    if spans.count("serve.tick") != ticks or "plan.build" in spans or \
            spans.count("query.infer_rows") != ticks:
        raise AssertionError(f"serve traced window: {ticks} ticks, spans "
                             f"{ {s: spans.count(s) for s in set(spans)} }")
    log(f"[serve] traced window udf-pred 400 requests at 800 req/s: {ticks} "
        f"serve.tick / serve.coalesce / query.infer_rows spans each, no "
        f"plan.build")
    TRACER.reset()

    # -- 4. per-request baseline: put one row, infer, read back -------------
    f_pred = tenants["udf-pred"][0]
    bstore = TensorBlockStore(device="cuda")
    bengine = fresh_engine(bstore)
    bstore.put("req", rows[:1])
    bengine.infer("req", f_pred, algorithm="predicated_pallas_fused")
    for rate in SERVE_RATES_HZ[:3]:
        n = min(int(rate * SERVE_WINDOW_S), SERVE_BASELINE_MAX)

        def baseline():
            def one(i: int) -> float:
                bstore.put("req", rows[i:i + 1])
                res = bengine.infer("req", f_pred,
                                    algorithm="predicated_pallas_fused")
                res.predictions.cpu()
                return time.perf_counter()

            done, due, t0 = open_loop(one, rate, n)
            return np.array(done) - due, done[-1] - t0

        (lat, span), counts = counted(baseline)
        only(counts, "predicated_fused", n, f"baseline at {rate} req/s")
        tally(counts)
        p50 = float(np.percentile(lat, 50)) * 1e3
        log(f"[serve] baseline {rate} req/s: {n} requests of store.put(1 "
            f"row) + infer(udf, predicated_pallas_fused) + read-back: p50 "
            f"{p50:.4f} ms p99 {float(np.percentile(lat, 99)) * 1e3:.4f} ms "
            f"from scheduled arrival, throughput {n / span:.1f} req/s; "
            f"coalesced / baseline p50 {coalesced_p50[rate] / p50:.4f}; on "
            f"{smi}")
    del bstore, bengine

    # -- 5. tenancy: a fourth tenant evicts the coldest plan ----------------
    teng = ForestServeEngine(TensorBlockStore(device="cuda"), buckets=(8,),
                             max_plans=3, algorithm="predicated_pallas_fused")
    x = rows[:4]

    def tenancy():
        teng.register_model("a", f_pred)
        first = teng.predict("a", x)
        for i, f_ in enumerate((tenants["udf-qs"][0], forest, big)):
            teng.register_model(f"b{i}", f_)
        misses0 = METRICS.counter("plan.cache_misses").value
        again = teng.predict("a", x)
        return first, again, METRICS.counter("plan.cache_misses").value \
            - misses0

    (first, again, missed), counts = counted(tenancy)
    ticks = sum(s["ticks"] for s in teng.stats()["per_model"].values())
    warm = 4                        # one warmup call a tenant, bucket 8
    only(counts, "predicated_fused", ticks + warm, "serve tenancy")
    tally(counts)
    if missed != 1 or teng.stats("a")["plan_misses"] != 1 or \
            not np.array_equal(first.view(np.int32), again.view(np.int32)):
        raise AssertionError(f"serve tenancy: {missed} plan misses, "
                             f"re-served bit for bit: "
                             f"{np.array_equal(first, again)}")
    log(f"[serve] tenancy: max_plans=3, buckets (8,): tenants b0-b2 evicted "
        f"a's plan; a's next request a plan miss ({missed}), re-served bit "
        f"for bit; {counts['predicated_fused']} launches")
    del teng

    # -- 6. shedding: a timeout below the interactive deadline --------------
    m = eng._get("udf-pred")
    shed0 = m.metrics.counter("serve.shed").value

    def shed_run():
        with eng:
            req = eng.submit("udf-pred", rows[7], priority=TIER_INTERACTIVE,
                             timeout_s=eng.interactive_deadline_s / 4)
            req.wait(30.0)
        return req

    req, counts = counted(shed_run)
    only(counts, "predicated_fused", 1, "serve shed")
    tally(counts)
    x8 = np.zeros((8, FEATURES), np.float32)
    x8[0] = rows[7]
    want = eng.qe.infer_rows(f_pred, x8, row_mask=np.arange(8) < 1,
                             algorithm="predicated_pallas_fused",
                             model_id=m.model_id).predictions[:1].cpu()
    waited = req.finished_at - req.submitted_at
    if not (req.shed and req.priority == TIER_BATCH
            and m.metrics.counter("serve.shed").value == shed0 + 1
            and waited >= eng.batch_deadline_s
            and torch.equal(bits(torch.from_numpy(req.predictions)),
                            bits(want))):
        raise AssertionError(f"serve shed: shed={req.shed}, waited "
                             f"{waited} s")
    log(f"[serve] shed: an interactive request with timeout_s "
        f"{eng.interactive_deadline_s / 4} s (deadline "
        f"{eng.interactive_deadline_s} s) shed to the batch tier, counted, "
        f"served after {waited * 1e3:.3f} ms (batch deadline "
        f"{eng.batch_deadline_s * 1e3:.1f} ms), bit for bit infer_rows")
    if METRICS.counter("serve.queue_depth").value != 0:
        raise AssertionError("serve.queue_depth did not return to 0")


def kernel_name(algorithm: str) -> str:
    """The launch-count name of a kernel algorithm's wrapper."""
    kind = algorithm.split("_")[0]
    return f"{kind}_fused" if algorithm.endswith("_fused") else f"{kind}_raw"


def rank_disagreements(predicted: dict, measured: dict) -> list:
    """Pairs of cells that the analytic model and the card order
    differently (each pair once)."""
    cells = sorted(predicted)
    return [(a, b) for i, a in enumerate(cells) for b in cells[i + 1:]
            if (predicted[a] < predicted[b]) != (measured[a] < measured[b])]


def optimizer_phase(*, counted, only, smi: str, tally,
                    link_gbps: float) -> None:
    """Phase 12: the cost-based optimizer on the card.  The calibrated
    peaks; a regret grid over the paper's quadrants (every static cell
    against ``plan="auto", algorithm="auto"``); tier advice on a host-tier
    table and ``auto_move``; a served tenant registered with ``"auto"``
    under open-loop traffic.  ``tally(counts)`` adds each counted run's
    launches to the kernels' record."""
    from repro_torch.core.forest import make_forest
    from repro_torch.db.optimizer import CUDA_ALGORITHMS, DEFAULT_PLANS
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.launch import roofline
    from repro_torch.obs import METRICS
    from repro_torch.serve.forest import ForestServeEngine
    from repro_torch.serve.router import TIER_INTERACTIVE

    def forest_of(trees: int, seed: int, integer: bool):
        """Random depth-8 trees; integer leaves make a regression forest,
        whose every cell's sums are exact (so any two cells agree bit for
        bit)."""
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(seed),
                                            integer_leaves=integer,
                                            trees=trees)
        return make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                           task="regression" if integer else
                           "classification", device="cuda")

    def opt_counters() -> dict:
        return {k: METRICS.counter(f"optimizer.{k}").value for k in (
            "decisions", "decision_cache_hits", "decision_cache_misses",
            "autotune_runs", "measurements")}

    # -- peaks ------------------------------------------------------------
    t0 = time.perf_counter()
    # raises unless its H2D source is pinned (roofline.h2d_source)
    peaks = roofline.calibrate_peaks("cuda")
    cal_s = time.perf_counter() - t0
    bad = [k for k in PEAK_KEYS if not peaks.get(k, 0) > 0]
    if bad or not peaks["measured"]:
        raise AssertionError(f"[optimizer] peaks missing or not positive: "
                             f"{bad}")
    log(f"[optimizer] calibrated peaks of {peaks['backend']} in "
        f"{cal_s:.3f} s on {smi}: f32 512x512 matmul "
        f"{peaks['peak_flops_bf16'] / 1e12:.4f} TFLOP/s (key "
        f"peak_flops_bf16); 32 MiB add {peaks['hbm_bandwidth'] / 1e9:.3f} "
        f"GB/s (hbm_bandwidth = ici_bandwidth); 16 MiB row gather "
        f"{peaks['gather_bandwidth'] / 1e9:.3f} GB/s; 16 MiB pinned H2D "
        f"{peaks['h2d_bandwidth'] / 1e9:.3f} GB/s beside phase 8's plain "
        f"pinned {LINK_BYTES} B copy {link_gbps:.3f} GB/s; dispatch "
        f"{peaks['dispatch_s'] * 1e6:.3f} us")

    # -- regret grid ------------------------------------------------------
    cells = [(a, p) for a in CUDA_ALGORITHMS for p in DEFAULT_PLANS]
    store = TensorBlockStore(device="cuda")
    for qi, trees in enumerate(OPT_TREES):
        forest = forest_of(trees, SEED + 60 + qi, integer=False)
        for ri, rows in enumerate(OPT_ROWS):
            name = f"q{trees}x{rows}"
            store.put(name, card_rows(rows, FEATURES, seed=SEED + 62 + ri))
            static_eng = fresh_engine(store)
            walls, static_counts = {}, {}
            for alg, plan in cells:
                def runs():
                    out = []
                    for _ in range(1 + OPT_STATIC_RUNS):
                        t1 = time.perf_counter()
                        r = static_eng.infer(name, forest, algorithm=alg,
                                             plan=plan)
                        out.append((time.perf_counter() - t1, r))
                    return out

                out, counts = counted(runs)
                tally(counts)
                walls[(alg, plan)] = min(w for w, _ in out[1:])
                static_counts[(alg, plan)] = counts[kernel_name(alg)] // \
                    len(out)
                del out
            auto_eng = fresh_engine(store)
            predicted = {(c.algorithm, c.plan): c.predicted_s for c in
                         auto_eng.optimizer.scored_cells(name, forest)}
            before = opt_counters()

            def first_auto():
                t1 = time.perf_counter()
                r = auto_eng.infer(name, forest, plan="auto",
                                   algorithm="auto")
                return r, time.perf_counter() - t1

            (res, first_s), counts = counted(first_auto)
            tally(counts)
            d = res.decision
            mid = opt_counters()
            kname = kernel_name(d.algorithm)
            static = static_eng.infer(name, forest, **d.overrides())
            want_launches = (d.n_parts or 1) * static.scan.batches

            def repeats():
                out = []
                for _ in range(OPT_AUTO_REPEATS):
                    t1 = time.perf_counter()
                    r = auto_eng.infer(name, forest, plan="auto",
                                       algorithm="auto")
                    out.append((time.perf_counter() - t1, r))
                return out

            reps, counts = counted(repeats)
            only(counts, kname, OPT_AUTO_REPEATS * want_launches,
                 f"[optimizer] {name} auto repeats")
            tally(counts)
            after = opt_counters()
            if after["autotune_runs"] != mid["autotune_runs"] or \
                    after["decision_cache_hits"] - \
                    mid["decision_cache_hits"] < OPT_AUTO_REPEATS:
                raise AssertionError(f"[optimizer] {name}: repeats "
                                     f"re-decided: {mid} -> {after}")
            for _, r in reps:
                if r.decision != d or not torch.equal(
                        bits(r.predictions), bits(static.predictions)):
                    raise AssertionError(f"[optimizer] {name}: the auto "
                                         f"query is not bit for bit its "
                                         f"decided cell's static run")
            if d.algorithm not in CUDA_ALGORITHMS:
                raise AssertionError(f"[optimizer] {name}: chose "
                                     f"{d.algorithm}")
            steady = min(w for w, _ in reps)
            best = min(walls, key=walls.get)
            worst = max(walls, key=walls.get)
            regret = steady / walls[best]
            measured_rank = sorted(walls, key=walls.get)
            analytic_rank = sorted(predicted, key=predicted.get)
            disagree = rank_disagreements(predicted, walls)
            log(f"[optimizer] {name} ({trees} trees x {rows} rows, device "
                f"tier): decision {d.algorithm} / {d.plan} n_parts "
                f"{d.n_parts} batch_pages {d.batch_pages} tier {d.tier}, "
                f"source {d.source}, cells_scored {d.cells_scored}, "
                f"cells_measured {d.cells_measured}, first call (decide + "
                f"query) {first_s:.6f} s, counters {before} -> {mid}; "
                f"steady auto {steady:.6f} s (min of {OPT_AUTO_REPEATS} "
                f"repeats, 0 autotune re-runs, "
                f"{after['decision_cache_hits'] - mid['decision_cache_hits']}"
                f" catalog hits, {counts[kname]} {kname} launches, no other "
                f"kernel, bit for bit the static run); best static "
                f"{best[0]}/{best[1]} {walls[best]:.6f} s, worst "
                f"{worst[0]}/{worst[1]} {walls[worst]:.6f} s; regret_vs_best "
                f"{regret:.4f}{' ABOVE ' + str(OPT_REGRET) if regret > OPT_REGRET else ''}, "
                f"win_vs_worst {walls[worst] / steady:.4f}; on {smi}")
            for c in analytic_rank:
                log(f"[optimizer] {name} cell {c[0]:<26} {c[1]:<9} "
                    f"predicted {predicted[c]:.6e} s (analytic rank "
                    f"{analytic_rank.index(c) + 1}) static wall "
                    f"{walls[c]:.6f} s (measured rank "
                    f"{measured_rank.index(c) + 1}), "
                    f"{static_counts[c]} launches a run")
            log(f"[optimizer] {name} analytic vs measured rank: top "
                f"{analytic_rank[0]} vs {measured_rank[0]}; "
                f"{len(disagree)} of {len(cells) * (len(cells) - 1) // 2} "
                f"pairs ordered differently")
            del res, static, reps, static_eng, auto_eng
            store.drop(name)
        del forest

    # -- tier advice and auto_move ----------------------------------------
    f500 = forest_of(ADVICE_TREES, SEED + 64, integer=True)
    astore = TensorBlockStore(device="cuda", device_budget_bytes=TIER_BUDGET)
    astore.put("adv", card_rows(ADVICE_ROWS, FEATURES, seed=SEED + 65),
               tier="host")
    aeng = fresh_engine(astore)
    c0 = opt_counters()

    def advised():
        t1 = time.perf_counter()
        r = aeng.infer("adv", f500, plan="auto", algorithm="auto")
        return r, time.perf_counter() - t1

    (host_res, host_s), counts = counted(advised)
    tally(counts)
    d = host_res.decision
    if d.tier != "device" or host_res.tier != "host":
        raise AssertionError(f"[optimizer] tier advice: decision tier "
                             f"{d.tier}, query ran on {host_res.tier}")
    default_bp = aeng.optimizer._default_batch_pages(astore.get("adv"))
    log(f"[optimizer] tier advice: {ADVICE_ROWS} x {FEATURES} on the host "
        f"tier under a {TIER_BUDGET} B device budget, {ADVICE_TREES} "
        f"trees: decision {d.algorithm} / {d.plan} n_parts {d.n_parts}, "
        f"advice tier {d.tier}, ran on {host_res.tier}, source {d.source}, "
        f"cells_scored {d.cells_scored}, cells_measured {d.cells_measured}; "
        f"hillclimbed batch_pages {d.batch_pages} (default {default_bp}, "
        f"{astore.get('adv').num_pages} pages, {host_res.scan.batches} "
        f"batches); first call {host_s:.6f} s")

    def moved():
        t1 = time.perf_counter()
        r = aeng.infer("adv", f500, plan="auto", algorithm="auto",
                       auto_move=True)
        return r, time.perf_counter() - t1

    (dev_res, move_s), counts = counted(moved)
    tally(counts)
    c1 = opt_counters()
    if astore.get("adv").tier != "device" or dev_res.tier != "device" or \
            c1["decisions"] - c0["decisions"] != 2 or \
            len(astore.decision_catalog()) != 2 or not torch.equal(
                bits(dev_res.predictions.cpu()),
                bits(host_res.predictions.cpu())):
        raise AssertionError(f"[optimizer] auto_move: tier "
                             f"{astore.get('adv').tier}, counters {c0} -> "
                             f"{c1}")
    log(f"[optimizer] auto_move=True: moved host -> device, second decision "
        f"{dev_res.decision.algorithm} / {dev_res.decision.plan} "
        f"(source {dev_res.decision.source}), {move_s:.6f} s with the move "
        f"and the decision; predictions bit for bit the host-tier run")
    del aeng, astore, host_res, dev_res

    # -- serving: a tenant registered with "auto" ---------------------------
    rows = card_rows(OPT_SERVE_REQUESTS, FEATURES, seed=SEED + 66).cpu() \
        .numpy()
    seng = ForestServeEngine(TensorBlockStore(device="cuda"))
    other = forest_of(ADVICE_TREES, SEED + 67, integer=True)
    seng.register_model("other", other, algorithm="predicated_pallas_fused")

    def register():
        t1 = time.perf_counter()
        m_ = seng.register_model("auto", f500, algorithm="auto",
                                 plan="auto")
        torch.cuda.synchronize()
        return m_, time.perf_counter() - t1

    (m, reg_s), counts = counted(register)
    tally(counts)
    (key, dec), = [(k, v) for k, v in seng.store.decision_catalog().items()
                   if k[1] == "#rows"]
    if key[2] != (max(seng.buckets), FEATURES) or \
            (m.algorithm, m.plan) != (dec["algorithm"], dec["plan"]) or \
            m.algorithm not in CUDA_ALGORITHMS:
        raise AssertionError(f"[optimizer] serve: decision {key} {dec}")
    misses0 = seng.stats("other")["plan_misses"]
    seng.predict("other", rows[:3])
    other_missed = seng.stats("other")["plan_misses"] - misses0
    kname = kernel_name(m.algorithm)
    per_tick = seng.qe._resolve_n_parts(f500, m.algorithm, None) \
        if m.plan == "rel+reuse" else 1
    log(f"[optimizer] serve: register_model('auto', {ADVICE_TREES} trees, "
        f"'auto', 'auto') -> {m.algorithm} / {m.plan} at B = "
        f"{key[2][0]} (source {dec['source']}, cells_measured "
        f"{dec['cells_measured']}), {reg_s:.6f} s with warmup; the other "
        f"tenant's plan misses after it: {other_missed}")
    st0 = seng.stats("auto")
    gmiss0 = METRICS.counter("plan.cache_misses").value

    def window():
        with seng:
            reqs_, due_, t0_ = open_loop(
                lambda i: seng.submit("auto", rows[i],
                                      priority=TIER_INTERACTIVE),
                OPT_SERVE_RATE_HZ, OPT_SERVE_REQUESTS)
            for r in reqs_:
                r.done.wait(120.0)
        torch.cuda.synchronize()
        return reqs_, due_, t0_

    (reqs, due, t_open), counts = counted(window)
    st1 = seng.stats("auto")
    ticks = st1["ticks"] - st0["ticks"]
    if any(not r.done.is_set() or r.error is not None for r in reqs):
        raise AssertionError("[optimizer] serve: a request failed")
    if st1["plan_misses"] != st0["plan_misses"] or \
            METRICS.counter("plan.cache_misses").value != gmiss0:
        raise AssertionError("[optimizer] serve: a plan miss after warmup")
    only(counts, kname, ticks * per_tick, "[optimizer] serve window")
    tally(counts)
    got = np.concatenate([r.predictions for r in reqs])
    big_b = max(seng.buckets)
    want = []
    for lo in range(0, OPT_SERVE_REQUESTS, big_b):
        n = min(big_b, OPT_SERVE_REQUESTS - lo)
        x = np.zeros((big_b, FEATURES), np.float32)
        x[:n] = rows[lo:lo + n]
        want.append(seng.qe.infer_rows(
            f500, x, row_mask=np.arange(big_b) < n, algorithm=m.algorithm,
            plan=m.plan, model_id=m.model_id).predictions[:n].cpu())
    want = torch.cat(want)
    if not torch.equal(bits(torch.from_numpy(got)), bits(want)):
        raise AssertionError("[optimizer] serve: a request differs from "
                             "infer_rows of the decided cell")
    stw = window_stats(reqs, due, t_open)
    log(f"[optimizer] serve: {OPT_SERVE_REQUESTS} single-row requests at "
        f"{OPT_SERVE_RATE_HZ} req/s on the auto tenant: p50 "
        f"{stw['p50_ms']:.4f} ms p99 {stw['p99_ms']:.4f} ms from scheduled "
        f"arrival, {ticks} ticks, 0 plan misses, {counts[kname]} {kname} "
        f"launches = {per_tick} a tick, no other kernel; each request bit "
        f"for bit infer_rows of {m.algorithm} / {m.plan}; on {smi}")
    del seng


def train_phase(*, counted, only, smi: str, tally) -> None:
    """Phase 13: in-database training on the card.  Three families trained
    by ``engine.train`` on a HIGGS-width table, each held bit for bit
    against ``train_forest`` run resident on the card; the XGBoost forest
    scored from the model catalog by the fused predicated kernel; the
    router's default forest trained and routing.  ``tally(counts)`` adds
    each counted run's launches to the kernels' record."""
    from repro_torch.core import train as train_mod
    from repro_torch.core.train import TrainConfig, train_forest
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.serve.router import ForestRouter, synth_router_trace

    t_phase = time.perf_counter()
    x = card_rows(TRAIN_ROWS, FEATURES, seed=SEED + 130,
                  missing=TRAIN_MISSING)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 131)
    w = torch.randn(FEATURES, generator=gen, device="cuda")
    y = (torch.nan_to_num(x) @ w > 0).to(torch.float32)
    x_np, y_np = x.cpu().numpy(), y.cpu().numpy()
    host = TensorBlockStore(device_budget_bytes=TIER_BUDGET)
    host.put("higgs", x, labels=y, tier="host")
    dev = TensorBlockStore()
    dev.put("higgs", x, labels=y, tier="device")
    del x, y
    engines = {"host": fresh_engine(host),
               "device": fresh_engine(dev)}
    runs = (("xgboost", "host", dict(), TRAIN_BATCH_PAGES),
            ("lightgbm", "device", dict(), None),
            ("randomforest", "device", dict(colsample=0.5), None))
    results = {}
    for model_type, tier, extra, batch_pages in runs:
        cfg = TrainConfig(model_type=model_type, num_trees=TRAIN_TREES[
            model_type], max_depth=TRAIN_DEPTH, num_bins=TRAIN_BINS,
                          seed=SEED, **extra)
        torch.cuda.synchronize()
        res = engines[tier].train("higgs", cfg, batch_pages=batch_pages)
        t0 = time.perf_counter()
        ref = train_forest(x_np, y_np, cfg, edges=res.edges, device="cuda")
        torch.cuda.synchronize()
        resident_s = time.perf_counter() - t0
        same = all(torch.equal(getattr(res.forest, k), a)
                   for k, a in ref.arrays().items())
        store = engines[tier].store
        bins = store.get(res.bins_dataset)
        levels_s = res.pass_s["levels"]
        route_s = sum(lv["route_s"] for lv in res.levels)
        hist_s = sum(lv["hist_s"] for lv in res.levels)
        log(f"[train] {model_type} {cfg.num_trees} trees x depth "
            f"{TRAIN_DEPTH}, {TRAIN_ROWS} x {FEATURES} rows on the {tier} "
            f"tier ({smi}): wall {res.wall_s:.3f} s (sketch "
            f"{res.pass_s['sketch']:.3f}, bin ingest "
            f"{res.pass_s['bin_ingest']:.3f}, level scans {levels_s:.3f}: "
            f"{levels_s / res.wall_s:.1%}), "
            f"{TRAIN_ROWS * cfg.num_trees / res.wall_s:.0f} rows x trees / "
            f"s; {res.num_scans} scans; resident on the card "
            f"{resident_s:.3f} s; streamed == resident bit for bit: "
            f"{'ok' if same else 'FAIL'}")
        log(f"[train] {model_type} level scans: routing device "
            f"{route_s:.4f} s ({route_s / levels_s:.2%} of the level "
            f"scans), host histograms {hist_s:.3f} s "
            f"({hist_s / levels_s:.1%})")
        for lv in res.levels[: TRAIN_DEPTH + 1]:
            log(f"[train] {model_type} tree 0 level {lv['level']}: route "
                f"device {lv['route_s'] * 1e3:.3f} ms, host histogram "
                f"{lv['hist_s'] * 1e3:.1f} ms")
        st = res.scan_stats[-2]                       # a routed hist scan
        log(f"[train] {model_type} bins relation {res.bins_dataset}: "
            f"{bins.nbytes} bytes, {bins.dtype}, tier {bins.tier}; a level "
            f"scan: batches={st.batches} batch_pages={st.batch_pages} "
            f"max_in_flight={st.max_in_flight} bytes_streamed="
            f"{st.bytes_streamed} wall={st.wall_s:.4f} s")
        if not same:
            raise AssertionError(f"[train] {model_type}: the streamed forest "
                                 f"differs from the resident one")
        if bins.tier != tier or bins.dtype != torch.uint8:
            raise AssertionError(f"[train] {model_type}: bins relation on "
                                 f"{bins.tier} as {bins.dtype}")
        if any(s.max_in_flight > 2 for s in res.scan_stats) or (
                tier == "host" and st.batches < 2):
            raise AssertionError(f"[train] {model_type}: scan bound or "
                                 f"streaming broken")
        results[model_type] = res

    # the host histogram alone: one level over the whole bins relation in
    # one np.add.at call against HIST_CHUNK_ROWS-row chunks (bit for bit)
    bins_np = host.get("higgs::bins").data.numpy()[:TRAIN_ROWS]
    r = np.random.default_rng(SEED + 132)
    level = 4
    node_of = r.integers((1 << level) - 1, (2 << level) - 1,
                         TRAIN_ROWS).astype(np.int32)
    g = r.normal(size=TRAIN_ROWS).astype(np.float32)
    h = r.random(TRAIN_ROWS).astype(np.float32)
    hist_s, hists = {}, {}
    chunk = train_mod.HIST_CHUNK_ROWS
    sizes = (TRAIN_ROWS, TRAIN_BATCH_PAGES * PAGE_ROWS, 32768, chunk, 2048)
    try:
        for rows in sizes + sizes:
            train_mod.HIST_CHUNK_ROWS = rows
            hg = np.zeros((1 << level, FEATURES, TRAIN_BINS + 1))
            hh = np.zeros_like(hg)
            t0 = time.perf_counter()
            train_mod.hist_update(hg, hh, bins_np, node_of, g, h)
            dt = time.perf_counter() - t0
            hist_s[rows] = min(hist_s.get(rows, dt), dt)
            hists[rows] = (hg, hh)
    finally:
        train_mod.HIST_CHUNK_ROWS = chunk
    same = all(np.array_equal(a, b) for rows in sizes
               for a, b in zip(hists[TRAIN_ROWS], hists[rows]))
    log(f"[train] host histogram of one level ({TRAIN_ROWS} x {FEATURES} "
        f"bins, {1 << level} nodes), min of 2, rows an np.add.at call: "
        + ", ".join(f"{rows} {hist_s[rows]:.4f} s" for rows in sizes)
        + f" (HIST_CHUNK_ROWS = {chunk}: "
        f"{hist_s[TRAIN_ROWS] / hist_s[chunk]:.2f}x one call); bit for "
        f"bit: {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("[train] chunked histograms differ")

    # the XGBoost forest from the model catalog, scored by the fused kernel
    engine = engines["host"]
    forest = host.get_model("higgs:model")
    q, counts = counted(lambda: engine.infer(
        "higgs", forest, plan="udf", algorithm="predicated_pallas_fused",
        model_id=results["xgboost"].fingerprint))
    only(counts, "predicated_fused", 1, "[train] scoring the trained forest")
    tally(counts)
    eager = engine.infer("higgs", forest, plan="udf",
                         algorithm="predicated").predictions
    got = q.predictions
    err = float((got - eager).abs().max())
    close = bool(torch.allclose(got, eager, rtol=TOL, atol=TOL))
    acc = float(((got.cpu().numpy() > 0.5) == (y_np > 0.5)).mean())
    log(f"[train] scored the catalog's xgboost forest: udf "
        f"predicated_pallas_fused {q.total_s:.4f} s on the host tier, 1 "
        f"launch; max_abs_err vs eager {err!r} rtol=atol={TOL}: "
        f"{'ok' if close else 'FAIL'}; training-set accuracy {acc:.4f} "
        f"(gate > {TRAIN_ACCURACY})")
    if not close or acc <= TRAIN_ACCURACY or not bool(
            torch.isfinite(got).all()):
        raise AssertionError("[train] the trained forest scores wrong")

    # the router's default forest, trained on the card
    t0 = time.perf_counter()
    router = ForestRouter()
    torch.cuda.synchronize()
    router_s = time.perf_counter() - t0
    cpu_router = ForestRouter(device="cpu")
    same = all(torch.equal(getattr(router.forest, k).cpu(), a)
               for k, a in cpu_router.forest.arrays().items())
    rx, ry = synth_router_trace(ROUTER_ROWS, seed=3)
    tiers = router.route(rx)
    agree = float((tiers == ry.astype(int)).mean())
    log(f"[train] ForestRouter() trained on the card in {router_s:.3f} s "
        f"({router.forest.num_trees} trees, depth {router.forest.depth}, "
        f"{router.forest.device}); routed {ROUTER_ROWS} rows, "
        f"{int(tiers.sum())} to the batch tier, {agree:.3f} agree with the "
        f"trace's rule; forest bit for bit the CPU router's: "
        f"{'ok' if same else 'FAIL'}")
    if not same or tiers.shape != (ROUTER_ROWS,) or \
            not np.array_equal(tiers, cpu_router.route(rx)):
        raise AssertionError("[train] the router differs from the CPU's")
    for store in (host, dev):
        store.drop("higgs")
        store.drop("higgs::bins")
    log(f"[train] phase wall {time.perf_counter() - t_phase:.3f} s")


def mesh_phase(*, forest, big, store, engine, udf_device, udf_device_s: float,
               rel_device_s: float, counted, only, smi: str, tally) -> None:
    """Phase 14: the (data, model) mesh over repeated cuda:0 positions.
    Every mesh query is held bit for bit against the same query without a
    mesh (at n_parts = n_model for rel), with exact launch counts; walls
    and mesh / mesh-less ratios are printed.  ``tally(counts)`` adds each
    counted run's launches to the kernels' record."""
    from repro_torch.core.train import TrainConfig
    from repro_torch.db.faults import FaultInjector, RetryPolicy
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    nd, nm = MESH_DATA, MESH_MODEL
    mesh = make_local_mesh(nd, nm, devices=["cuda:0"] * (nd * nm))
    src = store.get("higgs")
    n = src.num_rows
    mstore = TensorBlockStore(mesh=mesh)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mds = mstore.put("higgs", src.data[:n])
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    log(f"[mesh] {mesh!r}: physical devices "
        f"{[str(d) for d in mesh.physical_devices()]}; store.put('higgs', "
        f"{n} x {FEATURES}): {mds.num_pages} pages (a multiple of {nd}), "
        f"{mds.nbytes} B; device allocation grew {grown} B")
    if not mds.nbytes <= grown < mds.nbytes + (64 << 20):
        raise AssertionError(f"[mesh] the table is not held once: "
                             f"{grown} B for {mds.nbytes} B")
    mengine = fresh_engine(mstore)

    def same(a, b, what: str) -> None:
        if a.shape != b.shape or not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"[mesh] {what}: not bit for bit the "
                                 f"mesh-less result")

    def kernel(algorithm: str) -> str:
        kind = algorithm.split("_")[0]
        return f"{kind}_{'fused' if algorithm.endswith('_fused') else 'raw'}"

    def run(eng, dataset, model, runs: int, per_batch: int, what: str,
            **kw):
        results, c = counted(lambda: [eng.infer(dataset, model, **kw)
                                      for _ in range(runs)])
        batches = sum(r.scan.batches for r in results)
        only(c, kernel(kw["algorithm"]), per_batch * batches, what)
        tally(c)
        return results

    def ratio_line(what: str, mesh_s: float, flat_s: float, extra="",
                   against="mesh-less") -> None:
        log(f"[mesh] {what}: mesh {mesh_s:.6f} s, {against} "
            f"{flat_s:.6f} s, mesh / {against} {mesh_s / flat_s:.4f}"
            f"{extra} on {smi}")

    # -- udf: 500 trees over the 11M rows, 2 launches a batch -----------------
    udf = run(mengine, "higgs", forest, 2, nd, "mesh udf", plan="udf",
              algorithm="predicated_pallas_fused")
    if udf[0].plan_reuse_hit or not udf[1].plan_reuse_hit:
        raise AssertionError("[mesh] the repeated udf missed the plan cache")
    same(udf[1].predictions, udf_device, "udf")
    ops = [op for r in udf[1].stage_reports for op in r.operators]
    if "transform:forest-udf@shard_map" not in ops \
            or udf[1].mesh_devices != nd * nm:
        raise AssertionError(f"[mesh] udf stages {ops}")
    ratio_line(f"udf predicated_pallas_fused {TREES} trees x {n} rows "
               f"({nd} launches a batch, devices "
               f"{[r.devices for r in udf[1].stage_reports]})",
               udf[1].total_s, udf_device_s)

    # -- rel+reuse: 1600 trees, n_parts = n_model, 8 launches a batch ---------
    kw = dict(plan="rel+reuse", algorithm="predicated_pallas_fused")
    flat = run(engine, "higgs", big, 2, nm, "mesh-less rel+reuse",
               n_parts=nm, **kw)
    rel = run(mengine, "higgs", big, 2, nd * nm, "mesh rel+reuse", **kw)
    if rel[0].reuse_hit or not (rel[1].reuse_hit and rel[1].plan_reuse_hit) \
            or rel[1].partition_s != 0.0 or rel[1].n_parts != nm:
        raise AssertionError("[mesh] the repeated rel+reuse did not hit "
                             "both caches")
    same(rel[1].predictions, flat[1].predictions, "rel+reuse")
    ops = [op for r in rel[1].stage_reports for op in r.operators]
    if "cross-product:psum-agg" not in ops:
        raise AssertionError(f"[mesh] rel stages {ops}")
    ratio_line(f"rel+reuse predicated_pallas_fused {REL_TREES} trees x {n} "
               f"rows, n_parts {nm} ({nd * nm} launches a batch; "
               f"{', '.join(f'{r.name} {r.seconds:.6f} s' for r in rel[1].stage_reports)})",
               rel[1].total_s, flat[1].total_s,
               f"; against phase 6's raw rel+reuse at its own n_parts "
               f"{rel_device_s:.6f} s: {rel[1].total_s / rel_device_s:.4f} "
               f"(reported, not gated: other partitionings)")

    # -- the other kernels under rel on the 1M cut (walls: the 2nd run) -------
    mstore.put("higgs_1m", src.data[:CUT_ROWS])
    for algorithm in ("hummingbird_pallas_fused", "quickscorer_pallas_fused",
                      "predicated_pallas"):
        kw = dict(plan="rel", algorithm=algorithm)
        f1 = run(engine, "higgs_1m", big, 2, nm, f"mesh-less rel {algorithm}",
                 n_parts=nm, **kw)
        m1 = run(mengine, "higgs_1m", big, 2, nd * nm, f"mesh rel {algorithm}",
                 **kw)
        same(m1[1].predictions, f1[1].predictions, f"rel {algorithm}")
        ratio_line(f"rel {algorithm} {REL_TREES} trees x {CUT_ROWS} rows "
                   f"({nd * nm} launches a batch)", m1[1].total_s,
                   f1[1].total_s)

    # -- infer_rows ------------------------------------------------------------
    for plan, model in (("udf", forest), ("rel+reuse", big)):
        for B in ROW_BATCHES:
            x = src.data[:B]
            kw = dict(plan=plan, algorithm="predicated_pallas_fused")
            per = nd if plan == "udf" else nd * nm
            calls, c = counted(lambda: [mengine.infer_rows(model, x, **kw)
                                        for _ in range(2)])
            only(c, "predicated_fused", 2 * per, f"mesh infer_rows {plan} {B}")
            tally(c)
            flat_rows, c = counted(lambda: [engine.infer_rows(
                model, x, n_parts=None if plan == "udf" else nm, **kw)
                for _ in range(2)])
            tally(c)
            if not calls[1].plan_reuse_hit:
                raise AssertionError(f"[mesh] infer_rows {plan} {B}: the "
                                     f"repeat missed the plan cache")
            same(calls[1].predictions, flat_rows[1].predictions,
                 f"infer_rows {plan} {B}")
            ratio_line(f"infer_rows {plan} {B} rows (repeat, {per} "
                       f"launches)", calls[1].total_s, flat_rows[1].total_s)

    # -- the host tier, in data-unit batches ----------------------------------
    mhost = TensorBlockStore(mesh=mesh)
    hds = mhost.put("higgs_1m", src.data[:CUT_ROWS], tier="host")
    kw = dict(plan="udf", algorithm="predicated_pallas_fused")
    dev1m = run(mengine, "higgs_1m", forest, 2, nd, "mesh udf 1M", **kw)
    host = run(fresh_engine(mhost), "higgs_1m", forest, 2, nd,
               "mesh host udf", batch_pages=MESH_HOST_BATCH_PAGES, **kw)
    st = host[1].scan
    if hds.tier != "host" or host[1].tier != "host":
        raise AssertionError(f"[mesh] the host-tier scan ran on the "
                             f"{host[1].tier} tier (stored {hds.tier})")
    if st.batches < 2 or st.batch_pages % nd:
        raise AssertionError(f"[mesh] host scan {st}")
    same(host[1].predictions.cuda(), dev1m[1].predictions, "host tier")
    ratio_line(f"host-tier udf over {CUT_ROWS} rows ({st.batches} batches "
               f"of {st.batch_pages} pages, max_in_flight "
               f"{st.max_in_flight}, transfer_wait {st.transfer_wait_s:.6f} "
               f"s)", host[1].total_s, dev1m[1].total_s,
               against="mesh device tier")

    # -- CSR: the gather inside each row shard --------------------------------
    mstore.put_sparse("higgs_csr", src.data[:MESH_CSR_ROWS])
    store.put_sparse("higgs_csr", src.data[:MESH_CSR_ROWS])
    kw = dict(plan="udf", algorithm="hummingbird_pallas_fused")
    fc = run(engine, "higgs_csr", forest, 2, 1, "mesh-less csr", **kw)
    mc = run(mengine, "higgs_csr", forest, 2, nd, "mesh csr", **kw)
    same(mc[1].predictions, fc[1].predictions, "csr")
    ratio_line(f"CSR udf hummingbird_pallas_fused over {MESH_CSR_ROWS} "
               f"rows", mc[1].total_s, fc[1].total_s)
    store.drop("higgs_csr")

    # -- a transient kernel_launch fault ----------------------------------------
    kw = dict(plan="rel+reuse", algorithm="predicated_pallas_fused")
    clean = run(mengine, "higgs_1m", big, 2, nd * nm, "mesh clean", **kw)
    inj = FaultInjector().inject("kernel_launch", fail_at=1)
    faulted = run(mengine, "higgs_1m", big, 1, nd * nm, "mesh fault",
                  injector=inj, retry_policy=RetryPolicy(
                      backoff_base_s=0.0, max_backoff_s=0.0), **kw)
    st = faulted[0].scan
    if (st.faults_injected, st.retries) != (1, 1):
        raise AssertionError(f"[mesh] fault {st}")
    same(faulted[0].predictions, clean[1].predictions, "kernel_launch fault")
    ratio_line("rel+reuse with one transient kernel_launch fault (retries "
               "1)", faulted[0].total_s, clean[1].total_s,
               against="clean mesh run")

    # -- training: one XGBoost tree on the mesh ----------------------------------
    x = src.data[:CUT_ROWS]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 140)
    y = (x @ torch.randn(FEATURES, generator=gen, device="cuda") > 0).float()
    mstore.put("train", x, labels=y)
    store.put("train", x, labels=y)
    cfg = TrainConfig(model_type="xgboost", num_trees=1,
                      max_depth=MESH_TRAIN_DEPTH, num_bins=TRAIN_BINS,
                      seed=SEED)
    flat_t = engine.train("train", cfg)
    mesh_t = mengine.train("train", cfg)
    if not np.array_equal(flat_t.edges, mesh_t.edges) or not all(
            torch.equal(getattr(mesh_t.forest, k), a)
            for k, a in flat_t.forest.arrays().items()):
        raise AssertionError("[mesh] the mesh-trained tree differs")
    ratio_line(f"engine.train XGBoost 1 tree depth {MESH_TRAIN_DEPTH} over "
               f"{CUT_ROWS} rows ({mesh_t.num_scans} scans; bit for bit)",
               mesh_t.wall_s, flat_t.wall_s)
    store.drop("train")
    store.drop("train::bins")
    log(f"[mesh] phase wall {time.perf_counter() - t_phase:.3f} s")


def lm_greedy(cfg, params, prompt, bucket: int, max_new: int, ctx: int,
              gap: float) -> list[int]:
    """The single-request greedy loop, left-padded into ``bucket`` as the
    engine pads; it stops before a step whose top-two logits lie within
    ``gap`` (a near-tie another batch width may flip)."""
    from repro_torch.models import lm as LM

    toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
    toks[0, bucket - len(prompt):] = torch.as_tensor(prompt)
    logits, caches = LM.lm_prefill(cfg, params, toks, ctx=ctx)
    out: list[int] = []
    while len(out) < max_new:
        top2 = torch.topk(logits[0], 2).values
        if float(top2[0] - top2[1]) < gap:
            break
        out.append(int(torch.argmax(logits[0])))
        logits, caches = LM.lm_decode(
            cfg, params, caches, torch.tensor([[out[-1]]], device="cuda"))
    return out


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree; a value held as pieces by the positions of a
    mesh (``Sharded``) gives every position's piece."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if hasattr(tree, "pieces"):
        return list(tree.pieces.values())
    return [tree]


def on_card(tree, what: str) -> None:
    off = [t.device for t in tree_leaves(tree) if not t.is_cuda]
    if off:
        raise AssertionError(f"{what}: tensors off the card {off[:3]}")


def lm_tree_params(cfg, params) -> int:
    """The parameter count of ``params``, held to the reference's tree."""
    n = sum(t.numel() for t in tree_leaves(params))
    want = LM_TREE_PARAMS[(cfg.name, cfg.num_layers)]
    if n != want:
        raise AssertionError(f"{cfg.name}: {n:,} parameters, the "
                             f"reference's tree has {want:,}")
    return n


def lm_f32_checks(tag: str, cfg, params, *, batch: int, length: int,
                  steps: int, requests: int, new: int, seed: int,
                  tcfg=None) -> None:
    """In f32 with TF32 off: a ``batch`` x ``length`` prefill and ``steps``
    teacher-forced decode steps, each within LM_TOL of lm_prefill over the
    same prefix (run under ``tcfg``: ``cfg`` with what the comparison
    needs), then ``requests`` prompts through a 2-slot engine, token for
    token the single-request loop up to its first near-tie."""
    from repro_torch.models import lm as LM
    from repro_torch.serve.engine import ServeEngine

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for the f32 checks")
    tcfg = tcfg or cfg
    B, S, N = batch, length, steps
    toks = torch.randint(
        0, cfg.vocab_size, (B, S + N), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))
    t0 = time.perf_counter()
    logits, caches = LM.lm_prefill(tcfg, params, toks[:, :S], ctx=S + N)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if logits.shape != (B, cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    on_card(caches, "prefill caches")
    worst = 0.0
    for i in range(N):
        want, _ = LM.lm_prefill(tcfg, params, toks[:, :S + i + 1])
        got, caches = LM.lm_decode(tcfg, params, caches,
                                   toks[:, S + i:S + i + 1])
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL):
            raise AssertionError(f"{cfg.name} decode step {i}: max |err| "
                                 f"{err:.3e} past rtol = atol = {LM_TOL}")
    log(f"{tag} f32 prefill {B} x {S} in {prefill_s:.3f} s (first call); "
        f"{N} teacher-forced decode steps each within rtol = atol = "
        f"{LM_TOL} of lm_prefill over the same prefix, max |err| "
        f"{worst:.3e}, logits up to {float(want.abs().max()):.3f}"
        + (f" (capacity_factor {tcfg.capacity_factor}: no drops)"
           if tcfg.capacity_factor != cfg.capacity_factor else ""))
    del caches, logits, want, got

    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(20, 64)))
               for _ in range(requests)]
    engine = ServeEngine(cfg, params, slots=2, max_ctx=128,
                         prompt_buckets=(64,), dtype=torch.float32)
    uids = [engine.submit(q, max_new_tokens=new) for q in prompts]
    done = {r.uid: r.tokens for r in engine.run_until_drained()}
    compared = []
    for uid, q in zip(uids, prompts):
        want = lm_greedy(cfg, params, q, 64, new, 128, LM_TIE_GAP)
        if done[uid][:len(want)] != want:
            raise AssertionError(f"{cfg.name} request {uid}: engine "
                                 f"{done[uid]} against the single-request "
                                 f"loop {want}")
        compared.append(len(want))
    log(f"{tag} f32 engine, {requests} requests through 2 slots: token for "
        f"token the single-request loop over {sum(compared)} of "
        f"{requests * new} steps (per request {compared}; the rest follow a "
        f"near-tie within {LM_TIE_GAP})")


def lm_bf16_serving(tag: str, cfg, params, script: list, *, seed: int,
                    smi: str, splan=None, probe=None,
                    timed=LM_BUCKETS) -> dict:
    """``ServeEngine(slots=LM_SLOTS, max_ctx=LM_MAX_CTX, LM_BUCKETS)`` on its
    default bf16 caches (under ``splan`` when given): prefill ms a bucket
    of ``timed``,
    then ``script`` ([(prompt, max_new_tokens, priority)]) submitted at
    once and drained (stats, decode tick p50 / p99 beside the tick's byte
    bound, tokens/s, peak memory since the caller's reset), then a profile
    of decode-only ticks with every slot busy, and ``probe(engine)`` with
    those slots still busy.  Returns those numbers and each request's
    tokens, in submission order."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine

    engine = ServeEngine(cfg, params, slots=LM_SLOTS, max_ctx=LM_MAX_CTX,
                         prompt_buckets=LM_BUCKETS, splan=splan)
    on_card(engine.params, "bf16 params")
    on_card(engine.caches, "engine caches")
    param_bytes = sum(t.nbytes for t in tree_leaves(engine.params))
    cache_bytes = sum(t.nbytes for t in tree_leaves(
        {k: c for k, c in engine.caches.items() if k != "index"}))
    bound_ms = (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    leaves = sorted({f"{leaf} {str(t.dtype)[6:]}"
                     for name, c in engine.caches.items() if name != "index"
                     for leaf, t in c.items()})
    prefill_ms = {}
    for b in timed:
        x = torch.randint(0, cfg.vocab_size, (1, b), device="cuda")
        walls = []
        for _ in range(4):                      # the first warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._prefill_fn(engine.params, x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prefill_ms[b] = 1e3 * float(np.median(walls[1:]))
    log(f"{tag} bf16 params {param_bytes / 1e9:.3f} GB, caches "
        f"{cache_bytes / 1e9:.4f} GB ({LM_SLOTS} slots x {LM_MAX_CTX} "
        f"positions; {', '.join(leaves)}); prefill ms a bucket (median of "
        f"3, warmed) "
        + ", ".join(f"{b}: {ms:.3f}" for b, ms in prefill_ms.items()))

    for prompt, mnt, priority in script:
        engine.submit(prompt, max_new_tokens=mnt, priority=priority)
    decode_ms, admit_ms = [], []
    t0 = time.perf_counter()
    while engine._queue or engine._active:
        admits = min(len(engine._free), len(engine._queue))
        t1 = time.perf_counter()
        engine.step()
        (admit_ms if admits else decode_ms).append(
            1e3 * (time.perf_counter() - t1))
    serve_s = time.perf_counter() - t0
    done = engine._done
    budgets = sorted(mnt for _, mnt, _ in script)
    if len(done) != len(script) or \
            sorted(len(r.tokens) for r in done) != budgets:
        raise AssertionError(f"{len(done)} of {len(script)} requests done, "
                             f"token counts {[len(r.tokens) for r in done]}")
    bad = [t for r in done for t in r.tokens
           if not 0 <= t < cfg.vocab_padded]
    if bad:
        raise AssertionError(f"token ids out of range: {bad[:5]}")
    st = engine.stats()
    script_tokens = [r.tokens for r in sorted(done, key=lambda r: r.uid)]
    p50, p99 = np.percentile(decode_ms, [50, 99])
    log(f"{tag} bf16 serving stats {json.dumps(st)}")
    log(f"{tag} bf16 serving: {len(script)} requests, {st['tokens']} tokens "
        f"in {serve_s:.3f} s = {st['tokens'] / serve_s:.1f} tokens/s over "
        f"{engine.ticks} ticks; decode-only ticks {len(decode_ms)}: p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms; ticks with admissions "
        f"{len(admit_ms)}: p50 {np.median(admit_ms):.3f} ms; byte bound "
        f"{bound_ms:.4f} ms a tick (weights + the whole cache at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), p50 tick at "
        f"{100 * bound_ms / p50:.2f} % of it; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; on {smi}")

    # a profile of decode-only ticks: all slots busy, no admission
    rng = np.random.default_rng(seed)
    for _ in range(LM_SLOTS):
        engine.submit(rng.integers(0, cfg.vocab_size, 100),
                      max_new_tokens=LM_PROFILE_TICKS + 3)
    engine.step()                               # admits all, one tick
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILE_TICKS):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    every, kernels, _ = device_intervals(prof)
    busy = union_us(every)
    log(f"{tag} profile of {LM_PROFILE_TICKS} decode ticks ({LM_SLOTS} slots "
        f"busy): wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms"
        f" = {100 * busy / wall_us:.1f} % (idle "
        f"{100 - 100 * busy / wall_us:.1f} %), "
        f"{len(kernels) / LM_PROFILE_TICKS:.1f} kernels a tick")
    log_device_time(prof, 6)
    if probe is not None:
        probe(engine)
    engine.run_until_drained()
    return {"tokens": script_tokens, "tokens_s": st["tokens"] / serve_s, "p50_ms": float(p50),
            "p99_ms": float(p99), "kernels_tick": len(kernels)
            / LM_PROFILE_TICKS, "busy": busy / wall_us,
            "device_ms": busy / 1e3 / LM_PROFILE_TICKS,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def lm_phase(*, smi: str) -> None:
    """Phase 15: the LM serving path on olmo-1b at full width."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import get_bundle
    from repro_torch.serve.router import ForestRouter, request_features

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    bundle = get_bundle(cfg)
    log(f"[lm] {cfg.name} at full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim} "
        f"({cfg.num_kv_heads} KV), d_ff {cfg.d_ff} {cfg.mlp_type}, "
        f"{cfg.norm_type}, vocab {cfg.vocab_size} -> {cfg.vocab_padded}, "
        f"tied {cfg.tie_embeddings}; on {smi}")

    t0 = time.perf_counter()
    params = bundle.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 150),
        dtype=torch.float32)
    torch.cuda.synchronize()
    on_card(params, "f32 params")
    n = lm_tree_params(cfg, params)
    log(f"[lm] f32 params: {n:,} ({4 * n / 1e9:.3f} GB) drawn on the card "
        f"in {time.perf_counter() - t0:.3f} s")
    lm_f32_checks("[lm]", cfg, params, batch=LM_CHECK_BATCH,
                  length=LM_CHECK_LEN, steps=LM_CHECK_STEPS,
                  requests=LM_CHECK_REQUESTS, new=LM_CHECK_NEW,
                  seed=SEED + 151)
    del params
    free_card()

    torch.cuda.reset_peak_memory_stats()
    params = bundle.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 153))
    router = ForestRouter(seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 154)
    script, tiers, recent = [], [0, 0], []
    for _ in range(LM_REQUESTS):
        plen = int(rng.integers(LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + 1))
        mnt = int(rng.integers(LM_NEW_TOKENS[0], LM_NEW_TOKENS[1] + 1))
        recent.append(plen)
        tier = router.route(request_features(
            plen, mnt, None, 0, float(np.mean(recent[-8:]))))
        tiers[tier] += 1
        script.append((rng.integers(0, cfg.vocab_size, plen), mnt, tier))
    log(f"[lm] {LM_REQUESTS} requests routed by the forest router on the "
        f"card: {tiers[0]} interactive, {tiers[1]} batch")
    lm_bf16_serving("[lm]", cfg, params, script, seed=SEED + 155, smi=smi)
    del params, router
    free_card()

    # -- the CLI, at the reduced config on the card --------------------------
    t0 = time.perf_counter()
    st = serve_cli.main([])
    log(f"[lm] cli launch.serve.main on the card: {st['requests']} requests "
        f"served, none dropped, {st['tokens']} tokens in "
        f"{time.perf_counter() - t0:.3f} s")
    log(f"[lm] phase wall {time.perf_counter() - t_phase:.3f} s")


def lm_family_block(arch: str, *, smi: str) -> None:
    """Phase 16 for one model: the f32 checks, then bf16 serving."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import get_bundle
    from repro_torch.models import lm as LM
    from repro_torch.serve.router import TIER_BATCH

    t_block = time.perf_counter()
    tag = f"[lm-families] {arch}"
    full = get_config(arch)
    serve_layers, check_layers = LMF_LAYERS.get(
        arch, (full.num_layers, full.num_layers))
    cfg = dataclasses.replace(full, num_layers=serve_layers)
    bundle = get_bundle(cfg)
    what = (f"{cfg.num_blocks} blocks of {cfg.block_period}: "
            + ("SSD" if cfg.ssm_layers else "attention"))
    if cfg.shared_attn_every:
        what += f" + the shared attention block (LoRA rank " \
                f"{cfg.shared_attn_lora_rank}, {cfg.num_heads} heads x " \
                f"{cfg.head_dim}, gelu d_ff {cfg.d_ff})"
    if cfg.num_experts:
        what += (f" with MoE every {cfg.moe_every} ({cfg.num_experts} "
                 f"experts top-{cfg.top_k} + shared, d_ff {cfg.d_ff}), "
                 f"{cfg.num_heads} heads x {cfg.head_dim} ({cfg.num_kv_heads}"
                 f" KV), iRoPE window {cfg.attn_window} + global NoPE every "
                 f"{cfg.global_every}")
    if cfg.ssm_layers:
        what += (f"; SSD d_inner {cfg.d_inner}, {cfg.ssm_heads} heads x "
                 f"{cfg.ssm_headdim}, state {cfg.ssm_state}, conv "
                 f"{cfg.conv_width}, chunk {cfg.ssm_chunk}")
    log(f"{tag} d_model {cfg.d_model}, {serve_layers} of {full.num_layers} "
        f"layers ({what}), vocab {cfg.vocab_size} -> {cfg.vocab_padded}; "
        f"on {smi}")

    ccfg = dataclasses.replace(cfg, num_layers=check_layers)
    t0 = time.perf_counter()
    params = bundle.init(
        ccfg, torch.Generator(device="cuda").manual_seed(SEED + 160),
        dtype=torch.float32)
    torch.cuda.synchronize()
    on_card(params, "f32 params")
    n = lm_tree_params(ccfg, params)
    log(f"{tag} f32 params at {check_layers} layers: {n:,} ({4 * n / 1e9:.3f}"
        f" GB; the config's estimate {ccfg.param_count():,}) drawn on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    # teacher forcing compares routed layers only where no token drops
    tcfg = (dataclasses.replace(ccfg, capacity_factor=float(ccfg.num_experts))
            if ccfg.num_experts else ccfg)
    lm_f32_checks(tag, ccfg, params, batch=LMF_CHECK_BATCH,
                  length=LMF_CHECK_LEN, steps=LMF_CHECK_STEPS,
                  requests=LMF_CHECK_REQUESTS, new=LMF_CHECK_NEW,
                  seed=SEED + 161, tcfg=tcfg)
    del params
    free_card()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 163))
    torch.cuda.synchronize()
    n = lm_tree_params(cfg, params)
    log(f"{tag} bf16 params: {n:,} drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED + 164)
    script = []
    for _ in range(LMF_REQUESTS):
        plen = int(rng.integers(LMF_PROMPT_LEN[0], LMF_PROMPT_LEN[1] + 1))
        mnt = int(rng.integers(LMF_NEW_TOKENS[0], LMF_NEW_TOKENS[1] + 1))
        script.append((rng.integers(0, cfg.vocab_size, plen), mnt,
                       TIER_BATCH))
    lm_bf16_serving(tag, cfg, params, script, seed=SEED + 165, smi=smi)
    if cfg.num_experts:
        moe_layers = sum(p.use_moe for p in LM.make_layer_plans(cfg)) * \
            cfg.num_blocks
        item = params["embed"].element_size()
        gathered = moe_layers * LM_SLOTS * 3 * cfg.d_model * cfg.d_ff * item
        param_bytes = sum(t.nbytes for t in tree_leaves(params))
        log(f"{tag} the decode's expert-weight gathers copy {gathered:,} B "
            f"a tick ({gathered / 1e9:.3f} GB: {moe_layers} MoE layers x "
            f"{LM_SLOTS} tokens x 3 matrices of {cfg.d_model} x {cfg.d_ff} "
            f"bf16), {gathered / param_bytes:.2f}x the weights' bytes")
    del params
    free_card()
    log(f"{tag} block wall {time.perf_counter() - t_block:.3f} s")


def lm_families_phase(*, smi: str) -> None:
    """Phase 16: the SSD, hybrid and MoE serving paths, one model at a
    time."""
    t_phase = time.perf_counter()
    for arch in LMF_ARCHS:
        lm_family_block(arch, smi=smi)
    log(f"[lm-families] phase wall {time.perf_counter() - t_phase:.3f} s")


def train_step_flops(cfg, batch: int, seq: int) -> tuple[float, str]:
    """Model FLOPs of one training step (forward and backward, no
    recompute): 6 x each token x the matrix parameters it passes through,
    plus 12 x B x Sq x Sk x H x dh for each attention's two products
    (forward 4, backward 8; no causal half).  Enc-dec: ``seq`` frames
    through the encoder, ``seq // dec_len_ratio`` decoder tokens."""
    D, F, Vp = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    Hd, KVd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    attn = 2 * D * Hd + 2 * D * KVd
    mlp = (3 if cfg.mlp_type == "swiglu" else 2) * D * F
    B = batch
    if not cfg.encoder_layers:
        T, L_ = B * seq, cfg.num_layers
        flops = 6 * T * (L_ * (attn + mlp) + D * Vp) + \
            12 * L_ * B * seq * seq * Hd
        return float(flops), (f"6 x {T} tokens x ({L_} x {attn + mlp:,} + "
                              f"{D} x {Vp}) + 12 x {L_} x {B} x {seq}^2 x "
                              f"{Hd}")
    Sd = max(seq // cfg.dec_len_ratio, 1)
    Te, Td, Le, Ld = B * seq, B * Sd, cfg.encoder_layers, cfg.num_layers
    cross_kv = 2 * D * KVd
    mats = Te * Le * (attn + mlp) + Td * Ld * (attn + (attn - cross_kv)
                                                + mlp) \
        + Te * Ld * cross_kv + Td * D * Vp
    att = 12 * Hd * B * (Le * seq * seq + Ld * Sd * Sd + Ld * Sd * seq)
    return float(6 * mats + att), (
        f"6 x ({Te} frames x {Le} x {attn + mlp:,} + {Td} tokens x {Ld} x "
        f"{2 * attn - cross_kv + mlp:,} + {Te} x {Ld} x {cross_kv:,} + {Td} "
        f"x {D} x {Vp}) + 12 x {Hd} x {B} x ({Le} x {seq}^2 + {Ld} x "
        f"{Sd}^2 + {Ld} x {Sd} x {seq})")



def bits_equal(a, b) -> bool:
    """Two trees of tensors equal bit for bit, dtype and shape included."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def step_breakdown(cfg, opt, state, batch) -> dict:
    """One training step taken apart as ``make_train_step`` runs it, each
    part under CUDA events and its own peak of allocated memory above what
    was allocated before it: the loss's forward, its backward
    (``torch.autograd.grad`` over the parameters), the optimizer's
    update."""
    from repro_torch.models import get_bundle
    from repro_torch.train.trainer import deterministic_algorithms
    from repro_torch.train.tree import tree_leaves, tree_unflatten

    tb = {k: (torch.from_numpy(a).cuda() if a.dtype.kind == "f"
              else torch.from_numpy(a).long().cuda())
          for k, a in batch.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    out, peaks = {}, {}
    with deterministic_algorithms():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev[0].record()
        leaves = [t.detach().requires_grad_() for t in
                  tree_leaves(state["params"])]
        loss = get_bundle(cfg).loss(cfg, tree_unflatten(state["params"], leaves),
                                    tb, None)
        ev[1].record()
        torch.cuda.synchronize()
        peaks["forward"] = torch.cuda.max_memory_allocated() - base
        out["saved"] = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        torch.cuda.synchronize()
        peaks["backward"] = torch.cuda.max_memory_allocated() - base
        del loss, leaves
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        new = opt.update(tree_unflatten(state["params"], grads),
                         state["opt"], state["params"], state["step"])
        ev[3].record()
        torch.cuda.synchronize()
        peaks["update"] = torch.cuda.max_memory_allocated() - base
        out["new_state"] = torch.cuda.memory_allocated() - base
    del new, grads
    for i, part in enumerate(("forward", "backward", "update")):
        out[f"{part}_ms"] = ev[i].elapsed_time(ev[i + 1])
        out[f"{part}_peak"] = peaks[part]
    return out


def lm_train_parity(*, smi: str) -> None:
    """Phase 17 (a): one AdamW step (lr 1e-2 from step 0) of every config
    at reduced() on the card against the same step on the CPU, from the
    same state; then reduced olmo's microbatches."""
    from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config, reduced
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (init_state, make_train_step,
                                           state_from_arrays)
    from repro_torch.train.tree import tree_map

    def host_tree(tree):
        return tree_map(lambda t: t.detach().cpu().numpy(), tree)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for the f32 checks")
    opt = make_optimizer(OptimizerConfig(**LMM_OPT))
    shape = ShapeConfig("check", LMT_CHECK_SEQ, LMT_CHECK_BATCH, "train")
    for i, arch in enumerate(ARCH_IDS):
        cfg = reduced(get_config(arch))
        arrays = host_tree(init_state(
            cfg, opt, torch.Generator().manual_seed(SEED + 170 + i),
            dtype=torch.float32, device="cpu"))
        batch = batch_for(cfg, shape, 0, seed=SEED + i)
        step = make_train_step(cfg, opt)
        t0 = time.perf_counter()
        got, gm = step(state_from_arrays(arrays, device="cuda"), batch)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        want, wm = step(state_from_arrays(arrays, device="cpu"), batch)
        on_card(got, f"{arch} state")
        errs = {}
        for key in ("loss", "gnorm"):
            g, w = float(gm[key]), float(wm[key])
            errs[key] = abs(g - w)
            if not (math.isfinite(g) and abs(g - w) <= LMT_TOL
                    + LMT_TOL * abs(w)):
                raise AssertionError(f"{arch} {key}: card {g} against the "
                                     f"CPU's {w}")
        errs["mu"] = max(float((x.cpu() - y).abs().max()) for x, y in
                         zip(tree_leaves(got["opt"]["mu"]),
                             tree_leaves(want["opt"]["mu"])))
        if not errs["mu"] <= LMT_TOL:
            raise AssertionError(f"{arch} mu: max |err| {errs['mu']:.3e} "
                                 f"past {LMT_TOL}")
        # the CPU's clipped gradients: mu after one step is 0.1 x them
        grads = [m / 0.1 for m in tree_leaves(want["opt"]["mu"])]
        held = [(g == 0) | (g.abs() >= LMT_G_FLOOR) for g in grads]
        small = sum(int((~m).sum()) for m in held)
        n = sum(m.numel() for m in held)
        old = [torch.from_numpy(a) for a in tree_leaves(arrays["params"])]
        cpu_new = tree_leaves(want["params"])
        excess = update_excess(tree_leaves(got["params"]), old, cpu_new,
                               held)
        if not (excess <= 1.0 and small <= LMT_SMALL_G_SHARE * n):
            raise AssertionError(f"{arch}: update error {excess:.3e} x the "
                                 f"limit; {small} of {n:,} gradients under "
                                 f"{LMT_G_FLOOR:g}")
        upd = max(float((w - o).abs().max()) for w, o in zip(cpu_new, old))
        log(f"[lm-train] (a) {arch} reduced, one AdamW step (lr "
            f"{LMM_OPT['lr']:g} from step 0) on the card against the CPU: "
            f"loss {float(gm['loss']):.6f} (|err| {errs['loss']:.2e}), gnorm "
            f"{float(gm['gnorm']):.6f} (|err| {errs['gnorm']:.2e}), mu (0.1 "
            f"x the gradients) max |err| {errs['mu']:.2e}, within rtol = "
            f"atol = {LMT_TOL}; update max {upd:.3e}, its error "
            f"{excess:.3e} x the limit ({LMM_UPDATE_RTOL:g} x each leaf's "
            f"largest update) where the gradient is 0 or >= "
            f"{LMT_G_FLOOR:g} ({small} of {n:,} under it, limit "
            f"{LMT_SMALL_G_SHARE:g} of them); card step {card_s:.3f} s "
            f"(first call); on {smi}")

    cfg = reduced(get_config("olmo-1b"))
    sgd = make_optimizer(OptimizerConfig(name="sgd", lr=1e-2, warmup_steps=0,
                                         grad_clip=1e9))
    arrays = host_tree(init_state(cfg, sgd, torch.Generator().manual_seed(
        SEED + 180), dtype=torch.float32, device="cpu"))
    batch = batch_for(cfg, ShapeConfig("micro", 32, 8, "train"), 0,
                      seed=SEED)
    s1, m1 = make_train_step(cfg, sgd, microbatches=1)(
        state_from_arrays(arrays, device="cuda"), batch)
    s2, m2 = make_train_step(cfg, sgd, microbatches=2)(
        state_from_arrays(arrays, device="cuda"), batch)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])))
    loss_rel = abs(float(m1["loss"]) - float(m2["loss"])) / \
        abs(float(m1["loss"]))
    if not (diff < LMT_MICRO_TOL and loss_rel <= 1e-5):
        raise AssertionError(f"microbatches: params {diff:.3e}, loss "
                             f"{loss_rel:.3e}")
    log(f"[lm-train] (a) olmo-1b reduced on the card: 2 microbatches of 4 "
        f"against one batch of 8: params max |err| {diff:.2e} (limit "
        f"{LMT_MICRO_TOL}), loss rel err {loss_rel:.2e}; on {smi}")


def lm_train_continuation(*, smi: str) -> None:
    """Phase 17 (b): TrainLoop at reduced olmo on the card: a failure at
    step LMT_LOOP_FAIL, a restore from the last checkpoint and the rest of
    the steps, bit for bit an uninterrupted run; then the CLI with a
    resume."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as train_cli
    from repro_torch.train.checkpoint import latest_step
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.fault import FailureInjector, TrainLoop
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import init_state, make_train_step

    cfg = reduced(get_config("olmo-1b"))
    opt = make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=2))
    dc = DataConfig(seed=SEED + 5, vocab_size=cfg.vocab_size, batch=4,
                    seq_len=32)

    def fresh():
        return init_state(cfg, opt, torch.Generator(device="cuda")
                          .manual_seed(SEED + 190), dtype=torch.float32)

    def loop(ckpt_dir=None, injector=None):
        return TrainLoop(make_train_step(cfg, opt),
                         lambda k: synthetic_batch(dc, k), ckpt_dir=ckpt_dir,
                         ckpt_every=LMT_LOOP_CKPT, injector=injector)

    t0 = time.perf_counter()
    straight, report = loop().run(fresh(), LMT_LOOP_STEPS)
    with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as tmp:
        faulty = loop(tmp, FailureInjector(fail_at=LMT_LOOP_FAIL))
        try:
            faulty.run(fresh(), LMT_LOOP_STEPS)
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as exc:
            if "injected node failure" not in str(exc):
                raise
        saved = latest_step(tmp)
        restored, step = faulty.restore(fresh())
        on_card(restored, "restored state")
        resumed, rep2 = faulty.run(restored, LMT_LOOP_STEPS - step,
                                   start_step=step)
    if saved != LMT_LOOP_CKPT or step != LMT_LOOP_CKPT:
        raise AssertionError(f"restored from step {step}, saved {saved}")
    if not bits_equal(resumed, straight):
        raise AssertionError("the restored run is not bit for bit the "
                             "uninterrupted one")
    if rep2.losses != report.losses[step:]:
        raise AssertionError(f"losses {rep2.losses} against "
                             f"{report.losses[step:]}")
    log(f"[lm-train] (b) olmo-1b reduced, TrainLoop on the card, "
        f"deterministic: failure at step {LMT_LOOP_FAIL}, restored from the "
        f"step-{step} checkpoint, {LMT_LOOP_STEPS - step} more steps: every "
        f"leaf of the state bit for bit the uninterrupted {LMT_LOOP_STEPS}-"
        f"step run's, losses equal ({report.losses[0]:.6f} -> "
        f"{report.losses[-1]:.6f}); {time.perf_counter() - t0:.3f} s; on "
        f"{smi}")

    with tempfile.TemporaryDirectory(prefix="lm_cli_") as tmp:
        args = ["--arch", "olmo-1b", "--steps", "6", "--batch", "4", "--seq",
                "64", "--ckpt-dir", tmp, "--ckpt-every", "3"]
        first = train_cli.main(args)
        again = train_cli.main(args + ["--resume", "--steps", "2"])
        last = latest_step(tmp)
    if last != 8 or not all(math.isfinite(x["last_loss"])
                            for x in (first, again)):
        raise AssertionError(f"cli: latest step {last}, {first}, {again}")
    log(f"[lm-train] (b) cli launch.train.main on the card: 6 steps, loss "
        f"{first['first_loss']:.4f} -> {first['last_loss']:.4f}, then "
        f"--resume from step 6 for 2 more (latest checkpoint step {last}); "
        f"on {smi}")


def lm_train_xent(*, smi: str) -> None:
    """Phase 17 (c): chunked_xent over olmo-1b's padded vocabulary against
    a dense log-softmax loss, in f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as LM

    cfg = get_config("olmo-1b")
    V, D, T = cfg.vocab_padded, cfg.d_model, LMT_XENT_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 200)
    h = torch.randn((2, T // 2, D), generator=gen, device="cuda")
    w = torch.randn((D, V), generator=gen, device="cuda") * 0.02
    labels = torch.randint(0, cfg.vocab_size, (2, T // 2), generator=gen,
                           device="cuda")
    labels[:, ::7] = -1
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hc, wc = h.clone().requires_grad_(), w.clone().requires_grad_()
    loss = LM.chunked_xent(hc, wc, labels)
    gh, gw = torch.autograd.grad(loss, (hc, wc))
    torch.cuda.synchronize()
    chunked_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    hd, wd = h.clone().requires_grad_(), w.clone().requires_grad_()
    logp = torch.log_softmax(hd @ wd, dim=-1)
    mask = labels >= 0
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    dense = (nll * mask).sum() / mask.sum()
    dh, dw = torch.autograd.grad(dense, (hd, wd))
    torch.cuda.synchronize()
    dense_peak = torch.cuda.max_memory_allocated() - base
    loss, dense = loss.detach(), dense.detach()
    rel = abs(float(loss) - float(dense)) / abs(float(dense))
    eh, ew = float((gh - dh).abs().max()), float((gw - dw).abs().max())
    if not (rel <= LMT_XENT_LOSS_RTOL and eh <= LMT_XENT_GRAD_TOL
            and ew <= LMT_XENT_GRAD_TOL):
        raise AssertionError(f"chunked_xent: loss rel {rel:.3e}, grad h "
                             f"{eh:.3e}, grad w {ew:.3e}")
    log(f"[lm-train] (c) chunked_xent over {T} tokens x {cfg.vocab_size} ids "
        f"(padded {V}, chunks of 16,384, {int((~mask).sum())} labels -1), "
        f"f32: loss {float(loss):.6f}, rel err {rel:.2e} against a dense "
        f"log-softmax (limit {LMT_XENT_LOSS_RTOL}); grad h max |err| "
        f"{eh:.2e}, grad w {ew:.2e} (limit {LMT_XENT_GRAD_TOL}); peak memory "
        f"over the inputs {chunked_peak / 1e6:.1f} MB chunked, "
        f"{dense_peak / 1e6:.1f} MB dense; on {smi}")


def lm_train_encdec(*, smi: str) -> None:
    """Phase 17 (d): seamless-m4t-large-v2 at full width, f32: token-by-
    token decode against prefill over each prefix, and the copied
    prefill-then-decode defect."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec as ED
    from repro_torch.models import get_bundle

    cfg = get_config("seamless-m4t-large-v2")
    log(f"[lm-train] (d) {cfg.name} at full width: {cfg.encoder_layers} "
        f"encoder + {cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.head_dim}, {cfg.mlp_type} d_ff "
        f"{cfg.d_ff}, {cfg.norm_type}, vocab {cfg.vocab_size} -> "
        f"{cfg.vocab_padded} untied; on {smi}")
    t0 = time.perf_counter()
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 210),
        dtype=torch.float32)
    torch.cuda.synchronize()
    n = lm_tree_params(cfg, params)
    log(f"[lm-train] (d) f32 params: {n:,} (the config's param_count() "
        f"{cfg.param_count():,}) drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s; on {smi}")
    B, S, N = LMT_ED_BATCH, LMT_ED_FRAMES, LMT_ED_STEPS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 211)
    frames = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, N + 1), generator=gen,
                         device="cuda")
    caches = ED.init_encdec_caches(cfg, B, LMT_ED_CTX, mem_frames=S,
                                   dtype=torch.float32)
    caches["memory"] = ED.encode(cfg, params, frames)
    worst = 0.0
    for i in range(N):
        got, caches = ED.encdec_decode(cfg, params, caches, toks[:, i:i + 1])
        want, _ = ED.encdec_prefill(cfg, params, frames, toks[:, :i + 1])
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not (bool(torch.isfinite(got).all())
                and torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL)):
            raise AssertionError(f"enc-dec decode step {i}: max |err| "
                                 f"{err:.3e} past rtol = atol = {LM_TOL}")
    on_card(caches, "enc-dec caches")
    log(f"[lm-train] (d) f32, {B} x {S} frames: {N} decode steps from "
        f"init_encdec_caches(ctx={LMT_ED_CTX}) with memory = encode(frames),"
        f" each within rtol = atol = {LM_TOL} of encdec_prefill over the "
        f"same prefix, max |err| {worst:.3e}, logits up to "
        f"{float(want.abs().max()):.3f}; on {smi}")
    del caches
    _, pc = ED.encdec_prefill(cfg, params, frames, toks[:, :N])
    after, pc = ED.encdec_decode(cfg, params, pc, toks[:, N:N + 1])
    full, _ = ED.encdec_prefill(cfg, params, frames, toks)
    gap = float((after - full).abs().max())
    if not gap > 10 * LM_TOL:
        raise AssertionError(f"the prefill-then-decode defect did not show: "
                             f"gap {gap:.3e}")
    log(f"[lm-train] (d) the copied defect: prefill over {N} tokens, then "
        f"one decode (slot {N} % {pc['self']['k'].shape[2]} = 0 overwritten)"
        f": logits {gap:.3f} (max |err|) off a prefill over {N + 1}, as on "
        f"the CPU; on {smi}")
    del params, pc, frames
    free_card()


def lm_train_full(arch: str, *, smi: str) -> None:
    """Phase 17 (e) for one model: bf16 parameters, AdamW, the config's
    own remat, deterministic steps, LMT_STEPS steps through TrainLoop."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.train.data import batch_for
    from repro_torch.train.fault import TrainLoop
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import init_state, make_train_step

    tag = f"[lm-train] (e) {arch}"
    cfg = get_config(arch)
    B, S = LMT_BATCH, LMT_SEQ
    shape = ShapeConfig("train_1k", S, B, "train")
    tokens = B * (S // cfg.dec_len_ratio if cfg.encoder_layers else S)
    flops, formula = train_step_flops(cfg, B, S)
    opt = make_optimizer(OptimizerConfig(lr=1e-4, warmup_steps=2))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, opt, torch.Generator(device="cuda").manual_seed(
        SEED + 220))
    torch.cuda.synchronize()
    n = lm_tree_params(cfg, state["params"])
    state_bytes = sum(t.nbytes for t in tree_leaves(state))
    log(f"{tag} bf16 params {n:,}, AdamW state (params bf16 + f32 mu, nu, "
        f"master) {state_bytes / 1e9:.3f} GB, on the card in "
        f"{time.perf_counter() - t0:.3f} s; remat {cfg.remat} "
        f"({cfg.remat_policy}); batch {B} x {S}"
        + (f" frames + {B} x {S // cfg.dec_len_ratio} decoder tokens"
           if cfg.encoder_layers else " tokens") + f"; on {smi}")
    batches = {k: batch_for(cfg, shape, k, seed=SEED)
               for k in range(LMT_STEPS + LMT_PROFILE_STEPS
                              + LMT_LOOSE_STEPS)}
    gnorms = []

    def stepper(step_fn):
        def run(st, batch):
            st, m = step_fn(st, batch)
            gnorms.append(m["gnorm"])
            return st, m
        return run

    step = make_train_step(cfg, opt)
    # the loop holds the only reference to the initial state, so that it
    # goes after step 0 as every later step's input does
    start = {"state": state}
    del state
    state, report = TrainLoop(stepper(step), batches.__getitem__).run(
        start.pop("state"), LMT_STEPS)
    norms = [float(g) for g in gnorms]
    if not all(math.isfinite(x) for x in report.losses + norms):
        raise AssertionError(f"{arch}: losses {report.losses}, gnorm {norms}")
    walls = np.array(report.step_times[1:]) * 1e3
    p50, p99 = np.percentile(walls, [50, 99])
    per_s = tokens * len(walls) / (walls.sum() / 1e3)
    mfu = flops / (p50 / 1e3) / BF16_TENSOR_FLOPS
    log(f"{tag} {LMT_STEPS} deterministic steps, losses "
        + " ".join(f"{x:.4f}" for x in report.losses)
        + "; gnorm " + " ".join(f"{x:.3f}" for x in norms) + f"; on {smi}")
    log(f"{tag} step wall (steps 1-{LMT_STEPS - 1}) p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms, first step {1e3 * report.step_times[0]:.3f} ms; "
        f"{per_s:.1f} training tokens/s; model FLOPs a step {flops:.4e} "
        f"= {formula}; at the p50 wall {flops / (p50 / 1e3) / 1e12:.1f} "
        f"TFLOP/s = {100 * mfu:.2f} % of the {BF16_TENSOR_FLOPS / 1e12:.1f} "
        f"TFLOP/s dense bf16 peak; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; on {smi}")

    k0 = LMT_STEPS
    state_bytes = sum(t.nbytes for t in tree_leaves(state))
    bd = step_breakdown(cfg, opt, state, batches[k0])
    log(f"{tag} one step taken apart (CUDA events; memory above the "
        f"{state_bytes / 1e9:.3f} GB state): forward {bd['forward_ms']:.3f}"
        f" ms (peak +{bd['forward_peak'] / 1e9:.3f} GB, "
        f"{bd['saved'] / 1e9:.3f} GB kept for backward), backward "
        f"{bd['backward_ms']:.3f} ms (peak +{bd['backward_peak'] / 1e9:.3f}"
        f" GB), optimizer update {bd['update_ms']:.3f} ms (peak "
        f"+{bd['update_peak'] / 1e9:.3f} GB over the state and the "
        f"gradients, the new state {bd['new_state'] / 1e9:.3f} GB); on "
        f"{smi}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(k0, k0 + LMT_PROFILE_STEPS):
            state, m = step(state, batches[k])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    every, kernels, _ = device_intervals(prof)
    busy = union_us(every)
    log(f"{tag} profile of {LMT_PROFILE_STEPS} steps: wall "
        f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms = "
        f"{100 * busy / wall_us:.1f} % (idle {100 - 100 * busy / wall_us:.1f}"
        f" %), {len(kernels) / LMT_PROFILE_STEPS:.1f} kernels a step; on "
        f"{smi}")
    log_device_time(prof, 8)

    loose = make_train_step(cfg, opt, deterministic=False)
    k0 += LMT_PROFILE_STEPS
    lw = []
    for k in range(k0, k0 + LMT_LOOSE_STEPS):
        t0 = time.perf_counter()
        state, m = loose(state, batches[k])
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"{arch}: loss {float(m['loss'])}")
        lw.append(1e3 * (time.perf_counter() - t0))
    lp50 = float(np.median(lw[1:]))
    log(f"{tag} deterministic mode's cost: {LMT_LOOSE_STEPS - 1} steps "
        f"without it p50 {lp50:.3f} ms against {p50:.3f} ms with it = "
        f"{p50 / lp50:.4f}x; on {smi}")
    del state, m, batches, gnorms
    free_card()


def lm_train_phase(*, smi: str) -> None:
    """Phase 17: the LM training path (models' loss and remat, the
    optimizers, train step, checkpoints, TrainLoop, launch/train.py) and
    the enc-dec model."""
    t_phase = time.perf_counter()
    lm_train_parity(smi=smi)
    lm_train_continuation(smi=smi)
    lm_train_xent(smi=smi)
    lm_train_encdec(smi=smi)
    for arch in LMT_ARCHS:
        lm_train_full(arch, smi=smi)
    log(f"[lm-train] phase wall {time.perf_counter() - t_phase:.3f} s; on "
        f"{smi}")


def loss_and_grads(cfg, params, batch, splan):
    """The loss and its gradients over ``params`` as the train step takes
    them (deterministic on the card)."""
    from repro_torch.models import get_bundle
    from repro_torch.train.trainer import deterministic_algorithms
    from repro_torch.train.tree import tree_leaves as leaves_of
    from repro_torch.train.tree import tree_unflatten

    dev = leaves_of(params)[0].device
    tb = {k: (torch.from_numpy(a) if a.dtype.kind == "f"
              else torch.from_numpy(a).long()).to(dev)
          for k, a in batch.items()}
    with deterministic_algorithms(dev.type == "cuda"):
        leaves = [t.detach().requires_grad_() for t in leaves_of(params)]
        loss = get_bundle(cfg).loss(cfg, tree_unflatten(params, leaves), tb,
                                    splan)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def update_excess(new, old, want, same) -> float:
    """The worst leaf's max |(new - old) - (want - old)| over the elements
    where ``same``, as a multiple of LMM_UPDATE_RTOL x that leaf's largest
    update ``want - old``: at most 1 passes."""
    worst = 0.0
    for g, o, w, m in zip(new, old, want, same):
        ref = w - o
        if bool(m.any()):
            err = float(((g.cpu() - o) - ref)[m].abs().max())
            worst = max(worst, err / (LMM_UPDATE_RTOL
                                      * float(ref.abs().max()) or 1e-30))
    return worst


def lm_mesh_parity(*, smi: str) -> None:
    """Phase 18 (a): one f32 AdamW step with grad_compress of every config
    at reduced() on the (pod 2, data 2, model 2) mesh of card positions,
    against the same step on CPU positions from the same state; the card's
    step without compression must miss the update limit."""
    from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config, reduced
    from repro_torch.dist.compression import quantize_int8
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (init_state, jit_train_step,
                                           state_from_arrays)
    from repro_torch.train.tree import tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for the f32 checks")
    cards = make_position_mesh(LMM_TRAIN_MESH, "cuda:0")
    cpus = make_position_mesh(LMM_TRAIN_MESH, "cpu")
    opt = make_optimizer(OptimizerConfig(**LMM_OPT))
    shape = ShapeConfig("mesh", LMT_CHECK_SEQ, LMT_CHECK_BATCH, "train")
    for i, arch in enumerate(ARCH_IDS):
        cfg = reduced(get_config(arch))
        arrays = tree_map(lambda t: t.numpy(), init_state(
            cfg, opt, torch.Generator().manual_seed(SEED + 300 + i),
            dtype=torch.float32, device="cpu"))
        batch = batch_for(cfg, shape, 0, seed=SEED + i)
        step, splan = jit_train_step(cfg, opt, cards, grad_compress=True)
        t0 = time.perf_counter()
        got, gm = step(state_from_arrays(arrays, device="cuda"), batch)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        on_card(got, f"{arch} mesh state")
        plain, pm = jit_train_step(cfg, opt, cards)[0](
            state_from_arrays(arrays, device="cuda"), batch)
        want, wm = jit_train_step(cfg, opt, cpus, grad_compress=True)[0](
            state_from_arrays(arrays, device="cpu"), batch)
        g, w = float(gm["loss"]), float(wm["loss"])
        if not (math.isfinite(g) and abs(g - w) <= LMT_TOL
                + LMT_TOL * abs(w)):
            raise AssertionError(f"{arch} loss: card {g} against the "
                                 f"CPU's {w}")
        g, w = float(gm["gnorm"]), float(wm["gnorm"])
        gnorm_rel = abs(g - w) / abs(w)
        plain_rel = abs(float(pm["gnorm"]) - w) / abs(w)
        if not (math.isfinite(g) and gnorm_rel <= min(
                LMM_GNORM_RTOL, plain_rel / LMM_MISS_GNORM)):
            raise AssertionError(f"{arch} gnorm: card {g} against the "
                                 f"CPU's {w}, the uncompressed step's "
                                 f"{float(pm['gnorm'])}")
        _, gc = loss_and_grads(cfg, state_from_arrays(arrays, device="cuda")
                               ["params"], batch, splan)
        _, gh = loss_and_grads(cfg, state_from_arrays(arrays, device="cpu")
                               ["params"], batch, make_plan(cfg, cpus))
        same = [quantize_int8(x)[0].cpu() == quantize_int8(y)[0]
                for x, y in zip(tree_leaves(gc), tree_leaves(gh))]
        flips = sum(int((~m).sum()) for m in same)
        n = sum(m.numel() for m in same)
        old = [torch.from_numpy(a) for a in tree_leaves(arrays["params"])]
        cpu_new = tree_leaves(want["params"])
        excess = update_excess(tree_leaves(got["params"]), old, cpu_new,
                               same)
        plain_excess = update_excess(tree_leaves(plain["params"]), old,
                                     cpu_new, same)
        if not (excess <= 1.0 and flips <= LMM_FLIP_SHARE * n):
            raise AssertionError(f"{arch}: update error {excess:.3e} x the "
                                 f"limit where the levels agree, {flips} of "
                                 f"{n:,} levels differ")
        if not plain_excess > LMM_MISS:
            raise AssertionError(f"{arch}: the step without compression is "
                                 f"within {plain_excess:.3e} x the update "
                                 f"limit: the check cannot see compression")
        upd = max(float((w - o).abs().max()) for w, o in zip(cpu_new, old))
        log(f"[lm-mesh] (a) {arch} reduced on (pod 2, data 2, model 2), "
            f"{splan.attn_mode}, one AdamW step (lr {LMM_OPT['lr']:g} from "
            f"step 0) with grad_compress on the card against the CPU: loss "
            f"{float(gm['loss']):.6f} (|err| "
            f"{abs(float(gm['loss']) - float(wm['loss'])):.2e}), gnorm "
            f"{float(gm['gnorm']):.6f} (rel err {gnorm_rel:.2e}, limit "
            f"{LMM_GNORM_RTOL:g} and 1/{LMM_MISS_GNORM:g} of the uncompressed"
            f" step's {plain_rel:.2e}); "
            f"update max {upd:.3e}, its error where the int8 levels agree "
            f"{excess:.3e} x the limit ({LMM_UPDATE_RTOL:g} x each leaf's "
            f"largest update), the uncompressed step's {plain_excess:.3e} x; "
            f"{flips} of {n:,} levels differ (limit {LMM_FLIP_SHARE:g} of "
            f"them); card step {card_s:.3f} s (first call); on {smi}")


def lm_mesh_ep(*, smi: str) -> None:
    """Phase 18 (b): llama4-scout at full width on the (data 1, model 4)
    mesh: EP decode and no-drop EP prefill against the mesh-less paths in
    f32, the kept count at the config's capacity, then bf16 serving on the
    mesh plan beside the mesh-less twin."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.models import get_bundle
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve.router import TIER_BATCH

    tag = "[lm-mesh] (b) " + LMM_ARCH_EP
    full = get_config(LMM_ARCH_EP)
    serve_layers, check_layers = LMF_LAYERS[LMM_ARCH_EP]
    mesh = make_position_mesh(LMM_SERVE_MESH, "cuda:0")
    ccfg = dataclasses.replace(full, num_layers=check_layers)
    bundle = get_bundle(ccfg)
    params = bundle.init(
        ccfg, torch.Generator(device="cuda").manual_seed(SEED + 310),
        dtype=torch.float32)
    n = lm_tree_params(ccfg, params)
    E = ccfg.num_experts
    tcfg = dataclasses.replace(ccfg, capacity_factor=float(E))
    Bc, Sc, N = LMF_CHECK_BATCH, LMF_CHECK_LEN, LMF_CHECK_STEPS
    splan = make_plan(ccfg, mesh, decode_batch=Bc)
    n_model = mesh.shape["model"]
    toks = torch.randint(
        0, ccfg.vocab_size, (Bc, Sc + N), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 311))
    t0 = time.perf_counter()
    got, _ = LM.lm_prefill(tcfg, params, toks[:, :Sc], splan=splan)
    torch.cuda.synchronize()
    ep_s = time.perf_counter() - t0
    want, caches = LM.lm_prefill(tcfg, params, toks[:, :Sc], ctx=Sc + N)
    pre_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL):
        raise AssertionError(f"EP prefill: max |err| {pre_err:.3e}")
    worst = 0.0
    for i in range(N):
        mine = {k: (v if k == "index" else {kk: t.clone()
                                            for kk, t in v.items()})
                for k, v in caches.items()}
        g, _ = LM.lm_decode(ccfg, params, mine, toks[:, Sc + i:Sc + i + 1],
                            splan=splan)
        w, caches = LM.lm_decode(ccfg, params, caches,
                                 toks[:, Sc + i:Sc + i + 1])
        worst = max(worst, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=LM_TOL, atol=LM_TOL):
            raise AssertionError(f"EP decode step {i}: max |err| {worst:.3e}")
    del mine, caches
    log(f"{tag} f32 at {check_layers} layers ({n:,} params) on (data 1, "
        f"model 4), {splan.attn_mode}: EP prefill {Bc} x {Sc} at "
        f"capacity_factor {E:g} (no block drops) within rtol = atol = "
        f"{LM_TOL} of the mesh-less prefill, max |err| {pre_err:.3e} (EP "
        f"prefill {ep_s:.3f} s, first call); {N} EP decode steps (each of "
        f"{n_model} positions' {E // n_model} local experts, summed in model "
        f"order) within "
        f"{LM_TOL} of the per-token gather, max |err| {worst:.3e}; on {smi}")

    # the config's own capacity: block by block
    moe = {k: (v[0] if torch.is_tensor(v) else {kk: t[0]
                                               for kk, t in v.items()})
           for k, v in params["blocks"]["p0"]["moe"].items()}
    x = torch.randn((Bc, Sc, ccfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 312))
    cap = L.ep_capacity(ccfg, splan, x)
    _, eidx, keep = L.moe_dispatch_blocks(moe, x, 1, n_model, cap)
    routed = torch.nn.functional.one_hot(eidx, E).sum(1)
    want_kept = int(routed.clamp(max=cap).sum())
    if int(keep.sum()) != want_kept:
        raise AssertionError(f"kept {int(keep.sum())}, the blocks' "
                             f"capacity admits {want_kept}")
    plain_cap = max(1, int(Bc * Sc * ccfg.capacity_factor / E))
    _, _, plain_keep = L.moe_dispatch_blocks(moe, x, 1, 1, plain_cap)
    own, _ = LM.lm_prefill(ccfg, params, toks[:, :Sc], splan=splan)
    if not bool(torch.isfinite(own).all()):
        raise AssertionError("EP prefill at the config's capacity: "
                             "non-finite logits")
    log(f"{tag} at capacity_factor {ccfg.capacity_factor}: {n_model} "
        f"blocks of {Bc * Sc // n_model} tokens, cap_src {cap} a block and expert, kept "
        f"{int(keep.sum())} of {keep.numel()} = sum over blocks and experts "
        f"of min(routed, cap_src); the mesh-less layer (capacity "
        f"{plain_cap}) keeps {int(plain_keep.sum())}; the EP model's "
        f"logits finite; on {smi}")
    del params, moe, x, got, want, own
    free_card()

    cfg = dataclasses.replace(full, num_layers=serve_layers)
    torch.cuda.reset_peak_memory_stats()
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 313))
    rng = np.random.default_rng(SEED + 314)
    script = []
    for _ in range(LMF_REQUESTS):
        plen = int(rng.integers(LMF_PROMPT_LEN[0], LMF_PROMPT_LEN[1] + 1))
        mnt = int(rng.integers(LMF_NEW_TOKENS[0], LMF_NEW_TOKENS[1] + 1))
        script.append((rng.integers(0, cfg.vocab_size, plen), mnt,
                       TIER_BATCH))
    splan = make_plan(cfg, mesh, decode_batch=LM_SLOTS)
    twin = lm_bf16_serving(f"{tag} twin", cfg, params, script,
                           seed=SEED + 315, smi=smi)
    torch.cuda.reset_peak_memory_stats()
    ep = lm_bf16_serving(f"{tag} mesh", cfg, params, script,
                         seed=SEED + 315, smi=smi, splan=splan)
    moe_layers = sum(p.use_moe for p in LM.make_layer_plans(cfg)) * \
        cfg.num_blocks
    item = params["embed"].element_size()
    per = 3 * cfg.d_model * cfg.d_ff * item
    ep_bytes = moe_layers * E * per
    gather_bytes = moe_layers * LM_SLOTS * per
    log(f"{tag} bf16 serving on the mesh plan against its mesh-less twin "
        f"(mesh / twin): tokens/s {ep['tokens_s']:.1f} / "
        f"{twin['tokens_s']:.1f} = {ep['tokens_s'] / twin['tokens_s']:.3f};"
        f" decode tick p50 {ep['p50_ms']:.3f} / {twin['p50_ms']:.3f} ms = "
        f"{ep['p50_ms'] / twin['p50_ms']:.3f}, p99 {ep['p99_ms']:.3f} / "
        f"{twin['p99_ms']:.3f} ms = {ep['p99_ms'] / twin['p99_ms']:.3f}; "
        f"kernels a tick {ep['kernels_tick']:.1f} / "
        f"{twin['kernels_tick']:.1f} = "
        f"{ep['kernels_tick'] / twin['kernels_tick']:.3f}; busy "
        f"{100 * ep['busy']:.1f} / {100 * twin['busy']:.1f} %; expert-weight"
        f" bytes a tick {ep_bytes / 1e9:.3f} GB read in place ({moe_layers} "
        f"MoE layers x {E} experts x 3 matrices) / {gather_bytes / 1e9:.3f} "
        f"GB gathered (and copied) for {LM_SLOTS} tokens = "
        f"{ep_bytes / gather_bytes:.3f}; peak memory {ep['peak_gb']:.3f} / "
        f"{twin['peak_gb']:.3f} GB; on {smi}")
    del params
    free_card()


def lm_mesh_train(*, smi: str) -> None:
    """Phase 18 (c): olmo-1b at full width, bf16, AdamW, full remat,
    deterministic, on the (pod 2, data 2, model 2) mesh with grad_compress:
    step 1 against the mesh-less twin, bit for bit; timed steps a side;
    save, restore_checkpoint(mesh=) and a next step, bit for bit."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.dist.compression import compress_grads_crosspod
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (deterministic_algorithms,
                                           init_state, jit_train_step,
                                           make_train_step, place_state)

    tag = "[lm-mesh] (c) olmo-1b"
    cfg = get_config("olmo-1b")
    mesh = make_position_mesh(LMM_TRAIN_MESH, "cuda:0")
    shape = ShapeConfig("train_1k", LMT_SEQ, LMT_BATCH, "train")
    batches = [batch_for(cfg, shape, k, seed=SEED) for k in
               range(LMM_STEPS + 2)]
    opt = make_optimizer(OptimizerConfig(lr=1e-4, warmup_steps=2))
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, opt, torch.Generator(device="cuda").manual_seed(
        SEED + 320))
    step, splan = jit_train_step(cfg, opt, mesh, grad_compress=True)
    new, m = step(state, batches[0])
    on_card(new, "mesh state")
    params1 = new["params"]
    # the twin: the mesh-less gradients, int8-round-tripped, then the update
    loss, grads = loss_and_grads(cfg, state["params"], batches[0], None)
    with deterministic_algorithms():
        twin_params, _ = opt.update(compress_grads_crosspod(grads, None),
                                    state["opt"], state["params"],
                                    state["step"])
    # the mesh step's own work beside the twin's: the int8 round trip of
    # every gradient (CUDA events) and the two placements of the state
    # (host wall, synchronized)
    rt_ms = []
    for _ in range(LMM_RT_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sent = compress_grads_crosspod(grads, mesh)
        ev[1].record()
        torch.cuda.synchronize()
        rt_ms.append(ev[0].elapsed_time(ev[1]))
        del sent
    n_grads = sum(t.numel() for t in tree_leaves(grads))
    del grads
    place_ms = []
    for _ in range(LMM_RT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        place_state(state, mesh)
        torch.cuda.synchronize()
        place_ms.append(1e3 * (time.perf_counter() - t0))
    if not bits_equal({"l": m["loss"]}, {"l": loss}):
        raise AssertionError(f"step 1 loss {float(m['loss'])} against the "
                             f"twin's {float(loss)}")
    if not bits_equal(params1, twin_params):
        raise AssertionError("step 1 params are not the twin's update over "
                             "its round-tripped gradients")
    log(f"{tag} full width, bf16, AdamW, remat {cfg.remat_policy}, "
        f"deterministic, {LMT_BATCH} x {LMT_SEQ} tokens on (pod 2, data 2, "
        f"model 2), {splan.attn_mode}, grad_compress: step 1 loss "
        f"{float(m['loss']):.6f} bit for bit the mesh-less twin's; every new "
        f"parameter bit for bit the twin's update over its int8-round-"
        f"tripped gradients; on {smi}")
    del twin_params, state, params1

    state_gb = sum(t.nbytes for t in tree_leaves(new)) / 1e9
    with tempfile.TemporaryDirectory(prefix="lm_mesh_ckpt_") as tmp:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        t0 = time.perf_counter()
        save_checkpoint(tmp, new, 1)
        save_s = time.perf_counter() - t0
        s1, _ = step(new, batches[1])
        del new
        t0 = time.perf_counter()
        restored, at = restore_checkpoint(tmp, s1, mesh=mesh)
        restore_s = time.perf_counter() - t0
    on_card(restored, "restored state")
    r1, _ = step(restored, batches[1])
    del restored
    if at != 1 or not bits_equal(r1, s1):
        raise AssertionError("the restored step is not bit for bit the "
                             "unrestored one")
    del r1
    log(f"{tag} saved the step-1 state ({state_gb:.3f} GB) in {save_s:.3f} "
        f"s to a temporary directory ({free_gb:.1f} GB free before), "
        f"restore_checkpoint(mesh=) in {restore_s:.3f} s; the next step "
        f"from the restore bit for bit the unrestored loop's; on {smi}")

    walls = {"mesh": [], "twin": []}
    peaks = {}
    twin_step = make_train_step(cfg, opt)
    for side, fn in (("mesh", step), ("twin", twin_step)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cur = s1
        for k in range(2, LMM_STEPS + 2):
            t0 = time.perf_counter()
            cur, mk = fn(cur, batches[k])
            float(mk["loss"])
            walls[side].append(1e3 * (time.perf_counter() - t0))
        peaks[side] = torch.cuda.max_memory_allocated() / 1e9
        del cur
    mp, tp = np.median(walls["mesh"]), np.median(walls["twin"])
    rt, pl = float(np.median(rt_ms)), float(np.median(place_ms))
    log(f"{tag} {LMM_STEPS} steps a side from the same state: step wall p50 "
        f"mesh {mp:.3f} ms / twin {tp:.3f} ms = {mp / tp:.4f}, walls mesh "
        + " ".join(f"{w:.1f}" for w in walls["mesh"]) + " twin "
        + " ".join(f"{w:.1f}" for w in walls["twin"])
        + f" ms; the mesh's step adds {mp - tp:.3f} ms: the int8 round trip"
        f" of the {n_grads:,} gradients p50 {rt:.3f} ms (CUDA events, "
        f"{LMM_RT_REPS} reps: " + " ".join(f"{x:.3f}" for x in rt_ms)
        + f"), two placements of the state 2 x {pl:.3f} ms (host wall, "
        f"{LMM_RT_REPS} reps), the rest {mp - tp - rt - 2 * pl:.3f} ms "
        f"(the shard checks, by difference); peak memory mesh "
        f"{peaks['mesh']:.3f} GB / twin {peaks['twin']:.3f} GB; on {smi}")
    del s1
    free_card()


def lm_mesh_phase(*, smi: str) -> None:
    """Phase 18: the LM on a mesh of positions on the card."""
    t_phase = time.perf_counter()
    lm_mesh_parity(smi=smi)
    lm_mesh_ep(smi=smi)
    lm_mesh_train(smi=smi)
    log(f"[lm-mesh] phase wall {time.perf_counter() - t_phase:.3f} s; on "
        f"{smi}")


def count_diff(card: dict, meta: dict, what: str) -> list[str]:
    """The card's and meta's counts of one call: FLOPs and the collective
    record must be equal (raises otherwise); each aten op whose count or
    bytes differ is returned as a line, and one not in DRY_DEVICE_OPS
    raises."""
    for k in ("flops", "collective_bytes", "collective_wire_bytes",
              "collective_counts"):
        if card[k] != meta[k]:
            raise AssertionError(f"{what}: {k} card {card[k]} against meta "
                                 f"{meta[k]}")
    lines, unknown = [], []
    a, b = card["by_op"], meta["by_op"]
    for op in sorted(set(a) | set(b)):
        ca, cb = a.get(op, {}), b.get(op, {})
        if (ca.get("count"), ca.get("bytes")) == (cb.get("count"),
                                                  cb.get("bytes")):
            continue
        lines.append(f"{op}: card {ca.get('count', 0)} ops / "
                     f"{ca.get('bytes', 0):,} B, meta {cb.get('count', 0)} "
                     f"ops / {cb.get('bytes', 0):,} B ("
                     + DRY_DEVICE_OPS.get(op, "UNEXPLAINED") + ")")
        if op not in DRY_DEVICE_OPS:
            unknown.append(op)
    if unknown:
        raise AssertionError(f"{what}: the card and meta differ by "
                             f"{unknown}: " + "; ".join(lines))
    return lines


def device_time(run, n: int) -> tuple[float, float]:
    """``run()`` ``n`` times under a CUDA-only profiler: (device time, the
    union of every kernel and copy span, ms a run; kernels and copies a
    run)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    every, _, _ = device_intervals(prof)
    if not every:
        raise AssertionError("the profiler saw no device time")
    return union_us(every) / 1e3 / n, len(every) / n


def bound_line(cost: dict, positions: int, device_ms: float,
               what: str) -> str:
    """The H100 roofline terms of a count (per position, as the dry-run
    reports them) and the whole call's bound (every position on one
    card: max of FLOPs over the bf16 peak and bytes over HBM) as a share
    of its measured device time; a share past 1 raises."""
    from repro_torch.launch.mesh import H100
    from repro_torch.launch.roofline import roofline_terms

    terms = roofline_terms(flops_per_chip=cost["flops"] / positions,
                           bytes_per_chip=cost["bytes"] / positions,
                           coll_bytes_per_chip=cost["collective_bytes"]
                           / positions, peak=H100)
    compute_ms = 1e3 * cost["flops"] / H100["peak_flops_bf16"]
    memory_ms = 1e3 * cost["bytes"] / H100["hbm_bandwidth"]
    bound = max(compute_ms, memory_ms)
    share = bound / device_ms
    if share > 1.0:
        raise AssertionError(f"{what}: the counted bound {bound:.3f} ms "
                             f"beats the measured {device_ms:.3f} ms")
    return (f"H100 terms a position ({positions}): compute "
            f"{terms['compute_s'] * 1e3:.4f} ms, memory "
            f"{terms['memory_s'] * 1e3:.4f} ms, collective "
            f"{terms['collective_s'] * 1e3:.4f} ms, dominant "
            f"{terms['dominant']}; on one card the call's bound "
            f"{bound:.3f} ms (compute {compute_ms:.3f}, memory "
            f"{memory_ms:.3f}) = {100 * share:.1f} % of its {device_ms:.3f} "
            f"ms of device time")


def dryrun_train(*, smi: str) -> None:
    """Phase 19 (a): phase 18 (c)'s olmo-1b step counted on the card and on
    meta; timed and profiled steps; the count's bound against them."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import init_state, jit_train_step

    tag = "[dryrun] (a) olmo-1b"
    cfg = get_config("olmo-1b")
    shape = ShapeConfig("train_1k", LMT_SEQ, LMT_BATCH, "train")
    batches = [batch_for(cfg, shape, k, seed=SEED)
               for k in range(1 + DRY_STEPS + DRY_PROFILE_STEPS)]
    opt = make_optimizer(OptimizerConfig(lr=1e-4, warmup_steps=2))
    positions = int(np.prod([n for _, n in LMM_TRAIN_MESH]))
    counts, steps = {}, {}
    for dev in ("meta", "cuda:0"):
        mesh = make_position_mesh(LMM_TRAIN_MESH, dev)
        step, _ = jit_train_step(cfg, opt, mesh, grad_compress=True)
        gen = (torch.Generator() if dev == "meta"
               else torch.Generator(device="cuda"))
        state = init_state(cfg, opt, gen.manual_seed(SEED + 190),
                           device=dev)
        if dev != "meta":
            on_card(state, "state")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        counts[dev] = hlo_cost.analyze(step, state, batches[0])
        if dev != "meta":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        count_s = time.perf_counter() - t0
        steps[dev] = (step, state, count_s)
    card, meta = counts["cuda:0"], counts["meta"]
    diff = count_diff(card, meta, "olmo-1b step")
    log(f"{tag} full width, bf16 + f32 AdamW, remat {cfg.remat_policy}, "
        f"deterministic, {LMT_BATCH} x {LMT_SEQ} tokens on (pod 2, data 2, "
        f"model 2), grad_compress: one step counted on the card "
        f"({steps['cuda:0'][2]:.3f} s) and on meta ({steps['meta'][2]:.3f} "
        f"s): FLOPs {card['flops']:.6e} equal, collectives "
        f"{card['collective_counts']} {card['collective_bytes']:,.0f} B "
        f"(wire {card['collective_wire_bytes']:,.0f} B) equal; bytes card "
        f"{card['bytes']:,.0f} / meta {meta['bytes']:,.0f}, ops card "
        f"{card['ops']} / meta {meta['ops']}"
        + ("; differing ops: " + "; ".join(diff) if diff else
           "; every op's count and bytes equal") + f"; on {smi}")
    step, state, _ = steps["cuda:0"]
    del steps
    walls = []
    for k in range(1, 1 + DRY_STEPS):
        t0 = time.perf_counter()
        _, m = step(state, batches[k])
        float(m["loss"])
        walls.append(1e3 * (time.perf_counter() - t0))
        del m
    it = iter(batches[1 + DRY_STEPS:])
    dev_ms, launches = device_time(lambda: step(state, next(it)),
                                   DRY_PROFILE_STEPS)
    log(f"{tag} {DRY_STEPS} timed steps: wall p50 {np.median(walls):.3f} ms "
        f"(" + " ".join(f"{w:.1f}" for w in walls) + f" ms); profile of "
        f"{DRY_PROFILE_STEPS} steps: device time {dev_ms:.3f} ms a step, "
        f"{launches:.1f} kernels and copies a step (the count: "
        f"{card['ops']} aten ops); "
        + bound_line(card, positions, dev_ms, "olmo-1b step")
        + f"; peak live bytes counted {card['peak_live_bytes'] / 1e9:.3f} GB"
        f" (meta {meta['peak_live_bytes'] / 1e9:.3f} GB) against "
        f"max_memory_allocated {peak / 1e9:.3f} GB of the counted step; on "
        f"{smi}")
    del state, step
    free_card()


def dryrun_decode(*, smi: str) -> None:
    """Phase 19 (b): llama4-scout at phase 16's cut: one decode call of the
    EP path on (data 1, model 4) and of the mesh-less gather, each counted
    on the card and on meta and profiled; the counts' bounds and ranking
    against the card's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.mesh import H100, make_position_mesh
    from repro_torch.models import lm as LM

    tag = "[dryrun] (b) " + LMM_ARCH_EP
    cfg = dataclasses.replace(get_config(LMM_ARCH_EP),
                              num_layers=LMF_LAYERS[LMM_ARCH_EP][0])
    n_model = dict(LMM_SERVE_MESH)["model"]
    trees = {}
    for dev in ("meta", "cuda"):
        gen = (torch.Generator() if dev == "meta"
               else torch.Generator(device="cuda"))
        params = LM.init_lm(cfg, gen.manual_seed(SEED + 191), device=dev)
        caches = LM.init_caches(cfg, LM_SLOTS, LM_MAX_CTX, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (LM_SLOTS, 1),
                            generator=torch.Generator().manual_seed(
                                SEED + 192)).to(dev)
        mesh = make_position_mesh(LMM_SERVE_MESH,
                                  "meta" if dev == "meta" else "cuda:0")
        trees[dev] = (params, caches, tok, mesh)
    res = {}
    for side in ("ep", "gather"):
        counts = {}
        for dev, (params, caches, tok, mesh) in trees.items():
            splan = (make_plan(cfg, mesh, decode_batch=LM_SLOTS)
                     if side == "ep" else None)
            counts[dev] = hlo_cost.analyze(LM.lm_decode, cfg, params, caches,
                                           tok, splan=splan)
        card, meta = counts["cuda"], counts["meta"]
        diff = count_diff(card, meta, f"{side} decode")
        params, caches, tok, mesh = trees["cuda"]
        splan = (make_plan(cfg, mesh, decode_batch=LM_SLOTS)
                 if side == "ep" else None)
        dev_ms, launches = device_time(lambda: LM.lm_decode(
            cfg, params, caches, tok, splan=splan), DRY_TICKS)
        res[side] = (card, dev_ms)
        positions = n_model if side == "ep" else 1
        log(f"{tag} {side}, {cfg.num_layers} layers, {LM_SLOTS} slots x "
            f"{LM_MAX_CTX} positions, bf16: one decode call counted on the "
            f"card and on meta: FLOPs {card['flops']:.6e} equal, "
            f"collectives {card['collective_counts']} "
            f"{card['collective_bytes']:,.0f} B equal, bytes "
            f"{card['bytes']:,.0f} / {meta['bytes']:,.0f}, ops {card['ops']}"
            f" / {meta['ops']}"
            + ("; differing ops: " + "; ".join(diff) if diff else
               "; every op's count and bytes equal")
            + f"; {DRY_TICKS} profiled calls: device time {dev_ms:.3f} ms a "
            f"call, {launches:.1f} kernels and copies a call; "
            + bound_line(card, positions, dev_ms, f"{side} decode")
            + f"; on {smi}")
    (ep, ep_ms), (ga, ga_ms) = res["ep"], res["gather"]
    mem = {k: 1e3 * c["bytes"] / H100["hbm_bandwidth"]
           for k, (c, _) in res.items()}
    same = (mem["ep"] < mem["gather"]) == (ep_ms < ga_ms)
    log(f"{tag} EP / gather: counted memory_s {mem['ep']:.3f} / "
        f"{mem['gather']:.3f} ms = {mem['ep'] / mem['gather']:.3f}, measured"
        f" device time {ep_ms:.3f} / {ga_ms:.3f} ms = {ep_ms / ga_ms:.3f}: "
        f"the counts rank the two "
        + ("as the card does" if same else "AGAINST the card") + f"; on "
        f"{smi}")
    del trees, res
    free_card()


def dryrun_cli(*, smi: str) -> None:
    """Phase 19 (c): the CLIs on meta at production shapes: the dry-run of
    DRY_CLI_ARCH's four shapes on both meshes, and the hillclimb example
    (DRY_HILLCLIMB with moe_decode_ep true and false)."""
    import contextlib
    import io

    from repro_torch.launch import dryrun, hillclimb

    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        out = Path(tmp) / "dryrun.jsonl"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = dryrun.main(["--arch", DRY_CLI_ARCH, "--both-meshes",
                              "--out", str(out)])
        wall = time.perf_counter() - t0
        recs = [json.loads(line) for line in out.read_text().splitlines()]
    bad = [r for r in recs if r["status"] not in ("ok", "skipped")]
    if rc or bad or len(recs) != 8:
        raise AssertionError(f"dryrun rc {rc}, {len(recs)} records, "
                             f"failed {[(r['shape'], r['mesh']) for r in bad]}")
    for r in recs:
        if r["status"] == "skipped":
            log(f"[dryrun] (c) {r['arch']} {r['shape']} {r['mesh']}: "
                f"skipped")
            continue
        ma = r["memory_analysis"]
        log(f"[dryrun] (c) {r['arch']} {r['shape']} {r['mesh']} "
            f"({r['attn_mode']}): counted on {r['devices']} "
            + (f"(results off meta: {r['ops_off_device']}) "
               if r["ops_off_device"] else "") + f"in "
            f"{r['trace_s']} s; H100 compute {r['compute_s']:.4f} s, memory "
            f"{r['memory_s']:.4f} s, collective {r['collective_s']:.4f} s, "
            f"dominant {r['dominant']}, useful {r['useful_flops_ratio']:.3f},"
            f" roofline_fraction {r['roofline_fraction']:.4f}; arguments "
            f"{ma['argument_size_in_bytes'] / 1e9:.3f} GB + temp "
            f"{ma['temp_size_in_bytes'] / 1e9:.3f} GB a position")
    log(f"[dryrun] (c) python -m repro_torch.launch.dryrun --arch "
        f"{DRY_CLI_ARCH} --both-meshes: {len(recs)} records in {wall:.3f} "
        f"s, every status ok or skipped; on {smi}")
    arch, shape = DRY_HILLCLIMB
    for ep in ("true", "false"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = hillclimb.main(["--arch", arch, "--shape", shape, "--set",
                                 f"moe_decode_ep={ep}", "--tag",
                                 f"moe_decode_ep={ep}"])
        last = buf.getvalue().strip().splitlines()[-1]
        if rc or "status\": \"ok" not in buf.getvalue():
            raise AssertionError(f"hillclimb rc {rc}: {last}")
        log(f"[dryrun] (c) hillclimb {arch} {shape}: {last} ("
            f"{time.perf_counter() - t0:.3f} s)")


def dryrun_spmd(*, smi: str) -> None:
    """Phase 19 (d): phase 21 (a)'s own-shards olmo-1b step and phase 20
    (a)'s own-shards decode call, built by ``launch/dryrun.build_cell`` on
    cuda:0 positions and on meta and counted on each: op for op, the
    records kind for kind, ``moved_bytes`` against the records; the
    count's H100 terms beside what phases 20 (a) and 21 (a) measured."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist import collectives as C
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import H100, make_position_mesh
    from repro_torch.launch.roofline import roofline_terms

    t_part = time.perf_counter()
    cells = (("train", "21 (a)", ShapeConfig("train_1k", LMT_SEQ, LMT_BATCH,
                                              "train"), LMP_MESH),
             ("decode", "20 (a)", ShapeConfig("decode_1k", LM_MAX_CTX,
                                               LM_SLOTS, "decode"),
              LMS_MESH_A))
    for what, src, shape, pairs in cells:
        tag = f"[dryrun] (d) {DRY_SPMD_ARCH} {what}"
        positions = int(np.prod([n for _, n in pairs]))
        counts = {}
        for dev in ("meta", "cuda:0"):
            mesh = make_position_mesh(pairs, dev)
            fn, args, cfg, _, splan, _ = build_cell(
                DRY_SPMD_ARCH, shape, mesh, own_shards=True)
            if dev != "meta":
                off = [t.device for a in args for x in tree_values(a)
                       for t in (x.pieces.values() if hasattr(x, "pieces")
                                 else [x]) if not t.is_cuda]
                if off:
                    raise AssertionError(f"{tag}: arguments off the card "
                                         f"{off[:3]}")
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            moved = C.moved_bytes()
            with hlo_cost.CostMode(held=args) as mode:
                fn(*args)
            if dev != "meta":
                torch.cuda.synchronize()
            counts[dev] = (mode.summary(), mode.records,
                           C.moved_bytes() - moved,
                           time.perf_counter() - t0)
            del fn, args, mode
            free_card()
        (card, recs, moved, card_s), (meta, meta_recs, _, meta_s) = \
            counts["cuda:0"], counts["meta"]
        diff = count_diff(card, meta, f"{what} over own shards")
        if recs != meta_recs:
            raise AssertionError(f"{tag}: the card's collective records "
                                 f"differ from meta's")
        for k in ("collective_bytes_by_kind",
                  "collective_wire_bytes_by_kind"):
            if card[k] != meta[k]:
                raise AssertionError(f"{tag}: {k} card {card[k]} against "
                                     f"meta {meta[k]}")
        want_moved = sum(C.received_bytes(*r) for r in recs)
        if moved != want_moved:
            raise AssertionError(f"{tag}: moved_bytes {moved} against the "
                                 f"records' received bytes {want_moved}")
        terms = roofline_terms(
            flops_per_chip=card["flops"] / positions,
            bytes_per_chip=card["bytes"] / positions,
            coll_bytes_per_chip=card["collective_bytes"] / positions,
            peak=H100)
        copy_ms = 1e3 * 2 * moved / H100["hbm_bandwidth"]
        one_card_ms = max(1e3 * card["flops"] / H100["peak_flops_bf16"],
                          1e3 * card["bytes"] / H100["hbm_bandwidth"])
        by_kind = ", ".join(
            f"{k} x{card['collective_counts'][k] // positions} "
            f"{v / positions / 1e6:.3f} MB (wire "
            f"{card['collective_wire_bytes_by_kind'][k] / positions / 1e6:.3f}"
            f" MB)" for k, v in sorted(card["collective_bytes_by_kind"]
                                        .items()))
        got = DRY_SPMD_MEASURED.get(what)
        unit = {"train": "step", "decode": "tick"}[what]
        seen = (f"phase {src} measured: wall p50 {got['p50_ms']:.3f} ms, "
                f"device time {got['device_ms']:.3f} ms, "
                f"{got['kernels']:.1f} kernels a {unit}; the one-card bound "
                f"{100 * one_card_ms / got['device_ms']:.1f} % of that device "
                f"time" if got else f"phase {src} not measured in this run")
        log(f"{tag}, bf16 at full width, {shape.global_batch} x "
            f"{shape.seq_len} on {dict(pairs)} ({splan.attn_mode}), over own "
            f"shards: counted on cuda:0 positions ({card_s:.3f} s) and on "
            f"meta ({meta_s:.3f} s): ops {card['ops']} / {meta['ops']}, "
            f"FLOPs {card['flops']:.6e} equal"
            + ("; differing ops: " + "; ".join(diff) if diff else
               "; every op's count and bytes equal")
            + f"; the collective records equal kind for kind "
            f"({len(recs)} moves), a position: {by_kind}; moved_bytes "
            f"{moved:,} B = the records' received bytes (all-gather, "
            f"all-to-all and reduce-scatter their ring wire bytes, a psum's "
            f"fold (g - 1) r where the ring moves 2r (g - 1) / g; gather_to "
            f"adds none); on {smi}")
        log(f"{tag} H100 terms a position ({positions}): compute "
            f"{terms['compute_s'] * 1e3:.4f} ms, memory "
            f"{terms['memory_s'] * 1e3:.4f} ms, collective "
            f"{terms['collective_s'] * 1e3:.4f} ms (NVLink rate), dominant "
            f"{terms['dominant']}; on this one card every move is a copy "
            f"within HBM, so the whole call's bound is max(FLOPs / bf16 peak"
            f", bytes / HBM rate) = {one_card_ms:.3f} ms, the copies "
            f"already in its bytes ({copy_ms:.3f} ms of HBM time to read "
            f"and write {moved / 1e6:.3f} MB); {seen}; on {smi}")
    log(f"[dryrun] (d) part wall {time.perf_counter() - t_part:.3f} s; on "
        f"{smi}")


def dryrun_phase(*, smi: str) -> None:
    """Phase 19: the dry-run tools' counts against the card."""
    t_phase = time.perf_counter()
    dryrun_train(smi=smi)
    dryrun_decode(smi=smi)
    dryrun_cli(smi=smi)
    log(f"[dryrun] phase wall {time.perf_counter() - t_phase:.3f} s; on "
        f"{smi}")


def lms_script(cfg, seed: int, prompt_len=LMS_PROMPT_LEN,
               new_tokens=LMS_NEW_TOKENS) -> list:
    """Phase 20's serving script: (prompt, max_new_tokens, tier)."""
    from repro_torch.serve.router import TIER_BATCH

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(LMS_REQUESTS):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        mnt = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        out.append((rng.integers(0, cfg.vocab_size, plen), mnt, TIER_BATCH))
    return out


def lms_resident(engine, what: str) -> str:
    """Each position's resident bytes (its pieces of the parameters and
    the slot caches) against what the specs give it; raises if a position
    holds other than its spec's share."""
    from repro_torch.dist.sharding import (NamedSharding, cache_specs,
                                           own_spec, param_specs)

    mesh = engine.splan.mesh

    def spec_bytes(tree, specs) -> int:
        total = 0
        for leaf, spec in zip(tree_values(tree), tree_values(specs)):
            shape = NamedSharding(mesh, own_spec(spec, leaf.shape, mesh)) \
                .shard_shape(leaf.shape)
            total += int(np.prod(shape)) * leaf.first.element_size()
        return total

    held = {pos: 0 for pos in np.ndindex(*mesh.devices.shape)}
    for leaf in tree_values(engine.params) + tree_values(engine.caches):
        for pos, t in leaf.pieces.items():
            held[pos] += t.nbytes
    want = spec_bytes(engine.params, param_specs(engine.params, mesh)) + \
        spec_bytes(engine.caches, cache_specs(engine.caches, engine.splan))
    if set(held.values()) != {want}:
        raise AssertionError(f"{what}: positions hold "
                             f"{sorted(set(held.values()))} bytes, the "
                             f"specs give {want}")
    whole = sum(int(np.prod(leaf.shape)) * leaf.first.element_size()
                for leaf in tree_values(engine.params))
    return (f"each of {mesh.size} positions holds {want / 1e9:.4f} GB "
            f"(its pieces of the parameters and slot caches), equal to "
            f"what the specs give; the whole parameter tree is "
            f"{whole / 1e9:.3f} GB")


def tree_values(tree) -> list:
    """A tree's leaves as they are (a ``Sharded`` stays whole)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_values(tree[k])]
    return [tree]


class ListRecorder:
    """A collective recorder that keeps each record."""

    def __init__(self):
        self.records: list[tuple] = []

    def collective(self, kind, nbytes, group, members):
        self.records.append((kind, int(nbytes), int(group), int(members)))


def lms_recorded(run) -> tuple[list, int]:
    """``run()`` under a ``ListRecorder``: its records and the bytes the
    collectives moved across positions."""
    from repro_torch.dist import collectives as C

    rec = ListRecorder()
    prev = C.set_recorder(rec)
    moved = C.moved_bytes()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        C.set_recorder(prev)
    return rec.records, C.moved_bytes() - moved


def lms_bytes(records: list) -> str:
    """Records summed by kind: count and operand bytes (each member's
    result buffer, over the members)."""
    by: dict[str, list] = {}
    for kind, nbytes, _, members in records:
        e = by.setdefault(kind, [0, 0])
        e[0] += 1
        e[1] += nbytes * members
    return ", ".join(f"{k} x{n} {b / 1e6:.3f} MB" for k, (n, b) in
                     sorted(by.items())) or "none"


def lms_place(params, mesh) -> dict:
    """``params`` placed by ``param_specs`` as pieces over ``mesh``, leaf
    by leaf IN PLACE, each whole leaf dropped once its pieces exist (a
    tree and its pieces need not fit side by side); returns ``params``."""
    from repro_torch.dist.sharding import param_specs, shard_tensor

    def place(node, spec_node):
        for k in sorted(node):
            if isinstance(node[k], dict):
                place(node[k], spec_node[k])
            else:
                node[k] = shard_tensor(node[k], mesh, spec_node[k])
    place(params, param_specs(params, mesh))
    free_card()
    return params


def lms_teacher(tag: str, cfg, params, mesh, *, seed: int,
                held_mesh=None, consume: bool = False) -> str:
    """f32 prefill and LMS_CHECK decode steps teacher-forced on the
    held-once plan over ``held_mesh`` (default ``mesh``), then on an
    own-shards plan over ``mesh`` with the same weights, each within
    LM_TOL of the held-once logits; returns the summary.  ``consume``
    places ``params`` in place (``lms_place``): the whole tree is gone
    after."""
    from repro_torch.dist.sharding import make_plan, shard_params
    from repro_torch.models import lm as LM

    B, S, N = LMS_CHECK
    held = make_plan(cfg, held_mesh or mesh, decode_batch=B)
    own = make_plan(cfg, mesh, decode_batch=B, own_shards=True)
    toks = torch.randint(
        0, cfg.vocab_size, (B, S + N), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))
    ctx = S + 2 * N
    want, wc = LM.lm_prefill(cfg, params, toks[:, :S], splan=held, ctx=ctx)
    wants = [want]
    for i in range(N):
        want, wc = LM.lm_decode(cfg, params, wc, toks[:, S + i:S + i + 1],
                                splan=held)
        wants.append(want)
    del wc
    t0 = time.perf_counter()
    pieces = lms_place(params, mesh) if consume else \
        shard_params(params, own)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, gc_ = LM.lm_prefill(cfg, pieces, toks[:, :S], splan=own, ctx=ctx)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    errs = []
    for i, want in enumerate(wants):
        if i:
            got, gc_ = LM.lm_decode(cfg, pieces, gc_,
                                    toks[:, S + i - 1:S + i], splan=own)
        errs.append(float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL):
            what = "prefill" if not i else f"decode step {i - 1}"
            raise AssertionError(f"{tag} own-shards {what}: max |err| "
                                 f"{errs[-1]:.3e}")
    seq = ", ".join(f"{k} {t.spec}" for k, t in gc_["p0"].items())
    scale = max(float(w.abs().max()) for w in wants)
    del pieces, gc_, wants
    return (f"f32 {own.attn_mode} prefill {B} x {S} and {N} teacher-forced "
            f"decode steps within rtol = atol = {LM_TOL} of the held-once "
            f"path on the same weights, max |err| prefill {errs[0]:.3e}, "
            f"decode {max(errs[1:]):.3e} (logits up to {scale:.3f}); cache "
            f"spec {seq}; placement {place_s:.3f} s, own-shards prefill "
            f"{prefill_s:.3f} s (first call)")


def lms_replay(cfg, params, splan, prompt, tokens: list) -> list:
    """The request replayed alone as the engine runs it (its prompt
    left-padded to its bucket, then one token a decode), teacher-forced
    on ``tokens``.  For the prefill and each decode: (the router logits
    of each MoE call, host f32 ``[tokens, E]``, in call order; the top
    two LM logits and their ids; all the LM logits, host f32)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve.engine import _bucket

    calls: list = []
    route = L._route

    def spy(p, x):
        out = route(p, x)
        calls.append(out[0].detach().float().reshape(
            -1, out[0].shape[-1]).cpu())
        return out

    b = _bucket(len(prompt), LM_BUCKETS)
    toks = torch.zeros((1, b), dtype=torch.int64, device="cuda")
    toks[0, b - len(prompt):] = torch.as_tensor(prompt)
    steps = []
    L._route = spy
    try:
        logits, caches = LM.lm_prefill(cfg, params, toks, splan=splan,
                                       ctx=LM_MAX_CTX)
        for t in [None] + list(tokens):
            if t is not None:
                logits, caches = LM.lm_decode(
                    cfg, params, caches, torch.tensor([[t]], device="cuda"),
                    splan=splan)
            top = torch.topk(logits[0].float(), 2)
            steps.append((list(calls), top.values.cpu(), top.indices.cpu(),
                          logits[0].float().cpu()))
            calls.clear()
    finally:
        L._route = route
    del caches
    return steps


def lms_first_flip(held: list, own: list):
    """The first route that differs between two replays of a request
    (steps in order, MoE calls in layer order, tokens in order): (step,
    call, token, the held-once router's top-two margin there), or None.
    The own-shards path routes each call once a position: a prefill's
    calls are its blocks, a decode's repeat the same tokens."""
    for k, ((hc, *_), (oc, *_)) in enumerate(zip(held, own)):
        n = len(oc) // max(len(hc), 1)
        for j, h in enumerate(hc):
            o = torch.cat(oc[j * n:(j + 1) * n]) if k == 0 else oc[j * n]
            bad = (h.argmax(-1) != o.argmax(-1)).nonzero().flatten()
            if len(bad):
                top = torch.topk(h[bad[0]], 2).values
                return k, j, int(bad[0]), float(top[0] - top[1])
    return None


def lms_tokens_agree(tag: str, script, got: list, want: list, replay_held,
                     replay_own=None, replay_f32=None) -> str:
    """The own-shards engine's tokens against the held-once engine's: each
    request equal, or parting only at a near-tie.  Where request i parts
    at step k, ``replay_held(i, k)`` (and, for an MoE model,
    ``replay_own(i, k)``) replay it alone teacher-forced on the held-once
    engine's tokens (``lms_replay``); the first argmax that differs
    between the replays, a route (``lms_first_flip``) or else the token at
    step k, must have the held-once replay's top two within LMS_TIE_GAP:
    a bf16 rounding decided it, and all that follows it may differ.
    ``replay_f32(i, k)`` (the held-once path over the same weights upcast
    to f32, replayed as ``replay_held``) widens the token's limit to twice
    the held-once bf16 replay's own largest logit error against it at
    step k, where that is larger: each path's bf16 logits are that far
    from the f32 ones, so a gap below it is a rounding's to decide."""
    equal, ties, flips = 0, [], []
    for i, ((prompt, _, _), g, w) in enumerate(zip(script, got, want)):
        if g == w:
            equal += 1
            continue
        k = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b) \
            if any(a != b for a, b in zip(g, w)) else min(len(g), len(w))
        held = replay_held(i, k)
        flip = lms_first_flip(held, replay_own(i, k)) if replay_own else None
        if flip is not None:
            step, call, tok, gap = flip
            if gap >= LMS_TIE_GAP:
                raise AssertionError(
                    f"{tag} request with prompt {len(prompt)}: own-shards "
                    f"tokens {g} part from the held-once engine's {w} at "
                    f"step {k}; the first route that differs (step {step}, "
                    f"MoE call {call}, token {tok}) has the held-once "
                    f"router's top two {gap:.4f} apart")
            flips.append((k, step, call, round(gap, 5)))
            continue
        top2 = held[k][1]
        gap = float(top2[0] - top2[1])
        limit, err = LMS_TIE_GAP, None
        if replay_f32 is not None:
            err = float((held[k][3] - replay_f32(i, k)[k][3]).abs().max())
            limit = max(LMS_TIE_GAP, 2 * err)
        if gap >= limit:
            raise AssertionError(f"{tag} request with prompt {len(prompt)}:"
                                 f" own-shards tokens {g} part from the "
                                 f"held-once engine's {w} at step {k}, where "
                                 f"its top-two logits are {gap:.4f} apart "
                                 f"(limit {limit:.4f})")
        ties.append((k, round(gap, 4)) if err is None
                    else (k, round(gap, 4), round(err, 4)))
    return (f"{equal} of {len(script)} requests token for token the "
            f"held-once engine's"
            + (f"; {len(ties)} part after a near-tie of the logits (step, "
               f"top-two gap"
               + (", the held-once bf16 replay's largest |logit - f32 "
                  "logit| there; limit the larger of twice it and "
                  f"{LMS_TIE_GAP}" if replay_f32 is not None else "")
               + f") {ties}" if ties else "")
            + (f"; {len(flips)} part after a route near-tie (parting step, "
               f"then the first differing route's step, MoE call and the "
               f"held-once router's top-two gap) {flips}" if flips else "")
            + (f", every gap below {LMS_TIE_GAP}" if replay_f32 is None
               else ", every gap below its limit"))


def lm_spmd_olmo(*, smi: str) -> None:
    """Phase 20 (a) and (d): olmo-1b at full width over own shards."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch.mesh import make_local_mesh, make_position_mesh
    from repro_torch.models import get_bundle

    tag = "[lm-spmd] (a) olmo-1b"
    cfg = get_config("olmo-1b")
    mesh = make_position_mesh(LMS_MESH_A, "cuda:0")
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 400),
        dtype=torch.float32)
    log(f"{tag} on (data 2, model 4), every position on cuda:0 with its "
        f"own pieces: " + lms_teacher(tag, cfg, params, mesh,
                                      seed=SEED + 401) + f"; on {smi}")
    n = torch.cuda.device_count()
    if n >= 2:
        cards = make_local_mesh(1, n)
        log(f"[lm-spmd] (d) olmo-1b on {n} distinct cards (data 1, model "
            f"{n}): " + lms_teacher("[lm-spmd] (d)", cfg, params, cards,
                                    seed=SEED + 401, held_mesh=mesh)
            + f"; on {smi}")
    else:
        log(f"[lm-spmd] (d) skipped: {n} card on this machine, distinct "
            f"cards need two or more (make_local_mesh(1, n))")
    del params
    free_card()

    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 402))
    script = lms_script(cfg, SEED + 403)
    held = make_plan(cfg, mesh, decode_batch=LM_SLOTS)
    own = make_plan(cfg, mesh, decode_batch=LM_SLOTS, own_shards=True)
    torch.cuda.reset_peak_memory_stats()
    twin = lm_bf16_serving(f"{tag} held-once", cfg, params, script,
                           seed=SEED + 404, smi=smi, splan=held)
    seen = {}

    def probe(engine):
        records, moved = lms_recorded(engine.step)
        seen["tick"] = (lms_bytes(records), moved)
        seen["resident"] = lms_resident(engine, tag)

    torch.cuda.reset_peak_memory_stats()
    mine = lm_bf16_serving(f"{tag} own shards", cfg, params, script,
                           seed=SEED + 404, smi=smi, splan=own, probe=probe)
    agree = lms_tokens_agree(
        tag, script, mine["tokens"], twin["tokens"],
        lambda i, k: lms_replay(cfg, params, held, script[i][0],
                                twin["tokens"][i][:k]))
    log(f"{tag} bf16 engines, own shards / held once: {agree}; decode tick "
        f"p50 {mine['p50_ms']:.3f} / {twin['p50_ms']:.3f} ms, p99 "
        f"{mine['p99_ms']:.3f} / {twin['p99_ms']:.3f} ms; kernels a tick "
        f"{mine['kernels_tick']:.1f} / {twin['kernels_tick']:.1f}; busy "
        f"{100 * mine['busy']:.1f} / {100 * twin['busy']:.1f} %; tokens/s "
        f"{mine['tokens_s']:.1f} / {twin['tokens_s']:.1f}; peak memory "
        f"{mine['peak_gb']:.3f} / {twin['peak_gb']:.3f} GB; on {smi}")
    log(f"{tag} collectives a decode tick ({LM_SLOTS} slots busy): "
        f"{seen['tick'][0]}; {seen['tick'][1] / 1e6:.3f} MB moved across "
        f"positions; {seen['resident']}")
    DRY_SPMD_MEASURED["decode"] = {"p50_ms": mine["p50_ms"],
                                   "device_ms": mine["device_ms"],
                                   "kernels": mine["kernels_tick"]}
    del params
    free_card()


def lm_spmd_ep(*, smi: str) -> None:
    """Phase 20 (b): llama4-scout at full width over own shards, EP."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import (P, make_plan, shard_params,
                                           shard_tensor)
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.models import get_bundle
    from repro_torch.models import layers as L
    from repro_torch.models import positions as PS

    tag = "[lm-spmd] (b) " + LMM_ARCH_EP
    full = get_config(LMM_ARCH_EP)
    mesh = make_position_mesh(LMS_MESH_B, "cuda:0")
    B, S = LMS_MOE_TOKENS
    held = make_plan(full, mesh, decode_batch=B)
    own = make_plan(full, mesh, decode_batch=B, own_shards=True)
    moe = L.init_moe(full, torch.Generator(device="cuda").manual_seed(
        SEED + 410), full.d_model, full.d_ff, torch.float32, device="cuda")
    routed = {k: v for k, v in moe.items() if k != "shared"}
    pieces = shard_params({"moe": moe}, own)["moe"]
    x = torch.randn((B, S, full.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 411))
    cap = L.ep_capacity(full, held, x)
    want_rec, _ = lms_recorded(lambda: L.moe_dispatch_blocks(
        routed, x, 1, 4, cap))
    _, eidx, keep = L.moe_dispatch_blocks(routed, x, 1, 4, cap)
    xs = shard_tensor(x, mesh, P("data", None, None))
    rec, moved = lms_recorded(lambda: PS.moe_prefill(full, pieces, xs, own))
    if rec != want_rec:
        raise AssertionError(f"{tag} EP prefill records {rec}, held-once "
                             f"{want_rec}")
    out, routes = PS.moe_prefill(full, pieces, xs, own, with_routes=True)
    for pos, (e, k) in routes.items():
        m = pos[1]
        if not (torch.equal(e, eidx[m]) and torch.equal(k, keep[m])):
            raise AssertionError(f"{tag} EP prefill block {m}: the kept set "
                                 f"differs from the held-once path's")
    want = L.moe_dispatch_blocks(routed, x, 1, 4, cap)[0]
    got = C.gather_to(out, "cuda")
    scale = float(want.abs().max())
    pre_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL * scale):
        raise AssertionError(f"{tag} EP prefill: max |err| {pre_err:.3e}")
    xd = x[:, :1]
    want = L.moe_decode(full, moe, xd, splan=held)
    drec, dmoved = lms_recorded(lambda: PS.moe_layer(
        full, own, pieces, shard_tensor(xd, mesh, own.decode_hidden),
        own.decode_hidden, decode=True))
    got = C.gather_to(PS.moe_layer(
        full, own, pieces, shard_tensor(xd, mesh, own.decode_hidden),
        own.decode_hidden, decode=True), "cuda")
    dscale = float(want.abs().max())
    dec_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL * dscale):
        raise AssertionError(f"{tag} EP decode: max |err| {dec_err:.3e}")
    log(f"{tag} one MoE layer in f32 on (data 1, model 4), own pieces: EP "
        f"prefill of {B} x {S} tokens at cap_src {cap}: each block's kept "
        f"set and expert indices equal to the held-once path's (kept "
        f"{int(keep.sum())} of {keep.numel()}), output within rtol "
        f"{LM_TOL}, atol {LM_TOL} x {scale:.1f} (max |err| {pre_err:.3e}); "
        f"its records {lms_bytes(rec)} equal the held-once path's, "
        f"{moved / 1e6:.3f} MB moved across positions; EP decode of {B} "
        f"tokens within rtol {LM_TOL}, atol {LM_TOL} x {dscale:.1f} (max "
        f"|err| {dec_err:.3e}), collectives {lms_bytes(drec)}, "
        f"{dmoved / 1e6:.3f} MB moved; on {smi}")
    del moe, routed, pieces, x, xs, out, got, want
    free_card()

    cfg = dataclasses.replace(full, num_layers=LMS_LAYERS_B_F32)
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 415),
        dtype=torch.float32)
    log(f"{tag} cut to {LMS_LAYERS_B_F32} layers on (data 1, model 4): "
        + lms_teacher(tag, cfg, params, mesh, seed=SEED + 416, consume=True)
        + f"; on {smi}")
    del params
    free_card()

    serve_layers = LMF_LAYERS[LMM_ARCH_EP][0]
    cfg = dataclasses.replace(full, num_layers=serve_layers)
    held = make_plan(cfg, mesh, decode_batch=LM_SLOTS)
    own = make_plan(cfg, mesh, decode_batch=LM_SLOTS, own_shards=True)
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 412))
    script = lms_script(cfg, SEED + 413)
    # the held-once engine first, on the same weights and script: its
    # tokens are what the own-shards engine is held to, and each request's
    # replay on it is kept, because the whole tree and its pieces do not
    # fit side by side
    torch.cuda.reset_peak_memory_stats()
    twin = lm_bf16_serving(f"{tag} held-once", cfg, params, script,
                           seed=SEED + 414, smi=smi, splan=held)
    free_card()
    t0 = time.perf_counter()
    replays = [lms_replay(cfg, params, held, prompt, w[:-1])
               for (prompt, _, _), w in zip(script, twin["tokens"])]
    replay_s = time.perf_counter() - t0
    lms_place(params, mesh)
    torch.cuda.reset_peak_memory_stats()
    seen = {}

    def probe(engine):
        x = torch.randint(0, cfg.vocab_size, (1, LM_BUCKETS[0]),
                          device="cuda")
        rec, moved = lms_recorded(
            lambda: engine._prefill_fn(engine.params, x))
        seen["prefill"] = (lms_bytes(rec), moved)
        rec, moved = lms_recorded(engine.step)
        seen["tick"] = (lms_bytes(rec), moved)
        seen["resident"] = lms_resident(engine, tag)

    mine = lm_bf16_serving(f"{tag} own shards", cfg, params, script,
                           seed=SEED + 414, smi=smi, splan=own, probe=probe)
    agree = lms_tokens_agree(
        tag, script, mine["tokens"], twin["tokens"],
        lambda i, k: replays[i],
        lambda i, k: lms_replay(cfg, params, own, script[i][0],
                                twin["tokens"][i][:k]))
    log(f"{tag} bf16 at {serve_layers} layers, own shards / held once: "
        f"{agree} (the held-once replays {replay_s:.3f} s); decode tick p50 "
        f"{mine['p50_ms']:.3f} / {twin['p50_ms']:.3f} ms, p99 "
        f"{mine['p99_ms']:.3f} / {twin['p99_ms']:.3f} ms; kernels a tick "
        f"{mine['kernels_tick']:.1f} / {twin['kernels_tick']:.1f}; busy "
        f"{100 * mine['busy']:.1f} / {100 * twin['busy']:.1f} %; tokens/s "
        f"{mine['tokens_s']:.1f} / {twin['tokens_s']:.1f}; peak memory "
        f"{mine['peak_gb']:.3f} / {twin['peak_gb']:.3f} GB; collectives of a "
        f"{LM_BUCKETS[0]}-token prefill {seen['prefill'][0]} "
        f"({seen['prefill'][1] / 1e6:.3f} MB moved across positions), of a "
        f"decode tick {seen['tick'][0]} ({seen['tick'][1] / 1e6:.3f} MB "
        f"moved); {seen['resident']}; on {smi}")
    del params, replays
    free_card()


def lm_spmd_cp(*, smi: str) -> None:
    """Phase 20 (c): a cp config at full width, cut in depth, over own
    shards on (data 2, model 8)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.models import get_bundle

    cfg = dataclasses.replace(get_config(LMS_ARCH_C),
                              num_layers=LMS_LAYERS_C)
    tag = f"[lm-spmd] (c) {LMS_ARCH_C} cut to {LMS_LAYERS_C} layers"
    mesh = make_position_mesh(LMS_MESH_C, "cuda:0")
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED + 420),
        dtype=torch.float32)
    log(f"{tag} ({cfg.num_heads} heads / {cfg.num_kv_heads} KV) on (data 2,"
        f" model 8), 16 positions on cuda:0: "
        + lms_teacher(tag, cfg, params, mesh, seed=SEED + 421)
        + f"; on {smi}")
    del params
    free_card()


def lms_f32_engines(tag: str, cfg, params, mesh, script) -> str:
    """Both engines in f32 through 2 slots on the first LMS_F32_REQUESTS
    prompts of ``script`` (LMS_F32_NEW tokens each): the own-shards
    engine's tokens equal to the held-once engine's up to a near-tie
    under LMS_TIE_GAP (``lms_tokens_agree`` on the held-once f32
    replay)."""
    from repro_torch.dist.sharding import make_plan
    from repro_torch.serve.engine import ServeEngine

    reqs = [(prompt, LMS_F32_NEW, tier)
            for prompt, _, tier in script[:LMS_F32_REQUESTS]]
    tokens = {}
    for own in (False, True):
        engine = ServeEngine(
            cfg, params, slots=2, max_ctx=LM_MAX_CTX, prompt_buckets=LM_BUCKETS,
            splan=make_plan(cfg, mesh, decode_batch=2, own_shards=own),
            dtype=torch.float32)
        uids = [engine.submit(p, max_new_tokens=n, priority=t)
                for p, n, t in reqs]
        done = {r.uid: r.tokens for r in engine.run_until_drained()}
        tokens[own] = [done[u] for u in uids]
        del engine
        free_card()
    held = make_plan(cfg, mesh, decode_batch=2)
    return lms_tokens_agree(
        f"{tag} f32 engines", reqs, tokens[True], tokens[False],
        lambda i, k: lms_replay(cfg, params, held, reqs[i][0],
                                tokens[False][i][:k]))


def lm_spmd_family(arch: str, part: str, *, seed: int, smi: str) -> None:
    """Phase 20 (e) / (f): an SSD or hybrid config at full width, cut to
    LMS_FAM_LAYERS, over own shards, f32 against the held-once path
    (teacher-forced, and both engines on two requests), then both bf16
    engines."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.models import get_bundle
    from repro_torch.train.tree import tree_map

    tag = f"[lm-spmd] ({part}) {arch}"
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=LMS_FAM_LAYERS[arch])
    mesh = make_position_mesh(LMS_MESH_A, "cuda:0")
    held = make_plan(cfg, mesh, decode_batch=LM_SLOTS)
    own = make_plan(cfg, mesh, decode_batch=LM_SLOTS, own_shards=True)
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(seed),
        dtype=torch.float32)
    log(f"{tag} at full width cut to {cfg.num_layers} layers (SSD d_inner "
        f"{cfg.d_inner}, {cfg.ssm_heads} heads x {cfg.ssm_headdim}, state "
        f"{cfg.ssm_state}"
        + (f"; the shared block every {cfg.shared_attn_every}, {cfg.num_heads}"
           f" heads, LoRA rank {cfg.shared_attn_lora_rank}"
           if cfg.shared_attn_every else "")
        + f") on (data 2, model 4), every position on cuda:0 with its own "
        f"pieces; plan {own.attn_mode}, hidden {own.hidden}, ssm_state "
        f"{own.ssm_state}: "
        + lms_teacher(tag, cfg, params, mesh, seed=seed + 1) + f"; on {smi}")
    script = lms_script(cfg, seed + 3, LMS_FAM_PROMPT_LEN, LMS_FAM_NEW_TOKENS)
    log(f"{tag} f32 engines, own shards / held once, 2 slots: "
        + lms_f32_engines(tag, cfg, params, mesh, script) + f"; on {smi}")
    del params
    free_card()

    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(seed + 2))
    torch.cuda.reset_peak_memory_stats()
    twin = lm_bf16_serving(f"{tag} held-once", cfg, params, script,
                           seed=seed + 4, smi=smi, splan=held,
                           timed=LMS_FAM_TIMED)
    seen = {}

    def probe(engine):
        records, moved = lms_recorded(engine.step)
        seen["tick"] = (lms_bytes(records), moved)
        seen["resident"] = lms_resident(engine, tag)

    torch.cuda.reset_peak_memory_stats()
    mine = lm_bf16_serving(f"{tag} own shards", cfg, params, script,
                           seed=seed + 4, smi=smi, splan=own, probe=probe,
                           timed=LMS_FAM_TIMED)
    # a 64-layer random SSD stack turns bf16 roundings into logit
    # differences of bf16's own size between any two summation orders
    # (PERF.md §6), so a token's near-tie is measured against the
    # held-once bf16 path's own error (its f32 replay on the same weights)
    upcast = {}

    def replay_f32(i, k):
        if "params" not in upcast:
            upcast["params"] = tree_map(lambda t: t.float(), params)
        return lms_replay(cfg, upcast["params"], held, script[i][0],
                          twin["tokens"][i][:k])

    agree = lms_tokens_agree(
        tag, script, mine["tokens"], twin["tokens"],
        lambda i, k: lms_replay(cfg, params, held, script[i][0],
                                twin["tokens"][i][:k]), replay_f32=replay_f32)
    upcast.clear()
    log(f"{tag} bf16 engines, own shards / held once: {agree}; decode tick "
        f"p50 {mine['p50_ms']:.3f} / {twin['p50_ms']:.3f} ms, p99 "
        f"{mine['p99_ms']:.3f} / {twin['p99_ms']:.3f} ms; kernels a tick "
        f"{mine['kernels_tick']:.1f} / {twin['kernels_tick']:.1f}; busy "
        f"{100 * mine['busy']:.1f} / {100 * twin['busy']:.1f} %; tokens/s "
        f"{mine['tokens_s']:.1f} / {twin['tokens_s']:.1f}; peak memory "
        f"{mine['peak_gb']:.3f} / {twin['peak_gb']:.3f} GB; on {smi}")
    log(f"{tag} collectives a decode tick ({LM_SLOTS} slots busy): "
        f"{seen['tick'][0]}; {seen['tick'][1] / 1e6:.3f} MB moved across "
        f"positions; {seen['resident']}")
    del params
    free_card()


def lms_tick_profile(step, out: dict | None = None) -> tuple[int, float]:
    """(kernels, device busy share of the wall) of one ``step()`` under a
    CUDA-only profiler; ``out`` (if given) receives its ``device_ms``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    every, kernels, _ = device_intervals(prof)
    if out is not None:
        out["device_ms"] = union_us(every) / 1e3
    return len(kernels), union_us(every) / wall_us


def lm_spmd_encdec(*, seed: int, smi: str) -> None:
    """Phase 20 (g): seamless-m4t-large-v2 at full width over own shards:
    ``encdec_prefill`` on seeded frames and LMS_ED_CHECK decode steps in
    f32 against the held-once path, then each path's decode tick."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_plan, shard_params
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.models import encdec as ED
    from repro_torch.models import get_bundle

    cfg = get_config("seamless-m4t-large-v2")
    tag = f"[lm-spmd] (g) {cfg.name}"
    mesh = make_position_mesh(LMS_MESH_A, "cuda:0")
    B, S, N = LMS_ED_CHECK
    frames_n = ED.DECODE_MEMORY_FRAMES
    held = make_plan(cfg, mesh, decode_batch=B)
    own = make_plan(cfg, mesh, decode_batch=B, own_shards=True)
    params = get_bundle(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(seed),
        dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    frames = torch.randn((B, frames_n, cfg.d_model), device="cuda",
                         generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (B, S + N), device="cuda",
                         generator=gen)

    def run(p, splan):
        """Prefill and N teacher-forced decode steps: (logits of each, the
        caches, the prefill's wall, each decode's wall in ms)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = ED.encdec_prefill(cfg, p, frames, toks[:, :S],
                                           splan=splan)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs, ticks = [logits], []
        for i in range(N):
            t0 = time.perf_counter()
            logits, caches = ED.encdec_decode(cfg, p, caches,
                                              toks[:, S + i:S + i + 1],
                                              splan=splan)
            torch.cuda.synchronize()
            ticks.append(1e3 * (time.perf_counter() - t0))
            outs.append(logits)
        return outs, caches, prefill_s, ticks

    last = toks[:, S + N - 1:S + N]
    wants, wc, held_pre, held_ticks = run(params, held)
    held_prof = lms_tick_profile(lambda: ED.encdec_decode(
        cfg, params, wc, last, splan=held))
    del wc
    t0 = time.perf_counter()
    pieces = shard_params(params, own)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    gots, gc_, own_pre, own_ticks = run(pieces, own)
    errs = []
    for i, (got, want) in enumerate(zip(gots, wants)):
        errs.append(float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL):
            what = "prefill" if not i else f"decode step {i - 1}"
            raise AssertionError(f"{tag} own-shards {what}: max |err| "
                                 f"{errs[-1]:.3e}")
    scale = max(float(w.abs().max()) for w in wants)
    rec, moved = lms_recorded(lambda: ED.encdec_decode(
        cfg, pieces, gc_, last, splan=own))
    own_prof = lms_tick_profile(lambda: ED.encdec_decode(
        cfg, pieces, gc_, last, splan=own))
    resident = lms_resident(SimpleNamespace(splan=own, params=pieces,
                                            caches=gc_), tag)
    specs = {k: gc_[k].spec for k in ("memory", "index")}
    specs["self k"] = gc_["self"]["k"].spec
    log(f"{tag} at full width ({cfg.encoder_layers} + {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads, vocab "
        f"{cfg.vocab_padded}) on (data 2, model 4), every position on "
        f"cuda:0 with its own pieces ({own.attn_mode}): encdec_prefill of "
        f"{B} x {frames_n} seeded frames and {S} decoder tokens, then {N} "
        f"teacher-forced decode steps, f32, within rtol = atol = {LM_TOL} "
        f"of the held-once path on the same weights, max |err| prefill "
        f"{errs[0]:.3e}, decode {max(errs[1:]):.3e} (logits up to "
        f"{scale:.3f}); cache specs {specs}; placement {place_s:.3f} s; "
        f"prefill own / held once {own_pre:.3f} / {held_pre:.3f} s (first "
        f"call); decode tick p50 {np.median(own_ticks):.3f} / "
        f"{np.median(held_ticks):.3f} ms, p99 "
        f"{np.percentile(own_ticks, 99):.3f} / "
        f"{np.percentile(held_ticks, 99):.3f} ms (of {N}, the first "
        f"included); kernels a tick {own_prof[0]} / {held_prof[0]}; busy "
        f"{100 * own_prof[1]:.1f} / {100 * held_prof[1]:.1f} %; on {smi}")
    log(f"{tag} collectives a decode tick ({B} rows, the "
        f"{frames_n}-frame memory): {lms_bytes(rec)}; {moved / 1e6:.3f} MB "
        f"moved across positions; {resident}")
    del params, pieces, gc_, wants, gots
    free_card()


def lm_spmd_phase(*, smi: str) -> None:
    """Phase 20: LM serving over positions that own their shards."""
    t_phase = time.perf_counter()
    parts = (("a", lambda: lm_spmd_olmo(smi=smi)),
             ("b", lambda: lm_spmd_ep(smi=smi)),
             ("c", lambda: lm_spmd_cp(smi=smi)),
             ("e", lambda: lm_spmd_family(LMS_FAMILIES[0], "e",
                                          seed=SEED + 430, smi=smi)),
             ("f", lambda: lm_spmd_family(LMS_FAMILIES[1], "f",
                                          seed=SEED + 440, smi=smi)),
             ("g", lambda: lm_spmd_encdec(seed=SEED + 450, smi=smi)))
    for part, run in parts:
        t0 = time.perf_counter()
        run()
        log(f"[lm-spmd] ({part}) wall {time.perf_counter() - t0:.3f} s")
    log(f"[lm-spmd] phase wall {time.perf_counter() - t_phase:.3f} s; on "
        f"{smi}")


def lmp_update_check(tag: str, cfg, opt, mesh, *, seed: int) -> str:
    """Phase 21 (a) / (b)'s f32 check, from one state (drawn on the CPU
    from ``seed``) on the card: the own-shards step against the held-once
    step on ``mesh``, loss and gnorm within LMP_RTOL relative; the
    own-shards gradients (reduced over positions, gathered) each leaf
    within LMP_RTOL of its largest held-once gradient; the step's new
    parameters (gathered) each leaf within LMM_UPDATE_RTOL of its largest
    update of the held-once optimizer fed those gradients (a first AdamW
    update is lr g / (|g| + eps): fed the held-once gradients instead, a
    rounding-sized difference of a gradient near 0 moves it by up to 2
    lr); returns the summary."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import make_plan
    from repro_torch.train.data import batch_for
    from repro_torch.train.trainer import (_whole_grads,
                                           deterministic_algorithms,
                                           init_state, jit_train_step,
                                           make_train_step, place_state,
                                           state_from_arrays)
    from repro_torch.train.trainer import loss_and_grads as step_grads
    from repro_torch.train.tree import tree_leaves as flat
    from repro_torch.train.tree import tree_map, tree_unflatten

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for the f32 checks")
    arrays = tree_map(lambda t: t.numpy(), init_state(
        cfg, opt, torch.Generator().manual_seed(seed), dtype=torch.float32,
        device="cpu"))
    batch = batch_for(cfg, ShapeConfig("check", LMT_CHECK_SEQ,
                                       LMT_CHECK_BATCH, "train"), 0,
                      seed=seed)
    held = make_plan(cfg, mesh)
    _, wm = make_train_step(cfg, opt, held)(
        state_from_arrays(arrays, device="cuda"), batch)
    _, want_g = loss_and_grads(cfg, state_from_arrays(arrays, device="cuda")
                               ["params"], batch, held)
    want_g = [g.cpu() for g in flat(want_g)]
    step, own = jit_train_step(cfg, opt, mesh, own_shards=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, gm = step(state_from_arrays(arrays, device="cuda"), batch)
    torch.cuda.synchronize()
    own_s = time.perf_counter() - t0
    on_card(got, f"{tag} own-shards state")
    new = [C.gather_to(x, "cpu") for x in flat(got["params"])]
    del got
    errs = {}
    for key in ("loss", "gnorm"):
        g, w = float(gm[key]), float(wm[key])
        errs[key] = abs(g - w) / abs(w)
        if not (math.isfinite(g) and errs[key] <= LMP_RTOL):
            raise AssertionError(f"{tag} {key}: own shards {g} against held "
                                 f"once {w}")
    placed = place_state(state_from_arrays(arrays, device="cuda"), mesh,
                         own_shards=True)
    tb = {k: (torch.from_numpy(a) if a.dtype.kind == "f"
              else torch.from_numpy(a).long()).cuda() for k, a in batch.items()}
    with deterministic_algorithms():
        _, grads = step_grads(cfg, placed["params"], tb, own)
        grads = [C.gather_to(g, "cpu") for g in flat(_whole_grads(
            grads, own, compress=False))]
    del placed
    g_err = max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                 1e-30)
                for g, w in zip(grads, want_g))
    if not g_err <= LMP_RTOL:
        raise AssertionError(f"{tag}: a leaf's gradient {g_err:.3e} of its "
                             f"largest off the held-once one's")
    old = state_from_arrays(arrays, device="cpu")
    ref, _ = opt.update(tree_unflatten(old["params"], grads), old["opt"],
                        old["params"], old["step"])
    ref = flat(ref)
    old = [torch.from_numpy(a) for a in flat(arrays["params"])]
    excess = update_excess(new, old, ref,
                           [torch.ones_like(o, dtype=torch.bool)
                            for o in old])
    if not excess <= 1.0:
        raise AssertionError(f"{tag}: update error {excess:.3e} x the "
                             f"limit")
    upd = max(float((w - o).abs().max()) for w, o in zip(ref, old))
    free_card()
    return (f"one f32 {opt.cfg.name} step (lr {opt.cfg.lr:g} from step 0), "
            f"{own.attn_mode}, own shards against held once on the same "
            f"mesh: loss {float(gm['loss']):.6f} (rel err "
            f"{errs['loss']:.2e}), gnorm {float(gm['gnorm']):.6f} (rel err "
            f"{errs['gnorm']:.2e}), each leaf's gradient within "
            f"{g_err:.2e} of its largest (limit {LMP_RTOL:g} for all "
            f"three); update max {upd:.3e}, its error {excess:.3e} x the "
            f"limit ({LMM_UPDATE_RTOL:g} x each leaf's largest update of "
            f"the held-once optimizer on the own-shards gradients); own "
            f"step {own_s:.3f} s (first call)")


def lmp_resident(state, mesh) -> str:
    """Each position's bytes of the own-shards state (parameter and
    optimizer pieces) against what ``param_specs`` gives it; raises if a
    position holds another share."""
    from repro_torch.dist.sharding import NamedSharding, own_spec, param_specs

    want = 0
    for part in ("params", "opt"):
        for leaf, spec in zip(tree_values(state[part]),
                              tree_values(param_specs(state[part], mesh))):
            shape = NamedSharding(mesh, own_spec(spec, leaf.shape, mesh)) \
                .shard_shape(leaf.shape)
            want += int(np.prod(shape)) * leaf.first.element_size()
    held = {pos: 0 for pos in np.ndindex(*mesh.devices.shape)}
    for leaf in tree_values(state["params"]) + tree_values(state["opt"]):
        for pos, t in leaf.pieces.items():
            held[pos] += t.nbytes
    if set(held.values()) != {want}:
        raise AssertionError(f"positions hold {sorted(set(held.values()))} "
                             f"bytes of state, the specs give {want}")
    whole = sum(int(np.prod(x.shape)) * x.first.element_size()
                for x in tree_values(state["params"])
                + tree_values(state["opt"]))
    return (f"each of {mesh.size} positions holds {want / 1e9:.4f} GB of "
            f"parameter and optimizer pieces, what the specs give; the whole"
            f" state is {whole / 1e9:.3f} GB")


def lmp_timed(step, state, batches, *, tag: str) -> tuple:
    """LMP_STEPS steps from ``state``: (the state after, their walls in
    ms, their losses, the peak memory in GB)."""
    walls, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in range(LMP_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[k])
        losses.append(float(m["loss"]))
        walls.append(1e3 * (time.perf_counter() - t0))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: losses {losses}")
    return state, walls, losses, torch.cuda.max_memory_allocated() / 1e9


def lm_spmd_train_olmo(*, smi: str) -> None:
    """Phase 21 (a): olmo-1b over own shards on LMP_MESH: the f32 check at
    LMP_F32_LAYERS layers, then bf16 steps at full depth beside the
    held-once step."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (init_state, jit_train_step,
                                           make_train_step, place_state)

    tag = "[lm-spmd-train] (a) olmo-1b"
    full = get_config("olmo-1b")
    mesh = make_position_mesh(LMP_MESH, "cuda:0")
    cut = dataclasses.replace(full, num_layers=LMP_F32_LAYERS)
    log(f"{tag} f32 at {LMP_F32_LAYERS} layers on (data 2, model 4), every "
        f"position on cuda:0 with its own pieces, {LMT_CHECK_BATCH} x "
        f"{LMT_CHECK_SEQ} tokens: "
        + lmp_update_check(tag, cut, make_optimizer(OptimizerConfig(
            **LMM_OPT)), mesh, seed=SEED + 500) + f"; on {smi}")

    opt = make_optimizer(OptimizerConfig(lr=1e-4, warmup_steps=2))
    shape = ShapeConfig("train_1k", LMT_SEQ, LMT_BATCH, "train")
    batches = [batch_for(full, shape, k, seed=SEED) for k in
               range(LMP_STEPS + 2)]
    step, own = jit_train_step(full, opt, mesh, own_shards=True)
    state = init_state(full, opt, torch.Generator(device="cuda").manual_seed(
        SEED + 501))
    placed = place_state(state, mesh, own_shards=True)
    del state
    free_card()
    on_card(placed, f"{tag} placed state")
    resident = lmp_resident(placed, mesh)
    placed, walls, losses, peak = lmp_timed(step, placed, batches, tag=tag)
    records, moved = lms_recorded(lambda: step(placed, batches[LMP_STEPS]))
    prof: dict = {}
    kernels, busy = lms_tick_profile(lambda: step(placed,
                                                  batches[LMP_STEPS + 1]),
                                     prof)
    del placed
    free_card()
    held_step = make_train_step(full, opt, make_plan(full, mesh))
    state = init_state(full, opt, torch.Generator(device="cuda").manual_seed(
        SEED + 501))
    state, hwalls, hlosses, hpeak = lmp_timed(held_step, state, batches,
                                              tag=tag)
    hkernels, hbusy = lms_tick_profile(lambda: held_step(
        state, batches[LMP_STEPS + 1]))
    del state
    free_card()
    gap = abs(losses[0] - hlosses[0]) / abs(hlosses[0])
    if not gap <= LMP_BF16_RTOL:
        raise AssertionError(f"{tag} bf16 step 0 loss {losses[0]} against "
                             f"the held-once {hlosses[0]}")
    p50, p99 = np.percentile(walls[1:], [50, 99])
    hp50, hp99 = np.percentile(hwalls[1:], [50, 99])
    log(f"{tag} bf16 at full depth ({full.num_layers} layers, remat "
        f"{full.remat_policy}), AdamW, deterministic, {LMT_BATCH} x "
        f"{LMT_SEQ} tokens, {LMP_STEPS} steps a side from the same state, "
        f"own shards / held once: losses "
        + " ".join(f"{x:.4f}" for x in losses) + " / "
        + " ".join(f"{x:.4f}" for x in hlosses)
        + f" (step 0 rel gap {gap:.2e}, limit {LMP_BF16_RTOL:g}); step wall "
        f"(steps 1-{LMP_STEPS - 1}) p50 {p50:.3f} / {hp50:.3f} ms = "
        f"{p50 / hp50:.3f}, p99 {p99:.3f} / {hp99:.3f} ms, first step "
        f"{walls[0]:.3f} / {hwalls[0]:.3f} ms; kernels a step {kernels} / "
        f"{hkernels}; busy {100 * busy:.1f} / {100 * hbusy:.1f} %; peak "
        f"memory {peak:.3f} / {hpeak:.3f} GB; on {smi}")
    log(f"{tag} collectives a step (forward, backward and the gradients' "
        f"sums): {lms_bytes(records)}; {moved / 1e6:.3f} MB moved across "
        f"positions; {resident}")
    DRY_SPMD_MEASURED["train"] = {"p50_ms": float(p50),
                                  "device_ms": prof["device_ms"],
                                  "kernels": float(kernels)}


def lm_spmd_train_families(*, smi: str) -> None:
    """Phase 21 (b): each of LMP_FAMILIES at reduced() on LMP_MESH, one f32
    step over own shards against the held-once step."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

    mesh = make_position_mesh(LMP_MESH, "cuda:0")
    for i, (arch, name) in enumerate(LMP_FAMILIES):
        cfg = reduced(get_config(arch))
        opt = make_optimizer(OptimizerConfig(name=name, **LMM_OPT))
        tag = f"[lm-spmd-train] (b) {arch}"
        log(f"{tag} reduced on (data 2, model 4): "
            + lmp_update_check(tag, cfg, opt, mesh, seed=SEED + 510 + i)
            + f"; on {smi}")


def lm_spmd_train_compress(*, smi: str) -> None:
    """Phase 21 (c): reduced olmo's own-shards gradients on LMM_TRAIN_MESH,
    their int8 round trip bit for bit that of the gathered gradients."""
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.dist import collectives as C
    from repro_torch.dist.compression import compress_grads_crosspod
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.data import batch_for
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (_whole_grads, init_state,
                                           make_train_step, place_state)
    from repro_torch.train.trainer import loss_and_grads as step_grads
    from repro_torch.train.tree import tree_flatten_with_path

    tag = "[lm-spmd-train] (c) olmo-1b"
    cfg = reduced(get_config("olmo-1b"))
    mesh = make_position_mesh(LMM_TRAIN_MESH, "cuda:0")
    own = make_plan(cfg, mesh, own_shards=True)
    opt = make_optimizer(OptimizerConfig(**LMM_OPT))
    state = place_state(init_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(SEED + 520),
        dtype=torch.float32), mesh, own_shards=True)
    batch = batch_for(cfg, ShapeConfig("check", LMT_CHECK_SEQ,
                                       LMT_CHECK_BATCH, "train"), 0,
                      seed=SEED + 520)
    tb = {k: torch.from_numpy(a).long().cuda() for k, a in batch.items()}
    _, grads = step_grads(cfg, state["params"], tb, own)
    grads = _whole_grads(grads, own, compress=True)
    sent = compress_grads_crosspod(grads, mesh)
    whole = {"/".join(p): C.gather_to(g, "cuda")
             for p, g in tree_flatten_with_path(grads)}
    want = compress_grads_crosspod(whole, None)
    n = 0
    for path, g in tree_flatten_with_path(sent):
        got = C.gather_to(g, "cuda")
        if not bits_equal({"g": got}, {"g": want["/".join(path)]}):
            raise AssertionError(f"{tag}: {'/'.join(path)} round trip is not "
                                 f"bit for bit the gathered gradients'")
        n += got.numel()
    records, _ = lms_recorded(lambda: make_train_step(
        cfg, opt, own, grad_compress=True)(state, batch))
    int8 = sorted(g.first.numel() + 4 for g in tree_values(grads))
    pod = sorted(r[1] for r in records if r[0] == "all-reduce"
                 and r[2] == mesh.shape["pod"] and r[1] in set(int8))
    if pod != int8:
        raise AssertionError(f"{tag}: the compressed step's cross-pod "
                             f"all-reduces carry {pod} bytes, the int8 "
                             f"levels and scales {int8}")
    log(f"{tag} reduced on (pod 2, data 2, model 2), f32: the own-shards "
        f"gradients' int8 round trip (each leaf's scale the pmax of its "
        f"distinct slices' max-abs), {len(whole)} leaves and {n:,} "
        f"elements, bit for bit compress_grads_crosspod of the gathered "
        f"gradients; the compressed step's {len(pod)} cross-pod "
        f"all-reduces recorded at the int8 levels and an f32 scale "
        f"({sum(pod):,} B a position); all its collectives "
        f"{lms_bytes(records)}; on {smi}")
    del state, grads, sent, whole, want
    free_card()


def lm_spmd_train_loop(*, smi: str) -> None:
    """Phase 21 (d): TrainLoop over own shards at reduced olmo on the
    card: a failure, the restore as pieces and the continuation bit for
    bit the uninterrupted run; the last save restored onto LMM_TRAIN_MESH
    as pieces and held once."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch.mesh import make_position_mesh
    from repro_torch.train.checkpoint import latest_step, restore_checkpoint
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.fault import FailureInjector, TrainLoop
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import (init_state, make_train_step,
                                           place_state)

    tag = "[lm-spmd-train] (d) olmo-1b"
    cfg = reduced(get_config("olmo-1b"))
    mesh = make_position_mesh(LMP_MESH, "cuda:0")
    own = make_plan(cfg, mesh, own_shards=True)
    opt = make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=2))
    dc = DataConfig(seed=SEED + 5, vocab_size=cfg.vocab_size, batch=4,
                    seq_len=32)

    def fresh():
        return place_state(init_state(
            cfg, opt, torch.Generator(device="cuda").manual_seed(SEED + 530),
            dtype=torch.float32), mesh, own_shards=True)

    def loop(ckpt_dir=None, injector=None):
        return TrainLoop(make_train_step(cfg, opt, own),
                         lambda k: synthetic_batch(dc, k), ckpt_dir=ckpt_dir,
                         ckpt_every=LMT_LOOP_CKPT, injector=injector)

    t0 = time.perf_counter()
    straight, report = loop().run(fresh(), LMT_LOOP_STEPS)
    with tempfile.TemporaryDirectory(prefix="lm_spmd_ckpt_") as tmp:
        faulty = loop(tmp, FailureInjector(fail_at=LMT_LOOP_FAIL))
        try:
            faulty.run(fresh(), LMT_LOOP_STEPS)
            raise AssertionError("the injected failure did not fire")
        except RuntimeError as exc:
            if "injected node failure" not in str(exc):
                raise
        saved = latest_step(tmp)
        restored, step = faulty.restore(fresh(), mesh=mesh, own_shards=True)
        on_card(restored, f"{tag} restored state")
        resumed, rep2 = faulty.run(restored, LMT_LOOP_STEPS - step,
                                   start_step=step)
        onto = make_position_mesh(LMM_TRAIN_MESH, "cuda:0")
        pieces, at = restore_checkpoint(tmp, straight, mesh=onto,
                                        own_shards=True)
        held, _ = restore_checkpoint(tmp, straight, mesh=onto)
    if saved != LMT_LOOP_CKPT or step != LMT_LOOP_CKPT:
        raise AssertionError(f"restored from step {step}, saved {saved}")
    if not bits_equal(resumed, straight):
        raise AssertionError("the restored run is not bit for bit the "
                             "uninterrupted one")
    if rep2.losses != report.losses[step:]:
        raise AssertionError(f"losses {rep2.losses} against "
                             f"{report.losses[step:]}")
    gathered = {k: C.gather_to(x, "cuda") for k, x in
                enumerate(tree_values(resumed))}
    if at != LMT_LOOP_STEPS or not (
            bits_equal({k: C.gather_to(x, "cuda") for k, x in
                        enumerate(tree_values(pieces))}, gathered)
            and bits_equal(dict(enumerate(tree_values(held))), gathered)):
        raise AssertionError("the save restored onto (2, 2, 2) is not bit "
                             "for bit the saved state")
    log(f"{tag} reduced, TrainLoop over own shards on (data 2, model 4), "
        f"deterministic: failure at step {LMT_LOOP_FAIL}, restored as pieces"
        f" from the step-{step} checkpoint, {LMT_LOOP_STEPS - step} more "
        f"steps: every piece bit for bit the uninterrupted "
        f"{LMT_LOOP_STEPS}-step run's, losses equal ({report.losses[0]:.6f}"
        f" -> {report.losses[-1]:.6f}); the step-{at} save restored onto "
        f"(pod 2, data 2, model 2) as pieces and held once, both bit for "
        f"bit the saved state; {time.perf_counter() - t0:.3f} s; on {smi}")
    del straight, resumed, restored, pieces, held
    free_card()


def lm_spmd_train_phase(*, smi: str) -> None:
    """Phase 21: LM training over positions that own their shards."""
    t_phase = time.perf_counter()
    for part, run in (("a", lm_spmd_train_olmo),
                      ("b", lm_spmd_train_families),
                      ("c", lm_spmd_train_compress),
                      ("d", lm_spmd_train_loop)):
        t0 = time.perf_counter()
        run(smi=smi)
        log(f"[lm-spmd-train] ({part}) wall {time.perf_counter() - t0:.3f} s")
    log(f"[lm-spmd-train] phase wall {time.perf_counter() - t_phase:.3f} s; "
        f"on {smi}")


#: the phases that launch no forest kernel (15-21 and 19 (d)), by their
#: functions' names: ``chip_ab.py --forest-only`` runs main() without them
LM_PHASES = ("lm_phase", "lm_families_phase", "lm_train_phase",
             "lm_mesh_phase", "dryrun_phase", "lm_spmd_phase",
             "lm_spmd_train_phase", "dryrun_spmd")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.forest import make_forest, tree_slice
    from repro_torch.core.postprocess import predict_proba
    from repro_torch.db.store import TensorBlockStore
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import (feature_major,
                                            feature_major_plain, wide_tiled)
    from repro_torch.kernels.forest_hummingbird import (
        hummingbird_fused_plain, hummingbird_raw_plain)
    from repro_torch.kernels.forest_predicated import (predicated_fused_plain,
                                                       predicated_raw_plain)
    from repro_torch.kernels.forest_quickscorer import (
        quickscorer_fused_plain, quickscorer_raw_plain)
    from repro_torch.kernels.ops import (KERNEL_WRAPPERS, RAW_KERNEL_WRAPPERS,
                                         default_tree_block,
                                         predict_sum_pallas, prepare_inputs)

    BF16 = torch.bfloat16
    plain = dict(predicated=predicated_fused_plain,
                 hummingbird=hummingbird_fused_plain,
                 quickscorer=quickscorer_fused_plain)
    raw_plain = dict(predicated=predicated_raw_plain,
                     hummingbird=hummingbird_raw_plain,
                     quickscorer=quickscorer_raw_plain)
    wrappers = {**{f"{k}_fused": w for k, w in KERNEL_WRAPPERS.items()},
                **{f"{k}_raw": w for k, w in RAW_KERNEL_WRAPPERS.items()}}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def counted(run):
        """Run ``run()`` with every kernel's launch counts set to 0 just
        before; return its result and the counts just after: each
        wrapper's launches under its name, those in the wide-row x mode
        also under ``<name>_wide``, a fused kernel's over bf16 tree tiles
        also under ``<name>_bf16``; the feature-major transpose's under
        ``feature_major`` and ``feature_major_wide``."""
        for w in (*wrappers.values(), feature_major):
            w.launches = w.wide_launches = 0
        for w in KERNEL_WRAPPERS.values():
            w.bf16_launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        counts.update({f"{name}_wide": w.wide_launches
                       for name, w in wrappers.items()})
        counts.update({f"{kind}_fused_bf16": w.bf16_launches
                       for kind, w in KERNEL_WRAPPERS.items()})
        counts["feature_major"] = feature_major.launches
        counts["feature_major_wide"] = feature_major.wide_launches
        return out, counts

    def only(counts: dict, name: str, want: int, what: str) -> None:
        """Exactly ``want`` launches of ``name``'s kernel and no other
        kernel's, but for the transpose before each of its wide-tiled
        launches."""
        if counts[name] != want or want == 0:
            raise AssertionError(f"{what}: {counts[name]} {name} launches, "
                                 f"expected {want}")
        kind, variant = name.rsplit("_", 1)
        transposes = (counts[f"{name}_wide"]
                      if wide_tiled(kind, variant == "fused") else 0)
        if counts["feature_major"] != transposes:
            raise AssertionError(f"{what}: {counts['feature_major']} "
                                 f"transposes, expected {transposes}")
        stray = {k: n for k, n in counts.items()
                 if k not in (name, f"{name}_wide", f"{name}_bf16",
                              "feature_major", "feature_major_wide") and n}
        if stray:
            raise AssertionError(f"{what}: other kernels launched {stray}")

    # -- 1. report ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[report] device={name} count={count} nvidia-smi: {smi}")

    # -- 2. build -----------------------------------------------------------
    build_s = _build.build_all()
    log(f"[build] nvcc sm_90a, {len(_build.KERNEL_SOURCES)} libraries in "
        f"{build_s:.3f} s")
    for lib, text in _build.BUILD_LOG.items():
        regs = register_report(text)
        log(f"[build] {lib}: {'; '.join(sorted(regs[False]))}")
        log(f"[build] {lib} bf16: {'; '.join(sorted(regs[True]))}")

    # -- 3. kernel against plain version ------------------------------------
    rng = np.random.default_rng(SEED)
    x_np = rng.normal(size=(CHECK_ROWS, FEATURES)).astype(np.float32)
    x_np[rng.random(x_np.shape) < 0.05] = np.nan
    x_np[::16] = np.nan                                  # whole NaN rows
    x_chk = torch.from_numpy(x_np).cuda()
    max_err = {k: 0.0 for k in KINDS}
    raw_err = {k: 0.0 for k in KINDS}
    for integer in (True, False):
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(SEED + 1),
                                            integer_leaves=integer)
        f = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                        device="cuda")
        for kind in KINDS:
            args, tiles = prepare_inputs(kind, f, x_chk)
            got = KERNEL_WRAPPERS[kind](*args, **tiles)
            torch.cuda.synchronize()
            want = plain[kind](*args, depth=DEPTH)
            err = float((got - want).abs().max())
            if integer:
                ok = torch.equal(got, want)
                what = "bit-identical"
            else:
                ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
                what = f"rtol=atol={TOL}"
                max_err[kind] = max(max_err[kind], err)
            log(f"[kernels] {kind} {'integer' if integer else 'float'} "
                f"leaves, {CHECK_ROWS} rows (1/16 all-NaN): max_abs_err="
                f"{err!r} {what}: {'ok' if ok else 'FAIL'}")
            if not ok or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kind} kernel disagrees with its "
                                     f"plain version")
            args, tiles = prepare_inputs(kind, f, x_chk, fused=False)
            got = RAW_KERNEL_WRAPPERS[kind](*args, **tiles)
            torch.cuda.synchronize()
            want = raw_plain[kind](*args, depth=DEPTH)
            err = float((got - want).abs().max())
            raw_err[kind] = max(raw_err[kind], err)
            ok = torch.equal(bits(got), bits(want)) and bool(
                torch.isfinite(got).all())
            log(f"[kernels] {kind} raw {'integer' if integer else 'float'} "
                f"leaves, {CHECK_ROWS} rows x {TREES} trees, tiles {tiles}: "
                f"max_abs_err={err!r} bit-identical: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} raw kernel disagrees with its "
                                     f"plain version")

    # every kernel at the shallower depths, -0.0 leaves (a leaf lookup
    # keeps the sign; HummingBird's contraction gives +0.0)
    for depth in sorted(set().union(*SHALLOW.values())):
        fe, th, dl, lv = make_forest_arrays(
            np.random.default_rng(SEED + 10 + depth), integer_leaves=True,
            trees=37, depth=depth)
        lv[:, ::3] = -0.0
        f = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                        device="cuda")
        for kind in (k for k in KINDS if depth in SHALLOW[k]):
            for fused in (True, False):
                args, tiles = prepare_inputs(kind, f, x_chk, fused=fused)
                wrapper = (KERNEL_WRAPPERS if fused
                           else RAW_KERNEL_WRAPPERS)[kind]
                got = wrapper(*args, **tiles)
                torch.cuda.synchronize()
                want = (plain if fused else raw_plain)[kind](*args,
                                                             depth=depth)
                ok = torch.equal(bits(got), bits(want))
                err = float((got - want).abs().max())
                (max_err if fused else raw_err)[kind] = max(
                    (max_err if fused else raw_err)[kind], err)
                log(f"[kernels] {kind} {'fused' if fused else 'raw'} depth "
                    f"{depth}, 37 trees, integer and -0.0 leaves, "
                    f"{CHECK_ROWS} rows, tiles {tiles}: max_abs_err={err!r} "
                    f"bit for bit: {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{kind} at depth {depth} disagrees "
                                         f"with its plain version")

    # bf16 tree tiles: the fused kernels over narrow node records (8-byte
    # ones past 32,768 features), bit for bit against their plain versions
    bf16_err = {k: 0.0 for k in KINDS}

    def hold_bf16(kind, f, x, depth, what, staged=None):
        try:
            args, tiles = prepare_inputs(kind, f, x, staged=staged,
                                         tree_dtype=BF16)
        except ValueError:
            log(f"[kernels] {kind}_fused_bf16 {what}, staged: does not fit "
                f"one block")
            return
        got = KERNEL_WRAPPERS[kind](*args, **tiles)
        torch.cuda.synchronize()
        want = plain[kind](*args, depth=depth)
        ok = torch.equal(bits(got), bits(want)) and bool(
            torch.isfinite(got).all())
        err = float((got - want).abs().max())
        bf16_err[kind] = max(bf16_err[kind], err)
        log(f"[kernels] {kind}_fused_bf16 {what}, "
            f"{4 if args[1].dim() == 2 else 8}-byte node records, "
            f"{'staged' if tiles['staged'] else 'wide-row'} x, tiles "
            f"{tiles}: max_abs_err={err!r} bit for bit: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kind} over bf16 tree tiles, {what}, "
                                 f"disagrees with its plain version")

    for integer in (True, False):
        fe, th, dl, lv = make_forest_arrays(np.random.default_rng(SEED + 1),
                                            integer_leaves=integer)
        f = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                        device="cuda")
        for kind in KINDS:
            hold_bf16(kind, f, x_chk, DEPTH,
                      f"{'integer' if integer else 'float'} leaves, depth "
                      f"{DEPTH}, {TREES} trees, {CHECK_ROWS} rows (1/16 "
                      f"all-NaN)")
    for depth in sorted(set().union(*SHALLOW.values())):
        fe, th, dl, lv = make_forest_arrays(
            np.random.default_rng(SEED + 10 + depth), integer_leaves=True,
            trees=37, depth=depth)
        lv[:, ::3] = -0.0
        f = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                        device="cuda")
        for kind in (k for k in KINDS if depth in SHALLOW[k]):
            hold_bf16(kind, f, x_chk, depth,
                      f"depth {depth}, 37 trees, integer and -0.0 leaves, "
                      f"{CHECK_ROWS} rows")
    del x_chk

    # wide rows: every kernel, fused and raw, in the wide-row x mode and,
    # where a 32-sample x tile fits, staged, at depth 8 with integer
    # leaves; then the shallower depths with -0.0 leaves, wide mode
    wide_err = {f"{k}_{v}_wide": 0.0 for k in KINDS for v in ("fused", "raw")}
    wide_err["feature_major_wide"] = 0.0

    def hold_wide(kind, f, x, fused, staged, depth, what):
        try:
            args, tiles = prepare_inputs(kind, f, x, fused=fused,
                                         staged=staged)
        except ValueError:
            log(f"[kernels] {kind} {'fused' if fused else 'raw'} {what}, "
                f"staged: does not fit one block")
            return
        wrapper = (KERNEL_WRAPPERS if fused else RAW_KERNEL_WRAPPERS)[kind]
        got = wrapper(*args, **tiles)
        torch.cuda.synchronize()
        want = (plain if fused else raw_plain)[kind](*args, depth=depth)
        ok = torch.equal(bits(got), bits(want))
        err = float((got - want).abs().max())
        variant = "fused" if fused else "raw"
        if staged:
            (max_err if fused else raw_err)[kind] = max(
                (max_err if fused else raw_err)[kind], err)
        else:
            wide_err[f"{kind}_{variant}_wide"] = max(
                wide_err[f"{kind}_{variant}_wide"], err)
        log(f"[kernels] {kind} {variant} {what}, "
            f"{'staged' if staged else 'wide-row'} x, tiles {tiles}: "
            f"max_abs_err={err!r} bit for bit: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kind} {variant} {what} disagrees with "
                                 f"its plain version")

    for F in WIDE_CHECK_F:
        x_wide = card_rows(CHECK_ROWS, F, seed=SEED + 4, missing=0.05,
                           nan_every=16)
        # the wide-tiled kernels' feature-major operand
        got, want = feature_major(x_wide), feature_major_plain(x_wide)
        ok = torch.equal(bits(got), bits(want))
        wide_err["feature_major_wide"] = max(
            wide_err["feature_major_wide"], nan_err(got, want))
        log(f"[kernels] feature-major x (forest_transpose_rows) F={F}, "
            f"{CHECK_ROWS} rows -> {tuple(got.shape)}: bit for bit "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the transpose disagrees at F={F}")
        del got, want
        fe, th, dl, lv = make_forest_arrays(
            np.random.default_rng(SEED + 5), integer_leaves=True,
            features=F)
        f = make_forest(fe, th, lv, default_left=dl, n_features=F,
                        device="cuda")
        for kind in KINDS:
            for fused in (True, False):
                for staged in (False, True):
                    hold_wide(kind, f, x_wide, fused, staged, DEPTH,
                              f"F={F}, depth {DEPTH}, {TREES} trees, "
                              f"integer leaves, {CHECK_ROWS} rows")
            if F in BF16_WIDE_F:
                for staged in (False, True):
                    hold_bf16(kind, f, x_wide, DEPTH,
                              f"F={F}, depth {DEPTH}, {TREES} trees, "
                              f"integer leaves, {CHECK_ROWS} rows",
                              staged=staged)
        if F != WIDE_CHECK_F[0]:
            for depth in sorted(set().union(*SHALLOW.values())):
                fe, th, dl, lv = make_forest_arrays(
                    np.random.default_rng(SEED + 10 + depth),
                    integer_leaves=True, trees=37, depth=depth, features=F)
                lv[:, ::3] = -0.0
                f = make_forest(fe, th, lv, default_left=dl, n_features=F,
                                device="cuda")
                for kind in (k for k in KINDS if depth in SHALLOW[k]):
                    for fused in (True, False):
                        for staged in (False, True):
                            hold_wide(kind, f, x_wide, fused, staged, depth,
                                      f"F={F}, depth {depth}, 37 trees, "
                                      f"-0.0 leaves, {CHECK_ROWS} rows")
        del x_wide
    x_far = card_rows(CHECK_ROWS, BF16_PAST_NARROW_F, seed=SEED + 7,
                      missing=0.05, nan_every=16)
    fe, th, dl, lv = make_forest_arrays(
        np.random.default_rng(SEED + 8), integer_leaves=True,
        features=BF16_PAST_NARROW_F)
    f = make_forest(fe, th, lv, default_left=dl,
                    n_features=BF16_PAST_NARROW_F, device="cuda")
    for kind in KINDS:
        hold_bf16(kind, f, x_far, DEPTH,
                  f"F={BF16_PAST_NARROW_F} (past the narrow record), depth "
                  f"{DEPTH}, {TREES} trees, integer leaves, {CHECK_ROWS} "
                  f"rows")
    del x_far, f

    # -- 4. main path ---------------------------------------------------------
    fe, th, dl, lv = make_forest_arrays(np.random.default_rng(SEED + 2),
                                        integer_leaves=False)
    forest = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                         model_type="xgboost", task="classification",
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    rows = torch.randn((HIGGS_ROWS, FEATURES), generator=gen, device="cuda")
    store = TensorBlockStore(device="cuda")
    ds = store.put("higgs", rows)
    del rows
    torch.cuda.synchronize()
    log(f"[path] store.put('higgs', {HIGGS_ROWS} x {FEATURES} f32): "
        f"{ds.num_pages} pages of {ds.page_rows} rows, {ds.nbytes} B on "
        f"{ds.data.device}, {time.perf_counter() - t0:.3f} s set-up")
    engine = fresh_engine(store)
    sample = ds.data[:COMPARE_ROWS]
    oracle = predict_proba(forest, sample, algorithm="predicated")
    torch.cuda.synchronize()

    def drive(kind: str, dataset: str, runs: int):
        results, counts = counted(lambda: [
            engine.infer(dataset, forest, plan="udf",
                         algorithm=f"{kind}_pallas_fused")
            for _ in range(runs)])
        batches = sum(r.scan.batches for r in results)
        only(counts, f"{kind}_fused", batches, f"udf {kind}")
        preds = results[-1].predictions
        n = store.get(dataset).num_rows
        if tuple(preds.shape) != (n,) or not bool(torch.isfinite(preds).all()):
            raise AssertionError(f"{kind}: bad predictions {preds.shape}")
        err = float((preds[:COMPARE_ROWS] - oracle).abs().max())
        if not torch.allclose(preds[:COMPARE_ROWS], oracle, rtol=TOL,
                              atol=TOL):
            raise AssertionError(f"{kind}: predictions differ from the eager "
                                 f"oracle by {err}")
        return results, counts[f"{kind}_fused"], err

    res, launches_main, err = drive("predicated", "higgs", runs=2)
    first, second = res
    udf_device, udf_device_s = second.predictions, second.total_s
    if first.plan_reuse_hit or not second.plan_reuse_hit:
        raise AssertionError("the repeated query did not hit the plan cache")
    rows_per_s = ds.num_rows / second.total_s
    log(f"[path] infer(plan='udf', algorithm='predicated_pallas_fused') x2: "
        f"plan_reuse_hit={[r.plan_reuse_hit for r in res]}, "
        f"{launches_main} kernel launches for "
        f"{sum(r.scan.batches for r in res)} scan batches, "
        f"first {first.total_s:.6f} s, repeat {second.total_s:.6f} s "
        f"(udf stage {second.infer_s:.6f} s) = {rows_per_s:.1f} rows/s on "
        f"{smi}; max |pred - eager predicated| over {COMPARE_ROWS} rows = "
        f"{err!r}")
    launches = {"predicated_fused": launches_main}
    log(f"[path] cut: the HummingBird and QuickScorer paths score "
        f"{CUT_ROWS} of the {HIGGS_ROWS} rows (their kernels evaluate all "
        f"{(1 << DEPTH) - 1} nodes of every tree, the descent {DEPTH})")
    store.put("higgs_1m", ds.data[:CUT_ROWS])
    for kind in ("hummingbird", "quickscorer"):
        res, launches[f"{kind}_fused"], err = drive(kind, "higgs_1m", runs=1)
        log(f"[path] infer(plan='udf', algorithm='{kind}_pallas_fused') on "
            f"{CUT_ROWS} rows: {launches[f'{kind}_fused']} launches, "
            f"{res[0].total_s:.6f} s = {CUT_ROWS / res[0].total_s:.1f} "
            f"rows/s on {smi}; max |pred - eager predicated| = {err!r}")

    # -- 5. timing ----------------------------------------------------------
    record = []
    for kind in KINDS:
        table = store.get("higgs" if kind == "predicated" else "higgs_1m")
        args, tiles = prepare_inputs(kind, forest, table.data)
        kernel = KERNEL_WRAPPERS[kind]
        reps = 5 if kind == "predicated" else 3
        ms = cuda_ms(lambda: kernel(*args, **tiles), warmup=1, reps=reps)
        got = kernel(*args, **tiles)
        t_plain = time.perf_counter()
        want, plain_ms = timed_plain(plain[kind], args, DEPTH)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"{kind} at path shapes: max_abs_err {err}")
        max_err[kind] = max(max_err[kind], err)
        bound_ms, bound_by, parts = bound(kind, table.data.shape[0],
                                          FEATURES)
        log(f"[timing] {kind}: {table.data.shape[0]} rows x {TREES} trees, "
            f"tiles {tiles}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(host {time.perf_counter() - t_plain:.3f} s), bound "
            f"{bound_ms:.4f} ms by {bound_by} ({parts}), kernel/plain "
            f"max_abs_err {err!r}, on {smi}")
        record.append(dict(
            name=f"{kind}_fused", route="cuda", source=SOURCES[kind],
            replaces=REPLACES[kind], launches=None,
            max_abs_err=max_err[kind], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    del args, got, want

    # -- 5b. bf16 tree tiles at the path shapes, beside f32 ----------------
    eps_x = card_rows(-(-EPSILON_ROWS // PAGE_ROWS) * PAGE_ROWS, EPSILON_F,
                      seed=SEED + 9)
    fe, th, dl, lv = make_forest_arrays(np.random.default_rng(SEED + 11),
                                        integer_leaves=False,
                                        features=EPSILON_F)
    eps_forest = make_forest(fe, th, lv, default_left=dl,
                             n_features=EPSILON_F, device="cuda")
    shapes = {kind: (("higgs", forest, store.get(
        "higgs" if kind == "predicated" else "higgs_1m").data),
        ("epsilon", eps_forest, eps_x)) for kind in KINDS}
    bf16_out, counts = counted(lambda: {
        (kind, where): predict_sum_pallas(f_, x_,
                                          algorithm=f"{kind}_pallas_fused",
                                          tree_dtype=BF16)
        for kind in KINDS for where, f_, x_ in shapes[kind]})
    expect = {}
    for kind in KINDS:
        expect.update({f"{kind}_fused": 2, f"{kind}_fused_bf16": 2,
                       f"{kind}_fused_wide": 1})
    # one transpose before each wide-tiled launch at the Epsilon shape
    expect["feature_major"] = expect["feature_major_wide"] = sum(
        wide_tiled(kind, True) for kind in KINDS)
    if {k: n for k, n in counts.items() if n} != expect:
        raise AssertionError(f"bf16 path launches {counts}, expected "
                             f"{expect}")
    rounded = {"higgs": forest.astype(BF16).astype(torch.float32),
               "epsilon": eps_forest.astype(BF16).astype(torch.float32)}
    for (kind, where), got in bf16_out.items():
        x_ = dict((w, x) for w, _, x in shapes[kind])[where]
        want = predict_sum_pallas(rounded[where], x_,
                                  algorithm=f"{kind}_pallas_fused")
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"{kind} bf16 at the {where} shape is not "
                                 f"the f32 path over the rounded forest")
    log(f"[path] predict_sum_pallas(tree_dtype=torch.bfloat16) for each "
        f"fused kernel at the HIGGS and Epsilon shapes: launches {counts}; "
        f"each bit for bit the f32 path over forest.astype(bf16)"
        f".astype(f32)")
    del bf16_out, rounded
    bf16_record = []        # joins the record after the last phase
    for kind in KINDS:
        kernel = KERNEL_WRAPPERS[kind]
        for where, f_, x_ in shapes[kind]:
            a32, t32 = prepare_inputs(kind, f_, x_)
            a16, t16 = prepare_inputs(kind, f_, x_, tree_dtype=BF16)
            reps = 5 if kind == "predicated" else (3 if where == "higgs"
                                                   else 2)
            ms = {"f32": [], "bf16": []}
            for dt in ("f32", "bf16", "bf16", "f32"):
                a, t = (a32, t32) if dt == "f32" else (a16, t16)
                ms[dt].append(cuda_ms(lambda: kernel(*a, **t), warmup=1,
                                      reps=reps))
            ms32, ms16 = (sum(ms[d]) / 2 for d in ("f32", "bf16"))
            B, F = x_.shape
            b32, by32, _ = bound(kind, B, F, f_.num_trees)
            b16, by16, parts = bound(kind, B, F, f_.num_trees, record=4)
            log(f"[timing] {kind} bf16 at {where} {B} rows x {F} features "
                f"x {f_.num_trees} trees: f32 {ms32:.4f} ms (tiles {t32}), "
                f"bf16 {ms16:.4f} ms (tiles {t16}), bf16/f32 "
                f"{ms16 / ms32:.4f}; bound f32 {b32:.4f} ms by {by32}, bf16 "
                f"{b16:.4f} ms by {by16} ({parts}); on {smi}")
            if where != "higgs":
                continue
            # the narrow record at the f32 launch's own tiles: what the
            # record's decode costs, apart from the larger tree tile
            same, t_same = prepare_inputs(kind, f_, x_, tree_dtype=BF16,
                                          block_b=t32["block_b"],
                                          block_t=t32["block_t"])
            same_ms = cuda_ms(lambda: kernel(*same, **t_same), warmup=1,
                              reps=reps)
            log(f"[timing] {kind} bf16 at the f32 tiles {t_same}: "
                f"{same_ms:.4f} ms, /f32 {same_ms / ms32:.4f}; on {smi}")
            del same
            got = kernel(*a16, **t16)
            want, plain_ms = timed_plain(plain[kind], a16, DEPTH)
            err = float((got - want).abs().max())
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{kind} bf16 at the path shape: "
                                     f"max_abs_err {err}")
            bf16_err[kind] = max(bf16_err[kind], err)
            log(f"[timing] {kind} bf16 plain version: {plain_ms:.4f} ms, "
                f"kernel/plain bit for bit; on {smi}")
            bf16_record.append(dict(
                name=f"{kind}_fused_bf16", route="cuda",
                source=SOURCES[kind], replaces=REPLACES[kind],
                launches=counts[f"{kind}_fused_bf16"],
                max_abs_err=bf16_err[kind], ms=ms16, plain_ms=plain_ms,
                bound_ms=b16, bound_by=by16, library_ms=None))
            del got, want
        del a32, a16
    del eps_x, eps_forest, shapes

    # -- 6. the relation-centric plans at 1600 trees ----------------------
    # Leaves shrink with the tree count, as boosting's step size does, so
    # the margin keeps the 500-tree forest's spread.
    fe, th, dl, lv = make_forest_arrays(
        np.random.default_rng(SEED + 3), integer_leaves=False,
        trees=REL_TREES, leaf_scale=0.1 * math.sqrt(TREES / REL_TREES))
    big = make_forest(fe, th, lv, default_left=dl, n_features=FEATURES,
                      model_type="xgboost", task="classification",
                      device="cuda")
    big_oracle = predict_proba(big, sample, algorithm="predicated")
    torch.cuda.synchronize()        # no query below waits on the oracle

    def hold(preds: torch.Tensor, n: int, what: str) -> float:
        if tuple(preds.shape) != (n,) or not bool(torch.isfinite(preds).all()):
            raise AssertionError(f"{what}: bad predictions {preds.shape}")
        k = min(n, COMPARE_ROWS)
        err = float((preds[:k] - big_oracle[:k]).abs().max())
        if not torch.allclose(preds[:k], big_oracle[:k], rtol=TOL, atol=TOL):
            raise AssertionError(f"{what}: predictions differ from the eager "
                                 f"oracle by {err}")
        return err

    def breakdown(r) -> str:
        stages = ", ".join(f"{s.name} {s.seconds:.6f} s"
                           for s in r.stage_reports)
        return (f"total {r.total_s:.6f} s (partition {r.partition_s:.6f}, "
                f"infer {r.infer_s:.6f}, aggregate "
                f"{r.aggregate_s:.6f}; {stages})")

    def rel_run(dataset: str, plan: str, algorithm: str, runs: int):
        """``runs`` queries, each with its launches counted on its own."""
        kind = algorithm.split("_")[0]
        name_ = f"{kind}_{'fused' if algorithm.endswith('_fused') else 'raw'}"
        n = store.get(dataset).num_rows
        results, counts = [], {k: 0 for k in wrappers}
        for i in range(runs):
            r, c = counted(lambda: engine.infer(dataset, big, plan=plan,
                                                algorithm=algorithm))
            only(c, name_, r.n_parts * r.scan.batches,
                 f"{plan} {algorithm} run {i + 1}")
            err = hold(r.predictions, n, f"{plan} {algorithm}")
            log(f"[rel] infer(plan='{plan}', algorithm='{algorithm}') run "
                f"{i + 1} over {n} rows x {REL_TREES} trees: n_parts="
                f"{r.n_parts}, reuse_hit={r.reuse_hit}, plan_reuse_hit="
                f"{r.plan_reuse_hit}, {breakdown(r)} = "
                f"{n / r.total_s:.1f} rows/s on {smi}; {c[name_]} {name_} "
                f"launches = n_parts x scan batches, no other kernel; max "
                f"|pred - eager predicated| over {min(n, COMPARE_ROWS)} "
                f"rows = {err!r}")
            results.append(r)
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        return results, counts

    totals = {k: 0 for k in wrappers}

    def tally(counts: dict) -> None:
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    res, counts = rel_run("higgs", "rel+reuse", "predicated_pallas", runs=2)
    tally(counts)
    first, second = res
    if first.reuse_hit or not (second.reuse_hit and second.plan_reuse_hit) \
            or second.partition_s != 0.0:
        raise AssertionError("the repeated rel+reuse query did not hit both "
                             "caches")
    rel_parts = first.n_parts
    rel_device_s = second.total_s
    if rel_parts != -(-REL_TREES // default_tree_block(big, fused=False)):
        raise AssertionError(f"n_parts {rel_parts} is not one partition "
                             f"per raw tree tile")
    res, counts = rel_run("higgs", "rel", "predicated_pallas", runs=1)
    tally(counts)
    if res[0].reuse_hit:
        raise AssertionError("plan='rel' consulted a cache")
    profile_query(lambda: engine.infer("higgs", big, plan="rel+reuse",
                                       algorithm="predicated_pallas"),
                  "rel+reuse predicated_pallas, repeat", smi)

    for plan, algorithm, variant in (
            ("udf", "predicated_pallas_fused", "fused"),
            ("rel+reuse", "predicated_pallas", "raw")):
        for B in ROW_BATCHES:
            x = ds.data[:B]
            mask = np.arange(B) < B - B // 4           # coalescer padding
            calls, counts = counted(lambda: [
                engine.infer_rows(big, x, row_mask=mask, plan=plan,
                                  algorithm=algorithm) for _ in range(2)])
            n_parts = rel_parts if plan == "rel+reuse" else 1
            only(counts, f"predicated_{variant}", 2 * n_parts,
                 f"infer_rows {plan} {B}")
            tally(counts)
            if calls[0].plan_reuse_hit or not calls[1].plan_reuse_hit:
                raise AssertionError(f"infer_rows {plan} {B}: the repeat "
                                     f"missed the plan cache")
            keep = torch.from_numpy(mask).cuda()
            preds = calls[1].predictions
            err = float((preds[keep] - big_oracle[:B][keep]).abs().max())
            if not (torch.allclose(preds[keep], big_oracle[:B][keep],
                                   rtol=TOL, atol=TOL)
                    and bool(torch.isnan(preds[~keep]).all())):
                raise AssertionError(f"infer_rows {plan} {B}: wrong rows")
            log(f"[rows] infer_rows({B} rows, {int(mask.sum())} real, plan="
                f"'{plan}', algorithm='{algorithm}') x2: "
                f"{counts[f'predicated_{variant}']} launches, first "
                f"{calls[0].total_s:.6f} s, repeat {calls[1].total_s:.6f} s "
                f"on {smi}; max |pred - eager predicated| = {err!r}")

    for kind in ("hummingbird", "quickscorer"):
        res, counts = rel_run("higgs_1m", "rel+reuse", f"{kind}_pallas",
                              runs=2)
        tally(counts)
        if not (res[1].reuse_hit and res[1].plan_reuse_hit):
            raise AssertionError(f"the repeated rel+reuse {kind} query did "
                                 f"not hit both caches")
    res, counts = rel_run("higgs_1m", "udf", "predicated_pallas", runs=1)
    tally(counts)
    for name_ in ("predicated_fused", "hummingbird_fused",
                  "quickscorer_fused"):
        launches[name_] += totals[name_]
    for kind in KINDS:
        launches[f"{kind}_raw"] = totals[f"{kind}_raw"]
    for entry in record:
        entry["launches"] = launches[entry["name"]]

    # -- 7. raw kernel timing at one rel launch's shape ----------------------
    part = tree_slice(big, 0, REL_TREES // rel_parts)
    for kind in KINDS:
        table = store.get("higgs" if kind == "predicated" else "higgs_1m")
        args, tiles = prepare_inputs(kind, part, table.data, fused=False)
        kernel = RAW_KERNEL_WRAPPERS[kind]
        ms = cuda_ms(lambda: kernel(*args, **tiles), warmup=2, reps=10)
        got = kernel(*args, **tiles)
        t_plain = time.perf_counter()
        want, plain_ms = timed_plain(raw_plain[kind], args, DEPTH)
        err = float((got - want).abs().max())
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"{kind} raw at path shapes: max_abs_err "
                                 f"{err}")
        raw_err[kind] = max(raw_err[kind], err)
        B, T = got.shape
        bound_ms, bound_by, parts = bound(kind, B, FEATURES, T, raw=True)
        log(f"[timing] {kind} raw: {B} rows x {T} trees, tiles {tiles}: "
            f"kernel {ms:.4f} ms ({got.nbytes / ms / 1e6:.1f} GB/s of "
            f"[B, T] written), plain {plain_ms:.4f} ms (host "
            f"{time.perf_counter() - t_plain:.3f} s), bound {bound_ms:.4f} "
            f"ms by {bound_by} ({parts}), kernel/plain max_abs_err {err!r}, "
            f"on {smi}")
        # the same partition through the fused kernel, and the
        # aggregate_raw the rel plan runs on each raw output
        fargs, ftiles = prepare_inputs(kind, part, table.data)
        fused_ms = cuda_ms(lambda: KERNEL_WRAPPERS[kind](*fargs, **ftiles),
                           warmup=2, reps=10)
        sum_ms = cuda_ms(lambda: torch.sum(got, dim=-1), warmup=2, reps=10)
        log(f"[timing] {kind} at the same {T}-tree partition: fused kernel "
            f"{fused_ms:.4f} ms (tiles {ftiles}), raw - fused "
            f"{ms - fused_ms:.4f} ms, aggregate_raw (torch.sum over the "
            f"[B, T] output) {sum_ms:.4f} ms, on {smi}")
        del fargs
        record.append(dict(
            name=f"{kind}_raw", route="cuda", source=SOURCES[kind],
            replaces=RAW_REPLACES[kind], launches=launches[f"{kind}_raw"],
            max_abs_err=raw_err[kind], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        del args, got, want

    # -- 8. the host and disk tiers ------------------------------------------
    fused_ms = next(e["ms"] for e in record
                    if e["name"] == "predicated_fused")
    launches8, link_gbps = tiers_phase(
        forest=forest, big=big, store=store, engine=engine, counted=counted,
        only=only, smi=smi, fused_ms=fused_ms, rel_device_s=rel_device_s)
    for name_, n in launches8.items():
        next(e for e in record if e["name"] == name_)["launches"] += n

    # -- 9. wide rows and the sparse plane ----------------------------------
    counts9: dict[str, int] = {}

    def tally9(counts: dict) -> None:
        for k, n in counts.items():
            counts9[k] = counts9.get(k, 0) + n

    wide = sparse_phase(counted=counted, only=only, smi=smi, tally=tally9)
    for entry in record:
        name_ = entry["name"]
        entry["launches"] += counts9[name_] - counts9[f"{name_}_wide"]
    for kind in KINDS:
        for variant, replaces in (("fused", REPLACES), ("raw", RAW_REPLACES)):
            name_ = f"{kind}_{variant}_wide"
            if not counts9[name_]:
                raise AssertionError(f"{name_}: no launch on phase 9's path")
            w = wide[name_]
            record.append(dict(
                name=name_, route="cuda", source=SOURCES[kind],
                replaces=replaces[kind], launches=counts9[name_],
                max_abs_err=max(wide_err[name_], w["max_abs_err"]),
                ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"], library_ms=None))
    # the transpose before each wide-tiled launch: part of the wide-row
    # mode of the fused predicated and HummingBird kernels and raw
    # HummingBird
    if not counts9["feature_major_wide"]:
        raise AssertionError("feature_major_wide: no launch on phase 9's path")
    w = wide["feature_major_wide"]
    record.append(dict(
        name="feature_major_wide", route="cuda",
        source="src/repro_torch/kernels/csrc/forest_common.cuh",
        replaces=REPLACES["predicated"],
        launches=counts9["feature_major_wide"],
        max_abs_err=max(wide_err["feature_major_wide"], w["max_abs_err"]),
        ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
        bound_by=w["bound_by"], library_ms=w["library_ms"]))

    # -- 10. external loads against in-database inference -------------------
    counts10: dict[str, int] = {}

    def tally10(counts: dict) -> None:
        for k, n in counts.items():
            counts10[k] = counts10.get(k, 0) + n

    t10 = time.perf_counter()
    load_phase(counted=counted, only=only, smi=smi, tally=tally10)
    log(f"[load] phase wall {time.perf_counter() - t10:.3f} s")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts10[name_]
        else:
            entry["launches"] += counts10[name_] - counts10[f"{name_}_wide"]

    # -- 11. the forest serving plane ---------------------------------------
    counts11: dict[str, int] = {}

    def tally11(counts: dict) -> None:
        for k, n in counts.items():
            counts11[k] = counts11.get(k, 0) + n

    t11 = time.perf_counter()
    serve_phase(rows=ds.data[:SERVE_ROWS].cpu().numpy(), forest=forest,
                big=big, counted=counted, only=only, smi=smi, tally=tally11)
    log(f"[serve] phase wall {time.perf_counter() - t11:.3f} s")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts11[name_]
        else:
            entry["launches"] += counts11[name_] - counts11[f"{name_}_wide"]

    # -- 12. the cost-based optimizer ---------------------------------------
    counts12: dict[str, int] = {}

    def tally12(counts: dict) -> None:
        for k, n in counts.items():
            counts12[k] = counts12.get(k, 0) + n

    t12 = time.perf_counter()
    optimizer_phase(counted=counted, only=only, smi=smi, tally=tally12,
                    link_gbps=link_gbps)
    log(f"[optimizer] phase wall {time.perf_counter() - t12:.3f} s; "
        f"launches { {k: n for k, n in counts12.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts12[name_]
        else:
            entry["launches"] += counts12[name_] - counts12[f"{name_}_wide"]

    # -- 13. in-database training -------------------------------------------
    counts13: dict[str, int] = {}

    def tally13(counts: dict) -> None:
        for k, n in counts.items():
            counts13[k] = counts13.get(k, 0) + n

    train_phase(counted=counted, only=only, smi=smi, tally=tally13)
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts13[name_]
        else:
            entry["launches"] += counts13[name_] - counts13[f"{name_}_wide"]

    # -- 14. the (data, model) mesh ------------------------------------------
    counts14: dict[str, int] = {}

    def tally14(counts: dict) -> None:
        for k, n in counts.items():
            counts14[k] = counts14.get(k, 0) + n

    mesh_phase(forest=forest, big=big, store=store, engine=engine,
               udf_device=udf_device, udf_device_s=udf_device_s,
               rel_device_s=rel_device_s, counted=counted, only=only,
               smi=smi, tally=tally14)
    log(f"[mesh] launches { {k: n for k, n in counts14.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts14[name_]
        else:
            entry["launches"] += counts14[name_] - counts14[f"{name_}_wide"]

    # -- 15. the LM serving path ---------------------------------------------
    (_, counts15) = counted(lambda: lm_phase(smi=smi))
    log(f"[lm] forest kernel launches "
        f"{ {k: n for k, n in counts15.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts15[name_]
        else:
            entry["launches"] += counts15[name_] - counts15[f"{name_}_wide"]

    # -- 16. the SSD, hybrid and MoE serving paths ---------------------------
    (_, counts16) = counted(lambda: lm_families_phase(smi=smi))
    log(f"[lm-families] forest kernel launches "
        f"{ {k: n for k, n in counts16.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts16[name_]
        else:
            entry["launches"] += counts16[name_] - counts16[f"{name_}_wide"]

    # -- 17. the LM training path and enc-dec ---------------------------------
    (_, counts17) = counted(lambda: lm_train_phase(smi=smi))
    log(f"[lm-train] forest kernel launches "
        f"{ {k: n for k, n in counts17.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts17[name_]
        else:
            entry["launches"] += counts17[name_] - counts17[f"{name_}_wide"]

    # -- 18. the LM on a mesh -------------------------------------------------
    (_, counts18) = counted(lambda: lm_mesh_phase(smi=smi))
    log(f"[lm-mesh] forest kernel launches "
        f"{ {k: n for k, n in counts18.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts18[name_]
        else:
            entry["launches"] += counts18[name_] - counts18[f"{name_}_wide"]

    # -- 19. the dry-run tools ----------------------------------------------
    (_, counts19) = counted(lambda: dryrun_phase(smi=smi))
    log(f"[dryrun] forest kernel launches "
        f"{ {k: n for k, n in counts19.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts19[name_]
        else:
            entry["launches"] += counts19[name_] - counts19[f"{name_}_wide"]

    # -- 20. LM serving over positions that own their shards --------------------
    (_, counts20) = counted(lambda: lm_spmd_phase(smi=smi))
    log(f"[lm-spmd] forest kernel launches "
        f"{ {k: n for k, n in counts20.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts20[name_]
        else:
            entry["launches"] += counts20[name_] - counts20[f"{name_}_wide"]

    # -- 21. LM training over positions that own their shards ---------------
    (_, counts21) = counted(lambda: lm_spmd_train_phase(smi=smi))
    log(f"[lm-spmd-train] forest kernel launches "
        f"{ {k: n for k, n in counts21.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts21[name_]
        else:
            entry["launches"] += counts21[name_] - counts21[f"{name_}_wide"]

    # -- 19 (d). the dry-run over own shards, after phases 20 and 21 -------
    (_, counts19d) = counted(lambda: dryrun_spmd(smi=smi))
    log(f"[dryrun] (d) forest kernel launches "
        f"{ {k: n for k, n in counts19d.items() if n} }")
    for entry in record:
        name_ = entry["name"]
        if name_.endswith("_wide"):
            entry["launches"] += counts19d[name_]
        else:
            entry["launches"] += counts19d[name_] - counts19d[f"{name_}_wide"]
    record.extend(bf16_record)

    log(f"[smoke] wall {time.perf_counter() - t_start:.3f} s")

    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
