#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``euromillioner_tpu_torch``) on one NVIDIA
GPU and check it end to end.

Phases, each reported on its own lines:

1. device — the card's name, power limit and clocks;
2. build — every hand-written kernel, from the checkout's sources, one
   ``nvcc`` per source, all started together, with each kernel's
   registers, static shared memory and spills (``nvcc -Xptxas -v``); then
   ``cuobjdump --dump-sass`` of K1's and K2's libraries: every bf16
   instantiation runs tensor-core instructions (HMMA for ``mma.sync``,
   HGMMA for K2's ``wgmma`` dwh) and no f32 one does;
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (K1: the serving buckets, the HTTP batch
   server's 128-step bucket and the training batch; K2: the training batches, with K1's residuals; then the K1+K2
   Function's gradients against autograd through the scan), then its
   median time beside the plain version's, the card's bound and the
   earlier K1/K2 design's time (constants from PERF.md), each timed shape
   with its launch plan (cluster, tile rows, units per CTA, wh slice
   resident or streamed, shared memory, and how many of its clusters the
   card holds at once), K2 also as its two parts (recurrence, dwh) timed
   apart; then bf16 K1 and K2 the same way at the serving buckets (8, 32)
   and the training batches (64, and bench.py's 2048) at T=64, with three
   reruns bit-identical, and their times beside the f32 kernels' at B=64
   and 2048, K2's dwh beside one ``torch.matmul`` of the same product, and
   both under the cluster size the plan passed over beside the chosen
   plan (``LSTM_WAYS``), held to the plain version as well; then K1 and
   K2 in both dtypes at widths no main path runs (``ODD_WIDTHS``: 8-,
   64- and 72-unit CTAs, misaligned rows, streamed slices) and batches
   with masked rows, T=1 included, held to the plain versions with three
   reruns bit-identical;
4. serve — the flagship LSTM at full width (hidden 512, 2 layers, 64-step
   windows, 11 features, 7 outputs) with seeded random weights, saved as a
   checkpoint and served through the port's CLI (``serve --smoke 32``)
   under ``serve.precision=f32`` and ``=fused``: no request may fail, the
   fused run must go through K1 (launch counts reset just before it and
   read just after), its replies must lie inside the (lstm, fused)
   envelope of the f32 replies, and the f32 replies must agree with a
   direct per-sequence apply;
4a. serve over HTTP — the same flagship checkpointed and served by ``serve``
   subprocesses on free ports, one per scheduler: the step scheduler
   (``--scheduler continuous serve.max_slots=32 serve.step_blocks=2,8,32
   serve.profiles=bf16``) and the whole-sequence one (``--scheduler batch
   serve.seq_buckets=8,16,32,64,128 serve.profiles=fused``); bench.py's
   _bench_serve_seq traffic (320 sequences, 85% of 8-16 steps, 15% of
   96-128, numpy seed 0) POSTed from 8 client threads, once with every 4th
   request at ``{"profile": "bf16"}`` (continuous) or every 2nd at
   ``"fused"`` (batch) and once at f32 alone: /healthz, /stats and the
   /metrics 404, every f32 reply (the fused ones too: that tier serves
   float32) within F32_SERVE_TOL of a direct apply and every other inside
   its profile's envelope, requests/s and client
   p50/p99 per pass, the continuous-vs-batch ratio, SIGTERM → exit 0 with
   the final stats, the child's and the kernel launches logged; the
   continuous server launches no kernel (its blocks are the scan), the
   batch server's fused child launches K1 exactly layers x (its batches +
   its warmup programs); then both schedulers in this process with every
   sequence submitted at once (bench.py's way), each with one more pass
   under ``torch.profiler`` (device launches per dispatch, the device's
   busy share of the wall), and a saturated burst
   served across a mid-stream switch of the (2, 8, 32) ladder bit-equal to
   the fixed rung 2, with how many elements a hoisted input projection
   would round otherwise at other block sizes on the card and on the CPU;
5. train — the flagship at full width trained through the port's CLI
   (``train --model lstm --html-file tests/golden/euromillions.html``,
   2 epochs of B=64, f32) from seeded weights: two finite watch lines, K2
   launched exactly layers x steps x epochs times and K1 that plus the
   watch evaluations (counts reset just before, read just after), its
   ms/step and examples/s; then the same command at a float16 compute
   dtype, which the kernels do not take, must exit 17 (refused, never
   scanned);
6. step — one training step on the card against the same step on the CPU
   through the plain versions: the loss, every gradient and every updated
   parameter agree;
7. serve the trained checkpoint — ``serve --smoke 8`` under
   ``serve.precision=fused``, no failed request;
7e. govern (run right after 7) — the trained checkpoint behind
   ``make_sequence_engine`` in an f32 and a bf16 pool, with the step
   scheduler's governance parts: preemption (8 slots presaturated with 8
   bulk sequences of 512 steps, then 32 interactive ones of 8-32 steps:
   preemptions and restores, every bulk sequence done, none shed;
   p50_step_ms preempt-off against preempt-on), the budget (a RAM ledger
   of two victims' bytes and a spill directory: six victims spill and
   restore; in f32 one spill file corrupted on purpose sheds its own
   sequence, named), paging (2 pages of 4 rows, 32 sequences live, with a
   spill directory: peak_live >= 4x the rows, every row freed, both tiers
   drained; p50_step_ms dense against paged), the elastic pool (2 -> 32
   under a flood, then an explicit shrink that evicts and restores) and
   migration (in process, and in f32 through two ``serve --scheduler
   continuous`` children: ``/admin/export`` of a tag, ``/admin/migrate``).
   Every reply bit-equal to the same sequence served uninterrupted at the
   same block rows and within tolerance of a direct apply; the walls, the
   state bytes per slot and the counters printed; no kernel launched;
   and how many replies of the block program differ at 2-16 rows from
   32 rows on the card (why an elastic pool steps at max_slots rows);
7a. train at the default bfloat16 compute dtype through the CLI (the
   same command without ``model.compute_dtype=float32``): two finite watch
   lines, bf16 K2 launched exactly layers x steps x epochs times and bf16
   K1 that plus the watch chunks, the f32 kernels never; ms/step and
   examples/s;
7b. serve that checkpoint at its bfloat16 compute dtype through ``serve
   --smoke 32`` at ``f32``, ``bf16``, ``fused`` and ``int8w``: no failed
   request, each tier inside its envelope of the direct predict; fused and
   int8w serve float32, as the JAX package does, so they launch f32 K1
   once per layer per program and bf16 K1 never;
7c. bench.py's LSTM training step (B=2048, T=64, H=512, 2 layers, bf16,
   fused=auto, Adam 1e-3, mse): median ms/step, draws/s, bf16 K1+K2's
   share, a ``torch.profiler`` window and the peak memory;
7d. one bf16 training step at B=64 on the card against the CPU;
8. K3, the GBT histogram, against its plain version at the GBT paths'
   level shapes and at levels of depth 14 and 15 (errors relative to each
   cell's sum of magnitudes, three reruns bit-identical) and against
   float64 sums at two skewed shapes (90% of the rows in one node and four
   bins, hessians from 1e-8 to 0.25), each with its launch plan and shared
   memory; then its times beside the earlier node-tiled design's
   (constants from PERF.md), the plain version's, two ``torch.bincount``
   calls' and the card's bound, at the scaled GBT's deepest level also
   with the L2 flushed between launches, and at two shapes beside another
   plan (another way to add, K3_WAYS);
9. reference — ``reference --html-file tests/golden/euromillions.html``
   through the CLI at the full 500 rounds: exit 0, the printed boolean,
   K3 launched exactly 2 boosters x 500 rounds x 4 levels times (counts
   reset just before, read just after); then the pipeline through the API
   on the card and on the CPU, with their wall times: both boosters' trees
   equal in structure, predictions close;
10. golden trajectories — both 20-round configs of
   ``tests/golden/gbt_trajectory.json`` on the card against the CPU: equal
   tree structure, or a shown near-tie;
11. scaled GBT — bench.py's GBT_SCALED recipe (200k x 28, depth 6, 60
   rounds) on the card: K3 launched exactly 60 x 7 times, rounds/s, K3's
   share of the wall time (from phase 8's per-level times and from CUDA
   events around its launches in one more run, beside the earlier
   design's share from PERF.md); its
   first 5 trees against the CPU's;
12. ``fetch``, ``train --model gbt --save`` and ``predict --model-type gbt``
   through the CLI: the CLI's predictions bit-equal to Booster.predict;
13. K4a and K4b, the Wide&Deep one-hot contraction, against their plain
   versions in f32 and bf16 at the serving buckets (8, 32, 128), the
   training batch (64) and bench.py's batch (8192) at full width (21 x
   4096 x 1040), one odd shape and B=40000, past the earlier K4b's limit
   of 32768 rows (errors relative to each element's sum of magnitudes,
   three reruns bit-identical), each shape with its two launch plans,
   after the K4 library's ``-Xptxas -v`` lines; then their times per call
   (events around one wrapper call) and on the device (launches in a CUDA
   graph), K4b's sort and row writer apart (and the sort's count kernel
   where the batch has several tiles), at bench.py's batch also
   with the L2 flushed and K4a under each of its ways (``FWD_WAYS``),
   beside the plain versions', the library yardsticks' (``embedding_bag``,
   ``index_add_``) and the bounds; then both again at the tensor-parallel
   shard widths of phase 36 (E = 520 and 260, each shard a table of its
   own) at B=64 and 8192 in both dtypes: held to the plain versions,
   timed beside them, the library yardsticks and the bounds;
14. serve Wide&Deep — the 100M model with seeded random weights, saved as
   a TrainState checkpoint and served through the CLI (``serve
   --model-type wide_deep --smoke 32``): no failed request, K4a launched
   once per dispatched batch and bucket warmup (counts reset just before,
   read just after); then bench.py's rows through the engine, each reply
   bit-equal to a direct predict of the same bucket batch;
15. train Wide&Deep — ``train --model wide_deep --html-file
   tests/golden/euromillions.html`` at the defaults (B=64, bf16 towers,
   Adam), 2 epochs: two finite watch lines, K4b launched once per step and
   K4a that plus the watch evaluations, ms/step and examples/s; then
   ``serve --smoke 8`` on the checkpoint it saved;
16. bench.py's Wide&Deep step (B=8192, bf16, Adam): median ms/step,
   rows/s, K4a+K4b's launches (one each a step) and share of the step
   from their per-call and device times; then the step at the training
   batch (B=64); a ``torch.profiler`` window of each (kernel time per
   step, the device's busy share, the heaviest kernels);
17. one full-width Wide&Deep step on the card against the CPU, with f32
   towers and with the CLI's bf16 towers;
18. K3's set form (the random forest's one launch per level for all
   trees) at bench.py's RF_SHAPE level shapes (100k x 28, 32 bins, 20
   trees; levels 0, 4 and 7 as sibling subtraction's left halves and 8
   full), for the class pairs (20 sets) and the y-moments (40 sets): class
   counts bit-equal to the plain version, moments within K3_TOL of each
   cell's scale, each set bit-identical to a one-set launch, three reruns
   bit-identical; the same at the skewed shapes, four sets each, against
   float64 sums; then times beside the earlier design's (from PERF.md),
   the plain version's, a weighted ``torch.bincount`` yardstick's and the
   bound, at level 8 also with the L2 flushed between launches, and for
   the class pairs at levels 4 and 8 beside another plan (K3_SETS_WAYS);
19. the RF_SHAPE classifier on the card: exactly 9 set-form K3 launches
   per forest under ``hist_method=auto`` and 8 under ``pallas`` (counts
   reset just before each forest, read just after), trees/s (median of 3
   after 1 untimed), the wall time's host binning, host draws and K3
   shares (K3's beside the earlier design's from PERF.md); its trees
   bit-equal to the same seed's CPU forest (the tree count cut for that
   comparison when the CPU would take over a minute),
   auto's reachable trees bit-equal to pallas's, and the card forest's
   predictions bit-equal to the same trees predicted on the CPU;
20. the regressor at the same shape: launches, trees/s, and each tree
   equal to the CPU's in structure or a shown near-tie, leaf means close;
   a ``pallas`` regressor (sibling subtraction): exactly 8 launches, each
   reachable tree equal to auto's or a shown near-tie; the card forest's
   predictions within one ulp of the same trees predicted on the CPU;
21. ``train --model rf --num-classes 6 --save`` at the defaults (100
   trees, depth 8) on the golden page through the CLI: 9 K3 set launches
   of 300 sets; ``predict --model-type rf`` bit-equal to
   RandomForestModel.predict; ``serve --model-type rf --smoke 32`` on that
   model and ``serve --model-type gbt --smoke 32`` on phase 12's booster:
   no failed request, every reply bit-equal to a direct predict;
22. the MLP (BASELINE.json config 1) — ``train --model mlp --html-file
   tests/golden/euromillions.html`` at the ModelConfig defaults (hidden
   256, 256, the 10 label-dropped features, B=64, Adam, mse), 2 epochs
   (cut from 20), in bf16 and in f32, and the f32 command on the CPU: two
   finite watch lines each, ms/step and examples/s, the f32 run's
   per-epoch rmse within MLP_RMSE_TOL of the CPU's;
23. serve the MLP — ``serve --model-type mlp --smoke 32`` on the f32
   checkpoint at ``serve.precision=f32``, ``bf16`` and ``int8w`` and with
   ``serve.profiles=bf16,int8w``: no failed request; in process each
   profile's program at every bucket (8, 32, 128) against the f32
   predict (f32 bit-equal, bf16 and int8w inside their envelopes),
   requests naming each profile routed to it, each profile's
   ``serve_param_mb`` and its p50 and rows/s per bucket;
24. Wide&Deep's tiers — phase 14's checkpoint served through the CLI at
   ``bf16`` and ``int8w``: K4a counted from 0 in each run (the bf16
   program's batches and warmups plus the f32 profile's drift oracle's;
   at int8w the oracle's alone), K4b never; in process the int8w program
   launches no K4 kernel, each tier inside its envelope of the f32
   predict at every bucket, the tiers' params (int8w about a quarter of f32's) and p50 per
   bucket beside f32's;
25. classic — logistic regression, the linear SVM, Gaussian naive Bayes
   and k-means fitted on the card and on the CPU on the golden page's
   standardised rows (label column 0 as the class id; k-means from the
   same initial rows): fitted arrays within CLASSIC_TOL, test ids equal
   but at near ties, fit seconds; each saved as JSON and served through
   ``serve --model-type classic --smoke 32`` bit-equal to its predict;
26. DP-1 — ``train --model lstm --distributed`` through the CLI at the
   flagship's defaults (bf16, B=64, 2 epochs): one visible card, so a group
   of one over NCCL in this process; bf16 K1/K2 launched as many times as
   in the plain run, and its checkpoint bit-equal to the plain ``train
   --model lstm``'s at the same seed;
27. DP-1 for the other families, the same way: ``train --model mlp
   --distributed`` and ``train --model wide_deep --distributed`` at the
   CLI defaults (Wide&Deep at 100M parameters: K4a/K4b counted from 0,
   every step's gradients through one all-reduced f32 bucket) and ``train
   --model rf --num-classes 6 --distributed`` (9 K3 set launches), each
   beside the plain command at the same seed: launches equal, output
   bit-equal, ms/step (the forest's wall) beside the plain run's;
28. DP-2 and RF-mesh — two ranks on the one card (child processes, a gloo
   group over CUDA tensors: NCCL refuses two ranks on one device), after
   the single-process references in this process: the full-width flagship
   through ``DistributedTrainer`` with SGD for one epoch of global B=64
   over the golden windows (1129 = 17 x 64 + 41: the last batch padded),
   at bf16 and then f32, the ranks' params bit-identical and within
   DP2_PARAM_TOL of the single process (a tolerance at most a tenth of
   the distance the epoch moves the params, so a gradient-scale fault
   cannot pass), each kernel of the dtype launched layers x 18 times a
   rank, ms/step beside the single process's; then RF_SHAPE's classifier
   and regressor row-sharded
   over the two ranks (K3's set form on each rank's rows, one all-reduce a
   level): 9 set launches a rank, the classifier's trees equal to one
   device's, the regressor's equal or a shown near tie;
29. parameter averaging — one rank (a group of one over NCCL), the MLP at
   its defaults, two local steps a round: bit-equal to the plain trainer's
   replay on the card;
30. TBPTT (runs right after 7d) — ``train --model lstm --tbptt`` at the
   CLI defaults (H=512, 2 layers, chunk 50, 8 lanes of the golden
   history, bf16 inputs), 2 epochs (cut from 20): two finite epoch
   records, no K1/K2 launch in either dtype (counted from 0: TBPTT carries
   (h, c) into every chunk, so the layers scan), the checkpoint reloaded
   as a whole TrainState and its validation mse recomputed, ms per epoch
   and per chunk timed on the step; then the command in f32 on the card
   and on the CPU, per-epoch mse within TBPTT_F32_TOL;
31. chunked trees (runs after 21) — bench.py's serve_trees shape: a
   2048-tree synthetic GBT served in chunks of 256 (threshold 512, one
   bucket of 32), replies bit-equal to ``Booster.predict`` and to the
   unchunked engine, the ledger's tree-table peak within two blocks,
   ``serve_tree_chunks_total`` from ``/metrics`` over HTTP, one
   ``serve.chunk`` fault failing only its batch; the 256-tree ensemble on
   the whole-ensemble path with rows/s beside the plain engine's (a miss
   of bench.py's 0.9 is printed as one); RF_SHAPE's classifier in chunks
   of 4 bit-equal, its regressor's approximate mean inside the (rf,
   chunked_mean) envelope;
32. libemtpu and ``reference`` fetching (runs right after 9) — the port's
   loader builds ``native/emtpu.cpp`` here (the phase fails on the Python
   path), the golden ``fetch`` CSV read natively bit-equal to the Python
   parse; ``reference`` with ``data.url`` at a localhost server of the
   golden page whose first GET answers 503: one retry, the printed
   boolean and both predictions bit-equal to phase 9's ``--html-file``
   run, timed, K3 launched 4000 times;
33. the AOT program store (runs last, after 29) — AOT_FAMILIES at full
   width, each cut to one program of its ladder: the f32 MLP, the seeded
   100M Wide&Deep at bf16 (K4a), the trained flagship's fused padded
   program (K1) and one f32 rung of its step-scheduler ladder with the
   rung's gather, the 2048-tree ensemble's chunk program. Cold child
   processes (one a family, all at once, each with an empty Inductor cache
   under ``build/``) serve each family from an empty store — every program
   exported, compiled by AOTInductor, saved and loaded back — then one
   warm child serves them all from those stores: the seconds to compile
   each package, first-request-served cold and warm, the load time, zero
   compiles warm, replies bit-identical to the cold run's, the store-on/off
   gap (f32 within rtol 1e-5 / atol 1e-6, bf16 inside its envelope), the
   trees bit-equal to ``predict``, K1 (2 a batch) and K4a (1 a batch, 1 a
   drift check) launched from inside the loaded packages and those paths
   against their plain versions' programs on the CPU; then ``aot prewarm``
   (the trees), ``aot ls|verify`` through the CLI, and a truncated blob: a
   counted miss, quarantined;
34. the fleet (runs last, on phase 33's warm ladder store and Wide&Deep
   checkpoint) — two step-scheduler hosts of the trained flagship (f32,
   32 slots, block 8) behind a FleetRouter: the unfaulted fleet, then a
   host killed mid-traffic (ejected on stale probes, its sequences
   re-routed) and a reachable host whose attainment collapses (ejected,
   its live sequences migrated), every reply bit-equal to the unfaulted
   fleet's and within F32_SERVE_TOL of the direct apply; two ``serve
   --scheduler batch serve.precision=fused`` children behind a ``fleet``
   front-end child, one SIGKILLed mid-traffic: no client request fails,
   /healthz shows the ejection, K1 counted from the survivor's SIGTERM
   line; the supervisor over hosts from the warm store: a dead host
   respawned with 0 compiles and re-admitted by probation, a planned
   ``restart_host`` and a ``drain_export`` handoff, bit-equal; the 100M
   Wide&Deep rolled out bf16 → int8w (shadow, canary, full, commit) and a
   faulted canary rolled back, no failed request (K4a counted); the six
   ``fleet.*`` fault points fired once each; the phase's seconds;
35. the deployment boundary (runs right after 33, before 34; its children
   start with phase 33's cold ones) — ``export`` through the CLI of the trained
   flagship (f32, full width, batch 16) and of phase 33's 100M Wide&Deep
   (bf16, batch 16), each compiled by AOTInductor in a child process beside
   phase 33's cold children, with the native runner's g++ build in another:
   the runner's build seconds, each package's compile seconds and size,
   ``ldd`` of the runner (no ``libpython``); then 24 batches of each through
   the C++ runner on the card, which launches K1 (exactly 2 a batch) and
   K4a (exactly 1 a batch) from its own C++ registration and counts them
   itself, with no call of a CPU implementation; replies bit-equal to the
   same package loaded in this process (``aoti_load_package``), the
   flagship within rtol 1e-5 / atol 1e-6 of eager on the card and within
   F32_SERVE_TOL of the plain versions on the CPU (the elementwise pin
   printed beside it), Wide&Deep inside its bf16 envelope; a second
   runner on the same export compiles nothing; ``predict --model-type
   exported --runtime native`` on the golden CSV: 1705 finite rows, within
   the envelope of ``--runtime torch``; the runner's load, first-reply and
   median batch milliseconds beside the in-process package's and eager's;
36. parallelism (runs after 34, on the trained flagship) — TP-2: the 100M
   Wide&Deep at ``mesh.data=1 mesh.model=2`` on two rank processes sharing
   the card over gloo at B=8192, the wide table split by columns (K4a/K4b
   launched once a step each, on each rank's 520-wide shard): 3 SGD steps
   with f32 towers, the joined params within rtol 2e-5 / atol 2e-6 of one
   process's from the same params; 3 timed Adam steps with bf16 towers,
   each rank's ms/step beside one process's. SP-2: the full-width flagship
   (T=64, f32, B=64, two microbatches) at ``mesh.seq=2`` on the pipelined
   chunk scan: its output within 1e-5 and its gradients within atol 2e-5 /
   rtol 2e-4 of one process's scan, ms/step beside it, K1/K2 0. Sharded
   serving in this process on meshes laid on the one card (``devices=``
   naming card 0 more than once): the trained flagship's step scheduler on
   2x1 (32 slots, 64 sequences of ``http_traffic()``) bit-equal to the
   block program at a shard's 16 rows and to the unsharded 16-slot
   scheduler, within F32_SERVE_TOL of the direct apply (its agreement
   with the unsharded 32-slot scheduler printed: on the card a product
   rounds otherwise at another row count), stats ``mesh == "2x1"``, K1/K2
   0; the 100M Wide&Deep row engine on 1x2 and 1x4 at f32 (elementwise
   max rel, the JAX pin) and bf16 (max|diff| / max|ref|, the serving
   envelope's measure) within 1e-2 of one device, K4a counted per model
   shard at widths 520 and 260; one ``serve.shard`` fault fails one batch and the session
   serves on; ``serve ... serve.mesh=2,1`` on the one card exits 17; the
   phase's seconds;
37. the ``kernels`` JSON line (K1's ``launches_by_path`` holds phase 4a's
   ``serve_http_fused``, K4a's phase 24's ``serve_bf16`` and the int8w
   run's drift oracle, bf16 K1's and K2's ``train_dp`` (phase 26), K4a's
   and K4b's ``train_dp`` and the class forest's ``cli_train_dp`` (phase
   27), every K1/K2 row's ``train_dp_gloo`` (phase 28, summed over the
   ranks), the forest set forms' ``rf_mesh``, every K1/K2 row's
   ``train_tbptt`` (phase 30, 0), K3's ``reference_fetch`` (phase 32),
   K1's ``aot_padded_fused`` and K4a's ``aot_serve_bf16`` (phase 33),
   K1's ``fleet_http_fused`` and K4a's ``rollout_bf16`` (phase 34), K1's
   ``export_native`` and K4a's ``export_native_bf16``, counted by the
   runner process (phase 35), K4a's and K4b's ``tp_train``, K4a's
   ``serve_mesh``, K1's and K2's ``train_sp`` and K1's ``serve_mesh_step``
   (phase 36, the last three 0); K4a's and K4b's ``shard_widths``: phase
   13's times at widths 520 and 260), the ``nvidia-smi`` line,
   and last the ``{"ok": true, "device": ...}`` line. The lines phases
   22-36 measure carry the card's name and power limit.

Run from the root of a checkout: ``python3 chip_smoke.py``. Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
Any failed check ends the run with exit code 1.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import io
import json
import logging
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SEED = 0
HIDDEN, LAYERS, SEQ_LEN, FEATURES, OUTPUTS = 512, 2, 64, 11, 7
SMOKE_REQUESTS = 32
# K1 at the serving path's (row bucket, time bucket) shapes
K1_SHAPES = ((8, 8), (32, 16), (128, 64))
TIMED_SHAPE = (128, 64)
# K1 at the largest time bucket phase 4a's fused child runs
# (serve.seq_buckets=...,128 at the row buckets 8, 32, 128): checked at
# K1_TOL, not timed
K1_HTTP_SHAPES = ((8, 128), (32, 128), (128, 128))
# K1 with residuals at the training path's shape
K1_TRAIN_SHAPE = (64, 64)
TRAIN_EPOCHS = 2
TRAIN_SMOKE_REQUESTS = 8
STEP_RUNS = 5
GOLDEN_HTML = Path("tests") / "golden" / "euromillions.html"
# kernel vs plain version, both f32 on the card: summation order only.
# Measured at most 1.49e-7 (gates) on an H100 across K1_SHAPES and
# K1_TRAIN_SHAPE; pinned at ~10x that.
K1_TOL = 1.5e-6
# f32 serve replies vs a direct per-sequence apply (other batch shapes,
# so other GEMM algorithms — rounding only): measured 6.7e-7 max-rel on
# an H100, pinned at ~10x
F32_SERVE_TOL = 1e-5
# K2 at the training path's (batch, steps) shapes; timed at the second
K2_SHAPES = ((16, 8), (64, 64))
# K2 vs its plain version, both f32 on the card, on the same K1
# residuals: summation order only (the dh carry's 4H-long dots, dwh's
# (T-1)*B-long sums, dpeep's CTA partials). Each error is taken relative
# to the output's own scale, max|ref|. Measured on an H100 at K2_SHAPES:
# dxp 3.0e-7, dpeep 2.9e-7, dwh 3.1e-6 (its 4032-term sums); pinned at
# ~10x each.
K2_TOL = {"dxp": 3e-6, "dwh": 3e-5, "dpeep": 3e-6}
# the layer's parameter gradients through K1+K2 vs autograd through the
# plain scan, relative to each gradient's scale: measured at most 2.3e-6
# (wh) on an H100 at (64, 64); pinned at ~10x
FUNCTION_GRAD_TOL = 3e-5
# one full-width training step on the card (K1+K2) vs the CPU (plain
# versions), measured on an H100 and pinned at ~10x: the loss (relative,
# measured 9.2e-8) and each gradient relative to its scale (measured at
# most 1.3e-6, 0_LSTM.wh). The updated params are compared in absolute
# terms: adam's first step is lr * g / (|g| + 3.2e-7) per element, so a
# gradient element within a few ulps of zero can move its update by a
# visible fraction of lr = 1e-3 (measured 1.0e-5).
STEP_LOSS_TOL = 1e-6
STEP_GRAD_TOL = 1.5e-5
STEP_PARAM_TOL = 1e-4
# bf16 K1/K2 at H=512: the serving buckets (8, 32) at T=64, the training
# batch (64) and bench.py's batch (2048); timed at the training batch and
# at bench.py's
BF16_SHAPES = ((8, 64), (32, 64), (64, 64), (2048, 64))
BF16_TIMED = ((64, 64), (2048, 64))
# bf16 K1/K2 vs their plain versions on the card, both bf16 with f32
# carries and sums: a rounding flipped by another summation order moves
# an element by one bf16 ulp, and the carry passes it on. Each error is
# relative to the output's scale, max|ref|; one ulp at the scale is
# 2^-8..2^-7 of it. Measured on an H100 at BF16_SHAPES: K1 at most 4.9e-3
# (hs, B=32), K2 5.1e-3 (dwh, B=2048), dpeep (f32) 9.5e-5; pinned at two
# ulps at the bottom of the scale's binade, 2^-6.
BF16_KERNEL_TOL = 2.0 ** -6
# K1/K2 at widths no main path runs, where the plan and the kernels take
# their other branches: H=100 (8-unit CTAs, f32's wh slice resident, rows
# not 16-byte aligned: element loads, and dwh's plain-load ring), H=1024
# (64-unit CTAs, 128-byte swizzled dgates tiles, bf16 K1's wh slice
# streamed) and H=1139 (the widest the earlier design took: 72-unit CTAs,
# misaligned rows, both dtypes' slices streamed), at a serving bucket (8)
# and an odd batch (33: a tile with masked rows), and at T=1 (dwh sums
# no rows); held to the plain versions at K1_TOL, K2_TOL and
# BF16_KERNEL_TOL, three reruns bit-identical
ODD_WIDTHS = (100, 1024, 1139)
ODD_SHAPES = ((8, 8), (33, 8), (33, 1))
# bench.py's _bench_lstm at WORKLOAD on an accelerator: B=2048, bf16,
# fused=auto, Adam 1e-3, mse
LSTM_BENCH = {"batch": 2048, "warmup": 2, "steps": 10}
# one bf16 step at B=64 on the card (bf16 K1+K2) against the CPU (their
# plain versions), from the same params and batch. Loss relative, measured
# 1.3e-6 on an H100; each gradient (adam's mu) relative to its scale,
# measured at most 2.9e-3 (1_LSTM.wh: bf16 roundings flipped by the
# card's other summation orders); pinned at ~10x each. The updated params
# are not compared (adam's first step maps a gradient element to about
# +-lr, so a near-zero element of opposite sign moves its param by 2 lr)
LSTM_BF16_STEP_TOL = {"loss": 1e-5, "grad": 3e-2}
# phase 4a: the flagship behind the serve CLI's HTTP front end, with
# bench.py's _bench_serve_seq traffic (numpy seed 0: 85% of the sequences
# 8-16 steps, 15% 96-128) sent by HTTP_CLIENTS threads, once per server
# with the servers' extra profiles mixed in and once at f32 alone (the
# timed pass of the continuous-vs-batch ratio)
HTTP_SEQUENCES = 320
HTTP_CLIENTS = 8
HTTP_SERVERS = {
    "continuous": (["--scheduler", "continuous", "serve.max_slots=32",
                    "serve.step_blocks=2,8,32", "serve.profiles=bf16"],
                   "bf16", 4),   # every 4th request at bf16
    "batch": (["--scheduler", "batch", "serve.seq_buckets=8,16,32,64,128",
               "serve.profiles=fused"], "fused", 2),  # every 2nd fused
}
# seconds a server may take to answer /healthz, and any request or exit
HTTP_WAIT = 120
# the mid-stream rung switch on the card: sequences long enough to span
# several blocks, more of them than slots (load >= 1 from the start)
RUNG_SWITCH = {"sequences": 96, "steps": 64, "slots": 32,
               "blocks": (2, 8, 32)}
# The earlier K1/K2 design's times (8-row CTAs streaming all of wh from L2
# every step on the FP32 pipe; K2's dwh a 64 x 64-tile SIMT product over
# all of R in one pass), ms per launch on an H100 80GB HBM3 at 700 W, as
# PERF.md §6 records them (PRs 1-5): constants, printed beside this run's
# times and never measured here
EARLIER_LSTM_MS = {
    "K1 f32 B=8 T=8": 0.7974, "K1 f32 B=32 T=16": 1.6091,
    "K1 f32 B=128 T=64": 6.5984, "K1 f32 residuals B=64 T=64": 6.5956,
    "K1 f32 residuals B=2048 T=64": 15.0163,
    "K1 bf16 residuals B=64 T=64": 6.1960,
    "K1 bf16 residuals B=2048 T=64": 12.6553,
    "K2 f32 B=64 T=64": 8.0236, "K2 f32 B=2048 T=64": 34.1528,
    "K2 bf16 B=64 T=64": 7.8147, "K2 bf16 B=2048 T=64": 35.4600}
# K1/K2 under a plan lstm_plan passed over, beside the plan it chose, at
# bench.py's batch and the training batch in bf16: clusters of 8 CTAs (64
# units each, 32-row tiles, wh streamed) beside its 16, the size the plan
# would take where 16 could not be placed or were slower. The values
# replace the chosen plan's fields.
LSTM_WAYS = {"K1": {"cluster": 8}, "K2": {"cluster": 8}}
# the SASS of K1's and K2's libraries: the kernels (by mangled-name
# fragment) whose bf16 instantiations must run tensor-core instructions
# (HMMA: mma.sync; HGMMA: wgmma), and those of f32, which must run none
# (f32 means FP32 FMAs, never TF32)
SASS_TENSOR_CORES = {"lstm_fwd_kernelI13__nv_bfloat16": "HMMA",
                     "lstm_bwd_kernelI13__nv_bfloat16": "HMMA",
                     "dwh_wgmma_kernel": "HGMMA"}
SASS_F32 = ("lstm_fwd_kernelIf", "lstm_bwd_kernelIf", "dwh_simt_kernel",
            "dwh_reduce_kernelIf")
# K3 at the GBT paths' level shapes: the reference pipeline's levels
# (1193 rows x 10 features, 44 bins, 1-8 nodes), the scaled GBT's levels
# (200k x 28, 256 bins, 1-64 nodes), one bin count above 256, a depth-8
# GBT's deepest level, whose tile of 128 nodes x 256 bins is cut into two
# bin tiles, a depth-14 level (one-bin tiles) and a depth-15 level with 32
# bins (node tiles); timed at the scaled GBT's deepest level
K3_SHAPES = tuple((1193, 10, 44, 1 << d) for d in range(4)) + tuple(
    (200_000, 28, 256, 1 << d) for d in range(7)) + (
    (50_000, 8, 300, 4), (50_000, 8, 256, 128), (50_000, 8, 256, 1 << 14),
    (50_000, 8, 32, 1 << 15))
K3_TIMED_SHAPE = (200_000, 28, 256, 64)
# K3 where the scaled GBT's rows pile up: at its widths, 90% of the rows in
# one node and in four bins of every feature, and the hessians of
# saturated logistic rows, p (1 - p) for margins spread over +-18.4, so
# from 1e-8 to 0.25; at the shallowest and the deepest level
K3_SKEWED_SHAPES = ((200_000, 28, 256, 1), (200_000, 28, 256, 64))
# The earlier K3 design's times (node tiles re-reading the rows, four warp
# copies per block), ms per launch on an H100 80GB HBM3 at 700 W, as PERF.md
# §6 records them: constants, printed beside this run's times and never
# measured here
NODE_TILED_K3_MS = {
    "1193x10x44x1": 0.0486, "1193x10x44x2": 0.0427, "1193x10x44x4": 0.0411,
    "1193x10x44x8": 0.0485, "200000x28x256x1": 0.1242,
    "200000x28x256x2": 0.1300, "200000x28x256x4": 0.1404,
    "200000x28x256x8": 0.2266, "200000x28x256x16": 0.5141,
    "200000x28x256x32": 0.7493, "200000x28x256x64": 1.1871,
    "50000x8x300x4": 0.0551}
NODE_TILED_K3_SETS_MS = {
    "classes_0": 0.4747, "classes_4": 0.5726, "classes_7": 1.4009,
    "classes_8": 5.2103, "moments_0": 0.9052, "moments_4": 1.0919,
    "moments_7": 2.8472, "moments_8": 10.6632}
# K3's share of the scaled GBT's wall and of the RF_SHAPE forests' under
# the earlier design (PERF.md §5): constants, printed beside this run's
NODE_TILED_SCALED_K3_SHARE = "0.14-0.21"
NODE_TILED_RF_K3_SHARE = {"RF classifier": "0.029", "RF regressor": "0.054"}
# K3 under a plan that launch_plan passed over, beside the plan it chose:
# each of the kernel's three ways to add (lanes on rows with one owner,
# lanes on rows split among several owners, lanes on features) against
# another way at a shape of the main paths where both fit a block. The
# one-set form at the reference pipeline's deepest level and at the scaled
# GBT's 8-node level; the set form at RF_LEVELS 4 and 8 (class pairs). The
# values replace the chosen plan's fields.
K3_WAYS = {(1193, 10, 44, 8): {"copies": 2, "owners": 8},
           (200_000, 28, 256, 8): {"owners": 1}}
K3_SETS_WAYS = {4: {"by_feature": 0}, 8: {"by_feature": 1}}
# bytes written between two launches when a kernel is timed with a cold
# L2 (50 MB on an H100)
L2_FLUSH_BYTES = 128 << 20
# K3 vs its plain version, both f32 on the card: summation order only.
# Each cell's error is taken relative to the sum of the magnitudes it adds
# (sum |gw| or sum |hw| over its rows). Measured at most 1.15e-6 on an
# H100 (200k rows, one node); pinned at ~10x. At K3_SKEWED_SHAPES a cell
# adds up to 45k rows, and the plain version's own f32 sum (index_add_'s
# atomics, one long chain per cell) strays by more than this, so there K3
# is held to the same sums taken in float64, with the same tolerance.
K3_TOL = 1e-5
# two packages' or two devices' split gains closer than this (relative)
# are a near-tie, which f32 summation order may decide either way
NEAR_TIE = 1e-5
# GBT predictions and logloss, card vs CPU (the sigmoid and log differ by
# ulps between the devices; histogram sums by summation order)
GBT_PRED_TOL = 1e-5
GOLDEN_PIN = Path("tests") / "golden" / "gbt_trajectory.json"
# bench.py's GBT_SCALED recipe; the CPU replays its first rounds
SCALED = {"rows": 200_000, "features": 28, "rounds": 60, "max_depth": 6,
          "eta": 0.3, "gamma": 0.0}
SCALED_CPU_ROUNDS = 5
# bench.py's RF_SHAPE (BASELINE.json config 3) at train_classifier's other
# defaults (Poisson bootstrap, sqrt features, seed as bench.py's first
# timed run), timed as the median of RF_RUNS forests after one untimed
RF_SHAPE = {"rows": 100_000, "features": 28, "trees": 20, "max_depth": 8,
            "max_bins": 32, "num_classes": 2}
RF_SEED = 1
RF_RUNS = 3
# the CPU forest the card's is compared with: its tree count is cut (for
# the comparison only) so that it takes about this long
RF_CPU_SECONDS = 60.0
# K3's set form at RF_SHAPE's level shapes: (level, nodes per launch,
# which): sibling subtraction's left halves and the direct path's full
# levels, the deepest of each; timed at level 8 full, the main path's
# costliest launch
RF_LEVELS = ((0, 1, "full"), (4, 8, "left half"), (7, 64, "left half"),
             (8, 256, "full"))
# a regression forest's leaf means, card vs CPU (other summation orders of
# the same sums), relative to the largest leaf magnitude: measured 1.0e-7
# on an H100 at RF_SHAPE; pinned at ~10x
RF_REG_LEAF_TOL = 1e-6
# a regression forest's mean over trees, card vs CPU on the same trees:
# the same ordered sum and reciprocal, so expected bit-equal; pinned at
# one ulp of the largest prediction
RF_REG_PRED_ULPS = 1
# a regressor's leaf means, pallas (sibling subtraction) vs auto on the
# card, relative to the largest leaf magnitude: parent − left rounds at
# the parent's scale; pinned at the JAX package's own tree tolerance
# (tests/test_random_forest.py, 1e-5) taken relative
RF_SUB_LEAF_TOL = 1e-5
# K4a/K4b at the Wide&Deep paths' (B, K, V, E): the serving buckets, the
# training batch and bench.py's WD_SHAPE batch at full width (21 pair
# tables of 4096 codes, E = 1040), and one odd shape with ids outside
# [0, V); timed at the training batch
K4_SHAPES = tuple((b, 21, 4096, 1040) for b in (8, 32, 128, 64, 8192)) + (
    (5, 3, 300, 20),)
K4_TIMED_B = 64
# a batch past the earlier K4b's limit of 32768 rows (F6): held to the
# plain versions in both dtypes, reruns bit-identical; not timed
K4_F6_SHAPE = (40000, 21, 4096, 1040)
# K4a's and K4b's device times: launches per CUDA graph (device_ms)
K4_DEVICE_LAUNCHES = 50
# K4a/K4b against their plain versions (K4a's on the card, K4b's on CPU
# copies, whose index_add_ adds in batch order): both add in the same
# order, so bit-equal is expected; any error is taken relative to the sum
# of the magnitudes each output element adds, and pinned here
K4_TOL = 1e-6
WD_SMOKE_REQUESTS = 32
WD_TRAIN_SMOKE_REQUESTS = 8
# replies to single rows coalesced by the engine against a direct predict
# of the same rows in one batch of another shape: other cuBLAS algorithms
# for the bf16 towers, so bf16 rounding only; held to the (wide_deep,
# bf16) envelope
WD_CROSS_SHAPE_TOL = 2e-2
# one full-width step on the card against the CPU from the same params and
# batch. The loss and the step's outputs are relative (max|got - ref| /
# max|ref|), each gradient relative to its own scale, each updated param
# absolute. f32 towers, measured on an H100: loss 0, gradients 4.1e-7 of
# their scale; updated params 1.5e-6 — adam's first step is lr * g / (|g|
# + 3.2e-7) per element, so an element whose gradient sits near that eps
# moves by a visible fraction of lr = 1e-3 (as in the LSTM step); pinned
# at 1% of lr. The CLI's bf16 towers: loss and outputs inside the
# (wide_deep, bf16) envelope; gradients measured 3.8e-2 of their scale
# (a date-field embedding; the deep tower's bf16 GEMMs round otherwise on
# the card than on the CPU, while the wide table's gradient agrees to
# 1.6e-8), pinned at 1e-1; the updated params are not compared: the first
# adam step maps every gradient element to about +-lr, so a near-zero
# element of opposite sign moves its param by 2 lr (measured 2.0e-3), which
# says nothing the gradient check does not
WD_STEP_TOL = {"float32": {"loss": 1e-6, "out": 1e-5, "grad": 1e-5,
                           "param": 1e-5},
               "bfloat16": {"loss": 2e-2, "out": 2e-2, "grad": 1e-1,
                            "param": None}}
# bench.py's _bench_wide_deep: B = WD_SHAPE["batch"], 15 timed steps
WD_BENCH = {"batch": 8192, "warmup": 2, "steps": 15}
# the row families (phases 22-25): serve --smoke request counts; the row
# engine's buckets (ServeConfig's); per bucket, ROW_P50_RUNS closed-loop
# requests of one full bucket, then ROW_RATE_REQUESTS at once
MLP_SMOKE_REQUESTS = 32
CLASSIC_SMOKE_REQUESTS = 32
ROW_BUCKETS = (8, 32, 128)
ROW_P50_RUNS = 20
ROW_RATE_REQUESTS = 64
# the f32 MLP's per-epoch train-rmse / test-rmse on the card against the
# same CLI command on the CPU, relative: f32 on both sides (TF32 off), the
# products and reductions summed in other orders over 2 x 19 Adam steps
MLP_RMSE_TOL = 1e-4
# the classic fits on the card against the CPU's: each fitted array within
# this fraction of its scale (500 f32 gradient steps, or 50 Lloyd
# iterations from the same rows, summed in other orders); the linear SVM's
# hinge mask is discontinuous, so its fits may part where a margin sits
# within this of 1 (svm_first_flip); a test id may differ only where the
# CPU's top two scores are nearer than this fraction of the scores' scale
CLASSIC_TOL = 1e-4
CLASSIC_K = 6
# training across ranks (phases 26-29): two ranks share the one card over
# gloo (NCCL refuses two ranks on one device); global batch B=64 for one
# epoch of the golden page's 1129 windows = 17 x 64 + 41, so the last
# batch is padded (its 41 real rows all on rank 0 of 2: 32 + 9)
DP_RANKS = 2
DP_BATCH = 64
DP_EPOCHS = 1
# how long the ranks may wait on each other, and the two-rank phase in all
DP_GROUP_TIMEOUT_S = 120.0
DP_PHASE_TIMEOUT_S = 420.0
# DP-2 trains with plain SGD (as tests/test_torch_dist_train.py does), so
# the update is proportional to the gradient: a loss normaliser off by a
# factor (the local count, or the ranks' sum left undivided) moves the
# params by about as much as the whole epoch moves them. Adam's update
# barely changes when the gradient is scaled, and would hide that.
DP2_LR = 1e-3
# DP-2's params after its epoch (2 ranks of B=32, gradients all-reduced in
# f32) against the single-process trainer at B=64 on the card, absolute.
# bf16: the ranks' B=32 products (cuBLAS's input projection, K1/K2) round
# to bf16 apart from one process's B=64 ones; measured 1.320e-3 (0_LSTM.wx)
# on an NVIDIA H100 80GB HBM3 at 700.00 W, two calls alike, pinned at
# ~4x. f32: only summation orders differ; measured 1.192e-7
# (1_LSTM.bias) on the same card, two calls alike, pinned at ~8x. (At
# SGD 1e-4 the bf16 difference did not shrink, 7.641e-3, while the epoch
# moved the params 270x less: bf16's roundings of the weights do not
# scale with lr. 1e-3 keeps the check sharp.)
DP2_PARAM_TOL = {"bfloat16": 5e-3, "float32": 1e-6}
# the largest distance the single process's epoch moves a param must be
# at least this many times the tolerance, so that a gradient-scale fault
# (which moves the params by about that distance) cannot pass
DP2_POWER = 10
# parameter averaging (phase 29): the MLP at ModelConfig's defaults,
# per-worker B=64, two local steps a round, one rank
PA_SYNC_EVERY = 2
# the card's name and power limit (nvidia-smi), beside every measured line
# of phases 22-25
CARD = ""
# H100 SXM data-sheet peaks (dense): FP32 non-tensor, bf16 tensor cores
# and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, runs: int = 20) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events per run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, launches: int = 50, runs: int = 5) -> float:
    """Median milliseconds per call of ``fn`` on the card without the
    host's time: ``launches`` calls captured in one CUDA graph, the graph
    replayed between CUDA events ``runs`` times, each time divided by the
    count. ``fn`` must launch on the current stream and allocate nothing
    it keeps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def earlier(key: str, ms: float) -> str:
    """This run's time beside the earlier design's (EARLIER_LSTM_MS)."""
    was = EARLIER_LSTM_MS.get(key)
    if was is None:
        return "earlier design not timed"
    return (f"earlier design {was:.4f} ms in PERF.md ({was / ms:.2f}x this "
            f"run)")


def lstm_plan_line(what: str, dtype, batch: int, steps: int,
                   backward: bool) -> dict:
    """Prints the launch plan K1 (or K2) runs at one shape, with how many
    of its clusters the card holds at once; fails if none can be placed.
    Returns the plan's fields."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    plan = K.lstm_plan(dtype, batch, HIDDEN, steps, backward)
    active = K.max_active_clusters(dtype, plan, backward)
    wh = ("resident" if plan.resident else
          f"streamed ({plan.slots} slots of {plan.ktile} rows)")
    print(f"{what} plan B={batch} T={steps} H={HIDDEN} "
          f"{str(dtype).replace('torch.', '')}: cluster {plan.cluster} CTAs "
          f"x {plan.tiles} batch tiles of {plan.rows} rows, {plan.units} "
          f"units per CTA, wh slice {wh}, depth splits {plan.splits}, "
          f"{plan.threads} threads, smem {plan.smem} B per CTA, max active "
          f"clusters {active}"
          + (f", dwh split {plan.dwh_split}" if backward else ""))
    check(active >= 1, f"{what} plan at B={batch} cannot be placed")
    return {**plan._asdict(), "max_active_clusters": active}


def k2_parts_ms(wh, peep, res, g_hs, runs: int) -> dict:
    """K2's parts timed apart through its C entry point: the recurrence
    (dxp and dpeep's tile partials) and dwh (the split product and its
    reduction), each launch counted as any other."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    t, b, h = res[0].shape
    plan = K.lstm_plan(wh.dtype, b, h, t, backward=True)
    kernel = K._BWD_KERNELS[wh.dtype]
    dxp, dwh, dpeep = (torch.empty_like(res[2]), torch.empty_like(wh),
                       torch.empty_like(peep))
    out = {}
    for name, parts in (("recurrence", K.BWD_RECURRENCE), ("dwh", K.BWD_DWH)):
        args, scratch = K._bwd_args(plan, wh, peep, res, g_hs, dxp, dwh,
                                    dpeep, True, parts)
        out[name] = time_ms(lambda: kernel.launch(*args), runs=runs)
        del scratch
    return out


def lstm_ways_lines(x_proj, wh, peep, g_hs, chosen: dict) -> None:
    """K1 (residuals written) and K2 under the LSTM_WAYS plan beside the
    chosen plan's times (``chosen``: K1 and K2 ms), each held to the plain
    version at BF16_KERNEL_TOL as the chosen plan is (K2 on the plain
    version's residuals, as phase 3's check)."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    t, b, four_h = x_proj.shape
    h = four_h // 4
    ref = K.lstm_sequence_reference(x_proj, wh, peep, True)
    ref_b = K.lstm_backward_reference(wh, peep, ref, g_hs, True)
    failures = []
    for kern in ("K1", "K2"):
        backward = kern == "K2"
        plan = K._plan(wh.dtype, b, h, t, backward, **LSTM_WAYS[kern])
        outs = ((torch.empty_like(ref[2]), torch.empty_like(wh),
                 torch.empty_like(peep)) if backward else
                tuple(torch.empty_like(r) for r in ref))
        if backward:
            args, scratch = K._bwd_args(plan, wh, peep, ref, g_hs, *outs,
                                        True, K.BWD_ALL)
            kernel = K._BWD_KERNELS[wh.dtype]
        else:
            args = K._fwd_args(plan, x_proj, wh, peep, *outs, True)
            kernel = K._FWD_KERNELS[wh.dtype]
        ms = time_ms(lambda: kernel.launch(*args), runs=10)
        torch.cuda.synchronize()
        worst = max(max_errors(o, r)[1]
                    for o, r in zip(outs, ref_b if backward else ref))
        print(f"{kern} ways bf16 B={b} T={t}: chosen plan (cluster "
              f"{K.lstm_plan(wh.dtype, b, h, t, backward).cluster}) "
              f"{chosen[kern]:.4f} ms; cluster {plan.cluster} ({plan.rows}-row "
              f"tiles, wh {'resident' if plan.resident else 'streamed'}, max "
              f"active clusters "
              f"{K.max_active_clusters(wh.dtype, plan, backward)}) "
              f"{ms:.4f} ms ({ms / chosen[kern]:.2f}x), rel_to_scale "
              f"{worst:.3e} (tol {BF16_KERNEL_TOL:.2e})")
        if worst > BF16_KERNEL_TOL:
            failures.append(f"{kern} under {LSTM_WAYS[kern]}: rel "
                            f"{worst:.3e}")
    check(not failures, "; ".join(failures))


def phase_sass() -> None:
    """``cuobjdump --dump-sass`` of K1's and K2's libraries as built: every
    bf16 instantiation runs tensor-core instructions (HMMA, HGMMA) and no
    f32 one does."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    ops = {}
    for kernel in (K.FUSED_LSTM_FWD, K.FUSED_LSTM_BWD):
        sass = subprocess.run([tool, "--dump-sass", str(kernel.path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        name = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                name = ln.split("Function :")[1].strip()
                ops[name] = {"HGMMA": 0, "HMMA": 0}
            elif name is not None:
                for op in ops[name]:
                    ops[name][op] += len(re.findall(rf"\b{op}\b", ln))
    failures = []
    for frag, op in SASS_TENSOR_CORES.items():
        found = [n for n in ops if frag in n]
        for n in found:
            print(f"sass: {frag}: HGMMA {ops[n]['HGMMA']}, HMMA "
                  f"{ops[n]['HMMA']} (bf16: {op} expected)")
        if not found or any(ops[n][op] == 0 for n in found):
            failures.append(f"{frag} has no {op}")
    for frag in SASS_F32:
        found = [n for n in ops if frag in n]
        for n in found:
            print(f"sass: {frag}: HGMMA {ops[n]['HGMMA']}, HMMA "
                  f"{ops[n]['HMMA']} (f32: none allowed)")
        if not found or any(sum(ops[n].values()) for n in found):
            failures.append(f"{frag} missing or on the tensor cores")
    check(not failures, "SASS: " + "; ".join(failures))


def k1_inputs(batch: int, steps: int, peepholes: bool,
              hidden: int = HIDDEN):
    """Layer-1 inputs of the flagship model (or of the same layer at
    another width) at one (rows, steps) shape: x_proj from a real input
    projection, wh and peepholes as initialised."""
    from euromillioner_tpu_torch.nn.recurrent import LSTM

    gen = torch.Generator().manual_seed(SEED + batch + steps)
    layer = LSTM(FEATURES, hidden, peepholes=peepholes, generator=gen,
                 device="cuda").requires_grad_(False)
    x = torch.randn((batch, steps, FEATURES), generator=gen).cuda()
    x_proj = layer._input_proj(x).contiguous()
    return x_proj, layer.wh.contiguous(), layer._peep_rows()


def max_errors(got, ref) -> tuple[float, float]:
    diff = (got.double() - ref.double()).abs().max().item()
    return diff, diff / (ref.double().abs().max().item() + 1e-30)


def phase_k1() -> dict:
    from euromillioner_tpu_torch.ops import fused_lstm as K

    worst = 0.0
    for batch, steps in K1_SHAPES + (K1_TRAIN_SHAPE,) + K1_HTTP_SHAPES:
        for peepholes in (True, False):
            x_proj, wh, peep = k1_inputs(batch, steps, peepholes)
            ref = K.lstm_sequence_reference(x_proj, wh, peep, peepholes)
            torch.cuda.synchronize()
            hs_only = K.lstm_sequence(x_proj, wh, peep, peepholes)
            torch.cuda.synchronize()
            full = K.lstm_forward(x_proj, wh, peep, peepholes)
            torch.cuda.synchronize()
            errs = {"hs(no residuals)": max_errors(hs_only, ref[0])}
            for name, got, want in zip(("hs", "cs", "gates"), full, ref):
                errs[name] = max_errors(got, want)
            for name, (abs_err, rel_err) in errs.items():
                print(f"K1 B={batch} T={steps} H={HIDDEN} "
                      f"peepholes={peepholes} {name}: max_abs={abs_err:.3e} "
                      f"max_rel={rel_err:.3e} (tol {K1_TOL:.0e})")
                check(abs_err <= K1_TOL,
                      f"K1 {name} at B={batch} T={steps} differs by "
                      f"{abs_err:.3e} > {K1_TOL:.0e}")
                worst = max(worst, abs_err)
    timed, plans = {}, {}
    for batch, steps in K1_SHAPES:
        plans[f"B={batch} T={steps}"] = lstm_plan_line(
            "K1", torch.float32, batch, steps, False)
        x_proj, wh, peep = k1_inputs(batch, steps, True)
        ms = time_ms(lambda: K.lstm_sequence(x_proj, wh, peep, True))
        plain_ms = time_ms(
            lambda: K.lstm_sequence_reference(x_proj, wh, peep, True))
        # the least the card could take: inputs read once (x_proj, wh,
        # peep), hs written once, and the recurrent product's
        # 2*T*B*H*4H FLOPs on the FP32 pipe
        nbytes = 4 * (x_proj.numel() + wh.numel() + peep.numel()
                      + steps * batch * HIDDEN)
        flops = 2 * steps * batch * HIDDEN * 4 * HIDDEN
        bytes_ms = nbytes / PEAK_HBM_BYTES_S * 1e3
        ops_ms = flops / PEAK_FP32_FLOPS * 1e3
        timed[batch, steps] = (ms, plain_ms, bytes_ms, ops_ms)
        print(f"K1 timing B={batch} T={steps} H={HIDDEN} f32: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms ({flops / 1e9:.3f} GFLOP -> "
              f"{ops_ms:.4f} ms; {nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} "
              f"ms); {earlier(f'K1 f32 B={batch} T={steps}', ms)}")
    # with residuals (cs and gates written too) at the training shape:
    # the bytes add cs (T*B*H) and gates (T*B*4H) written once
    batch, steps = K1_TRAIN_SHAPE
    plans[f"B={batch} T={steps}"] = lstm_plan_line(
        "K1", torch.float32, batch, steps, False)
    x_proj, wh, peep = k1_inputs(batch, steps, True)
    train_ms = time_ms(lambda: K.lstm_forward(x_proj, wh, peep, True))
    train_plain_ms = time_ms(
        lambda: K.lstm_sequence_reference(x_proj, wh, peep, True))
    nbytes = 4 * (x_proj.numel() + wh.numel() + peep.numel()
                  + 6 * steps * batch * HIDDEN)
    flops = 2 * steps * batch * HIDDEN * 4 * HIDDEN
    print(f"K1 timing with residuals B={batch} T={steps} H={HIDDEN} f32: "
          f"kernel {train_ms:.4f} ms, plain {train_plain_ms:.4f} ms, bound "
          f"{max(nbytes / PEAK_HBM_BYTES_S, flops / PEAK_FP32_FLOPS) * 1e3:.4f}"
          f" ms ({flops / 1e9:.3f} GFLOP; {nbytes / 1e6:.2f} MB); "
          f"{earlier(f'K1 f32 residuals B={batch} T={steps}', train_ms)}")
    ms, plain_ms, bytes_ms, ops_ms = timed[TIMED_SHAPE]
    return {"name": "fused_lstm_fwd", "route": "cuda",
            "source": "euromillioner_tpu_torch/csrc/fused_lstm.cu",
            "replaces": "euromillioner_tpu/ops/fused_lstm.py:88",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None,
            "ms_by_shape": {f"B={b} T={t}": timed[b, t][0]
                            for b, t in K1_SHAPES},
            "residuals_ms": train_ms, "plan": plans}


def k2_inputs(batch: int, steps: int, peepholes: bool):
    """K2's inputs at one shape: K1's residuals on the flagship layer's
    inputs, and a seeded incoming gradient g_hs."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    x_proj, wh, peep = k1_inputs(batch, steps, peepholes)
    residuals = K.lstm_forward(x_proj, wh, peep, peepholes)
    gen = torch.Generator().manual_seed(SEED + 7 * batch + steps)
    g_hs = torch.randn((steps, batch, HIDDEN), generator=gen).cuda()
    return wh, peep, residuals, g_hs


def layer_grads(layer, x, g, fused: str) -> dict:
    """Gradients of every parameter of ``layer`` for sum(apply(x) * g)
    with ``layer.fused`` set to ``fused``."""
    layer.fused = fused
    layer.zero_grad(set_to_none=True)
    (layer.apply(x, train=True) * g).sum().backward()
    return {n: p.grad.detach().clone() for n, p in layer.named_parameters()}


def phase_k2() -> dict:
    from euromillioner_tpu_torch.nn.recurrent import LSTM
    from euromillioner_tpu_torch.ops import fused_lstm as K

    worst = 0.0
    failures = []
    for batch, steps in K2_SHAPES:
        for peepholes in (True, False):
            wh, peep, res, g_hs = k2_inputs(batch, steps, peepholes)
            want = K.lstm_backward_reference(wh, peep, res, g_hs, peepholes)
            torch.cuda.synchronize()
            got = K.lstm_backward(wh, peep, res, g_hs, peepholes)
            torch.cuda.synchronize()
            again = K.lstm_backward(wh, peep, res, g_hs, peepholes)
            torch.cuda.synchronize()
            for name, a, b, w in zip(("dxp", "dwh", "dpeep"), got, again,
                                     want):
                abs_err, rel_err = max_errors(a, w)
                same = torch.equal(a, b)
                print(f"K2 B={batch} T={steps} H={HIDDEN} "
                      f"peepholes={peepholes} {name}: max_abs={abs_err:.3e} "
                      f"rel_to_scale={rel_err:.3e} (tol {K2_TOL[name]:.0e}), "
                      f"scale {w.abs().max().item():.3e}, "
                      f"bit-identical rerun {same}")
                if rel_err > K2_TOL[name] or not same:
                    failures.append(f"K2 {name} at B={batch} T={steps} "
                                    f"peepholes={peepholes}: rel "
                                    f"{rel_err:.3e}, rerun equal {same}")
                worst = max(worst, abs_err)
    # the Function inside the layer: every parameter's gradient through
    # K1+K2 against autograd through the plain scan, on the card
    batch, steps = K2_SHAPES[-1]
    for peepholes in (True, False):
        gen = torch.Generator().manual_seed(SEED + 11)
        layer = LSTM(FEATURES, HIDDEN, return_sequences=True,
                     peepholes=peepholes, generator=gen, device="cuda")
        x = torch.randn((batch, steps, FEATURES), generator=gen).cuda()
        g = torch.randn((batch, steps, HIDDEN), generator=gen).cuda()
        kernel = layer_grads(layer, x, g, "on")
        plain = layer_grads(layer, x, g, "off")
        for name in plain:
            abs_err, rel_err = max_errors(kernel[name], plain[name])
            print(f"K1+K2 Function grad {name} B={batch} T={steps} "
                  f"peepholes={peepholes}: max_abs={abs_err:.3e} "
                  f"rel_to_scale={rel_err:.3e} (tol {FUNCTION_GRAD_TOL:.0e})")
            if rel_err > FUNCTION_GRAD_TOL:
                failures.append(f"Function grad {name}: rel {rel_err:.3e}")
    check(not failures, "; ".join(failures))

    batch, steps = K2_SHAPES[-1]
    plan = lstm_plan_line("K2", torch.float32, batch, steps, True)
    wh, peep, res, g_hs = k2_inputs(batch, steps, True)
    ms = time_ms(lambda: K.lstm_backward(wh, peep, res, g_hs, True))
    parts = k2_parts_ms(wh, peep, res, g_hs, runs=20)
    plain_ms = time_ms(
        lambda: K.lstm_backward_reference(wh, peep, res, g_hs, True))
    # the least the card could take: g_hs, hs, cs, gates, wh, peep read
    # once, dxp, dwh, dpeep written once; the dh carry and dwh each
    # 2*(T-1)*B*H*4H FLOPs on the FP32 pipe (the t = 0 terms are zero)
    hs, cs, gates = res
    nbytes = 4 * (g_hs.numel() + hs.numel() + cs.numel() + gates.numel()
                  + 2 * wh.numel() + 2 * peep.numel() + gates.numel())
    flops = 2 * 2 * (steps - 1) * batch * HIDDEN * 4 * HIDDEN
    bytes_ms = nbytes / PEAK_HBM_BYTES_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    print(f"K2 timing B={batch} T={steps} H={HIDDEN} f32: kernel "
          f"{ms:.4f} ms (recurrence {parts['recurrence']:.4f}, dwh "
          f"{parts['dwh']:.4f} timed apart), plain {plain_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({flops / 1e9:.3f} GFLOP -> "
          f"{ops_ms:.4f} ms; {nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms); "
          f"{earlier(f'K2 f32 B={batch} T={steps}', ms)}")
    return {"name": "fused_lstm_bwd", "route": "cuda",
            "source": "euromillioner_tpu_torch/csrc/fused_lstm_bwd.cu",
            "replaces": "euromillioner_tpu/ops/fused_lstm.py:175",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None, "recurrence_ms": parts["recurrence"],
            "dwh_ms": parts["dwh"], "plan": plan}


def serve_cli(ckdir: Path, precision: str,
              requests: int = SMOKE_REQUESTS,
              compute_dtype: str = "float32") -> dict:
    from euromillioner_tpu_torch import cli

    argv = ["serve", "--model-type", "lstm", "--checkpoint", str(ckdir),
            "--smoke", str(requests), f"model.compute_dtype={compute_dtype}",
            f"serve.precision={precision}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"serve {precision} exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    shown = {k: v for k, v in summary.items() if k != "predictions"}
    print(f"serve {precision}: failed: {summary['failed']} "
          f"{json.dumps(shown)}")
    check(summary["failed"] == 0, f"serve {precision}: requests failed")
    return summary


def phase_serve(root: Path) -> int:
    """The main path; returns K1's launches during the fused serve."""
    from euromillioner_tpu_torch.config import ServeConfig
    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD
    from euromillioner_tpu_torch.serve.transport import smoke_payloads
    from euromillioner_tpu_torch.train.checkpoint import save_checkpoint

    model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused="off",
                       in_features=FEATURES,
                       generator=torch.Generator().manual_seed(SEED),
                       device="cuda").requires_grad_(False)
    ckdir = root / "build" / "chip_smoke" / "ck"
    shutil.rmtree(ckdir, ignore_errors=True)
    save_checkpoint(str(ckdir), model, step=0)

    f32 = serve_cli(ckdir, "f32")
    FUSED_LSTM_FWD.launches = 0
    fused = serve_cli(ckdir, "fused")
    launches = FUSED_LSTM_FWD.launches
    serve = ServeConfig()
    programs = fused["stats"]["batches"] + (
        len(serve.buckets) * len(serve.seq_buckets) if serve.warmup else 0)
    print(f"serve fused: K1 launches {launches} for "
          f"{fused['stats']['batches']} batches + warmup programs "
          f"(expected {LAYERS} x {programs})")
    check(launches > 0, "the fused serve never launched K1")
    check(launches == LAYERS * programs,
          f"K1 launched {launches} times, expected {LAYERS * programs}")

    payloads = smoke_payloads(SMOKE_REQUESTS, FEATURES, SEQ_LEN)
    with torch.inference_mode():
        direct = [model.apply(torch.tensor([p], device="cuda"))[0].cpu()
                  for p in payloads]
    got_f32 = torch.tensor(f32["predictions"])
    got_fused = torch.tensor(fused["predictions"])
    check(tuple(got_f32.shape) == (SMOKE_REQUESTS, OUTPUTS)
          and tuple(got_fused.shape) == (SMOKE_REQUESTS, OUTPUTS),
          "reply shapes")
    check(bool(torch.isfinite(got_f32).all() and torch.isfinite(got_fused)
               .all()), "non-finite replies")
    oracle_err = rel_error(got_f32, torch.stack(direct))
    envelope = SERVE_ENVELOPES[("lstm", "fused")]
    fused_err = rel_error(got_fused, got_f32)
    print(f"serve check: f32 vs direct apply rel {oracle_err:.3e} "
          f"(tol {F32_SERVE_TOL:.0e}); fused vs f32 rel {fused_err:.3e} "
          f"(envelope {envelope:.0e})")
    check(oracle_err <= F32_SERVE_TOL, "f32 replies disagree with apply")
    check(fused_err <= envelope, "fused replies outside the envelope")
    shutil.rmtree(ckdir.parent, ignore_errors=True)
    return launches


def http_traffic() -> list:
    """bench.py's _bench_serve_seq sequences (numpy seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    n = HTTP_SEQUENCES
    short = rng.integers(8, 17, size=n)
    long_ = rng.integers(96, 129, size=n)
    lens = np.where(rng.random(n) < 0.85, short, long_)
    return [rng.normal(size=(int(t), FEATURES)).astype(np.float32)
            for t in lens]


def direct_apply(model, seqs) -> "torch.Tensor":
    """model.apply of every sequence on the card, one batch per length."""
    import numpy as np

    out = torch.empty((len(seqs), OUTPUTS))
    by_len: dict = {}
    for i, s in enumerate(seqs):
        by_len.setdefault(len(s), []).append(i)
    with torch.inference_mode():
        for idx in by_len.values():
            x = torch.from_numpy(np.stack([seqs[i] for i in idx])).cuda()
            out[idx] = model.apply(x).float().cpu()
    return out


def http_call(url: str, path: str, body=None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url + path, data=data), timeout=HTTP_WAIT) as reply:
            return reply.status, json.loads(reply.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_pass(url: str, seqs, profile_of) -> dict:
    """Every sequence POSTed from HTTP_CLIENTS threads; replies, client
    latencies (ms) and requests/s over the pass's wall."""
    replies: list = [None] * len(seqs)
    lat: list = [0.0] * len(seqs)

    def client(c: int) -> None:
        for i in range(c, len(seqs), HTTP_CLIENTS):
            body = {"rows": seqs[i].tolist()}
            if profile_of(i):
                body["profile"] = profile_of(i)
            t0 = time.perf_counter()
            status, reply = http_call(url, "/predict", body)
            lat[i] = (time.perf_counter() - t0) * 1e3
            replies[i] = reply["predictions"] if status == 200 else None

    t0 = time.perf_counter()
    with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
        list(pool.map(client, range(HTTP_CLIENTS)))
    wall = time.perf_counter() - t0
    lat.sort()
    return {"replies": replies, "rps": len(seqs) / wall,
            "p50_ms": statistics.median(lat),
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat) + 0.5))]}


def serve_http(root: Path, ckdir: Path, name: str, seqs) -> dict:
    """One ``serve`` subprocess on a free port: /healthz, /stats and the
    /metrics 404, the mixed pass, the f32 pass, then SIGTERM; returns the
    passes, its /stats and what its shutdown logged (final stats, the
    child's, kernel launches). The process is killed if anything fails."""
    import signal
    import socket

    extra, profile, every = HTTP_SERVERS[name]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    log = root / "build" / "chip_smoke" / f"http_{name}.log"
    argv = [sys.executable, "-m", "euromillioner_tpu_torch", "serve",
            "--model-type", "lstm", "--checkpoint", str(ckdir),
            f"serve.port={port}", "model.compute_dtype=float32", *extra]
    t_start = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen(argv, cwd=root, stdout=fh,
                                stderr=subprocess.STDOUT)
        try:
            while True:
                try:
                    status, health = http_call(url, "/healthz")
                    break
                except OSError:
                    check(proc.poll() is None and time.perf_counter()
                          - t_start < HTTP_WAIT, f"serve {name} never "
                          f"answered /healthz: {log.read_text()[-2000:]}")
                    time.sleep(0.2)
            up_s = time.perf_counter() - t_start
            check(status == 200 and health["ok"], f"{name} /healthz")
            print(f"serve http {name}: up in {up_s:.1f} s; /healthz "
                  f"{json.dumps(health)}")
            status, ctype, text = http_text(url, "/metrics")
            check(status == 200 and ctype.startswith("text/plain")
                  and "serve_requests_total" in text, f"{name} /metrics")
            mixed = http_pass(url, seqs, lambda i: profile
                              if i % every == 0 else None)
            f32 = http_pass(url, seqs, lambda i: None)
            status, stats = http_call(url, "/stats")
            check(status == 200, f"{name} /stats")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=HTTP_WAIT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=HTTP_WAIT)
    text = log.read_text()
    check(rc == 0 and "shutting down" in text,
          f"serve {name} after SIGTERM: rc {rc}: {text[-2000:]}")

    def logged(prefix: str) -> dict:
        line = next(ln for ln in text.splitlines() if prefix in ln)
        return json.loads(line.split(prefix, 1)[1])

    return {"mixed": mixed, "f32": f32, "stats": stats,
            "final": logged("final stats: "),
            "child": logged(f"final stats of the {profile} profile: "),
            "launches": logged("kernel launches: "), "profile": profile,
            "every": every}


def phase_serve_http(root: Path) -> int:
    """Phase 4a: the flagship served over HTTP by the CLI under both
    schedulers, each reply held to a direct apply (f32 within
    F32_SERVE_TOL, the extra profile inside its envelope), the continuous
    server launching no kernel and the batch server's fused child K1 once
    per layer per program; then the mid-stream rung switch on the card.
    Returns K1's launches on the HTTP fused path."""
    from euromillioner_tpu_torch.config import ServeConfig
    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.train.checkpoint import save_checkpoint

    model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused="off",
                       in_features=FEATURES,
                       generator=torch.Generator().manual_seed(SEED),
                       device="cuda").requires_grad_(False)
    ckdir = root / "build" / "chip_smoke" / "http_ck"
    shutil.rmtree(ckdir, ignore_errors=True)
    save_checkpoint(str(ckdir), model, step=0)
    seqs = http_traffic()
    direct = direct_apply(model, seqs)
    runs = {}
    for name in HTTP_SERVERS:
        run = runs[name] = serve_http(root, ckdir, name, seqs)
        for what in ("mixed", "f32"):
            p = run[what]
            check(all(r is not None for r in p["replies"]),
                  f"{name} {what}: requests failed")
            got = torch.tensor(p["replies"])
            at = [i for i in range(len(seqs)) if what == "mixed"
                  and i % run["every"] == 0]
            plain = [i for i in range(len(seqs)) if i not in set(at)]
            err = rel_error(got[plain], direct[plain])
            env = SERVE_ENVELOPES[("lstm", run["profile"])]
            prof_err = rel_error(got[at], direct[at]) if at else 0.0
            print(f"serve http {name} {what}: {p['rps']:.2f} requests/s, "
                  f"client p50 {p['p50_ms']:.3f} ms, p99 "
                  f"{p['p99_ms']:.3f} ms; f32 replies rel to direct apply "
                  f"{err:.3e} (tol {F32_SERVE_TOL:.0e})"
                  + (f"; {len(at)} {run['profile']} replies {prof_err:.3e} "
                     f"(envelope {env:.0e}"
                     + (f", tol {F32_SERVE_TOL:.0e}"
                        if run["profile"] == "fused" else "") + ")"
                     if at else ""))
            check(err <= F32_SERVE_TOL, f"{name} f32 replies disagree")
            check(prof_err <= env, f"{name} {run['profile']} replies "
                  f"outside the envelope")
            # the fused tier serves float32 through K1: held as f32 too
            check(run["profile"] != "fused" or prof_err <= F32_SERVE_TOL,
                  f"{name} fused replies {prof_err:.3e} > "
                  f"{F32_SERVE_TOL:.0e}")
        st = run["final"]
        print(f"serve http {name}: final stats {json.dumps(st)}; child "
              f"{json.dumps(run['child'])}; kernel launches "
              f"{json.dumps(run['launches'])}")
        check(st["sequences"] == 2 * len(seqs) - len(seqs) // run["every"]
              and run["child"]["sequences"] == len(seqs) // run["every"],
              f"{name} served counts")
    cont = runs["continuous"]
    check(not any(cont["launches"].values()),
          "the continuous server launched a kernel (its blocks scan)")
    print(f"serve http continuous: block_hist "
          f"{json.dumps(cont['final']['block_hist'])}, mean_occupancy "
          f"{cont['final']['mean_occupancy']}, readbacks "
          f"{cont['final']['readbacks']} for {cont['final']['sequences']} "
          f"sequences")
    batch = runs["batch"]
    serve = ServeConfig()
    warm = len(serve.buckets) * 5  # serve.seq_buckets=8,16,32,64,128
    k1 = batch["launches"]["emt_lstm_fwd_f32"]
    want = LAYERS * (batch["child"]["batches"] + warm)
    print(f"serve http batch: fused child K1 launches {k1} (expected "
          f"{LAYERS} x ({batch['child']['batches']} batches + {warm} warmup "
          f"programs) = {want})")
    check(k1 > 0 and k1 == want, f"HTTP fused K1 launches {k1} != {want}")
    check(sum(batch["launches"].values()) == k1, "other kernels launched")
    ratio = cont["f32"]["rps"] / batch["f32"]["rps"]
    print(f"serve http: continuous / batch requests/s at f32 "
          f"{cont['f32']['rps']:.2f} / {batch['f32']['rps']:.2f} = "
          f"{ratio:.3f}")
    open_loop_rates(model, seqs, direct)
    phase_rung_switch(model)
    shutil.rmtree(ckdir, ignore_errors=True)
    return k1


def open_loop_rates(model, seqs, direct) -> None:
    """The two schedulers in this process, bench.py's _bench_serve_seq way:
    every sequence submitted at once (no HTTP, no client threads), f32,
    one warm pass, then requests/s of one timed pass each; replies held
    to the direct apply at F32_SERVE_TOL."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import rel_error
    from euromillioner_tpu_torch.serve.continuous import (
        RecurrentBackend, StepScheduler, WholeSequenceScheduler)

    backend = RecurrentBackend(model, feat_dim=FEATURES,
                               compute_dtype=torch.float32)
    rates = {}
    for name, make in (
            ("batch", lambda: WholeSequenceScheduler(
                backend, row_buckets=(8, 32),
                time_buckets=(8, 16, 32, 64, 128), warmup=True)),
            ("continuous", lambda: StepScheduler(
                backend, max_slots=32, step_blocks=(2, 8, 32)))):
        with make() as eng:
            for f in [eng.submit(s) for s in seqs[:16]]:
                f.result(timeout=HTTP_WAIT)
            t0 = time.perf_counter()
            futures = [eng.submit(s) for s in seqs]
            got = torch.tensor(np.stack([f.result(timeout=HTTP_WAIT)
                                         for f in futures]))
            rates[name] = len(seqs) / (time.perf_counter() - t0)
            st = eng.stats()
            profiled_pass(name, eng, seqs)
        err = rel_error(got, direct)
        shown = {k: st[k] for k in ("block_hist", "mean_occupancy",
                                    "readbacks", "p50_step_ms",
                                    "mean_time_fill", "mean_row_fill")
                 if k in st}
        print(f"serve open loop {name}: {rates[name]:.2f} requests/s; "
              f"rel to direct apply {err:.3e}; {json.dumps(shown)}")
        check(err <= F32_SERVE_TOL, f"open loop {name} replies disagree")
    print(f"serve open loop: continuous / batch "
          f"{rates['continuous'] / rates['batch']:.3f}")


def profiled_pass(name: str, eng, seqs) -> None:
    """One more open-loop pass of ``seqs`` under ``torch.profiler`` (not
    timed for the rate): the device kernels and copies launched per
    scheduler dispatch (a step block, or a micro-batch), and their device
    time's share of the pass's wall (the busy share; the rest is idle).
    A measurement only: it checks nothing."""
    from torch.profiler import ProfilerActivity, profile

    key = "steps" if "steps" in eng.stats() else "batches"
    before = eng.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in [eng.submit(s) for s in seqs]:
            f.result(timeout=HTTP_WAIT)
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = eng.stats()
    dispatches = after[key] - before[key]
    # a step block of K advances every slot K steps
    substeps = sum(int(k) * (n - before.get("block_hist", {}).get(k, 0))
                   for k, n in after.get("block_hist", {}).items())
    launches, busy_ms, rows = 0, 0.0, []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        launches += e.count
        busy_ms += us / 1e3
        rows.append((us / 1e3, e.count, e.key))
    if not launches:
        print(f"serve open loop {name} profiled: the profiler recorded no "
              f"device time (not measured)")
        return
    print(f"serve open loop {name} profiled: {launches} device kernels and "
          f"copies over {dispatches} {key} = {launches / dispatches:.1f} "
          f"a dispatch"
          + (f", {launches / substeps:.1f} a step of the pool over "
             f"{substeps} steps" if substeps else "")
          + f"; device time {busy_ms:.3f} ms of the pass's "
          f"{wall_ms:.3f} ms wall = busy share {busy_ms / wall_ms:.4f}")
    for ms, count, kname in sorted(rows, reverse=True)[:6]:
        print(f"serve open loop {name} profiled:   {ms:.3f} ms in {count} "
              f"launches  {kname[:80]}")


def phase_rung_switch(model) -> None:
    """A saturated burst served across a mid-stream ladder switch on the
    card, bit-equal to the same sequences at the fixed smallest rung; and
    whether the hoisted input projection (the scan's one product over all
    of a block's rows) would round otherwise at other block sizes, on the
    card and on the CPU — why the block program projects each step at the
    pool's row count."""
    import numpy as np

    from euromillioner_tpu_torch.nn.recurrent import LSTM
    from euromillioner_tpu_torch.serve.continuous import (RecurrentBackend,
                                                          StepScheduler)

    cfg = RUNG_SWITCH
    rng = np.random.default_rng(3)
    seqs = [rng.normal(size=(cfg["steps"], FEATURES)).astype(np.float32)
            for _ in range(cfg["sequences"])]
    backend = RecurrentBackend(model, feat_dim=FEATURES,
                               compute_dtype=torch.float32)
    replies = {}
    for name, kw in (("ladder", {"step_blocks": cfg["blocks"]}),
                     ("fixed", {"step_block": cfg["blocks"][0]})):
        with StepScheduler(backend, max_slots=cfg["slots"], start=False,
                           **kw) as eng:
            futures = [eng.submit(s) for s in seqs]
            eng.start()
            replies[name] = np.stack([f.result(timeout=HTTP_WAIT)
                                      for f in futures])
            hist = eng.stats()["block_hist"]
        print(f"rung switch {name}: block_hist {json.dumps(hist)}")
    same = np.array_equal(replies["ladder"], replies["fixed"])
    print(f"rung switch: {cfg['sequences']} x {cfg['steps']} steps over "
          f"{cfg['slots']} slots, ladder {list(cfg['blocks'])} against "
          f"block {cfg['blocks'][0]}: bit-identical {same}")
    check(len(hist) == 1, "the fixed run switched rungs")
    check(same, "a mid-stream rung switch moved a reply")
    layers = [lyr for _n, lyr in model.named_layers()
              if isinstance(lyr, LSTM)]
    x = torch.from_numpy(np.stack(seqs[:cfg["slots"]]))[:, :32]
    for dev in ("cuda", "cpu"):
        counts = []
        for layer, width in zip(layers, (FEATURES, HIDDEN)):
            layer = layer if dev == "cuda" else copy.deepcopy(layer).cpu()
            inp = (x if width == FEATURES else torch.from_numpy(
                rng.normal(size=(cfg["slots"], 32, HIDDEN)).astype(
                    np.float32))).to(dev)
            with torch.inference_mode():
                whole = layer._input_proj(inp)
                for k in cfg["blocks"][:-1]:
                    parts = torch.cat([layer._input_proj(inp[:, i:i + k])
                                       for i in range(0, 32, k)])
                    counts.append(int((parts != whole).sum()))
        print(f"rung switch: hoisted input projection on {dev}, elements "
              f"differing from one K=32 product at K={list(cfg['blocks'][:-1])}"
              f" per layer: {counts} of {whole.numel()} per layer")


def golden_windows(root: Path):
    """The training path's windows: (train, test) Datasets of seq_len
    windows over the golden page, as ``cli train`` builds them."""
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.data.pipeline import pipeline_from_html
    from euromillioner_tpu_torch.models.lstm import make_sequences

    tr, va = pipeline_from_html((root / GOLDEN_HTML).read_text())
    return tuple(Dataset(*make_sequences(ds.full_rows(), SEQ_LEN))
                 for ds in (tr, va))


def lstm_counts() -> dict:
    from euromillioner_tpu_torch.ops import fused_lstm as K

    return {"K1.f32": K.FUSED_LSTM_FWD.launches,
            "K1.bf16": K.FUSED_LSTM_FWD_BF16.launches,
            "K2.f32": K.FUSED_LSTM_BWD.launches,
            "K2.bf16": K.FUSED_LSTM_BWD_BF16.launches}


def reset_lstm_counts() -> None:
    from euromillioner_tpu_torch.ops import fused_lstm as K

    for kernel in (K.FUSED_LSTM_FWD, K.FUSED_LSTM_FWD_BF16, K.FUSED_LSTM_BWD,
                   K.FUSED_LSTM_BWD_BF16):
        kernel.launches = 0


def train_cli(root: Path, name: str, dtype_args: list[str]
              ) -> tuple[dict, int, int, Path]:
    """The flagship trained through the CLI (``train --model lstm`` on the
    golden page, TRAIN_EPOCHS epochs, plus ``dtype_args``), every LSTM
    launch counter reset just before and read just after. Checks the exit
    code, two finite watch lines and the fit summary, and prints ms/step
    and examples/s. Returns the counts, the expected K1 and K2 launches
    of one kernel pair, and the checkpoint directory."""
    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.config import DataConfig

    out = root / "build" / "chip_smoke"
    ckdir = out / name
    jsonl = out / f"{name}.jsonl"
    shutil.rmtree(ckdir, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    jsonl.unlink(missing_ok=True)
    argv = ["train", "--model", "lstm", "--html-file",
            str(root / GOLDEN_HTML), f"train.epochs={TRAIN_EPOCHS}",
            *dtype_args, f"train.metrics_jsonl={jsonl}", "--save",
            str(ckdir)]
    reset_lstm_counts()
    rc = cli.main(argv)
    counts = lstm_counts()
    check(rc == 0, f"{name} exited {rc}")
    records = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    rounds = [r for r in records if "round" in r]
    summary = [r for r in records if r.get("event") == "fit_summary"]
    for r in rounds:
        print(f"{name} watch line [{r['round']}]: train-rmse "
              f"{r['train-rmse']:.6f} test-rmse {r['test-rmse']:.6f}")
    check(len(rounds) == TRAIN_EPOCHS, f"{name}: {len(rounds)} watch "
          f"lines, expected {TRAIN_EPOCHS}")
    check(all(math.isfinite(r[k]) for r in rounds
              for k in ("train-rmse", "test-rmse")), f"{name}: non-finite "
          f"rmse")

    train_ds, test_ds = golden_windows(root)
    batch = DataConfig().batch_size
    steps = -(-len(train_ds) // batch)
    evals = -(-len(train_ds) // batch) + -(-len(test_ds) // batch)
    want_k2 = LAYERS * steps * TRAIN_EPOCHS
    want_k1 = want_k2 + LAYERS * evals * TRAIN_EPOCHS
    print(f"{name}: {len(train_ds)} windows -> {steps} steps/epoch of "
          f"B={batch}; launches {json.dumps(counts)}; expected K2 {LAYERS} "
          f"layers x {steps} x {TRAIN_EPOCHS} epochs = {want_k2}, K1 "
          f"{want_k2} + {LAYERS} x {evals} watch chunks x {TRAIN_EPOCHS} = "
          f"{want_k1}")
    check(len(summary) == 1, f"{name}: no fit summary")
    stats = summary[0]
    card(f"{name} timing (device-synchronised steps, {stats['steps']} "
         f"timed): {stats['mean_step_ms']:.4f} ms/step, "
         f"{stats['examples_per_sec']:.1f} examples/s")
    return counts, want_k1, want_k2, ckdir


def phase_train(root: Path) -> tuple[int, int, Path]:
    """The training main path through the CLI in f32; returns K1's and
    K2's launches during it and the checkpoint directory."""
    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.ops.fused_lstm import kernel_refusal

    counts, want_k1, want_k2, ckdir = train_cli(
        root, "train", ["model.compute_dtype=float32"])
    k1, k2 = counts["K1.f32"], counts["K2.f32"]
    check(k2 == want_k2, f"K2 launched {k2} times, expected {want_k2}")
    check(k1 == want_k1, f"K1 launched {k1} times, expected {want_k1}")
    check(counts["K1.bf16"] == counts["K2.bf16"] == 0,
          "an f32 train launched the bf16 kernels")
    # float16 is a compute dtype the kernels do not take: the card refuses
    # it by name (ConfigError, exit 17) and never scans
    check(kernel_refusal(torch.float16, HIDDEN) is not None,
          "kernel_refusal passes float16")
    rc = cli.main(["train", "--model", "lstm", "--html-file",
                   str(root / GOLDEN_HTML), "train.epochs=1",
                   "model.compute_dtype=float16"])
    print(f"train at a float16 compute dtype: exit {rc} (expected 17)")
    check(rc == 17, f"a float16 train on the card exited {rc}, not 17")
    return k1, k2, ckdir


def phase_step(root: Path) -> None:
    """One training step from the same parameters and batch on the card
    (K1+K2) and on the CPU (the plain versions through the Function)."""
    from euromillioner_tpu_torch.core.precision import PARITY
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    train_ds, _ = golden_windows(root)
    host_batch = next(iter(train_ds.batches(64)))
    results = {}
    params = None
    for device, fused in (("cpu", "on"), ("cuda", "auto")):
        model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused=fused,
                           in_features=FEATURES,
                           generator=torch.Generator().manual_seed(SEED + 3),
                           device=device)
        trainer = Trainer(model, adam(1e-3), precision=PARITY)
        state = trainer.init_state(params)
        params = state.params
        new, loss = trainer.train_step(state, trainer._place(host_batch))
        results[device] = (loss.cpu(), {k: v.cpu() for k, v in
                                        new.opt_state["mu"].items()},
                           {k: v.cpu() for k, v in new.params.items()})
    (loss_c, mu_c, p_c), (loss_g, mu_g, p_g) = results["cpu"], results["cuda"]
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    print(f"step: loss card {float(loss_g):.6f} cpu {float(loss_c):.6f} "
          f"rel {loss_err:.3e} (tol {STEP_LOSS_TOL:.0e})")
    check(loss_err <= STEP_LOSS_TOL, f"step loss differs by {loss_err:.3e}")
    worst_grad = worst_param = 0.0
    for k in mu_c:
        # after one adam step mu = (1 - b1) * grad exactly, on both sides
        _, grad_err = max_errors(mu_g[k], mu_c[k])
        param_err, _ = max_errors(p_g[k], p_c[k])
        print(f"step grad {k}: rel_to_scale {grad_err:.3e} (tol "
              f"{STEP_GRAD_TOL:.1e}); updated param max_abs {param_err:.3e} "
              f"(tol {STEP_PARAM_TOL:.0e})")
        worst_grad = max(worst_grad, grad_err)
        worst_param = max(worst_param, param_err)
    check(worst_grad <= STEP_GRAD_TOL,
          f"step gradients differ by {worst_grad:.3e}")
    check(worst_param <= STEP_PARAM_TOL,
          f"updated params differ by {worst_param:.3e}")

    # the same step's time on the card through K1+K2 and through the scan
    # (host clock around synchronised steps; a comparison, not a check)
    timed = {}
    for fused in ("auto", "off", "auto"):
        model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused=fused,
                           in_features=FEATURES,
                           generator=torch.Generator().manual_seed(SEED + 3),
                           device="cuda")
        trainer = Trainer(model, adam(1e-3), precision=PARITY)
        state = trainer.init_state(params)
        batch = trainer._place(host_batch)
        for _ in range(2):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_RUNS):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        timed.setdefault(fused, []).append(
            (time.perf_counter() - t0) * 1e3 / STEP_RUNS)
    print(f"step timing B=64 T={SEQ_LEN} H={HIDDEN} {LAYERS} layers f32: "
          f"kernels {statistics.median(timed['auto']):.4f} ms/step "
          f"(runs {', '.join(f'{t:.4f}' for t in timed['auto'])}), "
          f"plain scan {timed['off'][0]:.4f} ms/step")


def phase_serve_trained(ckdir: Path) -> int:
    """Serve the checkpoint the train phase wrote; returns K1's launches."""
    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD

    FUSED_LSTM_FWD.launches = 0
    summary = serve_cli(ckdir, "fused", TRAIN_SMOKE_REQUESTS)
    launches = FUSED_LSTM_FWD.launches
    got = torch.tensor(summary["predictions"])
    check(tuple(got.shape) == (TRAIN_SMOKE_REQUESTS, OUTPUTS),
          "trained-checkpoint reply shapes")
    check(bool(torch.isfinite(got).all()), "non-finite trained replies")
    check(launches > 0, "serving the trained checkpoint never launched K1")
    print(f"serve trained checkpoint: K1 launches {launches}")
    return launches


# -- phase 7e: the step scheduler's governance --------------------------------

# The trained flagship behind make_sequence_engine with each governance part
# on, in an f32 and a bf16 pool. bench.py's serve_preempt shape: 8 slots
# presaturated with 8 bulk sequences of 512 steps, then 32 interactive ones
# of 8-32 steps; serve_paged's: 2 pages of 4 rows, 32 sequences live, 85% of
# 16-32 steps and 15% of 96-128; the elastic pool 2 -> 32 under a flood of
# 64 such sequences; migration of a 512-step sequence in process and of a
# 4096-step one between two ``serve --scheduler continuous`` children.
GOVERN = {"slots": 8, "step_block": 8, "bulk": 8, "bulk_steps": 512,
          "interactive": 32, "interactive_steps": (8, 33), "live": 32,
          "pages": 2, "page_slots": 4, "flood": 64, "elastic": (2, 32),
          "shrink_bulk": 4, "migrate_steps": 512,
          "http_migrate_steps": 4096}
# the rows of the block program whose bits phase 7e compares (elastic
# resize changes the pool's rows, unless the block keeps them fixed)
GOVERN_ROWS = (2, 4, 8, 16, 32)


def wait_until(what: str, cond, timeout: float = HTTP_WAIT) -> None:
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"timed out: {what}")
        time.sleep(0.001)


def governance_traffic(seed: int, n: int, mix=None, steps=None) -> list:
    """``n`` sequences from numpy seed ``seed``: the paged mix (85% of
    16-32 steps, 15% of 96-128) or lengths drawn from ``steps``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if mix:
            lo, hi = (96, 129) if rng.random() < 0.15 else (16, 33)
        else:
            lo, hi = steps
        out.append(rng.normal(size=(int(rng.integers(lo, hi)),
                                    FEATURES)).astype(np.float32))
    return out


def governance_engine(backend, *overrides: str):
    """The step scheduler the serve CLI builds: make_sequence_engine over
    ``serve.scheduler=continuous`` and GOVERN's pool, plus ``overrides``."""
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.serve.continuous import make_sequence_engine

    cfg = apply_overrides(Config(), [
        "serve.scheduler=continuous", f"serve.max_slots={GOVERN['slots']}",
        f"serve.step_block={GOVERN['step_block']}", *overrides])
    return make_sequence_engine(backend, cfg)


def governance_served(eng, seqs, cls: str = "bulk") -> list:
    return [f.result(timeout=HTTP_WAIT)
            for f in [eng.submit(s, cls=cls) for s in seqs]]


def governance_replies(what: str, got, ref, direct, profile: str) -> None:
    """Every reply bit-equal to the uninterrupted run at the same block
    rows, and within the profile's tolerance of a direct apply (f32:
    F32_SERVE_TOL; bf16: its envelope)."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)

    same = sum(np.array_equal(g, r) for g, r in zip(got, ref))
    err = rel_error(torch.tensor(np.stack(got)), direct)
    tol = F32_SERVE_TOL if profile == "f32" else \
        SERVE_ENVELOPES[("lstm", profile)]
    print(f"govern {profile} {what}: {same}/{len(got)} replies bit-equal "
          f"to the uninterrupted run; rel to direct apply {err:.3e} (tol "
          f"{tol:.0e}) [{CARD}]")
    check(same == len(got), f"{profile} {what}: a reply moved")
    check(err <= tol, f"{profile} {what}: replies off the direct apply")


def governance_rows(backend, profile: str) -> None:
    """Whether the block program's replies depend on its row count on the
    card: a few sequences in every row, at each of GOVERN_ROWS, against
    the same at 32 rows. Why an elastic pool steps at max_slots rows."""
    import numpy as np

    seqs = governance_traffic(21, 8, steps=(8, 33))
    counts = []
    for rows in GOVERN_ROWS:
        differ = 0
        for s in seqs:
            x = torch.from_numpy(np.repeat(s[None], rows, 0)).cuda()
            reset = torch.ones((rows, 1), dtype=torch.bool, device="cuda")
            _, y = backend.block_fn(backend.init_states(rows), x, reset)
            x32 = torch.from_numpy(np.repeat(s[None], 32, 0)).cuda()
            _, y32 = backend.block_fn(
                backend.init_states(32), x32,
                torch.ones((32, 1), dtype=torch.bool, device="cuda"))
            differ += int(not torch.equal(y[0, -1], y32[0, -1]))
        counts.append(differ)
    print(f"govern {profile} rows: replies differing from 32 rows at "
          f"{list(GOVERN_ROWS)} rows: {counts} of {len(seqs)} [{CARD}]")


def governance_preempt(backend, profile: str, direct_of) -> dict:
    """Preempt-off, then preempt-on on the same presaturated traffic:
    the on run preempts and restores, completes every bulk sequence, sheds
    none, and replies bit-equal to the off run. Returns the traffic and
    the off run's replies (the uninterrupted ones at GOVERN's rows)."""
    bulk = governance_traffic(11, GOVERN["bulk"],
                              steps=(GOVERN["bulk_steps"],
                                     GOVERN["bulk_steps"] + 1))
    inter = governance_traffic(12, GOVERN["interactive"],
                               steps=GOVERN["interactive_steps"])
    runs = {}
    for name, extra in (("off", ()), ("on", ("serve.preempt.enabled=true",))):
        t0 = time.perf_counter()
        with governance_engine(backend, *extra) as eng:
            fb = [eng.submit(s, cls="bulk") for s in bulk]
            wait_until("presaturation", lambda: eng.stats()["active"]
                       == GOVERN["slots"] and eng.stats()["steps"] >= 2)
            fi = [eng.submit(s, cls="interactive") for s in inter]
            got = [f.result(timeout=HTTP_WAIT) for f in fi + fb]
            st = eng.stats()
        runs[name] = (got, st, time.perf_counter() - t0)
        print(f"govern {profile} preempt {name}: wall "
              f"{runs[name][2]:.3f} s, p50_step_ms {st['p50_step_ms']}, "
              f"p99_step_ms {st['p99_step_ms']}, preempt "
              f"{json.dumps(st['preempt'])}, interactive "
              f"{json.dumps(st['classes']['interactive'])} [{CARD}]")
    st = runs["on"][1]
    check(st["preempt"]["preempted"] >= 1, "no preemption")
    check(st["preempt"]["restored"] >= 1, "no restore")
    check(st["preempt"]["shed"] == 0 and st["failed"] == 0,
          "a sequence was shed or failed")
    check(st["sequences"] == len(bulk) + len(inter), "not all completed")
    governance_replies("preempt", runs["on"][0], runs["off"][0],
                       direct_of(inter + bulk), profile)
    return {"seqs": inter + bulk, "ref": runs["off"][0], "bulk": bulk,
            "inter": inter}


def governance_budget(backend, profile: str, traffic: dict, direct_of,
                      corrupt: bool, tmp: Path) -> None:
    """The preempt traffic under a RAM ledger of two victims' bytes and a
    spill directory: the victims past two spill, restore from disk and
    reply bit-equal; with ``corrupt``, one spill file flipped on purpose
    sheds its own sequence only, with a ServeError naming the file."""
    import tempfile

    from euromillioner_tpu_torch.serve.continuous import (PreemptPolicy,
                                                          StepScheduler)
    from euromillioner_tpu_torch.serve.session import BudgetPolicy
    from euromillioner_tpu_torch.utils.errors import ServeError

    t0 = time.perf_counter()
    spill = Path(tempfile.mkdtemp(prefix="spill-", dir=str(tmp)))
    per = 2 * LAYERS * HIDDEN * (4 if profile == "f32" else 2)
    budget = BudgetPolicy(enabled=True, ledger_bytes=2 * per,
                          spill_dir=str(spill), spill_bytes=1 << 30)
    # the test thread holds the dispatcher so the spill files exist, and
    # one can be corrupted, before any restore runs
    eng = StepScheduler(backend, max_slots=GOVERN["slots"],
                        step_block=GOVERN["step_block"],
                        preempt=PreemptPolicy(enabled=True),
                        budget=budget, start=False)
    try:
        check(eng._per_slot_state_bytes() == per, "state bytes per slot")
        fb = [eng.submit(s, cls="bulk") for s in traffic["bulk"]]
        with eng._cond:
            eng._admit_locked()
        for _ in range(2):
            eng._dispatch_step()
        fi = [eng.submit(s, cls="interactive") for s in traffic["inter"]]
        eng._preempt_for_queue()
        files = sorted(os.listdir(spill))
        check(len(files) == GOVERN["bulk"] - 2,
              f"{len(files)} spill files, not {GOVERN['bulk'] - 2}")
        if corrupt:
            raw = bytearray((spill / files[0]).read_bytes())
            raw[-10] ^= 0xFF
            (spill / files[0]).write_bytes(bytes(raw))
        eng.start()
        got, shed = [], []
        for i, f in enumerate(fi + fb):
            try:
                got.append(f.result(timeout=HTTP_WAIT))
            except ServeError as e:
                shed.append((i, str(e)))
                got.append(None)
        st = eng.stats()
    finally:
        eng.close()
    b = st["budget"]
    print(f"govern {profile} budget: wall {time.perf_counter() - t0:.3f} s, "
          f"state bytes per slot {per}, budget {json.dumps(b)}, "
          f"preempt {json.dumps(st['preempt'])} [{CARD}]")
    if corrupt:
        check(len(shed) == 1 and files[0] in shed[0][1]
              and "spill blob" in shed[0][1],
              f"the corrupted spill file shed {shed}")
        print(f"govern {profile} budget: corrupted {files[0]}: shed "
              f"{shed[0][1]}")
    else:
        check(not shed, f"sequences shed: {shed}")
    keep = [i for i, g in enumerate(got) if g is not None]
    governance_replies("budget", [got[i] for i in keep],
                       [traffic["ref"][i] for i in keep],
                       direct_of([traffic["seqs"][i] for i in keep]),
                       profile)
    check(b["spills"] >= 1 and b["spill_restored"] >= 1, "no spill tier")
    # restores admitted together read their spilled rows back before any
    # scatter frees RAM, so the RAM tier's peak may pass its budget by
    # those reads, in the JAX package as here: printed, not held
    print(f"govern {profile} budget: RAM tier peak {b['peak']['ram']} "
          f"bytes against its {2 * per}-byte budget")
    check(b["bytes"]["ram"] == b["bytes"]["disk"] == 0, "tiers not drained")
    check(not os.listdir(spill), "a spill file survived")
    shutil.rmtree(spill, ignore_errors=True)


def governance_paging(backend, profile: str, direct_of, tmp: Path) -> None:
    """The paged mix, 32 sequences live on 2 pages of 4 rows with a RAM
    ledger of four rows' bytes and a spill directory, against the dense
    pool on the same traffic: bit-equal, peak_live >= 4x the rows, every
    row back on the freelist, RAM and disk drained."""
    import tempfile

    seqs = governance_traffic(0, GOVERN["live"], mix=True)
    spill = tempfile.mkdtemp(prefix="pages-", dir=str(tmp))
    per = 2 * LAYERS * HIDDEN * (4 if profile == "f32" else 2)
    runs = {}
    for name, extra in (
            ("dense", ()),
            ("paged", ("serve.paging.enabled=true",
                       f"serve.paging.pages={GOVERN['pages']}",
                       f"serve.paging.page_slots={GOVERN['page_slots']}",
                       f"serve.paging.max_live={GOVERN['live']}",
                       "serve.budget.enabled=true",
                       f"serve.budget.ledger_bytes={4 * per}",
                       f"serve.budget.spill_dir={spill}"))):
        t0 = time.perf_counter()
        with governance_engine(backend, *extra) as eng:
            got = governance_served(eng, seqs)
            st = eng.stats()
        runs[name] = (got, st)
        print(f"govern {profile} {name}: wall "
              f"{time.perf_counter() - t0:.3f} s, p50_step_ms "
              f"{st['p50_step_ms']}, steps {st['steps']}, paging "
              f"{json.dumps(st['paging'])}, budget spills "
              f"{st['budget']['spills']} [{CARD}]")
    pg, b = runs["paged"][1]["paging"], runs["paged"][1]["budget"]
    check(pg["peak_live"] >= 4 * pg["rows"], "the live set never reached "
          "4x the rows")
    check(pg["free_rows"] == pg["rows"] and pg["live"] == 0, "rows leaked")
    check(pg["demoted"] > 0 and pg["promoted"] > 0 and pg["shed"] == 0,
          "no demote/promote round trip")
    check(b["bytes"]["ram"] == b["bytes"]["disk"] == 0, "tiers not drained")
    check(not os.listdir(spill), "a spill file survived")
    shutil.rmtree(spill, ignore_errors=True)
    governance_replies("paged", runs["paged"][0], runs["dense"][0],
                       direct_of(seqs), profile)


def governance_elastic(backend, profile: str, direct_of) -> None:
    """A 2 -> 32 pool: a flood grows it and drains, bit-equal to a fixed
    32-slot pool; then an explicit shrink under 4 mid-flight bulk
    sequences evicts and restores them, bit-equal too."""
    lo, hi = GOVERN["elastic"]
    flood = governance_traffic(31, GOVERN["flood"], mix=True)
    bulk = governance_traffic(32, GOVERN["shrink_bulk"],
                              steps=(GOVERN["bulk_steps"],
                                     GOVERN["bulk_steps"] + 1))
    t0 = time.perf_counter()
    with governance_engine(backend, f"serve.max_slots={hi}") as eng:
        fixed = governance_served(eng, flood + bulk)
    elastic = (f"serve.max_slots={hi}", "serve.preempt.elastic=true",
               f"serve.preempt.min_slots={lo}")
    with governance_engine(backend, *elastic, "serve.preempt.grow_load=0.9",
                           "serve.preempt.resize_hysteresis=1") as eng:
        check(eng.pool_slots == lo, "the elastic pool did not start small")
        futures = [eng.submit(s) for s in flood]
        peak = [lo]
        while not all(f.done() for f in futures):
            peak.append(eng.pool_slots)
            time.sleep(0.001)
        got = [f.result(timeout=HTTP_WAIT) for f in futures]
        st = eng.stats()
    print(f"govern {profile} elastic flood: wall "
          f"{time.perf_counter() - t0:.3f} s, pool peak {max(peak)}, "
          f"p50_step_ms {st['p50_step_ms']}, preempt "
          f"{json.dumps(st['preempt'])} [{CARD}]")
    check(st["preempt"]["resizes"] >= 2 and max(peak) > lo,
          "the flood never grew the pool")
    governance_replies("elastic flood", got, fixed[:len(flood)],
                       direct_of(flood), profile)
    t0 = time.perf_counter()
    with governance_engine(backend, *elastic, "serve.preempt.grow_load=99",
                           "serve.preempt.shrink_load=-1",
                           "serve.preempt.resize_hysteresis=1") as eng:
        eng.request_resize(hi)
        wait_until("grow", lambda: eng.pool_slots == hi)
        fb = [eng.submit(s, cls="bulk") for s in bulk]
        wait_until("bulk mid-flight", lambda: eng.stats()["active"]
                   == len(bulk) and eng.stats()["steps"] >= 2)
        eng.request_resize(lo)
        got = [f.result(timeout=HTTP_WAIT) for f in fb]
        st = eng.stats()
    print(f"govern {profile} elastic shrink: wall "
          f"{time.perf_counter() - t0:.3f} s, preempt "
          f"{json.dumps(st['preempt'])}, pool bytes "
          f"{st['budget']['bytes']['pool']} [{CARD}]")
    check(st["preempt"]["preempted"] >= 1
          and st["preempt"]["restored"] == st["preempt"]["preempted"],
          "the shrink did not evict and restore")
    governance_replies("elastic shrink", got, fixed[len(flood):],
                       direct_of(bulk), profile)


def governance_migrate(backend, profile: str, direct_of) -> None:
    """Export mid-flight from one scheduler, import into another, in
    process: the reply bit-equal to the unmigrated one."""
    from euromillioner_tpu_torch.serve.continuous import unpack_migration

    x = governance_traffic(41, 1, steps=(GOVERN["migrate_steps"],
                                         GOVERN["migrate_steps"] + 1))[0]
    t0 = time.perf_counter()
    with governance_engine(backend) as eng:
        ref = eng.predict(x)
    with governance_engine(backend) as src, governance_engine(backend) as dst:
        fut = src.submit(x, cls="bulk", tag="migrate-0")
        wait_until("mid-flight", lambda: src.stats()["steps"] >= 2)
        blob = src.export_sequence("migrate-0")
        check(blob is not None, "nothing exported")
        header, _x, state = unpack_migration(blob)
        check(header["pos"] > 0 and state is not None, "not mid-flight")
        check(fut.exception(timeout=HTTP_WAIT) is not None,
              "the source still served the exported sequence")
        got = dst.import_sequence(blob).result(timeout=HTTP_WAIT)
        loads = src.load_desc, dst.load_desc
    print(f"govern {profile} migrate: wall {time.perf_counter() - t0:.3f} s,"
          f" blob {len(blob)} bytes at pos {header['pos']} of "
          f"{header['steps']}, pool_dtype {header['pool_dtype']}; "
          f"migrations {loads[0]['migrations']} out, "
          f"{loads[1]['migrations']} in [{CARD}]")
    governance_replies("migrate", [got], [ref], direct_of([x]), profile)


def governance_http_migrate(root: Path, ckdir: Path, backend,
                            direct_of) -> dict:
    """The same move through two ``serve --scheduler continuous``
    children: ``/predict`` with a tag on one, ``/admin/export`` of that
    tag mid-flight, ``/admin/migrate`` of the blob on the other; the
    first reply is the 400 naming the move, the second bit-equal to the
    unmigrated run. Returns the children's kernel launches."""
    import base64
    import signal

    import numpy as np

    from euromillioner_tpu_torch.serve.continuous import unpack_migration

    x = governance_traffic(42, 1, steps=(GOVERN["http_migrate_steps"],
                                         GOVERN["http_migrate_steps"] + 1))[0]
    t0 = time.perf_counter()
    with governance_engine(backend) as eng:
        ref = eng.predict(x)
    procs, urls, logs = [], [], []
    try:
        for name in ("source", "destination"):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            log = root / "build" / "chip_smoke" / f"migrate_{name}.log"
            logs.append(log)
            urls.append(f"http://127.0.0.1:{port}")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "euromillioner_tpu_torch", "serve",
                 "--model-type", "lstm", "--checkpoint", str(ckdir),
                 "--scheduler", "continuous", f"serve.port={port}",
                 f"serve.max_slots={GOVERN['slots']}",
                 f"serve.step_block={GOVERN['step_block']}",
                 "model.compute_dtype=float32"],
                cwd=root, stdout=open(log, "w"), stderr=subprocess.STDOUT))
        for proc, url, log in zip(procs, urls, logs):
            def up(url=url):
                try:
                    return http_call(url, "/healthz")[0] == 200
                except OSError:
                    check(proc.poll() is None, f"serve died: "
                          f"{log.read_text()[-2000:]}")
                    return False
            wait_until("a migration child's /healthz", up)
        src, dst = urls
        with ThreadPoolExecutor(1) as pool:
            first = pool.submit(http_call, src, "/predict", {
                "rows": x.tolist(), "class": "bulk", "tag": "http-0"})
            wait_until("mid-flight", lambda: http_call(
                src, "/stats")[1]["steps"] >= 2)
            status, body = http_call(src, "/admin/export",
                                     {"target": "http-0"})
            check(status == 200 and body["blob"], f"/admin/export {status}")
            blob = base64.b64decode(body["blob"])
            header = unpack_migration(blob)[0]
            check(header["pos"] > 0, "the HTTP export was not mid-flight")
            status, moved = http_call(dst, "/admin/migrate",
                                      {"blob": body["blob"]})
            check(status == 200 and moved["migrated"],
                  f"/admin/migrate {status}: {moved}")
            f_status, f_body = first.result(timeout=HTTP_WAIT)
        check(f_status == 400 and "migrated off" in f_body["error"],
              f"the source's /predict answered {f_status} {f_body}")
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        rcs = [proc.wait(timeout=HTTP_WAIT) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=HTTP_WAIT)
    check(rcs == [0, 0], f"migration children exited {rcs}")
    launches = {}
    for log in logs:
        line = next(ln for ln in log.read_text().splitlines()
                    if "kernel launches: " in ln)
        for k, v in json.loads(line.split("kernel launches: ", 1)[1]).items():
            launches[k] = launches.get(k, 0) + v
    got = np.asarray(moved["predictions"], np.float32)
    print(f"govern f32 http migrate: wall {time.perf_counter() - t0:.3f} s, "
          f"{GOVERN['http_migrate_steps']} steps, exported at pos "
          f"{header['pos']}, blob {len(blob)} bytes; children's kernel "
          f"launches {json.dumps(launches)} [{CARD}]")
    governance_replies("http migrate", [got], [ref], direct_of([x]), "f32")
    return launches


def phase_governance(root: Path, ckdir: Path) -> None:
    """Phase 7e: the trained flagship behind make_sequence_engine with
    preemption, the budget and its spill tier, paging, the elastic pool
    and migration, in an f32 and a bf16 pool; every reply bit-equal to
    the same sequence served uninterrupted at the same block rows and
    within tolerance of a direct apply; no kernel launched (the step
    scheduler scans)."""
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.serve.continuous import load_recurrent_backend

    t_phase = time.perf_counter()
    tmp = root / "build" / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    reset_lstm_counts()
    for profile in ("f32", "bf16"):
        cfg = apply_overrides(Config(), ["model.compute_dtype=float32",
                                         f"serve.precision={profile}"])
        backend = load_recurrent_backend(cfg, str(ckdir))
        model = backend.model
        direct_of = lambda seqs: direct_apply(model, seqs)  # noqa: E731
        governance_rows(backend, profile)
        traffic = governance_preempt(backend, profile, direct_of)
        governance_budget(backend, profile, traffic, direct_of,
                          corrupt=profile == "f32", tmp=tmp)
        governance_paging(backend, profile, direct_of, tmp)
        governance_elastic(backend, profile, direct_of)
        governance_migrate(backend, profile, direct_of)
        if profile == "f32":
            launches = governance_http_migrate(root, ckdir, backend,
                                               direct_of)
    counts = lstm_counts()
    print(f"govern: kernel launches in process {json.dumps(counts)}; wall "
          f"{time.perf_counter() - t_phase:.3f} s [{CARD}]")
    check(not any(counts.values()) and not any(launches.values()),
          "a governance part launched a kernel (its blocks scan)")


# -- phases 7f-7j: resilience and observability ------------------------------

# The replay cells: the port's seeded generators at their default rates and
# shapes, replayed open-loop at speed 1.0 against the trained flagship behind
# the step scheduler (32 slots, ladder 2/8/32, classes interactive,bulk,
# serve.obs.slo_ms=50,2000) and behind the batch scheduler's fused profile
# (K1). The batch scheduler runs at one row bucket and one time bucket (the
# generators' sequences are 2-48 steps), so every program has one shape and
# a reply does not depend on which requests shared its micro-batch.
REPLAY_TRACES = ("poisson_burst", "flash_crowd")
REPLAY_STEP = ["serve.scheduler=continuous", "serve.max_slots=32",
               "serve.step_blocks=2,8,32", "serve.classes=interactive,bulk",
               "serve.obs.slo_ms=50,2000"]
REPLAY_BATCH = ["serve.scheduler=batch", "serve.buckets=32",
                "serve.seq_buckets=64", "serve.classes=interactive,bulk",
                "serve.obs.slo_ms=50,2000"]
# the chaos run: the flagship at the CLI's defaults (bf16) for 3 epochs on
# the golden page (cut from the default 20), B=64, a checkpoint an epoch
CHAOS_EPOCHS = 3
CHAOS_URL = "http://127.0.0.1:9/results"  # never reached: fetch faults first


def http_text(url: str, path: str) -> tuple[int, str, str]:
    """GET ``path``: status, Content-Type and the body as text."""
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=HTTP_WAIT) as reply:
        return (reply.status, reply.headers["Content-Type"],
                reply.read().decode())


def replay_engine(backend, overrides: list[str], obs: bool):
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.serve.continuous import make_sequence_engine

    cfg = apply_overrides(Config(), [*overrides,
                                     f"serve.obs.enabled={str(obs).lower()}"])
    return make_sequence_engine(backend, cfg)


def span_breakdown(spans: list[dict]) -> str:
    """Mean ms from each span's admit stamp to each later stage."""
    sums: dict = {}
    for span in spans:
        for stage, ms in span["stages"].items():
            sums.setdefault(stage, []).append(ms)
    return ", ".join(f"{s} {statistics.mean(v):.3f}" for s, v in
                     sums.items())


def phase_replay(ckdir: Path) -> int:
    """Phase 7f: REPLAY_TRACES replayed open-loop at speed 1.0 against the
    trained f32 flagship behind the step scheduler and the batch
    scheduler's fused profile, each with telemetry on and then off: every
    reply bit-equal between the two runs and within F32_SERVE_TOL of a
    direct apply, no event failed; per-class attainment, clock lag,
    requests/s and K1 launches printed, and the spans' mean stage offsets
    of the telemetry-on step run. Returns K1's launches in the runs."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.core.precision import rel_error
    from euromillioner_tpu_torch.obs.replay import payload_for, replay_trace
    from euromillioner_tpu_torch.obs.workload import generate
    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD
    from euromillioner_tpu_torch.serve.continuous import load_recurrent_backend

    t_phase = time.perf_counter()
    backends = {}
    for name, prec in (("step", "f32"), ("batch_fused", "fused")):
        cfg = apply_overrides(Config(), ["model.compute_dtype=float32",
                                         f"serve.precision={prec}"])
        backends[name] = load_recurrent_backend(cfg, str(ckdir))
    model = backends["step"].model
    k1 = 0
    for trace_name in REPLAY_TRACES:
        trace = generate(trace_name, seed=0)
        for name, overrides in (("step", REPLAY_STEP),
                                ("batch_fused", REPLAY_BATCH)):
            runs = {}
            for obs in (True, False):
                eng = replay_engine(backends[name], overrides, obs)
                try:
                    seqs = [payload_for(ev, eng) for ev in trace.events]
                    FUSED_LSTM_FWD.launches = 0
                    rep = replay_trace(eng, trace, speed=1.0, collect=True,
                                       timeout_s=HTTP_WAIT)
                    launches = FUSED_LSTM_FWD.launches
                    spans = eng.telemetry.trace.last(512)
                finally:
                    eng.close()
                k1 += launches
                runs[obs] = rep
                rps = rep["completed"] / rep["wall_s"]
                slo = {c: v["attainment"] for c, v
                       in rep["engines"]["lstm"]["slo"].items()}
                card(f"replay {trace_name} {name} telemetry "
                     f"{'on' if obs else 'off'}: {rep['events']} events, "
                     f"completed {rep['completed']}, failed "
                     f"{rep['errors']}, {rps:.2f} requests/s over "
                     f"{rep['wall_s']} s; lag p50 "
                     f"{rep['clock']['lag_p50_ms']} ms p99 "
                     f"{rep['clock']['lag_p99_ms']} ms; attainment "
                     f"{json.dumps(slo)}; classes "
                     f"{json.dumps(rep['classes'])}; K1 launches "
                     f"{launches}")
                check(rep["errors"] == 0
                      and rep["completed"] == rep["events"],
                      f"replay {trace_name} {name}: events failed")
                if obs and name == "step":
                    card(f"replay {trace_name} step spans ({len(spans)}): "
                         f"mean ms from admit: {span_breakdown(spans)}")
                if name == "batch_fused":
                    check(launches > 0, f"replay {trace_name}: the fused "
                          f"profile never launched K1")
            on, off = runs[True]["outputs"], runs[False]["outputs"]
            same = sum(np.array_equal(a, b) for a, b in zip(on, off))
            got = torch.tensor(np.stack(on))
            err = rel_error(got, direct_apply(model, seqs))
            card(f"replay {trace_name} {name}: {same}/{len(on)} replies "
                 f"bit-equal telemetry on/off; rel to direct apply "
                 f"{err:.3e} (tol {F32_SERVE_TOL:.0e}); requests/s on/off "
                 f"{runs[True]['completed'] / runs[True]['wall_s']:.2f} / "
                 f"{runs[False]['completed'] / runs[False]['wall_s']:.2f}")
            check(same == len(on), f"replay {trace_name} {name}: telemetry "
                  f"moved a reply")
            check(err <= F32_SERVE_TOL, f"replay {trace_name} {name}: "
                  f"replies off the direct apply")
    card(f"replay: wall {time.perf_counter() - t_phase:.3f} s")
    return k1


def phase_obs_http(root: Path, ckdir: Path) -> None:
    """Phase 7g: a ``serve --scheduler continuous`` child of the trained
    checkpoint, phase 4a's traffic over HTTP, then /metrics (its request
    and completion counters equal /stats and the requests sent),
    /trace?n=16 (16 complete spans, stages in order, offsets monotonic)
    and ``obs-top --url <child> --once`` (one summary line)."""
    import signal

    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.obs.top import parse_prometheus
    from euromillioner_tpu_torch.obs.trace import STAGES

    port = free_port()
    url = f"http://127.0.0.1:{port}"
    log = root / "build" / "chip_smoke" / "http_obs.log"
    argv = [sys.executable, "-m", "euromillioner_tpu_torch", "serve",
            "--model-type", "lstm", "--checkpoint", str(ckdir),
            "--scheduler", "continuous", f"serve.port={port}",
            "model.compute_dtype=float32", "serve.max_slots=32",
            "serve.step_blocks=2,8,32", "serve.obs.slo_ms=50,2000"]
    seqs = http_traffic()
    t_start = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen(argv, cwd=root, stdout=fh,
                                stderr=subprocess.STDOUT)
        try:
            while True:
                try:
                    http_call(url, "/healthz")
                    break
                except OSError:
                    check(proc.poll() is None and time.perf_counter()
                          - t_start < HTTP_WAIT, f"obs child never "
                          f"answered: {log.read_text()[-2000:]}")
                    time.sleep(0.2)
            p = http_pass(url, seqs, lambda i: None)
            check(all(r is not None for r in p["replies"]),
                  "obs http: requests failed")
            status, ctype, text = http_text(url, "/metrics")
            _, stats = http_call(url, "/stats")
            _, trace = http_call(url, "/trace?n=16")
            _, health = http_call(url, "/healthz")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["obs-top", "--url", url, "--once"])
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=HTTP_WAIT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=HTTP_WAIT)
    fams = parse_prometheus(text)

    def total(name: str) -> float:
        return sum(v for _l, v in fams.get(name, ()))

    req, done = (total("serve_requests_total"),
                 total("serve_requests_completed_total"))
    print(f"obs http: /metrics {status} {ctype}, {len(fams)} sample "
          f"names; serve_requests_total {req:.0f}, completed {done:.0f}, "
          f"/stats sequences {stats['sequences']}, sent {len(seqs)}; "
          f"/healthz attainment {json.dumps(health.get('attainment'))}")
    card(f"obs http: {p['rps']:.2f} requests/s, client p50 "
         f"{p['p50_ms']:.3f} ms, p99 {p['p99_ms']:.3f} ms")
    check(status == 200 and ctype.startswith("text/plain; version=0.0.4"),
          "obs http: /metrics status or type")
    check(req == done == stats["sequences"] == len(seqs),
          "obs http: /metrics counters disagree with /stats")
    spans = trace["spans"]
    check(len(spans) == 16, f"obs http: /trace gave {len(spans)} spans")
    for span in spans:
        names = list(span["stages"])
        offsets = list(span["stages"].values())
        check(names[-1] == "reply" and names == [s for s in STAGES
                                                 if s in names]
              and offsets == sorted(offsets),
              f"obs http: span {span['trace_id']} incomplete or "
              f"not monotonic: {span}")
    card(f"obs http: /trace?n=16 mean ms from admit: "
         f"{span_breakdown(spans)}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    print(f"obs http: obs-top --url --once: exit {rc}: {lines}")
    check(rc == 0 and len(lines) == 1 and "rps=" in lines[0],
          "obs http: obs-top did not print one summary line")


def chaos_trainer():
    """The flagship trainer ``cli train --model lstm`` builds at the CLI's
    defaults (bf16 compute, Adam), from the seeded weights."""
    from euromillioner_tpu_torch.config import Config
    from euromillioner_tpu_torch.core.precision import from_names
    from euromillioner_tpu_torch.models.registry import build_model
    from euromillioner_tpu_torch.train.optim import from_train_config
    from euromillioner_tpu_torch.train.trainer import Trainer

    cfg = Config()
    cfg.model.name = "lstm"
    model = build_model(cfg.model, in_features=FEATURES,
                        generator=torch.Generator().manual_seed(
                            cfg.train.seed), device="cuda")
    return cfg, Trainer(model, from_train_config(cfg.train), loss="mse",
                        precision=from_names(cfg.model.param_dtype,
                                             cfg.model.compute_dtype))


def chaos_windows(tr, va):
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.models.lstm import make_sequences

    return tuple(Dataset(*make_sequences(ds.full_rows(), SEQ_LEN))
                 for ds in (tr, va))


def chaos_fit(tr, ckdir: Path, resume: bool):
    """One attempt: restore the newest intact checkpoint when asked, then
    fit to CHAOS_EPOCHS with a checkpoint an epoch."""
    from euromillioner_tpu_torch.train.checkpoint import (checkpoint_step,
                                                          latest_checkpoint,
                                                          load_train_state)

    cfg, trainer = chaos_trainer()
    state = trainer.init_state()
    start = 0
    ck = latest_checkpoint(str(ckdir)) if resume else None
    if ck is not None:
        state = load_train_state(ck, state)
        start = checkpoint_step(ck)
    state = trainer.fit(state, tr, epochs=CHAOS_EPOCHS,
                        batch_size=cfg.data.batch_size, seed=cfg.train.seed,
                        shuffle=cfg.data.shuffle, checkpoint_dir=str(ckdir),
                        checkpoint_every=1, start_epoch=start)
    return trainer, state


def phase_chaos_train(root: Path) -> dict:
    """Phase 7h: the flagship at the CLI's defaults (bf16 K1/K2) for
    CHAOS_EPOCHS epochs, fault-free and then faulted — its data through
    pipeline_from_url from a localhost URL never reached (a fetch.request
    storm served from the stale cache), the second checkpoint truncated
    after its rename, a train.step crash mid-epoch 2 restarted by the
    supervisor: final eval metrics and parameters bitwise equal. Returns
    the bf16 K1/K2 launches of both runs."""
    import glob as globmod

    import numpy as np

    from euromillioner_tpu_torch.config import DataConfig
    from euromillioner_tpu_torch.data.pipeline import (draws_from_html,
                                                       pipeline_from_html,
                                                       pipeline_from_url,
                                                       write_cache)
    from euromillioner_tpu_torch.dist.failure import run_with_restart
    from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
    from euromillioner_tpu_torch.utils.errors import FetchError, TrainError
    from euromillioner_tpu_torch.utils.retry import RetryPolicy

    t_phase = time.perf_counter()
    out = root / "build" / "chip_smoke" / "chaos"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    html = (root / GOLDEN_HTML).read_text()
    cfg = DataConfig(url=CHAOS_URL)
    cache = out / "draws.csv"
    write_cache(str(cache), draws_from_html(html, cfg))
    fast = RetryPolicy(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0,
                       pre_jitter_s=0.0)

    def truncate(ctx) -> None:
        (path,) = globmod.glob(os.path.join(ctx["path"], "arrays-*.emt"))
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) // 2)

    reset_lstm_counts()
    tr, va = chaos_windows(*pipeline_from_html(html, cfg))
    ref_trainer, ref = chaos_fit(tr, out / "ref", resume=False)
    ref_counts = lstm_counts()
    steps = -(-len(tr) // DataConfig().batch_size)
    plan = FaultPlan([
        FaultSpec("fetch.request",
                  raises=lambda: FetchError("injected 503", status=503)),
        FaultSpec("checkpoint.save.post", hits=(2,), action=truncate),
        FaultSpec("train.step", hits=(2 * steps + 2,),
                  raises=lambda: TrainError("injected mid-epoch crash"))])
    reset_lstm_counts()
    with inject(plan):
        ftr, fva = chaos_windows(*pipeline_from_url(
            cfg, cache_path=str(cache), policy=fast))
        trainer, state = run_with_restart(
            lambda n: chaos_fit(ftr, out / "chaos", resume=n > 0),
            max_restarts=2, backoff_s=0.0)
    counts = lstm_counts()
    fired = {p: plan.fired_count(p) for p in ("fetch.request",
                                              "checkpoint.save.post",
                                              "train.step")}
    got = {w: trainer.evaluate(state.params, ds)["rmse"]
           for w, ds in (("train", ftr), ("test", fva))}
    want = {w: ref_trainer.evaluate(ref.params, ds)["rmse"]
            for w, ds in (("train", tr), ("test", va))}
    same = [k for k, v in ref.params.items()
            if torch.equal(state.params[k], v)]
    print(f"chaos train: {len(tr)} windows, {steps} steps/epoch, "
          f"{CHAOS_EPOCHS} epochs; faults fired {json.dumps(fired)}; final "
          f"rmse faulted {json.dumps(got)} fault-free {json.dumps(want)}; "
          f"{len(same)}/{len(ref.params)} params bitwise equal; launches "
          f"fault-free {json.dumps(ref_counts)} faulted "
          f"{json.dumps(counts)}")
    card(f"chaos train: wall {time.perf_counter() - t_phase:.3f} s")
    check(fired == {"fetch.request": 3, "checkpoint.save.post": 1,
                    "train.step": 1}, "chaos train: a fault did not fire")
    check(np.array_equal(ftr.x, tr.x), "chaos train: the stale cache "
          "served other data")
    check(got == want, "chaos train: eval metrics differ")
    check(len(same) == len(ref.params), "chaos train: params differ")
    check(ref_counts["K1.bf16"] > 0 and ref_counts["K2.bf16"] > 0
          and counts["K2.bf16"] > ref_counts["K2.bf16"],
          "chaos train: the bf16 kernels did not carry the runs")
    shutil.rmtree(out, ignore_errors=True)
    return {k: ref_counts[k] + counts[k] for k in ("K1.bf16", "K2.bf16")}


def phase_quant_fallback(root: Path, ckdir: Path) -> None:
    """Phase 7i: a plan firing serve.quant at the bf16, fused and int8w
    sequence tiers' restore and at the row engine's bf16 child: each falls
    back to f32 and replies bit-equal to the f32 profile, and the fired
    counter is in /metrics."""
    import threading

    import numpy as np

    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.models.mlp import build_mlp
    from euromillioner_tpu_torch.obs.top import parse_prometheus
    from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
    from euromillioner_tpu_torch.serve.continuous import (
        load_recurrent_backend, make_sequence_engine)
    from euromillioner_tpu_torch.serve.engine import InferenceEngine
    from euromillioner_tpu_torch.serve.session import NNBackend
    from euromillioner_tpu_torch.serve.transport import make_server

    seqs = governance_traffic(31, 16, steps=(8, 65))

    def served(prec: str, plan=None):
        cfg = apply_overrides(Config(), ["model.compute_dtype=float32",
                                         f"serve.precision={prec}",
                                         *REPLAY_STEP])
        with (inject(plan) if plan else contextlib.nullcontext()):
            backend = load_recurrent_backend(cfg, str(ckdir))
        eng = make_sequence_engine(backend, cfg)
        try:
            return backend, governance_served(eng, seqs)
        finally:
            eng.close()

    _, want = served("f32")
    for prec in ("bf16", "fused", "int8w"):
        plan = FaultPlan([FaultSpec("serve.quant", raises=RuntimeError,
                                    hits=(1,))])
        backend, got = served(prec, plan)
        same = sum(np.array_equal(g, w) for g, w in zip(got, want))
        print(f"serve.quant {prec}: fired {plan.fired_count('serve.quant')}"
              f", served as {backend.precision}; {same}/{len(got)} replies "
              f"bit-equal to the f32 profile")
        check(plan.fired_count("serve.quant") == 1
              and backend.precision == "f32" and same == len(got),
              f"serve.quant {prec}: no f32 fallback")
    model = build_mlp((256, 256), 1, in_features=10,
                      generator=torch.Generator().manual_seed(SEED),
                      device="cuda")
    plan = FaultPlan([FaultSpec("serve.quant", raises=RuntimeError,
                                hits=(1,))])
    with inject(plan):
        backend = NNBackend(model, (10,), profiles=("bf16",))
    rows = np.random.default_rng(5).normal(size=(32, 10)).astype(np.float32)
    eng = InferenceEngine(backend, profiles=("bf16",))
    server = make_server(eng, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        f32 = eng.predict(rows)
        bf16 = eng.predict(rows, profile="bf16")
        _, _, text = http_text(f"http://127.0.0.1:"
                               f"{server.server_address[1]}", "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        eng.close()
    fired = {lab.get("point"): v for lab, v in parse_prometheus(text).get(
        "resilience_faults_fired_total", ())}
    print(f"serve.quant row bf16 child: fallbacks "
          f"{sorted(backend.fallbacks)}; replies bit-equal to f32 "
          f"{np.array_equal(f32, bf16)}; /metrics fired counter "
          f"{json.dumps(fired)}")
    check(backend.fallbacks == {"bf16"} and np.array_equal(f32, bf16),
          "serve.quant row bf16 child: no f32 fallback")
    check(fired.get("serve.quant", 0) >= 4,
          "serve.quant: the fired counter is not in /metrics")


def phase_profile_dir(root: Path) -> None:
    """Phase 7j: one bf16 training epoch of the flagship with
    ``Trainer.fit(profile_dir=...)``: the torch.profiler trace it writes
    names the bf16 K1 and K2 kernels."""
    from euromillioner_tpu_torch.data.pipeline import pipeline_from_html
    from euromillioner_tpu_torch.utils.profiling import TRACE_FILE

    out = root / "build" / "chip_smoke" / "profile"
    shutil.rmtree(out, ignore_errors=True)
    tr, _ = chaos_windows(*pipeline_from_html(
        (root / GOLDEN_HTML).read_text()))
    cfg, trainer = chaos_trainer()
    reset_lstm_counts()
    trainer.fit(trainer.init_state(), tr, epochs=1,
                batch_size=cfg.data.batch_size, shuffle=False,
                profile_dir=str(out))
    counts = lstm_counts()
    events = json.loads((out / TRACE_FILE).read_text())
    events = events.get("traceEvents", events)
    names = {e.get("name", "") for e in events
             if e.get("cat") in ("kernel", "Kernel")}
    ours = sorted(n for n in names if "lstm_" in n or "dwh_" in n)
    print(f"profile_dir: {len(events)} trace events, {len(names)} kernel "
          f"names; ours: {ours}; launches {json.dumps(counts)}")
    k1 = any("lstm_fwd_kernel" in n and "bfloat16" in n for n in ours)
    k2 = any("lstm_bwd_kernel" in n and "bfloat16" in n for n in ours)
    check(counts["K1.bf16"] > 0 and counts["K2.bf16"] > 0,
          "profile_dir: the epoch did not launch bf16 K1/K2")
    check(k1 and k2, "profile_dir: the trace does not name bf16 K1 and K2")
    shutil.rmtree(out, ignore_errors=True)


# -- the GBT path (K3) ----------------------------------------------------------

def bf16_inputs(batch: int, steps: int):
    """bf16 K1/K2 inputs at one shape: the flagship layer's x_proj and wh
    in bf16 (peep f32), K1's bf16 residuals and a seeded bf16 g_hs."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    x_proj, wh, peep = k1_inputs(batch, steps, True)
    x_proj = x_proj.to(torch.bfloat16)
    wh = wh.to(torch.bfloat16)
    residuals = K.lstm_forward(x_proj, wh, peep, True)
    gen = torch.Generator().manual_seed(SEED + 7 * batch + steps)
    g_hs = torch.randn((steps, batch, HIDDEN), generator=gen).cuda().to(
        torch.bfloat16)
    return x_proj, wh, peep, residuals, g_hs


def bf16_bounds(batch: int, steps: int) -> dict:
    """The least time the card could take for bf16 K1 (residuals written)
    and K2 at one shape: bf16 elements read and written once, peep and
    dpeep in f32, the products at the bf16 tensor-core rate."""
    tbh = steps * batch * HIDDEN
    wh = HIDDEN * 4 * HIDDEN
    out = {}
    for name, nbytes, flops in (
            # x_proj in; hs, cs, gates out
            ("K1", 2 * (4 * tbh + wh + tbh + tbh + 4 * tbh) + 4 * 4 * HIDDEN,
             2 * steps * batch * HIDDEN * 4 * HIDDEN),
            # g_hs, hs, cs, gates in; dxp, dwh out; the dh carry and dwh
            ("K2", 2 * (3 * tbh + 4 * tbh + wh + 4 * tbh + wh)
             + 2 * 4 * 4 * HIDDEN,
             2 * 2 * (steps - 1) * batch * HIDDEN * 4 * HIDDEN)):
        bytes_ms = nbytes / PEAK_HBM_BYTES_S * 1e3
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        out[name] = (max(bytes_ms, ops_ms),
                     "bytes" if bytes_ms > ops_ms else "operations",
                     nbytes, flops)
    return out


def phase_bf16_kernels() -> tuple[dict, dict]:
    """bf16 K1 and K2 against their plain versions on the card at
    BF16_SHAPES (three reruns bit-identical), then their median times
    beside the f32 kernels' at the same shapes, the plain versions' and
    the bounds."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    worst = {"K1": 0.0, "K2": 0.0}
    failures = []
    for batch, steps in BF16_SHAPES:
        x_proj, wh, peep, res, g_hs = bf16_inputs(batch, steps)
        ref = K.lstm_sequence_reference(x_proj, wh, peep, True)
        ref_b = K.lstm_backward_reference(wh, peep, ref, g_hs, True)
        torch.cuda.synchronize()
        runs = [(K.lstm_forward(x_proj, wh, peep, True),
                 K.lstm_backward(wh, peep, ref, g_hs, True),
                 K.lstm_sequence(x_proj, wh, peep, True))
                for _ in range(3)]
        torch.cuda.synchronize()
        (fwd, bwd, hs_only) = runs[0]
        checks = [("K1", n, fwd[i], ref[i], [r[0][i] for r in runs])
                  for i, n in enumerate(("hs", "cs", "gates"))]
        checks.append(("K1", "hs(no residuals)", hs_only, ref[0],
                       [r[2] for r in runs]))
        checks += [("K2", n, bwd[i], ref_b[i], [r[1][i] for r in runs])
                   for i, n in enumerate(("dxp", "dwh", "dpeep"))]
        for kern, name, got, want, reruns in checks:
            abs_err, rel_err = max_errors(got, want)
            same = all(torch.equal(reruns[0], r) for r in reruns[1:])
            print(f"{kern} bf16 B={batch} T={steps} H={HIDDEN} {name} "
                  f"({got.dtype}): max_abs={abs_err:.3e} "
                  f"rel_to_scale={rel_err:.3e} (tol {BF16_KERNEL_TOL:.2e}), "
                  f"3 runs bit-identical {same}")
            if rel_err > BF16_KERNEL_TOL or not same:
                failures.append(f"{kern} bf16 {name} at B={batch}: rel "
                                f"{rel_err:.3e}, reruns equal {same}")
            worst[kern] = max(worst[kern], abs_err)
        check(fwd[0].dtype == torch.bfloat16 and bwd[0].dtype == torch.bfloat16
              and bwd[1].dtype == torch.bfloat16
              and bwd[2].dtype == torch.float32, "bf16 output dtypes")
        del x_proj, wh, res, g_hs, ref, ref_b, runs, fwd, bwd, hs_only
        torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))

    timed, plans = {}, {}
    for batch, steps in BF16_TIMED:
        plans[batch, steps] = {
            "K1": lstm_plan_line("K1 bf16", torch.bfloat16, batch, steps,
                                 False),
            "K2": lstm_plan_line("K2 bf16", torch.bfloat16, batch, steps,
                                 True),
            "K1.f32": lstm_plan_line("K1 f32", torch.float32, batch, steps,
                                     False),
            "K2.f32": lstm_plan_line("K2 f32", torch.float32, batch, steps,
                                     True)}
        x_proj, wh, peep, res, g_hs = bf16_inputs(batch, steps)
        x32, wh32 = x_proj.float(), wh.float()
        res32 = K.lstm_forward(x32, wh32, peep, True)
        g32 = g_hs.float()
        runs = 10 if batch > 64 else 20
        t = {"K1": time_ms(lambda: K.lstm_forward(x_proj, wh, peep, True),
                           runs=runs),
             "K1.f32": time_ms(lambda: K.lstm_forward(x32, wh32, peep, True),
                               runs=runs),
             "K1.plain": time_ms(lambda: K.lstm_sequence_reference(
                 x_proj, wh, peep, True), runs=runs),
             "K2": time_ms(lambda: K.lstm_backward(wh, peep, res, g_hs,
                                                   True), runs=runs),
             "K2.f32": time_ms(lambda: K.lstm_backward(wh32, peep, res32,
                                                       g32, True), runs=runs),
             "K2.plain": time_ms(lambda: K.lstm_backward_reference(
                 wh, peep, res, g_hs, True), runs=runs)}
        for name, ms in k2_parts_ms(wh, peep, res, g_hs, runs).items():
            t[f"K2.{name}"] = ms
        # dwh's yardstick: one PyTorch call, h_prev^T . dxp over the same
        # (T-1)*B rows in bf16 (cuBLAS, f32 sums), timed and used nowhere
        dxp = K.lstm_backward(wh, peep, res, g_hs, True)[0]
        h_prev = res[0][:-1].reshape(-1, HIDDEN)
        d_rows = dxp[1:].reshape(-1, 4 * HIDDEN)
        t["dwh.library"] = time_ms(lambda: torch.matmul(h_prev.T, d_rows),
                                   runs=runs)
        bounds = bf16_bounds(batch, steps)
        for kern in ("K1", "K2"):
            bound, by, nbytes, flops = bounds[kern]
            key = f"{kern} {{}}{'residuals ' if kern == 'K1' else ''}" \
                  f"B={batch} T={steps}"
            print(f"{kern} bf16 timing B={batch} T={steps} H={HIDDEN}: kernel "
                  f"{t[kern]:.4f} ms, f32 kernel {t[kern + '.f32']:.4f} ms, "
                  f"plain {t[kern + '.plain']:.4f} ms, bound {bound:.4f} ms "
                  f"by {by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB);"
                  f" bf16 {earlier(key.format('bf16 '), t[kern])}; f32 "
                  f"{earlier(key.format('f32 '), t[kern + '.f32'])}")
        # dwh alone: 2 (T-1) B H 4H FLOPs on the tensor cores, hs and dxp's
        # rows read once, dwh written once
        r = (steps - 1) * batch
        dwh_bound = max(2 * r * HIDDEN * 4 * HIDDEN / PEAK_BF16_FLOPS,
                        2 * (r * 5 * HIDDEN + 4 * HIDDEN * HIDDEN)
                        / PEAK_HBM_BYTES_S) * 1e3
        print(f"K2 bf16 parts B={batch} T={steps}: recurrence "
              f"{t['K2.recurrence']:.4f} ms, dwh {t['K2.dwh']:.4f} ms "
              f"(bound {dwh_bound:.4f} ms), torch.matmul(h_prev^T, dxp) "
              f"{t['dwh.library']:.4f} ms (library / dwh "
              f"{t['dwh.library'] / t['K2.dwh']:.2f})")
        lstm_ways_lines(x_proj, wh, peep, g_hs, t)
        timed[batch, steps] = (t, bounds)
        del x_proj, wh, res, g_hs, x32, wh32, res32, g32, dxp, h_prev, d_rows
        torch.cuda.empty_cache()

    entries = []
    for kern, kernel, src, line in (
            ("K1", K.FUSED_LSTM_FWD_BF16, "fused_lstm.cu", 88),
            ("K2", K.FUSED_LSTM_BWD_BF16, "fused_lstm_bwd.cu", 175)):
        t, bounds = timed[LSTM_BENCH["batch"], SEQ_LEN]
        entries.append({
            "name": f"{kern}.bf16", "route": "cuda",
            "source": f"euromillioner_tpu_torch/csrc/{src}",
            "replaces": f"euromillioner_tpu/ops/fused_lstm.py:{line}",
            "symbol": kernel.symbol, "launches": 0,
            "max_abs_err": worst[kern], "ms": t[kern],
            "plain_ms": t[kern + ".plain"], "bound_ms": bounds[kern][0],
            "bound_by": bounds[kern][1], "library_ms": None,
            "shape": f"B={LSTM_BENCH['batch']} T={SEQ_LEN} H={HIDDEN}",
            "ms_by_shape": {f"B={b} T={s}": timed[b, s][0][kern]
                            for b, s in BF16_TIMED},
            "f32_ms_by_shape": {f"B={b} T={s}": timed[b, s][0][kern + ".f32"]
                                for b, s in BF16_TIMED},
            "plan": {f"B={b} T={s}": plans[b, s][kern]
                     for b, s in BF16_TIMED}})
    t = timed[LSTM_BENCH["batch"], SEQ_LEN][0]
    entries[1].update({"recurrence_ms": t["K2.recurrence"],
                       "dwh_ms": t["K2.dwh"],
                       "dwh_library_ms": t["dwh.library"]})
    return entries[0], entries[1]


def phase_lstm_odd_widths() -> None:
    """K1 and K2 in f32 and bf16 at ODD_WIDTHS x ODD_SHAPES against their
    plain versions on the same inputs (K2 on the plain version's
    residuals), three reruns bit-identical, each shape with its plans."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    failures = []
    for hidden in ODD_WIDTHS:
        for batch, steps in ODD_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                x_proj, wh, peep = k1_inputs(batch, steps, True, hidden)
                x_proj, wh = x_proj.to(dtype), wh.to(dtype)
                gen = torch.Generator().manual_seed(SEED + 7 * batch + steps)
                g_hs = torch.randn((steps, batch, hidden),
                                   generator=gen).cuda().to(dtype)
                ref = K.lstm_sequence_reference(x_proj, wh, peep, True)
                ref_b = K.lstm_backward_reference(wh, peep, ref, g_hs, True)
                torch.cuda.synchronize()
                runs = [(K.lstm_forward(x_proj, wh, peep, True),
                         K.lstm_backward(wh, peep, ref, g_hs, True),
                         K.lstm_sequence(x_proj, wh, peep, True))
                        for _ in range(3)]
                torch.cuda.synchronize()
                f32 = dtype == torch.float32
                name = "f32" if f32 else "bf16"
                plans = [K.lstm_plan(dtype, batch, hidden, steps, backward)
                         for backward in (False, True)]
                errs, all_same = [], True
                for kern, out, outs, want in (
                        [("K1", n, i, ref[i])
                         for i, n in enumerate(("hs", "cs", "gates"))]
                        + [("K1", "hs(no residuals)", None, ref[0])]
                        + [("K2", n, i, ref_b[i])
                           for i, n in enumerate(("dxp", "dwh", "dpeep"))]):
                    got = [r[2] if outs is None else
                           r[0 if kern == "K1" else 1][outs] for r in runs]
                    abs_err, rel_err = max_errors(got[0], want)
                    same = all(torch.equal(got[0], g) for g in got[1:])
                    all_same = all_same and same
                    if not f32:
                        err, tol = rel_err, BF16_KERNEL_TOL
                    elif kern == "K1":
                        err, tol = abs_err, K1_TOL
                    else:
                        err, tol = rel_err, K2_TOL[out]
                    errs.append(f"{kern} {out} {err:.2e}")
                    if err > tol or not same:
                        failures.append(
                            f"{kern} {name} {out} at H={hidden} B={batch} "
                            f"T={steps}: {err:.3e} > {tol:.2e} or reruns "
                            f"equal {same}")
                kinds, tols = (("K1 abs, K2 rel_to_scale", "K1_TOL, K2_TOL")
                               if f32 else ("rel_to_scale", "BF16_KERNEL_TOL"))
                print(f"K1/K2 odd width {name} H={hidden} B={batch} "
                      f"T={steps}: K1 plan cluster {plans[0].cluster} x "
                      f"{plans[0].units} units, {plans[0].rows}-row tiles, "
                      f"wh {'resident' if plans[0].resident else 'streamed'};"
                      f" K2 plan cluster {plans[1].cluster} x "
                      f"{plans[1].units} units, {plans[1].rows}-row tiles, "
                      f"wh {'resident' if plans[1].resident else 'streamed'}"
                      f"; errors ({kinds}): {', '.join(errs)} (tols {tols}), "
                      f"3 runs bit-identical {all_same}")
                del x_proj, wh, g_hs, ref, ref_b, runs
    check(not failures, "; ".join(failures))


def phase_train_bf16(root: Path) -> tuple[dict, Path]:
    """The flagship trained through the CLI at its default bfloat16
    compute dtype: bf16 K2 launched exactly layers x steps x epochs times
    and bf16 K1 that plus the watch chunks, the f32 kernels never. Returns
    the counts and the checkpoint directory."""
    from euromillioner_tpu_torch.config import ModelConfig

    check(ModelConfig().compute_dtype == "bfloat16",
          "the default compute dtype is not bfloat16")
    counts, want_k1, want_k2, ckdir = train_cli(root, "train_bf16", [])
    check(counts["K2.bf16"] == want_k2,
          f"bf16 K2 launched {counts['K2.bf16']} times, expected {want_k2}")
    check(counts["K1.bf16"] == want_k1,
          f"bf16 K1 launched {counts['K1.bf16']} times, expected {want_k1}")
    check(counts["K1.f32"] == counts["K2.f32"] == 0,
          "a bf16 train launched the f32 kernels")
    return counts, ckdir


def phase_serve_bf16_trained(ckdir: Path) -> dict:
    """Serve the bf16-trained checkpoint at its default compute dtype
    through ``serve --smoke 32`` at every profile: no failed request, the
    launch counts of each tier (fused and int8w serve float32, as the JAX
    package does: f32 K1 once per layer per program, bf16 K1 never), and
    each tier's replies inside its envelope of the direct predict.
    Returns the fused and int8w tiers' K1 launches."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config, ServeConfig
    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)
    from euromillioner_tpu_torch.serve.continuous import \
        load_recurrent_backend
    from euromillioner_tpu_torch.serve.transport import smoke_payloads

    oracle = load_recurrent_backend(Config(), str(ckdir), device="cuda")
    check(oracle.compute_dtype == torch.bfloat16, "checkpoint dtype")
    payloads = smoke_payloads(SMOKE_REQUESTS, FEATURES, SEQ_LEN)
    direct = torch.from_numpy(np.stack([oracle.predict(p)
                                        for p in payloads]))
    serve = ServeConfig()
    programs = LAYERS * (len(serve.buckets) * len(serve.seq_buckets)
                         if serve.warmup else 0)
    launches = {}
    failures = []
    for profile in ("f32", "bf16", "fused", "int8w"):
        reset_lstm_counts()
        summary = serve_cli(ckdir, profile, compute_dtype="bfloat16")
        counts = lstm_counts()
        got = torch.tensor(summary["predictions"])
        check(tuple(got.shape) == (SMOKE_REQUESTS, OUTPUTS)
              and bool(torch.isfinite(got).all()), f"{profile} replies")
        # f32 serves the checkpoint's bf16 through the scan at the bucket
        # shapes, the oracle at one row: bf16 rounding, held to (lstm, bf16)
        env = SERVE_ENVELOPES[("lstm", "bf16" if profile == "f32"
                               else profile)]
        err = rel_error(got, direct)
        want = (LAYERS * summary["stats"]["batches"] + programs
                if profile in ("fused", "int8w") else 0)
        print(f"serve bf16 checkpoint {profile}: rel to direct predict "
              f"{err:.3e} (envelope {env:.0e}); launches {json.dumps(counts)} "
              f"(expected K1.f32 {want}, others 0)")
        if err > env:
            failures.append(f"{profile} replies {err:.3e} outside {env}")
        if counts != {"K1.f32": want, "K1.bf16": 0, "K2.f32": 0,
                      "K2.bf16": 0}:
            failures.append(f"{profile} launches {counts}")
        launches[profile] = counts["K1.f32"]
    check(not failures, "; ".join(failures))
    return launches


def phase_lstm_bench(k1: dict, k2: dict) -> dict:
    """bench.py's _bench_lstm on the card: B=2048, T=64, H=512, 2 layers,
    bf16, fused=auto, Adam 1e-3, mse; median ms/step, draws/s, K1+K2's
    share of the step from their own times, a profiler window and the
    peak memory. Returns its bf16 K1/K2 launches."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import Precision
    from euromillioner_tpu_torch.data.dataset import Batch
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    b = LSTM_BENCH["batch"]
    model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused="auto",
                       in_features=FEATURES,
                       generator=torch.Generator().manual_seed(SEED),
                       device="cuda")
    trainer = Trainer(model, adam(1e-3), loss="mse",
                      precision=Precision(compute_dtype=torch.bfloat16))
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, SEQ_LEN, FEATURES)).astype(np.float32)
    y = rng.normal(size=(b, OUTPUTS)).astype(np.float32)
    batch = trainer._place(Batch(x=x, y=y, mask=np.ones(b, np.float32)))
    torch.cuda.reset_peak_memory_stats()
    reset_lstm_counts()
    times = []
    for i in range(LSTM_BENCH["warmup"] + LSTM_BENCH["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        if i >= LSTM_BENCH["warmup"]:
            times.append((time.perf_counter() - t0) * 1e3)
    counts = lstm_counts()
    check(math.isfinite(float(loss)), "lstm bench step loss is not finite")
    n = LSTM_BENCH["warmup"] + LSTM_BENCH["steps"]
    check(counts == {"K1.f32": 0, "K1.bf16": LAYERS * n, "K2.f32": 0,
                     "K2.bf16": LAYERS * n},
          f"bench step launches {counts}, expected {LAYERS} x {n} bf16")
    ms = statistics.median(times)
    kern_ms = LAYERS * (k1["ms"] + k2["ms"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"lstm bench step (B={b} T={SEQ_LEN} H={HIDDEN} {LAYERS} layers, "
          f"bf16, fused=auto, Adam, mse): median {ms:.4f} ms/step over "
          f"{len(times)} steps (min {min(times):.4f}, max {max(times):.4f}), "
          f"{b / ms * 1e3:.1f} draws/s; K1+K2 {kern_ms:.4f} ms = "
          f"{kern_ms / ms:.3f} of the step (from their own times); peak "
          f"device memory {peak:.2f} GiB; launches {json.dumps(counts)}")

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, batch)

    profile_steps(f"lstm bench step B={b}", step, ms)
    del trainer, state, model, batch
    torch.cuda.empty_cache()
    return {"K1.bf16": counts["K1.bf16"], "K2.bf16": counts["K2.bf16"],
            "step_ms": ms}


def phase_step_bf16(root: Path) -> None:
    """One bf16 training step at B=64 on the card (bf16 K1+K2) against the
    same step on the CPU (their plain versions through the Function)."""
    from euromillioner_tpu_torch.core.precision import DEFAULT_PRECISION
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    check(DEFAULT_PRECISION.compute_dtype == torch.bfloat16, "default dtype")
    train_ds, _ = golden_windows(root)
    host_batch = next(iter(train_ds.batches(64)))
    results, params = {}, None
    for device, fused in (("cpu", "on"), ("cuda", "auto")):
        model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused=fused,
                           in_features=FEATURES,
                           generator=torch.Generator().manual_seed(SEED + 3),
                           device=device)
        trainer = Trainer(model, adam(1e-3), precision=DEFAULT_PRECISION)
        state = trainer.init_state(params)
        params = state.params
        new, loss = trainer.train_step(state, trainer._place(host_batch))
        results[device] = (float(loss), {k: v.cpu() for k, v in
                                         new.opt_state["mu"].items()})
    (loss_c, mu_c), (loss_g, mu_g) = results["cpu"], results["cuda"]
    tol = LSTM_BF16_STEP_TOL
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    worst = 0.0
    for k in mu_c:
        _, err = max_errors(mu_g[k], mu_c[k])
        print(f"step bf16 grad {k}: rel_to_scale {err:.3e}")
        worst = max(worst, err)
    print(f"step bf16 B=64: loss card {loss_g:.6f} cpu {loss_c:.6f} rel "
          f"{loss_err:.3e} (tol {tol['loss']:.0e}); worst grad rel_to_scale "
          f"{worst:.3e} (tol {tol['grad']:.0e})")
    check(loss_err <= tol["loss"], f"bf16 step loss differs by {loss_err}")
    check(worst <= tol["grad"], f"bf16 step gradients differ by {worst}")


def k3_inputs(n: int, f: int, n_bins: int, n_nodes: int, seed: int):
    """One level's K3 inputs on the card, from numpy: uniform bins and
    nodes, normal gradients, uniform hessians, half the rows weighted."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2, size=n).astype(np.float32)
    arrays = (rng.integers(0, n_bins, size=(n, f)).astype(np.int32),
              rng.integers(0, n_nodes, size=n).astype(np.int32),
              rng.normal(size=n).astype(np.float32) * w,
              rng.uniform(0.05, 0.25, size=n).astype(np.float32) * w)
    return [torch.from_numpy(a).cuda() for a in arrays]


def k3_skewed_inputs(n: int, f: int, n_bins: int, n_nodes: int, seed: int):
    """K3_SKEWED_SHAPES' inputs on the card, from numpy: 90% of the rows in
    node 0 and in bins 0-3 of every feature, the rest uniform; gradients
    p - y and hessians p (1 - p) of logistic rows with margins uniform on
    +-18.4 (hessians from 1e-8 to 0.25)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hot = rng.uniform(size=n) < 0.9
    binned = rng.integers(0, n_bins, size=(n, f))
    binned[hot] = rng.integers(0, 4, size=(int(hot.sum()), f))
    local = np.where(hot, 0, rng.integers(0, n_nodes, size=n))
    p = 1.0 / (1.0 + np.exp(-rng.uniform(-18.4, 18.4, size=n)))
    y = rng.integers(0, 2, size=n)
    arrays = (binned.astype(np.int32), local.astype(np.int32),
              (p - y).astype(np.float32), (p * (1.0 - p)).astype(np.float32))
    return [torch.from_numpy(a).cuda() for a in arrays]


def k3_exact(binned, local, gw, hw, n_bins: int, n_nodes: int):
    """K3's sums taken in float64 on the card: the plain version's
    index_add_ over the flat (node, feature, bin) index, on doubles."""
    n, f = binned.shape
    flat = (local.long()[:, None] * (f * n_bins)
            + torch.arange(f, device=binned.device)[None, :] * n_bins
            + binned.long()).reshape(-1)
    hists = [torch.zeros(n_nodes * f * n_bins, dtype=torch.float64,
                         device=binned.device)
             .index_add_(0, flat, w.double()[:, None].expand(n, f)
                         .reshape(-1)) for w in (gw, hw)]
    hist = torch.stack(hists).view(2, n_nodes, f, n_bins)
    return hist.permute(2, 1, 0, 3).reshape(f, 2 * n_nodes, n_bins)


def k3_bound_ms(n: int, f: int, n_bins: int, n_nodes: int
                ) -> tuple[float, float]:
    """(bytes ms, operations ms): binned, local, gw and hw read once and
    the (F, 2K, bins) output written once at HBM rate; one add per
    (row, feature, stat) on the FP32 pipe."""
    nbytes = 4 * (n * f + 3 * n + f * 2 * n_nodes * n_bins)
    return (nbytes / PEAK_HBM_BYTES_S * 1e3,
            2 * n * f / PEAK_FP32_FLOPS * 1e3)


def time_cold_ms(fn, runs: int = 10) -> float:
    """Median milliseconds of ``fn`` on the card with a cold L2:
    L2_FLUSH_BYTES written before each run, outside its CUDA events."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for _ in range(runs):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k3_plan_line(n: int, f: int, n_bins: int, n_nodes: int,
                 sets: int = 1) -> str:
    """K3's launch plan at a shape and its shared memory per block of 16
    warps."""
    from euromillioner_tpu_torch.ops import fused_histogram as K

    plan = K.launch_plan(n, f, n_bins, n_nodes, sets)
    return f"{plan}, {K.smem_bytes(plan)} B shared per block of 16 warps"


def k3_way(plan) -> str:
    """How a K3 plan's warps add their rows."""
    if plan.by_feature:
        return f"lanes on features ({plan.features} features a block)"
    if plan.owners == 1:
        return f"lanes on rows, one owner ({plan.copies} copies)"
    return f"lanes on rows split among {plan.owners} owners"


def k3_ways_line(what: str, run, plan, alt, ok) -> bool:
    """Times ``run(plan)`` and ``run(alt)`` (K3 under the chosen plan and
    under another) and prints both; ``ok`` holds the other plan's result
    to the chosen plan's check. Returns ``ok``'s verdict."""
    ms = time_ms(lambda: run(plan))
    alt_ms = time_ms(lambda: run(alt))
    good = ok(run(alt))
    print(f"K3 ways at {what}: {k3_way(plan)}, chosen, {ms:.4f} ms; "
          f"{k3_way(alt)} {alt_ms:.4f} ms ({alt_ms / ms:.2f}x the chosen); "
          f"{alt}: its sums pass the chosen plan's check {good}")
    return good


def versus(ms: float, earlier_ms, library_ms: float, bound_ms: float) -> str:
    """A timed shape's kernel time beside the earlier design's (a constant
    from PERF.md), the bincount yardstick's and the bound."""
    earlier = ("node-tiled design not timed" if earlier_ms is None
               else f"node-tiled design {earlier_ms:.4f} ms in PERF.md "
               f"({earlier_ms / ms:.2f}x this run)")
    return (f"{earlier}; bincount x2 / kernel {library_ms / ms:.2f}; bound "
            f"share {bound_ms / ms:.4f}")


def phase_k3() -> dict:
    """K3 against its plain version at the GBT paths' level shapes, and
    against float64 sums at the skewed shapes; three reruns bit-identical;
    then times beside the earlier design's, the bincount yardstick's and
    the bounds."""
    from euromillioner_tpu_torch.ops import fused_histogram as K

    worst_rel = worst_abs = 0.0
    failures = []
    shapes = [(s, False) for s in K3_SHAPES] + [
        (s, True) for s in K3_SKEWED_SHAPES]
    for seed, ((n, f, n_bins, n_nodes), skewed) in enumerate(shapes):
        make = k3_skewed_inputs if skewed else k3_inputs
        binned, local, gw, hw = make(n, f, n_bins, n_nodes, seed)
        plain = K.fused_histogram_reference(binned, local, gw, hw, n_bins,
                                            n_nodes)
        want = (k3_exact(binned, local, gw, hw, n_bins, n_nodes) if skewed
                else plain.double())
        # each cell's scale: the sum of the magnitudes it adds up
        scale = k3_exact(binned, local, gw.abs(), hw.abs(), n_bins,
                         n_nodes).clamp_min(1e-30)
        torch.cuda.synchronize()
        runs = [K.fused_histogram(binned, local, gw, hw, n_bins, n_nodes)
                for _ in range(3)]
        torch.cuda.synchronize()
        err = (runs[0].double() - want).abs()
        rel = (err / scale).max().item()
        same = all(torch.equal(runs[0], r) for r in runs[1:])
        what = "float64 sums" if skewed else "plain"
        extra = ""
        if skewed:
            plain_rel = ((plain.double() - want).abs() / scale).max().item()
            extra = (f", the f32 plain version's own rel_to_cell_scale "
                     f"{plain_rel:.3e}")
        print(f"K3 N={n} F={f} bins={n_bins} nodes={n_nodes}"
              f"{' skewed' if skewed else ''}: vs {what} max_abs="
              f"{err.max().item():.3e} rel_to_cell_scale={rel:.3e} (tol "
              f"{K3_TOL:.0e}){extra}, bit-identical reruns {same}; "
              f"{k3_plan_line(n, f, n_bins, n_nodes)}")
        if rel > K3_TOL or not same:
            failures.append(f"K3 at {(n, f, n_bins, n_nodes)}"
                            f"{' skewed' if skewed else ''}: rel {rel:.3e}"
                            f", reruns equal {same}")
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, err.max().item())
        del plain, want, scale, runs, err
    check(not failures, "; ".join(failures))

    timed = {}
    for seed, ((n, f, n_bins, n_nodes), skewed) in enumerate(shapes):
        make = k3_skewed_inputs if skewed else k3_inputs
        binned, local, gw, hw = make(n, f, n_bins, n_nodes,
                                     seed if skewed else 0)
        ms = time_ms(lambda: K.fused_histogram(binned, local, gw, hw, n_bins,
                                               n_nodes))
        plain_ms = time_ms(lambda: K.fused_histogram_reference(
            binned, local, gw, hw, n_bins, n_nodes))
        # the yardstick: one bincount per stat over the flat (node,
        # feature, bin) index, the index built outside the timed call
        flat = (local.long()[:, None] * (f * n_bins)
                + torch.arange(f, device=binned.device)[None, :] * n_bins
                + binned.long()).reshape(-1)
        wg = gw[:, None].expand(n, f).reshape(-1)
        wh = hw[:, None].expand(n, f).reshape(-1)
        size = n_nodes * f * n_bins
        library_ms = time_ms(lambda: (
            torch.bincount(flat, weights=wg, minlength=size),
            torch.bincount(flat, weights=wh, minlength=size)))
        bytes_ms, ops_ms = k3_bound_ms(n, f, n_bins, n_nodes)
        bound = max(bytes_ms, ops_ms)
        key = "x".join(map(str, (n, f, n_bins, n_nodes)))
        if skewed:
            key += "_skewed"
        timed[key] = (ms, plain_ms, library_ms, bytes_ms, ops_ms)
        print(f"K3 timing N={n} F={f} bins={n_bins} nodes={n_nodes}"
              f"{' skewed' if skewed else ''}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bincount x2 {library_ms:.4f} ms, bound "
              f"{bound:.4f} ms (bytes {bytes_ms:.4f}, operations "
              f"{ops_ms:.4f}); "
              f"{versus(ms, NODE_TILED_K3_MS.get(key), library_ms, bound)}")
        if (n, f, n_bins, n_nodes) == K3_TIMED_SHAPE and not skewed:
            cold_ms = time_cold_ms(lambda: K.fused_histogram(
                binned, local, gw, hw, n_bins, n_nodes))
            print(f"K3 timing at {key} with L2 flushed "
                  f"({L2_FLUSH_BYTES >> 20} MB written between launches): "
                  f"kernel {cold_ms:.4f} ms (warm {ms:.4f} ms)")
        del flat, wg, wh
    for (n, f, n_bins, n_nodes), fields in K3_WAYS.items():
        binned, local, gw, hw = k3_inputs(n, f, n_bins, n_nodes, 0)
        plain = K.fused_histogram_reference(binned, local, gw, hw, n_bins,
                                            n_nodes).double()
        scale = k3_exact(binned, local, gw.abs(), hw.abs(), n_bins,
                         n_nodes).clamp_min(1e-30)
        plan = K.launch_plan(n, f, n_bins, n_nodes)
        good = k3_ways_line(
            f"N={n} F={f} bins={n_bins} nodes={n_nodes}",
            lambda p: K.fused_histogram(binned, local, gw, hw, n_bins,
                                        n_nodes, plan=p),
            plan, plan._replace(**fields),
            lambda out: ((out.double() - plain).abs() / scale).max().item()
            <= K3_TOL)
        check(good, f"K3 under {fields} at {(n, f, n_bins, n_nodes)}")
    key = "x".join(map(str, K3_TIMED_SHAPE))
    ms, plain_ms, library_ms, bytes_ms, ops_ms = timed[key]
    return {"name": "fused_histogram", "route": "cuda",
            "source": "euromillioner_tpu_torch/csrc/fused_histogram.cu",
            "replaces": "euromillioner_tpu/ops/fused_histogram.py:140",
            "launches": 0, "max_abs_err": worst_abs,
            "max_rel_to_cell_scale": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms, "cold_ms": cold_ms,
            "timed_shape": list(K3_TIMED_SHAPE),
            "ms_by_shape": {k: v[0] for k, v in timed.items()}}


def tree_structure(trees, r: int):
    leaf = trees["is_leaf"][r]
    return (tuple(leaf.tolist()), tuple(trees["feature"][r][~leaf].tolist()),
            tuple(trees["split_bin"][r][~leaf].tolist()))


def split_gain(booster, dtrain, r: int, node: int):
    """Gain of every (feature, bin) split candidate at ``node`` of round r,
    on the CPU from ``booster``'s margins after r rounds and its tree r's
    routing down to that node."""
    import numpy as np

    from euromillioner_tpu_torch.trees import binning, growth

    p = booster.params
    cuts = booster.cuts
    x = torch.from_numpy(binning.apply_bins(dtrain.x, cuts))
    margin = torch.full((len(dtrain),), booster.base_margin)
    for t in range(r):
        tree = {k: torch.from_numpy(v[t]) for k, v in booster.trees.items()}
        leaf = growth.route(x, tree["feature"], tree["split_bin"],
                            tree["is_leaf"], max_depth=booster.max_depth)
        margin = margin + tree["leaf_value"][leaf]
    grad, hess = booster.objective.grad_hess(margin,
                                             torch.from_numpy(dtrain.y))
    tree = {k: torch.from_numpy(v[r]) for k, v in booster.trees.items()}
    depth = int(np.log2(node + 1))
    at = growth.route(x, tree["feature"], tree["split_bin"],
                      tree["is_leaf"], max_depth=depth) == node
    w = at.float()
    hg, hh = growth.node_histograms(x, torch.zeros_like(at, dtype=torch.int32),
                                    grad * w, hess * w, 1,
                                    binning.num_bins(cuts))
    return growth.split_gains(hg, hh, float(p["lambda"]),
                              float(p["gamma"]))[0][0]


def same_trees_or_near_tie(card, cpu, dtrain, rounds: int, what: str) -> int:
    """Rounds whose tree structure is equal on the card and the CPU, up
    to the first that differs; a differing round must be a near-tie: the
    two splits' gains at the first differing node within NEAR_TIE of each
    other (a leaf counts as gain 0). Returns the equal-round count."""
    differ = next((r for r in range(rounds) if tree_structure(card.trees, r)
                   != tree_structure(cpu.trees, r)), rounds)
    print(f"{what}: trees equal in structure for {differ} of {rounds} "
          f"rounds")
    if differ < rounds:
        r = differ
        cols = [card.trees[k][r] for k in ("is_leaf", "feature", "split_bin")]
        ref = [cpu.trees[k][r] for k in ("is_leaf", "feature", "split_bin")]
        node = next(i for i in range(len(cols[0]))
                    if [c[i] for c in cols] != [c[i] for c in ref])
        gains = split_gain(cpu, dtrain, r, node)

        def gain(trees):
            if trees["is_leaf"][r][node]:
                return 0.0
            return float(gains[trees["feature"][r][node],
                               trees["split_bin"][r][node]])
        a, b = gain(card.trees), gain(cpu.trees)
        tie = abs(a - b) <= NEAR_TIE * max(abs(a), abs(b))
        print(f"{what}: round {r} node {node} differs; split gains card "
              f"{a!r} cpu {b!r}: near-tie (within {NEAR_TIE:.0e}) {tie}")
        check(tie, f"{what}: round {r} differs without a near-tie")
    return differ


def golden_matrices(root: Path, binary: bool):
    """(train, test) DMatrices of the golden page as the reference splits
    it; ``binary`` thresholds the label at its mean (the pin's binary
    config)."""
    import numpy as np

    from euromillioner_tpu_torch.data.pipeline import draws_from_html
    from euromillioner_tpu_torch.trees import DMatrix

    rows = np.asarray(draws_from_html((root / GOLDEN_HTML).read_text()),
                      np.float32)
    cut = int(0.7 * len(rows))
    y = rows[:, 0]
    if binary:
        y = (y > y.mean()).astype(np.float32)
    x = np.delete(rows, 0, axis=1)
    return DMatrix(x[:cut], y[:cut]), DMatrix(x[cut:], y[cut:])


def phase_reference(root: Path) -> tuple[int, dict]:
    """The reference pipeline through the CLI at the full 500 rounds (the
    main path; returns K3's launches during it, with the printed boolean
    and the card's API run for phase 32), then through the API on the
    card and on the CPU: trees equal in structure, predictions close."""
    import numpy as np

    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.app import run_reference_pipeline
    from euromillioner_tpu_torch.config import Config
    from euromillioner_tpu_torch.ops.fused_histogram import FUSED_HISTOGRAM

    cfg = Config()
    levels = cfg.gbt.max_depth + 1
    argv = ["reference", "--html-file", str(root / GOLDEN_HTML)]
    buf = io.StringIO()
    FUSED_HISTOGRAM.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FUSED_HISTOGRAM.launches
    out = buf.getvalue().strip().splitlines()
    want = 2 * cfg.gbt.nround * levels
    print(f"reference (CLI, {cfg.gbt.nround} rounds, 2 boosters): exit {rc}, "
          f"printed {out[-1] if out else None!r}, K3 launches {launches} "
          f"(expected 2 x {cfg.gbt.nround} x {levels} = {want}), wall "
          f"{wall:.3f} s")
    check(rc == 0, f"reference exited {rc}")
    check(bool(out) and out[-1] in ("True", "False"), "no boolean printed")
    check(launches == want, f"K3 launched {launches} times, expected {want}")

    html = (root / GOLDEN_HTML).read_text()
    runs, walls = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            runs[device] = run_reference_pipeline(cfg, html, device=device)
        walls[device] = time.perf_counter() - t0
    print(f"reference (API) wall: card {walls['cuda']:.3f} s, CPU "
          f"{walls['cpu']:.3f} s")
    dtrain, dtest = golden_matrices(root, binary=False)
    card, cpu = runs["cuda"], runs["cpu"]
    for name, dmat in (("booster", dtrain), ("booster_test", dtest)):
        rounds = same_trees_or_near_tie(getattr(card, name),
                                        getattr(cpu, name), dmat,
                                        cfg.gbt.nround, f"reference {name}")
        check(rounds == cfg.gbt.nround,
              f"reference {name}: trees differ from the CPU's at round "
              f"{rounds}")
    for got, ref in ((card.predictions, cpu.predictions),
                     (card.predictions_test, cpu.predictions_test)):
        rel = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref),
                                                          1e-30)))
        print(f"reference predictions card vs CPU: max rel {rel:.3e} (tol "
              f"{GBT_PRED_TOL:.0e})")
        check(rel <= GBT_PRED_TOL, f"predictions differ by {rel:.3e}")
    check(card.predicts_equal == cpu.predicts_equal, "printed booleans differ")
    return launches, {"printed": out[-1], "run": card}


def phase_golden_trajectories(root: Path) -> None:
    """Both 20-round golden configs on the card against the CPU: equal
    structure, or a shown near-tie; logloss close up to the first
    differing round."""
    import numpy as np

    from euromillioner_tpu_torch.trees import train

    pin = json.loads((root / GOLDEN_PIN).read_text())
    for key in ("reference", "binary"):
        dtrain, dtest = golden_matrices(root, binary=key == "binary")
        boosters, results = {}, {}
        for device in ("cuda", "cpu"):
            res = {}
            boosters[device] = train(
                dict(pin[key]["params"], device=device), dtrain,
                pin["n_rounds"], evals={"train": dtrain, "test": dtest},
                verbose_eval=False, evals_result=res)
            results[device] = res
        equal = same_trees_or_near_tie(boosters["cuda"], boosters["cpu"],
                                       dtrain, pin["n_rounds"],
                                       f"golden {key}")
        for name in ("train", "test"):
            a = np.asarray(results["cuda"][name]["logloss"][:equal])
            b = np.asarray(results["cpu"][name]["logloss"][:equal])
            rel = float(np.max(np.abs(a - b) / np.abs(b))) if equal else 0.0
            print(f"golden {key} {name}-logloss card vs CPU over {equal} "
                  f"rounds: max rel {rel:.3e} (tol {GBT_PRED_TOL:.0e})")
            check(rel <= GBT_PRED_TOL, f"golden {key} {name} logloss drifts")


def scaled_data():
    """bench.py's GBT_SCALED recipe: numpy seed 0, 200k x 28 normal
    features, labels from a random linear score plus noise."""
    import numpy as np

    from euromillioner_tpu_torch.trees import DMatrix

    rng = np.random.default_rng(0)
    x = rng.normal(size=(SCALED["rows"], SCALED["features"])).astype(
        np.float32)
    w = rng.normal(size=(SCALED["features"],)).astype(np.float32)
    y = (x @ w + 0.5 * rng.normal(size=SCALED["rows"]) > 0).astype(
        np.float32)
    return DMatrix(x, y)


def phase_scaled(k3_ms_by_shape: dict) -> int:
    """The scaled GBT on the card (returns K3's launches); its first
    rounds against the CPU."""
    from euromillioner_tpu_torch.ops.fused_histogram import FUSED_HISTOGRAM
    from euromillioner_tpu_torch.trees import train

    dtrain = scaled_data()
    dtrain.quantized(256)  # binning is set-up, outside the timed run
    params = {"objective": "binary:logistic", "eta": SCALED["eta"],
              "max_depth": SCALED["max_depth"], "gamma": SCALED["gamma"]}
    rounds, depth = SCALED["rounds"], SCALED["max_depth"]
    train(dict(params, device="cuda"), dtrain, 2, verbose_eval=False)
    FUSED_HISTOGRAM.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = train(dict(params, device="cuda"), dtrain, rounds,
                 verbose_eval=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FUSED_HISTOGRAM.launches
    want = rounds * (depth + 1)
    # K3's share: the per-level kernel times measured in the K3 phase at
    # these shapes, times the rounds, over the wall time; and CUDA events
    # around each K3 launch of one more run
    n, f = SCALED["rows"], SCALED["features"]
    k3_s = rounds * sum(k3_ms_by_shape[f"{n}x{f}x256x{1 << d}"]
                        for d in range(depth + 1)) / 1e3
    k3_events_s = kernel_ms(FUSED_HISTOGRAM, lambda: train(
        dict(params, device="cuda"), dtrain, rounds,
        verbose_eval=False)) / 1e3
    print(f"scaled GBT ({n} x {f}, depth {depth}, {rounds} rounds) on the "
          f"card: wall {wall:.3f} s, {rounds / wall:.2f} rounds/s; K3 "
          f"launches {launches} (expected {rounds} x {depth + 1} = {want}); "
          f"K3 share of wall {k3_s / wall:.3f} from the K3 phase's "
          f"per-level times, {k3_events_s / wall:.3f} from CUDA events "
          f"around its launches in one more run ({k3_events_s:.4f} s; the "
          f"node-tiled design's in PERF.md: {NODE_TILED_SCALED_K3_SHARE})")
    check(launches == want, f"K3 launched {launches} times, expected {want}")
    cpu = train(dict(params, device="cpu"), dtrain, SCALED_CPU_ROUNDS,
                verbose_eval=False)
    same_trees_or_near_tie(card, cpu, dtrain, SCALED_CPU_ROUNDS,
                           "scaled GBT")
    return launches


def phase_cli_train_predict(root: Path) -> tuple[int, Path]:
    """``fetch``, ``train --model gbt --save``, ``predict --model-type
    gbt`` through the CLI on the card; the CLI's predictions bit-equal to
    the in-process Booster.predict. Returns K3's launches in train and the
    directory that holds the CSV and the booster (gbt.json), which phase
    21 serves."""
    import numpy as np

    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.config import Config
    from euromillioner_tpu_torch.data.csvio import read_csv
    from euromillioner_tpu_torch.ops.fused_histogram import FUSED_HISTOGRAM
    from euromillioner_tpu_torch.trees import Booster, DMatrix

    out = root / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    csv, model = out / "draws.csv", out / "gbt.json"
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(["fetch", "--html-file", str(root / GOLDEN_HTML),
                        "--output", str(csv)]) == 0, "fetch failed")
    FUSED_HISTOGRAM.launches = 0
    rc = cli.main(["train", "--model", "gbt", "--csv", str(csv), "--save",
                   str(model)])
    launches = FUSED_HISTOGRAM.launches
    cfg = Config()
    want = cfg.gbt.nround * (cfg.gbt.max_depth + 1)
    check(rc == 0, f"train --model gbt exited {rc}")
    check(launches == want, f"K3 launched {launches} times in train, "
          f"expected {want}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["predict", "--model-type", "gbt", "--model-file",
                       str(model), "--csv", str(csv), "--has-label"])
    check(rc == 0, f"predict exited {rc}")
    got = np.asarray([float(v) for v in buf.getvalue().split()], np.float32)
    x, _, _ = read_csv(str(csv), label_column=0)
    ref = Booster.load_model(str(model)).predict(DMatrix(x))
    same = got.shape == ref.shape and np.array_equal(got, ref)
    print(f"CLI train --model gbt ({cfg.gbt.nround} rounds, K3 launches "
          f"{launches}) -> predict on {len(got)} rows: bit-equal to "
          f"Booster.predict {same}")
    check(same, "CLI predictions differ from Booster.predict")
    return launches, out


# -- the random forest (K3's set form) ----------------------------------------

def rf_data():
    """bench.py's _bench_rf recipe: numpy seed 0, 100k x 28 normal
    features; the classifier's labels threshold a random linear score plus
    noise at 0, the regressor's target is that score."""
    import numpy as np

    s = RF_SHAPE
    rng = np.random.default_rng(0)
    x = rng.normal(size=(s["rows"], s["features"])).astype(np.float32)
    w = rng.normal(size=(s["features"],)).astype(np.float32)
    score = x @ w + 0.5 * rng.normal(size=s["rows"])
    return x, (score > 0).astype(np.float32), score.astype(np.float32)


def rf_set_inputs(y_cls, y, n: int, n_nodes: int, form: str, seed: int):
    """One level's K3 set-form inputs for RF_SHAPE's trees, as the forest
    builds them (trees/random_forest.class_sets and reg_sets): each tree's
    rows spread uniformly over the level's nodes, Poisson(1) weights."""
    from euromillioner_tpu_torch.trees import random_forest as rf

    gen = torch.Generator().manual_seed(seed)
    local = torch.randint(0, n_nodes, (RF_SHAPE["trees"], n), generator=gen,
                          dtype=torch.int32).cuda()
    w = rf.poisson_bootstrap(gen, RF_SHAPE["trees"], n).cuda()
    if form == "classes":
        return rf.class_sets(y_cls, local, w, RF_SHAPE["num_classes"])
    return rf.reg_sets(y, local, w)


def k3_sets_bound_ms(n: int, f: int, n_bins: int, n_nodes: int, sets: int
                     ) -> tuple[float, float]:
    """(bytes ms, operations ms) of one set-form launch: binned read once,
    each set's local, gw and hw once, its (F, 2K, bins) output written
    once; one add per (set, row, feature, stat) on the FP32 pipe."""
    nbytes = 4 * (n * f + 3 * sets * n + sets * f * 2 * n_nodes * n_bins)
    return (nbytes / PEAK_HBM_BYTES_S * 1e3,
            2 * sets * n * f / PEAK_FP32_FLOPS * 1e3)


def phase_k3_sets() -> tuple[dict, dict]:
    """K3's set form at RF_SHAPE's level shapes, for the class pairs and
    the y-moments: against its plain version (class counts bit-equal,
    moments within K3_TOL of each cell's scale), each set bit-identical to
    a one-set launch on its inputs, three reruns bit-identical; then its
    times beside the plain version's, a weighted ``torch.bincount``
    yardstick and the bound. Returns the two forms' kernel entries."""
    import numpy as np

    from euromillioner_tpu_torch.ops import fused_histogram as K
    from euromillioner_tpu_torch.trees import binning

    x, y_cls, y = rf_data()
    cuts = binning.quantile_cuts(x, RF_SHAPE["max_bins"])
    n_bins = binning.num_bins(cuts)
    binned = torch.from_numpy(binning.apply_bins(x, cuts)).cuda()
    y_cls = torch.from_numpy(y_cls).int().cuda()
    y = torch.from_numpy(y).cuda()
    n, f = binned.shape
    failures, entries, cold = [], {}, {}
    for form, line, name in (("classes", 95, "rf_class_histograms"),
                             ("moments", 183, "rf_reg_histograms")):
        worst_abs = worst_rel = 0.0
        timed = {}
        for seed, (level, nodes, which) in enumerate(RF_LEVELS):
            local, gw, hw = rf_set_inputs(y_cls, y, n, nodes, form, seed)
            sets = local.shape[0]
            want = K.fused_histogram_sets_reference(binned, local, gw, hw,
                                                    n_bins, nodes)
            scale = K.fused_histogram_sets_reference(
                binned, local, gw.abs(), hw.abs(), n_bins, nodes)
            runs = [K.fused_histogram_sets(binned, local, gw, hw, n_bins,
                                           nodes) for _ in range(3)]
            torch.cuda.synchronize()
            reruns = all(torch.equal(runs[0], r) for r in runs[1:])
            per_set = all(torch.equal(runs[0][s], K.fused_histogram(
                binned, local[s], gw[s], hw[s], n_bins, nodes))
                for s in range(sets))
            err = (runs[0].double() - want.double()).abs()
            rel = (err / scale.double().clamp_min(1e-30)).max().item()
            exact = torch.equal(runs[0], want)
            ok = reruns and per_set and (exact if form == "classes"
                                         else rel <= K3_TOL)
            print(f"K3 sets {form} level {level} ({which}, {nodes} nodes, "
                  f"{sets} sets): max_abs={err.max().item():.3e} "
                  f"rel_to_cell_scale={rel:.3e} bit-equal to plain {exact}, "
                  f"each set bit-identical to a one-set launch {per_set}, "
                  f"bit-identical reruns {reruns}; "
                  f"{k3_plan_line(n, f, n_bins, nodes, sets)}")
            if not ok:
                failures.append(f"K3 sets {form} level {level}")
            worst_abs = max(worst_abs, err.max().item())
            worst_rel = max(worst_rel, rel)
            del want, scale, runs
            ms = time_ms(lambda: K.fused_histogram_sets(
                binned, local, gw, hw, n_bins, nodes))
            plain_ms = time_ms(lambda: K.fused_histogram_sets_reference(
                binned, local, gw, hw, n_bins, nodes), warmup=1, runs=5)
            # the yardstick: one weighted bincount per stat over the flat
            # (set, node, feature, bin) index, built outside the timed call
            dev = binned.device
            flat = ((((torch.arange(sets, device=dev)[:, None] * nodes
                       + local.long()) * f)[:, :, None]
                     + torch.arange(f, device=dev)) * n_bins
                    + binned.long()[None]).reshape(-1)
            wg = gw[:, :, None].expand(sets, n, f).reshape(-1)
            wh = hw[:, :, None].expand(sets, n, f).reshape(-1)
            size = sets * nodes * f * n_bins
            library_ms = time_ms(lambda: (
                torch.bincount(flat, weights=wg, minlength=size),
                torch.bincount(flat, weights=wh, minlength=size)),
                warmup=1, runs=5)
            del flat, wg, wh
            bytes_ms, ops_ms = k3_sets_bound_ms(n, f, n_bins, nodes, sets)
            bound = max(bytes_ms, ops_ms)
            earlier_ms = NODE_TILED_K3_SETS_MS.get(f"{form}_{level}")
            timed[level] = (ms, plain_ms, library_ms, bytes_ms, ops_ms, sets)
            print(f"K3 sets timing {form} level {level} ({nodes} nodes, "
                  f"{sets} sets): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, bincount x2 {library_ms:.4f} ms, bound "
                  f"{bound:.4f} ms (bytes {bytes_ms:.4f}, operations "
                  f"{ops_ms:.4f}); "
                  f"{versus(ms, earlier_ms, library_ms, bound)}")
            if level == RF_LEVELS[-1][0]:
                cold[form] = time_cold_ms(lambda: K.fused_histogram_sets(
                    binned, local, gw, hw, n_bins, nodes))
                print(f"K3 sets timing {form} level {level} with L2 flushed "
                      f"({L2_FLUSH_BYTES >> 20} MB written between "
                      f"launches): kernel {cold[form]:.4f} ms (warm "
                      f"{ms:.4f} ms)")
            if form == "classes" and level in K3_SETS_WAYS:
                plan = K.launch_plan(n, f, n_bins, nodes, sets)
                want = K.fused_histogram_sets_reference(
                    binned, local, gw, hw, n_bins, nodes)
                if not k3_ways_line(
                        f"{form} level {level} ({nodes} nodes, {sets} sets)",
                        lambda p: K.fused_histogram_sets(
                            binned, local, gw, hw, n_bins, nodes, plan=p),
                        plan, plan._replace(**K3_SETS_WAYS[level]),
                        lambda out: torch.equal(out, want)):
                    failures.append(f"K3 sets {form} level {level} under "
                                    f"{K3_SETS_WAYS[level]}")
                del want
            torch.cuda.empty_cache()
        deepest, deepest_nodes = RF_LEVELS[-1][:2]
        ms, plain_ms, library_ms, bytes_ms, ops_ms, sets = timed[deepest]
        entries[form] = {
            "name": name, "route": "cuda",
            "source": "euromillioner_tpu_torch/csrc/fused_histogram.cu",
            "replaces": f"euromillioner_tpu/trees/random_forest.py:{line}",
            "launches": 0, "max_abs_err": worst_abs,
            "max_rel_to_cell_scale": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms, "cold_ms": cold[form],
            "timed_shape": [n, f, n_bins, deepest_nodes, sets],
            "ms_by_level": {str(k): v[0] for k, v in timed.items()}}
    failures += k3_sets_skewed()
    check(not failures, "; ".join(failures))
    return entries["classes"], entries["moments"]


def k3_sets_skewed(sets: int = 4) -> list[str]:
    """The set form at K3_SKEWED_SHAPES, each set drawn apart: within
    K3_TOL of each cell's scale from the float64 sums, each set
    bit-identical to a one-set launch, three reruns bit-identical. Returns
    the failures."""
    from euromillioner_tpu_torch.ops import fused_histogram as K

    failures = []
    for n, f, n_bins, n_nodes in K3_SKEWED_SHAPES:
        draws = [k3_skewed_inputs(n, f, n_bins, n_nodes, 100 + s)
                 for s in range(sets)]
        binned = draws[0][0]
        local, gw, hw = (torch.stack([d[i] for d in draws])
                         for i in (1, 2, 3))
        del draws
        runs = [K.fused_histogram_sets(binned, local, gw, hw, n_bins,
                                       n_nodes) for _ in range(3)]
        reruns = all(torch.equal(runs[0], r) for r in runs[1:])
        per_set = all(torch.equal(runs[0][s], K.fused_histogram(
            binned, local[s], gw[s], hw[s], n_bins, n_nodes))
            for s in range(sets))
        rel = max(((runs[0][s].double() - k3_exact(
            binned, local[s], gw[s], hw[s], n_bins, n_nodes)).abs()
            / k3_exact(binned, local[s], gw[s].abs(), hw[s].abs(), n_bins,
                       n_nodes).clamp_min(1e-30)).max().item()
            for s in range(sets))
        print(f"K3 sets skewed N={n} F={f} bins={n_bins} nodes={n_nodes} "
              f"({sets} sets): vs float64 sums rel_to_cell_scale={rel:.3e} "
              f"(tol {K3_TOL:.0e}), each set bit-identical to a one-set "
              f"launch {per_set}, bit-identical reruns {reruns}; "
              f"{k3_plan_line(n, f, n_bins, n_nodes, sets)}")
        if rel > K3_TOL or not (reruns and per_set):
            failures.append(f"K3 sets skewed at {(n, f, n_bins, n_nodes)}")
        del runs, local, gw, hw
        torch.cuda.empty_cache()
    return failures


def kernel_ms(K, run) -> float:
    """Runs ``run`` with CUDA events around every launch of kernel ``K``
    (a ``CudaKernel``, on the launching stream); returns the kernel
    milliseconds summed."""
    events = []
    launch = K.launch

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*args)
        end.record()
        events.append((start, end))

    K.launch = timed
    try:
        run()
    finally:
        del K.launch
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events)


def grow_forest(classification: bool, x, y, trees: int, device: str,
                hist_method: str = "auto"):
    """(model, wall seconds, set-form K3 launches) of one forest at
    RF_SHAPE, the launch count reset just before and read just after."""
    from euromillioner_tpu_torch.ops.fused_histogram import \
        FUSED_HISTOGRAM_SETS
    from euromillioner_tpu_torch.trees import random_forest as rf

    kw = dict(num_trees=trees, max_depth=RF_SHAPE["max_depth"],
              max_bins=RF_SHAPE["max_bins"], seed=RF_SEED,
              hist_method=hist_method, device=device)
    torch.cuda.synchronize()
    FUSED_HISTOGRAM_SETS.launches = 0
    t0 = time.perf_counter()
    if classification:
        model = rf.train_classifier(x, y, RF_SHAPE["num_classes"], **kw)
    else:
        model = rf.train_regressor(x, y, **kw)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, FUSED_HISTOGRAM_SETS.launches


def rf_timed(classification: bool, x, y, what: str) -> tuple[object, float,
                                                            int]:
    """RF_RUNS forests of RF_SHAPE on the card after one untimed, each
    with exactly one set-form K3 launch per level; returns (the first
    timed model, the median wall seconds, launches per forest)."""
    import numpy as np

    depth, trees = RF_SHAPE["max_depth"], RF_SHAPE["trees"]
    grow_forest(classification, x, y, trees, "cuda")
    runs = [grow_forest(classification, x, y, trees, "cuda")
            for _ in range(RF_RUNS)]
    walls = [r[1] for r in runs]
    wall = statistics.median(walls)
    launches = [r[2] for r in runs]
    print(f"{what} on the card ({RF_SHAPE['rows']} x "
          f"{RF_SHAPE['features']}, {trees} trees, depth {depth}): walls "
          f"{[round(w, 4) for w in walls]} s, median {wall:.4f} s, "
          f"{trees / wall:.2f} trees/s; K3 set launches {launches} "
          f"(expected {depth + 1} each)")
    check(all(n == depth + 1 for n in launches),
          f"{what}: K3 set launches {launches}, expected {depth + 1}")
    for r in runs[1:]:
        check(all(np.array_equal(runs[0][0].trees[k], r[0].trees[k])
                  for k in runs[0][0].trees), f"{what}: reruns differ")
    return runs[0][0], wall, launches[0]


def rf_cpu_trees(classification: bool, x, y, what: str) -> int:
    """The tree count of the card-vs-CPU comparison: all of RF_SHAPE's
    trees when the CPU grows them in about RF_CPU_SECONDS (timed on a
    2-tree forest), else as many as fit, at least 2."""
    _, secs, _ = grow_forest(classification, x, y, 2, "cpu")
    per_tree = secs / 2
    trees = max(2, min(RF_SHAPE["trees"], int(RF_CPU_SECONDS / per_tree)))
    print(f"{what}: a 2-tree forest takes {secs:.2f} s on the CPU; the "
          f"card-vs-CPU comparison grows {trees} of {RF_SHAPE['trees']} "
          f"trees on both" + (" (cut)" if trees < RF_SHAPE["trees"] else ""))
    return trees


def rf_breakdown(classification: bool, x, y, wall: float, what: str) -> None:
    """Where a forest's wall time goes: host binning, the host draws, and
    K3 (CUDA events around each set launch, in one more forest)."""
    from euromillioner_tpu_torch.trees import binning
    from euromillioner_tpu_torch.trees import random_forest as rf

    t0 = time.perf_counter()
    cuts = binning.quantile_cuts(x, RF_SHAPE["max_bins"])
    binning.apply_bins(x, cuts)
    t1 = time.perf_counter()
    m = rf.resolve_feature_subset("auto", x.shape[1], classification)
    rf.draw_forest(RF_SEED, RF_SHAPE["trees"], len(x), x.shape[1], m,
                   RF_SHAPE["max_depth"], True)
    t2 = time.perf_counter()
    from euromillioner_tpu_torch.ops.fused_histogram import \
        FUSED_HISTOGRAM_SETS

    k3_ms = kernel_ms(FUSED_HISTOGRAM_SETS, lambda: grow_forest(
        classification, x, y, RF_SHAPE["trees"], "cuda"))
    print(f"{what} wall {wall:.4f} s: host binning {t1 - t0:.4f} s "
          f"({(t1 - t0) / wall:.3f}), host draws {t2 - t1:.4f} s "
          f"({(t2 - t1) / wall:.3f}), K3 {k3_ms:.3f} ms "
          f"({k3_ms / 1e3 / wall:.3f}; the node-tiled design's in PERF.md: "
          f"{NODE_TILED_RF_K3_SHARE[what]}); the "
          f"rest is split finding, routing and their launches")


def phase_rf_classifier() -> dict:
    """bench.py's RF_SHAPE classifier on the card: exactly max_depth + 1
    set-form K3 launches per forest under auto and max_depth under pallas,
    trees/s and where the wall time goes; its trees bit-equal to the same
    seed's CPU forest, and auto's reachable trees bit-equal to
    pallas's. Returns the K3 launches of its main-path runs."""
    import numpy as np

    from euromillioner_tpu_torch.trees import random_forest as rf

    x, y, _ = rf_data()
    depth = RF_SHAPE["max_depth"]
    card, wall, launches = rf_timed(True, x, y, "RF classifier")
    grow_forest(True, x, y, RF_SHAPE["trees"], "cuda", "pallas")
    sub, sub_wall, sub_launches = grow_forest(True, x, y, RF_SHAPE["trees"],
                                              "cuda", "pallas")
    print(f"RF classifier, pallas (sibling subtraction): wall "
          f"{sub_wall:.4f} s, {RF_SHAPE['trees'] / sub_wall:.2f} trees/s; "
          f"K3 set launches {sub_launches} (expected {depth})")
    check(sub_launches == depth,
          f"pallas forest: K3 set launches {sub_launches}, expected {depth}")
    a, b = (rf.reachable_trees(m.trees, depth) for m in (card, sub))
    same = all(np.array_equal(a[k], b[k]) for k in a)
    same_pred = np.array_equal(card.predict(x), sub.predict(x))
    print(f"RF classifier auto vs pallas: reachable trees bit-equal {same}, "
          f"predictions on the {len(x)} rows bit-equal {same_pred}")
    check(same and same_pred, "auto and pallas grow different classifiers")
    rf_card_vs_cpu_predict(card, x, "RF classifier")
    rf_breakdown(True, x, y, wall, "RF classifier")

    trees = rf_cpu_trees(True, x, y, "RF classifier")
    ref = card if trees == RF_SHAPE["trees"] else grow_forest(
        True, x, y, trees, "cuda")[0]
    cpu, cpu_wall, _ = grow_forest(True, x, y, trees, "cpu")
    equal = {k: np.array_equal(ref.trees[k], cpu.trees[k])
             for k in ref.trees}
    print(f"RF classifier card vs CPU ({trees} trees; CPU wall "
          f"{cpu_wall:.3f} s, {trees / cpu_wall:.2f} trees/s): arrays "
          f"bit-equal {equal}")
    check(all(equal.values()), "the card's classifier differs from the CPU's")
    return {"auto": launches, "pallas": sub_launches}


def rf_reg_first_difference(got, ref, x, y, trees: int,
                            names: tuple[str, str]) -> tuple[int, int]:
    """(trees equal in reachable structure, trees whose first differing
    node is a shown near-tie) of forest ``got`` against ``ref``: at that
    node, the variance gains on the CPU from ``ref``'s rows there, with
    the seed's bootstrap weights and feature mask; the two choices' gains
    within NEAR_TIE (a leaf counts as gain 0). ``names`` label the two
    forests in the printout."""
    import numpy as np

    from euromillioner_tpu_torch.trees import binning, growth
    from euromillioner_tpu_torch.trees import random_forest as rf

    depth, n_bins = RF_SHAPE["max_depth"], binning.num_bins(ref.cuts)
    a, b = (rf.reachable_trees(m.trees, depth) for m in (got, ref))
    m = rf.resolve_feature_subset("auto", x.shape[1], False)
    boot, masks = rf.draw_forest(RF_SEED, trees, len(x), x.shape[1], m,
                                 depth, True)
    binned = torch.from_numpy(binning.apply_bins(x, ref.cuts))
    yt = torch.from_numpy(y)
    equal = ties = 0
    for t in range(trees):
        cols = [(a[k][t], b[k][t]) for k in ("is_leaf", "feature",
                                              "split_bin")]
        node = next((i for i in range(len(cols[0][0]))
                     if any(u[i] != v[i] for u, v in cols)), None)
        if node is None:
            equal += 1
            continue
        d = int(np.log2(node + 1))
        tree = {k: torch.from_numpy(ref.trees[k][t]) for k in ref.trees}
        at = growth.route(binned, tree["feature"], tree["split_bin"],
                          tree["is_leaf"], max_depth=d) == node
        # one set on CPU tensors: K3's plain version, the node's rows
        # weighted by the tree's bootstrap
        s, s2, c = (h[0] for h in rf.reg_histograms_sets(
            binned, yt, torch.zeros((1, len(x)), dtype=torch.int32),
            (boot[t] * at.float())[None], 1, n_bins))
        mask = masks[d][t, node - ((1 << d) - 1)][None]
        gains = rf.variance_splits(s, s2, c, mask)[0]

        def gain(arr):
            if arr["is_leaf"][t][node]:
                return 0.0
            return float(gains[arr["feature"][t][node],
                               arr["split_bin"][t][node]])
        ga, gb = gain(a), gain(b)
        tie = abs(ga - gb) <= NEAR_TIE * max(abs(ga), abs(gb))
        print(f"RF regressor tree {t} node {node} differs: variance gains "
              f"{names[0]} {ga!r} {names[1]} {gb!r}: near-tie (within "
              f"{NEAR_TIE:.0e}) {tie}")
        ties += tie
    return equal, ties


def rf_leaf_gap(got, ref, trees: int, reachable: bool = False) -> float:
    """The largest leaf-mean difference over the trees whose structure is
    identical, relative to ``ref``'s largest leaf magnitude (the
    reachable form of both when ``reachable``)."""
    import numpy as np

    from euromillioner_tpu_torch.trees import random_forest as rf

    a, b = got.trees, ref.trees
    if reachable:
        a, b = (rf.reachable_trees(m.trees, RF_SHAPE["max_depth"])
                for m in (got, ref))
    same = [t for t in range(trees)
            if all(np.array_equal(a[k][t], b[k][t])
                   for k in ("is_leaf", "feature", "split_bin"))]
    if not same:
        return 0.0
    return (max(float(np.max(np.abs(a["leaf_value"][t]
                                    - b["leaf_value"][t]))) for t in same)
            / max(float(np.max(np.abs(b["leaf_value"]))), 1e-30))


def rf_card_vs_cpu_predict(card, x, what: str) -> None:
    """The card forest's predictions on RF_SHAPE's rows against the same
    trees loaded on the CPU: routing, the vote or the mean on each device.
    A classifier's are bit-equal; a regressor's within RF_REG_PRED_ULPS
    ulps of the largest prediction."""
    import numpy as np

    from euromillioner_tpu_torch.trees import RandomForestModel

    cpu = RandomForestModel(card.cuts, card.trees, card.max_depth,
                            card.classification, card.num_classes,
                            device="cpu")
    got, want = card.predict(x), cpu.predict(x)
    if card.classification:
        same = np.array_equal(got, want)
        print(f"{what}: predictions of the card's forest on the card and on "
              f"the CPU, {len(x)} rows: bit-equal {same}")
        check(same, f"{what}: card and CPU predictions differ")
        return
    gap = float(np.max(np.abs(got - want)))
    pin = RF_REG_PRED_ULPS * float(np.spacing(np.max(np.abs(want))))
    print(f"{what}: predictions of the card's forest on the card and on the "
          f"CPU, {len(x)} rows: bit-equal {np.array_equal(got, want)}, "
          f"largest gap {gap!r} (pin {RF_REG_PRED_ULPS} ulp = {pin!r})")
    check(got.dtype == want.dtype and gap <= pin,
          f"{what}: card and CPU predictions differ by {gap!r}")


def phase_rf_regressor() -> dict:
    """The regressor at RF_SHAPE on the card: exactly max_depth + 1 K3
    set launches per forest under auto and max_depth under pallas,
    trees/s; pallas's reachable trees equal to auto's or a shown
    near-tie; the card forest's predictions against the same trees on
    the CPU; against the same seed's CPU forest, each tree equal in
    structure or a shown near-tie, and the leaf means of equal trees
    within RF_REG_LEAF_TOL. Returns the K3 launches of its main-path
    runs."""
    x, _, y = rf_data()
    depth, n_trees = RF_SHAPE["max_depth"], RF_SHAPE["trees"]
    card, wall, launches = rf_timed(False, x, y, "RF regressor")
    grow_forest(False, x, y, n_trees, "cuda", "pallas")
    sub, sub_wall, sub_launches = grow_forest(False, x, y, n_trees, "cuda",
                                              "pallas")
    print(f"RF regressor, pallas (sibling subtraction): wall "
          f"{sub_wall:.4f} s, {n_trees / sub_wall:.2f} trees/s; K3 set "
          f"launches {sub_launches} (expected {depth})")
    check(sub_launches == depth,
          f"pallas regressor: K3 set launches {sub_launches}, expected "
          f"{depth}")
    equal, ties = rf_reg_first_difference(sub, card, x, y, n_trees,
                                          ("pallas", "auto"))
    leaf = rf_leaf_gap(sub, card, n_trees, reachable=True)
    print(f"RF regressor pallas vs auto on the card: {equal} of {n_trees} "
          f"trees equal in reachable structure, {ties} of the other "
          f"{n_trees - equal} a near-tie at their first difference; leaf "
          f"means of the identical trees within {leaf:.3e} of the largest "
          f"(tol {RF_SUB_LEAF_TOL:.0e})")
    check(equal + ties == n_trees,
          "pallas and auto grow different regressors without a near-tie")
    check(leaf <= RF_SUB_LEAF_TOL, f"pallas vs auto leaf means differ by "
          f"{leaf:.3e}")
    rf_card_vs_cpu_predict(card, x, "RF regressor")
    rf_breakdown(False, x, y, wall, "RF regressor")
    trees = rf_cpu_trees(False, x, y, "RF regressor")
    ref = card if trees == n_trees else grow_forest(
        False, x, y, trees, "cuda")[0]
    cpu, cpu_wall, _ = grow_forest(False, x, y, trees, "cpu")
    equal, ties = rf_reg_first_difference(ref, cpu, x, y, trees,
                                          ("card", "cpu"))
    leaf = rf_leaf_gap(ref, cpu, trees)
    print(f"RF regressor card vs CPU ({trees} trees; CPU wall "
          f"{cpu_wall:.3f} s): {equal} trees equal in reachable structure, "
          f"{ties} of the other {trees - equal} a near-tie at their first "
          f"difference; leaf means of the identical trees within "
          f"{leaf:.3e} of the largest (tol {RF_REG_LEAF_TOL:.0e})")
    check(equal + ties == trees, "the card's regressor differs from the "
          "CPU's without a near-tie")
    check(leaf <= RF_REG_LEAF_TOL, f"leaf means differ by {leaf:.3e}")
    return {"auto": launches, "pallas": sub_launches}


def tree_serve_cli(family: str, model: Path) -> None:
    """``serve --model-type gbt|rf --model-file M --smoke 32`` on the card:
    no failed request, every reply bit-equal to the backend's direct
    predict of the same rows."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config
    from euromillioner_tpu_torch.serve.session import load_backend
    from euromillioner_tpu_torch.serve.transport import row_payloads

    rc, out = wd_cli(["serve", "--model-type", family, "--model-file",
                      str(model), "--smoke", str(SMOKE_REQUESTS)])
    check(rc == 0, f"serve --model-type {family} exited {rc}")
    summary = json.loads(out.strip().splitlines()[-1])
    stats = summary["stats"]
    print(f"serve {family}: {summary['ok']} of {summary['requests']} ok, "
          f"{stats['batches']} batches, p50 {stats['p50_ms']} ms, p99 "
          f"{stats['p99_ms']} ms")
    check(summary["failed"] == 0, f"{family} serve: requests failed")
    backend = load_backend(family, cfg=Config(), model_file=str(model))
    rows = np.concatenate([np.asarray(r, np.float32) for r in row_payloads(
        SMOKE_REQUESTS, backend.feat_shape)])
    want = backend.predict(rows)
    got = np.asarray([p[0] for p in summary["predictions"]],
                     backend.out_dtype)
    same = np.array_equal(got, want)
    print(f"serve {family}: replies bit-equal to a direct predict {same}")
    check(same, f"{family} serve replies differ from predict")


def phase_rf_cli(root: Path, out: Path) -> int:
    """``train --model rf --num-classes 6 --save`` at the defaults (100
    trees, depth 8) on the golden page through the CLI (returns its K3 set
    launches, reset just before), ``predict --model-type rf`` bit-equal to
    RandomForestModel.predict, then ``serve --model-type rf`` on that
    model and ``serve --model-type gbt`` on phase 12's booster."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config
    from euromillioner_tpu_torch.data.csvio import read_csv
    from euromillioner_tpu_torch.ops.fused_histogram import \
        FUSED_HISTOGRAM_SETS
    from euromillioner_tpu_torch.trees import RandomForestModel

    csv, model = out / "draws.csv", out / "rf.json"
    cfg = Config()
    FUSED_HISTOGRAM_SETS.launches = 0
    t0 = time.perf_counter()
    rc, _ = wd_cli(["train", "--model", "rf", "--num-classes", "6",
                    "--html-file", str(root / GOLDEN_HTML), "--save",
                    str(model)])
    wall = time.perf_counter() - t0
    launches = FUSED_HISTOGRAM_SETS.launches
    want = cfg.forest.max_depth + 1
    print(f"CLI train --model rf --num-classes 6 ({cfg.forest.num_trees} "
          f"trees, depth {cfg.forest.max_depth}, 3 class pairs: "
          f"{3 * cfg.forest.num_trees} sets a launch): exit {rc}, wall "
          f"{wall:.3f} s, K3 set launches {launches} (expected {want})")
    check(rc == 0, f"train --model rf exited {rc}")
    check(launches == want, f"K3 set launches {launches}, expected {want}")
    rc, printed = wd_cli(["predict", "--model-type", "rf", "--model-file",
                          str(model), "--csv", str(csv), "--has-label"])
    check(rc == 0, f"predict --model-type rf exited {rc}")
    got = np.asarray([int(v) for v in printed.split()], np.int32)
    x, _, _ = read_csv(str(csv), label_column=0)
    ref = RandomForestModel.load_model(str(model)).predict(x)
    same = got.shape == ref.shape and np.array_equal(got, ref)
    print(f"CLI predict --model-type rf on {len(got)} rows: bit-equal to "
          f"RandomForestModel.predict {same}")
    check(same, "CLI rf predictions differ from RandomForestModel.predict")
    tree_serve_cli("rf", model)
    tree_serve_cli("gbt", out / "gbt.json")
    return launches


# -- the Wide&Deep path (K4a, K4b) ---------------------------------------------

def bench_rows(b: int, seed: int = 0):
    """bench.py's Wide&Deep rows (``_bench_wide_deep``): numpy seed 0;
    dow, month, day, year 2004-2020, five balls 1-50, two stars 1-12."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.stack([rng.integers(1, 8, b), rng.integers(1, 13, b),
                  rng.integers(1, 29, b), rng.integers(2004, 2021, b)], 1),
        rng.integers(1, 51, size=(b, 5)), rng.integers(1, 13, size=(b, 2)),
    ], axis=1).astype(np.float32)


def k4_inputs(b: int, k: int, v: int, e: int, dtype):
    """One shape's K4 inputs on the card: at full width the pair codes of
    bench.py's rows (what the model hands the kernels), else uniform ids
    with a few outside [0, V); a seeded table and cotangent."""
    import numpy as np

    from euromillioner_tpu_torch.models.wide_deep import WideDeep

    gen = torch.Generator(device="cuda").manual_seed(SEED + b + e)
    w = (0.01 * torch.randn((k, v, e), generator=gen, device="cuda")).to(
        dtype)
    dh = torch.randn((b, e), generator=gen, device="cuda").to(dtype)
    if (k, v) == (21, 4096):
        codes = WideDeep(wide_embed_dim=8, embed_dim=8, hidden_sizes=(8,),
                         device="cpu")  # ball_vocab 64: 21 x 4096 pair codes
        ids = codes._cross_ids(torch.from_numpy(bench_rows(b)))[1]
    else:
        rng = np.random.default_rng(b + e)
        raw = rng.integers(-2, v + 2, size=(b, k)).astype(np.int32)
        ids = torch.from_numpy(raw)
    return w, ids.contiguous().cuda(), dh


def k4_bound_ms(ids, w, dh) -> dict:
    """Bytes and operations bounds (ms) of both kernels on these inputs:
    K4a reads the ids and the distinct table rows they name and writes
    (B, E) f32; K4b reads the ids and dH and writes the dense (K, V, E)
    block; one f32 add per element either way."""
    b, k = ids.shape
    _, v, e = w.shape
    it = w.element_size()
    valid = (ids >= 0) & (ids < v)
    flat = (ids.long() + torch.arange(k, device=ids.device) * v)[valid]
    rows = int(torch.unique(flat).numel())
    adds = int(valid.sum()) * e
    fwd = 4 * b * k + rows * e * it + 4 * b * e
    dw = 4 * b * k + b * e * it + k * v * e * it
    ops_ms = adds / PEAK_FP32_FLOPS * 1e3
    return {"fwd": (fwd / PEAK_HBM_BYTES_S * 1e3, ops_ms),
            "dw": (dw / PEAK_HBM_BYTES_S * 1e3, ops_ms)}


def k4_raw_calls(w, ids, dh, v: int) -> dict:
    """Zero-argument calls that launch K4a, K4b and K4b's parts (``sort``:
    count, scan and place — with ``count`` alone when it is a kernel of its
    own; ``write``: the row writer) through their C entry
    points on outputs and scratch made here, each launch counted as any
    other; ``plans`` holds the two plans."""
    from euromillioner_tpu_torch.ops import wide_onehot as K

    b, k = ids.shape
    e = w.shape[2]
    out = torch.empty((b, e), dtype=torch.float32, device="cuda")
    dw = torch.empty((k, v, e), dtype=dh.dtype, device="cuda")
    fplan = K.fwd_plan(w.dtype, b, k, v, e,
                       K._vec(e, w.element_size(), w, out))
    dplan = K.dw_plan(dh.dtype, b, k, v, e,
                      K._vec(e, dh.element_size(), dh, dw))
    scratch = torch.empty(dplan.scratch, dtype=torch.int32, device="cuda")
    fargs = K._fwd_args(fplan, w, ids, out)
    calls = {"fwd": lambda: K.WIDE_ONEHOT_FWD.launch(*fargs),
             "plans": (fplan, dplan), "_keep": (out, dw, scratch)}
    parts = {"dw": K.DW_ALL, "sort": K.DW_SORT, "write": K.DW_WRITE}
    if not dplan.one_block:  # the sort's count kernel alone
        parts["count"] = K.DW_COUNT
    for name, part in parts.items():
        args = K._dw_args(dplan, ids, dh, dw, scratch, part)
        calls[name] = (lambda a=args: K.WIDE_ONEHOT_DW.launch(*a))
    return calls


def k4a_ways_line(w, ids, raw: dict) -> None:
    """K4a on the device under each way of FWD_WAYS (how many batch rows a
    thread walks the positions with, how many positions' loads it issues
    before their adds) beside the plan's, each bit-equal to the plan's
    output; prints one line, fails on a difference."""
    from euromillioner_tpu_torch.ops import wide_onehot as K

    b, k = ids.shape
    _, v, e = w.shape
    chosen = raw["plans"][0]
    want = K.wide_onehot_fwd(w, ids)
    out = torch.empty_like(want)
    times, same = {}, True
    for rows, group in K.FWD_WAYS:
        plan = K.fwd_plan(w.dtype, b, k, v, e, chosen.vec, rows=rows,
                          group=group)
        args = K._fwd_args(plan, w, ids, out)
        times[rows, group] = device_ms(
            lambda: K.WIDE_ONEHOT_FWD.launch(*args), K4_DEVICE_LAUNCHES)
        torch.cuda.synchronize()
        same = same and torch.equal(out, want)
    print(f"K4a ways B={b} {str(w.dtype)[6:]}: on the device, (rows per "
          f"thread, positions loaded at once) "
          + ", ".join(f"{r}x{g}: {t:.4f} ms" for (r, g), t in times.items())
          + f"; the plan takes {chosen.rows}x{chosen.group}; every way "
          f"bit-equal {same}")
    check(same, f"K4a ways differ at B={b}")


def phase_k4() -> tuple[dict, dict]:
    """K4a and K4b against their plain versions in f32 and bf16 at the
    paths' shapes and at K4_F6_SHAPE, three reruns bit-identical, each
    shape with its two launch plans; then, at the paths' shapes, times
    beside the plain versions', the library yardsticks' and the bounds:
    per call (CUDA events around one wrapper call), on the device alone
    (K4_DEVICE_LAUNCHES launches in a CUDA graph), K4b's sort and row
    writer apart, and at bench.py's batch with the L2 flushed."""
    from euromillioner_tpu_torch.ops import wide_onehot as K

    for ln in K.WIDE_ONEHOT_FWD.build_log.splitlines():
        if any(w in ln for w in ("entry function", "registers", "spill")):
            print(f"K4 ptxas: {ln.strip()}")
    failures = []
    worst = {"fwd": 0.0, "dw": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, k, v, e in K4_SHAPES + (K4_F6_SHAPE,):
            w, ids, dh = k4_inputs(b, k, v, e, dtype)
            fplan = K.fwd_plan(dtype, b, k, v, e)
            dplan = K.dw_plan(dtype, b, k, v, e)
            print(f"K4 plans B={b} K={k} V={v} E={e} {str(dtype)[6:]}: K4a "
                  f"{fplan._asdict()}; K4b {dplan._asdict()}")
            want_f = K.wide_onehot_fwd_reference(w, ids)
            scale_f = K.wide_onehot_fwd_reference(w.abs(), ids)
            cpu_ids, cpu_dh = ids.cpu(), dh.cpu()
            want_d = K.wide_onehot_dw_reference(cpu_ids, cpu_dh, v).float()
            scale_d = K.wide_onehot_dw_reference(
                cpu_ids, cpu_dh.float().abs(), v)
            torch.cuda.synchronize()
            fwd = [K.wide_onehot_fwd(w, ids) for _ in range(3)]
            dw = [K.wide_onehot_dw(ids, dh, v) for _ in range(3)]
            torch.cuda.synchronize()
            for name, runs, want, scale in (
                    ("K4a", fwd, want_f, scale_f),
                    ("K4b", dw, want_d.cuda(), scale_d.cuda())):
                err = (runs[0].double() - want.double()).abs()
                rel = (err / scale.double().clamp_min(1e-30)).max().item()
                same = all(torch.equal(runs[0], r) for r in runs[1:])
                exact = torch.equal(runs[0].float(), want.float())
                print(f"{name} B={b} K={k} V={v} E={e} {str(dtype)[6:]}: "
                      f"max_abs={err.max().item():.3e} rel_to_scale={rel:.3e}"
                      f" (tol {K4_TOL:.0e}), bit-equal to plain {exact}, "
                      f"bit-identical reruns {same}")
                if rel > K4_TOL or not same:
                    failures.append(f"{name} at {(b, k, v, e)} {dtype}: rel "
                                    f"{rel:.3e}, reruns equal {same}")
                key = "fwd" if name == "K4a" else "dw"
                worst[key] = max(worst[key], err.max().item())
                del err
            del w, ids, dh, fwd, dw, want_f, scale_f, want_d, scale_d
            torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    flush_ms = device_ms(lambda: flush.fill_(1.0), K4_DEVICE_LAUNCHES)
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, k, v, e in K4_SHAPES[:-1]:
            w, ids, dh = k4_inputs(b, k, v, e, dtype)
            raw = k4_raw_calls(w, ids, dh, v)
            fwd_ms = time_ms(lambda: K.wide_onehot_fwd(w, ids))
            fwd_plain = time_ms(lambda: K.wide_onehot_fwd_reference(w, ids))
            dw_ms = time_ms(lambda: K.wide_onehot_dw(ids, dh, v))
            dw_plain = time_ms(lambda: K.wide_onehot_dw_reference(ids, dh, v))
            dev = {key: device_ms(raw[key], K4_DEVICE_LAUNCHES)
                   for key in ("fwd", "dw", "sort", "write", "count")
                   if key in raw}
            sort_parts = (f"count {dev['count']:.4f}, scan and place "
                          f"{dev['sort'] - dev['count']:.4f}"
                          if "count" in dev else "one block per position")
            flushed = {}
            if b == WD_BENCH["batch"]:
                k4a_ways_line(w, ids, raw)
                for key in ("fwd", "dw"):
                    flushed[key] = device_ms(
                        lambda: (flush.fill_(1.0), raw[key]()),
                        K4_DEVICE_LAUNCHES) - flush_ms
            # yardsticks, built outside the timed calls: one embedding_bag
            # over the ids offset into the flat (K*V, E) table, and one
            # index_add_ of dH's rows into a zeroed f32 (K*V, E) + the cast
            flat = (ids.long() + torch.arange(k, device="cuda") * v)
            table = w.view(k * v, e)
            src = dh.float()[:, None, :].expand(b, k, e).reshape(b * k, e)
            idx = flat.reshape(-1)
            fwd_lib = time_ms(lambda: torch.nn.functional.embedding_bag(
                flat, table, mode="sum"))
            dw_lib = time_ms(lambda: torch.zeros(
                (k * v, e), device="cuda").index_add_(0, idx, src).to(dtype))
            bounds = k4_bound_ms(ids, w, dh)
            timed[b, str(dtype)[6:]] = {
                "fwd": (fwd_ms, fwd_plain, fwd_lib, *bounds["fwd"],
                        dev["fwd"], flushed.get("fwd")),
                "dw": (dw_ms, dw_plain, dw_lib, *bounds["dw"], dev["dw"],
                       flushed.get("dw"))}
            for name, key in (("K4a", "fwd"), ("K4b", "dw")):
                (ms, plain, lib, bytes_ms, ops_ms, d_ms,
                 cold) = timed[b, str(dtype)[6:]][key]
                bound = max(bytes_ms, ops_ms)
                print(f"{name} timing B={b} K={k} V={v} E={e} "
                      f"{str(dtype)[6:]}: kernel {ms:.4f} ms per call, "
                      f"{d_ms:.4f} ms on the device ({K4_DEVICE_LAUNCHES} "
                      f"launches in a CUDA graph; {bound / d_ms:.3f} of the "
                      f"bound)"
                      + (f", {cold:.4f} ms with the L2 flushed"
                         if cold is not None else "")
                      + (f" [sort {dev['sort']:.4f} ms ({sort_parts}), "
                         f"row writer {dev['write']:.4f} ms]"
                         if key == "dw" else "")
                      + f"; plain {plain:.4f} ms, library {lib:.4f} ms, "
                      f"bound {bound:.4f} ms (bytes {bytes_ms:.4f}, "
                      f"operations {ops_ms:.4f})")
            del w, ids, dh, raw, src, flat, table, idx
            torch.cuda.empty_cache()

    def entry(name, key, source_line):
        (ms, plain, lib, bytes_ms, ops_ms, d_ms,
         _) = timed[K4_TIMED_B, "bfloat16"][key]
        return {"name": name, "route": "cuda",
                "source": "euromillioner_tpu_torch/csrc/wide_onehot.cu",
                "replaces": f"euromillioner_tpu/ops/wide_onehot.py:"
                            f"{source_line}",
                "launches": 0, "max_abs_err": worst[key], "ms": ms,
                "device_ms": d_ms,
                "plain_ms": plain, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                "library_ms": lib,
                "timed_shape": [K4_TIMED_B, 21, 4096, 1040, "bfloat16"],
                "ms_by_shape": {f"{b}x21x4096x1040 {dt}": t[key][0]
                                for (b, dt), t in timed.items()},
                "device_ms_by_shape": {f"{b}x21x4096x1040 {dt}": t[key][5]
                                       for (b, dt), t in timed.items()}}

    return (entry("wide_onehot_fwd", "fwd", 86),
            entry("wide_onehot_dw", "dw", 97))


# K4a/K4b at the tensor-parallel shard widths of the 100M table (phase
# 36): E/2 = 520 (TP-2 training, serving on 1x2) and E/4 = 260 (serving on
# 1x4), each shard a table of its own; at the training batch and bench.py's
# B=8192, in both dtypes. Held to the plain versions at K4_TOL, reruns
# bit-identical, and timed with their bounds and library yardsticks.
K4_SHARD_SHAPES = tuple((b, 21, 4096, e) for e in (520, 260)
                        for b in (64, 8192))


def phase_k4_shards() -> dict:
    """Phase 13 at the shard widths (K4_SHARD_SHAPES): per kernel, each
    (width, batch, dtype)'s per-call time, plain version's and library
    yardstick's times, bound and launch plan."""
    from euromillioner_tpu_torch.ops import wide_onehot as K

    failures, timed = [], {"fwd": {}, "dw": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for b, k, v, e in K4_SHARD_SHAPES:
            w, ids, dh = k4_inputs(b, k, v, e, dtype)
            fplan = K.fwd_plan(dtype, b, k, v, e)
            dplan = K.dw_plan(dtype, b, k, v, e)
            want_f = K.wide_onehot_fwd_reference(w, ids)
            scale_f = K.wide_onehot_fwd_reference(w.abs(), ids)
            want_d = K.wide_onehot_dw_reference(ids.cpu(), dh.cpu(), v)
            scale_d = K.wide_onehot_dw_reference(ids.cpu(),
                                                 dh.cpu().float().abs(), v)
            fwd = [K.wide_onehot_fwd(w, ids) for _ in range(3)]
            dw = [K.wide_onehot_dw(ids, dh, v) for _ in range(3)]
            torch.cuda.synchronize()
            errs = {}
            for key, runs, want, scale in (
                    ("fwd", fwd, want_f, scale_f),
                    ("dw", dw, want_d.float().cuda(), scale_d.cuda())):
                err = (runs[0].double() - want.double()).abs()
                rel = (err / scale.double().clamp_min(1e-30)).max().item()
                same = all(torch.equal(runs[0], r) for r in runs[1:])
                errs[key] = (err.max().item(), rel, same,
                             torch.equal(runs[0].float(), want.float()))
                if rel > K4_TOL or not same:
                    failures.append(f"{key} at {(b, k, v, e)} {dtype}")
            flat = ids.long() + torch.arange(k, device="cuda") * v
            table = w.view(k * v, e)
            src = dh.float()[:, None, :].expand(b, k, e).reshape(b * k, e)
            idx = flat.reshape(-1)
            times = {
                "fwd": (time_ms(lambda: K.wide_onehot_fwd(w, ids)),
                        time_ms(lambda: K.wide_onehot_fwd_reference(w, ids)),
                        time_ms(lambda: torch.nn.functional.embedding_bag(
                            flat, table, mode="sum"))),
                "dw": (time_ms(lambda: K.wide_onehot_dw(ids, dh, v)),
                       time_ms(lambda: K.wide_onehot_dw_reference(ids, dh,
                                                                  v)),
                       time_ms(lambda: torch.zeros(
                           (k * v, e), device="cuda").index_add_(
                           0, idx, src).to(dtype)))}
            bounds = k4_bound_ms(ids, w, dh)
            dt = str(dtype)[6:]
            for name, key, plan in (("K4a", "fwd", fplan),
                                    ("K4b", "dw", dplan)):
                ms, plain, lib = times[key]
                bytes_ms, ops_ms = bounds[key]
                abs_err, rel, same, exact = errs[key]
                timed[key][f"{e} B={b} {dt}"] = {
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": ("bytes" if bytes_ms > ops_ms
                                 else "operations"),
                    "max_abs_err": abs_err}
                card(f"{name} shard width E={e} B={b} {dt}: plan "
                     f"{plan._asdict()}; max_abs={abs_err:.3e} "
                     f"rel_to_scale={rel:.3e} (tol {K4_TOL:.0e}), bit-equal "
                     f"to plain {exact}, reruns identical {same}; kernel "
                     f"{ms:.4f} ms per call, plain {plain:.4f} ms, library "
                     f"{lib:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
                     f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f})")
            del w, ids, dh, fwd, dw, want_f, scale_f, want_d, scale_d, src
            torch.cuda.empty_cache()
    check(not failures, "K4 at the shard widths: " + "; ".join(failures))
    return timed


def wd_cli(argv: list[str]) -> tuple[int, str]:
    """One in-process CLI call; (exit code, its stdout)."""
    from euromillioner_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def wd_serve_cli(ckdir: Path, requests: int, extra: tuple = ()
                 ) -> tuple[dict, int]:
    """``serve --model-type wide_deep --smoke N`` (with ``extra``
    overrides) on the card; returns the summary and K4a's launches during
    it (reset just before)."""
    from euromillioner_tpu_torch.ops.wide_onehot import (WIDE_ONEHOT_DW,
                                                         WIDE_ONEHOT_FWD)

    WIDE_ONEHOT_FWD.launches = WIDE_ONEHOT_DW.launches = 0
    rc, out = wd_cli(["serve", "--model-type", "wide_deep", "--checkpoint",
                      str(ckdir), "--smoke", str(requests), *extra])
    launches = WIDE_ONEHOT_FWD.launches
    check(rc == 0, f"serve --model-type wide_deep {' '.join(extra)} "
                   f"exited {rc}")
    check(WIDE_ONEHOT_DW.launches == 0, "serving launched K4b")
    summary = json.loads(out.strip().splitlines()[-1])
    shown = {k: v for k, v in summary.items() if k != "predictions"}
    print(f"serve wide_deep {' '.join(extra)}: {json.dumps(shown)}")
    check(summary["failed"] == 0, "wide_deep serve: requests failed")
    got = torch.tensor(summary["predictions"])
    check(tuple(got.shape) == (requests, 1, OUTPUTS), "reply shapes")
    check(bool(torch.isfinite(got).all()), "non-finite replies")
    return summary, launches


def phase_wd_serve(root: Path) -> tuple[int, Path]:
    """The serving main path at full width: a seeded Wide&Deep (100M) as a
    TrainState checkpoint, served through the CLI; then bench.py's rows
    through the engine against direct predicts. Returns K4a's launches in
    the CLI run and the checkpoint (phase_wd_tiers serves it again)."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config
    from euromillioner_tpu_torch.core.precision import rel_error
    from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
    from euromillioner_tpu_torch.serve.engine import make_row_engine
    from euromillioner_tpu_torch.serve.session import load_backend
    from euromillioner_tpu_torch.train.checkpoint import save_checkpoint
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    model = build_wide_deep(generator=torch.Generator().manual_seed(SEED),
                            device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    ckdir = root / "build" / "chip_smoke" / "wd"
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(str(ckdir), Trainer(model, adam(1e-3)).init_state(),
                    step=0)
    print(f"wide_deep: {n_params:,} parameters (E={model.wide_embed_dim}); "
          f"TrainState checkpoint written in {time.perf_counter() - t0:.2f} s")
    del model
    torch.cuda.empty_cache()

    summary, launches = wd_serve_cli(ckdir, WD_SMOKE_REQUESTS)
    cfg = Config()
    want = summary["stats"]["batches"] + (
        len(cfg.serve.buckets) if cfg.serve.warmup else 0)
    print(f"serve wide_deep: K4a launches {launches} (expected "
          f"{summary['stats']['batches']} batches + "
          f"{len(cfg.serve.buckets)} bucket warmups = {want})")
    check(launches >= 1, "the wide_deep serve never launched K4a")
    check(launches == want, f"K4a launched {launches} times, expected {want}")

    backend = load_backend("wide_deep", str(ckdir), cfg)
    rows = bench_rows(max(cfg.serve.buckets))
    engine = make_row_engine(backend, cfg)
    try:
        for b in cfg.serve.buckets:
            got = engine.predict(rows[:b])
            same = np.array_equal(got, backend.predict(rows[:b]))
            print(f"serve wide_deep engine vs direct predict, one request "
                  f"of {b} rows (bucket {b}): bit-equal {same}")
            check(same, f"engine reply differs from predict at bucket {b}")
        futures = [engine.submit(r) for r in rows[:WD_SMOKE_REQUESTS]]
        single = np.concatenate([f.result() for f in futures])
        stats = engine.stats()
    finally:
        engine.close()
    direct = backend.predict(rows[:WD_SMOKE_REQUESTS])
    err = rel_error(single, direct)
    print(f"serve wide_deep: {WD_SMOKE_REQUESTS} single-row requests in "
          f"{stats['batches']} batches vs one direct predict: rel {err:.3e} "
          f"(tol {WD_CROSS_SHAPE_TOL:.0e}); p50 {stats['p50_ms']} ms, p99 "
          f"{stats['p99_ms']} ms")
    check(bool(np.isfinite(single).all()), "non-finite engine replies")
    check(err <= WD_CROSS_SHAPE_TOL, "engine replies outside the tolerance")
    del backend
    torch.cuda.empty_cache()
    return launches, ckdir


def wd_golden_frames(root: Path):
    """The training path's (train, test) Datasets, as ``cli train --model
    wide_deep`` frames them: each full row predicts the next row's balls."""
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.data.pipeline import pipeline_from_html

    tr, va = pipeline_from_html((root / GOLDEN_HTML).read_text())
    out = []
    for ds in (tr, va):
        full = ds.full_rows()
        out.append(Dataset(x=full[:-1], y=full[1:, 4:11]))
    return tuple(out)


def phase_wd_train(root: Path) -> tuple[int, int]:
    """The training main path at full width through the CLI (defaults:
    B=64, bf16 towers, Adam), then ``serve --smoke 8`` on its checkpoint.
    Returns K4a's and K4b's launches in the train run."""
    from euromillioner_tpu_torch.config import DataConfig
    from euromillioner_tpu_torch.ops.wide_onehot import (WIDE_ONEHOT_DW,
                                                         WIDE_ONEHOT_FWD)

    out = root / "build" / "chip_smoke"
    ckdir, jsonl = out / "wd_train", out / "wd_train.jsonl"
    shutil.rmtree(ckdir, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    jsonl.unlink(missing_ok=True)
    WIDE_ONEHOT_FWD.launches = WIDE_ONEHOT_DW.launches = 0
    t0 = time.perf_counter()
    rc, _ = wd_cli(["train", "--model", "wide_deep", "--html-file",
                    str(root / GOLDEN_HTML), f"train.epochs={TRAIN_EPOCHS}",
                    f"train.metrics_jsonl={jsonl}", "--save", str(ckdir)])
    wall = time.perf_counter() - t0
    k4a, k4b = WIDE_ONEHOT_FWD.launches, WIDE_ONEHOT_DW.launches
    check(rc == 0, f"train --model wide_deep exited {rc}")
    records = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    rounds = [r for r in records if "round" in r]
    for r in rounds:
        print(f"wide_deep train watch line [{r['round']}]: train-rmse "
              f"{r['train-rmse']:.6f} test-rmse {r['test-rmse']:.6f}")
    check(len(rounds) == TRAIN_EPOCHS, f"{len(rounds)} watch lines")
    check(all(math.isfinite(r[k]) for r in rounds
              for k in ("train-rmse", "test-rmse")), "non-finite rmse")
    train_ds, test_ds = wd_golden_frames(root)
    batch = DataConfig().batch_size
    steps = -(-len(train_ds) // batch)
    evals = steps + -(-len(test_ds) // batch)
    want_b = steps * TRAIN_EPOCHS
    want_a = want_b + evals * TRAIN_EPOCHS
    print(f"wide_deep train: {len(train_ds)} rows -> {steps} steps/epoch of "
          f"B={batch}; K4b launches {k4b} (expected {steps} x {TRAIN_EPOCHS} "
          f"= {want_b}); K4a launches {k4a} (expected {want_b} + {evals} "
          f"watch chunks x {TRAIN_EPOCHS} = {want_a}); CLI wall {wall:.2f} s")
    check(k4b == want_b, f"K4b launched {k4b} times, expected {want_b}")
    check(k4a == want_a, f"K4a launched {k4a} times, expected {want_a}")
    stats = [r for r in records if r.get("event") == "fit_summary"][0]
    print(f"wide_deep train timing (device-synchronised steps, "
          f"{stats['steps']} timed): {stats['mean_step_ms']:.4f} ms/step, "
          f"{stats['examples_per_sec']:.1f} examples/s")
    summary, launches = wd_serve_cli(ckdir, WD_TRAIN_SMOKE_REQUESTS)
    print(f"serve trained wide_deep checkpoint: K4a launches {launches}")
    check(launches > 0, "serving the trained checkpoint never launched K4a")
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return k4a, k4b


def phase_wd_step(root: Path) -> None:
    """One full-width training step on the card against the same step on
    the CPU, from the same params and batch: f32 towers, then the CLI's
    bf16 towers. Both are measured and printed before either is checked."""
    from euromillioner_tpu_torch.core.precision import Precision, rel_error
    from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    train_ds, _ = wd_golden_frames(root)
    host_batch = next(iter(train_ds.batches(64)))
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        tol = WD_STEP_TOL[name]
        results, params = {}, None
        for device in ("cpu", "cuda"):
            model = build_wide_deep(
                compute_dtype=dtype, device=device,
                generator=torch.Generator().manual_seed(SEED + 5))
            trainer = Trainer(model, adam(1e-3),
                              precision=Precision(compute_dtype=dtype))
            state = trainer.init_state(params)
            params = {k: v.cpu() for k, v in state.params.items()}
            del model
            batch = trainer._place(host_batch)
            out = trainer._predict(state.params, batch.x).cpu()
            new, loss = trainer.train_step(state, batch)
            results[device] = (float(loss), out, {
                k: v.cpu() for k, v in new.opt_state["mu"].items()},
                {k: v.cpu() for k, v in new.params.items()})
            del trainer, state, new
            torch.cuda.empty_cache()
        (loss_c, out_c, mu_c, p_c), (loss_g, out_g, mu_g, p_g) = (
            results["cpu"], results["cuda"])
        loss_err = abs(loss_g - loss_c) / abs(loss_c)
        out_err = rel_error(out_g, out_c)
        print(f"wide_deep step {name}: loss card {loss_g:.7f} cpu "
              f"{loss_c:.7f} rel {loss_err:.3e} (tol {tol['loss']:.0e}); "
              f"outputs rel {out_err:.3e} (tol {tol['out']:.0e})")
        worst_g = worst_p = 0.0
        for k in mu_c:
            # after one adam step mu = (1 - b1) * grad, on both sides
            _, g_err = max_errors(mu_g[k], mu_c[k])
            p_abs, p_rel = max_errors(p_g[k], p_c[k])
            print(f"wide_deep step {name} {k}: grad rel_to_scale "
                  f"{g_err:.3e}; updated param max_abs {p_abs:.3e}, "
                  f"rel_to_scale {p_rel:.3e}")
            worst_g, worst_p = max(worst_g, g_err), max(worst_p, p_abs)
        print(f"wide_deep step {name}: worst grad rel_to_scale {worst_g:.3e} "
              f"(tol {tol['grad']:.0e}), worst updated param max_abs "
              f"{worst_p:.3e} (tol {tol['param'] or 'not compared'})")
        for what, err in (("loss", loss_err), ("out", out_err),
                          ("grad", worst_g), ("param", worst_p)):
            if tol[what] is not None and err > tol[what]:
                failures.append(f"{name} step {what} differs by {err:.3e}")
    check(not failures, "; ".join(failures))


def profile_steps(label: str, step, step_ms: float, steps: int = 3) -> None:
    """Where a step's device time goes: ``torch.profiler`` over ``steps``
    steps; prints the kernel time per step, its share of the unprofiled
    median ``step_ms`` (the device's busy share; the rest is idle), and the
    heaviest kernels. A measurement only: it checks nothing."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # kernels only: an aten op's entry repeats its kernels' time
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3 / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    if not rows:
        print(f"profile {label}: the profiler recorded no device time")
        return
    print(f"profile {label}: device kernels {busy:.4f} ms/step = "
          f"{busy / step_ms:.3f} of the {step_ms:.4f} ms step (busy share)")
    for ms, name in rows[:10]:
        print(f"profile {label}:   {ms:.4f} ms/step  {name[:90]}")


def phase_wd_bench(k4: tuple[dict, dict]) -> dict:
    """bench.py's _bench_wide_deep on the card: the 100M model, B=8192,
    bf16 towers, Adam 1e-3; median ms/step after the warm-up steps, rows/s
    and K4a+K4b's share of the step from their own times."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import Precision
    from euromillioner_tpu_torch.data.dataset import Batch
    from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
    from euromillioner_tpu_torch.ops.wide_onehot import (WIDE_ONEHOT_DW,
                                                         WIDE_ONEHOT_FWD)
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    b = WD_BENCH["batch"]
    model = build_wide_deep(generator=torch.Generator().manual_seed(SEED),
                            device="cuda")
    trainer = Trainer(model, adam(1e-3),
                      precision=Precision(compute_dtype=torch.bfloat16))
    state = trainer.init_state()
    x = bench_rows(b)
    y = np.random.default_rng(0).normal(size=(b, 7)).astype(np.float32)
    batch = trainer._place(Batch(x=x, y=y, mask=np.ones(b, np.float32)))
    torch.cuda.reset_peak_memory_stats()
    times = []
    WIDE_ONEHOT_FWD.launches = WIDE_ONEHOT_DW.launches = 0
    for i in range(WD_BENCH["warmup"] + WD_BENCH["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        if i >= WD_BENCH["warmup"]:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = {"K4a": WIDE_ONEHOT_FWD.launches,
                "K4b": WIDE_ONEHOT_DW.launches}
    check(math.isfinite(float(loss)), "bench step loss is not finite")
    n_steps = WD_BENCH["warmup"] + WD_BENCH["steps"]
    check(launches == {"K4a": n_steps, "K4b": n_steps},
          f"bench steps launched {launches}, expected {n_steps} of each")
    ms = statistics.median(times)
    key = f"{b}x21x4096x1040 bfloat16"
    k4_ms = k4[0]["ms_by_shape"][key] + k4[1]["ms_by_shape"][key]
    k4_dev = (k4[0]["device_ms_by_shape"][key]
              + k4[1]["device_ms_by_shape"][key])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"wide_deep bench step (B={b}, bf16 towers, Adam): median "
          f"{ms:.4f} ms/step over {len(times)} steps (min {min(times):.4f}, "
          f"max {max(times):.4f}), {b / ms * 1e3:.1f} rows/s; K4a+K4b "
          f"{k4_ms:.4f} ms per call = {k4_ms / ms:.3f} of the step, "
          f"{k4_dev:.4f} ms on the device = {k4_dev / ms:.3f} (from their own "
          f"times); launches {launches} in {n_steps} steps; peak device "
          f"memory {peak:.2f} GiB")

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, batch)

    profile_steps(f"bench step B={b}", step, ms)
    # the training path's batch (B=64) on the same state: its step alone,
    # without the CLI's host staging, and where it goes
    small = trainer._place(Batch(x=x[:64], y=y[:64],
                                 mask=np.ones(64, np.float32)))
    times = []
    for i in range(WD_BENCH["warmup"] + WD_BENCH["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, small)
        torch.cuda.synchronize()
        if i >= WD_BENCH["warmup"]:
            times.append((time.perf_counter() - t0) * 1e3)
    small_ms = statistics.median(times)
    print(f"wide_deep step B=64 (bf16 towers, Adam): median {small_ms:.4f} "
          f"ms/step (min {min(times):.4f}, max {max(times):.4f})")
    batch = small
    profile_steps("step B=64", step, small_ms)
    del trainer, state, model, batch, small
    torch.cuda.empty_cache()
    return {"step_ms": ms, "rows_per_s": b / ms * 1e3,
            "k4_share": k4_ms / ms, "k4_device_share": k4_dev / ms,
            "launches": launches}


# -- the row families: the MLP (BASELINE.json config 1), the narrow tiers
# of the mlp and Wide&Deep, the classic family ---------------------------

def card(text: str) -> None:
    """One measured line, with the card's name and power limit."""
    print(f"{text} [{CARD}]")


def watch_rounds(jsonl: Path) -> tuple[list, dict]:
    """The watch records and the fit summary a CLI training run wrote."""
    records = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    rounds = [r for r in records if "round" in r]
    summary = [r for r in records if r.get("event") == "fit_summary"]
    return rounds, (summary[0] if summary else {})


def phase_mlp_train(root: Path) -> Path:
    """``train --model mlp`` through the CLI at the ModelConfig defaults
    (hidden 256, 256; 10 label-dropped features; B=64, Adam 1e-3, mse;
    TRAIN_EPOCHS epochs, cut from 20) on the card in bf16 (the default
    compute dtype) and f32, and the f32 command once more on the CPU: each
    run's watch lines, the card runs' ms/step and examples/s, and the f32
    run's per-epoch rmse against the CPU's. Returns the f32 checkpoint."""
    out = root / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    runs = {}
    for name, extra in (("bf16", []),
                        ("f32", ["model.compute_dtype=float32"]),
                        ("f32 cpu", ["model.compute_dtype=float32",
                                     "--device", "cpu"])):
        tag = name.replace(" ", "_")
        ckdir, jsonl = out / f"mlp_{tag}", out / f"mlp_{tag}.jsonl"
        shutil.rmtree(ckdir, ignore_errors=True)
        jsonl.unlink(missing_ok=True)
        t0 = time.perf_counter()
        rc, _ = wd_cli(["train", "--model", "mlp", "--html-file",
                        str(root / GOLDEN_HTML), f"train.epochs={TRAIN_EPOCHS}",
                        f"train.metrics_jsonl={jsonl}", "--save", str(ckdir),
                        *extra])
        wall = time.perf_counter() - t0
        check(rc == 0, f"train --model mlp ({name}) exited {rc}")
        rounds, stats = watch_rounds(jsonl)
        for r in rounds:
            print(f"mlp train ({name}) watch line [{r['round']}]: train-rmse "
                  f"{r['train-rmse']:.6f} test-rmse {r['test-rmse']:.6f}")
        check(len(rounds) == TRAIN_EPOCHS, f"{len(rounds)} watch lines")
        check(all(math.isfinite(r[k]) for r in rounds
                  for k in ("train-rmse", "test-rmse")), "non-finite rmse")
        line = (f"mlp train ({name}, hidden 256x256, B=64): "
                f"{stats['mean_step_ms']:.4f} ms/step over {stats['steps']} "
                f"device-synchronised steps, {stats['examples_per_sec']:.1f} "
                f"examples/s; CLI wall {wall:.2f} s")
        if name.endswith("cpu"):
            print(f"{line} (the card machine's host CPU)")
        else:
            card(line)
        runs[name] = (rounds, ckdir)
    worst = max(abs(c[k] - h[k]) / abs(h[k])
                for c, h in zip(runs["f32"][0], runs["f32 cpu"][0])
                for k in ("train-rmse", "test-rmse"))
    print(f"mlp train f32, card vs CPU: per-epoch rmse within {worst:.3e} "
          f"relative (tol {MLP_RMSE_TOL:.0e})")
    check(worst <= MLP_RMSE_TOL, "mlp f32 training drifts from the CPU's")
    shutil.rmtree(runs["bf16"][1], ignore_errors=True)
    shutil.rmtree(runs["f32 cpu"][1], ignore_errors=True)
    return runs["f32"][1]


def bucket_rates(backend, profile: str, rows) -> dict:
    """Per bucket of ServeConfig's (8, 32, 128): an engine with that one
    bucket at ``profile``, ROW_P50_RUNS closed-loop requests of one full
    bucket (client p50 ms), then ROW_RATE_REQUESTS such requests at once
    (rows/s). Returns {bucket: (p50_ms, rows_per_s)}."""
    from euromillioner_tpu_torch.serve.engine import InferenceEngine

    out = {}
    for b in ROW_BUCKETS:
        eng = InferenceEngine(backend, buckets=(b,), precision=profile)
        try:
            lat = []
            for _ in range(ROW_P50_RUNS):
                t0 = time.perf_counter()
                eng.predict(rows[:b])
                lat.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            futures = [eng.submit(rows[:b]) for _ in range(ROW_RATE_REQUESTS)]
            for f in futures:
                f.result(timeout=HTTP_WAIT)
            dt = time.perf_counter() - t0
            check(eng.stats()["errors"] == 0, f"{profile} bucket {b} failed")
        finally:
            eng.close()
        out[b] = (statistics.median(lat), ROW_RATE_REQUESTS * b / dt)
    return out


def held_to_oracle(backend, profile: str, rows, what: str) -> None:
    """One full bucket of ``rows`` per bucket through the profile's
    program against the f32 ``predict`` of the same rows: f32 bit-equal,
    a narrow profile inside its pinned envelope, its params narrow (every
    float leaf bfloat16 under bf16, int8 leaves under int8w)."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        is_quantized,
                                                        rel_error)

    leaves = backend.serve_params(profile).values()
    if profile == "bf16":
        check(all(t.dtype == torch.bfloat16 for t in leaves
                  if t.is_floating_point()), f"{what} bf16 params not bf16")
    elif profile == "int8w":
        check(any(is_quantized(t) for t in leaves),
              f"{what} int8w params hold no int8 leaf")
    for b in ROW_BUCKETS:
        x = torch.as_tensor(rows[:b], device=backend.device)
        got = backend.serve_apply(profile)(x).cpu().numpy()
        want = backend.predict(rows[:b])
        if profile == "f32":
            same = np.array_equal(got, want)
            print(f"{what} f32 program vs predict at bucket {b}: bit-equal "
                  f"{same}")
            check(same, f"{what} f32 replies differ from predict")
        else:
            env = SERVE_ENVELOPES[(backend.family, profile)]
            err = rel_error(got, want)
            print(f"{what} {profile} vs the f32 predict at bucket {b}: rel "
                  f"{err:.3e} (envelope {env:.0e})")
            check(err <= env, f"{what} {profile} outside its envelope")


def print_rates(what: str, rates: dict, mb: dict) -> None:
    for profile, by_bucket in rates.items():
        cells = ", ".join(f"bucket {b}: p50 {p50:.4f} ms, {rps:.1f} rows/s"
                          for b, (p50, rps) in by_bucket.items())
        card(f"{what} at {profile} (serve_param_mb {mb[profile]}): {cells}")


def phase_mlp_serve(ckdir: Path) -> None:
    """The f32 checkpoint served through ``serve --model-type mlp --smoke
    N`` at f32, bf16 and int8w and with ``serve.profiles=bf16,int8w``: no
    failed request; then in process each profile's program held to the
    f32 predict at every bucket, requests naming each profile routed to
    it, and each profile's params and rates per bucket."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)
    from euromillioner_tpu_torch.serve.engine import (make_row_engine,
                                                      param_bytes)
    from euromillioner_tpu_torch.serve.session import load_backend
    from euromillioner_tpu_torch.serve.transport import handle_request

    flags = ["model.compute_dtype=float32"]
    for extra in (["serve.precision=f32"], ["serve.precision=bf16"],
                  ["serve.precision=int8w"], ["serve.profiles=bf16,int8w"]):
        rc, out = wd_cli(["serve", "--model-type", "mlp", "--checkpoint",
                          str(ckdir), "--smoke", str(MLP_SMOKE_REQUESTS),
                          *flags, *extra])
        check(rc == 0, f"serve --model-type mlp {extra[0]} exited {rc}")
        summary = json.loads(out.strip().splitlines()[-1])
        st = summary["stats"]
        got = np.asarray(summary["predictions"], np.float32)
        print(f"serve mlp --smoke {MLP_SMOKE_REQUESTS} {extra[0]}: ok "
              f"{summary['ok']}, failed {summary['failed']}, batches "
              f"{st['batches']}, precision {json.dumps(st['precision'])}")
        check(summary["failed"] == 0, f"mlp serve {extra[0]}: requests failed")
        check(got.shape == (MLP_SMOKE_REQUESTS, 1, 1)
              and bool(np.isfinite(got).all()), "mlp smoke replies")
        check(st["precision"]["envelope_breaches"] == 0, "envelope breached")
    cfg = apply_overrides(Config(), flags + ["serve.profiles=bf16,int8w"])
    backend = load_backend("mlp", str(ckdir), cfg)
    rows = np.random.default_rng(SEED).normal(
        size=(max(ROW_BUCKETS), 10)).astype(np.float32)
    mb = {}
    for profile in ("f32", "bf16", "int8w"):
        held_to_oracle(backend, profile, rows, "serve mlp")
        mb[profile] = round(param_bytes(backend.serve_params(profile))
                            / 2**20, 3)
    engine = make_row_engine(backend, cfg)
    try:
        for i in range(12):
            profile = (None, "bf16", "int8w")[i % 3]
            x = rows[8 * i:8 * i + 8]
            status, reply = handle_request(
                engine, {"rows": x.tolist(),
                         **({"profile": profile} if profile else {})})
            check(status == 200, f"profile {profile} request: {reply}")
            got = np.asarray(reply["predictions"], np.float32)
            want = backend.predict(x)
            if profile is None:
                check(np.array_equal(got, want), "f32 reply != predict")
            else:
                err = rel_error(got, want)
                check(0.0 < err <= SERVE_ENVELOPES[("nn", profile)],
                      f"{profile} reply outside its envelope")
        st = engine.stats()
    finally:
        engine.close()
    print(f"serve mlp serve.profiles=bf16,int8w, requests naming each "
          f"profile: {json.dumps(st['profiles'])}")
    check(all(st["profiles"][p]["completed"] == 4
              for p in ("f32", "bf16", "int8w")), "profile routing")
    rates = {p: bucket_rates(backend, p, rows)
             for p in ("f32", "bf16", "int8w")}
    print_rates("serve mlp (hidden 256x256)", rates, mb)
    del backend
    torch.cuda.empty_cache()


def phase_wd_tiers(ckdir: Path) -> dict:
    """The 100M Wide&Deep checkpoint of phase 14 served through the CLI at
    bf16 and int8w: no failed request, the bf16 run's K4a launches
    counted from 0 (its batches and bucket warmups, plus the f32 drift
    oracle's), the int8w run's only the f32 oracle's; in process the int8w
    program launches no K4 kernel at all, each tier is held to the f32
    predict at every bucket inside its envelope, and the tiers' params
    and p50 per bucket stand beside f32's. Returns K4a's launches in the
    two CLI runs."""
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.ops.wide_onehot import (WIDE_ONEHOT_DW,
                                                         WIDE_ONEHOT_FWD)
    from euromillioner_tpu_torch.serve.engine import param_bytes
    from euromillioner_tpu_torch.serve.session import load_backend

    launches = {}
    for profile in ("bf16", "int8w"):
        summary, k4a = wd_serve_cli(ckdir, WD_SMOKE_REQUESTS,
                                    (f"serve.precision={profile}",))
        st = summary["stats"]
        oracle = st["precision"]["drift_checks"]
        own = (st["batches"] + len(ROW_BUCKETS)) if profile == "bf16" else 0
        print(f"serve wide_deep at {profile}: K4a launches {k4a} (expected "
              f"{own} of the {profile} program: batches + bucket warmups, "
              f"+ {oracle} of the f32 profile's drift oracle = "
              f"{own + oracle})")
        check(st["precision"]["envelope_breaches"] == 0, "envelope breached")
        check(k4a == own + oracle, f"K4a launched {k4a} times at {profile}")
        launches[profile] = k4a
    cfg = apply_overrides(Config(), ["serve.profiles=bf16,int8w"])
    backend = load_backend("wide_deep", str(ckdir), cfg)
    rows = bench_rows(max(ROW_BUCKETS))
    mb = {p: round(param_bytes(backend.serve_params(p)) / 2**20, 3)
          for p in ("f32", "bf16", "int8w")}
    for profile in ("bf16", "int8w"):
        WIDE_ONEHOT_FWD.launches = WIDE_ONEHOT_DW.launches = 0
        for b in ROW_BUCKETS:
            backend.serve_apply(profile)(
                torch.as_tensor(rows[:b], device=backend.device))
        torch.cuda.synchronize()
        counts = (WIDE_ONEHOT_FWD.launches, WIDE_ONEHOT_DW.launches)
        want = (len(ROW_BUCKETS), 0) if profile == "bf16" else (0, 0)
        print(f"serve wide_deep {profile} program alone at the buckets "
              f"{ROW_BUCKETS}: (K4a, K4b) launches {counts}, expected {want}")
        check(counts == want, f"{profile} program's K4 launches {counts}")
        held_to_oracle(backend, profile, rows, "serve wide_deep")
    card(f"serve wide_deep serving params: f32 {mb['f32']} MB, bf16 "
         f"{mb['bf16']} MB, int8w {mb['int8w']} MB "
         f"({mb['int8w'] / mb['f32']:.3f} of f32)")
    check(mb["int8w"] <= 0.3 * mb["f32"], "int8w params not about a quarter")
    rates = {p: bucket_rates(backend, p, rows)
             for p in ("f32", "bf16", "int8w")}
    print_rates("serve wide_deep (100M)", rates, mb)
    del backend
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def classic_data(root: Path):
    """The golden page's featurized rows, label column 0 (the draw's day
    of week) as the class id, each feature standardised by the training
    split's mean and deviation: (x, y, x_test, y_test)."""
    import numpy as np

    from euromillioner_tpu_torch.data.pipeline import pipeline_from_html

    tr, va = pipeline_from_html((root / GOLDEN_HTML).read_text())
    mean, std = tr.x.mean(0), tr.x.std(0) + 1e-6
    return ((tr.x - mean) / std, tr.y.astype(np.int32),
            ((va.x - mean) / std).astype(np.float32), va.y.astype(np.int32))


def classic_scores(model, x):
    """The per-class scores each classic model's argmax (argmin for
    k-means) runs on, as numpy: the near-tie measure of a flipped id."""
    from euromillioner_tpu_torch.classic import GaussianNB, KMeans

    if isinstance(model, KMeans):
        xt = torch.as_tensor(x, device=model.device)
        c = model.centers
        return -((xt * xt).sum(-1, keepdim=True) - 2.0 * (xt @ c.T)
                 + (c * c).sum(-1)[None]).cpu().numpy()
    if isinstance(model, GaussianNB):
        return model.log_likelihood(
            torch.as_tensor(x, device=model.device)).cpu().numpy()
    return model.decision_function(x)


def svm_first_flip(x, y, steps: int, lr: float, l2: float) -> float:
    """The linear SVM's fit on the card and on the CPU agree until a step
    whose hinge mask (``y * score < 1``) differs between them; from there
    they follow different subgradients. Bisects the step count for the
    last step whose (w, b) still agree within CLASSIC_TOL of their scale,
    prints it and the margins the two devices classify differently at the
    next step, and returns the largest |margin - 1| among them (a near tie
    when below CLASSIC_TOL)."""
    import numpy as np

    from euromillioner_tpu_torch.classic.linear import _fit_svm

    def fit(dev, k):
        xt = torch.as_tensor(x, device=dev)
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(y, dtype=torch.int64, device=dev),
            int(y.max()) + 1).float()
        y_pm = 2.0 * onehot - 1.0
        w, b = _fit_svm(xt, y_pm, k, lr, l2)
        return (y_pm * (xt @ w + b)).cpu().numpy(), w.cpu(), b.cpu()

    def gap(k):
        (_, wg, bg), (_, wc, bc) = fit("cuda", k), fit("cpu", k)
        return max(float((a - c).abs().max() / (c.abs().max() + 1e-30))
                   for a, c in ((wg, wc), (bg, bc)))

    lo, hi = 0, steps
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if gap(mid) <= CLASSIC_TOL else (lo, mid)
    m_gpu, m_cpu = fit("cuda", lo)[0], fit("cpu", lo)[0]
    flips = np.flatnonzero((m_gpu < 1.0) != (m_cpu < 1.0))
    worst = float(np.abs(m_cpu.reshape(-1)[flips] - 1.0).max()) \
        if len(flips) else float("inf")
    print(f"classic svm: card and CPU agree within {CLASSIC_TOL:.0e} "
          f"through step {lo} (gap {gap(lo):.3e}); step {lo + 1}'s hinge "
          f"masks differ at {len(flips)} element(s), margins "
          f"{m_cpu.reshape(-1)[flips].tolist()} on the CPU and "
          f"{m_gpu.reshape(-1)[flips].tolist()} on the card")
    return worst


def phase_classic(root: Path) -> None:
    """Logistic regression, the linear SVM, Gaussian naive Bayes and
    k-means fitted on the card and on the CPU on the golden page's rows
    (k-means from the same initial rows): the fitted arrays within
    CLASSIC_TOL of each array's scale, test-split ids equal but at near
    ties, fit seconds; each card model saved as JSON and served through
    ``serve --model-type classic --smoke N``, replies bit-equal to its
    predict."""
    import numpy as np

    from euromillioner_tpu_torch import classic
    from euromillioner_tpu_torch.serve.transport import row_payloads

    x, y, xt, yt = classic_data(root)
    out = root / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    makers = {"logistic": classic.LogisticRegression,
              "svm": classic.LinearSVM, "naive_bayes": classic.GaussianNB,
              "kmeans": lambda device: classic.KMeans(
                  CLASSIC_K, seed=SEED, device=device)}
    for kind, make in makers.items():
        fits, secs = [], []
        for dev in ("cuda", "cpu"):
            m = make(device=dev)
            t0 = time.perf_counter()
            m.fit(x) if kind == "kmeans" else m.fit(x, y)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            fits.append(m)
        gpu, cpu = fits
        arrays = {"kmeans": lambda m: [m.centers],
                  "naive_bayes": lambda m: list(m._params)}.get(
                      kind, lambda m: list(m._wb))
        worst = max(float((a.cpu() - b).abs().max() / (b.abs().max() + 1e-30))
                    for a, b in zip(arrays(gpu), arrays(cpu)))
        ids_gpu, ids_cpu = gpu.predict(xt), cpu.predict(xt)
        scores = np.sort(classic_scores(cpu, xt), axis=-1)
        margin = (scores[:, -1] - scores[:, -2]) / np.abs(scores).max()
        flips = np.flatnonzero(ids_gpu != ids_cpu)
        card(f"classic {kind}: fit {secs[0]:.4f} s on the card, "
             f"{secs[1]:.4f} s on the CPU; fitted arrays within "
             f"{worst:.3e} of their scale (tol {CLASSIC_TOL:.0e}); test ids "
             f"{len(flips)} of {len(xt)} differ (margins "
             f"{margin[flips].tolist()}); test accuracy "
             f"{float((ids_gpu == yt).mean()) if kind != 'kmeans' else 'n/a'}")
        if kind == "svm" and worst > CLASSIC_TOL:
            # the hinge mask is discontinuous: hold the fits up to the step
            # where the devices first classify a margin differently, and
            # that margin to a near tie
            tie = svm_first_flip(x, y, gpu.steps, gpu.lr, gpu.l2)
            check(tie < CLASSIC_TOL, "svm: fits part away from a near tie")
        else:
            check(worst <= CLASSIC_TOL,
                  f"{kind}: card fit drifts from the CPU's")
        check(bool((margin[flips] < CLASSIC_TOL).all()),
              f"{kind}: ids differ away from a near tie")
        path = out / f"classic_{kind}.json"
        gpu.save_model(str(path))
        rc, stdout = wd_cli(["serve", "--model-type", "classic",
                             "--model-file", str(path), "--smoke",
                             str(CLASSIC_SMOKE_REQUESTS)])
        check(rc == 0, f"serve --model-type classic ({kind}) exited {rc}")
        summary = json.loads(stdout.strip().splitlines()[-1])
        got = np.asarray(summary["predictions"])[:, 0]
        rows = np.asarray(row_payloads(CLASSIC_SMOKE_REQUESTS, (x.shape[1],)),
                          np.float32)[:, 0]
        same = np.array_equal(got, gpu.predict(rows))
        print(f"serve classic {kind} --smoke {CLASSIC_SMOKE_REQUESTS}: ok "
              f"{summary['ok']}, failed {summary['failed']}, batches "
              f"{summary['stats']['batches']}, replies bit-equal to predict "
              f"{same}")
        check(summary["failed"] == 0 and same, f"classic {kind} serving")
        path.unlink()


# -- 26-28: training across ranks --------------------------------------------

def phase_train_dp(root: Path) -> dict:
    """DP-1: ``train --model lstm --distributed`` through the CLI at the
    flagship's defaults (bf16, B=64, TRAIN_EPOCHS epochs): with one visible
    card the CLI runs a group of one over NCCL in this process. Its K1/K2
    launches must be the plain run's, and its checkpoint bit-equal to the
    plain ``train --model lstm`` at the same seed (a group of one adds
    nothing to the arithmetic: the all-reduce of one rank is a copy).
    Returns the bf16 kernels' launches of the distributed run."""
    import torch.distributed as dist

    counts, want_k1, want_k2, ckdir = train_cli(root, "train_dp",
                                                ["--distributed"])
    print(f"DP-1 launches (a group of one over NCCL): bf16 K1 "
          f"{counts['K1.bf16']}, bf16 K2 {counts['K2.bf16']} (expected "
          f"{want_k1}, {want_k2})")
    check(counts["K2.bf16"] == want_k2 and counts["K1.bf16"] == want_k1,
          f"DP-1 launched {counts}, expected K1 {want_k1} and K2 {want_k2}")
    check(counts["K1.f32"] == counts["K2.f32"] == 0,
          "DP-1 launched the f32 kernels")
    check(not dist.is_initialized(), "DP-1 left its process group")
    _, _, _, ref = train_cli(root, "train_dp_ref", [])
    step = f"step_{TRAIN_EPOCHS:08d}"
    files = sorted(p.name for p in (ckdir / step).iterdir())
    same = files == sorted(p.name for p in (ref / step).iterdir()) and all(
        (ckdir / step / f).read_bytes() == (ref / step / f).read_bytes()
        for f in files)
    print(f"DP-1 checkpoint ({files}) bit-equal to the plain train's: "
          f"{same}")
    check(same, "DP-1's checkpoint differs from the plain train's")
    shutil.rmtree(ckdir, ignore_errors=True)
    shutil.rmtree(ref, ignore_errors=True)
    return counts


def dp_cli_pair(root: Path, model: str, extra: list[str], counters: dict
                ) -> dict:
    """``train --model {model}`` through the CLI on the golden page at its
    defaults (plus ``extra``), at the same seed: plain, then with
    ``--distributed`` (one visible card: a group of one over NCCL in this
    process), each with the ``counters`` (name: kernel entry point) reset
    just before and read just after. The two runs must launch each kernel
    alike and write bit-equal output (the checkpoint directory, or the
    forest's model file). Prints ms/step of both (a neural family's fit
    summary) or the walls (the forest). Returns the distributed run's
    launches."""
    import torch.distributed as dist

    out = root / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    runs = {}
    for name, dist_args in (("plain", []), ("distributed",
                                            ["--distributed"])):
        tag = f"dp_{model}_{name}"
        dest, jsonl = out / tag, out / f"{tag}.jsonl"
        shutil.rmtree(dest, ignore_errors=True)
        dest.unlink(missing_ok=True)
        jsonl.unlink(missing_ok=True)
        metrics = ([] if model == "rf" else
                   [f"train.epochs={TRAIN_EPOCHS}",
                    f"train.metrics_jsonl={jsonl}"])
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        rc, _ = wd_cli(["train", "--model", model, "--html-file",
                        str(root / GOLDEN_HTML), *metrics, *extra,
                        *dist_args, "--save", str(dest)])
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        check(rc == 0, f"train --model {model} {' '.join(dist_args)} "
                       f"exited {rc}")
        check(not dist.is_initialized(), f"{tag} left its process group")
        stats = {} if model == "rf" else watch_rounds(jsonl)[1]
        jsonl.unlink(missing_ok=True)
        runs[name] = (dest, launches, wall, stats)
    (dp, dp_n, dp_wall, dp_stats), (ref, ref_n, ref_wall, ref_stats) = (
        runs["distributed"], runs["plain"])
    if model == "rf":
        same = dp.read_bytes() == ref.read_bytes()
        timing = (f"CLI wall {dp_wall:.3f} s (plain {ref_wall:.3f} s, the "
                  f"same command without --distributed)")
        dp.unlink()
        ref.unlink()
    else:
        step = f"step_{TRAIN_EPOCHS:08d}"
        files = sorted(p.name for p in (dp / step).iterdir())
        same = (files == sorted(p.name for p in (ref / step).iterdir())
                and all((dp / step / f).read_bytes()
                        == (ref / step / f).read_bytes() for f in files))
        timing = (f"{dp_stats['mean_step_ms']:.4f} ms/step over "
                  f"{dp_stats['steps']} device-synchronised steps (plain "
                  f"{ref_stats['mean_step_ms']:.4f} ms/step over "
                  f"{ref_stats['steps']}); CLI wall {dp_wall:.2f} s (plain "
                  f"{ref_wall:.2f} s)")
        shutil.rmtree(dp, ignore_errors=True)
        shutil.rmtree(ref, ignore_errors=True)
    card(f"DP-1 {model} (train --distributed, a group of one over NCCL, "
         f"the CLI defaults {' '.join(extra)}): {timing}")
    print(f"DP-1 {model}: launches {dp_n} (plain {ref_n}); output "
          f"bit-equal to the plain train's: {same}")
    check(dp_n == ref_n, f"DP-1 {model} launched {dp_n}, the plain run "
                         f"{ref_n}")
    check(all(n > 0 for n in dp_n.values()),
          f"DP-1 {model} launched a kernel of its path no time: {dp_n}")
    check(same, f"DP-1 {model}'s output differs from the plain train's")
    return dp_n


def phase_train_dp_families(root: Path) -> dict:
    """DP-1 for the other families ``train --distributed`` covers, as the
    flagship's: the MLP (BASELINE.json config 1, no kernel of its own),
    Wide&Deep at the CLI's 100M parameters (K4a, K4b; every step's
    gradients, the wide tables' dense one included, go through one
    all-reduced f32 bucket) and the random forest (``--num-classes 6``,
    K3's set form, each level's histograms all-reduced). Returns the
    launches by kernel."""
    from euromillioner_tpu_torch.ops.fused_histogram import \
        FUSED_HISTOGRAM_SETS
    from euromillioner_tpu_torch.ops.wide_onehot import (WIDE_ONEHOT_DW,
                                                         WIDE_ONEHOT_FWD)

    dp_cli_pair(root, "mlp", [], {})
    wd = dp_cli_pair(root, "wide_deep", [], {"K4a": WIDE_ONEHOT_FWD,
                                             "K4b": WIDE_ONEHOT_DW})
    rf = dp_cli_pair(root, "rf", ["--num-classes", "6"],
                     {"K3.sets": FUSED_HISTOGRAM_SETS})
    wd_bucket_cost()
    torch.cuda.empty_cache()
    return {**wd, **rf}


def wd_bucket_cost() -> None:
    """The time of one ``all_reduce_grads`` on the CLI Wide&Deep's
    gradients in a group of one over NCCL, the cost the data-parallel step
    adds: the flat f32 bucket's ``cat``, the all-reduce, the copy back;
    beside the time its HBM traffic (each gradient read and written twice)
    takes at the card's peak rate."""
    from euromillioner_tpu_torch.core.mesh import MeshSpec, build_mesh
    from euromillioner_tpu_torch.dist import bootstrap
    from euromillioner_tpu_torch.dist.collectives import all_reduce_grads
    from euromillioner_tpu_torch.models.wide_deep import build_wide_deep

    model = build_wide_deep(generator=torch.Generator().manual_seed(SEED),
                            device="cuda")
    grads = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    del model
    loss = torch.zeros((), device="cuda")
    n = sum(g.numel() for g in grads.values())
    bootstrap.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = build_mesh(MeshSpec(), device="cuda")
        ms = time_ms(lambda: all_reduce_grads(grads, mesh, loss), runs=10)
    finally:
        bootstrap.shutdown()
    moved = 4 * 4 * n
    card(f"DP-1 wide_deep gradient bucket: {n:,} f32 gradients = "
         f"{4 * n / 1e6:.1f} MB; one all_reduce_grads (cat, NCCL all-reduce "
         f"of one rank, copy back) {ms:.4f} ms; its {moved / 1e9:.2f} GB of "
         f"HBM traffic take {moved / PEAK_HBM_BYTES_S * 1e3:.4f} ms at the "
         f"peak rate")
    del grads


def dp_precisions() -> dict:
    """DP-2's two runs: the default bf16 compute dtype, then f32."""
    from euromillioner_tpu_torch.core.precision import (DEFAULT_PRECISION,
                                                        PARITY)

    return {"bfloat16": DEFAULT_PRECISION, "float32": PARITY}


def dp_flagship(device: str):
    """The flagship at full width with seeded weights, for DP-2."""
    from euromillioner_tpu_torch.models.lstm import build_lstm

    return build_lstm(HIDDEN, LAYERS, OUTPUTS, in_features=FEATURES,
                      generator=torch.Generator().manual_seed(SEED + 11),
                      device=device)


def dp_fit(root: Path, trainer, jsonl: Path | None) -> tuple[dict, dict]:
    """One epoch of the golden windows at B=DP_BATCH, unshuffled, the LSTM
    counters reset just before and read just after: (params on the CPU,
    the run's numbers: the largest distance a param moved from its
    initial value, and ms/step from the fit summary in ``jsonl``, the
    trainer's ``metrics_jsonl``, where given)."""
    train_ds, _ = golden_windows(root)
    state = trainer.init_state()
    init = {k: v.detach().cpu().clone() for k, v in state.params.items()}
    reset_lstm_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.fit(state, train_ds, epochs=DP_EPOCHS,
                        batch_size=DP_BATCH, shuffle=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = watch_rounds(jsonl)[1] if jsonl is not None else {}
    params = {k: v.detach().cpu() for k, v in state.params.items()}
    moved = {k: float((params[k] - v).abs().max()) for k, v in init.items()}
    most = max(moved, key=moved.get)
    return (params,
            {"counts": lstm_counts(), "steps": int(state.step), "wall": wall,
             "moved": moved[most], "moved_most": most,
             "windows": len(train_ds), "ms_per_step":
                 stats.get("mean_step_ms"), "timed_steps": stats.get("steps")})


def rf_mesh_forests(mesh) -> dict:
    """RF_SHAPE's classifier and regressor row-sharded over ``mesh``
    (the seed's draws, hist_method=auto), each grown once untimed and
    once more: the second's trees, wall and set-form K3 launches on this
    rank."""
    from euromillioner_tpu_torch.ops.fused_histogram import \
        FUSED_HISTOGRAM_SETS
    from euromillioner_tpu_torch.trees import random_forest as rf

    x, y_cls, y_reg = rf_data()
    kw = dict(num_trees=RF_SHAPE["trees"], max_depth=RF_SHAPE["max_depth"],
              max_bins=RF_SHAPE["max_bins"], seed=RF_SEED, mesh=mesh)
    out = {}
    for name, grow in (
            ("classifier", lambda: rf.train_classifier(
                x, y_cls, RF_SHAPE["num_classes"], **kw)),
            ("regressor", lambda: rf.train_regressor(x, y_reg, **kw))):
        grow()
        torch.cuda.synchronize()
        FUSED_HISTOGRAM_SETS.launches = 0
        t0 = time.perf_counter()
        model = grow()
        torch.cuda.synchronize()
        out[name] = {"trees": model.trees, "wall": time.perf_counter() - t0,
                     "launches": FUSED_HISTOGRAM_SETS.launches}
    return out


def rank_worker(rank: int, world: int, address: str, out_dir: str) -> int:
    """One rank of DP-2 and RF-mesh: a gloo group over CUDA tensors on the
    card (both ranks on device 0), the data-parallel flagship for
    DP_EPOCHS epochs, then RF_SHAPE's two forests row-sharded; saves what
    it computed to ``out_dir/rank{rank}.pt``. Run by
    ``phase_ranks_on_one_card`` in a child process."""
    from datetime import timedelta

    import torch.distributed as dist

    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.core.mesh import MeshSpec, build_mesh
    from euromillioner_tpu_torch.dist.sharded import DistributedTrainer
    from euromillioner_tpu_torch.train.optim import sgd

    root = Path(__file__).resolve().parent
    out = Path(out_dir)
    resolve_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=DP_GROUP_TIMEOUT_S))
    try:
        mesh = build_mesh(MeshSpec(data=world), device="cuda")
        res = {}
        for name, precision in dp_precisions().items():
            jsonl = out / f"dp2_{name}.jsonl"
            trainer = DistributedTrainer(dp_flagship("cuda"), sgd(DP2_LR),
                                         precision=precision, mesh=mesh,
                                         metrics_jsonl=str(jsonl))
            res[name] = dp_fit(root, trainer, jsonl if rank == 0 else None)
        res["forests"] = rf_mesh_forests(mesh)
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def phase_ranks_on_one_card(root: Path) -> dict:
    """DP-2 and RF-mesh: DP_RANKS ranks on the one card over gloo with CUDA
    tensors (the collectives go through the host: not NCCL). First the
    single-process references in this process: the flagship trained one
    epoch at B=64 by the plain Trainer, and RF_SHAPE's forests on one
    device. Then the ranks, as child processes (killed in ``finally``):
    the data-parallel flagship (bit-identical params on every rank, within
    DP2_PARAM_TOL of the single process, layers x 18 launches of each bf16
    kernel a rank over the padded last batch, ms/step) and the
    row-sharded forests (the classifier's trees equal to one device's, the
    regressor's equal or a shown near tie; K3's set launches per rank).
    Returns the launches summed over the ranks."""
    import numpy as np

    from euromillioner_tpu_torch.train.optim import sgd
    from euromillioner_tpu_torch.train.trainer import Trainer

    out = root / "build" / "chip_smoke" / "ranks"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    single = {}
    for name, precision in dp_precisions().items():
        jsonl = out / f"single_{name}.jsonl"
        single[name] = dp_fit(root, Trainer(
            dp_flagship("cuda"), sgd(DP2_LR), precision=precision,
            metrics_jsonl=str(jsonl)), jsonl)
    x, y_cls, y_reg = rf_data()
    forests = {"classifier": grow_forest(True, x, y_cls, RF_SHAPE["trees"],
                                         "cuda")[:2],
               "regressor": grow_forest(False, x, y_reg, RF_SHAPE["trees"],
                                        "cuda")[:2]}
    address = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = []
    try:
        for rank in range(DP_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke as c; "
                 f"sys.exit(c.rank_worker({rank}, {DP_RANKS}, "
                 f"{address!r}, {str(out)!r}))"], cwd=root, env=env))
        deadline = time.monotonic() + DP_PHASE_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    check(codes == [0] * DP_RANKS, f"the ranks exited {codes}")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(DP_RANKS)]

    # DP-2 (launches summed over the ranks and both runs)
    lstm: dict = {}
    for name in single:
        params = [r[name][0] for r in ranks]
        runs = [r[name][1] for r in ranks]
        ref_params, ref_run = single[name]
        want_steps = -(-runs[0]["windows"] // DP_BATCH)
        per_rank = LAYERS * want_steps * DP_EPOCHS
        kind = "bf16" if name == "bfloat16" else "f32"
        print(f"DP-2 {name}: {runs[0]['windows']} windows = "
              f"{runs[0]['windows'] // DP_BATCH} x {DP_BATCH} + "
              f"{runs[0]['windows'] % DP_BATCH} -> {want_steps} steps, the "
              f"last padded; steps per rank {[r['steps'] for r in runs]}; "
              f"launches per rank {[r['counts'] for r in runs]} (expected "
              f"{kind} K1 and K2 {per_rank} each)")
        check(all(r["steps"] == want_steps * DP_EPOCHS for r in runs),
              "DP-2 ranks took another number of steps")
        other = "f32" if kind == "bf16" else "bf16"
        check(all(r["counts"][f"K1.{kind}"] == r["counts"][f"K2.{kind}"]
                  == per_rank and r["counts"][f"K1.{other}"]
                  == r["counts"][f"K2.{other}"] == 0 for r in runs),
              f"DP-2 {name} launches differ from layers x steps")
        identical = all(torch.equal(params[0][k], p[k])
                        for p in params[1:] for k in params[0])
        gaps = {k: float((params[0][k] - v).abs().max())
                for k, v in ref_params.items()}
        widest = max(gaps, key=gaps.get)
        gap = gaps[widest]
        tol = DP2_PARAM_TOL[name]
        moved = ref_run["moved"]
        print(f"DP-2 {name} (SGD {DP2_LR:g}): the ranks' params "
              f"bit-identical: {identical}; against the single-process "
              f"trainer at B={DP_BATCH} on the card: largest difference "
              f"{gap:.3e} ({widest}; tol {tol:.0e}); the epoch moves a param by up "
              f"to {moved:.3e} ({ref_run['moved_most']}) = "
              f"{moved / tol:.1f} x the tolerance (at least {DP2_POWER} x "
              f"required)")
        check(identical, f"DP-2 {name}: the ranks' params differ")
        check(gap <= tol, f"DP-2 {name} params differ by {gap:.3e}")
        check(moved >= DP2_POWER * tol, f"DP-2 {name}: the tolerance "
              f"{tol:.0e} would pass a gradient-scale fault (the epoch "
              f"moves a param by only {moved:.3e})")
        card(f"DP-2 {name} ({DP_RANKS} ranks on one card, gloo through the "
             f"host, not NCCL; B={DP_BATCH}): {runs[0]['ms_per_step']:.4f} "
             f"ms/step over {runs[0]['timed_steps']} device-synchronised "
             f"steps (epoch wall {runs[0]['wall']:.3f} s); the single "
             f"process {ref_run['ms_per_step']:.4f} ms/step (wall "
             f"{ref_run['wall']:.3f} s)")
        for k in runs[0]["counts"]:
            lstm[k] = lstm.get(k, 0) + sum(r["counts"][k] for r in runs)

    # RF-mesh
    n_trees, depth = RF_SHAPE["trees"], RF_SHAPE["max_depth"]
    launches = {}
    for name, (ref, ref_wall) in forests.items():
        got = [r["forests"][name] for r in ranks]
        per = [g["launches"] for g in got]
        launches[name] = sum(per)
        card(f"RF-mesh {name} ({DP_RANKS} ranks over gloo, RF_SHAPE): walls "
             f"{[round(g['wall'], 4) for g in got]} s (one device "
             f"{ref_wall:.4f} s); K3 set launches per rank {per} (expected "
             f"{depth + 1} each)")
        check(all(p == depth + 1 for p in per),
              f"RF-mesh {name}: K3 set launches {per}")
        check(all(np.array_equal(got[0]["trees"][k], g["trees"][k])
                  for g in got[1:] for k in got[0]["trees"]),
              f"RF-mesh {name}: the ranks grew different forests")
        mesh_model = type("Forest", (), {"trees": got[0]["trees"],
                                         "cuts": ref.cuts})
        if name == "classifier":
            same = all(np.array_equal(got[0]["trees"][k], ref.trees[k])
                       for k in ref.trees)
            print(f"RF-mesh classifier trees equal to one device's: {same}")
            check(same, "RF-mesh classifier trees differ from one device's")
            continue
        equal, ties = rf_reg_first_difference(mesh_model, ref, x, y_reg,
                                              n_trees,
                                              ("2 ranks", "one device"))
        leaf = rf_leaf_gap(mesh_model, ref, n_trees)
        print(f"RF-mesh regressor against one device: {equal} of {n_trees} "
              f"trees equal in reachable structure, {ties} of the other "
              f"{n_trees - equal} a near-tie at their first difference; "
              f"leaf means of the identical trees within {leaf:.3e} of the "
              f"largest (tol {RF_REG_LEAF_TOL:.0e})")
        check(equal + ties == n_trees,
              "RF-mesh regressor differs from one device's without a "
              "near-tie")
        check(leaf <= RF_REG_LEAF_TOL, f"RF-mesh leaf means differ by "
              f"{leaf:.3e}")
    shutil.rmtree(out, ignore_errors=True)
    return {"lstm": lstm, "rf": launches}


def free_port() -> int:
    """A localhost port no one listens on (for a process group's
    rendezvous)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_param_avg(root: Path) -> None:
    """Parameter averaging with one rank (a group of one over NCCL) and
    PA_SYNC_EVERY local steps a round: the MLP at ModelConfig's defaults
    (BASELINE.json config 1: hidden 256, 256, bf16, Adam 1e-3) over one
    epoch of the golden page's split, against the plain trainer's replay
    of the same batches (cycled to whole rounds) on the card, as the JAX
    package's ``test_single_worker_equals_sequential`` holds it."""
    from itertools import cycle, islice

    from euromillioner_tpu_torch.config import ModelConfig
    from euromillioner_tpu_torch.core.mesh import MeshSpec, build_mesh
    from euromillioner_tpu_torch.core.precision import DEFAULT_PRECISION
    from euromillioner_tpu_torch.data.pipeline import pipeline_from_html
    from euromillioner_tpu_torch.dist import bootstrap
    from euromillioner_tpu_torch.dist.param_avg import \
        fit_parameter_averaging
    from euromillioner_tpu_torch.models.registry import build_model
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    train_ds, _ = pipeline_from_html((root / GOLDEN_HTML).read_text())
    trainer = Trainer(build_model(
        ModelConfig(name="mlp"), in_features=train_ds.x.shape[1],
        generator=torch.Generator().manual_seed(SEED + 13), device="cuda"),
        adam(1e-3), precision=DEFAULT_PRECISION)
    bootstrap.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = build_mesh(MeshSpec(), device="cuda")
        t0 = time.perf_counter()
        state = fit_parameter_averaging(
            trainer, trainer.init_state(), train_ds, mesh=mesh, epochs=1,
            batch_size=DP_BATCH, sync_every=PA_SYNC_EVERY, shuffle=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        bootstrap.shutdown()
    batches = list(train_ds.batches(DP_BATCH))
    rounds = -(-len(batches) // PA_SYNC_EVERY)
    ref = trainer.init_state()
    for batch in islice(cycle(batches), rounds * PA_SYNC_EVERY):
        ref, _ = trainer.train_step(ref, trainer._place(batch))
    same = all(torch.equal(state.params[k], ref.params[k])
               for k in ref.params)
    gap = max(float((state.params[k] - v).abs().max())
              for k, v in ref.params.items())
    card(f"parameter averaging (1 rank over NCCL, sync_every "
         f"{PA_SYNC_EVERY}, the MLP at B={DP_BATCH}): {int(state.step)} steps "
         f"in {wall:.3f} s; bit-equal to the plain trainer's replay of "
         f"{rounds} rounds: {same} (largest difference {gap:.3e})")
    check(int(state.step) == int(ref.step) == rounds * PA_SYNC_EVERY,
          "parameter averaging took another number of steps")
    check(same, "parameter averaging with one rank differs from the replay")


# -- phases 30-32: truncated BPTT, chunked tree serving, libemtpu -----------

# train --model lstm --tbptt at the CLI defaults (H=512, 2 layers, chunk 50,
# 8 lanes, bf16 inputs) on the golden page: 1193 train rows fold into 8
# lanes x 149 steps, trimmed to 100 (2 chunks); 2 epochs (cut from 20)
TBPTT_EPOCHS = 2
TBPTT_TIMED_EPOCHS = 5
# the same command in f32 on the card and on the CPU: each per-epoch
# train/test mse within this of the CPU's, relative (measured 6.497e-08 on
# the H100; pinned at ~15x that)
TBPTT_F32_TOL = 1e-6
# bench.py's serve_trees shape (_bench_serve_trees, _synth_gbt): 2048
# synthetic trees of depth 3 over 8 features and 32 bins (seed 7), chunks
# of 256 above 512 trees, one bucket of 32 rows, 96 request rows; the
# 256-tree ensemble of the same config stays whole
TREES = {"trees": 2048, "small": 256, "depth": 3, "features": 8,
         "bins": 32, "seed": 7, "small_seed": 3, "chunk": 256,
         "threshold": 512, "bucket": 32, "rows": 96, "rps_requests": 512}
# RF_SHAPE's forests through the chunked dispatch: 20 trees in chunks of 4
RF_CHUNK = {"chunk": 4, "threshold": 8}
# bench.py's gate on the small ensemble's rows/s under the chunked config
# against the plain engine's (best of 3 each)
SMALL_RPS_GATE = 0.9


def tbptt_cli(root: Path, name: str, args: list[str]
              ) -> tuple[dict, list, Path, float]:
    """``train --model lstm --tbptt`` through the CLI on the golden page
    for TBPTT_EPOCHS epochs (plus ``args``), with a JSONL record per epoch
    and a checkpoint, every LSTM kernel counter reset just before and read
    just after. Returns the counts, the epoch records, the checkpoint
    directory and the wall seconds."""
    from euromillioner_tpu_torch import cli

    out = root / "build" / "chip_smoke"
    ckdir = out / name
    jsonl = out / f"{name}.jsonl"
    shutil.rmtree(ckdir, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    jsonl.unlink(missing_ok=True)
    argv = ["train", "--model", "lstm", "--tbptt", "--html-file",
            str(root / GOLDEN_HTML), f"train.epochs={TBPTT_EPOCHS}",
            f"train.metrics_jsonl={jsonl}", "--save", str(ckdir), *args]
    reset_lstm_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = lstm_counts()
    check(rc == 0, f"{name} exited {rc}")
    rounds = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    for r in rounds:
        print(f"{name} [{r['round']}]: train-mse {r['train-mse']!r} "
              f"test-mse {r['test-mse']!r}")
    check(len(rounds) == TBPTT_EPOCHS,
          f"{name}: {len(rounds)} epoch records, expected {TBPTT_EPOCHS}")
    check(all(math.isfinite(r[k]) for r in rounds
              for k in ("train-mse", "test-mse")), f"{name}: non-finite mse")
    return counts, rounds, ckdir, wall


def tbptt_setup(root: Path, device: str, dtype):
    """The CLI's TBPTT run set up by hand: the model from seed 0, its f32
    params, adam, the step, the folded train history (inputs in ``dtype``)
    and the validation fold."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config
    from euromillioner_tpu_torch.data.pipeline import pipeline_from_html
    from euromillioner_tpu_torch.models.lstm import build_tbptt_lstm
    from euromillioner_tpu_torch.nn import losses
    from euromillioner_tpu_torch.train.optim import from_train_config
    from euromillioner_tpu_torch.train.tbptt import (fold_history,
                                                     make_tbptt_train_step)

    cfg = Config()
    tr, va = pipeline_from_html((root / GOLDEN_HTML).read_text())
    chunk, lanes = cfg.train.tbptt_chunk_len, cfg.train.tbptt_lanes
    x, y = fold_history(tr.full_rows(), lanes)
    t = (x.shape[1] // chunk) * chunk
    xv, yv = fold_history(va.full_rows(), 1)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    model = build_tbptt_lstm(HIDDEN, LAYERS, OUTPUTS, in_features=FEATURES,
                             generator=torch.Generator().manual_seed(
                                 cfg.train.seed), device=device)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = from_train_config(cfg.train)
    step = make_tbptt_train_step(model, opt, losses.mse, chunk_len=chunk)
    return {"model": model, "params": params, "opt": opt, "step": step,
            "x": put(x[:, -t:], dtype), "y": put(y[:, -t:], torch.float32),
            "xv": put(xv, dtype), "yv": put(yv, torch.float32),
            "chunks": t // chunk, "lanes": lanes, "steps": t}


def phase_tbptt(root: Path) -> dict:
    """Phase 30: ``train --model lstm --tbptt`` at the CLI defaults (bf16)
    for TBPTT_EPOCHS epochs — no kernel launched (TBPTT carries (h, c)
    into each chunk, so every LSTM layer scans: the fused kernels start
    from a zero carry), the checkpoint reloaded into the TrainState and
    its validation mse recomputed; ms per epoch and per chunk timed on the
    step itself; then the same command in f32 on the card and on the CPU,
    per-epoch mse within TBPTT_F32_TOL. Returns the LSTM kernels' launches
    over the card's CLI runs (all 0)."""
    from euromillioner_tpu_torch.nn import losses
    from euromillioner_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                          load_train_state)
    from euromillioner_tpu_torch.train.tbptt import (apply_with_states,
                                                     init_states)
    from euromillioner_tpu_torch.train.trainer import TrainState

    t_phase = time.perf_counter()
    counts, rounds, ckdir, wall = tbptt_cli(root, "tbptt_bf16", [])
    su = tbptt_setup(root, "cuda", torch.bfloat16)
    card(f"train --tbptt (bf16 inputs, H={HIDDEN}, {LAYERS} layers, "
         f"{su['lanes']} lanes x {su['steps']} steps, {su['chunks']} chunks "
         f"of 50 an epoch): {TBPTT_EPOCHS} epochs in {wall:.3f} s of CLI "
         f"wall (data, model, evals and checkpoint included); launches "
         f"{json.dumps(counts)}")
    check(not any(counts.values()),
          f"train --tbptt launched a fused kernel: {counts}")

    # the checkpoint: the whole TrainState back, and its validation mse
    path = latest_checkpoint(str(ckdir))
    like = TrainState(params=su["params"],
                      opt_state=su["opt"].init(su["params"]),
                      step=torch.zeros((), dtype=torch.int32, device="cuda"))
    t0 = time.perf_counter()
    state = load_train_state(path, like)
    reload_s = time.perf_counter() - t0
    with torch.no_grad():
        out, _ = apply_with_states(
            su["model"], state.params, su["xv"],
            init_states(su["model"], 1, su["xv"].dtype))
        val = float(losses.mse(out.to(torch.float32), su["yv"]))
    want = rounds[-1]["test-mse"]
    card(f"train --tbptt checkpoint {Path(path).name}: "
         f"{len(state.params)} params + adam state reloaded in "
         f"{reload_s * 1e3:.3f} ms, step {int(state.step)}, adam count "
         f"{int(state.opt_state['count'])}; validation mse {val!r} against "
         f"the logged {want!r} (bit-equal {val == want})")
    check(int(state.step) == TBPTT_EPOCHS and int(state.opt_state["count"])
          == TBPTT_EPOCHS * su["chunks"], "checkpoint step or count")
    check(abs(val - want) <= 1e-6 * abs(want),
          "the reloaded params' validation mse differs from the log")

    # ms per epoch and per chunk, on the step itself
    reset_lstm_counts()
    su["step"](su["params"], su["opt"].init(su["params"]), su["x"], su["y"])
    opt_state = su["opt"].init(su["params"])
    walls = []
    for _ in range(TBPTT_TIMED_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        su["step"](su["params"], opt_state, su["x"], su["y"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(walls)
    check(not any(lstm_counts().values()), "the timed TBPTT step launched "
          "a fused kernel")
    card(f"tbptt step (bf16, B={su['lanes']}, {su['chunks']} chunks of 50): "
         f"{ms:.3f} ms/epoch (median of {TBPTT_TIMED_EPOCHS}: "
         f"{[round(w, 3) for w in walls]}), {ms / su['chunks']:.3f} "
         f"ms/chunk (forward, backward and adam)")

    # f32 on the card against f32 on the CPU
    f32, rounds_c, ck_c, wall_c = tbptt_cli(
        root, "tbptt_f32", ["model.compute_dtype=float32"])
    check(not any(f32.values()), f"f32 train --tbptt launched {f32}")
    _, rounds_h, ck_h, wall_h = tbptt_cli(
        root, "tbptt_f32_cpu", ["model.compute_dtype=float32", "--device",
                                "cpu"])
    rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(rounds_c, rounds_h)
              for k in ("train-mse", "test-mse"))
    card(f"train --tbptt f32: card {wall_c:.3f} s, CPU {wall_h:.3f} s; "
         f"per-epoch mse card vs CPU max rel {rel:.3e} (tol "
         f"{TBPTT_F32_TOL:.0e})")
    check(rel <= TBPTT_F32_TOL, f"f32 TBPTT card vs CPU mse differ by {rel}")
    for d in (ckdir, ck_c, ck_h):
        shutil.rmtree(d, ignore_errors=True)
    card(f"tbptt: wall {time.perf_counter() - t_phase:.3f} s")
    return {k: counts[k] + f32[k] for k in counts}


def synth_gbt(n_trees: int, seed: int):
    """bench.py's _synth_gbt on the card: ``n_trees`` stacked complete
    trees of TREES' depth over its features and bins, leaves N(0, 0.1^2),
    base margin 0, reg:logistic."""
    import numpy as np

    from euromillioner_tpu_torch.trees import binning
    from euromillioner_tpu_torch.trees.gbt import Booster

    d, f, bins = TREES["depth"], TREES["features"], TREES["bins"]
    rng = np.random.default_rng(seed)
    cuts = binning.quantile_cuts(
        rng.normal(size=(256, f)).astype(np.float32), bins)
    n_nodes = 2 ** (d + 1) - 1
    trees = {
        "feature": rng.integers(0, f, (n_trees, n_nodes)).astype(np.int32),
        "split_bin": rng.integers(0, bins,
                                  (n_trees, n_nodes)).astype(np.int32),
        "is_leaf": np.zeros((n_trees, n_nodes), bool),
        "leaf_value": rng.normal(
            scale=0.1, size=(n_trees, n_nodes)).astype(np.float32),
    }
    trees["is_leaf"][:, 2 ** d - 1:] = True
    return Booster({"objective": "reg:logistic", "max_depth": d}, cuts,
                   trees, 0.0, device="cuda")


def tree_engine(backend, bucket: int, **kw):
    from euromillioner_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(backend, buckets=(bucket,), max_wait_ms=1.0, **kw)


def tree_replies(eng, x, bucket: int):
    """Replies to ``x`` sent as bucket-sized requests at once."""
    import numpy as np

    futs = [eng.submit(x[i:i + bucket]) for i in range(0, len(x), bucket)]
    return np.concatenate([f.result(HTTP_WAIT) for f in futs])


def tree_pass_ms(eng, x, bucket: int, runs: int = 5) -> float:
    """Median wall milliseconds of one pass of ``x`` through the engine."""
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        tree_replies(eng, x, bucket)
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def tree_rps(backend, rows) -> float:
    """bench.py's rps: 64 single-row warmup requests, then the best of 3
    passes of TREES['rps_requests'] single-row requests."""
    n = TREES["rps_requests"]
    with tree_engine(backend, TREES["bucket"]) as eng:
        for f in [eng.submit(rows[i]) for i in range(64)]:
            f.result(HTTP_WAIT)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            futs = [eng.submit(rows[i % len(rows)]) for i in range(n)]
            for f in futs:
                f.result(HTTP_WAIT)
            best = max(best, n / (time.perf_counter() - t0))
    return best


def phase_chunked_trees(root: Path) -> None:
    """Phase 31: the chunked tree dispatch (``serve.trees.chunk``) at
    bench.py's serve_trees shape on the card: a 2048-tree GBT in chunks of
    256 served bit-equal to ``Booster.predict`` and to the unchunked
    engine, the ledger's tree-table peak within two blocks, a ``serve.chunk``
    fault failing only its batch, ``serve_tree_chunks_total`` read from
    ``/metrics`` over HTTP; the 256-tree ensemble under the same config on
    the whole-ensemble path with its rows/s beside the plain engine's;
    then RF_SHAPE's classifier (chunks of 4) bit-equal and its regressor
    with the approximate mean inside the (rf, chunked_mean) envelope.
    bench.py's AOT half of serve_trees (warm restart, compile counts)
    waits for the port's AOT store."""
    import threading

    import numpy as np

    from euromillioner_tpu_torch.core.precision import serve_envelope
    from euromillioner_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                    inject)
    from euromillioner_tpu_torch.serve.session import GBTBackend, RFBackend
    from euromillioner_tpu_torch.serve.transport import make_server
    from euromillioner_tpu_torch.trees import DMatrix

    t_phase = time.perf_counter()
    bucket, chunk, thr = TREES["bucket"], TREES["chunk"], TREES["threshold"]
    rows = np.random.default_rng(1).normal(
        size=(256, TREES["features"])).astype(np.float32)
    sample = rows[:TREES["rows"]]
    big = synth_gbt(TREES["trees"], TREES["seed"])
    direct = big.predict(DMatrix(sample))
    backend = GBTBackend(big, chunk=chunk, chunk_threshold=thr)
    check(backend.chunked is not None, "2048 trees did not serve chunked")
    bb = backend.chunked.block_bytes
    with tree_engine(backend, bucket) as eng:
        out = tree_replies(eng, sample, bucket)
        chunked_ms = tree_pass_ms(eng, sample, bucket)
        st = eng.stats()
        srv = make_server(eng, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            _, _, metrics = http_text(url, "/metrics")
            _, _, health = http_text(url, "/healthz")
        finally:
            srv.shutdown()
            srv.server_close()
    with tree_engine(GBTBackend(synth_gbt(TREES["trees"], TREES["seed"])),
                     bucket) as eng:
        whole = tree_replies(eng, sample, bucket)
        whole_ms = tree_pass_ms(eng, sample, bucket)
    same_direct = out.tobytes() == direct.tobytes()
    same_whole = out.tobytes() == whole.tobytes()
    trees = st["trees"]
    peak = st["budget"]["peak"]["tree_tables"]
    counter = [ln for ln in metrics.splitlines()
               if ln.startswith("serve_tree_chunks_total")]
    print(f"chunked GBT ({TREES['trees']} trees, depth {TREES['depth']}, "
          f"{trees['n_chunks']} chunks of {chunk}, {bb} bytes a block): "
          f"replies bit-equal to Booster.predict {same_direct}, to the "
          f"unchunked engine {same_whole}; stats trees {json.dumps(trees)}; "
          f"ledger tree_tables peak {peak} bytes (<= 2 x {bb}), now "
          f"{st['budget']['bytes']['tree_tables']}; /metrics {counter}; "
          f"/healthz tree_chunks {json.loads(health).get('tree_chunks')}")
    card(f"chunked GBT pass of {len(sample)} rows in {bucket}-row "
         f"requests: {chunked_ms:.3f} ms chunked, {whole_ms:.3f} ms whole "
         f"ensemble (median of 5)")
    check(same_direct and same_whole, "chunked GBT replies differ")
    check(0 < peak <= 2 * bb, f"tree_tables peak {peak} > 2 x {bb}")
    check(st["budget"]["bytes"]["tree_tables"] == 0, "window not unwound")
    check(len(counter) == 1 and int(float(counter[0].split()[-1]))
          == trees["chunks"], "serve_tree_chunks_total")

    plan = FaultPlan([FaultSpec(point="serve.chunk", raises=RuntimeError,
                                hits=(3,))])
    with inject(plan):
        with tree_engine(backend, bucket, warmup=False) as eng:
            try:
                eng.submit(sample[:bucket]).result(HTTP_WAIT)
                failed = False
            except RuntimeError:
                failed = True
            again = eng.submit(sample[:bucket]).result(HTTP_WAIT)
            fst = eng.stats()
    print(f"chunked GBT serve.chunk fault at the 3rd chunk: batch failed "
          f"{failed}, fired {plan.fired_count('serve.chunk')}, next batch "
          f"bit-equal {again.tobytes() == direct[:bucket].tobytes()}, "
          f"errors {fst['errors']}, tree_tables now "
          f"{fst['budget']['bytes']['tree_tables']}")
    check(failed and plan.fired_count("serve.chunk") == 1
          and fst["errors"] == 1, "the serve.chunk fault")
    check(again.tobytes() == direct[:bucket].tobytes()
          and fst["budget"]["bytes"]["tree_tables"] == 0,
          "the batch after the fault")

    small = GBTBackend(synth_gbt(TREES["small"], TREES["small_seed"]),
                       chunk=chunk, chunk_threshold=thr)
    check(small.chunked is None, "256 trees took the chunked path")
    rps_cfg = tree_rps(small, rows)
    rps_plain = tree_rps(GBTBackend(synth_gbt(TREES["small"],
                                              TREES["small_seed"])), rows)
    ratio = rps_cfg / rps_plain
    card(f"{TREES['small']}-tree GBT under serve.trees.chunk={chunk} "
         f"(threshold {thr}): whole-ensemble path; {rps_cfg:.1f} rows/s "
         f"against the plain engine's {rps_plain:.1f} (best of 3): "
         f"{ratio:.3f}, bench.py's gate {SMALL_RPS_GATE} "
         f"{'met' if ratio >= SMALL_RPS_GATE else 'MISSED'}")

    x, y, score = rf_data()
    rsample = x[:TREES["rows"]]
    for classification, label in ((True, y), (False, score)):
        model = grow_forest(classification, x, label, RF_SHAPE["trees"],
                            "cuda")[0]
        what = "classifier" if classification else "regressor"
        b = RFBackend(model, chunk=RF_CHUNK["chunk"],
                      chunk_threshold=RF_CHUNK["threshold"],
                      approx_mean=not classification)
        check(b.chunked is not None, f"the RF {what} did not serve chunked")
        with tree_engine(b, bucket) as eng:
            got = tree_replies(eng, rsample, bucket)
            rst = eng.stats()
        want = model.predict(rsample)
        if classification:
            with tree_engine(RFBackend(model), bucket) as eng:
                plain = tree_replies(eng, rsample, bucket)
            ok = (got.tobytes() == want.tobytes()
                  and got.tobytes() == plain.tobytes())
            print(f"chunked RF classifier ({RF_SHAPE['trees']} trees in "
                  f"{b.chunked.n_chunks} chunks of {RF_CHUNK['chunk']}): "
                  f"replies bit-equal to predict and to the unchunked "
                  f"engine {ok}")
            check(ok, "chunked RF classifier replies differ")
        else:
            env = serve_envelope("rf", "chunked_mean")
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            prec = rst["precision"]
            print(f"chunked RF regressor, approx mean ({b.chunked.n_chunks}"
                  f" chunks of {RF_CHUNK['chunk']}): profile "
                  f"{prec['profile']}, rel error {rel:.3e} against the "
                  f"whole-forest predict (envelope {env:.0e}), drift checks "
                  f"{prec['drift_checks']}, breaches "
                  f"{prec['envelope_breaches']}")
            check(prec["profile"] == "chunked_mean" and rel <= env
                  and prec["envelope_breaches"] == 0,
                  "the approximate chunked mean left its envelope")
    print("serve_trees: bench.py's AOT half (warm restart, compile counts) "
          "waits for the port's AOT store (ROADMAP queue 1 item 10)")
    card(f"chunked trees: wall {time.perf_counter() - t_phase:.3f} s")


class _PageStub:
    """A localhost HTTP server answering GETs with the statuses of
    ``script`` in order (the last repeats); 200 carries ``body``."""

    def __init__(self, script: list[int], body: bytes):
        import http.server
        import threading

        hits: list = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                hits.append(self.path)
                status = script[min(len(hits), len(script)) - 1]
                data = body if status == 200 else b"unavailable"
                self.send_response(status)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.hits = hits
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/results"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def phase_native_reference(root: Path, reference: dict) -> int:
    """Phase 32: ``libemtpu`` built from ``native/emtpu.cpp`` by the
    port's loader on this machine (the phase fails on the Python path);
    the ``fetch`` CSV of the golden page read natively bit-equal to the
    Python parse; then ``reference`` without ``--html-file``, its
    ``data.url`` a localhost server of the golden page whose first GET
    answers 503: one retry, the printed boolean and both boosters'
    predictions bit-equal to phase 9's ``--html-file`` run, timed, K3
    launched as there. Returns K3's launches in that run."""
    import numpy as np

    from euromillioner_tpu_torch import app, cli
    from euromillioner_tpu_torch.config import Config
    from euromillioner_tpu_torch.data import csvio
    from euromillioner_tpu_torch.ops.fused_histogram import FUSED_HISTOGRAM
    from euromillioner_tpu_torch.utils import native_lib

    # a build of its own into a fresh directory, timed: the one this
    # process loaded may come from an earlier phase's first use
    import tempfile

    kept = native_lib.BUILD_DIR
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        native_lib.BUILD_DIR = Path(tmp)
        try:
            t0 = time.perf_counter()
            fresh = native_lib.build()
            build_s = time.perf_counter() - t0
        finally:
            native_lib.BUILD_DIR = kept
    lib = native_lib.get()
    print(f"libemtpu: {native_lib.SOURCE.name} built by the loader with "
          f"{native_lib._compiler()} {' '.join(native_lib.CXX_FLAGS)} in "
          f"{build_s:.3f} s ({'ok' if fresh else 'FAILED'}); this process "
          f"loaded {lib.version() if lib else None}")
    check(fresh is not None and native_lib.available(),
          "libemtpu did not build or load")

    out = root / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    csv = str(out / "fetch.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["fetch", "--html-file", str(root / GOLDEN_HTML),
                       "--output", csv])
    check(rc == 0, f"fetch exited {rc}")
    native, _ = csvio._read_csv_native(csv, True)
    check(native is not None, "the native CSV parse failed")
    fast = csvio.read_csv(csv, label_column=0)
    real = native_lib.get
    native_lib.get = lambda: None
    try:
        slow = csvio.read_csv(csv, label_column=0)
    finally:
        native_lib.get = real
    same = (fast[0].tobytes() == slow[0].tobytes()
            and fast[1].tobytes() == slow[1].tobytes() and fast[2] == slow[2])
    print(f"fetch CSV {native.shape[0]} x {native.shape[1]}: native read "
          f"bit-equal to the Python parse {same}")
    check(same, "native and Python CSV parses differ")

    stub = _PageStub([503, 200], (root / GOLDEN_HTML).read_bytes())
    runs = []
    pipeline = app.run_reference_pipeline

    def recorded(*args, **kw):
        runs.append(pipeline(*args, **kw))
        return runs[-1]

    class Messages(logging.Handler):
        def __init__(self):
            super().__init__()
            self.seen: list[str] = []

        def emit(self, record):
            self.seen.append(record.getMessage())

    buf = io.StringIO()
    messages = Messages()
    port_logger = logging.getLogger("euromillioner_tpu_torch")
    port_logger.addHandler(messages)
    app.run_reference_pipeline = recorded
    FUSED_HISTOGRAM.launches = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["reference", f"data.url={stub.url}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        app.run_reference_pipeline = pipeline
        port_logger.removeHandler(messages)
        stub.close()
    launches = FUSED_HISTOGRAM.launches
    lines = buf.getvalue().strip().splitlines() or [None]
    retries = sum("retrying" in m for m in messages.seen)
    check(rc == 0 and len(runs) == 1, f"reference exited {rc}")
    got, ref = runs[0], reference["run"]
    same = {name: getattr(got, name).tobytes() == getattr(ref, name).tobytes()
            for name in ("predictions", "predictions_test")}
    cfg = Config()
    want = 2 * cfg.gbt.nround * (cfg.gbt.max_depth + 1)
    card(f"reference fetching data.url (localhost, first GET 503): exit "
         f"{rc}, {len(stub.hits)} GETs, {retries} retry line, printed "
         f"{lines[-1]!r} (the --html-file run printed "
         f"{reference['printed']!r}), predictions bit-equal {same}, K3 "
         f"launches {launches}, wall {wall:.3f} s (backoff and the "
         f"reference's pre-request jitter included)")
    check(len(stub.hits) == 2 and retries == 1, "not exactly one retry")
    check(lines[-1] == reference["printed"] and all(same.values()),
          "reference through data.url differs from --html-file")
    check(launches == want, f"K3 launched {launches}, expected {want}")
    return launches


# -- phase 33: the AOT program store ------------------------------------------

# The four program families of the store at full width, each cut to one
# program of its ladder (a package takes tens of seconds to compile): the
# f32 MLP (config 1) at bucket 8; the seeded 100M Wide&Deep at bf16, bucket
# 8 (K4a); the trained flagship's fused padded program at (8 rows, 16
# steps) (K1); one f32 rung of its step-scheduler ladder (32 slots, block
# 8) with the rung's finishers' gather; the 2048-tree serve_trees ensemble's
# chunk program at chunk 256, bucket 32. Each family's requests are sent
# one at a time, each one micro-batch, so the cold and the warm run cut the
# same batches.
AOT_FAMILIES = {
    "mlp": ("mlp", ["model.compute_dtype=float32", "serve.buckets=8"]),
    "wide_deep": ("wide_deep", ["serve.precision=bf16", "serve.buckets=8"]),
    "padded": ("lstm", ["model.compute_dtype=float32",
                        "serve.precision=fused", "serve.scheduler=batch",
                        "serve.buckets=8", "serve.seq_buckets=16"]),
    "ladder": ("lstm", ["model.compute_dtype=float32",
                        "serve.scheduler=continuous", "serve.max_slots=32",
                        "serve.step_block=8"]),
    "trees": ("gbt", ["serve.buckets=32", "serve.trees.chunk=256",
                      "serve.trees.chunk_threshold=512"]),
}
AOT_REQUESTS = 8
# a phase's processes: the cold ones compile concurrently
AOT_TIMEOUT_S = 900
# store on against store off (eager) on the card, f32: the JAX package's NN
# pin, as the CPU tests hold it (tests/test_torch_aot.py)
AOT_F32_RTOL = 1e-5
AOT_F32_ATOL = 1e-6


def aot_artifacts(root: Path, flagship: Path) -> dict:
    """Each family's model: the seeded MLP and Wide&Deep as serving
    checkpoints, the trained flagship (``flagship``), the 2048-tree
    ensemble as a model JSON. Returns {family: (model flag, path)}."""
    from euromillioner_tpu_torch.models.mlp import build_mlp
    from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
    from euromillioner_tpu_torch.train.checkpoint import save_checkpoint

    out = root / "build" / "chip_aot"
    mlp = out / "mlp"
    save_checkpoint(str(mlp), build_mlp(
        generator=torch.Generator().manual_seed(SEED), device="cuda"),
        step=1)
    wd = out / "wide_deep"
    model = build_wide_deep(generator=torch.Generator().manual_seed(SEED),
                            device="cuda")
    save_checkpoint(str(wd), model, step=1)
    del model
    torch.cuda.empty_cache()
    trees = out / "trees.json"
    synth_gbt(TREES["trees"], TREES["seed"]).save_model(str(trees))
    return {"mlp": ("--checkpoint", mlp),
            "wide_deep": ("--checkpoint", wd),
            "padded": ("--checkpoint", flagship),
            "ladder": ("--checkpoint", flagship),
            "trees": ("--model-file", trees)}


def aot_requests(family: str):
    """The family's requests: 8-row batches (MLP, Wide&Deep), 32-row
    batches of the ensemble's 8 features, or 4-16-step sequences."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    if family == "mlp":
        return [rng.normal(size=(8, 10)).astype(np.float32)
                for _ in range(AOT_REQUESTS)]
    if family == "wide_deep":
        rows = bench_rows(8 * AOT_REQUESTS)
        return [rows[i:i + 8] for i in range(0, len(rows), 8)]
    if family == "trees":
        return [rng.normal(size=(TREES["bucket"], TREES["features"])
                           ).astype(np.float32) for _ in range(3)]
    return [rng.normal(size=(int(rng.integers(4, 17)), FEATURES)
                       ).astype(np.float32) for _ in range(AOT_REQUESTS)]


def aot_backend(family: str, arg: str, path: str, device="cuda"):
    """The family's serving backend and config, as ``serve`` loads them."""
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.serve.continuous import \
        load_recurrent_backend
    from euromillioner_tpu_torch.serve.session import load_backend

    model_type, overrides = AOT_FAMILIES[family]
    cfg = apply_overrides(Config(), overrides)
    if model_type == "lstm":
        return load_recurrent_backend(cfg, path, device=device), cfg
    if arg == "--model-file":
        return load_backend(model_type, None, cfg, device=device,
                            model_file=path), cfg
    return load_backend(model_type, path, cfg, device=device), cfg


def aot_engine(backend, cfg, store):
    """The engine ``serve`` builds over ``backend``, with ``store`` (None:
    eager)."""
    from euromillioner_tpu_torch.serve.continuous import make_sequence_engine
    from euromillioner_tpu_torch.serve.engine import make_row_engine

    if backend.family == "lstm":
        return make_sequence_engine(backend, cfg, aot=store)
    return make_row_engine(backend, cfg, aot=store)


def aot_serve(family: str, backend, cfg, store) -> dict:
    """One family served from ``store`` (None: eagerly): the milliseconds
    from the engine's start to its first reply (the model's load
    excluded), every request's reply, and K1's and K4a's launches while
    serving them (the engine's warmup excluded)."""
    import numpy as np

    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD
    from euromillioner_tpu_torch.ops.wide_onehot import WIDE_ONEHOT_FWD

    reqs = aot_requests(family)
    t0 = time.perf_counter()
    eng = aot_engine(backend, cfg, store)
    try:
        FUSED_LSTM_FWD.launches = WIDE_ONEHOT_FWD.launches = 0
        t1 = time.perf_counter()
        replies = [eng.predict(reqs[0])]
        t2 = time.perf_counter()
        replies += [eng.predict(r) for r in reqs[1:]]
        launches = {"K1": FUSED_LSTM_FWD.launches,
                    "K4a": WIDE_ONEHOT_FWD.launches}
        stats = eng.stats()
        cache = getattr(eng, "_exec", None)
        counts = cache.counts() if cache is not None else None
        compiled = ({repr(k): v for k, v in cache.compiled.items()}
                    if cache is not None else {})
    finally:
        eng.close()
    return {"family": family, "first_request_ms": (t2 - t0) * 1e3,
            "first_reply_ms": (t2 - t1) * 1e3,
            "replies": np.stack(replies), "launches": launches,
            "stats": stats, "counts": counts, "compiled": compiled}


def aot_worker(role: str, families: list, store_root: str,
               out_dir: str) -> int:
    """One process of phase 33: ``cold`` serves each family from an empty
    store (every program compiled, saved and loaded back), ``warm`` from
    the store the cold process left; each family's result is saved to
    ``out_dir/<family>_<role>.pt``. Run in a child process."""
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.serve.aotstore import AotStore

    resolve_device("cuda")
    spec = json.loads(Path(out_dir, "artifacts.json").read_text())
    if role == "warm":
        # a loaded package's first call of a custom op (K1, K4a) imports
        # torch._dynamo, once a process: timed apart, first
        t0 = time.perf_counter()
        importlib.import_module("torch._dynamo")
        import_s = time.perf_counter() - t0
        print(f"aot-import: {import_s:.3f}", flush=True)
        Path(out_dir, "warm_import_s").write_text(f"{import_s:.3f}")
    for family in families:
        arg, path = spec[family]
        t0 = time.perf_counter()
        backend, cfg = aot_backend(family, arg, path)
        load_s = time.perf_counter() - t0
        store = AotStore(str(Path(store_root) / family))
        res = aot_serve(family, backend, cfg, store)
        res["load_s"] = load_s
        if role == "warm":
            res["eager"] = aot_serve(family, backend, cfg, None)["replies"]
        if family == "trees":
            import numpy as np

            res["predict"] = np.stack(
                [backend.predict(x) for x in aot_requests(family)])
        print("aot-result: " + json.dumps(
            {k: v for k, v in res.items()
             if k in ("family", "first_request_ms", "counts", "launches",
                      "compiled")}, default=str), flush=True)
        torch.save(res, Path(out_dir) / f"{family}_{role}.pt")
    return 0


def aot_children(root: Path, role: str, groups: list, store_root: Path,
                 out: Path, inductor: Path, extra: list | None = None
                 ) -> None:
    """Start one ``aot_worker`` child per group of families and one child
    per command line of ``extra``, all at once, each with a fresh empty
    Inductor cache of its own; wait for all."""
    env = dict(os.environ, PYTHONPATH=str(root))
    argvs = [([sys.executable, "-c", "import sys, chip_smoke as c; "
               f"sys.exit(c.aot_worker({role!r}, {fams!r}, "
               f"{str(store_root)!r}, {str(out)!r}))"], fams)
             for fams in groups]
    argvs += [(argv, argv[3:5]) for argv in extra or ()]
    procs = []
    try:
        for i, (argv, what) in enumerate(argvs):
            cache = inductor / f"{role}{i}"
            shutil.rmtree(cache, ignore_errors=True)
            log = open(out / f"{role}{i}.log", "w")
            procs.append((subprocess.Popen(
                argv, cwd=root,
                env=dict(env, TORCHINDUCTOR_CACHE_DIR=str(cache)),
                stdout=log, stderr=subprocess.STDOUT), log, what))
        deadline = time.monotonic() + AOT_TIMEOUT_S
        while any(p.poll() is None for p, _l, _f in procs):
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p, log, _f in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for i, (p, _l, fams) in enumerate(procs):
        tail = (out / f"{role}{i}.log").read_text().splitlines()[-15:]
        if p.returncode != 0:
            print("\n".join(tail))
        check(p.returncode == 0, f"aot {role} child for {fams} exited "
              f"{p.returncode}")


def phase_aot(root: Path, flagship: Path, keep: Path | None = None,
              beside=None) -> dict:
    """The AOT program store at full width on the card (see AOT_FAMILIES):
    cold children compile each family into a fresh store (concurrently,
    each with an empty Inductor cache), then a warm child restarts every
    family from those stores: zero compiles, replies bit-identical to the
    cold run's, the store-on/off gap, trees bit-equal to ``predict``, K1's
    and K4a's launches from inside the loaded packages, each path held
    against its plain version on the CPU. Then ``aot prewarm`` through the
    CLI, ``aot ls|verify``, and a truncated blob quarantined on the card.
    ``keep``: the warm ladder store and the Wide&Deep checkpoint move
    there for phase 34 instead of being removed. ``beside(spec)``: more
    command lines to run with the cold children (phase 35's). Returns K1's
    and K4a's launches on the warm paths."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import rel_error

    out = root / "build" / "chip_aot"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    print("aot cuts (ladder size only; widths full): the MLP and Wide&Deep "
          "at bucket 8 of serve.buckets' 8, 32, 128; the padded program at "
          "8 rows x 16 steps of serve.buckets' 8, 32, 128 x "
          "serve.seq_buckets' 8, 16, 32, 64; the step ladder's one rung "
          "(serve.step_block 8, 32 slots); the trees at bucket 32, chunk "
          f"256 (bench.py's serve_trees); {AOT_REQUESTS} requests a family, "
          "3 for the trees")
    spec = aot_artifacts(root, flagship)
    (out / "artifacts.json").write_text(json.dumps(
        {k: (a, str(p)) for k, (a, p) in spec.items()}))
    stores, inductor = out / "stores", out / "inductor"
    # `aot prewarm` through the CLI (the trees, into a store of its own)
    # compiles beside the cold children
    model_type, overrides = AOT_FAMILIES["trees"]
    prewarm = [sys.executable, "-m", "euromillioner_tpu_torch", "aot",
               "prewarm", "--model-type", model_type, "--model-file",
               str(spec["trees"][1]), "--dir", str(out / "cli_store"),
               *overrides]
    t0 = time.perf_counter()
    aot_children(root, "cold", [[f] for f in AOT_FAMILIES], stores, out,
                 inductor, extra=[prewarm, *(beside(spec) if beside else [])])
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aot_children(root, "warm", [list(AOT_FAMILIES)], stores, out, inductor)
    warm_s = time.perf_counter() - t0
    card(f"aot: cold children (one a family, and `aot prewarm`, all at "
         f"once, empty Inductor caches) {cold_s:.1f} s; the warm child "
         f"(every family, and each again eagerly) {warm_s:.1f} s, of which "
         f"{(out / 'warm_import_s').read_text()} s importing torch._dynamo "
         f"(what a package's first custom-op call imports, once a "
         f"process; the warm figures below exclude it)")
    launches = {}
    for family in AOT_FAMILIES:
        cold = torch.load(out / f"{family}_cold.pt", weights_only=False)
        warm = torch.load(out / f"{family}_warm.pt", weights_only=False)
        for key, (secs, nbytes) in cold["compiled"].items():
            card(f"aot {family}: compiled {key} in {secs:.3f} s "
                 f"({nbytes / 2**20:.2f} MB package)")
        aot_w = warm["stats"]["aot"]
        card(f"aot {family}: first request served "
             f"{cold['first_request_ms']:.1f} ms cold (from the engine's "
             f"start, compiles included) vs {warm['first_request_ms']:.1f} "
             f"ms warm ({aot_w['hits']} package(s) loaded in "
             f"{aot_w['load_ms']:.3f} ms); the first reply alone "
             f"{cold['first_reply_ms']:.3f} / {warm['first_reply_ms']:.3f} "
             f"ms; the model's load {warm['load_s']:.2f} s")
        check(cold["counts"]["compiles"] >= 1, f"aot {family}: the cold run "
              "compiled nothing")
        check(warm["counts"]["compiles"] == 0, f"aot {family}: the warm run "
              f"compiled {warm['counts']['compiles']} program(s)")
        same = np.array_equal(cold["replies"], warm["replies"])
        gap = rel_error(warm["replies"], warm["eager"])
        worst = float(np.abs(warm["replies"] - warm["eager"]).max())
        card(f"aot {family}: warm compiles 0, replies bit-identical to the "
             f"cold run's {same}; store on vs off (eager) rel {gap:.3e}, "
             f"max abs {worst:.3e}")
        check(same, f"aot {family}: warm replies differ from the cold run's")
        check(bool(np.isfinite(warm["replies"]).all()),
              f"aot {family}: non-finite replies")
        if family == "trees":
            eq = np.array_equal(warm["replies"], warm["predict"])
            card(f"aot trees: store-on replies bit-equal to predict {eq}")
            check(eq, "aot trees: replies differ from predict")
        elif family == "wide_deep":
            env = warm["stats"]["precision"]["envelope"]
            check(gap <= env, f"aot wide_deep: gap {gap:.3e} outside the "
                  f"bf16 envelope {env}")
        else:
            check(np.allclose(warm["replies"], warm["eager"],
                              rtol=AOT_F32_RTOL, atol=AOT_F32_ATOL),
                  f"aot {family}: store on vs off outside rtol "
                  f"{AOT_F32_RTOL} / atol {AOT_F32_ATOL}")
        launches[family] = warm["launches"]
        print(f"aot {family}: launches while serving from the warm store "
              f"{json.dumps(warm['launches'])}")
    # the loaded packages reach the kernels: K1 (2 layers a batch) and K4a
    # (one a batch, and one per sampled drift check of the f32 oracle)
    pad = launches["padded"]["K1"]
    check(pad == LAYERS * AOT_REQUESTS, f"aot padded: K1 launched {pad} "
          f"times, expected {LAYERS} x {AOT_REQUESTS}")
    wd = torch.load(out / "wide_deep_warm.pt", weights_only=False)
    drift = wd["stats"]["precision"]["drift_checks"]
    k4a = launches["wide_deep"]["K4a"]
    check(k4a == AOT_REQUESTS + drift, f"aot wide_deep: K4a launched {k4a} "
          f"times, expected {AOT_REQUESTS} batches + {drift} drift checks")
    aot_plain(out, spec)
    aot_cli(out, spec)
    if keep is not None:
        keep.mkdir(parents=True, exist_ok=True)
        shutil.move(str(stores / "ladder"), str(keep / "ladder"))
        shutil.move(str(spec["wide_deep"][1]), str(keep / "wide_deep"))
    shutil.rmtree(out, ignore_errors=True)
    return {"K1": pad, "K4a": k4a}


def aot_plain(out: Path, spec: dict) -> None:
    """The two kernel paths of the warm store against their plain versions:
    the same program eagerly on the CPU (plain K1, plain K4a) on the same
    requests."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import rel_error

    for family in ("padded", "wide_deep"):
        warm = torch.load(out / f"{family}_warm.pt", weights_only=False)
        arg, path = spec[family]
        backend, cfg = aot_backend(family, arg, str(path), device="cpu")
        eng = aot_engine(backend, cfg, None)
        try:
            plain = np.stack([eng.predict(r) for r in aot_requests(family)])
        finally:
            eng.close()
        err = rel_error(warm["replies"], plain)
        tol = (F32_SERVE_TOL if family == "padded"
               else warm["stats"]["precision"]["envelope"])
        kernel = "K1" if family == "padded" else "K4a"
        card(f"aot {family}: loaded packages on the card ({kernel} inside) "
             f"vs the plain version's program on the CPU: rel {err:.3e} "
             f"(tol {tol:.0e})")
        check(err <= tol, f"aot {family}: the card's replies disagree with "
              "the plain version's")
        del backend


def aot_cli(out: Path, spec: dict) -> None:
    """What ``aot prewarm`` (the 2048-tree ensemble, into a fresh store,
    run beside the cold children) printed, ``aot ls`` and ``aot verify``
    through the CLI, then a truncated blob: a counted miss on the card,
    quarantined to ``*.bad``."""
    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.serve.aotstore import AotStore

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1])

    d = out / "cli_store"
    log = (out / f"cold{len(AOT_FAMILIES)}.log").read_text().splitlines()
    rep = json.loads([ln for ln in log if ln.startswith('{"dir"')][-1])
    card(f"aot prewarm (trees, CLI, beside the cold children): "
         f"{json.dumps(rep)}")
    check(rep["saved"] == 1 and rep["errors"] == 0, "aot prewarm failed")
    rc, rep = run("aot", "ls", "--dir", str(d))
    check(rc == 0 and len(rep["entries"]) == 1, "aot ls")
    rc, rep = run("aot", "verify", "--dir", str(d))
    print(f"aot verify: exit {rc}, {json.dumps(rep)}")
    check(rc == 0 and rep["ok"] == 1, "aot verify")
    # a truncated blob: the engine's preload misses, counts and quarantines
    (blob,) = d.glob("*.aot")
    data = blob.read_bytes()
    blob.write_bytes(data[:len(data) // 2])
    from euromillioner_tpu_torch.serve.engine import InferenceEngine

    backend, cfg = aot_backend("trees", *map(str, spec["trees"]))
    eng = InferenceEngine(backend, buckets=cfg.serve.buckets, warmup=False,
                          aot=AotStore(str(d)))
    try:
        loaded = eng._exec.preload_aot()
        aot = eng._exec.aot_counts()
    finally:
        eng.close()
    bad = blob.with_name(blob.name + ".bad")
    print(f"aot truncated blob: loaded {loaded}, store counts "
          f"{json.dumps(aot)}, quarantined {bad.exists()}")
    check(loaded == 0 and aot["errors"] == 1 and bad.exists(),
          "a truncated blob was not a counted, quarantined miss")


# -- phase 34: the fleet ------------------------------------------------------

# The trained flagship behind the fleet (serve/fleet.py, serve/router.py,
# serve/supervisor.py, serve/rollout.py): every host a step scheduler of
# the f32 flagship at phase 33's ladder rung (32 slots, block 8), so
# re-routes and migrations between hosts are held bit-equal; two HTTP
# ``serve --scheduler batch serve.precision=fused`` children behind a
# ``fleet`` front end; the supervisor's respawns loaded from phase 33's warm
# ladder store; the 100M Wide&Deep rolled out from bf16 to int8w.
FLEET_CONFIG = ["model.compute_dtype=float32", "serve.scheduler=continuous",
                "serve.max_slots=32", "serve.step_block=8"]
FLEET_HTTP_HOST = ["--scheduler", "batch", "model.compute_dtype=float32",
                   "serve.precision=fused", "serve.buckets=8,32",
                   "serve.seq_buckets=16,128"]
FLEET_HTTP_SEQUENCES = 96
FLEET_LONG = {"sequences": 8, "steps": 512}
# a stage's requests: the canary split is a counter modulo 100, so a
# stage of 100 puts canary_pct of them on the candidate
FLEET_WD_BATCHES = 100
FLEET_CANARY_PCT = 50.0
# probe rounds are driven by the phase; the loops never fire by themselves
FLEET_PROBE = {"interval_s": 3600.0, "timeout_s": 5.0, "retries": 1,
               "jitter_s": 0.0, "eject_stale_probes": 2,
               "eject_breach_probes": 2, "probation_probes": 2}


def fleet_policy():
    from euromillioner_tpu_torch.serve.fleet import ProbePolicy

    return ProbePolicy(**FLEET_PROBE)


def fleet_engine(backend, store=None):
    """A fleet host's engine: the step scheduler ``serve`` builds with
    FLEET_CONFIG, eager or over the AOT store ``store``."""
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.serve.continuous import make_sequence_engine

    return make_sequence_engine(backend, apply_overrides(
        Config(), FLEET_CONFIG), aot=store)


def fleet_served(router, seqs, cls: str = "bulk") -> list:
    return [f.result(timeout=HTTP_WAIT)
            for f in [router.submit(s, cls=cls) for s in seqs]]


def fleet_compare(what: str, got, ref, direct) -> None:
    """Every reply bit-equal to the unfaulted run's and within
    F32_SERVE_TOL of the direct apply."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import rel_error

    same = all(np.array_equal(np.asarray(g), np.asarray(r))
               for g, r in zip(got, ref))
    err = rel_error(np.stack(got), direct.numpy())
    print(f"fleet {what}: {len(got)} replies bit-equal to the unfaulted "
          f"fleet's {same}; rel to the direct apply {err:.3e} (tol "
          f"{F32_SERVE_TOL:.0e})")
    check(same, f"fleet {what}: replies differ from the unfaulted fleet's")
    check(err <= F32_SERVE_TOL, f"fleet {what}: replies disagree with the "
          "direct apply")


def fleet_in_process(backend, model, faults: dict) -> None:
    """Part 1: two eager hosts behind a FleetRouter. A host killed
    mid-traffic is ejected on probe staleness and its sequences re-routed;
    a reachable host whose attainment collapses is ejected and its live
    sequences migrate (migrate_on_eject); the fleet.probe, fleet.route and
    fleet.migrate points fire once each. Zero failures, every reply
    bit-equal to the unfaulted fleet's."""
    from euromillioner_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                    inject)
    from euromillioner_tpu_torch.serve.fleet import FleetHost
    from euromillioner_tpu_torch.serve.router import FleetRouter
    from euromillioner_tpu_torch.serve.transport import healthz_body
    from euromillioner_tpu_torch.utils.errors import ServeError

    seqs = http_traffic()
    longs = governance_traffic(SEED + 34, FLEET_LONG["sequences"],
                               steps=(FLEET_LONG["steps"],
                                      FLEET_LONG["steps"] + 1))
    direct = direct_apply(model, seqs)
    direct_long = direct_apply(model, longs)
    engines = [fleet_engine(backend) for _ in range(2)]
    sick = [False]

    def probe_h0():
        body = healthz_body(engines[0])
        if sick[0]:  # the reachable host's attainment collapses
            body["attainment"] = dict(body["attainment"], interactive=0.1)
        return body

    def fleet():
        hosts = [FleetHost("h0", engines[0], probe_fn=probe_h0),
                 FleetHost("h1", engines[1])]
        return hosts, FleetRouter(hosts, policy=fleet_policy(), start=False)

    try:
        hosts, router = fleet()
        try:
            t0 = time.perf_counter()
            ref = fleet_served(router, seqs)
            ref_s = time.perf_counter() - t0
            ref_long = fleet_served(router, longs)
            st = router.stats()
        finally:
            router.close(drain_s=5)
        check(st["failed"] == 0, "the unfaulted fleet failed requests")
        card(f"fleet in process: {len(seqs)} sequences over 2 hosts of "
             f"32 slots unfaulted in {ref_s:.2f} s "
             f"({len(seqs) / ref_s:.1f} sequences/s)")
        fleet_compare("unfaulted", ref, ref, direct)
        # a host killed with sequences on it: stale probes eject it and
        # the router re-routes what it held
        hosts, router = fleet()
        try:
            futs = [router.submit(s, cls="bulk") for s in seqs]
            held = sum(1 for e in router._ledger.values() if e.host == "h1")
            hosts[1].kill()
            router.monitor.probe_once()
            router.monitor.probe_once()
            hs = router._states["h1"]
            check(not hs.admitted and "stale" in hs.ejected_reason,
                  "the killed host was not ejected as stale")
            got = [f.result(timeout=HTTP_WAIT) for f in futs]
            st = router.stats()
            print(f"fleet kill: h1 held {held} of {len(seqs)} requests "
                  f"when killed; ejected ({hs.ejected_reason[:40]}); "
                  f"rerouted {st['rerouted']}, failed {st['failed']}")
            check(st["failed"] == 0 and st["rerouted"] >= 1,
                  "the kill failed requests or re-routed none")
            fleet_compare("host kill", got, ref, direct)
        finally:
            router.close(drain_s=5)
            hosts[1].revive()
        # a reachable host's attainment collapses: SLO ejection migrates
        # its live sequences to the other host
        hosts, router = fleet()
        try:
            base = engines[0].telemetry.steps.get()
            router._states["h1"].admitted = False
            futs = [router.submit(s, cls="bulk") for s in longs]
            router._states["h1"].admitted = True
            wait_until("the long sequences are mid-flight",
                       lambda: engines[0].telemetry.steps.get() >= base + 4)
            sick[0] = True
            router.monitor.probe_once()
            router.monitor.probe_once()
            sick[0] = False
            hs = router._states["h0"]
            got = [f.result(timeout=HTTP_WAIT) for f in futs]
            st = router.stats()
            moved = int(router.telemetry.migrations("eject").get())
            print(f"fleet slo ejection: h0 ejected ({hs.ejected_reason}); "
                  f"migrated {moved} of {len(longs)} live sequences, "
                  f"rerouted {st['rerouted']}, failed {st['failed']}")
            check(not hs.admitted and "attainment" in hs.ejected_reason,
                  "the collapsed host was not ejected on attainment")
            check(moved >= 1 and st["rerouted"] == 0 and st["failed"] == 0,
                  "the SLO ejection did not migrate its sequences")
            fleet_compare("slo ejection", got, ref_long, direct_long)
        finally:
            router.close(drain_s=5)
        # fleet.probe, fleet.route and fleet.migrate, once each
        hosts, router = fleet()
        try:
            plan = FaultPlan([
                FaultSpec("fleet.probe", raises=ServeError, hits=(1,)),
                FaultSpec("fleet.route", raises=ServeError, hits=(1,)),
                FaultSpec("fleet.migrate", raises=ServeError, hits=(1,))])
            with inject(plan):
                router.monitor.probe_once()
                check(router._states["h0"].admitted,
                      "one failed probe ejected a host")
                got = fleet_served(router, seqs[:8])
                base = engines[0].telemetry.steps.get()
                router._states["h1"].admitted = False
                futs = [router.submit(s, cls="bulk") for s in longs[:2]]
                router._states["h1"].admitted = True
                wait_until("the long sequences are mid-flight",
                           lambda: engines[0].telemetry.steps.get()
                           >= base + 4)
                moved = router.migrate_host("h0", reason="drain")
                got_long = [f.result(timeout=HTTP_WAIT) for f in futs]
            st = router.stats()
            for point in ("fleet.probe", "fleet.route", "fleet.migrate"):
                faults[point] = plan.fired_count(point)
            print(f"fleet faults in process: fired {json.dumps(faults)}; "
                  f"rerouted {st['rerouted']}, migrated {moved} (one "
                  f"migration lost to the fault, its sequence finished "
                  f"where it was), failed {st['failed']}")
            check(st["failed"] == 0, "a fleet fault failed a request")
            fleet_compare("faults", got + got_long,
                          ref[:8] + ref_long[:2],
                          torch.cat([direct[:8], direct_long[:2]]))
        finally:
            router.close(drain_s=5)
    finally:
        for eng in engines:
            eng.close()


def fleet_http_children(root: Path, ckdir: Path) -> tuple:
    """Part 2's processes, started at once: two ``serve`` hosts and the
    ``fleet`` front end over them. Returns (procs, logs, urls, front)."""
    out = root / "build" / "chip_fleet"
    ports = [free_port() for _ in range(3)]
    urls = [f"http://127.0.0.1:{p}" for p in ports[:2]]
    argvs = [[sys.executable, "-m", "euromillioner_tpu_torch", "serve",
              "--model-type", "lstm", "--checkpoint", str(ckdir),
              f"serve.port={p}", *FLEET_HTTP_HOST] for p in ports[:2]]
    argvs.append([sys.executable, "-m", "euromillioner_tpu_torch", "fleet",
                  "--model-type", "lstm", "--hosts", ",".join(urls),
                  f"serve.port={ports[2]}",
                  "serve.fleet.probe_interval_ms=100",
                  "serve.fleet.probe_timeout_ms=2000",
                  "serve.fleet.eject_stale_probes=2"])
    procs, logs = [], []
    for name, argv in zip(("h0", "h1", "front"), argvs):
        log = out / f"http_{name}.log"
        logs.append(log)
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(argv, cwd=root, stdout=fh,
                                          stderr=subprocess.STDOUT))
    return procs, logs, urls, f"http://127.0.0.1:{ports[2]}"


def fleet_http(procs, logs, urls, front, model) -> int:
    """Part 2: traffic through the front end while one host child is
    SIGKILLed: no client request fails, the front end's /healthz shows the
    ejection, fused replies stay within F32_SERVE_TOL of the plain scan
    (direct apply). Returns K1's launches of the surviving host, read from
    its SIGTERM shutdown line (a SIGKILLed child reports nothing)."""
    import signal

    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)

    t0 = time.perf_counter()
    for url, proc, log in zip(urls + [front], procs, logs):
        wait_until(f"{url} answers /healthz", lambda u=url, p=proc, lg=log:
                   _answers(u, p, lg))
    up_s = time.perf_counter() - t0
    wait_until("the front end admits both hosts", lambda: all(
        h["admitted"] for h in http_call(front, "/healthz")[1]["fleet"][
            "hosts"].values()))
    seqs = http_traffic()[:FLEET_HTTP_SEQUENCES]
    direct = direct_apply(model, seqs)
    replies: list = [None] * len(seqs)
    done = [0]

    def client(c: int) -> None:
        for i in range(c, len(seqs), HTTP_CLIENTS):
            status, reply = http_call(front, "/predict",
                                      {"rows": seqs[i].tolist()})
            replies[i] = reply["predictions"] if status == 200 else None
            done[0] += 1

    t1 = time.perf_counter()
    with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
        running = [pool.submit(client, c) for c in range(HTTP_CLIENTS)]
        wait_until("a quarter of the traffic answered",
                   lambda: done[0] >= len(seqs) // 4)
        procs[1].send_signal(signal.SIGKILL)
        for r in running:
            r.result(timeout=HTTP_WAIT)
    wall = time.perf_counter() - t1
    wait_until("the front end ejects the killed host", lambda: not http_call(
        front, "/healthz")[1]["fleet"]["hosts"]["h1"]["admitted"])
    _, health = http_call(front, "/healthz")
    _, stats = http_call(front, "/stats")
    failed = sum(r is None for r in replies)
    card(f"fleet http: children up in {up_s:.1f} s; {len(seqs)} sequences "
         f"through the front end in {wall:.2f} s with h1 SIGKILLed after "
         f"{len(seqs) // 4}; failed {failed}; front end rerouted "
         f"{stats['rerouted']}; /healthz h1 "
         f"{json.dumps(health['fleet']['hosts']['h1'])}")
    check(failed == 0 and stats["failed"] == 0,
          "fleet http: client requests failed through the host kill")
    err = rel_error(torch.tensor(replies), direct)
    env = SERVE_ENVELOPES[("lstm", "fused")]
    print(f"fleet http fused replies vs the plain scan (direct apply): rel "
          f"{err:.3e} (envelope {env:.0e}, tol {F32_SERVE_TOL:.0e})")
    check(err <= F32_SERVE_TOL, "fleet http: fused replies disagree")
    rcs = []
    for i in (2, 0):  # the front end first, then the surviving host
        procs[i].send_signal(signal.SIGTERM)
        rcs.append(procs[i].wait(timeout=HTTP_WAIT))
    text = logs[0].read_text()
    check(rcs == [0, 0] and "shutting down" in text,
          f"fleet http: SIGTERM exits {rcs}: {text[-2000:]}")
    line = next(ln for ln in text.splitlines() if "kernel launches: " in ln)
    k1 = json.loads(line.split("kernel launches: ", 1)[1])[
        "emt_lstm_fwd_f32"]
    print(f"fleet http: K1 launches of the surviving host (its SIGTERM "
          f"line; the SIGKILLed host reports none) {k1}")
    check(k1 > 0, "fleet http: the surviving host never launched K1")
    return k1


def _answers(url: str, proc, log: Path) -> bool:
    try:
        return http_call(url, "/healthz")[0] == 200
    except OSError:
        check(proc.poll() is None, f"{url} exited: {log.read_text()[-2000:]}")
        return False


def fleet_supervisor(backend, model, store_dir: Path, faults: dict) -> None:
    """Part 3: hosts from phase 33's warm ladder store. A killed host is
    declared dead and respawned warm (0 compiles; a fleet.spawn fire
    retried) and probation re-admits it; a planned restart_host of a
    one-host fleet restores its slot holders into the respawned engine;
    a drain_export handoff restores a host's pool into a fresh engine;
    a scale decision aborted by fleet.scale. Replies bit-equal to the
    same store's unfaulted replies."""
    import numpy as np

    from euromillioner_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                    inject)
    from euromillioner_tpu_torch.serve.aotstore import AotStore
    from euromillioner_tpu_torch.serve.fleet import FleetHost
    from euromillioner_tpu_torch.serve.router import FleetRouter
    from euromillioner_tpu_torch.serve.supervisor import (FleetSupervisor,
                                                          SupervisorPolicy)
    from euromillioner_tpu_torch.utils.errors import ServeError

    t0 = time.perf_counter()
    importlib.import_module("torch._inductor")
    importlib.import_module("torch._dynamo")
    card(f"fleet supervisor: importing torch._inductor and torch._dynamo "
         f"(once a process, before the first package load) "
         f"{time.perf_counter() - t0:.3f} s")
    built: list = []
    spawn_s: list = []

    def spawn(name):
        t = time.perf_counter()
        eng = fleet_engine(backend, AotStore(str(store_dir)))
        spawn_s.append(time.perf_counter() - t)
        built.append(eng)
        return eng

    longs = governance_traffic(SEED + 35, FLEET_LONG["sequences"],
                               steps=(FLEET_LONG["steps"],
                                      FLEET_LONG["steps"] + 1))
    direct_long = direct_apply(model, longs)
    e0, e1 = spawn("h0"), spawn("h1")
    compiles = [e._exec.counts()["compiles"] for e in (e0, e1)]
    card(f"fleet supervisor: two hosts from the warm store in "
         f"{spawn_s[0]:.3f} / {spawn_s[1]:.3f} s, compiles {compiles}")
    check(compiles == [0, 0], "the warm store's hosts compiled")
    ref = [f.result(timeout=HTTP_WAIT) for f in
           [e0.submit(s, cls="bulk") for s in longs]]
    fleet_compare("warm store unfaulted", ref, ref, direct_long)
    pol = SupervisorPolicy(interval_s=3600.0, dead_after_probes=2,
                           spawn_retries=2, spawn_backoff_s=0.001)
    hosts = [FleetHost("h0", e0), FleetHost("h1", e1)]
    router = FleetRouter(hosts, policy=fleet_policy(), start=False)
    sup = FleetSupervisor(router, spawn, pol, start=False)
    try:
        hosts[1].kill()
        for _ in range(4):  # ejected, then past dead_after_probes
            router.monitor.probe_once()
        plan = FaultPlan([FaultSpec("fleet.spawn", raises=ServeError,
                                    hits=(1,))])
        t1 = time.perf_counter()
        with inject(plan):
            sup.tick()
        respawn_s = time.perf_counter() - t1
        faults["fleet.spawn"] = plan.fired_count("fleet.spawn")
        fresh = hosts[1].engine
        n_compiles = fresh._exec.counts()["compiles"]
        aot = fresh._exec.aot_counts()
        card(f"fleet supervisor: dead host respawned in {respawn_s:.3f} s "
             f"(the engine's build from the warm store {spawn_s[-1]:.3f} s; "
             f"one fleet.spawn fire retried), compiles {n_compiles}, store "
             f"hits {aot['hits']}, load {aot['load_ms']:.3f} ms")
        check(sup.spawns == 1 and sup.spawn_failures == 1,
              "the dead host was not respawned after one retried fire")
        check(n_compiles == 0, "the warm respawn compiled")
        router.monitor.probe_once()
        router.monitor.probe_once()
        check(router._states["h1"].admitted,
              "probation did not re-admit the respawned host")
        got = fleet_served(router, longs)
        check(router.stats()["failed"] == 0, "requests failed")
        fleet_compare("respawned fleet", got, ref, direct_long)
        # fleet.scale aborts a decision (two idle hosts: scale down)
        idle = [FleetHost(f"s{i}", e0, probe_fn=lambda: {
            "ok": True, "healthz_version": 1, "attainment": {},
            "drift_breaches": 0, "queued": 0, "mean_occupancy": 0.0})
            for i in range(2)]
        scale_router = FleetRouter(idle, policy=fleet_policy(), start=False)
        scaler = FleetSupervisor(scale_router, spawn, SupervisorPolicy(
            interval_s=3600.0, autoscale=True, scale_hysteresis=1,
            down_cooldown_s=0.0, dead_after_probes=99), start=False)
        try:
            scale_router.monitor.probe_once()
            plan = FaultPlan([FaultSpec("fleet.scale", raises=ServeError,
                                        hits=(1,))])
            with inject(plan):
                scaler.tick()
            faults["fleet.scale"] = plan.fired_count("fleet.scale")
            check(scaler.scale_aborts == 1 and scaler.scale_downs == 0,
                  "fleet.scale did not abort the decision")
        finally:
            scaler.close()
            scale_router.close(drain_s=0)
    finally:
        sup.close()
        router.close(drain_s=5)
    # a planned restart of a one-host fleet: the slot holders leave the
    # old engine as blobs and resume in the respawned one
    solo = spawn("r0")
    host = FleetHost("r0", solo)
    router = FleetRouter([host], policy=fleet_policy(), start=False)
    sup = FleetSupervisor(router, spawn, pol, start=False)
    try:
        futs = [router.submit(s, cls="bulk") for s in longs]
        wait_until("the long sequences are mid-flight",
                   lambda: solo.telemetry.steps.get() >= 4)
        t1 = time.perf_counter()
        carried = sup.restart_host("r0")
        restart_s = time.perf_counter() - t1
        got = [f.result(timeout=HTTP_WAIT) for f in futs]
        st = router.stats()
        card(f"fleet supervisor: restart_host carried {carried} of "
             f"{len(longs)} sequences into the respawned engine in "
             f"{restart_s:.3f} s (compiles "
             f"{host.engine._exec.counts()['compiles']}); rerouted "
             f"{st['rerouted']}, failed {st['failed']}")
        check(carried == len(longs) and st["rerouted"] == 0
              and st["failed"] == 0, "the restart did not carry every "
              "slot holder")
        fleet_compare("restart_host", got, ref, direct_long)
    finally:
        sup.close()
        router.close(drain_s=5)
    # the drain_export handoff: a host's pool exported, restored into a
    # fresh engine by FleetHost.respawn
    host = FleetHost("d0", spawn("d0"))
    try:
        old = host.engine
        futs = [old.submit(s, cls="bulk") for s in longs]
        wait_until("the long sequences are mid-flight",
                   lambda: old.telemetry.steps.get() >= 4)
        blobs = host.drain_export(reason="respawn")
        nfuts = host.respawn(spawn("d0"), sequences=blobs)
        got = [f.result(timeout=HTTP_WAIT) for f in nfuts]
        print(f"fleet supervisor: drain_export handed {len(blobs)} "
              f"sequences to the fresh engine")
        check(len(blobs) == len(longs), "drain_export missed sequences")
        check({np.asarray(g).tobytes() for g in got}
              == {np.asarray(r).tobytes() for r in ref},
              "the drain_export handoff's replies differ")
    finally:
        for eng in built:
            eng.close()


def fleet_rollout(wd_ckdir: Path, faults: dict) -> int:
    """Part 4: the 100M Wide&Deep rolled out from bf16 (v1) to int8w (v2,
    the same checkpoint) through shadow, canary and full, then committed;
    a fleet.rollout fire during a later canary rolls back. Zero failed
    requests; each version's replies inside its envelope of the f32
    predict, the shadow drift inside the two envelopes' sum. Returns K4a's
    launches over the rollout's traffic (bf16 batches and the f32 drift
    oracle's)."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)
    from euromillioner_tpu_torch.ops.wide_onehot import WIDE_ONEHOT_FWD
    from euromillioner_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                    inject)
    from euromillioner_tpu_torch.serve.engine import InferenceEngine
    from euromillioner_tpu_torch.serve.rollout import (RolloutEngine,
                                                       RolloutGates)
    from euromillioner_tpu_torch.serve.session import load_backend
    from euromillioner_tpu_torch.utils.errors import ServeError

    t0 = time.perf_counter()
    backend = load_backend("wide_deep", str(wd_ckdir), apply_overrides(
        Config(), ["serve.profiles=bf16,int8w"]))
    load_s = time.perf_counter() - t0
    env = {p: SERVE_ENVELOPES[("wide_deep", p)] for p in ("bf16", "int8w")}
    rows = bench_rows(8 * FLEET_WD_BATCHES, seed=34)
    reqs = [rows[i:i + 8] for i in range(0, len(rows), 8)]
    oracle = [backend.predict(r) for r in reqs]
    engines = {p: InferenceEngine(backend, buckets=(8,), precision=p)
               for p in ("bf16", "int8w")}
    # the parity gate at the two envelopes' sum (each version is held to
    # its own against f32 below); the latency and attainment gates off
    # (min_samples past the traffic): int8w's latency is not under test
    ro = RolloutEngine(engines["bf16"], "bf16", canary_pct=FLEET_CANARY_PCT,
                       gates=RolloutGates(max_rel_err=sum(env.values()),
                                          min_samples=10**6))
    replies: dict = {}
    try:
        ro.stage(engines["int8w"], "int8w")
        WIDE_ONEHOT_FWD.launches = 0
        # requests each version took in each stage (the per-version
        # counters /metrics renders; counted at submit)
        served = {}

        def taken():
            return {v: int(ro._req_counter.labels(v).get())
                    for v in ("bf16", "int8w")}

        for stage in ("shadow", "canary", "full"):
            before = taken()
            ro.set_stage(stage)
            replies[stage] = [ro.predict(r, max_wait_s=HTTP_WAIT)
                              for r in reqs]
            served[stage] = {v: n - before[v] for v, n in taken().items()}
        check(served["canary"]["bf16"] == served["canary"]["int8w"]
              == len(reqs) * FLEET_CANARY_PCT / 100,
              f"the canary did not split: {served['canary']}")
        wait_until("the shadow comparisons land", lambda: ro.stats()[
            "rollout"]["versions"]["int8w"]["parity"]["checks"] >= len(reqs))
        st = ro.stats()["rollout"]
        check(st["stage"] == "full" and st["rollbacks"] == 0,
              f"the rollout rolled back: {st['rollback_reason']}")
        ro.commit()
        k4a = WIDE_ONEHOT_FWD.launches
        parity = st["versions"]["int8w"]["parity"]
        errs = {s: max(rel_error(np.asarray(g), o) for g, o in
                       zip(replies[s], oracle)) for s in replies}
        card(f"fleet rollout wide_deep (100M, loaded in {load_s:.1f} s): "
             f"bf16 -> int8w through shadow, canary "
             f"({FLEET_CANARY_PCT:.0f}%), full, committed; requests per "
             f"version and stage {json.dumps(served)}; "
             f"shadow drift max {parity['drift_max']:.3e} (gate "
             f"{sum(env.values()):.0e}); worst rel to the f32 predict per "
             f"stage {json.dumps({s: f'{e:.3e}' for s, e in errs.items()})}"
             f"; K4a launches {k4a}")
        check(errs["shadow"] <= env["bf16"] and errs["full"] <= env["int8w"]
              and errs["canary"] <= max(env.values()),
              "rollout replies outside their envelopes")
        check(k4a >= len(reqs), "the bf16 version never launched K4a")
        # a fleet.rollout fire during a canary: rolled back, no failure
        ro.stage(engines["bf16"], "bf16-again", prestage=False)
        ro.set_stage("canary")
        plan = FaultPlan([FaultSpec("fleet.rollout", raises=ServeError,
                                    hits=(1,))])
        with inject(plan):
            got = [ro.predict(r, max_wait_s=HTTP_WAIT) for r in reqs[:4]]
        faults["fleet.rollout"] = plan.fired_count("fleet.rollout")
        st = ro.stats()["rollout"]
        print(f"fleet rollout: fleet.rollout fired {faults['fleet.rollout']}"
              f" during a canary: stage {st['stage']}, rollbacks "
              f"{st['rollbacks']} ({st['rollback_reason']}), "
              f"{len(got)} requests answered")
        check(st["stage"] == "stable" and st["rollbacks"] == 1
              and all(np.isfinite(np.asarray(g)).all() for g in got),
              "the faulted canary did not roll back cleanly")
    finally:
        for eng in engines.values():
            eng.close()
        del backend
        torch.cuda.empty_cache()
    return k4a


def phase_fleet(root: Path, flagship: Path, keep: Path) -> dict:
    """Phase 34: the fleet on the card (see FLEET_CONFIG): the in-process
    router through a host kill and an SLO ejection, the HTTP front end over
    two fused ``serve`` children through a SIGKILL (K1), the supervisor's
    warm respawn, restart and handoff from phase 33's ladder store, the
    Wide&Deep rollout (K4a), and the fleet.* fault points once each.
    Returns K1's launches on the HTTP path and K4a's on the rollout."""
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.serve.continuous import \
        load_recurrent_backend

    t0 = time.perf_counter()
    out = root / "build" / "chip_fleet"
    out.mkdir(parents=True, exist_ok=True)
    procs, logs, urls, front = fleet_http_children(root, flagship)
    faults: dict = {}
    try:
        backend = load_recurrent_backend(
            apply_overrides(Config(), FLEET_CONFIG), str(flagship),
            device="cuda")
        model = backend.model
        fleet_in_process(backend, model, faults)
        k1 = fleet_http(procs, logs, urls, front, model)
        fleet_supervisor(backend, model, keep / "ladder", faults)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    k4a = fleet_rollout(keep / "wide_deep", faults)
    print(f"fleet fault points fired: {json.dumps(faults, sort_keys=True)}")
    check(sorted(faults) == ["fleet.migrate", "fleet.probe",
                             "fleet.rollout", "fleet.route", "fleet.scale",
                             "fleet.spawn"] and all(
        n == 1 for n in faults.values()), "a fleet fault point did not "
        "fire exactly once")
    shutil.rmtree(out, ignore_errors=True)
    card(f"fleet: phase 34 took {time.perf_counter() - t0:.1f} s")
    return {"K1": k1, "K4a": k4a}


# -- phase 35: the deployment boundary -------------------------------------

# ``export`` → the C++ runner (core/export.py, core/native_runner.py): the
# trained flagship at full width in f32 (K1 twice a batch) and phase 33's
# seeded 100M Wide&Deep at its bf16 compute dtype (K4a once a batch), each
# exported at batch 16 and compiled by AOTInductor in a child started with
# phase 33's cold children (and the runner's g++ build in another), then
# served EXPORT_REQUESTS batches by the runner on the card.
EXPORT_BATCH = 16
EXPORT_REQUESTS = 24
# batches also run by the plain versions on the CPU
EXPORT_PLAIN = 4
EXPORTS = {"flagship": ("lstm", ["model.compute_dtype=float32"]),
           "wide_deep": ("wide_deep", [])}
# the export's f32 replies against eager on the card: the JAX package's NN
# pin, as phase 33 holds its packages. Against the plain versions on the
# CPU (other summation orders through 64 recurrent steps of trained
# weights: 2.602e-06 of the scale on an H100, past this pin's atol) the
# card-vs-CPU pin F32_SERVE_TOL holds, as phase 33's aot_plain
EXPORT_F32_RTOL = 1e-5
EXPORT_F32_ATOL = 1e-6


def export_children(root: Path, flagship: Path, out: Path,
                    spec: dict) -> list:
    """Phase 35's children, started beside phase 33's cold ones (one
    ``export_worker`` a model, one ``runner_worker``): their command
    lines."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cks = {"flagship": flagship, "wide_deep": spec["wide_deep"][1]}
    code = "import sys, chip_smoke as c; sys.exit(c.{}(*sys.argv[2:]))"
    argvs = [[sys.executable, "-c", code.format("export_worker"), "export",
              name, str(cks[name]), str(out / name)] for name in EXPORTS]
    argvs.append([sys.executable, "-c", code.format("runner_worker"),
                  "runner", str(out)])
    return argvs


def export_worker(name: str, ck: str, out: str) -> int:
    """``export`` of one EXPORTS model through the CLI, then its
    AOTInductor package compiled for the card (``core/export.
    native_package``); the seconds and the size to ``out/built.json``. Run
    in a child process."""
    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.core import export as ex
    from euromillioner_tpu_torch.core.device import resolve_device

    resolve_device("cuda")
    model, flags = EXPORTS[name]
    t0 = time.perf_counter()
    rc = cli.main(["export", "--model", model, "--checkpoint", ck,
                   "--output", out, "--batch", str(EXPORT_BATCH), *flags])
    if rc:
        return rc
    export_s = time.perf_counter() - t0
    path, compile_s = ex.native_package(out, "cuda")
    Path(out, "built.json").write_text(json.dumps({
        "export_s": export_s, "compile_s": compile_s,
        "package_mb": path.stat().st_size / 2**20}))
    return 0


def runner_worker(out: str) -> int:
    """The native runner built for this torch (``ensure_built``); its
    path and the seconds to ``out/runner.json``. Run in a child process."""
    from euromillioner_tpu_torch.core import native_runner as nr

    t0 = time.perf_counter()
    exe = nr.ensure_built()
    Path(out, "runner.json").write_text(json.dumps({
        "runner": str(exe), "build_s": time.perf_counter() - t0}))
    return 0


def export_requests(name: str) -> list:
    """EXPORT_REQUESTS batches of EXPORT_BATCH: the flagship's 64-step
    windows of 11 features, or bench.py's Wide&Deep rows."""
    import numpy as np

    if name == "wide_deep":
        rows = bench_rows(EXPORT_BATCH * EXPORT_REQUESTS)
        return [rows[i:i + EXPORT_BATCH]
                for i in range(0, len(rows), EXPORT_BATCH)]
    rng = np.random.default_rng(SEED)
    return [rng.normal(size=(EXPORT_BATCH, SEQ_LEN, FEATURES)
                       ).astype(np.float32) for _ in range(EXPORT_REQUESTS)]


def export_forward(name: str, ck: Path, device: str):
    """The model of ``ck`` as ``export`` wraps it, rebuilt on ``device``;
    on the CPU every LSTM layer runs K1's plain version (fused="on")."""
    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.core.export import ModelForward
    from euromillioner_tpu_torch.models.registry import restore_for_inference
    from euromillioner_tpu_torch.nn.recurrent import LSTM

    model, flags = EXPORTS[name]
    cfg = apply_overrides(Config(), [f"model.name={model}", *flags])
    net, dtype, _shape, _ck = restore_for_inference(cfg, str(ck),
                                                    device=device)
    if device == "cpu":
        for layer in net.modules():
            if isinstance(layer, LSTM):
                layer.fused = "on"
    return ModelForward(net.eval(), dtype)


def float_rows(text: str) -> list:
    """The lines of ``text`` that are whitespace-separated numbers (a
    prediction row each), as lists of floats; log lines are skipped."""
    rows = []
    for ln in text.splitlines():
        try:
            row = [float(v) for v in ln.split()]
        except ValueError:
            continue
        if row:
            rows.append(row)
    return rows


def timed_replies(call, reqs) -> tuple[list, float, float]:
    """Each request's reply (host arrays) through ``call``: the replies,
    the first one's milliseconds and the median of the rest (host clock;
    each reply ends on the host, so the card has finished)."""
    import numpy as np

    replies, ms = [], []
    for r in reqs:
        t0 = time.perf_counter()
        out = call(r)
        replies.append(np.asarray(out))
        ms.append((time.perf_counter() - t0) * 1e3)
    return replies, ms[0], statistics.median(ms[1:])


def phase_export(root: Path, out: Path, checkpoints: dict) -> dict:
    """Phase 35 on the card (see EXPORTS): the runner's build and ``ldd``;
    each package's compile seconds and size; EXPORT_REQUESTS batches
    through the C++ runner with K1 (2 a batch) and K4a (1 a batch) counted
    by the runner itself and no call of a CPU implementation; replies
    bit-equal to the same package loaded in this process, f32 within the NN
    pin of eager on the card and within F32_SERVE_TOL of the plain versions
    on the CPU, bf16 inside its envelope; a second runner compiling nothing; ``predict
    --model-type exported --runtime native`` on the golden CSV against
    ``--runtime torch``. Returns the runner's K1 and K4a launches."""
    import numpy as np

    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.core import export as ex
    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)

    t0 = time.perf_counter()
    print(f"export cuts: none (the flagship f32 at full width, the 100M "
          f"Wide&Deep at bf16, batch {EXPORT_BATCH}, {EXPORT_REQUESTS} "
          f"batches each)")
    built = json.loads((out / "runner.json").read_text())
    card(f"export: the native runner built in {built['build_s']:.1f} s "
         f"(g++ against torch's headers, no nvcc; beside phase 33's cold "
         f"children)")
    ldd = subprocess.run(["ldd", built["runner"]], capture_output=True,
                         text=True, timeout=60).stdout
    libs = sorted({ln.split()[0] for ln in ldd.splitlines() if ln.strip()})
    print(f"export: ldd {Path(built['runner']).name}: {' '.join(libs)}")
    check("libpython" not in ldd, "the native runner links libpython")
    check("libtorch_cuda" in ldd, "the native runner does not link "
          "libtorch_cuda")
    launches = {}
    for name, (model, _flags) in EXPORTS.items():
        d = out / name
        info = json.loads((d / "built.json").read_text())
        card(f"export {name}: torch.export {info['export_s']:.1f} s; the "
             f"AOTInductor package compiled on the card's host in "
             f"{info['compile_s']:.1f} s (beside phase 33's cold children), "
             f"{info['package_mb']:.1f} MB")
        reqs = export_requests(name)
        with ex.ExportedRunner(str(d), "native", "cuda") as run:
            check(run.compile_s is None, f"export {name}: the phase's "
                  "runner compiled its package again")
            native, first_ms, med_ms = timed_replies(
                lambda r: run(r)[0], reqs)
            stats = run.runner.stats()
            package = run.package
        with ex.ExportedRunner(str(d), "native", "cuda") as second:
            check(second.compile_s is None, f"export {name}: a second "
                  "runner compiled")
            again = second(reqs[0])[0]
        check(np.array_equal(again, native[0]), f"export {name}: a second "
              "runner replied otherwise")
        print(f"export {name}: the runner's own stats {json.dumps(stats)}")
        want = {"lstm_sequence": LAYERS * len(reqs) if model == "lstm"
                else 0, "wide_onehot_fwd": len(reqs)
                if model == "wide_deep" else 0}
        check(stats["launches"] == want, f"export {name}: the runner "
              f"launched {stats['launches']}, expected {want}")
        check(not any(stats["cpu_calls"].values()), f"export {name}: a CPU "
              f"implementation was called on the card {stats['cpu_calls']}")
        launches[name] = stats["launches"]
        # the same package in this process (torch._inductor's import, once
        # a process, timed apart)
        t1 = time.perf_counter()
        from torch._inductor import aoti_load_package

        import_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        pkg = aoti_load_package(str(package))
        load_ms = (time.perf_counter() - t1) * 1e3

        def in_process(r, fn=pkg):
            o = fn(torch.from_numpy(r).cuda())
            return (o[0] if isinstance(o, (list, tuple)) else o).cpu()

        inproc, in_first, in_med = timed_replies(in_process, reqs)
        same = all(np.array_equal(a, b) for a, b in zip(native, inproc))
        card(f"export {name}: runner replies bit-equal to the package in "
             f"this process: {same}")
        check(same, f"export {name}: the runner's replies differ from the "
              "same package run in Python")
        del pkg
        fwd = export_forward(name, checkpoints[name], "cuda")
        with torch.no_grad():
            eager, _e_first, e_med = timed_replies(
                lambda r: fwd(torch.from_numpy(r).cuda()).cpu(), reqs)
        del fwd
        cpu = export_forward(name, checkpoints[name], "cpu")
        with torch.no_grad():
            plain = [cpu(torch.from_numpy(r)).numpy()
                     for r in reqs[:EXPORT_PLAIN]]
        del cpu
        torch.cuda.empty_cache()
        got, got_plain = np.stack(native), np.stack(native[:EXPORT_PLAIN])
        e_gap, p_gap = (rel_error(got, np.stack(eager)),
                        rel_error(got_plain, np.stack(plain)))
        card(f"export {name}: runner vs eager on the card rel {e_gap:.3e}, "
             f"vs the plain versions on the CPU rel {p_gap:.3e}")
        if model == "wide_deep":
            env = SERVE_ENVELOPES[("wide_deep", "bf16")]
            check(e_gap <= env and p_gap <= env, f"export {name}: outside "
                  f"the bf16 envelope {env}")
        else:
            close = np.allclose(got_plain, np.stack(plain),
                                rtol=EXPORT_F32_RTOL, atol=EXPORT_F32_ATOL)
            worst = float(np.abs(got_plain - np.stack(plain)).max())
            print(f"export {name}: vs the plain versions max abs {worst:.3e}"
                  f", within rtol {EXPORT_F32_RTOL} / atol {EXPORT_F32_ATOL} "
                  f"{close} (held to F32_SERVE_TOL {F32_SERVE_TOL:.0e} of "
                  f"the scale, as phase 33 holds its packages)")
            check(np.allclose(got, np.stack(eager), rtol=EXPORT_F32_RTOL,
                              atol=EXPORT_F32_ATOL),
                  f"export {name}: runner vs eager outside rtol "
                  f"{EXPORT_F32_RTOL} / atol {EXPORT_F32_ATOL}")
            check(p_gap <= F32_SERVE_TOL, f"export {name}: runner vs the "
                  f"plain versions rel {p_gap:.3e} > {F32_SERVE_TOL:.0e}")
        check(bool(np.isfinite(got).all()), f"export {name}: non-finite "
              "replies")
        card(f"export {name}: the runner loads its package in "
             f"{stats['load_ms']:.1f} ms, first reply {first_ms:.2f} ms, "
             f"median {med_ms:.3f} ms a batch (host clock: the pipe and "
             f"both copies included); the package in this process loads in "
             f"{load_ms:.1f} ms (after {import_s:.1f} s importing "
             f"torch._inductor), first {in_first:.2f} ms, median "
             f"{in_med:.3f} ms; eager median {e_med:.3f} ms")
    # the CLI on the golden CSV, both runtimes
    csv = out / "draws.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(["fetch", "--html-file", str(root / GOLDEN_HTML),
                        "--output", str(csv)]) == 0, "fetch for predict")
    lines = {}
    for runtime in ("native", "torch"):
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["predict", "--model-type", "exported",
                           "--model-file", str(out / "wide_deep"), "--csv",
                           str(csv), "--runtime", runtime])
        secs = time.perf_counter() - t1
        check(rc == 0, f"predict --runtime {runtime} exited {rc}")
        rows = float_rows(buf.getvalue())
        lines[runtime] = np.array(rows, np.float32)
        card(f"export: predict --model-type exported --runtime {runtime} "
             f"(wide_deep) printed {len(rows)} lines in {secs:.1f} s")
    got = lines["native"]
    env = SERVE_ENVELOPES[("wide_deep", "bf16")]
    gap = rel_error(got, lines["torch"])
    print(f"export: predict native vs torch rel {gap:.3e} (envelope {env})")
    check(got.shape == (1705, OUTPUTS) and bool(np.isfinite(got).all()),
          f"predict --runtime native gave {got.shape}, not 1705 finite rows")
    check(gap <= env, "predict: native and torch runtimes disagree")
    shutil.rmtree(out, ignore_errors=True)
    card(f"export: phase 35 took {time.perf_counter() - t0:.1f} s")
    return {"K1": launches["flagship"]["lstm_sequence"],
            "K4a": launches["wide_deep"]["wide_onehot_fwd"]}


# -- phase 36: the rest of parallelism ---------------------------------------

# Tensor parallelism over ``model`` and sequence parallelism over ``seq``
# on PAR_RANKS rank processes sharing the one card over gloo (NCCL
# refuses two ranks on one device), then mesh-sharded serving in this
# process on meshes laid on the one card through ``devices=``. TP-2: the
# 100M Wide&Deep at B=8192, the wide table split by columns (K4a/K4b at
# its 520-wide shard). SP-2: the flagship at full width, T=64, B=64, two
# microbatches, on the pipelined chunk scan (K1/K2: 0).
PAR_RANKS = 2
PAR_WD_BATCH = 8192
# TP parity: PAR_TP_STEPS SGD steps with f32 towers against one process
# from the same params, at the JAX package's TP pin (tests/test_dist.py)
PAR_TP_STEPS = 3
PAR_TP_LR = 1e-3
TP_RTOL, TP_ATOL = 2e-5, 2e-6
# TP timing: PAR_TIMED_STEPS Adam steps with bf16 towers after one untimed
PAR_TIMED_STEPS = 3
# SP-2: the flagship's output and gradients against one process's scan at
# the JAX package's SP pins (tests/test_seq_parallel.py)
PAR_SP = {"batch": 64, "n_micro": 2}
SP_FWD_TOL = 1e-5
SP_GRAD_ATOL, SP_GRAD_RTOL = 2e-5, 2e-4
# how long the ranks may wait on each other, and each part in all
PAR_GROUP_TIMEOUT_S = 300.0
PAR_PART_TIMEOUT_S = 400.0
# sharded serving: the trained flagship's step scheduler on 2x1
# (PAR_SLOTS slots, block 8) over the first PAR_SEQUENCES of
# http_traffic(); the 100M Wide&Deep row engine on 1x2 and 1x4 at
# PAR_WD_ROWS-row batches, PAR_WD_BATCHES of them a mesh and profile,
# within the model-parallel envelope of the one-device engine
PAR_SLOTS = 32
PAR_SEQUENCES = 64
PAR_WD_ROWS = 64
PAR_WD_BATCHES = 4
PAR_MP_ENVELOPE = 1e-2


def par_wide_deep(dtype):
    """The seeded 100M Wide&Deep on the card, towers in ``dtype``."""
    from euromillioner_tpu_torch.models.wide_deep import build_wide_deep

    return build_wide_deep(compute_dtype=dtype, device="cuda",
                           generator=torch.Generator().manual_seed(SEED + 5))


def par_wd_batches(n: int):
    """``n`` host batches of bench.py's rows (B=PAR_WD_BATCH) with seeded
    targets."""
    import numpy as np

    from euromillioner_tpu_torch.data.dataset import Batch

    out = []
    for i in range(n):
        x = bench_rows(PAR_WD_BATCH, seed=i)
        y = np.random.default_rng(100 + i).normal(
            size=(PAR_WD_BATCH, OUTPUTS)).astype(np.float32)
        out.append(Batch(x=x, y=y, mask=np.ones(PAR_WD_BATCH, np.float32)))
    return out


def par_steps(trainer, state, batches, sync=True):
    """``state`` through one train step a batch; (state, ms a step)."""
    torch.cuda.synchronize()
    times = []
    for b in batches:
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, trainer._place(b))
        float(loss)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, times


def par_close(got: dict, ref: dict, rtol: float, atol: float) -> dict:
    """Per leaf the largest |got - ref| beyond ``atol + rtol·|ref|`` (0
    when every element is within) and the max abs difference."""
    out = {}
    for k, r in ref.items():
        g = got[k].double()
        r = r.double().to(g.device)
        diff = (g - r).abs()
        out[k] = (float((diff - (atol + rtol * r.abs())).clamp_min(0).max()),
                  float(diff.max()))
    return out


def par_tp(mesh, rank: int) -> dict:
    """TP-2 on this rank: rank 0 first runs the one-process reference (the
    others wait), then every rank trains the split model: PAR_TP_STEPS SGD
    steps in f32 (K4a/K4b counted; the joined params against the
    reference on rank 0), and Adam steps in bf16, timed."""
    import torch.distributed as dist

    from euromillioner_tpu_torch.core.precision import PARITY, Precision
    from euromillioner_tpu_torch.dist.sharded import DistributedTrainer
    from euromillioner_tpu_torch.ops.wide_onehot import (WIDE_ONEHOT_DW,
                                                         WIDE_ONEHOT_FWD)
    from euromillioner_tpu_torch.train.optim import adam, sgd
    from euromillioner_tpu_torch.train.trainer import Trainer

    batches = par_wd_batches(PAR_TP_STEPS + 1 + PAR_TIMED_STEPS)
    sgd_b, adam_b = batches[:PAR_TP_STEPS], batches[PAR_TP_STEPS:]
    bf16 = Precision(compute_dtype=torch.bfloat16)
    res: dict = {}
    ref = None
    if rank == 0:
        plain = Trainer(par_wide_deep(torch.float32), sgd(PAR_TP_LR),
                        precision=PARITY)
        state, _ = par_steps(plain, plain.init_state(), sgd_b)
        ref = {k: v.detach() for k, v in state.params.items()}
        del plain, state
        plain = Trainer(par_wide_deep(torch.bfloat16), adam(1e-3),
                        precision=bf16)
        state, times = par_steps(plain, plain.init_state(), adam_b)
        res["one_process_ms"] = times[1:]
        del plain, state
        torch.cuda.empty_cache()
    dist.barrier()
    tp = DistributedTrainer(par_wide_deep(torch.float32), sgd(PAR_TP_LR),
                            precision=PARITY, mesh=mesh)
    state = tp.init_state()
    res["shard"] = {k: tuple(v.shape) for k, v in state.params.items()}
    res["dims"] = dict(tp._dims)
    WIDE_ONEHOT_FWD.launches = WIDE_ONEHOT_DW.launches = 0
    state, times = par_steps(tp, state, sgd_b)
    res["sgd"] = {"K4a": WIDE_ONEHOT_FWD.launches,
                  "K4b": WIDE_ONEHOT_DW.launches, "ms": times}
    full = tp.global_state(state).params
    if ref is not None:
        res["errors"] = par_close(full, ref, TP_RTOL, TP_ATOL)
    del tp, state, full, ref
    torch.cuda.empty_cache()
    tp = DistributedTrainer(par_wide_deep(torch.bfloat16), adam(1e-3),
                            precision=bf16, mesh=mesh)
    WIDE_ONEHOT_FWD.launches = WIDE_ONEHOT_DW.launches = 0
    _, times = par_steps(tp, tp.init_state(), adam_b)
    res["adam"] = {"K4a": WIDE_ONEHOT_FWD.launches,
                   "K4b": WIDE_ONEHOT_DW.launches, "ms": times[1:]}
    return res


def par_flagship():
    from euromillioner_tpu_torch.models.lstm import build_lstm

    return build_lstm(HIDDEN, LAYERS, OUTPUTS, in_features=FEATURES,
                      fused="off", device="cuda",
                      generator=torch.Generator().manual_seed(SEED + 13))


def par_sp_batch():
    import numpy as np

    from euromillioner_tpu_torch.data.dataset import Batch

    rng = np.random.default_rng(SEED + 13)
    b = PAR_SP["batch"]
    return Batch(x=rng.normal(size=(b, SEQ_LEN, FEATURES)).astype(np.float32),
                 y=rng.normal(size=(b, OUTPUTS)).astype(np.float32),
                 mask=np.ones(b, np.float32))


def par_grads(trainer, state, batch):
    """(output, loss, gradients) of one step, the gradients as the update
    sees them (reduced over the ranks)."""
    placed = trainer._place(batch)
    params = {k: v.detach().requires_grad_()
              for k, v in state.params.items()}
    loss = trainer._loss(params, placed, None)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    grads, loss = trainer._reduce(grads, loss.detach())
    out = trainer._predict(state.params, placed.x)
    return out, float(loss), grads


def par_sp(mesh, rank: int) -> dict:
    """SP-2 on this rank: rank 0 first runs one process's scan (output,
    gradients, ms a step), then both ranks the pipelined one; K1/K2
    counted (0 expected)."""
    import torch.distributed as dist

    from euromillioner_tpu_torch.core.precision import PARITY
    from euromillioner_tpu_torch.dist.sharded import DistributedTrainer
    from euromillioner_tpu_torch.train.optim import sgd
    from euromillioner_tpu_torch.train.trainer import Trainer

    batch = par_sp_batch()
    res: dict = {}
    ref = None
    if rank == 0:
        plain = Trainer(par_flagship(), sgd(PAR_TP_LR), precision=PARITY)
        state = plain.init_state()
        ref = par_grads(plain, state, batch)
        _, times = par_steps(plain, state, [batch] * (PAR_TIMED_STEPS + 1))
        res["one_process_ms"] = times[1:]
        del plain, state
    dist.barrier()
    sp = DistributedTrainer(par_flagship(), sgd(PAR_TP_LR), precision=PARITY,
                            mesh=mesh, shard_sequence=True,
                            n_micro=PAR_SP["n_micro"])
    state = sp.init_state()
    reset_lstm_counts()
    out, loss, grads = par_grads(sp, state, batch)
    _, times = par_steps(sp, state, [batch] * (PAR_TIMED_STEPS + 1))
    res["counts"] = lstm_counts()
    res["ms"] = times[1:]
    if ref is not None:
        r_out, r_loss, r_grads = ref
        res["out"] = par_close({"out": out}, {"out": r_out}, SP_FWD_TOL,
                               SP_FWD_TOL)["out"]
        res["loss"] = (loss, r_loss)
        res["grads"] = par_close(grads, r_grads, SP_GRAD_RTOL, SP_GRAD_ATOL)
    return res


def par_worker(part: str, rank: int, world: int, address: str,
               out_dir: str) -> int:
    """One rank of phase 36's ``part`` (``tp``: mesh 1x2x1, ``sp``:
    1x1x2), both ranks on card 0 over gloo; saves its results to
    ``out_dir/{part}{rank}.pt``. Run by ``phase_parallel`` in a child
    process."""
    from datetime import timedelta

    import torch.distributed as dist

    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.core.mesh import MeshSpec, build_mesh
    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD
    from euromillioner_tpu_torch.ops.wide_onehot import (WIDE_ONEHOT_DW,
                                                         WIDE_ONEHOT_FWD)

    resolve_device("cuda")
    torch.cuda.set_device(0)
    for k in (FUSED_LSTM_FWD, WIDE_ONEHOT_FWD, WIDE_ONEHOT_DW):
        k.build()  # loads the libraries the parent built
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=PAR_GROUP_TIMEOUT_S))
    try:
        spec = (MeshSpec(data=1, model=world) if part == "tp"
                else MeshSpec(data=1, seq=world))
        mesh = build_mesh(spec, device="cuda")
        res = (par_tp if part == "tp" else par_sp)(mesh, rank)
        torch.save(res, Path(out_dir) / f"{part}{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def par_ranks(root: Path, part: str, out: Path) -> list:
    """PAR_RANKS ``par_worker`` children of ``part`` (killed in
    ``finally``); their results in rank order."""
    address = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = []
    try:
        for rank in range(PAR_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke as c; "
                 f"sys.exit(c.par_worker({part!r}, {rank}, {PAR_RANKS}, "
                 f"{address!r}, {str(out)!r}))"], cwd=root, env=env))
        deadline = time.monotonic() + PAR_PART_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    check(codes == [0] * PAR_RANKS, f"phase 36 {part}: the ranks exited "
          f"{codes}")
    return [torch.load(out / f"{part}{r}.pt", weights_only=False)
            for r in range(PAR_RANKS)]


def par_worst(errors: dict) -> tuple[str, float, float]:
    k = max(errors, key=lambda n: (errors[n][0], errors[n][1]))
    return k, errors[k][0], max(e[1] for e in errors.values())


def par_report_tp(ranks: list) -> dict:
    """TP-2's checks and lines; K4a/K4b launches summed over the ranks."""
    e = 1040
    for r, res in enumerate(ranks):
        width = res["shard"]["wide_table"][1]
        print(f"TP-2 rank {r}: wide_table shard {res['shard']['wide_table']}"
              f", split dims {json.dumps(res['dims'], sort_keys=True)}; SGD "
              f"f32 K4a {res['sgd']['K4a']} K4b {res['sgd']['K4b']}, Adam "
              f"bf16 K4a {res['adam']['K4a']} K4b {res['adam']['K4b']}")
        check(width == e // PAR_RANKS, f"TP-2 rank {r}: the table shard is "
              f"{width} wide")
        for part, n in (("sgd", PAR_TP_STEPS), ("adam", 1 + PAR_TIMED_STEPS)):
            check(res[part]["K4a"] == res[part]["K4b"] == n,
                  f"TP-2 rank {r} {part}: K4a/K4b launched "
                  f"{res[part]['K4a']}/{res[part]['K4b']} times, not {n}")
    k, beyond, worst_abs = par_worst(ranks[0]["errors"])
    print(f"TP-2 parity: {PAR_TP_STEPS} SGD steps (f32 towers, B="
          f"{PAR_WD_BATCH}) joined against one process: worst leaf {k}, "
          f"{beyond:.3e} beyond rtol {TP_RTOL:.0e} / atol {TP_ATOL:.0e}; "
          f"max abs {worst_abs:.3e}")
    check(beyond == 0.0, f"TP-2: {k} differs from one process by "
          f"{beyond:.3e} beyond the pin")
    one = statistics.median(ranks[0]["one_process_ms"])
    per = [statistics.median(r["adam"]["ms"]) for r in ranks]
    card(f"TP-2 timing: Adam, bf16 towers, B={PAR_WD_BATCH}: ranks "
         f"{', '.join(f'{m:.3f}' for m in per)} ms/step (two ranks on one "
         f"card over gloo) beside one process's {one:.3f} ms/step")
    return {"K4a": sum(r["sgd"]["K4a"] + r["adam"]["K4a"] for r in ranks),
            "K4b": sum(r["sgd"]["K4b"] + r["adam"]["K4b"] for r in ranks),
            "ms": per, "one_process_ms": one}


def par_report_sp(ranks: list) -> dict:
    res0 = ranks[0]
    beyond, out_abs = res0["out"]
    k, g_beyond, g_abs = par_worst(res0["grads"])
    print(f"SP-2: the flagship (H={HIDDEN}, T={SEQ_LEN}, f32, B="
          f"{PAR_SP['batch']}, {PAR_SP['n_micro']} microbatches) on the "
          f"pipelined scan against one process's scan: output {beyond:.3e} "
          f"beyond {SP_FWD_TOL:.0e} (max abs {out_abs:.3e}); loss "
          f"{res0['loss'][0]:.8f} vs {res0['loss'][1]:.8f}; gradients: "
          f"worst {k} {g_beyond:.3e} beyond atol {SP_GRAD_ATOL:.0e} / rtol "
          f"{SP_GRAD_RTOL:.0e} (max abs {g_abs:.3e}); launches per rank "
          f"{[r['counts'] for r in ranks]}")
    check(beyond == 0.0 and g_beyond == 0.0, "SP-2 differs from one "
          "process's scan beyond the pins")
    check(all(n == 0 for r in ranks for n in r["counts"].values()),
          "SP-2 launched K1 or K2")
    one = statistics.median(res0["one_process_ms"])
    per = [statistics.median(r["ms"]) for r in ranks]
    card(f"SP-2 timing: SGD f32 steps: ranks "
         f"{', '.join(f'{m:.3f}' for m in per)} ms/step beside one "
         f"process's scan {one:.3f} ms/step")
    return {"K1": 0, "K2": 0, "ms": per, "one_process_ms": one}


def par_serve_flagship(flagship: Path, devices: list) -> dict:
    """The trained flagship's step scheduler on a 2x1 mesh laid on the
    card: bit-equal to the block program at a shard's rows and to the
    unsharded scheduler whose program runs at those rows, within
    F32_SERVE_TOL of the direct apply; beside it the unsharded scheduler
    at PAR_SLOTS (on the card a product rounds otherwise at another row
    count: printed, not pinned); stats carry the mesh; K1/K2 0."""
    import numpy as np

    from euromillioner_tpu_torch.config import Config, apply_overrides
    from euromillioner_tpu_torch.core.precision import rel_error
    from euromillioner_tpu_torch.serve.continuous import (
        StepScheduler, load_recurrent_backend)
    from euromillioner_tpu_torch.serve.session import build_serving_mesh

    backend = load_recurrent_backend(
        apply_overrides(Config(), ["model.compute_dtype=float32"]),
        str(flagship), device="cuda")
    seqs = http_traffic()[:PAR_SEQUENCES]
    mesh = build_serving_mesh((2, 1), devices=devices)
    rows = PAR_SLOTS // 2

    def served(**kw):
        with StepScheduler(backend, step_block=8, **kw) as sched:
            t0 = time.perf_counter()
            got = [f.result(timeout=HTTP_WAIT)
                   for f in [sched.submit(s) for s in seqs]]
            return got, time.perf_counter() - t0, sched.stats()

    whole, whole_s, _ = served(max_slots=PAR_SLOTS)
    same_rows, same_s, _ = served(max_slots=rows)
    reset_lstm_counts()
    got, wall, st = served(max_slots=PAR_SLOTS, mesh=mesh)
    counts = lstm_counts()
    oracle = []
    with torch.inference_mode():
        for i in range(0, len(seqs), rows):
            group = seqs[i:i + rows]
            t = max(len(s) for s in group)
            x = np.zeros((rows, t, FEATURES), np.float32)
            for j, s in enumerate(group):
                x[j, :len(s)] = s
            _, y = backend.block_fn(
                backend.init_states(rows), torch.from_numpy(x).cuda(),
                torch.ones((rows, 1), dtype=torch.bool, device="cuda"))
            y = y.cpu().numpy()
            oracle += [y[j, len(s) - 1] for j, s in enumerate(group)]
    same_block = all(np.array_equal(g, w) for g, w in zip(got, oracle))
    same_sched = all(np.array_equal(g, w) for g, w in zip(got, same_rows))
    same_whole = sum(np.array_equal(g, w) for g, w in zip(got, whole))
    err = rel_error(np.stack(got), direct_apply(backend.model, seqs).numpy())
    card(f"sharded step scheduler 2x1 (devices {[str(d) for d in devices]}),"
         f" {PAR_SLOTS} slots, {len(seqs)} sequences: {wall:.3f} s (the "
         f"unsharded {PAR_SLOTS}-slot pool {whole_s:.3f} s, {rows}-slot "
         f"{same_s:.3f} s); bit-equal to the block program at {rows} rows "
         f"{same_block} and to the unsharded {rows}-slot scheduler "
         f"{same_sched}; {same_whole}/{len(seqs)} replies bit-equal to the "
         f"unsharded {PAR_SLOTS}-slot scheduler (rel "
         f"{rel_error(np.stack(got), np.stack(whole)):.3e}); rel to the "
         f"direct apply {err:.3e} (tol {F32_SERVE_TOL:.0e}); stats mesh "
         f"{st['mesh']}, failed {st['failed']}; launches {counts}")
    check(same_block and same_sched, "the sharded step scheduler's replies "
          "differ from the program at a shard's rows")
    check(err <= F32_SERVE_TOL and st["mesh"] == "2x1"
          and st["failed"] == 0, "the sharded step scheduler disagrees")
    check(all(n == 0 for n in counts.values()), "the sharded step "
          "scheduler launched K1 or K2")
    return counts


def par_serve_wd(devices: list) -> dict:
    """The 100M Wide&Deep (f32 towers) on 1x2 and 1x4 meshes laid on the
    card at the f32 and bf16 profiles, against the one-device engine
    within PAR_MP_ENVELOPE; K4a counted per model shard, each at the
    shard's width; one ``serve.shard`` fault fails one batch and the
    session serves on."""
    import numpy as np

    from euromillioner_tpu_torch.core.precision import rel_error
    from euromillioner_tpu_torch.ops.wide_onehot import WIDE_ONEHOT_FWD
    from euromillioner_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                    inject)
    from euromillioner_tpu_torch.serve.engine import InferenceEngine
    from euromillioner_tpu_torch.serve.session import (ModelSession,
                                                       NNBackend,
                                                       build_serving_mesh)

    model = par_wide_deep(torch.float32)
    rows = [bench_rows(PAR_WD_ROWS, seed=50 + i)
            for i in range(PAR_WD_BATCHES)]
    k4a = 0
    for prof in ("f32", "bf16"):
        base = NNBackend(model, (11,), compute_dtype=torch.float32,
                         precision=prof)
        with InferenceEngine(base, buckets=(PAR_WD_ROWS,), warmup=False,
                             max_wait_ms=1.0) as eng:
            want = [eng.predict(r) for r in rows]
        for axes in ((1, 2), (1, 4)):
            mesh = build_serving_mesh(axes, devices=devices)
            backend = NNBackend(model, (11,), compute_dtype=torch.float32,
                                precision=prof, mesh=mesh)
            placed, dims = backend.placed_params(prof)
            widths = [placed[0][j]["wide_table"].shape[1]
                      for j in range(axes[1])]
            WIDE_ONEHOT_FWD.launches = 0
            t0 = time.perf_counter()
            with InferenceEngine(ModelSession(backend, mesh=mesh),
                                 buckets=(PAR_WD_ROWS,), warmup=False,
                                 max_wait_ms=1.0) as eng:
                got = [eng.predict(r) for r in rows]
                st = eng.stats()
            wall = (time.perf_counter() - t0) * 1e3 / len(rows)
            n = WIDE_ONEHOT_FWD.launches
            k4a += n
            elem = max(float(np.max(np.abs(g - w) / np.maximum(np.abs(w),
                                                               1e-6)))
                       for g, w in zip(got, want))
            scale = rel_error(np.concatenate(got), np.concatenate(want))
            # f32: the JAX pin's elementwise max rel; bf16 rounds outputs
            # near zero to a few ulps of their own size, so there the
            # serving envelope's measure, max|diff| / max|ref|, holds
            err = elem if prof == "f32" else scale
            card(f"Wide&Deep {prof} on {axes[0]}x{axes[1]}: table shards "
                 f"{widths} wide (split dims wide_table "
                 f"{dims['wide_table']}, head "
                 f"{dims['deep.3_Dense.kernel']}); K4a {n} launches for "
                 f"{len(rows)} batches; against the one-device engine: "
                 f"elementwise max rel {elem:.3e}, max|diff|/max|ref| "
                 f"{scale:.3e} (the {'first' if prof == 'f32' else 'second'}"
                 f" held to {PAR_MP_ENVELOPE:.0e}); {wall:.3f} ms a batch; "
                 f"stats mesh {st['mesh']}")
            check(widths == [1040 // axes[1]] * axes[1], "a table shard "
                  "has another width")
            # a bf16 engine checks its first batch against the f32 program
            want_n = (len(rows) + (prof != "f32")) * axes[1]
            check(n == want_n, f"K4a launched {n} times on {axes} "
                  f"{prof}, not {want_n}")
            check(err <= PAR_MP_ENVELOPE, f"Wide&Deep {prof} on {axes} "
                  f"leaves the envelope: {err:.3e}")
        del base, backend, placed
        torch.cuda.empty_cache()
    mesh = build_serving_mesh((1, 2), devices=devices)
    backend = NNBackend(model, (11,), compute_dtype=torch.float32, mesh=mesh)
    WIDE_ONEHOT_FWD.launches = 0
    plan = FaultPlan([FaultSpec(point="serve.shard", raises=RuntimeError,
                                hits=(2,))])
    with inject(plan):
        with InferenceEngine(ModelSession(backend, mesh=mesh),
                             buckets=(PAR_WD_ROWS,), warmup=False,
                             max_wait_ms=1.0) as eng:
            ok1 = eng.predict(rows[0])
            failed = False
            try:
                eng.predict(rows[0])
            except RuntimeError as e:
                failed = "injected fault" in str(e)
            ok3 = eng.predict(rows[0])
            st = eng.stats()
    print(f"serve.shard fault on 1x2: fired "
          f"{plan.fired_count('serve.shard')}, the batch failed {failed}, "
          f"errors {st['errors']}, the session served on bit-equal "
          f"{np.array_equal(ok1, ok3)}")
    check(failed and plan.fired_count("serve.shard") == 1
          and st["errors"] == 1 and np.array_equal(ok1, ok3),
          "the serve.shard fault was not survived")
    return {"K4a": k4a + WIDE_ONEHOT_FWD.launches}


def par_cli_refuses(root: Path) -> None:
    """``serve ... serve.mesh=2,1`` on the one card: the JAX ConfigError
    (exit 17) before any restore."""
    from euromillioner_tpu_torch import cli

    rc = cli.main(["serve", "--model-type", "mlp", "--checkpoint",
                   str(root / "build" / "chip_smoke" / "absent"),
                   "serve.mesh=2,1"])
    print(f"serve serve.mesh=2,1 on {torch.cuda.device_count()} card(s): "
          f"exit {rc}")
    check(rc == 17, f"serve with a mesh the card cannot hold exited {rc}")


def phase_parallel(root: Path, flagship: Path) -> dict:
    """Phase 36: TP-2 training of the 100M Wide&Deep and SP-2 training of
    the full-width flagship on rank processes sharing the card over gloo,
    then sharded serving in this process (the flagship's step scheduler on
    2x1, Wide&Deep's row engine on 1x2 and 1x4, a serve.shard fault) and
    the CLI's refusal of a mesh the card cannot hold. Returns the kernels'
    launches by path."""
    t0 = time.perf_counter()
    out = root / "build" / "chip_smoke" / "parallel"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    tp = par_report_tp(par_ranks(root, "tp", out))
    sp = par_report_sp(par_ranks(root, "sp", out))
    devices = [torch.device("cuda", 0)] * 4
    serve_counts = par_serve_flagship(flagship, devices)
    wd = par_serve_wd(devices)
    par_cli_refuses(root)
    shutil.rmtree(out, ignore_errors=True)
    card(f"parallel: phase 36 took {time.perf_counter() - t0:.1f} s")
    return {"tp": tp, "sp": sp, "serve_step": serve_counts,
            "serve_mesh_k4a": wd["K4a"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "euromillioner_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(euromillioner_tpu_torch/ not found)", file=sys.stderr)
        return 1
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.ops.fused_histogram import (
        FUSED_HISTOGRAM, FUSED_HISTOGRAM_SETS)
    from euromillioner_tpu_torch.ops.fused_lstm import (FUSED_LSTM_BWD,
                                                        FUSED_LSTM_BWD_BF16,
                                                        FUSED_LSTM_FWD,
                                                        FUSED_LSTM_FWD_BF16)
    from euromillioner_tpu_torch.ops.wide_onehot import (WIDE_ONEHOT_DW,
                                                         WIDE_ONEHOT_FWD)

    global CARD
    resolve_device("cuda")  # TF32 off for the plain versions' GEMMs
    name = torch.cuda.get_device_name(0)
    smi = CARD = nvidia_smi("name,power.limit")
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); {nvidia_smi('clocks.sm,clocks.max.sm')}")
    kernels = (FUSED_LSTM_FWD, FUSED_LSTM_BWD, FUSED_HISTOGRAM,
               WIDE_ONEHOT_FWD)  # WIDE_ONEHOT_DW shares K4a's library
    try:
        with ThreadPoolExecutor(len(kernels)) as pool:
            seconds = list(pool.map(lambda k: k.build(), kernels))
        for kernel, secs in zip(kernels, seconds):
            print(f"build: {kernel.source} in {secs:.2f} s (parallel)")
            # nvcc -Xptxas -v: each kernel's name, then its registers,
            # static shared memory and spills
            for ln in kernel.build_log.splitlines():
                if any(w in ln for w in ("entry function", "registers",
                                         "spill")):
                    print(f"build: {kernel.source}: {ln.strip()}")
        # the bf16 entry points and K3's set form load the libraries the
        # builds above made
        FUSED_LSTM_FWD_BF16.build()
        FUSED_LSTM_BWD_BF16.build()
        FUSED_HISTOGRAM_SETS.build()
        phase_sass()
        k1 = phase_k1()
        k2 = phase_k2()
        k1b, k2b = phase_bf16_kernels()
        phase_lstm_odd_widths()
        k3 = phase_k3()
        serve_k1 = phase_serve(root)
        http_k1 = phase_serve_http(root)
        train_k1, train_k2, ckdir = phase_train(root)
        phase_step(root)
        trained_k1 = phase_serve_trained(ckdir)
        phase_governance(root, ckdir)
        replay_k1 = phase_replay(ckdir)
        phase_obs_http(root, ckdir)
        chaos = phase_chaos_train(root)
        phase_quant_fallback(root, ckdir)
        phase_profile_dir(root)
        bf16_train, bf16_ckdir = phase_train_bf16(root)
        bf16_serve_k1 = phase_serve_bf16_trained(bf16_ckdir)
        bench = phase_lstm_bench(k1b, k2b)
        phase_step_bf16(root)
        tbptt = phase_tbptt(root)
        # phase 33 serves the trained flagship from the AOT store last
        flagship = root / "build" / "chip_aot_flagship"
        shutil.rmtree(flagship, ignore_errors=True)
        shutil.copytree(ckdir, flagship)
        shutil.rmtree(ckdir.parent, ignore_errors=True)
        # the boosters' per-round eval lines: 3,000 lines of stdout
        logging.getLogger("euromillioner_tpu_torch.trees.gbt").setLevel(
            logging.WARNING)
        reference_k3, reference_run = phase_reference(root)
        fetch_k3 = phase_native_reference(root, reference_run)
        del reference_run
        phase_golden_trajectories(root)
        scaled_k3 = phase_scaled(k3["ms_by_shape"])
        cli_k3, gbt_out = phase_cli_train_predict(root)
        rf_cls, rf_reg = phase_k3_sets()
        rf_cls_k3 = phase_rf_classifier()
        rf_reg_k3 = phase_rf_regressor()
        rf_cls_k3["cli_train"] = phase_rf_cli(root, gbt_out)
        shutil.rmtree(gbt_out, ignore_errors=True)
        phase_chunked_trees(root)
        WIDE_ONEHOT_DW.build()  # loads the library K4a's build made
        k4a, k4b = phase_k4()
        k4_shards = phase_k4_shards()
        serve_k4a, wd_ckdir = phase_wd_serve(root)
        train_k4a, train_k4b = phase_wd_train(root)
        wd_bench = phase_wd_bench((k4a, k4b))
        phase_wd_step(root)
        mlp_ckdir = phase_mlp_train(root)
        phase_mlp_serve(mlp_ckdir)
        shutil.rmtree(mlp_ckdir, ignore_errors=True)
        tiers_k4a = phase_wd_tiers(wd_ckdir)
        phase_classic(root)
        dp1 = phase_train_dp(root)
        dp1_families = phase_train_dp_families(root)
        ranks = phase_ranks_on_one_card(root)
        phase_param_avg(root)
        # phase 34 runs on phase 33's warm ladder store and Wide&Deep
        fleet_keep = root / "build" / "chip_fleet" / "aot"
        # phase 35's exports and the runner's build run beside phase 33's
        # cold children
        export_out = root / "build" / "chip_export"
        aot = phase_aot(root, flagship, keep=fleet_keep,
                        beside=lambda spec: export_children(
                            root, flagship, export_out, spec))
        # phase 35 before 34, which removes the Wide&Deep checkpoint
        export = phase_export(root, export_out, {
            "flagship": flagship, "wide_deep": fleet_keep / "wide_deep"})
        fleet = phase_fleet(root, flagship, fleet_keep)
        par = phase_parallel(root, flagship)
        shutil.rmtree(flagship, ignore_errors=True)
        shutil.rmtree(fleet_keep.parent, ignore_errors=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    k1["launches_by_path"] = {
        "serve": serve_k1, "train": train_k1, "serve_trained": trained_k1,
        "serve_bf16_ckpt_fused": bf16_serve_k1["fused"],
        "serve_bf16_ckpt_int8w": bf16_serve_k1["int8w"],
        "serve_http_fused": http_k1, "replay_fused": replay_k1,
        "train_dp_gloo": ranks["lstm"]["K1.f32"],
        "train_tbptt": tbptt["K1.f32"], "aot_padded_fused": aot["K1"],
        "fleet_http_fused": fleet["K1"], "export_native": export["K1"],
        "train_sp": par["sp"]["K1"],
        "serve_mesh_step": par["serve_step"]["K1.f32"]}
    k1["launches"] = sum(k1["launches_by_path"].values())
    k2["launches_by_path"] = {"train": train_k2,
                              "train_dp_gloo": ranks["lstm"]["K2.f32"],
                              "train_tbptt": tbptt["K2.f32"],
                              "train_sp": par["sp"]["K2"]}
    k2["launches"] = sum(k2["launches_by_path"].values())
    k1b["launches_by_path"] = {"train": bf16_train["K1.bf16"],
                               "bench_step": bench["K1.bf16"],
                               "train_dp": dp1["K1.bf16"],
                               "train_chaos": chaos["K1.bf16"],
                               "train_dp_gloo": ranks["lstm"]["K1.bf16"],
                               "train_tbptt": tbptt["K1.bf16"]}
    k1b["launches"] = sum(k1b["launches_by_path"].values())
    k2b["launches_by_path"] = {"train": bf16_train["K2.bf16"],
                               "bench_step": bench["K2.bf16"],
                               "train_dp": dp1["K2.bf16"],
                               "train_chaos": chaos["K2.bf16"],
                               "train_dp_gloo": ranks["lstm"]["K2.bf16"],
                               "train_tbptt": tbptt["K2.bf16"]}
    k2b["launches"] = sum(k2b["launches_by_path"].values())
    k3["launches_by_path"] = {"reference": reference_k3,
                              "reference_fetch": fetch_k3,
                              "scaled_gbt": scaled_k3, "cli_train": cli_k3}
    k3["launches"] = sum(k3["launches_by_path"].values())
    k4a["launches_by_path"] = {"serve": serve_k4a, "train": train_k4a,
                               "bench_step": wd_bench["launches"]["K4a"],
                               "serve_bf16": tiers_k4a["bf16"],
                               "serve_int8w_drift_oracle":
                                   tiers_k4a["int8w"],
                               "train_dp": dp1_families["K4a"],
                               "aot_serve_bf16": aot["K4a"],
                               "rollout_bf16": fleet["K4a"],
                               "export_native_bf16": export["K4a"],
                               "tp_train": par["tp"]["K4a"],
                               "serve_mesh": par["serve_mesh_k4a"]}
    k4a["launches"] = sum(k4a["launches_by_path"].values())
    k4b["launches_by_path"] = {"train": train_k4b,
                               "bench_step": wd_bench["launches"]["K4b"],
                               "train_dp": dp1_families["K4b"],
                               "tp_train": par["tp"]["K4b"]}
    k4b["launches"] = sum(k4b["launches_by_path"].values())
    rf_cls["launches_by_path"] = dict(rf_cls_k3,
                                      cli_train_dp=dp1_families["K3.sets"],
                                      rf_mesh=ranks["rf"]["classifier"])
    rf_cls["launches"] = sum(rf_cls["launches_by_path"].values())
    rf_reg["launches_by_path"] = dict(rf_reg_k3,
                                      rf_mesh=ranks["rf"]["regressor"])
    rf_reg["launches"] = sum(rf_reg["launches_by_path"].values())
    k4a["shard_widths"] = k4_shards["fwd"]
    k4b["shard_widths"] = k4_shards["dw"]
    print(json.dumps({"kernels": [k1, k2, k1b, k2b, k3, k4a, k4b, rf_cls,
                                  rf_reg]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
