#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``modl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``modl_tpu_torch/csrc/*.cu`` from this checkout (one
   ``nvcc`` per source, all started together);
3. kernel: the Hopper BCD kernel against its plain PyTorch version on the
   card at the main path's shapes, the elastic-net ball, rows that do
   not shrink and a row too wide to stage in shared memory, with both
   times (CUDA events), the bound, the grid-wide exchanges a call made
   and a second launch held bitwise equal to the first; then the grid
   barrier alone (cooperative groups' and the kernel's own), in us;
   then fista: the FISTA kernel against its plain version at the image
   fit's solve (200 x 128, a shared Gram held in registers), its NMF,
   per-row Grams (``G_agg='average'``), ADHD-70's width with an
   elastic-net code (100 x 70), k=1,024 (Q read through L2), the image
   score's and transform's row counts, and shapes that launch every
   other instantiation of the kernel (``FISTA_CASES``): codes at 200
   iterations within 3e-5 of max |w|, the iterations at the solver's tol
   equal or one check apart and the batch objective within 1e-5, a
   second launch and half the batch bitwise equal, the check-a-launch
   driver bitwise equal to the one-launch solve, which also runs with
   host reads forbidden; the path each case takes (registers, smem or
   l2), its instantiation and its rows a thread, times, bounds and
   iterations; before the cases, each FISTA kernel instantiation's
   registers, stack frame and spill bytes from the build's ptxas report
   (the phase fails unless the cases launch every instantiation built,
   and the run fails, after phase 12, if the main path launched one that
   no case held against the plain version);
4. adhd70: ``DictFact(...).fit(X)`` at the ADHD-70 configuration of
   ``bench.py`` (k=70, 2,000 x 200,000 planted data, one epoch of 20
   steps): BCD and EMA-GEMM launches counted on the main path (one
   EMA-GEMM launch per deferred-B segment end) and on a gate-off control
   (none), a held-out objective below the initial dictionary's, agreement
   with the gate-off fit and with a refit through the plain BCD path, and
   samples/s;
   then step_graph: the step program (``decomposition/_program.py``)
   against the eager step at ADHD-70 width as ``partial_fit`` takes it
   (gather subsets) with ridge codes, l1 codes, the 'average'
   aggregators (FISTA, and ridge codes through batched Cholesky and
   triangular solves, on per-row Grams) and the 'full' ones, and at the
   image fit's step (k=128, 16 x 16 patches, reduction 8, Binomial
   sizes, FISTA, batch 200): 20 steps from one carried state and one
   set of draws, every leaf bitwise equal, the replays under
   ``torch.cuda.set_sync_debug_mode('error')``, BCD and FISTA launches
   equal; the host us to issue a step each way (draws and scalars,
   staging, replay) with the card idle, the card's ms a step over 20
   back to back, the capture's seconds and the graph pool's MB; then
   ``partial_fit`` with a callback (one capture, every step a replay);
   then scan_graph: the scan program (the fused epoch as one captured
   graph) against the eager ``somf_scan`` at ADHD-70 with windowed
   subsets and ridge codes (``bench.py``'s configuration), with l1 codes
   (FISTA), and with gather subsets: 3 epochs from one carried state and
   one set of draws, every leaf bitwise equal after each, the replays
   under ``set_sync_debug_mode('error')``, BCD, EMA-GEMM and FISTA
   launches equal to an epoch's; the epochs' relative difference against
   the same draws with host window starts (the slicing body); the wall
   seconds of an epoch each way (medians of 5), the card's ms an epoch,
   the host us to draw, stage and replay and to issue an eager epoch
   (the card idle), the capture's seconds, the pool's MB, the idle share
   of one profiled epoch each way, the rows' copy and a step's window
   gather in ms; then ``DictFact(**ADHD, n_epochs=3).fit``: one capture,
   every epoch a replay, the launches of 3 epochs, a held-out objective
   below the initial dictionary's;
   then adhd70_l1: the same fit with DictFact's default l1 codes (FISTA
   on the card): one FISTA and one BCD launch a step, every solve with
   host reads forbidden, and a refit with both kernels' plain versions
   within 1e-2;
   then dtype_policy: the same fit on the data cast to float64 with
   ``dtype=None`` runs float32 state, one BCD launch a step and the
   EMA-GEMM launches of phase 4; ``dtype=np.float64`` raises; a ``Coder``
   of a float64 dictionary runs float32; ``fMRIDictFact`` on two
   in-memory float64 records of 200 frames runs float32 state through
   the kernel; and the fit under the former policy (float64 state, plain
   BCD) for comparison;
   then checkpoint: a fitted estimator pickled and reloaded on the card
   (float32, equal components), one more ``partial_fit`` of it and of the
   original (kernel launched, bitwise equal), and ``save_state`` /
   ``load_state`` in the middle of a fit with the 'average' aggregators
   (``G_avg`` loaded into pinned host RAM, moved to the card by the next
   ``partial_fit``), resumed bitwise equal to the uninterrupted fit;
5. hcp1024: one epoch (6 steps) of the HCP-1024 configuration through
   the kernel block driver, with the same launch counts, gate on and off,
   and samples/s; then step_graph at HCP-1024 (gather subsets, the
   block driver's 4 calls a step) and scan_graph at HCP-1024 (windowed,
   the block driver, one EMA-GEMM segment end of 1,200 rows);
   then offload: the HCP-1024 configuration with ``Dx_agg=G_agg=
   'average'``, one epoch with ``average_offload=True`` (G_avg, 5.03 GB,
   in pinned host RAM; 6 segments of one batch; BCD launches as
   counted, no EMA-GEMM launch) against the resident fit stepped batch
   by batch, as the segments step (components within 1e-5 of their
   scale, and whether they are bitwise equal), and the resident fused
   epoch, which defers B's EMA (its difference printed); a held-out
   objective below the initial dictionary's, the fits' times
   (``StepTimer``), the host-device copy rates of a segment and the
   device's idle share of one more offloaded epoch (``torch.profiler``);
   then mesh: the dp x feat mesh of ``modl_tpu_torch.parallel`` in
   worlds started by ``parallel.launch.spawn``: ADHD-70 over NCCL on
   every visible card (up to four) as (world, 1) (on four cards every
   leg below instead), then four gloo ranks on card 0 with ADHD-70 on
   (4, 1) and (2, 2), HCP-1024 on (2, 2), ADHD-70 with
   ``G_agg='average'`` on (4, 1) (``G_avg`` split over dp) and the
   recsys fit of phase 10 (one epoch) on (4, 1); each leg after a
   warm-up fit, with the kernels' launches per rank (equal to the
   single-process fit's), the collectives and MB per step
   (``parallel.mesh.COLLECTIVES``), the epoch time, and the components
   within 1e-4 of max |D| of the single-process fit (recsys: and the
   test RMSE within 1e-3); then two gloo ranks on card 0 with the
   adhd70_l1 fit on (2, 1): each rank solves half of a batch's codes by
   FISTA, a check a launch, with the stop agreed over the ranks;
6. ema_kernel: the EMA-GEMM kernel (3xTF32 on the tensor cores) against
   its plain version at the segment-end shapes of the fMRI legs and of the
   resident ADHD-70 fit and at two ragged ones (one of odd width), for pi
   in {0, 0.9, 1} (a float on the card, which the kernel reads there),
   with both times, GB/s and TFLOP/s;
7. launch_overhead: the launch-overhead probe against its plain version,
   then its benchmark (ms per step and per launch at 4, 2, 1 launches);
8. fmri_adhd70: ``fMRIDictFact.fit`` on ``bench.py``'s streaming fMRI
   leg (2 records of 200 x 200,000 planted frames written by
   ``create_raw_rest_data(feature_order=0)``, float32 and float16, cleaned
   on the device, 3 epochs) with the EMA-GEMM kernel on the segment end:
   launch counts, record-cache hits, held-out objective below the initial
   dictionary's and within 1e-2 of a refit with the kernel off, the
   gate's A/B (``partial_fit`` ms of fits in turns with the kernel on,
   off, off, on, and the medians), epoch samples/s, io/cpu time, the
   host-to-device rate, and the scan program the records ran through
   (one capture, every record an epoch of it) with its row copy's ms;
9. fmri_hcp1024: ``exps/hcp/decompose_hcp.py``'s configuration (k=1024,
   reduction 20, batch 200) on 2 Gaussian records of 1,200 x 200,000,
   2 epochs: the same checks through the BCD block driver (the gate's
   A/B on the two fits alone);
   then nifti: ``fMRIDictFact`` (k=70, reduction 12, batch 100, no
   cleaning, 2 epochs) on records and mask given as NIfTI images on the
   MNI152 3 mm grid (61 x 73 x 61, a fixed mask of 200,000 voxels; 2
   records of phase 8's 200 planted frames), through in-process
   stand-ins for ``nibabel.Nifti1Image``, ``nilearn._utils.check_niimg``
   and ``nilearn.input_data.MultiNiftiMasker`` (neither package is on
   the card's machine): held against the ``.npy`` route of the same
   frames (components within 1e-5 of max |D|, bitwise expected; the same
   launches: a NIfTI masker knows no voxel order, so both draw gather
   subsets and end no deferred-B segment), ``_count_voxels``,
   ``components_img_`` and ``safe_to_filename``, a held-out objective
   below the initial dictionary's; then the same records as int16 run
   float32 state through the kernel; samples/s, ``io_time_`` and
   ``cpu_time_`` of both routes;
10. recsys_ml10m: ``RecsysDictFact.fit`` on ``bench.py``'s MovieLens-10M
   scale planted ratings (69,878 x 10,677, ~7.45M training entries, k=50,
   batch ceil(1 / sparsity) = 101, 2 epochs): one BCD launch a batch on
   the masked union-of-supports update, ``use_kernel_``, the resident
   width, epoch ratings/s, test RMSE after each epoch below the bias-only
   RMSE, and a one-epoch fit with the kernel forced off within 1e-2 (run
   eagerly: the plain BCD reads the order back);
   then recsys_graph: the fit's batches as programs (a window of 32
   batches one captured graph, every other batch a one-batch graph of
   its size) against the same batches run eagerly, from one set-up and
   the same seed: every leaf bitwise equal after each of 5 epochs, one
   BCD launch a batch each way, 3 captures (32 x 101, 1 x 101 and the
   tail's 1 x 87), every replay under ``set_sync_debug_mode('error')``;
   the epoch's wall seconds each way (medians), the card's ms a window,
   the host us to draw, stage and replay a window, the idle share of a
   profiled epoch each way, capture seconds and pool MB, a batch's
   Cholesky and triangular solves against ``torch.cholesky_solve``;
   then a 2-epoch ``fit`` through the programs, bitwise equal to the
   eager epochs' state and its refit codes, each window one replay;
11. image: ``ImageDictFact.fit`` at ``exps/exp_decompose_images.py``'s
   configuration (k=128, 16 x 16 patches, reduction 8, batch 200) on a
   768 x 1,024 grey synthetic image (the face's size; ~760k patches,
   gathered buffer by buffer), one epoch: every full batch through the
   step program (``path=graph``, one capture), one BCD and one FISTA
   launch a step, every step with host syncs forbidden (staging,
   capture, replays and the eager short batch), held-out score below the
   initial dictionary's, agreement with a refit through both kernels'
   plain versions on a 20,000-patch subset, patches/s and the steps'
   seconds; the card's idle share and the FISTA and BCD kernels' device
   time over 70 steady steps of the subset fit (``torch.profiler``
   through ``utils/profiling.py``, whose per-op host cost it counts in
   the window's wall clock); then a short NMF fit (20,000 patches) with
   non-negative components and codes;
12. drivers: the port's drivers on the card with ``MODL_OUTPUT`` under
   ``build/``: the HCP pipeline (``exps.hcp.unmask_hcp`` on 2 Gaussian
   volumes of 61 x 73 x 61 x 400 and the 200,000-voxel mask, then
   ``exps.hcp.decompose_hcp`` at its defaults, k=1,024: BCD launches =
   steps x blocks of the block driver, one EMA-GEMM launch a segment
   end, ``hcp_components.npy`` of (1,024, 200,000), finite); each
   example of ``modl_tpu_torch.examples`` (``decompose_fmri`` and
   ``decompose_images`` for one epoch, the latter on its synthetic image
   as 'face' would download, the others at their defaults: at least one
   BCD launch a learner step, the FISTA launches, the final score and
   seconds); and one run
   of ``exps.exp_decompose_fmri`` (one epoch) through ``Experiment``.

Phase 3 also holds the kernel at the recsys shape (50 x 10,677, l2 ball,
D and the gradient masked by a real batch's union of supports), at the
image fit's shape (128 x 75, the subset's storage width, as the main image
fit calls it) and at the image NMF shapes (128 x 32 and 128 x 75), and the
recsys route at a width one kernel call does not take (256 x 17,770,
Netflix's item count) through the block driver. The kernel-off refits of
phases 10 and 11 run with the kernel's wrapper swapped for its plain
version (``plain_bcd``), and the image refit the FISTA kernel's too
(``plain_fista``).

Then one JSON line per kernel (``{"kernels": [...]}``) and, last, the
device line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result where no CUDA device is visible.

``python3 chip_smoke.py --mesh-only`` runs phases 1, 2, the single-
process ADHD-70 and HCP-1024 fits and phase mesh alone (on a machine
with four cards, its legs over NCCL across them), then the device line.

``python3 chip_smoke.py --step-graph-only`` runs phases 1, 2 and
step_graph alone, then the device line; ``--scan-graph-only`` runs
phases 1, 2, the EMA-GEMM kernel at the fits' three segment-end shapes
and scan_graph, then the device line; ``--recsys-graph-only`` runs
phases 1, 2 and recsys_graph on phase 10's data, then the device line.

Every phase line ends with ``at=``, its seconds since the start. On
its way out, passed or failed, the script stops every process it
started that is still there (``stop_children``): ``multiprocessing``'s
resource tracker, which the mesh phase starts and which would outlive
the script, and any other descendant.

``python3 chip_smoke.py --ab-step-graph TREE [TREE ...]`` times the image
workload's fits of several checkouts in turns on one card through
``modl_tpu_torch/benchmarks/ab_image_fit.py`` (each leg a fresh process
on that checkout's package: three fits of the 20,000-patch subset after
a warm-up, then one face-size epoch; wall and step seconds, and the
steps taken through the step program); give them as A B B A.

``python3 chip_smoke.py --ab-fista TREE [TREE ...]`` times the FISTA
kernel of several checkouts in turns on one card (each TREE the root of
one, for example a ``git archive`` of another commit unpacked under
``build/``; give them as A B B A so that a drift of the card hits both
alike): for each TREE, in the order given, a fresh process imports that
checkout's ``modl_tpu_torch`` (building its kernels) and solves with its
``ops.fista.fista_gram`` on this file's inputs: every ``FISTA_CASES``
shape at the solver's tol, then the image shape at the fixed iteration
counts of ``AB_SWEEP`` with tol 0 (0: the power iteration, prox and
copies alone; 4: iterations without a check; then a check every 5
iterations). A line a solve: the tree, the case, the kernel's mean ms
(``cuda_ms``) and the iterations it ended at; a line a leg: the median
host microseconds of the kernel's entry point (its ctypes call, which
returns without waiting for the card) at the image shape, and how many
cases give codes bitwise equal to each tree's first leg.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

ADHD = dict(n_components=70, reduction=12, code_alpha=3e-4,
            code_l1_ratio=0, comp_l1_ratio=1, learning_rate=0.92,
            batch_size=100, random_state=0, dtype=np.float32,
            subset_sampling='window')
ADHD_SAMPLES, ADHD_TEST, N_FEATURES = 2000, 200, 200_000
HCP = dict(n_components=1024, reduction=20, code_alpha=3e-4,
           code_l1_ratio=0, comp_l1_ratio=1, learning_rate=0.92,
           batch_size=200, random_state=0, dtype=np.float32,
           subset_sampling='window')
HCP_SAMPLES = 1200

# kernel vs plain version: (k, s, comp_l1_ratio, comp_pos); k None is
# the most rows one call takes at that width (a row read from L2, not
# staged in shared memory)
KERNEL_CASES = [(70, 17655, 1.0, False), (256, 10780, 1.0, False),
                (64, 4096, 0.0, False), (64, 4096, 0.5, False),
                (64, 4096, 1.0, True), (70, 17655, 0.5, False),
                (None, 200_000, 1.0, False)]
# the same with a zero gradient and a budget no row reaches: no row
# shrinks, so one exchange an atom is the whole cost
NO_SHRINK_CASES = [(70, 17655, 1.0, False)]
# the image fits' calls, l2 ball: the main fit's ('dictionary
# learning', no sign constraint) at the subset's storage width
# (binomial_len_max(256, 32)), then the NMF fit's (comp_pos) at
# len_subset (256 / 8) and at the storage width
IMAGE_CASES = [(128, 75, 0.0, False), (128, 32, 0.0, True),
               (128, 75, 0.0, True)]
# the recsys route through the block driver: k=256 at Netflix's item
# count (the plan takes at most ~14.9k columns at k=256), a random union
# of 63% of the columns, as at MovieLens-10M
BLOCKED_RECSYS = (256, 17_770, 0.63)
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s, f32
# flop/s outside the tensor cores, 3xTF32 flop/s (495 / 3)
HBM_BPS, F32_FLOPS, TF32X3_FLOPS = 3.35e12, 67e12, 495e12 / 3
# FISTA kernel vs plain version: (label, b, k, features, reduction,
# shared Q, code l1_ratio, positive): the image fit's solve (k=128, a
# batch of 200, the Gram of a 32-feature subset of the 256 pixels scaled
# by 8, rank 32), its NMF, the same with per-row Grams of their own
# subsets (G_agg='average'), ADHD-70's width with an elastic-net code,
# k=1,024, whose shared Q is read from L2; then the image fit's
# transform and score of its 2,000 test patches on the full Gram (tiles
# of 8 rows, 250 tiles over the blocks: state loaded and stored each
# check period, four rows a thread in the product), 500 rows (two rows a
# thread), per-row Grams over 1,200 rows (tiles of 3, looped), at k=200
# (staged one row a tile, whatever the batch) and at k=256 (read from
# device memory); then the register path's other instantiations
# (fista_kernel_registers<NC, R>: NC = ceil(k / 32) warps a row, R rows a
# thread): examples/stability_selection.py's solve (k=16 on 64 features,
# reduction 2, a batch of 50) and a transform of 2,000 and 4,000 rows at
# its k, k=64 at a batch of 200 and over 1,000 and 2,000 rows, ADHD-70's
# width over 500 and 2,000 rows (the l1 fit's transform and score); and
# a shared Q staged in shared memory (k=200)
FISTA_CASES = [('image', 200, 128, 256, 8, True, 1.0, False),
               ('nmf', 200, 128, 256, 8, True, 1.0, True),
               ('average', 200, 128, 256, 8, False, 1.0, False),
               ('adhd70_enet', 100, 70, 2400, 12, True, 0.5, False),
               ('k1024', 200, 1024, 4096, 2, True, 1.0, False),
               ('image_score', 2000, 128, 256, 1, True, 1.0, False),
               ('rows500', 500, 128, 256, 1, True, 1.0, False),
               ('average_b1200', 1200, 128, 256, 8, False, 1.0, False),
               ('average_k200', 200, 200, 1600, 8, False, 1.0, False),
               ('average_k256', 200, 256, 2048, 8, False, 1.0, False),
               ('stability', 50, 16, 64, 2, True, 1.0, False),
               ('k16_b2000', 2000, 16, 64, 1, True, 1.0, False),
               ('k16_b4000', 4000, 16, 64, 1, True, 1.0, False),
               ('k64', 200, 64, 512, 8, True, 1.0, False),
               ('k64_b1000', 1000, 64, 512, 1, True, 1.0, False),
               ('k64_b2000', 2000, 64, 512, 1, True, 1.0, False),
               ('adhd70_b500', 500, 70, 2400, 1, True, 1.0, False),
               ('adhd70_b2000', 2000, 70, 2400, 1, True, 1.0, False),
               ('shared_k200', 200, 200, 1600, 8, True, 1.0, False)]
FISTA_ALPHA = 0.08          # exps/exp_decompose_images.py's alpha
FISTA_FIXED = 200           # iterations of the fixed-count check (tol 0)
# DictFact's tol, and 20 x its max_iter (ops/solvers.py::_enet_dispatch)
FISTA_TOL, FISTA_MAX_ITER = 1e-2, 2000
# codes at a fixed count vs the plain version, relative to max |w| (f32
# sums of Q z in another order, carried through 200 iterations; the
# readings were 2.9e-7 to 6.2e-6 on an H100 80GB HBM3 at 700 W); the
# batch objective at the solver's tol, relative
FISTA_RTOL = 3e-5
FISTA_OBJ_RTOL = 1e-5
# grid barriers a call of the barrier probe times
BARRIERS = 2000
# clock cycles the card sleeps before a timed run of calls (~5 ms at the
# H100's ~1.98 GHz), time for the host to queue them
QUEUE_CYCLES = 10_000_000
# both run the same sequential f32 recurrence with sums taken in another
# order; the l1 Newton branches on sums, so agreement is held at a
# relative 1e-4 of the rows' scale rather than at roundoff
KERNEL_RTOL = 1e-4
# mesh fits' components vs the single-process fit's on the same data,
# relative to max |D| (f32 sums over dp taken in another order); a
# recsys mesh fit's test RMSE vs the single fit's; a mesh world's time
# limit
MESH_RTOL = 1e-4
MESH_RMSE_TOL = 1e-3
MESH_TIMEOUT = 300
# held-out objective of the kernel fit vs the plain-path refit
# (tests/test_tpu_quality.py pins the Pallas path at the same 1e-2)
FIT_RTOL = 1e-2
# offloaded vs resident HCP-1024 components stepped batch by batch (the
# same math: bitwise expected), relative to max |ref|
OFFLOAD_RTOL = 1e-5
# offloaded vs the resident fused epoch (deferred B: B's EMA summed over
# a segment in another order), relative to max |ref|; the sound readings
# were 3.6e-5 (H100 80GB HBM3, 700 W), so a drift of the deferred-B path
# beyond its rounding shows
OFFLOAD_DEFERRED_RTOL = 1e-4
# EMA-GEMM kernel vs plain version, relative to max |ref|: the kernel's
# 3xTF32 split (~1e-6 a product, tests/test_torch_ema_gemm.py) and f32
# sums of m <= 1,200 products taken in another order
EMA_RTOL = 1e-5
EMA_PIS = (0.0, 0.9, 1.0)
# launch-overhead probe vs plain version (both round the same products)
LAUNCH_RTOL = 1e-6
# the streaming fMRI legs: bench.py's (records of 200 frames, planted) and
# exps/hcp/decompose_hcp.py's (records of 1,200 Gaussian frames)
FMRI_ADHD = dict(method='masked', n_components=70, reduction=12,
                 batch_size=100, alpha=3e-4, standardize=True,
                 detrend=True, random_state=0)
FMRI_ADHD_FRAMES, FMRI_RECORDS = 200, 2
FMRI_HCP = dict(method='masked', n_components=1024, reduction=20,
                batch_size=200, learning_rate=0.92, alpha=1e-4,
                standardize=False, detrend=False, random_state=0)
# the NIfTI leg: records and mask as images on the MNI152 3 mm grid, a
# fixed mask of exactly N_FEATURES voxels, the ADHD-70 leg's planted
# frames, fMRIDictFact at bench.py's ADHD settings (uncleaned), 2 epochs;
# components held against the .npy route of the same frames, relative
# to max |D| (the same float32 rows in the same order: bitwise expected)
MNI_3MM = (61, 73, 61)
FMRI_NIFTI = dict(method='masked', n_components=70, reduction=12,
                  batch_size=100, alpha=3e-4, standardize=False,
                  detrend=False, random_state=0)
NIFTI_EPOCHS = 2
NIFTI_RTOL = 1e-5
# the image subset fit's steps profiled for the idle share (of its 100),
# and the least idle gap of the card counted there (a step's host issue
# is ~0.3 ms)
IMAGE_WINDOW = (20, 90)
WINDOW_GAP_MS = 0.5
# the HCP driver pipeline's volumes: two of 400 frames (two full batches
# of 200 a record, so that a deferred-B segment ends in each)
HCP_DRIVER_VOLUMES, HCP_DRIVER_FRAMES = 2, 400
# --ab-fista: launches timed a solve, the image shape's fixed iteration
# counts, host-timed launches of the entry point a leg
AB_REPS, AB_SWEEP, AB_HOST_LAUNCHES = 20, (0, 4, 5, 50, 100, 200), 200
# phase step_graph: steps a leg runs eagerly and through the step
# program (then again for the card's time a step), and host-timed steps
# of each path with the card idle at each call
GRAPH_STEPS, GRAPH_HOST_STEPS = 20, 10
# phase scan_graph: epochs a leg holds bitwise (the first captures),
# epochs timed each way, and the epochs of its whole fit
SCAN_EPOCHS, SCAN_TIMED, SCAN_FIT_EPOCHS = 3, 5, 3
# rounds of on, off, off, on fits in the ADHD-70 leg's gate A/B: the
# kernel's ~1 ms over 6 segment ends sits inside one fit's spread (~32
# ms +- 1.5); the HCP-1024 leg's ~15 ms stands out in one round
AB_ROUNDS_ADHD = 5
# phase recsys_graph: epochs each way from one set-up (the first
# RECSYS_EPOCHS of them are the fit), and the later ones timed
RECSYS_GRAPH_EPOCHS = 5


# the run's start: every phase line ends with its seconds since (``at``)
T_START = time.perf_counter()


def phase(label, **fields):
    fields['at'] = f'{time.perf_counter() - T_START:.1f}'
    print(f'phase={label} ' + ' '.join(f'{k}={v}' for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls on the card: CUDA events
    around the calls, which the host queues while the card sleeps
    ``QUEUE_CYCLES`` first, so that a call shorter than its host issue
    time is timed by the card and not by the host (a call that reads a
    value back waits for the card anyway)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bcd_bound(k, s):
    """(ms, 'bytes' or 'operations'): the least time of one BCD call on
    an H100 SXM. Bytes: D, grad, C and the norms read once, D and the
    norms written once; operations: 2 k^2 s flops for the first residual
    and 2 k^2 s for the rank-1 updates (f32, outside the tensor cores;
    the projection's passes over the rows are left out)."""
    t_bytes = 4 * (3 * k * s + k * k + 3 * k) / HBM_BPS
    t_ops = 4 * k * k * s / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def bcd_inputs(k, s, l1_ratio, g, shrink=True, mask=None):
    """(D, grad, C, comp_norm, order) of one BCD call on the card, drawn
    from the generator ``g``; ``mask`` (s,) zeroes the columns of D and
    the gradient outside a union of supports, as the recsys step does."""
    import torch
    from modl_tpu_torch.ops.enet import enet_scale
    dev = dict(device='cuda', dtype=torch.float32, generator=g)
    D = enet_scale(torch.randn(k, s, **dev), l1_ratio, radius=1.0)
    A = torch.randn(k, k, **dev)
    C = A @ A.T / k + 0.1 * torch.eye(k, device='cuda')
    if shrink:
        grad = C @ (D + 0.3 * torch.randn(k, s, **dev) / math.sqrt(s))
        cn = torch.zeros(k, device='cuda')
    else:
        grad = torch.zeros(k, s, device='cuda')
        cn = torch.full((k,), 1e4, device='cuda')
    if mask is not None:
        D, grad = D * mask, grad * mask
    order = torch.randperm(k, device='cuda', generator=g)
    return D, grad, C, cn, order


def kernel_case(bcd, k, s, l1_ratio, comp_pos, seed, shrink=True,
                mask=None):
    """The kernel against its plain version at one shape (``mask`` as in
    :func:`bcd_inputs`)."""
    import torch
    if k is None:
        k = bcd.max_block(s, torch.float32)
    g = torch.Generator(device='cuda').manual_seed(seed)
    args = bcd_inputs(k, s, l1_ratio, g, shrink=shrink, mask=mask)
    D, cn = args[0], args[3]
    kw = dict(comp_pos=comp_pos, l1_ratio=l1_ratio)
    Dk, cnk = bcd.bcd_update(*args, **kw)
    exchanges = bcd.last_exchanges()
    Dk2, cnk2 = bcd.bcd_update(*args, **kw)
    torch.cuda.synchronize()
    Dr, cnr = bcd.bcd_update_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(Dk).all() and torch.isfinite(cnk).all()):
        raise RuntimeError(f'kernel output not finite at ({k}, {s})')
    err = float((Dk - Dr).abs().max())
    scale = float(Dr.abs().max())
    err_cn = float((cnk - cnr).abs().max())
    budget = float((cn + (D.abs() * (l1_ratio + (1 - l1_ratio) * D.abs()))
                    .sum(1)).abs().max())
    bitwise = bool(torch.equal(Dk, Dk2) and torch.equal(cnk, cnk2))
    ok = (err <= KERNEL_RTOL * scale and err_cn <= KERNEL_RTOL * budget
          and bitwise and exchanges <= k + 2)
    ms = cuda_ms(lambda: bcd.bcd_update(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: bcd.bcd_update_reference(*args, **kw), 2)
    bound_ms, bound_by = bcd_bound(k, s)
    extra = {} if mask is None else dict(
        union_share=f'{float(mask.mean()):.4f}')
    phase('kernel', shape=f'{k}x{s}', l1_ratio=l1_ratio, comp_pos=comp_pos,
          shrink=shrink, **extra, staged=bcd._plan(k, s)[3],
          max_abs_err=f'{err:.3e}', rel_err=f'{err / scale:.3e}',
          cn_abs_err=f'{err_cn:.3e}', exchanges=exchanges,
          bitwise_repeat=bitwise, ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
          bound_ms=f'{bound_ms:.4f}', bound_by=bound_by,
          share_of_bound=f'{bound_ms / ms:.4f}', ok=ok)
    if not ok:
        raise RuntimeError(f'kernel disagrees with its plain version, with '
                           f'itself or with one exchange an atom at '
                           f'({k}, {s}, l1={l1_ratio}, pos={comp_pos})')
    return err, ms, plain_ms, bound_ms, bound_by


def blocked_recsys_case(bcd, seed):
    """The recsys step's BCD route (``_step.bcd_kernel``, l2 ball, masked
    D and gradient) at a width one kernel call does not take: the block
    driver, one launch a block, against the plain version."""
    import torch
    from modl_tpu_torch.decomposition._step import bcd_kernel
    k, s, share = BLOCKED_RECSYS
    g = torch.Generator(device='cuda').manual_seed(seed)
    mask = (torch.rand(s, device='cuda', generator=g) < share).float()
    D, grad, C, cn, order = bcd_inputs(k, s, 0.0, g, mask=mask)
    block = bcd.max_block(s, torch.float32)
    blocks = -(-k // block)
    bcd.LAUNCHES = 0
    Dk, cnk = bcd_kernel(D.clone(), grad, C, cn, order, False, 0.0)
    launches = bcd.LAUNCHES
    Dr, cnr = bcd.bcd_update_reference(D, grad, C, cn, order)
    torch.cuda.synchronize()
    err = float((Dk - Dr).abs().max())
    scale = float(Dr.abs().max())
    err_cn = float((cnk - cnr).abs().max())
    budget = float((cn + (D * D).sum(1)).abs().max())
    ok = (bool(torch.isfinite(Dk).all()) and not bcd.supported(
        k, s, torch.float32) and launches == blocks >= 2
        and err <= KERNEL_RTOL * scale and err_cn <= KERNEL_RTOL * budget)
    phase('kernel_blocked', shape=f'{k}x{s}', l1_ratio=0.0,
          union_share=f'{float(mask.mean()):.4f}', block=block,
          launches=launches, max_abs_err=f'{err:.3e}',
          rel_err=f'{err / scale:.3e}', cn_abs_err=f'{err_cn:.3e}', ok=ok)
    if not ok:
        raise RuntimeError(f'the recsys route at ({k}, {s}) did not go '
                           f'through {blocks} kernel blocks or disagrees '
                           'with the plain version')
    return err


@contextlib.contextmanager
def plain_bcd():
    """The BCD kernel's wrapper swapped for its plain version, which then
    runs on the card, for a kernel-off refit; restored after. Its steps
    run eagerly (``eager_steps``)."""
    from modl_tpu_torch.ops import bcd
    saved = bcd.bcd_update
    bcd.bcd_update = bcd.bcd_update_reference
    try:
        with eager_steps():
            yield
    finally:
        bcd.bcd_update = saved


@contextlib.contextmanager
def plain_fista():
    """The FISTA kernel's wrapper swapped for its plain version (which
    then runs on the card) in the code solvers' dispatch; restored
    after."""
    from modl_tpu_torch.ops import fista, solvers
    saved = solvers.fista_gram
    solvers.fista_gram = fista.fista_gram_reference
    try:
        with eager_steps():
            yield
    finally:
        solvers.fista_gram = saved


@contextlib.contextmanager
def eager_steps():
    """No configuration runs as a program (``_program.capturable`` and
    ``capturable_recsys`` say no): for the kernel-off refits, whose plain
    versions read values back (the BCD's atom order, FISTA's count),
    which a captured step cannot, and for the eager side of phase
    recsys_graph; restored after."""
    from modl_tpu_torch.decomposition import _program
    saved = _program.capturable, _program.capturable_recsys
    _program.capturable = lambda cfg: False
    _program.capturable_recsys = lambda cfg, resident: False
    try:
        yield
    finally:
        _program.capturable, _program.capturable_recsys = saved


@contextlib.contextmanager
def steps_without_host_reads():
    """Every ``DictFact`` step (the step program's staging, capture and
    replay, or the eager step) run under
    ``torch.cuda.set_sync_debug_mode('error')``: a step that waits for
    the card raises."""
    import torch
    from modl_tpu_torch.decomposition.dict_fact import DictFact
    saved = DictFact._step_batch

    def guarded(self, *args, **kwargs):
        torch.cuda.set_sync_debug_mode('error')
        try:
            return saved(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode('default')

    DictFact._step_batch = guarded
    try:
        yield
    finally:
        DictFact._step_batch = saved


@contextlib.contextmanager
def fista_without_host_reads():
    """Every FISTA solve of the code solvers' dispatch run under
    ``torch.cuda.set_sync_debug_mode('error')``: a solve that waits for
    the card (reads a value back) raises."""
    import torch
    from modl_tpu_torch.ops import solvers
    saved = solvers.fista_gram

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode('error')
        try:
            return saved(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode('default')

    solvers.fista_gram = guarded
    try:
        yield
    finally:
        solvers.fista_gram = saved


def fista_inputs(b, k, n, reduction, shared, g):
    """(w0, Q, q, y_norm2) of one code solve on the card: unit-norm atoms
    D (k, n), rows X = sparse codes @ D + noise, and the masked step's
    estimates from a subset of n / reduction features scaled by the
    reduction, one subset for the batch (shared Q) or one a row."""
    import torch
    dev = dict(device='cuda', dtype=torch.float32, generator=g)
    D = torch.randn(k, n, **dev)
    D /= D.norm(dim=1, keepdim=True)
    codes = torch.randn(b, k, **dev) * (torch.rand(b, k, **dev) < 0.05)
    X = codes @ D + 0.1 * torch.randn(b, n, **dev)
    s = n // reduction
    if shared:
        cols = torch.randperm(n, device='cuda', generator=g)[:s]
        Ds = D[:, cols]
        Q = Ds @ Ds.T * reduction
        q = X[:, cols] @ Ds.T * reduction
    else:
        cols = torch.argsort(torch.rand(b, n, **dev), dim=1)[:, :s]
        Ds = D[:, cols].permute(1, 0, 2)                  # (b, k, s)
        Q = Ds @ Ds.transpose(1, 2) * reduction
        q = torch.einsum('bs,bks->bk', torch.gather(X, 1, cols),
                         Ds) * reduction
    return (torch.ones(b, k, device='cuda'), Q.contiguous(), q.contiguous(),
            (X * X).sum(1))


def fista_objective(w, Q, q, y2, l1, l2):
    """The batch's penalised objective sum_i 1/2 ||x_i||^2 - q_i.w_i +
    1/2 w_i Q_i w_i + l1 |w_i|_1 + l2/2 |w_i|^2, in float64."""
    w, Q, q, y2 = (t.double() for t in (w, Q, q, y2))
    Qw = w @ Q if Q.ndim == 2 else (Q @ w[:, :, None])[:, :, 0]
    return float((0.5 * y2 - (q * w).sum(1) + 0.5 * (w * Qw).sum(1)
                  + l1 * w.abs().sum(1) + 0.5 * l2 * (w * w).sum(1)).sum())


def fista_bound(b, k, shared, iters):
    """(ms, 'bytes' or 'operations'): the least time of a solve of
    ``iters`` iterations on an H100 SXM. Operations: 2 b k^2 flops for Q z
    an iteration and for Q w a check, 2 k^2 (per row: 2 b k^2) for each of
    the 17 power-iteration products (f32, outside the tensor cores);
    bytes: w0, q, Q and ||x||^2 read once, w written once."""
    from modl_tpu_torch.ops import fista
    prods = iters + iters // fista.CHECK_EVERY
    flops = 2 * b * k * k * prods + 2 * (1 if shared else b) * k * k * (
        fista.POWER_ITERS + 1)
    t_ops = flops / F32_FLOPS
    t_bytes = 4 * (3 * b * k + b + (k * k if shared else b * k * k)) \
        / HBM_BPS
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def fista_instance(k, shared, plan):
    """The ``fista_gram.cu`` instantiation a :class:`fista.Plan` launches,
    named as the ptxas report names it: ``fista_kernel_registers<NC,R>``
    on the register path (NC = ceil(k / 32) warps a row, R rows a
    thread), else ``fista_kernel<SHARED,QSMEM>``."""
    if plan.path == 'registers':
        return f'fista_kernel_registers<{-(-k // 32)},{plan.rows_a_thread}>'
    return (f'fista_kernel<{str(bool(shared)).lower()},'
            f'{str(plan.q_smem).lower()}>')


def record_fista_instances():
    """Returns a set to which, from now on, the instantiation of every
    FISTA solve planned in this process is added (``fista._plan`` is
    called once a solve)."""
    from modl_tpu_torch.ops import fista
    seen, plan = set(), fista._plan

    def recorded(b, k, shared, sms):
        p = plan(b, k, shared, sms)
        seen.add(fista_instance(k, shared, p))
        return p

    fista._plan = recorded
    return seen


def fista_case(label, b, k, n, reduction, shared, l1_ratio, positive, seed):
    """The FISTA kernel against its plain version at one shape: codes at
    a fixed count (tol 0), the iterations and batch objective at the
    solver's tol, a second launch bitwise equal to the first, half the
    batch alone equal to its rows of the whole batch's solve, the check-
    at-a-time driver (``agree``) bitwise equal to the one-launch solve,
    and the one-launch solve with host reads forbidden."""
    import torch
    from modl_tpu_torch.ops import fista
    from modl_tpu_torch.ops.precision import full_f32
    g = torch.Generator(device='cuda').manual_seed(seed)
    w0, Q, q, y2 = fista_inputs(b, k, n, reduction, shared, g)
    l1, l2 = FISTA_ALPHA * l1_ratio, FISTA_ALPHA * (1.0 - l1_ratio)
    fixed = (w0, Q, q, y2, l1, l2, positive, FISTA_FIXED, 0.0)
    solve = (w0, Q, q, y2, l1, l2, positive, FISTA_MAX_ITER, FISTA_TOL)
    half = b // 2
    sub = (w0[:half], Q if shared else Q[:half].contiguous(), q[:half],
           y2[:half], l1, l2, positive, FISTA_FIXED, 0.0)
    checks = []

    def counted(left):
        checks.append(left)
        return left

    with full_f32():
        wk = fista.fista_gram(*fixed)
        iters_fixed = fista.last_iterations()
        wk2 = fista.fista_gram(*fixed)
        wh = fista.fista_gram(*sub)
        wr = fista.fista_gram_reference(*fixed)
        ws = fista.fista_gram(*solve)
        iters = fista.last_iterations()
        before = fista.LAUNCHES
        torch.cuda.set_sync_debug_mode('error')
        try:
            fista.fista_gram(*solve)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        launches = fista.LAUNCHES - before
        before = fista.LAUNCHES
        wc = fista.fista_gram(*solve, agree=lambda left: left)
        chunk_launches = fista.LAUNCHES - before
        wp = fista.fista_gram_reference(*solve, agree=counted)
        torch.cuda.synchronize()
    iters_plain = min(fista.CHECK_EVERY * len(checks), FISTA_MAX_ITER)
    finite = bool(torch.isfinite(wk).all() and torch.isfinite(ws).all())
    err = float((wk - wr).abs().max())
    scale = float(wr.abs().max())
    obj_k = fista_objective(ws, Q, q, y2, l1, l2)
    obj_p = fista_objective(wp, Q, q, y2, l1, l2)
    obj_rel = abs(obj_k - obj_p) / abs(obj_p)
    bitwise = bool(torch.equal(wk, wk2))
    rows = bool(torch.equal(wh, wk[:half]))
    chunks = bool(torch.equal(wc, ws))
    with full_f32():
        ms = cuda_ms(lambda: fista.fista_gram(*solve), 10)
        plain_ms = cuda_ms(lambda: fista.fista_gram_reference(*solve), 2)
    bound_ms, bound_by = fista_bound(b, k, shared, iters)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fista._plan(b, k, shared, sms)
    ok = (finite and err <= FISTA_RTOL * scale and bitwise and rows
          and chunks and launches == 1
          and abs(iters - iters_plain) <= fista.CHECK_EVERY
          and obj_rel <= FISTA_OBJ_RTOL)
    phase('fista', case=label, b=b, k=k, Q='shared' if shared else 'per_row',
          path=plan.path, kernel=fista_instance(k, shared, plan),
          rows_a_tile=plan.rt,
          rows_a_thread=plan.rows_a_thread, blocks=plan.grid,
          l1_ratio=l1_ratio,
          positive=positive, fixed_iterations=iters_fixed,
          max_abs_err=f'{err:.3e}', rel_err=f'{err / scale:.3e}',
          iterations=iters, iterations_plain=iters_plain,
          objective=f'{obj_k:.9g}', objective_plain=f'{obj_p:.9g}',
          objective_rel=f'{obj_rel:.3e}', bitwise_repeat=bitwise,
          rows_invariant=rows, chunks_bitwise=chunks,
          chunk_launches=chunk_launches, launches=launches, host_reads=0,
          ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
          bound_ms=f'{bound_ms:.4f}', bound_by=bound_by,
          share_of_bound=f'{bound_ms / ms:.4f}', ok=ok)
    if not ok:
        raise RuntimeError(f'fista: the kernel disagrees with its plain '
                           f'version or with itself at {label}')
    return err, ms, plain_ms, bound_ms, bound_by, fista_instance(k, shared,
                                                                 plan)


def ptxas_report(log):
    """[(kernel, registers, stack frame bytes, spill store bytes, spill
    load bytes)] of each entry function in an ``nvcc -Xptxas -v`` log,
    names demangled where ``c++filt`` is on the machine."""
    import re
    rows = []
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            name = m.group(1)
            if not rows or rows[-1][0] != name:
                rows.append([name, None, 0, 0, 0])
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and rows:
            rows[-1][2:] = [int(v) for v in m.groups()]
        m = re.search(r'Used (\d+) registers', line)
        if m and rows:
            rows[-1][1] = int(m.group(1))
    try:
        names = subprocess.run(['c++filt'], input='\n'.join(r[0] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [r[0] for r in rows]
    # 'void (anonymous namespace)::f<1, 2>((anonymous namespace)::Params)'
    short = [re.sub(r'\(.*', '', n.replace('(anonymous namespace)::', ''))
             .split(' ', 1)[-1] for n in names]
    return [(s, *r[1:]) for s, r in zip(short, rows)]


def fista_phase():
    """Phase fista: the registers and spills of every FISTA kernel
    instantiation (the build's ptxas report), then every FISTA_CASES
    shape; fails unless the cases launch every instantiation built.
    Returns the cases' results (the image case first)."""
    from modl_tpu_torch.ops import _build
    log = _build.library_path().with_suffix('.log').read_text()
    built = set()
    for name, regs, stack, stores, loads in ptxas_report(log):
        if 'fista_kernel' in name:
            built.add(name.replace(' ', ''))
            phase('fista_ptxas', kernel=name.replace(' ', ''),
                  registers=regs, stack_frame_bytes=stack,
                  spill_store_bytes=stores, spill_load_bytes=loads)
    results = [fista_case(*case, seed=100 + i)
               for i, case in enumerate(FISTA_CASES)]
    missed = built - {r[5] for r in results}
    if not built or missed:
        raise RuntimeError(f'fista: no case launches {sorted(missed)} '
                           f'(built: {sorted(built)})')
    return results


def barrier_phase(grid):
    """Microseconds per grid barrier alone, on a cooperative grid of
    ``grid`` blocks of the BCD kernel's size: cooperative groups'
    grid.sync and the kernel's own counter barrier."""
    import ctypes

    import torch
    from modl_tpu_torch.ops import _build
    probe = _build.entry('modl_bcd_barrier_probe',
                         [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    counter = torch.zeros(1, dtype=torch.int32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def run(n, hand):
        counter.zero_()
        err = probe(n, hand, grid, counter.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f'barrier probe failed with cudaError {err}')

    us = {}
    for hand, label in ((0, 'grid_sync'), (1, 'counter')):
        run(BARRIERS, hand)                          # warm-up
        t_n = cuda_ms(lambda: run(BARRIERS, hand), 3)
        t_0 = cuda_ms(lambda: run(0, hand), 3)
        us[label] = (t_n - t_0) * 1e3 / BARRIERS
    phase('barrier', blocks=grid, barriers=BARRIERS,
          **{f'us_per_{key}': f'{v:.3f}' for key, v in us.items()})
    return us


def adhd_data():
    """bench.py's ADHD-70 planted data (seed 0) plus 200 held-out rows of
    the same model."""
    rng = np.random.RandomState(0)
    U = rng.randn(ADHD_SAMPLES, 70).astype(np.float32)
    V = rng.randn(70, N_FEATURES).astype(np.float32) / 30
    X = U @ V + 0.1 * rng.randn(ADHD_SAMPLES, N_FEATURES).astype(np.float32)
    rng = np.random.RandomState(1)
    X_test = (rng.randn(ADHD_TEST, 70).astype(np.float32) @ V
              + 0.1 * rng.randn(ADHD_TEST, N_FEATURES).astype(np.float32))
    return X, X_test


def timed_fit(estimator, X):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    estimator.fit(X)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3


@contextlib.contextmanager
def ema_gate(enabled):
    """The EMA-GEMM gate set to ``enabled``; the caller's setting is
    restored after."""
    from modl_tpu_torch.ops import ema_gemm
    saved = ema_gemm.ENABLED
    ema_gemm.ENABLED = enabled
    try:
        yield
    finally:
        ema_gemm.ENABLED = saved


def resident_fit(kw, X, enabled):
    """One ``DictFact.fit`` on the card with the EMA-GEMM gate set to
    ``enabled``; returns (estimator, wall seconds, launches of the BCD and
    EMA-GEMM kernels during the fit)."""
    from modl_tpu_torch import DictFact
    from modl_tpu_torch.ops import bcd, ema_gemm
    with ema_gate(enabled):
        df = DictFact(**kw, device='cuda')
        bcd.LAUNCHES = ema_gemm.LAUNCHES = 0
        seconds = timed_fit(df, X)
    return df, seconds, bcd.LAUNCHES, ema_gemm.LAUNCHES


def check_resident_ema(label, cfg, n_rows, batch, on, off):
    """EMA-GEMM launches of a one-epoch resident fit with the gate on and
    off: one per deferred-B segment end, and none."""
    want = expected_launches(cfg, n_rows, batch, 1, 1, 1)[1]
    if (on, off) != (want, 0) or want == 0:
        raise RuntimeError(f'{label}: {on} EMA-GEMM launches with the gate '
                           f'on and {off} off, expected {want} and 0')
    return want


def adhd70_l1_phase(X, X_test):
    """DictFact's default codes (``code_l1_ratio=1``, FISTA on the card)
    at ADHD-70 width through ``DictFact.fit``: one FISTA and one BCD
    launch a step, every solve without a host read, a held-out objective
    below the initial dictionary's and within FIT_RTOL of a refit with
    both kernels' plain versions. Returns (components, (BCD, EMA-GEMM)
    launches, FISTA launches)."""
    from modl_tpu_torch import DictFact
    from modl_tpu_torch.ops import fista
    kw = dict(ADHD, code_l1_ratio=1.0)
    steps = ADHD_SAMPLES // ADHD['batch_size']
    obj0 = DictFact(**kw, device='cuda').prepare(
        n_samples=ADHD_SAMPLES, X=X).score(X_test)
    fista.LAUNCHES = 0
    with fista_without_host_reads():
        df, seconds, launches, ema = resident_fit(kw, X, True)
    fista_launches = fista.LAUNCHES
    obj = df.score(X_test)
    plain = DictFact(**kw, device='cuda')
    fista.LAUNCHES = 0
    with plain_bcd(), plain_fista():
        plain_seconds = timed_fit(plain, X)
        obj_plain = plain.score(X_test)
    plain_launches = fista.LAUNCHES
    rel = abs(obj - obj_plain) / abs(obj_plain)
    phase('adhd70_l1', code_solver=df._cfg.code_solver, steps=steps,
          fista_launches=fista_launches, bcd_launches=launches,
          ema_launches=ema, fista_launches_plain=plain_launches,
          host_reads_in_solves=0, objective=f'{obj:.6g}',
          objective_init=f'{obj0:.6g}', objective_plain=f'{obj_plain:.6g}',
          rel_diff=f'{rel:.3e}',
          fit_samples_per_s=f'{ADHD_SAMPLES / seconds:.1f}',
          epoch_samples_per_s=f'{ADHD_SAMPLES / df.time_:.1f}',
          plain_fit_samples_per_s=f'{ADHD_SAMPLES / plain_seconds:.1f}')
    if (fista_launches, launches, plain_launches) != (steps, steps, 0):
        raise RuntimeError(f'ADHD-70 l1: {fista_launches} FISTA and '
                           f'{launches} BCD launches ({plain_launches} '
                           f'plain), expected {steps} each (0)')
    if not (math.isfinite(obj) and obj < obj0):
        raise RuntimeError(f'ADHD-70 l1: objective {obj} not below the '
                           f'initial {obj0}')
    if not rel < FIT_RTOL:
        raise RuntimeError(f'ADHD-70 l1: kernel and plain fits differ: '
                           f'rel {rel}')
    return df.components_, (launches, ema), fista_launches


def clone_state(st):
    """A copy of a learner state: its tensors cloned, its generator
    carrying the same state (so both draw alike)."""
    import torch
    from modl_tpu_torch.decomposition._step import SomfState
    gen = torch.Generator()
    gen.set_state(st.gen.get_state())
    return SomfState(**{
        f.name: (getattr(st, f.name).clone()
                 if torch.is_tensor(getattr(st, f.name))
                 else getattr(st, f.name))
        for f in dataclasses.fields(SomfState) if f.name != 'gen'}, gen=gen)


def graph_pool_mb(graph):
    """MB of the device memory segments of a captured graph's pool."""
    import torch
    pool = tuple(graph.pool())
    return sum(seg['total_size'] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get('segment_pool_id', ())) == pool) / 2 ** 20


def noop_callback(est):
    """A fit callback that does nothing: with it ``DictFact`` steps batch
    by batch (``_step_batch``)."""


def image_rows(n_rows):
    """``n_rows`` patches of the synthetic face-size image as the image
    fit's learner sees them, and that learner's parameters."""
    from modl_tpu_torch import ImageDictFact
    from modl_tpu_torch.benchmarks.workloads import IMAGE, IMAGE_SHAPE
    from modl_tpu_torch.datasets.image import make_synthetic_image
    from modl_tpu_torch.feature_extraction.image import \
        LazyCleanPatchExtractor
    img = ImageDictFact(**IMAGE, device='cuda')
    patches = LazyCleanPatchExtractor(
        patch_size=IMAGE['patch_size'], max_patches=n_rows,
        random_state=IMAGE['random_state']).fit(
            make_synthetic_image(*IMAGE_SHAPE)).transform()
    kw = img._learner().get_params()
    del kw['callback'], kw['device']
    return np.ascontiguousarray(img._as_rows(patches), np.float32), kw


def step_graph_leg(label, kw, X):
    """``kw``'s ``DictFact`` prepared on ``X`` (gather subsets, as
    ``partial_fit`` takes them): GRAPH_STEPS steps from one carried state
    with one set of draws through ``somf_step`` and through a
    ``StepProgram`` (the first runs eagerly and captures, the others
    replay under ``set_sync_debug_mode('error')``), every leaf held
    bitwise; host us to issue a step with the card idle, the card's ms a
    step over GRAPH_STEPS back to back, capture seconds and the pool's
    MB; then ``partial_fit`` with a callback over GRAPH_STEPS batches
    through the estimator: one capture, every step on the program, one
    BCD launch a step and block, one FISTA launch a step for l1 codes.
    Returns the leg's numbers."""
    import statistics

    import torch
    from modl_tpu_torch import DictFact
    from modl_tpu_torch.decomposition import _program, _step
    from modl_tpu_torch.ops import bcd, fista
    leg_t0 = time.perf_counter()
    b, n = kw['batch_size'], X.shape[0]
    df = DictFact(**kw, device='cuda').prepare(n_samples=n, X=X)
    cfg = df._cfg
    if cfg.windowed or not _program.capturable(cfg):
        raise RuntimeError(f'step_graph {label}: the configuration does '
                           'not run as a step program')
    X_dev = torch.as_tensor(X).cuda()

    def batch(t):
        lo = (t * b) % (n - n % b)
        return X_dev[lo:lo + b], torch.arange(lo, lo + b, device='cuda')

    def launches():
        return bcd.LAUNCHES, fista.LAUNCHES

    eager, graph = clone_state(df._state), clone_state(df._state)
    del df
    staging = _step.DrawStaging('cuda')
    c0 = launches()
    for t in range(GRAPH_STEPS):
        _step.somf_step(eager, *batch(t), cfg, staging)
    torch.cuda.synchronize()
    c1 = launches()
    l1 = cfg.code_l1_ratio != 0
    # the last launches' scratch: BCD exchanges, FISTA iterations
    scratch_eager = (bcd.last_exchanges(),
                     fista.last_iterations() if l1 else None)
    prog = _program.StepProgram(graph, cfg, b)
    t0 = time.perf_counter()
    prog.step(*batch(0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode('error')
    try:
        for t in range(1, GRAPH_STEPS):
            prog.step(*batch(t))
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    c2 = launches()
    # read from the graph pool's scratch, written by the last replay
    scratch_graph = (bcd.last_exchanges(),
                     fista.last_iterations() if l1 else None)
    diffs = {}
    for name in ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg',
                 'G_avg', 'sample_n_iter'):
        a, e = getattr(graph, name), getattr(eager, name)
        if a is not None:
            diffs[name] = float((a.double() - e.double()).abs().max())
    bitwise = all(d == 0.0 for d in diffs.values())
    eager_launches = tuple(y - x for x, y in zip(c0, c1))
    graph_launches = tuple(y - x for x, y in zip(c1, c2))

    def host_us(step):
        """Median host us of ``step(t)``'s parts (a list of their
        seconds), the card idle at each call."""
        parts = []
        for t in range(GRAPH_HOST_STEPS):
            torch.cuda.synchronize()
            parts.append(step(t))
        torch.cuda.synchronize()
        return [1e6 * statistics.median(p) for p in zip(*parts)]

    def card_ms(step):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for t in range(GRAPH_STEPS):
            step(t)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / GRAPH_STEPS

    def eager_step(t):
        X_b, idx = batch(t)
        t0 = time.perf_counter()
        _step.somf_step(eager, X_b, idx, cfg, staging)
        return [time.perf_counter() - t0]

    def graph_step(t):
        """``prog.step`` in its parts: the host draws and scalars, the
        staging, the replay, and the whole."""
        X_b, idx = batch(t)
        t0 = time.perf_counter()
        subset, n_valid, order = _step.draw_step(graph, cfg)
        scalars = _step.step_scalars(graph, cfg, b, n_valid)
        t1 = time.perf_counter()
        prog.stage(X_b, idx, (subset, order), scalars)
        t2 = time.perf_counter()
        prog.run()
        t3 = time.perf_counter()
        return [t1 - t0, t2 - t1, t3 - t2, t3 - t0]

    draw_us, stage_us, replay_us, graph_us = host_us(graph_step)
    timed = dict(eager_host_us=host_us(eager_step)[0], graph_host_us=graph_us,
                 draw_us=draw_us, stage_us=stage_us, replay_us=replay_us,
                 eager_ms=card_ms(eager_step), graph_ms=card_ms(graph_step))
    pool_mb = graph_pool_mb(prog.graph)
    capture_s = prog.capture_s
    del prog, eager, graph, staging
    # the estimator's interactive path
    captures, steps0 = _program.CAPTURES, _program.STEPS
    c0 = launches()
    est = DictFact(**kw, callback=noop_callback, device='cuda').prepare(
        n_samples=n, X=X)
    rows = min(n - n % b, GRAPH_STEPS * b)
    est.partial_fit(X[:rows], sample_indices=np.arange(rows))
    torch.cuda.synchronize()
    fit_launches = tuple(y - x for x, y in zip(c0, launches()))
    captures = _program.CAPTURES - captures
    fit_steps = _program.STEPS - steps0
    blocks = bcd_blocks(cfg)
    want = (rows // b * blocks, rows // b if l1 else 0)
    phase('step_graph', leg=label, k=cfg.n_components, batch=b,
          len_subset=cfg.len_subset, len_max=cfg.len_max,
          Dx_agg=cfg.Dx_agg, G_agg=cfg.G_agg,
          code='fista' if l1 else 'ridge', blocks=blocks,
          steps=GRAPH_STEPS, bitwise=bitwise,
          max_abs_diff=','.join(f'{k}:{v:.3e}' for k, v in diffs.items()),
          launches_eager='/'.join(map(str, eager_launches)),
          launches_graph='/'.join(map(str, graph_launches)),
          host_syncs_in_replays=0,
          exchanges='/'.join(map(str, (scratch_eager[0], scratch_graph[0]))),
          fista_iterations='/'.join(map(str, (scratch_eager[1],
                                               scratch_graph[1]))),
          **{key: f'{v:.1f}' if key.endswith('us') else f'{v:.4f}'
             for key, v in timed.items()},
          first_step_s=f'{first_s:.4f}', capture_s=f'{capture_s:.4f}',
          pool_MB=f'{pool_mb:.1f}', fit_path='graph' if fit_steps == rows
          // b else 'eager', fit_captures=captures, fit_steps=fit_steps,
          fit_launches='/'.join(map(str, fit_launches)),
          leg_s=f'{time.perf_counter() - leg_t0:.2f}')
    if scratch_graph != scratch_eager or not scratch_graph[0]:
        raise RuntimeError(f'step_graph {label}: the last launches\' '
                           f'scratch reads {scratch_graph} after the '
                           f'replays, {scratch_eager} after the eager steps')
    if not bitwise:
        raise RuntimeError(f'step_graph {label}: the captured steps differ '
                           f'from the eager steps: {diffs}')
    per_run = (GRAPH_STEPS * blocks, GRAPH_STEPS if l1 else 0)
    if eager_launches != per_run or graph_launches != per_run:
        raise RuntimeError(f'step_graph {label}: launches {eager_launches} '
                           f'eager and {graph_launches} captured, expected '
                           f'{per_run}')
    if (captures, fit_steps, fit_launches) != (1, rows // b, want):
        raise RuntimeError(f'step_graph {label}: partial_fit took '
                           f'{fit_steps} of {rows // b} steps through the '
                           f'program with {captures} captures and '
                           f'{fit_launches} launches, expected one capture '
                           f'and {want}')
    return dict(timed, capture_s=capture_s, pool_mb=pool_mb)


def step_graph_phase(legs):
    """Phase step_graph over ``legs`` ((label, DictFact parameters, X)
    each)."""
    return {label: step_graph_leg(label, kw, X) for label, kw, X in legs}


def adhd_graph_legs(X):
    """The ADHD-70 configuration as ``partial_fit`` takes it (gather
    subsets) with ridge codes, l1 codes (FISTA), the 'average'
    aggregators with l1 codes (FISTA on per-row Grams) and with ridge
    codes (batched Cholesky and triangular solves on per-row Grams,
    ``ops.solvers.spd_solve``), and the 'full' ones with ridge codes."""
    kw = {key: v for key, v in ADHD.items() if key != 'subset_sampling'}
    average = dict(kw, Dx_agg='average', G_agg='average')
    return [('adhd70_ridge', kw, X),
            ('adhd70_l1', dict(kw, code_l1_ratio=1.0), X),
            ('adhd70_average', dict(average, code_l1_ratio=1.0), X),
            ('adhd70_average_ridge', average, X),
            ('adhd70_full', dict(kw, Dx_agg='full', G_agg='full'), X)]


def image_graph_leg():
    """The image fit's step (k=128, 16 x 16 patches, reduction 8, Binomial
    sizes, FISTA, batch 200) on GRAPH_STEPS batches of its patches."""
    X, kw = image_rows(GRAPH_STEPS * 200)
    return [('image', kw, X)]


def hcp_graph_leg(X):
    """The HCP-1024 configuration as ``partial_fit`` takes it (gather
    subsets, the BCD block driver), over the 1,200 rows in turn."""
    kw = {key: v for key, v in HCP.items() if key != 'subset_sampling'}
    return [('hcp1024', kw, X)]


def scan_graph_leg(label, kw, X):
    """``kw``'s ``DictFact`` prepared on ``X`` (its n // b full batches):
    SCAN_EPOCHS epochs from one carried state with one set of draws
    through the eager ``somf_scan`` and through a ``ScanProgram`` (the
    first epoch runs eagerly and captures, the others replay under
    ``set_sync_debug_mode('error')``), every leaf held bitwise after each
    epoch and the BCD, EMA-GEMM and FISTA launches equal to the epoch's;
    windowed legs also run the epochs with host window starts (the
    slicing body of the step before the starts went to the device),
    whose largest relative difference is printed. Then SCAN_TIMED epochs
    each way: wall seconds (medians), the card's ms an epoch (CUDA events
    over epochs back to back), the host us to draw, stage and replay with
    the card idle, the capture's seconds and the pool's MB, the idle share
    of one profiled epoch each way, and the row copy's and the window
    gather's ms. Returns the leg's numbers."""
    import statistics

    import torch
    from modl_tpu_torch import DictFact
    from modl_tpu_torch.decomposition import _program, _step
    from modl_tpu_torch.ops import bcd, ema_gemm, fista
    from modl_tpu_torch.utils.profiling import device_summary, device_trace
    leg_t0 = time.perf_counter()
    b = kw['batch_size']
    T = X.shape[0] // b
    df = DictFact(**kw, device='cuda').prepare(n_samples=X.shape[0], X=X)
    cfg = df._cfg
    if not _program.capturable(cfg):
        raise RuntimeError(f'scan_graph {label}: the configuration does not '
                           'run as a scan program')
    X_dev = df._ingest_features(torch.as_tensor(X[:T * b]).cuda())
    Xb = X_dev.view(T, b, -1)
    idx = torch.arange(T * b, device='cuda')
    ib = idx.view(T, b)
    eager, graph, sliced = (clone_state(df._state) for _ in range(3))
    del df
    staging = _step.DrawStaging('cuda')
    prog = _program.ScanProgram(graph, cfg, T, b)
    seg = _step._deferred_seg(cfg, T)
    ends = -(-T // seg) if seg >= 2 else 0
    l1 = cfg.code_l1_ratio != 0
    blocks = bcd_blocks(cfg)
    want = (T * blocks, ends if ema_gemm.ENABLED else 0, T if l1 else 0)

    def launches():
        return bcd.LAUNCHES, ema_gemm.LAUNCHES, fista.LAUNCHES

    def eager_epoch():
        _step.somf_scan(eager, Xb, ib, cfg, _step.draw_epoch(eager, cfg, T),
                        staging)

    def graph_epoch():
        prog.epoch(X_dev, idx, _step.draw_epoch(graph, cfg, T))

    def sliced_epoch():
        """The epoch with its window starts as host ints (slices)."""
        draws = _step.draw_epoch(sliced, cfg, T)
        steps = _step.stage_epoch(sliced, cfg, b, draws, staging)
        _step._scan_body(sliced, Xb, ib, cfg, [
            (start,) + step[1:] for start, step in zip(draws.subsets,
                                                       steps)])

    def counted(fn, guard=False):
        c0 = launches()
        if guard:
            torch.cuda.set_sync_debug_mode('error')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        return tuple(y - x for x, y in zip(c0, launches()))

    diffs, rel_sliced, counts = {}, {}, set()
    for epoch in range(SCAN_EPOCHS):
        counts.add(('eager', counted(eager_epoch)))
        counts.add(('graph', counted(graph_epoch, guard=epoch > 0)))
        for name in _program.LEAVES:
            a, e = getattr(graph, name), getattr(eager, name)
            if a is not None:
                d = float((a.double() - e.double()).abs().max())
                diffs[name] = max(diffs.get(name, 0.0), d)
        if cfg.windowed:
            sliced_epoch()
            torch.cuda.synchronize()
            for name in ('D', 'B', 'C', 'comp_norm', 'code'):
                a, e = getattr(graph, name), getattr(sliced, name)
                r = float((a.double() - e.double()).abs().max()
                          / e.double().abs().max().clamp_min(1e-30))
                rel_sliced[name] = max(rel_sliced.get(name, 0.0), r)
    bitwise = all(d == 0.0 for d in diffs.values())
    del sliced

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def card_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(SCAN_TIMED):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / SCAN_TIMED

    def host_parts():
        """The host's seconds of an epoch's draws, staging and replay,
        and of an eager epoch's issue, each with the card idle."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws = _step.draw_epoch(graph, cfg, T)
        t1 = time.perf_counter()
        prog.stage(X_dev, idx, draws)
        t2 = time.perf_counter()
        prog.run()
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        eager_epoch()
        t5 = time.perf_counter()
        torch.cuda.synchronize()
        return t1 - t0, t2 - t1, t3 - t2, t5 - t4

    timed = dict(
        eager_epoch_s=statistics.median(wall(eager_epoch)
                                        for _ in range(SCAN_TIMED)),
        graph_epoch_s=statistics.median(wall(graph_epoch)
                                        for _ in range(SCAN_TIMED)),
        eager_card_ms=card_ms(eager_epoch), graph_card_ms=card_ms(graph_epoch))
    parts = [host_parts() for _ in range(SCAN_TIMED)]
    draw_us, stage_us, replay_us, eager_issue_us = (
        1e6 * statistics.median(p) for p in zip(*parts))
    idle = {}
    for way, fn in (('eager', eager_epoch), ('graph', graph_epoch)):
        with device_trace(os.path.join(REPO, 'build', 'chip_smoke_trace',
                                       f'scan_{label}_{way}')) as prof:
            seconds = wall(fn)
        busy = device_summary(prof)[0]
        idle[way] = (seconds, busy, 1 - busy / seconds)
    # what the epoch's data movement costs on the card: the row copy the
    # program makes a partial_fit, and one step's window gather of Xseg
    flat = prog.X.view(T * b, -1)
    copy_ms = cuda_ms(lambda: flat.copy_(X_dev), 5)
    width = cfg.len_max if cfg.rand_size else cfg.len_subset
    gather_ms = gather_mb = 0.0
    if seg >= 2:
        Xseg = Xb[:seg].reshape(seg * b, -1)
        cols = torch.arange(width, device='cuda') + X_dev.shape[1] // 3
        gather_ms = cuda_ms(lambda: Xseg[:, cols], 10)
        gather_mb = 4 * seg * b * width / 1e6
    pool_mb = graph_pool_mb(prog.graph)
    eager_counts = {c for way, c in counts if way == 'eager'}
    graph_counts = {c for way, c in counts if way == 'graph'}
    phase('scan_graph', leg=label, k=cfg.n_components, batch=b, steps=T,
          windowed=cfg.windowed, len_max=cfg.len_max,
          code='fista' if l1 else 'ridge', blocks=blocks, segment=seg,
          segment_ends=ends, epochs=SCAN_EPOCHS, bitwise=bitwise,
          max_abs_diff=','.join(f'{k}:{v:.3e}' for k, v in diffs.items()),
          rel_diff_vs_slicing=','.join(f'{k}:{v:.3e}'
                                       for k, v in rel_sliced.items())
          or None,
          launches_eager='/'.join(map(str, sorted(eager_counts)[0])),
          launches_graph='/'.join(map(str, sorted(graph_counts)[0])),
          launches_expected='/'.join(map(str, want)),
          host_syncs_in_replays=0,
          eager_epoch_s=f'{timed["eager_epoch_s"]:.5f}',
          graph_epoch_s=f'{timed["graph_epoch_s"]:.5f}',
          eager_card_ms=f'{timed["eager_card_ms"]:.4f}',
          graph_card_ms=f'{timed["graph_card_ms"]:.4f}',
          draw_us=f'{draw_us:.1f}', stage_us=f'{stage_us:.1f}',
          replay_us=f'{replay_us:.1f}',
          eager_issue_us=f'{eager_issue_us:.1f}',
          capture_s=f'{prog.capture_s:.4f}', pool_MB=f'{pool_mb:.1f}',
          **{f'{way}_profiled_s': f'{v[0]:.5f}' for way, v in idle.items()},
          **{f'{way}_busy_s': f'{v[1]:.5f}' for way, v in idle.items()},
          **{f'{way}_idle_share': f'{v[2]:.4f}' for way, v in idle.items()},
          rows_copy_ms=f'{copy_ms:.4f}', window_gather_MB=f'{gather_mb:.1f}',
          window_gather_ms=f'{gather_ms:.4f}',
          samples_per_s_eager=f'{T * b / timed["eager_epoch_s"]:.1f}',
          samples_per_s_graph=f'{T * b / timed["graph_epoch_s"]:.1f}',
          leg_s=f'{time.perf_counter() - leg_t0:.2f}')
    if not bitwise:
        raise RuntimeError(f'scan_graph {label}: the captured epochs differ '
                           f'from the eager ones: {diffs}')
    if eager_counts != {want} or graph_counts != {want}:
        raise RuntimeError(f'scan_graph {label}: launches {eager_counts} '
                           f'eager and {graph_counts} captured an epoch, '
                           f'expected {want}')
    if cfg.windowed and not max(rel_sliced.values()) < FIT_RTOL:
        raise RuntimeError(f'scan_graph {label}: the device-start epochs '
                           f'drift from the slicing ones: {rel_sliced}')
    return dict(timed, capture_s=prog.capture_s, pool_mb=pool_mb)


def scan_fit_leg(X, X_test, obj0):
    """``DictFact(**ADHD, n_epochs=SCAN_FIT_EPOCHS).fit``: one capture,
    every epoch through the scan program, the kernels' launches of its
    epochs, and a held-out objective below the initial dictionary's."""
    from modl_tpu_torch.decomposition import _program
    captures, epochs = _program.CAPTURES, _program.EPOCHS
    kw = dict(ADHD, n_epochs=SCAN_FIT_EPOCHS)
    df, seconds, launches, ema = resident_fit(kw, X, True)
    captures = _program.CAPTURES - captures
    epochs = _program.EPOCHS - epochs
    obj = df.score(X_test)
    steps = ADHD_SAMPLES // ADHD['batch_size']
    want = expected_launches(df._cfg, ADHD_SAMPLES, ADHD['batch_size'], 1,
                             SCAN_FIT_EPOCHS, 1)
    phase('scan_graph', leg='adhd70_fit', epochs=SCAN_FIT_EPOCHS,
          captures=captures, program_epochs=epochs,
          bcd_launches=launches, ema_launches=ema,
          expected='/'.join(map(str, want)), objective=f'{obj:.6g}',
          objective_init=f'{obj0:.6g}',
          fit_samples_per_s=f'{SCAN_FIT_EPOCHS * ADHD_SAMPLES / seconds:.1f}',
          epoch_samples_per_s=f'{SCAN_FIT_EPOCHS * ADHD_SAMPLES / df.time_:.1f}')
    if (captures, epochs) != (1, SCAN_FIT_EPOCHS) or len(df._scans) != 1:
        raise RuntimeError(f'scan_graph adhd70_fit: {captures} captures and '
                           f'{epochs} program epochs, expected 1 and '
                           f'{SCAN_FIT_EPOCHS}')
    if (launches, ema) != want or steps * SCAN_FIT_EPOCHS != want[0]:
        raise RuntimeError(f'scan_graph adhd70_fit: launches {launches}/'
                           f'{ema}, expected {want}')
    if not (math.isfinite(obj) and obj < obj0):
        raise RuntimeError(f'scan_graph adhd70_fit: objective {obj} not '
                           f'below the initial {obj0}')
    return launches, ema


def scan_graph_phase(X, X_test=None, obj0=None):
    """Phase scan_graph's ADHD-70 legs: windowed ridge (the bench
    configuration), windowed l1 (FISTA), gather subsets, then the whole
    fit over SCAN_FIT_EPOCHS epochs (given the held-out rows)."""
    kw = {key: v for key, v in ADHD.items() if key != 'subset_sampling'}
    out = {label: scan_graph_leg(label, leg_kw, X) for label, leg_kw in (
        ('adhd70_ridge', ADHD), ('adhd70_l1', dict(ADHD, code_l1_ratio=1.0)),
        ('adhd70_gather', kw))}
    if X_test is not None:
        out['adhd70_fit'] = scan_fit_leg(X, X_test, obj0)
    return out


def ema_case(ema_gemm, k, m, n, seed):
    """The EMA-GEMM kernel against its plain version at one shape, for
    every pi (a 0-d tensor on the card, which the kernel reads there);
    returns (max abs error, kernel ms, plain ms, bound ms,
    what bounds it, ms of the library's ``addmm_``) at pi=0.9."""
    import torch
    from modl_tpu_torch.ops.precision import full_f32
    g = torch.Generator(device='cuda').manual_seed(seed)
    dev = dict(device='cuda', dtype=torch.float32, generator=g)
    B = torch.randn(k, n, **dev)
    SC = torch.randn(m, k, **dev) / math.sqrt(m)
    X = torch.randn(m, n, **dev)
    err = 0.0
    for pi in EMA_PIS:
        # pi on the card, as the captured segment end reads it
        pi_dev = torch.tensor(pi, dtype=torch.float32, device='cuda')
        Bk = ema_gemm.ema_accumulate(B.clone(), SC, X, pi_dev)
        with full_f32():
            Br = ema_gemm.ema_accumulate_reference(B.clone(), SC, X, pi_dev)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(Bk).all()):
            raise RuntimeError(f'EMA-GEMM output not finite at ({k}, {m}, '
                               f'{n}), pi={pi}')
        e = float((Bk - Br).abs().max())
        scale = float(Br.abs().max())
        ok = e <= EMA_RTOL * scale
        # the step's plain path: one addmm_ with beta (fused epilogue)
        with full_f32():
            Bf = B.clone().addmm_(SC.T, X, beta=pi)
        e_fused = float((Bk - Bf).abs().max())
        phase('ema_kernel', shape=f'k{k}xm{m}xn{n}', pi=pi,
              max_abs_err=f'{e:.3e}', rel_err=f'{e / scale:.3e}',
              abs_diff_vs_addmm_beta=f'{e_fused:.3e}', ok=ok)
        if not ok:
            raise RuntimeError(f'EMA-GEMM kernel disagrees with its plain '
                               f'version at ({k}, {m}, {n}), pi={pi}')
        err = max(err, e)
        del Bk, Br, Bf
    reps = 5 if k * m * n > 1e10 else 20
    Bt = B.clone()
    pi_dev = torch.tensor(0.9, dtype=torch.float32, device='cuda')
    ms = cuda_ms(lambda: ema_gemm.ema_accumulate(Bt, SC, X, pi_dev), reps)
    with full_f32():
        plain_ms = cuda_ms(
            lambda: ema_gemm.ema_accumulate_reference(Bt, SC, X, pi_dev),
            reps)
        # one library call computing the same function
        library_ms = cuda_ms(lambda: Bt.addmm_(SC.T, X, beta=0.9), reps)
    gflop = 2.0 * k * m * n / 1e9
    # X and SC read, B read and written
    gbyte = 4.0 * (m * n + m * k + 2 * k * n) / 1e9
    t_bytes, t_ops = gbyte / HBM_BPS * 1e12, gflop / TF32X3_FLOPS * 1e12
    bound_ms = max(t_bytes, t_ops)
    bound_by = 'bytes' if t_bytes >= t_ops else 'operations'
    phase('ema_kernel', shape=f'k{k}xm{m}xn{n}', ms=f'{ms:.4f}',
          plain_ms=f'{plain_ms:.4f}', library_ms=f'{library_ms:.4f}',
          bound_ms=f'{bound_ms:.4f}', bound_by=bound_by,
          kernel_tflops=f'{gflop / ms:.2f}',
          plain_tflops=f'{gflop / plain_ms:.2f}',
          kernel_GBps=f'{gbyte / ms * 1e3:.0f}',
          plain_GBps=f'{gbyte / plain_ms * 1e3:.0f}')
    return err, ms, plain_ms, bound_ms, bound_by, library_ms


def launch_overhead_phase():
    """The launch-overhead probe against its plain version at four
    blocks, then its benchmark; returns (launches of the benchmark,
    max abs error, kernel ms, plain ms, bound ms) for one launch of four
    blocks."""
    import torch
    from modl_tpu_torch.benchmarks import launch_overhead as lo
    D, G = lo.operands(n_blocks=4)
    call = lo.make_call(4)
    Dk = call(D.clone(), G)
    Dr = lo.launch_overhead_reference(D.clone(), G)
    torch.cuda.synchronize()
    err = float((Dk - Dr).abs().max())
    scale = float(Dr.abs().max())
    ok = err <= LAUNCH_RTOL * scale
    Dt = D.clone()
    ms = cuda_ms(lambda: call(Dt, G), 50)
    plain_ms = cuda_ms(lambda: lo.launch_overhead_reference(Dt, G), 50)
    # D and G read, D written
    bound_ms = 4 * (2 * D.numel() + G.numel()) / HBM_BPS * 1e3
    phase('launch_overhead', shape=f'{tuple(D.shape)}',
          max_abs_err=f'{err:.3e}', rel_err=f'{err / scale:.3e}',
          ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
          bound_ms=f'{bound_ms:.4f}', ok=ok)
    if not ok:
        raise RuntimeError('launch-overhead kernel disagrees with its plain '
                           'version')
    del D, G, Dk, Dr, Dt
    lo.LAUNCHES = 0
    steps = lo.main()
    launches = lo.LAUNCHES
    for n_calls, (per_step, per_call) in steps.items():
        phase('launch_overhead', calls_per_step=n_calls,
              ms_per_step=f'{per_step:.4f}', ms_per_call=f'{per_call:.4f}')
    if launches == 0:
        raise RuntimeError('the launch-overhead benchmark launched nothing')
    return launches, err, ms, plain_ms, bound_ms


def expected_launches(cfg, n_frames, batch, n_records, n_epochs, blocks):
    """(BCD kernel launches, segment ends) of a streaming fit: per record
    T full batches in deferred-B segments, plus one step for a ragged
    tail; ``blocks`` BCD launches per step."""
    from modl_tpu_torch.decomposition._step import _deferred_seg
    T = n_frames // batch
    seg = _deferred_seg(cfg, T)
    ends = -(-T // seg) if seg >= 2 else 0
    steps = T + (1 if n_frames % batch else 0)
    runs = n_records * n_epochs
    return steps * blocks * runs, ends * runs


def bcd_blocks(cfg):
    import torch
    from modl_tpu_torch.ops import bcd
    if bcd.supported(cfg.n_components, cfg.len_max, torch.float32):
        return 1
    return -(-cfg.n_components // bcd.max_block(cfg.len_max, torch.float32))


def fmri_fit(records, masker, kw, n_epochs, enabled):
    """One fMRIDictFact fit on the card, the EMA-GEMM gate set to
    ``enabled``; returns (estimator, wall seconds, launches of the BCD and
    EMA-GEMM kernels during the fit)."""
    import torch
    from modl_tpu_torch.decomposition.fmri import fMRIDictFact
    from modl_tpu_torch.ops import bcd, ema_gemm
    with ema_gate(enabled):
        fd = fMRIDictFact(mask=masker, n_epochs=n_epochs, device='cuda',
                          **kw)
        bcd.LAUNCHES = ema_gemm.LAUNCHES = 0
        t0 = time.perf_counter()
        fd.fit(records)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return fd, seconds, bcd.LAUNCHES, ema_gemm.LAUNCHES


def gate_ab(records, masker, kw, n_epochs, rounds, on=(), off=()):
    """The gate's A/B: the given fits with the kernel on and off, then
    ``rounds`` turns of fresh fits on, off, off, on. Returns the phase
    fields: each fit's ``partial_fit`` ms and the medians."""
    ms = {True: [fd.dict_fact_.time_ * 1e3 for fd in on],
          False: [fd.dict_fact_.time_ * 1e3 for fd in off]}
    for _ in range(rounds):
        for enabled in (True, False, False, True):
            fd = fmri_fit(records, masker, kw, n_epochs, enabled)[0]
            ms[enabled].append(fd.dict_fact_.time_ * 1e3)
    med = {enabled: float(np.median(v)) for enabled, v in ms.items()}
    return dict(partial_fit_ms_on='/'.join(f'{t:.2f}' for t in ms[True]),
                partial_fit_ms_off='/'.join(f'{t:.2f}' for t in ms[False]),
                partial_fit_median_ms_on=f'{med[True]:.2f}',
                partial_fit_median_ms_off=f'{med[False]:.2f}',
                gate_on_no_slower=med[True] <= med[False])


def h2d_rates(rec):
    """Host-to-device MB/s of one record: pageable and pinned copies."""
    import torch
    out = []
    for pinned in (False, True):
        host = torch.empty(rec.shape, dtype=getattr(torch, rec.dtype.name),
                           pin_memory=pinned)
        host.numpy()[...] = rec
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = host.to('cuda', non_blocking=pinned)
        torch.cuda.synchronize()
        out.append(rec.nbytes / 1e6 / (time.perf_counter() - t0))
        del dev
    return out


def dict_diff(fd, off):
    """Largest difference between the dictionaries of two fits."""
    return float(np.abs(fd.components_ - off.components_).max())


def check_fmri(label, fd, launches, want, cache_hits, obj, obj_off,
               obj0=None):
    bcd_launches, ema_launches = launches
    want_bcd, want_ema = want
    info = fd.record_cache_info_
    rel = abs(obj - obj_off) / abs(obj_off)
    if (bcd_launches, ema_launches) != (want_bcd, want_ema) \
            or want_ema == 0:
        raise RuntimeError(f'{label}: launched {bcd_launches} BCD and '
                           f'{ema_launches} EMA-GEMM kernels, expected '
                           f'{want_bcd} and {want_ema}')
    if info['hits'] != cache_hits:
        raise RuntimeError(f'{label}: record cache {info}, expected '
                           f'{cache_hits} hits')
    if not bool(np.isfinite(fd.components_).all()):
        raise RuntimeError(f'{label}: dictionary not finite')
    if obj0 is not None and not (math.isfinite(obj) and obj < obj0):
        raise RuntimeError(f'{label}: held-out objective {obj} not below '
                           f'the initial {obj0}')
    if not rel < FIT_RTOL:
        raise RuntimeError(f'{label}: kernel on/off held-out objectives '
                           f'differ: {obj} vs {obj_off} (rel {rel})')
    return rel


def scan_programs(fd, captures, epochs, records):
    """The scan programs of a streaming fit that ran ``captures`` captures
    and ``epochs`` program epochs over ``records`` records of one length:
    one program, one capture, every record an epoch of it. Returns the
    phase fields, with the ms of the row copy its ``partial_fit`` makes
    (a record's full batches into the program's buffer)."""
    import torch
    progs = list(fd.dict_fact_._scans.values())
    if (len(progs), captures, epochs) != (1, 1, records):
        raise RuntimeError(f'{len(progs)} scan programs, {captures} '
                           f'captures and {epochs} program epochs over '
                           f'{records} records of one length, expected 1, '
                           f'1 and {records}')
    flat = progs[0].X.view(-1)
    src = torch.empty_like(flat)
    copy_ms = cuda_ms(lambda: flat.copy_(src), 5)
    return dict(scan_programs=len(progs), captures=captures,
                program_epochs=epochs, rows_copy_ms=f'{copy_ms:.4f}',
                rows_copy_MB=f'{flat.numel() * 4 / 1e6:.1f}')


def adhd_frames(n_records):
    """bench.py's planted streaming frames: ``n_records`` records of
    FMRI_ADHD_FRAMES x N_FEATURES, float32 (seed 0)."""
    rng = np.random.RandomState(0)
    k = FMRI_ADHD['n_components']
    V = rng.randn(k, N_FEATURES).astype(np.float32) / 30
    return [rng.randn(FMRI_ADHD_FRAMES, k).astype(np.float32) @ V
            + 0.1 * rng.randn(FMRI_ADHD_FRAMES, N_FEATURES).astype(
                np.float32) for _ in range(n_records)]


def fmri_adhd70(workdir):
    """bench.py's streaming fMRI leg at full width, float32 and float16
    records; returns the float32 run's EMA-GEMM launches."""
    from modl_tpu_torch.decomposition import _program
    from modl_tpu_torch.decomposition.fmri import fMRIDictFact
    from modl_tpu_torch.input_data.fmri import (create_raw_rest_data,
                                                get_raw_rest_data)
    recs = adhd_frames(FMRI_RECORDS + 1)
    pageable, pinned = h2d_rates(recs[0])
    mask = np.ones((N_FEATURES, 1, 1), bool)
    n_samples = FMRI_RECORDS * FMRI_ADHD_FRAMES
    ema_launches = None
    for tag, dtype in (('f32', np.float32), ('f16', np.float16)):
        d = os.path.join(workdir, f'adhd_{tag}')
        create_raw_rest_data(recs, mask, d, standardize=False,
                             detrend=False, feature_order=0, dtype=dtype)
        masker, records = get_raw_rest_data(d)
        # cleaned at fit time, on the device
        masker.standardize = masker.detrend = True
        train, test = records[:FMRI_RECORDS], records[FMRI_RECORDS:]
        init = fMRIDictFact(mask=masker, n_epochs=0, device='cuda',
                            **FMRI_ADHD).fit(train)
        obj0 = init.score(test)
        fmri_fit(train, masker, FMRI_ADHD, 1, True)          # warm-up
        fd1, dt1, _, _ = fmri_fit(train, masker, FMRI_ADHD, 1, True)
        # the driver's streaming time (record waits + cleaning and steps,
        # each ending in a device sync) at every record start, read by
        # its callback (verbose makes it fire; the prints are dropped)
        marks = []
        kw = dict(FMRI_ADHD, verbose=3 * FMRI_RECORDS + 1,
                  callback=lambda m, d, cpu_t, io_t: marks.append(
                      (d.n_iter_, cpu_t + io_t)))
        captures, epochs = _program.CAPTURES, _program.EPOCHS
        with contextlib.redirect_stdout(io.StringIO()):
            fd, _, *launches = fmri_fit(train, masker, kw, 3, True)
        scans = scan_programs(fd, _program.CAPTURES - captures,
                              _program.EPOCHS - epochs, 3 * FMRI_RECORDS)
        total = fd.io_time_ + fd.cpu_time_
        first = dict(marks)[n_samples]     # end of the first epoch
        steady = total - first             # epochs 2-3, from the cache
        obj = fd.score(test)
        cfg = fd.dict_fact_._cfg
        want = expected_launches(cfg, FMRI_ADHD_FRAMES,
                                 FMRI_ADHD['batch_size'], FMRI_RECORDS, 3,
                                 bcd_blocks(cfg))
        off, _, _, off_ema = fmri_fit(train, masker, FMRI_ADHD, 3, False)
        # fd runs the per-record callback: the A/B takes fresh fits
        ab = gate_ab(train, masker, FMRI_ADHD, 3, AB_ROUNDS_ADHD,
                     off=(off,))
        obj_off = off.score(test)
        rel = check_fmri(f'fmri_adhd70 {tag}', fd, launches, want,
                         2 * FMRI_RECORDS, obj, obj_off, obj0)
        if off_ema != 0:
            raise RuntimeError('the EMA-GEMM kernel ran with ENABLED off')
        phase('fmri_adhd70', records=tag, windowed=cfg.windowed,
              bcd_launches=launches[0], ema_launches=launches[1],
              segment_ends=want[1], steps=want[0],
              cache=fd.record_cache_info_['hits'],
              objective=f'{obj:.6g}', objective_init=f'{obj0:.6g}',
              objective_kernel_off=f'{obj_off:.6g}', rel_diff=f'{rel:.3e}',
              dict_max_abs_diff=f'{dict_diff(fd, off):.3e}',
              fit_samples_per_s=f'{n_samples / dt1:.1f}',
              first_epoch_samples_per_s=f'{n_samples / first:.1f}',
              steady_epoch_samples_per_s=f'{2 * n_samples / steady:.1f}',
              compute_samples_per_s=(
                  f'{3 * n_samples / fd.dict_fact_.time_:.1f}'),
              compute_samples_per_s_kernel_off=(
                  f'{3 * n_samples / off.dict_fact_.time_:.1f}'),
              **ab, **scans, io_s=f'{fd1.io_time_:.4f}',
              cpu_s=f'{fd1.cpu_time_:.4f}',
              h2d_pageable_MBps=f'{pageable:.1f}',
              h2d_pinned_MBps=f'{pinned:.1f}')
        if ema_launches is None:
            ema_launches = launches[1]
        shutil.rmtree(d, ignore_errors=True)
    return ema_launches


def fmri_hcp1024(workdir, X0):
    """exps/hcp/decompose_hcp.py's configuration at full width on two
    Gaussian records (the first is phase 7's data)."""
    from modl_tpu_torch.decomposition import _program
    from modl_tpu_torch.input_data.fmri import (create_raw_rest_data,
                                                get_raw_rest_data)
    recs = [X0] + [np.random.RandomState(seed).randn(n, N_FEATURES).astype(
        np.float32) for seed, n in ((1, HCP_SAMPLES), (2, 200))]
    d = os.path.join(workdir, 'hcp')
    create_raw_rest_data(recs, np.ones((N_FEATURES, 1, 1), bool), d,
                         standardize=False, detrend=False, feature_order=0)
    del recs
    masker, records = get_raw_rest_data(d)
    train, test = records[:FMRI_RECORDS], records[FMRI_RECORDS:]
    captures, epochs = _program.CAPTURES, _program.EPOCHS
    fd, seconds, *launches = fmri_fit(train, masker, FMRI_HCP, 2, True)
    scans = scan_programs(fd, _program.CAPTURES - captures,
                          _program.EPOCHS - epochs, 2 * FMRI_RECORDS)
    obj = fd.score(test)
    cfg = fd.dict_fact_._cfg
    blocks = bcd_blocks(cfg)
    want = expected_launches(cfg, HCP_SAMPLES, FMRI_HCP['batch_size'],
                             FMRI_RECORDS, 2, blocks)
    off, off_seconds, _, _ = fmri_fit(train, masker, FMRI_HCP, 2, False)
    # the A/B of the fits already made (no further rounds: each HCP-1024
    # fit is ~15 s of host set-up, and the kernel's ~15 ms a segment end
    # stands out in one pair)
    ab = gate_ab(train, masker, FMRI_HCP, 2, 0, on=(fd,), off=(off,))
    obj_off = off.score(test)
    rel = check_fmri('fmri_hcp1024', fd, launches, want, FMRI_RECORDS, obj,
                     obj_off)
    if blocks < 2:
        raise RuntimeError('fmri_hcp1024 did not go through the block driver')
    n = 2 * FMRI_RECORDS * HCP_SAMPLES
    phase('fmri_hcp1024', windowed=cfg.windowed, bcd_launches=launches[0],
          blocks_per_step=blocks, ema_launches=launches[1],
          segment_ends=want[1], cache=fd.record_cache_info_['hits'],
          objective=f'{obj:.6g}', objective_kernel_off=f'{obj_off:.6g}',
          rel_diff=f'{rel:.3e}', dict_max_abs_diff=f'{dict_diff(fd, off):.3e}',
          fit_samples_per_s=f'{n / seconds:.1f}',
          fit_samples_per_s_kernel_off=f'{n / off_seconds:.1f}',
          compute_samples_per_s=f'{n / fd.dict_fact_.time_:.1f}',
          compute_samples_per_s_kernel_off=(
              f'{n / off.dict_fact_.time_:.1f}'),
          **ab, **scans, io_s=f'{fd.io_time_:.4f}',
          cpu_s=f'{fd.cpu_time_:.4f}')
    shutil.rmtree(d, ignore_errors=True)


def mni_mask():
    """A fixed mask of N_FEATURES voxels on the MNI152 3 mm grid: the
    voxels nearest its centre in the grid's scaled distance (an
    ellipsoid; ties in C order)."""
    grid = np.indices(MNI_3MM, dtype=np.float64)
    centre = (np.array(MNI_3MM) - 1) / 2
    dist = sum(((g - c) / n) ** 2 for g, c, n in zip(grid, centre, MNI_3MM))
    mask = np.zeros(int(np.prod(MNI_3MM)), bool)
    mask[np.argsort(dist.ravel(), kind='stable')[:N_FEATURES]] = True
    return mask.reshape(MNI_3MM)


@contextlib.contextmanager
def nifti_standins():
    """In-process stand-ins, on numpy, for the surface of nibabel and
    nilearn that the port's NIfTI branches touch (the card's machine has
    neither package): ``nibabel.Nifti1Image``,
    ``nilearn._utils.check_niimg`` and
    ``nilearn.input_data.MultiNiftiMasker`` (mask in C order, no
    cleaning; float32 images give float32 rows, others float64, as
    nilearn hands back floats). The port's ``HAS_NILEARN`` is set and its
    ``MultiNiftiMasker`` left to be imported at first use; the modules
    and flags are restored after."""
    import types

    from modl_tpu_torch.base import BaseEstimator
    from modl_tpu_torch.input_data.fmri import base

    class Nifti1Image:
        def __init__(self, dataobj, affine, header=None):
            self.dataobj = dataobj
            self.affine = affine
            self.header = dict(header or {})

        @property
        def shape(self):
            return self.dataobj.shape

        def get_data_dtype(self):
            return self.dataobj.dtype

        def to_filename(self, filename):
            self.header['vox_offset'] = 352.0    # nibabel may update it
            with open(filename, 'wb') as f:
                np.save(f, np.asarray(self.dataobj))

    def check_niimg(img):
        if isinstance(img, Nifti1Image):
            return img
        return Nifti1Image(np.load(img, mmap_mode='r'), np.eye(4))

    class MultiNiftiMasker(BaseEstimator):
        def __init__(self, mask_img=None, smoothing_fwhm=None,
                     standardize=False, detrend=False, low_pass=None,
                     high_pass=None, t_r=None, target_affine=None,
                     target_shape=None, mask_strategy='background',
                     mask_args=None, memory=None, memory_level=1, n_jobs=1,
                     verbose=0):
            for name, value in list(locals().items()):
                if name != 'self':
                    setattr(self, name, value)

        def fit(self, imgs=None, y=None):
            self.mask_img_ = check_niimg(self.mask_img)
            self._mask = np.asarray(self.mask_img_.dataobj) != 0
            return self

        def transform_single_imgs(self, imgs, confounds=None):
            if self.standardize or self.detrend or confounds is not None:
                raise NotImplementedError('the stand-in masker does not '
                                          'clean')
            out = np.asarray(check_niimg(imgs).dataobj)[self._mask].T
            return np.ascontiguousarray(
                out, np.float32 if out.dtype == np.float32 else np.float64)

        def transform(self, imgs, confounds=None):
            if isinstance(imgs, (list, tuple)):
                return [self.transform_single_imgs(img) for img in imgs]
            return self.transform_single_imgs(imgs, confounds)

        def inverse_transform(self, X):
            if not isinstance(X, np.ndarray):
                raise TypeError(f'inverse_transform got {type(X)}')
            vol = np.zeros(self._mask.shape + (X.shape[0],), X.dtype)
            vol[self._mask] = X.T
            return Nifti1Image(vol, self.mask_img_.affine)

    nibabel = types.ModuleType('nibabel')
    nibabel.Nifti1Image = Nifti1Image
    nilearn = types.ModuleType('nilearn')
    nilearn._utils = types.ModuleType('nilearn._utils')
    nilearn._utils.check_niimg = check_niimg
    nilearn.input_data = types.ModuleType('nilearn.input_data')
    nilearn.input_data.MultiNiftiMasker = MultiNiftiMasker
    modules = {'nibabel': nibabel, 'nilearn': nilearn,
               'nilearn._utils': nilearn._utils,
               'nilearn.input_data': nilearn.input_data}
    saved = ({name: sys.modules.get(name) for name in modules},
             base.HAS_NILEARN, base.MultiNiftiMasker)
    sys.modules.update(modules)
    base.HAS_NILEARN, base.MultiNiftiMasker = True, None
    try:
        yield types.SimpleNamespace(Nifti1Image=Nifti1Image,
                                    MultiNiftiMasker=MultiNiftiMasker)
    finally:
        for name, module in saved[0].items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
        base.HAS_NILEARN, base.MultiNiftiMasker = saved[1:]


def streaming_rate(fd):
    """Samples/s of a streaming fit's epochs (io_time_ + cpu_time_)."""
    return fd.dict_fact_.n_iter_ / (fd.io_time_ + fd.cpu_time_)


def nifti_phase(workdir):
    """fMRIDictFact on records and mask given as NIfTI images (stand-ins)
    on the MNI152 3 mm grid, against the .npy route of the same frames;
    then the same records as int16. Returns the BCD and EMA-GEMM launches
    of the float32 NIfTI fit."""
    from modl_tpu_torch.decomposition.fmri import fMRIDictFact
    from modl_tpu_torch.input_data.fmri import (create_raw_rest_data,
                                                get_raw_rest_data,
                                                safe_to_filename)
    mask = mni_mask()
    vols = []
    for rec in adhd_frames(FMRI_RECORDS + 1):
        vol = np.zeros(MNI_3MM + (FMRI_ADHD_FRAMES,), np.float32)
        vol[mask] = rec.T
        vols.append(vol)
    # the control: the same frames through create_raw_rest_data (no voxel
    # order, as a NIfTI masker has none: both fits draw gather subsets)
    d = os.path.join(workdir, 'nifti_control')
    create_raw_rest_data(vols[:FMRI_RECORDS], mask, d, standardize=False,
                         detrend=False)
    masker, records = get_raw_rest_data(d)
    ctl, ctl_s, *ctl_launches = fmri_fit(records, masker, FMRI_NIFTI,
                                         NIFTI_EPOCHS, True)
    k = FMRI_NIFTI['n_components']
    with nifti_standins() as ni:
        affine = np.diag([-3.0, 3.0, 3.0, 1.0])
        mask_img = ni.Nifti1Image(mask.astype(np.uint8), affine)
        imgs = [ni.Nifti1Image(v, affine) for v in vols]
        train, test = imgs[:FMRI_RECORDS], imgs[FMRI_RECORDS:]
        fd, seconds, *launches = fmri_fit(train, mask_img, FMRI_NIFTI,
                                          NIFTI_EPOCHS, True)
        cfg = fd.dict_fact_._cfg
        want = expected_launches(cfg, FMRI_ADHD_FRAMES,
                                 FMRI_NIFTI['batch_size'], FMRI_RECORDS,
                                 NIFTI_EPOCHS, bcd_blocks(cfg))
        D, D_ctl = fd.components_, ctl.components_
        rel = float(np.abs(D - D_ctl).max() / np.abs(D_ctl).max())
        n_voxels = fMRIDictFact._count_voxels(fd.masker_)
        img = fd.components_img_
        vol = np.asarray(img.dataobj)
        img_ok = (vol.shape == MNI_3MM + (k,)
                  and np.array_equal(vol[mask], D.T))
        header = dict(img.header)
        path = os.path.join(workdir, 'components.nii')
        safe_to_filename(img, path)
        saved_ok = img.header == header and np.array_equal(np.load(path),
                                                           vol)
        obj = fd.score(test)
        obj0 = fMRIDictFact(mask=mask_img, n_epochs=0, device='cuda',
                            **FMRI_NIFTI).fit(train).score(test)
        # scanner-style int16 records of the same frames
        imgs16 = [ni.Nifti1Image(np.round(v * 1000).astype(np.int16),
                                 affine) for v in vols]
        del vols, imgs
        init16 = fMRIDictFact(mask=mask_img, n_epochs=0, device='cuda',
                              **FMRI_NIFTI).fit(imgs16[:FMRI_RECORDS])
        obj0_16 = init16.score(imgs16[FMRI_RECORDS:])
        fd16, seconds16, *launches16 = fmri_fit(
            imgs16[:FMRI_RECORDS], mask_img, FMRI_NIFTI, NIFTI_EPOCHS, True)
        obj16 = fd16.score(imgs16[FMRI_RECORDS:])
        state16 = str(fd16.dict_fact_._state.D.dtype)
        masker_class = type(fd.masker_)
    n = FMRI_RECORDS * FMRI_ADHD_FRAMES
    phase('nifti', standins='nibabel.Nifti1Image,nilearn._utils.'
          'check_niimg,nilearn.input_data.MultiNiftiMasker',
          grid='x'.join(map(str, MNI_3MM)), voxels=n_voxels,
          masker=masker_class.__name__, windowed=cfg.windowed,
          bcd_launches=launches[0], ema_launches=launches[1],
          bcd_launches_npy=ctl_launches[0], ema_launches_npy=ctl_launches[1],
          steps=want[0], rel_diff_npy=f'{rel:.3e}',
          bitwise_npy=bool(np.array_equal(D, D_ctl)),
          components_img=img_ok, safe_to_filename_unchanged=saved_ok,
          objective=f'{obj:.6g}', objective_init=f'{obj0:.6g}',
          epoch_samples_per_s=f'{streaming_rate(fd):.1f}',
          epoch_samples_per_s_npy=(
              f'{streaming_rate(ctl):.1f}'),
          fit_samples_per_s=f'{NIFTI_EPOCHS * n / seconds:.1f}',
          fit_samples_per_s_npy=f'{NIFTI_EPOCHS * n / ctl_s:.1f}',
          io_s=f'{fd.io_time_:.4f}', cpu_s=f'{fd.cpu_time_:.4f}',
          io_s_npy=f'{ctl.io_time_:.4f}', cpu_s_npy=f'{ctl.cpu_time_:.4f}',
          int16_state=state16, int16_bcd_launches=launches16[0],
          int16_objective=f'{obj16:.6g}',
          int16_objective_init=f'{obj0_16:.6g}',
          int16_epoch_samples_per_s=(
              f'{streaming_rate(fd16):.1f}'),
          int16_io_s=f'{fd16.io_time_:.4f}',
          int16_cpu_s=f'{fd16.cpu_time_:.4f}')
    if masker_class.__name__ != 'MultiNiftiMasker':
        raise RuntimeError(f'nifti: the fit took a {masker_class} masker')
    if not rel <= NIFTI_RTOL:
        raise RuntimeError(f'nifti: components differ from the .npy '
                           f'route by {rel} of max |D|')
    if tuple(launches) != tuple(ctl_launches) or launches[0] != want[0] \
            or tuple(launches16) != tuple(launches):
        raise RuntimeError(f'nifti: launched {launches} (int16 '
                           f'{launches16}), the .npy route {ctl_launches}, '
                           f'expected {want[0]} BCD launches')
    if n_voxels != N_FEATURES:
        raise RuntimeError(f'nifti: counted {n_voxels} voxels')
    if not (img_ok and saved_ok):
        raise RuntimeError(f'nifti: components_img_ {img_ok}, '
                           f'safe_to_filename {saved_ok}')
    if not (math.isfinite(obj) and obj < obj0):
        raise RuntimeError(f'nifti: held-out objective {obj} not below the '
                           f'initial {obj0}')
    if state16 != 'torch.float32' or not (math.isfinite(obj16)
                                          and obj16 < obj0_16):
        raise RuntimeError(f'nifti: int16 records ran {state16} state, '
                           f'objective {obj16} (initial {obj0_16})')
    shutil.rmtree(d, ignore_errors=True)
    return tuple(launches)


def recsys_union(X):
    """(n,) float mask on the card: the union of the supports of the
    first batch of the fit's first epoch (its seed's draws: the initial
    dictionary, then the epoch's permutation)."""
    import torch
    from modl_tpu_torch.benchmarks.workloads import RECSYS, recsys_batch
    n_samples, n_features = X.shape
    rng = np.random.RandomState(RECSYS['random_state'])
    rng.randn(RECSYS['n_components'], n_features)
    rows = rng.permutation(n_samples)[:recsys_batch(X)]
    union = np.zeros(n_features, np.float32)
    union[np.concatenate([X.indices[X.indptr[r]:X.indptr[r + 1]]
                          for r in rows])] = 1.0
    return torch.as_tensor(union, device='cuda')


def bias_only_rmse(est, X):
    """Test RMSE of the fit's own row and column biases (cropped)."""
    import scipy.sparse as sp
    from modl_tpu_torch.benchmarks.workloads import RECSYS
    from modl_tpu_torch.decomposition.recsys import rmse
    rows = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))
    pred = np.clip(est.row_mean_[rows] + est.col_mean_[X.indices],
                   *RECSYS['crop'])
    return rmse(X, sp.csr_matrix((pred, X.indices, X.indptr),
                                 shape=X.shape))


def recsys_ml10m(X_tr, X_te):
    """bench.py's recsys configuration through RecsysDictFact.fit; returns
    the BCD launches of the two-epoch fit."""
    from modl_tpu_torch import RecsysDictFact
    from modl_tpu_torch.benchmarks.workloads import (RECSYS, RECSYS_EPOCHS,
                                                     recsys_batch)
    from modl_tpu_torch.decomposition.recsys import compute_biases
    from modl_tpu_torch.ops import bcd

    # bench.py's bias-only RMSE: the test entries less their own biases
    Xc = X_te.copy()
    compute_biases(Xc, beta=RECSYS['beta'], inplace=True)
    bench_bias_rmse = float(np.sqrt(np.mean(Xc.data ** 2)))
    del Xc
    one = RecsysDictFact(**RECSYS, n_epochs=1, device='cuda')
    one_seconds = timed_fit(one, X_tr)       # also the warm-up
    rmse_1 = one.score(X_te)
    bcd.LAUNCHES = 0
    est = RecsysDictFact(**RECSYS, n_epochs=RECSYS_EPOCHS, device='cuda')
    seconds = timed_fit(est, X_tr)
    launches = bcd.LAUNCHES
    rmse_2 = est.score(X_te)
    bcd.LAUNCHES = 0
    plain = RecsysDictFact(**RECSYS, n_epochs=1, device='cuda')
    with plain_bcd():
        plain_seconds = timed_fit(plain, X_tr)
    plain_launches = bcd.LAUNCHES
    rmse_plain = plain.score(X_te)
    bias_rmse = bias_only_rmse(est, X_te)
    n_samples, n_features = X_tr.shape
    batch = recsys_batch(X_tr)
    n_batches = -(-n_samples // batch)
    rel = abs(rmse_1 - rmse_plain) / rmse_plain
    phase('recsys_ml10m', rows=n_samples, items=n_features,
          train_ratings=X_tr.nnz, test_ratings=X_te.nnz, batch=batch,
          batches_per_epoch=n_batches, bcd_launches=launches,
          bcd_launches_kernel_off=plain_launches,
          use_kernel=est.use_kernel_,
          resident=est.resident_width_ is not None,
          width=est.resident_width_,
          test_rmse_epoch1=f'{rmse_1:.6f}', test_rmse_epoch2=f'{rmse_2:.6f}',
          test_rmse_kernel_off_epoch1=f'{rmse_plain:.6f}',
          rel_diff=f'{rel:.3e}', bias_only_rmse=f'{bias_rmse:.6f}',
          bench_bias_only_rmse=f'{bench_bias_rmse:.6f}',
          epoch_ratings_per_s=f'{RECSYS_EPOCHS * X_tr.nnz / est.time_:.1f}',
          epoch_rows_per_s=f'{RECSYS_EPOCHS * n_samples / est.time_:.1f}',
          epoch_s=f'{est.time_ / RECSYS_EPOCHS:.4f}',
          epoch_s_kernel_off=f'{plain.time_:.4f}',
          fit_s=f'{seconds:.4f}', fit_s_one_epoch=f'{one_seconds:.4f}',
          fit_s_kernel_off=f'{plain_seconds:.4f}')
    if not (est.use_kernel_ and one.use_kernel_ and plain.use_kernel_):
        raise RuntimeError('recsys_ml10m: a fit on the card did not take '
                           'the kernel route')
    if launches != RECSYS_EPOCHS * n_batches or plain_launches != 0:
        raise RuntimeError(f'recsys_ml10m: {launches} BCD launches '
                           f'({plain_launches} with the kernel off), '
                           f'expected {RECSYS_EPOCHS * n_batches} and 0')
    if not (math.isfinite(rmse_2) and rmse_2 < min(bias_rmse,
                                                   bench_bias_rmse)):
        raise RuntimeError(f'recsys_ml10m: test RMSE {rmse_2} not below '
                           f'the bias-only {bias_rmse} and '
                           f'{bench_bias_rmse}')
    if not rel < FIT_RTOL:
        raise RuntimeError(f'recsys_ml10m: kernel and plain fits differ: '
                           f'RMSE {rmse_1} vs {rmse_plain} (rel {rel})')
    return launches


@contextlib.contextmanager
def recsys_replays_without_host_reads():
    """Every replay of a ``RecsysProgram`` (a run after its capture) under
    ``torch.cuda.set_sync_debug_mode('error')``: a replay that waits for
    the card raises. Yields the list of the replays' counts."""
    import torch
    from modl_tpu_torch.decomposition import _program
    saved = _program.RecsysProgram.run
    replays = [0]

    def guarded(self):
        if self.graph is None:
            return saved(self)
        torch.cuda.set_sync_debug_mode('error')
        try:
            return saved(self)
        finally:
            torch.cuda.set_sync_debug_mode('default')
            replays[0] += 1

    _program.RecsysProgram.run = guarded
    try:
        yield replays
    finally:
        _program.RecsysProgram.run = saved


def recsys_graph_phase(X):
    """Phase recsys_graph: ``RecsysDictFact``'s batches as programs
    (``_program.RecsysProgram``: a window of 32 batches one graph, every
    other batch a one-batch graph of its size) at phase 10's ML-10M
    configuration, against the same batches run eagerly. From one fit's
    set-up (``_start``, the same seed each way), RECSYS_GRAPH_EPOCHS
    epochs of ``recsys_epoch`` each way: every leaf (D, C, B, comp_norm,
    feature_n_iter, the batches' codes) and ``n_iter`` bitwise equal
    after each epoch, one BCD launch a batch each way, the programs'
    captures and runs, every replay under ``set_sync_debug_mode
    ('error')``; the first RECSYS_EPOCHS epochs are the fit with the
    programs off. The wall seconds of an epoch each way (medians over the
    epochs after the fit's), the card's ms a window (CUDA events over
    replays), the host us to draw, stage and replay a window (the card
    idle), the idle share of one profiled epoch each way, the captures'
    seconds and pools' MB, and a batch's Cholesky, triangular solves and
    the batched ``torch.cholesky_solve`` they replace, in ms. Then
    ``RecsysDictFact(n_epochs=RECSYS_EPOCHS).fit``, which runs through the
    programs: its dictionary, C and B bitwise equal to the eager epochs',
    its codes to their refit, each window one replay. Returns the fit's
    BCD launches."""
    import statistics

    import torch
    from modl_tpu_torch import RecsysDictFact
    from modl_tpu_torch.benchmarks.workloads import RECSYS, RECSYS_EPOCHS
    from modl_tpu_torch.decomposition import _program, recsys
    from modl_tpu_torch.decomposition._step import DrawStaging
    from modl_tpu_torch.ops import bcd
    from modl_tpu_torch.utils.profiling import device_busy_s, device_trace
    leg_t0 = time.perf_counter()
    parts_s = {}
    ways = {}
    for way in ('eager', 'graph'):
        est = RecsysDictFact(**RECSYS, device='cuda')
        state, cfg, csr, resident, b = est._start(X)
        ways[way] = dict(est=est, state=state, cfg=cfg, csr=csr,
                         resident=resident, b=b,
                         programs=None if way == 'eager' else {},
                         staging=DrawStaging('cuda'))
    g = ways['graph']
    parts_s['setup'] = time.perf_counter() - leg_t0
    b, n_samples = g['b'], X.shape[0]
    n_batches = -(-n_samples // b)
    n_windows = (n_samples // b) // recsys.WINDOW
    singles = n_samples // b - n_windows * recsys.WINDOW
    tail = n_samples % b
    if not _program.capturable_recsys(g['cfg'], g['resident'] is not None):
        raise RuntimeError('recsys_graph: the fit does not run as programs')

    def epoch(way):
        w = ways[way]
        recsys.recsys_epoch(w['state'], w['cfg'], w['resident'],
                            w['est'].random_state, w['b'], w['programs'],
                            w['staging'])

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    names = ('D', 'C', 'B', 'comp_norm', 'feature_n_iter', 'code')
    diffs, counts, walls = {}, set(), {'eager': [], 'graph': []}
    captures0 = _program.CAPTURES
    fit_leaves = None
    with recsys_replays_without_host_reads() as replays:
        for e in range(RECSYS_GRAPH_EPOCHS):
            for way in ('eager', 'graph'):
                bcd.LAUNCHES = 0
                walls[way].append(wall(lambda: epoch(way)))
                counts.add((way, bcd.LAUNCHES))
            ge, gg = ways['eager']['state'], ways['graph']['state']
            for name in names:
                a, r = getattr(gg, name), getattr(ge, name)
                d = float((a.double() - r.double()).abs().max())
                diffs[name] = max(diffs.get(name, 0.0), d)
            if ge.n_iter != gg.n_iter:
                diffs['n_iter'] = abs(ge.n_iter - gg.n_iter)
            if e == RECSYS_EPOCHS - 1:
                # what the fit with the programs off ends with
                fit_leaves = {name: getattr(ge, name).clone()
                              for name in ('D', 'C', 'B')}
                w = ways['eager']
                fit_leaves['code'] = w['est']._refit_device(
                    ge.D, w['csr'], w['resident'])
                fit_n_iter = ge.n_iter
    captures = _program.CAPTURES - captures0
    parts_s['epochs'] = sum(walls['eager']) + sum(walls['graph'])
    t_timed = time.perf_counter()
    bitwise = all(d == 0 for d in diffs.values())
    programs = g['programs']
    keys = sorted(programs)
    want_keys = sorted({(recsys.WINDOW, b), (1, b)}
                       | ({(1, tail)} if tail else set()))
    want_runs = {(recsys.WINDOW, b): n_windows, (1, b): singles,
                 (1, tail): 1}
    runs_ok = all(programs[key].runs == RECSYS_GRAPH_EPOCHS * want_runs[key]
                  for key in keys)
    eager_counts = {c for way, c in counts if way == 'eager'}
    graph_counts = {c for way, c in counts if way == 'graph'}

    # timings: the window program's replays on the card and on the host
    prog = programs[(recsys.WINDOW, b)]
    window_ms = cuda_ms(prog.run, 5)
    st, cfg, rs = g['state'], g['cfg'], g['est'].random_state
    k = st.D.shape[0]

    perm = rs.permutation(n_samples)     # an epoch's, drawn once an epoch

    def host_parts():
        """The host's seconds of a window's draws (its rows from the
        epoch's permutation, its atom orders), staging and replay."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows_w = np.stack([perm[t * b:(t + 1) * b]
                           for t in range(recsys.WINDOW)])
        orders_w = np.stack([rs.permutation(k)
                             for _ in range(recsys.WINDOW)])
        t1 = time.perf_counter()
        prog.stage([(r, o, recsys.batch_scalars(st, cfg, b))
                    for r, o in zip(rows_w, orders_w)])
        t2 = time.perf_counter()
        prog.run()
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        return t1 - t0, t2 - t1, t3 - t2

    draw_us, stage_us, replay_us = (
        1e6 * statistics.median(p)
        for p in zip(*[host_parts() for _ in range(5)]))
    idle = {}
    for way in ('eager', 'graph'):
        with device_trace(os.path.join(REPO, 'build', 'chip_smoke_trace',
                                       f'recsys_{way}')) as prof:
            seconds = wall(lambda: epoch(way))
        busy = device_busy_s(prof)
        idle[way] = (seconds, busy, 1 - busy / seconds)
    # one batch's solves at the fit's shape, on a real batch's Grams
    idx, val, lens = recsys._batch_rows(g['resident'],
                                        torch.arange(b, device='cuda'), None)
    Dg = torch.cat([st.D.T, st.D.new_zeros((1, k))])[idx.long()]
    G = (torch.einsum('bpk,bpq->bkq', Dg, Dg)
         + torch.eye(k, device='cuda'))
    rhs = torch.einsum('bpk,bp->bk', Dg, val)
    L = torch.linalg.cholesky_ex(G).L
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    solve_ms = dict(
        cholesky_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(G), 20),
        trsm_lower_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
            L, rhs[..., None], upper=False), 20),
        trsm_upper_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
            L.mT, y, upper=True), 20),
        cholesky_solve_ms=cuda_ms(lambda: torch.cholesky_solve(
            rhs[..., None], L), 20))
    pools = {key: graph_pool_mb(programs[key].graph) for key in keys}
    timed = dict(eager_epoch_s=statistics.median(
                     walls['eager'][RECSYS_EPOCHS:]),
                 graph_epoch_s=statistics.median(
                     walls['graph'][RECSYS_EPOCHS:]))
    del ways, g, st, prog, Dg, G, L, y, idx, val, lens
    parts_s['timed'] = time.perf_counter() - t_timed

    # the fit through the programs against the eager epochs' state
    t_fit = time.perf_counter()
    captures0, batches0 = _program.CAPTURES, recsys.BATCHES
    bcd.LAUNCHES = 0
    with recsys_replays_without_host_reads() as fit_replays:
        fit = RecsysDictFact(**RECSYS, n_epochs=RECSYS_EPOCHS,
                             device='cuda').fit(X)
    torch.cuda.synchronize()
    fit_launches, fit_captures = bcd.LAUNCHES, _program.CAPTURES - captures0
    fit_batches = recsys.BATCHES - batches0
    fit_diffs = {name: float((getattr(fit, f'_{name}').double()
                              - fit_leaves[name].double()).abs().max())
                 for name in ('D', 'C', 'B', 'code')}
    fit_runs = {key: p.runs for key, p in fit._programs.items()}
    parts_s['fit'] = time.perf_counter() - t_fit
    fit_ok = (all(d == 0 for d in fit_diffs.values())
              and fit.n_iter_ == fit_n_iter
              and fit_launches == fit_batches == RECSYS_EPOCHS * n_batches
              and fit_captures == len(want_keys)
              and fit_runs == {key: RECSYS_EPOCHS * want_runs[key]
                               for key in want_keys})
    phase('recsys_graph', rows=n_samples, batch=b, batches=n_batches,
          windows=n_windows, singles=singles, tail=tail,
          epochs=RECSYS_GRAPH_EPOCHS, bitwise=bitwise,
          max_abs_diff=','.join(f'{k_}:{v:.3e}' for k_, v in diffs.items()),
          launches_eager=','.join(map(str, sorted(eager_counts))),
          launches_graph=','.join(map(str, sorted(graph_counts))),
          captures=captures,
          programs=','.join(f'{t}x{b_}' for t, b_ in keys),
          runs=','.join(str(programs[key].runs) for key in keys),
          replays_guarded=replays[0], host_syncs_in_replays=0,
          eager_epoch_s=f'{timed["eager_epoch_s"]:.4f}',
          graph_epoch_s=f'{timed["graph_epoch_s"]:.4f}',
          eager_epochs_s=','.join(f'{t:.4f}' for t in walls['eager']),
          graph_epochs_s=','.join(f'{t:.4f}' for t in walls['graph']),
          window_card_ms=f'{window_ms:.4f}',
          draw_us=f'{draw_us:.1f}', stage_us=f'{stage_us:.1f}',
          replay_us=f'{replay_us:.1f}',
          **{f'{way}_profiled_s': f'{v[0]:.4f}' for way, v in idle.items()},
          **{f'{way}_busy_s': f'{v[1]:.4f}' for way, v in idle.items()},
          **{f'{way}_idle_share': f'{v[2]:.4f}' for way, v in idle.items()},
          capture_s=','.join(f'{programs[key].capture_s:.4f}'
                             for key in keys),
          pool_MB=','.join(f'{pools[key]:.1f}' for key in keys),
          **{key: f'{v:.4f}' for key, v in solve_ms.items()},
          fit_bitwise=all(d == 0 for d in fit_diffs.values()),
          fit_max_abs_diff=','.join(f'{k_}:{v:.3e}'
                                    for k_, v in fit_diffs.items()),
          fit_launches=fit_launches, fit_batches=fit_batches,
          fit_captures=fit_captures, fit_replays_guarded=fit_replays[0],
          fit_runs=','.join(str(fit_runs[key]) for key in sorted(fit_runs)),
          fit_epoch_s=f'{fit.time_ / RECSYS_EPOCHS:.4f}',
          **{f'{key}_s': f'{v:.2f}' for key, v in parts_s.items()},
          leg_s=f'{time.perf_counter() - leg_t0:.2f}')
    if not bitwise:
        raise RuntimeError(f'recsys_graph: the programs\' epochs differ '
                           f'from the eager ones: {diffs}')
    if eager_counts != {n_batches} or graph_counts != {n_batches}:
        raise RuntimeError(f'recsys_graph: BCD launches an epoch '
                           f'{eager_counts} eager and {graph_counts} '
                           f'through the programs, expected {n_batches}')
    if captures != len(want_keys) or keys != want_keys or not runs_ok:
        raise RuntimeError(f'recsys_graph: {captures} captures of '
                           f'{keys} (runs '
                           f'{[programs[key].runs for key in keys]}), '
                           f'expected {want_keys}')
    if not fit_ok:
        raise RuntimeError(f'recsys_graph: the fit through the programs '
                           f'differs from the eager epochs ({fit_diffs}, '
                           f'n_iter {fit.n_iter_}) or ran {fit_launches} '
                           f'BCD launches and {fit_batches} batches with '
                           f'{fit_captures} captures, runs {fit_runs}')
    return fit_launches


class ProfiledSteps:
    """An ImageDictFact callback (called before each step) that profiles
    the steps ``first`` to ``last - 1`` of a fit through
    ``utils/profiling.py::device_trace`` into ``logdir``, with the card
    synchronised at both ends; ``summary()`` reads the window after the
    fit."""

    def __init__(self, first, last, logdir):
        self.first, self.last, self.logdir = first, last, logdir
        self.calls = 0
        self.stack = contextlib.ExitStack()

    def __call__(self, est):
        import torch
        from modl_tpu_torch.utils.profiling import device_trace
        if self.calls in (self.first, self.last):
            torch.cuda.synchronize()
            if self.calls == self.first:
                self.prof = self.stack.enter_context(device_trace(
                    self.logdir))
                self.t0 = time.perf_counter()
            else:
                self.wall = time.perf_counter() - self.t0
                self.stack.close()
        self.calls += 1

    def summary(self):
        """(wall s, device busy s, host reads, {kernel: (device ms,
        launches)}, (count, ms) of the card's idle gaps of WINDOW_GAP_MS
        or more) of the window, for the FISTA and BCD kernels."""
        from modl_tpu_torch.utils.profiling import device_summary, idle_gaps
        busy, _, reads, device = device_summary(self.prof)
        kernels = {name: (sum(e.self_device_time_total for e in device
                              if name in e.key) / 1e3,
                          sum(e.count for e in device if name in e.key))
                   for name in ('fista_kernel', 'bcd_kernel')}
        return (self.wall, busy, reads, kernels,
                idle_gaps(self.prof, WINDOW_GAP_MS))


def image_phase():
    """exps/exp_decompose_images.py's configuration through
    ImageDictFact.fit; returns the BCD and FISTA launches of the main
    fit."""
    import torch
    from modl_tpu_torch import ImageDictFact
    from modl_tpu_torch.benchmarks.workloads import (IMAGE, IMAGE_SHAPE,
                                                     IMAGE_SUBSET,
                                                     IMAGE_TEST, image_steps)
    from modl_tpu_torch.datasets.image import make_synthetic_image
    from modl_tpu_torch.decomposition import _program
    from modl_tpu_torch.feature_extraction.image import \
        LazyCleanPatchExtractor
    from modl_tpu_torch.ops import bcd, fista

    image = make_synthetic_image(*IMAGE_SHAPE)
    test = LazyCleanPatchExtractor(
        patch_size=IMAGE['patch_size'], max_patches=IMAGE_TEST,
        random_state=IMAGE['random_state'] + 1).fit(image).transform()
    init = ImageDictFact(**IMAGE, n_epochs=0, device='cuda').fit(image)
    score0 = init.score(test)
    bcd.LAUNCHES = fista.LAUNCHES = 0
    captures, graph_steps = _program.CAPTURES, _program.STEPS
    est = ImageDictFact(**IMAGE, n_epochs=1, device='cuda')
    with steps_without_host_reads():
        seconds = timed_fit(est, image)
    launches, fista_launches = bcd.LAUNCHES, fista.LAUNCHES
    captures = _program.CAPTURES - captures
    graph_steps = _program.STEPS - graph_steps
    score = est.score(test)
    n_rows = est.n_iter_
    steps = image_steps(n_rows, est)
    # the batches short of batch_size (one a buffer with a remainder)
    # step eagerly
    short = image_steps(n_rows, est) - n_rows // est.batch_size
    path = 'graph' if graph_steps == steps - short else 'eager'
    cfg = est.dict_fact_._cfg
    sub = dict(IMAGE, n_epochs=1, max_patches=IMAGE_SUBSET, device='cuda')
    # the subset fit's steady steps under the profiler
    window = ProfiledSteps(*IMAGE_WINDOW, os.path.join(
        REPO, 'build', 'chip_smoke_trace', 'image'))
    kernel_sub = ImageDictFact(**sub, callback=window).fit(image)
    window_s, busy, window_reads, window_kernels, gaps = \
        window.summary()
    bcd.LAUNCHES = fista.LAUNCHES = 0
    plain_sub = ImageDictFact(**sub)
    with plain_bcd(), plain_fista():
        plain_seconds = timed_fit(plain_sub, image)
        score_p = plain_sub.score(test)
    plain_launches = bcd.LAUNCHES + fista.LAUNCHES
    score_k = kernel_sub.score(test)
    rel = abs(score_k - score_p) / abs(score_p)
    bcd.LAUNCHES = fista.LAUNCHES = 0
    nmf = ImageDictFact(**dict(sub, setting='NMF'))
    nmf_seconds = timed_fit(nmf, image)
    nmf_launches, nmf_fista = bcd.LAUNCHES, fista.LAUNCHES
    nmf_codes = nmf.transform(test)
    nmf_ok = bool((nmf.components_ >= 0).all() and (nmf_codes >= 0).all()
                  and nmf_codes.any() and np.isfinite(nmf.score(test)))
    phase('image', image=f'{IMAGE_SHAPE[0]}x{IMAGE_SHAPE[1]}',
          patches=n_rows, features=est.dict_fact_._n_features,
          len_subset=cfg.len_subset, len_max=cfg.len_max,
          steps=steps, path=path, graph_steps=graph_steps,
          eager_steps=steps - graph_steps, captures=captures,
          bcd_launches=launches, fista_launches=fista_launches,
          host_reads_in_steps=0, launches_plain=plain_launches,
          score=f'{score:.6g}',
          score_init=f'{score0:.6g}', subset=IMAGE_SUBSET,
          subset_score=f'{score_k:.6g}', subset_score_plain=f'{score_p:.6g}',
          rel_diff=f'{rel:.3e}', nmf_launches=nmf_launches,
          nmf_fista_launches=nmf_fista, nmf_nonnegative=nmf_ok,
          fit_patches_per_s=f'{n_rows / seconds:.1f}',
          compute_patches_per_s=f'{n_rows / est.time_:.1f}',
          subset_fit_s=f'{plain_seconds:.4f}',
          nmf_fit_s=f'{nmf_seconds:.4f}', fit_s=f'{seconds:.4f}',
          steps_s=f'{est.time_:.4f}',
          window_steps=IMAGE_WINDOW[1] - IMAGE_WINDOW[0],
          window_s=f'{window_s:.4f}', window_device_busy_s=f'{busy:.4f}',
          idle_share=f'{1 - busy / window_s:.4f}',
          window_host_reads=window_reads,
          window_idle_gaps=gaps[0],
          window_idle_gaps_ms=f'{gaps[1]:.3f}',
          **{f'window_{name}_ms': f'{ms:.3f}'
             for name, (ms, _) in window_kernels.items()},
          **{f'window_{name}_launches': n
             for name, (_, n) in window_kernels.items()})
    nmf_steps = image_steps(IMAGE_SUBSET, nmf)
    if ((launches, fista_launches, nmf_launches, nmf_fista, plain_launches)
            != (steps, steps, nmf_steps, nmf_steps, 0)):
        raise RuntimeError(f'image: {launches} and {nmf_launches} BCD and '
                           f'{fista_launches} and {nmf_fista} FISTA '
                           f'launches ({plain_launches} plain), expected '
                           f'{steps} and {nmf_steps} each (0)')
    if (path, captures) != ('graph', 1):
        raise RuntimeError(f'image: {graph_steps} of {steps} steps through '
                           f'the step program ({short} short batches), '
                           f'{captures} captures; expected every full batch '
                           'and one capture')
    if not (math.isfinite(score) and score < score0):
        raise RuntimeError(f'image: held-out score {score} not below the '
                           f'initial {score0}')
    if not rel < FIT_RTOL:
        raise RuntimeError(f'image: kernel and plain fits differ: '
                           f'{score_k} vs {score_p} (rel {rel})')
    if not nmf_ok:
        raise RuntimeError('image: NMF components or codes not '
                           'non-negative and finite')
    if not bool(torch.isfinite(est.dict_fact_._state.D).all()):
        raise RuntimeError('image: dictionary not finite')
    return launches, fista_launches


@contextlib.contextmanager
def environ(**values):
    """Environment variables set (None: unset) for the block."""
    saved = {name: os.environ.get(name) for name in values}
    try:
        for name, value in values.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


@contextlib.contextmanager
def counting_steps():
    """Counts the learner steps the block runs: ceil(n / batch) a
    ``DictFact._partial_fit_ingested`` call; recsys batches are counted by
    ``recsys.BATCHES`` (each batch that ran, eagerly or in a program's
    replay), which ``driven`` adds. Yields the dict that holds the
    count."""
    from modl_tpu_torch.decomposition import dict_fact
    count = {'steps': 0}
    ingested = dict_fact.DictFact._partial_fit_ingested

    def counted_ingested(self, X_dev, sample_indices, rows=None):
        n = X_dev.shape[0] if rows is None else rows.shape[0]
        count['steps'] += -(-n // min(self.batch_size, n)) if n else 0
        return ingested(self, X_dev, sample_indices, rows=rows)

    dict_fact.DictFact._partial_fit_ingested = counted_ingested
    try:
        yield count
    finally:
        dict_fact.DictFact._partial_fit_ingested = ingested


def driven(fn, count, **kwargs):
    """``fn(**kwargs)`` with its printing kept: (result, printed text,
    seconds, BCD launches, EMA-GEMM launches, steps, FISTA launches),
    the counts set to 0 just before; the steps are ``count``'s and the
    recsys batches."""
    import torch
    from modl_tpu_torch.decomposition import recsys
    from modl_tpu_torch.ops import bcd, ema_gemm, fista
    out = io.StringIO()
    bcd.LAUNCHES = ema_gemm.LAUNCHES = fista.LAUNCHES = count['steps'] = 0
    recsys.BATCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn(**kwargs)
    torch.cuda.synchronize()
    return (result, out.getvalue(), time.perf_counter() - t0,
            bcd.LAUNCHES, ema_gemm.LAUNCHES,
            count['steps'] + recsys.BATCHES, fista.LAUNCHES)


def final_score(name, result, text):
    """The final score an example reports: its last test objective or
    test RMSE, or the stability examples' lowest mean discrepancy."""
    import re
    if isinstance(result, dict):
        return min(mean for mean, _ in result.values())
    pattern = {'predict_recsys': r'test RMSE ([-+.\deE]+)'}.get(
        name, r'final test objective:? ([-+.\deE]+)')
    return float(re.findall(pattern, text)[-1])


def drivers_phase(workdir):
    """The port's drivers on the card: the HCP pipeline at its own
    k=1,024 on 200,000 voxels, every example and one run of
    exp_decompose_fmri. Returns their BCD and EMA-GEMM launches."""
    from modl_tpu_torch.examples import (decompose_fmri,
                                         decompose_fmri_stability,
                                         decompose_images, predict_recsys,
                                         stability_selection)
    from modl_tpu_torch.exps import exp_decompose_fmri
    from modl_tpu_torch.exps.hcp import decompose_hcp, unmask_hcp
    out = os.path.join(workdir, 'out')
    src = os.path.join(workdir, 'hcp_volumes')
    os.makedirs(src)
    np.save(os.path.join(src, 'mask.npy'), mni_mask())
    rng = np.random.default_rng(0)
    for i in range(HCP_DRIVER_VOLUMES):
        np.save(os.path.join(src, f'subject_{i}.npy'), rng.standard_normal(
            MNI_3MM + (HCP_DRIVER_FRAMES,), dtype=np.float32))
    launches = {}
    with environ(MODL_OUTPUT=out, MODL_DATA=os.path.join(workdir, 'data'),
                 MODL_SHARED_DATA=None), counting_steps() as count:
        # 1. the HCP pipeline: unmask on the host, then decompose_hcp at
        # its defaults
        manifest, _, unmask_s, *_ = driven(unmask_hcp.main, count,
                                           source_dir=src)
        with open(manifest) as f:
            n_records = len(json.load(f)['records'])
        fd, _, seconds, bcd_n, ema_n, steps, _ = driven(
            decompose_hcp.main, count)
        cfg = fd.dict_fact_._cfg
        blocks = bcd_blocks(cfg)
        want = expected_launches(cfg, HCP_DRIVER_FRAMES, fd.batch_size,
                                 n_records, fd.n_epochs, blocks)
        comps = np.load(os.path.join(out, 'hcp_components.npy'))
        phase('drivers', driver='exps.hcp', records=n_records,
              k=cfg.n_components, voxels=comps.shape[1],
              windowed=cfg.windowed, blocks_per_step=blocks,
              steps=steps, bcd_launches=bcd_n, ema_launches=ema_n,
              segment_ends=want[1], unmask_s=f'{unmask_s:.2f}',
              decompose_s=f'{seconds:.2f}',
              epoch_samples_per_s=f'{streaming_rate(fd):.1f}',
              io_s=f'{fd.io_time_:.4f}', cpu_s=f'{fd.cpu_time_:.4f}')
        if (bcd_n, ema_n) != want or blocks < 2 or ema_n < 1 \
                or steps * blocks != bcd_n:
            raise RuntimeError(f'drivers: decompose_hcp launched {bcd_n} '
                               f'BCD and {ema_n} EMA-GEMM kernels over '
                               f'{steps} steps, expected {want} '
                               f'({blocks} blocks a step)')
        if comps.shape != (cfg.n_components, N_FEATURES) \
                or not np.isfinite(comps).all():
            raise RuntimeError(f'drivers: hcp_components.npy {comps.shape}'
                               ' not finite or not (1024, 200000)')
        launches['hcp'] = (bcd_n, ema_n)
        del fd, comps
        shutil.rmtree(src, ignore_errors=True)
        # 2. the examples ('lisboa' is not under MODL_DATA: the image
        # example takes its synthetic image; 'face' would download)
        for name, fn, kw in (
                ('decompose_fmri', decompose_fmri.main, dict(n_epochs=1)),
                ('decompose_fmri_stability', decompose_fmri_stability.main,
                 {}),
                ('decompose_images', decompose_images.main,
                 dict(n_epochs=1, source='lisboa')),
                ('predict_recsys', predict_recsys.main, {}),
                ('stability_selection', stability_selection.main, {})):
            result, text, seconds, bcd_n, ema_n, steps, fista_n = driven(
                fn, count, **kw)
            score = final_score(name, result, text)
            phase('drivers', driver=f'examples.{name}', steps=steps,
                  bcd_launches=bcd_n, ema_launches=ema_n,
                  fista_launches=fista_n, score=f'{score:.6g}',
                  seconds=f'{seconds:.2f}')
            if not (steps > 0 and bcd_n >= steps and math.isfinite(score)):
                raise RuntimeError(f'drivers: {name} launched {bcd_n} BCD '
                                   f'kernels over {steps} steps, score '
                                   f'{score}')
            launches[name] = (bcd_n, ema_n)
        # 3. one run of the fMRI experiment
        run, _, seconds, bcd_n, ema_n, steps, _ = driven(
            exp_decompose_fmri.run, count, n_epochs=1)
        score = run.info['final_score']
        phase('drivers', driver='exps.exp_decompose_fmri', steps=steps,
              bcd_launches=bcd_n, ema_launches=ema_n, score=f'{score:.6g}',
              seconds=f'{seconds:.2f}',
              run_dir=os.path.relpath(run.dir, REPO))
        if not (steps > 0 and bcd_n >= steps and math.isfinite(score)):
            raise RuntimeError(f'drivers: exp_decompose_fmri launched '
                               f'{bcd_n} BCD kernels over {steps} steps, '
                               f'score {score}')
        launches['exp_decompose_fmri'] = (bcd_n, ema_n)
    return launches


@contextlib.contextmanager
def float64_state_policy():
    """The former dtype policy, for one fit: float64 data keeps float64
    state on the card, which takes the plain BCD (the kernel runs float32
    only) and the plain segment end."""
    from modl_tpu_torch.decomposition import dict_fact
    saved = dict_fact._default_dtype

    def keep(dtype, device, explicit=False):
        dtype = np.dtype(dtype)
        return dtype if dtype in (np.float32, np.float64) \
            else np.dtype(np.float32)

    dict_fact._default_dtype = keep
    try:
        yield
    finally:
        dict_fact._default_dtype = saved


def dtype_policy_phase(X, X_test, obj0):
    """ADHD-70 on float64 data through DictFact(dtype=None) and through
    fMRIDictFact on in-memory float64 records: float32 state, one BCD
    launch a step and the EMA-GEMM launches of a float32 fit; an explicit
    float64 raises; the former policy (float64 state, plain BCD) timed on
    the same data."""
    import torch
    from modl_tpu_torch import Coder, DictFact, fMRIDictFact
    from modl_tpu_torch.ops import bcd, ema_gemm
    X64 = X.astype(np.float64)
    kw = dict(ADHD, dtype=None)
    bcd.LAUNCHES = ema_gemm.LAUNCHES = 0
    df = DictFact(**kw, device='cuda')
    seconds = timed_fit(df, X64)
    launches, ema_launches = bcd.LAUNCHES, ema_gemm.LAUNCHES
    obj = df.score(X_test)
    steps = ADHD_SAMPLES // ADHD['batch_size']
    want_ema = expected_launches(df._cfg, ADHD_SAMPLES, ADHD['batch_size'],
                                 1, 1, 1)[1]
    try:
        DictFact(**dict(kw, dtype=np.float64), device='cuda').fit(X64[:200])
        refused = False
    except ValueError:
        refused = True
    coder_dtype = Coder(df.components_.astype(np.float64),
                        device='cuda')._components_device().dtype
    # the same fit under the former policy
    bcd.LAUNCHES = 0
    with float64_state_policy():
        before = DictFact(**kw, device='cuda')
        before_seconds = timed_fit(before, X64)
    before_launches = bcd.LAUNCHES
    obj_before = before.score(X_test)
    rel = abs(obj - obj_before) / abs(obj_before)
    # fMRIDictFact on two in-memory float64 records of 200 frames
    records = [X64[:FMRI_ADHD_FRAMES], X64[FMRI_ADHD_FRAMES:
                                           2 * FMRI_ADHD_FRAMES]]
    fd = fMRIDictFact(mask=np.ones((N_FEATURES, 1, 1), bool), n_epochs=1,
                      device='cuda', **FMRI_ADHD)
    bcd.LAUNCHES = ema_gemm.LAUNCHES = 0
    fd.fit(records)
    torch.cuda.synchronize()
    fmri_launches = (bcd.LAUNCHES, ema_gemm.LAUNCHES)
    fcfg = fd.dict_fact_._cfg
    want_fmri = expected_launches(fcfg, FMRI_ADHD_FRAMES,
                                  FMRI_ADHD['batch_size'], FMRI_RECORDS, 1,
                                  bcd_blocks(fcfg))
    phase('dtype_policy', data='float64', state=str(df._state.D.dtype),
          bcd_launches=launches, steps=steps, ema_launches=ema_launches,
          segment_ends=want_ema, explicit_float64_refused=refused,
          coder_dtype=str(coder_dtype), objective=f'{obj:.6g}',
          objective_init=f'{obj0:.6g}',
          objective_float64_state=f'{obj_before:.6g}', rel_diff=f'{rel:.3e}',
          epoch_s=f'{df.time_:.4f}', fit_s=f'{seconds:.4f}',
          float64_state=str(before._state.D.dtype),
          float64_state_bcd_launches=before_launches,
          float64_state_epoch_s=f'{before.time_:.4f}',
          float64_state_fit_s=f'{before_seconds:.4f}',
          fmri_state=str(fd.dict_fact_._state.D.dtype),
          fmri_bcd_launches=fmri_launches[0],
          fmri_ema_launches=fmri_launches[1], fmri_steps=want_fmri[0])
    if not (df._state.D.dtype == torch.float32 and launches == steps
            and ema_launches == want_ema > 0):
        raise RuntimeError(f'dtype_policy: float64 data ran '
                           f'{df._state.D.dtype} state with {launches} BCD '
                           f'and {ema_launches} EMA-GEMM launches, expected '
                           f'float32, {steps} and {want_ema}')
    if not refused:
        raise RuntimeError('dtype_policy: dtype=np.float64 on CUDA did not '
                           'raise')
    if coder_dtype != torch.float32:
        raise RuntimeError(f'dtype_policy: Coder ran {coder_dtype} on CUDA')
    if not (fd.dict_fact_._state.D.dtype == torch.float32
            and fmri_launches == want_fmri):
        raise RuntimeError(f'dtype_policy: fMRIDictFact ran '
                           f'{fd.dict_fact_._state.D.dtype} state with '
                           f'{fmri_launches} launches, expected float32 and '
                           f'{want_fmri}')
    if not (math.isfinite(obj) and obj < obj0 and rel < FIT_RTOL):
        raise RuntimeError(f'dtype_policy: objective {obj} (initial {obj0}, '
                           f'float64 state {obj_before})')
    return launches


def checkpoint_phase(X, workdir):
    """A fitted ADHD-70 DictFact pickled and reloaded on the card, one
    more partial_fit of both; then save_state/load_state mid-fit (with
    the 'average' aggregators, so G_avg goes through host RAM) and a
    resumed run against the uninterrupted one."""
    import pickle

    import torch
    from modl_tpu_torch import DictFact
    from modl_tpu_torch.ops import bcd
    from modl_tpu_torch.utils.checkpoint import load_state, save_state
    df = DictFact(**ADHD, device='cuda').fit(X)
    t0 = time.perf_counter()
    blob = pickle.dumps(df)
    twin = pickle.loads(blob)
    pickle_s = time.perf_counter() - t0
    D = twin._state.D
    loaded = (D.device.type == 'cuda' and D.dtype == torch.float32
              and np.array_equal(twin.components_, df.components_))
    rows = 5 * ADHD['batch_size']
    bcd.LAUNCHES = 0
    twin.partial_fit(X[:rows])
    launches = bcd.LAUNCHES
    df.partial_fit(X[:rows])
    resumed = np.array_equal(twin.components_, df.components_)

    # the mid-fit checkpoint carries G_avg: load_state leaves it in
    # pinned host RAM and the next partial_fit moves it to the card
    half = ADHD_SAMPLES // 2
    path = os.path.join(workdir, 'mid.npz')
    kw = dict(ADHD, Dx_agg='average', G_agg='average', device='cuda')
    a = DictFact(**kw).prepare(n_samples=ADHD_SAMPLES, X=X)
    a.partial_fit(X[:half], sample_indices=np.arange(half))
    t0 = time.perf_counter()
    save_state(a._state, path)
    save_s = time.perf_counter() - t0
    a.partial_fit(X[half:], sample_indices=np.arange(half, ADHD_SAMPLES))
    b = DictFact(**kw).prepare(n_samples=ADHD_SAMPLES, X=X)
    t0 = time.perf_counter()
    b._state = load_state(path)
    load_s = time.perf_counter() - t0
    G_loaded = b._state.G_avg
    b.partial_fit(X[half:], sample_indices=np.arange(half, ADHD_SAMPLES))
    g_avg_placed = (G_loaded.device.type == 'cpu' and G_loaded.is_pinned()
                    and b._state.G_avg.device.type == 'cuda')
    diff = float(np.abs(a.components_ - b.components_).max())
    phase('checkpoint', pickle_bytes=len(blob), pickle_round_trip_s=(
        f'{pickle_s:.4f}'), loaded_on=str(D.device), loaded_dtype=str(D.dtype),
          components_equal=loaded, bcd_launches_after_load=launches,
          steps_after_load=rows // ADHD['batch_size'],
          pickle_resume_bitwise=resumed,
          npz_bytes=os.path.getsize(path), save_s=f'{save_s:.4f}',
          load_s=f'{load_s:.4f}', g_avg_loaded_on=str(G_loaded.device),
          g_avg_loaded_pinned=G_loaded.is_pinned(),
          g_avg_resumed_on=str(b._state.G_avg.device),
          resume_max_abs_diff=f'{diff:.3e}')
    if not (loaded and launches == rows // ADHD['batch_size'] and resumed):
        raise RuntimeError('checkpoint: the unpickled estimator is not on the '
                           'card in float32 with equal components, or its '
                           'next partial_fit missed the kernel or diverged')
    if not g_avg_placed:
        raise RuntimeError('checkpoint: load_state did not leave G_avg in '
                           'pinned host RAM, or partial_fit did not move it '
                           'to the card')
    if diff != 0.0:
        raise RuntimeError(f'checkpoint: the resumed run differs from the '
                           f'uninterrupted one by {diff}')
    os.remove(path)


def each_batch(estimator):
    """A fit callback that does nothing: with it ``DictFact`` steps batch
    by batch, B's EMA each step, as an offloaded segment does."""


def offload_phase(X, X_test):
    """HCP-1024 width with Dx_agg=G_agg='average' and G_avg in pinned host
    RAM: one epoch of 1,200 rows (6 segments of one batch), against the
    resident fit stepped batch by batch (the segments' math: bitwise
    expected) and the resident fused epoch (deferred B); host-device copy
    rates at a segment's size and the device's idle share of one more
    offloaded partial_fit epoch."""
    import torch
    from modl_tpu_torch import DictFact
    from modl_tpu_torch.ops import bcd, ema_gemm
    from modl_tpu_torch.utils.profiling import (StepTimer, device_summary,
                                                device_trace)
    kw = dict(HCP, Dx_agg='average', G_agg='average')
    obj0 = DictFact(**HCP, device='cuda').prepare(
        n_samples=HCP_SAMPLES, X=X).score(X_test)
    runs = {'deferred': dict(), 'per_batch': dict(callback=each_batch),
            'offload': dict(average_offload=True)}
    out = {}
    for name, extra in runs.items():
        timer = StepTimer('cuda')
        bcd.LAUNCHES = ema_gemm.LAUNCHES = 0
        with timer.measure():
            est = DictFact(**kw, **extra, device='cuda').fit(X)
        out[name] = dict(launches=(bcd.LAUNCHES, ema_gemm.LAUNCHES),
                         fit_s=timer.total, epoch_s=est.time_,
                         D=est.components_)
        if name != 'offload':
            del est                 # its 5 GB of G_avg leave the card
            torch.cuda.empty_cache()
    off = est
    G_avg = off._state.G_avg
    cfg = off._cfg
    steps = HCP_SAMPLES // HCP['batch_size']
    blocks = bcd_blocks(cfg)
    D_off = out['offload']['D']

    def rel_diff(name):
        D = out[name]['D']
        return float(np.abs(D_off - D).max()) / float(np.abs(D).max())

    rel, rel_deferred = rel_diff('per_batch'), rel_diff('deferred')
    bitwise = bool(np.array_equal(D_off, out['per_batch']['D']))
    obj = off.score(X_test)
    # copy rates at one segment's size, through the fit's staging buffer
    staging = off._offload_staging
    dev = torch.empty(staging.shape, dtype=staging.dtype, device='cuda')
    h2d_ms = cuda_ms(lambda: dev.copy_(staging, non_blocking=True), 3)
    d2h_ms = cuda_ms(lambda: staging.copy_(dev, non_blocking=True), 3)
    mb = staging.numel() * staging.element_size() / 1e6
    del dev
    # idle share of one more offloaded epoch under the profiler
    with device_trace(os.path.join(REPO, 'build', 'chip_smoke_trace',
                                   'offload')) as prof:
        t0 = time.perf_counter()
        off.partial_fit(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_summary(prof)[0]
    launches = out['offload']['launches']
    phase('offload', k=cfg.n_components, rows=HCP_SAMPLES,
          features=N_FEATURES, g_avg_device=str(G_avg.device),
          g_avg_pinned=G_avg.is_pinned(),
          g_avg_GB=f'{G_avg.numel() * G_avg.element_size() / 1e9:.3f}',
          segment_rows=staging.shape[0], segment_MB=f'{mb:.1f}',
          bcd_launches=launches[0], steps=steps, blocks_per_step=blocks,
          ema_launches=launches[1],
          **{f'{name}_launches': '/'.join(map(str, out[name]['launches']))
             for name in ('per_batch', 'deferred')},
          rel_diff_per_batch=f'{rel:.3e}', bitwise_per_batch=bitwise,
          rel_diff_deferred=f'{rel_deferred:.3e}',
          objective=f'{obj:.6g}', objective_init=f'{obj0:.6g}',
          **{f'{name}_epoch_s': f'{out[name]["epoch_s"]:.4f}'
             for name in runs},
          **{f'{name}_fit_s': f'{out[name]["fit_s"]:.4f}' for name in runs},
          h2d_MBps=f'{mb / h2d_ms * 1e3:.1f}',
          d2h_MBps=f'{mb / d2h_ms * 1e3:.1f}',
          profiled_epoch_s=f'{wall:.4f}', device_busy_s=f'{busy:.4f}',
          idle_share=f'{1 - busy / wall:.4f}')
    if not (G_avg.device.type == 'cpu' and G_avg.is_pinned()
            and G_avg.shape == (HCP_SAMPLES, cfg.n_components,
                                cfg.n_components)):
        raise RuntimeError(f'offload: G_avg {tuple(G_avg.shape)} on '
                           f'{G_avg.device}, pinned={G_avg.is_pinned()}')
    if launches != (steps * blocks, 0) or blocks < 2:
        raise RuntimeError(f'offload: {launches} BCD and EMA-GEMM '
                           f'launches, expected ({steps * blocks}, 0)')
    if not rel <= OFFLOAD_RTOL:
        raise RuntimeError(f'offload: components differ from the resident '
                           f'fit by {rel:.3e} of their scale')
    if not rel_deferred <= OFFLOAD_DEFERRED_RTOL:
        raise RuntimeError(f'offload: components differ from the resident '
                           f'fused epoch by {rel_deferred:.3e} of their '
                           f'scale')
    if not (math.isfinite(obj) and obj < obj0):
        raise RuntimeError(f'offload: held-out objective {obj} not below '
                           f'the initial {obj0}')
    return launches[0]


def mesh_rank(rank, world, legs, device):
    """One rank of a mesh world (``parallel.launch.spawn``): each leg a
    fit on a mesh of its own shape, every rank with the same data and
    seed, after a warm-up fit on the leg's first ``warm`` rows (a fresh
    process' first fit pays for its libraries, allocations and
    communicators). The kernels' and the collectives' counts are set to
    0 just before the fit and read just after; the whole components
    (and a recsys fit's test RMSE) are held against the single-process
    fit's, saved by the parent. Returns one record a leg."""
    import scipy.sparse as sp
    import torch
    from modl_tpu_torch import DictFact, RecsysDictFact
    from modl_tpu_torch.ops import bcd, ema_gemm, fista
    from modl_tpu_torch.parallel import mesh as pmesh
    out = []
    for leg in legs:
        mesh = pmesh.make_mesh(*leg['shape'], device_type=device)
        if leg['kind'] == 'recsys':
            X = sp.load_npz(leg['data'])
            make, init = RecsysDictFact, {}
        else:
            X = np.load(leg['data'])
            # the warm-up's dictionary starts from the same k rows
            make, init = DictFact, dict(
                dict_init=X[:leg['kw']['n_components']])
        make(mesh=mesh, device=device, **leg['kw'], **init).fit(
            X[:leg['warm']])
        est = make(mesh=mesh, device=device, **leg['kw'])
        if device == 'cuda':
            torch.cuda.synchronize()
        pmesh.COLLECTIVES.clear()
        bcd.LAUNCHES = ema_gemm.LAUNCHES = fista.LAUNCHES = 0
        t0 = time.perf_counter()
        est.fit(X)
        if device == 'cuda':
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        rec = dict(name=leg['name'], rank=rank,
                   launches=(bcd.LAUNCHES, ema_gemm.LAUNCHES),
                   fista_launches=fista.LAUNCHES,
                   collectives=dict(pmesh.COLLECTIVES), fit_s=fit_s,
                   epoch_s=est.time_)
        D = est.components_
        ref = np.load(leg['ref'])
        rec['diff'] = float(np.abs(D - ref).max() / np.abs(ref).max())
        rec['finite'] = bool(np.isfinite(D).all())
        if leg['kind'] == 'recsys':
            rec['rmse'] = est.score(sp.load_npz(leg['test']))
            rec['rmse_diff'] = abs(rec['rmse'] - leg['rmse'])
            rec['resident_rows'] = est._resident_rows
        else:
            rec['local_D'] = tuple(est._state.D.shape)
            if est._state.G_avg is not None:
                rec['local_G_avg'] = tuple(est._state.G_avg.shape)
        out.append(rec)
        del est, X
        if device == 'cuda':
            torch.cuda.empty_cache()
    return out


def mesh_legs(results, backend, legs):
    """Print each leg's line (its ranks' worst numbers) and hold it to its
    bounds: ``leg['expect']`` is its (BCD, EMA-GEMM) launches per rank
    and its steps, ``leg['fista_min']`` (where given) the least FISTA
    launches per rank. Returns '<backend>_<leg>' -> (BCD, EMA-GEMM,
    FISTA) launches per rank."""
    launches = {}
    for i, leg in enumerate(legs):
        recs = [r[i] for r in results]
        name = leg['name']
        per_rank = {r['launches'] for r in recs}
        coll = recs[0]['collectives']
        want, steps = leg['expect'][:2], leg['expect'][2]
        diff = max(r['diff'] for r in recs)
        rmse_diff = max(r.get('rmse_diff', 0.0) for r in recs)
        extra = ({'test_rmse': f'{recs[0]["rmse"]:.6f}',
                  'rmse_single': f'{leg["rmse"]:.6f}',
                  'rmse_diff': f'{rmse_diff:.3e}',
                  'resident_rows_per_rank': recs[0]['resident_rows']}
                 if leg['kind'] == 'recsys' else
                 {'local_D': 'x'.join(map(str, recs[0]['local_D']))})
        if 'local_G_avg' in recs[0]:
            extra['local_G_avg'] = 'x'.join(map(str,
                                                recs[0]['local_G_avg']))
        phase(f'mesh_{backend}', leg=name,
              mesh='x'.join(map(str, leg['shape'])), backend=backend,
              ranks=len(recs),
              epoch_s=f'{max(r["epoch_s"] for r in recs):.4f}',
              fit_s=f'{max(r["fit_s"] for r in recs):.4f}',
              collectives_per_step=f'{coll.get("calls", 0) / steps:.1f}',
              MB_per_step=f'{coll.get("bytes", 0) / steps / 1e6:.2f}',
              collectives_dp=coll.get('calls_dp', 0),
              collectives_feat=coll.get('calls_feat', 0),
              bcd_launches_per_rank=recs[0]['launches'][0],
              ema_launches_per_rank=recs[0]['launches'][1],
              fista_launches_per_rank=recs[0]['fista_launches'],
              expected='/'.join(map(str, want)),
              max_diff=f'{diff:.3e}', **extra)
        if per_rank != {want}:
            raise RuntimeError(f'mesh {name}: launches per rank {per_rank}, '
                               f'expected {want}')
        fista_per_rank = {r['fista_launches'] for r in recs}
        if len(fista_per_rank) != 1 or min(fista_per_rank) < leg.get(
                'fista_min', 0):
            raise RuntimeError(f'mesh {name}: FISTA launches per rank '
                               f'{fista_per_rank}, expected one count of '
                               f'at least {leg.get("fista_min", 0)}')
        if not diff <= MESH_RTOL or not all(r['finite'] for r in recs):
            raise RuntimeError(f'mesh {name}: differs from the single-'
                               f'process fit by {diff:.3e} of max |D| '
                               f'(bound {MESH_RTOL})')
        if not rmse_diff <= MESH_RMSE_TOL:
            raise RuntimeError(f'mesh {name}: test RMSE differs from the '
                               f'single-process fit by {rmse_diff:.3e} '
                               f'(bound {MESH_RMSE_TOL})')
        launches[f'{backend}_{name}'] = (*recs[0]['launches'],
                                         recs[0]['fista_launches'])
    return launches


def mesh_phase(workdir, adhd, hcp, X_hcp, X_tr, X_te, mesh_only=False,
               adhd_l1=None):
    """The dp x feat mesh through torch.distributed (``parallel``): an
    NCCL world of every visible card (up to four) as (world, 1) on the
    ADHD-70 fit, then a gloo world of four ranks on card 0 with ADHD-70
    on (4, 1) and (2, 2), HCP-1024 on (2, 2), ADHD-70 with
    ``G_agg='average'`` on (4, 1) and the recsys fit on (4, 1), each
    held against the single-process fit of the same data in this call.
    ``adhd``/``hcp``: (single-process components, (BCD, EMA-GEMM)
    launches) of phases 4 and 5; ``workdir`` holds phase 4's data
    (``adhd_X.npy``). On four cards the NCCL world runs every four-rank
    leg, and ``mesh_only`` skips the gloo world then. ``adhd_l1``: the
    single-process fit of phase adhd70_l1 (components, (BCD, EMA-GEMM)
    launches); where given, a gloo world of two ranks on card 0 fits it
    on (2, 1), each rank solving half of each batch's codes by FISTA a
    check a launch with the stop agreed over the ranks. Returns
    '<backend>_<leg>' -> (BCD, EMA-GEMM, FISTA) launches per rank."""
    import scipy.sparse as sp
    import torch
    from modl_tpu_torch import DictFact, RecsysDictFact
    from modl_tpu_torch.benchmarks.workloads import RECSYS, recsys_batch
    from modl_tpu_torch.parallel.launch import spawn

    def path(name):
        return os.path.join(workdir, name)

    X = np.load(path('adhd_X.npy'))
    np.save(path('adhd_D.npy'), adhd[0])
    np.save(path('hcp_X.npy'), X_hcp)
    np.save(path('hcp_D.npy'), hcp[0])
    avg_kw = dict(ADHD, G_agg='average')
    single = DictFact(**avg_kw, device='cuda').fit(X)
    np.save(path('avg_D.npy'), single.components_)
    avg_cfg = single._cfg
    del single, X
    rec_kw = dict(RECSYS, n_epochs=1)
    single = RecsysDictFact(**rec_kw, device='cuda').fit(X_tr)
    rmse_single = single.score(X_te)
    np.save(path('rec_D.npy'), single.components_)
    del single
    sp.save_npz(path('rec_tr.npz'), X_tr)
    sp.save_npz(path('rec_te.npz'), X_te)
    torch.cuda.empty_cache()

    adhd_steps = ADHD_SAMPLES // ADHD['batch_size']
    hcp_steps = HCP_SAMPLES // HCP['batch_size']
    n_batches = -(-X_tr.shape[0] // recsys_batch(X_tr))
    avg_ema = expected_launches(avg_cfg, ADHD_SAMPLES, ADHD['batch_size'],
                                1, 1, 1)[1]
    adhd_expect = (*adhd[1], adhd_steps)

    def leg(name, shape, kw, data, ref, expect):
        return dict(name=name, kind='dict_fact', shape=shape, kw=kw,
                    data=path(data), ref=path(ref), expect=expect,
                    warm=4 * kw['batch_size'])

    four = [leg('adhd70_4x1', (4, 1), ADHD, 'adhd_X.npy', 'adhd_D.npy',
                adhd_expect),
            leg('adhd70_2x2', (2, 2), ADHD, 'adhd_X.npy', 'adhd_D.npy',
                adhd_expect),
            leg('hcp1024_2x2', (2, 2), HCP, 'hcp_X.npy', 'hcp_D.npy',
                (*hcp[1], hcp_steps)),
            leg('adhd70_average_4x1', (4, 1), avg_kw, 'adhd_X.npy',
                'avg_D.npy', (adhd_steps * bcd_blocks(avg_cfg), avg_ema,
                              adhd_steps)),
            dict(name='recsys_4x1', kind='recsys', shape=(4, 1), kw=rec_kw,
                 data=path('rec_tr.npz'), test=path('rec_te.npz'),
                 ref=path('rec_D.npy'), rmse=rmse_single, warm=5000,
                 expect=(n_batches, 0, n_batches))]
    # NCCL: one rank per card, as many as there are, up to four; on four
    # cards every four-rank leg, else ADHD-70 on (world, 1)
    world = min(torch.cuda.device_count(), 4)
    nccl = four if world == 4 else [
        leg(f'adhd70_{world}x1', (world, 1), ADHD, 'adhd_X.npy',
            'adhd_D.npy', adhd_expect)]
    results = spawn(mesh_rank, world, backend='nccl', device='cuda',
                    timeout=MESH_TIMEOUT, args=(nccl, 'cuda'))
    launches = mesh_legs(results, 'nccl', nccl)
    if mesh_only and world == 4:
        return launches
    # gloo: four ranks on card 0, the same program at world size 4
    results = spawn(mesh_rank, 4, backend='gloo', device='cuda',
                    timeout=MESH_TIMEOUT, args=(four, 'cuda'))
    launches.update(mesh_legs(results, 'gloo', four))
    if adhd_l1 is not None:
        np.save(path('adhd_l1_D.npy'), adhd_l1[0])
        l1 = [dict(leg('adhd70_l1_2x1', (2, 1), dict(ADHD, code_l1_ratio=1.0),
                       'adhd_X.npy', 'adhd_l1_D.npy',
                       (*adhd_l1[1], adhd_steps)), fista_min=adhd_steps)]
        results = spawn(mesh_rank, 2, backend='gloo', device='cuda',
                        timeout=MESH_TIMEOUT, args=(l1, 'cuda'))
        launches.update(mesh_legs(results, 'gloo', l1))
    return launches


def mesh_only_main(name):
    """``--mesh-only``: the single-process ADHD-70 and HCP-1024 fits of
    phases 4 and 5 (after a warm-up fit each), then phase mesh; on four
    cards its legs run over NCCL across them."""
    import torch
    from modl_tpu_torch import DictFact
    from modl_tpu_torch.benchmarks.workloads import recsys_data
    mesh_dir = os.path.join(REPO, 'build', 'chip_smoke_mesh')
    shutil.rmtree(mesh_dir, ignore_errors=True)
    os.makedirs(mesh_dir)
    refs = []
    try:
        for kw, X in ((ADHD, adhd_data()[0]),
                      (HCP, np.random.RandomState(0).randn(
                          HCP_SAMPLES, N_FEATURES).astype(np.float32))):
            DictFact(**kw, device='cuda').fit(X)        # warm-up
            df, _, launches, ema = resident_fit(kw, X, True)
            refs.append((df.components_, (launches, ema)))
            phase('mesh_reference', k=kw['n_components'],
                  epoch_s=f'{df.time_:.4f}', launches=launches,
                  ema_launches=ema)
            if kw is ADHD:
                np.save(os.path.join(mesh_dir, 'adhd_X.npy'), X)
            del df
            torch.cuda.empty_cache()
        mesh_phase(mesh_dir, *refs, X, *recsys_data(), mesh_only=True)
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def ab_fista_leg(tree, index):
    """One leg of ``--ab-fista``: ``tree``'s FISTA kernel on every case;
    saves the codes under build/ab_fista."""
    sys.path.insert(0, tree)
    import statistics

    import torch
    from modl_tpu_torch.ops import fista
    from modl_tpu_torch.ops.precision import full_f32
    name = os.path.basename(tree)
    solves = []
    for i, (label, b, k, n, reduction, shared, l1_ratio,
            positive) in enumerate(FISTA_CASES):
        g = torch.Generator(device='cuda').manual_seed(100 + i)
        ops = fista_inputs(b, k, n, reduction, shared, g)
        params = (FISTA_ALPHA * l1_ratio, FISTA_ALPHA * (1.0 - l1_ratio),
                  positive)
        solves.append((label, ops + params + (FISTA_MAX_ITER, FISTA_TOL)))
        if i == 0:
            solves += [(f'{label}_fixed{m}', ops + params + (m, 0.0))
                       for m in AB_SWEEP]
    codes = {}
    with full_f32():
        for label, args in solves:
            codes[label] = fista.fista_gram(*args).cpu()
            iters = fista.last_iterations()
            ms = cuda_ms(lambda: fista.fista_gram(*args), AB_REPS)
            print(f'tree={name} leg={index} case={label} ms={ms:.4f} '
                  f'iterations={iters}', flush=True)
        # the entry point's host time, the card kept busy by the queue
        entry, seconds = fista._kernel(), []

        def timed(*args):
            t0 = time.perf_counter()
            err = entry(*args)
            seconds.append(time.perf_counter() - t0)
            return err

        fista._kernel = lambda: timed
        torch.cuda._sleep(QUEUE_CYCLES)
        for _ in range(AB_HOST_LAUNCHES):
            fista.fista_gram(*solves[0][1])
        torch.cuda.synchronize()
    print(f'tree={name} leg={index} case={solves[0][0]} '
          f'launch_host_us={1e6 * statistics.median(seconds):.2f}',
          flush=True)
    out = os.path.join(REPO, 'build', 'ab_fista')
    os.makedirs(out, exist_ok=True)
    torch.save(codes, os.path.join(out, f'leg{index}.pt'))
    return 0


def ab_fista(trees):
    """``--ab-fista``: a leg a tree, in turns, each its own process; then
    the codes of each leg against each tree's first leg."""
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = [os.path.abspath(tree) for tree in trees]
    for index, tree in enumerate(trees):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--ab-fista-leg', tree, str(index)], cwd=tree,
                       check=True)
    names = [os.path.basename(tree) for tree in trees]
    legs = [torch.load(os.path.join(REPO, 'build', 'ab_fista',
                                    f'leg{i}.pt')) for i in range(len(trees))]
    first = {name: legs[names.index(name)] for name in names}
    for index, (name, codes) in enumerate(zip(names, legs)):
        equal = {other: sum(torch.equal(codes[label], ref[label])
                            for label in codes)
                 for other, ref in first.items()}
        print(f'tree={name} leg={index} cases={len(codes)} bitwise_equal='
              + ','.join(f'{other}:{n}' for other, n in equal.items()),
              flush=True)
    return 0


def ab_step_graph(trees):
    """``--ab-step-graph``: the image fits of each checkout in turns
    (``modl_tpu_torch/benchmarks/ab_image_fit.py`` of this one), each
    leg its own process."""
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    return subprocess.run([sys.executable, os.path.join(
        REPO, 'modl_tpu_torch', 'benchmarks', 'ab_image_fit.py'),
        *trees]).returncode


def scan_graph_only_main(name, smi):
    """``--scan-graph-only``: the EMA-GEMM kernel at the three segment-end
    shapes of the fits, then phase scan_graph, then the device line."""
    import torch
    from modl_tpu_torch.ops import ema_gemm
    from modl_tpu_torch.ops.sampler import binomial_len_max
    n_adhd = N_FEATURES + binomial_len_max(N_FEATURES, N_FEATURES // 12)
    n_hcp = N_FEATURES + binomial_len_max(N_FEATURES, N_FEATURES // 20)
    for i, shape in enumerate([(70, 200, n_adhd), (1024, 1200, n_hcp),
                               (70, 700, n_adhd)]):
        ema_case(ema_gemm, *shape, seed=10 + i)
    X, X_test = adhd_data()
    from modl_tpu_torch import DictFact
    obj0 = DictFact(**ADHD, device='cuda').prepare(
        n_samples=ADHD_SAMPLES, X=X).score(X_test)
    scan_graph_phase(X, X_test, obj0)
    del X, X_test
    scan_graph_leg('hcp1024', HCP, np.random.RandomState(0).randn(
        HCP_SAMPLES, N_FEATURES).astype(np.float32))
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)

    from modl_tpu_torch import DictFact
    from modl_tpu_torch.benchmarks import launch_overhead
    from modl_tpu_torch.ops import _build, bcd, ema_gemm, fista

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase('device', name=repr(name), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    for module in (bcd, ema_gemm, launch_overhead, fista):
        module._kernel()
    phase('build', seconds=f'{time.perf_counter() - t0:.2f}',
          library=os.path.relpath(lib, REPO))
    for line in lib.with_suffix('.log').read_text().splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ptxas: ' + line.strip(), flush=True)
    if sys.argv[1:] == ['--mesh-only']:
        return mesh_only_main(name)
    if sys.argv[1:] == ['--scan-graph-only']:
        return scan_graph_only_main(name, smi)
    if sys.argv[1:] == ['--recsys-graph-only']:
        from modl_tpu_torch.benchmarks.workloads import recsys_data
        recsys_graph_phase(recsys_data()[0])
        print(smi, flush=True)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': name,
            'count': torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ['--step-graph-only']:
        X, _ = adhd_data()
        legs = adhd_graph_legs(X) + image_graph_leg()
        step_graph_phase(legs)
        del X, legs
        step_graph_phase(hcp_graph_leg(np.random.RandomState(0).randn(
            HCP_SAMPLES, N_FEATURES).astype(np.float32)))
        print(smi, flush=True)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': name,
            'count': torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. the kernel against its plain version
    results = [kernel_case(bcd, *case, seed=i)
               for i, case in enumerate(KERNEL_CASES)]
    results += [kernel_case(bcd, *case, seed=len(results) + i, shrink=False)
                for i, case in enumerate(NO_SHRINK_CASES)]
    from modl_tpu_torch.benchmarks.workloads import RECSYS, recsys_data
    X_tr, X_te = recsys_data()
    union = recsys_union(X_tr)
    recsys_case = kernel_case(bcd, RECSYS['n_components'], X_tr.shape[1],
                              0.0, False, seed=len(results), mask=union)
    image_cases = [kernel_case(bcd, *case, seed=len(results) + 1 + i)
                   for i, case in enumerate(IMAGE_CASES)]
    results += [recsys_case] + image_cases
    del union
    max_err = max([r[0] for r in results]
                  + [blocked_recsys_case(bcd, seed=len(results))])
    adhd_ms, adhd_plain_ms, adhd_bound_ms, adhd_bound_by = results[0][1:]
    hcp_ms, hcp_plain_ms, hcp_bound_ms, _ = results[1][1:]
    barrier_phase(bcd._plan(*KERNEL_CASES[0][:2])[0])
    # 3b. the FISTA kernel against its plain version
    fista_results = fista_phase()
    main_fista = record_fista_instances()

    # 4. ADHD-70 through DictFact.fit
    X, X_test = adhd_data()
    obj0 = DictFact(**ADHD, device='cuda').prepare(
        n_samples=ADHD_SAMPLES, X=X).score(X_test)
    DictFact(**ADHD, device='cuda').fit(X)          # warm-up epoch
    df, seconds, launches, ema_on = resident_fit(ADHD, X, True)
    obj = df.score(X_test)
    # gate-off control: the BCD kernel alone
    off, _, off_launches, ema_off = resident_fit(ADHD, X, False)
    obj_off = off.score(X_test)
    ends = check_resident_ema('ADHD-70', df._cfg, ADHD_SAMPLES,
                              ADHD['batch_size'], ema_on, ema_off)
    rel_off = abs(obj - obj_off) / abs(obj_off)

    class PlainDictFact(DictFact):
        def _make_config(self, *args, **kwargs):
            cfg = super()._make_config(*args, **kwargs)
            return dataclasses.replace(cfg, use_kernel=False)

    plain = PlainDictFact(**ADHD, device='cuda')
    plain_seconds = timed_fit(plain, X)
    obj_plain = plain.score(X_test)
    rel = abs(obj - obj_plain) / abs(obj_plain)
    phase('adhd70', launches=launches, steps=ADHD_SAMPLES // 100,
          ema_launches=ema_on, segment_ends=ends,
          ema_launches_gate_off=ema_off,
          objective=f'{obj:.6g}', objective_init=f'{obj0:.6g}',
          objective_plain=f'{obj_plain:.6g}', rel_diff=f'{rel:.3e}',
          objective_gate_off=f'{obj_off:.6g}',
          rel_diff_gate_off=f'{rel_off:.3e}',
          fit_samples_per_s=f'{ADHD_SAMPLES / seconds:.1f}',
          epoch_samples_per_s=f'{ADHD_SAMPLES / df.time_:.1f}',
          epoch_samples_per_s_gate_off=f'{ADHD_SAMPLES / off.time_:.1f}',
          plain_fit_samples_per_s=f'{ADHD_SAMPLES / plain_seconds:.1f}')
    if min(launches, off_launches) < ADHD_SAMPLES // 100:
        raise RuntimeError(f'ADHD-70 fits launched the kernel {launches} '
                           f'and {off_launches} times, expected one per '
                           'step')
    if not (math.isfinite(obj) and obj < obj0):
        raise RuntimeError(f'ADHD-70 objective {obj} not below the '
                           f'initial {obj0}')
    if not (rel < FIT_RTOL and rel_off < FIT_RTOL):
        raise RuntimeError(f'kernel and plain fits differ: rel {rel} '
                           f'(plain path), {rel_off} (gate off)')
    adhd_ref = (df.components_, (launches, ema_on))
    del df, off, plain

    # 4-. the SOMF step as one captured graph, against the eager step
    step_graph_phase(adhd_graph_legs(X) + image_graph_leg())
    # 4-b. the fused epoch as one captured graph, against the eager scan
    scan_graph_phase(X, X_test, obj0)

    # 4a. DictFact's default codes (l1, FISTA) at ADHD-70 width
    *adhd_l1, adhd_l1_fista = adhd70_l1_phase(X, X_test)

    # 4b. float64 data on the card; 4c. pickling and checkpoints
    dtype_launches = dtype_policy_phase(X, X_test, obj0)
    workdir = os.path.join(REPO, 'build', 'chip_smoke_checkpoint')
    os.makedirs(workdir, exist_ok=True)
    try:
        checkpoint_phase(X, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # phase mesh's ranks read the data from here
    mesh_dir = os.path.join(REPO, 'build', 'chip_smoke_mesh')
    shutil.rmtree(mesh_dir, ignore_errors=True)
    os.makedirs(mesh_dir)
    np.save(os.path.join(mesh_dir, 'adhd_X.npy'), X)
    del X, X_test

    # 5. HCP-1024: the block driver
    X = np.random.RandomState(0).randn(HCP_SAMPLES, N_FEATURES).astype(
        np.float32)
    DictFact(**HCP, device='cuda').fit(X)           # warm-up epoch
    df, seconds, hcp_launches, ema_on = resident_fit(HCP, X, True)
    off, _, off_launches, ema_off = resident_fit(HCP, X, False)
    cfg = df._cfg
    ends = check_resident_ema('HCP-1024', cfg, HCP_SAMPLES,
                              HCP['batch_size'], ema_on, ema_off)
    steps = HCP_SAMPLES // HCP['batch_size']
    blocks = -(-cfg.n_components // bcd.max_block(cfg.len_max,
                                                  torch.float32))
    D = df._state.D
    phase('hcp1024', launches=hcp_launches, steps=steps,
          blocks_per_step=blocks, len_max=cfg.len_max,
          ema_launches=ema_on, segment_ends=ends,
          ema_launches_gate_off=ema_off,
          fit_samples_per_s=f'{HCP_SAMPLES / seconds:.1f}',
          epoch_samples_per_s=f'{HCP_SAMPLES / df.time_:.1f}',
          epoch_samples_per_s_gate_off=f'{HCP_SAMPLES / off.time_:.1f}')
    if (hcp_launches, off_launches) != (steps * blocks,) * 2 or blocks < 2:
        raise RuntimeError(f'HCP-1024 launched {hcp_launches} and '
                           f'{off_launches} kernels, expected {steps} x '
                           f'{blocks} (block driver)')
    if not bool(torch.isfinite(D).all()):
        raise RuntimeError('HCP-1024 dictionary not finite')
    hcp_ref = (df.components_, (hcp_launches, ema_on))
    del df, off, D
    step_graph_phase(hcp_graph_leg(X))
    scan_graph_leg('hcp1024', HCP, X)

    # 5b. average_offload: G_avg in pinned host RAM at HCP-1024 width
    offload_launches = offload_phase(
        X, np.random.RandomState(2).randn(200, N_FEATURES).astype(
            np.float32))
    torch.cuda.empty_cache()

    # 5c. the dp x feat mesh through torch.distributed
    try:
        mesh_launches = mesh_phase(mesh_dir, adhd_ref, hcp_ref, X, X_tr,
                                   X_te, adhd_l1=adhd_l1)
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    del adhd_ref, hcp_ref, adhd_l1

    # 6. the EMA-GEMM kernel against its plain version
    from modl_tpu_torch.ops.sampler import binomial_len_max
    n_adhd = N_FEATURES + binomial_len_max(N_FEATURES, N_FEATURES // 12)
    n_hcp = N_FEATURES + binomial_len_max(N_FEATURES, N_FEATURES // 20)
    # fMRI ADHD-70, HCP-1024 (both fits), resident ADHD-70 (7 x 100 rows),
    # ragged (even and odd width)
    ema = [ema_case(ema_gemm, *shape, seed=10 + i) for i, shape in enumerate(
        [(70, 200, n_adhd), (1024, 1200, n_hcp), (70, 700, n_adhd),
         (37, 13, 1000), (37, 13, 1001)])]
    ema_err = max(r[0] for r in ema)

    # 7. the launch-overhead probe and its benchmark
    lo_launches, lo_err, lo_ms, lo_plain_ms, lo_bound_ms = \
        launch_overhead_phase()

    # 8-9. the streaming fMRI fits (records under build/, git ignores it)
    workdir = os.path.join(REPO, 'build', 'chip_smoke_fmri')
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        ema_launches = fmri_adhd70(workdir)
        fmri_hcp1024(workdir, X)
        del X
        # 9b. the same fit on records and mask given as NIfTI images
        nifti_launches = nifti_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 10-11. the recsys and image fits
    recsys_launches = recsys_ml10m(X_tr, X_te)
    recsys_graph_launches = recsys_graph_phase(X_tr)
    del X_tr, X_te
    image_launches, image_fista = image_phase()

    # 12. the drivers: the HCP pipeline, the examples, an experiment
    workdir = os.path.join(REPO, 'build', 'chip_smoke_drivers')
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        driver_launches = drivers_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # every FISTA instantiation the main path ran was held against the
    # plain version in phase fista (the mesh ranks' solves: their own
    # processes, at shapes of the single fits)
    unchecked = main_fista - {r[5] for r in fista_results}
    phase('fista_coverage', main_path=','.join(sorted(main_fista)),
          unchecked=','.join(sorted(unchecked)) or None)
    if unchecked:
        raise RuntimeError(f'fista: the main path launched '
                           f'{sorted(unchecked)}, which phase fista does '
                           'not hold against the plain version')

    phase('done', seconds=f'{time.perf_counter() - t_start:.1f}')
    print(smi, flush=True)          # the card again, near the end
    print(json.dumps({'kernels': [{
        'name': 'bcd_update', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/bcd_update.cu',
        'replaces': 'modl_tpu/ops/bcd_pallas.py:267',
        'launches': launches, 'max_abs_err': max_err,
        'ms': adhd_ms, 'plain_ms': adhd_plain_ms,
        'bound_ms': adhd_bound_ms, 'bound_by': adhd_bound_by,
        'library_ms': None, 'ms_hcp': hcp_ms, 'plain_ms_hcp': hcp_plain_ms,
        'bound_ms_hcp': hcp_bound_ms, 'launches_recsys': recsys_launches,
        'ms_recsys': recsys_case[1], 'plain_ms_recsys': recsys_case[2],
        'bound_ms_recsys': recsys_case[3],
        'launches_recsys_graph': recsys_graph_launches,
        'launches_image': image_launches,
        'ms_image': image_cases[0][1], 'plain_ms_image': image_cases[0][2],
        'bound_ms_image': image_cases[0][3],
        'launches_dtype_policy': dtype_launches,
        'launches_offload': offload_launches,
        'launches_mesh': {leg: n[0] for leg, n in mesh_launches.items()},
        'launches_nifti': nifti_launches[0],
        'launches_drivers': {leg: n[0]
                             for leg, n in driver_launches.items()}}, {
        'name': 'ema_accumulate', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/ema_gemm.cu',
        'replaces': 'modl_tpu/ops/ema_gemm.py:83',
        'launches': ema_launches, 'max_abs_err': ema_err,
        'ms': ema[0][1], 'plain_ms': ema[0][2], 'bound_ms': ema[0][3],
        'bound_by': ema[0][4], 'library_ms': ema[0][5],
        'launches_mesh': {leg: n[1] for leg, n in mesh_launches.items()},
        'launches_nifti': nifti_launches[1],
        'launches_drivers': {leg: n[1]
                             for leg, n in driver_launches.items()}}, {
        'name': 'launch_overhead', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/launch_overhead.cu',
        'replaces': 'benchmarks/pallas_call_overhead.py:31',
        'launches': lo_launches, 'max_abs_err': lo_err,
        'ms': lo_ms, 'plain_ms': lo_plain_ms, 'bound_ms': lo_bound_ms,
        'bound_by': 'bytes', 'library_ms': None}, {
        'name': 'fista_gram', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/fista_gram.cu',
        'replaces': 'modl_tpu/ops/solvers.py:163',
        'launches': image_fista,
        'max_abs_err': max(r[0] for r in fista_results),
        'ms': fista_results[0][1], 'plain_ms': fista_results[0][2],
        'bound_ms': fista_results[0][3], 'bound_by': fista_results[0][4],
        'library_ms': None,
        **{f'{key}_{case[0]}': r[i] for case, r in zip(
            FISTA_CASES[1:], fista_results[1:])
           for i, key in ((1, 'ms'), (2, 'plain_ms'), (3, 'bound_ms'))},
        'launches_adhd70_l1': adhd_l1_fista,
        'launches_mesh': {leg: n[2] for leg, n in mesh_launches.items()
                          if n[2]}}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def stop_children():
    """Stop every process of the run that is still there when it ends:
    the resource tracker that ``multiprocessing`` starts for the mesh
    phase's ranks (it outlives its parent, cleaning up after it), then
    every other descendant, terminated (killed after 5 s) and waited
    for."""
    import gc
    import signal
    from multiprocessing import resource_tracker
    gc.collect()        # the ranks' queue unregisters its locks first
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, '_pid', None) is not None:
        tracker._stop()             # closes its pipe, waits for its exit
    parents = {}
    for pid in filter(str.isdigit, os.listdir('/proc')):
        try:
            with open(f'/proc/{pid}/stat') as f:
                stat = f.read()
        except OSError:
            continue
        parents[int(pid)] = int(stat[stat.rindex(')') + 2:].split()[1])
    left = [os.getpid()]          # every descendant, children first
    for pid in left:
        left += [c for c, parent in parents.items() if parent == pid]
    left = left[1:]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            with contextlib.suppress(OSError):
                os.kill(pid, sig)
        deadline = time.monotonic() + 5.0
        while left and time.monotonic() < deadline:
            for pid in list(left):
                with contextlib.suppress(ChildProcessError):
                    if os.waitpid(pid, os.WNOHANG) == (0, 0):
                        continue            # a child still running
                if parents.get(pid) == os.getpid() or not os.path.exists(
                        f'/proc/{pid}'):
                    left.remove(pid)
            time.sleep(0.05)


def run():
    if sys.argv[1:2] == ['--ab-fista-leg']:
        return ab_fista_leg(os.path.abspath(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ['--ab-fista'] and sys.argv[2:]:
        return ab_fista(sys.argv[2:])
    if sys.argv[1:2] == ['--ab-step-graph'] and sys.argv[2:]:
        return ab_step_graph(sys.argv[2:])
    return main()


if __name__ == '__main__':
    try:
        code = run()
    finally:
        stop_children()
    sys.exit(code)
