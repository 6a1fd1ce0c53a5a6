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
4. adhd70: ``DictFact(...).fit(X)`` at the ADHD-70 configuration of
   ``bench.py`` (k=70, 2,000 x 200,000 planted data, one epoch of 20
   steps): BCD and EMA-GEMM launches counted on the main path (one
   EMA-GEMM launch per deferred-B segment end) and on a gate-off control
   (none), a held-out objective below the initial dictionary's, agreement
   with the gate-off fit and with a refit through the plain BCD path, and
   samples/s;
5. hcp1024: one epoch (6 steps) of the HCP-1024 configuration through
   the kernel block driver, with the same launch counts, gate on and off,
   and samples/s;
6. ema_kernel: the EMA-GEMM kernel (3xTF32 on the tensor cores) against
   its plain version at the segment-end shapes of the fMRI legs and of the
   resident ADHD-70 fit and at two ragged ones (one of odd width), for pi
   in {0, 0.9, 1}, with both times, GB/s and TFLOP/s;
7. launch_overhead: the launch-overhead probe against its plain version,
   then its benchmark (ms per step and per launch at 4, 2, 1 launches);
8. fmri_adhd70: ``fMRIDictFact.fit`` on ``bench.py``'s streaming fMRI
   leg (2 records of 200 x 200,000 planted frames written by
   ``create_raw_rest_data(feature_order=0)``, float32 and float16, cleaned
   on the device, 3 epochs) with the EMA-GEMM kernel on the segment end:
   launch counts, record-cache hits, held-out objective below the initial
   dictionary's and within 1e-2 of a refit with the kernel off, the
   gate's A/B (``partial_fit`` ms of fits in turns with the kernel on,
   off, off, on, and the medians), epoch samples/s, io/cpu time and the
   host-to-device rate;
9. fmri_hcp1024: ``exps/hcp/decompose_hcp.py``'s configuration (k=1024,
   reduction 20, batch 200) on 2 Gaussian records of 1,200 x 200,000,
   2 epochs: the same checks through the BCD block driver.

Then one JSON line per kernel (``{"kernels": [...]}``) and, last, the
device line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result where no CUDA device is visible.
"""
import contextlib
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
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s, f32
# flop/s outside the tensor cores, 3xTF32 flop/s (495 / 3)
HBM_BPS, F32_FLOPS, TF32X3_FLOPS = 3.35e12, 67e12, 495e12 / 3
# grid barriers a call of the barrier probe times
BARRIERS = 2000
# both run the same sequential f32 recurrence with sums taken in another
# order; the l1 Newton branches on sums, so agreement is held at a
# relative 1e-4 of the rows' scale rather than at roundoff
KERNEL_RTOL = 1e-4
# held-out objective of the kernel fit vs the plain-path refit
# (tests/test_tpu_quality.py pins the Pallas path at the same 1e-2)
FIT_RTOL = 1e-2
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
# rounds of on, off, off, on fits in the ADHD-70 leg's gate A/B: the
# kernel's ~1 ms over 6 segment ends sits inside one fit's spread (~32
# ms +- 1.5); the HCP-1024 leg's ~15 ms stands out in one round
AB_ROUNDS_ADHD = 5


def phase(label, **fields):
    print(f'phase={label} ' + ' '.join(f'{k}={v}' for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
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


def kernel_case(bcd, k, s, l1_ratio, comp_pos, seed, shrink=True):
    import torch
    from modl_tpu_torch.ops.enet import enet_scale
    if k is None:
        k = bcd.max_block(s, torch.float32)
    g = torch.Generator(device='cuda').manual_seed(seed)
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
    order = torch.randperm(k, device='cuda', generator=g)
    args = (D, grad, C, cn, order)
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
    phase('kernel', shape=f'{k}x{s}', l1_ratio=l1_ratio, comp_pos=comp_pos,
          shrink=shrink, staged=bcd._plan(k, s)[3],
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


def ema_case(ema_gemm, k, m, n, seed):
    """The EMA-GEMM kernel against its plain version at one shape, for
    every pi; returns (max abs error, kernel ms, plain ms, bound ms,
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
        Bk = ema_gemm.ema_accumulate(B.clone(), SC, X, pi)
        with full_f32():
            Br = ema_gemm.ema_accumulate_reference(B.clone(), SC, X, pi)
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
    ms = cuda_ms(lambda: ema_gemm.ema_accumulate(Bt, SC, X, 0.9), reps)
    with full_f32():
        plain_ms = cuda_ms(
            lambda: ema_gemm.ema_accumulate_reference(Bt, SC, X, 0.9), reps)
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


def fmri_adhd70(workdir):
    """bench.py's streaming fMRI leg at full width, float32 and float16
    records; returns the float32 run's EMA-GEMM launches."""
    from modl_tpu_torch.decomposition.fmri import fMRIDictFact
    from modl_tpu_torch.input_data.fmri import (create_raw_rest_data,
                                                get_raw_rest_data)
    rng = np.random.RandomState(0)
    k = FMRI_ADHD['n_components']
    V = rng.randn(k, N_FEATURES).astype(np.float32) / 30
    recs = [rng.randn(FMRI_ADHD_FRAMES, k).astype(np.float32) @ V
            + 0.1 * rng.randn(FMRI_ADHD_FRAMES, N_FEATURES).astype(
                np.float32) for _ in range(FMRI_RECORDS + 1)]
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
        with contextlib.redirect_stdout(io.StringIO()):
            fd, _, *launches = fmri_fit(train, masker, kw, 3, True)
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
              **ab, io_s=f'{fd1.io_time_:.4f}', cpu_s=f'{fd1.cpu_time_:.4f}',
              h2d_pageable_MBps=f'{pageable:.1f}',
              h2d_pinned_MBps=f'{pinned:.1f}')
        if ema_launches is None:
            ema_launches = launches[1]
        shutil.rmtree(d, ignore_errors=True)
    return ema_launches


def fmri_hcp1024(workdir, X0):
    """exps/hcp/decompose_hcp.py's configuration at full width on two
    Gaussian records (the first is phase 7's data)."""
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
    fd, seconds, *launches = fmri_fit(train, masker, FMRI_HCP, 2, True)
    obj = fd.score(test)
    cfg = fd.dict_fact_._cfg
    blocks = bcd_blocks(cfg)
    want = expected_launches(cfg, HCP_SAMPLES, FMRI_HCP['batch_size'],
                             FMRI_RECORDS, 2, blocks)
    off, off_seconds, _, _ = fmri_fit(train, masker, FMRI_HCP, 2, False)
    ab = gate_ab(train, masker, FMRI_HCP, 2, 1, on=(fd,), off=(off,))
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
          **ab, io_s=f'{fd.io_time_:.4f}', cpu_s=f'{fd.cpu_time_:.4f}')
    shutil.rmtree(d, ignore_errors=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import dataclasses

    from modl_tpu_torch import DictFact
    from modl_tpu_torch.benchmarks import launch_overhead
    from modl_tpu_torch.ops import _build, bcd, ema_gemm

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
    for module in (bcd, ema_gemm, launch_overhead):
        module._kernel()
    phase('build', seconds=f'{time.perf_counter() - t0:.2f}',
          library=os.path.relpath(lib, REPO))
    for line in lib.with_suffix('.log').read_text().splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ptxas: ' + line.strip(), flush=True)

    # 3. the kernel against its plain version
    results = [kernel_case(bcd, *case, seed=i)
               for i, case in enumerate(KERNEL_CASES)]
    results += [kernel_case(bcd, *case, seed=len(results) + i, shrink=False)
                for i, case in enumerate(NO_SHRINK_CASES)]
    max_err = max(r[0] for r in results)
    adhd_ms, adhd_plain_ms, adhd_bound_ms, adhd_bound_by = results[0][1:]
    hcp_ms, hcp_plain_ms, hcp_bound_ms, _ = results[1][1:]
    barrier_phase(bcd._plan(*KERNEL_CASES[0][:2])[0])

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
    del X, X_test, df, off, plain

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
    del df, off, D

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
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print(json.dumps({'kernels': [{
        'name': 'bcd_update', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/bcd_update.cu',
        'replaces': 'modl_tpu/ops/bcd_pallas.py:267',
        'launches': launches, 'max_abs_err': max_err,
        'ms': adhd_ms, 'plain_ms': adhd_plain_ms,
        'bound_ms': adhd_bound_ms, 'bound_by': adhd_bound_by,
        'library_ms': None, 'ms_hcp': hcp_ms, 'plain_ms_hcp': hcp_plain_ms,
        'bound_ms_hcp': hcp_bound_ms}, {
        'name': 'ema_accumulate', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/ema_gemm.cu',
        'replaces': 'modl_tpu/ops/ema_gemm.py:83',
        'launches': ema_launches, 'max_abs_err': ema_err,
        'ms': ema[0][1], 'plain_ms': ema[0][2], 'bound_ms': ema[0][3],
        'bound_by': ema[0][4], 'library_ms': ema[0][5]}, {
        'name': 'launch_overhead', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/launch_overhead.cu',
        'replaces': 'benchmarks/pallas_call_overhead.py:31',
        'launches': lo_launches, 'max_abs_err': lo_err,
        'ms': lo_ms, 'plain_ms': lo_plain_ms, 'bound_ms': lo_bound_ms,
        'bound_by': 'bytes', 'library_ms': None}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
