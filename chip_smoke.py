#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``modl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``modl_tpu_torch/csrc/*.cu`` from this checkout (one
   ``nvcc`` per source, all started together);
3. kernel: the Hopper BCD kernel against its plain PyTorch version on the
   card at the main path's shapes, with both times (CUDA events);
4. adhd70: ``DictFact(...).fit(X)`` at the ADHD-70 configuration of
   ``bench.py`` (k=70, 2,000 x 200,000 planted data, one epoch of 20
   steps): kernel launches counted on the main path, a held-out objective
   below the initial dictionary's, agreement with a refit through the
   plain BCD path, and samples/s;
5. hcp1024: one epoch (6 steps) of the HCP-1024 configuration through
   the kernel block driver, with samples/s;
6. ema_kernel: the EMA-GEMM kernel against its plain version at the two
   fMRI segment-end shapes and a ragged one, for pi in {0, 0.9, 1};
7. launch_overhead: the launch-overhead probe against its plain version,
   then its benchmark (ms per step and per launch at 4, 2, 1 launches);
8. fmri_adhd70: ``fMRIDictFact.fit`` on ``bench.py``'s streaming fMRI
   leg (2 records of 200 x 200,000 planted frames written by
   ``create_raw_rest_data(feature_order=0)``, float32 and float16, cleaned
   on the device, 3 epochs) with the EMA-GEMM kernel on the segment end:
   launch counts, record-cache hits, held-out objective below the initial
   dictionary's and within 1e-2 of a refit with the kernel off, epoch
   samples/s, io/cpu time and the host-to-device rate;
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

# kernel vs plain version: (k, s, comp_l1_ratio, comp_pos)
KERNEL_CASES = [(70, 17655, 1.0, False), (256, 10780, 1.0, False),
                (64, 4096, 0.0, False), (64, 4096, 0.5, False),
                (64, 4096, 1.0, True)]
# both run the same sequential f32 recurrence with sums taken in another
# order; the l1 Newton branches on sums, so agreement is held at a
# relative 1e-4 of the rows' scale rather than at roundoff
KERNEL_RTOL = 1e-4
# held-out objective of the kernel fit vs the plain-path refit
# (tests/test_tpu_quality.py pins the Pallas path at the same 1e-2)
FIT_RTOL = 1e-2
# EMA-GEMM kernel vs plain version, relative to max |ref|: f32 sums of
# m <= 1,200 products taken in another order
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


def kernel_case(bcd, k, s, l1_ratio, comp_pos, seed):
    import torch
    from modl_tpu_torch.ops.enet import enet_scale
    g = torch.Generator(device='cuda').manual_seed(seed)
    dev = dict(device='cuda', dtype=torch.float32, generator=g)
    D = enet_scale(torch.randn(k, s, **dev), l1_ratio, radius=1.0)
    A = torch.randn(k, k, **dev)
    C = A @ A.T / k + 0.1 * torch.eye(k, device='cuda')
    grad = C @ (D + 0.3 * torch.randn(k, s, **dev) / math.sqrt(s))
    cn = torch.zeros(k, device='cuda')
    order = torch.randperm(k, device='cuda', generator=g)
    args = (D, grad, C, cn, order)
    kw = dict(comp_pos=comp_pos, l1_ratio=l1_ratio)
    Dk, cnk = bcd.bcd_update(*args, **kw)
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
    ok = err <= KERNEL_RTOL * scale and err_cn <= KERNEL_RTOL * budget
    ms = cuda_ms(lambda: bcd.bcd_update(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: bcd.bcd_update_reference(*args, **kw), 2)
    phase('kernel', shape=f'{k}x{s}', l1_ratio=l1_ratio, comp_pos=comp_pos,
          max_abs_err=f'{err:.3e}', rel_err=f'{err / scale:.3e}',
          cn_abs_err=f'{err_cn:.3e}', ms=f'{ms:.4f}',
          plain_ms=f'{plain_ms:.4f}', ok=ok)
    if not ok:
        raise RuntimeError(f'kernel disagrees with its plain version at '
                           f'({k}, {s}, l1={l1_ratio}, pos={comp_pos})')
    return err, ms, plain_ms


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


def ema_case(ema_gemm, k, m, n, seed):
    """The EMA-GEMM kernel against its plain version at one shape, for
    every pi; returns (max abs error, kernel ms, plain ms) at pi=0.9."""
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
    gflop = 2.0 * k * m * n / 1e9
    phase('ema_kernel', shape=f'k{k}xm{m}xn{n}', ms=f'{ms:.4f}',
          plain_ms=f'{plain_ms:.4f}',
          kernel_tflops=f'{gflop / ms:.2f}',
          plain_tflops=f'{gflop / plain_ms:.2f}')
    return err, ms, plain_ms


def launch_overhead_phase():
    """The launch-overhead probe against its plain version at four
    blocks, then its benchmark; returns (launches of the benchmark,
    max abs error, kernel ms, plain ms) for one launch of four blocks."""
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
    phase('launch_overhead', shape=f'{tuple(D.shape)}',
          max_abs_err=f'{err:.3e}', rel_err=f'{err / scale:.3e}',
          ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}', ok=ok)
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
    return launches, err, ms, plain_ms


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
    ema_gemm.ENABLED = enabled
    try:
        fd = fMRIDictFact(mask=masker, n_epochs=n_epochs, device='cuda',
                          **kw)
        bcd.LAUNCHES = ema_gemm.LAUNCHES = 0
        t0 = time.perf_counter()
        fd.fit(records)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return fd, seconds, bcd.LAUNCHES, ema_gemm.LAUNCHES
    finally:
        ema_gemm.ENABLED = False


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
              fit_samples_per_s=f'{n_samples / dt1:.1f}',
              first_epoch_samples_per_s=f'{n_samples / first:.1f}',
              steady_epoch_samples_per_s=f'{2 * n_samples / steady:.1f}',
              compute_samples_per_s=(
                  f'{3 * n_samples / fd.dict_fact_.time_:.1f}'),
              io_s=f'{fd1.io_time_:.4f}', cpu_s=f'{fd1.cpu_time_:.4f}',
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
          rel_diff=f'{rel:.3e}', fit_samples_per_s=f'{n / seconds:.1f}',
          fit_samples_per_s_kernel_off=f'{n / off_seconds:.1f}',
          compute_samples_per_s=f'{n / fd.dict_fact_.time_:.1f}',
          compute_samples_per_s_kernel_off=(
              f'{n / off.dict_fact_.time_:.1f}'),
          io_s=f'{fd.io_time_:.4f}', cpu_s=f'{fd.cpu_time_:.4f}')
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
    max_err = max(r[0] for r in results)
    adhd_ms, adhd_plain_ms = results[0][1], results[0][2]

    # 4. ADHD-70 through DictFact.fit
    X, X_test = adhd_data()
    obj0 = DictFact(**ADHD, device='cuda').prepare(
        n_samples=ADHD_SAMPLES, X=X).score(X_test)
    DictFact(**ADHD, device='cuda').fit(X)          # warm-up epoch
    bcd.LAUNCHES = 0
    df = DictFact(**ADHD, device='cuda')
    seconds = timed_fit(df, X)
    launches = bcd.LAUNCHES
    obj = df.score(X_test)

    class PlainDictFact(DictFact):
        def _make_config(self, *args, **kwargs):
            cfg = super()._make_config(*args, **kwargs)
            return dataclasses.replace(cfg, use_kernel=False)

    plain = PlainDictFact(**ADHD, device='cuda')
    plain_seconds = timed_fit(plain, X)
    obj_plain = plain.score(X_test)
    rel = abs(obj - obj_plain) / abs(obj_plain)
    phase('adhd70', launches=launches, steps=ADHD_SAMPLES // 100,
          objective=f'{obj:.6g}', objective_init=f'{obj0:.6g}',
          objective_plain=f'{obj_plain:.6g}', rel_diff=f'{rel:.3e}',
          fit_samples_per_s=f'{ADHD_SAMPLES / seconds:.1f}',
          epoch_samples_per_s=f'{ADHD_SAMPLES / df.time_:.1f}',
          plain_fit_samples_per_s=f'{ADHD_SAMPLES / plain_seconds:.1f}')
    if launches < ADHD_SAMPLES // 100:
        raise RuntimeError(f'ADHD-70 fit launched the kernel {launches} '
                           'times, expected one per step')
    if not (math.isfinite(obj) and obj < obj0):
        raise RuntimeError(f'ADHD-70 objective {obj} not below the '
                           f'initial {obj0}')
    if not rel < FIT_RTOL:
        raise RuntimeError(f'kernel and plain fits differ: rel {rel}')
    del X, X_test, df, plain

    # 5. HCP-1024: the block driver
    X = np.random.RandomState(0).randn(HCP_SAMPLES, N_FEATURES).astype(
        np.float32)
    DictFact(**HCP, device='cuda').fit(X)           # warm-up epoch
    bcd.LAUNCHES = 0
    df = DictFact(**HCP, device='cuda')
    seconds = timed_fit(df, X)
    hcp_launches = bcd.LAUNCHES
    cfg = df._cfg
    steps = HCP_SAMPLES // HCP['batch_size']
    blocks = -(-cfg.n_components // bcd.max_block(cfg.len_max,
                                                  torch.float32))
    D = df._state.D
    phase('hcp1024', launches=hcp_launches, steps=steps,
          blocks_per_step=blocks, len_max=cfg.len_max,
          fit_samples_per_s=f'{HCP_SAMPLES / seconds:.1f}',
          epoch_samples_per_s=f'{HCP_SAMPLES / df.time_:.1f}')
    if hcp_launches != steps * blocks or blocks < 2:
        raise RuntimeError(f'HCP-1024 launched {hcp_launches} kernels, '
                           f'expected {steps} x {blocks} (block driver)')
    if not bool(torch.isfinite(D).all()):
        raise RuntimeError('HCP-1024 dictionary not finite')
    del df, D

    # 6. the EMA-GEMM kernel against its plain version
    from modl_tpu_torch.ops.sampler import binomial_len_max
    n_adhd = N_FEATURES + binomial_len_max(N_FEATURES, N_FEATURES // 12)
    n_hcp = N_FEATURES + binomial_len_max(N_FEATURES, N_FEATURES // 20)
    ema = [ema_case(ema_gemm, *shape, seed=10 + i) for i, shape in enumerate(
        [(70, 200, n_adhd), (1024, 1200, n_hcp), (37, 13, 1000)])]
    ema_err = max(r[0] for r in ema)

    # 7. the launch-overhead probe and its benchmark
    lo_launches, lo_err, lo_ms, lo_plain_ms = launch_overhead_phase()

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
        'ms': adhd_ms, 'plain_ms': adhd_plain_ms}, {
        'name': 'ema_accumulate', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/ema_gemm.cu',
        'replaces': 'modl_tpu/ops/ema_gemm.py:83',
        'launches': ema_launches, 'max_abs_err': ema_err,
        'ms': ema[0][1], 'plain_ms': ema[0][2]}, {
        'name': 'launch_overhead', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/launch_overhead.cu',
        'replaces': 'benchmarks/pallas_call_overhead.py:31',
        'launches': lo_launches, 'max_abs_err': lo_err,
        'ms': lo_ms, 'plain_ms': lo_plain_ms}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
