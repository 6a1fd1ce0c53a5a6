#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``modl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``modl_tpu_torch/csrc/*.cu`` from this checkout;
3. kernel: the Hopper BCD kernel against its plain PyTorch version on the
   card at the main path's shapes, with both times (CUDA events);
4. adhd70: ``DictFact(...).fit(X)`` at the ADHD-70 configuration of
   ``bench.py`` (k=70, 2,000 x 200,000 planted data, one epoch of 20
   steps): kernel launches counted on the main path, a held-out objective
   below the initial dictionary's, agreement with a refit through the
   plain BCD path, and samples/s;
5. hcp1024: one epoch (6 steps) of the HCP-1024 configuration through
   the kernel block driver, with samples/s.

Then one JSON line per kernel (``{"kernels": [...]}``) and, last, the
device line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result where no CUDA device is visible.
"""
import json
import math
import os
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


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import dataclasses

    from modl_tpu_torch import DictFact
    from modl_tpu_torch.ops import _build, bcd

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
    bcd._library()
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

    print(json.dumps({'kernels': [{
        'name': 'bcd_update', 'route': 'cuda',
        'source': 'modl_tpu_torch/csrc/bcd_update.cu',
        'replaces': 'modl_tpu/ops/bcd_pallas.py:267',
        'launches': launches, 'max_abs_err': max_err,
        'ms': adhd_ms, 'plain_ms': adhd_plain_ms}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
