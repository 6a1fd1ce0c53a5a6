"""Where the time goes in a recsys epoch and in image steps, on one GPU.

    python -m modl_tpu_torch.benchmarks.profile_estimators

Runs the recsys_ml10m and image workloads of ``chip_smoke.py``
(``workloads.py``) under ``torch.profiler`` (a warm-up fit first, then
the profiled one) and
prints, for each: the fit's wall time, its device busy time (the sum of
the device kernels' and copies' times; one stream, so they do not
overlap), the idle share ``1 - busy / wall``, the host reads of device
values (``aten::_local_scalar_dense``), and the device ops with the most
time. Recsys profiles a one-epoch ``RecsysDictFact.fit`` (the epoch loop
plus the CSR copy, the packing and the two code refits, which take well
under 1% of the device time); image profiles a one-epoch fit on a
20,000-patch subset (100 steps of the per-step ``DictFact`` path). Needs
a CUDA device; prints the card's name and power limit first.
"""
import subprocess
import sys
import time

import torch

TOP = 12


def _profile(label, fit, units):
    """Profile ``fit()`` (a warm-up call first) and print the summary;
    ``units()`` adds fields read after the fit."""
    from torch.profiler import ProfilerActivity, profile
    fit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device = [e for e in events if e.device_type.name == 'CUDA']
    busy = sum(e.self_device_time_total for e in device) / 1e6
    reads = sum(e.count for e in events
                if e.key == 'aten::_local_scalar_dense')
    launches = sum(e.count for e in device)
    print(f'profile={label} wall_s={wall:.4f} device_busy_s={busy:.4f} '
          f'idle_share={1 - busy / wall:.4f} device_ops={launches} '
          f'host_reads={reads} {units()}', flush=True)
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f'  {e.self_device_time_total / 1e3:10.3f} ms '
              f'{e.count:7d} x  {e.key[:100]}', flush=True)


def main():
    if not torch.cuda.is_available():
        print('profile_estimators: no CUDA device visible', file=sys.stderr)
        return 1
    from .. import ImageDictFact, RecsysDictFact
    from ..datasets.image import make_synthetic_image
    from . import workloads as wl

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    X_tr, _ = wl.recsys_data()
    batches = -(-X_tr.shape[0] // wl.recsys_batch(X_tr))
    est = RecsysDictFact(**wl.RECSYS, n_epochs=1, device='cuda')
    _profile('recsys_ml10m_epoch', lambda: est.fit(X_tr),
             lambda: f'batches={batches} epoch_loop_s={est.time_:.4f}')
    del X_tr

    image = make_synthetic_image(*wl.IMAGE_SHAPE)
    img = ImageDictFact(**dict(wl.IMAGE, n_epochs=1,
                               max_patches=wl.IMAGE_SUBSET), device='cuda')
    steps = wl.image_steps(wl.IMAGE_SUBSET, img)
    _profile('image_subset_epoch', lambda: img.fit(image),
             lambda: f'steps={steps} steps_s={img.time_:.4f}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
