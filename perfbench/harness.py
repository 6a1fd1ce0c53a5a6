"""The benchmark of modl_tpu_torch: one cell, one run.

A cell (``BENCHMARK.json``'s ``workloads``) is a configuration
(``configs/<name>.json``: the estimator's parameters, the data's sizes
and how the data is made) under a traffic mix (``traffic/<name>.json``:
how the fit is driven). The configuration's driver
(``drivers/<driver>.py``, :mod:`perfbench.drivers`) makes the data on
the device from the seed, prepares the estimator as its ``fit`` does and
drives ``fit``'s epoch loop:

- set-up: the first ``CHECKED_EPOCHS`` epochs, which capture the
  programs and warm every shape, and whose D, C and B the plain
  reference (``reference/``) recomputes after the window;
- the window: whole epochs until ``seconds`` have passed, each ending
  in a sync;
- with ``trace``, the window's first ``TRACE_SECONDS`` under
  ``torch.profiler``, read by the per-layer metrics
  (``metrics/<name>.py``, each a ``read(view)`` of :class:`TraceView`).

``correct`` compares the program's D, C and B after the checked epochs
with the reference's (:mod:`perfbench.checks`), each number against the
cell's limit in ``limits/<cell>.json``.
"""
import bisect
import gc
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import drivers
# the drivers' shared names, and the dict_fact loop where callers of the
# harness find it
from .drivers import CHECKED_EPOCHS, EPOCH_SPAN, SHUFFLE_SPAN, sync  # noqa
from .drivers.dict_fact import FitLoop, snapshot  # noqa: F401

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the part of a traced window under the profiler (seconds)
TRACE_SECONDS = 3.0
# modules that may not be loaded in a run (whole top-level names)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'modl_tpu')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark():
    return load_json(ROOT / 'BENCHMARK.json')


def find(entries, name):
    for entry in entries:
        if entry['name'] == name:
            return entry
    raise KeyError(f'no entry named {name!r}')


def load_config(bench, name):
    return load_json(ROOT / find(bench['configs'], name)['file'])


def load_traffic(name):
    return load_json(HERE / 'traffic' / f'{name}.json')


def load_limits(cell):
    return load_json(HERE / 'limits' / f'{cell}.json')


def metric_reader(name):
    """The ``read(view)`` of ``metrics/<name>.py``."""
    return importlib.import_module(f'perfbench.metrics.{name}').read


def cell_metrics(bench, cell, kind):
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``):
    those without a ``workloads`` list and those that list the cell."""
    return [m for m in bench[kind]
            if cell in m.get('workloads', [cell])]


def split_seed(seed):
    """(data seed, estimator seed) from a run's seed of any size."""
    data, est = np.random.SeedSequence(int(seed)).generate_state(2)
    return int(data), int(est)


def make_data(cfg, seed, device):
    """The configuration's data, made by its driver from ``seed``."""
    return drivers.of(cfg).make_data(cfg, seed, device)


def run_window(loop, seconds, trace, device):
    """Whole epochs until ``seconds`` have passed; returns the host
    clock at the window's start and after each epoch (the last after a
    sync) and, with ``trace``, the profiler that held the first
    ``TRACE_SECONDS``."""
    prof = traced = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    marks = [time.perf_counter()]
    while True:
        loop.epoch()
        now = time.perf_counter()
        if prof is not None and now - marks[0] >= min(TRACE_SECONDS,
                                                      seconds):
            sync(device)
            prof.__exit__(None, None, None)
            traced, prof = prof, None
            now = time.perf_counter()
        marks.append(now)
        if now - marks[0] >= seconds:
            break
    sync(device)
    marks[-1] = time.perf_counter()
    return marks, traced


def epoch_ms(marks):
    """ms of each of the window's epochs: the host clock between
    consecutive marks, each epoch's call ending in a sync."""
    return [1e3 * (b - a) for a, b in zip(marks, marks[1:])]


def p95(values):
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20)[-1]


class TraceView:
    """What the per-layer metrics read from a traced window: the
    harness's epoch and shuffle spans, the device's kernels and copies
    within the window (ns on the profiler's clock), the configuration,
    the work of the traced epochs (``work``, from the configuration's
    driver: :mod:`perfbench.drivers`; the ``dict_fact`` driver's counts
    of ``cfg`` where none is given) and the peaks of the device."""

    def __init__(self, prof, cfg, peaks, work=None):
        host, device = [], []
        for e in prof.profiler.kineto_results.events():
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type().name != 'CUDA':
                host.append(span)
            elif not (getattr(e, 'is_user_annotation', bool)()
                      or e.name().startswith('perfbench.')):
                # the device's kernels and copies, not the profiler's
                # copies of the harness's spans on the device's timeline
                device.append(span)
        # the profiler starts at the window, after set-up's last sync: every
        # device event is the window's; the window ends at the later of
        # the last epoch or shuffle span and the last device event
        self.epochs = sorted(s[:2] for s in host if s[2] == EPOCH_SPAN)
        self.shuffles = sorted(s[:2] for s in host if s[2] == SHUFFLE_SPAN)
        self.device = sorted(device)
        self.window = None
        if self.epochs:
            self.window = (self.epochs[0][0],
                           max([self.epochs[-1][1]]
                               + [e for _, e in self.shuffles[-1:]]
                               + [e for _, e, _ in self.device]))
        self.host = sorted(host)
        self.config = cfg
        self.work = work or drivers.dict_fact.Work(cfg)
        self.peak_flops = peaks and peaks['flops']
        self.peak_bytes = peaks and peaks['bytes_per_s']
        self.busy_ns = sum(e - s for s, e in self.merged())

    @property
    def window_ns(self):
        return self.window[1] - self.window[0] if self.window else 0

    @property
    def steps(self):
        return self.work.steps(len(self.epochs))

    def least_s(self, counts):
        """The least seconds of ``counts`` (``(times, operations,
        bytes)`` each) at the device's peaks: each the larger of its
        operations over the peak rate and its bytes over the peak
        bandwidth, times ``times``."""
        return sum(times * max(ops / self.peak_flops,
                               nbytes / self.peak_bytes)
                   for times, ops, nbytes in counts)

    def merged(self):
        """The device's busy intervals, overlaps merged."""
        out = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def kernel_ns(self, pattern):
        """Summed device ns of the events whose name matches ``pattern``
        (a regular expression); None where none does."""
        rx = re.compile(pattern)
        times = [e - s for s, e, name in self.device if rx.search(name)]
        return sum(times) if times else None

    def top_ops(self, n=10):
        total = {}
        for s, e, name in self.device:
            total[name] = total.get(name, 0) + e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n=10, scan=5000):
        """The idle time between the device's events, summed by what the
        host was doing at each gap's middle (the innermost op or span
        among the ``scan`` host events that started last before it): the
        ``n`` largest of the 500 longest gaps' sums."""
        starts = [s for s, _, _ in self.host]
        gaps = []
        busy = self.merged()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            gaps.append((s1 - e0, (s1 + e0) // 2))
        total = {}
        for length, mid in sorted(gaps, reverse=True)[:500]:
            label = 'none'
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - scan, -1), -1):
                if self.host[j][1] >= mid:
                    label = self.host[j][2]
                    break
            total[label] = total.get(label, 0) + length
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]


def device_peaks(kind):
    for prefix, peaks in load_json(HERE / 'peaks.json').items():
        if kind.startswith(prefix):
            return peaks
    return None


def device_info(device):
    if torch.device(device).type != 'cuda':
        return dict(platform='cpu', kind='cpu', count=0,
                    memory_peak_bytes=0)
    return dict(platform='gpu', kind=torch.cuda.get_device_name(device),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    device)))


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it (None where it
    cannot)."""
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader,nounits'],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def prepare(cfg, traffic, data_seed, est_seed, device):
    """The configuration's estimator prepared and driven through the
    checked epochs by its driver; returns ``(loop, program)``: the loop
    whose ``epoch()`` the window calls and ``[D0, (D, C, B) after each
    checked epoch]``."""
    return drivers.of(cfg).prepare(cfg, traffic, data_seed, est_seed,
                                   device)


def reference(cfg, data_seed, est_seed, device, precision=None):
    """The plain reference on the same data, remade from the seed by the
    driver, in ``precision`` (the driver's default where None)."""
    kw = {} if precision is None else dict(precision=precision)
    return drivers.of(cfg).reference(cfg, data_seed, est_seed, device, **kw)


def free(device):
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def run_cell(bench, cell, seed, seconds, trace, device, t0, cfg=None):
    """One run of ``cell`` (a ``workloads`` entry); returns ``(result,
    checks)``: the result line's object and ``{name: (value, limit)}``.
    ``cfg`` replaces the cell's configuration (tests, at a small size)."""
    cfg = cfg or load_config(bench, cell['config'])
    traffic = load_traffic(cell['traffic'])
    limits = load_limits(cell['name'])
    data_seed, est_seed = split_seed(seed)
    loop, program = prepare(cfg, traffic, data_seed, est_seed, device)
    setup_s = time.perf_counter() - t0

    marks, prof = run_window(loop, seconds, trace, device)
    info = device_info(device)
    n_epochs = len(marks) - 1
    window_s = marks[-1] - marks[0]
    metrics = {}
    traced = prof is not None
    if not traced:
        values = {
            'samples_per_s': n_epochs * cfg['n_samples'] / window_s,
            'epoch_ms_p95': p95(epoch_ms(marks)),
            'peak_mem_gib': info['memory_peak_bytes'] / 2 ** 30,
            'setup_s': setup_s,
        }
        for m in cell_metrics(bench, cell['name'], 'end_to_end'):
            metrics[m['name']] = dict(value=values[m['name']], unit=m['unit'])
    else:
        view = TraceView(prof, cfg, device_peaks(info['kind']),
                         drivers.of(cfg).work(cfg, loop))
        del prof
        for m in cell_metrics(bench, cell['name'], 'per_layer'):
            value = metric_reader(m['name'])(view)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
        info.update(busy_s=view.busy_ns / 1e9, window_s=view.window_ns / 1e9)
        breakdown = dict(device_ops=view.top_ops(), idle_gaps=view.idle_gaps())
        del view

    # the reference, once the program's state is freed
    del loop
    free(device)
    if info['platform'] == 'gpu':
        info['power_limit_w'] = power_limit()
    numbers = drivers.of(cfg).compare(program, reference(
        cfg, data_seed, est_seed, device))
    compared = {name: (numbers[name], limits[name]) for name in limits}
    result = dict(correct=all(v <= lim for v, lim in compared.values()),
                  attempted=n_epochs, failed=0, metrics=metrics, device=info)
    if traced:
        result['breakdown'] = breakdown
    result['checks'] = {name: dict(value=v, limit=lim)
                        for name, (v, lim) in compared.items()}
    return result, compared


def forbidden_modules():
    return sorted({name.split('.')[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(args, t0):
    """The command's run: returns the exit code."""
    bench = load_benchmark()
    cell = find(bench['workloads'], args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell['chips']:
        print(f'perfbench: {args.workload} needs {cell["chips"]} CUDA '
              f'device(s), found {have}', file=sys.stderr)
        return 2
    result, compared = run_cell(bench, cell, args.seed, args.seconds,
                                bool(args.trace), 'cuda', t0)
    loaded = forbidden_modules()
    if loaded:
        print(f'perfbench: the run loaded {", ".join(loaded)}',
              file=sys.stderr)
        return 3
    for name, (value, limit) in compared.items():
        print(f'check {name} {value!r} limit {limit!r}', file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
