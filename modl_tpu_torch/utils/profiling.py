"""Profiling helpers (counterpart of ``modl_tpu/utils/profiling.py``).

The estimators keep their own accounting (``time_``, ``io_time_`` /
``cpu_time_``). This module adds the device layer: a synchronising
scalar read, a ``torch.profiler`` trace with a summary of device time,
and a step timer that reads CUDA events on the card and the host clock
on the CPU.
"""
import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["sync", "device_trace", "device_summary", "device_busy_s",
           "host_waits", "idle_gaps", "StepTimer"]

# the CUDA runtime's calls in which the host waits for the card
WAIT_CALLS = ('cudaDeviceSynchronize', 'cudaStreamSynchronize',
              'cudaEventSynchronize')


def _first_tensor(x):
    if torch.is_tensor(x):
        return x
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    elif not isinstance(x, (list, tuple)):
        return None
    for v in x:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def sync(x):
    """Wait for the device of the first tensor in ``x`` (a tensor, or a
    list, tuple, dict or dataclass holding one) and return one of its
    values as a Python float."""
    leaf = _first_tensor(x)
    if leaf.device.type == 'cuda':
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[:1].sum())


@contextlib.contextmanager
def device_trace(logdir, device='cuda'):
    """Profile the block with ``torch.profiler`` (host ops, and CUDA
    kernels and copies when ``device`` is CUDA) and write a Chrome trace,
    ``logdir/trace.json``. Yields the profiler: read it with
    :func:`device_summary`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def device_summary(prof):
    """(busy seconds, device ops, host reads, device events) of a finished
    :func:`device_trace`: the summed self time of the device's kernels
    and copies (one stream, so they do not overlap), their count, and
    the scalar reads by the host (``aten::_local_scalar_dense``: of
    device and host tensors alike, so ``int()`` of a host generator's
    draw counts too; :func:`host_waits` counts the waits for the card).
    The events are ``key_averages()``'s device rows."""
    events = prof.key_averages()
    device = [e for e in events if e.device_type.name == 'CUDA']
    busy = sum(e.self_device_time_total for e in device) / 1e6
    reads = sum(e.count for e in events
                if e.key == 'aten::_local_scalar_dense')
    return busy, sum(e.count for e in device), reads, device


def device_busy_s(prof):
    """The busy seconds of :func:`device_summary`, summed from the
    profiler's raw events (each kernel and copy on the device once): a
    pass over the events, where ``key_averages`` over an eager recsys
    epoch's ~10^5 ops takes tens of seconds."""
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type().name == 'CUDA') / 1e9


def host_waits(prof):
    """The calls of a finished :func:`device_trace` in which the host
    waited for the card (``WAIT_CALLS``), by name."""
    return {e.key: e.count for e in prof.key_averages()
            if e.key in WAIT_CALLS}


def idle_gaps(prof, min_ms):
    """``(count, ms)`` of the gaps of at least ``min_ms`` between the
    device's kernels and copies in a finished :func:`device_trace`
    (where the card sat idle, waiting for the host)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == 'CUDA')
    count, total, end = 0, 0.0, None
    for start, stop in spans:
        if end is not None and start - end >= 1e3 * min_ms:
            count += 1
            total += start - end
        end = stop if end is None else max(end, stop)
    return count, total / 1e3


class StepTimer:
    """Sums the time of measured blocks: CUDA events around each block on
    the card (``device`` CUDA), the host clock on the CPU."""

    def __init__(self, device='cuda'):
        self.device = torch.device(device)
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self, result_fn=None):
        """Time the block; ``result_fn()``, when given, returns the
        block's result and is read with :func:`sync` inside the timing."""
        if self.device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            if result_fn is not None:
                sync(result_fn())
            stop.record()
            stop.synchronize()
            self.total += start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            yield
            if result_fn is not None:
                sync(result_fn())
            self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean(self):
        return self.total / max(self.count, 1)
