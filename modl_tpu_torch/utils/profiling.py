"""Profiling helpers (counterpart of ``modl_tpu/utils/profiling.py``).

The estimators keep their own accounting (``time_``, ``io_time_`` /
``cpu_time_``). This module adds the device layer: a synchronising
scalar read, a ``torch.profiler`` trace with a summary of device time,
a step timer that reads CUDA events on the card and the host clock on
the CPU, and :func:`span`, the program's named ranges on the
profiler's clock.

The program's spans (``modl.*``), each around host work of an epoch:

- ``modl.draw``: the host generator's draws (an epoch's on the fused
  route, a step's in ``StepProgram.step``);
- ``modl.stage``: the scalars, the ring's copy, the rows' gather or
  copy into a program's buffers;
- ``modl.stage.wait``: the host waiting for the card to free a slot of
  ``DrawStaging``'s ring (inside ``modl.stage`` on the program routes);
- ``modl.run``: a program's replay (its body on the CPU; its capture at
  the first run);
- ``modl.capture``: a program's warm-up and capture;
- ``modl.sync``: the wait that ends ``DictFact``'s epoch call;
- ``modl.shuffle.perm``, ``modl.shuffle.gather``: ``DictFact.shuffle``'s
  permutation and its copy to the card, and the per-sample leaves'
  gathers.
"""
import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["sync", "span", "device_trace", "device_summary",
           "device_busy_s", "idle_gaps", "StepTimer"]

# what span gives while no profiler runs: one context shared by every call
_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs (a host event on the profiler's clock, beside the
    device's kernels and copies); otherwise one shared context that does
    nothing, so that a span off the profiler constructs nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
    draw counts too). The events are ``key_averages()``'s device rows,
    less the profiler's copies of the spans on the device's timeline."""
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type.name == 'CUDA' and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    reads = sum(e.count for e in events
                if e.key == 'aten::_local_scalar_dense')
    return busy, sum(e.count for e in device), reads, device


def _merged(spans):
    """Sorted ``(start, end)`` intervals with overlaps merged."""
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def device_busy_s(prof):
    """The seconds in which the device ran a kernel or a copy, from the
    profiler's raw events: their intervals merged, less the profiler's
    copies of the spans on the device's timeline (a pass over the
    events, where ``key_averages`` over an eager recsys epoch's ~10^5
    ops takes tens of seconds)."""
    busy = _merged((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type().name == 'CUDA'
                   and not e.is_user_annotation())
    return sum(end - start for start, end in busy) / 1e9


def idle_gaps(prof, min_ms):
    """``(count, ms)`` of the gaps of at least ``min_ms`` between the
    device's kernels and copies in a finished :func:`device_trace`
    (where the card sat idle, waiting for the host); the profiler's
    copies of the spans on the device's timeline do not fill a gap."""
    busy = _merged((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type.name == 'CUDA'
                   and not e.is_user_annotation)
    gaps = [s1 - e0 for (_, e0), (s1, _) in zip(busy, busy[1:])
            if s1 - e0 >= 1e3 * min_ms]
    return len(gaps), sum(gaps) / 1e3


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
