"""The readers of the program's spans (``metrics/_spans.py`` and the
seven metrics on it) on made-up profiler events, through
:class:`perfbench.harness.TraceView`, with their values worked out by
hand."""
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.metrics import (draw_idle_ms, run_idle_ms, shuffle_gather_ms,
                               shuffle_perm_ms, stage_idle_ms, stage_wait_ms,
                               sync_wait_ms)

US = 1_000
MS = 1_000_000
CFG = dict(n_samples=2000, estimator=dict(batch_size=100))
IDLE = (draw_idle_ms, stage_idle_ms, run_idle_ms)
HOST = (stage_wait_ms, sync_wait_ms, shuffle_perm_ms, shuffle_gather_ms)


def event(name, start, end, device='CPU', annotation=False):
    """A raw profiler event (``kineto_results.events()``), in ns."""
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start,
        duration_ns=lambda: end - start,
        device_type=lambda: SimpleNamespace(name=device),
        is_user_annotation=lambda: annotation)


def trace(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def epoch(t0, wait):
    """One fused epoch of 30 ms from ``t0`` and its shuffle of 1 ms: the
    draw [0, 4) ms with a copy of 0.5 ms inside; the stage [4, 6) with,
    where ``wait``, a ring wait [4, 4.5) and a copy of 0.2 ms; the run
    [6, 7), its first kernel at 6.6 and kernels to 29.5 (two overlap);
    the sync [7, 30); the shuffle's permutation [30, 30.4) and gathers
    [30.4, 30.9); the profiler's copy of the run on the device's timeline
    [6, 29.5), which is no work of the card's."""
    def at(ms):
        return t0 + round(ms * MS)
    out = [event('perfbench.epoch', at(0), at(30)),
           event('modl.draw', at(0), at(4)),
           event('Memcpy HtoD', at(1), at(1.5), 'CUDA'),
           event('modl.stage', at(4), at(6)),
           event('Memcpy HtoD (Pinned)', at(5), at(5.2), 'CUDA'),
           event('modl.run', at(6), at(7)),
           event('cudaGraphLaunch', at(6.1), at(6.9)),
           event('modl.run', at(6), at(29.5), 'CUDA', annotation=True),
           event('bcd_kernel', at(6.6), at(20), 'CUDA'),
           event('gemm', at(19), at(29.5), 'CUDA'),
           event('modl.sync', at(7), at(30)),
           event('perfbench.shuffle', at(30), at(31)),
           event('modl.shuffle.perm', at(30), at(30.4)),
           event('Memcpy HtoD', at(30.3), at(30.35), 'CUDA'),
           event('modl.shuffle.gather', at(30.4), at(30.9))]
    if wait:
        out.append(event('modl.stage.wait', at(4), at(4.5)))
    return out


def test_span_readers_on_two_made_up_epochs():
    """Two epochs, one with a ring wait: the card idle 3.5 ms in each
    draw, 1.8 in each stage, 0.6 in each run; the host 0.5 ms in one
    wait, 23 in each sync, 0.4 and 0.5 in each shuffle's parts."""
    view = harness.TraceView(
        trace(epoch(0, wait=True) + epoch(31 * MS, wait=False)), CFG, None)
    assert len(view.epochs) == 2
    assert draw_idle_ms.read(view) == pytest.approx(3.5)
    assert stage_idle_ms.read(view) == pytest.approx(1.8)
    assert run_idle_ms.read(view) == pytest.approx(0.6)
    assert stage_wait_ms.read(view) == pytest.approx(0.25)
    assert sync_wait_ms.read(view) == pytest.approx(23.0)
    assert shuffle_perm_ms.read(view) == pytest.approx(0.4)
    assert shuffle_gather_ms.read(view) == pytest.approx(0.5)


def test_span_readers_find_nothing_without_spans_or_card():
    """A program without the spans (the harness's own spans only): every
    reader None. A trace with the spans but no device event: the idle
    readers None, the host readers their values."""
    bare = [e for e in epoch(0, wait=True)
            if not e.name().startswith('modl.')]
    view = harness.TraceView(trace(bare), CFG, None)
    for reader in IDLE + HOST:
        assert reader.read(view) is None
    host_only = [e for e in epoch(0, wait=True)
                 if e.device_type().name != 'CUDA']
    view = harness.TraceView(trace(host_only), CFG, None)
    for reader in IDLE:
        assert reader.read(view) is None
    assert [reader.read(view) for reader in HOST] == pytest.approx(
        [0.5, 23.0, 0.4, 0.5])


def test_idle_reader_counts_a_span_split_by_kernels():
    """A 10 us span with kernels over [2, 4) and [3, 6) us (overlapping)
    and [8, 12) us: idle 2 + 2 = 4 us of it."""
    events = [event('perfbench.epoch', 0, 20 * US),
              event('modl.run', 0, 10 * US),
              event('k1', 2 * US, 4 * US, 'CUDA'),
              event('k2', 3 * US, 6 * US, 'CUDA'),
              event('k3', 8 * US, 12 * US, 'CUDA'),
              event('perfbench.shuffle', 20 * US, 21 * US)]
    view = harness.TraceView(trace(events), CFG, None)
    assert run_idle_ms.read(view) == pytest.approx(0.004)


def test_window_ends_at_the_last_epoch_or_shuffle_or_device_event():
    """The window runs from the first epoch's start to the latest of the
    last epoch span, the last shuffle span and the last device event: a
    driver without shuffle spans (``recsys``) still has one, and the
    fused epochs' window is as before (it ends at their last shuffle)."""
    no_shuffle = [event('perfbench.epoch', 0, 10 * MS),
                  event('k1', 2 * MS, 4 * MS, 'CUDA'),
                  event('perfbench.epoch', 10 * MS, 20 * MS),
                  event('k2', 12 * MS, 14 * MS, 'CUDA')]
    view = harness.TraceView(trace(no_shuffle), CFG, None)
    assert view.window == (0, 20 * MS) and view.shuffles == []
    late = no_shuffle + [event('k3', 19 * MS, 21 * MS, 'CUDA')]
    assert harness.TraceView(trace(late), CFG, None).window == (0, 21 * MS)
    fused = epoch(0, wait=True) + epoch(31 * MS, wait=False)
    assert harness.TraceView(trace(fused), CFG, None).window == (0, 62 * MS)
