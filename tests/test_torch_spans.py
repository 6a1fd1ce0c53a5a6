"""The program's spans (``utils/profiling.span``, ``modl.*``) on the CPU.

- ``span`` off the profiler is one shared context and constructs no
  ``record_function``, on the fused and the step routes alike; under a
  profiler it records a host event of its name;
- the fused route records one ``modl.draw``, ``modl.stage``, ``modl.run``
  and ``modl.sync`` an epoch, the step route one draw, stage and run a
  step and one sync a call;
- the ring's wait (``modl.stage.wait``) sits inside ``modl.stage`` once
  the ring has turned, and never before (pinned memory and events stood
  in for, as in ``test_torch_step_program.py``);
- ``shuffle`` records its two spans once each, and a program's body
  (``_step_body``, ``_scan_body``) records none, so the captured graphs
  stay as they were;
- ``device_busy_s``, ``idle_gaps`` and ``device_summary`` leave out the
  profiler's copies of the spans on the device's timeline and merge
  overlapping device intervals;
- a real CPU trace of fused epochs through ``perfbench``'s ``TraceView``
  and the seven span readers: host ms where the spans are, None for the
  card's idle ms, where the CPU trace has no device event.
"""
import contextlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modl_tpu_torch.decomposition import _program, _step
from modl_tpu_torch.utils import profiling
from modl_tpu_torch.utils.profiling import (device_busy_s, device_summary,
                                            idle_gaps, span)
from test_torch_step_program import (  # noqa: F401 (cuda_typed: fixture)
    KernelDictFact, _batches, _Event, _kernel_stand_ins, _port_df,
    cuda_typed)
from torch_parity import clone_state, planted

N, B = 80, 16            # five full batches an epoch, no short one
SPAN_METRICS = ('draw_idle_ms', 'stage_idle_ms', 'run_idle_ms',
                'stage_wait_ms', 'sync_wait_ms', 'shuffle_perm_ms',
                'shuffle_gather_ms')


def _est(**kw):
    X = planted(N, 24, k=4, seed=5, dtype=np.float32)
    est = KernelDictFact(n_components=5, reduction=3, code_alpha=0.1,
                         code_solver='fista', batch_size=B, random_state=0,
                         device='cpu', **kw)
    est.prepare(n_samples=N, X=X)
    return est, X


def _called_back(est):
    pass


@contextlib.contextmanager
def _traced():
    """A CPU profiler; yields the list it fills, at its exit, with the
    ``(name, start ns, end ns)`` of the ``modl.*`` events, by start."""
    found = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield found
    found.extend(sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith('modl.')), key=lambda s: s[1]))


def _names(found):
    return [name for name, _, _ in found]


def _refused(*args, **kwargs):
    raise AssertionError('record_function constructed with no profiler')


@pytest.mark.parametrize('interactive', [False, True])
def test_span_off_constructs_nothing(interactive, monkeypatch):
    """No profiler: every span is the one shared null context, and an
    epoch (fused, or stepped through the step program) and a shuffle
    construct no ``record_function``."""
    _kernel_stand_ins(monkeypatch)
    monkeypatch.setattr(torch.profiler, 'record_function', _refused)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function',
                        _refused)
    assert not torch.autograd._profiler_enabled()
    assert span('modl.draw') is span('modl.run')
    assert isinstance(span('modl.run'), contextlib.nullcontext)
    est, X = _est(callback=_called_back if interactive else None)
    steps, epochs = _program.STEPS, _program.EPOCHS
    est.partial_fit(X)
    est.shuffle()
    assert ((_program.STEPS - steps, _program.EPOCHS - epochs)
            == ((N // B, 0) if interactive else (0, 1)))


def test_span_on_is_recorded():
    with _traced() as found:
        assert torch.autograd._profiler_enabled()
        ctx = span('modl.test')
        assert isinstance(ctx, torch.profiler.record_function)
        with ctx:
            torch.ones(4).sum()
    assert _names(found) == ['modl.test']
    assert span('modl.test') is profiling._NO_SPAN


def test_fused_epoch_records_one_of_each(monkeypatch):
    """Each fused epoch: one draw, one stage, one run (the replay; the
    body on the CPU) and one sync, in that order, and no capture on the
    CPU."""
    _kernel_stand_ins(monkeypatch)
    est, X = _est()
    for _ in range(2):
        with _traced() as found:
            est.partial_fit(X)
        assert _names(found) == ['modl.draw', 'modl.stage', 'modl.run',
                                 'modl.sync']
    assert len(est._scans) == 1


def test_step_route_records_each_step(monkeypatch):
    """An interactive epoch (a callback, as with ``verbose``): one draw,
    stage and run a step through the step program, one sync a call."""
    _kernel_stand_ins(monkeypatch)
    est, X = _est(callback=_called_back)
    for _ in range(2):
        with _traced() as found:
            est.partial_fit(X)
        assert (_names(found)
                == ['modl.draw', 'modl.stage', 'modl.run'] * (N // B)
                + ['modl.sync'])
    assert est._program is not None


@pytest.mark.parametrize('route', ['step', 'scan'])
def test_ring_wait_sits_inside_the_stage(route, cuda_typed):
    """A program whose ring is CUDA-typed waits on a slot's event from the
    third send on: a ``modl.stage.wait`` inside that send's
    ``modl.stage``, and none before."""
    df, X, cfg = _port_df()
    state = clone_state(df._state)
    b = df.batch_size
    if route == 'step':
        prog = _program.StepProgram(state, cfg, b)
        sends = ((lambda X_b=X_b, idx=idx: prog.step(X_b, idx))
                 for X_b, idx in _batches(X, b, 4))
    else:
        T = X.shape[0] // b
        prog = _program.ScanProgram(state, cfg, T, b)
        Xt, idx = torch.as_tensor(X), torch.arange(X.shape[0])
        sends = (lambda: prog.stage(Xt, idx, _step.draw_epoch(state, cfg, T))
                 for _ in range(4))
    prog.staging = _step.DrawStaging('cuda')
    for n, send in enumerate(sends):
        with _traced() as found:
            send()
        stages = [s for s in found if s[0] == 'modl.stage']
        waits = [s for s in found if s[0] == 'modl.stage.wait']
        assert len(stages) == 1
        if n < 2:
            assert waits == []
        else:
            (_, s0, e0), = stages
            (_, s1, e1), = waits
            assert s0 <= s1 <= e1 <= e0
            assert _Event.log[-2][0] == 'wait'


def test_shuffle_spans_and_no_span_in_a_body(monkeypatch):
    """``shuffle``: its permutation, then its gathers, once each. A
    program's body, called under the profiler, records no span."""
    _kernel_stand_ins(monkeypatch)
    est, X = _est()
    est.partial_fit(X)
    with _traced() as found:
        est.shuffle()
    assert _names(found) == ['modl.shuffle.perm', 'modl.shuffle.gather']
    (_, s0, e0), (_, s1, e1) = found
    assert e0 <= s1

    df, X, cfg = _port_df()
    b = df.batch_size
    step = _program.StepProgram(clone_state(df._state), cfg, b)
    (X_b, idx), = _batches(X, b, 1)
    step.step(X_b, idx)
    T = X.shape[0] // b
    scan = _program.ScanProgram(clone_state(df._state), cfg, T, b)
    scan.stage(torch.as_tensor(X), torch.arange(X.shape[0]),
               _step.draw_epoch(scan.state, cfg, T))
    for prog in (step, scan):
        with _traced() as found:
            prog.body()
        assert found == []


def _raw(device, start, end, name='k', annotation=False):
    """A raw (kineto) event of the profiler, in ns."""
    return types.SimpleNamespace(
        device_type=lambda: types.SimpleNamespace(name=device),
        start_ns=lambda: start, duration_ns=lambda: end - start,
        is_user_annotation=lambda: annotation, name=lambda: name)


def _fn_event(device, start, end, annotation=False, key='k', self_us=0):
    """A ``FunctionEvent`` (us) or a ``key_averages`` row."""
    return types.SimpleNamespace(
        device_type=types.SimpleNamespace(name=device), key=key, count=1,
        time_range=types.SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation, self_device_time_total=self_us)


def test_busy_and_gaps_leave_out_annotations_and_merge_overlaps():
    """Kernels at [0, 1,000), [500, 1,500) and [4,000, 5,000) us under a
    device-side ``modl.run`` annotation over [0, 6,000): 2.5 ms busy,
    one gap of 2.5 ms; the annotation and a host event count for
    nothing."""
    ns = 1000
    raw = [_raw('CUDA', 0, 6000 * ns, 'modl.run', annotation=True),
           _raw('CUDA', 0, 1000 * ns), _raw('CUDA', 500 * ns, 1500 * ns),
           _raw('CPU', 0, 9000 * ns, 'modl.run', annotation=True),
           _raw('CUDA', 4000 * ns, 5000 * ns)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    assert device_busy_s(prof) == pytest.approx(0.0025, abs=1e-15)
    events = [_fn_event('CUDA', 0, 6000, annotation=True),
              _fn_event('CUDA', 0, 1000), _fn_event('CUDA', 500, 1500),
              _fn_event('CPU', 1500, 4000),
              _fn_event('CUDA', 4000, 5000)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert idle_gaps(prof, 1.0) == (1, 2.5)
    assert idle_gaps(prof, 3.0) == (0, 0.0)
    rows = [_fn_event('CUDA', 0, 0, annotation=True, key='modl.run',
                      self_us=6000),
            _fn_event('CUDA', 0, 0, key='bcd_kernel', self_us=2000)]
    prof = types.SimpleNamespace(key_averages=lambda: rows)
    busy, ops, reads, device = device_summary(prof)
    assert (busy, ops, reads, [e.key for e in device]) == \
        (0.002, 1, 0, ['bcd_kernel'])


def test_span_readers_on_a_cpu_trace(monkeypatch, cuda_typed):
    """``perfbench``'s epoch loop over ingested rows, traced on the CPU for
    three fused epochs after one of set-up, its ring CUDA-typed so that
    the third traced epoch waits on a slot: the host-ms readers read
    their spans, the idle readers None (no device event)."""
    from perfbench import harness
    from perfbench.metrics import _spans
    _kernel_stand_ins(monkeypatch)
    est, X = _est()
    loop = harness.FitLoop(est, est._ingest_features(torch.as_tensor(X)))
    loop.epoch()
    (prog,) = est._scans.values()
    prog.staging = _step.DrawStaging('cuda')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            loop.epoch()
    cfg = dict(n_samples=N, estimator=dict(batch_size=B))
    view = harness.TraceView(prof, cfg, None)
    assert len(view.epochs) == len(view.shuffles) == 3 and not view.device
    values = {name: harness.metric_reader(name)(view)
              for name in SPAN_METRICS}
    assert {name for name, v in values.items() if v is None} == {
        'draw_idle_ms', 'stage_idle_ms', 'run_idle_ms'}
    for name in ('sync_wait_ms', 'shuffle_perm_ms', 'shuffle_gather_ms',
                 'stage_wait_ms'):
        assert values[name] >= 0
    waits = _spans.spans(view, 'modl.stage.wait')
    assert len(waits) == 1
    assert values['stage_wait_ms'] == pytest.approx(
        (waits[0][1] - waits[0][0]) / 3 / 1e6)
    perm = _spans.spans(view, 'modl.shuffle.perm')
    assert len(perm) == 3
    assert values['shuffle_perm_ms'] == pytest.approx(
        sum(e - s for s, e in perm) / 3 / 1e6)
