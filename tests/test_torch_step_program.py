"""The SOMF step as one device program (``decomposition/_program.py``)
and the step body it captures, on the CPU at small sizes.

- the step body (scalars as 0-d tensors, every leaf written in place)
  against modl_tpu's ``somf_step_inner`` with injected subsets and
  orders: every aggregator, Binomial sizes on and off, ridge and FISTA
  codes, float64 (atol 1e-9, the bar of tests/test_reference_parity.py)
  and float32 (relative 1e-4: f32 sums in another order, carried
  through the steps and the solver's stop);
- ``StepProgram.run`` on the CPU (the body on its static buffers)
  bitwise equal to eager ``somf_step_inner`` calls with the same draws,
  and a fit through the program bitwise equal to the eager fit;
- a capture-safety audit: every op the body dispatches and its
  non-tensor arguments, identical for two steps with different draws,
  and no read of a device value (ridge codes on per-row Grams too,
  through ``ops.solvers.spd_solve``);
- every leaf keeps its address across a step;
- ``capturable`` over the configurations;
- the estimator drops and rebuilds its program after ``set_params``,
  ``shuffle``, unpickling and a replaced leaf;
- the draws' staging: the layout round trip, the ring's wait before it
  reuses a slot, and on a CUDA-typed path (pinned memory, events and the
  copies stood in for here) one non-blocking copy a step from pinned
  memory and no other copy to a device.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

import jax
import jax.numpy as jnp

from modl_tpu import DictFact as JaxDictFact
from modl_tpu.decomposition._step import somf_step_inner as jax_step_inner
from modl_tpu_torch import DictFact
from modl_tpu_torch.decomposition import _program, _step
from modl_tpu_torch.ops import bcd, solvers
from torch_parity import (assert_rel_close, assert_states_close,
                          clone_state, planted, port_config, port_state)

T = torch.as_tensor
jax_step = jax.jit(jax_step_inner, static_argnames='cfg')
FIELDS = ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg', 'G_avg')
LEAVES = FIELDS + ('sample_n_iter',)


def _jax_df(dtype, rand_size, agg, code, n=24, seed=0):
    X = np.random.RandomState(seed).randn(60, n).astype(dtype)
    df = JaxDictFact(n_components=5, reduction=3, code_alpha=0.1,
                     code_l1_ratio=1.0 if code == 'fista' else 0.0,
                     comp_l1_ratio=1.0, code_solver='fista', tol=1e-3,
                     Dx_agg=agg, G_agg=agg, batch_size=12, random_state=0,
                     rand_size=rand_size, dtype=dtype)
    df.prepare(n_samples=60, X=X)
    return df, X


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('rand_size', [False, True])
@pytest.mark.parametrize('agg', ['masked', 'full', 'average'])
@pytest.mark.parametrize('code', ['ridge', 'fista'])
def test_body_matches_jax(dtype, rand_size, agg, code):
    """Three steps from one carried state with the same injected subsets
    (``len_max`` wide and a Binomial size under ``rand_size``), sample
    indices and orders."""
    df, X = _jax_df(dtype, rand_size, agg, code)
    cfg = df._cfg
    assert cfg.rand_size == rand_size
    rng = np.random.RandomState(1)
    st_jax, st = df._state, port_state(df)
    cfg_port = port_config(df)
    k, b, n = cfg.n_components, df.batch_size, X.shape[1]
    width = cfg.len_max if rand_size else cfg.len_subset
    for _ in range(3):
        idx = rng.permutation(60)[:b]
        subset = rng.permutation(n)[:width]
        order = rng.permutation(k)
        n_valid = int(rng.randint(cfg.len_subset // 2, width + 1)) \
            if rand_size else None
        st_jax = jax_step(st_jax, jnp.asarray(X[idx]),
                          jnp.asarray(idx, jnp.int32),
                          jnp.asarray(subset, jnp.int32),
                          jnp.asarray(order, jnp.int32), cfg,
                          n_valid=None if n_valid is None
                          else jnp.asarray(n_valid, jnp.int32))
        st = _step.somf_step_inner(st, T(X[idx]), T(idx), T(subset),
                                   T(order), cfg_port, n_valid=n_valid)
    assert st.n_iter == int(st_jax.n_iter)
    np.testing.assert_array_equal(st.sample_n_iter.numpy(),
                                  np.asarray(st_jax.sample_n_iter))
    if dtype == np.float64:
        assert_states_close(st, st_jax, FIELDS)
    else:
        # comp_norm, a near-zero residual of the l1 ball, at atol 1e-5
        # (tests/test_torch_step.py's kernel-path bar)
        assert_states_close(st, st_jax, ('comp_norm',), atol=1e-5)
        for name in FIELDS[:-4] + FIELDS[-3:]:
            if getattr(st, name) is not None:
                assert_rel_close(getattr(st, name), getattr(st_jax, name),
                                 1e-4, name)


def _port_df(dtype=np.float32, rand_size=True, agg='masked', code='fista',
             optimizer='variational', n=24, **kw):
    """A port DictFact on the CPU, prepared, and its configuration with
    the kernels on (``use_kernel``: on the CPU their plain versions)."""
    X = planted(60, n, k=4, seed=2, dtype=dtype)
    df = DictFact(n_components=5, reduction=3, code_alpha=0.1,
                  code_l1_ratio=1.0 if code == 'fista' else 0.0,
                  comp_l1_ratio=1.0, code_solver='fista', tol=1e-3,
                  Dx_agg=agg, G_agg=agg, batch_size=12, random_state=0,
                  rand_size=rand_size, optimizer=optimizer, device='cpu',
                  **kw)
    df.prepare(n_samples=60, X=X)
    return df, X, dataclasses.replace(df._cfg, use_kernel=True)


CONFIGS = [dict(), dict(rand_size=False, agg='full', code='ridge'),
           dict(agg='average'), dict(agg='full'),
           dict(optimizer='sgd', code='ridge', rand_size=False),
           dict(agg='average', code='ridge')]


def _batches(X, b, n_steps, seed=3):
    rng = np.random.RandomState(seed)
    Xt = torch.as_tensor(X)
    for _ in range(n_steps):
        idx = torch.as_tensor(rng.permutation(X.shape[0])[:b])
        yield Xt[idx], idx


@pytest.mark.parametrize('kw', CONFIGS)
def test_program_run_bitwise_equal_to_eager_steps(kw):
    df, X, cfg = _port_df(**kw)
    assert _program.capturable(cfg)
    eager, staged = clone_state(df._state), clone_state(df._state)
    b = df.batch_size
    prog = _program.StepProgram(staged, cfg, b)
    for X_b, idx in _batches(X, b, 5):
        subset, n_valid, order = _step.draw_step(eager, cfg)
        _step.somf_step_inner(eager, X_b, idx, subset, order.to(torch.int32),
                              cfg, n_valid=n_valid)
        subset, n_valid, order = _step.draw_step(staged, cfg)
        prog.stage(X_b, idx, (subset, order),
                   _step.step_scalars(staged, cfg, b, n_valid))
        prog.run()
    assert prog.graph is None           # the CPU runs the body itself
    assert staged.n_iter == eager.n_iter == 5 * b
    for name in LEAVES:
        a, e = getattr(staged, name), getattr(eager, name)
        assert (a is None) == (e is None), name
        if a is not None:
            assert torch.equal(a, e), name


class _Recorder(TorchDispatchMode):
    """Every dispatched op with its non-tensor arguments (a tensor stands
    as its shape and dtype)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def spec(x):
            if isinstance(x, torch.Tensor):
                return ('tensor', tuple(x.shape), x.dtype)
            return x
        self.ops.append((str(func), tree_map(spec, args),
                         tree_map(spec, kwargs)))
        return func(*args, **kwargs)


def _kernel_stand_ins(monkeypatch):
    """The two kernels' wrappers as dispatch sees them on the card: their
    outputs allocated (the launch is a ctypes call dispatch never sees)."""
    def bcd_update(D, grad, C, comp_norm, order=None, comp_pos=False,
                   l1_ratio=0.0):
        return (torch.empty_like(D).copy_(D),
                torch.empty_like(comp_norm).copy_(comp_norm))

    def fista_gram(w0, Q, q, y_norm2, l1_reg, l2_reg, positive, max_iter,
                   tol, agree=None):
        return torch.empty_like(q).copy_(w0)
    monkeypatch.setattr(bcd, 'bcd_update', bcd_update)
    monkeypatch.setattr(solvers, 'fista_gram', fista_gram)


WINDOWED = dict(subset_sampling='window')


@pytest.mark.parametrize('kw', CONFIGS[:4] + [
    dict(blocks=True), WINDOWED,
    dict(WINDOWED, rand_size=False, agg='full', code='ridge'),
    dict(WINDOWED, agg='average'), dict(WINDOWED, blocks=True),
    dict(agg='average', code='ridge')])
def test_body_is_capture_safe(kw, monkeypatch):
    """Two steps with different draws (subsets or window starts, orders,
    Binomial sizes, weights) dispatch the same ops with the same
    non-tensor arguments, which is what a graph's baked arguments need;
    neither reads a device value back, nor makes a tensor of host data
    (``lift_fresh``: a capture would bake its value, or refuse its copy
    to the card). ``blocks``: the BCD block driver (two rows a kernel
    call)."""
    _kernel_stand_ins(monkeypatch)
    if kw.pop('blocks', False):
        monkeypatch.setattr(bcd, 'MAX_ROWS', 2)
    df, X, cfg = _port_df(**kw)
    if cfg.windowed:
        X = df._ingest_features(T(X)).numpy()
    state = clone_state(df._state)
    prog = _program.StepProgram(state, cfg, df.batch_size)
    runs = []
    for X_b, idx in _batches(X, df.batch_size, 2):
        subset, n_valid, order = _step.draw_step(state, cfg)
        prog.stage(X_b, idx, (subset, order),
                   _step.step_scalars(state, cfg, df.batch_size, n_valid))
        runs.append((subset, n_valid, order, prog.scalars.clone()))
        with _Recorder() as rec:
            prog.run()
        runs[-1] += (rec.ops,)
    (s0, v0, o0, w0, ops0), (s1, v1, o1, w1, ops1) = runs
    assert not torch.equal(T(s0), T(s1)) and not torch.equal(w0, w1)
    assert len(ops0) > 30
    assert ops0 == ops1
    names = {op[0] for op in ops0}
    assert not any('_local_scalar_dense' in n or 'item' in n
                   or 'lift_fresh' in n for n in names)


def _addresses(state):
    return {name: getattr(state, name).data_ptr() for name in LEAVES
            if getattr(state, name) is not None}


@pytest.mark.parametrize('kw', [dict(), dict(agg='full', code='ridge'),
                                dict(agg='average'),
                                dict(optimizer='sgd', code='ridge')])
def test_leaves_keep_their_addresses(kw):
    """Eager steps (the plain BCD, the kernel path, and windowed storage)
    and a program's step write every leaf in place."""
    df, X, cfg = _port_df(**kw)
    state = df._state
    before = _addresses(state)
    for config in (df._cfg, cfg):
        for X_b, idx in _batches(X, df.batch_size, 2):
            _step.somf_step(state, X_b, idx, config)
    prog = _program.StepProgram(state, cfg, df.batch_size)
    for X_b, idx in _batches(X, df.batch_size, 2):
        prog.step(X_b, idx)
    assert _addresses(state) == before
    assert prog.holds(state, cfg, df.batch_size)


def test_windowed_step_keeps_leaf_addresses():
    X = planted(120, 200, k=4, seed=4, dtype=np.float32)
    df = DictFact(n_components=5, reduction=8, code_alpha=1e-3,
                  code_l1_ratio=0.0, batch_size=20, random_state=0,
                  subset_sampling='window', device='cpu')
    df.prepare(n_samples=120, X=X)
    assert df._cfg.windowed
    before = _addresses(df._state)
    Xw = df._ingest_features(torch.as_tensor(X))
    for X_b, idx in _batches(Xw.numpy(), 20, 3):
        _step.somf_step(df._state, X_b, idx, df._cfg)
    assert _addresses(df._state) == before


def _cfg(**changes):
    base = _step.SomfConfig(
        n_components=4, len_subset=8, reduction=3.0, Dx_agg='masked',
        G_agg='masked', optimizer='variational', learning_rate=0.9,
        sample_learning_rate=0.76, step_size=1.0, code_alpha=0.1,
        code_l1_ratio=1.0, comp_l1_ratio=0.0, code_pos=False,
        comp_pos=False, tol=1e-2, max_iter=10, replacement=True,
        rand_size=True, len_max=12, use_kernel=True, code_solver='fista')
    return dataclasses.replace(base, **changes)


@pytest.mark.parametrize('changes,expected', [
    (dict(), True),
    (dict(rand_size=False, len_max=8), True),
    (dict(optimizer='sgd'), True),
    (dict(Dx_agg='full', G_agg='full'), True),
    (dict(Dx_agg='average', G_agg='average'), True),
    (dict(code_l1_ratio=0.0, code_solver='cd'), True),
    (dict(code_l1_ratio=0.0, Dx_agg='average'), True),
    (dict(code_l1_ratio=0.0, G_agg='average'), True),
    (dict(code_solver='cd'), False),
    (dict(windowed=True, n_features=24), True),
    (dict(windowed=True, n_features=24, rand_size=False, len_max=8), True),
    (dict(windowed=True, n_features=24, code_solver='cd'), False),
    (dict(average_offload=True), False),
    (dict(mesh=object()), False),
    (dict(use_kernel=False), False),
    (dict(optimizer='adam'), False),
])
def test_capturable(changes, expected):
    assert _program.capturable(_cfg(**changes)) is expected


class KernelDictFact(DictFact):
    """DictFact with the kernels' switch on, as on the card (on the CPU
    the wrappers run their plain versions), so its steps take the step
    program."""

    def _make_config(self, *args, **kwargs):
        return dataclasses.replace(super()._make_config(*args, **kwargs),
                                   use_kernel=True)


def _called_back(est):
    pass


def _kernel_df(**kw):
    X = planted(80, 24, k=4, seed=5, dtype=np.float32)
    df = KernelDictFact(n_components=5, reduction=3, code_alpha=0.1,
                        code_solver='fista', batch_size=16, random_state=0,
                        callback=_called_back, device='cpu', **kw)
    df.prepare(n_samples=80, X=X)
    return df, X


def test_estimator_steps_through_the_program():
    """A partial_fit with a callback takes the program for its full
    batches and steps a short last batch eagerly; the fit is bitwise
    that of the eager steps."""
    df, X = _kernel_df()
    ref, _ = _kernel_df()
    steps = _program.STEPS
    df.partial_fit(X[:72])
    assert _program.STEPS - steps == 4          # 4 of 16 rows, then 8
    prog = df._program
    assert prog is not None and prog.batch_size == 16
    saved = _program.capturable
    _program.capturable = lambda cfg: False
    try:
        ref.partial_fit(X[:72])
    finally:
        _program.capturable = saved
    assert ref._program is None
    for name in LEAVES:
        a, e = getattr(df._state, name), getattr(ref._state, name)
        if a is not None:
            assert torch.equal(a, e), name
    df.partial_fit(X[:32])
    assert df._program is prog                  # kept across calls


def test_program_is_rebuilt_after_invalidation():
    df, X = _kernel_df()
    df.partial_fit(X[:32])
    first = df._program
    df.set_params(reduction=2)
    assert df._program is None
    df.partial_fit(X[:32])
    second = df._program
    assert second is not first and second.cfg == df._cfg
    assert second.cfg.len_subset != first.cfg.len_subset
    # shuffle permutes the per-sample leaves in place: the program holds
    df.shuffle()
    assert df._program is second
    assert second.holds(df._state, df._cfg, df.batch_size)
    df.partial_fit(X[:32])
    third = df._program
    assert third is second
    # a leaf replaced behind the estimator's back
    df._state.code = df._state.code.clone()
    assert not third.holds(df._state, df._cfg, df.batch_size)
    df.partial_fit(X[:32])
    assert df._program is not third
    blob = pickle.dumps(df)
    assert b'StepProgram' not in blob
    twin = pickle.loads(blob)
    assert getattr(twin, '_program', None) is None
    twin.partial_fit(X[:32])
    df.partial_fit(X[:32])
    assert twin._program is not None and twin._program.state is twin._state
    np.testing.assert_array_equal(twin.components_, df.components_)


@pytest.mark.parametrize('dtype,width', [(torch.float32, 7),
                                         (torch.float64, 7),
                                         (torch.float32, 0)])
def test_draw_layout_round_trip(dtype, width):
    layout = _step.DrawLayout(width, 5, dtype)
    subset = torch.arange(100, 100 + width)
    order = torch.randperm(5)
    scalars = np.arange(1, 1 + _step.N_SCALARS,
                        dtype=str(dtype).removeprefix('torch.')) / 7
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    layout.fill(buf.numpy(), subset, order, scalars)
    got_subset, got_order, got_scalars = layout.views(buf)
    if width:
        assert torch.equal(got_subset, subset)
    else:
        assert got_subset is None
    assert got_order.dtype == torch.int32
    assert torch.equal(got_order, order.to(torch.int32))
    assert got_scalars.dtype == dtype
    np.testing.assert_array_equal(got_scalars.numpy(), scalars)


class _Event:
    log = []

    def record(self):
        _Event.log.append(('record', id(self)))

    def synchronize(self):
        _Event.log.append(('wait', id(self)))


@pytest.fixture
def cuda_typed(monkeypatch):
    """Pinned memory, CUDA events and copies to 'cuda' stood in for on the
    CPU: ``torch.empty(pin_memory=True)`` gives a tensor remembered as
    pinned, events log their records and waits, and ``Tensor.to`` /
    ``Tensor.copy_`` log every copy that names a device or reads a pinned
    tensor (a copy to 'cuda' gives a CPU clone)."""
    pinned, copies = set(), []
    real_empty, real_to, real_copy = torch.empty, torch.Tensor.to, \
        torch.Tensor.copy_

    def empty(*args, pin_memory=False, **kwargs):
        t = real_empty(*args, **kwargs)
        if pin_memory:
            pinned.add(t.untyped_storage().data_ptr())
        return t

    def is_pinned(t):
        return t.untyped_storage().data_ptr() in pinned

    def to(self, *args, **kwargs):
        device = kwargs.get('device')
        for a in args:
            if isinstance(a, (str, torch.device)):
                device = a
        if device is None:
            return real_to(self, *args, **kwargs)
        copies.append(('to', torch.device(device).type,
                       bool(kwargs.get('non_blocking')), is_pinned(self)))
        if torch.device(device).type == 'cuda':
            return self.clone()
        return real_to(self, *args, **kwargs)

    def copy_(self, src, non_blocking=False):
        if is_pinned(src):
            copies.append(('copy_', self.device.type, bool(non_blocking),
                           True))
        return real_copy(self, src, non_blocking)

    monkeypatch.setattr(torch, 'empty', empty)
    monkeypatch.setattr(torch.cuda, 'Event', _Event)
    monkeypatch.setattr(torch.Tensor, 'to', to)
    monkeypatch.setattr(torch.Tensor, 'copy_', copy_)
    _Event.log = []
    return copies


@pytest.mark.parametrize('windowed', [False, True])
def test_eager_step_sends_draws_without_blocking(windowed, cuda_typed):
    """``somf_step`` on a CUDA-typed path: the draws reach the device in
    one non-blocking copy a step from a pinned slot, and nothing else is
    copied to a device (the blocking ``.to(device)`` of the subset and
    the order stay gone)."""
    X = planted(120, 200, k=4, seed=6, dtype=np.float32)
    df = DictFact(n_components=5, reduction=8, code_alpha=1e-3,
                  code_l1_ratio=0.0, batch_size=20, random_state=0,
                  subset_sampling='window' if windowed else 'gather',
                  device='cpu')
    df.prepare(n_samples=120, X=X)
    assert df._cfg.windowed == windowed
    Xd = df._ingest_features(torch.as_tensor(X))
    staging = _step.DrawStaging('cuda')
    for X_b, idx in _batches(Xd.numpy(), 20, 3):
        cuda_typed.clear()
        _step.somf_step(df._state, X_b, idx, df._cfg, staging)
        assert cuda_typed == [('to', 'cuda', True, True)]
    assert np.isfinite(df.components_).all()


def test_ring_waits_before_reusing_a_slot(cuda_typed):
    """The ring alternates its two slots and waits on a slot's event
    (its last copy) before writing the slot again; the program's stage
    copies into its static buffer without blocking."""
    df, X, cfg = _port_df()
    prog = _program.StepProgram(clone_state(df._state), cfg, df.batch_size)
    prog.staging = staging = _step.DrawStaging('cuda')
    for step, (X_b, idx) in enumerate(_batches(X, df.batch_size, 4)):
        cuda_typed.clear()
        subset, n_valid, order = _step.draw_step(prog.state, cfg)
        prog.stage(X_b, idx, (subset, order),
                   _step.step_scalars(prog.state, cfg, df.batch_size,
                                      n_valid))
        assert cuda_typed == [('copy_', 'cpu', True, True)]
        slot_event = id(staging.events[step % 2])
        assert _Event.log[-1] == ('record', slot_event)
        if step >= 2:
            assert _Event.log[-2] == ('wait', slot_event)
        else:
            assert ('wait', slot_event) not in _Event.log
    assert staging.slots[0].data_ptr() != staging.slots[1].data_ptr()
