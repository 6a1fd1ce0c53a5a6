"""The fused epoch as one device program (``_program.ScanProgram``) and
what it needs of the step, on the CPU at small sizes.

- the write-back of a window whose start is a device value (two index
  copies) bitwise equal to the three slice copies of a host start and to
  a numpy form of the JAX package's "purewrite" chain, for every start;
- the windowed step body with a device start against modl_tpu's
  ``somf_step_inner`` with the same start and order (float64, rtol
  1e-9): the head overlap, the interior and a wrap, every aggregator,
  ridge and FISTA codes, Binomial sizes on and off;
- ``ScanProgram.run`` on the CPU (the body on its static buffers) over
  T = 8 steps, which its deferred-B segments do not divide, against
  modl_tpu's deferred step chain (float64, rtol 1e-9) and bitwise
  against the port's eager ``somf_scan`` on the same draws; the host
  generator and sample counter advance alike;
- a capture-safety audit of whole epochs (windowed with its segment
  ends, gather, the BCD block driver): two epochs with different draws
  dispatch the same ops with the same non-tensor arguments and read no
  device value;
- ``pi`` as a 0-d tensor in the EMA-GEMM's plain version and wrapper;
- the estimator's route: a windowed ``fit`` runs every epoch through one
  program, bitwise equal to the eager route; ``partial_fit`` builds one
  program a record length;
- the epoch's draws reach the device in one non-blocking copy from
  pinned memory.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modl_tpu import DictFact as JaxDictFact
from modl_tpu.decomposition._step import somf_step_inner as jax_step_inner
from modl_tpu_torch import DictFact
from modl_tpu_torch.decomposition import _program, _step
from modl_tpu_torch.ops import bcd, ema_gemm
from test_torch_step_program import (  # noqa: F401 (cuda_typed: fixture)
    KernelDictFact, _kernel_stand_ins, _Recorder, cuda_typed)
from torch_parity import (assert_states_close, clone_state, planted,
                          port_config, port_state, to_np)

T = torch.as_tensor
jax_step = jax.jit(jax_step_inner, static_argnames='cfg')
FIELDS = ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg', 'G_avg')
LEAVES = FIELDS + ('sample_n_iter',)


def _purewrite(D, V, start, n):
    """numpy form of the JAX package's windowed write-back ('purewrite',
    ``modl_tpu/decomposition/_step.py``): the window at ``start``, then
    the head after this step at column 0 and at the mirror (column n),
    computed from the head before the write by ``dynamic_slice``s of
    ``[0 | V | 0]`` (whose start clamps to the array)."""
    k, s = V.shape
    D = D.copy()
    head_pre = D[:, :s].copy()
    pad = np.concatenate([np.zeros((k, s)), V, np.zeros((k, s))], axis=1)

    def dslice(at):
        at = min(max(at, 0), 2 * s)
        return pad[:, at:at + s]

    col = np.arange(s)[None, :]
    head = np.where(col >= start, dslice(s - start), head_pre)
    head = np.where(col < start + s - n, dslice(s + n - start), head)
    D[:, start:start + s] = V
    D[:, :s] = head
    D[:, n:n + s] = head
    return D


@pytest.mark.parametrize('start', range(11))
@pytest.mark.parametrize('s', [1, 4, 5, 10])
def test_device_start_writeback_is_bitwise(s, start):
    """k = 3, n = 11: windows of 1 to 10 columns at every start, so the
    head, mirror and wrap ranges overlap in every way."""
    k, n = 3, 11
    rng = np.random.RandomState(s * 100 + start)
    D0 = rng.randn(k, n + s)
    D0[:, n:] = D0[:, :s]
    V = rng.randn(k, s)
    sliced, gathered = T(D0.copy()), T(D0.copy())
    _step._writeback_window(sliced, T(V), start, n)
    _step._writeback_window_at(gathered, T(V),
                               torch.tensor(start) + torch.arange(s), n)
    assert torch.equal(gathered, sliced)
    np.testing.assert_array_equal(gathered.numpy(),
                                  _purewrite(D0, V, start, n))
    np.testing.assert_array_equal(gathered[:, n:].numpy(),
                                  gathered[:, :s].numpy())


def _jax_windowed(agg, code, rand_size, reduction=4, n=400, seed=1,
                  n_samples=300):
    X = planted(n_samples, n, seed=seed)
    df = JaxDictFact(n_components=6, reduction=reduction, code_alpha=1e-3,
                     code_l1_ratio=1.0 if code == 'fista' else 0.0,
                     code_solver='fista', tol=1e-3, random_state=0,
                     batch_size=50, Dx_agg=agg, G_agg=agg,
                     rand_size=rand_size, subset_sampling='window')
    df.prepare(n_samples=n_samples, X=X)
    assert df._cfg.windowed and df._cfg.rand_size == rand_size
    return df, X


@pytest.mark.parametrize('rand_size', [True, False])
@pytest.mark.parametrize('code', ['ridge', 'fista'])
@pytest.mark.parametrize('agg', ['masked', 'full', 'average'])
def test_windowed_device_start_step_matches_jax(agg, code, rand_size):
    """Three steps from one carried state: a window over the head (the
    mirror refreshed), one inside and one that wraps (its tail folds into
    the head), each start a 0-d tensor on the port's side."""
    df, X = _jax_windowed(agg, code, rand_size)
    cfg = df._cfg
    n, s = 400, cfg.len_max if rand_size else cfg.len_subset
    rng = np.random.RandomState(2)
    st_jax, st = df._state, port_state(df)
    cfg_port = port_config(df)
    for step, start in enumerate((3, 117, n - s // 2)):
        idx = np.arange(step * 50, (step + 1) * 50)
        Xw = np.array(df._ingest_features(jnp.asarray(X[idx])))
        order = rng.permutation(6)
        n_valid = s - 7 if rand_size else None
        st_jax = jax_step(st_jax, jnp.asarray(Xw), jnp.asarray(idx, jnp.int32),
                          jnp.asarray(start, jnp.int32),
                          jnp.asarray(order, jnp.int32), cfg,
                          n_valid=None if n_valid is None
                          else jnp.asarray(n_valid, jnp.int32))
        st = _step.somf_step_inner(st, T(Xw), T(idx), torch.tensor(start),
                                   T(order), cfg_port, n_valid=n_valid)
    # planted data: C and B reach ~1e4, so roundoff is held relative
    assert_states_close(st, st_jax, FIELDS, rtol=1e-9)
    D = to_np(st.D)
    np.testing.assert_array_equal(D[:, n:], D[:, :s])


def _draws(cfg, n_steps, seed):
    """Injected draws: window starts over [0, n), Binomial sizes under
    ``rand_size``, atom orders."""
    rng = np.random.RandomState(seed)
    s = cfg.len_max if cfg.rand_size else cfg.len_subset
    sizes = (np.clip(rng.binomial(cfg.n_features, cfg.len_subset
                                  / cfg.n_features, n_steps), 1, s).tolist()
             if cfg.rand_size else [None] * n_steps)
    return _step.Draws(
        subsets=rng.randint(0, cfg.n_features, n_steps).tolist(),
        sizes=sizes, orders=T(np.stack([rng.permutation(cfg.n_components)
                                        for _ in range(n_steps)])))


def _jax_deferred_epoch(df, Xw, draws, seg, b):
    """modl_tpu's deferred step chain: per segment, its steps through
    ``somf_step_inner(..., deferred=(B0, Xseg, SC, pi, trow))``, then
    ``B = pi B0 + SC^T Xseg``."""
    cfg = df._cfg
    st = df._state
    n_steps = len(draws.subsets)
    for pos in range(0, n_steps, seg):
        L = min(seg, n_steps - pos)
        Xseg = Xw[pos * b:(pos + L) * b]
        B0 = st.B
        SC = jnp.zeros((L * b, cfg.n_components), B0.dtype)
        pi = jnp.asarray(1.0, B0.dtype)
        for trow in range(L):
            t = pos + trow
            size = draws.sizes[t]
            st, SC, pi = jax_step(
                st, Xw[t * b:(t + 1) * b],
                jnp.arange(t * b, (t + 1) * b, dtype=jnp.int32),
                jnp.asarray(draws.subsets[t], jnp.int32),
                jnp.asarray(np.asarray(draws.orders[t]), jnp.int32), cfg,
                n_valid=None if size is None else jnp.asarray(size,
                                                              jnp.int32),
                deferred=(B0, Xseg, SC, pi, jnp.int32(trow)))
        st = st._replace(B=pi * B0 + SC.T @ Xseg)
    return st


@pytest.mark.parametrize('code', ['ridge', 'fista'])
@pytest.mark.parametrize('rand_size,reduction', [(True, 10), (False, 5)])
def test_scan_program_matches_jax_and_eager_scan(rand_size, reduction, code,
                                                 monkeypatch):
    """T = 8 steps in deferred-B segments of 3 (3 + 3 + 2), through the
    program's buffers (the kernels' plain versions: float64 opens the
    BCD kernel's gate here) against the JAX package's chain and, bitwise,
    against the eager scan on the same draws."""
    monkeypatch.setattr(bcd, 'supported', lambda k, s, dtype: True)
    df, X = _jax_windowed('masked', code, rand_size, reduction=reduction,
                          n=480, seed=3, n_samples=400)
    n_steps, b = 8, 50
    cfg = port_config(df, use_kernel=True)
    seg = _step._deferred_seg(cfg, n_steps)
    assert seg == 3 and _program.capturable(cfg)
    draws = _draws(cfg, n_steps, seed=4)
    Xw = df._ingest_features(jnp.asarray(X[:n_steps * b]))
    want = _jax_deferred_epoch(df, Xw, draws, seg, b)

    X_dev = T(np.array(Xw))
    idx = torch.arange(n_steps * b)
    eager = _step.somf_scan(port_state(df), X_dev.reshape(n_steps, b, -1),
                            idx.reshape(n_steps, b), cfg, draws)
    staged = port_state(df)
    prog = _program.ScanProgram(staged, cfg, n_steps, b)
    epochs = _program.EPOCHS
    prog.epoch(X_dev, idx, draws)
    assert _program.EPOCHS - epochs == 1 and prog.graph is None
    assert staged.n_iter == eager.n_iter == n_steps * b
    for name in LEAVES:
        a, e = getattr(staged, name), getattr(eager, name)
        assert (a is None) == (e is None), name
        if a is not None:
            assert torch.equal(a, e), name
    assert_states_close(staged, want, FIELDS, rtol=1e-9)
    np.testing.assert_array_equal(staged.sample_n_iter.numpy(),
                                  np.asarray(want.sample_n_iter))


def test_epoch_scalars_match_the_stepwise_recurrence():
    """The staged pi is the segment's running decay product, rounded to
    the state's dtype at each step as the eager host recurrence did; the
    sample counter advances by b a step."""
    X = planted(400, 480, seed=5, dtype=np.float32)
    df = DictFact(n_components=6, reduction=5, code_alpha=1e-3, batch_size=50,
                  random_state=0, rand_size=False, subset_sampling='window',
                  device='cpu').prepare(n_samples=400, X=X)
    cfg, st = df._cfg, df._state
    assert _step._deferred_seg(cfg, 8) == 3
    rows = _step.epoch_scalars(clone_state(st), cfg, 50, [None] * 8)
    assert rows.dtype == np.float32 and rows.shape == (8, _step.N_SCALARS)
    ref = clone_state(st)
    for t in range(8):
        host = _step.step_scalars(ref, cfg, 50, None)
        pi = np.float32(1.0) if t % 3 == 0 else pi
        pi = np.float32(pi * host[1])
        np.testing.assert_array_equal(rows[t, :_step.PI], host[:_step.PI])
        assert rows[t, _step.PI] == pi
    assert ref.n_iter == 400


def _port_window_df(rand_size=True, code='fista', n=300, reduction=12,
                    subset_sampling='window'):
    """A port DictFact on the CPU (windowed subsets by default),
    prepared, its rows in the storage layout, and its configuration with the kernels
    on (``use_kernel``: on the CPU their plain versions)."""
    X = planted(96, n, k=4, seed=6, dtype=np.float32)
    df = DictFact(n_components=5, reduction=reduction, code_alpha=0.1,
                  code_l1_ratio=1.0 if code == 'fista' else 0.0,
                  comp_l1_ratio=1.0, code_solver='fista', tol=1e-3,
                  batch_size=12, random_state=0, rand_size=rand_size,
                  subset_sampling=subset_sampling, device='cpu')
    df.prepare(n_samples=96, X=X)
    Xw = df._ingest_features(T(X))
    return df, Xw, dataclasses.replace(df._cfg, use_kernel=True)


@pytest.mark.parametrize('kw', [dict(), dict(rand_size=False, code='ridge',
                                            reduction=6),
                                dict(blocks=True), dict(gather=True),
                                dict(gather=True, blocks=True)])
def test_scan_epoch_is_capture_safe(kw, monkeypatch):
    """Two epochs (8 steps, deferred-B segments with their EMA-GEMM
    segment ends for windows; gather subsets without) with different
    draws dispatch the same ops with the same non-tensor arguments, read
    no device value back and make no tensor of host data. ``blocks``:
    the BCD block driver (two rows a kernel call)."""
    _kernel_stand_ins(monkeypatch)
    ends = []
    monkeypatch.setattr(ema_gemm, 'ema_accumulate',
                        lambda B, SC, X, pi: ends.append(pi) or B)
    monkeypatch.setattr(ema_gemm, 'supported', lambda k, n, m, dtype: True)
    if kw.pop('blocks', False):
        monkeypatch.setattr(bcd, 'MAX_ROWS', 2)
    if kw.pop('gather', False):
        kw['subset_sampling'] = 'gather'
    df, Xw, cfg = _port_window_df(**kw)
    assert _program.capturable(cfg)
    windowed = cfg.windowed
    seg = _step._deferred_seg(cfg, 8)
    assert (2 <= seg < 8) if windowed else seg == 0
    state = clone_state(df._state)
    prog = _program.ScanProgram(state, cfg, 8, 12)
    runs = []
    for epoch in range(2):
        draws = _step.draw_epoch(state, cfg, 8)
        rows = torch.as_tensor(
            np.random.RandomState(epoch).permutation(96))
        prog.stage(Xw, torch.arange(96), draws, rows)
        with _Recorder() as rec:
            prog.run()
        runs.append((draws, prog.draws.clone(), rec.ops))
    (d0, b0, ops0), (d1, b1, ops1) = runs
    assert d0.subsets != d1.subsets if windowed else not torch.equal(
        d0.subsets[0], d1.subsets[0])
    assert not torch.equal(b0, b1)
    assert len(ops0) > 8 * 30
    assert ops0 == ops1
    names = {op[0] for op in ops0}
    assert not any('_local_scalar_dense' in n or 'item' in n
                   or 'lift_fresh' in n for n in names)
    n_ends = -(-8 // seg) if windowed else 0
    assert len(ends) == 2 * n_ends
    # each segment end reads its pi from the staged scalars
    assert all(pi.dim() == 0 and pi.data_ptr() >= prog.draws.data_ptr()
               for pi in ends)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('pi', [0.0, 0.75, 0.9137, 1.0])
def test_ema_pi_as_a_tensor_is_bitwise(pi, dtype):
    """The plain version and the wrapper's CPU route take ``pi`` as a 0-d
    tensor with the products of the number, bitwise."""
    rng = np.random.RandomState(7)
    B = T(rng.randn(6, 37)).to(dtype)
    SC, X = T(rng.randn(9, 6)).to(dtype), T(rng.randn(9, 37)).to(dtype)
    pi_t = torch.tensor(pi, dtype=dtype)
    number = float(pi_t)
    want = ema_gemm.ema_accumulate_reference(B.clone(), SC, X, number)
    for fn in (ema_gemm.ema_accumulate_reference, ema_gemm.ema_accumulate):
        got = fn(B.clone(), SC, X, pi_t)
        assert torch.equal(got, want)


def _window_kernel_df(**kw):
    X = planted(120, 150, k=4, seed=8, dtype=np.float32)
    df = KernelDictFact(n_components=5, reduction=5, code_alpha=0.1,
                        code_solver='fista', batch_size=12, random_state=0,
                        subset_sampling='window', device='cpu', **kw)
    return df, X


def test_fit_runs_every_epoch_through_one_program(monkeypatch):
    """A windowed fit without a callback: one program for its 3 epochs of
    10 full batches (rows gathered through the shuffles' composed
    permutation), bitwise equal to the eager route's fit (``somf_scan``
    on rows permuted epoch by epoch)."""
    df, X = _window_kernel_df(n_epochs=3)
    ref, _ = _window_kernel_df(n_epochs=3)
    built = []
    real = _program.ScanProgram

    def spy(*args):
        built.append(real(*args))
        return built[-1]

    monkeypatch.setattr(_program, 'ScanProgram', spy)
    epochs = _program.EPOCHS
    df.fit(X)
    assert _program.EPOCHS - epochs == 3
    assert len(built) == 1 and df._scans == {(10, 12): built[0]}
    assert built[0].holds(df._state, df._cfg, 10, 12)
    monkeypatch.setattr(_program, 'capturable', lambda cfg: False)
    ref.fit(X)
    assert ref._scans == {}
    for name in LEAVES:
        a, e = getattr(df._state, name), getattr(ref._state, name)
        if a is not None:
            assert torch.equal(a, e), name
    assert df._state.n_iter == ref._state.n_iter == 3 * 120
    np.testing.assert_array_equal(df.components_, ref.components_)


def test_partial_fit_builds_one_program_a_record_length():
    """Records of 60 and 36 rows in turns (5 and 3 batches): one program
    each, replayed by the later records of the same length, whose short
    tails step eagerly; a changed configuration drops them."""
    df, X = _window_kernel_df()
    df.prepare(n_samples=120, X=X)
    epochs = _program.EPOCHS
    for lo, hi in ((0, 60), (60, 96), (0, 66), (60, 96)):
        df.partial_fit(X[lo:hi], sample_indices=np.arange(lo, hi))
    assert _program.EPOCHS - epochs == 4
    assert sorted(df._scans) == [(3, 12), (5, 12)]
    progs = dict(df._scans)
    df.partial_fit(X[:60])
    assert df._scans[(5, 12)] is progs[(5, 12)]
    df.set_params(reduction=3)
    assert df._scans == {}
    assert np.isfinite(df.components_).all()


def test_eager_scan_sends_draws_without_blocking(cuda_typed):
    """``somf_scan`` on a CUDA-typed path: the epoch's draws and scalars
    reach the device in one non-blocking copy from a pinned slot, and
    nothing else is copied to a device (the blocking copies of the
    orders and subsets stay gone); a program's stage copies into its
    static buffer the same way."""
    df, Xw, cfg = _port_window_df()
    T_, b = 8, 12
    X_b = Xw.reshape(T_, b, -1)
    state = clone_state(df._state)
    draws = _step.draw_epoch(state, cfg, T_)
    cuda_typed.clear()
    _step.somf_scan(state, X_b, torch.arange(96).reshape(T_, b), cfg,
                    draws, _step.DrawStaging('cuda'))
    assert cuda_typed == [('to', 'cuda', True, True)]
    prog = _program.ScanProgram(clone_state(df._state), cfg, T_, b)
    prog.staging = _step.DrawStaging('cuda')
    cuda_typed.clear()
    prog.stage(Xw, torch.arange(96), _step.draw_epoch(prog.state, cfg, T_))
    assert cuda_typed == [('copy_', 'cpu', True, True)]
    assert np.isfinite(to_np(state.D)).all()
