"""The recsys window scan as one device program (``_program.
RecsysProgram``) and the batch body it captures, on the CPU at small
sizes.

- a window of 32 batches through a program's static buffers against
  modl_tpu's ``_recsys_window_resident`` with the same rows and orders,
  from one carried state: float64 (1e-9) and float32 with the port's BCD
  wrapper (its plain version here) against the Pallas kernel in
  interpret mode, at the rtol and atol of
  ``test_batch_steps_match_jax_from_carried_state`` held against each
  leaf's largest magnitude (32 batches of float32 roundoff, not 3);
- ``RecsysDictFact.fit`` through the programs (the kernel's switch on,
  as on the card) against modl_tpu's fit: 40 full batches and a short
  one an epoch (one window, eight single batches, the tail), components,
  codes, B and C at 1e-9, the same ``RandomState`` draws; and the
  callback route (one-batch programs), called as often as modl_tpu's
  callback and seeing the same dictionary each time;
- a capture-safety audit: two windows with different draws dispatch the
  same ops with the same non-tensor arguments, read no device value and
  make no tensor of host data;
- the staged scalars equal the host recurrence bit for bit;
- on a CUDA-typed path, the eager batches and a program's stage send
  their draws in one non-blocking copy from pinned memory;
- ``ops.solvers.spd_solve`` against ``torch.cholesky_solve`` (1e-12).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import modl_tpu.decomposition.recsys as jrec
import modl_tpu.ops.bcd_pallas as bp
import modl_tpu_torch.decomposition.recsys as trec
import modl_tpu_torch.datasets.recsys as tdata
from modl_tpu_torch import RecsysDictFact, convert
from modl_tpu_torch.decomposition import _program, _step
from modl_tpu_torch.ops import bcd, solvers
from test_torch_recsys import FIT_KW, _port_csr, _ratings
from test_torch_step_program import (  # noqa: F401 (cuda_typed: fixture)
    _kernel_stand_ins, _Recorder, cuda_typed)
from torch_parity import to_np

T = torch.as_tensor
NAMES = ('D', 'C', 'B', 'comp_norm', 'feature_n_iter', 'n_iter', 'code')


class KernelRecsysDictFact(RecsysDictFact):
    """RecsysDictFact with the BCD kernel's switch on, as on the card (on
    the CPU the wrapper runs its plain version), so its fits run as
    programs."""

    def _make_config(self, device):
        return dataclasses.replace(super()._make_config(device),
                                   use_kernel=True)


def _kernel_route(monkeypatch):
    """The BCD kernel's route in float64 too (``bcd.supported`` opens it;
    on CPU tensors the wrapper runs the plain version)."""
    monkeypatch.setattr(bcd, 'supported', lambda k, s, dtype: True)


def _carried(dtype, n_samples=120, n=64, k=4, b=3, seed=1):
    """JAX's state after one resident batch (C != 0), the resident rows,
    and the draws of a window of 32 batches."""
    X = _ratings(n_samples, n, density=0.3, seed=seed, dtype=dtype)
    rng = np.random.RandomState(7)
    D = rng.randn(k, n).astype(dtype)
    D /= np.sqrt(np.sum(D ** 2, axis=1))[:, None]
    perm = rng.permutation(n_samples)
    rows_0, rows_w = perm[:b], perm[b:b + 32 * b].reshape(32, b)
    orders_w = np.stack([rng.permutation(k) for _ in range(33)])
    resident = jrec._pad_all_rows(X, n, dtype)
    return X, D, resident, rows_0, rows_w, orders_w


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_window_program_matches_jax(dtype, monkeypatch):
    """A program of T = 32 on its static buffers (the body the card
    captures) against ``_recsys_window_resident`` from one carried
    state, every leaf compared."""
    f32 = dtype == np.float32
    n_samples, n, k, b, alpha, lr = 120, 64, 4, 3, 0.1, 0.9
    X, D, resident, rows_0, rows_w, orders_w = _carried(dtype)
    idx_all, val_all, lens_all, _ = (jnp.asarray(a) if i < 3 else a
                                     for i, a in enumerate(resident))
    old = bp.INTERPRET
    bp.INTERPRET = True
    try:
        state = (jnp.asarray(D), jnp.zeros((k, k), dtype),
                 jnp.zeros((k, n), dtype), jnp.zeros((k,), dtype),
                 jnp.zeros((n,), jnp.int32), jnp.zeros((), jnp.int32),
                 jnp.zeros((n_samples, k), dtype))
        state = jrec._recsys_batch_resident(
            *state, idx_all, val_all, lens_all, jnp.asarray(rows_0),
            jnp.asarray(orders_w[0]), alpha, lr, use_pallas=f32)
        st = convert.recsys_state_from_jax(
            {name: np.asarray(v) for name, v in zip(NAMES, state)},
            device='cpu')
        want = jrec._recsys_window_resident(
            *state, idx_all, val_all, lens_all, jnp.asarray(rows_w),
            jnp.asarray(orders_w[1:]), alpha, lr, use_pallas=f32)
    finally:
        bp.INTERPRET = old

    if not f32:
        _kernel_route(monkeypatch)
    port = trec.RecsysState(**st)
    assert port.n_iter == b
    cfg = trec.RecsysConfig(alpha=alpha, learning_rate=lr, use_kernel=True)
    packed = trec._pad_all_rows(_port_csr(X, port.D.dtype))
    programs = {}
    launches = []
    wrapper = bcd.bcd_update
    monkeypatch.setattr(bcd, 'bcd_update', lambda *a, **kw: (
        launches.append(a[0].shape), wrapper(*a, **kw))[1])
    trec._run(port, cfg, packed, rows_w, orders_w[1:], programs, None)
    prog = programs[(32, b)]
    assert prog.runs == 1 and prog.graph is None     # the CPU runs the body
    assert len(launches) == 32
    assert port.n_iter == int(want[5]) == 33 * b
    np.testing.assert_array_equal(to_np(port.feature_n_iter),
                                  np.asarray(want[4]))
    got = dict(D=port.D, C=port.C, B=port.B, comp_norm=port.comp_norm,
               code=port.code)
    for i, name in ((0, 'D'), (1, 'C'), (2, 'B'), (3, 'comp_norm'),
                    (6, 'code')):
        a, w = to_np(got[name]), np.asarray(want[i])
        if f32:
            # the rtol and atol of the three-step test, held against the
            # leaf's largest magnitude: float32 roundoff grows with the
            # batches (D's largest gap 1.8e-6 after 3 batches, 4.8e-6
            # after 32, against |D| up to 0.26)
            rtol, atol = dict(D=(2e-5, 2e-6)).get(name, (1e-4, 1e-5))
            assert np.abs(a - w).max() <= rtol * np.abs(w).max() + atol, \
                name
        else:
            np.testing.assert_allclose(a, w, rtol=1e-9, atol=1e-9,
                                       err_msg=name)


def _fit_pair(monkeypatch, callback=None, n_samples=122):
    """modl_tpu's fit and the port's through the programs (batch 3: 40
    full batches an epoch, one window of 32, then 8 single batches and a
    tail of 2), both with ``callback('jax')``/``callback('port')``."""
    _kernel_route(monkeypatch)
    X = tdata.make_synthetic_ratings(n_samples, 50, rank=4, density=0.2,
                                     seed=0)
    kw = dict(FIT_KW, batch_size=3)
    ref = jrec.RecsysDictFact(
        callback=callback and callback('jax'), **kw).fit(X)
    port = KernelRecsysDictFact(
        device='cpu', dtype=np.float64,
        callback=callback and callback('port'), **kw).fit(X)
    return X, ref, port


def _assert_fits_match(X, ref, port):
    assert port.use_kernel_
    for name in ('components_', 'code_', 'B_', 'C_'):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    assert port.score(X) == pytest.approx(ref.score(X), rel=1e-9)
    assert port.n_iter_ == ref.n_iter_ == 2 * X.shape[0]
    # the same draws from the RandomState, in the same order
    np.testing.assert_array_equal(port.random_state.get_state()[1],
                                  ref.random_state.get_state()[1])


def test_fit_through_programs_matches_jax(monkeypatch):
    batches = trec.BATCHES
    X, ref, port = _fit_pair(monkeypatch)
    _assert_fits_match(X, ref, port)
    assert trec.BATCHES - batches == 2 * 41
    progs = port._programs
    assert sorted(progs) == [(1, 2), (1, 3), (32, 3)]
    assert [progs[key].runs for key in sorted(progs)] == [2, 16, 2]


def test_callback_route_matches_jax(monkeypatch):
    """With a callback every batch runs alone (one-batch programs), the
    callback before each; it sees the dictionary as modl_tpu's does."""
    seen = {'jax': [], 'port': []}

    def callback(key):
        return lambda est: seen[key].append(np.asarray(est._D).copy())

    X, ref, port = _fit_pair(monkeypatch, callback, n_samples=62)
    _assert_fits_match(X, ref, port)
    assert sorted(port._programs) == [(1, 2), (1, 3)]
    assert port._programs[(1, 3)].runs == 2 * 20
    assert len(seen['port']) == len(seen['jax']) == 2 * 21
    for got, want in zip(seen['port'], seen['jax']):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def _window_program(state, cfg, resident, b, n_batches=32):
    programs = {}
    rows = np.zeros((n_batches, b), np.int64)
    orders = np.zeros((n_batches, state.D.shape[0]), np.int64)
    trec._run(state, cfg, resident, rows, orders, programs, None)
    return programs[(n_batches, b)]


def _float32_fit_state(n_samples=120, n=64, k=4):
    """A port fit's state right after its set-up (float32, the kernel's
    dtype), its configuration with the kernel on, and the resident rows."""
    X = _ratings(n_samples, n, density=0.3, seed=2, dtype=np.float32)
    est = KernelRecsysDictFact(device='cpu', n_components=k, alpha=0.1,
                               learning_rate=0.9, batch_size=3,
                               random_state=0)
    state, cfg, _, resident, b = est._start(X)
    return state, cfg, resident, b


def test_window_is_capture_safe(monkeypatch):
    """Two windows of 32 batches with different rows, orders and weights
    dispatch the same ops with the same non-tensor arguments; neither
    reads a device value back, makes a tensor of host data
    (``lift_fresh``) or hands a Python number to ``where`` (which copies
    it to the card)."""
    _kernel_stand_ins(monkeypatch)
    state, cfg, resident, b = _float32_fit_state()
    rng = np.random.RandomState(3)
    prog = _window_program(state, cfg, resident, b)
    runs = []
    for _ in range(2):
        rows = rng.permutation(120)[:32 * b].reshape(32, b)
        orders = np.stack([rng.permutation(4) for _ in range(32)])
        prog.stage([(r, o, trec.batch_scalars(state, cfg, b))
                    for r, o in zip(rows, orders)])
        with _Recorder() as rec:
            prog.run()
        runs.append((prog.draws.clone(), rec.ops))
    (d0, ops0), (d1, ops1) = runs
    assert not torch.equal(d0, d1)
    assert len(ops0) > 32 * 40
    assert ops0 == ops1
    names = {op[0] for op in ops0}
    assert not any('_local_scalar_dense' in n or 'item' in n
                   or 'lift_fresh' in n for n in names)
    assert not any(n.startswith('aten.where.Scalar') for n in names)
    # the BCD kernel's wrapper takes the staged order as it is (int32)
    assert prog.batches[0][1].dtype == torch.int32


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_staged_scalars_equal_the_host_recurrence(dtype):
    """``batch_scalars`` over a fit's batches (full ones and a tail) give
    ``w n_iter``, ``1 - w`` and ``w / b`` in the state's dtype, bitwise
    as the step computed them from its host ``n_iter`` (numpy products
    in the dtype), and a program's views read them back unchanged."""
    tdtype = getattr(torch, np.dtype(dtype).name)
    state = trec.RecsysState(*(torch.zeros(1, dtype=tdtype),) * 6)
    cfg = trec.RecsysConfig(alpha=1.0, learning_rate=0.95, use_kernel=True)
    n_iter = 0
    sizes = [101] * 40 + [87] + [101] * 40
    rows = [trec.batch_scalars(state, cfg, b) for b in sizes]
    for b, got in zip(sizes, rows):
        n_iter += b
        w = trec.batch_weight(n_iter, b, 0.95, 0.0, np.dtype(dtype))
        want = [float(w * np.dtype(dtype).type(n_iter)),
                float(np.dtype(dtype).type(1.0) - w),
                float(w / np.dtype(dtype).type(b))]
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, np.array(want, dtype))
    assert state.n_iter == n_iter
    layout = _step.DrawLayout(3, 4, tdtype, n_scalars=trec.N_SCALARS)
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    layout.fill(buf.numpy(), np.arange(3), np.arange(4), rows[-1])
    staged_rows, order, scalars = layout.views(buf)
    assert torch.equal(staged_rows, torch.arange(3))
    np.testing.assert_array_equal(scalars.numpy(), rows[-1])


@pytest.mark.parametrize('resident', [True, False])
def test_eager_batches_send_draws_without_blocking(resident, cuda_typed):
    """``recsys_batches`` on a CUDA-typed path: a window's rows, orders
    and scalars reach the device in one non-blocking copy from a pinned
    slot, and nothing else is copied to a device (the blocking copies of
    the permutation and the orders are gone), resident rows or packed a
    batch at a time; a program's stage copies into its static buffer the
    same way."""
    state, cfg, packed, b = _float32_fit_state()
    src = packed if resident else trec._DeviceCSR(
        _ratings(120, 64, density=0.3, seed=2, dtype=np.float32),
        torch.device('cpu'), torch.float32)
    rng = np.random.RandomState(4)
    rows = rng.permutation(120)[:32 * b].reshape(32, b)
    orders = np.stack([rng.permutation(4) for _ in range(32)])
    cuda_typed.clear()
    trec.recsys_batches(state, cfg, src, rows, orders,
                        _step.DrawStaging('cuda'))
    assert cuda_typed == [('to', 'cuda', True, True)]
    prog = _window_program(state, cfg, packed, b)
    prog.staging = _step.DrawStaging('cuda')
    cuda_typed.clear()
    prog.stage([(r, o, trec.batch_scalars(state, cfg, b))
                for r, o in zip(rows, orders)])
    assert cuda_typed == [('copy_', 'cpu', True, True)]
    assert np.isfinite(to_np(state.D)).all()


def test_program_leaves_keep_their_addresses():
    """A window through the program and eager batches write every leaf in
    place, so the program's graph would still address them."""
    state, cfg, resident, b = _float32_fit_state()
    before = [t.data_ptr() for t in state.leaves()]
    prog = _window_program(state, cfg, resident, b)
    rng = np.random.RandomState(5)
    rows = rng.permutation(120)[:32 * b].reshape(32, b)
    orders = np.stack([rng.permutation(4) for _ in range(32)])
    trec.recsys_batches(state, cfg, resident, rows, orders,
                        _step.DrawStaging('cpu'))
    assert [t.data_ptr() for t in state.leaves()] == before
    assert prog.addresses[:6] == tuple(before)


@pytest.mark.parametrize('b,k', [(1, 1), (7, 5), (101, 50), (16, 70)])
def test_spd_solve_matches_cholesky_solve(b, k):
    rng = np.random.RandomState(b * 100 + k)
    A = rng.randn(b, k, 2 * k)
    G = T(A @ A.transpose(0, 2, 1) / k + 0.1 * np.eye(k))
    rhs = T(rng.randn(b, k))
    want = torch.cholesky_solve(rhs[..., None],
                                torch.linalg.cholesky(G))[..., 0]
    got = solvers.spd_solve(G, rhs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    ridge = solvers.ridge_multi_gram(G, rhs, T(np.full((b, 1, 1), 0.3)))
    np.testing.assert_allclose(
        ridge.numpy(), solvers.ridge_multi_gram(G, rhs, 0.3).numpy(),
        rtol=0, atol=0)


def test_capturable_recsys():
    cfg = trec.RecsysConfig(alpha=1.0, learning_rate=1.0, use_kernel=True)
    assert _program.capturable_recsys(cfg, True)
    assert not _program.capturable_recsys(cfg, False)
    assert not _program.capturable_recsys(
        dataclasses.replace(cfg, use_kernel=False), True)
    assert not _program.capturable_recsys(
        dataclasses.replace(cfg, mesh=object()), True)


def test_program_body_is_the_resident_batch():
    """The program runs ``_resident_batch`` over its views, in order."""
    state, cfg, resident, b = _float32_fit_state()
    calls = []
    prog = _program.RecsysProgram(
        state.leaves(), lambda *views: calls.append(views),
        trec.draw_layout(state, b), 3)
    prog.stage([(np.full(b, t), np.arange(4), np.zeros(3, np.float32))
                for t in range(3)])
    prog.run()
    assert [int(c[0][0]) for c in calls] == [0, 1, 2]
    assert all(c[0].data_ptr() == v[0].data_ptr()
               for c, v in zip(calls, prog.batches))
