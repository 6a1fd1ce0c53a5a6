"""The port's recsys slice against modl_tpu's, on the CPU.

- the device packer against ``_pad_rows``/``_pad_all_rows``, bit for bit
  (empty rows and truncation included);
- ``_masked_ridge_codes`` and ``_b_ema_dense`` against the JAX functions
  and the serial numpy oracle of tests/test_recsys_parity.py (1e-10);
- three batch steps from a carried state: float64 against the lax path
  (1e-9), float32 through the BCD wrapper against the Pallas kernel in
  interpret mode (the tolerances of
  ``test_recsys_batch_step_pallas_matches_lax``), in one call and through
  the block driver;
- whole fits against the JAX fit under x64, resident and per batch;
- the host helpers, a pickle round trip, and a pickled CUDA estimator
  that will not load without a card.
Data is made with numpy from a seed; the JAX package runs on the CPU
with x64 on, the port with ``device='cpu'``.
"""
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import modl_tpu.decomposition.recsys as jrec
import modl_tpu.datasets.recsys as jdata
import modl_tpu.utils.recsys.cross_validation as jcv
import modl_tpu_torch.decomposition.recsys as trec
import modl_tpu_torch.datasets.recsys as tdata
import modl_tpu_torch.utils.recsys.cross_validation as tcv
from modl_tpu_torch import RecsysDictFact, convert
from modl_tpu_torch.ops import bcd
from test_recsys_parity import _numpy_batch_step
from torch_parity import to_np

T = torch.as_tensor
FIT_KW = dict(n_components=5, alpha=1.0, beta=0.1, learning_rate=0.95,
              batch_size=None, detrend=True, crop=(1, 5), n_epochs=2,
              random_state=0)


def _ratings(n_samples=40, n_features=30, density=0.3, seed=0,
             dtype=np.float64):
    """Random ratings with two empty rows and one full row."""
    X = sp.random(n_samples, n_features, density=density, random_state=seed,
                  format='lil')
    X[3, :] = 0
    X[17, :] = 0
    X[5, :] = np.arange(1, n_features + 1) / n_features
    X = sp.csr_matrix(X, dtype=dtype)
    X.data += 0.5
    return X


def _port_csr(X, dtype=torch.float64):
    return trec._DeviceCSR(X, torch.device('cpu'), dtype)


@pytest.mark.parametrize('case', ['batch', 'truncated', 'all'])
def test_packer_matches_jax(case):
    X = _ratings()
    csr = _port_csr(X)
    rows = np.random.RandomState(1).permutation(40)[:12]
    rows[:3] = (3, 5, 17)              # two empty rows and the full one
    if case == 'all':
        *want, want_P = jrec._pad_all_rows(X, 30, np.float64)
        got = trec._pad_all_rows(csr)
    else:
        width = 4 if case == 'truncated' else None
        *want, want_P = jrec._pad_rows(X, rows, 30, np.float64, width=width)
        got = trec._pad_rows(csr, rows, T(rows), width=width)
        if case == 'truncated':
            assert np.diff(X.indptr)[rows].max() > 4
    assert got[3] == want_P
    for a, b, name in zip(got[:3], want, ('idx', 'val', 'lens')):
        assert to_np(a).dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(to_np(a), np.asarray(b), err_msg=name)


def test_resident_budget_and_widths(monkeypatch):
    X = _ratings()
    csr = _port_csr(X)
    assert csr.width() == trec._next_pow2(30) == 32
    monkeypatch.setattr(trec, 'RESIDENT_BUDGET', 40 * 32 * 12 - 1)
    assert trec._pad_all_rows(csr) is None
    monkeypatch.setattr(trec, 'RESIDENT_BUDGET', 40 * 32 * 12)
    assert trec._pad_all_rows(csr)[3] == 32


def test_masked_ridge_codes_match_jax():
    X = _ratings()
    rng = np.random.RandomState(2)
    D = rng.randn(6, 30)
    rows = np.array([3, 5, 17, 0, 8, 21, 33])
    idx, val, lens, _ = jrec._pad_rows(X, rows, 30, np.float64)
    want = jrec._masked_ridge_codes(jnp.asarray(D), jnp.asarray(idx),
                                    jnp.asarray(val), jnp.asarray(lens), 0.7)
    pidx, pval, plens, _ = trec._pad_rows(_port_csr(X), rows, T(rows))
    got = trec._masked_ridge_codes(T(D), pidx, pval, plens, 0.7)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-10,
                               atol=1e-10)
    assert not to_np(got)[[0, 2]].any()           # empty rows: zero codes


def test_b_ema_dense_matches_jax_and_serial_oracle():
    rng = np.random.RandomState(3)
    n_samples, n, k, b = 50, 37, 5, 11
    X = sp.random(n_samples, n, density=0.25, random_state=3, format='csr')
    X.data += 0.5
    D = rng.randn(k, n)
    B0 = rng.randn(k, n)
    fni0 = rng.randint(0, 5, size=n).astype(np.int32)
    n_iter0, lr = 23, 0.9
    rows = rng.permutation(n_samples)[:b]
    idx, val, lens, _ = trec._pad_rows(_port_csr(X), rows, T(rows))
    code_b = trec._masked_ridge_codes(T(D), idx, val, lens, 0.1)
    n_iter_new = n_iter0 + b
    w = trec.batch_weight(n_iter_new, b, lr, 0.0, np.float64)
    # the port takes w n_iter as a device scalar and writes B and the
    # counts in place (into copies: T() shares the numpy arrays' memory)
    B, fni = trec._b_ema_dense(T(B0.copy()), T(fni0.copy()), code_b, idx,
                               val, lens, torch.tensor(w * n_iter_new))

    B_jax, fni_jax = jrec._b_ema_dense(
        jnp.asarray(B0), jnp.asarray(fni0), jnp.asarray(to_np(code_b)),
        jnp.asarray(to_np(idx)), jnp.asarray(to_np(val)),
        jnp.asarray(to_np(lens)), jnp.asarray(w),
        jnp.asarray(n_iter_new, jnp.int32))
    np.testing.assert_allclose(to_np(B), np.asarray(B_jax), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(to_np(fni), np.asarray(fni_jax))

    _, _, B_ref, _, fni_ref, _, codes_ref = _numpy_batch_step(
        X, rows, D, np.zeros((k, k)), B0.copy(), np.zeros(k),
        fni0.astype(int), n_iter0, 0.1, lr)
    np.testing.assert_allclose(to_np(code_b), codes_ref, atol=1e-10)
    np.testing.assert_allclose(to_np(B), B_ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(to_np(fni), fni_ref)


@pytest.mark.parametrize('route', ['float64-lax', 'float32-kernel',
                                   'float32-blocks'])
def test_batch_steps_match_jax_from_carried_state(route, monkeypatch):
    """Three steps from a state after one JAX step (C != 0), carried by
    ``convert.recsys_state_from_jax``. float32: the port's BCD wrapper
    (its plain version on CPU tensors) against the Pallas kernel in
    interpret mode; ``float32-blocks`` caps a kernel call at 2 rows, so
    each step's k=4 update runs through the block driver in two calls."""
    import modl_tpu.ops.bcd_pallas as bp
    f32 = route != 'float64-lax'
    dtype = np.float32 if f32 else np.float64
    n_samples, n, k, b, alpha, lr = 40, 64, 4, 8, 0.1, 0.9
    X = _ratings(n_samples, n, density=0.3, seed=1, dtype=dtype)
    rng = np.random.RandomState(7)
    D = rng.randn(k, n).astype(dtype)
    D /= np.sqrt(np.sum(D ** 2, axis=1))[:, None]
    draws = [(rng.permutation(n_samples)[:b], rng.permutation(k))
             for _ in range(4)]

    def jax_step(state, rows, order):
        D, C, B, cn, fni, nit, code = state
        idx, val, lens, _ = jrec._pad_rows(X, rows, n, dtype)
        code_b = jrec._masked_ridge_codes(D, jnp.asarray(idx),
                                          jnp.asarray(val),
                                          jnp.asarray(lens), alpha)
        code = code.at[rows].set(code_b)
        return (*jrec._recsys_batch_step(
            D, C, B, cn, fni, nit, code_b, jnp.asarray(idx),
            jnp.asarray(val), jnp.asarray(lens), jnp.asarray(order), lr,
            use_pallas=f32), code)

    old = bp.INTERPRET
    bp.INTERPRET = True
    try:
        jax_state = (jnp.asarray(D), jnp.zeros((k, k), dtype),
                     jnp.zeros((k, n), dtype), jnp.zeros((k,), dtype),
                     jnp.zeros((n,), jnp.int32), jnp.zeros((), jnp.int32),
                     jnp.zeros((n_samples, k), dtype))
        jax_state = jax_step(jax_state, *draws[0])
        names = ('D', 'C', 'B', 'comp_norm', 'feature_n_iter', 'n_iter',
                 'code')
        st = convert.recsys_state_from_jax(
            {name: np.asarray(v) for name, v in zip(names, jax_state)},
            device='cpu')
        for rows, order in draws[1:]:
            jax_state = jax_step(jax_state, rows, order)
    finally:
        bp.INTERPRET = old

    assert st['D'].dtype == getattr(torch, np.dtype(dtype).name)
    assert st['n_iter'] == b and st['feature_n_iter'].dtype == torch.int32
    csr = _port_csr(X, st['D'].dtype)
    state = trec.RecsysState(**st)
    cfg = trec.RecsysConfig(alpha=alpha, learning_rate=lr, use_kernel=f32)
    calls = []
    if route == 'float32-blocks':
        monkeypatch.setattr(bcd, 'MAX_ROWS', 2)
        assert not bcd.supported(k, n, torch.float32)
        assert bcd.max_block(n, torch.float32) == 2
    wrapper = bcd.bcd_update
    monkeypatch.setattr(bcd, 'bcd_update', lambda *a, **kw: (
        calls.append(a[0].shape), wrapper(*a, **kw))[1])
    for rows, order in draws[1:]:
        idx, val, lens, _ = trec._pad_rows(csr, rows, T(rows))
        code_b = trec._masked_ridge_codes(state.D, idx, val, lens, alpha)
        trec._recsys_batch_step(
            state, code_b, idx, val, lens, T(order),
            T(trec.batch_scalars(state, cfg, b)), use_kernel=f32)
    D_p, C_p, B_p, cn_p, fni_p, nit_p = (
        state.D, state.C, state.B, state.comp_norm, state.feature_n_iter,
        state.n_iter)
    D_j, C_j, B_j, cn_j, fni_j, nit_j, _ = jax_state
    assert nit_p == int(nit_j) == 4 * b
    rows_per_call = {'float64-lax': [], 'float32-kernel': [k] * 3,
                     'float32-blocks': [2] * 6}[route]
    assert [shape[0] for shape in calls] == rows_per_call
    np.testing.assert_array_equal(to_np(fni_p), np.asarray(fni_j))
    if f32:
        np.testing.assert_allclose(to_np(D_p), D_j, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(to_np(cn_p), cn_j, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(to_np(B_p), B_j, rtol=1e-4, atol=1e-5)
    else:
        for got, want in ((D_p, D_j), (C_p, C_j), (B_p, B_j),
                          (cn_p, cn_j)):
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       rtol=1e-9, atol=1e-9)


def _fit_pair(monkeypatch, resident, with_callback):
    X = tdata.make_synthetic_ratings(120, 50, rank=4, density=0.2, seed=0)
    calls = {'jax': [], 'port': []}

    def callback(key):
        return (lambda est: calls[key].append(est.n_iter_ if key == 'port'
                                              else None)) \
            if with_callback else None

    if not resident:
        monkeypatch.setattr(trec, 'RESIDENT_BUDGET', 0)
    ref = jrec.RecsysDictFact(callback=callback('jax'), **FIT_KW).fit(X)
    port = RecsysDictFact(device='cpu', dtype=np.float64,
                          callback=callback('port'), **FIT_KW).fit(X)
    return X, ref, port, calls


@pytest.mark.parametrize('resident,with_callback',
                         [(True, True), (False, False)])
def test_fit_matches_jax(monkeypatch, resident, with_callback):
    X, ref, port, calls = _fit_pair(monkeypatch, resident, with_callback)
    assert (port.resident_width_ is not None) == resident
    assert not port.use_kernel_
    np.testing.assert_allclose(port.components_, ref.components_,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(port.code_, ref.code_, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(port.B_, ref.B_, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(port.C_, ref.C_, rtol=1e-9, atol=1e-9)
    assert port.score(X) == pytest.approx(ref.score(X), rel=1e-9)
    assert port.n_iter_ == ref.n_iter_ == 2 * 120
    np.testing.assert_array_equal(port.row_mean_, ref.row_mean_)
    np.testing.assert_array_equal(port.col_mean_, ref.col_mean_)
    if with_callback:
        n_batches = len(calls['jax'])
        assert n_batches == len(calls['port']) > 0
        assert calls['port'][0] == 0 and calls['port'] == sorted(
            calls['port'])
    # the same draws from the RandomState, in the same order
    s_port = port.random_state.get_state()
    s_ref = ref.random_state.get_state()
    np.testing.assert_array_equal(s_port[1], s_ref[1])
    assert port.time_ > 0


def test_resident_and_per_batch_fits_agree(monkeypatch):
    X = tdata.make_synthetic_ratings(120, 50, rank=4, density=0.2, seed=1)
    kw = dict(FIT_KW, device='cpu', dtype=np.float64)
    res = RecsysDictFact(**kw).fit(X)
    monkeypatch.setattr(trec, 'RESIDENT_BUDGET', 0)
    per = RecsysDictFact(**kw).fit(X)
    assert res.resident_width_ == 32 and per.resident_width_ is None
    np.testing.assert_allclose(per.components_, res.components_,
                               rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(per.code_, res.code_, rtol=1e-11, atol=1e-11)


def test_fit_float32_and_bias_only_baseline():
    X = tdata.make_synthetic_ratings(300, 80, rank=4, density=0.2, seed=2)
    X_tr, X_te = tcv.train_test_split(X, train_size=0.75, random_state=0)
    X_tr, X_te = sp.csr_matrix(X_tr), sp.csr_matrix(X_te)
    est = RecsysDictFact(device='cpu', **dict(FIT_KW, n_epochs=3)).fit(X_tr)
    assert est.components_.dtype == np.float32
    base = trec.rmse(X_te, _bias_prediction(est, X_te))
    assert np.isfinite(est.score(X_te)) and est.score(X_te) < base


def _bias_prediction(est, X):
    rows = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))
    out = np.clip(est.row_mean_[rows] + est.col_mean_[X.indices], 1, 5)
    return sp.csr_matrix((out, X.indices, X.indptr), shape=X.shape)


@pytest.mark.parametrize('helper', ['compute_biases', 'rmse',
                                    'train_test_split', 'shuffle_split',
                                    'make_synthetic_ratings'])
def test_host_helpers_match_jax(helper):
    X = jdata.make_synthetic_ratings(150, 40, rank=3, density=0.3, seed=4)
    if helper == 'compute_biases':
        for beta in (0.0, 0.1):
            got = trec.compute_biases(X, beta=beta)
            want = jrec.compute_biases(X, beta=beta)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    elif helper == 'rmse':
        Y = X.copy()
        Y.data = Y.data[::-1].copy()
        assert trec.rmse(X, Y) == jrec.rmse(X, Y)
    elif helper == 'train_test_split':
        for a, b in zip(tcv.train_test_split(X, 0.75, random_state=3),
                        jcv.train_test_split(X, 0.75, random_state=3)):
            assert (a != b).nnz == 0 and a.nnz == b.nnz
    elif helper == 'shuffle_split':
        got = list(tcv.ShuffleSplit(n_iter=2, random_state=5).split(X))
        want = list(jcv.ShuffleSplit(n_iter=2, random_state=5).split(X))
        assert len(tcv.ShuffleSplit(n_iter=2)) == 2
        for (a, b), (c, d) in zip(got, want):
            assert (a != c).nnz == 0 and (b != d).nnz == 0
    else:
        Y = tdata.make_synthetic_ratings(150, 40, rank=3, density=0.3,
                                         seed=4)
        np.testing.assert_array_equal(Y.indptr, X.indptr)
        np.testing.assert_array_equal(Y.indices, X.indices)
        np.testing.assert_array_equal(Y.data, X.data)


def test_pickle_round_trip():
    X = tdata.make_synthetic_ratings(100, 30, rank=3, density=0.3, seed=5)
    est = RecsysDictFact(device='cpu', **dict(FIT_KW, n_epochs=1)).fit(X)
    twin = pickle.loads(pickle.dumps(est))
    for name in ('_D', '_C', '_B', '_code'):
        assert torch.is_tensor(getattr(twin, name))
    np.testing.assert_array_equal(twin.components_, est.components_)
    np.testing.assert_array_equal(twin.code_, est.code_)
    np.testing.assert_array_equal(twin.predict(X).data, est.predict(X).data)
    assert twin.score(X) == est.score(X)


@pytest.mark.skipif(torch.cuda.is_available(), reason='needs no card')
def test_pickled_cuda_estimator_needs_a_card():
    """A ``device='cuda'`` estimator's state loads onto the card or
    raises; it is not moved to the CPU."""
    X = tdata.make_synthetic_ratings(60, 20, rank=3, density=0.3, seed=6)
    est = RecsysDictFact(device='cpu', **dict(FIT_KW, n_epochs=1)).fit(X)
    blob = pickle.dumps(est.set_params(device='cuda'))
    with pytest.raises(RuntimeError, match='no CUDA'):
        pickle.loads(blob)
