"""The port's estimator and the slice as a whole against modl_tpu.

- one epoch of the windowed, deferred-B fit from a JAX ``prepare`` state
  carried over by ``modl_tpu_torch.convert``, the same injected draws in
  both packages, at float64;
- ``fit`` on planted data reconstructs it;
- ``transform``/``score`` against JAX ``compute_code``/``objective_value``;
- the package imports neither JAX nor modl_tpu, and ``device='cuda'``
  (the default of every estimator) raises where there is no card.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from modl_tpu import Coder as JaxCoder
from modl_tpu import DictFact as JaxDictFact
from modl_tpu.decomposition import _step as jstep
from modl_tpu_torch import Coder, DictFact, ImageDictFact, RecsysDictFact
from modl_tpu_torch.decomposition import _step
from torch_parity import (assert_states_close, planted, port_config,
                          port_state, to_np)

T = torch.as_tensor
REPO = Path(__file__).resolve().parent.parent
KW = dict(n_components=6, reduction=6, code_alpha=1e-3, code_l1_ratio=0,
          random_state=0, batch_size=50)


def test_epoch_matches_jax_from_carried_state():
    X = planted()
    df = JaxDictFact(subset_sampling='window', **KW)
    df.prepare(n_samples=400, X=X)
    cfg = df._cfg
    assert cfg.windowed and cfg.rand_size and cfg.len_max < 480 // 2

    port = DictFact(subset_sampling='window', device='cpu', **KW)
    port.prepare(n_samples=400, X=X)
    # the port derives the same configuration from the same parameters
    assert port._cfg == port_config(df)
    port._feat_perm, port._feat_inv = df._feat_perm, df._feat_inv
    port._state = port_state(df)
    Xw = port._ingest_features(T(X))
    Xw_jax = df._ingest_features(jnp.asarray(X))
    np.testing.assert_array_equal(to_np(Xw), np.asarray(Xw_jax))

    rng = np.random.RandomState(7)
    T_, b = 8, 50
    starts = rng.randint(0, 480, T_).tolist()
    sizes = np.clip(rng.binomial(480, cfg.len_subset / 480, T_), 1,
                    cfg.len_max).tolist()
    orders = np.stack([rng.permutation(6) for _ in range(T_)])
    assert _step._deferred_seg(port._cfg, T_) >= 2

    step = jax.jit(jstep.somf_step_inner, static_argnames='cfg')
    st_jax = df._state
    for t in range(T_):
        st_jax = step(st_jax, Xw_jax[t * b:(t + 1) * b],
                      jnp.arange(t * b, (t + 1) * b, dtype=jnp.int32),
                      jnp.asarray(starts[t], jnp.int32),
                      jnp.asarray(orders[t], jnp.int32), cfg,
                      n_valid=jnp.asarray(sizes[t], jnp.int32))
    draws = _step.Draws(subsets=starts, sizes=sizes, orders=T(orders))
    st = _step.somf_scan(port._state, Xw.reshape(T_, b, -1),
                         torch.arange(400).reshape(T_, b), port._cfg, draws)
    # deferred-B segments reorder B's sums: float64 roundoff, relative
    assert_states_close(st, st_jax, ('D', 'B', 'C', 'code', 'comp_norm'),
                        rtol=1e-9, atol=1e-9)
    df._state = st_jax
    np.testing.assert_allclose(port.components_, df.components_,
                               rtol=1e-9, atol=1e-9)


def test_fit_reconstructs_planted_data():
    X = planted(dtype=np.float32)
    fits = [DictFact(n_epochs=6, device='cpu', **KW).fit(X)
            for _ in range(2)]
    df = fits[0]
    assert df._cfg.windowed and df._cfg.rand_size and not df._cfg.use_kernel
    assert df.components_.shape == (6, 480)
    assert df.components_.dtype == np.float32
    rec = df.transform(X) @ df.components_
    assert np.sum((X - rec) ** 2) / np.sum(X ** 2) < 0.02
    assert df.n_iter_ == 6 * 400
    np.testing.assert_array_equal(fits[0].components_, fits[1].components_)


def test_partial_fit_streams_and_calls_back():
    X = planted(dtype=np.float32)
    calls = []
    df = DictFact(subset_sampling='window', device='cpu',
                  callback=lambda est: calls.append(est.n_iter_), **KW)
    df.prepare(n_samples=400, X=X)
    for lo in range(0, 400, 100):
        df.partial_fit(X[lo:lo + 100], np.arange(lo, lo + 100))
    assert calls == list(range(0, 400, 50))
    rec = df.transform(X) @ df.components_
    assert np.sum((X - rec) ** 2) / np.sum(X ** 2) < 0.1


@pytest.mark.parametrize('code_l1', [0.0, 1.0])
@pytest.mark.parametrize('with_gram', [False, True])
def test_transform_and_score_match_jax(code_l1, with_gram):
    rng = np.random.RandomState(3)
    D, X = rng.randn(6, 40), rng.randn(30, 40)
    G = D @ D.T if with_gram else None
    args = (code_l1, 0.5, False, 1e-6, 200)
    got = _step.compute_code(T(D), None if G is None else T(G), T(X), *args)
    want = jstep.compute_code(jnp.asarray(D),
                              None if G is None else jnp.asarray(G),
                              jnp.asarray(X), *args)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-9)
    got = _step.objective_value(T(D), None if G is None else T(G), T(X),
                                *args)
    want = jstep.objective_value(jnp.asarray(D),
                                 None if G is None else jnp.asarray(G),
                                 jnp.asarray(X), *args)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    coder_kw = dict(code_alpha=0.5, code_l1_ratio=code_l1, tol=1e-6,
                    max_iter=200)
    port, ref = Coder(D, device='cpu', **coder_kw), JaxCoder(D, **coder_kw)
    np.testing.assert_allclose(port.transform(X, batch_size=7),
                               ref.transform(X), atol=1e-9)
    assert port.score(X) == pytest.approx(ref.score(X), rel=1e-12)


def test_import_does_not_pull_jax():
    code = ("import sys, modl_tpu_torch, modl_tpu_torch.decomposition.fmri, "
            "modl_tpu_torch.decomposition.recsys, "
            "modl_tpu_torch.decomposition.image; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'modl_tpu', 'sklearn', 'joblib')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_package_sources_never_import_jax():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|modl_tpu)(\.|\s|$)',
                         re.M)
    for path in (REPO / 'modl_tpu_torch').rglob('*.py'):
        assert not pattern.search(path.read_text()), path


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is visible')
    X = planted(60, 40, dtype=np.float32)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        DictFact(n_components=3).fit(X)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Coder(X[:3]).transform(X)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        RecsysDictFact(n_components=3).fit(sp.random(20, 10, density=0.3,
                                                     random_state=0))
    image = np.random.RandomState(0).rand(12, 12, 1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ImageDictFact(n_components=3, patch_size=(4, 4)).fit(image)


def test_unfitted_estimator_raises():
    X = planted(20, 40, dtype=np.float32)
    df = DictFact(device='cpu', **KW)
    for call in (df.transform, df.score):
        with pytest.raises(ValueError, match='not fitted'):
            call(X)


def test_params_round_trip():
    from sklearn.base import clone
    df = DictFact(device='cpu', **KW)
    params = df.get_params()
    assert params['device'] == 'cpu' and params['reduction'] == 6
    twin = clone(df)
    assert twin.get_params() == params and twin is not df
    df.set_params(reduction=3)
    assert df.reduction == 3
    with pytest.raises(ValueError, match='invalid parameter'):
        df.set_params(mesh=None)
    coder = Coder(np.eye(3), device='cpu')
    assert clone(coder).get_params()['dictionary'].shape == (3, 3)
    assert repr(coder).startswith('Coder(')
