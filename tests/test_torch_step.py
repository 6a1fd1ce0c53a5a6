"""The port's SOMF step against modl_tpu's, with injected draws.

- float64, plain path (``use_kernel=False`` vs ``use_pallas=False``):
  every aggregator, both dictionary balls, ``comp_pos``, ridge and l1
  codes (CD, and FISTA under every aggregator), and ``sgd``, at atol
  1e-9 (the bar of tests/test_reference_parity.py); windowed steps at
  the head, in the interior and wrapping, under ``rand_size``;
- float32, kernel path (the kernel's plain version on the CPU vs the
  Pallas kernel in interpret mode), 3 steps, rtol 1e-5 / atol 1e-6
  (tests/test_bcd_pallas.py), whole-k and through the block driver;
- the port's deferred-B ``somf_scan`` against its own per-step loop.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import modl_tpu.ops.bcd_pallas as bp
from modl_tpu import DictFact as JaxDictFact
from modl_tpu.decomposition._step import somf_step_inner as jax_step_inner
from modl_tpu_torch import DictFact
from modl_tpu_torch.decomposition import _step
from modl_tpu_torch.ops import bcd
from torch_parity import (assert_rel_close, assert_states_close,
                          clone_state, planted, port_config, port_state,
                          to_np)

T = torch.as_tensor
jax_step = jax.jit(jax_step_inner, static_argnames='cfg')
FIELDS = ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg', 'G_avg')


def _run_both(df, X, n_steps, seed, **port_changes):
    """Step both packages from the same state with the same draws."""
    rng = np.random.RandomState(seed)
    n_samples, n = X.shape
    cfg = df._cfg
    st_jax = df._state
    st = port_state(df)
    cfg_port = port_config(df, **port_changes)
    k, b = cfg.n_components, df.batch_size
    for _ in range(n_steps):
        idx = rng.permutation(n_samples)[:b]
        subset = rng.permutation(n)[:cfg.len_subset]
        order = rng.permutation(k)
        st_jax = jax_step(st_jax, jnp.asarray(X[idx]),
                          jnp.asarray(idx, jnp.int32),
                          jnp.asarray(subset, jnp.int32),
                          jnp.asarray(order, jnp.int32), cfg)
        st = _step.somf_step_inner(st, T(X[idx]), T(idx), T(subset),
                                   T(order), cfg_port)
    return st, st_jax


@pytest.mark.parametrize('agg', ['masked', 'full', 'average'])
@pytest.mark.parametrize('comp_l1', [0.0, 1.0])
@pytest.mark.parametrize('comp_pos', [False, True])
def test_step_matches_jax_float64(agg, comp_l1, comp_pos):
    # code l1 toggles across the (comp_l1, comp_pos) grid, so every
    # aggregator runs both the ridge and the elastic-net CD code solve
    code_l1 = float(comp_l1 != comp_pos)
    X = np.random.RandomState(0).randn(60, 24)
    df = JaxDictFact(n_components=5, reduction=2, code_alpha=0.1,
                     code_l1_ratio=code_l1, comp_l1_ratio=comp_l1,
                     comp_pos=comp_pos, code_solver='cd', tol=1e-3,
                     Dx_agg=agg, G_agg=agg, batch_size=12, random_state=0)
    df.prepare(n_samples=60, X=X)
    st, st_jax = _run_both(df, X, 6, seed=0)
    assert st.n_iter == int(st_jax.n_iter)
    assert_states_close(st, st_jax, FIELDS + ('sample_n_iter',))


@pytest.mark.parametrize('agg', ['masked', 'full', 'average'])
def test_fista_step_matches_jax_float64(agg):
    """l1 codes by FISTA, the solver DictFact takes on the card: the
    port's plain FISTA against modl_tpu's while_loop, with a shared Gram
    ('masked', 'full') and per-sample Grams ('average')."""
    X = np.random.RandomState(5).randn(60, 24)
    df = JaxDictFact(n_components=5, reduction=2, code_alpha=0.1,
                     code_l1_ratio=1.0, comp_l1_ratio=1.0,
                     code_solver='fista', tol=1e-3, Dx_agg=agg, G_agg=agg,
                     batch_size=12, random_state=0)
    df.prepare(n_samples=60, X=X)
    assert port_config(df).code_solver == 'fista'
    st, st_jax = _run_both(df, X, 6, seed=5)
    assert st.n_iter == int(st_jax.n_iter)
    assert_states_close(st, st_jax, FIELDS + ('sample_n_iter',))


@pytest.mark.parametrize('code_l1', [0.0, 1.0])
def test_sgd_step_matches_jax_float64(code_l1):
    X = np.random.RandomState(4).randn(60, 24)
    df = JaxDictFact(n_components=5, reduction=2, code_alpha=0.1,
                     code_l1_ratio=code_l1, comp_l1_ratio=0.0,
                     optimizer='sgd', step_size=1e-2, code_solver='cd',
                     tol=1e-3, Dx_agg='full', G_agg='full', batch_size=12,
                     random_state=0)
    df.prepare(n_samples=60, X=X)
    st, st_jax = _run_both(df, X, 6, seed=4)
    assert_states_close(st, st_jax, FIELDS)


@pytest.mark.parametrize('start', [3, 117, 350])   # head, interior, wraps
@pytest.mark.parametrize('agg', ['masked', 'full'])
def test_windowed_step_matches_jax_float64(start, agg):
    """Window starts below the window width (the mirror is refreshed),
    inside, and past n - width (the wrapped tail folds into the head),
    with a Binomial-size mask (n_valid < len_max)."""
    X = planted(300, 400, seed=1)
    df = JaxDictFact(n_components=6, reduction=4, code_alpha=1e-3,
                     code_l1_ratio=0, random_state=0, batch_size=50,
                     Dx_agg=agg, G_agg=agg, subset_sampling='window')
    df.prepare(n_samples=300, X=X)
    cfg = df._cfg
    assert cfg.windowed and cfg.rand_size
    n, s = 400, cfg.len_max
    n_valid = s - 7
    Xw = np.array(df._ingest_features(jnp.asarray(X[:50])))
    idx = np.arange(50)
    order = np.random.RandomState(2).permutation(6)
    st_jax = jax_step(df._state, jnp.asarray(Xw),
                      jnp.asarray(idx, jnp.int32),
                      jnp.asarray(start, jnp.int32),
                      jnp.asarray(order, jnp.int32), cfg,
                      n_valid=jnp.asarray(n_valid, jnp.int32))
    st = _step.somf_step_inner(port_state(df), T(Xw), T(idx), start,
                               T(order), port_config(df), n_valid=n_valid)
    # planted data: C and B reach ~1e4, so roundoff is held relative
    assert_states_close(st, st_jax, FIELDS, rtol=1e-9)
    D = to_np(st.D)
    np.testing.assert_array_equal(D[:, n:], D[:, :s])


def test_writeback_window_is_circular():
    n, s, k = 20, 6, 3
    for start in (0, 4, 9, 14, 19):
        D = torch.arange(k * (n + s), dtype=torch.float64).reshape(k, -1)
        D[:, n:] = D[:, :s]
        logical = D[:, :n].clone()
        vals = -torch.arange(1, k * s + 1, dtype=torch.float64).reshape(k, s)
        logical[:, (start + torch.arange(s)) % n] = vals
        _step._writeback_window(D, vals, start, n)
        torch.testing.assert_close(D[:, :n], logical, rtol=0, atol=0)
        torch.testing.assert_close(D[:, n:], D[:, :s], rtol=0, atol=0)


@pytest.fixture
def block_driver():
    """Shrink both packages' per-call row caps to 8 so a k=16 dictionary
    runs two kernel blocks per step."""
    old = bp.INTERPRET, bp.VMEM_BUDGET, bcd.MAX_ROWS
    bp.INTERPRET = True

    def force(s):
        bp.VMEM_BUDGET = (bp.vmem_footprint(8, s)
                          + bp.vmem_footprint(16, s)) // 2
        bcd.MAX_ROWS = 8
    yield force
    bp.INTERPRET, bp.VMEM_BUDGET, bcd.MAX_ROWS = old


@pytest.mark.parametrize('blocks', [False, True])
def test_kernel_path_matches_pallas_float32(blocks, block_driver):
    rng = np.random.RandomState(2)
    X = rng.randn(96, 128).astype(np.float32)
    df = JaxDictFact(n_components=16, reduction=2, code_alpha=1e-3,
                     comp_l1_ratio=1.0, random_state=0, batch_size=32,
                     dtype=np.float32)
    df.prepare(n_samples=96, X=X)
    s = df._cfg.len_subset
    if blocks:
        block_driver(s)
        assert bcd.max_block(s, torch.float32) == 8
        assert bp.max_block(16, s, np.float32) == 8
    else:
        assert bcd.supported(16, s, torch.float32)
        assert bp.supported(16, s, np.float32, 1.0)
    df._cfg = dataclasses.replace(df._cfg, use_pallas=True)
    st, st_jax = _run_both(df, X, 3, seed=5)
    assert st.D.dtype == torch.float32
    np.testing.assert_allclose(to_np(st.D), np.asarray(st_jax.D),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(st.comp_norm),
                               np.asarray(st_jax.comp_norm),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('rand_size', [True, False])
def test_deferred_scan_matches_stepping(rand_size):
    """The deferred-B epoch (B = pi B0 + SC^T Xseg per segment) against
    the same draws stepped one by one with B's EMA every step: the same
    math with sums reordered, held at f32 rel 1e-4 (comp_norm 1e-3: it is
    a near-zero residual) as tests/test_windowed.py holds the JAX scan."""
    X = planted(400, 480, dtype=np.float32)
    df = DictFact(n_components=6, reduction=6, code_alpha=1e-3,
                  random_state=0, batch_size=50, rand_size=rand_size,
                  subset_sampling='window', device='cpu')
    df.prepare(n_samples=400, X=X)
    cfg = df._cfg
    assert cfg.windowed and _step._deferred_seg(cfg, 8) >= 2
    Xd = df._ingest_features(T(X))
    Xb, ib = Xd.reshape(8, 50, -1), torch.arange(400).reshape(8, 50)
    draws = _step.draw_epoch(clone_state(df._state), cfg, 8)
    st_scan = _step.somf_scan(clone_state(df._state), Xb, ib, cfg, draws)
    st_step = clone_state(df._state)
    for t in range(8):
        _step.somf_step_inner(st_step, Xb[t], ib[t], draws.subsets[t],
                              draws.orders[t], cfg, n_valid=draws.sizes[t])
    for name in ('D', 'B', 'C', 'comp_norm', 'code'):
        assert_rel_close(getattr(st_scan, name), getattr(st_step, name),
                         1e-3 if name == 'comp_norm' else 1e-4, name)
    D = to_np(st_scan.D)
    s = cfg.len_max if rand_size else cfg.len_subset
    np.testing.assert_array_equal(D[:, 480:], D[:, :s])
