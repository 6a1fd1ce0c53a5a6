"""modl_tpu_torch.ops against modl_tpu.ops: weights, enet geometry,
solvers and samplers, on the same numpy inputs at float64."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modl_tpu.ops import enet as jenet
from modl_tpu.ops import sampler as jsampler
from modl_tpu.ops import solvers as jsolvers
from modl_tpu.ops import weights as jweights
from modl_tpu_torch.ops import enet, precision, sampler, solvers, weights
from torch_parity import to_np

T = torch.as_tensor


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('count,b,lr', [(10, 10, 1.0), (1200, 100, 0.92),
                                        (37, 5, 0.76)])
def test_batch_weight_matches_jax(dtype, count, b, lr):
    got = weights.batch_weight(count, b, lr, 0.0, dtype)
    want = np.asarray(jweights.batch_weight(count, b, lr, 0.0, dtype=dtype))
    assert got.dtype == np.dtype(dtype)
    # float32: the products are taken in another order
    np.testing.assert_allclose(got, want,
                               rtol=1e-12 if dtype == np.float64 else 1e-6)


def test_sample_weight_matches_jax():
    sni = np.array([1, 2, 5, 30])
    got = weights.sample_weight(T(sni), 0.76, torch.float64)
    want = jweights.sample_weight(jnp.asarray(sni), 0.76, jnp.float64)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-12)


@pytest.mark.parametrize('l1_ratio', [0.0, 0.3, 1.0])
def test_enet_norm_and_scale_match_jax(l1_ratio):
    V = np.random.RandomState(0).randn(5, 40)
    V[2] = 0.0
    np.testing.assert_allclose(
        to_np(enet.enet_norm(T(V), l1_ratio)),
        np.asarray(jenet.enet_norm(jnp.asarray(V), l1_ratio)), atol=1e-9)
    np.testing.assert_allclose(
        to_np(enet.enet_scale(T(V), l1_ratio, radius=2.0)),
        np.asarray(jenet.enet_scale(jnp.asarray(V), l1_ratio, radius=2.0)),
        atol=1e-9)


@pytest.mark.parametrize('l1_ratio', [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize('radius', [0.0, 0.5, 3.0, 1e3])
def test_enet_projection_matches_jax(l1_ratio, radius):
    """Exact sort projection, one row and batched, including the zero
    radius and the inside-the-ball identity (radius 1e3)."""
    V = np.random.RandomState(1).randn(4, 50)
    got = enet.enet_projection_batch(T(V), T(np.full(4, radius)), l1_ratio)
    want = jenet.enet_projection_batch(jnp.asarray(V),
                                       jnp.full(4, radius), l1_ratio)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-9)
    one = enet.enet_projection(T(V[0]), radius, l1_ratio)
    np.testing.assert_allclose(to_np(one), np.asarray(want)[0], atol=1e-9)


def _problem(seed, b=12, k=6, n=30):
    rng = np.random.RandomState(seed)
    X = rng.randn(b, n)
    D = rng.randn(k, n)
    G = D @ D.T
    return X, D, G, X @ D.T


def test_ridge_solvers_match_jax():
    X, D, G, Dx = _problem(0)
    np.testing.assert_allclose(
        to_np(solvers.ridge_single_gram(T(G), T(Dx), 0.1)),
        np.asarray(jsolvers.ridge_single_gram(jnp.asarray(G),
                                              jnp.asarray(Dx), 0.1)),
        atol=1e-9)
    rng = np.random.RandomState(1)
    Gs = np.stack([(lambda A: A @ A.T + np.eye(5))(rng.randn(5, 5))
                   for _ in range(8)])
    Dxs = rng.randn(8, 5)
    np.testing.assert_allclose(
        to_np(solvers.ridge_multi_gram(T(Gs), T(Dxs), 0.3)),
        np.asarray(jsolvers.ridge_multi_gram(jnp.asarray(Gs),
                                             jnp.asarray(Dxs), 0.3)),
        atol=1e-9)


@pytest.mark.parametrize('positive', [False, True])
@pytest.mark.parametrize('shared', [True, False])
def test_enet_cd_gram_matches_jax(positive, shared):
    """Same sweep order, bookkeeping and stop: float64 roundoff only."""
    X, D, G, Dx = _problem(2)
    Q = G if shared else np.stack([G + 0.1 * i * np.eye(6)
                                   for i in range(12)])
    w0 = np.ones_like(Dx)
    y2 = np.sum(X * X, axis=1)
    args = (0.5, 0.1, positive, 100, 1e-4)
    got = solvers.enet_cd_gram(T(w0), T(Q), T(Dx), T(y2), *args)
    want = jsolvers.enet_cd_gram(jnp.asarray(w0), jnp.asarray(Q),
                                 jnp.asarray(Dx), jnp.asarray(y2), *args)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-9)


@pytest.mark.parametrize('positive,shared', [
    (False, True), (True, True), (False, False), (True, False)],
    ids=['False', 'True', 'False-per_row', 'True-per_row'])
def test_fista_gram_matches_jax(positive, shared):
    """The same iterations, power iteration and stop as modl_tpu's: codes
    at float64 roundoff (1e-12; the readings are ~1e-16), with a shared
    Gram and with per-row Grams. CD stops on its own test, so FISTA and
    CD agree to the solver tolerance: within 1e-3 (tol 1e-6 here)."""
    X, D, G, Dx = _problem(3)
    Q = G if shared else np.stack([G + 0.1 * i * np.eye(6)
                                   for i in range(12)])
    w0 = np.zeros_like(Dx)
    y2 = np.sum(X * X, axis=1)
    args = (0.5, 0.1, positive, 2000, 1e-6)
    got = solvers.fista_gram(T(w0), T(Q), T(Dx), T(y2), *args)
    want = jsolvers.fista_gram(jnp.asarray(w0), jnp.asarray(Q),
                               jnp.asarray(Dx), jnp.asarray(y2), *args)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=1e-12)
    cd = solvers.enet_cd_gram(T(w0), T(Q), T(Dx), T(y2), 0.5, 0.1,
                              positive, 1000, 1e-10)
    np.testing.assert_allclose(to_np(got), to_np(cd), atol=1e-3)


@pytest.mark.parametrize('l1_ratio,solver', [(0.0, 'cd'), (1.0, 'cd'),
                                             (0.5, 'fista')])
def test_dispatchers_match_jax(l1_ratio, solver):
    X, D, G, Dx = _problem(4)
    w0 = np.ones_like(Dx)
    args = (l1_ratio, 0.2, False, 1e-8, 200)
    got = solvers.enet_regression_single_gram(T(w0), T(G), T(Dx), T(X),
                                              *args, solver=solver)
    want = jsolvers.enet_regression_single_gram(
        jnp.asarray(w0), jnp.asarray(G), jnp.asarray(Dx), jnp.asarray(X),
        *args, solver=solver)
    np.testing.assert_allclose(to_np(got), np.asarray(want),
                               atol=1e-9 if solver == 'cd' else 1e-4)
    Gs = np.stack([G] * 12)
    got = solvers.enet_regression_multi_gram(T(w0), T(Gs), T(Dx), T(X),
                                             *args, solver=solver)
    np.testing.assert_allclose(to_np(got), np.asarray(want),
                               atol=1e-9 if solver == 'cd' else 1e-4)


def test_full_f32_restores_flags():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with precision.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize('n,s', [(1000, 83), (200_000, 16_666),
                                 (200_000, 10_000), (50, 50)])
def test_binomial_len_max_matches_jax(n, s):
    assert sampler.binomial_len_max(n, s) == jsampler.binomial_len_max(n, s)


def test_window_starts_are_uniform():
    n = 40
    gen = torch.Generator().manual_seed(0)
    starts = [sampler.draw_window(0, gen, 10, n, True)[0]
              for _ in range(8000)]
    counts = np.bincount(starts, minlength=n)
    assert counts.shape == (n,)
    # each bin ~ Binomial(8000, 1/40): mean 200, std ~14
    assert np.all(np.abs(counts - 200) < 6 * 14), counts


def test_window_cycling_tiles_the_circle():
    gen = torch.Generator().manual_seed(0)
    cursor, starts = 0, []
    for _ in range(5):
        start, cursor = sampler.draw_window(cursor, gen, 7, 30, False)
        starts.append(start)
    assert starts == [0, 7, 14, 21, 28]


@pytest.mark.parametrize('replacement', [True, False])
def test_binomial_sizes_mean_and_std(replacement):
    n, s, len_max = 600, 50, sampler.binomial_len_max(600, 50)
    gen = torch.Generator().manual_seed(1)
    cursor, sizes = 0, []
    for _ in range(3000):
        start, m, new_cursor = sampler.draw_window_sized(
            cursor, gen, s, len_max, n, replacement)
        if not replacement:
            assert start == cursor % n and new_cursor == (cursor + m) % n
        cursor = new_cursor
        sizes.append(m)
    sizes = np.array(sizes)
    p = s / n
    mean, std = n * p, math.sqrt(n * p * (1 - p))
    assert sizes.min() >= 1 and sizes.max() <= len_max
    assert abs(sizes.mean() - mean) < 4 * std / math.sqrt(len(sizes))
    assert abs(sizes.std() - std) < 0.1 * std


@pytest.mark.parametrize('n,s', [(60, 12), (50, 12)])
def test_draw_subset_without_replacement_partitions(n, s):
    """Consecutive draws partition the features; at a cycle boundary the
    unserved tail is served first, then a re-shuffled new cycle."""
    gen = torch.Generator().manual_seed(2)
    box, cursor = sampler.init_sampler_state(n, gen)
    assert sorted(box.tolist()) == list(range(n))
    served = []
    for _ in range(n // s):
        sub, box, cursor = sampler.draw_subset(box, cursor, gen, s, False)
        assert len(set(sub.tolist())) == s
        served.extend(sub.tolist())
    assert len(set(served)) == len(served) == (n // s) * s
    tail = set(range(n)) - set(served)
    sub, box, cursor = sampler.draw_subset(box, cursor, gen, s, False)
    if tail:
        assert set(sub[:len(tail)].tolist()) == tail
    assert len(set(sub.tolist())) == s


def test_draw_subset_with_replacement_and_sized():
    n, s = 100, 20
    gen = torch.Generator().manual_seed(3)
    box, cursor = sampler.init_sampler_state(n, gen)
    for _ in range(12):
        sub, box, cursor = sampler.draw_subset(box, cursor, gen, s, True)
        assert len(set(sub.tolist())) == s and int(sub.max()) < n
    len_max = sampler.binomial_len_max(n, s)
    for replacement in (True, False):
        sub, m, box, cursor = sampler.draw_subset_sized(
            box, cursor, gen, s, len_max, replacement)
        assert sub.shape == (len_max,) and 1 <= m <= len_max
        assert len(set(sub[:m].tolist())) == m
