"""The port's host helpers and profiling against modl_tpu.

- ``get_sub_slice``, ``concatenated_cv``, the cache and output
  directories, ``RandomState``, the host ``Sampler`` and
  ``make_synthetic_rest_data`` are numpy in both packages: the same
  seeds give the same values, and the properties of
  ``tests/test_random.py`` and ``tests/test_sampler.py`` hold;
- ``enet_projection_bisect`` and the Amari discrepancy run on torch and
  are held against the JAX functions at float64;
- ``utils/profiling.py`` keeps ``tests/test_profiling.py``'s contract
  on the CPU.
"""
import os
import pickle
import types
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import modl_tpu.datasets.adhd as jadhd
import modl_tpu.decomposition.stability as jstab
import modl_tpu.utils as jutils
import modl_tpu.utils.random as jrandom
import modl_tpu.utils.system as jsystem
from modl_tpu.ops import Sampler as JaxSampler
from modl_tpu.ops.enet import enet_projection_bisect as jax_bisect
from modl_tpu_torch import utils as tutils
from modl_tpu_torch.datasets import adhd as tadhd
from modl_tpu_torch.decomposition import stability as tstab
from modl_tpu_torch.ops.enet import enet_projection, enet_projection_bisect
from modl_tpu_torch.ops.sampler import Sampler
from modl_tpu_torch.utils import random as trandom
from modl_tpu_torch.utils import system as tsystem
from modl_tpu_torch.utils.profiling import (StepTimer, device_busy_s,
                                            device_summary,
                                            device_trace, idle_gaps,
                                            sync)

T = torch.as_tensor


@pytest.mark.parametrize('outer, inner', [
    (None, slice(2, 5)), (slice(10, 20), slice(2, 5)),
    (np.array([5, 7, 9, 11]), slice(1, 3)), (None, np.array([1, 2])),
    (slice(3, None), np.array([0, 4]))])
def test_get_sub_slice_matches_jax(outer, inner):
    np.testing.assert_array_equal(tutils.get_sub_slice(outer, inner),
                                  jutils.get_sub_slice(outer, inner))


def test_concatenated_cv_matches_jax():
    def gen(base):
        yield np.array([base, base + 1]), np.array([base + 2])
        yield np.array([base + 3]), np.array([base, base + 4])

    for (a_tr, a_te), (b_tr, b_te) in zip(
            tutils.concatenated_cv([gen(0), gen(10)]),
            jutils.concatenated_cv([gen(0), gen(10)])):
        np.testing.assert_array_equal(a_tr, b_tr)
        np.testing.assert_array_equal(a_te, b_te)


def test_directories_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv('SHARED_CACHE', str(tmp_path / 'a'))
    monkeypatch.setenv('CACHE', str(tmp_path / 'b'))
    monkeypatch.setenv('MODL_OUTPUT', str(tmp_path / 'out'))
    assert tsystem.get_cache_dirs() == jsystem.get_cache_dirs()
    assert tsystem.get_cache_dirs('/c') == jsystem.get_cache_dirs('/c')
    assert tsystem.get_output_dir() == jsystem.get_output_dir()
    assert tsystem.get_output_dir('/x') == jsystem.get_output_dir('/x')
    monkeypatch.delenv('MODL_OUTPUT')
    assert tsystem.get_output_dir() == jsystem.get_output_dir()


def test_random_state_stream_matches_jax():
    a, b = trandom.RandomState(3), jrandom.RandomState(3)
    assert [a.randint(9) for _ in range(50)] == \
        [b.randint(9) for _ in range(50)]
    np.testing.assert_array_equal(a.permutation(40), b.permutation(40))
    assert a.binomial(100, 0.3) == b.binomial(100, 0.3)
    xa, xb = np.arange(60.).reshape(20, 3), np.arange(60.).reshape(20, 3)
    ya, yb = np.arange(20), np.arange(20)
    np.testing.assert_array_equal(a.shuffle_with_trace([xa, ya]),
                                  b.shuffle_with_trace([xb, yb]))
    np.testing.assert_array_equal(xa, xb)


def test_random_state_properties():
    rng = trandom.RandomState(0)
    draws = np.array([rng.randint(10) for _ in range(5000)])
    assert draws.min() == 0 and draws.max() == 10     # inclusive bound
    x = np.arange(60, dtype=float).reshape(20, 3)
    orig = x.copy()
    trace = rng.shuffle_with_trace([x])
    np.testing.assert_array_equal(x, orig[trace])
    # pickling restarts the stream from the construction seed
    rng = trandom.RandomState(5)
    first = rng.permutation(30)
    twin = pickle.loads(pickle.dumps(rng))
    np.testing.assert_array_equal(twin.permutation(30), first)
    with pytest.raises(ValueError):
        trandom.RandomState('seed')


@pytest.mark.parametrize('rand_size', [False, True])
@pytest.mark.parametrize('replacement', [False, True])
def test_sampler_matches_jax(rand_size, replacement):
    a = Sampler(37, rand_size=rand_size, replacement=replacement,
                random_seed=4)
    b = JaxSampler(37, rand_size=rand_size, replacement=replacement,
                   random_seed=4)
    for _ in range(12):
        np.testing.assert_array_equal(a.yield_subset(4), b.yield_subset(4))


def test_sampler_properties():
    s = Sampler(100, rand_size=False, replacement=False, random_seed=0)
    union = np.sort(np.concatenate([s.yield_subset(4) for _ in range(4)]))
    np.testing.assert_array_equal(union, np.arange(100))
    s = Sampler(500, rand_size=True, replacement=True, random_seed=0)
    assert abs(np.mean([len(s.yield_subset(5)) for _ in range(300)])
               - 100) < 5


@pytest.mark.parametrize('l1_ratio', [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize('radius', [0.5, 1.0, 3.0])
def test_enet_projection_bisect_matches_jax(l1_ratio, radius):
    """Against the JAX bisection at float64, and against the exact
    projection at ``tests/test_enet.py``'s 1e-7."""
    rng = np.random.RandomState(7)
    for _ in range(5):
        v = rng.randn(80) * 2
        ours = enet_projection_bisect(T(v), radius, l1_ratio, n_iter=60)
        theirs = np.asarray(jax_bisect(jnp.asarray(v), radius, l1_ratio,
                                       n_iter=60))
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-12,
                                   atol=1e-14)
        exact = enet_projection(T(v), radius, l1_ratio)
        np.testing.assert_allclose(ours.numpy(), exact.numpy(), atol=1e-7)
    zero = enet_projection_bisect(T(v), 0.0, l1_ratio)
    assert not zero.any()


def test_amari_discrepency_matches_jax():
    rng = np.random.RandomState(0)
    D, D2 = rng.randn(6, 30), rng.randn(6, 30)
    perm, scales = rng.permutation(6), (rng.rand(6) + 0.5)[:, None]
    assert tstab.amari_discrepency(D, D) < 1e-10
    assert tstab.amari_discrepency(D, D[perm] * scales) < 1e-10
    assert tstab.amari_discrepency(D, D2) > 0.05
    assert tstab.amari_discrepency(D, D2) == pytest.approx(
        jstab.amari_discrepency(D, D2), rel=1e-12)
    dicts = [rng.randn(4, 20) for _ in range(4)]
    np.testing.assert_allclose(tstab.mean_amari_discrepency(dicts),
                               jstab.mean_amari_discrepency(dicts),
                               rtol=1e-12)


def test_synthetic_rest_data_matches_jax():
    kw = dict(n_subjects=2, n_frames=7, shape=(4, 5, 3), n_networks=3,
              seed=2)
    data, mask, maps = tadhd.make_synthetic_rest_data(**kw)
    jdata, jmask, jmaps = jadhd.make_synthetic_rest_data(**kw)
    for a, b in zip(data, jdata):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(maps, jmaps)
    assert data[0].shape == (4, 5, 3, 7)
    with pytest.raises(ImportError, match='make_synthetic_rest_data'):
        tadhd.fetch_adhd(n_subjects=1)


@dataclass
class _Holder:
    name: str
    value: torch.Tensor


def test_sync_returns_scalar():
    x = torch.arange(8.0)
    assert isinstance(sync(x), float)
    assert sync({'a': x + 1, 'b': x}) == 1.0
    assert sync([None, (x * 2,)]) == 0.0
    assert sync(_Holder('h', x + 3)) == 3.0


def test_step_timer_on_the_cpu():
    t = StepTimer(device='cpu')
    x = torch.arange(128.0)
    for _ in range(3):
        with t.measure(result_fn=lambda: x):
            x * 2
    assert t.count == 3
    assert t.total > 0
    assert t.mean == t.total / 3


def test_device_trace_on_the_cpu(tmp_path):
    with device_trace(str(tmp_path), device='cpu') as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / 'trace.json') > 0
    busy, ops, reads, events = device_summary(prof)
    assert (busy, ops, events) == (0.0, 0, [])
    assert reads >= 0


def test_device_busy_sums_the_card_s_raw_events(tmp_path):
    """The device's kernels and copies among the raw events, once each
    (ns); host events do not count; a CPU trace has none."""
    def raw(device, start, ns):
        return types.SimpleNamespace(
            device_type=lambda: types.SimpleNamespace(name=device),
            start_ns=lambda: start, duration_ns=lambda: ns,
            is_user_annotation=lambda: False)
    events = [raw('CUDA', 0, 2_000_000), raw('CPU', 0, 9_000_000),
              raw('CUDA', 3_000_000, 500_000)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert device_busy_s(prof) == 0.0025
    with device_trace(str(tmp_path), device='cpu') as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert device_busy_s(prof) == 0.0


def _event(device, start, end, key='k', count=1):
    return types.SimpleNamespace(
        device_type=types.SimpleNamespace(name=device), key=key,
        count=count, time_range=types.SimpleNamespace(start=start, end=end),
        is_user_annotation=False)


def test_idle_gaps_sum_the_card_s_long_gaps():
    """Device spans (us) with gaps of 1,500 and 700 us and overlapping
    spans; host events do not count."""
    events = [_event('CUDA', 0, 100), _event('CUDA', 50, 400),
              _event('CPU', 400, 5000), _event('CUDA', 1900, 2000),
              _event('CUDA', 2700, 2800), _event('CUDA', 2850, 2900)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert idle_gaps(prof, 0.5) == (2, 2.2)
    assert idle_gaps(prof, 1.0) == (1, 1.5)
    assert idle_gaps(types.SimpleNamespace(events=lambda: []), 0.5) == \
        (0, 0.0)


def test_host_reads_count_the_host_generator_s_draws(tmp_path):
    """``device_summary``'s host reads are scalar reads of any tensor: a
    step's draws on the host generator (a Binomial size and a box
    offset) make two, with no wait for a card."""
    from modl_tpu_torch import DictFact
    from modl_tpu_torch.decomposition._step import draw_step
    X = np.random.RandomState(0).randn(300, 256).astype(np.float32)
    df = DictFact(n_components=8, reduction=8, batch_size=20,
                  random_state=0, device='cpu').prepare(n_samples=300, X=X)
    assert df._cfg.rand_size and not df._cfg.windowed
    with device_trace(str(tmp_path), device='cpu') as prof:
        for _ in range(10):
            draw_step(df._state, df._cfg)
    assert device_summary(prof)[2] == 20
