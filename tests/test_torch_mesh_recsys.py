"""The port's recsys fit on a dp mesh against modl_tpu's, on the CPU:
the recsys cases of tests/test_parallel.py one for one.

The port's ranks run in one gloo world of 8 processes started by
``parallel.launch.spawn`` (tests/torch_mesh_ranks.py) on an (8, 1)
``DeviceMesh``; modl_tpu's mesh fits run here on the conftest's eight
virtual CPU devices. Both take the same data and ``random_state`` (the
recsys draws are numpy's in both packages), at float64:

- the resident fit, its packed rows split over dp, against modl_tpu's
  mesh fit to 1e-9 and the port's single-process fit;
- the odd batch (7 rows over 8 ranks: replicated), and a fit whose rows
  are packed batch by batch;
- the union-BCD kernel route under the mesh (its plain version on the
  CPU; float32, the kernel's dtype), one call a batch on every rank;
- a mesh without a dp axis is refused; a pickle drops the mesh.
"""
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

import modl_tpu.decomposition.recsys as jrec
import torch_mesh_ranks as ranks
from modl_tpu.parallel import make_mesh as jax_make_mesh
import modl_tpu_torch.decomposition.recsys as trec
from modl_tpu_torch import RecsysDictFact
from modl_tpu_torch.parallel.launch import spawn

WORLD = 8


def _ratings(n, m, k, density, seed):
    rng = np.random.RandomState(seed)
    dense = rng.randn(n, k) @ rng.randn(k, m)
    mask = rng.rand(n, m) < density
    return sp.csr_matrix(np.where(mask, dense, 0.0))


CASES = {
    'resident': dict(X=_ratings(260, 40, 3, 0.35, 0),
                     kw=dict(n_components=3, alpha=1e-2, learning_rate=0.9,
                             batch_size=8, n_epochs=2, random_state=0)),
    'odd': dict(X=_ratings(130, 24, 3, 0.4, 3),
                kw=dict(n_components=3, alpha=1e-2, learning_rate=0.9,
                        batch_size=7, n_epochs=1, random_state=0)),
    'per_batch': dict(X=_ratings(130, 24, 3, 0.4, 4), budget=0,
                      kw=dict(n_components=3, alpha=1e-2, learning_rate=0.9,
                              batch_size=8, n_epochs=1, random_state=0)),
    # the kernel takes float32 state
    'kernel': dict(X=_ratings(96, 48, 8, 0.4, 5).astype(np.float32),
                   kernel=True, dtype=np.float32,
                   kw=dict(n_components=8, alpha=1e-2, learning_rate=0.9,
                           batch_size=8, n_epochs=1, random_state=0)),
}


@pytest.fixture(scope='module')
def world():
    cases = {name: dict(case, kw=dict(case['kw'], dtype=case.get(
        'dtype', np.float64))) for name, case in CASES.items()}
    results = spawn(ranks.recsys_world, WORLD, backend='gloo', device='cpu',
                    timeout=180, args=(cases,))
    return results


def _jax_fit(name, monkeypatch=None, mesh=True):
    case = CASES[name]
    if case.get('budget') is not None:
        monkeypatch.setattr(jrec, 'RESIDENT_BUDGET', case['budget'])
    return jrec.RecsysDictFact(mesh=jax_make_mesh(8, 1) if mesh else None,
                               **case['kw']).fit(case['X'].copy())


def _single(name, monkeypatch=None):
    case = CASES[name]
    if case.get('kernel'):
        step = trec._recsys_batch_step
        monkeypatch.setattr(trec, '_recsys_batch_step', lambda *a, **kw: step(
            *a, **dict(kw, use_kernel=True)))
    return RecsysDictFact(device='cpu', dtype=case.get('dtype', np.float64),
                          **case['kw']).fit(case['X'].copy())


def _check(got, ref, single, rtol=1e-9, atol=1e-11):
    """Against modl_tpu's fit (codes at float64 only, as
    tests/test_parallel.py) and the port's single-process fit."""
    np.testing.assert_allclose(got['components'], ref.components_,
                               rtol=rtol, atol=atol)
    if ref.code_.dtype == np.float64:
        np.testing.assert_allclose(got['code'], ref.code_, rtol=1e-8,
                                   atol=1e-10)
    assert got['n_iter'] == ref.n_iter_
    np.testing.assert_allclose(got['components'], single.components_,
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got['code'], single.code_, rtol=1e-12,
                               atol=1e-14)


def test_recsys_mesh_resident_matches_jax_mesh_and_single(world):
    got = world[0]['resident']
    ref = _jax_fit('resident')
    _check(got, ref, _single('resident'))
    assert abs(got['score'] - ref.score(CASES['resident']['X'])) < 1e-9
    # the packed rows live 1/8 a rank: 260 rows padded to 264
    assert got['resident_rows'] == 264 // 8
    assert got['resident_width'] is not None
    assert got['collectives']['calls_dp'] > 0


def test_recsys_mesh_resident_odd_batch(world):
    _check(world[0]['odd'], _jax_fit('odd'), _single('odd'))


def test_recsys_mesh_per_batch_packing(world, monkeypatch):
    """Rows packed batch by batch: held against modl_tpu's single-device
    fit (its mesh fit takes the resident path only: the per-window path
    fails on a mesh there, a name clash at recsys.py:848-856)."""
    got = world[0]['per_batch']
    assert got['resident_width'] is None
    _check(got, _jax_fit('per_batch', monkeypatch, mesh=False),
           _single('per_batch'))


def test_recsys_union_bcd_route_under_mesh(world, monkeypatch):
    """The route a CUDA fit takes (``bcd_kernel`` -> ``bcd.bcd_update``,
    whose plain version runs on CPU tensors), float32: one call a batch
    on every rank; the port's single-process fit on the same route to
    roundoff, and modl_tpu's float32 mesh fit (its lax update) to the
    tolerances of tests/test_parallel.py's kernel-under-mesh case."""
    got = world[0]['kernel']
    assert got['bcd_calls'] == 96 // 8
    ref = _jax_fit('kernel')
    assert ref.components_.dtype == np.float32
    _check(got, ref, _single('kernel', monkeypatch), rtol=5e-3, atol=5e-4)
    assert abs(got['score'] - ref.score(CASES['kernel']['X'])) < 1e-3


def test_ranks_hold_the_same_recsys_dictionary(world):
    for name in CASES:
        for res in world[1:]:
            np.testing.assert_array_equal(res[name]['components'],
                                          world[0][name]['components'])


def test_recsys_mesh_needs_a_dp_axis(world):
    assert "requires a mesh with a 'dp' axis" in world[0]['no_dp']


def test_pickled_recsys_mesh_estimator_is_single_process(world):
    est = pickle.loads(world[0]['resident']['pickle'])
    assert est.mesh is None
    np.testing.assert_array_equal(est.components_,
                                  world[0]['resident']['components'])
    X = CASES['resident']['X']
    assert est.code_.shape == (X.shape[0], 3)
    assert est.score(X) == pytest.approx(world[0]['resident']['score'],
                                         rel=1e-12)
