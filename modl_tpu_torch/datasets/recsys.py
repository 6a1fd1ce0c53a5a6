"""Recsys datasets: MovieLens and Netflix loaders and a planted generator.

Counterpart of ``modl_tpu/datasets/recsys.py``. ``load_movielens`` reads
the pickled sparse matrix or the raw GroupLens ``ratings.dat`` /
``ratings.csv`` from the data-dir chain; ``make_synthetic_ratings``
returns the JAX package's planted matrix bit for bit. ``joblib`` is
imported only by the loaders that read pickles.
"""
import os

import numpy as np
import scipy.sparse as sp

from . import get_data_dirs

__all__ = ["load_movielens", "load_netflix", "load_recsys",
           "make_synthetic_ratings"]


def load_movielens(version):
    data_dir = get_data_dirs()[0]
    for candidate in (os.path.join(data_dir, 'movielens%s' % version,
                                   'X_csr.pkl'),
                      os.path.join(data_dir, 'movielens%s' % version)):
        if os.path.exists(candidate):
            if candidate.endswith('.pkl'):
                from joblib import load
                return load(candidate)
            return _load_grouplens_dir(candidate)
    raise IOError('MovieLens %s not found under %s; set MODL_DATA or '
                  'MODL_SHARED_DATA' % (version, data_dir))


def _load_grouplens_dir(path):
    for name, sep in (('ratings.dat', '::'), ('ratings.csv', ',')):
        f = os.path.join(path, name)
        if os.path.exists(f):
            raw = np.genfromtxt(f, delimiter=sep, skip_header=name.endswith(
                'csv'), usecols=(0, 1, 2))
            rows = raw[:, 0].astype(int)
            cols = raw[:, 1].astype(int)
            vals = raw[:, 2]
            return sp.csr_matrix(
                (vals, (rows - rows.min(), cols - cols.min())))
    raise IOError('No ratings file in %s' % path)


def load_netflix():
    """Pre-split (X_tr, X_te) Netflix matrices."""
    data_dir = os.path.join(get_data_dirs()[0], 'nf_prize')
    from joblib import load
    try:
        return load(os.path.join(data_dir, 'X_tr.pkl')), \
            load(os.path.join(data_dir, 'X_te.pkl'))
    except FileNotFoundError as e:
        raise IOError('Netflix data not found under %s' % data_dir) from e


def load_recsys(dataset, random_state=None):
    """(X_train, X_test) CSR pair of a named recsys dataset: MovieLens
    versions are entry-split 75/25, Netflix ships pre-split."""
    if dataset in ('100k', '1m', '10m'):
        from ..utils.recsys.cross_validation import train_test_split
        X = load_movielens(dataset)
        X_tr, X_te = train_test_split(X, train_size=0.75,
                                      random_state=random_state)
        return X_tr.tocsr(), X_te.tocsr()
    if dataset == 'netflix':
        return load_netflix()
    raise ValueError('Unknown recsys dataset %r' % (dataset,))


def make_synthetic_ratings(n_users=1000, n_items=500, rank=10,
                           density=0.05, noise=0.1, crop=(1., 5.),
                           seed=0):
    """Planted low-rank rating matrix with a random observation mask."""
    rng = np.random.RandomState(seed)
    U = rng.randn(n_users, rank) / np.sqrt(rank)
    V = rng.randn(rank, n_items)
    nnz = int(density * n_users * n_items)
    rows = rng.randint(n_users, size=nnz)
    cols = rng.randint(n_items, size=nnz)
    vals = np.sum(U[rows] * V[:, cols].T, axis=1)
    vals += noise * rng.randn(nnz)
    # map to a rating-like scale
    vals = np.clip((vals - vals.mean()) / (vals.std() + 1e-12) + 3.0,
                   crop[0], crop[1])
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n_users, n_items))
    X.sum_duplicates()
    # duplicate (u, i) draws summed above may exceed the rating scale
    X.data = np.clip(X.data, crop[0], crop[1])
    return X
