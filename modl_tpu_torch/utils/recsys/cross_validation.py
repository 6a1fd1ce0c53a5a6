"""Entry-level train/test splitting of sparse rating matrices.

Counterpart of ``modl_tpu/utils/recsys/cross_validation.py``, numpy
only: the stored entries of a sparse matrix are partitioned while its
shape is kept, so both folds address the same user/item index space.
The same ``random_state`` gives the JAX package's folds.
"""
import numpy as np
import scipy.sparse as sp

__all__ = ["ShuffleSplit", "train_test_split", "cross_val_score"]


def _coo_triplets(X):
    X = sp.coo_matrix(X)
    return X.shape, X.row, X.col, X.data


def _from_mask(shape, rows, cols, vals, mask):
    return sp.coo_matrix((vals[mask], (rows[mask], cols[mask])), shape=shape)


def _entry_split(X, train_size, rng):
    """One random (train, test) partition of X's stored entries."""
    shape, rows, cols, vals = _coo_triplets(X)
    n_entries = vals.shape[0]
    n_train = int(train_size * n_entries)
    in_train = np.zeros(n_entries, dtype=bool)
    in_train[rng.choice(n_entries, size=n_train, replace=False)] = True
    return (_from_mask(shape, rows, cols, vals, in_train),
            _from_mask(shape, rows, cols, vals, ~in_train))


class ShuffleSplit:
    """Yields ``n_iter`` independent random entry partitions of X."""

    def __init__(self, n_iter=5, train_size=0.75, random_state=None):
        self.n_iter = n_iter
        self.train_size = train_size
        self.random_state = random_state

    def split(self, X):
        rng = np.random.default_rng(self.random_state)
        for _ in range(self.n_iter):
            yield _entry_split(X, self.train_size, rng)

    def __len__(self):
        return self.n_iter


def train_test_split(X, train_size=0.75, random_state=None):
    rng = np.random.default_rng(random_state)
    return _entry_split(X, train_size, rng)


def cross_val_score(estimator, X, cv):
    return np.array([estimator.fit(X_tr).score(X_te)
                     for X_tr, X_te in cv.split(X)])
