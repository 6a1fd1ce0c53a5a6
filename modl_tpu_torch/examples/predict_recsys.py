"""Collaborative filtering on MovieLens (counterpart of
``examples/predict_recsys.py``: ML-1M, 50 components, lr 0.95, detrend).

    python -m modl_tpu_torch.examples.predict_recsys [--version V]
        [--n-components K] [--n-epochs E] [--device D]

MovieLens from the modl data dir where it is there, otherwise a
synthetic planted-rank rating matrix.
"""
import argparse
import time

import scipy.sparse as sp

from ..decomposition.recsys import RecsysDictFact
from ..utils.recsys.cross_validation import train_test_split


class Callback:
    """Train and test RMSE after each callback, with the fit's time."""

    def __init__(self, X_tr, X_te):
        self.X_tr = X_tr
        self.X_te = X_te
        self.rmse_tr = []
        self.rmse_te = []
        self.times = []
        self.start_time = time.perf_counter()
        self.test_time = 0

    def __call__(self, mf):
        test_time = time.perf_counter()
        self.rmse_tr.append(mf.score(self.X_tr))
        self.rmse_te.append(mf.score(self.X_te))
        self.test_time += time.perf_counter() - test_time
        self.times.append(time.perf_counter() - self.start_time
                          - self.test_time)


def main(version='1m', n_components=50, n_epochs=10, learning_rate=0.95,
         alpha=1.0, beta=0.1, device='cuda'):
    try:
        from ..datasets.recsys import load_movielens
        X = load_movielens(version)
        print('MovieLens %s: %r, %d ratings' % (version, X.shape, X.nnz))
    except Exception as e:
        print('falling back to synthetic ratings (%s)' % e)
        from ..datasets.recsys import make_synthetic_ratings
        X = make_synthetic_ratings(n_users=3000, n_items=1500,
                                   density=0.04, seed=0)
    X_tr, X_te = train_test_split(X, train_size=0.75, random_state=0)
    X_tr = sp.csr_matrix(X_tr)
    X_te = sp.csr_matrix(X_te)

    cb = Callback(X_tr, X_te)
    mf = RecsysDictFact(n_components=n_components,
                        batch_size=None,
                        n_epochs=n_epochs,
                        alpha=alpha, beta=beta,
                        detrend=True,
                        learning_rate=learning_rate,
                        crop=(1., 5.),
                        verbose=5,
                        callback=cb,
                        random_state=0,
                        device=device)
    t0 = time.perf_counter()
    mf.fit(X_tr)
    dt = time.perf_counter() - t0
    print('fit in %.1fs; test RMSE %.4f' % (dt, mf.score(X_te)))
    if cb.rmse_te:
        print('test RMSE trajectory:', ['%.4f' % s for s in cb.rmse_te])
    return mf


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--version', default='1m')
    p.add_argument('--n-components', type=int, default=50)
    p.add_argument('--n-epochs', type=int, default=10)
    p.add_argument('--device', default='cuda')
    a = p.parse_args()
    main(version=a.version, n_components=a.n_components,
         n_epochs=a.n_epochs, device=a.device)
