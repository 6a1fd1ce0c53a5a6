"""The recsys and image workloads that ``chip_smoke.py`` and
``profile_estimators.py`` drive on the GPU: estimator settings, data and
step counts."""
import math

import scipy.sparse as sp

# bench.py:249-270's MovieLens-10M scale and RecsysDictFact settings
RECSYS_USERS, RECSYS_ITEMS, RECSYS_NNZ = 69_878, 10_677, 10_000_000
RECSYS = dict(n_components=50, alpha=1.0, beta=0.1, learning_rate=0.95,
              batch_size=None, detrend=True, crop=(1, 5), random_state=0)
RECSYS_EPOCHS = 2
# exps/exp_decompose_images.py:22-34 (4 epochs there, 1 here), on the
# face's size; the plain-path refit and the NMF fit take a subset
IMAGE = dict(method='masked', setting='dictionary learning',
             n_components=128, patch_size=(16, 16), reduction=8, alpha=0.08,
             batch_size=200, learning_rate=0.92, random_state=0)
IMAGE_SHAPE, IMAGE_TEST, IMAGE_SUBSET = (768, 1024), 2000, 20_000


def recsys_data():
    """bench.py:259-270's data: planted ratings at MovieLens-10M scale
    (seed 0), entries split 75/25 (random_state 0)."""
    from ..datasets.recsys import make_synthetic_ratings
    from ..utils.recsys.cross_validation import train_test_split
    density = RECSYS_NNZ / RECSYS_USERS / RECSYS_ITEMS
    X = make_synthetic_ratings(RECSYS_USERS, RECSYS_ITEMS, rank=12,
                               density=density, seed=0)
    X_tr, X_te = train_test_split(X, train_size=0.75, random_state=0)
    return sp.csr_matrix(X_tr), sp.csr_matrix(X_te)


def recsys_batch(X):
    """RecsysDictFact's batch size with ``batch_size=None``."""
    return int(math.ceil(1. / (X.nnz / X.shape[0] / X.shape[1])))


def image_steps(n_rows, est):
    """Steps of one epoch of ImageDictFact: batches of each buffer."""
    buffer = est.buffer_size or est.batch_size * 10
    return sum(-(-min(buffer, n_rows - lo) // est.batch_size)
               for lo in range(0, n_rows, buffer))
