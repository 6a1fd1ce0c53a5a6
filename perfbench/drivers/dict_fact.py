"""The driver of ``DictFact`` on dense rows resident on the device: the
data made on the device from the seed, the estimator prepared as
``DictFact.fit`` prepares it (the first k rows handed over as the
initial dictionary, the rows ingested once), ``fit``'s epoch loop
(``_partial_fit_ingested`` over the rows in the shuffles' composed
order, then ``shuffle``), the plain reference of ``reference/somf.py``,
and the counts of the per-layer shares from the configuration's sizes."""
import numpy as np
import torch

from . import CHECKED_EPOCHS, EPOCH_SPAN, SHUFFLE_SPAN, sync
from .. import checks
from ..reference import somf


def make_data(cfg, seed, device):
    """The configuration's rows, float32 on ``device``, from ``seed``:
    ``planted``, a low-rank model plus noise (``bench.py``'s ADHD-70
    data: U V / divisor + noise, U and V Gaussian), or ``gaussian``."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, p = cfg['n_samples'], cfg['n_features']
    kw = dict(generator=g, device=device)
    if cfg['data'] == 'gaussian':
        return torch.randn(n, p, **kw)
    if cfg['data'] == 'planted':
        r = cfg['planted_rank']
        U = torch.randn(n, r, **kw)
        V = torch.randn(r, p, **kw).div_(cfg['planted_divisor'])
        X = torch.randn(n, p, **kw).mul_(cfg['planted_noise'])
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return X.addmm_(U, V)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    raise ValueError(f'unknown data {cfg["data"]!r}')


class FitLoop:
    """``DictFact.fit``'s epoch loop over ingested rows ``X_dev``: the
    epoch in the shuffles' composed row order, then ``shuffle``."""

    def __init__(self, est, X_dev):
        self.est, self.X, self.rows = est, X_dev, None

    def epoch(self):
        est, X = self.est, self.X
        with torch.profiler.record_function(EPOCH_SPAN):
            est._partial_fit_ingested(X, None, rows=None if self.rows is None
                                      else torch.as_tensor(self.rows,
                                                           device=X.device))
        with torch.profiler.record_function(SHUFFLE_SPAN):
            perm = est.shuffle()
        self.rows = perm if self.rows is None else self.rows[perm]


def snapshot(est):
    """D, C and B in the data's feature order, host copies."""
    return (np.array(est.components_, copy=True), np.array(est.C_, copy=True),
            np.array(est.B_, copy=True))


def prepare(cfg, traffic, data_seed, est_seed, device):
    """A ``DictFact`` prepared as ``DictFact.fit`` prepares it, driven
    through the checked epochs; returns ``(loop, program)``: the
    :class:`FitLoop` and ``[D0, (D, C, B) after each checked epoch]``."""
    from modl_tpu_torch import DictFact
    params = cfg['estimator']
    X = make_data(cfg, data_seed, device)
    est = DictFact(**params, random_state=est_seed, device=device,
                   verbose=traffic['verbose'], n_epochs=traffic['n_epochs'])
    est.prepare(n_samples=X.shape[0], X=X[:params['n_components']].cpu()
                .numpy(), dtype=np.float32)
    loop = FitLoop(est, est._ingest_features(X))
    del X
    program = [np.array(est.components_, copy=True)]
    for _ in range(CHECKED_EPOCHS):
        loop.epoch()
        program.append(snapshot(est))
    sync(device)
    return loop, program


def reference(cfg, data_seed, est_seed, device, precision='float64'):
    """The plain reference's ``[D0, (D, C, B) after each checked
    epoch]`` on the same data, remade from the seed."""
    X = make_data(cfg, data_seed, device)
    return somf.fit(X, cfg['estimator'], est_seed, CHECKED_EPOCHS,
                    precision)


compare = checks.compare


def steps_per_epoch(cfg):
    return cfg['n_samples'] // cfg['estimator']['batch_size']


def bcd_counts(cfg):
    """(operations, bytes) of one step's dictionary update, counted from
    the configuration's sizes, k atoms over the s = n_features /
    reduction columns of a subset, whatever launches carry it (one call,
    or the block driver's): 4 k^2 s operations (the residual and the k
    rank-1 updates) and 4 (3 k s + k^2 + 3 k) bytes (D, the gradient and
    C read once, D written once, the budgets read and written)."""
    k = cfg['estimator']['n_components']
    s = int(cfg['n_features'] / cfg['estimator']['reduction'])
    return 4 * k * k * s, 4 * (3 * k * s + k * k + 3 * k)


def epoch_counts(cfg):
    """(operations, bytes) of one epoch. Per step of b rows, k atoms, s =
    n_features / reduction subset columns and n features: 2 b s k (masked
    Dx) + 2 s k^2 (masked G) + k^3 / 3 (the Cholesky factor) + 2 b k^2
    (the code solve) + 2 b k^2 (the C EMA) + 2 b k n (the B EMA) + 4 k^2
    s (the dictionary update) operations; per epoch of N rows, 4 (N n +
    4 k n) bytes: X read once, B and D read and written once."""
    est = cfg['estimator']
    k, b = est['n_components'], est['batch_size']
    N, n = cfg['n_samples'], cfg['n_features']
    s = int(n / est['reduction'])
    step = (2 * b * s * k + 2 * s * k * k + k ** 3 / 3 + 2 * b * k * k
            + 2 * b * k * k + 2 * b * k * n + 4 * k * k * s)
    return step * (N // b), 4 * (N * n + 4 * k * n)


class Work:
    """The work of the window's epochs, from the configuration's sizes
    alone: every step and every epoch alike."""

    def __init__(self, cfg):
        self.cfg = cfg

    def steps(self, n_epochs):
        return n_epochs * steps_per_epoch(self.cfg)

    def bcd(self, n_epochs):
        return [(self.steps(n_epochs),) + bcd_counts(self.cfg)]

    def epoch(self, n_epochs):
        return [(n_epochs,) + epoch_counts(self.cfg)]


def work(cfg, loop):
    return Work(cfg)
