"""The driver of ``RecsysDictFact`` on sparse ratings: the rating matrix
made from the seed with the configuration's shape and skew, the
estimator set up as ``RecsysDictFact.fit`` sets it up (``_start``),
``fit``'s epoch loop (one ``recsys_epoch`` a window epoch, then the
sync that ends ``fit``'s epochs), the plain reference of
``reference/recsys.py``, and the counts of the per-layer shares from
the configuration's sizes, the data and the reference's draws.

The data (:func:`make_data`): ``n_samples`` users, ``n_features`` films
and ``n_ratings`` distinct ratings.

- Users' counts (:func:`user_counts`): a lognormal with a free
  location, floored at ``users['min']``: ``max(min, loc + exp(mu +
  sigma z))`` at the standard normal's quantiles ``z`` of ``(i + 1/2) /
  n_samples``, ``loc`` and ``mu`` set so that the middle user has
  ``users['median']`` and the last ``users['max']``, and ``sigma`` so
  that the counts sum to ``n_ratings``; each capped at the films,
  rounded by largest remainders. Each user's training count is
  ``train_share`` of it, rounded the same way to ``floor(train_share *
  n_ratings)`` in all. The counts are the same for every seed; the seed
  deals them to the users.
- Films' popularity: a lognormal of shape ``films['sigma']`` at the
  films' quantiles, dealt to the films by the seed. Each user rates
  their count of distinct films drawn without replacement with
  probabilities in proportion to the popularity (the smallest of
  exponential keys over the popularity), and a uniform draw among them
  picks the training ones.
- Values: ``values['mean']`` plus a user's and a film's Gaussian bias
  (``user_sd``, ``film_sd``), a rank-``values['rank']`` Gaussian model
  (``factor_sd``) and Gaussian noise (``noise_sd``), rounded to the
  nearest multiple of ``step`` and clipped to ``[min, max]``.

The draws run on ``device`` from one generator, in blocks of
``BLOCK`` users; the training entries and the held-out ones are kept
apart.

``correct`` (:func:`compare`) reads the fit from the seed alone: the
initial dictionary and the films' visits exactly; D, C and B after the
fit's first ``LOCKS`` batches, where the float32 fit still follows the
float64 reference (from the same start two sound float32 fits part by
O(1) within the first epoch: its early, heavily weighted batches
amplify rounding; ``PERF.md``); and the held-out RMSE of the fit's
predictions after the ``KEPT`` epochs. The program's leaves after those
batches are copied around ``recsys._run``, the call that
``recsys_epoch`` makes for each group of batches (windows of 32 from
the epoch's start), during set-up, which runs the window's own call.
"""
import contextlib
import functools
from collections import namedtuple

import numpy as np
import scipy.sparse as sp
import torch

from . import CHECKED_EPOCHS, EPOCH_SPAN, sync
from .. import checks
from ..reference import recsys as plain

# users a block of the generator's draws holds
BLOCK = 2048
# the batches from the fit's start after which D, C and B are compared
LOCKS = (32,)
# the epochs after which the held-out RMSE is compared; the reference
# runs as far as the last
KEPT = (1, 2)

Ratings = namedtuple('Ratings', 'X test stats')


def _largest_remainder(real, total):
    """Integers that sum to ``total``, each the floor of ``real`` or one
    more, the ones more where the remainders are largest (ties by
    position)."""
    out = np.floor(real).astype(np.int64)
    extra = int(total - out.sum())
    if extra:
        out[np.argsort(-(real - out), kind='stable')[:extra]] += 1
    return out


def _normal_quantiles(count):
    return torch.special.ndtri((torch.arange(count, dtype=torch.float64)
                                + 0.5) / count).numpy()


def _lognormal_quantiles(count, sigma):
    """``exp(sigma z)`` at the standard normal's quantiles ``(i + 1/2) /
    count``, ascending, the largest 1."""
    z = _normal_quantiles(count)
    return np.exp(sigma * (z - z[-1]))


def _floored_lognormal(z, low, median, top, sigma):
    """``max(low, loc + exp(mu + sigma z))``, ``loc`` and ``mu`` such
    that ``z = 0`` gives ``median`` and the largest ``z`` gives ``top``."""
    scale = (top - median) / np.expm1(sigma * z[-1])
    return np.maximum(low, median - scale + scale * np.exp(sigma * z))


@functools.lru_cache(maxsize=4)
def _user_counts(n_users, n_films, n_ratings, low, median, top,
                 train_share):
    z = _normal_quantiles(n_users)
    cap = min(n_films, top)
    lo, hi = 1e-3, 16.0          # the total falls as sigma grows
    for _ in range(200):
        sigma = (lo + hi) / 2
        total = np.minimum(cap, _floored_lognormal(z, low, median, top,
                                                   sigma)).sum()
        lo, hi = (sigma, hi) if total > n_ratings else (lo, sigma)
    real = np.minimum(cap, _floored_lognormal(z, low, median, top, hi))
    real *= n_ratings / real.sum()
    counts = _largest_remainder(np.minimum(cap, real), n_ratings)
    train = _largest_remainder(train_share * counts,
                               int(train_share * n_ratings))
    return counts, train, hi


def user_counts(cfg):
    """Every user's ratings and training ratings, ascending by quantile
    (the same for every seed): two int64 arrays, and the law's
    ``sigma``."""
    users = cfg['users']
    counts, train, sigma = _user_counts(
        cfg['n_samples'], cfg['n_features'], cfg['n_ratings'],
        users['min'], users['median'], users['max'], cfg['train_share'])
    return counts.copy(), train.copy(), sigma


def make_data(cfg, seed, device):
    """The training ratings as a float64 CSR matrix on the host, and what
    they hold (``stats``), made from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    U, n = cfg['n_samples'], cfg['n_features']
    values = cfg['values']
    kw = dict(generator=g, device=device)
    counts, train, _ = user_counts(cfg)
    deal = torch.randperm(U, **kw).cpu().numpy()
    counts, train = counts[deal], train[deal]
    popularity = torch.from_numpy(_lognormal_quantiles(
        n, cfg['films']['sigma'])).to(device, torch.float32)
    popularity = popularity[torch.randperm(n, **kw)]
    rank = values['rank']
    user_f = torch.randn(U, rank, **kw)
    film_f = torch.randn(n, rank, **kw)
    user_b = torch.randn(U, **kw).mul_(values['user_sd'])
    film_b = torch.randn(n, **kw).mul_(values['film_sd'])
    counts_d = torch.from_numpy(counts).to(device)
    train_d = torch.from_numpy(train).to(device)
    rated = torch.zeros(n, dtype=torch.int64, device=device)
    rated_train = torch.zeros(n, dtype=torch.int64, device=device)
    out = {True: ([], [], []), False: ([], [], [])}
    for r0 in range(0, U, BLOCK):
        m = min(BLOCK, U - r0)
        chosen = _ranks(torch.empty(m, n, device=device).exponential_(
            generator=g).div_(popularity)) < counts_d[r0:r0 + m, None]
        key = torch.rand(m, n, **kw).masked_fill_(~chosen, 2.0)
        kept = _ranks(key) < train_d[r0:r0 + m, None]
        rated += chosen.sum(0)
        rated_train += kept.sum(0)
        for train_part, where in ((True, kept), (False, chosen & ~kept)):
            row, col = where.nonzero(as_tuple=True)
            user = row + r0
            planted = (user_f[user] * film_f[col]).sum(1).div_(rank ** 0.5)
            x = (values['mean'] + user_b[user] + film_b[col]
                 + values['factor_sd'] * planted
                 + values['noise_sd'] * torch.randn(len(col), **kw))
            step = values['step']
            rows, cols, vals = out[train_part]
            rows.append(user)
            cols.append(col.to(torch.int32))
            vals.append(torch.clamp(torch.round(x / step) * step,
                                    values['min'], values['max']))
    X, test = (_csr(*out[part], (U, n)) for part in (True, False))
    stats = dict(distinct=int(counts.sum()), train=int(X.nnz),
                 held_out=int(test.nnz),
                 longest_user=int(counts.max()),
                 longest_train_row=int(train.max()),
                 most_rated_film=int(rated.max()),
                 most_rated_film_train=int(rated_train.max()))
    return Ratings(X, test, stats)


def _csr(rows, cols, vals, shape):
    """Float64 CSR on the host of entries listed row by row (ascending
    blocks of rows, each block's entries in row order)."""
    rows = torch.cat(rows).cpu().numpy()
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=shape[0]))])
    return sp.csr_matrix((torch.cat(vals).cpu().numpy().astype(np.float64),
                          torch.cat(cols).cpu().numpy(), indptr), shape=shape)


def _ranks(keys):
    """Each entry's rank in its row of ``keys``, ascending."""
    order = torch.argsort(keys, dim=1)
    ranks = torch.empty_like(order)
    return ranks.scatter_(1, order, torch.arange(
        keys.shape[1], device=keys.device).expand_as(order))


class RecsysLoop:
    """``RecsysDictFact.fit``'s epoch loop after its set-up
    (``_start``): one ``recsys_epoch`` an epoch, through the programs
    where ``fit`` would take them, then the sync that ends ``fit``'s
    epochs."""

    def __init__(self, est, X):
        from modl_tpu_torch.decomposition import _program, _step
        state, cfg, csr, resident, batch_size = est._start(X)
        est._programs = ({} if _program.capturable_recsys(
            cfg, resident is not None) else None)
        self.est, self.state, self.cfg = est, state, cfg
        self.src = csr if resident is None else resident
        self.resident = resident is not None
        self.batch_size = batch_size
        self.staging = _step.DrawStaging(state.D.device)
        self.before_batch = (functools.partial(est._before_batch, state)
                             if est.verbose or est.callback is not None
                             else None)

    def epoch(self):
        from modl_tpu_torch.decomposition import recsys
        with torch.profiler.record_function(EPOCH_SPAN):
            recsys.recsys_epoch(self.state, self.cfg, self.src,
                                self.est.random_state, self.batch_size,
                                self.est._programs, self.staging,
                                self.before_batch)
            self.est.n_iter_ = self.state.n_iter
            sync(self.state.D.device)


def _leaves(state):
    """Host copies of the fit's D, C and B."""
    return tuple(x.cpu().numpy().copy() for x in (state.D, state.C,
                                                   state.B))


def _visits(state):
    return dict(counts=state.feature_n_iter.cpu().numpy().astype(np.int64),
                n_iter=state.n_iter)


@contextlib.contextmanager
def _lockstep(locks):
    """Copies of the fit's leaves after the first ``t`` batches run
    inside, for each ``t`` of ``locks`` at which a group of batches
    ends, into the dict it yields, taken around ``recsys._run``."""
    from modl_tpu_torch.decomposition import recsys as port
    run, seen, taken = port._run, [0], {}

    def observed(state, cfg, src, rows_w, *rest):
        run(state, cfg, src, rows_w, *rest)
        seen[0] += rows_w.shape[0]
        if seen[0] in locks:
            taken[seen[0]] = _leaves(state)
    port._run = observed
    try:
        yield taken
    finally:
        port._run = run


def prepare(cfg, traffic, data_seed, est_seed, device, dtype=np.float32):
    """A ``RecsysDictFact`` set up as its ``fit`` sets it up, driven
    through the checked epochs; returns ``(loop, program)``: the
    :class:`RecsysLoop` and what :func:`compare` reads: ``dict(D0=...,
    lock={t: (D, C, B)}, states=[...])``, D0 the dictionary ``_start``
    drew, ``lock`` the leaves after the fit's first ``t`` batches
    (``LOCKS``; where no group of batches ended there, the leaves after
    the checked epochs), and ``states`` the films' visits and ``n_iter``
    after each checked epoch, with the rows' codes and D after the
    ``KEPT`` ones."""
    from modl_tpu_torch import RecsysDictFact
    data = make_data(cfg, data_seed, device)
    est = RecsysDictFact(**cfg['estimator'], random_state=est_seed,
                         device=device, dtype=dtype,
                         verbose=traffic['verbose'],
                         n_epochs=traffic['n_epochs'])
    loop = RecsysLoop(est, data.X)
    loop.data, loop.est_seed = data, est_seed
    program = dict(D0=loop.state.D.cpu().numpy().copy(), states=[])
    with _lockstep(LOCKS) as taken:
        for e in range(1, CHECKED_EPOCHS + 1):
            loop.epoch()
            state = _visits(loop.state)
            if e in KEPT:
                state.update(code=loop.state.code.cpu().numpy().copy(),
                             D=loop.state.D.cpu().numpy().copy())
            program['states'].append(state)
    program['lock'] = {t: taken.get(t) or _leaves(loop.state)
                       for t in LOCKS}
    sync(device)
    return loop, program


def reference(cfg, data_seed, est_seed, device, precision='float64'):
    """The plain reference's record (:func:`plain.record`) of the
    epochs up to the last of ``KEPT``, on the same ratings remade from
    the seed, in
    ``precision`` (``'tf32'``: the control), with the held-out ratings
    and the crop that :func:`compare` reads."""
    data = make_data(cfg, data_seed, device)
    X = data.X
    out = plain.record(X.indptr, X.indices, X.data, X.shape,
                       cfg['estimator'], est_seed, max(KEPT), LOCKS, KEPT,
                       precision, device)
    out.update(test=data.test, crop=cfg['estimator'].get('crop'))
    return out


def compare(program, reference):
    """:func:`checks.compare_lockstep` of the two records, the held-out
    RMSE with the reference's biases, ratings and crop."""
    return checks.compare_lockstep(
        program, reference, functools.partial(
            plain.rmse, test=reference['test'], bias=reference['bias'],
            crop=reference['crop']))


def batch_counts(k, n_rows, entries, union):
    """(operations, bytes) of a batch of ``n_rows`` rows holding
    ``entries`` ratings over ``union`` distinct films, k atoms, and of
    its dictionary update alone, each as little as the mathematics
    needs: each row's code on its own support (2 entries k^2 for the
    Grams, 2 entries k for the right-hand sides, k^3 / 3 + 2 k^2 a row
    for the Cholesky factor and the two solves), the C EMA (2 b k^2),
    the B EMA (2 entries k) and the union's dictionary update (4 k^2 u,
    the residual and the k rank-1 updates); bytes: the entries' index and
    value read once (8 entries), D and B on the union read and written
    once, C and the budgets (4 (4 k u + k^2 + 3 k)), the codes written
    (4 b k); the dictionary update alone 4 k^2 u operations and 4 (3 k
    u + k^2 + 3 k) bytes (D and its gradient read, D written, C read,
    the budgets read and written)."""
    bcd = (4 * k * k * union, 4 * (3 * k * union + k * k + 3 * k))
    ops = (2 * entries * k * k + 2 * entries * k
           + n_rows * (k ** 3 / 3 + 2 * k * k) + 2 * n_rows * k * k
           + 2 * entries * k + bcd[0])
    nbytes = 8 * entries + 4 * (4 * k * union + k * k + 3 * k + n_rows * k)
    return (ops, nbytes), bcd


class Work:
    """The work of the window's epochs, batch by batch: the rows, the
    entries and the union width of each, from the training ratings and
    the estimator's draws replayed as the reference makes them (the
    window's epochs follow the ``CHECKED_EPOCHS``)."""

    def __init__(self, cfg, X, seed):
        self.k = cfg['estimator']['n_components']
        self.X, self.seed = X, seed
        self.b = plain.batch_size(cfg['estimator'], X.shape[0], X.shape[1],
                                  X.nnz)

    def steps(self, n_epochs):
        return n_epochs * -(-self.X.shape[0] // self.b)

    def _epochs(self, n_epochs):
        """Each of the window's first ``n_epochs`` epochs as a list of its
        batches' (rows, entries, union)."""
        X, k = self.X, self.k
        rs = np.random.RandomState(self.seed)
        plain.initial_dictionary(rs, k, X.shape[1])
        row_of = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))
        out = []
        for e in range(CHECKED_EPOCHS + n_epochs):
            draws = plain.epoch_draws(rs, X.shape[0], k, self.b)
            if e < CHECKED_EPOCHS:
                continue
            batch_of = np.empty(X.shape[0], dtype=np.int64)
            for t, (rows, _) in enumerate(draws):
                batch_of[rows] = t
            of_entry = batch_of[row_of]
            entries = np.bincount(of_entry, minlength=len(draws))
            pairs = np.unique(of_entry * X.shape[1] + X.indices)
            union = np.bincount(pairs // X.shape[1], minlength=len(draws))
            out.append([(len(rows), int(entries[t]), int(union[t]))
                        for t, (rows, _) in enumerate(draws)])
        return out

    def bcd(self, n_epochs):
        return [(1,) + batch_counts(self.k, *batch)[1]
                for batches in self._epochs(n_epochs) for batch in batches]

    def epoch(self, n_epochs):
        out = []
        for batches in self._epochs(n_epochs):
            counts = [batch_counts(self.k, *batch)[0] for batch in batches]
            out.append((1, sum(c[0] for c in counts),
                        sum(c[1] for c in counts)))
        return out


def work(cfg, loop):
    return Work(cfg, loop.data.X, loop.est_seed)
