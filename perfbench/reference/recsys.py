"""Plain masked matrix factorisation of sparse ratings (Mensch et al.,
"Dictionary Learning for Massive Matrix Factorization", ICML 2016,
arXiv:1605.00937), with the serial semantics of upstream modl's
``RecsysDictFact`` (``modl/decomposition/recsys.py``) as the
benchmark's ``recsys`` configurations run it.

The fit detrends the ratings (:func:`compute_biases`, then each entry
less its row's and its column's bias), draws the initial dictionary
``D0`` (k, n) from ``RandomState(seed).randn`` with unit rows, and runs
epochs: each draws ``permutation(n_rows)``, then one
``permutation(k)`` a batch (:func:`epoch_draws`), and steps the batches
of consecutive permuted rows in turn. One batch of b rows, its rows'
supports ``s`` and values ``x_s``, after ``n_iter += b`` and ``w = 1 -
prod_{i = n_iter - b + 1}^{n_iter} (1 - i^-lr)``:

    c     = (D_s D_s^T + alpha |s| / n I)^-1 D_s x_s      each row's code
    B_:j  = (1 - w_j) B_:j + w_j x_j c                    row by row, each
            w_j = min(1, w n_iter / count_j)              entry j; count_j
                                                          the column's
                                                          visits, its own
                                                          included
    C     = (1 - w) C + (w / b) c^T c
    then, atom by atom in the drawn order, on the union U of the
    batch's supports, with budget_a = comp_norm_a + ||D_aU||^2:
    R     = B_:U - C D_:U
    D_aU  = (R_a + C_aa D_aU) / C_aa                      (kept where
                                                          C_aa <= 1e-20)
    D_aU  = D_aU scaled into the l2 ball of radius sqrt(budget_a)
    R    -= C_:a (D_aU(new) - D_aU(old))
    comp_norm_a = budget_a - ||D_aU||^2

The codes are solved for all of a batch's rows at once (they read the
same D), the B update runs visit by visit, all columns' j-th visits of
the batch together (each column's visits keep their row order), and the
update of one atom runs on all union columns at once: no step reorders
what the serial loop computes. The initial codes, which a fit solves
before its first epoch, feed none of D, C and B and are not computed;
every row's code is solved again in each epoch, and the last one kept
(``code``), as ``predict`` reads it:

    x_ij ~ clip(code_i D_:j + row_bias_i + col_bias_j, crop)

Everything runs in ``precision``: ``'float64'`` (the reference, the
batch weight too) or ``'tf32'`` (the control: float32 storage and
weight, every matrix product's operands rounded to TF32, :mod:`.somf`).
Imports nothing of the port.
"""
import math

import numpy as np
import torch

from .somf import _matmul, batch_weight


def compute_biases(indptr, indices, data, n_cols, beta):
    """Row and column biases of CSR ratings: two rounds of the row means
    (shrunk towards the global mean by ``beta`` pseudo-ratings), removed,
    then the column means (damped by ``beta``), removed. Returns
    ``(row_bias, col_bias)``; ``data`` is left as it was."""
    n_rows = len(indptr) - 1
    vals = np.array(data, dtype=np.float64)
    rows = np.repeat(np.arange(n_rows), np.diff(indptr))
    cnt_r = np.maximum(np.bincount(rows, minlength=n_rows), 1)
    cnt_c = np.maximum(np.bincount(indices, minlength=n_cols), 1)
    mean = vals.mean() if len(vals) else 0.0
    row_bias, col_bias = np.zeros(n_rows), np.zeros(n_cols)
    for _ in range(2):
        r = (np.bincount(rows, weights=vals, minlength=n_rows)
             + mean * beta) / (cnt_r + beta)
        vals -= r[rows]
        c = np.bincount(indices, weights=vals, minlength=n_cols) / (
            cnt_c + beta)
        vals -= c[indices]
        row_bias += r
        col_bias += c
    return row_bias, col_bias


def initial_dictionary(rs, k, n):
    """``D0``: ``rs.randn(k, n)`` (the fit's first draw), unit rows."""
    D = rs.randn(k, n)
    return D / np.sqrt(np.sum(D ** 2, axis=1))[:, None]


def batch_size(params, n_rows, n_cols, nnz):
    """The configuration's batch; ``None`` is ``ceil(1 / density)``."""
    b = params.get('batch_size')
    return int(math.ceil(n_rows * n_cols / nnz)) if b is None else int(b)


def epoch_draws(rs, n_rows, k, b):
    """One epoch's draws in the fit's order: ``permutation(n_rows)``,
    then one ``permutation(k)`` a batch. Returns ``[(rows, order)]``,
    one a batch of ``b`` consecutive permuted rows (the last may be
    shorter)."""
    perm = rs.permutation(n_rows)
    return [(perm[s:s + b], rs.permutation(k)) for s in range(0, n_rows, b)]


def batch_entries(indptr, rows):
    """The positions in the CSR arrays of ``rows``' entries, row after
    row, and each entry's row within the batch."""
    starts, lens = indptr[rows], indptr[rows + 1] - indptr[rows]
    first = np.cumsum(lens) - lens
    at = np.repeat(starts - first, lens) + np.arange(int(lens.sum()))
    return at, np.repeat(np.arange(len(rows)), lens), lens


def _codes(D, cols, vals, row, lens, alpha, matmul):
    """Each row's ridge code on its own support, the rows padded with
    the zero column ``n`` to the batch's longest (no term changes)."""
    k, n = D.shape
    b, width = len(lens), int(lens.max())
    slot = np.arange(len(cols)) - np.repeat(np.cumsum(lens) - lens, lens)
    idx = np.full((b, width), n, dtype=np.int64)
    idx[row, slot] = cols
    val = np.zeros((b, width))
    val[row, slot] = vals
    dev = D.device
    Dg = torch.cat([D.T, D.new_zeros((1, k))])[torch.from_numpy(idx).to(dev)]
    Dgt = Dg.transpose(1, 2)
    x = torch.from_numpy(val).to(dev, D.dtype)
    Dx = matmul(Dgt, x[..., None])[..., 0]
    G = matmul(Dgt, Dg)
    ridge = torch.from_numpy(alpha * lens / n).to(dev, D.dtype)
    G = G + ridge[:, None, None] * torch.eye(k, dtype=D.dtype, device=dev)
    code = torch.cholesky_solve(Dx[..., None], torch.linalg.cholesky(G))
    code = code[..., 0]
    return torch.where(torch.from_numpy(lens > 0).to(dev)[:, None], code,
                       torch.zeros_like(code))


def _b_update(B, code, cols, vals, row, counts, wn, np_dtype):
    """The B EMA entry by entry in row order: all columns' j-th visits
    of the batch at once, for j = 0, 1, ...; ``counts`` (host, n) are the
    columns' visits before the batch and are advanced."""
    order = np.argsort(cols, kind='stable')
    sorted_cols = cols[order]
    first = np.flatnonzero(np.r_[True, sorted_cols[1:] != sorted_cols[:-1]])
    visit = np.empty(len(cols), dtype=np.int64)
    visit[order] = np.arange(len(cols)) - np.repeat(
        first, np.diff(np.r_[first, len(cols)]))
    count = (counts[cols] + visit + 1).astype(np_dtype)
    w = np.minimum(np_dtype(1), np_dtype(wn) / count)
    counts += np.bincount(cols, minlength=len(counts))
    by_visit = np.argsort(visit, kind='stable')
    edges = np.searchsorted(visit[by_visit], np.arange(visit.max() + 2))
    dev = B.device
    cols_d = torch.from_numpy(cols[by_visit]).to(dev)
    rows_d = torch.from_numpy(row[by_visit]).to(dev)
    keep = torch.from_numpy(np_dtype(1) - w[by_visit]).to(dev, B.dtype)
    add = torch.from_numpy((w * vals.astype(np_dtype))[by_visit]).to(
        dev, B.dtype)
    for a, e in zip(edges[:-1], edges[1:]):
        c = cols_d[a:e]
        B[:, c] = B[:, c] * keep[a:e] + code[rows_d[a:e]].T * add[a:e]


def _bcd(D, B, C, comp_norm, union, order, matmul):
    """The l2-ball block coordinate descent on the union columns, in
    place on D and comp_norm."""
    Ds = D[:, union]
    R = B[:, union] - matmul(C, Ds)
    budget = comp_norm + torch.sum(Ds * Ds, dim=1)
    diag = torch.diagonal(C)
    moves = (diag > 1e-20).tolist()
    one = torch.ones((), dtype=D.dtype, device=D.device)
    for a in order.tolist():
        old = Ds[a]
        v = (R[a] + diag[a] * old) / diag[a] if moves[a] else old.clone()
        norm2 = torch.dot(v, v)
        v = v * torch.where(norm2 > budget[a], torch.sqrt(
            torch.clamp(budget[a], min=0) / torch.clamp(norm2, min=1e-30)),
            one)
        R.addr_(C[:, a], v - old, alpha=-1)
        Ds[a] = v
    comp_norm.copy_(budget - torch.sum(Ds * Ds, dim=1))
    D[:, union] = Ds


class Fit:
    """A fit of the CSR ratings (``indptr``, ``indices``, ``data``: numpy,
    ``shape`` (n_rows, n)) under the configuration's estimator
    ``params`` from the estimator's ``seed``, on ``device``, in
    ``precision`` (``'float32'``, float32 without TF32, serves as a
    witness): its leaves ``D``, ``C``, ``B``, ``comp_norm``, the rows'
    last codes ``code``, the films' visits ``counts`` (host) and
    ``n_iter``, from ``D0`` and zeros; ``row_bias`` and ``col_bias``
    the detrending's (zeros without it)."""

    def __init__(self, indptr, indices, data, shape, params, seed,
                 precision='float64', device='cpu'):
        if params.get('l1_ratio', 0) != 0:
            raise ValueError('the reference covers l2-ball dictionary rows')
        self.dtype = torch.float64 if precision == 'float64' else \
            torch.float32
        self.np_dtype = np.float64 if precision == 'float64' else np.float32
        self.matmul = torch.matmul if precision == 'float32' else \
            _matmul(precision)
        self.device = device
        self.n_rows, n = shape
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        vals = np.array(data, dtype=np.float64)
        self.row_bias, self.col_bias = np.zeros(self.n_rows), np.zeros(n)
        if params.get('detrend'):
            self.row_bias, self.col_bias = compute_biases(
                self.indptr, self.indices, vals, n, params.get('beta', 0))
            vals -= np.repeat(self.row_bias, np.diff(self.indptr))
            vals -= self.col_bias[self.indices]
        self.vals = vals
        self.k = k = int(params['n_components'])
        self.alpha = float(params['alpha'])
        self.lr = float(params['learning_rate'])
        self.b = batch_size(params, self.n_rows, n, len(self.indices))
        self.rs = np.random.RandomState(seed)
        self.load(D=initial_dictionary(self.rs, k, n),
                  C=np.zeros((k, k)), B=np.zeros((k, n)),
                  comp_norm=np.zeros(k), counts=np.zeros(n, np.int64),
                  n_iter=0)
        self.code = torch.zeros((self.n_rows, k), dtype=self.dtype,
                                device=device)

    def load(self, D, C, B, comp_norm, counts, n_iter):
        """Set the leaves (numpy or tensors) in this fit's precision."""
        def t(x):
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                   else x).to(self.device, self.dtype,
                                              copy=True)
        self.D, self.C, self.B, self.comp_norm = t(D), t(C), t(B), \
            t(comp_norm)
        self.counts = np.array(counts, dtype=np.int64)
        self.n_iter = int(n_iter)

    def batch(self, rows, order):
        at, row, lens = batch_entries(self.indptr, rows)
        cols, x = self.indices[at], self.vals[at]
        self.n_iter += len(rows)
        w = batch_weight(self.n_iter, len(rows), self.lr, self.np_dtype)
        code = _codes(self.D, cols, x, row, lens, self.alpha, self.matmul)
        self.code[torch.from_numpy(rows).to(self.device)] = code
        _b_update(self.B, code, cols, x, row, self.counts,
                  self.np_dtype(w) * self.np_dtype(self.n_iter),
                  self.np_dtype)
        self.C = (1 - w) * self.C + (w / len(rows)) * self.matmul(code.T,
                                                                  code)
        union = torch.from_numpy(np.unique(cols)).to(self.device)
        _bcd(self.D, self.B, self.C, self.comp_norm, union,
             torch.from_numpy(order), self.matmul)

    def draws(self):
        """The next epoch's draws (:func:`epoch_draws`)."""
        return epoch_draws(self.rs, self.n_rows, self.k, self.b)

    def epoch(self):
        for rows, order in self.draws():
            self.batch(rows, order)

    def leaves(self):
        return self.D.clone(), self.C.clone(), self.B.clone()


def fit(indptr, indices, data, shape, params, seed, n_epochs,
        precision='float64', device='cpu'):
    """The first ``n_epochs`` epochs of a :class:`Fit`. Returns ``[D0,
    (D, C, B) after epoch 1, ...]``."""
    f = Fit(indptr, indices, data, shape, params, seed, precision, device)
    out = [f.D.clone()]
    for _ in range(n_epochs):
        f.epoch()
        out.append(f.leaves())
    return out


def record(indptr, indices, data, shape, params, seed, n_epochs, locks,
           kept, precision='float64', device='cpu'):
    """What a fit of ``n_epochs`` epochs from the seed leaves, as the
    benchmark compares it: ``dict(D0=..., lock={t: (D, C, B)},
    states=[...], bias=(row_bias, col_bias))``, ``lock`` the leaves
    after the fit's first ``t`` batches for each ``t`` of ``locks``,
    ``states`` one dict an epoch of the films' visits
    ``counts`` and ``n_iter``, with the rows' codes ``code`` and ``D``
    after the epochs in ``kept``."""
    f = Fit(indptr, indices, data, shape, params, seed, precision, device)
    out = dict(D0=f.D.clone(), lock={}, states=[],
               bias=(f.row_bias, f.col_bias))
    done = 0
    for e in range(1, n_epochs + 1):
        for rows, order in f.draws():
            f.batch(rows, order)
            done += 1
            if done in locks:
                out['lock'][done] = f.leaves()
        state = dict(counts=f.counts.copy(), n_iter=f.n_iter)
        if e in kept:
            state.update(code=f.code.clone(), D=f.D.clone())
        out['states'].append(state)
    return out


def predict(code, D, rows, cols, row_bias, col_bias, crop):
    """The fit's predictions at the entries (``rows``, ``cols``: host
    int arrays), in float64 on the host: each its row's code times its
    column of D, plus the biases, clipped to ``crop`` (None: not)."""
    device = D.device if torch.is_tensor(D) else 'cpu'
    code = torch.as_tensor(code).to(device, torch.float64)
    D = torch.as_tensor(D).to(device, torch.float64)
    out = np.empty(len(rows))
    for s in range(0, len(rows), 1 << 18):
        r = torch.from_numpy(rows[s:s + (1 << 18)]).to(device)
        c = torch.from_numpy(cols[s:s + (1 << 18)]).to(device)
        out[s:s + len(r)] = torch.einsum('ek,ke->e', code[r],
                                         D[:, c]).cpu().numpy()
    out += row_bias[rows] + col_bias[cols]
    if crop is not None:
        np.clip(out, crop[0], crop[1], out=out)
    return out


def rmse(code, D, test, bias, crop):
    """The root mean squared error of :func:`predict` on the held-out
    ratings ``test`` (CSR: ``indptr``, ``indices``, ``data``)."""
    rows = np.repeat(np.arange(len(test.indptr) - 1), np.diff(test.indptr))
    pred = predict(code, D, rows, test.indices.astype(np.int64), *bias,
                   crop)
    return float(np.sqrt(np.mean((pred - test.data) ** 2)))
