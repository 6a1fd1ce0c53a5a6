"""Plain SOMF (Mensch et al., "Stochastic Subsampling for Factorizing
Huge Matrices", IEEE TSP 2018), as the benchmark's configurations run
it: ridge codes on the masked estimators, l1-ball dictionary rows,
windowed feature subsets of Binomial size, a batch weight
``1 - prod (1 - i^-lr)`` and a shuffle of the rows after every epoch.

One step on a batch ``X_b`` (b rows) and a subset ``S`` of features
(``m`` columns of one fixed random feature order, starting at a drawn
window start and wrapping around):

    Dx   = r X_b[:, S] D[:, S]^T            r = the configuration's reduction
    G    = r D[:, S] D[:, S]^T
    A    = Dx (G + alpha I)^-1               the codes, (b, k)
    C    = (1 - w) C + w A^T A / b
    B    = (1 - w) B + (w / b) A^T X_b       every feature
    then, atom by atom in the drawn order, on the columns S:
    R_j  = B_j - C_j D + C_jj D_j
    D_j  = R_j / C_jj                        (kept where C_jj <= 1e-20)
    D_j  = D_j projected on the l1 ball of radius c_j + ||D_j(old)||_1,
           and c_j = that radius - ||D_j||_1

where ``c`` (starting at 0) is the l1 budget each row has left outside
``S``; every row starts at l1 norm 1, the first k rows of X scaled. The
projection is the port's (:func:`project_l1`): a bracketed Newton search
of the soft threshold, stopped after 6 steps, which the exact projection
(a sort) departs from by up to ~1e-3 of the dictionary's change at
HCP-1,024's widths.

This is the same mathematics as the port's fused epoch, whose B is
updated once per segment of steps (``B = pi B0 + SC^T X``); here it is
updated at every step. Everything runs in ``precision``: ``'float64'``
(the reference) or ``'tf32'``, float32 storage with every matrix
product's operands rounded to TF32 (10 mantissa bits) and summed in
float32, as the tensor cores compute a float32 product with TF32 on:
the control, one precision below the configuration's float32.
"""
import numpy as np
import torch

from .sampler import (atom_order, binomial_len_max, draw_window_sized,
                      feature_order)

MAX_INT = np.iinfo(np.int32).max


def tf32(x):
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _matmul(precision):
    if precision == 'float64':
        return torch.matmul
    if precision == 'tf32':
        return lambda a, b: torch.matmul(tf32(a), tf32(b))
    raise ValueError(f'unknown precision {precision!r}')


def batch_weight(n_iter, b, learning_rate, dtype):
    """``w = 1 - prod_{i = n_iter - b + 1}^{n_iter} (1 - i^-lr)``."""
    i = np.arange(n_iter - b + 1, n_iter + 1, dtype=dtype)
    return float(dtype(1) - np.prod(dtype(1) - i ** -dtype(learning_rate),
                                    dtype=dtype))


def project_l1(v, radius, count, steps=6):
    """``v`` (numpy) projected on the l1 ball of ``radius`` as the port's
    dictionary update projects it (``modl_tpu_torch/ops/bcd.py``, after
    the JAX package's Pallas kernel), in v's dtype: the soft threshold
    ``lam`` of ``|v|`` is searched for in a bracket, from ``lo = max((
    ||v||_1 - radius) / count, 0)`` (``count`` the row's stored width,
    padded to a multiple of 8 from 2,048 on) and the secant point towards
    ``max |v|``, by ``steps`` safeguarded Newton steps (each at least the
    bracket's middle; a step that overshoots moves the upper end to it or
    to the secant point), then one Newton step from the lower end; the
    soft-thresholded row is scaled back into the ball where it is still
    outside. This is the exact Euclidean projection where the steps reach
    the threshold's linear piece, and near it elsewhere."""
    dt = v.dtype.type
    radius, tiny = dt(radius), dt(1e-30)
    if radius <= 0:
        return np.zeros_like(v)
    a = np.abs(v)
    norm = a.sum(dtype=dt)
    if norm <= radius:
        return v

    def g(lam):
        t = a - lam
        t = t[t > 0]
        return t.sum(dtype=dt), dt(max(t.size, 1))

    lo = max((norm - radius) / dt(count), dt(0))
    top = a.max()
    glo, nlo = g(lo)
    hi = min(max(lo + (glo - radius) * (top - lo) / max(glo, tiny), lo), top)
    for _ in range(steps):
        t = min(max(max(lo + (glo - radius) / nlo, (lo + hi) / dt(2)), lo),
                hi)
        gt, nt = g(t)
        if gt >= radius:
            lo, glo, nlo = t, gt, nt
        else:
            hi = min(t, lo + (glo - radius) * (t - lo) / max(glo - gt, tiny))
    lam = max(lo + (glo - radius) / nlo, dt(0))
    w = np.maximum(a - lam, dt(0))
    total = w.sum(dtype=dt)
    scale = radius / max(total, tiny) if total > radius else dt(1)
    return np.sign(v) * w * scale


def dictionary_update(D, grad, C, budget_left, order, matmul, count):
    """Block coordinate descent on the rows of ``D`` (k, s) in ``order``,
    each projected on its l1 ball (:func:`project_l1`); ``budget_left``
    (numpy, k) is updated in place. Returns D'. The residual and the
    rank-1 updates stay on D's device, each row's projection runs on the
    host."""
    D = D.clone()
    R = grad - matmul(C, D)
    diag = torch.diagonal(C).cpu().numpy()
    for j in order.tolist():
        Rj, old = torch.stack([R[j], D[j]]).cpu().numpy()
        cjj = diag[j]
        radius = budget_left[j] + np.abs(old).sum(dtype=old.dtype)
        new = (Rj + cjj * old) / cjj if cjj > 1e-20 else old
        new = project_l1(new, radius, count)
        budget_left[j] = radius - np.abs(new).sum(dtype=new.dtype)
        new = torch.from_numpy(new).to(D.device)
        R.addr_(C[:, j], new - D[j], alpha=-1)
        D[j] = new
    return D


def fit(X, params, seed, n_epochs, precision='float64'):
    """The first ``n_epochs`` epochs of a fit of ``X`` (n, p) under the
    configuration's estimator ``params`` from the estimator's ``seed``,
    on X's device. Returns ``[D0, (D, C, B) after epoch 1, ...]``, D and
    B in the data's feature order."""
    if (params.get('code_l1_ratio', 1) != 0
            or params.get('comp_l1_ratio', 0) != 1
            or params.get('Dx_agg') != 'masked'
            or params.get('G_agg') != 'masked'):
        raise ValueError('the reference covers ridge codes, l1-ball '
                         'dictionary rows and the masked estimators')
    dtype = torch.float64 if precision == 'float64' else torch.float32
    np_dtype = np.float64 if precision == 'float64' else np.float32
    matmul = _matmul(precision)
    X = X.to(dtype)
    n, p = X.shape
    dev = X.device
    k, b = int(params['n_components']), int(params['batch_size'])
    reduction = float(params['reduction'])
    alpha = float(params['code_alpha'])
    len_subset = int(p / reduction)
    len_max = binomial_len_max(p, len_subset)
    if not (len_subset < p and p >= 2 * len_max):
        raise ValueError('the reference covers windowed subsets')

    count = -(-len_max // 8) * 8 if len_max >= 2048 else len_max
    rs = np.random.RandomState(seed)
    D = X[:k].clone()
    D /= torch.sum(torch.abs(D), dim=1, keepdim=True)
    gen = torch.Generator().manual_seed(int(rs.randint(MAX_INT)))
    order = feature_order(p, gen).to(dev)
    C = torch.zeros((k, k), dtype=dtype, device=dev)
    B = torch.zeros((k, p), dtype=dtype, device=dev)
    left = np.zeros(k, np_dtype)
    eye = torch.eye(k, dtype=dtype, device=dev)
    rows = np.arange(n)
    n_iter = 0
    out = [D.clone()]
    for _ in range(n_epochs):
        for t in range(n // b):
            start, m = draw_window_sized(gen, p, len_subset, len_max)
            atoms = atom_order(k, gen)
            cols = order[(start + torch.arange(m, device=dev)) % p]
            Xb = X[torch.as_tensor(rows[t * b:(t + 1) * b], device=dev)]
            n_iter += b
            w = batch_weight(n_iter, b, params['learning_rate'], np_dtype)
            Ds = D[:, cols]
            Dx = matmul(Xb[:, cols], Ds.T) * reduction
            G = matmul(Ds, Ds.T) * reduction
            L = torch.linalg.cholesky(G + alpha * eye)
            A = torch.cholesky_solve(Dx.T, L).T
            C = (1 - w) * C + w * matmul(A.T, A) / b
            B = (1 - w) * B + (w / b) * matmul(A.T, Xb)
            D[:, cols] = dictionary_update(Ds, B[:, cols], C, left, atoms,
                                           matmul, count)
        out.append((D.clone(), C.clone(), B.clone()))
        perm = np.random.RandomState(rs.randint(MAX_INT)).permutation(n)
        rows = rows[perm]
    return out
