"""Batched code solvers on the Gram formulation, in PyTorch.

Counterpart of ``modl_tpu/ops/solvers.py`` (the reference's
``dict_fact_fast.pyx``):

- ``ridge_single_gram``: one Cholesky factorisation of ``G + alpha I``
  shared by every sample of the batch (``torch.linalg.cholesky_ex`` +
  ``torch.cholesky_solve``).
- ``ridge_multi_gram``: per-sample Grams, one batched Cholesky solve
  (``spd_solve``: a batched factorisation and two batched triangular
  solves, all capturable in a CUDA graph).
- ``enet_cd_gram``: coordinate descent on
  ``1/2 w^T Q w - q^T w + alpha ||w||_1 + beta/2 ||w||_2^2`` with the
  incremental ``H = Q w`` bookkeeping and the duality-gap stop; every
  sample runs at once and a per-row ``active`` mask freezes converged
  rows, which reproduces the sequential per-sample algorithm.
- ``fista_gram`` (``ops/fista.py``): the same problem by accelerated
  proximal gradient, the Hopper kernel on the card.

CD reads one boolean back per sweep; FISTA reads nothing back on one
card, and one agreed count per five iterations where a batch's rows are
split over ranks; the ridge path reads nothing back.
"""
import torch

from .fista import _duality_gap, _soft_threshold, fista_gram

__all__ = ["ridge_single_gram", "ridge_multi_gram", "spd_solve",
           "enet_cd_gram",
           "fista_gram", "enet_regression_single_gram",
           "enet_regression_multi_gram"]


def _cholesky(A):
    """Lower Cholesky factor without the host-side info check (which
    would wait for the device every step); like the JAX path, a system
    that is not positive definite yields NaN instead of raising."""
    return torch.linalg.cholesky_ex(A).L


def ridge_single_gram(G, Dx, alpha):
    """Solve ``(G + alpha I) code^T = Dx^T``: G (k, k), Dx (b, k)."""
    k = G.shape[0]
    Greg = G + alpha * torch.eye(k, dtype=G.dtype, device=G.device)
    return torch.cholesky_solve(Dx.T, _cholesky(Greg)).T


def spd_solve(A, rhs):
    """Batched positive-definite solves ``A x = rhs``: A (b, k, k), rhs
    (b, k) -> x (b, k). A batched Cholesky factorisation (cuSOLVER's
    batched potrf on the card) and two batched triangular solves
    (cuBLAS's batched trsm), which a CUDA graph captures; the batched
    ``torch.cholesky_solve`` goes to MAGMA's ``potrs_batched``, which
    allocates device memory during the call and so cannot be captured."""
    L = _cholesky(A)
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def ridge_multi_gram(G, Dx, alpha):
    """Per-sample ridge solves: G (b, k, k), Dx (b, k) -> code (b, k);
    ``alpha`` a number or a (b, 1, 1) tensor of per-sample ridges."""
    k = G.shape[-1]
    Greg = G + alpha * torch.eye(k, dtype=G.dtype, device=G.device)
    return spd_solve(Greg, Dx)


def enet_cd_gram(w0, Q, q, y_norm2, l1_reg, l2_reg, positive, max_iter,
                 tol):
    """Batched elastic-net coordinate descent on the Gram formulation.

    Minimises, independently for each row i,
    ``1/2 w^T Q_i w - q_i^T w + l1_reg ||w||_1 + l2_reg/2 ||w||_2^2``.
    ``Q`` is (k, k) shared or (b, k, k) per row; ``q`` (b, k);
    ``y_norm2`` (b,) scales the gap tolerance (dict_fact_fast.pyx:336).
    """
    b, k = q.shape
    shared = Q.ndim == 2
    w = w0.clone()
    gap_tol = tol * y_norm2
    if shared:
        H = w @ Q
        Qdiag = torch.diagonal(Q)
    else:
        H = torch.einsum('bij,bj->bi', Q, w)
        Qdiag = torch.diagonal(Q, dim1=-2, dim2=-1)
    active = torch.ones(b, dtype=torch.bool, device=q.device)
    denom_all = Qdiag + l2_reg
    for it in range(max_iter):
        d_w_max = torch.zeros(b, dtype=q.dtype, device=q.device)
        w_max = torch.zeros(b, dtype=q.dtype, device=q.device)
        act = active[:, None]
        for ii in range(k):
            if shared:
                Qii = Qdiag[ii]
                Qrow = Q[ii][None, :]
                denom = denom_all[ii]
            else:
                Qii = Qdiag[:, ii]
                Qrow = Q[:, ii, :]
                denom = denom_all[:, ii]
            w_ii = w[:, ii].clone()     # w[:, ii] is overwritten below
            H1 = H - w_ii[:, None] * Qrow
            tmp = q[:, ii] - H1[:, ii]
            w_new = _soft_threshold(tmp, l1_reg) / denom
            if positive:
                w_new = torch.where(tmp < 0, torch.zeros_like(w_new), w_new)
            # skip zero-curvature coordinates (pyx:357) and frozen rows
            w_new = torch.where((Qii == 0.0) | ~active, w_ii, w_new)
            H = torch.where(act, H1 + w_new[:, None] * Qrow, H)
            w[:, ii] = w_new
            d_w_max = torch.maximum(d_w_max, torch.abs(w_new - w_ii))
            w_max = torch.maximum(w_max, torch.abs(w_new))
        check = ((w_max == 0.0) | (d_w_max < tol * w_max)
                 | (it == max_iter - 1))
        gap = _duality_gap(w, H, q, y_norm2, l1_reg, l2_reg, positive)
        active = active & ~(check & (gap < gap_tol))
        if not bool(active.any()):
            break
    return w


def enet_regression_single_gram(w0, G, Dx, X, l1_ratio, alpha, positive,
                                tol, max_iter, solver='cd', y_norm2=None,
                                agree=None):
    """Shared-Gram dispatcher: ridge when ``l1_ratio == 0``, else CD or
    FISTA warm-started at ``w0`` with ``y_norm2 = ||x_i||^2`` (from X
    unless given: a rank holding some of X's columns passes the whole
    rows' norms). ``agree``: FISTA's stop over a batch split over ranks
    (:func:`fista_gram`)."""
    if l1_ratio == 0.0:
        return ridge_single_gram(G, Dx, alpha)
    return _enet_dispatch(w0, G, Dx, X, l1_ratio, alpha, positive, tol,
                          max_iter, solver, y_norm2, agree)


def enet_regression_multi_gram(w0, G, Dx, X, l1_ratio, alpha, positive,
                               tol, max_iter, solver='cd', y_norm2=None,
                               agree=None):
    """Per-sample-Gram dispatcher (``G`` is (b, k, k))."""
    if l1_ratio == 0.0:
        return ridge_multi_gram(G, Dx, alpha)
    return _enet_dispatch(w0, G, Dx, X, l1_ratio, alpha, positive, tol,
                          max_iter, solver, y_norm2, agree)


def _enet_dispatch(w0, G, Dx, X, l1_ratio, alpha, positive, tol, max_iter,
                   solver, y_norm2, agree):
    if y_norm2 is None:
        y_norm2 = torch.sum(X * X, dim=-1)
    l1_reg, l2_reg = alpha * l1_ratio, alpha * (1.0 - l1_ratio)
    if solver == 'fista':
        # the kernel takes contiguous operands only
        w0, G, Dx, y_norm2 = (t.contiguous() for t in (w0, G, Dx, y_norm2))
        return fista_gram(w0, G, Dx, y_norm2, l1_reg, l2_reg, positive,
                          20 * max_iter, tol, agree=agree)
    return enet_cd_gram(w0, G, Dx, y_norm2, l1_reg, l2_reg, positive,
                        max_iter, tol)
