"""RecsysDictFact: masked online matrix factorisation of sparse ratings.

Counterpart of ``modl_tpu/decomposition/recsys.py`` on PyTorch. Each
minibatch of CSR rows is packed into (b, P) padded (index, value)
blocks, the pad index being ``n_features``, and one step runs

- per-row masked ridge codes ``(D_s D_s^T + alpha |s| / n I) c =
  D_s x_s`` as a batched Cholesky (``_masked_ridge_codes``),
- the order-dependent per-feature B EMA of the reference's serial loop
  in closed form, by cumulative sums down the rows of the batch
  (``_b_ema_dense``),
- the C EMA, and the l2-ball block coordinate descent on the union of
  the batch's supports (``_recsys_batch_step``): D and B are masked to
  the union columns and handed to the BCD kernel whole
  (``ops/bcd.py``, one launch a batch, or the SOMF step's block driver
  where the kernel's plan does not take (k, n)), which leaves the other
  columns at zero; only the union columns of its result are kept.

JAX's out-of-range semantics are explicit here: gathers read the pad
index from an appended zero row, and scatters send pad and invalid
entries to dump slots that are dropped afterwards.

Packing runs on the device: the CSR arrays move over once, and one
scatter per block places each entry at ``its position - indptr[row]``.
The whole matrix is packed once when the padded size fits
``RESIDENT_BUDGET`` (batches are then row gathers), else each batch is
packed at its own width. Row lengths for the widths come from the
host's copy of ``indptr``, so the epoch loop reads nothing back from
the device. The JAX package's dp mesh, its windows of 32 batches and
its alternative B-EMA formulation are not ported.
"""
import time
from math import ceil, log

import numpy as np
import scipy.sparse as sp
import torch

from ..base import BaseEstimator, check_random_state, gen_batches
from ..ops import bcd
from ..ops.precision import precise
from ..ops.solvers import _cholesky
from ..ops.weights import batch_weight
from ._step import _np_dtype, bcd_kernel
from .dict_fact import _resolve_device, _torch_dtype

__all__ = ["RecsysDictFact", "compute_biases", "rmse"]

# device budget (bytes of int32 index + value) for packing every row
# once; above it each batch is packed at its own width
RESIDENT_BUDGET = 512 * 1024 * 1024


def _next_pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


def _full(value, like):
    """0-d tensor of ``value`` on ``like``'s device and dtype (a fill,
    not a host-to-device copy), for true division by a tensor."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


class _DeviceCSR:
    """A CSR matrix's arrays on the device, with the host's row lengths
    (which give the packed widths without a read-back)."""

    def __init__(self, X, device, dtype):
        self.shape = X.shape
        self.lens = np.diff(X.indptr).astype(np.int64)
        self.indptr = torch.as_tensor(X.indptr.astype(np.int64)).to(device)
        self.indices = torch.as_tensor(X.indices.astype(np.int32)).to(device)
        self.data = torch.as_tensor(X.data).to(device, dtype)

    def width(self, rows=slice(None)):
        """Power-of-two width of the longest of ``rows``."""
        lens = self.lens[rows]
        return _next_pow2(max(int(lens.max()) if lens.size else 1, 1))


def _pad_rows(csr, rows, rows_dev, width=None):
    """Pack CSR rows into (b, P) padded int32 indices and values.

    ``rows`` (host) and ``rows_dev`` (device) name the same rows. Pad
    index ``n_features``, value 0; rows longer than ``P`` keep their
    first ``P`` entries, and ``lens`` is clipped to ``P``. Returns
    ``(idx, val, lens, P)``."""
    n_features = csr.shape[1]
    lens_h = csr.lens[rows]
    P = width if width is not None else csr.width(rows)
    b, total = len(lens_h), int(lens_h.sum())
    device = csr.indptr.device
    starts = csr.indptr[rows_dev]
    lens = csr.indptr[rows_dev + 1] - starts
    row_e = torch.repeat_interleave(torch.arange(b, device=device), lens,
                                    output_size=total)
    slot = (torch.arange(total, device=device)
            - (torch.cumsum(lens, 0) - lens)[row_e])
    src = starts[row_e] + slot
    # entries past P go to a dump column, dropped below
    col = torch.clamp(slot, max=P)
    idx = torch.full((b, P + 1), n_features, dtype=torch.int32,
                     device=device)
    val = torch.zeros((b, P + 1), dtype=csr.data.dtype, device=device)
    idx[row_e, col] = csr.indices[src]
    val[row_e, col] = csr.data[src]
    return (idx[:, :P].contiguous(), val[:, :P].contiguous(),
            torch.clamp(lens, max=P).to(torch.int32), P)


def _pad_all_rows(csr):
    """Every row packed once at one shared power-of-two width, or None
    when the padded size exceeds ``RESIDENT_BUDGET``."""
    n_samples = csr.shape[0]
    P = csr.width()
    itemsize = csr.data.element_size()
    if n_samples * P * (4 + itemsize) > RESIDENT_BUDGET:
        return None
    return _pad_rows(csr, np.arange(n_samples),
                     torch.arange(n_samples, device=csr.indptr.device),
                     width=P)


@precise
def _masked_ridge_codes(D, idx, val, lens, alpha):
    """Per-row masked ridge solves; rows with an empty support get a
    zero code. D (k, n); idx/val (b, P) padded; lens (b,)."""
    k, n = D.shape
    # support columns as rows of D^T, plus a zero row read by the pad
    # index n
    Dt = torch.cat([D.T, D.new_zeros((1, k))])
    Dg = Dt[idx.long()]                                  # (b, P, k)
    Dx = torch.einsum('bpk,bp->bk', Dg, val)
    G = torch.einsum('bpk,bpq->bkq', Dg, Dg)
    lens_f = torch.clamp(lens, min=1).to(D.dtype)
    ridge = _full(alpha, lens_f) / (_full(n, lens_f) / lens_f)
    G = G + ridge[:, None, None] * torch.eye(k, dtype=D.dtype,
                                             device=D.device)
    code = torch.cholesky_solve(Dx[..., None], _cholesky(G))[..., 0]
    return torch.where((lens > 0)[:, None], code, torch.zeros_like(code))


def _b_ema_dense(B, feature_n_iter, code_b, idx, val, lens, w, n_iter_new):
    """Order-dependent per-feature B EMA of one batch, in closed form.

    The reference's serial loop gives row j the weight ``min(1, w
    n_iter / count)`` with the column's visit count after its own
    increment, and lets later rows decay earlier rows' contributions.
    That couples entries only within a column, in row order: on the
    dense (b, n) scatter of the batch the per-entry rank is an exclusive
    cumulative sum of the occupancy down the rows, and the exclusive
    suffix decay product is a reversed cumulative product (absent
    entries contribute factors of exactly 1). Pad and invalid entries
    go to the dump column ``n + 1``. ``w`` is a host scalar of the state
    dtype and ``n_iter_new`` a host int. Returns ``(B, feature_n_iter)``.
    """
    k, n = B.shape
    b, P = idx.shape
    device = B.device
    valid = torch.arange(P, device=device)[None, :] < lens[:, None]
    cols = torch.where(valid, idx.long(), n + 1)
    rows = torch.arange(b, device=device)[:, None].expand(b, P)
    # every write to the dump column is the same value (1, or a pad's 0);
    # the values are device tensors (a Python scalar would be copied over)
    occ = B.new_zeros((b, n + 2))
    occ[rows, cols] = torch.ones_like(val)
    xv = B.new_zeros((b, n + 2))
    xv[rows, cols] = val

    csum = torch.cumsum(occ, 0)
    rank = csum - occ                      # exclusive: earlier rows only
    fni_ext = torch.cat([feature_n_iter,
                         feature_n_iter.new_zeros(2)]).to(B.dtype)
    count = fni_ext[None, :] + rank + 1.0
    wn = float(w * _np_dtype(B.dtype).type(n_iter_new))
    w_rc = torch.clamp(_full(wn, count) / torch.clamp(count, min=1.0),
                       max=1.0) * occ
    q = 1.0 - w_rc
    sfx = torch.flip(torch.cumprod(torch.flip(q, (0,)), 0), (0,))
    sfx_excl = torch.cat([sfx[1:], torch.ones_like(sfx[:1])])
    B = torch.addmm(B * sfx[0, :n][None, :], code_b.T,
                    (w_rc * xv * sfx_excl)[:, :n])
    feature_n_iter = feature_n_iter + csum[-1, :n].to(feature_n_iter.dtype)
    return B, feature_n_iter


@precise
def _recsys_batch_step(D, C, B, comp_norm, feature_n_iter, n_iter, code_b,
                       idx, val, lens, order, learning_rate,
                       use_kernel=False):
    """One batch update once the codes are solved: the B EMA, the C EMA,
    the union mask and the union BCD. ``n_iter`` is a host int; returns
    ``(D, C, B, comp_norm, feature_n_iter, n_iter)``.

    ``use_kernel`` runs the BCD kernel (one call, or the block driver
    where its plan does not take (k, n)); otherwise its plain version
    runs on the same masked inputs (its math is the JAX package's lax
    loop: budget ``cn + ||D_j||^2`` at visit time, the atom kept where
    ``C_jj <= 1e-20``)."""
    k, n = D.shape
    b, P = idx.shape
    np_dtype = _np_dtype(D.dtype)
    n_iter_new = n_iter + b
    w = batch_weight(n_iter_new, b, learning_rate, 0.0, np_dtype)

    B, feature_n_iter = _b_ema_dense(B, feature_n_iter, code_b, idx, val,
                                     lens, w, n_iter_new)
    C = (C * float(np_dtype.type(1.0) - w)
         + float(w / np_dtype.type(b)) * (code_b.T @ code_b))

    # union of supports: a scatter into n + 1 slots, the pad slot dropped
    valid = torch.arange(P, device=D.device)[None, :] < lens[:, None]
    slots = D.new_zeros(n + 1)
    slots.index_fill_(0, torch.where(valid, idx.long(), n).reshape(-1), 1.0)
    union_f = slots[:n]

    if use_kernel:
        D_new, comp_norm = bcd_kernel(D * union_f, B * union_f, C,
                                      comp_norm, order, False, 0.0)
    else:
        D_new, comp_norm = bcd.bcd_update_reference(
            D * union_f, B * union_f, C, comp_norm, order, comp_pos=False,
            l1_ratio=0.0)
    D = torch.where(union_f[None, :] > 0, D_new, D)
    return D, C, B, comp_norm, feature_n_iter, n_iter_new


@precise
def _predict_entries(code, D, row_idx, col_idx):
    """out[e] = code[row[e]] . D[:, col[e]] for stored entries."""
    return torch.sum(code[row_idx] * D.T[col_idx], dim=1)


def _check_csr(X, copy=False):
    """CSR float32/float64 (others become float32) with finite values."""
    if not sp.issparse(X):
        X = sp.csr_matrix(X)
    X = sp.csr_matrix(X, copy=copy)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float32)
    if not np.isfinite(X.data).all():
        raise ValueError('input contains NaN or infinity')
    return X


class RecsysDictFact(BaseEstimator):
    """Masked matrix-factorisation estimator for sparse ratings.

    Parameters mirror ``modl_tpu.RecsysDictFact`` without ``mesh``:
    ``alpha`` (ridge), ``beta`` (bias shrinkage), ``n_components``,
    ``learning_rate``, ``batch_size`` (None: ceil(1 / sparsity)),
    ``detrend``, ``crop``. ``device`` places the state (``'cuda'`` by
    default; asking for CUDA where there is none raises) and ``dtype``
    is the state's float type (float64 is the counterpart of the JAX
    package's x64 mode). On CUDA the BCD kernel runs every batch's
    dictionary update (``use_kernel_``), which takes float32 state only;
    the CPU runs its plain version. ``time_`` is the epoch loop's wall
    time, ending in one device synchronisation.
    """

    def __init__(self, alpha=1.0, beta=.0, n_components=30,
                 learning_rate=1., batch_size=1, dict_init=None,
                 l1_ratio=0, n_epochs=1, random_state=None, verbose=0,
                 detrend=False, crop=None, callback=None, device='cuda',
                 dtype=np.float32):
        self.callback = callback
        self.verbose = verbose
        self.random_state = random_state
        self.n_epochs = n_epochs
        self.l1_ratio = l1_ratio
        self.dict_init = dict_init
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.n_components = n_components
        self.alpha = alpha
        self.beta = beta
        self.detrend = detrend
        self.crop = crop
        self.device = device
        self.dtype = dtype

    def fit(self, X, y=None):
        device = _resolve_device(self.device)
        tdtype = _torch_dtype(self.dtype)
        # the BCD kernel on the card (float32 only), its plain version on
        # the CPU
        use_kernel = device.type == 'cuda'
        if use_kernel and tdtype != torch.float32:
            raise ValueError(f'RecsysDictFact: the CUDA BCD kernel takes '
                             f'float32 state, got dtype={self.dtype!r}; '
                             'float64 fits run with device="cpu"')
        X = _check_csr(X, copy=True)
        n_samples, n_features = X.shape
        k = self.n_components
        self._n_features = n_features
        self.random_state = check_random_state(self.random_state)

        if self.detrend:
            self.row_mean_, self.col_mean_ = compute_biases(
                X, beta=self.beta, inplace=False)
            X.data -= np.repeat(self.row_mean_, np.diff(X.indptr))
            X.data -= self.col_mean_.take(X.indices, mode='clip')

        D0 = self.random_state.randn(k, n_features)
        D0 /= np.sqrt(np.sum(D0 ** 2, axis=1))[:, np.newaxis]
        D = torch.as_tensor(D0).to(device, tdtype)

        csr = _DeviceCSR(X, device, tdtype)
        resident = _pad_all_rows(csr)
        self.resident_width_ = resident[3] if resident is not None else None
        code = self._refit_device(D, csr, resident)

        self.feature_freq_ = np.bincount(X.indices, minlength=n_features) \
            / n_samples
        feature_n_iter = torch.zeros(n_features, dtype=torch.int32,
                                     device=device)
        sparsity = X.nnz / n_samples / n_features
        if self.batch_size is None:
            batch_size = int(ceil(1. / sparsity))
        else:
            batch_size = self.batch_size

        comp_norm = torch.zeros(k, dtype=tdtype, device=device)
        C = torch.zeros((k, k), dtype=tdtype, device=device)
        B = torch.zeros((k, n_features), dtype=tdtype, device=device)
        n_iter = 0
        if self.verbose:
            log_lim = log(n_samples * self.n_epochs / batch_size, 10)
            self.verbose_iter_ = ((np.logspace(0, log_lim, self.verbose,
                                               base=10) - 1)
                                  * batch_size).tolist()

        self._D, self._C, self._B, self._code = D, C, B, code
        self.n_iter_ = n_iter
        alpha = float(self.alpha)
        lr = float(self.learning_rate)
        self.use_kernel_ = use_kernel

        t0 = time.perf_counter()
        for _ in range(self.n_epochs):
            # the JAX package's draws, in its order: the epoch's
            # permutation, then one atom order a batch
            permutation = self.random_state.permutation(n_samples)
            batches = list(gen_batches(n_samples, batch_size))
            orders = np.stack([self.random_state.permutation(k)
                               for _ in batches])
            perm_dev = torch.as_tensor(permutation).to(device)
            orders_dev = torch.as_tensor(orders).to(device)
            for t, batch in enumerate(batches):
                if self.verbose and getattr(self, 'verbose_iter_', None) \
                        and n_iter >= self.verbose_iter_[0]:
                    print('Iteration %i' % n_iter)
                    self.verbose_iter_ = self.verbose_iter_[1:]
                    self._callback()
                elif not self.verbose and self.callback is not None:
                    self._callback()
                rows = perm_dev[batch]
                if resident is not None:
                    idx, val, lens = (a[rows] for a in resident[:3])
                else:
                    idx, val, lens, _ = _pad_rows(csr, permutation[batch],
                                                  rows)
                code_b = _masked_ridge_codes(D, idx, val, lens, alpha)
                code[rows] = code_b
                D, C, B, comp_norm, feature_n_iter, n_iter = \
                    _recsys_batch_step(D, C, B, comp_norm, feature_n_iter,
                                       n_iter, code_b, idx, val, lens,
                                       orders_dev[t], lr,
                                       use_kernel=use_kernel)
                self._D, self._C, self._B = D, C, B
                self.n_iter_ = n_iter
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        self.time_ = time.perf_counter() - t0
        self._code = self._refit_device(D, csr, resident)
        return self

    def _refit_device(self, D, csr, resident, chunk=2048):
        """All codes on dictionary D, in chunks of ``chunk`` rows at one
        shared width."""
        n_samples = csr.shape[0]
        alpha = float(self.alpha)
        width = csr.width()
        out = D.new_empty((n_samples, self.n_components))
        for batch in gen_batches(n_samples, chunk):
            if resident is not None:
                idx, val, lens = (a[batch] for a in resident[:3])
            else:
                idx, val, lens, _ = _pad_rows(
                    csr, np.arange(batch.start, batch.stop),
                    torch.arange(batch.start, batch.stop, device=D.device),
                    width=width)
            out[batch] = _masked_ridge_codes(D, idx, val, lens, alpha)
        return out

    def _callback(self):
        if self.callback is not None:
            self.callback(self)

    # pickling: device tensors as host numpy ---------------------------- #

    _DEVICE_FIELDS = ('_D', '_C', '_B', '_code')

    def __getstate__(self):
        state = dict(self.__dict__)
        for f in self._DEVICE_FIELDS:
            if state.get(f) is not None:
                state[f] = ('__np__', state[f].cpu().numpy())
        return state

    def __setstate__(self, state):
        device = _resolve_device(state['device'])
        for f in self._DEVICE_FIELDS:
            v = state.get(f)
            if isinstance(v, tuple) and v and v[0] == '__np__':
                state[f] = torch.as_tensor(v[1]).to(device)
        self.__dict__ = state

    # views ---------------------------------------------------------------- #

    @property
    def components_(self):
        return self._D.cpu().numpy()

    @property
    def code_(self):
        return self._code.cpu().numpy()

    @property
    def C_(self):
        return self._C.cpu().numpy()

    @property
    def B_(self):
        return self._B.cpu().numpy()

    def predict(self, X):
        """Predicted values at the stored entries of X."""
        X = _check_csr(X)
        n_samples = X.shape[0]
        row_idx = np.repeat(np.arange(n_samples), np.diff(X.indptr))
        col_idx = X.indices.astype(np.int64)
        device = self._D.device
        out = _predict_entries(self._code, self._D,
                               torch.as_tensor(row_idx).to(device),
                               torch.as_tensor(col_idx).to(device))
        out = out.cpu().numpy().astype(np.float64)

        if self.detrend:
            out += self.row_mean_.take(row_idx)
            out += self.col_mean_.take(col_idx, mode='clip')

        if self.crop is not None:
            out[out > self.crop[1]] = self.crop[1]
            out[out < self.crop[0]] = self.crop[0]

        return sp.csr_matrix((out, X.indices, X.indptr), shape=X.shape)

    def score(self, X):
        """RMSE at the stored entries."""
        X = _check_csr(X)
        return rmse(X, self.predict(X))


def compute_biases(X, beta=0, inplace=False):
    """Row/column detrending biases of a CSR rating matrix: two
    alternating rounds of damped row-mean then column-mean removal;
    ``beta`` shrinks row means toward the global mean and damps column
    means. Segment sums over the stored entries (``np.bincount``)."""
    if not inplace:
        X = X.copy()
    X = sp.csr_matrix(X)
    n_rows, n_cols = X.shape
    vals = X.data
    rows = np.repeat(np.arange(n_rows), np.diff(X.indptr))
    cols = X.indices

    cnt_r = np.maximum(np.bincount(rows, minlength=n_rows), 1)
    cnt_c = np.maximum(np.bincount(cols, minlength=n_cols), 1)
    global_mean = vals.mean() if X.nnz else 0.0

    bias_r = np.zeros(n_rows)
    bias_c = np.zeros(n_cols)
    for _ in range(2):
        w_r = ((np.bincount(rows, weights=vals, minlength=n_rows)
                + global_mean * beta) / (cnt_r + beta))
        vals -= w_r[rows]
        w_c = (np.bincount(cols, weights=vals, minlength=n_cols)
               / (cnt_c + beta))
        vals -= w_c[cols]
        bias_r += w_r
        bias_c += w_c
    return bias_r, bias_c


def rmse(X_true, X_pred):
    """Root mean squared error between two same-pattern sparse matrices."""
    X_true = sp.csr_matrix(X_true)
    X_pred = sp.csr_matrix(X_pred)
    return np.sqrt(np.mean((X_true.data - X_pred.data) ** 2))
