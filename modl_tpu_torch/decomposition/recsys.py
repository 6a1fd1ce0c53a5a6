"""RecsysDictFact: masked online matrix factorisation of sparse ratings.

Counterpart of ``modl_tpu/decomposition/recsys.py`` on PyTorch. Each
minibatch of CSR rows is packed into (b, P) padded (index, value)
blocks, the pad index being ``n_features``, and one batch runs

- per-row masked ridge codes ``(D_s D_s^T + alpha |s| / n I) c =
  D_s x_s`` as a batched Cholesky factorisation and two batched
  triangular solves (``_masked_ridge_codes``, through
  ``ops.solvers.ridge_multi_gram``),
- the order-dependent per-feature B EMA of the reference's serial loop
  in closed form, by cumulative sums down the rows of the batch
  (``_b_ema_dense``),
- the C EMA, and the l2-ball block coordinate descent on the union of
  the batch's supports (``_recsys_batch_step``): D and B are masked to
  the union columns and handed to the BCD kernel whole
  (``ops/bcd.py``, one launch a batch, or the SOMF step's block driver
  where the kernel's plan does not take (k, n)), which leaves the other
  columns at zero; only the union columns of its result are kept.

A batch writes every leaf of the fit's :class:`RecsysState` in place
and takes what changes from batch to batch from device tensors: its
rows' ids, its atom order and its scalars (:func:`batch_scalars`,
computed on the host in the state's dtype from the host ``n_iter``).
Those reach the card in one non-blocking copy from pinned memory
(``_step.DrawStaging``), so a batch reads nothing back and the host
never waits for the card.

Batches are grouped as the JAX package groups them
(:func:`recsys_epoch`): a fit without a callback or ``verbose`` runs
each window of ``WINDOW`` = 32 consecutive full-size batches together,
and every other batch alone (an interactive fit runs every batch
alone, the callback and the verbose schedule before each). Where
``_program.capturable_recsys`` takes the fit (the BCD kernel on the
card, resident rows, no mesh), a window is one replay of a captured
CUDA graph (``_program.RecsysProgram``, the counterpart of the jitted
``_recsys_window_resident``) and every other batch one replay of a
one-batch graph of its size (``_recsys_batch_resident``); the short
last batch of an epoch gets a one-batch graph of its own. The host
draws, stages one copy and launches one graph. A fit builds its
programs anew, and a capture that fails raises. Other fits (a mesh,
rows packed a batch at a time, the plain BCD) run the same batch body
eagerly.

JAX's out-of-range semantics are explicit here: gathers read the pad
index from an appended zero row, and scatters send pad and invalid
entries to dump slots that are dropped afterwards.

Packing runs on the device: the CSR arrays move over once, and one
scatter per block places each entry at ``its position - indptr[row]``.
The whole matrix is packed once when the padded size fits
``RESIDENT_BUDGET`` (batches are then row gathers), else each batch is
packed at its own width. Row lengths for the widths come from the
host's copy of ``indptr``, so the epoch loop reads nothing back from
the device. The JAX package's alternative B-EMA formulation is not
ported.

``mesh=`` (a DeviceMesh with a ``'dp'`` axis, ``parallel.make_mesh``)
runs the fit SPMD, every rank with the same data and ``random_state``:
the resident packed rows are split over ``dp`` (each rank packs and
keeps its block, so resident capacity grows with the mesh), a batch is
reassembled from the ranks' hits by a SUM all-reduce over ``dp``, each
rank solves the codes of its block of the batch's rows (the whole batch
where ``dp`` does not divide it) and the codes are reassembled, and the
rest of the step (B and C EMAs, the union BCD kernel) runs replicated on
every rank, as in the JAX package.
"""
import functools
import time
from dataclasses import dataclass
from math import ceil, log

import numpy as np
import scipy.sparse as sp
import torch

from ..base import BaseEstimator, check_random_state, gen_batches
from ..ops import bcd
from ..ops.precision import precise
from ..ops.solvers import ridge_multi_gram
from ..ops.weights import batch_weight
from ..parallel import mesh as pmesh
from . import _program
from ._step import DrawLayout, DrawStaging, _np_dtype, bcd_kernel
from .dict_fact import _PickleStateMixin, _resolve_device, _torch_dtype

__all__ = ["RecsysDictFact", "compute_biases", "rmse"]

# device budget (bytes of int32 index + value) for packing every row
# once; above it each batch is packed at its own width
RESIDENT_BUDGET = 512 * 1024 * 1024
# full-size batches a window runs together in a fit that is not
# interactive (the JAX package's window, recsys.py:791)
WINDOW = 32
# batches run by fits, eagerly or by programs (read by chip_smoke.py)
BATCHES = 0
# a batch's scalars on the device (:func:`batch_scalars`)
N_SCALARS = 3


@dataclass
class RecsysState:
    """A recsys fit's learner state: device tensors, each written in
    place by every batch (the programs hold their addresses), and the
    host int ``n_iter``."""
    D: torch.Tensor
    C: torch.Tensor
    B: torch.Tensor
    comp_norm: torch.Tensor
    feature_n_iter: torch.Tensor
    code: torch.Tensor
    n_iter: int = 0

    def leaves(self):
        return [self.D, self.C, self.B, self.comp_norm,
                self.feature_n_iter, self.code]


@dataclass(frozen=True)
class RecsysConfig:
    """What a recsys batch takes besides its data and draws: the ridge
    ``alpha``, the ``learning_rate``, whether the BCD kernel runs
    (``use_kernel``) and the mesh (None off a mesh)."""
    alpha: float
    learning_rate: float
    use_kernel: bool
    mesh: object = None


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


def _pad_all_rows(csr, mesh=None):
    """Every row packed once at one shared power-of-two width, or None
    when the padded size exceeds ``RESIDENT_BUDGET`` (per rank).

    On a mesh the rows are padded to a ``dp`` multiple with empty rows
    (pad index, zero value, zero length) and this rank packs and keeps
    its contiguous block of them."""
    n_samples = csr.shape[0]
    P = csr.width()
    itemsize = csr.data.element_size()
    n_dp = pmesh.size(mesh, 'dp')
    n_stored = n_samples + (-n_samples) % n_dp
    if n_stored * P * (4 + itemsize) > n_dp * RESIDENT_BUDGET:
        return None
    r0, m = pmesh.block(mesh, 'dp', n_stored, mesh is not None)
    rows = np.arange(r0, min(r0 + m, n_samples))
    idx, val, lens, P = _pad_rows(
        csr, rows, torch.as_tensor(rows).to(csr.indptr.device), width=P)
    if len(rows) < m:           # the empty rows past n_samples
        extra = m - len(rows)
        idx = torch.cat([idx, idx.new_full((extra, P), csr.shape[1])])
        val = torch.cat([val, val.new_zeros((extra, P))])
        lens = torch.cat([lens, lens.new_zeros(extra)])
    return idx, val, lens, P


def _batch_rows(resident, rows, mesh):
    """A batch's packed rows from the resident ones: a row gather, or on
    a mesh each rank's hits written into zeros and reassembled by SUM
    all-reduces over ``dp`` (exact: every row has one owner)."""
    idx_all, val_all, lens_all = resident[:3]
    if mesh is None:
        return idx_all[rows], val_all[rows], lens_all[rows]
    local, own = pmesh.owned(rows, mesh, pmesh.size(mesh, 'dp')
                             * idx_all.shape[0])
    hit = own[:, None]
    ints = torch.cat([idx_all[local], lens_all[local][:, None]], dim=1)
    ints = torch.where(hit, ints, torch.zeros_like(ints))
    val = val_all[local]
    val = torch.where(hit, val, torch.zeros_like(val))
    pmesh.all_reduce_sum(ints, mesh, 'dp')
    pmesh.all_reduce_sum(val, mesh, 'dp')
    return ints[:, :-1], val, ints[:, -1]


def _batch_codes(D, idx, val, lens, alpha, mesh):
    """The batch's codes: on a mesh whose ``dp`` divides the batch, each
    rank solves its block of the rows and the codes are reassembled over
    ``dp``."""
    b = idx.shape[0]
    if not pmesh.rows_split(mesh, b):
        return _masked_ridge_codes(D, idx, val, lens, alpha)
    code = _masked_ridge_codes(D, pmesh.shard_batch(idx, mesh),
                               pmesh.shard_batch(val, mesh),
                               pmesh.shard_indices(lens, mesh), alpha)
    return pmesh.unshard(code, mesh, 'dp', 0, b, True)


@precise
def _masked_ridge_codes(D, idx, val, lens, alpha):
    """Per-row masked ridge solves; rows with an empty support get a
    zero code. D (k, n); idx/val (b, P) padded; lens (b,). The solves
    are ``ops.solvers.ridge_multi_gram``'s, which a capture takes."""
    k, n = D.shape
    # support columns as rows of D^T, plus a zero row read by the pad
    # index n
    Dt = torch.cat([D.T, D.new_zeros((1, k))])
    Dg = Dt[idx.long()]                                  # (b, P, k)
    Dx = torch.einsum('bpk,bp->bk', Dg, val)
    G = torch.einsum('bpk,bpq->bkq', Dg, Dg)
    lens_f = torch.clamp(lens, min=1).to(D.dtype)
    ridge = _full(alpha, lens_f) / (_full(n, lens_f) / lens_f)
    code = ridge_multi_gram(G, Dx, ridge[:, None, None])
    return torch.where((lens > 0)[:, None], code, torch.zeros_like(code))


def _valid_cols(idx, lens, fill):
    """The batch's columns as int64, with pad and invalid entries (past
    a row's length) sent to column ``fill``."""
    P = idx.shape[1]
    invalid = torch.arange(P, device=idx.device)[None, :] >= lens[:, None]
    # masked_fill takes the fill as a kernel argument (torch.where would
    # copy a Python number from host memory, which a capture refuses)
    return idx.long().masked_fill(invalid, fill)


def _b_ema_dense(B, feature_n_iter, code_b, idx, val, lens, wn):
    """Order-dependent per-feature B EMA of one batch, in closed form.

    The reference's serial loop gives row j the weight ``min(1, w
    n_iter / count)`` with the column's visit count after its own
    increment, and lets later rows decay earlier rows' contributions.
    That couples entries only within a column, in row order: on the
    dense (b, n) scatter of the batch the per-entry rank is an exclusive
    cumulative sum of the occupancy down the rows, and the exclusive
    suffix decay product is a reversed cumulative product (absent
    entries contribute factors of exactly 1). Pad and invalid entries
    go to the dump column ``n + 1``. ``wn`` is ``w n_iter`` (a 0-d
    tensor of the state dtype, :func:`batch_scalars`). Writes ``B`` and
    ``feature_n_iter`` in place and returns them.
    """
    k, n = B.shape
    b, P = idx.shape
    cols = _valid_cols(idx, lens, n + 1)
    rows = torch.arange(b, device=B.device)[:, None].expand(b, P)
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
    w_rc = torch.clamp(wn / torch.clamp(count, min=1.0), max=1.0) * occ
    q = 1.0 - w_rc
    sfx = torch.flip(torch.cumprod(torch.flip(q, (0,)), 0), (0,))
    sfx_excl = torch.cat([sfx[1:], torch.ones_like(sfx[:1])])
    B.mul_(sfx[0, :n][None, :]).addmm_(code_b.T,
                                      (w_rc * xv * sfx_excl)[:, :n])
    feature_n_iter.add_(csum[-1, :n].to(feature_n_iter.dtype))
    return B, feature_n_iter


@precise
def _recsys_batch_step(state, code_b, idx, val, lens, order, scalars,
                       use_kernel=False):
    """One batch update once the codes are solved, in place on
    ``state``'s leaves: the B EMA, the C EMA, the union mask and the
    union BCD. ``scalars`` are the batch's (:func:`batch_scalars`) on the
    device and ``order`` its atom order there.

    ``use_kernel`` runs the BCD kernel (one call, or the block driver
    where its plan does not take (k, n)); otherwise its plain version
    runs on the same masked inputs (its math is the JAX package's lax
    loop: budget ``cn + ||D_j||^2`` at visit time, the atom kept where
    ``C_jj <= 1e-20``)."""
    D, C, B = state.D, state.C, state.B
    n = D.shape[1]
    wn, decay, w_b = scalars.unbind()
    _b_ema_dense(B, state.feature_n_iter, code_b, idx, val, lens, wn)
    C.mul_(decay).add_(w_b * (code_b.T @ code_b))

    # union of supports: a scatter into n + 1 slots, the pad slot dropped
    slots = D.new_zeros(n + 1)
    slots.index_fill_(0, _valid_cols(idx, lens, n).reshape(-1), 1.0)
    union_f = slots[:n]

    if use_kernel:
        D_new, comp_norm = bcd_kernel(D * union_f, B * union_f, C,
                                      state.comp_norm, order, False, 0.0)
    else:
        D_new, comp_norm = bcd.bcd_update_reference(
            D * union_f, B * union_f, C, state.comp_norm, order,
            comp_pos=False, l1_ratio=0.0)
    torch.where(union_f[None, :] > 0, D_new, D, out=D)
    state.comp_norm.copy_(comp_norm)


def batch_scalars(state, cfg, b):
    """Advance ``state.n_iter`` by a batch of ``b`` and return the batch's
    ``N_SCALARS`` scalars as a numpy array of the state's dtype, computed
    in that dtype as the JAX package's step computes them from its
    ``n_iter``: ``w n_iter``, ``1 - w`` and ``w / b``, with ``w`` the
    batch weight (``batch_weight``). ``n_iter`` and ``w`` reach the
    device only through these."""
    np_dtype = _np_dtype(state.D.dtype)
    state.n_iter += b
    w = batch_weight(state.n_iter, b, cfg.learning_rate, 0.0, np_dtype)
    return np.array([w * np_dtype.type(state.n_iter),
                     np_dtype.type(1.0) - w, w / np_dtype.type(b)], np_dtype)


def draw_layout(state, b):
    """Where a batch's rows (b,), order and scalars lie in its staged
    bytes (``_step.DrawLayout``)."""
    return DrawLayout(b, state.D.shape[0], state.D.dtype,
                      n_scalars=N_SCALARS)


@precise
def _recsys_batch(state, cfg, idx, val, lens, rows, order, scalars):
    """One batch given its packed rows and its draws on the device: the
    codes (solved on ``dp`` blocks on a mesh), their write into
    ``state.code`` at ``rows``, then :func:`_recsys_batch_step`."""
    code_b = _batch_codes(state.D, idx, val, lens, cfg.alpha, cfg.mesh)
    state.code.index_copy_(0, rows, code_b)
    _recsys_batch_step(state, code_b, idx, val, lens, order, scalars,
                       use_kernel=cfg.use_kernel)


def _resident_batch(state, cfg, resident, rows, order, scalars):
    """A batch of the resident packed rows: their gathers by the device
    row ids ``rows`` (reassembled over ``dp`` on a mesh), then
    :func:`_recsys_batch`. The body a ``RecsysProgram`` captures."""
    idx, val, lens = _batch_rows(resident, rows, cfg.mesh)
    _recsys_batch(state, cfg, idx, val, lens, rows, order, scalars)


def recsys_batches(state, cfg, src, rows_w, orders_w, staging):
    """Batches run eagerly: their scalars (:func:`batch_scalars`, which
    advances ``state.n_iter``), rows and orders sent to the device in one
    non-blocking copy through ``staging`` (a ``_step.DrawStaging``),
    then each batch's body. ``rows_w`` (T, b) and ``orders_w`` (T, k)
    are host arrays; ``src`` the resident packed rows or a
    ``_DeviceCSR``, whose batches are packed each at its own width."""
    b = rows_w.shape[1]
    steps = staging.send_steps(
        draw_layout(state, b), [(rows, order, batch_scalars(state, cfg, b))
                                for rows, order in zip(rows_w, orders_w)])
    for rows_h, (rows, order, scalars) in zip(rows_w, steps):
        if isinstance(src, _DeviceCSR):
            idx, val, lens, _ = _pad_rows(src, rows_h, rows)
            _recsys_batch(state, cfg, idx, val, lens, rows, order, scalars)
        else:
            _resident_batch(state, cfg, src, rows, order, scalars)


def _run(state, cfg, src, rows_w, orders_w, programs, staging):
    """T batches of b rows (``rows_w`` (T, b)): one run of the
    ``RecsysProgram`` of (T, b) in ``programs`` (built on first use)
    where ``programs`` is a dict, else :func:`recsys_batches`."""
    global BATCHES
    T, b = rows_w.shape
    if programs is None:
        recsys_batches(state, cfg, src, rows_w, orders_w, staging)
    else:
        prog = programs.get((T, b))
        if prog is None:
            prog = programs[(T, b)] = _program.RecsysProgram(
                state.leaves() + list(src[:3]),
                functools.partial(_resident_batch, state, cfg, src),
                draw_layout(state, b), T)
        prog.stage([(rows, order, batch_scalars(state, cfg, b))
                    for rows, order in zip(rows_w, orders_w)])
        prog.run()
    BATCHES += T


def recsys_epoch(state, cfg, src, random_state, batch_size, programs,
                 staging, before_batch=None):
    """One epoch over ``state.code``'s rows, grouped and drawn as the
    JAX package's fit does (``modl_tpu/decomposition/recsys.py:824-893``):
    the epoch's permutation, then in turn each window of ``WINDOW``
    consecutive full-size batches with its ``WINDOW`` atom orders, where
    ``before_batch`` is None (the fit is not interactive), or else each
    batch alone, ``before_batch()`` (the callback and the verbose
    schedule) called before its order is drawn. ``programs``: a dict of
    the fit's ``RecsysProgram``s by (T, b), which run the windows (T =
    ``WINDOW``) and the other batches (T = 1, one program a batch size:
    the short last batch has its own); None runs every batch eagerly
    through ``staging`` (a ``_step.DrawStaging``). ``src`` is the
    resident packed rows, or a ``_DeviceCSR`` (eager only)."""
    n_samples = state.code.shape[0]
    k = state.D.shape[0]
    window = WINDOW if before_batch is None else 1
    permutation = random_state.permutation(n_samples)
    batches = list(gen_batches(n_samples, batch_size))
    pos = 0
    while pos < len(batches):
        group = batches[pos:pos + window]
        if before_batch is None and len(group) == window and all(
                bt.stop - bt.start == batch_size for bt in group):
            rows_w = np.stack([permutation[bt] for bt in group])
            orders_w = np.stack([random_state.permutation(k)
                                 for _ in group])
            pos += window
        else:
            batch = batches[pos]
            pos += 1
            if before_batch is not None:
                before_batch()
            rows_w = permutation[batch][None]
            orders_w = random_state.permutation(k)[None]
        _run(state, cfg, src, rows_w, orders_w, programs, staging)


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


class RecsysDictFact(_PickleStateMixin, BaseEstimator):
    """Masked matrix-factorisation estimator for sparse ratings.

    Parameters mirror ``modl_tpu.RecsysDictFact``: ``alpha`` (ridge),
    ``beta`` (bias shrinkage), ``n_components``, ``learning_rate``,
    ``batch_size`` (None: ceil(1 / sparsity)), ``detrend``, ``crop``,
    ``mesh`` (a DeviceMesh with a ``'dp'`` axis: the SPMD fit of the
    module docstring; pickles drop it). ``device`` places the state
    (``'cuda'`` by default; asking for CUDA where there is none raises)
    and ``dtype`` is the state's float type (float64 is the counterpart
    of the JAX package's x64 mode). On CUDA the BCD kernel runs every
    batch's dictionary update (``use_kernel_``), which takes float32
    state only; the CPU runs its plain version. ``time_`` is the epoch
    loop's wall time, ending in one device synchronisation.
    """

    def __init__(self, alpha=1.0, beta=.0, n_components=30,
                 learning_rate=1., batch_size=1, dict_init=None,
                 l1_ratio=0, n_epochs=1, random_state=None, verbose=0,
                 detrend=False, crop=None, callback=None, mesh=None,
                 device='cuda', dtype=np.float32):
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
        self.mesh = mesh
        self.device = device
        self.dtype = dtype

    def fit(self, X, y=None):
        state, cfg, csr, resident, batch_size = self._start(X)
        # a dict of programs where the fit runs as programs, built anew
        # each fit
        self._programs = ({} if _program.capturable_recsys(
            cfg, resident is not None) else None)
        staging = DrawStaging(state.D.device)
        interactive = bool(self.verbose) or self.callback is not None
        before_batch = (functools.partial(self._before_batch, state)
                        if interactive else None)
        src = csr if resident is None else resident
        t0 = time.perf_counter()
        for _ in range(self.n_epochs):
            recsys_epoch(state, cfg, src, self.random_state, batch_size,
                         self._programs, staging, before_batch)
            self.n_iter_ = state.n_iter
        if state.D.device.type == 'cuda':
            torch.cuda.synchronize(state.D.device)
        self.time_ = time.perf_counter() - t0
        self._code = self._refit_device(state.D, csr, resident)
        return self

    def _make_config(self, device):
        """The fit's :class:`RecsysConfig`: the BCD kernel on the card, its
        plain version on the CPU."""
        return RecsysConfig(alpha=float(self.alpha),
                            learning_rate=float(self.learning_rate),
                            use_kernel=device.type == 'cuda', mesh=self.mesh)

    def _start(self, X):
        """A fit's set-up: the checks, the detrending, the initial
        dictionary (the first draw of ``random_state``), the packed rows
        (resident where they fit ``RESIDENT_BUDGET``) and the initial
        codes, and zero statistics. Sets the fitted attributes that do
        not change during the epochs; returns ``(state, cfg, csr,
        resident, batch_size)``, ``state`` a :class:`RecsysState` whose
        tensors are ``_D``, ``_C``, ``_B`` and ``_code``."""
        mesh = self.mesh
        if mesh is not None and 'dp' not in (mesh.mesh_dim_names or ()):
            raise ValueError(
                "RecsysDictFact(mesh=...) requires a mesh with a 'dp' axis "
                f'(got axes {mesh.mesh_dim_names!r}): the resident rows and '
                'the ridge solves split over dp')
        device = _resolve_device(self.device)
        tdtype = _torch_dtype(self.dtype)
        cfg = self._make_config(device)
        if device.type == 'cuda' and tdtype != torch.float32:
            raise ValueError(f'RecsysDictFact: the CUDA BCD kernel takes '
                             f'float32 state, got dtype={self.dtype!r}; '
                             'float64 fits run with device="cpu"')
        X = _check_csr(X, copy=True)
        n_samples, n_features = X.shape
        k = self.n_components
        self._n_features = n_features
        self.random_state = check_random_state(self.random_state)
        if mesh is not None:
            pmesh.check_same([pmesh.fingerprint(
                self.random_state.get_state()[1])], mesh, 'random_state')

        if self.detrend:
            self.row_mean_, self.col_mean_ = compute_biases(
                X, beta=self.beta, inplace=False)
            X.data -= np.repeat(self.row_mean_, np.diff(X.indptr))
            X.data -= self.col_mean_.take(X.indices, mode='clip')

        D0 = self.random_state.randn(k, n_features)
        D0 /= np.sqrt(np.sum(D0 ** 2, axis=1))[:, np.newaxis]
        D = torch.as_tensor(D0).to(device, tdtype)

        csr = _DeviceCSR(X, device, tdtype)
        resident = _pad_all_rows(csr, mesh)
        self.resident_width_ = resident[3] if resident is not None else None
        # rows of the packed block this rank holds (all, off a mesh)
        self._resident_rows = (resident[0].shape[0] if resident is not None
                               else None)
        code = self._refit_device(D, csr, resident)

        self.feature_freq_ = np.bincount(X.indices, minlength=n_features) \
            / n_samples
        sparsity = X.nnz / n_samples / n_features
        if self.batch_size is None:
            batch_size = int(ceil(1. / sparsity))
        else:
            batch_size = self.batch_size
        if self.verbose:
            log_lim = log(n_samples * self.n_epochs / batch_size, 10)
            self.verbose_iter_ = ((np.logspace(0, log_lim, self.verbose,
                                               base=10) - 1)
                                  * batch_size).tolist()

        state = RecsysState(
            D=D, C=torch.zeros((k, k), dtype=tdtype, device=device),
            B=torch.zeros((k, n_features), dtype=tdtype, device=device),
            comp_norm=torch.zeros(k, dtype=tdtype, device=device),
            feature_n_iter=torch.zeros(n_features, dtype=torch.int32,
                                       device=device),
            code=code)
        self._D, self._C, self._B, self._code = (state.D, state.C, state.B,
                                                 state.code)
        self.n_iter_ = 0
        self.use_kernel_ = cfg.use_kernel
        return state, cfg, csr, resident, batch_size

    def _before_batch(self, state):
        """An interactive fit's hook before each batch: the verbose
        schedule's print and callback, or the callback alone."""
        self.n_iter_ = state.n_iter
        if self.verbose and getattr(self, 'verbose_iter_', None) \
                and state.n_iter >= self.verbose_iter_[0]:
            print('Iteration %i' % state.n_iter)
            self.verbose_iter_ = self.verbose_iter_[1:]
            self._callback()
        elif not self.verbose and self.callback is not None:
            self._callback()

    def _refit_device(self, D, csr, resident, chunk=2048):
        """All codes on dictionary D, in chunks of ``chunk`` rows at one
        shared width. On a mesh with resident rows each rank solves its
        block and the codes are reassembled over ``dp``."""
        n_samples = csr.shape[0]
        alpha = float(self.alpha)
        if resident is not None and self.mesh is not None:
            m = resident[0].shape[0]
            out = D.new_empty((m, self.n_components))
            for batch in gen_batches(m, chunk):
                out[batch] = _masked_ridge_codes(
                    D, *(a[batch] for a in resident[:3]), alpha)
            n_dp = pmesh.size(self.mesh, 'dp')
            return pmesh.unshard(out, self.mesh, 'dp', 0, n_dp * m,
                                 True)[:n_samples]
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

    # pickled as host numpy by _PickleStateMixin
    _DEVICE_FIELDS = ('_D', '_C', '_B', '_code')

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
