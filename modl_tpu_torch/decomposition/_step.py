"""SOMF/OMF core in PyTorch: learner state, one step, and the fused epoch.

Counterpart of ``modl_tpu/decomposition/_step.py``. One step runs

    subset draw -> step weights -> code solve -> C/B statistics EMA ->
    block coordinate descent on the dictionary (subset columns only)

and ``somf_scan`` runs an epoch over device-resident minibatches with
B's full-width EMA deferred across segments; ``offload_scan`` runs a
segment of an ``average_offload`` epoch, whose ``G_avg`` stays in host
RAM. ``state_to_numpy``/``state_from_numpy`` carry the state to the
host and back under the JAX package's field names (pickles,
checkpoints). PyTorch runs eagerly, so the
state is a plain dataclass of tensors (it carries no gradients) updated
in place where JAX's immutability forced copies: every leaf keeps its
tensor (and its address) across steps, which the captured step of
``_program.py`` relies on. Draws (window starts, Binomial sizes, atom
orders) are made on a host generator ahead of the step, and the step's
scalars (the batch weight and what derives from it, the Binomial size,
the deferred-B segment's decay product) are computed on the host
(:func:`step_scalars`). ``somf_step`` sends a step's subset or window
start, order and scalars to the device in one non-blocking copy from
pinned memory (:class:`DrawStaging`), and ``somf_scan`` a whole
epoch's in one copy (:func:`stage_epoch`), so the step body
(``_step_body``) takes every value that changes from step to step from
device tensors, reads nothing back and never makes the host wait for
the card. A window start on the device addresses its columns by a
gather at ``start + arange(width)`` (the JAX package's
``lax.dynamic_slice``) and writes them back by two index copies
(:func:`_writeback_window_at`).

On a mesh (``cfg.mesh``, a state sharded by ``parallel.mesh.
shard_state``) the same step body runs on every rank over its shards,
through the collectives of ``_Sharded``: window and subset reads
reassembled over ``feat``, per-sample rows gathered over ``dp``, this
rank's batch rows solved and their codes reassembled, the BCD kernel
launched on the replicated (k, s) block by every rank, and the
write-back made shard-local. Off the mesh ``_Local`` gives the plain
indexing.

Only each TPU switch's default branch is ported; the JAX package keeps
the alternatives. ``comp_pos`` clamps only the atom being updated, as
in the JAX package (its module docstring explains the deviation from
the reference).
"""
import dataclasses
import zlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import bcd, ema_gemm
from ..ops.enet import enet_norm, enet_projection, enet_projection_batch
from ..ops.precision import precise
from ..ops.sampler import (draw_subset, draw_subset_sized, draw_window,
                           draw_window_sized)
from ..ops.solvers import (enet_regression_multi_gram,
                           enet_regression_single_gram)
from ..ops.weights import batch_weight, sample_weight
from ..parallel import mesh as pmesh
from ..utils.profiling import span

# rows per block of the plain (use_kernel=False) block-recomputed BCD
PLAIN_BLOCK = 128


@dataclass
class SomfState:
    """All learner state; tensors live on the fit's device except the
    sampler's ``box`` (host, gather mode) and ``gen`` (host generator)."""
    D: torch.Tensor                  # (k, n_stored) dictionary
    C: torch.Tensor                  # (k, k) code second-moment EMA
    B: torch.Tensor                  # (k, n_stored) code-data EMA
    G: Optional[torch.Tensor]        # (k, k) Gram, only for G_agg == 'full'
    comp_norm: torch.Tensor          # (k,) enet-norm budget
    code: Optional[torch.Tensor]     # (n_samples, k) per-sample codes
    Dx_avg: Optional[torch.Tensor]   # (n_samples, k), Dx_agg == 'average'
    G_avg: Optional[torch.Tensor]    # (n_samples, k, k), G_agg == 'average'
    n_iter: int                      # samples seen (host)
    sample_n_iter: torch.Tensor      # (n_samples,) visits per sample
    box: torch.Tensor                # (n_features,) sampler box (host)
    cursor: int                      # sampler cursor (host)
    gen: torch.Generator             # host generator: subsets and orders
    layout: object = None            # parallel.mesh.Layout of a sharded
                                     # state (None: whole tensors)


@dataclass(frozen=True)
class SomfConfig:
    """Static solver configuration (``modl_tpu``'s ``SomfConfig``;
    ``use_kernel`` is ``use_pallas``)."""
    n_components: int
    len_subset: int
    reduction: float
    Dx_agg: str                     # 'full' | 'masked' | 'average'
    G_agg: str                      # 'full' | 'masked' | 'average'
    optimizer: str                  # 'variational' | 'sgd'
    learning_rate: float
    sample_learning_rate: float
    step_size: float
    code_alpha: float
    code_l1_ratio: float
    comp_l1_ratio: float
    code_pos: bool
    comp_pos: bool
    tol: float
    max_iter: int
    replacement: bool
    rand_size: bool = False         # Binomial subset sizes (masked tail)
    len_max: int = 0                # subset storage width under rand_size
    use_kernel: bool = False        # Hopper BCD kernel (CUDA, float32)
    code_solver: str = 'cd'         # 'cd' | 'fista'
    windowed: bool = False          # subsets are circular windows of one
                                    # fixed feature order (mirror-padded
                                    # storage); subsets are window starts
    n_features: int = 0             # logical feature count (windowed)
    average_offload: bool = False   # G_avg in host RAM, exchanged per
                                    # segment (offload_scan)
    mesh: object = None             # ('dp', 'feat') DeviceMesh of an SPMD
                                    # fit (pickling drops it)


class Draws(NamedTuple):
    """One epoch's host draws: per step a window start (int) or a subset
    index tensor, a Binomial size (int, or None without rand_size), and
    the (T, k) atom orders."""
    subsets: list
    sizes: list
    orders: torch.Tensor


def _np_dtype(dtype):
    """numpy dtype of a torch float dtype."""
    return np.dtype(str(dtype).removeprefix('torch.'))


def _width(cfg, subset):
    if cfg.windowed:
        return cfg.len_max if cfg.rand_size else cfg.len_subset
    return subset.shape[0]


def _subset_cols(A, subset, width):
    """Columns of A addressed by a subset: the window ``[start, start +
    width)`` of a host start (a view; the mirror pad makes circular
    windows contiguous) or a gather at an index tensor (a copy): a
    gather subset, or a window's columns ``start + arange(width)`` of a
    start on the device."""
    if isinstance(subset, int):
        return A[:, subset:subset + width]
    return A[:, subset]


def _valid_mask(width, n_valid, dtype, device):
    """1 on the columns below ``n_valid`` (a 0-d device tensor), else 0."""
    return (torch.arange(width, device=device) < n_valid).to(dtype)


def _writeback_window(D, V, start, n_log, base=0):
    """In-place windowed write-back of the window values ``V`` (k, s) at
    column ``start``, into the columns ``[base, base + D.shape[1])``
    that ``D`` holds (the whole array, or a ``feat`` shard): the window,
    the head columns a wrapped window folds into, and the mirror of a
    window that overlaps the head, so that D[:, n:] == D[:, :s] again
    (the mirror held the head before). Each is one slice copy of V,
    clipped to the block; no column is read back."""
    s = V.shape[1]
    stop = base + D.shape[1]
    # (first column, end, column of V[:, 0]): window, wrapped head,
    # mirror of the head overlap
    for lo, hi, src in ((start, start + s, start),
                        (0, start + s - n_log, start - n_log),
                        (n_log + start, n_log + s, n_log + start)):
        lo, hi = max(lo, base), min(hi, stop)
        if lo < hi:
            D[:, lo - base:hi - base] = V[:, lo - src:hi - src]


def _writeback_window_at(D, V, cols, n_log):
    """:func:`_writeback_window` for a window on the device: ``cols`` =
    ``start + arange(s)`` (s = V.shape[1] <= n_log, the mirror pad's
    width). Two index copies of V: the window at its columns, then each
    window column's other copy, distinct columns all: ``c - n_log`` for
    a column of the mirror (c >= n_log: the head it wraps into),
    ``c + n_log`` for a column of the head (c < s: its mirror), else
    ``c`` itself again with the same value. The JAX package's
    "purewrite" form (``modl_tpu/decomposition/_step.py``) writes the
    same values; no column is read back."""
    s = V.shape[1]
    D.index_copy_(1, cols, V)
    other = torch.where(cols >= n_log, cols - n_log,
                        torch.where(cols < s, cols + n_log, cols))
    D.index_copy_(1, other, V)


class _Local:
    """Batch rows and subset columns of a step on whole tensors: plain
    indexing and no collective. ``rows`` picks this rank's rows out of
    full-batch values (all of them here); ``n_stored`` is the width of
    D and B."""
    split_cols = False
    rows = slice(None)
    agree = None

    def __init__(self, idx, n_stored):
        self.idx = idx
        self.n_stored = n_stored

    def visit(self, sample_n_iter):
        """Count the batch's visits of its samples."""
        sample_n_iter.index_add_(
            0, self.idx, torch.ones_like(self.idx,
                                         dtype=sample_n_iter.dtype))

    def read(self, leaves):
        """The batch's rows of per-sample leaves, (b, ...) each."""
        return [leaf[self.idx] for leaf in leaves]

    def write(self, leaf, values):
        """Write the batch's rows of a per-sample leaf."""
        leaf[self.idx] = values

    def batch(self, t):
        """Full-batch values from this rank's rows of them."""
        return t

    def sum_rows(self, t):
        """A sum over the batch's rows from this rank's partial sum."""
        return t

    def sum_feat(self, t):
        """A sum over the features from this rank's partial sum."""
        return t

    def col(self, g):
        """This rank's index of global column ``g`` (clipped)."""
        return g

    def norms(self, X):
        """``||x_i||^2`` of the rows of X where its columns are split,
        else None (the solver takes them from X)."""
        return None

    def cols(self, A, subset, width, cfg):
        """The subset's columns of A (D, B or X), whole."""
        return _subset_cols(A, subset, width)

    def write_cols(self, D, subset, V, cfg):
        """Write the subset's new columns V into D."""
        if not cfg.windowed:
            D[:, subset] = V
        elif isinstance(subset, int):
            _writeback_window(D, V, subset, cfg.n_features)
        else:
            _writeback_window_at(D, V, subset, cfg.n_features)

    def window_grad(self, B0, SC, Xseg, start, width, pi, cfg):
        """The gradient window ``pi B0[:, win] + SC^T Xseg[:, win]`` of a
        deferred-B segment (``pi`` a 0-d tensor)."""
        return (pi * _subset_cols(B0, start, width)
                + SC.T @ _subset_cols(Xseg, start, width))

    def segment_end(self, B, SC, Xseg, pi, kernel):
        """``B <- pi B + SC^T Xseg`` in place (``pi`` a 0-d tensor on B's
        device): the EMA-GEMM kernel (``kernel``) or its plain version."""
        if kernel:
            ema_gemm.ema_accumulate(B, SC, Xseg, pi)
        else:
            ema_gemm.ema_accumulate_reference(B, SC, Xseg, pi)


class _Sharded(_Local):
    """The same on a rank's shards (``parallel.mesh``): per-sample rows
    gathered over ``dp`` and written by their owner; this rank's block
    of the batch's rows (``rows``), whose codes are reassembled over
    ``dp`` and whose partial sums are all-reduced there; subset columns
    reassembled over ``feat`` from the shards and written shard-local.
    Every collective is a SUM all-reduce."""

    def __init__(self, idx, layout):
        super().__init__(idx, layout.n_stored)
        self.lay = layout
        self.mesh = mesh = layout.mesh
        b = idx.shape[0]
        self.split_batch = pmesh.rows_split(mesh, b)
        r0, nr = pmesh.block(mesh, 'dp', b, self.split_batch)
        self.rows = slice(r0, r0 + nr)
        self.split_cols = layout.split_cols
        self.base, self.width = layout.cols()
        # the dp rank that adds replicated terms to sums over dp
        self.lead = pmesh.coord(mesh, 'dp') == 0 or not self.split_batch
        self.agree = self.sum_rows if self.split_batch else None

    def visit(self, sample_n_iter):
        if not self.lay.split_rows:
            return super().visit(sample_n_iter)
        local, own = pmesh.owned(self.idx, self.mesh, self.lay.n_samples)
        sample_n_iter.index_add_(0, local, own.to(sample_n_iter.dtype))

    def read(self, leaves):
        return pmesh.gather_rows(leaves, self.idx, self.mesh,
                                 self.lay.n_samples, self.lay.split_rows)

    def write(self, leaf, values):
        pmesh.scatter_rows(leaf, self.idx, values, self.mesh,
                           self.lay.n_samples, self.lay.split_rows)

    def batch(self, t):
        if not self.split_batch:
            return t
        return pmesh.unshard(t.contiguous(), self.mesh, 'dp', 0,
                             self.idx.shape[0], True)

    def sum_rows(self, t):
        if not self.split_batch:
            return t
        return pmesh.all_reduce_sum(t, self.mesh, 'dp')

    def sum_feat(self, t):
        if not self.split_cols:
            return t
        return pmesh.all_reduce_sum(t, self.mesh, 'feat')

    def col(self, g):
        return min(max(g - self.base, 0), self.width)

    def norms(self, X):
        if not self.split_cols:
            return None
        return self.sum_feat(torch.sum(X * X, dim=-1))

    def _window(self, start, width):
        """``(j0, j1, l0)``: columns [j0, j1) of the window ``[start,
        start + width)`` are this rank's columns from ``l0`` on."""
        j0 = min(max(self.base - start, 0), width)
        j1 = max(min(self.base + self.width - start, width), j0)
        return j0, j1, start + j0 - self.base

    def _owned(self, subset):
        local = subset - self.base
        own = (local >= 0) & (local < self.width)
        return torch.where(own, local, torch.zeros_like(local)), own

    def cols(self, A, subset, width, cfg):
        if not self.split_cols:
            return super().cols(A, subset, width, cfg)
        if cfg.windowed:
            j0, j1, l0 = self._window(subset, width)
            out = A.new_zeros((A.shape[0], width))
            out[:, j0:j1] = A[:, l0:l0 + j1 - j0]
            return self.sum_feat(out)
        local, own = self._owned(subset)
        return pmesh.assemble_cols(A, torch.where(own, local, -1), width,
                                   self.mesh)

    def write_cols(self, D, subset, V, cfg):
        if not self.split_cols:
            return super().write_cols(D, subset, V, cfg)
        if cfg.windowed:
            _writeback_window(D, V, subset, cfg.n_features, self.base)
        else:
            pmesh.put_owned(D, 1, *self._owned(subset), V)

    def window_grad(self, B0, SC, Xseg, start, width, pi, cfg):
        j0, j1, l0 = self._window(start, width)
        cols = slice(l0, l0 + j1 - j0)
        part = SC.T @ Xseg[:, cols]
        if self.lead:
            part += pi * B0[:, cols]
        part = self.sum_rows(part)
        if not self.split_cols:
            return part
        out = part.new_zeros((part.shape[0], width))
        out[:, j0:j1] = part
        return self.sum_feat(out)

    def segment_end(self, B, SC, Xseg, pi, kernel):
        # B0 is replicated over dp: only the lead rank's sum carries it
        if not self.lead:
            B.zero_()
            pi = torch.zeros_like(pi)
        super().segment_end(B, SC, Xseg, pi, kernel)
        self.sum_rows(B)


def _context(state, cfg, idx):
    """The step's rows and columns: ``_Sharded`` on a mesh, else
    ``_Local``."""
    if cfg.mesh is None:
        return _Local(idx, state.D.shape[1])
    if state.layout is None:
        raise ValueError('the configuration has a mesh but the state is '
                         'whole: shard it with parallel.mesh.shard_state')
    return _Sharded(idx, state.layout)


def _solve_code(state, X, ctx, w_sample, subset, cfg, n_valid=None):
    """Codes of this rank's batch rows under the Dx/G estimators
    (dict_fact.py:577-648 of the reference). ``w_sample`` holds the
    whole batch's sample weights. Updates ``Dx_avg``/``G_avg`` in
    place."""
    D = state.D
    width = _width(cfg, subset)
    rows = ctx.rows
    want = [name for name, on in (('code', state.code is not None),
                                  ('Dx_avg', cfg.Dx_agg == 'average'),
                                  ('G_avg', cfg.G_agg == 'average')) if on]
    old = dict(zip(want, ctx.read([getattr(state, n) for n in want])))
    if cfg.Dx_agg != 'full' or cfg.G_agg != 'full':
        D_subset = ctx.cols(D, subset, width, cfg)
        if n_valid is not None:
            D_subset = D_subset * _valid_mask(width, n_valid, D.dtype,
                                              D.device)[None, :]

    if cfg.Dx_agg == 'full':
        Dx = X @ D.T
        if cfg.windowed:
            # the mirror columns [n, n + w) duplicate the head columns
            m0 = ctx.col(cfg.n_features)
            Dx = Dx - X[:, m0:] @ D[:, m0:].T
        Dx = ctx.sum_feat(Dx)
    else:
        X_subset = ctx.cols(X, subset, width, cfg)
        Dx = (X_subset @ D_subset.T) * cfg.reduction
        if cfg.Dx_agg == 'average':
            prev, w_rows = old['Dx_avg'][rows], w_sample[rows]
            # unvisited rows (exact zeros) take the new estimate whole
            unvisited = torch.sum(torch.abs(prev), dim=-1) == 0
            w_eff = torch.where(unvisited, torch.ones_like(w_rows), w_rows)
            Dx = prev * (1.0 - w_eff[:, None]) + Dx * w_eff[:, None]
            ctx.write(state.Dx_avg, ctx.batch(Dx))

    if cfg.G_agg == 'full':
        G = state.G
    else:
        G = (D_subset @ D_subset.T) * cfg.reduction
        if cfg.G_agg == 'average':
            # the whole batch's rows: G is replicated, so every rank
            # computes them and writes those it owns
            prev = old['G_avg']
            unvisited = torch.sum(torch.abs(prev), dim=(-2, -1)) == 0
            w_eff = torch.where(unvisited, torch.ones_like(w_sample),
                                w_sample)
            G = (prev * (1.0 - w_eff[:, None, None])
                 + G[None] * w_eff[:, None, None])
            ctx.write(state.G_avg, G)
            G = G[rows]

    w0 = old['code'][rows] if 'code' in old else torch.ones_like(Dx)
    # the solvers read X only through ||x_i||^2: drop the mirror columns
    X_solver = X[:, :ctx.col(cfg.n_features)] if cfg.windowed else X
    y_norm2 = ctx.norms(X_solver) if cfg.code_l1_ratio != 0 else None
    solve = (enet_regression_multi_gram if cfg.G_agg == 'average'
             else enet_regression_single_gram)
    return solve(w0, G, Dx, X_solver, cfg.code_l1_ratio, cfg.code_alpha,
                 cfg.code_pos, cfg.tol, cfg.max_iter,
                 solver=cfg.code_solver, y_norm2=y_norm2, agree=ctx.agree)


def _bcd_plain(D_subset, grad_subset, C, comp_norm, order, cfg):
    """Block-recomputed BCD with the exact sort projection (the JAX
    package's lax body, _step.py:461-481): per block of the visit
    order, the residual rows are recomputed with one (bs, k) x (k, s)
    product and the atoms are updated one by one."""
    k = C.shape[0]
    l1 = cfg.comp_l1_ratio
    for start in range(0, k, PLAIN_BLOCK):
        ob = order[start:start + PLAIN_BLOCK]
        C_rows = C[ob]
        C_inner = C_rows[:, ob]
        D_blk = D_subset[ob]
        R_blk = grad_subset[ob] - C_rows @ D_subset
        for j in range(ob.shape[0]):
            oj = ob[j:j + 1]      # a tensor index: no host read-back
            cjj = C_inner[j, j]
            Dj = D_blk[j].clone()
            budget = comp_norm[oj][0] + enet_norm(Dj, l1)
            Rj = R_blk[j] + cjj * Dj
            good = cjj > 1e-20
            Dj_new = torch.where(
                good, Rj / torch.where(good, cjj, torch.ones_like(cjj)), Dj)
            if cfg.comp_pos:
                Dj_new = torch.clamp(Dj_new, min=0.0)
            Dj_new = enet_projection(Dj_new, budget, l1)
            comp_norm[oj] = budget - enet_norm(Dj_new, l1)
            R_blk -= torch.outer(C_inner[:, j], Dj_new - Dj)
            D_blk[j] = Dj_new
        D_subset[ob] = D_blk
    return D_subset, comp_norm


def _bcd_blocks(D_subset, grad_subset, C, comp_norm, order, comp_pos,
                l1_ratio):
    """Kernel block driver for dictionaries wider than one kernel call:
    per block of the visit order the out-of-block residual contributions
    are subtracted from the gradient with one product, and the kernel
    updates the block's rows (already in visit order). Overwrites the
    rows of ``D_subset``; returns ``(D_subset, comp_norm')``."""
    k, s = D_subset.shape
    block = bcd.max_block(s, D_subset.dtype)
    if block == 0:
        raise ValueError(f'no BCD kernel block fits a subset of width {s}')
    kw = dict(comp_pos=comp_pos, l1_ratio=l1_ratio)
    comp_norm = comp_norm.clone()
    for start in range(0, k, block):
        ob = order[start:start + block]
        C_rows = C[ob]
        # index_fill_ takes the 0 as a kernel argument: an indexed
        # assignment of a Python number copies it from host memory
        out_mask = torch.ones(k, dtype=C.dtype, device=C.device)
        out_mask.index_fill_(0, ob.to(torch.int64), 0.0)
        G_blk = grad_subset[ob] - (C_rows * out_mask[None, :]) @ D_subset
        D_blk, cn_blk = bcd.bcd_update(
            D_subset[ob], G_blk, C_rows[:, ob].contiguous(), comp_norm[ob],
            None, **kw)
        comp_norm[ob] = cn_blk
        D_subset[ob] = D_blk
    return D_subset, comp_norm


def bcd_kernel(D_subset, grad_subset, C, comp_norm, order, comp_pos,
               l1_ratio):
    """The BCD kernel on a (k, s) dictionary: one call where its plan
    takes the shape, else the block driver (which raises where no block
    fits). Returns ``(D', comp_norm')``; may overwrite ``D_subset``."""
    k, s = D_subset.shape
    if bcd.supported(k, s, D_subset.dtype):
        return bcd.bcd_update(D_subset, grad_subset.contiguous(), C,
                              comp_norm, order=order, comp_pos=comp_pos,
                              l1_ratio=l1_ratio)
    return _bcd_blocks(D_subset, grad_subset, C, comp_norm, order,
                       comp_pos, l1_ratio)


def _update_dict(D, G, comp_norm, C, grad_subset, subset, w_step, order,
                 cfg, n_features, ctx, n_valid=None):
    """Block coordinate descent on the subset columns (dict_fact.py:650-715
    of the reference). Writes the new columns into ``D``, the new
    ``comp_norm`` into its tensor and, under ``G_agg='full'``, the new
    Gram into ``G``, all in place. ``w_step`` is the 0-d ``w *
    step_size`` of the ``sgd`` optimizer.

    On a mesh the (k, s) block is reassembled whole on every rank, which
    updates it alike (the BCD kernel launched by every rank) and writes
    back the columns of its shard.

    ``n_valid`` (rand_size): columns >= n_valid are zero-masked; zero is a
    fixed point of the update, and the masked columns are restored
    before the write-back."""
    s = _width(cfg, subset)
    dtype = D.dtype
    D_cols = ctx.cols(D, subset, s, cfg)
    if isinstance(subset, int) and not ctx.split_cols:  # a view: copy it
        D_cols = D_cols.clone(memory_format=torch.contiguous_format)
    if n_valid is not None:
        validf = _valid_mask(s, n_valid, dtype, D.device)[None, :]
        D_subset = D_cols * validf
        grad_subset = grad_subset * validf
    else:
        D_subset = D_cols
    incremental_G = cfg.G_agg == 'full' and s < n_features / 2.0
    if incremental_G:
        G_new = G - D_subset @ D_subset.T
    cn = comp_norm.clone()

    if cfg.optimizer == 'variational' and cfg.use_kernel:
        D_subset, cn = bcd_kernel(D_subset, grad_subset, C, cn, order,
                                  cfg.comp_pos, cfg.comp_l1_ratio)
    elif cfg.optimizer == 'variational':
        D_subset, cn = _bcd_plain(D_subset, grad_subset, C, cn, order, cfg)
    else:  # 'sgd': projected gradient step on the surrogate
        R = grad_subset - C @ D_subset
        budgets = cn + enet_norm(D_subset, cfg.comp_l1_ratio, axis=1)
        D_new = D_subset + w_step * R
        if cfg.comp_pos:
            D_new = torch.clamp(D_new, min=0.0)
        D_subset = enet_projection_batch(D_new, budgets, cfg.comp_l1_ratio)
        cn = budgets - enet_norm(D_subset, cfg.comp_l1_ratio, axis=1)

    if incremental_G:
        G_new = G_new + D_subset @ D_subset.T
    if n_valid is not None:
        D_subset = torch.where(validf > 0, D_subset, D_cols)
    ctx.write_cols(D, subset, D_subset, cfg)
    if cfg.G_agg == 'full' and not incremental_G:
        G_new = D @ D.T
        if cfg.windowed:
            Dm = D[:, ctx.col(cfg.n_features):]
            G_new = G_new - Dm @ Dm.T
        G_new = ctx.sum_feat(G_new)
    if cfg.G_agg == 'full':
        G.copy_(G_new)
    comp_norm.copy_(cn)


# the step's scalars, in the state's dtype: the batch weight w, the decay
# 1 - w, w / b, the Binomial size n_valid (0 without one), the sgd step
# w * step_size and pi, the product of the decays since the step's
# deferred-B segment began (this step's included)
N_SCALARS = 6
PI = 5


def step_scalars(state: SomfState, cfg: SomfConfig, b, n_valid, pi=1.0):
    """Advance the sample counter by a batch of ``b`` and return the
    step's scalars (``N_SCALARS``) as a numpy array of the state's dtype.
    The weight is numpy in that dtype (``batch_weight``); ``w / b`` and
    ``w * step_size`` are taken in double and rounded to it, as the
    kernels' cast of a Python float rounded them; ``pi`` is the previous
    step's decay product in the segment (1 at its first step) times
    this step's decay, rounded to the dtype."""
    np_dtype = _np_dtype(state.D.dtype)
    state.n_iter += b
    w = batch_weight(state.n_iter, b, cfg.learning_rate, 0.0, np_dtype)
    decay = np_dtype.type(1.0) - w
    return np.array([w, decay, float(w) / b,
                     0 if n_valid is None else n_valid,
                     float(w) * cfg.step_size,
                     np_dtype.type(pi) * decay], np_dtype)


def epoch_scalars(state: SomfState, cfg: SomfConfig, b, sizes):
    """The (T, N_SCALARS) scalars of an epoch of ``len(sizes)`` steps
    (:func:`step_scalars` in turn), ``pi`` restarting at each deferred-B
    segment of :func:`_deferred_seg`."""
    seg = _deferred_seg(cfg, len(sizes))
    rows = []
    for t, n_valid in enumerate(sizes):
        pi = rows[-1][PI] if seg >= 2 and t % seg else 1.0
        rows.append(step_scalars(state, cfg, b, n_valid, pi))
    return np.stack(rows)


@precise
def _step_body(state: SomfState, X, sample_indices, subset, order,
               scalars, cfg: SomfConfig, sized, deferred=None):
    """The step's device work: every value that changes from step to step
    is a tensor (``subset`` or a window's start, ``order``, the
    ``scalars`` of :func:`step_scalars`; a mesh keeps its window start a
    host int, and a host start slices), and every state leaf is written
    in place. ``sized``: the subset's columns from ``n_valid`` on are
    masked. ``deferred`` = ``(B0, Xseg, SC, trow)`` (windowed fused
    epochs, :func:`_scan_body`): B's full-width EMA is not applied; the
    segment's scaled code buffer SC (this rank's rows, updated in place)
    advances instead, and the gradient window is ``pi B0[:, win] + SC^T
    Xseg[:, win]`` with the step's ``pi``."""
    w, decay, w_b, n_valid, w_step, pi = scalars.unbind()
    n_valid = n_valid if sized else None
    b = sample_indices.shape[0]
    ctx = _context(state, cfg, sample_indices)
    n_features = cfg.n_features if cfg.windowed else ctx.n_stored
    width = cfg.len_max if cfg.rand_size else cfg.len_subset
    if cfg.windowed and torch.is_tensor(subset):
        # the window's columns, gathered wherever the step reads them
        subset = subset + torch.arange(width, device=subset.device)

    # --- step weights ---
    ctx.visit(state.sample_n_iter)
    w_sample = sample_weight(ctx.read([state.sample_n_iter])[0],
                             cfg.sample_learning_rate, state.D.dtype)

    # --- code: this rank's rows, then the whole batch's ---
    code_rows = _solve_code(state, X, ctx, w_sample, subset, cfg,
                            n_valid=n_valid)
    code_batch = ctx.batch(code_rows)
    if state.code is not None:
        ctx.write(state.code, code_batch)

    # --- surrogate statistics ---
    CtC = code_batch.T @ code_batch
    if cfg.optimizer == 'variational':
        state.C.mul_(decay).add_(w * CtC / b)
        if deferred is None:
            # one rounding of w / b times the product, as add_(alpha=)
            state.B.mul_(decay).addcmul_(ctx.sum_rows(code_rows.T @ X), w_b)
        else:
            B0, Xseg, SC, trow = deferred
            m = code_rows.shape[0]
            SC.mul_(decay)
            SC[trow * m:(trow + 1) * m] = w_b * code_rows
    else:
        state.C.copy_(CtC / b)
        state.B.copy_(ctx.sum_rows(code_rows.T @ X) / b)

    # --- dictionary update on the subset columns ---
    if deferred is None or cfg.optimizer != 'variational':
        grad_subset = ctx.cols(state.B, subset, width, cfg)
    else:
        grad_subset = ctx.window_grad(B0, SC, Xseg, subset, width, pi, cfg)
    _update_dict(state.D, state.G, state.comp_norm, state.C, grad_subset,
                 subset, w_step, order, cfg, n_features, ctx,
                 n_valid=n_valid)
    return state


def _device_scalars(host, device):
    """A step's scalars on ``device``: a non-blocking copy from pinned
    memory on CUDA."""
    scalars = torch.from_numpy(host)
    if device.type == 'cuda':
        return scalars.pin_memory().to(device, non_blocking=True)
    return scalars


def somf_step_inner(state: SomfState, X, sample_indices, subset, order,
                    cfg: SomfConfig, n_valid=None):
    """The step given a drawn subset (a window start, as a host int or a
    0-d device tensor, or an index tensor on the device), Binomial size
    ``n_valid`` (a host int) and atom ``order``: :func:`step_scalars`,
    then the step body. Updates ``state`` in place and returns it; the
    sampler fields are untouched. A host window start slices, a device
    one gathers.

    On a mesh (``cfg.mesh``; ``state`` sharded) ``X`` is this rank's
    block of the batch (``parallel.mesh.shard_batch``) and
    ``sample_indices`` the whole batch's global sample indices."""
    host = step_scalars(state, cfg, sample_indices.shape[0], n_valid)
    return _step_body(state, X, sample_indices, subset, order,
                      _device_scalars(host, state.D.device), cfg,
                      n_valid is not None)


class DrawLayout:
    """Where a step's draws lie in one byte buffer: the subset's
    ``width`` int64 indices (one for a ``window`` start, 0 for none;
    the batch's rows for a recsys batch), the ``n_scalars`` scalars in
    ``dtype`` (``N_SCALARS`` for a SOMF step) and the (k,) int32 order,
    each at an offset its type aligns to; ``nbytes`` is a multiple of 8,
    so that an epoch's steps lie one after another (step t at ``t *
    nbytes``)."""

    def __init__(self, width, k, dtype, window=False, n_scalars=N_SCALARS):
        self.width, self.dtype, self.window = width, dtype, window
        self.n_scalars = n_scalars
        self.itemsize = torch.empty((), dtype=dtype).element_size()
        self.scalars_at = 8 * width
        self.order_at = (self.scalars_at
                         + -(-n_scalars * self.itemsize // 8) * 8)
        self.order_end = self.order_at + 4 * k
        self.nbytes = -(-self.order_end // 8) * 8

    @classmethod
    def of(cls, cfg: SomfConfig, dtype):
        if cfg.windowed:
            return cls(1, cfg.n_components, dtype, window=True)
        return cls(cfg.len_max if cfg.rand_size else cfg.len_subset,
                   cfg.n_components, dtype)

    def fill(self, buf, subset, order, scalars):
        """Write a step's draws into ``buf`` (a uint8 numpy array); the
        subset and order are CPU tensors or numpy arrays."""
        if self.window:
            buf[:8].view(np.int64)[0] = subset
        elif self.width:
            buf[:self.scalars_at].view(np.int64)[:] = np.asarray(subset)
        buf[self.scalars_at:self.order_at].view(scalars.dtype)[
            :self.n_scalars] = scalars
        buf[self.order_at:self.order_end].view(np.int32)[:] = \
            np.asarray(order)

    def views(self, buf):
        """``(subset, order, scalars)`` views of a uint8 tensor of
        ``nbytes`` (``subset`` a 0-d start for a window, None for no
        subset)."""
        subset = (buf[:self.scalars_at].view(torch.int64) if self.width
                  else None)
        if self.window:
            subset = subset[0]
        scalars = buf[self.scalars_at:self.scalars_at
                      + self.n_scalars * self.itemsize].view(self.dtype)
        return subset, buf[self.order_at:self.order_end].view(torch.int32), \
            scalars


class DrawStaging:
    """The host draws' way to the device: two host slots (pinned on
    CUDA) used in turn. The draws of a step (or of an epoch's steps) are
    packed into one slot (:class:`DrawLayout`) and sent in one
    non-blocking copy, after which an event is recorded for the slot; a
    slot is rewritten only once that event has passed, so a copy in
    flight never sees its source change. The host waits for the card
    only there, when it is two sends ahead of it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == 'cuda'
        self.slots = [None, None]
        self.events = [None, None]
        self.turn = 0

    def send(self, layout, subset, order, scalars, out=None):
        """Stage a step's draws; returns their ``(subset, order,
        scalars)`` on the device, as views of ``out`` (a uint8 device
        tensor of ``layout.nbytes``) or of a new tensor."""
        return self.send_steps(layout, [(subset, order, scalars)], out)[0]

    def send_steps(self, layout, steps, out=None):
        """Stage the draws ``(subset, order, scalars)`` of several steps
        in one copy; returns each step's views of ``out`` (a uint8 device
        tensor of ``len(steps) * layout.nbytes``) or of a new tensor."""
        i = self.turn
        self.turn = 1 - i
        if self.events[i] is not None:
            with span('modl.stage.wait'):
                self.events[i].synchronize()
        nbytes = len(steps) * layout.nbytes
        slot = self.slots[i]
        if slot is None or slot.shape[0] < nbytes:
            slot = self.slots[i] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=self.pinned)
        slot = slot[:nbytes]
        host = slot.numpy()
        for t, (subset, order, scalars) in enumerate(steps):
            layout.fill(host[t * layout.nbytes:], subset, order, scalars)
        if out is None:
            out = slot.to(self.device, non_blocking=True, copy=True)
        else:
            out.copy_(slot, non_blocking=True)
        if self.pinned:
            if self.events[i] is None:
                self.events[i] = torch.cuda.Event()
            self.events[i].record()
        return [layout.views(out[t * layout.nbytes:(t + 1) * layout.nbytes])
                for t in range(len(steps))]


def draw_step(state: SomfState, cfg: SomfConfig):
    """Draw one step's subset, Binomial size and atom order on the host
    generator, advancing the sampler state. Returns ``(subset, n_valid,
    order)``: a window start (int) or CPU index tensor, an int or None,
    and a CPU (k,) order."""
    if cfg.windowed:
        if cfg.rand_size:
            subset, n_valid, state.cursor = draw_window_sized(
                state.cursor, state.gen, cfg.len_subset, cfg.len_max,
                cfg.n_features, cfg.replacement)
        else:
            subset, state.cursor = draw_window(
                state.cursor, state.gen, cfg.len_subset, cfg.n_features,
                cfg.replacement)
            n_valid = None
    elif cfg.rand_size:
        subset, n_valid, state.box, state.cursor = draw_subset_sized(
            state.box, state.cursor, state.gen, cfg.len_subset,
            cfg.len_max, cfg.replacement)
    else:
        subset, state.box, state.cursor = draw_subset(
            state.box, state.cursor, state.gen, cfg.len_subset,
            cfg.replacement)
        n_valid = None
    order = torch.randperm(cfg.n_components, generator=state.gen)
    return subset, n_valid, order


def draw_epoch(state: SomfState, cfg: SomfConfig, n_batches):
    """``n_batches`` steps' draws, in the order ``somf_step`` makes them."""
    draws = [draw_step(state, cfg) for _ in range(n_batches)]
    return Draws(subsets=[d[0] for d in draws], sizes=[d[1] for d in draws],
                 orders=torch.stack([d[2] for d in draws]))


def _host_start(cfg):
    """Whether the step takes a window start as a host int: windowed
    subsets on a mesh, whose steps run eagerly (``_Sharded``)."""
    return cfg.windowed and cfg.mesh is not None


def somf_step(state: SomfState, X, sample_indices, cfg: SomfConfig,
              staging=None):
    """One minibatch update: host draws and scalars, sent to the device
    through ``staging`` (a :class:`DrawStaging`, kept across steps by the
    caller; a new one otherwise), then the step body."""
    subset, n_valid, order = draw_step(state, cfg)
    host = step_scalars(state, cfg, sample_indices.shape[0], n_valid)
    if staging is None:
        staging = DrawStaging(state.D.device)
    sent, order, scalars = staging.send(DrawLayout.of(cfg, state.D.dtype),
                                        subset, order, host)
    return _step_body(state, X, sample_indices,
                      subset if _host_start(cfg) else sent, order, scalars,
                      cfg, n_valid is not None)


def _deferred_seg(cfg, n_batches):
    """Deferred-B segment length in batches (0 = off): T is capped where
    the per-step window correction (~T b k width MACs) stays below ~2/3
    of the amortised full-width EMA (b k n MACs), and at 16."""
    if not (cfg.windowed and cfg.optimizer == 'variational'):
        return 0
    width = cfg.len_max if cfg.rand_size else cfg.len_subset
    seg = (2 * cfg.n_features) // (3 * max(width, 1))
    return int(max(0, min(seg, 16, n_batches)))


def stage_epoch(state: SomfState, cfg: SomfConfig, b, draws: Draws,
                staging):
    """An epoch's scalars (:func:`epoch_scalars`, at batch size ``b``)
    and draws sent to the device in one copy through ``staging``.
    Returns each step's ``(subset, order, scalars)``, the window starts
    kept host ints on a mesh."""
    scalars = epoch_scalars(state, cfg, b, draws.sizes)
    steps = staging.send_steps(
        DrawLayout.of(cfg, state.D.dtype),
        list(zip(draws.subsets, draws.orders, scalars)))
    if _host_start(cfg):
        steps = [(start,) + step[1:]
                 for start, step in zip(draws.subsets, steps)]
    return steps


@precise
def _scan_body(state: SomfState, X_batches, idx_batches, cfg: SomfConfig,
               steps):
    """The epoch's device work over stacked minibatches, given each
    step's ``(subset, order, scalars)`` on the device
    (:func:`stage_epoch`): the step bodies in turn or, for windowed
    variational configurations, deferred-B segments, each ended by one
    full-width ``B <- pi B + SC^T Xseg`` in place with the segment's
    last ``pi``. Every value that changes from epoch to epoch is read
    from those tensors, so ``_program.ScanProgram`` captures this."""
    T = len(steps)
    seg = _deferred_seg(cfg, T)
    if seg < 2:
        for t in range(T):
            _step_body(state, X_batches[t], idx_batches[t], *steps[t], cfg,
                       cfg.rand_size)
        return state
    ctx = _context(state, cfg, idx_batches[0])
    m = X_batches.shape[1]          # this rank's rows of a batch
    kernel = cfg.use_kernel and ema_gemm.supported(
        cfg.n_components, state.B.shape[1], seg * m, state.B.dtype)
    for pos in range(0, T, seg):
        L = min(seg, T - pos)
        Xseg = X_batches[pos:pos + L].reshape(L * m, -1)
        SC = torch.zeros((L * m, cfg.n_components), dtype=state.D.dtype,
                         device=state.D.device)
        for trow in range(L):
            t = pos + trow
            _step_body(state, X_batches[t], idx_batches[t], *steps[t], cfg,
                       cfg.rand_size, deferred=(state.B, Xseg, SC, trow))
        # one full-width pass materialises the segment's B, in place: the
        # EMA-GEMM kernel where its gate allows (on by default), else its
        # plain version; on a mesh each rank's column slab, summed over dp
        ctx.segment_end(state.B, SC, Xseg, steps[pos + L - 1][2][PI],
                        kernel)
    return state


def somf_scan(state: SomfState, X_batches, idx_batches, cfg: SomfConfig,
              draws: Draws, staging=None):
    """Fused epoch over stacked minibatches with the given host draws,
    run eagerly: :func:`stage_epoch` (through ``staging``, a new
    :class:`DrawStaging` by default), then :func:`_scan_body`.

    X_batches (T, b, n_stored) and idx_batches (T, b) on the device (on
    a mesh, this rank's block of X_batches, ``parallel.mesh.
    shard_batches``, and the whole of idx_batches). Windowed variational
    configs run deferred-B segments: the same math as T calls of the
    step, with B's full-width EMA applied once per segment (in place)
    instead of once per batch."""
    if staging is None:
        staging = DrawStaging(state.D.device)
    steps = stage_epoch(state, cfg, idx_batches.shape[1], draws, staging)
    return _scan_body(state, X_batches, idx_batches, cfg, steps)


def offload_supported(device):
    """Whether ``average_offload`` runs on ``device``: CUDA (``G_avg`` in
    pinned host RAM) or the CPU (plain host memory; the same segmented
    code runs)."""
    return torch.device(device).type in ('cuda', 'cpu')


def host_zeros(shape, dtype, device):
    """Zeros in host memory, pinned when the learner is on CUDA (the
    offloaded ``G_avg``; never staged through a device tensor)."""
    return torch.zeros(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == 'cuda')


def offload_scan(state: SomfState, X_batches, idx_batches, cfg: SomfConfig,
                 draws: Draws, staging):
    """One segment of an ``average_offload`` epoch (the JAX package's
    ``_offload_scan_body``): ``G_avg`` lives in host RAM and only the
    segment's rows visit the device.

    The rows the segment's sample indices ``idx_batches`` (T, b; CPU)
    touch are gathered once: ``G_avg``'s from host RAM into the pinned
    ``staging`` buffer (at least as many rows) and on to the device, the
    device-resident per-sample leaves by row. The T steps then run on
    segment-local indices with an inner configuration that has
    ``average_offload`` off (per-step B EMA, no deferred segments, as the
    reference steps ``somf_step``), and the rows are scattered back at
    the segment's end. Repeated indices map to one local row, so the
    segment sees what the resident state would.

    All copies run on the current stream: the gather into ``staging``
    finishes on the host before its copy to the device is queued, and the
    scatter into ``G_avg`` waits for the copy back, so neither ``G_avg``
    nor ``staging`` changes while a copy is in flight."""
    device = state.D.device
    T = X_batches.shape[0]
    rows, local = torch.unique(idx_batches.reshape(-1), return_inverse=True)
    rows_dev = rows.to(device)
    local = local.reshape(idx_batches.shape).to(device)
    buf = staging[:rows.shape[0]]
    torch.index_select(state.G_avg, 0, rows, out=buf)

    def gather(leaf):
        return None if leaf is None else leaf[rows_dev]

    seg = dataclasses.replace(
        state, G_avg=buf.to(device, non_blocking=True),
        Dx_avg=gather(state.Dx_avg), code=gather(state.code),
        sample_n_iter=state.sample_n_iter[rows_dev])
    inner = dataclasses.replace(cfg, average_offload=False)
    # the draws in one copy; the steps as somf_step takes them (B's EMA
    # every step: the scalars' pi goes unread)
    steps = stage_epoch(seg, inner, idx_batches.shape[1], draws,
                        DrawStaging(device))
    for t in range(T):
        _step_body(seg, X_batches[t], local[t], *steps[t], inner,
                   inner.rand_size)
    buf.copy_(seg.G_avg, non_blocking=True)
    if device.type == 'cuda':
        torch.cuda.current_stream(device).synchronize()
    state.G_avg.index_copy_(0, rows, buf)
    for name in ('Dx_avg', 'code', 'sample_n_iter'):
        leaf = getattr(state, name)
        if leaf is not None:
            leaf[rows_dev] = getattr(seg, name)
    for name in ('D', 'B', 'C', 'G', 'comp_norm', 'n_iter'):
        setattr(state, name, getattr(seg, name))
    return state


# the leaves of the JAX package's SomfState that hold floats
_FLOAT_LEAVES = ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg', 'G_avg')


def state_to_numpy(state: SomfState):
    """Host copy of a state under the JAX package's field names and
    dtypes, so that either package loads what the other saved.

    ``gen_state`` (uint8) holds the port's generator, so that a port-saved
    state resumes bit for bit; ``key`` is a valid threefry key (uint32[2])
    derived from it, with which the JAX package resumes on its own
    trajectory. A sharded state is gathered whole first (a collective:
    every rank calls this)."""
    state = pmesh.unshard_state(state)
    out = {name: (None if getattr(state, name) is None
                  else getattr(state, name).detach().cpu().numpy())
           for name in _FLOAT_LEAVES}
    gen_state = state.gen.get_state().numpy()
    out.update(
        n_iter=np.asarray(state.n_iter, np.int32),
        sample_n_iter=state.sample_n_iter.cpu().numpy().astype(np.int32),
        box=state.box.numpy().astype(np.int32),
        cursor=np.asarray(state.cursor, np.int32),
        key=np.array([0, zlib.crc32(gen_state.tobytes())], np.uint32),
        gen_state=gen_state)
    return out


def seed_from_key(key):
    """A generator seed from a JAX threefry key (uint32[2])."""
    hi, lo = (int(w) for w in np.asarray(key, np.uint32))
    return hi << 32 | lo


def state_from_numpy(arrays, device, dtype, seed=None):
    """A :class:`SomfState` from host arrays under the JAX package's
    field names (:func:`state_to_numpy`, or a JAX state on the host).

    Float leaves go to ``device`` in ``dtype`` (a torch dtype), but
    ``G_avg`` stays in host RAM (pinned when ``device`` is CUDA): the
    estimator's next ``partial_fit`` places it where its configuration
    keeps it. ``box`` stays on the host.
    The generator takes ``gen_state`` where there is one, else it is
    seeded with ``seed`` (default: :func:`seed_from_key` of ``key``)."""
    def leaf(name):
        v = arrays.get(name)
        if v is None:
            return None
        v = torch.as_tensor(np.array(v))
        if name == 'G_avg':
            return host_zeros(v.shape, dtype, device).copy_(v)
        return v.to(device, dtype)

    gen = torch.Generator()
    if arrays.get('gen_state') is not None:
        gen.set_state(torch.as_tensor(np.array(arrays['gen_state'],
                                               np.uint8)))
    else:
        gen.manual_seed(seed_from_key(arrays['key']) if seed is None
                        else int(seed))
    return SomfState(
        **{name: leaf(name) for name in _FLOAT_LEAVES},
        n_iter=int(arrays['n_iter']),
        sample_n_iter=torch.as_tensor(
            np.array(arrays['sample_n_iter'], np.int64)).to(device),
        box=torch.as_tensor(np.array(arrays['box'], np.int64)),
        cursor=int(arrays['cursor']), gen=gen)


@precise
def compute_code(D, G, X, code_l1_ratio, code_alpha, code_pos, tol,
                 max_iter, solver='cd'):
    """Codes for data rows X on dictionary D (``G`` None: D D^T)."""
    if G is None:
        G = D @ D.T
    Dx = X @ D.T
    return enet_regression_single_gram(
        torch.ones_like(Dx), G, Dx, X, code_l1_ratio, code_alpha, code_pos,
        tol, max_iter, solver=solver)


@precise
def objective_value(D, G, X, code_l1_ratio, code_alpha, code_pos, tol,
                    max_iter, solver='cd'):
    """Penalised reconstruction objective per row (a 0-d tensor)."""
    code = compute_code(D, G, X, code_l1_ratio, code_alpha, code_pos, tol,
                        max_iter, solver=solver)
    loss = torch.sum((X - code @ D) ** 2) / 2.0
    regul = code_alpha * (torch.sum(torch.abs(code)) * code_l1_ratio
                          + (1.0 - code_l1_ratio)
                          * torch.sum(code ** 2) / 2.0)
    return (loss + regul) / X.shape[0]
