"""SOMF/OMF core in PyTorch: learner state, one step, and the fused epoch.

Counterpart of ``modl_tpu/decomposition/_step.py``. One step runs

    subset draw -> step weights -> code solve -> C/B statistics EMA ->
    block coordinate descent on the dictionary (subset columns only)

and ``somf_scan`` runs an epoch over device-resident minibatches with
B's full-width EMA deferred across segments. PyTorch runs eagerly, so the
state is a plain dataclass of tensors (it carries no gradients) updated
in place where JAX's immutability forced copies: the windowed D
write-back, the B EMA, the per-sample statistics and the deferred-B
buffers. Draws (window starts, Binomial sizes, atom orders) are made on
a host generator ahead of the step, and the batch weight is a host
float, so a step reads nothing back from the device.

Only each TPU switch's default branch is ported; the JAX package keeps
the alternatives. ``comp_pos`` clamps only the atom being updated, as
in the JAX package (its module docstring explains the deviation from
the reference).
"""
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


@dataclass(frozen=True)
class SomfConfig:
    """Static solver configuration (``modl_tpu`` ``SomfConfig`` without
    the mesh and host-offload fields; ``use_kernel`` is ``use_pallas``)."""
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


def _subset_cols(A, subset, width, cfg):
    """Columns of A addressed by a subset: the window ``[start, start +
    width)`` (a view; the mirror pad makes circular windows contiguous)
    or a gather at an index tensor (a copy)."""
    if cfg.windowed:
        return A[:, subset:subset + width]
    return A[:, subset]


def _valid_mask(width, n_valid, dtype, device):
    return (torch.arange(width, device=device) < n_valid).to(dtype)


def _solve_code(state, X, sample_indices, w_sample, subset, cfg,
                n_valid=None):
    """Codes of the batch under the Dx/G estimators (dict_fact.py:577-648
    of the reference). Updates ``Dx_avg``/``G_avg`` in place."""
    D = state.D
    width = _width(cfg, subset)
    if cfg.Dx_agg != 'full' or cfg.G_agg != 'full':
        D_subset = _subset_cols(D, subset, width, cfg)
        if n_valid is not None:
            D_subset = D_subset * _valid_mask(width, n_valid, D.dtype,
                                              D.device)[None, :]

    if cfg.Dx_agg == 'full':
        Dx = X @ D.T
        if cfg.windowed:
            # the mirror columns [n, n + w) duplicate the head columns
            n_log = cfg.n_features
            Dx = Dx - X[:, n_log:] @ D[:, n_log:].T
    else:
        X_subset = _subset_cols(X, subset, width, cfg)
        Dx = (X_subset @ D_subset.T) * cfg.reduction
        if cfg.Dx_agg == 'average':
            old = state.Dx_avg[sample_indices]
            # unvisited rows (exact zeros) take the new estimate whole
            unvisited = torch.sum(torch.abs(old), dim=-1) == 0
            w_eff = torch.where(unvisited, torch.ones_like(w_sample),
                                w_sample)
            Dx = old * (1.0 - w_eff[:, None]) + Dx * w_eff[:, None]
            state.Dx_avg[sample_indices] = Dx

    if cfg.G_agg == 'full':
        G = state.G
    else:
        G = (D_subset @ D_subset.T) * cfg.reduction
        if cfg.G_agg == 'average':
            old = state.G_avg[sample_indices]
            unvisited = torch.sum(torch.abs(old), dim=(-2, -1)) == 0
            w_eff = torch.where(unvisited, torch.ones_like(w_sample),
                                w_sample)
            G = (old * (1.0 - w_eff[:, None, None])
                 + G[None] * w_eff[:, None, None])
            state.G_avg[sample_indices] = G

    w0 = (state.code[sample_indices] if state.code is not None
          else torch.ones_like(Dx))
    # the solvers read X only through ||x_i||^2: drop the mirror columns
    X_solver = X[:, :cfg.n_features] if cfg.windowed else X
    solve = (enet_regression_multi_gram if cfg.G_agg == 'average'
             else enet_regression_single_gram)
    return solve(w0, G, Dx, X_solver, cfg.code_l1_ratio, cfg.code_alpha,
                 cfg.code_pos, cfg.tol, cfg.max_iter,
                 solver=cfg.code_solver)


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
        out_mask = torch.ones(k, dtype=C.dtype, device=C.device)
        out_mask[ob] = 0.0
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


def _writeback_window(D, D_subset, start, n_log):
    """In-place windowed write-back: write the window, fold a wrapped tail
    into the head, and refresh the mirror so D[:, n:] == D[:, :s]."""
    s = D_subset.shape[1]
    D[:, start:start + s] = D_subset
    wrapped = start + s - n_log
    if wrapped > 0:
        D[:, :wrapped] = D[:, n_log:n_log + wrapped]
    if start < s or wrapped > 0:
        D[:, n_log:n_log + s] = D[:, :s]


def _update_dict(D, G, comp_norm, C, grad_subset, subset, w, order, cfg,
                 n_features, n_valid=None):
    """Block coordinate descent on the subset columns (dict_fact.py:650-715
    of the reference). Writes the new columns into ``D`` in place and
    returns ``(G, comp_norm)``.

    ``n_valid`` (rand_size): columns >= n_valid are zero-masked; zero is a
    fixed point of the update, and the masked columns are restored
    before the write-back."""
    s = _width(cfg, subset)
    dtype = D.dtype
    D_cols = _subset_cols(D, subset, s, cfg)
    if cfg.windowed:            # a view of D: copy before D is written
        D_cols = D_cols.clone(memory_format=torch.contiguous_format)
    if n_valid is not None:
        validf = _valid_mask(s, n_valid, dtype, D.device)[None, :]
        D_subset = D_cols * validf
        grad_subset = grad_subset * validf
    else:
        D_subset = D_cols
    incremental_G = cfg.G_agg == 'full' and s < n_features / 2.0
    if incremental_G:
        G = G - D_subset @ D_subset.T
    comp_norm = comp_norm.clone()

    if cfg.optimizer == 'variational' and cfg.use_kernel:
        D_subset, comp_norm = bcd_kernel(D_subset, grad_subset, C,
                                         comp_norm, order, cfg.comp_pos,
                                         cfg.comp_l1_ratio)
    elif cfg.optimizer == 'variational':
        D_subset, comp_norm = _bcd_plain(D_subset, grad_subset, C,
                                         comp_norm, order, cfg)
    else:  # 'sgd': projected gradient step on the surrogate
        R = grad_subset - C @ D_subset
        budgets = comp_norm + enet_norm(D_subset, cfg.comp_l1_ratio, axis=1)
        D_new = D_subset + w * cfg.step_size * R
        if cfg.comp_pos:
            D_new = torch.clamp(D_new, min=0.0)
        D_subset = enet_projection_batch(D_new, budgets, cfg.comp_l1_ratio)
        comp_norm = budgets - enet_norm(D_subset, cfg.comp_l1_ratio, axis=1)

    if incremental_G:
        G = G + D_subset @ D_subset.T
    if n_valid is not None:
        D_subset = torch.where(validf > 0, D_subset, D_cols)
    if cfg.windowed:
        _writeback_window(D, D_subset, subset, cfg.n_features)
    else:
        D[:, subset] = D_subset
    if cfg.G_agg == 'full' and not incremental_G:
        G = D @ D.T
        if cfg.windowed:
            Dm = D[:, cfg.n_features:]
            G = G - Dm @ Dm.T
    return G, comp_norm


@precise
def somf_step_inner(state: SomfState, X, sample_indices, subset, order,
                    cfg: SomfConfig, n_valid=None, deferred=None):
    """The step body given a drawn subset (window start or index tensor on
    the device), Binomial size ``n_valid`` and atom ``order``. Updates
    ``state`` in place and returns it; the sampler fields are untouched.

    ``deferred`` = ``(B0, Xseg, SC, pi, trow)`` (windowed fused epochs):
    B's full-width EMA is not applied; the segment's scaled code buffer
    SC (updated in place) and decay product ``pi`` (host scalar) advance
    instead, and the gradient window is ``pi B0[:, win] + SC^T
    Xseg[:, win]``. Returns ``(state, SC, pi)`` then; ``somf_scan``
    materialises ``B = pi B0 + SC^T Xseg`` at the segment's end.
    """
    dtype = state.D.dtype
    np_dtype = _np_dtype(dtype)
    b = X.shape[0]
    n_features = cfg.n_features if cfg.windowed else state.D.shape[1]

    # --- step weights ---
    state.n_iter += b
    state.sample_n_iter.index_add_(
        0, sample_indices, torch.ones_like(sample_indices,
                                           dtype=state.sample_n_iter.dtype))
    w_sample = sample_weight(state.sample_n_iter[sample_indices],
                             cfg.sample_learning_rate, dtype)
    w_np = batch_weight(state.n_iter, b, cfg.learning_rate, 0.0, np_dtype)
    decay_np = np_dtype.type(1.0) - w_np
    w, decay = float(w_np), float(decay_np)

    # --- code ---
    code_batch = _solve_code(state, X, sample_indices, w_sample, subset,
                             cfg, n_valid=n_valid)
    if state.code is not None:
        state.code[sample_indices] = code_batch

    # --- surrogate statistics ---
    CtC = code_batch.T @ code_batch
    if cfg.optimizer == 'variational':
        state.C = state.C * decay + w * CtC / b
        if deferred is None:
            state.B.mul_(decay).add_(code_batch.T @ X, alpha=w / b)
        else:
            B0, Xseg, SC, pi, trow = deferred
            SC.mul_(decay)
            SC[trow * b:(trow + 1) * b] = (w / b) * code_batch
            pi = np_dtype.type(pi * decay_np)
    else:
        state.C = CtC / b
        state.B = (code_batch.T @ X) / b

    # --- dictionary update on the subset columns ---
    width = cfg.len_max if cfg.rand_size else cfg.len_subset
    if deferred is None or cfg.optimizer != 'variational':
        grad_subset = _subset_cols(state.B, subset, width, cfg)
    else:
        Xwin = _subset_cols(Xseg, subset, width, cfg)
        grad_subset = (float(pi) * _subset_cols(B0, subset, width, cfg)
                       + SC.T @ Xwin)
    state.G, state.comp_norm = _update_dict(
        state.D, state.G, state.comp_norm, state.C, grad_subset, subset, w,
        order, cfg, n_features, n_valid=n_valid)
    if deferred is None:
        return state
    return state, SC, pi


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


def _to_device(subset, device):
    return subset if isinstance(subset, int) else subset.to(device)


def somf_step(state: SomfState, X, sample_indices, cfg: SomfConfig):
    """One minibatch update: host draws, then :func:`somf_step_inner`."""
    subset, n_valid, order = draw_step(state, cfg)
    device = state.D.device
    return somf_step_inner(state, X, sample_indices,
                           _to_device(subset, device),
                           order.to(device, torch.int32), cfg,
                           n_valid=n_valid)


def _deferred_seg(cfg, n_batches):
    """Deferred-B segment length in batches (0 = off): T is capped where
    the per-step window correction (~T b k width MACs) stays below ~2/3
    of the amortised full-width EMA (b k n MACs), and at 16."""
    if not (cfg.windowed and cfg.optimizer == 'variational'):
        return 0
    width = cfg.len_max if cfg.rand_size else cfg.len_subset
    seg = (2 * cfg.n_features) // (3 * max(width, 1))
    return int(max(0, min(seg, 16, n_batches)))


@precise
def somf_scan(state: SomfState, X_batches, idx_batches, cfg: SomfConfig,
              draws: Draws):
    """Fused epoch over stacked minibatches with the given host draws.

    X_batches (T, b, n_stored) and idx_batches (T, b) on the device.
    Windowed variational configs run deferred-B segments: the same math
    as T calls of the step, with B's full-width EMA applied once per
    segment (in place) instead of once per batch."""
    T, b = X_batches.shape[0], X_batches.shape[1]
    device = state.D.device
    orders = draws.orders.to(device, torch.int32)
    subsets = [_to_device(sub, device) for sub in draws.subsets]
    seg = _deferred_seg(cfg, T)
    if seg < 2:
        for t in range(T):
            somf_step_inner(state, X_batches[t], idx_batches[t], subsets[t],
                            orders[t], cfg, n_valid=draws.sizes[t])
        return state
    np_dtype = _np_dtype(state.D.dtype)
    pos = 0
    while pos < T:
        L = min(seg, T - pos)
        Xseg = X_batches[pos:pos + L].reshape(L * b, -1)
        B0 = state.B
        SC = torch.zeros((L * b, cfg.n_components), dtype=state.D.dtype,
                         device=device)
        pi = np_dtype.type(1.0)
        for trow in range(L):
            t = pos + trow
            state, SC, pi = somf_step_inner(
                state, X_batches[t], idx_batches[t], subsets[t], orders[t],
                cfg, n_valid=draws.sizes[t],
                deferred=(B0, Xseg, SC, pi, trow))
        # one full-width pass materialises the segment's B, in place:
        # the EMA-GEMM kernel where its gate allows (off by default, as
        # in the JAX package), else one addmm_
        if cfg.use_kernel and ema_gemm.supported(
                cfg.n_components, state.B.shape[1], Xseg.shape[0],
                state.B.dtype):
            ema_gemm.ema_accumulate(state.B, SC, Xseg, pi)
        else:
            state.B.addmm_(SC.T, Xseg, beta=float(pi))
        pos += L
    return state


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
