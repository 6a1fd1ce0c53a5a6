"""FISTA on the Gram formulation: the Hopper kernel's wrapper and its plain
PyTorch version.

Counterpart of ``modl_tpu/ops/solvers.py::fista_gram``, a
``lax.while_loop`` that never leaves the device. Both functions solve,
independently for each row i of the batch,

    min_w 1/2 w^T Q_i w - q_i^T w + l1_reg ||w||_1 + l2_reg/2 ||w||_2^2

by accelerated proximal gradient from ``w = z = prox(w0)``: step 1/L with
L the top eigenvalue of Q (16 power iterations from a ones vector) plus
l2_reg, with a 1% margin; each iteration

    grad = Q z - q + l2_reg z
    w'   = prox(z - grad / L)       (soft threshold at l1_reg / L, then
                                     a clamp at 0 when ``positive``)
    t'   = (1 + sqrt(1 + 4 t^2)) / 2
    z    = w' + ((t - 1) / t') (w' - w)

After every 5th iteration the duality gap of every row is computed, and
the solve stops when every row's gap is below ``tol * y_norm2``, or at
``max_iter``. Converged rows keep iterating until the whole batch stops.
``t`` and the momentum factor are Python floats (double), applied to the
rows' dtype.

``fista_gram`` runs the plain version for CPU tensors only; for CUDA
tensors it launches ``csrc/fista_gram.cu`` or raises. Without ``agree``
the whole solve is one launch and reads nothing back. Where the batch's
rows are split over ranks, ``agree`` sums a 0-d count of unconverged
rows over them: the solve then runs one check (5 iterations) a call,
carrying ``w``, ``z``, ``t`` and the iteration count from call to call,
and reads the agreed count once a call (on the CPU the same driver calls
the plain iterations). ``LAUNCHES`` counts kernel launches;
``last_iterations`` reads the iterations the last launch ended at.

The kernel is a persistent cooperative grid: each block owns tiles of
rows. A shared Q with k <= 128 (``REG_K``) is held in registers, a
thread a column of Q and its elements of 1, 2 or 4 rows, which keep
their ``w``, ``z`` and ``q`` in registers too: each product reads only
the rows' ``z`` from shared memory, and an iteration ends at one block
barrier. Otherwise a tile of up to 8 rows keeps its ``w``, ``z`` and
``q`` in shared memory, with Q too where it fits (a shared Q up to about
k = 225; per-row Grams up to k = 238, as many rows a tile as fit), else
Q is read through L2. At each check every block adds its arrival and
its count of unconverged rows to the check's 64-bit slot in one atomic
and waits until the slot holds every block's arrival; the count it then
reads is the batch's, alike in every block. The path, and whether
per-row Grams are staged, depend on k alone, and every path sums each
output in one order wherever the row lies, so a row's arithmetic
depends neither on the block that holds it nor on the batch's size:
ranks that solve part of a batch get the codes of the whole batch's
solve.
"""
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

__all__ = ["fista_gram", "fista_gram_reference", "supported",
           "last_iterations", "LAUNCHES"]

# kernel launches made by ``fista_gram`` (read by chip_smoke.py)
LAUNCHES = 0
# the scratch tensor of the last launch (its last int32: the iterations)
_last_scratch = None

CHECK_EVERY = 5     # iterations between duality-gap tests
POWER_ITERS = 16    # power iterations for the Lipschitz constant

# the kernel's warps a block
NWARPS = 8
# rows of a block's tile on the shared-memory and L2 paths (at most the
# kernel's warps: one warp a row)
MAX_TILE = 8
# a shared Q up to this k is held in registers (a column a thread)
REG_K = 128
# rows a thread on the register path, and the row sums of a check
ROWS_A_THREAD = (1, 2, 4)
_GAP_SUMS = 5
# the kernel's paths, as its entry point numbers them
PATHS = {'l2': 0, 'smem': 1, 'registers': 2}
# dynamic shared memory one block may opt into on sm_90 (227 KB)
SMEM_BYTES = 232448
# bytes of a tile's rows' 1/L and ||x||^2 and its two counters
_TILE_EXTRA_BYTES = 4 * (2 * MAX_TILE + 2)


def _soft_threshold(x, thresh):
    return torch.sign(x) * torch.clamp(torch.abs(x) - thresh, min=0.0)


def _duality_gap(w, H, q, y_norm2, l1_reg, l2_reg, positive):
    """Per-row duality gap of the elastic-net Gram problem
    (dict_fact_fast.pyx:388-426), with ``H = Q w``."""
    q_dot_w = torch.sum(w * q, dim=-1)
    XtA = q - H - l2_reg * w
    if positive:
        dual_norm = torch.max(XtA, dim=-1).values
    else:
        dual_norm = torch.max(torch.abs(XtA), dim=-1).values
    R_norm2 = y_norm2 + torch.sum(w * H, dim=-1) - 2.0 * q_dot_w
    over = dual_norm > l1_reg
    scaling = torch.where(
        over, l1_reg / torch.where(dual_norm != 0, dual_norm,
                                   torch.ones_like(dual_norm)),
        torch.ones_like(dual_norm))
    gap = torch.where(over, 0.5 * (R_norm2 + R_norm2 * scaling ** 2),
                      R_norm2)
    return gap + (l1_reg * torch.sum(torch.abs(w), dim=-1)
                  - scaling * y_norm2 + scaling * q_dot_w
                  + 0.5 * l2_reg * (1.0 + scaling ** 2)
                  * torch.sum(w * w, dim=-1))


def _next_t(t):
    return 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))


def _matvec(Q):
    if Q.ndim == 2:
        return lambda W: W @ Q
    return lambda W: torch.einsum('bij,bj->bi', Q, W)


def _inv_lipschitz(Q, q, l2_reg):
    """``1 / L`` as a (1, 1) (shared Q) or (b, 1) column."""
    matvec = _matvec(Q)
    b, k = q.shape
    v = torch.ones((1 if Q.ndim == 2 else b, k), dtype=q.dtype,
                   device=q.device)
    for _ in range(POWER_ITERS):
        v = matvec(v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    L = (torch.sum(v * matvec(v), dim=-1)
         / torch.clamp(torch.sum(v * v, dim=-1), min=1e-30))
    L = (torch.clamp(L, min=1e-12) + l2_reg) * 1.01
    return (1.0 / L)[:, None]


def _prox(z, l1_reg, inv_L, positive):
    out = _soft_threshold(z, l1_reg * inv_L)
    if positive:
        out = torch.clamp(out, min=0.0)
    return out


def _iterate(w, z, t, it, it_end, Q, q, y_norm2, inv_L, l1_reg, l2_reg,
             positive, tol, stop):
    """Iterations ``it + 1 .. it_end`` from ``(w, z, t)``; after each
    multiple of ``CHECK_EVERY`` the 0-d count of rows whose gap is not
    below ``tol * y_norm2`` goes to ``stop``, and the loop ends where it
    returns True. Returns ``(w, z)``."""
    matvec = _matvec(Q)
    gap_tol = tol * y_norm2
    while it < it_end:
        it += 1
        grad = matvec(z) - q + l2_reg * z
        w_new = _prox(z - grad * inv_L, l1_reg, inv_L, positive)
        t_new = _next_t(t)
        z = w_new + ((t - 1.0) / t_new) * (w_new - w)
        w, t = w_new, t_new
        if it % CHECK_EVERY == 0:
            gap = _duality_gap(w, matvec(w), q, y_norm2, l1_reg, l2_reg,
                               positive)
            if stop(torch.sum(~(gap < gap_tol))):
                break
    return w, z


def fista_gram_reference(w0, Q, q, y_norm2, l1_reg, l2_reg, positive,
                         max_iter, tol, agree=None):
    """Plain PyTorch version: the whole solve in one loop. ``Q`` is
    (k, k) shared or (b, k, k) per row, ``q`` and ``w0`` (b, k),
    ``y_norm2`` (b,). ``agree``, where given, sums each check's count
    of unconverged rows over the ranks that hold the batch's other rows,
    so that every rank stops where the whole batch would: the same
    iterations then run one check a call of :func:`_drive_checks`."""
    if agree is not None:
        run = _PlainChecks(w0, Q, q, y_norm2, l1_reg, l2_reg, positive,
                           tol)
        _drive_checks(run, max_iter, agree)
        return run.w
    inv_L = _inv_lipschitz(Q, q, l2_reg)
    w = _prox(w0, l1_reg, inv_L, positive)
    return _iterate(w, w, 1.0, 0, max_iter, Q, q, y_norm2, inv_L, l1_reg,
                    l2_reg, positive, tol, lambda left: int(left) == 0)[0]


def _drive_checks(run, max_iter, agree):
    """The solve one check at a time: ``run(it0, it_end, t0)`` runs the
    iterations ``it0 + 1 .. it_end`` from ``t = t0`` and returns the 0-d
    count of unconverged rows at ``it_end``'s check (None where no check
    falls); ``agree`` sums it over the ranks, and the solve stops where
    the sum is 0."""
    it, t = 0, 1.0
    while True:
        end = min(it + CHECK_EVERY, max_iter)
        left = run(it, end, t)
        for _ in range(it, end):
            t = _next_t(t)
        it = end
        if left is not None and int(agree(left)) == 0:
            return
        if it >= max_iter:
            return


class _PlainChecks:
    """``run`` of :func:`_drive_checks` on the plain iterations; the
    codes end in ``w``."""

    def __init__(self, w0, Q, q, y_norm2, l1_reg, l2_reg, positive, tol):
        self.args = Q, q, y_norm2
        self.params = l1_reg, l2_reg, positive, tol
        self.w0 = w0

    def __call__(self, it0, it_end, t0):
        Q, q, y_norm2 = self.args
        l1_reg, l2_reg, positive, tol = self.params
        if it0 == 0:
            self.inv_L = _inv_lipschitz(Q, q, l2_reg)
            self.w = self.z = _prox(self.w0, l1_reg, self.inv_L, positive)
        counts = []

        def keep(left):
            counts.append(left)
            return False

        self.w, self.z = _iterate(self.w, self.z, t0, it0, it_end, Q, q,
                                  y_norm2, self.inv_L, l1_reg, l2_reg,
                                  positive, tol, keep)
        return counts[0] if counts else None


def _q_bytes(k, rt, shared):
    """Shared memory of a staged Q: the shared (k, k) Q, or a tile's rows'
    Grams at a row stride of k + 1."""
    return 4 * k * k if shared else 4 * rt * k * (k + 1)


def _reg_smem(rt, k, rows_a_thread):
    """Shared memory of the register path: z twice and w for a tile's rows
    at k padded to whole warps, the row sums' slots, the block's count
    and its stop flag."""
    kp = 32 * -(-k // 32)
    return 4 * (3 * rt * kp + NWARPS * rows_a_thread * _GAP_SUMS + 2)


class Plan(NamedTuple):
    """A launch's shape: rows a tile, blocks, dynamic shared memory bytes,
    whether Q (or the tile's rows' Grams) is staged in shared memory,
    the kernel's path (``'registers'``, ``'smem'`` or ``'l2'``) and the
    rows of the product each thread sums."""
    rt: int
    grid: int
    smem: int
    q_smem: bool
    path: str
    rows_a_thread: int


def _plan(b, k, shared, sms):
    """The :class:`Plan` of a solve on a card of ``sms`` multiprocessors.

    A shared Q with k <= ``REG_K`` takes the register path, whatever the
    batch: a row takes ceil(k / 32) warps, so a pass holds 8 // that
    many rows, and a tile as many passes (rows a thread: 1, 2 or 4) as
    spread the batch over one block a multiprocessor; where 4 do not,
    the tiles loop over the blocks.

    Otherwise a tile's z, w, q and Q z take 16 k bytes a row in shared
    memory, beside its rows' 1/L and ||x||^2 and two counters. Rows
    spread over one block a multiprocessor, up to ``MAX_TILE`` a tile. A
    shared Q is staged beside them where it fits; one that does not is
    read through L2 by tiles of ``MAX_TILE`` rows, which share each read
    (both products sum in the same order). Per-row Grams are staged
    where one row's fits, whatever the batch's size (the staged and the
    device-memory products sum in different orders), with as many rows a
    tile as fit."""
    per_block = max(1, -(-b // sms))
    if shared and k <= REG_K:
        per_pass = NWARPS // -(-k // 32)
        r = next((r for r in ROWS_A_THREAD if per_pass * r >= per_block),
                 ROWS_A_THREAD[-1])
        rt = per_pass * r
        return Plan(rt, max(1, min(-(-b // rt), sms)), _reg_smem(rt, k, r),
                    False, 'registers', r)
    rt = min(MAX_TILE, per_block)
    row = 16 * k
    if shared:
        q_smem = (_q_bytes(k, 1, True) + rt * row + _TILE_EXTRA_BYTES
                  <= SMEM_BYTES)
        if not q_smem:
            rt = MAX_TILE
    else:
        gram = _q_bytes(k, 1, False)
        q_smem = gram + row + _TILE_EXTRA_BYTES <= SMEM_BYTES
        if q_smem:
            rt = min(rt, (SMEM_BYTES - _TILE_EXTRA_BYTES) // (gram + row))
    rt = max(1, min(rt, (SMEM_BYTES - _TILE_EXTRA_BYTES) // row))
    grid = max(1, min(-(-b // rt), sms))
    smem = (rt * row + _TILE_EXTRA_BYTES
            + (_q_bytes(k, rt, shared) if q_smem else 0))
    # a warp owns 32 columns of a shared Q's product for a group of rows;
    # of a per-row Gram's, outputs of one row
    nc = -(-k // 32)
    groups = max(1, min(rt, NWARPS // nc))
    return Plan(rt, grid, smem, q_smem, 'smem' if q_smem else 'l2',
                -(-rt // groups) if shared else 1)


def supported(k):
    """Whether the kernel takes rows of k coefficients."""
    return 1 <= k and 16 * k + _TILE_EXTRA_BYTES <= SMEM_BYTES


@functools.cache
def _kernel():
    return _build.entry('modl_fista_gram_f32',
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                        + [ctypes.c_float] * 4
                        + [ctypes.c_int] * 3 + [ctypes.c_double]
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def last_iterations():
    """Iterations the last kernel launch ended at, read from its scratch
    once it has run (synchronises); None before any launch."""
    if _last_scratch is None:
        return None
    return int(_last_scratch[-1:].view(torch.int32).item())


class _KernelChecks:
    """Launches of the kernel on one solve's state: ``w`` (the codes)
    and a scratch of z, 1/L, from the next 8-byte boundary the checks'
    64-bit slots (2^32 a block that reached the check plus the
    unconverged rows) and the iteration count."""

    def __init__(self, w0, Q, q, y_norm2, l1_reg, l2_reg, positive,
                 max_iter, tol):
        b, k = q.shape
        self.ops = w0, Q, q, y_norm2
        self.params = (float(l1_reg), float(l2_reg), float(0.5 * l2_reg),
                       float(tol), int(bool(positive)))
        sms = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        self.plan = _plan(b, k, Q.ndim == 2, sms)
        self.n_checks = max_iter // CHECK_EVERY
        self.w = torch.empty_like(q)
        slots = (b * k + b + 1) // 2 * 2
        self.scratch = torch.empty(slots + 2 * self.n_checks + 1,
                                   dtype=torch.float32, device=q.device)
        self.scratch[b * k + b:].zero_()
        # each slot's low 32 bits: the count
        self.counts = self.scratch[slots:-1].view(torch.int32)[0::2]

    def __call__(self, it0, it_end, t0, sync=False):
        global LAUNCHES, _last_scratch
        w0, Q, q, y_norm2 = self.ops
        b, k = q.shape
        if b:
            plan = self.plan
            err = _kernel()(
                w0.data_ptr(), Q.data_ptr(), q.data_ptr(),
                y_norm2.data_ptr(), self.w.data_ptr(),
                self.scratch.data_ptr(), b, k, int(Q.ndim == 2), plan.rt,
                plan.grid, plan.smem, PATHS[plan.path], *self.params, it0,
                it_end, float(t0), int(sync), self.n_checks,
                torch.cuda.current_stream(q.device).cuda_stream)
            if err != 0:
                raise RuntimeError(
                    f'fista_gram: kernel launch failed with cudaError '
                    f'{err} at (b={b}, k={k}, grid={plan.grid}, '
                    f'path={plan.path})')
            LAUNCHES += 1
            _last_scratch = self.scratch
        if sync or it_end == it0 or it_end % CHECK_EVERY:
            return None
        return self.counts[it_end // CHECK_EVERY - 1].to(torch.int64)


def _check_operands(w0, Q, q, y_norm2):
    if q.ndim != 2 or not supported(q.shape[1]):
        k_max = (SMEM_BYTES - _TILE_EXTRA_BYTES) // 16
        raise ValueError(f'fista_gram: q must be a (b, k) tensor with '
                         f'1 <= k <= {k_max}, got {tuple(q.shape)}')
    b, k = q.shape
    shapes = {'w0': (b, k), 'Q': (k, k) if Q.ndim == 2 else (b, k, k),
              'q': (b, k), 'y_norm2': (b,)}
    for name, t in zip(shapes, (w0, Q, q, y_norm2)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f'fista_gram: {name} must be float32 on '
                             f'{q.device}, got {t.dtype} on {t.device}')
        if tuple(t.shape) != shapes[name] or not t.is_contiguous():
            raise ValueError(f'fista_gram: {name} must be a contiguous '
                             f'{shapes[name]} tensor, got '
                             f'{tuple(t.shape)}')


def fista_gram(w0, Q, q, y_norm2, l1_reg, l2_reg, positive, max_iter, tol,
               agree=None):
    """Batched FISTA on the Gram formulation; returns the codes (b, k) as
    a new tensor.

    w0, q (b, k); Q (k, k) shared or (b, k, k) per row; y_norm2 (b,).
    CPU tensors run :func:`fista_gram_reference` (with ``agree``: the
    same iterations one check a call). CUDA tensors must be contiguous
    float32: the kernel runs on the current stream, in one launch
    without ``agree`` (no synchronisation), else in one launch a check
    with one read of the agreed count."""
    if q.device.type == 'cpu':
        return fista_gram_reference(w0, Q, q, y_norm2, l1_reg, l2_reg,
                                    positive, max_iter, tol, agree)
    if q.device.type != 'cuda':
        raise ValueError('fista_gram: tensors must be on CPU or CUDA, got '
                         f'{q.device}')
    _check_operands(w0, Q, q, y_norm2)
    run = _KernelChecks(w0, Q, q, y_norm2, l1_reg, l2_reg, positive,
                        max_iter, tol)
    if agree is None:
        run(0, max_iter, 1.0, sync=True)
    else:
        _drive_checks(run, max_iter, agree)
    return run.w
