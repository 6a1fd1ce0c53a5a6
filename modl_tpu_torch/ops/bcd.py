"""Block coordinate descent on the dictionary: the Hopper kernel's wrapper
and its plain PyTorch version.

Counterpart of ``modl_tpu/ops/bcd_pallas.py``. Both functions compute,
sequentially over the atoms j of ``order`` (row order when ``None``):

    R_j    = grad_j - sum_i C[j, i] D_cur[i] + C[j, j] D_j
    D_j'   = R_j / C[j, j]            (kept as D_j when C[j, j] <= 1e-20)
    D_j'   = max(D_j', 0)             (``comp_pos``)
    D_j'   = projection of D_j' on the enet ball of radius
             budget_j = comp_norm_j + enet_norm(D_j)
    comp_norm_j' = budget_j - enet_norm(D_j')

``grad`` is the surrogate gradient B[:, subset] with any out-of-block
contributions already subtracted (the delayed-update contract of the
JAX kernel): R = grad - C @ D is formed inside.

The projection is the one of ``bcd_pallas._project_rows``, not the exact
sort: the l2 ball by a closed-form scale, the l1 ball by 6 steps of
bracketed Newton plus a feasibility scale, the general elastic-net ball
by 30 bisection steps. The l1 bracket's lower bound divides by the
row's element count *including* the Pallas wrapper's padding (the fold
pad to a multiple of 8 once s >= 2048); ``_l1_count`` reproduces that
count so the port lands on the Pallas result to f32 roundoff rather
than ~1e-2 off on deep-shrinkage rows.

``bcd_update`` runs the plain version for CPU tensors only; for CUDA
tensors it launches ``csrc/bcd_update.cu`` or raises. ``LAUNCHES`` counts
kernel launches.
"""
import ctypes
import functools

import torch

from . import _build
from .enet import enet_norm

__all__ = ["bcd_update", "bcd_update_reference", "supported", "max_block",
           "LAUNCHES"]

# kernel launches made by ``bcd_update`` (read by chip_smoke.py)
LAUNCHES = 0

NEWTON_ITERS = 6    # bracketed-Newton steps of the l1-ball threshold
PROJ_ITERS = 30     # bisection steps of the elastic-net-ball threshold

# rows per kernel call: the same cap as the JAX block driver
MAX_ROWS = 256
# dynamic shared memory one block may opt into on sm_90 (227 KB)
SMEM_BYTES = 232448
# the kernel's block size and warps (must match csrc/bcd_update.cu)
THREADS = 256
_NWARPS = THREADS // 32
# narrowest column slab worth a block of its own
MIN_COLS = 32
# multiprocessors of an H100 SXM: the slab plan's block count when no
# card is visible (so CPU runs take the same block decisions as the GPU)
H100_SMS = 132
_TINY = 1e-30


def _sm_count():
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).multi_processor_count
    return H100_SMS


def _plan(k, s):
    """Column-slab plan: (blocks, slab width, dynamic smem bytes).

    One block per multiprocessor (fewer for narrow rows); each owns a
    contiguous slab of ``w`` columns and keeps its D and residual slabs,
    one working row and the k budgets in shared memory."""
    grid = max(1, min(_sm_count(), -(-s // MIN_COLS)))
    w = -(-s // grid)
    grid = -(-s // w)
    smem = 4 * (2 * k * w + w + k + 2 * _NWARPS + 2)
    return grid, w, smem


def supported(k, s, dtype):
    """Whether one kernel call takes a (k, s) block of this dtype."""
    return (dtype == torch.float32 and 1 <= k <= MAX_ROWS and s >= 1
            and _plan(k, s)[2] <= SMEM_BYTES)


def max_block(s, dtype):
    """Most rows one kernel call takes at width s (0: none)."""
    if dtype != torch.float32:
        return 0
    for k in range(MAX_ROWS, 0, -1):
        if supported(k, s, dtype):
            return k
    return 0


def _l1_count(s):
    """Element count the Pallas l1 bracket divides by: the row width
    padded to a multiple of 8 once it is folded (s >= 2048)."""
    return -(-s // 8) * 8 if s >= 2048 else s


def _project_row(v, radius, l1_ratio, count):
    """Enet-ball projection of one row with the kernel's iteration
    counts (``bcd_pallas._project_rows``); ``radius`` a 0-d tensor."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    tiny = torch.tensor(_TINY, dtype=v.dtype, device=v.device)
    if l1_ratio == 0.0:
        norm2 = torch.sum(v * v)
        scale = torch.where(norm2 <= radius, torch.ones_like(norm2),
                            torch.sqrt(norm2 / torch.maximum(radius, tiny)))
        return torch.where(radius > 0, v / scale, zero)

    if l1_ratio == 1.0:
        b = torch.abs(v)
        norm = torch.sum(b)
        lo = torch.clamp((norm - radius) / count, min=0.0)
        hi0 = torch.max(b)

        def eval_g(lam):
            t = b - lam
            pos = (t > 0).to(v.dtype)
            return torch.sum(t * pos), torch.clamp(torch.sum(pos), min=1.0)

        glo, nlo = eval_g(lo)
        hi = torch.minimum(torch.maximum(
            lo + (glo - radius) * (hi0 - lo) / torch.maximum(glo, tiny),
            lo), hi0)
        for _ in range(NEWTON_ITERS):
            newton = lo + (glo - radius) / nlo
            t = torch.minimum(torch.maximum(
                torch.maximum(newton, 0.5 * (lo + hi)), lo), hi)
            g, n = eval_g(t)
            left = g >= radius
            sec = lo + (glo - radius) * (t - lo) / torch.maximum(glo - g,
                                                                 tiny)
            lo, glo, nlo, hi = (torch.where(left, t, lo),
                                torch.where(left, g, glo),
                                torch.where(left, n, nlo),
                                torch.where(left, hi, torch.minimum(t, sec)))
        lam = torch.clamp(lo + (glo - radius) / nlo, min=0.0)
        w = torch.clamp(b - lam, min=0.0)
        norm_w = torch.sum(w)
        scale = torch.where(norm_w > radius,
                            radius / torch.maximum(norm_w, tiny),
                            torch.ones_like(norm_w))
        out = torch.where(norm <= radius, v, torch.sign(v) * w * scale)
        return torch.where(radius > 0, out, zero)

    gamma = 2.0 / l1_ratio - 2.0
    r = radius / l1_ratio
    b = torch.abs(v)
    norm = torch.sum(b * (1.0 + gamma / 2.0 * b))
    lo, hi = zero, torch.max(b)
    for _ in range(PROJ_ITERS):
        mid = 0.5 * (lo + hi)
        w = torch.clamp(b - mid, min=0.0) / (1.0 + mid * gamma)
        too_big = torch.sum(w * (1.0 + gamma / 2.0 * w)) > r
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    lam = 0.5 * (lo + hi)
    shrunk = torch.sign(v) * torch.clamp(b - lam, min=0.0) \
        / (1.0 + lam * gamma)
    out = torch.where(norm <= r, v, shrunk)
    return torch.where(radius > 0, out, zero)


def bcd_update_reference(D, grad, C, comp_norm, order=None, comp_pos=False,
                         l1_ratio=0.0):
    """Plain PyTorch version of the kernel: a sequential loop over atoms
    on the explicit residual ``R = grad - C @ D`` (right-looking: each
    updated row's delta is folded into R at once). Returns
    ``(D', comp_norm')``; the inputs are left untouched."""
    k, s = D.shape
    count = _l1_count(s)
    D = D.clone()
    R = grad - C @ D
    cn = comp_norm.clone()
    budgets = comp_norm + enet_norm(D, l1_ratio, axis=1)
    visit = range(k) if order is None else order.tolist()
    for j in visit:
        cjj = C[j, j]
        good = cjj > 1e-20
        inv = 1.0 / torch.where(good, cjj, torch.ones_like(cjj))
        Dj = D[j].clone()
        v = torch.where(good, (R[j] + cjj * Dj) * inv, Dj)
        if comp_pos:
            v = torch.clamp(v, min=0.0)
        v = _project_row(v, budgets[j], l1_ratio, count)
        cn[j] = budgets[j] - enet_norm(v, l1_ratio)
        R -= torch.outer(C[:, j], v - Dj)
        D[j] = v
    return D, cn


@functools.cache
def _kernel():
    return _build.entry('modl_bcd_update_f32',
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                        + [ctypes.c_float] * 3
                        + [ctypes.c_int, ctypes.c_void_p])


def bcd_update(D, grad, C, comp_norm, order=None, comp_pos=False,
               l1_ratio=0.0):
    """Sequential BCD over the atoms of ``order``; returns
    ``(D', comp_norm')`` as new tensors.

    D, grad (k, s) f32; C (k, k) f32; comp_norm (k,) f32; order (k,)
    integer or None (row order). CPU tensors run
    :func:`bcd_update_reference`; CUDA tensors launch the Hopper kernel
    on the current stream (no synchronisation) and raise on anything it
    does not take."""
    global LAUNCHES
    if D.device.type == 'cpu':
        return bcd_update_reference(D, grad, C, comp_norm, order=order,
                                    comp_pos=comp_pos, l1_ratio=l1_ratio)
    if D.device.type != 'cuda':
        raise ValueError('bcd_update: tensors must be on CPU or CUDA, got '
                         f'{D.device}')
    k, s = D.shape
    ops = {'D': D, 'grad': grad, 'C': C, 'comp_norm': comp_norm}
    shapes = {'D': (k, s), 'grad': (k, s), 'C': (k, k), 'comp_norm': (k,)}
    for name, t in ops.items():
        if t.device != D.device or t.dtype != torch.float32:
            raise ValueError(f'bcd_update: {name} must be float32 on '
                             f'{D.device}, got {t.dtype} on {t.device}')
        if tuple(t.shape) != shapes[name] or not t.is_contiguous():
            raise ValueError(f'bcd_update: {name} must be a contiguous '
                             f'{shapes[name]} tensor, got {tuple(t.shape)}')
    if not supported(k, s, D.dtype):
        raise ValueError(f'bcd_update: a ({k}, {s}) block exceeds the '
                         'kernel\'s shared-memory plan; split it into '
                         f'blocks of at most {max_block(s, D.dtype)} rows')
    if order is not None:
        if order.shape != (k,) or order.device != D.device:
            raise ValueError('bcd_update: order must be a (k,) tensor on '
                             f'{D.device}')
        order = order.to(torch.int32).contiguous()
    grid, w, _ = _plan(k, s)
    mode = 0 if l1_ratio == 0.0 else 1 if l1_ratio == 1.0 else 2
    gamma = 2.0 / l1_ratio - 2.0 if mode == 2 else 0.0
    D_out = torch.empty_like(D)
    cn_out = torch.empty_like(comp_norm)
    scratch = torch.empty((4 + 2 * k) * grid, dtype=torch.float32,
                          device=D.device)
    err = _kernel()(
        D.data_ptr(), D_out.data_ptr(), grad.data_ptr(), C.data_ptr(),
        comp_norm.data_ptr(), cn_out.data_ptr(),
        order.data_ptr() if order is not None else None,
        scratch.data_ptr(),
        k, s, w, grid, _l1_count(s), mode,
        float(l1_ratio), gamma, gamma / 2.0, int(bool(comp_pos)),
        torch.cuda.current_stream(D.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'bcd_update: kernel launch failed with '
                           f'cudaError {err} at (k={k}, s={s}, grid={grid})')
    LAUNCHES += 1
    return D_out, cn_out
