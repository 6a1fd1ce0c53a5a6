"""modl_tpu_torch.ops.fista on the CPU: the plain version against
modl_tpu's ``fista_gram`` (a ``lax.while_loop``), the check-at-a-time
driver that runs a batch split over ranks, and what the CUDA wrapper
plans and refuses (the kernel itself runs in ``chip_smoke.py`` phase
fista), and a numpy emulation of the order in which the kernel's
register path (a shared Q with k <= 128) sums.

Both packages run the same iterations, power iteration and gap test in
the same order, so the codes agree to roundoff: 1e-12 at float64 (the
readings are ~1e-16) and 1e-6 of max |w| at float32 (modl_tpu carries t
in float32, the port as a Python float; ~6e-8).
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modl_tpu.ops import solvers as jsolvers
from modl_tpu_torch.ops import fista, solvers
from torch_parity import to_np

T = torch.as_tensor
L1 = 0.5


def _problem(seed, shared, dtype=np.float64, b=12, k=6, n=30):
    """(w0, Q, q, y_norm2): a shared Gram, or per-row Grams of random
    halves of the features scaled by 2 (as the masked step's estimates)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(b, n)
    D = rng.randn(k, n)
    if shared:
        Q = D @ D.T
    else:
        masks = rng.rand(b, 1, n) < 0.5
        Dm = D[None] * masks
        Q = 2.0 * Dm @ Dm.transpose(0, 2, 1)
    return [a.astype(dtype) for a in (np.zeros((b, k)), Q, X @ D.T,
                                      np.sum(X * X, axis=1))]


def _counting():
    calls = []

    def agree(left):
        calls.append(int(left))
        return left
    return agree, calls


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('tol', [0.0, 1e-6])
@pytest.mark.parametrize('l2_reg', [0.0, 0.2])
@pytest.mark.parametrize('positive', [False, True])
@pytest.mark.parametrize('shared', [True, False])
def test_reference_matches_jax(shared, positive, l2_reg, tol, dtype):
    """tol 0 runs to max_iter; tol 1e-6 stops at a check before it, at
    the same iteration in both packages (else the codes would differ by
    more than roundoff)."""
    args = _problem(0, shared, dtype)
    params = (L1, l2_reg, positive, 300, tol)
    agree, calls = _counting()
    got = to_np(fista.fista_gram_reference(*map(T, args), *params,
                                           agree=agree))
    want = np.asarray(jsolvers.fista_gram(*map(jnp.asarray, args),
                                          *params))
    assert got.dtype == want.dtype == np.dtype(dtype)
    if tol == 0.0:
        assert len(calls) == 300 // fista.CHECK_EVERY
    else:
        assert calls[-1] == 0 and len(calls) < 300 // fista.CHECK_EVERY
    atol = 1e-12 if dtype == np.float64 else 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize('tol', [0.0, 1e-6])
@pytest.mark.parametrize('positive', [False, True])
@pytest.mark.parametrize('shared', [True, False])
def test_check_driver_equals_one_shot(shared, positive, tol):
    """With ``agree`` the solve runs one check a call, carrying w, z, t
    and the iteration count: bit for bit the one-loop solve, with one
    agreed count a check."""
    args = list(map(T, _problem(1, shared)))
    params = (L1, 0.1, positive, 300, tol)
    one_shot = fista.fista_gram_reference(*args, *params)
    agree, calls = _counting()
    got = fista.fista_gram(*args, *params, agree=agree)
    assert torch.equal(got, one_shot)
    agree_ref, calls_ref = _counting()
    fista.fista_gram_reference(*args, *params, agree=agree_ref)
    assert calls == calls_ref
    assert fista.fista_gram(*args, *params) is not one_shot
    assert torch.equal(fista.fista_gram(*args, *params), one_shot)


@pytest.mark.parametrize('max_iter', [0, 3, 7])
def test_check_driver_off_the_check_grid(max_iter):
    """max_iter 0 returns prox(w0); a max_iter that is not a multiple of
    5 runs its tail with no check, as the one-loop solve does."""
    args = list(map(T, _problem(2, True)))
    args[0] = torch.ones_like(args[0])
    params = (L1, 0.1, True, max_iter, 0.0)
    agree, calls = _counting()
    got = fista.fista_gram(*args, *params, agree=agree)
    assert torch.equal(got, fista.fista_gram_reference(*args, *params))
    assert len(calls) == max_iter // fista.CHECK_EVERY


@pytest.mark.parametrize('shared', [True, False])
def test_split_batch_stops_where_the_whole_batch_does(shared):
    """Two ranks (threads) each solve half of the batch and sum their
    counts through ``agree``: every rank runs until the whole batch has
    converged, so the halves are the whole batch's codes."""
    w0, Q, q, y2 = map(T, _problem(3, shared))
    params = (L1, 0.0, False, 2000, 1e-8)
    whole = fista.fista_gram_reference(w0, Q, q, y2, *params)
    halves = [slice(0, 5), slice(5, 12)]
    counts = [None, None]
    meet = threading.Barrier(2)
    out = [None, None]

    def rank(r):
        rows = halves[r]

        def agree(left):
            counts[r] = left
            meet.wait()
            total = counts[0] + counts[1]
            meet.wait()
            return total

        out[r] = fista.fista_gram(w0[rows], Q if shared else Q[rows],
                                  q[rows], y2[rows], *params, agree=agree)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    np.testing.assert_allclose(to_np(torch.cat(out)), to_np(whole),
                               rtol=0, atol=1e-12)
    # alone, one of the halves would have stopped earlier
    checks = []
    for rows in halves:
        agree, calls = _counting()
        fista.fista_gram_reference(w0[rows], Q if shared else Q[rows],
                                   q[rows], y2[rows], *params, agree=agree)
        checks.append(len(calls))
    agree, calls = _counting()
    fista.fista_gram_reference(w0, Q, q, y2, *params, agree=agree)
    assert min(checks) < len(calls)


def test_solvers_dispatch_to_the_wrapper():
    assert solvers.fista_gram is fista.fista_gram
    args = list(map(T, _problem(4, True)))
    X = torch.ones(12, 30, dtype=torch.float64)
    got = solvers.enet_regression_single_gram(args[0], args[1], args[2], X,
                                              0.5, 0.2, False, 1e-4, 50,
                                              solver='fista')
    want = fista.fista_gram_reference(args[0], args[1], args[2],
                                      torch.sum(X * X, dim=-1), 0.1, 0.1,
                                      False, 1000, 1e-4)
    assert torch.equal(got, want)


SMS = 132   # multiprocessors of an H100 SXM


@pytest.mark.parametrize('b,k,shared,rt,path,rows_a_thread', [
    (200, 128, True, 2, 'registers', 1),   # the image fit: over 100 blocks
    (200, 128, False, 2, 'smem', 1),       # per-row Grams, two a block
    (200, 200, False, 1, 'smem', 1),       # per-row Grams, one a tile
    (200, 256, False, 2, 'l2', 1),         # per-row Grams from device memory
    (1200, 128, False, 3, 'smem', 1),      # as many per-row Grams as fit
    (100, 70, True, 2, 'registers', 1),    # three warps a row, two a block
    (200, 1024, True, 8, 'l2', 8),         # Q through L2, tiles of 8 rows
    (500, 128, True, 4, 'registers', 2),
    (2000, 128, True, 8, 'registers', 4),  # the image score: 250 tiles
    (20_000, 128, True, 8, 'registers', 4),  # transform: 19 tiles a block
    (3, 5, True, 8, 'registers', 1)])      # a warp a row, 8 a pass
def test_plan(b, k, shared, rt, path, rows_a_thread):
    plan = fista._plan(b, k, shared, SMS)
    assert (plan.rt, plan.path, plan.rows_a_thread) == (rt, path,
                                                        rows_a_thread)
    assert plan.q_smem == (path == 'smem')
    assert plan.grid == min(-(-b // rt), SMS)
    assert plan.smem <= fista.SMEM_BYTES
    if path == 'registers':
        kp = 32 * -(-k // 32)
        assert plan.smem == 4 * (3 * rt * kp + 5 * 8 * rows_a_thread + 2)
    else:
        q_bytes = 4 * k * k if shared else 4 * rt * k * (k + 1)
        assert plan.smem == 16 * rt * k + fista._TILE_EXTRA_BYTES + (
            q_bytes if plan.q_smem else 0)


@pytest.mark.parametrize('k', [1, 5, 32, 33, 64, 70, 96, 128, 129, 200])
def test_plan_picks_the_register_path_by_k_alone(k):
    """The register path sums in another order than the shared-memory and
    L2 products, so a shared Q takes it by k alone, whatever the batch:
    half a batch (a rank's rows) runs the whole batch's arithmetic. A row
    takes ceil(k / 32) warps of 8, and a tile 1, 2 or 4 such passes."""
    plans = [fista._plan(b, k, True, SMS)
             for b in (1, 50, 100, 132, 200, 264, 500, 2000, 20_000)]
    paths = {plan.path for plan in plans}
    if k > fista.REG_K:
        assert 'registers' not in paths
        return
    assert paths == {'registers'}
    per_pass = 8 // -(-k // 32)
    for plan in plans:
        assert plan.rows_a_thread in fista.ROWS_A_THREAD
        assert plan.rt == per_pass * plan.rows_a_thread


@pytest.mark.parametrize('k', [128, 169, 200, 238, 239, 256])
def test_plan_stages_per_row_grams_by_k_alone(k):
    """The staged per-row product sums each output in another order than
    the one from device memory, so whether the Grams are staged depends
    on k alone: half a batch (a rank's rows) runs the whole batch's
    arithmetic."""
    staged = {fista._plan(b, k, False, SMS)[3]
              for b in (1, 100, 132, 200, 264, 1200, 20_000)}
    assert staged == {k <= 238}


def test_plan_takes_the_widest_rows():
    k = (fista.SMEM_BYTES - fista._TILE_EXTRA_BYTES) // 16
    assert fista.supported(k) and not fista.supported(k + 1)
    assert fista._plan(200, k, True, SMS)[0] == 1
    assert fista._plan(200, k, True, SMS)[2] <= fista.SMEM_BYTES


def _f32(*shape):
    return torch.ones(*shape, dtype=torch.float32)


@pytest.mark.parametrize('case', ['float64', 'strided', 'Q shape',
                                  'y_norm2 shape', 'k too wide'])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    b, k = 4, 3
    ops = dict(w0=_f32(b, k), Q=_f32(k, k), q=_f32(b, k), y_norm2=_f32(b))
    if case == 'float64':
        ops['Q'] = ops['Q'].double()
    elif case == 'strided':
        ops['q'] = _f32(k, b).T
    elif case == 'Q shape':
        ops['Q'] = _f32(b + 1, k, k)
    elif case == 'y_norm2 shape':
        ops['y_norm2'] = _f32(b + 1)
    else:
        k = fista.SMEM_BYTES
        ops = dict(w0=_f32(1, k), Q=_f32(1, 1), q=_f32(1, k),
                   y_norm2=_f32(1))
    with pytest.raises(ValueError, match='fista_gram'):
        fista._check_operands(*ops.values())
    fista._check_operands(_f32(b, 3), _f32(b, 3, 3), _f32(b, 3), _f32(b))


def test_wrapper_takes_only_cpu_or_cuda():
    ops = [torch.ones(2, 3, device='meta'), torch.ones(3, 3, device='meta'),
           torch.ones(2, 3, device='meta'), torch.ones(2, device='meta')]
    with pytest.raises(ValueError, match='CPU or CUDA'):
        fista.fista_gram(*ops, 0.1, 0.0, False, 10, 1e-3)


# -- the register path's order of sums, emulated in numpy float32 --------

f32 = np.float32


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64;
    the sum's two roundings match one but for rare ties)."""
    return (a.astype(np.float64) * b + c).astype(f32)


def _row_sum(x, op=np.add):
    """The kernel's sum over a row's threads, x (..., kp): a butterfly in
    each warp of 32, then the warps' results in order."""
    total = None
    for c in range(x.shape[-1] // 32):
        a = x[..., 32 * c:32 * (c + 1)]
        while a.shape[-1] > 1:
            a = op(a[..., :a.shape[-1] // 2], a[..., a.shape[-1] // 2:])
        total = a[..., 0] if total is None else op(total, a[..., 0])
    return total


def _product(Z, Qp):
    """Z @ Qp as the register path sums each output: four interleaved FMA
    chains over i (i mod 4), added as (c0 + c1) + (c2 + c3)."""
    rows, kp = Z.shape
    acc = np.zeros((4, rows, kp), f32)
    Z4, Q4 = Z.reshape(rows, kp // 4, 4), Qp.reshape(kp // 4, 4, kp)
    for s in range(kp // 4):
        acc = _fma(Z4[:, s, :].T[:, :, None], Q4[s][:, None, :], acc)
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _prox(x, thr, positive):
    out = np.sign(x) * np.maximum(np.abs(x) - thr, f32(0))
    return np.maximum(out, f32(0)) if positive else out


def _emulate_registers(w0, Q, q, y2, l1, l2, positive, max_iter, tol):
    """The register path's solve of a shared Q (k <= 128) in float32, with
    the kernel's order of every sum and its roundings: Q z and Q w by
    :func:`_product`, the power iteration's and the gap's row sums by
    :func:`_row_sum`, t in double and the momentum factor as a float.
    Returns (codes, iterations)."""
    b, k = q.shape
    kp = 32 * -(-k // 32)

    def pad(a):
        return np.pad(a.astype(f32), [(0, 0)] * (a.ndim - 1)
                      + [(0, kp - a.shape[-1])])

    Qp = pad(np.pad(Q.astype(f32), [(0, kp - k), (0, 0)]))
    q, y2, l1, l2 = pad(q), y2.astype(f32), f32(l1), f32(l2)
    v = pad(np.ones((1, k), f32))
    for n in range(16):
        m = _product(v, Qp)
        d = np.maximum(np.sqrt(_row_sum(m * m)), f32(1e-30))
        v = m / d[:, None]
    m = _product(v, Qp)
    ratio = _row_sum(v * m) / np.maximum(_row_sum(v * v), f32(1e-30))
    inv_L = f32(1) / ((np.maximum(ratio, f32(1e-12)) + l2) * f32(1.01))
    thr = l1 * inv_L
    w = z = _prox(pad(w0), thr, positive)
    t, it = 1.0, 0
    valid = np.arange(kp) < k
    while it < max_iter:
        it += 1
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        f = f32((t - 1.0) / t_new)
        t = t_new
        g = (_product(z, Qp) - q) + l2 * z
        w_new = _prox(z - g * inv_L, thr, positive)
        z, w = w_new + f * (w_new - w), w_new
        if it % 5 == 0:
            H = _product(w, Qp)
            qdw, wH = _row_sum(w * q), _row_sum(w * H)
            l1n, ww = _row_sum(np.abs(w)), _row_sum(w * w)
            xta = (q - H) - l2 * w
            dn = _row_sum(np.where(valid, xta if positive else np.abs(xta),
                                   f32(-np.inf)), np.maximum)
            R = (y2 + wH) - f32(2) * qdw
            over = dn > l1
            sc = np.where(over, l1 / np.where(dn != 0, dn, f32(1)), f32(1))
            s2 = sc * sc
            gap = np.where(over, f32(0.5) * (R + R * s2), R)
            gap = gap + (((l1 * l1n - sc * y2) + sc * qdw)
                         + (f32(0.5) * l2 * (f32(1) + s2)) * ww)
            if not np.sum(~(gap < f32(tol) * y2)):
                break
    return w[:, :k], it


# codes at a fixed count: the emulation against the plain version and
# modl_tpu, relative to max |w| (float32 sums in another order carried
# through 100 iterations: the readings are 4e-8 to 1.0e-5, and the plain
# version and modl_tpu differ by up to 1.2e-5); chip_smoke.py's
# FISTA_RTOL holds the kernel to the same bound
EMULATION_RTOL = 3e-5


@pytest.mark.parametrize('positive', [False, True])
@pytest.mark.parametrize('k', [5, 70, 128])
def test_register_order_matches_the_plain_version_and_jax(k, positive):
    w0, Q, q, y2 = _problem(5, True, np.float32, b=12, k=k, n=40)
    params = (0.1, 0.05, positive, 100, 0.0)
    got, iters = _emulate_registers(w0, Q, q, y2, *params)
    assert iters == 100
    plain = to_np(fista.fista_gram_reference(*map(T, (w0, Q, q, y2)),
                                             *params))
    want = np.asarray(jsolvers.fista_gram(*map(jnp.asarray,
                                               (w0, Q, q, y2)), *params))
    scale = np.abs(want).max()
    assert scale > 0 and np.count_nonzero(want) < want.size
    np.testing.assert_allclose(got, plain, rtol=0,
                               atol=EMULATION_RTOL * scale)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=EMULATION_RTOL * scale)


@pytest.mark.parametrize('positive', [False, True])
@pytest.mark.parametrize('k', [5, 70, 128])
def test_register_order_stops_with_the_plain_version(k, positive):
    """At the solvers' tol the emulation stops at the plain version's
    check, or one check from it."""
    w0, Q, q, y2 = _problem(6, True, np.float32, b=12, k=k, n=40)
    params = (0.1, 0.05, positive, 2000, 1e-2)
    _, iters = _emulate_registers(w0, Q, q, y2, *params)
    agree, calls = _counting()
    fista.fista_gram_reference(*map(T, (w0, Q, q, y2)), *params,
                               agree=agree)
    assert abs(iters - fista.CHECK_EVERY * len(calls)) <= fista.CHECK_EVERY
    assert iters < 2000
