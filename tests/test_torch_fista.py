"""modl_tpu_torch.ops.fista on the CPU: the plain version against
modl_tpu's ``fista_gram`` (a ``lax.while_loop``), the check-at-a-time
driver that runs a batch split over ranks, and what the CUDA wrapper
plans and refuses (the kernel itself runs in ``chip_smoke.py`` phase
fista).

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


@pytest.mark.parametrize('b,k,shared,rt,q_smem', [
    (200, 128, True, 2, True),       # the image fit: over 100 blocks
    (200, 128, False, 2, True),      # per-row Grams, two a block
    (200, 200, False, 1, True),      # per-row Grams, one a tile
    (200, 256, False, 2, False),     # per-row Grams from device memory
    (1200, 128, False, 3, True),     # as many per-row Grams as fit
    (100, 70, True, 1, True),
    (200, 1024, True, 8, False),     # Q through L2, tiles of 8 rows
    (500, 128, True, 4, True),
    (2000, 128, True, 8, True),      # the image score: 250 tiles
    (20_000, 128, True, 8, True),    # transform: 19 tiles a block
    (3, 5, True, 1, True)])
def test_plan(b, k, shared, rt, q_smem):
    got_rt, grid, smem, got_q = fista._plan(b, k, shared, SMS)
    assert (got_rt, got_q) == (rt, q_smem)
    assert grid == min(-(-b // rt), SMS)
    assert smem <= fista.SMEM_BYTES
    q_bytes = 4 * k * k if shared else 4 * rt * k * (k + 1)
    assert smem == 16 * rt * k + fista._TILE_EXTRA_BYTES + (
        q_bytes if q_smem else 0)


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
