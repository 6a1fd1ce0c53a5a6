"""The port's BCD update against the Pallas kernel it replaces.

``bcd_update_reference`` (what ``bcd_update`` runs for CPU tensors, and
the plain version the Hopper kernel is held against on the card) against
``modl_tpu.ops.bcd_pallas.bcd_update`` in interpret mode, float32 on both
sides (the Pallas kernel refuses float64), at the kernel test's
tolerance atol 2e-5 (tests/test_bcd_pallas.py). The CUDA kernel itself
has no CPU mode; chip_smoke.py compares it with this plain version on
the GPU. The kernel takes its sums in another order than the plain
version (per-slab partials, its thread and reduction tree, the
elastic-net probe's two sums), so a numpy emulation of that order is
held against both here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import modl_tpu.ops.bcd_pallas as bp
from modl_tpu_torch.ops import bcd
from torch_parity import to_np


@pytest.fixture(autouse=True)
def interpret_mode():
    old = bp.INTERPRET
    bp.INTERPRET = True
    yield
    bp.INTERPRET = old


def _case(k, s, seed, l1_normalised=False):
    rng = np.random.RandomState(seed)
    D = rng.randn(k, s).astype(np.float32)
    if l1_normalised:
        D /= np.abs(D).sum(axis=1, keepdims=True)
    else:
        D /= np.linalg.norm(D, axis=1, keepdims=True)
    C = (lambda A: (A @ A.T / k + np.eye(k)).astype(np.float32))(
        rng.randn(k, k))
    grad = (rng.randn(k, s) * 0.1).astype(np.float32)
    cn = np.zeros(k, np.float32)
    order = rng.permutation(k).astype(np.int32)
    return D, grad, C, cn, order


def _both(D, grad, C, cn, order, comp_pos, l1r):
    got = bcd.bcd_update(*map(torch.as_tensor, (D, grad, C, cn)),
                         order=torch.as_tensor(order).long(),
                         comp_pos=comp_pos, l1_ratio=l1r)
    want = bp.bcd_update(*map(jnp.asarray, (D, grad, C, cn)),
                         order=jnp.asarray(order), comp_pos=comp_pos,
                         l1_ratio=l1r)
    return [to_np(x) for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize('comp_pos', [False, True])
@pytest.mark.parametrize('l1r', [0.0, 1.0, 0.5])
def test_plain_bcd_matches_pallas_small(comp_pos, l1r):
    (Dg, cng), (Dw, cnw) = _both(*_case(8, 96, 0), comp_pos, l1r)
    np.testing.assert_allclose(Dg, Dw, atol=2e-5)
    np.testing.assert_allclose(cng, cnw, atol=2e-5)


@pytest.mark.parametrize('k,s', [(32, 80), (72, 2050)])
def test_plain_bcd_matches_pallas_l1(k, s):
    """Several panels (k > 8) and, at s=2050, the Pallas fold pad: the
    l1 bracket divides by the padded count 2056 (ops/bcd.py)."""
    (Dg, cng), (Dw, cnw) = _both(*_case(k, s, 1, l1_normalised=True),
                                 False, 1.0)
    np.testing.assert_allclose(Dg, Dw, atol=2e-5)
    np.testing.assert_allclose(cng, cnw, atol=2e-5)


def test_plain_bcd_matches_pallas_adversarial_rows():
    """tests/test_bcd_pallas.py's spiky geometric rows: the capped Newton
    is one-sided, so both keep every row inside its l1 ball."""
    rng = np.random.RandomState(3)
    k, s = 8, 256
    D = (rng.randn(k, s) * np.logspace(-6, 3, s)[None, :]).astype(
        np.float32)
    D[:, :4] *= 1e4
    C = np.eye(k, dtype=np.float32)
    grad = (D * 37.0).astype(np.float32)
    cn = np.zeros(k, np.float32)
    order = np.arange(k, dtype=np.int32)
    (Dg, cng), (Dw, cnw) = _both(D, grad, C, cn, order, False, 1.0)
    scale = np.abs(Dw).max()
    np.testing.assert_allclose(Dg, Dw, atol=2e-5 * scale)
    budgets = np.abs(D).sum(axis=1)
    assert np.all(np.abs(Dg).sum(axis=1) <= budgets * (1 + 1e-5))
    assert np.all(cng >= -1e-4 * budgets)
    np.testing.assert_allclose(cng, cnw, atol=1e-5 * budgets.max())


def test_l1_count_reproduces_the_fold_pad():
    assert bcd._l1_count(2047) == 2047
    assert bcd._l1_count(2050) == 2056
    assert bcd._l1_count(17655) == 17656


def test_slab_plan_and_row_cap():
    """One block per SM of an H100 (132), slabs of ceil(s / 132) columns;
    shared memory (227 KB) holds both slabs, the delta, the budgets and,
    where it fits beside them, the whole candidate row (staged); the row
    cap is what that allows, at most 256."""
    if torch.cuda.is_available():
        pytest.skip('the plan follows the visible card, not an H100')
    # 4 (2 k w + max(w, 64) + k + 2) bytes, plus 4 s4 for a staged row
    assert bcd._plan(70, 17655) == (132, 134, 146488, True)
    assert bcd._plan(256, 10780) == (132, 82, 212416, True)
    assert bcd._plan(8, 96) == (3, 32, 2728, True)
    k = bcd.max_block(200_000, torch.float32)
    assert 0 < k < 256
    assert bcd._plan(k, 200_000)[3] is False          # the row from L2
    assert bcd._plan(k, 200_000)[2] <= bcd.SMEM_BYTES
    assert bcd.supported(256, 10780, torch.float32)
    assert not bcd.supported(257, 10780, torch.float32)
    assert not bcd.supported(70, 17655, torch.float64)
    assert bcd.max_block(10780, torch.float32) == 256
    assert bcd.max_block(1000, torch.float64) == 0


def _warp_sum(x):
    """The kernel's xor-butterfly sum over the last axis (32 lanes)."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ off]
    return x[..., 0]


def _block_sums(row4, f, g):
    """``row_sums`` of the kernel: thread t adds f and g of its float4s
    q = t, t + THREADS, ... in order, then warps, then the block."""
    T = bcd.THREADS
    n4 = row4.shape[0]
    per = -(-n4 // T)
    P = np.zeros((per * T, 4), np.float32)
    P[:n4] = row4
    P = P.reshape(per, T, 4)
    a = np.zeros(T, np.float32)
    b = np.zeros(T, np.float32)
    for m in range(per):
        for e in range(4):
            a += f(P[m, :, e])
            b += g(P[m, :, e])
    out = []
    for x in (a, b):
        warps = _warp_sum(x.reshape(T // 32, 32))
        lanes = np.zeros(32, np.float32)
        lanes[:T // 32] = warps
        out.append(_warp_sum(lanes))
    return out


def _sum_partials(parts):
    """``sum_partials``: lane l adds blocks l, l + 32, ..., then the warp."""
    G = len(parts)
    lanes = np.zeros((-(-G // 32) * 32,), np.float32)
    lanes[:G] = parts
    return _warp_sum(lanes.reshape(-1, 32).sum(axis=0, dtype=np.float32))


def _slab_sum(x, w):
    """A warp's sum over a slab: lane l adds columns l, l + 32, ..."""
    lanes = np.zeros((-(-w // 32) * 32,), np.float32)
    lanes[:len(x)] = x
    return _warp_sum(lanes.reshape(-1, 32).sum(axis=0, dtype=np.float32))


def _emulate_kernel(D, grad, C, cn, order, comp_pos, l1_ratio):
    """numpy float32 emulation of csrc/bcd_update.cu's order of sums: the
    budgets and each candidate row's first statistics from per-slab
    partials, the threshold search over the whole row in the kernel's
    thread and reduction order, the elastic-net probe as (S_t + hg S_t2 /
    den) / den, the new row's norm from the search's own sums, and the
    right-looking rank-1 updates. Not bitwise (fused multiply-adds are
    rounded once on the card), but the same algorithm."""
    f32 = np.float32
    k, s = D.shape
    grid, w, _, _ = bcd._plan(k, s)
    s4 = bcd._row4(s)
    count = f32(bcd._l1_count(s))
    l1, l2c = f32(l1_ratio), f32(1.0 - l1_ratio)
    gamma = f32(2.0 / l1_ratio - 2.0) if 0.0 < l1_ratio < 1.0 else f32(0)
    hg = f32((2.0 / l1_ratio - 2.0) / 2.0) if 0.0 < l1_ratio < 1.0 \
        else f32(0)
    tiny = f32(1e-30)
    D = D.astype(f32).copy()
    R = (grad.astype(f32) - C.astype(f32) @ D).astype(f32)
    slabs = [slice(b * w, min(s, (b + 1) * w)) for b in range(grid)]
    ax = np.abs(D)
    enorm = ax * (l1 + l2c * ax)
    budget = np.array([cn[i] + _sum_partials(
        [_slab_sum(enorm[i, sl], w) for sl in slabs]) for i in range(k)],
        f32)
    cn_out = np.zeros(k, f32)
    for j in (range(k) if order is None else order):
        cjj = f32(C[j, j])
        good = cjj > 1e-20
        inv = f32(1) / (cjj if good else f32(1))
        v = (R[j] + cjj * D[j]) * inv if good else D[j].copy()
        if comp_pos:
            v = np.maximum(v, f32(0))
        b = np.abs(v)
        stat = v * v if l1_ratio == 0.0 else b if l1_ratio == 1.0 \
            else b * (f32(1) + hg * b)
        r0x = _sum_partials([_slab_sum(stat[sl], w) for sl in slabs])
        r0y = f32(b.max())
        radius = budget[j]
        row4 = np.zeros(s4, f32)
        row4[:s] = v
        row4 = row4.reshape(-1, 4)

        def sums(f, g):
            return _block_sums(row4, f, g)

        if not radius > 0:
            o, norm = np.zeros_like(v), f32(0)
        elif l1_ratio == 0.0:
            scale = f32(1) if r0x <= radius else np.sqrt(r0x / max(radius,
                                                                   tiny))
            o, norm = v / scale, r0x / (scale * scale)
        elif l1_ratio == 1.0 and r0x <= radius:
            o, norm = v, r0x
        elif l1_ratio == 1.0:
            def probe(tp):
                g, n = sums(lambda x: np.maximum(np.abs(x) - tp, f32(0)),
                            lambda x: (np.abs(x) - tp > 0).astype(f32))
                return g, n
            lo = max((r0x - radius) / count, f32(0))
            glo, nlo = probe(lo)
            nlo = max(nlo, f32(1))
            hi = min(max(lo + (glo - radius) * (r0y - lo) / max(glo, tiny),
                         lo), r0y)
            for _ in range(bcd.NEWTON_ITERS):
                newton = lo + (glo - radius) / nlo
                tp = min(max(max(newton, f32(0.5) * (lo + hi)), lo), hi)
                g, n = probe(tp)
                n = max(n, f32(1))
                sec = lo + (glo - radius) * (tp - lo) / max(glo - g, tiny)
                if g >= radius:
                    lo, glo, nlo = tp, g, n
                else:
                    hi = min(tp, sec)
            lam = max(lo + (glo - radius) / nlo, f32(0))
            norm_w = probe(lam)[0]
            scale = radius / max(norm_w, tiny) if norm_w > radius else f32(1)
            o = np.copysign(np.maximum(b - lam, f32(0)), v) * scale
            norm = norm_w * scale
        elif r0x <= radius / l1:
            o, norm = v, l1 * r0x
        else:
            def scaled_norm(tp, den):
                st, st2 = sums(lambda x: np.maximum(np.abs(x) - tp, f32(0)),
                               lambda x: np.maximum(np.abs(x) - tp,
                                                    f32(0)) ** 2)
                return (st + hg * st2 / den) / den
            rr = radius / l1
            lo, hi = f32(0), r0y
            for _ in range(bcd.PROJ_ITERS):
                mid = f32(0.5) * (lo + hi)
                if scaled_norm(mid, f32(1) + mid * gamma) > rr:
                    lo = mid
                else:
                    hi = mid
            lam = f32(0.5) * (lo + hi)
            den = f32(1) + lam * gamma
            o = np.copysign(np.maximum(b - lam, f32(0)) / den, v)
            norm = l1 * scaled_norm(lam, den)
        o = o.astype(f32)
        cn_out[j] = radius - norm
        R -= np.outer(C[:, j].astype(f32), o - D[j]).astype(f32)
        D[j] = o
    return D, cn_out


@pytest.mark.parametrize('comp_pos', [False, True])
@pytest.mark.parametrize('l1r', [0.0, 1.0, 0.5])
def test_kernel_emulation_matches_pallas_small(comp_pos, l1r):
    D, grad, C, cn, order = _case(8, 96, 0)
    got = _emulate_kernel(D, grad, C, cn, order, comp_pos, l1r)
    (Dr, cnr), (Dw, cnw) = _both(D, grad, C, cn, order, comp_pos, l1r)
    for a, want in ((got[0], Dw), (got[1], cnw), (got[0], Dr),
                    (got[1], cnr)):
        np.testing.assert_allclose(a, want, atol=2e-5)


@pytest.mark.parametrize('k,s', [(32, 80), (72, 2050)])
def test_kernel_emulation_matches_pallas_l1(k, s):
    """The shapes of test_plain_bcd_matches_pallas_l1: several slabs of
    the plan, the fold pad's bracket count at s = 2050."""
    D, grad, C, cn, order = _case(k, s, 1, l1_normalised=True)
    got = _emulate_kernel(D, grad, C, cn, order, False, 1.0)
    (Dr, cnr), (Dw, cnw) = _both(D, grad, C, cn, order, False, 1.0)
    for a, want in ((got[0], Dw), (got[1], cnw), (got[0], Dr),
                    (got[1], cnr)):
        np.testing.assert_allclose(a, want, atol=2e-5)


def test_kernel_emulation_matches_pallas_adversarial_rows():
    """The spiky geometric rows of test_plain_bcd_matches_pallas_adversarial
    _rows: the kernel's order of sums keeps every row inside its ball."""
    rng = np.random.RandomState(3)
    k, s = 8, 256
    D = (rng.randn(k, s) * np.logspace(-6, 3, s)[None, :]).astype(
        np.float32)
    D[:, :4] *= 1e4
    C = np.eye(k, dtype=np.float32)
    grad = (D * 37.0).astype(np.float32)
    cn = np.zeros(k, np.float32)
    order = np.arange(k, dtype=np.int32)
    Dg, cng = _emulate_kernel(D, grad, C, cn, order, False, 1.0)
    (Dr, cnr), (Dw, cnw) = _both(D, grad, C, cn, order, False, 1.0)
    scale = np.abs(Dw).max()
    budgets = np.abs(D).sum(axis=1)
    for want_D, want_cn in ((Dw, cnw), (Dr, cnr)):
        np.testing.assert_allclose(Dg, want_D, atol=2e-5 * scale)
        np.testing.assert_allclose(cng, want_cn, atol=1e-5 * budgets.max())
    assert np.all(np.abs(Dg).sum(axis=1) <= budgets * (1 + 1e-5))
    assert np.all(cng >= -1e-4 * budgets)


def test_wrapper_runs_plain_version_on_cpu_only():
    D, grad, C, cn, order = map(torch.as_tensor, _case(8, 40, 4))
    before = bcd.LAUNCHES
    got = bcd.bcd_update(D, grad, C, cn, order=order.long(), l1_ratio=1.0)
    want = bcd.bcd_update_reference(D, grad, C, cn, order=order.long(),
                                    l1_ratio=1.0)
    assert bcd.LAUNCHES == before        # no kernel was launched
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        bcd.bcd_update(*(t.to('meta') for t in (D, grad, C, cn)))
