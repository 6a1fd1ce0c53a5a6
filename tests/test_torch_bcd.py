"""The port's BCD update against the Pallas kernel it replaces.

``bcd_update_reference`` (what ``bcd_update`` runs for CPU tensors, and
the plain version the Hopper kernel is held against on the card) against
``modl_tpu.ops.bcd_pallas.bcd_update`` in interpret mode, float32 on both
sides (the Pallas kernel refuses float64), at the kernel test's
tolerance atol 2e-5 (tests/test_bcd_pallas.py). The CUDA kernel itself
has no CPU mode; chip_smoke.py compares it with this plain version on
the GPU.
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
    the row cap is what 227 KB of shared memory allows, at most 256."""
    if torch.cuda.is_available():
        pytest.skip('the plan follows the visible card, not an H100')
    assert bcd._plan(70, 17655)[:2] == (132, 134)
    assert bcd._plan(256, 10780)[:2] == (132, 82)
    assert bcd._plan(8, 96)[:2] == (3, 32)
    assert bcd.supported(256, 10780, torch.float32)
    assert not bcd.supported(257, 10780, torch.float32)
    assert not bcd.supported(70, 17655, torch.float64)
    assert bcd.max_block(10780, torch.float32) == 256
    assert 0 < bcd.max_block(200_000, torch.float32) < 256
    assert bcd.max_block(1000, torch.float64) == 0


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
