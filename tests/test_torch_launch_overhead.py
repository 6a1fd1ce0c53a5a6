"""The port's launch-overhead probe against benchmarks/pallas_call_overhead.py.

The plain version (which the probe's wrapper runs for CPU tensors) is
held against the Pallas ``_kernel`` run through ``make_call`` in
interpret mode: ``pl.pallas_call`` is patched to pass
``interpret=True`` for the duration of the test (the benchmark file
itself is not edited). The Hopper kernel rounds as the plain version
does and is compared with it on the card (chip_smoke.py).
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from modl_tpu_torch.benchmarks import launch_overhead as lo
from torch_parity import to_np

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def pallas_overhead(monkeypatch):
    """benchmarks/pallas_call_overhead.py with its pallas_call run in
    interpret mode."""
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    path = REPO / 'benchmarks' / 'pallas_call_overhead.py'
    spec = importlib.util.spec_from_file_location('pallas_call_overhead',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shapes_match_the_pallas_probe(pallas_overhead):
    assert (lo.KP, lo.SPP, lo.FOLD, lo.P, lo.PPB) == (
        pallas_overhead.KP, pallas_overhead.SPP, pallas_overhead.FOLD,
        pallas_overhead.P, pallas_overhead.PPB)


def test_plain_version_matches_pallas_kernel(pallas_overhead):
    rng = np.random.RandomState(0)
    shape = (lo.BLOCK_ROWS, lo.SPP)
    D = rng.randn(*shape).astype(np.float32)
    G = rng.randn(*shape).astype(np.float32)
    want = np.asarray(pallas_overhead.make_call(1)(jnp.asarray(D),
                                                   jnp.asarray(G)))
    launches = lo.LAUNCHES
    Dt = torch.tensor(D)
    out = lo.make_call(1)(Dt, torch.tensor(G))
    assert out is Dt and lo.LAUNCHES == launches   # in place, no launch
    np.testing.assert_allclose(to_np(out), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        to_np(lo.launch_overhead_reference(torch.tensor(D),
                                           torch.tensor(G))), to_np(out))


def test_call_checks_its_operands():
    D, G = lo.operands(n_blocks=1, device='cpu')
    call = lo.make_call(1)
    for bad in (D[:64], D.double(), D.T.contiguous().T):
        with pytest.raises(ValueError, match='launch_overhead'):
            call(bad, G)
    two = lo.make_call(2)
    with pytest.raises(ValueError, match='launch_overhead'):
        two(D, G)


def test_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is visible')
    with pytest.raises(RuntimeError, match='CUDA'):
        lo.bench(4)
