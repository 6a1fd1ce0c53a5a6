"""The port's dtype policy on CUDA and on the CPU.

On CUDA, float64 data runs float32 state, as ``modl_tpu`` maps it
without x64 (its TPU setting), so that the BCD kernel runs; an explicit
``dtype=np.float64`` raises there. On the CPU float64 stays float64
(``modl_tpu`` with x64, as the parity tests run it). The policy is a
pure function of the device, ``_default_dtype(dtype, device)``, so its
CUDA branch runs here without a card; the estimators are checked to
feed it their device and the data's dtype by stopping them where the
state's dtype is decided.
"""
import numpy as np
import pytest
import torch

import jax

from modl_tpu.decomposition.dict_fact import _default_dtype as jax_default
from modl_tpu_torch import Coder, DictFact, fMRIDictFact
from modl_tpu_torch.decomposition import dict_fact
from modl_tpu_torch.decomposition.dict_fact import _default_dtype

CUDA = torch.device('cuda')
FLOATS = [np.float16, np.float32, np.float64]


@pytest.mark.parametrize('device', ['cuda', 'cuda:0', CUDA])
def test_cuda_maps_float64_to_float32(device):
    assert _default_dtype(np.float64, device) == np.float32
    assert _default_dtype(np.float32, device) == np.float32
    assert _default_dtype(np.float16, device) == np.float32
    assert _default_dtype(np.float32, device, explicit=True) == np.float32


def test_cuda_refuses_explicit_float64():
    with pytest.raises(ValueError, match='float32 state'):
        _default_dtype(np.float64, CUDA, explicit=True)


@pytest.mark.parametrize('explicit', [False, True])
def test_cpu_keeps_float64(explicit):
    cpu = torch.device('cpu')
    assert _default_dtype(np.float64, cpu, explicit=explicit) == np.float64
    assert _default_dtype(np.float32, cpu, explicit=explicit) == np.float32
    assert _default_dtype(np.int64, cpu, explicit=explicit) == np.float32


@pytest.mark.parametrize('dtype', FLOATS)
def test_matches_jax_x64_policy(dtype):
    """CUDA takes modl_tpu's x64-off mapping, the CPU its x64 one."""
    assert _default_dtype(dtype, 'cpu') == jax_default(dtype)
    x64 = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', False)
    try:
        assert _default_dtype(dtype, CUDA) == jax_default(dtype)
    finally:
        jax.config.update('jax_enable_x64', x64)


class _Decided(Exception):
    """Raised where ``prepare`` has decided the state's dtype."""


@pytest.fixture
def on_cuda(monkeypatch):
    """The estimators believe they are on CUDA up to the point where the
    state's dtype is decided (``_torch_dtype`` of it), which raises
    :class:`_Decided` with that dtype."""
    monkeypatch.setattr(dict_fact, '_resolve_device', lambda device: CUDA)

    def decided(dtype):
        raise _Decided(np.dtype(dtype))

    monkeypatch.setattr(dict_fact, '_torch_dtype', decided)


def _state_dtype(fn):
    with pytest.raises(_Decided) as info:
        fn()
    return info.value.args[0]


def test_dict_fact_float64_data_on_cuda_runs_float32(on_cuda):
    X = np.random.RandomState(0).randn(20, 12)
    df = DictFact(n_components=3, device='cuda')
    assert _state_dtype(lambda: df.fit(X)) == np.float32
    assert _state_dtype(lambda: df.prepare(n_samples=20,
                                           n_features=12)) == np.float32


def test_dict_fact_explicit_float64_on_cuda_raises(on_cuda):
    X = np.random.RandomState(0).randn(20, 12)
    with pytest.raises(ValueError, match='float32 state'):
        DictFact(n_components=3, dtype=np.float64, device='cuda').fit(X)


def test_fmri_float64_records_on_cuda_run_float32(on_cuda):
    rng = np.random.RandomState(0)
    records = [rng.randn(10, 16) for _ in range(2)]
    mask = np.ones((16, 1, 1), bool)
    fd = fMRIDictFact(n_components=3, mask=mask, device='cuda')
    assert _state_dtype(lambda: fd.fit(records)) == np.float32


def test_cpu_fits_keep_float64():
    rng = np.random.RandomState(0)
    X = rng.randn(20, 12)
    df = DictFact(n_components=3, device='cpu').fit(X)
    assert df._state.D.dtype == torch.float64
    coder = Coder(df.components_, device='cpu')
    assert coder._components_device().dtype == torch.float64
    records = [rng.randn(10, 16) for _ in range(2)]
    fd = fMRIDictFact(n_components=3, mask=np.ones((16, 1, 1), bool),
                      standardize=False, detrend=False, device='cpu')
    assert fd.fit(records).dict_fact_._state.D.dtype == torch.float64
