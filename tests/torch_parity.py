"""Shared pieces of the parity tests between modl_tpu and modl_tpu_torch.

Not a test module (pytest collects ``test_*.py`` only). Inputs are made
with numpy from a seed and handed to both packages; JAX stays on the
CPU (tests/conftest.py) with x64 on, and the port runs on the CPU, where
its BCD wrapper takes the kernel's plain version.
"""
import dataclasses

import numpy as np
import torch

from modl_tpu.decomposition.dict_fact import _state_to_host
from modl_tpu_torch import convert
from modl_tpu_torch.decomposition._step import SomfState

# keep each worker's torch to one thread: the suite runs in parallel
torch.set_num_threads(1)


def to_np(x):
    """numpy view of a torch tensor or a JAX array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def planted(n_samples=400, n_features=480, k=6, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return (rng.randn(n_samples, k) @ rng.randn(k, n_features)).astype(dtype)


def port_state(df_jax, seed=0):
    """The port's state carried over from a prepared JAX estimator."""
    return convert.state_from_jax(_state_to_host(df_jax._state),
                                  device='cpu', seed=seed)


def port_config(df_jax, **changes):
    return dataclasses.replace(convert.config_from_jax(df_jax._cfg),
                               **changes)


def clone_state(st):
    """Deep copy of a port state (its tensors are updated in place)."""
    def copy(v):
        return v.clone() if torch.is_tensor(v) else v
    gen = torch.Generator()
    gen.set_state(st.gen.get_state())
    return SomfState(**{f.name: copy(getattr(st, f.name))
                        for f in dataclasses.fields(SomfState)
                        if f.name != 'gen'}, gen=gen)


def assert_states_close(st_port, st_jax, names, rtol=0.0, atol=1e-9):
    for name in names:
        a, b = getattr(st_port, name), getattr(st_jax, name)
        if a is None and b is None:
            continue
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol,
                                   err_msg=name)


def assert_rel_close(a, b, tol, name=''):
    """max |a - b| / max |b| < tol."""
    a, b = to_np(a), to_np(b)
    rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
    assert rel < tol, f'{name}: rel {rel}'
