"""Carry learner state and configuration across from the JAX package.

Takes host values only (numpy arrays, a frozen dataclass), so nothing
here imports JAX: ``state_from_jax`` reads the dictionary that
``modl_tpu.decomposition.dict_fact._state_to_host`` returns, and
``config_from_jax`` reads the attributes of a ``modl_tpu`` SomfConfig.
Together they let a test start both packages from the same state.
"""
import dataclasses

import numpy as np
import torch

from .decomposition._step import SomfConfig, SomfState

__all__ = ["state_from_jax", "config_from_jax"]


def state_from_jax(state_np, device='cpu', dtype=None, seed=0):
    """Port-side :class:`SomfState` from a JAX ``SomfState`` on the host.

    ``state_np`` maps field names to numpy arrays (or None). Float leaves
    go to ``device`` in ``dtype`` (default: the dictionary's dtype); the
    sampler's ``box`` stays on the host and ``cursor``/``n_iter`` become
    ints. The JAX PRNG ``key`` has no counterpart and is dropped: the
    port's host generator is seeded with ``seed`` instead.
    """
    if dtype is None:
        dtype = getattr(torch, np.asarray(state_np['D']).dtype.name)

    def dev(name, dt=dtype):
        v = state_np.get(name)
        if v is None:
            return None
        return torch.as_tensor(np.array(v)).to(device, dt)

    return SomfState(
        D=dev('D'), C=dev('C'), B=dev('B'), G=dev('G'),
        comp_norm=dev('comp_norm'), code=dev('code'),
        Dx_avg=dev('Dx_avg'), G_avg=dev('G_avg'),
        n_iter=int(state_np['n_iter']),
        sample_n_iter=dev('sample_n_iter', torch.int64),
        box=torch.as_tensor(np.array(state_np['box'], dtype=np.int64)),
        cursor=int(state_np['cursor']),
        gen=torch.Generator().manual_seed(int(seed)),
    )


def config_from_jax(cfg):
    """Port-side :class:`SomfConfig` from a JAX ``SomfConfig``.

    ``use_pallas`` becomes ``use_kernel``; a mesh or ``average_offload``
    has no counterpart in the port yet and is refused."""
    if getattr(cfg, 'mesh', None) is not None or getattr(
            cfg, 'average_offload', False):
        raise ValueError('meshes and average_offload are not ported')
    fields = {f.name for f in dataclasses.fields(SomfConfig)}
    values = {name: getattr(cfg, name) for name in fields
              if name != 'use_kernel'}
    values['use_kernel'] = bool(cfg.use_pallas)
    return SomfConfig(**values)
