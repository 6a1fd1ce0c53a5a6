"""Carry learner state and configuration across from the JAX package.

Takes host values only (numpy arrays, a frozen dataclass), so nothing
here imports JAX: ``state_from_jax`` reads the dictionary that
``modl_tpu.decomposition.dict_fact._state_to_host`` returns, and
``config_from_jax`` reads the attributes of a ``modl_tpu`` SomfConfig
and ``masker_from_jax`` those of a fitted ``modl_tpu`` ``NumpyMasker``;
``recsys_state_from_jax`` takes the host values of a recsys fit's state.
Together they let a test start both packages from the same state. A JAX
mesh becomes a port mesh of the same ``('dp', 'feat')`` shape, and
``parallel.mesh.shard_state`` carries a whole state to a rank's shards.
"""
import dataclasses

import numpy as np
import torch

from .decomposition._step import SomfConfig, state_from_numpy
from .decomposition.dict_fact import _resolve_device
from .input_data.fmri.base import NumpyMasker
from .parallel.mesh import config_for_mesh, make_mesh

__all__ = ["state_from_jax", "config_from_jax", "masker_from_jax",
           "recsys_state_from_jax"]


def state_from_jax(state_np, device='cuda', dtype=None, seed=0):
    """Port-side :class:`SomfState` from a JAX ``SomfState`` on the host.

    ``state_np`` maps field names to numpy arrays (or None). Float leaves
    go to ``device`` (the card unless the caller asks for the CPU; raises
    where there is none) in ``dtype`` (default: the dictionary's dtype),
    ``G_avg`` to host RAM, where an estimator's next ``partial_fit``
    places it (``_step.state_from_numpy``); the sampler's ``box`` stays
    on the host and ``cursor``/``n_iter`` become
    ints. The JAX PRNG ``key`` has no counterpart and is dropped: the
    port's host generator is seeded with ``seed`` instead.
    """
    if dtype is None:
        dtype = getattr(torch, np.asarray(state_np['D']).dtype.name)
    return state_from_numpy(state_np, _resolve_device(device), dtype,
                            seed=seed)


def config_from_jax(cfg, device_type='cuda'):
    """Port-side :class:`SomfConfig` from a JAX ``SomfConfig``.

    ``use_pallas`` becomes ``use_kernel``. A JAX mesh (its ``shape``
    maps ``'dp'`` and ``'feat'`` to sizes) becomes a port DeviceMesh of
    the same shape on ``device_type``, made by ``parallel.make_mesh``
    over the initialised default group (every rank calls this then)."""
    fields = {f.name for f in dataclasses.fields(SomfConfig)}
    values = {name: getattr(cfg, name) for name in fields
              if name not in ('use_kernel', 'mesh')}
    values['use_kernel'] = bool(cfg.use_pallas)
    port = SomfConfig(**values)
    if getattr(cfg, 'mesh', None) is not None:
        shape = dict(cfg.mesh.shape)
        port = config_for_mesh(port, make_mesh(shape.get('dp', 1),
                                               shape.get('feat', 1),
                                               device_type))
    return port


def masker_from_jax(masker):
    """The port's fitted :class:`NumpyMasker` from a fitted ``modl_tpu``
    one: its parameters (detrend, standardize, filters, dtype, ...), its
    mask and its feature order."""
    params = {name: getattr(masker, name)
              for name in NumpyMasker._get_param_names()
              if hasattr(masker, name)}
    params['mask_img'] = np.array(masker.mask_img_, bool)
    order = masker.feature_order_
    params['feature_order'] = None if order is None else np.array(order)
    return NumpyMasker(**params).fit()


def recsys_state_from_jax(state_np, device='cuda', dtype=None):
    """The port's recsys state from the JAX one on the host.

    ``state_np`` maps ``D``, ``C``, ``B`` and ``code`` (the JAX
    estimator's ``_D``, ``_C``, ``_B``, ``_code``) and the step's
    ``comp_norm``, ``feature_n_iter`` and ``n_iter`` to numpy values.
    Returns a dict of the same keys: float tensors on ``device`` (the
    card unless the caller asks for the CPU) in ``dtype`` (default: the
    dictionary's), ``feature_n_iter`` as int32
    and ``n_iter`` as a host int: the fields of
    ``decomposition.recsys.RecsysState``."""
    device = _resolve_device(device)
    if dtype is None:
        dtype = getattr(torch, np.asarray(state_np['D']).dtype.name)
    out = {name: torch.as_tensor(np.array(state_np[name])).to(device, dtype)
           for name in ('D', 'C', 'B', 'code', 'comp_norm')}
    out['feature_n_iter'] = torch.as_tensor(
        np.array(state_np['feature_n_iter'], dtype=np.int32)).to(device)
    out['n_iter'] = int(state_np['n_iter'])
    return out
