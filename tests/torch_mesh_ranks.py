"""The rank side of the mesh tests (tests/test_torch_mesh*.py).

Not a test module. ``parallel.launch.spawn`` starts one process per rank
and calls the functions below by their import path, so this module
imports torch, numpy and ``modl_tpu_torch`` only (no JAX): the JAX side
of each comparison runs in the pytest process, which passes its inputs
here as numpy arrays and plain values.
"""
import pickle
import types

import numpy as np
import torch

from modl_tpu_torch import DictFact, RecsysDictFact, convert
from modl_tpu_torch.decomposition import _step
from modl_tpu_torch.decomposition import dict_fact as dict_fact_mod
from modl_tpu_torch.decomposition import recsys as recsys_mod
from modl_tpu_torch.ops import bcd, fista
from modl_tpu_torch.parallel import (COLLECTIVES, make_mesh, shard_batch,
                                     shard_state, unshard_state)
from modl_tpu_torch.utils.checkpoint import save_state
from torch.distributed.device_mesh import DeviceMesh

T = torch.as_tensor
STATE_FIELDS = ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg', 'G_avg',
                'sample_n_iter')


def _host(state):
    whole = unshard_state(state)
    return {name: (None if getattr(whole, name) is None
                   else getattr(whole, name).numpy().copy())
            for name in STATE_FIELDS} | {'n_iter': whole.n_iter}


def _jax_cfg(fields, shape):
    """A stand-in for a JAX SomfConfig on a mesh of ``shape``: its field
    values and a mesh with a ``shape`` mapping, as ``config_from_jax``
    reads them."""
    mesh = types.SimpleNamespace(shape={'dp': shape[0], 'feat': shape[1]})
    return types.SimpleNamespace(**fields, mesh=mesh)


def run_steps(case):
    """Steps from a carried JAX state on a mesh: ``convert`` carries the
    state and the configuration, ``shard_state`` the shards; returns the
    whole state after the steps (rank 0) and the collectives they made."""
    cfg = convert.config_from_jax(_jax_cfg(case['cfg'], case['shape']),
                                  device_type='cpu')
    state = shard_state(convert.state_from_jax(case['state'], device='cpu'),
                        cfg.mesh)
    COLLECTIVES.clear()
    for X, idx, subset, n_valid, order in case['steps']:
        X_loc = shard_batch(T(X), cfg.mesh, feat=case['shape'][1] > 1)
        subset = subset if isinstance(subset, int) else T(subset)
        state = _step.somf_step_inner(state, X_loc, T(idx), subset,
                                      T(order), cfg, n_valid=n_valid)
    return _host(state), dict(COLLECTIVES)


def fit(case):
    """One estimator fit on a mesh: returns its public arrays (whole on
    every rank) and a few facts of its layout."""
    mesh = make_mesh(*case['shape'], device_type='cpu')
    host_allocs = []    # G_avg allocations in host RAM (offloaded)
    saved_host_zeros = dict_fact_mod.host_zeros
    dict_fact_mod.host_zeros = (lambda *a: (host_allocs.append(a[0]),
                                            saved_host_zeros(*a))[1])
    split_solves = []   # FISTA solves run a check a call (``agree``)
    saved_drive = fista._drive_checks
    fista._drive_checks = (lambda *a: (split_solves.append(1),
                                       saved_drive(*a))[1])
    try:
        df = DictFact(mesh=mesh, device='cpu', **case['kw']).fit(case['X'])
    finally:
        dict_fact_mod.host_zeros = saved_host_zeros
        fista._drive_checks = saved_drive
    out = dict(components=df.components_, windowed=df._cfg.windowed,
               split_solves=len(split_solves),
               offload=df._cfg.average_offload, n_iter=df.n_iter_,
               local_D=tuple(df._state.D.shape),
               transform=df.transform(case['X']),
               G_average=df.G_average_, Dx_average=df.Dx_average_)
    if df._state.G_avg is not None:
        out['local_G_avg'] = tuple(df._state.G_avg.shape)
        out['G_avg_device'] = str(df._state.G_avg.device)
        out['G_avg_pinned'] = df._state.G_avg.is_pinned()
        out['D_device'] = str(df._state.D.device)
        out['host_allocs'] = host_allocs
    if case.get('save'):
        # pickles and checkpoints gather the state: every rank makes them
        out['pickle'] = pickle.dumps(df)
        out['saved'] = save_state(
            df._state, f"{case['save']}.{torch.distributed.get_rank()}")
        # and the mesh fit goes on after them
        df.partial_fit(case['X'])
        out['after_partial_fit'] = df.components_
    if case.get('then'):
        # a mid-run set_params regathers and reshards the state
        df.set_params(**case['then'])
        df.partial_fit(case['X'])
        out['after_set_params'] = df.components_
        out['windowed_after'] = df._cfg.windowed
    return out


def dict_fact_world(rank, world, cases):
    """The DictFact mesh cases of tests/test_torch_mesh.py in one world:
    ``cases`` maps names to inputs; returns name -> result (rank 0
    returns them all, the other ranks the fits' components only, to show
    that every rank holds the same dictionary)."""
    out = {}
    for name, case in cases.items():
        if case['kind'] == 'steps':
            out[name] = run_steps(case)
        elif case['kind'] == 'fit':
            res = fit(case)
            out[name] = res if rank == 0 else {
                'components': res['components']}
        elif case['kind'] == 'bad_mesh':
            try:
                make_mesh(*case['shape'], device_type='cpu')
            except ValueError as e:
                out[name] = str(e)
    return out


def draws_differ(rank, world):
    """Rank 1 seeds its fit otherwise: ``prepare`` raises on every
    rank."""
    mesh = make_mesh(world, 1, device_type='cpu')
    X = np.random.RandomState(0).randn(40, 16)
    DictFact(mesh=mesh, n_components=3, reduction=2, batch_size=10,
             random_state=int(rank == 1), device='cpu').fit(X)


def dies_before_collective(rank, world):
    """Rank 1 raises while rank 0 waits in an all-reduce."""
    if rank == 1:
        raise RuntimeError('rank 1 gives up')
    torch.distributed.all_reduce(torch.ones(1))


def recsys_world(rank, world, cases):
    """The recsys mesh cases of tests/test_torch_mesh_recsys.py: each a
    mesh fit (resident rows split over dp, or packed per batch), with
    the kernel route forced where asked (BCD calls counted)."""
    out = {}
    mesh = make_mesh(world, 1, device_type='cpu')
    try:        # a mesh without a dp axis is refused
        RecsysDictFact(mesh=DeviceMesh('cpu', torch.arange(world),
                                       mesh_dim_names=('x',)),
                       device='cpu').fit(cases['resident']['X'])
    except ValueError as e:
        out['no_dp'] = str(e)
    for name, case in cases.items():
        calls = []
        saved_budget = recsys_mod.RESIDENT_BUDGET
        saved_step = recsys_mod._recsys_batch_step
        saved_bcd = bcd.bcd_update
        if case.get('budget') is not None:
            recsys_mod.RESIDENT_BUDGET = case['budget']
        if case.get('kernel'):
            # the route a CUDA fit takes (bcd_kernel -> bcd.bcd_update;
            # its plain version on CPU tensors), one call a batch
            recsys_mod._recsys_batch_step = (
                lambda *a, **kw: saved_step(*a, **dict(kw, use_kernel=True)))
            bcd.bcd_update = (lambda *a, **kw: (
                calls.append(a[0].shape), saved_bcd(*a, **kw))[1])
        try:
            COLLECTIVES.clear()
            est = RecsysDictFact(mesh=mesh, device='cpu', **case['kw']).fit(
                case['X'].copy())
        finally:
            recsys_mod.RESIDENT_BUDGET = saved_budget
            recsys_mod._recsys_batch_step = saved_step
            bcd.bcd_update = saved_bcd
        out[name] = dict(components=est.components_, code=est.code_,
                         score=est.score(case['X']), n_iter=est.n_iter_,
                         resident_width=est.resident_width_,
                         resident_rows=est._resident_rows,
                         bcd_calls=len(calls),
                         collectives=dict(COLLECTIVES),
                         pickle=pickle.dumps(est) if rank == 0 else None)
        if rank != 0:
            out[name] = {'components': out[name]['components']}
    return out

