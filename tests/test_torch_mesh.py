"""The port's dp x feat mesh (``modl_tpu_torch.parallel``) against
modl_tpu's, on the CPU: the cases of tests/test_parallel.py one for one.

The port's ranks run in one gloo world of 8 processes started by
``parallel.launch.spawn`` (tests/torch_mesh_ranks.py), holding ``DeviceMesh``es
of the shapes (8, 1), (4, 2) and (2, 4); the JAX side runs here on the
conftest's eight virtual CPU devices. Inputs are made with numpy from a
seed and handed to both.

- one ``somf_step_inner`` from a JAX state carried by ``convert`` and
  sharded by ``shard_state``, with injected subsets, sizes and orders, on
  every mesh shape, field by field against modl_tpu's sharded step and
  the port's single-process step (float64, rtol 1e-10, atol 1e-12); a
  5-step trajectory on (4, 2); windowed steps on feat-split meshes;
- ``DictFact(mesh=...)`` fits against the port's single-process fit and
  against modl_tpu's mesh fit stepped with the port's draws (the two
  packages' generators differ): float64 at rtol 1e-10, atol 1e-12,
  ``transform`` at rtol 1e-8; the odd batch; windowed float32 at rtol
  1e-5, atol 1e-6 and the (2, 4) gather fallback; the 'average'
  aggregators with ``G_avg`` split over dp; ``average_offload`` on a
  mesh runs resident; l1 codes by FISTA with the batch split over dp
  (its stop agreed over the ranks);
- pickles and ``save_state`` of a mesh fit load as whole single-process
  state; a rank whose draws differ raises on every rank, and a failing
  rank does not hang its world.
"""
import dataclasses
import inspect
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks
from modl_tpu import DictFact as JaxDictFact
from modl_tpu.decomposition._step import somf_step_inner as jax_step_inner
from modl_tpu.decomposition.dict_fact import _state_to_host
from modl_tpu.parallel import make_mesh as jax_make_mesh
from modl_tpu.parallel import shard_batch as jax_shard_batch
from modl_tpu.parallel import shard_state as jax_shard_state
from modl_tpu_torch import DictFact, convert
from modl_tpu_torch.decomposition import _step
from modl_tpu_torch.parallel import make_mesh
from modl_tpu_torch.parallel.launch import RankError, spawn
from modl_tpu_torch.utils.checkpoint import load_state
from torch_parity import planted, port_config, port_state, to_np

T = torch.as_tensor
WORLD = 8
TIMEOUT = 180
SHAPES = [(8, 1), (4, 2), (2, 4)]
jax_step = jax.jit(jax_step_inner, static_argnames='cfg')
i32 = jnp.int32

GATHER_KW = dict(n_components=4, reduction=2, code_alpha=1e-4,
                 comp_l1_ratio=0, n_epochs=2, batch_size=24, random_state=0)
WINDOW_KW = dict(n_components=4, reduction=4, code_alpha=1e-3,
                 code_l1_ratio=0, random_state=0, batch_size=32, n_epochs=2,
                 dtype=np.float32)
WIDE_KW = dict(WINDOW_KW, reduction=12)
AVG_KW = dict(GATHER_KW, Dx_agg='average', G_agg='average')
FISTA_KW = dict(GATHER_KW, code_alpha=0.5, code_l1_ratio=1.0,
                code_solver='fista')


def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != 'mesh'}


def _step_inputs(df, X, n_steps, seed, starts=None):
    """Injected draws: (X batch, idx, subset or window start, n_valid,
    order) per step."""
    rng = np.random.RandomState(seed)
    cfg = df._cfg
    n_samples, b = X.shape[0], df.batch_size
    steps = []
    for t in range(n_steps):
        idx = rng.permutation(n_samples)[:b]
        if cfg.windowed:
            subset = int(starts[t])
        else:
            subset = rng.permutation(X.shape[1])[:cfg.len_max]
        n_valid = int(rng.randint(cfg.len_max // 2, cfg.len_max + 1))
        steps.append((X[idx], idx, subset, n_valid,
                      rng.permutation(cfg.n_components)))
    return steps


def _jax_steps(state, cfg, steps, mesh, feat):
    for X, idx, subset, n_valid, order in steps:
        state = jax_step(state, jax_shard_batch(jnp.asarray(X), mesh,
                                                feat=feat),
                         jnp.asarray(idx, i32), jnp.asarray(subset, i32),
                         jnp.asarray(order, i32), cfg,
                         n_valid=jnp.asarray(n_valid, i32))
    return state


def _port_steps(df, steps, cfg=None):
    st = port_state(df)
    cfg = port_config(df) if cfg is None else cfg
    for X, idx, subset, n_valid, order in steps:
        st = _step.somf_step_inner(
            st, T(X), T(idx), subset if isinstance(subset, int)
            else T(subset), T(order), cfg, n_valid=n_valid)
    return st


def _gather_df():
    X = np.random.RandomState(0).randn(64, 32)
    df = JaxDictFact(n_components=4, reduction=2, code_alpha=1e-4,
                     comp_l1_ratio=0, random_state=0, batch_size=16)
    df.prepare(n_samples=64, X=X)
    return df, X


def _window_df(shape):
    """A windowed JAX estimator prepared on a feat-split mesh (its state
    sharded, padded to a feat multiple) and its ingested data."""
    X = planted(96, 1600, k=4, seed=3)
    df = JaxDictFact(n_components=4, reduction=12, code_alpha=1e-3,
                     code_l1_ratio=0, random_state=0, batch_size=32,
                     subset_sampling='window', mesh=jax_make_mesh(*shape))
    df.prepare(n_samples=96, X=X)
    assert df._cfg.windowed
    return df, np.asarray(df._ingest_features(jnp.asarray(X)))


def _window_starts(df):
    s, n = df._cfg.len_max, df._cfg.n_features
    return [3, n // 3, n - s // 2]          # head, interior, wraps


def _port_draws(kw, X):
    """The draws the port's fit of ``kw`` makes, epoch by epoch."""
    df = DictFact(device='cpu', **kw)
    df._resident_fit = True
    df.prepare(n_samples=X.shape[0], X=X, dtype=X.dtype)
    n_full = X.shape[0] // kw['batch_size']
    return [_step.draw_epoch(df._state, df._cfg, n_full)
            for _ in range(kw['n_epochs'])]


def _jax_fit(kw, X, shape):
    """modl_tpu's mesh fit of ``kw`` (DictFact.fit: prepare, then per
    epoch the steps and a shuffle) stepped with the port's draws."""
    mesh = jax_make_mesh(*shape)
    df = JaxDictFact(mesh=mesh, **kw)
    df._resident_fit = True
    df.prepare(n_samples=X.shape[0], X=X, dtype=X.dtype)
    df._resident_fit = False
    assert not df._cfg.windowed
    X_dev = jnp.asarray(X)
    b = kw['batch_size']
    for draws in _port_draws(kw, X):
        steps = [(np.asarray(X_dev[t * b:(t + 1) * b]),
                  np.arange(t * b, (t + 1) * b), draws.subsets[t].numpy(),
                  draws.sizes[t], draws.orders[t].numpy())
                 for t in range(len(draws.subsets))]
        df._state = _jax_steps(df._state, df._cfg, steps, mesh,
                               shape[1] > 1)
        X_dev = X_dev[jnp.asarray(df.shuffle())]
    return df


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """One world of 8 ranks runs every port case; returns rank 0's
    results, every rank's and the inputs."""
    save = str(tmp_path_factory.mktemp('mesh') / 'state')
    cases, inputs = {}, {}
    df, X = _gather_df()
    for shape in SHAPES:
        steps = _step_inputs(df, X, 1, seed=sum(shape))
        inputs[f'step{shape}'] = (df, steps)
        cases[f'step{shape}'] = dict(
            kind='steps', shape=shape, cfg=_cfg_fields(df._cfg),
            state=_state_to_host(df._state), steps=steps)
    steps = _step_inputs(df, X, 5, seed=11)
    inputs['trajectory'] = (df, steps)
    cases['trajectory'] = dict(kind='steps', shape=(4, 2),
                               cfg=_cfg_fields(df._cfg),
                               state=_state_to_host(df._state), steps=steps)
    for shape in [(4, 2), (2, 4)]:
        wdf, Xw = _window_df(shape)
        steps = _step_inputs(wdf, Xw, 3, seed=5, starts=_window_starts(wdf))
        inputs[f'window{shape}'] = (wdf, steps)
        cases[f'window{shape}'] = dict(
            kind='steps', shape=shape, cfg=_cfg_fields(wdf._cfg),
            state=_state_to_host(wdf._state), steps=steps)
    cases['bad_mesh'] = dict(kind='bad_mesh', shape=(3, 2))

    X_fit = np.random.RandomState(0).randn(120, 32)
    inputs['X_fit'] = X_fit
    cases['fit'] = dict(kind='fit', shape=(4, 2), kw=GATHER_KW, X=X_fit,
                        save=save + '.gather', then=dict(G_agg='full'))
    cases['odd'] = dict(kind='fit', shape=(8, 1),
                        kw=dict(n_components=4, reduction=2, batch_size=24,
                                random_state=0),
                        X=np.random.RandomState(1).randn(50, 16))
    Xw = planted(256, 400, k=4, seed=1, dtype=np.float32)
    for shape in SHAPES:
        cases[f'windowed{shape}'] = dict(
            kind='fit', shape=shape, kw=WINDOW_KW, X=Xw,
            save=save + '.windowed' if shape == (4, 2) else None,
            then=dict(reduction=5) if shape == (4, 2) else None)
    cases['wide'] = dict(kind='fit', shape=(2, 4), kw=WIDE_KW,
                         X=planted(192, 1600, k=4, seed=3,
                                   dtype=np.float32))
    cases['average'] = dict(kind='fit', shape=(4, 2), kw=AVG_KW, X=X_fit)
    cases['fista'] = dict(kind='fit', shape=(2, 4), kw=FISTA_KW, X=X_fit)
    cases['offload'] = dict(kind='fit', shape=(4, 2), X=X_fit,
                            kw=dict(AVG_KW, average_offload=True))
    results = spawn(ranks.dict_fact_world, WORLD, backend='gloo', device='cpu',
                    timeout=TIMEOUT, args=(cases,))
    return dict(rank0=results[0], all=results, inputs=inputs, cases=cases,
                save=save)


def _close(got, want, rtol=1e-10, atol=1e-12, names=None):
    for name in names or want:
        if want[name] is None:
            assert got[name] is None, name
            continue
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


FIELDS = ('D', 'C', 'B', 'comp_norm', 'code', 'sample_n_iter')


@pytest.mark.parametrize('shape', SHAPES)
def test_sharded_step_matches_jax_and_single(world, shape):
    got, collectives = world['rank0'][f'step{shape}']
    df, steps = world['inputs'][f'step{shape}']
    mesh = jax_make_mesh(*shape)
    out = _jax_steps(jax_shard_state(df._state, mesh),
                     dataclasses.replace(df._cfg, mesh=mesh), steps, mesh,
                     shape[1] > 1)
    _close(got, _state_to_host(out), names=FIELDS)
    single = _port_steps(df, steps)
    _close(got, {name: to_np(getattr(single, name)) for name in FIELDS})
    assert got['n_iter'] == int(out.n_iter) == 16
    # the subset reads and Dx run over feat only where it splits
    assert (collectives.get('calls_feat', 0) > 0) == (shape[1] > 1)
    assert collectives['calls_dp'] > 0


def test_sharded_multi_step_trajectory(world):
    got, _ = world['rank0']['trajectory']
    df, steps = world['inputs']['trajectory']
    mesh = jax_make_mesh(4, 2)
    out = _jax_steps(jax_shard_state(df._state, mesh),
                     dataclasses.replace(df._cfg, mesh=mesh), steps, mesh,
                     True)
    _close(got, _state_to_host(out), rtol=1e-9, atol=1e-11,
           names=('D', 'B', 'C'))


@pytest.mark.parametrize('shape', [(4, 2), (2, 4)])
def test_windowed_step_on_feat_mesh_matches_jax(world, shape):
    """Window reads reassembled over feat and the shard-local write-back
    (head, interior and wrapping windows): the same as modl_tpu's
    ``_window_cols_feat``/``_windowed_writeback_feat`` and as the port's
    single-process step."""
    got, _ = world['rank0'][f'window{shape}']
    df, steps = world['inputs'][f'window{shape}']
    out = _state_to_host(_jax_steps(df._state, df._cfg, steps,
                                    df._cfg.mesh, True))
    # planted data: B reaches ~1e3, so roundoff is held relative
    _close(got, out, rtol=1e-9, atol=1e-9, names=FIELDS)
    single = _port_steps(df, steps, convert.config_from_jax(
        dataclasses.replace(df._cfg, mesh=None)))
    _close(got, {name: to_np(getattr(single, name)) for name in FIELDS},
           rtol=1e-9, atol=1e-9)
    n, s = df._cfg.n_features, df._cfg.len_max
    np.testing.assert_array_equal(got['D'][:, n:n + s], got['D'][:, :s])


def test_mesh_validation(world):
    assert 'n_dp * n_feat (3*2) != world size (8)' in world['rank0'][
        'bad_mesh']
    with pytest.raises(RuntimeError, match='initialised process group'):
        make_mesh(2, 1)


def test_worlds_and_meshes_default_to_the_card():
    """Like the estimators, a world and a mesh run on the card unless the
    caller asks for the CPU (the tests here do)."""
    params = inspect.signature(spawn).parameters
    assert params['backend'].default == 'nccl'
    assert params['device'].default == 'cuda'
    assert inspect.signature(make_mesh).parameters[
        'device_type'].default == 'cuda'
    assert inspect.signature(convert.config_from_jax).parameters[
        'device_type'].default == 'cuda'


def test_dictfact_mesh_matches_jax_mesh_fit_and_single(world):
    got = world['rank0']['fit']
    X = world['inputs']['X_fit']
    single = DictFact(device='cpu', **GATHER_KW).fit(X)
    np.testing.assert_allclose(got['components'], single.components_,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got['transform'], single.transform(X),
                               rtol=1e-8, atol=1e-10)
    ref = _jax_fit(GATHER_KW, X, (4, 2))
    np.testing.assert_allclose(got['components'], ref.components_,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got['transform'], ref.transform(X),
                               rtol=1e-8, atol=1e-10)
    # D and B split over feat, 32 / 2 columns a rank
    assert got['local_D'] == (4, 16)


def test_ranks_hold_the_same_dictionary(world):
    for name in ('fit', 'windowed(4, 2)', 'wide', 'average'):
        for res in world['all'][1:]:
            np.testing.assert_array_equal(res[name]['components'],
                                          world['rank0'][name]['components'])


def test_dictfact_mesh_odd_batch(world):
    """50 rows in batches of 24: the remainder of 2 rows does not split
    over dp = 8 and runs replicated."""
    got = world['rank0']['odd']
    assert got['n_iter'] == 50
    single = DictFact(device='cpu', **world['cases']['odd']['kw']).fit(
        world['cases']['odd']['X'])
    np.testing.assert_allclose(got['components'], single.components_,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('shape', [(8, 1), (4, 2)])
def test_windowed_fit_under_mesh_matches_single(world, shape):
    got = world['rank0'][f'windowed{shape}']
    assert got['windowed']
    single = DictFact(device='cpu', **WINDOW_KW).fit(
        world['cases'][f'windowed{shape}']['X'])
    assert single._cfg.windowed
    np.testing.assert_allclose(got['components'], single.components_,
                               rtol=1e-5, atol=1e-6)


def test_windowed_fit_falls_back_to_gather_on_a_wide_feat_mesh(world):
    """4 feat shards of (400 + width)-wide storage cannot each hold a
    window: gather subsets, as modl_tpu decides."""
    assert not world['rank0']['windowed(2, 4)']['windowed']
    ref = JaxDictFact(mesh=jax_make_mesh(2, 4), **WINDOW_KW)
    ref._resident_fit = True
    ref.prepare(n_samples=256, X=world['cases']['windowed(2, 4)']['X'])
    assert not ref._cfg.windowed


def test_windowed_fit_under_wide_feat_mesh_matches_single(world):
    got = world['rank0']['wide']
    assert got['windowed']
    single = DictFact(device='cpu', **WIDE_KW).fit(world['cases']['wide'][
        'X'])
    np.testing.assert_allclose(got['components'], single.components_,
                               rtol=1e-5, atol=1e-6)


def test_dictfact_mesh_average_methods(world):
    got = world['rank0']['average']
    X = world['inputs']['X_fit']
    assert got['local_G_avg'] == (120 // 4, 4, 4)      # split over dp
    single = DictFact(device='cpu', **AVG_KW).fit(X)
    for name, want in (('components', single.components_),
                       ('G_average', single.G_average_),
                       ('Dx_average', single.Dx_average_)):
        np.testing.assert_allclose(got[name], want, rtol=1e-10, atol=1e-12,
                                   err_msg=name)
    ref = _jax_fit(AVG_KW, X, (4, 2))
    for name, want in (('components', ref.components_),
                       ('G_average', ref.G_average_),
                       ('Dx_average', ref.Dx_average_)):
        np.testing.assert_allclose(got[name], want, rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_dictfact_mesh_fista_codes_match_single(world):
    """l1 codes by FISTA with the batch's rows split over dp = 2: every
    solve runs a check a call and stops where the whole batch does, so
    the fit is the single-process fit's (which solves in one loop)."""
    got = world['rank0']['fista']
    X = world['inputs']['X_fit']
    assert got['split_solves'] == 2 * 120 // 24
    single = DictFact(device='cpu', **FISTA_KW).fit(X)
    np.testing.assert_allclose(got['components'], single.components_,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got['transform'], single.transform(X),
                               rtol=1e-8, atol=1e-10)
    assert np.count_nonzero(got['transform']) < got['transform'].size


def test_average_offload_on_a_mesh_runs_resident(world):
    got = world['rank0']['offload']
    assert not got['offload']
    # G_avg is split over dp on D's device, never allocated in host RAM
    assert got['host_allocs'] == []
    assert got['G_avg_device'] == got['D_device'] and not got['G_avg_pinned']
    assert got['local_G_avg'] == (30, 4, 4)
    np.testing.assert_array_equal(got['components'],
                                  world['rank0']['average']['components'])


@pytest.mark.parametrize('case', ['fit', 'windowed(4, 2)'])
def test_pickled_mesh_estimator_is_whole_and_single_process(world, case):
    """The mesh is dropped and the state gathered whole (D and B without
    the zero columns a feat split added); the single-process estimator
    goes on as the mesh fit did."""
    got = world['rank0'][case]
    X = world['cases'][case]['X']
    df = pickle.loads(got['pickle'])
    assert df.mesh is None and df._cfg.mesh is None
    assert df._state.layout is None
    n = X.shape[1]
    width = df._cfg.len_max if df._cfg.windowed else 0
    assert df._state.D.shape == (4, n + width)
    np.testing.assert_array_equal(df.components_, got['components'])
    df.partial_fit(X)
    np.testing.assert_allclose(df.components_, got['after_partial_fit'],
                               rtol=1e-5 if width else 1e-10,
                               atol=1e-6 if width else 1e-12)


@pytest.mark.parametrize('case', ['fit', 'windowed(4, 2)'])
def test_set_params_mid_run_on_a_mesh(world, case):
    """``set_params`` on a mesh gathers the state whole, applies the
    mid-run hooks (the Gram upgrade; a new window width re-laid on the
    feat shards) and shards it again: the fit goes on as the
    single-process one does."""
    got = world['rank0'][case]
    c = world['cases'][case]
    single = DictFact(device='cpu', **c['kw']).fit(c['X'])
    single.partial_fit(c['X'])
    single.set_params(**c['then'])
    single.partial_fit(c['X'])
    assert got['windowed_after'] == single._cfg.windowed
    windowed = c['kw'] is WINDOW_KW
    np.testing.assert_allclose(got['after_set_params'], single.components_,
                               rtol=1e-5 if windowed else 1e-10,
                               atol=1e-6 if windowed else 1e-12)


def test_save_state_of_a_mesh_fit_loads_whole(world):
    got = world['rank0']['windowed(4, 2)']
    st = load_state(got['saved'], device='cpu')
    assert st.layout is None
    df = pickle.loads(got['pickle'])
    for name in ('D', 'B', 'code', 'sample_n_iter'):
        assert getattr(st, name).shape == getattr(df._state, name).shape
    np.testing.assert_array_equal(to_np(st.D), to_np(df._state.D))


def test_rank_whose_draws_differ_raises():
    with pytest.raises(RankError, match='disagree on the sampler'):
        spawn(ranks.draws_differ, 2, backend='gloo', device='cpu', timeout=60)


def test_failing_rank_does_not_hang_the_world():
    with pytest.raises(RankError, match='rank 1 gives up'):
        spawn(ranks.dies_before_collective, 2, backend='gloo', device='cpu',
              timeout=60)
