"""Checkpoints, pickling and the experiment harness of the port (the
counterpart of ``tests/test_checkpoint.py``), and checkpoints across the
two packages:

- a state saved by ``modl_tpu`` at float64 loads in the port and equals
  ``convert.state_from_jax``'s, its generator seeded from the file's key;
- a state saved by the port loads in ``modl_tpu`` and a JAX fit resumes
  from it.
"""
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from modl_tpu import DictFact as JaxDictFact
from modl_tpu.decomposition._step import SomfState as JaxSomfState
from modl_tpu.decomposition.dict_fact import _state_to_host
from modl_tpu.utils import checkpoint as jckpt
from modl_tpu_torch import (Coder, DictFact, ImageDictFact, RecsysDictFact,
                            convert, fMRIDictFact)
from modl_tpu_torch.datasets.adhd import make_synthetic_rest_data
from modl_tpu_torch.datasets.image import make_synthetic_image
from modl_tpu_torch.decomposition._step import SomfState, seed_from_key
from modl_tpu_torch.utils.checkpoint import (CheckpointCallback,
                                             load_estimator, load_state,
                                             save_estimator, save_state)
from modl_tpu_torch.utils.experiment import Experiment

KW = dict(n_components=4, reduction=2, code_alpha=1e-3, comp_l1_ratio=0,
          batch_size=20, random_state=0)
TENSORS = ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg', 'G_avg',
           'sample_n_iter', 'box')


def _fit_small(**kw):
    X = np.random.RandomState(0).randn(60, 24)
    df = DictFact(**dict(KW, n_epochs=2, device='cpu', **kw)).fit(X)
    return df, X


def _assert_states_equal(a, b):
    for name in TENSORS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name
    assert (a.n_iter, a.cursor) == (b.n_iter, b.cursor)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def test_estimator_pickle_roundtrip(tmp_path):
    df, X = _fit_small()
    path = save_estimator(df, str(tmp_path / 'est.pkl'))
    df2 = load_estimator(path)
    _assert_states_equal(df2._state, df._state)
    np.testing.assert_array_equal(df.components_, df2.components_)
    np.testing.assert_array_equal(df.transform(X), df2.transform(X))


@pytest.mark.parametrize('agg', ['masked', 'average'])
@pytest.mark.parametrize('offload', [False, True])
def test_pickle_then_resume_training(agg, offload):
    """A pickled estimator resumes where the original goes on, bit for
    bit (its generator's state rides along), offloaded or not."""
    df, X = _fit_small(Dx_agg=agg, G_agg=agg, average_offload=offload)
    twin = pickle.loads(pickle.dumps(df))
    n_before = twin.n_iter_
    for est in (df, twin):
        est.partial_fit(X)
    assert twin.n_iter_ == n_before + X.shape[0]
    _assert_states_equal(twin._state, df._state)


def test_state_save_load_npz(tmp_path):
    df, X = _fit_small()
    path = save_state(df._state, str(tmp_path / 'state'))
    assert path.endswith('.npz')
    restored = load_state(path, SomfState, device='cpu')
    _assert_states_equal(restored, df._state)
    # fields absent from the run (G_avg in masked mode) stay None
    assert restored.G_avg is None and restored.Dx_avg is None
    with np.load(path) as data:
        assert data['key'].dtype == np.uint32 and data['key'].shape == (2,)
        assert data['gen_state'].dtype == np.uint8
        assert data['n_iter'].dtype == np.int32


def test_state_resume_trajectory_identical(tmp_path):
    """Checkpoint-restart reproduces the uninterrupted trajectory."""
    X = np.random.RandomState(0).randn(80, 24)
    df = DictFact(**KW, device='cpu').prepare(n_samples=80, X=X)
    df.partial_fit(X)
    path = save_state(df._state, str(tmp_path / 'mid.npz'))
    df.partial_fit(X)
    df2 = DictFact(**KW, device='cpu').prepare(n_samples=80, X=X)
    df2._state = load_state(path, device='cpu')
    df2.partial_fit(X)
    np.testing.assert_array_equal(df2.components_, df.components_)
    _assert_states_equal(df2._state, df._state)


def test_offloaded_state_resumes_from_a_checkpoint(tmp_path):
    """A checkpoint of an offloaded fit resumes bit for bit, offloaded or
    resident: ``load_state`` leaves ``G_avg`` in host RAM and the next
    ``partial_fit`` places it where the estimator's configuration keeps
    it."""
    X = np.random.RandomState(1).randn(80, 24)
    kw = dict(KW, Dx_agg='average', G_agg='average', device='cpu')
    df = DictFact(**kw, average_offload=True).prepare(n_samples=80, X=X)
    df.partial_fit(X)
    path = save_state(df._state, str(tmp_path / 'off.npz'))
    df.partial_fit(X)
    for offload in (False, True):
        df2 = DictFact(**kw, average_offload=offload).prepare(n_samples=80,
                                                              X=X)
        df2._state = load_state(path, device='cpu')
        assert df2._state.G_avg.device.type == 'cpu'
        df2.partial_fit(X)
        _assert_states_equal(df2._state, df._state)


def test_all_estimators_pickle():
    """Every public estimator pickles after fit and keeps predicting."""
    rng = np.random.RandomState(0)

    img = make_synthetic_image(24, 24, patch_size=6, seed=0)
    idf = ImageDictFact(method='masked', n_components=4, batch_size=20,
                        reduction=2, n_epochs=1, patch_size=(5, 5),
                        max_patches=80, random_state=0,
                        device='cpu').fit(img)
    idf2 = pickle.loads(pickle.dumps(idf))
    np.testing.assert_array_equal(idf2.components_, idf.components_)
    assert idf2.dict_fact_.callback.__self__ is idf2

    Xr = sp.csr_matrix(np.abs(rng.rand(30, 12)))
    mf = RecsysDictFact(n_components=3, n_epochs=1, alpha=0.5,
                        random_state=0, device='cpu').fit(Xr)
    mf2 = pickle.loads(pickle.dumps(mf))
    assert torch.is_tensor(mf2._D)
    np.testing.assert_array_equal(mf2.components_, mf.components_)
    assert mf2.score(Xr) == mf.score(Xr)

    data, mask, _ = make_synthetic_rest_data(n_subjects=2, n_frames=15,
                                             shape=(5, 5, 3),
                                             n_networks=3)
    fdf = fMRIDictFact(method='masked', n_components=3, reduction=2,
                       batch_size=5, n_epochs=1, alpha=1e-2, mask=mask,
                       standardize=False, detrend=False, random_state=0,
                       device='cpu').fit(data)
    fdf2 = pickle.loads(pickle.dumps(fdf))
    np.testing.assert_array_equal(fdf2.components_, fdf.components_)
    _assert_states_equal(fdf2.dict_fact_._state, fdf.dict_fact_._state)
    codes = fdf2.transform(data[:1])
    assert codes[0].shape == (15, 3)

    coder = Coder(fdf.components_, code_alpha=1e-2, device='cpu')
    coder2 = pickle.loads(pickle.dumps(coder))
    X = data[0].reshape(-1, 15).T
    np.testing.assert_array_equal(coder2.transform(X), coder.transform(X))


@pytest.mark.parametrize('make', ['dict_fact', 'coder', 'fmri'])
def test_pickled_cuda_estimator_needs_a_card(make):
    """An estimator pickled with ``device='cuda'`` loads onto the card or
    raises; it is not moved to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('needs a machine without a CUDA device')
    df, _ = _fit_small()
    est = {'dict_fact': df,
           'coder': Coder(df.components_, device='cpu'),
           'fmri': fMRIDictFact(n_components=4, device='cpu')}[make]
    est.device = 'cuda'
    blob = pickle.dumps(est)
    with pytest.raises(RuntimeError, match='no CUDA'):
        pickle.loads(blob)


def test_state_carriers_default_to_the_card(monkeypatch):
    """``convert.state_from_jax`` and ``recsys_state_from_jax`` carry a
    state onto the card unless the caller asks for the CPU: without a
    card their default raises in ``_resolve_device``, never lands on the
    CPU."""
    import inspect
    for fn in (convert.state_from_jax, convert.recsys_state_from_jax):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    df = JaxDictFact(**KW).prepare(n_samples=60, X=np.random.RandomState(
        0).randn(60, 24))
    host = _state_to_host(df._state)
    recsys = {name: host[name] for name in ('D', 'C', 'B', 'code',
                                            'comp_norm')}
    recsys.update(feature_n_iter=np.zeros(24, np.int32), n_iter=0)
    asked = []

    def spy(device):
        asked.append(str(device))
        return resolve(device)

    resolve = convert._resolve_device
    monkeypatch.setattr(convert, '_resolve_device', spy)
    for fn, state in ((convert.state_from_jax, host),
                      (convert.recsys_state_from_jax, recsys)):
        if torch.cuda.is_available():
            assert fn(state) is not None
        else:
            with pytest.raises(RuntimeError, match='no CUDA'):
                fn(state)
        assert fn(state, device='cpu') is not None
    assert asked == ['cuda', 'cpu'] * 2


def test_checkpoint_callback(tmp_path):
    X = np.random.RandomState(0).randn(60, 24)
    path = str(tmp_path / 'ckpt.npz')
    cb = CheckpointCallback(path, every=1)
    df = DictFact(n_components=4, reduction=2, batch_size=20, verbose=3,
                  n_epochs=2, random_state=0, callback=cb, device='cpu')
    df.fit(X)
    assert cb.n_saved >= 1
    restored = load_state(path, SomfState, device='cpu')
    assert restored.D.shape == (4, 24)


def test_experiment_harness(tmp_path):
    exp = Experiment('toy', output_dir=str(tmp_path))

    @exp.config
    def config():
        return dict(a=1, b='x')

    @exp.main
    def main(a, b, _run):
        _run.info['score'] = np.float64(a * 2)
        return a * 2

    run = exp.run(config_updates={'a': 3})
    assert run.info['score'] == 6
    assert os.path.exists(os.path.join(run.dir, 'config.json'))
    assert os.path.exists(os.path.join(run.dir, 'info.json'))
    rows = Experiment.gather(str(tmp_path))
    assert rows[0]['config']['a'] == 3
    assert rows[0]['run']['status'] == 'COMPLETED'
    assert rows[0]['info']['score'] == 6.0
    run2 = exp.run()
    assert run2.id == run.id + 1


def _jax_fit(**kw):
    X = np.random.RandomState(3).randn(60, 24)
    df = JaxDictFact(**dict(KW, Dx_agg='average', G_agg='average', **kw))
    df.prepare(n_samples=60, X=X)
    df.partial_fit(X)
    return df, X


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    df, _ = _jax_fit()
    path = jckpt.save_state(df._state, str(tmp_path / 'jax.npz'))
    with pytest.warns(UserWarning, match='seeded from its key'):
        st = load_state(path, device='cpu')
    host = _state_to_host(df._state)
    ref = convert.state_from_jax(host, device='cpu',
                                 seed=seed_from_key(host['key']))
    assert st.D.dtype == torch.float64
    _assert_states_equal(st, ref)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    X = np.random.RandomState(3).randn(60, 24)
    kw = dict(KW, Dx_agg='average', G_agg='average')
    port = DictFact(**kw, device='cpu').prepare(n_samples=60, X=X)
    port.partial_fit(X)
    path = save_state(port._state, str(tmp_path / 'port.npz'))
    st = jckpt.load_state(path, JaxSomfState)
    saved = port._state
    for name in ('D', 'C', 'B', 'comp_norm', 'code', 'Dx_avg', 'G_avg',
                 'sample_n_iter', 'box'):
        np.testing.assert_array_equal(np.asarray(getattr(st, name)),
                                      getattr(saved, name).numpy(),
                                      err_msg=name)
    assert int(st.n_iter) == saved.n_iter and int(st.cursor) == \
        saved.cursor
    df = JaxDictFact(**kw).prepare(n_samples=60, X=X)
    df._state = st
    df.partial_fit(X)
    assert df.n_iter_ == 2 * X.shape[0]
    assert np.isfinite(df.components_).all()

