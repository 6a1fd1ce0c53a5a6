"""The port's fMRI slice against modl_tpu's, on the CPU.

- host maskers: ``NumpyMasker`` (detrend, standardize, Butterworth,
  confounds, feature order; 1e-10 at float64), ``MultiRawMasker``, and
  ``.npy`` manifests written by one package and read by the other;
- ``_clean_device`` against the JAX one for the four flag settings;
- the streaming driver: both packages, spied at
  ``DictFact._partial_fit_device`` over the same pre-permuted records,
  receive the same rows (1e-10) and sample indices (exact), on the raw
  and the host path, and leave the shared host ``RandomState`` in the
  same place;
- tests/test_fmri.py's planted-maps recovery for every method, 'sgd'
  and 'reducing ratio' on a pre-permuted pipeline included;
- the record cache (hits, misses, same trajectory without it, LRU);
- ``fMRICoder`` transform and score against the JAX one (1e-9).
Data is made with numpy from a seed; the JAX package runs on the CPU
with x64 on, the port with ``device='cpu'``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import modl_tpu.decomposition.dict_fact as jdf
import modl_tpu.decomposition.fmri as jfmri
import modl_tpu.input_data.fmri as jin
import modl_tpu_torch.decomposition.dict_fact as tdf
import modl_tpu_torch.decomposition.fmri as tfmri
import modl_tpu_torch.input_data.fmri as tin
from modl_tpu_torch import convert
from torch_parity import to_np

METHODS = ['masked', 'dictionary only', 'gram', 'average', 'reducing ratio',
           'sgd']


def _make_components(shape=(20, 20, 1)):
    components = np.zeros((4,) + shape)
    components[0, :5, :10, 0] = 1
    components[0, 5:10, :10, 0] = -1
    components[1, :5, -10:, 0] = 1
    components[1, 5:10, -10:, 0] = -1
    components[2, -5:, -10:, 0] = 1
    components[2, -10:-5, -10:, 0] = -1
    components[3, -5:, :10, 0] = 1
    components[3, -10:-5, :10, 0] = -1
    return components


def _make_dataset(n_subjects=8, n_frames=40, shape=(20, 20, 1), seed=0):
    """tests/test_fmri.py's planted dataset: 4 signed regions."""
    rng = np.random.RandomState(seed)
    components = _make_components(shape)
    flat = components.reshape(4, -1)
    data = []
    for _ in range(n_subjects):
        X = rng.randn(n_frames, 4) @ flat \
            + rng.randn(n_frames, flat.shape[1]) * 0.01
        data.append(X.T.reshape(shape + (n_frames,)))
    mask = np.ones(shape, dtype=bool)
    init = flat + rng.randn(*flat.shape)
    return data, mask, components, init


def _recovered_maps(est_components, true_components):
    flat_true = true_components.reshape(4, -1)
    D = est_components / (np.sqrt(np.sum(est_components ** 2,
                                         axis=1))[:, None] + 1e-30)
    Q = flat_true / np.sqrt(np.sum(flat_true ** 2, axis=1))[:, None]
    G = np.abs(D @ Q.T)
    return min(np.sum(np.any(G > 0.95, axis=1)),
               np.sum(np.any(G > 0.95, axis=0)))


def _prepermuted(tmp_path, module, dtype=np.float64, feature_order=7):
    data, mask, components, init = _make_dataset(n_subjects=4)
    module.create_raw_rest_data(data, mask, str(tmp_path), standardize=False,
                                detrend=False, feature_order=feature_order,
                                dtype=dtype)
    return data, mask, components


# --------------------------------------------------------------------- #
# host maskers
# --------------------------------------------------------------------- #

MASKER_CASES = [
    dict(),
    dict(detrend=True),
    dict(standardize=True, detrend=True),
    dict(low_pass=0.2, high_pass=0.03, t_r=1.0),
    dict(low_pass=0.2, t_r=2.0, standardize=True),
    dict(high_pass=0.05, t_r=1.0, detrend=True),
    dict(detrend=True, feature_order=3),
    dict(standardize=True, feature_order=np.arange(60)[::-1].copy()),
]


@pytest.mark.parametrize('confounds', [False, True])
@pytest.mark.parametrize('params', MASKER_CASES)
def test_numpy_masker_matches_jax(params, confounds):
    rng = np.random.RandomState(0)
    data = rng.randn(4, 5, 3, 50) * 2 + rng.randn(4, 5, 3, 1)
    mask = rng.rand(4, 5, 3) > 0.0
    conf = rng.randn(50, 3) if confounds else None
    ref = jin.NumpyMasker(mask_img=mask, **params).fit()
    port = tin.NumpyMasker(mask_img=mask, **params).fit()
    np.testing.assert_array_equal(port.mask_img_, ref.mask_img_)
    if ref.feature_order_ is None:
        assert port.feature_order_ is None
    else:
        np.testing.assert_array_equal(port.feature_order_,
                                      ref.feature_order_)
    want = ref.transform(data, confounds=conf)
    np.testing.assert_allclose(port.transform(data, confounds=conf), want,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(port.transform_raw(data),
                                  ref.transform_raw(data))
    # 2-D records, stored in order or not
    rec = ref.transform_raw(data)
    for raw_in_order in (True, False):
        ref.raw_in_order = port.raw_in_order = raw_in_order
        np.testing.assert_allclose(port.transform(rec, confounds=conf),
                                   ref.transform(rec, confounds=conf),
                                   rtol=1e-10, atol=1e-10)
    comps = rng.randn(3, port.n_voxels_)
    np.testing.assert_array_equal(port.inverse_transform(comps),
                                  ref.inverse_transform(comps))
    # the converter carries a fitted JAX masker over
    conv = convert.masker_from_jax(ref)
    np.testing.assert_array_equal(conv.transform_raw(data),
                                  ref.transform_raw(data))
    assert conv.get_params().keys() == port.get_params().keys()


@pytest.mark.parametrize('detrend', [False, True])
@pytest.mark.parametrize('standardize', [False, True])
def test_multi_raw_masker_matches_jax(tmp_path, detrend, standardize):
    rng = np.random.RandomState(1)
    mask = np.ones((6, 5, 1), bool)
    vol = rng.randn(6, 5, 1, 30)
    rec = rng.randn(30, 30) + np.arange(30)[:, None] * 0.1
    path = str(tmp_path / 'rec.npy')
    np.save(path, rec)
    kw = dict(detrend=detrend, standardize=standardize)
    ref = jin.MultiRawMasker(mask_img=mask, **kw).fit()
    port = tin.MultiRawMasker(mask_img=mask, **kw).fit()
    assert port.n_voxels_ == ref.n_voxels_ == 30
    for img in (vol, rec, path):
        np.testing.assert_allclose(port.transform(img), ref.transform(img),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(port.transform_raw(img),
                                      ref.transform_raw(img))
    outs = port.transform([rec, path])
    assert len(outs) == 2
    comps = rng.randn(2, 30)
    np.testing.assert_array_equal(port.inverse_transform(comps),
                                  ref.inverse_transform(comps))


def test_non_npy_inputs_raise_without_nilearn():
    masker = tin.MultiRawMasker(mask_img=np.ones((2, 2, 1), bool)).fit()
    with pytest.raises(ValueError, match='requires nilearn'):
        masker.transform('subject.nii.gz')
    with pytest.raises(ValueError, match='without nibabel/nilearn'):
        tin.NumpyMasker(mask_img=np.ones((2, 2, 1), bool)).fit().transform(
            'subject.nii')
    # a NIfTI record is scanned through nilearn, as in the JAX package
    for module in (tfmri, jfmri):
        with pytest.raises(ImportError, match='nilearn'):
            module._lazy_scan(['subject.nii.gz'])


@pytest.mark.parametrize('writer,reader', [(tin, jin), (jin, tin)])
@pytest.mark.parametrize('feature_order', [None, 5])
def test_manifests_cross_packages(tmp_path, writer, reader, feature_order):
    data, mask, _, _ = _make_dataset(n_subjects=3)
    data[1] = 'missing.npy'                  # a record that fails
    writer.create_raw_rest_data(data, mask, str(tmp_path),
                                feature_order=feature_order)
    assert (tmp_path / 'record_1-error').is_file()
    masker, records = reader.get_raw_rest_data(str(tmp_path))
    other, records2 = writer.get_raw_rest_data(str(tmp_path))
    assert records == records2 and len(records) == 2
    if feature_order is None:
        assert masker.feature_order_ is None
    else:
        np.testing.assert_array_equal(masker.feature_order_,
                                      other.feature_order_)
    ref = writer.NumpyMasker(mask_img=mask, standardize=True, detrend=True,
                             feature_order=feature_order).fit()
    np.testing.assert_allclose(masker.transform(records[1]),
                               ref.transform(data[2]).astype(np.float32),
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# device cleaning
# --------------------------------------------------------------------- #

@pytest.mark.parametrize('detrend', [False, True])
@pytest.mark.parametrize('standardize', [False, True])
def test_clean_device_matches_jax(detrend, standardize):
    rng = np.random.RandomState(0)
    raw = rng.randn(50, 201) * 3 + rng.randn(1, 201)
    want = np.asarray(jfmri._clean_device(jnp.asarray(raw), detrend,
                                          standardize, np.float64))
    got = tfmri._clean_device(torch.tensor(raw), detrend, standardize,
                              torch.float64)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-10, atol=1e-10)
    host = tin.NumpyMasker(mask_img=np.ones((201, 1, 1), bool),
                           detrend=detrend, standardize=standardize).fit()
    np.testing.assert_allclose(to_np(got), host.transform(raw),
                               rtol=1e-10, atol=1e-10)


def test_clean_device_casts_float16_records():
    rng = np.random.RandomState(0)
    raw = (rng.randn(40, 64) * 2).astype(np.float16)
    got = tfmri._clean_device(torch.tensor(raw), True, True, torch.float32)
    want = np.asarray(jfmri._clean_device(jnp.asarray(raw), True, True,
                                          np.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# the streaming driver
# --------------------------------------------------------------------- #

def _spy(monkeypatch, cls, calls):
    real = cls._partial_fit_device

    def spy(self, X_dev, sample_indices, ingested=False):
        calls.append((np.array(to_np(X_dev)),
                      None if sample_indices is None
                      else np.array(sample_indices)))
        return real(self, X_dev, sample_indices, ingested=ingested)

    monkeypatch.setattr(cls, '_partial_fit_device', spy)


class _JaxHostOnly(jin.NumpyMasker):
    transform_raw = property()    # hidden: the driver takes the host path


class _PortHostOnly(tin.NumpyMasker):
    transform_raw = property()


@pytest.mark.parametrize('path', ['raw', 'host'])
@pytest.mark.parametrize('method', ['masked', 'average'])
def test_driver_feeds_the_same_rows(tmp_path, monkeypatch, method, path):
    _prepermuted(tmp_path, jin)
    jmask, records = jin.get_raw_rest_data(str(tmp_path))
    jmask.detrend = jmask.standardize = True
    pmask = convert.masker_from_jax(jmask)
    if path == 'host':
        jmask = _JaxHostOnly(**jmask.get_params()).fit()
        pmask = _PortHostOnly(**pmask.get_params()).fit()
    kw = dict(method=method, n_components=4, reduction=4, batch_size=10,
              n_epochs=2, alpha=1e-3, standardize=True, detrend=True)
    calls = {'jax': [], 'port': []}
    _spy(monkeypatch, jdf.DictFact, calls['jax'])
    _spy(monkeypatch, tdf.DictFact, calls['port'])
    rs = {'jax': np.random.RandomState(0), 'port': np.random.RandomState(0)}
    ref = jfmri.fMRIDictFact(mask=jmask, random_state=rs['jax'], **kw)
    ref.fit(records)
    port = tfmri.fMRIDictFact(mask=pmask, random_state=rs['port'],
                              device='cpu', **kw)
    port.fit(records)
    assert port.dict_fact_._cfg.windowed == ref.dict_fact_._cfg.windowed
    assert port.dict_fact_._cfg.windowed
    assert len(calls['port']) == len(calls['jax']) == 2 * len(records)
    for (X, idx), (X_ref, idx_ref) in zip(calls['port'], calls['jax']):
        np.testing.assert_allclose(X, X_ref, rtol=1e-10, atol=1e-10)
        if idx_ref is None:
            assert idx is None and method == 'masked'
        else:
            np.testing.assert_array_equal(idx, idx_ref)
    # the same draws from the shared host RandomState, in the same order
    s_port, s_ref = rs['port'].get_state(), rs['jax'].get_state()
    np.testing.assert_array_equal(s_port[1], s_ref[1])
    assert s_port[2] == s_ref[2]
    assert np.isfinite(port.components_).all()
    assert port.components_.shape == ref.components_.shape == (4, 400)
    assert port.io_time_ >= 0 and port.cpu_time_ > 0


@pytest.mark.parametrize('method', METHODS)
def test_recovers_planted_maps(method):
    data, mask, components, init = _make_dataset()
    fd = tfmri.fMRIDictFact(method=method, n_components=4, reduction=2,
                            batch_size=20, n_epochs=2, alpha=1,
                            dict_init=init, mask=mask, standardize=False,
                            detrend=False, random_state=0, device='cpu')
    fd.fit(data)
    assert fd.components_.shape == (4, 400)
    assert _recovered_maps(fd.components_, components) >= 4
    assert fd.components_img_.shape == (20, 20, 1, 4)
    for comp in fd.components_:                   # sign flip
        assert np.sum(comp > 0) >= np.sum(comp < 0)


def test_reducing_ratio_on_prepermuted_pipeline(tmp_path):
    _, _, components = _prepermuted(tmp_path, tin, dtype=np.float32,
                                    feature_order=11)
    masker, records = tin.get_raw_rest_data(str(tmp_path))
    fd = tfmri.fMRIDictFact(method='reducing ratio', n_components=4,
                            reduction=4, batch_size=10, n_epochs=3,
                            alpha=1e-3, mask=masker, standardize=False,
                            detrend=False, random_state=0, device='cpu')
    fd.fit(records)
    maps = np.moveaxis(fd.components_img_, -1, 0).reshape(4, -1)
    assert _recovered_maps(maps, components) >= 4


def test_float16_records_fit_in_float32(tmp_path, monkeypatch):
    _prepermuted(tmp_path, tin, dtype=np.float16)
    masker, records = tin.get_raw_rest_data(str(tmp_path))
    masker.detrend = masker.standardize = True
    calls = []
    _spy(monkeypatch, tdf.DictFact, calls)
    fd = tfmri.fMRIDictFact(n_components=4, reduction=2, batch_size=10,
                            n_epochs=2, mask=masker, random_state=0,
                            device='cpu')
    fd.fit(records)
    assert fd.dict_fact_._dtype == np.float32
    assert all(X.dtype == np.float32 for X, _ in calls)
    assert fd.record_cache_info_['hits'] == len(records)
    assert fd.record_cache_info_['resident_bytes'] == sum(
        np.load(r).nbytes for r in records)
    assert np.isfinite(fd.components_).all()


def test_record_cache(tmp_path, monkeypatch):
    data, mask, _, _ = _make_dataset(n_subjects=3)
    tin.create_raw_rest_data(data, mask, str(tmp_path), standardize=False,
                             detrend=False)
    masker, records = tin.get_raw_rest_data(str(tmp_path))

    def run():
        fd = tfmri.fMRIDictFact(method='masked', n_components=4, reduction=2,
                                batch_size=10, n_epochs=3, alpha=1e-3,
                                mask=masker, standardize=False,
                                detrend=False, random_state=0, device='cpu')
        return fd.fit(records)

    cached = run()
    info = cached.record_cache_info_
    assert info['misses'] == len(records)
    assert info['hits'] == 2 * len(records)
    assert info['resident_bytes'] == 3 * 40 * 400 * 4

    monkeypatch.setattr(tfmri, 'RECORD_CACHE_BYTES', 0)
    off = run()
    assert not hasattr(off, 'record_cache_info_')
    np.testing.assert_array_equal(cached.components_, off.components_)

    one_record = 40 * 400 * np.dtype(np.float32).itemsize
    monkeypatch.setattr(tfmri, 'RECORD_CACHE_BYTES', one_record + 1)
    small = run()
    info = small.record_cache_info_
    assert info['resident_bytes'] <= one_record + 1
    assert info['misses'] > len(records)
    np.testing.assert_array_equal(small.components_, off.components_)


def test_record_cache_evicts_least_recently_used():
    cache = tfmri._RecordCache(30)
    for key in range(3):
        cache.put(key, torch.zeros(key + 1), 10)
    assert cache.get(0) is not None            # 0 becomes most recent
    cache.put(3, torch.zeros(1), 10)           # evicts 1, the oldest
    assert cache.get(1) is None and cache.get(2) is not None
    cache.put(4, torch.zeros(1), 31)           # over budget: not kept
    assert cache.get(4) is None
    assert (cache.hits, cache.misses, cache.nbytes) == (2, 2, 30)


# --------------------------------------------------------------------- #
# coding, scoring, callbacks
# --------------------------------------------------------------------- #

def test_coder_matches_jax():
    data, mask, components, _ = _make_dataset(n_subjects=3)
    flat = components.reshape(4, -1)
    kw = dict(dictionary=flat, mask=mask, alpha=1e-2, standardize=True,
              detrend=True)
    ref = jfmri.fMRICoder(**kw).fit()
    port = tfmri.fMRICoder(device='cpu', **kw).fit()
    for got, want in zip(port.transform(data), ref.transform(data)):
        assert got.shape == (40, 4)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert port.score(data) == pytest.approx(ref.score(data), rel=1e-9)
    np.testing.assert_array_equal(port.components_img_,
                                  ref.components_img_)


def test_scorer_callback_and_fitted_transform():
    data, mask, _, _ = _make_dataset(n_subjects=4)
    scorer = tfmri.rfMRIDictionaryScorer(test_imgs=data[:2])
    fd = tfmri.fMRIDictFact(method='masked', n_components=4, reduction=2,
                            batch_size=10, n_epochs=2, alpha=1e-3, mask=mask,
                            standardize=False, detrend=False, random_state=0,
                            verbose=4, callback=scorer, device='cpu')
    fd.fit(data)
    assert len(scorer.score) >= 1
    assert all(np.isfinite(s) for s in scorer.score)
    codes = fd.transform(data[:2])
    assert len(codes) == 2 and codes[0].shape == (40, 4)
    assert np.isfinite(fd.score(data[:2]))


def test_embedded_masker_conflict_warning():
    mask = np.ones((4, 4, 1), bool)
    provided = tin.NumpyMasker(mask_img=mask, standardize=False,
                               detrend=True, t_r=2.0).fit()
    est = tfmri.fMRIDictFact(mask=provided, standardize=True, detrend=False,
                             n_components=2, memory_level=3, device='cpu')
    with pytest.warns(UserWarning, match='Overriding'):
        masker = tin.check_embedded_masker(est)
    assert masker.standardize is False and masker.detrend is True
    assert masker.t_r == 2.0 and masker.memory_level == 2
    assert hasattr(masker, 'mask_img_')



def test_scorer_artifacts_need_no_joblib(tmp_path, monkeypatch):
    """With ``artifact_dir`` the scorer saves the flipped components and
    ``info``, as the JAX one does, where joblib cannot be imported (the
    card's machine has none); ``info.pkl`` loads with pickle and with
    ``joblib.load``."""
    import pickle

    import joblib
    data, mask, _, _ = _make_dataset(n_subjects=3)
    info = {}
    scorer = tfmri.rfMRIDictionaryScorer(test_imgs=data[:1], info=info,
                                         artifact_dir=str(tmp_path))
    fd = tfmri.fMRIDictFact(method='masked', n_components=4, reduction=2,
                            batch_size=10, n_epochs=1, alpha=1e-3, mask=mask,
                            standardize=False, detrend=False, random_state=0,
                            verbose=2, callback=scorer, device='cpu')
    monkeypatch.setitem(__import__('sys').modules, 'joblib', None)
    fd.fit(data[1:])
    monkeypatch.undo()
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert 'info.pkl' in saved and any(
        name.startswith('components_') for name in saved)
    with open(tmp_path / 'info.pkl', 'rb') as f:
        assert pickle.load(f) == info == joblib.load(tmp_path / 'info.pkl')
    assert info['score'] == scorer.score and info['iter'] == scorer.iter
    last = np.load(tmp_path / f'components_{scorer.iter[-1]}.npy')
    assert last.shape == (4, 400)
