"""The port's image slice against modl_tpu's, on the CPU.

- ``scale_patches``, ``clean_mask``, ``fill``, ``LazyCleanPatchExtractor``
  (with and without missing pixels) and ``make_synthetic_image``, bit for
  bit;
- ``ImageDictFact.fit``: both packages, spied at ``DictFact.partial_fit``
  and ``DictFact.set_params``, receive the same rows and windows and make
  the same parameter changes in the same order, for every schedule;
- ``transform``/``score`` from a carried dictionary (1e-9);
- ``DictionaryScorer``'s fields, and NMF's non-negative codes.
Data is made with numpy from a seed; the JAX package runs on the CPU
with x64 on, the port with ``device='cpu'`` and float64 state.
"""
import numpy as np
import pytest
import torch

import modl_tpu.datasets.image as jdata
import modl_tpu.decomposition.dict_fact as jdf
import modl_tpu.decomposition.image as jimage
import modl_tpu.feature_extraction.image as jfe
import modl_tpu.input_data.image as jin
import modl_tpu_torch.datasets.image as tdata
import modl_tpu_torch.decomposition.dict_fact as tdf
import modl_tpu_torch.decomposition.image as timage
import modl_tpu_torch.feature_extraction.image as tfe
import modl_tpu_torch.input_data.image as tin

KW = dict(n_components=6, batch_size=20, reduction=2, patch_size=(5, 5),
          max_patches=150, alpha=0.1, random_state=0)


def _image(missing=0.0, shape=(30, 34), channels=1):
    return jdata.make_synthetic_image(*shape, n_channels=channels,
                                      patch_size=6,
                                      missing_fraction=missing, seed=3)


@pytest.mark.parametrize('kw', [dict(), dict(channel_wise=False),
                                dict(with_mean=False),
                                dict(with_std=False, copy=False)])
def test_scale_patches_bit_for_bit(kw):
    patches = np.random.RandomState(0).rand(12, 4, 4, 3)
    got = tin.scale_patches(patches.copy(), **kw)
    want = jin.scale_patches(patches.copy(), **kw)
    np.testing.assert_array_equal(got, want)


def test_clean_mask_and_fill_bit_for_bit():
    img = _image(missing=0.02, channels=2)
    patches = jfe.extract_patches(img, (4, 4, 2))
    np.testing.assert_array_equal(tin.clean_mask(patches, img),
                                  jin.clean_mask(patches, img))
    np.testing.assert_array_equal(tin.fill(5, 7, 2), jin.fill(5, 7, 2))
    np.testing.assert_array_equal(tfe.extract_patches(img, (4, 4, 2)),
                                  patches)


@pytest.mark.parametrize('missing', [0.0, 0.01])
def test_patch_extractor_bit_for_bit(missing):
    img = _image(missing=missing)
    got = tfe.LazyCleanPatchExtractor(patch_size=(5, 5), random_state=0,
                                      max_patches=200).fit(img)
    want = jfe.LazyCleanPatchExtractor(patch_size=(5, 5), random_state=0,
                                       max_patches=200).fit(img)
    np.testing.assert_array_equal(got.order_, want.order_)
    assert got.n_patches_ == want.n_patches_
    assert got.patch_shape_ == want.patch_shape_ == (5, 5, 1)
    np.testing.assert_array_equal(got.transform(), want.transform())
    np.testing.assert_array_equal(got.partial_transform(batch=7),
                                  want.partial_transform(batch=7))
    if missing:
        assert np.all(got.transform() != -1)
    perm = np.random.RandomState(1).permutation(got.n_patches_)
    got.shuffle(perm)
    want.shuffle(perm)
    np.testing.assert_array_equal(got.partial_transform(batch=slice(3, 9)),
                                  want.partial_transform(batch=slice(3, 9)))
    got.shuffle()
    want.shuffle()
    np.testing.assert_array_equal(got.order_, want.order_)


@pytest.mark.parametrize('kw', [dict(), dict(n_channels=3, n_atoms=4,
                                             patch_size=5,
                                             missing_fraction=0.05, seed=2)])
def test_make_synthetic_image_bit_for_bit(kw):
    np.testing.assert_array_equal(tdata.make_synthetic_image(40, 36, **kw),
                                  jdata.make_synthetic_image(40, 36, **kw))


@pytest.mark.parametrize('source', ['lisboa', 'aviris', 'unknown'])
def test_load_image_errors(source, monkeypatch, tmp_path):
    monkeypatch.setenv('MODL_DATA', str(tmp_path))
    monkeypatch.delenv('MODL_SHARED_DATA', raising=False)
    err = ValueError if source == 'unknown' else IOError
    with pytest.raises(err):
        tdata.load_image(source)


def _spy(monkeypatch, cls, calls):
    real_fit, real_set = cls.partial_fit, cls.set_params

    def partial_fit(self, X, sample_indices=None):
        calls.append(('partial_fit', np.array(X), sample_indices))
        return real_fit(self, X, sample_indices)

    def set_params(self, **params):
        calls.append(('set_params', params, None))
        return real_set(self, **params)

    monkeypatch.setattr(cls, 'partial_fit', partial_fit)
    monkeypatch.setattr(cls, 'set_params', set_params)


@pytest.mark.parametrize('method,n_epochs', [('masked', 2), ('gram', 5),
                                             ('reducing ratio', 3),
                                             ('sgd', 2)])
def test_fit_feeds_the_same_rows(monkeypatch, method, n_epochs):
    img = _image()
    calls = {'jax': [], 'port': []}
    _spy(monkeypatch, jdf.DictFact, calls['jax'])
    _spy(monkeypatch, tdf.DictFact, calls['port'])
    kw = dict(KW, method=method, n_epochs=n_epochs, buffer_size=40)
    ref = jimage.ImageDictFact(**kw).fit(img)
    port = timage.ImageDictFact(device='cpu', dtype=np.float64, **kw).fit(img)
    assert len(calls['port']) == len(calls['jax'])
    fits = [c for c in calls['port'] if c[0] == 'partial_fit']
    assert len(fits) == n_epochs * 4          # 150 patches, buffers of 40
    for (kind, X, sl), (kind_ref, X_ref, sl_ref) in zip(calls['port'],
                                                        calls['jax']):
        assert kind == kind_ref
        if kind == 'partial_fit':
            assert sl == sl_ref
            np.testing.assert_array_equal(X, X_ref)
        else:
            assert X == X_ref
    if method == 'gram':
        assert ('set_params', dict(G_agg='full', Dx_agg='average'),
                None) in calls['port']
        assert port.dict_fact_.G_ is not None
    assert port.components_.shape == ref.components_.shape == (6, 5, 5, 1)
    assert np.isfinite(port.components_).all()
    assert port.n_iter_ == ref.n_iter_ == n_epochs * 150


@pytest.mark.parametrize('setting', ['dictionary learning', 'NMF'])
def test_transform_and_score_from_carried_dictionary(setting):
    img = _image()
    kw = dict(KW, setting=setting, n_epochs=1)
    ref = jimage.ImageDictFact(**kw).fit(img)
    port = timage.ImageDictFact(device='cpu', dtype=np.float64,
                                **dict(kw, n_epochs=0)).fit(img)
    port.dict_fact_._state.D = torch.as_tensor(
        np.array(ref.dict_fact_.components_))
    np.testing.assert_array_equal(port.components_, ref.components_)
    test = tfe.LazyCleanPatchExtractor(patch_size=(5, 5), max_patches=30,
                                       random_state=1).fit(img).transform()
    np.testing.assert_allclose(port.transform(test), ref.transform(test),
                               rtol=1e-9, atol=1e-9)
    assert port.score(test) == pytest.approx(ref.score(test), rel=1e-9)


def test_nmf_codes_are_non_negative():
    img = _image()
    est = timage.ImageDictFact(setting='NMF', device='cpu', n_epochs=2,
                               **KW).fit(img)
    assert est.dict_fact_._cfg.comp_pos and est.dict_fact_._cfg.code_pos
    assert np.all(est.components_ >= 0)
    test = tfe.LazyCleanPatchExtractor(patch_size=(5, 5), max_patches=30,
                                       random_state=1).fit(img).transform()
    code = est.transform(test)
    assert code.shape == (30, 6) and np.all(code >= 0) and code.any()


def test_dictionary_scorer_fields():
    img = _image()
    test = tfe.LazyCleanPatchExtractor(patch_size=(5, 5), max_patches=30,
                                       random_state=1).fit(img).transform()
    info = {}
    scorer = timage.DictionaryScorer(test, info=info)
    est = timage.ImageDictFact(device='cpu', n_epochs=1, callback=scorer,
                               **KW).fit(img)
    steps = est.n_iter_ // KW['batch_size'] + 1    # 150 = 7 x 20 + 10
    assert len(scorer.score) == len(scorer.iter) == steps
    assert scorer.iter == sorted(scorer.iter) and scorer.iter[0] == 0
    assert len(scorer.time) == len(scorer.cpu_time) == steps
    assert all(np.isfinite(scorer.score))
    assert info['score'] == scorer.score and info['iter'] == scorer.iter
    assert info['time'] == scorer.cpu_time
    with pytest.raises(AttributeError):
        scorer.missing
