"""The port's NIfTI path against modl_tpu's, under the same stand-ins.

Neither nibabel nor nilearn is installed here, so both packages run
their NIfTI branches against the in-process fakes of
``tests/test_nifti_mocked.py`` (``FakeNifti1Image``,
``FakeMultiNiftiMasker``, installed in ``sys.modules``) and, for
``fetch_adhd``, of ``tests/test_datasets_mocked.py``. ``NiftiMasker``
below adds what a fit needs to the fake masker: a C-order
mask-and-flatten ``transform`` with detrend/standardize, and an
``inverse_transform`` that records what it was given.

Tolerances: fixes (pickle round trip, token hashes) and loads are exact;
the rows and indices the fits feed to ``_partial_fit_device`` 1e-10 at
float64 (indices exact); ``components_img_`` of the same components
1e-12;
``fMRICoder.transform`` 1e-9. Every global a test patches (joblib's
hash, ``nibabel.load``, nilearn's loader, the fixes' class cache, the
maskers' nilearn flags) is restored after it.
"""
import contextlib
import pickle
import sys
import types

import numpy as np
import pytest

import modl_tpu.datasets.adhd as jadhd
import modl_tpu.decomposition.dict_fact as jdf
import modl_tpu.decomposition.fmri as jfmri
import modl_tpu.input_data.fmri.base as jbase
import modl_tpu.input_data.fmri.fixes as jfixes
import modl_tpu.input_data.fmri.unmask as junmask
import modl_tpu_torch.datasets.adhd as tadhd
import modl_tpu_torch.decomposition.dict_fact as tdf
import modl_tpu_torch.decomposition.fmri as tfmri
import modl_tpu_torch.input_data.fmri.base as tbase
import modl_tpu_torch.input_data.fmri.fixes as tfixes
import modl_tpu_torch.input_data.fmri.unmask as tunmask
from test_datasets_mocked import _install_fake_nilearn_datasets
from test_nifti_mocked import FakeMultiNiftiMasker, FakeNifti1Image
from test_torch_fmri import _spy

PACKAGES = {'jax': (jbase, jfixes, jfmri, junmask),
            'port': (tbase, tfixes, tfmri, tunmask)}


def _data(img):
    from nilearn._utils import check_niimg
    return np.asanyarray(check_niimg(img).dataobj)


class NiftiMasker(FakeMultiNiftiMasker):
    """The fake masker with a transform: mask in C order, then nilearn's
    detrend (mean and linear trend) and standardize, in float64; and an
    inverse transform to a 4-D image, which records the types it got."""

    received = []

    def _mask(self):
        return _data(self.mask_img_) != 0

    def transform_single_imgs(self, imgs, confounds=None):
        out = _data(imgs)[self._mask()].T.astype(np.float64)
        if self.detrend:
            out = out - out.mean(0)
            t = np.arange(out.shape[0]) - (out.shape[0] - 1) / 2
            out = out - np.outer(t, t @ out / (t @ t))
        if self.standardize:
            out = out - out.mean(0)
            std = out.std(0)
            out = out / np.where(std == 0, 1, std)
        return out

    def transform(self, imgs, confounds=None):
        if isinstance(imgs, (list, tuple)):
            return [self.transform_single_imgs(img) for img in imgs]
        return self.transform_single_imgs(imgs, confounds)

    def inverse_transform(self, components):
        NiftiMasker.received.append(type(components))
        mask = self._mask()
        vol = np.zeros(mask.shape + (components.shape[0],))
        vol[mask] = components.T
        return FakeNifti1Image(vol, np.eye(4))


class SavableImage(FakeNifti1Image):
    """A fake image whose save updates its header in place, as nibabel's
    may."""

    def to_filename(self, filename):
        self.header = {'saved': filename}
        np.save(filename, np.asarray(self._dataobj))


@contextlib.contextmanager
def nifti_fakes():
    """Fake nibabel and nilearn modules, and both packages' nilearn flags
    set to them; every global restored on exit."""
    from joblib import hashing, memory
    mp = pytest.MonkeyPatch()
    try:
        def fake_load(filename, **kwargs):
            img = FakeNifti1Image(np.load(filename), np.eye(4))
            img.set_filename(str(filename))
            return img

        def check_niimg(img):
            return img if isinstance(img, FakeNifti1Image) \
                else fake_load(img)

        nibabel = types.ModuleType('nibabel')
        nibabel.Nifti1Image = FakeNifti1Image
        nibabel.load = fake_load
        nilearn = types.ModuleType('nilearn')
        nl_utils = types.ModuleType('nilearn._utils')
        nl_utils.check_niimg = check_niimg
        nl_niimg = types.ModuleType('nilearn._utils.niimg')
        nl_niimg.load_niimg = lambda niimg_in, dtype=None: check_niimg(
            niimg_in)
        nl_cache = types.ModuleType('nilearn._utils.cache_mixin')

        def _wiping_safe_cache(memory, func, **kwargs):
            raise AssertionError('cache wiped')

        nl_cache._safe_cache = _wiping_safe_cache
        nl_input = types.ModuleType('nilearn.input_data')
        nl_input.MultiNiftiMasker = NiftiMasker
        nl_utils.niimg, nl_utils.cache_mixin = nl_niimg, nl_cache
        nilearn._utils, nilearn.input_data = nl_utils, nl_input
        for name, mod in (('nibabel', nibabel), ('nilearn', nilearn),
                          ('nilearn._utils', nl_utils),
                          ('nilearn._utils.niimg', nl_niimg),
                          ('nilearn._utils.cache_mixin', nl_cache),
                          ('nilearn.input_data', nl_input)):
            mp.setitem(sys.modules, name, mod)
        for base, fixes, _, _ in PACKAGES.values():
            mp.setattr(base, 'HAS_NILEARN', True)
            mp.setattr(base, 'MultiNiftiMasker', NiftiMasker, raising=False)
            mp.setattr(fixes, '_PICKLABLE_CACHE', None)
            mp.delitem(fixes.__dict__, 'Nifti1Image', raising=False)
        mp.setattr(hashing, 'hash', hashing.hash)
        if hasattr(memory, 'hash'):   # joblib versions that bind it
            mp.setattr(memory, 'hash', memory.hash)
        NiftiMasker.received = []
        yield nibabel
    finally:
        for _, fixes, _, _ in PACKAGES.values():
            fixes.__dict__.pop('Nifti1Image', None)
        mp.undo()


@pytest.fixture
def fakes():
    with nifti_fakes() as nibabel:
        yield nibabel


def _save(tmp_path, name, arr):
    """``arr`` in npy format under a NIfTI-like name (the fake loader
    reads it with ``np.load``)."""
    path = tmp_path / name
    with open(path, 'wb') as f:
        np.save(f, arr)
    return str(path)


def _records(n_records=3, n_frames=30, shape=(5, 4, 3), seed=0,
             dtype=np.float64):
    rng = np.random.RandomState(seed)
    mask = np.zeros(shape, np.float32)
    mask[1:, :, 1:] = 1           # not every voxel: the order matters
    maps = rng.randn(4, *shape)
    recs = []
    for _ in range(n_records):
        vol = np.einsum('tk,kxyz->xyzt', rng.randn(n_frames, 4), maps) \
            + 0.1 * rng.randn(*shape, n_frames)
        recs.append(vol.astype(dtype) if np.dtype(dtype).kind == 'f'
                    else np.round(100 * vol).astype(dtype))
    return recs, mask


# --------------------------------------------------------------------- #
# fixes.py
# --------------------------------------------------------------------- #

def test_fixes_match_jax_and_restore_every_global(tmp_path):
    """Each package under its own fakes (the patches are process-wide:
    the first package to patch ``nibabel.load`` would keep it)."""
    from joblib import hashing, memory
    saved = (hashing.hash, getattr(memory, 'hash', None))
    vol = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    path_a = _save(tmp_path, 'a.nii', vol)
    path_b = _save(tmp_path, 'b.nii', vol)
    out = {}
    for name, (_, fixes, _, _) in PACKAGES.items():
        with nifti_fakes() as nibabel:
            cls, load = fixes.get_picklable_nifti_classes()
            assert issubclass(cls, FakeNifti1Image)
            assert fixes.Nifti1Image is cls and cls.__module__ == \
                fixes.__name__
            img = cls(vol, np.eye(4))
            img.set_filename('/data/rec.nii.gz')
            back = pickle.loads(pickle.dumps(img))
            assert type(back) is cls
            np.testing.assert_array_equal(back.dataobj, vol)
            assert back.get_filename() == '/data/rec.nii.gz'
            assert fixes.get_picklable_nifti_classes()[0] is cls
            assert fixes.filename_mtime_token(path_a) == \
                jfixes.filename_mtime_token(path_a)
            assert fixes.monkey_patch_nilearn_caching() is True
            img_a, img_a2 = nibabel.load(path_a), nibabel.load(path_a)
            img_a2._dataobj = img_a2._dataobj + 1   # same file, new data
            assert type(img_a) is cls
            # file-backed images hash by their token, others by content
            out[name] = (hashing.hash(img_a), hashing.hash(img_a2),
                         hashing.hash(nibabel.load(path_b)),
                         getattr(memory, 'hash', hashing.hash)(img_a),
                         hashing.hash(FakeNifti1Image(vol, np.eye(4))))
            from nilearn._utils import cache_mixin, niimg
            assert type(niimg.load_niimg(path_a)) is cls
            assert cache_mixin._safe_cache(
                types.SimpleNamespace(cache=lambda f, **kw: f), len) is len
        # every global is back
        assert (hashing.hash, getattr(memory, 'hash', None)) == saved
        assert not hasattr(fixes, 'Nifti1Image')
        assert fixes._PICKLABLE_CACHE is None
        assert 'nibabel' not in sys.modules and not tbase.HAS_NILEARN
        assert tbase.MultiNiftiMasker is None
    for h in out.values():
        assert h[0] == h[1] == h[3] != h[2]
    assert out['jax'] == out['port']   # the same token, the same hash


@pytest.mark.parametrize('name', ['jax', 'port'])
def test_fixes_without_nibabel(monkeypatch, name):
    _, fixes, _, _ = PACKAGES[name]
    monkeypatch.setitem(sys.modules, 'nibabel', None)
    monkeypatch.setattr(fixes, '_PICKLABLE_CACHE', None)
    assert fixes.get_picklable_nifti_classes() is None
    assert fixes.monkey_patch_nifti_image() is False
    assert fixes.monkey_patch_nilearn_caching() is False


# --------------------------------------------------------------------- #
# maskers: base.py and unmask.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize('as_path', [False, True])
def test_check_embedded_masker_routes_nifti_masks(fakes, tmp_path,
                                                  as_path):
    mask = np.ones((3, 2, 2), np.float32)
    img = _save(tmp_path, 'mask.nii.gz', mask) if as_path \
        else FakeNifti1Image(mask, np.eye(4))
    kw = dict(mask=img, smoothing_fwhm=4.0, standardize=True, n_jobs=3,
              memory_level=2, t_r=2.0)
    got = tbase.check_embedded_masker(
        tfmri.fMRIDictFact(device='cpu', **kw))
    want = jbase.check_embedded_masker(jfmri.fMRIDictFact(**kw))
    assert type(got) is type(want) is NiftiMasker
    assert got.get_params() == want.get_params()
    assert got.mask_img_ is img and got.memory_level == 1
    # .npy paths and arrays stay on the numpy masker
    npy = str(tmp_path / 'mask.npy')
    np.save(npy, mask > 0)
    for m in (npy, mask > 0):
        assert type(tbase.check_embedded_masker(
            tfmri.fMRIDictFact(mask=m, device='cpu'))) is tbase.NumpyMasker


def test_load_img_and_raw_masker_read_nifti_paths(fakes, tmp_path):
    rng = np.random.RandomState(0)
    vol = rng.randn(3, 2, 2, 6)
    path = _save(tmp_path, 'rec.nii', vol)
    np.testing.assert_array_equal(tbase._load_img(path),
                                  jbase._load_img(path))
    np.testing.assert_array_equal(tbase._load_img(path), vol)
    mask = FakeNifti1Image(np.ones((3, 2, 2)), np.eye(4))
    kw = dict(mask_img=mask, standardize=True, detrend=True)
    port = tunmask.MultiRawMasker(**kw).fit()
    ref = junmask.MultiRawMasker(**kw).fit()
    for img in (path, FakeNifti1Image(vol, np.eye(4))):
        got = port.transform(img)
        np.testing.assert_array_equal(got, ref.transform(img))
        np.testing.assert_array_equal(port.transform_raw(img),
                                      ref.transform_raw(img))
    assert isinstance(port._nifti_masker_, NiftiMasker)
    assert port._nifti_masker_.standardize and port._nifti_masker_.detrend
    np.testing.assert_allclose(got.std(0), 1, rtol=1e-12)


def test_safe_to_filename_leaves_the_image_unchanged(tmp_path):
    for name, (base, _, _, _) in PACKAGES.items():
        img = SavableImage(np.arange(4.), np.eye(4), header={'v': 1})
        base.safe_to_filename(img, str(tmp_path / f'{name}.npy'))
        assert img.header == {'v': 1}
        np.testing.assert_array_equal(np.load(tmp_path / f'{name}.npy'),
                                      np.arange(4.))


# --------------------------------------------------------------------- #
# decomposition/fmri.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize('dtype', [np.float32, np.int16])
def test_lazy_scan_reads_nifti_headers(fakes, tmp_path, dtype):
    recs, _ = _records(n_records=2, dtype=dtype)
    imgs = [FakeNifti1Image(recs[0], np.eye(4)),
            _save(tmp_path, 'r1.nii.gz', recs[1][..., :17])]
    got, want = tfmri._lazy_scan(imgs), jfmri._lazy_scan(imgs)
    assert got == want == ([30, 17], np.dtype(dtype))


def test_count_voxels_of_a_nilearn_masker(fakes, tmp_path):
    _, mask = _records()
    for img in (FakeNifti1Image(mask, np.eye(4)),
                _save(tmp_path, 'mask.nii', mask)):
        masker = NiftiMasker(mask_img=img).fit()
        assert tfmri.fMRIDictFact._count_voxels(masker) == \
            jfmri.fMRIDictFact._count_voxels(masker, None) == \
            int((mask != 0).sum()) == 32


@pytest.mark.parametrize('as_path', [False, True])
@pytest.mark.parametrize('method', ['masked', 'average'])
def test_nifti_fit_feeds_the_same_rows(fakes, tmp_path, monkeypatch, method,
                                       as_path):
    recs, mask = _records()
    imgs = ([_save(tmp_path, f'r{i}.nii.gz', r) for i, r in enumerate(recs)]
            if as_path else [FakeNifti1Image(r, np.eye(4)) for r in recs])
    kw = dict(method=method, n_components=4, reduction=2, batch_size=10,
              n_epochs=2, alpha=1e-3, mask=FakeNifti1Image(mask, np.eye(4)),
              random_state=0)
    calls = {'jax': [], 'port': []}
    _spy(monkeypatch, jdf.DictFact, calls['jax'])
    _spy(monkeypatch, tdf.DictFact, calls['port'])
    ref = jfmri.fMRIDictFact(**kw).fit(imgs)
    port = tfmri.fMRIDictFact(device='cpu', **kw).fit(imgs)
    assert isinstance(port.masker_, NiftiMasker)
    assert not port.dict_fact_._cfg.windowed      # gather subsets
    assert not hasattr(port, 'record_cache_info_')   # the host route
    assert len(calls['port']) == len(calls['jax']) == 2 * len(recs)
    for (X, idx), (X_ref, idx_ref) in zip(calls['port'], calls['jax']):
        np.testing.assert_allclose(X, X_ref, rtol=1e-10, atol=1e-10)
        if idx_ref is None:
            assert idx is None
        else:
            np.testing.assert_array_equal(idx, idx_ref)
    # voxel order: the rows are the C-order masked volume
    assert calls['port'][0][0].shape[1] == 32
    assert tfmri.fMRIDictFact._count_voxels(port.masker_) == 32
    # the dictionaries differ (the packages draw subsets from different
    # generators); components_img_ is the masker's image of the
    # components, built from numpy, never from a tensor
    assert set(NiftiMasker.received) == {np.ndarray}
    vol = np.asarray(port.components_img_.dataobj)
    assert vol.shape == mask.shape + (4,)
    C = port.components_
    np.testing.assert_allclose(
        np.asarray(ref.masker_.inverse_transform(C).dataobj), vol,
        rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(vol[mask != 0], port.components_.T)


@pytest.mark.parametrize('dtype', [np.int16, np.float32])
def test_nifti_records_run_float32_state(fakes, monkeypatch, dtype):
    """Scanner int16 (and float32) images: ``_lazy_scan`` reports their
    dtype, the state is float32 and the masker's float64 rows are fed in
    float32."""
    recs, mask = _records(dtype=dtype)
    calls = []
    _spy(monkeypatch, tdf.DictFact, calls)
    fd = tfmri.fMRIDictFact(n_components=4, reduction=2, batch_size=10,
                            n_epochs=1, mask=FakeNifti1Image(mask, np.eye(4)),
                            random_state=0, device='cpu')
    fd.fit([FakeNifti1Image(r, np.eye(4)) for r in recs])
    assert fd.dict_fact_._dtype == np.float32
    assert all(X.dtype == np.float32 for X, _ in calls) and calls
    assert np.isfinite(fd.components_).all()
    assert fd.components_.dtype == np.float32


def test_nifti_coder_matches_jax(fakes):
    recs, mask = _records(n_records=2)
    imgs = [FakeNifti1Image(r, np.eye(4)) for r in recs]
    D = np.random.RandomState(3).randn(4, 32)
    kw = dict(dictionary=D, mask=FakeNifti1Image(mask, np.eye(4)),
              alpha=1e-2)
    port = tfmri.fMRICoder(device='cpu', **kw).fit()
    ref = jfmri.fMRICoder(**kw).fit()
    for got, want in zip(port.transform(imgs), ref.transform(imgs)):
        assert got.shape == (30, 4)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert port.score(imgs) == pytest.approx(ref.score(imgs), rel=1e-9)
    np.testing.assert_array_equal(port.components_img_.dataobj,
                                  ref.components_img_.dataobj)


# --------------------------------------------------------------------- #
# datasets/adhd.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize('mask_url', [None, 'http://example.org/m.nii.gz'])
def test_fetch_adhd_matches_jax(monkeypatch, tmp_path, mask_url):
    fetched = []
    _install_fake_nilearn_datasets(monkeypatch, tmp_path, fetched)
    monkeypatch.delenv('MODL_SHARED_DATA', raising=False)
    out = {}
    for name, module in (('jax', jadhd), ('port', tadhd)):
        monkeypatch.setenv('MODL_DATA', str(tmp_path / name))
        out[name] = module.fetch_adhd(n_subjects=3, mask_url=mask_url)
    got, want = out['port'], out['jax']
    assert sorted(got) == sorted(want) == sorted(
        ['rest', 'behavioral', 'description', 'mask', 'root', 'func',
         'confounds'])
    assert got.rest.equals(want.rest)
    assert got.behavioral.equals(want.behavioral)
    assert got.behavioral.index.names == ['subject']
    for key in ('description', 'root', 'func', 'confounds'):
        assert got[key] == want[key] == getattr(got, key)
    assert got.mask.replace('port', 'jax') == want.mask
    assert len(fetched) == 2
    assert fetched[0] == fetched[1] == (
        mask_url or tadhd._MASK_URL)
    if mask_url is None:
        # the mask is there now: no second download
        assert tadhd.fetch_adhd(n_subjects=3).mask == got.mask
        assert len(fetched) == 2


def test_fetch_adhd_without_nilearn_raises_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, 'nilearn', None)
    msgs = []
    for module in (jadhd, tadhd):
        with pytest.raises(ImportError, match='make_synthetic_rest_data') \
                as info:
            module.fetch_adhd(n_subjects=1)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
