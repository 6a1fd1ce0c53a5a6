"""Masker abstraction for fMRI-like data, on the host.

Counterpart of ``modl_tpu/input_data/fmri/base.py`` restricted to its
native path: ``NumpyMasker`` masks 4-D arrays and ``.npy`` records with
a boolean 3-D mask. nilearn and nibabel are not used: a NIfTI path or
any other non-``.npy`` string raises the error the JAX package raises
where nilearn is missing.
"""
import inspect
import warnings

import numpy as np

from ...base import BaseEstimator

__all__ = ["NumpyMasker", "BaseNilearnEstimator", "check_embedded_masker",
           "check_embedded_nifti_masker"]


class NumpyMasker(BaseEstimator):
    """Mask 4-D arrays into (n_frames, n_voxels) matrices.

    Parameters are those of ``modl_tpu``'s ``NumpyMasker``:

    mask_img : 3-D boolean ndarray (or path to a ``.npy`` holding one).
    standardize : bool, center/scale each voxel time-series.
    detrend : bool, remove mean + linear trend per voxel.
    low_pass, high_pass : float Hz cutoffs; Butterworth (order 5,
        zero-phase) temporal filtering. Requires ``t_r``.
    t_r : repetition time in seconds (needed for filtering).
    smoothing_fwhm, target_affine, target_shape, mask_strategy,
        mask_args : accepted for API parity with the nilearn masker;
        ignored (the mask is always the nonzero-variance background).
    memory, memory_level, n_jobs, verbose : technical params, carried
        so ``check_embedded_masker`` can forward them uniformly.
    feature_order : None | int seed | permutation ndarray. When set,
        ``transform`` emits voxel columns in this fixed random order
        and ``inverse_transform`` maps them back; streaming fits then
        draw feature subsets as contiguous windows.
    raw_in_order : bool (default True). Whether already-masked 2-D
        inputs carry ``feature_order`` already (records stored
        permuted); ``create_raw_rest_data`` sets False.
    dtype : 'auto' (float64 stays float64, anything else float32) or a
        numpy dtype: the computation and output dtype of ``transform``.

    Preprocessing order in ``transform``: mask -> permute -> detrend ->
    Butterworth filter -> standardize -> confound regression.
    """

    def __init__(self, mask_img=None, standardize=False, detrend=False,
                 low_pass=None, high_pass=None, t_r=None,
                 smoothing_fwhm=None, target_affine=None,
                 target_shape=None, mask_strategy='background',
                 mask_args=None, memory=None, memory_level=1, n_jobs=1,
                 verbose=0, feature_order=None, raw_in_order=True,
                 dtype='auto'):
        self.feature_order = feature_order
        self.raw_in_order = raw_in_order
        self.dtype = dtype
        self.mask_img = mask_img
        self.standardize = standardize
        self.detrend = detrend
        self.low_pass = low_pass
        self.high_pass = high_pass
        self.t_r = t_r
        self.smoothing_fwhm = smoothing_fwhm
        self.target_affine = target_affine
        self.target_shape = target_shape
        self.mask_strategy = mask_strategy
        self.mask_args = mask_args
        self.memory = memory
        self.memory_level = memory_level
        self.n_jobs = n_jobs
        self.verbose = verbose

    def fit(self, imgs=None, y=None):
        mask = self.mask_img
        if isinstance(mask, str):
            mask = np.load(mask)
        if mask is None:
            if imgs is None:
                raise ValueError('Provide a mask or data to fit the masker')
            img = _load_img(imgs[0] if isinstance(imgs, (list, tuple))
                            else imgs)
            if img.ndim == 2:
                # already-masked (t, voxels) record: every column is a
                # feature (axis -1 is voxels here, not time)
                mask = np.ones(img.shape[1], dtype=bool)
            else:
                # background mask: voxels with nonzero variance
                mask = img.std(axis=-1) > 0
        self.mask_img_ = np.asarray(mask, bool)
        self.n_voxels_ = int(self.mask_img_.sum())
        order = self.feature_order
        if order is None:
            self.feature_order_ = None
        elif np.ndim(order) == 0:
            rng = np.random.RandomState(int(order))
            self.feature_order_ = rng.permutation(self.n_voxels_)
        else:
            self.feature_order_ = np.asarray(order, np.int64)
            if self.feature_order_.shape != (self.n_voxels_,):
                raise ValueError('feature_order length %d != n_voxels %d'
                                 % (len(self.feature_order_),
                                    self.n_voxels_))
        return self

    def _check_fitted(self):
        if not hasattr(self, 'mask_img_'):
            raise ValueError('NumpyMasker is not fitted')

    def _work_dtype(self, in_dtype):
        d = getattr(self, 'dtype', 'auto')
        if d in (None, 'auto'):
            return (np.float64 if np.dtype(in_dtype) == np.float64
                    else np.float32)
        return np.dtype(d)

    def transform_raw(self, img):
        """Mask + feature order only: no temporal preprocessing and no
        dtype copy. ``fMRIDictFact`` then runs detrend/standardize on
        the device over the transferred record; on a pre-cleaned
        ``.npy`` pipeline this is a zero-copy mmap handoff."""
        data = _load_img(img)
        order = getattr(self, 'feature_order_', None)
        if data.ndim == 2:
            if order is not None and not getattr(self, 'raw_in_order',
                                                 True):
                return np.asarray(data)[:, order]
            return data
        self._check_fitted()
        out = data[self.mask_img_].T
        if order is not None:
            out = out[:, order]
        return out

    def transform(self, img, confounds=None):
        """(x, y, z, t) array or .npy path -> (t, n_voxels)."""
        data = _load_img(img)
        order = getattr(self, 'feature_order_', None)
        dt = self._work_dtype(data.dtype)
        if data.ndim == 2:  # already masked (raw path) - no mask needed
            out = np.asarray(data, dt)
            if order is not None and not getattr(self, 'raw_in_order',
                                                 True):
                out = out[:, order]
        else:
            self._check_fitted()
            out = data[self.mask_img_].T.astype(dt)
            if order is not None:
                out = out[:, order]
        if self.detrend:
            # nilearn's detrend removes the mean and the linear trend
            out = out - out.mean(0)
            t = np.arange(out.shape[0], dtype=dt)
            t = (t - t.mean())
            denom = np.sum(t * t)
            if denom > 0:
                slope = (t[:, None] * out).sum(0) / denom
                out = out - np.outer(t, slope)
        if self.low_pass is not None or self.high_pass is not None:
            out = _butterworth(out, self.t_r, self.low_pass,
                               self.high_pass).astype(dt, copy=False)
        if self.standardize:
            out = out - out.mean(axis=0)
            std = out.std(axis=0)
            std[std == 0] = 1
            out = out / std
        if confounds is not None:
            conf = np.asarray(confounds, dt)
            conf = conf - conf.mean(0)
            coef, *_ = np.linalg.lstsq(conf, out, rcond=None)
            out = out - conf @ coef
        return out

    def inverse_transform(self, components):
        """(k, n_voxels) -> (x, y, z, k) volume stack."""
        self._check_fitted()
        components = np.atleast_2d(components)
        if getattr(self, 'feature_order_', None) is not None:
            # columns arrive in the shuffled order; map back to voxels
            inv = np.empty_like(self.feature_order_)
            inv[self.feature_order_] = np.arange(len(self.feature_order_))
            components = components[:, inv]
        shape = self.mask_img_.shape + (components.shape[0],)
        out = np.zeros(shape, components.dtype)
        out[self.mask_img_] = components.T
        return out


def _butterworth(data, t_r, low_pass, high_pass, order=5):
    """Zero-phase Butterworth temporal filter on (t, voxels) data
    (nilearn's clean() filtering stage, with scipy.signal)."""
    if t_r is None:
        raise ValueError('low_pass/high_pass filtering requires t_r')
    from scipy.signal import butter, sosfiltfilt
    nyq = 0.5 / t_r
    if low_pass is not None and high_pass is not None:
        sos = butter(order, [high_pass / nyq, low_pass / nyq],
                     btype='band', output='sos')
    elif low_pass is not None:
        sos = butter(order, low_pass / nyq, btype='low', output='sos')
    else:
        sos = butter(order, high_pass / nyq, btype='high', output='sos')
    return sosfiltfilt(sos, data, axis=0)


def _load_img(img):
    """A record as an array: ``.npy`` paths are memory-mapped."""
    if isinstance(img, str):
        if img.endswith('.npy'):
            return np.load(img, mmap_mode='r')
        raise ValueError('Cannot load %r without nibabel/nilearn' % img)
    return np.asarray(img)


class BaseNilearnEstimator(BaseEstimator):
    """Estimator base that builds its masker from its parameters (the
    JAX package's ``BaseNilearnEstimator`` on the numpy masker only)."""

    def __init__(self, mask=None, smoothing_fwhm=None, standardize=True,
                 detrend=True, low_pass=None, high_pass=None, t_r=None,
                 target_affine=None, target_shape=None,
                 mask_strategy='background', mask_args=None, memory=None,
                 memory_level=2, n_jobs=1, verbose=0):
        self.mask = mask
        self.smoothing_fwhm = smoothing_fwhm
        self.standardize = standardize
        self.detrend = detrend
        self.low_pass = low_pass
        self.high_pass = high_pass
        self.t_r = t_r
        self.target_affine = target_affine
        self.target_shape = target_shape
        self.mask_strategy = mask_strategy
        self.mask_args = mask_args
        self.memory = memory
        self.memory_level = memory_level
        self.n_jobs = n_jobs
        self.verbose = verbose

    def fit(self, imgs=None, y=None, confounds=None):
        self.masker_ = check_embedded_masker(self)
        if not hasattr(self.masker_, 'mask_img_'):
            self.masker_.fit(imgs)
        self.mask_img_ = self.masker_.mask_img_
        return self


def _init_params(cls):
    """Constructor parameter names of a masker class."""
    sig = inspect.signature(cls.__init__)
    return [name for name in sig.parameters if name != 'self']


def check_embedded_masker(estimator):
    """Build a masker from estimator params (the JAX package's contract):

    - ``estimator.mask`` is a masker instance -> a NEW masker of the
      same class is built from the *masker's* params, overriding the
      estimator's, with a warning listing each conflict. A fitted mask
      (``mask_img_``) is carried over.
    - otherwise the masker parameters found on the estimator are
      forwarded to a :class:`NumpyMasker`, with ``mask`` as the mask.
    - technical params (n_jobs, memory, memory_level - 1, verbose) are
      always forwarded from the estimator.
    """
    mask = getattr(estimator, 'mask', None)

    is_masker = isinstance(mask, BaseEstimator) and hasattr(mask,
                                                            'mask_img')
    masker_class = mask.__class__ if is_masker else NumpyMasker

    masker_param_names = _init_params(masker_class)
    estimator_params = {name: getattr(estimator, name)
                        for name in masker_param_names
                        if hasattr(estimator, name)}

    if is_masker:
        new_params = {name: getattr(mask, name)
                      for name in masker_param_names
                      if hasattr(mask, name)}
    else:
        new_params = dict(estimator_params)
        new_params['mask_img'] = mask

    # technical params always come from the estimator (not reported as
    # conflicts: forwarding them is the contract, not an override)
    technical = ('n_jobs', 'memory', 'memory_level', 'verbose')
    for name, value in (('n_jobs', getattr(estimator, 'n_jobs', 1)),
                        ('memory', getattr(estimator, 'memory', None)),
                        ('memory_level',
                         max(0, getattr(estimator, 'memory_level', 1) - 1)),
                        ('verbose', getattr(estimator, 'verbose', 0))):
        if name in masker_param_names:
            new_params[name] = value

    if is_masker:
        conflicts = []
        for name in sorted(estimator_params):
            if name not in new_params or name in technical:
                continue
            if np.any(new_params[name] != estimator_params[name]):
                conflicts.append(
                    'Parameter %s :\n    Masker parameter %s'
                    ' - overriding estimator parameter %s'
                    % (name, new_params[name], estimator_params[name]))
        if conflicts:
            warnings.warn('Overriding provided-default estimator'
                          ' parameters with provided masker parameters'
                          ' :\n%s' % '\n'.join(conflicts))

    masker = masker_class(**new_params)
    if hasattr(mask, 'mask_img_'):
        # provided masker is fitted: adopt its mask
        masker.mask_img = mask.mask_img_
    if masker.mask_img is not None and not hasattr(masker, 'mask_img_'):
        masker.fit()
    return masker


# the JAX package's reference-named alias
check_embedded_nifti_masker = check_embedded_masker
