"""Raw-data masker: ``.npy`` paths and ndarrays as (memory-mapped) loads.

Counterpart of ``modl_tpu/input_data/fmri/unmask.py`` (``MultiRawMasker``)
without nilearn: pre-unmasked records are 2-D (n_frames, n_voxels)
arrays on disk, and transform is a memory-mapped load plus optional
detrend/standardize. An image object is read through its ``dataobj``;
any other non-``.npy`` input raises the error the JAX package raises
where nilearn is missing.
"""
import numpy as np

from ...base import BaseEstimator
from .base import NumpyMasker

__all__ = ["MultiRawMasker"]


def _mask_array(mask_img):
    """Boolean 3-D mask from an ndarray / .npy path / image object."""
    if mask_img is None or isinstance(mask_img, (np.ndarray, str)):
        return mask_img
    if hasattr(mask_img, 'dataobj'):    # NIfTI-like image object
        return np.asanyarray(mask_img.dataobj) != 0
    return mask_img


class MultiRawMasker(BaseEstimator):
    """Masker over pre-unmasked 2-D records."""

    def __init__(self, mask_img=None, smoothing_fwhm=None, standardize=False,
                 detrend=False):
        self.mask_img = mask_img
        self.smoothing_fwhm = smoothing_fwhm
        self.standardize = standardize
        self.detrend = detrend

    def fit(self, imgs=None, y=None):
        self._backing = NumpyMasker(mask_img=_mask_array(self.mask_img),
                                    standardize=self.standardize,
                                    detrend=self.detrend)
        if self.mask_img is not None:
            self._backing.fit()
            self.mask_img_ = self._backing.mask_img_
            self.n_voxels_ = self._backing.n_voxels_
        return self

    def _image_object(self, imgs, confounds=None, raw=False):
        """Non-``.npy`` input: an image object's ``dataobj``, else the
        JAX package's no-nilearn error."""
        if hasattr(imgs, 'dataobj'):
            data = np.asanyarray(imgs.dataobj)
            return (self._backing.transform_raw(data) if raw
                    else self._backing.transform(data, confounds=confounds))
        raise ValueError(
            'MultiRawMasker got a non-.npy input %r; handling NIfTI '
            'paths requires nilearn (pass pre-unmasked .npy records or '
            'ndarrays for the native path)' % (imgs,))

    def _load(self, imgs):
        if isinstance(imgs, str) and imgs.endswith('.npy'):
            return np.load(imgs, mmap_mode='r')
        if isinstance(imgs, np.ndarray):
            return imgs
        return None

    def transform(self, imgs, confounds=None):
        if isinstance(imgs, (list, tuple)):
            return [self.transform(img, confounds) for img in imgs]
        data = self._load(imgs)
        if data is None:
            return self._image_object(imgs, confounds=confounds)
        # NumpyMasker takes 2-D (pre-unmasked) and 4-D inputs alike
        return self._backing.transform(data, confounds=confounds)

    def transform_raw(self, imgs):
        """Mask-only load (see NumpyMasker.transform_raw)."""
        data = self._load(imgs)
        if data is None:
            return self._image_object(imgs, raw=True)
        return self._backing.transform_raw(data)

    def inverse_transform(self, components):
        if self.mask_img is None:
            raise ValueError('inverse_transform requires a mask')
        return self._backing.inverse_transform(components)
