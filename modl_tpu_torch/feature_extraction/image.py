"""Lazy clean-patch extraction over strided views.

Counterpart of ``modl_tpu/feature_extraction/image.py``. The extractor
keeps one flat ordering ``order_`` of linear patch ids over the patch
grid and materialises patches from a zero-copy strided view only when a
batch is asked for, so a large image costs O(batch) memory per buffer
and a shuffle is one 1-D gather (the co-permutation that
``DictFact.shuffle`` returns).
"""
import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from ..base import BaseEstimator, check_random_state
from ..input_data.image import clean_mask, fill

__all__ = ["LazyCleanPatchExtractor", "extract_patches"]


def extract_patches(image, patch_shape):
    """All overlapping patches of ``image`` as a zero-copy strided view
    of shape (n_i, n_j, n_k, *patch_shape)."""
    return sliding_window_view(image, patch_shape)


class LazyCleanPatchExtractor(BaseEstimator):
    """On-demand extractor of patches free of missing (-1) pixels.

    fit / transform / partial_transform / shuffle as in the JAX
    package; ``n_patches_`` and ``patch_shape_`` are derived properties.
    """

    def __init__(self, patch_size=None, random_state=None, max_patches=None):
        self.patch_size = patch_size
        self.max_patches = max_patches
        self.random_state = random_state

    def fit(self, X, y=None):
        self.random_state = check_random_state(self.random_state)
        shape = self._resolve_patch_shape(X)
        self._view = extract_patches(X, shape)
        self._grid = self._view.shape[:3]
        self.order_ = self._clean_ids(X)
        self.random_state.shuffle(self.order_)
        if self.max_patches is not None:
            self.order_ = self.order_[:self.max_patches]
        return self

    def _resolve_patch_shape(self, X):
        n_channels = X.shape[-1]
        if self.patch_size is None:
            return (X.shape[0] // 10, X.shape[1] // 10, n_channels)
        return tuple(self.patch_size) + (n_channels,)

    def _clean_ids(self, X):
        """Linear ids (over the patch grid) of patches with no -1 pixel."""
        if np.all(X != -1):
            coords = fill(*self._grid)
        else:
            coords = clean_mask(self._view, X)
        return np.ravel_multi_index(tuple(coords.T), self._grid)

    def _gather(self, ids):
        """Materialise the patches whose linear grid ids are ``ids``."""
        return self._view[np.unravel_index(ids, self._grid)]

    def partial_transform(self, X=None, batch=None):
        if X is not None:
            self.fit(X)
        if batch is None:
            batch = slice(None)
        elif isinstance(batch, (int, np.integer)):
            batch = slice(0, batch)
        return self._gather(self.order_[batch])

    def transform(self, X=None):
        return self.partial_transform(X=X)

    def shuffle(self, permutation=None):
        """Reorder the patch stream; with an argument, follow a learner's
        co-permutation."""
        if permutation is None:
            self.random_state.shuffle(self.order_)
        else:
            self.order_ = self.order_[permutation]

    @property
    def n_patches_(self):
        return self.order_.shape[0]

    @property
    def patch_shape_(self):
        return self._view.shape[3:]
