"""Image patch preprocessing on the host (numpy).

Counterpart of ``modl_tpu/input_data/image.py``: per-patch mean/std
normalisation, and the clean-patch test as a summed-area table (a patch
is clean iff the window sum of its missing (-1) pixels is zero).
"""
from math import sqrt

import numpy as np

__all__ = ["scale_patches", "clean_mask", "fill"]


def scale_patches(X, with_mean=True, with_std=True, channel_wise=True,
                  copy=True):
    """Per-patch (optionally channel-wise) mean/std normalisation."""
    if copy:
        X = X.copy()
    X = np.asarray(X, dtype=np.result_type(X.dtype, np.float32))
    if with_mean:
        if channel_wise:
            X -= np.mean(X, axis=(1, 2))[:, np.newaxis, np.newaxis, :]
        else:
            X -= np.mean(X, axis=(1, 2, 3))[:, np.newaxis, np.newaxis,
                                            np.newaxis]
    if with_std:
        if channel_wise:
            n_channel = X.shape[3]
            std = np.sqrt(np.sum(X ** 2, axis=(1, 2)))
            std[std == 0] = 1
            X /= std[:, np.newaxis, np.newaxis, :] * sqrt(n_channel)
        else:
            std = np.sqrt(np.sum(X ** 2, axis=(1, 2, 3)))
            std[std == 0] = 1
            X /= std[:, np.newaxis, np.newaxis, np.newaxis]
    return X


def clean_mask(patches, image):
    """Coordinates of patches containing no missing (-1) pixel.

    patches: 6-D strided view (n_i, n_j, 1, p_h, p_w, n_chan) as made by
    ``extract_patches``; image: (h, w, n_chan) with -1 marking missing
    values. Returns the (n_clean, 3) int array of (i, j, 0) patch
    coordinates in row-major order.
    """
    n_i, n_j, n_k, p_h, p_w, n_chan = patches.shape
    invalid = np.any(image == -1, axis=2).astype(np.int64)  # (h, w)
    # summed-area table with zero padding
    sat = np.zeros((invalid.shape[0] + 1, invalid.shape[1] + 1),
                   dtype=np.int64)
    sat[1:, 1:] = invalid.cumsum(0).cumsum(1)
    # window sum of invalid pixels for each top-left patch corner
    win = (sat[p_h:p_h + n_i, p_w:p_w + n_j]
           - sat[p_h:p_h + n_i, :n_j]
           - sat[:n_i, p_w:p_w + n_j]
           + sat[:n_i, :n_j])
    ii, jj = np.nonzero(win == 0)
    coords = np.zeros((ii.shape[0], 3), dtype=np.int64)
    coords[:, 0] = ii
    coords[:, 1] = jj
    return coords


def fill(n_i, n_j, n_k):
    """Dense (i, j, k) index grid, row-major."""
    grid = np.indices((n_i, n_j, n_k))
    return grid.reshape(3, -1).T.astype(np.int64)
