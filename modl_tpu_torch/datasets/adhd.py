"""ADHD resting-state data (counterpart of ``modl_tpu/datasets/adhd.py``).

``make_synthetic_rest_data`` makes an offline stand-in with planted
spatial networks, in the (records, mask) contract the fMRI estimators
take. ``fetch_adhd`` needs nilearn and NIfTI support, which the port
does not have yet: it raises ``ImportError``.
"""
import numpy as np

__all__ = ["fetch_adhd", "make_synthetic_rest_data"]


def fetch_adhd(*args, **kwargs):
    """The ADHD rest data of ``modl_tpu.datasets.adhd.fetch_adhd``: not
    available in the port yet (it reads NIfTI images through nilearn)."""
    raise ImportError('modl_tpu_torch.datasets.adhd.fetch_adhd needs the '
                      'NIfTI path, which is not ported yet; use '
                      'make_synthetic_rest_data for offline runs')


def make_synthetic_rest_data(n_subjects=8, n_frames=100, shape=(12, 14, 10),
                             n_networks=6, noise=0.1, seed=0):
    """Synthetic rest-fMRI records: planted smooth spatial networks.

    Returns (list of 4-D arrays, 3-D bool mask, true (k, n_voxels) maps).
    """
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    mask = np.ones(shape, bool)
    n_voxels = int(np.prod(shape))
    # smooth random spatial maps
    maps = rng.randn(n_networks, *shape)
    for i in range(n_networks):
        maps[i] = gaussian_filter(maps[i], sigma=1.5)
    flat = maps.reshape(n_networks, n_voxels)
    flat /= np.sqrt(np.sum(flat ** 2, axis=1))[:, None]
    data = []
    for _ in range(n_subjects):
        loadings = rng.randn(n_frames, n_networks)
        X = loadings @ flat + noise * rng.randn(n_frames, n_voxels)
        data.append(X.T.reshape(shape + (n_frames,)))
    return data, mask, flat
