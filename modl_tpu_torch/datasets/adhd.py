"""ADHD resting-state data (counterpart of ``modl_tpu/datasets/adhd.py``).

``fetch_adhd`` wraps nilearn's fetcher, as the JAX package's does: it
needs nilearn (and pandas for the phenotype frames), both imported when
it is called. ``make_synthetic_rest_data`` makes an offline stand-in
with planted spatial networks, in the (records, mask) contract the fMRI
estimators take.
"""
import os

import numpy as np

__all__ = ["fetch_adhd", "make_synthetic_rest_data"]

_MASK_URL = 'http://amensch.fr/data/cogspaces/mask/mask_img.nii.gz'


def fetch_adhd(n_subjects=40, data_dir=None, url=None, resume=True,
               modl_data_dir=None, mask_url=None, verbose=1):
    """ADHD rest data + grey-matter mask + phenotype frame.

    Wraps nilearn's ``fetch_adhd``, downloads the analysis mask into the
    modl data dir once, and turns the phenotypic records into
    subject-indexed pandas frames. Returns a ``Bunch`` with ``rest``
    (filename/confounds frame), ``behavioral``, ``description``,
    ``mask``, ``root``, and the ``func``/``confounds`` lists.
    """
    try:
        from nilearn import datasets as nl_datasets
    except ImportError as e:
        raise ImportError('fetch_adhd requires nilearn; use '
                          'make_synthetic_rest_data for offline runs') \
            from e
    import pandas as pd

    from ..base import Bunch

    dataset = nl_datasets.fetch_adhd(n_subjects=n_subjects,
                                     data_dir=data_dir, url=url,
                                     resume=resume, verbose=verbose)

    # dataset root: walk up from the first functional file to 'adhd'
    root_dir, tail = os.path.split(dataset.func[0])
    while tail and tail != 'adhd':
        root_dir, tail = os.path.split(root_dir)
    root_dir = os.path.join(root_dir, tail)

    mask_img = _fetch_mask(modl_data_dir, mask_url, resume=resume,
                           verbose=verbose)

    behavioral = pd.DataFrame(dataset.phenotypic)
    behavioral['Subject'] = pd.to_numeric(behavioral['Subject'])
    behavioral = behavioral.set_index('Subject')
    behavioral.index.names = ['subject']
    rest = pd.DataFrame(data=list(zip(dataset.func, dataset.confounds)),
                        columns=['filename', 'confounds'],
                        index=behavioral.index)
    return Bunch(rest=rest, behavioral=behavioral,
                 description=dataset.description, mask=mask_img,
                 root=root_dir, func=list(dataset.func),
                 confounds=list(dataset.confounds))


def _fetch_mask(modl_data_dir, mask_url, resume=True, verbose=1):
    """Download (once) the analysis mask into the modl data dir."""
    from . import get_data_dirs

    mask_dir = os.path.join(get_data_dirs(modl_data_dir)[0], 'adhd')
    mask_img = os.path.join(mask_dir, 'mask_img.nii.gz')
    if os.path.exists(mask_img):
        return mask_img
    if mask_url is None:
        mask_url = _MASK_URL
    try:  # nilearn moved this helper across versions
        from nilearn.datasets._utils import fetch_single_file
    except ImportError:
        from nilearn.datasets.utils import _fetch_file as fetch_single_file
    os.makedirs(mask_dir, exist_ok=True)
    return fetch_single_file(mask_url, mask_dir, resume=resume,
                             verbose=verbose)


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
