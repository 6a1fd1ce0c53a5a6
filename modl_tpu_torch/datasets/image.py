"""Image datasets: the reference's three sources and a planted generator.

Counterpart of ``modl_tpu/datasets/image.py``. ``load_image`` reads
scipy's raccoon face, a photo ('lisboa', through scikit-image) or the
AVIRIS hyperspectral cube (through ``spectral``, -1 marking missing
bands) and raises an informative error when the file or the package is
absent. ``make_synthetic_image`` returns the JAX package's image bit for
bit.
"""
import os

import numpy as np

from . import get_data_dirs

__all__ = ["load_image", "make_synthetic_image"]


def _gray_scale(image):
    return image.mean(axis=2, keepdims=True)


def load_image(source, scale=1, gray=False, memory=None):
    data_dir = get_data_dirs()[0]
    if source == 'face':
        import scipy.datasets
        image = scipy.datasets.face(gray=gray)
        image = image.astype(np.float64) / 255
        if image.ndim == 2:
            image = image[..., np.newaxis]
        if scale != 1:
            import scipy.ndimage
            zoom = (scale, scale) + (1,) * (image.ndim - 2)
            image = scipy.ndimage.zoom(image, zoom)
        return image
    elif source == 'lisboa':
        path = os.path.join(data_dir, 'images', 'lisboa.jpg')
        if not os.path.exists(path):
            raise IOError('Image %r not found; place it under %s'
                          % (source, path))
        try:
            from skimage.io import imread
            from skimage.transform import rescale
        except ImportError as e:
            raise ImportError('loading %r requires scikit-image' % source) \
                from e
        image = imread(path)
        image = image.astype(np.float64) / 255
        if gray:
            image = _gray_scale(image)
        if scale != 1:
            image = rescale(image, scale=scale)
        return image
    elif source == 'aviris':
        path = os.path.join(data_dir, 'aviris', 'f100826t01p00r05rdn_b',
                            'f100826t01p00r05rdn_b_sc01_ort_img.hdr')
        if not os.path.exists(path):
            raise IOError('AVIRIS data not found under %s' % path)
        try:
            from spectral import open_image  # type: ignore
        except ImportError as e:
            raise ImportError("loading 'aviris' requires the spectral "
                              "package") from e
        image = open_image(path)
        image = np.array(image.open_memmap(), dtype=np.float64)
        good_bands = list(range(image.shape[2]))
        good_bands.remove(110)
        image = image[:, :, good_bands]
        indices = image == -50
        image[indices] = -1
        image[~indices] -= np.min(image[~indices])
        image[~indices] /= np.max(image[~indices])
        return image
    else:
        raise ValueError('Data source is not known')


def make_synthetic_image(height=128, width=128, n_channels=1,
                         n_atoms=8, patch_size=8, missing_fraction=0.0,
                         seed=0):
    """Offline image with planted smooth local structure: low-frequency
    atoms (oriented gratings under Gaussian envelopes) added at random
    places, so patches correlate strongly with a small dictionary, as in
    natural images and unlike white noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, patch_size),
                         np.linspace(-1, 1, patch_size), indexing='ij')
    atoms = np.zeros((n_atoms, patch_size, patch_size, n_channels))
    for a in range(n_atoms):
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(0.5, 2.0) * np.pi
        phase = rng.uniform(0, 2 * np.pi)
        grating = np.cos(freq * (xx * np.cos(theta) + yy * np.sin(theta))
                         + phase)
        envelope = np.exp(-(xx ** 2 + yy ** 2) / 0.8)
        atoms[a] = (grating * envelope)[..., None] * \
            (1 + 0.1 * rng.randn(n_channels))[None, None, :]
    image = np.zeros((height, width, n_channels))
    for _ in range(height * width // (patch_size ** 2) * 8):
        i = rng.randint(height - patch_size)
        j = rng.randint(width - patch_size)
        a = rng.randint(n_atoms)
        image[i:i + patch_size, j:j + patch_size] += \
            atoms[a] * rng.randn()
    image -= image.min()
    denom = image.max()
    if denom > 0:
        image /= denom
    if missing_fraction > 0:
        mask = rng.rand(height, width) < missing_fraction
        image[mask] = -1
    return image
