"""Dataset loaders and data-directory resolution.

Counterpart of ``modl_tpu/datasets/__init__.py``: the MODL_SHARED_DATA /
MODL_DATA / ~/modl_data chain is the same. Loaders of external corpora
(MovieLens, Netflix, the images) look there and raise informative
errors when the files or the optional packages are absent; the
synthetic generators make every path runnable offline.
"""
import os

__all__ = ["get_data_dirs"]


def get_data_dirs(data_dir=None):
    """Data directory chain: arg > MODL_SHARED_DATA > MODL_DATA >
    ~/modl_data."""
    paths = []
    if data_dir is not None:
        paths.extend(data_dir.split(os.pathsep))
    else:
        global_data = os.getenv('MODL_SHARED_DATA')
        if global_data is not None:
            paths.extend(global_data.split(os.pathsep))
        local_data = os.getenv('MODL_DATA')
        if local_data is not None:
            paths.extend(local_data.split(os.pathsep))
        paths.append(os.path.expanduser('~/modl_data'))
    return paths
