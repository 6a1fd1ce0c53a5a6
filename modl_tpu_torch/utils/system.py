"""Cache and output directory resolution (counterpart of
``modl_tpu/utils/system.py``, without its XLA compilation cache, which
has no counterpart here)."""
import os

__all__ = ["get_cache_dirs", "get_output_dir"]


def get_cache_dirs(cache_dir=None):
    """Cache directory chain: arg > SHARED_CACHE > CACHE > ~/cache."""
    paths = []
    if cache_dir is not None:
        paths.extend(cache_dir.split(os.pathsep))
    else:
        global_data = os.getenv('SHARED_CACHE')
        if global_data is not None:
            paths.extend(global_data.split(os.pathsep))
        local_data = os.getenv('CACHE')
        if local_data is not None:
            paths.extend(local_data.split(os.pathsep))
        paths.append(os.path.expanduser('~/cache'))
    return paths


def get_output_dir(data_dir=None):
    """Output directory: arg > MODL_OUTPUT > ~/output/modl."""
    if data_dir is not None:
        return str(data_dir)
    output_dir = os.getenv('MODL_OUTPUT')
    if output_dir is not None:
        return str(output_dir)
    return os.path.expanduser('~/output/modl')
