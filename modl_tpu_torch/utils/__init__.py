"""Host-side utilities of the port (counterpart of ``modl_tpu/utils``)."""
import numpy as np

__all__ = ["get_sub_slice", "concatenated_cv"]


def get_sub_slice(indices, sub_indices):
    """Resolve ``sub_indices`` relative to an outer ``indices`` selection.

    Both levels may be a slice or an integer array; ``indices=None``
    means the identity selection. Slices compose by offset arithmetic
    without materialising the outer range.
    """
    if indices is None:
        indices = slice(0, None)
    if not isinstance(indices, slice):
        return np.asarray(indices)[sub_indices]
    base = indices.start or 0
    if isinstance(sub_indices, slice):
        return np.arange(base + sub_indices.start, base + sub_indices.stop)
    return base + np.asarray(sub_indices)


def concatenated_cv(cvs):
    """Merge parallel CV generators into folds of concatenated indices."""
    for splits in zip(*cvs):
        trains, tests = zip(*splits)
        yield np.concatenate(trains), np.concatenate(tests)
