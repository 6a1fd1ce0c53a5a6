"""fMRI maskers and the offline ``.npy`` record pipeline, on the host.

Counterpart of ``modl_tpu/input_data/fmri`` without nilearn or nibabel:
masks are boolean arrays or ``.npy`` files, records 4-D arrays or
pre-unmasked 2-D ``.npy`` files; any other input raises. The NIfTI
patches of the JAX package's ``fixes.py`` are not ported.
"""
from .base import (BaseNilearnEstimator, NumpyMasker, check_embedded_masker,
                   check_embedded_nifti_masker)
from .rest import create_raw_rest_data, get_raw_rest_data
from .unmask import MultiRawMasker

__all__ = ["BaseNilearnEstimator", "NumpyMasker", "check_embedded_masker",
           "check_embedded_nifti_masker", "create_raw_rest_data",
           "get_raw_rest_data", "MultiRawMasker"]
