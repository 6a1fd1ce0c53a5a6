"""fMRI maskers, the NIfTI caching patches and the offline ``.npy``
record pipeline, on the host.

Counterpart of ``modl_tpu/input_data/fmri``: masks are boolean arrays,
``.npy`` files or, where nilearn is installed, NIfTI images; records 4-D
arrays, pre-unmasked 2-D ``.npy`` files or NIfTI images. nibabel,
nilearn and joblib are imported only where a NIfTI input needs them.
"""
from .base import (BaseNilearnEstimator, NumpyMasker, check_embedded_masker,
                   check_embedded_nifti_masker, safe_to_filename)
from .fixes import monkey_patch_nifti_image, monkey_patch_nilearn_caching
from .rest import create_raw_rest_data, get_raw_rest_data
from .unmask import MultiRawMasker

__all__ = ["BaseNilearnEstimator", "NumpyMasker", "check_embedded_masker",
           "check_embedded_nifti_masker", "safe_to_filename",
           "monkey_patch_nifti_image", "monkey_patch_nilearn_caching",
           "create_raw_rest_data", "get_raw_rest_data", "MultiRawMasker"]
