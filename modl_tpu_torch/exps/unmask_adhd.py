"""Offline unmasking of rest data into raw ``.npy`` records
(counterpart of ``exps/unmask_adhd.py``).

    python -m modl_tpu_torch.exps.unmask_adhd [n_jobs]

Unmasks the ADHD records through nilearn's ``MultiNiftiMasker`` where
nilearn and the data are there, else synthetic rest data, into
``<output>/unmasked/adhd``, stored in a fixed random voxel order so the
streaming fit draws windows. Host only: nothing runs on the card.
"""
import os
import sys

import numpy as np

from ..input_data.fmri import create_raw_rest_data
from ..utils.system import get_output_dir


def main(n_jobs=1, feature_order=0):
    out = os.path.join(get_output_dir(), 'unmasked', 'adhd')
    try:
        # check for nilearn before any download: NIfTI unmasking needs
        # its masker (the numpy masker takes arrays and .npy only)
        import nilearn.input_data  # noqa: F401
        from ..datasets.adhd import fetch_adhd
        dataset = fetch_adhd(n_subjects=40)
        from nilearn.input_data import MultiNiftiMasker
        masker = MultiNiftiMasker().fit(dataset['func'])
        imgs = masker.transform(dataset['func'])  # list of 2-D records
        mask = np.asanyarray(masker.mask_img_.dataobj) != 0
    except Exception as e:
        print('synthetic fallback (%s)' % e)
        from ..datasets.adhd import make_synthetic_rest_data
        imgs, mask, _ = make_synthetic_rest_data(
            n_subjects=8, n_frames=150, shape=(16, 16, 12))
    manifest = create_raw_rest_data(imgs, mask, out, standardize=True,
                                    detrend=False, n_jobs=n_jobs,
                                    feature_order=feature_order)
    print('manifest:', manifest)
    return manifest


if __name__ == '__main__':
    main(n_jobs=int(sys.argv[1]) if len(sys.argv) > 1 else 1)
