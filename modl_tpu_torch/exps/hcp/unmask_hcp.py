"""Offline unmasking of HCP-scale records into raw ``.npy`` (counterpart
of ``exps/hcp/unmask_hcp.py``).

    python -m modl_tpu_torch.exps.hcp.unmask_hcp [source_dir [n_jobs]]

``source_dir`` holds 4-D ``.npy`` volumes and their 3-D ``mask.npy``;
without it the script makes synthetic HCP-like records. Every ``.npy``
file there is taken as a record, as in the ``exps/`` script: the mask
itself fails to unmask and leaves a ``record_<i>-error`` file. The records are
standardized, stored in a fixed random voxel order (``feature_order=0``)
under ``<output>/unmasked/hcp`` with the ``data.json`` manifest that
``decompose_hcp`` streams. Host only: nothing runs on the card.
"""
import os
import sys

import numpy as np

from ...input_data.fmri import create_raw_rest_data
from ...utils.system import get_output_dir


def main(source_dir=None, n_jobs=1):
    out = os.path.join(get_output_dir(), 'unmasked', 'hcp')
    if source_dir and os.path.isdir(source_dir):
        imgs = [os.path.join(source_dir, f)
                for f in sorted(os.listdir(source_dir))
                if f.endswith('.npy')]
        mask = np.load(os.path.join(source_dir, 'mask.npy'))
    else:
        print('no source dir; generating synthetic HCP-like records')
        from ...datasets.adhd import make_synthetic_rest_data
        imgs, mask, _ = make_synthetic_rest_data(
            n_subjects=4, n_frames=300, shape=(24, 24, 16),
            n_networks=32)
    manifest = create_raw_rest_data(imgs, mask, out, standardize=True,
                                    feature_order=0,
                                    detrend=False, n_jobs=n_jobs)
    print('manifest:', manifest)
    return manifest


if __name__ == '__main__':
    main(source_dir=sys.argv[1] if len(sys.argv) > 1 else None,
         n_jobs=int(sys.argv[2]) if len(sys.argv) > 2 else 1)
