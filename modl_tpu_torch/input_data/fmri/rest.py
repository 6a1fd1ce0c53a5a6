"""Offline unmask pipeline: volumes -> raw ``.npy`` records + manifest.

Counterpart of ``modl_tpu/input_data/fmri/rest.py`` with the same
on-disk layout, so either package reads what the other wrote: one 2-D
``record_<i>.npy`` per record, ``mask.npy``, ``feature_order.npy`` when
records are stored in a fixed random voxel order, and a ``data.json``
manifest. A record that fails to unmask writes a ``record_<i>-error``
file with the traceback and is skipped.
"""
import json
import os
import traceback

import numpy as np

from .base import NumpyMasker

__all__ = ["create_raw_rest_data", "get_raw_rest_data"]


def _single_mask(masker, img, dump_dir, index, dtype=np.float32):
    name = 'record_%i' % index
    try:
        data = masker.transform(img)
        path = os.path.join(dump_dir, name + '.npy')
        np.save(path, np.asarray(data, dtype))
        return path, data.shape[0]
    except Exception:
        # skip-and-log: one corrupt record must not end the whole pass
        err_path = os.path.join(dump_dir, name + '-error')
        with open(err_path, 'w') as f:
            f.write(traceback.format_exc())
        return None, 0


def create_raw_rest_data(imgs, mask, dump_dir, standardize=True,
                         detrend=True, n_jobs=1, feature_order=None,
                         dtype=np.float32):
    """Unmask every record into dump_dir; returns the manifest path.

    imgs: list of 4-D arrays / ``.npy`` paths; mask: 3-D bool array.
    feature_order: None | int seed | permutation; records are then stored
    with voxel columns in this order (``fMRIDictFact`` detects it and
    draws windows instead of gathers). dtype: storage dtype (float16
    halves disk and host-to-device volume; fits cast on the device).
    """
    os.makedirs(dump_dir, exist_ok=True)
    # incoming 2-D records are in natural voxel order: permute at store
    masker = NumpyMasker(mask_img=mask, standardize=standardize,
                         detrend=detrend, feature_order=feature_order,
                         raw_in_order=False).fit()
    if n_jobs != 1:
        from joblib import Parallel, delayed
        results = Parallel(n_jobs=n_jobs)(
            delayed(_single_mask)(masker, img, dump_dir, i, dtype)
            for i, img in enumerate(imgs))
    else:
        results = [_single_mask(masker, img, dump_dir, i, dtype)
                   for i, img in enumerate(imgs)]

    np.save(os.path.join(dump_dir, 'mask.npy'), masker.mask_img_)
    manifest = {
        'mask': os.path.join(dump_dir, 'mask.npy'),
        'records': [{'filename': p, 'n_frames': int(n)}
                    for p, n in results if p is not None],
    }
    if masker.feature_order_ is not None:
        order_path = os.path.join(dump_dir, 'feature_order.npy')
        np.save(order_path, masker.feature_order_)
        manifest['feature_order'] = order_path
    manifest_path = os.path.join(dump_dir, 'data.json')
    with open(manifest_path, 'w') as f:
        json.dump(manifest, f, indent=2)
    return manifest_path


def get_raw_rest_data(dump_dir):
    """Reload (masker, list of record paths) from a manifest directory."""
    with open(os.path.join(dump_dir, 'data.json')) as f:
        manifest = json.load(f)
    order = (np.load(manifest['feature_order'])
             if 'feature_order' in manifest else None)
    masker = NumpyMasker(mask_img=np.load(manifest['mask']),
                         feature_order=order).fit()
    records = [r['filename'] for r in manifest['records']]
    return masker, records
