"""HCP-scale decomposition (counterpart of ``exps/hcp/decompose_hcp.py``:
1,024 components, reduction 20, batch 200, lr 0.92).

    python -m modl_tpu_torch.exps.hcp.decompose_hcp [records_dir]

Streams the raw ``.npy`` records that ``unmask_hcp`` wrote through
``fMRIDictFact`` on the card (``device='cpu'`` runs it on the host) and
saves the components to ``<output>/hcp_components.npy``, their columns
in the records' stored voxel order.

Unlike the ``exps/`` script, which passes ``masker.mask_img_``, this
driver passes the manifest's masker whole, as ``modl_tpu``'s
``fMRIDictFact(mask=masker)`` takes it. The fit then knows that the
records are stored in a fixed random voxel order: it draws windows of
that order and defers B's EMA to segment ends, where the EMA-GEMM
kernel runs. Given the bare mask, it would draw gathered voxel subsets
and run no EMA-GEMM kernel. The saved components are in stored order
either way.
"""
import os
import sys

import numpy as np

from ...decomposition.fmri import fMRIDictFact
from ...input_data.fmri import get_raw_rest_data
from ...utils.system import get_output_dir


def main(records_dir=None, n_components=1024, reduction=20, batch_size=200,
         learning_rate=0.92, alpha=1e-4, n_epochs=1, device='cuda'):
    records_dir = records_dir or os.path.join(get_output_dir(),
                                              'unmasked', 'hcp')
    if not os.path.exists(os.path.join(records_dir, 'data.json')):
        print('no raw records under %s - run the unmask pipeline first '
              '(modl_tpu_torch.exps.hcp.unmask_hcp)' % records_dir)
        return None
    masker, records = get_raw_rest_data(records_dir)
    dict_fact = fMRIDictFact(method='masked',
                             n_components=n_components,
                             reduction=reduction,
                             batch_size=batch_size,
                             learning_rate=learning_rate,
                             alpha=alpha,
                             n_epochs=n_epochs,
                             mask=masker,
                             standardize=False, detrend=False,
                             random_state=0, verbose=20, device=device)
    dict_fact.fit(records)
    out = os.path.join(get_output_dir(), 'hcp_components.npy')
    np.save(out, dict_fact.components_)
    print('saved', out)
    return dict_fact


if __name__ == '__main__':
    main(records_dir=sys.argv[1] if len(sys.argv) > 1 else None)
