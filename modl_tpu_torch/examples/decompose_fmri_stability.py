"""Stability-based model selection for fMRI decompositions (counterpart
of ``examples/decompose_fmri_stability.py``): the Amari discrepancy
across seeds over a grid of component counts, on synthetic rest data.

    python -m modl_tpu_torch.examples.decompose_fmri_stability [--device D]
"""
import argparse

from ..datasets.adhd import make_synthetic_rest_data
from ..decomposition.fmri import fMRIDictFact
from ..decomposition.stability import mean_amari_discrepency


def main(n_components_list=(4, 6, 8), n_runs=3, device='cuda'):
    imgs, mask, _ = make_synthetic_rest_data(
        n_subjects=6, n_frames=80, shape=(12, 12, 8), n_networks=6)
    results = {}
    for k in n_components_list:
        dictionaries = []
        for seed in range(n_runs):
            df = fMRIDictFact(method='masked', n_components=k, reduction=3,
                              batch_size=20, n_epochs=2, alpha=1e-3,
                              mask=mask, standardize=False, detrend=False,
                              random_state=seed, device=device)
            df.fit(imgs)
            dictionaries.append(df.components_)
        mean_d, std_d = mean_amari_discrepency(dictionaries)
        results[k] = (mean_d, std_d)
        print('n_components=%-3d discrepancy %.4f +- %.4f'
              % (k, mean_d, std_d))
    best = min(results, key=lambda k: results[k][0])
    print('most stable size: %d' % best)
    return results


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--device', default='cuda')
    main(device=p.parse_args().device)
