"""Model selection by dictionary stability (counterpart of
``examples/stability_selection.py``): several seeds per component count
on planted data, and the count with the lowest mean Amari discrepancy.

    python -m modl_tpu_torch.examples.stability_selection [--n-runs N]
        [--device D]
"""
import argparse

import numpy as np

from ..decomposition.dict_fact import DictFact
from ..decomposition.stability import mean_amari_discrepency


def main(n_components_list=(2, 4, 8, 16), n_runs=4, n_samples=400,
         n_features=64, true_rank=8, device='cuda'):
    rng = np.random.RandomState(0)
    Q = rng.randn(true_rank, n_features)
    code = rng.randn(n_samples, true_rank)
    X = code @ Q + 0.05 * rng.randn(n_samples, n_features)

    results = {}
    for k in n_components_list:
        dictionaries = []
        for seed in range(n_runs):
            df = DictFact(n_components=k, reduction=2, code_alpha=1e-2,
                          code_l1_ratio=1, comp_l1_ratio=0, n_epochs=3,
                          batch_size=50, random_state=seed, device=device)
            df.fit(X)
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
    p.add_argument('--n-runs', type=int, default=4)
    p.add_argument('--device', default='cuda')
    a = p.parse_args()
    main(n_runs=a.n_runs, device=a.device)
