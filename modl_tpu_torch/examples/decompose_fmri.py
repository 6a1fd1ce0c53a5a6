"""Sparse spatial maps from rest-fMRI (counterpart of
``examples/decompose_fmri.py``: 20 components, reduction 12).

    python -m modl_tpu_torch.examples.decompose_fmri [--n-components K]
        [--reduction R] [--n-epochs E] [--method M] [--device D]

ADHD through nilearn's fetcher where it is installed, otherwise
synthetic rest data with planted networks.
"""
import argparse
import time

from ..decomposition.fmri import fMRIDictFact, rfMRIDictionaryScorer


def main(n_components=20, reduction=12, n_epochs=5, method='masked',
         batch_size=50, device='cuda'):
    try:
        from ..datasets.adhd import fetch_adhd
        dataset = fetch_adhd(n_subjects=8)
        imgs = dataset['func']
        mask = None
        print('using ADHD data (%d records)' % len(imgs))
    except Exception as e:
        print('falling back to synthetic rest data (%s)' % e)
        from ..datasets.adhd import make_synthetic_rest_data
        imgs, mask, _ = make_synthetic_rest_data(
            n_subjects=8, n_frames=120, shape=(16, 16, 12), n_networks=12)

    train, test = imgs[:-2], imgs[-2:]
    scorer = rfMRIDictionaryScorer(test)
    dict_fact = fMRIDictFact(method=method,
                             n_components=n_components,
                             reduction=reduction,
                             batch_size=batch_size,
                             n_epochs=n_epochs,
                             alpha=1e-3,
                             mask=mask,
                             standardize=False, detrend=False,
                             random_state=0,
                             verbose=10,
                             callback=scorer,
                             device=device)
    t0 = time.perf_counter()
    dict_fact.fit(train)
    print('fit in %.1fs (io %.1fs / compute %.1fs)'
          % (time.perf_counter() - t0, dict_fact.io_time_,
             dict_fact.cpu_time_))
    print('test objective trajectory:', ['%.4f' % s for s in scorer.score])
    print('final test objective: %.5f' % dict_fact.score(test))
    return dict_fact


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--n-components', type=int, default=20)
    p.add_argument('--reduction', type=float, default=12)
    p.add_argument('--n-epochs', type=int, default=5)
    p.add_argument('--method', default='masked')
    p.add_argument('--device', default='cuda')
    a = p.parse_args()
    main(n_components=a.n_components, reduction=a.reduction,
         n_epochs=a.n_epochs, method=a.method, device=a.device)
