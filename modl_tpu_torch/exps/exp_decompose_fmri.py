"""fMRI decomposition experiment (counterpart of
``exps/exp_decompose_fmri.py``: 70 components, reduction 12).

    python -m modl_tpu_torch.exps.exp_decompose_fmri

One run through ``utils.experiment.Experiment`` (config/info/run JSON
under ``<output>/decompose_fmri/<run>``). ADHD through nilearn where it
is installed, else synthetic rest data; the fit runs on the card unless
the config's ``device`` is ``'cpu'``.
"""
import time

import numpy as np

from ..decomposition.fmri import fMRIDictFact, rfMRIDictionaryScorer
from ..utils.experiment import Experiment
from ..utils.system import get_output_dir

exp = Experiment('decompose_fmri')


@exp.config
def config():
    return dict(n_components=70,
                batch_size=100,
                learning_rate=0.92,
                method='masked',
                reduction=12,
                alpha=3e-4,
                n_epochs=10,
                n_subjects=8,
                test_subjects=2,
                seed=0,
                device='cuda')


@exp.main
def main(n_components, batch_size, learning_rate, method, reduction, alpha,
         n_epochs, n_subjects, test_subjects, seed, device, _run):
    try:
        from ..datasets.adhd import fetch_adhd
        dataset = fetch_adhd(n_subjects=n_subjects + test_subjects)
        imgs, mask = dataset['func'], None
    except Exception:
        from ..datasets.adhd import make_synthetic_rest_data
        imgs, mask, _ = make_synthetic_rest_data(
            n_subjects=n_subjects + test_subjects, n_frames=150,
            shape=(16, 16, 12), n_networks=max(4, n_components // 2))
    train, test = imgs[:n_subjects], imgs[n_subjects:]

    scorer = rfMRIDictionaryScorer(test, info=_run.info,
                                   artifact_dir=_run.dir)
    dict_fact = fMRIDictFact(method=method, n_components=n_components,
                             reduction=reduction, batch_size=batch_size,
                             learning_rate=learning_rate, alpha=alpha,
                             n_epochs=n_epochs, mask=mask,
                             standardize=False, detrend=False,
                             random_state=seed, verbose=15,
                             callback=scorer, device=device)
    t0 = time.perf_counter()
    dict_fact.fit(train)
    _run.info['fit_time'] = time.perf_counter() - t0
    _run.info['io_time'] = dict_fact.io_time_
    _run.info['cpu_time'] = dict_fact.cpu_time_
    final = float(dict_fact.score(test))
    _run.info['final_score'] = final
    np.save('%s/components.npy' % _run.dir, dict_fact.components_)
    return final


def run(**config_updates):
    """One run under ``<output>/decompose_fmri``; returns the run."""
    exp.output_dir = '%s/decompose_fmri' % get_output_dir()
    return exp.run(config_updates=config_updates)


if __name__ == '__main__':
    run()
