"""Image decomposition experiment (counterpart of
``exps/exp_decompose_images.py``: 128 components, 16 x 16 patches).

    python -m modl_tpu_torch.exps.exp_decompose_images

One run through ``utils.experiment.Experiment`` (config/info/run JSON
under ``<output>/decompose_images/<run>``). The image comes from
``datasets.image.load_image(source)``, else a synthetic one; the fit
runs on the card unless the config's ``device`` is ``'cpu'``.
"""
import time

import numpy as np

from ..decomposition.image import DictionaryScorer, ImageDictFact
from ..feature_extraction.image import LazyCleanPatchExtractor
from ..utils.experiment import Experiment
from ..utils.system import get_output_dir

exp = Experiment('decompose_images')


@exp.config
def config():
    return dict(source='face',
                batch_size=200,
                learning_rate=0.92,
                reduction=8,
                alpha=0.08,
                n_epochs=4,
                n_components=128,
                patch_size=16,
                test_size=2000,
                method='masked',
                setting='dictionary learning',
                seed=0,
                device='cuda')


@exp.main
def main(source, batch_size, learning_rate, reduction, alpha, n_epochs,
         n_components, patch_size, test_size, method, setting, seed, device,
         _run):
    from ..datasets.image import load_image, make_synthetic_image
    try:
        image = load_image(source, gray=(source == 'face'))
    except Exception:
        image = make_synthetic_image(256, 256)

    extractor = LazyCleanPatchExtractor(patch_size=(patch_size, patch_size),
                                        max_patches=test_size,
                                        random_state=seed + 1)
    test_patches = extractor.fit(image).transform()

    scorer = DictionaryScorer(test_patches, info=_run.info)
    dict_fact = ImageDictFact(method=method, setting=setting,
                              n_components=n_components,
                              batch_size=batch_size,
                              reduction=reduction,
                              patch_size=(patch_size, patch_size),
                              n_epochs=n_epochs, alpha=alpha,
                              learning_rate=learning_rate,
                              callback=scorer, verbose=5,
                              random_state=seed, device=device)
    t0 = time.perf_counter()
    dict_fact.fit(image)
    _run.info['fit_time'] = time.perf_counter() - t0
    final = float(dict_fact.score(test_patches))
    _run.info['final_score'] = final
    np.save('%s/components.npy' % _run.dir, dict_fact.components_)
    return final


def run(**config_updates):
    """One run under ``<output>/decompose_images``; returns the run."""
    exp.output_dir = '%s/decompose_images' % get_output_dir()
    return exp.run(config_updates=config_updates)


if __name__ == '__main__':
    run()
