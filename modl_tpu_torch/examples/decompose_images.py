"""Patch dictionary learning on an image (counterpart of
``examples/decompose_images.py``: 100 components, 16 x 16 patches).

    python -m modl_tpu_torch.examples.decompose_images [--source S]
        [--n-components K] [--method M] [--reduction R] [--n-epochs E]
        [--plot] [--device D]

The image comes from ``datasets.image.load_image(source)`` ('face' is
scipy's raccoon face, which scipy downloads once; 'lisboa' and 'aviris'
read files under the modl data dir), otherwise a synthetic image.
``--plot`` saves the components with ``plotting.image.plot_patches``.
"""
import argparse
import time

from ..decomposition.image import DictionaryScorer, ImageDictFact
from ..feature_extraction.image import LazyCleanPatchExtractor


def main(source='face', n_components=100, method='masked', reduction=10,
         batch_size=200, n_epochs=3, patch_size=16, plot=False,
         device='cuda'):
    from ..datasets.image import load_image, make_synthetic_image
    try:
        image = load_image(source, gray=(source == 'face'))
    except Exception as e:
        print('falling back to synthetic image (%s)' % e)
        image = make_synthetic_image(256, 256)
    print('image:', image.shape)

    extractor = LazyCleanPatchExtractor(
        patch_size=(patch_size, patch_size), max_patches=2000,
        random_state=1)
    test_patches = extractor.fit(image).transform()

    scorer = DictionaryScorer(test_patches)
    dict_fact = ImageDictFact(method=method,
                              n_components=n_components,
                              batch_size=batch_size,
                              reduction=reduction,
                              patch_size=(patch_size, patch_size),
                              n_epochs=n_epochs,
                              alpha=0.1,
                              learning_rate=0.92,
                              callback=scorer,
                              verbose=5,
                              random_state=0,
                              device=device)
    t0 = time.perf_counter()
    dict_fact.fit(image)
    print('fit in %.1fs; final test objective %.5f'
          % (time.perf_counter() - t0, dict_fact.score(test_patches)))
    print('objective trajectory:',
          ['%.4f' % s for s in scorer.score])

    if plot:
        import matplotlib.pyplot as plt
        from ..plotting.image import plot_patches
        fig = plt.figure(figsize=(8, 8))
        plot_patches(fig, dict_fact.components_)
        fig.savefig('components.png')
        print('saved components.png')
    return dict_fact


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--source', default='face')
    p.add_argument('--n-components', type=int, default=100)
    p.add_argument('--method', default='masked')
    p.add_argument('--reduction', type=float, default=10)
    p.add_argument('--n-epochs', type=int, default=3)
    p.add_argument('--plot', action='store_true')
    p.add_argument('--device', default='cuda')
    a = p.parse_args()
    main(source=a.source, n_components=a.n_components, method=a.method,
         reduction=a.reduction, n_epochs=a.n_epochs, plot=a.plot,
         device=a.device)
