"""Patch-dictionary learning on images, over the port's ``DictFact``.

Counterpart of ``modl_tpu/decomposition/image.py``: the same method and
setting tables, clean-patch streaming, the epoch-4 Gram upgrade of
'gram', the per-epoch reduction annealing of 'reducing ratio' and the
extractor/learner co-shuffle. Patches are normalised once and kept as a
resident row matrix when they fit ``_RESIDENT_BUDGET``; larger patch
sets are gathered and normalised buffer by buffer, with the same values.
The learner always carries ``_relay_callback``, so ``DictFact`` takes
its per-step path, as in the JAX package.

``device`` places the learner (``'cuda'`` by default) and ``dtype`` its
state (float32 by default, where the BCD kernel runs; float64 is the
counterpart of the JAX package's x64 mode).
"""
import time
from math import sqrt

import numpy as np

from ..base import BaseEstimator, check_random_state
from ..feature_extraction.image import LazyCleanPatchExtractor
from ..input_data.image import scale_patches
from .dict_fact import DictFact

__all__ = ["ImageDictFact", "DictionaryScorer"]

# user-level strategy names -> SOMF aggregation flags. 'gram' starts
# masked and upgrades to an exact Gram at epoch 5; 'reducing ratio'
# anneals `reduction` toward 1 every epoch (see fit())
PATCH_METHODS = {
    'masked': dict(G_agg='masked', Dx_agg='masked'),
    'dictionary only': dict(G_agg='full', Dx_agg='full'),
    'gram': dict(G_agg='masked', Dx_agg='masked'),
    'average': dict(G_agg='average', Dx_agg='average'),
    'reducing ratio': dict(G_agg='masked', Dx_agg='masked'),
    'sgd': dict(G_agg='full', Dx_agg='full'),
}

# problem settings: sparse-code dictionary learning vs NMF
PATCH_SETTINGS = {
    'dictionary learning': dict(comp_l1_ratio=0, code_l1_ratio=1,
                                comp_pos=False, code_pos=False,
                                with_std=True, with_mean=True),
    'NMF': dict(comp_l1_ratio=0, code_l1_ratio=1,
                comp_pos=True, code_pos=True,
                with_std=True, with_mean=False),
}

# resident patch matrices up to this many elements (~200 MB float32)
# are normalised once and kept on the host for all epochs
_RESIDENT_BUDGET = 50_000_000


class _PatchStream:
    """Epoch-ready source of normalised, flattened patch rows.

    Wraps a fitted LazyCleanPatchExtractor. ``rows(sl)`` returns the
    same values whether the patch set is resident or gathered per
    buffer, and ``shuffle(perm)`` keeps the stream aligned with the
    learner's co-permuted state."""

    def __init__(self, extractor, with_mean, with_std):
        self._extractor = extractor
        self._with_mean = with_mean
        self._with_std = with_std
        n_elems = extractor.n_patches_ * int(
            np.prod(extractor.patch_shape_))
        self._resident = None
        if n_elems <= _RESIDENT_BUDGET:
            self._resident = self._normalize(
                extractor.partial_transform(batch=None))

    def _normalize(self, patches):
        flat = scale_patches(patches, with_mean=self._with_mean,
                             with_std=self._with_std, copy=False)
        return flat.reshape(len(flat), -1)

    def rows(self, sl):
        if self._resident is not None:
            return self._resident[sl]
        return self._normalize(self._extractor.partial_transform(batch=sl))

    def shuffle(self, permutation):
        self._extractor.shuffle(permutation)
        if self._resident is not None:
            self._resident = self._resident[permutation]

    @property
    def n_rows(self):
        return self._extractor.n_patches_


class ImageDictFact(BaseEstimator):
    """Dictionary / NMF decomposition of image patches via SOMF."""

    methods = PATCH_METHODS
    settings = PATCH_SETTINGS

    def __init__(self, method='masked', setting='dictionary learning',
                 patch_size=(8, 8), batch_size=100, buffer_size=None,
                 step_size=1e-3, n_components=50, alpha=0.1,
                 learning_rate=0.92, reduction=10, n_epochs=1,
                 random_state=None, callback=None, max_patches=None,
                 verbose=0, n_threads=1, device='cuda', dtype=np.float32):
        self.method = method
        self.setting = setting
        self.patch_size = patch_size
        self.batch_size = batch_size
        self.buffer_size = buffer_size
        self.step_size = step_size
        self.n_components = n_components
        self.alpha = alpha
        self.learning_rate = learning_rate
        self.reduction = reduction
        self.n_epochs = n_epochs
        self.random_state = random_state
        self.callback = callback
        self.max_patches = max_patches
        self.verbose = verbose
        self.n_threads = n_threads
        self.device = device
        self.dtype = dtype

    # -- learner construction -------------------------------------------

    def _learner(self):
        strategy = PATCH_METHODS[self.method]
        problem = PATCH_SETTINGS[self.setting]
        sgd = self.method == 'sgd'
        return DictFact(
            n_components=self.n_components,
            n_epochs=self.n_epochs,
            batch_size=self.batch_size,
            code_alpha=self.alpha,
            code_l1_ratio=problem['code_l1_ratio'],
            comp_l1_ratio=problem['comp_l1_ratio'],
            code_pos=problem['code_pos'],
            comp_pos=problem['comp_pos'],
            learning_rate=self.learning_rate,
            reduction=1 if sgd else self.reduction,
            G_agg=strategy['G_agg'],
            Dx_agg=strategy['Dx_agg'],
            optimizer='sgd' if sgd else 'variational',
            step_size=self.step_size,
            tol=1e-2,
            random_state=self.random_state,
            callback=self._relay_callback,
            verbose=self.verbose,
            n_threads=self.n_threads,
            dtype=self.dtype,
            device=self.device)

    def _epoch_schedule(self, epoch):
        """Apply the per-epoch strategy mutations before streaming."""
        if self.method == 'gram' and epoch == 4:
            self.dict_fact_.set_params(G_agg='full', Dx_agg='average')
        elif self.method == 'reducing ratio':
            annealed = 1 + (self.reduction - 1) / sqrt(epoch + 1)
            self.dict_fact_.set_params(reduction=annealed)

    # -- fitting ---------------------------------------------------------

    def fit(self, image, y=None):
        self.random_state = check_random_state(self.random_state)
        problem = PATCH_SETTINGS[self.setting]

        if self.verbose:
            print('Preparing patch extraction')
        extractor = LazyCleanPatchExtractor(
            patch_size=self.patch_size, max_patches=self.max_patches,
            random_state=self.random_state)
        extractor.fit(image)
        self.patch_shape_ = extractor.patch_shape_
        stream = _PatchStream(extractor, with_mean=problem['with_mean'],
                              with_std=problem['with_std'])

        if self.verbose:
            print('Fitting dictionary')
        self.dict_fact_ = self._learner()
        self.dict_fact_.prepare(n_samples=stream.n_rows,
                                X=stream.rows(slice(0, self.n_components)))

        buffer_size = self.buffer_size or self.batch_size * 10
        starts = range(0, stream.n_rows, buffer_size)
        for epoch in range(self.n_epochs):
            if self.verbose:
                print('Epoch %i' % (epoch + 1))
            if epoch:
                stream.shuffle(self.dict_fact_.shuffle())
            self._epoch_schedule(epoch)
            for lo in starts:
                window = slice(lo, min(lo + buffer_size, stream.n_rows))
                self.dict_fact_.partial_fit(stream.rows(window), window)
        return self

    # -- inference -------------------------------------------------------

    def _as_rows(self, patches):
        problem = PATCH_SETTINGS[self.setting]
        flat = scale_patches(patches, with_mean=problem['with_mean'],
                             with_std=problem['with_std'], copy=True)
        return flat.reshape(len(flat), -1)

    def transform(self, patches):
        return self.dict_fact_.transform(self._as_rows(patches))

    def score(self, patches):
        return self.dict_fact_.score(self._as_rows(patches))

    @property
    def n_iter_(self):
        return self.dict_fact_.n_iter_

    @property
    def time_(self):
        return self.dict_fact_.time_

    @property
    def components_(self):
        return self.dict_fact_.components_.reshape(
            (self.n_components,) + self.patch_shape_)

    def _relay_callback(self, *_):
        if self.callback is not None:
            self.callback(self)


class DictionaryScorer:
    """Fit callback recording the held-out objective trajectory.

    Wall-clock excludes the time spent scoring; ``time``/``cpu_time``/
    ``iter``/``score`` expose parallel trajectories, and an optional
    ``info`` dict is kept in sync for an experiment harness.
    """

    _FIELDS = ('time', 'cpu_time', 'iter', 'score')

    def __init__(self, test_data, info=None):
        self.test_data = test_data
        self.info = info
        self.test_time = 0.0
        self.start_time = time.perf_counter()
        self._trajectory = []

    def __call__(self, learner):
        tick = time.perf_counter()
        objective = learner.score(self.test_data)
        self.test_time += time.perf_counter() - tick
        wall = time.perf_counter() - self.start_time - self.test_time
        self._trajectory.append(
            dict(time=wall, cpu_time=learner.time_,
                 iter=learner.n_iter_, score=objective))
        if self.info is not None:
            self.info['time'] = self.cpu_time
            self.info['score'] = self.score
            self.info['iter'] = self.iter

    def __getattr__(self, name):
        if name in DictionaryScorer._FIELDS:
            return [point[name] for point in self._trajectory]
        raise AttributeError(name)
