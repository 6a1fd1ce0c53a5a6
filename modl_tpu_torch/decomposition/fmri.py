"""fMRI dictionary learning: sparse spatial maps from rest-fMRI streams.

Counterpart of ``modl_tpu/decomposition/fmri.py`` on PyTorch: the same
estimators (``fMRIDictFact``, ``fMRICoder``, ``rfMRIDictionaryScorer``),
method table, record-streaming driver, epoch-5 Gram upgrade, reduction
annealing and sign flip, over the host maskers of
``modl_tpu_torch.input_data.fmri`` (numpy masks and ``.npy`` records;
NIfTI images through nilearn where it is installed). ``device`` places
the inner ``DictFact`` and ``Coder``.

The driver streams records through ``DictFact._partial_fit_device``.
On the raw path (a masker with ``transform_raw``, no temporal filter, no
confounds) a 2-deep prefetch ring of loader threads copies each record
from its memory map into pinned host memory and on to the card on a
side stream, while the card trains on the previous record; detrend and
standardize then run on the device (``_clean_device``). Multi-epoch raw
fits keep the transferred records on the card (``_RecordCache``).
Other maskers (nilearn's) clean each record on the host, and the fit
copies the cleaned rows in the state's dtype.

The JAX package's documented deviation from the reference holds: the
'gram' upgrade and the per-sample indices of 'average'/'gram' are live.
"""
import itertools
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from math import sqrt

import numpy as np
import torch

from ..base import TransformerMixin, check_random_state
from ..input_data.fmri.base import BaseNilearnEstimator
from ..ops.precision import precise
from .dict_fact import Coder, DictFact, _PickleStateMixin, _torch_dtype

# largest record the prefetch ring stages on the card ahead of use
# (bigger records transfer when they are trained on, so that PREFETCH + 1
# of them cannot crowd the learner state out of device memory)
H2D_STAGE_BYTES = 1 << 30

# cross-epoch budget of records kept on the device: epochs >= 2 of a raw
# fit replay them instead of paying the host-to-device copy again. The
# cached tensor is the one the stream produced (the record's stored
# dtype: float16 records take half the room); LRU eviction; 0 disables.
RECORD_CACHE_BYTES = 2 << 30

# records the loader threads prepare ahead of the one being trained on
PREFETCH = 2

__all__ = ["fMRIDictFact", "fMRICoder", "fMRICoderMixin",
           "rfMRIDictionaryScorer"]


class _RecordCache:
    """LRU cache of device tensors keyed by record index (thread-safe:
    the loader threads get and put concurrently)."""

    def __init__(self, budget_bytes):
        self.budget = int(budget_bytes)
        self.hits = 0
        self.misses = 0
        self.nbytes = 0
        self._d = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key][0]
            self.misses += 1
            return None

    def put(self, key, dev, nbytes):
        if nbytes > self.budget:
            return
        with self._lock:
            if key in self._d:
                return
            while self.nbytes + nbytes > self.budget and self._d:
                # drop the reference only: a step in flight may still use
                # the evicted tensor; the caching allocator frees it when
                # the last reference and its recorded streams are done
                _, (_, old_bytes) = self._d.popitem(last=False)
                self.nbytes -= old_bytes
            self._d[key] = (dev, nbytes)
            self.nbytes += nbytes


def _lazy_scan(imgs):
    """Record lengths + dtype without loading voxel data (NIfTI records
    through nilearn's ``check_niimg``: the header's length and dtype)."""
    n_samples_list = []
    dtype = np.float32
    for img in imgs:
        if isinstance(img, str) and img.endswith('.npy'):
            arr = np.load(img, mmap_mode='r')
            n = arr.shape[0]
            dtype = arr.dtype
        elif isinstance(img, np.ndarray):
            n = img.shape[-1] if img.ndim == 4 else img.shape[0]
            dtype = img.dtype
        else:  # NIfTI path or image, via nilearn
            from nilearn._utils import check_niimg
            ni = check_niimg(img)
            n = ni.shape[3]
            dtype = ni.get_data_dtype()
        n_samples_list.append(int(n))
    return n_samples_list, np.dtype(dtype)


def _flip(components):
    """Flip each component's sign so its positive part dominates."""
    components = components.copy()
    for component in components:
        if np.sum(component < 0) > np.sum(component > 0):
            component *= -1
    return components


def _mask_record(masker, img, confounds=None):
    """Module-level so joblib can pickle it for Parallel / Memory."""
    return masker.transform(img, confounds=confounds)


@precise
def _clean_device(X, detrend, standardize, dtype):
    """Detrend (mean + linear trend) and standardize a (t, voxels)
    record on its device in ``dtype`` (torch), the ``NumpyMasker``
    stages moved off the host; float16 records are cast first."""
    X = X.to(dtype)
    if detrend:
        X = X - X.mean(0)
        t = torch.arange(X.shape[0], dtype=dtype, device=X.device)
        t = t - t.mean()
        denom = torch.sum(t * t)
        slope = (t @ X) / torch.where(denom > 0, denom,
                                      torch.ones_like(denom))
        X = X - t[:, None] * slope[None, :]
    if standardize:
        X = X - X.mean(0)
        std = X.std(0, correction=0)
        X = X / torch.where(std == 0, torch.ones_like(std), std)
    return X


def _host_tensor(arr):
    """A CPU tensor holding a copy of ``arr`` (memory maps are
    read-only, so ``torch.from_numpy`` cannot take them)."""
    return torch.tensor(np.asarray(arr))


def _check_dict_init(dict_init, masker, n_components=None):
    """Accept ndarray dictionaries or maskable images."""
    if dict_init is None:
        return None
    if isinstance(dict_init, np.ndarray) and dict_init.ndim == 2:
        components = dict_init
    else:
        components = masker.transform(dict_init)
        if isinstance(components, list):
            components = np.concatenate(components, axis=0)
    if n_components is not None:
        return components[:n_components]
    return components


class fMRICoderMixin(_PickleStateMixin, BaseNilearnEstimator,
                     TransformerMixin):
    """Masker + fixed-dictionary coding over image lists."""

    def __init__(self, n_components=20, alpha=0.1, dict_init=None,
                 transform_batch_size=None, mask=None, smoothing_fwhm=None,
                 standardize=True, detrend=True, low_pass=None,
                 high_pass=None, t_r=None, target_affine=None,
                 target_shape=None, mask_strategy='background',
                 mask_args=None, memory=None, memory_level=2, n_jobs=1,
                 verbose=0, device='cuda'):
        BaseNilearnEstimator.__init__(
            self, mask=mask, smoothing_fwhm=smoothing_fwhm,
            standardize=standardize, detrend=detrend, low_pass=low_pass,
            high_pass=high_pass, t_r=t_r, target_affine=target_affine,
            target_shape=target_shape, mask_strategy=mask_strategy,
            mask_args=mask_args, memory=memory, memory_level=memory_level,
            n_jobs=n_jobs, verbose=verbose)
        self.n_components = n_components
        self.transform_batch_size = transform_batch_size
        self.dict_init = dict_init
        self.alpha = alpha
        self.device = device

    def _coder(self):
        return Coder(dictionary=self.components_, code_alpha=self.alpha,
                     code_l1_ratio=0, n_threads=self.n_jobs,
                     device=self.device).fit()

    def fit(self, imgs=None, y=None, confounds=None):
        if imgs is not None:
            BaseNilearnEstimator.fit(self, imgs, confounds=confounds)
        elif self.dict_init is not None:
            BaseNilearnEstimator.fit(self, self.dict_init)
        else:
            BaseNilearnEstimator.fit(self)
        self.components_ = _check_dict_init(self.dict_init, self.masker_,
                                            self.n_components)
        if self.components_ is not None:
            self.components_img_ = self.masker_.inverse_transform(
                self.components_)
            self.coder_ = self._coder()
        return self

    def _imgs_list(self, imgs):
        if isinstance(imgs, str) or isinstance(imgs, np.ndarray) \
                or not hasattr(imgs, '__iter__'):
            return [imgs]
        return list(imgs)

    def _masked_records(self, imgs, confounds=None):
        """Unmask every record, joblib-parallel over records and
        optionally cached; coding on the device stays serial."""
        confounds = (list(confounds) if confounds is not None
                     else [None] * len(imgs))
        mask_one = _mask_record
        if self.memory is not None:
            from joblib import Memory
            memory = (self.memory if isinstance(self.memory, Memory)
                      else Memory(location=self.memory, verbose=0))
            mask_one = memory.cache(_mask_record)
        if self.n_jobs not in (None, 1) and len(imgs) > 1:
            from joblib import Parallel, delayed
            return Parallel(n_jobs=self.n_jobs)(
                delayed(mask_one)(self.masker_, img, conf)
                for img, conf in zip(imgs, confounds))
        return [mask_one(self.masker_, img, conf)
                for img, conf in zip(imgs, confounds)]

    def transform(self, imgs, confounds=None):
        """Per-record code loadings."""
        imgs = self._imgs_list(imgs)
        return [self.coder_.transform(
                    data, batch_size=self.transform_batch_size)
                for data in self._masked_records(imgs, confounds)]

    def score(self, imgs, confounds=None):
        """Length-weighted mean objective over records."""
        imgs = self._imgs_list(imgs)
        scores, lens = [], []
        for data in self._masked_records(imgs, confounds):
            scores.append(self.coder_.score(data))
            lens.append(data.shape[0])
        scores = np.array(scores)
        lens = np.array(lens)
        return float(np.sum(scores * lens) / np.sum(lens))


class fMRIDictFact(fMRICoderMixin):
    """Sparse spatial-map dictionary learning on fMRI records.

    method: one of {'masked', 'dictionary only', 'gram', 'average',
    'reducing ratio', 'sgd'} -> (G_agg, Dx_agg, optimizer) table.
    ``device`` places the inner ``DictFact`` and ``Coder`` (``'cuda'``
    by default; raises where there is no card).
    """

    methods = {'masked': {'G_agg': 'masked', 'Dx_agg': 'masked'},
               'dictionary only': {'G_agg': 'full', 'Dx_agg': 'full'},
               'gram': {'G_agg': 'masked', 'Dx_agg': 'masked'},
               'average': {'G_agg': 'average', 'Dx_agg': 'average'},
               'reducing ratio': {'G_agg': 'masked', 'Dx_agg': 'masked'}}

    def __init__(self, method='masked', n_components=20, n_epochs=1,
                 alpha=0.1, dict_init=None, random_state=None,
                 batch_size=20, reduction=1, learning_rate=1,
                 positive=False, step_size=1, transform_batch_size=None,
                 mask=None, smoothing_fwhm=None, standardize=True,
                 detrend=True, low_pass=None, high_pass=None, t_r=None,
                 target_affine=None, target_shape=None,
                 mask_strategy='background', mask_args=None, memory=None,
                 memory_level=2, n_jobs=1, verbose=0, callback=None,
                 device='cuda'):
        fMRICoderMixin.__init__(
            self, n_components=n_components, alpha=alpha,
            dict_init=dict_init, mask=mask, smoothing_fwhm=smoothing_fwhm,
            standardize=standardize, detrend=detrend, low_pass=low_pass,
            high_pass=high_pass, t_r=t_r,
            transform_batch_size=transform_batch_size,
            target_affine=target_affine, target_shape=target_shape,
            mask_strategy=mask_strategy, mask_args=mask_args, memory=memory,
            memory_level=memory_level, n_jobs=n_jobs, verbose=verbose,
            device=device)
        self.method = method
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.reduction = reduction
        self.learning_rate = learning_rate
        self.positive = positive
        self.step_size = step_size
        self.random_state = random_state
        self.callback = callback

    def fit(self, imgs=None, y=None, confounds=None):
        if imgs is None:
            return fMRICoderMixin.fit(self)
        imgs = self._imgs_list(imgs)
        fMRICoderMixin.fit(self, imgs)

        compute = self._compute_components
        if self.memory is not None:
            from joblib import Memory
            memory = (self.memory if isinstance(self.memory, Memory)
                      else Memory(location=self.memory, verbose=0))
            compute = memory.cache(self._compute_components,
                                   ignore=['self'])
        self.components_ = compute(imgs, confounds=confounds)
        self.components_img_ = self.masker_.inverse_transform(
            self.components_)
        self.coder_ = self._coder()
        return self

    def _compute_components(self, imgs, confounds=None):
        """The record-streaming training driver."""
        masker = self.masker_
        method = self.method
        reduction = self.reduction
        random_state = check_random_state(self.random_state)

        dict_init = _check_dict_init(self.dict_init, masker,
                                     self.n_components)
        n_components = self.n_components
        if dict_init is not None:
            n_components = dict_init.shape[0]

        if method == 'sgd':
            optimizer = 'sgd'
            G_agg, Dx_agg = 'full', 'full'
            reduction = 1
        else:
            table = fMRIDictFact.methods[method]
            G_agg, Dx_agg = table['G_agg'], table['Dx_agg']
            optimizer = 'variational'

        if self.verbose:
            print('Scanning data')
        n_records = len(imgs)
        if confounds is None:
            confounds = list(itertools.repeat(None, n_records))
        data_list = list(zip(imgs, confounds))
        n_samples_list, dtype = _lazy_scan(imgs)
        indices_list = np.zeros(len(imgs) + 1, dtype='int')
        indices_list[1:] = np.cumsum(n_samples_list)
        n_samples = int(indices_list[-1])
        n_voxels = self._count_voxels(masker)

        if self.verbose:
            print('Learning...')
        # pre-permuted pipelines deliver voxel columns in a fixed random
        # order: subsets are then windows of it instead of gathers
        sampling = ('window-ordered'
                    if getattr(masker, 'feature_order_', None) is not None
                    else 'gather')
        dict_fact = DictFact(n_components=n_components,
                             code_alpha=self.alpha,
                             code_l1_ratio=0,
                             comp_l1_ratio=1,
                             comp_pos=self.positive,
                             reduction=reduction,
                             Dx_agg=Dx_agg,
                             optimizer=optimizer,
                             step_size=self.step_size,
                             G_agg=G_agg,
                             learning_rate=self.learning_rate,
                             batch_size=self.batch_size,
                             random_state=random_state,
                             n_threads=self.n_jobs,
                             subset_sampling=sampling,
                             verbose=0,
                             device=self.device)
        dict_fact.prepare(n_samples=n_samples, n_features=n_voxels,
                          X=dict_init, dtype=dtype)
        self.dict_fact_ = dict_fact
        device = dict_fact._state.D.device
        work_dtype = _torch_dtype(dict_fact._dtype)
        cpu_time = 0.
        io_time = 0.
        if n_records > 0:
            if self.verbose:
                verbose_iter_ = np.linspace(0, n_records * self.n_epochs,
                                            self.verbose).tolist()
            current_n_records = 0

            # raw path: the host only masks and orders; detrend and
            # standardize run on the device over the transferred record
            raw_path = (hasattr(masker, 'transform_raw')
                        and getattr(masker, 'low_pass', None) is None
                        and getattr(masker, 'high_pass', None) is None
                        and all(c is None for c in confounds))

            # epochs >= 2 replay records from device memory
            cache = (_RecordCache(RECORD_CACHE_BYTES)
                     if raw_path and self.n_epochs > 1
                     and RECORD_CACHE_BYTES > 0 else None)
            # H2D copies run on a side stream; the training stream waits
            # on each record's event before it reads the record
            side = (torch.cuda.Stream(device) if device.type == 'cuda'
                    else None)

            def stage(arr):
                """Record -> device tensor, and the event its copy
                completes (None when nothing is in flight)."""
                if side is None:
                    return _host_tensor(arr), None
                # mmap -> pinned host (disk IO here, in the loader
                # thread), then a non-blocking copy on the side stream
                host = torch.empty(arr.shape,
                                   dtype=_torch_dtype(arr.dtype),
                                   pin_memory=True)
                host.numpy()[...] = arr
                with torch.cuda.stream(side):
                    dev = host.to(device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(side)
                # keep the loader honest about completion, as the JAX
                # loader's block_until_ready does, without stalling the
                # training stream
                event.synchronize()
                return dev, event

            def load(record):
                img, these_confounds = data_list[record]
                if raw_path:
                    if cache is not None:
                        hit = cache.get(record)
                        if hit is not None:
                            return hit, None
                    arr = np.ascontiguousarray(masker.transform_raw(img))
                    if side is None or arr.nbytes <= H2D_STAGE_BYTES:
                        dev, event = stage(arr)
                        if cache is not None:
                            cache.put(record, dev, arr.nbytes)
                        return dev, event
                    return arr, None
                return masker.transform(img, confounds=these_confounds), None

            # host IO / device compute overlap: while the device trains on
            # record r, the loader threads prepare r + 1 and r + 2;
            # io_time counts only the wait that is not overlapped
            pool = ThreadPoolExecutor(PREFETCH)
            try:
                for i in range(self.n_epochs):
                    if self.verbose:
                        print('Epoch %i' % (i + 1))
                    if method == 'gram' and i == 5:
                        dict_fact.set_params(G_agg='full',
                                             Dx_agg='average')
                    if method == 'reducing ratio':
                        reduction = 1 + (self.reduction - 1) / sqrt(i + 1)
                        dict_fact.set_params(reduction=reduction)
                    record_list = random_state.permutation(n_records)
                    pending = [pool.submit(load, r)
                               for r in record_list[:PREFETCH]]
                    for ri, record in enumerate(record_list):
                        if (self.verbose and verbose_iter_
                                and current_n_records >= verbose_iter_[0]):
                            print('Record %i' % current_n_records)
                            if self.callback is not None:
                                self.callback(masker, dict_fact, cpu_time,
                                              io_time)
                            verbose_iter_ = verbose_iter_[1:]
                        t0 = time.perf_counter()
                        masked_data, event = pending.pop(0).result()
                        io_time += time.perf_counter() - t0
                        if ri + PREFETCH < len(record_list):
                            pending.append(pool.submit(
                                load, record_list[ri + PREFETCH]))

                        t0 = time.perf_counter()
                        permutation = random_state.permutation(
                            masked_data.shape[0])
                        if method in ('average', 'gram'):
                            sample_indices = np.arange(
                                indices_list[record],
                                indices_list[record + 1])
                            sample_indices = sample_indices[permutation]
                        else:
                            sample_indices = None
                        if raw_path:
                            if not torch.is_tensor(masked_data):
                                # too large to stage: copy it now
                                masked_data = _host_tensor(
                                    masked_data).to(device)
                            elif event is not None:
                                stream = torch.cuda.current_stream(device)
                                stream.wait_event(event)
                                # the side stream allocated it: keep the
                                # allocator from reusing it while this
                                # stream's work on it is pending
                                masked_data.record_stream(stream)
                            Xd = _clean_device(
                                masked_data,
                                getattr(masker, 'detrend', False),
                                getattr(masker, 'standardize', False),
                                work_dtype)
                            Xd = Xd[torch.as_tensor(permutation,
                                                    device=device)]
                            dict_fact._partial_fit_device(Xd,
                                                          sample_indices)
                        else:
                            masked_data = masked_data[permutation]
                            dict_fact.partial_fit(
                                masked_data,
                                sample_indices=sample_indices)
                        current_n_records += 1
                        cpu_time += time.perf_counter() - t0
            finally:
                pool.shutdown(wait=True, cancel_futures=True)
            if cache is not None:
                self.record_cache_info_ = {
                    'hits': cache.hits, 'misses': cache.misses,
                    'resident_bytes': cache.nbytes}
        self.cpu_time_ = cpu_time
        self.io_time_ = io_time
        return _flip(dict_fact.components_)

    @staticmethod
    def _count_voxels(masker):
        if hasattr(masker, 'n_voxels_'):
            return masker.n_voxels_
        if isinstance(getattr(masker, 'mask_img_', None), np.ndarray):
            return int(masker.mask_img_.sum())
        # nilearn masker: the non-zeros of its mask image
        from nilearn._utils import check_niimg
        return int(np.sum(np.asanyarray(
            check_niimg(masker.mask_img_).dataobj) != 0))


class fMRICoder(fMRICoderMixin):
    """Code new images on a fixed spatial dictionary."""

    def __init__(self, dictionary, alpha=0.1, transform_batch_size=None,
                 mask=None, smoothing_fwhm=None, standardize=True,
                 detrend=True, low_pass=None, high_pass=None, t_r=None,
                 target_affine=None, target_shape=None,
                 mask_strategy='background', mask_args=None, memory=None,
                 memory_level=2, n_jobs=1, verbose=0, device='cuda'):
        self.dictionary = dictionary
        fMRICoderMixin.__init__(
            self, n_components=None, alpha=alpha, dict_init=self.dictionary,
            mask=mask, smoothing_fwhm=smoothing_fwhm,
            standardize=standardize, detrend=detrend, low_pass=low_pass,
            high_pass=high_pass,
            transform_batch_size=transform_batch_size, t_r=t_r,
            target_affine=target_affine, target_shape=target_shape,
            mask_strategy=mask_strategy, mask_args=mask_args,
            memory=memory, memory_level=memory_level, n_jobs=n_jobs,
            verbose=verbose, device=device)


class rfMRIDictionaryScorer:
    """Callback recording the test objective over time; with
    ``artifact_dir``, the flipped components at each call and ``info``
    (pickled to ``info.pkl``)."""

    def __init__(self, test_imgs, test_confounds=None, info=None,
                 artifact_dir=None):
        self.start_time = time.perf_counter()
        self.test_imgs = test_imgs
        if test_confounds is None:
            test_confounds = itertools.repeat(None)
        self.test_confounds = test_confounds
        self.test_time = 0
        self.score = []
        self.iter = []
        self.time = []
        self.cpu_time = []
        self.io_time = []
        self.info = info
        self.artifact_dir = artifact_dir

    def __call__(self, masker, dict_fact, cpu_time, io_time):
        test_time = time.perf_counter()
        if not hasattr(self, 'data'):
            self.data = [masker.transform(img, confounds=conf)
                         for img, conf in zip(self.test_imgs,
                                              self.test_confounds)]
        scores = np.array([dict_fact.score(data) for data in self.data])
        len_imgs = np.array([data.shape[0] for data in self.data])
        score = np.sum(scores * len_imgs) / np.sum(len_imgs)
        self.test_time += time.perf_counter() - test_time
        this_time = time.perf_counter() - self.start_time - self.test_time
        self.score.append(score)
        self.time.append(this_time)
        self.cpu_time.append(cpu_time)
        self.io_time.append(io_time)
        self.iter.append(dict_fact.n_iter_)
        if self.info is not None:
            self.info['time'] = self.cpu_time
            self.info['score'] = self.score
            self.info['iter'] = self.iter
        if self.artifact_dir is not None:
            import os
            import pickle
            components = _flip(dict_fact.components_)
            np.save(os.path.join(self.artifact_dir, 'components_%i.npy'
                                 % dict_fact.n_iter_), components)
            if self.info is not None:
                # a plain pickle (joblib.load reads it too), so that the
                # scorer runs where joblib is not installed
                with open(os.path.join(self.artifact_dir, 'info.pkl'),
                          'wb') as f:
                    pickle.dump(self.info, f)
