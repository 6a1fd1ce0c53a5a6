"""DictFact: the sklearn-compatible SOMF/OMF estimator on PyTorch.

Counterpart of ``modl_tpu/decomposition/dict_fact.py`` with the same
public API and hyper-parameters (``DictFact``, ``Coder``,
``CodingMixin``: fit / partial_fit / prepare / transform / score /
shuffle / set_params). The learner state lives on ``device``
(``'cuda'`` by default; asking for CUDA where there is none raises) and
the host keeps the numpy ``RandomState`` orchestration of the JAX
package. Its documented deviations from the reference hold here too:
Binomial subset sizes as a fixed-width window with a masked tail,
windowed subsets of one fixed feature order for resident fits, and
seeds that reproduce this package's own runs, not the reference's or
the JAX package's bits.

``dtype=None`` takes X's dtype: float64 stays float64 (the JAX package
does the same with x64 on), anything else than float32/float64 becomes
float32. The Hopper BCD kernel runs for float32 state on CUDA; float64
and CPU runs take the plain PyTorch path.

``set_params`` carries the JAX package's mid-run hooks: the Gram
upgrade, the lazy 'average' allocation and the windowed re-layout
(``fMRIDictFact`` changes ``reduction`` and ``G_agg`` between epochs).
Not ported yet: pickling of device state.
"""
import dataclasses
import time
import warnings

import numpy as np
import torch

from ..base import (BaseEstimator, TransformerMixin, check_array,
                    check_is_fitted, check_random_state, gen_batches)
from ..ops.enet import enet_scale
from ..ops.sampler import binomial_len_max, init_sampler_state
from ._step import (SomfConfig, SomfState, compute_code, draw_epoch,
                    objective_value, somf_scan, somf_step)

MAX_INT = np.iinfo(np.int32).max


def _default_dtype(dtype):
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return np.dtype(np.float32)
    return dtype


def _torch_dtype(dtype):
    return getattr(torch, np.dtype(dtype).name)


def _resolve_device(device):
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but no CUDA "
                           "device is available")
    return device


class CodingMixin(TransformerMixin):
    """Shared transform/score over a fitted dictionary."""

    def _set_coding_params(self, n_components, code_alpha=1,
                           code_l1_ratio=1, tol=1e-2, max_iter=100,
                           code_pos=False, random_state=None, n_threads=1,
                           device='cuda'):
        self.n_components = n_components
        self.code_l1_ratio = code_l1_ratio
        self.code_alpha = code_alpha
        self.code_pos = code_pos
        self.random_state = random_state
        self.tol = tol
        self.max_iter = max_iter
        self.n_threads = n_threads  # accepted for API parity; unused
        self.device = device

    def _code_solver(self):
        cfg = getattr(self, '_cfg', None)
        if cfg is not None:
            return cfg.code_solver
        solver = getattr(self, 'code_solver', 'auto')
        if solver == 'auto':
            return ('fista' if _resolve_device(self.device).type == 'cuda'
                    else 'cd')
        return solver

    def _transform_gram(self):
        """G to use at transform time: the maintained Gram iff exact."""
        if getattr(self, 'G_agg', None) == 'full' \
                and getattr(self, '_state', None) is not None \
                and self._state.G is not None:
            return self._state.G
        return None

    def _code_args(self):
        return (float(self.code_l1_ratio), float(self.code_alpha),
                bool(self.code_pos), float(self.tol), int(self.max_iter))

    def transform(self, X, batch_size=None):
        """Codes for rows of X on the current dictionary (b, k).

        ``batch_size`` (or ``self.transform_batch_size`` when set) chunks
        the rows to bound device memory on very large inputs."""
        check_is_fitted(self, 'components_')
        D = self._components_device()
        X = np.asarray(X)
        G = self._transform_gram()
        batch_size = (batch_size or getattr(self, 'transform_batch_size',
                                            None) or max(X.shape[0], 1))
        codes = [compute_code(D, G,
                              torch.as_tensor(X[batch]).to(D.device,
                                                           D.dtype),
                              *self._code_args(), solver=self._code_solver())
                 for batch in gen_batches(X.shape[0], batch_size)]
        return torch.cat(codes).cpu().numpy()

    def score(self, X):
        """Penalised objective on X (lower is better)."""
        check_is_fitted(self, 'components_')
        D = self._components_device()
        X = torch.as_tensor(np.asarray(X)).to(D.device, D.dtype)
        return float(objective_value(D, self._transform_gram(), X,
                                     *self._code_args(),
                                     solver=self._code_solver()))

    def _components_device(self):
        if getattr(self, '_state', None) is not None:
            D = self._state.D
            if getattr(getattr(self, '_cfg', None), 'windowed', False):
                # stored order -> logical feature order (drops the pad)
                D = D[:, torch.tensor(self._feat_inv, device=D.device)]
            return D
        D = np.asarray(self.components_)
        dtype = _default_dtype(D.dtype)
        return torch.as_tensor(D.astype(dtype, copy=False)).to(
            _resolve_device(self.device))


class DictFact(CodingMixin, BaseEstimator):
    """Streaming matrix factorisation with stochastic subsampling (SOMF).

    Solves, over a stream of sample rows,
        min_{D in enet-ball^k, A}  1/2 ||X - A D||^2
            + code_alpha * (code_l1_ratio ||A||_1
                            + (1 - code_l1_ratio)/2 ||A||_2^2)
    touching only ``n_features / reduction`` random feature columns per
    step. Parameters mirror ``modl_tpu.DictFact`` without ``mesh`` and
    ``average_offload``; ``device`` places the learner state.
    """

    def __init__(self,
                 reduction=1,
                 learning_rate=1,
                 sample_learning_rate=0.76,
                 Dx_agg='masked',
                 G_agg='masked',
                 optimizer='variational',
                 dict_init=None,
                 code_alpha=1,
                 code_l1_ratio=1,
                 comp_l1_ratio=0,
                 step_size=1,
                 tol=1e-2,
                 max_iter=100,
                 code_pos=False,
                 comp_pos=False,
                 random_state=None,
                 n_epochs=1,
                 n_components=10,
                 batch_size=10,
                 verbose=0,
                 callback=None,
                 n_threads=1,
                 rand_size=True,
                 replacement=True,
                 dtype=None,
                 code_solver='auto',
                 subset_sampling='auto',
                 device='cuda',
                 ):
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.sample_learning_rate = sample_learning_rate
        self.Dx_agg = Dx_agg
        self.G_agg = G_agg
        self.reduction = reduction
        self.dict_init = dict_init
        self._set_coding_params(n_components,
                                code_l1_ratio=code_l1_ratio,
                                code_alpha=code_alpha,
                                code_pos=code_pos,
                                random_state=random_state,
                                tol=tol, max_iter=max_iter,
                                n_threads=n_threads, device=device)
        self.comp_l1_ratio = comp_l1_ratio
        self.comp_pos = comp_pos
        self.optimizer = optimizer
        self.step_size = step_size
        self.n_epochs = n_epochs
        self.verbose = verbose
        self.callback = callback
        self.rand_size = rand_size
        self.replacement = replacement
        self.dtype = dtype
        self.code_solver = code_solver
        self.subset_sampling = subset_sampling

    # ------------------------------------------------------------------ #
    # state plumbing
    # ------------------------------------------------------------------ #

    def _make_config(self, n_features, dtype=None):
        reduction = float(self.reduction)
        if self.optimizer == 'sgd':
            reduction = 1.0
        len_subset = max(1, int(n_features / reduction))
        G_agg, Dx_agg = self.G_agg, self.Dx_agg
        if self.optimizer == 'sgd':
            G_agg, Dx_agg = 'full', 'full'
        if dtype is None:
            dtype = getattr(self, '_dtype', np.float32)
        device = _resolve_device(self.device)
        # the Hopper BCD kernel: CUDA, float32 (dict_fact.py:293-294 of
        # the JAX package gates its Pallas kernel the same way)
        use_kernel = (device.type == 'cuda'
                      and np.dtype(dtype) == np.float32)
        rand_size = bool(self.rand_size) and len_subset < n_features
        len_max = (binomial_len_max(n_features, len_subset)
                   if rand_size else len_subset)
        code_solver = self.code_solver
        if code_solver == 'auto':
            code_solver = 'fista' if device.type == 'cuda' else 'cd'
        # windowed subsets for resident fits (fit()) or on request; the
        # window must leave at least half the features outside it
        want = getattr(self, 'subset_sampling', 'auto')
        windowed = (want in ('window', 'window-ordered')
                    or (want == 'auto'
                        and getattr(self, '_resident_fit', False)))
        windowed = (windowed and len_subset < n_features
                    and n_features >= 2 * len_max)
        return SomfConfig(
            n_components=int(self.n_components),
            len_subset=len_subset,
            reduction=reduction,
            Dx_agg=Dx_agg,
            G_agg=G_agg,
            optimizer=self.optimizer,
            learning_rate=float(self.learning_rate),
            sample_learning_rate=float(self.sample_learning_rate),
            step_size=float(self.step_size),
            code_alpha=float(self.code_alpha),
            code_l1_ratio=float(self.code_l1_ratio),
            comp_l1_ratio=float(self.comp_l1_ratio),
            code_pos=bool(self.code_pos),
            comp_pos=bool(self.comp_pos),
            tol=float(self.tol),
            max_iter=int(self.max_iter),
            replacement=bool(self.replacement),
            rand_size=rand_size,
            len_max=len_max,
            use_kernel=use_kernel,
            code_solver=code_solver,
            windowed=windowed,
            n_features=int(n_features) if windowed else 0,
        )

    def prepare(self, n_samples=None, n_features=None, dtype=None, X=None):
        """Allocate all learner state on ``device``."""
        device = _resolve_device(self.device)
        if X is not None:
            X = check_array(X, order='C', dtype=[np.float32, np.float64])
            if dtype is None:
                dtype = X.dtype
            if n_samples is None:
                n_samples = X.shape[0]
            if n_features is None:
                n_features = X.shape[1]
            elif n_features != X.shape[1]:
                raise ValueError('n_features and X do not match')
        else:
            if n_features is None or n_samples is None:
                raise ValueError('Either provide shape or data to prepare.')
            if dtype is None:
                dtype = np.float64
        if self.optimizer not in ('variational', 'sgd'):
            raise ValueError("optimizer should be 'variational' or 'sgd'")
        if self.dtype is not None:
            dtype = self.dtype
        dtype = _default_dtype(dtype)
        tdtype = _torch_dtype(dtype)

        self.random_state = check_random_state(self.random_state)
        k = self.n_components

        # dictionary init: first k rows of X or randn
        if X is None:
            D0 = self.random_state.randn(k, n_features)
        else:
            if X.shape[0] < k:
                raise ValueError('Need at least n_components rows to init')
            D0 = np.array(X[:k], dtype=np.float64, copy=True)
        if self.comp_pos:
            D0 = np.abs(D0)
        D = enet_scale(torch.as_tensor(np.asarray(D0, dtype)).to(device),
                       float(self.comp_l1_ratio), radius=1.0)

        cfg = self._make_config(n_features, dtype)
        self._cfg = cfg
        self._n_features = int(n_features)
        self._n_samples = int(n_samples)
        self._dtype = dtype

        sampler_seed = self.random_state.randint(MAX_INT)
        gen = torch.Generator().manual_seed(int(sampler_seed))
        box, cursor = init_sampler_state(n_features, gen)

        G = D @ D.T if cfg.G_agg == 'full' else None

        # windowed subsets: D/B in the fixed random feature order (the
        # box) with a mirror pad of the window width
        width = cfg.len_max if cfg.rand_size else cfg.len_subset
        if cfg.windowed:
            if self.subset_sampling == 'window-ordered':
                self._feat_perm = np.arange(n_features)
            else:
                self._feat_perm = box.numpy().copy()
                D = D[:, box.to(device)]
            inv = np.empty(n_features, np.int64)
            inv[self._feat_perm] = np.arange(n_features)
            self._feat_inv = inv
            D = torch.cat([D, D[:, :width]], dim=1)
            B0 = torch.zeros((k, n_features + width), dtype=tdtype,
                             device=device)
        else:
            self._feat_perm = self._feat_inv = None
            B0 = torch.zeros((k, n_features), dtype=tdtype, device=device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=tdtype, device=device)

        self._state = SomfState(
            D=D.contiguous(),
            C=zeros(k, k),
            B=B0,
            G=G,
            comp_norm=zeros(k),
            code=torch.ones((n_samples, k), dtype=tdtype, device=device),
            Dx_avg=zeros(n_samples, k) if cfg.Dx_agg == 'average' else None,
            G_avg=(zeros(n_samples, k, k) if cfg.G_agg == 'average'
                   else None),
            n_iter=0,
            sample_n_iter=torch.zeros(n_samples, dtype=torch.int64,
                                      device=device),
            box=box,
            cursor=cursor,
            gen=gen,
        )
        self.labels_ = np.arange(n_samples)
        if self.verbose:
            self.verbose_iter_ = np.linspace(
                0, n_samples * self.n_epochs, self.verbose).tolist()
        self.time_ = 0.0
        return self

    # sklearn-style trailing-underscore views over the state ------------ #

    @property
    def components_(self):
        if getattr(self, '_state', None) is None:
            # unfitted: check_is_fitted's hasattr sees no attribute
            raise AttributeError('components_')
        return self._components_device().cpu().numpy()

    @property
    def code_(self):
        return self._state.code.cpu().numpy()

    @property
    def C_(self):
        return self._state.C.cpu().numpy()

    @property
    def B_(self):
        B = self._state.B
        if self._cfg.windowed:
            B = B[:, torch.tensor(self._feat_inv, device=B.device)]
        return B.cpu().numpy()

    @property
    def G_(self):
        G = self._state.G
        return G.cpu().numpy() if G is not None else None

    @property
    def Dx_average_(self):
        A = self._state.Dx_avg
        return A.cpu().numpy() if A is not None else None

    @property
    def G_average_(self):
        A = self._state.G_avg
        return A.cpu().numpy() if A is not None else None

    @property
    def n_iter_(self):
        return self._state.n_iter

    @property
    def sample_n_iter_(self):
        return self._state.sample_n_iter.cpu().numpy()

    # ------------------------------------------------------------------ #
    # fitting
    # ------------------------------------------------------------------ #

    def fit(self, X, y=None):
        """Full factorisation: prepare + n_epochs x (partial_fit + shuffle).
        The data stays on the device for the whole fit."""
        X = check_array(X, order='C', dtype=[np.float32, np.float64])
        dict_init = X if self.dict_init is None else check_array(
            self.dict_init, dtype=X.dtype.type)
        self._resident_fit = True
        try:
            self.prepare(n_samples=X.shape[0], X=dict_init, dtype=X.dtype)
        finally:
            self._resident_fit = False
        X_dev = self._ingest_features(self._to_device(X))
        for _ in range(self.n_epochs):
            self._partial_fit_device(X_dev, None, ingested=True)
            perm = self.shuffle()
            X_dev = X_dev[torch.as_tensor(perm, device=X_dev.device)]
        return self

    def _to_device(self, X):
        return torch.as_tensor(X).to(self._state.D.device,
                                     _torch_dtype(self._dtype))

    def _ingest_features(self, X_dev):
        """Windowed mode: reorder columns into the fixed feature order and
        append the mirror pad (the unpermuted copy is released). Identity
        otherwise."""
        cfg = self._cfg
        if not cfg.windowed:
            return X_dev
        width = cfg.len_max if cfg.rand_size else cfg.len_subset
        if self.subset_sampling != 'window-ordered':
            X_dev = X_dev[:, torch.tensor(self._feat_perm,
                                          device=X_dev.device)]
        return torch.cat([X_dev, X_dev[:, :width]], dim=1)

    def partial_fit(self, X, sample_indices=None):
        """Stream rows of X through the learner."""
        X = check_array(X, dtype=[np.float32, np.float64], order='C')
        self._partial_fit_device(self._to_device(X), sample_indices)
        return self

    def _partial_fit_device(self, X_dev, sample_indices, ingested=False):
        """partial_fit on rows already on the device in the fit's dtype
        (the fMRI driver's entry); ``ingested``: already in the windowed
        layout."""
        if not ingested:
            X_dev = self._ingest_features(X_dev)
        self._partial_fit_ingested(X_dev, sample_indices)

    def _partial_fit_ingested(self, X_dev, sample_indices):
        t0 = time.perf_counter()
        device = X_dev.device
        n = X_dev.shape[0]
        b = min(self.batch_size, n)
        cfg = self._cfg
        if sample_indices is None:
            idx = torch.arange(n, device=device)
        elif isinstance(sample_indices, slice):
            idx = torch.arange(sample_indices.start, sample_indices.stop,
                               device=device)
        else:
            idx = torch.as_tensor(np.asarray(sample_indices),
                                  dtype=torch.int64).to(device)

        n_full = n // b
        if bool(self.verbose) or self.callback is not None:
            for batch in gen_batches(n, b):
                if (self.verbose and getattr(self, 'verbose_iter_', None)
                        and self.n_iter_ >= self.verbose_iter_[0]):
                    print('Iteration %i' % self.n_iter_)
                    self.verbose_iter_ = self.verbose_iter_[1:]
                    self._callback()
                elif not self.verbose and self.callback is not None:
                    self._callback()
                self._state = somf_step(self._state, X_dev[batch],
                                        idx[batch], cfg)
        else:
            if n_full > 0:
                draws = draw_epoch(self._state, cfg, n_full)
                self._state = somf_scan(
                    self._state, X_dev[:n_full * b].reshape(n_full, b, -1),
                    idx[:n_full * b].reshape(n_full, b), cfg, draws)
            if n_full * b < n:
                self._state = somf_step(self._state, X_dev[n_full * b:],
                                        idx[n_full * b:], cfg)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        self.time_ += time.perf_counter() - t0

    def _callback(self):
        if self.callback is not None:
            self.callback(self)

    def shuffle(self):
        """Co-shuffle per-sample state; return the permutation used."""
        seed = self.random_state.randint(MAX_INT)
        perm = np.random.RandomState(seed).permutation(self._n_samples)
        st = self._state
        perm_dev = torch.as_tensor(perm, device=st.D.device)
        for name in ('code', 'G_avg', 'Dx_avg', 'sample_n_iter'):
            arr = getattr(st, name)
            if arr is not None:
                setattr(st, name, arr[perm_dev])
        self.labels_ = self.labels_[perm]
        return perm

    def set_params(self, **params):
        """set_params with the JAX package's mid-run hooks: G_agg='full'
        recomputes the Gram, switching an aggregator to 'average' lazily
        allocates its zeroed per-sample state, and the configuration is
        rebuilt (``_migrate_layout`` moves a windowed state to the new
        window width)."""
        G_agg = params.pop('G_agg', None)
        st = getattr(self, '_state', None)
        if G_agg == 'full' and self.G_agg != 'full':
            if st is not None:
                Dl = st.D
                if self._cfg.windowed:
                    # the mirror pad duplicates head columns: drop it
                    Dl = Dl[:, :self._n_features]
                st.G = Dl @ Dl.T
            self.G_agg = 'full'
        elif G_agg is not None:
            self.G_agg = G_agg
        BaseEstimator.set_params(self, **params)
        if st is not None:
            k = self.n_components

            def zeros(*shape):
                # exact zeros: the step's unvisited->weight-1 rule makes
                # the first update after the switch unbiased
                return torch.zeros(shape, dtype=st.D.dtype,
                                   device=st.D.device)

            if self.Dx_agg == 'average' and st.Dx_avg is None:
                st.Dx_avg = zeros(self._n_samples, k)
            if self.G_agg == 'average' and st.G_avg is None:
                st.G_avg = zeros(self._n_samples, k, k)
        if hasattr(self, '_n_features'):
            old_cfg = getattr(self, '_cfg', None)
            new_cfg = self._make_config(self._n_features)
            if old_cfg is not None and st is not None:
                new_cfg = self._migrate_layout(old_cfg, new_cfg)
            self._cfg = new_cfg
        return self

    def _migrate_layout(self, old_cfg, new_cfg):
        """Reconcile the live state with a rebuilt configuration.

        The windowed layout (fixed feature order + mirror pad of the
        window width) is baked into the stored D and B, but the pad only
        duplicates head columns. When the window width changes, the pad
        is stripped and laid again at the new width; when the new width
        no longer allows windows (it would cover more than half the
        features), the state goes back to logical feature order and
        gather subsets, with a warning. A state that was not windowed
        stays so (no ingestion permute was applied to it)."""
        if not old_cfg.windowed:
            return dataclasses.replace(new_cfg, windowed=False, n_features=0)
        st = self._state
        n = self._n_features
        old_width = (old_cfg.len_max if old_cfg.rand_size
                     else old_cfg.len_subset)
        new_width = (new_cfg.len_max if new_cfg.rand_size
                     else new_cfg.len_subset)
        fits = new_cfg.len_subset < n and n >= 2 * new_width
        if fits and new_width == old_width:
            return dataclasses.replace(new_cfg, windowed=True, n_features=n)
        D_log, B_log = st.D[:, :n], st.B[:, :n]
        if fits:
            st.D = torch.cat([D_log, D_log[:, :new_width]], dim=1)
            st.B = torch.cat([B_log, B_log[:, :new_width]], dim=1)
            return dataclasses.replace(new_cfg, windowed=True, n_features=n)
        warnings.warn('set_params made the subset window wider than the '
                      'windowed layout supports; falling back to gather '
                      'subset sampling for the rest of this fit')
        if not np.array_equal(self._feat_perm, np.arange(n)):
            inv = torch.as_tensor(self._feat_inv, device=st.D.device)
            D_log, B_log = D_log[:, inv], B_log[:, inv]
        self._feat_perm = self._feat_inv = None
        st.D, st.B = D_log.contiguous(), B_log.contiguous()
        return dataclasses.replace(new_cfg, windowed=False, n_features=0)


class Coder(CodingMixin, BaseEstimator):
    """Fixed-dictionary encoder."""

    def __init__(self, dictionary, code_alpha=1, code_l1_ratio=1, tol=1e-2,
                 max_iter=100, code_pos=False, random_state=None,
                 n_threads=1, device='cuda'):
        self._set_coding_params(dictionary.shape[0],
                                code_l1_ratio=code_l1_ratio,
                                code_alpha=code_alpha,
                                code_pos=code_pos,
                                random_state=random_state,
                                tol=tol, max_iter=max_iter,
                                n_threads=n_threads, device=device)
        self.dictionary = dictionary
        self.components_ = np.asarray(dictionary)

    def fit(self, X=None, y=None):
        return self
