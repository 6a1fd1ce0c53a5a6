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

``dtype=None`` takes X's dtype. On CUDA float64 becomes float32, as in
the JAX package without x64 (its TPU setting), and the Hopper BCD kernel
runs on the float32 state; an explicit ``dtype=np.float64`` raises
there. On the CPU float64 stays float64 (the JAX package's x64 mode) and
every run takes the plain PyTorch path. Anything else than
float32/float64 becomes float32.

``average_offload=True`` keeps ``G_avg`` (n_samples, k, k) in host RAM,
pinned on CUDA, and moves only a segment's rows to the card
(``_step.offload_scan``; segments of ``OFFLOAD_SEG_BYTES``).

``mesh=`` (a ``('dp', 'feat')`` DeviceMesh from ``parallel.make_mesh``)
runs the fit SPMD: every rank calls it with the same data and
``random_state`` and holds its shards (``parallel/mesh.py``); there
``average_offload`` is off, ``G_avg`` being split over ``dp`` instead.
The trailing-underscore views, ``transform`` and ``score`` give the
whole arrays on every rank, and so do pickles and ``save_state``
(collectives: every rank calls them); a pickle drops the mesh.

``set_params`` carries the JAX package's mid-run hooks: the Gram
upgrade, the lazy 'average' allocation and the windowed re-layout
(``fMRIDictFact`` changes ``reduction`` and ``G_agg`` between epochs).
Estimators pickle their state as host numpy (``_PickleStateMixin``)
and place it on their ``device`` when loaded.
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
from ..parallel import mesh as pmesh
from ..utils.profiling import span
from . import _program
from ._step import (DrawStaging, SomfConfig, SomfState, compute_code,
                    draw_epoch, host_zeros, objective_value, offload_scan,
                    offload_supported, somf_scan, somf_step,
                    state_from_numpy, state_to_numpy)

MAX_INT = np.iinfo(np.int32).max

# device residency of one average_offload segment: the G_avg rows of
# seg * batch_size samples, (seg * batch_size, k, k)
OFFLOAD_SEG_BYTES = 512 * 1024 * 1024


def _default_dtype(dtype, device, explicit=False):
    """The learner's state dtype on ``device`` for a requested ``dtype``.

    On CUDA float64 becomes float32, as the JAX package maps it without
    x64 (its TPU setting), so that the BCD kernel runs; an ``explicit``
    float64 (the estimator's ``dtype`` parameter) raises there instead.
    On the CPU float64 stays float64. Anything else than float32/float64
    becomes float32."""
    dtype = np.dtype(dtype)
    if torch.device(device).type == 'cuda' and dtype == np.float64:
        if explicit:
            raise ValueError('the CUDA BCD kernel takes float32 state, got '
                             'dtype=float64; float64 fits run with '
                             'device="cpu"')
        return np.dtype(np.float32)
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


class _PickleStateMixin:
    """Pickle device state as host numpy and place it with
    ``_resolve_device(self.device)`` on load (the JAX package's mixin of
    the same name): an estimator pickled with ``device='cuda'`` loads
    onto the card, or raises where there is none.

    ``_state`` (a :class:`SomfState`) goes through ``state_to_numpy``,
    with the generator's state, and comes back with ``G_avg`` in host
    RAM, where the next ``partial_fit`` places it; the tensor attributes
    named in ``_DEVICE_FIELDS`` go as plain arrays; the transient
    buffers (``_offload_staging``, ``_draw_staging``) and the device
    programs (``_program``, ``_scans``; a recsys fit's ``_programs``)
    are dropped. A mesh is dropped
    too (the JAX package's mixin does the same): a sharded state is
    gathered whole (every rank pickles) and loads as a single-process
    estimator."""

    _DEVICE_FIELDS = ()

    def __getstate__(self):
        state = dict(self.__dict__)
        if state.get('_state') is not None:
            state['_state'] = state_to_numpy(state['_state'])
        for name in self._DEVICE_FIELDS:
            if state.get(name) is not None:
                state[name] = state[name].cpu().numpy()
        for name in ('_offload_staging', '_draw_staging', '_program',
                     '_scans', '_programs'):
            state.pop(name, None)
        if state.get('mesh') is not None:
            state['mesh'] = None
        if getattr(state.get('_cfg'), 'mesh', None) is not None:
            state['_cfg'] = dataclasses.replace(state['_cfg'], mesh=None)
        return state

    def __setstate__(self, state):
        device = _resolve_device(state['device'])
        arrays = state.get('_state')
        if arrays is not None:
            state['_state'] = state_from_numpy(
                arrays, device, _torch_dtype(arrays['D'].dtype))
        for name in self._DEVICE_FIELDS:
            if state.get(name) is not None:
                state[name] = torch.as_tensor(state[name]).to(device)
        self.__dict__ = state


class CodingMixin(_PickleStateMixin, TransformerMixin):
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
            D = pmesh.unshard_leaf(self._state, 'D')
            if getattr(getattr(self, '_cfg', None), 'windowed', False):
                # stored order -> logical feature order (drops the pad)
                D = D[:, torch.tensor(self._feat_inv, device=D.device)]
            return D
        D = np.asarray(self.components_)
        device = _resolve_device(self.device)
        dtype = _default_dtype(D.dtype, device)
        return torch.as_tensor(D.astype(dtype, copy=False)).to(device)


class DictFact(CodingMixin, BaseEstimator):
    """Streaming matrix factorisation with stochastic subsampling (SOMF).

    Solves, over a stream of sample rows,
        min_{D in enet-ball^k, A}  1/2 ||X - A D||^2
            + code_alpha * (code_l1_ratio ||A||_1
                            + (1 - code_l1_ratio)/2 ||A||_2^2)
    touching only ``n_features / reduction`` random feature columns per
    step. Parameters mirror ``modl_tpu.DictFact``; ``device`` places the
    learner state, and ``mesh`` (a ``('dp', 'feat')`` DeviceMesh) shards
    it over the ranks of an SPMD fit.
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
                 mesh=None,
                 code_solver='auto',
                 average_offload=False,
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
        self.mesh = mesh
        self.code_solver = code_solver
        self.average_offload = average_offload
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
                    and n_features >= 2 * len_max
                    and self._mesh_holds_windows(n_features, len_max))
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
            average_offload=self._offloads(),
            mesh=self.mesh,
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
            dtype = _default_dtype(self.dtype, device, explicit=True)
        dtype = _default_dtype(dtype, device)
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
        if cfg.average_offload and not offload_supported(device):
            raise ValueError(f'average_offload runs on CUDA or the CPU, '
                             f'not on {device}')
        self._cfg = cfg
        self._program = self._draw_staging = None
        self._scans = {}
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

        average = cfg.G_agg == 'average'
        self._state = SomfState(
            D=D.contiguous(),
            C=zeros(k, k),
            B=B0,
            G=G,
            comp_norm=zeros(k),
            code=torch.ones((n_samples, k), dtype=tdtype, device=device),
            Dx_avg=zeros(n_samples, k) if cfg.Dx_agg == 'average' else None,
            G_avg=(self._avg_zeros(tdtype, device)
                   if average and self.mesh is None else None),
            n_iter=0,
            sample_n_iter=torch.zeros(n_samples, dtype=torch.int64,
                                      device=device),
            box=box,
            cursor=cursor,
            gen=gen,
        )
        if self.mesh is not None:
            # every rank draws alike or the fit is void: compare the
            # sampler's and the RandomState's states over the mesh
            pmesh.check_same([pmesh.fingerprint(
                gen.get_state(), box, self.random_state.get_state()[1])],
                self.mesh, 'the sampler and random_state')
            self._state = self._shard(self._state)
            if average:     # allocated at this rank's rows only
                self._state.G_avg = self._avg_zeros(
                    tdtype, device, self._state.layout.rows()[1])
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

    def _whole(self, name):
        """A state leaf as a host array, whole on every rank of a mesh
        (a collective there); None where the leaf is."""
        A = pmesh.unshard_leaf(self._state, name)
        return A.cpu().numpy() if A is not None else None

    @property
    def code_(self):
        return self._whole('code')

    @property
    def C_(self):
        return self._whole('C')

    @property
    def B_(self):
        B = pmesh.unshard_leaf(self._state, 'B')
        if self._cfg.windowed:
            B = B[:, torch.tensor(self._feat_inv, device=B.device)]
        return B.cpu().numpy()

    @property
    def G_(self):
        return self._whole('G')

    @property
    def Dx_average_(self):
        return self._whole('Dx_avg')

    @property
    def G_average_(self):
        return self._whole('G_avg')    # in host RAM under average_offload

    @property
    def n_iter_(self):
        return self._state.n_iter

    @property
    def sample_n_iter_(self):
        return self._whole('sample_n_iter')

    # ------------------------------------------------------------------ #
    # fitting
    # ------------------------------------------------------------------ #

    def fit(self, X, y=None):
        """Full factorisation: prepare + n_epochs x (partial_fit + shuffle).
        The data stays on the device for the whole fit, in its first
        order: an epoch takes its rows through the shuffles' composed
        permutation."""
        X = check_array(X, order='C', dtype=[np.float32, np.float64])
        dict_init = X if self.dict_init is None else check_array(
            self.dict_init, dtype=X.dtype.type)
        self._resident_fit = True
        try:
            self.prepare(n_samples=X.shape[0], X=dict_init, dtype=X.dtype)
        finally:
            self._resident_fit = False
        X_dev = self._ingest_features(self._to_device(X))
        rows = None
        for _ in range(self.n_epochs):
            self._partial_fit_ingested(
                X_dev, None, rows=None if rows is None else torch.as_tensor(
                    rows, device=X_dev.device))
            perm = self.shuffle()
            rows = perm if rows is None else rows[perm]
        return self

    def _to_device(self, X):
        return torch.as_tensor(X).to(self._state.D.device,
                                     _torch_dtype(self._dtype))

    def _mesh_holds_windows(self, n_features, width):
        """Whether every ``feat`` shard of the windowed storage (padded to
        a ``feat`` multiple) holds a whole window, as the JAX package's
        gate asks; where not, the fit takes gather subsets."""
        n_feat = pmesh.size(self.mesh, 'feat')
        n_stored = (n_features + width
                    + self._windowed_extra_pad(n_features, width))
        return n_stored // n_feat >= width

    def _windowed_extra_pad(self, n_features, width):
        """Zero columns beyond the mirror pad that make windowed storage
        split evenly over a mesh's ``feat`` axis."""
        return (-(n_features + width)) % pmesh.size(self.mesh, 'feat')

    def _shard(self, state):
        """This rank's shards of a whole state (windowed storage padded
        to a ``feat`` multiple first)."""
        cfg = self._cfg
        width = cfg.len_max if cfg.rand_size else cfg.len_subset
        n_pad = (self._windowed_extra_pad(cfg.n_features, width)
                 if cfg.windowed else 0)
        return pmesh.shard_state(state, self.mesh, n_pad=n_pad)

    def _ingest_features(self, X_dev):
        """Windowed mode: reorder columns into the fixed feature order and
        append the mirror pad (the unpermuted copy is released); on a
        mesh, then keep this rank's columns (the zero pad of
        :meth:`_shard` included). Identity otherwise."""
        cfg = self._cfg
        if cfg.windowed:
            width = cfg.len_max if cfg.rand_size else cfg.len_subset
            if self.subset_sampling != 'window-ordered':
                X_dev = X_dev[:, torch.tensor(self._feat_perm,
                                              device=X_dev.device)]
            X_dev = torch.cat([X_dev, X_dev[:, :width]], dim=1)
        lay = getattr(self._state, 'layout', None)
        if lay is None:
            return X_dev
        X_dev = torch.nn.functional.pad(
            X_dev, (0, lay.n_stored - X_dev.shape[1]))
        return X_dev.narrow(1, *lay.cols()).contiguous()

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

    def _partial_fit_ingested(self, X_dev, sample_indices, rows=None):
        """partial_fit on ingested rows: ``X_dev[rows]`` (``rows`` a device
        index; default: ``X_dev`` as it is). An epoch of a configuration
        ``_program.capturable`` takes, with no callback, runs its full
        batches through a ``ScanProgram`` (one graph replay on the card),
        which gathers the rows into its buffer itself."""
        t0 = time.perf_counter()
        device = X_dev.device
        n = X_dev.shape[0]
        b = min(self.batch_size, n)
        cfg = self._cfg
        offload = self._place_g_avg()
        # an offloaded G_avg is gathered on the host, so its indices stay
        # there; a resident state takes them on the device
        idx_device = torch.device('cpu') if offload else device
        if sample_indices is None:
            idx = torch.arange(n, device=idx_device)
        elif isinstance(sample_indices, slice):
            idx = torch.arange(sample_indices.start, sample_indices.stop,
                               device=idx_device)
        else:
            idx = torch.as_tensor(np.asarray(sample_indices),
                                  dtype=torch.int64).to(idx_device)

        n_full = n // b
        interactive = bool(self.verbose) or self.callback is not None
        if offload and not interactive:
            # a segment scatters each of its rows back once, so repeated
            # indices step batch by batch, as in the JAX package
            interactive = torch.unique(idx).shape[0] < n
        program = (n_full > 0 and not interactive and not offload
                   and _program.capturable(cfg))
        if rows is not None and not program:
            X_dev, rows = X_dev[rows], None
        if interactive:
            for batch in gen_batches(n, b):
                if (self.verbose and getattr(self, 'verbose_iter_', None)
                        and self.n_iter_ >= self.verbose_iter_[0]):
                    print('Iteration %i' % self.n_iter_)
                    self.verbose_iter_ = self.verbose_iter_[1:]
                    self._callback()
                elif not self.verbose and self.callback is not None:
                    self._callback()
                self._step_batch(X_dev[batch], idx[batch], offload)
        else:
            if n_full > 0 and offload:
                # segments of OFFLOAD_SEG_BYTES of G_avg rows; leftover
                # full batches run one by one
                k2 = (self.n_components ** 2
                      * np.dtype(self._dtype).itemsize)
                seg = min(max(1, int(OFFLOAD_SEG_BYTES // (b * k2))),
                          n_full)
                n_seg = n_full // seg
                for s in range(n_seg):
                    lo, hi = s * seg * b, (s + 1) * seg * b
                    self._offload_segment(X_dev[lo:hi].reshape(seg, b, -1),
                                          idx[lo:hi].reshape(seg, b))
                for s in range(n_seg * seg, n_full):
                    self._step_batch(X_dev[s * b:(s + 1) * b],
                                     idx[s * b:(s + 1) * b], offload)
            elif program:
                # the scan program gathers the epoch's rows itself
                prog = self._scan_program(n_full, b)
                with span('modl.draw'):
                    draws = draw_epoch(self._state, cfg, n_full)
                prog.epoch(X_dev, idx[:n_full * b], draws,
                           None if rows is None else rows[:n_full * b])
            elif n_full > 0:
                draws = draw_epoch(self._state, cfg, n_full)
                self._state = somf_scan(
                    self._state,
                    self._rows(X_dev[:n_full * b].reshape(n_full, b, -1)),
                    idx[:n_full * b].reshape(n_full, b), cfg, draws)
            if n_full * b < n:
                tail = (X_dev[n_full * b:] if rows is None
                        else X_dev[rows[n_full * b:]])
                self._step_batch(tail, idx[n_full * b:], offload)
        with span('modl.sync'):
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
        self.time_ += time.perf_counter() - t0

    def _step_batch(self, X_dev, idx, offload):
        """One minibatch: a segment of one batch, the step program (a
        captured graph on the card) where the configuration runs as one
        (``_program.capturable``) and the batch is full, else
        ``somf_step``."""
        if offload:
            self._offload_segment(X_dev[None], idx[None])
        elif (X_dev.shape[0] == self.batch_size
              and _program.capturable(self._cfg)):
            self._step_program().step(X_dev, idx)
        else:
            if getattr(self, '_draw_staging', None) is None:
                self._draw_staging = DrawStaging(self._state.D.device)
            self._state = somf_step(self._state, self._rows(X_dev[None])[0],
                                    idx, self._cfg, self._draw_staging)

    def _step_program(self):
        """The step program of the current state, configuration and batch
        size: the cached one, or a new one where any of them changed or a
        leaf of the state was replaced."""
        prog = getattr(self, '_program', None)
        if prog is None or not prog.holds(self._state, self._cfg,
                                          self.batch_size):
            self._program = None        # release the old graph first
            self._program = prog = _program.StepProgram(
                self._state, self._cfg, self.batch_size)
        return prog

    def _scan_program(self, n_batches, batch_size):
        """The scan program of the current state and configuration for
        epochs of ``n_batches`` batches of ``batch_size``: a cached one
        (one a shape: a record stream alternates lengths), or a new one
        where none holds; every cached program is dropped when a leaf was
        replaced or the configuration changed."""
        scans = getattr(self, '_scans', None)
        if scans is None:
            scans = self._scans = {}
        key = (n_batches, batch_size)
        prog = scans.get(key)
        if prog is None or not prog.holds(self._state, self._cfg,
                                          n_batches, batch_size):
            if prog is not None:
                scans.clear()           # release the old graphs first
            prog = scans[key] = _program.ScanProgram(
                self._state, self._cfg, n_batches, batch_size)
        return prog

    def _rows(self, X_batches):
        """This rank's rows of stacked (T, b, n) batches on a mesh (their
        columns are this rank's already); the batches off the mesh."""
        if self.mesh is None:
            return X_batches
        return pmesh.shard_batches(X_batches, self.mesh)

    def _offload_segment(self, X_batches, idx_batches):
        self._state = offload_scan(
            self._state, X_batches, idx_batches, self._cfg,
            draw_epoch(self._state, self._cfg, X_batches.shape[0]),
            self._staging(idx_batches.numel()))

    def _staging(self, rows):
        """The pinned host buffer an offload segment's G_avg rows pass
        through, kept across calls and grown to ``rows`` on demand."""
        buf = getattr(self, '_offload_staging', None)
        if buf is None or buf.shape[0] < rows:
            G_avg = self._state.G_avg
            buf = torch.empty((rows,) + G_avg.shape[1:], dtype=G_avg.dtype,
                              pin_memory=G_avg.is_pinned())
            self._offload_staging = buf
        return buf

    def _offloads(self):
        """Whether G_avg lives in host RAM: ``average_offload``, off a
        mesh (on a mesh G_avg is split over dp instead)."""
        return bool(self.average_offload) and self.mesh is None

    def _avg_zeros(self, dtype, device, rows=None):
        """Zeroed G_avg of ``rows`` rows (default: every sample's): in
        host RAM under ``average_offload`` (pinned on CUDA, never staged
        through a device tensor), else on the device."""
        shape = (self._n_samples if rows is None else rows,
                 self.n_components, self.n_components)
        if self._offloads():
            return host_zeros(shape, dtype, device)
        return torch.zeros(shape, dtype=dtype, device=device)

    def _place_g_avg(self):
        """Move G_avg where the configuration keeps it (a loaded or
        unpickled state has it in host RAM; ``set_params`` may toggle
        ``average_offload``). Returns whether the epoch is offloaded."""
        st = self._state
        if st.G_avg is None:
            return False
        device = st.D.device
        if self._cfg.average_offload:
            if st.G_avg.device.type != 'cpu':
                st.G_avg = host_zeros(st.G_avg.shape, st.G_avg.dtype,
                                      device).copy_(st.G_avg)
            return True
        st.G_avg = st.G_avg.to(device)
        return False

    def _callback(self):
        if self.callback is not None:
            self.callback(self)

    def shuffle(self):
        """Co-shuffle per-sample state; return the permutation used."""
        st = self._state
        with span('modl.shuffle.perm'):
            seed = self.random_state.randint(MAX_INT)
            perm = np.random.RandomState(seed).permutation(self._n_samples)
            perm_dev = torch.as_tensor(perm, device=st.D.device)
        with span('modl.shuffle.gather'):
            if st.layout is not None and st.layout.split_rows:
                self._shuffle_shards(perm_dev)
            else:
                self._shuffle_leaves(perm, perm_dev)
            self.labels_ = self.labels_[perm]
        return perm

    def _shuffle_leaves(self, perm, perm_dev):
        """Permute the per-sample leaves of a state off the mesh's dp
        split by ``perm`` (numpy) or its copy on the device."""
        st = self._state
        for name in ('code', 'G_avg', 'Dx_avg', 'sample_n_iter'):
            arr = getattr(st, name)
            if arr is None:
                continue
            if arr.device != st.D.device:
                # the offloaded G_avg: permuted in host RAM, kept pinned
                out = torch.empty(arr.shape, dtype=arr.dtype,
                                  pin_memory=arr.is_pinned())
                setattr(st, name, torch.index_select(
                    arr, 0, torch.as_tensor(perm), out=out))
            else:
                # in place: the leaf keeps its address, and the device
                # programs that hold it stay valid
                arr.copy_(torch.index_select(arr, 0, perm_dev))

    def _shuffle_shards(self, perm):
        """Permute the dp-split per-sample leaves: the rows of each rank's
        new block are gathered over dp in turn, one rank's block at a
        time, so no rank holds more than its share."""
        st = self._state
        names = [name for name in pmesh.SAMPLE_LEAVES
                 if getattr(st, name) is not None]
        r0, m = st.layout.rows()
        for start in range(0, self._n_samples, m):
            rows = pmesh.gather_rows(
                [getattr(st, name) for name in names],
                perm[start:start + m], self.mesh, self._n_samples, True)
            if start == r0:
                mine = [r.contiguous() for r in rows]
        for name, arr in zip(names, mine):
            setattr(st, name, arr)

    def set_params(self, **params):
        """set_params with the JAX package's mid-run hooks: G_agg='full'
        recomputes the Gram, switching an aggregator to 'average' lazily
        allocates its zeroed per-sample state, and the configuration is
        rebuilt (``_migrate_layout`` moves a windowed state to the new
        window width). On a mesh the state is gathered whole for this and
        sharded again after (collectives: every rank calls it)."""
        G_agg = params.pop('G_agg', None)
        st = getattr(self, '_state', None)
        self._program = None
        self._scans = {}
        if st is not None and st.layout is not None:
            st = self._state = pmesh.unshard_state(st)
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
                st.G_avg = self._avg_zeros(st.D.dtype, st.D.device)
        if hasattr(self, '_n_features'):
            old_cfg = getattr(self, '_cfg', None)
            new_cfg = self._make_config(self._n_features)
            if old_cfg is not None and st is not None:
                new_cfg = self._migrate_layout(old_cfg, new_cfg)
            self._cfg = new_cfg
        if st is not None and self.mesh is not None:
            self._state = self._shard(st)
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
        fits = (new_cfg.len_subset < n and n >= 2 * new_width
                and self._mesh_holds_windows(n, new_width))
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
