"""The SOMF step and the fused epoch as device programs: the
counterparts of the JAX package's ``somf_step_jit``
(``modl_tpu/decomposition/_step.py:825``), which runs an interactive
step as one XLA dispatch, and of its jitted ``somf_scan`` (``:939``),
which runs an epoch of resident minibatches as one.

A :class:`StepProgram` owns static device buffers for a step's inputs
(the batch rows, their sample indices, and the subset or window start,
order and scalars of :class:`_step.DrawLayout`), a pinned staging ring
(:class:`_step.DrawStaging`) and, on CUDA, one ``torch.cuda.CUDAGraph``
of ``_step._step_body`` over those buffers and the state's leaves. A
step draws on the host generator exactly as ``somf_step`` does, stages
the draws and scalars in one non-blocking copy and the rows in one
device copy (:meth:`StepProgram.stage`), and replays the graph
(:meth:`StepProgram.run`): the host issues three copies and one graph
launch, reads nothing back, and waits for the card only when the ring
is two steps ahead of it.

A :class:`ScanProgram` does the same for an epoch of T batches of b
rows: its buffers hold the epoch's rows (T, b, n_stored), sample
indices and T rows of draws and scalars, and its graph holds
``_step._scan_body``: every step body with its BCD (and, for l1 codes,
FISTA) launches and every deferred-B segment end with its EMA-GEMM
launch, whose ``pi`` is read from the staged scalars. An epoch draws on
the host generator as ``draw_epoch`` does, stages the draws and scalars
(``_step.epoch_scalars``) in one non-blocking copy, gathers or copies
the rows into the row buffer (:meth:`ScanProgram.stage`) and replays
the graph (:meth:`ScanProgram.run`).

The first run of a program runs its body eagerly on a side stream (the
warm-up ``torch.cuda.graphs`` asks for) and is then captured; the
capture itself launches nothing. On the CPU, which only the tests ask
for, ``run`` calls the same body on the same buffers.

A :class:`RecsysProgram` runs T batches of b rows of a
``RecsysDictFact`` fit over its resident packed rows, the counterpart
of the JAX package's ``_recsys_window_resident`` (T = 32,
``modl_tpu/decomposition/recsys.py:606``) and
``_recsys_batch_resident`` (T = 1, ``:623``): its buffer holds each
batch's rows (b,) int64, atom order (k,) int32 and scalars in the
state's dtype, staged in one non-blocking copy, and its graph holds,
for each batch, the row gathers, the masked ridge codes, the code write,
the B and C EMAs, the union mask and one BCD launch (the body is the
recsys module's, handed in by the estimator).

Which configurations run as programs is decided from the configuration
alone by :func:`capturable` (SOMF) and :func:`capturable_recsys`; the
others step eagerly through ``somf_step`` and ``somf_scan`` (or the
recsys module's eager batches), each for a reason:

- ``code_solver='cd'``: it reads a convergence flag every sweep;
- a mesh: ``agree`` reads a count at each check, over gloo or NCCL (a
  recsys mesh fit reassembles its batch rows by all-reduces);
- recsys rows packed a batch at a time (not resident): each batch has
  its own width, read from the host's row lengths;
- ``average_offload``: segments gather and scatter in host RAM;
- the plain BCD path (``use_kernel`` off: the CPU, or the kernel's
  plain version on the card), which reads the atom order back.

Ridge codes on per-row Grams (``G_agg='average'``, and every recsys
batch) solve through ``ops.solvers.spd_solve``, whose batched Cholesky
factorisation and triangular solves a capture takes (the batched
``torch.cholesky_solve`` does not: MAGMA's ``potrs_batched`` allocates
device memory during the call).

The host's parts of a program's step or epoch are spans on the
profiler's clock (``utils.profiling.span``, which constructs nothing
while no profiler runs): ``modl.draw``, ``modl.stage`` (with
``modl.stage.wait`` where the ring waits for a slot), ``modl.run`` and,
inside a first run, ``modl.capture``. No span sits inside a body, so the
captured graphs hold only the step's work.

A capture that fails raises; nothing falls back to the eager step or
scan. A program is tied to one state object, configuration, shape and
the addresses of the state's leaves (``holds``); the estimator builds a
new one when any of them changes (a recsys fit builds its programs
anew each ``fit``). The kernels' launch counters count launches that
ran: a capture records what it would launch and each replay adds that
(``LAUNCHES`` of ``ops.bcd``, ``ops.fista`` and ``ops.ema_gemm``).
"""
import time

import torch

from ..ops import bcd, ema_gemm, fista
from ..utils.profiling import span
from ._step import (DrawLayout, DrawStaging, _scan_body, _step_body,
                    draw_step, epoch_scalars, step_scalars)

__all__ = ["StepProgram", "ScanProgram", "RecsysProgram", "capturable",
           "capturable_recsys", "CAPTURES", "STEPS", "EPOCHS"]

# graphs captured, steps run by step programs and epochs run by scan
# programs (read by chip_smoke.py)
CAPTURES = 0
STEPS = 0
EPOCHS = 0

AGGREGATORS = ('full', 'masked', 'average')
# the state's leaves a step reads or writes on the device
LEAVES = ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg', 'G_avg',
          'sample_n_iter')
# the launch counters of the kernels a program launches
COUNTED = (bcd, fista, ema_gemm)


def capturable(cfg):
    """Whether steps and epochs of ``cfg`` run as programs: gather or
    windowed subsets (with or without ``rand_size``), the
    ``variational`` or ``sgd`` optimizer, any aggregators, ridge or
    FISTA codes, the kernels on (``use_kernel``: CUDA, float32), no
    mesh, no ``average_offload``."""
    return (cfg.use_kernel
            and cfg.optimizer in ('variational', 'sgd')
            and cfg.Dx_agg in AGGREGATORS and cfg.G_agg in AGGREGATORS
            and (cfg.code_l1_ratio == 0.0 or cfg.code_solver == 'fista')
            and cfg.mesh is None and not cfg.average_offload)


def capturable_recsys(cfg, resident):
    """Whether a ``RecsysDictFact`` fit of ``cfg`` (a
    ``recsys.RecsysConfig``) runs its batches as programs: the BCD
    kernel on (``use_kernel``: CUDA, float32; its plain version reads the
    atom order back), rows ``resident`` (packed once; packed a batch at
    a time, each batch has its own width), no mesh (a batch's rows are
    reassembled by all-reduces over ``dp``)."""
    return bool(cfg.use_kernel and resident and cfg.mesh is None)


def _addresses(leaves):
    return tuple(None if t is None else t.data_ptr() for t in leaves)


class _Program:
    """What every program shares: the leaves it reads and writes (held,
    so that no new tensor takes their addresses), their addresses, a
    staging ring for the draws, and the run of ``body`` (a callable of no
    argument): the body on the CPU; on CUDA its capture, then replays.

    ``capture_s`` holds the seconds the capture took (``None`` before
    it), ``graph`` the ``torch.cuda.CUDAGraph`` once captured, and
    ``launches`` the ``(counter module, launches)`` a replay makes."""

    def __init__(self, device, leaves, body):
        self.device = device
        self.leaves = list(leaves)
        self.addresses = _addresses(self.leaves)
        self.body = body
        self.staging = DrawStaging(device)
        self.graph = None
        self.launches = None
        self.capture_s = None

    def _run(self):
        """Replay the graph (capture it at the first run, after running
        the body as the warm-up) on CUDA; the body on the CPU."""
        with span('modl.run'):
            if self.device.type != 'cuda':
                self.body()
            elif self.graph is None:
                with span('modl.capture'):
                    self._capture()
            else:
                self.graph.replay()
                for module, n in self.launches:
                    module.LAUNCHES += n

    def _capture(self):
        """The staged inputs' run eagerly on a side stream, then the
        capture of the body (which runs nothing) on the same stream."""
        global CAPTURES
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body()
            t0 = time.perf_counter()
            before = [module.LAUNCHES for module in COUNTED]
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode='thread_local')
            try:
                self.body()
            finally:
                graph.capture_end()
            self.launches = []
            for module, n in zip(COUNTED, before):
                self.launches.append((module, module.LAUNCHES - n))
                module.LAUNCHES = n
            self.capture_s = time.perf_counter() - t0
        main.wait_stream(side)
        self.graph = graph
        CAPTURES += 1


class _SomfProgram(_Program):
    """What the SOMF programs share: the state and configuration they
    are tied to, the draws' layout, and the static buffers of rows,
    sample indices and draws."""

    def __init__(self, state, cfg):
        if not capturable(cfg):
            raise ValueError('this configuration does not run as a device '
                             'program (see _program.capturable)')
        super().__init__(state.D.device,
                         [getattr(state, name) for name in LEAVES],
                         self._body)
        self.state, self.cfg = state, cfg
        self.layout = DrawLayout.of(cfg, state.D.dtype)

    def _buffers(self, shape, n_steps):
        """Static buffers: rows (``shape`` + (n_stored,)), sample indices
        (``shape``) and the draws of ``n_steps`` steps (uint8, a
        ``DrawLayout.nbytes`` row each)."""
        D = self.state.D
        self.X = torch.zeros(shape + (D.shape[1],), dtype=D.dtype,
                             device=self.device)
        self.idx = torch.zeros(shape, dtype=torch.int64, device=self.device)
        self.draws = torch.zeros(n_steps * self.layout.nbytes,
                                 dtype=torch.uint8, device=self.device)

    def _holds(self, state, cfg):
        return (state is self.state and cfg == self.cfg
                and _addresses([getattr(state, name) for name in LEAVES])
                == self.addresses)


class StepProgram(_SomfProgram):
    """The step of ``cfg`` at batch size ``batch_size`` on ``state``, as
    one captured graph on CUDA (see the module docstring)."""

    def __init__(self, state, cfg, batch_size):
        super().__init__(state, cfg)
        self.batch_size = batch_size
        self._buffers((batch_size,), 1)
        self.subset, self.order, self.scalars = self.layout.views(
            self.draws)

    def holds(self, state, cfg, batch_size):
        """Whether this program steps ``state`` under ``cfg`` at
        ``batch_size``, with its leaves where they were."""
        return self._holds(state, cfg) and batch_size == self.batch_size

    def stage(self, X_rows, idx, draws, scalars):
        """Put a step's inputs in the static buffers: the host ``draws``
        ``(subset, order)`` and ``scalars`` (``_step.step_scalars``) in
        one non-blocking copy through the ring, the rows ``X_rows`` and
        sample indices ``idx`` (device tensors) by device copies."""
        subset, order = draws
        self.staging.send(self.layout, subset, order, scalars,
                          out=self.draws)
        self.X.copy_(X_rows)
        self.idx.copy_(idx)

    def run(self):
        """Run the staged step (:meth:`_Program._run`)."""
        global STEPS
        self._run()
        STEPS += 1

    def step(self, X_rows, idx):
        """One minibatch update of the state: host draws and scalars as
        ``somf_step`` makes them, :meth:`stage`, :meth:`run`."""
        with span('modl.draw'):
            subset, n_valid, order = draw_step(self.state, self.cfg)
        with span('modl.stage'):
            scalars = step_scalars(self.state, self.cfg, self.batch_size,
                                   n_valid)
            self.stage(X_rows, idx, (subset, order), scalars)
        self.run()

    def _body(self):
        _step_body(self.state, self.X, self.idx, self.subset, self.order,
                   self.scalars, self.cfg, self.cfg.rand_size)


class ScanProgram(_SomfProgram):
    """The fused epoch of ``cfg`` over ``n_batches`` batches of
    ``batch_size`` rows on ``state``, as one captured graph on CUDA (see
    the module docstring): ``_step.somf_scan`` with its inputs in static
    buffers. ``X`` holds the epoch's rows (T, b, n_stored), ``idx`` their
    sample indices (T, b) and ``steps`` each step's ``(subset, order,
    scalars)`` views of the staged draws."""

    def __init__(self, state, cfg, n_batches, batch_size):
        super().__init__(state, cfg)
        self.n_batches, self.batch_size = n_batches, batch_size
        self._buffers((n_batches, batch_size), n_batches)
        nb = self.layout.nbytes
        self.steps = [self.layout.views(self.draws[t * nb:(t + 1) * nb])
                      for t in range(n_batches)]

    def holds(self, state, cfg, n_batches, batch_size):
        """Whether this program runs epochs of ``n_batches`` batches of
        ``batch_size`` on ``state`` under ``cfg``, with its leaves where
        they were."""
        return (self._holds(state, cfg) and n_batches == self.n_batches
                and batch_size == self.batch_size)

    def stage(self, X, idx, draws, rows=None):
        """Put an epoch's inputs in the static buffers: the host ``draws``
        (a ``_step.Draws``) and their scalars (``_step.epoch_scalars``,
        which advances the sample counter) in one non-blocking copy
        through the ring; the rows ``X[rows]`` by one gather
        (``rows`` a device index of T b rows) or the first T b rows of
        ``X`` by one device copy, and the sample indices ``idx`` (T b,
        on the device) by another."""
        T, b = self.n_batches, self.batch_size
        with span('modl.stage'):
            scalars = epoch_scalars(self.state, self.cfg, b, draws.sizes)
            self.staging.send_steps(
                self.layout, list(zip(draws.subsets, draws.orders, scalars)),
                out=self.draws)
            flat = self.X.view(T * b, -1)
            if rows is None:
                flat.copy_(X[:T * b])
            else:
                torch.index_select(X, 0, rows, out=flat)
            self.idx.view(-1).copy_(idx)

    def run(self):
        """Run the staged epoch (:meth:`_Program._run`)."""
        global EPOCHS
        self._run()
        EPOCHS += 1

    def epoch(self, X, idx, draws, rows=None):
        """One epoch of the state: :meth:`stage`, :meth:`run`."""
        self.stage(X, idx, draws, rows)
        self.run()

    def _body(self):
        _scan_body(self.state, self.X, self.idx, self.cfg, self.steps)


class RecsysProgram(_Program):
    """``n_batches`` batches of a recsys fit as one captured graph on CUDA
    (see the module docstring). ``leaves`` are the tensors the batches
    read and write (the state's and the resident packed rows), ``batch``
    the body of one batch, called with its ``(rows, order, scalars)``
    views of the staged draws, and ``layout`` (a ``DrawLayout`` of b
    rows) where those lie in a batch's bytes. ``runs`` counts the
    program's runs (replays, and the run that captured it)."""

    def __init__(self, leaves, batch, layout, n_batches):
        super().__init__(leaves[0].device, leaves, self._body)
        self.batch, self.layout = batch, layout
        self.n_batches = n_batches
        nb = layout.nbytes
        self.draws = torch.zeros(n_batches * nb, dtype=torch.uint8,
                                 device=self.device)
        self.batches = [layout.views(self.draws[t * nb:(t + 1) * nb])
                        for t in range(n_batches)]
        self.runs = 0

    def stage(self, steps):
        """Put the batches' host draws ``(rows, order, scalars)`` (numpy)
        in the static buffer in one non-blocking copy through the ring."""
        self.staging.send_steps(self.layout, steps, out=self.draws)

    def run(self):
        """Run the staged batches (:meth:`_Program._run`)."""
        self._run()
        self.runs += 1

    def _body(self):
        for rows, order, scalars in self.batches:
            self.batch(rows, order, scalars)
