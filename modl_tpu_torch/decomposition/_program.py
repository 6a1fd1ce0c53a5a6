"""The SOMF step as one device program: the counterpart of the JAX
package's ``somf_step_jit`` (``modl_tpu/decomposition/_step.py:825``),
which runs an interactive step as one XLA dispatch.

A :class:`StepProgram` owns static device buffers for a step's inputs
(the batch rows, their sample indices, and the subset, order and
scalars of :class:`_step.DrawLayout`), a pinned staging ring
(:class:`_step.DrawStaging`) and, on CUDA, one ``torch.cuda.CUDAGraph``
of ``_step._step_body`` over those buffers and the state's leaves. A
step draws on the host generator exactly as ``somf_step`` does, stages
the draws and scalars in one non-blocking copy and the rows in one
device copy (:meth:`StepProgram.stage`), and replays the graph
(:meth:`StepProgram.run`): the host issues three copies and one graph
launch, reads nothing back, and waits for the card only when the ring
is two steps ahead of it. The first step runs the body eagerly on a
side stream (the warm-up ``torch.cuda.graphs`` asks for) and is then
captured; the capture itself launches nothing. On the CPU, which only
the tests ask for, ``run`` calls the same body on the same buffers.

Which configurations run as a program is decided from the configuration
alone by :func:`capturable`; the others step eagerly through
``somf_step``, each for a reason:

- windowed subsets: the window start is a host int that slices D;
- ``code_solver='cd'``: it reads a convergence flag every sweep;
- ridge codes on per-row Grams (``G_agg='average'``): the batched
  Cholesky solve goes to MAGMA, whose ``spotrs_batched`` allocates
  device memory during the call, which a capture refuses;
- a mesh: ``agree`` reads a count at each check, over gloo or NCCL;
- ``average_offload``: segments gather and scatter in host RAM;
- the plain BCD path (``use_kernel`` off: the CPU, or the kernel's
  plain version on the card), which reads the atom order back.

A capture that fails raises; nothing falls back to the eager step. A
program is tied to one state object, configuration, batch size and the
addresses of the state's leaves (:meth:`StepProgram.holds`); the
estimator builds a new one when any of them changes. The kernels'
launch counters count launches that ran: a capture records what it
would launch and each replay adds that (``LAUNCHES`` of ``ops.bcd`` and
``ops.fista``).
"""
import time

import torch

from ..ops import bcd, fista
from ._step import (DrawLayout, DrawStaging, _step_body, draw_step,
                    step_scalars)

__all__ = ["StepProgram", "capturable", "CAPTURES", "STEPS"]

# graphs captured and steps run by programs (read by chip_smoke.py)
CAPTURES = 0
STEPS = 0

AGGREGATORS = ('full', 'masked', 'average')
# the state's leaves a step reads or writes on the device
LEAVES = ('D', 'C', 'B', 'G', 'comp_norm', 'code', 'Dx_avg', 'G_avg',
          'sample_n_iter')
# the launch counters of the kernels a step launches
COUNTED = (bcd, fista)


def capturable(cfg):
    """Whether steps of ``cfg`` run as a :class:`StepProgram`: gather
    subsets (with or without ``rand_size``), the ``variational`` or
    ``sgd`` optimizer, any aggregators, FISTA codes, or ridge codes on a
    shared Gram (``G_agg`` not ``'average'``), the kernels on
    (``use_kernel``: CUDA, float32), no mesh, no ``average_offload``."""
    ridge = cfg.code_l1_ratio == 0.0
    return (cfg.use_kernel and not cfg.windowed
            and cfg.optimizer in ('variational', 'sgd')
            and cfg.Dx_agg in AGGREGATORS and cfg.G_agg in AGGREGATORS
            and (cfg.G_agg != 'average' if ridge
                 else cfg.code_solver == 'fista')
            and cfg.mesh is None and not cfg.average_offload)


def _addresses(state):
    return tuple(None if getattr(state, name) is None
                 else getattr(state, name).data_ptr() for name in LEAVES)


class StepProgram:
    """The step of ``cfg`` at batch size ``batch_size`` on ``state``, as
    one captured graph on CUDA (see the module docstring).

    ``capture_s`` holds the seconds the capture took (``None`` before
    it), ``graph`` the ``torch.cuda.CUDAGraph`` once captured, and
    ``launches`` the ``(counter module, launches)`` a replay makes."""

    def __init__(self, state, cfg, batch_size):
        if not capturable(cfg):
            raise ValueError('this configuration does not run as a step '
                             'program (see _program.capturable)')
        D = state.D
        self.device = D.device
        self.state, self.cfg, self.batch_size = state, cfg, batch_size
        # the leaves are held, so no new tensor takes their addresses
        self.leaves = [getattr(state, name) for name in LEAVES]
        self.addresses = _addresses(state)
        self.layout = DrawLayout.of(cfg, D.dtype)
        self.X = torch.zeros((batch_size, D.shape[1]), dtype=D.dtype,
                             device=self.device)
        self.idx = torch.zeros(batch_size, dtype=torch.int64,
                               device=self.device)
        self.draws = torch.zeros(self.layout.nbytes, dtype=torch.uint8,
                                 device=self.device)
        self.subset, self.order, self.scalars = self.layout.views(
            self.draws)
        self.staging = DrawStaging(self.device)
        self.graph = None
        self.launches = None
        self.capture_s = None

    def holds(self, state, cfg, batch_size):
        """Whether this program steps ``state`` under ``cfg`` at
        ``batch_size``, with its leaves where they were."""
        return (state is self.state and cfg == self.cfg
                and batch_size == self.batch_size
                and _addresses(state) == self.addresses)

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
        """Run the staged step: replay the graph (capture it at the first
        step, after running that step as the warm-up) on CUDA; the body
        on the buffers on the CPU."""
        global STEPS
        if self.device.type != 'cuda':
            self._body()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            for module, n in self.launches:
                module.LAUNCHES += n
        STEPS += 1

    def step(self, X_rows, idx):
        """One minibatch update of the state: host draws and scalars as
        ``somf_step`` makes them, :meth:`stage`, :meth:`run`."""
        subset, n_valid, order = draw_step(self.state, self.cfg)
        scalars = step_scalars(self.state, self.cfg, self.batch_size,
                               n_valid)
        self.stage(X_rows, idx, (subset, order), scalars)
        self.run()

    def _body(self):
        _step_body(self.state, self.X, self.idx, self.subset, self.order,
                   self.scalars, self.cfg, self.cfg.rand_size)

    def _capture(self):
        """The staged step eagerly on a side stream, then the capture of
        the body (which runs nothing) on the same stream."""
        global CAPTURES
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body()
            t0 = time.perf_counter()
            before = [module.LAUNCHES for module in COUNTED]
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode='thread_local')
            try:
                self._body()
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
