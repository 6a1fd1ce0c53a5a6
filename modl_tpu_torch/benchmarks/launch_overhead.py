"""Micro-benchmark: the fixed cost of one kernel launch on the card.

Counterpart of ``benchmarks/pallas_call_overhead.py``, which measured the
fixed cost of one ``pallas_call`` and motivated the BCD block driver's
single-call design. The probe is the same trivial pass at the HCP-1024
block driver's operand shapes, ``D <- 0.9999 D + 1e-6 G`` in place over
panels of 64 rows (``csrc/launch_overhead.cu``), and a step covers four
256-atom blocks with 4, 2 or 1 launches: the difference between the
three is the cost of a launch.

Usage (needs a CUDA device)::

    python -m modl_tpu_torch.benchmarks.launch_overhead
"""
import ctypes
import functools

import numpy as np
import torch

from ..ops import _build

__all__ = ["make_call", "launch_overhead_reference", "bench", "main",
           "LAUNCHES"]

KP, SPP, FOLD, P = 256, 1360, 8, 8      # HCP-1024 block shapes
PPB = KP // P                            # panels per block
PANEL_ROWS = P * FOLD                    # rows of one panel (64)
BLOCK_ROWS = KP * FOLD                   # rows of one block (2,048)
SCALE, ALPHA = 0.9999, 1e-6

# kernel launches made by the calls of ``make_call`` (read by chip_smoke.py)
LAUNCHES = 0


def launch_overhead_reference(D, G):
    """Plain PyTorch version: ``D <- 0.9999 D + 1e-6 G`` in place (the
    products and the sum rounded separately); returns D."""
    return D.mul_(SCALE).add_(G * ALPHA)


@functools.cache
def _kernel():
    return _build.entry('modl_launch_overhead_f32',
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                         ctypes.c_void_p])


def make_call(n_blocks):
    """One launch covering ``n_blocks`` x 32 panels of 64 rows.

    The returned ``call(D, G)`` updates D, (n_blocks * 2,048, 1,360)
    float32, in place and returns it. CPU tensors run
    :func:`launch_overhead_reference`; CUDA tensors launch the kernel on
    the current stream or raise."""
    shape = (n_blocks * BLOCK_ROWS, SPP)
    n_panels = n_blocks * PPB

    def call(D, G):
        global LAUNCHES
        for name, t in (('D', D), ('G', G)):
            if tuple(t.shape) != shape or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.device != D.device:
                raise ValueError(f'launch_overhead: {name} must be a '
                                 f'contiguous float32 {shape} tensor on '
                                 f'{D.device}')
        if D.device.type == 'cpu':
            return launch_overhead_reference(D, G)
        if D.device.type != 'cuda':
            raise ValueError(f'launch_overhead: tensors must be on CPU or '
                             f'CUDA, got {D.device}')
        if D.data_ptr() % 16 or G.data_ptr() % 16:
            raise ValueError('launch_overhead: D and G must be 16-byte '
                             'aligned')
        err = _kernel()(D.data_ptr(), G.data_ptr(), n_panels,
                        PANEL_ROWS * SPP, SCALE, ALPHA,
                        torch.cuda.current_stream(D.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'launch_overhead: kernel launch failed '
                               f'with cudaError {err} ({n_panels} panels)')
        LAUNCHES += 1
        return D
    return call


def operands(n_blocks=4, seed=0, device='cuda'):
    """D and G of ``n_blocks`` blocks: Gaussian D from ``seed``, G = D."""
    D = np.random.RandomState(seed).randn(n_blocks * BLOCK_ROWS, SPP)
    D = torch.as_tensor(D.astype(np.float32)).to(device)
    return D, D.clone()


def bench(n_calls, reps=50):
    """ms per step of four blocks made of ``n_calls`` launches of
    ``4 // n_calls`` blocks each, timed with CUDA events over ``reps``
    steps after one warm-up step."""
    if not torch.cuda.is_available():
        raise RuntimeError('launch_overhead.bench needs a CUDA device')
    per_call = 4 // n_calls
    call = make_call(per_call)
    D, G = operands()
    rows = per_call * BLOCK_ROWS
    parts = [(D[c * rows:(c + 1) * rows], G[c * rows:(c + 1) * rows])
             for c in range(n_calls)]

    def step():
        for Dc, Gc in parts:
            call(Dc, Gc)

    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    """Print ms per step and per launch at 4, 2 and 1 launches per step;
    return them as ``{n_calls: (ms_per_step, ms_per_call)}``."""
    out = {}
    for n_calls in (4, 2, 1):
        ms = bench(n_calls)
        out[n_calls] = (ms, ms / n_calls)
        print(f'{n_calls} calls/step (grid {4 // n_calls * PPB} each): '
              f'{ms:.4f} ms/step -> {ms / n_calls:.4f} ms/call', flush=True)
    return out


if __name__ == '__main__':
    main()
