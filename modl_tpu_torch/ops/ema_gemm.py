"""In-place EMA-GEMM ``B <- pi * B + SC^T @ X``: the Hopper kernel's
wrapper and its plain PyTorch version.

Counterpart of ``modl_tpu/ops/ema_gemm.py``. ``somf_scan``'s deferred-B
segments end with one full-width materialisation of the surrogate
statistics, ``B = pi * B0 + SC^T Xseg`` over the (k, n_stored) state;
this module fuses the decay, the product and the accumulate into one
pass that reads X once and reads and writes B once
(``csrc/ema_gemm.cu``). The kernel runs the product on the tensor cores
in 3xTF32: each float32 operand is split into a TF32 ``hi`` and a TF32
``lo = x - hi`` and three TF32 products (``hi*lo``, ``lo*hi``,
``hi*hi``) are summed in float32 (a fresh tensor-core accumulator for
each window of 16 or 64 rows of m, added into a float32 sum), which
keeps ~21 bits of the inputs (relative error ~1e-6 a product; a numpy
emulation in tests/test_torch_ema_gemm.py bounds the result at 1e-6 of
``max |SC^T X|`` at the segment-end shapes). That is not single-pass TF32,
which ``precision.py`` rules out; the plain version runs in full float32
under ``precision.full_f32()``. The TPU kernel's single bf16 pass was a
limitation of Mosaic and is not kept.

The step routes here only when ``ENABLED`` is set and :func:`supported`
accepts the shape. ``ENABLED`` is on by default, unlike the JAX
package's gate: on the H100 the kernel beats the plain ``addmm_`` at
every segment-end shape of the fits, and their ``partial_fit`` is no
slower with it on (``PERF.md``, section 6). The TPU gate's
VMEM budget and ``k % 8`` rule have no counterpart: the Hopper kernel
tiles atoms in widths of 8 up to 128 and masks the ragged edges, so it
takes any shape. What it needs is float32 data on a CUDA device,
contiguous; ``supported`` checks the flag and the dtype, the step's
``cfg.use_kernel`` the device, and :func:`ema_accumulate` raises on a
CUDA tensor it cannot take.

``ema_accumulate`` runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel (a split of SC into scratch, then the
product) or raises. ``pi`` is a 0-d float32 tensor on B's device, which
the kernel reads from device memory (one load a block), so that a
captured segment end (``decomposition/_program.py``'s ``ScanProgram``)
takes each epoch's value. ``LAUNCHES`` counts calls that launched it,
one per segment end.
"""
import ctypes
import functools

import torch

from . import _build

__all__ = ["ema_accumulate", "ema_accumulate_reference", "supported",
           "ENABLED", "LAUNCHES"]

# route the segment end through the kernel (chip_smoke.py compares the
# fits with it on and off)
ENABLED = True

# calls of ``ema_accumulate`` that launched the kernel (read by
# chip_smoke.py)
LAUNCHES = 0


def supported(k, n, m, dtype):
    """Whether the step may route a (B (k, n), SC (m, k)) segment end
    through :func:`ema_accumulate`."""
    return (ENABLED and dtype == torch.float32
            and min(int(k), int(n), int(m)) >= 1)


def ema_accumulate_reference(B, SC, X, pi):
    """Plain PyTorch version: ``B.mul_(pi).addmm_(SC.T, X)``, in place;
    returns B. ``pi`` a 0-d tensor of B's dtype on its device, or a
    number: the same products, bitwise."""
    return B.mul_(pi).addmm_(SC.T, X)


@functools.cache
def _kernel():
    return _build.entry('modl_ema_accumulate_f32',
                        [ctypes.c_void_p] * 3
                        + [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
                        + [ctypes.c_void_p] * 3)


@functools.cache
def _scratch_floats():
    return _build.entry('modl_ema_scratch_floats',
                        [ctypes.c_int, ctypes.c_int], ctypes.c_int64)


def ema_accumulate(B, SC, X, pi):
    """``B <- pi * B + SC^T @ X`` in place; returns B.

    B (k, n), SC (m, k), X (m, n); ``pi`` a 0-d float32 tensor on B's
    device (the CPU route takes a number too). CPU tensors run
    :func:`ema_accumulate_reference`; CUDA tensors launch the Hopper
    kernel on the current stream (no synchronisation; ``pi`` is read on
    the card) and raise on anything it does not take. The kernel's
    result differs from the plain version's by the 3xTF32 split (~1e-6
    of ``max |SC^T X|``)."""
    global LAUNCHES
    if B.device.type == 'cpu':
        return ema_accumulate_reference(B, SC, X, pi)
    if B.device.type != 'cuda':
        raise ValueError('ema_accumulate: tensors must be on CPU or CUDA, '
                         f'got {B.device}')
    k, n = B.shape
    m = SC.shape[0]
    shapes = {'B': (k, n), 'SC': (m, k), 'X': (m, n)}
    for name, t in (('B', B), ('SC', SC), ('X', X)):
        if t.device != B.device or t.dtype != torch.float32:
            raise ValueError(f'ema_accumulate: {name} must be float32 on '
                             f'{B.device}, got {t.dtype} on {t.device}')
        if tuple(t.shape) != shapes[name] or not t.is_contiguous():
            raise ValueError(f'ema_accumulate: {name} must be a contiguous '
                             f'{shapes[name]} tensor, got {tuple(t.shape)}')
    if not (torch.is_tensor(pi) and pi.dim() == 0 and pi.device == B.device
            and pi.dtype == torch.float32):
        raise ValueError(f'ema_accumulate: pi must be a 0-d float32 tensor '
                         f'on {B.device}, got {pi!r}')
    # the split SC^T (hi, lo), on B's device and the current stream
    scratch = torch.empty(_scratch_floats()(k, m), dtype=torch.float32,
                          device=B.device)
    err = _kernel()(B.data_ptr(), SC.data_ptr(), X.data_ptr(), k, n, m,
                    pi.data_ptr(), scratch.data_ptr(),
                    torch.cuda.current_stream(B.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ema_accumulate: kernel launch failed with '
                           f'cudaError {err} at (k={k}, n={n}, m={m})')
    LAUNCHES += 1
    return B
