"""In-place EMA-GEMM ``B <- pi * B + SC^T @ X``: the Hopper kernel's
wrapper and its plain PyTorch version.

Counterpart of ``modl_tpu/ops/ema_gemm.py``. ``somf_scan``'s deferred-B
segments end with one full-width materialisation of the surrogate
statistics, ``B = pi * B0 + SC^T Xseg`` over the (k, n_stored) state;
this module fuses the decay, the product and the accumulate into one
pass that reads X once and reads and writes B once
(``csrc/ema_gemm.cu``). Inputs and accumulation are float32, as the
port's plain path runs them under ``precision.full_f32()``; the TPU
kernel's single bf16 pass was a limitation of Mosaic and is not kept.

As in the JAX package the step routes here only when ``ENABLED`` is set
(off by default) and :func:`supported` accepts the shape. The TPU gate's
VMEM budget and ``k % 8`` rule have no counterpart: the Hopper kernel
tiles B in fixed (64, 128) blocks with masked edges, so it takes any
shape. What it needs is float32 data on a CUDA device, contiguous;
``supported`` checks the flag and the dtype, the step's
``cfg.use_kernel`` the device, and :func:`ema_accumulate` raises on a
CUDA tensor it cannot take.

``ema_accumulate`` runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches.
"""
import ctypes
import functools

import torch

from . import _build

__all__ = ["ema_accumulate", "ema_accumulate_reference", "supported",
           "ENABLED", "LAUNCHES"]

# route the segment end through the kernel (off by default, as in the
# JAX package; chip_smoke.py turns it on and compares both settings)
ENABLED = False

# kernel launches made by ``ema_accumulate`` (read by chip_smoke.py)
LAUNCHES = 0


def supported(k, n, m, dtype):
    """Whether the step may route a (B (k, n), SC (m, k)) segment end
    through :func:`ema_accumulate`."""
    return (ENABLED and dtype == torch.float32
            and min(int(k), int(n), int(m)) >= 1)


def ema_accumulate_reference(B, SC, X, pi):
    """Plain PyTorch version: ``B.mul_(pi).addmm_(SC.T, X)``, in place;
    returns B."""
    return B.mul_(float(pi)).addmm_(SC.T, X)


@functools.cache
def _kernel():
    return _build.entry('modl_ema_accumulate_f32',
                        [ctypes.c_void_p] * 3
                        + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_float, ctypes.c_void_p])


def ema_accumulate(B, SC, X, pi):
    """``B <- pi * B + SC^T @ X`` in place; returns B.

    B (k, n), SC (m, k), X (m, n); ``pi`` a host scalar. CPU tensors run
    :func:`ema_accumulate_reference`; CUDA tensors launch the Hopper
    kernel on the current stream (no synchronisation) and raise on
    anything it does not take."""
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
    err = _kernel()(B.data_ptr(), SC.data_ptr(), X.data_ptr(), k, n, m,
                    float(pi), torch.cuda.current_stream(B.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ema_accumulate: kernel launch failed with '
                           f'cudaError {err} at (k={k}, n={n}, m={m})')
    LAUNCHES += 1
    return B
