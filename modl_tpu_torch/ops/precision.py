"""Matmul precision policy for the GPU step: full float32, never TF32.

The JAX package runs every contraction of the step and of coding at
``'high'`` precision (3-pass bf16 on the TPU's MXU, ~f32 input quality)
because single-pass bf16 wrecked the masked Gram estimators
(``modl_tpu/ops/precision.py``). On the card the nearest cheaper
alternative to full f32 is TF32, which keeps a 10-bit mantissa — worse
than 3-pass bf16 — so the port's counterpart of 'high' is full f32:
``full_f32()`` turns TF32 off for cuBLAS and cuDNN while the step or a
coding call runs and restores the caller's settings afterwards.

The k x k products that are accumulated across the whole fit (C, and
the maintained Gram under ``G_agg='full'``) are therefore exact f32
like every other contraction; the JAX package has to request
``Precision.HIGHEST`` for them explicitly. CPU and float64 paths are
unaffected by the switches.

The EMA-GEMM kernel (``csrc/ema_gemm.cu``, the deferred-B segment end)
runs on the tensor cores in 3xTF32: each float32 operand is split into a
TF32 ``hi`` and a TF32 ``lo = x - hi`` and three TF32 products
(``hi*lo + lo*hi + hi*hi``) are summed in float32, which keeps ~21 bits
of the inputs, at or above 'high'. That is not single-pass TF32, and the
"never TF32" rule still holds for every cuBLAS call, the plain segment
end's ``addmm_`` included.
"""
import functools
from contextlib import contextmanager

import torch

__all__ = ["full_f32", "precise"]


@contextmanager
def full_f32():
    """Run float32 matrix products and convolutions without TF32."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def precise(fn):
    """Decorator: run ``fn`` under :func:`full_f32`."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)
    return wrapper
