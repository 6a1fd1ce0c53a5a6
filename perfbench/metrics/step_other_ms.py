"""Device ms a step outside the kernels ``bcd_roofline`` and
``ema_gemm_roofline`` time: the step's GEMMs, Cholesky solve, EMAs,
gathers and write-back (``decomposition/_step.py``) and the copies."""
from . import bcd_roofline, ema_gemm_roofline


def read(view):
    if not view.device or not view.steps:
        return None
    kernels = sum(view.kernel_ns(k) or 0 for k in (
        bcd_roofline.KERNEL, ema_gemm_roofline.KERNEL))
    return (view.busy_ns - kernels) / view.steps / 1e6
