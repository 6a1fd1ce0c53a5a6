"""The BCD kernel's share of its roofline (``ops/bcd.py`` ->
``csrc/bcd_update.cu``), in %.

The least time of a step's dictionary update is counted from the
configuration's sizes, k atoms over the s = n_features / reduction
columns of a subset, whatever launches carry it (one call, or the block
driver's): 4 k^2 s operations (the residual and the k rank-1 updates)
and 4 (3 k s + k^2 + 3 k) bytes (D, the gradient and C read once, D
written once, the budgets read and written). Divided by the device time
of the kernels ``KERNEL`` names over the traced steps."""
KERNEL = r'\bbcd_kernel\b'


def counts(cfg):
    """(operations, bytes) of one step's dictionary update."""
    k = cfg['estimator']['n_components']
    s = int(cfg['n_features'] / cfg['estimator']['reduction'])
    return 4 * k * k * s, 4 * (3 * k * s + k * k + 3 * k)


def read(view):
    ns = view.kernel_ns(KERNEL)
    if not ns or not view.peak_flops:
        return None
    ops, nbytes = counts(view.config)
    least = max(ops / view.peak_flops, nbytes / view.peak_bytes)
    return 100 * least * view.steps / (ns / 1e9)
