"""The EMA-GEMM kernel's share of its roofline (``ops/ema_gemm.py`` ->
``csrc/ema_gemm.cu``: the deferred-B segment end ``B <- pi B + SC^T X``
of the fused epoch), in %.

The least time an epoch's segment ends need is counted from the
configuration's sizes, whatever segments the program chose: 2 k N n
operations (every row's codes times its data, N rows an epoch, n
features) and 4 (N n + N k + 2 k n) bytes (X and the scaled codes read
once, B read and written once). Divided by the device time of the
kernels ``KERNEL`` names (the split of SC and the product) over the
traced epochs."""
KERNEL = r'\bema_split_sc\b|\bema_gemm_tf32x3\b'


def counts(cfg):
    """(operations, bytes) of one epoch's segment ends."""
    k = cfg['estimator']['n_components']
    N, n = cfg['n_samples'], cfg['n_features']
    return 2 * k * N * n, 4 * (N * n + N * k + 2 * k * n)


def read(view):
    ns = view.kernel_ns(KERNEL)
    if not ns or not view.peak_flops:
        return None
    ops, nbytes = counts(view.config)
    least = max(ops / view.peak_flops, nbytes / view.peak_bytes)
    return 100 * least * len(view.epochs) / (ns / 1e9)
