"""The whole epoch's share of the device's peak, in %: the least time
an epoch needs, counted from the configuration's sizes, over the traced
window's wall time an epoch.

Per step of b rows, k atoms, s = n_features / reduction subset columns
and n features: 2 b s k (masked Dx) + 2 s k^2 (masked G) + k^3 / 3
(the Cholesky factor) + 2 b k^2 (the code solve) + 2 b k^2 (the C EMA)
+ 2 b k n (the B EMA) + 4 k^2 s (the dictionary update) operations;
per epoch of N rows, 4 (N n + 4 k n) bytes: X read once, B and D read
and written once."""


def counts(cfg):
    """(operations, bytes) of one epoch."""
    est = cfg['estimator']
    k, b = est['n_components'], est['batch_size']
    N, n = cfg['n_samples'], cfg['n_features']
    s = int(n / est['reduction'])
    step = (2 * b * s * k + 2 * s * k * k + k ** 3 / 3 + 2 * b * k * k
            + 2 * b * k * k + 2 * b * k * n + 4 * k * k * s)
    return step * (N // b), 4 * (N * n + 4 * k * n)


def read(view):
    if not view.epochs or not view.window_ns or not view.peak_flops:
        return None
    ops, nbytes = counts(view.config)
    least = max(ops / view.peak_flops, nbytes / view.peak_bytes)
    return 100 * least * len(view.epochs) / (view.window_ns / 1e9)
