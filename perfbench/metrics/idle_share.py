"""The device's idle share of the traced window, in %: 1 - busy /
window, busy the union of the device's kernels and copies."""


def read(view):
    if not view.device or not view.window_ns:
        return None
    return 100 * (1 - view.busy_ns / view.window_ns)
