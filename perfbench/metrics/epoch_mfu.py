"""The whole epoch's share of the device's peak, in %: the least time
the traced epochs need, counted by the configuration's driver from its
sizes, data and draws (``work.epoch``: ``drivers/dict_fact.py``'s
``epoch_counts``, ``drivers/recsys.py``'s ``batch_counts``), over the
traced window's wall time."""


def read(view):
    if not view.epochs or not view.window_ns or not view.peak_flops:
        return None
    least = view.least_s(view.work.epoch(len(view.epochs)))
    return 100 * least / (view.window_ns / 1e9)
