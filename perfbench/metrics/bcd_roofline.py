"""The BCD kernel's share of its roofline (``ops/bcd.py`` ->
``csrc/bcd_update.cu``), in %.

The least time of the traced steps' dictionary updates, counted by the
configuration's driver from its sizes, data and draws (``work.bcd``:
``drivers/dict_fact.py``'s ``bcd_counts``, ``drivers/recsys.py``'s
union widths), whatever launches carry them, over the device time of
the kernels ``KERNEL`` names."""
KERNEL = r'\bbcd_kernel\b'


def read(view):
    ns = view.kernel_ns(KERNEL)
    if not ns or not view.peak_flops:
        return None
    least = view.least_s(view.work.bcd(len(view.epochs)))
    return 100 * least / (ns / 1e9)
