"""What the readers of the program's spans share: the ``modl.*`` ranges
that ``modl_tpu_torch.utils.profiling.span`` records on the profiler's
clock, found by name among a traced window's host events, as host ms an
epoch inside them or as ms an epoch in which the card sat idle inside
them. A reader returns None where the window holds none of its spans
(a program without them), and an idle reader where the card ran
nothing."""
import bisect


def spans(view, name):
    """The ``(start, end)`` ns of the host events named ``name``."""
    return [(s, e) for s, e, n in view.host if n == name]


def host_ms(view, name):
    """Host ms an epoch inside the spans named ``name``: their summed
    length over the traced epochs."""
    found = spans(view, name)
    if not found or not view.epochs:
        return None
    return sum(e - s for s, e in found) / len(view.epochs) / 1e6


def idle_ms(view, name):
    """ms an epoch in which the card ran no kernel or copy inside the
    spans named ``name`` (the arithmetic of ``epoch_call_idle_ms`` over
    these spans): each span's length less the part of it that the
    device's merged busy intervals cover, summed over the traced
    epochs."""
    busy = view.merged()
    found = spans(view, name)
    if not busy or not found or not view.epochs:
        return None
    starts = [s for s, _ in busy]
    idle = 0
    for s, e in found:
        covered = 0
        for bs, be in busy[max(bisect.bisect_right(starts, s) - 1, 0):]:
            if bs >= e:
                break
            covered += max(0, min(be, e) - max(bs, s))
        idle += e - s - covered
    return idle / len(view.epochs) / 1e6
