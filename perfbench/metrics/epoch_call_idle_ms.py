"""ms an epoch in which the card sits idle inside the epoch's call (the
harness's span around ``_partial_fit_ingested``): the host's draws,
scalars, staging and issue while no kernel or copy runs (the programs
layer, ``decomposition/_program.py``, and the estimator's code around
it); the mean over the traced epochs."""
import bisect


def read(view):
    busy = view.merged()
    if not busy or not view.epochs:
        return None
    starts = [s for s, _ in busy]
    idle = []
    for s, e in view.epochs:
        covered = 0
        for bs, be in busy[max(bisect.bisect_right(starts, s) - 1, 0):]:
            if bs >= e:
                break
            covered += max(0, min(be, e) - max(bs, s))
        idle.append(e - s - covered)
    return sum(idle) / len(idle) / 1e6
