"""Host ms an epoch in ``DictFact.shuffle`` (the estimator layer): the
harness's span around the call, on the profiler's clock."""


def read(view):
    if not view.shuffles:
        return None
    return sum(e - s for s, e in view.shuffles) / len(view.shuffles) / 1e6
