"""Faults planted in the program, which the comparison has to catch
(``tests/test_perfbench_checks.py`` on the CPU, ``readings.py`` on the
card). Each is a context manager that patches the port while it is
open; a program captured inside it keeps the fault.

- ``unchanged``: an epoch call that leaves the state as it was;
- ``half_batch``: every step on the first half of its batch, the
  statistics' means taken over that half;
- ``altered``: the dictionary update's answer altered where it is
  made, one atom's new columns negated.

The exchange between chips is not among them: every cell runs on one.
"""
import contextlib

from modl_tpu_torch.decomposition import _program, _step
from modl_tpu_torch.decomposition.dict_fact import DictFact


@contextlib.contextmanager
def patched(*targets):
    """Set ``(owner, name, value)`` for each target; restore after."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in
             targets]
    for owner, name, value in targets:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def unchanged():
    def epoch(self, X_dev, sample_indices, rows=None):
        pass
    return patched((DictFact, '_partial_fit_ingested', epoch))


def half_batch():
    body = _step._step_body

    def half(state, X, sample_indices, subset, order, scalars, cfg, sized,
             deferred=None):
        b = X.shape[0]
        h = b // 2
        scalars = scalars.clone()
        scalars[2] = scalars[2] * (b / h)      # w / b -> w / h
        return body(state, X[:h], sample_indices[:h], subset, order,
                    scalars, cfg, sized, deferred)
    return patched((_step, '_step_body', half), (_program, '_step_body', half))


def altered():
    kernel, plain = _step.bcd_kernel, _step._bcd_plain

    def negate(update):
        def run(*args, **kwargs):
            D, cn = update(*args, **kwargs)
            D = D.clone()
            D[0].neg_()
            return D, cn
        return run
    return patched((_step, 'bcd_kernel', negate(kernel)),
                   (_step, '_bcd_plain', negate(plain)))


FAULTS = {'unchanged': unchanged, 'half_batch': half_batch,
          'altered': altered}
