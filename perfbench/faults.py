"""Faults planted in the program, which the comparison has to catch
(``tests/test_perfbench_checks.py`` on the CPU, ``readings.py`` on the
card), for each driver (``BY_DRIVER``). Each is a context manager that
patches the port while it is open; a program captured inside it keeps
the fault.

- ``unchanged``: an epoch call that leaves the state as it was;
- ``half_batch``: every step on the first half of its batch, the
  statistics' means taken over that half;
- ``altered``: the dictionary update's answer altered where it is
  made, one atom's new columns negated.

The exchange between chips is not among them: every cell runs on one.
"""
import contextlib

from modl_tpu_torch.decomposition import _program, _step, recsys
from modl_tpu_torch.decomposition.dict_fact import DictFact
from modl_tpu_torch.ops import bcd


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


def _negate_first_atom(update):
    def run(*args, **kwargs):
        D, cn = update(*args, **kwargs)
        D = D.clone()
        D[0].neg_()
        return D, cn
    return run


def altered():
    return patched(
        (_step, 'bcd_kernel', _negate_first_atom(_step.bcd_kernel)),
        (_step, '_bcd_plain', _negate_first_atom(_step._bcd_plain)))


def recsys_unchanged():
    def epoch(*args, **kwargs):
        pass
    return patched((recsys, 'recsys_epoch', epoch))


def recsys_half_batch():
    body = recsys._recsys_batch

    def half(state, cfg, idx, val, lens, rows, order, scalars):
        b = idx.shape[0]
        h = b // 2
        scalars = scalars.clone()
        scalars[2] = scalars[2] * (b / h)      # w / b -> w / h
        return body(state, cfg, idx[:h], val[:h], lens[:h], rows[:h], order,
                    scalars)
    return patched((recsys, '_recsys_batch', half))


def recsys_altered():
    return patched(
        (recsys, 'bcd_kernel', _negate_first_atom(recsys.bcd_kernel)),
        (bcd, 'bcd_update_reference',
         _negate_first_atom(bcd.bcd_update_reference)))


FAULTS = {'unchanged': unchanged, 'half_batch': half_batch,
          'altered': altered}
BY_DRIVER = {
    'dict_fact': FAULTS,
    'recsys': {'unchanged': recsys_unchanged,
               'half_batch': recsys_half_batch, 'altered': recsys_altered},
}
