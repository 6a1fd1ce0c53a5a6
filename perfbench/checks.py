"""The comparison that decides ``correct``: the program's state after
the checked epochs against the plain reference's.

After epoch 1 and after the last checked epoch, for each leaf — C, B
(the surrogate's statistics, which the dictionary update takes as its
gradient) and the dictionary's change since its start, ``D - D0`` (each
side's own D0) — two readings against the reference's leaf R:

    gap  = | ||P|| - ||R|| | / ||R||      the gap of the norms
    diff = ||P - R|| / ||R||              the norm of the difference

``compare`` returns every reading (``gap_e1.B``, ...) and, per epoch
and kind, the worst leaf (``gap_e1``, ``diff_e3``, ...); the cell's
limits file names the numbers that decide ``correct``. Norms are
Frobenius norms taken in float64. ``compare_lockstep`` reads the same
numbers after a fit's first batches, with exact ones and the held-out
error of later epochs, for fits whose epochs cannot be compared leaf by
leaf.
"""
import numpy as np
import torch

LEAVES = ('C', 'B', 'dD')


def _leaves(state, D0):
    D, C, B = state
    return dict(C=C, B=B, dD=D - D0)


def _t(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                           ).to(device, torch.float64)


def compare(program, reference):
    """Readings of ``program`` against ``reference``: each a list
    ``[D0, (D, C, B) after epoch 1, ...]`` (numpy or tensors)."""
    device = (reference[0].device if torch.is_tensor(reference[0])
              else torch.device('cpu'))
    last = len(reference) - 1
    out = {}
    for e in sorted({1, last}):
        P = _leaves([_t(x, device) for x in program[e]],
                    _t(program[0], device))
        R = _leaves([_t(x, device) for x in reference[e]],
                    _t(reference[0], device))
        _read(out, f'e{e}', P, R)
    return out


def _read(out, at, P, R):
    """The gap and diff of each leaf of ``P`` against ``R``, and of the
    worst leaf, into ``out`` (``gap_<at>``, ...)."""
    for leaf in LEAVES:
        norm = float(torch.linalg.norm(R[leaf]))
        out[f'gap_{at}.{leaf}'] = abs(
            float(torch.linalg.norm(P[leaf])) - norm) / norm
        out[f'diff_{at}.{leaf}'] = float(
            torch.linalg.norm(P[leaf] - R[leaf])) / norm
    for kind in ('gap', 'diff'):
        out[f'{kind}_{at}'] = max(out[f'{kind}_{at}.{leaf}']
                                  for leaf in LEAVES)


def compare_lockstep(program, reference, rmse):
    """Readings of a fit whose epochs part by O(1) from the reference's
    through rounding alone (a ``recsys`` cell), from the seed alone. Both
    are dicts (``reference/recsys.py``'s :func:`record`): ``D0``,
    ``lock`` (``{t: (D, C, B)}``: the leaves after the first t batches)
    and ``states`` (one dict an epoch, from 1: the films' visit
    ``counts`` and ``n_iter``, with the rows' ``code`` and ``D`` after
    some epochs).

    - ``start``: ``||D0_P - D0_R|| / ||D0_R||``, the initial dictionary
      drawn from the seed, ``D0_R`` cast to ``D0_P``'s dtype (exact: the
      same float64 draw cast to the state's dtype);
    - ``visits``: over the epochs both ran, the largest gap of the films'
      visit counts plus the gap of ``n_iter`` (exact: every rating once
      an epoch);
    - for each t, ``gap_lock<t>`` and ``diff_lock<t>`` (and by leaf) as
      :func:`compare` reads an epoch, of C, B and D - D0;
    - for each epoch e with codes, ``rmse_e<e>``: ``|rmse(P) - rmse(R)|
      / rmse(R)``, ``rmse(code, D)`` the held-out RMSE of a fit's
      predictions, and the two RMSEs as ``rmse_program_e<e>`` and
      ``rmse_reference_e<e>``."""
    device = (reference['D0'].device if torch.is_tensor(reference['D0'])
              else torch.device('cpu'))
    out = {}
    P0, R0 = _t(program['D0'], device), _t(reference['D0'], device)
    # the reference's draw in the program's dtype, as the program casts it
    D0 = program['D0']
    dtype = D0.dtype if torch.is_tensor(D0) else torch.from_numpy(
        np.asarray(D0)).dtype
    out['start'] = float(torch.linalg.norm(P0 - R0.to(dtype).double())
                         / torch.linalg.norm(R0))
    out['visits'] = max(
        int(np.abs(np.asarray(p['counts'], np.int64)
                   - np.asarray(r['counts'], np.int64)).max())
        + abs(int(p['n_iter']) - int(r['n_iter']))
        for p, r in zip(program['states'], reference['states']))
    for t in sorted(reference['lock']):
        P = _leaves([_t(x, device) for x in program['lock'][t]], P0)
        R = _leaves([_t(x, device) for x in reference['lock'][t]], R0)
        _read(out, f'lock{t}', P, R)
    for e, (p, r) in enumerate(zip(program['states'], reference['states']),
                               1):
        if 'code' in r:
            ours, theirs = rmse(p['code'], p['D']), rmse(r['code'], r['D'])
            out[f'rmse_program_e{e}'] = ours
            out[f'rmse_reference_e{e}'] = theirs
            out[f'rmse_e{e}'] = abs(ours - theirs) / theirs
    return out
