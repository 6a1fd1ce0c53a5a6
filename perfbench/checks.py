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
Frobenius norms taken in float64.
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
        for leaf in LEAVES:
            norm = float(torch.linalg.norm(R[leaf]))
            out[f'gap_e{e}.{leaf}'] = abs(
                float(torch.linalg.norm(P[leaf])) - norm) / norm
            out[f'diff_e{e}.{leaf}'] = float(
                torch.linalg.norm(P[leaf] - R[leaf])) / norm
        for kind in ('gap', 'diff'):
            out[f'{kind}_e{e}'] = max(out[f'{kind}_e{e}.{leaf}']
                                      for leaf in LEAVES)
    return out
