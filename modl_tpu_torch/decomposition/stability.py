"""Dictionary stability metrics (counterpart of
``modl_tpu/decomposition/stability.py``).

Amari discrepancy between dictionaries: the normalised
cross-correlation is one torch matmul, on the device of the inputs
(numpy inputs run on the CPU).
"""
from itertools import combinations
from typing import List

import numpy as np
import torch

__all__ = ["amari_discrepency", "mean_amari_discrepency"]


def amari_discrepency(D1, D2):
    """0.5 (mean(1 - max_col C) + mean(1 - max_row C)) for the normalised
    cross-correlation C of the rows of ``D1`` and ``D2``."""
    D1 = torch.as_tensor(D1)
    D2 = torch.as_tensor(D2)
    C = (D1 @ D2.T
         / torch.sqrt(torch.sum(D1 ** 2, dim=1))[:, None]
         / torch.sqrt(torch.sum(D2 ** 2, dim=1))[None, :])
    return float(.5 * (torch.mean(1 - C.max(dim=0).values)
                       + torch.mean(1 - C.max(dim=1).values)))


def mean_amari_discrepency(dictionaries: List[np.ndarray], n_jobs=1):
    """Mean and standard deviation of the pairwise discrepancies
    (``n_jobs`` is accepted for API parity and unused)."""
    discrepencies = [amari_discrepency(D1, D2)
                     for D1, D2 in combinations(dictionaries, 2)]
    return (float(np.mean(discrepencies)), float(np.std(discrepencies)))
