"""A frozen copy of the port's windowed sampler draws
(``modl_tpu_torch/ops/sampler.py``: ``binomial_len_max``,
``init_sampler_state``, ``draw_window_sized``), so that the reference
makes the same draws from the same generator without importing the
port. A later change to the port's sampler shows as a failed
comparison, not as a reference that follows it."""
import math

import torch


def binomial_len_max(n_features, len_subset):
    """Storage width of Binomial(n, len_subset / n) subset sizes: the mean
    plus 8 standard deviations, at most n."""
    p = len_subset / max(n_features, 1)
    std = math.sqrt(max(n_features * p * (1.0 - p), 0.0))
    return int(min(n_features, math.ceil(len_subset + 8.0 * std)))


def feature_order(n_features, gen):
    """The fixed random feature order of a windowed fit."""
    return torch.randperm(n_features, generator=gen)


def draw_window_sized(gen, n_features, len_subset, len_max):
    """One draw with replacement: ``(start, m)``, a window start in
    ``[0, n)`` and its size ``m ~ Binomial(n, len_subset / n)`` clamped
    to ``[1, len_max]``, drawn in the port's order (size, then start)."""
    p = torch.tensor([len_subset / n_features], dtype=torch.float64)
    m = int(torch.binomial(torch.tensor([float(n_features)],
                                        dtype=torch.float64), p,
                           generator=gen))
    m = min(max(m, 1), len_max)
    start = int(torch.randint(n_features, (1,), generator=gen))
    return start, m


def atom_order(k, gen):
    """The order in which a step's dictionary update visits the atoms."""
    return torch.randperm(k, generator=gen)
