"""Random feature-subset draws on an explicit host ``torch.Generator``.

Counterpart of the traced sampler of ``modl_tpu/ops/sampler.py``. Draws
are made on the host (a CPU generator) and handed to the step as Python
ints (window starts, Binomial sizes) or small CPU index tensors, so the
step never reads a value back from the device. The two generators give
different numbers from one seed, so the port's draws reproduce the
JAX package's distributions, not its bits:

- windowed mode (``draw_window``/``draw_window_sized``): features live
  in one fixed random order for the fit and a subset is the circular
  window ``[start, start + width)``; ``start ~ Uniform[0, n)`` with
  replacement, else the cursor, advancing by the drawn size;
- gather mode (``draw_subset``/``draw_subset_sized``): uniform-offset
  wraparound windows of a box re-shuffled once per ``n // len_subset``
  draws (replacement), or the cycling partition with the
  tail-preserving reshuffle (without replacement).

With ``rand_size`` the drawn size is ``m ~ Binomial(n, len_subset/n)``
clamped to ``[1, len_max]``; the storage width stays ``len_max`` and the
step zero-masks columns ``>= m``.
"""
import math

import numpy as np
import torch

__all__ = ["binomial_len_max", "init_sampler_state", "draw_window",
           "draw_window_sized", "draw_subset", "draw_subset_sized",
           "Sampler"]


def binomial_len_max(n_features, len_subset):
    """Static storage width for Binomial(n, len_subset/n) draws:
    mean + 8 std, clamped to the feature count."""
    p = len_subset / max(n_features, 1)
    std = math.sqrt(max(n_features * p * (1.0 - p), 0.0))
    return int(min(n_features, math.ceil(len_subset + 8.0 * std)))


def init_sampler_state(n_features, gen):
    """Initial ``(box, cursor)``: a shuffled arange (CPU int64) and 0."""
    return torch.randperm(n_features, generator=gen), 0


def _randint(gen, high):
    return int(torch.randint(high, (1,), generator=gen))


def _binomial_size(gen, n, len_subset, len_max):
    p = torch.tensor([len_subset / n], dtype=torch.float64)
    m = int(torch.binomial(torch.tensor([float(n)], dtype=torch.float64),
                           p, generator=gen))
    return min(max(m, 1), len_max)


def draw_window(cursor, gen, len_subset, n_features, replacement):
    """Window-mode draw; returns ``(start, cursor')``."""
    if replacement:
        return _randint(gen, n_features), cursor
    start = cursor % n_features
    return start, (cursor + len_subset) % n_features


def draw_window_sized(cursor, gen, len_subset, len_max, n_features,
                      replacement):
    """Window-mode draw with a Binomial size; returns
    ``(start, m, cursor')``. The cycling cursor advances by ``m``."""
    m = _binomial_size(gen, n_features, len_subset, len_max)
    if replacement:
        return _randint(gen, n_features), m, cursor
    start = cursor % n_features
    return start, m, (cursor + m) % n_features


def _reshuffle_keep_tail(box, cursor, gen):
    """Box for a new cycle: the not-yet-served tail first (in order),
    the served head re-shuffled behind it."""
    served = box[:cursor][torch.randperm(cursor, generator=gen)]
    return torch.cat([box[cursor:], served])


def _draw_box(box, cursor, gen, len_subset, width, m, replacement):
    n = box.shape[0]
    if replacement:
        if cursor >= max(n // len_subset, 1):
            box = box[torch.randperm(n, generator=gen)]
            cursor = 0
        offset = _randint(gen, n)
        idx = (offset + torch.arange(width)) % n
        return box[idx], box, cursor + 1
    if n - cursor < m:
        box = _reshuffle_keep_tail(box, cursor, gen)
        cursor = 0
    idx = (cursor + torch.arange(width)) % n
    return box[idx], box, cursor + m


def draw_subset(box, cursor, gen, len_subset, replacement):
    """Gather-mode draw of ``len_subset`` feature indices; returns
    ``(subset, box', cursor')``."""
    return _draw_box(box, cursor, gen, len_subset, len_subset, len_subset,
                     replacement)


def draw_subset_sized(box, cursor, gen, len_subset, len_max, replacement):
    """Gather-mode draw with a Binomial size: ``subset`` has width
    ``len_max`` and only its first ``m`` entries are live. Returns
    ``(subset, m, box', cursor')``."""
    m = _binomial_size(gen, box.shape[0], len_subset, len_max)
    subset, box, cursor = _draw_box(box, cursor, gen, len_subset, len_max,
                                    m, replacement)
    return subset, m, box, cursor


class Sampler:
    """Host-side eager sampler, API-compatible with the reference class.

    Parameters mirror ``sampler.pyx:10-39``: ``range_`` (number of
    features), ``rand_size`` (Binomial subset sizes), ``replacement``
    (reshuffle per call vs cycling partition), ``random_seed``.

    The cycling state is expressed as (feature order, consumed-prefix
    cursor), as in the gather-mode draws above, rather than the
    reference's in-place box swaps; the emitted subset
    sequences satisfy the identical contracts (each draw is disjoint
    from the cycle's previous draws; a partial tail at a cycle boundary
    is served first, in order, before the refilled pool).
    """

    def __init__(self, range_, rand_size=True, replacement=True,
                 random_seed=None):
        self.range = int(range_)
        self.rand_size = bool(rand_size)
        self.replacement = bool(replacement)
        self.random_state = np.random.RandomState(random_seed)
        self.box = self.random_state.permutation(self.range)
        self.cursor = 0  # features before the cursor were already served

    def _draw_size(self, reduction):
        if self.rand_size:
            return int(self.random_state.binomial(self.range,
                                                  1.0 / reduction))
        return int(self.range / reduction)

    def yield_subset(self, reduction):
        n = self.range
        m = self._draw_size(reduction)
        if self.replacement or m >= n:
            # i.i.d. draws: a fresh order every call, take its prefix
            self.box = self.random_state.permutation(self.box)
            self.cursor = min(m, n)
            return self.box[:self.cursor].copy()
        left = n - self.cursor
        if left == 0:
            # cycle exhausted exactly: refill with a full reshuffle
            self.box = self.random_state.permutation(self.box)
            self.cursor = 0
        elif left < m:
            # cycle boundary mid-draw: the not-yet-served tail moves to
            # the front (order preserved) and the served part is
            # reshuffled behind it (sampler.pyx:59-64 semantics)
            served = self.random_state.permutation(self.box[:self.cursor])
            self.box = np.concatenate([self.box[self.cursor:], served])
            self.cursor = 0
        out = self.box[self.cursor:self.cursor + m].copy()
        self.cursor += m
        return out
