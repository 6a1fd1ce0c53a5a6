"""Host-side ``RandomState`` / ``Sampler``-companion RNG utility.

Portability shim for reference scripts written against
``modl.utils.randomkit.RandomState``
(reference modl/utils/randomkit/random_fast.pyx:33-150): the same public
contract — ``seed`` / ``randint`` / ``permutation`` / Fisher–Yates
``shuffle`` (including row-shuffle of 2-D arrays and externally supplied
swap sequences) / ``shuffle_with_trace`` (co-shuffle several arrays with
ONE shared permutation and return it) / ``binomial`` — with
pickling-by-reseed semantics (``__reduce__`` restarts the stream from
the construction seed, reference random_fast.pyx:149-150).

The bit stream itself is numpy PCG64, not randomkit's MT19937: golden
MT19937 sequences are not reproducible without vendoring the C library,
and nothing in this framework depends on them (SURVEY.md §2.1 N1). All
*property* contracts (Fisher–Yates trace identity, partition behavior,
distribution moments) are preserved and tested in
``tests/test_torch_utils.py``.

The learner's own draws live elsewhere: subsets and atom orders come
from a host ``torch.Generator`` in the learner state
(``ops/sampler.py``). This class is for record permutations,
co-shuffles and script-level RNG.
"""
import numpy as np

__all__ = ["RandomState"]


class RandomState:
    """Picklable host RNG with Fisher–Yates co-shuffle support.

    Parameters
    ----------
    seed : int or None. ``None`` seeds from OS entropy; an unpicklable
        choice if reproducibility across pickle round-trips matters
        (the pickle restarts from the *initial* seed, like the
        reference, reference random_fast.pyx:56-57).
    """

    def __init__(self, seed=None):
        self.initial_seed = None if seed is None else int(seed)
        self.seed(seed)

    def __reduce__(self):
        # Pickle-by-reseed: the clone restarts the stream from the
        # construction seed (reference random_fast.pyx:149-150).
        return (RandomState, (self.initial_seed,))

    def seed(self, seed=None):
        if seed is not None and not isinstance(seed, (int, np.integer)):
            raise ValueError("Wrong seed")
        self._gen = np.random.default_rng(
            None if seed is None else int(seed))

    def randint(self, high):
        """Uniform integer on the inclusive range [0, high].

        Matches ``rk_interval(high, state)`` (reference
        random_fast.pyx:76-77): the upper bound is *included*.
        """
        return int(self._gen.integers(0, int(high) + 1))

    def binomial(self, n, p):
        """One Binomial(n, p) draw (reference random_fast.pyx:146-147)."""
        return int(self._gen.binomial(int(n), float(p)))

    def _draw_swaps(self, n):
        """The Fisher–Yates swap targets: swap[i] ~ U[0, i] for i=n-1..1."""
        swap = np.zeros(n, dtype=np.int64)
        for i in range(n - 1, 0, -1):
            swap[i] = self._gen.integers(0, i + 1)
        return swap

    @staticmethod
    def _apply_swaps(x, swap):
        """Apply a Fisher–Yates swap sequence to ``x`` in place.

        Works on python lists and on numpy arrays of any rank; 2-D+
        arrays are shuffled along axis 0 (row shuffle, reference
        random_fast.pyx:113-125). Numpy row swaps need no explicit
        `.copy()` dance: tuple assignment of row copies is done
        explicitly to match the reference's aliasing-safe behavior.
        """
        if isinstance(x, np.ndarray) and x.ndim >= 2:
            for i in range(len(x) - 1, 0, -1):
                j = swap[i]
                xi = x[i].copy()
                x[i] = x[j]
                x[j] = xi
        else:
            for i in range(len(x) - 1, 0, -1):
                j = swap[i]
                x[i], x[j] = x[j], x[i]

    def shuffle(self, x, swap=None):
        """Fisher–Yates shuffle of ``x`` in place.

        ``swap`` replays an externally drawn swap sequence (the
        mechanism ``shuffle_with_trace`` uses to co-shuffle several
        arrays identically, reference random_fast.pyx:87-125).
        """
        n = len(x)
        if swap is None:
            swap = self._draw_swaps(n)
        self._apply_swaps(x, swap)

    def permutation(self, size):
        """A uniformly random permutation of ``arange(size)``.

        Same draw sequence as ``shuffle`` on an arange (reference
        random_fast.pyx:79-85).
        """
        res = np.arange(int(size), dtype=np.int64)
        self.shuffle(res)
        return res

    def shuffle_with_trace(self, arrays):
        """Shuffle every array in ``arrays`` with ONE shared permutation.

        Returns the trace ``t`` such that, for each array,
        ``shuffled[i] == original[t[i]]`` — the contract
        ``DictFact.shuffle`` relies on to co-permute ``code_`` /
        ``G_average_`` / ``Dx_average_`` with the sample order
        (reference random_fast.pyx:127-144, dict_fact.py:359-379).
        """
        n = len(arrays[0])
        for x in arrays:
            if len(x) != n:
                raise ValueError(
                    "shuffle_with_trace arrays must share their leading "
                    "dimension (got %d and %d)" % (n, len(x)))
        trace = np.arange(n, dtype=np.int64)
        swap = self._draw_swaps(n)
        self._apply_swaps(trace, swap)
        for x in arrays:
            self._apply_swaps(x, swap)
        return trace
