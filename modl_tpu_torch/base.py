"""The estimator plumbing the port needs, without scikit-learn.

The GPU machines the port runs on carry PyTorch, numpy and scipy but not
scikit-learn, so the few pieces of it that ``modl_tpu`` uses are written
out here with the same behaviour: parameter introspection
(``get_params``/``set_params``, so ``sklearn.base.clone`` works where
scikit-learn is installed), ``fit_transform``, input validation, batch
slicing and ``Bunch``.
"""
import inspect

import numpy as np

__all__ = ["BaseEstimator", "TransformerMixin", "Bunch", "check_array",
           "check_random_state", "check_is_fitted", "gen_batches"]


class BaseEstimator:
    """Parameters are the ``__init__`` arguments, stored as attributes."""

    @classmethod
    def _get_param_names(cls):
        sig = inspect.signature(cls.__init__)
        return sorted(p.name for p in sig.parameters.values()
                      if p.name != 'self' and p.kind not in (
                          p.VAR_POSITIONAL, p.VAR_KEYWORD))

    def get_params(self, deep=True):
        return {name: getattr(self, name)
                for name in self._get_param_names()}

    def set_params(self, **params):
        valid = set(self._get_param_names())
        for name, value in params.items():
            if name not in valid:
                raise ValueError(f'invalid parameter {name!r} for '
                                 f'{type(self).__name__}')
            setattr(self, name, value)
        return self

    def __repr__(self):
        args = ', '.join(f'{k}={v!r}' for k, v in self.get_params().items())
        return f'{type(self).__name__}({args})'


class Bunch(dict):
    """A dict whose keys are also attributes (``sklearn.utils.Bunch``)."""

    def __init__(self, **kwargs):
        super().__init__(kwargs)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value

    def __dir__(self):
        return list(self.keys())


class TransformerMixin:
    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X)


def check_array(X, dtype=(np.float32, np.float64), order='C'):
    """2-D finite array of one of ``dtype`` (else the first), C order."""
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f'expected a 2-D array, got shape {X.shape}')
    dtypes = [np.dtype(d) for d in (
        dtype if isinstance(dtype, (list, tuple)) else [dtype])]
    if X.dtype not in dtypes:
        X = X.astype(dtypes[0])
    X = np.asarray(X, order=order)
    if not np.isfinite(X).all():
        raise ValueError('input contains NaN or infinity')
    return X


def check_random_state(seed):
    """A ``RandomState`` from None (numpy's global one), an int or itself."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, np.random.RandomState):
        return seed
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    raise ValueError(f'{seed!r} cannot seed a numpy RandomState')


def check_is_fitted(estimator, attribute):
    if not hasattr(estimator, attribute):
        raise ValueError(f'this {type(estimator).__name__} is not fitted '
                         'yet; call fit first')


def gen_batches(n, batch_size):
    """Slices of ``batch_size`` rows covering ``range(n)``."""
    for start in range(0, n, batch_size):
        yield slice(start, min(start + batch_size, n))
