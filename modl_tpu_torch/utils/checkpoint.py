"""Checkpoint and resume of the learner state (counterpart of
``modl_tpu/utils/checkpoint.py``).

``save_state`` writes a compressed ``.npz`` under the JAX package's
field names and dtypes (the JAX package also writes orbax checkpoints;
orbax imports JAX, so the port writes ``.npz`` only), plus the port's
generator state, ``gen_state``. A state saved by one package loads in
the other:

- saved and loaded by the port, it resumes bit for bit;
- saved by ``modl_tpu``, it has no ``gen_state``: the port seeds its
  generator from the file's ``key`` (as ``convert.state_from_jax``
  seeds it from an argument) and warns;
- saved by the port, ``modl_tpu.utils.checkpoint.load_state`` reads the
  fields it knows, a valid threefry ``key`` among them, and resumes on
  the JAX package's own trajectory.

``partial_fit`` after ``prepare`` and a load is the warm-start API::

    df.prepare(...); df._state = load_state(path, SomfState)
    df.partial_fit(...)
"""
import pickle
import warnings

import numpy as np

from ..decomposition._step import SomfState, state_from_numpy, state_to_numpy
from ..decomposition.dict_fact import (_default_dtype, _resolve_device,
                                       _torch_dtype)

__all__ = ["save_state", "load_state", "save_estimator", "load_estimator",
           "CheckpointCallback"]


def _npz(path):
    return path if path.endswith('.npz') else path + '.npz'


def save_state(state, path):
    """Save a :class:`SomfState` to ``path`` (``.npz`` appended where
    missing); returns the path written. Fields the run lacks (e.g.
    ``G_avg`` outside 'average') are left out."""
    path = _npz(path)
    np.savez_compressed(path, **{name: v for name, v in
                                 state_to_numpy(state).items()
                                 if v is not None})
    return path


def load_state(path, state_cls=SomfState, device='cuda'):
    """Load a state saved by either package's ``save_state``.

    Float leaves go to ``device`` (raises where it is CUDA and there is
    no card) in the saved dictionary's dtype, through the estimators'
    dtype policy (float64 becomes float32 on CUDA); fields absent from
    the file stay None. ``G_avg`` stays in host RAM: the estimator's next
    ``partial_fit`` moves it to the card unless it runs under
    ``average_offload``."""
    if state_cls is not SomfState:
        raise TypeError(f'load_state builds a SomfState, not {state_cls!r}')
    device = _resolve_device(device)
    with np.load(_npz(path), allow_pickle=False) as data:
        arrays = {name: data[name] for name in data.files}
    if 'gen_state' not in arrays:
        warnings.warn(f'{path} holds no generator state (a modl_tpu '
                      'checkpoint): the generator is seeded from its key')
    dtype = _torch_dtype(_default_dtype(arrays['D'].dtype, device))
    return state_from_numpy(arrays, device, dtype)


class CheckpointCallback:
    """Periodic mid-training checkpointing (preemption recovery).

    Pass as ``DictFact(callback=...)``; every ``every`` invocations it
    saves the learner state. Resume with::

        df.prepare(...); df._state = load_state(path, SomfState)
        df.partial_fit(...)

    Restart reproduces the uninterrupted trajectory exactly
    (``tests/test_torch_checkpoint.py``).
    """

    def __init__(self, path, every=1):
        self.path = path
        self.every = every
        self.n_calls = 0
        self.n_saved = 0

    def __call__(self, *args):
        # callback conventions differ per estimator: DictFact passes
        # itself; ImageDictFact passes itself (holding dict_fact_);
        # fMRIDictFact passes (masker, dict_fact, cpu_time, io_time)
        self.n_calls += 1
        if self.n_calls % self.every:
            return
        for obj in args:
            state = getattr(obj, '_state', None)
            if state is None and hasattr(obj, 'dict_fact_'):
                state = getattr(obj.dict_fact_, '_state', None)
            if state is not None:
                save_state(state, self.path)
                self.n_saved += 1
                return


def save_estimator(estimator, path):
    """Pickle a fitted estimator (its device state as host numpy)."""
    with open(path, 'wb') as f:
        pickle.dump(estimator, f)
    return path


def load_estimator(path):
    """Unpickle an estimator saved by :func:`save_estimator`; its state
    goes to its ``device``."""
    with open(path, 'rb') as f:
        return pickle.load(f)
