"""Step-weight schedules for the SOMF/OMF surrogate updates (host side).

Counterpart of ``modl_tpu/ops/weights.py``. The batch weight depends only
on the number of samples seen and the batch size, both host integers, so
it is computed with numpy in the state dtype and handed to the step as a
Python float: the step never waits on the device for it.
"""
import numpy as np
import torch

__all__ = ["batch_weight", "sample_weight"]


def batch_weight(count, batch_size, learning_rate, offset=0.0,
                 dtype=np.float32):
    """``w = 1 - prod_{i=count+1-b}^{count} (1 - ((1+offset)/(offset+i))^lr)``.

    ``count`` is the post-increment sample counter (host int). Evaluated
    in ``dtype`` like the JAX version; returns a numpy scalar of it.
    """
    dtype = np.dtype(dtype)
    i = np.arange(1 - batch_size, 1, dtype=dtype) + dtype.type(count)
    terms = dtype.type(1.0) - (
        dtype.type(1.0 + offset) / (dtype.type(offset) + i)
    ) ** dtype.type(learning_rate)
    return dtype.type(1.0) - np.prod(terms, dtype=dtype)


def sample_weight(sample_n_iter, sample_learning_rate, dtype=torch.float32):
    """Per-sample EMA weight ``t^-sample_learning_rate`` (tensor in, out)."""
    return sample_n_iter.to(dtype) ** (-sample_learning_rate)
