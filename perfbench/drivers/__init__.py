"""Estimator drivers: what a configuration's estimator needs from the
harness, one module a driver (``drivers/<driver>.py``), found by the
configuration file's ``driver`` key (``dict_fact`` where it has none).

A driver provides:

- ``make_data(cfg, seed, device)``: the configuration's data from the
  data seed;
- ``prepare(cfg, traffic, data_seed, est_seed, device)``: the estimator
  prepared as its ``fit`` prepares it and driven through the
  ``CHECKED_EPOCHS``; returns ``(loop, program)``, ``loop.epoch()`` one
  epoch of ``fit``'s loop inside an ``EPOCH_SPAN`` and ending in a sync,
  ``program`` what its ``compare`` reads of the checked epochs;
- ``reference(cfg, data_seed, est_seed, device, precision)``: the plain
  reference's record, remade from the seeds alone, in ``precision``
  (its default the driver's; ``'tf32'`` is the control);
- ``compare(program, reference)``: the readings that decide
  ``correct`` (:mod:`perfbench.checks`), by name;
- ``work(cfg, loop)``: the work the per-layer shares count, an object
  with ``steps(n)``, ``bcd(n)`` and ``epoch(n)`` for the window's first
  n epochs, the last two lists of ``(times, operations, bytes)``.
"""
import importlib

import torch

# the epochs set-up runs, which the reference follows
CHECKED_EPOCHS = 3
# the harness's spans around the calls into the estimator
EPOCH_SPAN, SHUFFLE_SPAN = 'perfbench.epoch', 'perfbench.shuffle'


def name(cfg):
    """The configuration's driver name."""
    return cfg.get('driver', 'dict_fact')


def of(cfg):
    """The configuration's driver module."""
    return importlib.import_module(f'perfbench.drivers.{name(cfg)}')


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)

