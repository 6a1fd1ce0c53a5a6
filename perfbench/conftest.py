"""pytest settings of the benchmark's own tests (``perfbench/tests``):
the repo's root on the path, the ``card`` marker, and small
configurations that the CPU runs in seconds."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a cell's configuration cut to a size the CPU runs in a second: k=5,
# 60 rows of 4,000 features, batches of 10; the reduction stays, so the
# fused epoch still defers B over segments of several steps
SMALL = dict(n_samples=60, n_features=4000, planted_rank=5)
SMALL_ESTIMATOR = dict(n_components=5, batch_size=10)
# the recsys configuration's: k=8, 300 users of 120 films, 9,000 ratings
# (20 to 120 a user, the middle one 26, the same laws), batches of
# ceil(1 / density) = 6
RECSYS_SMALL = dict(n_samples=300, n_features=120, n_ratings=9000,
                    users=dict(min=20, median=26, max=120))
RECSYS_SMALL_ESTIMATOR = dict(n_components=8)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs an NVIDIA GPU; skips where there is none '
        '(run: python3 -m pytest perfbench/tests -m card on the card)')


@pytest.fixture
def card():
    """Skip the test where no CUDA device is visible."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.fixture
def bench():
    from perfbench import harness
    return harness.load_benchmark()


@pytest.fixture
def small():
    """``small(bench, config)``: the configuration at the small size."""
    from perfbench import harness

    def make(bench, name):
        cfg = harness.load_config(bench, name)
        cfg.update(SMALL)
        cfg['estimator'].update(SMALL_ESTIMATOR)
        return cfg
    return make
