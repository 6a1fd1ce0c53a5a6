"""The comparison that decides ``correct``, on the CPU at a small size:
the reference against the port in float64, sound runs, the control and
the planted faults."""
import time

import numpy as np
import pytest
import torch

from perfbench import checks, drivers, faults, harness
from perfbench.reference import somf

CELLS = [w['name'] for w in harness.load_benchmark()['workloads']]


def run_small(bench, small, cell, seed=3_000_000_019):
    entry = harness.find(bench['workloads'], cell)
    return harness.run_cell(bench, entry, seed, 0.2, 0, 'cpu',
                            time.perf_counter(),
                            cfg=small(bench, entry['config']))


@pytest.fixture
def kernel_algorithm(monkeypatch):
    """The port's CPU steps with the dictionary update of the card's
    kernel (its plain version: the same projection), in place of the
    CPU's own, which projects exactly."""
    from modl_tpu_torch.decomposition import _step
    from modl_tpu_torch.ops import bcd

    def update(D, grad, C, comp_norm, order, cfg):
        return bcd.bcd_update_reference(D, grad.contiguous(), C, comp_norm,
                                        order=order, comp_pos=cfg.comp_pos,
                                        l1_ratio=cfg.comp_l1_ratio)
    monkeypatch.setattr(_step, '_bcd_plain', update)


@pytest.mark.parametrize('config', ['adhd70', 'hcp1024'])
def test_reference_is_the_port_in_float64(bench, small, config,
                                          kernel_algorithm):
    """The port's fit on the CPU in float64 (the segment-deferred B of
    the fused epoch, the kernel's dictionary update) equals the
    reference's to rounding: the reference recomputes the same draws and
    mathematics."""
    from modl_tpu_torch import DictFact
    cfg = small(bench, config)
    data_seed, est_seed = harness.split_seed(77)
    X = harness.make_data(cfg, data_seed, 'cpu').double()
    k = cfg['estimator']['n_components']
    est = DictFact(**cfg['estimator'], random_state=est_seed, device='cpu')
    est.prepare(n_samples=X.shape[0], X=X[:k].numpy(), dtype=np.float64)
    loop = harness.FitLoop(est, est._ingest_features(X))
    program = [np.array(est.components_, copy=True)]
    for _ in range(harness.CHECKED_EPOCHS):
        loop.epoch()
        program.append(harness.snapshot(est))
    assert est._cfg.windowed
    ref = somf.fit(X, cfg['estimator'], est_seed, harness.CHECKED_EPOCHS)
    numbers = checks.compare(program, ref)
    assert max(v for name, v in numbers.items() if '.' in name) < 1e-10


def test_projection_is_the_ports_where_it_is_not_exact():
    """At HCP-1,024's window width the port's projection (6 Newton steps)
    departs from the exact one on some rows; the reference's follows the
    port's there too."""
    from modl_tpu_torch.ops import bcd
    from modl_tpu_torch.ops.enet import enet_projection
    s = 10780
    count = bcd._l1_count(s)
    g = torch.Generator().manual_seed(0)
    inexact = 0.0
    for _ in range(20):
        v = torch.randn(s, generator=g, dtype=torch.float64)
        r = torch.tensor(0.05 * float(v.abs().sum()), dtype=torch.float64)
        port = bcd._project_row(v, r, 1.0, count)
        ours = torch.from_numpy(somf.project_l1(v.numpy(), float(r), count))
        assert float((ours - port).norm() / port.norm()) < 1e-12
        exact = enet_projection(v, r, 1.0)
        inexact = max(inexact, float((exact - port).norm() / exact.norm()))
    assert inexact > 1e-6


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(bench, small, cell):
    result, compared = run_small(bench, small, cell)
    assert result['correct'], compared


@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
@pytest.mark.parametrize('cell', CELLS)
def test_planted_fault_is_not_correct(bench, small, cell, fault):
    """Each fault of the cell's driver (``faults.BY_DRIVER``)."""
    cfg = harness.load_config(bench, harness.find(bench['workloads'],
                                                  cell)['config'])
    with faults.BY_DRIVER[drivers.name(cfg)][fault]():
        result, compared = run_small(bench, small, cell)
    assert not result['correct'], compared


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(bench, small, cell):
    """The reference in TF32 in the program's place fails the cell's
    limits."""
    entry = harness.find(bench['workloads'], cell)
    cfg = small(bench, entry['config'])
    driver = drivers.of(cfg)
    limits = harness.load_limits(cell)
    for seed in (11, 12, 13):
        data_seed, est_seed = harness.split_seed(seed)
        ref = harness.reference(cfg, data_seed, est_seed, 'cpu')
        control = harness.reference(cfg, data_seed, est_seed, 'cpu', 'tf32')
        numbers = driver.compare(control, ref)
        assert any(numbers[n] > lim for n, lim in limits.items()), numbers


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -1 - 2 ** -10,
                      1 + 2 ** -12], dtype=torch.float32)
    want = [1.0, 1.0, 1 + 2 ** -9, -1 - 2 ** -10, 1.0]
    assert somf.tf32(x).tolist() == want


def test_l1_projection():
    v = np.array([3.0, -1.0, 0.5])
    assert somf.project_l1(v, 2.0, 3).tolist() == pytest.approx(
        [2.0, 0.0, 0.0])
    assert somf.project_l1(v, 3.0, 3).tolist() == pytest.approx(
        [2.5, -0.5, 0.0])
    assert somf.project_l1(v, 5.0, 3) is v
    assert not somf.project_l1(v, 0.0, 3).any()
