"""The per-layer metrics' counts at the configurations' sizes, worked
out by hand, and their readers on a made-up traced window."""
import math
from types import SimpleNamespace

import pytest

from perfbench import drivers, harness
from perfbench.drivers import dict_fact
from perfbench.metrics import (bcd_roofline, ema_gemm_roofline,
                               epoch_call_idle_ms, epoch_mfu, idle_share,
                               shuffle_ms, step_other_ms)

PEAKS = dict(flops=495e12, bytes_per_s=3.35e12)


@pytest.fixture
def cfgs(bench):
    return {name: harness.load_config(bench, name)
            for name in ('adhd70', 'hcp1024')}


def test_bcd_counts(cfgs):
    # k = 70, s = 60,000 / 12 = 5,000
    assert dict_fact.bcd_counts(cfgs['adhd70']) == (
        98_000_000, 4 * (1_050_000 + 4900 + 210))
    # k = 1,024, s = 200,000 / 20 = 10,000
    assert dict_fact.bcd_counts(cfgs['hcp1024']) == (
        41_943_040_000, 4 * (30_720_000 + 1_048_576 + 3072))


def test_ema_gemm_counts(cfgs):
    assert ema_gemm_roofline.counts(cfgs['adhd70']) == (
        16_800_000_000, 4 * (120_000_000 + 140_000 + 8_400_000))
    assert ema_gemm_roofline.counts(cfgs['hcp1024']) == (
        491_520_000_000, 4 * (240_000_000 + 1_228_800 + 409_600_000))


def test_epoch_counts(cfgs):
    # a step: 2bsk + 2sk^2 + k^3/3 + 2bk^2 + 2bk^2 + 2bkn + 4k^2 s
    adhd = (70_000_000 + 49_000_000 + 343_000 / 3 + 980_000 + 980_000
            + 840_000_000 + 98_000_000)
    ops, nbytes = dict_fact.epoch_counts(cfgs['adhd70'])
    assert ops == pytest.approx(20 * adhd, rel=1e-12)
    assert nbytes == 4 * (120_000_000 + 16_800_000)
    hcp = (4_096_000_000 + 20_971_520_000 + 1_073_741_824 / 3
           + 419_430_400 + 419_430_400 + 81_920_000_000 + 41_943_040_000)
    ops, nbytes = dict_fact.epoch_counts(cfgs['hcp1024'])
    assert ops == pytest.approx(6 * hcp, rel=1e-12)
    assert nbytes == 4 * (240_000_000 + 819_200_000)


@pytest.mark.parametrize('config, steps, bcd, epoch', [
    ('adhd70', 20, (98_000_000, 4_220_440),
     (20 * 1_059_074_333.3333334, 547_200_000)),
    ('hcp1024', 6, (41_943_040_000, 127_086_592),
     (6 * 150_127_334_741.33334, 4_236_800_000)),
])
def test_shares_take_the_drivers_counts(cfgs, config, steps, bcd, epoch):
    """``bcd_roofline`` and ``epoch_mfu`` read the ``dict_fact`` driver's
    work, which holds the counts these metrics used before the drivers:
    over 3 traced epochs, 3 epochs' steps of one step's update and 3 of
    one epoch's."""
    cfg = cfgs[config]
    assert drivers.name(cfg) == 'dict_fact'
    work = drivers.of(cfg).work(cfg, None)
    assert work.steps(3) == 3 * steps
    assert work.bcd(3) == [(3 * steps,) + bcd]
    ((times, ops, nbytes),) = work.epoch(3)
    assert times == 3 and nbytes == epoch[1]
    assert ops == pytest.approx(epoch[0], rel=1e-12)


def view(cfg, device, epochs, shuffles, peaks=PEAKS):
    """A made-up traced window, with what ``TraceView`` gives readers."""
    v = SimpleNamespace(config=cfg, device=sorted(device), epochs=epochs,
                        shuffles=shuffles, peak_flops=peaks['flops'],
                        peak_bytes=peaks['bytes_per_s'],
                        work=dict_fact.Work(cfg))
    v.steps = v.work.steps(len(epochs))
    v.window = (epochs[0][0], shuffles[-1][1])
    v.window_ns = v.window[1] - v.window[0]
    v.busy_ns = sum(e - s for s, e, _ in device)
    v.kernel_ns = lambda p: harness.TraceView.kernel_ns(v, p)
    v.merged = lambda: harness.TraceView.merged(v)
    v.least_s = lambda counts: harness.TraceView.least_s(v, counts)
    return v


def test_readers_on_a_made_up_window(cfgs):
    cfg = cfgs['adhd70']        # 20 steps an epoch
    ms = 1_000_000
    # two epochs of 30 ms, each: 1 ms before its first kernel, 20 BCD
    # kernels of 0.75 ms, one EMA-GEMM of 1 ms and 5 ms of other work
    device = []
    for t0 in (0, 31 * ms):
        # the row order's upload opens the epoch; a kernel follows 1 ms in
        device.append((t0 + 100_000, t0 + 200_000, 'Memcpy HtoD (Pageable)'))
        at = t0 + ms
        for _ in range(20):
            device.append((at, at + 750_000, 'void bcd_kernel<1, true>(P)'))
            at += 750_000
        device.append((at, at + ms, 'void ema_gemm_tf32x3<72, false>(f)'))
        at += ms
        device.append((at, at + 5 * ms, 'sm80_xmma_gemm'))
    v = view(cfg, device, epochs=[(0, 30 * ms), (31 * ms, 61 * ms)],
             shuffles=[(30 * ms, 31 * ms), (61 * ms, 62 * ms)])
    assert shuffle_ms.read(v) == pytest.approx(1.0)
    # each 30 ms call holds 0.1 ms of copy and 21 ms of kernels
    assert epoch_call_idle_ms.read(v) == pytest.approx(8.9)
    assert step_other_ms.read(v) == pytest.approx(5.1 / 20)
    assert idle_share.read(v) == pytest.approx(100 * (1 - 42.2 / 62))
    ops, nbytes = dict_fact.bcd_counts(cfg)
    least = max(ops / 495e12, nbytes / 3.35e12)
    assert bcd_roofline.read(v) == pytest.approx(100 * least / 0.75e-3)
    ops, nbytes = ema_gemm_roofline.counts(cfg)
    least = max(ops / 495e12, nbytes / 3.35e12)
    assert ema_gemm_roofline.read(v) == pytest.approx(100 * least / 1e-3)
    ops, nbytes = dict_fact.epoch_counts(cfg)
    least = max(ops / 495e12, nbytes / 3.35e12)
    assert epoch_mfu.read(v) == pytest.approx(100 * least / 31e-3)


def test_readers_find_nothing_where_nothing_ran(cfgs):
    ms = 1_000_000
    v = view(cfgs['hcp1024'], [(ms, 2 * ms, 'Memcpy HtoD')],
             epochs=[(0, 3 * ms)], shuffles=[(3 * ms, 4 * ms)])
    assert bcd_roofline.read(v) is None
    assert ema_gemm_roofline.read(v) is None
    v = view(cfgs['hcp1024'], [], epochs=[(0, 3 * ms)],
             shuffles=[(3 * ms, 4 * ms)])
    for reader in (epoch_call_idle_ms, step_other_ms, idle_share):
        assert reader.read(v) is None


def test_shares_stay_below_the_peak_at_the_least_time(cfgs):
    """A kernel that took exactly the least time reads 100%."""
    cfg = cfgs['hcp1024']
    ops, nbytes = dict_fact.bcd_counts(cfg)
    least_ns = math.ceil(max(ops / 495e12, nbytes / 3.35e12) * 1e9)
    v = view(cfg, [(0, least_ns * 6, 'bcd_kernel')],
             epochs=[(0, least_ns * 6)], shuffles=[(0, least_ns * 6)])
    assert 99.99 <= bcd_roofline.read(v) <= 100
