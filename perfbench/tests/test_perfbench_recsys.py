"""The ``recsys`` driver and its reference on the CPU at a small skewed
size (``conftest.RECSYS_SMALL``: 300 users x 120 films, k=8): the
generator's statistics, the reference against the port in float64, the
driver's ``prepare``, its counts, the numbers that decide ``correct``
and the dispatch of configurations to drivers. The configuration
``configs/recsys_ml10m.json`` is read from its file: its cell is not in
``BENCHMARK.json`` (``PERF.md``)."""
import time

import numpy as np
import pytest

from perfbench import drivers, faults, harness
from perfbench.conftest import RECSYS_SMALL, RECSYS_SMALL_ESTIMATOR
from perfbench.drivers import recsys
from perfbench.reference import recsys as plain

SEED = 2 ** 31 + 4099
EPOCH = dict(verbose=0, n_epochs=1)
CELL = dict(name='recsys_ml10m-epoch', config='recsys_ml10m',
            traffic='epoch', chips=1)


def full_config():
    return harness.load_json(harness.HERE / 'configs' / 'recsys_ml10m.json')


@pytest.fixture
def cfg():
    cfg = full_config()
    cfg.update(RECSYS_SMALL)
    cfg['estimator'].update(RECSYS_SMALL_ESTIMATOR)
    return cfg


def test_configurations_find_their_drivers(bench):
    """A configuration without ``driver`` runs ``dict_fact``."""
    for name in ('adhd70', 'hcp1024'):
        cfg = harness.load_config(bench, name)
        assert 'driver' not in cfg
        assert drivers.of(cfg) is drivers.dict_fact
    assert drivers.of(full_config()) is recsys


def test_user_counts_at_the_configuration_s_size():
    """The counts' law at ML-10M's size: 10,000,054 ratings, at least 20
    a user, the middle user 69 and the heaviest 7,359; 7,500,040 of them
    for training."""
    counts, train, sigma = recsys.user_counts(full_config())
    assert counts.sum() == 10_000_054 and train.sum() == 7_500_040
    assert counts.min() == 20 and abs(np.median(counts) - 69) <= 1
    assert abs(int(counts.max()) - 7_359) <= 1
    assert np.all(np.diff(counts) >= 0) and np.all(train <= counts)
    assert np.abs(train - 0.75 * counts).max() < 1
    assert 0.9 < sigma < 1.0


@pytest.mark.parametrize('seed', [SEED, 7])
def test_generator_statistics(cfg, seed):
    """Exactly the ratings asked for, distinct, at least 20 a user, split
    into training and held-out ratings, half stars in [0.5, 5]; the same
    counts for every seed."""
    data = recsys.make_data(cfg, seed, 'cpu')
    X, test = data.X, data.test
    assert X.shape == test.shape == (300, 120)
    assert data.stats['distinct'] == 9000
    assert X.nnz == data.stats['train'] == int(0.75 * 9000)
    assert test.nnz == data.stats['held_out'] == 9000 - X.nnz
    lens = np.diff(X.indptr)
    counts, train, _ = recsys.user_counts(cfg)
    assert sorted(lens) == sorted(train) and min(train) >= 15
    assert sorted(lens + np.diff(test.indptr)) == sorted(counts)
    assert counts.min() >= 20 and data.stats['longest_user'] == 120
    for r in range(X.shape[0]):
        cols = np.concatenate([X.indices[X.indptr[r]:X.indptr[r + 1]],
                               test.indices[test.indptr[r]:test.indptr[r + 1]]])
        assert len(np.unique(cols)) == len(cols)
    for part in (X, test):
        assert np.all(part.data * 2 == np.round(part.data * 2))
        assert part.data.min() >= 0.5 and part.data.max() <= 5.0
    again = recsys.make_data(cfg, seed, 'cpu')
    assert (again.X != X).nnz == 0 and (again.test != test).nnz == 0


def test_reference_is_the_port_in_float64(cfg):
    """The port's ``RecsysDictFact(device='cpu', dtype=np.float64)``,
    driven by ``prepare`` through three epochs, equals the reference's D,
    C and B to 1e-10 after them and after the lock-step batches, and the
    held-out RMSE; the start and the visits exactly."""
    data_seed, est_seed = harness.split_seed(SEED)
    loop, program = recsys.prepare(cfg, EPOCH, data_seed, est_seed, 'cpu',
                                   dtype=np.float64)
    assert loop.resident and loop.batch_size == 6
    X = recsys.make_data(cfg, data_seed, 'cpu').X
    whole = plain.fit(X.indptr, X.indices, X.data, X.shape,
                      cfg['estimator'], est_seed, drivers.CHECKED_EPOCHS,
                      'float64')
    st = loop.state
    for ours, theirs in zip((st.D, st.C, st.B), whole[-1]):
        assert float((ours - theirs).norm() / theirs.norm()) < 1e-10
    numbers = recsys.compare(program, recsys.reference(
        cfg, data_seed, est_seed, 'cpu'))
    assert {'start', 'visits', 'rmse_e1', 'rmse_e2'} <= set(numbers)
    assert numbers['start'] == 0 and numbers['visits'] == 0
    assert max(v for name, v in numbers.items()
               if '.' in name or name.startswith('rmse_e')) < 1e-10


def test_lockstep_numbers_catch_what_they_should(cfg):
    """From the seed: a sound float32 run reads far under the TF32
    control after the first batches; a wrong initial dictionary fails
    ``start``, a lost visit ``visits``, a changed C the lock-step
    numbers, scaled codes the held-out RMSE."""
    data_seed, est_seed = harness.split_seed(SEED)
    _, program = recsys.prepare(cfg, EPOCH, data_seed, est_seed, 'cpu')
    ref = recsys.reference(cfg, data_seed, est_seed, 'cpu')
    sound = recsys.compare(program, ref)
    assert sound['start'] == 0 and sound['visits'] == 0
    control = recsys.compare(recsys.reference(
        cfg, data_seed, est_seed, 'cpu', 'tf32'), ref)
    for t in recsys.LOCKS:
        assert control[f'diff_lock{t}'] > 30 * sound[f'diff_lock{t}']
    assert recsys.compare(dict(program, D0=-program['D0']), ref)[
        'start'] > 1
    states = [dict(s) for s in program['states']]
    states[0]['counts'] = states[0]['counts'] - (np.arange(120) == 5)
    assert recsys.compare(dict(program, states=states), ref)['visits'] == 1
    t = recsys.LOCKS[0]
    D, C, B = program['lock'][t]
    lock = {**program['lock'], t: (D, 1.01 * C, B)}
    assert recsys.compare(dict(program, lock=lock), ref)[
        f'gap_lock{t}'] > 5e-3
    e = recsys.KEPT[-1]
    states = [dict(s) for s in program['states']]
    states[e - 1]['code'] = 1.2 * states[e - 1]['code']
    assert recsys.compare(dict(program, states=states), ref)[
        f'rmse_e{e}'] > 100 * sound[f'rmse_e{e}']


def test_prepare_runs_fit_s_loop(cfg):
    """``prepare`` hands the window the estimator as ``fit`` leaves it
    after the checked epochs: the same n_iter, one EPOCH_SPAN call an
    epoch, the lock-step leaves copied at the end of a window of 32
    batches; a window epoch moves the state on."""
    data_seed, est_seed = harness.split_seed(SEED)
    loop, program = recsys.prepare(cfg, EPOCH, data_seed, est_seed, 'cpu')
    states = program['states']
    assert len(states) == drivers.CHECKED_EPOCHS
    assert [s['n_iter'] for s in states] == [300, 600, 900]
    assert [('code' in s) for s in states] == [
        e in recsys.KEPT for e in range(1, drivers.CHECKED_EPOCHS + 1)]
    assert loop.est.n_iter_ == 900
    D, C, B = program['lock'][recsys.LOCKS[0]]
    assert D.dtype == np.float32 and C.shape == (8, 8)
    assert np.abs(D - program['D0']).max() > 0
    last = states[recsys.KEPT[-1] - 1]['D']
    assert np.abs(D - last).max() > 0
    before = loop.est.components_.copy()
    loop.epoch()
    assert loop.est.n_iter_ == (drivers.CHECKED_EPOCHS + 1) * 300
    assert np.abs(loop.est.components_ - before).max() > 0


def run_small(cfg, seed=3_000_000_019):
    return harness.run_cell(harness.load_benchmark(), CELL, seed, 0.2, 0,
                            'cpu', time.perf_counter(), cfg=cfg)


def test_sound_run_is_correct(cfg):
    result, compared = run_small(cfg)
    assert result['correct'], compared
    assert set(compared) == set(harness.load_limits(CELL['name']))


@pytest.mark.parametrize('fault', sorted(faults.BY_DRIVER['recsys']))
def test_planted_fault_is_not_correct(cfg, fault):
    with faults.BY_DRIVER['recsys'][fault]():
        result, compared = run_small(cfg)
    assert not result['correct'], compared


def test_control_is_not_correct(cfg):
    """The reference in TF32 in the program's place fails the limits."""
    limits = harness.load_limits(CELL['name'])
    for seed in (11, 12, 13):
        data_seed, est_seed = harness.split_seed(seed)
        ref = recsys.reference(cfg, data_seed, est_seed, 'cpu')
        control = recsys.reference(cfg, data_seed, est_seed, 'cpu', 'tf32')
        numbers = recsys.compare(control, ref)
        assert any(numbers[n] > lim for n, lim in limits.items()), numbers


def test_work_replays_the_draws(cfg):
    """The counts' batches: the reference's draws of the window's epochs
    (after the checked ones), each batch's entries and union over its
    rows, every row once an epoch."""
    data_seed, est_seed = harness.split_seed(SEED)
    X = recsys.make_data(cfg, data_seed, 'cpu').X
    work = recsys.Work(cfg, X, est_seed)
    assert work.b == 6 and work.steps(2) == 100
    rs = np.random.RandomState(est_seed)
    plain.initial_dictionary(rs, 8, 120)
    for _ in range(drivers.CHECKED_EPOCHS):
        plain.epoch_draws(rs, 300, 8, 6)
    epochs = work._epochs(2)
    for batches in epochs:
        draws = plain.epoch_draws(rs, 300, 8, 6)
        assert len(batches) == len(draws) == 50
        for (rows, _), (b, entries, union) in zip(draws, batches):
            cols = np.concatenate([X.indices[X.indptr[r]:X.indptr[r + 1]]
                                   for r in rows])
            assert (b, entries, union) == (len(rows), len(cols),
                                           len(np.unique(cols)))
    (bcd_ops, bcd_bytes) = recsys.batch_counts(8, *epochs[0][0])[1]
    assert work.bcd(1)[0] == (1, bcd_ops, bcd_bytes)
    assert bcd_ops == 4 * 64 * epochs[0][0][2]
    ops = sum(recsys.batch_counts(8, *b)[0][0] for b in epochs[1])
    assert work.epoch(2)[1][1] == pytest.approx(ops)


def test_batch_counts_by_hand():
    """k = 50, 100 rows, 10,000 entries over 3,000 films."""
    (ops, nbytes), (bcd_ops, bcd_bytes) = recsys.batch_counts(
        50, 100, 10_000, 3_000)
    assert bcd_ops == 4 * 2500 * 3000
    assert bcd_bytes == 4 * (3 * 50 * 3000 + 2500 + 150)
    assert ops == pytest.approx(
        2 * 10_000 * 2500 + 2 * 10_000 * 50 + 100 * (125_000 / 3 + 5000)
        + 2 * 100 * 2500 + 2 * 10_000 * 50 + bcd_ops)
    assert nbytes == 8 * 10_000 + 4 * (4 * 50 * 3000 + 2500 + 150 + 5000)


def test_b_update_is_the_serial_loop():
    """The reference's B EMA, visit level by visit level, equals the
    serial loop over rows of upstream modl (a column visited three times
    in one batch among them)."""
    import torch
    rng = np.random.RandomState(0)
    k, n = 3, 6
    cols = np.array([0, 2, 5, 2, 3, 2, 0])
    row = np.array([0, 0, 0, 1, 1, 2, 2])
    vals = rng.randn(len(cols))
    code = rng.randn(3, k)
    B0 = rng.randn(k, n)
    counts0 = np.array([4, 0, 1, 2, 0, 7])
    wn = 2.5
    B = torch.from_numpy(B0.copy())
    counts = counts0.copy()
    plain._b_update(B, torch.from_numpy(code), cols, vals, row, counts, wn,
                    np.float64)
    want, seen = B0.copy(), counts0.copy()
    for j in range(3):
        s = cols[row == j]
        seen[s] += 1
        w = np.minimum(1.0, wn / seen[s])
        want[:, s] = want[:, s] * (1 - w) + np.outer(code[j],
                                                     vals[row == j] * w)
    assert np.abs(B.numpy() - want).max() < 1e-14
    assert (counts == seen).all()
