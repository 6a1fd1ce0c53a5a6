"""The harness on the CPU at a small size: finding its parts by name,
the result line, the modules a run loads, the reference's imports."""
import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(harness.ROOT)
CELLS = [w['name'] for w in harness.load_benchmark()['workloads']]
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def run_small(bench, small, cell, trace, seconds=0.3, seed=2 ** 33 + 1):
    entry = harness.find(bench['workloads'], cell)
    return harness.run_cell(bench, entry, seed, seconds, trace, 'cpu',
                            time.perf_counter(),
                            cfg=small(bench, entry['config']))


@pytest.mark.parametrize('cell', CELLS)
def test_cell_parts_found_by_name(bench, cell):
    entry = harness.find(bench['workloads'], cell)
    cfg = harness.load_config(bench, entry['config'])
    assert cfg['estimator']['n_components'] > 0
    traffic = harness.load_traffic(entry['traffic'])
    assert {'verbose', 'n_epochs'} <= set(traffic)
    assert harness.load_limits(cell)
    for m in harness.cell_metrics(bench, cell, 'per_layer'):
        assert callable(harness.metric_reader(m['name']))
    names = {m['name'] for m in harness.cell_metrics(bench, cell,
                                                     'end_to_end')}
    assert 'setup_s' in names and len(names) >= 2


@pytest.mark.parametrize('trace', [0, 1])
def test_result_line_has_the_contract_keys(bench, small, trace):
    result, compared = run_small(bench, small, 'adhd70-epoch', trace)
    want = KEYS + (['breakdown'] if trace else []) + ['checks']
    assert list(result) == want
    json.dumps(result)
    assert result['correct'] is True and result['failed'] == 0
    assert result['attempted'] >= 1
    assert set(result['checks']) == set(compared)
    if trace:
        assert {'busy_s', 'window_s'} <= set(result['device'])
        assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert set(result['metrics']) == {
            m['name'] for m in bench['end_to_end']}


def test_new_metric_file_is_picked_up(bench, small, tmp_path, monkeypatch):
    import perfbench.metrics
    (tmp_path / 'epochs_traced.py').write_text(
        'def read(view):\n    return float(len(view.epochs))\n')
    monkeypatch.setattr(perfbench.metrics, '__path__',
                        list(perfbench.metrics.__path__) + [str(tmp_path)])
    bench = dict(bench, per_layer=bench['per_layer'] + [dict(
        name='epochs_traced', unit='epochs', better='higher',
        source='host_clock', layer='test', moves='samples_per_s')])
    result, _ = run_small(bench, small, 'adhd70-verbose', 1)
    assert result['metrics']['epochs_traced']['value'] >= 1


def test_run_loads_no_jax(small):
    code = (
        'import sys, time\n'
        f'sys.path.insert(0, {str(ROOT)!r})\n'
        'from perfbench import conftest, harness\n'
        'bench = harness.load_benchmark()\n'
        'cfg = harness.load_config(bench, "hcp1024")\n'
        'cfg.update(conftest.SMALL)\n'
        'cfg["estimator"].update(conftest.SMALL_ESTIMATOR)\n'
        'cell = harness.find(bench["workloads"], "hcp1024-epoch")\n'
        'res, _ = harness.run_cell(bench, cell, 5, 0.2, 0, "cpu",'
        ' time.perf_counter(), cfg=cfg)\n'
        'top = {m.split(".")[0] for m in sys.modules}\n'
        'assert res["correct"]\n'
        'assert "modl_tpu_torch" in top\n'
        'print(sorted(top & {"jax", "jaxlib", "flax", "modl_tpu"}))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, 'modl_tpu_torch_probe', sys)
    monkeypatch.setitem(sys.modules, 'jaxlibrary.probe', sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, 'modl_tpu.probe', sys)
    assert set(harness.forbidden_modules()) == before | {'modl_tpu'}


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / 'perfbench' / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ''] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split('.')[0] in ('numpy', 'torch', 'math'), \
                    f'{path.name} imports {name}'
    code = (f'import sys; sys.path.insert(0, {str(ROOT)!r}); '
            'import perfbench.reference.somf, perfbench.reference.recsys; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"modl_tpu_torch", "modl_tpu", "jax"}))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == '[]'


def test_command_without_a_card_prints_no_result(tmp_path):
    """Without a CUDA device the command fails and prints no result; so
    it does in a directory that holds only the benchmark's files."""
    for where in (ROOT, tmp_path):
        if where == tmp_path:
            shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
            shutil.copytree(ROOT / 'perfbench', tmp_path / 'perfbench',
                            ignore=shutil.ignore_patterns('__pycache__'))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
        out = subprocess.run(
            [sys.executable, 'perfbench/run.py', '--workload',
             'adhd70-epoch', '--seed', str(2 ** 31 + 11), '--seconds', '1',
             '--trace', '0'], capture_output=True, text=True, timeout=300,
            cwd=where, env=env)
        assert out.returncode != 0
        assert out.stdout.strip() == ''


def test_seeds_of_any_size_split_the_same_way():
    big = 2 ** 31 + 12345
    assert harness.split_seed(big) == harness.split_seed(big)
    assert harness.split_seed(big) != harness.split_seed(big + 1)
    assert all(0 <= s < 2 ** 32 for s in harness.split_seed(2 ** 40))


def test_the_tail_reads_every_epoch():
    # 100 epochs of 30 ms, 6 of them stalled to 80 ms: a p95 of single
    # epochs sees the stalls
    lengths = [0.03] * 94 + [0.08] * 6
    marks = [0.0]
    for t in lengths:
        marks.append(marks[-1] + t)
    ms = harness.epoch_ms(marks)
    assert len(ms) == 100
    assert abs(min(ms) - 30.0) < 1e-6
    assert abs(harness.p95(ms) - 80.0) < 1e-6
