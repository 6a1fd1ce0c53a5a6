"""One short run of every cell on the card through the benchmark's command
(``python3 -m pytest perfbench/tests -m card`` on a machine with an
H100; skips elsewhere)."""
import json
import subprocess
import sys

import pytest

from perfbench import harness

CELLS = [w['name'] for w in harness.load_benchmark()['workloads']]


@pytest.mark.card
@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', cell, '--seed',
         str(2 ** 31 + 977), '--seconds', '4', '--trace', str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu'
    assert result['metrics']
