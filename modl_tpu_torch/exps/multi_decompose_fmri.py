"""Reduction/learning-rate sweep of the fMRI experiment (counterpart of
``exps/multi_decompose_fmri.py``).

    python -m modl_tpu_torch.exps.multi_decompose_fmri [n_jobs]

Runs ``exp_decompose_fmri`` over the grid (70 components, 3 epochs) into
``<output>/multi_decompose_fmri``, in ``n_jobs`` joblib workers when
more than one. A run that fails on its data or parameters is logged and
the sweep goes on, as in the ``exps/`` script; a failure of the device
or of a kernel (a ``RuntimeError``) ends the sweep.
"""
import sys

from ..utils.system import get_output_dir
from .exp_decompose_fmri import exp

REDUCTIONS = [1, 4, 8, 12]
LEARNING_RATES = [0.92]


def run_one(reduction, learning_rate, device):
    try:
        exp.output_dir = '%s/multi_decompose_fmri' % get_output_dir()
        run = exp.run(config_updates={'reduction': reduction,
                                      'learning_rate': learning_rate,
                                      'n_components': 70,
                                      'n_epochs': 3,
                                      'device': device})
        return run.info.get('final_score')
    except RuntimeError:
        raise
    except Exception as e:
        print('run r=%s lr=%s failed: %s' % (reduction, learning_rate, e))
        return None


def main(n_jobs=1, device='cuda'):
    grid = [(r, lr) for r in REDUCTIONS for lr in LEARNING_RATES]
    if n_jobs == 1:
        results = [run_one(r, lr, device) for r, lr in grid]
    else:
        from joblib import Parallel, delayed
        results = Parallel(n_jobs=n_jobs)(
            delayed(run_one)(r, lr, device) for r, lr in grid)
    for (r, lr), score in zip(grid, results):
        print('reduction=%-4s lr=%-5s final=%s' % (r, lr, score))
    return results


if __name__ == '__main__':
    main(n_jobs=int(sys.argv[1]) if len(sys.argv) > 1 else 1)
