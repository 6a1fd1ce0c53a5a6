"""Reduction sweep of the image experiment (counterpart of
``exps/multi_decompose_images.py``).

    python -m modl_tpu_torch.exps.multi_decompose_images [n_jobs]

Runs ``exp_decompose_images`` over reductions x methods (64 components,
2 epochs) into ``<output>/multi_decompose_images``, in ``n_jobs``
joblib workers when more than one. A run that fails on its data or
parameters is tried again, up to 3 times, as in the ``exps/`` script; a
failure of the device or of a kernel (a ``RuntimeError``) ends the
sweep.
"""
import sys

from ..utils.system import get_output_dir
from .exp_decompose_images import exp

REDUCTIONS = [1, 4, 6, 8, 12, 24]
METHODS = ['masked', 'gram']


def run_one(method, reduction, device):
    for attempt in range(3):
        try:
            exp.output_dir = '%s/multi_decompose_images' % get_output_dir()
            run = exp.run(config_updates={'method': method,
                                          'reduction': reduction,
                                          'n_epochs': 2,
                                          'n_components': 64,
                                          'device': device})
            return run.info.get('final_score')
        except RuntimeError:
            raise
        except Exception as e:
            print('run %s/r=%s attempt %d failed: %s'
                  % (method, reduction, attempt + 1, e))
    return None


def main(n_jobs=1, device='cuda'):
    grid = [(m, r) for m in METHODS for r in REDUCTIONS]
    if n_jobs == 1:
        results = [run_one(m, r, device) for m, r in grid]
    else:
        from joblib import Parallel, delayed
        results = Parallel(n_jobs=n_jobs)(
            delayed(run_one)(m, r, device) for m, r in grid)
    for (m, r), score in zip(grid, results):
        print('%-8s reduction=%-4s final=%s' % (m, r, score))
    return results


if __name__ == '__main__':
    main(n_jobs=int(sys.argv[1]) if len(sys.argv) > 1 else 1)
