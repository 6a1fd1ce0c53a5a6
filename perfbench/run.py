"""Run one cell of the benchmark of modl_tpu_torch once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. Prints the result as one JSON object on the last line of
standard output, and the numbers that decide ``correct`` beside their
limits as the last lines of standard error (``perfbench/README.md``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout, so that
# only a checkout's first run builds
CACHES = {'TRITON_CACHE_DIR': 'triton', 'TORCH_EXTENSIONS_DIR': 'torch_ext',
          'CUDA_CACHE_PATH': 'cuda'}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, name in CACHES.items():
        os.environ[var] = os.path.join(ROOT, 'build', 'perfbench', name)
    os.environ.setdefault('OMP_NUM_THREADS', '1')
    sys.path.insert(0, ROOT)
    from perfbench import harness
    return harness.main(args, T0)


if __name__ == '__main__':
    sys.exit(main())
