"""The readings the limits of ``correct`` are set from, for one cell at
its own size, in one process:

    python3 perfbench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 --fault-seeds 3

Prints one JSON line a reading: the program's (sound runs, one a seed),
the control's (the reference in TF32 in the program's place) and each
planted fault's (``faults.py``), every number of ``checks.compare``.
The window is not run: the readings are of the checked epochs, which
set-up runs through the window's own call."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, default=12)
    parser.add_argument('--control-seeds', type=int, default=3)
    parser.add_argument('--fault-seeds', type=int, default=3)
    parser.add_argument('--first-seed', type=int, default=1_000_003)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import checks, faults, harness
    bench = harness.load_benchmark()
    cell = harness.find(bench['workloads'], args.workload)
    cfg = harness.load_config(bench, cell['config'])
    traffic = harness.load_traffic(cell['traffic'])

    def show(kind, seed, numbers, t0):
        print(json.dumps(dict(cell=args.workload, kind=kind, seed=seed,
                              seconds=time.perf_counter() - t0, **numbers)),
              flush=True)

    n = max(args.seeds, args.control_seeds, args.fault_seeds)
    for i in range(n):
        seed = args.first_seed + 7919 * i
        data_seed, est_seed = harness.split_seed(seed)
        t0 = time.perf_counter()
        ref = harness.reference(cfg, data_seed, est_seed, 'cuda')
        show('reference', seed, {}, t0)
        if i < args.seeds:
            t0 = time.perf_counter()
            loop, program = harness.prepare(cfg, traffic, data_seed, est_seed,
                                            'cuda')
            del loop
            harness.free('cuda')
            show('program', seed, checks.compare(program, ref), t0)
        if i < args.control_seeds:
            t0 = time.perf_counter()
            control = harness.reference(cfg, data_seed, est_seed, 'cuda',
                                        'tf32')
            show('control', seed, checks.compare(control, ref), t0)
            del control
        if i < args.fault_seeds:
            for name, fault in faults.FAULTS.items():
                t0 = time.perf_counter()
                with fault():
                    loop, program = harness.prepare(cfg, traffic, data_seed,
                                                    est_seed, 'cuda')
                del loop
                harness.free('cuda')
                show(f'fault.{name}', seed, checks.compare(program, ref), t0)
        del ref
        harness.free('cuda')
    return 0


if __name__ == '__main__':
    sys.exit(main())
