"""The readings the limits of ``correct`` are set from, for one cell at
its own size, in one process:

    python3 perfbench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 --fault-seeds 3

(a cell that ``BENCHMARK.json`` does not list yet takes ``--config`` and
``--traffic`` too)

Prints one JSON line a reading: the program's (sound runs, one a seed),
the control's (the reference in TF32 in the program's place) and each
planted fault's (``faults.py``), every number of the driver's
``compare``.
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
    parser.add_argument('--config', help='for a cell that BENCHMARK.json '
                        'does not list yet: its configs/<config>.json')
    parser.add_argument('--traffic', help='with --config: its traffic mix')
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import drivers, faults, harness
    if args.config:
        cfg = harness.load_json(harness.HERE / 'configs'
                                / f'{args.config}.json')
        traffic = harness.load_traffic(args.traffic)
    else:
        bench = harness.load_benchmark()
        cell = harness.find(bench['workloads'], args.workload)
        cfg = harness.load_config(bench, cell['config'])
        traffic = harness.load_traffic(cell['traffic'])
    driver = drivers.of(cfg)
    planted = faults.BY_DRIVER[drivers.name(cfg)]

    def show(kind, seed, numbers, t0):
        print(json.dumps(dict(cell=args.workload, kind=kind, seed=seed,
                              seconds=time.perf_counter() - t0, **numbers)),
              flush=True)

    def run(data_seed, est_seed):
        loop, program = harness.prepare(cfg, traffic, data_seed, est_seed,
                                        'cuda')
        del loop
        harness.free('cuda')
        return program

    n = max(args.seeds, args.control_seeds, args.fault_seeds)
    for i in range(n):
        seed = args.first_seed + 7919 * i
        data_seed, est_seed = harness.split_seed(seed)
        t0 = time.perf_counter()
        ref = harness.reference(cfg, data_seed, est_seed, 'cuda')
        show('reference', seed, {}, t0)
        if i < args.seeds:
            t0 = time.perf_counter()
            show('program', seed, driver.compare(run(data_seed, est_seed),
                                                 ref), t0)
        if i < args.control_seeds:
            t0 = time.perf_counter()
            control = harness.reference(cfg, data_seed, est_seed, 'cuda',
                                        'tf32')
            show('control', seed, driver.compare(control, ref), t0)
            del control
        if i < args.fault_seeds:
            for name, fault in planted.items():
                t0 = time.perf_counter()
                with fault():
                    program = run(data_seed, est_seed)
                show(f'fault.{name}', seed, driver.compare(program, ref), t0)
        del ref
        harness.free('cuda')
    return 0


if __name__ == '__main__':
    sys.exit(main())
