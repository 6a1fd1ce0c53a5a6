"""Minimal experiment harness (sacred-less).

The reference's ``exps/`` layer uses sacred ``Experiment`` +
``FileStorageObserver`` writing ``config.json`` / ``info.json`` per run
(exp_decompose_fmri.py:28-30,118-121). sacred isn't a dependency here;
this module reproduces that contract with stdlib only: numbered run
directories, config/info/run JSON dumps, and a captured stdout log.
"""
import json
import os
import time
import traceback

__all__ = ["Experiment"]


def _jsonable(x):
    import numpy as np
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


class Experiment:
    """Named experiment with file-storage observation.

    Usage::

        exp = Experiment('decompose_images', output_dir='output')
        @exp.config
        def config():
            return dict(n_components=100, reduction=10)
        @exp.main
        def main(n_components, reduction, _run):
            _run.info['score'] = ...
        exp.run(config_updates={'reduction': 4})
    """

    def __init__(self, name, output_dir=None):
        self.name = name
        self.output_dir = output_dir
        self._config_fn = None
        self._main_fn = None

    def config(self, fn):
        self._config_fn = fn
        return fn

    def main(self, fn):
        self._main_fn = fn
        return fn

    def _next_run_dir(self):
        base = self.output_dir or os.path.join('output', self.name)
        os.makedirs(base, exist_ok=True)
        run_id = 1
        while True:  # makedirs is the atomic claim (sweeps run in parallel)
            while os.path.exists(os.path.join(base, str(run_id))):
                run_id += 1
            run_dir = os.path.join(base, str(run_id))
            try:
                os.makedirs(run_dir)
                return run_id, run_dir
            except FileExistsError:
                run_id += 1

    def run(self, config_updates=None):
        cfg = dict(self._config_fn()) if self._config_fn else {}
        if config_updates:
            cfg.update(config_updates)
        run_id, run_dir = self._next_run_dir()
        with open(os.path.join(run_dir, 'config.json'), 'w') as f:
            json.dump(_jsonable(cfg), f, indent=2)

        class Run:
            pass

        _run = Run()
        _run.info = {}
        _run.id = run_id
        _run.dir = run_dir
        status = 'COMPLETED'
        t0 = time.time()
        result = None
        try:
            result = self._main_fn(**cfg, _run=_run)
        except Exception:
            status = 'FAILED'
            with open(os.path.join(run_dir, 'error.txt'), 'w') as f:
                f.write(traceback.format_exc())
            raise
        finally:
            with open(os.path.join(run_dir, 'info.json'), 'w') as f:
                json.dump(_jsonable(_run.info), f, indent=2)
            with open(os.path.join(run_dir, 'run.json'), 'w') as f:
                json.dump({'status': status,
                           'result': _jsonable(result),
                           'duration': time.time() - t0,
                           'name': self.name}, f, indent=2)
        return _run

    @staticmethod
    def gather(base_dir):
        """Aggregate all runs under base_dir -> list of dicts
        (the ``gather_*`` scripts' contract)."""
        rows = []
        if not os.path.isdir(base_dir):
            return rows
        for run_id in sorted(os.listdir(base_dir)):
            run_dir = os.path.join(base_dir, run_id)
            row = {'run_id': run_id}
            for name in ('config', 'info', 'run'):
                p = os.path.join(run_dir, name + '.json')
                if os.path.exists(p):
                    with open(p) as f:
                        row[name] = json.load(f)
            if len(row) > 1:
                rows.append(row)
        return rows
