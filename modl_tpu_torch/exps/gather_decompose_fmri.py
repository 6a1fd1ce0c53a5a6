"""Table of the fMRI sweep's runs (counterpart of
``exps/gather_decompose_fmri.py``).

    python -m modl_tpu_torch.exps.gather_decompose_fmri

Reads the config/info JSON of every run under
``<output>/multi_decompose_fmri``. Host only.
"""
from ..utils.experiment import Experiment
from ..utils.system import get_output_dir


def main(base_dir=None):
    base_dir = base_dir or '%s/multi_decompose_fmri' % get_output_dir()
    rows = Experiment.gather(base_dir)
    print('%-6s %-10s %-6s %-12s %-10s %-10s'
          % ('run', 'reduction', 'lr', 'final_score', 'cpu_time',
             'io_time'))
    table = []
    for row in rows:
        cfg = row.get('config', {})
        info = row.get('info', {})
        rec = (row['run_id'], cfg.get('reduction'),
               cfg.get('learning_rate'), info.get('final_score'),
               info.get('cpu_time'), info.get('io_time'))
        table.append(rec)
        print('%-6s %-10s %-6s %-12s %-10s %-10s' % tuple(
            '%.4f' % v if isinstance(v, float) else str(v) for v in rec))
    return table


if __name__ == '__main__':
    main()
