"""Table (and plot) of the image sweep's runs (counterpart of
``exps/gather_decompose_images.py``).

    python -m modl_tpu_torch.exps.gather_decompose_images [--plot]

Reads the config/info JSON of every run under
``<output>/multi_decompose_images``; ``--plot`` saves the final score
against the reduction, one line a method, with matplotlib. Host only.
"""
import sys

from ..utils.experiment import Experiment
from ..utils.system import get_output_dir


def main(base_dir=None, plot=False):
    base_dir = base_dir or '%s/multi_decompose_images' % get_output_dir()
    rows = Experiment.gather(base_dir)
    print('%-6s %-8s %-10s %-12s %-10s'
          % ('run', 'method', 'reduction', 'final_score', 'fit_time'))
    table = []
    for row in rows:
        cfg = row.get('config', {})
        info = row.get('info', {})
        rec = (row['run_id'], cfg.get('method'), cfg.get('reduction'),
               info.get('final_score'), info.get('fit_time'))
        table.append(rec)
        print('%-6s %-8s %-10s %-12s %-10s' % tuple(
            '%.4f' % v if isinstance(v, float) else str(v) for v in rec))
    if plot and table:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        for method in sorted({t[1] for t in table}):
            pts = sorted((t[2], t[3]) for t in table
                         if t[1] == method and t[3] is not None)
            if pts:
                ax.plot([p[0] for p in pts], [p[1] for p in pts],
                        marker='o', label=method)
        ax.set_xlabel('reduction')
        ax.set_ylabel('final test objective')
        ax.legend()
        fig.savefig('gather_decompose_images.png')
        print('saved gather_decompose_images.png')
    return table


if __name__ == '__main__':
    main(plot='--plot' in sys.argv)
