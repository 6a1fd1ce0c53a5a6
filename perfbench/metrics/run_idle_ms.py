"""ms an epoch in which the card sits idle inside the program's
``modl.run`` spans: a replay's launch before the graph's first kernel,
and the gaps between the graph's kernels while the launch call lasts
(``decomposition/_program.py``)."""
from ._spans import idle_ms


def read(view):
    return idle_ms(view, 'modl.run')
