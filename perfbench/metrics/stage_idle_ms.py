"""ms an epoch in which the card sits idle inside the program's
``modl.stage`` spans: the step scalars, the packing of the draws into a
ring slot and its copy, the rows' gather or copy and the indices' copy
into a program's buffers (``decomposition/_program.py``,
``_step.DrawStaging``)."""
from ._spans import idle_ms


def read(view):
    return idle_ms(view, 'modl.stage')
