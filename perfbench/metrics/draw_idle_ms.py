"""ms an epoch in which the card sits idle inside the program's
``modl.draw`` spans: the host generator's draws, an epoch's before the
fused epoch's replay or a step's in ``StepProgram.step`` (the programs
layer: ``decomposition/_program.py``, ``_step.draw_step``)."""
from ._spans import idle_ms


def read(view):
    return idle_ms(view, 'modl.draw')
