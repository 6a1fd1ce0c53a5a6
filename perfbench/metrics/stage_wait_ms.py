"""Host ms an epoch in the program's ``modl.stage.wait`` spans: the
host waiting for the card to free a slot of ``_step.DrawStaging``'s
ring before it packs the next draws into it."""
from ._spans import host_ms


def read(view):
    return host_ms(view, 'modl.stage.wait')
