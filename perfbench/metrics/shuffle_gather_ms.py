"""Host ms an epoch in the program's ``modl.shuffle.gather`` span:
``DictFact.shuffle``'s gathers and copies of the per-sample leaves
and of ``labels_`` (``decomposition/dict_fact.py``)."""
from ._spans import host_ms


def read(view):
    return host_ms(view, 'modl.shuffle.gather')
