"""Host ms an epoch in the program's ``modl.sync`` span: the wait
that ends ``DictFact._partial_fit_ingested``, the card's time that no
host work overlaps (``decomposition/dict_fact.py``)."""
from ._spans import host_ms


def read(view):
    return host_ms(view, 'modl.sync')
