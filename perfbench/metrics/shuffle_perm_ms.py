"""Host ms an epoch in the program's ``modl.shuffle.perm`` span:
``DictFact.shuffle``'s seed draw, the permutation and its copy to the
card (``decomposition/dict_fact.py``)."""
from ._spans import host_ms


def read(view):
    return host_ms(view, 'modl.shuffle.perm')
