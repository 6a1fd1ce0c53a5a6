"""modl_tpu_torch: the PyTorch/CUDA port of modl_tpu's SOMF/OMF learner.

The resident dense fit (``DictFact.fit``) runs on an NVIDIA GPU through
plain PyTorch for the step's matrix products and one hand-written Hopper
kernel for the sequential dictionary update (``ops/bcd.py``). The JAX
package ``modl_tpu`` stays the reference this port is tested against;
nothing here imports it or JAX.
"""
__version__ = "0.1.0"

from .decomposition.dict_fact import Coder, DictFact

__all__ = ["DictFact", "Coder"]
