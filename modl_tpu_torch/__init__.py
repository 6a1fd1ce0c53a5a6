"""modl_tpu_torch: the PyTorch/CUDA port of modl_tpu's SOMF/OMF learner.

The dense fit (``DictFact``), the streaming fMRI fit (``fMRIDictFact``
over ``.npy`` records), patch dictionaries of images (``ImageDictFact``)
and masked factorisation of sparse ratings (``RecsysDictFact``) run on
an NVIDIA GPU through plain PyTorch for the steps' matrix products and
hand-written Hopper kernels for the sequential dictionary update
(``ops/bcd.py``) and the deferred-B segment end (``ops/ema_gemm.py``). The JAX package
``modl_tpu`` stays the reference this port is tested against; nothing
here imports it or JAX.
"""
__version__ = "0.1.0"

from .decomposition.dict_fact import Coder, DictFact
from .decomposition.fmri import fMRICoder, fMRIDictFact
from .decomposition.image import ImageDictFact
from .decomposition.recsys import RecsysDictFact

__all__ = ["DictFact", "Coder", "fMRIDictFact", "fMRICoder",
           "ImageDictFact", "RecsysDictFact"]
