"""tostore_tpu_torch: the PyTorch / CUDA port of tostore_tpu's vector layer.

The JAX package `tostore_tpu` stays the reference; this package mirrors
its layout (ops/, vector/, models/) and imports neither JAX nor
`tostore_tpu`. Device tensors live where the caller says (`device=`);
on a CUDA device the flat scan and the IVF bucket scans run the
hand-written Hopper kernels in `csrc/`, built with nvcc at first use
(ops/_kernels.py).
"""

from .models.results import VectorSearchResult
from .vector.corpus import DeviceCorpus
from .vector.flat import FlatVectorIndex
from .vector.ivf import IVFVectorIndex
from .vector.pq import PQCodebook, train_pq

__all__ = ["FlatVectorIndex", "IVFVectorIndex", "PQCodebook", "train_pq", "DeviceCorpus",
           "VectorSearchResult"]
