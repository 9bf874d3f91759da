"""tostore_tpu_torch: the PyTorch / CUDA port of tostore_tpu's vector layer.

The JAX package `tostore_tpu` stays the reference; this package mirrors
its layout (ops/, vector/, models/) and imports neither JAX nor
`tostore_tpu`. Device tensors live where the caller says (`device=`);
on a CUDA device the flat scan runs the hand-written Hopper kernels in
`csrc/`, built with nvcc at first use (ops/_kernels.py).
"""

from .models.results import VectorSearchResult
from .vector.corpus import DeviceCorpus
from .vector.flat import FlatVectorIndex

__all__ = ["FlatVectorIndex", "DeviceCorpus", "VectorSearchResult"]
