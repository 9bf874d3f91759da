"""Vector index engines of the port: the device corpus, the flat index,
the IVF / IVF-PQ index and product quantization."""

from .corpus import DeviceCorpus
from .flat import FlatVectorIndex
from .ivf import IVFVectorIndex
from .pq import PQCodebook, train_pq

__all__ = ["DeviceCorpus", "FlatVectorIndex", "IVFVectorIndex", "PQCodebook", "train_pq"]
