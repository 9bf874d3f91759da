"""Vector index engines of the port: the device corpus and the flat index."""

from .corpus import DeviceCorpus
from .flat import FlatVectorIndex

__all__ = ["DeviceCorpus", "FlatVectorIndex"]
