"""Utilities: ID generation, binary codecs, crypto, logging (host code carried
from `tostore_tpu/utils/`; figures in its comments are that package's history)."""
