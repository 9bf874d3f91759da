"""Query layer of the port: condition trees, planning, vectorized
execution (host code, carried from `tostore_tpu/query/`)."""

from .condition import QueryCondition

__all__ = ["QueryCondition"]
