"""Query layer of the port: condition trees (host code, carried from
`tostore_tpu/query/`). Planning and the executor belong to the engine,
which is not ported yet."""

from .condition import QueryCondition

__all__ = ["QueryCondition"]
