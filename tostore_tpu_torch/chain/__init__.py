"""Chained query DSL (reference lib/src/chain/: QueryBuilder,
UpdateBuilder, DeleteBuilder, SchemaBuilder, StreamQueryBuilder)."""

from .builders import (
    QueryBuilder,
    UpdateBuilder,
    DeleteBuilder,
    SchemaBuilder,
    StreamQueryBuilder,
    VectorQueryBuilder,
)

__all__ = [
    "QueryBuilder",
    "UpdateBuilder",
    "DeleteBuilder",
    "SchemaBuilder",
    "StreamQueryBuilder",
    "VectorQueryBuilder",
]
