"""Result models of the port (counterpart of `tostore_tpu/models/results.py`,
carried as it is: host Python).

Same semantics as the reference's `DbResult` (model/db_result.dart:1-187:
success/partial/error with successKeys/failedKeys), `ResultType`
(result_type.dart:1-94 coded enum), `QueryResult` with cursor pagination
(query_result.dart:1-228), `VectorSearchResult` (query_result.dart:207) and
`TransactionResult` (transaction_result.dart).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Iterator


class ResultType(enum.IntEnum):
    """Coded result types (reference result_type.dart: 0 success, 1 partial,
    negative codes for error families)."""

    success = 0
    partial = 1
    unknown = -1
    validationFailed = -10
    uniqueViolation = -20
    notFound = -30
    foreignKeyViolation = -40
    constraintViolation = -50
    transactionConflict = -60
    resourceLimit = -70
    ioError = -80
    businessError = -90
    schemaError = -92


@dataclass
class DbResult:
    type: ResultType = ResultType.success
    message: str | None = None
    success_keys: list[Any] = field(default_factory=list)
    failed_keys: list[Any] = field(default_factory=list)
    errors: dict[Any, str] = field(default_factory=dict)
    data: Any = None

    @property
    def is_success(self) -> bool:
        return self.type == ResultType.success

    @property
    def is_partial(self) -> bool:
        return self.type == ResultType.partial

    @property
    def is_error(self) -> bool:
        return self.type.value < 0

    @staticmethod
    def success(keys=None, data=None, message=None) -> "DbResult":
        return DbResult(ResultType.success, message, list(keys or []), [], {}, data)

    @staticmethod
    def error(type: ResultType, message: str, failed_keys=None, errors=None) -> "DbResult":
        return DbResult(type, message, [], list(failed_keys or []), dict(errors or {}))

    @staticmethod
    def partial(success_keys, failed_keys, errors=None, message=None) -> "DbResult":
        return DbResult(
            ResultType.partial, message, list(success_keys), list(failed_keys), dict(errors or {})
        )

    def __bool__(self) -> bool:
        return not self.is_error


@dataclass
class QueryResult:
    """Query results with dual pagination (offset or cursor token —
    reference query_executor.dart ExecuteResult + query_result.dart next()/
    prev())."""

    records: list[dict[str, Any]] = field(default_factory=list)
    next_cursor: str | None = None
    prev_cursor: str | None = None
    has_more: bool = False
    total: int | None = None
    # bound query context for next()/prev(); set by the query chain
    _source: Any = None

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return iter(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]

    @property
    def is_empty(self) -> bool:
        return not self.records

    def next(self) -> "QueryResult":
        if self._source is None or self.next_cursor is None:
            return QueryResult()
        return self._source._page(cursor=self.next_cursor, forward=True)

    def prev(self) -> "QueryResult":
        if self._source is None or self.prev_cursor is None:
            return QueryResult()
        return self._source._page(cursor=self.prev_cursor, forward=False)


@dataclass(frozen=True)
class VectorSearchResult:
    """One ANN hit (reference query_result.dart:207). `distance` is the true
    metric distance; `score` the user-facing relevance mapping
    (vector_index_manager.dart:1411-1423)."""

    primary_key: Any
    distance: float
    score: float
    record: dict[str, Any] | None = None


@dataclass
class TransactionResult:
    committed: bool
    result: Any = None
    error: str | None = None
    tx_id: str | None = None
    retries: int = 0  # conflict retries consumed (transaction(retries=N))


class UniqueViolation(Exception):
    def __init__(self, table: str, fields, value, message: str | None = None):
        self.table = table
        self.fields = tuple(fields) if isinstance(fields, (list, tuple)) else (fields,)
        self.value = value
        super().__init__(
            message or f"unique violation on {table}({', '.join(self.fields)}) value={value!r}"
        )


class BusinessError(Exception):
    """User-raised error inside a transaction that triggers rollback
    (reference model/business_error.dart)."""

    def __init__(self, message: str, code: str | None = None):
        self.code = code
        super().__init__(message)
