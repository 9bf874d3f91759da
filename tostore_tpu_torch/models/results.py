"""Result models of the port (counterpart of `tostore_tpu/models/results.py`).

Only `VectorSearchResult` is carried over so far: the flat vector index
returns it. Fields and their order are those of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class VectorSearchResult:
    """One ANN hit (reference query_result.dart:207). `distance` is the true
    metric distance; `score` the user-facing relevance mapping
    (vector_index_manager.dart:1411-1423)."""

    primary_key: Any
    distance: float
    score: float
    record: dict[str, Any] | None = None
