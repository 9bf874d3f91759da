"""Result models of the port."""

from .results import VectorSearchResult

__all__ = ["VectorSearchResult"]
