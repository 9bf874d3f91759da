"""Aggregation specs (reference model/query_aggregation.dart:1-292:
Agg.count/sum/avg/max/min with aliases, groupBy/having support).

Deliberate deviation: count(field) counts NON-NULL values of the field
(SQL semantics); the reference's accumulator increments count before
reading the field (query_aggregation.dart:126-129), making count(f)
indistinguishable from count(*). count() / count("*") count all rows."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Agg:
    op: str  # count | sum | avg | min | max
    field: str | None = None  # None only for count(*)
    alias: str | None = None

    @property
    def name(self) -> str:
        return self.alias or (f"{self.op}_{self.field}" if self.field else self.op)

    @staticmethod
    def count(field: str | None = None, alias: str | None = None) -> "Agg":
        # "*" is the count-all spelling, not a field name
        return Agg("count", None if field == "*" else field, alias)

    @staticmethod
    def sum(field: str, alias: str | None = None) -> "Agg":
        return Agg("sum", field, alias)

    @staticmethod
    def avg(field: str, alias: str | None = None) -> "Agg":
        return Agg("avg", field, alias)

    @staticmethod
    def min(field: str, alias: str | None = None) -> "Agg":
        return Agg("min", field, alias)

    @staticmethod
    def max(field: str, alias: str | None = None) -> "Agg":
        return Agg("max", field, alias)

    def apply(self, values: list) -> object:
        vals = [v for v in values if v is not None]
        if self.op == "count":
            return len(vals) if self.field else len(values)
        if not vals:
            return None
        if self.op == "sum":
            return sum(vals)
        if self.op == "avg":
            return sum(vals) / len(vals)
        if self.op == "min":
            return min(vals)
        if self.op == "max":
            return max(vals)
        raise ValueError(self.op)
