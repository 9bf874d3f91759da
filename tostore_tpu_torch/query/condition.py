"""Composable query condition trees (counterpart of
`tostore_tpu/query/condition.py`, carried as it is: host Python and numpy,
which the port cannot import from the JAX package without JAX).

Same operator surface as the reference `QueryCondition`
(query/query_condition.dart:1-836): =, !=, >, <, >=, <=, IN, NOT IN,
BETWEEN, LIKE, NOT LIKE, IS (NULL), IS NOT, with arbitrary AND/OR nesting
and map round-trip serialization (used by the WAL for large-delete metadata,
wal_manager.dart:78-131). A map written by either package loads in the
other.

Two evaluation modes (the reference has only row-at-a-time
handler/value_matcher.dart):
  - `matches(record)`: per-record, for write-buffer overlays and triggers.
  - `mask(columns, n)`: vectorized NumPy over a columnar store — the host
    analogue of the device bitmask that hybrid vector search folds into the
    scan's bias (vector/filters.py `device_mask`; BASELINE.json config #4).
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np

_OPS = {"=", "!=", ">", "<", ">=", "<=", "in", "notIn", "between", "like", "notLike", "is", "isNot"}


def _like_to_regex(pattern: str) -> re.Pattern:
    """SQL LIKE: % = any run, _ = single char. Case-SENSITIVE — parity
    with the reference matcher (value_matcher.dart:318 builds a plain
    RegExp), and what makes memcomparable prefix index arms sound."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _coerce_pair(a, b):
    """Numeric/text coercion for comparisons (reference quirk: quoted
    numerics compare numerically — database_tester.dart advanced-queries
    suite)."""
    if a is None or b is None:
        return a, b
    if isinstance(a, bool) or isinstance(b, bool):
        return a, b
    if isinstance(a, (int, float)) and isinstance(b, str):
        try:
            return a, float(b) if not float(b).is_integer() else int(float(b))
        except ValueError:
            return a, b
    if isinstance(a, str) and isinstance(b, (int, float)):
        try:
            fa = float(a)
            return (int(fa) if fa.is_integer() else fa), b
        except ValueError:
            return a, b
    return a, b


def _cmp(a, b) -> int | None:
    a, b = _coerce_pair(a, b)
    if a is None or b is None:
        return None
    try:
        if a == b:
            return 0
        return -1 if a < b else 1
    except TypeError:
        sa, sb = str(a), str(b)
        if sa == sb:
            return 0
        return -1 if sa < sb else 1


class QueryCondition:
    """A predicate tree node. Leaves hold (field, op, value); internal nodes
    AND/OR children. Immutable-ish; builders return new nodes."""

    def __init__(self):
        self._clauses: list[tuple[str, str, Any]] = []  # AND-ed leaves
        self._and: list[QueryCondition] = []
        self._or: list[QueryCondition] = []

    # --- builders ----------------------------------------------------------

    def where(self, field: str, op: str, value: Any = None) -> "QueryCondition":
        op = {"==": "=", "notin": "notIn", "not in": "notIn"}.get(op, op)
        if op not in _OPS:
            raise ValueError(f"unknown operator {op!r}")
        self._clauses.append((field, op, value))
        return self

    def where_equal(self, field, value):
        return self.where(field, "=", value)

    def where_in(self, field, values):
        return self.where(field, "in", list(values))

    def where_between(self, field, lo, hi):
        return self.where(field, "between", (lo, hi))

    def where_like(self, field, pattern):
        return self.where(field, "like", pattern)

    def where_null(self, field):
        return self.where(field, "is", None)

    def where_not_null(self, field):
        return self.where(field, "isNot", None)

    def and_(self, other: "QueryCondition") -> "QueryCondition":
        self._and.append(other)
        return self

    def or_(self, other: "QueryCondition") -> "QueryCondition":
        self._or.append(other)
        return self

    @property
    def is_empty(self) -> bool:
        return not (self._clauses or self._and or self._or)

    # --- introspection (used by the optimizer) ------------------------------

    def and_leaves(self) -> list[tuple[str, str, Any]]:
        """All leaves reachable by AND only (safe for index selection)."""
        if self._or:
            return []
        leaves = list(self._clauses)
        for c in self._and:
            leaves.extend(c.and_leaves())
        return leaves

    def dnf(self, cap: int = 64) -> list[list[tuple[str, str, Any]]] | None:
        """Disjunctive normal form: a list of AND-conjunctions (leaf lists)
        whose union is this predicate, or None when expansion exceeds `cap`
        (reference query_optimizer.dart:11 maxDnfExpansion=64). Node
        semantics: (clauses AND and-children) OR or-children."""
        if not self._clauses and not self._and:
            if not self._or:
                return [[]]  # empty condition = TRUE
            out: list[list] = []
            for c in self._or:
                sub = c.dnf(cap)
                if sub is None:
                    return None
                out.extend(sub)
                if len(out) > cap:
                    return None
            return out
        base: list[list] = [list(self._clauses)]
        for c in self._and:
            sub = c.dnf(cap)
            if sub is None:
                return None
            base = [b + s for b in base for s in sub]
            if len(base) > cap:
                return None
        for c in self._or:
            sub = c.dnf(cap)
            if sub is None:
                return None
            base.extend(sub)
            if len(base) > cap:
                return None
        return base

    def referenced_fields(self) -> set[str]:
        out = {f for f, _, _ in self._clauses}
        for c in self._and + self._or:
            out |= c.referenced_fields()
        return out

    # --- per-record evaluation ----------------------------------------------

    def matches(self, record: dict) -> bool:
        if not self._clauses and not self._and:
            # OR-only node: the result IS the disjunction (an empty AND part
            # must not make it vacuously true)
            return not self._or or any(c.matches(record) for c in self._or)
        base = all(self._match_leaf(record, f, op, v) for f, op, v in self._clauses) and all(
            c.matches(record) for c in self._and
        )
        if base:
            return True
        return any(c.matches(record) for c in self._or)

    @staticmethod
    def _field_value(record: dict, field: str):
        """Record value for a possibly table-qualified field: direct key
        first, then the bare suffix for dotted names — the reference's
        merged-record lookup (value_matcher.dart getFieldValue:
        direct -> '<table>.<field>' falls back to '<field>')."""
        v = record.get(field)
        if v is not None or field in record:
            return v
        if "." in field:
            part = field.split(".", 1)[1]
            if part in record:
                return record[part]
        return None

    @staticmethod
    def _match_leaf(record: dict, field: str, op: str, value: Any) -> bool:
        cur = QueryCondition._field_value(record, field)
        if op == "is":
            return cur is None if value is None else cur == value
        if op == "isNot":
            return cur is not None if value is None else cur != value
        if op == "in":
            return any(_cmp(cur, v) == 0 for v in value)
        if op == "notIn":
            return cur is not None and all(_cmp(cur, v) != 0 for v in value)
        if op == "between":
            lo, hi = value
            c1, c2 = _cmp(cur, lo), _cmp(cur, hi)
            return c1 is not None and c2 is not None and c1 >= 0 and c2 <= 0
        if op in ("like", "notLike"):
            if cur is None:
                return False
            hit = bool(_like_to_regex(str(value)).match(str(cur)))
            return hit if op == "like" else not hit
        c = _cmp(cur, value)
        if c is None:
            return False
        return {"=": c == 0, "!=": c != 0, ">": c > 0, "<": c < 0, ">=": c >= 0, "<=": c <= 0}[op]

    # --- vectorized evaluation ----------------------------------------------

    def mask(self, get_column: Callable[[str], np.ndarray], n: int) -> np.ndarray:
        """Vectorized evaluation: get_column(field) -> np array of length n
        (object dtype allowed). Returns bool[n]."""
        if not self._clauses and not self._and:
            if not self._or:
                return np.ones(n, dtype=bool)
            alt = np.zeros(n, dtype=bool)
            for c in self._or:
                alt |= c.mask(get_column, n)
            return alt
        m = np.ones(n, dtype=bool)
        for f, op, v in self._clauses:
            m &= self._mask_leaf(get_column(f), op, v, n)
        for c in self._and:
            m &= c.mask(get_column, n)
        if self._or:
            alt = np.zeros(n, dtype=bool)
            for c in self._or:
                alt |= c.mask(get_column, n)
            m |= alt
        return m

    @staticmethod
    def _mask_leaf(col: np.ndarray, op: str, value: Any, n: int) -> np.ndarray:
        isnull = np.array([x is None for x in col]) if col.dtype == object else np.zeros(n, bool)
        if op == "is" and value is None:
            return isnull
        if op == "isNot" and value is None:
            return ~isnull
        if op in ("like", "notLike"):
            rx = _like_to_regex(str(value))
            hit = np.fromiter(
                (x is not None and bool(rx.match(str(x))) for x in col), bool, count=n
            )
            return hit if op == "like" else ~hit
        if op == "in":
            vals = list(value)
            out = np.zeros(n, bool)
            for v in vals:
                out |= QueryCondition._mask_leaf(col, "=", v, n)
            return out
        if op == "notIn":
            return ~QueryCondition._mask_leaf(col, "in", value, n) & ~isnull
        if op == "between":
            lo, hi = value
            return QueryCondition._mask_leaf(col, ">=", lo, n) & QueryCondition._mask_leaf(
                col, "<=", hi, n
            )
        # ordered comparisons: try fast numeric path
        if col.dtype != object and isinstance(value, (int, float)) and not isinstance(value, bool):
            with np.errstate(invalid="ignore"):
                if op == "=":
                    return col == value
                if op == "!=":
                    return col != value
                if op == ">":
                    return col > value
                if op == "<":
                    return col < value
                if op == ">=":
                    return col >= value
                if op == "<=":
                    return col <= value
        # generic per-element (object columns / mixed types)
        cmp = np.fromiter((_c if (_c := _cmp(x, value)) is not None else 99 for x in col),
                          np.int8, count=n)
        return {
            "=": cmp == 0,
            "!=": (cmp != 0) & (cmp != 99),
            ">": cmp == 1,
            "<": cmp == -1,
            ">=": (cmp >= 0) & (cmp != 99),
            "<=": (cmp <= 0),
        }[op]

    # --- serialization -------------------------------------------------------

    def to_map(self) -> dict:
        return {
            "clauses": [[f, op, self._ser_value(v)] for f, op, v in self._clauses],
            "and": [c.to_map() for c in self._and],
            "or": [c.to_map() for c in self._or],
        }

    @staticmethod
    def _ser_value(v):
        if isinstance(v, tuple):
            return list(v)
        return v

    @staticmethod
    def from_map(d: dict) -> "QueryCondition":
        c = QueryCondition()
        for f, op, v in d.get("clauses", []):
            if op == "between" and isinstance(v, list):
                v = tuple(v)
            c._clauses.append((f, op, v))
        c._and = [QueryCondition.from_map(x) for x in d.get("and", [])]
        c._or = [QueryCondition.from_map(x) for x in d.get("or", [])]
        return c

    def __repr__(self):
        parts = [f"{f} {op} {v!r}" for f, op, v in self._clauses]
        if self._and:
            parts.append("AND(" + ", ".join(map(repr, self._and)) + ")")
        if self._or:
            parts.append("OR(" + ", ".join(map(repr, self._or)) + ")")
        return "Cond(" + " & ".join(parts) + ")"
