"""Atomic server-side update expressions.

Same surface as the reference `Expr` (model/expr.dart:1-400): arithmetic on
the current field value, min/max clamps, now(), insert/update detection, and
conditional when/ifElse — all evaluated at write time inside the engine so
read-modify-write races cannot occur.

Usage:
    db.update('t', {'count': Expr.field('count') + 1, 'ts': Expr.now()})
"""

from __future__ import annotations

import time
from typing import Any, Callable


class Expr:
    """An expression tree evaluated against (record, is_insert)."""

    def __init__(self, fn: Callable[[dict, bool], Any], desc: str = "expr"):
        self._fn = fn
        self._desc = desc

    # --- constructors -----------------------------------------------------

    @staticmethod
    def field(name: str) -> "Expr":
        return Expr(lambda rec, ins: rec.get(name), f"field({name})")

    @staticmethod
    def value(v: Any) -> "Expr":
        return Expr(lambda rec, ins: v, f"value({v!r})")

    @staticmethod
    def now() -> "Expr":
        return Expr(lambda rec, ins: int(time.time() * 1000), "now()")

    @staticmethod
    def is_update() -> "Expr":
        return Expr(lambda rec, ins: not ins, "isUpdate()")

    @staticmethod
    def is_insert() -> "Expr":
        return Expr(lambda rec, ins: ins, "isInsert()")

    @staticmethod
    def when(cond: "Expr | Any", then: "Expr | Any", otherwise: "Expr | Any" = None) -> "Expr":
        c, t, o = Expr._wrap(cond), Expr._wrap(then), Expr._wrap(otherwise)
        return Expr(
            lambda rec, ins: t._fn(rec, ins) if c._fn(rec, ins) else o._fn(rec, ins),
            "when(...)",
        )

    if_else = when  # reference names it ifElse

    @staticmethod
    def _wrap(v) -> "Expr":
        return v if isinstance(v, Expr) else Expr.value(v)

    # --- arithmetic -------------------------------------------------------

    def _binop(self, other, op, name) -> "Expr":
        o = Expr._wrap(other)

        def fn(rec, ins):
            a = self._fn(rec, ins)
            b = o._fn(rec, ins)
            if a is None:
                a = 0
            if b is None:
                b = 0
            return op(a, b)

        return Expr(fn, f"({self._desc} {name} {o._desc})")

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b, "+")

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b, "-")

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b, "*")

    def __truediv__(self, other):
        # division by zero yields None (reference surfaces a business error;
        # we store null and report in DbResult errors)
        def div(a, b):
            if b in (0, 0.0):
                raise ZeroDivisionError("Expr division by zero")
            return a / b

        return self._binop(other, div, "/")

    def min(self, other) -> "Expr":
        return self._binop(other, lambda a, b: a if a <= b else b, "min")

    def max(self, other) -> "Expr":
        return self._binop(other, lambda a, b: a if a >= b else b, "max")

    # comparisons (for when() conditions)
    def __gt__(self, other):
        return self._binop(other, lambda a, b: a > b, ">")

    def __ge__(self, other):
        return self._binop(other, lambda a, b: a >= b, ">=")

    def __lt__(self, other):
        return self._binop(other, lambda a, b: a < b, "<")

    def __le__(self, other):
        return self._binop(other, lambda a, b: a <= b, "<=")

    def eq(self, other):
        return self._binop(other, lambda a, b: a == b, "==")

    def ne(self, other):
        return self._binop(other, lambda a, b: a != b, "!=")

    # --- evaluation (engine-internal) --------------------------------------

    def evaluate(self, record: dict, is_insert: bool = False) -> Any:
        return self._fn(record, is_insert)

    def __repr__(self):
        return f"Expr<{self._desc}>"


def resolve_expr_values(data: dict, current: dict, is_insert: bool) -> dict:
    """Materialize any Expr values in an update/insert payload against the
    current record state."""
    out = {}
    base = dict(current)
    for k, v in data.items():
        out[k] = v.evaluate(base, is_insert) if isinstance(v, Expr) else v
    return out
