"""Device-resident predicate columns for hybrid filtered search
(counterpart of `tostore_tpu/vector/filters.py`).

Columns referenced by hybrid-search predicates live as device tensors
aligned with the vector corpus's slots; DeviceCorpus re-packs them when it
compacts. A QueryCondition compiles to a few elementwise tensor ops that
produce the slot mask on the corpus's device (`device_mask`); only the
comparison scalars travel. The scans fold the mask into their bias
(`search_arrays(slot_mask=)`), so a filtered search reads the corpus once,
like an unfiltered one. The JAX package evaluates the mask in XLA outside
any kernel; here it is plain PyTorch.

Column kinds:
  - "float" (double/boolean fields): one f32 tensor; None is NaN
    (comparisons with NaN are False).
  - "int" (integer/bigInt/datetime fields): an exact int64 tensor plus an
    isnull bool tensor, so epoch-millisecond timestamps 1 ms apart stay
    distinct. The JAX package stores (hi int32, lo uint32, isnull) because
    its device arrays are 32-bit, and compares (hi, lo) pairs
    lexicographically, which orders them as int64 does. `state_dict` and
    `gather_host` / `scatter` keep that triple layout, so snapshots move
    between the packages unchanged.

Use: `compilable(cond, fc.names())`, then `fc.ensure(name, capacity)` for
every referenced field, then `device_mask(cond, fc, capacity)`.

The masks equal the JAX package's, except for bounds on int columns that
its device path gets wrong and its host evaluator gets right (an integral
float such as 1.7e12, an int beyond int64, an infinite bound): there
this module gives `QueryCondition.mask`'s answer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..query.condition import QueryCondition

_DEVICE_OPS = {"=", "!=", ">", "<", ">=", "<=", "between", "in", "is", "isNot"}
_MAX_IN = 16  # larger IN lists are not compiled (the engine's host path serves them)
_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1


def _to_triple(vals: torch.Tensor, nulls: torch.Tensor):
    """int64 values -> (hi int32, lo uint32, isnull bool) numpy arrays."""
    v = vals.cpu().numpy().astype(np.int64)
    hi = (v >> 32).astype(np.int32)
    lo = (v & 0xFFFFFFFF).astype(np.uint32)
    return hi, lo, nulls.cpu().numpy().astype(np.bool_)


def _from_triple(hi, lo) -> np.ndarray:
    return (np.asarray(hi, np.int64) << 32) | np.asarray(lo, np.uint32).astype(np.int64)


class FilterColumns:
    """Slot-aligned predicate columns living next to a DeviceCorpus."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.columns: dict[str, torch.Tensor] = {}  # float kind: f32 [cap]
        # int kind: name -> (values int64 [cap], isnull bool [cap])
        self.int_columns: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def _nan(self, n: int) -> torch.Tensor:
        return torch.full((n,), math.nan, dtype=torch.float32, device=self.device)

    def _empty_int(self, n: int):
        return (torch.zeros(n, dtype=torch.int64, device=self.device),
                torch.ones(n, dtype=torch.bool, device=self.device))

    def names(self) -> set[str]:
        return set(self.columns) | set(self.int_columns)

    def ensure(self, name: str, capacity: int):
        if name in self.columns:
            col = self.columns[name]
            if col.shape[0] < capacity:
                new = self._nan(capacity)
                new[: col.shape[0]] = col
                self.columns[name] = new
        elif name in self.int_columns:
            val, nul = self.int_columns[name]
            if val.shape[0] < capacity:
                nval, nnul = self._empty_int(capacity)
                nval[: val.shape[0]] = val
                nnul[: nul.shape[0]] = nul
                self.int_columns[name] = (nval, nnul)

    def update(self, name: str, slots: np.ndarray, values: list, capacity: int,
               kind: str = "float"):
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        if kind == "int":
            if name not in self.int_columns:
                self.int_columns[name] = self._empty_int(capacity)
            self.ensure(name, capacity)
            vals = np.zeros(len(values), np.int64)
            nulls = np.zeros(len(values), np.bool_)
            for j, v in enumerate(values):
                if v is None:
                    nulls[j] = True
                else:
                    iv = int(v)
                    if not (_I64_MIN <= iv <= _I64_MAX):
                        raise OverflowError(f"{name}: {iv} out of int64 range")
                    vals[j] = iv
            val, nul = self.int_columns[name]
            val[idx] = torch.from_numpy(vals).to(self.device)
            nul[idx] = torch.from_numpy(nulls).to(self.device)
        else:
            if name not in self.columns:
                self.columns[name] = self._nan(capacity)
            self.ensure(name, capacity)
            vals = np.asarray(
                [math.nan if v is None else float(v) for v in values], np.float32
            )
            self.columns[name][idx] = torch.from_numpy(vals).to(self.device)

    def gather_permute(self, gather: torch.Tensor, new_cap: int):
        """Re-pack all columns through a slot permutation (compaction)."""
        m = gather.shape[0]
        for name, col in list(self.columns.items()):
            new = self._nan(new_cap)
            if m:
                new[:m] = col[gather]
            self.columns[name] = new
        for name, (val, nul) in list(self.int_columns.items()):
            nval, nnul = self._empty_int(new_cap)
            if m:
                nval[:m] = val[gather]
                nnul[:m] = nul[gather]
            self.int_columns[name] = (nval, nnul)

    def move_ranges(self, ranges, new_cap: int):
        """Re-lay all columns out at capacity new_cap: each (src, dst, n) of
        `ranges` moves slots src .. src+n-1 to dst .. dst+n-1, every other
        slot reads as null (the sharded indexes' re-stripe on growth)."""
        for name, col in list(self.columns.items()):
            new = self._nan(new_cap)
            for src, dst, n in ranges:
                new[dst:dst + n] = col[src:src + n]
            self.columns[name] = new
        for name, (val, nul) in list(self.int_columns.items()):
            nval, nnul = self._empty_int(new_cap)
            for src, dst, n in ranges:
                nval[dst:dst + n] = val[src:src + n]
                nnul[dst:dst + n] = nul[src:src + n]
            self.int_columns[name] = (nval, nnul)

    def gather_host(self, slots) -> dict:
        """Host-side snapshot of the columns at the given slots (int columns
        as (hi int32, lo uint32, isnull) triples)."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        return {
            "float": {k: v[idx].cpu().numpy() for k, v in self.columns.items()},
            "int": {k: _to_triple(val[idx], nul[idx])
                    for k, (val, nul) in self.int_columns.items()},
        }

    def scatter(self, host_state: dict, slots, capacity: int):
        """Write a gather_host snapshot back at (possibly different) slots."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        for k, v in host_state.get("float", {}).items():
            if k not in self.columns:
                self.columns[k] = self._nan(capacity)
            self.ensure(k, capacity)
            self.columns[k][idx] = torch.tensor(np.asarray(v, np.float32), device=self.device)
        for k, (hi, lo, nu) in host_state.get("int", {}).items():
            if k not in self.int_columns:
                self.int_columns[k] = self._empty_int(capacity)
            self.ensure(k, capacity)
            val, nul = self.int_columns[k]
            val[idx] = torch.as_tensor(_from_triple(hi, lo), device=self.device)
            nul[idx] = torch.tensor(np.asarray(nu, np.bool_), device=self.device)

    def state_dict(self, upto: int | None = None):
        s = slice(None, upto)
        return {
            "float": {k: v[s].cpu().numpy() for k, v in self.columns.items()},
            "int": {k: _to_triple(val[s], nul[s])
                    for k, (val, nul) in self.int_columns.items()},
        }

    def load_state_dict(self, d, capacity: int):
        # legacy flat format: {name: f32 array}
        if d and "float" not in d and "int" not in d:
            d = {"float": d, "int": {}}
        for k, v in d.get("float", {}).items():
            full = self._nan(capacity)
            v = np.asarray(v, np.float32)
            full[: len(v)] = torch.tensor(v, device=self.device)
            self.columns[k] = full
        for k, (hi, lo, nu) in d.get("int", {}).items():
            m = len(hi)
            nval, nnul = self._empty_int(capacity)
            nval[:m] = torch.tensor(_from_triple(hi, lo), device=self.device)
            nnul[:m] = torch.tensor(np.asarray(nu, np.bool_), device=self.device)
            self.int_columns[k] = (nval, nnul)


def _coerce_scalar(v) -> float | None:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)  # quoted-numeric reference quirk
        except ValueError:
            return None
    return None


def _coerce_int_scalar(v) -> int | float | None:
    """For int columns: an exact int (integral floats and quoted integers
    included, of any size), a non-integral or infinite float (handled by
    bound adjustment), or None if unusable (NaN, text)."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, str):
        try:
            v = float(v)
        except ValueError:
            return None
    if isinstance(v, float):
        if math.isnan(v):
            return None
        return int(v) if v.is_integer() else v
    return None


def compilable(cond: QueryCondition, available: set[str]) -> bool:
    """Can this condition tree evaluate fully on device columns?"""
    for f, op, v in cond._clauses:
        if f not in available or op not in _DEVICE_OPS:
            return False
        if op in ("is", "isNot"):
            if v is not None:
                return False
        elif op == "between":
            if any(_coerce_scalar(x) is None for x in v):
                return False
        elif op == "in":
            if len(v) > _MAX_IN or any(_coerce_scalar(x) is None for x in v):
                return False
        elif _coerce_scalar(v) is None:
            return False
    return all(compilable(c, available) for c in cond._and + cond._or)


def _float_leaf(col, op, v):
    s = _coerce_scalar(v)
    if op == "=":
        return col == s
    if op == "!=":
        return (col != s) & ~torch.isnan(col)
    if op == ">":
        return col > s
    if op == "<":
        return col < s
    if op == ">=":
        return col >= s
    return col <= s  # "<="


def _int_leaf(val, nul, op, v):
    """One comparison on an int column, exact in int64. Null rows never
    match."""
    s = _coerce_int_scalar(v)
    ok = ~nul
    none = torch.zeros_like(nul)
    if s is None:
        return none
    if isinstance(s, float) and math.isfinite(s):  # non-integral bound
        if op == "=":
            return none
        if op == "!=":
            return ok
        if op in (">", ">="):
            op, s = ">=", math.ceil(s)
        else:  # <, <=
            op, s = "<=", math.floor(s)
    if not _I64_MIN <= s <= _I64_MAX:  # beyond every int64 value (or infinite)
        below = s > 0  # every stored value lies below the bound
        return {"=": none, "!=": ok, ">": none if below else ok, ">=": none if below else ok,
                "<": ok if below else none, "<=": ok if below else none}[op]
    if op == "=":
        return (val == s) & ok
    if op == "!=":
        return (val != s) & ok
    if op == ">":
        return (val > s) & ok
    if op == "<":
        return (val < s) & ok
    if op == ">=":
        return (val >= s) & ok
    return (val <= s) & ok  # "<="


def _leaf(fc: FilterColumns, f: str, op: str, v):
    if f in fc.int_columns:
        return _int_leaf(*fc.int_columns[f], op, v)
    return _float_leaf(fc.columns[f], op, v)


def device_mask(cond: QueryCondition, fc: FilterColumns, capacity: int) -> torch.Tensor:
    """Compile + evaluate the condition into a bool [capacity] mask on the
    columns' device. Node semantics: (clauses AND and-children) OR
    or-children. Caller must have checked `compilable` against fc.names()
    and `ensure`d every referenced column to `capacity`."""
    dev = fc.device
    alt = None
    if cond._or:
        alt = torch.zeros(capacity, dtype=torch.bool, device=dev)
        for c in cond._or:
            alt = alt | device_mask(c, fc, capacity)
        if not cond._clauses and not cond._and:
            return alt  # an OR-only node is not vacuously true (see condition.matches)
    m = torch.ones(capacity, dtype=torch.bool, device=dev)
    for f, op, v in cond._clauses:
        if op in ("is", "isNot"):  # IS NULL / IS NOT NULL
            isnull = (fc.int_columns[f][1] if f in fc.int_columns
                      else torch.isnan(fc.columns[f]))
            m = m & (isnull if op == "is" else ~isnull)
        elif op == "between":
            m = m & _leaf(fc, f, ">=", v[0]) & _leaf(fc, f, "<=", v[1])
        elif op == "in":
            hit = torch.zeros(capacity, dtype=torch.bool, device=dev)
            for x in v:
                hit = hit | _leaf(fc, f, "=", x)
            m = m & hit
        else:
            m = m & _leaf(fc, f, op, v)
    for c in cond._and:
        m = m & device_mask(c, fc, capacity)
    return m if alt is None else m | alt
