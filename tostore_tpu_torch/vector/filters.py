"""Slot-aligned predicate columns (counterpart of the storage half of
`tostore_tpu/vector/filters.py`: `FilterColumns`).

Columns referenced by hybrid-search predicates live as device tensors
aligned with the vector corpus's slots; DeviceCorpus re-packs them when it
compacts. Column kinds:
  - "float" (double/boolean fields): one f32 tensor; None is NaN.
  - "int" (integer/bigInt/datetime fields): an exact int64 tensor plus an
    isnull bool tensor. The JAX package stores (hi int32, lo uint32,
    isnull) because its device arrays are 32-bit; `state_dict` keeps that
    triple layout, so snapshots move between the packages unchanged.

Predicate evaluation on the device (`compilable`, `device_mask`) and the
host snapshot helpers (`gather_host`, `scatter`) are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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
