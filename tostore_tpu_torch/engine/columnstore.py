"""ColumnStore — typed columnar record storage for one table.

The host-side replacement for the reference's paged B+Tree record store
(table_tree_partition_manager.dart: global leaf-chain B+Tree over 16 KB
pages with BinarySchemaCodec values). A TPU-native engine reads records in
bulk to build device bitmasks and batch vector payloads, so the natural
layout is columnar: one typed NumPy array per field plus null masks, a
dense rowid space with tombstones, and a pk->rowid hash. Vectorized
predicate evaluation (query/condition.py `mask`) runs directly over these
columns — the reference's row-at-a-time ValueMatcher loop becomes a few
NumPy kernels.
"""

from __future__ import annotations

import threading

import numpy as np

from ..models.schema import DataType, TableSchema

# numpy backing per DataType; None = object column
_NP_TYPES = {
    DataType.integer: np.int64,
    DataType.bigInt: np.int64,
    DataType.double: np.float64,
    DataType.boolean: np.bool_,
    DataType.datetime: np.int64,  # epoch ms
}

_GROW = 256
_GROW_LOCK = threading.Lock()  # serializes lazy Column growth (see _grow)


def _copy_cell(v):
    """Structure-copy list/dict/ndarray cells (copy-on-read/write guard).
    ~8x faster than copy.deepcopy for the small JSON payloads records
    hold. Vector cells are 1-D float32 ndarrays (stored verbatim through
    WAL + snapshots by the native codec — NEVER per-element Python
    lists; the list form cost ~40x in checkpoint/replay interpreter
    time at the 10M-row scale soak)."""
    t = type(v)
    if t is np.ndarray:
        return v.copy()
    if t is list:
        return [_copy_cell(x) for x in v]
    if t is dict:
        return {k: _copy_cell(x) for k, x in v.items()}
    return v


class Column:
    def __init__(self, dtype: DataType):
        self.dtype = dtype
        self.np_type = _NP_TYPES.get(dtype)
        if self.np_type is not None:
            self.data = np.zeros(0, self.np_type)
            self.null = np.ones(0, np.bool_)
        else:
            self.data = np.empty(0, dtype=object)
            self.null = None  # None sentinel lives in the object array

    def _grow(self, n: int):
        # thread-safe for concurrent READERS (view() grows lazily and may
        # run under the engine's SHARED mode): growth is serialized and
        # `null` is published before `data`, so a reader that observes a
        # grown `data` always sees the matching grown `null`. Cell VALUES
        # only mutate under engine-exclusive mode, so the copied prefix is
        # stable.
        if n <= len(self.data):
            return
        with _GROW_LOCK:
            cur = len(self.data)
            if n <= cur:
                return  # another grower won the race
            new = max(n, cur * 2, _GROW)
            if self.np_type is not None:
                d = np.zeros(new, self.np_type)
                d[:cur] = self.data
                m = np.ones(new, np.bool_)
                m[:cur] = self.null
                self.null = m
                self.data = d
            else:
                d = np.empty(new, dtype=object)
                d[:cur] = self.data
                self.data = d

    def set(self, row: int, value):
        self._grow(row + 1)
        if self.np_type is not None:
            if value is None:
                self.null[row] = True
                self.data[row] = 0
            else:
                self.null[row] = False
                if self.dtype == DataType.boolean:
                    self.data[row] = bool(value)
                else:
                    self.data[row] = value
        else:
            if isinstance(value, (list, dict, np.ndarray)):  # copy-on-write, see get()
                value = _copy_cell(value)
            self.data[row] = value

    def bulk_set(self, rows: np.ndarray, values: list | None):
        """Set many rows at once; values=None means all-null."""
        if len(rows) == 0:
            return
        self._grow(int(rows.max()) + 1)
        if self.np_type is not None:
            if values is None:
                self.null[rows] = True
                return
            # np.asarray silently coerces None for bool/float dtypes, so the
            # None scan must be explicit
            if any(v is None for v in values):
                arr = np.empty(len(values), self.np_type)
                nulls = np.zeros(len(values), np.bool_)
                for j, v in enumerate(values):
                    if v is None:
                        nulls[j] = True
                        arr[j] = 0
                    else:
                        arr[j] = v
            else:
                arr = np.asarray(values, self.np_type)
                nulls = np.zeros(len(values), np.bool_)
            self.data[rows] = arr
            self.null[rows] = nulls
        else:
            if values is None:
                self.data[rows] = None
            else:
                out = np.empty(len(values), dtype=object)
                out[:] = [
                    _copy_cell(v)
                    if isinstance(v, (list, dict, np.ndarray)) else v
                    for v in values
                ]  # object assignment keeps list/dict cells intact
                self.data[rows] = out

    def get(self, row: int):
        if row >= len(self.data):
            return None
        if self.np_type is not None:
            if self.null[row]:
                return None
            v = self.data[row]
            if self.dtype in (DataType.integer, DataType.bigInt, DataType.datetime):
                return int(v)
            if self.dtype == DataType.double:
                return float(v)
            if self.dtype == DataType.boolean:
                return bool(v)
            return v
        v = self.data[row]
        # copy-on-read: callers own the returned record; handing out the
        # stored list/dict would let mutations bypass the WAL and poison
        # cached query results
        if isinstance(v, (list, dict, np.ndarray)):
            return _copy_cell(v)
        return v

    def get_many(self, rows: np.ndarray) -> list:
        """Vectorized get() over many rows: one fancy-index + tolist per
        column instead of a branchy per-cell call (hot in query result
        materialization). Cell semantics identical to get(): null -> None,
        Python scalar types, copy-on-read for mutable cells."""
        if len(rows) == 0:
            return []
        if len(self.data) == 0 or int(rows.max()) >= len(self.data):
            return [self.get(int(r)) for r in rows]
        vals = self.data[rows].tolist()  # native Python scalars / objects
        if self.np_type is not None:
            nulls = self.null[rows]
            if nulls.any():
                for j in np.flatnonzero(nulls):
                    vals[j] = None
            return vals
        return [
            _copy_cell(v) if isinstance(v, (list, dict, np.ndarray)) else v
            for v in vals
        ]

    def view(self, n: int) -> np.ndarray:
        """First n entries as an array for vectorized predicates. Typed
        columns with nulls are surfaced as object arrays only when needed."""
        self._grow(n)
        if self.np_type is None:
            return self.data[:n]
        if not self.null[:n].any():
            return self.data[:n]
        out = self.data[:n].astype(object)
        out[self.null[:n]] = None
        return out


class PkMap:
    """pk -> rowid mapping with a dense int-keyed fast path.

    At the reference's 10M-100M-row envelope (README.md:1527-1531) a Python
    dict costs ~100 B per entry plus a boxed int key — ~10x the bytes of the
    int64 column it indexes, and the single biggest share of the r4 scale
    soak's 9x RAM-vs-disk blowup. When keys are ints and reasonably dense
    (sequential-pk tables), rowid+1 lives in one int64 numpy array indexed
    by (pk - base), 0 = absent: 8 B/row, vectorized bulk build. String,
    sparse-int, and out-of-window keys fall back to / overflow into a dict.

    Iteration order is ascending pk for the dense window (the engine's
    pks()/items() consumers are order-insensitive — integrity sampling,
    migrations, resumable deletes, overlay merges)."""

    __slots__ = ("_dict", "_arr", "_base", "_ndense")

    # grow the dense window for appends within this many slots past the
    # end (8 MB of int64); farther outliers overflow into the dict
    _GROW_WINDOW = 1 << 20

    def __init__(self):
        self._dict: dict = {}
        self._arr: np.ndarray | None = None
        self._base = 0
        self._ndense = 0

    # --- construction ------------------------------------------------------

    @staticmethod
    def _int_key(pk):
        if type(pk) is int:
            return pk
        if isinstance(pk, np.integer):
            return int(pk)
        return None

    @staticmethod
    def build_from_arrays(pks: np.ndarray, rows: np.ndarray) -> "PkMap":
        """Vectorized bulk build (snapshot load): int64 pks + rowids."""
        m = PkMap()
        n = len(pks)
        if n == 0:
            return m
        lo = int(pks.min())
        hi = int(pks.max())
        span = hi - lo + 1
        if span <= max(4 * n, n + 4096):
            m._base = lo
            m._arr = np.zeros(span, np.int64)
            m._arr[pks - lo] = rows + 1
            m._ndense = n
        else:
            m._dict = dict(zip(pks.tolist(), rows.tolist()))
        return m

    def _try_activate(self, pks, rows) -> bool:
        """First bulk insert into an empty map: go dense when keys allow."""
        try:
            arr = np.asarray(pks)
            if arr.dtype.kind not in "iu":
                return False
            built = PkMap.build_from_arrays(
                arr.astype(np.int64), np.asarray(rows, np.int64)
            )
        except (TypeError, ValueError, OverflowError):
            return False
        if built._arr is None:
            return False
        self._arr, self._base, self._ndense = built._arr, built._base, built._ndense
        return True

    def _grow_to(self, i: int) -> bool:
        """Extend the dense window to cover index i (amortized doubling,
        bounded extra allocation); farther appends overflow into the dict."""
        a = self._arr
        if i >= len(a) + self._GROW_WINDOW:
            return False
        new_len = max(i + 1, min(2 * len(a), i + self._GROW_WINDOW))
        g = np.zeros(new_len, np.int64)
        g[: len(a)] = a
        self._arr = g
        return True

    # --- dict-compatible surface ------------------------------------------

    def get(self, pk, default=None):
        a = self._arr
        if a is not None:
            k = self._int_key(pk)
            if k is not None:
                i = k - self._base
                if 0 <= i < len(a):
                    v = a[i]
                    if v:
                        return int(v) - 1
                    # the window may have grown over a key that overflowed
                    # into the dict while it was out of range
                    return self._dict.get(pk, default) if self._dict else default
        return self._dict.get(pk, default)

    def __getitem__(self, pk):
        v = self.get(pk)
        if v is None:
            raise KeyError(pk)
        return v

    def __setitem__(self, pk, row):
        a = self._arr
        if a is not None:
            k = self._int_key(pk)
            if k is not None:
                i = k - self._base
                if 0 <= i < len(a) or (i >= len(a) and self._grow_to(i)):
                    a = self._arr
                    if a[i] == 0:
                        self._ndense += 1
                        if self._dict:  # grown-over overflow key migrates
                            self._dict.pop(pk, None)
                    a[i] = row + 1
                    return
        elif a is None and not self._dict:
            if self._try_activate([pk], [row]):
                return
        self._dict[pk] = row

    def pop(self, pk, default=None):
        a = self._arr
        if a is not None:
            k = self._int_key(pk)
            if k is not None:
                i = k - self._base
                if 0 <= i < len(a):
                    v = a[i]
                    if v:
                        a[i] = 0
                        self._ndense -= 1
                        return int(v) - 1
                    return self._dict.pop(pk, default) if self._dict else default
        return self._dict.pop(pk, default)

    def update(self, pairs):
        for pk, row in pairs:
            self[pk] = row

    def bulk_set(self, pks: list, rows: np.ndarray):
        """Vectorized batch insert (the bulk_insert hot path)."""
        if self._arr is None:
            if not self._dict and self._try_activate(pks, rows):
                return
            self._dict.update(zip(pks, rows.tolist()))
            return
        try:
            keys = np.asarray(pks)
            ok = keys.dtype.kind in "iu"
        except (TypeError, ValueError):
            ok = False
        if not ok:
            self.update(zip(pks, rows.tolist()))
            return
        keys = keys.astype(np.int64) - self._base
        hi = int(keys.max()) if len(keys) else -1
        if int(keys.min()) < 0 or (hi >= len(self._arr) and not self._grow_to(hi)):
            self.update(zip(pks, rows.tolist()))
            return
        a = self._arr
        self._ndense += int(np.count_nonzero(a[keys] == 0))
        if self._dict:
            # grown-over overflow keys move from the dict into the window
            for pk in pks:
                self._dict.pop(pk, None)
        a[keys] = np.asarray(rows, np.int64) + 1

    def __contains__(self, pk):
        return self.get(pk) is not None

    def contains_many(self, pks) -> np.ndarray:
        """Vectorized membership for a batch -> bool mask. WAL replay
        filters whole batch frames against the store; per-pk get() calls
        cost ~1 s per 500k rows on the recovery path this serves."""
        n = len(pks)
        a = self._arr
        if a is not None:
            try:
                keys = np.asarray(pks)
                ok = keys.dtype.kind in "iu"
            except (TypeError, ValueError):
                ok = False
            if ok:
                idx = keys.astype(np.int64) - self._base
                in_win = (idx >= 0) & (idx < len(a))
                out = np.zeros(n, np.bool_)
                out[in_win] = a[idx[in_win]] != 0
                if self._dict:
                    d = self._dict
                    for j in np.flatnonzero(~out):
                        if pks[j] in d:
                            out[j] = True
                return out
        return np.fromiter((pk in self for pk in pks), np.bool_, n)

    def __len__(self):
        return self._ndense + len(self._dict)

    def keys(self) -> list:
        out = []
        a = self._arr
        if a is not None and self._ndense:
            out = (np.flatnonzero(a) + self._base).tolist()
        if self._dict:
            out += list(self._dict.keys())
        return out

    def __iter__(self):
        return iter(self.keys())

    def items(self):
        a = self._arr
        if a is not None and self._ndense:
            idx = np.flatnonzero(a)
            for i, v in zip((idx + self._base).tolist(), (a[idx] - 1).tolist()):
                yield i, v
        yield from self._dict.items()

    def values(self):
        return [row for _, row in self.items()]


class ColumnStore:
    """Records for one table: dense rowids, tombstones, pk->rowid map."""

    def __init__(self, schema: TableSchema):
        self.schema = schema
        self.pk_name = schema.primary_key.name
        self.columns: dict[str, Column] = {f.name: Column(f.type) for f in schema.fields}
        # the PK column itself (type depends on pk strategy: int or str)
        self.pk_col = Column(
            DataType.integer
            if schema.primary_key.type.value == "sequential"
            else DataType.text
        )
        self._pk_row = PkMap()
        self.valid = np.zeros(0, np.bool_)
        self.high = 0
        self._free: list[int] = []
        self.generation = 0  # bumped on every mutation (query cache keys)

    def __len__(self):
        return len(self._pk_row)

    def __contains__(self, pk):
        return pk in self._pk_row

    def contains_many(self, pks) -> np.ndarray:
        return self._pk_row.contains_many(pks)

    def rowid(self, pk) -> int | None:
        return self._pk_row.get(pk)

    def pks(self) -> list:
        return list(self._pk_row.keys())

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        r = self.high
        self.high += 1
        if r >= len(self.valid):
            v = np.zeros(max(self.high * 2, _GROW), np.bool_)
            v[: len(self.valid)] = self.valid
            self.valid = v
        return r

    def ensure_column(self, name: str, dtype: DataType):
        if name not in self.columns:
            self.columns[name] = Column(dtype)

    def drop_column(self, name: str):
        self.columns.pop(name, None)

    def bulk_insert(self, pks: list, col_values: dict[str, list]) -> np.ndarray:
        """Insert n brand-new records column-wise (caller guarantees pks are
        new). The batch analogue of `upsert` — one pass per column instead
        of one call per cell (reference batch_insert_compute.dart)."""
        n = len(pks)
        rows = np.empty(n, np.int64)
        n_free = min(len(self._free), n)
        for j in range(n_free):
            rows[j] = self._free.pop()
        fresh = n - n_free
        if fresh:
            rows[n_free:] = np.arange(self.high, self.high + fresh)
            self.high += fresh
        if self.high > len(self.valid):
            v = np.zeros(max(self.high * 2, _GROW), np.bool_)
            v[: len(self.valid)] = self.valid
            self.valid = v
        self.valid[rows] = True
        self._pk_row.bulk_set(pks, rows)
        self.pk_col.bulk_set(rows, pks)
        for name, col in self.columns.items():
            vals = col_values.get(name)
            col.bulk_set(rows, vals)
        self.generation += 1
        return rows

    def upsert(self, pk, record: dict) -> int:
        """Full-record write (insert or replace). Returns rowid."""
        row = self._pk_row.get(pk)
        if row is None:
            row = self._alloc()
            self._pk_row[pk] = row
        self.valid[row] = True
        self.pk_col.set(row, pk)
        for name, col in self.columns.items():
            col.set(row, record.get(name))
        self.generation += 1
        return row

    def bulk_patch(self, rows: np.ndarray, col_values: dict[str, list]):
        """Column-wise patch of existing rows (batch_update fast path):
        one bulk_set per updated column instead of one set() per cell
        (reference batch_update_compute.dart isolate batches)."""
        rows = np.asarray(rows, np.int64)
        for name, vals in col_values.items():
            col = self.columns.get(name)
            if col is not None:
                col.bulk_set(rows, vals)
        self.generation += 1

    def patch(self, pk, updates: dict) -> int | None:
        row = self._pk_row.get(pk)
        if row is None:
            return None
        for name, value in updates.items():
            if name in self.columns:
                self.columns[name].set(row, value)
        self.generation += 1
        return row

    def delete(self, pk) -> bool:
        row = self._pk_row.pop(pk, None)
        if row is None:
            return False
        self.valid[row] = False
        self._free.append(row)
        self.generation += 1
        return True

    def bulk_delete(self, pks: list, rows: np.ndarray) -> None:
        """Columnar delete of pre-resolved (pk, rowid) pairs: ONE
        generation bump, so callers note every index exactly once."""
        pop = self._pk_row.pop
        for pk in pks:
            pop(pk, None)
        self.valid[rows] = False
        self._free.extend(int(r) for r in rows)
        self.generation += 1

    def clear(self):
        self.__init__(self.schema)

    def get(self, pk) -> dict | None:
        row = self._pk_row.get(pk)
        if row is None:
            return None
        return self.read_row(row)

    def read_row(self, row: int) -> dict:
        rec = {self.pk_name: self.pk_col.get(row)}
        for name, col in self.columns.items():
            rec[name] = col.get(row)
        return rec

    def read_rows(self, rows, fields=None) -> list[dict]:
        """Bulk read_row: one vectorized gather per column instead of one
        get() per cell — the query-result materialization hot path.
        `fields` (a set) gathers only those columns — projection
        pushdown for SELECTed pages on wide tables."""
        rows = np.asarray(rows, np.int64)
        if len(rows) == 0:
            return []
        if fields is None:
            names = [self.pk_name, *self.columns.keys()]
            cols = [self.pk_col.get_many(rows)]
            cols.extend(c.get_many(rows) for c in self.columns.values())
        else:
            names, cols = [], []
            if self.pk_name in fields:
                names.append(self.pk_name)
                cols.append(self.pk_col.get_many(rows))
            for n, c in self.columns.items():
                if n in fields:
                    names.append(n)
                    cols.append(c.get_many(rows))
            if not names:
                return [{} for _ in range(len(rows))]
        return [dict(zip(names, cells)) for cells in zip(*cols)]

    def column_view(self, name: str) -> np.ndarray:
        """Column (or PK) values for rows [0, high) — invalid rows included;
        callers AND with `valid_view()`."""
        if name == self.pk_name:
            return self.pk_col.view(self.high)
        col = self.columns.get(name)
        if col is None:
            return np.full(self.high, None, dtype=object)
        return col.view(self.high)

    def valid_view(self) -> np.ndarray:
        return self.valid[: self.high]

    def nbytes(self) -> int:
        """Estimated live data size in bytes (reference TableInfo.fileSize,
        model/table_info.dart). Typed columns count exactly; object columns
        are sampled (≤256 live cells, extrapolated) so the estimate stays
        O(columns), not O(cells), on multi-million-row tables."""
        import sys

        n_live = len(self._pk_row)
        if n_live == 0:
            return 0
        total = 0
        live_rows = None
        for col in [*self.columns.values(), self.pk_col]:
            n = min(self.high, len(col.data))
            if col.np_type is not None:
                total += int(col.data[:n].nbytes)
                continue
            if live_rows is None:
                live_rows = np.flatnonzero(self.valid_view())
            sample = live_rows[:: max(1, len(live_rows) // 256)][:256]
            if len(sample) == 0:
                continue
            per = 0
            for r in sample:
                v = col.data[r] if r < len(col.data) else None
                if v is None:
                    per += 8
                elif isinstance(v, np.ndarray):
                    per += v.nbytes
                elif isinstance(v, (str, bytes)):
                    per += len(v) + 16
                else:
                    per += sys.getsizeof(v)
            total += per * len(live_rows) // len(sample)
        return total

    def rows_for_mask(self, mask: np.ndarray) -> np.ndarray:
        return np.flatnonzero(mask & self.valid_view())

    # --- persistence -------------------------------------------------------

    def _pack_column(self, col: Column, rows: np.ndarray) -> dict:
        """Vectorized column serialization — one fancy-index per typed
        column instead of one Python call per cell (checkpoints must be
        O(dirty data), not O(cells) of interpreter time). When every row
        is live (`rows` is the dense prefix — the common append-only
        case) typed columns pack as prefix VIEWS: zero copies here, and
        the streaming snapshot writer (codec.dump_parts) sends the bytes
        straight to the file. Safe because checkpoints run under the
        engine's exclusive lock, so the views can't race mutation."""
        col._grow(self.high)
        dense = len(rows) == self.high
        if col.np_type is not None:
            if dense:
                return {"data": col.data[: self.high], "null": col.null[: self.high]}
            return {"data": col.data[rows], "null": col.null[rows]}
        if dense:
            return {"values": col.data[: self.high].tolist()}
        return {"values": col.data[rows].tolist()}

    @staticmethod
    def _unpack_column(col: Column, packed: dict, n: int):
        if "values" in packed:
            out = np.empty(n, dtype=object)
            out[:] = packed["values"]
            col.data = out
        else:
            col.data = ColumnStore._owned(packed["data"], col.np_type)
            col.null = ColumnStore._owned(packed["null"], np.bool_)

    @staticmethod
    def _owned(v, np_type) -> np.ndarray:
        """Writable owning array from a decoded snapshot value WITHOUT a
        redundant copy: tag-10 codec arrays already own their memory (one
        copy from the file bytes), legacy list/read-only forms get copied.
        On hosts with slow page faults the extra copy per 10M-row column
        is seconds of open time."""
        if (
            isinstance(v, np.ndarray)
            and v.dtype == np_type
            and v.flags.owndata
            and v.flags.writeable
        ):
            return v
        a = np.asarray(v, np_type)
        if a is v or not (a.flags.owndata and a.flags.writeable):
            a = a.copy()
        return a

    def state_dict(self) -> dict:
        rows = np.flatnonzero(self.valid_view())
        self.pk_col._grow(self.high)
        return {
            "fmt": 2,
            "n": int(len(rows)),
            "pk": self._pack_column(self.pk_col, rows),
            "pk_dtype": self.pk_col.dtype.value,
            "columns": {
                name: self._pack_column(col, rows) for name, col in self.columns.items()
            },
            "column_types": {name: col.dtype.value for name, col in self.columns.items()},
        }

    @staticmethod
    def from_state_dict(schema: TableSchema, d: dict) -> "ColumnStore":
        cs = ColumnStore(schema)
        for name, tval in d.get("column_types", {}).items():
            cs.ensure_column(name, DataType(tval))  # system/extra columns
        if d.get("fmt", 1) >= 2:
            n = int(d["n"])
            cs.high = n
            cs.valid = np.zeros(max(n, _GROW), np.bool_)
            cs.valid[:n] = True
            ColumnStore._unpack_column(cs.pk_col, d["pk"], n)
            if cs.pk_col.np_type is not None and cs.pk_col.null is None:
                cs.pk_col.null = np.zeros(n, np.bool_)
            if cs.pk_col.np_type is not None:
                # vectorized dense build: no 10M-entry Python dict
                cs._pk_row = PkMap.build_from_arrays(
                    np.asarray(cs.pk_col.data[:n], np.int64),
                    np.arange(n, dtype=np.int64),
                )
            else:
                cs._pk_row = PkMap()
                cs._pk_row.update(
                    (pk, i) for i, pk in enumerate(cs.pk_col.data[:n])
                )
            for name, packed in d["columns"].items():
                if name in cs.columns:
                    ColumnStore._unpack_column(cs.columns[name], packed, n)
            cs.generation = 0
            return cs
        # legacy fmt 1: one value list per column
        cols = d["columns"]
        names = list(cs.columns)
        for j, pk in enumerate(d["pks"]):
            rec = {n: cols[n][j] if n in cols else None for n in names}
            cs.upsert(pk, rec)
        cs.generation = 0
        return cs
