"""Table — schema-validated record storage with indexes.

Bundles what the reference spreads across TableDataManager
(table_data_manager.dart: record store + buffers), IndexManager
(index_manager.dart: unique checks, secondary index maintenance,
searchIndex) and VectorIndexManager (vector_index_manager.dart): one table
owns a ColumnStore, hash unique maps (the reference's unique B+Trees),
lazily-sorted ordered indexes (the reference's non-unique B+Trees with
memcomparable keys), and device-resident vector indexes with a buffered
flush path (the reference's write-buffer -> flush pipeline, pjm:350).
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from ..models.expr import Expr
from ..models.results import UniqueViolation
from ..models.schema import (
    DataType,
    IndexSchema,
    PrimaryKeyType,
    TableSchema,
)
from ..utils.idgen import SequentialIdGenerator, TimeBasedIdGenerator
from ..utils.rwlock import rw
from ..vector.flat import FlatVectorIndex
from ..vector.ivf import IVFVectorIndex
from .columnstore import ColumnStore

INGEST_TS_FIELD = "_system_ingest_ts_ms"  # reference ttl_cleanup_manager.dart:40


class ValidationError(ValueError):
    pass


class NullKey:
    """Sentinel for IS NULL index bounds — `None` already means
    'unbounded' in the planner's (lo, hi) tuples, so null equality needs
    its own marker; SortedIndex._encode maps it to the null byte tag."""


NULL_KEY = NullKey()


class SortedIndex:
    """Ordered secondary index: sorted memcomparable key array over live
    rows PLUS an incremental delta log — the vectorized stand-in for the
    reference's paged index B+Trees (index_tree_partition_manager.dart),
    which update in place per write. A full rebuild is O(n log n)
    (measured 2.4 s at 2M rows), so a single write must not force one on
    the next indexed query; instead Table's mutators feed this index an
    ordered (key, rowid, is_add) log, and reads serve from
    base + replayed deltas until the log exceeds ~2% of the base (then
    one rebuild folds it in). Keys use the order-preserving memcomparable
    encoding (utils/memcomparable.py, reference handler/memcomparable.dart),
    so typed multi-field tuples sort and range-scan as plain byte strings
    via np.searchsorted.

    Safety: every store mutation bumps `store.generation` exactly once,
    and every Table mutator notifies every index exactly once (possibly a
    no-op note). The log tracks generation contiguity; ANY untracked bump
    (a gap) or threshold overflow marks the log broken and the next read
    falls back to a full rebuild — delta replay can therefore never serve
    a state it did not see. Read methods return spans `(a, b, kl, kh)`
    (base bisect positions + the encoded byte bounds) so counts and rows
    adjust for deltas EXACTLY: key in [kl, kh) <=> base position in
    [a, b), since base is sorted by the same bytes with side-left
    bisection at both ends. Thread-safe for concurrent readers under the
    engine's SHARED mode: replay/rebuild serialize on _build_lock and
    publish their generation stamps last; mutators (and hence the notes)
    only run under engine-exclusive mode.
    """

    LOG_MIN = 1024  # always allow at least this many deltas
    LOG_FRAC = 0.02  # rebuild once deltas exceed this fraction of base

    def __init__(self, fields: tuple[str, ...]):
        self.fields = fields
        self._gen = -1  # generation of the BASE arrays
        self._order: np.ndarray | None = None  # rowids sorted by key
        self._keys: np.ndarray | None = None  # sorted memcomparable keys (object/bytes)
        # delta log: (key_bytes, rowid, is_add), in mutation order
        self._log: list[tuple[bytes, int, bool]] = []
        self._log_broken = False
        self._tracked_gen = -1  # generation the log brings the base up to
        # replay cache for generation _cache_gen:
        # (add_keys, add_rows, del_keys, del_rows, del_set)
        self._cache_gen = -2
        self._cache = None
        self._merged_gen = -2
        self._merged: np.ndarray | None = None
        self._merged_keys: np.ndarray | None = None
        self._desc_gen = -2  # group-reversed ordered_rows cache
        self._desc: np.ndarray | None = None
        self._build_lock = threading.Lock()

    @staticmethod
    def _encode(v) -> bytes:
        from ..utils import memcomparable as mc

        if v is NULL_KEY:
            return mc.encode_value(None)
        if isinstance(v, np.bool_):
            v = bool(v)
        elif isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        elif isinstance(v, np.str_):
            v = str(v)
        try:
            return mc.encode_value(v)
        except TypeError:
            return mc.encode_value(str(v))

    def key_of(self, record: dict) -> bytes:
        """Concatenated memcomparable key of this record's index fields —
        byte-identical to what _build produces for the same values."""
        return b"".join(self._encode(record.get(f)) for f in self.fields)

    @staticmethod
    def _pk_sortable(store: ColumnStore, rows: np.ndarray):
        """pk values of `rows` as a numpy-sortable array (int64 direct;
        str pks as 'U'), or None for exotic pk types."""
        col = store.pk_col
        if col.np_type is not None:
            return col.data[rows]
        v = col.data[rows].tolist()
        if all(isinstance(x, str) for x in v):
            return np.asarray(v, dtype="U")
        return None

    def _build(self, store: ColumnStore):
        from ..native import get as get_native

        rows = np.flatnonzero(store.valid_view())
        sorted_keys = None
        if len(rows):
            # pre-order candidates by PK: the stable key sort then leaves
            # every equal-key tie group in pk-ASC order — the index tie
            # contract cursor pagination depends on (rowid/arrival order
            # diverges from pk order after rowid reuse)
            pkv = self._pk_sortable(store, rows)
            if pkv is not None:
                rows = rows[np.argsort(pkv, kind="stable")]
            cols = [store.column_view(f)[rows] for f in self.fields]
            native = get_native()
            if native is not None and hasattr(native, "mc_sort_rows"):
                # fused encode + stable sort: the numpy object-dtype argsort's
                # per-comparison PyBytes dispatch dominated the cold build
                # (measured 2M rows: 1.9 s encode+argsort -> C++ one-pass)
                try:
                    ks, order_buf = native.mc_sort_rows([c.tolist() for c in cols])
                    sorted_keys = np.asarray(ks, dtype=object)
                    order = np.frombuffer(order_buf, np.int64)
                except (TypeError, OverflowError):
                    native = None
            if sorted_keys is None:
                if native is not None:
                    try:
                        keys = np.asarray(
                            native.mc_encode_rows([c.tolist() for c in cols]),
                            dtype=object,
                        )
                    except (TypeError, OverflowError):
                        native = None
                if native is None:
                    keys = np.asarray(
                        [
                            b"".join(self._encode(c[j]) for c in cols)
                            for j in range(len(rows))
                        ],
                        dtype=object,
                    )
                order = np.argsort(keys, kind="stable")
        else:
            keys = np.zeros(0, dtype=object)
            order = np.zeros(0, np.int64)
        self._order = rows[order]
        if sorted_keys is not None:
            self._keys = sorted_keys
        else:
            self._keys = keys[order] if len(rows) else keys
        self._log.clear()
        self._log_broken = False
        self._cache_gen = -2
        self._cache = None
        self._merged_gen = -2
        self._merged = None
        self._merged_keys = None
        self._desc_gen = -2
        self._desc = None
        self._tracked_gen = store.generation
        self._gen = store.generation  # published LAST (see _build_lock doc)

    # --- mutation notes (engine-EXCLUSIVE mode only) -------------------------

    def invalidate(self):
        """Force the next read to rebuild (clear/restore/migration)."""
        self._log_broken = True
        self._log.clear()
        # clear()/restore RESET store.generation, so a later mutation count
        # can catch back up to the old build generation — the base must
        # never satisfy _ensure's `_gen == generation` check again
        self._gen = -1

    def _advance(self, store: ColumnStore) -> bool:
        """Track one store mutation. Returns True when the delta log may
        accept entries for it; marks the log broken on any generation gap
        (an untracked mutation slipped in between)."""
        g = store.generation
        prev = self._tracked_gen
        self._tracked_gen = g
        if self._order is None or self._log_broken:
            return False
        if g != prev + 1:
            self.invalidate()
            return False
        return True

    def _room_for(self, n: int) -> bool:
        if len(self._log) + n > max(self.LOG_MIN, int(self.LOG_FRAC * len(self._order))):
            self.invalidate()
            return False
        return True

    def note_noop(self, store: ColumnStore):
        """This index's fields were untouched by the mutation."""
        self._advance(store)

    def note_insert(self, store: ColumnStore, rowid: int, record: dict):
        if self._advance(store) and self._room_for(1):
            self._log.append((self.key_of(record), int(rowid), True))
            self._cache_gen = -2

    def note_delete(self, store: ColumnStore, rowid: int, old: dict):
        if self._advance(store) and self._room_for(1):
            self._log.append((self.key_of(old), int(rowid), False))
            self._cache_gen = -2

    def note_update(self, store: ColumnStore, rowid: int, old: dict, new: dict):
        if self._advance(store) and self._room_for(2):
            self._log.append((self.key_of(old), int(rowid), False))
            self._log.append((self.key_of(new), int(rowid), True))
            self._cache_gen = -2

    def note_bulk(self, store: ColumnStore, rowids, records_or_none):
        """Bulk insert (records list) — or None to just invalidate when
        the batch is bigger than the log budget."""
        if not self._advance(store):
            return
        if records_or_none is None:
            self.invalidate()
            return
        if not self._room_for(len(rowids)):
            return  # _room_for marked the log broken
        for r, rec in zip(rowids, records_or_none):
            self._log.append((self.key_of(rec), int(r), True))
        self._cache_gen = -2

    def note_bulk_delete(self, store: ColumnStore, rowids, olds_or_none):
        """Bulk delete (per-row old key dicts) — or None to invalidate
        when the batch exceeds the log budget."""
        if not self._advance(store):
            return
        if olds_or_none is None:
            self.invalidate()
            return
        if not self._room_for(len(rowids)):
            return
        for r, old in zip(rowids, olds_or_none):
            self._log.append((self.key_of(old), int(r), False))
        self._cache_gen = -2

    def note_bulk_update(self, store: ColumnStore, rowids, olds, news):
        """Bulk patch of existing rows; olds/news are per-row dicts of
        this index's fields (olds=None to just invalidate)."""
        if not self._advance(store):
            return
        if olds is None:
            self.invalidate()
            return
        if not self._room_for(2 * len(rowids)):
            return
        for r, o, nw in zip(rowids, olds, news):
            self._log.append((self.key_of(o), int(r), False))
            self._log.append((self.key_of(nw), int(r), True))
        self._cache_gen = -2

    # --- read-side state ------------------------------------------------------

    def _ensure(self, store: ColumnStore):
        """Returns the delta cache (add_keys, add_rows, del_keys, del_rows,
        del_set) or None when the base alone is current."""
        g = store.generation
        if self._gen == g:
            return None
        if (
            not self._log_broken
            and self._tracked_gen == g
            and self._order is not None
        ):
            if self._cache_gen == g:
                return self._cache
            with self._build_lock:
                if self._gen == store.generation:
                    return None  # another thread rebuilt
                if self._cache_gen == store.generation:
                    return self._cache
                return self._replay(store, store.generation)
        with self._build_lock:
            g = store.generation
            if self._gen == g:
                return None
            if (
                not self._log_broken
                and self._tracked_gen == g
                and self._order is not None
            ):
                if self._cache_gen == g:
                    return self._cache
                return self._replay(store, g)
            self._build(store)
            return None

    def _replay(self, store: ColumnStore, g: int):
        """Fold the ordered log into (pending adds, base deletions).
        Correct under rowid reuse: a remove cancels a pending add of the
        same rowid; otherwise it tombstones the base row. Adds sort by
        (key, pk) — the index-wide tie contract (_build)."""
        adds: dict[int, bytes] = {}
        dels: dict[int, bytes] = {}
        for key, row, is_add in self._log:
            if is_add:
                adds[row] = key
            elif row in adds:
                del adds[row]
            else:
                dels[row] = key
        items = sorted(
            adds.items(), key=lambda kv: (kv[1], store.pk_col.get(int(kv[0])))
        )
        ak = np.asarray([k for _, k in items], dtype=object)
        ar = np.asarray([r for r, _ in items], dtype=np.int64)
        dk = np.asarray(list(dels.values()), dtype=object)
        dr = np.asarray(list(dels.keys()), dtype=np.int64)
        if len(dk):
            o = np.argsort(dk, kind="stable")
            dk, dr = dk[o], dr[o]
        cache = (ak, ar, dk, dr, frozenset(dels))
        self._cache = cache
        self._merged_gen = -2
        self._merged = None
        self._merged_keys = None
        self._desc_gen = -2
        self._desc = None
        self._cache_gen = g  # published last
        return cache

    @staticmethod
    def _count_in(keys: np.ndarray, kl: bytes | None, kh: bytes | None) -> int:
        lo = 0 if kl is None else int(np.searchsorted(keys, kl, side="left"))
        hi = (
            len(keys)
            if kh is None
            else int(np.searchsorted(keys, kh, side="left"))
        )
        return max(0, hi - lo)

    def span_count(self, store: ColumnStore, span) -> int:
        """EXACT live-row count for a span — the cost model input."""
        a, b, kl, kh = span
        d = self._ensure(store)
        base = b - a
        if d is None:
            return base
        ak, _, dk, _, _ = d
        return base - self._count_in(dk, kl, kh) + self._count_in(ak, kl, kh)

    @staticmethod
    def _group_reverse(rows: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Key-DESC view of an ASC (rows, keys) pair: reverse the order of
        equal-key GROUPS while preserving intra-group order — ties keep the
        same relative order as the ASC path, and NULL keys (which sort
        first ASC, memcomparable tag 0x01) land at the end, matching the
        sort path's nulls-first-asc / nulls-last-desc convention."""
        m = len(rows)
        if m <= 1:
            return rows
        change = np.r_[True, keys[1:] != keys[:-1]]
        gid = np.cumsum(change) - 1
        starts = np.flatnonzero(change)
        sizes = np.diff(np.r_[starts, m])
        elem_start = starts[gid]
        dest = (m - (elem_start + sizes[gid])) + (np.arange(m) - elem_start)
        out = np.empty(m, rows.dtype)
        out[dest] = rows
        return out

    def span_rows(
        self, store: ColumnStore, span, ordered: bool = False,
        desc: bool = False,
    ) -> np.ndarray:
        """Candidate rowids for a span. With `ordered=True` the result is in
        index-KEY order — pending delta adds are merge-inserted at their key
        position instead of concatenated (the executor's ordered-slice fast
        path pages the raw span, so appended-at-the-end delta rows would
        drop recently written rows from early pages and misorder late ones).
        `desc=True` (with ordered) returns the group-reversed key-DESC view.
        """
        a, b, kl, kh = span
        d = self._ensure(store)
        rows = self._order[a:b]
        need_keys = ordered and (desc or d is not None)
        keys = self._keys[a:b] if need_keys else None
        if d is not None:
            ak, ar, dk, dr, del_set = d
            if del_set and len(rows):
                keep = ~np.isin(rows, dr)
                rows = rows[keep]
                if need_keys:
                    keys = keys[keep]
            lo = 0 if kl is None else int(np.searchsorted(ak, kl, side="left"))
            hi = len(ak) if kh is None else int(np.searchsorted(ak, kh, side="left"))
            if hi > lo:
                if ordered:
                    pos = self._merge_positions(
                        store, keys, rows, ak[lo:hi], ar[lo:hi]
                    )
                    rows = np.insert(rows, pos, ar[lo:hi])
                    if desc:
                        keys = np.insert(keys, pos, ak[lo:hi])
                else:
                    rows = np.concatenate([rows, ar[lo:hi]])
        if ordered and desc:
            rows = self._group_reverse(rows, keys)
        return rows

    @staticmethod
    def _merge_positions(
        store: ColumnStore, keys: np.ndarray, rows: np.ndarray,
        ak: np.ndarray, ar: np.ndarray,
    ) -> np.ndarray:
        """Insert positions for (key,pk)-sorted delta adds against a
        key-sorted base whose equal-key ties are pk-ASC (_build): each add
        lands inside its tie group at its pk position, so merged order
        keeps the (key, pk) total order cursor pagination depends on.
        Equal positions preserve `ar` order (already pk-sorted)."""
        left = np.searchsorted(keys, ak, side="left")
        pos = np.searchsorted(keys, ak, side="right").astype(np.int64)
        pkc = store.pk_col
        for i in range(len(ak)):
            l, r = int(left[i]), int(pos[i])
            if l >= r:
                continue  # no base ties: position is exact already
            apk = pkc.get(int(ar[i]))
            while l < r:  # bisect the tie group by pk
                mid = (l + r) // 2
                if pkc.get(int(rows[mid])) > apk:
                    r = mid
                else:
                    l = mid + 1
            pos[i] = l
        return pos

    def ordered_rows(self, store: ColumnStore, desc: bool = False) -> np.ndarray:
        d = self._ensure(store)
        g = store.generation
        if d is None:
            order, keys = self._order, self._keys
        elif self._merged_gen == g:
            order, keys = self._merged, self._merged_keys
        else:
            with self._build_lock:
                if self._merged_gen == store.generation:
                    order, keys = self._merged, self._merged_keys
                else:
                    ak, ar, dk, dr, del_set = d
                    keys, order = self._keys, self._order
                    if del_set and len(order):
                        keep = ~np.isin(order, dr)
                        keys, order = keys[keep], order[keep]
                    if len(ak):
                        pos = self._merge_positions(store, keys, order, ak, ar)
                        order = np.insert(order, pos, ar)
                        keys = np.insert(keys, pos, ak)
                    self._merged = order
                    self._merged_keys = keys
                    self._merged_gen = store.generation  # published last
        if not desc:
            return order
        if self._desc_gen == g:
            return self._desc
        with self._build_lock:
            if self._desc_gen == store.generation:
                return self._desc
            rev = self._group_reverse(order, keys)
            self._desc = rev
            self._desc_gen = store.generation  # published last
            return rev

    # --- bisect spans ---------------------------------------------------------

    def _span(self, kl: bytes | None, kh: bytes | None):
        keys = self._keys
        a = 0 if kl is None else int(np.searchsorted(keys, kl, side="left"))
        b = len(keys) if kh is None else int(np.searchsorted(keys, kh, side="left"))
        return (a, max(a, b), kl, kh)

    def range_span(
        self, store: ColumnStore, lo=None, hi=None, lo_open=False, hi_open=False
    ):
        """Span of rows whose first key field lies within [lo, hi]; with
        deltas, span_count is still EXACT (reference cost_estimator.dart
        compares estimated plan costs; the sorted array + bounded delta
        bisects give the true selectivity for free)."""
        from ..utils import memcomparable as mc

        self._ensure(store)
        kl = kh = None
        if lo is not None:
            kl = self._encode(lo)
            if lo_open:
                kl = mc.prefix_upper_bound(kl)
        if hi is not None:
            kh = self._encode(hi)
            kh = kh if hi_open else mc.prefix_upper_bound(kh)
        return self._span(kl, kh)

    def range_span_multi(self, store: ColumnStore, eq_values: list, bounds=None):
        """Composite-prefix span: equality on the leading `eq_values`
        fields plus an optional (lo, hi, lo_open, hi_open) range on the
        NEXT field (reference query_optimizer.dart composite-index
        selection)."""
        from ..utils import memcomparable as mc

        self._ensure(store)
        prefix = b"".join(self._encode(v) for v in eq_values)
        if bounds is None:
            return self._span(prefix, mc.prefix_upper_bound(prefix))
        lo, hi, lo_open, hi_open = bounds
        if lo is not None:
            kl = prefix + self._encode(lo)
            if lo_open:
                kl = mc.prefix_upper_bound(kl)
        else:
            kl = prefix
        if hi is not None:
            kh = prefix + self._encode(hi)
            kh = kh if hi_open else mc.prefix_upper_bound(kh)
        else:
            kh = mc.prefix_upper_bound(prefix)
        return self._span(kl, kh)

    def prefix_span_multi(
        self, store: ColumnStore, eq_values: list, text_prefix: str
    ):
        """Span of rows whose next-field TEXT value starts with
        `text_prefix`, after an equality prefix — the LIKE 'abc%' index
        arm (reference searchIndex prefix scans, index_manager.dart:3299).
        The memcomparable text encoding is escape-stable, so the encoded
        prefix (type tag + escaped utf8, NO terminator) is a byte-prefix
        of exactly the matching keys."""
        from ..utils import memcomparable as mc

        self._ensure(store)
        base = b"".join(self._encode(v) for v in eq_values)
        kp = (
            base + b"\x06"
            + text_prefix.encode().replace(b"\x00", b"\x00\xff")
        )
        return self._span(kp, mc.prefix_upper_bound(kp))

    # --- compatibility helpers (tests / tools) --------------------------------

    def range_rows(self, store: ColumnStore, lo=None, hi=None, lo_open=False, hi_open=False):
        """Rows whose first key field lies within [lo, hi]."""
        return self.span_rows(store, self.range_span(store, lo, hi, lo_open, hi_open))


def _sharded(mesh) -> bool:
    """A mesh of more than one cell asks for the sharded indexes."""
    return mesh is not None and len(mesh.devices.flat) > 1


def _sharded_dtype(precision: str) -> str:
    return precision if precision in ("bfloat16", "int8") else "float32"


def _make_vector_index(dims: int, precision: str, idx: IndexSchema, mesh=None, *, device):
    # the corpus allocates at the first row: touch the device now, so that a
    # table declared on a device that is not there raises torch's own error
    # when it is declared, not at some later write
    torch.empty(0, device=mesh.device if _sharded(mesh) else device)
    cfg = idx.vector_config
    metric = cfg.metric.kernel_name
    vi = _make_vector_index_inner(dims, precision, cfg, metric, mesh, device)
    vi.search_mode = cfg.search_mode  # 'auto' | 'exact' default per index
    return vi


def _make_vector_index_inner(dims, precision, cfg, metric, mesh, device):
    if _sharded(mesh):
        # mesh-striped corpus (parallel/)
        dtype = _sharded_dtype(precision)
        if cfg.index_type.value in ("ivf", "ngh"):
            from ..parallel.sharded_ivf import ShardedIVFIndex

            sivf = ShardedIVFIndex(
                dims, mesh, metric=metric, dtype=dtype,
                num_clusters=cfg.num_clusters, nprobe=cfg.nprobe,
                pq_subspaces=cfg.pq_subspaces, pq_centroids=cfg.pq_centroids,
                rerank_factor=cfg.rerank_factor, pq_rerank=cfg.pq_rerank,
            )
            # engine-owned: growth retrains + compactions run off-lock in
            # background maintenance (Database.run_vector_maintenance)
            sivf.defer_retrain = True
            return sivf
        from ..parallel.sharded import ShardedFlatIndex

        return ShardedFlatIndex(dims, mesh, metric=metric, dtype=dtype)
    if cfg.index_type.value in ("ivf", "ngh"):
        ivf = IVFVectorIndex(
            dims,
            metric=metric,
            precision=precision,
            num_clusters=cfg.num_clusters,
            nprobe=cfg.nprobe,
            pq_subspaces=cfg.pq_subspaces,
            pq_centroids=cfg.pq_centroids,
            rerank_factor=cfg.rerank_factor,
            pq_residual=cfg.pq_residual,
            pq_rerank=cfg.pq_rerank,
            device=device,
        )
        # engine-owned: growth retrains run in background maintenance
        # (Database.run_vector_maintenance) instead of the write path
        ivf.defer_retrain = True
        return ivf
    return FlatVectorIndex(dims, metric=metric, precision=precision, device=device)


def filterable_fields(schema: TableSchema) -> tuple[str, ...]:
    """Fields that mirror into device filter columns (vector/filters.py)."""
    return tuple(
        f.name
        for f in schema.fields
        if f.type in (DataType.integer, DataType.bigInt, DataType.double,
                      DataType.boolean, DataType.datetime)
    )


class Table:
    def __init__(self, schema: TableSchema, node_id: int = 0, mesh=None, *, device):
        self.schema = schema
        self.store = ColumnStore(schema)
        self.store.ensure_column(INGEST_TS_FIELD, DataType.datetime)
        self.node_id = node_id
        self.mesh = mesh
        self.device = device  # where this table's vector corpora live

        pk = schema.primary_key
        self._known_fields = frozenset(f.name for f in schema.fields) | {pk.name}
        self._seq = SequentialIdGenerator(pk.initial_value, pk.increment)
        self._timegen = (
            TimeBasedIdGenerator(pk.type.value, node_id)
            if pk.type in (PrimaryKeyType.timestampBased, PrimaryKeyType.datePrefixed, PrimaryKeyType.shortCode)
            else None
        )

        # unique maps: field/index-name -> {key: pk} (+ cached constraint
        # specs — schema accessors rebuild lists per call, too hot for the
        # per-record write path)
        self.unique_maps: dict[str, dict] = {f: {} for f in schema.unique_fields()}
        for idx in schema.btree_indexes():
            if idx.unique:
                self.unique_maps[idx.index_name] = {}
        self._unique_field_names = tuple(schema.unique_fields())
        self._unique_index_specs = tuple(
            (idx.index_name, idx.fields) for idx in schema.btree_indexes() if idx.unique
        )
        self.sorted_indexes: dict[str, SortedIndex] = {
            idx.index_name: SortedIndex(idx.fields) for idx in schema.btree_indexes()
        }

        # vector indexes + buffered writes (field -> {pk: vec|None})
        self.vector_indexes: dict[str, Any] = {}
        self._vec_pending: dict[str, dict] = {}
        # monotonic ts of the OLDEST unflushed stage per field (bounded-
        # staleness contract: searches may skip a contended flush until
        # the pending batch exceeds an age/row bound — database.py)
        self._vec_pend_since: dict[str, float] = {}
        # device-resident predicate columns (vector/filters.py): numeric/
        # bool/datetime fields mirror into slot-aligned f32 device arrays
        # (owned by each index's corpus) so hybrid search masks compile on
        # device instead of being uploaded per query
        self.filter_fields: tuple[str, ...] = ()
        self._filter_pending: dict[str, dict] = {}  # vfield -> {pk: {f: val}}
        for idx in schema.vector_indexes():
            field = idx.fields[0]
            fs = schema.field_map[field]
            vc = fs.vector_config
            self.vector_indexes[field] = _make_vector_index(
                vc.dimensions, vc.precision.value, idx, mesh, device=device
            )
            self._vec_pending[field] = {}
            self._filter_pending[field] = {}
        if self.vector_indexes:
            self.filter_fields = filterable_fields(schema)

    # --- validation ------------------------------------------------------------

    def generate_pk(self):
        t = self.schema.primary_key.type
        if t == PrimaryKeyType.sequential:
            return self._seq.next()
        if t == PrimaryKeyType.none:
            raise ValidationError(
                f"table {self.schema.name!r}: primary key must be supplied (type none)"
            )
        return self._timegen.next()

    def validate(self, data: dict, is_insert: bool) -> dict:
        """Type/constraint validation + defaults. Returns a clean record
        (without PK). Reference: _validateAndProcessData dsi:1562 +
        record_compute.dart batches."""
        known = self._known_fields
        for k in data:  # cheaper than building set differences per record
            if k not in known:
                raise ValidationError(
                    f"table {self.schema.name!r}: unknown fields "
                    f"{sorted(set(data) - known)}"
                )
        out = {}
        for f in self.schema.fields:
            name = f.name
            present = name in data
            v = data.get(name)
            if not present and is_insert:
                v = f.default_value
                if isinstance(v, Expr):  # e.g. default_value=Expr.now()
                    v = v.evaluate({}, True)
            if v is None:
                if not f.nullable and is_insert:
                    raise ValidationError(f"field {name!r} is not nullable")
                if present or is_insert:
                    out[name] = None
                continue
            out[name] = self._coerce(f, v)
        return out

    def _coerce(self, f, v):
        t = f.type
        try:
            if t in (DataType.integer, DataType.bigInt):
                if isinstance(v, bool):
                    raise ValidationError(f"field {f.name!r}: bool is not an integer")
                v = int(v)
            elif t == DataType.double:
                v = float(v)
            elif t == DataType.boolean:
                if not isinstance(v, bool):
                    raise ValidationError(f"field {f.name!r}: expected boolean")
            elif t == DataType.text:
                v = str(v)
                if f.max_length is not None and len(v) > f.max_length:
                    raise ValidationError(f"field {f.name!r}: exceeds max_length")
            elif t == DataType.blob:
                if not isinstance(v, (bytes, bytearray)):
                    raise ValidationError(f"field {f.name!r}: expected bytes")
                v = bytes(v)
            elif t == DataType.datetime:
                if isinstance(v, (int, float)):
                    v = int(v)
                else:
                    raise ValidationError(f"field {f.name!r}: datetime must be epoch ms")
            elif t == DataType.array:
                if not isinstance(v, (list, tuple)):
                    raise ValidationError(f"field {f.name!r}: expected array")
                v = list(v)
            elif t == DataType.json:
                if not isinstance(v, (dict, list, str, int, float, bool)):
                    raise ValidationError(f"field {f.name!r}: not JSON-serializable")
            elif t == DataType.vector:
                # keep vectors as f32 ndarrays end to end (cells, WAL,
                # snapshots): the native codec serializes them verbatim.
                # np.array (not asarray) detaches from the caller's buffer
                # so later caller mutations cannot skew the WAL record.
                arr = np.array(v, np.float32)
                if arr.ndim != 1 or arr.shape[0] != f.vector_config.dimensions:
                    raise ValidationError(
                        f"field {f.name!r}: expected {f.vector_config.dimensions}-d vector"
                    )
                v = arr
        except (TypeError, ValueError) as e:
            if isinstance(e, ValidationError):
                raise
            raise ValidationError(f"field {f.name!r}: cannot coerce {v!r} to {t.value}") from e
        if f.min_value is not None and isinstance(v, (int, float)) and v < f.min_value:
            raise ValidationError(f"field {f.name!r}: below min_value {f.min_value}")
        if f.max_value is not None and isinstance(v, (int, float)) and v > f.max_value:
            raise ValidationError(f"field {f.name!r}: above max_value {f.max_value}")
        return v

    def validate_batch(self, records: list[dict]) -> tuple[dict, dict]:
        """Vectorized batch validation: one type-scan pass per FIELD instead
        of one _coerce call per cell (reference record_compute.dart isolate
        batches). Returns (col_values, errors): col_values[field] is an
        n-list of coerced values (entries at failed indexes unspecified),
        errors maps record index -> message. Semantics identical to
        validate(..., is_insert=True) per record."""
        errors: dict[int, str] = {}
        known = self._known_fields
        # unknown-field scan — consecutive records usually share a key tuple
        prev_keys: tuple | None = None
        for i, r in enumerate(records):
            kt = tuple(r)
            if kt == prev_keys:
                continue
            if all(k in known for k in kt):
                prev_keys = kt
            else:
                errors[i] = (
                    f"table {self.schema.name!r}: unknown fields "
                    f"{sorted(set(r) - known)}"
                )
        cols: dict[str, list] = {}
        for f in self.schema.fields:
            cols[f.name] = self._coerce_column(f, records, errors)
        return cols, errors

    def _coerce_column(self, f, records: list[dict], errors: dict[int, str]) -> list:
        name = f.name
        default = f.default_value
        if isinstance(default, Expr):
            default = default.evaluate({}, True)
        vals = [r.get(name, default) for r in records]
        if not f.nullable and any(v is None for v in vals):
            for i, v in enumerate(vals):
                if v is None:
                    errors.setdefault(i, f"field {name!r} is not nullable")
        ts = set(map(type, vals))
        ts.discard(type(None))
        t = f.type
        unbounded = f.min_value is None and f.max_value is None
        # all-same-type fast paths: the whole column is already clean
        if unbounded:
            if t in (DataType.integer, DataType.bigInt, DataType.datetime):
                if ts <= {int}:  # bool is type bool, never in this set
                    return vals
            elif t == DataType.text:
                if ts <= {str} and (
                    f.max_length is None
                    or all(len(v) <= f.max_length for v in vals if v is not None)
                ):
                    return vals
            elif t == DataType.double:
                if ts <= {float}:
                    return vals
                if ts <= {int, float}:
                    return [None if v is None else float(v) for v in vals]
        if t == DataType.boolean and ts <= {bool}:
            return vals
        if t == DataType.json and ts <= {dict, list, str, int, float, bool}:
            return vals
        if t == DataType.array and ts <= {list}:
            return vals
        if t == DataType.blob and ts <= {bytes}:
            return vals
        # generic per-value fallback (mixed types / vectors / bounds)
        out = []
        for i, v in enumerate(vals):
            if v is None:
                out.append(None)
                continue
            try:
                out.append(self._coerce(f, v))
            except ValidationError as e:
                errors.setdefault(i, str(e))
                out.append(None)
        return out

    def bulk_apply_insert_cols(self, pks: list, col_values: dict[str, list]):
        """Columnar insert of pre-validated, all-new records from column
        value lists (no per-record dicts anywhere on the path)."""
        now = int(time.time() * 1000)
        int_pks = [p for p in pks if isinstance(p, int) and not isinstance(p, bool)]
        if int_pks:
            self._seq.observe(max(int_pks))
        col_values = dict(col_values)
        col_values[INGEST_TS_FIELD] = [now] * len(pks)
        rowids = self.store.bulk_insert(pks, col_values)
        self._note_indexes_insert(rowids, col_values)
        # unique maps: one zip pass per constraint instead of a per-record
        # dict + _unique_apply call (measured hot in 200k-row batches)
        for f in self._unique_field_names:
            vals = col_values.get(f)
            if vals is not None:
                self.unique_maps[f].update(
                    (v, pk) for v, pk in zip(vals, pks) if v is not None
                )
        for name, fields in self._unique_index_specs:
            cols = [col_values.get(x) for x in fields]
            if any(c is None for c in cols):
                continue
            m = self.unique_maps[name]
            for pk, key in zip(pks, zip(*cols)):
                if None not in key:
                    m[key] = pk
        for field in self.vector_indexes:
            vals = col_values.get(field)
            if vals is not None:
                pend = self._vec_pending[field]
                self._vec_pend_since.setdefault(field, time.monotonic())
                for pk, v in zip(pks, vals):
                    pend[pk] = None if v is None else np.asarray(v, np.float32)
        if self.filter_fields:
            fcols = {
                f: col_values[f]
                for f in self.filter_fields
                if col_values.get(f) is not None
            }
            if fcols:
                for vf in self.vector_indexes:
                    fp = self._filter_pending[vf]
                    self._vec_pend_since.setdefault(vf, time.monotonic())
                    for j, pk in enumerate(pks):
                        fp.setdefault(pk, {}).update(
                            {f: c[j] for f, c in fcols.items()}
                        )

    # --- unique enforcement ---------------------------------------------------------

    def _unique_entries(self, pk, record: dict):
        """Yield (map_name, key) pairs for this record's unique constraints."""
        for f in self._unique_field_names:
            v = record.get(f)
            if v is not None:
                yield f, v
        for name, fields in self._unique_index_specs:
            key = tuple(record.get(x) for x in fields)
            if any(k is None for k in key):
                continue
            yield name, key

    def check_unique(self, pk, record: dict, old: dict | None = None):
        for name, key in self._unique_entries(pk, record):
            holder = self.unique_maps[name].get(key)
            if holder is not None and holder != pk:
                fields = name if name in self.schema.field_map else name
                raise UniqueViolation(self.schema.name, fields, key)

    def _unique_apply(self, pk, record: dict, old: dict | None):
        if old is not None:
            for name, key in self._unique_entries(pk, old):
                if self.unique_maps[name].get(key) == pk:
                    del self.unique_maps[name][key]
        for name, key in self._unique_entries(pk, record):
            self.unique_maps[name][key] = pk

    # --- mutation (called by Database under WAL) -----------------------------------

    def bulk_apply_insert(self, pks: list, records: list[dict]):
        """Columnar insert of pre-validated, all-new records (caller ran
        validate + unique checks). One pass per column; unique maps and
        vector staging update in bulk."""
        now = int(time.time() * 1000)
        # keep generated keys ahead of user-supplied ones (observe the max
        # once — one lock acquisition instead of one per record)
        int_pks = [p for p in pks if isinstance(p, int) and not isinstance(p, bool)]
        if int_pks:
            self._seq.observe(max(int_pks))
        col_values = {
            name: [rec.get(name) for rec in records] for name in self.store.columns
        }
        col_values[INGEST_TS_FIELD] = [now] * len(pks)
        rowids = self.store.bulk_insert(pks, col_values)
        self._note_indexes_insert(rowids, col_values)
        for pk, rec in zip(pks, records):
            self._unique_apply(pk, rec, None)
            self._vector_stage(pk, rec)

    def bulk_apply_delete(self, pks: list, need_olds: bool = False):
        """Columnar delete — the batch analogue of apply_delete. The
        caller gates FK involvement (no referencing tables) and handles
        WAL/notifications. Returns (deleted_pks, old records when
        `need_olds` — skipping materialization entirely otherwise)."""
        store = self.store
        kept: list = []
        rows: list[int] = []
        seen: set = set()  # a duplicate pk would double-free its rowid
        for pk in pks:
            if pk in seen:
                continue
            r = store.rowid(pk)
            if r is not None:
                seen.add(pk)
                kept.append(pk)
                rows.append(int(r))
        if not kept:
            return [], ([] if need_olds else None)
        rows_arr = np.asarray(rows, np.int64)
        olds = store.read_rows(rows_arr) if need_olds else None
        ufields = set(self._unique_field_names)
        for _, fl in self._unique_index_specs:
            ufields.update(fl)
        if ufields:
            views = {f: store.column_view(f) for f in ufields}
            for pk, r in zip(kept, rows):
                rec_u = {f: views[f][r] for f in ufields}
                for name, key in self._unique_entries(pk, rec_u):
                    if self.unique_maps[name].get(key) == pk:
                        del self.unique_maps[name][key]
        # capture old index keys BEFORE the store patch
        small = len(rows) <= SortedIndex.LOG_MIN
        caps: dict[str, list | None] = {}
        for name, sidx in self.sorted_indexes.items():
            if not small:
                caps[name] = None
                continue
            vws = {f: store.column_view(f) for f in sidx.fields}
            caps[name] = [
                {f: vws[f][r] for f in sidx.fields} for r in rows
            ]
        store.bulk_delete(kept, rows_arr)
        for name, sidx in self.sorted_indexes.items():
            sidx.note_bulk_delete(store, rows_arr, caps[name])
        for field in self.vector_indexes:
            self._vec_pend_since.setdefault(field, time.monotonic())
            pend = self._vec_pending[field]
            for pk in kept:
                pend[pk] = None
        return kept, olds

    def bulk_apply_update_cols(self, pks: list, rows, col_values: dict[str, list]):
        """Columnar update of pre-validated fields on existing rows — the
        batch analogue of apply_update. The caller guarantees existence and
        that no PK/unique/FK fields are touched (those need the general
        per-record path)."""
        rows_arr = np.asarray(rows, np.int64)
        captured = self._capture_index_olds(rows_arr, col_values)
        self.store.bulk_patch(rows, col_values)
        self._note_indexes_update(rows_arr, col_values, captured)
        touches_vec = any(f in col_values for f in self.vector_indexes)
        touches_filt = any(f in col_values for f in self.filter_fields)
        if touches_vec or touches_filt:
            names = list(col_values)
            for j, pk in enumerate(pks):
                self._vector_stage(
                    pk, {name: col_values[name][j] for name in names}
                )

    def apply_insert(self, pk, record: dict):
        if self.schema.primary_key.type == PrimaryKeyType.sequential:
            self._seq.observe(pk)
        if pk in self.store:
            raise UniqueViolation(self.schema.name, self.schema.primary_key.name, pk)
        self.check_unique(pk, record)
        self._unique_apply(pk, record, None)
        rec = dict(record)
        rec[INGEST_TS_FIELD] = rec.get(INGEST_TS_FIELD) or int(time.time() * 1000)
        rowid = self.store.upsert(pk, rec)
        for sidx in self.sorted_indexes.values():
            sidx.note_insert(self.store, rowid, rec)
        self._vector_stage(pk, record)

    def apply_update(self, pk, updates: dict) -> dict | None:
        old = self.store.get(pk)
        if old is None:
            return None
        new = {**old, **updates}
        self.check_unique(pk, new, old)
        self._unique_apply(pk, new, old)
        rowid = self.store.patch(pk, updates)
        for sidx in self.sorted_indexes.values():
            if any(f in updates for f in sidx.fields):
                sidx.note_update(self.store, rowid, old, new)
            else:
                sidx.note_noop(self.store)
        self._vector_stage(pk, updates)
        return old

    def apply_delete(self, pk) -> dict | None:
        old = self.store.get(pk)
        if old is None:
            return None
        for name, key in self._unique_entries(pk, old):
            if self.unique_maps[name].get(key) == pk:
                del self.unique_maps[name][key]
        rowid = self.store.rowid(pk)
        self.store.delete(pk)
        for sidx in self.sorted_indexes.values():
            sidx.note_delete(self.store, rowid, old)
        for field in self.vector_indexes:
            self._vec_pend_since.setdefault(field, time.monotonic())
            self._vec_pending[field][pk] = None
        return old

    def apply_clear(self):
        self.store.clear()
        self.store.ensure_column(INGEST_TS_FIELD, DataType.datetime)
        for sidx in self.sorted_indexes.values():
            sidx.invalidate()
        for m in self.unique_maps.values():
            m.clear()
        for idx in self.schema.vector_indexes():
            field = idx.fields[0]
            fs = self.schema.field_map[field]
            self.vector_indexes[field] = _make_vector_index(
                fs.vector_config.dimensions, fs.vector_config.precision.value, idx, self.mesh,
                device=self.device,
            )
            self._vec_pending[field] = {}
            self._filter_pending[field] = {}

    def _note_indexes_insert(self, rowids, col_values: dict):
        """Feed a bulk insert to every sorted index's delta log (or
        invalidate when the batch exceeds the log budget — the rebuild
        then amortizes over the batch, exactly like before)."""
        small = len(rowids) <= SortedIndex.LOG_MIN
        for sidx in self.sorted_indexes.values():
            if not small:
                sidx.note_bulk(self.store, rowids, None)
                continue
            cols = [col_values.get(f) for f in sidx.fields]
            recs = [
                {f: (c[j] if c is not None else None)
                 for f, c in zip(sidx.fields, cols)}
                for j in range(len(rowids))
            ]
            sidx.note_bulk(self.store, rowids, recs)

    def _capture_index_olds(self, rows_arr, col_values: dict) -> dict:
        """Pre-patch snapshot of the OLD key-field values for every index
        whose fields a bulk update touches (removals need the old key)."""
        captured: dict[str, list | None] = {}
        small = len(rows_arr) <= SortedIndex.LOG_MIN
        for name, sidx in self.sorted_indexes.items():
            if not any(f in col_values for f in sidx.fields):
                continue
            if not small:
                captured[name] = None
                continue
            views = {f: self.store.column_view(f) for f in sidx.fields}
            captured[name] = [
                {f: views[f][r] for f in sidx.fields} for r in rows_arr
            ]
        return captured

    def _note_indexes_update(self, rows_arr, col_values: dict, captured: dict):
        for name, sidx in self.sorted_indexes.items():
            if name not in captured:
                sidx.note_noop(self.store)
                continue
            olds = captured[name]
            if olds is None:
                sidx.note_bulk_update(self.store, rows_arr, None, None)
                continue
            news = [
                {
                    f: (col_values[f][j] if f in col_values else olds[j][f])
                    for f in sidx.fields
                }
                for j in range(len(rows_arr))
            ]
            sidx.note_bulk_update(self.store, rows_arr, olds, news)

    def _vector_stage(self, pk, record: dict):
        for field in self.vector_indexes:
            if field in record:
                v = record[field]
                self._vec_pend_since.setdefault(field, time.monotonic())
                self._vec_pending[field][pk] = (
                    None if v is None else np.asarray(v, np.float32)
                )
        if self.filter_fields:
            touched = {f: record[f] for f in self.filter_fields if f in record}
            if touched:
                for vf in self.vector_indexes:
                    self._vec_pend_since.setdefault(vf, time.monotonic())
                    self._filter_pending[vf].setdefault(pk, {}).update(touched)

    # --- vector flush + search ----------------------------------------------------

    def flush_vectors(self, field: str | None = None):
        """Apply buffered vector writes to device indexes in batches — the
        engine analogue of the reference flush fan-out into
        VectorIndexManager.writeChanges (im:3123)."""
        fields = [field] if field else list(self.vector_indexes)
        for f in fields:
            pend = self._vec_pending.get(f)
            fpend_peek = self._filter_pending.get(f)
            if not pend and not fpend_peek:
                continue  # nothing buffered: skip the write lock entirely
            idx = self.vector_indexes[f]
            with rw(idx).write():  # wait out in-flight off-lock searches
                self._flush_one(f, idx)
            self._vec_pend_since.pop(f, None)

    def vec_pending_count(self, field: str) -> int:
        return len(self._vec_pending.get(field) or ()) + len(
            self._filter_pending.get(field) or ()
        )

    def vec_pending_age(self, field: str) -> float:
        since = self._vec_pend_since.get(field)
        return 0.0 if since is None else time.monotonic() - since

    def _flush_one(self, f: str, idx):
        pend = self._vec_pending.get(f)
        if pend:
            dels = [pk for pk, v in pend.items() if v is None]
            ups = [(pk, v) for pk, v in pend.items() if v is not None]
            if dels:
                idx.delete(dels)
            if ups:
                idx.upsert([pk for pk, _ in ups], np.stack([v for _, v in ups]))
            pend.clear()
        fpend = self._filter_pending.get(f)
        if fpend:
            c = idx.corpus
            fc = c.filter_columns
            pks = list(fpend)
            slots = c.slots_for_pks(pks)
            by_field: dict[str, tuple[list, list]] = {}
            for pk, slot in zip(pks, slots):
                if slot < 0:
                    continue  # no vector for this pk (null vector field)
                for fname, val in fpend[pk].items():
                    s, v = by_field.setdefault(fname, ([], []))
                    s.append(slot)
                    v.append(val)
            int_kinds = (DataType.integer, DataType.bigInt, DataType.datetime)
            for fname, (s, v) in by_field.items():
                kind = (
                    "int"
                    if self.schema.field_map[fname].type in int_kinds
                    else "float"
                )
                fc.update(fname, np.asarray(s, np.int64), v, c.capacity, kind=kind)
            if by_field and hasattr(idx, "_mutations"):
                # filter columns are part of the corpus an off-lock
                # rebuild captures: invalidate in-flight RCU builds
                idx._mutations += 1
            fpend.clear()

    def vector_index_for(self, field: str):
        idx = self.vector_indexes.get(field)
        if idx is None:
            raise ValidationError(
                f"no vector index on {self.schema.name}.{field}"
            )
        return idx

    def slot_mask_from_pks(self, field: str, allowed_pks) -> np.ndarray:
        """Build a device-shaped slot mask from a host pk set (hybrid
        filtering bridge)."""
        idx = self.vector_index_for(field)
        c = idx.corpus
        mask = np.zeros(c.capacity, bool)
        slots = c.slots_for_pks(list(allowed_pks))
        mask[slots[slots >= 0]] = True
        return mask

    # --- maintenance -------------------------------------------------------------------

    def expired_pks(self, now_ms: int) -> list:
        """TTL scan (reference ttl_cleanup_manager.dart): rows whose source
        timestamp + ttl < now."""
        ttl = self.schema.ttl
        if not ttl or not ttl.enabled:
            return []
        field = ttl.source_field or INGEST_TS_FIELD
        col = self.store.column_view(field)
        valid = self.store.valid_view()
        cutoff = now_ms - int(ttl.ttl_seconds * 1000)
        if col.dtype == object:
            rows = [
                r
                for r in np.flatnonzero(valid)
                if col[r] is not None and col[r] <= cutoff
            ]
        else:
            rows = np.flatnonzero(valid & (col <= cutoff)).tolist()
        return [self.store.pk_col.get(r) for r in rows]

    # --- persistence ---------------------------------------------------------------------

    def state_dict(self) -> dict:
        self.flush_vectors()
        return {
            "schema": self.schema.to_json(),
            "store": self.store.state_dict(),
            "seq": self._seq.state(),
            "vector_indexes": {
                f: vi.state_dict() for f, vi in self.vector_indexes.items()
            },
        }

    @staticmethod
    def from_state_dict(d: dict, node_id: int = 0, mesh=None, *, device) -> "Table":
        schema = TableSchema.from_json(d["schema"])
        t = Table(schema, node_id, mesh, device=device)
        t.store = ColumnStore.from_state_dict(schema, d["store"])
        t.store.ensure_column(INGEST_TS_FIELD, DataType.datetime)
        t._seq.restore(d.get("seq", 1))
        # rebuild unique maps touching only the constrained fields (restores
        # must be O(rows x unique-fields), not O(cells))
        needed = set(t._unique_field_names)
        for _, fields in t._unique_index_specs:
            needed.update(fields)
        if needed:
            cols = {f: t.store.columns[f] for f in needed if f in t.store.columns}
            for pk, row in t.store._pk_row.items():
                rec = {f: c.get(row) for f, c in cols.items()}
                t._unique_apply(pk, rec, None)
        vstates = d.get("vector_indexes", {})
        for f, vs in vstates.items():
            if f in t.vector_indexes:
                mode = getattr(t.vector_indexes[f], "search_mode", "auto")
                t.vector_indexes[f] = _index_from_state(vs, mesh, device=device)
                # search_mode is schema config, not index state: carry the
                # schema-built default over the restored object
                t.vector_indexes[f].search_mode = mode
        return t


def _index_from_state(vs: dict, mesh=None, *, device):
    """Restore a vector index, converting between single-device (on
    `device`) and mesh-sharded layouts when the deployment changed across
    restarts."""
    vtype = vs.get("type", "flat")
    if _sharded(mesh):
        from ..parallel.sharded import ShardedFlatIndex
        from ..parallel.sharded_ivf import ShardedIVFIndex

        if vtype == "sharded_ivf":
            sivf = ShardedIVFIndex.from_state_dict(vs, mesh)
            sivf.defer_retrain = True  # engine-owned: background maintenance
            return sivf
        if vtype == "sharded_flat":
            return ShardedFlatIndex.from_state_dict(vs, mesh)
        # single-device snapshot -> sharded: stored rows are already in
        # storage space (normalized/padded), re-stripe them, preserving
        # the IVF configuration + centroids when the snapshot was IVF
        cs = vs["corpus"]
        vecs = np.asarray(cs["vectors"], np.float32)  # a BF16Array widens exactly
        if cs["precision"] == "int8":
            sc = cs.get("scales")
            if sc is not None:  # per-vector dequant factors
                vecs = vecs * np.asarray(sc, np.float32)[:, None]
            else:  # legacy global value/127 rule
                vecs = vecs / 127.0
        dtype = _sharded_dtype(cs["precision"])
        if vtype == "ivf":
            sh = ShardedIVFIndex(
                cs["dims"], mesh, vs["metric"], dtype,
                num_clusters=vs.get("num_clusters_cfg", 0),
                nprobe=vs.get("nprobe", 8),
                pq_subspaces=vs.get("pq_subspaces", 0),
                pq_centroids=vs.get("pq_centroids", 256),
                rerank_factor=vs.get("rerank_factor", 2),
                pq_rerank=vs.get("pq_rerank", 0),
            )
            orig_min = sh.min_train_size
            sh.min_train_size = 1 << 62
            try:
                if len(cs["pks"]):
                    sh.upsert(cs["pks"], vecs[:, : cs["dims"]], _prepped=vecs)
            finally:
                sh.min_train_size = orig_min
            if vs.get("centroids") is not None:
                # residual codebooks transfer across topologies (slice
                # centroids are duplicated CLUSTER centroids, the same
                # residual space); legacy raw-code books do not
                books = vs.get("pq") if vs.get("pq_residual", False) else None
                sh._install_centroids(
                    vs["centroids"], vs.get("trained_size", len(sh)), books)
            sh.defer_retrain = True  # engine-owned: background maintenance
            return sh
        sh = ShardedFlatIndex(cs["dims"], mesh, vs["metric"], dtype)
        if len(cs["pks"]):
            sh.upsert(cs["pks"], vecs[:, : cs["dims"]], _prepped=vecs)
        return sh
    vtype = vs.get("type", "flat")
    if vtype in ("sharded_flat", "sharded_ivf"):
        # sharded snapshot -> single device (IVF keeps its config/centroids)
        from ..parallel.sharded import state_vectors_f32

        vecs = state_vectors_f32(vs)
        if vtype == "sharded_ivf":
            ivf = IVFVectorIndex(
                vs["dims"], metric=vs["metric"], precision=vs["precision"],
                num_clusters=vs.get("num_clusters_cfg", 0),
                nprobe=vs.get("nprobe", 8),
                device=device,
            )
            ivf.defer_retrain = True  # engine-owned: background maintenance
            if len(vs["pks"]):
                slots = ivf.corpus.upsert(vs["pks"], vecs[:, : vs["dims"]])
                ivf.corpus.filter_columns.scatter(
                    vs.get("filter_columns", {}), slots, ivf.corpus.capacity
                )
            if vs.get("centroids") is not None:
                cents = np.asarray(vs["centroids"], np.float32)
                ivf.centroids = torch.tensor(cents, device=ivf.corpus.device)
                ivf._trained_size = vs.get("trained_size", len(ivf.corpus))
                ivf._rebuild_buckets()
            return ivf
        flat = FlatVectorIndex(
            vs["dims"], metric=vs["metric"], precision=vs["precision"], device=device
        )
        if len(vs["pks"]):
            slots = flat.corpus.upsert(vs["pks"], vecs[:, : vs["dims"]])
            flat.corpus.filter_columns.scatter(
                vs.get("filter_columns", {}), slots, flat.corpus.capacity
            )
        return flat
    cls = IVFVectorIndex if vtype == "ivf" else FlatVectorIndex
    idx = cls.from_state_dict(vs, device=device)
    if isinstance(idx, IVFVectorIndex):
        idx.defer_retrain = True  # engine-owned: background maintenance
    return idx
