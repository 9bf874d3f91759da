"""Database — the engine core orchestrator.

The re-design of the reference's `DataStoreImpl` (data_store_impl.dart:
7,736 LoC): instance lifecycle + recovery (:652-933), CRUD entry points
with validation/unique/FK pipeline (:1527-1794), batch ops (:3968),
transactions (:3534), vector search (:5849), KV ops (:5986), spaces
(:5873), backup/restore (:2253) and status (:986).

Concurrency model: one process-wide re-entrant lock guards base-store
access per OPERATION (the TPU engine is a single-controller design —
SURVEY.md §2.4 notes the reference's LockManager/WorkloadScheduler
machinery exists to arbitrate its own internal async tasks, which don't
exist here). Transactions BUFFER their writes in a per-thread overlay
(reference write_buffer_manager.dart) with op-time engine-wide unique-key
reservations (tryReserve, wbm:54-100), so concurrent readers and writers
proceed during an open transaction and see only committed state; the
transaction's own relational/KV reads merge its overlay (buffer-overlay
reads, query_executor.dart:2152); vector search reflects the committed,
flushed index (minus rows the txn deleted/rewrote) — buffered inserts
become searchable at commit, matching the reference's flush-deferred
vector index updates. Commit replays the op log under the lock —
after a first-committer-wins write-set validation when the isolation
level is `serializable` (the reference's SSI check,
transaction_manager.dart:30-36; `readCommitted` skips it) — and appends
one WAL group record, so a crash mid-transaction rolls back by
construction. Rollback just discards the buffer. DDL (create/drop/clear,
schema updates) is non-transactional and applies immediately.
"""

from __future__ import annotations

import contextlib
import itertools
import queue as _queue
import json
import os
import threading
import time
import uuid
import zipfile
from typing import Any, Callable

import numpy as np
import torch

from ..models.config import DataStoreConfig, GlobalConfig, IsolationLevel
from ..models.expr import Expr, resolve_expr_values
from ..models.results import (
    BusinessError,
    DbResult,
    ResultType,
    TransactionResult,
    UniqueViolation,
    VectorSearchResult,
)
from ..models.schema import DataType, ForeignKeyAction, TableSchema
from ..query.condition import QueryCondition
from ..query.executor import QueryExecutor, QuerySpec
from ..utils import codec
from ..utils.bf16 import BF16Array
from ..utils.logging import Logger
from ..utils.rwlock import ReadGuard, RWLock, WriteGuard, rw
from .table import INGEST_TS_FIELD, Table, ValidationError
from .wal import (
    SegmentedWalWriter,
    iter_wal_segments,
    list_segments,
    read_wal,
)

log = Logger("engine")

GLOBAL_SPACE = "global"
KV_TABLE = "_system_kv"
MIGRATIONS_TABLE = "_system_migrations"
SYSTEM_PREFIX = "_system_"

# engine on-disk format version + upgrade registry (reference upgrades/
# version_upgrade_manager.dart: v2/v3 upgrade steps run once at open).
# Upgrades map target_version -> fn(db); each runs inside open, in order.
ENGINE_VERSION = 1
UPGRADES: dict[int, Callable] = {}


class ChangeEvent:
    __slots__ = ("type", "space", "table", "pk", "record")

    def __init__(self, type_, space, table, pk, record=None):
        self.type = type_  # insert | update | delete | clear
        self.space = space
        self.table = table
        self.pk = pk
        self.record = record

    def __repr__(self):
        return f"ChangeEvent({self.type}, {self.table}, {self.pk})"


_STREAM_END = object()


class Subscription:
    """A change subscription: callback delivery, an event log, AND a
    stream surface — blocking sync iterator + async iterator (the
    reference watch() returns streams, data_store_impl.dart:6245)."""

    def __init__(self, db, key, callback):
        self._db = db
        self._key = key
        self.callback = callback
        self.events: list[ChangeEvent] = []
        self._queue: _queue.Queue = _queue.Queue()
        self._closed = False

    def _emit(self, ev: ChangeEvent):
        self.events.append(ev)
        self._queue.put(ev)
        if self.callback:
            self.callback(ev)

    def stream(self, timeout: float | None = None):
        """Blocking iterator of change events. Ends on cancel(); with
        `timeout`, also ends after that many seconds without an event."""
        while not self._closed:
            try:
                ev = self._queue.get(timeout=timeout)
            except _queue.Empty:
                return
            if ev is _STREAM_END:
                return
            yield ev

    def __iter__(self):
        return self.stream()

    async def _astream(self):
        import asyncio
        import functools

        loop = asyncio.get_running_loop()
        # BOUNDED get: an unbounded queue.get would park the executor
        # thread until the next event even after the async consumer is
        # cancelled (thread leak, VERDICT r2 Weak #7); with a poll window
        # the worker re-checks liveness and frees itself within 0.2 s
        get = functools.partial(self._queue.get, timeout=0.2)
        while not self._closed:
            try:
                ev = await loop.run_in_executor(None, get)
            except _queue.Empty:
                continue
            if ev is _STREAM_END:
                return
            yield ev

    def __aiter__(self):
        return self._astream()

    def cancel(self):
        self._closed = True
        self._queue.put(_STREAM_END)
        subs = self._db._subs.get(self._key, [])
        if self in subs:
            subs.remove(self)


class SnapshotCorruption(RuntimeError):
    """A table snapshot failed its CRC / decode at open (bit corruption,
    truncation, or AEAD failure). The WAL alone cannot reconstruct the
    table, so the open fails loudly instead of silently losing rows."""


_TOMBSTONE = None  # overlay value marking an in-transaction delete


class _Txn:
    """Transaction context (reference transaction_manager.dart:17 +
    write_buffer_manager.dart buffered entries).

    Lifecycle has two phases:
      - BUFFERING (user code running): writes go to `overlay`/`oplog`, never
        the base store; unique keys are reserved engine-wide at op time
        (reference BatchCheckContext.tryReserve, wbm:54-100); the engine
        lock is held only per-op, so concurrent readers/writers proceed and
        see only committed state.
      - COMMIT REPLAY (buffering=False, lock held): the oplog replays
        through the eager apply paths, which collect `undo` (mid-replay
        failure rollback), `wal_ops` (one WAL group frame) and `events`
        (dispatched after commit) on this object."""

    def __init__(self, db, tx_id):
        self.db = db
        self.tx_id = tx_id
        self.buffering = True
        self.begin_seq = 0
        # (space, table) -> {pk: record-with-pk | None tombstone}
        self.overlay: dict[tuple, dict] = {}
        self.oplog: list[tuple] = []  # ("insert"/"update"/"delete", tkey, pk, payload)
        self.write_set: set[tuple] = set()  # {(tkey, pk)}
        # {(tkey, pk)} whose ONLY writes in this txn are blind all-Expr
        # updates (deferred to commit replay): exempt from this txn's own
        # write-footprint validation — a blind write commutes with any
        # concurrent commit because commit order is a valid serial order
        # for a txn whose behavior never observed the row (any read of the
        # row lands in read_set, which always stays in the footprint)
        self.commutes: set[tuple] = set()
        # {(tkey, pk)} row reads + {(tkey, None)} table-level predicate
        # reads (conservative phantom protection: a condition query
        # conflicts with ANY later commit touching that table)
        self.read_set: set[tuple] = set()
        # precise predicate reads: (tkey, condition, frozenset(match pks))
        # — validated by re-evaluating the condition against concurrently
        # committed rows instead of conflicting with ANY table write
        self.pred_reads: list[tuple] = []
        self.reservations: set[tuple] = set()  # {(tkey, name, key)}
        self.undo: list[tuple] = []  # (fn, args) applied in reverse on rollback
        self.wal_ops: list[dict] = []
        self.events: list[ChangeEvent] = []

    def table_overlay(self, tkey) -> dict | None:
        ov = self.overlay.get(tkey)
        return ov if ov else None


class Transaction:
    """Handle passed to user transaction code (also usable as proof of
    context); mirrors the reference's Zone-scoped txId (dsi:167-169)."""

    def __init__(self, db, txn: _Txn):
        self._db = db
        self.tx_id = txn.tx_id

    def rollback(self, message: str = "rolled back by user"):
        raise BusinessError(message, code="user_rollback")


class _TableRegistry(dict):
    """Tables by (space, name) with LAZY materialization from snapshots.

    The reference opens lazily and pages on demand (tree_cache.dart:15-70,
    prewarm strictly optional, data_store_impl.dart:5441) — that is what
    lets it serve 100M+ records on a phone (README.md:1527-1531). Here the
    dict base holds LOADED tables; `pending` maps unloaded keys to their
    snapshot's catalog-relative path, and the first access loads it.

    Semantics (deliberately asymmetric, every caller audited):
      - get()/[] materialize pending entries (the data paths);
      - `in`, `len`, iteration over keys INCLUDE pending (metadata checks,
        space listings, DDL guards — no load);
      - items()/values() return LIST SNAPSHOTS of loaded tables only (hot
        loops: flush dirty-scan, status, background maintenance — these
        must not force a 100M-row load, and a list copy keeps concurrent
        materialization from invalidating iteration).

    Materialization may run under the engine's SHARED mode (query paths):
    like Column._grow it is an internally-locked cache fill — the loaded
    table is published before the pending entry is removed, and a second
    racing reader waits on the same mutex."""

    def __init__(self, loader):
        super().__init__()
        self._loader = loader
        self._mat_lock = threading.Lock()
        self.pending: dict[tuple, str] = {}

    def peek(self, key):
        """Loaded table or None — never materializes."""
        return dict.get(self, key)

    def get(self, key, default=None):
        t = dict.get(self, key)
        if t is None and key in self.pending:
            with self._mat_lock:
                t = dict.get(self, key)
                if t is None:
                    rel = self.pending.get(key)
                    if rel is not None:
                        t = self._loader(key, rel)
                        dict.__setitem__(self, key, t)
                        del self.pending[key]
        return t if t is not None else default

    def __getitem__(self, key):
        t = self.get(key)
        if t is None:
            raise KeyError(key)
        return t

    def __contains__(self, key):
        return dict.__contains__(self, key) or key in self.pending

    def __iter__(self):
        return iter(list(dict.keys(self)) + list(self.pending))

    def keys(self):
        return list(self.__iter__())

    def __len__(self):
        return dict.__len__(self) + len(self.pending)

    def items(self):
        return list(dict.items(self))

    def values(self):
        return list(dict.values(self))

    def __setitem__(self, key, value):
        self.pending.pop(key, None)
        dict.__setitem__(self, key, value)

    def __delitem__(self, key):
        had = self.pending.pop(key, None) is not None
        if dict.__contains__(self, key):
            dict.__delitem__(self, key)
        elif not had:
            raise KeyError(key)

    def pop(self, key, default=None):
        self.pending.pop(key, None)
        return dict.pop(self, key, default)

    def clear(self):
        self.pending.clear()
        dict.clear(self)

    def materialize_all(self):
        """Force-load every pending table (backup, force_all flush,
        explicit prewarm, deep integrity checks)."""
        for key in list(self.pending):
            self.get(key)


class Database:
    def __init__(self, config: DataStoreConfig | None = None, storage=None):
        self.config = config or DataStoreConfig()
        # where the vector corpora live. Nothing is allocated here: with
        # the default ("cuda") and no card, the first table that declares
        # a vector index raises torch's own error. No global torch state
        # (TF32, cudnn.benchmark) is set at import or open.
        self._device = torch.device(self.config.device)
        # storage seam (reference StorageInterface, storage_interface.dart:
        # 22-159): all persistence bytes flow through this backend. Default
        # file mode = FileStorage; memory mode = MemoryStorage (state dies
        # with the object unless the same instance is reused); inject an
        # ObjectStorage to checkpoint into a bucket.
        from .storage import FileStorage, MemoryStorage

        self._storage = storage or (
            MemoryStorage() if self.config.memory_mode else FileStorage()
        )
        from ..utils.logging import LogConfig

        LogConfig.set_config(
            level=self.config.log_level, on_log=self.config.on_log
        )
        if self.config.isolation_level not in (
            IsolationLevel.readCommitted,
            IsolationLevel.serializable,
        ):
            raise ValueError(
                f"unknown isolation level {self.config.isolation_level!r}"
            )
        # one re-entrant engine lock guards every base-store mutation and
        # read; transactions BUFFER their writes (per-thread overlay) and
        # hold the lock only per-op + during commit replay, so readers never
        # block on an open transaction and never see uncommitted state.
        # serializable commits validate their write-set AND read-set against
        # every txn / direct write committed since begin (first-committer-
        # wins; row reads match by pk, predicate reads at table granularity
        # — conservative phantom protection, strictly stronger than the
        # reference's write-set-only SSI check, tm:30-36); readCommitted
        # commits skip validation (last-writer-wins).
        # the big engine lock is a readers-writer lock (reference
        # lock_manager.dart:38-44 shared/exclusive): every mutator path
        # keeps `with self._lock:` (EXCLUSIVE — a drop-in guard over the
        # RWLock, re-entrant, and a holder may nest shared mode), while
        # the audited read-only entry points (query/count/get_by_pk) take
        # `with self._shared:` so concurrent relational reads execute in
        # parallel. Read-path lazy mutators are individually thread-safe:
        # Column._grow (columnstore), SortedIndex._ensure (table.py), the
        # executor query cache (_cache_lock), and metrics (_metrics_lock);
        # a missed write under shared mode fails loudly — RWLock raises on
        # read->write upgrade instead of deadlocking.
        self._biglock = RWLock()
        self._lock = WriteGuard(self._biglock)
        self._shared = ReadGuard(self._biglock)
        self._metrics_lock = threading.Lock()  # counters/timings off-lock
        self._tables: _TableRegistry = _TableRegistry(self._load_table)
        self._schemas: dict[tuple[str, str], TableSchema] = {}
        self._catalog_rows: dict[tuple[str, str], int] = {}  # pending sizes
        self.global_config = GlobalConfig()
        self._wal: SegmentedWalWriter | None = None
        self._ckpt_gens: dict[tuple[str, str], int] = {}  # per-table clean marks
        self._fk_rev_cache: dict | None = None  # ref-table -> referencing FKs
        self._pending_large_ops: dict[str, dict] = {}  # replayed, unfinished
        self._wal_buffer: list | None = None
        self._txn_local = threading.local()
        self._active_txns: set = set()
        self._commit_seq = 0
        # [(commit_seq, frozenset{(tkey, pk)})] for write-set validation
        self._recent_commits: list[tuple[int, frozenset]] = []
        # engine-wide unique-key reservations: (tkey, map_name, key) ->
        # (tx_id, pk) — blocks other txns AND direct writers at op time
        self._unique_res: dict[tuple, tuple] = {}
        # pessimistic escalation registry: (tkey, pk) -> short exclusive
        # lock serializing repeatedly-conflicting hot-row transactions
        self._hot_locks: dict[tuple, threading.Lock] = {}
        self._hot_lock_guard = threading.Lock()
        self._subs: dict[tuple, list[Subscription]] = {}
        self._closed = False
        self._crontab = None
        self._opened_ms = int(time.time() * 1000)
        self._counters = {"inserts": 0, "updates": 0, "deletes": 0, "queries": 0,
                          "vector_searches": 0, "flushes": 0,
                          "recovered_wal_entries": 0,
                          "recovery_decode_errors": 0,  # CRC-valid frames that
                          # failed to decode (wrong key / corruption)
                          "recovery_apply_errors": 0}  # replayed entries whose
        # re-application raised (benign double-apply or genuine divergence)
        self._timings: dict[str, list] = {}  # op -> [count, total_s]
        self.executor = QueryExecutor(self)
        self._envelope = self._make_envelope()
        from .maintenance import (
            IntegrityChecker, ResourceManager, WeightManager, WorkloadScheduler,
        )

        self.resources = ResourceManager(self.db_dir, self._device)
        self.weights = WeightManager()
        self._integrity = IntegrityChecker()
        self.workload = WorkloadScheduler(
            maintenance_share=self.config.maintenance_share,
            defer_s=self.config.maintenance_defer_s,
        )
        self._mesh = self._make_mesh()

        # a pure-memory database is always freshly created (no manifest
        # to recover); _open_files flips this when one exists on disk
        self.freshly_created = True
        if not self.config.memory_mode:
            self._open_files()
        self._ensure_kv_table()
        self._mark_interrupted_migrations()
        self._start_crontab()
        if self.config.prewarm_on_open:
            # reference loadDataToCache at open (dsi:908): warm search
            # executables off the open path; hottest tables first
            self._prewarm_thread = threading.Thread(
                target=self._prewarm_guarded, daemon=True,
                name="tostore-prewarm",
            )
            self._prewarm_thread.start()

    def _prewarm_guarded(self):
        try:
            self.prewarm()
        except Exception as exc:  # startup warming must never kill opens
            log.warning(f"prewarm_on_open failed: {exc}")

    # --- per-thread transaction context ------------------------------------

    @property
    def _txn(self):
        return getattr(self._txn_local, "txn", None)

    @_txn.setter
    def _txn(self, value):
        self._txn_local.txn = value

    def _buffering_txn(self):
        """The current thread's OPEN (buffering) transaction, if any."""
        txn = self._txn
        return txn if txn is not None and txn.buffering else None

    def _overlay_for(self, tkey) -> dict | None:
        txn = self._buffering_txn()
        return txn.table_overlay(tkey) if txn is not None else None

    def _note_read(self, tkey, pk=None):
        """Record a row (pk) or predicate (None) read in the open
        transaction's read-set for serializable validation."""
        txn = self._buffering_txn()
        if txn is not None:
            txn.read_set.add((tkey, pk))

    PRED_READ_MAX_PKS = 4096

    def _note_pred_read(self, tkey, condition, pks):
        """Narrow predicate read: the condition plus its read-time match
        set. Validation conflicts only with commits whose rows were in the
        match set OR currently satisfy the condition (phantoms) — measured
        83.8%% abort rate on DISJOINT-row workloads under table granularity
        (BENCH config #9), vs ~0 with this. Huge match sets fall back to
        table granularity (the validation scan would not pay for itself)."""
        txn = self._buffering_txn()
        if txn is None:
            return
        if (
            condition is None
            or condition.is_empty
            or pks is None
            or len(pks) > self.PRED_READ_MAX_PKS
        ):
            txn.read_set.add((tkey, None))
            return
        txn.pred_reads.append((tkey, condition, frozenset(pks)))

    def _tkey(self, t: Table) -> tuple:
        space = GLOBAL_SPACE if t.schema.is_global else self.current_space
        return (space, t.schema.name)

    # --- overlay-aware state views (committed base + this thread's txn) ----

    def _view_get(self, t: Table, tkey, pk) -> dict | None:
        """Record as visible to the current thread (incl. pk field)."""
        ov = self._overlay_for(tkey)
        if ov is not None and pk in ov:
            rec = ov[pk]
            return dict(rec) if rec is not None else None
        return t.store.get(pk)

    def _view_exists(self, t: Table, tkey, pk) -> bool:
        ov = self._overlay_for(tkey)
        if ov is not None and pk in ov:
            return ov[pk] is not None
        return pk in t.store

    def _unique_holder(self, t: Table, tkey, name, key):
        """Overlay-aware unique lookup: the pk currently holding
        (map_name, key) in this thread's view, or None."""
        ov = self._overlay_for(tkey)
        if ov:
            for pk, rec in ov.items():
                if rec is None:
                    continue
                for n2, k2 in t._unique_entries(pk, rec):
                    if n2 == name and k2 == key:
                        return pk
        holder = t.unique_maps.get(name, {}).get(key)
        if holder is not None and ov and holder in ov:
            rec = ov[holder]
            if rec is None:
                return None  # deleted in-txn: value is free
            if not any(
                n2 == name and k2 == key
                for n2, k2 in t._unique_entries(holder, rec)
            ):
                return None  # rewritten in-txn without this value
        return holder

    def _check_reservations(self, tkey, entries, tx_id, pk):
        """Raise when another transaction holds an op-time reservation on
        any of `entries` (reference tryReserve, wbm:54-100)."""
        if not self._unique_res:
            return
        for name, key in entries:
            owner = self._unique_res.get((tkey, name, key))
            if owner is not None and owner != (tx_id, pk):
                raise UniqueViolation(tkey[1], name if name != "__pk__" else "pk", key)

    def _match_pks(self, t: Table, tkey, condition: QueryCondition) -> list:
        """Condition -> pks over base + this thread's overlay."""
        mask = condition.mask(lambda f: t.store.column_view(f), t.store.high)
        pks = [t.store.pk_col.get(r) for r in t.store.rows_for_mask(mask)]
        ov = self._overlay_for(tkey)
        if ov:
            pks = [p for p in pks if p not in ov]
            pks += [
                p for p, rec in ov.items()
                if rec is not None and condition.matches(rec)
            ]
        # narrow predicate read (update/delete targeting)
        self._note_pred_read(tkey, condition, pks)
        return pks

    def _all_pks(self, t: Table, tkey) -> list:
        pks = t.store.pks()
        ov = self._overlay_for(tkey)
        if ov:
            pks = [p for p in pks if p not in ov]
            pks += [p for p, rec in ov.items() if rec is not None]
        return pks

    def _make_mesh(self):
        """Optional mesh of cells for sharded vector corpora (config
        mesh_shape: (shard,) or (dp, shard)); () and a one-cell shape mean a
        single device. Where the cells live follows `config.device`
        (models/config.py): after `parallel.mesh.init_distributed` they
        follow the process group's ranks; a device without an index
        ("cuda") puts one cell on each of cuda:0..n-1 and raises when the
        machine has fewer cards; a device with an index ("cuda:0") or
        "cpu" holds every cell."""
        shape = self.config.mesh_shape
        if not shape:
            return None
        import math as _math

        from ..parallel.mesh import distributed_initialized, make_mesh

        n = _math.prod(shape)
        if n <= 1:
            return None
        dp = shape[0] if len(shape) == 2 else 1
        dev = torch.device(self.config.device)
        if distributed_initialized() or (dev.type == "cuda" and dev.index is None):
            return make_mesh(n_devices=n, dp=dp)
        return make_mesh(n_devices=n, dp=dp, devices=[dev] * n)

    def _kdf_params(self) -> tuple[bytes, int]:
        """Per-database KDF salt + iteration count. New databases get a
        random salt (persisted in the manifest) and 600k iterations;
        databases whose manifest predates kdf_salt keep the legacy fixed
        salt so their artifacts stay decryptable.

        Device binding (reference data_store_config.dart:945-961): when the
        database is device-bound, the salt is mixed with a host/path factor
        before key derivation, and the manifest carries a binding
        fingerprint so a copied database fails with a clean error on a
        foreign host/path instead of an AEAD tag failure."""
        import hashlib
        import secrets

        from ..utils.crypto import (
            DEFAULT_KDF_ITERS, LEGACY_KDF_ITERS, LEGACY_KDF_SALT,
            device_binding_factor,
        )

        enc = self.config.encryption
        if not self.config.memory_mode:
            manifest_path = os.path.join(self.db_dir, "manifest.json")
            if self._storage.exists(manifest_path):
                extras = json.loads(self._storage.read(manifest_path)).get(
                    "extras", {}
                )
                bound = bool(extras.get("device_bound"))
                if enc.device_binding and not bound:
                    raise ValueError(
                        "existing database was created without device "
                        "binding; re-create or rotate keys to enable it"
                    )
                if "kdf_salt" in extras:
                    salt = bytes.fromhex(extras["kdf_salt"])
                    iters = int(extras.get("kdf_iters", DEFAULT_KDF_ITERS))
                else:
                    salt, iters = LEGACY_KDF_SALT, LEGACY_KDF_ITERS
                if bound:
                    factor = device_binding_factor(self.db_dir)
                    fp = hashlib.sha256(factor).hexdigest()[:16]
                    if extras.get("device_fingerprint", fp) != fp:
                        raise ValueError(
                            "database is device-bound to a different host "
                            "or path and refuses to open here"
                        )
                    salt = hashlib.sha256(salt + factor).digest()
                return salt, iters
        salt = secrets.token_bytes(16)
        self.global_config.extras["kdf_salt"] = salt.hex()
        self.global_config.extras["kdf_iters"] = DEFAULT_KDF_ITERS
        if enc.device_binding:
            if self.config.memory_mode:
                raise ValueError(
                    "device binding requires a file-backed database"
                )
            factor = device_binding_factor(self.db_dir)
            self.global_config.extras["device_bound"] = True
            self.global_config.extras["device_fingerprint"] = hashlib.sha256(
                factor
            ).hexdigest()[:16]
            salt = hashlib.sha256(salt + factor).digest()
        return salt, DEFAULT_KDF_ITERS

    def _make_envelope(self):
        enc = self.config.encryption
        if not enc.enable_encoding:
            return None
        from ..utils.crypto import Envelope, KeyRing

        passphrase = enc.encryption_key or enc.encoding_key
        if not passphrase:
            raise ValueError("encryption enabled but no key configured")
        salt, iters = self._kdf_params()
        return Envelope(
            KeyRing.from_passphrase(passphrase, enc.key_id, salt=salt, iters=iters),
            enc.algorithm,
        )

    def _wrap_bytes(self, b: bytes) -> bytes:
        if self.config.enable_compression:
            from ..utils import compress as _cz

            b = _cz.compress(b, self.config.compression_level)
        if self._envelope is not None:
            return self._envelope.seal(b)
        return b

    def _unwrap_bytes(self, b: bytes) -> bytes:
        from ..utils import compress as _cz
        from ..utils.crypto import Envelope

        if Envelope.is_sealed(b):
            if self._envelope is None:
                raise ValueError("artifact is encrypted but no key configured")
            b = self._envelope.open(b)
        if _cz.is_compressed(b):
            b = _cz.decompress(b)
        return b

    # ------------------------------------------------------------------ files

    @property
    def db_dir(self) -> str | None:
        if self.config.memory_mode:
            return None
        return os.path.join(self.config.db_path, self.config.db_name)

    def _read_snapshot_file(self, path: str) -> dict:
        """CRC-verified snapshot read (reference page CRC headers): new
        snapshots carry one CRC frame inside the (possibly encrypted)
        payload; legacy unframed files (top-level dict tag, never the
        0xA7 frame magic) decode directly. Any corruption — bit flips,
        truncation, AEAD failures — surfaces as SnapshotCorruption naming
        the file instead of a garbage decode deep in the codec."""
        data = self._storage.read(path)
        try:
            raw = self._unwrap_bytes(data)
            if raw[:1] == bytes([codec.FRAME_MAGIC]):
                payloads = list(codec.iter_frames(raw))
                if len(payloads) != 1:
                    raise ValueError("frame CRC mismatch or torn frame")
                return codec.loads(payloads[0])
            return codec.loads(raw)
        except Exception as exc:
            raise SnapshotCorruption(
                f"corrupted snapshot {path!r}: {exc} — restore this table "
                "from a backup or delete the file to rebuild from WAL"
            ) from exc

    def _load_table(self, key: tuple, rel: str) -> Table:
        """Materialize a lazily-registered table from its snapshot
        (first-touch load; _TableRegistry calls this under its own mutex).
        Records the per-table load latency under timings()['table_load']."""
        with self._timed("table_load"):
            td = self._read_snapshot_file(os.path.join(self.db_dir, rel))
            t = Table.from_state_dict(
                _unpack_ndarrays(td), self.config.distributed.node_id, self._mesh,
                device=self._device,
            )
        self._ckpt_gens[key] = t.store.generation
        self._catalog_rows.pop(key, None)
        self._bump("lazy_table_loads")
        return t

    def _open_files(self):
        d = self.db_dir
        self._storage.makedirs(d)
        manifest_path = os.path.join(d, "manifest.json")
        if self._storage.exists(manifest_path):
            self.freshly_created = False
            self.global_config = GlobalConfig.from_json(
                json.loads(self._storage.read(manifest_path))
            )
        else:
            self.freshly_created = True  # drives the onCreate callback
            self._persist_manifest()  # pin fresh-database state (KDF salt)
        if self.global_config.version < ENGINE_VERSION:
            for v in range(self.global_config.version + 1, ENGINE_VERSION + 1):
                fn = UPGRADES.get(v)
                if fn is not None:
                    fn(self)
            self.global_config.version = ENGINE_VERSION
            self._persist_manifest()

        # resumable key rotation (reference key_migration_runner.dart): a
        # crash between rotate() and the full re-seal left the manifest
        # carrying the RETIRING keys wrapped under the new one — unwrap
        # them into the ring before reading any sealed artifact, finish
        # the re-seal after recovery (_finish_pending_rotation)
        resume_rotation = False
        pend = self.global_config.extras.get("pending_rotation")
        if pend and self._envelope is not None:
            ring = self._envelope.ring
            if ring.current != pend["current"]:
                # the reopen config assigned the new passphrase a different
                # key id; artifacts are sealed under the rotation's id
                ring.keys[pend["current"]] = ring.keys.pop(ring.current)
                ring.current = pend["current"]
            for kid_s, blob_hex in pend["wrapped"].items():
                kid = int(kid_s)
                if kid not in ring.keys:
                    ring.keys[kid] = self._envelope.open(bytes.fromhex(blob_hex))
            resume_rotation = True

        # table snapshots: LAZY per-table load via the manifest catalog
        # (reference opens lazily and pages on demand, tree_cache.dart:15-70;
        # prewarm strictly optional, data_store_impl.dart:5441) — opening
        # touches only the manifest; each table's snapshot loads on first
        # access or when WAL replay needs it. A legacy round-1 monolithic
        # current.snap loads once and migrates; manifests from before the
        # schema catalog existed fall back to eager loads.
        legacy_snap = os.path.join(d, "current.snap")
        legacy_wal = os.path.join(d, "wal.log")
        legacy = self._storage.exists(legacy_snap) or self._storage.exists(legacy_wal)
        if self._storage.exists(legacy_snap):
            self._load_snapshot(self._read_snapshot_file(legacy_snap))
        catalog = self.global_config.extras.get("catalog", {})
        sch_meta = self.global_config.extras.get("schemas", {})
        for space, tbls in catalog.items():
            for name, rel in tbls.items():
                key = (space, name)
                meta = sch_meta.get(space, {}).get(name)
                has_snap = self._storage.exists(os.path.join(d, rel))
                if meta is not None:
                    schema = TableSchema.from_json(meta["schema"])
                    self._schemas[key] = schema
                    if has_snap:
                        self._catalog_rows[key] = int(meta.get("rows", 0))
                        self._tables.pending[key] = rel
                    else:  # checkpointed before the table's first write
                        self._tables[key] = Table(
                            schema, self.config.distributed.node_id, self._mesh,
                            device=self._device,
                        )
                elif has_snap:  # legacy manifest: schema lives in the snap
                    td = self._read_snapshot_file(os.path.join(d, rel))
                    t = Table.from_state_dict(
                        _unpack_ndarrays(td),
                        self.config.distributed.node_id, self._mesh,
                        device=self._device,
                    )
                    self._tables[key] = t
                    self._schemas[key] = t.schema
        for key, t in self._tables.items():
            self._ckpt_gens[key] = t.store.generation
        self._ensure_kv_table()  # must exist before WAL replay of KV writes

        # WAL replay (crash recovery): STREAM segments at/after the
        # checkpoint pointer frame by frame (never materializing the entry
        # list — the r4 soak held the whole 500k-row tail in RAM), and
        # coalesce runs of single-op frames into columnar bulk applies
        # (reference decodes WAL in isolate batches,
        # wal_decode_batch_runner.dart:304, and refills the write buffer in
        # bulk, parallel_journal_manager.dart:124). Dirty tables
        # materialize on their first replayed entry.
        wal_dir = os.path.join(d, "wal")
        start_seq = int(self.global_config.extras.get("wal_start_seq", 1))
        legacy_read = read_wal(
            legacy_wal, unwrap=self._unwrap_bytes, storage=self._storage
        )
        torn_segments: list = []
        replayed = self._replay_stream(
            itertools.chain(
                legacy_read.entries,
                iter_wal_segments(
                    wal_dir, start_seq,
                    unwrap=self._unwrap_bytes, storage=self._storage,
                    errors=torn_segments,
                ),
            )
        )
        entries = replayed  # count; the stream is never materialized
        self._fk_rev_cache = None
        self._counters["recovered_wal_entries"] = replayed
        self._counters["recovery_decode_errors"] = (
            legacy_read.errors + len(torn_segments)
        )
        # TTL-enabled tables must be resident for sweeps to see them
        # (bounded-staleness would otherwise extend to first user touch)
        for key, schema in list(self._schemas.items()):
            if schema.ttl and schema.ttl.enabled:
                self._tables.get(key)
        segs = list_segments(wal_dir, self._storage)
        next_seq = max(start_seq, segs[-1][0] + 1 if segs else start_seq)
        self._wal = SegmentedWalWriter(
            wal_dir,
            next_seq,
            storage=self._storage,
            sync_policy=(
                "commit"
                if self.config.persist_recovery_on_commit
                else self.config.recovery_flush_policy
            ),
            interval_ms=self.config.recovery_flush_interval_ms,
            wrap=self._wrap_bytes if self._envelope is not None else None,
            segment_max_bytes=self.config.wal_segment_max_bytes,
        )
        if self._pending_large_ops:
            resumed = 0
            for entry in list(self._pending_large_ops.values()):
                resumed += self._resume_large_delete(entry)
            self._pending_large_ops.clear()
            self._counters["resumed_large_delete_rows"] = resumed
        if legacy:
            self.flush()  # legacy layouts migrate through a full checkpoint
            for p in (legacy_snap, legacy_wal):
                self._storage.delete(p)
        elif entries:
            # DEFER the post-replay checkpoint off the open path: at the 10M
            # soak it rewrote the whole dirty 10.5M-row snapshot during
            # recovery (~2/3 of recover_open_s). The reference opens lazily and
            # journals in the background (data_store_impl.dart:5441,
            # pjm:1209-1228); seeding the writer's counter makes the crontab
            # time-based checkpoint (FLUSH_AGE_S) fold the tail shortly
            # after open. A crash before then replays the same tail again —
            # identical durability, recovery work bounded by FLUSH_AGE_S.
            self._wal.entries_since_checkpoint = entries
        if resume_rotation:
            self._finish_pending_rotation()

    def _finish_pending_rotation(self):
        """Re-seal every artifact under the current key and retire the
        wrapped ones (the resume half of rotate_encryption_key)."""
        ring = self._envelope.ring
        self.flush(force_all=True)
        for kid in [k for k in ring.keys if k != ring.current]:
            ring.retire(kid)
        self.global_config.extras.pop("pending_rotation", None)
        self._persist_manifest()
        self._counters["resumed_key_rotation"] = (
            self._counters.get("resumed_key_rotation", 0) + 1
        )

    def _start_crontab(self):
        from .crontab import CrontabManager

        self._crontab = CrontabManager(self)
        self._crontab.start()

    def close(self, keep_active_space: bool = True):
        """`keep_active_space=False` resets the persisted active-space
        pointer to 'default' before closing, so the next open lands in
        the default space (reference close(keepActiveSpace:),
        data_store_impl.dart:1086-1170 — the logout idiom)."""
        with self._lock:
            if self._closed:
                return
            if not keep_active_space:
                self.global_config.active_space = "default"
            if self._crontab:
                self._crontab.stop()
            if not self.config.memory_mode:
                self.flush()
                if self._wal:
                    self._wal.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ------------------------------------------------------- observability

    @contextlib.contextmanager
    def _timed(self, op: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._metrics_lock:
                cell = self._timings.setdefault(op, [0, 0.0])
                cell[0] += 1
                cell[1] += time.perf_counter() - t0
            self.workload.note_foreground()

    def _bump(self, name: str, n: int = 1):
        """Counter increment safe from SHARED-mode (off-exclusive) paths.
        Keys bumped here must not also be `+=`-incremented elsewhere."""
        with self._metrics_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    @contextlib.contextmanager
    def profile_trace(self, log_dir: str, host_profiler: bool = False):
        """Capture a device trace for everything inside the block
        (reference §5 tracing): a Chrome trace, `log_dir/trace_<ms>.json`,
        viewable in Perfetto or chrome://tracing. Wraps
        torch.profiler.profile — host ops, and on a CUDA device the
        kernels and copies, show up per-op. `host_profiler=True` adds
        Python stacks to the host events."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=acts, with_stack=host_profiler) as prof:
            yield
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{int(time.time() * 1000)}.json")
        )

    def timings(self) -> dict:
        """Per-op latency counters: {op: {count, total_ms, avg_ms}}."""
        return {
            op: {
                "count": c,
                "total_ms": round(t * 1e3, 3),
                "avg_ms": round(t * 1e3 / max(c, 1), 4),
            }
            for op, (c, t) in sorted(self._timings.items())
        }

    # ------------------------------------------------------------- spaces

    @property
    def current_space(self) -> str:
        return self.global_config.active_space

    def declare_schemas(self, schemas) -> None:
        """Schemas declared at construction: created now in the active
        space and RE-CREATED in any space switched into later (the
        reference re-runs initialize -> setup on switchSpace,
        data_store_impl.dart switchSpace -> initialize)."""
        self._declared_schemas = list(schemas)
        self.create_tables(self._declared_schemas)

    def switch_space(self, name: str):
        with self._lock:
            self.global_config.active_space = name
            self._ensure_space_config(name)
            self._ensure_kv_table()
            # declared schemas materialize in the new space (reference
            # switchSpace re-initializes; global tables already exist)
            for s in getattr(self, "_declared_schemas", ()):
                self.create_table(s)
            self._persist_manifest()

    def _ensure_space_config(self, name: str):
        from ..models.config import SpaceConfig

        spaces = self.global_config.extras.setdefault("spaces", {})
        if name not in spaces:
            spaces[name] = SpaceConfig(
                name=name, created_ms=int(time.time() * 1000)
            ).to_json()

    def space_config(self, name: str | None = None):
        """Per-space persisted state (reference space_config.dart)."""
        from ..models.config import SpaceConfig

        name = name or self.current_space
        self._ensure_space_config(name)
        return SpaceConfig.from_json(self.global_config.extras["spaces"][name])

    def update_space_config(self, cfg):
        with self._lock:
            self.global_config.extras.setdefault("spaces", {})[cfg.name] = cfg.to_json()
            self._persist_manifest()

    def list_spaces(self) -> list[str]:
        spaces = {s for s, _ in self._tables if s != GLOBAL_SPACE}
        spaces.add(self.current_space)
        spaces.update(self.global_config.extras.get("spaces", {}))
        return sorted(spaces)

    def delete_space(self, name: str):
        with self._lock:
            for key in [k for k in self._tables if k[0] == name]:
                del self._tables[key]
                self._schemas.pop(key, None)
            self.global_config.extras.get("spaces", {}).pop(name, None)
            self._fk_rev_cache = None
            self._wal_append({"op": "drop_space", "space": name})
            self._ensure_kv_table()  # deleting the active space must not
            # leave its system KV table missing

    def _persist_manifest(self):
        if self.config.memory_mode:
            return
        # schema catalog: lets the next engine start register every table WITHOUT
        # touching its snapshot (lazy open), and report record counts for
        # never-loaded tables (status/space info)
        sch: dict[str, dict] = {}
        for (space, name), schema in list(self._schemas.items()):
            t = self._tables.peek((space, name))
            rows = (
                len(t.store) if t is not None
                else self._catalog_rows.get((space, name), 0)
            )
            sch.setdefault(space, {})[name] = {
                "schema": schema.to_json(), "rows": rows,
            }
        self.global_config.extras["schemas"] = sch
        self._storage.write_atomic(
            os.path.join(self.db_dir, "manifest.json"),
            json.dumps(self.global_config.to_json()).encode(),
        )

    # ------------------------------------------------------------- tables

    def _space_for(self, schema: TableSchema) -> str:
        return GLOBAL_SPACE if schema.is_global else self.current_space

    def _table(self, name: str, space: str | None = None) -> Table:
        space = space or self.current_space
        t = self._tables.get((space, name)) or self._tables.get((GLOBAL_SPACE, name))
        if t is None:
            raise ValidationError(f"table {name!r} does not exist")
        return t

    def has_table(self, name: str, space: str | None = None) -> bool:
        space = space or self.current_space
        return (space, name) in self._tables or (GLOBAL_SPACE, name) in self._tables

    def create_table(self, schema: TableSchema, if_not_exists: bool = True) -> DbResult:
        with self._lock:
            space = self._space_for(schema)
            key = (space, schema.name)
            if key in self._tables:
                existing = self._schemas.get(key)
                if existing is not None and not _schemas_equal(existing, schema):
                    # schema-diff auto-migration at open (reference
                    # data_store_impl.dart:897 _startSetupAndUpgrade ->
                    # migration_manager.dart:47): the declared schema wins
                    return self.update_schema(schema.name, schema)
                if if_not_exists:
                    return DbResult.success(message="table exists")
                return DbResult.error(ResultType.schemaError, f"table {schema.name!r} exists")
            if schema.name.startswith(SYSTEM_PREFIX) and schema.name != KV_TABLE:
                return DbResult.error(
                    ResultType.schemaError, "system table names are reserved"
                )
            self._fk_rev_cache = None
            self._tables[key] = Table(
                schema, self.config.distributed.node_id, self._mesh,
                device=self._device,
            )
            self._schemas[key] = schema
            self._wal_append({"op": "create_table", "space": space, "schema": schema.to_json()})
            return DbResult.success()

    def create_tables(self, schemas: list[TableSchema]) -> DbResult:
        for s in schemas:
            r = self.create_table(s)
            if r.is_error:
                return r
        return DbResult.success()

    def drop_table(self, name: str) -> DbResult:
        with self._lock:
            space = self.current_space
            key = (space, name)
            if key not in self._tables:
                key = (GLOBAL_SPACE, name)
            if key not in self._tables:
                return DbResult.error(ResultType.notFound, f"table {name!r} not found")
            self._fk_rev_cache = None
            del self._tables[key]
            del self._schemas[key]
            self._wal_append({"op": "drop_table", "space": key[0], "table": name})
            return DbResult.success()

    def update_schema(
        self, name: str, new_schema: TableSchema, renames: dict[str, str] | None = None
    ) -> DbResult:
        """Migrate a table to a new schema (reference updateSchema +
        migration_manager auto-detection). Rename inference follows the
        reference's similarity scoring; explicit `renames` win."""
        from .migration import migrate_table

        with self._lock:
            try:
                t = self._table(name)
            except ValidationError as e:
                return DbResult.error(ResultType.notFound, str(e))
            space = GLOBAL_SPACE if t.schema.is_global else self.current_space
            task_id = self._migration_task_start(name, space)

            def on_progress(pct: int, phase: str):
                self._migration_task_update(
                    task_id, progress=int(pct), phase=phase
                )

            try:
                report = migrate_table(t, new_schema, renames, on_progress)
            except (ValidationError, ValueError) as e:
                self._migration_task_update(
                    task_id, status="failed", error=str(e),
                    finished_ms=int(time.time() * 1000),
                )
                return DbResult.error(ResultType.schemaError, str(e))
            self._schemas[(space, name)] = new_schema
            self._fk_rev_cache = None
            self._wal_append(
                {"op": "schema_update", "space": space, "table": name,
                 "schema": new_schema.to_json(), "renames": renames or {}}
            )
            self._migration_task_update(
                task_id, status="completed", progress=100, phase="done",
                report=report, finished_ms=int(time.time() * 1000),
            )
            return DbResult.success(data={**report, "task_id": task_id})

    def _apply_schema_update(self, space, name, schema, renames):
        from .migration import migrate_table

        t = self._tables.get((space, name))
        if t is not None:
            migrate_table(t, schema, renames)
            self._schemas[(space, name)] = schema

    def rename_table(self, old: str, new: str) -> DbResult:
        """Move a table to a new name (WAL-logged so recovery replays it)."""
        with self._lock:
            for sp in (self.current_space, GLOBAL_SPACE):
                key = (sp, old)
                if key in self._tables:
                    if (sp, new) in self._tables:
                        return DbResult.error(
                            ResultType.schemaError, f"table {new!r} already exists"
                        )
                    t = self._tables.get(key)  # materializes if lazy: the
                    # snapshot file is keyed by name, so the renamed table
                    # must be resident (and dirty) for the next checkpoint
                    del self._tables[key]
                    self._schemas.pop(key, None)
                    self._tables[(sp, new)] = t
                    self._schemas[(sp, new)] = t.schema
                    self._fk_rev_cache = None
                    self._wal_append(
                        {"op": "rename_table", "space": sp, "old": old, "new": new}
                    )
                    return DbResult.success()
            return DbResult.error(ResultType.notFound, f"table {old!r} not found")

    def get_schema(self, name: str) -> TableSchema | None:
        # metadata read: served from the schema catalog so it never forces
        # a lazy table load
        for key in ((self.current_space, name), (GLOBAL_SPACE, name)):
            s = self._schemas.get(key)
            if s is not None:
                return s
        return None

    def _ensure_kv_table(self):
        from ..models.schema import FieldSchema, PrimaryKeyConfig, PrimaryKeyType

        for space in (GLOBAL_SPACE, self.current_space):
            key = (space, KV_TABLE)
            if key not in self._tables:
                schema = TableSchema(
                    name=KV_TABLE,
                    fields=(
                        FieldSchema("value", DataType.json),
                        FieldSchema("expires_ms", DataType.bigInt),
                    ),
                    primary_key=PrimaryKeyConfig(name="key", type=PrimaryKeyType.none),
                    is_global=(space == GLOBAL_SPACE),
                )
                self._tables[key] = Table(schema, device=self._device)
                self._schemas[key] = schema
        # persisted migration task queue (reference migration_manager.dart
        # task records + tostore.dart:1119 queryMigrationTaskStatus)
        mkey = (GLOBAL_SPACE, MIGRATIONS_TABLE)
        if mkey not in self._tables:
            schema = TableSchema(
                name=MIGRATIONS_TABLE,
                fields=(
                    FieldSchema("table", DataType.text),
                    FieldSchema("space", DataType.text),
                    FieldSchema("status", DataType.text),
                    FieldSchema("progress", DataType.integer),
                    FieldSchema("phase", DataType.text),
                    FieldSchema("started_ms", DataType.bigInt),
                    FieldSchema("finished_ms", DataType.bigInt),
                    FieldSchema("report", DataType.json),
                    FieldSchema("error", DataType.text),
                ),
                is_global=True,
            )
            self._tables[mkey] = Table(schema, device=self._device)
            self._schemas[mkey] = schema

    # ---------------------------------------------------- migration tasks

    def _migration_tasks_table(self) -> Table:
        return self._tables[(GLOBAL_SPACE, MIGRATIONS_TABLE)]

    def _migration_task_start(self, name: str, space: str) -> int:
        t = self._migration_tasks_table()
        pk = t.generate_pk()
        rec = {
            "table": name, "space": space, "status": "running",
            "progress": 0, "phase": "start",
            "started_ms": int(time.time() * 1000), "finished_ms": 0,
            "report": None, "error": None,
        }
        t.apply_insert(pk, rec)
        self._wal_append(
            {"op": "insert", "space": GLOBAL_SPACE, "table": MIGRATIONS_TABLE,
             "pk": pk, "rec": rec}
        )
        return pk

    def _migration_task_update(self, pk: int, **updates):
        t = self._migration_tasks_table()
        t.apply_update(pk, updates)
        self._wal_append(
            {"op": "update", "space": GLOBAL_SPACE, "table": MIGRATIONS_TABLE,
             "pk": pk, "updates": updates}
        )

    def _mark_interrupted_migrations(self):
        """A task still 'running' at open was cut by a crash; the schema
        diff re-detects the work, so the stale task is marked rather than
        blindly re-executed with stale parameters."""
        t = self._tables.get((GLOBAL_SPACE, MIGRATIONS_TABLE))
        if t is None:
            return
        for pk in list(t.store.pks()):
            rec = t.store.get(pk)
            if rec.get("status") == "running":
                self._migration_task_update(pk, status="interrupted")

    def query_migration_status(self, task_id: int | None = None):
        """Persisted migration task records (reference tostore.dart:1119
        queryMigrationTaskStatus): one dict per task, or the single task."""
        with self._lock:
            t = self._migration_tasks_table()
            if task_id is not None:
                rec = t.store.get(task_id)
                if rec is not None:
                    rec["task_id"] = task_id
                return rec
            out = []
            for pk in sorted(t.store.pks()):
                rec = t.store.get(pk)
                rec["task_id"] = pk
                out.append(rec)
            return out

    # ------------------------------------------------------------- WAL plumbing

    def _wal_append(self, entry: dict):
        if self._crontab is not None:
            self._crontab.poke()
        self.workload.note_foreground()  # all write paths funnel through here
        txn = self._txn
        if txn is not None and not txn.buffering:
            # commit replay groups its frames into one WAL txn record;
            # during BUFFERING the only callers are non-transactional ops
            # (DDL, clear, large deletes) whose records must hit the WAL
            # immediately — buffered data ops never reach here
            txn.wal_ops.append(entry)
            return
        if self._wal_buffer is not None:
            self._wal_buffer.append(entry)
            return
        if self._wal is not None:
            self._wal.append(entry)
            if self._wal.entries_since_checkpoint >= self.config.write_batch_size:
                self.flush()

    @contextlib.contextmanager
    def _wal_group(self):
        """Group-commit WAL window for batch ops: one framed write + flush
        for the whole batch (the reference's write-buffer acks before its
        async flush too, pjm:350; durability granularity is the batch)."""
        if self._txn is not None or self._wal is None or self._wal_buffer is not None:
            yield
            return
        buf: list[dict] = []
        self._wal_buffer = buf
        try:
            yield
        finally:
            self._wal_buffer = None
            if buf:
                self._wal.append_many(buf)
                if self._wal.entries_since_checkpoint >= self.config.write_batch_size:
                    self.flush()

    # ops whose consecutive single-record frames coalesce into one columnar
    # bulk apply during replay (reference batches WAL decode + write-buffer
    # refill, wal_decode_batch_runner.dart:304 / pjm.dart:124)
    _COALESCE_CAP = 100_000

    def _replay_stream(self, entries) -> int:
        """Streaming batched replay: consume WAL entries one at a time,
        coalescing runs of single-op insert/delete frames on the same
        table into columnar bulk applies (12.4k -> 100k+ rows/s on the
        r4 soak's recovery path). Txn frames flatten into their sub-ops
        (already-committed by WAL presence); any other op flushes the run.
        Falls back to per-entry _replay on a batch failure so best-effort
        semantics and error counters match the single-entry path."""
        n = 0
        run_op = run_key = None
        run: list[dict] = []

        def flush_run():
            nonlocal run_op, run_key, run
            if not run:
                return
            batch, op, key = run, run_op, run_key
            run, run_op, run_key = [], None, None
            t = self._tables.get(key)
            if t is None:
                return
            try:
                if op == "insert":
                    seen = t.store.contains_many([e["pk"] for e in batch])
                    fresh = (
                        batch if not seen.any()
                        else [e for e, s in zip(batch, seen) if not s]
                    )
                    if fresh:
                        t.bulk_apply_insert(
                            [e["pk"] for e in fresh],
                            [e["rec"] for e in fresh],
                        )
                else:  # delete
                    t.bulk_apply_delete([e["pk"] for e in batch])
            except (UniqueViolation, ValidationError, KeyError) as exc:
                log.warning(
                    f"WAL replay: coalesced {op} batch failed "
                    f"({exc}); replaying singly"
                )
                for e in batch:
                    self._replay(e)

        def feed(e: dict):
            nonlocal run_op, run_key, run
            op = e.get("op")
            if op == "txn":
                for sub in e["ops"]:
                    feed(sub)
                return
            if op in ("insert", "delete"):
                key = (e["space"], e["table"])
                if op != run_op or key != run_key:
                    flush_run()
                    run_op, run_key = op, key
                run.append(e)
                if len(run) >= self._COALESCE_CAP:
                    flush_run()
                return
            flush_run()
            self._replay(e)

        for e in entries:
            n += 1
            feed(e)
        flush_run()
        return n

    def _replay(self, e: dict):
        op = e.get("op")
        try:
            if op == "txn":
                for sub in e["ops"]:
                    self._replay(sub)
            elif op == "create_table":
                schema = TableSchema.from_json(e["schema"])
                key = (e["space"], schema.name)
                if key not in self._tables:
                    self._tables[key] = Table(
                        schema, self.config.distributed.node_id, self._mesh,
                        device=self._device,
                    )
                    self._schemas[key] = schema
            elif op == "drop_table":
                self._tables.pop((e["space"], e["table"]), None)
                self._schemas.pop((e["space"], e["table"]), None)
            elif op == "drop_space":
                for key in [k for k in self._tables if k[0] == e["space"]]:
                    del self._tables[key]
                    del self._schemas[key]
            elif op == "insert":
                t = self._tables.get((e["space"], e["table"]))
                if t is not None and e["pk"] not in t.store:
                    t.apply_insert(e["pk"], e["rec"])
            elif op == "batch_insert_cols":
                t = self._tables.get((e["space"], e["table"]))
                if t is not None:
                    seen = t.store.contains_many(e["pks"])
                    if not seen.any():
                        t.bulk_apply_insert_cols(e["pks"], e["cols"])
                    elif not seen.all():
                        keep = np.flatnonzero(~seen).tolist()
                        cols = {
                            name: [vals[j] for j in keep]
                            for name, vals in e["cols"].items()
                        }
                        t.bulk_apply_insert_cols(
                            [e["pks"][j] for j in keep], cols
                        )
            elif op == "batch_insert":
                t = self._tables.get((e["space"], e["table"]))
                if t is not None:
                    seen = t.store.contains_many(e["pks"])
                    fresh = [
                        (pk, rec)
                        for pk, rec, s in zip(e["pks"], e["recs"], seen)
                        if not s
                    ]
                    if fresh:
                        t.bulk_apply_insert(
                            [p for p, _ in fresh], [r for _, r in fresh]
                        )
            elif op == "update":
                t = self._tables.get((e["space"], e["table"]))
                if t is not None:
                    t.apply_update(e["pk"], e["updates"])
            elif op == "batch_update_cols":
                t = self._tables.get((e["space"], e["table"]))
                if t is not None:
                    keep = [
                        (j, r) for j, r in (
                            (j, t.store.rowid(pk))
                            for j, pk in enumerate(e["pks"])
                        ) if r is not None
                    ]
                    if keep:
                        cols = {
                            name: [vals[j] for j, _ in keep]
                            for name, vals in e["cols"].items()
                        }
                        t.bulk_apply_update_cols(
                            [e["pks"][j] for j, _ in keep],
                            np.asarray([r for _, r in keep], np.int64),
                            cols,
                        )
            elif op == "delete":
                t = self._tables.get((e["space"], e["table"]))
                if t is not None:
                    t.apply_delete(e["pk"])
            elif op == "batch_delete":
                t = self._tables.get((e["space"], e["table"]))
                if t is not None:
                    t.bulk_apply_delete(e["pks"])
            elif op == "clear":
                t = self._tables.get((e["space"], e["table"]))
                if t is not None:
                    t.apply_clear()
            elif op == "schema_update":
                self._apply_schema_update(
                    e["space"], e["table"], TableSchema.from_json(e["schema"]), e.get("renames", {})
                )
            elif op == "large_delete_begin":
                self._pending_large_ops[e["id"]] = e
            elif op == "large_op_done":
                self._pending_large_ops.pop(e["id"], None)
            elif op == "rename_table":
                key = (e["space"], e["old"])
                t = self._tables.get(key)  # materialize: snap is name-keyed
                if key in self._tables:
                    del self._tables[key]
                self._schemas.pop(key, None)
                if t is not None:
                    self._tables[(e["space"], e["new"])] = t
                    self._schemas[(e["space"], e["new"])] = t.schema
        except (UniqueViolation, ValidationError, KeyError) as exc:
            # best-effort per entry, but COUNTED and logged: a benign
            # double-apply after a checkpoint race and genuine recovery
            # divergence must be distinguishable in status()
            self._counters["recovery_apply_errors"] += 1
            log.warning(f"WAL replay: {op} entry failed to apply: {exc}")

    # ------------------------------------------------------------- notifications

    @staticmethod
    def _event_rec(t, pk):
        """Record payload for a ChangeEvent: the live row WITHOUT the
        internal ingest-ts field (every read path strips it; watch
        callbacks must see the same shape)."""
        rec = t.store.get(pk)
        if rec is not None:
            rec.pop(INGEST_TS_FIELD, None)
        return rec

    def _notify(self, ev: ChangeEvent):
        if self._txn is not None:
            self._txn.events.append(ev)
            return
        self._dispatch(ev)

    def _dispatch(self, ev: ChangeEvent):
        targets = [(ev.space, ev.table), (ev.space, None)]
        if ev.space == GLOBAL_SPACE:
            # global tables are visible from every space: deliver to
            # watchers registered under any space
            targets += [
                k for k in self._subs
                if k[0] != GLOBAL_SPACE and k[1] in (ev.table, None)
            ]
        seen = set()
        for key in targets:
            if key in seen:
                continue
            seen.add(key)
            for sub in self._subs.get(key, []):
                sub._emit(ev)

    def watch(
        self,
        table: str | None = None,
        callback: Callable | None = None,
        condition: QueryCondition | None = None,
    ) -> Subscription:
        """Change stream for a table (or all tables with table=None),
        optionally filtered by a condition over the changed record
        (reference watch() streams, data_store_impl.dart:6245)."""
        key = (self.current_space, table)
        sub = Subscription(self, key, callback)
        if condition is not None:
            orig = sub._emit

            def emit(ev):
                if ev.record is None or condition.matches(ev.record):
                    orig(ev)

            sub._emit = emit
        self._subs.setdefault(key, []).append(sub)
        return sub

    # ------------------------------------------------------------- FK checks

    def _fk_check_write(self, table: Table, record: dict):
        for fk in table.schema.foreign_keys:
            v = record.get(fk.field)
            if v is None:
                continue
            ref = self._table(fk.references_table)
            rkey = self._tkey(ref)
            if fk.references_field is None or fk.references_field == ref.schema.primary_key.name:
                ok = self._view_exists(ref, rkey, v)
                # parent existence is a READ: a concurrent parent delete
                # must conflict with this txn under serializable
                self._note_read(rkey, v)
            else:
                holder = self._unique_holder(ref, rkey, fk.references_field, v)
                ok = holder is not None
                if holder is not None:
                    self._note_read(rkey, holder)
            if not ok:
                raise ValidationError(
                    f"foreign key violation: {table.schema.name}.{fk.field}={v!r} "
                    f"has no match in {fk.references_table}"
                )

    LARGE_OP_THRESHOLD = 10_000
    # conditional updates at/above this many matched rows take the
    # columnar batch path (one coerce pass per field, one WAL frame)
    BULK_UPDATE_MIN_ROWS = 64

    def _resume_large_delete(self, entry: dict) -> int:
        """Re-execute an unfinished large delete after WAL replay."""
        t = self._tables.get((entry["space"], entry["table"]))
        if t is None:
            return 0
        cond = (
            QueryCondition.from_map(entry["cond"])
            if entry.get("cond") is not None
            else None
        )
        if cond is not None and not cond.is_empty:
            mask = cond.mask(lambda f: t.store.column_view(f), t.store.high)
            targets = [t.store.pk_col.get(r) for r in t.store.rows_for_mask(mask)]
        elif entry.get("all"):
            targets = t.store.pks()
        else:
            return 0
        n = 0
        for p in targets:
            try:
                if self._delete_pk(t, entry["space"], p):
                    n += 1
            except ValidationError as exc:
                log.warning(f"large-delete resume: pk {p!r} skipped: {exc}")
        return n

    def _fk_referencing(self, ref_table: str) -> list[tuple]:
        """(space, name, table, fk) rows whose FK targets `ref_table` —
        cached so cascade deletes stop scanning every table per row
        (invalidated on any schema change via _fk_rev_cache=None)."""
        cache = self._fk_rev_cache
        if cache is None:
            cache = {}
            # built from the SCHEMA catalog (covers lazily-pending tables);
            # the referencing table itself materializes only when a parent
            # delete actually needs to touch it
            for (space, name), schema in list(self._schemas.items()):
                for fk in schema.foreign_keys:
                    cache.setdefault(fk.references_table, []).append(
                        (space, name, fk)
                    )
            self._fk_rev_cache = cache
        return cache.get(ref_table, [])

    def _fk_on_delete(self, table: Table, pk, record: dict):
        """Enforce referencing tables' on_delete actions."""
        for space, name, fk in list(self._fk_referencing(table.schema.name)):
            if space not in (self.current_space, GLOBAL_SPACE):
                continue
            t = self._tables.get((space, name))
            if t is None:
                continue
            ref_field = fk.references_field or table.schema.primary_key.name
            refv = pk if ref_field == table.schema.primary_key.name else record.get(ref_field)
            if refv is None:
                continue
            cond = QueryCondition().where(fk.field, "=", refv)
            hits = t.store.rows_for_mask(
                cond.mask(lambda f: t.store.column_view(f), t.store.high)
            )
            if not len(hits):
                continue
            child_pks = [t.store.pk_col.get(r) for r in hits]
            if fk.on_delete == ForeignKeyAction.restrict:
                raise ValidationError(
                    f"foreign key restrict: {name}.{fk.field} references "
                    f"{table.schema.name} pk={pk!r}"
                )
            if fk.on_delete == ForeignKeyAction.cascade:
                for cpk in child_pks:
                    self._delete_pk(t, space, cpk)
            elif fk.on_delete == ForeignKeyAction.setNull:
                for cpk in child_pks:
                    self._update_pk(t, space, cpk, {fk.field: None})
            # noAction: leave dangling

    # ------------------------------------------------------------- CRUD

    def insert(self, table: str, data: dict) -> DbResult:
        with self._lock, self._timed("insert"):
            if self.resources.writes_blocked():
                return DbResult.error(
                    ResultType.resourceLimit,
                    "writes blocked: resource level critical (reference dsi:1536)",
                )
            t = self._table(table)
            try:
                pk_name = t.schema.primary_key.name
                # resolve expressions BEFORE validation so Expr payloads
                # coerce as their materialized values (mirrors _update_pk);
                # a second pass after validate catches Expr default_values
                rec = resolve_expr_values(
                    {k: v for k, v in data.items() if k != pk_name}, {}, True
                )
                rec = t.validate(rec, is_insert=True)
                pk = data.get(pk_name)
                if pk is None:
                    pk = t.generate_pk()
                self._fk_check_write(t, rec)
                space = GLOBAL_SPACE if t.schema.is_global else self.current_space
                tkey = (space, table)
                buf = self._buffering_txn()
                if buf is not None:
                    return self._txn_insert(buf, t, tkey, pk_name, pk, rec)
                cur = self._txn  # commit-replay txn or None (direct write)
                self._check_reservations(
                    tkey,
                    [("__pk__", pk), *t._unique_entries(pk, rec)],
                    cur.tx_id if cur is not None else None,
                    pk,
                )
                t.apply_insert(pk, rec)
                if cur is not None:
                    cur.undo.append(("delete", t, pk))
                self._wal_append(
                    {"op": "insert", "space": space, "table": table, "pk": pk,
                     "rec": self._walable(rec)}
                )
                self._counters["inserts"] += 1
                self._track_direct_write(tkey, pk)
                self._notify(ChangeEvent("insert", space, table, pk, {**rec, pk_name: pk}))
                return DbResult.success([pk])
            except UniqueViolation as e:
                return DbResult.error(ResultType.uniqueViolation, str(e), [data.get(pk_name)])
            except ValidationError as e:
                code = (
                    ResultType.foreignKeyViolation
                    if "foreign key" in str(e)
                    else ResultType.validationFailed
                )
                return DbResult.error(code, str(e))

    def _txn_insert(self, txn: _Txn, t: Table, tkey, pk_name, pk, rec) -> DbResult:
        """Buffered insert: validate against the thread's view, reserve the
        unique keys engine-wide, stage the op. Nothing touches the base
        store until commit replay."""
        if self._view_exists(t, tkey, pk):
            raise UniqueViolation(t.schema.name, pk_name, pk)
        entries = list(t._unique_entries(pk, rec))
        for name, key in entries:
            holder = self._unique_holder(t, tkey, name, key)
            if holder is not None and holder != pk:
                raise UniqueViolation(t.schema.name, name, key)
        all_entries = [("__pk__", pk)] + entries
        self._check_reservations(tkey, all_entries, txn.tx_id, pk)
        for e in all_entries:
            rkey = (tkey,) + e
            self._unique_res[rkey] = (txn.tx_id, pk)
            txn.reservations.add(rkey)
        txn.overlay.setdefault(tkey, {})[pk] = {**rec, pk_name: pk}
        txn.oplog.append(("insert", tkey, pk, rec))
        txn.write_set.add((tkey, pk))
        return DbResult.success([pk])

    def _bulk_insert_fast(self, table: str, records: list[dict], t=None):
        """Columnar fast path for batch_insert: validate + unique-check per
        record (cheap), then ONE columnar store pass and one WAL group.
        Returns None when the batch needs the general path (FK tables,
        in-transaction, Expr payloads, any failure with atomic semantics).
        `t` overrides name resolution for same-named per-space system
        tables (the KV store's global/local split)."""
        t = t if t is not None else self._table(table)
        if t.schema.foreign_keys or self._txn is not None:
            return None
        space = GLOBAL_SPACE if t.schema.is_global else self.current_space
        pk_name = t.schema.primary_key.name
        for data in records:
            if Expr in map(type, data.values()):
                return None  # general path handles expressions
        # one type-scan pass per FIELD (reference record_compute.dart
        # isolate batches) instead of one validate() call per record
        col_vals, val_errors = t.validate_batch(records)
        ok, failed, errors = [], [], {}
        pks, keep = [], []
        batch_unique: dict[tuple, object] = {}
        uniq_fields = set(t._unique_field_names)
        for _, fields in t._unique_index_specs:
            uniq_fields.update(fields)
        # one lock acquisition for the whole batch's generated ids (gaps on
        # per-record failures are fine — sequences only promise uniqueness)
        seq = t.schema.primary_key.type.value == "sequential"
        gen_iter = None
        if seq and not any(pk_name in r for r in records):
            gen_iter = iter(t._seq.next_batch(len(records)))
        for i, data in enumerate(records):
            if i in val_errors:
                failed.append(data.get(pk_name, i))
                errors[data.get(pk_name, i)] = val_errors[i]
                continue
            pk = data.get(pk_name)
            if pk is None:
                pk = next(gen_iter) if gen_iter is not None else t.generate_pk()
            elif seq:
                t._seq.observe(pk)
            try:
                key_pk = ("pk", pk)
                if pk in t.store or key_pk in batch_unique:
                    raise UniqueViolation(t.schema.name, pk_name, pk)
                # two-phase: check ALL of this record's unique keys first,
                # reserve only after the record fully passes (a failing
                # record must not poison later records' keys)
                entries = [key_pk]
                if uniq_fields:
                    rec_u = {f: col_vals[f][i] for f in uniq_fields if f in col_vals}
                    entries += list(t._unique_entries(pk, rec_u))
                for name, key in entries[1:]:
                    if t.unique_maps[name].get(key) is not None or (name, key) in batch_unique:
                        raise UniqueViolation(t.schema.name, name, key)
                if self._unique_res:  # open txns' op-time reservations
                    self._check_reservations(
                        (space, table),
                        [("__pk__", pk)] + entries[1:],
                        None, pk,
                    )
                for bkey in entries:
                    batch_unique[bkey] = pk
            except UniqueViolation as e:
                failed.append(data.get(pk_name, i))
                errors[data.get(pk_name, i)] = str(e)
                continue
            pks.append(pk)
            keep.append(i)
            ok.append(pk)
        if pks:
            if len(keep) == len(records):
                final_cols = col_vals
            else:
                final_cols = {
                    name: [vals[i] for i in keep] for name, vals in col_vals.items()
                }
            t.bulk_apply_insert_cols(pks, final_cols)
            self._wal_append(
                {"op": "batch_insert_cols", "space": space, "table": table,
                 "pks": pks, "cols": final_cols}
            )
            self._counters["inserts"] += len(pks)
            if self._active_txns:  # visible to serializable validation
                self._record_commit({((space, table), pk) for pk in pks})
            if self._subs:
                names = list(final_cols)
                for j, pk in enumerate(pks):
                    rec = {name: final_cols[name][j] for name in names}
                    rec[pk_name] = pk
                    self._notify(ChangeEvent("insert", space, table, pk, rec))
        if failed and ok:
            return DbResult.partial(ok, failed, errors)
        if failed:
            return DbResult.error(
                ResultType.validationFailed, next(iter(errors.values())), failed, errors
            )
        return DbResult.success(ok)

    def batch_insert(self, table: str, records: list[dict], allow_partial: bool = True) -> DbResult:
        with self._lock, self._wal_group(), self._timed("batch_insert"):
            if allow_partial:
                if self.resources.writes_blocked():
                    return DbResult.error(
                        ResultType.resourceLimit, "writes blocked: resource level critical"
                    )
                fast = self._bulk_insert_fast(table, records)
                if fast is not None:
                    return fast
            return self._batch_insert_general(table, records, allow_partial)

    def _batch_insert_general(self, table, records, allow_partial) -> DbResult:
        ok, failed, errors = [], [], {}
        with self._lock:
            for i, rec in enumerate(records):
                r = self.insert(table, rec)
                if r.is_success:
                    ok.extend(r.success_keys)
                else:
                    key = rec.get(self._table(table).schema.primary_key.name, i)
                    failed.append(key)
                    errors[key] = r.message
                    if not allow_partial:
                        # roll back the ones already applied (under the
                        # table's own space — a global table's compensating
                        # deletes must replay against the global key)
                        t = self._table(table)
                        space = GLOBAL_SPACE if t.schema.is_global else self.current_space
                        for pk in ok:
                            self._delete_pk(t, space, pk, wal=True)
                        return DbResult.error(
                            ResultType.validationFailed, r.message, failed, errors
                        )
        if failed and ok:
            return DbResult.partial(ok, failed, errors)
        if failed:
            return DbResult.error(
                ResultType.validationFailed, next(iter(errors.values())), failed, errors
            )
        return DbResult.success(ok)

    def upsert(self, table: str, data: dict) -> DbResult:
        """Insert, or update when the PK (or a unique field) already matches
        (reference upsert semantics, tostore.dart batchUpsert)."""
        with self._lock:
            t = self._table(table)
            tkey = self._tkey(t)
            pk_name = t.schema.primary_key.name
            pk = data.get(pk_name)
            if pk is None:
                # try unique-field match (overlay-aware inside transactions)
                for f in t.schema.unique_fields():
                    v = data.get(f)
                    if v is not None:
                        holder = self._unique_holder(t, tkey, f, v)
                        if holder is not None:
                            pk = holder
                            break
            if pk is not None and self._view_exists(t, tkey, pk):
                return self.update(
                    table, {k: v for k, v in data.items() if k != pk_name}, pk=pk
                )
            return self.insert(table, data)

    def batch_upsert(self, table: str, records: list[dict]) -> DbResult:
        with self._lock, self._wal_group(), self._timed("batch_upsert"):
            if self.resources.writes_blocked():
                return DbResult.error(
                    ResultType.resourceLimit,
                    "writes blocked: resource level critical",
                )
            fast = self._bulk_upsert_fast(table, records)
            if fast is not None:
                return fast
            ok, failed, errors = [], [], {}
            return self._batch_upsert_inner(table, records, ok, failed, errors)

    def _bulk_upsert_fast(self, table: str, records: list[dict]) -> DbResult | None:
        """Split a pk-carrying batch into new rows (columnar bulk insert)
        and existing rows (columnar bulk update). Both fast paths bail
        with None BEFORE mutating anything, so falling back to the
        per-record loop is always safe."""
        t = self._table(table)
        pk_name = t.schema.primary_key.name
        if t.schema.foreign_keys or self._txn is not None \
                or self._buffering_txn() is not None:
            return None
        if not all(r.get(pk_name) is not None for r in records):
            return None  # unique-field upsert matching: general path
        if len({r[pk_name] for r in records}) != len(records):
            return None  # intra-batch duplicate pks are sequential upserts
        exist = [r for r in records if r[pk_name] in t.store]
        new = [r for r in records if r[pk_name] not in t.store]
        r_upd = (
            self._bulk_update_fast(t, exist) if exist else DbResult.success([])
        )
        if r_upd is None:
            return None  # nothing applied yet
        if new:
            r_new = self._bulk_insert_fast(table, new)
            if r_new is None:  # updates already applied; inserts per-record
                r_new = self._batch_insert_general(table, new, True)
        else:
            r_new = DbResult.success([])
        ok = (r_upd.success_keys or []) + (r_new.success_keys or [])
        failed = (r_upd.failed_keys or []) + (r_new.failed_keys or [])
        errors = {**(r_upd.errors or {}), **(r_new.errors or {})}
        return self._batch_result(ok, failed, errors)

    def _batch_upsert_inner(self, table, records, ok, failed, errors) -> DbResult:
        for rec in records:
            r = self.upsert(table, rec)
            if r.is_success:
                ok.extend(r.success_keys)
            else:
                failed.extend(r.failed_keys or ["?"])
                errors.update(r.errors or {})
        if failed and ok:
            return DbResult.partial(ok, failed, errors)
        if failed:
            return DbResult.error(ResultType.validationFailed, "batch upsert failures", failed, errors)
        return DbResult.success(ok)

    @staticmethod
    def _batch_result(ok, failed, errors) -> DbResult:
        """Shared success/partial/error assembly of the batch paths."""
        if failed and ok:
            return DbResult.partial(ok, failed, errors)
        if failed:
            return DbResult.error(
                ResultType.validationFailed,
                next(iter(errors.values()), "batch failures"),
                failed, errors,
            )
        return DbResult.success(ok)

    def batch_update(self, table: str, records: list[dict]) -> DbResult:
        """Each record carries the PK; the remaining fields are updates.
        Columnar fast path (one coerce pass per field, one store pass, one
        WAL frame — reference batch_update_compute.dart) when the batch is
        uniform, expression-free, outside transactions, and touches no
        PK/unique/FK machinery; otherwise per-record semantics identical
        to update()."""
        with self._lock, self._wal_group(), self._timed("batch_update"):
            if self.resources.writes_blocked():
                return DbResult.error(
                    ResultType.resourceLimit,
                    "writes blocked: resource level critical",
                )
            t = self._table(table)
            fast = self._bulk_update_fast(t, records)
            if fast is not None:
                return fast
            return self._batch_update_general(t, records)

    def _bulk_update_fast(self, t: Table, records: list[dict]) -> DbResult | None:
        if t.schema.foreign_keys or self._txn is not None \
                or self._buffering_txn() is not None:
            return None
        if not records:
            return DbResult.success([])
        space = GLOBAL_SPACE if t.schema.is_global else self.current_space
        pk_name = t.schema.primary_key.name
        fields = set(records[0])
        if pk_name not in fields or len(fields) < 2:
            return None
        fset = fields - {pk_name}
        known = {f.name for f in t.schema.fields}
        if fset - known:
            return None  # unknown fields: general path reports them
        uniq = set(t._unique_field_names)
        for _, fl in t._unique_index_specs:
            uniq.update(fl)
        if uniq & fset:
            return None  # unique-map maintenance needs the general path
        for r in records:
            if set(r) != fields:
                return None  # non-uniform batch
            if Expr in map(type, r.values()):
                return None
        err_idx: dict[int, str] = {}
        cols = {
            f.name: t._coerce_column(f, records, err_idx)
            for f in t.schema.fields
            if f.name in fset
        }
        pks = [r[pk_name] for r in records]
        ok, failed, errors = [], [], {}
        keep, rows = [], []
        for i, pk in enumerate(pks):
            if i in err_idx:
                failed.append(pk)
                errors[pk] = err_idx[i]
            elif (row := t.store.rowid(pk)) is None:
                failed.append(pk)
                errors[pk] = "record not found"
            else:
                keep.append(i)
                rows.append(row)
                ok.append(pk)
        if keep:
            final = (
                cols if len(keep) == len(records)
                else {n: [v[i] for i in keep] for n, v in cols.items()}
            )
            kept_pks = [pks[i] for i in keep]
            t.bulk_apply_update_cols(kept_pks, np.asarray(rows, np.int64), final)
            self._wal_append(
                {"op": "batch_update_cols", "space": space,
                 "table": t.schema.name, "pks": kept_pks, "cols": final}
            )
            self._counters["updates"] += len(keep)
            tkey = (space, t.schema.name)
            if self._active_txns:  # visible to serializable validation
                self._record_commit({(tkey, pk) for pk in kept_pks})
            if self._subs:
                for pk in kept_pks:
                    self._notify(ChangeEvent(
                        "update", space, t.schema.name, pk,
                        self._event_rec(t, pk),
                    ))
        return self._batch_result(ok, failed, errors)

    def _batch_update_general(self, t: Table, records: list[dict]) -> DbResult:
        pk_name = t.schema.primary_key.name
        ok, failed, errors = [], [], {}
        for i, rec in enumerate(records):
            pk = rec.get(pk_name)
            if pk is None:
                failed.append(None)
                errors[f"record_{i}"] = "missing primary key"
                continue
            r = self.update(
                t.schema.name,
                {k: v for k, v in rec.items() if k != pk_name},
                pk=pk,
            )
            if r.is_success and r.success_keys:
                ok.append(pk)
            else:
                failed.append(pk)
                errors[pk] = r.message or "record not found"
        return self._batch_result(ok, failed, errors)

    def _update_pk(self, t: Table, space: str, pk, updates: dict) -> dict | None:
        tkey = (space, t.schema.name)
        buf = self._buffering_txn()
        if buf is not None:
            return self._txn_update(buf, t, tkey, pk, updates)
        old = t.store.get(pk)
        if old is None:
            return None
        resolved = resolve_expr_values(updates, old, False)
        resolved = t.validate(resolved, is_insert=False)
        resolved = {k: v for k, v in resolved.items() if k in updates}
        self._fk_check_write(t, {**old, **resolved})
        cur = self._txn
        self._check_reservations(
            tkey,
            [
                e for e in t._unique_entries(pk, {**old, **resolved})
                if t.unique_maps.get(e[0], {}).get(e[1]) != pk
            ],
            cur.tx_id if cur is not None else None,
            pk,
        )
        before = t.apply_update(pk, resolved)
        if cur is not None and before is not None:
            cur.undo.append(("update", t, pk, {k: before.get(k) for k in resolved}))
        self._wal_append(
            {"op": "update", "space": space, "table": t.schema.name, "pk": pk,
             "updates": self._walable(resolved)}
        )
        self._counters["updates"] += 1
        self._track_direct_write(tkey, pk)
        self._notify(
            ChangeEvent("update", space, t.schema.name, pk, self._event_rec(t, pk))
        )
        return before

    def _txn_update(self, txn: _Txn, t: Table, tkey, pk, updates: dict) -> dict | None:
        """Buffered update. Literal updates resolve against the thread's
        view at op time and replay the resolved values at commit (the
        value may embed prior reads, so first-committer-wins validation
        keeps the write in the conflict footprint).

        ALL-Expr updates (`{"val": Expr.field("val") + 1}` — the
        reference's atomic-update surface, README.md:612-668) are BLIND:
        the txn's behavior never observes the row, so the Expr is buffered
        UNRESOLVED and re-resolves against live state at commit replay
        (under the engine lock). Such writes are exempt from this txn's
        own write-footprint validation (`txn.commutes`): concurrent
        hot-row increments all commit, each applying on top of the last —
        commit order is a valid serial order for blind writes. Reading the
        row (get_by_pk/query) still lands in read_set/pred_reads, which
        always conflict, so read-modify-write stays protected; a later
        literal write to the same pk demotes it. The overlay carries an
        op-time provisional resolution so same-txn read-back is coherent
        (and that read-back itself restores conflict detection)."""
        cur = self._view_get(t, tkey, pk)
        if cur is None:
            return None
        resolved = resolve_expr_values(updates, cur, False)
        resolved = t.validate(resolved, is_insert=False)
        resolved = {k: v for k, v in resolved.items() if k in updates}
        merged = {**cur, **resolved}
        self._fk_check_write(t, merged)
        # only values the txn NEWLY claims need checks + reservations; a
        # value this pk already holds in the base is not contested (a
        # concurrent same-row writer conflicts via the write-set instead)
        entries = [
            e for e in t._unique_entries(pk, merged)
            if t.unique_maps.get(e[0], {}).get(e[1]) != pk
        ]
        for name, key in entries:
            holder = self._unique_holder(t, tkey, name, key)
            if holder is not None and holder != pk:
                raise UniqueViolation(t.schema.name, name, key)
        self._check_reservations(tkey, entries, txn.tx_id, pk)
        for e in entries:
            rkey = (tkey,) + e
            self._unique_res[rkey] = (txn.tx_id, pk)
            txn.reservations.add(rkey)
        txn.overlay.setdefault(tkey, {})[pk] = merged
        blind = bool(updates) and all(
            isinstance(v, Expr) for v in updates.values()
        )
        if blind and (
            (tkey, pk) not in txn.write_set or (tkey, pk) in txn.commutes
        ):
            txn.oplog.append(("update", tkey, pk, dict(updates)))
            txn.commutes.add((tkey, pk))
        else:
            txn.oplog.append(("update", tkey, pk, resolved))
            txn.commutes.discard((tkey, pk))
        txn.write_set.add((tkey, pk))
        return {k: cur.get(k) for k in resolved}

    def update(
        self,
        table: str,
        updates: dict,
        condition: QueryCondition | None = None,
        pk=None,
        allow_update_all: bool = False,
    ) -> DbResult:
        with self._lock:
            t = self._table(table)
            space = GLOBAL_SPACE if t.schema.is_global else self.current_space
            try:
                tkey = (space, t.schema.name)
                if pk is not None:
                    pks = [pk] if self._view_exists(t, tkey, pk) else []
                elif condition is not None and not condition.is_empty:
                    pks = self._match_pks(t, tkey, condition)
                elif allow_update_all:
                    pks = self._all_pks(t, tkey)
                else:
                    return DbResult.error(
                        ResultType.validationFailed,
                        "update without condition requires allow_update_all",
                    )
                if (
                    len(pks) >= self.BULK_UPDATE_MIN_ROWS
                    and pk is None
                    and self._txn is None
                    and self._buffering_txn() is None
                    and updates
                    and not any(isinstance(v, Expr) for v in updates.values())
                ):
                    # large literal conditional update: one columnar pass +
                    # one WAL frame via the batch_update machinery
                    # (_bulk_update_fast re-checks FK/unique/unknown-field
                    # eligibility and returns None to fall back here).
                    # Strip the pk from the payload: the per-row path
                    # ignores it, and {pk_name: p, **updates} would let it
                    # override the row selector.
                    pk_name = t.schema.primary_key.name
                    ups = {k: v for k, v in updates.items() if k != pk_name}
                    fast = (
                        self._bulk_update_fast(
                            t, [{pk_name: p, **ups} for p in pks]
                        )
                        if ups
                        else None
                    )
                    if fast is not None:
                        return fast
                ok, failed, errors = [], [], {}
                for p in pks:
                    try:
                        if self._update_pk(t, space, p, updates) is not None:
                            ok.append(p)
                    except (UniqueViolation, ValidationError, ZeroDivisionError) as e:
                        failed.append(p)
                        errors[p] = str(e)
                if failed and not ok:
                    return DbResult.error(
                        ResultType.validationFailed, next(iter(errors.values())), failed, errors
                    )
                if failed:
                    return DbResult.partial(ok, failed, errors)
                return DbResult.success(ok)
            except (UniqueViolation, ValidationError) as e:
                return DbResult.error(ResultType.validationFailed, str(e))

    def _delete_pk(self, t: Table, space: str, pk, wal: bool = True):
        tkey = (space, t.schema.name)
        buf = self._buffering_txn()
        if buf is not None:
            # buffered tombstone; FK restrict/cascade runs at commit replay
            # (the reference defers heavy deletes + cascade ops to commit,
            # transaction_manager.dart:41-60)
            if not self._view_exists(t, tkey, pk):
                return False
            buf.overlay.setdefault(tkey, {})[pk] = _TOMBSTONE
            buf.oplog.append(("delete", tkey, pk, None))
            buf.write_set.add((tkey, pk))
            buf.commutes.discard((tkey, pk))  # delete is not commutative
            return True
        old = t.store.get(pk)
        if old is None:
            return False
        self._fk_on_delete(t, pk, old)
        t.apply_delete(pk)
        if self._txn is not None:
            self._txn.undo.append(("insert", t, pk, old))
        if wal:
            self._wal_append({"op": "delete", "space": space, "table": t.schema.name, "pk": pk})
        self._counters["deletes"] += 1
        self._track_direct_write(tkey, pk)
        self._notify(ChangeEvent("delete", space, t.schema.name, pk, old))
        return True

    def delete(
        self,
        table: str,
        condition: QueryCondition | None = None,
        pk=None,
        pks=None,
        allow_delete_all: bool = False,
    ) -> DbResult:
        with self._lock:
            t = self._table(table)
            space = GLOBAL_SPACE if t.schema.is_global else self.current_space
            try:
                tkey = (space, t.schema.name)
                if pk is not None:
                    targets = [pk]
                elif pks is not None:
                    targets = list(pks)
                elif condition is not None and not condition.is_empty:
                    targets = self._match_pks(t, tkey, condition)
                elif allow_delete_all:
                    targets = self._all_pks(t, tkey)
                else:
                    return DbResult.error(
                        ResultType.validationFailed,
                        "delete without condition requires allow_delete_all",
                    )
                # resumable large deletes (reference
                # large_operation_runner.dart:26 + wal_manager.dart:78-131
                # LargeDeleteMeta): persist the CONDITION before the row
                # deletes start, mark done after — a crash mid-way resumes
                # the remainder on reopen (row deletes are idempotent)
                op_id = None
                if len(targets) >= self.LARGE_OP_THRESHOLD and pk is None and pks is None:
                    op_id = uuid.uuid4().hex
                    self._wal_append(
                        {"op": "large_delete_begin", "id": op_id, "space": space,
                         "table": table,
                         "cond": condition.to_map() if condition is not None else None,
                         "all": bool(allow_delete_all)}
                    )
                kept = self._bulk_delete_core(t, space, list(targets))
                if kept is not None:
                    if op_id is not None:
                        self._wal_append({"op": "large_op_done", "id": op_id})
                    return DbResult.success(kept)
                ok = [p for p in targets if self._delete_pk(t, space, p)]
                if op_id is not None:
                    self._wal_append({"op": "large_op_done", "id": op_id})
                return DbResult.success(ok)
            except ValidationError as e:
                return DbResult.error(ResultType.foreignKeyViolation, str(e))

    def _bulk_delete_core(self, t, space, targets: list):
        """Columnar bulk delete: one store patch, one WAL frame; olds
        materialize only when watchers exist. Returns the kept pk list,
        or None when the per-row path must run (small batches, open
        transactions, FK-referenced tables) — nothing is mutated then."""
        if (
            len(targets) < self.BULK_UPDATE_MIN_ROWS
            or self._txn is not None
            or self._buffering_txn() is not None
            or list(self._fk_referencing(t.schema.name))
        ):
            return None
        need_olds = bool(self._subs)
        kept, olds = t.bulk_apply_delete(targets, need_olds)
        if kept:
            self._wal_append(
                {"op": "batch_delete", "space": space,
                 "table": t.schema.name, "pks": kept}
            )
            self._counters["deletes"] += len(kept)
            if self._active_txns:
                self._record_commit(
                    {((space, t.schema.name), p) for p in kept}
                )
            if need_olds:
                for p, old in zip(kept, olds):
                    old.pop(INGEST_TS_FIELD, None)
                    self._notify(ChangeEvent(
                        "delete", space, t.schema.name, p, old
                    ))
        return kept

    def clear(self, table: str) -> DbResult:
        with self._lock:
            t = self._table(table)
            space = GLOBAL_SPACE if t.schema.is_global else self.current_space
            t.apply_clear()
            self._wal_append({"op": "clear", "space": space, "table": table})
            self._notify(ChangeEvent("clear", space, table, None))
            return DbResult.success()

    # ------------------------------------------------------------- reads

    def get_by_pk(self, table: str, pk) -> dict | None:
        self.workload.note_foreground()
        with self._shared:  # no torn reads of mid-update records
            t = self._table(table)
            tkey = self._tkey(t)
            self._note_read(tkey, pk)
            rec = self._view_get(t, tkey, pk)
        if rec is not None:
            rec.pop(INGEST_TS_FIELD, None)
            self.weights.record_access(table, pk)
        return rec

    def check_integrity(self) -> dict:
        """Structure + sampled record validation (reference
        integrity_checker.dart)."""
        with self._lock:
            return self._integrity.check_database(self)

    PREWARM_KS = (1, 10)  # top_k shapes searched ahead (k=10 is the
    # engine default). On the card the first search of a kernel pays its
    # nvcc build (ops/_kernels.py, one lock around build-and-load, so this
    # thread and a foreground search may race to it)

    def prewarm(self, table: str | None = None):
        """Flush buffered vector writes and run one search per index, so
        that the kernels are built and loaded
        (reference loadDataToCache/prewarm, data_store_impl.dart:5441).
        Tables warm hottest-first by recorded access weights (reference
        prewarm consumer data_store_impl.dart:5723 orders by weight)."""
        with self._lock:
            if table:
                tables = [self._table(table)]
            else:
                # explicit prewarm = the reference's loadDataToCache:
                # materialize lazily-pending tables too
                self._tables.materialize_all()
                tables = [t for (_, n), t in self._tables.items()]
        tables.sort(key=lambda t: -self.weights.table_weight(t.schema.name))
        for t in tables:
            with self._lock:  # flush mutates pending dicts shared with CRUD
                t.flush_vectors()
                indexes = list(t.vector_indexes.values())
            for vi in indexes:
                if len(vi):
                    if getattr(vi, "trained", True) is False:
                        with rw(vi).write():  # lazy train mutates: exclusive
                            vi.train()
                    with rw(vi).read():  # warm off-lock, like real searches
                        for kk in self.PREWARM_KS:
                            vi.search(np.zeros(vi.dims, np.float32), top_k=kk)

    def run_cache_maintenance(self) -> int:
        """Periodic weight decay + memory-pressure cache eviction
        (reference weight_manager decay via crontab + cache_manager
        eviction under the resource budget). Returns entries evicted."""
        self.weights.decay()
        with self._lock:  # the query path mutates the cache under the lock
            evicted = self.executor.shrink_under_pressure(self.resources.level())
        if evicted:
            self._counters["cache_pressure_evictions"] = (
                self._counters.get("cache_pressure_evictions", 0) + evicted
            )
        return evicted

    def explain(self, table: str, spec=None) -> dict:
        """Query plan description (reference query_plan.dart explain())."""
        from ..query.executor import QuerySpec

        t = self._table(table)
        info = self.executor.choose_plan(t, spec or QuerySpec())
        return {
            "plan": info.plan,
            "index": info.index,
            "estimated_rows": info.estimated_rows,
            "ordered": bool(info.ordered or info.ordered_rev),
        }

    WEIGHT_SAMPLE = 32  # result-pks recorded per query (weights are sampled)

    def query(self, table: str, spec: QuerySpec | None = None):
        self._bump("queries")
        # SHARED mode: concurrent queries execute in parallel (reference
        # shared query locks); mutators hold exclusive so no torn reads
        with self._shared, self._timed("query"):
            t = self._table(table)
            tkey = self._tkey(t)
            # predicate reads are noted inside the executor, where the
            # read-time match set is available (narrow validation)
            overlay = self._overlay_for(tkey)
            res = self.executor.execute(
                self.current_space, table, spec or QuerySpec(), overlay=overlay
            )
        pk_name = t.schema.primary_key.name
        pks = [
            pk for r in res.records[: self.WEIGHT_SAMPLE]
            if (pk := r.get(pk_name)) is not None  # aggregates carry no pk
        ]
        if pks:
            self.weights.record_accesses(table, pks)
        return res

    def count(self, table: str, condition: QueryCondition | None = None) -> int:
        with self._shared:
            t = self._table(table)
            tkey = self._tkey(t)
            ov = self._overlay_for(tkey)
            if condition is None or condition.is_empty:
                # whole-table read: inserts/deletes anywhere change it
                self._note_read(tkey)
                if not ov:
                    return len(t.store)
                return len(self._all_pks(t, tkey))
            if ov:
                return len(self._match_pks(t, tkey, condition))
            mask = condition.mask(lambda f: t.store.column_view(f), t.store.high)
            rows = t.store.rows_for_mask(mask)
            if self._buffering_txn() is not None:
                self._note_pred_read(
                    tkey, condition,
                    [t.store.pk_col.get(int(r)) for r in rows]
                    if len(rows) <= self.PRED_READ_MAX_PKS else None,
                )
            return int(len(rows))

    # ------------------------------------------------------------- vector search

    def vector_search(
        self,
        table: str,
        field: str,
        query,
        top_k: int = 10,
        threshold: float | None = None,
        condition: QueryCondition | None = None,
        nprobe: int | None = None,
        include_records: bool = False,
        mode: str | None = None,
    ) -> list[VectorSearchResult]:
        """The north-star read path (reference tostore.dart:493 ->
        vector_index_manager.dart:475). Hybrid filtering turns the structured
        predicate into a slot bitmask folded into the scan kernel.

        mode: None (index default from VectorIndexConfig.search_mode) |
        'auto' (flat scans may use per-lane candidate selection, miss
        ~1e-5..1e-8/query) | 'exact' (zero-miss full scan; on IVF this
        bypasses the probe — reference exact semantics) | 'fast' (accepted
        for configs written for the JAX package, whose `fast` is the TPU's
        hardware-binned top-k; the card has no such unit and the port
        serves it as 'auto', ops/topk.py)."""
        self._bump("vector_searches")
        with self._timed("vector_search"):
            # CAPTURE under the engine lock (flush pending writes, resolve
            # the index, build the predicate slot mask, pin the index in
            # SHARED mode), then run the multi-millisecond device dispatch
            # with the engine lock RELEASED so concurrent searches pipeline
            # on the device and CRUD proceeds — the reference's shared
            # query locks (lock_manager.dart:38-44) + concurrent leases
            # (workload_scheduler.dart:48-53), done RCU-style: the shared
            # index lock, acquired before the engine lock drops, guarantees
            # corpus layout and slot mask stay mutually consistent.
            with self._lock:
                t = self._table(table)
                self._note_read(self._tkey(t))  # predicate read
                idx = t.vector_index_for(field)
                pending_del, pending_filt = self._flush_or_defer(t, idx, field)
                if (
                    getattr(idx, "trained", True) is False
                    and len(idx)
                    and not getattr(idx, "defer_retrain", False)
                ):
                    # library-style index: lazy first train (search() must
                    # not mutate). Engine-owned indexes serve the exact
                    # flat fallback until background maintenance builds —
                    # a bulk load must never pay k-means inside a search
                    # under the engine lock
                    with rw(idx).write():
                        idx.train()
                slot_mask = self._vector_slot_mask(t, idx, field, condition)
                kwargs = {}
                if nprobe is not None and idx.index_type in ("ivf", "sharded_ivf"):
                    kwargs["nprobe"] = nprobe
                eff_mode = mode or getattr(idx, "search_mode", "auto")
                if eff_mode != "auto":
                    kwargs["mode"] = eff_mode
                ov = self._overlay_for(self._tkey(t))
                ov_keys = set(ov) if ov else None
                lock = rw(idx)
                lock.acquire_read()
            try:
                hits = idx.search(
                    np.asarray(query, np.float32), top_k=top_k,
                    threshold=threshold, slot_mask=slot_mask, **kwargs
                )
            finally:
                lock.release_read()
        if ov_keys:
            # own-transaction overlay: a row deleted or rewritten in the
            # open txn must not surface from the committed index (buffered
            # INSERTS become searchable at commit + flush, matching the
            # reference's flush-deferred vector index updates)
            hits = [r for r in hits if r.primary_key not in ov_keys]
        if pending_del:
            # deferred-flush window: committed deletes whose tombstones
            # have not reached the device yet must not surface
            hits = [r for r in hits if r.primary_key not in pending_del]
        if pending_filt and condition is not None and not condition.is_empty:
            # deferred-flush window, filter columns: the device slot mask
            # was built from stale column values for these pks — re-check
            # hit rows against the LIVE condition so an explicit predicate
            # is never violated (rows that newly MATCH may still be
            # omitted until the flush lands: same bounded staleness as
            # pending inserts, documented at _flush_or_defer)
            def _still_matches(pk):
                rec = self.get_by_pk(table, pk)
                return rec is not None and condition.matches(rec)

            hits = [
                r for r in hits
                if r.primary_key not in pending_filt
                or _still_matches(r.primary_key)
            ]
        if include_records:
            hits = [
                VectorSearchResult(
                    r.primary_key, r.distance, r.score, self.get_by_pk(table, r.primary_key)
                )
                for r in hits
            ]
        for h in hits[: self.WEIGHT_SAMPLE]:
            self.weights.record_access(table, h.primary_key)
        return hits

    # bounded-staleness vector flush (reference writeChanges runs on the
    # async background write scheduler — searches there never force-flush
    # either): a search flushes pending index writes eagerly when the
    # index is uncontended, but if other searches are mid-dispatch
    # (shared mode held), waiting for exclusive mode WHILE HOLDING THE
    # ENGINE LOCK would convoy the whole engine behind one flush.
    # Instead the flush defers — results may omit rows staged in
    # the last VEC_FLUSH_FORCE_AGE_S seconds / VEC_FLUSH_FORCE_ROWS rows
    # — until either bound trips, which forces a blocking flush. Pending
    # DELETES never surface: the capture returns them for post-filtering.
    VEC_FLUSH_FORCE_ROWS = 512
    VEC_FLUSH_FORCE_AGE_S = 1.0
    # background retrain/compact waits for this quiet window after the
    # last corpus mutation (bulk loads build ONCE at the end), bounded so
    # steady writers can't starve maintenance forever
    VEC_MAINT_QUIESCENCE_S = 2.0
    VEC_MAINT_MAX_SKIPS = 10

    def _flush_or_defer(self, t, idx, field):
        """Called under the engine lock. Returns (pending-delete pks,
        pending-filter-update pks) when the flush was deferred, else
        (None, None). Both sets post-filter results: tombstoned rows must
        never surface, and rows whose staged filter-column updates have
        not reached the device yet must be re-checked against the LIVE
        condition (the stale device column would otherwise return rows
        that no longer satisfy the caller's explicit predicate)."""
        pend_n = t.vec_pending_count(field)
        if not pend_n:
            return None, None
        if (
            pend_n >= self.VEC_FLUSH_FORCE_ROWS
            or t.vec_pending_age(field) >= self.VEC_FLUSH_FORCE_AGE_S
        ):
            t.flush_vectors(field)  # bound tripped: block (staleness cap)
            return None, None
        lk = rw(idx)
        if lk.try_acquire_write():
            try:
                t.flush_vectors(field)  # uncontended: flush eagerly
            finally:
                lk.release_write()
            return None, None
        self._counters["vector_flush_deferred"] = (
            self._counters.get("vector_flush_deferred", 0) + 1
        )
        pend = t._vec_pending.get(field) or {}
        fpend = t._filter_pending.get(field) or {}
        return (
            frozenset(pk for pk, v in pend.items() if v is None) or None,
            frozenset(fpend) or None,
        )

    def _vector_slot_mask(self, t, idx, field, condition):
        """Hybrid-filter slot mask, computed under the engine lock."""
        if condition is None or condition.is_empty:
            return None
        from ..vector import filters

        fc = idx.corpus.filter_columns
        device_ok = filters.compilable(
            condition, set(t.filter_fields) & fc.names()
        )
        if device_ok and idx.corpus.capacity:
            for name in condition.referenced_fields():
                fc.ensure(name, idx.corpus.capacity)
            return filters.device_mask(condition, fc, idx.corpus.capacity)
        # host fallback: LIKE/text predicates, unindexed fields
        mask = condition.mask(lambda f: t.store.column_view(f), t.store.high)
        rows = t.store.rows_for_mask(mask)
        allowed = [t.store.pk_col.get(r) for r in rows]
        # the scan wants the mask on the corpus's device
        return torch.from_numpy(t.slot_mask_from_pks(field, allowed)).to(
            idx.corpus.device
        )

    # ------------------------------------------------------------- transactions

    @contextlib.contextmanager
    def _transaction_cm(self):
        if self._txn is not None:
            # nested: flatten into outer txn (reference nests zones)
            yield Transaction(self, self._txn)
            return
        txn = _Txn(self, uuid.uuid4().hex[:16])
        with self._lock:
            txn.begin_seq = self._commit_seq
            self._active_txns.add(txn)
        self._txn = txn
        try:
            yield Transaction(self, txn)
        except BaseException:
            self._abort_buffered(txn)
            raise
        else:
            self._commit_buffered(txn)

    def transaction(
        self,
        action: Callable | None = None,
        *,
        retries: int = 0,
        backoff: float = 0.002,
        max_backoff: float = 0.25,
    ):
        """Context-manager or callback form (reference tostore.dart:860).

        With `retries=N` the callback form re-runs `action` in a fresh
        transaction after a first-committer-wins `txn_conflict` abort,
        sleeping an exponentially growing, jittered delay between attempts
        (the retry loop every hot-row caller would otherwise hand-roll —
        reference transaction_manager.dart:30-36 surfaces the same conflict
        to the caller). The action must therefore be idempotent side-effect
        free outside the transaction. Business/validation failures never
        retry: only optimistic-concurrency conflicts do.

        Pessimistic escalation (reference lock_manager.dart:38-44): from
        the `escalate_after`-th conflict on, the retry serializes through
        short exclusive locks on the keys it has conflicted over — hot
        read-modify-write rows stop burning optimistic work (r4 measured
        57% aborts on the hot-row shape) and commit in lock order instead.
        Locks are held only for the attempt and sorted for deadlock
        freedom; direct writers never take them, so this is purely a
        goodput escalation, not a new consistency mechanism.
        """
        if action is None:
            return self._transaction_cm()
        attempt = 0
        hot_keys: tuple = ()
        while True:
            locks = self._acquire_hot_locks(hot_keys) if hot_keys else []
            try:
                try:
                    with self._transaction_cm() as tx:
                        result = action(tx)
                    return TransactionResult(
                        True, result, tx_id=tx.tx_id, retries=attempt
                    )
                except BusinessError as e:
                    if getattr(e, "code", None) == "txn_conflict" and attempt < retries:
                        attempt += 1
                        self._bump("txn_retries")  # runs outside the engine lock
                        if attempt >= self.config.txn_escalate_after:
                            hot_keys = tuple(sorted(
                                set(hot_keys)
                                | set(getattr(e, "conflict_keys", ())),
                                key=repr,
                            ))
                            self._bump("txn_escalations")
                            continue  # the lock provides the ordering: no sleep
                        import random

                        delay = min(backoff * (2 ** (attempt - 1)), max_backoff)
                        time.sleep(delay * (0.5 + random.random()))
                        continue
                    return TransactionResult(False, None, str(e), retries=attempt)
                except (UniqueViolation, ValidationError) as e:
                    return TransactionResult(False, None, str(e), retries=attempt)
            finally:
                for lk in reversed(locks):
                    lk.release()

    def _acquire_hot_locks(self, keys) -> list:
        """Exclusive per-(table, pk) escalation locks, acquired in sorted
        order (deadlock freedom). The registry is pruned of unheld locks
        when it grows past a few thousand keys."""
        locks = []
        for key in keys:
            with self._hot_lock_guard:
                lk = self._hot_locks.get(key)
                if lk is None:
                    if len(self._hot_locks) > 4096:
                        for k in [
                            k for k, v in self._hot_locks.items()
                            if not v.locked()
                        ]:
                            del self._hot_locks[k]
                    lk = self._hot_locks[key] = threading.Lock()
            lk.acquire()
            locks.append(lk)
        return locks

    def _release_txn(self, txn: _Txn):
        for key in txn.reservations:
            owner = self._unique_res.get(key)
            if owner is not None and owner[0] == txn.tx_id:
                del self._unique_res[key]
        self._active_txns.discard(txn)
        self._txn = None

    def _abort_buffered(self, txn: _Txn):
        with self._lock:
            self._release_txn(txn)

    def _record_commit(self, write_set):
        """Register a committed write-set for first-committer-wins
        validation; pruned to what an active transaction could still see."""
        self._commit_seq += 1
        if not self._active_txns:
            self._recent_commits.clear()
            return
        self._recent_commits.append((self._commit_seq, frozenset(write_set)))
        horizon = min(t.begin_seq for t in self._active_txns)
        while self._recent_commits and self._recent_commits[0][0] <= horizon:
            self._recent_commits.pop(0)

    def _track_direct_write(self, tkey, pk):
        """Direct (non-transaction) mutations count as tiny committed txns
        for conflict detection — only tracked while transactions are open."""
        if self._active_txns and self._txn is None:
            self._record_commit({(tkey, pk)})

    def _pred_conflicts(self, pred_reads, wset) -> set:
        """Precise phantom check: a committed write conflicts with a
        predicate read iff its row was in the read-time match set (the row
        this txn saw was changed/deleted) or its CURRENT value satisfies
        the condition (a phantom entered the result). A deleted row absent
        from the match set cannot have matched at read time — its tombstone
        is safe to ignore."""
        for ptk, cond, rpks in pred_reads:
            for wtk, wpk in wset:
                if wtk != ptk:
                    continue
                if wpk in rpks:
                    return {(wtk, wpk)}
                t = self._tables.get(wtk)
                cur = t.store.get(wpk) if t is not None else None
                if cur is not None and cond.matches(cur):
                    return {(wtk, wpk)}
        return set()

    def _commit_buffered(self, txn: _Txn):
        with self._lock:
            try:
                if self.config.isolation_level == IsolationLevel.serializable:
                    # first-committer-wins over the write-set PLUS read-set
                    # validation (true serializability incl. write-skew; the
                    # reference's check is write-set-only, tm:30-36): abort
                    # when a concurrent commit wrote a record this txn wrote
                    # OR read — row reads match by pk, predicate reads match
                    # any write to the table
                    tables_read = {
                        tk for tk, pk in txn.read_set if pk is None
                    }
                    # blind all-Expr writes (txn.commutes) are exempt from
                    # the txn's OWN footprint — they re-resolve against
                    # live state at replay, so commit order is a valid
                    # serial order; they still enter the RECORDED write-set
                    # below, so concurrent readers of those rows conflict
                    footprint = (txn.write_set - txn.commutes) | txn.read_set
                    for seq, wset in self._recent_commits:
                        if seq <= txn.begin_seq:
                            continue
                        hit = wset & footprint
                        if not hit:
                            hit = {
                                e for e in wset if e[0] in tables_read
                            }
                        if not hit and txn.pred_reads:
                            hit = self._pred_conflicts(txn.pred_reads, wset)
                        if hit:
                            (_, tname), cpk = next(iter(hit))
                            err = BusinessError(
                                f"transaction conflict on {tname} pk={cpk!r}: "
                                "a concurrent commit wrote a record this "
                                "transaction wrote or read",
                                code="txn_conflict",
                            )
                            # the conflicting keys drive pessimistic
                            # escalation in transaction(retries=) (reference
                            # lock_manager.dart:38-44 takes row locks for
                            # exactly this)
                            err.conflict_keys = frozenset(hit)
                            raise err
                txn.buffering = False  # oplog now replays eagerly
                try:
                    for op in txn.oplog:
                        self._apply_buffered_op(txn, op)
                except BaseException:
                    # mid-replay failure (deferred FK restrict/cascade,
                    # readCommitted races): undo what replayed, then surface
                    for entry in reversed(txn.undo):
                        kind, t = entry[0], entry[1]
                        if kind == "delete":
                            t.apply_delete(entry[2])
                        elif kind == "update":
                            t.apply_update(entry[2], entry[3])
                        elif kind == "insert":
                            t.apply_insert(entry[2], entry[3])
                    raise
            finally:
                self._release_txn(txn)
            self._record_commit(txn.write_set)
            if txn.wal_ops and self._wal is not None:
                self._wal.append({"op": "txn", "ops": txn.wal_ops})
        for ev in txn.events:
            self._dispatch(ev)

    def _apply_buffered_op(self, txn: _Txn, op: tuple):
        kind, tkey, pk, payload = op
        space, name = tkey
        t = self._tables.get(tkey)
        if t is None:
            return
        if kind == "insert":
            # re-check FK at replay: under readCommitted a parent may have
            # been deleted since the op-time check (no read-set validation
            # protects it); a violation rolls the whole commit back
            self._fk_check_write(t, payload)
            t.apply_insert(pk, payload)
            txn.undo.append(("delete", t, pk))
            self._wal_append(
                {"op": "insert", "space": space, "table": name, "pk": pk,
                 "rec": self._walable(payload)}
            )
            self._counters["inserts"] += 1
            pk_name = t.schema.primary_key.name
            self._notify(
                ChangeEvent("insert", space, name, pk, {**payload, pk_name: pk})
            )
        elif kind == "update":
            self._update_pk(t, space, pk, payload)
        elif kind == "delete":
            self._delete_pk(t, space, pk)

    # ------------------------------------------------------------- durability

    def _walable(self, rec: dict) -> dict:
        out = {}
        for k, v in rec.items():
            if isinstance(v, np.ndarray):
                v = v.astype(np.float32)
            out[k] = v
        return out

    def _table_dirty(self, key: tuple[str, str], t: Table) -> bool:
        return (
            key not in self._ckpt_gens
            or t.store.generation != self._ckpt_gens[key]
            or any(t._vec_pending.values())
            or any(t._filter_pending.values())
        )

    def flush(self, force_all: bool = False) -> None:
        """Incremental checkpoint: rewrite only the tables dirtied since the
        last checkpoint (per-table atomic snapshot files), persist the
        catalog + WAL checkpoint pointer, prune covered segments (reference
        pjm:1209-1228 flushAll -> advanceCheckpoint; wal_manager.dart:608
        checkpoint pointer). Cost is O(dirty tables), not O(database).
        `force_all` rewrites everything (key rotation re-seals artifacts)."""
        if self.config.memory_mode:
            return
        with self._lock, self._timed("flush"):
            from urllib.parse import quote

            if force_all:
                # rewrite-everything flushes (key rotation re-seals) must
                # see every table, including lazily-pending ones
                self._tables.materialize_all()
            tdir = os.path.join(self.db_dir, "tables")
            self._storage.makedirs(tdir)
            catalog: dict[str, dict[str, str]] = {}
            written = 0
            # unloaded tables are clean by definition: carry their catalog
            # entries forward untouched
            for (space, name), rel in self._tables.pending.items():
                catalog.setdefault(space, {})[name] = rel
            for (space, name), t in self._tables.items():
                rel = "tables/" + quote(space, safe="") + "@" + quote(name, safe="") + ".snap"
                catalog.setdefault(space, {})[name] = rel
                if force_all or self._table_dirty((space, name), t):
                    gen = t.store.generation
                    if self.config.enable_compression or self._envelope is not None:
                        # wrap transforms need the whole payload
                        self._storage.write_atomic(
                            os.path.join(self.db_dir, rel),
                            self._wrap_bytes(
                                codec.frame(codec.dumps(self._pack_table(t)))
                            ),
                        )
                    else:
                        # default path streams: big columns ride as
                        # zero-copy views straight into the file (O(chunk)
                        # extra memory instead of 2x the snapshot)
                        self._storage.write_atomic_framed(
                            os.path.join(self.db_dir, rel),
                            codec.dump_parts(self._pack_table(t)),
                        )
                    self._ckpt_gens[(space, name)] = gen
                    written += 1
            # stale snap files: dropped/renamed tables
            live = {
                os.path.basename(rel)
                for tbls in catalog.values()
                for rel in tbls.values()
            }
            for name in self._storage.list(tdir):
                if name.endswith(".snap") and name not in live:
                    self._storage.delete(os.path.join(tdir, name))
            self._ckpt_gens = {
                k: v for k, v in self._ckpt_gens.items() if k in self._tables
            }
            new_seq = self._wal.checkpoint_rotate() if self._wal is not None else 1
            self.global_config.extras["catalog"] = catalog
            self.global_config.extras["wal_start_seq"] = new_seq
            self._persist_manifest()
            if self._wal is not None:
                self._wal.prune_before(new_seq)
            self._counters["flushes"] += 1
            self._counters["tables_checkpointed"] = (
                self._counters.get("tables_checkpointed", 0) + written
            )

    def _snapshot_state(self) -> dict:
        self._tables.materialize_all()  # backups cover every table
        tables = {}
        for (space, name), t in self._tables.items():
            tables.setdefault(space, {})[name] = self._pack_table(t)
        return {"version": 1, "tables": tables}

    @staticmethod
    def _pack_table(t: Table) -> dict:
        d = t.state_dict()
        return _pack_ndarrays(d)

    def _load_snapshot(self, snap: dict):
        for space, tbls in snap.get("tables", {}).items():
            for name, td in tbls.items():
                t = Table.from_state_dict(
                    _unpack_ndarrays(td), self.config.distributed.node_id, self._mesh,
                    device=self._device,
                )
                self._tables[(space, name)] = t
                self._schemas[(space, name)] = t.schema

    # ------------------------------------------------------------- key rotation

    def rotate_encryption_key(self, new_passphrase: str) -> DbResult:
        """Online key rotation (reference key_manager.dart + resumable
        key_migration_runner): add the new key, re-encrypt the durable
        artifacts at the next checkpoint (done eagerly here), retire the
        old key. Artifacts written under the old key stay readable during
        the window via the envelope key-id fallback."""
        if self._envelope is None:
            return DbResult.error(ResultType.schemaError, "encryption is not enabled")
        with self._lock:
            ring = self._envelope.ring
            old_id = ring.current
            ring.rotate(new_passphrase)
            if not self.config.memory_mode:
                # crash safety: persist the retiring keys WRAPPED under the
                # new key BEFORE re-sealing, so a crash mid-re-seal reopens
                # with the new passphrase and resumes (reference resumable
                # key migration, key_migration_runner.dart)
                self.global_config.extras["pending_rotation"] = {
                    "current": ring.current,
                    "wrapped": {
                        str(kid): self._envelope.seal(key).hex()
                        for kid, key in ring.keys.items()
                        if kid != ring.current
                    },
                }
                self._persist_manifest()
            # every artifact re-sealed under the new key; WAL rotated
            self.flush(force_all=True)
            ring.retire(old_id)
            self.global_config.extras.pop("pending_rotation", None)
            if not self.config.memory_mode:
                self._persist_manifest()
            return DbResult.success(data={"key_id": ring.current})

    # ------------------------------------------------------------- backup/restore

    def _scoped_snapshot(self, scope: str) -> dict:
        snap = self._snapshot_state()
        if scope == "database":
            return snap
        keep = {self.current_space}
        if scope == "currentSpaceWithGlobal":
            keep.add(GLOBAL_SPACE)
        elif scope != "currentSpace":
            raise ValueError(f"unknown backup scope {scope!r}")
        snap["tables"] = {s: t for s, t in snap["tables"].items() if s in keep}
        return snap

    def backup(self, dest_path: str, scope: str = "database") -> str:
        """Zip backup (reference backup_manager.dart:26-40). scope:
        database | currentSpace | currentSpaceWithGlobal. Scoped backups
        (and memory mode) serialize a snapshot; full file-mode backups zip
        the database directory verbatim."""
        with self._lock:
            self.flush()
            if self.config.memory_mode or scope != "database":
                data = self._wrap_bytes(codec.dumps(self._scoped_snapshot(scope)))
                os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
                with zipfile.ZipFile(dest_path, "w") as z:
                    z.writestr("memory.snap", data)
                return dest_path
            with zipfile.ZipFile(dest_path, "w") as z:
                # enumerate through the storage seam: object/memory-backed
                # databases back up the same way as file-backed ones
                for rel in self._storage.walk(self.db_dir):
                    if not rel.endswith(".tmp"):
                        z.writestr(
                            rel.replace(os.sep, "/"),
                            self._storage.read(os.path.join(self.db_dir, rel)),
                        )
            return dest_path

    def restore(self, src_path: str) -> DbResult:
        with self._lock:
            with zipfile.ZipFile(src_path) as z:
                names = z.namelist()
                if "memory.snap" in names:
                    snap = codec.loads(self._unwrap_bytes(z.read("memory.snap")))
                    # replace only the spaces the backup contains (scoped
                    # restores leave other spaces intact)
                    for space in snap.get("tables", {}):
                        for key in [k for k in self._tables if k[0] == space]:
                            del self._tables[key]
                            self._schemas.pop(key, None)
                    self._load_snapshot(snap)
                    self._fk_rev_cache = None
                    self._ensure_kv_table()
                    self.flush()  # checkpoint: the pre-restore WAL tail
                    # must not replay over restored state after a crash
                    return DbResult.success()
                if self.config.memory_mode:
                    return DbResult.error(
                        ResultType.ioError, "cannot restore a file backup into memory mode"
                    )
                if self._wal:
                    self._wal.close()
                    self._wal = None
                for rel in self._storage.walk(self.db_dir):
                    self._storage.delete(os.path.join(self.db_dir, rel))
                for name in z.namelist():
                    if name.endswith("/"):
                        continue
                    dest = os.path.join(self.db_dir, name)
                    self._storage.makedirs(os.path.dirname(dest))
                    self._storage.write_atomic(dest, z.read(name))
            self._tables.clear()
            self._schemas.clear()
            self._ckpt_gens.clear()
            self._fk_rev_cache = None
            if self._wal:
                self._wal.close()
            # the restored manifest may carry a different KDF salt
            self._envelope = self._make_envelope()
            self._open_files()
            self._ensure_kv_table()
            return DbResult.success()

    # ------------------------------------------------------------- maintenance

    def run_ttl_cleanup(self) -> int:
        """Delete expired rows + expired KV entries (reference
        ttl_cleanup_manager.dart)."""
        now = int(time.time() * 1000)
        removed = 0
        with self._lock:
            for (space, name), t in list(self._tables.items()):
                if name == KV_TABLE:
                    from .kv import kv_live_mask

                    rows = np.flatnonzero(
                        t.store.valid_view() & ~kv_live_mask(t.store, now)
                    )
                    if not len(rows):
                        continue
                    pks = [t.store.pk_col.get(int(r)) for r in rows]
                else:
                    pks = list(t.expired_pks(now))
                    if not pks:
                        continue
                # one columnar patch + WAL frame per table when large
                kept = self._bulk_delete_core(t, space, pks)
                if kept is not None:
                    removed += len(kept)
                else:
                    removed += sum(
                        1 for pk in pks if self._delete_pk(t, space, pk)
                    )
        return removed

    def run_compaction(self):
        with self._lock:
            for t in self._tables.values():
                for vi in t.vector_indexes.values():
                    if getattr(vi, "defer_retrain", False) and vi.trained:
                        continue  # run_vector_maintenance compacts off-lock
                    with rw(vi).write():
                        vi.maybe_compact(self.config.tombstone_compact_ratio)

    def run_vector_flush(self) -> int:
        """Background drain of buffered vector-index writes (the
        reference's writeChanges runs on the async background write
        scheduler, so its searches never pay the flush either). Searches
        flush eagerly only when the index is uncontended
        (`_flush_or_defer`); this crontab job drains what they deferred —
        and drains write-only workloads that never search — so the
        bounded-staleness window closes without a reader tripping the
        force bounds. Contended indexes are skipped for the next tick
        rather than convoying behind in-flight search dispatches."""
        with self._lock:
            work = [
                (t, f)
                for t in self._tables.values()
                for f in t.vector_indexes
                if t.vec_pending_count(f)
            ]
        done = 0
        for t, f in work:
            with self._lock:
                idx = t.vector_indexes.get(f)
                if idx is None or not t.vec_pending_count(f):
                    continue
                lk = rw(idx)
                if not lk.try_acquire_write():
                    continue  # searches mid-dispatch; retry next tick
                try:
                    t.flush_vectors(f)
                finally:
                    lk.release_write()
                done += 1
        return done

    def run_vector_maintenance(self, wait_quiescent: bool = False) -> int:
        """Background IVF retrains without stalling the engine: capture the
        immutable device arrays under the lock, run the multi-second
        train + bucket build OUTSIDE it, swap the new layout in if the
        index did not mutate meanwhile (RCU over jax immutability — the
        reference runs index maintenance through its async
        background_write_scheduler for the same reason)."""
        jobs = []
        ratio = self.config.tombstone_compact_ratio
        with self._lock:
            for t in self._tables.values():
                for vi in t.vector_indexes.values():
                    if not getattr(vi, "defer_retrain", False):
                        continue
                    if not (vi.needs_retrain() or vi.needs_compact(ratio)):
                        continue
                    # quiescence gate: mid-bulk-load RCU builds churn (the
                    # install fails its mutation check anyway) — wait for a
                    # short quiet window, but never starve a steady-write
                    # workload (bounded skips)
                    q = getattr(vi, "quiescent_s", None)
                    if (
                        wait_quiescent
                        and q is not None
                        and q() < self.VEC_MAINT_QUIESCENCE_S
                    ):
                        skips = getattr(vi, "_maint_skips", 0)
                        if skips < self.VEC_MAINT_MAX_SKIPS:
                            vi._maint_skips = skips + 1
                            continue
                    vi._maint_skips = 0
                    if vi.needs_retrain():
                        jobs.append(("retrain", vi, vi.capture_build_state()))
                    else:
                        jobs.append(("compact", vi, vi.capture_compact_state()))
        done = 0
        for kind, vi, cap in jobs:
            if kind == "retrain":
                shadow = vi.build_retrained(cap)  # off-lock: queries proceed
                with self._lock, rw(vi).write():
                    if vi.install_retrained(cap, shadow):
                        done += 1
                        self._counters["background_retrains"] = (
                            self._counters.get("background_retrains", 0) + 1
                        )
            else:
                shadow = vi.build_compacted(cap)  # off-lock
                with self._lock, rw(vi).write():
                    if vi.install_compacted(cap, shadow):
                        done += 1
                        self._counters["background_compactions"] = (
                            self._counters.get("background_compactions", 0) + 1
                        )
        return done

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        tables = {}
        for (space, name), t in self._tables.items():
            if name.startswith(SYSTEM_PREFIX):
                continue
            tables[f"{space}/{name}"] = {
                "records": len(t.store),
                "loaded": True,
                "vector_indexes": {
                    f: {
                        "type": vi.index_type,
                        "count": len(vi),
                        "deleted_ratio": vi.corpus.deleted_ratio,
                    }
                    for f, vi in t.vector_indexes.items()
                },
            }
        for (space, name) in list(self._tables.pending):
            if name.startswith(SYSTEM_PREFIX) or f"{space}/{name}" in tables:
                continue
            # never-touched lazy tables: report the checkpointed count
            # without forcing a load
            tables[f"{space}/{name}"] = {
                "records": self._catalog_rows.get((space, name), 0),
                "loaded": False,
                "vector_indexes": {},
            }
        return {
            "config": {
                "db_path": self.config.db_path,
                "db_name": self.config.db_name,
                "memory_mode": self.config.memory_mode,
                "isolation_level": self.config.isolation_level,
                # buffered txn writes + op-time unique reservations; commit
                # validates write-set AND read-set first-committer-wins
                # under serializable (row reads by pk, predicate reads at
                # table granularity — conservative phantom protection;
                # strictly stronger than the reference's write-set-only
                # check, transaction_manager.dart:30-36), skips validation
                # under readCommitted. Readers always see committed state.
                "effective_isolation": (
                    "serializable (read+write-set validation)"
                    if self.config.isolation_level == IsolationLevel.serializable
                    else "readCommitted"
                ),
                "encryption": self.config.encryption.enable_encoding,
            },
            "active_space": self.current_space,
            "spaces": self.list_spaces(),
            "tables": tables,
            "counters": dict(self._counters),
            "timings": self.timings(),
            "crontab": {
                "parked": bool(self._crontab.parked) if self._crontab else None,
                "job_errors": self._crontab.job_errors if self._crontab else 0,
            },
            "workload": self.workload.stats(),
            "resources": self.resources.status(),
            "migrations": self.query_migration_status(),
            "uptime_ms": int(time.time() * 1000) - self._opened_ms,
        }


def _schemas_equal(a: TableSchema, b: TableSchema) -> bool:
    return json.dumps(a.to_json(), sort_keys=True, default=str) == json.dumps(
        b.to_json(), sort_keys=True, default=str
    )


# --- ndarray packing for the codec ------------------------------------------


def _pack_ndarrays(v):
    """Legacy shim: typed ndarrays now ride the codec's tag 10 natively
    (one memcpy each way); only dtypes the codec doesn't know (none in
    practice) still get the `__nd__` dict wrapper. _unpack_ndarrays stays
    for reading pre-tag-10 snapshots."""
    if isinstance(v, np.ndarray):
        if v.ndim == 0 or v.dtype in codec._DTYPE_CODES:
            return v  # codec-native (tag 9/10 or scalar)
        return {
            "__nd__": True,
            "shape": list(v.shape),
            "dtype": str(v.dtype),
            "data": v.tobytes(),
        }
    if isinstance(v, dict):
        return {k: _pack_ndarrays(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_pack_ndarrays(x) for x in v]
    return v


def _unpack_ndarrays(v):
    if isinstance(v, dict):
        if v.get("__nd__"):
            if v["dtype"] == "bfloat16":  # no numpy dtype: carry the bits
                bits = np.frombuffer(v["data"], dtype="<u2")
                return BF16Array(bits.reshape(v["shape"]).copy())
            return (
                np.frombuffer(v["data"], dtype=np.dtype(v["dtype"]))
                .reshape(v["shape"])
                .copy()
            )
        return {k: _unpack_ndarrays(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unpack_ndarrays(x) for x in v]
    return v
