"""Public API facade.

Mirrors the reference facade `ToStore` (lib/tostore.dart:1-1196):
`open()`/`memory()` constructors, CRUD + batch ops, chained query/update/
delete/schema builders, `vector_search`, the `kv` namespace, transactions,
spaces, backup/restore, `update_schema`, watch streams and `status`.
"""

from __future__ import annotations

from typing import Any, Callable

from .engine.database import Database
from .engine.kv import KvStore
from .models.config import DataStoreConfig
from .models.schema import TableSchema
from .chain.builders import (
    DeleteBuilder,
    QueryBuilder,
    SchemaBuilder,
    StreamQueryBuilder,
    UpdateBuilder,
    VectorQueryBuilder,
)


class ToStoreTPU:
    """The embedded engine handle. Construct via `open()` or `memory()`."""

    def __init__(
        self,
        config: DataStoreConfig,
        schemas: list[TableSchema] | None = None,
        storage=None,
        on_configure: Callable | None = None,
        on_create: Callable | None = None,
        on_open: Callable | None = None,
    ):
        """Lifecycle callbacks (reference tostore.dart:100-102 /
        data_store_impl.dart:960,1033,913): `on_configure(db)` fires
        after recovery but BEFORE declared schemas apply; `on_create(db)`
        only on first creation (no prior manifest); `on_open(db)` once
        the handle is fully ready."""
        self._db = Database(config, storage=storage)
        self.kv = KvStore(self._db, is_global=False)
        self.kv_global = KvStore(self._db, is_global=True)
        if on_configure is not None:
            on_configure(self)
        if schemas:
            self._db.declare_schemas(schemas)
        if on_create is not None and getattr(
            self._db, "freshly_created", False
        ):
            on_create(self)
        if on_open is not None:
            on_open(self)

    # --- constructors (reference ToStore.open / ToStore.memory) -------------

    @staticmethod
    def open(
        path: str,
        db_name: str = "default",
        schemas: list[TableSchema] | None = None,
        config: DataStoreConfig | None = None,
        storage=None,
        on_configure: Callable | None = None,
        on_create: Callable | None = None,
        on_open: Callable | None = None,
        **kw,
    ) -> "ToStoreTPU":
        """`storage`: optional engine.storage.Storage backend (the
        StorageInterface seam) — file by default; pass MemoryStorage or an
        ObjectStorage to persist somewhere other than the local FS.
        `":memory:"` (the sqlite idiom) aliases to `memory()` instead of
        creating a literal `:memory:` directory. `on_configure` /
        `on_create` / `on_open`: lifecycle callbacks (reference
        tostore.dart:100-102)."""
        if path == ":memory:":
            return ToStoreTPU.memory(
                schemas=schemas, config=config, storage=storage,
                on_configure=on_configure, on_create=on_create,
                on_open=on_open, **kw
            )
        cfg = (config or DataStoreConfig()).copy_with(db_path=path, db_name=db_name, **kw)
        return ToStoreTPU(
            cfg, schemas, storage=storage, on_configure=on_configure,
            on_create=on_create, on_open=on_open,
        )

    @staticmethod
    def memory(
        schemas: list[TableSchema] | None = None,
        config: DataStoreConfig | None = None,
        storage=None,
        on_configure: Callable | None = None,
        on_create: Callable | None = None,
        on_open: Callable | None = None,
        **kw,
    ) -> "ToStoreTPU":
        """`storage`: reuse a MemoryStorage instance across open/close
        cycles to test recovery without touching the filesystem."""
        cfg = (config or DataStoreConfig()).copy_with(db_path=None, **kw)
        return ToStoreTPU(
            cfg, schemas, storage=storage, on_configure=on_configure,
            on_create=on_create, on_open=on_open,
        )

    # --- lifecycle ------------------------------------------------------------

    def close(self, keep_active_space: bool = True):
        """`keep_active_space=False` resets the persisted active space to
        'default' (reference close(keepActiveSpace:), tostore.dart:1046 —
        the logout idiom)."""
        self._db.close(keep_active_space=keep_active_space)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @property
    def engine(self) -> Database:
        return self._db

    @property
    def instance_path(self) -> str | None:
        """Physical storage directory (reference instancePath,
        tostore.dart:1015); None for memory mode."""
        return self._db.db_dir

    @property
    def config(self) -> DataStoreConfig:
        """Final effective config snapshot (reference `db.config`,
        README.md "Instance Discovery")."""
        return self._db.config

    def get_table_info(self, table: str) -> dict:
        """Runtime table info — record count, index count, data size,
        flags (reference getTableInfo, tostore.dart:986 /
        model/table_info.dart TableInfo)."""
        info = self.status.table(table)
        t = self._db._table(table)
        info["record_count"] = info["records"]
        info["index_count"] = (
            len(info["indexes"]) + len(info["vector_indexes"])
        )
        info["is_global"] = bool(getattr(t.schema, "is_global", False))
        info["data_size_bytes"] = t.store.nbytes()
        return info

    # --- schema ------------------------------------------------------------------

    def create_table(self, schema: TableSchema, if_not_exists: bool = True):
        return self._db.create_table(schema, if_not_exists)

    def create_tables(self, schemas: list[TableSchema]):
        return self._db.create_tables(schemas)

    def drop_table(self, name: str):
        return self._db.drop_table(name)

    def get_schema(self, name: str) -> TableSchema | None:
        return self._db.get_schema(name)

    def update_schema(self, name: str) -> SchemaBuilder:
        """Chained DDL (reference SchemaBuilder)."""
        return SchemaBuilder(self._db, name)

    def set_schema(self, name: str, schema: TableSchema, renames: dict | None = None):
        return self._db.update_schema(name, schema, renames)

    # --- CRUD -----------------------------------------------------------------------

    def insert(self, table: str, data: dict):
        return self._db.insert(table, data)

    def batch_insert(self, table: str, records: list[dict], allow_partial: bool = True):
        return self._db.batch_insert(table, records, allow_partial)

    def upsert(self, table: str, data: dict):
        return self._db.upsert(table, data)

    def batch_upsert(self, table: str, records: list[dict]):
        return self._db.batch_upsert(table, records)

    def update(self, table: str, updates: dict) -> UpdateBuilder:
        return UpdateBuilder(self._db, table, updates)

    def update_by_pk(self, table: str, pk, updates: dict):
        return self._db.update(table, updates, pk=pk)

    def batch_update(self, table: str, records: list[dict]):
        """Each record must carry the PK; remaining fields are updates.
        Uniform expression-free batches ride a columnar fast path (one
        coerce pass per field, one store pass, one WAL frame)."""
        return self._db.batch_update(table, records)

    def delete(self, table: str) -> DeleteBuilder:
        return DeleteBuilder(self._db, table)

    def delete_by_pk(self, table: str, pk):
        return self._db.delete(table, pk=pk)

    def clear(self, table: str):
        return self._db.clear(table)

    # --- queries ------------------------------------------------------------------------

    def query(self, table: str) -> QueryBuilder:
        return QueryBuilder(self._db, table)

    def stream_query(self, table: str, batch_size: int = 500) -> StreamQueryBuilder:
        return StreamQueryBuilder(self._db, table, batch_size)

    def get_by_pk(self, table: str, pk) -> dict | None:
        return self._db.get_by_pk(table, pk)

    def count(self, table: str) -> int:
        return self._db.count(table)

    # --- vector search --------------------------------------------------------------------

    def vector_search(
        self,
        table: str,
        field: str,
        query,
        top_k: int = 10,
        threshold: float | None = None,
        condition=None,
        nprobe: int | None = None,
        include_records: bool = False,
        mode: str | None = None,
    ):
        """Direct form (reference tostore.dart:493). For hybrid chaining use
        `vector_query()`. mode: None = index default, 'auto' | 'exact'."""
        return self._db.vector_search(
            table, field, query, top_k, threshold, condition, nprobe,
            include_records, mode=mode,
        )

    def vector_query(self, table: str, field: str, query) -> VectorQueryBuilder:
        return VectorQueryBuilder(self._db, table, field, query)

    # --- KV handled via `self.kv` / `self.kv_global` ----------------------------------------

    def set_value(self, key: str, value: Any, is_global: bool = False):
        return (self.kv_global if is_global else self.kv).set(key, value)

    def get_value(self, key: str, is_global: bool = False):
        return (self.kv_global if is_global else self.kv).get(key)

    def remove_value(self, key: str, is_global: bool = False):
        return (self.kv_global if is_global else self.kv).remove(key)

    # --- transactions -----------------------------------------------------------------------

    def transaction(
        self,
        action: Callable | None = None,
        *,
        retries: int = 0,
        backoff: float = 0.002,
        max_backoff: float = 0.25,
    ):
        return self._db.transaction(
            action, retries=retries, backoff=backoff, max_backoff=max_backoff
        )

    # --- spaces ------------------------------------------------------------------------------

    def switch_space(self, name: str):
        self._db.switch_space(name)
        return self

    @property
    def current_space(self) -> str:
        return self._db.current_space

    def list_spaces(self):
        return self._db.list_spaces()

    def delete_space(self, name: str):
        return self._db.delete_space(name)

    # --- durability / backup ----------------------------------------------------------------

    def flush(self, flush_storage: bool = True):
        """Checkpoint dirty tables + rotate the WAL (reference flush,
        tostore.dart:1035). `flush_storage` exists for signature parity:
        the reference skips its storage.flushAll() fsync when False
        (data_store_impl.dart:1071), but our checkpoint protocol closes
        and fsyncs each WAL segment as part of rotation, so a flush here
        is ALWAYS storage-durable — the parameter is accepted and has no
        weaker mode to select."""
        self._db.flush()

    def backup(self, dest_path: str, scope: str = "database") -> str:
        return self._db.backup(dest_path, scope)

    def restore(self, src_path: str):
        return self._db.restore(src_path)

    # --- maintenance / observability -----------------------------------------------------------

    def rotate_encryption_key(self, new_passphrase: str):
        return self._db.rotate_encryption_key(new_passphrase)

    def run_ttl_cleanup(self) -> int:
        return self._db.run_ttl_cleanup()

    def compact(self):
        self._db.run_compaction()

    def watch(self, table: str | None = None, callback: Callable | None = None, condition=None):
        return self._db.watch(table, callback, condition)

    @property
    def status(self) -> "DbStatus":
        """Scoped status surface (reference Interface/status_provider.dart:
        DbStatus.memory()/space()/table()/config()/migration()). Callable
        for the full report: `db.status()`."""
        return DbStatus(self._db)

    def check_integrity(self) -> dict:
        return self._db.check_integrity()

    def prewarm(self, table: str | None = None):
        self._db.prewarm(table)

    def explain(self, table: str) -> dict:
        return self._db.explain(table)

    def timings(self) -> dict:
        return self._db.timings()

    def profile_trace(self, log_dir: str):
        return self._db.profile_trace(log_dir)

    # --- misc reference-API parity ------------------------------------------

    def table_exists(self, table: str) -> bool:
        """Reference tableExists (tostore.dart:944)."""
        return self._db.has_table(table)

    _USER_VERSION_KEY = "__user_version__"

    def get_version(self) -> int:
        """App-managed database version (reference getVersion,
        tostore.dart:1008) — persisted in the global KV space."""
        return int(self.kv_global.get(self._USER_VERSION_KEY, 0))

    def set_version(self, version: int) -> None:
        """Reference setVersion (tostore.dart:1025)."""
        self.kv_global.set(self._USER_VERSION_KEY, int(version))

    def delete_database(
        self, db_path: str | None = None, db_name: str | None = None
    ) -> None:
        """Close and remove database files (reference deleteDatabase,
        tostore.dart:1069). With `db_path`/`db_name` the TARGET database's
        directory is resolved the way `open()` would (defaults fall back to
        this instance's own path/name, data_store_impl.dart:5967-5975); when
        the target is another database, this handle stays open — the
        reference closes it only because its instance pool ties one handle
        per path. Memory databases just close."""
        import os

        cfg = self._db.config
        own = None if cfg.memory_mode else self._db.db_dir
        if db_path is None and db_name is None:
            target = own
        else:
            base = db_path if db_path is not None else cfg.db_path
            if base is None:
                raise ValueError(
                    "db_path required: memory databases have no directory"
                )
            target = os.path.join(base, db_name if db_name is not None else cfg.db_name)
        storage = self._db._storage
        if target is None or target == own:
            self._db.close()
        if target is not None:
            for rel in storage.walk(target):
                storage.delete(f"{target}/{rel}")
            # FileStorage leaves empty dirs behind; sweep them if real
            import shutil

            shutil.rmtree(target, ignore_errors=True)

    def clear_query_cache(self) -> int:
        """Drop every cached query result (reference clearQueryCache,
        query_builder.dart:277). Returns the number of entries dropped."""
        with self._db._lock:
            n = len(self._db.executor._cache)
            self._db.executor._cache.clear()
        return n

    def get_space_info(self, use_cache: bool = True) -> dict:
        """Current space's tables + record counts (reference getSpaceInfo,
        tostore.dart:1134 / space_info.dart). `use_cache` is accepted for
        signature parity; the report is recomputed from live table state
        every call (O(tables), no cache to bypass — strictly fresher than
        the reference's cached SpaceInfo)."""
        return self.status.space()

    def watch_value(self, key: str, callback=None, is_global: bool = False):
        """Stream of changes for one KV key (reference watchValue)."""
        return (self.kv_global if is_global else self.kv).watch_value(
            key, callback
        )

    def watch_values(self, keys, callback=None, is_global: bool = False):
        """Stream of changes for a set of KV keys (reference watchValues,
        tostore.dart:784)."""
        return (self.kv_global if is_global else self.kv).watch_values(
            keys, callback
        )

    def query_migration_status(self, task_id: int | None = None):
        return self._db.query_migration_status(task_id)


class DbStatus:
    """Runtime observability, scoped like the reference's status provider
    (Interface/status_provider.dart:9-21 + model/memory_info.dart,
    space_info.dart, table_info.dart, config_info.dart): `db.status()` is
    the full report; the scoped accessors return one section each."""

    def __init__(self, engine):
        self._db = engine

    def __call__(self) -> dict:
        return self._db.status()

    def memory(self) -> dict:
        """Host + device memory and disk (reference memory_info.dart)."""
        return self._db.resources.status()

    def config(self) -> dict:
        from .models.config import IsolationLevel

        cfg = self._db.config
        return {
            "db_path": cfg.db_path,
            "db_name": cfg.db_name,
            "memory_mode": cfg.memory_mode,
            "isolation_level": cfg.isolation_level,
            "effective_isolation": (
                "serializable (read+write-set validation)"
                if cfg.isolation_level == IsolationLevel.serializable
                else "readCommitted"
            ),
            "encryption": cfg.encryption.enable_encoding,
        }

    def space(self, name: str | None = None) -> dict:
        """Tables + record counts of one space (reference space_info.dart)
        — computed directly, without the full report's resource probes."""
        name = name or self._db.current_space
        tables = {
            tname: {"records": len(t.store)}
            for (sp, tname), t in self._db._tables.items()
            if sp == name and not tname.startswith("_system_")
        }
        for sp, tname in list(self._db._tables.pending):
            if sp == name and not tname.startswith("_system_") and tname not in tables:
                tables[tname] = {
                    "records": self._db._catalog_rows.get((sp, tname), 0)
                }
        return {"space": name, "tables": tables,
                "record_count": sum(t["records"] for t in tables.values())}

    def table(self, name: str) -> dict:
        """Per-table detail (reference table_info.dart record/index counts)."""
        t = self._db._table(name)
        return {
            "table": name,
            "records": len(t.store),
            "indexes": sorted(t.sorted_indexes),
            "unique_constraints": sorted(t.unique_maps),
            "vector_indexes": {
                f: {"type": vi.index_type, "count": len(vi)}
                for f, vi in t.vector_indexes.items()
            },
        }

    def table_statistics(self, name: str) -> dict:
        """Per-field distinct/min/max/null statistics (reference
        TableStatistics, model/table_statistics.dart — there it feeds the
        cost estimator; here the planner uses EXACT bisect selectivity,
        so this is a user-facing inspection surface). One vectorized pass
        per column."""
        import numpy as np

        t = self._db._table(name)
        store = t.store
        valid = store.valid_view()
        total = int(valid.sum())
        field_stats = {}
        for f in t.schema.fields:
            if f.type.value in ("vector", "blob", "json", "array"):
                continue  # unbounded cells: no scalar stats
            col = store.column_view(f.name)[valid]
            nulls = np.asarray([v is None for v in col])
            present = col[~nulls]
            stats = {
                "distinct_values": int(len(set(present.tolist()))),
                "null_percentage": (
                    round(float(nulls.mean()) * 100, 2) if total else 0.0
                ),
                "min_value": None,
                "max_value": None,
            }
            if len(present):
                try:
                    stats["min_value"] = min(present.tolist())
                    stats["max_value"] = max(present.tolist())
                except TypeError:
                    pass  # mixed-type column: no total order
            field_stats[f.name] = stats
        return {"total_rows": total, "field_stats": field_stats}

    def migration(self, task_id: int | None = None):
        return self._db.query_migration_status(task_id)

    def workload(self) -> dict:
        return self._db.workload.stats()
