"""KvStore — typed key-value namespace over the system KV table.

Same surface as the reference `db.kv` (Interface/kv_store.dart:1-354):
typed getters, setMany/removeKeys, atomic setIncrement counters,
getKeys(prefix)/count/exists/clear, per-key TTL, watch streams, and
global vs space-local scoping (global keys live in the shared global-space
KV table)."""

from __future__ import annotations

import fnmatch
import time
from typing import Any, Callable

from ..models.results import DbResult
from ..query.condition import QueryCondition

KV_TABLE = "_system_kv"


def kv_live_mask(store, now_ms: float):
    """bool[high] — rows that are valid and not TTL-expired (null, zero,
    or future expires_ms). THE liveness rule: get_keys/count read it and
    run_ttl_cleanup sweeps its inverse; keep them agreeing."""
    high = store.high
    exp = store.columns["expires_ms"]
    exp._grow(high)
    return store.valid_view() & (
        exp.null[:high] | (exp.data[:high] <= 0) | (exp.data[:high] > now_ms)
    )


class KvStore:
    def __init__(self, db, is_global: bool = False):
        self._db = db
        self._global = is_global

    @property
    def _space(self):
        from .database import GLOBAL_SPACE

        return GLOBAL_SPACE if self._global else self._db.current_space

    def _t(self):
        return self._db._tables[(self._space, KV_TABLE)]

    # --- write -----------------------------------------------------------

    def set(self, key: str, value: Any, ttl_seconds: float | None = None) -> DbResult:
        expires = int(time.time() * 1000 + ttl_seconds * 1000) if ttl_seconds else 0
        db = self._db
        with db._lock:
            t = self._t()
            rec = {"value": value, "expires_ms": expires}
            tkey = (self._space, KV_TABLE)
            buf = db._buffering_txn()
            if buf is not None:  # buffered with the relational ops
                if db._view_exists(t, tkey, key):
                    db._txn_update(buf, t, tkey, key, rec)
                else:
                    db._txn_insert(
                        buf, t, tkey, t.schema.primary_key.name, key, rec
                    )
                return DbResult.success([key])
            if key in t.store:
                t.apply_update(key, rec)
                op = "update"
            else:
                t.apply_insert(key, rec)
                op = "insert"
            db._wal_append(
                {"op": op, "space": self._space, "table": KV_TABLE, "pk": key,
                 **({"rec": rec} if op == "insert" else {"updates": rec})}
            )
            db._track_direct_write(tkey, key)
            from .database import ChangeEvent

            db._notify(ChangeEvent(op, self._space, KV_TABLE, key, rec))
            return DbResult.success([key])

    def set_many(self, entries: dict[str, Any], ttl_seconds: float | None = None) -> DbResult:
        """Batched set (reference setMany): one lock + one WAL group via
        the columnar bulk insert/update machinery instead of a per-key
        loop. Small batches, open transactions, and fast-path declines
        (Expr payloads) keep per-key semantics."""
        db = self._db
        if (
            len(entries) < 64
            or db._buffering_txn() is not None
            or db._txn is not None
        ):
            for k, v in entries.items():
                self.set(k, v, ttl_seconds)
            return DbResult.success(list(entries))
        expires = (
            int(time.time() * 1000 + ttl_seconds * 1000) if ttl_seconds else 0
        )
        with db._lock, db._wal_group(), db._timed("kv_set_many"):
            t = self._t()
            pk = t.schema.primary_key.name
            recs = [
                {pk: k, "value": v, "expires_ms": expires}
                for k, v in entries.items()
            ]
            exist = [r for r in recs if r[pk] in t.store]
            new = [r for r in recs if r[pk] not in t.store]
            # both fast paths bail with None BEFORE mutating anything,
            # and set() never validates (KV values are opaque json), so
            # any key the columnar routes decline OR reject (their
            # schema validation is stricter than per-key set) falls back
            # to per-key — set_many's contract stays always-success and
            # batch-size-independent
            r_upd = (
                db._bulk_update_fast(t, exist)
                if exist
                else DbResult.success([])
            )
            ok: set = set()
            if r_upd is not None:
                ok |= set(r_upd.success_keys or [])
                r_new = (
                    db._bulk_insert_fast(KV_TABLE, new, t=t)
                    if new
                    else DbResult.success([])
                )
                if r_new is not None:
                    ok |= set(r_new.success_keys or [])
            todo = [k for k in entries if k not in ok]
        for k in todo:
            self.set(k, entries[k], ttl_seconds)
        return DbResult.success(list(entries))

    def set_increment(self, key: str, delta: float | int = 1) -> int | float:
        """Atomic counter (reference setIncrement)."""
        with self._db._lock:
            cur = self.get(key)
            if cur is None:
                cur = 0
            if not isinstance(cur, (int, float)) or isinstance(cur, bool):
                raise ValueError(f"kv key {key!r} is not numeric")
            new = cur + delta
            self.set(key, new)
            return new

    def remove(self, key: str) -> bool:
        with self._db._lock:
            t = self._t()
            if not self._db._view_exists(t, (self._space, KV_TABLE), key):
                return False
            self._db._delete_pk(t, self._space, key)
            return True

    def remove_keys(self, keys: list[str]) -> int:
        db = self._db
        with db._lock:
            t = self._t()
            live = [
                k for k in keys
                if db._view_exists(t, (self._space, KV_TABLE), k)
            ]
            if not live:
                return 0
            kept = db._bulk_delete_core(t, self._space, live)
            if kept is not None:
                return len(kept)
            return sum(
                1 for k in live if db._delete_pk(t, self._space, k)
            )

    def clear(self) -> int:
        with self._db._lock:
            t = self._t()
            keys = self._db._all_pks(t, (self._space, KV_TABLE))
            if not keys:
                return 0
            kept = self._db._bulk_delete_core(t, self._space, keys)
            if kept is not None:
                return len(kept)
            for k in keys:
                self._db._delete_pk(t, self._space, k)
            return len(keys)

    # --- read ------------------------------------------------------------------

    def _live(self, key: str):
        t = self._t()
        self._db._note_read((self._space, KV_TABLE), key)
        rec = self._db._view_get(t, (self._space, KV_TABLE), key)
        if rec is None:
            return None
        exp = rec.get("expires_ms") or 0
        if exp and exp <= int(time.time() * 1000):
            return None  # lazily expired (cron sweeps later)
        return rec

    def get(self, key: str, default: Any = None) -> Any:
        rec = self._live(key)
        return default if rec is None else rec.get("value")

    def get_string(self, key: str, default: str | None = None) -> str | None:
        v = self.get(key)
        return str(v) if v is not None else default

    def get_int(self, key: str, default: int | None = None) -> int | None:
        v = self.get(key)
        try:
            return int(v) if v is not None else default
        except (TypeError, ValueError):
            return default

    def get_double(self, key: str, default: float | None = None) -> float | None:
        v = self.get(key)
        try:
            return float(v) if v is not None else default
        except (TypeError, ValueError):
            return default

    def get_bool(self, key: str, default: bool | None = None) -> bool | None:
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(v).lower() in ("true", "1", "yes")

    def get_json(self, key: str, default: Any = None) -> Any:
        return self.get(key, default)

    def exists(self, key: str) -> bool:
        return self._live(key) is not None

    def get_keys(self, prefix: str = "") -> list[str]:
        db = self._db
        if db._buffering_txn() is not None:
            # overlay merge + per-key read notes need the record path
            t = self._t()
            pks = db._all_pks(t, (self._space, KV_TABLE))
            return sorted(
                k for k in pks if str(k).startswith(prefix) and self._live(k)
            )
        # vectorized liveness over the expires column — a prefix count
        # over 200k keys must not materialize 200k records. SHARED mode:
        # high/valid/expires/pk gathers must be mutually consistent
        with db._shared:
            t = self._t()
            store = t.store
            live = kv_live_mask(store, time.time() * 1000)
            store.pk_col._grow(store.high)
            pks = store.pk_col.data[: store.high][live].tolist()
        if prefix:
            pks = [k for k in pks if str(k).startswith(prefix)]
        return sorted(pks)

    def count(self, prefix: str = "") -> int:
        return len(self.get_keys(prefix))

    def get_ttl(self, key: str) -> float | None:
        rec = self._live(key)
        if rec is None:
            return None
        exp = rec.get("expires_ms") or 0
        if not exp:
            return None
        return max(0.0, (exp - time.time() * 1000) / 1000)

    def set_ttl(self, key: str, ttl_seconds: float | None) -> bool:
        db = self._db
        with db._lock:
            t = self._t()
            tkey = (self._space, KV_TABLE)
            if not db._view_exists(t, tkey, key):
                return False
            expires = int(time.time() * 1000 + ttl_seconds * 1000) if ttl_seconds else 0
            buf = db._buffering_txn()
            if buf is not None:
                db._txn_update(buf, t, tkey, key, {"expires_ms": expires})
                return True
            t.apply_update(key, {"expires_ms": expires})
            db._wal_append(
                {"op": "update", "space": self._space, "table": KV_TABLE, "pk": key,
                 "updates": {"expires_ms": expires}}
            )
            db._track_direct_write(tkey, key)
            return True

    # --- watch -------------------------------------------------------------------

    def watch_value(self, key: str, callback: Callable | None = None):
        """Stream of changes for one key (reference watchValue)."""
        return self.watch_values((key,), callback)

    def watch_values(self, keys, callback: Callable | None = None):
        """Stream of changes for a SET of keys (reference watchValues,
        tostore.dart:784): events for other keys are filtered out before
        delivery."""
        keyset = set(keys)
        sub = self._db.watch(KV_TABLE, callback=None)
        orig_emit = sub._emit

        def emit(ev):
            if ev.pk in keyset:
                orig_emit(ev)

        sub._emit = emit
        sub.callback = callback
        return sub
