"""Resource monitoring, access weights, integrity checking, workload QoS.

Parity components (SURVEY.md §2.5 + §2.4):
  - ResourceManager (core/resource_manager.dart): memory/disk monitor with
    normal/warning/critical escalation and write blocking at critical
    (reference dsi:1536). Here it watches host RSS/available memory and
    device HBM (when the runtime reports it).
  - WeightManager (core/weight_manager.dart): access-frequency weights
    (0-100 with decay) driving hot/cold reporting and prewarm ordering.
  - IntegrityChecker (core/integrity_checker.dart): structural checks +
    sampled record validation (first/last N rather than full scans).
  - WorkloadScheduler (core/workload_scheduler.dart:48-53 token shares
    flush 40% / query 40% / maintenance 15% / aux 5%): the reference
    arbitrates its own async I/O tasks with token leases; this engine is
    single-controller, so QoS reduces to the real contention point —
    background maintenance (compaction, TTL sweeps, checkpoints) holding
    the engine lock while foreground traffic is hot. Maintenance defers
    while foreground ops ran within the defer window or while the
    maintenance TIME SHARE over the sliding window exceeds its budget;
    bounded deferral (the reference's lease rebalancing) guarantees
    progress under sustained load.
"""

from __future__ import annotations

import os
import shutil
import time

import torch


class ResourceManager:
    """Levels: normal | warning | critical. Critical blocks writes."""

    WARNING_FRACTION = 0.85
    CRITICAL_FRACTION = 0.95

    def __init__(self, db_dir: str | None = None, device=None):
        self.db_dir = db_dir
        self.device = torch.device(device) if device is not None else None
        self._last_check = 0.0
        self._level = "normal"

    @staticmethod
    def memory_info() -> dict:
        total = avail = None
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = int(line.split()[1]) * 1024
                    elif line.startswith("MemAvailable:"):
                        avail = int(line.split()[1]) * 1024
        except OSError:
            pass
        return {"total_bytes": total, "available_bytes": avail}

    def device_memory_info(self) -> dict:
        """The card's memory as CUDA reports it (all processes'
        use, not only this one's); {} for a CPU device, which has none."""
        if self.device is None or self.device.type != "cuda":
            return {}
        free, total = torch.cuda.mem_get_info(self.device)
        return {"hbm_in_use": total - free, "hbm_limit": total}

    def disk_info(self) -> dict:
        if not self.db_dir or not os.path.exists(self.db_dir):
            return {}
        u = shutil.disk_usage(self.db_dir)
        return {"disk_total": u.total, "disk_free": u.free}

    def level(self, max_age_s: float = 2.0) -> str:
        now = time.monotonic()
        if now - self._last_check < max_age_s:
            return self._level
        self._last_check = now
        m = self.memory_info()
        lvl = "normal"
        if m["total_bytes"] and m["available_bytes"] is not None:
            used = 1.0 - m["available_bytes"] / m["total_bytes"]
            if used >= self.CRITICAL_FRACTION:
                lvl = "critical"
            elif used >= self.WARNING_FRACTION:
                lvl = "warning"
        dev = self.device_memory_info()
        if dev.get("hbm_limit") and dev.get("hbm_in_use"):
            frac = dev["hbm_in_use"] / dev["hbm_limit"]
            if frac >= self.CRITICAL_FRACTION:
                lvl = "critical"
            elif frac >= self.WARNING_FRACTION and lvl == "normal":
                lvl = "warning"
        self._level = lvl
        return lvl

    def writes_blocked(self) -> bool:
        return self.level() == "critical"

    def status(self) -> dict:
        return {
            "level": self.level(),
            **self.memory_info(),
            **self.device_memory_info(),
            **self.disk_info(),
        }


class WeightManager:
    """Access-frequency weights 0-100 with periodic decay (reference
    weight_manager.dart:10-50). Sampled: tracks per-(table, pk) hits."""

    MAX_WEIGHT = 100.0
    HIT_BONUS = 4.0
    DECAY = 0.5

    def __init__(self, max_entries: int = 100_000):
        import threading

        self._w: dict[tuple, float] = {}
        self.max_entries = max_entries
        # recorders run outside the engine lock (read paths must not
        # serialize on it just to bump a weight); decay iterates
        self._mu = threading.Lock()

    def record_access(self, table: str, pk):
        key = (table, pk)
        with self._mu:
            self._w[key] = min(
                self.MAX_WEIGHT, self._w.get(key, 0.0) + self.HIT_BONUS
            )
            overflow = len(self._w) > self.max_entries
        if overflow:
            self.decay(evict=True)

    def record_accesses(self, table: str, pks):
        """Batch record_access: one lock round-trip per query result
        instead of one per row (hot on the shared-mode read path)."""
        with self._mu:
            w = self._w
            for pk in pks:
                key = (table, pk)
                w[key] = min(self.MAX_WEIGHT, w.get(key, 0.0) + self.HIT_BONUS)
            overflow = len(w) > self.max_entries
        if overflow:
            self.decay(evict=True)

    def decay(self, evict: bool = False):
        with self._mu:
            dead = []
            for k in self._w:
                self._w[k] *= self.DECAY
                if self._w[k] < 1.0:
                    dead.append(k)
            if evict or dead:
                for k in dead:
                    del self._w[k]

    def weight(self, table: str, pk) -> float:
        return self._w.get((table, pk), 0.0)

    def table_weight(self, table: str) -> float:
        """Aggregate access weight of a table — drives prewarm ordering and
        cache-eviction priority (reference prewarm consumer dsi:5723)."""
        with self._mu:
            return sum(w for (t, _), w in self._w.items() if t == table)

    def top_hot(self, table: str, n: int = 100) -> list:
        with self._mu:
            items = [(pk, w) for (t, pk), w in self._w.items() if t == table]
        items.sort(key=lambda x: -x[1])
        return items[:n]


class IntegrityChecker:
    """Structure + sampled record validation (reference
    integrity_checker.dart:36-40 first/last-N sampling)."""

    def __init__(self, sample_n: int = 32):
        self.sample_n = sample_n

    def check_table(self, table) -> dict:
        from .table import ValidationError

        issues = []
        store = table.store
        # 1. pk map <-> rowid consistency
        for pk, row in store._pk_row.items():
            if not store.valid[row]:
                issues.append(f"pk {pk!r} maps to tombstoned row {row}")
            elif store.pk_col.get(row) != pk:
                issues.append(f"pk {pk!r} row {row} holds {store.pk_col.get(row)!r}")
        # 2. unique maps point at live pks
        for name, m in table.unique_maps.items():
            for key, pk in m.items():
                if pk not in store:
                    issues.append(f"unique map {name!r} key {key!r} -> missing pk {pk!r}")
        # 3. vector corpora pk maps subset of table pks
        for field, vi in table.vector_indexes.items():
            for pk in list(vi.corpus._pk_slot)[: self.sample_n]:
                if pk not in store and pk not in {
                    p for p, v in table._vec_pending.get(field, {}).items()
                }:
                    issues.append(f"vector index {field!r} holds pk {pk!r} not in table")
        # 4. sampled record re-validation
        pks = store.pks()
        sample = pks[: self.sample_n] + pks[-self.sample_n :]
        for pk in sample:
            rec = store.get(pk)
            try:
                table.validate(
                    {k: v for k, v in rec.items()
                     if k in table.schema.field_map},
                    is_insert=False,
                )
            except ValidationError as e:
                issues.append(f"record {pk!r} fails validation: {e}")
        return {
            "table": table.schema.name,
            "records": len(store),
            "issues": issues,
            "ok": not issues,
        }

    def check_database(self, db) -> dict:
        db._tables.materialize_all()  # a deep check covers lazy tables too
        reports = [
            self.check_table(t)
            for (space, name), t in db._tables.items()
            if not name.startswith("_system_")
        ]
        return {"ok": all(r["ok"] for r in reports), "tables": reports}


class WorkloadScheduler:
    """Foreground-vs-maintenance arbitration (see module docstring; the
    reference's token-share scheduler, workload_scheduler.dart:14,48-53).

    Foreground ops stamp `note_foreground()` (wired into Database._timed);
    maintenance jobs run inside `maintenance()` so their wall time is
    accounted against `maintenance_share` of the sliding window. A job may
    run when the engine looks idle (no foreground op within `defer_s`) AND
    the maintenance share is under budget — or when it has been deferred
    `MAX_DEFERS` times (bounded deferral: progress under sustained load,
    the reference's lease rebalancing)."""

    WINDOW_S = 60.0
    MAX_DEFERS = 20

    def __init__(self, maintenance_share: float = 0.15, defer_s: float = 0.25):
        self.maintenance_share = maintenance_share
        self.defer_s = defer_s
        self._last_fg = 0.0
        self._maint_slices: list[tuple[float, float]] = []  # (end_ts, dur)
        self._defers: dict[str, int] = {}
        self.deferred_total = 0
        import threading

        self._tl = threading.local()

    def note_foreground(self):
        # a maintenance job's own writes (TTL deletes, compaction) must not
        # stamp the foreground clock and defer the NEXT maintenance job
        if getattr(self._tl, "in_maintenance", False):
            return
        self._last_fg = time.monotonic()

    def _share_now(self) -> float:
        now = time.monotonic()
        self._maint_slices = [
            (end, dur) for end, dur in self._maint_slices
            if end >= now - self.WINDOW_S
        ]
        return sum(dur for _, dur in self._maint_slices) / self.WINDOW_S

    def may_run(self, job: str) -> bool:
        """Gate for one maintenance job; deferred jobs eventually force."""
        now = time.monotonic()
        busy = now - self._last_fg < self.defer_s
        over = self._share_now() > self.maintenance_share
        if (busy or over) and self._defers.get(job, 0) < self.MAX_DEFERS:
            self._defers[job] = self._defers.get(job, 0) + 1
            self.deferred_total += 1
            return False
        self._defers[job] = 0
        return True

    def maintenance(self):
        """Context manager accounting a maintenance job's wall time."""
        sched = self

        class _Span:
            def __enter__(self):
                self.t0 = time.monotonic()
                sched._tl.in_maintenance = True
                return self

            def __exit__(self, *exc):
                sched._tl.in_maintenance = False
                now = time.monotonic()
                sched._maint_slices.append((now, now - self.t0))
                return False

        return _Span()

    def stats(self) -> dict:
        return {
            "maintenance_share_budget": self.maintenance_share,
            "maintenance_share_now": round(self._share_now(), 4),
            "deferred_jobs_total": self.deferred_total,
        }
