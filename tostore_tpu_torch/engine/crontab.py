"""CrontabManager — background maintenance scheduler.

Reference: core/crontab_manager.dart (global interval scheduler with
idle-stop driving TTL cleanup, txn cleanup, weight decay) +
ttl_cleanup_manager.dart + compaction_manager.dart. A single daemon thread
ticks every `crontab_interval_s` and runs due jobs: TTL sweeps, tombstone
compaction, periodic time-based checkpoints, and weight decay.

Idle-stop (reference crontab_manager idle semantics): after IDLE_STOP_S
with no engine writes the ticker parks on the wake event instead of
polling; any write wakes it. Job errors are counted and surfaced in
status() rather than silently swallowed. Every job passes the
WorkloadScheduler gate (maintenance.py) first: maintenance defers while
foreground traffic is hot (reference workload_scheduler.dart shares).
"""

from __future__ import annotations

import threading
import time

from ..utils.logging import Logger

log = Logger("crontab")

IDLE_STOP_S = 300.0  # park the ticker after this long with no writes
FLUSH_AGE_S = 60.0  # time-based checkpoint when the WAL has entries
COMPACT_EVERY_S = 60.0
VECTOR_MAINT_EVERY_S = 30.0  # off-lock IVF retrain checks
VECTOR_FLUSH_EVERY_S = 2.0  # drain buffered index writes (async writeChanges)
CACHE_MAINT_EVERY_S = 60.0  # weight decay + pressure eviction


class CrontabManager:
    def __init__(self, db):
        self.db = db
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_ttl = time.monotonic()
        self._last_compact = time.monotonic()
        self._last_flush = time.monotonic()
        self._last_vecmaint = time.monotonic()
        self._last_vecflush = time.monotonic()
        self._last_cachemaint = time.monotonic()
        self._last_write_marker = -1
        self._idle_since = time.monotonic()
        self.parked = False  # observable idle-stop state
        self.job_errors = 0

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True, name="tostore-cron")
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def poke(self):
        """Wake a parked ticker (called on writes)."""
        self._wake.set()

    def _write_marker(self) -> int:
        c = self.db._counters
        return c["inserts"] + c["updates"] + c["deletes"]

    def _run(self):
        cfg = self.db.config
        while not self._stop.is_set():
            marker = self._write_marker()
            if marker != self._last_write_marker:
                self._last_write_marker = marker
                self._idle_since = time.monotonic()
            elif time.monotonic() - self._idle_since >= IDLE_STOP_S:
                # idle-stop: park until the next write (or stop)
                self.parked = True
                self._wake.clear()
                self._wake.wait()
                self.parked = False
                self._idle_since = time.monotonic()
                continue
            if self._stop.wait(cfg.crontab_interval_s):
                return
            now = time.monotonic()
            sched = self.db.workload
            for due, attr, job in (
                (cfg.ttl_cleanup_interval_s, "_last_ttl", self.db.run_ttl_cleanup),
                (COMPACT_EVERY_S, "_last_compact", self.db.run_compaction),
                (VECTOR_MAINT_EVERY_S, "_last_vecmaint",
                 lambda: self.db.run_vector_maintenance(wait_quiescent=True)),
                (VECTOR_FLUSH_EVERY_S, "_last_vecflush", self.db.run_vector_flush),
                (CACHE_MAINT_EVERY_S, "_last_cachemaint", self.db.run_cache_maintenance),
                (FLUSH_AGE_S, "_last_flush", self._maybe_flush),
            ):
                if now - getattr(self, attr) >= due:
                    # workload QoS: defer while foreground traffic is hot or
                    # the maintenance time share is over budget (bounded —
                    # a repeatedly deferred job eventually forces through)
                    if not sched.may_run(job.__name__):
                        continue
                    setattr(self, attr, now)
                    try:
                        with sched.maintenance():
                            job()
                    except Exception as exc:
                        # background maintenance must never kill the engine,
                        # but failures must be visible
                        self.job_errors += 1
                        log.warning(f"crontab job {job.__name__} failed: {exc}")

    def _maybe_flush(self):
        """Time-based checkpoint: bound the replay window even when the
        write rate never reaches write_batch_size (reference
        maxFlushLatencyMs semantics at checkpoint granularity)."""
        wal = self.db._wal
        if wal is not None and wal.entries_since_checkpoint > 0:
            self.db.flush()
