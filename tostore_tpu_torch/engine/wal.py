"""Write-ahead log (segmented) + checkpointed snapshots.

Durability contract matches the reference (SURVEY.md §2.3): every mutation
is WAL-appended before it is acknowledged; a checkpoint persists the dirty
tables' snapshots and advances a checkpoint pointer past the log segments
it covered (reference wal_manager.dart:608 initializeAndRecover +
parallel_journal_manager.dart:1209-1228 flushAll->advanceCheckpoint);
crash recovery = load per-table snapshots + replay segments at/after the
pointer, discarding any torn tail frame.

The reference needs an A/B parallel journal, page redo logs and pending-
batch registries because it mutates thousands of 16 KB pages in place; here
each table snapshot is written to a temp file and atomically renamed, so
the redo machinery collapses to "rename is the commit point".

Fsync policy (reference data_store_config.dart:125 recoveryFlushPolicy):
"commit" fsyncs every append (persistRecoveryOnCommit), "interval" fsyncs
at most once per `interval_ms` piggybacked on appends (default, bounds the
power-loss window to ~1s), "os" never fsyncs explicitly (page cache only).

All byte I/O flows through the `Storage` seam (storage.py — the
reference's StorageInterface, storage_interface.dart:22-159); the module
default is FileStorage.
"""

from __future__ import annotations

import os
import re
import threading
import time

from ..utils import codec
from .storage import FILE, Storage

_SEG_RE = re.compile(r"wal-(\d{8})\.log$")


def _segment_path(wal_dir: str, seq: int) -> str:
    return os.path.join(wal_dir, f"wal-{seq:08d}.log")


def list_segments(wal_dir: str, storage: Storage = FILE) -> list[tuple[int, str]]:
    out = []
    for name in storage.list(wal_dir):
        m = _SEG_RE.search(name)
        if m:
            out.append((int(m.group(1)), os.path.join(wal_dir, name)))
    return sorted(out)


class SegmentedWalWriter:
    """Append-only framed WAL over numbered segment files.

    A new segment always starts on open (never append after a possibly-torn
    tail) and on checkpoint; oversized segments rotate transparently.
    `wrap` transforms each payload before framing (encryption envelope)."""

    def __init__(
        self,
        wal_dir: str,
        start_seq: int,
        sync_policy: str = "interval",
        interval_ms: int = 1000,
        wrap=None,
        segment_max_bytes: int = 64 << 20,
        storage: Storage = FILE,
    ):
        if sync_policy not in ("commit", "interval", "os"):
            raise ValueError(f"unknown recovery flush policy {sync_policy!r}")
        self.storage = storage
        storage.makedirs(wal_dir)
        self.wal_dir = wal_dir
        self.seq = start_seq
        self.sync_policy = sync_policy
        self.interval_ms = interval_ms
        self.segment_max_bytes = segment_max_bytes
        self.wrap = wrap or (lambda b: b)
        self._lock = threading.Lock()
        self._last_sync = 0.0
        self._bytes = 0
        self._f = storage.appender(_segment_path(wal_dir, start_seq))
        self.entries_since_checkpoint = 0

    @property
    def path(self) -> str:
        return _segment_path(self.wal_dir, self.seq)

    def _write(self, data: bytes, n_entries: int):
        with self._lock:
            self._f.write(data)
            self._f.flush()
            if self.sync_policy == "commit":
                self._f.fsync()
            elif self.sync_policy == "interval":
                now = time.monotonic()
                if (now - self._last_sync) * 1000.0 >= self.interval_ms:
                    self._f.fsync()
                    self._last_sync = now
            self.entries_since_checkpoint += n_entries
            self._bytes += len(data)
            if self._bytes >= self.segment_max_bytes:
                self._roll_locked()

    def append(self, entry: dict):
        self._write(codec.frame(self.wrap(codec.dumps(entry))), 1)

    def append_many(self, entries: list[dict]):
        if not entries:
            return
        self._write(
            b"".join(codec.frame(self.wrap(codec.dumps(e))) for e in entries),
            len(entries),
        )

    def _roll_locked(self):
        self._f.flush()
        self._f.fsync()
        self._f.close()
        self.seq += 1
        self._bytes = 0
        self._f = self.storage.appender(_segment_path(self.wal_dir, self.seq))

    def checkpoint_rotate(self) -> int:
        """Start a fresh segment; returns its seq (the new checkpoint
        pointer). Older segments become garbage once the pointer persists."""
        with self._lock:
            self._roll_locked()
            self.entries_since_checkpoint = 0
            return self.seq

    def prune_before(self, seq: int):
        """Delete segments older than the persisted checkpoint pointer."""
        for s, p in list_segments(self.wal_dir, self.storage):
            if s < seq:
                try:
                    self.storage.delete(p)
                except OSError:
                    pass

    def close(self):
        with self._lock:
            try:
                self._f.flush()
                self._f.fsync()
            except (ValueError, OSError):
                pass
            self._f.close()


def read_wal_segments(
    wal_dir: str, start_seq: int, unwrap=None, storage: Storage = FILE
) -> tuple[list[dict], int]:
    """Replay entries from every segment >= start_seq, in order. Returns
    (entries, decode_errors): per segment the intact frame prefix is used
    and a torn/undecryptable tail is dropped (counted as one error)."""
    entries: list[dict] = []
    errors = 0
    for seq, path in list_segments(wal_dir, storage):
        if seq < start_seq:
            continue
        got = read_wal(path, unwrap=unwrap, storage=storage)
        entries.extend(got.entries)
        errors += got.errors
    return entries, errors


def iter_wal(path: str, unwrap=None, storage: Storage = FILE):
    """Stream one log file's intact entry prefix (generator — recovery
    memory stays bounded by one decoded entry, not the whole log; the
    reference decodes WAL in isolate batches for the same reason,
    wal_decode_batch_runner.dart:304). Yields entries; raises _TornTail
    internally-counted via iter_wal_segments — a torn/corrupt tail simply
    ends the stream and bumps the error count the caller receives through
    the `errors` list argument."""
    if not storage.exists(path):
        return
    unwrap = unwrap or (lambda b: b)
    data = storage.read(path)
    for p in codec.iter_frames(data):
        try:
            yield codec.loads(unwrap(p))
        except (ValueError, IndexError):
            raise TornTail()  # undecryptable/corrupt entry: intact prefix only


class TornTail(Exception):
    """Internal: a segment's tail failed to decode (counted, not fatal)."""


def iter_wal_segments(
    wal_dir: str, start_seq: int, unwrap=None, storage: Storage = FILE,
    errors: list | None = None,
):
    """Stream entries from every segment >= start_seq in order; decode
    errors end that segment's stream and append to `errors` (if given)."""
    for seq, path in list_segments(wal_dir, storage):
        if seq < start_seq:
            continue
        try:
            yield from iter_wal(path, unwrap=unwrap, storage=storage)
        except TornTail:
            if errors is not None:
                errors.append(path)


class WalReadResult:
    __slots__ = ("entries", "errors")

    def __init__(self, entries, errors):
        self.entries = entries
        self.errors = errors


def read_wal(path: str, unwrap=None, storage: Storage = FILE) -> "WalReadResult":
    """Replay one log file: the intact entry prefix; a torn/corrupt tail is
    dropped and counted so recovery can surface it in status()."""
    if not storage.exists(path):
        return WalReadResult([], 0)
    unwrap = unwrap or (lambda b: b)
    data = storage.read(path)
    out = []
    errors = 0
    consumed = 0
    for p in codec.iter_frames(data):
        try:
            out.append(codec.loads(unwrap(p)))
        except (ValueError, IndexError):
            errors += 1
            break  # undecryptable/corrupt entry: stop at the intact prefix
        consumed += 1
    return WalReadResult(out, errors)


def atomic_write(path: str, data: bytes, storage: Storage = FILE):
    """Write + fsync + rename (the snapshot commit point; reference
    replaceFileAtomic, storage_interface.dart:94)."""
    storage.write_atomic(path, data)
