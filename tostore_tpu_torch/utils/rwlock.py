"""Re-entrant readers-writer lock for off-lock vector search.

The TPU-native replacement for the reference's shared/exclusive lock
manager (lock_manager.dart:38-44) and its concurrent query leases
(workload_scheduler.dart:48-53): searches take SHARED mode on the index
they scan — acquired while still holding the engine lock so the captured
slot mask and corpus layout cannot drift, then held across the
multi-millisecond device dispatch with the engine lock released — while
every index mutator (flush, compact, RCU install) takes EXCLUSIVE mode.
Concurrent searches therefore pipeline on the device instead of
serializing behind the engine lock, and CRUD on other tables proceeds
during an in-flight search.

Writer-preferring: a waiting writer blocks NEW readers (no writer
starvation under a read-heavy search load), but a thread already holding
the lock re-enters freely in either mode (a writer may also take read).
Read->write upgrades deadlock by construction and raise instead.

Lock order is engine lock -> index lock, never the reverse: readers
acquire under the engine lock and never re-take the engine lock while
holding shared mode; writers always already hold the engine lock.
"""

from __future__ import annotations

import threading


class RWLock:
    __slots__ = ("_cond", "_readers", "_writer", "_writer_count", "_write_waiters")

    def __init__(self):
        self._cond = threading.Condition()
        self._readers: dict[int, int] = {}  # thread ident -> hold count
        self._writer: int | None = None
        self._writer_count = 0
        self._write_waiters = 0

    # --- shared ---------------------------------------------------------------

    def acquire_read(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me or me in self._readers:
                # re-entrant (including read-under-write)
                self._readers[me] = self._readers.get(me, 0) + 1
                return
            while self._writer is not None or self._write_waiters:
                self._cond.wait()
            self._readers[me] = 1

    def release_read(self):
        me = threading.get_ident()
        with self._cond:
            n = self._readers.get(me, 0) - 1
            if n > 0:
                self._readers[me] = n
                return
            self._readers.pop(me, None)
            if not self._readers:
                self._cond.notify_all()

    # --- exclusive ------------------------------------------------------------

    def acquire_write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_count += 1
                return
            if me in self._readers:
                raise RuntimeError("read->write lock upgrade is not supported")
            self._write_waiters += 1
            try:
                while self._writer is not None or self._readers:
                    self._cond.wait()
            finally:
                self._write_waiters -= 1
            self._writer = me
            self._writer_count = 1

    def try_acquire_write(self) -> bool:
        """Non-blocking exclusive acquire. True = acquired (re-entrant
        included); False = contended, nothing changed."""
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_count += 1
                return True
            if me in self._readers:
                return False  # upgrade would deadlock
            if self._writer is not None or self._readers:
                return False
            self._writer = me
            self._writer_count = 1
            return True

    def release_write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer != me:
                raise RuntimeError("release_write by non-owner")
            self._writer_count -= 1
            if self._writer_count == 0:
                self._writer = None
                self._cond.notify_all()

    # --- context managers -----------------------------------------------------

    class _Guard:
        __slots__ = ("_acq", "_rel")

        def __init__(self, acq, rel):
            self._acq, self._rel = acq, rel

        def __enter__(self):
            self._acq()

        def __exit__(self, *exc):
            self._rel()
            return False

    def read(self) -> "RWLock._Guard":
        return RWLock._Guard(self.acquire_read, self.release_read)

    def write(self) -> "RWLock._Guard":
        return RWLock._Guard(self.acquire_write, self.release_write)


class WriteGuard:
    """Reusable `with`-able exclusive view of an RWLock. The engine's big
    lock swaps its RLock for one of these so every existing
    `with self._lock:` site keeps exclusive semantics unchanged, while
    audited read-only paths take the sibling ReadGuard (shared mode)."""

    __slots__ = ("_lk",)

    def __init__(self, lk: RWLock):
        self._lk = lk

    def __enter__(self):
        self._lk.acquire_write()
        return self

    def __exit__(self, *exc):
        self._lk.release_write()
        return False


class ReadGuard:
    """Reusable `with`-able shared view of an RWLock (see WriteGuard)."""

    __slots__ = ("_lk",)

    def __init__(self, lk: RWLock):
        self._lk = lk

    def __enter__(self):
        self._lk.acquire_read()
        return self

    def __exit__(self, *exc):
        self._lk.release_read()
        return False


_ATTACH = threading.Lock()


def rw(obj) -> RWLock:
    """The lock guarding `obj`'s search-visible state, attached lazily.

    Per-object (not per-class): an index replaced wholesale (apply_clear,
    restore) carries a fresh lock; in-flight readers finish on the old
    object, which is immutable-by-abandonment — the RCU pattern the
    engine already uses for background retrains.
    """
    lock = getattr(obj, "_rw_lock", None)
    if lock is None:
        with _ATTACH:
            lock = getattr(obj, "_rw_lock", None)
            if lock is None:
                lock = RWLock()
                obj._rw_lock = lock
    return lock
