"""Primary-key generators.

Same strategy surface as the reference (model/id_generator.dart:1-1435):
sequential pools, timestamp-based, date-prefixed, Base62 short codes, and a
snowflake-style global generator with node bits for distributed mode
(:1357-1420). The reference's `CentralServerClient` ID-segment protocol
(:1300-1318) maps to `SegmentAllocator` — per-node ranges so primary keys
stay globally unique across a mesh/multi-host deployment without
coordination on the hot path.
"""

from __future__ import annotations

import threading
import time

_BASE62 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


def base62(n: int, width: int = 0) -> str:
    if n == 0:
        s = "0"
    else:
        out = []
        while n:
            n, r = divmod(n, 62)
            out.append(_BASE62[r])
        s = "".join(reversed(out))
    return s.rjust(width, "0") if width else s


class SequentialIdGenerator:
    """Lock-protected counter (reference pool-based generator :29)."""

    def __init__(self, initial: int = 1, increment: int = 1):
        self._next = initial
        self._inc = increment
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            v = self._next
            self._next += self._inc
            return v

    def next_batch(self, n: int) -> range:
        """Reserve n consecutive ids in one lock acquisition (reference
        pool-based batch generation, id_generator.dart:669)."""
        with self._lock:
            start = self._next
            self._next += self._inc * n
            return range(start, start + self._inc * n, self._inc)

    def observe(self, value):
        """Advance past user-supplied keys so generated keys never collide."""
        if isinstance(value, bool) or not isinstance(value, int):
            return
        with self._lock:
            if value >= self._next:
                self._next = value + self._inc

    def state(self) -> int:
        return self._next

    def restore(self, v: int):
        self._next = v


class TimeBasedIdGenerator:
    """timestampBased / datePrefixed / shortCode strategies
    (reference :255-311)."""

    def __init__(self, mode: str = "timestampBased", node_id: int = 0):
        self.mode = mode
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def _tick(self, max_seq: int) -> tuple[int, int]:
        with self._lock:
            ms = int(time.time() * 1000)
            if ms == self._last_ms:
                self._seq += 1
            else:
                self._last_ms = ms
                self._seq = 0
            while self._seq > max_seq:  # burst overflow: wait out the ms
                ms = int(time.time() * 1000)
                if ms != self._last_ms:
                    self._last_ms = ms
                    self._seq = 0
            return ms, self._seq

    def next(self) -> str:
        ms, seq = self._tick(0x3FF if self.mode == "shortCode" else 9999)
        if self.mode == "timestampBased":
            return f"{ms}{self.node_id:03d}{seq:04d}"
        if self.mode == "datePrefixed":
            lt = time.localtime(ms / 1000)
            day = time.strftime("%Y%m%d", lt)
            ms_of_day = ((lt.tm_hour * 60 + lt.tm_min) * 60 + lt.tm_sec) * 1000 + ms % 1000
            return f"{day}{ms_of_day:08d}{seq:04d}"
        if self.mode == "shortCode":
            # 10 sequence bits: 1024 unique ids per ms per node (a 4-bit
            # field collided under trivial burst ingest)
            v = (ms << 20) | (self.node_id << 10) | (seq & 0x3FF)
            return base62(v)
        raise ValueError(self.mode)


class GlobalIdGenerator:
    """Snowflake-style 41-bit ts + 10-bit node + 12-bit seq
    (reference :1357-1420)."""

    EPOCH = 1_600_000_000_000

    def __init__(self, node_id: int = 0):
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last = 0
        self._seq = 0

    def next(self) -> int:
        with self._lock:
            ms = int(time.time() * 1000) - self.EPOCH
            if ms == self._last:
                self._seq = (self._seq + 1) & 0xFFF
                if self._seq == 0:
                    while ms <= self._last:
                        ms = int(time.time() * 1000) - self.EPOCH
            else:
                self._seq = 0
            self._last = ms
            return (ms << 22) | (self.node_id << 12) | self._seq


class SegmentAllocator:
    """Distributed ID segments: each node consumes ranges of `segment_size`
    ids from an allocator callback (the reference's CentralServerClient
    requestIdBatch, id_generator.dart:1311). Default allocator hands out
    node-striped local ranges so single-process use needs no server."""

    def __init__(self, node_id: int = 0, segment_size: int = 4096, fetch=None):
        self.node_id = node_id
        self.segment_size = segment_size
        self._fetch = fetch or self._local_fetch
        self._lock = threading.Lock()
        self._cur = 0
        self._end = 0
        self._epoch = 0

    def _local_fetch(self) -> tuple[int, int]:
        start = 1 + self._epoch * self.segment_size
        self._epoch += 1
        return start, start + self.segment_size

    def next(self) -> int:
        with self._lock:
            if self._cur >= self._end:
                self._cur, self._end = self._fetch()
            v = self._cur
            self._cur += 1
            return v
